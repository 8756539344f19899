"""PyTorch/CUDA port of the agentcontrolplane_tpu serving path.

A second package beside ``agentcontrolplane_tpu`` (the JAX reference): the
Llama model, the paged KV cache, a trimmed continuous-batching engine and an
OpenAI-compatible HTTP front door, with the TPU's paged decode-attention
kernel rewritten by hand in CUDA C++ for Hopper (``csrc/``). The package
imports ``torch`` and numpy, never ``jax`` and nothing of the JAX package.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; there the kernel wrappers use their plain PyTorch
versions, which is how the CPU tests compare the port with the reference.
"""

__version__ = "0.1.0"
