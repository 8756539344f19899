"""Hand-written CUDA kernels (``csrc/``) behind plain-PyTorch wrappers.

A wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it runs the kernel's plain version. Kernels build at first use
(``build.py``), never at import.
"""
