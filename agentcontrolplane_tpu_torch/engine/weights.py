"""Weights for the port's model: carried across from the JAX package, or
random from a seed.

No checkpoint ships with the repository, so full-width serving uses
:func:`random_params`. Loading HF safetensors checkpoints is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.llama import LlamaConfig, check_supported, init_params


def _to_tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.array(a)  # a writable, contiguous host copy
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (ml_dtypes registers it): carry the
        # raw 16-bit words and reinterpret them on the torch side
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype)


def params_from_jax(tree: dict, config: LlamaConfig, device="cuda") -> dict:
    """The JAX package's params pytree, as numpy arrays with the same keys
    (``embed``, ``norm``, ``lm_head``, ``layers.{ln1, ln2, wq, wk, wv, wo,
    w1, w2, w3}`` stacked on a leading L axis, ``x @ W`` orientation), as
    the port's params on ``device`` in ``config.dtype``."""
    check_supported(config)
    layer_keys = ("ln1", "ln2", "wq", "wk", "wv", "wo", "w1", "w2", "w3")
    out = {
        "embed": _to_tensor(tree["embed"], config.dtype, device),
        "norm": _to_tensor(tree["norm"], config.dtype, device),
        "layers": {k: _to_tensor(tree["layers"][k], config.dtype, device) for k in layer_keys},
    }
    if not config.tie_embeddings:
        out["lm_head"] = _to_tensor(tree["lm_head"], config.dtype, device)
    return out


def random_params(config: LlamaConfig, seed: int, device="cuda") -> dict:
    """Full-width random weights made on ``device`` from a seeded
    ``torch.Generator``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return init_params(config, gen, device=device)
