"""Weights for the port's model: carried across from the JAX package, or
random from a seed.

No checkpoint ships with the repository, so full-width serving uses
:func:`random_params`. Loading HF safetensors checkpoints is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.llama import LlamaConfig, check_supported, init_params
from ..ops.quant import QuantizedTensor


def _to_tensor(a, dtype: Optional[torch.dtype], device) -> torch.Tensor:
    """``a`` as a tensor on ``device``, cast to ``dtype`` (None keeps the
    array's own dtype, bit for bit)."""
    arr = np.array(a)  # a writable, contiguous host copy
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (ml_dtypes registers it): carry the
        # raw 16-bit words and reinterpret them on the torch side
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def _quantized_pair(leaf):
    """A quantized leaf of the JAX package as ``(q, scale)``: its own
    ``QuantizedTensor`` (anything with ``.q`` and ``.scale``) or a pair."""
    if hasattr(leaf, "q") and hasattr(leaf, "scale"):
        return leaf.q, leaf.scale
    if isinstance(leaf, (tuple, list)) and len(leaf) == 2:
        return leaf[0], leaf[1]
    return None


def params_from_jax(tree: dict, config: LlamaConfig, device="cuda") -> dict:
    """The JAX package's params pytree, as numpy arrays with the same keys
    (``embed``, ``norm``, ``lm_head``, ``layers.{ln1, ln2, wq, wk, wv, wo,
    w1, w2, w3}`` stacked on a leading L axis, ``x @ W`` orientation), as
    the port's params on ``device`` in ``config.dtype``. Layer matrices the
    reference quantized (its ``QuantizedTensor``, or a ``(q, scale)`` pair
    of numpy arrays) become the port's ``QuantizedTensor`` with the int8
    values and f32 scales kept exactly."""
    check_supported(config)
    layer_keys = ("ln1", "ln2", "wq", "wk", "wv", "wo", "w1", "w2", "w3")

    def layer(leaf):
        pair = _quantized_pair(leaf)
        if pair is None:
            return _to_tensor(leaf, config.dtype, device)
        q, scale = (_to_tensor(a, None, device) for a in pair)
        if q.dtype != torch.int8 or scale.dtype != torch.float32:
            raise TypeError(f"quantized leaf must be int8 + f32, not {q.dtype} + {scale.dtype}")
        return QuantizedTensor(q=q, scale=scale)

    out = {
        "embed": _to_tensor(tree["embed"], config.dtype, device),
        "norm": _to_tensor(tree["norm"], config.dtype, device),
        "layers": {k: layer(tree["layers"][k]) for k in layer_keys},
    }
    if not config.tie_embeddings:
        out["lm_head"] = _to_tensor(tree["lm_head"], config.dtype, device)
    return out


def random_params(
    config: LlamaConfig, seed: int, device="cuda", quantize: Optional[str] = None
) -> dict:
    """Full-width random weights made on ``device`` from a seeded
    ``torch.Generator``. With ``quantize="int8"`` every quantizable stacked
    matrix is drawn in the model dtype, quantized and freed before the next
    is drawn, so the bf16 model never exists whole (llama3-8b: about 9.1 GB
    served, peaking at that plus one stacked w1 of 3.76 GB); the values are
    those of quantizing the bf16 draw of the same seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return init_params(config, gen, device=device, quantize=quantize)
