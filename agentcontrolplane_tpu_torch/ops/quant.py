"""int8 quantization for serving: weights and the paged KV cache.

Mirrors ``agentcontrolplane_tpu/ops/quant.py`` formula for formula, so the
port's int8 values and scales equal the reference's bit for bit on the same
input (``torch.round`` rounds half to even, like ``jnp.round``). One detail
decides "the reference's": its compiled programs (every serving path runs
under ``jax.jit``) compute ``absmax / 127.0`` as ``absmax * f32(1/127)``,
because XLA rewrites division by a constant, while eager JAX and its
``quantize_np`` divide exactly; the two disagree by one ulp in a few
percent of scales. The torch quantizers follow the compiled programs (the
numerics the reference serves with); :func:`quantize_np` follows the
reference's ``quantize_np``.

**Weights** — symmetric per-output-channel int8: ``W[in, out] -> (q int8,
scale [.., 1, out] f32)``. The scale is per output channel, so it commutes
with the contraction and :func:`matmul` applies it after the product:
``(x @ q.to(x.dtype)) * scale``. The reference leaves that product to XLA
(outside Pallas), so the port leaves it to ``torch.matmul``; in eager
PyTorch the ``q.to(x.dtype)`` is a real converted copy of the matrix (XLA
fuses it into the operand load).

**KV cache** — symmetric per-row-per-head int8: a K or V row
``[..., H_kv, d]`` quantizes over its head_dim to ``(q int8 [..., H_kv, d],
scale f32 [..., H_kv])``. Write paths quantize on commit and attention
dequantizes after the gather (the plain versions in ``ops/paged.py``) or
inside the int8 page walk (``ops/cuda/paged_attention.py``), so the pool
stays int8: a page plus its scales takes 4/d more than half its bf16 bytes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# Scale floor for symmetric int8: an all-zero channel or row has absmax 0
# and would otherwise divide by zero. Clamping the scale — not the quotient
# — keeps the round trip exact for zeros: q = round(0 / floor) = 0.
SCALE_FLOOR = 1e-8
# f32(1) / f32(127), exactly representable as a Python float: the factor
# XLA's compiled programs multiply by in place of dividing by 127
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


@dataclass
class QuantizedTensor:
    """int8 values + per-output-channel scales, in the layout of the tensor
    it replaces: ``q [..., in, out]`` int8, ``scale [..., 1, out]`` f32."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype

    def __getitem__(self, i) -> "QuantizedTensor":
        """Index the leading (layer) axis of both parts."""
        return QuantizedTensor(self.q[i], self.scale[i])

    @property
    def nbytes(self) -> int:
        return self.q.numel() * self.q.element_size() + self.scale.numel() * 4


def quantize(w: torch.Tensor, axis: int = -2) -> QuantizedTensor:
    """Per-output-channel symmetric int8 over the contraction axis
    (``axis`` = the 'in' dimension being summed)."""
    wf = w.float()
    absmax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(absmax * _INV_127, SCALE_FLOOR)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q=q, scale=scale)


def quantize_stacked(w: torch.Tensor) -> QuantizedTensor:
    """:func:`quantize` of a stacked ``[L, in, out]`` matrix, one layer at a
    time: the same values (the scale reduces within a layer), with f32
    temporaries of one layer instead of the whole stack."""
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty((w.shape[0], 1, w.shape[2]), dtype=torch.float32, device=w.device)
    for i in range(w.shape[0]):
        qi = quantize(w[i])
        q[i], scale[i] = qi.q, qi.scale
    return QuantizedTensor(q=q, scale=scale)


def quantize_np(w, axis: int = -2):
    """Host-side (numpy) quantizer, returning ``(q, scale)`` numpy arrays
    equal to the reference's ``quantize_np`` bit for bit: it divides by 127
    exactly, so its scales may differ from :func:`quantize`'s by one ulp
    (see the module docstring)."""
    wf = np.asarray(w, dtype=np.float32)
    absmax = np.max(np.abs(wf), axis=axis, keepdims=True)
    scale = np.maximum(absmax / np.float32(127.0), np.float32(SCALE_FLOOR))
    q = np.clip(np.round(wf / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize(t: QuantizedTensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (t.q.float() * t.scale).to(dtype)


def matmul(x: torch.Tensor, w: "torch.Tensor | QuantizedTensor") -> torch.Tensor:
    """``x @ w`` with transparent int8 weights: ``(x @ q) * scale``, the
    scale broadcast over the result's rows (its kept contraction axis is
    squeezed)."""
    if isinstance(w, QuantizedTensor):
        return (x @ w.q.to(x.dtype)) * w.scale.squeeze(-2).to(x.dtype)
    return x @ w


QUANTIZABLE = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


def quantize_params(params: dict) -> dict:
    """Quantize the stacked layer matrices (embed, lm_head and the norms
    stay in the model dtype). Returns a new dict; ``params`` is unchanged."""
    out = dict(params)
    out["layers"] = dict(params["layers"])
    for key in QUANTIZABLE:
        out["layers"][key] = quantize_stacked(params["layers"][key])
    return out


# ---------------------------------------------------------------------------
# KV-cache quantization (per-row-per-head)
# ---------------------------------------------------------------------------


def kv_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize K or V rows ``[..., H_kv, d]`` over head_dim -> ``(q int8
    [..., H_kv, d], scale f32 [..., H_kv])``. All-zero rows take the
    SCALE_FLOOR and round-trip to exact zeros."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    scale = torch.clamp_min(absmax * _INV_127, SCALE_FLOOR)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`kv_quantize`: ``q [..., H_kv, d]`` x ``scale
    [..., H_kv]`` -> values in ``dtype``."""
    return (q.float() * scale[..., None]).to(dtype)
