"""Rotary position embeddings, split-half (rotate_half) convention as in HF
Llama — the same formulation as ``agentcontrolplane_tpu/ops/rope.py``:
frequencies from integer positions, computed in float32, cast back."""

from __future__ import annotations

import math
from typing import Optional

import torch


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies [head_dim//2] (float32)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def llama3_scale_frequencies(
    inv_freq: torch.Tensor,
    factor: float,
    low_freq_factor: float,
    high_freq_factor: float,
    original_max_seq: int,
) -> torch.Tensor:
    """Llama-3.1's RoPE frequency rescale (HF ``rope_type == "llama3"``):
    wavelengths beyond the original context are slowed by ``factor``,
    short ones kept, with a smooth ramp between."""
    wavelen = (2.0 * math.pi) / inv_freq
    low_wavelen = original_max_seq / low_freq_factor
    high_wavelen = original_max_seq / high_freq_factor
    smooth = (original_max_seq / wavelen - low_freq_factor) / (
        high_freq_factor - low_freq_factor
    )
    interpolated = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
    return torch.where(
        wavelen < high_wavelen,
        inv_freq,
        torch.where(wavelen > low_wavelen, inv_freq / factor, interpolated),
    )


def apply_rope(
    x: torch.Tensor,  # [..., T, H, d]
    positions: torch.Tensor,  # [..., T] integer
    theta: float = 500000.0,
    scaling: Optional[tuple[float, float, float, int]] = None,
) -> torch.Tensor:
    """Rotate q or k by position. ``scaling`` = (factor, low_freq_factor,
    high_freq_factor, original_max_seq) applies the Llama-3.1 rescale."""
    d = x.shape[-1]
    inv_freq = rope_frequencies(d, theta, device=x.device)
    if scaling is not None:
        inv_freq = llama3_scale_frequencies(inv_freq, *scaling)
    angles = positions[..., None].float() * inv_freq  # [..., T, d/2]
    cos = torch.cos(angles)[..., None, :]  # [..., T, 1, d/2]
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., : d // 2].float()
    x2 = x[..., d // 2 :].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
