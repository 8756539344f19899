"""Prefill attention as plain PyTorch (mirrors
``agentcontrolplane_tpu/ops/attention.py``).

In the reference this was left to XLA, so it stays plain tensor code here;
only the paged decode attention has a hand-written kernel (``ops.cuda``).
Softmax math is float32; logits are masked with the finite ``NEG_INF`` so a
fully-masked row never produces NaN.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[..., H_kv, d] -> [..., H_kv * n_rep, d] (GQA)."""
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=-2)


def causal_attention(
    q: torch.Tensor,  # [B, T, H, d]
    k: torch.Tensor,  # [B, T, H_kv, d]
    v: torch.Tensor,  # [B, T, H_kv, d]
    positions: Optional[torch.Tensor] = None,  # [B, T]; -1 = padding
) -> torch.Tensor:
    """Full causal self-attention. With ``positions`` given, tokens attend
    only to tokens with position <= their own AND valid (position >= 0)."""
    B, T, H, d = q.shape
    n_rep = H // k.shape[-2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    scale = 1.0 / (d**0.5)
    logits = torch.einsum("bthd,bshd->bhts", q, k).float() * scale
    if positions is None:
        mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))[None, None]
    else:
        valid = positions >= 0
        mask = (
            (positions[:, None, :, None] >= positions[:, None, None, :])
            & valid[:, None, :, None]
            & valid[:, None, None, :]
        )
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def online_softmax_step(qf, kf, vf, mask, m, l, acc, scale):
    """One flash-style accumulation step over a K/V block: f32 query
    [B,Tq,H,d], block keys/values [B,Tk,H,d] (kv heads already repeated),
    a [B,1|H,Tq,Tk] mask; folds the block into the running (m, l, acc).
    The isfinite guards keep fully-masked-so-far rows at exactly zero."""
    logits = torch.einsum("bthd,bshd->bhts", qf, kf) * scale
    logits = torch.where(mask, logits, NEG_INF)
    m_blk = logits.amax(dim=-1)
    m_new = torch.maximum(m, m_blk)
    finite = torch.isfinite(m_new)
    m_safe = torch.where(finite, m_new, 0.0)
    p = torch.exp(logits - m_safe[..., None])
    p = torch.where(finite[..., None], p, 0.0)
    correction = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
    l = l * correction + p.sum(dim=-1)
    acc = acc * correction[..., None] + torch.einsum("bhts,bshd->bhtd", p, vf)
    return m_new, l, acc


def online_softmax_finalize(l, acc, dtype):
    """(l, acc) -> [B, T, H, d] output in ``dtype``."""
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(dtype)


def blocked_causal_attention(
    q: torch.Tensor,  # [B, T, H, d]
    k: torch.Tensor,  # [B, T, H_kv, d]
    v: torch.Tensor,
    positions: Optional[torch.Tensor] = None,  # [B, T] (-1 = padding)
    block_size: int = 512,
) -> torch.Tensor:
    """Flash-style blocked causal attention: query block i scans key blocks
    0..i with an online-softmax accumulator, so peak logits memory is
    [B, H, block, block] instead of [B, H, T, T]. Exact vs
    :func:`causal_attention` up to f32 accumulation order. Falls back to the
    dense path when T does not split into blocks."""
    B, T, H, d = q.shape
    if T <= block_size or T % block_size:
        return causal_attention(q, k, v, positions)
    if positions is None:
        positions = torch.arange(T, device=q.device).expand(B, T)
    nb = T // block_size
    n_rep = H // k.shape[-2]
    scale = 1.0 / (d**0.5)
    outs = []
    for qi in range(nb):
        sl = slice(qi * block_size, (qi + 1) * block_size)
        qf = q[:, sl].float()
        q_pos = positions[:, sl]
        m = torch.full((B, H, block_size), float("-inf"), device=q.device)
        l = torch.zeros((B, H, block_size), device=q.device)
        acc = torch.zeros((B, H, block_size, d), device=q.device)
        for ki in range(qi + 1):
            ks = slice(ki * block_size, (ki + 1) * block_size)
            kf = repeat_kv(k[:, ks], n_rep).float()
            vf = repeat_kv(v[:, ks], n_rep).float()
            kv_pos = positions[:, ks]
            mask = (
                (kv_pos[:, None, None, :] <= q_pos[:, None, :, None])
                & (q_pos[:, None, :, None] >= 0)
                & (kv_pos[:, None, None, :] >= 0)
            )
            m, l, acc = online_softmax_step(qf, kf, vf, mask, m, l, acc, scale)
        outs.append(online_softmax_finalize(l, acc, q.dtype))
    return torch.cat(outs, dim=1)
