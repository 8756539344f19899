"""Token sampling: greedy / temperature / top-k / top-p, batched per slot.

Mirrors ``agentcontrolplane_tpu/ops/sampling.py``: temperature 0 means
greedy, all math is float32, and both masks come from a 32-step bisection
of a threshold instead of sorting the vocabulary. The bisections are the
reference's step for step, so the top-k and top-p masks match it exactly;
only the random draw differs (a ``torch.Generator`` instead of
``jax.random``), so temperature samples agree in distribution, not bits.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
_BISECT_ITERS = 32


def _topk_threshold(logits: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-row value t such that count(logits >= t) >= k and masking
    logits < t keeps the k largest (plus boundary ties). k >= V keeps all.
    [S, V], [S] -> [S, 1]."""
    lo = logits.amin(dim=-1)
    hi = logits.amax(dim=-1)
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        count = (logits >= mid[:, None]).sum(dim=-1)
        ok = count >= k  # mid keeps enough -> can raise the floor
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return lo[:, None]


def _topp_threshold(
    logits: torch.Tensor, top_p: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (prob threshold t [S, 1], probs [S, V]): keeping probs >= t
    keeps exactly the nucleus — every token whose strictly-greater-prob
    mass is < top_p.

    top_p >= 1 keeps every token above max_p * 2^-32, which is what the
    reference documents for that case. The reference reaches it by the
    f32 sum of the probabilities staying below 1.0; where that sum rounds
    up to 1.0 it also drops some tail tokens, and on which ones depends on
    the summation order, which no two frameworks share. Here the rows with
    top_p >= 1 always take the documented path."""
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    lo = torch.zeros(probs.shape[0], device=probs.device)
    hi = probs.amax(dim=-1)
    keep_all = top_p >= 1.0
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        mass_above = torch.where(probs > mid[:, None], probs, 0.0).sum(dim=-1)
        ok = (mass_above < top_p) | keep_all  # mid admits the nucleus -> go lower
        lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
    return hi[:, None], probs


def sample(
    logits: torch.Tensor,  # [S, V]
    generator: torch.Generator,
    temperature: torch.Tensor,  # [S]
    top_k: torch.Tensor,  # [S] int, 0 = disabled
    top_p: torch.Tensor,  # [S] float32, 1.0 = disabled
) -> torch.Tensor:
    """Returns sampled token ids [S] (int64). Temperature rows draw by the
    Gumbel-max trick from ``generator`` — the same method as the
    reference's ``jax.random.categorical``."""
    logits = logits.float()
    S, V = logits.shape
    k = torch.where(top_k > 0, top_k, V)
    kth = _topk_threshold(logits, k)
    logits = torch.where(logits < kth, NEG_INF, logits)
    p_thresh, probs = _topp_threshold(logits, top_p)
    logits = torch.where(probs < p_thresh, NEG_INF, logits)

    greedy = logits.argmax(dim=-1)
    temp = torch.clamp_min(temperature, 1e-6)[:, None]
    u = torch.rand((S, V), generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    sampled = (logits / temp + gumbel).argmax(dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled)
