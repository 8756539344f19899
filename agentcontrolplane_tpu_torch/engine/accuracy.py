"""Byte-identity-relaxed accuracy gate for quantized serving, the port of
``agentcontrolplane_tpu/engine/accuracy.py``.

Greedy byte identity is the port's correctness contract against the
reference, and int8 weights and int8 KV are the one place it legitimately
breaks: a different, deliberately close function. The replacement
contract: a pinned deterministic fixture is scored through the serving
numerics (a prefill into the paged cache, then every following token
teacher-forced through ``decode_step_paged`` — the hot loop's read/write
discipline) under the quantized configuration and under the unquantized
baseline, and the gate asserts

- **top-1 greedy agreement** — the fraction of positions whose argmax
  token matches the baseline's — stays >= a pinned threshold, and
- **logit MAE** — mean |quantized - baseline| over the fixture's logits —
  stays <= a pinned bound.

The reference scores through its slot cache; the port has only the paged
layout, so it scores through the paged programs. Both knobs off stays
covered by byte identity — this gate never relaxes that.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.llama import (
    LlamaConfig,
    decode_step_paged,
    init_paged_cache,
    prefill_paged_batch,
)
from ..ops.quant import quantize_params

PAGE_SIZE = 16  # the gate's page size (the engine's default)


def pinned_fixture(
    vocab_size: int, prompts: int = 4, length: int = 48, seed: int = 20260804
) -> np.ndarray:
    """The gate's deterministic prompt set: ``[prompts, length]`` int32
    rows drawn from a fixed seed (token 0 reserved out). Same (vocab,
    shape, seed) -> same fixture as the reference's, forever."""
    rng = np.random.default_rng(seed)
    return rng.integers(1, vocab_size, size=(prompts, length)).astype(np.int32)


def teacher_forced_logits(
    params: dict,
    config: LlamaConfig,
    rows: np.ndarray,  # [B, T] int32 — equal-length fixture rows
    quantize_kv: bool = False,
) -> np.ndarray:
    """Serving-numerics logits at every position: the first token prefills
    an (optionally int8) paged cache, then each following token is teacher-
    forced through ``decode_step_paged``, so position ``t``'s logits are
    computed reading the pages as the engine's decode loop reads them
    (int8 pages dequantize inside the walk; fresh K/V quantizes on
    commit). Runs on the device of ``params``. Returns [B, T, V] float32;
    ``logits[:, t]`` scores the token following ``rows[:, t]``."""
    B, T = rows.shape
    P = PAGE_SIZE
    device = params["embed"].device
    max_pages = -(-T // P)
    pages = init_paged_cache(
        config, B * max_pages + 1, P, device=device, quantize_kv=quantize_kv
    )
    # row b owns pages 1 + b*M .. (b+1)*M; page 0 is the trash page
    tables = (1 + torch.arange(B * max_pages, dtype=torch.int32)).reshape(B, max_pages)
    tables = tables.to(device)
    first = torch.zeros((B, P), dtype=torch.long)
    first[:, 0] = torch.from_numpy(rows[:, 0].astype(np.int64))
    active = torch.ones(B, dtype=torch.bool, device=device)
    with torch.inference_mode():
        pages, logits = prefill_paged_batch(
            params, pages, first.to(device), torch.ones(B, dtype=torch.long, device=device),
            tables[:, :1], config,
        )
        out = [logits.float().cpu().numpy()]
        for t in range(1, T):
            pages, logits = decode_step_paged(
                params, pages, torch.from_numpy(rows[:, t].astype(np.int64)).to(device),
                torch.full((B,), t, dtype=torch.int32, device=device), tables, active, config,
            )
            out.append(logits.float().cpu().numpy())
    return np.stack(out, axis=1).astype(np.float32)


def accuracy_report(
    config: LlamaConfig,
    params: dict,
    *,
    quantize_weights: bool = False,
    quantize_kv: bool = False,
    rows: Optional[np.ndarray] = None,
    baseline: Optional[np.ndarray] = None,
) -> dict:
    """Score one quantized configuration against the unquantized baseline
    over the pinned fixture. ``params`` are the DENSE params (the weight-
    quantized run derives its int8 copy with ``quantize_params``, so both
    runs serve the same underlying function). ``baseline`` optionally
    supplies the unquantized :func:`teacher_forced_logits` for these
    ``rows``. Returns the gate metrics::

        {"top1_agreement": float, "logit_mae": float,
         "positions": int, "quantize_weights": bool, "quantize_kv": bool}
    """
    if rows is None:
        rows = pinned_fixture(config.vocab_size)
    base = baseline if baseline is not None else teacher_forced_logits(
        params, config, rows, quantize_kv=False
    )
    qparams = quantize_params(params) if quantize_weights else params
    cand = teacher_forced_logits(qparams, config, rows, quantize_kv=quantize_kv)
    agree = float(np.mean(base.argmax(-1) == cand.argmax(-1)))
    mae = float(np.mean(np.abs(base - cand)))
    return {
        "top1_agreement": round(agree, 4),
        "logit_mae": round(mae, 5),
        "positions": int(base.shape[0] * base.shape[1]),
        "quantize_weights": bool(quantize_weights),
        "quantize_kv": bool(quantize_kv),
    }


def check_accuracy_gate(report: dict, min_top1: float, max_logit_mae: float) -> list[str]:
    """Evaluate a report against pinned thresholds; returns violations
    (empty = the gate passes)."""
    problems: list[str] = []
    if report["top1_agreement"] < min_top1:
        problems.append(
            f"top-1 greedy agreement {report['top1_agreement']} < pinned "
            f"threshold {min_top1}"
        )
    if report["logit_mae"] > max_logit_mae:
        problems.append(
            f"logit MAE {report['logit_mae']} > pinned bound {max_logit_mae}"
        )
    return problems
