#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, ``nvcc`` and a
CUDA build of PyTorch. Every phase must pass or the script exits non-zero
without printing a result:

1. card — the card's name and power limit from ``nvidia-smi``;
2. build — every CUDA source under ``agentcontrolplane_tpu_torch/csrc``
   compiled with ``nvcc`` (one process per source, all at once);
3. kernel — both paged decode-attention walks (one split-KV launch each,
   ``n_split`` from the shape) against their plain PyTorch
   versions on the card, both epilogue modes: the f32/bf16 walk at the
   llama3-8b decode shape (8 slots, 32 query / 8 KV heads, head_dim 128,
   pages of 16, bf16, ragged lengths up to 2048 including 0), one lane of
   2048 tokens at one card's and one tp=2 rank's heads, lengths on, one
   past and short of the split boundaries, and edge
   shapes (d=16 f32, d=256 bf16, a group of 7 query heads); the int8 walk
   over pages made on the card by ``kv_quantize`` at the llama3-8b shape,
   the serving lengths, the single lanes and split boundaries, d=16 f32,
   d=256 with a group of 8, and a case whose
   trash page and masked tail rows hold poisoned values and scales; one
   tp=2 rank's heads (16/4) in both walks; the STATE form of both walks
   (the context-parallel wrapper's unnormalized (acc, m, l)) on each sp
   rank's rows of every page at one sp=2 x tp=2 rank's shape and at its
   split boundaries, with lanes a
   rank holds no row of, poisoned masked rows (int8), and the two ranks'
   states merged with the self term against the mode-1 kernel over whole
   pages; times of each kernel, its plain version and a PyTorch attention
   call (``scaled_dot_product_attention``, or for the state form the
   memory-efficient attention that returns the log-sum-exp; a yardstick
   only) beside the bound, and ptxas's registers and spills (a spill in the
   llama3-8b variant of either walk fails the run);
4. model — the tiny f32 model's paged prefill + decode on the card (kernel)
   against the same on the CPU (plain version), unquantized and with int8
   weights and an int8 KV cache (the int8 walk); then its engines on the
   card and on the CPU: six requests on a 9-page pool (preempted and
   resumed), a two-turn conversation whose second turn adopts the
   first's parked slot, a 200-token row prefilled in chunks of 16 and a
   burst of four on one persona (three dedup shares), both with the fused
   megastep on (the default) and off, greedy tokens equal to uncontended
   runs, across the two modes and to the CPU's, and the preempted group
   and the two turns again with the host KV tier on (the turns' parked
   slot expiring into it) equal to the same;
5. serving — llama3-8b at full width and depth with random weights from
   seed 0 behind the HTTP server, first in bf16, then (after the bf16
   engine is freed) with int8 weights and int8 KV pages: five chat
   completions each (four concurrent greedy ones, one sampled that arrives
   mid-decode), with the walk's launch count equal to n_layers x decode
   steps and no launch of the other walk; then a greedy batch run twice
   must give identical tokens, and TTFT / decode rates and a profile;
   then, on the bf16 engine, the constrained phase: eight concurrent
   requests through the HTTP server (four ``response_format: json_object``,
   one of them with 24 tokens, two forcing one of two offered tools, one
   ``tool_choice: "required"``, and one ``stream: true`` forcing a tool),
   every completion parsed (JSON, or a call to the forced tool), the stream
   against the same body unstreamed in a repeat of the group, the walk's
   launches equal to n_layers x decode steps; then the JSON table's bytes
   and build time, ms per decode step with constrained lanes against
   unconstrained ones over as many steps (medians of repeats), device ops
   per step of each (a profile window each, less a window of the same
   requests' prefill alone), the masks' own ops and time at the decode
   shape, and a forced request's TTFT; then, on each of the two engines,
   the kv-reuse phase: a 1,024-token row's last 64 tokens continued over
   its first 960 against the row prefilled whole (2e-2 relative L2; with
   int8 KV against a whole-row pass reading the prefix as the int8 pool
   holds it), 4 conversations x 3 turns parked (8 adoptions, no miss, only
   suffixes prefilled), the same traffic hitting the prefix
   cache (8 hits), and 8 x (512 + 128) tokens on a second engine of 256
   pages over the same weights (preemption, token counts equal to an
   uncontended run, the pool whole after), every part's decode steps
   through the walk; then, on each of the two engines, the host-KV phase
   (the host-RAM tier at 1 GiB): (a) the preemption group again on the
   256-page engine with the tier on (swap-outs and restores >= 1, token
   counts equal to the uncontended run's, both pools whole, streams
   identical to it counted against the tier-off run), (b) on bf16 4
   conversations x 2 turns whose parked slots expire between the turns (4
   swap-outs, 4 restores by token prefix, only the suffixes prefilled),
   beside the same turns adopted and re-prefilled, (c) a 1,920-row entry
   restored in 8 chunks of 256 while 4 lanes decode, prefetch on and off
   (every restored page bit-equal to the entry, int8 scale twins included;
   prefetch commits >= 1 on and 0 off; a fused ``s16...`` key), beside the
   row prefilled in chunks, and (d) on bf16 an ``export_kv`` request's
   ``kv_handoff`` injected back and restored bit-equal by its row plus a
   suffix; every part's decode steps through the walk; then, on each of
   the two engines, the chunked/dedup
   phase with the prefix cache off and parked slots expired: (a) a
   1,920-token row prefilled whole and in 256-token chunks on a scratch
   pool, bf16 logits held against an f32 pass (each within 3e-2 relative
   L2, chunked within 1.5 x whole + 2e-3), int8 KV chunked against whole
   (5e-2); (b) four greedy decoders of 128 tokens with a 1,920-token
   request landing mid-decode, chunking off and at 256 (through the fused
   megastep) in turns, once each (the decoders' longest gap between
   commits, the long request's TTFT, hol wait, chunks, budget
   utilization; its tokens and finish equal across modes), and on bf16
   (b') the same at 256 with the megastep off, once, and (d) the long
   request with a deadline of 0.6 x (b)'s chunked TTFT, the rate planner
   on and then off (the planned quota >= 2, every chunk quota x 256
   tokens up to the largest bucket, the first token within ceil(8 /
   quota) + 1 cycles; each outcome printed, not gated), every run's
   prefill cycles, fused dispatches, shapes and fallbacks and its walk
   launches (n_layers x decode steps in every fused run) printed; (c)
   eight requests sharing a 768-token prefix with their
   own 64-token tails, dedup on and off in turns, once each (7 shares on,
   0 off, page peaks within 15% of 112 and 448, token counts and finishes
   equal, TTFTs); the walk launches of (b) and (c) equal n_layers x decode
   steps; last, on each of the two engines,
   the control-plane phase: JSON manifests (three ``provider: tpu`` LLMs
   and two Agents) applied to a sqlite store, a Manager under a
   LeaderElector (lease 2 s) running the LLM controller (a one-token probe
   through the factory's client: a prefill on the card) and the Agent
   controller through the elector's fenced store, until the LLM that fits
   the engine is Ready, the tp=2 one (and on the bf16 engine the int8 one)
   Error with the reference's message, and its Agents Ready and Pending;
   every status write fenced, a stale fence refused, the store reopened
   from its file with the same statuses and resource versions, then one
   16-token chat through the factory-made client whose decode steps all
   go through the engine's walk; then the operator phase: the port's
   ``Operator`` over a sqlite store, with forced ``provider: tpu`` LLMs
   (``tool_choice`` ``"required"`` or a tool's name), the MCP stdio echo
   server (``tests/mcp/echo_server.py`` under a ``/bin/sh`` memory limit),
   a ContactChannel on the local human backend and Agents using each; 8
   Tasks at once (2 delegating, 2 MCP echo, 2 asking a human, 2 without
   tools) whose turns run on the engine, each tool Task's first ToolCall
   CR (early or at fan-out) executed to its terminal state and its result
   joined to the Task's window, the human answered through the backend,
   one delegation ToolCall applied directly running its child Task to
   FinalAnswer, Task create -> first ToolCall CR (p50 and max per kind)
   and the other checkpoints printed with the dedup shares, the most
   pages shared at once, the fused dispatches and the rate plans made,
   every decode step through the walk;
   new turns are stopped by holding the Tasks' ``task-llm`` leases before
   the operator stops; then on the bf16 engine the observability phase;
   last, over each engine's params, the slot phase: an
   ``Engine(kv_layout="slot")`` of 8 x 2048 rows whose prefill and decode
   logits are held against an f32 pass (bf16), which serves 8 x (512 + 64)
   greedy requests (int8: 8 x 32 tokens) with no walk launch, adopts a
   parked slot, hits the prefix cache and restores swapped-out rows
   bit-equal, and (bf16) one decode step at 8 and 64 lanes timed on both
   layouts;
6. parallel serving — llama3-8b over ``torch.distributed`` ranks (one
   process each, rank 0 behind HTTP, gloo when the ranks share one card):
   tp=2 in bf16 (with one more request, forcing a tool call), then sp=2 x
   tp=2 in bf16 and with int8 weights + KV (12 tokens a request each), one
   phase's ranks at a time. Every rank's stream of
   finished requests must be identical, every decode layer of every step
   must go through the expected walk (the state form on every sp rank),
   and the first-step logits must agree with the single card's for the
   same seed; ms per decode step, the step's collectives replayed alone,
   and memory per rank are recorded;
7. quick start — the README's quick start through the port's own entry
   points, after every earlier engine is freed: ``python -m
   agentcontrolplane_tpu_torch run --tpu-preset llama3-8b`` as a subprocess
   (its own bf16 engine on ``run``'s default slot layout, a sqlite store, a
   bearer token), and beside it the same with ``--tpu-kv-layout paged``;
   then the CLI in
   this process: ``apply -f`` of ``examples/gpu-quickstart.yaml`` and of a
   YAML manifest of the smoke's (forced echo and human-contact LLMs), ``get``
   until every Agent is Ready, ``task create --follow`` to FinalAnswer on
   two Agents and ``task show``, an MCP echo call gated by ``approvals
   approve`` and a human contact answered by ``contacts respond`` (the forced
   Tasks then deleted), ``events``, ``chat``, ``/v1/models``, ``/metrics``
   (the Task phase and engine gauges), a request without the token (401),
   and SIGTERM with exit code 0, with no walk launch; then on the paged
   subprocess the same manifests, both Tasks to FinalAnswer, ``chat`` and
   SIGTERM, its walk launches (read from its ``/v1/engine``) equal to
   n_layers x decode steps.

``--kernels-only`` stops after the kernel phase (a first check of a new
kernel; it prints no result line). ``--host-kv-only`` runs the model phase
and then, on a bf16 and an int8 llama3-8b engine with no HTTP server, the
kv-reuse phase's preemption group and the host-KV phase (a first check of
that phase; no result line either).

The last two lines are one JSON object describing the kernels and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
MAX_BF16_ERR = 2e-2  # about one bf16 ulp at the outputs' magnitude
MAX_F32_ERR = 1e-5


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi: {e}")
    if not out:
        fail("nvidia-smi printed no card")
    return out[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn(i)`` over ``iters`` eager calls,
    timed with CUDA events after ``warmup`` calls. Where the host issues
    calls slower than the card runs them, this is the host's rate."""
    import torch

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int, replays: int = 10) -> float:
    """Device milliseconds per call of ``fn(i)``: ``calls`` calls captured
    back to back in one CUDA graph, replayed ``replays`` times between CUDA
    events — the card's time for the work without the host's launch cost."""
    import torch

    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


# -- kernel phase --------------------------------------------------------

LLAMA_LENS = [0, 1, 17, 255, 1024, 1500, 2047, 2048]
# seq_lens resolved on the card from the walk's split plan: lengths that end
# exactly on a split boundary, one row past it, inside the first split (so
# every later split is empty) and at the full table (_boundary_lens)
SPLIT_BOUNDARIES = "split-boundaries"
CASES = [
    # name, dtype, H, H_kv, d, P, max_pages, seq_lens, layers cycled for timing
    ("llama3-8b", "bfloat16", 32, 8, 128, 16, 128, LLAMA_LENS, 4),
    # one tp=2 rank's heads: the tp wrapper runs this on every decode layer
    ("llama3-8b-tp2-rank", "bfloat16", 16, 4, 128, 16, 128, LLAMA_LENS, 4),
    ("llama3-8b-serving-lengths", "bfloat16", 32, 8, 128, 16, 128,
     [61, 64, 70, 77, 85, 90, 96, 110], 4),
    # an agent's one long turn: a single lane of 2048 tokens, where the
    # split along pages matters most
    ("llama3-8b-one-lane-2048", "bfloat16", 32, 8, 128, 16, 128, [2048], 4),
    ("llama3-8b-tp2-rank-one-lane-2048", "bfloat16", 16, 4, 128, 16, 128, [2048], 4),
    ("llama3-8b-split-boundaries", "bfloat16", 32, 8, 128, 16, 128, SPLIT_BOUNDARIES, 1),
    ("tiny-d16-f32", "float32", 4, 2, 16, 8, 8, [0, 5, 16, 27, 64], 1),
    ("d256-group8-bf16", "bfloat16", 8, 1, 256, 16, 16, [0, 33, 128, 256], 1),
    ("d64-group7-f32", "float32", 14, 2, 64, 16, 8, [3, 0, 100, 128], 1),
]
# the int8 walk: pages are kv_quantize of random pools; the poisoned case
# fills the trash page and every row past each slot's seq_len in its last
# page with value 127 and scale 1e30, which must not reach the output
INT8_CASES = [
    ("llama3-8b", "bfloat16", 32, 8, 128, 16, 128, LLAMA_LENS, 4),
    ("llama3-8b-tp2-rank", "bfloat16", 16, 4, 128, 16, 128, LLAMA_LENS, 4),
    ("llama3-8b-serving-lengths", "bfloat16", 32, 8, 128, 16, 128,
     [61, 64, 70, 77, 85, 90, 96, 110], 4),
    ("llama3-8b-one-lane-2048", "bfloat16", 32, 8, 128, 16, 128, [2048], 4),
    ("llama3-8b-tp2-rank-one-lane-2048", "bfloat16", 16, 4, 128, 16, 128, [2048], 4),
    ("llama3-8b-split-boundaries", "bfloat16", 32, 8, 128, 16, 128, SPLIT_BOUNDARIES, 1),
    ("tiny-d16-f32", "float32", 4, 2, 16, 8, 8, [0, 5, 16, 27, 64], 1),
    ("d256-group8-bf16", "bfloat16", 8, 1, 256, 16, 16, [0, 33, 128, 256], 1),
    ("llama3-8b-poisoned-tail", "bfloat16", 32, 8, 128, 16, 16, [1, 17, 100, 255, 16, 0, 33, 200], 1),
]
MODES = (("cache_plus_new", True), ("classic", False))
# the state form, at one sp rank's slice of every page: name, dtype, H,
# H_kv, d, P (tokens per page), sp, max_pages, seq_lens, layers cycled. The
# llama3-8b case is one rank of sp=2 x tp=2 (16 query / 4 KV heads, rows
# 0-7 or 8-15 of every 16-token page); lengths 0 and 1 leave rank 1 no row
STATE_CASES = [
    ("llama3-8b-sp2xtp2-rank", "bfloat16", 16, 4, 128, 16, 2, 128, LLAMA_LENS, 4),
    ("llama3-8b-sp2xtp2-split-boundaries", "bfloat16", 16, 4, 128, 16, 2, 128,
     SPLIT_BOUNDARIES, 1),
    ("tiny-d16-f32", "float32", 4, 2, 16, 8, 2, 8, [0, 3, 5, 16, 27, 64], 1),
]
INT8_STATE_CASES = STATE_CASES + [
    ("llama3-8b-sp2xtp2-poisoned-tail", "bfloat16", 16, 4, 128, 16, 2, 16,
     [1, 17, 100, 255, 16, 0, 33, 200], 1),
]
# f32 state math on the same inputs: only the order of the sums differs
MAX_STATE_ERR = 1e-4


def _split_plan(S, H_kv, page_rows, max_pages) -> tuple[int, int]:
    """(n_split, pages per split): what the wrapper picks on this card for
    this shape."""
    import torch

    from agentcontrolplane_tpu_torch.ops.cuda import paged_attention as pa

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return pa.split_plan(max_pages, page_rows, S * H_kv, sms)


def _boundary_lens(S, H_kv, page_rows, page_tokens, max_pages) -> list[int]:
    """S lengths for the split-boundary case: on the split plan's first and
    last boundaries, one token past each, inside the first split, and at
    the full table."""
    n_split, pps = _split_plan(S, H_kv, page_rows, max_pages)
    if n_split < 3:
        fail(f"split-boundary case: only {n_split} splits at this shape")
    b = pps * page_tokens  # tokens per split
    lens = [b, b + 1, (n_split - 1) * b, (n_split - 1) * b + 1, b // 4, max_pages * page_tokens,
            2 * b, 2 * b + 1]
    return (lens * S)[:S]


def _tables(seq_lens, P, max_pages):
    import numpy as np

    S = len(seq_lens)
    num_pages = S * max_pages + 1
    rng = np.random.default_rng(0)
    perm = rng.permutation(np.arange(1, num_pages)).astype(np.int32)
    tables = np.zeros((S, max_pages), np.int32)
    for s, n in enumerate(seq_lens):
        used = -(-n // P)
        tables[s, :used] = perm[s * max_pages : s * max_pages + used]
    return tables, num_pages


def _poison(kq, vq, ks, vs, tables, seq_lens, P):
    """Copies of one layer's int8 pools with the trash page and each slot's
    masked tail rows (values and scales) set to large finite junk."""
    kq, vq, ks, vs = kq.clone(), vq.clone(), ks.clone(), vs.clone()
    for t in (kq, vq):
        t[0] = 127
    for t in (ks, vs):
        t[0] = 1e30
    for s, n in enumerate(seq_lens):
        if n == 0:
            continue
        last = (n - 1) // P
        page, off = int(tables[s, last]), n - last * P
        if off < P:
            kq[page, off:] = 127
            vq[page, off:] = 127
            ks[page, off:] = 1e30
            vs[page, off:] = 1e30
    return kq, vq, ks, vs


def _sdpa_inputs(q, k_rows, v_rows, bt, seq_lens, P, k_new, v_new, with_self):
    """The context of each slot gathered (dequantized for int8), padded and
    repeated to every query head, for one SDPA call: [S, H, L, d] keys and
    values and a [S, 1, 1, L] mask; with_self appends the new token."""
    import torch

    S, H, d = q.shape
    H_kv = k_rows.shape[2]
    dev, dtype = q.device, q.dtype
    L = max(seq_lens) + 1
    kg = torch.zeros(S, H, L, d, device=dev, dtype=dtype)
    vg = torch.zeros_like(kg)
    mask = torch.zeros(S, 1, 1, L, dtype=torch.bool, device=dev)
    for s, n in enumerate(seq_lens):
        rows = torch.arange(n, device=dev)
        pages = bt[s, rows // P].long()
        kg[s, :, :n] = k_rows[pages, rows % P].to(dtype).repeat_interleave(H // H_kv, dim=1).transpose(0, 1)
        vg[s, :, :n] = v_rows[pages, rows % P].to(dtype).repeat_interleave(H // H_kv, dim=1).transpose(0, 1)
        if with_self:
            kg[s, :, n] = k_new[s].repeat_interleave(H // H_kv, dim=0)
            vg[s, :, n] = v_new[s].repeat_interleave(H // H_kv, dim=0)
        mask[s, ..., : n + (1 if with_self else 0)] = True
    return kg, vg, mask


def run_case(case, int8: bool) -> dict:
    """One kernel case: both modes against the plain version (and, int8,
    the poisoned variant), kernel / eager / plain / SDPA times and the
    bound. Fails the run on any disagreement."""
    import torch
    import torch.nn.functional as F

    from agentcontrolplane_tpu_torch.ops import paged as plain
    from agentcontrolplane_tpu_torch.ops.cuda import paged_attention as pa
    from agentcontrolplane_tpu_torch.ops.quant import kv_dequantize, kv_quantize

    name, dtype_name, H, H_kv, d, P, max_pages, seq_lens, n_layers = case
    if seq_lens == SPLIT_BOUNDARIES:
        seq_lens = _boundary_lens(8, H_kv, P, P, max_pages)
    walk = "int8" if int8 else dtype_name
    dev = torch.device("cuda")
    dtype = getattr(torch, dtype_name)
    S = len(seq_lens)
    n_split = _split_plan(S, H_kv, P, max_pages)[0]
    tables, num_pages = _tables(seq_lens, P, max_pages)
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)

    q = randn(S, H, d)
    k_pool = randn(n_layers, num_pages, P, H_kv, d)
    v_pool = randn(n_layers, num_pages, P, H_kv, d)
    k_new, v_new = randn(S, H_kv, d), randn(S, H_kv, d)
    if int8:
        (k_pool, k_sc), (v_pool, v_sc) = kv_quantize(k_pool), kv_quantize(v_pool)

    def scales(i):
        """The int8 walk's scale keywords for layer ``i`` of the pools."""
        return {"k_scales": k_sc[i], "v_scales": v_sc[i]} if int8 else {}
    bt = torch.from_numpy(tables).to(dev)
    sl = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
    tol = MAX_BF16_ERR if dtype == torch.bfloat16 else MAX_F32_ERR
    entry = {"case": name, "walk": walk, "dtype": dtype_name, "S": S, "H": H, "H_kv": H_kv,
             "d": d, "P": P, "max_pages": max_pages, "seq_lens": seq_lens, "tol": tol,
             "n_split": n_split}
    poisoned = int8 and "poisoned" in name
    for mode, with_self in MODES:
        extra = (k_new, v_new) if with_self else ()
        kern = (pa.paged_decode_attention_cache_plus_new if with_self
                else pa.paged_decode_attention)
        ref = (plain.paged_decode_attention_reference_cache_plus_new if with_self
               else plain.paged_decode_attention_reference)
        out = kern(q, k_pool[0], v_pool[0], bt, sl, *extra, **scales(0))
        torch.cuda.synchronize()
        want = ref(q, k_pool[0], v_pool[0], bt, sl, *extra, **scales(0))
        if not torch.isfinite(out.float()).all():
            fail(f"kernel {walk} {name}/{mode}: non-finite output")
        err = (out.float() - want.float()).abs().max().item()
        again = kern(q, k_pool[0], v_pool[0], bt, sl, *extra, **scales(0))
        if not torch.equal(out, again):
            fail(f"kernel {walk} {name}/{mode}: two launches on the same inputs differ")
        if poisoned:
            kq, vq, ks, vs = _poison(k_pool[0], v_pool[0], k_sc[0], v_sc[0], tables, seq_lens, P)
            bad = kern(q, kq, vq, bt, sl, *extra, k_scales=ks, v_scales=vs)
            err = max(err, (bad.float() - want.float()).abs().max().item())
            if not torch.equal(bad, out):
                fail(f"kernel {walk} {name}/{mode}: poisoned masked rows changed the output")
        if err > tol:
            fail(f"kernel {walk} {name}/{mode}: max |kernel - plain| = {err:.3e} > {tol}")
        entry[f"{mode}_max_abs_err"] = err
        launch = (lambda i, e=extra, k=kern: k(q, k_pool[i % n_layers], v_pool[i % n_layers],
                                               bt, sl, *e, **scales(i % n_layers)))
        entry[f"{mode}_kernel_ms"] = graph_ms(launch, 32)
        entry[f"{mode}_eager_ms"] = cuda_ms(launch, 100)
        entry[f"{mode}_plain_ms"] = cuda_ms(
            lambda i, e=extra, r=ref: r(q, k_pool[i % n_layers], v_pool[i % n_layers],
                                        bt, sl, *e, **scales(i % n_layers)), 10, warmup=1)
        # yardstick: one SDPA call over the context already gathered (and
        # dequantized), padded and repeated beforehand (none of that timed)
        k_rows = kv_dequantize(k_pool[0], k_sc[0], dtype) if int8 else k_pool[0]
        v_rows = kv_dequantize(v_pool[0], v_sc[0], dtype) if int8 else v_pool[0]
        kg, vg, mask = _sdpa_inputs(q, k_rows, v_rows, bt, seq_lens, P, k_new, v_new, with_self)
        q4 = q[:, :, None, :]
        lib = F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask)[:, :, 0]
        live = sl > 0 if not with_self else torch.ones_like(sl, dtype=torch.bool)
        entry[f"{mode}_library_max_abs_err"] = (
            (lib.float() - want.float())[live].abs().max().item())
        entry[f"{mode}_library_ms"] = graph_ms(
            lambda i: F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask), 16)
        say(f"kernel {walk:8s} {name:32s} {mode:15s} n_split {n_split:2d} max_abs_err {err:.3e} "
            f"(tol {tol}) kernel {entry[f'{mode}_kernel_ms']:.4f} ms (eager "
            f"{entry[f'{mode}_eager_ms']:.4f}) plain {entry[f'{mode}_plain_ms']:.4f} ms "
            f"sdpa {entry[f'{mode}_library_ms']:.4f} ms")
        del kg, vg
    # the least time for the cache-plus-new call on these inputs: each
    # valid K/V row (and, int8, its two scales) read once, q/k_new/v_new
    # read and out written once, the walked table entries and lengths
    esz = torch.finfo(dtype).bits // 8
    rows = sum(seq_lens)
    pages_walked = sum(-(-n // P) for n in seq_lens)
    page_bytes = 1 if int8 else esz
    nbytes = (2 * S * H * d + 2 * S * H_kv * d) * esz + 2 * rows * H_kv * d * page_bytes \
        + 4 * (pages_walked + S)
    flops = 4 * (rows + S) * H * d
    if int8:
        nbytes += 2 * rows * H_kv * 4
        flops += 2 * rows * H_kv * d  # value * scale
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    entry.update(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                 bound_bytes=nbytes, bound_flops=flops)
    say(f"kernel {walk:8s} {name:32s} n_split {n_split:2d} bound {entry['bound_ms']:.5f} ms "
        f"({entry['bound_by']}, {nbytes} B)")
    return entry


def _state_err(got, want) -> float:
    """Largest difference of two (acc, m, l) states, relative to the
    weight sum: |dm|, |dl| / max(l, 1) and |dacc| / max(l, 1)."""
    acc, m, l = (t.float() for t in got)
    acc_w, m_w, l_w = (t.float() for t in want)
    w = l_w.clamp_min(1.0)
    return max((m - m_w).abs().max().item(), ((l - l_w).abs() / w).max().item(),
               ((acc - acc_w).abs() / w[..., None]).max().item())


def _library_state(q, k_rows, v_rows, bt, seq_lens, P, P_local, pos_base):
    """Yardstick for the state form: one call of PyTorch's memory-efficient
    attention over this rank's valid rows (gathered, dequantized, padded to
    a multiple of 16 and repeated to every query head beforehand), which
    returns the log-sum-exp — the state's m + log(l). Returns (fn, lse)."""
    import torch

    S, H, d = q.shape
    H_kv = k_rows.shape[2]
    dev, dtype = q.device, q.dtype
    lists = []
    for n in seq_lens:
        lists.append([(j, r) for j in range(-(-n // P)) for r in range(P_local)
                      if j * P + pos_base + r < n])
    L = max(16, -(-max(len(x) for x in lists) // 16) * 16)
    kg = torch.zeros(S, H, L, d, device=dev, dtype=dtype)
    vg = torch.zeros_like(kg)
    bias = torch.full((S, H, 1, L), float("-inf"), device=dev, dtype=dtype)
    for s_, rows in enumerate(lists):
        if not rows:
            continue
        pages = bt[s_, torch.tensor([j for j, _ in rows], device=dev)].long()
        offs = torch.tensor([r for _, r in rows], device=dev)
        kg[s_, :, : len(rows)] = k_rows[pages, offs].to(dtype).repeat_interleave(
            H // H_kv, dim=1).transpose(0, 1)
        vg[s_, :, : len(rows)] = v_rows[pages, offs].to(dtype).repeat_interleave(
            H // H_kv, dim=1).transpose(0, 1)
        bias[s_, :, :, : len(rows)] = 0
    q4 = q[:, :, None, :].contiguous()

    def fn(_i=0):
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            q4, kg, vg, bias, True)

    return fn, fn()[1][:, :, 0]


def run_state_case(case, int8: bool) -> dict:
    """The state form on each sp rank's slice against its plain version;
    the ranks' states merged with the self term against the mode-1 kernel
    over whole pages; kernel / plain / library times and the bound."""
    import torch

    from agentcontrolplane_tpu_torch.ops import paged as plain
    from agentcontrolplane_tpu_torch.ops.cuda import paged_attention as pa
    from agentcontrolplane_tpu_torch.ops.quant import kv_dequantize, kv_quantize

    name, dtype_name, H, H_kv, d, P, sp, max_pages, seq_lens, n_layers = case
    P_local = P // sp
    if seq_lens == SPLIT_BOUNDARIES:
        seq_lens = _boundary_lens(8, H_kv, P_local, P, max_pages)
    walk = "int8" if int8 else dtype_name
    dev = torch.device("cuda")
    dtype = getattr(torch, dtype_name)
    S = len(seq_lens)
    n_split = _split_plan(S, H_kv, P_local, max_pages)[0]
    tables, num_pages = _tables(seq_lens, P, max_pages)
    g = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)

    q = randn(S, H, d)
    k_pool = randn(n_layers, num_pages, P, H_kv, d)
    v_pool = randn(n_layers, num_pages, P, H_kv, d)
    k_new, v_new = randn(S, H_kv, d), randn(S, H_kv, d)
    k_sc = v_sc = None
    if int8:
        (k_pool, k_sc), (v_pool, v_sc) = kv_quantize(k_pool), kv_quantize(v_pool)
    bt = torch.from_numpy(tables).to(dev)
    sl = torch.tensor(seq_lens, dtype=torch.int32, device=dev)

    def rank_slice(i, r):
        """Layer i's pools cut to sp rank r's rows, as the rank holds them."""
        rows = slice(r * P_local, (r + 1) * P_local)
        out = {"k": k_pool[i][:, rows].contiguous(), "v": v_pool[i][:, rows].contiguous()}
        if int8:
            out["k_scales"] = k_sc[i][:, rows].contiguous()
            out["v_scales"] = v_sc[i][:, rows].contiguous()
        return out

    slices = [[rank_slice(i, r) for r in range(sp)] for i in range(n_layers)]

    def state(i, r, fn=pa.paged_decode_state):
        t = slices[i][r]
        kw = {k: v for k, v in t.items() if k.endswith("scales")}
        return fn(q, t["k"], t["v"], bt, sl, pos_base=r * P_local, global_page_size=P, **kw)

    tol = MAX_BF16_ERR if dtype == torch.bfloat16 else MAX_F32_ERR
    entry = {"case": name, "walk": walk, "dtype": dtype_name, "S": S, "H": H, "H_kv": H_kv,
             "d": d, "P": P, "P_local": P_local, "sp": sp, "max_pages": max_pages,
             "seq_lens": seq_lens, "state_tol": MAX_STATE_ERR, "merge_tol": tol,
             "n_split": n_split}
    states, err = [], 0.0
    for r in range(sp):
        got = state(0, r)
        torch.cuda.synchronize()
        want = state(0, r, plain.paged_decode_state_reference)
        if not all(torch.isfinite(t).all() for t in got):
            fail(f"state {walk} {name} rank {r}: non-finite state")
        e = _state_err(got, want)
        again = state(0, r)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"state {walk} {name} rank {r}: two launches on the same inputs differ")
        empty = torch.tensor([sum(1 for j in range(-(-n // P)) for x in range(P_local)
                                  if j * P + r * P_local + x < n) == 0 for n in seq_lens],
                             device=dev)
        if empty.any():
            acc, m, l = got
            if not ((m[empty] == -1e30).all() and (l[empty] == 0).all()
                    and (acc[empty] == 0).all()):
                fail(f"state {walk} {name} rank {r}: a lane with no valid row is not "
                     "(acc 0, m -1e30, l 0)")
        if "poisoned" in name:
            t = slices[0][r]
            kq, vq, ks, vs = t["k"].clone(), t["v"].clone(), t["k_scales"].clone(), t["v_scales"].clone()
            for a in (kq, vq):
                a[0] = 127
            for a in (ks, vs):
                a[0] = 1e30
            for s_, n in enumerate(seq_lens):
                for j in range(-(-n // P)):
                    page = int(tables[s_, j])
                    for x in range(P_local):
                        if j * P + r * P_local + x >= n:
                            kq[page, x] = vq[page, x] = 127
                            ks[page, x] = vs[page, x] = 1e30
            bad = pa.paged_decode_state(q, kq, vq, bt, sl, pos_base=r * P_local,
                                        global_page_size=P, k_scales=ks, v_scales=vs)
            if not all(torch.equal(a, b) for a, b in zip(bad, got)):
                fail(f"state {walk} {name} rank {r}: poisoned masked rows changed the state")
        if e > MAX_STATE_ERR:
            fail(f"state {walk} {name} rank {r}: |kernel - plain| = {e:.3e} > {MAX_STATE_ERR}")
        err = max(err, e)
        states.append(got)
    entry["state_max_err"] = err
    # merge the ranks' states as the sp group does, fold the self term, and
    # hold that against the mode-1 kernel over whole pages
    acc, m, l = (torch.stack(x) for x in zip(*states))
    acc, m, l = plain.merge_sp_states(acc, m, l, lambda x: x.amax(0, keepdim=True),
                                      lambda x: x.sum(0, keepdim=True))
    merged = plain.fold_self_term(q, k_new, v_new, acc[0], m[0], l[0])
    scales = {"k_scales": k_sc[0], "v_scales": v_sc[0]} if int8 else {}
    whole = pa.paged_decode_attention_cache_plus_new(q, k_pool[0], v_pool[0], bt, sl,
                                                     k_new, v_new, **scales)
    merge_err = (merged.float() - whole.float()).abs().max().item()
    if merge_err > tol:
        fail(f"state {walk} {name}: merged ranks vs whole-page kernel {merge_err:.3e} > {tol}")
    entry["merge_max_abs_err"] = merge_err
    # times on rank 0's slice (it holds at least as many valid rows as any)
    entry["kernel_ms"] = graph_ms(lambda i: state(i % n_layers, 0), 32)
    entry["plain_ms"] = cuda_ms(
        lambda i: state(i % n_layers, 0, plain.paged_decode_state_reference), 10, warmup=1)
    t = slices[0][0]
    k_rows = kv_dequantize(t["k"], t["k_scales"], dtype) if int8 else t["k"]
    v_rows = kv_dequantize(t["v"], t["v_scales"], dtype) if int8 else t["v"]
    lib, lse = _library_state(q, k_rows, v_rows, bt, seq_lens, P, P_local, 0)
    acc0, m0, l0 = states[0]
    live = l0 > 0
    entry["library_max_abs_err"] = (lse.float() - (m0 + torch.log(l0)))[live].abs().max().item()
    entry["library_ms"] = graph_ms(lib, 16)
    esz = torch.finfo(dtype).bits // 8
    rows = sum(sum(1 for j in range(-(-n // P)) for x in range(P_local) if j * P + x < n)
               for n in seq_lens)
    pages_walked = sum(-(-n // P) for n in seq_lens)
    page_bytes = 1 if int8 else esz
    nbytes = S * H * d * esz + 2 * rows * H_kv * d * page_bytes + S * H * (d + 2) * 4 \
        + 4 * (pages_walked + S)
    flops = 4 * rows * H * d
    if int8:
        nbytes += 2 * rows * H_kv * 4
        flops += 2 * rows * H_kv * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    entry.update(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                 bound_bytes=nbytes, bound_flops=flops, rank0_rows=rows)
    say(f"state  {walk:8s} {name:34s} n_split {n_split:2d} state err {err:.3e} "
        f"(tol {MAX_STATE_ERR}) merged vs whole "
        f"{merge_err:.3e} (tol {tol}) kernel {entry['kernel_ms']:.4f} ms plain "
        f"{entry['plain_ms']:.4f} ms library {entry['library_ms']:.4f} ms bound "
        f"{entry['bound_ms']:.5f} ms ({entry['bound_by']}, {nbytes} B)")
    return entry


def kernel_phase() -> dict:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 plain version in full f32
    torch.backends.cudnn.allow_tf32 = False
    results = {"bf16": [], "int8": [], "state_bf16": [], "state_int8": []}
    for key, cases, int8 in (("bf16", CASES, False), ("int8", INT8_CASES, True)):
        for case in cases:
            results[key].append(run_case(case, int8))
            torch.cuda.empty_cache()
    for key, cases, int8 in (("state_bf16", STATE_CASES, False),
                             ("state_int8", INT8_STATE_CASES, True)):
        for case in cases:
            results[key].append(run_state_case(case, int8))
            torch.cuda.empty_cache()
    return results


# -- model phase ---------------------------------------------------------


def model_phase() -> dict:
    """tiny f32: paged prefill + teacher-forced decode on the card (the
    kernel) and on the CPU (its plain version), same weights — unquantized
    (the f32 walk), then with int8 weights and an int8 KV cache (the int8
    walk)."""
    import dataclasses

    import torch

    from agentcontrolplane_tpu_torch.engine.weights import random_params
    from agentcontrolplane_tpu_torch.models import llama
    from agentcontrolplane_tpu_torch.ops.cuda import paged_attention as pa
    from agentcontrolplane_tpu_torch.ops.quant import quantize_params

    torch.backends.cuda.matmul.allow_tf32 = False  # compare f32 with f32
    cfg = dataclasses.replace(llama.PRESETS["tiny"], vocab_size=512, max_seq_len=256)
    dense = random_params(cfg, 0, "cpu")
    seq = torch.randint(0, 512, (21,), generator=torch.Generator().manual_seed(3))
    plen, P = 13, 8
    n_steps = len(seq) - plen
    table = torch.tensor([[2, 4, 6, 0]], dtype=torch.int32)
    doc = {}
    for label, quantized in (("tiny-f32", False), ("tiny-f32-int8", True)):
        cpu_params = quantize_params(dense) if quantized else dense
        gpu_params = {
            k: ({n: (type(t)(t.q.cuda(), t.scale.cuda()) if hasattr(t, "q") else t.cuda())
                 for n, t in v.items()} if k == "layers" else v.cuda())
            for k, v in cpu_params.items()
        }
        logits, pools = {}, {}
        launches0, int8_0 = pa.LAUNCHES, pa.INT8_LAUNCHES
        for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
            pages = llama.init_paged_cache(cfg, 8, P, device=dev, quantize_kv=quantized)
            toks = torch.zeros(1, 16, dtype=torch.long)
            toks[0, :plen] = seq[:plen]
            pages, lg = llama.prefill_paged_batch(
                params, pages, toks.to(dev), torch.tensor([plen], device=dev),
                table[:, :2].to(dev), cfg)
            steps = [lg]
            for pos in range(plen, len(seq)):
                pages, lg = llama.decode_step_paged(
                    params, pages, seq[pos : pos + 1].to(dev),
                    torch.tensor([pos], dtype=torch.int32, device=dev), table.to(dev),
                    torch.tensor([True], device=dev), cfg)
                steps.append(lg)
            logits[dev] = torch.cat(steps).cpu()
            pools[dev] = {n: t.cpu() for n, t in pages.items()}
        launches, int8_launches = pa.LAUNCHES - launches0, pa.INT8_LAUNCHES - int8_0
        want = cfg.n_layers * n_steps
        if launches != want or int8_launches != (want if quantized else 0):
            fail(f"model {label}: {launches} launches ({int8_launches} int8), want {want} "
                 f"{'int8' if quantized else 'f32'}")
        err = (logits["cuda"] - logits["cpu"]).abs().max().item()
        entry = {"logits_max_abs_err": err, "decode_steps": n_steps}
        if quantized:
            # one int8 step of difference where the card's and the CPU's f32
            # K/V round to different sides of a half is allowed, and counted
            for n in ("k", "v"):
                diff = (pools["cuda"][n][:, 1:].int() - pools["cpu"][n][:, 1:].int()).abs()
                if diff.max().item() > 1:
                    fail(f"model {label}: int8 {n} pools differ by {diff.max().item()} steps")
                entry[f"{n}_int8_diffs"] = int((diff > 0).sum())
            for n in ("ks", "vs"):
                a, b = pools["cuda"][n][:, 1:], pools["cpu"][n][:, 1:]
                rel = ((a - b).abs() / b.abs().clamp_min(1e-30)).max().item()
                if rel > 1e-5:
                    fail(f"model {label}: scales {n} differ by {rel:.2e} relative")
        if not torch.allclose(logits["cuda"], logits["cpu"], rtol=2e-4, atol=2e-4):
            fail(f"model {label}: card logits differ from the CPU's by {err:.3e} (tol 2e-4)")
        say(f"model {label} prefill+{n_steps} decode steps: card vs cpu max |dlogit| {err:.3e} "
            f"(tol 2e-4); {launches} launches ({int8_launches} int8)"
            + (f"; int8 pool entries differing by one step: k {entry['k_int8_diffs']}, "
               f"v {entry['v_int8_diffs']}" if quantized else ""))
        doc[label] = entry
    doc["engines"] = tiny_engine_runs(cfg, dense)
    return doc


TWO_CALLS = '{"name": "t1", "arguments": {"x": 1}} {"name": "t2", "arguments": {}}'
TINY_CHUNKED_ROW = [1 + (i * 7) % 250 for i in range(200)]
TINY_PERSONA = "p" * 40  # five pages of 8
TINY_TAILS = [f"-{ch * 4}" for ch in "abcd"]
# speculation on the tiny engines: the reference's tool-echo fixture and the
# busy group of tests/test_torch_megastep.py (three chunked rows, one plain)
TINY_ECHO = '{"tool": "search", "args": {"q": "x"}} {"tool": "search", "args": {"q": "x"}}'
TINY_BUSY = [("abcabcabc " * 8, 30), ("the quick brown fox jumps over " * 4, 10),
             ("pack my box with five dozen jugs " * 3, 10), ("hi, a short one", 8)]


def tiny_engine_runs(cfg, dense: dict) -> dict:
    """The tiny f32 model's engines on the card and on the CPU, same
    weights: six 20-token prompts (12 tokens each) on a 9-page pool, so
    they preempt and resume; a two-turn conversation whose second turn
    adopts the first's parked slot; a 200-token row prefilled in 16-token
    chunks; and a burst of four requests on one 40-token persona, three of
    which share the first's pages. Greedy tokens must equal an uncontended
    run's (each prompt alone; the turns, the row and the burst's requests
    on an engine without parking, prefix cache, chunking or dedup) on the
    card, and the CPU engines' tokens. Then speculation: the tool-echo
    prompt and a busy group chunked in 16-token chunks, with spec_len 0
    and 6 on the same engine; the streams must be equal, and the
    speculating run must have verified and accepted drafts."""
    import torch

    from agentcontrolplane_tpu_torch.engine.engine import Engine, SamplingParams
    from agentcontrolplane_tpu_torch.engine.tokenizer import ByteTokenizer
    from agentcontrolplane_tpu_torch.ops.cuda import paged_attention as pa

    kw = dict(max_slots=4, max_ctx=256, prefill_buckets=(32, 64, 128, 256), decode_block_size=4,
              page_size=8)
    prompts = [ch * 20 for ch in "abcdef"]
    turn1 = "user question " * 4
    turn2 = turn1 + "assistant said things; tool results; next question"
    forced = tuple(ByteTokenizer().encode(TWO_CALLS))

    def runs(dev: str) -> dict:
        params = dense if dev == "cpu" else {
            k: ({n: t.cuda() for n, t in v.items()} if k == "layers" else v.cuda())
            for k, v in dense.items()}
        engines = {"roomy": Engine(cfg, params, device=dev, **kw),
                   "tight": Engine(cfg, params, device=dev, kv_pages=10, **kw),
                   "plain": Engine(cfg, params, device=dev, park_max_s=0,
                                   prefix_cache_entries=0, prefix_dedup=False, **kw)}
        for e in engines.values():
            e.start()
        try:
            sp = SamplingParams(max_tokens=12)
            out = {"uncontended": [engines["roomy"].generate(p, sp).tokens for p in prompts]}
            tight = engines["tight"]
            with tight.hold_admission():
                futs = [tight.submit(p, sp) for p in prompts]
            res = [f.result(timeout=120) for f in futs]
            out["preempted"] = [r.tokens for r in res]
            out["preempt_counts"] = [r.preempt_count for r in res]
            # the same with the host tier on: the resumes restore their rows
            tight.set_host_kv_bytes(1 << 22)
            with tight.hold_admission():
                futs = [tight.submit(p, sp) for p in prompts]
            out["preempted_host"] = [f.result(timeout=120).tokens for f in futs]
            out["host_swaps"] = [tight.kv_swap_outs, tight.kv_swap_ins]
            roomy, plain = engines["roomy"], engines["plain"]
            s1, s2 = SamplingParams(max_tokens=16, forced_prefix=forced), SamplingParams(
                max_tokens=8)
            r1 = roomy.submit(turn1, s1, on_tool_call=lambda i, tc: None, park=True).result(120)
            r2 = roomy.submit(turn2, s2).result(120)
            out["parked"] = [r1.tokens, r2.tokens]
            out["adoptions"] = roomy.stats()["tool_overlap"]["park_adoptions"]
            out["unparked"] = [plain.generate(turn1, s1).tokens, plain.generate(turn2, s2).tokens]
            # the turns again, the parked slot expiring into the host tier
            # between them: the second restores it by token prefix
            roomy.set_host_kv_bytes(1 << 22)
            _forget_prefixes(roomy)
            r1 = roomy.submit(turn1, s1, on_tool_call=lambda i, tc: None, park=True).result(120)
            _idle_parked(roomy)
            _forget_prefixes(roomy)
            out["expired"] = [r1.tokens, roomy.submit(turn2, s2).result(120).tokens]
            out["expiry_swaps"] = [roomy.kv_swap_outs, roomy.kv_swap_ins]
            roomy.set_host_kv_bytes(0)
            # the chunked row and the burst fused (the default), then split;
            # each run cold (no prefix-cache entry from the one before)
            fused0 = roomy.megastep_dispatches
            for mode in ("", "_split"):
                roomy.megastep = not mode
                roomy.prefill_chunk = 16
                out["chunked" + mode] = roomy.generate(TINY_CHUNKED_ROW, sp).tokens
                roomy.prefill_chunk = 0
                _forget_prefixes(roomy)
                shares0 = roomy.prefix_shares
                with roomy.hold_admission():
                    futs = [roomy.submit(TINY_PERSONA + t, sp) for t in TINY_TAILS]
                out["burst" + mode] = [f.result(timeout=120).tokens for f in futs]
                out["shares" + mode] = roomy.prefix_shares - shares0
                _forget_prefixes(roomy)
            roomy.megastep = True
            out["megastep_dispatches"] = roomy.megastep_dispatches - fused0
            out["unchunked"] = plain.generate(TINY_CHUNKED_ROW, sp).tokens
            out["alone"] = [plain.generate(TINY_PERSONA + t, sp).tokens for t in TINY_TAILS]
            for mode, spec_len in (("", 0), ("_spec", 6)):
                roomy.spec_len = spec_len
                _forget_prefixes(roomy)
                out["echo" + mode] = roomy.generate(TINY_ECHO, SamplingParams(max_tokens=40)).tokens
                roomy.prefill_chunk = 16
                with roomy.hold_admission():
                    futs = [roomy.submit(p, SamplingParams(max_tokens=m)) for p, m in TINY_BUSY]
                out["busy" + mode] = [f.result(timeout=120).tokens for f in futs]
                roomy.prefill_chunk = 0
            roomy.spec_len = 0
            out["spec_dispatches"] = roomy.spec_dispatches
            out["spec_accepted"] = roomy.spec_accepted
            # a verify pass is a decode step that runs no walk
            out["walk_steps"] = sum(e.decode_steps - e.spec_dispatches for e in engines.values())
            return out
        finally:
            for e in engines.values():
                e.stop()

    cpu = runs("cpu")
    pa.LAUNCHES = pa.INT8_LAUNCHES = 0
    card = runs("cuda")
    walk = _walk_check("model engines", card["walk_steps"], cfg.n_layers, False)
    for name, ok in (
        ("preempted", sum(card["preempt_counts"]) >= 1),
        ("preempted = uncontended on the card", card["preempted"] == card["uncontended"]),
        ("swapped and restored", min(card["host_swaps"]) >= 1),
        ("preempted with the host tier = uncontended on the card",
         card["preempted_host"] == card["uncontended"]),
        ("an expired park restored", card["expiry_swaps"] == [1, 1]),
        ("restored turns = unparked on the card", card["expired"] == card["unparked"]),
        ("adopted", card["adoptions"] == 1),
        ("parked turns = unparked on the card", card["parked"] == card["unparked"]),
        ("chunked = unchunked on the card", card["chunked"] == card["unchunked"]),
        ("3 shares in the burst", card["shares"] == card["shares_split"] == len(TINY_TAILS) - 1),
        ("the burst = each request alone on the card", card["burst"] == card["alone"]),
        ("fused", card["megastep_dispatches"] > 0),
        ("the megastep on = off on the card", (card["chunked"], card["burst"])
         == (card["chunked_split"], card["burst_split"])),
        ("spec on = off on the card", (card["echo"], card["busy"])
         == (card["echo_spec"], card["busy_spec"])),
        ("verified and accepted drafts", card["spec_dispatches"] > 0
         and card["spec_accepted"] > 0),
        ("the card's streams = the CPU's", {k: v for k, v in card.items() if k != "walk_steps"}
         == {k: v for k, v in cpu.items() if k != "walk_steps"}),
    ):
        if not ok:
            fail(f"model engines: not {name}: card {card}, cpu {cpu}")
    say(f"model engines tiny-f32: 6 requests on a 9-page pool, preempt counts "
        f"{card['preempt_counts']}, tokens = each prompt alone, and so with the host tier on "
        f"({card['host_swaps'][0]} swap-outs, {card['host_swaps'][1]} restores); two turns, the "
        f"second adopting the first's parked slot, and again restoring it from the host tier "
        f"after it expired, = an engine without parking or cache; a "
        f"{len(TINY_CHUNKED_ROW)}-token row in chunks of 16 = unchunked; a burst of "
        f"{len(TINY_TAILS)} on one persona ({card['shares']} shares) = each alone, both with the "
        f"megastep on ({card['megastep_dispatches']} fused dispatches) = off; all = the "
        f"CPU engines' tokens; the echo prompt and the busy group with spec_len 6 "
        f"({card['spec_dispatches']} verify passes, {card['spec_accepted']} drafts accepted) = "
        f"spec_len 0 = the CPU's; walk launches {walk} = {cfg.n_layers} x {card['walk_steps']} "
        f"(decode steps less verify passes)")
    return {"card": card, "cpu": cpu, "launches": walk}


# -- serving phase -------------------------------------------------------


def _post(base: str, body: dict) -> tuple[int, dict]:
    req = urllib.request.Request(
        base + "/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _check_reply(status: int, doc: dict, max_tokens: int, what: str) -> int:
    if status != 200:
        fail(f"serving {what}: HTTP {status}: {doc}")
    try:
        msg = doc["choices"][0]["message"]
        n = doc["usage"]["completion_tokens"]
        ok = (doc["object"] == "chat.completion" and msg["role"] == "assistant"
              and doc["usage"]["total_tokens"] == doc["usage"]["prompt_tokens"] + n)
    except (KeyError, IndexError, TypeError):
        ok = False
    if not ok:
        fail(f"serving {what}: malformed reply {doc}")
    if not 1 <= n <= max_tokens:
        fail(f"serving {what}: completion_tokens {n} not in [1, {max_tokens}]")
    return n


def _post_sse(base: str, body: dict) -> tuple[int, list[str]]:
    """POST a ``stream: true`` body: (status, every event's data)."""
    req = urllib.request.Request(
        base + "/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            if r.headers.get("Content-Type") != "text/event-stream":
                return r.status, []
            raw = r.read().decode()
            return r.status, [e[len("data: "):] for e in raw.split("\n\n")[:-1]]
    except urllib.error.HTTPError as e:
        return e.code, [e.read().decode()]


def _forced_call(status: int, doc: dict, name: str) -> str:
    """The arguments of the one tool call a forced reply must be, parsed by
    the port's toolparse from the reply's call; raises ValueError."""
    from agentcontrolplane_tpu_torch.engine.toolparse import parse_tool_calls

    try:
        choice = doc["choices"][0]
        (call,) = choice["message"]["tool_calls"]
        fn = call["function"]
        (parsed,) = parse_tool_calls(json.dumps({"name": fn["name"],
                                                 "arguments": json.loads(fn["arguments"])}))
    except (KeyError, IndexError, TypeError, ValueError) as e:
        raise ValueError(f"HTTP {status}: not one parseable tool call ({e!r}): {doc}") from None
    if status != 200 or choice["finish_reason"] != "tool_calls" or parsed.function.name != name:
        raise ValueError(f"HTTP {status}: not a call to {name}: {doc}")
    return fn["arguments"]


def profile_window(run, card: str, label: str = "") -> dict:
    """Device time by kernel over one serving run, from ``torch.profiler``'s
    CUDA activity, and the card's busy share: that device time over the
    wall time of the same run made again without the profiler (which slows
    the host, not the kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.monotonic()
    run()
    wall_ms = (time.monotonic() - t0) * 1e3
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _res, steps = run()
            torch.cuda.synchronize()
    except RuntimeError as e:  # an observation, not a phase: record why it is missing
        say(f"profile: not measured ({e!r})")
        return {"error": repr(e)}
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count)
         for e in prof.key_averages() if e.self_device_time_total > 0),
        key=lambda kv: -kv[1],
    )
    busy_ms = sum(ms for _, ms, _ in kernels)
    launches = sum(n for _, _, n in kernels)
    raw_ops = _raw_device_ops(prof)  # device_ops()'s count of the same window
    if raw_ops != launches:
        say(f"profile {label}: {raw_ops} ops on the raw events against {launches}")
    doc = {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms, "decode_steps": steps,
        "raw_device_ops": raw_ops,
        "busy_share": busy_ms / wall_ms,
        "device_ops_per_decode_step": launches / steps if steps else None,
        "top": [{"kernel": k[:120], "ms": ms, "count": n} for k, ms, n in kernels[:10]],
    }
    say(f"profile {label} (8 requests x 32 tokens): device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms "
        f"wall ({100 * doc['busy_share']:.1f}%); {launches} device ops, "
        f"{doc['device_ops_per_decode_step']:.0f} per decode step  [{card}]")
    for t in doc["top"]:
        say(f"  {t['ms']:9.3f} ms  x{t['count']:<6d} {t['kernel'][:90]}")
    return doc


def _raw_device_ops(prof) -> int:
    """Device ops (kernels and copies with device time) in a finished
    ``torch.profiler`` window, counted on its raw events: the count
    ``key_averages()`` gives, without building its event tree (tens of
    seconds for a window of 50,000 kernels)."""
    from torch.autograd import DeviceType

    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0)


def device_ops(run) -> tuple[int, object]:
    """(device ops in one ``run()``, from ``torch.profiler``'s CUDA
    activity; what ``run()`` returned)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    return _raw_device_ops(prof), out


def _pool_bytes(cache: dict) -> int:
    return sum(t.numel() * t.element_size() for t in cache.values())


def weight_product_ms(params: dict, cfg, slots: int = 8) -> float:
    """Device ms of one decode step's weight products: the seven matmuls of
    every layer through ``quant.matmul`` at ``slots`` tokens, captured in a
    CUDA graph (for int8 weights this includes the eager int8 -> bf16
    conversion of each matrix)."""
    import torch

    from agentcontrolplane_tpu_torch.models.llama import _layer
    from agentcontrolplane_tpu_torch.ops.quant import matmul as mm

    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(slots, 1, cfg.dim, generator=g, device="cuda").to(cfg.dtype)
    a = torch.randn(slots, 1, cfg.n_heads * cfg.head_dim, generator=g, device="cuda").to(cfg.dtype)
    f = torch.randn(slots, 1, cfg.ffn_dim, generator=g, device="cuda").to(cfg.dtype)
    layers = [_layer(params, i) for i in range(cfg.n_layers)]

    def step(_i):
        for w in layers:
            mm(x, w["wq"]), mm(x, w["wk"]), mm(x, w["wv"]), mm(a, w["wo"])
            mm(x, w["w1"]), mm(x, w["w3"]), mm(f, w["w2"])

    with torch.inference_mode():
        return graph_ms(step, 1, replays=5)


def serving_phase(card: str, label: str, constrained: bool = False, slot_ref=None,
                  **engine_kw) -> dict:
    """llama3-8b at full width behind the HTTP server. ``engine_kw`` picks
    the int8 knobs; with ``quantize_kv`` the int8 walk must serve every
    decode layer, otherwise the f32/bf16 walk. ``constrained`` runs the
    constrained phase on the same engine after the timed window; the
    control-plane phase and then the operator phase run on it last, then
    (bf16) the observability phase and, over the same params, the slot
    phase (``slot_ref``: the bf16 slot phase's first-step logits, for the
    int8 one)."""
    import torch

    from agentcontrolplane_tpu_torch.engine.engine import Engine, SamplingParams
    from agentcontrolplane_tpu_torch.models.llama import forward
    from agentcontrolplane_tpu_torch.ops.cuda import paged_attention as pa
    from agentcontrolplane_tpu_torch.server.rest import make_server, serve_in_thread

    int8_walk = bool(engine_kw.get("quantize_kv"))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    engine = Engine("llama3-8b", device="cuda", seed=0, max_slots=8, max_ctx=2048,
                    page_size=16, decode_block_size=8, **engine_kw)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    init_peak = torch.cuda.max_memory_allocated()
    cfg = engine.config
    pool_bytes = _pool_bytes(engine.cache)
    say(f"serving {label} llama3-8b: dim {cfg.dim}, {cfg.n_layers} layers, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, vocab {cfg.vocab_size}, "
        f"{engine.weight_bytes / 1e9:.3f} GB of weights (quantize={engine.quantize}), "
        f"{engine.num_pages} pages = {pool_bytes / 1e9:.3f} GB of KV pool "
        f"(quantize_kv={engine.quantize_kv}); init {init_s:.2f} s, peak "
        f"{init_peak / 1e9:.2f} GB  [{card}]")
    with torch.inference_mode():
        lg = forward(engine.params, torch.arange(16, device="cuda")[None] + 256, cfg)
    if lg.shape != (1, 16, cfg.vocab_size) or not torch.isfinite(lg).all():
        fail(f"serving {label}: llama3-8b forward logits {tuple(lg.shape)} not finite/shaped")
    ref_logits = first_step_logits(engine.params, cfg, None, "cuda", engine.quantize_kv)
    wp_ms = weight_product_ms(engine.params, cfg)
    say(f"serving {label}: one decode step's weight products (8 slots, {cfg.n_layers} layers x 7 "
        f"matmuls) take {wp_ms:.3f} ms of device time  [{card}]")
    engine.start()
    server = make_server(engine, "127.0.0.1", 0)
    serve_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        def chat(i, temperature=0.0, top_p=None, max_tokens=32):
            body = {"model": "llama3-8b", "max_tokens": max_tokens, "temperature": temperature,
                    "messages": [{"role": "system", "content": "You are a helpful agent."},
                                 {"role": "user", "content": f"Request {i}: plan the next step."}]}
            if top_p is not None:
                body["top_p"] = top_p
            return _post(base, body)

        _check_reply(*chat("warm-up", max_tokens=4), 4, f"{label} warm-up")
        # the counted run: counts to 0 just before, read just after
        pa.LAUNCHES = 0
        pa.INT8_LAUNCHES = 0
        steps0 = engine.decode_steps
        replies: dict = {}
        threads = [threading.Thread(target=lambda i=i: replies.__setitem__(i, chat(i)))
                   for i in range(4)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 300
        while engine.decode_steps == steps0 and time.monotonic() < deadline:
            time.sleep(0.001)
        if engine.decode_steps == steps0:
            fail(f"serving {label}: decoding never started")
        late = threading.Thread(
            target=lambda: replies.__setitem__("sampled", chat("late", 0.7, 0.9)))
        late.start()
        for t in [*threads, late]:
            t.join(timeout=600)
        launches, int8_launches = pa.LAUNCHES, pa.INT8_LAUNCHES
        steps = engine.decode_steps - steps0
        if len(replies) != 5:
            fail(f"serving {label}: {len(replies)} of 5 replies arrived")
        n_tokens = [_check_reply(*replies[k], 32, f"{label} request {k}") for k in replies]
        walk_launches = int8_launches if int8_walk else launches - int8_launches
        other = launches - walk_launches
        walk = "int8" if int8_walk else "bf16"
        if walk_launches != cfg.n_layers * steps or steps == 0 or other:
            fail(f"serving {label}: {walk_launches} {walk}-walk launches (and {other} of the "
                 f"other walk) for {steps} decode steps x {cfg.n_layers} layers")
        say(f"serving {label}: 5 chat completions OK, completion tokens {n_tokens}; {walk}-walk "
            f"launches {walk_launches} = {cfg.n_layers} layers x {steps} decode steps, "
            f"other walk {other}")
        stats = engine.stats()
        if not _pool_whole(engine):
            fail(f"serving {label}: pages or slots not released after the run: {stats}")
        # the pages still allocated are the prefix-cache entries'
        held = engine.num_pages - 1 - stats["kv_pages"]["free"]
        if stats["memory"]["quantized_kv"] != {"enabled": int8_walk,
                                               "pages": held if int8_walk else 0}:
            fail(f"serving {label}: stats quantized_kv {stats['memory']['quantized_kv']}")

        # a greedy batch admitted as one group, run twice: identical tokens
        def batch(n, max_tokens):
            with engine.hold_admission():
                futs = [engine.submit(f"Task {i}: summarize the incident report.",
                                      SamplingParams(max_tokens=max_tokens)) for i in range(n)]
                s0 = engine.decode_steps
            res = [f.result(timeout=600) for f in futs]
            return res, engine.decode_steps - s0

        run_a, _ = batch(4, 32)
        run_b, steps_b = batch(4, 32)
        if [r.tokens for r in run_a] != [r.tokens for r in run_b]:
            fail(f"serving {label}: the same greedy batch gave different tokens on a second run")
        say(f"serving {label}: greedy batch of 4 repeated -> identical tokens")
        perf = {"card": card, "walk": walk, "launches": walk_launches, "decode_steps": steps,
                "init_s": init_s, "init_peak_bytes": init_peak,
                "weight_bytes": engine.weight_bytes, "pool_bytes": pool_bytes,
                "num_pages": engine.num_pages, "quantize": engine.quantize,
                "quantize_kv": engine.quantize_kv, "weight_product_ms": wp_ms}
        for blabel, (res, nsteps) in (("batch4", (run_b, steps_b)), ("batch8", batch(8, 128))):
            decode_ms = max(r.latency_ms for r in res) - max(r.ttft_ms for r in res)
            dec_tokens = sum(max(0, len(r.tokens) - 1) for r in res)
            perf[blabel] = {
                "ttft_ms_mean": sum(r.ttft_ms for r in res) / len(res),
                "ttft_ms_max": max(r.ttft_ms for r in res),
                "decode_steps": nsteps,
                "ms_per_decode_step": decode_ms / nsteps,
                "decode_tokens_per_s": dec_tokens / (decode_ms / 1e3),
            }
            p = perf[blabel]
            say(f"serving {label} {blabel}: TTFT mean {p['ttft_ms_mean']:.1f} ms max "
                f"{p['ttft_ms_max']:.1f} ms; {p['ms_per_decode_step']:.2f} ms per decode step; "
                f"{p['decode_tokens_per_s']:.1f} decode tokens/s  [{card}]")
        perf["profile"] = profile_window(lambda: batch(8, 32), card, label)
        perf["first_step_logits"] = ref_logits
        if constrained:
            perf["constrained"] = constrained_phase(engine, base, card, perf["profile"])
        perf["kv_reuse"] = kv_reuse_phase(engine, card, label)
        perf["host_kv"] = host_kv_phase(engine, card, label, perf["kv_reuse"]["preemption"])
        perf["chunked"] = chunked_phase(engine, card, label)
        perf["spec"] = spec_phase(engine, card, label)
        perf["control_plane"] = control_plane_phase(engine, card, label)
        perf["operator"] = operator_phase(engine, card, label)
        if label == "bf16":
            perf["observability"] = observability_phase(engine, card, label,
                                                        perf["operator"]["observability_rest"])
            perf["slot"] = slot_phase(engine, card, label, paged=perf["observability"])
        else:
            perf["slot"] = slot_phase(engine, card, label, ref=slot_ref)
        return perf
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()


# -- constrained phase ---------------------------------------------------

TOOLS = [
    {"type": "function", "function": {
        "name": "get_weather", "description": "Current weather for a city.",
        "parameters": {"type": "object", "properties": {"city": {"type": "string"}},
                       "required": ["city"]}}},
    {"type": "function", "function": {
        "name": "search_docs", "description": "Search the team's runbooks.",
        "parameters": {"type": "object", "properties": {"query": {"type": "string"}}}}},
]
TIMING_REPEATS = 3  # kept low: the script's wall


def _force(name: str) -> dict:
    return {"type": "function", "function": {"name": name}}


def _constrained_bodies() -> list[tuple[str, dict]]:
    """The constrained phase's eight requests, labelled."""
    def body(i, max_tokens=48, **extra):
        return {"model": "llama3-8b", "max_tokens": max_tokens, **extra,
                "messages": [{"role": "system", "content": "You are a helpful agent."},
                             {"role": "user", "content": f"Request {i}: check the weather in "
                                                         "Paris, then plan the next step."}]}
    out = [(f"json-{i}", body(i, 24 if i == 0 else 48, response_format={"type": "json_object"}))
           for i in range(4)]
    out += [(f"forced-{n}", body(4 + k, tools=TOOLS, tool_choice=_force(n)))
            for k, n in enumerate(("get_weather", "search_docs"))]
    out.append(("required", body(6, tools=TOOLS, tool_choice="required")))
    out.append(("stream", body(7, tools=TOOLS, tool_choice=_force("get_weather"), stream=True)))
    return out


def _sse_view(events: list[str]) -> dict:
    """An OpenAI streaming client's view of an SSE reply: content, tool
    calls accumulated by index, finish reason, usage."""
    if not events or events[-1] != "[DONE]":
        raise ValueError(f"the last event is not [DONE]: {events[-2:]}")
    content, calls = "", {}
    docs = [json.loads(e) for e in events[:-1]]
    for d in docs:
        if d.get("object") != "chat.completion.chunk":
            raise ValueError(f"not a chunk: {d}")
        delta = d["choices"][0]["delta"]
        content += delta.get("content") or ""
        for tc in delta.get("tool_calls") or []:
            calls[tc["index"]] = (tc["function"]["name"], tc["function"]["arguments"])
    return {"content": content, "calls": [calls[i] for i in sorted(calls)],
            "finish": docs[-1]["choices"][0]["finish_reason"], "usage": docs[-1]["usage"]}


def _reply_view(doc: dict) -> dict:
    msg = doc["choices"][0]["message"]
    return {"content": msg["content"] or "",
            "calls": [(c["function"]["name"], c["function"]["arguments"])
                      for c in msg.get("tool_calls") or []],
            "finish": doc["choices"][0]["finish_reason"], "usage": doc["usage"]}


def constrained_phase(engine, base: str, card: str, plain_profile: dict) -> dict:
    """JSON-constrained decoding, forced tool calls and SSE on the bf16
    llama3-8b engine (already serving at ``base``)."""
    import statistics

    import torch

    from agentcontrolplane_tpu_torch.engine.client import forced_call_prefix
    from agentcontrolplane_tpu_torch.engine.engine import SamplingParams
    from agentcontrolplane_tpu_torch.engine.types import Tool, ToolFunction
    from agentcontrolplane_tpu_torch.ops.cuda import paged_attention as pa
    from agentcontrolplane_tpu_torch.ops.sampling import advance_constraint, constrain_logits

    cfg = engine.config
    bodies = _constrained_bodies()
    t_phase = time.monotonic()
    parts = {}  # wall seconds of each part of this phase

    def group(stream: bool) -> dict:
        """The eight requests admitted as one group in a fixed order (each
        queued before the next is sent): label -> (status, reply)."""
        replies: dict = {}
        threads = []
        with engine.hold_admission():
            for k, (name, body) in enumerate(bodies):
                if not stream:
                    body = {b: v for b, v in body.items() if b != "stream"}
                post = _post_sse if body.get("stream") else _post
                threads.append(threading.Thread(
                    target=lambda n=name, b=body, f=post: replies.__setitem__(n, f(base, b))))
                threads[-1].start()
                deadline = time.monotonic() + 60
                while engine.stats()["waiting"] < k + 1 and time.monotonic() < deadline:
                    time.sleep(0.001)
                if engine.stats()["waiting"] < k + 1:
                    fail(f"constrained: request {name} never reached the queue")
        for t in threads:
            t.join(timeout=600)
        if len(replies) != len(bodies):
            fail(f"constrained: {len(replies)} of {len(bodies)} replies arrived")
        return replies

    # the counted run: counts to 0 just before, read just after
    pa.LAUNCHES = pa.INT8_LAUNCHES = 0
    steps0 = engine.decode_steps
    t0 = time.monotonic()
    first = group(stream=True)
    wall_s = time.monotonic() - t0
    launches, steps = pa.LAUNCHES, engine.decode_steps - steps0
    if launches != cfg.n_layers * steps or steps == 0 or pa.INT8_LAUNCHES:
        fail(f"constrained: {launches} walk launches ({pa.INT8_LAUNCHES} int8) for {steps} "
             f"decode steps x {cfg.n_layers} layers")
    views = {}
    try:
        for name, body in bodies:
            status, reply = first[name]
            if name == "stream":
                if status != 200:
                    fail(f"constrained: stream HTTP {status}: {reply}")
                views[name] = _sse_view(reply)
                (call,) = views[name]["calls"]
                if call[0] != "get_weather" or views[name]["finish"] != "tool_calls":
                    fail(f"constrained: the stream is not a call to get_weather: {views[name]}")
                json.loads(call[1])
                continue
            if status != 200:
                fail(f"constrained: {name} HTTP {status}: {reply}")
            views[name] = view = _reply_view(reply)
            if name.startswith("forced-"):
                _forced_call(status, reply, name[len("forced-"):])
            elif view["calls"]:  # a JSON object that is a call (to an offered tool)
                for _, args in view["calls"]:
                    json.loads(args)
            elif not isinstance(json.loads(view["content"]), dict):
                fail(f"constrained: {name} is not a JSON object: {view['content']!r}")
            n = reply["usage"]["completion_tokens"]
            if "tools" not in body and n > body["max_tokens"]:
                fail(f"constrained: {name} took {n} tokens, max_tokens {body['max_tokens']}")
    except ValueError as e:
        fail(f"constrained: {e}")
    # the same group again, the stream's body unstreamed: the stream must
    # carry exactly its reply, and every other reply must repeat. The cache
    # is emptied first, so the repeat prefills as the first group did
    parts["first_group"] = wall_s
    _forget_prefixes(engine)
    t0 = time.monotonic()
    second = group(stream=False)
    parts["second_group"] = time.monotonic() - t0
    for name, _ in bodies:
        again = _reply_view(second[name][1])
        if name == "stream":
            got = views["stream"]
            if (got["calls"], got["content"], got["finish"], got["usage"]) != (
                    again["calls"], again["content"], again["finish"], again["usage"]):
                fail(f"constrained: the stream {got} differs from the unstreamed reply {again}")
        elif again != views[name]:
            fail(f"constrained: {name} changed on a repeat: {views[name]} then {again}")
    stats = engine.stats()
    table_bytes, build_s = stats["constraint_table_bytes"], stats["constraint_table_build_s"]
    if not 0 < table_bytes < 8 * 2**20:
        fail(f"constrained: the JSON table takes {table_bytes} bytes on the card")
    if not _pool_whole(engine):
        fail(f"constrained: pages or slots not released: {stats}")
    say(f"constrained: 8 concurrent requests OK in {wall_s:.2f} s (4 json_object, one of 24 "
        f"tokens; 2 forced tools; 1 required; 1 SSE stream = its unstreamed reply, last event "
        f"[DONE]); walk launches {launches} = {cfg.n_layers} x {steps} decode steps; JSON table "
        f"{table_bytes} B on the card, built in {build_s:.2f} s  [{card}]")

    def batch(json_only: bool, n: int = 8, max_tokens: int = 32):
        with engine.hold_admission():
            futs = [engine.submit(f"Task {i}: summarize the incident report as JSON.",
                                  SamplingParams(max_tokens=max_tokens, json_only=json_only))
                    for i in range(n)]
            s0 = engine.decode_steps
        res = [f.result(timeout=600) for f in futs]
        return res, engine.decode_steps - s0

    def row(res, nsteps):
        decode_ms = max(r.latency_ms for r in res) - max(r.ttft_ms for r in res)
        return {"ms_per_decode_step": decode_ms / nsteps, "decode_steps": nsteps,
                "tokens": sum(len(r.tokens) for r in res)}

    # the constrained lanes close their objects early (data-dependent), so
    # each unconstrained run is given the same number of decode steps
    t0 = time.monotonic()
    rows = {False: [], True: []}
    for _ in range(TIMING_REPEATS):
        res, nsteps = batch(True)
        rows[True].append(row(res, nsteps))
        rows[False].append(row(*batch(False, max_tokens=nsteps + 1)))
    timing = {}
    for json_only, label in ((False, "unconstrained"), (True, "constrained")):
        ms = [r["ms_per_decode_step"] for r in rows[json_only]]
        timing[label] = {"median_ms_per_decode_step": statistics.median(ms),
                         "runs": rows[json_only]}
    say(f"constrained: ms per decode step at 8 slots, median of {TIMING_REPEATS}: constrained "
        f"{timing['constrained']['median_ms_per_decode_step']:.2f} (runs "
        f"{[round(r['ms_per_decode_step'], 2) for r in rows[True]]}, steps "
        f"{[r['decode_steps'] for r in rows[True]]}) vs unconstrained "
        f"{timing['unconstrained']['median_ms_per_decode_step']:.2f} (runs "
        f"{[round(r['ms_per_decode_step'], 2) for r in rows[False]]}, steps "
        f"{[r['decode_steps'] for r in rows[False]]})  [{card}]")
    parts["timing"] = time.monotonic() - t0
    # device ops per decode step over equal step counts: one profile window
    # of the 8 requests constrained (max_tokens 32), then one of the same
    # requests unconstrained given as many decode steps; a window of each
    # with max_tokens 1 (prefill and first token only) gives the ops that
    # are not decode steps
    t0 = time.monotonic()
    ops = {}
    for json_only, label in ((True, "constrained"), (False, "unconstrained")):
        max_tokens = 32 if json_only else ops["constrained"]["decode_steps"] + 1
        whole, (_res, nsteps) = device_ops(lambda j=json_only, m=max_tokens: batch(j,
                                                                                 max_tokens=m))
        prefill, _ = device_ops(lambda j=json_only: batch(j, max_tokens=1))
        ops[label] = {"window_ops": whole, "prefill_window_ops": prefill, "decode_steps": nsteps,
                      "raw_per_decode_step": whole / nsteps,
                      "per_decode_step": (whole - prefill) / nsteps}
    if ops["constrained"]["decode_steps"] != ops["unconstrained"]["decode_steps"]:
        fail(f"constrained: the ops windows ran {ops['constrained']['decode_steps']} and "
             f"{ops['unconstrained']['decode_steps']} decode steps, not as many")
    parts["ops_windows"] = time.monotonic() - t0
    # the masks alone at this decode shape (8 lanes, every lane constrained):
    # device time per step from a CUDA graph, the host's rate issuing them
    # eagerly, and their device ops
    dev = engine.device
    g = torch.Generator(device=dev).manual_seed(2)
    table, min_close = engine._get_token_table(), engine._min_close
    logits = torch.randn(8, cfg.vocab_size, generator=g, device=dev)
    states = torch.randint(0, table.shape[0], (8,), generator=g, device=dev, dtype=torch.int32)
    toks = torch.randint(0, table.shape[1], (8,), generator=g, device=dev)
    lanes = torch.ones(8, dtype=torch.bool, device=dev)
    budgets = torch.full((8,), 16, dtype=torch.int32, device=dev)

    def masks(_i=0):
        constrain_logits(logits, table, states, lanes, min_close, budgets)
        return advance_constraint(table, states, lanes, toks)

    t0 = time.monotonic()
    mask = {"device_ms": graph_ms(masks, 16), "eager_ms": cuda_ms(masks, 100),
            "device_ops": device_ops(masks)[0]}
    parts["masks"] = time.monotonic() - t0
    con, unc = ops["constrained"], ops["unconstrained"]
    say(f"constrained: device ops per decode step {con['per_decode_step']:.1f} constrained vs "
        f"{unc['per_decode_step']:.1f} unconstrained, +"
        f"{con['per_decode_step'] - unc['per_decode_step']:.1f} (8 requests over "
        f"{con['decode_steps']} decode steps each; a profile window of each less its "
        f"max_tokens-1 window; whole windows {con['raw_per_decode_step']:.1f} / "
        f"{unc['raw_per_decode_step']:.1f} per step, the serving phase's "
        f"{plain_profile.get('device_ops_per_decode_step')} over 32 steps); the masks "
        f"alone at 8 x {cfg.vocab_size}: {mask['device_ops']} ops, "
        f"{mask['device_ms']:.4f} ms of device time (CUDA graph), {mask['eager_ms']:.4f} ms a "
        f"step issued eagerly  [{card}]")
    # TTFT needs the first token only: max_tokens 1 (the forced envelope is
    # not counted in it), so no decode step is paid for
    t0 = time.monotonic()
    tool = Tool(function=ToolFunction(name="get_weather"))
    forced = SamplingParams(max_tokens=1, json_only=True, forced_prefix=forced_call_prefix(
        engine.tokenizer, [tool], "get_weather"))
    prompt = "Request 8: check the weather in Paris, then plan the next step."
    ttft = {}
    for label, sp in (("forced", forced), ("plain", SamplingParams(max_tokens=1))):
        ttft[label] = statistics.median(engine.generate(prompt, sp).ttft_ms
                                        for _ in range(TIMING_REPEATS))
    parts["ttft"] = time.monotonic() - t0
    say(f"constrained: TTFT of a forced tool call {ttft['forced']:.1f} ms vs {ttft['plain']:.1f} "
        f"ms unforced, one request alone, median of {TIMING_REPEATS}  [{card}]")
    phase_s = time.monotonic() - t_phase
    say(f"constrained: phase wall {phase_s:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()) + f" s; the table build, {build_s:.2f} s, "
        f"inside the first group)  [{card}]")
    return {"card": card, "launches": launches, "decode_steps": steps, "wall_s": wall_s,
            "phase_s": phase_s, "parts_s": parts,
            "table_bytes": table_bytes, "table_build_s": build_s, "timing": timing,
            "device_ops": ops, "masks": mask, "ttft_ms": ttft,
            "replies": views}


# -- kv reuse phase ------------------------------------------------------

KV_CONVERSATIONS = 4
KV_TURNS = 3
KV_FIRST_PROMPT = 768  # tokens of each conversation's first prompt
KV_TURN_TOKENS = 32  # sampled tokens a turn (greedy)
KV_TOOL_RESULT = 64  # tokens of the tool result appended after each turn
KV_REPEATS = 1
CONT_ROW, CONT_CUT = 1024, 960  # the continuation check's row and its cached prefix
CONT_TOL = 2e-2  # relative L2 of the continuation's last-token logits vs the whole row's
PREEMPT_PAGES = 257  # the preemption engine's pool: 256 usable pages of 16
# the prompts alone fill the pool, so the group preempts at its first page
# crossing; 128 sampled tokens keep the script's wall
PREEMPT_REQUESTS, PREEMPT_PROMPT, PREEMPT_TOKENS = 8, 512, 128


def _idle_parked(engine) -> None:
    """Let the engine expire its parked slots itself (its loop owns them),
    then restore the knob."""
    keep, engine.park_max_s = engine.park_max_s, 1e-3
    deadline = time.monotonic() + 60
    while engine.stats()["parked_slots"] and time.monotonic() < deadline:
        time.sleep(0.005)
    engine.park_max_s = keep
    if engine.stats()["parked_slots"]:
        fail("parked slots did not expire")


def _forget_prefixes(engine) -> None:
    """Evict every prefix-cache entry. Only while the engine idles: its
    thread touches the allocator only when it admits or decodes."""
    while engine._evict_one_prefix_entry():
        pass


def _pool_whole(engine) -> bool:
    """Idle and every page free or held by a prefix-cache entry or a parked
    slot."""
    held = {p for e in list(engine._prefix_cache.values()) for p in e["pages"]}
    held |= {p for s, sl in list(engine._slots.items()) if sl.parked
             for p in engine._slot_pages.get(s, [])}
    s = engine.stats()
    return not s["active_slots"] and s["kv_pages"]["free"] + len(held) == engine.num_pages - 1


def _walk_check(what: str, steps: int, n_layers: int, int8_walk: bool) -> int:
    """The counted part's walk launches (counts set to 0 just before it):
    n_layers x decode steps of the expected walk, none of the other."""
    from agentcontrolplane_tpu_torch.ops.cuda import paged_attention as pa

    walk = pa.INT8_LAUNCHES if int8_walk else pa.LAUNCHES - pa.INT8_LAUNCHES
    other = pa.LAUNCHES - walk
    if steps <= 0 or walk != n_layers * steps or other:
        fail(f"{what}: {walk} walk launches (other walk {other}) for {steps} decode steps x "
             f"{n_layers} layers")
    return walk


def _rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def _whole_row_int8_prefix(engine, row):
    """Last-token logits of one pass over the whole row in which rows from
    CONT_CUT on attend rows [0, CONT_CUT) as an int8 pool holds them
    (quantized, then dequantized in f32) and their own rows at full
    precision, while the rows before CONT_CUT attend at full precision as
    their prefill did: the function the continuation computes over int8
    pages, without the cache."""
    import torch

    from agentcontrolplane_tpu_torch.models import llama
    from agentcontrolplane_tpu_torch.ops.attention import blocked_causal_attention
    from agentcontrolplane_tpu_torch.ops.norms import rms_norm
    from agentcontrolplane_tpu_torch.ops.quant import kv_dequantize, kv_quantize

    cfg, params = engine.config, engine.params
    positions = torch.arange(row.shape[1], device=row.device)[None]

    def as_pool(t):
        q8, scale = kv_quantize(t[:, :CONT_CUT])
        return torch.cat([kv_dequantize(q8, scale, torch.float32), t[:, CONT_CUT:].float()], 1)

    with torch.inference_mode():
        x = llama._embed(params, row, cfg)
        def attn(q, k, v):
            full = blocked_causal_attention(q, k, v, positions)
            pooled = blocked_causal_attention(q, as_pool(k), as_pool(v), positions)
            return torch.cat([full[:, :CONT_CUT], pooled[:, CONT_CUT:]], 1)

        for i in range(cfg.n_layers):
            x, _, _ = llama._attn_mlp(x, llama._layer(params, i), cfg, positions, attn)
        x = rms_norm(x[:, -1], params["norm"], cfg.norm_eps)
        return llama._head_logits(x, params, cfg)


def continuation_check(engine, card: str, label: str) -> dict:
    """The model's continuation against a whole prefill: a 1,024-token row
    prefilled whole, and its first 960 tokens prefilled then its last 64
    continued over the pages just written (a 128-column table, the
    engine's); the last-token logits must agree within CONT_TOL. With int8
    KV the continuation reads the prefix as the int8 pool holds it, so it
    is held against a whole-row pass that reads the same values
    (``_whole_row_int8_prefix``); its distance from the plain whole-row
    prefill, which attends the prefix at full precision, is reported."""
    import torch

    from agentcontrolplane_tpu_torch.models import llama

    cfg, P, dev = engine.config, engine.page_size, "cuda"
    n_pages = CONT_ROW // P
    row = torch.randint(0, 256, (1, CONT_ROW), generator=torch.Generator().manual_seed(11))
    row = row.to(dev)
    with torch.inference_mode():
        pages = llama.init_paged_cache(cfg, 1 + 2 * n_pages, P, device=dev,
                                       quantize_kv=engine.quantize_kv)
        whole_ids = torch.arange(1, 1 + n_pages, device=dev)[None]
        pages, whole = llama.prefill_paged_batch(
            engine.params, pages, row, torch.tensor([CONT_ROW], device=dev), whole_ids, cfg)
        ids = torch.arange(1 + n_pages, 1 + 2 * n_pages, device=dev)[None]
        table = torch.zeros(1, engine.max_pages_per_seq, dtype=torch.int32, device=dev)
        table[0, :n_pages] = ids[0]
        pages, _ = llama.prefill_paged_batch(
            engine.params, pages, row[:, :CONT_CUT], torch.tensor([CONT_CUT], device=dev),
            ids[:, : CONT_CUT // P], cfg)
        walls = []
        for _ in range(2):  # the second call is the one timed warm
            torch.cuda.synchronize()
            t0 = time.monotonic()
            pages, cont = llama.prefill_paged_continue(
                engine.params, pages, row[:, CONT_CUT:], torch.tensor([CONT_ROW - CONT_CUT],
                                                                      device=dev),
                torch.tensor([CONT_CUT], device=dev), ids[:, CONT_CUT // P:], table, cfg)
            torch.cuda.synchronize()
            walls.append((time.monotonic() - t0) * 1e3)
    doc = {"rel_l2_whole": _rel_l2(cont[0], whole[0]), "continue_ms": walls[1],
           "continue_first_ms": walls[0]}
    if engine.quantize_kv:
        doc["rel_l2"] = _rel_l2(cont[0], _whole_row_int8_prefix(engine, row)[0])
        against = "a whole-row pass reading the prefix as the int8 pool holds it"
    else:
        doc["rel_l2"] = doc["rel_l2_whole"]
        against = f"the {CONT_ROW}-token row prefilled whole"
    if not torch.isfinite(cont).all() or doc["rel_l2"] > CONT_TOL:
        fail(f"kv reuse {label}: continuation logits {doc['rel_l2']:.3e} relative L2 from "
             f"{against} (tol {CONT_TOL})")
    whole_l2 = (f"; vs the row prefilled whole {doc['rel_l2_whole']:.3e}"
                if engine.quantize_kv else "")
    say(f"kv reuse {label}: {CONT_ROW - CONT_CUT}-token continuation over {CONT_CUT} cached "
        f"rows vs {against}: last-token logits {doc['rel_l2']:.3e} relative L2 (tol "
        f"{CONT_TOL}){whole_l2}; continuation {walls[1]:.2f} ms warm ({walls[0]:.2f} first)  "
        f"[{card}]")
    return doc


def conversations(engine, card: str, label: str, seed: int, park: bool) -> dict:
    """KV_CONVERSATIONS conversations of KV_TURNS turns, each turn's four
    requests admitted as one group (so no save evicts an entry another
    turn still has to match); every turn's prompt is the last prompt + its
    sampled tokens + a KV_TOOL_RESULT-token tool result. With ``park`` turn
    2 on adopts the parked slot of turn 1; without, it hits the prefix
    cache. Either way only the suffix is prefilled."""
    import torch

    from agentcontrolplane_tpu_torch.engine.engine import SamplingParams

    g = torch.Generator().manual_seed(seed)
    prompts = [torch.randint(0, 256, (KV_FIRST_PROMPT,), generator=g).tolist()
               for _ in range(KV_CONVERSATIONS)]
    P = engine.page_size
    turns, reused = [], None
    for turn in range(KV_TURNS):
        s0 = engine.stats()
        with engine.hold_admission():
            futs = [engine.submit(p, SamplingParams(max_tokens=KV_TURN_TOKENS), park=park)
                    for p in prompts]
        res = [f.result(timeout=600) for f in futs]
        s1 = engine.stats()
        pc0, pc1 = s0["prefix_cache"], s1["prefix_cache"]
        doc = {
            "ttft_ms": [r.ttft_ms for r in res],
            "prompt_tokens": [len(p) for p in prompts],
            "prefill_tokens": s1["prefill_tokens"] - s0["prefill_tokens"],
            "adoptions": s1["tool_overlap"]["park_adoptions"] - s0["tool_overlap"][
                "park_adoptions"],
            "hits": pc1["hits"] - pc0["hits"], "misses": pc1["misses"] - pc0["misses"],
            "decode_steps": s1["decode_steps"] - s0["decode_steps"],
        }
        # the rows each request had resident: a parked slot's prompt rows,
        # or the previous turn's cache entry (its prompt less one row)
        want = sum(len(p) for p in prompts) if reused is None else sum(
            len(p) - c for p, c in zip(prompts, reused))
        doc["expected_prefill_tokens"] = want
        if doc["prefill_tokens"] != want:
            fail(f"kv reuse {label} turn {turn + 1}: {doc['prefill_tokens']} rows prefilled, "
                 f"the suffixes hold {want}")
        turns.append(doc)
        reused = [(len(p) // P if park else (len(p) - 1) // P) * P for p in prompts]
        prompts = [p + r.tokens + torch.randint(0, 256, (KV_TOOL_RESULT,), generator=g).tolist()
                   for p, r in zip(prompts, res)]
    later = turns[1:]
    n = KV_CONVERSATIONS * (KV_TURNS - 1)
    if park:
        bad = (sum(t["adoptions"] for t in later), sum(t["misses"] for t in later),
               sum(t["hits"] for t in later)) != (n, 0, 0)
    else:
        bad = (sum(t["hits"] for t in later), sum(t["misses"] for t in later)) != (n, 0)
    if bad:
        fail(f"kv reuse {label}: turns 2-{KV_TURNS} {'adopted' if park else 'hit'} "
             f"{[(t['adoptions'], t['hits'], t['misses']) for t in later]} (adoptions, hits, "
             f"misses), want {n} {'adoptions' if park else 'hits'} and no miss")
    return {"turns": turns}


def preemption_check(engine, card: str, label: str) -> dict:
    """A second engine over the SAME params dict (no second copy of the
    weights) with a 256-page pool: 8 requests of 512-token prompts and
    max_tokens 128 need 40 pages each, 320 in all (the prompts alone fill
    the pool), so it must preempt.
    Every request finishes with as many tokens as the same group run
    uncontended on the serving engine, and the pool is whole after. The
    second engine stays up for the host-tier phase, which reruns the group
    on it with the tier on: the doc carries it (``_small``), the
    uncontended results and the prompts, and that phase stops it."""
    import torch

    from agentcontrolplane_tpu_torch.engine.engine import Engine, SamplingParams
    from agentcontrolplane_tpu_torch.ops.cuda import paged_attention as pa

    cfg = engine.config
    g = torch.Generator().manual_seed(300)
    prompts = [torch.randint(0, 256, (PREEMPT_PROMPT,), generator=g).tolist()
               for _ in range(PREEMPT_REQUESTS)]
    sp = SamplingParams(max_tokens=PREEMPT_TOKENS)

    def group(eng):
        with eng.hold_admission():
            futs = [eng.submit(p, sp) for p in prompts]
        t0 = time.monotonic()
        res = [f.result(timeout=900) for f in futs]
        return res, time.monotonic() - t0

    # uncontended: the serving engine's pool holds all eight at once
    _idle_parked(engine)
    _forget_prefixes(engine)
    pa.LAUNCHES = pa.INT8_LAUNCHES = 0
    s0 = engine.decode_steps
    solo, solo_s = group(engine)
    solo_walk = _walk_check(f"kv reuse {label} uncontended", engine.decode_steps - s0,
                            cfg.n_layers, engine.quantize_kv)
    if any(r.preempt_count for r in solo):
        fail(f"kv reuse {label}: the uncontended group was preempted")
    small = Engine(cfg, engine.params, device="cuda", seed=0, max_slots=8, max_ctx=2048,
                   page_size=16, decode_block_size=8, kv_pages=PREEMPT_PAGES,
                   quantize_weights=engine.quantize is not None, quantize_kv=engine.quantize_kv)
    pool_gb = sum(t.numel() * t.element_size() for t in small.cache.values()) / 1e9
    small.start()
    try:
        pa.LAUNCHES = pa.INT8_LAUNCHES = 0
        prefill0 = small.prefill_tokens
        res, wall_s = group(small)
        walk = _walk_check(f"kv reuse {label} preemption", small.decode_steps, cfg.n_layers,
                           engine.quantize_kv)
        st = small.stats()
        preempts = [r.preempt_count for r in res]
        lens, solo_lens = [len(r.tokens) for r in res], [len(r.tokens) for r in solo]
        same = sum(r.tokens == s.tokens for r, s in zip(res, solo))
        cached_pages = st["prefix_cache"]["cached_tokens"] // small.page_size
        if sum(preempts) < 1 or st["preemptions"] != sum(preempts):
            fail(f"kv reuse {label}: preemptions {preempts}, engine {st['preemptions']}")
        if lens != solo_lens or any(r.finish_reason != s.finish_reason
                                    for r, s in zip(res, solo)):
            fail(f"kv reuse {label}: preempted token counts {lens} vs uncontended {solo_lens}")
        if st["active_slots"] or st["kv_pages"]["free"] + cached_pages != PREEMPT_PAGES - 1:
            fail(f"kv reuse {label}: after preemption {st['kv_pages']['free']} free + "
                 f"{cached_pages} cached pages != {PREEMPT_PAGES - 1}")
        steps = small.decode_steps
        prefilled = small.prefill_tokens - prefill0
    except BaseException:
        small.stop()
        raise
    say(f"kv reuse {label}: preemption on a {PREEMPT_PAGES - 1}-page pool ({pool_gb:.2f} GB, "
        f"the serving engine's weights): {PREEMPT_REQUESTS} x ({PREEMPT_PROMPT} + "
        f"{PREEMPT_TOKENS}) tokens, preempt counts {preempts} ({sum(preempts)} preemptions), "
        f"token counts equal to the uncontended run's ({same} of {PREEMPT_REQUESTS} streams "
        f"identical), {steps} decode steps in {wall_s:.1f} s vs {solo_s:.1f} s uncontended; "
        f"free {st['kv_pages']['free']} + cached {cached_pages} = {PREEMPT_PAGES - 1} pages; "
        f"walk launches {walk} = {cfg.n_layers} x {steps} (uncontended {solo_walk})  [{card}]")
    return {"preempt_counts": preempts, "token_counts": lens, "identical_streams": same,
            "decode_steps": steps, "wall_s": wall_s, "uncontended_wall_s": solo_s,
            "uncontended_decode_steps": solo_walk // cfg.n_layers, "launches": walk,
            "pool_bytes": pool_gb * 1e9, "free_pages": st["kv_pages"]["free"],
            "cached_pages": cached_pages, "prefill_tokens": prefilled,
            "_small": small, "_solo": solo, "_prompts": prompts}


def kv_reuse_phase(engine, card: str, label: str) -> dict:
    """KV reuse across an agent's turns on the serving llama3-8b engine:
    the continuation's logits, parked turns (adoption), cache hits, and
    preemption on a second, smaller engine; every part's decode steps go
    through the expected walk."""
    import statistics

    from agentcontrolplane_tpu_torch.ops.cuda import paged_attention as pa

    t_phase = time.monotonic()
    cfg, int8_walk = engine.config, engine.quantize_kv
    out = {"card": card, "continuation": continuation_check(engine, card, label)}
    for name, seeds, park in (("parked", [100 + r for r in range(KV_REPEATS)], True),
                              ("cache", [200], False)):
        pa.LAUNCHES = pa.INT8_LAUNCHES = 0
        steps0 = engine.decode_steps
        runs = [conversations(engine, card, label, seed, park) for seed in seeds]
        walk = _walk_check(f"kv reuse {label} {name}", engine.decode_steps - steps0,
                           cfg.n_layers, int8_walk)
        first = [v for r in runs for v in r["turns"][0]["ttft_ms"]]
        later = [v for r in runs for t in r["turns"][1:] for v in t["ttft_ms"]]
        rows = [t["prefill_tokens"] / KV_CONVERSATIONS for t in runs[0]["turns"]]
        counts = [(t["adoptions"], t["hits"], t["misses"]) for r in runs for t in r["turns"]]
        out[name] = {"runs": runs, "launches": walk, "ttft_turn1_ms": statistics.median(first),
                     "ttft_later_ms": statistics.median(later)}
        say(f"kv reuse {label} {name}: {KV_CONVERSATIONS} conversations x {KV_TURNS} turns "
            f"x {len(seeds)} run(s), {KV_FIRST_PROMPT}-token first prompts, "
            f"{KV_TURN_TOKENS} + {KV_TOOL_RESULT} tokens a turn; (adoptions, hits, misses) per "
            f"turn {counts}; rows prefilled per request {rows}; TTFT median turn 1 "
            f"{statistics.median(first):.1f} ms, turns 2-{KV_TURNS} "
            f"{statistics.median(later):.1f} ms; walk launches {walk} = {cfg.n_layers} x "
            f"{walk // cfg.n_layers} decode steps  [{card}]")
    out["preemption"] = preemption_check(engine, card, label)
    out["phase_s"] = time.monotonic() - t_phase
    return out


# -- host KV tier phase --------------------------------------------------

HOST_KV_BYTES = 1 << 30  # the host tier's budget in every part
HOST_LONG_PROMPT, HOST_CHUNK = 1930, 256  # (c): parked as a 1,920-row entry; restore chunks
HOST_RESTORE_CHUNKS = 8  # (c): 7 x 256 + 128 rows
HOST_DECODERS, HOST_DECODER_PROMPT, HOST_DECODE_TOKENS = 4, 64, 128  # (c): the decoding lanes
HOST_SUFFIX, HOST_LONG_TOKENS = 16, 16  # (c): the row past the entry; its budget
HANDOFF_PROMPT, HANDOFF_SUFFIX = 512, 32  # (d)


class _RestoreWatch:
    """On the engine thread: every restore chunk that lands
    (``_advance_restore``) and, at ``_finish_swap_in``, the slot's pages
    held against the entry's rows (``torch.equal``, scale twins included),
    the stall seconds and the time. ``close()`` takes the hooks off."""

    def __init__(self, engine):
        self.engine = engine
        self.chunks: list = []
        self.done: list = []  # (rows, bit-equal, stall s, monotonic time)
        advance, finish = engine._advance_restore, engine._finish_swap_in

        def on_advance(slot, sl, st, n):
            self.chunks.append((st, n))
            advance(slot, sl, st, n)

        def on_finish(slot, sl):
            self.done.append((sl.prefill_pos, self.equal(slot, sl), sl.swap_stall_s,
                              time.monotonic()))
            finish(slot, sl)

        engine._advance_restore, engine._finish_swap_in = on_advance, on_finish

    def equal(self, slot, sl) -> bool:
        import torch

        e, n = self.engine, sl.prefill_pos
        pages = torch.tensor(e._slot_pages[slot][: n // e.page_size], device=e.device)
        entry = sl.swap_entry
        rows = {"k": entry.k, "v": entry.v}
        if "ks" in e.cache:
            rows.update(ks=entry.k_scale, vs=entry.v_scale)
        for name, want in rows.items():
            pool = e.cache[name]
            got = pool.index_select(1, pages).reshape(pool.shape[0], n, *pool.shape[3:])
            if not torch.equal(got, want[:, :n].to(e.device)):
                return False
        return True

    def close(self) -> None:
        del self.engine._advance_restore, self.engine._finish_swap_in


def _host_audit(engine, what: str) -> int:
    """The host pool's accounting: used bytes = the sum of its entries,
    within the budget."""
    pool = engine._host_pool
    used, entries = pool.audit()
    if used != sum(entries.values()) or used > pool.max_bytes:
        fail(f"{what}: host pool used {used} B, entries {sum(entries.values())} B, budget "
             f"{pool.max_bytes} B")
    return used


def _host_preemption(small, card: str, label: str, pre: dict) -> dict:
    """(a) The kv-reuse phase's preemption group again on its 256-page
    engine, the host tier on: the preempted rows go to the host and come
    back as restores. Token counts and finishes equal the uncontended
    run's; walk launches n_layers x decode steps; both pools whole."""
    from agentcontrolplane_tpu_torch.engine.engine import SamplingParams
    from agentcontrolplane_tpu_torch.ops.cuda import paged_attention as pa

    solo, prompts = pre.pop("_solo"), pre.pop("_prompts")
    what = f"host kv {label} (a)"
    _forget_prefixes(small)  # the host-off run's entries would serve these rows
    small.set_host_kv_bytes(HOST_KV_BYTES)
    watch = _RestoreWatch(small)
    c0 = (small.kv_swap_outs, small.kv_swap_ins, small.preemptions, small.prefill_tokens,
          small.decode_steps)
    pa.LAUNCHES = pa.INT8_LAUNCHES = 0
    with small.hold_admission():
        futs = [small.submit(p, SamplingParams(max_tokens=PREEMPT_TOKENS)) for p in prompts]
    t0 = time.monotonic()
    res = [f.result(timeout=900) for f in futs]
    wall_s = time.monotonic() - t0
    steps = small.decode_steps - c0[4]
    walk = _walk_check(what, steps, small.config.n_layers, small.quantize_kv)
    watch.close()
    outs, ins = small.kv_swap_outs - c0[0], small.kv_swap_ins - c0[1]
    preempts = small.preemptions - c0[2]
    prefilled = small.prefill_tokens - c0[3]
    used = _host_audit(small, what)
    st = small.stats()
    cached_pages = st["prefix_cache"]["cached_tokens"] // small.page_size
    if outs < 1 or ins < 1 or preempts < 1:
        fail(f"{what}: {preempts} preemptions, {outs} swap-outs, {ins} swap-ins")
    if not all(ok for _n, ok, _s, _t in watch.done) or len(watch.done) != ins:
        fail(f"{what}: restored pages differ from their entries' rows ({watch.done})")
    if [len(r.tokens) for r in res] != [len(r.tokens) for r in solo] or any(
            r.finish_reason != s.finish_reason for r, s in zip(res, solo)):
        fail(f"{what}: token counts {[len(r.tokens) for r in res]} vs uncontended "
             f"{[len(r.tokens) for r in solo]}")
    if st["active_slots"] or st["kv_pages"]["free"] + cached_pages != PREEMPT_PAGES - 1:
        fail(f"{what}: after the run {st['kv_pages']['free']} free + {cached_pages} cached "
             f"pages != {PREEMPT_PAGES - 1}")
    same = sum(r.tokens == s.tokens for r, s in zip(res, solo))
    restored = sum(n for n, _ok, _s, _t in watch.done)
    stall = sum(s for _n, _ok, s, _t in watch.done)
    say(f"{what}: {PREEMPT_REQUESTS} x ({PREEMPT_PROMPT} + {PREEMPT_TOKENS}) tokens on the "
        f"{PREEMPT_PAGES - 1}-page engine, host tier {HOST_KV_BYTES >> 20} MiB: {preempts} "
        f"preemptions, {outs} swap-outs, {ins} swap-ins (every restored page bit-equal to its "
        f"entry), token counts equal to the uncontended run's; streams identical to it {same} "
        f"of {PREEMPT_REQUESTS} (host tier off: {pre['identical_streams']}); rows restored "
        f"{restored}, rows prefilled by the model {prefilled} (host tier off: "
        f"{pre['prefill_tokens']}); restore stalls {stall * 1e3:.1f} ms; {steps} decode steps "
        f"in {wall_s:.1f} s (off: {pre['decode_steps']} in {pre['wall_s']:.1f} s); host pool "
        f"{used} B after; walk launches {walk} = {small.config.n_layers} x {steps}  [{card}]")
    small.set_host_kv_bytes(0)
    return {"preemptions": preempts, "swap_outs": outs, "swap_ins": ins,
            "identical_streams": same, "identical_streams_host_off": pre["identical_streams"],
            "rows_restored": restored, "prefill_tokens": prefilled,
            "prefill_tokens_host_off": pre["prefill_tokens"], "stall_s": stall,
            "decode_steps": steps, "wall_s": wall_s, "launches": walk, "host_used_bytes": used}


def _host_expiry(engine, card: str, label: str) -> dict:
    """(b) 4 conversations x 2 turns (768-token first prompts, 32 sampled
    + 64 tool tokens), three ways: every parked slot expired between the
    turns with the host tier on (the second turn restores by token
    prefix), parked slots adopted, and expired with the tier off (the
    whole history prefilled again). The prefix cache is emptied before
    each second turn, so only the named mechanism serves it."""
    import torch

    from agentcontrolplane_tpu_torch.engine.engine import SamplingParams
    from agentcontrolplane_tpu_torch.ops.cuda import paged_attention as pa

    what = f"host kv {label} (b)"
    P = engine.page_size
    watch = _RestoreWatch(engine)
    pa.LAUNCHES = pa.INT8_LAUNCHES = 0
    steps0 = engine.decode_steps
    out = {}
    for seed, name, expire, host in ((400, "restored", True, True), (401, "adopted", False, True),
                                     (402, "re-prefilled", True, False)):
        engine.set_host_kv_bytes(HOST_KV_BYTES if host else 0)
        _forget_prefixes(engine)
        g = torch.Generator().manual_seed(seed)
        prompts = [torch.randint(0, 256, (KV_FIRST_PROMPT,), generator=g).tolist()
                   for _ in range(KV_CONVERSATIONS)]
        sp = SamplingParams(max_tokens=KV_TURN_TOKENS)
        with engine.hold_admission():
            futs = [engine.submit(p, sp, park=True) for p in prompts]
        first = [f.result(timeout=600) for f in futs]
        s0 = engine.stats()
        if expire:
            _idle_parked(engine)
        _forget_prefixes(engine)
        s1 = engine.stats()
        turn2 = [p + r.tokens + torch.randint(0, 256, (KV_TOOL_RESULT,), generator=g).tolist()
                 for p, r in zip(prompts, first)]
        with engine.hold_admission():
            futs = [engine.submit(p, sp) for p in turn2]
        res = [f.result(timeout=600) for f in futs]
        s2 = engine.stats()
        h0, h1, h2 = (s["memory"]["host_kv"] for s in (s0, s1, s2))
        # an adopted slot keeps its prompt's whole pages; a host entry
        # stops below the prompt's last row (a strict prefix of its row)
        n = len(prompts[0])
        kept = {"restored": (n - 1) // P * P, "adopted": n // P * P}.get(name, 0)
        doc = {
            "ttft_turn2_ms": statistics.median(r.ttft_ms for r in res),
            "ttft_turn1_ms": statistics.median(r.ttft_ms for r in first),
            "rows_prefilled_turn2": s2["prefill_tokens"] - s1["prefill_tokens"],
            "expected_rows": sum(len(p) - kept for p in turn2),
            "expired": s1["tool_overlap"]["park_releases"] - s0["tool_overlap"]["park_releases"],
            "swap_outs": h1["swap_outs"] - h0["swap_outs"],
            "swap_ins": h2["swap_ins"] - h1["swap_ins"],
            "adoptions": s2["tool_overlap"]["park_adoptions"] - s1["tool_overlap"][
                "park_adoptions"],
        }
        out[name] = doc
        if host:
            _host_audit(engine, what)
    r = out["restored"]
    if (r["swap_outs"], r["expired"], r["swap_ins"]) != (KV_CONVERSATIONS,) * 3:
        fail(f"{what}: {r['expired']} parks expired, {r['swap_outs']} swap-outs, "
             f"{r['swap_ins']} swap-ins in turn 2, want {KV_CONVERSATIONS} each")
    if r["rows_prefilled_turn2"] != r["expected_rows"]:
        fail(f"{what}: turn 2 prefilled {r['rows_prefilled_turn2']} rows, the suffixes past the "
             f"restored rows hold {r['expected_rows']}")
    if not all(ok for _n, ok, _s, _t in watch.done) or len(watch.done) != KV_CONVERSATIONS:
        fail(f"{what}: {len(watch.done)} restores, bit-equal {[d[1] for d in watch.done]}")
    watch.close()
    walk = _walk_check(what, engine.decode_steps - steps0, engine.config.n_layers,
                       engine.quantize_kv)
    say(f"{what}: {KV_CONVERSATIONS} conversations x 2 turns, {KV_FIRST_PROMPT}-token first "
        f"prompts: turn 2 TTFT median (rows prefilled per request): "
        + ", ".join(f"{n} {d['ttft_turn2_ms']:.1f} ms ({d['rows_prefilled_turn2'] / KV_CONVERSATIONS:.0f})"
                    for n, d in out.items())
        + f"; {r['expired']} parks expired, {r['swap_outs']} swap-outs, {r['swap_ins']} "
        f"restores (bit-equal); adoptions {out['adopted']['adoptions']}; walk launches {walk}"
        f"  [{card}]")
    out["launches"] = walk
    return out


def _host_chunked(engine, card: str, label: str) -> dict:
    """(c) A parked 1,930-token prompt expires into a 1,920-row entry,
    restored while 4 lanes decode, with 256-token chunks: in 8 restore
    chunks, then one model chunk of the rest, prefetch on and off; then,
    on bf16, the same row with no entry, prefilled in 7.6 chunks. The restored
    pages are bit-equal to the entry (scale twins included on int8);
    prefetch commits >= 1 on and 0 off; a fused key starts with s16."""
    import torch

    from agentcontrolplane_tpu_torch.engine.engine import SamplingParams
    from agentcontrolplane_tpu_torch.ops.cuda import paged_attention as pa

    what = f"host kv {label} (c)"
    g = torch.Generator().manual_seed(500)
    long = torch.randint(0, 256, (HOST_LONG_PROMPT,), generator=g).tolist()
    row = long + torch.randint(0, 256, (HOST_SUFFIX,), generator=g).tolist()
    decoders = [torch.randint(0, 256, (HOST_DECODER_PROMPT,), generator=g).tolist()
                for _ in range(HOST_DECODERS)]
    cache_on, engine._prefix_enabled = engine._prefix_enabled, False
    engine.set_host_kv_bytes(HOST_KV_BYTES)
    engine.submit(long, SamplingParams(max_tokens=1), park=True).result(timeout=600)
    _idle_parked(engine)
    entry = engine._host_pool.match_prefix(row)
    if entry is None or entry.cut != HOST_CHUNK * (HOST_RESTORE_CHUNKS - 1) + HOST_CHUNK // 2:
        fail(f"{what}: the expired park left no 1,920-row entry ({entry and entry.cut})")
    engine.prefill_chunk = HOST_CHUNK
    pa.LAUNCHES = pa.INT8_LAUNCHES = 0
    steps0 = engine.decode_steps
    runs = {}
    # the row prefilled in chunks beside it on bf16 only (the int8 wall)
    modes = (("prefetch", True), ("blocking", False)) + (
        () if engine.quantize_kv else (("prefill", None),))
    for name, prefetch in modes:
        if prefetch is None:
            engine.set_host_kv_bytes(0)
        else:
            engine.host_prefetch = prefetch
            if engine._host_pool.get(entry.rid) is None:
                engine.inject_host_kv(entry)  # the run before consumed it
        watch = _RestoreWatch(engine)
        keys0, commits0 = set(engine._megastep_shapes), engine.kv_prefetch_commits
        s0 = engine.decode_steps
        futs = [engine.submit(p, SamplingParams(max_tokens=HOST_DECODE_TOKENS))
                for p in decoders]
        deadline = time.monotonic() + 300
        while engine.decode_steps == s0 and time.monotonic() < deadline:
            time.sleep(0.001)
        t0 = time.monotonic()
        r = engine.submit(row, SamplingParams(max_tokens=HOST_LONG_TOKENS)).result(timeout=600)
        res = [f.result(timeout=600) for f in futs]
        watch.close()
        runs[name] = {
            "ttft_ms": r.ttft_ms, "tokens": r.tokens,
            "restore_chunks": watch.chunks, "restores": len(watch.done),
            "bit_equal": all(ok for _n, ok, _s, _t in watch.done),
            "rows_restored": sum(n for n, _ok, _s, _t in watch.done),
            "stall_s": sum(s for _n, _ok, s, _t in watch.done),
            "restore_wall_ms": (watch.done[0][3] - t0) * 1e3 if watch.done else None,
            "prefetch_commits": engine.kv_prefetch_commits - commits0,
            "new_keys": sorted(engine._megastep_shapes - keys0),
            "decoder_tokens": [len(x.tokens) for x in res],
        }
    engine.prefill_chunk, engine.host_prefetch = 0, True
    engine._prefix_enabled = cache_on
    walk = _walk_check(what, engine.decode_steps - steps0, engine.config.n_layers,
                       engine.quantize_kv)
    for name in ("prefetch", "blocking"):
        d = runs[name]
        if (d["restores"], d["rows_restored"], len(d["restore_chunks"])) != (
                1, entry.cut, HOST_RESTORE_CHUNKS) or not d["bit_equal"]:
            fail(f"{what} {name}: {d['restores']} restores of {d['rows_restored']} rows in "
                 f"{len(d['restore_chunks'])} chunks, bit-equal {d['bit_equal']}; want 1 of "
                 f"{entry.cut} in {HOST_RESTORE_CHUNKS}, bit-equal")
    if runs["prefetch"]["prefetch_commits"] < 1 or runs["blocking"]["prefetch_commits"]:
        fail(f"{what}: prefetch commits {runs['prefetch']['prefetch_commits']} on, "
             f"{runs['blocking']['prefetch_commits']} off")
    s_key = f"megastep[paged,s{HOST_CHUNK // engine.page_size}+"  # one group of 16 pages
    if not any(k.startswith(s_key) for k in runs["prefetch"]["new_keys"]):
        fail(f"{what}: no fused key starts with {s_key}: {runs['prefetch']['new_keys']}")
    if runs.get("prefill", {}).get("restores"):
        fail(f"{what}: the run without an entry restored")
    p, b, f = runs["prefetch"], runs["blocking"], runs.get("prefill")
    beside = (f"{f['ttft_ms']:.1f} ms prefilling all {len(row)} rows in chunks; restored vs "
              f"prefilled tokens equal {p['tokens'] == f['tokens']}" if f else "no prefill run")
    say(f"{what}: a {entry.cut}-row entry restored in {HOST_RESTORE_CHUNKS} chunks of "
        f"{HOST_CHUNK} while {HOST_DECODERS} lanes decode, bit-equal with prefetch on and off; "
        f"restore stalls {p['stall_s'] * 1e3:.2f} ms on vs {b['stall_s'] * 1e3:.2f} ms off "
        f"({p['prefetch_commits']} prefetch commits on, {b['prefetch_commits']} off); submit -> "
        f"restored {p['restore_wall_ms']:.1f} / {b['restore_wall_ms']:.1f} ms; the long "
        f"request's TTFT {p['ttft_ms']:.1f} / {b['ttft_ms']:.1f} ms restored (tokens equal on "
        f"vs off {p['tokens'] == b['tokens']}) vs {beside}; new fused keys {p['new_keys']}; walk launches {walk}  [{card}]")
    for d in runs.values():
        d.pop("tokens")
    return {"runs": runs, "entry_rows": entry.cut, "entry_bytes": entry.nbytes,
            "entry_pinned": entry.k.is_pinned(), "launches": walk}


def _host_handoff(engine, card: str, label: str) -> dict:
    """(d) A request with ``export_kv=True``: its ``kv_handoff`` entry is
    injected back into the same engine, then the same row plus a suffix
    restores from ``handoff-<rid>``, bit-equal to the export."""
    import torch

    from agentcontrolplane_tpu_torch.engine.engine import SamplingParams

    what = f"host kv {label} (d)"
    g = torch.Generator().manual_seed(600)
    prompt = torch.randint(0, 256, (HANDOFF_PROMPT,), generator=g).tolist()
    follow = prompt + torch.randint(0, 256, (HANDOFF_SUFFIX,), generator=g).tolist()
    cache_on, engine._prefix_enabled = engine._prefix_enabled, False
    engine.set_host_kv_bytes(HOST_KV_BYTES)
    fut = engine.submit(prompt, SamplingParams(max_tokens=8), export_kv=True)
    r = fut.result(timeout=600)
    e = r.kv_handoff
    want_cut = ((HANDOFF_PROMPT - 1) // engine.page_size) * engine.page_size
    if e is None or e.rid != f"handoff-{fut.rid}" or e.cut != want_cut:
        fail(f"{what}: kv_handoff {e and (e.rid, e.cut)}, want handoff-{fut.rid} of {want_cut}")
    pool = engine._host_pool
    popped: list = []
    pool.pop = lambda rid, real=pool.pop: popped.append(rid) or real(rid)
    watch = _RestoreWatch(engine)
    injects0 = engine.kv_injects
    t0 = time.monotonic()
    if not engine.inject_host_kv(e):
        fail(f"{what}: inject_host_kv refused the entry")
    r2 = engine.submit(follow, SamplingParams(max_tokens=8)).result(timeout=600)
    watch.close()
    del pool.pop
    engine._prefix_enabled = cache_on
    if (engine.kv_injects - injects0, popped, [(n, ok) for n, ok, _s, _t in watch.done]) != (
            1, [e.rid], [(e.cut, True)]):
        fail(f"{what}: injects {engine.kv_injects - injects0}, consumed {popped}, restores "
             f"{watch.done}")
    say(f"{what}: export_kv on a {HANDOFF_PROMPT}-token prompt -> {e.rid} of {e.cut} rows "
        f"({e.nbytes / 1e6:.1f} MB, pinned {e.k.is_pinned()}); injected into the same engine, "
        f"its row + {HANDOFF_SUFFIX} tokens restored it (bit-equal to the export) and "
        f"prefilled the {len(follow) - e.cut} rows past it: TTFT {r2.ttft_ms:.1f} ms (the export's own "
        f"{r.ttft_ms:.1f} ms), inject -> done {(time.monotonic() - t0) * 1e3:.1f} ms  [{card}]")
    return {"rows": e.cut, "bytes": e.nbytes, "ttft_ms": r2.ttft_ms, "export_ttft_ms": r.ttft_ms}


def host_kv_phase(engine, card: str, label: str, pre: dict) -> dict:
    """The host-RAM KV tier on the serving engines: (a) preemption with the
    tier on, on the kv-reuse phase's 256-page engine; (b) park expiry and a
    prefix-match restore (bf16); (c) a chunked restore with prefetch on and
    off; (d) the prefill -> decode handoff (bf16). The tier is off again
    after, as by default."""
    import torch

    t_phase = time.monotonic()
    small = pre.pop("_small")
    try:
        out = {"card": card, "preemption": _host_preemption(small, card, label, pre)}
    finally:
        small.stop()
        del small
        gc.collect()
        torch.cuda.empty_cache()
    try:
        if not engine.quantize_kv:
            out["expiry"] = _host_expiry(engine, card, label)
        out["chunked"] = _host_chunked(engine, card, label)
        if not engine.quantize_kv:
            out["handoff"] = _host_handoff(engine, card, label)
    finally:
        _idle_parked(engine)
        engine.set_host_kv_bytes(0)
    out["phase_s"] = time.monotonic() - t_phase
    return out


# -- chunked prefill / dedup phase --------------------------------------

CHUNK_ROW, CHUNK_SIZE = 1920, 256  # (a): the row, and its chunks (7 KV-only + the final)
CHUNK_F32_TOL = 3e-2  # (a) bf16: each path's relative L2 from the f32 pass
CHUNK_INT8_TOL = 5e-2  # (a) int8 KV: chunked vs whole
HOL_DECODERS, HOL_DECODE_TOKENS = 4, 128  # (b): the lanes decoding when the long row lands
HOL_PROMPT, HOL_LONG_TOKENS = 64, 16  # (b): decoder prompts; the long request's budget
HOL_REPEATS = 1  # (b) once on both engines, as (c) (DEDUP_REPEATS): the script's wall
DEADLINE_SHARE = 0.6  # (d): the deadline, as a share of (b)'s chunked TTFT
DEDUP_REQUESTS, DEDUP_PREFIX, DEDUP_TAIL, DEDUP_TOKENS = 8, 768, 64, 32  # (c)
DEDUP_REPEATS = 1
# (c): pages at the peak, from the shapes: each slot grows to 56 pages (832
# rows + 8 decode blocks of lookahead); dedup shares the prefix's 48
DEDUP_PEAKS = {True: 48 + 8 * (56 - 48), False: 8 * 56}
DEDUP_PEAK_TOL = 0.15


def _f32_logits(engine, row, last: int = 1):
    """Logits of the last ``last`` positions of an f32 pass over ``row``
    ([1, last, V]): every layer's weights cast to f32 as it runs (one
    layer's copy on the card at a time), f32 activations and exact causal
    attention, TF32 off."""
    import dataclasses

    import torch

    from agentcontrolplane_tpu_torch.models import llama
    from agentcontrolplane_tpu_torch.ops.attention import blocked_causal_attention
    from agentcontrolplane_tpu_torch.ops.norms import rms_norm

    cfg = dataclasses.replace(engine.config, dtype=torch.float32)
    params = engine.params
    positions = torch.arange(row.shape[1], device=row.device)[None]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            x = params["embed"][row].float()
            for i in range(cfg.n_layers):
                layer = {k: v.float() for k, v in llama._layer(params, i).items()}
                x, _, _ = llama._attn_mlp(
                    x, layer, cfg, positions,
                    lambda q, k, v: blocked_causal_attention(q, k, v, positions))
            x = rms_norm(x[:, -last:], params["norm"].float(), cfg.norm_eps)
            return x @ params["lm_head"].float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def chunk_check(engine, card: str, label: str) -> dict:
    """(a) A CHUNK_ROW-token row prefilled whole and in CHUNK_SIZE-token
    chunks (KV-only continuations, then the final continuation) on a
    scratch pool. bf16: both last-token logits against an f32 pass of the
    row; int8 KV: the chunked logits against the whole row's."""
    import torch

    from agentcontrolplane_tpu_torch.models import llama

    cfg, P, dev = engine.config, engine.page_size, "cuda"
    n_pages = CHUNK_ROW // P
    row = torch.randint(0, 256, (1, CHUNK_ROW), generator=torch.Generator().manual_seed(13))
    row = row.to(dev)
    with torch.inference_mode():
        pages = llama.init_paged_cache(cfg, 1 + 2 * n_pages, P, device=dev,
                                       quantize_kv=engine.quantize_kv)
        ids = torch.arange(1, 1 + n_pages, device=dev)[None]
        pages, whole = llama.prefill_paged_batch(
            engine.params, pages, row, torch.tensor([CHUNK_ROW], device=dev), ids, cfg)
        ids = torch.arange(1 + n_pages, 1 + 2 * n_pages, device=dev)[None]
        table = torch.zeros(1, engine.max_pages_per_seq, dtype=torch.int32, device=dev)
        table[0, :n_pages] = ids[0]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for st in range(0, CHUNK_ROW, CHUNK_SIZE):
            n = min(CHUNK_SIZE, CHUNK_ROW - st)
            args = (row[:, st: st + n], torch.tensor([n], device=dev),
                    torch.tensor([st], device=dev), ids[:, st // P: (st + n) // P], table, cfg)
            if st + n < CHUNK_ROW:
                pages = llama.prefill_paged_continue_kv(engine.params, pages, *args)
            else:
                pages, chunked = llama.prefill_paged_continue(engine.params, pages, *args)
        torch.cuda.synchronize()
        chunked_ms = (time.monotonic() - t0) * 1e3
    doc = {"chunked_vs_whole": _rel_l2(chunked[0], whole[0]), "chunked_ms": chunked_ms,
           "chunks": -(-CHUNK_ROW // CHUNK_SIZE)}
    if not torch.isfinite(chunked).all() or not torch.isfinite(whole).all():
        fail(f"chunked {label}: logits not finite")
    if engine.quantize_kv:
        if doc["chunked_vs_whole"] > CHUNK_INT8_TOL:
            fail(f"chunked {label}: chunked logits {doc['chunked_vs_whole']:.3e} relative L2 "
                 f"from the whole row's (tol {CHUNK_INT8_TOL})")
        say(f"chunked {label}: a {CHUNK_ROW}-token row in {doc['chunks']} chunks of "
            f"{CHUNK_SIZE} vs prefilled whole: last-token logits "
            f"{doc['chunked_vs_whole']:.3e} relative L2 (tol {CHUNK_INT8_TOL}); the chunks "
            f"took {chunked_ms:.1f} ms  [{card}]")
        return doc
    f32 = _f32_logits(engine, row)[:, -1]
    doc["whole_vs_f32"] = _rel_l2(whole[0], f32[0])
    doc["chunked_vs_f32"] = _rel_l2(chunked[0], f32[0])
    bound = 1.5 * doc["whole_vs_f32"] + 2e-3
    if max(doc["whole_vs_f32"], doc["chunked_vs_f32"]) > CHUNK_F32_TOL or (
            doc["chunked_vs_f32"] > bound):
        fail(f"chunked {label}: relative L2 from the f32 pass: whole {doc['whole_vs_f32']:.3e}, "
             f"chunked {doc['chunked_vs_f32']:.3e} (tol {CHUNK_F32_TOL} each, chunked <= "
             f"{bound:.3e})")
    say(f"chunked {label}: a {CHUNK_ROW}-token row in {doc['chunks']} chunks of {CHUNK_SIZE} "
        f"vs prefilled whole: last-token logits from an f32 pass {doc['chunked_vs_f32']:.3e} "
        f"and {doc['whole_vs_f32']:.3e} relative L2 (tol {CHUNK_F32_TOL}; chunked <= 1.5 x "
        f"whole + 2e-3 = {bound:.3e}); chunked vs whole {doc['chunked_vs_whole']:.3e}; the "
        f"chunks took {chunked_ms:.1f} ms  [{card}]")
    return doc


def hol_run(engine, prompts: list, long_row: list, chunk: int, megastep: bool = True,
            timeout_s: float = 0.0) -> dict:
    """(b) HOL_DECODERS greedy decoders admitted as one group; once they
    decode, the long request arrives (with ``timeout_s``, a deadline), and
    once it has finished or expired the decoders are cancelled. The
    decoders' longest gap between two commits, the long request's TTFT,
    the scheduler's deltas, and the long request's own record: the cycles
    in which it prefilled (the last one samples its first token), its rate
    plans' quotas and its chunks' sizes, read at the engine's own calls;
    the run's fused dispatches, new fused shapes and fallbacks; its walk
    launches and decode steps."""
    from agentcontrolplane_tpu_torch.engine.engine import DeadlineExceededError, SamplingParams
    from agentcontrolplane_tpu_torch.ops.cuda import paged_attention as pa

    stamps = [[] for _ in prompts]
    s0 = engine.stats()
    spent0, total0 = engine._budget_spent_total, engine._budget_total
    shapes0 = set(engine._megastep_shapes)
    launches0, int80, dsteps0 = pa.LAUNCHES, pa.INT8_LAUNCHES, engine.decode_steps
    mine = {"cycles": 0, "quotas": [], "sizes": []}  # the long request's
    real = {name: getattr(engine, name)
            for name in ("_dispatch_once", "_project_quota", "_record_chunk_round")}

    def long_slot(sl):
        return len(sl.request.prompt) == len(long_row)

    def dispatch():  # on the engine thread, like the two below
        if any(sl.prefilling and long_slot(sl) for sl in list(engine._slots.values())):
            mine["cycles"] += 1
        real["_dispatch_once"]()

    def project(slot, sl, reason):
        real["_project_quota"](slot, sl, reason)
        if long_slot(sl):
            mine["quotas"].append(sl.chunk_quota)

    def record(landed, rnd):
        mine["sizes"] += [n for _slot, sl, _st, n in landed if long_slot(sl)]
        real["_record_chunk_round"](landed, rnd)

    with engine.hold_admission():
        futs = [engine.submit(p, SamplingParams(max_tokens=HOL_DECODE_TOKENS),
                              on_tokens=lambda _t, i=i: stamps[i].append(time.monotonic()))
                for i, p in enumerate(prompts)]
    steps0 = engine.decode_steps
    deadline = time.monotonic() + 120
    while engine.decode_steps < steps0 + 2 * engine.decode_block_size:
        if time.monotonic() > deadline:
            fail("chunked: the decoders never started")
        time.sleep(0.001)
    engine.prefill_chunk = chunk  # the decoders were admitted whole either way
    engine.megastep = megastep
    engine._dispatch_once, engine._project_quota, engine._record_chunk_round = (
        dispatch, project, record)
    try:
        long = engine.submit(long_row, SamplingParams(max_tokens=HOL_LONG_TOKENS),
                             timeout_s=timeout_s or None)
        try:
            r = long.result(timeout=300)
            outcome = "finished"
        except DeadlineExceededError:
            r, outcome = None, "deadline expired"
        for f in futs:  # the window that matters is over: stop the decoders
            engine.cancel(f)
        res = [f.result(timeout=300) for f in futs]
    finally:
        for name in real:
            delattr(engine, name)
        engine.megastep = True
    s1 = engine.stats()
    engine.prefill_chunk = 0
    gaps = [b - a for st in stamps for a, b in zip(st, st[1:])]
    m0, m1 = s0["scheduler"]["megastep"], s1["scheduler"]["megastep"]
    return {
        "chunk": chunk, "megastep": megastep, "rate_planner": engine.rate_planner,
        "timeout_s": timeout_s, "outcome": outcome,
        "long_ttft_ms": r.ttft_ms if r else None, "long_tokens": len(r.tokens) if r else None,
        "long_finish": r.finish_reason if r else None,
        "long_stream": list(r.tokens) if r else None,
        "decoder_tokens": [len(x.tokens) for x in res],
        "max_gap_s": max(gaps) if gaps else 0.0,
        "hol_wait_s": s1["scheduler"]["hol_wait_seconds"] - s0["scheduler"]["hol_wait_seconds"],
        "prefill_chunks": s1["scheduler"]["prefill_chunks_total"]
        - s0["scheduler"]["prefill_chunks_total"],
        "budget_utilization": ((engine._budget_spent_total - spent0)
                               / (engine._budget_total - total0))
        if engine._budget_total > total0 else 0.0,
        "long_cycles": mine["cycles"], "quotas": mine["quotas"], "chunk_sizes": mine["sizes"],
        "megastep_dispatches": m1["dispatches"] - m0["dispatches"],
        "megastep_fallbacks": m1["fallbacks"] - m0["fallbacks"],
        "new_shapes": sorted(set(engine._megastep_shapes) - shapes0),
        "launches": pa.LAUNCHES - launches0, "int8_launches": pa.INT8_LAUNCHES - int80,
        "decode_steps": engine.decode_steps - dsteps0,
    }


def _run_line(h: dict) -> str:
    """One (b)/(b')/(d) run, printed."""
    ttft = f"{h['long_ttft_ms']:.1f} ms" if h["long_ttft_ms"] is not None else "none"
    return (f"chunk {h['chunk'] or 'off'}, megastep {'on' if h['megastep'] else 'off'}"
            + (f", planner {'on' if h['rate_planner'] else 'off'}, deadline "
               f"{h['timeout_s']:.3f} s ({h['outcome']})" if h["timeout_s"] else "")
            + f": longest gap {h['max_gap_s'] * 1e3:.1f} ms, long TTFT {ttft}, "
            f"{h['long_cycles']} prefill cycles, chunks {h['chunk_sizes']}, quotas "
            f"{h['quotas']}; megastep dispatches {h['megastep_dispatches']}, new shapes "
            f"{h['new_shapes']}, fallbacks {h['megastep_fallbacks']}; walk launches "
            f"{h['launches']} (int8 {h['int8_launches']}) for {h['decode_steps']} decode steps")


def dedup_burst(engine, prompts: list, dedup: bool) -> dict:
    """(c) The burst admitted as one group, dedup on or off: shares, the
    peak of allocated pages (read at every commit), TTFTs and tokens."""
    from agentcontrolplane_tpu_torch.engine.engine import SamplingParams

    engine.prefix_dedup = dedup
    peak = [0]

    def watch(_toks):  # on the engine thread
        peak[0] = max(peak[0], engine.num_pages - 1 - engine._allocator.free_count)

    shares0 = engine.prefix_shares
    with engine.hold_admission():
        futs = [engine.submit(p, SamplingParams(max_tokens=DEDUP_TOKENS), on_tokens=watch)
                for p in prompts]
    res = [f.result(timeout=300) for f in futs]
    engine.prefix_dedup = True
    return {"shares": engine.prefix_shares - shares0, "peak_pages": peak[0],
            "ttft_ms": [r.ttft_ms for r in res], "tokens": [r.tokens for r in res],
            "finish": [r.finish_reason for r in res]}


def chunked_phase(engine, card: str, label: str) -> dict:
    """Chunked prefill, the megastep, the rate planner and shared-prefix
    dedup on the serving engine: (a) chunked against whole at the model
    level, (b) a long request landing on decoding lanes, whole and chunked
    (fused) in turns, and on bf16 (b') chunked with the megastep off and
    (d) chunked with a deadline, the planner on then off, (c) a burst
    sharing a prefix, dedup on and off in turns; (b) HOL_REPEATS and (c)
    DEDUP_REPEATS times on bf16, once on int8. Parked slots are expired
    and the prefix cache is emptied and off for the phase, so every run is
    cold; the knobs are put back after. Every run's decode steps go
    through the expected walk only."""
    import torch

    from agentcontrolplane_tpu_torch.ops.cuda import paged_attention as pa

    t_phase = time.monotonic()
    cfg, int8_walk = engine.config, engine.quantize_kv
    repeats, dedup_repeats = (1, 1) if int8_walk else (HOL_REPEATS, DEDUP_REPEATS)
    _idle_parked(engine)
    _forget_prefixes(engine)
    cache_on = engine._prefix_enabled
    engine._prefix_enabled = False
    try:
        out = {"card": card, "check": chunk_check(engine, card, label)}
        g = torch.Generator().manual_seed(400)
        hol_prompts = [torch.randint(0, 256, (HOL_PROMPT,), generator=g).tolist()
                       for _ in range(HOL_DECODERS)]
        long_row = torch.randint(0, 256, (CHUNK_ROW,), generator=g).tolist()
        prefix = torch.randint(0, 256, (DEDUP_PREFIX,), generator=g).tolist()
        burst = [prefix + torch.randint(0, 256, (DEDUP_TAIL,), generator=g).tolist()
                 for _ in range(DEDUP_REQUESTS)]
        pa.LAUNCHES = pa.INT8_LAUNCHES = 0
        steps0 = engine.decode_steps
        # (b), and on bf16 (b'): chunk 256 with the megastep off too
        modes = [(0, True), (CHUNK_SIZE, True)] + ([] if int8_walk else [(CHUNK_SIZE, False)])
        hol = [hol_run(engine, hol_prompts, long_row, chunk, megastep)
               for _ in range(repeats) for chunk, megastep in modes]
        deadline_runs = []
        if not int8_walk:
            # (d): the deadline is a share of this run's chunked TTFT
            flat = statistics.median(h["long_ttft_ms"] for h in hol
                                     if h["chunk"] and h["megastep"])
            for planner in (True, False):
                engine.rate_planner = planner
                deadline_runs.append(hol_run(engine, hol_prompts, long_row, CHUNK_SIZE,
                                             timeout_s=DEADLINE_SHARE * flat / 1e3))
            engine.rate_planner = True
        dedup = [dedup_burst(engine, burst, on) for _ in range(dedup_repeats)
                 for on in (True, False)]
        walk = _walk_check(f"chunked {label}", engine.decode_steps - steps0, cfg.n_layers,
                           int8_walk)
    finally:
        engine._prefix_enabled = cache_on
        engine.prefill_chunk, engine.prefix_dedup = 0, True
    if not _pool_whole(engine) or engine.stats()["prefilling_slots"]:
        fail(f"chunked {label}: pages or slots not released: {engine.stats()}")
    views = {(h["long_tokens"], h["long_finish"]) for h in hol if h["megastep"]}
    if len(views) != 1:
        fail(f"chunked {label}: the long request's tokens and finish differ across modes: "
             f"{views}")
    for h in hol + deadline_runs:
        walked = h["int8_launches"] if int8_walk else h["launches"] - h["int8_launches"]
        if h["megastep"] and h["chunk"] and (
                h["megastep_dispatches"] < 1 or h["megastep_fallbacks"]
                or walked != cfg.n_layers * h["decode_steps"] or walked != h["launches"]):
            fail(f"chunked {label}: a fused run dispatched no megastep, fell back, or its walk "
                 f"launches are not {cfg.n_layers} x its decode steps: {_run_line(h)}")
    fused = [h for h in hol if h["chunk"] and h["megastep"]]
    split = [h for h in hol if h["chunk"] and not h["megastep"]]
    same_streams = all(h["long_stream"] == fused[0]["long_stream"] for h in fused + split)
    if deadline_runs:
        planned = deadline_runs[0]
        q = planned["quotas"][0] if planned["quotas"] else 1
        size = min(q * CHUNK_SIZE, engine.prefill_buckets[-1])
        sizes = planned["chunk_sizes"]
        whole = sizes and all(n == size for n in sizes[:-1]) and sizes[-1] <= size
        # the cycle that samples the first token is the last one counted
        within = -(-CHUNK_ROW // CHUNK_SIZE)
        first_by = -(-within // q) + 1
        if (q < 2 or not whole or (planned["outcome"] == "finished"
                                   and planned["long_cycles"] > first_by)):
            fail(f"chunked {label} (d): quota {planned['quotas']} (want >= 2), chunks {sizes} "
                 f"(want {size} each), first token after {planned['long_cycles']} cycles (want "
                 f"<= {first_by})")
    for i, d in enumerate(dedup):
        on = i % 2 == 0  # the runs alternate dedup on, off
        want = DEDUP_REQUESTS - 1 if on else 0
        if d["shares"] != want:
            fail(f"chunked {label}: a burst shared {d['shares']} times, want {want}")
        expect = DEDUP_PEAKS[on]
        if abs(d["peak_pages"] - expect) > DEDUP_PEAK_TOL * expect:
            fail(f"chunked {label}: a burst's page peak {d['peak_pages']}, want {expect} "
                 f"(+-{DEDUP_PEAK_TOL:.0%})")
    base = dedup[0]
    for d in dedup[1:]:
        if [len(t) for t in d["tokens"]] != [len(t) for t in base["tokens"]] or (
                d["finish"] != base["finish"]):
            fail(f"chunked {label}: the burst's token counts or finishes differ across runs")

    def med(key, chunk, megastep=True):
        return statistics.median(h[key] for h in hol
                                 if h["chunk"] == chunk and h["megastep"] == megastep)

    out["hol"] = {"runs": [{k: v for k, v in h.items() if k != "long_stream"} for h in hol],
                  "medians": {
        str(c): {k: med(k, c) for k in ("max_gap_s", "long_ttft_ms", "hol_wait_s",
                                         "prefill_chunks", "budget_utilization")}
        for c in (0, CHUNK_SIZE)}}
    if split:
        out["hol"]["medians"]["split"] = {
            k: med(k, CHUNK_SIZE, False) for k in ("max_gap_s", "long_ttft_ms", "hol_wait_s",
                                                   "prefill_chunks", "long_cycles")}
    out["hol"]["long_streams_identical"] = same_streams
    out["deadline"] = [{k: v for k, v in h.items() if k != "long_stream"}
                       for h in deadline_runs]
    on_runs, off_runs = dedup[0::2], dedup[1::2]
    same = sum(a == b for r_on, r_off in zip(on_runs, off_runs)
               for a, b in zip(r_on["tokens"], r_off["tokens"]))
    ttft = {m: [v for d in runs for v in d["ttft_ms"]]
            for m, runs in (("on", on_runs), ("off", off_runs))}
    out["dedup"] = {"runs": [{k: v for k, v in d.items() if k != "tokens"} for d in dedup],
                    "ttft_ms": {m: _ms_stats(v) for m, v in ttft.items()},
                    "peak_pages": {"on": [d["peak_pages"] for d in on_runs],
                                   "off": [d["peak_pages"] for d in off_runs]},
                    "identical_streams": same,
                    "streams": DEDUP_REQUESTS * dedup_repeats}
    out["launches"] = walk
    out["decode_steps"] = walk // cfg.n_layers
    m = out["hol"]["medians"]
    for h in hol + deadline_runs:
        say(f"chunked {label} run: {_run_line(h)}  [{card}]")
    if split:
        sm, fm = m["split"], m[str(CHUNK_SIZE)]
        say(f"chunked {label} (b'), chunk {CHUNK_SIZE}, megastep on vs off: longest gap "
            f"{fm['max_gap_s'] * 1e3:.1f} / {sm['max_gap_s'] * 1e3:.1f} ms, long TTFT "
            f"{fm['long_ttft_ms']:.1f} / {sm['long_ttft_ms']:.1f} ms, "
            f"{statistics.median(h['long_cycles'] for h in fused)} / {sm['long_cycles']} prefill "
            f"cycles (medians of {repeats}); the long request's streams "
            f"{'identical' if same_streams else 'NOT identical'} across the fused and split "
            f"runs (reported, not gated, in bf16)  [{card}]")
    for h in deadline_runs:
        say(f"chunked {label} (d), planner {'on' if h is deadline_runs[0] else 'off'}: deadline "
            f"{h['timeout_s'] * 1e3:.1f} ms ({DEADLINE_SHARE} x the chunked TTFT), quotas "
            f"{h['quotas']}, chunks {h['chunk_sizes']}, {h['long_cycles']} prefill cycles; "
            f"{h['outcome']}, TTFT "
            f"{'%.1f ms' % h['long_ttft_ms'] if h['long_ttft_ms'] is not None else 'none'}"
            f"  [{card}]")
    for c in (0, CHUNK_SIZE):
        say(f"chunked {label} HOL, chunk {c or 'off'}: {HOL_DECODERS} decoders x "
            f"{HOL_DECODE_TOKENS} tokens, a {CHUNK_ROW}-token request lands mid-decode: "
            f"decoders' longest gap {m[str(c)]['max_gap_s'] * 1e3:.1f} ms, the long "
            f"request's TTFT {m[str(c)]['long_ttft_ms']:.1f} ms, hol wait "
            f"{m[str(c)]['hol_wait_s']:.3f} s, {m[str(c)]['prefill_chunks']} chunks, budget "
            f"utilization {m[str(c)]['budget_utilization']:.3f} (medians of {repeats})  "
            f"[{card}]")
    say(f"chunked {label} dedup: {DEDUP_REQUESTS} requests of {DEDUP_PREFIX} shared + "
        f"{DEDUP_TAIL} own tokens, {DEDUP_TOKENS} tokens each: shares "
        f"{[d['shares'] for d in dedup]}, page peaks on {out['dedup']['peak_pages']['on']} vs "
        f"off {out['dedup']['peak_pages']['off']} (want about {DEDUP_PEAKS[True]} and "
        f"{DEDUP_PEAKS[False]}); TTFT on {_fmt(out['dedup']['ttft_ms']['on'])}, off "
        f"{_fmt(out['dedup']['ttft_ms']['off'])}; {same} of {DEDUP_REQUESTS * dedup_repeats} "
        f"streams identical on vs off; walk launches {walk} = {cfg.n_layers} x "
        f"{walk // cfg.n_layers} decode steps  [{card}]")
    out["phase_s"] = time.monotonic() - t_phase
    say(f"chunked {label}: phase {out['phase_s']:.1f} s  [{card}]")
    return out


# -- speculative decoding phase ------------------------------------------

SPEC_LEN = 6
SPEC_REQUESTS = 8
SPEC_TOKENS = 64
SPEC_REPEATS = 1  # runs of each mode, in turns (one: the script's wall)
SPEC_INT8_REQUESTS = 4
SPEC_INT8_TOKENS = 32
SPEC_PREFIX = 500  # rows below the verified ones: 500 % 16 = 4, mid-page
SPEC_TOL = 2e-2  # each verified position's logits, relative L2 from an f32 pass


def _spec_prompts(n: int) -> list[str]:
    """Self-repeating tool-call prompts: each restates its own call six
    times, as an agent loop restates its tool calls."""
    return [f'{{"name": "search_docs", "arguments": {{"query": "incident {i}", '
            f'"limit": {i + 3}}}}} ' * 6 for i in range(n)]


def verify_check(engine, card: str, label: str) -> dict:
    """One verify pass at full width on a scratch pool: a SPEC_PREFIX-token
    row prefilled, then lane 0 scores SPEC_LEN + 1 tokens from row
    SPEC_PREFIX (mid-page), beside an idle lane (``n_input = 0``, start
    ``max_ctx``) whose table is the same pages. Each position's logits
    against an f32 pass over the same rows (gated at SPEC_TOL), with the
    whole-row bf16 forward's distance from that pass beside it; the pass
    writes only its own rows."""
    import torch

    from agentcontrolplane_tpu_torch.models import llama

    cfg, P, dev = engine.config, engine.page_size, "cuda"
    T = SPEC_LEN + 1
    n_pages = -(-(SPEC_PREFIX + T) // P)
    row = torch.randint(0, 256, (1, n_pages * P), generator=torch.Generator().manual_seed(17))
    row = row.to(dev)
    with torch.inference_mode():
        pages = llama.init_paged_cache(cfg, 1 + n_pages, P, device=dev,
                                       quantize_kv=engine.quantize_kv)
        ids = torch.arange(1, 1 + n_pages, device=dev)
        pages, _ = llama.prefill_paged_batch(
            engine.params, pages, row, torch.tensor([SPEC_PREFIX], device=dev), ids[None], cfg)
        table = torch.zeros(2, engine.max_pages_per_seq, dtype=torch.int32, device=dev)
        table[:, :n_pages] = ids
        toks = torch.zeros(2, T, dtype=torch.long, device=dev)
        toks[0] = row[0, SPEC_PREFIX: SPEC_PREFIX + T]
        before = {n: t[:, 1:].clone() for n, t in pages.items()}
        torch.cuda.synchronize()
        t0 = time.monotonic()
        pages, logits = llama.verify_paged_continue(
            engine.params, pages, toks, torch.tensor([T, 0], device=dev),
            torch.tensor([SPEC_PREFIX, engine.max_ctx], device=dev), table, cfg)
        torch.cuda.synchronize()
        verify_ms = (time.monotonic() - t0) * 1e3
        bf16 = llama.forward(engine.params, row[:, : SPEC_PREFIX + T], cfg)[0, -T:]
        kept = True
        for n, t in pages.items():
            rows = t[:, 1:].reshape(t.shape[0], -1, *t.shape[3:])
            was = before[n].reshape(rows.shape)
            rows[:, SPEC_PREFIX: SPEC_PREFIX + T] = was[:, SPEC_PREFIX: SPEC_PREFIX + T]
            kept = kept and bool(torch.equal(rows, was))
    f32 = _f32_logits(engine, row[:, : SPEC_PREFIX + T], last=T)[0]
    doc = {"verify_vs_f32": [_rel_l2(logits[0, i], f32[i]) for i in range(T)],
           "bf16_whole_vs_f32": [_rel_l2(bf16[i], f32[i]) for i in range(T)],
           "verify_ms": verify_ms, "other_rows_kept": kept}
    worst = max(doc["verify_vs_f32"])
    if not torch.isfinite(logits[0]).all() or worst > SPEC_TOL or not kept:
        fail(f"spec {label}: verify logits {worst:.3e} relative L2 from an f32 pass (tol "
             f"{SPEC_TOL}), finite {bool(torch.isfinite(logits[0]).all())}, other rows kept "
             f"{kept}")
    say(f"spec {label}: one verify pass of {T} tokens from row {SPEC_PREFIX} (mid-page) beside "
        f"an idle lane: per-position logits from an f32 pass max {worst:.3e} relative L2 (tol "
        f"{SPEC_TOL}); the whole-row bf16 forward's max {max(doc['bf16_whole_vs_f32']):.3e}; "
        f"every other pool row unchanged; {verify_ms:.1f} ms (first call)  [{card}]")
    return doc


def spec_run(engine, prompts: list, max_tokens: int) -> dict:
    """One admission group of greedy requests; each one's streamed tokens
    must be its result's, exactly once. Verify passes are timed by wrapping
    the engine's ``_decode_spec`` (drafting, growth, the pass, its host
    read and commit) for the run."""
    from agentcontrolplane_tpu_torch.engine.engine import SamplingParams

    streams: list = [[] for _ in prompts]
    verify_ms: list = []
    real = engine._decode_spec

    def timed(pending=None):
        v0, t0 = engine.spec_dispatches, time.monotonic()
        out = real(pending)
        if engine.spec_dispatches > v0:
            verify_ms.append((time.monotonic() - t0) * 1e3)
        return out

    c0 = (engine.decode_steps, engine.spec_dispatches, engine.spec_proposed,
          engine.spec_accepted, engine.tokens_generated)
    engine._decode_spec = timed
    try:
        t0 = time.monotonic()
        with engine.hold_admission():
            futs = [engine.submit(p, SamplingParams(max_tokens=max_tokens),
                                  on_tokens=streams[i].extend) for i, p in enumerate(prompts)]
        res = [f.result(timeout=600) for f in futs]
        wall_s = time.monotonic() - t0
    finally:
        del engine._decode_spec
    _idle_parked(engine)
    for i, r in enumerate(res):
        if r.finish_reason not in ("stop", "length") or streams[i] != list(r.tokens):
            fail(f"spec: request {i} finished {r.finish_reason!r}, streamed {len(streams[i])} "
                 f"tokens for {len(r.tokens)}")
    steps, verify, proposed, accepted, generated = (
        b - a for a, b in zip(c0, (engine.decode_steps, engine.spec_dispatches,
                                   engine.spec_proposed, engine.spec_accepted,
                                   engine.tokens_generated)))
    n_tokens = sum(len(r.tokens) for r in res)
    return {"tokens": [list(r.tokens) for r in res], "wall_s": wall_s,
            "tokens_per_s": n_tokens / wall_s, "decode_steps": steps, "verify_passes": verify,
            "proposed": proposed, "accepted": accepted,
            "tokens_per_decode_step": generated / steps if steps else 0.0,
            "verify_ms": verify_ms}


def spec_phase(engine, card: str, label: str) -> dict:
    """Speculative decoding on the serving engine, spec_len set while it
    idles (as the reference's autopilot sets it) and put back to 0 after.
    bf16: the verify check, then SPEC_REQUESTS self-repeating tool-call
    requests of SPEC_TOKENS tokens, spec on and off in turns, SPEC_REPEATS
    runs each; int8: SPEC_INT8_REQUESTS requests, spec on, twice, which
    must give the same tokens. Every run cold (the prefix cache emptied);
    every decode step that is not a verify pass goes through the expected
    walk, and the pool is whole after."""
    import statistics

    from agentcontrolplane_tpu_torch.ops.cuda import paged_attention as pa

    t_phase = time.monotonic()
    cfg, int8_walk = engine.config, engine.quantize_kv
    _idle_parked(engine)
    out = {"card": card}
    if not int8_walk:
        out["check"] = verify_check(engine, card, label)
    n, max_tokens = ((SPEC_INT8_REQUESTS, SPEC_INT8_TOKENS) if int8_walk
                     else (SPEC_REQUESTS, SPEC_TOKENS))
    prompts = _spec_prompts(n)
    order = [["on", "on"]] if int8_walk else [
        ["off", "on"] if r % 2 == 0 else ["on", "off"] for r in range(SPEC_REPEATS)]
    runs: dict = {"on": [], "off": []}
    pa.LAUNCHES = pa.INT8_LAUNCHES = 0
    steps0, verify0 = engine.decode_steps, engine.spec_dispatches
    try:
        for modes in order:
            for mode in modes:
                _forget_prefixes(engine)
                engine.spec_len = SPEC_LEN if mode == "on" else 0
                runs[mode].append(spec_run(engine, prompts, max_tokens))
    finally:
        engine.spec_len = 0
    steps = engine.decode_steps - steps0
    verify = engine.spec_dispatches - verify0
    walk = _walk_check(f"spec {label}", steps - verify, cfg.n_layers, int8_walk)
    if verify <= 0:
        fail(f"spec {label}: no verify pass ran")
    if not _pool_whole(engine):
        fail(f"spec {label}: pages or slots not released: {engine.stats()}")
    on = runs["on"]
    verify_ms = [t for r in on for t in r["verify_ms"]]
    out.update({
        "runs": runs, "decode_steps": steps, "verify_passes": verify, "launches": walk,
        "acceptance_rate": sum(r["accepted"] for r in on) / max(1, sum(r["proposed"] for r in on)),
        "tokens_per_decode_step_on": statistics.median(r["tokens_per_decode_step"] for r in on),
        "verify_ms_median": statistics.median(verify_ms) if verify_ms else None,
        "tokens_per_s_on": statistics.median(r["tokens_per_s"] for r in on),
    })
    if int8_walk:
        if on[0]["tokens"] != on[1]["tokens"]:
            fail(f"spec {label}: the same greedy group gave different tokens on a second run")
        say(f"spec {label}: {n} requests x {max_tokens} tokens, spec_len {SPEC_LEN}, twice: "
            f"identical tokens; {verify} verify passes, acceptance {out['acceptance_rate']:.3f}, "
            f"{out['tokens_per_decode_step_on']:.3f} tokens per decode step, verify pass "
            f"{out['verify_ms_median']:.1f} ms (median); int8-walk launches {walk} = "
            f"{cfg.n_layers} x ({steps} decode steps - {verify} verify passes)  [{card}]")
    else:
        off = runs["off"]
        same = sum(a == b for r_on, r_off in zip(on, off)
                   for a, b in zip(r_on["tokens"], r_off["tokens"]))
        out.update({
            "identical_on_off": same,
            "tokens_per_decode_step_off": statistics.median(
                r["tokens_per_decode_step"] for r in off),
            "tokens_per_s_off": statistics.median(r["tokens_per_s"] for r in off),
        })
        say(f"spec {label}: {n} self-repeating tool-call requests x {max_tokens} tokens, "
            f"spec_len {SPEC_LEN} on vs off, {SPEC_REPEATS} runs each in turns: {same} of "
            f"{n * SPEC_REPEATS} streams identical on vs off; {verify} verify passes, "
            f"acceptance {out['acceptance_rate']:.3f}, tokens per decode step "
            f"{out['tokens_per_decode_step_on']:.3f} on / "
            f"{out['tokens_per_decode_step_off']:.3f} off, verify pass "
            f"{out['verify_ms_median']:.1f} ms (median of {len(verify_ms)}), "
            f"{out['tokens_per_s_on']:.1f} / {out['tokens_per_s_off']:.1f} tokens/s on / off "
            f"(medians, TTFT included); walk launches {walk} = {cfg.n_layers} x ({steps} decode "
            f"steps - {verify} verify passes)  [{card}]")
    out["phase_s"] = time.monotonic() - t_phase
    say(f"spec {label}: phase {out['phase_s']:.1f} s  [{card}]")
    return out


# -- parallel serving phases ---------------------------------------------

FIRST_PROMPT = [300 + 7 * i for i in range(20)]
# tp / sp ranks against one card: the reduction order differs from a single
# card's (partial products rounded to bf16, then summed in f32), so logits
# agree to a few bf16 roundings per layer, not bit for bit
MAX_LOGIT_REL_L2 = 5e-2


# -- control-plane phase -------------------------------------------------

# the applied manifests (JSON; camelCase as a user writes them)
CONTROL_PLANE_MANIFEST = json.dumps([
    {"kind": "LLM", "metadata": {"name": "l8b"}, "spec": {
        "provider": "tpu", "parameters": {"model": "llama3-8b", "maxTokens": 16},
        "tpu": {"preset": "llama3-8b", "tensorParallelism": 1}}},
    {"kind": "LLM", "metadata": {"name": "needs-tp2"}, "spec": {
        "provider": "tpu", "tpu": {"preset": "llama3-8b", "tensorParallelism": 2}}},
    {"kind": "LLM", "metadata": {"name": "needs-int8"}, "spec": {
        "provider": "tpu", "tpu": {"preset": "llama3-8b", "quantizeWeights": True}}},
    {"kind": "Agent", "metadata": {"name": "a1"}, "spec": {
        "llmRef": {"name": "l8b"}, "system": "You are a helpful agent."}},
    {"kind": "Agent", "metadata": {"name": "a2"}, "spec": {
        "llmRef": {"name": "needs-tp2"}, "system": "You are a helpful agent."}},
])
AGENT_REQUEUE_S = 0.5  # the Agent controller's wait for a pending LLM (default 5 s)


class RecordingEngine:
    """The engine as the control plane sees it, recording each request's
    future (the probes' TTFT and count); everything else passes through."""

    def __init__(self, engine):
        self._engine = engine
        self.futures: list = []

    def submit(self, *args, **kw):
        fut = self._engine.submit(*args, **kw)
        self.futures.append(fut)
        return fut

    def __getattr__(self, name):
        return getattr(self._engine, name)


def control_plane_phase(engine, card: str, label: str) -> dict:
    """The control plane over the running llama3-8b ``engine``: JSON
    manifests applied to a sqlite store, a Manager under a LeaderElector
    (lease 2 s) driving the LLM controller (1-token probe) and the Agent
    controller through the elector's fenced store, every expected status
    checked, the store reopened from its file, then one chat through the
    factory-made client, which must run the walk."""
    import asyncio
    import tempfile

    from agentcontrolplane_tpu_torch.api.manifests import apply_resources, load_manifests
    from agentcontrolplane_tpu_torch.controllers import AgentReconciler, LLMReconciler
    from agentcontrolplane_tpu_torch.engine.types import Message
    from agentcontrolplane_tpu_torch.kernel import (
        Conflict, FencedStore, LeaderElector, Manager, SqliteBackend, Store,
    )
    from agentcontrolplane_tpu_torch.llmclient.factory import DefaultLLMClientFactory
    from agentcontrolplane_tpu_torch.ops.cuda import paged_attention as pa

    int8 = engine.quantize == "int8"
    expected = {
        ("LLM", "l8b"): ("Ready", "Provider validated"),
        ("LLM", "needs-tp2"): (
            "Error", "engine mesh tp=1 != spec tensorParallelism=2 (set acp-tpu run --tpu-tp)"),
        ("LLM", "needs-int8"): ("Ready", "Provider validated") if int8 else (
            "Error", "engine serves bf16 weights but spec requests quantizeWeights "
                     "(set acp-tpu run --tpu-quantize-weights)"),
        ("Agent", "a1"): ("Ready", "All dependencies validated"),
        ("Agent", "a2"): ("Pending", 'LLM "needs-tp2" not ready'),
    }

    class CountingFencedStore(FencedStore):
        """The reconcilers' store: every mutation carries the elector's
        fence; status writes are counted."""

        status_writes = 0

        def update_status(self, obj):
            out = super().update_status(obj)
            self.status_writes += 1
            return out

    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    t_phase = time.monotonic()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        path = str(Path(tmp) / "control-plane.db")
        recording = RecordingEngine(engine)
        prefills0 = engine.stats()["requests_prefilled"]

        async def run() -> dict:
            store = Store(SqliteBackend(path))
            mgr = Manager(store, identity=f"chip-smoke-{label}", leader_election=True)
            mgr.elector = LeaderElector(store, mgr.identity, ttl=2.0, renew_interval=0.5)
            fenced = CountingFencedStore(store, mgr.elector.fence)
            mgr.add_controller("llm", "LLM", LLMReconciler(
                fenced, mgr.recorder, DefaultLLMClientFactory(recording), probe=True))
            mgr.add_controller("agent", "Agent", AgentReconciler(
                fenced, mgr.recorder, requeue_delay=AGENT_REQUEUE_S))
            watch = store.watch(["LLM", "Agent"])
            await mgr.start()
            await mgr.run_until(lambda: mgr.elector.is_leader, timeout=10)
            t_apply = time.monotonic()
            applied = apply_resources(store, load_manifests(CONTROL_PLANE_MANIFEST))
            if [a for a, _ in applied] != ["created"] * 5:
                fail(f"control plane {label}: apply gave {[a for a, _ in applied]}")
            settled_at: dict = {}

            def settled() -> bool:
                for key, want in expected.items():
                    st = store.get(*key).status
                    if (st.status, st.status_detail) == want:
                        settled_at.setdefault(key, time.monotonic() - t_apply)
                    else:
                        settled_at.pop(key, None)
                return len(settled_at) == len(expected)

            try:
                await mgr.run_until(settled, timeout=120)
            except TimeoutError:
                got = {k: (store.get(*k).status.status, store.get(*k).status.status_detail)
                       for k in expected}
                fail(f"control plane {label}: statuses did not settle: {got}")
            # quiet: no probe in flight (a Ready LLM's reconcile after its own
            # status write probes once more), none started for 0.2 s
            n_requests = -1
            while n_requests != len(recording.futures):
                n_requests = len(recording.futures)
                await mgr.run_until(lambda: all(f.done() for f in recording.futures), timeout=60)
                await asyncio.sleep(0.2)
            # a fence of a later epoch than the elector's is refused
            stale = {**mgr.elector.fence(), "epoch": mgr.elector.epoch + 1}
            try:
                store.update_status(store.get("LLM", "l8b"), fence=stale)
                fail(f"control plane {label}: a write under a stale fence landed")
            except Conflict:
                pass
            before = {k: (store.get(*k).status.model_dump(),
                          store.get(*k).metadata.resource_version) for k in expected}
            epoch = mgr.elector.epoch
            await mgr.stop()
            modified = []
            while (ev := await watch.next(timeout=0.01)) is not None:
                if ev.type == "MODIFIED":
                    modified.append(ev.object.key)
            watch.stop()
            if fenced.status_writes != len(modified) or fenced.status_writes < len(expected):
                fail(f"control plane {label}: {len(modified)} status writes landed, "
                     f"{fenced.status_writes} under the elector's fence")
            store.close()

            t_reopen = time.monotonic()
            reopened = Store(SqliteBackend(path))
            after = {k: (reopened.get(*k).status.model_dump(),
                         reopened.get(*k).metadata.resource_version) for k in expected}
            reopen_ms = (time.monotonic() - t_reopen) * 1e3
            if after != before:
                fail(f"control plane {label}: statuses or resource versions changed across "
                     f"the reopen: {before} -> {after}")
            l8b = reopened.get("LLM", "l8b")
            reopened.close()

            # one chat through the factory-made client: decode through the walk
            client = await DefaultLLMClientFactory(recording).create_client(l8b, "")
            steps0 = engine.decode_steps
            pa.LAUNCHES = 0
            pa.INT8_LAUNCHES = 0
            reply = await client.send_request(
                [Message(role="system", content="You are a helpful agent."),
                 Message(role="user", content="Plan the next step of the incident review.")],
                [])
            launches, int8_launches = pa.LAUNCHES, pa.INT8_LAUNCHES
            steps = engine.decode_steps - steps0
            return {"settled_ms": {f"{k[0]}/{k[1]}": v * 1e3 for k, v in settled_at.items()},
                    "status_writes": fenced.status_writes, "epoch": epoch,
                    "reopen_ms": reopen_ms, "reply": reply, "chat_steps": steps,
                    "launches": launches, "int8_launches": int8_launches}

        out = asyncio.run(run())
    probes = recording.futures[:-1]  # the last request is the chat
    probe_ttft = [f.result().ttft_ms for f in probes]
    prefilled = engine.stats()["requests_prefilled"] - prefills0
    n_ready_llms = sum(1 for k, (st, _) in expected.items() if k[0] == "LLM" and st == "Ready")
    if len(probes) < n_ready_llms or prefilled != len(recording.futures):
        fail(f"control plane {label}: {len(probes)} probes for {n_ready_llms} Ready LLMs, "
             f"engine counted {prefilled} prefills for {len(recording.futures)} requests")
    reply, steps = out.pop("reply"), out["chat_steps"]
    walk = out["int8_launches"] if engine.quantize_kv else out["launches"] - out["int8_launches"]
    other = out["launches"] - walk
    if reply.role != "assistant" or steps == 0:
        fail(f"control plane {label}: chat gave {reply!r} over {steps} decode steps")
    if walk != engine.config.n_layers * steps or other:
        fail(f"control plane {label}: {walk} walk launches (other walk {other}) for {steps} "
             f"decode steps x {engine.config.n_layers} layers")
    phase_s = time.monotonic() - t_phase
    ms = out["settled_ms"]
    say(f"control plane {label}: apply -> LLM l8b Ready {ms['LLM/l8b']:.1f} ms, -> Agent a1 "
        f"Ready {ms['Agent/a1']:.1f} ms (Agent requeue {AGENT_REQUEUE_S} s); probe TTFT "
        f"{probe_ttft[0]:.1f} ms ({len(probes)} probes); reopen {out['reopen_ms']:.2f} ms; "
        f"{out['status_writes']} fenced status writes (epoch {out['epoch']}); chat "
        f"{steps} decode steps, {walk} walk launches; phase {phase_s:.1f} s  [{card}]")
    return {**out, "card": card, "probe_ttft_ms": probe_ttft, "probes": len(probes),
            "requests_prefilled": prefilled, "walk_launches": walk,
            "agent_requeue_s": AGENT_REQUEUE_S, "phase_s": phase_s}


# -- operator phase -------------------------------------------------------

ECHO_SERVER = ROOT / "tests" / "mcp" / "echo_server.py"  # stdlib-only MCP stdio server


def _llm_doc(name: str, tool_choice: str = "") -> dict:
    spec = {"provider": "tpu", "parameters": {"model": "llama3-8b", "maxTokens": 32,
                                              "temperature": 0},
            "tpu": {"preset": "llama3-8b", "requestTimeoutSeconds": 120}}
    if tool_choice:
        spec["providerConfig"] = {"tool_choice": tool_choice}
    return {"kind": "LLM", "metadata": {"name": name}, "spec": spec}


def _agent_doc(name: str, llm: str, system: str, **deps) -> dict:
    return {"kind": "Agent", "metadata": {"name": name},
            "spec": {"llmRef": {"name": llm}, "system": system, **deps}}


# the operator phase's manifests: forced tool calls as the reference's
# provider: tpu end-to-end tests force them (required / a named tool)
OPERATOR_MANIFEST = json.dumps([
    {"kind": "Secret", "metadata": {"name": "hl-key"}, "spec": {"data": {"api-key": "local"}}},
    {"kind": "ContactChannel", "metadata": {"name": "oncall"}, "spec": {
        "type": "email", "apiKeyFrom": {"name": "hl-key", "key": "api-key"},
        "email": {"address": "oncall@example.com", "contextAboutUser": "the on-call engineer"}}},
    {"kind": "MCPServer", "metadata": {"name": "echo"}, "spec": {
        "transport": "stdio", "command": sys.executable, "args": [str(ECHO_SERVER)],
        "resources": {"limits": {"memory": "1Gi"}}}},
    _llm_doc("l8b-delegate", "required"),
    _llm_doc("l8b-ask", "oncall__human_contact_email"),
    _llm_doc("l8b-echo", "echo__echo"),
    _llm_doc("l8b-free"),
    _agent_doc("leaf", "l8b-free", "Answer in one line.",
               description="answers one question in one line"),
    _agent_doc("delegator", "l8b-delegate", "Delegate the question.",
               subAgents=[{"name": "leaf"}]),
    _agent_doc("asker", "l8b-ask", "Ask the on-call engineer first.",
               humanContactChannels=[{"name": "oncall"}]),
    _agent_doc("echoer", "l8b-echo", "Use the echo tool.", mcpServers=[{"name": "echo"}]),
    _agent_doc("plain", "l8b-free", "You are a helpful agent."),
])
OPERATOR_KINDS = {"delegate": "delegator", "echo": "echoer", "human": "asker", "plain": "plain"}
HUMAN_ANSWER = "approved, proceed"
TOOLCALL_POLL_S = 0.1  # the ToolCall controller's poll of a human / a child (default 5 s)


def _ms_stats(values: list) -> dict:
    vals = sorted(values)
    return {"p50": statistics.median(vals), "max": vals[-1], "n": len(vals),
            "values": vals} if vals else {}


def operator_phase(engine, card: str, label: str) -> dict:
    """The port's ``Operator`` over the running llama3-8b ``engine``: JSON
    manifests (forced ``provider: tpu`` LLMs, an MCP stdio server, a
    ContactChannel on the local human backend, Agents using each) applied
    to its sqlite store, then 8 Tasks at once (2 delegating, 2 MCP echo, 2
    asking a human, 2 without tools) and one delegation ToolCall applied
    directly (the forced arguments of a random-weight model carry no
    ``message`` for a child Task) to a Task whose window already holds the
    assistant's call, so that the child's output joins that window. Every
    Task's first turn must create its
    first ToolCall CR (or reach FinalAnswer without tools), every ToolCall
    must reach its terminal state with its result joined to the parent's
    context window, and the decode steps must go through the engine's walk.
    Then the phase stops new turns by holding every Task's ``task-llm``
    lease, waits until the engine has no request in flight, and stops the
    operator."""
    import asyncio
    import tempfile

    from agentcontrolplane_tpu_torch.api.manifests import apply_resources, load_manifests
    from agentcontrolplane_tpu_torch.api.resources import Task, ToolCall
    from agentcontrolplane_tpu_torch.engine.engine import SamplingParams
    from agentcontrolplane_tpu_torch.kernel import lease
    from agentcontrolplane_tpu_torch.operator import Operator, OperatorOptions
    from agentcontrolplane_tpu_torch.ops.cuda import paged_attention as pa

    if not Path("/bin/sh").exists():
        fail("operator: /bin/sh is missing (the MCP memory limit runs through it)")
    int8_walk = engine.quantize_kv
    max_bucket = engine.prefill_buckets[-1]
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    t_phase = time.monotonic()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        recording = RecordingEngine(engine)
        prompts: list = []  # (prompt tokens, prompt text, wall time) of each request
        submit = recording.submit

        def submit_recording(prompt, *a, **kw):
            prompts.append((len(engine.tokenizer.encode(prompt)), prompt, time.time()))
            return submit(prompt, *a, **kw)

        recording.submit = submit_recording

        async def run() -> dict:
            # the REST server serves the engine's observability routes,
            # read once the Tasks have run (_operator_rest_checks)
            op = Operator(OperatorOptions(db_path=str(Path(tmp) / "operator.db"), llm_probe=True,
                                          engine=recording, identity=f"chip-smoke-op-{label}",
                                          enable_rest=True, api_host="127.0.0.1", api_port=0))
            op.agent_reconciler.requeue_delay = AGENT_REQUEUE_S
            op.toolcall_reconciler.poll_interval = TOOLCALL_POLL_S
            store = op.store
            await op.start()
            try:
                return await asyncio.wait_for(drive(op, store), 600)
            finally:
                await op.stop()

        async def drive(op, store) -> dict:
            t_apply = time.monotonic()
            applied = apply_resources(store, load_manifests(OPERATOR_MANIFEST))
            if any(a != "created" for a, _ in applied):
                fail(f"operator {label}: apply gave {[a for a, _ in applied]}")
            agents = [d["metadata"]["name"] for d in json.loads(OPERATOR_MANIFEST)
                      if d["kind"] == "Agent"]
            try:
                await op.manager.run_until(
                    lambda: all(store.get("Agent", a).status.ready for a in agents), timeout=180)
            except TimeoutError:
                fail(f"operator {label}: Agents not Ready: " + str(
                    {a: store.get("Agent", a).status.status_detail for a in agents}))
            ready_ms = (time.monotonic() - t_apply) * 1e3
            # quiet: the LLM probes are done (none in flight for 0.2 s)
            n_requests = -1
            while n_requests != len(recording.futures):
                n_requests = len(recording.futures)
                await op.manager.run_until(lambda: all(f.done() for f in recording.futures),
                                           timeout=120)
                await asyncio.sleep(0.2)
            probes = len(recording.futures)
            # the JSON table is built at an engine's first constrained
            # request (no prewarm yet, ROADMAP A.3): build it before the
            # counted run, so no Task's first turn waits for it
            t0 = time.monotonic()
            await asyncio.to_thread(lambda: engine.submit(
                "warm-up", SamplingParams(max_tokens=1, json_only=True)).result(timeout=120))
            table_s = time.monotonic() - t0
            n_prompts = len(prompts)

            created: dict = {}  # task -> create time
            seen: dict = {}  # (what, name) -> first time
            watch = store.watch(["Task", "ToolCall"])
            names = {f"t-{kind}-{i}": agent for kind, agent in OPERATOR_KINDS.items()
                     for i in range(2)}
            # the counted run: counts to 0 just before the Tasks are created
            pa.LAUNCHES = 0
            pa.INT8_LAUNCHES = 0
            steps0 = engine.decode_steps
            for name, agent in names.items():
                store.create(Task.model_validate({"metadata": {"name": name}, "spec": {
                    "agentRef": {"name": agent}, "userMessage": f"{name}: check the deploy."}}))
                created[name] = time.monotonic()
            # a parent whose last turn already asked for the delegation: the
            # Task is created in ToolCallsPending with the assistant's call,
            # and the ToolCall carries that turn's request id
            direct_args = json.dumps({"message": "Summarize the deploy in one line."})
            parent = store.create(Task.model_validate({
                "metadata": {"name": "t-delegate-join"},
                "spec": {"agentRef": {"name": "delegator"},
                         "userMessage": "t-delegate-join: summarize the deploy."},
                "status": {"phase": "ToolCallsPending", "status": "Ready",
                           "toolCallRequestId": "direct0", "messageCount": 3,
                           "contextWindow": [
                               {"role": "system", "content": "Delegate the question."},
                               {"role": "user", "content": "t-delegate-join: summarize the deploy."},
                               {"role": "assistant", "toolCalls": [{
                                   "id": "call_direct", "function": {
                                       "name": "delegate_to_agent__leaf",
                                       "arguments": direct_args}}]}]}}))
            direct = store.create(ToolCall.model_validate({
                "metadata": {"name": "direct-delegate",
                             "labels": {"acp.tpu/task": parent.name,
                                        "acp.tpu/toolcallrequest": "direct0"},
                             "ownerReferences": [parent.owner_ref().model_dump()]},
                "spec": {"toolCallId": "call_direct", "taskRef": {"name": parent.name},
                         "toolRef": {"name": "delegate_to_agent__leaf"},
                         "toolType": "DelegateToAgent", "arguments": direct_args}}))
            created[direct.name] = time.monotonic()

            def note(what: str, name: str) -> None:
                seen.setdefault((what, name), time.monotonic())

            def first_calls() -> dict:
                out = {}
                for tc in store.list("ToolCall"):
                    task = tc.spec.task_ref.name
                    if tc.name != direct.name and (
                            task not in out or tc.metadata.creation_timestamp <
                            out[task].metadata.creation_timestamp):
                        out[task] = tc
                return out

            def done() -> bool:
                firsts = first_calls()
                for name in names:
                    if name.startswith("t-plain"):
                        if ("final", name) not in seen:
                            return False
                    elif name not in firsts or ("joined", name) not in seen:
                        return False
                return ("terminal", direct.name) in seen and ("joined", parent.name) in seen

            async def observe() -> None:
                while not done():
                    ev = await watch.next(timeout=0.05)
                    if ev is None:
                        pass
                    elif ev.object.kind == "ToolCall":
                        tc = ev.object
                        note("toolcall", tc.name)
                        if ev.type == "ADDED":
                            seen.setdefault(("added_rv", tc.name), tc.metadata.resource_version)
                        if tc.status.phase == "AwaitingHumanInput":
                            note("awaiting", tc.name)
                        if tc.status.phase in ("Succeeded", "Failed", "ToolCallRejected"):
                            note("terminal", tc.name)
                    else:
                        t = ev.object
                        if t.status.phase == "ToolCallsPending":
                            # the store's order tells an early CR (created
                            # while the turn decoded) from one of the fan-out
                            seen.setdefault(("pending_rv", t.name, t.status.tool_call_request_id),
                                            t.metadata.resource_version)
                        if t.status.phase == "FinalAnswer":
                            note("final", t.name)
                        if any(m.role == "tool" for m in t.status.context_window):
                            note("joined", t.name)
                    for c in op.human_backend.pending_contacts():
                        op.human_backend.respond(c.call_id, HUMAN_ANSWER)
                        note("responded", c.run_id)

            try:
                await asyncio.wait_for(observe(), 300)
            except asyncio.TimeoutError:
                fail(f"operator {label}: checkpoints not reached in 300 s: "
                     f"{sorted(k for k in seen if k[0] in ('final', 'joined', 'terminal'))}")
            t_checkpoints = time.monotonic()
            # stop new turns: hold every unfinished Task's task-llm lease (as
            # another replica would), until no request is in flight
            while True:
                held = all(
                    t.status.phase in ("FinalAnswer", "Failed") or lease.try_acquire(
                        store, f"task-llm-{t.name}", "chip-smoke-drain", ttl=600)
                    for t in store.list("Task"))
                if held and all(f.done() for f in recording.futures):
                    await asyncio.sleep(0.2)
                    if all(f.done() for f in recording.futures):
                        break
                await asyncio.sleep(0.02)
            drain_s = time.monotonic() - t_checkpoints
            watch.stop()
            launches, int8_launches = pa.LAUNCHES, pa.INT8_LAUNCHES
            steps = engine.decode_steps - steps0

            firsts = first_calls()
            tasks = {t.name: t for t in store.list("Task")}
            kinds: dict = {}
            first_turn = {}  # task -> (submit wall time, its GenerationResult)
            for name in names:
                i = next(i for i in range(n_prompts, len(prompts))
                         if f"{name}: check" in prompts[i][1])
                first_turn[name] = (prompts[i][2], recording.futures[i].result())
            for kind in OPERATOR_KINDS:
                k = kinds.setdefault(kind, {"create_to_first_toolcall_ms": [], "how": [],
                                            "create_to_terminal_ms": [], "terminal": [],
                                            "create_to_joined_ms": [], "create_to_final_ms": [],
                                            "create_to_submit_ms": [], "ttft_ms": [],
                                            "first_token_to_toolcall_ms": [], "turn_tokens": []})
                for i in range(2):
                    name = f"t-{kind}-{i}"
                    t0 = created[name]
                    # the first turn: create -> submit (the controllers),
                    # submit -> first token (queue + prefill, engine clock)
                    t_submit, res = first_turn[name]
                    k["create_to_submit_ms"].append(
                        (t_submit - tasks[name].metadata.creation_timestamp) * 1e3)
                    k["ttft_ms"].append(res.ttft_ms)
                    k["turn_tokens"].append(len(res.tokens))
                    if kind == "plain":
                        if tasks[name].status.phase != "FinalAnswer":
                            fail(f"operator {label}: {name} is {tasks[name].status.phase}")
                        k["create_to_final_ms"].append((seen[("final", name)] - t0) * 1e3)
                        continue
                    tc = store.get("ToolCall", firsts[name].name)
                    want = {"delegate": "delegate_to_agent__leaf", "echo": "echo__echo",
                            "human": "oncall__human_contact_email"}[kind]
                    if tc.spec.tool_ref.name != want:
                        fail(f"operator {label}: {name}'s first ToolCall is "
                             f"{tc.spec.tool_ref.name}, not {want}")
                    json.loads(tc.spec.arguments)  # the grammar guarantees a JSON object
                    # store clock: the CR's creation against the Task's
                    k["create_to_first_toolcall_ms"].append(
                        (tc.metadata.creation_timestamp - tasks[name].metadata.creation_timestamp)
                        * 1e3)
                    k["first_token_to_toolcall_ms"].append(
                        (tc.metadata.creation_timestamp - t_submit) * 1e3 - res.ttft_ms)
                    pending_rv = seen.get(("pending_rv", name,
                                           tc.metadata.labels.get("acp.tpu/toolcallrequest")))
                    k["how"].append("early" if pending_rv is not None and
                                    seen[("added_rv", tc.name)] < pending_rv else "fan-out")
                    k["terminal"].append(tc.status.phase)
                    k["create_to_terminal_ms"].append((seen[("terminal", tc.name)] - t0) * 1e3)
                    k["create_to_joined_ms"].append((seen[("joined", name)] - t0) * 1e3)
                    if kind == "echo" and not (tc.status.phase == "Succeeded"
                                               and tc.status.result.startswith("echo: ")):
                        fail(f"operator {label}: {name}'s echo ToolCall {tc.status.phase} "
                             f"{tc.status.result!r}")
                    if kind == "human":
                        if tc.status.result != HUMAN_ANSWER or ("awaiting", tc.name) not in seen:
                            fail(f"operator {label}: {name}'s human ToolCall {tc.status.phase} "
                                 f"{tc.status.result!r}")
                        k.setdefault("create_to_awaiting_ms", []).append(
                            (seen[("awaiting", tc.name)] - t0) * 1e3)
                        k.setdefault("respond_to_joined_ms", []).append(
                            (seen[("joined", name)] - seen[("responded", tc.name)]) * 1e3)
                    if kind == "delegate" and tc.status.phase == "Failed" and \
                            tc.status.error != "delegate_to_agent requires a message argument":
                        fail(f"operator {label}: {name}'s delegation failed: {tc.status.error}")
                    window = tasks[name].status.context_window
                    joined = [m for m in window if m.role == "tool"
                              and m.tool_call_id == tc.spec.tool_call_id]
                    if not joined or joined[0].content != (tc.status.result or
                                                            f"error: {tc.status.error}"):
                        fail(f"operator {label}: {name}'s tool result did not join its window")
            direct = store.get("ToolCall", direct.name)
            children = [t for t in tasks.values()
                        if t.metadata.labels.get("acp.tpu/parent-toolcall") == direct.name]
            if direct.status.phase != "Succeeded" or len(children) != 1 or \
                    children[0].status.phase != "FinalAnswer" or \
                    direct.status.result != children[0].status.output:
                fail(f"operator {label}: the applied delegation is {direct.status.phase}, "
                     f"children {[(c.name, c.status.phase) for c in children]}")
            joined = [m for m in tasks[parent.name].status.context_window
                      if m.role == "tool" and m.tool_call_id == "call_direct"]
            if not joined or joined[0].content != children[0].status.output:
                fail(f"operator {label}: the child's output did not join {parent.name}'s window")
            kinds["delegate"]["applied_to_child_final_ms"] = (
                seen[("final", children[0].name)] - created[direct.name]) * 1e3
            kinds["delegate"]["applied_to_succeeded_ms"] = (
                seen[("terminal", direct.name)] - created[direct.name]) * 1e3
            kinds["delegate"]["applied_to_joined_ms"] = (
                seen[("joined", parent.name)] - created[direct.name]) * 1e3
            first_prompt = {}
            for name in names:
                lens = [n for n, text, _ in prompts[n_prompts:] if f"{name}: check" in text]
                first_prompt[name] = lens[0] if lens else None
                if lens and lens[0] > max_bucket:
                    fail(f"operator {label}: {name}'s prompt, {lens[0]} tokens, is past the "
                         f"largest prefill bucket ({max_bucket})")
            rest = await asyncio.to_thread(_operator_rest_checks, op, tasks, label)
            return {"agents_ready_ms": ready_ms, "probes": probes, "kinds": kinds,
                    "observability_rest": rest,
                    "table_warmup_s": table_s,
                    "first_prompt_tokens": first_prompt,
                    "max_prompt_tokens": max(n for n, _, _ in prompts[n_prompts:]),
                    "requests": len(prompts) - n_prompts, "tasks": len(tasks),
                    "toolcalls": len(store.list("ToolCall")), "decode_steps": steps,
                    "launches": launches, "int8_launches": int8_launches,
                    "drain_s": drain_s}

        overlap0 = engine.stats()["tool_overlap"]
        shares0 = engine.prefix_shares
        fused0, plans0 = engine.megastep_dispatches, engine.quota_projections
        shared_peak, sampling = [0], threading.Event()

        def sample_shared():  # pages with more than one owner, every 10 ms
            while not sampling.wait(0.01):
                shared_peak[0] = max(shared_peak[0], engine.stats()["memory"]["prefix_dedup"][
                    "shared_pages"])

        sampler = threading.Thread(target=sample_shared, daemon=True)
        sampler.start()
        try:
            out = asyncio.run(run())
        finally:
            sampling.set()
            sampler.join(timeout=5)
        overlap1 = engine.stats()["tool_overlap"]
        out["parks"] = overlap1["parks"] - overlap0["parks"]
        out["park_adoptions"] = overlap1["park_adoptions"] - overlap0["park_adoptions"]
        out["prefix_shares"] = engine.prefix_shares - shares0
        out["shared_pages_peak"] = shared_peak[0]
        out["megastep_dispatches"] = engine.megastep_dispatches - fused0
        out["quota_projections"] = engine.quota_projections - plans0
    steps, launches, int8_launches = out["decode_steps"], out["launches"], out["int8_launches"]
    walk = int8_launches if int8_walk else launches - int8_launches
    other = launches - walk
    if steps == 0 or walk != engine.config.n_layers * steps or other:
        fail(f"operator {label}: {walk} walk launches (other walk {other}) for {steps} decode "
             f"steps x {engine.config.n_layers} layers")
    phase_s = time.monotonic() - t_phase
    kinds = out["kinds"]
    say(f"operator {label}: Agents Ready {out['agents_ready_ms']:.1f} ms after apply "
        f"({out['probes']} probes); JSON table warm-up {out['table_warmup_s']:.2f} s; first-turn prompts {out['first_prompt_tokens']} tokens "
        f"(largest bucket {max_bucket}); {out['requests']} engine requests, {out['tasks']} "
        f"Tasks, {out['toolcalls']} ToolCalls  [{card}]")
    for kind, k in kinds.items():
        say(f"operator {label} {kind}, first turn: create -> submit "
            f"{_fmt(_ms_stats(k['create_to_submit_ms']))}; TTFT (queue + prefill) "
            f"{_fmt(_ms_stats(k['ttft_ms']))}; tokens {k['turn_tokens']}" + (
                "" if kind == "plain" else "; first token -> ToolCall CR " +
                _fmt(_ms_stats(k["first_token_to_toolcall_ms"]))) + f"  [{card}]")
        if kind == "plain":
            say(f"operator {label} {kind}: create -> FinalAnswer "
                f"{_fmt(_ms_stats(k['create_to_final_ms']))}  [{card}]")
            continue
        line = (f"operator {label} {kind}: create -> first ToolCall CR "
                f"{_fmt(_ms_stats(k['create_to_first_toolcall_ms']))} ({', '.join(k['how'])}); "
                f"-> {'/'.join(k['terminal'])} {_fmt(_ms_stats(k['create_to_terminal_ms']))}; "
                f"-> result joined {_fmt(_ms_stats(k['create_to_joined_ms']))}")
        if kind == "human":
            line += (f"; create -> AwaitingHumanInput {_fmt(_ms_stats(k['create_to_awaiting_ms']))}"
                     f", respond -> joined {_fmt(_ms_stats(k['respond_to_joined_ms']))}")
        if kind == "delegate":
            line += (f"; applied delegation -> child FinalAnswer "
                     f"{k['applied_to_child_final_ms']:.1f} ms, -> Succeeded "
                     f"{k['applied_to_succeeded_ms']:.1f} ms, -> child output joined "
                     f"{k['applied_to_joined_ms']:.1f} ms")
        say(line + f"  [{card}]")
    all_first = [v for k in kinds.values() for v in k["create_to_first_toolcall_ms"]]
    say(f"operator {label}: Task create -> first ToolCall CR over all 6 tool Tasks "
        f"{_fmt(_ms_stats(all_first))}; {steps} decode steps, "
        f"{walk} {'int8' if int8_walk else 'bf16'}-walk launches, other walk {other}; "
        f"parks {out['parks']}, park adoptions {out['park_adoptions']}; dedup shares "
        f"{out['prefix_shares']}, shared pages at most {out['shared_pages_peak']}; megastep "
        f"dispatches {out['megastep_dispatches']}, quota projections "
        f"{out['quota_projections']}; "
        f"drain {out['drain_s']:.2f} s; phase {phase_s:.1f} s  [{card}]")
    return {**out, "card": card, "walk_launches": walk, "first_toolcall_ms": _ms_stats(all_first),
            "phase_s": phase_s, "toolcall_poll_s": TOOLCALL_POLL_S,
            "agent_requeue_s": AGENT_REQUEUE_S}


def _operator_rest_checks(op, tasks: dict, label: str) -> dict:
    """The engine's observability routes on the operator's REST server:
    ``/v1/engine/perf`` and ``/v1/requests/{rid}/timeline`` of a Task's own
    request, found through the Task's trace (the engine's phase spans under
    it carry the request id)."""
    deadline = time.monotonic() + 30
    while not op.rest_server.bound_port and time.monotonic() < deadline:
        time.sleep(0.01)
    base = f"http://127.0.0.1:{op.rest_server.bound_port}"
    task = tasks["t-plain-0"]
    ctx = task.status.span_context
    rids = [sp.attributes["request_id"] for sp in op.tracer.spans_for_trace(ctx.trace_id)
            if sp.name.startswith("engine.")] if ctx is not None else []
    if not rids:
        fail(f"operator {label}: no engine phase span under {task.name}'s trace")
    rid = rids[-1]
    status, doc = _get(base, f"/v1/requests/{rid}/timeline")
    kinds = [e["kind"] for e in doc["events"]] if status == 200 else []
    if status != 200 or doc["request_id"] != rid or kinds[:1] != ["submit"] or \
            kinds[-1:] != ["finish"] or not {"queue_wait", "prefill", "decode"} <= set(
                doc["phases"]):
        fail(f"operator {label}: GET /v1/requests/{rid}/timeline -> {status} {str(doc)[:300]}")
    p_status, perf = _get(base, "/v1/engine/perf")
    if p_status != 200 or not perf.get("configured") or not perf.get("programs"):
        fail(f"operator {label}: GET /v1/engine/perf -> {p_status} {str(perf)[:300]}")
    return {"task": task.name, "rid": rid, "timeline_status": status, "perf_status": p_status,
            "events": kinds, "phases_ms": {k: v * 1e3 for k, v in doc["phases"].items()},
            "total_ms": doc["total_s"] * 1e3, "trace_spans": len(rids),
            "perf_programs": len(perf["programs"])}


# -- observability phase ----------------------------------------------------


def _obs_prompts(n: int, length: int, seed: int, vocab: int) -> list[list[int]]:
    """``n`` distinct token rows of ``length`` from a seed (no shared page,
    so no dedup or cache reuse between them)."""
    import random

    rng = random.Random(seed)
    return [[rng.randrange(256, min(8192, vocab)) for _ in range(length)] for _ in range(n)]


def _group_burst(engine, prompts, sp) -> tuple:
    """The requests admitted as one group on an empty prefix cache:
    (results, futures, decode steps, ms per decode step)."""
    _forget_prefixes(engine)
    with engine.hold_admission():
        futs = [engine.submit(p, sp) for p in prompts]
        s0 = engine.decode_steps
    res = [f.result(timeout=600) for f in futs]
    steps = engine.decode_steps - s0
    decode_ms = max(r.latency_ms for r in res) - max(r.ttft_ms for r in res)
    return res, futs, steps, decode_ms / max(1, steps)


def observability_phase(engine, card: str, label: str, rest: dict, prompt_len: int = 512,
                        max_tokens: int = 64, device: str = "cuda") -> dict:
    """The flight recorder, the dispatch profiler and the audit on the
    running llama3-8b engine (ROADMAP A.11), after the operator phase:
    (a) 8 concurrent greedy requests of 512 prompt + 64 sampled tokens:
    every timeline's phases sum to its submit -> finish wall within 1%, the
    median queue_wait / prefill / decode printed; (b) the profiler's
    per-program dispatches, host and sampled device ms and first
    dispatches printed, its ledger conserved; (c) the exported trace
    validates (written to the output directory), and the operator phase's REST
    reads (``/v1/requests/{rid}/timeline`` of a Task's own request and
    ``/v1/engine/perf``) answered 200; (d) the same requests with the
    recorder and profiler off give the same streams, ms per decode step on
    and off printed (median of 3 runs each, interleaved); (e) one burst
    with the invariant checker armed audits clean (the audit's ms per
    cycle printed), then on tiny f32 engines on the card
    ``engine.invariant_break`` writes a crash dump holding the violation
    and ``ensure_running`` serves the next request, and
    ``engine.prefetch_error`` aborts staged copies of the side stream with
    byte-identical streams. The walk's launches of (a) must equal n_layers
    x decode steps."""
    import os
    import tempfile

    import torch

    from agentcontrolplane_tpu_torch.engine.engine import SamplingParams
    from agentcontrolplane_tpu_torch.engine.invariants import verify_engine
    from agentcontrolplane_tpu_torch.observability.trace_export import (
        export_trace,
        validate_trace,
    )
    from agentcontrolplane_tpu_torch.ops.cuda import paged_attention as pa

    t_phase = time.monotonic()
    cfg = engine.config
    _idle_parked(engine)
    _forget_prefixes(engine)
    prompts = _obs_prompts(8, prompt_len, 11, cfg.vocab_size)
    sp = SamplingParams(max_tokens=max_tokens)

    def burst() -> tuple:
        return _group_burst(engine, prompts, sp)

    # (a) the counted run: the walk's counts to 0 just before, read after
    pa.LAUNCHES = 0
    pa.INT8_LAUNCHES = 0
    res_on, futs_on, steps_a, ms_on0 = burst()
    launches = pa.LAUNCHES
    if launches != cfg.n_layers * steps_a or steps_a == 0 or pa.INT8_LAUNCHES:
        fail(f"observability {label}: {launches} walk launches for {steps_a} decode steps x "
             f"{cfg.n_layers} layers (int8 walk {pa.INT8_LAUNCHES})")
    phases: dict = {}
    worst = 0.0
    for f in futs_on:
        doc = engine.flight.timeline_doc(f.rid)
        if doc is None or doc["events"][-1]["kind"] != "finish":
            fail(f"observability {label}: no finished timeline for {f.rid}")
        summed = sum(v for k, v in doc["phases"].items()
                     if k not in ("tool_overlap_hidden", "host_stall"))
        off = abs(summed - doc["total_s"]) / doc["total_s"]
        worst = max(worst, off)
        if off > 0.01:
            fail(f"observability {label}: {f.rid}'s phases sum to {summed:.6f} s against its "
                 f"{doc['total_s']:.6f} s wall")
        for k, v in doc["phases"].items():
            phases.setdefault(k, []).append(v * 1e3)
    split = {k: statistics.median(v) for k, v in phases.items()}
    say(f"observability {label} (a): 8 x ({prompt_len} + {max_tokens}) greedy, {steps_a} decode steps, "
        f"walk launches {launches} = {cfg.n_layers} x {steps_a}; phases sum to the wall within "
        f"{worst * 100:.4f}%; median " + ", ".join(f"{k} {v:.1f} ms" for k, v in split.items())
        + f"  [{card}]")

    # (b) the profiler
    perf = engine.profiler.stats()
    led = engine.profiler.ledger()
    if led["computed"] != led["goodput"] + sum(led["waste"].values()) or led["computed"] <= 0:
        fail(f"observability {label}: the goodput ledger does not balance: {led}")
    programs = perf["programs"]
    top = sorted(programs.items(), key=lambda kv: -kv[1]["host_ms_total"])[:12]
    for key, pr in top:
        say(f"observability {label} (b): {key}: {pr['dispatches']} dispatches, host "
            f"{pr['host_ms_mean']:.3f} ms mean, device {pr['device_ms_mean']} ms mean over "
            f"{pr['device_samples']} samples, first dispatch {pr['first_wall_ms']:.1f} ms, "
            f"padding {pr['padding_pct']:.1f}%  [{card}]")
    g = perf["goodput"]
    say(f"observability {label} (b): {len(programs)} program keys; ledger {g['goodput']} goodput "
        f"of {g['computed']} computed ({g['ratio']:.4f}), waste "
        f"{ {k: v for k, v in g['waste'].items() if v} }; conserved  [{card}]")

    # (c) the trace and the REST reads
    trace = export_trace(engine.flight)
    problems = validate_trace(trace)
    if problems or not trace["requests"]:
        fail(f"observability {label}: the exported trace does not validate: {problems[:5]}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"observability_trace_{label}.json").write_text(json.dumps(trace, indent=1))
    if rest["timeline_status"] != 200 or rest["perf_status"] != 200:
        fail(f"observability {label}: REST reads {rest}")
    say(f"observability {label} (c): trace of {len(trace['requests'])} requests validates "
        f"(complete={trace['complete']}); operator REST: {rest['task']}'s request {rest['rid']} "
        f"timeline 200 ({' '.join(rest['events'])}), /v1/engine/perf 200 "
        f"({rest['perf_programs']} programs)  [{card}]")

    # (d) recorder and profiler off: the same streams; ms per decode step
    ms = {True: [ms_on0], False: []}
    streams_on = [list(r.tokens) for r in res_on]
    for rep_i in range(5):
        on = rep_i % 2 == 1
        engine.flight.enabled = engine.profiler.enabled = on
        try:
            res, _f, _s, ms_step = burst()
        finally:
            engine.flight.enabled = engine.profiler.enabled = True
        if [list(r.tokens) for r in res] != streams_on:
            fail(f"observability {label}: streams differ with the recorder and profiler "
                 f"{'on' if on else 'off'}")
        ms[on].append(ms_step)
    med_on, med_off = statistics.median(ms[True]), statistics.median(ms[False])
    say(f"observability {label} (d): streams byte-identical on and off; ms per decode step "
        f"on {med_on:.2f} ({', '.join(f'{v:.2f}' for v in ms[True])}), off {med_off:.2f} "
        f"({', '.join(f'{v:.2f}' for v in ms[False])}); on/off {med_on / med_off:.4f}  [{card}]")

    # (e) the armed audit on this engine
    checks0 = _registry_count("acp_engine_invariant_checks_total")
    engine.check_invariants = True
    try:
        _res_a, _f, steps_e, ms_armed = burst()
    finally:
        engine.check_invariants = False
    audits = int(_registry_count("acp_engine_invariant_checks_total") - checks0)
    audit_ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        found = verify_engine(engine)
        audit_ms.append((time.perf_counter() - t0) * 1e3)
    if found or audits <= 0:
        fail(f"observability {label}: the armed burst audited {audits} cycles; idle audit {found}")
    say(f"observability {label} (e): armed burst {audits} audits clean over {steps_e} decode "
        f"steps, {ms_armed:.2f} ms per decode step armed; the audit alone "
        f"{statistics.median(audit_ms):.3f} ms per cycle (median of 20, idle engine)  [{card}]")

    # (e) the crash dump and the prefetch abort on tiny f32 engines
    with tempfile.TemporaryDirectory(dir=out_dir) as dump_dir:
        os.environ["ACP_FLIGHT_DUMP_DIR"] = dump_dir
        try:
            tiny = _tiny_fault_runs(card, dump_dir, device)
        finally:
            os.environ.pop("ACP_FLIGHT_DUMP_DIR", None)
    phase_s = time.monotonic() - t_phase
    say(f"observability {label}: phase {phase_s:.1f} s  [{card}]")
    return {"card": card, "launches": launches, "decode_steps": steps_a,
            "phase_split_ms_median": split, "phase_sum_worst_rel": worst,
            "programs": programs, "goodput": g, "trace_requests": len(trace["requests"]),
            "rest": rest, "streams": streams_on,
            "ms_per_decode_step": {"on": ms[True], "off": ms[False],
                                                 "median_on": med_on, "median_off": med_off},
            "armed": {"audits": audits, "ms_per_decode_step": ms_armed,
                      "audit_ms_median": statistics.median(audit_ms)},
            "tiny": tiny, "phase_s": phase_s}


def _registry_count(name: str) -> float:
    from agentcontrolplane_tpu_torch.observability.metrics import REGISTRY

    m = REGISTRY._metrics.get(name)
    return 0.0 if m is None else m.values.get((), 0.0)


SLOT_ROWS, SLOT_PROMPT, SLOT_TOKENS = 8, 512, 64  # (a) and (b) of the slot phase
SLOT_INT8_TOKENS = 32  # the int8 slot engine's served tokens a request
SLOT_TOL = 2e-2  # (a): relative L2 from an f32 pass (ROADMAP C, the bf16 gates)
SLOT_REPEATS = 3  # (b): bursts timed on the slot engine (median)
SLOT_PREEMPT_TOKENS = 32  # (c): the preempted request's tokens (the fault at its 16th step)
SLOT_WIDTHS = (8, 64)  # (d): decode widths timed on both layouts (run's --tpu-slots is 64)
SLOT_WIDTH_ROWS = 576  # (d): each lane's rows before the step (the burst's 512 + 64)
SLOT_WIDTH_STEPS = 5  # (d): timed steps a width and layout (median), after one warm step


def _slot_engine(params, **kw):
    """The slot layout on llama3-8b at the serving phase's widths, over an
    engine's params (no second weight init)."""
    from agentcontrolplane_tpu_torch.engine.engine import Engine

    return Engine("llama3-8b", params=params, device="cuda", seed=0, kv_layout="slot",
                  max_slots=SLOT_ROWS, max_ctx=2048, decode_block_size=8, **kw)


def _slot_first_logits(engine, rows):
    """``prefill_batch``'s last-token logits over ``rows`` [B, T] into slots
    0..B-1 of the (not yet started) engine's cache, then those of one
    ``decode_step`` on each row's argmax; both [B, V] f32, and the argmaxes."""
    import torch

    from agentcontrolplane_tpu_torch.models import llama

    cfg = engine.config
    B, T = rows.shape
    with torch.inference_mode():
        engine.cache, lg0 = llama.prefill_batch(
            engine.params, engine.cache, rows, torch.full((B,), T, device="cuda"),
            torch.arange(B, device="cuda"), cfg)
        nxt = lg0.argmax(-1)
        engine.cache, lg1 = llama.decode_step(
            engine.params, engine.cache, nxt, torch.full((B,), T, dtype=torch.int32,
                                                         device="cuda"),
            cfg, active=torch.ones(B, dtype=torch.bool, device="cuda"))
    return lg0.float(), lg1.float(), nxt


def _paged_first_logits(engine, rows, nxt):
    """The paged layout's prefill and decode logits on the same rows and
    next tokens, on a scratch pool (the walk runs in the decode step)."""
    import torch

    from agentcontrolplane_tpu_torch.models import llama

    cfg = engine.config
    B, T = rows.shape
    P = 16
    n = T // P + 1  # the decode row lands on a fresh page
    ids = torch.arange(1, 1 + B * n, device="cuda").reshape(B, n)
    with torch.inference_mode():
        pages = llama.init_paged_cache(cfg, 1 + B * n, P, device="cuda",
                                       quantize_kv=engine.quantize_kv)
        pages, lg0 = llama.prefill_paged_batch(engine.params, pages, rows,
                                               torch.full((B,), T, device="cuda"),
                                               ids[:, : T // P], cfg)
        tables = torch.zeros(B, 2048 // P, dtype=torch.int32, device="cuda")
        tables[:, :n] = ids
        pages, lg1 = llama.decode_step_paged(
            engine.params, pages, nxt, torch.full((B,), T, dtype=torch.int32, device="cuda"),
            tables, torch.ones(B, dtype=torch.bool, device="cuda"), cfg)
        del pages
    return lg0.float(), lg1.float()




def _slot_decode_widths(engine, card: str) -> dict:
    """(d) One decode step of the model functions on the serving engine's
    params at each of SLOT_WIDTHS lanes, every lane at SLOT_WIDTH_ROWS rows
    of a 2048-row context: ``decode_step`` over a slot cache of
    ``max(SLOT_WIDTHS)`` x 2048 rows against ``decode_step_paged`` (the
    walk) over pages holding the same rows. ms by CUDA events around each
    call, median of SLOT_WIDTH_STEPS, the layouts interleaved. Reported,
    not gated; the walk's launches here fall outside every counted run."""
    import torch

    from agentcontrolplane_tpu_torch.models import llama

    cfg = engine.config
    S, C, P = max(SLOT_WIDTHS), 2048, 16
    n = SLOT_WIDTH_ROWS // P + 1  # the step's row lands on the last page
    doc: dict = {"card": card, "rows": SLOT_WIDTH_ROWS, "max_ctx": C}
    with torch.inference_mode():
        cache = llama.init_kv_cache(cfg, S, C, device="cuda", quantize_kv=engine.quantize_kv)
        pages = llama.init_paged_cache(cfg, 1 + S * n, P, device="cuda",
                                       quantize_kv=engine.quantize_kv)
        tables = torch.zeros(S, C // P, dtype=torch.int32, device="cuda")
        tables[:, :n] = torch.arange(1, 1 + S * n, dtype=torch.int32,
                                     device="cuda").reshape(S, n)
        g = torch.Generator().manual_seed(37)

        def ms(fn) -> float:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end)

        for W in SLOT_WIDTHS:
            toks = torch.randint(256, 8192, (W,), generator=g).to("cuda")
            lens = torch.full((W,), SLOT_WIDTH_ROWS, dtype=torch.int32, device="cuda")
            active = torch.ones(W, dtype=torch.bool, device="cuda")
            runs = {
                "slot": lambda: llama.decode_step(engine.params, cache, toks, lens, cfg,
                                                  active=active),
                "paged": lambda: llama.decode_step_paged(engine.params, pages, toks, lens,
                                                         tables[:W], active, cfg),
            }
            times: dict = {k: [] for k in runs}
            for k, fn in runs.items():
                ms(fn)  # warm
            for _ in range(SLOT_WIDTH_STEPS):
                for k, fn in runs.items():
                    times[k].append(ms(fn))
            med = {k: statistics.median(v) for k, v in times.items()}
            doc[W] = {"ms": times, "median_ms": med, "ratio": med["slot"] / med["paged"],
                      "slot_rows_read": W * C, "paged_rows_read": W * SLOT_WIDTH_ROWS}
            say(f"slot bf16 (d): one decode step at {W} lanes of {SLOT_WIDTH_ROWS} rows: slot "
                f"(every lane's {C} rows in f32) {med['slot']:.2f} ms, paged (the walk) "
                f"{med['paged']:.2f} ms, {med['slot'] / med['paged']:.2f}x (medians of "
                f"{SLOT_WIDTH_STEPS}; slot {', '.join(f'{t:.2f}' for t in times['slot'])}; "
                f"paged {', '.join(f'{t:.2f}' for t in times['paged'])})  [{card}]")
        del cache, pages
    gc.collect()
    torch.cuda.empty_cache()
    return doc


def _walk_counts() -> tuple:
    from agentcontrolplane_tpu_torch.ops.cuda import paged_attention as pa

    return pa.LAUNCHES, pa.INT8_LAUNCHES, pa.STATE_LAUNCHES


def _slot_reuse(engine, prompts, card: str, label: str) -> dict:
    """(c) KV reuse on the slot layout: a 2-turn parked conversation adopts
    its slot; a repeated prompt hits the prefix cache (a ``prefix_copy``);
    under a 1 GiB host tier one ``engine.force_preempt`` swaps the slot's
    rows out and the resume restores rows bit-equal to the rows taken
    before the swap."""
    import torch

    from agentcontrolplane_tpu_torch.engine.engine import SamplingParams
    from agentcontrolplane_tpu_torch.faults import FAULTS

    sp = SamplingParams(max_tokens=8)
    what = f"slot {label} (c)"
    a0 = engine.park_adoptions
    turn1 = prompts[0][:300]
    engine.submit(turn1, sp, park=True).result(timeout=600)
    engine.generate(turn1 + prompts[1][:40], sp)
    adoptions = engine.park_adoptions - a0
    _idle_parked(engine)
    _forget_prefixes(engine)
    h0 = engine._prefix_hits
    engine.generate(prompts[2], sp)
    engine.generate(prompts[2], sp)
    hits = engine._prefix_hits - h0
    copies = [k for k in engine.profiler.stats()["programs"] if k.startswith("prefix_copy[")]
    _forget_prefixes(engine)
    # the host tier: the rows at the swap-out, held on the card, against the
    # rows the restore lands
    engine.set_host_kv_bytes(HOST_KV_BYTES)
    taken, landed = [], []
    extract, finish = engine._extract_rows, engine._finish_swap_in

    def on_extract(slot, cut):
        taken.append({n: a[:, slot, :cut].clone() for n, a in engine.cache.items()})
        return extract(slot, cut)

    def on_finish(slot, sl):
        n = sl.prefill_pos
        landed.append((n, all(torch.equal(engine.cache[name][:, slot, :n], taken[-1][name][:, :n])
                              for name in engine.cache)))
        finish(slot, sl)

    engine._extract_rows, engine._finish_swap_in = on_extract, on_finish
    o0, i0 = engine.kv_swap_outs, engine.kv_swap_ins
    try:
        FAULTS.arm("engine.force_preempt", after_steps=engine.decode_steps + 16)
        r = engine.generate(prompts[3], SamplingParams(max_tokens=SLOT_PREEMPT_TOKENS))
    finally:
        FAULTS.reset()
        del engine._extract_rows, engine._finish_swap_in
        engine.set_host_kv_bytes(0)
    outs, ins = engine.kv_swap_outs - o0, engine.kv_swap_ins - i0
    if adoptions != 1 or hits != 1 or not copies:
        fail(f"{what}: {adoptions} adoptions, {hits} prefix-cache hits, copies {copies}")
    if r.preempt_count != 1 or outs != 1 or ins != 1 or len(landed) != 1 or not landed[0][1]:
        fail(f"{what}: preempted {r.preempt_count}, {outs} swap-outs, {ins} swap-ins, "
             f"restores {landed}")
    say(f"{what}: a parked turn adopted by its next ({adoptions}); a repeated prompt hit the "
        f"prefix cache ({hits}, {copies}); one forced preemption under a "
        f"{HOST_KV_BYTES >> 20} MiB host tier swapped out {landed[0][0]} rows and restored them "
        f"bit-equal; the resumed request returned {len(r.tokens)} tokens  [{card}]")
    return {"adoptions": adoptions, "prefix_hits": hits, "prefix_copies": copies,
            "swap_outs": outs, "swap_ins": ins, "rows_restored": landed[0][0]}


def slot_phase(engine, card: str, label: str, paged: dict = None, ref=None) -> dict:
    """The slot KV layout (ROADMAP A.10) on the serving phase's llama3-8b
    params, one ``Engine(kv_layout="slot", max_slots=8, max_ctx=2048)``,
    freed at the end. bf16 (``ref`` None): (a) SLOT_ROWS random rows of
    SLOT_PROMPT tokens: ``prefill_batch``'s last-token logits and one
    ``decode_step``'s, each gated against an f32 pass over the same rows
    at SLOT_TOL relative L2, the paged functions' distance on the same rows
    printed; (b) the observability phase's SLOT_ROWS x (SLOT_PROMPT +
    SLOT_TOKENS) greedy requests served SLOT_REPEATS times: every request
    returns SLOT_TOKENS tokens and the walk's counters do not move; the
    program keys, the streams' agreement with the paged engine's and the
    ms per decode step on both layouts printed; (c) ``_slot_reuse``; (d)
    after the slot engine is freed, ``_slot_decode_widths``. int8
    (``ref`` the bf16 phase's first-step logits): (a)'s logits against the
    bf16 slot engine's, printed; SLOT_ROWS x SLOT_INT8_TOKENS served on the
    walk-free path. The doc's ``first`` holds (a)'s logits for the int8
    phase."""
    import torch

    from agentcontrolplane_tpu_torch.engine.engine import SamplingParams

    t_phase = time.monotonic()
    cfg = engine.config
    what = f"slot {label}"
    quant = dict(quantize_weights=engine.quantize == "int8", quantize_kv=engine.quantize_kv)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    slot = _slot_engine(engine.params, **quant)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    cache_bytes = _pool_bytes(slot.cache)
    doc: dict = {"card": card, "init_s": init_s, "cache_bytes": cache_bytes}
    try:
        g = torch.Generator().manual_seed(29)
        rows = torch.randint(256, 8192, (SLOT_ROWS, SLOT_PROMPT), generator=g).to("cuda")
        lg0, lg1, nxt = _slot_first_logits(slot, rows)
        finite = bool(torch.isfinite(lg0).all() and torch.isfinite(lg1).all())
        if ref is None:
            f0 = _f32_logits(engine, rows)[:, -1]
            f1 = _f32_logits(engine, torch.cat([rows, nxt[:, None]], dim=1))[:, -1]
            p0, p1 = _paged_first_logits(engine, rows, nxt)
            d = {"prefill_vs_f32": [_rel_l2(lg0[i], f0[i]) for i in range(SLOT_ROWS)],
                 "decode_vs_f32": [_rel_l2(lg1[i], f1[i]) for i in range(SLOT_ROWS)],
                 "paged_prefill_vs_f32": [_rel_l2(p0[i], f0[i]) for i in range(SLOT_ROWS)],
                 "paged_decode_vs_f32": [_rel_l2(p1[i], f1[i]) for i in range(SLOT_ROWS)],
                 "prefill_vs_paged": [_rel_l2(lg0[i], p0[i]) for i in range(SLOT_ROWS)],
                 "decode_vs_paged": [_rel_l2(lg1[i], p1[i]) for i in range(SLOT_ROWS)]}
            worst = max(max(d["prefill_vs_f32"]), max(d["decode_vs_f32"]))
            if not finite or worst > SLOT_TOL:
                fail(f"{what} (a): prefill / decode logits {max(d['prefill_vs_f32']):.3e} / "
                     f"{max(d['decode_vs_f32']):.3e} relative L2 from an f32 pass (tol "
                     f"{SLOT_TOL}), finite {finite}")
            say(f"{what} (a): {SLOT_ROWS} rows of {SLOT_PROMPT}: prefill_batch's last-token logits "
                f"max {max(d['prefill_vs_f32']):.3e} and one decode_step's max "
                f"{max(d['decode_vs_f32']):.3e} relative L2 from an f32 pass (tol {SLOT_TOL}); "
                f"the paged functions' {max(d['paged_prefill_vs_f32']):.3e} / "
                f"{max(d['paged_decode_vs_f32']):.3e}; slot against paged "
                f"{max(d['prefill_vs_paged']):.3e} / {max(d['decode_vs_paged']):.3e} (not gated)"
                f"  [{card}]")
            doc["logits"] = d
            doc["first"] = (lg0.cpu(), lg1.cpu())
        else:
            b0, b1 = ref
            d = {"prefill_vs_bf16_slot": [_rel_l2(lg0[i].cpu(), b0[i]) for i in range(SLOT_ROWS)],
                 "decode_vs_bf16_slot": [_rel_l2(lg1[i].cpu(), b1[i]) for i in range(SLOT_ROWS)]}
            if not finite:
                fail(f"{what} (a): the int8 slot engine's first-step logits are not finite")
            say(f"{what} (a): the int8 slot engine's prefill / decode logits on the same rows "
                f"max {max(d['prefill_vs_bf16_slot']):.3e} / {max(d['decode_vs_bf16_slot']):.3e} "
                f"relative L2 from the bf16 slot engine's (reported)  [{card}]")
            doc["logits"] = d
        del lg0, lg1

        prompts = _obs_prompts(SLOT_ROWS, SLOT_PROMPT, 11, cfg.vocab_size)
        tokens = SLOT_TOKENS if ref is None else SLOT_INT8_TOKENS
        slot.start()
        counts0 = _walk_counts()
        runs = [_group_burst(slot, prompts, SamplingParams(max_tokens=tokens))
                for _ in range(SLOT_REPEATS if ref is None else 1)]
        counts1 = _walk_counts()
        res, _futs, steps, _ms = runs[0]
        ms = [m for _r, _f, _s, m in runs]
        n_tokens = [len(r.tokens) for r in res]
        if counts1 != counts0 or n_tokens != [tokens] * SLOT_ROWS or steps <= 0:
            fail(f"{what} (b): tokens {n_tokens} (want {tokens} each), walk counts "
                 f"{counts0} -> {counts1}, {steps} decode steps")
        keys = sorted(k for k in slot.profiler.stats()["programs"]
                      if k.startswith(("decode[", "megastep[", "prefill[")))
        doc.update(decode_steps=steps, ms_per_decode_step=ms,
                   ms_per_decode_step_median=statistics.median(ms), programs=keys,
                   walk_counts=counts1)
        line = (f"{what} (b): {SLOT_ROWS} x ({SLOT_PROMPT} + {tokens}) greedy served, every "
                f"request {tokens} tokens, {steps} decode steps, walk counts unchanged "
                f"{counts1}; programs {keys}; ms per decode step "
                f"{statistics.median(ms):.2f} ({', '.join(f'{m:.2f}' for m in ms)})")
        if ref is None:
            streams = paged["streams"]
            same = sum(list(r.tokens) == s for r, s in zip(res, streams))
            agree = sum(a == b for r, s in zip(res, streams) for a, b in zip(r.tokens, s))
            doc.update(identical_streams=same, agreeing_tokens=agree,
                       paged_ms_per_decode_step=paged["ms_per_decode_step"]["median_on"])
            line += (f"; paged (observability phase, this process) "
                     f"{paged['ms_per_decode_step']['median_on']:.2f}; streams identical to the "
                     f"paged engine's {same} of {SLOT_ROWS}, tokens agreeing position by "
                     f"position {agree} of {SLOT_ROWS * tokens} (bf16 orders differ; not gated)")
            say(line + f"  [{card}]")
            doc["reuse"] = _slot_reuse(slot, prompts, card, label)
        else:
            say(line + f"  [{card}]")
    finally:
        slot.stop()
        del slot
        gc.collect()
        torch.cuda.empty_cache()
    if ref is None:
        doc["widths"] = _slot_decode_widths(engine, card)
    doc["phase_s"] = time.monotonic() - t_phase
    say(f"{what}: init {init_s:.2f} s, {cache_bytes / 1e9:.3f} GB of slot cache; phase "
        f"{doc['phase_s']:.1f} s  [{card}]")
    return doc


def _tiny_fault_runs(card: str, dump_dir: str, device: str = "cuda") -> dict:
    """Tiny f32 engines on the card: ``engine.invariant_break`` on an armed
    engine crashes it with a dump holding the violation, and
    ``ensure_running`` serves the next request; ``engine.prefetch_error``
    aborts two staged restores (the side stream's copies) on a tight pool
    with the host tier, and the streams equal the uncontended runs."""
    import dataclasses
    import glob

    from agentcontrolplane_tpu_torch.engine.engine import Engine, SamplingParams
    from agentcontrolplane_tpu_torch.faults import FAULTS
    from agentcontrolplane_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.PRESETS["tiny"], vocab_size=512, max_seq_len=256)
    kw = dict(max_slots=4, max_ctx=64, prefill_buckets=(32, 64), decode_block_size=4,
              page_size=8, kv_pages=33, seed=0)
    out = {}
    eng = Engine(cfg, device=device, check_invariants=True, **kw)
    eng.start()
    try:
        sp = SamplingParams(max_tokens=8)
        eng.generate("warm-up", sp)
        FAULTS.arm("engine.invariant_break")
        fut = eng.submit("boom", sp)
        try:
            fut.result(timeout=120)
            fail("tiny: engine.invariant_break did not crash the armed engine")
        except RuntimeError as e:
            if "invariant" not in str(e):
                fail(f"tiny: the crash is not the invariant violation: {e}")
        dumps = sorted(glob.glob(f"{dump_dir}/flightdump-*.json"))
        if not dumps:
            fail("tiny: no flight dump written")
        dump = json.loads(Path(dumps[-1]).read_text())
        kinds = [e["kind"] for e in dump["events"]]
        if dump["error"]["type"] != "InvariantViolation" or "invariant_violation" not in kinds \
                or "crash" not in kinds:
            fail(f"tiny: the dump holds {dump['error']} and {kinds[-6:]}")
        if not eng.ensure_running():
            fail("tiny: ensure_running did not restart the engine")
        after = eng.generate("after the crash", sp)
        if not after.tokens or not eng.flight.events(kind="restart"):
            fail("tiny: no request served after the restart")
        out["crash_dump"] = {"events": len(kinds), "last_kinds": kinds[-4:],
                             "after_tokens": len(after.tokens)}
    finally:
        FAULTS.reset()
        eng.stop()
    eng = Engine(cfg, device=device, host_kv_bytes=1 << 22, prefill_chunk=16, **kw)
    eng.start()
    try:
        sp = SamplingParams(max_tokens=12)
        prompts = [ch * 20 for ch in "abcdef"]
        # the reference's 10-page pool: the page-pressure site holds the rest
        FAULTS.arm("engine.page_pressure", pages=eng._allocator.free_count - 9)
        FAULTS.apply_page_pressure(eng._allocator)
        solo = [eng.generate(p, sp).tokens for p in prompts]
        FAULTS.arm("engine.prefetch_error", times=2)
        with eng.hold_admission():
            futs = [eng.submit(p, sp) for p in prompts]
        burst = [f.result(timeout=120).tokens for f in futs]
        aborts = len(eng.flight.events(kind="prefetch_abort", last=0))
        if burst != solo or aborts < 1 or eng.kv_swap_ins < 1:
            fail(f"tiny: prefetch_error: streams equal {burst == solo}, {aborts} aborts, "
                 f"{eng.kv_swap_ins} restores")
        out["prefetch_error"] = {"aborts": aborts, "restores": eng.kv_swap_ins,
                                 "prefetch_commits": eng.kv_prefetch_commits}
    finally:
        FAULTS.reset()
        eng.stop()
    say(f"observability tiny: engine.invariant_break -> dump with {out['crash_dump']['events']} "
        f"events ending {out['crash_dump']['last_kinds']}, restarted and served; "
        f"engine.prefetch_error -> {out['prefetch_error']['aborts']} aborts, "
        f"{out['prefetch_error']['restores']} restores, streams equal  [{card}]")
    return out


def _fmt(st: dict) -> str:
    """p50 (the median) and max; with two values or fewer, each value."""
    if not st:
        return "none"
    if st["n"] <= 2:
        return " and ".join(f"{v:.1f}" for v in st["values"]) + " ms"
    return f"p50 {st['p50']:.1f} / max {st['max']:.1f} ms"


def first_step_logits(params, cfg, group, device, quantize_kv: bool = False):
    """Logits of a fixed 20-token prompt's paged prefill and of the decode
    step after it, on a scratch pool of 4 pages of 16 (this rank's slice of
    it with a group; every rank of the group must call this)."""
    import torch

    from agentcontrolplane_tpu_torch.models import llama

    with torch.inference_mode():
        pages = llama.init_paged_cache(cfg, 4, 16, device=device, quantize_kv=quantize_kv,
                                       group=group)
        toks = torch.zeros(1, 32, dtype=torch.long)
        toks[0, :20] = torch.tensor(FIRST_PROMPT)
        pages, lg0 = llama.prefill_paged_batch(
            params, pages, toks.to(device), torch.tensor([20], device=device),
            torch.tensor([[1, 2]], device=device), cfg, group=group)
        pages, lg1 = llama.decode_step_paged(
            params, pages, torch.tensor([int(lg0[0].argmax())], device=device),
            torch.tensor([20], dtype=torch.int32, device=device),
            torch.tensor([[1, 2, 3, 0]], dtype=torch.int32, device=device),
            torch.tensor([True], device=device), cfg, group=group)
        return torch.stack([lg0[0], lg1[0]]).float().cpu()


def collective_replay_ms(group, cfg, slots: int = 8, reps: int = 3) -> dict:
    """Device-synchronized ms of one decode step's collectives replayed
    alone at ``slots`` lanes, with the shapes and dtypes the model sends:
    the embedding and the two per-layer tp sums of [slots, 1, dim] bf16,
    per layer the sp merge's max and two sums of f32 [slots, H/tp] and
    [slots, H/tp, d], and the logits' tp sum of f32 [slots, V]. Timed as the
    port sends them (``ServingGroup``: an f32 copy on the card, reduced by
    the backend), and, for comparison, staged through the host by hand
    (copy to the CPU, reduce, copy back). Every rank of the group must call
    this at once."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.randn(slots, 1, cfg.dim, device=dev).to(cfg.dtype)
    h = cfg.n_heads // group.tp
    m = torch.randn(slots, h, device=dev)
    acc = torch.randn(slots, h, cfg.head_dim, device=dev)
    logits = torch.randn(slots, cfg.vocab_size, device=dev)
    MAX, SUM = dist.ReduceOp.MAX, dist.ReduceOp.SUM

    def staged(t, op, g):
        buf = t.to("cpu", torch.float32)
        dist.all_reduce(buf, op=op, group=g)
        return buf.to(dev, t.dtype)

    def step(reduce):
        reduce(x, SUM, "tp")
        for _ in range(cfg.n_layers):
            if group.sp > 1:
                reduce(m, MAX, "sp")
                reduce(m, SUM, "sp")
                reduce(acc, SUM, "sp")
            reduce(x, SUM, "tp")
            reduce(x, SUM, "tp")
        reduce(logits, SUM, "tp")

    def ported(t, op, axis):
        if axis == "tp":
            return group.tp_sum(t)
        return group.sp_max(t) if op == MAX else group.sp_sum(t)

    def by_hand(t, op, axis):
        if (group.tp if axis == "tp" else group.sp) == 1:
            return t
        return staged(t, op, group.tp_group if axis == "tp" else group.sp_group)

    out = {}
    for name, fn in (("ms_per_step", ported), ("host_staged_ms_per_step", by_hand)):
        calls0 = group.collective_calls
        step(fn)
        out["calls_per_step"] = max(out.get("calls_per_step", 0), group.collective_calls - calls0)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            step(fn)
        torch.cuda.synchronize(dev)
        out[name] = (time.perf_counter() - t0) * 1e3 / reps
    return out


def _serving_rank(label: str, tp: int, sp: int, max_tokens: int, engine_kw: dict,
                  preset="llama3-8b", forced_tool: bool = False) -> dict:
    """One rank of a parallel serving phase (a spawned process). Every rank
    builds its engine (its slices of llama3-8b from seed 0), computes the
    first-step logits, zeroes the walk counters just before its engine
    starts and reads them just after it stops. Rank 0 serves the HTTP
    traffic; the others run the loop on its frames. ``forced_tool`` adds a
    request whose tool_choice forces a call to get_weather."""
    import torch

    from agentcontrolplane_tpu_torch.engine.engine import Engine, SamplingParams
    from agentcontrolplane_tpu_torch.ops.cuda import paged_attention as pa
    from agentcontrolplane_tpu_torch.parallel.distributed import runtime_info
    from agentcontrolplane_tpu_torch.parallel.mesh import serving_group
    from agentcontrolplane_tpu_torch.server.rest import make_server, serve_in_thread

    info = runtime_info()
    group = serving_group(tp, sp)
    dev = torch.device(info["device"])
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    engine = Engine(preset, device=dev, seed=0, group=group, max_slots=8, max_ctx=2048,
                    page_size=16, decode_block_size=8, **engine_kw)
    torch.cuda.synchronize(dev)
    doc = {"rank": group.rank, "n_layers": engine.config.n_layers, "tp_rank": group.tp_rank, "sp_rank": group.sp_rank,
           "backend": info["backend"], "device": info["device"],
           "init_s": time.monotonic() - t0, "init_peak_bytes": torch.cuda.max_memory_allocated(dev),
           "weight_bytes": engine.weight_bytes, "pool_bytes": engine.pool_bytes,
           "pool_shape": list(engine.cache["k"].shape)}
    logits = first_step_logits(engine.params, engine.config, group, dev, engine.quantize_kv)
    if group.is_leader:
        doc["first_step_logits"] = logits
    # the counted run: counts to 0 just before the engine starts
    pa.LAUNCHES = pa.INT8_LAUNCHES = pa.STATE_LAUNCHES = 0
    group.collective_calls = 0
    engine.start()
    if group.is_leader:
        server = make_server(engine, "127.0.0.1", 0)
        serve_in_thread(server)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            def chat(i, temperature=0.0, top_p=None):
                body = {"model": "llama3-8b", "max_tokens": max_tokens,
                        "temperature": temperature,
                        "messages": [{"role": "system", "content": "You are a helpful agent."},
                                     {"role": "user",
                                      "content": f"Request {i}: plan the next step."}]}
                if top_p is not None:
                    body["top_p"] = top_p
                return _post(base, body)

            _check_reply(*chat("warm-up"), max_tokens, f"{label} warm-up")
            replies: dict = {}
            threads = [threading.Thread(target=lambda i=i: replies.__setitem__(i, chat(i)))
                       for i in range(4)]
            steps0 = engine.decode_steps
            for t in threads:
                t.start()
            deadline = time.monotonic() + 300
            while engine.decode_steps == steps0 and time.monotonic() < deadline:
                time.sleep(0.001)
            late = threading.Thread(
                target=lambda: replies.__setitem__("sampled", chat("late", 0.7, 0.9)))
            late.start()
            for t in [*threads, late]:
                t.join(timeout=600)
            if len(replies) != 5:
                raise RuntimeError(f"{len(replies)} of 5 replies arrived")
            doc["completion_tokens"] = [
                _check_reply(*replies[k], max_tokens, f"{label} request {k}") for k in replies]
            if forced_tool:  # raises in this rank when the reply is not the call
                body = {"model": "llama3-8b", "max_tokens": max_tokens, "tools": TOOLS,
                        "tool_choice": _force("get_weather"),
                        "messages": [{"role": "user", "content": "Weather in Paris?"}]}
                doc["forced_call"] = _forced_call(*_post(base, body), "get_weather")

            def batch(n):
                with engine.hold_admission():
                    futs = [engine.submit(f"Task {i}: summarize the incident report.",
                                          SamplingParams(max_tokens=max_tokens))
                            for i in range(n)]
                    s0 = engine.decode_steps
                res = [f.result(timeout=600) for f in futs]
                return res, engine.decode_steps - s0

            run_a, _ = batch(4)
            run_b, steps_b = batch(4)
            doc["repeat_identical"] = [r.tokens for r in run_a] == [r.tokens for r in run_b]
            decode_ms = max(r.latency_ms for r in run_b) - max(r.ttft_ms for r in run_b)
            doc["batch4"] = {
                "ttft_ms_mean": sum(r.ttft_ms for r in run_b) / len(run_b),
                "decode_steps": steps_b,
                "ms_per_decode_step": decode_ms / steps_b if steps_b else None,
                "decode_tokens_per_s": (sum(max(0, len(r.tokens) - 1) for r in run_b)
                                        / (decode_ms / 1e3)) if decode_ms > 0 else None,
            }
            stats = engine.stats()
            doc["stats_mesh"] = stats["mesh"]
            doc["pages_released"] = _pool_whole(engine)
        finally:
            server.shutdown()
            server.server_close()
            engine.stop()
    elif not engine.join(timeout=900):
        raise RuntimeError("follower engine did not stop with the leader")
    torch.cuda.synchronize(dev)
    doc.update(launches=pa.LAUNCHES, int8_launches=pa.INT8_LAUNCHES,
               state_launches=pa.STATE_LAUNCHES, decode_steps=engine.decode_steps,
               engine_collective_calls=group.collective_calls,
               finished=list(engine.finished), peak_bytes=torch.cuda.max_memory_allocated(dev))
    doc["collectives"] = collective_replay_ms(group, engine.config)
    return doc


def parallel_serving_phase(card: str, label: str, tp: int, sp: int, ref_logits,
                           max_tokens: int = 32, preset="llama3-8b", forced_tool: bool = False,
                           **engine_kw) -> dict:
    """llama3-8b served over tp x sp ranks sharing this machine's card(s),
    behind rank 0's HTTP server. Checks: every rank's stream of finished
    requests identical, pages released, greedy repeats identical, every
    decode layer of every step through the expected walk and form on every
    rank, first-step logits against the single card's within
    MAX_LOGIT_REL_L2."""
    import torch

    from agentcontrolplane_tpu_torch.parallel.distributed import run_ranks

    world = tp * sp
    t0 = time.monotonic()
    try:
        ranks = run_ranks(_serving_rank, world,
                          args=(label, tp, sp, max_tokens, engine_kw, preset, forced_tool),
                          timeout_s=600)
    except RuntimeError as e:
        fail(f"parallel {label}: {e}")
    wall_s = time.monotonic() - t0
    lead = ranks[0]
    shared = f"{world} ranks sharing one card" if lead["device"] == ranks[-1]["device"] \
        else f"{world} ranks, one card each"
    int8_walk = bool(engine_kw.get("quantize_kv"))
    steps, n_layers = lead["decode_steps"], lead["n_layers"]
    for r in ranks:
        if r["finished"] != lead["finished"] or r["decode_steps"] != steps:
            fail(f"parallel {label}: rank {r['rank']}'s token streams or decode steps differ "
                 "from rank 0's")
        want = n_layers * steps
        walk = r["int8_launches"] if int8_walk else r["launches"] - r["int8_launches"]
        other = r["launches"] - walk
        state = r["state_launches"]
        if steps == 0 or walk != want or other or state != (want if sp > 1 else 0):
            fail(f"parallel {label}: rank {r['rank']} ran {walk} {'int8' if int8_walk else 'bf16'}"
                 f"-walk launches ({state} in the state form, {other} of the other walk) for "
                 f"{steps} decode steps x {n_layers} layers")
    if not lead["repeat_identical"] or not lead["pages_released"]:
        fail(f"parallel {label}: repeat identical {lead['repeat_identical']}, pages released "
             f"{lead['pages_released']}")
    want_mesh = {"sp": sp, "tp": tp} if sp > 1 else {"tp": tp}
    if lead["stats_mesh"] != want_mesh:
        fail(f"parallel {label}: stats mesh {lead['stats_mesh']} != {want_mesh}")
    lg = lead.pop("first_step_logits")
    rel = ((lg - ref_logits).norm() / ref_logits.norm()).item()
    max_abs = (lg - ref_logits).abs().max().item()
    cos = torch.nn.functional.cosine_similarity(lg, ref_logits, dim=-1).tolist()
    same_argmax = (lg.argmax(-1) == ref_logits.argmax(-1)).tolist()
    if not torch.isfinite(lg).all() or rel > MAX_LOGIT_REL_L2:
        fail(f"parallel {label}: first-step logits vs one card: relative L2 {rel:.3e} > "
             f"{MAX_LOGIT_REL_L2} (max |d| {max_abs:.3e})")
    if forced_tool:
        say(f"parallel {label}: a forced tool_choice request answered get_weather("
            f"{lead['forced_call']}), its stream identical on every rank  [{card}]")
    b, c = lead["batch4"], lead["collectives"]
    model = preset if isinstance(preset, str) else f"a {preset.dim}-wide model"
    say(f"parallel {label} ({shared}, backend {lead['backend']}): {world} ranks x {model}, "
        f"5 chat completions OK ({lead['completion_tokens']} tokens), streams identical on "
        f"every rank, {steps} decode steps, per rank {lead['launches']} walk launches "
        f"({lead['state_launches']} state form, {lead['int8_launches']} int8) = {n_layers} x {steps}; "
        f"first-step logits vs one card: rel L2 {rel:.3e} (tol {MAX_LOGIT_REL_L2}), max |d| "
        f"{max_abs:.3e}, cosine {cos}, same argmax {same_argmax}  [{card}]")
    say(f"parallel {label} ({shared}): {b['ms_per_decode_step']:.2f} ms per decode step at 4 "
        f"slots, {b['decode_tokens_per_s']:.1f} decode tokens/s, TTFT mean "
        f"{b['ttft_ms_mean']:.1f} ms; collectives {c['calls_per_step']} per step, "
        f"{c['ms_per_step']:.2f} ms per step replayed alone (synchronized; staged through the "
        f"host by hand {c['host_staged_ms_per_step']:.2f} ms); "
        f"per rank weights {lead['weight_bytes'] / 1e9:.3f} GB, pool "
        f"{lead['pool_bytes'] / 1e9:.3f} GB {lead['pool_shape']}, peak "
        + ", ".join(f"{r['peak_bytes'] / 1e9:.2f}" for r in ranks)
        + f" GB; phase wall {wall_s:.1f} s  [{card}]")
    return {"card": card, "label": label, "tp": tp, "sp": sp, "ranks_sharing_card": shared,
            "wall_s": wall_s, "logits_rel_l2": rel, "logits_max_abs": max_abs,
            "logits_cosine": cos, "logits_same_argmax": same_argmax,
            "ranks": [{k: v for k, v in r.items() if k != "finished"} for r in ranks]}


# -- quick-start phase ------------------------------------------------------

# the README's quick start over provider: tpu applies
# examples/gpu-quickstart.yaml; beside it the smoke's own manifest: a plain
# Agent, an Agent whose LLM forces the MCP echo tool, served behind an
# approval channel (as examples/mcp-and-approval.yaml sets it up), and an
# Agent whose LLM forces the human-contact tool
QUICKSTART_YAML = """\
# Written by chip_smoke.py: the quick start over provider: tpu.
kind: Secret
metadata:
  name: smoke-hl-key
spec:
  data:
    api-key: "local"
---
kind: ContactChannel
metadata:
  name: oncall
spec:
  type: email
  apiKeyFrom:
    name: smoke-hl-key
    key: api-key
  email:
    address: "oncall@example.com"
    contextAboutUser: "The on-call engineer who approves tool use"
---
kind: MCPServer
metadata:
  name: echotool
spec:
  transport: stdio
  command: {python}
  args: [{echo_server}]
  approvalContactChannel: oncall
  resources:
    limits:
      memory: 1Gi
---
kind: LLM
metadata:
  name: llama3-tpu
spec:
  provider: tpu
  parameters:
    model: llama3-8b
    temperature: 0
    maxTokens: 16
  tpu:
    preset: llama3-8b
    requestTimeoutSeconds: 120
---
kind: LLM
metadata:
  name: llama3-tpu-echo
spec:
  provider: tpu
  parameters:
    model: llama3-8b
    temperature: 0
    maxTokens: 32
  tpu:
    preset: llama3-8b
    requestTimeoutSeconds: 120
  providerConfig: {{tool_choice: echotool__echo}}
---
kind: LLM
metadata:
  name: llama3-tpu-ask
spec:
  provider: tpu
  parameters:
    model: llama3-8b
    temperature: 0
    maxTokens: 32
  tpu:
    preset: llama3-8b
    requestTimeoutSeconds: 120
  providerConfig:
    tool_choice: oncall__human_contact_email
---
kind: Agent
metadata:
  name: my-assistant
spec:
  llmRef:
    name: llama3-tpu
  system: |
    You are a helpful assistant running on one GPU.
---
kind: Agent
metadata:
  name: echoer
spec:
  llmRef:
    name: llama3-tpu-echo
  system: "Use the echo tool."
  mcpServers:
    - name: echotool
---
kind: Agent
metadata:
  name: asker
spec:
  llmRef:
    name: llama3-tpu-ask
  system: "Ask the on-call engineer first."
  humanContactChannels:
    - name: oncall
"""
QUICKSTART_AGENTS = ("gpu-assistant", "gpu-echoer", "my-assistant", "echoer", "asker")
QUICKSTART_EXAMPLE = ROOT / "examples" / "gpu-quickstart.yaml"  # the README's manifest
QUICKSTART_ANSWER = "yes, go ahead"


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(base: str, path: str, token: str = "") -> tuple[int, object]:
    req = urllib.request.Request(base + path,
                                 headers={"Authorization": f"Bearer {token}"} if token else {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            raw, ctype = r.read().decode(), r.headers.get_content_type()
            status = r.status
    except urllib.error.HTTPError as e:
        raw, ctype, status = e.read().decode(), e.headers.get_content_type(), e.code
    return status, json.loads(raw) if ctype == "application/json" else raw


class _Operator:
    """One ``run --tpu-preset llama3-8b --tpu-slots 8`` operator subprocess
    of the quick start (its own bf16 engine, a sqlite store, a bearer
    token; its log under the output directory) and the port's CLI driving
    it from this process (``main([...])`` with ``--server`` and
    ``--token``)."""

    def __init__(self, layout: str, extra: list, tmp: Path, token: str, port: int):
        import os

        self.layout, self.token = layout, token
        self.base = f"http://127.0.0.1:{port}"
        self.log_path = ROOT / "chiprun_out" / f"quickstart_run_{layout}.log"
        self.log = open(self.log_path, "w")
        env = dict(os.environ, ACP_TPU_LOG_LEVEL="WARNING", PYTHONUNBUFFERED="1")
        env.pop("ACP_API_TOKEN", None)
        self.t_start = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "agentcontrolplane_tpu_torch", "run",
             "--tpu-preset", "llama3-8b", "--tpu-slots", "8", "--tpu-ctx", "2048", *extra,
             "--db", str(tmp / f"acp-{layout}.db"), "--port", str(port), "--api-token", token],
            cwd=str(ROOT), env=env, stdout=self.log, stderr=subprocess.STDOUT)

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)
        self.log.close()

    def failed(self, msg: str) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)
        self.log.flush()
        tail = self.log_path.read_text()[-3000:]
        fail(f"quick start ({self.layout}): {msg}; the operator's log ends:\n{tail}")

    def cli(self, *argv, stdin: str | None = None) -> tuple[int, str, str]:
        import contextlib
        import io

        from agentcontrolplane_tpu_torch.cli import main as cli_main

        out, err = io.StringIO(), io.StringIO()
        saved = sys.stdin
        if stdin is not None:
            sys.stdin = io.StringIO(stdin)
        try:
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = cli_main(["--server", self.base, "--token", self.token, *argv])
        except SystemExit as e:
            rc = e.code
        finally:
            sys.stdin = saved
        return rc, out.getvalue(), err.getvalue()

    def api(self, path: str):
        return _get(self.base, path, self.token)

    def wait(self, pred, what: str, timeout: float = 120.0, poll: float = 0.02):
        deadline = time.monotonic() + timeout
        while True:
            got = pred()
            if got:
                return got
            if self.proc.poll() is not None:
                self.failed(f"the operator exited with {self.proc.returncode} waiting for {what}")
            if time.monotonic() > deadline:
                self.failed(f"timed out waiting for {what}")
            time.sleep(poll)

    def wait_ready(self) -> tuple[float, dict]:
        """Seconds from the start to /readyz, and /v1/engine then."""
        def ready():
            try:
                return _get(self.base, "/readyz")[0] == 200
            except OSError:
                return False
        self.wait(ready, "/readyz", timeout=600, poll=0.2)
        ready_s = time.monotonic() - self.t_start
        st, eng = self.api("/v1/engine")
        if st != 200 or not eng.get("configured"):
            self.failed(f"/v1/engine before the drive: {st} {eng}")
        return ready_s, eng

    def apply(self, manifest: Path) -> float:
        """``apply -f`` of the README's example and the smoke's manifest, then
        ``get`` until every Agent is Ready: ms."""
        from agentcontrolplane_tpu_torch.api.yamlsubset import load_all

        t0 = time.monotonic()
        for path, n in ((QUICKSTART_EXAMPLE, 6), (manifest, 9)):
            rc, text, err = self.cli("apply", "-f", str(path))
            if rc != 0 or text.count(" created") != n:
                self.failed(f"apply -f {path.name}: rc {rc}, {text!r} {err!r}")

        def agents_ready():
            rc, table, err = self.cli("get", "Agent")
            rows = {ln.split()[0]: ln.split()[1:2] for ln in table.splitlines()[1:] if ln}
            return rc == 0 and all(rows.get(a) == ["Ready"] for a in QUICKSTART_AGENTS)
        self.wait(agents_ready, "the three Agents Ready", poll=0.1)
        apply_ready_ms = (time.monotonic() - t0) * 1e3
        rc, text, err = self.cli("get", "LLM", "llama3-tpu", "-o", "yaml")
        docs = load_all(text) if rc == 0 else []
        if not docs or not (docs[0].get("status") or {}).get("ready"):
            self.failed(f"get LLM llama3-tpu -o yaml: rc {rc}, {text[:400]!r} {err!r}")
        return apply_ready_ms

    def tasks(self) -> dict:
        """Tasks to FinalAnswer through ``task create --follow``, the
        README's (up to 256 tokens) and the smoke's plain Agent's (16), each
        then shown: ms per Agent."""
        final_ms = {}
        for agent, message in (("gpu-assistant", "What's the capital of France?"),
                               ("my-assistant", "Say hello in one line.")):
            t0 = time.monotonic()
            rc, text, err = self.cli("task", "create", agent, message, "--follow")
            final_ms[agent] = (time.monotonic() - t0) * 1e3
            if rc != 0 or "phase: FinalAnswer" not in text:
                self.failed(f"task create {agent} --follow: rc {rc}, {text!r} {err!r}")
            task_name = text.split()[0].split("/", 1)[1]
            rc, shown, err = self.cli("task", "show", task_name)
            if rc != 0 or "[SYSTEM]" not in shown or "[USER]" not in shown \
                    or "[ASSISTANT]" not in shown:
                self.failed(f"task show {task_name}: rc {rc}, {shown!r} {err!r}")
        return final_ms

    def chat(self) -> None:
        rc, chat_out, chat_err = self.cli("chat", "--max-tokens", "8", "--temperature", "0",
                                          stdin="Hello there.\n")
        if rc != 0 or chat_err or not chat_out.startswith("chatting with the engine"):
            self.failed(f"chat: rc {rc}, {chat_out!r} {chat_err!r}")

    def stop(self) -> float:
        """SIGTERM, then exit code 0: seconds."""
        import signal

        t0 = time.monotonic()
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(90)
        except subprocess.TimeoutExpired:
            self.failed("the operator did not exit within 90 s of SIGTERM")
        if rc != 0:
            self.failed(f"the operator exited with {rc} after SIGTERM")
        return time.monotonic() - t0


def quickstart_phase(card: str) -> dict:
    """The README's quick start through the port's own entry points: ``python
    -m agentcontrolplane_tpu_torch run --tpu-preset llama3-8b`` as a
    subprocess on ``run``'s default slot layout, driven by the port's CLI in
    this process: ``apply -f`` of a YAML manifest, ``get``, ``task create
    --follow`` to FinalAnswer, ``task show``, an approval and a human contact
    answered through ``approvals approve`` and ``contacts respond``,
    ``delete`` of the forced Tasks, ``events``, ``chat``, the REST routes
    (``/v1/models``, ``/metrics``, ``/v1/engine``, a 401), then SIGTERM and
    exit code 0; its walk launches must stay 0. Beside it, started at the
    same time, ``run --tpu-kv-layout paged`` serves the same manifests, both
    Tasks to FinalAnswer and a chat, and every decode step of that process
    must go through the bf16 walk (launches = n_layers x decode steps, int8
    0). Each subprocess's decode steps and walk launches are read from its
    ``/v1/engine`` before and after its drive."""
    import os
    import tempfile

    import torch

    from agentcontrolplane_tpu_torch.api.yamlsubset import load_all

    gc.collect()
    torch.cuda.empty_cache()
    free0, total = torch.cuda.mem_get_info()
    parent_reserved = torch.cuda.memory_reserved()
    say(f"quick start: before the subprocesses, {free0 / 1e9:.2f} of {total / 1e9:.2f} GB free "
        f"on the card, this process holds {parent_reserved / 1e9:.3f} GB reserved by torch "
        f"(plus its CUDA context)  [{card}]")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    token = "quickstart-" + os.urandom(8).hex()
    port = _free_port()
    port_paged = _free_port()
    while port_paged == port:
        port_paged = _free_port()
    t_phase = time.monotonic()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        manifest = Path(tmp) / "quickstart.yaml"
        manifest.write_text(QUICKSTART_YAML.format(python=sys.executable,
                                                   echo_server=ECHO_SERVER))
        op = _Operator("slot", [], Path(tmp), token, port)
        paged = _Operator("paged", ["--tpu-kv-layout", "paged"], Path(tmp), token, port_paged)
        try:
            # 1. start: each subprocess builds its own engine, then serves REST
            ready_s, eng0 = op.wait_ready()
            paged_ready_s, paged_eng0 = paged.wait_ready()
            free1, _ = torch.cuda.mem_get_info()
            say(f"quick start: `run --tpu-preset llama3-8b` -> /readyz in {ready_s:.2f} s "
                f"({eng0['kv_layout']}), with `--tpu-kv-layout paged` beside it in "
                f"{paged_ready_s:.2f} s ({paged_eng0['kv_layout']}); the two operator processes "
                f"hold {(free0 - free1) / 1e9:.2f} GB of the card "
                f"({eng0['model']['weight_bytes'] / 1e9:.3f} GB of bf16 weights each, "
                f"{eng0['rank']['pool_bytes'] / 1e9:.3f} GB of slot KV cache, "
                f"{paged_eng0['rank']['pool_bytes'] / 1e9:.3f} GB of KV pool); "
                f"{free1 / 1e9:.2f} GB left free  [{card}]")

            # 2. apply the README's example and a YAML manifest of the
            # smoke's, then get until the Agents are Ready
            apply_ready_ms = op.apply(manifest)
            n_docs = len(load_all(QUICKSTART_EXAMPLE.read_text())) + len(
                load_all(manifest.read_text()))
            say(f"quick start: apply -f examples/{QUICKSTART_EXAMPLE.name} and the smoke's "
                f"manifest ({n_docs} YAML documents) -> every Agent Ready in "
                f"{apply_ready_ms:.1f} ms (get Agent polled)  [{card}]")

            # 3. Tasks to FinalAnswer through task create --follow
            final_ms = op.tasks()
            say("quick start: task create --follow -> FinalAnswer in "
                + ", ".join(f"{v:.1f} ms ({k})" for k, v in final_ms.items())
                + f" (0.5 s polls); task show OK  [{card}]")

            def toolcalls(task: str) -> list:
                st, docs = op.api(f"/v1/resources/ToolCall?labelSelector=acp.tpu/task={task}")
                return docs if st == 200 else []

            # 4a. the approval: echo__echo behind the approvals channel
            rc, text, err = op.cli("task", "create", "echoer", "Echo the word hello.")
            if rc != 0:
                op.failed(f"task create echoer: rc {rc} {err!r}")
            echo_task = text.split()[0].split("/", 1)[1]

            def pending(route: str, command: str):
                """The first pending call id that ``command`` lists (its
                table runs a long id into the next column, so the id is
                read from the route)."""
                st, rows = op.api(route)
                if st != 200 or not rows:
                    return None
                rc, table, err = op.cli(command)
                return rows[0]["callId"] if rc == 0 and rows[0]["callId"] in table else None
            call_id = op.wait(lambda: pending("/v1/approvals", "approvals"), "a pending approval",
                              poll=0.1)
            tcs = toolcalls(echo_task)
            if not any((tc.get("status") or {}).get("phase") == "AwaitingHumanApproval"
                       for tc in tcs):
                op.failed(f"no ToolCall of {echo_task} AwaitingHumanApproval: {tcs}")
            t0 = time.monotonic()
            rc, text, err = op.cli("approvals", "approve", call_id, "--comment", "ok")
            if rc != 0:
                op.failed(f"approvals approve {call_id}: rc {rc}, {text!r} {err!r}")
            succeeded = op.wait(lambda: [tc for tc in toolcalls(echo_task)
                                         if (tc.get("status") or {}).get("phase") == "Succeeded"],
                                "the approved ToolCall Succeeded")
            approve_ms = (time.monotonic() - t0) * 1e3
            echo_result = succeeded[0]["status"].get("result", "")
            if not echo_result.startswith("echo: "):
                op.failed(f"the approved echo ToolCall's result: {echo_result!r}")

            # 4b. the human contact, answered through contacts respond
            rc, text, err = op.cli("task", "create", "asker", "Check the deploy with a human.")
            if rc != 0:
                op.failed(f"task create asker: rc {rc} {err!r}")
            ask_task = text.split()[0].split("/", 1)[1]

            contact_id = op.wait(lambda: pending("/v1/contacts", "contacts"),
                                 "a pending human contact", poll=0.1)
            if not any((tc.get("status") or {}).get("phase") == "AwaitingHumanInput"
                       for tc in toolcalls(ask_task)):
                op.failed(f"no ToolCall of {ask_task} AwaitingHumanInput")
            t0 = time.monotonic()
            rc, text, err = op.cli("contacts", "respond", contact_id, QUICKSTART_ANSWER)
            if rc != 0:
                op.failed(f"contacts respond {contact_id}: rc {rc}, {text!r} {err!r}")

            def answer_joined():
                st, t = op.api(f"/v1/tasks/{ask_task}")
                return st == 200 and any(m.get("role") == "tool"
                                         and m.get("content") == QUICKSTART_ANSWER
                                         for m in t["contextWindow"])
            op.wait(answer_joined, "the human's answer in the Task's window")
            respond_ms = (time.monotonic() - t0) * 1e3
            # forced Tasks never end with random weights: take them away
            for name in (echo_task, ask_task):
                rc, text, err = op.cli("delete", "Task", name)
                if rc != 0:
                    op.failed(f"delete Task {name}: rc {rc}, {text!r} {err!r}")
            say(f"quick start: approvals approve -> echo ToolCall Succeeded in {approve_ms:.1f} "
                f"ms; contacts respond -> answer in the Task's window in {respond_ms:.1f} ms; "
                f"both forced Tasks deleted  [{card}]")

            # 5. the other routes
            rc, events, err = op.cli("events")
            if rc != 0 or not events.strip():
                op.failed(f"events: rc {rc} {err!r}")
            st, models = op.api("/v1/models")
            ids = {m["id"]: m for m in models["data"]} if st == 200 else {}
            if "tpu" not in ids or not all(ids.get(n, {}).get("ready") for n in (
                    "llama3-tpu", "llama3-tpu-echo", "llama3-tpu-ask")):
                op.failed(f"/v1/models: {st} {models}")
            st, metrics = op.api("/metrics")
            if st != 200 or 'acp_objects{kind="Task",phase="' not in metrics \
                    or "acp_engine_active_slots" not in metrics:
                op.failed(f"/metrics lacks the Task phase gauges or the engine's: {st}")
            task_gauges = [ln for ln in metrics.splitlines()
                           if ln.startswith('acp_objects{kind="Task"')]
            st, anon = _get(op.base, "/v1/tasks")
            if st != 401:
                op.failed(f"/v1/tasks without the token answered {st}, not 401")
            op.chat()
            st, eng1 = op.api("/v1/engine")
            if st != 200:
                op.failed(f"/v1/engine after the drive: {st}")
            steps = eng1["decode_steps"] - eng0["decode_steps"]
            launches = eng1["walk_launches"]["total"] - eng0["walk_launches"]["total"]
            n_layers = eng1["model"]["layers"]
            # the quick start serves run's default layout, the reference's
            # slot rows: plain torch attention, so the walk never launches
            if eng1.get("kv_layout") != "slot" or steps <= 0 \
                    or eng1["walk_launches"]["total"] != 0:
                op.failed(f"layout {eng1.get('kv_layout')}, {steps} decode steps, walk "
                          f"launches {eng1['walk_launches']['total']} since the start (want "
                          f"slot, > 0 steps, 0 launches)")
            overlap = eng1.get("tool_overlap", {})
            say(f"quick start: the operator process's engine parked {overlap.get('parks')} "
                f"slots, {overlap.get('park_adoptions')} adopted by a next turn  [{card}]")
            say(f"quick start: events {len(events.splitlines())} lines; /v1/models "
                f"{sorted(ids)}; /metrics {task_gauges}; no token -> 401; chat OK; the operator "
                f"process served the {eng1['kv_layout']} layout ({n_layers} layers): "
                f"{steps} decode steps during the drive and {launches} walk launches, "
                f"{eng1['walk_launches']['total']} since it started  [{card}]")

            # 6. stop: SIGTERM, exit code 0
            stop_s = op.stop()

            # 7. run --tpu-kv-layout paged: the same manifests, both Tasks
            # to FinalAnswer and a chat, every decode step on the bf16 walk
            paged_apply_ms = paged.apply(manifest)
            paged_final_ms = paged.tasks()
            paged.chat()
            st, paged_eng1 = paged.api("/v1/engine")
            if st != 200:
                paged.failed(f"/v1/engine after the drive: {st}")
            paged_steps = paged_eng1["decode_steps"] - paged_eng0["decode_steps"]
            paged_launches = (paged_eng1["walk_launches"]["total"]
                              - paged_eng0["walk_launches"]["total"])
            paged_int8 = (paged_eng1["walk_launches"]["int8"]
                          - paged_eng0["walk_launches"]["int8"])
            if paged_eng1.get("kv_layout") != "paged" or paged_steps <= 0 \
                    or paged_launches != n_layers * paged_steps or paged_int8 != 0:
                paged.failed(f"layout {paged_eng1.get('kv_layout')}, walk launches "
                             f"{paged_launches} (int8 {paged_int8}) != {n_layers} x "
                             f"{paged_steps} decode steps")
            paged_stop_s = paged.stop()
            say(f"quick start: `run --tpu-kv-layout paged`: every Agent Ready in "
                f"{paged_apply_ms:.1f} ms, FinalAnswer in "
                + ", ".join(f"{v:.1f} ms ({k})" for k, v in paged_final_ms.items())
                + f", chat OK; {paged_steps} decode steps and {paged_launches} walk launches "
                f"(= {n_layers} x {paged_steps}, bf16 walk) during the drive; SIGTERM -> exit 0 "
                f"in {paged_stop_s:.2f} s  [{card}]")
        finally:
            op.close()
            paged.close()
    phase_s = time.monotonic() - t_phase
    say(f"quick start: SIGTERM -> exit 0 in {stop_s:.2f} s; phase {phase_s:.1f} s  [{card}]")
    return {"card": card, "ready_s": ready_s, "apply_ready_ms": apply_ready_ms,
            "final_answer_ms": final_ms, "approve_ms": approve_ms, "respond_ms": respond_ms,
            "decode_steps": steps, "walk_launches": launches,
            "walk_launches_since_start": eng1["walk_launches"]["total"],
            "parks": eng1.get("tool_overlap", {}).get("parks"),
            "park_adoptions": eng1.get("tool_overlap", {}).get("park_adoptions"),
            "paged": {"ready_s": paged_ready_s, "apply_ready_ms": paged_apply_ms,
                      "final_answer_ms": paged_final_ms, "decode_steps": paged_steps,
                      "walk_launches": paged_launches, "stop_s": paged_stop_s},
            "card_bytes_free_before": free0, "card_bytes_free_after_start": free1,
            "parent_reserved_bytes": parent_reserved, "task_gauges": task_gauges,
            "stop_s": stop_s, "phase_s": phase_s}


def _ptxas_summary(logs: dict) -> dict:
    """Per library: registers and spill bytes of every kernel instantiation
    from ``-Xptxas -v``, keyed by the mangled name."""
    out: dict = {}
    for lib, text in logs.items():
        kernels: dict = {}
        current = None
        for line in text.splitlines():
            if "Compiling entry function" in line:
                current = line.split("'")[1] if "'" in line else line
                kernels[current] = {}
            elif current and "spill stores" in line:
                nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
                kernels[current]["spill_bytes"] = sum(nums[1:]) if len(nums) >= 3 else nums
            elif current and "Used" in line and "registers" in line:
                kernels[current]["registers"] = int(line.split("Used")[1].split()[0])
        out[lib] = kernels
    return out


def host_kv_only(card: str) -> dict:
    """``--host-kv-only``: the preemption group and the host-KV phase on a
    bf16 and then an int8 llama3-8b engine, one at a time."""
    import torch

    from agentcontrolplane_tpu_torch.engine.engine import Engine

    out = {}
    for label, kw in (("bf16", {}), ("int8", dict(quantize_weights=True, quantize_kv=True))):
        engine = Engine("llama3-8b", device="cuda", seed=0, max_slots=8, max_ctx=2048,
                        page_size=16, decode_block_size=8, **kw)
        engine.start()
        try:
            pre = preemption_check(engine, card, label)
            out[label] = {"preemption": pre, "host_kv": host_kv_phase(engine, card, label, pre)}
        finally:
            engine.stop()
            del engine
            gc.collect()
            torch.cuda.empty_cache()
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke runs only on a CUDA card")
    sys.path.insert(0, str(ROOT))
    try:
        from agentcontrolplane_tpu_torch.ops.cuda import build
    except ImportError as e:
        fail(f"the agentcontrolplane_tpu_torch package is not beside this script: {e}")
    kernels_only = "--kernels-only" in sys.argv[1:]
    t_start = time.monotonic()
    card = card_line()
    say(f"card: {card}")
    say(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.monotonic()
    logs = build.build_all()
    build_s = time.monotonic() - t0
    say(f"build: {len(logs)} of {len(build.SOURCES)} libraries compiled in {build_s:.1f} s")
    ptxas = _ptxas_summary(logs)
    for lib, kernels in ptxas.items():
        regs = [k.get("registers", 0) for k in kernels.values()]
        spills = {n: k["spill_bytes"] for n, k in kernels.items() if k.get("spill_bytes")}
        # the llama3-8b instantiation: bf16 q, head_dim 128, group of 4
        main_regs = [k.get("registers") for n, k in kernels.items()
                     if "nv_bfloat16" in n and "Li128ELi4E" in n]
        say(f"  {lib}: {len(kernels)} kernels, registers {min(regs, default=0)}-"
            f"{max(regs, default=0)}, llama3-8b variant {main_regs}, spills "
            f"{spills if spills else 'none'}")
        main_spills = {n: b for n, b in spills.items() if "nv_bfloat16" in n and "Li128ELi4E" in n}
        if main_spills:
            fail(f"{lib}: the llama3-8b variant spills: {main_spills}")

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    walls = {"build": build_s}  # wall seconds of each phase

    def timed(name, fn, *args, **kw):
        t0 = time.monotonic()
        out = fn(*args, **kw)
        walls[name] = time.monotonic() - t0
        return out

    if "--host-kv-only" in sys.argv[1:]:
        model = timed("model", model_phase)
        host = timed("host_kv", host_kv_only, card)
        (out_dir / "chip_smoke_host_kv.json").write_text(json.dumps(
            {"card": card, "model": model, "host_kv": host, "walls_s": walls}, indent=1,
            default=str))
        say(f"host kv only: {time.monotonic() - t_start:.1f} s  [{card}]")
        return 0
    kernels = timed("kernels", kernel_phase)
    if kernels_only:
        (out_dir / "chip_smoke_kernels.json").write_text(json.dumps(
            {"card": card, "build_s": build_s, "ptxas": ptxas, "kernels": kernels}, indent=1))
        say(f"kernels only: {time.monotonic() - t_start:.1f} s  [{card}]")
        return 0
    model = timed("model", model_phase)
    perf = timed("serving_bf16", serving_phase, card, "bf16", constrained=True)
    walls["constrained"] = perf["constrained"]["phase_s"]
    walls["kv_reuse_bf16"] = perf["kv_reuse"]["phase_s"]
    walls["host_kv_bf16"] = perf["host_kv"]["phase_s"]
    walls["chunked_bf16"] = perf["chunked"]["phase_s"]
    walls["spec_bf16"] = perf["spec"]["phase_s"]
    walls["control_plane_bf16"] = perf["control_plane"]["phase_s"]
    walls["operator_bf16"] = perf["operator"]["phase_s"]
    walls["observability_bf16"] = perf["observability"]["phase_s"]
    walls["slot_bf16"] = perf["slot"]["phase_s"]
    walls["serving_bf16"] -= (walls["constrained"] + walls["kv_reuse_bf16"]
                              + walls["host_kv_bf16"] + walls["chunked_bf16"] + walls["spec_bf16"]
                              + walls["control_plane_bf16"] + walls["operator_bf16"]
                              + walls["observability_bf16"] + walls["slot_bf16"])
    slot_first = perf["slot"].pop("first")
    gc.collect()
    torch.cuda.empty_cache()
    perf_int8 = timed("serving_int8", serving_phase, card, "int8", slot_ref=slot_first,
                      quantize_weights=True, quantize_kv=True)
    walls["kv_reuse_int8"] = perf_int8["kv_reuse"]["phase_s"]
    walls["host_kv_int8"] = perf_int8["host_kv"]["phase_s"]
    walls["chunked_int8"] = perf_int8["chunked"]["phase_s"]
    walls["spec_int8"] = perf_int8["spec"]["phase_s"]
    walls["control_plane_int8"] = perf_int8["control_plane"]["phase_s"]
    walls["operator_int8"] = perf_int8["operator"]["phase_s"]
    walls["slot_int8"] = perf_int8["slot"]["phase_s"]
    walls["serving_int8"] -= (walls["kv_reuse_int8"] + walls["host_kv_int8"]
                              + walls["chunked_int8"]
                              + walls["spec_int8"] + walls["control_plane_int8"]
                              + walls["operator_int8"] + walls["slot_int8"])
    perf_int8["slot"].pop("first", None)
    say(f"serving int8 vs bf16: weights {perf_int8['weight_bytes'] / 1e9:.3f} / "
        f"{perf['weight_bytes'] / 1e9:.3f} GB, KV pool {perf_int8['pool_bytes'] / 1e9:.3f} / "
        f"{perf['pool_bytes'] / 1e9:.3f} GB for {perf['num_pages']} pages  [{card}]")
    ref_bf16, ref_int8 = perf.pop("first_step_logits"), perf_int8.pop("first_step_logits")
    gc.collect()
    torch.cuda.empty_cache()
    # one phase's ranks at a time; each rank holds its slices only
    par = {
        "tp2_bf16": timed("tp2_bf16", parallel_serving_phase, card, "tp2-bf16", 2, 1, ref_bf16,
                          forced_tool=True),
        # 12 tokens a request on both sp=2 x tp=2 phases: at about 0.47 s a
        # decode step on one shared card, decode sets their wall
        "sp2xtp2_bf16": timed("sp2xtp2_bf16", parallel_serving_phase, card, "sp2xtp2-bf16", 2, 2,
                              ref_bf16, max_tokens=12),
        "sp2xtp2_int8": timed("sp2xtp2_int8", parallel_serving_phase, card, "sp2xtp2-int8", 2, 2,
                              ref_int8, max_tokens=12, quantize_weights=True, quantize_kv=True),
    }
    # the README's quick start, against an operator process of its own
    quickstart = timed("quickstart", quickstart_phase, card)

    docs = []
    for walk, name, source, replaces, serving in (
        ("bf16", "paged_decode_attention", "agentcontrolplane_tpu_torch/csrc/paged_attention.cu",
         "agentcontrolplane_tpu/ops/pallas/paged_attention.py:325", perf),
        ("int8", "paged_decode_attention_int8",
         "agentcontrolplane_tpu_torch/csrc/paged_attention_int8.cu",
         "agentcontrolplane_tpu/ops/pallas/paged_attention.py:82", perf_int8),
    ):
        cases = kernels[walk]
        main_case = next(c for c in cases if c["case"] == "llama3-8b")
        docs.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            # the serving run's and, on bf16, the observability phase's
            "launches": serving["launches"] + serving.get("observability", {}).get("launches", 0),
            "max_abs_err": max(c[f"{m}_max_abs_err"] for c in cases for m, _ in MODES),
            "ms": main_case["cache_plus_new_kernel_ms"],
            "kernel_ms": main_case["cache_plus_new_kernel_ms"],
            "n_split": main_case["n_split"],
            "plain_ms": main_case["cache_plus_new_plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["cache_plus_new_library_ms"],
        })
    for walk, name, source, phase in (
        ("state_bf16", "paged_decode_state", "agentcontrolplane_tpu_torch/csrc/paged_attention.cu",
         par["sp2xtp2_bf16"]),
        ("state_int8", "paged_decode_state_int8",
         "agentcontrolplane_tpu_torch/csrc/paged_attention_int8.cu", par["sp2xtp2_int8"]),
    ):
        cases = kernels[walk]
        main_case = next(c for c in cases if c["case"] == "llama3-8b-sp2xtp2-rank")
        docs.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": "agentcontrolplane_tpu/ops/pallas/paged_attention.py:399",
            "launches": phase["ranks"][0]["state_launches"],
            "max_abs_err": max(max(c["state_max_err"], c["merge_max_abs_err"]) for c in cases),
            "ms": main_case["kernel_ms"],
            "n_split": main_case["n_split"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
        })
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build_s": build_s, "ptxas": ptxas, "kernels": docs,
         "kernel_cases": kernels, "model": model, "serving": perf, "serving_int8": perf_int8,
         "parallel": par, "quickstart": quickstart, "walls_s": walls, "seconds": time.monotonic() - t_start}, indent=1,
        default=str))
    say("phase walls: " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
        + " s (serving phases without the constrained, kv-reuse, host-kv, chunked, spec, "
          "control-plane, operator, observability and slot phases)")
    say(f"total {time.monotonic() - t_start:.1f} s")
    say(f"card: {card}")
    say(json.dumps({"kernels": docs}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
