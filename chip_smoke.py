#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, ``nvcc`` and a
CUDA build of PyTorch. Every phase must pass or the script exits non-zero
without printing a result:

1. card — the card's name and power limit from ``nvidia-smi``;
2. build — every CUDA source under ``agentcontrolplane_tpu_torch/csrc``
   compiled with ``nvcc`` (one process per source, all at once);
3. kernel — both paged decode-attention walks against their plain PyTorch
   versions on the card, both epilogue modes: the f32/bf16 walk at the
   llama3-8b decode shape (8 slots, 32 query / 8 KV heads, head_dim 128,
   pages of 16, bf16, ragged lengths up to 2048 including 0) and edge
   shapes (d=16 f32, d=256 bf16, a group of 7 query heads); the int8 walk
   over pages made on the card by ``kv_quantize`` at the llama3-8b shape,
   the serving lengths, d=16 f32, d=256 with a group of 8, and a case whose
   trash page and masked tail rows hold poisoned values and scales; times
   of each kernel, its plain version and ``scaled_dot_product_attention``
   (a yardstick only) beside the bound;
4. model — the tiny f32 model's paged prefill + decode on the card (kernel)
   against the same on the CPU (plain version), unquantized and with int8
   weights and an int8 KV cache (the int8 walk);
5. serving — llama3-8b at full width and depth with random weights from
   seed 0 behind the HTTP server, first in bf16, then (after the bf16
   engine is freed) with int8 weights and int8 KV pages: five chat
   completions each (four concurrent greedy ones, one sampled that arrives
   mid-decode), with the walk's launch count equal to n_layers x decode
   steps and no launch of the other walk; then a greedy batch run twice
   must give identical tokens, and TTFT / decode rates and a profile.

``--kernels-only`` stops after the kernel phase (a first check of a new
kernel; it prints no result line).

The last two lines are one JSON object describing the kernels and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
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

CASES = [
    # name, dtype, H, H_kv, d, P, max_pages, seq_lens, layers cycled for timing
    ("llama3-8b", "bfloat16", 32, 8, 128, 16, 128, [0, 1, 17, 255, 1024, 1500, 2047, 2048], 4),
    ("llama3-8b-serving-lengths", "bfloat16", 32, 8, 128, 16, 128,
     [61, 64, 70, 77, 85, 90, 96, 110], 4),
    ("tiny-d16-f32", "float32", 4, 2, 16, 8, 8, [0, 5, 16, 27, 64], 1),
    ("d256-group8-bf16", "bfloat16", 8, 1, 256, 16, 16, [0, 33, 128, 256], 1),
    ("d64-group7-f32", "float32", 14, 2, 64, 16, 8, [3, 0, 100, 128], 1),
]
# the int8 walk: pages are kv_quantize of random pools; the poisoned case
# fills the trash page and every row past each slot's seq_len in its last
# page with value 127 and scale 1e30, which must not reach the output
INT8_CASES = [
    ("llama3-8b", "bfloat16", 32, 8, 128, 16, 128, [0, 1, 17, 255, 1024, 1500, 2047, 2048], 4),
    ("llama3-8b-serving-lengths", "bfloat16", 32, 8, 128, 16, 128,
     [61, 64, 70, 77, 85, 90, 96, 110], 4),
    ("tiny-d16-f32", "float32", 4, 2, 16, 8, 8, [0, 5, 16, 27, 64], 1),
    ("d256-group8-bf16", "bfloat16", 8, 1, 256, 16, 16, [0, 33, 128, 256], 1),
    ("llama3-8b-poisoned-tail", "bfloat16", 32, 8, 128, 16, 16, [1, 17, 100, 255, 16, 0, 33, 200], 1),
]
MODES = (("cache_plus_new", True), ("classic", False))


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
    walk = "int8" if int8 else dtype_name
    dev = torch.device("cuda")
    dtype = getattr(torch, dtype_name)
    S = len(seq_lens)
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
             "d": d, "P": P, "max_pages": max_pages, "seq_lens": seq_lens, "tol": tol}
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
        say(f"kernel {walk:8s} {name:28s} {mode:15s} max_abs_err {err:.3e} (tol {tol}) "
            f"kernel {entry[f'{mode}_kernel_ms']:.4f} ms (eager "
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
    say(f"kernel {walk:8s} {name:28s} bound {entry['bound_ms']:.5f} ms ({entry['bound_by']}, "
        f"{nbytes} B)")
    return entry


def kernel_phase() -> dict:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 plain version in full f32
    torch.backends.cudnn.allow_tf32 = False
    results = {"bf16": [], "int8": []}
    for key, cases, int8 in (("bf16", CASES, False), ("int8", INT8_CASES, True)):
        for case in cases:
            results[key].append(run_case(case, int8))
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
    return doc


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
    doc = {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms, "decode_steps": steps,
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


def serving_phase(card: str, label: str, **engine_kw) -> dict:
    """llama3-8b at full width behind the HTTP server. ``engine_kw`` picks
    the int8 knobs; with ``quantize_kv`` the int8 walk must serve every
    decode layer, otherwise the f32/bf16 walk."""
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
        if stats["kv_pages"]["free"] != engine.num_pages - 1 or stats["active_slots"]:
            fail(f"serving {label}: pages or slots not released after the run: {stats}")
        if stats["memory"]["quantized_kv"] != {"enabled": int8_walk, "pages": 0}:
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
        return perf
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()


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

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    kernels = kernel_phase()
    if kernels_only:
        (out_dir / "chip_smoke_kernels.json").write_text(json.dumps(
            {"card": card, "build_s": build_s, "ptxas": ptxas, "kernels": kernels}, indent=1))
        say(f"kernels only: {time.monotonic() - t_start:.1f} s  [{card}]")
        return 0
    model = model_phase()
    perf = serving_phase(card, "bf16")
    gc.collect()
    torch.cuda.empty_cache()
    perf_int8 = serving_phase(card, "int8", quantize_weights=True, quantize_kv=True)
    say(f"serving int8 vs bf16: weights {perf_int8['weight_bytes'] / 1e9:.3f} / "
        f"{perf['weight_bytes'] / 1e9:.3f} GB, KV pool {perf_int8['pool_bytes'] / 1e9:.3f} / "
        f"{perf['pool_bytes'] / 1e9:.3f} GB for {perf['num_pages']} pages  [{card}]")

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
            "launches": serving["launches"],
            "max_abs_err": max(c[f"{m}_max_abs_err"] for c in cases for m, _ in MODES),
            "ms": main_case["cache_plus_new_kernel_ms"],
            "kernel_ms": main_case["cache_plus_new_kernel_ms"],
            "plain_ms": main_case["cache_plus_new_plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["cache_plus_new_library_ms"],
        })
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build_s": build_s, "ptxas": ptxas, "kernels": docs,
         "kernel_cases": kernels, "model": model, "serving": perf, "serving_int8": perf_int8,
         "seconds": time.monotonic() - t_start}, indent=1))
    say(f"total {time.monotonic() - t_start:.1f} s")
    say(f"card: {card}")
    say(json.dumps({"kernels": docs}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
