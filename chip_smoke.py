#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, ``nvcc`` and a
CUDA build of PyTorch. Every phase must pass or the script exits non-zero
without printing a result:

1. card — the card's name and power limit from ``nvidia-smi``;
2. build — every CUDA source under ``agentcontrolplane_tpu_torch/csrc``
   compiled with ``nvcc`` (one process per source, all at once);
3. kernel — the paged decode-attention kernel against its plain PyTorch
   version on the card, both epilogue modes, at the llama3-8b decode shape
   (8 slots, 32 query / 8 KV heads, head_dim 128, pages of 16, bf16, ragged
   lengths up to 2048 including 0) and edge shapes (d=16 f32, d=256 bf16,
   a group of 7 query heads); times of the kernel, the plain version and
   ``scaled_dot_product_attention`` (a yardstick only) beside the bound;
4. model — the tiny f32 model's paged prefill + decode on the card (kernel)
   against the same on the CPU (plain version);
5. serving — llama3-8b at full width and depth with random bf16 weights
   from seed 0 behind the HTTP server: five chat completions (four
   concurrent greedy ones, one sampled that arrives mid-decode), with the
   kernel's launch count equal to n_layers x decode steps; then a greedy
   batch run twice must give identical tokens, and TTFT / decode rates.

The last two lines are one JSON object describing the kernels and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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


def kernel_phase() -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from agentcontrolplane_tpu_torch.ops import paged as plain
    from agentcontrolplane_tpu_torch.ops.cuda import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 plain version in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    results = []
    for name, dtype_name, H, H_kv, d, P, max_pages, seq_lens, n_layers in CASES:
        dtype = getattr(torch, dtype_name)
        S = len(seq_lens)
        num_pages = S * max_pages + 1
        rng = np.random.default_rng(0)
        perm = rng.permutation(np.arange(1, num_pages)).astype(np.int32)
        tables = np.zeros((S, max_pages), np.int32)
        for s, n in enumerate(seq_lens):
            used = -(-n // P)
            tables[s, :used] = perm[s * max_pages : s * max_pages + used]
        g = torch.Generator(device=dev).manual_seed(0)

        def randn(*shape, g=g, dtype=dtype):
            return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)

        q = randn(S, H, d)
        k_pool = randn(n_layers, num_pages, P, H_kv, d)
        v_pool = randn(n_layers, num_pages, P, H_kv, d)
        k_new, v_new = randn(S, H_kv, d), randn(S, H_kv, d)
        bt = torch.from_numpy(tables).to(dev)
        sl = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
        tol = MAX_BF16_ERR if dtype == torch.bfloat16 else MAX_F32_ERR
        entry = {"case": name, "dtype": dtype_name, "S": S, "H": H, "H_kv": H_kv, "d": d,
                 "P": P, "max_pages": max_pages, "seq_lens": seq_lens, "tol": tol}
        for mode, with_self in (("cache_plus_new", True), ("classic", False)):
            extra = (k_new, v_new) if with_self else ()
            kern = (pa.paged_decode_attention_cache_plus_new if with_self
                    else pa.paged_decode_attention)
            ref = (plain.paged_decode_attention_reference_cache_plus_new if with_self
                   else plain.paged_decode_attention_reference)
            out = kern(q, k_pool[0], v_pool[0], bt, sl, *extra)
            torch.cuda.synchronize()
            want = ref(q, k_pool[0], v_pool[0], bt, sl, *extra)
            if not torch.isfinite(out.float()).all():
                fail(f"kernel {name}/{mode}: non-finite output")
            err = (out.float() - want.float()).abs().max().item()
            again = kern(q, k_pool[0], v_pool[0], bt, sl, *extra)
            if not torch.equal(out, again):
                fail(f"kernel {name}/{mode}: two launches on the same inputs differ")
            if err > tol:
                fail(f"kernel {name}/{mode}: max |kernel - plain| = {err:.3e} > {tol}")
            entry[f"{mode}_max_abs_err"] = err
            launch = (lambda i, e=extra, k=kern: k(q, k_pool[i % n_layers], v_pool[i % n_layers],
                                                   bt, sl, *e))
            entry[f"{mode}_kernel_ms"] = graph_ms(launch, 32)
            entry[f"{mode}_eager_ms"] = cuda_ms(launch, 100)
            entry[f"{mode}_plain_ms"] = cuda_ms(
                lambda i, e=extra, r=ref: r(q, k_pool[i % n_layers], v_pool[i % n_layers],
                                            bt, sl, *e), 10, warmup=1)
            say(f"kernel {name:28s} {mode:15s} max_abs_err {err:.3e} (tol {tol}) "
                f"kernel {entry[f'{mode}_kernel_ms']:.4f} ms (eager "
                f"{entry[f'{mode}_eager_ms']:.4f}) plain {entry[f'{mode}_plain_ms']:.4f} ms")
        # yardstick: one SDPA call over the context already gathered and
        # padded (the gather is not timed), the new token as its last key
        L = max(seq_lens) + 1
        kg = torch.zeros(S, H, L, d, device=dev, dtype=dtype)
        vg = torch.zeros_like(kg)
        mask = torch.zeros(S, 1, 1, L, dtype=torch.bool, device=dev)
        for s, n in enumerate(seq_lens):
            rows = torch.arange(n, device=dev)
            pages = bt[s, rows // P].long()
            kg[s, :, :n] = k_pool[0][pages, rows % P].repeat_interleave(H // H_kv, dim=1).transpose(0, 1)
            vg[s, :, :n] = v_pool[0][pages, rows % P].repeat_interleave(H // H_kv, dim=1).transpose(0, 1)
            kg[s, :, n] = k_new[s].repeat_interleave(H // H_kv, dim=0)
            vg[s, :, n] = v_new[s].repeat_interleave(H // H_kv, dim=0)
            mask[s, ..., : n + 1] = True
        q4 = q[:, :, None, :]
        lib = F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask)[:, :, 0]
        ref_new = plain.paged_decode_attention_reference_cache_plus_new(
            q, k_pool[0], v_pool[0], bt, sl, k_new, v_new)
        entry["library_max_abs_err"] = (lib.float() - ref_new.float()).abs().max().item()
        entry["library_ms"] = graph_ms(
            lambda i: F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask), 16)
        # the least time for the cache-plus-new call on these inputs
        esz = torch.finfo(dtype).bits // 8
        rows = sum(seq_lens)
        pages_walked = sum(-(-n // P) for n in seq_lens)
        nbytes = (2 * S * H * d + 2 * S * H_kv * d + 2 * rows * H_kv * d) * esz \
            + 4 * (pages_walked + S)
        flops = 4 * (rows + S) * H * d
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
        entry.update(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                     bound_bytes=nbytes, bound_flops=flops)
        say(f"kernel {name:28s} library (sdpa) {entry['library_ms']:.4f} ms "
            f"bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}, {nbytes} B)")
        results.append(entry)
        del k_pool, v_pool, kg, vg
        torch.cuda.empty_cache()
    return {"cases": results}


# -- model phase ---------------------------------------------------------


def model_phase() -> None:
    """tiny f32: paged prefill + teacher-forced decode on the card (the
    kernel) and on the CPU (its plain version), same weights."""
    import dataclasses

    import torch

    from agentcontrolplane_tpu_torch.engine.weights import random_params
    from agentcontrolplane_tpu_torch.models import llama
    from agentcontrolplane_tpu_torch.ops.cuda import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False  # compare f32 with f32
    cfg = dataclasses.replace(llama.PRESETS["tiny"], vocab_size=512, max_seq_len=256)
    cpu_params = random_params(cfg, 0, "cpu")
    gpu_params = {
        k: ({n: t.cuda() for n, t in v.items()} if k == "layers" else v.cuda())
        for k, v in cpu_params.items()
    }
    seq = torch.randint(0, 512, (21,), generator=torch.Generator().manual_seed(3))
    plen, P = 13, 8
    table = torch.tensor([[2, 4, 6, 0]], dtype=torch.int32)
    logits = {}
    launches0 = pa.LAUNCHES
    for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
        pages = llama.init_paged_cache(cfg, 8, P, device=dev)
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
    n_steps = len(seq) - plen
    if pa.LAUNCHES - launches0 != cfg.n_layers * n_steps:
        fail(f"model: {pa.LAUNCHES - launches0} kernel launches, want {cfg.n_layers * n_steps}")
    err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    if not torch.allclose(logits["cuda"], logits["cpu"], rtol=2e-4, atol=2e-4):
        fail(f"model: card logits differ from the CPU's by {err:.3e} (tol 2e-4)")
    say(f"model tiny-f32 prefill+{n_steps} decode steps: card vs cpu max |dlogit| {err:.3e} (tol 2e-4)")


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


def profile_window(run, card: str) -> dict:
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
    say(f"profile (8 requests x 32 tokens): device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms "
        f"wall ({100 * doc['busy_share']:.1f}%); {launches} device ops, "
        f"{doc['device_ops_per_decode_step']:.0f} per decode step  [{card}]")
    for t in doc["top"]:
        say(f"  {t['ms']:9.3f} ms  x{t['count']:<6d} {t['kernel'][:90]}")
    return doc


def serving_phase(card: str) -> dict:
    import torch

    from agentcontrolplane_tpu_torch.engine.engine import Engine, SamplingParams
    from agentcontrolplane_tpu_torch.models.llama import forward
    from agentcontrolplane_tpu_torch.ops.cuda import paged_attention as pa
    from agentcontrolplane_tpu_torch.server.rest import make_server, serve_in_thread

    t0 = time.monotonic()
    engine = Engine("llama3-8b", device="cuda", seed=0, max_slots=8, max_ctx=2048,
                    page_size=16, decode_block_size=8)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    cfg = engine.config
    say(f"serving llama3-8b: dim {cfg.dim}, {cfg.n_layers} layers, {cfg.n_heads}/{cfg.n_kv_heads} "
        f"heads, vocab {cfg.vocab_size}, {engine.weight_bytes / 1e9:.2f} GB of bf16 weights, "
        f"{engine.num_pages} pages; init {init_s:.2f} s")
    with torch.inference_mode():
        lg = forward(engine.params, torch.arange(16, device="cuda")[None] + 256, cfg)
    if lg.shape != (1, 16, cfg.vocab_size) or not torch.isfinite(lg).all():
        fail(f"serving: llama3-8b forward logits {tuple(lg.shape)} not finite/shaped")
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

        _check_reply(*chat("warm-up", max_tokens=4), 4, "warm-up")
        # the counted run: counts to 0 just before, read just after
        pa.LAUNCHES = 0
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
            fail("serving: decoding never started")
        late = threading.Thread(
            target=lambda: replies.__setitem__("sampled", chat("late", 0.7, 0.9)))
        late.start()
        for t in [*threads, late]:
            t.join(timeout=600)
        launches = pa.LAUNCHES
        steps = engine.decode_steps - steps0
        if len(replies) != 5:
            fail(f"serving: {len(replies)} of 5 replies arrived")
        n_tokens = [_check_reply(*replies[k], 32, f"request {k}") for k in replies]
        if launches != cfg.n_layers * steps or steps == 0:
            fail(f"serving: {launches} kernel launches for {steps} decode steps x "
                 f"{cfg.n_layers} layers")
        say(f"serving: 5 chat completions OK, completion tokens {n_tokens}; kernel launches "
            f"{launches} = {cfg.n_layers} layers x {steps} decode steps")
        stats = engine.stats()
        if stats["kv_pages"]["free"] != engine.num_pages - 1 or stats["active_slots"]:
            fail(f"serving: pages or slots not released after the run: {stats}")

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
            fail("serving: the same greedy batch gave different tokens on a second run")
        say("serving: greedy batch of 4 repeated -> identical tokens")
        perf = {"card": card, "launches": launches, "decode_steps": steps, "init_s": init_s}
        for label, (res, nsteps) in (("batch4", (run_b, steps_b)), ("batch8", batch(8, 128))):
            decode_ms = max(r.latency_ms for r in res) - max(r.ttft_ms for r in res)
            dec_tokens = sum(max(0, len(r.tokens) - 1) for r in res)
            perf[label] = {
                "ttft_ms_mean": sum(r.ttft_ms for r in res) / len(res),
                "ttft_ms_max": max(r.ttft_ms for r in res),
                "decode_steps": nsteps,
                "ms_per_decode_step": decode_ms / nsteps,
                "decode_tokens_per_s": dec_tokens / (decode_ms / 1e3),
            }
            p = perf[label]
            say(f"serving {label}: TTFT mean {p['ttft_ms_mean']:.1f} ms max {p['ttft_ms_max']:.1f} ms; "
                f"{p['ms_per_decode_step']:.2f} ms per decode step; "
                f"{p['decode_tokens_per_s']:.1f} decode tokens/s  [{card}]")
        perf["profile"] = profile_window(lambda: batch(8, 32), card)
        return perf
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()


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
    t_start = time.monotonic()
    card = card_line()
    say(f"card: {card}")
    say(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.monotonic()
    logs = build.build_all()
    build_s = time.monotonic() - t0
    say(f"build: {len(logs)} of {len(build.SOURCES)} libraries compiled in {build_s:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  {name}: {line.strip()}")

    kernels = kernel_phase()
    model_phase()
    perf = serving_phase(card)

    main_case = next(c for c in kernels["cases"] if c["case"] == "llama3-8b")
    max_err = max(c[f"{m}_max_abs_err"] for c in kernels["cases"]
                  for m in ("cache_plus_new", "classic"))
    kernel_doc = {
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "agentcontrolplane_tpu_torch/csrc/paged_attention.cu",
        "replaces": "agentcontrolplane_tpu/ops/pallas/paged_attention.py:325",
        "launches": perf["launches"],
        "max_abs_err": max_err,
        "ms": main_case["cache_plus_new_kernel_ms"],
        "kernel_ms": main_case["cache_plus_new_kernel_ms"],
        "plain_ms": main_case["cache_plus_new_plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "cases": kernels["cases"],
    }
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build_s": build_s, "kernel": kernel_doc, "serving": perf,
         "seconds": time.monotonic() - t_start}, indent=1))
    say(f"total {time.monotonic() - t_start:.1f} s")
    say(f"card: {card}")
    say(json.dumps({"kernels": [kernel_doc]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
