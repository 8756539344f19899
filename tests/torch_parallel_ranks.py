"""What each rank of ``tests/test_torch_parallel.py`` runs, in its own
spawned process: the port's parallel pieces on the CPU over gloo, on inputs
the test made with numpy, returning numpy results.

``spawn`` re-imports this module in every rank, so it imports neither JAX
nor the JAX package: the ranks run the port alone, and the test process
holds them against the reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from agentcontrolplane_tpu_torch.engine.engine import Engine, SamplingParams
from agentcontrolplane_tpu_torch.engine.weights import params_from_jax
from agentcontrolplane_tpu_torch.models import llama as tl
from agentcontrolplane_tpu_torch.ops.cuda import paged_attention as pa
from agentcontrolplane_tpu_torch.ops.quant import quantize_params
from agentcontrolplane_tpu_torch.parallel.mesh import serving_group, shard_params


def _slice_pages(a: np.ndarray, group, head_axis: int) -> torch.Tensor:
    """The rank's part of a full [.., NP, P, H_kv(, d)] pool: rows
    ``[sp_rank * P/sp, ...)`` of every page and its tp share of KV heads."""
    P, H = a.shape[head_axis - 1], a.shape[head_axis]
    pl, hl = P // group.sp, H // group.tp
    idx = [slice(None)] * a.ndim
    idx[head_axis - 1] = slice(group.sp_rank * pl, (group.sp_rank + 1) * pl)
    idx[head_axis] = slice(group.tp_rank * hl, (group.tp_rank + 1) * hl)
    return torch.from_numpy(np.ascontiguousarray(a[tuple(idx)]))


def _heads(a: np.ndarray, group) -> torch.Tensor:
    """The rank's tp share of the head axis (axis 1) of [S, H, d]."""
    h = a.shape[1] // group.tp
    return torch.from_numpy(np.ascontiguousarray(a[:, group.tp_rank * h:(group.tp_rank + 1) * h]))


def _wrappers(group, w: dict) -> dict:
    """Both sharded wrappers over both walks on the rank's slices."""
    out = {}
    tables, lens = torch.from_numpy(w["tables"]), torch.from_numpy(w["lens"])
    q, k_new, v_new = _heads(w["q"], group), _heads(w["k_new"], group), _heads(w["v_new"], group)
    for walk in ("f32", "int8"):
        kp, vp = _slice_pages(w[f"k_{walk}"], group, 2), _slice_pages(w[f"v_{walk}"], group, 2)
        scales = {}
        if walk == "int8":
            scales = {"k_scales": _slice_pages(w["ks"], group, 2),
                      "v_scales": _slice_pages(w["vs"], group, 2)}
        out[f"cache_plus_new_{walk}"] = pa.paged_decode_attention_cache_plus_new_sharded(
            group, q, kp, vp, tables, lens, k_new, v_new, **scales).numpy()
        out[f"classic_{walk}"] = pa.paged_decode_attention_sharded(
            group, q, kp, vp, tables, lens + 1, **scales).numpy()
    return out


def _decode(group, tree: dict, config, d: dict) -> dict:
    """One decode_step_paged on the rank's params and pool slices: the full
    logits and the rank's committed pools."""
    params = params_from_jax(tree, config, device="cpu", group=group)
    pages = {"k": _slice_pages(d["k"], group, 3), "v": _slice_pages(d["v"], group, 3)}
    pages, logits = tl.decode_step_paged(
        params, pages, torch.from_numpy(d["tokens"]), torch.from_numpy(d["lens"]),
        torch.from_numpy(d["tables"]), torch.from_numpy(d["active"]), config, group=group,
    )
    return {"logits": logits.numpy(), "k": pages["k"].numpy(), "v": pages["v"].numpy()}


def _streams(group, tree: dict, config, batch, conversation, engine_kw: dict,
             quantized: bool) -> dict:
    """A greedy batch of (prompt, sampling keywords) through this rank's
    engine (submitted on rank 0, as one admission group), then the turns of
    one conversation one after another (each turn's prompt extends the
    last, so the second hits the prefix cache): the leader's results, every
    rank's record of finished requests and its prefix-cache hits."""
    if quantized:  # int8 is applied to the whole model, then sliced
        params = shard_params(quantize_params(params_from_jax(tree, config, device="cpu")), group)
    else:
        params = params_from_jax(tree, config, device="cpu", group=group)
    engine = Engine(config, params, device="cpu", group=group, quantize_weights=quantized,
                    quantize_kv=quantized, **engine_kw)
    engine.start()
    results = None
    if group.is_leader:
        with engine.hold_admission():
            futs = [engine.submit(p, SamplingParams(**kw)) for p, kw in batch]
        results = [(f.result(timeout=120).tokens, f.result().finish_reason) for f in futs]
        for prompt, kw in conversation:
            r = engine.submit(prompt, SamplingParams(**kw)).result(timeout=120)
            results.append((r.tokens, r.finish_reason))
        engine.stop()
    else:
        refused = engine.submit("x", SamplingParams(max_tokens=1))
        if not isinstance(refused.exception(timeout=10), RuntimeError):
            raise AssertionError("a follower engine accepted a submission")
        if not engine.join(timeout=120):
            raise AssertionError("follower engine did not stop with the leader")
    stats = engine.stats()
    return {"results": results, "finished": list(engine.finished),
            "mesh": stats["mesh"], "pool_shape": tuple(engine.cache["k"].shape),
            "decode_steps": engine.decode_steps, "prefix_hits": stats["prefix_cache"]["hits"]}


def _clock_decisions(group, tree: dict, config, engine_kw: dict) -> dict:
    """The leader's clock decisions reach every rank as frames: a queued
    request whose deadline passes while admission is held, and a decoding
    request cancelled mid-generation."""
    params = params_from_jax(tree, config, device="cpu", group=group)
    engine = Engine(config, params, device="cpu", group=group, **engine_kw)
    engine.start()
    out = None
    if group.is_leader:
        with engine.hold_admission():
            long = engine.submit("w" * 20, SamplingParams(max_tokens=40))
            doomed = engine.submit("never admitted", SamplingParams(max_tokens=5), timeout_s=0.01)
            doomed.exception(timeout=60)  # expires while held
        while engine.decode_steps == 0:
            time.sleep(0.001)
        engine.cancel(long)
        out = {"long": long.result(timeout=60).finish_reason,
               "doomed": type(doomed.exception()).__name__, "doomed_rid": doomed.rid}
        engine.stop()
    elif not engine.join(timeout=120):
        raise AssertionError("follower engine did not stop with the leader")
    return {"leader": out, "finished": list(engine.finished)}


def _chunked_streams(group, tree: dict, config, engine_kw: dict, chunked: dict,
                     megastep: bool) -> dict:
    """On an engine with chunked prefill on, the megastep on or off: one
    row prefilled in chunks, then two requests sharing a page-aligned
    prefix admitted as one group (the second shares the first's pages):
    the leader's results, every rank's record of finished requests, its
    dedup shares, chunks, fused dispatches and rate plans. The row carries
    a deadline that would give it a quota of 2 on one card (the cycle clock
    seeded with 10 s a cycle); under the group its quota stays 1."""
    params = params_from_jax(tree, config, device="cpu", group=group)
    engine = Engine(config, params, device="cpu", group=group, megastep=megastep,
                    prefill_chunk=chunked["prefill_chunk"], **engine_kw)
    engine._cycle_clock.cycle_s = 10.0
    engine.start()
    results = None
    if group.is_leader:
        prompt, kw = chunked["row"]
        r = engine.submit(prompt, SamplingParams(**kw),
                          timeout_s=chunked["timeout_s"]).result(timeout=120)
        results = [(r.tokens, r.finish_reason)]
        with engine.hold_admission():
            futs = [engine.submit(p, SamplingParams(**kw)) for p, kw in chunked["pair"]]
        results += [(f.result(timeout=120).tokens, f.result().finish_reason) for f in futs]
        engine.stop()
    elif not engine.join(timeout=120):
        raise AssertionError("follower engine did not stop with the leader")
    return {"results": results, "finished": list(engine.finished),
            "shares": engine.prefix_shares, "chunks": engine.prefill_chunks,
            "megastep": engine.stats()["scheduler"]["megastep"],
            "quota_projections": engine.quota_projections}


def parallel_cases(tp: int, sp: int, inputs: dict) -> dict:
    """Every multi-process case of the test file, in one run of the ranks."""
    torch.set_num_threads(1)
    group = serving_group(tp, sp)
    cfg = inputs["config"]
    out = {"rank": group.rank, "tp_rank": group.tp_rank, "sp_rank": group.sp_rank}
    out["wrappers"] = _wrappers(group, inputs["wrappers"])
    pa.LAUNCHES = pa.STATE_LAUNCHES = 0
    out["decode"] = _decode(group, inputs["tree"], cfg, inputs["decode"])
    out["launches"] = (pa.LAUNCHES, pa.STATE_LAUNCHES)  # CPU tensors: no kernel launch
    for quantized in (False, True):
        out[f"streams_{'int8' if quantized else 'f32'}"] = _streams(
            group, inputs["stream_tree"], cfg, inputs["batch"], inputs["conversation"],
            inputs["engine_kw"], quantized)
    out["clock"] = _clock_decisions(group, inputs["stream_tree"], cfg, inputs["engine_kw"])
    if sp == 1:
        for megastep in (True, False):
            out[f"chunked_{'fused' if megastep else 'split'}"] = _chunked_streams(
                group, inputs["stream_tree"], cfg, inputs["engine_kw"], inputs["chunked"],
                megastep)
    return out
