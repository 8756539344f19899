"""The port's tensor- and context-parallel paged serving against the JAX
package's sharded programs, on the CPU.

Single process: the plain state walk over each sp rank's slice of every
page against the Pallas kernel's ``_paged_state(..., pos_base=,
global_page_size=)`` in interpret mode (f32 and int8, lanes where the rank
holds a valid row, rtol/atol 1e-5), and the sp merge plus self-term fold
over the stacked ranks against ``paged_decode_attention_cache_plus_new_
sharded`` on an sp x tp mesh (1e-5).

Multi-process: ``run_ranks`` once per world size (tp=2, and sp=2 x tp=2),
gloo, one thread per rank, each rank running every case of
``tests/torch_parallel_ranks.py`` (no JAX there); the sharded wrappers of
both walks against the JAX sharded wrappers (1e-5), ``decode_step_paged``
logits against the reference's (2e-4, the bar of ``test_torch_model.py``)
and its committed pools (1e-5), and greedy engine streams byte-identical
across ranks, to the port on one card and to the JAX mesh engine, unquantized
and with int8 weights + KV, a json_only request and a forced tool-call
envelope among them, then a two-turn conversation whose second turn hits
the prefix cache on every rank (a continuation prefill over shared pages:
each rank's heads under tp, the sp ranks' prefix states merged under sp);
under tp=2 also an engine with chunked prefill on, whose chunked row and
dedup pair must give the single-card port's tokens on every rank. Plus the
reference's refusals of bad serving configurations, and
``run_ranks``' hard timeout.
"""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from agentcontrolplane_tpu.engine import constrain as ref_constrain
from agentcontrolplane_tpu.engine.engine import Engine as JaxEngine
from agentcontrolplane_tpu.engine.engine import SamplingParams as JaxSampling
from agentcontrolplane_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from agentcontrolplane_tpu.models import llama as jl
from agentcontrolplane_tpu.ops.pallas import paged_attention as jpa
from agentcontrolplane_tpu.parallel.mesh import make_mesh
from agentcontrolplane_tpu_torch.engine import constrain as port_constrain
from agentcontrolplane_tpu_torch.engine import engine as port_engine_mod
from agentcontrolplane_tpu_torch.engine.engine import Engine, SamplingParams
from agentcontrolplane_tpu_torch.engine.tokenizer import ByteTokenizer
from agentcontrolplane_tpu_torch.engine.weights import params_from_jax
from agentcontrolplane_tpu_torch.models import llama as tl
from agentcontrolplane_tpu_torch.ops import paged as tpaged
from agentcontrolplane_tpu_torch.ops.cuda import paged_attention as tpa
from agentcontrolplane_tpu_torch.parallel.distributed import run_ranks
from agentcontrolplane_tpu_torch.parallel.mesh import ServingGroup

from .torch_parallel_ranks import parallel_cases

TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
WORLDS = {"tp2": (2, 1), "sp2xtp2": (2, 2)}  # name -> (tp, sp)
JCFG = dataclasses.replace(jl.PRESETS["tiny"], vocab_size=512, max_seq_len=256)
TCFG = dataclasses.replace(tl.PRESETS["tiny"], vocab_size=512, max_seq_len=256)
ENGINE_KW = dict(max_slots=4, max_ctx=64, prefill_buckets=(32, 64), decode_block_size=4,
                 page_size=8)
EOT = 260  # ByteTokenizer's <|eot_id|>, a stop token
# as tests/test_torch_engine.py: stops mid-decode and at the first token,
# max_tokens clipping, a truncated prompt running into the context edge
BATCH = [("json", 30), ("cat", 10), ("hello", 7), ("w" * 50, 40), ("qq", 12), ("tool time", 20)]
# (prompt, sampling keywords): the batch above, plus a json_only request and
# a forced tool-call envelope under the constraint
WORKLOAD = [(p, {"max_tokens": m}) for p, m in BATCH] + [
    ("json", {"max_tokens": 20, "json_only": True}),
    ("tool time", {"max_tokens": 12, "json_only": True,
                   "forced_prefix": tuple(b'{"name": "get_weather", "arguments": {')}),
]

# two turns of one conversation, served one after the other: the second
# extends the first (40 -> 52 tokens), so it hits the prefix cache (a 32-row
# entry) and prefills its 20-token suffix over the shared pages
TURN1 = "user asks; tool answers. " * 2
CONVERSATION = [(p, {"max_tokens": 4}) for p in (TURN1[:40], TURN1[:40] + " more words!")]
# on an engine with 16-token chunks (tp=2 world only), the megastep on and
# off: a 50-token row prefilled in four chunks, with a deadline that gives
# it a quota of 2 on one card at 10 s a cycle (ceil(4 / (floor(50 / 10) -
# 2))), then two requests whose first 16 tokens agree, admitted as one
# group, so the second shares the first's two pages
CHUNKED = {
    "prefill_chunk": 16,
    "timeout_s": 50.0,
    "row": (TURN1, {"max_tokens": 8}),
    "pair": [("shared persona text! one", {"max_tokens": 6}),
             ("shared persona text! two", {"max_tokens": 6})],
}

# paged inputs: S=4 lanes, pages of 8 tokens, 2 KV heads of 8 query heads,
# d=16. Lengths: 0 (nothing anywhere), 3 (all rows of sp rank 1 masked at
# sp=2), 12 (rank 1's last slice masked), and 31 (the whole table once the
# new token, or the classic form's +1, is counted).
S, H, HKV, D, P, MAX_PAGES, NUM_PAGES = 4, 8, 2, 16, 8, 4, 20
LENS = np.array([0, 3, 12, 31], np.int32)


def _paged_inputs(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    tables = np.zeros((S, MAX_PAGES), np.int32)
    perm = rng.permutation(np.arange(1, NUM_PAGES)).astype(np.int32)
    for s, n in enumerate(LENS):
        used = -(-int(n) // P)
        tables[s, :used] = perm[s * MAX_PAGES: s * MAX_PAGES + used]
    shape = (NUM_PAGES, P, HKV, D)
    return {
        "q": rng.standard_normal((S, H, D)).astype(np.float32),
        "k_new": rng.standard_normal((S, HKV, D)).astype(np.float32),
        "v_new": rng.standard_normal((S, HKV, D)).astype(np.float32),
        "k_f32": rng.standard_normal(shape).astype(np.float32),
        "v_f32": rng.standard_normal(shape).astype(np.float32),
        "k_int8": rng.integers(-127, 128, shape).astype(np.int8),
        "v_int8": rng.integers(-127, 128, shape).astype(np.int8),
        "ks": rng.uniform(0.001, 0.02, shape[:-1]).astype(np.float32),
        "vs": rng.uniform(0.001, 0.02, shape[:-1]).astype(np.float32),
        "tables": tables,
        "lens": LENS.copy(),
    }


def _pages(w: dict, walk: str) -> tuple:
    """(k, v, scale keywords) of one walk, as numpy."""
    scales = {"k_scales": w["ks"], "v_scales": w["vs"]} if walk == "int8" else {}
    return w[f"k_{walk}"], w[f"v_{walk}"], scales


def _valid_rows(sp: int, rank: int) -> np.ndarray:
    """Per lane, how many of its rows the sp rank holds below seq_len."""
    pl = P // sp
    pos = (np.arange(MAX_PAGES)[:, None] * P + rank * pl + np.arange(pl)[None, :]).ravel()
    return np.array([(pos < n).sum() for n in LENS])


# -- single process: the state walk and the merge ----------------------------


@pytest.mark.parametrize("walk", ["f32", "int8"])
def test_state_matches_pallas_state_on_each_sp_rank(walk):
    w = _paged_inputs(1)
    k, v, scales = _pages(w, walk)
    sp = 2
    pl = P // sp
    for rank in range(sp):
        rows = slice(rank * pl, (rank + 1) * pl)
        local = {n: a[:, rows] for n, a in scales.items()}
        ref = jpa._paged_state(
            jnp.asarray(w["q"]), jnp.asarray(k[:, rows]), jnp.asarray(v[:, rows]),
            jnp.asarray(w["tables"]), jnp.asarray(w["lens"]), interpret=True,
            pos_base=jnp.array([rank * pl], jnp.int32), global_page_size=P,
            **{n: jnp.asarray(a) for n, a in local.items()},
        )
        ours = tpa.paged_decode_state(
            torch.from_numpy(w["q"]), torch.from_numpy(k[:, rows].copy()),
            torch.from_numpy(v[:, rows].copy()), torch.from_numpy(w["tables"]),
            torch.from_numpy(w["lens"]), pos_base=rank * pl, global_page_size=P,
            **{n: torch.from_numpy(a.copy()) for n, a in local.items()},
        )
        held = _valid_rows(sp, rank) > 0
        for name, o, r in zip(("acc", "m", "l"), ours, ref):
            np.testing.assert_allclose(o.numpy()[held], np.asarray(r)[held], **TOL,
                                       err_msg=f"{name} rank {rank}")
        # a lane this rank holds no valid row of: the empty state, by design
        # (Pallas loads the masked rows and counts them in l)
        acc, m, l = (t.numpy()[~held] for t in ours)
        assert (~held).any()
        assert np.all(m == np.float32(-1e30)) and np.all(l == 0) and np.all(acc == 0)


@pytest.fixture(scope="module")
def jax_sharded():
    """(world, walk, form) -> the reference's sharded wrapper in interpret
    mode on ``_paged_inputs(4)``, computed once (each costs seconds). Its
    classic wrapper shards only tp and replicates over sp, so both worlds
    share the tp=2 result."""
    w = _paged_inputs(4)
    cache = {}

    def get(world, walk, form):
        if form == "classic":
            world = "tp2"
        if (world, walk, form) not in cache:
            k, v, scales = _pages(w, walk)
            kw = {n: jnp.asarray(a) for n, a in scales.items()}
            common = (jnp.asarray(w["q"]), jnp.asarray(k), jnp.asarray(v),
                      jnp.asarray(w["tables"]))
            if form == "cache_plus_new":
                out = jpa.paged_decode_attention_cache_plus_new_sharded(
                    _mesh(world), *common, jnp.asarray(w["lens"]), jnp.asarray(w["k_new"]),
                    jnp.asarray(w["v_new"]), interpret=True, **kw)
            else:
                out = jpa.paged_decode_attention_sharded(
                    _mesh(world), *common, jnp.asarray(w["lens"] + 1), interpret=True, **kw)
            cache[world, walk, form] = np.asarray(out)
        return cache[world, walk, form]

    return w, get


@pytest.mark.parametrize("walk", ["f32", "int8"])
def test_merge_and_fold_match_jax_sp_sharded(jax_sharded, walk):
    """merge_sp_states + fold_self_term over the sp ranks' stacked states
    (each tp rank's heads) == the reference's sp x tp wrapper."""
    w, ref = jax_sharded
    k, v, scales = _pages(w, walk)
    sp, tp = WORLDS["sp2xtp2"][1], WORLDS["sp2xtp2"][0]
    pl, hq, hk = P // sp, H // tp, HKV // tp
    outs = []
    for t in range(tp):
        qh, kh = slice(t * hq, (t + 1) * hq), slice(t * hk, (t + 1) * hk)
        q = torch.from_numpy(w["q"][:, qh].copy())
        states = []
        for r in range(sp):
            rows = slice(r * pl, (r + 1) * pl)
            states.append(tpaged.paged_decode_state_reference(
                q, torch.from_numpy(k[:, rows, kh].copy()), torch.from_numpy(v[:, rows, kh].copy()),
                torch.from_numpy(w["tables"]), torch.from_numpy(w["lens"]),
                pos_base=r * pl, global_page_size=P,
                **{n: torch.from_numpy(a[:, rows, kh].copy()) for n, a in scales.items()},
            ))
        acc, m, l = (torch.stack(x) for x in zip(*states))  # a leading sp axis
        acc, m, l = tpaged.merge_sp_states(
            acc, m, l, lambda x: x.amax(0, keepdim=True), lambda x: x.sum(0, keepdim=True))
        outs.append(tpaged.fold_self_term(
            q, torch.from_numpy(w["k_new"][:, kh].copy()),
            torch.from_numpy(w["v_new"][:, kh].copy()), acc[0], m[0], l[0]))
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(),
                               ref("sp2xtp2", walk, "cache_plus_new"), **TOL)


# -- multi-process: every case inside the ranks, once per world size ---------


def _stream_weights() -> dict:
    """As tests/test_torch_engine.py: seeded weights whose stop token's
    lm_head column is a scaled copy of a frequently chosen token's."""
    p = jax.tree_util.tree_map(np.array, jl.init_params(JCFG, jax.random.key(0)))
    p["lm_head"][:, EOT] = p["lm_head"][:, 289] * 1.05
    return p


def _decode_inputs() -> dict:
    rng = np.random.default_rng(3)
    shape = (JCFG.n_layers, 16, P, JCFG.n_kv_heads, JCFG.head_dim)
    return {
        "k": rng.standard_normal(shape).astype(np.float32),
        "v": rng.standard_normal(shape).astype(np.float32),
        "tokens": np.array([17, 400, 9, 256], np.int32),
        "lens": np.array([5, 16, 3, 11], np.int32),
        "tables": np.array([[3, 7, 0, 0], [5, 6, 8, 0], [10, 0, 0, 0], [1, 9, 0, 0]], np.int32),
        "active": np.array([True, True, False, True]),
    }


@pytest.fixture(scope="module")
def inputs():
    tree = jax.tree_util.tree_map(np.array, jl.init_params(JCFG, jax.random.key(7)))
    return {
        "config": TCFG, "wrappers": _paged_inputs(4), "tree": tree,  # as jax_sharded
        "decode": _decode_inputs(), "stream_tree": _stream_weights(), "batch": WORKLOAD,
        "conversation": CONVERSATION, "engine_kw": ENGINE_KW, "chunked": CHUNKED,
    }


@pytest.fixture(scope="module")
def ranks(inputs):
    """world name -> each rank's results, by rank."""
    return {
        name: run_ranks(parallel_cases, tp * sp, args=(tp, sp, inputs), timeout_s=120,
                        backend="gloo", device="cpu")
        for name, (tp, sp) in WORLDS.items()
    }


def _mesh(name):
    tp, sp = WORLDS[name]
    axes = {"sp": sp, "tp": tp} if sp > 1 else {"tp": tp}
    return make_mesh(axes, devices=jax.devices()[: tp * sp])


def _by_tp(results: list, key: str, sub: str) -> np.ndarray:
    """The ranks' head slices of one output joined over tp (from sp rank 0),
    after checking every sp rank of a tp slice returned the same bits."""
    tp = max(r["tp_rank"] for r in results) + 1
    parts = []
    for t in range(tp):
        mine = [r[key][sub] for r in results if r["tp_rank"] == t]
        for other in mine[1:]:
            np.testing.assert_array_equal(other, mine[0])
        parts.append(mine[0])
    return np.concatenate(parts, axis=1)


@pytest.mark.parametrize("form", ["cache_plus_new", "classic"])
@pytest.mark.parametrize("walk", ["f32", "int8"])
@pytest.mark.parametrize("world", list(WORLDS))
def test_sharded_wrappers_match_jax(ranks, jax_sharded, world, walk, form):
    _w, ref = jax_sharded
    ours = _by_tp(ranks[world], "wrappers", f"{form}_{walk}")
    np.testing.assert_allclose(ours, ref(world, walk, form), **TOL)


@pytest.mark.parametrize("world", list(WORLDS))
def test_decode_step_paged_matches_jax(ranks, inputs, world):
    d = inputs["decode"]
    jp = jax.tree_util.tree_map(jnp.asarray, inputs["tree"])
    j_pages, j_logits = jl.decode_step_paged(
        jp, {n: jnp.asarray(d[n]) for n in ("k", "v")},
        *(jnp.asarray(d[n]) for n in ("tokens", "lens", "tables", "active")), JCFG,
        mesh=_mesh(world),
    )
    tp, sp = WORLDS[world]
    pl, hk = P // sp, JCFG.n_kv_heads // tp
    for r in ranks[world]:
        np.testing.assert_allclose(r["decode"]["logits"], np.asarray(j_logits), **LOGIT_TOL)
        for name in ("k", "v"):
            ref = np.asarray(j_pages[name])[
                :, :, r["sp_rank"] * pl:(r["sp_rank"] + 1) * pl,
                r["tp_rank"] * hk:(r["tp_rank"] + 1) * hk]
            # page 0 takes the trash writes (other ranks' rows, inactive lanes)
            np.testing.assert_allclose(r["decode"][name][:, 1:], ref[:, 1:], **TOL)
        assert r["launches"] == (0, 0)  # CPU tensors: the plain versions


@pytest.fixture(scope="module")
def single_card_streams(inputs):
    """quantized -> (the port on one card, the JAX mesh engines by world)."""
    weights = inputs["stream_tree"]
    out = {}
    # every engine would build the same JSON token table: build it once a side
    table = ref_constrain.build_token_table(JaxByteTokenizer())
    port_table = port_constrain.build_token_table(ByteTokenizer())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_constrain, "build_token_table", lambda tokenizer, max_depth=8: table)
        mp.setattr(port_engine_mod, "build_token_table",
                   lambda tokenizer, max_depth=8: port_table)
        for quantized in (False, True):
            out[quantized] = _single_card_streams(weights, quantized)
    return out


def _single_card_streams(weights, quantized: bool):
    """(the port's greedy streams on one card, the JAX mesh engine's by world)."""
    port = Engine(TCFG, params_from_jax(weights, TCFG, device="cpu"), device="cpu",
                  quantize_weights=quantized, quantize_kv=quantized, **ENGINE_KW)
    port.start()
    try:
        with port.hold_admission():
            futs = [port.submit(p, SamplingParams(**kw)) for p, kw in WORKLOAD]
        mine = [(f.result(timeout=120).tokens, f.result().finish_reason) for f in futs]
        for p, kw in CONVERSATION:
            r = port.submit(p, SamplingParams(**kw)).result(timeout=120)
            mine.append((r.tokens, r.finish_reason))
        assert port.stats()["prefix_cache"]["hits"] == 1
    finally:
        port.stop()
    jax_streams = {}
    for world in WORLDS:
        eng = JaxEngine(
            config=JCFG, params=jax.tree_util.tree_map(jnp.asarray, weights),
            tokenizer=JaxByteTokenizer(), mesh=_mesh(world), kv_layout="paged",
            prefix_dedup=False, quantize_weights=quantized, quantize_kv=quantized,
            **ENGINE_KW,
        )
        eng.start()
        try:
            futs = [eng.submit(p, JaxSampling(**kw)) for p, kw in WORKLOAD]
            jax_streams[world] = [(f.result(timeout=300).tokens, f.result().finish_reason)
                                  for f in futs]
            for p, kw in CONVERSATION:
                r = eng.submit(p, JaxSampling(**kw)).result(timeout=300)
                jax_streams[world].append((r.tokens, r.finish_reason))
            assert eng.stats()["prefix_cache"]["hits"] == 1
        finally:
            eng.stop()
    return mine, jax_streams


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("world", list(WORLDS))
def test_engine_streams_identical_across_ranks_single_card_and_jax(
        ranks, single_card_streams, world, quantized):
    key = f"streams_{'int8' if quantized else 'f32'}"
    runs = [r[key] for r in ranks[world]]
    leader = runs[0]["results"]
    one_card, jax_streams = single_card_streams[quantized]
    assert leader == one_card
    assert leader == jax_streams[world]
    for (_prompt, kw), (tokens, _reason) in zip(WORKLOAD, leader):
        if kw.get("json_only"):  # the constrained requests complete as JSON
            json.loads(ByteTokenizer().decode(tokens))
    reasons = [reason for _, reason in leader]
    assert "stop" in reasons and "length" in reasons
    assert len(leader) == len(WORKLOAD) + len(CONVERSATION)
    for run in runs:  # the conversation's second turn hit on every rank
        assert run["prefix_hits"] == 1
    for run in runs[1:]:
        assert run["finished"] == runs[0]["finished"]
        assert run["decode_steps"] == runs[0]["decode_steps"] > 0
    finished = {rid: (list(toks), reason) for rid, toks, reason in runs[0]["finished"]}
    assert sorted(finished.values()) == sorted(leader)


def test_chunked_row_and_dedup_pair_identical_across_ranks_and_one_card(ranks, inputs):
    """tp=2 with chunked prefill on, the megastep on and off: the chunked
    row and the dedup pair give the port's single-card tokens, on every
    rank, with the same shares and chunks; the fused runs dispatch the same
    megasteps on every rank, and no rank makes a rate plan (the row's
    deadline keeps quota 1 there, so its chunks are the flat count)."""
    port = Engine(TCFG, params_from_jax(inputs["stream_tree"], TCFG, device="cpu"),
                  device="cpu", prefill_chunk=CHUNKED["prefill_chunk"], **ENGINE_KW)
    port.start()
    try:
        prompt, kw = CHUNKED["row"]
        r = port.submit(prompt, SamplingParams(**kw)).result(timeout=120)
        one_card = [(r.tokens, r.finish_reason)]
        with port.hold_admission():
            futs = [port.submit(p, SamplingParams(**kw)) for p, kw in CHUNKED["pair"]]
        one_card += [(f.result(timeout=120).tokens, f.result().finish_reason) for f in futs]
        shares, chunks = port.prefix_shares, port.prefill_chunks
        fused = port.megastep_dispatches
    finally:
        port.stop()
    assert shares == 1 and chunks >= 4 and fused > 0
    for mode in ("fused", "split"):
        runs = [r[f"chunked_{mode}"] for r in ranks["tp2"]]
        assert runs[0]["results"] == one_card, mode
        for run in runs:
            assert (run["shares"], run["chunks"], run["quota_projections"]) == (shares, chunks, 0)
            assert run["finished"] == runs[0]["finished"]
            assert run["megastep"] == runs[0]["megastep"]
        assert (runs[0]["megastep"]["dispatches"] == fused) == (mode == "fused"), mode


@pytest.mark.parametrize("world", list(WORLDS))
def test_rank_stats_and_local_pools(ranks, world):
    tp, sp = WORLDS[world]
    for r in ranks[world]:
        s = r["streams_f32"]
        assert s["mesh"] == ({"sp": sp, "tp": tp} if sp > 1 else {"tp": tp})
        L, hk = JCFG.n_layers, JCFG.n_kv_heads // tp
        assert s["pool_shape"][0] == L and s["pool_shape"][2:] == (P // sp, hk, JCFG.head_dim)


@pytest.mark.parametrize("world", list(WORLDS))
def test_clock_decisions_reach_every_rank_as_frames(ranks, world):
    """Deadline expiry and cancel are the leader's decisions: every rank
    drops the expired request and cancels the decoding one in lockstep."""
    runs = [r["clock"] for r in ranks[world]]
    lead = runs[0]["leader"]
    assert lead["doomed"] == "DeadlineExceededError"
    assert lead["long"] in ("cancelled", "length")  # "length" only if it outran the cancel
    for run in runs[1:]:
        assert run["finished"] == runs[0]["finished"]
    rids = [rid for rid, _, _ in runs[0]["finished"]]
    assert lead["doomed_rid"] not in rids and len(rids) == 1
    assert runs[0]["finished"][0][2] == lead["long"]


def _fake_group(tp, sp):
    """A ServingGroup with no process groups: enough for the checks that
    run before an engine touches a collective."""
    return ServingGroup(tp=tp, sp=sp, rank=0, tp_rank=0, sp_rank=0)


def test_engine_refuses_bad_parallel_configs():
    """The reference's refusals (test_context_parallel_serving.py:137-150
    and engine.py:519-545)."""
    kw = dict(device="cpu", max_slots=2)
    with pytest.raises(ValueError, match="context-parallel paged"):
        Engine(TCFG, max_ctx=256, page_size=2, group=_fake_group(2, 4), **kw)
    with pytest.raises(ValueError, match="divisible"):
        Engine(TCFG, max_ctx=254, group=_fake_group(2, 4), **kw)
    with pytest.raises(ValueError, match="n_kv_heads=2 cannot shard over tp=4"):
        Engine(TCFG, max_ctx=64, group=_fake_group(4, 1), **kw)
    # int8 weights must be quantized before they are cut to the ranks
    tree = jax.tree_util.tree_map(np.array, jl.init_params(JCFG, jax.random.key(0)))
    with pytest.raises(ValueError, match="quantized before slicing"):
        Engine(TCFG, params_from_jax(tree, TCFG, device="cpu", group=_fake_group(2, 1)),
               max_ctx=64, page_size=8, quantize_weights=True, group=_fake_group(2, 1), **kw)


def test_run_ranks_timeout_kills_every_rank():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="timed out"):
        run_ranks(time.sleep, 1, args=(600,), timeout_s=3, backend="gloo", device="cpu")
    assert time.monotonic() - t0 < 60
