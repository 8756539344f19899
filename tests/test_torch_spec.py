"""Speculative decoding on the CPU: the port against the JAX package.

- ``engine/spec.py``: ``ngram_propose`` and ``SpecState`` give the
  reference module's results on its own unit cases and on seeded contexts.
- ``ops/paged.py::token_write_targets`` and ``ops/sampling.py::
  speculative_accept`` equal the reference's functions on seeded numpy
  inputs (greedy; with and without the JSON table, stop tokens, budgets of
  1..T and a forced rejection).
- ``models/llama.py::verify_paged_continue``: logits within 2e-4 of the
  JAX function in f32 and with int8 KV, starts mid-page, an idle lane
  (``n_input = 0``, ``starts = max_ctx``) and drafts of mixed length; the
  rows ``[start, start + n_input)`` written as the reference writes them
  and no other live row changed.
- Replays of the reference's engine cases (``tests/engine/
  test_spec_decode.py``, the ``spec_len > 0`` cells of ``test_megastep.py``,
  ``test_chunked_prefill.py`` and ``test_quant_kv.py``, paged) on one
  module-scoped trio on the tiny f32 preset with the same weights: the JAX
  engine and the port's with ``spec_len=6``, and the port's with
  ``spec_len=0``. Each case gives byte-identical streams and equal
  ``spec_proposed``, ``spec_accepted``, ``spec_dispatches`` and
  ``decode_steps`` on the two spec engines, and the port's spec-on streams
  equal its spec-off ones. The ``engine.spec_mismatch`` and
  ``engine.force_preempt`` fault sites are armed alike on both engines,
  each on its own package's ``FAULTS``. Every model
  call of the port is held to the shared-page rule (a verify commit never
  writes a page referenced more than once).

``test_tool_echo_fixture_accepts_over_1_5_tokens_per_dispatch`` is not
replayed as a bar (it fails in the reference, ROADMAP C): the port's tokens
per decode step on that fixture must equal the reference's instead.
"""

import argparse
import re
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from agentcontrolplane_tpu.cli import build_parser as ref_parser
from agentcontrolplane_tpu.engine import constrain as ref_constrain
from agentcontrolplane_tpu.engine import spec as ref_spec
from agentcontrolplane_tpu.engine.engine import Engine as JaxEngine
from agentcontrolplane_tpu.engine.engine import SamplingParams as JaxSampling
from agentcontrolplane_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from agentcontrolplane_tpu.models import llama as jl
from agentcontrolplane_tpu.observability.metrics import REGISTRY as JAX_REGISTRY
from agentcontrolplane_tpu.ops import paged as ref_paged
from agentcontrolplane_tpu.ops import sampling as ref_sampling
from agentcontrolplane_tpu.parallel.mesh import make_mesh
from agentcontrolplane_tpu.testing import FAULTS
from agentcontrolplane_tpu_torch.faults import FAULTS as PORT_FAULTS
from agentcontrolplane_tpu_torch.cli import build_parser as port_parser
from agentcontrolplane_tpu_torch.engine import constrain
from agentcontrolplane_tpu_torch.engine import engine as port_engine_mod
from agentcontrolplane_tpu_torch.engine import spec
from agentcontrolplane_tpu_torch.engine.engine import Engine, SamplingParams, _Slot
from agentcontrolplane_tpu_torch.engine.tokenizer import ByteTokenizer
from agentcontrolplane_tpu_torch.engine.weights import params_from_jax
from agentcontrolplane_tpu_torch.models import llama as tl
from agentcontrolplane_tpu_torch.observability.metrics import REGISTRY as PORT_REGISTRY
from agentcontrolplane_tpu_torch.ops import sampling
from agentcontrolplane_tpu_torch.ops.paged import TRASH_PAGE, PageAllocator, token_write_targets

from .test_torch_chunked import (
    JCFG,
    KW,
    LOGIT_TOL,
    TCFG,
    TOOL_ECHO,
    _drop_parked,
    _Hold,
    _idle,
    _jit,
    _model_inputs,
    _pages_close,
    _SharedPageChecks,
    _weights,
)
from .test_torch_constrain import _reference_mask_fns
from .test_torch_megastep import BUSY

P = KW["page_size"]
V = JCFG.vocab_size
TOK = ByteTokenizer()
STOPS = sorted(TOK.stop_tokens)
SPEC = 6
MODEL_CALLS = ("decode_step_paged", "prefill_paged_batch", "prefill_paged_continue",
               "prefill_paged_continue_kv", "verify_paged_continue")


# -- the drafter and the controller ------------------------------------------------

NGRAM_CASES = [
    ([1, 2, 3, 9, 1, 2, 3, 7, 8, 1, 2, 3], 3, 4),
    ([1, 2, 3, 9, 1, 2, 3, 7, 8, 1, 2, 3], 3, 1),
    ([1, 2, 3, 9, 1, 2, 3, 7, 8, 1, 2, 3], 1, 2),
    ([6, 4, 5, 6], 3, 3),
    ([1, 2, 3, 4], 3, 4),
    ([7], 3, 4),
    ([7, 7, 7], 3, 0),
    ([9, 9, 9, 9], 3, 2),
    ([4, 5, 4, 5, 4, 5], 3, 4),
    # more heads than MAX_HEADS_PER_N: only the most recent are walked
    ([5, 1] * 80 + [5, 2] + [5, 1] * 3 + [5], 2, 3),
] + [("seeded", seed, 0) for seed in range(6)]


@pytest.mark.parametrize("ctx,ngram,max_len", NGRAM_CASES,
                         ids=[f"case{i}" for i in range(len(NGRAM_CASES))])
def test_ngram_propose_matches_the_reference(ctx, ngram, max_len):
    if ctx == "seeded":
        rng = np.random.default_rng(ngram)
        cases = [(rng.integers(0, 4, rng.integers(2, 60)), int(rng.integers(1, 5)),
                  int(rng.integers(0, 9))) for _ in range(40)]
    else:
        cases = [(np.asarray(ctx, dtype=np.int64), ngram, max_len)]
    assert spec.MAX_HEADS_PER_N == ref_spec.MAX_HEADS_PER_N
    for c, n, m in cases:
        assert spec.ngram_propose(c.astype(np.int32), n, m) == ref_spec.ngram_propose(c, n, m)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_state_sequences_match_the_reference(seed):
    """The same feedback gives the same caps: decay to 0, the re-probe
    after REPROBE_DISPATCHES, additive and doubling growth."""
    assert spec.REPROBE_DISPATCHES == ref_spec.REPROBE_DISPATCHES
    rng = np.random.default_rng(seed)
    ours, theirs = spec.SpecState(limit=8), ref_spec.SpecState(limit=8)
    for _ in range(200):
        assert ours.cap() == theirs.cap()
        prop = int(rng.integers(0, ours.cur + 1))
        acc = int(rng.choice([0, 0, prop, rng.integers(0, prop + 1)]))
        ours.observe(prop, acc)
        theirs.observe(prop, acc)
        assert (ours.cur, ours.idle) == (theirs.cur, theirs.idle)


# -- token_write_targets and speculative_accept ------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_token_write_targets_matches_the_reference(seed):
    """Starts mid-page, rows of every length 0..T, idle lanes at max_ctx
    (their page index clamped to the table)."""
    rng = np.random.default_rng(seed)
    S, M, T = 8, 12, 7
    tables = rng.integers(1, 40, (S, M)).astype(np.int32)
    starts = rng.integers(0, M * P - T, S).astype(np.int32)
    lengths = rng.integers(0, T + 1, S).astype(np.int32)
    starts[:2], lengths[:2] = M * P, 0
    want = ref_paged.token_write_targets(jnp.asarray(tables), jnp.asarray(starts),
                                         jnp.asarray(lengths), P, T)
    got = token_write_targets(torch.from_numpy(tables), torch.from_numpy(starts),
                              torch.from_numpy(lengths), P, T)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0][:2] == TRASH_PAGE).all()


@pytest.fixture(scope="module")
def tables():
    """The JSON table, built once for every engine of this module."""
    ref, port = ref_constrain.build_token_table(JaxByteTokenizer()), \
        constrain.build_token_table(ByteTokenizer())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_constrain, "build_token_table", lambda tokenizer, max_depth=8: ref)
        mp.setattr(port_engine_mod, "build_token_table", lambda tokenizer, max_depth=8: port)
        yield ref, port


def _accept_port(logits, inputs, n_input, active, budgets, force, table=None, states=None,
                 lanes=None):
    kw = {}
    if table is not None:
        trans, min_close = torch.from_numpy(table.token_trans), torch.from_numpy(table.min_close)
        cl = torch.from_numpy(lanes)
        kw = dict(
            constrain_fn=lambda lg, st, b: sampling.constrain_logits(lg, trans, st, cl,
                                                                     min_close, b),
            advance_fn=lambda st, tok, take: torch.where(
                take, sampling.advance_constraint(trans, st, cl, tok), st),
            con_states=torch.from_numpy(states))
    S = logits.shape[0]
    out = sampling.speculative_accept(
        torch.from_numpy(logits), torch.from_numpy(inputs), torch.from_numpy(n_input),
        torch.from_numpy(active), torch.Generator().manual_seed(0), torch.zeros(S),
        torch.zeros(S, dtype=torch.int64), torch.ones(S), torch.tensor(STOPS),
        torch.from_numpy(budgets), force, **kw)
    return [t.numpy() for t in out]


def _accept_ref(logits, inputs, n_input, active, budgets, force, table=None, states=None,
                lanes=None):
    kw = {}
    if table is not None:
        ref_constrain_logits, ref_advance = _reference_mask_fns()
        n_states, width = table.token_trans.shape
        padded = np.full((n_states, V), -1, np.int32)
        padded[:, :width] = table.token_trans
        padded, min_close = jnp.asarray(padded), jnp.asarray(table.min_close.astype(np.int32))
        cl = jnp.asarray(lanes)
        kw = dict(
            constrain_fn=lambda lg, st, b: ref_constrain_logits(lg, padded, st, cl, min_close, b),
            advance_fn=lambda st, tok, take: jnp.where(take, ref_advance(padded, st, cl, tok), st),
            con_states=jnp.asarray(states))
    S = logits.shape[0]
    out = ref_sampling.speculative_accept(
        jnp.asarray(logits), jnp.asarray(inputs), jnp.asarray(n_input), jnp.asarray(active),
        jax.random.key(0), jnp.zeros(S), jnp.zeros(S, jnp.int32), jnp.ones(S), tuple(STOPS),
        jnp.asarray(budgets), jnp.asarray(force), **kw)
    return [np.asarray(t) for t in out]


@pytest.mark.parametrize("json_table", [False, True], ids=["plain", "json"])
@pytest.mark.parametrize("force", [False, True], ids=["verify", "force-reject"])
def test_speculative_accept_matches_the_reference(tables, json_table, force):
    """Greedy accept over 2T lanes: drafts built to match the verified
    argmax for 0..T-1 positions (lanes drafting fewer tokens too), budgets
    1..T, a lane whose matching draft ends on a stop token, an inactive
    lane, and, with the table, constrained lanes in states reached by legal
    tokens. Equal tokens, counts and automaton states."""
    T = 6
    S = 2 * T
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((S, T, V)) * 3).astype(np.float32)
    logits[1, 1, STOPS[1]] = 50.0  # lane 1 emits a stop token at position 1
    inputs = rng.integers(0, 256, (S, T)).astype(np.int64)
    n_input = np.full(S, T, dtype=np.int64)
    n_input[2::3] = [1 + (i % T) for i in range(len(n_input[2::3]))]
    active = np.ones(S, dtype=bool)
    active[-1] = False
    budgets = np.asarray([1 + (s % T) for s in range(S)], dtype=np.int32)
    budgets[1] = T
    target = np.asarray([s % T for s in range(S)])
    target[1] = T
    states = lanes = None
    table = tables[1] if json_table else None
    if json_table:
        lanes = rng.random(S) < 0.8
        lanes[1] = False  # the stop token's lane
        states = np.full(S, table.start_state, dtype=np.int32)
        for s in range(S):
            for _ in range(s % 5):  # walk legal tokens into varied states
                legal = np.flatnonzero(table.token_trans[states[s]] >= 0)
                states[s] = table.token_trans[states[s], rng.choice(legal)]
    # each round makes every lane's draft match one more verified token
    for i in range(T - 1):
        out, _n, _st = _accept_port(logits, inputs, n_input, active, np.full(S, T, np.int32),
                                    False, table, states, lanes)
        for s in range(S):
            if i < target[s] and i + 1 < n_input[s] and out[s, i] >= 0:
                inputs[s, i + 1] = out[s, i]
    want = _accept_ref(logits, inputs, n_input, active, budgets, force, table, states, lanes)
    got = _accept_port(logits, inputs, n_input, active, budgets, force, table, states, lanes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.astype(g.dtype))
    n_emit = got[1]
    assert n_emit[-1] == 0 and (n_emit <= budgets).all()
    if not force:
        assert len(set(n_emit.tolist())) >= 4  # the walk stopped at many places
        assert got[0][1, 1] == STOPS[1] and n_emit[1] == 2


# -- the verify pass -------------------------------------------------------------


@pytest.mark.parametrize("quantize_kv", [False, True], ids=["f32", "int8-kv"])
def test_verify_paged_continue_matches_jax(quantize_kv):
    """Two rows prefilled (19 and 24 tokens), then a verify pass of four
    lanes: 1 + 3 rows from 19 (mid-page), 1 + 5 from 24, an idle lane
    (``n_input = 0``, ``starts = max_ctx``) whose table is row 0's, and one
    token from 5 rows of row 1's. Logits of every scored position within
    2e-4, the written rows as the reference writes them, and every other
    row of every page the same as before the pass."""
    tree, tables2, toks = _model_inputs()
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    params = params_from_jax(tree, TCFG, device="cpu")
    pre = [19, 24]
    first = np.zeros((2, 32), np.int32)
    pids = np.zeros((2, 4), np.int32)
    for b in range(2):
        first[b, : pre[b]] = toks[b][: pre[b]]
        pids[b, : -(-pre[b] // P)] = tables2[b, : -(-pre[b] // P)]
    pages = jl.init_paged_cache(JCFG, 16, P, quantize_kv=quantize_kv)
    pages, _ = _jit(jl.prefill_paged_batch)(
        jp, pages, jnp.asarray(first), jnp.asarray(pre, np.int32), jnp.asarray(pids), config=JCFG)
    max_ctx = tables2.shape[1] * P
    T = 6
    tables = tables2[[0, 1, 0, 1]]
    starts = np.asarray([19, 24, max_ctx, 5], np.int32)
    lengths = np.asarray([4, 6, 0, 1], np.int32)
    tokens = np.zeros((4, T), np.int32)
    for b in range(4):
        tokens[b, : lengths[b]] = toks[b % 2][40: 40 + lengths[b]]
    before = {k: np.array(v) for k, v in pages.items()}
    ours = {k: torch.from_numpy(v.copy()) for k, v in before.items()}
    ref_pages, ref_logits = _jit(jl.verify_paged_continue)(
        jp, pages, jnp.asarray(tokens), jnp.asarray(lengths), jnp.asarray(starts),
        jnp.asarray(tables), config=JCFG)
    ours, logits = tl.verify_paged_continue(
        params, ours, torch.from_numpy(tokens), torch.from_numpy(lengths),
        torch.from_numpy(starts), torch.from_numpy(tables), TCFG)
    assert logits.shape == (4, T, V)
    ref_logits = np.asarray(ref_logits)
    for b in range(4):
        np.testing.assert_allclose(logits[b, : lengths[b]].numpy(), ref_logits[b, : lengths[b]],
                                   **LOGIT_TOL, err_msg=f"lane {b}")
    written = set()
    for b in range(4):
        for pos in range(starts[b], starts[b] + lengths[b]):
            written.add((int(tables[b, pos // P]), pos % P))
    for name in ours:
        a = np.asarray(ref_pages[name]).astype(np.float32)
        g = ours[name].numpy().astype(np.float32)
        was = before[name].astype(np.float32)
        rows = sorted(written)
        pick = lambda x: np.stack([x[:, pg, off] for pg, off in rows], axis=1)
        _pages_close(pick(g), pick(a), quantize_kv and name in ("k", "v"), name)
        keep = np.ones(g.shape[1:3], dtype=bool)
        keep[TRASH_PAGE] = False
        for pg, off in rows:
            keep[pg, off] = False
        np.testing.assert_array_equal(g[:, keep], was[:, keep], err_msg=f"{name} rows kept")


# -- the engines -------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines(tables):
    weights = _weights()
    ref = JaxEngine(
        config=JCFG, params=jax.tree_util.tree_map(jnp.asarray, weights),
        tokenizer=JaxByteTokenizer(), mesh=make_mesh({"tp": 1}, devices=jax.devices()[:1]),
        kv_layout="paged", autopilot=False, spec_len=SPEC, host_kv_bytes=0, **KW,
    )
    params = params_from_jax(weights, TCFG, device="cpu")
    on = Engine(TCFG, params, device="cpu", spec_len=SPEC, **KW)
    off = Engine(TCFG, params, device="cpu", spec_len=0, **KW)
    checks: dict = {}  # engine thread -> its checks
    real = {name: getattr(port_engine_mod, name) for name in MODEL_CALLS}

    def mine():
        return checks.get(threading.current_thread())

    def decode(params, pages, tokens, seq_lens, block_tables, active, config, group=None):
        if mine() is not None:
            mine().step(seq_lens, block_tables, active)
        return real["decode_step_paged"](params, pages, tokens, seq_lens, block_tables, active,
                                         config, group=group)

    def writer(name, ids_at):
        def call(*args, **kw):
            if mine() is not None:
                mine().prefill(args[ids_at])
            return real[name](*args, **kw)
        return call

    def verify(params, pages, tokens, lengths, starts, block_tables, config):
        if mine() is not None:
            mine().verify(lengths, starts, block_tables)
        return real["verify_paged_continue"](params, pages, tokens, lengths, starts, block_tables,
                                             config)

    port_engine_mod.decode_step_paged = decode
    port_engine_mod.prefill_paged_batch = writer("prefill_paged_batch", 4)
    port_engine_mod.prefill_paged_continue = writer("prefill_paged_continue", 5)
    port_engine_mod.prefill_paged_continue_kv = writer("prefill_paged_continue_kv", 5)
    port_engine_mod.verify_paged_continue = verify
    ref.start()
    for eng in (on, off):
        eng.start()
        checks[eng._thread] = _SharedPageChecks(eng)
    try:
        yield SimpleNamespace(ref=ref, on=on, off=off, checks=checks)
    finally:
        for name, fn in real.items():
            setattr(port_engine_mod, name, fn)
        FAULTS.reset()
        PORT_FAULTS.reset()
        for eng in (ref, on, off):
            eng.stop()


def _rest(eng) -> None:
    _idle(eng)
    _drop_parked(eng)
    while eng._evict_one_prefix_entry():
        pass
    eng.prefill_chunk, eng.megastep, eng.megastep_max_programs = 0, True, 32
    eng._prefix_enabled = True
    if eng.spec_len:
        eng.spec_len = SPEC
    _faults(eng).reset()


@pytest.fixture
def trio(engines):
    """The module's engines at rest and at their defaults before and after
    a case; the pools and the slots whole after it, the port's checks
    clean."""
    for eng in (engines.ref, engines.on, engines.off):
        _rest(eng)
    n0 = {t: len(c.violations) for t, c in engines.checks.items()}
    yield engines
    FAULTS.reset()
    PORT_FAULTS.reset()
    for eng in (engines.ref, engines.on, engines.off):
        _rest(eng)
        assert eng._allocator.free_count == eng.num_pages - 1
        assert len(eng._free) == eng.max_slots
    for t, c in engines.checks.items():
        assert c.violations[n0[t]:] == []


def _counters(eng) -> dict:
    return {"spec_proposed": eng.spec_proposed, "spec_accepted": eng.spec_accepted,
            "spec_dispatches": eng.spec_dispatches, "decode_steps": eng.decode_steps,
            "tokens_generated": eng.tokens_generated, "preemptions": eng.preemptions,
            "megastep_dispatches": eng.megastep_dispatches,
            "megastep_fallbacks": eng.megastep_fallbacks, "prefill_chunks": eng.prefill_chunks,
            "prefix_hits": eng._prefix_hits}


def _run(eng, case):
    sp = SamplingParams if isinstance(eng, Engine) else JaxSampling
    c0 = _counters(eng)
    out = case(eng, sp)
    _idle(eng)
    c1 = _counters(eng)
    return out, {k: c1[k] - c0[k] for k in c0}


def _replay(trio, case, streams=lambda out: out) -> tuple:
    """``case(engine, SamplingParams class)`` on the JAX spec engine, the
    port's and the port's spec-off engine: equal outcomes and counter
    deltas on the two spec engines, and the same streams (``streams`` of
    the outcome) spec off. Returns the port's outcome and deltas."""
    ref, ref_d = _run(trio.ref, case)
    on, on_d = _run(trio.on, case)
    off, off_d = _run(trio.off, case)
    assert on == ref
    assert on_d == ref_d
    assert streams(on) == streams(off)
    assert off_d["spec_dispatches"] == 0
    return on, on_d


def _faults(eng):
    """The fault injector of ``eng``'s package."""
    return PORT_FAULTS if isinstance(eng, Engine) else FAULTS


def _reject(eng, times: int) -> None:
    """Force the next ``times`` verify passes to reject every draft: the
    ``engine.spec_mismatch`` fault site of either package."""
    _faults(eng).arm("engine.spec_mismatch", times=times)


def _unreject(eng) -> None:
    _faults(eng).disarm("engine.spec_mismatch")


def _counter(eng, name: str) -> float:
    registry = PORT_REGISTRY if isinstance(eng, Engine) else JAX_REGISTRY
    m = registry._metrics.get(name)
    return 0.0 if m is None else m.values.get((), 0.0)


# -- tests/engine/test_spec_decode.py ----------------------------------------------


def test_greedy_byte_identity_and_streams(trio):
    def case(eng, sp):
        out = []
        for p in ["abcabcabcabcabc", TOOL_ECHO[:30], "hello world"]:
            stream: list[int] = []
            r = eng.submit(p, sp(max_tokens=20), on_tokens=stream.extend).result(timeout=120)
            assert stream == list(r.tokens)  # streamed exactly once
            out.append(list(r.tokens))
        return out

    _out, d = _replay(trio, case)
    assert d["spec_dispatches"] > 0 and d["spec_accepted"] > 0
    assert trio.on.stats()["spec"]["enabled"] and not trio.off.stats()["spec"]["enabled"]


def test_json_constrained_greedy_identity(trio):
    def case(eng, sp):
        r = eng.generate("make json " + TOOL_ECHO[:20], sp(max_tokens=24, json_only=True))
        return list(r.tokens), r.finish_reason

    out, d = _replay(trio, case)
    assert d["spec_dispatches"] > 0
    assert out[0][0] == ord("{")


def test_max_tokens_budget_exact_with_multi_token_commits(trio):
    def case(eng, sp):
        r = eng.generate(TOOL_ECHO, sp(max_tokens=17))
        return list(r.tokens), r.finish_reason

    (tokens, reason), d = _replay(trio, case)
    assert d["spec_accepted"] > 0
    if reason == "length":
        assert len(tokens) == 17


def test_spec_composes_with_prefix_cache_hits(trio):
    turn1 = "sys: you are a tool agent. " + "abc" * 16
    turn2 = turn1 + " user: again again again"

    def case(eng, sp):
        eng.generate(turn1, sp(max_tokens=12))
        hits0 = eng._prefix_hits
        out = list(eng.generate(turn2, sp(max_tokens=12)).tokens)
        assert eng._prefix_hits > hits0, "turn 2 must hit the prefix cache"
        return out

    _replay(trio, case)


def test_tool_echo_tokens_per_decode_step_equal_the_reference(trio):
    """The reference's acceptance fixture (its 1.5 bar fails there): the
    same tokens per decode step and acceptance on both engines."""

    def case(eng, sp):
        before = _counter(eng, "acp_engine_spec_accepted_total")
        acc0 = eng.spec_accepted
        r = eng.generate(TOOL_ECHO, sp(max_tokens=120))
        if eng.spec_len:
            assert _counter(eng, "acp_engine_spec_accepted_total") - before == (
                eng.spec_accepted - acc0)
            assert 0.0 < eng.stats()["spec"]["acceptance_rate"] <= 1.0
        return list(r.tokens)

    tokens, d = _replay(trio, case)
    assert len(tokens) > 60
    assert d["tokens_generated"] / d["decode_steps"] > 1.0
    assert 0 < d["spec_accepted"] <= d["spec_proposed"]


def test_forced_full_rejection_is_byte_identical(trio):
    def case(eng, sp):
        base = list(eng.generate(TOOL_ECHO, sp(max_tokens=24)).tokens)
        acc0, disp0 = eng.spec_accepted, eng.spec_dispatches
        _reject(eng, 1000)
        forced = list(eng.generate(TOOL_ECHO, sp(max_tokens=24)).tokens)
        forced_acc, forced_disp = eng.spec_accepted - acc0, eng.spec_dispatches - disp0
        _unreject(eng)
        again = list(eng.generate(TOOL_ECHO, sp(max_tokens=24)).tokens)
        return base, forced, again, forced_acc, forced_disp > 0, eng.spec_accepted > acc0

    (base, forced, again, forced_acc, verified, recovered), _d = _replay(
        trio, case, streams=lambda out: out[:3])
    assert forced == base == again
    assert forced_acc == 0 and verified and recovered


def test_adaptive_decay_reaches_the_block_path(trio):
    def case(eng, sp):
        _reject(eng, 10_000)
        r = eng.generate(TOOL_ECHO, sp(max_tokens=80))
        _unreject(eng)
        return list(r.tokens)

    tokens, d = _replay(trio, case)
    assert len(tokens) > 0
    # 6 -> 3 -> 1 -> 0 after three rejections, then re-probes only
    assert 0 < d["spec_dispatches"] < 20 and d["spec_accepted"] == 0


def test_stress_oversubscribed_spec_preempt_mismatch(trio):
    """Four requests on a pool of nine pages, three forced rejections and a
    forced preemption once four decode steps ran: every stream equals its
    uncontended run, exactly once, and the pool comes back whole."""
    prompts = [ch * 20 for ch in "abcd"]
    holds: list = []

    def case(eng, sp):
        s = sp(max_tokens=10)
        solo = [list(eng.generate(p, s).tokens) for p in prompts]
        _idle(eng)
        holds.append(_Hold([eng], pages=9))
        _reject(eng, 3)
        _faults(eng).arm("engine.force_preempt", after_steps=4)
        streams = {p: [] for p in prompts}
        try:
            with eng.hold_admission():
                futs = [eng.submit(p, s, on_tokens=streams[p].extend) for p in prompts]
            res = [f.result(timeout=240) for f in futs]
        finally:
            _faults(eng).disarm("engine.force_preempt")
            holds.pop().release()
        for p, r in zip(prompts, res):
            assert streams[p] == list(r.tokens)
            assert r.finish_reason in ("stop", "length")
        return solo, [list(r.tokens) for r in res], sum(r.preempt_count for r in res)

    (solo, got, preempts), d = _replay(trio, case, streams=lambda out: out[:2])
    assert got == solo and preempts >= 1 and d["preemptions"] >= 1


@pytest.mark.parametrize("cls", [JaxEngine, Engine], ids=["reference", "port"])
def test_reclaim_floor_honors_in_flight_spec_dispatch_need(cls):
    """The reference's bare-object case on both engines' methods: a later
    slot's allocation in the same growth pass must not take back the pages
    an earlier slot was just given for its 1 + draft rows."""
    from agentcontrolplane_tpu.engine.engine import _Slot as JaxSlot
    from agentcontrolplane_tpu.ops.paged import PageAllocator as JaxAllocator

    slot_cls, alloc_cls = (JaxSlot, JaxAllocator) if cls is JaxEngine else (_Slot, PageAllocator)
    eng = cls.__new__(cls)
    eng.page_size, eng.decode_block_size, eng.max_pages_per_seq = 8, 4, 8
    eng._allocator = alloc_cls(4)  # pages 1..3 usable (0 = trash)
    eng._seq_lens = np.zeros(4, dtype=np.int32)
    eng._block_tables = np.full((4, 8), TRASH_PAGE, dtype=np.int32)
    eng._tables_dirty = False
    eng._slots = {0: slot_cls(request=None), 1: slot_cls(request=None)}
    eng._seq_lens[0] = 2
    eng._slot_pages = {0: eng._allocator.alloc(2), 1: eng._allocator.alloc(1)}
    eng._block_tables[0, :2] = eng._slot_pages[0]
    eng._block_tables[1, :1] = eng._slot_pages[1]
    # slot 0's floor is ceil((2 + max(4, 7)) / 8) = 2 pages: nothing to take
    assert eng._alloc_reclaiming_lookahead(1, 1, {0: 7, 1: 4}) is None
    assert len(eng._slot_pages[0]) == 2 and eng._block_tables[0, 1] != TRASH_PAGE
    # the plain block's floor is ceil((2 + 4) / 8) = 1 page: one comes back
    got = eng._alloc_reclaiming_lookahead(1, 1, None)
    assert got is not None and len(got) == 1
    assert len(eng._slot_pages[0]) == 1 and eng._block_tables[0, 1] == TRASH_PAGE


def test_ctx_edge_off_by_one_shared_geometry(trio):
    """A prompt near the 256-token edge (kept to its last 128 tokens)
    clips at prompt + generated == max_ctx on every engine."""

    def case(eng, sp):
        r = eng.generate(TOOL_ECHO * 3, sp(max_tokens=500))
        return list(r.tokens), r.finish_reason, r.prompt_tokens

    (tokens, reason, prompt_tokens), d = _replay(trio, case)
    if reason == "length" and len(tokens) < 500:
        assert prompt_tokens + len(tokens) == KW["max_ctx"]
    assert d["spec_dispatches"] > 0


# -- the other reference files --------------------------------------------------


def _busy(eng, sp, chunk: int = 16) -> list:
    """``test_torch_megastep.py``'s busy group, the prefix cache off as in
    the reference's megastep cases (a later run would hit the first's
    entries and chunk less)."""
    eng._prefix_enabled = False
    eng.prefill_chunk = chunk
    with eng.hold_admission():
        futs = [eng.submit(p, sp(max_tokens=m)) for p, m in BUSY]
    out = [list(f.result(timeout=300).tokens) for f in futs]
    _idle(eng)
    eng.prefill_chunk = 0
    return out


def _megastep_keys(eng) -> set:
    if isinstance(eng, Engine):
        return set(eng._megastep_shapes)
    return {f"megastep[{layout},{'+'.join(parts)}{tbl}]"
            for layout, parts, tbl in eng._megastep_shapes}


def test_megastep_busy_matrix_fused_equals_split_spec4(trio):
    """``test_megastep.py``'s busy matrix at ``spec_len=4``: chunks co-run
    with verify passes in fused cycles (``v<W>x5`` keys), fused = split,
    the same new fused keys on both spec engines."""
    keys = {}

    def case(eng, sp):
        if eng.spec_len:
            eng.spec_len = 4
        k0 = _megastep_keys(eng)
        fused = _busy(eng, sp)
        eng.megastep = False
        split = _busy(eng, sp)
        keys[("port" if isinstance(eng, Engine) else "ref", bool(eng.spec_len))] = (
            _megastep_keys(eng) - k0)
        return fused, split

    (fused, split), d = _replay(trio, case)
    assert fused == split
    assert d["megastep_dispatches"] > 0 and d["megastep_fallbacks"] == 0
    assert d["spec_dispatches"] > 0
    assert keys[("port", True)] == keys[("ref", True)]
    assert any(re.search(r"\+v\d+x5(\+tbl)?\]$", k) for k in keys[("port", True)])


def test_shape_bound_falls_back_to_split_dispatches_spec4(trio):
    """``megastep_max_programs=0`` at ``spec_len=4``: every fused cycle
    splits its chunks and then runs the verify pass alone on the lanes
    fixed before the fallback; streams equal the split path's."""
    verified_after_fallback = []

    def case(eng, sp):
        if eng.spec_len:
            eng.spec_len = 4
        eng.megastep = False
        split = _busy(eng, sp)
        eng.megastep, eng.megastep_max_programs = True, 0
        seen, eng._megastep_shapes = eng._megastep_shapes, set()
        fb0 = _counter(eng, "acp_engine_megastep_fallbacks_total")
        if eng is trio.on:
            real = eng._decode_spec

            def spy(pending=None):
                n0, v0 = eng.megastep_fallbacks, eng.spec_dispatches
                out = real(pending)
                verified_after_fallback.append(
                    eng.megastep_fallbacks > n0 and eng.spec_dispatches > v0)
                return out

            eng._decode_spec = spy
        try:
            bounded = _busy(eng, sp)
        finally:
            eng._megastep_shapes = seen
            if eng is trio.on:
                del eng._decode_spec
        return split, bounded, _counter(eng, "acp_engine_megastep_fallbacks_total") > fb0

    (split, bounded, counted), d = _replay(trio, case)
    assert bounded == split and counted
    assert d["megastep_dispatches"] == 0 and d["megastep_fallbacks"] > 0
    assert d["spec_dispatches"] > 0 and any(verified_after_fallback)


def test_chunked_identity_matrix_spec6(trio):
    """``test_chunked_prefill.py``'s matrix at ``spec_len=6``: chunks of 1
    (a page), 24 and 300 (the largest bucket) against chunking off."""
    prompts = ["hello world this is a test", "a" * 150, TOOL_ECHO]

    def case(eng, sp):
        s = sp(max_tokens=16)
        ref = [list(eng.generate(p, s).tokens) for p in prompts]
        out = []
        for chunk in (1, 24, 300):
            eng.prefill_chunk = chunk
            out.append([list(eng.generate(p, s).tokens) for p in prompts])
            eng.prefill_chunk = 0
        return ref, out

    (ref, chunked), d = _replay(trio, case)
    assert all(c == ref for c in chunked)
    assert d["prefill_chunks"] > 0 and d["spec_dispatches"] > 0


@pytest.mark.parametrize("prefill_chunk", [0, 16])
def test_quantized_kv_spec4_serves_deterministically(tables, prefill_chunk):
    """``test_quant_kv.py``'s cell at ``spec_len=4``: an int8 KV cache,
    greedy output repeated twice identical, speculating, equal to the JAX
    int8 engine's with equal spec counters."""
    weights = _weights()
    ref = JaxEngine(
        config=JCFG, params=jax.tree_util.tree_map(jnp.asarray, weights),
        tokenizer=JaxByteTokenizer(), mesh=make_mesh({"tp": 1}, devices=jax.devices()[:1]),
        kv_layout="paged", autopilot=False, spec_len=4, host_kv_bytes=0, quantize_kv=True,
        prefill_chunk=prefill_chunk, **KW)
    port = Engine(TCFG, params_from_jax(weights, TCFG, device="cpu"), device="cpu", spec_len=4,
                  quantize_kv=True, prefill_chunk=prefill_chunk, **KW)
    outs = []
    for eng in (ref, port):
        eng.start()
        try:
            sp = (SamplingParams if eng is port else JaxSampling)(max_tokens=10)
            r1 = eng.generate("abcabcabc " * 4, sp)
            r2 = eng.generate("abcabcabc " * 4, sp)
            assert r1.finish_reason in ("stop", "length") and r1.tokens == r2.tokens
            outs.append((list(r1.tokens), eng.spec_proposed, eng.spec_accepted,
                         eng.spec_dispatches, eng.decode_steps))
        finally:
            eng.stop()
    assert outs[0] == outs[1]
    assert outs[1][3] > 0


# -- the knobs -----------------------------------------------------------------------


def test_stats_defaults_and_flags_match_the_reference(trio):
    import inspect

    assert set(trio.on.stats()["spec"]) == set(trio.ref.stats()["spec"])
    assert trio.on.stats()["spec"]["spec_len"] == trio.ref.stats()["spec"]["spec_len"] == SPEC
    want = {"spec_len": 0, "spec_ngram": 3}
    for cls in (JaxEngine, Engine):
        params = inspect.signature(cls.__init__).parameters
        assert {k: params[k].default for k in want} == want
    with pytest.raises(ValueError, match="A.14"):
        Engine(TCFG, device="cpu", spec_len=2, group=SimpleNamespace(tp=2, sp=1))

    flags = ("tpu_spec_len", "tpu_spec_ngram")

    def run_flags(parser) -> dict:
        run = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction)).choices["run"]
        return {a.dest: (a.default, a.help) for a in run._actions if a.dest in flags}

    ours = run_flags(port_parser())
    assert len(ours) == len(flags) and ours == run_flags(ref_parser())
    args = port_parser().parse_args(["run", "--tpu-spec-len", "6", "--tpu-spec-ngram", "2"])
    assert (args.tpu_spec_len, args.tpu_spec_ngram) == (6, 2)


def test_run_builds_a_speculating_engine(monkeypatch, tmp_path):
    """``run --tpu-spec-len`` reaches the engine: ``cmd_run`` builds it with
    the flags and serves the operator until stopped."""
    from agentcontrolplane_tpu_torch import cli as port_cli
    from agentcontrolplane_tpu_torch import operator as port_operator

    built = {}

    class FakeEngine:
        def __init__(self, *args, **kw):
            built.update(kw)

        def start(self):
            pass

        def stop(self):
            pass

    async def no_serve():
        return None

    monkeypatch.setattr(port_engine_mod, "Engine", FakeEngine)
    monkeypatch.setattr(port_operator, "serve_until_signalled", no_serve)
    args = port_parser().parse_args(["run", "--db", str(tmp_path / "acp.db"), "--tpu-preset",
                                     "tiny", "--device", "cpu", "--tpu-spec-len", "6",
                                     "--tpu-spec-ngram", "2", "--port", "0"])
    port_cli.cmd_run(args)
    assert (built["spec_len"], built["spec_ngram"]) == (6, 2)
