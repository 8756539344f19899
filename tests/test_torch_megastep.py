"""The fused megastep on the CPU: the port's engine against the JAX
package's paged engine, both with ``megastep=True`` and
``rate_planner=True`` (their defaults), replaying
``tests/engine/test_megastep.py`` on the paged layout with ``spec_len=0``.

One module-scoped pair on the tiny f32 preset with the same weights (as
``tests/test_torch_chunked.py``, whose helpers this file reuses), the
prefix cache off as in the reference's cases. A case runs on both engines;
their greedy streams must be byte-identical, and so must the fused
dispatches, the fallbacks, the fused shapes' keys (the reference's shape
tuples spelled as its program keys) and the chunk, share, preemption and
adoption counters. Fused must equal split (``megastep=False``) on the
port, and on the reference where a case runs both. Every model call of
the port is checked against the shared-page rule (``_SharedPageChecks``).

Not replayed, each for its reason:

- ``test_inactive_lane_decode_write_clamps_to_unread_row``: the slot
  layout (ROADMAP A.10), and the reference fails it;
- ``test_pad_fuse_waste_row_populates_and_conserves``: the goodput ledger
  is the profiler's (A.11);
- the two prewarm cases: prewarm is A.3;
- the ``spec_len=4`` cases: they are replayed in ``tests/test_torch_spec.py``;
- the slot-layout cells of the busy matrix and the park-adopt case (A.10).
"""

import time
from types import SimpleNamespace

import pytest

import jax
import jax.numpy as jnp

from agentcontrolplane_tpu.engine.engine import Engine as JaxEngine
from agentcontrolplane_tpu.engine.engine import SamplingParams as JaxSampling
from agentcontrolplane_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from agentcontrolplane_tpu.observability.metrics import REGISTRY as JAX_REGISTRY
from agentcontrolplane_tpu.parallel.mesh import make_mesh
from agentcontrolplane_tpu_torch.engine import engine as port_engine_mod
from agentcontrolplane_tpu_torch.engine.engine import Engine, SamplingParams
from agentcontrolplane_tpu_torch.engine.weights import params_from_jax
from agentcontrolplane_tpu_torch.observability.metrics import REGISTRY as PORT_REGISTRY

from .test_torch_chunked import (
    JCFG,
    KW,
    PERSONA,
    TAILS,
    TCFG,
    _drop_parked,
    _Hold,
    _idle,
    _SharedPageChecks,
    _weights,
)

ATTRACTOR = "abcabcabc " * 8  # 80 tokens: five 16-token chunks
# the busy workload admitted as one group: three rows that chunk, one short
# enough to be a plain final (its whole row one chunk)
BUSY = [(ATTRACTOR, 30), ("the quick brown fox jumps over " * 4, 10),
        ("pack my box with five dozen jugs " * 3, 10), ("hi, a short one", 8)]
MODEL_CALLS = ("decode_step_paged", "prefill_paged_batch", "prefill_paged_continue",
               "prefill_paged_continue_kv")
SPLIT_DISPATCHES = ("_chunk_dispatch", "_prefill_group", "_decode_dispatch",
                    "_spill_long_chunks")


@pytest.fixture(scope="module")
def engines():
    weights = _weights()
    ref = JaxEngine(
        config=JCFG, params=jax.tree_util.tree_map(jnp.asarray, weights),
        tokenizer=JaxByteTokenizer(), mesh=make_mesh({"tp": 1}, devices=jax.devices()[:1]),
        kv_layout="paged", megastep=True, rate_planner=True, autopilot=False, spec_len=0,
        host_kv_bytes=0, prefix_cache_entries=0, **KW,
    )
    port = Engine(TCFG, params_from_jax(weights, TCFG, device="cpu"), device="cpu",
                  prefix_cache_entries=0, **KW)
    checks = _SharedPageChecks(port)
    real = {name: getattr(port_engine_mod, name) for name in MODEL_CALLS}

    def decode(params, pages, tokens, seq_lens, block_tables, active, config, group=None):
        checks.step(seq_lens, block_tables, active)
        return real["decode_step_paged"](params, pages, tokens, seq_lens, block_tables, active,
                                         config, group=group)

    def writer(name, ids_at):
        def call(*args, **kw):
            checks.prefill(args[ids_at])
            return real[name](*args, **kw)
        return call

    port_engine_mod.decode_step_paged = decode
    port_engine_mod.prefill_paged_batch = writer("prefill_paged_batch", 4)
    port_engine_mod.prefill_paged_continue = writer("prefill_paged_continue", 5)
    port_engine_mod.prefill_paged_continue_kv = writer("prefill_paged_continue_kv", 5)
    ref.start()
    port.start()
    try:
        yield SimpleNamespace(ref=ref, port=port, checks=checks)
    finally:
        for name, fn in real.items():
            setattr(port_engine_mod, name, fn)
        ref.stop()
        port.stop()


def _rest(eng) -> None:
    _idle(eng)
    _drop_parked(eng)
    eng.prefill_chunk, eng.token_budget, eng.prefix_dedup = 0, 0, True
    eng.megastep, eng.megastep_max_programs = True, 32


@pytest.fixture
def pair(engines):
    """The module's engines at rest and at their defaults before and after
    a case; the pool and the slots whole after it, the port's checks
    clean."""
    for eng in (engines.ref, engines.port):
        _rest(eng)
    n0 = len(engines.checks.violations)
    yield engines
    for eng in (engines.ref, engines.port):
        _rest(eng)
        assert eng._allocator.free_count == eng.num_pages - 1
        assert len(eng._free) == eng.max_slots
    assert engines.checks.violations[n0:] == []


def _keys(eng) -> set:
    """The fused shapes seen, as program keys (the reference keeps tuples)."""
    if isinstance(eng, Engine):
        return set(eng._megastep_shapes)
    return {f"megastep[{layout},{'+'.join(parts)}{tbl}]"
            for layout, parts, tbl in eng._megastep_shapes}


def _counters(eng) -> dict:
    return {"dispatches": eng.megastep_dispatches, "fallbacks": eng.megastep_fallbacks,
            "prefill_chunks": eng.prefill_chunks, "prefix_shares": eng.prefix_shares,
            "preemptions": eng.preemptions, "park_adoptions": eng.park_adoptions}


def _both(pair, case) -> tuple:
    """Run ``case(engine, SamplingParams class)`` on the reference, then on
    the port: equal outcomes, equal counter deltas and the same new fused
    shapes. Returns the port's outcome and deltas."""
    out, deltas, keys = [], [], []
    for eng, sp in ((pair.ref, JaxSampling), (pair.port, SamplingParams)):
        c0, k0 = _counters(eng), _keys(eng)
        out.append(case(eng, sp))
        _idle(eng)
        c1 = _counters(eng)
        deltas.append({k: c1[k] - c0[k] for k in c0})
        keys.append(_keys(eng) - k0)
    assert out[0] == out[1]
    assert deltas[0] == deltas[1]
    assert keys[0] == keys[1]
    return out[1], deltas[1]


def _busy(eng, sp, chunk: int = 16) -> list:
    eng.prefill_chunk = chunk
    with eng.hold_admission():
        futs = [eng.submit(p, sp(max_tokens=m)) for p, m in BUSY]
    out = [list(f.result(timeout=300).tokens) for f in futs]
    _idle(eng)
    eng.prefill_chunk = 0
    return out


def _counter(registry, name: str) -> float:
    m = registry._metrics.get(name)
    return 0.0 if m is None else m.values.get((), 0.0)


def test_busy_matrix_fused_equals_split_and_the_reference(pair):
    """Chunks of 16 co-running with decode (mid chunks, a plain final,
    continuation finals and decode blocks in one cycle): the fused streams
    equal the split ones on each engine, the port's equal the reference's,
    with the same fused dispatches and shapes."""

    def case(eng, sp):
        fused = _busy(eng, sp)
        d0 = eng.megastep_dispatches
        eng.megastep = False
        split = _busy(eng, sp)
        assert eng.megastep_dispatches == d0
        return fused, split

    (fused, split), d = _both(pair, case)
    assert fused == split
    assert d["dispatches"] > 0 and d["fallbacks"] == 0
    keys = _keys(pair.port)
    assert any("+p32x1" in k for k in keys) and any("+d" in k and "m32" in k for k in keys)


def test_park_adopt_under_fusion(pair):
    """A parked turn adopted by the next, chunked and fused: both turns
    equal the unchunked, unfused engine's."""
    turn1 = "persona prompt " * 4
    turn2 = turn1 + " and then some follow up words"

    def case(eng, sp):
        def run(mega, chunk):
            eng.megastep, eng.prefill_chunk = mega, chunk
            r1 = eng.submit(turn1, sp(max_tokens=12), park=True).result(timeout=180)
            a0 = eng.park_adoptions
            r2 = eng.submit(turn2, sp(max_tokens=12)).result(timeout=180)
            adopted = eng.park_adoptions - a0
            _idle(eng)
            _drop_parked(eng)
            return list(r1.tokens), list(r2.tokens), adopted

        plain = run(False, 0)
        fused = run(True, 12)
        return plain, fused

    (plain, fused), d = _both(pair, case)
    assert fused == plain and fused[2] == 1
    assert d["dispatches"] > 0


def test_shape_bound_falls_back_to_split_dispatches(pair):
    """``megastep_max_programs=0``: every fused cycle runs the split
    dispatches and counts a fallback (and the metric), none fuses, and the
    streams equal the split path's."""

    def case(eng, sp):
        eng.megastep = False
        split = _busy(eng, sp)
        eng.megastep, eng.megastep_max_programs = True, 0
        seen, eng._megastep_shapes = eng._megastep_shapes, set()
        fb0 = _counter(PORT_REGISTRY if isinstance(eng, Engine) else JAX_REGISTRY,
                       "acp_engine_megastep_fallbacks_total")
        try:
            bounded = _busy(eng, sp)
        finally:
            eng._megastep_shapes = seen
        fb1 = _counter(PORT_REGISTRY if isinstance(eng, Engine) else JAX_REGISTRY,
                       "acp_engine_megastep_fallbacks_total")
        return split, bounded, fb1 > fb0

    (split, bounded, counted), d = _both(pair, case)
    assert bounded == split and counted
    assert d["dispatches"] == 0 and d["fallbacks"] > 0


def test_busy_cycle_is_one_dispatch(pair):
    """While chunks co-run with decode, no split dispatch runs: the port's
    split chunk, prefill and decode dispatches are never called with a
    slot mid-prefill, while the fused dispatches rise."""
    eng = pair.port
    calls = {name: 0 for name in SPLIT_DISPATCHES}
    real = {name: getattr(eng, name) for name in SPLIT_DISPATCHES}

    def counted(name):
        def call(*args, **kw):
            if eng._prefilling_count:
                calls[name] += 1
            return real[name](*args, **kw)
        return call

    for name in SPLIT_DISPATCHES:
        setattr(eng, name, counted(name))
    try:
        eng.prefill_chunk = 8
        anchor = eng.submit(ATTRACTOR, SamplingParams(max_tokens=40))
        deadline = time.monotonic() + 120
        while eng.decode_steps == 0 or eng._prefilling_count:
            assert time.monotonic() < deadline
            time.sleep(0.001)
        d0 = eng.megastep_dispatches
        long = eng.submit("w" * 110, SamplingParams(max_tokens=6))
        long.result(timeout=180)
        busy = eng.megastep_dispatches - d0
        anchor.result(timeout=180)
    finally:
        for name in SPLIT_DISPATCHES:
            delattr(eng, name)
    assert busy >= -(-110 // 8) and calls == {name: 0 for name in SPLIT_DISPATCHES}


@pytest.mark.parametrize("prefill_chunk", [0, 16])
def test_dedup_burst_through_fused_cycles(pair, prefill_chunk):
    """A burst of four on one persona: three followers share the leader's
    pages and dispatch their suffixes in fused cycles once it has written
    them (a leader mid-prefill with chunks of 16); every stream equals the
    request served alone, and the port's checks saw prefill writes into
    shared pages and no breach of the rule."""
    n0 = pair.checks.shared_prefill_writes

    def case(eng, sp):
        solo = [list(eng.generate(PERSONA + t, sp(max_tokens=8)).tokens) for t in TAILS]
        eng.prefill_chunk = prefill_chunk
        with eng.hold_admission():
            futs = [eng.submit(PERSONA + t, sp(max_tokens=8)) for t in TAILS]
        return solo, [list(f.result(timeout=180).tokens) for f in futs]

    (solo, burst), d = _both(pair, case)
    assert burst == solo
    assert d["prefix_shares"] == len(TAILS) - 1 and d["dispatches"] > 0
    if prefill_chunk:
        assert pair.checks.shared_prefill_writes > n0


def test_preempted_planned_lane_is_dropped(pair):
    """A prefilling slot preempted after its chunk was planned: on a pool
    of six pages a decoder's first page crossing preempts the 40-token row
    (it has sampled nothing), whose planned lane is dropped before the
    fused dispatch and never writes; it resumes once the decoder is done,
    both streams equal their uncontended runs, and the pool is whole."""
    dropped: list = []
    real = pair.port._validate_pending

    def spy(pending):
        before = sum(len(pending[k]) for k in ("mids", "plains", "finals"))
        real(pending)
        dropped.append(before - sum(len(pending[k]) for k in ("mids", "plains", "finals")))

    holds: list = []
    burst = [("d" * 7, 24), ("r" * 40, 8)]

    def case(eng, sp):
        solo = [list(eng.generate(p, sp(max_tokens=m)).tokens) for p, m in burst]
        _idle(eng)
        holds.append(_Hold([eng], pages=6))
        eng.prefill_chunk = 8
        with eng.hold_admission():
            futs = [eng.submit(p, sp(max_tokens=m)) for p, m in burst]
        got = [f.result(timeout=180) for f in futs]
        return solo, [list(r.tokens) for r in got], [r.preempt_count for r in got]

    pair.port._validate_pending = spy
    try:
        (solo, got, preempts), d = _both(pair, case)
    finally:
        del pair.port._validate_pending
        for h in holds:
            h.release()
    assert got == solo and preempts == [0, 1] and d["preemptions"] == 1
    assert sum(dropped) >= 1
