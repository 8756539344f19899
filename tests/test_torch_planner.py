"""The chunk-rate planner on the CPU: the port's ``engine/planner.py``
against the reference's function by function, and the port's engine
against the JAX package's paged engine (both at their defaults: megastep
and rate planner on), replaying ``tests/engine/test_planner.py``.

The engine cases run one module-scoped pair on the tiny f32 preset (the
weights and helpers of ``tests/test_torch_chunked.py``), the prefix cache
off. The planner reads the wall clock, so a case seeds both engines' cycle
clocks with 10 s a cycle (large against the admission delay) and gives
deadlines whose ``floor(seconds_left / cycle_s)`` cannot change between
submit and admission. No case gates on a deadline being met in wall time.
The port's quotas are read off its slots at each projection, the
reference's from its flight recorder's ``quota`` events, and both
engines' chunk sizes from the chunks recorded as dispatched.

Not replayed here, each for its reason:

- ``test_planner_meets_deadline_flat_cadence_would_miss``: it gates on
  wall-clock expiry against 20 ms stalls, and fails in loaded runs of the
  reference's own suite; the arithmetic it stands for is gated here by
  quotas, chunk sizes and cycle counts;
- ``test_timeline_surfaces_rate_plan`` and
  ``test_autopilot_engine_applies_and_flight_records``: they read the
  flight recorder and are replayed with it in ``tests/test_torch_flight.py``;
  ``recommend`` and ``Autopilot`` themselves are compared below.
"""

import itertools
import random
from types import SimpleNamespace

import pytest

import jax
import jax.numpy as jnp

from agentcontrolplane_tpu.engine import planner as ref_planner
from agentcontrolplane_tpu.engine.engine import Engine as JaxEngine
from agentcontrolplane_tpu.engine.engine import SamplingParams as JaxSampling
from agentcontrolplane_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from agentcontrolplane_tpu.observability.metrics import REGISTRY as JAX_REGISTRY
from agentcontrolplane_tpu.parallel.mesh import make_mesh
from agentcontrolplane_tpu_torch.engine import planner as port_planner
from agentcontrolplane_tpu_torch.engine.engine import Engine, SamplingParams
from agentcontrolplane_tpu_torch.engine.weights import params_from_jax
from agentcontrolplane_tpu_torch.observability.metrics import REGISTRY as PORT_REGISTRY
from agentcontrolplane_tpu_torch.parallel.mesh import ServingGroup

from .test_torch_chunked import JCFG, KW, TCFG, _drop_parked, _Hold, _idle, _row, _weights

CYCLE_S = 10.0  # the seeded cycle time
CHUNK = 8
LARGEST = KW["prefill_buckets"][-1]

# -- the module against the reference's --------------------------------------

QUOTA_GRID = list(itertools.product(
    (0, 1, 15, 16, 17, 200, 4096),  # tokens left
    (0, 1, 8, 16, 256),  # chunk
    (None, -1.0, 0.0, 1e-3, 0.05, 0.5, 3.0, 60.0),  # seconds left
    (0.0, 1e-7, 0.05, 0.5),  # cycle seconds
))


@pytest.mark.parametrize("max_quota,slack", [(8, 2), (1, 2), (64, 0), (8, 5)])
def test_project_quota_matches_the_reference(max_quota, slack):
    """Every edge: no deadline, past and zero deadlines, nothing left, a
    zero chunk, a zero or tiny clock, the cap and the slack."""
    for tokens, chunk, left, cycle in QUOTA_GRID:
        args = (tokens, chunk, left, cycle)
        kw = dict(max_quota=max_quota, slack_cycles=slack)
        assert port_planner.project_quota(*args, **kw) == ref_planner.project_quota(*args, **kw), (
            args, kw)
    assert port_planner.project_quota(200, 16, 0.5, 0.05) == 2  # the reference's worked case


@pytest.mark.parametrize("alpha", [0.1, 0.5, 1.0])
def test_cycle_clock_matches_the_reference(alpha):
    """Seeding, decay, and ignored non-positive samples, sample by
    sample."""
    rnd = random.Random(int(alpha * 10))
    samples = [0.0, -1.0] + [rnd.choice([-0.5, 0.0, 1e-4, 0.02, 0.3, 5.0]) for _ in range(200)]
    ours, theirs = port_planner.CycleClock(alpha), ref_planner.CycleClock(alpha)
    assert ours.cycle_s == theirs.cycle_s == 0.0
    for dt in samples:
        ours.observe(dt)
        theirs.observe(dt)
        assert ours.cycle_s == theirs.cycle_s


LIMITS = dict(chunk_min=8, chunk_max=256, budget_max=2048, spec_len_max=16)  # the reference's
PHASES = [
    {},
    {"prefill": 2.0, "queue_wait": 0.1, "decode": 0.5, "preempt_stall": 0.0},
    {"prefill": 0.1, "queue_wait": 2.0, "decode": 0.5, "preempt_stall": 0.0},
    {"prefill": 0.1, "queue_wait": 0.1, "decode": 0.5, "preempt_stall": 0.4},
    {"prefill": 0.2, "queue_wait": 0.2, "decode": 0.5, "preempt_stall": 0.0},
    {"prefill": 0.0, "queue_wait": 0.0, "decode": 0.0, "preempt_stall": 0.0},
]


@pytest.mark.parametrize("phases", PHASES, ids=[f"phases{i}" for i in range(len(PHASES))])
def test_recommend_matches_the_reference(phases):
    """Over utilizations, acceptances and knobs (the chunk and the spec
    length at and past their limits, auto and explicit budgets)."""
    ours_limits = port_planner.AutopilotLimits(**LIMITS)
    ref_limits = ref_planner.AutopilotLimits(**LIMITS)
    for util, acc, chunk, budget, spec in itertools.product(
            (0.0, 0.5, 0.95, 0.99, 1.0), (None, 0.0, 0.1, 0.3, 0.5, 0.7, 0.9, 1.0),
            (0, 8, 32, 256), (0, 128, 2047, 2048), (0, 1, 4, 16)):
        knobs = {"prefill_chunk": chunk, "token_budget": budget, "spec_len": spec}
        assert (port_planner.recommend(phases, util, acc, knobs, ours_limits)
                == ref_planner.recommend(phases, util, acc, knobs, ref_limits)), (util, acc, knobs)


def test_autopilot_due_and_step_match_the_reference():
    ours = port_planner.Autopilot(port_planner.AutopilotLimits(**LIMITS), interval=3)
    theirs = ref_planner.Autopilot(ref_planner.AutopilotLimits(**LIMITS), interval=3)
    knobs = {"prefill_chunk": 32, "token_budget": 128, "spec_len": 4}
    for i in range(12):
        assert ours.due() == theirs.due()
        phases = PHASES[i % len(PHASES)]
        acc = (None, 0.1, 0.5, 0.9)[i % 4]
        assert ours.step(phases, 0.99, acc, knobs) == theirs.step(phases, 0.99, acc, knobs)
        assert (ours.cycles, ours.adjustments) == (theirs.cycles, theirs.adjustments)
    assert ours.adjustments > 0
    assert port_planner.Autopilot(port_planner.AutopilotLimits(**LIMITS), interval=0).interval == 1


# -- the engines ---------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    weights = _weights()
    ref = JaxEngine(
        config=JCFG, params=jax.tree_util.tree_map(jnp.asarray, weights),
        tokenizer=JaxByteTokenizer(), mesh=make_mesh({"tp": 1}, devices=jax.devices()[:1]),
        kv_layout="paged", spec_len=0, host_kv_bytes=0, prefix_cache_entries=0, **KW,
    )
    port = Engine(TCFG, params_from_jax(weights, TCFG, device="cpu"), device="cpu",
                  prefix_cache_entries=0, **KW)
    # (rid, quota, reason, projected) of each port plan: ``projected`` where
    # a rate plan was made (the reference records those alone)
    plans: list = []
    real_project, real_record = port._project_quota, port._record_chunk_round
    chunks: list = []  # (rid, n) of each port chunk that dispatched

    def project(slot, sl, reason):
        n0 = port.quota_projections
        real_project(slot, sl, reason)
        plans.append((sl.request.rid, sl.chunk_quota, reason, port.quota_projections > n0))

    def record(landed, rnd):
        chunks.extend((sl.request.rid, n) for _slot, sl, _st, n in landed)
        real_record(landed, rnd)

    port._project_quota, port._record_chunk_round = project, record
    ref.start()
    port.start()
    try:
        yield SimpleNamespace(ref=ref, port=port, plans=plans, chunks=chunks)
    finally:
        ref.stop()
        port.stop()


@pytest.fixture
def pair(engines):
    for eng in (engines.ref, engines.port):
        _idle(eng)
        _drop_parked(eng)
    yield engines
    for eng in (engines.ref, engines.port):
        _idle(eng)
        _drop_parked(eng)
        eng.prefill_chunk, eng.token_budget, eng.rate_planner = 0, 0, True
        assert eng._allocator.free_count == eng.num_pages - 1
        assert len(eng._free) == eng.max_slots


def _seed_clock(eng) -> None:
    """Seed the cycle clock (the engine idles, so its thread observes
    nothing until the next request is admitted)."""
    _idle(eng)
    eng._cycle_clock.cycle_s = CYCLE_S


def _plan(pair, eng, fut) -> tuple:
    """(quotas, reasons, chunk sizes) of one request on either engine."""
    if isinstance(eng, Engine):
        mine = [(q, r) for rid, q, r, projected in pair.plans if rid == fut.rid and projected]
        sizes = [n for rid, n in pair.chunks if rid == fut.rid]
    else:
        events = eng.flight.events(last=0, kind="quota", rid=fut.rid)
        mine = [(e["detail"]["quota"], e["detail"]["reason"]) for e in events]
        sizes = [e["detail"]["n"] for e in eng.flight.events(last=0, kind="prefill_chunk",
                                                               rid=fut.rid)]
    return [q for q, _ in mine], [r for _, r in mine], sizes


def _planner_stats(eng) -> dict:
    return dict(eng.stats()["scheduler"]["planner"])


def _both(pair, case) -> tuple:
    """Run ``case(engine, SamplingParams class)`` on the reference, then on
    the port: equal outcomes and equal planner-stat deltas."""
    out, deltas = [], []
    for eng, sp in ((pair.ref, JaxSampling), (pair.port, SamplingParams)):
        s0 = _planner_stats(eng)
        out.append(case(eng, sp))
        _idle(eng)
        s1 = _planner_stats(eng)
        deltas.append({k: s1[k] - s0[k] if isinstance(s1[k], int) and not isinstance(s1[k], bool)
                       else s1[k] for k in s1})
    assert out[0] == out[1]
    assert deltas[0] == deltas[1]
    return out[1], deltas[1]


ROW = _row(200, salt=5)  # 25 chunks of 8


def test_deadline_quota_sizes_chunks_and_cuts_cycles(pair):
    """A 200-token row with 95 s left at 10 s a cycle: 7 cycles after the
    slack, so a quota of ceil(25 / 7) = 4; chunks of 4 x 8 = 32 tokens
    (under the largest bucket), the prefill done in ceil(25 / 4) = 7
    cycles against 25 with the planner off, the same tokens."""
    chunks = -(-len(ROW) // CHUNK)

    def case(eng, sp):
        out = {}
        for planner in (True, False):
            eng.prefill_chunk, eng.rate_planner = CHUNK, planner
            _seed_clock(eng)
            fut = eng.submit(ROW, sp(max_tokens=6), timeout_s=95.0)
            tokens = list(fut.result(timeout=180).tokens)
            _idle(eng)
            out[planner] = (tokens, *_plan(pair, eng, fut))
        return out

    out, d = _both(pair, case)
    (on_tokens, quotas, reasons, on_sizes), (off_tokens, _, _, off_sizes) = out[True], out[False]
    assert quotas == [4] and reasons == ["admit"]
    assert on_sizes == [min(4 * CHUNK, LARGEST)] * 6 + [len(ROW) - 6 * 32]
    assert len(on_sizes) == -(-chunks // 4) and off_sizes == [CHUNK] * chunks
    assert on_tokens == off_tokens
    assert d["quota_projections"] == 1 and d["quota_reprojections"] == 0


def test_quota_capped_at_max_and_the_largest_bucket(pair):
    """15 s left: one cycle after the slack, a quota of 25 capped at
    ``planner_max_quota`` 8, so chunks of min(8 x 16, 128) = 128 tokens."""

    def case(eng, sp):
        eng.prefill_chunk = 16
        _seed_clock(eng)
        fut = eng.submit(ROW, sp(max_tokens=4), timeout_s=35.0)
        tokens = list(fut.result(timeout=180).tokens)
        return tokens, *_plan(pair, eng, fut)

    (_tokens, quotas, reasons, sizes), d = _both(pair, case)
    assert quotas == [8] and reasons == ["admit"] and sizes == [LARGEST, len(ROW) - LARGEST]
    assert d["quota_projections"] == 1


def test_no_deadline_keeps_quota_one(pair):
    def case(eng, sp):
        eng.prefill_chunk = CHUNK
        _seed_clock(eng)
        fut = eng.submit(_row(100, salt=6), sp(max_tokens=4))
        tokens = list(fut.result(timeout=180).tokens)
        quotas, _reasons, sizes = _plan(pair, eng, fut)
        return tokens, quotas, max(sizes)

    (_tokens, quotas, largest), d = _both(pair, case)
    assert quotas == [] and largest == CHUNK
    assert d["quota_projections"] == 0
    assert [(q, projected) for _rid, q, _r, projected in pair.plans[-1:]] == [(1, False)]


def test_preempt_resume_reprojects(pair):
    """Pool pressure preempts a deadline row mid-prefill (a decoder's page
    crossing on a six-page pool; the budget lets both start in the first
    cycle): its re-admission reprojects, once, with the reason
    ``resume``, on both engines, and the streams equal their uncontended
    runs."""
    holds: list = []

    def case(eng, sp):
        burst = [("d" * 7, None), ("r" * 40, 45.0)]
        solo = [list(eng.generate(p, sp(max_tokens=8)).tokens) for p, _ in burst]
        holds.append(_Hold([eng], pages=6))
        eng.prefill_chunk, eng.token_budget = CHUNK, 1000
        _seed_clock(eng)
        counter0 = _counter(eng, "acp_engine_quota_reprojections_total")
        with eng.hold_admission():
            futs = [eng.submit(p, sp(max_tokens=24 if t is None else 8), timeout_s=t)
                    for p, t in burst]
        got = [f.result(timeout=180) for f in futs]
        _quotas, reasons, _sizes = _plan(pair, eng, futs[1])
        counted = _counter(eng, "acp_engine_quota_reprojections_total") - counter0
        return ([list(got[0].tokens)[:8], list(got[1].tokens)] == solo, reasons,
                [r.preempt_count for r in got], counted)

    try:
        (same, reasons, preempts, counted), d = _both(pair, case)
    finally:
        for h in holds:
            h.release()
    assert same and reasons == ["admit", "resume"] and preempts == [0, 1]
    assert d["quota_reprojections"] == 1 and counted == 1


def test_park_adopt_reprojects_with_reason_adopt(pair):
    turn1 = "persona prompt " * 4
    turn2 = turn1 + " and then some follow up words, " * 3

    def case(eng, sp):
        eng.prefill_chunk = CHUNK
        eng.submit(turn1, sp(max_tokens=6), park=True).result(timeout=180)
        _seed_clock(eng)
        a0 = eng.park_adoptions
        fut = eng.submit(turn2, sp(max_tokens=6), timeout_s=95.0)
        tokens = list(fut.result(timeout=180).tokens)
        _quotas, reasons, _sizes = _plan(pair, eng, fut)
        return tokens, reasons, eng.park_adoptions - a0

    (_tokens, reasons, adopted), d = _both(pair, case)
    assert adopted == 1 and reasons == ["adopt"]
    assert d["quota_projections"] == 1 and d["quota_reprojections"] == 1


def test_planner_is_inert_under_a_group():
    """Deadlines are the leader's clock: an engine with a serving group
    keeps every quota at 1 and projects nothing, whatever the deadline."""
    group = ServingGroup(tp=1, sp=1, rank=0, tp_rank=0, sp_rank=0)
    eng = Engine(TCFG, params_from_jax(_weights(), TCFG, device="cpu"), device="cpu",
                 group=group, prefill_chunk=CHUNK, prefix_cache_entries=0, **KW)
    eng._cycle_clock.cycle_s = CYCLE_S
    eng.start()
    try:
        eng.submit(ROW, SamplingParams(max_tokens=2), timeout_s=35.0).result(timeout=120)
        planner = eng.stats()["scheduler"]["planner"]
        assert planner["quota_projections"] == 0 and planner["enabled"] is True
        assert eng.prefill_chunks == -(-len(ROW) // CHUNK)
    finally:
        eng.stop()


def _counter(eng, name: str) -> float:
    registry = PORT_REGISTRY if isinstance(eng, Engine) else JAX_REGISTRY
    m = registry._metrics.get(name)
    return 0.0 if m is None else m.values.get((), 0.0)
