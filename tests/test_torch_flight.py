"""The flight recorder on the CPU: the port's ``observability/flight.py``
against the reference's, and the port's engine against the JAX package's
paged engine, replaying ``tests/engine/test_flight.py``.

- The recorder's own cases (disabled, the env knob, the window and the
  finished-timeline LRU, the per-request cap, ``attribute_phases`` on
  hand-made histories, no dump without ``$ACP_FLIGHT_DUMP_DIR``) run the
  same calls on both classes and must give the same results.
- The engine cases run one module-scoped pair on the tiny f32 preset with
  the same weights (the JAX engine on a one-rank mesh and the port's),
  the reference's test configuration. For each request the sequence of
  event kinds must equal the reference's, with equal slots and equal
  ``detail`` fields; timestamps, stall seconds and rids are not compared.
  Each admitted request's phase windows must sum to its submit -> end
  wall within 1e-6 s. The reference's tight pool (``kv_pages=10``) is made by holding
  pages while the engines idle.
- The crash dump (``engine.invariant_break`` with the dump directory set)
  and recovery run on both engines, each armed on its own package's
  ``FAULTS``; ``TPUEngineClient(trace_context=...)`` yields engine child
  spans; the planner's ``rate_plan`` timeline block and the autopilot's
  engine loop (``tests/engine/test_planner.py``) run on both engines.
"""

import dataclasses
import glob
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from agentcontrolplane_tpu.engine.engine import Engine as JaxEngine
from agentcontrolplane_tpu.engine.engine import SamplingParams as JaxSampling
from agentcontrolplane_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from agentcontrolplane_tpu.models import llama as jl
from agentcontrolplane_tpu.observability import flight as ref_flight
from agentcontrolplane_tpu.observability.metrics import REGISTRY as JAX_REGISTRY
from agentcontrolplane_tpu.observability.tracing import Tracer as JaxTracer
from agentcontrolplane_tpu.parallel.mesh import make_mesh
from agentcontrolplane_tpu.testing import FAULTS
from agentcontrolplane_tpu_torch.engine.client import TPUEngineClient
from agentcontrolplane_tpu_torch.engine.engine import Engine, SamplingParams
from agentcontrolplane_tpu_torch.engine.types import BaseConfig, Message
from agentcontrolplane_tpu_torch.engine.weights import params_from_jax
from agentcontrolplane_tpu_torch.faults import FAULTS as PORT_FAULTS
from agentcontrolplane_tpu_torch.models import llama as tl
from agentcontrolplane_tpu_torch.observability import flight as port_flight
from agentcontrolplane_tpu_torch.observability.metrics import REGISTRY as PORT_REGISTRY
from agentcontrolplane_tpu_torch.observability.tracing import Tracer as PortTracer

from .test_torch_chunked import _drop_parked, _Hold, _idle

# the reference's test configuration (tests/engine/test_flight.py)
JCFG = dataclasses.replace(jl.PRESETS["tiny"], vocab_size=512, max_seq_len=256, n_kv_heads=2)
TCFG = dataclasses.replace(tl.PRESETS["tiny"], vocab_size=512, max_seq_len=256, n_kv_heads=2)
KW = dict(max_slots=4, max_ctx=64, prefill_buckets=(32, 64), decode_block_size=4, page_size=8,
          kv_pages=33)
EOT = 260  # ByteTokenizer's <|eot_id|>, a stop token
PROMPTS = [ch * 20 for ch in "abcdef"]
TERMINAL = ("finish", "expire", "cancel", "shed")
# detail fields that are clocks (or another request's id), not decisions
VOLATILE = {"stall_s", "seconds_left", "leader", "error"}


def _weights() -> dict:
    p = jax.tree_util.tree_map(np.array, jl.init_params(JCFG, jax.random.key(0)))
    p["lm_head"][:, EOT] = p["lm_head"][:, 289] * 1.05
    return p


def ref_engine(weights, **kw) -> JaxEngine:
    return JaxEngine(
        config=JCFG, params=jax.tree_util.tree_map(jnp.asarray, weights),
        tokenizer=JaxByteTokenizer(), mesh=make_mesh({"tp": 1}, devices=jax.devices()[:1]),
        kv_layout="paged", **{"spec_len": 0, **KW, **kw},
    )


def port_engine(params, **kw) -> Engine:
    return Engine(TCFG, params, device="cpu", **{**KW, **kw})


def is_port(eng) -> bool:
    return isinstance(eng, Engine)


def faults(eng):
    """The fault injector of ``eng``'s package."""
    return PORT_FAULTS if is_port(eng) else FAULTS


def registry(eng):
    return PORT_REGISTRY if is_port(eng) else JAX_REGISTRY


def sampling(eng):
    return SamplingParams if is_port(eng) else JaxSampling


def counter(eng, name: str, labels: tuple = ()) -> float:
    m = registry(eng)._metrics.get(name)
    return 0.0 if m is None else m.values.get(labels, 0.0)


def sequence(eng, rid: str) -> list:
    """One request's decisions: (kind, slot, detail without clocks)."""
    return [(e["kind"], e.get("slot"),
             {k: v for k, v in (e.get("detail") or {}).items() if k not in VOLATILE})
            for e in eng.flight.timeline(rid) or []]


def wall_split(eng, rid: str) -> tuple:
    """(summed non-overlapping phases, submit -> terminal wall) of one
    request, from its rendered events."""
    events = eng.flight.timeline(rid)
    durations, _ = port_flight.attribute_phases(events)
    end = next(e["t"] for e in reversed(events) if e["kind"] in TERMINAL)
    summed = sum(v for k, v in durations.items()
                 if k not in ("tool_overlap_hidden", "host_stall"))
    return summed, end - events[0]["t"]


def settled(eng, timeout: float = 10.0) -> None:
    """Idle, and the engine thread done releasing: every slot id free or
    occupied (``_idle`` reads ``stats()``, which turns idle a moment before
    a finished slot's id is back on the free heap)."""
    _idle(eng)
    deadline = time.monotonic() + timeout
    while len(eng._free) + len(eng._slots) != eng.max_slots and time.monotonic() < deadline:
        time.sleep(0.005)


def wait_finished(eng, rid: str, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not any(e["kind"] in TERMINAL for e in eng.flight.timeline(rid) or []):
        assert time.monotonic() < deadline, rid
        time.sleep(0.01)


@pytest.fixture(scope="module")
def engines():
    weights = _weights()
    ref = ref_engine(weights)
    port = port_engine(params_from_jax(weights, TCFG, device="cpu"))
    ref.flight.tracer, port.flight.tracer = JaxTracer(endpoint=""), PortTracer(endpoint="")
    ref.start()
    port.start()
    try:
        yield SimpleNamespace(ref=ref, port=port, weights=weights)
    finally:
        FAULTS.reset()
        PORT_FAULTS.reset()
        ref.stop()
        port.stop()


def rest(eng) -> None:
    settled(eng)
    _drop_parked(eng)
    while eng._evict_one_prefix_entry():
        pass
    eng.max_queue, eng.park_max_s, eng.prefill_chunk = 0, 30.0, 0


@pytest.fixture
def pair(engines):
    for eng in (engines.ref, engines.port):
        rest(eng)
    yield engines
    FAULTS.reset()
    PORT_FAULTS.reset()
    for eng in (engines.ref, engines.port):
        rest(eng)
        assert eng._allocator.free_count == eng.num_pages - 1
        assert len(eng._free) == eng.max_slots


def both(pair, case) -> tuple:
    """``case(engine)`` -> (outcome, futures) on the reference, then on the
    port: equal outcomes, and for every future equal decision sequences and
    phases summing to its wall. Returns the port's (outcome, futures) and
    the reference's futures."""
    runs = []
    for eng in (pair.ref, pair.port):
        out, futs = case(eng)
        settled(eng)
        for f in futs:
            wait_finished(eng, f.rid)
        runs.append((out, futs, [sequence(eng, f.rid) for f in futs]))
        for f in futs:
            if any(e["kind"] == "admit" for e in eng.flight.timeline(f.rid)):
                # a request shed or expired in the queue has no phase
                summed, wall = wall_split(eng, f.rid)
                assert abs(summed - wall) <= 1e-6, (eng, summed, wall)
    (ref_out, ref_futs, ref_seqs), (out, futs, seqs) = runs
    assert out == ref_out
    assert seqs == ref_seqs
    return out, futs, ref_futs


class Trace:
    """A span context without the API layer."""

    def __init__(self, trace_id="ab" * 16, span_id="cd" * 8):
        self.trace_id, self.span_id = trace_id, span_id


# -- the engine cases ------------------------------------------------------------------


def test_preempt_resume_timeline_phases_and_spans(pair):
    """A nine-page pool preempts at least one request mid-decode; its
    timeline is submit -> admit -> prefill_done -> preempt -> admit
    (resumed) -> prefill_done -> finish on both engines, with a
    preempt_stall phase, and the phases land as child spans of the
    request's trace context."""
    trace = Trace()

    def case(eng):
        hold = _Hold([eng], pages=9)
        try:
            sp = sampling(eng)(temperature=0.0, max_tokens=12)
            with eng.hold_admission():
                futs = [eng.submit(p, sp, trace=trace) for p in PROMPTS]
            res = [f.result(timeout=240) for f in futs]
        finally:
            hold.release()
        return [(list(r.tokens), r.preempt_count) for r in res], futs

    out, futs, _ = both(pair, case)
    preempted = [f for f, (_t, n) in zip(futs, out) if n > 0]
    assert preempted
    doc = pair.port.flight.timeline_doc(preempted[0].rid)
    kinds = [e["kind"] for e in doc["events"]]
    assert kinds[0] == "submit" and kinds[-1] == "finish" and "preempt" in kinds
    assert kinds.count("admit") >= 2 and kinds.count("prefill_done") >= 2
    assert [e["seq"] for e in doc["events"]] == sorted(e["seq"] for e in doc["events"])
    assert any(e["detail"].get("resumed") for e in doc["events"] if e["kind"] == "admit")
    assert doc["phases"].get("preempt_stall", 0.0) > 0.0
    spans = [s for s in pair.port.flight.tracer.spans_for_trace(trace.trace_id)
             if s.attributes.get("request_id") == preempted[0].rid]
    assert {"engine.queue_wait", "engine.prefill", "engine.decode",
            "engine.preempt_stall"} <= {s.name for s in spans}
    assert all(s.parent_span_id == trace.span_id and s.end_time >= s.start_time for s in spans)


def test_plain_request_phases_sum_and_decode_blocks_recorded(pair):
    def case(eng):
        fut = eng.submit("hello flight", sampling(eng)(temperature=0.0, max_tokens=8))
        return list(fut.result(timeout=60).tokens), [fut]

    _out, (fut,), (ref_fut,) = both(pair, case)
    for eng, f in ((pair.port, fut), (pair.ref, ref_fut)):
        doc = eng.flight.timeline_doc(f.rid)
        assert set(doc["phases"]) >= {"queue_wait", "prefill", "decode"}
        assert eng.flight.events(kind="decode_block")
    block = pair.port.flight.events(kind="decode_block", last=1)[0]["detail"]
    assert block["program"].startswith("decode[paged,") and block["steps"] == 4


def test_park_adopt_timeline_and_window_filters(pair):
    """A parked turn and its adopting follow-up: park then finish on the
    first, an ``adopt`` and an admission tagged adopted on the second, and
    the window filters by kind and rid."""
    first = "conversation-prefix-" + "x" * 20

    def case(eng):
        sp = sampling(eng)(temperature=0.0, max_tokens=4)
        a = eng.submit(first, sp, park=True)
        ta = list(a.result(timeout=60).tokens)
        wait_finished(eng, a.rid)
        b = eng.submit(first + "more turn text", sp)
        return [ta, list(b.result(timeout=60).tokens)], [a, b]

    _out, (a, b), _ = both(pair, case)
    port = pair.port
    assert "park" in [k for k, _s, _d in sequence(port, a.rid)]
    assert any(d.get("adopted") for k, _s, d in sequence(port, b.rid) if k == "admit")
    adopts = port.flight.events(kind="adopt")
    assert adopts and all(e["kind"] == "adopt" for e in adopts)
    only = port.flight.events(rid=b.rid, last=0)
    assert only and all(e.get("rid") == b.rid for e in only)


def test_shed_and_deadline_expiry_recorded(pair):
    """A queue cap of 1 sheds: submit -> shed; a queued request past its
    deadline ends with ``expire`` where=queued."""

    def case(eng):
        sp = sampling(eng)
        eng.max_queue = 1
        with eng.hold_admission():
            futs = [eng.submit("p" * 8, sp(temperature=0.0, max_tokens=4), timeout_s=60)
                    for _ in range(4)]
            shed = [f for f in futs if f.done() and f.exception() is not None]
            eng.max_queue = 0
            doomed = eng.submit("q" * 8, sp(max_tokens=4), timeout_s=0.01)
            time.sleep(0.05)
        with pytest.raises(Exception):
            doomed.result(timeout=30)
        for f in futs:
            if f not in shed:
                f.result(timeout=60)
        return [futs.index(f) for f in shed], [*futs, doomed]

    shed_idx, futs, _ = both(pair, case)
    assert shed_idx
    assert [k for k, _s, _d in sequence(pair.port, futs[shed_idx[0]].rid)] == ["submit", "shed"]
    tl = pair.port.flight.timeline(futs[-1].rid)
    assert tl[-1]["kind"] == "expire" and tl[-1]["detail"]["where"] == "queued"


def test_park_release_extends_retired_timeline_without_orphan(pair):
    """A park_release after the finish extends the finished timeline; no
    live entry is left behind."""

    def case(eng):
        eng.park_max_s = 0.05
        fut = eng.submit("park-release-" + "y" * 20,
                         sampling(eng)(temperature=0.0, max_tokens=4), park=True)
        tokens = list(fut.result(timeout=60).tokens)
        deadline = time.monotonic() + 10
        while (eng.flight.timeline(fut.rid) or [{}])[-1].get("kind") != "park_release":
            assert time.monotonic() < deadline
            time.sleep(0.01)
        return tokens, [fut]

    _out, (fut,), _ = both(pair, case)
    tl = pair.port.flight.timeline(fut.rid)
    kinds = [e["kind"] for e in tl]
    assert kinds[-1] == "park_release" and "finish" in kinds and "submit" in kinds
    assert tl[-1]["detail"]["reason"] == "expired"
    assert pair.port.flight.stats()["live_requests"] == 0


def test_timeline_surfaces_rate_plan(pair):
    """With a deadline and chunked prefill the timeline carries the
    planner's quota against the chunks that dispatched."""
    row = [1 + (i % 250) for i in range(56)]

    def case(eng):
        eng.prefill_chunk = 8
        settled(eng)
        eng._cycle_clock.cycle_s = 10.0
        fut = eng.submit(row, sampling(eng)(temperature=0.0, max_tokens=4), timeout_s=95.0)
        tokens = list(fut.result(timeout=120).tokens)
        wait_finished(eng, fut.rid)
        plan = dict(eng.flight.timeline_doc(fut.rid)["rate_plan"])
        plan.pop("prefill_span_s")
        plan["projections"] = [{k: v for k, v in p.items() if k != "seconds_left"}
                               for p in plan["projections"]]
        return (tokens, plan), [fut]

    (_tokens, plan), _f, _ = both(pair, case)
    assert plan["quota"] >= 1 and plan["chunks_dispatched"] >= 1
    assert plan["chunk_tokens"] >= len(row) and plan["projections"][0]["reason"] == "admit"


def test_trace_export_validates_and_matches_the_reference(pair):
    """``export_trace`` of the same traffic: a document ``validate_trace``
    finds no problem in, with the reference's rows (prompt and output
    tokens, persona keys, deadlines, finishes, tool calls), offsets aside."""
    from agentcontrolplane_tpu.observability import trace_export as ref_export
    from agentcontrolplane_tpu_torch.observability import trace_export as port_export

    docs = []
    for eng, mod in ((pair.ref, ref_export), (pair.port, port_export)):
        sp = sampling(eng)(temperature=0.0, max_tokens=6)
        with eng.hold_admission():
            futs = [eng.submit(p, sp, timeout_s=t) for p, t in
                    (("persona " * 12 + "one", None), ("persona " * 12 + "two", 30.0),
                     ("other prompt", None))]
        for f in futs:
            f.result(timeout=60)
            wait_finished(eng, f.rid)
        doc = mod.export_trace(eng.flight)
        assert mod.validate_trace(doc) == []
        rows = [{k: v for k, v in r.items() if k not in ("i", "offset_s")}
                for r in doc["requests"][-3:]]  # this case's, the latest submitted
        docs.append((doc["version"], doc["source"], doc["anonymized"], rows))
    assert docs[1] == docs[0]
    assert port_export.validate_trace({"version": 9, "requests": [{"offset_s": -1}]}) == \
        ref_export.validate_trace({"version": 9, "requests": [{"offset_s": -1}]}) != []


def test_invariant_break_produces_crash_dump_end_to_end(pair, tmp_path, monkeypatch):
    """``engine.invariant_break`` on an armed engine: the checker trips, the
    crash handler writes the dump BEFORE failing the futures (the
    violation, the request's history, stats and the allocator's audit),
    and ``ensure_running`` recovers; on both engines alike."""
    monkeypatch.setenv("ACP_FLIGHT_DUMP_DIR", str(tmp_path))
    docs = []
    for eng in (pair.ref, pair.port):
        sp = sampling(eng)
        eng.check_invariants = True
        try:
            eng.generate("warmup", sp(temperature=0.0, max_tokens=4))
            n0 = len(glob.glob(str(tmp_path / "flightdump-*.json")))
            faults(eng).arm("engine.invariant_break")
            fut = eng.submit("boom", sp(temperature=0.0, max_tokens=8))
            with pytest.raises(Exception, match="crash|invariant"):
                fut.result(timeout=60)
            dumps = sorted(glob.glob(str(tmp_path / "flightdump-*.json")))
            assert len(dumps) == n0 + 1
            doc = json.loads(open(dumps[-1]).read())
            assert eng.ensure_running()
            assert eng.generate("after", sp(temperature=0.0, max_tokens=4)).tokens
            assert eng.flight.events(kind="restart")
        finally:
            eng.check_invariants = False
        kinds = [e["kind"] for e in doc["events"]]
        docs.append((doc["error"]["type"], "invariant_violation" in kinds, "crash" in kinds,
                     "submit" in kinds and "admit" in kinds, doc["engine_stats"]["max_slots"],
                     sorted(doc["allocator_audit"])))
    assert docs[0] == docs[1] == ("InvariantViolation", True, True, True, 4,
                                  ["free", "refcounts", "referenced"])


def test_no_dump_dir_means_no_dump(pair, tmp_path, monkeypatch):
    monkeypatch.delenv("ACP_FLIGHT_DUMP_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    for eng in (pair.ref, pair.port):
        faults(eng).arm("engine.crash")
        fut = eng.submit("x" * 8, sampling(eng)(temperature=0.0, max_tokens=4))
        with pytest.raises(Exception):
            fut.result(timeout=60)
        assert eng.ensure_running()
    assert not glob.glob(str(tmp_path / "flightdump-*.json"))


def test_client_trace_context_yields_engine_child_spans(pair):
    """``TPUEngineClient`` advertises trace contexts and passes the
    caller's into ``Engine.submit``: the request's phase spans land under
    it."""
    import asyncio

    from agentcontrolplane_tpu_torch.api.resources import SpanContext

    client = TPUEngineClient(pair.port, BaseConfig(model="tiny", max_tokens=6))
    assert client.supports_trace_context
    ctx = SpanContext(trace_id="12" * 16, span_id="34" * 8)
    msg = asyncio.run(client.send_request([Message(role="user", content="hi")], tools=[],
                                          trace_context=ctx))
    assert msg.role == "assistant"
    deadline = time.monotonic() + 10
    spans: list = []
    while not spans:
        assert time.monotonic() < deadline
        spans = pair.port.flight.tracer.spans_for_trace(ctx.trace_id)
        time.sleep(0.01)
    assert {"engine.queue_wait", "engine.prefill", "engine.decode"} <= {s.name for s in spans}
    assert all(s.parent_span_id == ctx.span_id for s in spans)


def test_autopilot_engine_applies_and_flight_records(engines):
    """``Engine(autopilot=True)`` at a tiny interval with the spec
    acceptance forced low steps ``spec_len`` down and records it, on both
    engines (fresh ones: the autopilot is fixed at construction)."""
    params = params_from_jax(engines.weights, TCFG, device="cpu")
    for eng in (ref_engine(engines.weights, prefill_chunk=8, spec_len=6, autopilot=True,
                           autopilot_interval=2),
                port_engine(params, prefill_chunk=8, spec_len=6, autopilot=True,
                            autopilot_interval=2)):
        eng.start()
        try:
            a0 = counter(eng, "acp_engine_autopilot_adjustments_total")
            eng.spec_proposed, eng.spec_accepted = 1000, 10
            sp = sampling(eng)
            futs = [eng.submit("steer me " * 4, sp(temperature=0.0, max_tokens=8))
                    for _ in range(3)]
            for f in futs:
                f.result(timeout=120)
            deadline = time.monotonic() + 30
            while eng.spec_len == 6 and time.monotonic() < deadline:
                eng.generate("tick", sp(temperature=0.0, max_tokens=4))
            assert eng.spec_len < 6
            assert counter(eng, "acp_engine_autopilot_adjustments_total") > a0
            assert eng.flight.events(kind="autopilot")
            assert eng.stats()["scheduler"]["planner"]["autopilot"] is True
        finally:
            eng.stop()


# -- the recorder's own cases ----------------------------------------------------------

RECORDERS = [ref_flight, port_flight]


def _disabled(mod):
    rec = mod.FlightRecorder(enabled=False)
    rec.record("submit", rid="r1")
    return [rec.finish("r1", "stop"), rec.events(), rec.timeline("r1"),
            rec.stats()["recorded_total"]]


def _window(mod):
    rec = mod.FlightRecorder(capacity=16, finished_timelines=2)
    for i in range(100):
        rec.record("decode_block", width=i)
    out = [rec.stats()["window_events"], rec.stats()["recorded_total"]]
    for rid in ("a", "b", "c"):
        rec.record("submit", rid=rid)
        rec.finish(rid, "stop")
    return out + [rec.timeline("a") is None, rec.timeline("b") is not None,
                  rec.request_ids()[-2:], rec.stats()["evicted_timelines"]]


def _cap(mod):
    rec = mod.FlightRecorder(capacity=4096, per_request_cap=8)
    for _ in range(50):
        rec.record("prefill_chunk", rid="big")
    return [len(rec.timeline("big")), sorted(rec.truncated_rids())]


def _discard(mod):
    rec = mod.FlightRecorder()
    rec.record("submit", rid="r")
    rec.finish("r", "stop")
    rec.record("park_release", rid="r", reason="expired")
    rec.discard("r")
    return [[e["kind"] for e in rec.timeline("r")], rec.stats()["live_requests"]]


RECORDER_CASES = {"disabled_records_nothing": (_disabled, [{}, [], None, 0]),
                  "window_capacity_and_finished_lru": (_window, [16, 100, True, True,
                                                                 ["b", "c"], 1]),
                  "per_request_cap_bounds_timeline": (_cap, [8, ["big"]]),
                  "discard_extends_the_finished_timeline": (
                      _discard, [["submit", "finish", "park_release"], 0])}


@pytest.mark.parametrize("name", list(RECORDER_CASES))
def test_recorder_matches_the_reference(name):
    fn, want = RECORDER_CASES[name]
    assert [fn(mod) for mod in RECORDERS] == [want, want]


def test_env_knob_disables(monkeypatch):
    for mod in RECORDERS:
        monkeypatch.setenv("ACP_FLIGHT", "0")
        assert mod.FlightRecorder().enabled is False
        monkeypatch.setenv("ACP_FLIGHT", "1")
        assert mod.FlightRecorder().enabled is True


def _ev(*items) -> list:
    return [{"seq": i + 1, "t": t, "kind": k, **({"detail": d} if d else {})}
            for i, (t, k, d) in enumerate(items)]


PHASE_CASES = {
    "tool_overlap": _ev((0.0, "submit", None), (1.0, "admit", None), (3.0, "prefill_done", None),
                        (4.0, "tool_call", None), (9.0, "finish", None)),
    "shed_before_admission": _ev((0.0, "submit", None), (0.5, "shed", None)),
    "preempted_never_resumed": _ev((0.0, "submit", None), (1.0, "admit", None),
                                   (2.0, "prefill_done", None), (3.0, "preempt", None),
                                   (7.0, "finish", None)),
    "host_stall_overlaps": _ev((0.0, "submit", None), (1.0, "admit", None),
                               (2.0, "prefill_done", None), (3.0, "preempt", None),
                               (3.2, "swap_out", {"stall_s": 0.2}),
                               (4.5, "swap_in", {"stall_s": 0.5}),
                               (5.0, "prefill_done", None), (9.0, "finish", None)),
    "swap_without_stall": _ev((0.0, "submit", None), (1.0, "swap_out", None),
                              (2.0, "finish", None)),
    "mid_prefill_stall_carves_prefill": _ev((0.0, "submit", None), (1.0, "admit", None),
                                            (2.0, "preempt", None),
                                            (12.0, "prefill_done", None),
                                            (15.0, "finish", None)),
}


@pytest.mark.parametrize("name", list(PHASE_CASES))
def test_attribute_phases_matches_the_reference(name):
    events = PHASE_CASES[name]
    got = port_flight.attribute_phases(events)
    assert got == ref_flight.attribute_phases(events)
    durations, _ = got
    if name not in ("shed_before_admission", "swap_without_stall"):
        total = sum(v for k, v in durations.items()
                    if k not in ("tool_overlap_hidden", "host_stall"))
        assert total == pytest.approx(events[-1]["t"] - events[0]["t"])


def test_dump_crash_without_dir_returns_none(monkeypatch):
    monkeypatch.delenv("ACP_FLIGHT_DUMP_DIR", raising=False)

    class _E:
        def stats(self):
            return {}

    for mod in RECORDERS:
        assert mod.FlightRecorder().dump_crash(_E(), RuntimeError("x")) is None


# -- the operator's wiring and the OTLP metrics push -----------------------------------


def test_operator_hands_the_recorder_its_tracer_and_starts_the_metrics_push(monkeypatch):
    """``Operator`` gives the engine's recorder its tracer (finished
    requests' phases export as spans) and owns a ``MetricsExporter``,
    which does nothing without an endpoint."""
    monkeypatch.delenv("OTEL_EXPORTER_OTLP_ENDPOINT", raising=False)
    from agentcontrolplane_tpu_torch.operator import Operator, OperatorOptions

    eng = port_engine(params_from_jax(_weights(), TCFG, device="cpu"))
    op = Operator(OperatorOptions(engine=eng, enable_rest=False))
    try:
        assert eng.flight.tracer is op.tracer
        op.metrics_exporter.start()
        assert op.metrics_exporter._thread is None  # no endpoint: a no-op
    finally:
        op.store.close()


def test_otlp_metrics_document_matches_the_reference():
    """The same registry snapshot becomes the same OTLP-JSON document."""
    from agentcontrolplane_tpu.observability import otel_metrics as ref_otel
    from agentcontrolplane_tpu.observability.metrics import Registry as RefRegistry
    from agentcontrolplane_tpu_torch.observability import otel_metrics as port_otel
    from agentcontrolplane_tpu_torch.observability.metrics import Registry as PortRegistry

    docs = []
    for otel, reg in ((ref_otel, RefRegistry()), (port_otel, PortRegistry())):
        reg.counter_add("acp_x_total", 2.0, labels={"k": "v"}, help="x")
        reg.gauge_set("acp_y", 0.5, help="y")
        for v in (0.1, 0.2, 0.3):
            reg.observe("acp_z_seconds", v, help="z")
        docs.append(otel._to_otlp(reg.snapshot(), 1, 2))
        exporter = otel.MetricsExporter(registry=reg, endpoint="")
        exporter.start()
        assert exporter._thread is None
    assert docs[1] == docs[0]
