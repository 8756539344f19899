"""The dispatch profiler on the CPU: the port's
``observability/profiler.py`` against the reference's, and the port's
engine against the JAX package's, replaying
``tests/observability/test_profiler.py`` and
``tests/engine/test_profiler_engine.py``.

- The profiler's own cases run the same calls on both classes (the port's
  ``out`` a torch tensor): per-program aggregation and sampling, first
  dispatches after ``mark_prewarmed`` (``cold_compile``), the ledger's
  conservation by construction and zero-sum ``reclassify``, delta
  publishing, the disabled profiler and the env knobs.
- The engine cases run one module-scoped pair on the tiny f32 preset with
  the same weights (``tests/test_torch_flight.py``'s): the same traffic
  gives the same program keys with the same dispatches, real and padded
  tokens and lanes, and the same goodput and waste causes, with
  conservation held (the fault matrix included: ``engine.force_preempt``,
  ``engine.spec_mismatch`` and ``engine.host_swap_error`` armed alike on
  both engines); streams are byte-identical with the profiler on and off.

Not replayed: ``test_fully_prewarmed_engine_reports_zero_cold_compiles``
and ``test_prewarm_gap_records_flight_event_and_counter`` (the port has no
prewarm yet, ROADMAP A.3).
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from agentcontrolplane_tpu.observability import flight as ref_flight
from agentcontrolplane_tpu.observability import profiler as ref_profiler
from agentcontrolplane_tpu.observability.metrics import REGISTRY as JAX_REGISTRY
from agentcontrolplane_tpu.testing import FAULTS
from agentcontrolplane_tpu_torch.engine.invariants import verify_engine
from agentcontrolplane_tpu_torch.engine.weights import params_from_jax
from agentcontrolplane_tpu_torch.faults import FAULTS as PORT_FAULTS
from agentcontrolplane_tpu_torch.observability import flight as port_flight
from agentcontrolplane_tpu_torch.observability import profiler as port_profiler
from agentcontrolplane_tpu_torch.observability.metrics import REGISTRY as PORT_REGISTRY

from .test_torch_chunked import _drop_parked
from .test_torch_flight import (TCFG, _weights, faults, port_engine, ref_engine, sampling,
                                settled)

# -- the profiler's own cases -------------------------------------------------------------

MODULES = [(ref_profiler, ref_flight, JAX_REGISTRY, np.zeros(4)),
           (port_profiler, port_flight, PORT_REGISTRY, torch.zeros(4))]


def _counter(reg, name: str, **labels) -> float:
    m = reg._metrics.get(name)
    return 0.0 if m is None else m.values.get(tuple(sorted(labels.items())), 0.0)


def _aggregates(mod, _flight, reg, out):
    prof = mod.DispatchProfiler(enabled=True, sample_every=2)
    for _ in range(5):
        prof.record("decode[paged,4x4]", prof.start(), out=out, real_tokens=12,
                    padded_tokens=4, real_slots=3, padded_slots=1)
    p = prof.stats()["programs"]["decode[paged,4x4]"]
    count, _w = reg.series_window("acp_engine_dispatch_seconds", {"program": "decode[paged,4x4]"})
    return [p["dispatches"], p["real_tokens"], p["padded_tokens"], p["padding_pct"],
            p["real_slots"], p["padded_slots"], p["device_samples"],
            p["device_ms_mean"] is not None, count >= 5]


def _cold(mod, flight, reg, _out):
    rec = flight.FlightRecorder(enabled=True)
    prof = mod.DispatchProfiler(flight=rec, enabled=True)
    before = _counter(reg, "acp_engine_cold_compiles_total")
    prof.record("prefill[paged,64x1]", prof.start())
    out = [prof.stats()["cold_compiles"]["serving"]]
    prof.mark_prewarmed()
    prof.record("prefill[paged,64x1]", prof.start())
    prof.record("prefill[paged,128x1]", prof.start())
    doc = prof.stats()
    return out + [doc["cold_compiles"]["serving"], doc["cold_compiles"]["events"][0]["program"],
                  doc["programs"]["prefill[paged,128x1]"]["cold"],
                  doc["programs"]["prefill[paged,64x1]"]["cold"],
                  _counter(reg, "acp_engine_cold_compiles_total") - before,
                  [e["detail"]["program"] for e in rec.events(kind="cold_compile")]]


def _ledger(mod, _flight, _reg, _out):
    prof = mod.DispatchProfiler(enabled=True)
    prof.account(goodput=100, pad_bucket=28, prewarm=10)
    prof.account(goodput=50, pad_width=6, spec_rejected=4)
    log = [prof.ledger()]
    prof.reclassify("preempt_discard", 40)
    log.append(prof.ledger())
    prof.reclassify("dedup_rewind", 10_000)
    prof.reclassify("swap_recompute", 0)
    prof.reclassify("swap_recompute", -5)
    log.append(prof.ledger())
    for led in log:
        assert led["computed"] == led["goodput"] + sum(led["waste"].values())
    with pytest.raises(KeyError):
        prof.account(goodput=1, bogus_cause=2)
    with pytest.raises(KeyError):
        prof.reclassify("bogus_cause", 1)
    return log + [sorted(mod.WASTE_CAUSES)]


def _publish(mod, _flight, reg, _out):
    prof = mod.DispatchProfiler(enabled=True)
    base = {c: _counter(reg, "acp_engine_tokens_computed_total", cause=c)
            for c in ("goodput", "pad_bucket")}
    prof.account(goodput=30, pad_bucket=10)
    prof.publish()
    prof.publish()  # deltas: nothing twice
    key = "chunk[paged,32x2]"
    prof.record(key, prof.start(), real_tokens=40, padded_tokens=24)
    real0 = _counter(reg, "acp_engine_dispatch_tokens_total", program=key, kind="real")
    prof.publish()
    return [_counter(reg, "acp_engine_tokens_computed_total", cause=c) - b
            for c, b in base.items()] + [
        _counter(reg, "acp_engine_goodput_ratio"),
        _counter(reg, "acp_engine_dispatch_tokens_total", program=key, kind="real") - real0]


def _disabled(mod, _flight, _reg, _out):
    prof = mod.DispatchProfiler(enabled=False)
    t0 = prof.start()
    prof.record("decode[paged,1x4]", 0.0, real_tokens=4)
    prof.account(goodput=10, pad_width=2)
    prof.reclassify("preempt_discard", 5)
    prof.publish()
    doc = prof.stats()
    return [t0, doc["enabled"], doc["programs"], doc["goodput"]["computed"],
            doc["goodput"]["ratio"]]


UNIT_CASES = {
    "record_aggregates_per_program_and_observes_histogram": (
        _aggregates, [5, 60, 20, 25.0, 15, 5, 3, True, True]),
    "cold_compiles_only_after_mark_prewarmed": (
        _cold, [0, 1, "prefill[paged,128x1]", True, False, 1.0, ["prefill[paged,128x1]"]]),
    "ledger_conservation_by_construction_and_reclassify_zero_sum": (_ledger, None),
    "publish_pushes_delta_counters_and_ratio_gauge": (_publish, [30.0, 10.0, 0.75, 40.0]),
    "disabled_profiler_is_inert": (_disabled, [0.0, False, {}, 0, 1.0]),
}


@pytest.mark.parametrize("name", list(UNIT_CASES))
def test_profiler_matches_the_reference(name):
    fn, want = UNIT_CASES[name]
    ref, port = (fn(*m) for m in MODULES)
    assert port == ref
    if want is not None:
        assert port == want


def test_env_knobs(monkeypatch):
    for mod, *_ in MODULES:
        monkeypatch.setenv("ACP_PROF", "0")
        assert mod.DispatchProfiler().enabled is False
        monkeypatch.setenv("ACP_PROF", "1")
        monkeypatch.setenv("ACP_PROF_SAMPLE", "7")
        prof = mod.DispatchProfiler()
        assert prof.enabled is True and prof.sample_every == 7


def test_cpu_record_needs_no_device_wait():
    """On the CPU a sampled record times the host call alone (the ops have
    run when they return); a CUDA tensor would wait on an event."""
    prof = port_profiler.DispatchProfiler(enabled=True, sample_every=1)
    prof.record("decode[paged,1x4]", prof.start(), out=torch.zeros(2))
    p = prof.stats()["programs"]["decode[paged,1x4]"]
    assert p["device_samples"] == 1 and p["device_ms_mean"] is not None


# -- the engines ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    weights = _weights()
    ref = ref_engine(weights, host_kv_bytes=1 << 22)
    port = port_engine(params_from_jax(weights, TCFG, device="cpu"), host_kv_bytes=1 << 22)
    ref.start()
    port.start()
    try:
        yield SimpleNamespace(ref=ref, port=port)
    finally:
        FAULTS.reset()
        PORT_FAULTS.reset()
        ref.stop()
        port.stop()


def _rest(eng) -> None:
    settled(eng)
    _drop_parked(eng)
    while eng._evict_one_prefix_entry():
        pass
    eng.spec_len, eng.prefill_chunk, eng.megastep = 0, 0, True
    eng.profiler.enabled = True
    eng.check_invariants = False


@pytest.fixture
def pair(engines):
    for eng in (engines.ref, engines.port):
        _rest(eng)
    yield engines
    FAULTS.reset()
    PORT_FAULTS.reset()
    for eng in (engines.ref, engines.port):
        _rest(eng)
        assert eng._allocator.free_count == eng.num_pages - 1


def _snapshot(eng) -> tuple:
    """(program stats without clocks, the ledger) of ``eng``'s profiler."""
    perf = eng.profiler.stats()
    progs = {k: {f: p[f] for f in ("dispatches", "real_tokens", "padded_tokens", "real_slots",
                                     "padded_slots")}
             for k, p in perf["programs"].items()}
    return progs, eng.profiler.ledger()


def _delta(before: tuple, after: tuple) -> tuple:
    (p0, l0), (p1, l1) = before, after
    progs = {}
    for key, p in p1.items():
        old = p0.get(key, {f: 0 for f in p})
        d = {f: p[f] - old[f] for f in p}
        if d["dispatches"]:
            progs[key] = d
    led = {"computed": l1["computed"] - l0["computed"], "goodput": l1["goodput"] - l0["goodput"],
           "waste": {c: l1["waste"][c] - l0["waste"][c] for c in l1["waste"]}}
    return progs, led


def _both(pair, case) -> tuple:
    """``case(engine)`` on the reference, then on the port: equal outcomes,
    equal per-program deltas and ledger deltas, conservation held. Returns
    the port's (outcome, program deltas, ledger delta)."""
    seen = []
    for eng in (pair.ref, pair.port):
        s0 = _snapshot(eng)
        out = case(eng)
        settled(eng)
        time.sleep(0.05)
        led = eng.profiler.ledger()
        assert led["computed"] == led["goodput"] + sum(led["waste"].values())
        seen.append((out, *_delta(s0, _snapshot(eng))))
    assert seen[1] == seen[0]
    return seen[1]


def test_program_stats_and_ledger_match_the_reference(pair):
    """Spec, chunking on, the megastep off: the chunk, decode and verify
    programs by the reference's keys, with equal counts, and equal
    goodput and waste."""

    def case(eng):
        eng.spec_len, eng.prefill_chunk, eng.megastep = 4, 16, False
        sp = sampling(eng)(temperature=0.0, max_tokens=10)
        with eng.hold_admission():
            futs = [eng.submit(f"telemetry {i} " * 3, sp) for i in range(4)]
        return [list(f.result(timeout=240).tokens) for f in futs]

    _out, progs, led = _both(pair, case)
    assert any(k.startswith("chunk[paged,") for k in progs)
    assert any(k.startswith("decode[paged,") for k in progs)
    assert led["computed"] > 0 and led["goodput"] > 0
    for p in pair.port.profiler.stats()["programs"].values():
        assert p["device_samples"] >= 1  # a key's first dispatch always samples
    blocks = pair.port.flight.events(kind="decode_block")
    assert blocks and all(e["detail"]["program"].startswith("decode[paged,") for e in blocks)


def test_megastep_programs_and_pad_fuse_match_the_reference(pair):
    """The fused cycle's keys and its ``pad_fuse`` rows, as the reference
    accounts them."""

    def case(eng):
        eng.prefill_chunk = 16
        sp = sampling(eng)(temperature=0.0, max_tokens=10)
        with eng.hold_admission():
            futs = [eng.submit(ch * 30, sp) for ch in "xyz"]
        return [list(f.result(timeout=240).tokens) for f in futs]

    _out, progs, _led = _both(pair, case)
    assert any(k.startswith("megastep[paged,") for k in progs)


def test_profiler_on_off_greedy_byte_identity(pair):
    """Spec and chunking on: the streams are the same bytes with the
    profiler on and off (and the reference's)."""
    prompts = ["hello profiler " + c * 9 for c in "abc"]

    def run(eng):
        eng.spec_len, eng.prefill_chunk = 4, 16
        sp = sampling(eng)(temperature=0.0, max_tokens=12)
        with eng.hold_admission():
            futs = [eng.submit(p, sp) for p in prompts]
        return [list(f.result(timeout=240).tokens) for f in futs]

    ref = run(pair.ref)
    _rest(pair.ref)
    on = run(pair.port)
    _rest(pair.port)
    pair.port.profiler.enabled = False
    computed0 = pair.port.profiler.ledger()["computed"]
    off = run(pair.port)
    assert on == off == ref
    assert pair.port.profiler.ledger()["computed"] == computed0  # disabled: nothing counted


def test_dispatch_seconds_histogram_exported(pair):
    pair.port.generate("histogram", sampling(pair.port)(temperature=0.0, max_tokens=6))
    keys = [k for k in pair.port.profiler.stats()["programs"] if k.startswith("decode[")]
    assert keys
    count, window = PORT_REGISTRY.series_window("acp_engine_dispatch_seconds",
                                                {"program": keys[0]})
    assert count > 0 and window


def test_token_conservation_under_fault_matrix(pair):
    """Preemptions, a forced full rejection and failed host swaps (armed
    alike on both engines) on a 23-page pool (``engine.page_pressure``
    holds the rest), with the armed audit every
    cycle: every request completes, the audit stays clean, the ledger
    balances, and the goodput and every waste cause equal the
    reference's."""

    def case(eng):
        eng.spec_len, eng.prefill_chunk, eng.check_invariants = 4, 16, True
        sp = sampling(eng)(temperature=0.0, max_tokens=12)
        with eng.hold_admission():  # one group on both engines, whatever the timing
            warm = [eng.submit("warm " + c * 16, sp) for c in "ab"]
        for f in warm:
            f.result(timeout=240)
        settled(eng)
        f = faults(eng)
        # the reference's 24-page pool: the page-pressure site holds the
        # rest, as pages the audit counts as owned
        f.arm("engine.page_pressure", pages=eng._allocator.free_count - 23)
        f.apply_page_pressure(eng._allocator)
        try:
            f.arm("engine.force_preempt", after_steps=2)
            f.arm("engine.spec_mismatch", times=1)
            f.arm("engine.host_swap_error", times=2)
            with eng.hold_admission():
                futs = [eng.submit(ch * 24, sp) for ch in "cdefgh"]
            res = [f.result(timeout=240) for f in futs]
        finally:
            settled(eng)
            f.reset()
        assert all(r.finish_reason in ("stop", "length") for r in res)
        return [list(r.tokens) for r in res], sum(r.preempt_count for r in res)

    (_streams, preempts), _progs, led = _both(pair, case)
    assert preempts > 0
    waste = led["waste"]
    assert waste["preempt_discard"] + waste["swap_recompute"] + waste["spec_rejected"] > 0
    assert verify_engine(pair.port) == []
    g = pair.port.stats()["perf"]["goodput"]
    full = pair.port.profiler.ledger()
    assert g["computed"] == full["computed"] and g["waste"] == full["waste"]


def test_cuda_record_waits_on_an_event_on_the_given_stream(monkeypatch):
    """The port's device sample (ROADMAP C): a CUDA output makes a sampled
    record record an event on the stream named (else the output device's
    current stream) and synchronize it, where the reference calls
    ``jax.block_until_ready``."""
    calls = []

    class _Event:
        def record(self, stream):
            calls.append(("record", stream))

        def synchronize(self):
            calls.append(("synchronize",))

    class _Out:
        is_cuda = True
        device = "cuda:0"

    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: ("current", dev))
    prof = port_profiler.DispatchProfiler(enabled=True, sample_every=2)
    for stream in (None, "side", None):
        prof.record("swap_scatter[2]", prof.start(), out=_Out(), stream=stream)
    # dispatches 1 (the first) and 3 are sampled, 2 is not
    assert calls == [("record", ("current", "cuda:0")), ("synchronize",),
                     ("record", ("current", "cuda:0")), ("synchronize",)]
    prof.record("swap_gather[1]", prof.start(), out=_Out(), stream="side")
    assert calls[-2:] == [("record", "side"), ("synchronize",)]
    assert prof.stats()["programs"]["swap_scatter[2]"]["device_samples"] == 2


def test_no_kernel_fallback_event_or_counter(pair):
    """The port has no Pallas -> XLA fallback (ROADMAP C): serving records
    no ``kernel_fallback`` event and exports no fallback counter; on a
    CUDA tensor the walk launches or raises."""
    pair.port.generate("no fallback here", sampling(pair.port)(max_tokens=4))
    assert not pair.port.flight.events(kind="kernel_fallback", last=0)
    assert "acp_engine_kernel_fallbacks_total" not in PORT_REGISTRY._metrics
