"""The armed invariant checker on the CPU: the port's
``engine/invariants.py`` over the port's own structures, against the
reference's checker over the JAX engine, replaying the twelve cases of
``tests/engine/test_invariants.py``.

One module-scoped pair on the tiny f32 preset with the same weights
(``tests/test_torch_flight.py``'s), armed, with speculation and chunked
prefill on and a 4 MiB host tier, warmed by the reference's traffic (four
requests, one parked). Each case seeds the same corruption into both
engines' idle state, takes both audits and reverts: the port's problems
are the reference's, string for string, and the audit is clean again
after. The int8 classes run on a second pair with ``quantize_kv``.

One difference is recorded (ROADMAP C): the port's ``stats()`` reads the
allocator's shared-page counter directly and keeps no
``_prefix_shared_pages`` mirror, so that mirror's drift class has no
counterpart; the allocator's own counter drift is checked on both.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentcontrolplane_tpu.engine import invariants as ref_inv
from agentcontrolplane_tpu.ops.paged import HostKVEntry as RefEntry
from agentcontrolplane_tpu.testing import FAULTS
from agentcontrolplane_tpu_torch.engine import invariants as port_inv
from agentcontrolplane_tpu_torch.engine.weights import params_from_jax
from agentcontrolplane_tpu_torch.faults import FAULTS as PORT_FAULTS
from agentcontrolplane_tpu_torch.ops.paged import HostKVEntry as PortEntry

from .test_torch_flight import (
    TCFG,
    _weights,
    counter,
    faults,
    is_port,
    port_engine,
    ref_engine,
    sampling,
    settled,
)


def inv(eng):
    return port_inv if is_port(eng) else ref_inv


def audit(eng) -> list:
    return inv(eng).verify_engine(eng)


def _warm(eng) -> None:
    sp = sampling(eng)(temperature=0.0, max_tokens=10)
    with eng.hold_admission():
        futs = [eng.submit(f"hello world {i} " * 3, sp, park=(i == 0)) for i in range(4)]
    for f in futs:
        assert f.result(timeout=240).finish_reason in ("stop", "length")
    settled(eng)


@pytest.fixture(scope="module")
def pair():
    weights = _weights()
    kw = dict(spec_len=4, prefill_chunk=16, check_invariants=True, host_kv_bytes=1 << 22)
    engs = (ref_engine(weights, **kw),
            port_engine(params_from_jax(weights, TCFG, device="cpu"), **kw))
    for eng in engs:
        eng.start()
        _warm(eng)
    try:
        yield SimpleNamespace(ref=engs[0], port=engs[1], weights=weights)
    finally:
        FAULTS.reset()
        PORT_FAULTS.reset()
        for eng in engs:
            eng.stop()


@pytest.fixture
def engines(pair):
    for eng in (pair.ref, pair.port):
        settled(eng)
    yield (pair.ref, pair.port)
    FAULTS.reset()
    PORT_FAULTS.reset()
    for eng in (pair.ref, pair.port):
        settled(eng)
        assert audit(eng) == []


def both(engines, seed) -> list:
    """``seed(engine)`` -> problems, on both engines: equal problems.
    Returns the port's."""
    ref, port = (seed(eng) for eng in engines)
    assert port == ref
    return port


def corrupt(eng, apply, revert) -> list:
    apply()
    try:
        return audit(eng)
    finally:
        revert()


def test_clean_engine_audits_clean_and_counts_checks(engines):
    for eng in engines:
        assert eng._parked_count == 1  # the warm-up's parked conversation
        assert audit(eng) == []
        assert counter(eng, "acp_engine_invariant_checks_total") > 0


def test_mirror_drift_is_detected(engines):
    def seed(eng):
        out = []
        for name in ("_parked_count", "_prefilling_count"):
            out.append(corrupt(eng, lambda n=name: setattr(eng, n, getattr(eng, n) + 1),
                               lambda n=name: setattr(eng, n, getattr(eng, n) - 1)))
        return out

    parked, prefilling = both(engines, seed)
    assert any("mirror drift" in p and "_parked_count" in p for p in parked)
    assert any("_prefilling_count" in p for p in prefilling)


def test_refcount_leak_and_conservation_break_are_detected(engines):
    def seed(eng):
        alloc = eng._allocator
        page = sorted(alloc._refs)[0]
        leak = corrupt(eng, lambda: alloc._refs.__setitem__(page, alloc._refs[page] + 1),
                       lambda: alloc._refs.__setitem__(page, alloc._refs[page] - 1))
        stolen = []
        lost = corrupt(eng, lambda: stolen.append(alloc._free.pop()),
                       lambda: alloc._free.append(stolen.pop()))
        return [leak, lost]

    leak, lost = both(engines, seed)
    assert any("refcount leak" in p for p in leak)
    assert any("vanished from accounting" in p for p in lost)


def test_parked_kv_coverage_break_is_detected(engines):
    def seed(eng):
        slot = next(s for s, sl in eng._slots.items() if sl.parked)
        pages = eng._slot_pages[slot]
        held = []
        short = corrupt(eng, lambda: held.append(pages.pop()), lambda: pages.append(held.pop()))
        cut = int(eng._seq_lens[slot])
        off = corrupt(eng, lambda: eng._seq_lens.__setitem__(slot, cut + 1),
                      lambda: eng._seq_lens.__setitem__(slot, cut))
        return [short, off]

    short, off = both(engines, seed)
    assert any("parked slot" in p for p in short)
    assert any("park_cut" in p for p in off)


def test_check_raises_and_counts(engines):
    for eng in engines:
        inv(eng).check_engine_invariants(eng)  # healthy: no raise
        before = counter(eng, "acp_engine_invariant_violations_total")
        eng._parked_count += 1
        try:
            with pytest.raises(inv(eng).InvariantViolation, match="mirror drift"):
                inv(eng).check_engine_invariants(eng)
        finally:
            eng._parked_count -= 1
        assert counter(eng, "acp_engine_invariant_violations_total") > before
        assert eng.flight.events(kind="invariant_violation")


def test_host_resident_page_leak_is_detected(engines):
    """Bytes counted with no entry, and an entry gone behind the counter's
    back: both are a host-pool leak, and the mirror drifts."""

    def seed(eng):
        pool = eng._host_pool
        shape = (TCFG.n_layers, 16, TCFG.n_kv_heads, TCFG.head_dim)
        if is_port(eng):
            entry = PortEntry("seed", tuple(range(16)), torch.zeros(shape), torch.zeros(shape))
        else:
            entry = RefEntry("seed", tuple(range(16)), np.zeros(shape, dtype=np.float32),
                             np.zeros(shape, dtype=np.float32))
        pool.put(entry)
        eng._publish_memory_state()
        try:
            clean = audit(eng)

            def add(n):
                pool.used_bytes += n

            extra = corrupt(eng, lambda: add(123), lambda: add(-123))
            gone = corrupt(eng, lambda: pool._entries.pop("seed"),
                           lambda: pool._entries.__setitem__("seed", entry))
        finally:
            pool.pop("seed")
            eng._publish_memory_state()
        return [clean, extra, gone]

    clean, extra, gone = both(engines, seed)
    assert clean == []
    assert any("host KV pool leak" in p for p in extra)
    assert any("_host_kv_used" in p for p in extra)
    assert any("host KV pool leak" in p for p in gone)


def test_off_knob_engine_with_scale_storage_is_detected(engines):
    def seed(eng):
        twin = torch.zeros(1) if is_port(eng) else jnp.zeros((1,), dtype=jnp.float32)
        return corrupt(eng, lambda: eng.cache.__setitem__("ks", twin),
                       lambda: eng.cache.pop("ks"))

    assert any("quantize_kv off" in p for p in both(engines, seed))


def test_shared_page_refcount_drift_is_detected(engines):
    """A shared page's reference dropped while its second owner holds it
    (the parked slot and its cache entry share pages), and the allocator's
    shared counter drifting from the refcounts."""

    def seed(eng):
        alloc = eng._allocator
        pg = next(p for p, r in sorted(alloc._refs.items()) if r > 1)
        dropped = corrupt(eng, lambda: alloc.free([pg]), lambda: alloc.share([pg]))

        def bump(n):
            alloc._shared += n

        drift = corrupt(eng, lambda: bump(1), lambda: bump(-1))
        return [dropped, drift]

    dropped, drift = both(engines, seed)
    assert any("owners but refcount" in p for p in dropped)
    assert any("shared_count" in p for p in drift)


def test_goodput_ledger_conservation_break_is_detected(engines):
    def seed(eng):
        prof = eng.profiler

        def setv(**kw):
            for k, v in kw.items():
                if k == "pad_bucket":
                    prof._waste["pad_bucket"] = v
                else:
                    setattr(prof, k, v)

        comp0, good0, pad0 = prof._computed, prof._goodput, prof._waste["pad_bucket"]
        out = [corrupt(eng, lambda: setv(_computed=comp0 + 7), lambda: setv(_computed=comp0)),
               corrupt(eng, lambda: setv(pad_bucket=-2, _computed=comp0 - pad0 - 2),
                       lambda: setv(pad_bucket=pad0, _computed=comp0)),
               corrupt(eng, lambda: setv(_goodput=-1, _computed=-1 + sum(prof._waste.values())),
                       lambda: setv(_goodput=good0, _computed=comp0))]
        # the ledgers' values differ between engines only by their traffic
        return [[p.split(":")[0] for p in probs] for probs in out]

    unclassified, negative_cause, negative_goodput = both(engines, seed)
    assert "goodput ledger conservation broken" in unclassified
    assert "negative waste-cause counters" in negative_cause
    assert "goodput ledger negative" in negative_goodput


def test_invariant_break_fault_trips_end_to_end(engines):
    """The fault site corrupts a mirror inside the loop; the armed checker
    crashes the engine, the caller fails loudly, ``ensure_running``
    recovers and the next request is served."""
    for eng in engines:
        sp = sampling(eng)
        faults(eng).arm("engine.invariant_break")
        fut = eng.submit("hello there", sp(temperature=0.0, max_tokens=48))
        with pytest.raises(RuntimeError, match="invariant"):
            fut.result(timeout=240)
        assert eng._crashed
        assert eng.ensure_running()
        assert eng.generate("hello again", sp(max_tokens=4)).finish_reason in ("stop", "length")
        settled(eng)
        assert audit(eng) == []
        _warm(eng)  # the parked slot again, for the cases after


def test_disarmed_fault_site_is_inert(engines):
    """Against a disarmed engine ``engine.invariant_break`` corrupts
    nothing: the site is gated on ``check_invariants``."""
    for eng in engines:
        eng.check_invariants = False
        try:
            faults(eng).arm("engine.invariant_break")
            out = eng.generate("hello", sampling(eng)(temperature=0.0, max_tokens=8))
            assert out.finish_reason in ("stop", "length")
            settled(eng)
            assert audit(eng) == []
            assert faults(eng).armed("engine.invariant_break")
        finally:
            # disarm, and let the loop finish its cycle, before re-arming
            # the checker: the cycle's tail reads check_invariants
            faults(eng).disarm("engine.invariant_break")
            settled(eng)
            eng.check_invariants = True


def test_quantized_scale_row_corruption_classes_are_detected(pair):
    """int8 KV: a scale row kept past its page's free, an allocated page
    without one, and a scale twin sheared off the pool, on both engines."""
    params = params_from_jax(pair.weights, TCFG, device="cpu")
    got = []
    for eng in (ref_engine(pair.weights, quantize_kv=True, check_invariants=True),
                port_engine(params, quantize_kv=True, check_invariants=True)):
        eng.start()
        try:
            assert eng.generate("warm quantized pages", sampling(eng)(
                temperature=0.0, max_tokens=6)).finish_reason in ("stop", "length")
            settled(eng)
            clean = audit(eng)
            alloc, scales = eng._allocator, eng._allocator._scale_pages
            stale = max(set(range(1, eng.num_pages)) - set(alloc._refs))
            leak = corrupt(eng, lambda: scales.add(stale), lambda: scales.discard(stale))
            pages = alloc.alloc(1)
            try:
                missing = corrupt(eng, lambda: scales.discard(pages[0]),
                                  lambda: scales.add(pages[0]))
            finally:
                alloc.free(pages)
            held = []
            sheared = corrupt(eng, lambda: held.append(eng.cache.pop("ks")),
                              lambda: eng.cache.__setitem__("ks", held.pop()))
            got.append([clean, leak, missing, sheared, audit(eng)])
        finally:
            eng.stop()
    assert got[1] == got[0]
    clean, leak, missing, sheared, after = got[1]
    assert clean == after == []
    assert any("scale-row leak" in p for p in leak)
    assert any("without owned scale rows" in p for p in missing)
    assert any("cache carries keys" in p for p in sheared)
