"""The fault sites on the CPU: the port's ``faults.py`` and its engine sites
against the JAX package's, replaying the host-tier fault cases of
``tests/engine/test_kv_memory.py`` and ``tests/engine/test_prefetch.py``.

One module-scoped pair on the tiny f32 preset with the same weights
(``tests/test_torch_flight.py``'s), both with a 4 MiB host tier and the
invariant checker armed. Each engine's sites are armed on its own
package's ``FAULTS`` (two separate injectors: a site armed for one engine
never fires on the other). The reference's tight pools (``kv_pages=10``,
``16``) are made by the ``engine.page_pressure`` site itself, whose held
pages the audit counts as owned. Each case gives byte-identical streams
against the uncontended runs, the reference's per-request flight sequences
(``swap_out`` / ``swap_in`` / ``prefetch_abort`` included), and a clean
audit.
"""

import time
from types import SimpleNamespace

import pytest

from agentcontrolplane_tpu import faults as ref_faults
from agentcontrolplane_tpu.testing import FAULTS
from agentcontrolplane_tpu_torch import faults as port_faults
from agentcontrolplane_tpu_torch.engine.invariants import verify_engine
from agentcontrolplane_tpu_torch.engine.weights import params_from_jax
from agentcontrolplane_tpu_torch.faults import FAULTS as PORT_FAULTS
from agentcontrolplane_tpu_torch.ops.paged import PageAllocator

from .test_torch_chunked import _drop_parked
from .test_torch_flight import (
    TCFG,
    _weights,
    both,
    counter,
    faults,
    port_engine,
    ref_engine,
    sampling,
    settled,
)

HOST = 1 << 22
PROMPTS = [ch * 20 for ch in "abcdef"]


@pytest.fixture(scope="module")
def engines():
    weights = _weights()
    ref = ref_engine(weights, host_kv_bytes=HOST, check_invariants=True)
    port = port_engine(params_from_jax(weights, TCFG, device="cpu"), host_kv_bytes=HOST,
                       check_invariants=True)
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
    eng.set_host_kv_bytes(0)
    eng.set_host_kv_bytes(HOST)
    eng.prefill_chunk, eng.megastep, eng.host_prefetch = 0, True, True
    eng._prefix_enabled, eng.max_queue = True, 0


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
        assert verify_engine(engines.port) == []


def _pool(eng, pages: int) -> None:
    """The reference's ``kv_pages=pages`` pool: ``engine.page_pressure``
    holds the rest (applied now, re-applied at every decode site)."""
    f = faults(eng)
    f.arm("engine.page_pressure", pages=eng._allocator.free_count - (pages - 1))
    f.apply_page_pressure(eng._allocator)


# -- the injector ---------------------------------------------------------------------------


def _injector_log(mod):
    fi = mod.FaultInjector()
    log = [fi.enabled, fi.pop("x")]
    fi.arm("x", times=2, after_steps=3, seconds=0.5)
    log += [fi.enabled, fi.armed("x"), fi.pop("x", steps=2), fi.pop("x", steps=3),
            fi.pop("x", steps=9), fi.pop("x", steps=9), fi.armed("x")]
    fi.arm("y", replica="r1")
    log += [fi.pop("y", match={"replica": "r2"}), fi.pop("y", match={"replica": "r1"})]
    alloc = PageAllocator(9)
    fi.arm("engine.page_pressure", pages=3)
    fi.apply_page_pressure(alloc)
    log += [len(fi.held_pages(alloc)), alloc.free_count]
    fi.disarm("engine.page_pressure")
    fi.apply_page_pressure(alloc)
    log += [fi.held_pages(alloc), alloc.free_count]
    fi.arm("engine.page_pressure", pages=2)
    fi.apply_page_pressure(alloc)
    fi.reset()
    return log + [alloc.free_count, fi.armed("engine.page_pressure")]


def test_injector_matches_the_reference(monkeypatch):
    monkeypatch.delenv("ACP_FAULTS", raising=False)
    want = [False, None, True, True, None,
            {"times": 1, "after_steps": 3, "seconds": 0.5},
            {"times": 0, "after_steps": 3, "seconds": 0.5}, None, False,
            None, {"times": 0, "after_steps": 0, "replica": "r1"}, 3, 5, [], 8, 8, False]
    assert _injector_log(port_faults) == _injector_log(ref_faults) == want
    monkeypatch.setenv("ACP_FAULTS", "1")
    assert port_faults.FaultInjector().enabled is ref_faults.FaultInjector().enabled is True
    assert port_faults.FAULTS is not ref_faults.FAULTS


# -- tests/engine/test_kv_memory.py ---------------------------------------------------------


def test_host_swap_error_falls_back_to_recompute_identically(pair):
    def case(eng):
        _pool(eng, 10)
        sp = sampling(eng)(temperature=0.0, max_tokens=16)
        base = list(eng.generate("hello world " * 4, sp).tokens)
        outs0 = eng.kv_swap_outs
        faults(eng).arm("engine.host_swap_error", times=1)
        faults(eng).arm("engine.force_preempt", after_steps=eng.decode_steps + 2)
        fut = eng.submit("hello world " * 4, sp)
        r = fut.result(timeout=180)
        return (list(r.tokens) == base, r.preempt_count >= 1, eng.kv_swap_outs - outs0), [fut]

    out, (fut,), _ = both(pair, case)
    assert out == (True, True, 0)  # the swap-out failed; the resume recomputed
    kinds = [e["kind"] for e in pair.port.flight.timeline(fut.rid)]
    assert "swap_out" in kinds and "preempt" in kinds


def test_host_swap_slow_stall_is_flight_recorded(pair):
    def case(eng):
        _pool(eng, 10)
        sp = sampling(eng)(temperature=0.0, max_tokens=16)
        base = list(eng.generate("hello world " * 4, sp).tokens)
        faults(eng).arm("engine.host_swap_slow", times=1, seconds=0.2)
        faults(eng).arm("engine.force_preempt", after_steps=eng.decode_steps + 2)
        fut = eng.submit("hello world " * 4, sp)
        tokens = list(fut.result(timeout=180).tokens)
        return tokens == base, [fut]

    same, (fut,), (ref_fut,) = both(pair, case)
    assert same
    for eng, f in ((pair.port, fut), (pair.ref, ref_fut)):
        swaps = [e for e in eng.flight.timeline(f.rid) if e["kind"] in ("swap_out", "swap_in")]
        assert swaps and any(e["detail"].get("stall_s", 0) > 0.1 for e in swaps)
        assert eng.flight.timeline_doc(f.rid)["phases"].get("host_stall", 0) > 0.1


def test_stress_pressure_swap_faults_preempt_invariants_armed(pair):
    """A 16-page pool, page pressure, both swap faults and a forced
    preemption, dedup-eligible prompts, the cache off: every stream equals
    its solo run and streamed exactly once."""
    persona = "p" * 40
    prompts = [persona + f"-{chr(97 + i) * 4}" for i in range(4)] + ["z" * 24]

    def case(eng):
        eng._prefix_enabled, eng.prefill_chunk = False, 16
        sp = sampling(eng)(temperature=0.0, max_tokens=10)
        f = faults(eng)
        _pool(eng, 16)
        solo = {p: list(eng.generate(p, sp).tokens) for p in prompts}
        settled(eng)
        f.arm("engine.page_pressure", pages=len(f.held_pages(eng._allocator)) + 4)
        f.arm("engine.host_swap_slow", times=2, seconds=0.05)
        f.arm("engine.host_swap_error", times=1)
        f.arm("engine.force_preempt", after_steps=eng.decode_steps + 3)
        streams = {p: [] for p in prompts}
        with eng.hold_admission():
            futs = [eng.submit(p, sp, on_tokens=streams[p].extend) for p in prompts]
        res = [fu.result(timeout=300) for fu in futs]
        same = all(list(r.tokens) == solo[p] == streams[p] for p, r in zip(prompts, res))
        settled(eng)
        f.reset()
        return (same, sum(r.preempt_count for r in res) > 0), futs

    out, _futs, _ = both(pair, case)
    assert out == (True, True)
    assert verify_engine(pair.port) == []


# -- tests/engine/test_prefetch.py ---------------------------------------------------------


def _pressure_run(eng) -> bool:
    """The oversubscribed pool: preemptions swap out, resumes swap back in
    over chunked cycles while the survivors decode. True when every burst
    stream equals its solo run."""
    sp = sampling(eng)(temperature=0.0, max_tokens=12)
    solo = [list(eng.generate(p, sp).tokens) for p in PROMPTS]
    with eng.hold_admission():
        futs = [eng.submit(p, sp) for p in PROMPTS]
    return [list(f.result(timeout=300).tokens) for f in futs] == solo, futs


def test_prefetch_on_off_byte_identity_and_overlap_counted(pair):
    def case(eng):
        out = {}
        futs = []
        for pf in (False, True):
            _rest(eng)
            eng.prefill_chunk, eng.host_prefetch = 16, pf
            _pool(eng, 10)
            before = counter(eng, "acp_engine_kv_prefetch_commits_total")
            ins0 = eng.kv_swap_ins
            same, fs = _pressure_run(eng)
            settled(eng)
            faults(eng).reset()
            futs += fs
            out[pf] = (same, eng.kv_swap_ins > ins0,
                       counter(eng, "acp_engine_kv_prefetch_commits_total") > before)
        return out, futs

    out, _futs, _ = both(pair, case)
    assert out == {False: (True, True, False), True: (True, True, True)}


def test_prefetch_error_degrades_to_blocking_copy_identically(pair):
    def case(eng):
        eng.prefill_chunk = 16
        _pool(eng, 10)
        faults(eng).arm("engine.prefetch_error", times=2)
        aborts0 = len(eng.flight.events(kind="prefetch_abort", last=0))
        same, futs = _pressure_run(eng)
        return (same, len(eng.flight.events(kind="prefetch_abort", last=0)) > aborts0), futs

    out, _futs, _ = both(pair, case)
    assert out == (True, True)


def test_staged_scatter_absorbs_into_megastep_swaps_phase(pair):
    """A staged restore chunk commits inside a fused cycle: a megastep
    program key with an ``s`` phase, on both profilers."""

    def case(eng):
        eng.prefill_chunk = 16
        _pool(eng, 10)
        same, futs = _pressure_run(eng)
        keys = sorted(k for k in eng.profiler.stats()["programs"]
                      if k.startswith("megastep[paged,s"))
        return (same, keys), futs

    (same, keys), _futs, _ = both(pair, case)
    assert same and keys


def test_queue_full_site_sheds(pair):
    """``engine.queue_full``: the submit sheds as if the queue were at its
    cap; the timeline is submit -> shed."""

    def case(eng):
        faults(eng).arm("engine.queue_full")
        fut = eng.submit("shed me", sampling(eng)(max_tokens=4))
        with pytest.raises(Exception, match="queue full"):
            fut.result(timeout=10)
        return eng.stats()["sheds"] > 0, [fut]

    out, (fut,), _ = both(pair, case)
    assert out is True
    assert [e["kind"] for e in pair.port.flight.timeline(fut.rid)] == ["submit", "shed"]


def test_tool_sites_slow_and_fail_an_mcp_execution():
    """``tool.slow`` / ``tool.error`` on the port's ToolCall controller: the
    error becomes the ToolCall's failure (a tool result, never a crash)."""
    import asyncio

    from agentcontrolplane_tpu_torch.controllers import toolcall as tc_mod

    calls = []

    class _MCP:
        async def call_tool(self, server, tool, args):
            calls.append((server, tool))
            return "ok"

    rec = SimpleNamespace(fail=[])

    class _Ctl:
        mcp_manager = _MCP()

        def _update_status(self, tc):
            pass

        def _fail(self, tc, msg):
            rec.fail.append(msg)
            return "failed"

    src = tc_mod.ToolCallReconciler
    PORT_FAULTS.arm("tool.slow", seconds=0.05)
    PORT_FAULTS.arm("tool.error")
    try:
        t0 = time.monotonic()
        tc = SimpleNamespace(spec=SimpleNamespace(tool_ref=SimpleNamespace(name="srv__tool"),
                                                  arguments="{}"),
                             status=SimpleNamespace())
        out = asyncio.run(src._execute_mcp(_Ctl(), tc))
        assert out == "failed" and rec.fail == ["fault injection: tool error"]
        assert time.monotonic() - t0 >= 0.05 and calls == []
    finally:
        PORT_FAULTS.reset()
