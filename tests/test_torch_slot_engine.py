"""The slot KV layout's engine on the CPU: the port's
``Engine(kv_layout="slot")`` against the JAX package's
``Engine(kv_layout="slot")``.

One module-scoped pair on the tiny f32 preset with the same weights (the
stop token's lm_head column a scaled copy of a frequent token's, as in
``tests/test_torch_engine.py``), both with a 4 MiB host tier and the armed
invariant audit after every cycle. Each case runs on the reference, then
on the port, and must give equal outcomes (byte-identical greedy streams),
equal counter deltas, equal per-request flight event sequences (kinds,
slots and details without clocks), equal new profiler program keys and
equal new megastep keys. The cases: a plain burst, chunked prefill with
chunks of 8 and 16, a busy run with the megastep on and off, prefix-cache
hits (a device copy of the rows), park and adopt, a forced preemption and
its resume, speculation on against off, the host tier (swap-out on a
preemption and on a park expiry, the restores checked row for row against
the entries on the port, an ``export_kv`` handoff injected into a second
engine) and constrained lanes.

Outside the cases: ``stats()`` carries the reference's keys with
``kv_layout == "slot"``; the audit is clean after a burst; a slot engine
under a serving group raises; and the same traffic on a port/reference pair
emits the same ``acp_engine_*`` metric series on both layouts, with equal
deltas of the deterministic counters.
"""

import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from agentcontrolplane_tpu.engine.engine import Engine as JaxEngine
from agentcontrolplane_tpu.engine.engine import SamplingParams as JaxSampling
from agentcontrolplane_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from agentcontrolplane_tpu.models import llama as jl
from agentcontrolplane_tpu.observability.metrics import REGISTRY as JAX_REGISTRY
from agentcontrolplane_tpu.parallel.mesh import make_mesh
from agentcontrolplane_tpu.testing import FAULTS
from agentcontrolplane_tpu_torch.engine.engine import Engine, SamplingParams
from agentcontrolplane_tpu_torch.engine.invariants import verify_engine
from agentcontrolplane_tpu_torch.engine.weights import params_from_jax
from agentcontrolplane_tpu_torch.faults import FAULTS as PORT_FAULTS
from agentcontrolplane_tpu_torch.models import llama as tl
from agentcontrolplane_tpu_torch.observability.metrics import REGISTRY as PORT_REGISTRY
from agentcontrolplane_tpu_torch.parallel.mesh import ServingGroup

from .test_torch_chunked import _drop_parked, _idle

JCFG = dataclasses.replace(jl.PRESETS["tiny"], vocab_size=512, max_seq_len=256, n_kv_heads=2)
TCFG = dataclasses.replace(tl.PRESETS["tiny"], vocab_size=512, max_seq_len=256, n_kv_heads=2)
# a row past the largest bucket (64) spills; buckets and chunks need no
# page alignment on the slot layout
KW = dict(max_slots=4, max_ctx=128, prefill_buckets=(32, 64), width_buckets=(1, 2, 4),
          decode_block_size=4)
HOST = 1 << 22
EOT = 260  # ByteTokenizer's <|eot_id|>, a stop token
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
ATTRACTOR = "abcabcabc " * 8  # the n-gram drafter proposes on it
# detail fields that are clocks (or another request's id), not decisions
VOLATILE = {"stall_s", "seconds_left", "leader", "error"}


def _weights() -> dict:
    p = jax.tree_util.tree_map(np.array, jl.init_params(JCFG, jax.random.key(0)))
    p["lm_head"][:, EOT] = p["lm_head"][:, 289] * 1.05
    return p


def _ref_engine(weights, **kw) -> JaxEngine:
    return JaxEngine(
        config=JCFG, params=jax.tree_util.tree_map(jnp.asarray, weights),
        tokenizer=JaxByteTokenizer(), mesh=make_mesh({"tp": 1}, devices=jax.devices()[:1]),
        **{"kv_layout": "slot", "spec_len": 0, "autopilot": False, **KW, **kw},
    )


def _port_engine(params, **kw) -> Engine:
    return Engine(TCFG, params, device="cpu", **{"kv_layout": "slot", **KW, **kw})


class _RestoreChecks:
    """On a port slot engine: every completed restore's rows against its
    entry's, bit for bit."""

    def __init__(self, engine: Engine):
        self.violations: list[str] = []
        self.restores = 0
        finish = engine._finish_swap_in

        def checked(slot, sl):
            n = sl.prefill_pos
            e = sl.swap_entry
            rows = {"k": e.k, "v": e.v, **({"ks": e.k_scale, "vs": e.v_scale}
                                           if "ks" in engine.cache else {})}
            for name, want in rows.items():
                if not torch.equal(engine.cache[name][:, slot, :n], want[:, :n]):
                    self.violations.append(f"slot {slot}: restored {name} rows differ")
            self.restores += 1
            finish(slot, sl)

        engine._finish_swap_in = checked


@pytest.fixture(scope="module")
def engines():
    weights = _weights()
    params = params_from_jax(weights, TCFG, device="cpu")
    ref = _ref_engine(weights, host_kv_bytes=HOST, check_invariants=True)
    port = _port_engine(params, host_kv_bytes=HOST, check_invariants=True)
    checks = _RestoreChecks(port)
    ref.start()
    port.start()
    try:
        yield SimpleNamespace(ref=ref, port=port, checks=checks, weights=weights, params=params)
    finally:
        FAULTS.reset()
        PORT_FAULTS.reset()
        ref.stop()
        port.stop()


def _rest(eng) -> None:
    """Idle, nothing parked, empty prefix cache and host tier, the module's
    knobs, no fused shape seen."""
    _idle(eng)
    _drop_parked(eng)
    while eng._evict_one_prefix_entry():
        pass
    eng.set_host_kv_bytes(0)
    eng.set_host_kv_bytes(HOST)
    eng.prefill_chunk, eng.token_budget, eng.spec_len = 0, 0, 0
    eng.megastep, eng.megastep_max_programs = True, 32
    eng._prefix_enabled, eng.park_max_s = True, 30.0
    eng._megastep_shapes.clear()


@pytest.fixture
def pair(engines):
    for eng in (engines.ref, engines.port):
        _rest(eng)
    n0 = len(engines.checks.violations)
    yield engines
    FAULTS.reset()
    PORT_FAULTS.reset()
    for eng in (engines.ref, engines.port):
        _rest(eng)
        assert len(eng._free) == eng.max_slots
    assert engines.checks.violations[n0:] == []


def _is_port(eng) -> bool:
    return isinstance(eng, Engine)


def _sampling(eng):
    return SamplingParams if _is_port(eng) else JaxSampling


def _faults(eng):
    return PORT_FAULTS if _is_port(eng) else FAULTS


def _counters(eng) -> dict:
    return {"decode_steps": eng.decode_steps, "preemptions": eng.preemptions,
            "parks": eng.parks, "adoptions": eng.park_adoptions,
            "releases": eng.park_releases, "hits": eng._prefix_hits,
            "misses": eng._prefix_misses, "chunks": eng.prefill_chunks,
            "megastep": eng.megastep_dispatches, "fallbacks": eng.megastep_fallbacks,
            "proposed": eng.spec_proposed, "accepted": eng.spec_accepted,
            "verify": eng.spec_dispatches, "swap_outs": eng.kv_swap_outs,
            "swap_ins": eng.kv_swap_ins, "injects": eng.kv_injects,
            "early_calls": eng.tool_calls_early}


def _megastep_keys(eng) -> set:
    if _is_port(eng):
        return set(eng._megastep_shapes)
    return {f"megastep[{layout},{'+'.join(parts)}{tbl}]"
            for layout, parts, tbl in eng._megastep_shapes}


def _programs(eng) -> dict:
    return {k: v["dispatches"] for k, v in eng.profiler.stats()["programs"].items()}


def _sequence(eng, rid: str) -> list:
    return [(e["kind"], e.get("slot"),
             {k: v for k, v in (e.get("detail") or {}).items() if k not in VOLATILE})
            for e in eng.flight.timeline(rid) or []]


def _run(eng, case) -> tuple:
    """``case(engine, SamplingParams class)`` with every submitted rid
    recorded; returns (outcome, rids, counter deltas, new program keys, new
    megastep keys)."""
    rids: list[str] = []
    submit = eng.submit

    def recording(*a, **kw):
        fut = submit(*a, **kw)
        rids.append(fut.rid)
        return fut

    c0, p0, m0 = _counters(eng), _programs(eng), _megastep_keys(eng)
    eng.submit = recording
    try:
        out = case(eng, _sampling(eng))
    finally:
        del eng.submit
    _idle(eng)
    c1, p1 = _counters(eng), _programs(eng)
    new_programs = {k for k, n in p1.items() if n != p0.get(k, 0)}
    return (out, rids, {k: c1[k] - c0[k] for k in c0}, new_programs,
            _megastep_keys(eng) - m0)


def _both(pair, case) -> tuple:
    """The case on the reference, then on the port: equal outcomes, counter
    deltas, program and megastep keys, and flight sequences per request.
    Returns the port's (outcome, counter deltas, program keys)."""
    ref = _run(pair.ref, case)
    port = _run(pair.port, case)
    (ref_out, ref_rids, ref_d, ref_p, ref_m), (out, rids, d, p, m) = ref, port
    assert out == ref_out
    assert d == ref_d
    assert p == ref_p
    assert m == ref_m
    assert len(rids) == len(ref_rids)
    for a, b in zip(ref_rids, rids):
        assert _sequence(pair.port, b) == _sequence(pair.ref, a)
    return out, d, p


def _streams(futs) -> list:
    return [(list(r.tokens), r.finish_reason, r.preempt_count)
            for r in (f.result(timeout=240) for f in futs)]


PROMPTS = ["short one", "a prompt of middling length " * 2, "x" * 70,
           "the longest prompt here spills past the largest bucket " * 2]


def _burst(eng, sp, prompts=PROMPTS, max_tokens=10):
    s = sp(temperature=0.0, max_tokens=max_tokens)
    with eng.hold_admission():
        futs = [eng.submit(p, s) for p in prompts]
    return _streams(futs)


# -- the cases -----------------------------------------------------------------------


def test_burst_matches_the_reference(pair):
    out, d, progs = _both(pair, lambda eng, sp: _burst(eng, sp))
    assert all(n for n, _r, _p in out) and d["decode_steps"] > 0
    assert any(k.startswith("decode[slot,") for k in progs)
    assert any(k.startswith("spill[slot,") for k in progs)  # the 110-token row


@pytest.mark.parametrize("chunk", [8, 16])
def test_chunked_prefill_matches_the_reference(pair, chunk):
    def case(eng, sp):
        eng.prefill_chunk = chunk
        return _burst(eng, sp)

    out, d, progs = _both(pair, case)
    assert d["chunks"] > len(PROMPTS) and any(k.startswith("megastep[slot,") for k in progs)


def _busy(eng, sp):
    """A decoding anchor with long prompts chunking through it and a short
    latecomer: cycles carry mid chunks, continuation finals and decode."""
    anchor = eng.submit(ATTRACTOR, sp(temperature=0.0, max_tokens=24))
    deadline = time.monotonic() + 60
    while eng.decode_steps == 0 and time.monotonic() < deadline:
        time.sleep(0.002)
    s = sp(temperature=0.0, max_tokens=8)
    with eng.hold_admission():
        futs = [eng.submit("the quick brown fox jumps over " * 3, s),
                eng.submit("pack my box with five dozen jugs " * 2, s),
                eng.submit("hello small prompt", s)]
    return _streams([anchor, *futs])


@pytest.mark.parametrize("megastep", [True, False], ids=["megastep", "split"])
def test_busy_chunked_run_matches_the_reference(pair, megastep):
    def case(eng, sp):
        eng.prefill_chunk, eng.megastep, eng._prefix_enabled = 16, megastep, False
        return _busy(eng, sp)

    out, d, _progs = _both(pair, case)
    assert (d["megastep"] > 0) is megastep and d["chunks"] > 0


def test_prefix_cache_hit_copies_the_rows(pair):
    system = "you are an agent with tools; answer in one line. " * 2

    def case(eng, sp):
        s = sp(temperature=0.0, max_tokens=6)
        first = list(eng.generate(system + "first question", s).tokens)
        second = list(eng.generate(system + "second question", s).tokens)
        return first, second

    (_first, _second), d, progs = _both(pair, case)
    assert d["hits"] == 1 and d["misses"] == 1
    assert any(k.startswith("prefix_copy[") for k in progs)
    assert any(k.startswith("prefix_extract[") for k in progs)


def test_park_and_adopt(pair):
    turn1 = "persona prompt for a two turn chat. " * 2

    def case(eng, sp):
        eng._prefix_enabled = False
        s = sp(temperature=0.0, max_tokens=6)
        cold = list(eng.generate(turn1 + "and a follow up", s).tokens)
        first = eng.submit(turn1, s, park=True).result(60)
        second = eng.generate(turn1 + "and a follow up", s)
        return cold, list(first.tokens), list(second.tokens)

    (cold, _first, second), d, _progs = _both(pair, case)
    assert second == cold and d["parks"] == 1 and d["adoptions"] == 1


def test_forced_preempt_and_resume(pair):
    def case(eng, sp):
        eng.set_host_kv_bytes(0)
        s = sp(temperature=0.0, max_tokens=16)
        base = list(eng.generate("hello world " * 4, s).tokens)
        _faults(eng).arm("engine.force_preempt", after_steps=eng.decode_steps + 4)
        r = eng.generate("hello world " * 4, s)
        _faults(eng).reset()
        return base, list(r.tokens), r.preempt_count

    (base, got, preempts), d, _progs = _both(pair, case)
    assert got == base and preempts == 1 and d["preemptions"] == 1 and d["swap_outs"] == 0


def test_spec_on_matches_spec_off(pair):
    def case(eng, sp):
        s = sp(temperature=0.0, max_tokens=20)
        off = list(eng.generate(ATTRACTOR, s).tokens)
        eng.spec_len = 4
        on = list(eng.generate(ATTRACTOR, s).tokens)
        eng.spec_len = 0
        return off, on

    (off, on), d, progs = _both(pair, case)
    assert on == off and d["verify"] > 0 and d["accepted"] > 0
    assert any(k.startswith("spec_verify[slot,") for k in progs)


def test_host_tier_swap_outs_and_restores(pair):
    """A forced preemption swaps the slot's rows out and the resume restores
    them; an expiring parked slot swaps out and the next turn restores it by
    token prefix. Every restore is checked row for row on the port."""
    turn1 = "persona " * 5
    n0 = pair.checks.restores

    def case(eng, sp):
        eng._prefix_enabled = False
        s = sp(temperature=0.0, max_tokens=12)
        base = list(eng.generate("hello world " * 4, s).tokens)
        _faults(eng).arm("engine.force_preempt", after_steps=eng.decode_steps + 4)
        r = eng.generate("hello world " * 4, s)
        _faults(eng).reset()
        cold = list(eng.generate(turn1 + "more text here", s).tokens)
        outs0 = eng.kv_swap_outs
        eng.park_max_s = 0.2
        eng.submit(turn1, s, park=True).result(60)
        deadline = time.monotonic() + 10
        while eng.kv_swap_outs == outs0:
            assert time.monotonic() < deadline, "park expiry never swapped out"
            time.sleep(0.02)
        again = list(eng.generate(turn1 + "more text here", s).tokens)
        return base, list(r.tokens), r.preempt_count, cold, again

    (base, got, preempts, cold, again), d, progs = _both(pair, case)
    assert got == base and preempts == 1 and again == cold
    assert d["swap_outs"] == 2 and d["swap_ins"] == 2
    assert pair.checks.restores - n0 == 2
    assert any(k.startswith("swap_extract[") for k in progs)
    assert any(k.startswith("swap_restore[") for k in progs)


def test_export_handoff_injects_and_restores_bit_equal(pair):
    """``export_kv=True`` on the slot layout: rows [0, cut) below the row's
    last token, the port's within 2e-4 of the reference's. Injected into a
    second port slot engine, they restore bit for bit and the stream equals
    a cold run's."""
    prompt = "handoff persona: answer tersely. "
    res = {}
    for eng in (pair.ref, pair.port):
        fut = eng.submit(prompt, _sampling(eng)(temperature=0.0, max_tokens=6), export_kv=True)
        res[type(eng)] = fut.result(60)
    ref_e, port_e = res[JaxEngine].kv_handoff, res[Engine].kv_handoff
    assert res[Engine].tokens == res[JaxEngine].tokens
    assert port_e.tokens == ref_e.tokens and port_e.cut == len(prompt) - 1
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(port_e, name).numpy(), getattr(ref_e, name),
                                   **LOGIT_TOL)
    follow = prompt + "and then?"
    sp = SamplingParams(temperature=0.0, max_tokens=6)
    cold = list(pair.port.generate(follow, sp).tokens)
    second = _port_engine(pair.params, host_kv_bytes=HOST)
    checks = _RestoreChecks(second)
    second.start()
    try:
        assert second.inject_host_kv(port_e)
        r = second.generate(follow, sp)
        mem = second.stats()["memory"]["host_kv"]
    finally:
        second.stop()
    assert list(r.tokens) == cold
    assert (mem["injects"], mem["swap_ins"], mem["entries"]) == (1, 1, 0)
    assert checks.restores == 1 and checks.violations == []


def test_constrained_lanes(pair):
    def case(eng, sp):
        with eng.hold_admission():
            futs = [eng.submit("call a tool", sp(temperature=0.0, max_tokens=24,
                                                  json_only=True)),
                    eng.submit("plain text lane", sp(temperature=0.0, max_tokens=12)),
                    eng.submit("forced envelope", sp(
                        temperature=0.0, max_tokens=24, json_only=True,
                        forced_prefix=tuple(b'{"name": "t1", "arguments": {'))),
                    ]
        return _streams(futs)

    out, _d, progs = _both(pair, case)
    assert any("+tbl" in k for k in progs)
    assert out[2][0][:5] == list(b'{"nam')


# -- outside the cases ---------------------------------------------------------------


def _key_paths(tree: dict, prefix: str = "") -> set:
    out = set()
    for k, v in tree.items():
        path = f"{prefix}{k}"
        out.add(path)
        if isinstance(v, dict) and k not in ("programs", "mesh"):
            out |= _key_paths(v, path + ".")
    return out


def test_stats_carry_the_reference_keys(pair):
    ref, port = pair.ref.stats(), pair.port.stats()
    assert port["kv_layout"] == ref["kv_layout"] == "slot"
    assert "kv_pages" not in port and "kv_pages" not in ref
    missing = _key_paths(ref) - _key_paths(port)
    assert missing == set(), missing
    # the port's own additions, the same on both layouts: its device and
    # dtype, its rank's share, the walk's launch counters, and counts the
    # reference keeps only as attributes
    extra = {p.split(".")[0] if not p.startswith("model.") else p
             for p in _key_paths(port) - _key_paths(ref)}
    assert extra == {"device", "model.dtype", "rank", "walk_launches",
                     "constraint_table_bytes", "constraint_table_build_s", "tool_calls_early",
                     "requests_prefilled", "prefill_tokens"}, extra
    dedup = port["memory"]["prefix_dedup"]
    assert dedup["enabled"] is ref["memory"]["prefix_dedup"]["enabled"] is False
    assert port["memory"]["quantized_kv"]["pages"] == 0


def test_audit_clean_after_a_burst(pair):
    _both(pair, lambda eng, sp: _burst(eng, sp, PROMPTS * 2, max_tokens=6))
    assert verify_engine(pair.port) == []
    assert pair.port.ensure_running()  # the armed audit never crashed the loop


def test_slot_layout_under_a_group_raises():
    group = ServingGroup(tp=1, sp=1, rank=0, tp_rank=0, sp_rank=0)
    with pytest.raises(ValueError, match="A.14"):
        Engine(TCFG, device="cpu", kv_layout="slot", group=group, **KW)
    with pytest.raises(ValueError, match="kv_layout"):
        Engine(TCFG, device="cpu", kv_layout="pages", **KW)


# -- the engine's metric series (both layouts) ---------------------------------------


class _Touched:
    """The metric names a registry is written under while armed; the
    registries are process-global, so the test reads what the traffic
    wrote, not what was there before."""

    def __init__(self, registry):
        self.registry, self.names = registry, set()

    def __enter__(self):
        for method in ("counter_add", "gauge_set", "observe"):
            real = getattr(self.registry, method)

            def wrapped(name, *a, _real=real, **kw):
                self.names.add(name)
                return _real(name, *a, **kw)

            setattr(self.registry, method, wrapped)
        return self

    def __exit__(self, *exc):
        for method in ("counter_add", "gauge_set", "observe"):
            delattr(self.registry, method)


DETERMINISTIC = ("acp_engine_requests_total", "acp_engine_tokens_total",
                 "acp_engine_tool_calls_early_total", "acp_engine_parks_total",
                 "acp_engine_park_adoptions_total", "acp_engine_prefix_cache_hit_requests",
                 "acp_engine_prefix_cache_miss_requests")


def _counter(registry, name: str) -> float:
    m = registry._metrics.get(name)
    return 0.0 if m is None else sum(m.values.values())


@pytest.mark.parametrize("kv_layout", ["slot", "paged"])
def test_engine_metric_series_match_the_reference(engines, kv_layout):
    """A fresh pair per layout (init-time gauges count), the same traffic
    on each: a parked turn and its follow-up, a tool call streamed early, a
    prefix-cache hit. Equal sets of ``acp_engine_*`` names written, all of
    them rendered, the nine series of ROADMAP C.2 among them, and equal
    deltas of the deterministic counters."""
    call = '{"name": "t1", "arguments": {"x": 1}}'
    seen = {}
    for registry, make, sp in (
        (JAX_REGISTRY, lambda: _ref_engine(engines.weights, kv_layout=kv_layout, page_size=8),
         JaxSampling),
        (PORT_REGISTRY, lambda: _port_engine(engines.params, kv_layout=kv_layout, page_size=8),
         SamplingParams),
    ):
        before = {n: _counter(registry, n) for n in DETERMINISTIC}
        with _Touched(registry) as touched:
            eng = make()
            eng.start()
            try:
                s = sp(temperature=0.0, max_tokens=8)
                system = "system prompt for the metrics case. " * 2
                eng.submit(system + "turn one", s, park=True).result(60)
                eng.generate(system + "turn one and two", s)
                forced = sp(temperature=0.0, max_tokens=24, json_only=True,
                            forced_prefix=tuple(call[:-4].encode()))
                eng.submit("use the tool", forced, on_tool_call=lambda i, tc: None).result(60)
                eng.generate(system + "another question", s)
                _idle(eng)
            finally:
                eng.stop()
        # the stall watchdog reads wall time (the reference's first
        # dispatches compile), so whether it fires is not the traffic's
        names = {n for n in touched.names
                 if n.startswith("acp_engine_") and n != "acp_engine_stalls_total"}
        rendered = registry.render()
        assert all(f"# TYPE {n} " in rendered for n in names)
        seen[registry is PORT_REGISTRY] = (
            names, {n: _counter(registry, n) - before[n] for n in DETERMINISTIC})
    (ref_names, ref_d), (names, d) = seen[False], seen[True]
    assert names == ref_names, (names ^ ref_names)
    assert d == ref_d
    c2 = {"acp_engine_ttft_seconds", "acp_engine_requests_total", "acp_engine_tokens_total",
          "acp_engine_tool_calls_early_total", "acp_engine_tool_overlap_saved_seconds",
          "acp_engine_preempted_waiting", "acp_engine_parked_slots", "acp_engine_weight_bytes",
          "acp_engine_quantized_kv_pages"}
    assert c2 <= names, c2 - names
    assert d["acp_engine_requests_total"] == 4 and d["acp_engine_tool_calls_early_total"] >= 1
