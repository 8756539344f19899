"""The host-RAM KV tier and the prefill -> decode handoff on the CPU: the
port against the JAX package's paged engine.

- ``ops/paged.py::HostKVPool`` against the reference class over the same
  calls (``tests/engine/test_host_pool.py``'s seven pool cases): equal
  results, ``used_bytes`` and audits, the port's entries holding torch
  tensors where the reference's hold numpy arrays.
- Cases replayed from ``tests/engine/test_kv_memory.py``,
  ``test_prefetch.py`` and ``test_quant_kv.py`` (paged) on one
  module-scoped pair on the tiny f32 preset with the same weights, both
  built with ``host_kv_bytes = 4 MiB``: the JAX engine (``mesh`` of one
  rank) and the port's. Each case gives
  byte-identical streams and equal swap, inject and prefetch counters,
  preemptions, prefill chunks, ``stats()["memory"]["host_kv"]`` and new
  megastep keys (``s...`` included). The reference's tighter pools
  (``kv_pages=10``/``12``) are made by holding pages while the engines
  idle. Its ``engine.force_preempt`` and ``engine.preempt_mid_prefill``
  fault sites are armed alike on both engines, each on its own package's
  ``FAULTS``; its flight-recorder checks are replaced here by recording the
  entries the pools take and the rows each restore lands
  (``tests/test_torch_faults.py`` replays them on both recorders).
- On the port every cycle checks the host pool's audit (``used_bytes`` is
  the sum of its entries and within the budget), and every completed
  restore checks that the slot's pages hold the entry's rows bit for bit.
- The int8 pair restores int8 bytes and their f32 scale twins verbatim.
- A port export is within 2e-4 of the reference's and restores
  bit-exactly in a second port engine it is injected into.
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
from agentcontrolplane_tpu.ops import paged as ref_paged
from agentcontrolplane_tpu.parallel.mesh import make_mesh
from agentcontrolplane_tpu.testing import FAULTS
from agentcontrolplane_tpu_torch.faults import FAULTS as PORT_FAULTS
from agentcontrolplane_tpu_torch.engine.engine import Engine, SamplingParams
from agentcontrolplane_tpu_torch.engine.tokenizer import ByteTokenizer
from agentcontrolplane_tpu_torch.engine.weights import params_from_jax
from agentcontrolplane_tpu_torch.models import llama as tl
from agentcontrolplane_tpu_torch.observability.metrics import REGISTRY as PORT_REGISTRY
from agentcontrolplane_tpu_torch.ops import paged as port_paged
from agentcontrolplane_tpu_torch.parallel.mesh import ServingGroup

from .test_torch_chunked import _drop_parked, _Hold, _idle

# the reference's own test configuration (tests/engine/test_kv_memory.py)
JCFG = dataclasses.replace(jl.PRESETS["tiny"], vocab_size=512, max_seq_len=256, n_kv_heads=2)
TCFG = dataclasses.replace(tl.PRESETS["tiny"], vocab_size=512, max_seq_len=256, n_kv_heads=2)
KW = dict(max_slots=4, max_ctx=64, prefill_buckets=(32, 64), decode_block_size=4, page_size=8,
          kv_pages=33)
P = KW["page_size"]
HOST = 1 << 22
EOT = 260  # ByteTokenizer's <|eot_id|>, a stop token
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)  # the bar of tests/test_torch_model.py
PROMPTS = [ch * 20 for ch in "abcdef"]
PREFETCH = "acp_engine_kv_prefetch_commits_total"


def _weights() -> dict:
    p = jax.tree_util.tree_map(np.array, jl.init_params(JCFG, jax.random.key(0)))
    p["lm_head"][:, EOT] = p["lm_head"][:, 289] * 1.05
    return p


# -- HostKVPool (tests/engine/test_host_pool.py) -------------------------------------


def _entry(cls, rid: str, n_tokens: int, toks=None):
    shape = (2, n_tokens, 2, 4)  # [L, T, H_kv, d]
    tokens = tuple(toks if toks is not None else range(n_tokens))
    if cls is port_paged.HostKVEntry:
        return cls(rid=rid, tokens=tokens, k=torch.zeros(shape), v=torch.zeros(shape))
    return cls(rid=rid, tokens=tokens, k=np.zeros(shape, dtype=np.float32),
               v=np.zeros(shape, dtype=np.float32))


def _rid(e):
    return None if e is None else e.rid


def _put_get_pop(mk, pool_cls, eb):
    pool, log = pool_cls(10 * eb), []
    e = mk("r1", 8)
    log += [pool.put(e), pool.used_bytes == e.nbytes, len(pool), pool.get("r1") is e,
            pool.get("nope"), pool.audit(), pool.pop("r1") is e, pool.used_bytes, len(pool),
            pool.pop("r1")]
    return log


def _reput(mk, pool_cls, eb):
    pool = pool_cls(10 * eb)
    pool.put(mk("r1", 8))
    bigger = mk("r1", 16)
    return [pool.put(bigger), len(pool), pool.used_bytes == bigger.nbytes, pool.used_bytes]


def _lru(mk, pool_cls, eb):
    pool, log = pool_cls(3 * eb), []
    for rid in ("a", "b", "c"):
        log.append(pool.put(mk(rid, 8)))
    pool.get("a")  # a lookup refreshes recency
    log += [pool.put(mk("d", 8)), _rid(pool.get("b")), _rid(pool.get("a")),
            pool.used_bytes <= pool.max_bytes]
    return log


def _match_refreshes(mk, pool_cls, eb):
    pool = pool_cls(2 * eb)
    pool.put(mk("old", 8, [1] * 8))
    pool.put(mk("new", 8, [2] * 8))
    log = [_rid(pool.match_prefix([1] * 8 + [3]))]
    pool.put(mk("third", 8, [4] * 8))
    return log + [_rid(pool.get("new")), _rid(pool.get("old"))]


def _oversized(mk, pool_cls, eb):
    pool = pool_cls(eb)
    pool.put(mk("small", 8))
    return [pool.put(mk("huge", 64)), _rid(pool.get("small")), pool.used_bytes]


def _longest_strict(mk, pool_cls, eb):
    pool = pool_cls(10 * eb)
    pool.put(mk("short", 4, [1, 2, 3, 4]))
    pool.put(mk("long", 8, [1, 2, 3, 4, 5, 6, 7, 8]))
    pool.put(mk("other", 6, [9] * 6))
    return [_rid(pool.match_prefix([1, 2, 3, 4, 5, 6, 7, 8, 10, 11])),
            _rid(pool.match_prefix([1, 2, 3, 4])), _rid(pool.match_prefix([1, 2, 3, 4, 99])),
            _rid(pool.match_prefix([42]))]


def _clear(mk, pool_cls, eb):
    pool = pool_cls(10 * eb)
    pool.put(mk("a", 8))
    pool.clear()
    return [pool.used_bytes, len(pool)]


POOL_CASES = {
    "put_get_pop_accounting": (_put_get_pop, [True, True, 1, True, None, (1024, {"r1": 1024}),
                                              True, 0, 0, None]),
    "reput_same_rid_replaces_without_double_count": (_reput, [True, 1, True, 2048]),
    "lru_eviction_within_budget": (_lru, [True, True, True, True, None, "a", True]),
    "match_prefix_refreshes_recency": (_match_refreshes, ["old", None, "old"]),
    "oversized_entry_refused": (_oversized, [False, "small", 1024]),
    "match_prefix_longest_strict": (_longest_strict, ["long", None, "short", None]),
    "clear_resets_accounting": (_clear, [0, 0]),
}


@pytest.mark.parametrize("name", list(POOL_CASES))
def test_host_pool_matches_the_reference(name):
    """The same calls on both pools give the same results, which are the
    reference test's own expectations."""
    fn, want = POOL_CASES[name]
    got = {}
    for entry_cls, pool_cls in ((ref_paged.HostKVEntry, ref_paged.HostKVPool),
                                (port_paged.HostKVEntry, port_paged.HostKVPool)):
        def mk(rid, n, toks=None, cls=entry_cls):
            return _entry(cls, rid, n, toks)

        eb = mk("x", 8).nbytes
        assert eb == 1024  # 2*8*2*4 f32 values * 2 tensors
        got[pool_cls] = fn(mk, pool_cls, eb)
    assert got[port_paged.HostKVPool] == got[ref_paged.HostKVPool] == want


def test_entry_bytes_count_scale_twins():
    """An int8 entry's bytes are its int8 rows plus its f32 scale rows,
    as the reference counts them."""
    k8 = np.zeros((2, 16, 2, 4), dtype=np.int8)
    sc = np.ones((2, 16, 2), dtype=np.float32)
    ref = ref_paged.HostKVEntry("r", tuple(range(16)), k8, k8, sc, sc)
    port = port_paged.HostKVEntry("r", tuple(range(16)), torch.from_numpy(k8),
                                  torch.from_numpy(k8), torch.from_numpy(sc),
                                  torch.from_numpy(sc))
    assert port.nbytes == ref.nbytes == 2 * 256 + 2 * 256 and port.cut == ref.cut == 16


# -- the engines ---------------------------------------------------------------------


class _PortChecks:
    """On a port engine: the host pool's audit after every dispatch cycle,
    and every completed restore's pages against its entry's rows."""

    def __init__(self, engine: Engine):
        self.engine = engine
        self.violations: list[str] = []
        self.restores = 0
        cycle, finish = engine._dispatch_once, engine._finish_swap_in

        def audited():
            cycle()
            pool = engine._host_pool
            if pool is not None:
                used, entries = pool.audit()
                if used != sum(entries.values()) or used > pool.max_bytes:
                    self.violations.append(f"host pool audit: {used} of {pool.max_bytes}, "
                                           f"entries {entries}")

        def checked(slot, sl):
            self.check_restore(slot, sl)
            finish(slot, sl)

        engine._dispatch_once = audited
        engine._finish_swap_in = checked

    def check_restore(self, slot: int, sl) -> None:
        e = self.engine
        n = sl.prefill_pos
        pages = e._slot_pages[slot][: n // P]
        entry = sl.swap_entry
        rows = {"k": entry.k, "v": entry.v}
        if "ks" in e.cache:
            rows.update(ks=entry.k_scale, vs=entry.v_scale)
        for name, want in rows.items():
            pool = e.cache[name]
            got = pool[:, pages].reshape(pool.shape[0], n, *pool.shape[3:])
            if not torch.equal(got, want[:, :n]):
                self.violations.append(f"slot {slot}: restored {name} rows differ")
        self.restores += 1


def _ref_engine(weights, **kw) -> JaxEngine:
    return JaxEngine(
        config=JCFG, params=jax.tree_util.tree_map(jnp.asarray, weights),
        tokenizer=JaxByteTokenizer(), mesh=make_mesh({"tp": 1}, devices=jax.devices()[:1]),
        kv_layout="paged", autopilot=False, spec_len=0, **KW, **kw,
    )


@pytest.fixture(scope="module")
def engines():
    weights = _weights()
    ref = _ref_engine(weights, host_kv_bytes=HOST)
    params = params_from_jax(weights, TCFG, device="cpu")
    port = Engine(TCFG, params, device="cpu", host_kv_bytes=HOST, **KW)
    checks = _PortChecks(port)
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
    """Idle, no parked slot, an empty prefix cache and host tier, no fused
    shape seen yet, and the module's knobs."""
    _idle(eng)
    _drop_parked(eng)
    while eng._evict_one_prefix_entry():
        pass
    eng.set_host_kv_bytes(0)
    eng.set_host_kv_bytes(HOST)
    eng.prefill_chunk, eng.token_budget, eng.prefix_dedup = 0, 0, True
    eng.megastep, eng.megastep_max_programs, eng.host_prefetch = True, 32, True
    eng._prefix_enabled, eng.spec_len, eng.park_max_s = True, 0, 30.0
    eng._megastep_shapes.clear()  # each case's keys are its own


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
        assert eng._allocator.free_count == eng.num_pages - 1
        assert len(eng._free) == eng.max_slots
    assert engines.checks.violations[n0:] == []


def _registry(eng):
    return PORT_REGISTRY if isinstance(eng, Engine) else JAX_REGISTRY


def _counter(eng, name: str) -> float:
    m = _registry(eng)._metrics.get(name)
    return 0.0 if m is None else m.values.get((), 0.0)


def _keys(eng) -> set:
    if isinstance(eng, Engine):
        return set(eng._megastep_shapes)
    return {f"megastep[{layout},{'+'.join(parts)}{tbl}]"
            for layout, parts, tbl in eng._megastep_shapes}


def _counters(eng) -> dict:
    return {"swap_outs": eng.kv_swap_outs, "swap_ins": eng.kv_swap_ins,
            "injects": eng.kv_injects, "prefetch_commits": _counter(eng, PREFETCH),
            "preemptions": eng.preemptions, "prefill_chunks": eng.prefill_chunks,
            "megastep_dispatches": eng.megastep_dispatches,
            "megastep_fallbacks": eng.megastep_fallbacks}


def _both(pair, case) -> tuple:
    """``case(engine, SamplingParams class)`` on the reference, then on
    the port: equal outcomes, counter deltas, host-tier blocks and new
    megastep keys. Returns the port's outcome, its deltas and its new
    keys."""
    seen = []
    for eng, sp in ((pair.ref, JaxSampling), (pair.port, SamplingParams)):
        c0, k0 = _counters(eng), _keys(eng)
        out = case(eng, sp)
        _idle(eng)
        c1 = _counters(eng)
        seen.append((out, {k: c1[k] - c0[k] for k in c0}, eng.stats()["memory"]["host_kv"],
                     _keys(eng) - k0))
    (ref_out, ref_d, ref_mem, ref_keys), (out, d, mem, keys) = seen
    assert out == ref_out
    assert d == ref_d
    assert mem == ref_mem
    assert keys == ref_keys
    return out, d, keys


class _Preempts:
    """The fault sites ``engine.force_preempt`` (a policy victim at the
    decode site once ``decode_steps >= decode_after``) and
    ``engine.preempt_mid_prefill`` (the mid-prefill slot with the most rows,
    at the chunk loop once ``prefill_chunks >= chunk_after``), armed on
    the injector of ``eng``'s package and reset on exit."""

    def __init__(self, eng, decode_after=None, chunk_after=None):
        self.faults = PORT_FAULTS if isinstance(eng, Engine) else FAULTS
        if decode_after is not None:
            self.faults.arm("engine.force_preempt", after_steps=decode_after)
        if chunk_after is not None:
            self.faults.arm("engine.preempt_mid_prefill", after_steps=chunk_after)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.faults.reset()


def _pressure(eng, sp, prompts=PROMPTS, pages=9, max_tokens=12) -> tuple:
    """The reference's oversubscribed pool (``kv_pages=10``: nine usable
    pages): each prompt alone, then all at once. Returns (solo streams,
    burst streams and finish reasons, preemptions of the burst)."""
    hold = _Hold([eng], pages=pages)
    try:
        s = sp(temperature=0.0, max_tokens=max_tokens)
        solo = [list(eng.generate(p, s).tokens) for p in prompts]
        with eng.hold_admission():
            futs = [eng.submit(p, s) for p in prompts]
        res = [f.result(timeout=240) for f in futs]
    finally:
        hold.release()
    return solo, [list(r.tokens) for r in res], [r.finish_reason for r in res], \
        sum(r.preempt_count for r in res)


# -- tests/engine/test_kv_memory.py ---------------------------------------------------


def test_swap_roundtrip_identical_paged_under_pool_pressure(pair):
    """Preemptions swap KV to the host and the resumes restore it: every
    stream equals its uncontended run, with a full round trip."""
    (solo, burst, reasons, preempts), d, _ = _both(pair, _pressure)
    assert burst == solo and set(reasons) <= {"stop", "length"}
    assert preempts >= 1 and d["swap_outs"] >= 1 and d["swap_ins"] >= 1
    assert pair.port.stats()["memory"]["host_kv"]["enabled"] is True


def test_forced_preempt_swap_resume_identical_spec_on(pair):
    """Speculation on: a forced preemption swaps out, the resume swaps in,
    and the stream equals the unpreempted run's."""

    def case(eng, sp):
        eng.spec_len = 4
        s = sp(temperature=0.0, max_tokens=16)
        base = list(eng.generate("hello world " * 4, s).tokens)
        with _Preempts(eng, decode_after=2):
            r = eng.generate("hello world " * 4, s)
        return base, list(r.tokens), r.preempt_count

    (base, got, preempts), d, _ = _both(pair, case)
    assert got == base and preempts >= 1
    assert d["swap_outs"] >= 1 and d["swap_ins"] >= 1


def test_swap_in_metered_through_chunked_budget_loop(pair):
    """With chunked prefill a restore lands chunk by chunk through the
    token-budget loop (the same restore chunks on both engines), and the
    streams equal the uncontended runs."""
    chunks: dict = {}

    def case(eng, sp):
        eng.prefill_chunk, eng._prefix_enabled = 16, False
        seen = chunks.setdefault(type(eng), [])
        real = eng._advance_restore

        def advance(slot, sl, st, n):
            seen.append((st, n))
            real(slot, sl, st, n)

        eng._advance_restore = advance
        try:
            return _pressure(eng, sp)
        finally:
            del eng._advance_restore

    (solo, burst, _reasons, _preempts), d, _ = _both(pair, case)
    assert burst == solo and d["swap_ins"] >= 1
    assert chunks[Engine] == chunks[JaxEngine] and chunks[Engine]
    assert all(n <= 16 for _st, n in chunks[Engine])


def test_park_expiry_swaps_and_prefix_match_restores(pair):
    """A parked slot that expires swaps its prompt KV out; the
    conversation's next turn (another rid) restores it by token prefix,
    byte-identical to a cold run."""

    def case(eng, sp):
        eng._prefix_enabled, eng.park_max_s = False, 0.2
        s = sp(temperature=0.0, max_tokens=6)
        turn1 = "persona " * 5
        cold = list(eng.generate(turn1 + "more text here", s).tokens)
        outs0 = eng.kv_swap_outs
        eng.submit(turn1, s, park=True).result(60)
        deadline = time.monotonic() + 10
        while eng.kv_swap_outs == outs0:
            assert time.monotonic() < deadline, "park expiry never swapped out"
            time.sleep(0.02)
        r = eng.generate(turn1 + "more text here", s)
        return cold, list(r.tokens)

    (cold, got), d, _ = _both(pair, case)
    assert got == cold and d["swap_outs"] == 1 and d["swap_ins"] == 1


def test_host_tier_off_is_todays_behavior(pair):
    """``host_kv_bytes=0``: no pool, no swap, no host bytes; the preempt
    path recomputes, and the streams equal the tier-on run's."""
    prompts = [ch * 20 for ch in "abcd"]
    on, _, _ = _both(pair, lambda eng, sp: _pressure(eng, sp, prompts))

    def case(eng, sp):
        eng.set_host_kv_bytes(0)
        out = _pressure(eng, sp, prompts)
        return out, eng.stats()["memory"]["host_kv"]

    ((solo, burst, _r, _p), mem), d, _ = _both(pair, case)
    assert burst == solo == on[0] and burst == on[1]
    assert d["preemptions"] >= 1 and d["swap_outs"] == d["swap_ins"] == 0
    assert mem["enabled"] is False and mem["used_bytes"] == 0 and mem["entries"] == 0


def test_host_pool_budget_bounds_and_lru_evicts(pair):
    """A pool too small for every victim stays within its budget and
    refuses what does not fit; the resumes still give the uncontended
    streams."""

    def case(eng, sp):
        eng.set_host_kv_bytes(40 * 1024)
        seen = []
        real = eng._host_pool.put

        def put(entry):
            ok = real(entry)
            seen.append((entry.cut, entry.nbytes, ok, eng._host_pool.used_bytes))
            return ok

        eng._host_pool.put = put
        out = _pressure(eng, sp)
        return out, seen, eng._host_pool.used_bytes <= eng.host_kv_bytes

    ((solo, burst, _r, _p), seen, within), _d, _ = _both(pair, case)
    assert burst == solo and within and seen
    assert all(used <= 40 * 1024 for *_x, used in seen)


def test_mid_restore_preempt_reputs_whole_entry(pair):
    """A slot preempted while its restore is landing re-puts the whole
    consumed entry (no copy), so the next resume restores every row
    again instead of recomputing them."""

    def case(eng, sp):
        eng.prefill_chunk, eng._prefix_enabled = 8, False
        hold = _Hold([eng], pages=11)
        puts, restored = [], []
        real_put, real_finish = eng._host_pool.put, eng._finish_swap_in

        def put(entry):
            puts.append((entry.rid, entry.cut))
            return real_put(entry)

        def finish(slot, sl):
            restored.append(sl.prefill_pos)
            real_finish(slot, sl)

        eng._host_pool.put, eng._finish_swap_in = put, finish
        try:
            s = sp(temperature=0.0, max_tokens=12)
            base = list(eng.generate("w" * 30, s).tokens)
            chunks0 = eng.prefill_chunks
            with _Preempts(eng, decode_after=2, chunk_after=chunks0 + 5):
                fut = eng.submit("w" * 30, s)
                r = fut.result(timeout=180)
        finally:
            del eng._host_pool.put, eng._finish_swap_in
            hold.release()
        return base, list(r.tokens), r.preempt_count, [c for _rid, c in puts], restored

    (base, got, preempts, cuts, restored), d, _ = _both(pair, case)
    assert got == base and preempts == 2
    assert d["swap_outs"] == 2 and len(cuts) == 2 and cuts[1] == cuts[0]
    assert restored and restored[-1] == cuts[0]


# -- tests/engine/test_prefetch.py ----------------------------------------------------


def test_prefetch_on_off_byte_identity_and_overlap_counted(pair):
    """Prefetch changes when the restore copies happen, never what lands:
    the streams are equal on and off, staged commits counted only on."""
    outs = {}
    for pf in (False, True):
        def case(eng, sp, pf=pf):
            eng.prefill_chunk, eng._prefix_enabled, eng.host_prefetch = 16, False, pf
            return _pressure(eng, sp)

        (solo, burst, _r, _p), d, _ = _both(pair, case)
        assert burst == solo and d["swap_ins"] >= 1
        assert (d["prefetch_commits"] > 0) if pf else (d["prefetch_commits"] == 0)
        outs[pf] = burst
        for eng in (pair.ref, pair.port):
            _rest(eng)
    assert outs[True] == outs[False]


def test_staged_scatter_absorbs_into_megastep_swaps_phase(pair):
    """A restore chunk that commits while other slots decode rides the
    fused cycle: a megastep key with an ``s...`` part, the same keys as
    the reference's."""

    def case(eng, sp):
        eng.prefill_chunk, eng._prefix_enabled = 16, False
        return _pressure(eng, sp)

    (solo, burst, _r, _p), d, keys = _both(pair, case)
    assert burst == solo and d["megastep_dispatches"] > 0
    assert any(",s" in k.replace("+s", ",s") for k in keys), keys


# -- tests/engine/test_quant_kv.py ----------------------------------------------------


def test_quantized_swap_roundtrip_bit_exact(pair):
    """int8 KV, speculation on: preempt -> host -> resume restores the int8
    bytes and their scale rows verbatim (checked page by page on the port)
    and moves no token; the port equals the reference."""
    ref = _ref_engine(pair.weights, host_kv_bytes=HOST, quantize_kv=True)
    port = Engine(TCFG, pair.params, device="cpu", host_kv_bytes=HOST, quantize_kv=True, **KW)
    checks = _PortChecks(port)
    out = {}
    try:
        for eng, sp in ((ref, JaxSampling), (port, SamplingParams)):
            eng.start()
            eng.spec_len = 4
            s = sp(temperature=0.0, max_tokens=14)
            base = list(eng.generate("hello world " * 4, s).tokens)
            with _Preempts(eng, decode_after=2):
                r = eng.generate("hello world " * 4, s)
            _idle(eng)
            out[type(eng)] = (base, list(r.tokens), r.preempt_count >= 1, eng.kv_swap_outs,
                              eng.kv_swap_ins, eng.stats()["memory"]["host_kv"])
    finally:
        FAULTS.reset()
        PORT_FAULTS.reset()
        ref.stop()
        port.stop()
    base, got, preempted, outs, ins, _mem = out[Engine]
    assert out[Engine] == out[JaxEngine]
    assert got == base and preempted and outs >= 1 and ins >= 1
    assert checks.restores >= 1 and checks.violations == []
    assert "ks" in port.cache


# -- the handoff ----------------------------------------------------------------------


def test_export_handoff_injects_and_restores(pair):
    """``export_kv=True`` attaches the prompt's rows (page-aligned, below
    the row's last token) as ``handoff-<rid>``: the port's tokens equal
    the reference's and its rows are within 2e-4 of them. Injected into a
    second port engine, the entry is restored bit for bit by a request
    that extends the row, whose stream equals a cold run's."""
    prompt = "handoff persona: answer tersely. "
    res, rids = {}, {}
    for eng, sp in ((pair.ref, JaxSampling), (pair.port, SamplingParams)):
        fut = eng.submit(prompt, sp(temperature=0.0, max_tokens=6), export_kv=True)
        res[type(eng)], rids[type(eng)] = fut.result(60), fut.rid
    ref_e, port_e = res[JaxEngine].kv_handoff, res[Engine].kv_handoff
    assert res[Engine].tokens == res[JaxEngine].tokens
    assert port_e.rid == f"handoff-{rids[Engine]}" and ref_e.rid == f"handoff-{rids[JaxEngine]}"
    assert port_e.tokens == ref_e.tokens and port_e.cut % P == 0 and port_e.cut >= P
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(port_e, name).numpy(), getattr(ref_e, name),
                                   **LOGIT_TOL)
    assert port_e.nbytes == ref_e.nbytes and port_e.k_scale is None

    follow = prompt + "and then?"
    sp = SamplingParams(temperature=0.0, max_tokens=6)
    cold = list(pair.port.generate(follow, sp).tokens)
    second = Engine(TCFG, pair.params, device="cpu", host_kv_bytes=HOST, **KW)
    checks = _PortChecks(second)
    popped = []
    real_pop = second._host_pool.pop
    second._host_pool.pop = lambda rid: popped.append(rid) or real_pop(rid)
    second.start()
    try:
        assert second.inject_host_kv(port_e)
        r = second.generate(follow, sp)
        mem = second.stats()["memory"]["host_kv"]
    finally:
        second.stop()
    assert list(r.tokens) == cold
    assert popped == [port_e.rid]
    assert (mem["injects"], mem["swap_ins"], mem["entries"], mem["used_bytes"]) == (1, 1, 0, 0)
    assert checks.restores == 1 and checks.violations == []
    assert not second.inject_host_kv(port_e)  # a stopped engine takes no entry


def test_host_tier_refused_under_a_group():
    """Each rank holds a slice of every page: the tier and the handoff
    under a serving group raise and name ROADMAP A.14."""
    group = ServingGroup(tp=1, sp=1, rank=0, tp_rank=0, sp_rank=0)
    params = params_from_jax(_weights(), TCFG, device="cpu")
    with pytest.raises(ValueError, match="A.14"):
        Engine(TCFG, params, device="cpu", group=group, host_kv_bytes=HOST, **KW)
    eng = Engine(TCFG, params, device="cpu", group=group, **KW)
    eng.start()
    try:
        fut = eng.submit("hello", SamplingParams(max_tokens=2), export_kv=True)
        with pytest.raises(ValueError, match="A.14"):
            fut.result(10)
    finally:
        eng.stop()


def test_engine_defaults_and_stats_match_the_reference(pair):
    import inspect

    want = {"host_kv_bytes": 0, "host_prefetch": True}
    for cls in (JaxEngine, Engine):
        params = inspect.signature(cls.__init__).parameters
        assert {k: params[k].default for k in want} == want
    ref, port = pair.ref.stats()["memory"], pair.port.stats()["memory"]
    assert ref["host_kv"] == port["host_kv"]
    assert ref["host_kv"]["enabled"] is True and ref["host_kv"]["max_bytes"] == HOST
    assert set(ref) == set(port)
