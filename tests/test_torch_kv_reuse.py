"""KV reuse across an agent's turns on the CPU: the port's prefix cache,
parked slots and lazy page growth with preempt-and-resume against the JAX
package's paged engine.

Both engines run the tiny f32 preset with the same weights (the stop
token's lm_head column a scaled copy of a frequent token's, as in
``tests/test_torch_engine.py``), one module-scoped pair of each, both
built with no dedup and no chunking (the reference also with
``kv_layout="paged"``, no speculation, no host tier), so the cache's and
the parks' counters mean the same on both. Cases replayed from the reference's
own tests (``tests/engine/test_prefix_cache.py``, ``test_preempt_resume.py``
and ``test_tool_overlap.py``, on the paged layout) must give greedy streams
byte-identical to the reference's, with equal prefix-cache hits and misses,
preemptions, parks, adoptions and releases, and equal ``preempt_count`` per
result. A tighter pool is made by holding pages of the allocator while the
engines idle, so one pair serves every case.

On the port engine every decode block is checked after its page growth: no
row the block writes lands in a page referenced more than once, and every
decoding slot's table covers ``seq_len + K``; every decode step's write
target is checked again inside the step.

Plus ``prefill_paged_continue`` against the JAX function (f32 and int8 KV,
2e-4), the allocator's refcounts against the reference's over one sequence
of calls, the victim policy, and parking off under a serving group.
"""

import dataclasses
import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from agentcontrolplane_tpu.engine import engine as ref_engine_mod
from agentcontrolplane_tpu.engine.engine import Engine as JaxEngine
from agentcontrolplane_tpu.engine.engine import SamplingParams as JaxSampling
from agentcontrolplane_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from agentcontrolplane_tpu.models import llama as jl
from agentcontrolplane_tpu.ops import paged as jpaged
from agentcontrolplane_tpu.parallel.mesh import make_mesh
from agentcontrolplane_tpu_torch.engine import engine as port_engine_mod
from agentcontrolplane_tpu_torch.engine.engine import Engine, SamplingParams
from agentcontrolplane_tpu_torch.engine.tokenizer import ByteTokenizer
from agentcontrolplane_tpu_torch.engine.weights import params_from_jax
from agentcontrolplane_tpu_torch.models import llama as tl
from agentcontrolplane_tpu_torch.ops import paged as tpaged
from agentcontrolplane_tpu_torch.parallel.mesh import ServingGroup

JCFG = dataclasses.replace(jl.PRESETS["tiny"], vocab_size=512, max_seq_len=256)
TCFG = dataclasses.replace(tl.PRESETS["tiny"], vocab_size=512, max_seq_len=256)
KW = dict(max_slots=4, max_ctx=256, prefill_buckets=(32, 64, 128, 256), decode_block_size=4,
          page_size=8)
P, K = KW["page_size"], KW["decode_block_size"]
EOT = 260  # ByteTokenizer's <|eot_id|>, a stop token
TOK = ByteTokenizer()
SYSTEM = "you are an agent with tools. " * 4
TWO_CALLS = '{"name": "t1", "arguments": {"x": 1}} {"name": "t2", "arguments": {}}'
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)  # the bar of tests/test_torch_model.py


def _weights() -> dict:
    p = jax.tree_util.tree_map(np.array, jl.init_params(JCFG, jax.random.key(0)))
    p["lm_head"][:, EOT] = p["lm_head"][:, 289] * 1.05
    return p


class _BlockChecks:
    """Wraps the port engine's page growth and decode step and records
    every breach of the two invariants the shared-page walk relies on."""

    def __init__(self, engine: Engine):
        self.engine = engine
        self.violations: list[str] = []
        self.blocks = 0
        grow = engine._ensure_pages_for_block

        def checked_grow():
            grow()
            self.after_growth()

        engine._ensure_pages_for_block = checked_grow

    def after_growth(self) -> None:
        e = self.engine
        refs = e._allocator.snapshot()[1]
        for slot, sl in e._slots.items():
            if sl.parked:
                continue
            self.blocks += 1
            seq = int(e._seq_lens[slot])
            need = min(-(-(seq + K) // P), e.max_pages_per_seq)
            table = e._block_tables[slot]
            if len(e._slot_pages[slot]) < need or (table[:need] == tpaged.TRASH_PAGE).any():
                self.violations.append(f"slot {slot}: table does not cover {seq} + {K}")
            last = min(seq + K, e.max_ctx) - 1
            for page in {int(table[r // P]) for r in range(seq, last + 1)}:
                if refs.get(page, 0) != 1:
                    self.violations.append(f"slot {slot}: writes page {page} (refs "
                                           f"{refs.get(page, 0)})")

    def step(self, tokens, seq_lens, block_tables, active) -> None:
        refs = self.engine._allocator.snapshot()[1]
        lens, tables, act = seq_lens.numpy(), block_tables.numpy(), active.numpy()
        for s in np.flatnonzero(act):
            page = int(tables[s, min(int(lens[s]) // P, tables.shape[1] - 1)])
            if page == tpaged.TRASH_PAGE or refs.get(page, 0) != 1:
                self.violations.append(f"lane {s}: step writes page {page} (refs "
                                       f"{refs.get(page, 0)})")


@pytest.fixture(scope="module")
def engines():
    weights = _weights()
    ref = JaxEngine(
        config=JCFG, params=jax.tree_util.tree_map(jnp.asarray, weights),
        tokenizer=JaxByteTokenizer(), mesh=make_mesh({"tp": 1}, devices=jax.devices()[:1]),
        kv_layout="paged", prefix_dedup=False, prefill_chunk=0, spec_len=0, host_kv_bytes=0,
        **KW,
    )
    port = Engine(TCFG, params_from_jax(weights, TCFG, device="cpu"), device="cpu",
                  prefix_dedup=False, prefill_chunk=0, **KW)
    checks = _BlockChecks(port)
    step = port_engine_mod.decode_step_paged

    def checked_step(params, pages, tokens, seq_lens, block_tables, active, config, group=None):
        checks.step(tokens, seq_lens, block_tables, active)
        return step(params, pages, tokens, seq_lens, block_tables, active, config, group=group)

    port_engine_mod.decode_step_paged = checked_step
    ref.start()
    port.start()
    try:
        yield SimpleNamespace(ref=ref, port=port, checks=checks)
    finally:
        port_engine_mod.decode_step_paged = step
        ref.stop()
        port.stop()


def _idle(eng, timeout: float = 60) -> None:
    deadline = time.monotonic() + timeout
    while eng.stats()["active_slots"] or eng.stats()["waiting"]:
        assert time.monotonic() < deadline, eng.stats()
        time.sleep(0.005)


def _drop_parked(eng) -> None:
    """Let the engine expire its parked slots itself, then restore the knob."""
    if not eng.stats()["parked_slots"]:
        return
    keep, eng.park_max_s = eng.park_max_s, 1e-3
    deadline = time.monotonic() + 30
    while eng.stats()["parked_slots"]:
        assert time.monotonic() < deadline
        time.sleep(0.005)
    eng.park_max_s = keep


def _clear_cache(eng) -> None:
    """Evict every prefix-cache entry (the engine idles, as the reference's
    own refcount test does it)."""
    while eng._evict_one_prefix_entry():
        pass


@pytest.fixture
def pair(engines):
    """The module's engines at rest and empty before and after a case; the
    port's block checks must stay clean."""
    for eng in (engines.ref, engines.port):
        _idle(eng)
        _drop_parked(eng)
        _clear_cache(eng)
    n0 = len(engines.checks.violations)
    yield engines
    for eng in (engines.ref, engines.port):
        _idle(eng)
        _drop_parked(eng)
        _clear_cache(eng)
        assert eng._allocator.free_count == eng.num_pages - 1
    assert engines.checks.violations[n0:] == []


class _Hold:
    """Hold pages of an idle engine's allocator so that ``usable`` stay
    free: the reference's small-pool cases on the module's engines."""

    def __init__(self, engines, usable: int):
        self.held = [(e, e._allocator.alloc(e._allocator.free_count - usable))
                     for e in (engines.ref, engines.port)]

    def release(self):
        for e, pages in self.held:
            _idle(e)
            e._allocator.free(pages)


def _counters(eng) -> dict:
    s = eng.stats()
    t = s["tool_overlap"]
    return {"hits": s["prefix_cache"]["hits"], "misses": s["prefix_cache"]["misses"],
            "preemptions": s["preemptions"], "parks": t["parks"],
            "park_adoptions": t["park_adoptions"], "park_releases": t["park_releases"]}


def _both(pair, case) -> tuple:
    """Run ``case(engine, SamplingParams class)`` on the reference, then on
    the port; return both outcomes and both engines' counter deltas."""
    out, deltas = [], []
    for eng, sp in ((pair.ref, JaxSampling), (pair.port, SamplingParams)):
        c0 = _counters(eng)
        out.append(case(eng, sp))
        _idle(eng)
        c1 = _counters(eng)
        deltas.append({k: c1[k] - c0[k] for k in c0})
    assert deltas[0] == deltas[1], deltas
    return out[0], out[1], deltas[1]


def _view(r) -> tuple:
    return (list(r.tokens), r.text, r.finish_reason, r.preempt_count)


# -- prefix cache (tests/engine/test_prefix_cache.py, paged) ------------------


def test_paged_hit_results_match_cold_engine(pair):
    """A hit borrows the entry's pages and prefills only its suffix; its
    greedy stream equals a cold prefill's and the reference's."""
    prompts = [SYSTEM + "turn one", SYSTEM + "turn one and then some"]

    def case(eng, sp):
        out = [_view(eng.generate(p, sp(max_tokens=10))) for p in prompts]
        assert eng.stats()["prefix_cache"]["entries"] >= 1
        return out

    ref, port, d = _both(pair, case)
    assert port == ref and d["hits"] >= 1
    cold = []
    for p in prompts:
        _clear_cache(pair.port)
        cold.append(_view(pair.port.generate(p, SamplingParams(max_tokens=10))))
    assert cold == port


def test_paged_prefix_page_refcounts_conserved(pair):
    """Once requests drain, the only pages out are the entries' shared
    pages; evicting them returns the pool whole."""

    def case(eng, sp):
        eng._prefix_cache_entries = 2  # LRU evicts past two entries
        try:
            toks = [eng.generate(SYSTEM + f"variant {i}", sp(max_tokens=6)).tokens
                    for i in range(5)]
            _idle(eng)
            held = len({p for e in eng._prefix_cache.values() for p in e["pages"]})
            free = eng._allocator.free_count
        finally:
            eng._prefix_cache_entries = 4
        return toks, held, free

    ref, port, _ = _both(pair, case)
    assert port == ref
    _, held, free = port
    assert held > 0 and free == pair.port.num_pages - 1 - held


def test_paged_entry_eviction_while_borrower_active_is_safe(pair):
    """An entry evicted while a sequence still borrows its pages must not
    free them under it: the borrower's output is unaffected."""
    seed = SYSTEM + "base"

    def case(eng, sp):
        eng._prefix_cache_entries = 1  # the next save evicts
        try:
            eng.generate(seed, sp(max_tokens=4))
            borrower = eng.submit(seed + " extended turn", sp(max_tokens=48))
            eng.generate("completely different " * 10, sp(max_tokens=4))
            return _view(borrower.result(timeout=120))
        finally:
            eng._prefix_cache_entries = 4

    ref, port, d = _both(pair, case)
    assert port == ref and d["hits"] >= 1
    _clear_cache(pair.port)
    cold = pair.port.generate(seed + " extended turn", SamplingParams(max_tokens=48))
    assert _view(cold) == port


def test_growing_conversation_reuses_prefix(pair):
    """Each prompt extends the previous one (the conversation re-sent in
    full): later turns hit and stay identical."""

    def case(eng, sp):
        convo, out = SYSTEM, []
        for turn in range(3):
            convo += f" user says thing {turn}. assistant replies."
            out.append(_view(eng.generate(convo, sp(max_tokens=8))))
        return out

    ref, port, d = _both(pair, case)
    assert port == ref and d["hits"] >= 2


def test_forced_prefix_and_json_through_cache_hit(pair):
    """Forcing plus the JSON grammar through the hit path: the automaton is
    seeded past the forced prefix wherever the KV came from. Greedy here
    (the reference samples at 1.1), so the streams compare byte for byte."""
    prefix = tuple(TOK.encode('{"name": "t", "arguments": {'))

    def case(eng, sp):
        s = sp(max_tokens=24, json_only=True, forced_prefix=prefix)
        return [_view(eng.generate(SYSTEM + "call it", s)) for _ in range(2)]

    ref, port, d = _both(pair, case)
    assert port == ref and d["hits"] >= 1
    for tokens, text, _, _ in port:
        assert json.loads(text)["name"] == "t"


def test_concurrent_mixed_hits_and_misses(pair):
    """A burst of hits and a miss, admitted as one group, equals the same
    prompts served one at a time."""
    prompts = [SYSTEM + f"variant {i}" for i in range(3)] + ["totally different"]

    def case(eng, sp):
        eng.generate(SYSTEM + "seed", sp(max_tokens=8))
        solo = [_view(eng.generate(p, sp(max_tokens=8))) for p in prompts]
        with eng.hold_admission():
            futs = [eng.submit(p, sp(max_tokens=8)) for p in prompts]
        burst = [_view(f.result(timeout=120)) for f in futs]
        return solo, burst

    ref, port, d = _both(pair, case)
    assert port == ref and port[0] == port[1]
    assert d["hits"] >= 3 and d["misses"] >= 1


# -- preempt-and-resume (tests/engine/test_preempt_resume.py, paged) ----------


def test_oversubscribed_pool_preempts_resumes_byte_identical(pair):
    """Six 20-token prompts over 9 usable pages of 8: every response equals
    its uncontended run, at least one request is preempted, and streamed
    tokens arrive exactly once across a resume."""
    prompts = [ch * 20 for ch in "abcdef"]
    hold = _Hold(pair, usable=9)
    try:
        def case(eng, sp):
            s = sp(max_tokens=12)
            solo = {p: _view(eng.generate(p, s)) for p in prompts}
            streams = {p: [] for p in prompts}
            with eng.hold_admission():
                futs = [eng.submit(p, s, on_tokens=streams[p].extend) for p in prompts]
            results = {p: _view(f.result(timeout=180)) for p, f in zip(prompts, futs)}
            return solo, results, streams

        ref, port, d = _both(pair, case)
    finally:
        hold.release()
    assert port == ref
    solo, results, streams = port
    for p in prompts:
        assert results[p][:3] == solo[p][:3]
        assert streams[p] == results[p][0]
    assert d["preemptions"] >= 1 and any(r[3] for r in results.values())


def test_preempted_result_reports_honest_finish_reason(pair):
    """A preempted and resumed generation that runs to its budget finishes
    "length" with the whole budget: never a pool-exhaustion truncation."""
    hold = _Hold(pair, usable=9)
    try:
        def case(eng, sp):
            with eng.hold_admission():
                futs = [eng.submit("y" * 24, sp(max_tokens=10)) for _ in range(5)]
            return [_view(f.result(timeout=180)) for f in futs]

        ref, port, d = _both(pair, case)
    finally:
        hold.release()
    assert port == ref and d["preemptions"] >= 1
    for tokens, _, reason, _ in port:
        if reason == "length":
            assert len(tokens) == 10


def test_victim_policy_fewest_tokens_then_most_recent():
    """Parked slots first, then the fewest sampled tokens, ties to the most
    recently admitted: both engines' ``_pick_victim`` on the same slots."""

    def slots(mod, spec):
        from concurrent.futures import Future

        out = {}
        for slot, (n, seq, parked_at) in spec.items():
            req = mod._Request(rid=f"r{seq}", prompt=[1], sampling=mod.SamplingParams(),
                               future=Future())
            out[slot] = mod._Slot(request=req, generated=list(range(n)), admit_seq=seq,
                                  parked=parked_at is not None, parked_at=parked_at or 0.0)
        return out

    cases = [
        ({0: (5, 1, None), 1: (2, 2, None), 2: (2, 3, None)}, 2),
        ({0: (5, 1, None), 1: (2, 2, None)}, 1),
        ({0: (5, 1, None), 1: (9, 2, 4.0), 2: (0, 3, None), 3: (9, 4, 2.0)}, 3),
        ({}, None),
    ]
    for spec, want in cases:
        for mod, eng_cls in ((ref_engine_mod, JaxEngine), (port_engine_mod, Engine)):
            assert eng_cls._pick_victim(SimpleNamespace(_slots=slots(mod, spec))) == want


# -- parked slots (tests/engine/test_tool_overlap.py, paged) ------------------


def test_overlap_park_two_turn_byte_identity(pair):
    """Turn 2 adopts turn 1's parked slot and prefills only its suffix; both
    turns equal a plain run's, on the port as on the reference."""
    turn1 = "user question " * 4
    turn2 = turn1 + "assistant said things; tool results; next question"

    def case(eng, sp):
        s1 = sp(max_tokens=16, forced_prefix=tuple(TOK.encode(TWO_CALLS)))
        r1 = eng.submit(turn1, s1, on_tool_call=lambda i, tc: None, park=True).result(120)
        assert eng.stats()["parked_slots"] == 1
        r2 = eng.submit(turn2, sp(max_tokens=8)).result(120)
        assert eng.stats()["parked_slots"] == 0  # turn 2 didn't ask to park
        return _view(r1), _view(r2)

    ref, port, d = _both(pair, case)
    assert port == ref
    assert d["parks"] == 1 and d["park_adoptions"] == 1 and d["hits"] == 0
    _clear_cache(pair.port)
    plain = [_view(pair.port.generate(
        t, SamplingParams(max_tokens=m, forced_prefix=f)))
        for t, m, f in ((turn1, 16, tuple(TOK.encode(TWO_CALLS))), (turn2, 8, ()))]
    assert plain == list(port)


def test_parked_slot_yields_under_pool_pressure(pair):
    """Parked pages are speculative capacity: a burst that needs them gets
    them (the parked slot is released, never a live one preempted)."""
    hold = _Hold(pair, usable=17)
    try:
        def case(eng, sp):
            s = sp(max_tokens=8, forced_prefix=tuple(TOK.encode(TWO_CALLS)))
            eng.submit("a" * 40, s, on_tool_call=lambda i, tc: None, park=True).result(120)
            assert eng.stats()["parked_slots"] == 1
            with eng.hold_admission():
                futs = [eng.submit(ch * 60, sp(max_tokens=24)) for ch in "bc"]
            out = [_view(f.result(120)) for f in futs]
            assert eng.stats()["parked_slots"] == 0
            return out

        ref, port, d = _both(pair, case)
    finally:
        hold.release()
    assert port == ref and d["park_releases"] >= 1


def test_unclaimed_park_expires(pair):
    def case(eng, sp):
        keep, eng.park_max_s = eng.park_max_s, 0.3
        try:
            s = sp(max_tokens=6, forced_prefix=tuple(TOK.encode(TWO_CALLS)))
            r = eng.submit("final answer turn " * 3, s, park=True).result(120)
            assert eng.stats()["parked_slots"] == 1
            deadline = time.monotonic() + 10
            while eng.stats()["parked_slots"] and time.monotonic() < deadline:
                time.sleep(0.05)
            assert eng.stats()["parked_slots"] == 0
            return _view(r)
        finally:
            eng.park_max_s = keep

    ref, port, d = _both(pair, case)
    assert port == ref and d["park_releases"] == 1


def test_full_house_of_parked_slots_never_blocks_admission(pair):
    """Every slot parked: an unrelated prompt still admits (the oldest
    parked slot yields its slot id)."""

    def case(eng, sp):
        s = sp(max_tokens=4, forced_prefix=tuple(TOK.encode(TWO_CALLS)))
        for conv in "ABCD":
            eng.submit(f"conv {conv} " * 4, s, park=True).result(120)
        assert eng.stats()["parked_slots"] == 4
        return _view(eng.submit("conv E brand new", sp(max_tokens=4)).result(120))

    ref, port, d = _both(pair, case)
    assert port == ref and d["park_releases"] >= 1 and d["parks"] == 4


def test_early_events_survive_preempt_resume_without_replay(pair):
    """A request preempted mid-decode neither drops nor re-emits its early
    tool calls: the parser rides the request, and a resume streams only
    fresh tokens."""
    hold = _Hold(pair, usable=23)
    try:
        def case(eng, sp):
            events, lock = [], threading.Lock()

            def on_tc(i, tc):
                with lock:
                    events.append((i, tc.function.name))

            s = sp(max_tokens=40, forced_prefix=tuple(TOK.encode(TWO_CALLS)))
            with eng.hold_admission():
                futs = [eng.submit(ch * 16, s, on_tool_call=on_tc) for ch in "ab"]
            out = [_view(f.result(180)) for f in futs]
            with lock:
                return out, sorted(events)

        ref, port, d = _both(pair, case)
    finally:
        hold.release()
    assert port == ref and d["preemptions"] >= 1
    assert port[1] == [(0, "t1"), (0, "t1"), (1, "t2"), (1, "t2")]


def test_stats_keys_match_the_reference(pair):
    ref, port = pair.ref.stats(), pair.port.stats()
    for key in ("parked_slots", "preemptions", "preempted_waiting"):
        assert key in port and key in ref
    assert set(ref["tool_overlap"]) - {"overlap_saved_s"} <= set(port["tool_overlap"])
    assert set(port["prefix_cache"]) == set(ref["prefix_cache"])
    assert port["prefix_cache"]["capacity"] == ref["prefix_cache"]["capacity"] == 4
    assert port["tool_overlap"]["park_max_s"] == ref["tool_overlap"]["park_max_s"] == 30.0


def test_engine_defaults_match_the_reference():
    import inspect

    want = {"prefix_cache_entries": 4, "prefix_cache_max_tokens": 4096,
            "page_lookahead_blocks": 8, "park_max_s": 30.0, "prefill_chunk": 0,
            "token_budget": 0, "prefix_dedup": True}
    for cls in (JaxEngine, Engine):
        params = inspect.signature(cls.__init__).parameters
        assert {k: params[k].default for k in want} == want


def test_parking_is_off_under_a_group():
    """Park expiry reads the wall clock, which would fork lockstep ranks:
    under a serving group park_max_s is 0 and nothing parks."""
    group = ServingGroup(tp=1, sp=1, rank=0, tp_rank=0, sp_rank=0)
    params = params_from_jax(_weights(), TCFG, device="cpu")
    eng = Engine(TCFG, params, device="cpu", group=group, **KW)
    assert eng.park_max_s == 0.0
    eng.start()
    try:
        r = eng.submit("user question " * 4, SamplingParams(max_tokens=4), park=True).result(60)
        assert r.finish_reason in ("stop", "length")
        assert eng.stats()["parked_slots"] == 0 and eng.stats()["tool_overlap"]["parks"] == 0
    finally:
        eng.stop()


# -- the model and the allocator ----------------------------------------------


@pytest.mark.parametrize("quantize_kv", [False, True], ids=["f32", "int8-kv"])
def test_prefill_paged_continue_matches_jax(quantize_kv):
    """Two rows written by ``prefill_paged_batch`` (16 and 24 tokens), then
    13- and 20-token suffixes through ``prefill_paged_continue`` over their
    tables: logits and every written row within 2e-4 of the reference's."""
    tree = jax.tree_util.tree_map(np.array, jl.init_params(JCFG, jax.random.key(0)))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    rng = np.random.default_rng(0)
    pre, suf = [16, 24], [13, 20]
    tables = np.zeros((2, 8), np.int32)
    tables[0, :5] = [3, 5, 7, 9, 11]
    tables[1, :6] = [2, 4, 6, 8, 10, 12]
    toks = np.zeros((2, 32), np.int32)
    stoks = np.zeros((2, 24), np.int32)
    for b in range(2):
        toks[b, : pre[b]] = rng.integers(0, 512, pre[b])
        stoks[b, : suf[b]] = rng.integers(0, 512, suf[b])
    pids = np.zeros((2, 4), np.int32)
    spids = np.zeros((2, 3), np.int32)
    for b in range(2):
        n0, n1 = pre[b] // P, -(-(pre[b] + suf[b]) // P)
        pids[b, :n0] = tables[b, :n0]
        spids[b, : n1 - n0] = tables[b, n0:n1]
    pages = jl.init_paged_cache(JCFG, 24, P, quantize_kv=quantize_kv)
    pages, _ = jl.prefill_paged_batch(jp, pages, jnp.asarray(toks), jnp.asarray(pre, np.int32),
                                      jnp.asarray(pids), JCFG)
    ours = {k: torch.from_numpy(np.array(v)) for k, v in pages.items()}
    ref_pages, ref_logits = jl.prefill_paged_continue(
        jp, pages, jnp.asarray(stoks), jnp.asarray(suf, np.int32), jnp.asarray(pre, np.int32),
        jnp.asarray(spids), jnp.asarray(tables), JCFG)
    ours, logits = tl.prefill_paged_continue(
        params_from_jax(tree, TCFG, device="cpu"), ours, torch.from_numpy(stoks),
        torch.tensor(suf), torch.tensor(pre), torch.from_numpy(spids),
        torch.from_numpy(tables), TCFG)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **LOGIT_TOL)
    for name in ref_pages:
        a = np.asarray(ref_pages[name]).astype(np.float32)
        b = ours[name].numpy().astype(np.float32)
        for row in range(2):  # the rows each sequence wrote (not the padding)
            n = pre[row] + suf[row]
            got = b[:, tables[row]].reshape(b.shape[0], -1, *b.shape[3:])[:, :n]
            want = a[:, tables[row]].reshape(a.shape[0], -1, *a.shape[3:])[:, :n]
            np.testing.assert_allclose(got, want, **LOGIT_TOL, err_msg=f"{name} row {row}")


def test_continue_attention_walks_blocks_as_one_softmax():
    """Walking the keys in blocks of 16, or in two calls through the state,
    gives one softmax: the dense form within f32 rounding."""
    from agentcontrolplane_tpu_torch.ops.attention import (
        continue_attention, continue_state, online_softmax_finalize)

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 12, 4, 16, generator=g),
               torch.randn(2, 40, 2, 16, generator=g), torch.randn(2, 40, 2, 16, generator=g))
    qpos = torch.tensor([[28 + t if t < 10 else -1 for t in range(12)], [30 + t for t in range(12)]])
    kpos = torch.arange(40).expand(2, 40).clone()
    kpos[0, 5] = -1
    dense = continue_attention(q, k, v, qpos, kpos, block_size=4096)
    np.testing.assert_allclose(continue_attention(q, k, v, qpos, kpos, block_size=16).numpy(),
                               dense.numpy(), rtol=1e-5, atol=1e-5)
    state = continue_state(q, k[:, :24], v[:, :24], qpos, kpos[:, :24])
    _m, l, acc = continue_state(q, k[:, 24:], v[:, 24:], qpos, kpos[:, 24:], state=state)
    np.testing.assert_allclose(online_softmax_finalize(l, acc, q.dtype).numpy(), dense.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_page_allocator_refcounts_match_the_reference():
    """One sequence of alloc / share / free on both allocators: the same
    pages, free lists, refcounts and shared counts after every call."""
    ours, ref = tpaged.PageAllocator(12), jpaged.PageAllocator(12)
    ops = [("alloc", 4), ("share", [1, 2]), ("alloc", 3), ("free", [1, 2, 3, 4]),
           ("share", [5, 6, 7]), ("free", [1]), ("alloc", 5), ("share", [0, 2]),
           ("free", [2, 2]), ("free", [5, 6, 7]), ("free", [5, 6, 7]), ("alloc", 6)]
    for op, arg in ops:
        got = getattr(ours, op)(arg)
        want = getattr(ref, op)(arg)
        assert got == want, (op, arg)
        assert ours.snapshot() == ref.audit(), (op, arg)
        assert (ours.shared_count, ours.free_count, ours.allocated_count) == (
            ref.shared_count, ref.free_count, ref.allocated_count), (op, arg)
    with pytest.raises(MemoryError):
        ours.alloc(ours.free_count + 1)
    page = min(ours.snapshot()[1])
    while page in ours.snapshot()[1]:
        ours.free([page])
    with pytest.raises(KeyError):
        ours.free([page])  # a double free raises
