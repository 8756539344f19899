"""Chunked prefill under the token-budget scheduler and shared-prefix dedup
on the CPU: the port's engine against the JAX package's paged engine.

Both engines run the tiny f32 preset with the same weights (the stop
token's lm_head column a scaled copy of a frequent token's, as in
``tests/test_torch_engine.py``), one module-scoped pair, both on the split
path: ``kv_layout="paged"``, no megastep, no rate planner, no autopilot,
no speculation, no host tier (the fused path, the planner and speculation
are held to the reference in ``tests/test_torch_megastep.py``,
``tests/test_torch_planner.py`` and ``tests/test_torch_spec.py``, whose
``spec_len=6`` replay of the identity matrix below runs fused). Buckets (32, 64, 128)
at ``max_ctx=256``, so a 200-token row spills on both engines with
chunking off. Both keep the reference's defaults otherwise:
``prefill_chunk=0``, ``token_budget=0``, ``prefix_dedup=True``; a case
sets the knobs it needs on both and the fixture puts them back.

Cases replayed from the reference's own tests
(``tests/engine/test_chunked_prefill.py`` and ``test_kv_memory.py``, on the
paged layout) must give greedy streams byte-identical to the reference's,
with equal ``prefill_chunks``, ``prefix_shares`` and ``preemptions`` and
equal finish reasons. Small pools are made by holding pages of the
allocator while the engines idle, one slot by holding slot ids, and the
prefix cache is switched off for the cases the reference ran without it.

On the port every model call is checked against the shared-page rule
(``engine/engine.py``): a decode step writes no page referenced more than
once; a prefill writes a shared page only while every other holder of it
is itself still mid-prefill (never a decoding or parked slot, never a
prefix-cache entry); no decode commit reads a prefilling lane's tokens;
and every decoding slot's table covers ``seq_len + K`` before its block
(or ``seq_len`` + 1 + its draft before a verify pass, which writes no
shared page either).

Plus ``prefill_paged_continue_kv`` against the JAX function and a chunk
sequence against the whole-row prefill (f32 and int8 KV, 2e-4), the stats
keys, the engine's defaults and the ``run`` flags against the reference's.
"""

import argparse
import dataclasses
import heapq
import time
from concurrent.futures import CancelledError
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from agentcontrolplane_tpu.cli import build_parser as ref_parser
from agentcontrolplane_tpu.engine.engine import DeadlineExceededError as JaxDeadline
from agentcontrolplane_tpu.engine.engine import Engine as JaxEngine
from agentcontrolplane_tpu.engine.engine import SamplingParams as JaxSampling
from agentcontrolplane_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from agentcontrolplane_tpu.models import llama as jl
from agentcontrolplane_tpu.observability.metrics import REGISTRY as JAX_REGISTRY
from agentcontrolplane_tpu.parallel.mesh import make_mesh
from agentcontrolplane_tpu_torch.cli import build_parser as port_parser
from agentcontrolplane_tpu_torch.engine import engine as port_engine_mod
from agentcontrolplane_tpu_torch.engine.engine import DeadlineExceededError, Engine, SamplingParams
from agentcontrolplane_tpu_torch.engine.tokenizer import ByteTokenizer
from agentcontrolplane_tpu_torch.engine.weights import params_from_jax
from agentcontrolplane_tpu_torch.models import llama as tl
from agentcontrolplane_tpu_torch.observability.metrics import REGISTRY as PORT_REGISTRY
from agentcontrolplane_tpu_torch.ops.paged import TRASH_PAGE

JCFG = dataclasses.replace(jl.PRESETS["tiny"], vocab_size=512, max_seq_len=256)
TCFG = dataclasses.replace(tl.PRESETS["tiny"], vocab_size=512, max_seq_len=256)
KW = dict(max_slots=4, max_ctx=256, prefill_buckets=(32, 64, 128), decode_block_size=4,
          page_size=8)
P, K = KW["page_size"], KW["decode_block_size"]
EOT = 260  # ByteTokenizer's <|eot_id|>, a stop token
TOK = ByteTokenizer()
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)  # the bar of tests/test_torch_model.py
# decodes its whole 80-token budget on these weights: a lane that stays live
TOOL_ECHO = '{"tool": "search", "args": {"q": "x"}} {"tool": "search", "args": {"q": "x"}}'
PERSONA = "p" * 40  # five pages
TAILS = [f"-{chr(97 + i) * 4}" for i in range(4)]


def _weights() -> dict:
    p = jax.tree_util.tree_map(np.array, jl.init_params(JCFG, jax.random.key(0)))
    p["lm_head"][:, EOT] = p["lm_head"][:, 289] * 1.05
    return p


def _row(n: int, salt: int = 0) -> list[int]:
    return [1 + (i * 7 + salt) % 250 for i in range(n)]


class _SharedPageChecks:
    """Wraps the port engine's model calls and host commits and records
    every breach of the shared-page rule and of table coverage, and counts
    the prefill writes that did land in shared pages (the rule's one
    allowed case), so a case can show it exercised that case."""

    def __init__(self, engine: Engine):
        self.engine = engine
        self.violations: list[str] = []
        self.shared_prefill_writes = 0
        self.decode_blocks = 0
        grow, consume = engine._ensure_pages_for_block, engine._consume_tokens

        def checked_grow(need_tokens=None):
            grow(need_tokens)
            self.after_growth(need_tokens)

        def checked_consume(slot, sl, toks):
            if sl.prefilling or sl.parked:
                self.violations.append(f"slot {slot}: a decode commit read a lane that is "
                                       f"{'prefilling' if sl.prefilling else 'parked'}")
            return consume(slot, sl, toks)

        engine._ensure_pages_for_block = checked_grow
        engine._consume_tokens = checked_consume

    def after_growth(self, need_tokens=None) -> None:
        """Every decoding slot's table covers its next dispatch: K rows, or
        the 1 + draft rows of a verify pass (``need_tokens``)."""
        e = self.engine
        for slot, sl in e._slots.items():
            if sl.parked or sl.prefilling:
                continue
            self.decode_blocks += 1
            seq = int(e._seq_lens[slot])
            rows = K if need_tokens is None else need_tokens.get(slot, K)
            need = min(-(-(seq + rows) // P), e.max_pages_per_seq)
            if len(e._slot_pages[slot]) < need or (e._block_tables[slot, :need] == TRASH_PAGE).any():
                self.violations.append(f"slot {slot}: table does not cover {seq} + {rows}")

    def step(self, seq_lens, block_tables, active) -> None:
        refs = self.engine._allocator.snapshot()[1]
        lens, tables, act = seq_lens.numpy(), block_tables.numpy(), active.numpy()
        for s in np.flatnonzero(act):
            page = int(tables[s, min(int(lens[s]) // P, tables.shape[1] - 1)])
            if page == TRASH_PAGE or refs.get(page, 0) != 1:
                self.violations.append(f"lane {s}: decode writes page {page} (refs "
                                       f"{refs.get(page, 0)})")

    def verify(self, lengths, starts, block_tables) -> None:
        """A verify pass writes rows [start, start + length) of each lane
        through its table: never the trash page, never a shared page."""
        refs = self.engine._allocator.snapshot()[1]
        tables = block_tables.numpy()
        for s in np.flatnonzero(lengths.numpy()):
            st = int(starts[s])
            for pos in range(st, st + int(lengths[s])):
                page = int(tables[s, min(pos // P, tables.shape[1] - 1)])
                if page == TRASH_PAGE or refs.get(page, 0) != 1:
                    self.violations.append(f"lane {s}: verify writes page {page} (refs "
                                           f"{refs.get(page, 0)})")

    def prefill(self, page_ids) -> None:
        """A prefill or chunk commit is about to write ``page_ids``: every
        other holder of a shared one must still be mid-prefill."""
        e = self.engine
        refs = e._allocator.snapshot()[1]
        holders: dict[int, list[str]] = {}
        for slot, pages in e._slot_pages.items():
            sl = e._slots.get(slot)
            kind = ("admitting" if sl is None else "parked" if sl.parked
                    else "prefilling" if sl.prefilling else "decoding")
            for page in pages:
                holders.setdefault(page, []).append(kind)
        for entry in e._prefix_cache.values():
            for page in entry["pages"]:
                holders.setdefault(page, []).append("cache")
        for page in {int(p) for p in page_ids.reshape(-1)} - {TRASH_PAGE}:
            if refs.get(page, 0) > 1:
                self.shared_prefill_writes += 1
                bad = [k for k in holders.get(page, []) if k in ("decoding", "parked", "cache")]
                if bad:
                    self.violations.append(f"prefill writes shared page {page} held by {bad}")


@pytest.fixture(scope="module")
def engines():
    weights = _weights()
    ref = JaxEngine(
        config=JCFG, params=jax.tree_util.tree_map(jnp.asarray, weights),
        tokenizer=JaxByteTokenizer(), mesh=make_mesh({"tp": 1}, devices=jax.devices()[:1]),
        kv_layout="paged", megastep=False, rate_planner=False, autopilot=False, spec_len=0,
        host_kv_bytes=0, **KW,
    )
    port = Engine(TCFG, params_from_jax(weights, TCFG, device="cpu"), device="cpu",
                  megastep=False, rate_planner=False, **KW)
    checks = _SharedPageChecks(port)
    real = {name: getattr(port_engine_mod, name) for name in (
        "decode_step_paged", "prefill_paged_batch", "prefill_paged_continue",
        "prefill_paged_continue_kv")}

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


def _idle(eng, timeout: float = 120) -> None:
    deadline = time.monotonic() + timeout
    while True:
        s = eng.stats()
        if not (s["active_slots"] or s["prefilling_slots"] or s["waiting"]):
            return
        assert time.monotonic() < deadline, s
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
    """Evict every prefix-cache entry (only while the engine idles)."""
    while eng._evict_one_prefix_entry():
        pass


def _rest(eng) -> None:
    _idle(eng)
    _drop_parked(eng)
    _clear_cache(eng)
    eng.prefill_chunk, eng.token_budget, eng.prefix_dedup = 0, 0, True
    eng._prefix_enabled = True


@pytest.fixture
def pair(engines):
    """The module's engines at rest, empty and at their defaults before and
    after a case; the port's checks must stay clean."""
    for eng in (engines.ref, engines.port):
        _rest(eng)
    n0 = len(engines.checks.violations)
    yield engines
    for eng in (engines.ref, engines.port):
        _rest(eng)
        assert eng._allocator.free_count == eng.num_pages - 1
        assert len(eng._free) == eng.max_slots
    assert engines.checks.violations[n0:] == []


def _knobs(eng, **kw) -> None:
    """Set knobs on an idle engine (``no_cache`` switches the prefix cache
    off, as the reference's own cases ran with ``prefix_cache_entries=0``)."""
    if kw.pop("no_cache", False):
        eng._prefix_enabled = False
    for k, v in kw.items():
        setattr(eng, k, v)


class _Hold:
    """Hold pages (and slot ids) of idle engines so that ``pages`` pages and
    ``slots`` slot ids stay free."""

    def __init__(self, engines: list, pages: int = 0, slots: int = 0):
        self.held = []
        for e in engines:
            held_pages = e._allocator.alloc(e._allocator.free_count - pages) if pages else []
            held_slots = ([heapq.heappop(e._free) for _ in range(len(e._free) - slots)]
                          if slots else [])
            self.held.append((e, held_pages, held_slots))

    def release(self):
        for e, pages, slots in self.held:
            _idle(e)
            e._allocator.free(pages)
            for s in slots:
                heapq.heappush(e._free, s)


def _counters(eng) -> dict:
    return {"prefill_chunks": eng.prefill_chunks, "prefix_shares": eng.prefix_shares,
            "preemptions": eng.preemptions, "park_adoptions": eng.park_adoptions,
            "park_releases": eng.park_releases}


def _both(pair, case, compare=("prefill_chunks", "prefix_shares", "preemptions")) -> tuple:
    """Run ``case(engine, SamplingParams class)`` on the reference, then on
    the port; both outcomes must be equal, and so must the counters named
    in ``compare``. Returns the port's outcome and counter deltas."""
    out, deltas = [], []
    for eng, sp in ((pair.ref, JaxSampling), (pair.port, SamplingParams)):
        c0 = _counters(eng)
        out.append(case(eng, sp))
        _idle(eng)
        c1 = _counters(eng)
        deltas.append({k: c1[k] - c0[k] for k in c0})
    assert out[0] == out[1]
    assert {k: deltas[0][k] for k in compare} == {k: deltas[1][k] for k in compare}, deltas
    return out[1], deltas[1]


def _view(r) -> tuple:
    return (list(r.tokens), r.finish_reason, r.preempt_count)


def _counter(registry, name: str) -> float:
    m = registry._metrics.get(name)
    return 0.0 if m is None else m.values.get((), 0.0)


def _registry(eng):
    return PORT_REGISTRY if isinstance(eng, Engine) else JAX_REGISTRY


# -- chunked prefill (tests/engine/test_chunked_prefill.py, paged) -------------

MATRIX_ROWS = (7, 8, 9, 63, 64, 65, 200)


def test_greedy_byte_identity_matrix(pair):
    """Chunks of 8, 16 and 40 tokens against chunking off, over rows of 7
    to 200 tokens (one chunk, a chunk's edge, several chunks, a spill past
    the largest bucket): every stream equal to the unchunked one and to the
    reference's. Each run starts cold (no cache entry)."""

    def case(eng, sp):
        out = {}
        for chunk in (0, 8, 16, 40):
            eng.prefill_chunk = chunk
            for n in MATRIX_ROWS:
                out[(chunk, n)] = _view(eng.generate(_row(n), sp(max_tokens=16)))
                _idle(eng)
                _clear_cache(eng)
        eng.prefill_chunk = 0
        return out

    port, d = _both(pair, case)
    for (chunk, n), view in port.items():
        assert view == port[(0, n)], (chunk, n)
    assert d["prefill_chunks"] > 0


def test_chunk_boundary_at_ctx_edge(pair):
    """Rows of 254, 253 and 249 tokens at a 256-token context (a two-token
    budget that the edge clips): chunks of 31, 32 and plen - 1 (page
    rounding and the bucket clamp) clip at exactly the unchunked token."""

    def case(eng, sp):
        _knobs(eng, no_cache=True)
        out = {}
        for plen in (254, 253, 249):
            row = _row(plen, salt=3)
            out[(0, plen)] = _view(eng.generate(row, sp(max_tokens=2)))
            for chunk in (31, 32, plen - 1):
                eng.prefill_chunk = chunk
                out[(chunk, plen)] = _view(eng.generate(row, sp(max_tokens=2)))
                eng.prefill_chunk = 0
        return out

    port, _ = _both(pair, case)
    for (chunk, plen), view in port.items():
        assert view == port[(0, plen)], (chunk, plen)


def test_decode_never_starved_and_chunks_always_progress(pair):
    """With a one-token budget a 200-token prompt still advances one chunk
    a cycle, and every cycle that dispatched a chunk while a lane decoded
    also ran a decode block."""

    def case(eng, sp):
        _knobs(eng, no_cache=True)
        events = []
        real = eng._prefill_chunks

        def spy(budget):
            spent = real(budget)
            if spent:
                events.append((eng.decode_steps, eng._n_active()))
            return spent

        eng._prefill_chunks = spy
        try:
            steps0 = eng.decode_steps
            decoder = eng.submit(TOOL_ECHO, sp(max_tokens=80))
            deadline = time.monotonic() + 120
            while eng.decode_steps == steps0 and time.monotonic() < deadline:
                time.sleep(0.002)
            eng.prefill_chunk, eng.token_budget = 8, 1
            long = eng.submit("z" * 200, sp(max_tokens=4))
            out = [_view(long.result(timeout=180)), _view(decoder.result(timeout=180))]
        finally:
            del eng._prefill_chunks
        live = [(a, b) for (a, act_a), (b, act_b) in zip(events, events[1:]) if act_a and act_b]
        assert len(live) >= 3, events
        assert all(b > a for a, b in live), events
        return out

    _both(pair, case)


def test_deadline_expires_between_chunks_releases_partial_kv(pair):
    """A 200-token prompt whose deadline passes between chunks (each cycle
    slowed by 20 ms) fails "mid-prefill", releases its pages and slot, and
    counts as expired; the engine serves on."""

    def case(eng, sp):
        _knobs(eng, no_cache=True, prefill_chunk=8)
        real = eng._prefill_chunks

        def slow(budget):
            time.sleep(0.02)
            return real(budget)

        eng._prefill_chunks = slow
        expired0 = _counter(_registry(eng), "acp_engine_deadline_expired_total")
        try:
            fut = eng.submit("z" * 200, sp(max_tokens=8), timeout_s=0.15)
            err = fut.exception(timeout=120)
        finally:
            del eng._prefill_chunks
        assert isinstance(err, (DeadlineExceededError, JaxDeadline)) and "mid-prefill" in str(err)
        _idle(eng)
        assert eng._prefilling_count == 0 and len(eng._free) == eng.max_slots
        assert eng._allocator.free_count == eng.num_pages - 1
        assert _counter(_registry(eng), "acp_engine_deadline_expired_total") == expired0 + 1
        return _view(eng.generate("ok", sp(max_tokens=4)))

    _both(pair, case, compare=("prefix_shares", "preemptions"))


def test_cancel_mid_prefill_releases_partial_kv(pair):
    """A request cancelled between its chunks is cancelled, not failed, and
    its partial KV pages and slot are released; the engine serves on."""

    def case(eng, sp):
        _knobs(eng, no_cache=True, prefill_chunk=8)
        real = eng._prefill_chunks

        def slow(budget):
            time.sleep(0.02)
            return real(budget)

        eng._prefill_chunks = slow
        try:
            chunks0 = eng.prefill_chunks
            fut = eng.submit("z" * 200, sp(max_tokens=8))
            deadline = time.monotonic() + 60
            while eng.prefill_chunks == chunks0 or not eng._prefilling_count:
                assert time.monotonic() < deadline
                time.sleep(0.001)
            eng.cancel(fut)
            with pytest.raises(CancelledError):
                fut.result(timeout=60)
        finally:
            del eng._prefill_chunks
        _idle(eng)
        assert eng._prefilling_count == 0 and len(eng._free) == eng.max_slots
        assert eng._allocator.free_count == eng.num_pages - 1
        return _view(eng.generate("ok", sp(max_tokens=4)))

    _both(pair, case, compare=("prefix_shares", "preemptions"))


def test_park_adopt_across_chunked_prefill(pair):
    """A parked slot adopted by the next turn while chunking is on: the
    suffix enters the chunk loop at the park cut, and the turn equals a
    fresh unchunked run of the same prompt."""
    turn1 = "sys prompt: be an agent. " + "abc" * 20
    turn2 = turn1 + " user: more more more"

    def case(eng, sp):
        _knobs(eng, no_cache=True)
        plain = _view(eng.generate(turn2, sp(max_tokens=16)))
        eng.prefill_chunk = 16
        first = _view(eng.submit(turn1, sp(max_tokens=16), park=True).result(timeout=120))
        a0 = eng.park_adoptions
        second = _view(eng.generate(turn2, sp(max_tokens=16)))
        assert eng.park_adoptions == a0 + 1
        return plain, first, second

    (plain, _first, second), d = _both(pair, case, compare=(
        "prefill_chunks", "prefix_shares", "preemptions", "park_adoptions"))
    assert second == plain and d["park_adoptions"] == 1


def test_toggle_off_mid_prefill_drains_page_aligned(pair):
    """Chunking turned off while a slot is mid-prefill drains it at the
    largest bucket (page-aligned), never corrupting its pages."""

    def case(eng, sp):
        _knobs(eng, no_cache=True)
        plain = _view(eng.generate("t" * 200, sp(max_tokens=16)))
        eng.prefill_chunk = 16
        fut = eng.submit("t" * 200, sp(max_tokens=16))
        deadline = time.monotonic() + 60
        while not eng._prefilling_count and time.monotonic() < deadline:
            time.sleep(0.001)
        eng.prefill_chunk = 0
        return plain, _view(fut.result(timeout=180))

    (plain, toggled), _ = _both(pair, case, compare=("prefix_shares", "preemptions"))
    assert toggled == plain


def test_scheduler_stats_and_metrics(pair):
    def case(eng, sp):
        _knobs(eng, prefill_chunk=8)
        chunks0 = _counter(_registry(eng), "acp_engine_prefill_chunks_total")
        out = _view(eng.generate("m" * 100, sp(max_tokens=8)))
        s = eng.stats()
        sch = s["scheduler"]
        assert sch["chunked_prefill"] is True and sch["prefill_chunk"] == 8
        assert sch["token_budget"] == 0
        assert sch["prefill_chunks_total"] == eng.prefill_chunks
        assert 0.0 <= sch["budget_utilization_avg"] <= 1.0
        assert 0.0 <= sch["budget_utilization_last"] <= 1.0
        assert _counter(_registry(eng), "acp_engine_prefill_chunks_total") > chunks0
        assert s["prefilling_slots"] == 0
        return out

    _both(pair, case)


def test_hol_wait_attributed_while_decoding(pair):
    """A whole prefill at admission while a lane decodes counts as
    head-of-line wait (the metric both modes share)."""

    def case(eng, sp):
        steps0 = eng.decode_steps
        decoder = eng.submit(TOOL_ECHO, sp(max_tokens=60))
        deadline = time.monotonic() + 120
        while eng.decode_steps == steps0 and time.monotonic() < deadline:
            time.sleep(0.002)
        h0 = eng.hol_wait_s
        out = [_view(eng.generate("n" * 150, sp(max_tokens=4))),
               _view(decoder.result(timeout=180))]
        assert eng.hol_wait_s > h0
        assert _counter(_registry(eng), "acp_engine_hol_wait_seconds") > 0
        return out

    _both(pair, case)


def test_stats_keys_match_the_reference(pair):
    ref, port = pair.ref.stats(), pair.port.stats()
    assert "prefilling_slots" in port and "prefilling_slots" in ref
    assert set(port["scheduler"]) == set(ref["scheduler"])
    for block in ("megastep", "planner"):
        assert set(port["scheduler"][block]) == set(ref["scheduler"][block])
    assert port["memory"]["prefix_dedup"].keys() == ref["memory"]["prefix_dedup"].keys()
    assert port["memory"]["prefix_dedup"]["enabled"] is ref["memory"]["prefix_dedup"][
        "enabled"] is True


def test_engine_and_run_defaults_match_the_reference():
    import inspect

    want = {"prefill_chunk": 0, "token_budget": 0, "prefix_dedup": True, "megastep": True,
            "megastep_max_programs": 32, "rate_planner": True, "planner_max_quota": 8,
            "autopilot": False}
    for cls in (JaxEngine, Engine):
        params = inspect.signature(cls.__init__).parameters
        assert {k: params[k].default for k in want} == want
    # the autopilot reads the flight recorder's phase summaries: on
    assert Engine(TCFG, device="cpu", autopilot=True).stats()["scheduler"]["planner"][
        "autopilot"] is True

    flags = ("tpu_prefill_chunk", "tpu_token_budget", "tpu_prefix_dedup", "tpu_megastep",
             "tpu_rate_planner")

    def run_flags(parser) -> dict:
        run = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction)).choices["run"]
        return {a.dest: (a.default, a.help) for a in run._actions if a.dest in flags}

    ours = run_flags(port_parser())
    assert len(ours) == len(flags) and ours == run_flags(ref_parser())
    args = port_parser().parse_args(["run", "--tpu-prefill-chunk", "256",
                                     "--tpu-token-budget", "512", "--tpu-prefix-dedup", "0",
                                     "--tpu-megastep", "0", "--tpu-rate-planner", "0"])
    assert (args.tpu_prefill_chunk, args.tpu_token_budget, args.tpu_prefix_dedup,
            args.tpu_megastep, args.tpu_rate_planner) == (256, 512, 0, 0, 0)


# -- shared-prefix dedup (tests/engine/test_kv_memory.py, paged) ---------------


@pytest.mark.parametrize("prefill_chunk", [0, 16])
def test_dedup_burst_identical_and_shares_pages(pair, prefill_chunk):
    """Four requests on one 40-token persona admitted as one group: three
    share the first one's five persona pages, and every stream equals the
    request served alone (with chunking on the followers wait for a leader
    that is itself mid-prefill)."""

    def case(eng, sp):
        _knobs(eng, no_cache=True)
        solo = [_view(eng.generate(PERSONA + t, sp(max_tokens=8))) for t in TAILS]
        eng.prefill_chunk = prefill_chunk
        peak = [0]

        def watch(_toks):  # on the engine thread, at each commit
            peak[0] = max(peak[0], eng.stats()["memory"]["prefix_dedup"]["shared_pages"])

        s0 = eng.prefix_shares
        with eng.hold_admission():
            futs = [eng.submit(PERSONA + t, sp(max_tokens=8), on_tokens=watch) for t in TAILS]
        burst = [_view(f.result(timeout=180)) for f in futs]
        assert eng.prefix_shares - s0 == len(TAILS) - 1
        return solo, burst, peak[0] >= len(PERSONA) // P

    (solo, burst, shared), _ = _both(pair, case)
    assert burst == solo and shared


def test_dedup_multiplies_concurrent_slots_at_fixed_page_budget(pair):
    """At a pool too small for four private copies of a 48-token persona
    (23 pages), dedup runs the whole burst at once where dedup off
    serializes it."""
    persona = "q" * 48
    hold = _Hold([pair.ref, pair.port], pages=23)
    try:
        def case(eng, sp):
            _knobs(eng, no_cache=True)
            out = {}
            for dedup in (True, False):
                eng.prefix_dedup = dedup
                peak = [0]

                def watch(_toks):
                    s = eng.stats()
                    peak[0] = max(peak[0], s["active_slots"] + s["prefilling_slots"])

                with eng.hold_admission():
                    futs = [eng.submit(persona + t, sp(max_tokens=8), on_tokens=watch)
                            for t in TAILS]
                out[dedup] = ([_view(f.result(timeout=180)) for f in futs], peak[0])
                _idle(eng)
            # the peaks are read from commit callbacks, which the two engines
            # fire at different points of a prefill's commit: compare the
            # claim, not the counts
            (on, peak_on), (off, peak_off) = out[True], out[False]
            return on, off, peak_on >= len(TAILS) and peak_on > peak_off

        (with_dedup, without, more), _ = _both(pair, case)
    finally:
        hold.release()
    assert [v[:2] for v in with_dedup] == [v[:2] for v in without]
    assert more


def test_dedup_off_never_shares(pair):
    def case(eng, sp):
        _knobs(eng, no_cache=True, prefix_dedup=False)
        with eng.hold_admission():
            futs = [eng.submit(PERSONA + t, sp(max_tokens=4)) for t in TAILS]
        out = [_view(f.result(timeout=180)) for f in futs]
        assert eng.stats()["memory"]["prefix_dedup"]["enabled"] is False
        return out

    _, d = _both(pair, case)
    assert d["prefix_shares"] == 0


def test_parked_dedup_leader_released_for_capacity_admits_undeduped(pair):
    """One slot, held by a parked slot that is the only dedup candidate:
    it is released for its slot id and the request admitted undeduped, equal
    to the request served alone."""
    persona = "persona " * 4  # 32 shared tokens
    other = persona + "-- a different task entirely"
    hold = _Hold([pair.ref, pair.port], slots=1)
    try:
        def case(eng, sp):
            _knobs(eng, no_cache=True)
            solo = _view(eng.generate(other, sp(max_tokens=4)))
            eng.submit(persona + "conversation one", sp(max_tokens=4), park=True).result(60)
            assert eng.stats()["parked_slots"] == 1
            r = _view(eng.submit(other, sp(max_tokens=4)).result(timeout=120))
            return solo, r

        (solo, r), d = _both(pair, case, compare=(
            "prefill_chunks", "prefix_shares", "preemptions", "park_releases"))
    finally:
        hold.release()
    assert r == solo and d["park_releases"] >= 1 and d["prefix_shares"] == 0


def test_dedup_follower_of_adopted_leader_shares_full_page_list(pair):
    """A adopts the parked turn; B, in the same group, dedups on A past the
    park cut and must share A's whole page list: both equal the prompt
    served alone."""
    turn1 = "persona " * 6  # 48 tokens: park cut 48
    next_turn = turn1 + "assistant said; next question"  # 77 tokens: share cut 72

    def case(eng, sp):
        _knobs(eng, no_cache=True)
        solo = _view(eng.generate(next_turn, sp(max_tokens=4)))
        eng.submit(turn1, sp(max_tokens=4), park=True).result(60)
        with eng.hold_admission():
            fa = eng.submit(next_turn, sp(max_tokens=4))
            fb = eng.submit(next_turn, sp(max_tokens=4))
        return solo, _view(fa.result(timeout=120)), _view(fb.result(timeout=120))

    (solo, a, b), d = _both(pair, case, compare=(
        "prefill_chunks", "prefix_shares", "preemptions", "park_adoptions"))
    assert a == solo and b == solo
    assert d["park_adoptions"] == 1 and d["prefix_shares"] == 1


def test_dedup_leader_preempted_mid_prefill_followers_recover(pair):
    """A leader preempted mid-prefill rewinds its waiting followers to the
    rows it wrote; they recompute the rest into the shared pages, and every
    stream equals its solo run. Pool pressure forces it (the port has no
    fault sites): a 9-page pool holds a short decoder, the leader (its
    forced prefix makes it the victim: it sorts below the followers) and two
    followers, and the decoder's first page crossing preempts."""
    forced = tuple(TOK.encode("ok:"))
    holds: list = []

    def case(eng, sp):
        _knobs(eng, no_cache=True)
        burst = [("d" * 7, sp(max_tokens=24)),
                 (PERSONA + "-lead", sp(max_tokens=8, forced_prefix=forced))]
        burst += [(PERSONA + t, sp(max_tokens=8)) for t in TAILS[:2]]
        solo = [_view(eng.generate(p, s))[:2] for p, s in burst]
        _idle(eng)
        holds.append(_Hold([eng], pages=9))
        eng.prefill_chunk = 8
        with eng.hold_admission():
            futs = [eng.submit(p, s) for p, s in burst]
        got = [f.result(timeout=180) for f in futs]
        return solo, [_view(r)[:2] for r in got], [r.preempt_count for r in got]

    try:
        (solo, got, preempts), d = _both(pair, case)
    finally:
        for h in holds:
            h.release()
    assert got == solo
    assert preempts[1] >= 1 and d["preemptions"] >= 1 and d["prefix_shares"] >= 2


def test_shared_page_rule_holds_and_is_exercised(pair):
    """A chunked dedup burst whose leader writes the rows its waiting
    followers share: the port's checks saw prefill writes into shared
    pages, and no breach of the rule."""
    n0 = pair.checks.shared_prefill_writes
    blocks0 = pair.checks.decode_blocks

    def case(eng, sp):
        _knobs(eng, no_cache=True, prefill_chunk=16)
        with eng.hold_admission():
            futs = [eng.submit(PERSONA + t, sp(max_tokens=8)) for t in TAILS]
        return [_view(f.result(timeout=180)) for f in futs]

    _both(pair, case)
    assert pair.checks.shared_prefill_writes > n0
    assert pair.checks.decode_blocks > blocks0


# -- the model ------------------------------------------------------------------


def _jit(fn):
    """The reference's model function compiled, as its engine runs it: the
    compiled int8 quantizer multiplies by f32(1/127) as the port's does,
    where the eager one divides (ROADMAP C)."""
    return jax.jit(fn, static_argnames=("config",))


def _pages_close(got: np.ndarray, want: np.ndarray, int8: bool, what: str) -> None:
    """Written rows within 2e-4; int8 values within one step, in at most
    0.2% of the entries: the f32 rows differ in their last bits, and a value
    that lands on a half rounds to either side (the smoke's model phase
    counts the same steps on the card)."""
    if not int8:
        np.testing.assert_allclose(got, want, **LOGIT_TOL, err_msg=what)
        return
    steps = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert steps.max() <= 1 and (steps > 0).mean() <= 2e-3, (what, steps.max(),
                                                              (steps > 0).sum())


def _model_inputs():
    tree = jax.tree_util.tree_map(np.array, jl.init_params(JCFG, jax.random.key(0)))
    rng = np.random.default_rng(0)
    tables = np.zeros((2, 12), np.int32)
    tables[0, :6] = [3, 5, 7, 9, 11, 13]
    tables[1, :7] = [2, 4, 6, 8, 10, 12, 14]
    toks = [rng.integers(0, 512, 48) for _ in range(2)]
    return tree, tables, toks


@pytest.mark.parametrize("quantize_kv", [False, True], ids=["f32", "int8-kv"])
def test_prefill_paged_continue_kv_matches_jax(quantize_kv):
    """Rows of 16 and 24 tokens written by ``prefill_paged_batch``, then a
    16-token mid chunk each through ``prefill_paged_continue_kv``: every
    written row within 2e-4 of the reference's."""
    tree, tables, toks = _model_inputs()
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    pre, n = [16, 24], 16
    first = np.zeros((2, 32), np.int32)
    chunk = np.zeros((2, n), np.int32)
    pids = np.zeros((2, 4), np.int32)
    cids = np.zeros((2, n // P), np.int32)
    for b in range(2):
        first[b, : pre[b]] = toks[b][: pre[b]]
        chunk[b] = toks[b][pre[b]: pre[b] + n]
        pids[b, : pre[b] // P] = tables[b, : pre[b] // P]
        cids[b] = tables[b, pre[b] // P: (pre[b] + n) // P]
    pages = jl.init_paged_cache(JCFG, 16, P, quantize_kv=quantize_kv)
    pages, _ = _jit(jl.prefill_paged_batch)(
        jp, pages, jnp.asarray(first), jnp.asarray(pre, np.int32), jnp.asarray(pids), config=JCFG)
    ours = {k: torch.from_numpy(np.array(v)) for k, v in pages.items()}
    ref_pages = _jit(jl.prefill_paged_continue_kv)(
        jp, pages, jnp.asarray(chunk), jnp.full((2,), n, jnp.int32), jnp.asarray(pre, np.int32),
        jnp.asarray(cids), jnp.asarray(tables), config=JCFG)
    ours = tl.prefill_paged_continue_kv(
        params_from_jax(tree, TCFG, device="cpu"), ours, torch.from_numpy(chunk),
        torch.full((2,), n), torch.tensor(pre), torch.from_numpy(cids),
        torch.from_numpy(tables), TCFG)
    for name in ref_pages:
        a = np.asarray(ref_pages[name]).astype(np.float32)
        b = ours[name].numpy().astype(np.float32)
        for row in range(2):
            rows = pre[row] + n
            got = b[:, tables[row]].reshape(b.shape[0], -1, *b.shape[3:])[:, :rows]
            want = a[:, tables[row]].reshape(a.shape[0], -1, *a.shape[3:])[:, :rows]
            _pages_close(got, want, quantize_kv and name in ("k", "v"), f"{name} row {row}")


@pytest.mark.parametrize("quantize_kv", [False, True], ids=["f32", "int8-kv"])
def test_chunk_sequence_matches_the_whole_prefill(quantize_kv):
    """Rows of 45 and 48 tokens in chunks of 16 (mid chunks through
    ``prefill_paged_continue_kv``, the final through
    ``prefill_paged_continue``) against ``prefill_paged_batch`` of the whole
    rows: last-token logits and every written row within 2e-4. With int8
    KV each chunk reads the earlier chunks back from int8 pages, so the
    chunked side is held against the reference's own chunk sequence."""
    tree, tables, toks = _model_inputs()
    params = params_from_jax(tree, TCFG, device="cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    lens, n = [45, 48], 16

    def chunked(mod, pages, t):
        kv, final = ((mod.prefill_paged_continue_kv, mod.prefill_paged_continue) if mod is tl
                     else (_jit(jl.prefill_paged_continue_kv), _jit(jl.prefill_paged_continue)))
        weights, cfg = (params, TCFG) if mod is tl else (jp, JCFG)
        for st in range(0, 48, n):
            size = [min(n, L - st) for L in lens]
            chunk = np.zeros((2, n), np.int32)
            ids = np.zeros((2, n // P), np.int32)
            for b in range(2):
                chunk[b, : size[b]] = toks[b][st: st + size[b]]
                got = tables[b, st // P: -(-(st + size[b]) // P)]
                ids[b, : len(got)] = got
            args = [t(chunk), t(np.asarray(size, np.int32)), t(np.full(2, st, np.int32)),
                    t(ids), t(tables)]
            if st + n < 45:
                pages = kv(weights, pages, *args, config=cfg)
            else:
                pages, logits = final(weights, pages, *args, config=cfg)
        return pages, logits

    ours, our_logits = chunked(tl, tl.init_paged_cache(TCFG, 16, P, device="cpu",
                                                       quantize_kv=quantize_kv),
                               lambda a: torch.from_numpy(np.asarray(a)).long())
    theirs, their_logits = chunked(jl, jl.init_paged_cache(JCFG, 16, P, quantize_kv=quantize_kv),
                                   jnp.asarray)
    whole = np.zeros((2, 64), np.int32)
    for b in range(2):
        whole[b, : lens[b]] = toks[b][: lens[b]]
    ids = np.zeros((2, 8), np.int32)
    ids[:, :6] = tables[:, :6]
    whole_pages, whole_logits = tl.prefill_paged_batch(
        params, tl.init_paged_cache(TCFG, 16, P, device="cpu", quantize_kv=quantize_kv),
        torch.from_numpy(whole), torch.tensor(lens), torch.from_numpy(ids), TCFG)
    np.testing.assert_allclose(our_logits.numpy(), np.asarray(their_logits), **LOGIT_TOL)
    if not quantize_kv:
        np.testing.assert_allclose(our_logits.numpy(), whole_logits.numpy(), **LOGIT_TOL)
    for name in ours:
        a = np.asarray(theirs[name]).astype(np.float32)
        b_ = ours[name].numpy().astype(np.float32)
        w = whole_pages[name].numpy().astype(np.float32)
        for row in range(2):
            pick = lambda x: x[:, tables[row]].reshape(x.shape[0], -1, *x.shape[3:])[:, :lens[row]]
            _pages_close(pick(b_), pick(a), quantize_kv and name in ("k", "v"),
                         f"{name} row {row}")
            if not quantize_kv:
                np.testing.assert_allclose(pick(b_), pick(w), **LOGIT_TOL,
                                           err_msg=f"{name} {row} vs whole")
