"""The armed runtime invariant checker of the serving engine (the port's
copy of the reference's ``engine/invariants.py``, over the port's own
structures).

It turns the engine's host-side bookkeeping contracts into an audit, run
after every busy cycle when armed (``ACP_INVARIANTS=1`` or
``Engine(check_invariants=True)``):

- **slot conservation**: every slot id is exactly one of {free, occupied};
  free slots' host mirrors are zeroed.
- **slot state machine**: a slot is exactly one of PREFILLING / ACTIVE /
  PARKED; parked slots have resolved futures and ``seq_len == park_cut``;
  prefilling slots have ``seq_len == prefill_pos`` within the row, a chunk
  quota of at least 1, a dedup latch only below its cut and a restore only
  below its entry's cut.
- **mirror counters**: ``_parked_count`` / ``_prefilling_count`` equal the
  truth recomputed from the slot dict.
- **budget agreement**: an active slot's sampled-token count and sequence
  length agree with its request (``seq == prompt + generated - 1``,
  ``sampled <= max_tokens``, below the context edge).
- **page-accounting conservation** (the paged layout; the slot layout
  has no pages): free + referenced + trash == total
  pages; refcounts positive; every reference held by exactly refcount
  owners across slot tables, prefix-cache entries and fault-held pages;
  parked slots hold exactly their prompt-covering pages, prefilling slots
  their whole row's; block-table rows mirror the page lists; the
  allocator's shared-page counter equals the truth from the refcounts.
- **int8 KV accounting** (``quantize_kv``): the pool carries int8 values
  with scale twins of matching dims (an engine without it carries no
  scale storage), and every allocated page owns exactly one set of scale
  rows, given up with the page's last reference.
- **host KV pool conservation**: the pool's used bytes equal the sum of
  its live entries' bytes, stay within the budget, and match the engine's
  mirrors.
- **goodput/waste conservation**: the profiler's ledger balances,
  computed token positions == goodput + the sum of the waste causes, with
  every counter non-negative.

``verify_engine`` returns the violations as strings;
``check_engine_invariants`` raises :class:`InvariantViolation`, which
crashes the engine loop: a corrupt engine fails loudly instead of serving
garbage. Both run on the engine thread (or on an idle engine) and only
read state. The audit reads host structures only: the cache's dtypes and
shapes are metadata, so it never waits on the device. Disarmed, the loop
pays one bool branch.
"""

from __future__ import annotations

from collections import Counter

from ..observability.metrics import REGISTRY
from ..ops.paged import TRASH_PAGE


class InvariantViolation(RuntimeError):
    """The engine's host-side bookkeeping broke one of its contracts."""


def verify_engine(engine) -> list[str]:
    """Audit ``engine``'s host-side state; returns problem descriptions
    (empty = healthy). Read-only; engine-thread or idle-engine callers."""
    problems: list[str] = []
    slots = dict(engine._slots)
    free = list(engine._free)

    # -- slot conservation ------------------------------------------------
    if len(free) != len(set(free)):
        problems.append("free-slot heap holds duplicate slot ids")
    overlap = set(free) & set(slots)
    if overlap:
        problems.append(f"slot ids both free and occupied: {sorted(overlap)}")
    if len(set(free)) + len(slots) != engine.max_slots:
        problems.append(
            f"slot conservation broken: {len(set(free))} free + "
            f"{len(slots)} occupied != max_slots {engine.max_slots}"
        )
    for s in free:
        if int(engine._seq_lens[s]) != 0:
            problems.append(
                f"free slot {s} has non-zero seq_len {int(engine._seq_lens[s])} "
                "(host mirror not reset on release)"
            )

    # -- slot state machine + per-state bookkeeping -----------------------
    parked_truth = 0
    prefilling_truth = 0
    for slot, sl in slots.items():
        seq = int(engine._seq_lens[slot])
        if sl.parked and sl.prefilling:
            problems.append(f"slot {slot} is both PARKED and PREFILLING")
            continue
        if sl.parked:
            parked_truth += 1
            if not sl.request.future.done():
                problems.append(
                    f"parked slot {slot} has an unresolved future (park "
                    "must resolve the caller before lingering)"
                )
            if seq != sl.park_cut:
                problems.append(
                    f"parked slot {slot}: seq_len {seq} != park_cut "
                    f"{sl.park_cut} — adoption would prefill against rows "
                    "that aren't the intact prompt KV"
                )
        elif sl.prefilling:
            prefilling_truth += 1
            row_len = len(sl.prefill_row or [])
            if not 0 <= sl.prefill_pos <= row_len:
                problems.append(
                    f"prefilling slot {slot}: prefill_pos {sl.prefill_pos} "
                    f"outside [0, {row_len}]"
                )
            if seq != sl.prefill_pos:
                problems.append(
                    f"prefilling slot {slot}: seq_len {seq} != prefill_pos "
                    f"{sl.prefill_pos}"
                )
            if sl.chunk_quota < 1:
                problems.append(
                    f"prefilling slot {slot}: chunk_quota {sl.chunk_quota} "
                    "< 1 — the rate planner must always plan progress (a "
                    "zero quota would starve the slot forever)"
                )
            if sl.share_of is not None and sl.prefill_pos != sl.share_of[2]:
                problems.append(
                    f"prefilling slot {slot}: dedup follower advanced to "
                    f"{sl.prefill_pos} while still latched on its leader at "
                    f"cut {sl.share_of[2]} — its suffix would attend over "
                    "rows the leader hasn't written"
                )
            if sl.swap_entry is not None and sl.prefill_pos >= engine._swap_in_cut(sl):
                problems.append(
                    f"prefilling slot {slot}: mid-restore prefill_pos "
                    f"{sl.prefill_pos} reached/passed its host entry's cut "
                    "— the swap-in should have completed and detached"
                )
        elif sl.share_of is not None or sl.swap_entry is not None:
            problems.append(
                f"slot {slot}: dedup/swap state on a non-prefilling slot "
                "(share_of/swap_entry must clear before decode)"
            )
        else:  # ACTIVE (decoding)
            want = sl.prompt_len + len(sl.generated) - 1
            if seq != want:
                problems.append(
                    f"active slot {slot}: seq_len {seq} != prompt_len + "
                    f"len(generated) - 1 = {want} — KV rows and host "
                    "bookkeeping have diverged"
                )
            sampled = len(sl.generated) - sl.prefix_len
            cap = sl.request.sampling.max_tokens
            if sampled > cap:
                problems.append(
                    f"active slot {slot}: sampled {sampled} tokens past its "
                    f"max_tokens {cap} — the budget seam was bypassed"
                )
            if seq >= engine.max_ctx:
                problems.append(
                    f"active slot {slot}: seq_len {seq} at/over max_ctx "
                    f"{engine.max_ctx} — the context edge no longer "
                    "deactivates this lane"
                )

    # -- mirror counters vs recomputed truth ------------------------------
    if parked_truth != engine._parked_count:
        problems.append(
            f"mirror drift: _parked_count {engine._parked_count} != "
            f"{parked_truth} parked slots recomputed from the slot dict"
        )
    if prefilling_truth != engine._prefilling_count:
        problems.append(
            f"mirror drift: _prefilling_count {engine._prefilling_count} != "
            f"{prefilling_truth} prefilling slots recomputed from the slot dict"
        )

    problems.extend(_verify_host_pool(engine))
    problems.extend(_verify_profiler(engine))
    problems.extend(_verify_quantized_cache(engine))
    if engine.kv_layout == "paged":  # the slot layout has no pages to conserve
        problems.extend(_verify_pages(engine, slots))
    return problems


def _verify_quantized_cache(engine) -> list[str]:
    """int8 KV structure: a quantize_kv engine's pool carries int8 values
    plus scale twins whose leading dims match the values exactly (a twin
    sheared off its values dequantizes every later read into garbage); an
    engine without it carries NO scale storage. Dtype and shape metadata
    only: no device transfer."""
    problems: list[str] = []
    keys = set(engine.cache)
    if not engine.quantize_kv:
        if keys != {"k", "v"}:
            problems.append(
                f"quantize_kv off but the cache carries keys {sorted(keys)} "
                "— scale storage must not exist on the bit-identical path"
            )
        return problems
    if keys != {"k", "v", "ks", "vs"}:
        problems.append(
            f"quantize_kv on but the cache carries keys {sorted(keys)} "
            "(want k/v int8 values + ks/vs scale rows)"
        )
        return problems
    for name in ("k", "v"):
        val, sc = engine.cache[name], engine.cache[name + "s"]
        if str(val.dtype).replace("torch.", "") != "int8":
            problems.append(
                f"quantized cache '{name}' has dtype {val.dtype}, not int8"
            )
        if tuple(sc.shape) != tuple(val.shape[:-1]):
            problems.append(
                f"scale rows '{name}s' shaped {tuple(sc.shape)} do not "
                f"match value rows {tuple(val.shape[:-1])} — scale storage "
                "sheared off its pages/rows"
            )
    return problems


def _verify_profiler(engine) -> list[str]:
    """Goodput/waste ledger conservation (``observability/profiler.py``):
    every computed token position is classified exactly once, so
    ``computed == goodput + sum(waste)`` must hold and no counter may go
    negative. ``account()`` makes it true by construction; the audit
    catches a dispatch site that bypasses it (or a reclassification that
    is not a zero-sum move)."""
    problems: list[str] = []
    led = engine.profiler.ledger()
    computed, goodput, waste = led["computed"], led["goodput"], led["waste"]
    total_waste = sum(waste.values())
    if computed != goodput + total_waste:
        problems.append(
            f"goodput ledger conservation broken: {computed} computed token "
            f"positions != {goodput} goodput + {total_waste} attributed "
            "waste — a dispatch site is adding compute without classifying "
            "it (or a reclassify was not zero-sum)"
        )
    if goodput < 0:
        problems.append(f"goodput ledger negative: goodput {goodput} < 0")
    negative = {c: n for c, n in waste.items() if n < 0}
    if negative:
        problems.append(f"negative waste-cause counters: {negative}")
    return problems


def _verify_host_pool(engine) -> list[str]:
    """Host-RAM KV tier conservation: the pool's used bytes must equal the
    sum of its live entries' bytes (bytes without an entry are host RAM
    that can never be restored or reclaimed), stay within the budget, and
    match the engine's mirrors that stats() reads."""
    problems: list[str] = []
    pool = engine._host_pool
    if pool is None:
        if engine._host_kv_used or engine._host_kv_entries:
            problems.append(
                "mirror drift: host pool disabled but _host_kv_used="
                f"{engine._host_kv_used} / _host_kv_entries="
                f"{engine._host_kv_entries} are non-zero"
            )
        return problems
    used, entries = pool.audit()
    total = sum(entries.values())
    if used != total:
        problems.append(
            f"host KV pool leak: used_bytes {used} != {total} summed over "
            f"{len(entries)} live entries — swapped-out KV vanished from "
            "accounting (or accounting outlived its entry)"
        )
    if used > pool.max_bytes:
        problems.append(
            f"host KV pool over budget: {used} bytes used > max "
            f"{pool.max_bytes} — the LRU bound is not being enforced"
        )
    if engine._host_kv_used != used:
        problems.append(
            f"mirror drift: _host_kv_used {engine._host_kv_used} != host "
            f"pool used_bytes {used}"
        )
    if engine._host_kv_entries != len(entries):
        problems.append(
            f"mirror drift: _host_kv_entries {engine._host_kv_entries} != "
            f"{len(entries)} live host pool entries"
        )
    return problems


def _verify_pages(engine, slots: dict) -> list[str]:
    problems: list[str] = []
    P = engine.page_size
    alloc = engine._allocator
    free_pages, refs = alloc.snapshot()
    free_set = set(free_pages)

    # conservation: free + referenced + trash == total, no page in both
    if len(free_set) != len(free_pages):
        problems.append("page allocator free list holds duplicate pages")
    both = free_set & set(refs)
    if both:
        problems.append(
            f"pages both free and referenced: {sorted(both)[:8]} — a "
            "double-free pooled a live page"
        )
    lost = set(range(1, alloc.num_pages)) - free_set - set(refs)
    if lost:
        problems.append(
            f"pages vanished from accounting: {sorted(lost)[:8]} "
            "(free + allocated + trash != total)"
        )
    negative = {pg: r for pg, r in refs.items() if r <= 0}
    if negative:
        problems.append(f"non-positive refcounts: {negative}")

    # shared-page accounting (dedup and the prefix cache): the allocator's
    # incremental shared counter must equal the truth from the refcounts
    # (stats() reads the allocator's counter directly: the port keeps no
    # engine mirror of it)
    shared_truth = sum(1 for r in refs.values() if r > 1)
    if alloc.shared_count != shared_truth:
        problems.append(
            f"allocator shared_count {alloc.shared_count} != {shared_truth} "
            "pages with refcount > 1 — incremental share accounting drifted"
        )

    # quantized-page scale accounting (quantize_kv): every allocated page
    # of an int8 pool owns exactly one set of scale rows, released with the
    # page's last reference — a page without scale ownership dequantizes
    # reads through untracked rows, a scale row outliving its page is the
    # quantized twin of a refcount leak
    scale_set = alloc.scale_audit()
    if engine.quantize_kv:
        if scale_set is None:
            problems.append(
                "quantize_kv on but the allocator is not tracking scale-row "
                "ownership (PageAllocator(track_scales=True) required)"
            )
        else:
            missing = set(refs) - scale_set
            if missing:
                problems.append(
                    f"allocated pages without owned scale rows: "
                    f"{sorted(missing)[:8]} — quantized KV would dequantize "
                    "through unowned scale storage"
                )
            stale = scale_set - set(refs)
            if stale:
                problems.append(
                    f"scale rows owned for freed pages: {sorted(stale)[:8]} "
                    "— scale-row leak (the quantized twin of a refcount "
                    "leak)"
                )

    # ownership audit: every reference is held by exactly refcount owners
    owners: Counter = Counter()
    for slot, pages in engine._slot_pages.items():
        if slot not in slots:
            problems.append(f"page table exists for unoccupied slot {slot}")
        for pg in pages:
            owners[pg] += 1
    with engine._prefix_lock:
        for entry in engine._prefix_cache.values():
            for pg in entry.get("pages", ()):
                owners[pg] += 1
    for pg in engine._faults.held_pages(alloc):
        owners[pg] += 1
    for pg, n in owners.items():
        r = refs.get(pg, 0)
        if n > r:
            problems.append(
                f"page {pg}: {n} owners but refcount {r} — unshared "
                "multi-ownership (two sequences would write one page)"
            )
        elif n < r:
            problems.append(
                f"page {pg}: refcount {r} but only {n} owners — refcount "
                "leak (the page can never return to the pool)"
            )
    orphaned = set(refs) - set(owners)
    if orphaned:
        problems.append(
            f"pages referenced but owned by nothing: {sorted(orphaned)[:8]} "
            "— refcount leak"
        )

    # per-slot coverage + block-table mirror
    for slot, sl in slots.items():
        pages = engine._slot_pages.get(slot)
        if pages is None:
            problems.append(f"occupied slot {slot} has no page table")
            continue
        seq = int(engine._seq_lens[slot])
        if sl.parked:
            want = sl.park_cut // P
            if len(pages) != want:
                problems.append(
                    f"parked slot {slot}: holds {len(pages)} pages, prompt "
                    f"cut {sl.park_cut} needs exactly {want} — surplus pins "
                    "the pool, deficit serves garbage KV on adoption"
                )
        elif sl.prefilling:
            want = -(-len(sl.prefill_row or []) // P)
            if len(pages) != want:
                problems.append(
                    f"prefilling slot {slot}: holds {len(pages)} pages but "
                    f"its whole row needs {want} — the chunk loop never "
                    "allocates, so the admission-time reservation must be "
                    "complete"
                )
        else:
            if len(pages) * P < seq:
                problems.append(
                    f"active slot {slot}: {len(pages)} pages cover "
                    f"{len(pages) * P} rows < seq_len {seq} — KV was "
                    "written past the owned pages"
                )
            if len(pages) > engine.max_pages_per_seq:
                problems.append(
                    f"active slot {slot}: {len(pages)} pages exceeds "
                    f"max_pages_per_seq {engine.max_pages_per_seq}"
                )
        table_row = engine._block_tables[slot]
        if list(table_row[: len(pages)]) != list(pages):
            problems.append(
                f"slot {slot}: block-table row diverges from its page list"
            )
        if any(int(x) != TRASH_PAGE for x in table_row[len(pages):]):
            problems.append(
                f"slot {slot}: block-table rows beyond the page list are "
                "not TRASH_PAGE — a stale mapping could be read after the "
                "page is reused"
            )
    return problems


def check_engine_invariants(engine) -> None:
    """Audit and raise on the first broken contract (armed mode)."""
    REGISTRY.counter_add(
        "acp_engine_invariant_checks_total",
        1.0,
        help="engine state audits run (ACP_INVARIANTS armed)",
    )
    problems = verify_engine(engine)
    if problems:
        REGISTRY.counter_add(
            "acp_engine_invariant_violations_total",
            float(len(problems)),
            help="broken engine bookkeeping contracts detected by the "
            "armed invariant checker",
        )
        # flight-record the violation itself, so the crash dump (written by
        # the engine loop's crash handler) carries it inline with the
        # decisions that led to it
        engine.flight.record(
            "invariant_violation",
            problems=len(problems),
            first=problems[0][:200],
        )
        raise InvariantViolation(
            "engine invariant violation(s):\n  " + "\n  ".join(problems)
        )
