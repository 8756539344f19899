"""Paged KV cache: page-table layout, the host page allocator, and the
plain PyTorch versions of paged decode attention.

Mirrors ``agentcontrolplane_tpu/ops/paged.py``. KV lives in fixed-size
pages ``[L, num_pages, page_size, H_kv, d]`` and each sequence owns a page
list (block table). Page 0 is the trash page: padded and inactive-lane
writes land there and nothing reads it.

The two ``paged_decode_attention_reference*`` functions and
``paged_decode_state_reference`` are the plain versions of the hand-written
CUDA kernel's three forms in ``ops/cuda/paged_attention.py``: the CPU path
and the yardstick the kernel is held against on the card. They gather each
slot's pages — the ``[S, max_pages, P, H_kv, d]`` copy the kernel exists to
avoid — and, for int8 pools, dequantize the gathered rows.

``HostKVEntry`` and ``HostKVPool`` are the host-RAM KV tier: swapped-out
rows as torch CPU tensors (the card's machine has no ``ml_dtypes``, so
numpy cannot hold bf16), in the reference pool's LRU byte budget.

Context-parallel serving (``sp`` ranks) keeps a ``[P / sp]`` slice of every
page on each rank; ``merge_sp_states`` and ``fold_self_term`` are the plain
torch algebra that turns the ranks' unnormalized states into the output,
as the reference computes them outside its kernel. The same algebra
merges the splits of the CUDA kernel's split-KV walk inside one launch;
``paged_decode_state_split_reference`` is its plain version.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

import torch

from .attention import NEG_INF

TRASH_PAGE = 0


def init_kv_pages(
    n_layers: int, num_pages: int, page_size: int, n_kv_heads: int, head_dim: int,
    dtype: torch.dtype, device="cuda", quantize: bool = False,
) -> dict:
    """Zeroed page pools ``{"k", "v"}`` of [L, NP, P, H_kv, d] in ``dtype``
    (bf16 or f32). With ``quantize`` the values are int8 and per-row-per-
    head f32 scales ride page-shaped twins ``{"ks", "vs"}`` of
    [L, NP, P, H_kv], indexed by the same page ids, so scale storage is
    allocated and freed with its pages."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"paged KV pools support bf16 and f32, not {dtype}")
    shape = (n_layers, num_pages, page_size, n_kv_heads, head_dim)
    if quantize:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "ks": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            "vs": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        }
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def token_write_targets(
    block_tables: torch.Tensor,  # [S, max_pages] int
    starts: torch.Tensor,  # [S] int — absolute position of each row's first token
    lengths: torch.Tensor,  # [S] int — valid tokens per row
    page_size: int,
    T: int,  # row width (padded token count)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token scatter targets for a multi-token write whose start is
    not page-aligned (speculative verify: the draft begins mid-page, in a
    page that already holds live prefix KV, which a whole-page commit would
    clobber). Returns ``(pages [S, T], offsets [S, T])`` as int64; positions
    past ``lengths`` land on the trash page, and page indexes are clamped
    to the table, so padding never reads past it."""
    ar = torch.arange(T, device=starts.device)
    pos = starts.long()[:, None] + ar[None, :]  # [S, T]
    valid = ar[None, :] < lengths.long()[:, None]
    page_idx = torch.clamp_max(pos // page_size, block_tables.shape[1] - 1)
    pages = torch.gather(block_tables.long(), 1, page_idx)
    pages = torch.where(valid, pages, TRASH_PAGE)
    return pages, pos % page_size


def _gather_rows(pages, scales, idx):
    """Each slot's pages gathered to f32 ``[S, M, P, H_kv, d]``; int8 pages
    dequantize AFTER the gather (``value * scale``, as ``kv_dequantize``),
    so only the gathered rows ever exist in float."""
    rows = pages[idx].float()
    if scales is not None:
        rows = rows * scales[idx][..., None]
    return rows


def _gather_logits(q, k_pages, block_tables, seq_lens, k_scales, pos_base=0,
                   global_page_size=None):
    """Shared body of the plain versions: f32 logits over each slot's
    gathered pages, masked at ``seq_lens``. Local row r of page j sits at
    global position ``j * global_page_size + pos_base + r`` (a pool holding
    a slice of every page; by default the whole page). Returns (logits
    [S,M,P,H_kv,r], grouped q [S,H_kv,r,d] f32, the 1/sqrt(d) scale, int64
    block tables)."""
    S, H, d = q.shape
    _num_pages, P, H_kv, _ = k_pages.shape
    max_pages = block_tables.shape[1]
    idx = block_tables.long()
    k = _gather_rows(k_pages, k_scales, idx)  # [S, M, P, H_kv, d]
    r = H // H_kv
    scale = 1.0 / (d**0.5)
    q4 = q.reshape(S, H_kv, r, d).float()
    logits = torch.einsum("skrd,smpkd->smpkr", q4, k) * scale
    pos = (
        torch.arange(max_pages, device=q.device)[:, None] * (global_page_size or P)
        + pos_base
        + torch.arange(P, device=q.device)[None, :]
    )  # [M, P]
    mask = pos[None, :, :, None, None] < seq_lens.long()[:, None, None, None, None]
    logits = torch.where(mask, logits, NEG_INF)
    return logits, q4, scale, idx


def paged_decode_attention_reference(
    q: torch.Tensor,  # [S, H, d] — one new token per slot
    k_pages: torch.Tensor,  # [num_pages, P, H_kv, d]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [S, max_pages] int
    seq_lens: torch.Tensor,  # [S] — valid tokens per slot (incl. the new one)
    k_scales: Optional[torch.Tensor] = None,  # [num_pages, P, H_kv] f32 (int8 pools)
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Exact paged attention by gathering each slot's pages. A slot with
    ``seq_len == 0`` attends over nothing and gets zeros — what the TPU
    kernel and the CUDA kernel return (the XLA reference averages the
    masked rows there instead; the engine never issues such a lane). With
    ``k_scales``/``v_scales`` the pools are int8 and dequantize after the
    gather, in f32."""
    S, H, d = q.shape
    logits, _q4, _scale, idx = _gather_logits(q, k_pages, block_tables, seq_lens, k_scales)
    m = logits.amax(dim=(1, 2))  # [S, H_kv, r]
    p = torch.exp(logits - m[:, None, None])
    denom = p.sum(dim=(1, 2))
    out = torch.einsum("smpkr,smpkd->skrd", p, _gather_rows(v_pages, v_scales, idx))
    out = out / torch.clamp_min(denom, 1e-30)[..., None]
    out = torch.where((seq_lens > 0)[:, None, None, None], out, 0.0)
    return out.reshape(S, H, d).to(q.dtype)


def paged_decode_attention_reference_cache_plus_new(
    q: torch.Tensor,  # [S, H, d]
    k_pages: torch.Tensor,  # [num_pages, P, H_kv, d] — WITHOUT the new token
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [S, max_pages]
    seq_lens: torch.Tensor,  # [S] — tokens valid in the pages (excl. new)
    k_new: torch.Tensor,  # [S, H_kv, d]
    v_new: torch.Tensor,
    k_scales: Optional[torch.Tensor] = None,  # [num_pages, P, H_kv] f32 (int8 pools)
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Exact reference for the read-only-pages + self-term decode form: the
    pages stay read-only, the not-yet-written token attends through an
    explicit term, and the step commits its K/V once after the layer loop
    (see ``models/llama.py::decode_step_paged``). With scales the int8
    pools dequantize after the gather; the new token's k/v stay full
    precision (they are quantized only at the post-loop commit)."""
    S, H, d = q.shape
    logits, q4, scale, idx = _gather_logits(q, k_pages, block_tables, seq_lens, k_scales)
    self_logit = (q4 * k_new.float()[:, :, None, :]).sum(dim=-1) * scale  # [S,H_kv,r]
    m = torch.maximum(logits.amax(dim=(1, 2)), self_logit)
    p = torch.exp(logits - m[:, None, None])
    p_self = torch.exp(self_logit - m)
    denom = p.sum(dim=(1, 2)) + p_self
    out = torch.einsum("smpkr,smpkd->skrd", p, _gather_rows(v_pages, v_scales, idx))
    out = out + p_self[..., None] * v_new.float()[:, :, None, :]
    out = out / torch.clamp_min(denom, 1e-30)[..., None]
    return out.reshape(S, H, d).to(q.dtype)


def paged_decode_state_reference(
    q: torch.Tensor,  # [S, H, d]
    k_pages: torch.Tensor,  # [num_pages, P_local, H_kv, d] — a slice of every page
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [S, max_pages]
    seq_lens: torch.Tensor,  # [S] — valid tokens per slot (global positions)
    *,
    pos_base: int = 0,  # this slice's first row within a page
    global_page_size: Optional[int] = None,  # tokens per page (default P_local)
    k_scales: Optional[torch.Tensor] = None,  # [num_pages, P_local, H_kv] f32 (int8)
    v_scales: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The unnormalized online-softmax state ``(acc [S,H,d], m [S,H],
    l [S,H])`` in f32 over this pool's rows, masked at the rows' GLOBAL
    positions — the reference's ``_paged_state(..., pos_base=,
    global_page_size=)``. Masked rows weigh nothing (p = 0), so a lane with
    no valid row here gives ``m = -1e30``, ``l = 0``, ``acc = 0`` (the
    Pallas kernel, which loads masked rows, counts them in ``l`` with
    ``exp(0)`` instead; the merged outputs agree)."""
    S, H, d = q.shape
    logits, _q4, _scale, idx = _gather_logits(
        q, k_pages, block_tables, seq_lens, k_scales, pos_base, global_page_size
    )
    valid = logits > NEG_INF
    m = logits.amax(dim=(1, 2))  # [S, H_kv, r]
    p = torch.where(valid, torch.exp(logits - m[:, None, None]), 0.0)
    l = p.sum(dim=(1, 2))
    acc = torch.einsum("smpkr,smpkd->skrd", p, _gather_rows(v_pages, v_scales, idx))
    return acc.reshape(S, H, d), m.reshape(S, H), l.reshape(S, H)


def merge_sp_states(acc, m, l, reduce_max, reduce_sum):
    """Merge the sp ranks' unnormalized states: ``m_g = max(m)``,
    ``corr = exp(m - m_g)``, ``l_g = sum(l * corr)``, ``acc_g = sum(acc *
    corr)`` — the reference's one pmax and two psums
    (``paged_decode_attention_cache_plus_new_sp_sharded``). The reductions
    are passed in: ``all_reduce`` over the sp group on the serving path, a
    reduction over a stacked rank axis in a single-process test."""
    m_g = reduce_max(m)
    corr = torch.exp(m - m_g)
    l_g = reduce_sum(l * corr)
    acc_g = reduce_sum(acc * corr[..., None])
    return acc_g, m_g, l_g


def paged_decode_state_split_reference(
    q: torch.Tensor,  # [S, H, d]
    k_pages: torch.Tensor,  # [num_pages, P_local, H_kv, d]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [S, max_pages]
    seq_lens: torch.Tensor,  # [S] — valid tokens per slot (global positions)
    bounds,  # page boundaries 0 = b_0 < b_1 < ... < b_n = max_pages
    *,
    pos_base: int = 0,
    global_page_size: Optional[int] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The state walk cut along pages, as the split-KV CUDA kernel cuts it:
    split z walks table columns ``[bounds[z], bounds[z+1])``, its state
    comes from ``paged_decode_state_reference`` over those columns (lengths
    shifted by the pages before it; a split past the valid rows is the
    empty state), and the states merge with ``merge_sp_states``' algebra,
    summed in split order. Equals the unsplit state up to f32 rounding."""
    G = global_page_size or k_pages.shape[1]
    states = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        lens = torch.clamp_min(seq_lens.long() - a * G, 0).to(seq_lens.dtype)
        states.append(paged_decode_state_reference(
            q, k_pages, v_pages, block_tables[:, a:b].contiguous(), lens, pos_base=pos_base,
            global_page_size=G, k_scales=k_scales, v_scales=v_scales,
        ))
    acc, m, l = (torch.stack(x) for x in zip(*states))

    def in_order(x):
        total = x[0]
        for part in x[1:]:
            total = total + part
        return total

    return merge_sp_states(acc, m, l, lambda x: x.amax(0), in_order)


def fold_self_term(q, k_new, v_new, acc, m, l) -> torch.Tensor:
    """One more online-softmax fold: the not-yet-written new token's
    self-attention term merged into the unnormalized ``(acc, m, l)`` state,
    then normalized — the reference's ``_fold_self_term``, which it computes
    outside its kernel (plain torch here too)."""
    S, H, d = q.shape
    H_kv = k_new.shape[1]
    r = H // H_kv
    scale = 1.0 / (d**0.5)
    q4 = q.reshape(S, H_kv, r, d).float()
    self_logit = ((q4 * k_new.float()[:, :, None, :]).sum(dim=-1) * scale).reshape(S, H)
    m2 = torch.maximum(m, self_logit)
    corr = torch.exp(m - m2)
    p_self = torch.exp(self_logit - m2)
    l2 = l * corr + p_self
    v_new_rep = v_new.float()[:, :, None, :].expand(S, H_kv, r, d).reshape(S, H, d)
    out = (acc * corr[..., None] + p_self[..., None] * v_new_rep) / torch.clamp_min(
        l2, 1e-30
    )[..., None]
    return out.to(q.dtype)


class PageAllocator:
    """Host-side page free list with reference counts (engine-thread owned;
    no locking). Page 0 is the reserved trash page and is never handed out.

    Refcounts make prefix sharing zero-copy: a prefix-cache entry keeps a
    reference on its (whole, never rewritten) prompt pages, and every
    sequence whose block table borrows them takes another; a page returns
    to the pool only when its last reference drops.

    With ``track_scales`` (int8 pools) it also keeps the set of pages that
    own scale rows: an int8 page's f32 scales live in page-shaped twins
    indexed by the same page id, so every allocated page owns exactly one
    set and a page's last free gives them up. The invariant checker holds
    the set against the refcounts (``engine/invariants.py``)."""

    def __init__(self, num_pages: int, track_scales: bool = False):
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))  # pop() yields 1,2,...
        self._refs: dict[int, int] = {}
        # pages with refcount >= 2, kept incrementally so a reader gets an
        # int instead of scanning the refcounts
        self._shared = 0
        # int8 pools: the pages that own scale rows (None: not tracked)
        self._scale_pages: Optional[set[int]] = set() if track_scales else None

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def allocated_count(self) -> int:
        """Pages currently referenced."""
        return len(self._refs)

    @property
    def shared_count(self) -> int:
        """Pages referenced by more than one owner."""
        return self._shared

    def snapshot(self) -> tuple[list[int], dict[int, int]]:
        """Copies of ``(free pages, {page: refcount})`` — the reference's
        ``audit()``: the two partition ``1..num_pages-1`` exactly."""
        return list(self._free), dict(self._refs)

    def scale_audit(self) -> Optional[set[int]]:
        """A copy of the pages that own scale rows (None when untracked)."""
        return None if self._scale_pages is None else set(self._scale_pages)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise MemoryError(f"out of KV pages: need {n}, have {len(self._free)}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        if self._scale_pages is not None:
            self._scale_pages.update(pages)
        return pages

    def share(self, pages: list[int]) -> None:
        """Take one more reference on already-allocated pages."""
        for p in pages:
            if p != TRASH_PAGE:
                n = self._refs[p] + 1
                self._refs[p] = n
                if n == 2:
                    self._shared += 1

    def free(self, pages: list[int]) -> None:
        """Drop one reference per page; pool it when the last ref drops. A
        page with no live reference raises (KeyError) — a silent double-free
        would hand one page to two sequences later."""
        for p in pages:
            if p == TRASH_PAGE:
                continue
            left = self._refs[p] - 1
            if left == 1:
                self._shared -= 1
            if left <= 0:
                del self._refs[p]
                self._free.append(p)
                if self._scale_pages is not None:
                    self._scale_pages.discard(p)
            else:
                self._refs[p] = left


@dataclass
class HostKVEntry:
    """Swapped-out KV in host RAM: token-major rows ``[0, cut)`` of a
    request's prefill row, as torch CPU tensors (pinned when the engine
    serves on CUDA).

    ``tokens`` is the exact token sequence whose KV the rows hold, so an
    entry matches either by the rid it was swapped under (preempt ->
    resume) or by token-prefix equality (park expiry or a mid-prefill
    deadline, then a later request re-sending the same conversation).

    int8 pools swap their bytes verbatim with their f32 scale rows
    (``k_scale``/``v_scale``, [L, cut, H_kv]), so a restore is bit-exact
    with no requantization."""

    rid: str
    tokens: tuple
    k: torch.Tensor  # [L, cut, H_kv, d] (bf16/f32, or int8 with scales below)
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None  # [L, cut, H_kv] f32
    v_scale: Optional[torch.Tensor] = None

    @property
    def cut(self) -> int:
        return len(self.tokens)

    @property
    def nbytes(self) -> int:
        n = 0
        for t in (self.k, self.v, self.k_scale, self.v_scale):
            if t is not None:
                n += t.numel() * t.element_size()
        return n


class HostKVPool:
    """The bounded host-RAM KV tier (engine-thread owned, no locking).
    A put LRU-evicts until it fits ``max_bytes``; an entry that alone
    exceeds the budget is refused (the caller recomputes instead).
    ``audit()`` snapshots the accounting: ``used_bytes`` equals the sum of
    the live entries' bytes and never exceeds the budget."""

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self.used_bytes = 0
        self._entries: OrderedDict[str, HostKVEntry] = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def put(self, entry: HostKVEntry) -> bool:
        """Admit ``entry`` keyed by its rid (a re-put replaces), evicting
        the least recently used until it fits. False when the entry alone
        exceeds the budget (nothing is evicted then)."""
        if entry.nbytes > self.max_bytes:
            return False
        old = self._entries.pop(entry.rid, None)
        if old is not None:
            self.used_bytes -= old.nbytes
        while self.used_bytes + entry.nbytes > self.max_bytes and self._entries:
            _, evicted = self._entries.popitem(last=False)
            self.used_bytes -= evicted.nbytes
        self._entries[entry.rid] = entry
        self.used_bytes += entry.nbytes
        return True

    def get(self, rid: str) -> Optional[HostKVEntry]:
        """The entry of ``rid`` without removing it (the reservation may
        still fail; consuming is :meth:`pop`). A hit refreshes recency."""
        e = self._entries.get(rid)
        if e is not None:
            self._entries.move_to_end(rid)
        return e

    def match_prefix(self, row: list[int]) -> Optional[HostKVEntry]:
        """The longest entry whose tokens are a STRICT prefix of ``row`` (a
        suffix token must remain to give logits); refreshes its recency."""
        best: Optional[HostKVEntry] = None
        for e in self._entries.values():
            if e.cut < len(row) and (best is None or e.cut > best.cut):
                if tuple(row[: e.cut]) == e.tokens:
                    best = e
        if best is not None:
            self._entries.move_to_end(best.rid)
        return best

    def pop(self, rid: str) -> Optional[HostKVEntry]:
        """Consume an entry (a restore took it; its bytes return)."""
        e = self._entries.pop(rid, None)
        if e is not None:
            self.used_bytes -= e.nbytes
        return e

    def clear(self) -> None:
        self._entries.clear()
        self.used_bytes = 0

    def audit(self) -> tuple[int, dict[str, int]]:
        """``(used_bytes, {rid: entry bytes})``, copies."""
        return self.used_bytes, {r: e.nbytes for r, e in self._entries.items()}
