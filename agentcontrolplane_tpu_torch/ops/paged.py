"""Paged KV cache: page-table layout, the host page allocator, and the
plain PyTorch versions of paged decode attention.

Mirrors ``agentcontrolplane_tpu/ops/paged.py``. KV lives in fixed-size
pages ``[L, num_pages, page_size, H_kv, d]`` and each sequence owns a page
list (block table). Page 0 is the trash page: padded and inactive-lane
writes land there and nothing reads it.

The two ``paged_decode_attention_reference*`` functions are the plain
versions of the hand-written CUDA kernel in ``ops/cuda/paged_attention.py``:
the CPU path and the yardstick the kernel is held against on the card. They
gather each slot's pages — the ``[S, max_pages, P, H_kv, d]`` copy the kernel
exists to avoid — and, for int8 pools, dequantize the gathered rows.
"""

from __future__ import annotations

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


def _gather_rows(pages, scales, idx):
    """Each slot's pages gathered to f32 ``[S, M, P, H_kv, d]``; int8 pages
    dequantize AFTER the gather (``value * scale``, as ``kv_dequantize``),
    so only the gathered rows ever exist in float."""
    rows = pages[idx].float()
    if scales is not None:
        rows = rows * scales[idx][..., None]
    return rows


def _gather_logits(q, k_pages, block_tables, seq_lens, k_scales):
    """Shared body of the two plain versions: f32 logits over each slot's
    gathered pages, masked at ``seq_lens``. Returns (logits [S,M,P,H_kv,r],
    grouped q [S,H_kv,r,d] f32, the 1/sqrt(d) scale, int64 block tables)."""
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
        torch.arange(max_pages, device=q.device)[:, None] * P
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


class PageAllocator:
    """Host-side page free list with reference counts (engine-thread owned;
    no locking). Page 0 is the reserved trash page and is never handed out.
    The reference's allocator, less the prefix-sharing and int8 scale-row
    bookkeeping that arrive with the features that use them."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))  # pop() yields 1,2,...
        self._refs: dict[int, int] = {}

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def allocated_count(self) -> int:
        """Pages currently referenced."""
        return len(self._refs)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise MemoryError(f"out of KV pages: need {n}, have {len(self._free)}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def free(self, pages: list[int]) -> None:
        """Drop one reference per page; pool it when the last ref drops. A
        page with no live reference raises (KeyError) — a silent double-free
        would hand one page to two sequences later."""
        for p in pages:
            if p == TRASH_PAGE:
                continue
            left = self._refs[p] - 1
            if left <= 0:
                del self._refs[p]
                self._free.append(p)
            else:
                self._refs[p] = left
