"""Paged decode attention: the CUDA kernel's wrapper.

Replaces the TPU kernel ``agentcontrolplane_tpu/ops/pallas/paged_attention.py``
(``paged_decode_attention`` :278 and ``paged_decode_attention_cache_plus_new``
:325, both through ``_paged_state``'s ``pl.pallas_call`` at :265) with the
hand-written Hopper kernel in ``csrc/paged_attention.cu`` — one kernel, two
epilogue modes. The signatures are the reference's.

Bound: bytes. The least time for a call is the K/V page rows it must walk
(sum over slots of seq_len rows x H_kv x d x 2 (K and V) x dtype bytes, plus
q, k_new, v_new and the output) over the card's memory rate;
``chip_smoke.py`` computes it from the data sheet's rate and prints it
beside the measured time.

Routing: CUDA tensors launch the kernel (or raise — there is no fallback);
CPU tensors run the plain version in ``ops/paged.py``. ``LAUNCHES`` counts
kernel launches, so a run can show the main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ..paged import (
    paged_decode_attention_reference,
    paged_decode_attention_reference_cache_plus_new,
)
from . import build

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0

HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 8  # query heads per KV head the kernel's register tiles hold
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _entry():
    lib = build.load("paged_attention")
    fn = lib.acp_paged_decode_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k_pages, v_pages, block_tables, seq_lens, k_new, v_new) -> None:
    """Raise on anything the kernel does not take."""
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"q must be [S,H,d] and pages [NP,P,H_kv,d]; got "
                         f"{tuple(q.shape)} and {tuple(k_pages.shape)}")
    S, H, d = q.shape
    _num_pages, _P, H_kv, dk = k_pages.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged attention kernel takes float32 or bfloat16, not {q.dtype}")
    if d not in HEAD_DIMS or dk != d:
        raise ValueError(f"head_dim {d} (pages {dk}) not in {HEAD_DIMS}")
    if H % H_kv or H // H_kv > MAX_GROUP:
        raise ValueError(f"{H} query heads over {H_kv} KV heads: need a group of <= {MAX_GROUP}")
    if v_pages.shape != k_pages.shape:
        raise ValueError("k_pages and v_pages differ in shape")
    if block_tables.dim() != 2 or block_tables.shape[0] != S or tuple(seq_lens.shape) != (S,):
        raise ValueError("block_tables must be [S, max_pages] and seq_lens [S]")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("block_tables and seq_lens must be int32")
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if t is not None and tuple(t.shape) != (S, H_kv, d):
            raise ValueError(f"{name} must be [S, H_kv, d] = {(S, H_kv, d)}")
    tensors = [q, k_pages, v_pages, block_tables, seq_lens]
    tensors += [t for t in (k_new, v_new) if t is not None]
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}; one is on {t.device}")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    for t in (q, k_pages, v_pages, k_new, v_new):
        if t is not None and t.dtype != q.dtype:
            raise TypeError("q, pages, k_new and v_new must share one dtype")
        if t is not None and t.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")


def _launch(q, k_pages, v_pages, block_tables, seq_lens, k_new, v_new) -> torch.Tensor:
    global LAUNCHES
    _check(q, k_pages, v_pages, block_tables, seq_lens, k_new, v_new)
    S, H, d = q.shape
    _num_pages, P, H_kv, _ = k_pages.shape
    out = torch.empty_like(q)
    if S == 0:
        return out
    with_self = k_new is not None
    err = _entry()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(),
        k_new.data_ptr() if with_self else None,
        v_new.data_ptr() if with_self else None,
        out.data_ptr(),
        S, H, H_kv, d, P, block_tables.shape[1], _DTYPES[q.dtype], int(with_self),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"paged attention kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def _route(q) -> bool:
    """True for the kernel (CUDA tensors), False for the plain version (CPU
    tensors); anything else raises."""
    if q.device.type == "cuda":
        return True
    if q.device.type == "cpu":
        return False
    raise ValueError(f"paged attention runs on cuda or cpu tensors, not {q.device}")


def paged_decode_attention(
    q: torch.Tensor,  # [S, H, d]
    k_pages: torch.Tensor,  # [num_pages, P, H_kv, d]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [S, max_pages] int32
    seq_lens: torch.Tensor,  # [S] int32 — valid tokens per slot (already written)
) -> torch.Tensor:
    """Attention over written pages only (the classic form)."""
    if not _route(q):
        return paged_decode_attention_reference(q, k_pages, v_pages, block_tables, seq_lens)
    return _launch(q, k_pages, v_pages, block_tables, seq_lens, None, None)


def paged_decode_attention_cache_plus_new(
    q: torch.Tensor,  # [S, H, d]
    k_pages: torch.Tensor,  # [num_pages, P, H_kv, d] — WITHOUT the new token
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [S, max_pages] int32
    seq_lens: torch.Tensor,  # [S] int32 — tokens valid in the PAGES (excl. new)
    k_new: torch.Tensor,  # [S, H_kv, d]
    v_new: torch.Tensor,
) -> torch.Tensor:
    """The walk over the read-only pages plus the new token's self term,
    folded in the kernel's epilogue (the TPU version folds it outside)."""
    if not _route(q):
        return paged_decode_attention_reference_cache_plus_new(
            q, k_pages, v_pages, block_tables, seq_lens, k_new, v_new
        )
    return _launch(q, k_pages, v_pages, block_tables, seq_lens, k_new, v_new)
