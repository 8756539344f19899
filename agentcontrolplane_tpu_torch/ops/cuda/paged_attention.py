"""Paged decode attention: the CUDA kernels' wrapper.

Replaces the TPU kernel ``agentcontrolplane_tpu/ops/pallas/paged_attention.py``
(``paged_decode_attention`` :278 and ``paged_decode_attention_cache_plus_new``
:325, both through ``_paged_state``'s ``pl.pallas_call`` at :265) with the
hand-written Hopper kernel of ``csrc/paged_attention.cuh`` — one kernel, two
epilogue modes, two page walks:

- the f32/bf16 walk (``csrc/paged_attention.cu``): pages in q's dtype;
- the int8 walk (``csrc/paged_attention_int8.cu``, the Pallas kernel's
  ``quantized=True``): int8 pages plus f32 ``k_scales``/``v_scales`` of
  [NP, P, H_kv], dequantized inside the kernel as ``value * scale``.

The signatures are the reference's (scales as keywords).

Bound: bytes. The least time for a call is the K/V page rows it must walk
(sum over slots of seq_len rows x H_kv x d x 2 (K and V) x page bytes, plus
the int8 walk's scales, q, k_new, v_new and the output) over the card's
memory rate; ``chip_smoke.py`` computes it from the data sheet's rate and
prints it beside the measured time.

Routing: CUDA tensors launch a kernel (or raise — there is no fallback);
CPU tensors run the plain version in ``ops/paged.py``. ``LAUNCHES`` counts
every kernel launch and ``INT8_LAUNCHES`` the int8 walk's alone, so a run
can show the main path went through the kernel and which walk served it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..paged import (
    paged_decode_attention_reference,
    paged_decode_attention_reference_cache_plus_new,
)
from . import build

# kernel launches since import (or since a caller reset them to 0): all
# walks, and the int8 walk alone
LAUNCHES = 0
INT8_LAUNCHES = 0

HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 8  # query heads per KV head the kernel's register tiles hold
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _entry(int8: bool):
    if int8:
        fn = build.load("paged_attention_int8").acp_paged_decode_attention_int8
        n_ptrs = 10
    else:
        fn = build.load("paged_attention").acp_paged_decode_attention
        n_ptrs = 8
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k_pages, v_pages, block_tables, seq_lens, k_new, v_new,
           k_scales=None, v_scales=None) -> None:
    """Raise on anything the kernels do not take."""
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"q must be [S,H,d] and pages [NP,P,H_kv,d]; got "
                         f"{tuple(q.shape)} and {tuple(k_pages.shape)}")
    S, H, d = q.shape
    num_pages, P, H_kv, dk = k_pages.shape
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
    int8 = k_pages.dtype == torch.int8
    if int8 != (v_pages.dtype == torch.int8):
        raise TypeError("k_pages and v_pages must both be int8 or neither")
    if int8 != (k_scales is not None) or (k_scales is None) != (v_scales is None):
        raise ValueError("int8 pages need k_scales and v_scales, and only int8 pages take them")
    scales = [k_scales, v_scales] if int8 else []
    for t in scales:
        if t.dtype != torch.float32:
            raise TypeError(f"k_scales and v_scales must be float32, not {t.dtype}")
        if tuple(t.shape) != (num_pages, P, H_kv):
            raise ValueError(f"scales must be [NP, P, H_kv] = {(num_pages, P, H_kv)}, "
                             f"not {tuple(t.shape)}")
    tensors = [q, k_pages, v_pages, block_tables, seq_lens, *scales]
    tensors += [t for t in (k_new, v_new) if t is not None]
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}; one is on {t.device}")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    pages_dtype = torch.int8 if int8 else q.dtype
    for t in (k_pages, v_pages):
        if t.dtype != pages_dtype:
            raise TypeError(f"pages must be int8 or q's dtype {q.dtype}, not {t.dtype}")
    for t in (k_new, v_new):
        if t is not None and t.dtype != q.dtype:
            raise TypeError("q, k_new and v_new must share one dtype")
    for t in (q, k_pages, v_pages, k_new, v_new):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")


def _launch(q, k_pages, v_pages, block_tables, seq_lens, k_new, v_new,
            k_scales, v_scales) -> torch.Tensor:
    global LAUNCHES, INT8_LAUNCHES
    _check(q, k_pages, v_pages, block_tables, seq_lens, k_new, v_new, k_scales, v_scales)
    S, H, d = q.shape
    _num_pages, P, H_kv, _ = k_pages.shape
    out = torch.empty_like(q)
    if S == 0:
        return out
    with_self = k_new is not None
    int8 = k_scales is not None
    ptrs = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()]
    if int8:
        ptrs += [k_scales.data_ptr(), v_scales.data_ptr()]
    ptrs += [
        block_tables.data_ptr(), seq_lens.data_ptr(),
        k_new.data_ptr() if with_self else None,
        v_new.data_ptr() if with_self else None,
        out.data_ptr(),
    ]
    err = _entry(int8)(
        *ptrs, S, H, H_kv, d, P, block_tables.shape[1], _DTYPES[q.dtype], int(with_self),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        walk = "int8" if int8 else "f32/bf16"
        raise RuntimeError(f"paged attention ({walk} walk) launch failed: CUDA error {err}")
    LAUNCHES += 1
    if int8:
        INT8_LAUNCHES += 1
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
    k_pages: torch.Tensor,  # [num_pages, P, H_kv, d] (q's dtype, or int8)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [S, max_pages] int32
    seq_lens: torch.Tensor,  # [S] int32 — valid tokens per slot (already written)
    *,
    k_scales: Optional[torch.Tensor] = None,  # [num_pages, P, H_kv] f32 — int8 pages
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention over written pages only (the classic form)."""
    if not _route(q):
        return paged_decode_attention_reference(
            q, k_pages, v_pages, block_tables, seq_lens, k_scales=k_scales, v_scales=v_scales
        )
    return _launch(q, k_pages, v_pages, block_tables, seq_lens, None, None, k_scales, v_scales)


def paged_decode_attention_cache_plus_new(
    q: torch.Tensor,  # [S, H, d]
    k_pages: torch.Tensor,  # [num_pages, P, H_kv, d] — WITHOUT the new token
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [S, max_pages] int32
    seq_lens: torch.Tensor,  # [S] int32 — tokens valid in the PAGES (excl. new)
    k_new: torch.Tensor,  # [S, H_kv, d] — full precision, in q's dtype
    v_new: torch.Tensor,
    *,
    k_scales: Optional[torch.Tensor] = None,  # [num_pages, P, H_kv] f32 — int8 pages
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The walk over the read-only pages plus the new token's self term,
    folded in the kernel's epilogue (the TPU version folds it outside). The
    new token's k/v are not yet written, so no scale applies to them."""
    if not _route(q):
        return paged_decode_attention_reference_cache_plus_new(
            q, k_pages, v_pages, block_tables, seq_lens, k_new, v_new,
            k_scales=k_scales, v_scales=v_scales,
        )
    return _launch(q, k_pages, v_pages, block_tables, seq_lens, k_new, v_new, k_scales, v_scales)
