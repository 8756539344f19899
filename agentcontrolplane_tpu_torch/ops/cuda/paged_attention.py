"""Paged decode attention: the CUDA kernels' wrapper.

Replaces the TPU kernel ``agentcontrolplane_tpu/ops/pallas/paged_attention.py``
(``paged_decode_attention`` :278, ``paged_decode_attention_cache_plus_new``
:325 and the context-parallel wrapper's state walk :399-460, all through
``_paged_state``'s ``pl.pallas_call`` at :265) with the hand-written Hopper
kernel of ``csrc/paged_attention.cuh`` — one kernel, three epilogue forms
(normalized without and with the self term, and the unnormalized
``(acc, m, l)`` state over a slice of every page), two page walks:

- the f32/bf16 walk (``csrc/paged_attention.cu``): pages in q's dtype;
- the int8 walk (``csrc/paged_attention_int8.cu``, the Pallas kernel's
  ``quantized=True``): int8 pages plus f32 ``k_scales``/``v_scales`` of
  [NP, P, H_kv], dequantized inside the kernel as ``value * scale``.

The signatures are the reference's (scales as keywords). The sharded
wrappers (reference :348-500) take a ``ServingGroup`` (``parallel/mesh.py``)
where the reference takes a mesh, and the RANK's tensors: its query and KV
head slice (tp) and its row slice of every page (sp). tp needs no
collective; sp merges the ranks' states with one max and two sum
all-reduces over the sp group, then folds the self term once.

Bound: bytes. The least time for a call is the K/V page rows it must walk
(sum over slots of seq_len rows x H_kv x d x 2 (K and V) x page bytes, plus
the int8 walk's scales, q, k_new, v_new and the output) over the card's
memory rate; ``chip_smoke.py`` computes it from the data sheet's rate and
prints it beside the measured time.

Split-KV: every call is ONE launch of a (S, H_kv, n_split) grid whose
blocks walk runs of table columns and merge their partial states in the
same launch (``csrc/paged_attention.cuh``). :func:`split_plan` picks
``n_split`` from shapes only — the table width, rows per page, S x H_kv and
the card's SM count — never from ``seq_lens``, so a call never reads the
lengths on the host and can be captured in a CUDA graph. The wrapper owns
the merge's workspace and its ticket counters: cached per device, grown
when a call needs more, the counters zeroed once (every launch leaves them
zero). So calls on one device must not overlap in time: one stream at a
time, as the engine's single loop thread issues them. Make a graph's first
call eagerly before capturing it, so the buffers exist zeroed.

Routing: CUDA tensors launch a kernel (or raise — there is no fallback);
CPU tensors run the plain version in ``ops/paged.py``. ``LAUNCHES`` counts
every kernel launch, ``INT8_LAUNCHES`` the int8 walk's and
``STATE_LAUNCHES`` the state form's (of either walk), so a run can show the
main path went through the kernel and which walk and form served it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..paged import (
    fold_self_term,
    merge_sp_states,
    paged_decode_attention_reference,
    paged_decode_attention_reference_cache_plus_new,
    paged_decode_state_reference,
)
from . import build

# kernel launches since import (or since a caller reset them to 0): all
# walks and forms, the int8 walk alone, and the state form alone
LAUNCHES = 0
INT8_LAUNCHES = 0
STATE_LAUNCHES = 0

HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 8  # query heads per KV head the kernel's register tiles hold
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
WAVES = 2  # blocks to aim for, in multiples of the card's SMs
MIN_SPLIT_ROWS = 128  # rows a split walks at least (8 pages of 16)
MAX_SPLITS = 256  # the kernel's kMaxSplits: its merge's shared memory holds this many

_sm_counts: dict = {}
_scratch: dict = {}  # device -> (workspace f32, counters int32)


def split_plan(max_pages: int, page_rows: int, lanes: int, sm_count: int) -> tuple[int, int]:
    """``(n_split, pages_per_split)`` for a walk of ``max_pages`` table
    columns of ``page_rows`` rows each over ``lanes`` = S x H_kv (slot, KV
    head) pairs on a card of ``sm_count`` SMs: about ``WAVES`` blocks per
    SM, at least ``MIN_SPLIT_ROWS`` rows a split, and no split wholly past
    the table, at most ``MAX_SPLITS``. Shapes only: never the lengths."""
    want = -(-WAVES * sm_count // max(lanes, 1))
    most = max(1, max_pages * page_rows // MIN_SPLIT_ROWS)
    n = max(1, min(want, most, max_pages, MAX_SPLITS))
    pps = -(-max_pages // n)
    return -(-max_pages // pps), pps


def _sm_count(device: torch.device) -> int:
    key = device.index if device.index is not None else torch.cuda.current_device()
    if key not in _sm_counts:
        _sm_counts[key] = torch.cuda.get_device_properties(key).multi_processor_count
    return _sm_counts[key]


def _split(q, k_pages, block_tables):
    """This call's ``(n_split, workspace pointer, counters pointer)``; the
    pointers are None when the walk is not split."""
    S, H, d = q.shape
    _num_pages, P, H_kv, _ = k_pages.shape
    n_split, _pps = split_plan(block_tables.shape[1], P, S * H_kv, _sm_count(q.device))
    if n_split == 1:
        return 1, None, None
    need_ws, need_pairs = S * n_split * H * (d + 2), S * H_kv
    ws, counters = _scratch.get(q.device, (None, None))
    if ws is None or ws.numel() < need_ws:
        ws = torch.empty(need_ws, dtype=torch.float32, device=q.device)
    if counters is None or counters.numel() < need_pairs:
        counters = torch.zeros(need_pairs, dtype=torch.int32, device=q.device)
    _scratch[q.device] = (ws, counters)
    return n_split, ws.data_ptr(), counters.data_ptr()


def _entry(int8: bool, state: bool = False):
    lib = build.load("paged_attention_int8" if int8 else "paged_attention")
    name = "acp_paged_decode_" + ("state" if state else "attention") + ("_int8" if int8 else "")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        # pointers: q, k/v pages, (int8: k/v scales), tables, lens, then
        # k_new, v_new, out — or, in the state form, acc, m, l — then the
        # split's workspace and counters; ints: S, H, H_kv, d, P,
        # max_pages, then dtype, with_self — or pos_base, global_page_size,
        # dtype — then n_split
        n_ptrs = 12 if int8 else 10
        n_ints = 10 if state else 9
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
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
    n_split, ws, counters = _split(q, k_pages, block_tables)
    ptrs += [
        block_tables.data_ptr(), seq_lens.data_ptr(),
        k_new.data_ptr() if with_self else None,
        v_new.data_ptr() if with_self else None,
        out.data_ptr(), ws, counters,
    ]
    err = _entry(int8)(
        *ptrs, S, H, H_kv, d, P, block_tables.shape[1], _DTYPES[q.dtype], int(with_self),
        n_split, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        walk = "int8" if int8 else "f32/bf16"
        raise RuntimeError(f"paged attention ({walk} walk) launch failed: CUDA error {err}")
    LAUNCHES += 1
    if int8:
        INT8_LAUNCHES += 1
    return out


def _launch_state(q, k_pages, v_pages, block_tables, seq_lens, pos_base, global_page_size,
                  k_scales, v_scales):
    global LAUNCHES, INT8_LAUNCHES, STATE_LAUNCHES
    _check(q, k_pages, v_pages, block_tables, seq_lens, None, None, k_scales, v_scales)
    S, H, d = q.shape
    _num_pages, P, H_kv, _ = k_pages.shape
    if not (0 <= pos_base and P <= global_page_size and pos_base + P <= global_page_size):
        raise ValueError(f"a slice of {P} rows at {pos_base} does not fit pages of "
                         f"{global_page_size} tokens")
    acc = torch.empty((S, H, d), dtype=torch.float32, device=q.device)
    m = torch.empty((S, H), dtype=torch.float32, device=q.device)
    l = torch.empty((S, H), dtype=torch.float32, device=q.device)
    if S == 0:
        return acc, m, l
    int8 = k_scales is not None
    ptrs = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()]
    if int8:
        ptrs += [k_scales.data_ptr(), v_scales.data_ptr()]
    n_split, ws, counters = _split(q, k_pages, block_tables)
    ptrs += [block_tables.data_ptr(), seq_lens.data_ptr(), acc.data_ptr(), m.data_ptr(),
             l.data_ptr(), ws, counters]
    err = _entry(int8, state=True)(
        *ptrs, S, H, H_kv, d, P, block_tables.shape[1], pos_base, global_page_size,
        _DTYPES[q.dtype], n_split, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        walk = "int8" if int8 else "f32/bf16"
        raise RuntimeError(f"paged attention state ({walk} walk) launch failed: CUDA error {err}")
    LAUNCHES += 1
    STATE_LAUNCHES += 1
    if int8:
        INT8_LAUNCHES += 1
    return acc, m, l


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


def paged_decode_state(
    q: torch.Tensor,  # [S, H, d]
    k_pages: torch.Tensor,  # [num_pages, P_local, H_kv, d] — a slice of every page
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [S, max_pages] int32
    seq_lens: torch.Tensor,  # [S] int32 — valid tokens per slot (global positions)
    *,
    pos_base: int = 0,  # the slice's first row within a page
    global_page_size: Optional[int] = None,  # tokens per page (default P_local)
    k_scales: Optional[torch.Tensor] = None,  # [num_pages, P_local, H_kv] f32 — int8
    v_scales: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's state form: unnormalized f32 ``(acc [S,H,d], m [S,H],
    l [S,H])`` over this pool's rows, local row r of page j at global
    position ``j * global_page_size + pos_base + r`` (the reference's
    ``_paged_state(..., pos_base=, global_page_size=)``). A lane with no
    valid row here gives ``m = -1e30``, ``l = 0``, ``acc = 0``."""
    G = global_page_size or k_pages.shape[1]
    if not _route(q):
        return paged_decode_state_reference(
            q, k_pages, v_pages, block_tables, seq_lens, pos_base=pos_base,
            global_page_size=G, k_scales=k_scales, v_scales=v_scales,
        )
    return _launch_state(q, k_pages, v_pages, block_tables, seq_lens, pos_base, G,
                         k_scales, v_scales)


def _sp_state(group, q, k_pages, v_pages, block_tables, seq_lens, k_scales, v_scales):
    """This sp rank's state walk merged over the sp group: (acc_g, m_g,
    l_g), identical on every rank of the group."""
    P_local = k_pages.shape[1]
    acc, m, l = paged_decode_state(
        q, k_pages, v_pages, block_tables, seq_lens,
        pos_base=group.sp_rank * P_local, global_page_size=P_local * group.sp,
        k_scales=k_scales, v_scales=v_scales,
    )
    return merge_sp_states(acc, m, l, group.sp_max, group.sp_sum)


def paged_decode_attention_sharded(
    group,  # ServingGroup
    q: torch.Tensor,  # [S, H/tp, d] — this rank's query heads
    k_pages: torch.Tensor,  # [num_pages, P/sp, H_kv/tp, d] — this rank's slice
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [S, max_pages] int32, the same on every rank
    seq_lens: torch.Tensor,  # [S] int32, the same on every rank
    *,
    k_scales: Optional[torch.Tensor] = None,  # [num_pages, P/sp, H_kv/tp] f32 — int8
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The classic form on a rank (reference :375): with sp = 1 the kernel
    over the rank's heads, no collective; with sp > 1 the state walk over
    the rank's rows merged over the sp group, normalized as
    ``acc / max(l, 1e-30)``."""
    if group.sp == 1:
        return paged_decode_attention(q, k_pages, v_pages, block_tables, seq_lens,
                                      k_scales=k_scales, v_scales=v_scales)
    acc, _m, l = _sp_state(group, q, k_pages, v_pages, block_tables, seq_lens,
                           k_scales, v_scales)
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)


def paged_decode_attention_cache_plus_new_sp_sharded(
    group,  # ServingGroup with sp > 1
    q: torch.Tensor,  # [S, H/tp, d]
    k_pages: torch.Tensor,  # [num_pages, P/sp, H_kv/tp, d] — WITHOUT the new token
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,  # [S] — tokens valid in the PAGES (excl. new)
    k_new: torch.Tensor,  # [S, H_kv/tp, d], the same on every sp rank
    v_new: torch.Tensor,
    *,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Context-parallel cache-plus-new (reference :399): the state walk over
    this rank's rows with exact global-position masking, the sp merge
    (``m_g = max m``, ``l_g = sum l*corr``, ``acc_g = sum acc*corr``), then
    the self term folded once."""
    acc, m, l = _sp_state(group, q, k_pages, v_pages, block_tables, seq_lens,
                          k_scales, v_scales)
    return fold_self_term(q, k_new, v_new, acc, m, l)


def paged_decode_attention_cache_plus_new_sharded(
    group,  # ServingGroup
    q: torch.Tensor,  # [S, H/tp, d]
    k_pages: torch.Tensor,  # [num_pages, P/sp, H_kv/tp, d]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    k_new: torch.Tensor,  # [S, H_kv/tp, d]
    v_new: torch.Tensor,
    *,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Reference :463: sp > 1 routes to the context-parallel form; sp = 1
    runs the cache-plus-new kernel over the rank's heads (each rank's pool
    holds only its heads, so the slice is contiguous), no collective."""
    if group.sp > 1:
        return paged_decode_attention_cache_plus_new_sp_sharded(
            group, q, k_pages, v_pages, block_tables, seq_lens, k_new, v_new,
            k_scales=k_scales, v_scales=v_scales,
        )
    return paged_decode_attention_cache_plus_new(
        q, k_pages, v_pages, block_tables, seq_lens, k_new, v_new,
        k_scales=k_scales, v_scales=v_scales,
    )
