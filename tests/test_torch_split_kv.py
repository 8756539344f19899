"""The split-KV page walk's algebra on the CPU: the port's plain
split-and-merge (``ops/paged.py::paged_decode_state_split_reference``,
the arithmetic the CUDA kernel runs inside one launch) against the unsplit
plain walk, against ``agentcontrolplane_tpu/ops/paged.py``'s references and
against the Pallas kernel in interpret mode, in all three forms (the
unnormalized state, the classic normalization and the cache-plus-new
self-term fold), for f32/bf16 and int8 pages, at split counts 1, 2, 3 and
16 cut as the kernel cuts them, and on a context-parallel slice of every
page (``pos_base`` > 0).

Lengths end on a split boundary (which is a page edge), one row past it,
inside the first split (so every later split is empty), at 0 and at the
full table. Tolerances: float32 1e-5 (the same math, summed in another
order); bfloat16 outputs 2e-2, about one bf16 ulp at the outputs' magnitude
(both sides accumulate in f32 and round once); states 1e-5 relative to the
weight sum, as f32 on both sides.

The kernel itself runs only on the card; chip_smoke.py holds it against
the plain versions there, at the same boundaries.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from agentcontrolplane_tpu.ops.paged import (
    paged_decode_attention_reference as jax_ref,
    paged_decode_attention_reference_cache_plus_new as jax_ref_new,
)
from agentcontrolplane_tpu.ops.pallas import paged_attention as jpa
from agentcontrolplane_tpu.ops.quant import kv_quantize as jax_kv_quantize
from agentcontrolplane_tpu_torch.ops import paged as plain
from agentcontrolplane_tpu_torch.ops.cuda import build, walk_parts
from agentcontrolplane_tpu_torch.ops.cuda.paged_attention import split_plan

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
STATE_TOL = 1e-5
# 8 lanes, pages of 4 rows, a 16-page table, 8 query heads over 2 KV heads
S, H, HKV, D, P, MAX_PAGES = 8, 8, 2, 16, 4, 16
NUM_PAGES = S * MAX_PAGES + 1
# 24 ends on the 3-way split's first boundary and 32 on the 2-way split's
# (both page edges), 25 and 33 one row past them, 5 inside the first split
# of every cut, 64 the full table
LENS = np.array([0, 24, 25, 32, 33, 5, 64, 48], np.int32)
SPLITS = (1, 2, 3, 16)


def _bounds(n_split: int) -> list[int]:
    """Page boundaries of an ``n_split``-way cut, as the kernel cuts:
    runs of ceil(max_pages / n_split) columns."""
    pps = -(-MAX_PAGES // n_split)
    return [min(z * pps, MAX_PAGES) for z in range(n_split)] + [MAX_PAGES]


@functools.lru_cache(maxsize=None)
def _inputs(pages: str) -> dict:
    """numpy inputs from one seed; int8 pages made by the reference's
    compiled kv_quantize and handed to both sides."""
    rng = np.random.default_rng(11)
    tables = np.zeros((S, MAX_PAGES), np.int32)
    perm = rng.permutation(np.arange(1, NUM_PAGES)).astype(np.int32)
    for s, n in enumerate(LENS):
        used = -(-int(n) // P)
        tables[s, :used] = perm[s * MAX_PAGES: s * MAX_PAGES + used]
    shape = (NUM_PAGES, P, HKV, D)
    inp = {
        "q": rng.standard_normal((S, H, D)).astype(np.float32),
        "k_new": rng.standard_normal((S, HKV, D)).astype(np.float32),
        "v_new": rng.standard_normal((S, HKV, D)).astype(np.float32),
        "k": rng.standard_normal(shape).astype(np.float32),
        "v": rng.standard_normal(shape).astype(np.float32),
        "tables": tables,
        "lens": LENS.copy(),
    }
    if pages == "int8":
        for name in ("k", "v"):
            qv, sc = jax.jit(jax_kv_quantize)(jnp.asarray(inp[name]))
            inp[name], inp[f"{name}s"] = np.array(qv), np.array(sc)
    return inp


def _torch(inp: dict, dtype: torch.dtype, rows=slice(None)) -> dict:
    """Torch tensors of the inputs, the pools cut to ``rows`` of every page."""
    t = {n: torch.from_numpy(inp[n]).to(dtype) for n in ("q", "k_new", "v_new")}
    t["tables"], t["lens"] = torch.from_numpy(inp["tables"]), torch.from_numpy(inp["lens"])
    int8 = "ks" in inp
    for n in ("k", "v"):
        a = torch.from_numpy(np.ascontiguousarray(inp[n][:, rows]))
        t[n] = a if int8 else a.to(dtype)
    t["scales"] = ({"k_scales": torch.from_numpy(np.ascontiguousarray(inp["ks"][:, rows])),
                    "v_scales": torch.from_numpy(np.ascontiguousarray(inp["vs"][:, rows]))}
                   if int8 else {})
    return t


def _jax_args(inp: dict, dtype, rows=slice(None)) -> tuple[list, dict]:
    jdt = getattr(jnp, dtype)
    int8 = "ks" in inp
    k, v = (jnp.asarray(inp[n][:, rows]) for n in ("k", "v"))
    if not int8:
        k, v = k.astype(jdt), v.astype(jdt)
    args = [jnp.asarray(inp["q"]).astype(jdt), k, v, jnp.asarray(inp["tables"]),
            jnp.asarray(inp["lens"])]
    kw = ({"k_scales": jnp.asarray(inp["ks"][:, rows]), "v_scales": jnp.asarray(inp["vs"][:, rows])}
          if int8 else {})
    return args, kw


@functools.lru_cache(maxsize=None)
def _jax_outputs(pages: str, dtype: str) -> dict:
    """The reference's outputs, once per page type and dtype: the XLA
    references and the Pallas kernel (interpret mode), both forms."""
    inp = _inputs(pages)
    args, kw = _jax_args(inp, dtype)
    jdt = getattr(jnp, dtype)
    new = [jnp.asarray(inp["k_new"]).astype(jdt), jnp.asarray(inp["v_new"]).astype(jdt)]
    out = {
        "ref_classic": jax_ref(*args, **kw),
        "ref_cache_plus_new": jax_ref_new(*args, *new, **kw),
        "pallas_classic": jpa.paged_decode_attention(*args, interpret=True, **kw),
        "pallas_cache_plus_new": jpa.paged_decode_attention_cache_plus_new(
            *args, *new, interpret=True, **kw),
    }
    return {n: np.asarray(a.astype(jnp.float32)) for n, a in out.items()}


@functools.lru_cache(maxsize=None)
def _pallas_state(pages: str, rank: int) -> tuple:
    """The Pallas kernel's state (interpret mode) over sp=2 rank ``rank``'s
    rows of every page, once per page type and rank."""
    args, kw = _jax_args(_inputs(pages), "float32", slice(2 * rank, 2 * rank + 2))
    out = jpa._paged_state(*args, interpret=True, global_page_size=P,
                           pos_base=jnp.array([2 * rank], jnp.int32), **kw)
    return tuple(np.asarray(a) for a in out)


def _state_err(got, want) -> float:
    """Largest difference of two (acc, m, l) states relative to the weight
    sum, as chip_smoke.py measures the kernel's."""
    acc, m, l = (torch.as_tensor(np.asarray(x), dtype=torch.float32) for x in got)
    acc_w, m_w, l_w = (torch.as_tensor(np.asarray(x), dtype=torch.float32) for x in want)
    w = l_w.clamp_min(1.0)
    return max((m - m_w).abs().max().item(), ((l - l_w).abs() / w).max().item(),
               ((acc - acc_w).abs() / w[..., None]).max().item())


@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("pages", ["native", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_walk_matches_unsplit_reference_and_pallas(dtype, pages, n_split):
    """All three forms of the split walk: the state against the unsplit
    plain state, the classic and cache-plus-new outputs against the unsplit
    plain outputs, the XLA references and the Pallas kernel."""
    inp = _inputs(pages)
    tdt = getattr(torch, dtype)
    t = _torch(inp, tdt)
    base = (t["q"], t["k"], t["v"], t["tables"], t["lens"])
    bounds = _bounds(n_split)
    assert len(bounds) == n_split + 1
    split = plain.paged_decode_state_split_reference(*base, bounds, **t["scales"])
    whole = plain.paged_decode_state_reference(*base, **t["scales"])
    assert _state_err(split, whole) <= STATE_TOL
    acc, m, l = split
    empty = torch.from_numpy(LENS == 0)
    assert (m[empty] == -1e30).all() and (l[empty] == 0).all() and (acc[empty] == 0).all()

    tol = TOL[dtype]
    jax_out = _jax_outputs(pages, dtype)
    forms = {
        "classic": ((acc / torch.clamp_min(l, 1e-30)[..., None]).to(tdt),
                    plain.paged_decode_attention_reference(*base, **t["scales"])),
        "cache_plus_new": (plain.fold_self_term(t["q"], t["k_new"], t["v_new"], acc, m, l),
                           plain.paged_decode_attention_reference_cache_plus_new(
                               *base, t["k_new"], t["v_new"], **t["scales"])),
    }
    for form, (ours, unsplit) in forms.items():
        assert ours.dtype == tdt
        ours = ours.float().numpy()
        np.testing.assert_allclose(ours, unsplit.float().numpy(), atol=tol, rtol=tol,
                                   err_msg=f"{form} vs unsplit")
        np.testing.assert_allclose(ours, jax_out[f"pallas_{form}"], atol=tol, rtol=tol,
                                   err_msg=f"{form} vs Pallas")
        # the classic XLA reference averages a zero-length lane's masked rows
        live = LENS > 0 if form == "classic" else np.ones(S, bool)
        np.testing.assert_allclose(ours[live], jax_out[f"ref_{form}"][live], atol=tol, rtol=tol,
                                   err_msg=f"{form} vs XLA reference")


@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("pages", ["native", "int8"])
def test_split_walk_on_an_sp_slice(pages, n_split):
    """Each sp=2 rank's slice of every page (rows 0-1 at pos_base 0, rows
    2-3 at pos_base 2 of 4-token pages), split: the state against the
    unsplit plain state and, on lanes the rank holds a row of, the Pallas
    kernel's ``_paged_state``; the two ranks merged with the self term
    against the XLA reference over whole pages."""
    inp = _inputs(pages)
    bounds = _bounds(n_split)
    states = []
    for rank in range(2):
        rows = slice(2 * rank, 2 * rank + 2)
        t = _torch(inp, torch.float32, rows)
        base = (t["q"], t["k"], t["v"], t["tables"], t["lens"])
        kw = dict(pos_base=2 * rank, global_page_size=P, **t["scales"])
        split = plain.paged_decode_state_split_reference(*base, bounds, **kw)
        assert _state_err(split, plain.paged_decode_state_reference(*base, **kw)) <= STATE_TOL
        pallas = _pallas_state(pages, rank)
        pos = np.arange(MAX_PAGES)[:, None] * P + 2 * rank + np.arange(2)[None, :]
        held = np.array([(pos < n).sum() > 0 for n in LENS])
        assert (~held).any() and held.any()
        for name, o, r in zip(("acc", "m", "l"), split, pallas):
            np.testing.assert_allclose(o.numpy()[held], np.asarray(r)[held], rtol=1e-5,
                                       atol=1e-5, err_msg=f"{name} rank {rank}")
        acc, m, l = (x.numpy()[~held] for x in split)
        assert np.all(m == np.float32(-1e30)) and np.all(l == 0) and np.all(acc == 0)
        states.append(split)
    acc, m, l = (torch.stack(x) for x in zip(*states))
    acc, m, l = plain.merge_sp_states(acc, m, l, lambda x: x.amax(0), lambda x: x.sum(0))
    t = _torch(inp, torch.float32)
    merged = plain.fold_self_term(t["q"], t["k_new"], t["v_new"], acc, m, l).numpy()
    np.testing.assert_allclose(merged, _jax_outputs(pages, "float32")["ref_cache_plus_new"],
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape,want", [
    # (max_pages, rows per page, S x H_kv, SMs) -> n_split
    ((128, 16, 8 * 8, 132), 5),    # llama3-8b on one card, 8 slots
    ((128, 16, 8 * 4, 132), 9),    # one tp=2 rank's heads
    ((128, 16, 1 * 8, 132), 16),   # one long lane: capped at 128 rows a split
    ((128, 8, 8 * 4, 132), 8),     # one sp=2 x tp=2 rank's 8-row slices
    ((8, 8, 5 * 2, 132), 1),       # a table shorter than one split's rows
    ((4, 256, 1, 132), 4),         # never more splits than columns
])
def test_split_plan_from_shapes(shape, want):
    """About two waves of blocks, at least 128 rows a split, no split
    wholly past the table, from shapes alone."""
    max_pages, rows, lanes, sms = shape
    n_split, pps = split_plan(max_pages, rows, lanes, sms)
    assert n_split == want
    assert 1 <= n_split <= max_pages and (n_split - 1) * pps < max_pages <= n_split * pps
    assert n_split == 1 or pps * rows >= 128


@pytest.mark.parametrize("variant", sorted(walk_parts.VARIANTS))
def test_walk_parts_switches_find_the_kernel_source(variant):
    """The card-side breakdown tool edits copies of the kernel header at
    fixed anchors; each switched-off part must find its anchor and leave
    the header otherwise whole."""
    src = (build.CSRC / "paged_attention.cuh").read_text()
    math, loads, merge = walk_parts.VARIANTS[variant]
    out = walk_parts.patched(src, math, loads, merge)
    assert (out == src) == (math and loads and merge)
    assert out.count("H < 0") == (not math) + (not loads) + (not merge)
