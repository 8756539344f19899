"""Paged decode attention of the torch port against the JAX package: the
port's plain versions (the CPU path of the CUDA kernel's wrapper) against
``ops/paged.py``'s references and against the Pallas kernel in interpret
mode, in both forms (classic, and cache-plus-new with the self term).

Tolerances: float32 within 1e-5 (the same math, summed in another order);
bfloat16 outputs within 2e-2 absolute, about one bf16 ulp at the outputs'
magnitude — both sides accumulate in f32 and round once at the end.

The kernel itself runs only on the card; chip_smoke.py holds it against
these plain versions there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from agentcontrolplane_tpu.ops.paged import (
    paged_decode_attention_reference as jax_ref,
    paged_decode_attention_reference_cache_plus_new as jax_ref_new,
)
from agentcontrolplane_tpu.ops.pallas.paged_attention import (
    paged_decode_attention as jax_pallas,
    paged_decode_attention_cache_plus_new as jax_pallas_new,
)
from agentcontrolplane_tpu_torch.ops.cuda import paged_attention as wrapper
from agentcontrolplane_tpu_torch.ops.paged import (
    PageAllocator,
    TRASH_PAGE,
    paged_decode_attention_reference,
    paged_decode_attention_reference_cache_plus_new,
)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# (H, H_kv, d, P, max_pages, seq_lens): ragged lengths, an exact page
# multiple, a zero-length lane and a full table
GEOMETRIES = {
    "gqa_d16": (4, 2, 16, 8, 4, [0, 5, 16, 27, 32]),
    "mha_d32": (2, 2, 32, 4, 3, [1, 4, 12]),
    "group4_d64": (8, 2, 64, 16, 2, [17, 0, 32]),
}


def _inputs(geometry: str, seed: int = 0):
    H, H_kv, d, P, max_pages, seq_lens = GEOMETRIES[geometry]
    rng = np.random.default_rng(seed)
    S = len(seq_lens)
    num_pages = S * max_pages + 1
    perm = rng.permutation(np.arange(1, num_pages)).astype(np.int32)
    tables = np.full((S, max_pages), TRASH_PAGE, dtype=np.int32)
    for s, n in enumerate(seq_lens):
        used = -(-n // P)
        tables[s, :used] = perm[s * max_pages : s * max_pages + used]
    return {
        "q": rng.standard_normal((S, H, d)).astype(np.float32),
        "k_pages": rng.standard_normal((num_pages, P, H_kv, d)).astype(np.float32),
        "v_pages": rng.standard_normal((num_pages, P, H_kv, d)).astype(np.float32),
        "tables": tables,
        "seq_lens": np.asarray(seq_lens, dtype=np.int32),
        "k_new": rng.standard_normal((S, H_kv, d)).astype(np.float32),
        "v_new": rng.standard_normal((S, H_kv, d)).astype(np.float32),
    }


def _torch(x, dtype):
    t = torch.from_numpy(x)
    return t.to(dtype) if t.is_floating_point() else t


def _jax(x, dtype):
    a = jnp.asarray(x)
    return a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a


def _port(inp, dtype, with_self):
    t = {k: _torch(v, dtype) for k, v in inp.items()}
    if with_self:
        out = paged_decode_attention_reference_cache_plus_new(
            t["q"], t["k_pages"], t["v_pages"], t["tables"], t["seq_lens"],
            t["k_new"], t["v_new"],
        )
    else:
        out = paged_decode_attention_reference(
            t["q"], t["k_pages"], t["v_pages"], t["tables"], t["seq_lens"]
        )
    assert out.dtype == dtype
    return out.float().numpy()


def _jax_run(fn, inp, dtype, with_self, **kw):
    j = {k: _jax(v, dtype) for k, v in inp.items()}
    args = [j["q"], j["k_pages"], j["v_pages"], j["tables"], j["seq_lens"]]
    if with_self:
        args += [j["k_new"], j["v_new"]]
    return np.asarray(fn(*args, **kw).astype(jnp.float32))


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_self", [True, False], ids=["cache_plus_new", "classic"])
def test_plain_version_matches_jax_reference_and_pallas(geometry, dtype, with_self):
    inp = _inputs(geometry)
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    ours = _port(inp, tdt, with_self)
    tol = TOL[dtype]
    pallas = _jax_run(jax_pallas_new if with_self else jax_pallas, inp, jdt, with_self,
                      interpret=True)
    np.testing.assert_allclose(ours, pallas, atol=tol, rtol=tol)
    ref = _jax_run(jax_ref_new if with_self else jax_ref, inp, jdt, with_self)
    # on a zero-length lane the classic XLA reference averages the masked
    # rows while both kernels (Pallas and CUDA) return zeros; the port
    # follows the kernels, so that lane is held against Pallas only
    live = inp["seq_lens"] > 0 if not with_self else np.ones(len(inp["seq_lens"]), bool)
    np.testing.assert_allclose(ours[live], ref[live], atol=tol, rtol=tol)


def test_zero_length_lane_edges():
    """seq_len == 0 walks nothing: the self-term form returns v_new exactly
    (repeated over the group), the classic form zeros."""
    inp = _inputs("gqa_d16")
    out_new = _port(inp, torch.float32, True)
    out_cls = _port(inp, torch.float32, False)
    H, H_kv = out_new.shape[1], inp["v_new"].shape[1]
    expect = np.repeat(inp["v_new"][0], H // H_kv, axis=0)
    np.testing.assert_allclose(out_new[0], expect, atol=1e-6)
    assert np.all(out_cls[0] == 0.0)


@pytest.mark.parametrize("with_self", [True, False], ids=["cache_plus_new", "classic"])
def test_wrapper_routes_cpu_tensors_to_the_plain_version(with_self):
    inp = _inputs("gqa_d16", seed=1)
    t = {k: _torch(v, torch.float32) for k, v in inp.items()}
    before = wrapper.LAUNCHES
    if with_self:
        got = wrapper.paged_decode_attention_cache_plus_new(
            t["q"], t["k_pages"], t["v_pages"], t["tables"], t["seq_lens"], t["k_new"], t["v_new"]
        )
    else:
        got = wrapper.paged_decode_attention(
            t["q"], t["k_pages"], t["v_pages"], t["tables"], t["seq_lens"]
        )
    np.testing.assert_array_equal(got.numpy(), _port(inp, torch.float32, with_self))
    assert wrapper.LAUNCHES == before  # the plain version is not a launch


def test_wrapper_rejects_other_devices_and_checks_shapes():
    inp = _inputs("gqa_d16")
    t = {k: _torch(v, torch.float32).to("meta") for k, v in inp.items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        wrapper.paged_decode_attention(
            t["q"], t["k_pages"], t["v_pages"], t["tables"], t["seq_lens"]
        )
    c = {k: _torch(v, torch.float32) for k, v in inp.items()}
    with pytest.raises(ValueError, match="head_dim"):
        wrapper._check(c["q"][..., :12].contiguous(), c["k_pages"][..., :12].contiguous(),
                       c["v_pages"][..., :12].contiguous(), c["tables"], c["seq_lens"],
                       None, None)
    with pytest.raises(TypeError, match="int32"):
        wrapper._check(c["q"], c["k_pages"], c["v_pages"], c["tables"].long(),
                       c["seq_lens"], None, None)


def test_page_allocator_matches_reference_semantics():
    a = PageAllocator(6)
    pages = a.alloc(3)
    assert pages == [1, 2, 3] and a.free_count == 2  # page 0 is never handed out
    a.free(pages + [TRASH_PAGE])  # trash entries in a table are ignored
    assert a.free_count == 5
    with pytest.raises(MemoryError):
        a.alloc(6)
    with pytest.raises(KeyError):
        a.free([1])  # double free


# -- the int8 walk -----------------------------------------------------------
#
# int8 pools with f32 scale twins, made once by the reference's compiled
# kv_quantize and handed to both sides, so the comparison is of attention
# alone: the plain versions dequantize after the gather in f32, exactly as
# the reference and the Pallas kernel do, so the tolerances stay 1e-5 (f32
# q) and 2e-2 (bf16 q).

import jax

from agentcontrolplane_tpu.ops.quant import kv_quantize as jax_kv_quantize


def _quantize_pools(inp):
    out = dict(inp)
    for name, scale in (("k_pages", "k_scales"), ("v_pages", "v_scales")):
        q, s = jax.jit(jax_kv_quantize)(jnp.asarray(inp[name]))
        out[name], out[scale] = np.array(q), np.array(s)
    return out


def _port_int8(inp, dtype, with_self, fn_new=None, fn=None):
    t = {k: (_torch(v, dtype) if k not in ("k_scales", "v_scales") else torch.from_numpy(v))
         for k, v in inp.items()}
    t["k_pages"], t["v_pages"] = torch.from_numpy(inp["k_pages"]), torch.from_numpy(inp["v_pages"])
    scales = dict(k_scales=t["k_scales"], v_scales=t["v_scales"])
    if with_self:
        out = (fn_new or paged_decode_attention_reference_cache_plus_new)(
            t["q"], t["k_pages"], t["v_pages"], t["tables"], t["seq_lens"],
            t["k_new"], t["v_new"], **scales,
        )
    else:
        out = (fn or paged_decode_attention_reference)(
            t["q"], t["k_pages"], t["v_pages"], t["tables"], t["seq_lens"], **scales
        )
    assert out.dtype == dtype
    return out.float().numpy()


def _jax_int8(fn, inp, dtype, with_self, **kw):
    j = {k: (_jax(v, dtype) if k not in ("k_pages", "v_pages", "k_scales", "v_scales")
             else jnp.asarray(v)) for k, v in inp.items()}
    args = [j["q"], j["k_pages"], j["v_pages"], j["tables"], j["seq_lens"]]
    if with_self:
        args += [j["k_new"], j["v_new"]]
    out = fn(*args, k_scales=j["k_scales"], v_scales=j["v_scales"], **kw)
    return np.asarray(out.astype(jnp.float32))


def _check_int8(inp, dtype, with_self, live=None):
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    ours = _port_int8(inp, tdt, with_self)
    tol = TOL[dtype]
    pallas = _jax_int8(jax_pallas_new if with_self else jax_pallas, inp, jdt, with_self,
                       interpret=True)
    np.testing.assert_allclose(ours, pallas, atol=tol, rtol=tol)
    ref = _jax_int8(jax_ref_new if with_self else jax_ref, inp, jdt, with_self)
    if live is None:  # the classic XLA reference averages a zero-length lane
        live = inp["seq_lens"] > 0 if not with_self else np.ones(len(inp["seq_lens"]), bool)
    np.testing.assert_allclose(ours[live], ref[live], atol=tol, rtol=tol)
    return ours


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_self", [True, False], ids=["cache_plus_new", "classic"])
def test_int8_plain_version_matches_jax_reference_and_pallas(geometry, dtype, with_self):
    _check_int8(_quantize_pools(_inputs(geometry)), dtype, with_self)


# sequence lengths that end mid-page, exactly on a page boundary, and a
# single-token row (the first fetch is also the last), with pages of 4
ALIGNMENT_LENS = ([8, 4, 16], [1, 4, 17], [9, 1, 12], [4, 3, 1])


def _edge_inputs(seq_lens, seed=7, H=4, H_kv=2, d=16, P=4, max_pages=6):
    GEOMETRIES["_edge"] = (H, H_kv, d, P, max_pages, list(seq_lens))
    try:
        return _quantize_pools(_inputs("_edge", seed))
    finally:
        del GEOMETRIES["_edge"]


@pytest.mark.parametrize("seq_lens", ALIGNMENT_LENS, ids=lambda x: "-".join(map(str, x)))
@pytest.mark.parametrize("with_self", [True, False], ids=["cache_plus_new", "classic"])
def test_int8_scale_row_alignment_edges(seq_lens, with_self):
    _check_int8(_edge_inputs(seq_lens), "float32", with_self)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_self", [True, False], ids=["cache_plus_new", "classic"])
def test_int8_masks_trash_page_and_poisoned_tail_scales(dtype, with_self):
    """Junk in the masked region must not reach the output: the trash page
    and every row past each slot's seq_len in its last page (values AND
    scales) are poisoned with 127 and 1e30, and the result must equal the
    one over the clean pools."""
    clean = _edge_inputs([9, 4, 17, 6], seed=8)
    P = clean["k_pages"].shape[1]
    bad = {k: v.copy() for k, v in clean.items()}
    for name, value in (("k_pages", 127), ("v_pages", 127), ("k_scales", 1e30),
                        ("v_scales", 1e30)):
        bad[name][TRASH_PAGE] = value
        for s, n in enumerate(clean["seq_lens"]):
            last = (int(n) - 1) // P
            page, off = int(clean["tables"][s, last]), int(n) - last * P
            bad[name][page, off:] = value
    expect = _check_int8(clean, dtype, with_self)
    got = _check_int8(bad, dtype, with_self)
    np.testing.assert_allclose(got, expect, atol=TOL[dtype], rtol=TOL[dtype])
    # the XLA reference over the CLEAN pools holds the poisoned run too
    ref = _jax_int8(jax_ref_new if with_self else jax_ref, clean, getattr(jnp, dtype), with_self)
    np.testing.assert_allclose(got, ref, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("with_self", [True, False], ids=["cache_plus_new", "classic"])
def test_wrapper_routes_int8_cpu_tensors_to_the_plain_version(with_self):
    inp = _quantize_pools(_inputs("group4_d64", seed=1))
    before, before_int8 = wrapper.LAUNCHES, wrapper.INT8_LAUNCHES
    got = _port_int8(inp, torch.bfloat16, with_self,
                     fn_new=wrapper.paged_decode_attention_cache_plus_new,
                     fn=wrapper.paged_decode_attention)
    np.testing.assert_array_equal(got, _port_int8(inp, torch.bfloat16, with_self))
    assert (wrapper.LAUNCHES, wrapper.INT8_LAUNCHES) == (before, before_int8)


def test_wrapper_rejects_mismatched_scales():
    inp = _quantize_pools(_inputs("gqa_d16"))
    c = {k: (_torch(v, torch.float32) if k not in ("k_scales", "v_scales") else torch.from_numpy(v))
         for k, v in inp.items()}
    kq, vq = torch.from_numpy(inp["k_pages"]), torch.from_numpy(inp["v_pages"])
    ks, vs = c["k_scales"], c["v_scales"]
    base = (c["q"], kq, vq, c["tables"], c["seq_lens"], c["k_new"], c["v_new"])
    wrapper._check(*base, ks, vs)  # the well-formed call passes
    with pytest.raises(ValueError, match="need k_scales"):
        wrapper._check(*base, None, None)
    with pytest.raises(ValueError, match="need k_scales"):
        wrapper._check(*base, ks, None)
    with pytest.raises(ValueError, match=r"\[NP, P, H_kv\]"):
        wrapper._check(*base, ks[:, :-1].contiguous(), vs)
    with pytest.raises(ValueError, match=r"\[NP, P, H_kv\]"):
        wrapper._check(*base, ks, vs[..., None].contiguous())
    with pytest.raises(TypeError, match="float32"):
        wrapper._check(*base, ks.to(torch.bfloat16), vs)
    with pytest.raises(TypeError, match="float32"):
        wrapper._check(*base, ks, vs.double())
    fp = {k: _torch(v, torch.float32) for k, v in _inputs("gqa_d16").items()}
    with pytest.raises(ValueError, match="only int8 pages"):
        wrapper._check(c["q"], fp["k_pages"], fp["v_pages"], c["tables"], c["seq_lens"],
                       c["k_new"], c["v_new"], ks, vs)
    with pytest.raises(TypeError, match="both be int8"):
        wrapper._check(c["q"], kq, fp["v_pages"], c["tables"], c["seq_lens"],
                       c["k_new"], c["v_new"], ks, vs)
    with pytest.raises(ValueError, match="contiguous"):
        wrapper._check(*base, ks.transpose(0, 1).contiguous().transpose(0, 1), vs)
    with pytest.raises(TypeError, match="k_new"):
        wrapper._check(*base[:5], c["k_new"].double(), c["v_new"], ks, vs)


def test_init_kv_pages_int8_layout():
    from agentcontrolplane_tpu_torch.ops.paged import init_kv_pages

    pools = init_kv_pages(2, 5, 4, 2, 16, torch.bfloat16, device="cpu", quantize=True)
    assert {n: (t.dtype, tuple(t.shape)) for n, t in pools.items()} == {
        "k": (torch.int8, (2, 5, 4, 2, 16)), "v": (torch.int8, (2, 5, 4, 2, 16)),
        "ks": (torch.float32, (2, 5, 4, 2)), "vs": (torch.float32, (2, 5, 4, 2)),
    }
    plain = init_kv_pages(2, 5, 4, 2, 16, torch.bfloat16, device="cpu")
    assert set(plain) == {"k", "v"} and plain["k"].dtype == torch.bfloat16
    a = PageAllocator(6)
    a.free(a.alloc(2)[:1])
    assert a.allocated_count == 1
