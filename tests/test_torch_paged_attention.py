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
