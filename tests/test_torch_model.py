"""The torch port's Llama programs against the JAX package on the tiny f32
preset with the same weights: ``forward`` logits, paged prefill (page
contents and logits) and paged decode (logits and the committed pages,
including the trash-page routing of inactive lanes). Logits within rtol /
atol 2e-4 — the bar the reference's own HF fidelity test uses; page
contents (one projection + RoPE away from the weights) within 1e-5."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from agentcontrolplane_tpu.models import llama as jl
from agentcontrolplane_tpu_torch.engine.weights import params_from_jax
from agentcontrolplane_tpu_torch.models import llama as tl
from agentcontrolplane_tpu_torch.ops.paged import TRASH_PAGE

JCFG = dataclasses.replace(jl.PRESETS["tiny"], vocab_size=512, max_seq_len=256)
TCFG = dataclasses.replace(tl.PRESETS["tiny"], vocab_size=512, max_seq_len=256)
P, NUM_PAGES, MAX_PAGES = 8, 16, 4
TOL = dict(rtol=2e-4, atol=2e-4)
KV_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def params():
    np_params = jax.tree_util.tree_map(np.asarray, jl.init_params(JCFG, jax.random.key(0)))
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    return jp, params_from_jax(np_params, TCFG, device="cpu")


def _prefill_inputs():
    rng = np.random.default_rng(0)
    lengths = np.array([5, 16, 11], np.int32)
    tokens = rng.integers(0, 512, (3, 16)).astype(np.int32)
    page_ids = np.array([[3, TRASH_PAGE], [5, 6], [1, 9]], np.int32)
    return tokens, lengths, page_ids


def _jax_pages():
    return jl.init_paged_cache(JCFG, NUM_PAGES, P)


def test_forward_matches_jax(params):
    jp, tp = params
    tokens = np.random.default_rng(1).integers(0, 512, (2, 24)).astype(np.int32)
    ref = np.asarray(jl.forward(jp, jnp.asarray(tokens), JCFG))
    ours = tl.forward(tp, torch.from_numpy(tokens), TCFG).numpy()
    np.testing.assert_allclose(ours, ref, **TOL)


def test_prefill_paged_batch_matches_jax(params):
    jp, tp = params
    tokens, lengths, page_ids = _prefill_inputs()
    j_pages, j_logits = jl.prefill_paged_batch(
        jp, _jax_pages(), jnp.asarray(tokens), jnp.asarray(lengths), jnp.asarray(page_ids), JCFG
    )
    t_pages = tl.init_paged_cache(TCFG, NUM_PAGES, P, device="cpu")
    t_pages, t_logits = tl.prefill_paged_batch(
        tp, t_pages, *map(torch.from_numpy, (tokens, lengths, page_ids)), TCFG
    )
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    for name in ("k", "v"):
        # page 0 takes colliding trash writes in unspecified order: skip it
        np.testing.assert_allclose(
            t_pages[name][:, 1:].numpy(), np.asarray(j_pages[name])[:, 1:], **KV_TOL
        )


def _decode_inputs():
    seq_lens = np.array([5, 16, 3, 11], np.int32)
    tables = np.array(
        [[3, 7, 0, 0], [5, 6, 8, 0], [10, 0, 0, 0], [1, 9, 0, 0]], np.int32
    )
    active = np.array([True, True, False, True])
    tokens = np.array([17, 400, 9, 256], np.int32)
    return tokens, seq_lens, tables, active


def test_decode_step_paged_matches_jax(params):
    jp, tp = params
    rng = np.random.default_rng(2)
    shape = (JCFG.n_layers, NUM_PAGES, P, JCFG.n_kv_heads, JCFG.head_dim)
    start = {n: rng.standard_normal(shape).astype(np.float32) for n in ("k", "v")}
    tokens, seq_lens, tables, active = _decode_inputs()
    j_pages, j_logits = jl.decode_step_paged(
        jp, {n: jnp.asarray(a) for n, a in start.items()},
        *map(jnp.asarray, (tokens, seq_lens, tables, active)), JCFG, use_pallas=False,
    )
    t_pages = {n: torch.from_numpy(a.copy()) for n, a in start.items()}
    t_pages, t_logits = tl.decode_step_paged(
        tp, t_pages, *map(torch.from_numpy, (tokens, seq_lens, tables, active)), TCFG
    )
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    for name in ("k", "v"):
        ours, ref = t_pages[name].numpy(), np.asarray(j_pages[name])
        np.testing.assert_allclose(ours[:, 1:], ref[:, 1:], **KV_TOL)
        # active lanes wrote their token at (page(seq_len), offset(seq_len))
        for s in np.flatnonzero(active):
            page, off = tables[s, seq_lens[s] // P], seq_lens[s] % P
            assert not np.array_equal(ours[:, page, off], start[name][:, page, off])
        # the inactive lane's own page is untouched: its write went to trash
        inactive = np.flatnonzero(~active)[0]
        page = tables[inactive, seq_lens[inactive] // P]
        np.testing.assert_array_equal(ours[:, page], start[name][:, page])
        assert not np.array_equal(ours[:, TRASH_PAGE], start[name][:, TRASH_PAGE])


def test_prefill_then_decode_reproduces_forward(params):
    """The slice end to end at the model level: prefill a prompt into
    pages, decode its continuation token by token through the paged path,
    and every step's logits equal the full-sequence forward's."""
    _jp, tp = params
    seq = np.random.default_rng(3).integers(0, 512, 21).astype(np.int32)
    full = tl.forward(tp, torch.from_numpy(seq[None]), TCFG)[0].numpy()
    plen = 13
    tokens = np.zeros((1, 16), np.int32)
    tokens[0, :plen] = seq[:plen]
    pages = tl.init_paged_cache(TCFG, NUM_PAGES, P, device="cpu")
    table = np.array([[2, 4, 6, 0]], np.int32)
    pages, logits = tl.prefill_paged_batch(
        tp, pages, torch.from_numpy(tokens), torch.tensor([plen]),
        torch.from_numpy(table[:, :2]), TCFG,
    )
    np.testing.assert_allclose(logits[0].numpy(), full[plen - 1], **TOL)
    for pos in range(plen, len(seq)):
        pages, logits = tl.decode_step_paged(
            tp, pages, torch.tensor([seq[pos]]), torch.tensor([pos], dtype=torch.int32),
            torch.from_numpy(table), torch.tensor([True]), TCFG,
        )
        np.testing.assert_allclose(logits[0].numpy(), full[pos], **TOL)


def test_unported_families_are_refused():
    gemma = tl.PRESETS["gemma-2b"]
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tl.check_supported(gemma)
    with pytest.raises(NotImplementedError):
        tl.init_params(tl.PRESETS["moe-tiny"], torch.Generator().manual_seed(0))


# -- int8 serving ------------------------------------------------------------
#
# The reference runs its model programs under jax.jit, which is also what
# fixes its quantizer's rounding (ops/quant.py in the port says why), so
# the JAX side runs jitted here. Two sides' f32 K/V differ in the last
# bits, so an int8 value may land one step apart where x / scale sits on a
# rounding half: allowed (and counted); scales within 1e-6 relative.

from functools import partial

from agentcontrolplane_tpu.ops import quant as jq
from agentcontrolplane_tpu_torch.ops import quant as tq

SCALE_RTOL = 1e-6


def _compare_int8_pools(ours: dict, ref: dict, skip_trash: bool = True) -> int:
    """Hold the port's int8 pools against the reference's; returns how
    many int8 values differ (each by exactly one step)."""
    lo = 1 if skip_trash else 0
    differing = 0
    for name in ("k", "v"):
        a = ours[name][:, lo:].numpy().astype(np.int32)
        b = np.asarray(ref[name])[:, lo:].astype(np.int32)
        assert np.abs(a - b).max() <= 1, name
        differing += int((a != b).sum())
    for name in ("ks", "vs"):
        np.testing.assert_allclose(ours[name][:, lo:].numpy(), np.asarray(ref[name])[:, lo:],
                                   rtol=SCALE_RTOL, atol=0)
    return differing


def test_int8_prefill_and_decode_match_jax_on_quantized_pages(params):
    jp, tp = params
    tokens, lengths, page_ids = _prefill_inputs()
    j_prefill = jax.jit(partial(jl.prefill_paged_batch, config=JCFG))
    j_pages, j_logits = j_prefill(
        jp, jl.init_paged_cache(JCFG, NUM_PAGES, P, quantize_kv=True), jnp.asarray(tokens),
        jnp.asarray(lengths), jnp.asarray(page_ids),
    )
    t_pages = tl.init_paged_cache(TCFG, NUM_PAGES, P, device="cpu", quantize_kv=True)
    assert t_pages["k"].dtype == torch.int8 and t_pages["ks"].dtype == torch.float32
    t_pages, t_logits = tl.prefill_paged_batch(
        tp, t_pages, *map(torch.from_numpy, (tokens, lengths, page_ids)), TCFG
    )
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    differing = _compare_int8_pools(t_pages, j_pages)
    print(f"int8 prefill: {differing} int8 values one step apart")

    # decode from the prefilled int8 state: both sides walk the same pages
    start = {n: np.array(a) for n, a in j_pages.items()}
    tokens, seq_lens, tables, active = _decode_inputs()
    seq_lens = np.array([5, 16, 3, 11], np.int32)
    tables = np.array([[3, 0, 0, 0], [5, 6, 8, 0], [10, 0, 0, 0], [1, 9, 0, 0]], np.int32)
    j_decode = jax.jit(partial(jl.decode_step_paged, config=JCFG, use_pallas=False))
    j_pages2, j_logits2 = j_decode(
        jp, {n: jnp.asarray(a) for n, a in start.items()},
        *map(jnp.asarray, (tokens, seq_lens, tables, active)),
    )
    t_start = {n: torch.from_numpy(a.copy()) for n, a in start.items()}
    t_pages2, t_logits2 = tl.decode_step_paged(
        tp, t_start, *map(torch.from_numpy, (tokens, seq_lens, tables, active)), TCFG
    )
    np.testing.assert_allclose(t_logits2.numpy(), np.asarray(j_logits2), **TOL)
    differing = _compare_int8_pools(t_pages2, j_pages2)
    print(f"int8 decode: {differing} int8 values one step apart")
    # active lanes committed a quantized row with its scale; the inactive
    # lane's page is untouched (its write went to the trash page)
    for s in np.flatnonzero(active):
        page, off = tables[s, seq_lens[s] // P], seq_lens[s] % P
        assert not np.array_equal(t_pages2["ks"][:, page, off].numpy(), start["ks"][:, page, off])
    inactive = np.flatnonzero(~active)[0]
    page = tables[inactive, seq_lens[inactive] // P]
    for n in ("k", "v", "ks", "vs"):
        np.testing.assert_array_equal(t_pages2[n][:, page].numpy(), start[n][:, page])


def test_int8_prefill_then_decode_reproduces_int8_forward_closely(params):
    """The int8 slice end to end at the model level: int8 weights and an
    int8 cache, prefill then token-by-token decode, against the dense
    int8-weight forward (which reads unquantized K/V): close, not equal —
    quantizing the cache is the one legitimate difference."""
    _jp, tp = params
    qp = tq.quantize_params(tp)
    seq = np.random.default_rng(3).integers(0, 512, 21).astype(np.int32)
    full = tl.forward(qp, torch.from_numpy(seq[None]), TCFG)[0].numpy()
    plen = 13
    tokens = np.zeros((1, 16), np.int32)
    tokens[0, :plen] = seq[:plen]
    pages = tl.init_paged_cache(TCFG, NUM_PAGES, P, device="cpu", quantize_kv=True)
    table = np.array([[2, 4, 6, 0]], np.int32)
    pages, logits = tl.prefill_paged_batch(
        qp, pages, torch.from_numpy(tokens), torch.tensor([plen]),
        torch.from_numpy(table[:, :2]), TCFG,
    )
    np.testing.assert_allclose(logits[0].numpy(), full[plen - 1], **TOL)  # no cache read yet
    worst = 0.0
    for pos in range(plen, len(seq)):
        pages, logits = tl.decode_step_paged(
            qp, pages, torch.tensor([seq[pos]]), torch.tensor([pos], dtype=torch.int32),
            torch.from_numpy(table), torch.tensor([True]), TCFG,
        )
        worst = max(worst, float(np.abs(logits[0].numpy() - full[pos]).max()))
        assert logits[0].argmax().item() == full[pos].argmax()
    assert 0.0 < worst < 0.05


def test_int8_weight_forward_matches_jax(params):
    jp, _tp = params
    jqp = jax.jit(jq.quantize_params)(jp)
    tqp = params_from_jax(jax.tree_util.tree_map(np.asarray, jqp), TCFG, device="cpu")
    assert isinstance(tqp["layers"]["w2"], tq.QuantizedTensor)
    tokens = np.random.default_rng(1).integers(0, 512, (2, 24)).astype(np.int32)
    ref = np.asarray(jax.jit(partial(jl.forward, config=JCFG))(jqp, jnp.asarray(tokens)))
    ours = tl.forward(tqp, torch.from_numpy(tokens), TCFG).numpy()
    np.testing.assert_allclose(ours, ref, **TOL)
    dense = tl.forward(params[1], torch.from_numpy(tokens), TCFG).numpy()
    assert np.abs(ours - dense).max() > 1e-4  # int8 weights are a different function
