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
