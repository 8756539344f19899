"""The slot KV layout's model programs on the CPU: the port against the JAX
package on the tiny f32 preset with the same weights.

- ``ops/attention.py::decode_attention_cache_plus_new`` (the slot decode
  attention: every slot's rows in f32, masked at seq_len, plus the new
  token's self term) against the reference's.
- ``prefill_batch``, ``prefill``, ``prefill_continue``,
  ``prefill_continue_kv``, ``verify_continue`` and ``decode_step``: the
  logits and the cache rows each writes, with and without ``quantize_kv``.
  Logits, f32 rows and f32 scale rows within rtol/atol 2e-4 (the bar of
  ``tests/test_torch_model.py``); int8 values within one quantization step
  in at most 0.2% of the entries (a value that lands on a half rounds
  either way when its f32 input differs in the last bits, as in
  ``tests/test_torch_chunked.py``). The rows compared are each slot's
  real rows: bucket-padding positions carry garbage K/V that is never
  read, and row ``C - 1`` takes padding's clamped writes in unspecified
  order.
- The continuations' ``prefix_rows``, passed from the engine's host lane
  arrays, write and return exactly what they do without it.
- The ``active`` clamp, deterministically: a mid-prefill slot below the
  dispatch width keeps its prompt rows through a decode step, and its
  lane's write lands at row ``C - 1`` as the reference's ``decode_step``
  puts it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from agentcontrolplane_tpu.models import llama as jl
from agentcontrolplane_tpu.ops import attention as ja
from agentcontrolplane_tpu_torch.engine.engine import _live_start
from agentcontrolplane_tpu_torch.engine.weights import params_from_jax
from agentcontrolplane_tpu_torch.models import llama as tl
from agentcontrolplane_tpu_torch.ops import attention as ta

JCFG = dataclasses.replace(jl.PRESETS["tiny"], vocab_size=512, max_seq_len=256)
TCFG = dataclasses.replace(tl.PRESETS["tiny"], vocab_size=512, max_seq_len=256)
S, C = 4, 64  # slots, max_ctx
TOL = dict(rtol=2e-4, atol=2e-4)
QUANT = pytest.mark.parametrize("quantize_kv", [False, True], ids=["f32", "int8-kv"])


@pytest.fixture(scope="module")
def params():
    tree = jax.tree_util.tree_map(np.asarray, jl.init_params(JCFG, jax.random.key(0)))
    return jax.tree_util.tree_map(jnp.asarray, tree), params_from_jax(tree, TCFG, device="cpu")


def _jit(fn):
    """The reference's program compiled, as its engine runs it (the
    compiled int8 quantizer multiplies by f32(1/127), as the port's does)."""
    return jax.jit(fn, static_argnames=("config",))


def _to_torch(cache: dict) -> dict:
    return {n: torch.from_numpy(np.array(a)) for n, a in cache.items()}


def _rows_close(got: np.ndarray, want: np.ndarray, name: str, what: str) -> None:
    if got.dtype == np.int8:
        steps = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert steps.max() <= 1 and (steps > 0).mean() <= 2e-3, (what, name, steps.max(),
                                                                  int((steps > 0).sum()))
        return
    np.testing.assert_allclose(got, want, **TOL, err_msg=f"{what}: {name}")


def _caches_close(ours: dict, ref: dict, what: str, valid: dict | None = None) -> None:
    """Every slot's rows (untouched rows are zeros or the shared start on
    both sides). ``valid`` maps a slot to its real rows: the rows past them
    hold the K/V of bucket-padding positions, whose queries attend nothing
    and so carry a different garbage through the port's online softmax
    than through the reference's dense one. They are never read (attention
    masks at seq_len), so they are left out, and so is row C-1 (clamped
    padding writes land there in unspecified order)."""
    valid = valid or {}
    for name, a in ref.items():
        want, got = np.asarray(a), ours[name].numpy()
        for s in range(S):
            n = valid.get(s, C - 1)
            _rows_close(got[:, s, :n], want[:, s, :n], name, f"{what} slot {s}")


def _prefilled(jp, quantize_kv: bool):
    """Slots 0, 2 and 3 prefilled with rows of 24, 16 and 20 tokens by the
    reference (slot 1 empty): the state the continuations start from."""
    rng = np.random.default_rng(3)
    lengths = np.array([24, 16, 20], np.int32)
    tokens = rng.integers(0, 512, (3, 32)).astype(np.int32)
    slots = np.array([0, 2, 3], np.int32)
    cache, _ = _jit(jl.prefill_batch)(
        jp, jl.init_kv_cache(JCFG, S, C, quantize_kv=quantize_kv), jnp.asarray(tokens),
        jnp.asarray(lengths), jnp.asarray(slots), config=JCFG)
    return cache, lengths, slots


def test_decode_attention_cache_plus_new_matches_jax():
    rng = np.random.default_rng(0)
    H, H_kv, d = 8, 2, 16

    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    q, k_cache, v_cache = randn(5, H, d), randn(5, C, H_kv, d), randn(5, C, H_kv, d)
    k_new, v_new = randn(5, H_kv, d), randn(5, H_kv, d)
    seq_lens = np.array([0, 1, 17, C - 1, C], np.int32)
    want = ja.decode_attention_cache_plus_new(*map(jnp.asarray, (q, k_cache, v_cache, k_new,
                                                                 v_new, seq_lens)))
    got = ta.decode_attention_cache_plus_new(*map(torch.from_numpy, (q, k_cache, v_cache, k_new,
                                                                     v_new, seq_lens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # seq_len 0 attends the new token alone
    np.testing.assert_allclose(got[0].reshape(H_kv, H // H_kv, d).numpy(),
                               np.broadcast_to(v_new[0][:, None], (H_kv, H // H_kv, d)), **TOL)


def test_init_kv_cache_layout():
    dense = tl.init_kv_cache(TCFG, S, C, device="cpu")
    assert set(dense) == {"k", "v"}
    assert dense["k"].shape == (TCFG.n_layers, S, C, TCFG.n_kv_heads, TCFG.head_dim)
    assert dense["k"].dtype == TCFG.dtype
    q = tl.init_kv_cache(TCFG, S, C, device="cpu", quantize_kv=True)
    ref = jl.init_kv_cache(JCFG, S, C, quantize_kv=True)
    assert {n: (tuple(a.shape), str(a.dtype).replace("torch.", "")) for n, a in q.items()} == {
        n: (tuple(a.shape), str(a.dtype)) for n, a in ref.items()}


@QUANT
def test_prefill_batch_matches_jax(params, quantize_kv):
    jp, tp = params
    rng = np.random.default_rng(1)
    lengths = np.array([5, 16, 11], np.int32)
    tokens = rng.integers(0, 512, (3, 16)).astype(np.int32)
    slots = np.array([2, 0, 3], np.int32)
    ref_cache, ref_logits = _jit(jl.prefill_batch)(
        jp, jl.init_kv_cache(JCFG, S, C, quantize_kv=quantize_kv), jnp.asarray(tokens),
        jnp.asarray(lengths), jnp.asarray(slots), config=JCFG)
    cache = tl.init_kv_cache(TCFG, S, C, device="cpu", quantize_kv=quantize_kv)
    cache, logits = tl.prefill_batch(tp, cache, *map(torch.from_numpy, (tokens, lengths, slots)),
                                     TCFG)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    _caches_close(cache, ref_cache, "prefill_batch")
    for a in cache.values():  # slot 1 was no row's target
        assert not a[:, 1].any()


def test_prefill_is_the_single_row_view(params):
    jp, tp = params
    tokens = np.random.default_rng(2).integers(0, 512, 16).astype(np.int32)
    ref_cache, ref_logits = _jit(jl.prefill)(
        jp, jl.init_kv_cache(JCFG, S, C), jnp.asarray(tokens), jnp.int32(9), jnp.int32(1),
        config=JCFG)
    cache, logits = tl.prefill(tp, tl.init_kv_cache(TCFG, S, C, device="cpu"),
                               torch.from_numpy(tokens), torch.tensor(9), torch.tensor(1), TCFG)
    assert logits.shape == (TCFG.vocab_size,)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    _caches_close(cache, ref_cache, "prefill")


def _ends(slots, starts, lengths) -> dict:
    """Each written slot's real rows: its start plus its lane's tokens."""
    return {int(s): int(st) + int(n) for s, st, n in zip(slots, starts, lengths) if st < C}


def _suffix_lanes():
    """Suffixes of 8, 12 and 6 tokens after 24, 16 and 20 written rows."""
    rng = np.random.default_rng(4)
    tokens = np.zeros((3, 16), np.int32)
    lengths = np.array([8, 12, 6], np.int32)
    for b, n in enumerate(lengths):
        tokens[b, :n] = rng.integers(0, 512, n)
    return tokens, lengths


@QUANT
def test_prefill_continue_matches_jax(params, quantize_kv):
    jp, tp = params
    cache, starts, slots = _prefilled(jp, quantize_kv)
    tokens, lengths = _suffix_lanes()
    ours = _to_torch(cache)
    ref_cache, ref_logits = _jit(jl.prefill_continue)(
        jp, cache, jnp.asarray(tokens), jnp.asarray(lengths), jnp.asarray(starts),
        jnp.asarray(slots), config=JCFG)
    ours, logits = tl.prefill_continue(tp, ours, *map(torch.from_numpy,
                                                      (tokens, lengths, starts, slots)), TCFG)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    _caches_close(ours, ref_cache, "prefill_continue", _ends(slots, starts, lengths))


@QUANT
def test_prefill_continue_kv_matches_jax_with_a_padding_lane(params, quantize_kv):
    """Three chunk lanes and a padding lane (length 0, start max_ctx, slot
    0, as the megastep pads): the chunk rows are the reference's, and the
    padding lane writes only the never-read row C-1."""
    jp, tp = params
    cache, starts, slots = _prefilled(jp, quantize_kv)
    tokens, lengths = _suffix_lanes()
    tokens = np.concatenate([tokens, np.zeros((1, 16), np.int32)])
    lengths = np.append(lengths, 0).astype(np.int32)
    starts = np.append(starts, C).astype(np.int32)
    slots = np.append(slots, 0).astype(np.int32)
    ours = _to_torch(cache)
    ref_cache = _jit(jl.prefill_continue_kv)(
        jp, cache, jnp.asarray(tokens), jnp.asarray(lengths), jnp.asarray(starts),
        jnp.asarray(slots), config=JCFG)
    ours = tl.prefill_continue_kv(tp, ours, *map(torch.from_numpy,
                                                 (tokens, lengths, starts, slots)), TCFG)
    _caches_close(ours, ref_cache, "prefill_continue_kv", _ends(slots[:3], starts, lengths))


@QUANT
def test_verify_continue_matches_jax(params, quantize_kv):
    """Lane b is slot b: lanes 0, 2 and 3 verify a last token plus a draft
    at their seq_len, idle lane 1 (length 0, start max_ctx) writes only row
    C-1. The logits of every real position and the rows are the
    reference's."""
    jp, tp = params
    cache, written, _slots = _prefilled(jp, quantize_kv)
    rng = np.random.default_rng(5)
    T = 5
    tokens = rng.integers(0, 512, (S, T)).astype(np.int32)
    lengths = np.array([5, 0, 3, 1], np.int32)
    starts = np.array([written[0], C, written[1], written[2]], np.int32)
    ours = _to_torch(cache)
    ref_cache, ref_logits = _jit(jl.verify_continue)(
        jp, cache, *map(jnp.asarray, (tokens, lengths, starts)), config=JCFG)
    ours, logits = tl.verify_continue(tp, ours, *map(torch.from_numpy, (tokens, lengths, starts)),
                                      TCFG)
    assert logits.shape == (S, T, TCFG.vocab_size)
    for b in range(S):
        np.testing.assert_allclose(logits[b, : lengths[b]].numpy(),
                                   np.asarray(ref_logits)[b, : lengths[b]], **TOL)
    _caches_close(ours, ref_cache, "verify_continue", _ends(np.arange(S), starts, lengths))


@pytest.mark.parametrize("fn", ["prefill_continue", "prefill_continue_kv", "verify_continue"])
def test_host_prefix_rows_change_nothing(params, fn):
    """The engine passes each continuation the live lanes' largest start
    from its host lane arrays (``prefix_rows``, by ``_live_start``), so the
    dispatch reads nothing back from the device: the rows written and the
    logits equal the form that reads the start from the device, with a
    padding lane (length 0, start max_ctx) beside three real ones."""
    jp, tp = params
    cache, written, slots = _prefilled(jp, False)
    tokens, lengths = _suffix_lanes()
    tokens = np.concatenate([tokens, np.zeros((1, 16), np.int32)])
    lengths = np.append(lengths, 0).astype(np.int32)
    starts = np.append(written, C).astype(np.int32)
    args = [tokens, lengths, starts]
    if fn != "verify_continue":
        args.append(np.append(slots, 0).astype(np.int32))
    rows = _live_start(lengths, starts)
    assert rows == int(written.max())
    outs = []
    for kw in ({}, {"prefix_rows": rows}):
        out = getattr(tl, fn)(tp, _to_torch(cache), *map(torch.from_numpy, args), TCFG, **kw)
        outs.append(out if isinstance(out, tuple) else (out,))
    for name in outs[0][0]:
        assert torch.equal(outs[0][0][name], outs[1][0][name]), (fn, name)
    if fn != "prefill_continue_kv":
        assert torch.equal(outs[0][1], outs[1][1]), fn


def _decode_lanes():
    tokens = np.array([17, 400, 9, 256], np.int32)
    seq_lens = np.array([24, 0, 16, 20], np.int32)
    active = np.array([True, False, True, True])
    return tokens, seq_lens, active


@QUANT
def test_decode_step_matches_jax(params, quantize_kv):
    jp, tp = params
    cache, _, _ = _prefilled(jp, quantize_kv)
    tokens, seq_lens, active = _decode_lanes()
    ours = _to_torch(cache)
    ref_cache, ref_logits = _jit(jl.decode_step)(
        jp, cache, *map(jnp.asarray, (tokens, seq_lens)), config=JCFG,
        active=jnp.asarray(active))
    ours, logits = tl.decode_step(tp, ours, *map(torch.from_numpy, (tokens, seq_lens)), TCFG,
                                  active=torch.from_numpy(active))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    _caches_close(ours, ref_cache, "decode_step")


def test_decode_step_at_a_narrower_width_leaves_the_rest_untouched(params):
    jp, tp = params
    cache, _, _ = _prefilled(jp, False)
    ours = _to_torch(cache)
    before = {n: a.clone() for n, a in ours.items()}
    tokens, seq_lens = np.array([3, 5], np.int32), np.array([24, 0], np.int32)
    ref_cache, ref_logits = _jit(jl.decode_step)(jp, cache, jnp.asarray(tokens),
                                                  jnp.asarray(seq_lens), config=JCFG)
    ours, logits = tl.decode_step(tp, ours, torch.from_numpy(tokens),
                                  torch.from_numpy(seq_lens), TCFG)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    _caches_close(ours, ref_cache, "decode_step W=2")
    for n, a in ours.items():
        assert torch.equal(a[:, 2:], before[n][:, 2:])


@pytest.mark.parametrize("quantize_kv", [False, True], ids=["f32", "int8-kv"])
def test_active_clamp_keeps_a_mid_prefill_slots_prompt_rows(params, quantize_kv):
    """Slot 1 is mid-prefill below the dispatch width: 24 prompt rows
    written, its uploaded seq_len stale at 8 inside them, its lane
    inactive. With ``active`` its rows [0, 24) come through a decode step
    bit for bit and the lane's write lands at row C-1, where the reference
    puts it; without ``active`` (the unclamped form) both write row 8."""
    jp, tp = params
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, 512, (2, 32)).astype(np.int32)
    cache, _ = _jit(jl.prefill_batch)(
        jp, jl.init_kv_cache(JCFG, S, C, quantize_kv=quantize_kv), jnp.asarray(tokens),
        jnp.asarray(np.array([20, 24], np.int32)), jnp.asarray(np.array([0, 1], np.int32)),
        config=JCFG)
    start = _to_torch(cache)
    dec_tokens = np.array([11, 12], np.int32)
    seq_lens = np.array([20, 8], np.int32)
    active = np.array([True, False])
    ref_cache, _ = _jit(jl.decode_step)(jp, cache, jnp.asarray(dec_tokens),
                                         jnp.asarray(seq_lens), config=JCFG,
                                         active=jnp.asarray(active))
    ours, _ = tl.decode_step(tp, {n: a.clone() for n, a in start.items()},
                             torch.from_numpy(dec_tokens), torch.from_numpy(seq_lens), TCFG,
                             active=torch.from_numpy(active))
    for n, a in ours.items():
        assert torch.equal(a[:, 1, :24], start[n][:, 1, :24]), n  # the prompt rows survive
        assert not torch.equal(a[:, 1, C - 1], start[n][:, 1, C - 1]), n  # the write landed
        want = np.asarray(ref_cache[n])
        _rows_close(a[:, 1, C - 1].numpy(), want[:, 1, C - 1], n, "clamped row")
        np.testing.assert_array_equal(want[:, 1, :24], start[n][:, 1, :24].numpy())
    # the unclamped form overwrites prompt row 8 on both sides
    ref_open, _ = _jit(jl.decode_step)(jp, jax.tree_util.tree_map(jnp.asarray, {
        n: a.numpy() for n, a in start.items()}), jnp.asarray(dec_tokens),
        jnp.asarray(seq_lens), config=JCFG)
    open_, _ = tl.decode_step(tp, {n: a.clone() for n, a in start.items()},
                              torch.from_numpy(dec_tokens), torch.from_numpy(seq_lens), TCFG)
    for n, a in open_.items():
        assert not torch.equal(a[:, 1, 8], start[n][:, 1, 8]), n
        _rows_close(a[:, 1, 8].numpy(), np.asarray(ref_open[n])[:, 1, 8], n, "unclamped row")
