"""The torch port's plain ops against the JAX package on the same seeded
numpy inputs: RMSNorm, RoPE (with llama3 scaling), prefill attention, and
sampling (top-k/top-p masks identical, greedy = argmax, temperature draws
compared in distribution because the two random generators differ)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from agentcontrolplane_tpu.ops import attention as jattn
from agentcontrolplane_tpu.ops import sampling as jsamp
from agentcontrolplane_tpu.ops.norms import rms_norm as jax_rms_norm
from agentcontrolplane_tpu.ops.rope import apply_rope as jax_apply_rope
from agentcontrolplane_tpu_torch.ops import attention as tattn
from agentcontrolplane_tpu_torch.ops import sampling as tsamp
from agentcontrolplane_tpu_torch.ops.norms import rms_norm
from agentcontrolplane_tpu_torch.ops.rope import apply_rope

def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    ours = rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy()
    ref = np.asarray(jax_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize(
    "scaling", [None, (8.0, 1.0, 4.0, 8192), (32.0, 1.0, 4.0, 8192)],
    ids=["plain", "llama3.1", "llama3.2"],
)
def test_apply_rope_matches_jax(scaling):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 128)).astype(np.float32)
    pos = np.stack([np.arange(7), np.array([0, 3, 9, 100, 4000, 131071, -1])]).astype(np.int32)
    ours = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0, scaling).numpy()
    ref = np.asarray(jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0, scaling))
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("T", [12, 1024], ids=["dense", "blocked"])
def test_prefill_attention_matches_jax(T):
    rng = np.random.default_rng(0)
    B, H, H_kv, d = 2, 4, 2, 16
    q = rng.standard_normal((B, T, H, d)).astype(np.float32)
    k = rng.standard_normal((B, T, H_kv, d)).astype(np.float32)
    v = rng.standard_normal((B, T, H_kv, d)).astype(np.float32)
    lengths = np.array([T, T - 5])
    pos = np.where(np.arange(T)[None] < lengths[:, None], np.arange(T)[None], -1).astype(np.int32)
    ours = tattn.blocked_causal_attention(*map(torch.from_numpy, (q, k, v, pos))).numpy()
    ref = np.asarray(jattn.blocked_causal_attention(*map(jnp.asarray, (q, k, v, pos))))
    np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=2e-5)
    dense = tattn.causal_attention(*map(torch.from_numpy, (q, k, v, pos))).numpy()
    np.testing.assert_allclose(ours, dense, atol=2e-5, rtol=2e-5)


def _mask_logits():
    """Random rows plus rows built on ties (repeated values, a flat row)."""
    rng = np.random.default_rng(0)
    rows = [rng.standard_normal(64).astype(np.float32) * s for s in (0.5, 2.0, 8.0)]
    tied = np.repeat(rng.standard_normal(8).astype(np.float32), 8)
    rows += [tied, np.zeros(64, np.float32), np.round(rng.standard_normal(64) * 2).astype(np.float32)]
    return np.stack(rows)


@pytest.mark.parametrize("k", [0, 1, 5, 17, 64, 100])
def test_topk_mask_identical_to_jax(k):
    logits = _mask_logits()
    S, V = logits.shape
    kk = np.full(S, k if k > 0 else V, dtype=np.int32)  # top_k=0 keeps all (k=V)
    t_thr = tsamp._topk_threshold(torch.from_numpy(logits), torch.from_numpy(kk)).numpy()
    j_thr = np.asarray(jsamp._topk_threshold(jnp.asarray(logits), jnp.asarray(kk)))
    np.testing.assert_array_equal(logits < t_thr, logits < j_thr)


@pytest.mark.parametrize("top_p", [0.1, 0.5, 0.9, 0.99, 1.0])
def test_topp_mask_identical_to_jax(top_p):
    """Identical masks for top_p < 1. At top_p = 1 the port keeps every
    token above max_p * 2^-32 (the reference's documented behaviour); the
    reference's own mask there also drops tail tokens wherever its f32 sum
    of probabilities rounds up to 1.0 (summation-order noise), so the two
    are held equal on every token with probability >= 1e-3 * max_p."""
    logits = _mask_logits()
    tp = np.full(logits.shape[0], top_p, dtype=np.float32)
    t_thr, t_probs = tsamp._topp_threshold(torch.from_numpy(logits), torch.from_numpy(tp))
    j_thr, j_probs = jsamp._topp_threshold(jnp.asarray(logits), jnp.asarray(tp))
    ours = t_probs.numpy() < t_thr.numpy()
    ref = np.asarray(j_probs) < np.asarray(j_thr)
    if top_p < 1.0:
        np.testing.assert_array_equal(ours, ref)
        return
    probs = t_probs.numpy()
    np.testing.assert_array_equal(t_thr.numpy()[:, 0], probs.max(-1) * 2.0**-32)
    visible = probs >= 1e-3 * probs.max(-1, keepdims=True)
    np.testing.assert_array_equal(ours[visible], ref[visible])


def test_greedy_is_argmax_and_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 300)).astype(np.float32)
    logits[2, 7] = logits[2, 9] = logits[2].max() + 1.0  # tie: first index wins
    S = logits.shape[0]
    temps = np.zeros(S, np.float32)
    top_ks = np.array([0, 3, 0, 10, 0, 1], np.int32)
    top_ps = np.array([1.0, 1.0, 0.5, 0.9, 1.0, 1.0], np.float32)
    gen = torch.Generator().manual_seed(0)
    ours = tsamp.sample(torch.from_numpy(logits), gen, *map(torch.from_numpy, (temps, top_ks, top_ps)))
    ref = jsamp.sample(jnp.asarray(logits), jax.random.key(0), *map(jnp.asarray, (temps, top_ks, top_ps)))
    np.testing.assert_array_equal(ours.numpy(), logits.argmax(-1))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (3, 1.0), (0, 0.8)])
def test_temperature_samples_match_jax_in_distribution(top_k, top_p):
    """Both samplers' empirical distributions over N draws sit within 0.02
    of the analytic distribution of the masked, tempered logits (N = 20000:
    the standard error of each frequency is at most 0.0036)."""
    V, N, temp = 8, 20000, 0.7
    logits = np.array([2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -3.0], np.float32)
    batch = np.broadcast_to(logits, (N, V)).copy()
    args = (np.full(N, temp, np.float32), np.full(N, top_k, np.int32), np.full(N, top_p, np.float32))
    gen = torch.Generator().manual_seed(1)
    ours = tsamp.sample(torch.from_numpy(batch), gen, *map(torch.from_numpy, args)).numpy()
    ref = np.asarray(jsamp.sample(jnp.asarray(batch), jax.random.key(1), *map(jnp.asarray, args)))
    p = np.exp((logits - logits.max()) / temp)
    keep = np.ones(V, bool)
    if top_k:
        keep[top_k:] = False
    if top_p < 1.0:
        base = np.exp(logits - logits.max())
        base /= base.sum()
        keep &= (np.cumsum(base) - base) < top_p
    p = np.where(keep, p, 0.0)
    p /= p.sum()
    for draws in (ours, ref):
        freq = np.bincount(draws, minlength=V) / N
        assert np.all(freq[~keep] == 0)
        np.testing.assert_allclose(freq, p, atol=0.02)


def test_port_presets_copy_the_reference():
    from agentcontrolplane_tpu.models.llama import PRESETS as JP
    from agentcontrolplane_tpu_torch.models.llama import PRESETS as TP

    assert set(TP) == set(JP)
    for name, jc in JP.items():
        tc = dataclasses.asdict(TP[name])
        for key, val in dataclasses.asdict(jc).items():
            if key == "dtype":
                assert str(tc[key]).replace("torch.", "") == jnp.dtype(val).name, name
            else:
                assert tc[key] == val, (name, key)
