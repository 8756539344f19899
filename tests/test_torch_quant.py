"""int8 quantization of the torch port against the JAX package: the KV and
weight quantizers give the same int8 values and the same scales bit for
bit as the reference's compiled (``jax.jit``) quantizers, and
``quantize_np`` as the reference's ``quantize_np`` (both round half to
even; see ``ops/quant.py`` for why compiled and eager JAX differ by one
ulp in some scales), the int8 matmul agrees within 1e-5 in f32,
all-zero rows take the scale floor, and the accuracy gate passes the
reference's pinned thresholds (0.92 top-1, 0.05 MAE) for weights, KV and
both, with the dense baseline self-identical."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from agentcontrolplane_tpu.engine.accuracy import pinned_fixture as jax_pinned_fixture
from agentcontrolplane_tpu.models import llama as jl
from agentcontrolplane_tpu.ops import quant as jq
from agentcontrolplane_tpu_torch.engine.accuracy import (
    accuracy_report,
    check_accuracy_gate,
    pinned_fixture,
    teacher_forced_logits,
)
from agentcontrolplane_tpu_torch.engine.weights import params_from_jax, random_params
from agentcontrolplane_tpu_torch.models import llama as tl
from agentcontrolplane_tpu_torch.ops import quant as tq

# the reference's pinned gate (tests/engine/test_quant_kv.py)
GATE_MIN_TOP1 = 0.92
GATE_MAX_MAE = 0.05


def _rows(shape, seed, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 3.0
    return torch.from_numpy(x).to(dtype), jnp.asarray(x).astype(getattr(jnp, str(dtype)[6:]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_quantize_equals_jax_exactly(dtype):
    t, j = _rows((5, 7, 4, 16), 0, dtype)
    q, s = tq.kv_quantize(t)
    jq_, js = jax.jit(jq.kv_quantize)(j)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and tuple(s.shape) == (5, 7, 4)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = tq.kv_dequantize(q, s, torch.float32).numpy()
    np.testing.assert_array_equal(back, np.asarray(jq.kv_dequantize(jq_, js, jnp.float32)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weight_quantize_and_quantize_np_equal_jax_exactly(dtype):
    t, j = _rows((3, 24, 40), 1, dtype)
    ours = tq.quantize(t)
    ref = jax.jit(jq.quantize)(j)
    np.testing.assert_array_equal(ours.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(ours.scale.numpy(), np.asarray(ref.scale))
    assert tuple(ours.scale.shape) == (3, 1, 40)
    stacked = tq.quantize_stacked(t)  # layer by layer: the same values
    assert torch.equal(stacked.q, ours.q) and torch.equal(stacked.scale, ours.scale)
    q_np, s_np = tq.quantize_np(t.float().numpy())
    jq_np, js_np = jq.quantize_np(np.asarray(j.astype(jnp.float32)))
    np.testing.assert_array_equal(q_np, jq_np)
    np.testing.assert_array_equal(s_np, js_np)
    # the reference's own split: compiled scales multiply by f32(1/127),
    # numpy's divide; they agree within one ulp
    np.testing.assert_array_max_ulp(s_np, ours.scale.numpy(), maxulp=1)


def test_int8_matmul_matches_jax():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((32, 48)).astype(np.float32)  # one layer's [in, out]
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    ref = np.asarray(jax.jit(jq.matmul)(jnp.asarray(x), jax.jit(jq.quantize)(jnp.asarray(w))))
    ours = tq.matmul(torch.from_numpy(x), tq.quantize(torch.from_numpy(w))).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
    dense = tq.matmul(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(dense, x @ w, rtol=1e-5, atol=1e-5)
    deq = tq.dequantize(tq.quantize(torch.from_numpy(w)), torch.float32).numpy()
    ref_deq = jq.dequantize(jax.jit(jq.quantize)(jnp.asarray(w)), jnp.float32)
    np.testing.assert_array_equal(deq, np.asarray(ref_deq))


def test_all_zero_rows_take_the_scale_floor():
    q, s = tq.kv_quantize(torch.zeros(2, 3, 8))
    assert torch.all(s == torch.tensor(tq.SCALE_FLOOR, dtype=torch.float32))
    out = tq.kv_dequantize(q, s, torch.float32)
    assert torch.all(torch.isfinite(out)) and torch.all(out == 0.0)
    w = torch.zeros(4, 6)
    w[:, 1] = 2.0  # one live channel beside all-zero ones
    qt = tq.quantize(w)
    assert float(qt.scale[0, 0]) == np.float32(tq.SCALE_FLOOR)
    assert torch.equal(tq.dequantize(qt, torch.float32), w)


def test_quantize_params_and_params_from_jax_carry_int8_exactly():
    cfg = dataclasses.replace(jl.PRESETS["tiny"], vocab_size=512, max_seq_len=256)
    tcfg = dataclasses.replace(tl.PRESETS["tiny"], vocab_size=512, max_seq_len=256)
    dense = jl.init_params(cfg, jax.random.key(0))
    # the reference's engine quantizes under jit (engine/engine.py)
    jqp = jax.tree_util.tree_map(np.asarray, jax.jit(jq.quantize_params)(dense))
    ours = params_from_jax(jqp, tcfg, device="cpu")
    mine = tq.quantize_params(params_from_jax(jax.tree_util.tree_map(np.asarray, dense), tcfg,
                                              device="cpu"))
    for key in tq.QUANTIZABLE:
        carried = ours["layers"][key]
        assert isinstance(carried, tq.QuantizedTensor)
        assert carried.q.dtype == torch.int8 and carried.scale.dtype == torch.float32
        np.testing.assert_array_equal(carried.q.numpy(), jqp["layers"][key].q)
        np.testing.assert_array_equal(carried.scale.numpy(), jqp["layers"][key].scale)
        assert torch.equal(mine["layers"][key].q, carried.q)
        assert torch.equal(mine["layers"][key].scale, carried.scale)
    # (q, scale) numpy pairs are carried the same way
    pairs = {**jqp, "layers": {k: ((v.q, v.scale) if k in tq.QUANTIZABLE else v)
                               for k, v in jqp["layers"].items()}}
    again = params_from_jax(pairs, tcfg, device="cpu")
    assert torch.equal(again["layers"]["w1"].q, ours["layers"]["w1"].q)
    with pytest.raises(TypeError, match="int8"):
        params_from_jax({**pairs, "layers": {**pairs["layers"], "wq": (
            jqp["layers"]["wq"].q.astype(np.float32), jqp["layers"]["wq"].scale)}}, tcfg,
            device="cpu")


def test_random_params_int8_equals_quantized_bf16_draw():
    cfg = dataclasses.replace(tl.PRESETS["tiny"], dtype=torch.bfloat16)
    dense = random_params(cfg, 5, "cpu")
    quantized = random_params(cfg, 5, "cpu", quantize="int8")
    expect = tq.quantize_params(dense)
    for key, w in quantized["layers"].items():
        if key in tq.QUANTIZABLE:
            assert torch.equal(w.q, expect["layers"][key].q)
            assert torch.equal(w.scale, expect["layers"][key].scale)
        else:
            assert torch.equal(w, dense["layers"][key])
    assert torch.equal(quantized["embed"], dense["embed"])
    with pytest.raises(ValueError, match="unsupported"):
        random_params(cfg, 5, "cpu", quantize="int4")


def test_pinned_fixture_equals_jax():
    for vocab in (256, 512, 128256):
        a = pinned_fixture(vocab)
        np.testing.assert_array_equal(a, jax_pinned_fixture(vocab))
        assert a.shape == (4, 48) and a.dtype == np.int32 and a.min() >= 1 and a.max() < vocab


@pytest.fixture(scope="module")
def tiny_params():
    cfg = jl.PRESETS["tiny"]
    np_params = jax.tree_util.tree_map(np.asarray, jl.init_params(cfg, jax.random.key(0)))
    return params_from_jax(np_params, tl.PRESETS["tiny"], device="cpu")


@pytest.fixture(scope="module")
def tiny_baseline(tiny_params):
    cfg = tl.PRESETS["tiny"]
    return accuracy_report(cfg, tiny_params), teacher_forced_logits(
        tiny_params, cfg, pinned_fixture(cfg.vocab_size))


@pytest.mark.parametrize("qw,qkv", [(True, False), (False, True), (True, True)],
                         ids=["weights", "kv", "both"])
def test_accuracy_gate_passes_pinned_thresholds(tiny_params, tiny_baseline, qw, qkv):
    """The byte-identity-relaxed contract, scored through the port's paged
    serving programs over the reference's pinned fixture."""
    base_report, base_logits = tiny_baseline
    assert base_report["top1_agreement"] == 1.0 and base_report["logit_mae"] == 0.0
    rep = accuracy_report(tl.PRESETS["tiny"], tiny_params, quantize_weights=qw, quantize_kv=qkv,
                          baseline=base_logits)
    assert rep["positions"] == 4 * 48
    assert check_accuracy_gate(rep, GATE_MIN_TOP1, GATE_MAX_MAE) == [], rep
    # the quantized path is a different function: the gate is not vacuous
    assert rep["logit_mae"] > 0.0


def test_accuracy_gate_reports_violations():
    rep = {"top1_agreement": 0.5, "logit_mae": 0.2}
    problems = check_accuracy_gate(rep, GATE_MIN_TOP1, GATE_MAX_MAE)
    assert len(problems) == 2 and "top-1" in problems[0] and "MAE" in problems[1]
