"""The torch engine on the CPU against the JAX package's paged engine, on
the tiny f32 preset with the same weights: greedy token streams must be
byte-identical for a concurrent batch (more requests than slots, a stop
token mid-block and at the first token, max_tokens clipping, and a
truncated prompt that runs into the context edge). Plus the engine's own
contracts: pages recycled, FIFO backpressure when pages run out, cancel,
deadlines, load shedding, the refusal of an illegal forced JSON prefix,
and no silent CPU fallback."""

import dataclasses
import time
from concurrent.futures import CancelledError

import numpy as np
import pytest
import torch

import jax

from agentcontrolplane_tpu.engine.engine import Engine as JaxEngine
from agentcontrolplane_tpu.engine.engine import SamplingParams as JaxSampling
from agentcontrolplane_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from agentcontrolplane_tpu.models import llama as jl
from agentcontrolplane_tpu.parallel.mesh import make_mesh
from agentcontrolplane_tpu_torch.engine.engine import (
    DeadlineExceededError,
    Engine,
    EngineOverloadedError,
    SamplingParams,
)
from agentcontrolplane_tpu_torch.engine.weights import params_from_jax
from agentcontrolplane_tpu_torch.models import llama as tl

JCFG = dataclasses.replace(jl.PRESETS["tiny"], vocab_size=512, max_seq_len=256)
TCFG = dataclasses.replace(tl.PRESETS["tiny"], vocab_size=512, max_seq_len=256)
KW = dict(max_slots=4, max_ctx=64, prefill_buckets=(32, 64), decode_block_size=4, page_size=8)
EOT = 260  # ByteTokenizer's <|eot_id|>, a stop token
# (prompt, max_tokens); with the weights below "json" stops mid-decode,
# "cat" stops at its first token, "qq" at its second, the long prompt is
# tail-truncated and runs into the context edge, the rest are clipped
BATCH = [
    ("json", 30), ("cat", 10), ("hello", 7), ("w" * 50, 40),
    ("qq", 12), ("tool time", 20),
]


def _weights() -> dict:
    """Seeded random weights, with the stop token's lm_head column a scaled
    copy of a frequently chosen token's, so greedy streams do stop."""
    p = jax.tree_util.tree_map(np.array, jl.init_params(JCFG, jax.random.key(0)))
    p["lm_head"][:, EOT] = p["lm_head"][:, 289] * 1.05
    return p


@pytest.fixture(scope="module")
def engines():
    weights = _weights()
    jax_engine = JaxEngine(
        config=JCFG, params=jax.tree_util.tree_map(jax.numpy.asarray, weights),
        tokenizer=JaxByteTokenizer(), mesh=make_mesh({"tp": 1}, devices=jax.devices()[:1]),
        kv_layout="paged", prefix_cache_entries=0, **KW,
    )
    port = Engine(TCFG, params_from_jax(weights, TCFG, device="cpu"), device="cpu", **KW)
    jax_engine.start()
    port.start()
    yield jax_engine, port
    jax_engine.stop()
    port.stop()


def test_greedy_streams_byte_identical_to_jax_engine(engines):
    jax_engine, port = engines
    jf = [jax_engine.submit(p, JaxSampling(max_tokens=m)) for p, m in BATCH]
    tf = [port.submit(p, SamplingParams(max_tokens=m)) for p, m in BATCH]
    ref = [f.result(timeout=300) for f in jf]
    ours = [f.result(timeout=300) for f in tf]
    for (prompt, _), r, o in zip(BATCH, ref, ours):
        assert o.tokens == r.tokens, prompt
        assert o.text == r.text and o.finish_reason == r.finish_reason, prompt
        assert o.prompt_tokens == r.prompt_tokens, prompt
    reasons = [o.finish_reason for o in ours]
    assert "stop" in reasons and "length" in reasons
    assert any(o.finish_reason == "stop" and not o.tokens for o in ours)  # first-token stop
    truncated = ours[3]  # 50-token prompt keeps its 32-token tail
    assert truncated.prompt_tokens == 32
    assert truncated.finish_reason == "length"
    assert truncated.prompt_tokens + len(truncated.tokens) == KW["max_ctx"]


def test_pages_recycled_after_completion(engines):
    _, port = engines
    free0 = port.stats()["kv_pages"]["free"]
    futs = [port.submit(f"req {i}", SamplingParams(max_tokens=5)) for i in range(8)]
    for f in futs:
        assert f.result(timeout=120).finish_reason in ("stop", "length")
    assert port.stats()["kv_pages"]["free"] == free0 == port.num_pages - 1
    assert port.stats()["active_slots"] == 0


def test_backpressure_when_pages_run_out():
    """9 usable pages of 8 tokens: each request reserves the 3 pages of its
    20-token prompt at admission, so at most three run at once and the
    rest wait at the head of the queue; growing to 32 rows (4 pages) each,
    the three overrun the pool, and a preempted one resumes later. All six
    complete with the same stream, and every page returns. Dedup is off:
    with it the six identical prompts would share their first two pages."""
    weights = _weights()
    eng = Engine(TCFG, params_from_jax(weights, TCFG, device="cpu"), device="cpu",
                 kv_pages=10, prefix_dedup=False, **KW)
    eng.start()
    try:
        with eng.hold_admission():
            futs = [eng.submit("w" * 20, SamplingParams(max_tokens=12)) for _ in range(6)]
            time.sleep(0.05)
        seen_waiting = 0
        while not all(f.done() for f in futs):
            s = eng.stats()
            assert s["active_slots"] <= 3
            seen_waiting = max(seen_waiting, s["waiting"])
            time.sleep(0.001)
        results = [f.result(timeout=120) for f in futs]
        assert all(r.finish_reason in ("stop", "length") for r in results)
        assert len({tuple(r.tokens) for r in results}) == 1  # same prompt, same stream
        assert sum(r.preempt_count for r in results) >= 1
        assert eng.stats()["kv_pages"]["free"] == 9
    finally:
        eng.stop()


def test_cancel_frees_slot_and_pages(engines):
    _, port = engines
    with port.hold_admission():
        queued = port.submit("never runs", SamplingParams(max_tokens=5))
        port.cancel(queued)
    with pytest.raises(CancelledError):
        queued.result(timeout=60)
    fut = port.submit("z", SamplingParams(max_tokens=50))
    while port.stats()["active_slots"] == 0 and not fut.done():
        time.sleep(0.0005)
    port.cancel(fut)
    # normally "cancelled"; a tiny model on a fast host may finish first
    r = fut.result(timeout=60)
    assert r.finish_reason in ("cancelled", "length", "stop")
    assert port.stats()["kv_pages"]["free"] == port.num_pages - 1


def test_deadline_and_queue_shedding():
    eng = Engine(TCFG, params_from_jax(_weights(), TCFG, device="cpu"), device="cpu",
                 max_queue=2, **KW)
    eng.start()
    try:
        with eng.hold_admission():
            late = eng.submit("a", SamplingParams(max_tokens=3), timeout_s=0.01)
            ok = eng.submit("b", SamplingParams(max_tokens=3))
            shed = eng.submit("c", SamplingParams(max_tokens=3))
            with pytest.raises(EngineOverloadedError):
                shed.result(timeout=5)
            time.sleep(0.1)
        with pytest.raises(DeadlineExceededError):
            late.result(timeout=60)
        assert ok.result(timeout=60).finish_reason in ("stop", "length")
        assert eng.stats()["sheds"] == 1
    finally:
        eng.stop()


def test_constrained_requests_are_rejected(engines):
    """The refusal the reference keeps: a json_only request whose forced
    prefix is not a legal JSON prefix fails at admission with "not a legal
    JSON prefix", as the JAX engine's does; the engine serves on."""
    jax_engine, port = engines
    bad = tuple(port.tokenizer.encode('{"name": }'))
    with pytest.raises(RuntimeError, match="not a legal JSON prefix"):
        jax_engine.submit("x", JaxSampling(json_only=True, forced_prefix=bad)).result(timeout=120)
    with pytest.raises(RuntimeError, match="not a legal JSON prefix"):
        port.submit("x", SamplingParams(json_only=True, forced_prefix=bad)).result(timeout=120)
    assert port.generate("x", SamplingParams(max_tokens=3)).finish_reason in ("stop", "length")
    assert port.stats()["active_slots"] == 0


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(TCFG, params={})
    from agentcontrolplane_tpu_torch.server.rest import serve

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve("tiny", port=0)


# -- int8 serving ------------------------------------------------------------


@pytest.fixture(scope="module")
def int8_engines():
    weights = _weights()
    jax_engine = JaxEngine(
        config=JCFG, params=jax.tree_util.tree_map(jax.numpy.asarray, weights),
        tokenizer=JaxByteTokenizer(), mesh=make_mesh({"tp": 1}, devices=jax.devices()[:1]),
        kv_layout="paged", prefix_cache_entries=0, quantize_kv=True, quantize_weights=True,
        **KW,
    )
    port = Engine(TCFG, params_from_jax(weights, TCFG, device="cpu"), device="cpu",
                  quantize_kv=True, quantize_weights=True, **KW)
    jax_engine.start()
    port.start()
    yield jax_engine, port
    jax_engine.stop()
    port.stop()


def test_int8_greedy_streams_byte_identical_to_jax_engine(int8_engines, engines):
    """int8 weights and an int8 KV cache on both sides: the streams equal
    the reference's int8 engine byte for byte, and (the legitimate break)
    differ from the unquantized streams somewhere."""
    jax_engine, port = int8_engines
    jf = [jax_engine.submit(p, JaxSampling(max_tokens=m)) for p, m in BATCH]
    tf = [port.submit(p, SamplingParams(max_tokens=m)) for p, m in BATCH]
    ref = [f.result(timeout=300) for f in jf]
    ours = [f.result(timeout=300) for f in tf]
    for (prompt, _), r, o in zip(BATCH, ref, ours):
        assert o.tokens == r.tokens, prompt
        assert o.text == r.text and o.finish_reason == r.finish_reason, prompt
    _, dense_port = engines
    dense = [dense_port.submit(p, SamplingParams(max_tokens=m)).result(timeout=300)
             for p, m in BATCH]
    assert [d.tokens for d in dense] != [o.tokens for o in ours]
    assert port.stats()["kv_pages"]["free"] == port.num_pages - 1


def test_int8_stats_and_storage(int8_engines, engines):
    jax_engine, port = int8_engines
    _, dense = engines
    s, js = port.stats(), jax_engine.stats()
    for key in ("quantize", "quantize_kv"):
        assert s["model"][key] == js["model"][key]
    assert s["model"]["quantize"] == "int8" and s["model"]["quantize_kv"] is True
    assert s["memory"]["quantized_kv"] == {"enabled": True, "pages": 0}
    assert set(port.cache) == {"k", "v", "ks", "vs"} and port.cache["k"].dtype == torch.int8
    # weight bytes count int8 values plus f32 scales, as the reference does
    assert s["model"]["weight_bytes"] == js["model"]["weight_bytes"]
    assert s["model"]["weight_bytes"] < dense.stats()["model"]["weight_bytes"]
    # both knobs off: no scale storage and the unquantized stats
    d = dense.stats()
    assert set(dense.cache) == {"k", "v"} and dense.cache["k"].dtype == torch.float32
    assert d["model"]["quantize"] is None and d["model"]["quantize_kv"] is False
    assert d["memory"]["quantized_kv"] == {"enabled": False, "pages": 0}


def test_quantized_pages_counted_while_serving(int8_engines):
    _, port = int8_engines
    with port.hold_admission():
        fut = port.submit("w" * 20, SamplingParams(max_tokens=30))
    while port.stats()["active_slots"] == 0 and not fut.done():
        time.sleep(0.0005)
    pages = port.stats()["memory"]["quantized_kv"]["pages"]
    fut.result(timeout=120)
    # pages of 8: the 20-token row's 3 at admission, then at the first page
    # crossing a lookahead window (8 blocks of 4) to 7 (0: finished first)
    assert pages in (0, 3, 7)
    assert port.stats()["memory"]["quantized_kv"]["pages"] == 0


def test_quantize_knob_validation():
    with pytest.raises(ValueError, match="unsupported quantization"):
        Engine(TCFG, params_from_jax(_weights(), TCFG, device="cpu"), device="cpu",
               quantize="int4", **KW)
    eng = Engine(TCFG, params_from_jax(_weights(), TCFG, device="cpu"), device="cpu",
                 quantize="int8", **KW)
    assert eng.quantize == "int8" and not eng.quantize_kv
    assert set(eng.cache) == {"k", "v"}
