"""The port's ``provider: tpu`` client, its tool-call stream parser and its
forced-call envelope against the JAX package, on the CPU.

- ``ToolStreamParser`` emits the reference's calls (and drops what it
  drops) for seeded chunkings of prose, fenced, tagged, escaped, nested,
  malformed and never-closing text.
- ``forced_call_prefix`` gives the reference's tokens for every tool_choice.
- ``TPUEngineClient``'s two-phase wait mirrors
  ``tests/engine/test_client_timeout.py`` case for case, its errors map to
  503/504/500 as the reference's do, a crashed engine is rebuilt through
  ``ensure_running``, and early tool calls reach the caller densely
  re-indexed past filtered names.
- On the tiny f32 preset, a forced-tool (and a JSON-required)
  ``send_request`` over the port's engine returns the reference client's
  Message over the JAX paged engine.
"""

import asyncio
import dataclasses
import json
import threading
from concurrent.futures import Future

import numpy as np
import pytest

import jax

from agentcontrolplane_tpu.api.resources import BaseConfig as JaxBaseConfig
from agentcontrolplane_tpu.api.resources import Message as JaxMessage
from agentcontrolplane_tpu.engine import toolparse as ref_toolparse
from agentcontrolplane_tpu.engine.client import TPUEngineClient as JaxClient
from agentcontrolplane_tpu.engine.client import forced_call_prefix as ref_forced_call_prefix
from agentcontrolplane_tpu.engine.engine import Engine as JaxEngine
from agentcontrolplane_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from agentcontrolplane_tpu.llmclient.base import Tool as JaxTool
from agentcontrolplane_tpu.llmclient.base import ToolFunction as JaxToolFunction
from agentcontrolplane_tpu.models import llama as jl
from agentcontrolplane_tpu.parallel.mesh import make_mesh
from agentcontrolplane_tpu_torch.engine import toolparse
from agentcontrolplane_tpu_torch.engine.client import TPUEngineClient, forced_call_prefix
from agentcontrolplane_tpu_torch.engine.engine import (
    DeadlineExceededError,
    Engine,
    EngineOverloadedError,
    GenerationResult,
    SamplingParams,
)
from agentcontrolplane_tpu_torch.engine.tokenizer import ByteTokenizer
from agentcontrolplane_tpu_torch.engine.types import BaseConfig, Message, Tool, ToolFunction
from agentcontrolplane_tpu_torch.engine.weights import params_from_jax
from agentcontrolplane_tpu_torch.llmclient.base import LLMRequestError
from agentcontrolplane_tpu_torch.models import llama as tl

JCFG = dataclasses.replace(jl.PRESETS["tiny"], vocab_size=512, max_seq_len=256)
TCFG = dataclasses.replace(tl.PRESETS["tiny"], vocab_size=512, max_seq_len=256)
KW = dict(max_slots=4, max_ctx=128, prefill_buckets=(64, 128), decode_block_size=4, page_size=8)
EOT = 260  # ByteTokenizer's <|eot_id|>, a stop token

# -- the stream parser --------------------------------------------------------

CALL1 = '{"name": "web__fetch", "arguments": {"url": "https://x.test/a"}}'
CALL2 = '{"name": "db__query", "arguments": {"sql": "select \\"1\\" -- \\u00e9"}}'
TEXTS = [
    CALL1,
    f"I'll do two things.\nFirst: {CALL1}\nthen also {CALL2} - done!",
    f"```json\n{CALL2}\n```\nand <|python_tag|>{CALL1}",
    '{"name": "nested", "arguments": {"a": {"b": [1, {"c": "}"}]}, "d": "{"}}',
    '{"name": "s", "arguments": "{\\"k\\": 2}"} {"a": } {"no_name": 1} ' + CALL1,
    '{"name": "never", "arguments": {"x": "' + "y" * 200 + " " + CALL2,
]


def _names_args(calls):
    return [(c.function.name, c.function.arguments) for c in calls]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("text", range(len(TEXTS)))
def test_tool_stream_parser_matches_the_reference(text, seed):
    text = TEXTS[text]
    rng = np.random.default_rng(seed)
    cuts = sorted({0, len(text), *rng.integers(1, len(text), rng.integers(1, 12)).tolist()})
    ours = toolparse.ToolStreamParser(max_object_bytes=128)
    ref = ref_toolparse.ToolStreamParser(max_object_bytes=128)
    for a, b in zip(cuts, cuts[1:]):
        assert _names_args(ours.feed(text[a:b])) == _names_args(ref.feed(text[a:b])), (a, b)
    assert (ours.emitted, ours.dropped) == (ref.emitted, ref.dropped)
    assert _names_args(toolparse.parse_tool_calls(text)) == \
        _names_args(ref_toolparse.parse_tool_calls(text))


@pytest.mark.parametrize("tool_choice", [
    "auto", "required", "none", "", "get_weather", "search", "not_offered", 'we"ird\\name',
])
@pytest.mark.parametrize("names", [(), ("get_weather",), ("get_weather", "search"),
                                   ('we"ird\\name',)], ids=["none", "one", "two", "escaped"])
def test_forced_call_prefix_matches_the_reference(names, tool_choice):
    ours = forced_call_prefix(ByteTokenizer(), [Tool(function=ToolFunction(name=n))
                                                 for n in names], tool_choice)
    ref = ref_forced_call_prefix(JaxByteTokenizer(), [JaxTool(function=JaxToolFunction(name=n))
                                                       for n in names], tool_choice)
    assert ours == ref


# -- the two-phase wait (as tests/engine/test_client_timeout.py) -------------


def make_client(request_timeout_s: float, queue_timeout_s: float) -> TPUEngineClient:
    return TPUEngineClient(
        engine=object(),  # _await_result never touches the engine
        params=BaseConfig(model="stub"),
        request_timeout_s=request_timeout_s,
        queue_timeout_s=queue_timeout_s,
    )


def make_future(admitted: bool | None = False) -> Future:
    """admitted=None -> a future without the attribute."""
    fut: Future = Future()
    if admitted is not None:
        fut.admitted = Future()  # type: ignore[attr-defined]
        if admitted:
            fut.admitted.set_result(True)  # type: ignore[attr-defined]
    return fut


async def test_queue_wait_does_not_consume_generation_budget():
    """Admission arrives after the request timeout would have expired; the
    generation still completes because its clock starts at admission."""
    client = make_client(request_timeout_s=0.4, queue_timeout_s=30.0)
    fut = make_future(admitted=False)

    def engine_side():
        threading.Event().wait(0.6)  # queued for longer than request_timeout_s
        fut.admitted.set_result(True)
        threading.Event().wait(0.2)  # then generates well inside the budget
        fut.set_result("generated")

    t = threading.Thread(target=engine_side, daemon=True)
    t.start()
    assert await client._await_result(fut) == "generated"
    t.join()


async def test_queue_timeout_expires_with_queue_message():
    client = make_client(request_timeout_s=30.0, queue_timeout_s=0.2)
    with pytest.raises(asyncio.TimeoutError, match="queue wait"):
        await client._await_result(make_future(admitted=False))


async def test_generation_timeout_after_admission():
    client = make_client(request_timeout_s=0.2, queue_timeout_s=30.0)
    with pytest.raises(asyncio.TimeoutError, match="after slot admission"):
        await client._await_result(make_future(admitted=True))


async def test_completion_while_queued_short_circuits():
    """Fast failure paths complete the future without ever admitting."""
    client = make_client(request_timeout_s=30.0, queue_timeout_s=30.0)
    fut = make_future(admitted=False)
    threading.Timer(0.1, lambda: fut.set_result("early")).start()
    assert await client._await_result(fut) == "early"


async def test_future_without_admitted_attr_uses_request_timeout():
    client = make_client(request_timeout_s=0.2, queue_timeout_s=30.0)
    with pytest.raises(asyncio.TimeoutError):
        await client._await_result(make_future(admitted=None))


def _tiny_engine(**kw) -> Engine:
    p = jax.tree_util.tree_map(np.array, jl.init_params(JCFG, jax.random.key(0)))
    p["lm_head"][:, EOT] = p["lm_head"][:, 289] * 1.05
    return Engine(TCFG, params_from_jax(p, TCFG, device="cpu"), device="cpu", **{**KW, **kw})


def test_requests_drained_at_stop_fail_instead_of_hanging():
    eng = _tiny_engine(max_slots=2)
    eng.start()
    with eng.hold_admission():  # keep the request in the queue
        fut = eng.submit("hang?", SamplingParams(max_tokens=4))
        eng.stop()
    with pytest.raises(RuntimeError):
        fut.result(timeout=30)
    assert not fut.admitted.done()


# -- errors, crash recovery, early calls -------------------------------------


class _StubEngine:
    """Engine-shaped stand-in: ``outcome`` is an exception for the future or
    a text to finish with after streaming ``calls`` to on_tool_call."""

    tokenizer = ByteTokenizer()

    def __init__(self, outcome, calls=(), running=True):
        self.outcome, self.calls, self.running = outcome, calls, running
        self.cancelled, self.samplings, self.parks, self.traces = [], [], [], []

    def ensure_running(self):
        return self.running

    def submit(self, prompt, sampling, on_tokens=None, timeout_s=None, on_tool_call=None,
               park=False, trace=None):
        self.samplings.append(sampling)
        self.parks.append(park)
        self.traces.append(trace)
        fut = Future()
        fut.admitted = Future()
        if isinstance(self.outcome, BaseException):
            fut.set_exception(self.outcome)
            return fut
        fut.admitted.set_result(True)
        if self.outcome is None:
            return fut  # admitted, never finishes
        for i, call in enumerate(self.calls):
            if on_tool_call is not None:
                on_tool_call(i, toolparse.parse_tool_calls(call)[0])
        fut.set_result(GenerationResult(text=self.outcome, tokens=[], finish_reason="stop",
                                        prompt_tokens=1, ttft_ms=0.0, latency_ms=0.0))
        return fut

    def cancel(self, fut):
        self.cancelled.append(fut)


TOOLS = [Tool(function=ToolFunction(name="get_weather", description="look it up",
                                    parameters={"type": "object",
                                                "properties": {"city": {"type": "string"}}})),
         Tool(function=ToolFunction(name="search", description="search the web"))]
MESSAGES = [Message(role="system", content="You are a helpful agent."),
            Message(role="user", content="weather in Paris?")]


@pytest.mark.parametrize("outcome,status", [
    (EngineOverloadedError("full"), 503),
    (DeadlineExceededError("late"), 504),
    (RuntimeError("engine crashed: boom"), 500),
    ("stopped", 503),
    (None, 504),
], ids=["overloaded", "queue-deadline", "failure", "stopped", "generation-timeout"])
async def test_errors_map_to_the_reference_statuses(outcome, status):
    eng = _StubEngine(None if outcome == "stopped" else outcome, running=outcome != "stopped")
    client = TPUEngineClient(eng, BaseConfig(), request_timeout_s=0.2)
    with pytest.raises(LLMRequestError) as e:
        await client.send_request(MESSAGES, TOOLS)
    assert e.value.status_code == status and not e.value.terminal
    assert len(eng.cancelled) == (1 if outcome is None else 0)  # a timed-out request is freed


async def test_early_tool_calls_are_densely_indexed_past_filtered_names():
    calls = ['{"name": "hallucinated", "arguments": {}}',
             '{"name": "search", "arguments": {"q": "a"}}',
             '{"name": "get_weather", "arguments": {"city": "Paris"}}']
    eng = _StubEngine("\n".join(calls), calls=calls)
    seen = []
    msg = await TPUEngineClient(eng, BaseConfig()).send_request(
        MESSAGES, TOOLS, on_tool_call=lambda i, tc: seen.append((i, tc.function.name)))
    assert seen == [(0, "search"), (1, "get_weather")]  # delivered before the reply
    assert [tc.function.name for tc in msg.tool_calls] == ["search", "get_weather"]
    seen.clear()
    await TPUEngineClient(eng, BaseConfig(), overlap_tool_calls=False).send_request(
        MESSAGES, TOOLS, on_tool_call=lambda i, tc: seen.append(i))
    assert seen == []


async def test_sampling_from_the_llm_params_and_tool_choice():
    eng = _StubEngine("ok")
    cfg = BaseConfig(temperature=0.5, top_k=7, top_p=0.9, max_tokens=33)
    await TPUEngineClient(eng, cfg, tool_choice="search").send_request(MESSAGES, TOOLS)
    await TPUEngineClient(eng, BaseConfig(), force_json_tools=True).send_request(MESSAGES, TOOLS)
    await TPUEngineClient(eng, BaseConfig(), force_json_tools=True).send_request(MESSAGES, [])
    forced, json_tools, no_tools = eng.samplings
    assert (forced.temperature, forced.top_k, forced.top_p, forced.max_tokens) == (0.5, 7, 0.9, 33)
    assert forced.json_only and forced.forced_prefix == forced_call_prefix(
        eng.tokenizer, TOOLS, "search")
    assert json_tools.json_only and not json_tools.forced_prefix
    assert not no_tools.json_only and no_tools.max_tokens == 512


async def test_overlapped_turns_park_their_slot():
    """As the reference's client (engine/client.py:175-178): a turn with
    tools and overlap on parks its slot for the next turn; a turn without
    tools, or with overlap off, does not."""
    eng = _StubEngine("ok")
    await TPUEngineClient(eng, BaseConfig()).send_request(MESSAGES, TOOLS)
    await TPUEngineClient(eng, BaseConfig()).send_request(MESSAGES, [])
    await TPUEngineClient(eng, BaseConfig(), overlap_tool_calls=False).send_request(
        MESSAGES, TOOLS)
    assert eng.parks == [True, False, False]
    assert eng.traces == [None, None, None]  # no span context given, none passed


async def test_crashed_engine_is_rebuilt_by_the_next_request():
    eng = _tiny_engine()
    eng.start()
    client = TPUEngineClient(eng, BaseConfig(max_tokens=6))
    real = eng._prefill_group

    def crash_once(chunk):
        eng._prefill_group = real
        raise RuntimeError("injected")

    eng._prefill_group = crash_once
    try:
        with pytest.raises(LLMRequestError) as e:
            await client.send_request(MESSAGES, [])
        assert e.value.status_code == 500 and "injected" in e.value.message
        msg = await client.send_request(MESSAGES, [])  # ensure_running rebuilt the loop
        assert msg.role == "assistant"
        assert eng.stats()["active_slots"] == 0
    finally:
        eng.stop()


# -- the client over the engines, against the reference ----------------------


@pytest.fixture(scope="module")
def engines():
    p = jax.tree_util.tree_map(np.array, jl.init_params(JCFG, jax.random.key(0)))
    p["lm_head"][:, EOT] = p["lm_head"][:, 289] * 1.05
    jax_engine = JaxEngine(
        config=JCFG, params=jax.tree_util.tree_map(jax.numpy.asarray, p),
        tokenizer=JaxByteTokenizer(), mesh=make_mesh({"tp": 1}, devices=jax.devices()[:1]),
        kv_layout="paged", prefix_cache_entries=0, **KW,
    )
    port = Engine(TCFG, params_from_jax(p, TCFG, device="cpu"), device="cpu", **KW)
    jax_engine.start()
    port.start()
    yield jax_engine, port
    jax_engine.stop()
    port.stop()


@pytest.mark.parametrize("tool_choice,n_tools,force_json", [
    ("search", 2, False), ("required", 1, False), ("required", 2, False), ("auto", 2, True),
], ids=["named", "required-one", "required-two", "force-json"])
async def test_send_request_returns_the_reference_message(engines, tool_choice, n_tools,
                                                          force_json):
    jax_engine, port = engines
    tools = TOOLS[2 - n_tools:] if tool_choice == "required" else TOOLS
    ref_tools = [JaxTool(function=JaxToolFunction(
        name=t.function.name, description=t.function.description,
        parameters=t.function.parameters)) for t in tools]
    ref_msgs = [JaxMessage(role=m.role, content=m.content) for m in MESSAGES]
    kw = dict(tool_choice=tool_choice, force_json_tools=force_json)
    ref = await JaxClient(jax_engine, JaxBaseConfig(model="tiny", max_tokens=24), **kw) \
        .send_request(ref_msgs, ref_tools)
    ours = await TPUEngineClient(port, BaseConfig(model="tiny", max_tokens=24), **kw) \
        .send_request(MESSAGES, tools)
    assert (ours.role, ours.content) == (ref.role, ref.content)
    assert _names_args(ours.tool_calls) == _names_args(ref.tool_calls)
    if tool_choice == "search" or n_tools == 1:  # a forced envelope: always a call
        (call,) = ours.tool_calls
        assert call.function.name == "search"
        json.loads(call.function.arguments)
