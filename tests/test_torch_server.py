"""The torch port's stdlib HTTP front door on a CPU engine: OpenAI-shaped
chat completions with usage counts, 400s on malformed and constrained
requests, health and engine-stats endpoints, and a tool-call completion
parsed by the ported toolparse."""

import dataclasses
import json
import urllib.error
import urllib.request
from concurrent.futures import Future

import pytest

from agentcontrolplane_tpu_torch.engine.engine import Engine, GenerationResult
from agentcontrolplane_tpu_torch.engine.weights import random_params
from agentcontrolplane_tpu_torch.models import llama as tl
from agentcontrolplane_tpu_torch.server.rest import make_server, serve_in_thread

CFG = dataclasses.replace(tl.PRESETS["tiny"], vocab_size=512, max_seq_len=512)


def _serve(engine):
    server = make_server(engine, "127.0.0.1", 0)
    serve_in_thread(server)
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _call(base, path, body=None, raw=None):
    data = raw if raw is not None else (json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(base + path, data=data, method="POST" if data else "GET")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def live():
    eng = Engine(CFG, random_params(CFG, 0, "cpu"), device="cpu", max_slots=4,
                 max_ctx=512, prefill_buckets=(128, 256, 512), decode_block_size=4, page_size=16)
    eng.start()
    server, base = _serve(eng)
    yield eng, base
    server.shutdown()
    server.server_close()
    eng.stop()


def test_chat_completion_is_openai_shaped(live):
    _eng, base = live
    status, doc = _call(base, "/v1/chat/completions", {
        "model": "llama", "max_tokens": 9,
        "messages": [{"role": "system", "content": "be brief"},
                     {"role": "user", "content": "hello"}],
    })
    assert status == 200
    assert doc["object"] == "chat.completion" and doc["model"] == "llama"
    choice = doc["choices"][0]
    assert choice["message"]["role"] == "assistant"
    assert choice["finish_reason"] in ("stop", "length", "tool_calls")
    usage = doc["usage"]
    assert 1 <= usage["completion_tokens"] + (choice["finish_reason"] == "stop") <= 10
    assert usage["prompt_tokens"] > 0
    assert usage["total_tokens"] == usage["prompt_tokens"] + usage["completion_tokens"]


def test_health_and_engine_stats(live):
    eng, base = live
    assert _call(base, "/healthz") == (200, {"ok": True})
    status, stats = _call(base, "/v1/engine")
    assert status == 200 and stats["kv_layout"] == "paged" and stats["device"] == "cpu"
    assert stats["max_slots"] == eng.max_slots
    assert _call(base, "/nope")[0] == 404


@pytest.mark.parametrize("body,raw,match", [
    (None, b"{not json", "invalid request"),
    ({"messages": "x"}, None, "invalid request"),
    ({}, None, "invalid request"),
    ({"messages": [{"role": "wizard", "content": "hi"}]}, None, "invalid request"),
    ({"messages": [{"role": "user", "content": "hi"}],
      "response_format": {"type": "json_object"}}, None, "not yet supported"),
    ({"messages": [{"role": "user", "content": "hi"}], "tool_choice": "required",
      "tools": [{"function": {"name": "f"}}]}, None, "not yet supported"),
])
def test_malformed_and_constrained_requests_are_400(live, body, raw, match):
    _eng, base = live
    status, doc = _call(base, "/v1/chat/completions", body, raw=raw)
    assert status == 400 and match in doc["error"]


class _ScriptedEngine:
    """Engine-shaped stand-in whose generation text is fixed, to drive the
    tool-call parse path deterministically."""

    def __init__(self, text):
        self.text = text
        self.prompts = []

    def ensure_running(self):
        return True

    def submit(self, prompt, sampling, timeout_s=None):
        self.prompts.append(prompt)
        fut = Future()
        fut.set_result(GenerationResult(
            text=self.text, tokens=list(range(len(self.text))), finish_reason="stop",
            prompt_tokens=7, ttft_ms=1.0, latency_ms=2.0,
        ))
        return fut

    def cancel(self, fut):
        pass

    def stats(self):
        return {}


def test_tool_call_completion_parsed_by_toolparse():
    eng = _ScriptedEngine('Sure. {"name": "get_weather", "arguments": {"city": "Paris"}}')
    server, base = _serve(eng)
    try:
        status, doc = _call(base, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "weather?"}],
            "tools": [{"type": "function", "function": {
                "name": "get_weather", "description": "look it up",
                "parameters": {"type": "object", "properties": {"city": {"type": "string"}}},
            }}],
        })
    finally:
        server.shutdown()
        server.server_close()
    assert status == 200
    choice = doc["choices"][0]
    assert choice["finish_reason"] == "tool_calls"
    assert choice["message"]["content"] is None
    (call,) = choice["message"]["tool_calls"]
    assert call["function"]["name"] == "get_weather"
    assert json.loads(call["function"]["arguments"]) == {"city": "Paris"}
    # the tool schema was rendered into the system turn of the prompt
    assert '"name": "get_weather"' in eng.prompts[0]


def test_int8_engine_stats_served_and_cli_flags(monkeypatch):
    """``serve --quantize-weights --quantize-kv`` reaches the engine, and
    ``/v1/engine`` shows the int8 knobs and the quantized-KV block."""
    from agentcontrolplane_tpu_torch import __main__ as cli
    from agentcontrolplane_tpu_torch.server import rest

    seen = {}
    monkeypatch.setattr(rest, "serve", lambda preset, **kw: seen.update(kw, preset=preset))
    assert cli.main(["serve", "--preset", "tiny", "--device", "cpu", "--quantize-weights",
                     "--quantize-kv"]) == 0
    assert seen["quantize_weights"] is True and seen["quantize_kv"] is True
    cli.main(["serve", "--preset", "tiny", "--device", "cpu"])
    assert seen["quantize_weights"] is False and seen["quantize_kv"] is False

    eng = Engine(CFG, random_params(CFG, 0, "cpu"), device="cpu", max_slots=2, max_ctx=64,
                 prefill_buckets=(32, 64), decode_block_size=4, page_size=8,
                 quantize_weights=True, quantize_kv=True)
    server, base = _serve(eng)
    try:
        status, stats = _call(base, "/v1/engine")
        assert status == 200
        assert stats["model"]["quantize"] == "int8" and stats["model"]["quantize_kv"] is True
        assert stats["memory"]["quantized_kv"] == {"enabled": True, "pages": 0}
    finally:
        server.shutdown()
        server.server_close()


# -- refusals held against the reference -------------------------------------


@pytest.fixture(scope="module")
def scripted():
    """A front door over a scripted engine: what it serves or refuses is
    decided before any generation, so no model is needed."""
    eng = _ScriptedEngine("ok")
    server, base = _serve(eng)
    yield eng, base
    server.shutdown()
    server.server_close()


@pytest.mark.parametrize("stream,status", [(True, 400), (False, 200), (None, 200)])
def test_stream_true_is_refused_until_sse_is_ported(scripted, stream, status):
    _eng, base = scripted
    body = {"messages": [{"role": "user", "content": "hi"}]}
    if stream is not None:
        body["stream"] = stream
    got, doc = _call(base, "/v1/chat/completions", body)
    assert got == status
    if status == 400:
        assert "not yet supported" in doc["error"] and "stream" in doc["error"]
    else:
        assert doc["object"] == "chat.completion"


def _reference_constrains(tool_names, tool_choice) -> bool:
    """The reference front door's decision (``server/rest.py``'s
    ``chat_completions``): normalize ``tool_choice`` as it does, then
    constrain when ``forced_call_prefix`` forces a call or ``json_required``
    holds."""
    from agentcontrolplane_tpu.engine.client import forced_call_prefix
    from agentcontrolplane_tpu.engine.tokenizer import ByteTokenizer
    from agentcontrolplane_tpu.llmclient.base import Tool, ToolFunction

    tools = [Tool(function=ToolFunction(name=n, description="", parameters={}))
             for n in tool_names]
    if isinstance(tool_choice, dict):
        tool_choice = (tool_choice.get("function") or {}).get("name") or ""
    tool_choice = str(tool_choice or "auto")
    forced = forced_call_prefix(ByteTokenizer(), tools, tool_choice)
    return bool(forced) or (tool_choice == "required" and bool(tools))


TOOL_CHOICES = [
    None, "auto", "none", "", "required", "Required", "get_weather", "search",
    "not_offered", {"type": "function", "function": {"name": "get_weather"}},
    {"type": "function", "function": {"name": "not_offered"}}, {"type": "function"},
]


@pytest.mark.parametrize("tool_names", [(), ("get_weather",), ("get_weather", "search")],
                         ids=["no-tools", "one-tool", "two-tools"])
@pytest.mark.parametrize("tool_choice", TOOL_CHOICES, ids=lambda c: json.dumps(c))
def test_tool_choice_refused_exactly_where_the_reference_constrains(
        scripted, tool_names, tool_choice):
    """400 "not yet supported" where the reference would force a call or
    require JSON; served unconstrained (200) everywhere else, as the
    reference serves it."""
    _eng, base = scripted
    body = {"messages": [{"role": "user", "content": "weather?"}]}
    if tool_names:
        body["tools"] = [{"type": "function", "function": {"name": n}} for n in tool_names]
    if tool_choice is not None:
        body["tool_choice"] = tool_choice
    status, doc = _call(base, "/v1/chat/completions", body)
    if _reference_constrains(tool_names, tool_choice):
        assert status == 400 and "not yet supported" in doc["error"]
    else:
        assert status == 200 and doc["object"] == "chat.completion"


def test_tool_choice_table_covers_both_outcomes():
    """The table above holds cases the reference constrains and cases it
    serves unconstrained, with and without tools, so neither side of the
    boundary goes untested."""
    from agentcontrolplane_tpu_torch.engine.types import Tool as PortTool
    from agentcontrolplane_tpu_torch.engine.types import ToolFunction as PortToolFunction
    from agentcontrolplane_tpu_torch.server.rest import tool_choice_constrains

    seen = set()
    for names in [(), ("get_weather",), ("get_weather", "search")]:
        tools = [PortTool(function=PortToolFunction(name=n, description="", parameters={}))
                 for n in names]
        for choice in TOOL_CHOICES:
            want = _reference_constrains(names, choice)
            norm = choice
            if isinstance(norm, dict):
                norm = (norm.get("function") or {}).get("name") or ""
            assert tool_choice_constrains(tools, str(norm or "auto")) == want, (names, choice)
            seen.add((bool(names), want))
    assert seen == {(False, False), (True, False), (True, True)}
