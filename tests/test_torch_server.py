"""The torch port's stdlib HTTP front door on a CPU engine: OpenAI-shaped
chat completions with usage counts, 400s on malformed requests (constrained
ones included), health and engine-stats endpoints, a tool-call completion
parsed by the ported toolparse, the reference's mapping of
``response_format`` / ``tool_choice`` onto ``SamplingParams``, and
``stream: true`` as server-sent events in the reference's wire format."""

import dataclasses
import json
import urllib.error
import urllib.request
from concurrent.futures import Future

import pytest

from agentcontrolplane_tpu_torch.engine.engine import Engine, GenerationResult
from agentcontrolplane_tpu_torch.engine.tokenizer import ByteTokenizer
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
    # malformed constrained bodies, which the reference's parse also answers
    # with 400 (the ids are those of the two refusals these cases replaced)
    pytest.param({"messages": [{"role": "user", "content": "hi"}],
                  "response_format": "json_object"}, None, "invalid request",
                 id="body4-None-not yet supported"),
    pytest.param({"messages": [{"role": "user", "content": "hi"}],
                  "tool_choice": {"type": "function", "function": "f"},
                  "tools": [{"function": {"name": "f"}}]}, None, "invalid request",
                 id="body5-None-not yet supported"),
])
def test_malformed_and_constrained_requests_are_400(live, body, raw, match):
    _eng, base = live
    status, doc = _call(base, "/v1/chat/completions", body, raw=raw)
    assert status == 400 and match in doc["error"]


class _ScriptedEngine:
    """Engine-shaped stand-in whose generation text is fixed, to drive the
    tool-call parse path deterministically; it records each request's
    prompt and sampling parameters, and streams its text as one commit."""

    tokenizer = ByteTokenizer()

    def __init__(self, text, error=None):
        self.text = text
        self.error = error
        self.prompts = []
        self.samplings = []

    def ensure_running(self):
        return True

    def submit(self, prompt, sampling, on_tokens=None, timeout_s=None, on_tool_call=None):
        self.prompts.append(prompt)
        self.samplings.append(sampling)
        fut = Future()
        tokens = self.tokenizer.encode(self.text)
        if on_tokens is not None:
            on_tokens(tokens)
        if self.error is not None:
            fut.set_exception(self.error)
            return fut
        fut.set_result(GenerationResult(
            text=self.text, tokens=tokens, finish_reason="stop",
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


def _sse(base, body, timeout=120):
    """POST a stream: (status, content type, [each event's data])."""
    req = urllib.request.Request(base + "/v1/chat/completions", data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        raw = r.read().decode()
        status, ctype = r.status, r.headers.get("Content-Type")
    assert raw.endswith("\n\n")
    events = raw.split("\n\n")[:-1]
    assert all(e.startswith("data: ") for e in events), raw
    return status, ctype, [e[len("data: "):] for e in events]


# ids kept from the refusal this test replaced: stream: true answered 400
@pytest.mark.parametrize("stream", [True, False, None], ids=["True-400", "False-200", "None-200"])
def test_stream_true_is_refused_until_sse_is_ported(scripted, stream):
    """``stream: true`` is served as server-sent events (200,
    text/event-stream, chunks ending in ``data: [DONE]``); false or absent,
    as one JSON completion."""
    _eng, base = scripted
    body = {"messages": [{"role": "user", "content": "hi"}]}
    if stream is not None:
        body["stream"] = stream
    if stream:
        status, ctype, events = _sse(base, body)
        assert status == 200 and ctype == "text/event-stream"
        assert events[-1] == "[DONE]"
        docs = [json.loads(e) for e in events[:-1]]
        assert all(d["object"] == "chat.completion.chunk" for d in docs)
        assert docs[0]["choices"][0]["delta"] == {"role": "assistant"}
        assert "".join(d["choices"][0]["delta"].get("content", "") for d in docs) == "ok"
        assert docs[-1]["choices"][0]["finish_reason"] == "stop"
    else:
        got, doc = _call(base, "/v1/chat/completions", body)
        assert got == 200 and doc["object"] == "chat.completion"


def _reference_mapping(tool_names, tool_choice) -> tuple[bool, tuple]:
    """The reference front door's mapping (``server/rest.py``'s
    ``chat_completions``) of a body without ``response_format``: normalize
    ``tool_choice`` as it does -> (json_only, forced_prefix)."""
    from agentcontrolplane_tpu.engine.client import forced_call_prefix
    from agentcontrolplane_tpu.engine.tokenizer import ByteTokenizer
    from agentcontrolplane_tpu.llmclient.base import Tool, ToolFunction

    tools = [Tool(function=ToolFunction(name=n, description="", parameters={}))
             for n in tool_names]
    if isinstance(tool_choice, dict):
        tool_choice = (tool_choice.get("function") or {}).get("name") or ""
    tool_choice = str(tool_choice or "auto")
    forced = forced_call_prefix(ByteTokenizer(), tools, tool_choice)
    return bool(forced) or (tool_choice == "required" and bool(tools)), forced


def _reference_constrains(tool_names, tool_choice) -> bool:
    """Whether the reference constrains decoding for this body."""
    return _reference_mapping(tool_names, tool_choice)[0]


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
    """Every value is served (200), and the port's resolved sampling
    parameters (json_only, forced_prefix) equal the reference's mapping:
    constrained exactly where the reference would force a call or require
    JSON, with the same teacher-forced envelope tokens."""
    eng, base = scripted
    body = {"messages": [{"role": "user", "content": "weather?"}]}
    if tool_names:
        body["tools"] = [{"type": "function", "function": {"name": n}} for n in tool_names]
    if tool_choice is not None:
        body["tool_choice"] = tool_choice
    n = len(eng.samplings)
    status, doc = _call(base, "/v1/chat/completions", body)
    assert status == 200 and doc["object"] == "chat.completion"
    (sampling,) = eng.samplings[n:]
    json_only, forced = _reference_mapping(tool_names, tool_choice)
    assert (sampling.json_only, tuple(sampling.forced_prefix)) == (json_only, tuple(forced))


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


# -- server-sent events -------------------------------------------------------

TOOLS = [
    {"type": "function", "function": {
        "name": "get_weather", "description": "look it up",
        "parameters": {"type": "object", "properties": {"city": {"type": "string"}}}}},
    {"type": "function", "function": {"name": "search", "description": "search the web"}},
]


def _accumulate(docs):
    """An OpenAI streaming client's view of the chunks: content, the tool
    calls accumulated by index, the finish reason and the usage."""
    content, calls = "", {}
    for d in docs:
        delta = d["choices"][0]["delta"]
        content += delta.get("content") or ""
        for tc in delta.get("tool_calls") or []:
            calls[tc["index"]] = (tc["function"]["name"], tc["function"]["arguments"])
    return content, [calls[i] for i in sorted(calls)], docs[-1]["choices"][0]["finish_reason"], \
        docs[-1]["usage"]


@pytest.mark.parametrize("extra", [
    {"tools": TOOLS, "tool_choice": {"type": "function", "function": {"name": "search"}}},
    {"tools": TOOLS, "tool_choice": "required"},
    {"response_format": {"type": "json_object"}},
], ids=["forced-tool", "required", "json-object"])
def test_sse_matches_the_non_streamed_greedy_reply(live, extra):
    """A greedy stream carries what the same body returns unstreamed: the
    same tool calls (as ``tool_calls`` deltas) or content, finish reason and
    usage; the last event is ``data: [DONE]``."""
    _eng, base = live
    body = {"messages": [{"role": "user", "content": "weather in Paris?"}], "max_tokens": 24,
            **extra}
    status, doc = _call(base, "/v1/chat/completions", body)
    assert status == 200
    msg = doc["choices"][0]["message"]
    status, ctype, events = _sse(base, {**body, "stream": True})
    assert status == 200 and ctype == "text/event-stream" and events[-1] == "[DONE]"
    content, calls, finish, usage = _accumulate([json.loads(e) for e in events[:-1]])
    want_calls = [(c["function"]["name"], c["function"]["arguments"])
                  for c in msg.get("tool_calls") or []]
    assert calls == want_calls
    assert content.strip() == (msg["content"] or "")
    assert finish == doc["choices"][0]["finish_reason"] and usage == doc["usage"]
    if isinstance(extra.get("tool_choice"), dict):  # a forced call
        assert finish == "tool_calls" and [name for name, _ in calls] == ["search"]
    if not calls:  # constrained to one JSON object
        json.loads(content)


def test_sse_failed_generation_ends_with_an_error_event_and_no_done():
    eng = _ScriptedEngine("partial", error=RuntimeError("boom"))
    server, base = _serve(eng)
    try:
        status, _ctype, events = _sse(base, {"messages": [{"role": "user", "content": "hi"}],
                                             "stream": True})
    finally:
        server.shutdown()
        server.server_close()
    assert status == 200 and "[DONE]" not in events
    err = json.loads(events[-1])["error"]
    assert err == {"message": "generation failed: boom", "type": "server_error"}


def test_sse_shed_before_the_stream_opens_is_a_plain_503():
    from agentcontrolplane_tpu_torch.engine.engine import EngineOverloadedError

    eng = _ScriptedEngine("", error=EngineOverloadedError("queue full", retry_after_s=3.0))
    server, base = _serve(eng)
    try:
        req = urllib.request.Request(base + "/v1/chat/completions", method="POST", data=json.dumps(
            {"messages": [{"role": "user", "content": "hi"}], "stream": True}).encode())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
    finally:
        server.shutdown()
        server.server_close()
    assert e.value.code == 503 and e.value.headers["Retry-After"] == "3"
    assert "queue full" in json.loads(e.value.read())["error"]


class _HangingEngine(_ScriptedEngine):
    """A generation that never ends until cancelled."""

    def __init__(self):
        super().__init__("")
        self.cancelled = []

    def submit(self, prompt, sampling, on_tokens=None, timeout_s=None, on_tool_call=None):
        return Future()

    def cancel(self, fut):
        self.cancelled.append(fut)
        fut.cancel()


def test_sse_client_disconnect_cancels_the_request():
    import socket
    import time

    eng = _HangingEngine()
    server, base = _serve(eng)
    try:
        body = json.dumps({"messages": [{"role": "user", "content": "hi"}],
                           "stream": True}).encode()
        with socket.create_connection(server.server_address, timeout=30) as sock:
            sock.sendall(b"POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\n"
                         b"Content-Length: %d\r\n\r\n" % len(body) + body)
            head = b""
            while b"chat.completion.chunk" not in head:  # the role chunk arrived
                head += sock.recv(4096)
            assert b"text/event-stream" in head
        deadline = time.monotonic() + 30
        while not eng.cancelled and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        server.shutdown()
        server.server_close()
    assert len(eng.cancelled) == 1 and eng.cancelled[0].cancelled()


# -- the SSE wire against the reference's _stream_chat ------------------------


class _ReplayEngine:
    """Engine-shaped stand-in that replays a fixed completion as the engines
    commit one: ``stream`` in blocks of ``block`` ids to ``on_tokens`` and,
    with ``on_tool_call``, each block's decoded text (a multi-byte character
    cut at a block edge held back) to the package's own
    ``ToolStreamParser``; the result's text is ``text`` (``stream`` unless
    given, so a stream that diverges from the final text can be made). The
    result is set after the commits, on the event loop when one runs, so
    every commit is queued before the generation ends. ``pkg`` is either
    package's root module name: its tokenizer, parser and shed error are
    used."""

    def __init__(self, pkg, stream="", text=None, block=3, finish="stop", error=None,
                 shed=False, hang=False):
        import importlib

        self.tokenizer = importlib.import_module(f"{pkg}.engine.tokenizer").ByteTokenizer()
        self.parser = importlib.import_module(f"{pkg}.engine.toolparse").ToolStreamParser
        self.overloaded = importlib.import_module(f"{pkg}.engine.engine").EngineOverloadedError
        self.stream, self.text = stream, stream if text is None else text
        self.block, self.finish, self.error = block, finish, error
        self.shed, self.hang = shed, hang
        self.cancelled = []

    def ensure_running(self):
        return True

    def submit(self, prompt, sampling, on_tokens=None, on_tool_call=None, timeout_s=None):
        import asyncio
        from types import SimpleNamespace

        fut = Future()
        if self.shed:
            fut.set_exception(self.overloaded("queue full", retry_after_s=3.0))
            return fut
        if self.hang:
            return fut
        ids = self.tokenizer.encode(self.stream)
        parser = self.parser() if on_tool_call is not None else None
        pending, n_calls = [], 0
        for i in range(0, len(ids), self.block):
            on_tokens(ids[i:i + self.block])
            if parser is None:
                continue
            pending += ids[i:i + self.block]
            text = self.tokenizer.decode(pending)
            if text.endswith("\ufffd") and i + self.block < len(ids):
                continue
            pending.clear()
            for tc in parser.feed(text):
                on_tool_call(n_calls, tc)
                n_calls += 1
        result = SimpleNamespace(text=self.text, tokens=ids, finish_reason=self.finish,
                                 prompt_tokens=7)

        def done():
            if self.error is not None:
                fut.set_exception(self.error)
            else:
                fut.set_result(result)

        try:
            asyncio.get_running_loop().call_soon(done)
        except RuntimeError:  # no event loop here: the port's threaded server
            done()
        return fut

    def cancel(self, fut):
        self.cancelled.append(fut)
        fut.cancel()


def _reference_http(engine, body):
    """POST ``body`` to the reference's chat endpoint (aiohttp, its
    ``chat_completions`` and ``_stream_chat``) over ``engine``:
    (status, Content-Type, Retry-After, raw body)."""
    import asyncio
    from types import SimpleNamespace

    from aiohttp import web
    from aiohttp.test_utils import TestClient, TestServer

    from agentcontrolplane_tpu.server.rest import RestServer

    rest = object.__new__(RestServer)  # only its operator's engine is read
    rest.operator = SimpleNamespace(engine=engine, fleet=None)

    async def go():
        app = web.Application()
        app.router.add_post("/v1/chat/completions", rest.chat_completions)
        async with TestClient(TestServer(app)) as client:
            resp = await client.post("/v1/chat/completions", json=body)
            return (resp.status, resp.headers.get("Content-Type"),
                    resp.headers.get("Retry-After"), (await resp.read()).decode())

    return asyncio.run(go())


def _port_http(engine, body):
    """The same through the port's front door."""
    server, base = _serve(engine)
    req = urllib.request.Request(base + "/v1/chat/completions", data=json.dumps(body).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers.get("Content-Type"), r.headers.get("Retry-After"), \
                r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.headers.get("Retry-After"), \
            e.read().decode()
    finally:
        server.shutdown()
        server.server_close()


def _wire_events(raw):
    """The events of an SSE body, each parsed, with what is random per
    request (the completion's id and time, each call's id) normalised; the
    id and time must be the same in every chunk of the stream."""
    assert raw.endswith("\n\n"), raw
    events = raw.split("\n\n")[:-1]
    assert all(e.startswith("data: ") for e in events), raw
    out, ids = [], set()
    for e in events:
        data = e[len("data: "):]
        if data == "[DONE]":
            out.append(data)
            continue
        doc = json.loads(data)
        if "id" in doc:
            ids.add((doc["id"], doc["created"]))
            doc["id"], doc["created"] = "chatcmpl-*", 0
        for choice in doc.get("choices", []):
            for tc in choice["delta"].get("tool_calls") or []:
                assert tc["id"].startswith("call_")
                tc["id"] = "call_*"
        out.append(doc)
    assert len(ids) <= 1, ids
    return out


CALL = '{"name": "search", "arguments": {"q": "Paris"}}'
WEATHER = '{"name": "get_weather", "arguments": {"city": "Rome"}}'
WIRE_CASES = {
    # content deltas, a multi-byte character cut at a block edge held back
    "content": ({"stream": "Hello, wörld — ünïcode ✓ ok"}, {}),
    "length": ({"stream": "Hello, wörld", "finish": "length"}, {"max_tokens": 5}),
    "forced-call": ({"stream": CALL}, {"tools": TOOLS, "tool_choice": {
        "type": "function", "function": {"name": "search"}}}),
    "required-python-tag": ({"stream": "<|python_tag|>" + WEATHER},
                            {"tools": TOOLS, "tool_choice": "required"}),
    # an unoffered name is dropped from the stream and the reply; a fenced
    # call is found too
    "unoffered-and-fenced": ({"stream": '{"name": "rm", "arguments": {}} then ' + WEATHER
                              + ' and ```json\n' + CALL + '\n```'}, {"tools": TOOLS}),
    # calls the batch parse finds beyond the streamed ones are flushed
    # before the finish chunk, after the streamed indices
    "trailing-call": ({"stream": CALL, "text": CALL + " " + WEATHER}, {"tools": TOOLS}),
    "divergent": ({"stream": CALL, "text": WEATHER}, {"tools": TOOLS}),
    "tools-no-call": ({"stream": "No tool is needed: it is sunny."}, {"tools": TOOLS}),
    "failed": ({"stream": "partial", "error": RuntimeError("boom")}, {}),
    "timed-out": ({"hang": True}, {"timeout_s": 1}),
    "shed": ({"shed": True}, {}),
}


@pytest.mark.parametrize("case", list(WIRE_CASES))
def test_sse_wire_matches_the_reference_stream_chat(case):
    """The same body over the same replayed completion, through the
    reference's aiohttp ``_stream_chat`` and the port's ``ChatStream``: the
    status, the content type and every event, field by field (chunks,
    ``tool_calls`` deltas with their indices, the finish chunk with usage,
    ``data: [DONE]``, the error event with no ``[DONE]`` after it), and a
    shed before the stream opens as the same plain 503."""
    engine_kw, extra = WIRE_CASES[case]
    body = {"model": "llama3-8b", "stream": True, "messages": [
        {"role": "user", "content": "weather in Paris?"}], **extra}
    ref_engine = _ReplayEngine("agentcontrolplane_tpu", **engine_kw)
    port_engine = _ReplayEngine("agentcontrolplane_tpu_torch", **engine_kw)
    ref = _reference_http(ref_engine, body)
    got = _port_http(port_engine, body)
    if case == "shed":
        assert ref[0] == got[0] == 503 and ref[2] == got[2] == "3"
        assert json.loads(got[3]) == json.loads(ref[3]) == {"error": "queue full"}
        return
    assert ref[0] == got[0] == 200
    assert ref[1] == got[1] == "text/event-stream"
    want = _wire_events(ref[3])
    assert _wire_events(got[3]) == want
    # the cases hold what they are named for
    last = want[-1]
    if case in ("failed", "timed-out"):
        assert "[DONE]" not in want and set(last) == {"error"}
        assert len(port_engine.cancelled) == len(ref_engine.cancelled) == (case == "timed-out")
    else:
        assert last == "[DONE]" and want[-2]["usage"]["completion_tokens"] > 0
    if case in ("forced-call", "trailing-call", "divergent", "unoffered-and-fenced"):
        assert want[-2]["choices"][0]["finish_reason"] == "tool_calls"
        assert not any(d["choices"][0]["delta"].get("content") for d in want[:-1])
    if case == "content":
        assert sum("content" in d["choices"][0]["delta"] for d in want[:-1]) > 3
