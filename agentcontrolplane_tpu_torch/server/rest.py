"""OpenAI-compatible HTTP front door over the torch engine.

The port of the reference's engine-direct chat endpoint
(``agentcontrolplane_tpu/server/rest.py`` ``chat_completions``), on the
standard library's ``ThreadingHTTPServer`` because the card's machine has
no aiohttp:

- ``POST /v1/chat/completions`` — a chat completion; tool calls are parsed
  from the generated text by ``engine/toolparse.py``. ``response_format:
  json_object`` constrains the completion to a JSON object, a ``tool_choice``
  that forces a call (:func:`tool_choice_constrains`) teacher-forces the
  call's envelope and constrains the rest, and ``stream: true`` answers with
  server-sent events (``chat.completion.chunk`` documents, tool calls as
  ``tool_calls`` deltas the moment their arguments close, ``data: [DONE]``);
- ``GET /healthz`` — liveness;
- ``GET /v1/engine`` — ``Engine.stats()`` (with the int8 knobs under
  ``model.quantize``/``model.quantize_kv`` and ``memory.quantized_kv``, and
  the serving group under ``mesh``).

:func:`serve_parallel` serves over tp x sp ranks (one process each, from
``parallel.distributed.run_ranks``): rank 0 answers HTTP, the other ranks
run the engine loop on the leader's frame stream.
"""

from __future__ import annotations

import json
import queue
import select
import socket
import threading
import time
import uuid
from concurrent.futures import CancelledError, TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Iterator, Optional

from ..engine.engine import (
    DeadlineExceededError,
    Engine,
    EngineOverloadedError,
    SamplingParams,
)
from ..engine.client import forced_call_prefix
from ..engine.tokenizer import render_prompt
from ..engine.toolparse import to_message
from ..engine.types import Message, MessageToolCall, Tool, ToolCallFunction, ToolFunction


def tool_choice_constrains(tools: list[Tool], tool_choice: str) -> bool:
    """Whether the reference constrains decoding for this OpenAI
    ``tool_choice`` (already normalized to a string): ``"required"`` with
    tools (its ``json_required``, however many are offered), or the name of
    an offered tool (its ``forced_call_prefix``,
    ``agentcontrolplane_tpu/engine/client.py``). Any other value, a name
    that is not offered included, is served unconstrained there and here."""
    if not tools:
        return False
    if tool_choice == "required":
        return True
    offered = {t.function.name for t in tools}
    return tool_choice not in ("auto", "none", "") and tool_choice in offered


def _parse_chat(body: Any, tokenizer) -> tuple[str, SamplingParams, list[Tool], float, bool]:
    """Request body -> (prompt, sampling, tools, timeout_s, stream), mapped
    as the reference's ``chat_completions`` maps it. Any malformed input
    raises (the handler answers 400)."""
    if not isinstance(body, dict):
        raise ValueError("request body must be a JSON object")
    messages = [
        Message(
            role=m["role"],
            content=m.get("content") or "",
            tool_call_id=m.get("tool_call_id"),
            tool_calls=[
                MessageToolCall(
                    id=tc.get("id", f"call_{i}"),
                    function=ToolCallFunction(
                        name=tc["function"]["name"],
                        arguments=tc["function"].get("arguments") or "{}",
                    ),
                )
                for i, tc in enumerate(m.get("tool_calls") or [])
            ],
        )
        for m in body["messages"]
    ]
    tools = [
        Tool(function=ToolFunction(
            name=t["function"]["name"],
            description=t["function"].get("description", ""),
            parameters=t["function"].get("parameters") or {},
        ))
        for t in body.get("tools") or []
    ]
    json_object = (body.get("response_format") or {}).get("type") == "json_object"
    # OpenAI tool_choice: "required" or a named function forces a parseable
    # call — the teacher-forced envelope plus the JSON constraint
    tool_choice = body.get("tool_choice")
    if isinstance(tool_choice, dict):
        tool_choice = (tool_choice.get("function") or {}).get("name") or ""
    tool_choice = str(tool_choice or "auto")
    sampling = SamplingParams(
        temperature=float(body.get("temperature") or 0.0),
        top_p=float(body["top_p"]) if body.get("top_p") is not None else 1.0,
        max_tokens=int(body.get("max_tokens") or 512),
        json_only=json_object or tool_choice_constrains(tools, tool_choice),
        forced_prefix=forced_call_prefix(tokenizer, tools, tool_choice),
    )
    timeout_s = min(3600.0, max(1.0, float(body.get("timeout_s") or 600.0)))
    # render here so an unparseable history tool call is a 400, not a 500
    return render_prompt(messages, tools), sampling, tools, timeout_s, bool(body.get("stream"))


def _overloaded(e: EngineOverloadedError) -> tuple[int, dict, dict]:
    return 503, {"error": str(e)}, {"Retry-After": str(max(1, int(e.retry_after_s)))}


def chat_completion(engine: Engine, body: Any) -> tuple[int, Any, dict]:
    """Serve one chat completion body -> (status, JSON doc or
    :class:`ChatStream`, extra headers)."""
    try:
        prompt, sampling, tools, timeout_s, stream = _parse_chat(body, engine.tokenizer)
    except Exception as e:  # any malformed client input is a 400
        return 400, {"error": f"invalid request: {e}"}, {}
    if not engine.ensure_running():
        return 503, {"error": "engine is stopped"}, {}
    if stream:
        chat = ChatStream(engine, prompt, sampling, tools, body, timeout_s)
        exc = chat.future.exception() if chat.future.done() else None
        if isinstance(exc, EngineOverloadedError):
            # shed before the stream opened: a plain 503 the client can retry
            return _overloaded(exc)
        return 200, chat, {}
    fut = engine.submit(prompt, sampling, timeout_s=timeout_s)
    try:
        result = fut.result(timeout=timeout_s)
    except FutureTimeout:
        engine.cancel(fut)  # free the slot; don't decode for a gone caller
        return 504, {"error": "generation timed out"}, {}
    except EngineOverloadedError as e:
        return _overloaded(e)
    except DeadlineExceededError as e:
        return 504, {"error": str(e)}, {}
    except (CancelledError, RuntimeError) as e:
        return 500, {"error": f"generation failed: {e}"}, {}
    allowed = {t.function.name for t in tools} if tools else None
    msg = to_message(result.text, allowed)
    out_msg: dict[str, Any] = {"role": "assistant", "content": msg.content or None}
    if msg.tool_calls:
        out_msg["tool_calls"] = [
            {
                "id": tc.id,
                "type": "function",
                "function": {"name": tc.function.name, "arguments": tc.function.arguments},
            }
            for tc in msg.tool_calls
        ]
    finish = "tool_calls" if msg.tool_calls else (
        "length" if result.finish_reason == "length" else "stop"
    )
    return 200, {
        "id": f"chatcmpl-{uuid.uuid4().hex[:24]}",
        "object": "chat.completion",
        "created": int(time.time()),
        "model": body.get("model") or "torch",
        "choices": [{"index": 0, "message": out_msg, "finish_reason": finish}],
        "usage": {
            "prompt_tokens": result.prompt_tokens,
            "completion_tokens": len(result.tokens),
            "total_tokens": result.prompt_tokens + len(result.tokens),
        },
    }, {}


class ChatStream:
    """One ``stream: true`` completion as server-sent events, in the wire
    format of the reference's ``_stream_chat``: ``chat.completion.chunk``
    documents, the first with the assistant role. Without tools, content
    deltas follow each decode block. With tools the completion is buffered
    (the reply is either content or tool calls, as the non-streamed one is)
    and each call goes out as a ``tool_calls`` delta the moment its
    arguments close in the decode stream; calls the final batch parse finds
    beyond the streamed ones are flushed before the finish chunk
    (``tool_calls``/``stop``/``length``, with usage), then ``data: [DONE]``.
    A timeout or a failed generation ends the stream with an error event
    and no ``[DONE]``. The request is submitted when the stream is made."""

    def __init__(self, engine: Engine, prompt: str, sampling: SamplingParams,
                 tools: list[Tool], body: dict, timeout_s: float):
        self.engine = engine
        self.tools = tools
        self.allowed = {t.function.name for t in tools} if tools else None
        self.id = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        self.created = int(time.time())
        self.model = body.get("model") or "torch"
        self.deadline = time.monotonic() + timeout_s
        # filled from the engine thread: token id lists and ("tool_call", tc)
        self.events: queue.Queue = queue.Queue()

        def on_tool_call(_idx, tc):
            if self.allowed is None or tc.function.name in self.allowed:
                self.events.put(("tool_call", tc))

        self.future = engine.submit(
            prompt, sampling, on_tokens=lambda ids: self.events.put(list(ids)),
            timeout_s=timeout_s, on_tool_call=on_tool_call if tools else None,
        )

    def cancel(self) -> None:
        self.engine.cancel(self.future)

    def _doc(self, delta: dict, finish: Optional[str] = None, **extra) -> bytes:
        doc = {
            "id": self.id, "object": "chat.completion.chunk", "created": self.created,
            "model": self.model,
            "choices": [{"index": 0, "delta": delta, "finish_reason": finish}],
            **extra,
        }
        return f"data: {json.dumps(doc)}\n\n".encode()

    def _tool_chunk(self, calls: list[MessageToolCall], base: int) -> bytes:
        return self._doc({"tool_calls": [
            {"index": base + i, "id": tc.id, "type": "function",
             "function": {"name": tc.function.name, "arguments": tc.function.arguments}}
            for i, tc in enumerate(calls)
        ]})

    @staticmethod
    def _error(message: str, etype: str) -> bytes:
        return f'data: {json.dumps({"error": {"message": message, "type": etype}})}\n\n'.encode()

    def chunks(self, peer_gone: Callable[[], bool] = lambda: False) -> Iterator[bytes]:
        """The stream's events, each one whole ``data:`` line pair.
        ``peer_gone`` is polled while waiting; when it turns true the
        request is cancelled (its slot freed) and the stream ends."""
        fut = self.future
        buffer_mode = bool(self.tools)
        pending: list[int] = []  # ids not yet sent as content
        sent = 0  # characters already sent as content
        streamed: list[MessageToolCall] = []  # calls already sent as deltas
        yield self._doc({"role": "assistant"})
        while not fut.done() or not self.events.empty():
            if time.monotonic() > self.deadline:
                self.cancel()
                yield self._error("generation timed out", "timeout")
                return
            if peer_gone():
                self.cancel()
                return
            try:
                item = self.events.get(timeout=0.1)
            except queue.Empty:
                continue
            if isinstance(item, tuple):
                # a call's arguments closed in the decode stream: send it NOW
                yield self._tool_chunk([item[1]], len(streamed))
                streamed.append(item[1])
                continue
            pending.extend(item)
            if buffer_mode:
                continue
            text = self.engine.tokenizer.decode(pending)
            if text.endswith("\ufffd"):
                continue  # a multi-byte character cut at a block edge
            if text:
                yield self._doc({"content": text})
                sent += len(text)
            pending.clear()
        try:
            result = fut.result(timeout=max(1.0, min(30.0, self.deadline - time.monotonic())))
        except (Exception, CancelledError) as e:
            yield self._error(f"generation failed: {e}", "server_error")
            return
        finish = "length" if result.finish_reason == "length" else "stop"
        msg = to_message(result.text, self.allowed)
        # the batch parse is authoritative (it is the non-streamed reply):
        # without calls the content flows, held-back characters included
        if not (buffer_mode and msg.tool_calls):
            delta = result.text[sent:]
            if delta:
                yield self._doc({"content": delta})
        if msg.tool_calls:
            # the streamed calls that positionally match the batch parse were
            # sent; flush the rest (all of it after a divergent stream, after
            # the streamed indices, so an accumulate-by-index client ends
            # with every call)
            matched = 0
            for tc in msg.tool_calls:
                if matched >= len(streamed):
                    break
                s = streamed[matched]
                if (s.function.name, s.function.arguments) != (tc.function.name,
                                                                tc.function.arguments):
                    break
                matched += 1
            rest = msg.tool_calls[matched:] if matched == len(streamed) else msg.tool_calls
            if rest:
                yield self._tool_chunk(rest, len(streamed))
            finish = "tool_calls"
        yield self._doc({}, finish, usage={
            "prompt_tokens": result.prompt_tokens,
            "completion_tokens": len(result.tokens),
            "total_tokens": result.prompt_tokens + len(result.tokens),
        })
        yield b"data: [DONE]\n\n"


def _peer_gone(sock: socket.socket) -> bool:
    """Whether the client closed its end: readable with nothing to read (a
    stream's client sends nothing after its request)."""
    try:
        readable, _, _ = select.select([sock], [], [], 0)
        return bool(readable) and sock.recv(1, socket.MSG_PEEK) == b""
    except (OSError, ValueError):
        return True


class _Handler(BaseHTTPRequestHandler):
    server_version = "acp-torch/0.1"
    protocol_version = "HTTP/1.1"

    def log_message(self, format, *args):  # noqa: A002 — keep the console quiet
        pass

    def _reply(self, status: int, doc: dict, headers: dict) -> None:
        data = json.dumps(doc).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in headers.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path == "/healthz":
            self._reply(200, {"ok": True}, {})
        elif self.path == "/v1/engine":
            self._reply(200, self.server.engine.stats(), {})
        else:
            self._reply(404, {"error": "not found"}, {})

    def do_POST(self):
        if self.path != "/v1/chat/completions":
            self._reply(404, {"error": "not found"}, {})
            return
        try:
            n = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(n))
        except ValueError as e:
            self._reply(400, {"error": f"invalid request: {e}"}, {})
            return
        status, doc, headers = chat_completion(self.server.engine, body)
        if isinstance(doc, ChatStream):
            self._stream(doc)
        else:
            self._reply(status, doc, headers)

    def _stream(self, chat: ChatStream) -> None:
        """Server-sent events, close-delimited, each event flushed as it is
        made. A client that goes away cancels its request."""
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True
        try:
            for event in chat.chunks(lambda: _peer_gone(self.connection)):
                self.wfile.write(event)
                self.wfile.flush()
        except OSError:  # the client went away mid-stream
            chat.cancel()


def make_server(engine: Engine, host: str = "127.0.0.1", port: int = 8000) -> ThreadingHTTPServer:
    """A bound (not yet serving) HTTP server over ``engine``; port 0 picks
    a free one (``server.server_address[1]``)."""
    server = ThreadingHTTPServer((host, port), _Handler)
    server.daemon_threads = True
    server.engine = engine  # type: ignore[attr-defined]
    return server


def serve_in_thread(server: ThreadingHTTPServer) -> threading.Thread:
    t = threading.Thread(target=server.serve_forever, name="acp-torch-http", daemon=True)
    t.start()
    return t


def serve(
    preset: str = "llama3-8b",
    seed: int = 0,
    host: str = "127.0.0.1",
    port: int = 8000,
    device: str = "cuda",
    **engine_kw,
) -> None:
    """Build an engine with random weights from ``seed`` and serve until
    interrupted. Raises when CUDA is missing and ``device="cpu"`` was not
    passed."""
    engine = Engine(preset, device=device, seed=seed, **engine_kw)
    engine.start()
    server = make_server(engine, host, port)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        engine.stop()


def _serve_rank(preset: str, tp: int, sp: int, seed: int, host: str, port: int,
                engine_kw: dict) -> None:
    """One rank of :func:`serve_parallel` (runs in a spawned process)."""
    from ..parallel.distributed import runtime_info
    from ..parallel.mesh import serving_group

    group = serving_group(tp, sp)
    engine = Engine(preset, device=runtime_info()["device"], seed=seed, group=group, **engine_kw)
    engine.start()
    if not group.is_leader:
        engine.join()  # until the leader's stop frame
        return
    server = make_server(engine, host, port)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        engine.stop()


def serve_parallel(
    preset: str = "llama3-8b",
    tp: int = 2,
    sp: int = 1,
    seed: int = 0,
    host: str = "127.0.0.1",
    port: int = 8000,
    device: str = "cuda",
    backend: str | None = None,
    **engine_kw,
) -> None:
    """Serve ``preset`` over ``tp x sp`` ranks on this machine until
    interrupted. ``backend`` defaults to nccl when every rank has a card of
    its own and gloo otherwise (NCCL refuses two ranks on one card)."""
    from ..parallel.distributed import run_ranks

    run_ranks(_serve_rank, tp * sp, args=(preset, tp, sp, seed, host, port, engine_kw),
              timeout_s=None, backend=backend, device=device)
