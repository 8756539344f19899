"""OpenAI-compatible HTTP front door over the torch engine.

The port of the reference's engine-direct chat endpoint
(``agentcontrolplane_tpu/server/rest.py`` ``chat_completions``), on the
standard library's ``ThreadingHTTPServer`` because the card's machine has
no aiohttp:

- ``POST /v1/chat/completions`` — non-streaming chat completion; tool calls
  are parsed from the generated text by ``engine/toolparse.py``;
- ``GET /healthz`` — liveness;
- ``GET /v1/engine`` — ``Engine.stats()`` (with the int8 knobs under
  ``model.quantize``/``model.quantize_kv`` and ``memory.quantized_kv``, and
  the serving group under ``mesh``).

:func:`serve_parallel` serves over tp x sp ranks (one process each, from
``parallel.distributed.run_ranks``): rank 0 answers HTTP, the other ranks
run the engine loop on the leader's frame stream.

Constrained requests (``response_format: json_object``, or a ``tool_choice``
the reference would force: :func:`tool_choice_constrains`) and
``stream: true`` answer 400: the torch engine has no constrained decoding
and no server-sent events yet.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from concurrent.futures import CancelledError, TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from ..engine.engine import (
    DeadlineExceededError,
    Engine,
    EngineOverloadedError,
    SamplingParams,
)
from ..engine.tokenizer import render_prompt
from ..engine.toolparse import to_message
from ..engine.types import Message, MessageToolCall, Tool, ToolCallFunction, ToolFunction

NOT_SUPPORTED = "not yet supported by the torch engine"


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


def _parse_chat(body: Any) -> tuple[str, SamplingParams, list[Tool], float]:
    """Request body -> (prompt, sampling, tools, timeout_s). Any malformed
    input raises (the handler answers 400)."""
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
    if (body.get("response_format") or {}).get("type") == "json_object":
        raise NotImplementedError(f"response_format json_object is {NOT_SUPPORTED}")
    tool_choice = body.get("tool_choice")
    if isinstance(tool_choice, dict):
        tool_choice = (tool_choice.get("function") or {}).get("name") or ""
    tool_choice = str(tool_choice or "auto")
    if tool_choice_constrains(tools, tool_choice):
        raise NotImplementedError(f"tool_choice {tool_choice!r} (a forced call) is {NOT_SUPPORTED}")
    if body.get("stream"):
        raise NotImplementedError(f"stream: true (server-sent events) is {NOT_SUPPORTED}")
    sampling = SamplingParams(
        temperature=float(body.get("temperature") or 0.0),
        top_p=float(body["top_p"]) if body.get("top_p") is not None else 1.0,
        max_tokens=int(body.get("max_tokens") or 512),
    )
    timeout_s = min(3600.0, max(1.0, float(body.get("timeout_s") or 600.0)))
    # render here so an unparseable history tool call is a 400, not a 500
    return render_prompt(messages, tools), sampling, tools, timeout_s


def chat_completion(engine: Engine, body: Any) -> tuple[int, dict, dict]:
    """Serve one chat completion body -> (status, JSON doc, extra headers)."""
    try:
        prompt, sampling, tools, timeout_s = _parse_chat(body)
    except NotImplementedError as e:
        return 400, {"error": str(e)}, {}
    except Exception as e:  # any malformed client input is a 400
        return 400, {"error": f"invalid request: {e}"}, {}
    if not engine.ensure_running():
        return 503, {"error": "engine is stopped"}, {}
    fut = engine.submit(prompt, sampling, timeout_s=timeout_s)
    try:
        result = fut.result(timeout=timeout_s)
    except FutureTimeout:
        engine.cancel(fut)  # free the slot; don't decode for a gone caller
        return 504, {"error": "generation timed out"}, {}
    except EngineOverloadedError as e:
        return 503, {"error": str(e)}, {"Retry-After": str(max(1, int(e.retry_after_s)))}
    except DeadlineExceededError as e:
        return 504, {"error": str(e)}, {}
    except (CancelledError, RuntimeError) as e:
        return 500, {"error": f"generation failed: {e!r}"}, {}
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
        self._reply(*chat_completion(self.server.engine, body))


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
