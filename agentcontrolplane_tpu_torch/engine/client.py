"""``provider: tpu`` — the LLM client backed by the in-process engine: the
port's copy of the reference's ``agentcontrolplane_tpu/engine/client.py``.

The engine is stateless with respect to conversations (the whole context
window arrives every time); the KV cache is per-request state inside it.

The caller's span context rides into ``Engine.submit(trace=)``, so the
flight recorder exports the request's phase windows as child spans of the
Task's trace. Not passed yet, because the port's engine does not have it:
``affinity_key=`` (fleet routing, ROADMAP A.12).
"""

from __future__ import annotations

import asyncio
import json

from ..llmclient.base import LLMClient, LLMRequestError
from .engine import DeadlineExceededError, Engine, EngineOverloadedError, SamplingParams
from .tokenizer import render_prompt
from .toolparse import to_message
from .types import BaseConfig, Message, Tool

# the reference's TPUProviderConfig defaults: requestTimeoutSeconds (its 30 s
# LLMRequestTimeout, counted from slot admission) and queueTimeoutSeconds
REQUEST_TIMEOUT_S = 30.0
QUEUE_TIMEOUT_S = 600.0


def forced_call_prefix(tokenizer, tools: list[Tool], tool_choice: str) -> tuple:
    """Teacher-forced tool-call envelope tokens for a tool_choice that
    names one tool ("required" with a single tool, or an explicit name) —
    shared by the client and the HTTP front door's OpenAI ``tool_choice``.
    Empty tuple when nothing can be forced."""
    if not tools:
        return ()
    name = None
    if tool_choice == "required" and len(tools) == 1:
        name = tools[0].function.name
    elif tool_choice not in ("auto", "required", "none", ""):
        offered = {t.function.name for t in tools}
        if tool_choice in offered:
            name = tool_choice
    if name is None:
        return ()
    # json.dumps escapes quotes/backslashes in exotic tool names: an
    # unescaped name would be an illegal prefix and fail every request
    prefix = f'{{"name": {json.dumps(name)}, "arguments": {{'
    return tuple(tokenizer.encode(prefix))


class TPUEngineClient(LLMClient):
    def __init__(
        self,
        engine: Engine,
        params: BaseConfig,
        force_json_tools: bool = False,
        tool_choice: str = "auto",
        request_timeout_s: float | None = None,
        queue_timeout_s: float | None = None,
        overlap_tool_calls: bool = True,
    ):
        self.engine = engine
        self.params = params
        # stream-parse tool calls during decode and hand each to the caller
        # the moment its braces close (send_request's on_tool_call). Moves
        # WHEN execution can start, never what is generated.
        self.overlap_tool_calls = bool(overlap_tool_calls)
        self.supports_early_tool_calls = self.overlap_tool_calls
        # the Task controller passes its LLMRequest span context down
        # (send_request trace_context=...); the engine's phase spans parent
        # under it
        self.supports_trace_context = True
        # the generation clock starts at SLOT ADMISSION, not submit: queue
        # wait under saturation must not eat the request's budget; the
        # queue wait is bounded separately (and generously)
        self.request_timeout_s = REQUEST_TIMEOUT_S if request_timeout_s is None \
            else request_timeout_s
        self.queue_timeout_s = QUEUE_TIMEOUT_S if queue_timeout_s is None else queue_timeout_s
        # grammar-constrain the response to a JSON object whenever tools
        # are offered (parseable tool calls, no prose answers)
        self.force_json_tools = force_json_tools
        # "auto" (default), "required" (force a call to the single offered
        # tool; with several tools, json_only), or a tool's name: forcing
        # teacher-forces the '{"name": "X", "arguments": {' envelope and
        # constrains the rest, so the completion is always a call to X
        self.tool_choice = tool_choice

    def _forced_call(self, tools: list[Tool]) -> tuple:
        return forced_call_prefix(self.engine.tokenizer, tools, self.tool_choice)

    async def send_request(self, messages: list[Message], tools: list[Tool],
                           on_tool_call=None, trace_context=None) -> Message:
        """``on_tool_call`` (honored when ``overlap_tool_calls``): called on
        the event loop as ``(index, MessageToolCall)`` for each streamed call
        the moment its arguments close; indices are dense over the calls
        that pass the allowed-tools filter. The returned Message is batch-
        parsed from the finished text and is authoritative."""
        prompt = render_prompt(messages, tools)
        # crash recovery: a dead engine loop (an exception, not a stop()) is
        # rebuilt and restarted, off the event loop (it allocates the pools)
        if not await asyncio.to_thread(self.engine.ensure_running):
            raise LLMRequestError(503, "TPU engine is stopped")
        forced = self._forced_call(tools)
        # "required" with several tools can't force ONE envelope; it still
        # demands a tool call, so fall back to grammar-constrained JSON
        json_required = self.tool_choice == "required"
        p = self.params
        sampling = SamplingParams(
            temperature=p.temperature or 0.0,
            top_k=p.top_k or 0,
            top_p=p.top_p if p.top_p is not None else 1.0,
            max_tokens=p.max_tokens or 512,
            json_only=bool((self.force_json_tools or forced or json_required) and tools),
            forced_prefix=forced,
        )
        allowed = {t.function.name for t in tools} if tools else None
        engine_cb = None
        overlap = self.overlap_tool_calls and bool(tools)
        if overlap and on_tool_call is not None:
            loop = asyncio.get_running_loop()
            seen = {"n": 0}  # re-index past filtered (hallucinated) names

            def engine_cb(_idx, tc):
                # engine thread -> event loop; the loop's FIFO lands every
                # bridged event before the future's own waiter resumes
                if allowed is not None and tc.function.name not in allowed:
                    return
                idx, seen["n"] = seen["n"], seen["n"] + 1
                loop.call_soon_threadsafe(on_tool_call, idx, tc)

        # the queue deadline rides INTO the engine: a request that would
        # outwait it is failed there without a prefill
        future = self.engine.submit(
            prompt, sampling, timeout_s=self.queue_timeout_s, on_tool_call=engine_cb,
            # park the finished slot: the conversation's next turn (sent as
            # soon as the overlapped tools complete) adopts it and prefills
            # only its suffix
            park=overlap,
            # the engine's phase spans parent under the caller's span
            trace=trace_context,
        )
        try:
            result = await self._await_result(future)
        except asyncio.TimeoutError as e:
            self.engine.cancel(future)  # free the slot; don't decode for a dead request
            raise LLMRequestError(504, str(e) or "TPU engine request timed out") from e
        except asyncio.CancelledError:
            # caller torn down mid-generation: free the slot
            self.engine.cancel(future)
            raise
        except EngineOverloadedError as e:
            # 503: non-terminal, the caller retries with backoff
            raise LLMRequestError(503, f"TPU engine overloaded: {e}") from e
        except DeadlineExceededError as e:
            raise LLMRequestError(504, f"TPU engine queue deadline: {e}") from e
        except Exception as e:
            raise LLMRequestError(500, f"TPU engine failure: {e}") from e
        return to_message(result.text, allowed)

    async def _await_result(self, future):
        """Two-phase wait: queue_timeout_s bounds submit -> slot admission,
        request_timeout_s bounds admission -> completion. Raises
        asyncio.TimeoutError naming the phase that expired. The admission
        signal is a concurrent Future bridged with wrap_future, so a queued
        request parks no executor thread."""
        wrapped = asyncio.wrap_future(future)
        admitted = getattr(future, "admitted", None)
        if admitted is not None and not admitted.done():
            admit_wait = asyncio.wrap_future(admitted)
            try:
                # completion also ends the queue phase (fast failure paths
                # complete the future without ever resolving admission)
                done, _ = await asyncio.wait(
                    {wrapped, admit_wait}, timeout=self.queue_timeout_s,
                    return_when=asyncio.FIRST_COMPLETED,
                )
                if wrapped in done:
                    return wrapped.result()
                if admit_wait not in done:
                    raise asyncio.TimeoutError(
                        f"TPU engine queue wait exceeded {self.queue_timeout_s:.0f}s "
                        "(engine wedged or oversubscribed)"
                    )
            finally:
                if not admit_wait.done():
                    admit_wait.cancel()
        try:
            return await asyncio.wait_for(wrapped, timeout=self.request_timeout_s)
        except asyncio.TimeoutError:
            raise asyncio.TimeoutError(
                "TPU engine generation timed out "
                f"{self.request_timeout_s:.0f}s after slot admission"
            ) from None
