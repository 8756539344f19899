"""Task controller: drives the agentic loop (the port's copy of the
reference's ``controllers/task.py``).

A phase machine dispatching on ``status.phase``:

    ""            -> initialize (persist the root span, Phase=Initializing)
    Initializing  |
    Pending       -> validate the agent, build the initial context window
    ReadyForLLM   -> [per-task mutex + the task-llm lease] send the context
                     window to the LLM; final answer OR fan out ToolCalls
    ToolCallsPending -> join the ToolCall results into the context window
    FinalAnswer / Failed -> terminal (end the trace span)

The loop ReadyForLLM -> ToolCallsPending -> ReadyForLLM accumulates the
conversation; with ``provider: tpu`` each send is one request to the
in-process engine (``engine/client.py::TPUEngineClient``), whose streamed
tool calls create their ToolCall CRs before the turn's decode ends.
"""

from __future__ import annotations

import asyncio
import json
import logging
import random
from dataclasses import dataclass, field
from typing import Optional

from ..api.meta import ObjectMeta
from ..api.resources import (
    LABEL_AGENT,
    LABEL_PARENT_TOOLCALL,
    LABEL_TASK,
    LABEL_TOOL_CALL_REQUEST,
    LABEL_V1BETA3,
    LLM,
    Agent,
    ContactChannel,
    LocalObjectRef,
    Message,
    Task,
    ToolCall,
    ToolCallSpec,
    TASK_PHASE_FAILED,
    TASK_PHASE_FINAL_ANSWER,
    TASK_PHASE_INITIALIZING,
    TASK_PHASE_PENDING,
    TASK_PHASE_READY_FOR_LLM,
    TASK_PHASE_TOOL_CALLS_PENDING,
    TC_PHASE_FAILED,
    TC_PHASE_REJECTED,
    TC_PHASE_SUCCEEDED,
)
from ..humanlayer.client import HumanLayerClientFactory
from ..kernel.errors import AlreadyExists, Conflict, Invalid, NotFound
from ..kernel import lease as leaselib
from ..kernel.events import EventRecorder
from ..kernel.runtime import Result
from ..kernel.store import Key, Store
from ..engine.types import Tool
from ..llmclient.base import LLMRequestError, tool_from_contact_channel
from ..llmclient.factory import LLMClientFactory, resolve_secret_key
from ..mcp.adapters import convert_mcp_tools, convert_sub_agents
from ..mcp.manager import MCPManager
from ..observability.metrics import REGISTRY
from ..observability.tracing import NOOP_TRACER, Tracer
from ..validation import (
    get_user_message_preview,
    generate_k8s_random_string,
    validate_contact_channel_ref,
    validate_task_message_input,
)

log = logging.getLogger("acp_tpu.task")

# Operational constants.
REQUEUE_DELAY = 5.0
LLM_LEASE_TTL = 30.0
NOTIFY_BACKOFF = (1.0, 2.0, 4.0)


@dataclass
class _EarlyDispatch:
    """One turn's overlapped tool dispatch: the request_id minted before
    the LLM call, the calls whose CRs were already created (in stream
    order), and whether a creation failed (forces the fresh-request_id
    fallback at fan-out)."""

    request_id: str
    records: list = field(default_factory=list)  # MessageToolCall, in order
    failed: bool = False


@dataclass
class TaskReconciler:
    store: Store
    recorder: EventRecorder
    llm_factory: LLMClientFactory
    mcp_manager: Optional[MCPManager] = None
    hl_factory: Optional[HumanLayerClientFactory] = None
    tracer: Tracer = field(default_factory=lambda: NOOP_TRACER)
    identity: str = "acp-tpu-0"
    requeue_delay: float = REQUEUE_DELAY
    # per-task in-memory mutex map
    _locks: dict[str, asyncio.Lock] = field(default_factory=dict)
    _notify_tasks: set = field(default_factory=set)

    # ------------------------------------------------------------------

    def _lock_for(self, key: str) -> asyncio.Lock:
        if key not in self._locks:
            self._locks[key] = asyncio.Lock()
        return self._locks[key]

    async def reconcile(self, key: Key) -> Result:
        _, ns, name = key
        task = self.store.try_get("Task", name, ns)
        if task is None:
            self._locks.pop(f"{ns}/{name}", None)
            return Result.done()
        assert isinstance(task, Task)
        phase = task.status.phase

        if phase == "":
            return self._initialize(task)
        if phase in (TASK_PHASE_INITIALIZING, TASK_PHASE_PENDING):
            return self._validate_agent_and_prepare(task)
        if phase == TASK_PHASE_READY_FOR_LLM:
            return await self._send_llm_request(task)
        if phase == TASK_PHASE_TOOL_CALLS_PENDING:
            return self._check_tool_calls(task)
        if phase in (TASK_PHASE_FINAL_ANSWER, TASK_PHASE_FAILED):
            return Result.done()
        return Result.done()

    # -- phase "": initialize ----------------

    def _initialize(self, task: Task) -> Result:
        span = self.tracer.start_span(
            "Task", attributes={"task": task.name, "agent": task.spec.agent_ref.name}
        )
        task.status.phase = TASK_PHASE_INITIALIZING
        task.status.status = "Pending"
        task.status.status_detail = "Initializing Task"
        task.status.span_context = span.context()
        self._update_status(task)
        return Result(requeue=True)

    # -- Initializing|Pending: validate + prepare -------------

    def _validate_agent_and_prepare(self, task: Task) -> Result:
        agent = self.store.try_get("Agent", task.spec.agent_ref.name, task.namespace)
        if agent is None or not agent.status.ready:
            detail = (
                f'Waiting for Agent "{task.spec.agent_ref.name}" to exist'
                if agent is None
                else f'Waiting for Agent "{task.spec.agent_ref.name}" to become ready'
            )
            if task.status.phase != TASK_PHASE_PENDING or task.status.status_detail != detail:
                task.status.phase = TASK_PHASE_PENDING
                task.status.status = "Pending"
                task.status.status_detail = detail
                self._update_status(task)
                self.recorder.event(task, "Normal", "Waiting", detail)
            return Result.after(self.requeue_delay)
        assert isinstance(agent, Agent)

        try:
            validate_task_message_input(task.spec.user_message, task.spec.context_window)
            validate_contact_channel_ref(self.store, task)
        except Invalid as e:
            task.status.phase = TASK_PHASE_FAILED
            task.status.status = "Error"
            task.status.error = str(e)
            task.status.status_detail = f"Validation failed: {e}"
            self._update_status(task)
            self.recorder.event(task, "Warning", "ValidationFailed", str(e))
            self._end_task_span(task, "ERROR")
            return Result.done()

        task.status.context_window = build_initial_context_window(
            task.spec.context_window or [], agent.spec.system, task.spec.user_message or ""
        )
        task.status.message_count = len(task.status.context_window)
        task.status.user_msg_preview = get_user_message_preview(
            task.spec.user_message, task.spec.context_window
        )
        task.status.phase = TASK_PHASE_READY_FOR_LLM
        task.status.status = "Ready"
        task.status.status_detail = "Ready to send to LLM"
        self._update_status(task)
        self.recorder.event(task, "Normal", "ValidationSucceeded", "Task validated successfully")
        return Result(requeue=True)

    # -- ReadyForLLM: the hot path -----------------------------

    async def _send_llm_request(self, task: Task) -> Result:
        lock_key = f"{task.namespace}/{task.name}"
        lock = self._lock_for(lock_key)
        if lock.locked():
            return Result.after(self.requeue_delay)
        async with lock:
            lease_name = f"task-llm-{task.name}"
            if not leaselib.try_acquire(
                self.store, lease_name, self.identity, task.namespace, ttl=LLM_LEASE_TTL
            ):
                return Result.after(self.requeue_delay)
            try:
                return await self._send_llm_request_locked(task)
            finally:
                leaselib.release(self.store, lease_name, self.identity, task.namespace)

    async def _send_llm_request_locked(self, task: Task) -> Result:
        # Re-fetch: the lease wait may have raced another replica's update.
        fresh = self.store.try_get("Task", task.name, task.namespace)
        if fresh is None or fresh.status.phase != TASK_PHASE_READY_FOR_LLM:
            return Result.done()
        task = fresh  # type: ignore[assignment]
        assert isinstance(task, Task)

        agent = self.store.try_get("Agent", task.spec.agent_ref.name, task.namespace)
        if agent is None or not agent.status.ready:
            task.status.phase = TASK_PHASE_PENDING
            task.status.status = "Pending"
            task.status.status_detail = "Agent no longer ready"
            self._update_status(task)
            return Result.after(self.requeue_delay)
        assert isinstance(agent, Agent)

        # LLM + credentials
        try:
            llm = self.store.get("LLM", agent.spec.llm_ref.name, task.namespace)
            assert isinstance(llm, LLM)
            engine_handle = getattr(self.llm_factory, "engine", None)
            if llm.spec.provider == "tpu" and engine_handle is None:
                # multi-replica: THIS replica has no serving engine (a
                # follower joined for control-plane capacity). Leave the
                # task for the engine-owning replica instead of burning a
                # failed send + error churn; the lease releases in our
                # caller's finally, so the owner's next attempt wins it.
                task.status.status_detail = (
                    "waiting for an engine-serving replica (provider: tpu)"
                )
                self._update_status(task)
                return Result.after(self.requeue_delay)
            # a fleet router's replica pool (ROADMAP A.12); a bare engine
            # has none
            fleet_pool = getattr(engine_handle, "pool", None)
            if (
                llm.spec.provider == "tpu"
                and fleet_pool is not None
                and not fleet_pool.alive()
            ):
                # the handle is a fleet router whose every replica is dead
                # or unregistered: requeue rather than burn a guaranteed
                # "no live replicas" failure — a replica (re)joining the
                # pool makes the next attempt succeed
                task.status.status_detail = (
                    "waiting for a live fleet replica (provider: tpu)"
                )
                self._update_status(task)
                return Result.after(self.requeue_delay)
            api_key = resolve_secret_key(self.store, task.namespace, llm.spec.api_key_from)
            client = await self.llm_factory.create_client(llm, api_key)
        except (NotFound, Invalid) as e:
            return self._llm_request_failed(task, LLMRequestError(500, str(e)))

        tools = self._collect_tools(task, agent)

        span = self.tracer.start_span(
            "LLMRequest",
            parent=task.status.span_context,
            attributes={
                "messages": len(task.status.context_window),
                "tools": len(tools),
                "provider": llm.spec.provider,
                "model": llm.spec.parameters.model,
            },
        )
        self.recorder.event(
            task, "Normal", "SendingContextWindowToLLM", "Sending context window to LLM"
        )
        outbound = task.status.context_window
        if agent.spec.context_policy is not None:
            outbound = compact_window(
                outbound, agent.spec.context_policy.max_messages
            )
        # Overlapped tool execution: when the client stream-parses tool
        # calls, create each ToolCall CR the moment its arguments close —
        # the ToolCall controller starts executing (approval gate included)
        # while the model is still decoding the rest of the turn. The
        # definitive fan-out below reconciles against these early CRs; a
        # mismatch (or a failed/errored turn) orphans them — they may
        # execute, which is the at-least-once posture this control plane
        # already has everywhere (the join selector keys on request_id, so
        # orphans never contaminate the context window).
        early: Optional[_EarlyDispatch] = None
        send_kwargs: dict = {}
        if tools and getattr(client, "supports_early_tool_calls", False):
            early = _EarlyDispatch(request_id=generate_k8s_random_string(7))
            tool_types = {t.function.name: t.acp_tool_type for t in tools}

            def _on_tool_call(idx: int, tc, _task=task, _early=early):
                if _early.failed:
                    return
                name = f"{_task.name}-{_early.request_id}-tc-{idx + 1:02d}"
                try:
                    self._create_tool_call(
                        _task, name, _early.request_id, tc.id,
                        tc.function.name, tc.function.arguments,
                        tool_types.get(tc.function.name, "MCP"),
                    )
                except Exception:
                    # fan-out falls back to a fresh request_id; the turn
                    # itself must not die on an early-dispatch failure
                    log.exception("early ToolCall create failed for %s", _task.name)
                    _early.failed = True
                    return
                _early.records.append(tc)
                REGISTRY.counter_add(
                    "acp_task_early_toolcalls_total", 1.0,
                    help="ToolCall CRs created from streamed tool calls "
                    "before the turn's generation finished",
                )

            send_kwargs["on_tool_call"] = _on_tool_call
        if getattr(client, "supports_trace_context", False):
            # a client whose engine exports per-phase child spans under THIS
            # LLMRequest span (the flight recorder, ROADMAP A.11)
            send_kwargs["trace_context"] = span.context()
        try:
            response = await client.send_request(outbound, tools, **send_kwargs)
        except LLMRequestError as e:
            self.tracer.end_span(span, "ERROR")
            self._orphan_early(task, early, f"turn failed: {e}")
            return self._llm_request_failed(task, e)
        except Exception as e:  # transport/unknown: retryable
            self.tracer.end_span(span, "ERROR")
            self._orphan_early(task, early, f"turn failed: {e}")
            return self._llm_request_failed(task, LLMRequestError(500, str(e)))
        finally:
            await client.close()
        self.tracer.end_span(span)
        return self._process_llm_response(task, response, tools, early)

    def _orphan_early(self, task: Task, early: Optional[_EarlyDispatch], why: str) -> None:
        """Account for early-created ToolCall CRs this turn is abandoning
        (failed send, content-only final parse, or early/definitive
        divergence). They may execute — the at-least-once posture — but
        their results never join (the join selector keys on request_id);
        the counter is the operator's signal that spurious executions
        happened."""
        if early is None or not early.records:
            return
        log.warning(
            "task %s: orphaning %d early-dispatched tool call(s): %s",
            task.name, len(early.records), why,
        )
        REGISTRY.counter_add(
            "acp_task_early_toolcalls_orphaned_total", float(len(early.records)),
            help="early-created ToolCall CRs abandoned (failed turn, "
            "content-only final parse, or early/definitive divergence)",
        )
        early.records.clear()  # never double-count one turn's orphans

    def _llm_request_failed(self, task: Task, err: LLMRequestError) -> Result:
        """4xx -> terminal Failed; else keep phase and retry.
        Overload responses (503 shed by the engine's bounded admission
        queue, 429 rate limits) retry with JITTERED backoff so a fleet of
        shed tasks doesn't re-converge on the engine in one synchronized
        wave and get shed again."""
        self.recorder.event(task, "Warning", "LLMRequestFailed", str(err))
        if err.terminal:
            task.status.phase = TASK_PHASE_FAILED
            task.status.status = "Error"
            task.status.error = str(err)
            task.status.status_detail = str(err)
            self._update_status(task)
            self._end_task_span(task, "ERROR")
            return Result.done()
        task.status.status = "Error"
        task.status.status_detail = f"LLM request failed (will retry): {err}"
        task.status.error = str(err)
        self._update_status(task)
        if err.status_code in (429, 503):
            return Result.after(self.requeue_delay * (1.0 + random.random()))
        return Result.after(self.requeue_delay)

    # -- tool collection ------------

    def _collect_tools(self, task: Task, agent: Agent) -> list[Tool]:
        tools: list[Tool] = []
        if self.mcp_manager is not None:
            for resolved in agent.status.valid_mcp_servers:
                mcp_tools = self.mcp_manager.get_tools(resolved.name)
                tools.extend(convert_mcp_tools(mcp_tools, resolved.name))
        for channel_name in agent.status.valid_human_contact_channels:
            channel = self.store.try_get("ContactChannel", channel_name, task.namespace)
            if isinstance(channel, ContactChannel):
                tools.append(tool_from_contact_channel(channel))
        sub_agents = [
            a
            for a in (
                self.store.try_get("Agent", s.name, task.namespace)
                for s in agent.status.valid_sub_agents
            )
            if isinstance(a, Agent)
        ]
        tools.extend(convert_sub_agents(sub_agents))
        return tools

    # -- response processing -------------------------

    def _process_llm_response(
        self,
        task: Task,
        response: Message,
        tools: list[Tool],
        early: Optional[_EarlyDispatch] = None,
    ) -> Result:
        if response.tool_calls:
            return self._fan_out_tool_calls(task, response, tools, early)
        # content-only final parse: any early CRs are orphans (degenerate —
        # the stream saw call-shaped text the batch parse rejected)
        self._orphan_early(task, early, "final parse yielded no tool calls")
        if task.metadata.labels.get(LABEL_V1BETA3) == "true" and task.spec.contact_channel_ref:
            # v1beta3: final answers become respond_to_human tool calls
            return self._fan_out_respond_to_human(task, response)
        # Final answer
        task.status.context_window = task.status.context_window + [
            Message(role="assistant", content=response.content)
        ]
        task.status.message_count = len(task.status.context_window)
        task.status.phase = TASK_PHASE_FINAL_ANSWER
        task.status.status = "Ready"
        task.status.status_detail = "LLM final response received"
        task.status.output = response.content
        self._update_status(task)
        self.recorder.event(task, "Normal", "LLMFinalAnswer", "Task completed with final answer")
        if task.spec.contact_channel_ref is not None and self.hl_factory is not None:
            notify = asyncio.ensure_future(self._notify_final_answer(task))
            self._notify_tasks.add(notify)
            notify.add_done_callback(self._notify_tasks.discard)
        self._end_task_span(task, "OK")
        return Result.done()

    def _fan_out_tool_calls(
        self,
        task: Task,
        response: Message,
        tools: list[Tool],
        early: Optional[_EarlyDispatch] = None,
    ) -> Result:
        tool_types = {t.function.name: t.acp_tool_type for t in tools}
        calls = list(response.tool_calls)
        # Reconcile against early-dispatched CRs: adopt them iff the early
        # stream is a positional prefix of the definitive batch parse (same
        # names and arguments, in order) — then those CRs (already
        # executing) ARE this turn's fan-out, and the context window takes
        # the early call objects so its ids match their tool_call_ids.
        # Any divergence (a creation failure, or degenerate output where
        # the stream scan and the fenced-preference batch rule disagree)
        # falls back to a fresh request_id: the early CRs are orphaned —
        # possibly executed, never joined — and the definitive set is
        # created from scratch. Dispatch moves WHEN execution starts,
        # never what the conversation records.
        pre_created = 0
        request_id = generate_k8s_random_string(7)
        if early is not None and early.records and not early.failed:
            recs = early.records
            if len(recs) <= len(calls) and all(
                r.function.name == calls[i].function.name
                and r.function.arguments == calls[i].function.arguments
                for i, r in enumerate(recs)
            ):
                calls[: len(recs)] = recs
                request_id = early.request_id
                pre_created = len(recs)
            else:
                self._orphan_early(
                    task, early,
                    f"diverged from the final parse ({len(recs)} early vs "
                    f"{len(calls)} final)",
                )
        response.tool_calls = calls
        task.status.context_window = task.status.context_window + [
            Message(role="assistant", content="", tool_calls=calls)
        ]
        task.status.message_count = len(task.status.context_window)
        task.status.phase = TASK_PHASE_TOOL_CALLS_PENDING
        task.status.status = "Ready"
        task.status.status_detail = f"LLM requested {len(calls)} tool call(s)"
        task.status.tool_call_request_id = request_id
        self._update_status(task)  # status FIRST, then create children

        try:
            for i, tc in enumerate(calls):
                if i < pre_created:
                    continue  # created while the model was still decoding
                name = f"{task.name}-{request_id}-tc-{i + 1:02d}"
                tool_type = tool_types.get(tc.function.name, "MCP")
                self._create_tool_call(task, name, request_id, tc.id, tc.function.name, tc.function.arguments, tool_type)
        except Exception as e:
            # Partial fan-out would leave the context window declaring N tool
            # calls with < N results (providers reject that) — fail the Task
            # with the real cause instead of wedging in ToolCallsPending.
            task.status.phase = TASK_PHASE_FAILED
            task.status.status = "Error"
            task.status.error = f"failed to create tool calls: {e}"
            task.status.status_detail = task.status.error
            self._update_status(task)
            self.recorder.event(task, "Warning", "ToolCallCreationFailed", str(e))
            self._end_task_span(task, "ERROR")
            return Result.done()
        self.recorder.event(
            task,
            "Normal",
            "ToolCallsPending",
            f"Created {len(response.tool_calls)} tool call(s), request {request_id}",
        )
        return Result.after(self.requeue_delay)

    def _fan_out_respond_to_human(self, task: Task, response: Message) -> Result:
        request_id = generate_k8s_random_string(7)
        call_id = f"call_{generate_k8s_random_string(8)}"
        task.status.context_window = task.status.context_window + [
            Message(role="assistant", content=response.content)
        ]
        task.status.message_count = len(task.status.context_window)
        task.status.phase = TASK_PHASE_TOOL_CALLS_PENDING
        task.status.status = "Ready"
        task.status.status_detail = "Responding to human (v1beta3)"
        task.status.tool_call_request_id = request_id
        self._update_status(task)
        self._create_tool_call(
            task,
            f"{task.name}-{request_id}-tc-01",
            request_id,
            call_id,
            "respond_to_human",
            json.dumps({"content": response.content}),
            "HumanContact",
        )
        self.recorder.event(task, "Normal", "RespondToHuman", "Final answer routed to human channel")
        return Result.after(self.requeue_delay)

    def _create_tool_call(
        self,
        task: Task,
        name: str,
        request_id: str,
        call_id: str,
        tool_name: str,
        arguments: str,
        tool_type: str,
    ) -> None:
        tc = ToolCall(
            metadata=ObjectMeta(
                name=name,
                namespace=task.namespace,
                labels={
                    LABEL_TASK: task.name,
                    LABEL_TOOL_CALL_REQUEST: request_id,
                    **(
                        {LABEL_V1BETA3: "true"}
                        if task.metadata.labels.get(LABEL_V1BETA3) == "true"
                        else {}
                    ),
                },
                owner_references=[task.owner_ref()],
            ),
            spec=ToolCallSpec(
                tool_call_id=call_id,
                task_ref=LocalObjectRef(name=task.name),
                tool_ref=LocalObjectRef(name=tool_name),
                tool_type=tool_type,  # type: ignore[arg-type]
                arguments=arguments,
            ),
        )
        try:
            self.store.create(tc)
        except AlreadyExists:
            pass  # idempotent under requeue

    # -- ToolCallsPending: join --------------------------------

    def _check_tool_calls(self, task: Task) -> Result:
        selector = {LABEL_TASK: task.name}
        if task.status.tool_call_request_id:
            selector[LABEL_TOOL_CALL_REQUEST] = task.status.tool_call_request_id
        tool_calls = [
            tc
            for tc in self.store.list("ToolCall", task.namespace, label_selector=selector)
            if isinstance(tc, ToolCall)
        ]
        terminal = {TC_PHASE_SUCCEEDED, TC_PHASE_FAILED, TC_PHASE_REJECTED}
        if not tool_calls or any(tc.status.phase not in terminal for tc in tool_calls):
            return Result.after(self.requeue_delay)

        # v1beta3 respond_to_human: the "tool result" loop ends the task.
        if (
            task.metadata.labels.get(LABEL_V1BETA3) == "true"
            and len(tool_calls) == 1
            and tool_calls[0].spec.tool_ref.name == "respond_to_human"
        ):
            delivery = tool_calls[0]
            if delivery.status.phase == TC_PHASE_FAILED:
                task.status.phase = TASK_PHASE_FAILED
                task.status.status = "Error"
                task.status.error = f"respond_to_human failed: {delivery.status.error}"
                task.status.status_detail = task.status.error
                self._update_status(task)
                self.recorder.event(task, "Warning", "RespondToHumanFailed", delivery.status.error)
                self._end_task_span(task, "ERROR")
                return Result.done()
            task.status.phase = TASK_PHASE_FINAL_ANSWER
            task.status.status = "Ready"
            task.status.status_detail = "Human response delivered"
            task.status.output = task.status.context_window[-1].content
            self._update_status(task)
            self._end_task_span(task, "OK")
            return Result.done()

        tool_calls.sort(key=lambda tc: tc.metadata.name)
        results = [
            Message(
                role="tool",
                content=tc.status.result
                if tc.status.phase != TC_PHASE_FAILED
                else (tc.status.result or f"error: {tc.status.error}"),
                tool_call_id=tc.spec.tool_call_id,
            )
            for tc in tool_calls
        ]
        task.status.context_window = task.status.context_window + results
        task.status.message_count = len(task.status.context_window)
        task.status.phase = TASK_PHASE_READY_FOR_LLM
        task.status.status = "Ready"
        task.status.status_detail = "All tool calls completed, ready to send tool results to LLM"
        self._update_status(task)
        self.recorder.event(
            task, "Normal", "AllToolCallsCompleted", f"{len(tool_calls)} tool call(s) completed"
        )
        return Result(requeue=True)

    # -- final-answer notification -----------------------------

    async def _notify_final_answer(self, task: Task) -> None:
        assert self.hl_factory is not None
        ref = task.spec.contact_channel_ref
        assert ref is not None
        channel = self.store.try_get("ContactChannel", ref.name, task.namespace)
        if not isinstance(channel, ContactChannel):
            return
        api_key = ""
        try:
            if task.spec.channel_token_from is not None:
                api_key = resolve_secret_key(self.store, task.namespace, task.spec.channel_token_from)
            elif channel.spec.api_key_from is not None:
                api_key = resolve_secret_key(self.store, task.namespace, channel.spec.api_key_from)
        except Invalid:
            pass
        client = self.hl_factory.create_client(api_key)
        for attempt, delay in enumerate(NOTIFY_BACKOFF):
            try:
                await client.request_human_contact(
                    run_id=task.name,
                    call_id=f"{task.name}-notify",
                    message=task.status.output,
                    channel=channel_payload(channel, task.spec.thread_id),
                )
                return
            except Exception:
                if attempt == len(NOTIFY_BACKOFF) - 1:
                    log.warning("final-answer notification failed for %s", task.name)
                    return
                await asyncio.sleep(delay)

    # -- helpers ---------------------------------------------------------

    def _update_status(self, task: Task) -> None:
        try:
            updated = self.store.update_status(task)
        except Conflict:
            updated = self.store.mutate_status(
                "Task",
                task.name,
                task.namespace,
                lambda fresh: fresh.__setattr__("status", task.status),
            )
        task.metadata.resource_version = updated.metadata.resource_version

    def _end_task_span(self, task: Task, status: str) -> None:
        if task.status.span_context is None:
            return
        span = self.tracer.start_span("EndTaskSpan", parent=task.status.span_context)
        span.set_attribute("phase", task.status.phase)
        self.tracer.end_span(span, status)


def compact_window(window: list[Message], max_messages: int) -> list[Message]:
    """Send-side compaction for long conversations (AgentSpec.contextPolicy):
    keeps the leading system messages and the most recent suffix within
    ``max_messages``, starting the suffix at a protocol-safe boundary (never
    a tool result whose requesting assistant message was dropped). The
    elided span is summarized by a marker message. The persisted history in
    Task.status is untouched — this shapes only what the LLM sees."""
    if max_messages <= 0 or len(window) <= max_messages:
        return window
    head = []
    for m in window:
        if m.role != "system":
            break
        head.append(m)
    body = window[len(head) :]
    budget = max_messages - len(head) - 1  # -1 for the elision marker
    if budget < 1:
        budget = 1
    suffix = body[-budget:]
    # protocol-safe start: drop leading tool results orphaned by the cut
    while suffix and suffix[0].role == "tool":
        suffix = suffix[1:]
    elided = len(body) - len(suffix)
    marker = Message(
        role="system",
        content=f"[{elided} earlier message(s) elided to fit the context policy]",
    )
    return head + [marker] + suffix


def build_initial_context_window(
    context_window: list[Message], system_prompt: str, user_message: str
) -> list[Message]:
    """Pure context-window construction: a provided window gets the agent's
    system prompt prepended iff it has none; otherwise [system, user]."""
    if context_window:
        window = list(context_window)
        if not any(m.role == "system" for m in window):
            window = [Message(role="system", content=system_prompt)] + window
        return window
    return [
        Message(role="system", content=system_prompt),
        Message(role="user", content=user_message),
    ]


def channel_payload(channel: ContactChannel, thread_id: Optional[str] = None) -> dict:
    """Serialize a channel for the human-layer API (slack/email payloads)."""
    if channel.spec.type == "slack" and channel.spec.slack is not None:
        payload = {
            "slack": {
                "channel_or_user_id": channel.spec.slack.channel_or_user_id
                or channel.spec.channel_id
                or "",
                "context_about_channel_or_user": channel.spec.slack.context_about_channel_or_user,
            }
        }
        if thread_id:
            payload["slack"]["thread_ts"] = thread_id
        return payload
    if channel.spec.type == "email" and channel.spec.email is not None:
        return {
            "email": {
                "address": channel.spec.email.address,
                "context_about_user": channel.spec.email.context_about_user,
            }
        }
    return {}
