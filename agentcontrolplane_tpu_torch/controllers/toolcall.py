"""ToolCall controller: executes one tool call, with approval gating (the
port's copy of the reference's ``controllers/toolcall.py``).

    ""                      -> initialize the span + Pending/Pending
    Pending/Pending         -> setup (Status=Ready)
    Pending/Ready           -> approval check: MCP tools whose server has an
                               approval ContactChannel go to a human first
    AwaitingHumanApproval   -> poll; approved -> ReadyToExecuteApprovedTool,
                               rejected -> ToolCallRejected with
                               Result="Rejected: <comment>" and
                               Status=Succeeded (the LLM sees the rejection
                               as a tool result)
    ReadyToExecuteApprovedTool -> execute
    execute routes on ToolType: MCP call | child Task (delegation) |
                               human contact request
    AwaitingSubAgent        -> join the child Task by its parent-toolcall
                               label
    AwaitingHumanInput      -> poll the human contact's status

The deterministic fault sites ``tool.slow`` and ``tool.error``
(``faults.py``) stretch or fail an MCP execution.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Optional

from ..api.meta import ObjectMeta
from ..api.resources import (
    LABEL_PARENT_TOOLCALL,
    LABEL_V1BETA3,
    Agent,
    ContactChannel,
    LocalObjectRef,
    MCPServer,
    Task,
    TaskSpec,
    ToolCall,
    TASK_PHASE_FAILED,
    TASK_PHASE_FINAL_ANSWER,
    TC_PHASE_AWAITING_HUMAN_APPROVAL,
    TC_PHASE_AWAITING_HUMAN_INPUT,
    TC_PHASE_AWAITING_SUB_AGENT,
    TC_PHASE_ERR_REQUESTING_APPROVAL,
    TC_PHASE_ERR_REQUESTING_INPUT,
    TC_PHASE_FAILED,
    TC_PHASE_PENDING,
    TC_PHASE_READY_TO_EXECUTE,
    TC_PHASE_REJECTED,
    TC_PHASE_RUNNING,
    TC_PHASE_SUCCEEDED,
)
from ..faults import FAULTS
from ..humanlayer.client import FunctionCallSpec, HumanLayerClientFactory
from ..kernel.errors import AlreadyExists, Conflict, NotFound
from ..kernel.events import EventRecorder
from ..kernel.runtime import Result
from ..kernel.store import Key, Store
from ..llmclient.factory import resolve_secret_key
from ..mcp.adapters import parse_tool_arguments, split_tool_name
from ..mcp.manager import MCPManager
from ..observability.tracing import NOOP_TRACER, Tracer
from .task import channel_payload

log = logging.getLogger("acp_tpu.toolcall")

POLL_INTERVAL = 5.0
POLL_INTERVAL_AFTER_ERROR = 15.0


@dataclass
class ToolCallReconciler:
    store: Store
    recorder: EventRecorder
    mcp_manager: Optional[MCPManager] = None
    hl_factory: Optional[HumanLayerClientFactory] = None
    tracer: Tracer = field(default_factory=lambda: NOOP_TRACER)
    poll_interval: float = POLL_INTERVAL

    async def reconcile(self, key: Key) -> Result:
        _, ns, name = key
        tc = self.store.try_get("ToolCall", name, ns)
        if tc is None:
            return Result.done()
        assert isinstance(tc, ToolCall)

        if tc.status.span_context is None:
            self._initialize_span(tc)

        phase, status = tc.status.phase, tc.status.status
        if phase == "":
            return self._initialize(tc)
        if phase == TC_PHASE_PENDING and status == "Pending":
            return self._setup(tc)
        if phase == TC_PHASE_PENDING and status == "Ready":
            return await self._check_approval(tc)
        if phase == TC_PHASE_AWAITING_HUMAN_APPROVAL:
            return await self._wait_for_approval(tc)
        if phase == TC_PHASE_ERR_REQUESTING_APPROVAL:
            return await self._check_approval(tc)
        if phase == TC_PHASE_READY_TO_EXECUTE:
            return await self._execute(tc)
        if phase == TC_PHASE_RUNNING:
            # durable-state resume: the operator died mid-execution; re-run
            # the tool (at-least-once semantics, like the reference's requeue)
            return await self._execute(tc)
        if phase == TC_PHASE_AWAITING_SUB_AGENT:
            return self._wait_for_sub_agent(tc)
        if phase in (TC_PHASE_AWAITING_HUMAN_INPUT, TC_PHASE_ERR_REQUESTING_INPUT):
            return await self._wait_for_human_input(tc)
        return Result.done()  # terminal

    # ------------------------------------------------------------------

    def _initialize_span(self, tc: ToolCall) -> None:
        parent = None
        task = self.store.try_get("Task", tc.spec.task_ref.name, tc.namespace)
        if isinstance(task, Task):
            parent = task.status.span_context
        span = self.tracer.start_span(
            "ToolCall", parent=parent, attributes={"tool": tc.spec.tool_ref.name}
        )
        tc.status.span_context = span.context()
        self._update_status(tc)

    def _initialize(self, tc: ToolCall) -> Result:
        tc.status.phase = TC_PHASE_PENDING
        tc.status.status = "Pending"
        tc.status.status_detail = "Initializing"
        tc.status.start_time = time.time()
        self._update_status(tc)
        return Result(requeue=True)

    def _setup(self, tc: ToolCall) -> Result:
        tc.status.status = "Ready"
        tc.status.status_detail = "Ready for execution"
        self._update_status(tc)
        return Result(requeue=True)

    # -- approval gate -----

    class _ApprovalGateBroken(Exception):
        """Approval is required but its channel cannot be resolved — the gate
        must fail CLOSED (never execute an approval-gated tool unapproved)."""

    def _approval_channel(self, tc: ToolCall) -> Optional[ContactChannel]:
        """Only MCP tools can require approval: the server's
        ApprovalContactChannel gates all of its tools. Raises
        _ApprovalGateBroken if approval is configured but unresolvable."""
        if tc.spec.tool_type != "MCP":
            return None
        try:
            server_name, _ = split_tool_name(tc.spec.tool_ref.name)
        except ValueError:
            return None  # malformed names fail later in execute, never gated
        server = self.store.try_get("MCPServer", server_name, tc.namespace)
        if not isinstance(server, MCPServer) or not server.spec.approval_contact_channel:
            return None
        channel = self.store.try_get(
            "ContactChannel", server.spec.approval_contact_channel, tc.namespace
        )
        if not isinstance(channel, ContactChannel):
            raise self._ApprovalGateBroken(
                f'approval ContactChannel "{server.spec.approval_contact_channel}" not found'
            )
        return channel

    def _hl_client(self, tc: ToolCall, channel: Optional[ContactChannel]):
        assert self.hl_factory is not None
        api_key = ""
        if channel is not None and channel.spec.api_key_from is not None:
            try:
                api_key = resolve_secret_key(self.store, tc.namespace, channel.spec.api_key_from)
            except Exception:
                pass
        elif channel is not None and channel.spec.channel_api_key_from is not None:
            try:
                api_key = resolve_secret_key(
                    self.store, tc.namespace, channel.spec.channel_api_key_from
                )
            except Exception:
                pass
        return self.hl_factory.create_client(api_key)

    async def _check_approval(self, tc: ToolCall) -> Result:
        try:
            channel = self._approval_channel(tc)
        except self._ApprovalGateBroken as e:
            tc.status.phase = TC_PHASE_ERR_REQUESTING_APPROVAL
            tc.status.status = "Error"
            tc.status.status_detail = str(e)
            self._update_status(tc)
            self.recorder.event(tc, "Warning", "ApprovalGateBroken", str(e))
            return Result.after(POLL_INTERVAL_AFTER_ERROR)
        if channel is not None and self.hl_factory is None:
            # approval required but no human-layer wiring: fail CLOSED
            tc.status.phase = TC_PHASE_ERR_REQUESTING_APPROVAL
            tc.status.status = "Error"
            tc.status.status_detail = "approval required but no human-layer client configured"
            self._update_status(tc)
            self.recorder.event(
                tc, "Warning", "ApprovalGateBroken", tc.status.status_detail
            )
            return Result.after(POLL_INTERVAL_AFTER_ERROR)
        if channel is None:
            return await self._execute(tc)
        client = self._hl_client(tc, channel)
        try:
            args = parse_tool_arguments(tc.spec.arguments)
        except ValueError:
            args = {"_raw": tc.spec.arguments}
        try:
            call_id = await client.request_approval(
                run_id=tc.name,
                call_id=tc.name,
                spec=FunctionCallSpec(
                    fn=tc.spec.tool_ref.name, kwargs=args, channel=channel_payload(channel)
                ),
            )
        except Exception as e:
            tc.status.phase = TC_PHASE_ERR_REQUESTING_APPROVAL
            tc.status.status = "Error"
            tc.status.status_detail = f"Error requesting approval: {e}"
            self._update_status(tc)
            self.recorder.event(tc, "Warning", "ApprovalRequestFailed", str(e))
            return Result.after(POLL_INTERVAL_AFTER_ERROR)
        tc.status.external_call_id = call_id
        tc.status.phase = TC_PHASE_AWAITING_HUMAN_APPROVAL
        tc.status.status = "Ready"
        tc.status.status_detail = f"Awaiting approval via {channel.name}"
        self._update_status(tc)
        self.recorder.event(tc, "Normal", "AwaitingHumanApproval", f"Approval requested: {call_id}")
        return Result.after(self.poll_interval)

    async def _wait_for_approval(self, tc: ToolCall) -> Result:
        try:
            channel = self._approval_channel(tc)
        except self._ApprovalGateBroken:
            return Result.after(POLL_INTERVAL_AFTER_ERROR)
        client = self._hl_client(tc, channel)
        try:
            status = await client.get_function_call_status(tc.status.external_call_id)
        except KeyError:
            # The backend lost the call (e.g. operator restart with the
            # in-memory human backend): re-request approval rather than
            # polling a dead id forever.
            tc.status.phase = TC_PHASE_ERR_REQUESTING_APPROVAL
            tc.status.status = "Error"
            tc.status.status_detail = "approval request lost; re-requesting"
            self._update_status(tc)
            return Result(requeue=True)
        except Exception:
            return Result.after(POLL_INTERVAL_AFTER_ERROR)
        if status.approved is None:
            return Result.after(self.poll_interval)
        if status.approved:
            tc.status.phase = TC_PHASE_READY_TO_EXECUTE
            tc.status.status = "Ready"
            tc.status.status_detail = "Approved, ready to execute"
            self._update_status(tc)
            self.recorder.event(tc, "Normal", "ApprovalGranted", "Human approved tool execution")
            return Result(requeue=True)
        # Rejection becomes a *successful* tool result so the LLM sees it.
        tc.status.phase = TC_PHASE_REJECTED
        tc.status.status = "Succeeded"
        tc.status.result = f"Rejected: {status.comment}" if status.comment else "Rejected"
        tc.status.status_detail = "Tool call rejected by human"
        tc.status.completion_time = time.time()
        self._update_status(tc)
        self.recorder.event(tc, "Normal", "ApprovalRejected", tc.status.result)
        self._end_span(tc, "OK")
        return Result.done()

    # -- execution ---------------------------

    async def _execute(self, tc: ToolCall) -> Result:
        if tc.spec.tool_type == "MCP":
            return await self._execute_mcp(tc)
        if tc.spec.tool_type == "DelegateToAgent":
            return self._execute_delegate(tc)
        if tc.spec.tool_type == "HumanContact":
            return await self._execute_human_contact(tc)
        return self._fail(tc, f"unknown tool type {tc.spec.tool_type!r}")

    async def _execute_mcp(self, tc: ToolCall) -> Result:
        if self.mcp_manager is None:
            return self._fail(tc, "no MCP manager configured")
        try:
            server, tool = split_tool_name(tc.spec.tool_ref.name)
            args = parse_tool_arguments(tc.spec.arguments)
        except ValueError as e:
            return self._fail(tc, str(e))
        tc.status.phase = TC_PHASE_RUNNING
        tc.status.status = "Ready"
        tc.status.status_detail = f"Executing {server}/{tool}"
        self._update_status(tc)
        # the fault sites (faults.py): "tool.slow" stretches this execution
        # by ``seconds`` (a parked slot outliving a slow tool); "tool.error"
        # fails it, so the error joins the conversation as a tool result
        if FAULTS.enabled:
            slow = FAULTS.pop("tool.slow")
            if slow is not None:
                await asyncio.sleep(float(slow.get("seconds", 0.05)))
            if FAULTS.pop("tool.error") is not None:
                return self._fail(tc, "fault injection: tool error")
        try:
            result = await self.mcp_manager.call_tool(server, tool, args)
        except Exception as e:
            return self._fail(tc, f"MCP tool call failed: {e}")
        tc.status.phase = TC_PHASE_SUCCEEDED
        tc.status.status = "Succeeded"
        tc.status.result = result
        tc.status.status_detail = "Tool executed successfully"
        tc.status.completion_time = time.time()
        self._update_status(tc)
        self.recorder.event(tc, "Normal", "ExecutionSucceeded", f"{server}/{tool} completed")
        self._end_span(tc, "OK")
        return Result.done()

    def _execute_delegate(self, tc: ToolCall) -> Result:
        """Idempotently spawn the child Task; the whole Task loop runs
        recursively for the sub-agent."""
        agent_name = tc.spec.tool_ref.name.removeprefix("delegate_to_agent__")
        agent = self.store.try_get("Agent", agent_name, tc.namespace)
        if not isinstance(agent, Agent):
            return self._fail(tc, f'delegate target Agent "{agent_name}" not found')
        try:
            args = parse_tool_arguments(tc.spec.arguments)
        except ValueError as e:
            return self._fail(tc, str(e))
        message = args.get("message", "")
        if not message:
            return self._fail(tc, "delegate_to_agent requires a message argument")
        child_name = f"delegate-{tc.name}-{agent_name}"[:63].rstrip("-")
        child = Task(
            metadata=ObjectMeta(
                name=child_name,
                namespace=tc.namespace,
                labels={LABEL_PARENT_TOOLCALL: tc.name},
                owner_references=[tc.owner_ref()],
            ),
            spec=TaskSpec(agent_ref=LocalObjectRef(name=agent_name), user_message=message),
        )
        try:
            self.store.create(child)
            self.recorder.event(tc, "Normal", "SubAgentTaskCreated", f"Created child task {child_name}")
        except AlreadyExists:
            pass  # idempotent under requeue
        tc.status.phase = TC_PHASE_AWAITING_SUB_AGENT
        tc.status.status = "Ready"
        tc.status.status_detail = f"Delegated to agent {agent_name}"
        self._update_status(tc)
        return Result.after(self.poll_interval)

    def _wait_for_sub_agent(self, tc: ToolCall) -> Result:
        """Join child Task by label."""
        children = [
            t
            for t in self.store.list(
                "Task", tc.namespace, label_selector={LABEL_PARENT_TOOLCALL: tc.name}
            )
            if isinstance(t, Task)
        ]
        if not children:
            return Result.after(self.poll_interval)
        child = children[0]
        if child.status.phase == TASK_PHASE_FINAL_ANSWER:
            tc.status.phase = TC_PHASE_SUCCEEDED
            tc.status.status = "Succeeded"
            tc.status.result = child.status.output
            tc.status.status_detail = "Sub-agent completed"
            tc.status.completion_time = time.time()
            self._update_status(tc)
            self.recorder.event(tc, "Normal", "SubAgentCompleted", f"Child task {child.name} completed")
            self._end_span(tc, "OK")
            return Result.done()
        if child.status.phase == TASK_PHASE_FAILED:
            return self._fail(tc, f"sub-agent task failed: {child.status.error}")
        return Result.after(self.poll_interval)

    async def _execute_human_contact(self, tc: ToolCall) -> Result:
        if self.hl_factory is None:
            return self._fail(tc, "no human-layer client configured")
        try:
            args = parse_tool_arguments(tc.spec.arguments)
        except ValueError as e:
            return self._fail(tc, str(e))
        message = args.get("message", "")

        channel: Optional[ContactChannel] = None
        task = self.store.try_get("Task", tc.spec.task_ref.name, tc.namespace)
        if tc.spec.tool_ref.name == "respond_to_human":
            return await self._execute_respond_to_human(
                tc, args, task if isinstance(task, Task) else None
            )
        else:
            channel_name = tc.spec.tool_ref.name.split("__", 1)[0]
            ch = self.store.try_get("ContactChannel", channel_name, tc.namespace)
            channel = ch if isinstance(ch, ContactChannel) else None
        if channel is None:
            return self._fail(tc, f"contact channel for tool {tc.spec.tool_ref.name!r} not found")

        client = self._hl_client_for_contact(tc, channel, task if isinstance(task, Task) else None)
        thread_id = task.spec.thread_id if isinstance(task, Task) else None
        try:
            call_id = await client.request_human_contact(
                run_id=tc.name,
                call_id=tc.name,
                message=message,
                channel=channel_payload(channel, thread_id),
            )
        except Exception as e:
            tc.status.phase = TC_PHASE_ERR_REQUESTING_INPUT
            tc.status.status = "Error"
            tc.status.status_detail = f"Error requesting human input: {e}"
            self._update_status(tc)
            self.recorder.event(tc, "Warning", "HumanContactRequestFailed", str(e))
            return Result.after(POLL_INTERVAL_AFTER_ERROR)
        tc.status.external_call_id = call_id
        tc.status.phase = TC_PHASE_AWAITING_HUMAN_INPUT
        tc.status.status = "Ready"
        tc.status.status_detail = f"Awaiting human response via {channel.name}"
        self._update_status(tc)
        self.recorder.event(tc, "Normal", "AwaitingHumanInput", f"Human contacted: {call_id}")
        return Result.after(self.poll_interval)

    async def _execute_respond_to_human(
        self, tc: ToolCall, args: dict, task: Optional[Task]
    ) -> Result:
        """v1beta3 special case: deliver the final answer through the
        task's per-event channel token and succeed at once (a notification,
        not a question)."""
        if task is None:
            return self._fail(tc, "parent task not found")
        if task.metadata.labels.get(LABEL_V1BETA3) != "true":
            return self._fail(tc, "respond_to_human tool can only be used with v1beta3 tasks")
        content = args.get("content")
        if not isinstance(content, str) or not content:
            return self._fail(tc, "missing or invalid 'content' argument")
        if task.spec.channel_token_from is None:
            return self._fail(tc, "task does not have channelTokenFrom configured")
        try:
            token = resolve_secret_key(self.store, tc.namespace, task.spec.channel_token_from)
        except Exception as e:
            return self._fail(tc, f"failed to resolve channel token: {e}")
        channel = None
        if task.spec.contact_channel_ref is not None:
            ch = self.store.try_get(
                "ContactChannel", task.spec.contact_channel_ref.name, tc.namespace
            )
            channel = ch if isinstance(ch, ContactChannel) else None
        assert self.hl_factory is not None
        client = self.hl_factory.create_client(token)
        try:
            call_id = await client.request_human_contact(
                run_id=tc.spec.task_ref.name,
                call_id=tc.spec.tool_call_id,
                message=content,
                channel=channel_payload(channel, task.spec.thread_id) if channel else None,
            )
        except Exception as e:
            tc.status.phase = TC_PHASE_ERR_REQUESTING_INPUT
            tc.status.status = "Error"
            tc.status.status_detail = f"respond_to_human failed: {e}"
            self._update_status(tc)
            return Result.after(POLL_INTERVAL_AFTER_ERROR)
        tc.status.phase = TC_PHASE_SUCCEEDED
        tc.status.status = "Succeeded"
        tc.status.result = f"Response sent to human, call ID: {call_id}"
        tc.status.status_detail = "Response delivered"
        tc.status.completion_time = time.time()
        self._update_status(tc)
        self.recorder.event(tc, "Normal", "RespondedToHuman", tc.status.result)
        self._end_span(tc, "OK")
        return Result.done()

    def _hl_client_for_contact(self, tc: ToolCall, channel: ContactChannel, task: Optional[Task]):
        assert self.hl_factory is not None
        api_key = ""
        try:
            if task is not None and task.spec.channel_token_from is not None:
                api_key = resolve_secret_key(self.store, tc.namespace, task.spec.channel_token_from)
            elif channel.spec.api_key_from is not None:
                api_key = resolve_secret_key(self.store, tc.namespace, channel.spec.api_key_from)
            elif channel.spec.channel_api_key_from is not None:
                api_key = resolve_secret_key(self.store, tc.namespace, channel.spec.channel_api_key_from)
        except Exception:
            pass
        return self.hl_factory.create_client(api_key)

    async def _wait_for_human_input(self, tc: ToolCall) -> Result:
        if tc.status.phase == TC_PHASE_ERR_REQUESTING_INPUT:
            return await self._execute_human_contact(tc)
        assert self.hl_factory is not None
        task = self.store.try_get("Task", tc.spec.task_ref.name, tc.namespace)
        channel = self._contact_channel_for(tc)
        if channel is None and isinstance(task, Task) and task.spec.contact_channel_ref:
            ch = self.store.try_get(
                "ContactChannel", task.spec.contact_channel_ref.name, tc.namespace
            )
            channel = ch if isinstance(ch, ContactChannel) else None
        if channel is not None:
            client = self._hl_client_for_contact(
                tc, channel, task if isinstance(task, Task) else None
            )
        else:
            client = self.hl_factory.create_client("")
        try:
            status = await client.get_human_contact_status(tc.status.external_call_id)
        except KeyError:
            # backend lost the contact request (restart): re-request
            tc.status.phase = TC_PHASE_ERR_REQUESTING_INPUT
            tc.status.status = "Error"
            tc.status.status_detail = "contact request lost; re-requesting"
            self._update_status(tc)
            return Result(requeue=True)
        except Exception:
            return Result.after(POLL_INTERVAL_AFTER_ERROR)
        if status.response is None:
            return Result.after(self.poll_interval)
        tc.status.phase = TC_PHASE_SUCCEEDED
        tc.status.status = "Succeeded"
        tc.status.result = status.response
        tc.status.status_detail = "Human responded"
        tc.status.completion_time = time.time()
        self._update_status(tc)
        self.recorder.event(tc, "Normal", "HumanResponded", "Human input received")
        self._end_span(tc, "OK")
        return Result.done()

    def _contact_channel_for(self, tc: ToolCall) -> Optional[ContactChannel]:
        name = tc.spec.tool_ref.name.split("__", 1)[0]
        ch = self.store.try_get("ContactChannel", name, tc.namespace)
        return ch if isinstance(ch, ContactChannel) else None

    # -- helpers ---------------------------------------------------------

    def _fail(self, tc: ToolCall, error: str) -> Result:
        tc.status.phase = TC_PHASE_FAILED
        tc.status.status = "Error"
        tc.status.error = error
        tc.status.result = f"error: {error}"
        tc.status.status_detail = error
        tc.status.completion_time = time.time()
        self._update_status(tc)
        self.recorder.event(tc, "Warning", "ExecutionFailed", error)
        self._end_span(tc, "ERROR")
        return Result.done()

    def _update_status(self, tc: ToolCall) -> None:
        """Fetch-latest-then-update with conflict retry."""
        try:
            updated = self.store.update_status(tc)
        except Conflict:
            updated = self.store.mutate_status(
                "ToolCall",
                tc.name,
                tc.namespace,
                lambda fresh: fresh.__setattr__("status", tc.status),
            )
        except NotFound:
            return
        tc.metadata.resource_version = updated.metadata.resource_version

    def _end_span(self, tc: ToolCall, status: str) -> None:
        if tc.status.span_context is None:
            return
        span = self.tracer.start_span("EndToolCallSpan", parent=tc.status.span_context)
        self.tracer.end_span(span, status)
