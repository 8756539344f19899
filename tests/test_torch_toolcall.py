"""The port's ToolCall controller against the JAX package's, on the CPU.

Every case of the reference's ``tests/controllers/test_toolcall_controller.py``
(9) is replayed on both packages, one reconcile at a time, and so are
eight more paths that list does not reach (an approval gate whose channel
is missing, approval required with no human layer, a lost approval and a
lost contact after a backend restart, a child Task name cut to 63
characters, delegation to a missing Agent, the
v1beta3 respond-to-human delivery, and resuming a ToolCall left Running).
After every step the store is snapshotted as in ``test_torch_task.py``
(objects, Events, Leases, the ``Result``), with the human backend's
pending approvals and contacts and the fake MCP manager's calls; the two
packages' snapshots must be equal, exactly, after that file's
normalization. Span ids are compared by parentage: a ToolCall's trace is
its Task's. The cases are parametrised, not copied.
"""

import json

import pytest

from .test_torch_task import (
    PORT,
    REF,
    FakeMCPManager,
    make_agent,
    make_contactchannel,
    make_llm,
    make_mcpserver,
    make_secret,
    make_task,
    make_toolcall,
    normalized,
    random_ids,
    snapshot,
)

TC = "test-task-abc1234-tc-01"


class ToolCallHarness:
    """The reference test's harness: a ToolCall reconciler with a fake MCP
    manager (``fetch__fetch`` returns a page) and the local human backend."""

    def __init__(self, ns):
        self.ns = ns
        self.store = ns.K.Store()
        self.recorder = ns.K.EventRecorder(self.store)
        self.backend = ns.HL.LocalHumanBackend()
        self.mcp = FakeMCPManager(ns, results={"fetch__fetch": "<html>example</html>"})
        self.rec = ns.toolcall.ToolCallReconciler(
            store=self.store, recorder=self.recorder, mcp_manager=self.mcp,
            hl_factory=ns.HL.LocalHumanLayerClientFactory(self.backend))
        self.snaps = []

    async def step(self, name=TC):
        result = await self.rec.reconcile(("ToolCall", "default", name))
        snap = snapshot(self.store, result)
        snap["human"] = ([(a.call_id, a.run_id, a.fn, a.kwargs, a.channel, a.approved, a.comment)
                          for a in self.backend.approvals.values()],
                         [(c.call_id, c.run_id, c.message, c.channel, c.response)
                          for c in self.backend.contacts.values()])
        snap["mcp_calls"] = [list(c) for c in self.mcp.calls]
        self.snaps.append(snap)
        return result

    def make_task(self, **kw):
        """The parent Task, with a root span as its controller persists it."""
        task = make_task(self.ns, self.store, **kw)
        task.status.span_context = self.ns.R.SpanContext(trace_id="a" * 32, span_id="b" * 16)
        return self.store.update_status(task)

    async def to_ready(self, name=TC):
        await self.step(name)  # '' -> Pending/Pending (+ span)
        await self.step(name)  # -> Pending/Ready

    def tc(self, name=TC):
        return self.store.get("ToolCall", name)


async def case_initialize_then_setup(h):
    h.make_task()
    make_toolcall(h.ns, h.store)
    result = await h.step()
    assert (h.tc().status.phase, h.tc().status.status) == ("Pending", "Pending")
    assert h.tc().status.span_context is not None and result.requeue
    await h.step()
    assert (h.tc().status.phase, h.tc().status.status) == ("Pending", "Ready")


async def case_mcp_execution_without_approval(h):
    h.make_task()
    make_mcpserver(h.ns, h.store, "fetch")
    make_toolcall(h.ns, h.store)
    await h.to_ready()
    result = await h.step()
    tc = h.tc()
    assert (tc.status.phase, tc.status.result) == ("Succeeded", "<html>example</html>")
    assert tc.status.completion_time is not None and result.requeue_after is None
    assert h.mcp.calls == [("fetch", "fetch", {"url": "https://example.com"})]


async def case_mcp_failure_marks_failed_with_error_result(h):
    h.mcp._results["fetch__fetch"] = RuntimeError("connection refused")
    h.make_task()
    make_mcpserver(h.ns, h.store, "fetch")
    make_toolcall(h.ns, h.store)
    await h.to_ready()
    await h.step()
    tc = h.tc()
    assert tc.status.phase == "Failed" and "connection refused" in tc.status.error
    assert tc.status.result.startswith("error:")


async def case_approval_gate_approve_then_execute(h):
    make_secret(h.ns, h.store)
    h.make_task()
    make_contactchannel(h.ns, h.store, "approvals")
    make_mcpserver(h.ns, h.store, "fetch", approval_channel="approvals")
    make_toolcall(h.ns, h.store)
    await h.to_ready()
    result = await h.step()
    tc = h.tc()
    assert tc.status.phase == "AwaitingHumanApproval" and tc.status.external_call_id
    assert result.requeue_after == h.rec.poll_interval
    (pending,) = h.backend.pending_approvals()
    assert pending.fn == "fetch__fetch"
    assert (await h.step()).requeue_after == h.rec.poll_interval  # still pending
    h.backend.approve(tc.status.external_call_id, "go ahead")
    await h.step()
    assert h.tc().status.phase == "ReadyToExecuteApprovedTool"
    await h.step()
    assert (h.tc().status.phase, h.tc().status.result) == ("Succeeded", "<html>example</html>")


async def case_approval_rejection_is_a_successful_tool_result(h):
    make_secret(h.ns, h.store)
    h.make_task()
    make_contactchannel(h.ns, h.store, "approvals")
    make_mcpserver(h.ns, h.store, "fetch", approval_channel="approvals")
    make_toolcall(h.ns, h.store)
    await h.to_ready()
    await h.step()
    h.backend.reject(h.tc().status.external_call_id, "too dangerous")
    await h.step()
    tc = h.tc()
    assert (tc.status.phase, tc.status.status, tc.status.result) == (
        "ToolCallRejected", "Succeeded", "Rejected: too dangerous")
    assert h.mcp.calls == []


async def case_delegate_spawns_child_task_and_joins(h):
    make_llm(h.ns, h.store)
    make_agent(h.ns, h.store, name="researcher", description="does research")
    h.make_task()
    make_toolcall(h.ns, h.store, tool="delegate_to_agent__researcher",
                  tool_type="DelegateToAgent", arguments='{"message": "find the answer"}')
    await h.to_ready()
    await h.step()
    assert h.tc().status.phase == "AwaitingSubAgent"
    (child,) = h.store.list("Task", label_selector={"acp.tpu/parent-toolcall": TC})
    assert (child.spec.agent_ref.name, child.spec.user_message) == ("researcher",
                                                                    "find the answer")
    assert child.metadata.owner_references[0].name == TC
    await h.step()  # idempotent under requeue: no duplicate child
    assert len(h.store.list("Task", label_selector={"acp.tpu/parent-toolcall": TC})) == 1
    child.status.phase, child.status.output = "FinalAnswer", "the answer is 42"
    h.store.update_status(child)
    await h.step()
    assert (h.tc().status.phase, h.tc().status.result) == ("Succeeded", "the answer is 42")


async def case_delegate_child_failure_propagates(h):
    make_llm(h.ns, h.store)
    make_agent(h.ns, h.store, name="researcher")
    h.make_task()
    make_toolcall(h.ns, h.store, tool="delegate_to_agent__researcher",
                  tool_type="DelegateToAgent", arguments='{"message": "do it"}')
    await h.to_ready()
    await h.step()
    (child,) = h.store.list("Task", label_selector={"acp.tpu/parent-toolcall": TC})
    child.status.phase, child.status.error = "Failed", "llm exploded"
    h.store.update_status(child)
    await h.step()
    assert h.tc().status.phase == "Failed" and "llm exploded" in h.tc().status.error


async def case_human_contact_roundtrip(h):
    make_secret(h.ns, h.store)
    h.make_task()
    make_contactchannel(h.ns, h.store, "oncall")
    make_toolcall(h.ns, h.store, tool="oncall__human_contact_email", tool_type="HumanContact",
                  arguments='{"message": "should I deploy?"}')
    await h.to_ready()
    result = await h.step()
    assert h.tc().status.phase == "AwaitingHumanInput"
    assert result.requeue_after == h.rec.poll_interval
    assert h.backend.pending_contacts()[0].message == "should I deploy?"
    h.backend.respond(h.tc().status.external_call_id, "yes, ship it")
    await h.step()
    assert (h.tc().status.phase, h.tc().status.result) == ("Succeeded", "yes, ship it")


async def case_unknown_tool_type_fails(h):
    h.make_task()
    make_toolcall(h.ns, h.store, tool="unmangled-name")
    await h.to_ready()
    await h.step()
    assert h.tc().status.phase == "Failed" and "not of the form" in h.tc().status.error


async def case_approval_channel_missing_fails_closed(h):
    h.make_task()
    make_mcpserver(h.ns, h.store, "fetch", approval_channel="gone")
    make_toolcall(h.ns, h.store)
    await h.to_ready()
    result = await h.step()
    assert h.tc().status.phase == "ErrorRequestingHumanApproval" and result.requeue_after == 15.0
    assert h.mcp.calls == []


async def case_approval_without_human_layer_fails_closed(h):
    h.rec.hl_factory = None
    make_secret(h.ns, h.store)
    h.make_task()
    make_contactchannel(h.ns, h.store, "approvals")
    make_mcpserver(h.ns, h.store, "fetch", approval_channel="approvals")
    make_toolcall(h.ns, h.store)
    await h.to_ready()
    await h.step()
    assert h.tc().status.status_detail == "approval required but no human-layer client configured"


async def case_lost_approval_and_contact_are_requested_again(h):
    make_secret(h.ns, h.store)
    h.make_task()
    make_contactchannel(h.ns, h.store, "approvals")
    make_mcpserver(h.ns, h.store, "fetch", approval_channel="approvals")
    make_toolcall(h.ns, h.store)
    make_toolcall(h.ns, h.store, name="hc", tool="approvals__human_contact_email",
                  tool_type="HumanContact", arguments='{"message": "ok?"}')
    await h.to_ready()
    await h.to_ready("hc")
    await h.step()
    await h.step("hc")
    h.backend.approvals.clear()  # the in-memory backend restarted
    h.backend.contacts.clear()
    await h.step()
    await h.step("hc")
    assert h.tc().status.status_detail == "approval request lost; re-requesting"
    assert h.tc("hc").status.status_detail == "contact request lost; re-requesting"
    await h.step()
    await h.step("hc")
    assert h.tc().status.phase == "AwaitingHumanApproval"
    assert h.tc("hc").status.phase == "AwaitingHumanInput"


async def case_delegate_child_name_is_cut_to_63(h):
    agent = "researcher-with-a-name-long-enough-to-cut"
    make_llm(h.ns, h.store)
    make_agent(h.ns, h.store, name=agent)
    h.make_task()
    make_toolcall(h.ns, h.store, tool=f"delegate_to_agent__{agent}",
                  tool_type="DelegateToAgent", arguments='{"message": "go"}')
    await h.to_ready()
    await h.step()
    (child,) = h.store.list("Task", label_selector={"acp.tpu/parent-toolcall": TC})
    assert len(child.name) <= 63 and not child.name.endswith("-")


async def case_delegate_to_missing_agent_fails(h):
    h.make_task()
    make_toolcall(h.ns, h.store, tool="delegate_to_agent__nobody", tool_type="DelegateToAgent",
                  arguments='{"message": "x"}')
    await h.to_ready()
    await h.step()
    assert h.tc().status.error == 'delegate target Agent "nobody" not found'


async def case_respond_to_human_delivers_v1beta3_answer(h):
    make_secret(h.ns, h.store)
    make_secret(h.ns, h.store, name="event-token", data={"token": "tok-1"})
    make_contactchannel(h.ns, h.store, "slackish")
    h.make_task(labels={"acp.tpu/v1beta3": "true"},
              contactChannelRef={"name": "slackish"},
              channelTokenFrom={"name": "event-token", "key": "token"}, threadId="t-1")
    make_toolcall(h.ns, h.store, tool="respond_to_human", tool_type="HumanContact",
                  arguments=json.dumps({"content": "done"}))
    await h.to_ready()
    await h.step()
    assert h.tc().status.phase == "Succeeded"
    assert h.backend.contacts["call_1"].message == "done"


async def case_running_toolcall_resumes(h):
    h.make_task()
    make_mcpserver(h.ns, h.store, "fetch")
    tc = make_toolcall(h.ns, h.store)
    tc.status.phase, tc.status.status = "Running", "Ready"
    h.store.update_status(tc)
    await h.step()
    assert h.tc().status.phase == "Succeeded" and len(h.mcp.calls) == 1


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


async def replay(ns, case) -> ToolCallHarness:
    h = ToolCallHarness(ns)
    await CASES[case](h)
    return h


def test_every_reference_case_is_replayed():
    ref_cases = {n[len("test_"):] for n in dir(__import__(
        "tests.controllers.test_toolcall_controller", fromlist=["x"])) if n.startswith("test_")}
    assert ref_cases <= set(CASES) and len(ref_cases) == 9


@pytest.mark.parametrize("case", CASES)
async def test_toolcall_controller_matches_the_reference(case):
    ref, ours = await replay(REF, case), await replay(PORT, case)
    assert ours.snaps, case
    assert normalized(ours.snaps, random_ids(ours.store)) == \
        normalized(ref.snaps, random_ids(ref.store))
    for h in (ref, ours):  # a ToolCall's span is a child of its Task's trace
        for tc in h.store.list("ToolCall"):
            assert tc.status.span_context.trace_id == "a" * 32
