"""The port's Task controller against the JAX package's, on the CPU.

Every case of the reference's ``tests/controllers/test_task_controller.py``
(17) is replayed on both packages through ``MockLLMClient`` scripts, one
reconcile at a time, and so are six more paths of the controller that
case list does not reach (early dispatch adopted in part or whole, and
orphaned, a fan-out
that fails to create its ToolCall, the v1beta3 respond-to-human loop, the
jittered 429 retry). After every step the whole store is snapshotted:
each Task's and ToolCall's spec, status and metadata, every Event (type,
reason, message, count), every Lease, the reconcile's ``Result``, and what
the mock LLM was sent. The two packages' snapshots must be equal after
normalization: ids the controllers draw from ``secrets`` (request ids,
respond-to-human call ids) become ``<r0>``, ``<r1>``... in order of first
appearance, uids are dropped, and wall-clock times and span ids are
reduced to their presence (their parentage is checked separately). The
cases are parametrised (one test id each), not copied; the reference's own
assertions are also made on the port's run. No tolerance: every compared
value is exact.

The ``make_*`` helpers here are the port-side counterparts of the
reference's ``testing.py`` helpers, made from camelCase documents through each
package's ``model_validate`` so the same document reaches both; the
ToolCall tests (``test_torch_toolcall.py``) reuse them.
"""

import dataclasses
import json
import re
import types

import pytest

import agentcontrolplane_tpu.api.resources as ref_resources
import agentcontrolplane_tpu.controllers.task as ref_task
import agentcontrolplane_tpu.controllers.toolcall as ref_toolcall
import agentcontrolplane_tpu.humanlayer as ref_humanlayer
import agentcontrolplane_tpu.kernel as ref_kernel
import agentcontrolplane_tpu.llmclient as ref_llmclient
import agentcontrolplane_tpu_torch.api.resources as port_resources
import agentcontrolplane_tpu_torch.controllers.task as port_task
import agentcontrolplane_tpu_torch.controllers.toolcall as port_toolcall
import agentcontrolplane_tpu_torch.engine.types as port_types
import agentcontrolplane_tpu_torch.humanlayer as port_humanlayer
import agentcontrolplane_tpu_torch.kernel as port_kernel
import agentcontrolplane_tpu_torch.llmclient.base as port_base
import agentcontrolplane_tpu_torch.llmclient.factory as port_factory
import agentcontrolplane_tpu_torch.llmclient.mock as port_mock

REF = types.SimpleNamespace(
    name="ref", R=ref_resources, K=ref_kernel, task=ref_task, toolcall=ref_toolcall,
    HL=ref_humanlayer, MockLLMClient=ref_llmclient.MockLLMClient,
    MockLLMClientFactory=ref_llmclient.MockLLMClientFactory,
    LLMRequestError=ref_llmclient.LLMRequestError, assistant=ref_llmclient.assistant,
    tool_call_message=ref_llmclient.tool_call_message, MessageToolCall=ref_resources.MessageToolCall,
    ToolCallFunction=ref_resources.ToolCallFunction)
PORT = types.SimpleNamespace(
    name="port", R=port_resources, K=port_kernel, task=port_task, toolcall=port_toolcall,
    HL=port_humanlayer, MockLLMClient=port_mock.MockLLMClient,
    MockLLMClientFactory=port_factory.MockLLMClientFactory,
    LLMRequestError=port_base.LLMRequestError, assistant=port_mock.assistant,
    tool_call_message=port_mock.tool_call_message, MessageToolCall=port_types.MessageToolCall,
    ToolCallFunction=port_types.ToolCallFunction)

# -- object helpers (the reference testing.py's, per package) ------------------


def create(ns, store, kind, doc, status=None):
    obj = store.create(ns.R.KINDS[kind].model_validate(doc))
    if status is not None:
        obj.status = type(obj.status).model_validate(status)
        obj = store.update_status(obj)
    return obj


def make_secret(ns, store, name="test-secret", data=None):
    return create(ns, store, "Secret", {"metadata": {"name": name},
                                        "spec": {"data": data or {"api-key": "sk-test-123"}}})


def make_llm(ns, store, name="test-llm", provider="mock", ready=True, **spec):
    return create(ns, store, "LLM", {
        "metadata": {"name": name},
        "spec": {"provider": provider, "parameters": {"model": "test-model"}, **spec}},
        {"ready": True, "status": "Ready"} if ready else None)


def make_agent(ns, store, name="test-agent", llm="test-llm", system="you are a helpful assistant",
               ready=True, mcp_servers=(), channels=(), sub_agents=(), resolved_tools=None,
               description="", **spec):
    status = None
    if ready:
        status = {"ready": True, "status": "Ready",
                  "validMcpServers": [{"name": s, "tools": (resolved_tools or {}).get(s, [])}
                                      for s in mcp_servers],
                  "validHumanContactChannels": list(channels),
                  "validSubAgents": [{"name": a} for a in sub_agents]}
    return create(ns, store, "Agent", {
        "metadata": {"name": name},
        "spec": {"llmRef": {"name": llm}, "system": system, "description": description,
                 "mcpServers": [{"name": s} for s in mcp_servers],
                 "humanContactChannels": [{"name": c} for c in channels],
                 "subAgents": [{"name": a} for a in sub_agents], **spec}}, status)


def make_task(ns, store, name="test-task", agent="test-agent",
              user_message="what is the capital of france?", context_window=None, labels=None,
              **spec):
    doc = {"agentRef": {"name": agent}, **spec}
    if user_message is not None:
        doc["userMessage"] = user_message
    if context_window is not None:
        doc["contextWindow"] = context_window
    return create(ns, store, "Task", {"metadata": {"name": name, "labels": labels or {}},
                                      "spec": doc})


def make_toolcall(ns, store, name="test-task-abc1234-tc-01", task="test-task", tool="fetch__fetch",
                  tool_type="MCP", arguments='{"url": "https://example.com"}', labels=None,
                  owner=None):
    meta = {"name": name, "labels": labels or {}}
    if owner is not None:
        meta["ownerReferences"] = [owner.owner_ref().model_dump()]
    return create(ns, store, "ToolCall", {"metadata": meta, "spec": {
        "toolCallId": "call_1", "taskRef": {"name": task}, "toolRef": {"name": tool},
        "toolType": tool_type, "arguments": arguments}})


def make_mcpserver(ns, store, name="fetch", connected=True, tools=("fetch",),
                   approval_channel=None):
    spec = {"transport": "stdio", "command": "echo"}
    if approval_channel:
        spec["approvalContactChannel"] = approval_channel
    status = {"connected": True, "status": "Ready",
              "tools": [{"name": t, "description": f"{t} tool"} for t in tools]}
    return create(ns, store, "MCPServer", {"metadata": {"name": name}, "spec": spec},
                  status if connected else None)


def make_contactchannel(ns, store, name="approval-channel", ready=True):
    return create(ns, store, "ContactChannel", {
        "metadata": {"name": name},
        "spec": {"type": "email", "apiKeyFrom": {"name": "test-secret", "key": "api-key"},
                 "email": {"address": "human@example.com"}}},
        {"ready": True, "status": "Ready"} if ready else None)


class FakeMCPManager:
    """The reference test's stand-in MCP manager: scripted tools (MCPTool
    documents) and results (a string, or an exception to raise)."""

    def __init__(self, ns, tools=None, results=None):
        self._tools = {k: [ns.R.MCPTool.model_validate(t) for t in v]
                       for k, v in (tools or {}).items()}
        self._results = results or {}
        self.calls = []

    def get_tools(self, name):
        return self._tools.get(name, [])

    async def call_tool(self, server, tool, args):
        self.calls.append((server, tool, args))
        result = self._results.get(f"{server}__{tool}", "ok")
        if isinstance(result, Exception):
            raise result
        return result


# -- snapshots ----------------------------------------------------------------

TIMES = {"creation_timestamp", "last_timestamp", "acquire_time", "renew_time", "start_time",
         "completion_time"}
RANDOM_ID = re.compile(r"\b(?:call_)?[a-z][a-z0-9]{6,7}\b")


def _norm(x):
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            if k in ("uid", "involved_uid", "acp.tpu/involved-uid"):
                continue
            if k in TIMES:
                out[k] = bool(v)
            elif k == "span_context":
                out[k] = v is not None and len(v["trace_id"]) == 32 and len(v["span_id"]) == 16
            else:
                out[k] = _norm(v)
        return out
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


def _doc(obj) -> dict:
    doc = _norm(obj.model_dump())
    if doc["kind"] == "Event":
        doc["metadata"]["name"] = None  # "<involved>.<random hex>"
    return doc


def _tools_view(tools) -> list:
    return [(t.function.name, t.function.description, t.function.parameters, t.acp_tool_type)
            for t in tools]


def snapshot(store, result=None, mock=None) -> dict:
    snap = {"objects": [_doc(o) for kind in ("Task", "ToolCall", "Lease")
                        for o in store.list(kind, namespace=None)],
            "events": sorted((e.spec.involved_kind, e.spec.involved_name, e.spec.type,
                              e.spec.reason, e.spec.message, e.spec.count,
                              e.metadata.resource_version)
                             for e in store.list("Event", namespace=None))}
    if result is not None:
        snap["result"] = dataclasses.astuple(result)
    if mock is not None:
        snap["sent"] = [([m.model_dump() for m in r.messages], _tools_view(r.tools))
                        for r in mock.requests]
    return snap


def random_ids(store) -> list:
    """The ids the controllers drew from ``secrets`` in this store, in the
    order their first ToolCall was created, a ToolCall's request id before
    its call id (ids only a Task's status holds come last)."""
    first: dict = {}
    for tc in store.list("ToolCall", namespace=None):
        for rank, i in enumerate((
                tc.metadata.labels.get("acp.tpu/toolcallrequest", ""),
                tc.spec.tool_call_id if tc.spec.tool_ref.name == "respond_to_human" else "")):
            if i:
                first[i] = min(first.get(i, (float("inf"), 0)),
                               (tc.metadata.creation_timestamp, rank))
    for t in store.list("Task", namespace=None):
        if t.status.tool_call_request_id:
            first.setdefault(t.status.tool_call_request_id, (float("inf"), 0))
    ids = [i for i in first if RANDOM_ID.fullmatch(i) and "-" not in i]
    return sorted(ids, key=lambda i: (first[i], i))


def normalized(snaps, ids) -> list:
    """The snapshots with each random id replaced by ``<rN>`` (N its rank
    in ``ids``), and each snapshot's objects and events re-sorted, since
    the store lists by names that hold the ids."""
    text = json.dumps(snaps, sort_keys=True, default=str)
    if ids:
        text = re.sub("|".join(map(re.escape, ids)), lambda m: f"<r{ids.index(m.group(0))}>",
                      text)
    out = json.loads(text)
    for snap in out:
        if isinstance(snap, dict) and "objects" in snap:
            snap["objects"].sort(key=lambda d: (d["kind"], d["metadata"]["name"]))
            snap["events"].sort()
    return out


class TaskHarness:
    """The reference test's harness: a Task reconciler over a fresh store
    with a scripted mock LLM, a fake MCP manager and the local human
    backend; ``step`` reconciles once and snapshots the store."""

    def __init__(self, ns):
        self.ns = ns
        self.store = ns.K.Store()
        self.recorder = ns.K.EventRecorder(self.store)
        self.mock = ns.MockLLMClient()
        self.rec = ns.task.TaskReconciler(
            store=self.store, recorder=self.recorder,
            llm_factory=ns.MockLLMClientFactory(self.mock), mcp_manager=FakeMCPManager(ns),
            hl_factory=ns.HL.LocalHumanLayerClientFactory())
        self.snaps = []

    async def step(self, name="test-task"):
        result = await self.rec.reconcile(("Task", "default", name))
        self.snaps.append(snapshot(self.store, result, self.mock))
        return result

    def task(self, name="test-task"):
        return self.store.get("Task", name)

    def reasons(self, name="test-task"):
        return [e.spec.reason for e in self.recorder.events_for(self.task(name))]


# -- the reference's 17 cases, then six more paths ----------------------------


async def case_empty_phase_initializes_and_persists_span(h):
    make_llm(h.ns, h.store)
    make_agent(h.ns, h.store)
    make_task(h.ns, h.store)
    result = await h.step()
    assert h.task().status.phase == "Initializing"
    assert len(h.task().status.span_context.trace_id) == 32
    assert result.requeue


async def case_agent_missing_goes_pending_with_requeue(h):
    make_task(h.ns, h.store, agent="missing-agent")
    await h.step()
    result = await h.step()
    assert h.task().status.phase == "Pending"
    assert 'Waiting for Agent "missing-agent" to exist' in h.task().status.status_detail
    assert result.requeue_after == h.rec.requeue_delay
    assert "Waiting" in h.reasons()


async def case_agent_not_ready_goes_pending(h):
    make_llm(h.ns, h.store)
    make_agent(h.ns, h.store, ready=False)
    make_task(h.ns, h.store)
    await h.step()
    result = await h.step()
    assert h.task().status.phase == "Pending"
    assert "to become ready" in h.task().status.status_detail
    assert result.requeue_after == h.rec.requeue_delay


async def case_ready_agent_builds_context_window(h):
    make_llm(h.ns, h.store)
    make_agent(h.ns, h.store, system="system prompt here")
    make_task(h.ns, h.store, user_message="hello")
    await h.step()
    result = await h.step()
    task = h.task()
    assert task.status.phase == "ReadyForLLM"
    assert [(m.role, m.content) for m in task.status.context_window] == [
        ("system", "system prompt here"), ("user", "hello")]
    assert task.status.user_msg_preview == "hello"
    assert result.requeue


async def case_invalid_spec_fails_terminally(h):
    make_llm(h.ns, h.store)
    make_agent(h.ns, h.store)
    make_task(h.ns, h.store, user_message="both",
              context_window=[{"role": "user", "content": "also this"}])
    await h.step()
    result = await h.step()
    task = h.task()
    assert (task.status.phase, task.status.status) == ("Failed", "Error")
    assert "only one of" in task.status.error
    assert not result.requeue and result.requeue_after is None


async def case_final_answer_path(h):
    make_llm(h.ns, h.store)
    make_agent(h.ns, h.store)
    make_task(h.ns, h.store, user_message="2+2?")
    h.mock.script.append(h.ns.assistant("4"))
    await h.step()
    await h.step()
    result = await h.step()
    task = h.task()
    assert (task.status.phase, task.status.output, task.status.message_count) == (
        "FinalAnswer", "4", 3)
    assert not result.requeue and result.requeue_after is None
    assert (await h.step()).requeue_after is None  # terminal: a no-op


async def case_tool_calls_fan_out(h):
    make_llm(h.ns, h.store)
    h.rec.mcp_manager = FakeMCPManager(h.ns, tools={"fetch": [
        {"name": "fetch", "description": "fetch a url"}]})
    make_mcpserver(h.ns, h.store, "fetch")
    make_agent(h.ns, h.store, mcp_servers=["fetch"], resolved_tools={"fetch": ["fetch"]})
    make_task(h.ns, h.store, user_message="fetch example.com")
    h.mock.script.append(h.ns.tool_call_message(("fetch__fetch", {"url": "https://example.com"})))
    await h.step()
    await h.step()
    result = await h.step()
    task = h.task()
    assert task.status.phase == "ToolCallsPending" and task.status.tool_call_request_id
    assert "fetch__fetch" in [t.function.name for t in h.mock.requests[0].tools]
    (tc,) = h.store.list("ToolCall", label_selector={
        "acp.tpu/task": "test-task", "acp.tpu/toolcallrequest": task.status.tool_call_request_id})
    assert tc.metadata.name == f"test-task-{task.status.tool_call_request_id}-tc-01"
    assert (tc.spec.tool_type, tc.spec.tool_ref.name) == ("MCP", "fetch__fetch")
    assert tc.metadata.owner_references[0].name == "test-task"
    assert result.requeue_after == h.rec.requeue_delay


def _pending_with(h, results, request_id="req1234"):
    task = make_task(h.ns, h.store)
    task.status.phase = "ToolCallsPending"
    task.status.tool_call_request_id = request_id
    task.status.context_window = [h.ns.R.Message(role="system", content="s"),
                                  h.ns.R.Message(role="user", content="u")]
    h.store.update_status(task)
    labels = {"acp.tpu/task": "test-task", "acp.tpu/toolcallrequest": request_id}
    for name, text, phase in results:
        tc = make_toolcall(h.ns, h.store, name=f"test-task-{request_id}-{name}", labels=labels)
        if phase:
            tc.status.phase, tc.status.status, tc.status.result = phase, "Succeeded", text
            h.store.update_status(tc)


async def case_tool_calls_join_appends_results_in_order(h):
    make_llm(h.ns, h.store)
    make_agent(h.ns, h.store)
    _pending_with(h, [("tc-01", "result one", "Succeeded"),
                      ("tc-02", "Rejected: no", "ToolCallRejected")])
    result = await h.step()
    task = h.task()
    assert task.status.phase == "ReadyForLLM"
    assert [m.content for m in task.status.context_window if m.role == "tool"] == [
        "result one", "Rejected: no"]
    assert result.requeue


async def case_tool_calls_pending_waits_for_completion(h):
    make_llm(h.ns, h.store)
    make_agent(h.ns, h.store)
    _pending_with(h, [("tc-01", "", "")])
    result = await h.step()
    assert h.task().status.phase == "ToolCallsPending"
    assert result.requeue_after == h.rec.requeue_delay


async def case_llm_4xx_fails_terminally(h):
    make_llm(h.ns, h.store)
    make_agent(h.ns, h.store)
    make_task(h.ns, h.store)
    h.mock.script.append(h.ns.LLMRequestError(401, "bad api key"))
    await h.step()
    await h.step()
    result = await h.step()
    assert h.task().status.phase == "Failed" and "401" in h.task().status.error
    assert result.requeue_after is None and not result.requeue
    assert "LLMRequestFailed" in h.reasons()


async def case_llm_5xx_retries_keeping_phase(h):
    make_llm(h.ns, h.store)
    make_agent(h.ns, h.store)
    make_task(h.ns, h.store)
    h.mock.script.append(h.ns.LLMRequestError(503, "overloaded"))
    await h.step()
    await h.step()
    result = await h.step()
    assert (h.task().status.phase, h.task().status.status) == ("ReadyForLLM", "Error")
    # jittered in [delay, 2 x delay): checked here, the value normalized
    assert h.rec.requeue_delay <= result.requeue_after < 2 * h.rec.requeue_delay
    h.snaps[-1]["result"] = (False, "jitter")
    h.mock.script.append(h.ns.assistant("recovered"))
    await h.step()
    assert h.task().status.phase == "FinalAnswer"


async def case_lease_held_by_other_replica_blocks_llm_send(h):
    make_llm(h.ns, h.store)
    make_agent(h.ns, h.store)
    make_task(h.ns, h.store)
    await h.step()
    await h.step()
    h.ns.K.lease.try_acquire(h.store, "task-llm-test-task", "other-pod", ttl=30)
    result = await h.step()
    assert h.task().status.phase == "ReadyForLLM"
    assert result.requeue_after == h.rec.requeue_delay
    assert h.mock.requests == []


async def case_build_initial_context_window_prepends_system_iff_absent(h):
    build, M = h.ns.task.build_initial_context_window, h.ns.R.Message
    views = []
    for window, user in (([M(role="user", content="u")], ""),
                         ([M(role="system", content="custom"), M(role="user", content="u")], ""),
                         ([], "hello")):
        views.append([(m.role, m.content) for m in build(window, "SYS", user)])
    assert views == [[("system", "SYS"), ("user", "u")], [("system", "custom"), ("user", "u")],
                     [("system", "SYS"), ("user", "hello")]]
    h.snaps.append(views)


async def case_context_window_task_spec(h):
    make_llm(h.ns, h.store)
    make_agent(h.ns, h.store, system="AGENT SYS")
    make_task(h.ns, h.store, user_message=None,
              context_window=[{"role": "user", "content": "continuing conversation"}])
    await h.step()
    await h.step()
    task = h.task()
    assert task.status.phase == "ReadyForLLM"
    assert (task.status.context_window[0].role, task.status.context_window[0].content) == (
        "system", "AGENT SYS")
    assert task.status.user_msg_preview == "continuing conversation"


async def case_compact_window_protocol_safe(h):
    M, compact = h.ns.R.Message, h.ns.task.compact_window
    window = [M(role="system", content="sys")]
    for i in range(6):
        window.append(M(role="assistant", content="", tool_calls=[h.ns.MessageToolCall(
            id=f"c{i}", function=h.ns.ToolCallFunction(name="t__x"))]))
        window.append(M(role="tool", content=f"r{i}", tool_call_id=f"c{i}"))
    window.append(M(role="user", content="latest question"))
    out = compact(window, max_messages=6)
    assert len(out) <= 6 and out[0].content == "sys" and "elided" in out[1].content
    assert out[2].role != "tool"
    assert compact(window, 0) == window and compact(window[:3], 10) == window[:3]
    h.snaps.append([m.model_dump() for m in out])


async def case_context_policy_applied_to_llm_request(h):
    make_llm(h.ns, h.store)
    make_agent(h.ns, h.store)
    agent = h.store.get("Agent", "test-agent")
    agent.spec.context_policy = h.ns.R.ContextPolicy(max_messages=4)
    h.store.update(agent)
    task = make_task(h.ns, h.store)
    task.status.phase = "ReadyForLLM"
    task.status.context_window = [h.ns.R.Message(role="system", content="s")] + [
        h.ns.R.Message(role="user" if i % 2 == 0 else "assistant", content=f"m{i}")
        for i in range(10)]
    h.store.update_status(task)
    h.mock.script.append(h.ns.assistant("done"))
    await h.step()
    sent = h.mock.requests[0].messages
    assert len(sent) <= 4 and any("elided" in m.content for m in sent)
    assert len(h.task().status.context_window) == 12


async def case_engineless_replica_defers_tpu_tasks(h):
    make_llm(h.ns, h.store, name="tpu-llm", provider="tpu")
    make_agent(h.ns, h.store, name="agent", llm="tpu-llm")
    make_task(h.ns, h.store, name="t", agent="agent", user_message="hi")
    await h.step("t")
    await h.step("t")
    assert getattr(h.rec.llm_factory, "engine", "missing") is None
    result = await h.step("t")
    task = h.task("t")
    assert task.status.phase == "ReadyForLLM"
    assert "engine-serving replica" in task.status.status_detail
    assert result.requeue_after == h.rec.requeue_delay and h.mock.requests == []
    assert h.ns.K.lease.try_acquire(h.store, "task-llm-t", "engine-owner")
    h.snaps.append(snapshot(h.store))


class EarlyMock:
    """A mock LLM client that stream-dispatches: it calls ``on_tool_call``
    for each of ``early`` before returning ``reply`` (what the engine client
    does from its stream parser)."""

    supports_early_tool_calls = True

    def __init__(self, reply, early):
        self.reply, self.early, self.requests = reply, early, []

    async def send_request(self, messages, tools, on_tool_call=None):
        self.requests.append(types.SimpleNamespace(messages=list(messages), tools=list(tools)))
        for i, tc in enumerate(self.early):
            on_tool_call(i, tc)
        return self.reply

    async def close(self):
        pass


def _two_tools(h, early_args, both=False):
    make_llm(h.ns, h.store)
    h.rec.mcp_manager = FakeMCPManager(h.ns, tools={"fetch": [
        {"name": "fetch", "description": "fetch a url"}, {"name": "post"}]})
    make_agent(h.ns, h.store, mcp_servers=["fetch"], resolved_tools={"fetch": ["fetch", "post"]})
    make_task(h.ns, h.store, user_message="fetch two pages")
    reply = h.ns.tool_call_message(("fetch__fetch", {"url": "a"}), ("fetch__post", {"b": 1}))
    early = h.ns.tool_call_message(("fetch__fetch", early_args)).tool_calls
    if both:  # the stream saw every call of the turn, as the engine's does
        early = list(reply.tool_calls)
    h.mock = EarlyMock(reply, early)
    h.rec.llm_factory = h.ns.MockLLMClientFactory(h.mock)


async def case_early_dispatch_adopted(h):
    _two_tools(h, {"url": "a"})
    for _ in range(3):
        await h.step()
    task = h.task()
    tcs = h.store.list("ToolCall", label_selector={"acp.tpu/task": "test-task"})
    assert task.status.phase == "ToolCallsPending" and len(tcs) == 2
    assert {tc.metadata.labels["acp.tpu/toolcallrequest"] for tc in tcs} == {
        task.status.tool_call_request_id}


async def case_early_dispatch_every_call_adopted(h):
    _two_tools(h, {"url": "a"}, both=True)
    for _ in range(3):
        await h.step()
    tcs = h.store.list("ToolCall", label_selector={"acp.tpu/task": "test-task"})
    assert len(tcs) == 2 and h.task().status.context_window[-1].tool_calls[1].id == "call_1"


async def case_early_dispatch_orphaned_on_divergence(h):
    _two_tools(h, {"url": "different"})
    for _ in range(3):
        await h.step()
    task = h.task()
    tcs = h.store.list("ToolCall", label_selector={"acp.tpu/task": "test-task"})
    fresh = [tc for tc in tcs
             if tc.metadata.labels["acp.tpu/toolcallrequest"] == task.status.tool_call_request_id]
    assert len(tcs) == 3 and len(fresh) == 2  # the early CR is an orphan


async def case_fan_out_create_failure_fails_task(h):
    make_llm(h.ns, h.store)
    make_agent(h.ns, h.store)
    make_task(h.ns, h.store)
    h.mock.script.append(h.ns.tool_call_message(("fetch__fetch", {"url": "a"})))
    create = h.store.create

    def refuse_toolcalls(obj, *a, **kw):
        if obj.kind == "ToolCall":
            raise h.ns.K.Invalid("quota exceeded")
        return create(obj, *a, **kw)

    h.store.create = refuse_toolcalls
    for _ in range(3):
        await h.step()
    task = h.task()
    assert task.status.phase == "Failed"
    assert task.status.error == "failed to create tool calls: quota exceeded"


async def case_v1beta3_final_answer_responds_to_human(h):
    make_secret(h.ns, h.store)
    make_secret(h.ns, h.store, name="event-token", data={"token": "tok-1"})
    make_contactchannel(h.ns, h.store, "slackish")
    make_llm(h.ns, h.store)
    make_agent(h.ns, h.store)
    make_task(h.ns, h.store, labels={"acp.tpu/v1beta3": "true"},
              contactChannelRef={"name": "slackish"},
              channelTokenFrom={"name": "event-token", "key": "token"}, threadId="t-1")
    h.mock.script.append(h.ns.assistant("the answer"))
    for _ in range(3):
        await h.step()
    (tc,) = h.store.list("ToolCall", label_selector={"acp.tpu/task": "test-task"})
    assert tc.spec.tool_ref.name == "respond_to_human" and tc.spec.tool_type == "HumanContact"
    assert json.loads(tc.spec.arguments) == {"content": "the answer"}
    tc.status.phase, tc.status.status, tc.status.result = "Succeeded", "Succeeded", "sent"
    h.store.update_status(tc)
    await h.step()
    task = h.task()
    assert (task.status.phase, task.status.output) == ("FinalAnswer", "the answer")


async def case_rate_limited_429_retries_with_jitter(h):
    make_llm(h.ns, h.store)
    make_agent(h.ns, h.store)
    make_task(h.ns, h.store)
    h.mock.script.append(h.ns.LLMRequestError(429, "slow down"))
    await h.step()
    await h.step()
    result = await h.step()
    assert h.task().status.phase == "ReadyForLLM"
    assert h.rec.requeue_delay <= result.requeue_after < 2 * h.rec.requeue_delay
    h.snaps[-1]["result"] = (False, "jitter")


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


async def replay(ns, case) -> TaskHarness:
    h = TaskHarness(ns)
    await CASES[case](h)
    return h


def test_every_reference_case_is_replayed():
    ref_cases = {n[len("test_"):] for n in dir(__import__(
        "tests.controllers.test_task_controller", fromlist=["x"])) if n.startswith("test_")}
    assert ref_cases <= set(CASES) and len(ref_cases) == 17


@pytest.mark.parametrize("case", CASES)
async def test_task_controller_matches_the_reference(case):
    ref, ours = await replay(REF, case), await replay(PORT, case)
    assert ours.snaps, case
    assert normalized(ours.snaps, random_ids(ours.store)) == \
        normalized(ref.snaps, random_ids(ref.store))


# -- what the Task controller counts and traces into ---------------------------


def test_metrics_registry_matches_the_reference():
    import agentcontrolplane_tpu.observability.metrics as ref_metrics
    import agentcontrolplane_tpu_torch.observability.metrics as port_metrics

    views = []
    for mod in (ref_metrics, port_metrics):
        r = mod.Registry(hist_window=4)
        r.counter_add("acp_x_total", 2.0, {"k": 'a"b\nc\\d'}, help="x\\y\nz")
        r.counter_add("acp_x_total", 1.0, {"k": 'a"b\nc\\d'})
        r.gauge_set("acp_g", 3.5)
        r.gauge_set("acp_g", 1.0, {"p": "q"})
        r.gauge_remove("acp_g", {"p": "q"})
        for v in (5.0, 1.0, 3.0, 2.0, 4.0):
            r.observe("acp_h", v, {"s": "t"})
        views.append((r.render(), r.snapshot(), r.quantile("acp_h", 0.5, {"s": "t"}),
                      r.series_window("acp_h", {"s": "t"})))
    assert views[0] == views[1]
    assert 'acp_x_total{k="a\\"b\\nc\\\\d"} 3.0' in views[1][0]


def test_tracer_parentage_and_otlp_export_match_the_reference():
    """Spans keep their trace through the persisted context, and the OTLP
    export posts the reference's JSON body to a local collector; a tracer
    with no endpoint exports nothing."""
    import http.server
    import threading

    import agentcontrolplane_tpu.observability.tracing as ref_tracing
    import agentcontrolplane_tpu_torch.observability.tracing as port_tracing

    bodies = []

    class Collector(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            bodies.append((self.path, json.loads(self.rfile.read(int(self.headers["Content-Length"])))))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *a):
            pass

    server = http.server.HTTPServer(("127.0.0.1", 0), Collector)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        for mod in (ref_tracing, port_tracing):
            tracer = mod.Tracer(endpoint=f"http://127.0.0.1:{server.server_address[1]}/")
            root = tracer.start_span("Task", attributes={"task": "t"})
            child = tracer.start_span("LLMRequest", parent=root.context(), attributes={"n": 2})
            assert (child.trace_id, child.parent_span_id) == (root.trace_id, root.span_id)
            assert len(root.trace_id) == 32 and len(root.span_id) == 16
            tracer.end_span(child, "ERROR")
            assert [s.name for s in tracer.spans_for_trace(root.trace_id)] == ["LLMRequest"]
            fixed = mod.Span(name="s", trace_id="a" * 32, span_id="b" * 16, parent_span_id="c" * 16,
                             start_time=1.5, end_time=2.25, attributes={"k": 1})
            tracer._export(fixed)  # synchronous: the body the export thread posts
            assert mod.NOOP_TRACER.endpoint == ""
        exported = [b for b in bodies if b[1]["resourceSpans"][0]["scopeSpans"][0]["spans"][0][
            "name"] == "s"]
        assert len(exported) == 2 and exported[0] == exported[1]
        assert exported[1][0] == "/v1/traces"
    finally:
        server.shutdown()
        server.server_close()
