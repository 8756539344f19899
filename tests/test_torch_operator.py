"""The port's ``Operator`` against the JAX package's, on the CPU.

- With one module-scoped engine pair (the tiny f32 preset, greedy: the
  port's engine and the JAX paged engine from the same numpy weights),
  three forced Tasks run on the port's ``Operator`` and on the reference
  ``Operator``: a delegation (``tool_choice: "required"`` with one
  sub-agent), a human contact (the channel's tool named) answered through
  the local backend, and an MCP echo (``echo__echo`` named) over stdio
  against ``tests/mcp/echo_server.py``. Each Task's first turn decodes its
  forced, JSON-constrained call on the engine; its ToolCall executes; the
  result joins its context window. A forced Task would loop for ever, so
  the LLM factory lets each forced LLM make one turn and holds the next
  one at ``create_client`` until the operator stops (no engine request is
  in flight then). The two operators must give the same ToolCall
  ``tool_ref`` names, byte-identical arguments, the same phases and
  results, and the same context windows, exactly, with ids drawn at random
  (request ids, call ids, the child Task's name) normalized.
- Shutdown with a turn in flight: a long turn is decoding on the port's
  engine when ``Operator.stop()`` is called. The stop returns, the engine
  frees the slot, the Task stays ReadyForLLM with its lease released, and
  a new ``Operator`` over the same sqlite file resumes it to FinalAnswer.
- The options the port does not serve yet raise ``Invalid`` at
  construction, and the operator wires six controllers. Every operator
  here runs without its REST server (``enable_rest=False``; the REST
  routes are ``tests/test_torch_rest.py``'s).
"""

import asyncio
import collections
import dataclasses
import os
import sys

import numpy as np
import pytest

import jax

import agentcontrolplane_tpu.llmclient as ref_llmclient
import agentcontrolplane_tpu.operator as ref_operator
import agentcontrolplane_tpu_torch.llmclient.factory as port_factory
import agentcontrolplane_tpu_torch.operator as port_operator
from agentcontrolplane_tpu.engine.engine import Engine as JaxEngine
from agentcontrolplane_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from agentcontrolplane_tpu.models import llama as jl
from agentcontrolplane_tpu.parallel.mesh import make_mesh
from agentcontrolplane_tpu_torch.engine.engine import Engine
from agentcontrolplane_tpu_torch.engine.weights import params_from_jax
from agentcontrolplane_tpu_torch.models import llama as tl

from agentcontrolplane_tpu_torch.kernel import Result

from .test_torch_task import PORT, REF, create, normalized

REF.operator, REF.factory = ref_operator, ref_llmclient
PORT.operator, PORT.factory = port_operator, port_factory

JCFG = dataclasses.replace(jl.PRESETS["tiny"], vocab_size=512, max_seq_len=1024)
TCFG = dataclasses.replace(tl.PRESETS["tiny"], vocab_size=512, max_seq_len=1024)
KW = dict(max_slots=4, max_ctx=1024, prefill_buckets=(128, 1024), decode_block_size=4,
          page_size=8)
SERVER = os.path.join(os.path.dirname(__file__), "mcp", "echo_server.py")
TIMEOUT = 240.0  # hard limit on each operator run


@pytest.fixture(scope="module")
def engines():
    p = jax.tree_util.tree_map(np.array, jl.init_params(JCFG, jax.random.key(0)))
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


def _llm(name, max_tokens, tool_choice=None):
    spec = {"provider": "tpu", "parameters": {"model": "tiny", "maxTokens": max_tokens,
                                              "temperature": 0},
            "tpu": {"preset": "tiny"}}
    if tool_choice:
        spec["providerConfig"] = {"tool_choice": tool_choice}
    return ("LLM", {"metadata": {"name": name}, "spec": spec})


def _agent(name, llm, system, **deps):
    return ("Agent", {"metadata": {"name": name}, "spec": {"llmRef": {"name": llm},
                                                           "system": system, **deps}})


MANIFEST = [
    ("Secret", {"metadata": {"name": "hl-key"}, "spec": {"data": {"api-key": "sk-local"}}}),
    ("ContactChannel", {"metadata": {"name": "oncall"}, "spec": {
        "type": "email", "apiKeyFrom": {"name": "hl-key", "key": "api-key"},
        "email": {"address": "oncall@example.com", "contextAboutUser": "the on-call engineer"}}}),
    ("MCPServer", {"metadata": {"name": "echo"}, "spec": {
        "transport": "stdio", "command": sys.executable, "args": [SERVER],
        "resources": {"limits": {"memory": "1Gi"}}}}),
    _llm("deleg", 24, "required"),
    _llm("asks", 24, "oncall__human_contact_email"),
    _llm("echoes", 24, "echo__echo"),
    _llm("free", 12),
    _agent("leaf", "free", "Answer in one line.", description="answers one question"),
    _agent("rooter", "deleg", "Delegate the work.", subAgents=[{"name": "leaf"}]),
    _agent("asker", "asks", "Ask the human first.", humanContactChannels=[{"name": "oncall"}]),
    _agent("echoer", "echoes", "Use the echo tool.", mcpServers=[{"name": "echo"}]),
]
TASKS = {"t-deleg": "rooter", "t-ask": "asker", "t-echo": "echoer"}
FORCED = ("deleg", "asks", "echoes")
ANSWER = "approved, proceed"


class OneTurnFactory:
    """The operator's LLM client factory, letting each forced LLM make one
    turn: a later turn waits at ``create_client`` (before any engine
    request) until the operator's stop cancels it."""

    def __init__(self, inner, gated=FORCED):
        self.inner, self.gated = inner, set(gated)
        self.turns = collections.Counter()
        self.held = collections.Counter()

    @property
    def engine(self):
        return self.inner.engine

    async def create_client(self, llm, api_key):
        self.turns[llm.name] += 1
        if llm.name in self.gated and self.turns[llm.name] > 1:
            self.held[llm.name] += 1
            await asyncio.Event().wait()
        return await self.inner.create_client(llm, api_key)


def _tune(op):
    op.task_reconciler.requeue_delay = 0.02
    op.toolcall_reconciler.poll_interval = 0.02
    op.agent_reconciler.requeue_delay = 0.05


def _freeze_agents(op) -> None:
    """Stop revalidating Agents once they are Ready. The reference's Agent
    controller rewrites its status on every reconcile, and the write's own
    watch event reconciles it again at once (ROADMAP C), so its event loop
    would spin against the engine's thread for the rest of the run; both
    operators get the same treatment."""
    async def done(key):
        return Result()

    op.agent_reconciler.reconcile = done


def _call_ids(store) -> list:
    """Every id drawn at random in this store (request ids, tool-call ids
    from the engine's parser), by the Task their ToolCall belongs to, then
    in the order their ToolCall was created: the Tasks' turns finish in an
    order the engine's scheduling decides (a dedup follower's first token
    comes a cycle after its leader's), which is not what this compares."""
    first = {}
    for tc in sorted(store.list("ToolCall", namespace=None),
                     key=lambda tc: (tc.spec.task_ref.name, tc.metadata.creation_timestamp)):
        for i in (tc.metadata.labels["acp.tpu/toolcallrequest"], tc.spec.tool_call_id):
            first.setdefault(i, len(first))
    for t in store.list("Task", namespace=None):
        for m in t.status.context_window:
            for c in m.tool_calls:
                first.setdefault(c.id, len(first))
    return sorted(first, key=first.get)


def _view(store) -> list:
    tasks = {t.name: {"agent": t.spec.agent_ref.name, "user": t.spec.user_message,
                      "parent": t.metadata.labels.get("acp.tpu/parent-toolcall"),
                      "phase": t.status.phase, "status": t.status.status,
                      "detail": t.status.status_detail, "output": t.status.output,
                      "window": [m.model_dump() for m in t.status.context_window]}
             for t in store.list("Task", namespace=None)}
    tcs = sorted(({"task": tc.spec.task_ref.name, "name": tc.name, "tool": tc.spec.tool_ref.name,
                   "type": tc.spec.tool_type, "arguments": tc.spec.arguments,
                   "call_id": tc.spec.tool_call_id, "phase": tc.status.phase,
                   "status": tc.status.status, "result": tc.status.result,
                   "error": tc.status.error}
                  for tc in store.list("ToolCall", namespace=None)),
                 key=lambda d: (d["task"], d["tool"]))
    return normalized([{"tasks": tasks, "toolcalls": tcs}], _call_ids(store))


async def _run_forced_tasks(ns, engine) -> tuple:
    factory = OneTurnFactory(ns.factory.DefaultLLMClientFactory(engine))
    op = ns.operator.Operator(ns.operator.OperatorOptions(
        llm_probe=False, engine=engine, identity=f"{ns.name}-op", enable_rest=False),
        llm_factory=factory)
    _tune(op)
    store = op.store
    for kind, doc in MANIFEST:
        create(ns, store, kind, doc)
    await op.start()
    try:
        async def drive():
            await op.manager.run_until(lambda: all(
                store.get("Agent", a).status.ready for a in set(TASKS.values()) | {"leaf"}),
                timeout=60)
            _freeze_agents(op)
            for name, agent in TASKS.items():
                create(ns, store, "Task", {"metadata": {"name": name}, "spec": {
                    "agentRef": {"name": agent}, "userMessage": f"{name}: check the deploy."}})
            answered = False
            while set(factory.held) != set(FORCED):
                for c in op.human_backend.pending_contacts():
                    op.human_backend.respond(c.call_id, ANSWER)
                    answered = True
                await asyncio.sleep(0.02)
            return answered

        answered = await asyncio.wait_for(drive(), TIMEOUT)
        view = _view(store)
    finally:
        await op.stop()
    return view, answered, dict(factory.turns)


async def test_forced_tasks_match_the_reference_operator(engines):
    jax_engine, port = engines
    steps0 = port.decode_steps
    ref = await _run_forced_tasks(REF, jax_engine)
    ours = await _run_forced_tasks(PORT, port)
    assert ours == ref
    (view,), answered, turns = ours
    assert answered and turns == {"deleg": 2, "asks": 2, "echoes": 2, **(
        {"free": 1} if "free" in turns else {})}
    assert port.decode_steps > steps0
    by_task = {tc["task"]: tc for tc in view["toolcalls"]}
    assert [by_task[t]["tool"] for t in TASKS] == [
        "delegate_to_agent__leaf", "oncall__human_contact_email", "echo__echo"]
    for name in TASKS:
        task, tc = view["tasks"][name], by_task[name]
        assert tc["phase"] in ("Succeeded", "Failed")
        # the first turn: [system, user, assistant call, tool result]; the
        # second is held, so the Task waits ReadyForLLM with its result
        assert task["phase"] == "ReadyForLLM"
        assert [m["role"] for m in task["window"]] == ["system", "user", "assistant", "tool"]
        assert task["window"][2]["tool_calls"][0]["function"]["name"] == tc["tool"]
        assert task["window"][3]["tool_call_id"] == tc["call_id"]
        assert task["window"][3]["content"] == (tc["result"] if tc["phase"] == "Succeeded"
                                                else tc["result"] or f"error: {tc['error']}")
    assert by_task["t-ask"]["result"] == ANSWER
    assert by_task["t-echo"]["result"].startswith("echo: ")
    child = [t for t in view["tasks"].values() if t["parent"]]
    if by_task["t-deleg"]["phase"] == "Succeeded":  # its arguments carried a message
        assert child[0]["phase"] == "FinalAnswer"
        assert by_task["t-deleg"]["result"] == child[0]["output"]
    else:
        assert by_task["t-deleg"]["error"] == "delegate_to_agent requires a message argument"


async def test_stop_with_a_turn_in_flight_then_resume(engines, tmp_path):
    _, port = engines
    db = str(tmp_path / "operator.db")
    doc = _llm("long", 400)
    doc[1]["spec"]["tpu"]["requestTimeoutSeconds"] = 120

    async def start(factory=None):
        op = port_operator.Operator(port_operator.OperatorOptions(
            db_path=db, llm_probe=False, engine=port, enable_rest=False), llm_factory=factory)
        _tune(op)
        await op.start()
        return op

    op = await start()
    try:
        for kind, d in (doc, _agent("talker", "long", "Talk at length.")):
            create(PORT, op.store, kind, d)
        await op.manager.run_until(lambda: op.store.get("Agent", "talker").status.ready,
                                   timeout=30)
        create(PORT, op.store, "Task", {"metadata": {"name": "t-long"}, "spec": {
            "agentRef": {"name": "talker"}, "userMessage": "Tell me everything."}})
        steps0 = port.decode_steps
        await op.manager.run_until(
            lambda: port.stats()["active_slots"] and port.decode_steps > steps0, timeout=60)
    finally:
        await asyncio.wait_for(op.stop(), 30)
    deadline = asyncio.get_running_loop().time() + 30
    while port.stats()["active_slots"] or port.stats()["waiting"]:
        assert asyncio.get_running_loop().time() < deadline, port.stats()
        await asyncio.sleep(0.01)
    # the cancelled turn's pages are back; what is out is held by prefix-cache
    # entries and by slots that earlier tool turns parked
    held = {p for e in port._prefix_cache.values() for p in e["pages"]}
    held |= {p for s, sl in port._slots.items() if sl.parked for p in port._slot_pages[s]}
    assert port.stats()["kv_pages"]["free"] + len(held) == port.num_pages - 1

    store = PORT.K.Store(PORT.K.SqliteBackend(db))  # what a restart finds
    try:
        assert store.get("Task", "t-long").status.phase == "ReadyForLLM"
        assert store.get("Lease", "task-llm-t-long").spec.holder_identity == ""
    finally:
        store.close()
    op = await start()
    try:
        task = await PORT.K.wait_for(op.store, "Task", "t-long", "default",
                                     lambda t: t.status.phase == "FinalAnswer", timeout=120)
        assert [m.role for m in task.status.context_window] == ["system", "user", "assistant"]
    finally:
        await asyncio.wait_for(op.stop(), 30)


@pytest.mark.parametrize("option,value,message", [
    ("store_address", "unix:///tmp/x.sock", r"store_address is not ported yet \(ROADMAP A.12\)"),
    ("serve_store", "tcp://127.0.0.1:0", r"serve_store is not ported yet \(ROADMAP A.12\)"),
    ("store_token", "secret", r"store_token is not ported yet \(ROADMAP A.12\)"),
    ("fleet", object(), r"fleet is not ported yet \(ROADMAP A.12\)"),
])
def test_unported_options_are_refused(option, value, message):
    with pytest.raises(PORT.K.Invalid, match=message):
        port_operator.Operator(port_operator.OperatorOptions(**{option: value}))


async def test_operator_wires_six_controllers_like_the_reference():
    views = []
    for ns in (REF, PORT):
        op = ns.operator.Operator(ns.operator.OperatorOptions(
            task_workers=3, toolcall_workers=2, identity="x", enable_rest=False))
        try:
            views.append(sorted((c.name, c.kind, c.workers, sorted(c.mappers))
                                for c in op.manager._controllers))
            assert op.hl_factory.backend is op.human_backend
            assert op.llm_factory.engine is None and op.task_reconciler.identity == "x"
        finally:
            await op.stop()
    assert views[0] == views[1] and len(views[1]) == 6


async def test_run_operator_stops_the_engine_once_signalled(monkeypatch):
    stopped = []

    class Engine:  # what run_operator stops when the signal comes
        def stop(self):
            stopped.append(True)

    async def signalled():
        await asyncio.sleep(0.05)

    monkeypatch.setattr(port_operator, "serve_until_signalled", signalled)
    await asyncio.wait_for(port_operator.run_operator(
        port_operator.OperatorOptions(engine=Engine(), llm_probe=False, enable_rest=False)), 30)
    assert stopped == [True]
