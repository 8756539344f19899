"""The port's MCP client, adapters, human-layer tool and the MCPServer /
ContactChannel controllers against the JAX package's, on the CPU.

- The reference's ``tests/mcp/test_mcp.py`` stdio cases run on the
  reference's ``MCPManager`` and on the port's, against the same fixture
  server, ``tests/mcp/echo_server.py`` (run by ``sys.executable``, never
  imported): connect and discover, flatten, the Secret-resolved env, a tool
  error, an unconnected server, a reconnect, a memory limit through
  ``/bin/sh``, and concurrent calls to one server (the short call's answer
  arrives first, routed by id). The two give equal tool lists,
  ``server_info``, returned strings and error messages, exactly; the
  reference test's literal expectations are checked besides. The reference's
  HTTP-transport case is replaced by the port's refusal of ``transport:
  http`` (ROADMAP A.16). Every subprocess is closed in a ``finally``.
- Pure functions give the reference's outputs for the same inputs, exactly:
  ``convert_mcp_tools``, ``convert_sub_agents``, ``split_tool_name``,
  ``parse_tool_arguments`` (its messages too), ``flatten_tool_result``,
  ``parse_quantity``, ``convert_env_vars``, ``tool_from_contact_channel``,
  ``merge_choices`` and ``channel_payload``.
- The reference's MCPServer and ContactChannel controller cases (its
  ``test_agent_llm_controllers.py``) are replayed on both packages with the
  reference's stub MCP manager: the same status, requeue and Events. Under
  a Manager, the port's skip an unchanged status write (ROADMAP C).
"""

import asyncio
import dataclasses
import json
import os
import sys
import types

import pytest

import agentcontrolplane_tpu.controllers as ref_controllers
import agentcontrolplane_tpu.llmclient.base as ref_base
import agentcontrolplane_tpu.mcp as ref_mcp
import agentcontrolplane_tpu.mcp.stdio as ref_stdio
import agentcontrolplane_tpu_torch.controllers as port_controllers
import agentcontrolplane_tpu_torch.llmclient.base as port_base
import agentcontrolplane_tpu_torch.mcp as port_mcp
import agentcontrolplane_tpu_torch.mcp.stdio as port_stdio

from .test_torch_task import PORT, REF, create, make_secret

SERVER = os.path.join(os.path.dirname(__file__), "mcp", "echo_server.py")
for ns, mcp, stdio, base, ctl in ((REF, ref_mcp, ref_stdio, ref_base, ref_controllers),
                                  (PORT, port_mcp, port_stdio, port_base, port_controllers)):
    ns.mcp, ns.stdio, ns.base, ns.controllers = mcp, stdio, base, ctl


def echo_server(ns, name="echo", env=None, memory=None):
    spec = {"transport": "stdio", "command": sys.executable, "args": [SERVER], "env": env or []}
    if memory:
        spec["resources"] = {"limits": {"memory": memory}}
    return ns.R.MCPServer.model_validate({"metadata": {"name": name}, "spec": spec})


async def _with_manager(ns, fn, store=None):
    mgr = ns.mcp.MCPManager(store or ns.K.Store())
    try:
        return await asyncio.wait_for(fn(ns, mgr), 30)
    finally:
        await mgr.close()


async def _on_both(fn, store_for=None) -> dict:
    """Run one stdio case on the reference's manager and on the port's,
    against the same fixture server; each gives what it observed."""
    ref, ours = [await _with_manager(ns, fn, store_for(ns) if store_for else None)
                 for ns in (REF, PORT)]
    assert ours == ref
    return ours


async def test_connect_discovers_tools():
    async def run(ns, mgr):
        conn = await mgr.connect_server(echo_server(ns))
        view = {"tools": sorted((t.name, t.description, t.input_schema) for t in conn.tools),
                "server_info": conn.client.server_info,
                "pooled": [t.name for t in mgr.get_tools("echo")], "alive": conn.client.alive}
        return conn, view

    ref_conn, ref_view = await _with_manager(REF, run)
    conn, view = await _with_manager(PORT, run)
    assert view == ref_view
    assert {t[0] for t in view["tools"]} == {"echo", "env", "fail", "sleep"}
    assert view["server_info"]["name"] == "echo-test-server" and view["alive"]
    assert not conn.client.alive and not ref_conn.client.alive  # closed with the manager


async def test_call_tool_flattens_text():
    async def run(ns, mgr):
        await mgr.connect_server(echo_server(ns))
        return await mgr.call_tool("echo", "echo", {"message": "hello mcp"})

    assert await _on_both(run) == "echo: hello mcp"


async def test_secret_env_vars_reach_subprocess():
    def store_for(ns):
        store = ns.K.Store()
        make_secret(ns, store, name="mcp-creds", data={"token": "s3cr3t-value"})
        return store

    async def run(ns, mgr):
        await mgr.connect_server(echo_server(ns, env=[
            {"name": "PLAIN", "value": "plain-value"},
            {"name": "FROM_SECRET", "valueFrom": {"name": "mcp-creds", "key": "token"}}]))
        return [await mgr.call_tool("echo", "env", {"name": n}) for n in ("PLAIN", "FROM_SECRET")]

    assert await _on_both(run, store_for) == ["plain-value", "s3cr3t-value"]


async def test_tool_error_raises():
    async def run(ns, mgr):
        await mgr.connect_server(echo_server(ns))
        with pytest.raises(ns.mcp.MCPError, match="scripted failure") as e:
            await mgr.call_tool("echo", "fail", {})
        return str(e.value)

    await _on_both(run)


async def test_call_unconnected_server_raises():
    async def run(ns, mgr):
        with pytest.raises(ns.mcp.MCPError, match="not connected") as e:
            await mgr.call_tool("ghost", "tool", {})
        return str(e.value)

    assert await _on_both(run) == "MCP server 'ghost' not connected"


async def test_reconnect_replaces_pool_entry():
    async def run(ns, mgr):
        conn1 = await mgr.connect_server(echo_server(ns))
        conn2 = await mgr.connect_server(echo_server(ns))
        return {"replaced": mgr.get_connection("echo") is conn2, "old_alive": conn1.client.alive,
                "call": await mgr.call_tool("echo", "echo", {"message": "x"})}

    assert await _on_both(run) == {"replaced": True, "old_alive": False, "call": "echo: x"}


async def test_stdio_memory_limit_applied():
    """``resources.limits.memory`` reaches the subprocess through a
    ``/bin/sh`` ulimit shim; a generous limit still lets the server run."""
    async def run(ns, mgr):
        conn = await mgr.connect_server(echo_server(ns, name="limited", memory="1Gi"))
        return {"limit": conn.client.memory_limit, "argv": conn.client._argv(),
                "call": await mgr.call_tool("limited", "echo", {"message": "hi"})}

    view = await _on_both(run)
    assert view["limit"] == 1024**3 and view["argv"][:2] == ["/bin/sh", "-c"]
    assert "hi" in view["call"]


async def test_concurrent_calls_to_one_stdio_server_overlap():
    """Two sleeps and an echo on one server: responses are routed by id, so
    the short calls finish while the long one is still sleeping (a reader
    that served one request at a time would finish the long one first)."""
    async def run(ns, mgr):
        await mgr.connect_server(echo_server(ns))
        done = []

        async def call(tool, args):
            out = await mgr.call_tool("echo", tool, args)
            done.append(out)
            return out

        results = await asyncio.gather(call("sleep", {"seconds": 0.6}),
                                       call("sleep", {"seconds": 0.05}),
                                       call("echo", {"message": "while sleeping"}))
        return {"results": results, "last": done[-1]}

    assert await _on_both(run) == {
        "results": ["slept 0.6", "slept 0.05", "echo: while sleeping"], "last": "slept 0.6"}


async def test_http_transport_is_refused():
    server = PORT.R.MCPServer.model_validate(
        {"metadata": {"name": "httpd"}, "spec": {"transport": "http", "url": "http://x/mcp"}})
    mgr = port_mcp.MCPManager(PORT.K.Store())
    with pytest.raises(PORT.K.Invalid, match=r"transport http is not ported yet \(ROADMAP A.16\)"):
        await mgr.connect_server(server)
    assert mgr.get_connection("httpd") is None


# -- pure functions, against the reference ------------------------------------

TOOLS = [{"name": "fetch", "description": "d", "inputSchema": {"type": "object"}},
         {"name": "bare"}, {"name": "deep__er", "description": "x",
                            "inputSchema": {"type": "object", "properties": {"q": {}}}}]


def _tool(t) -> tuple:
    return (t.type, t.function.name, t.function.description, t.function.parameters,
            t.acp_tool_type)


def _pure_view(ns) -> dict:
    R, M = ns.R, ns.mcp
    store = ns.K.Store()
    make_secret(ns, store, name="creds", data={"t": "v"})
    server = R.MCPServer.model_validate({"metadata": {"name": "s"}, "spec": {
        "transport": "stdio", "command": "c", "env": [
            {"name": "A", "value": "1"}, {"name": "B", "valueFrom": {"name": "creds", "key": "t"}},
            {"name": "C"}]}})
    agents = [R.Agent.model_validate({"metadata": {"name": n}, "spec": {
        "llmRef": {"name": "l"}, "system": "s", "description": d}})
        for n, d in (("researcher", "does research"), ("blank", ""))]
    channels = [R.ContactChannel.model_validate({"metadata": {"name": n}, "spec": spec})
                for n, spec in (
                    ("mail", {"type": "email", "email": {"address": "a@b.c",
                                                         "contextAboutUser": "the on-call"}}),
                    ("mail2", {"type": "email"}),
                    ("chat", {"type": "slack", "slack": {"channelOrUserId": "C123",
                                                         "contextAboutChannelOrUser": "ops"}}),
                    ("chat2", {"type": "slack", "channelId": "C999"}))]

    def outcome(fn, *a):
        try:
            return ("ok", fn(*a))
        except Exception as e:
            return (type(e).__name__, str(e))

    msgs = [ns.assistant("first"), ns.tool_call_message(("a__b", {"x": 1})), ns.assistant("")]
    merged = [ns.base.merge_choices(c).model_dump() for c in (msgs, msgs[:1], msgs[2:], [])]
    return {
        "mcp_tools": [_tool(t) for t in M.convert_mcp_tools(
            [R.MCPTool.model_validate(t) for t in TOOLS], "web")],
        "sub_agents": [_tool(t) for t in M.convert_sub_agents(agents)],
        "split": [outcome(M.split_tool_name, n) for n in ("web__fetch", "web__fetch__deep",
                                                          "bare", "__x", "x__")],
        "args": [outcome(M.parse_tool_arguments, a) for a in (
            '{"a": 1}', "", "[1,2]", "{broken", "null", '{"n": {"m": [1]}}')],
        "flatten": [outcome(M.flatten_tool_result, r) for r in (
            {"content": [{"type": "text", "text": "line1"}, {"type": "image", "data": "abc"},
                         {"type": "text", "text": "line2"}]},
            {"content": []}, {},
            {"isError": True, "content": [{"type": "text", "text": "bad"}]},
            {"isError": True})],
        "quantity": [outcome(ns.stdio.parse_quantity, q) for q in (
            "512Mi", "1Gi", "100M", "2048", "1.5Gi", " 2k ", "3Ti")],
        "env": M.convert_env_vars(store, "default", server),
        "channel_tools": [_tool(ns.base.tool_from_contact_channel(c)) for c in channels],
        "payloads": [ns.controllers.channel_payload(c, t) for c in channels
                     for t in (None, "thread-1")],
        "merged": merged,
        "schema": ns.base.MESSAGE_SCHEMA,
    }


def test_pure_functions_match_the_reference():
    ours, ref = _pure_view(PORT), _pure_view(REF)
    assert json.loads(json.dumps(ours)) == json.loads(json.dumps(ref))
    assert ours["split"][:3] == [("ok", ("web", "fetch")), ("ok", ("web", "fetch__deep")),
                                 ("ValueError", "tool name 'bare' is not of the form server__tool")]


# -- the MCPServer and ContactChannel controllers ------------------------------


class StubMCPManager:
    """The reference test's scriptable MCP manager."""

    def __init__(self, ns, fail=False):
        self.ns, self.fail, self.connected = ns, fail, {}

    async def connect_server(self, server):
        if self.fail:
            raise RuntimeError("spawn failed")
        conn = self.ns.mcp.MCPConnection(
            name=server.metadata.name, client=types.SimpleNamespace(alive=True),
            tools=[self.ns.R.MCPTool(name="fetch", description="fetch a url")])
        self.connected[server.metadata.name] = conn
        return conn

    def get_connection(self, name):
        return self.connected.get(name)

    async def disconnect_server(self, name):
        self.connected.pop(name, None)


CHANNEL = {"type": "email", "apiKeyFrom": {"name": "test-secret", "key": "api-key"},
           "email": {"address": "human@example.com"}}
CONTROLLER_CASES = {
    # kind, spec, secret?, fail?, human layer?, verify?
    "contactchannel-validation": ("ContactChannel", CHANNEL, True, False, True, True),
    "contactchannel-bad-email": ("ContactChannel", {**CHANNEL, "email": {
        "address": "not-an-email"}}, True, False, False, False),
    "contactchannel-missing-secret": ("ContactChannel", CHANNEL, False, False, True, True),
    "contactchannel-verify-fails": ("ContactChannel", CHANNEL, True, True, True, True),
    "mcpserver-connects": ("MCPServer", {"transport": "stdio", "command": "uvx",
                                         "args": ["mcp-server-fetch"]}, False, False, None, None),
    "mcpserver-connect-failure": ("MCPServer", {"transport": "stdio", "command": "nope"},
                                  False, True, None, None),
    "mcpserver-invalid-spec": ("MCPServer", {"transport": "stdio"}, False, False, None, None),
    "mcpserver-awaits-approval-channel": ("MCPServer", {
        "transport": "stdio", "command": "uvx", "approvalContactChannel": "nobody"},
        False, False, None, None),
}


async def _controller_case(ns, case) -> dict:
    kind, spec, secret, fail, hl, verify = CONTROLLER_CASES[case]
    store = ns.K.Store()
    if secret:
        make_secret(ns, store)
    if kind == "MCPServer":
        rec = ns.controllers.MCPServerReconciler(store, ns.K.EventRecorder(store),
                                                 StubMCPManager(ns, fail))
    else:
        backend = ns.HL.LocalHumanBackend(should_fail=fail)
        rec = ns.controllers.ContactChannelReconciler(
            store, ns.K.EventRecorder(store),
            ns.HL.LocalHumanLayerClientFactory(backend) if hl else None,
            verify_credentials=verify)
    create(ns, store, kind, {"metadata": {"name": "x"}, "spec": spec})
    results = [dataclasses.astuple(await rec.reconcile((kind, "default", "x"))) for _ in range(2)]
    obj = store.get(kind, "x")
    events = sorted((e.spec.type, e.spec.reason, e.spec.message, e.spec.count)
                    for e in ns.K.EventRecorder(store).events_for(obj))
    return {"status": obj.status.model_dump(), "results": results, "events": events}


@pytest.mark.parametrize("case", CONTROLLER_CASES)
async def test_mcpserver_and_contactchannel_controllers_match_the_reference(case):
    ref, ours = await _controller_case(REF, case), await _controller_case(PORT, case)
    assert ours == ref
    want = {"contactchannel-validation": "Ready", "mcpserver-connects": "Ready",
            "mcpserver-awaits-approval-channel": "Pending"}.get(case, "Error")
    assert ours["status"]["status"] == want


async def test_failing_server_and_channel_are_not_rewritten_under_a_manager():
    """The port's MCPServer and ContactChannel controllers skip a status
    write that changes nothing (ROADMAP C): under a Manager, a server that
    fails to connect is respawned once on its first Error write's event and
    then only after the 30 s retry, and an Error channel keeps its resource
    version."""
    store = PORT.K.Store()
    mgr = PORT.K.Manager(store)
    stub = StubMCPManager(PORT, fail=True)
    attempts = []
    connect = stub.connect_server

    async def counted(server):
        attempts.append(server.name)
        return await connect(server)

    stub.connect_server = counted
    mgr.add_controller("mcpserver", "MCPServer", port_controllers.MCPServerReconciler(
        store, mgr.recorder, stub))
    mgr.add_controller("contactchannel", "ContactChannel", port_controllers.ContactChannelReconciler(
        store, mgr.recorder, None, verify_credentials=False))
    await mgr.start()
    try:
        create(PORT, store, "MCPServer", {"metadata": {"name": "s"},
                                          "spec": {"transport": "stdio", "command": "nope"}})
        create(PORT, store, "ContactChannel", {"metadata": {"name": "c"}, "spec": CHANNEL})
        keys = [("MCPServer", "s"), ("ContactChannel", "c")]
        await mgr.run_until(lambda: all(store.get(*k).status.status == "Error" for k in keys),
                            timeout=10)
        rvs = {k: store.get(*k).metadata.resource_version for k in keys}
        tries = len(attempts)
        await asyncio.sleep(0.3)
        assert {k: store.get(*k).metadata.resource_version for k in keys} == rvs
        # the first failure's status write brings one more attempt, then none
        assert len(attempts) == tries <= 2
    finally:
        await mgr.stop()
