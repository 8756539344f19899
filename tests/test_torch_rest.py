"""The port's operator REST API against the JAX package's, on the CPU.

Each case of the reference's ``tests/server/test_rest.py`` and
``tests/server/test_tls.py`` that this slice serves (the fleet routes are
ROADMAP A.12) runs twice: on a
reference ``Operator`` (aiohttp, on its event loop in a thread) and on the
port's (``ThreadingHTTPServer``), each with ``enable_rest=True`` on an
ephemeral port and a ``MockLLMClient`` script. The same ``urllib``
requests go to both, and every reply's status code and JSON body must be
equal after normalization: random names (``<agent>-task-xxxxxxxx``) and
random ids are numbered in order of first appearance, and uids, resource
versions, timestamps and span ids are dropped. Where the reference's text
is not its own (aiohttp's 404/405 pages, pydantic's messages) only the
status is compared, and the case says so. The reference's own assertions
are made on the port's replies too. TLS, mTLS, bearer auth, client-CA and
certificate rotation run on both servers with the same clients.

One case serves ``/v1/chat/completions`` through both operators over a
tiny f32 engine pair (the port's from ``params_from_jax`` of the JAX
engine's weights): the greedy reply must be byte-identical. Another serves
a request there and then the engine's observability routes
(``/v1/engine/perf``, ``/v1/engine/flight``, ``/v1/engine/trace``,
``/v1/requests/{rid}/timeline``): equal statuses, keys, event kinds,
programs and ledgers, and the reference's error bodies.

Agents made Ready by the helpers are frozen on both operators (their
controller would otherwise revalidate them in a loop on the reference,
ROADMAP C).
"""

import asyncio
import dataclasses
import json
import re
import ssl
import threading
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import agentcontrolplane_tpu.operator as ref_operator
import agentcontrolplane_tpu_torch.operator as port_operator
from agentcontrolplane_tpu_torch.kernel import Result

from .server.test_tls import _make_cert
from .test_torch_task import PORT, REF, create, make_agent, make_llm, make_task

NS = {"ref": types.SimpleNamespace(**{**vars(REF), "operator": ref_operator}),
      "port": types.SimpleNamespace(**{**vars(PORT), "operator": port_operator})}
ROOT = Path(__file__).resolve().parents[1]
GETTING_STARTED = (ROOT / "examples" / "getting-started.yaml").read_text()
TIMEOUT = 30.0
_DROP = {"uid", "resource_version", "resourceVersion", "trace_id", "span_id", "traceId",
         "spanId", "parent_span_id"}
_RANDOM = re.compile(r"-task-[a-z0-9]{8}\b")


async def _done(key):
    return Result()


class Live:
    """One operator of a package with its REST server on an ephemeral
    port, on an event loop in a thread of its own; the test thread talks
    to it over HTTP and runs store work on its loop."""

    def __init__(self, pkg: str, engine=None, **opts):
        self.ns = NS[pkg]
        self.engine, self.opts = engine, opts
        self.mock = self.ns.MockLLMClient()

    def __enter__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        try:
            self.op = self.sync(self._start())
        except BaseException:
            self._close_loop()
            raise
        scheme = "https" if self.opts.get("tls_cert_path") else "http"
        self.base = f"{scheme}://127.0.0.1:{self.op.rest_server.bound_port}"
        return self

    async def _start(self):
        ns = self.ns
        op = ns.operator.Operator(
            ns.operator.OperatorOptions(enable_rest=True, api_port=0, llm_probe=False,
                                        verify_channel_credentials=False, engine=self.engine,
                                        **self.opts),
            llm_factory=ns.MockLLMClientFactory(self.mock))
        op.task_reconciler.requeue_delay = 0.02
        op.toolcall_reconciler.poll_interval = 0.02
        op.agent_reconciler.requeue_delay = 0.05
        await op.start()
        for _ in range(500):
            if op.rest_server.bound_port:
                return op
            await asyncio.sleep(0.01)
        raise TimeoutError("the REST server did not bind")

    def __exit__(self, *exc):
        try:
            self.sync(self.op.stop())
        finally:
            self._close_loop()

    def _close_loop(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(TIMEOUT)
        self.loop.close()

    # -- helpers ------------------------------------------------------------

    def sync(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(TIMEOUT)

    def on_loop(self, fn, *args, **kw):
        async def run():
            return fn(*args, **kw)
        return self.sync(run())

    @property
    def store(self):
        return self.op.store

    def freeze(self, *reconcilers):
        for name in reconcilers:
            self.on_loop(setattr, getattr(self.op, f"{name}_reconciler"), "reconcile", _done)

    def setup(self, agent="helper", **agent_kw):
        """A Ready mock LLM and a Ready Agent, the Agent controller frozen."""
        self.freeze("agent")
        self.on_loop(make_llm, self.ns, self.store)
        self.on_loop(make_agent, self.ns, self.store, name=agent, **agent_kw)

    def script(self, *answers):
        self.mock.script.extend(self.ns.assistant(a) for a in answers)

    def call(self, method, path, body=None, data=None, headers=None, context=None):
        return call(self.base + path, method, body, data, headers, context)

    def wait(self, pred, what="condition"):
        deadline = time.monotonic() + TIMEOUT
        while not pred():
            assert time.monotonic() < deadline, f"timed out waiting for {what}"
            time.sleep(0.02)

    def wait_task(self, name, *phases):
        self.wait(lambda: self.call("GET", f"/v1/tasks/{name}")[1].get("phase") in phases,
                  f"task {name} in {phases}")


def call(url, method="GET", body=None, data=None, headers=None, context=None):
    """(status, parsed JSON or text) of one request."""
    headers = dict(headers or {})
    if body is not None:
        data = json.dumps(body).encode()
        headers["Content-Type"] = "application/json"
    elif isinstance(data, str):
        data = data.encode()
    req = urllib.request.Request(url, data=data, method=method, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT, context=context) as resp:
            status, raw, ctype = resp.status, resp.read().decode(), resp.headers.get_content_type()
    except urllib.error.HTTPError as e:
        status, raw, ctype = e.code, e.read().decode(), e.headers.get_content_type()
    return status, json.loads(raw) if ctype == "application/json" else raw


def normalized(obs):
    """Random names and ids numbered in order of first appearance; uids,
    resource versions, timestamps and span ids dropped."""
    seen: dict = {}

    def name(m):
        return "-task-<%d>" % seen.setdefault(m.group(0), len(seen))

    def walk(x):
        if isinstance(x, dict):
            out = {}
            for k, v in x.items():
                if k in _DROP:
                    continue
                low = k.lower()
                if low.endswith(("timestamp", "time")) or low == "created":
                    v = "<time>" if v is not None else None
                out[k] = walk(v)
            return out
        if isinstance(x, (list, tuple)):
            return [walk(v) for v in x]
        if isinstance(x, str):
            return _RANDOM.sub(name, x)
        return x

    return walk(obs)


def both(case, **opts):
    """Run ``case(h)`` on the reference's operator, then on the port's;
    the observations must be equal after normalization. Returns the port's."""
    views = {}
    for pkg in ("ref", "port"):
        with Live(pkg, **opts) as h:
            views[pkg] = case(h)
    assert normalized(views["port"]) == normalized(views["ref"])
    return views["port"]


def status_only(reply):
    return reply[0]


# -- the replayed cases ---------------------------------------------------------


def case_create_task_and_poll_to_completion(h):
    h.setup()
    h.script("Paris")
    created = h.call("POST", "/v1/tasks",
                     {"agentName": "helper", "userMessage": "capital of france?"})
    assert created[0] == 201 and created[1]["name"].startswith("helper-task-")
    assert created[1]["userMsgPreview"] == ""  # not yet reconciled
    name = created[1]["name"]
    h.wait_task(name, "FinalAnswer")
    got = h.call("GET", f"/v1/tasks/{name}")
    assert got[1]["output"] == "Paris"
    assert [m["role"] for m in got[1]["contextWindow"]] == ["system", "user", "assistant"]
    return [created, got, h.call("GET", "/v1/tasks"), h.call("GET", "/v1/tasks?namespace=other"),
            h.call("GET", "/v1/tasks/ghost")]


def case_create_task_missing_agent_404(h):
    return [h.call("POST", "/v1/tasks", {"agentName": "ghost", "userMessage": "hi"}),
            h.call("POST", "/v1/tasks", {"userMessage": "hi"})]


def case_create_task_strict_decode_rejects_unknown_fields(h):
    h.setup()
    out = [h.call("POST", "/v1/tasks",
                  {"agentName": "helper", "userMessage": "hi", "bogusField": 1}),
           h.call("POST", "/v1/tasks", data=b"{broken"),
           h.call("POST", "/v1/tasks", body=[1, 2])]
    assert out[0][0] == 400 and "unknown fields" in out[0][1]["error"]
    return out


def case_create_task_requires_exactly_one_input(h):
    h.setup()
    out = [h.call("POST", "/v1/tasks", {"agentName": "helper"}),
           h.call("POST", "/v1/tasks", {"agentName": "helper", "userMessage": "x",
                                        "contextWindow": [{"role": "user", "content": "y"}]}),
           h.call("POST", "/v1/tasks", {"agentName": "helper",
                                        "contextWindow": [{"role": "system", "content": "y"}]})]
    assert [o[0] for o in out] == [400, 400, 400]
    # a contextWindow the model refuses: the reference's text is pydantic's
    bad = h.call("POST", "/v1/tasks", {"agentName": "helper",
                                       "contextWindow": [{"role": "robot", "content": "y"}]})
    return out + [status_only(bad)]


def case_create_task_from_context_window(h):
    h.setup()
    h.script("Lyon")
    created = h.call("POST", "/v1/tasks", {
        "agentName": "helper", "contactChannelRef": "",
        "contextWindow": [{"role": "system", "content": "s"}, {"role": "user", "content": "u"}]})
    h.wait_task(created[1]["name"], "FinalAnswer")
    return [created, h.call("GET", f"/v1/tasks/{created[1]['name']}")]


def case_create_agent_creates_llm_and_secret(h):
    created = h.call("POST", "/v1/agents", {
        "name": "writer", "systemPrompt": "you write",
        "llm": {"provider": "mock", "model": "m", "apiKey": "sk-123"}})
    assert created[0] == 201
    assert h.on_loop(h.store.get, "Secret", "writer-llm-key").spec.data == {"api-key": "sk-123"}
    dup = h.call("POST", "/v1/agents",
                 {"name": "writer", "systemPrompt": "x", "llm": {"provider": "mock"}})
    assert dup[0] == 409
    missing = h.call("POST", "/v1/agents", {"name": "w2", "llm": {"provider": "mock"}})
    unknown = h.call("POST", "/v1/agents", {"name": "w3", "bogus": 1})
    # a provider the model refuses: pydantic's text in the reference; the
    # partial LLM and Secret are removed on both
    bad = h.call("POST", "/v1/agents", {"name": "w4", "systemPrompt": "x",
                                        "llm": {"provider": "bogus", "apiKey": "k"}})
    assert bad[0] == 400 and h.on_loop(h.store.try_get, "Secret", "w4-llm-key") is None
    h.wait(lambda: h.call("GET", "/v1/agents/writer")[1]["ready"], "agent writer Ready")
    h.freeze("agent")
    got = h.call("GET", "/v1/agents/writer")
    assert got[1]["llmRef"] == "writer-llm"
    return [created, dup, missing, unknown, status_only(bad), got, h.call("GET", "/v1/agents"),
            h.call("GET", "/v1/agents/ghost"), h.call("GET", "/v1/resources/LLM/writer-llm")]


def case_v1beta3_event_fabricates_channel_and_task(h):
    h.setup(agent="support")
    h.script("I'll help with that")
    created = h.call("POST", "/v1/beta3/events", {
        "type": "agent_slack.received", "agentName": "support", "channelApiKey": "xoxb-token",
        "event": {"message": "help me", "thread_ts": "171717.42", "channel_id": "C0AAAAAAAAA",
                  "event_id": "ev12345"}})
    assert created[0] == 201 and created[1]["channel"] == "v1beta3-channel-ev12345"
    task = h.on_loop(h.store.get, "Task", created[1]["taskName"])
    assert task.metadata.labels["acp.tpu/v1beta3"] == "true"
    assert task.spec.thread_id == "171717.42"
    h.wait_task(created[1]["taskName"], "FinalAnswer", "Failed")
    got = h.call("GET", f"/v1/tasks/{created[1]['taskName']}")
    assert got[1]["phase"] == "FinalAnswer" and got[1]["output"] == "I'll help with that"
    return [created, got, h.call("GET", "/v1/resources/ContactChannel/v1beta3-channel-ev12345"),
            h.call("POST", "/v1/beta3/events", {"type": "agent_email.bounced"}),
            h.call("POST", "/v1/beta3/events", {"agentName": "support"}),
            h.call("POST", "/v1/beta3/events", {"agentName": "ghost", "message": "m"}),
            h.call("POST", "/v1/beta3/events", data=b"{")]


def case_approvals_endpoint_roundtrip(h):
    client = h.op.hl_factory.create_client("")
    spec = h.ns.HL.FunctionCallSpec(fn="web__fetch", kwargs={"url": "x"})
    h.sync(client.request_approval("run1", "call-abc", spec))
    h.sync(client.request_approval("run2", "call-def", spec))
    out = [h.call("GET", "/v1/approvals"),
           h.call("POST", "/v1/approvals/call-abc/approve?comment=ok"),
           h.call("POST", "/v1/approvals/call-def/reject"),
           h.call("POST", "/v1/approvals/call-zzz/approve")]
    status = h.sync(client.get_function_call_status("call-abc"))
    assert status.approved is True and status.comment == "ok"
    rejected = h.sync(client.get_function_call_status("call-def"))
    assert rejected.approved is False
    return out + [h.call("GET", "/v1/approvals")]


def case_contacts_endpoint_roundtrip(h):
    client = h.op.hl_factory.create_client("")
    h.sync(client.request_human_contact("run1", "call-h", "which region?"))
    out = [h.call("GET", "/v1/contacts"),
           h.call("POST", "/v1/contacts/call-h/respond", {"response": 7}),
           h.call("POST", "/v1/contacts/call-h/respond", data=b"{"),
           h.call("POST", "/v1/contacts/call-zzz/respond", {"response": "x"}),
           h.call("POST", "/v1/contacts/call-h/respond", {"response": "eu-west"})]
    assert h.sync(client.get_human_contact_status("call-h")).response == "eu-west"
    return out + [h.call("GET", "/v1/contacts")]


def case_metrics_and_health(h):
    health = [h.call("GET", "/healthz"), h.call("GET", "/readyz")]
    metrics = h.call("GET", "/metrics")
    assert health[0][1]["status"] == "ok" and metrics[0] == 200
    return health + [status_only(metrics)]


def _task_lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith("acp_objects{") and 'kind="Task"' in ln and 'phase="unknown"' in ln]


def case_metrics_phase_gauges_track_and_zero_out(h):
    h.setup()
    h.freeze("task")  # the Task stays where make_task leaves it
    h.on_loop(make_task, h.ns, h.store, name="t1", agent="helper", user_message="hi")
    first = _task_lines(h.call("GET", "/metrics")[1])
    assert len(first) == 1 and first[0].endswith(" 1.0")
    h.on_loop(h.store.delete, "Task", "t1")
    zeroed = _task_lines(h.call("GET", "/metrics")[1])
    assert len(zeroed) == 1 and zeroed[0].endswith(" 0.0")  # zeroed, not stale
    gone = _task_lines(h.call("GET", "/metrics")[1])
    assert gone == []  # and dropped on the next scrape
    return [first, zeroed, gone]


def case_update_agent_patch(h):
    h.setup()
    out = [h.call("PATCH", "/v1/agents/helper",
                  {"systemPrompt": "new prompt", "description": "d2"})]
    agent = h.on_loop(h.store.get, "Agent", "helper")
    assert agent.spec.system == "new prompt" and agent.metadata.generation == 2
    out += [h.call("PATCH", "/v1/agents/helper", {"systemPrompt": ""}),
            h.call("PATCH", "/v1/agents/helper", {"bogus": 1}),
            h.call("PATCH", "/v1/agents/ghost", {"description": "x"}),
            h.call("PATCH", "/v1/agents/helper", {"mcpServers": ["fetch"], "subAgents": ["a"]}),
            h.call("GET", "/v1/resources/Agent/helper")]
    return out


def case_update_agent_rejects_bad_types(h):
    h.setup()
    out = [h.call("PATCH", "/v1/agents/helper", bad) for bad in (
        {"systemPrompt": 123}, {"mcpServers": "tools"}, {"mcpServers": [5]}, {"subAgents": [""]})]
    assert [o[0] for o in out] == [400] * 4
    assert h.on_loop(h.store.get, "Agent", "helper").spec.system == "you are a helpful assistant"
    return out


def case_delete_task_and_agent_endpoints(h):
    h.setup()
    h.script("hi")
    name = h.call("POST", "/v1/tasks", {"agentName": "helper", "userMessage": "x"})[1]["name"]
    out = [h.call("DELETE", f"/v1/tasks/{name}"), h.call("DELETE", f"/v1/tasks/{name}")]
    assert out[0][0] == 200 and out[1][0] == 404
    assert h.on_loop(h.store.try_get, "Task", name) is None
    return out + [h.call("DELETE", "/v1/agents/helper"), h.call("DELETE", "/v1/agents/helper")]


def case_chat_completions_without_engine_503(h):
    return [h.call("POST", "/v1/chat/completions",
                   {"messages": [{"role": "user", "content": "x"}]}),
            h.call("GET", "/v1/engine"), h.call("GET", "/v1/models")]


def case_secret_data_redacted_on_resource_endpoints(h):
    h.on_loop(create, h.ns, h.store, "Secret",
              {"metadata": {"name": "llm-key"}, "spec": {"data": {"api-key": "sk-super-secret"}}})
    one, many = h.call("GET", "/v1/resources/Secret/llm-key"), h.call("GET", "/v1/resources/Secret")
    assert "sk-super-secret" not in json.dumps([one, many])
    assert one[1]["spec"]["data"] == {"api-key": "<redacted>"}
    assert h.on_loop(h.store.get, "Secret", "llm-key").spec.data["api-key"] == "sk-super-secret"
    return [one, many]


def case_list_models_endpoint(h):
    # the LLM controller frozen before either LLM exists: with llm_probe off
    # it marks a mock LLM Ready, so whether "other" is reported ready would
    # depend on which ran first on each operator
    h.freeze("llm")
    h.setup()
    h.on_loop(make_llm, h.ns, h.store, name="other", ready=False)
    return [h.call("GET", "/v1/models")]


def case_apply_endpoint_and_generic_resources(h):
    applied = h.call("POST", "/v1/apply", data=GETTING_STARTED)
    assert applied[0] == 200 and {(a["kind"], a["action"]) for a in applied[1]} == {
        ("Secret", "created"), ("LLM", "created"), ("Agent", "created"), ("Task", "created")}
    agent = h.call("GET", "/v1/resources/Agent/my-assistant")
    assert agent[1]["spec"]["llm_ref"]["name"] == "gpt-4o"
    h.freeze("agent", "llm", "task")  # the objects stay as applied
    out = [applied,
           h.call("POST", "/v1/apply", data=GETTING_STARTED),  # configured, not created
           h.call("GET", "/v1/resources/Task?labelSelector=acp.tpu/agent=x"),
           h.call("GET", "/v1/resources/Secret?labelSelector=bogus"),
           h.call("GET", "/v1/resources/Bogus"), h.call("GET", "/v1/resources/Bogus/x"),
           h.call("DELETE", "/v1/resources/Task/hello-world-1"),
           h.call("GET", "/v1/resources/Task/hello-world-1"),
           h.call("DELETE", "/v1/resources/Task/hello-world-1"),
           h.call("DELETE", "/v1/resources/Bogus/x"),
           h.call("POST", "/v1/apply", data="kind: Nope\nmetadata: {name: x}"),
           h.call("POST", "/v1/apply", data="kind: Task\nmetadata: {}\n"),
           h.call("POST", "/v1/apply", data="")]
    assert out[7][0] == 404 and out[10][0] == 400
    return out


def case_engine_status_endpoint_unconfigured(h):
    return [h.call("GET", "/v1/engine")]


def case_events_after_a_task(h):
    h.setup()
    h.script("done")
    name = h.call("POST", "/v1/tasks", {"agentName": "helper", "userMessage": "go"})[1]["name"]
    h.wait_task(name, "FinalAnswer")
    return [h.call("GET", "/v1/events"), h.call("GET", "/v1/events?namespace=other")]


def case_chunked_request_body(h):
    """A body sent with ``Transfer-Encoding: chunked`` (no Content-Length),
    then a second request on the same kept-alive connection."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", int(h.base.rsplit(":", 1)[1]), timeout=10)
    try:
        halves = GETTING_STARTED.split("---", 1)
        conn.request("POST", "/v1/apply", body=iter([halves[0].encode(), b"---",
                                                    halves[1].encode()]),
                     encode_chunked=True)
        resp = conn.getresponse()
        first = (resp.status, json.loads(resp.read()))
        conn.request("GET", "/v1/resources/Secret/openai-key")
        resp = conn.getresponse()
        second = (resp.status, json.loads(resp.read()))
    finally:
        conn.close()
    assert first[0] == 200 and len(first[1]) == 4 and second[0] == 200
    h.freeze("agent", "llm", "task")
    return [first, second]


def case_unknown_path_and_method(h):
    # aiohttp's 404 and 405 pages are its own text: statuses only
    return [status_only(h.call("GET", "/v1/nothing")),
            status_only(h.call("PUT", "/v1/tasks")),
            status_only(h.call("DELETE", "/v1/agents"))]


CASES = [v for k, v in sorted(globals().items()) if k.startswith("case_")]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__[len("case_"):])
def test_rest_case_matches_the_reference(case):
    both(case)


def test_bearer_token_auth():
    def case(h):
        auth = {"Authorization": "Bearer t0ps3cret"}
        out = [h.call("GET", "/v1/tasks"), h.call("GET", "/healthz"), h.call("GET", "/readyz"),
               h.call("GET", "/v1/tasks", headers=auth),
               h.call("GET", "/v1/tasks", headers={"Authorization": "Bearer wrong"}),
               h.call("GET", "/v1/tasks", headers={"Authorization": "t0ps3cret"}),
               h.call("POST", "/v1/tasks", {"agentName": "a", "userMessage": "b"}),
               h.call("GET", "/metrics"), h.call("GET", "/v1/nothing")]
        assert [o[0] for o in out] == [401, 200, 200, 200, 401, 401, 401, 401, 401]
        return out
    both(case, api_token="t0ps3cret")


# -- TLS ------------------------------------------------------------------------


def _client_ssl(ca_path, cert_path=None, key_path=None) -> ssl.SSLContext:
    ctx = ssl.create_default_context(cafile=str(ca_path))
    ctx.check_hostname = False
    if cert_path is not None:
        ctx.load_cert_chain(str(cert_path), str(key_path))
    return ctx


def _tls_get(h, path, ctx, **kw):
    """The status of a GET over TLS, or the class of handshake failure."""
    try:
        return h.call("GET", path, context=ctx, **kw)[0]
    except (urllib.error.URLError, ConnectionError, ssl.SSLError, OSError):
        return "refused"


def test_https_serving(tmp_path):
    cert, key, *_ = _make_cert(tmp_path, "server", "acp-tpu")

    def case(h):
        out = [h.call("GET", "/healthz", context=_client_ssl(cert))]
        try:  # plaintext to the TLS port fails instead of serving
            call(h.base.replace("https", "http") + "/healthz")
            plain = "served"
        except (urllib.error.URLError, ConnectionError, OSError):
            plain = "refused"
        assert out[0] == (200, {"status": "ok"}) and plain == "refused"
        return out + [plain]
    both(case, tls_cert_path=str(cert), tls_key_path=str(key))


def test_https_with_bearer_token(tmp_path):
    cert, key, *_ = _make_cert(tmp_path, "server", "acp-tpu")

    def case(h):
        ctx = _client_ssl(cert)
        out = [_tls_get(h, "/healthz", ctx), _tls_get(h, "/metrics", ctx),
               _tls_get(h, "/metrics", ctx, headers={"Authorization": "Bearer s3cret"})]
        assert out == [200, 401, 200]
        return out
    both(case, tls_cert_path=str(cert), tls_key_path=str(key), api_token="s3cret")


def test_mtls_requires_client_cert(tmp_path):
    ca_cert, _, ca_obj, ca_key = _make_cert(tmp_path, "ca", "acp-ca", is_ca=True)
    cert, key, *_ = _make_cert(tmp_path, "server", "acp-tpu")
    client_cert, client_key, *_ = _make_cert(tmp_path, "client", "acp-client",
                                             issuer_key=ca_key, issuer_cert=ca_obj)

    def case(h):
        out = [_tls_get(h, "/healthz", _client_ssl(cert)),
               _tls_get(h, "/healthz", _client_ssl(cert, client_cert, client_key))]
        assert out == ["refused", 200]
        return out
    both(case, tls_cert_path=str(cert), tls_key_path=str(key),
         tls_client_ca_path=str(ca_cert))


def test_client_ca_rotation_revokes_old_ca(tmp_path, monkeypatch):
    monkeypatch.setenv("ACP_TLS_RELOAD_INTERVAL_S", "0.1")
    ca1_cert, _, ca1_obj, ca1_key = _make_cert(tmp_path, "ca1", "acp-ca1", is_ca=True)
    ca2_cert, _, ca2_obj, ca2_key = _make_cert(tmp_path, "ca2", "acp-ca2", is_ca=True)
    cert, key, *_ = _make_cert(tmp_path, "server", "acp-tpu")
    c1 = _make_cert(tmp_path, "c1", "client-1", issuer_key=ca1_key, issuer_cert=ca1_obj)[:2]
    c2 = _make_cert(tmp_path, "c2", "client-2", issuer_key=ca2_key, issuer_cert=ca2_obj)[:2]
    client_ca = tmp_path / "client-ca.pem"

    def case(h):
        before = _tls_get(h, "/healthz", _client_ssl(cert, *c1))
        client_ca.write_bytes(ca2_cert.read_bytes())  # rotate CA1 -> CA2
        deadline = time.monotonic() + 10
        while _tls_get(h, "/healthz", _client_ssl(cert, *c2)) != 200:
            assert time.monotonic() < deadline, "the rotated-in client CA was never accepted"
            time.sleep(0.1)
        after = _tls_get(h, "/healthz", _client_ssl(cert, *c1))  # a fresh handshake
        client_ca.write_bytes(ca1_cert.read_bytes())  # back, for the other server
        assert (before, after) == (200, "refused")
        return [before, after]

    client_ca.write_bytes(ca1_cert.read_bytes())
    both(case, tls_cert_path=str(cert), tls_key_path=str(key),
         tls_client_ca_path=str(client_ca))


def test_cert_rotation_without_restart(tmp_path, monkeypatch):
    monkeypatch.setenv("ACP_TLS_RELOAD_INTERVAL_S", "0.1")
    old_cert, old_key, *_ = _make_cert(tmp_path, "old", "acp-old")
    new_cert, new_key, *_ = _make_cert(tmp_path, "rotated", "acp-new")
    cert, key = tmp_path / "server.crt", tmp_path / "server.key"

    def case(h):
        before = _tls_get(h, "/healthz", _client_ssl(old_cert))
        cert.write_bytes(new_cert.read_bytes())  # rotate in place
        key.write_bytes(new_key.read_bytes())
        deadline = time.monotonic() + 10
        while _tls_get(h, "/healthz", _client_ssl(new_cert)) != 200:
            assert time.monotonic() < deadline, "the rotated certificate was never served"
            time.sleep(0.1)
        cert.write_bytes(old_cert.read_bytes())  # back, for the other server
        key.write_bytes(old_key.read_bytes())
        return [before, 200]

    cert.write_bytes(old_cert.read_bytes())
    key.write_bytes(old_key.read_bytes())
    both(case, tls_cert_path=str(cert), tls_key_path=str(key))


# -- the port alone -------------------------------------------------------------


def test_routes_left_out_answer_404_on_the_port():
    with Live("port") as h:
        for path in ("/v1/fleet", "/v1/fleet/trace"):
            assert h.call("GET", path) == (404, {"error": "not found"}), path


def test_leader_gated_rest_binds_only_while_leading(tmp_path):
    """With leader election on, the REST server is a leader-gated runnable:
    it binds once this replica holds the election lease."""
    with Live("port", leader_election=True, db_path=str(tmp_path / "op.db")) as h:
        assert h.op.manager.elector is not None and h.op.manager.elector.is_leader
        assert h.call("GET", "/healthz") == (200, {"status": "ok"})


def test_engine_gauges_and_stats_with_an_engine_stub():
    """``/metrics`` and ``/v1/engine`` read ``Engine.stats()``, taking
    ``.get`` for what the port's engine lacks."""
    class Stub:
        tokenizer = None

        def stats(self):
            return {"model": {"dim": 8}, "active_slots": 3, "waiting": 2, "decode_steps": 5}

    with Live("port", engine=Stub()) as h:
        text = h.call("GET", "/metrics")[1]
        assert "acp_engine_active_slots 3.0" in text
        assert "acp_engine_waiting_requests 2.0" in text
        assert "acp_engine_prefix_shared_pages 0.0" in text
        assert h.call("GET", "/v1/engine")[1] == {"configured": True, **Stub().stats()}
        models = h.call("GET", "/v1/models")[1]["data"]
        assert models[0]["id"] == "tpu" and models[0]["metadata"] == {"dim": 8}


# -- chat over a tiny engine pair -------------------------------------------------


def _engine_pair() -> dict:
    """The tiny f32 engines of both packages, with the same weights."""
    import jax

    from agentcontrolplane_tpu.engine.engine import Engine as JaxEngine
    from agentcontrolplane_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
    from agentcontrolplane_tpu.models import llama as jl
    from agentcontrolplane_tpu.parallel.mesh import make_mesh
    from agentcontrolplane_tpu_torch.engine.engine import Engine
    from agentcontrolplane_tpu_torch.engine.weights import params_from_jax
    from agentcontrolplane_tpu_torch.models import llama as tl

    jcfg = dataclasses.replace(jl.PRESETS["tiny"], vocab_size=512, max_seq_len=256)
    tcfg = dataclasses.replace(tl.PRESETS["tiny"], vocab_size=512, max_seq_len=256)
    kw = dict(max_slots=2, max_ctx=256, prefill_buckets=(128, 256), decode_block_size=4,
              page_size=8)
    p = jax.tree_util.tree_map(np.array, jl.init_params(jcfg, jax.random.key(0)))
    return {
        "ref": JaxEngine(config=jcfg, params=jax.tree_util.tree_map(jax.numpy.asarray, p),
                         tokenizer=JaxByteTokenizer(),
                         mesh=make_mesh({"tp": 1}, devices=jax.devices()[:1]),
                         kv_layout="paged", prefix_cache_entries=0, **kw),
        "port": Engine(tcfg, params_from_jax(p, tcfg, device="cpu"), device="cpu",
                       prefix_cache_entries=0, **kw),
    }


def test_engine_observability_routes_match_the_reference():
    """One chat request, then the perf, flight, trace and timeline routes:
    equal statuses and shapes, the same program keys with the same counts,
    the same ledger, the request's event kinds and phases; and the
    reference's errors (an unknown rid, a bad ``last``, no engine)."""
    body = {"model": "tiny", "max_tokens": 8, "temperature": 0,
            "messages": [{"role": "user", "content": "observe me"}]}
    got = {}
    engines = _engine_pair()
    try:
        for pkg, engine in engines.items():
            engine.start()
            with Live(pkg, engine=engine) as h:
                assert h.call("POST", "/v1/chat/completions", body)[0] == 200
                status, flight = h.call("GET", "/v1/engine/flight?last=5")
                rid = flight["request_ids"][-1]
                tl_status, tl = h.call("GET", f"/v1/requests/{rid}/timeline")
                perf_status, perf = h.call("GET", "/v1/engine/perf")
                tr_status, trace = h.call("GET", "/v1/engine/trace")
                got[pkg] = {
                    "statuses": [status, tl_status, perf_status, tr_status],
                    "flight": (sorted(flight), len(flight["events"]),
                               [e["kind"] for e in flight["events"]]),
                    "timeline": (sorted(tl), [e["kind"] for e in tl["events"]], sorted(tl["phases"]),
                                 sum(tl["phases"].get(k, 0.0) for k in
                                     ("queue_wait", "prefill", "decode"))
                                 == pytest.approx(tl["total_s"], abs=1e-5)),
                    "perf": (sorted(perf), {k: v["dispatches"] for k, v in perf["programs"].items()},
                             perf["goodput"]),
                    "trace": ({k: v for k, v in trace.items() if k != "span_s"},),
                    "errors": [h.call("GET", "/v1/requests/nope/timeline"),
                               h.call("GET", "/v1/engine/flight?last=x")],
                }
            with Live(pkg) as h:
                got[pkg]["no_engine"] = [h.call("GET", path) for path in (
                    "/v1/engine/perf", "/v1/engine/flight", "/v1/engine/trace",
                    "/v1/requests/r1/timeline")]
    finally:
        for engine in engines.values():
            engine.stop()
    assert got["port"] == got["ref"]
    port = got["port"]
    assert port["statuses"] == [200, 200, 200, 200]
    assert port["timeline"][1][0] == "submit" and port["timeline"][1][-1] == "finish"
    assert port["timeline"][3] is True
    assert port["errors"][0][0] == 404 and port["errors"][1] == (400, {"error": "last must be "
                                                                                "an integer"})
    assert all(r == (503, {"error": "no TPU engine configured"}) for r in port["no_engine"])


def test_chat_completion_is_byte_identical_to_the_reference():
    engines = _engine_pair()
    body = {"model": "tiny", "max_tokens": 12, "temperature": 0,
            "messages": [{"role": "system", "content": "s"}, {"role": "user", "content": "hello"}]}
    replies = {}
    try:
        for pkg, engine in engines.items():
            engine.start()
            with Live(pkg, engine=engine) as h:
                replies[pkg] = [h.call("POST", "/v1/chat/completions", body),
                                h.call("POST", "/v1/chat/completions", data=b"{broken"),
                                h.call("POST", "/v1/chat/completions", {"model": "x"})]
    finally:
        for engine in engines.values():
            engine.stop()
    (status, doc), *bad = replies["port"]
    (ref_status, ref_doc), *ref_bad = replies["ref"]
    assert status == ref_status == 200
    assert doc["choices"] == ref_doc["choices"]  # the greedy reply, byte for byte
    assert doc["usage"] == ref_doc["usage"] and doc["usage"]["completion_tokens"] >= 1
    assert doc["object"] == "chat.completion" and doc["id"].startswith("chatcmpl-")
    assert [b[0] for b in bad] == [b[0] for b in ref_bad] == [400, 400]
