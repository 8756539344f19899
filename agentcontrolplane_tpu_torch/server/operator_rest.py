"""The operator's REST API (the port's copy of the reference's
``server/rest.py`` ``RestServer``), on the standard library's
``ThreadingHTTPServer`` because the card's machine has no aiohttp.

It sits in a module of its own, beside the engine's front door
(``server/rest.py``): the front door serves one engine for ``serve``, this
server serves an ``Operator`` (its store, human backend and engine) for
``run``. The chat route is the front door's (``chat_completion`` /
``ChatStream``) mounted on ``operator.engine``, and its handler class
extends the front door's, so the two share their reply and SSE code.

Routes (the reference's, with its request and error bodies):

- ``POST/GET /v1/tasks``, ``GET/DELETE /v1/tasks/{name}``;
- ``POST/GET /v1/agents``, ``GET/PATCH/DELETE /v1/agents/{name}``;
- ``POST /v1/beta3/events`` (fabricates a Secret, a ContactChannel and a
  Task);
- ``POST /v1/apply`` (YAML or JSON manifests),
  ``GET /v1/resources/{kind}[/{name}]`` (``labelSelector``; Secret data
  redacted), ``DELETE /v1/resources/{kind}/{name}``;
- ``GET /v1/approvals``, ``POST /v1/approvals/{id}/approve|reject``,
  ``GET /v1/contacts``, ``POST /v1/contacts/{id}/respond``;
- ``GET /v1/events``, ``GET /v1/models``, ``GET /v1/engine``,
  ``POST /v1/chat/completions``;
- ``GET /v1/engine/perf`` (the dispatch profiler), ``GET
  /v1/engine/flight?last=N&kind=&rid=`` (the flight recorder's window),
  ``GET /v1/engine/trace`` (the anonymized workload trace) and ``GET
  /v1/requests/{rid}/timeline`` (one request's events and phases); each
  reads only the recorder's and the profiler's cross-thread methods;
- ``GET /metrics`` (object counts by kind and phase, the engine's gauges),
  ``GET /healthz``, ``GET /readyz``.

The fleet routes (ROADMAP A.12) are not served: they answer 404 like any
unknown path.

Threads: requests are handled on the server's worker threads; the store
is thread-safe (an RLock; watch events reach the operator's loop with
``call_soon_threadsafe``) and the human backend takes its own lock, so a
handler never touches the operator's event loop. With ``api_token`` set,
every route but the health probes needs ``Authorization: Bearer <token>``.
With a certificate and key it serves HTTPS; with a client CA, mTLS. The
files are stat'ed at most every ``ACP_TLS_RELOAD_INTERVAL_S`` seconds (30)
when a connection is accepted, and a changed set builds a fresh context
that wraps every later connection, so a rotated certificate or client CA
is served without a restart and without swapping the listener.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import re
import ssl
import threading
import time
from dataclasses import dataclass
from http.server import ThreadingHTTPServer
from typing import TYPE_CHECKING, Any, Callable, Optional
from urllib.parse import parse_qsl, unquote, urlsplit

from ..api.manifests import apply_resources, load_manifests, resource_to_manifest
from ..api.meta import ObjectMeta
from ..api.resources import (
    KINDS,
    LABEL_AGENT,
    LABEL_V1BETA3,
    LLM,
    Agent,
    AgentSpec,
    BaseConfig,
    ContactChannel,
    ContactChannelSpec,
    ContactChannelStatus,
    LLMSpec,
    LocalObjectRef,
    Message,
    Secret,
    SecretKeyRef,
    SecretSpec,
    SlackChannelConfig,
    Task,
    TaskSpec,
)
from ..kernel.errors import AlreadyExists, Conflict, Invalid, NotFound
from ..observability.metrics import REGISTRY
from ..observability.trace_export import export_trace
from ..utils.tokens import token_matches
from ..validation import generate_k8s_random_string, validate_task_message_input
from .rest import ChatStream, _Handler, chat_completion

if TYPE_CHECKING:
    from ..operator import Operator

log = logging.getLogger("acp_tpu.rest")

# health probes stay open (the reference exempts them from authn too)
_UNAUTHENTICATED_PATHS = {"/healthz", "/readyz"}

Reply = tuple[int, Any, dict]  # (status, JSON doc | text | ChatStream, headers)


def _json_error(status: int, message: str) -> Reply:
    return status, {"error": message}, {}


def _redact_secrets(manifest: dict[str, Any]) -> dict[str, Any]:
    """Blank Secret payloads on read routes: the object stays readable,
    its data does not."""
    if manifest.get("kind") == "Secret":
        data = (manifest.get("spec") or {}).get("data")
        if data:
            manifest["spec"]["data"] = {k: "<redacted>" for k in data}
    return manifest


def _strict_decode(raw: bytes, allowed: set[str]) -> dict[str, Any]:
    """A JSON object with no field outside ``allowed``."""
    body = json.loads(raw)
    if not isinstance(body, dict):
        raise Invalid("request body must be a JSON object")
    unknown = set(body) - allowed
    if unknown:
        raise Invalid(f"unknown fields: {sorted(unknown)}")
    return body


def task_to_json(task: Task) -> dict[str, Any]:
    return {
        "name": task.name,
        "namespace": task.namespace,
        "agentName": task.spec.agent_ref.name,
        "phase": task.status.phase,
        "status": task.status.status,
        "statusDetail": task.status.status_detail,
        "output": task.status.output,
        "userMsgPreview": task.status.user_msg_preview,
        "messageCount": task.status.message_count,
        "contextWindow": [m.model_dump(exclude_none=True) for m in task.status.context_window],
        "error": task.status.error,
        "creationTimestamp": task.metadata.creation_timestamp,
    }


@dataclass
class Request:
    query: dict[str, str]  # the first value of each name
    match: dict[str, str]  # the route's {name} segments, unquoted
    body: bytes


class _OperatorHandler(_Handler):
    """One connection: parse, authenticate, dispatch to the server's
    route, reply (JSON, text or SSE)."""

    def do_GET(self):
        self._serve("GET")

    def do_POST(self):
        self._serve("POST")

    def do_PATCH(self):
        self._serve("PATCH")

    def do_PUT(self):
        self._serve("PUT")  # no route takes PUT: 405 on a known path

    def do_DELETE(self):
        self._serve("DELETE")

    def _read_body(self) -> bytes:
        if "chunked" in (self.headers.get("Transfer-Encoding") or "").lower():
            parts = []
            while True:
                size = int(self.rfile.readline().split(b";")[0].strip() or b"0", 16)
                if size == 0:
                    while self.rfile.readline() not in (b"\r\n", b"\n", b""):
                        pass  # trailers
                    return b"".join(parts)
                parts.append(self.rfile.read(size))
                self.rfile.readline()
        return self.rfile.read(int(self.headers.get("Content-Length") or 0))

    def _serve(self, method: str) -> None:
        rest: RestServer = self.server.rest  # type: ignore[attr-defined]
        url = urlsplit(self.path)
        query: dict[str, str] = {}
        for k, v in parse_qsl(url.query, keep_blank_values=True):
            query.setdefault(k, v)
        body = self._read_body()
        status, doc, headers = rest.handle(method, url.path, query, self.headers, body)
        if isinstance(doc, ChatStream):
            self._stream(doc)
        elif isinstance(doc, str):
            data = doc.encode()
            self.send_response(status)
            self.send_header("Content-Type", "text/plain; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        else:
            self._reply(status, doc, headers)


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, address, rest: "RestServer"):
        self.rest = rest
        super().__init__(address, _OperatorHandler)

    def get_request(self):
        sock, addr = super().get_request()
        ctx = self.rest._current_ssl_context()
        if ctx is not None:
            # the handshake runs on the worker thread (finish_request), so
            # a slow client never holds up the accept loop
            sock = ctx.wrap_socket(sock, server_side=True, do_handshake_on_connect=False)
        return sock, addr

    def finish_request(self, request, client_address):
        if isinstance(request, ssl.SSLSocket):
            request.settimeout(30.0)
            request.do_handshake()
            request.settimeout(None)
        super().finish_request(request, client_address)

    def handle_error(self, request, client_address):
        # a refused handshake, or a client gone mid-reply
        log.debug("REST connection from %s ended with an error", client_address, exc_info=True)


Route = Callable[[Request], Reply]


class RestServer:
    def __init__(self, operator: "Operator", host: str = "127.0.0.1", port: Optional[int] = None):
        self.operator = operator
        # leader-gated serving writes through the fenced view: once another
        # replica adopts the election lease, this one's in-flight REST
        # mutations observe Conflict (409); the raw store without election
        self.store = operator.manager.fenced_store()
        self.host = host
        self.port = port if port is not None else operator.options.api_port
        self.api_token = operator.options.api_token
        self.bound_port: Optional[int] = None
        self._httpd: Optional[_HTTPServer] = None
        opts = operator.options
        self._tls_paths = (
            (opts.tls_cert_path, opts.tls_key_path, opts.tls_client_ca_path)
            if opts.tls_cert_path and opts.tls_key_path else None
        )
        # built now, so a bad certificate path fails at construction
        self._ssl_context = self._build_ssl_context() if self._tls_paths else None
        self._tls_stamp = self._stat_tls_files()
        self._tls_checked = time.monotonic()
        self._tls_interval = 30.0
        self._gauge_lock = threading.Lock()
        self._phase_series: set[tuple[str, str]] = set()
        self._phase_zeroed: set[tuple[str, str]] = set()
        self._routes: list[tuple[str, re.Pattern, Route]] = []
        for method, pattern, fn in (
            ("POST", "/v1/tasks", self.create_task),
            ("GET", "/v1/tasks", self.list_tasks),
            ("GET", "/v1/tasks/{name}", self.get_task),
            ("DELETE", "/v1/tasks/{name}", self.delete_task),
            ("POST", "/v1/agents", self.create_agent),
            ("GET", "/v1/agents", self.list_agents),
            ("GET", "/v1/agents/{name}", self.get_agent),
            ("PATCH", "/v1/agents/{name}", self.update_agent),
            ("DELETE", "/v1/agents/{name}", self.delete_agent),
            ("POST", "/v1/beta3/events", self.handle_v1beta3_event),
            ("POST", "/v1/apply", self.apply_manifests),
            ("GET", "/v1/resources/{kind}", self.list_resources),
            ("GET", "/v1/resources/{kind}/{name}", self.get_resource),
            ("DELETE", "/v1/resources/{kind}/{name}", self.delete_resource),
            ("GET", "/v1/approvals", self.list_approvals),
            ("POST", "/v1/approvals/{call_id}/approve", self.approve),
            ("POST", "/v1/approvals/{call_id}/reject", self.reject),
            ("GET", "/v1/contacts", self.list_contacts),
            ("POST", "/v1/contacts/{call_id}/respond", self.respond),
            ("GET", "/v1/events", self.list_events),
            ("POST", "/v1/chat/completions", self.chat_completions),
            ("GET", "/v1/models", self.list_models),
            ("GET", "/v1/engine", self.engine_status),
            ("GET", "/v1/engine/perf", self.engine_perf),
            ("GET", "/v1/engine/flight", self.engine_flight),
            ("GET", "/v1/engine/trace", self.engine_trace),
            ("GET", "/v1/requests/{rid}/timeline", self.request_timeline),
            ("GET", "/metrics", self.metrics),
            ("GET", "/healthz", self.healthz),
            ("GET", "/readyz", self.healthz),
        ):
            regex = re.compile("^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern) + "$")
            self._routes.append((method, regex, fn))

    # -- TLS --------------------------------------------------------------

    def _build_ssl_context(self) -> ssl.SSLContext:
        cert, key, client_ca = self._tls_paths  # type: ignore[misc]
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_2
        ctx.load_cert_chain(cert, key)
        if client_ca:
            ctx.load_verify_locations(client_ca)
            ctx.verify_mode = ssl.CERT_REQUIRED
        return ctx

    def _stat_tls_files(self) -> tuple:
        if not self._tls_paths:
            return ()
        out = []
        for p in self._tls_paths:
            st = os.stat(p) if p else None
            out.append((st.st_mtime_ns, st.st_size, st.st_ino) if st else None)
        return tuple(out)

    def _current_ssl_context(self) -> Optional[ssl.SSLContext]:
        """The context for a newly accepted connection (accept thread only).
        A fresh context replaces the old one when the files changed: loading
        into the live one would only add client CAs, never drop one. A
        half-written rotation fails to load and is retried at a later
        accept, with the old chain served meanwhile."""
        if self._ssl_context is None:
            return None
        now = time.monotonic()
        if now - self._tls_checked >= self._tls_interval:
            self._tls_checked = now
            try:
                stamp = self._stat_tls_files()
                if stamp != self._tls_stamp:
                    self._ssl_context = self._build_ssl_context()
                    self._tls_stamp = stamp
            except (OSError, ssl.SSLError):
                pass
        return self._ssl_context

    # -- lifecycle ----------------------------------------------------------

    async def run(self) -> None:
        """Serve until cancelled: blocking, so a leader-gated runner can
        cancel it on leadership loss and start it again on re-acquisition."""
        self._tls_interval = float(os.environ.get("ACP_TLS_RELOAD_INTERVAL_S", "30"))
        try:
            httpd = _HTTPServer((self.host, self.port), self)
        except OSError:
            log.exception("REST API: cannot bind %s:%s", self.host, self.port)
            raise
        self._httpd = httpd
        self.bound_port = httpd.server_address[1]
        threading.Thread(target=httpd.serve_forever, kwargs={"poll_interval": 0.05},
                         name="acp-torch-rest", daemon=True).start()
        try:
            await asyncio.Event().wait()
        finally:
            await self.stop()

    async def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        self.bound_port = None
        if httpd is not None:
            httpd.shutdown()  # within one poll interval (50 ms)
            httpd.server_close()

    # -- dispatch -----------------------------------------------------------

    def handle(self, method: str, path: str, query: dict[str, str], headers,
               body: bytes) -> Reply:
        if self.api_token and path not in _UNAUTHENTICATED_PATHS and not token_matches(
                headers.get("Authorization", ""), f"Bearer {self.api_token}"):
            return _json_error(401, "unauthorized")
        allowed = []
        for m, regex, fn in self._routes:
            match = regex.match(path)
            if match is None:
                continue
            if m != method:
                allowed.append(m)
                continue
            req = Request(query, {k: unquote(v) for k, v in match.groupdict().items()}, body)
            try:
                return fn(req)
            except (AlreadyExists, Conflict) as e:
                return _json_error(409, str(e))
            except NotFound as e:
                return _json_error(404, str(e))
            except Invalid as e:
                return _json_error(400, str(e))
            except Exception as e:
                log.exception("REST %s %s failed", method, path)
                return _json_error(500, f"internal error: {e}")
        if allowed:
            return 405, {"error": "method not allowed"}, {"Allow": ", ".join(allowed)}
        return _json_error(404, "not found")

    # -- tasks --------------------------------------------------------------

    def create_task(self, req: Request) -> Reply:
        try:
            body = _strict_decode(
                req.body,
                {"agentName", "userMessage", "contextWindow", "namespace", "contactChannelRef"},
            )
        except (Invalid, json.JSONDecodeError) as e:
            return _json_error(400, str(e))
        agent_name = body.get("agentName", "")
        if not agent_name:
            return _json_error(400, "agentName is required")
        ns = body.get("namespace", "default")
        context_window = None
        if body.get("contextWindow"):
            try:
                context_window = [Message.model_validate(m) for m in body["contextWindow"]]
            except Exception as e:
                return _json_error(400, f"invalid contextWindow: {e}")
        try:
            validate_task_message_input(body.get("userMessage"), context_window)
        except Invalid as e:
            return _json_error(400, str(e))
        if self.store.try_get("Agent", agent_name, ns) is None:
            return _json_error(404, f'agent "{agent_name}" not found')
        task = Task(
            metadata=ObjectMeta(name=f"{agent_name}-task-{generate_k8s_random_string(8)}",
                                namespace=ns, labels={LABEL_AGENT: agent_name}),
            spec=TaskSpec(
                agent_ref=LocalObjectRef(name=agent_name),
                user_message=body.get("userMessage"),
                context_window=context_window,
                contact_channel_ref=(
                    LocalObjectRef(name=body["contactChannelRef"])
                    if body.get("contactChannelRef") else None
                ),
            ),
        )
        return 201, task_to_json(self.store.create(task)), {}

    def list_tasks(self, req: Request) -> Reply:
        ns = req.query.get("namespace", "default")
        return 200, [task_to_json(t) for t in self.store.list("Task", ns)], {}

    def get_task(self, req: Request) -> Reply:
        task = self.store.try_get("Task", req.match["name"], req.query.get("namespace", "default"))
        if not isinstance(task, Task):
            return _json_error(404, "task not found")
        return 200, task_to_json(task), {}

    def delete_task(self, req: Request) -> Reply:
        try:
            self.store.delete("Task", req.match["name"], req.query.get("namespace", "default"))
        except NotFound:
            return _json_error(404, "task not found")
        return 200, {"deleted": req.match["name"]}, {}

    # -- agents -------------------------------------------------------------

    def create_agent(self, req: Request) -> Reply:
        try:
            body = _strict_decode(
                req.body,
                {"name", "namespace", "systemPrompt", "description", "llm", "mcpServers",
                 "subAgents"},
            )
        except (Invalid, json.JSONDecodeError) as e:
            return _json_error(400, str(e))
        name = body.get("name", "")
        ns = body.get("namespace", "default")
        llm_cfg = body.get("llm") or {}
        if not name or not body.get("systemPrompt") or not llm_cfg.get("provider"):
            return _json_error(400, "name, systemPrompt and llm.provider are required")
        created: list = []  # undone in reverse on failure
        try:
            secret_ref = None
            if llm_cfg.get("apiKey"):
                secret = self.store.create(Secret(
                    metadata=ObjectMeta(name=f"{name}-llm-key", namespace=ns),
                    spec=SecretSpec(data={"api-key": llm_cfg["apiKey"]}),
                ))
                created.append(secret)
                secret_ref = SecretKeyRef(name=secret.name, key="api-key")
            llm = self.store.create(LLM(
                metadata=ObjectMeta(name=f"{name}-llm", namespace=ns),
                spec=LLMSpec(
                    provider=llm_cfg["provider"],
                    api_key_from=secret_ref,
                    parameters=BaseConfig(model=llm_cfg.get("model", ""),
                                          base_url=llm_cfg.get("baseURL")),
                ),
            ))
            created.append(llm)
            created.append(self.store.create(Agent(
                metadata=ObjectMeta(name=name, namespace=ns),
                spec=AgentSpec(
                    llm_ref=LocalObjectRef(name=llm.name),
                    system=body["systemPrompt"],
                    description=body.get("description", ""),
                    mcp_servers=[LocalObjectRef(name=s) for s in body.get("mcpServers", [])],
                    sub_agents=[LocalObjectRef(name=s) for s in body.get("subAgents", [])],
                ),
            )))
        except Exception as e:  # a bad provider's validation error included
            for obj in reversed(created):
                try:
                    self.store.delete(obj.kind, obj.metadata.name, obj.metadata.namespace)
                except NotFound:
                    pass
                except Conflict:
                    break  # deposed mid-create: the fenced cleanup cannot run either
            return _json_error(409 if isinstance(e, (AlreadyExists, Conflict)) else 400, str(e))
        return 201, {"name": name, "namespace": ns, "llm": llm.name}, {}

    def list_agents(self, req: Request) -> Reply:
        agents = self.store.list("Agent", req.query.get("namespace", "default"))
        return 200, [{"name": a.name, "ready": a.status.ready, "status": a.status.status,
                      "description": a.spec.description} for a in agents], {}

    def get_agent(self, req: Request) -> Reply:
        agent = self.store.try_get("Agent", req.match["name"],
                                   req.query.get("namespace", "default"))
        if not isinstance(agent, Agent):
            return _json_error(404, "agent not found")
        return 200, {
            "name": agent.name,
            "namespace": agent.namespace,
            "systemPrompt": agent.spec.system,
            "llmRef": agent.spec.llm_ref.name,
            "ready": agent.status.ready,
            "status": agent.status.status,
            "statusDetail": agent.status.status_detail,
            "validMCPServers": [s.model_dump() for s in agent.status.valid_mcp_servers],
            "validSubAgents": [s.model_dump() for s in agent.status.valid_sub_agents],
        }, {}

    def update_agent(self, req: Request) -> Reply:
        """Partial update of systemPrompt / description / mcpServers /
        subAgents; the Agent controller revalidates."""
        ns = req.query.get("namespace", "default")
        try:
            body = _strict_decode(req.body,
                                  {"systemPrompt", "description", "mcpServers", "subAgents"})
        except (Invalid, json.JSONDecodeError) as e:
            return _json_error(400, str(e))
        for key in ("systemPrompt", "description"):
            if key in body and not isinstance(body[key], str):
                return _json_error(400, f"{key} must be a string")
        for key in ("mcpServers", "subAgents"):
            if key in body and (not isinstance(body[key], list)
                                or not all(isinstance(s, str) and s for s in body[key])):
                return _json_error(400, f"{key} must be a list of names")
        if body.get("systemPrompt") == "":
            return _json_error(400, "systemPrompt cannot be empty")
        for _ in range(3):  # retry against concurrent status writes
            agent = self.store.try_get("Agent", req.match["name"], ns)
            if not isinstance(agent, Agent):
                return _json_error(404, "agent not found")
            if "systemPrompt" in body:
                agent.spec.system = body["systemPrompt"]
            if "description" in body:
                agent.spec.description = body["description"]
            if "mcpServers" in body:
                agent.spec.mcp_servers = [LocalObjectRef(name=s) for s in body["mcpServers"]]
            if "subAgents" in body:
                agent.spec.sub_agents = [LocalObjectRef(name=s) for s in body["subAgents"]]
            try:
                updated = self.store.update(agent)
            except Conflict:
                continue
            return 200, {"name": updated.name, "generation": updated.metadata.generation}, {}
        return _json_error(409, "conflict: concurrent updates, retry")

    def delete_agent(self, req: Request) -> Reply:
        try:
            self.store.delete("Agent", req.match["name"], req.query.get("namespace", "default"))
        except NotFound:
            return _json_error(404, "agent not found")
        return 200, {"deleted": req.match["name"]}, {}

    # -- v1beta3 inbound events --------------------------------------------

    def handle_v1beta3_event(self, req: Request) -> Reply:
        """A Slack- or email-style thread event becomes a Task on a
        per-event ContactChannel, whose final answer goes back through
        respond_to_human."""
        try:
            body = json.loads(req.body)
        except json.JSONDecodeError as e:
            return _json_error(400, str(e))
        event_type = body.get("type", "")
        if event_type not in ("agent_email.received", "agent_slack.received", ""):
            return _json_error(400, f"unsupported event type {event_type!r}")
        payload = body.get("event") or body
        agent_name = body.get("agentName") or payload.get("agent_name", "")
        message = (payload.get("message") or (payload.get("body") or {}).get("text", "")
                   or payload.get("text", ""))
        channel_token = body.get("channelApiKey") or payload.get("channel_api_key", "")
        thread_id = payload.get("thread_id") or payload.get("thread_ts")
        event_id = payload.get("event_id") or generate_k8s_random_string(8)
        ns = body.get("namespace", "default")
        if not agent_name or not message:
            return _json_error(400, "agentName and message are required")
        if self.store.try_get("Agent", agent_name, ns) is None:
            return _json_error(404, f'agent "{agent_name}" not found')
        secret_name = f"v1beta3-token-{event_id}"
        channel_name = f"v1beta3-channel-{event_id}"
        try:
            self.store.create(Secret(metadata=ObjectMeta(name=secret_name, namespace=ns),
                                     spec=SecretSpec(data={"token": channel_token})))
        except AlreadyExists:
            pass
        channel_id = payload.get("channel_id", "C0000000000")
        try:
            # created Ready in one write: this runs on a worker thread, and a
            # create followed by a status write would let the ContactChannel
            # controller see it not Ready in between and overwrite the detail
            self.store.create(ContactChannel(
                metadata=ObjectMeta(name=channel_name, namespace=ns),
                spec=ContactChannelSpec(
                    type="slack",
                    channel_api_key_from=SecretKeyRef(name=secret_name, key="token"),
                    channel_id=channel_id,
                    slack=SlackChannelConfig(channel_or_user_id=channel_id),
                ),
                status=ContactChannelStatus(ready=True, status="Ready",
                                            status_detail="v1beta3 channel (per-event token)"),
            ))
        except AlreadyExists:
            pass
        created = self.store.create(Task(
            metadata=ObjectMeta(
                name=f"{agent_name}-task-{generate_k8s_random_string(8)}",
                namespace=ns,
                labels={LABEL_AGENT: agent_name, LABEL_V1BETA3: "true"},
            ),
            spec=TaskSpec(
                agent_ref=LocalObjectRef(name=agent_name),
                user_message=message,
                contact_channel_ref=LocalObjectRef(name=channel_name),
                channel_token_from=SecretKeyRef(name=secret_name, key="token"),
                thread_id=thread_id,
            ),
        ))
        return 201, {"taskName": created.name, "channel": channel_name}, {}

    # -- generic resources --------------------------------------------------

    def apply_manifests(self, req: Request) -> Reply:
        try:
            resources = load_manifests(req.body.decode())
        except Exception as e:
            return _json_error(400, str(e))
        try:
            results = apply_resources(self.store, resources)
        except Invalid as e:
            return _json_error(400, str(e))
        except Exception as e:
            return _json_error(500, f"apply failed: {e}")
        return 200, [{"kind": r.kind, "name": r.metadata.name, "action": action}
                     for action, r in results], {}

    def list_resources(self, req: Request) -> Reply:
        kind = req.match["kind"]
        if kind not in KINDS:
            return _json_error(404, f"unknown kind {kind!r}")
        selector = None
        if req.query.get("labelSelector"):
            selector = dict(part.split("=", 1)
                            for part in req.query["labelSelector"].split(",") if "=" in part)
        objs = self.store.list(kind, req.query.get("namespace", "default"),
                               label_selector=selector)
        return 200, [_redact_secrets(resource_to_manifest(o)) for o in objs], {}

    def get_resource(self, req: Request) -> Reply:
        kind = req.match["kind"]
        if kind not in KINDS:
            return _json_error(404, f"unknown kind {kind!r}")
        obj = self.store.try_get(kind, req.match["name"], req.query.get("namespace", "default"))
        if obj is None:
            return _json_error(404, "not found")
        return 200, _redact_secrets(resource_to_manifest(obj)), {}

    def delete_resource(self, req: Request) -> Reply:
        kind = req.match["kind"]
        if kind not in KINDS:
            return _json_error(404, f"unknown kind {kind!r}")
        try:
            self.store.delete(kind, req.match["name"], req.query.get("namespace", "default"))
        except NotFound:
            return _json_error(404, "not found")
        return 200, {"deleted": req.match["name"]}, {}

    # -- the in-tree human backend -------------------------------------------

    def list_approvals(self, req: Request) -> Reply:
        return 200, [{"callId": a.call_id, "runId": a.run_id, "fn": a.fn, "kwargs": a.kwargs,
                      "created": a.created}
                     for a in self.operator.human_backend.pending_approvals()], {}

    def approve(self, req: Request) -> Reply:
        return self._verdict(req, True)

    def reject(self, req: Request) -> Reply:
        return self._verdict(req, False)

    def _verdict(self, req: Request, approve: bool) -> Reply:
        call_id = req.match["call_id"]
        b = self.operator.human_backend
        if call_id not in b.approvals:
            return _json_error(404, "approval not found")
        (b.approve if approve else b.reject)(call_id, req.query.get("comment", ""))
        return 200, {"callId": call_id, "approved": approve}, {}

    def list_contacts(self, req: Request) -> Reply:
        return 200, [{"callId": c.call_id, "runId": c.run_id, "message": c.message,
                      "created": c.created}
                     for c in self.operator.human_backend.pending_contacts()], {}

    def respond(self, req: Request) -> Reply:
        call_id = req.match["call_id"]
        b = self.operator.human_backend
        if call_id not in b.contacts:
            return _json_error(404, "contact not found")
        try:
            body = json.loads(req.body)
        except json.JSONDecodeError as e:
            return _json_error(400, str(e))
        if not isinstance(body.get("response"), str):
            return _json_error(400, "response (string) is required")
        b.respond(call_id, body["response"])
        return 200, {"callId": call_id}, {}

    # -- the engine ------------------------------------------------------------

    def chat_completions(self, req: Request) -> Reply:
        engine = self.operator.engine
        if engine is None:
            return _json_error(
                503, "no TPU engine configured (run with --tpu-preset/--tpu-checkpoint)")
        try:
            body = json.loads(req.body)
        except ValueError as e:
            return _json_error(400, f"invalid request: {e}")
        return chat_completion(engine, body)

    def list_models(self, req: Request) -> Reply:
        """OpenAI-style model list: the engine's model, then every LLM with
        its readiness."""
        models = []
        engine = self.operator.engine
        if engine is not None:
            models.append({"id": "tpu", "object": "model", "created": int(time.time()),
                           "owned_by": "acp-tpu", "metadata": engine.stats()["model"]})
        for llm in self.store.list("LLM", req.query.get("namespace", "default")):
            models.append({"id": llm.metadata.name, "object": "model",
                           "created": int(time.time()), "owned_by": llm.spec.provider,
                           "ready": llm.status.ready})
        return 200, {"object": "list", "data": models}, {}

    def engine_status(self, req: Request) -> Reply:
        engine = self.operator.engine
        if engine is None:
            return 200, {"configured": False}, {}
        return 200, {"configured": True, **engine.stats()}, {}

    def engine_perf(self, req: Request) -> Reply:
        """The dispatch profiler: per-program dispatch stats (host and
        sampled device time, real and padded tokens), first dispatches and
        the goodput/waste ledger."""
        engine = self.operator.engine
        if engine is None:
            return _json_error(503, "no TPU engine configured")
        return 200, {"configured": True, **engine.profiler.stats()}, {}

    def engine_flight(self, req: Request) -> Reply:
        """The flight recorder's window: the newest ``last`` events,
        filterable by ``kind`` and ``rid``."""
        engine = self.operator.engine
        if engine is None:
            return _json_error(503, "no TPU engine configured")
        try:
            last = int(req.query.get("last", "200"))
        except ValueError:
            return _json_error(400, "last must be an integer")
        flight = engine.flight
        return 200, {
            **flight.stats(),
            "request_ids": flight.request_ids(),
            "events": flight.events(last=last, kind=req.query.get("kind") or None,
                                    rid=req.query.get("rid") or None),
        }, {}

    def engine_trace(self, req: Request) -> Reply:
        """The anonymized workload trace derived from the flight recorder
        (``observability/trace_export.py``): arrival offsets, token lengths,
        persona mix, tool-call offsets, deadlines and cancels, no content."""
        engine = self.operator.engine
        if engine is None:
            return _json_error(503, "no TPU engine configured")
        return 200, export_trace(engine.flight), {}

    def request_timeline(self, req: Request) -> Reply:
        """One request's recorded decisions in order, with the phase
        attribution whose durations sum to its end-to-end wall."""
        engine = self.operator.engine
        if engine is None:
            return _json_error(503, "no TPU engine configured")
        doc = engine.flight.timeline_doc(req.match["rid"])
        if doc is None:
            return _json_error(404, "unknown request id (never recorded, or its timeline aged "
                                    "out of the finished-request window)")
        return 200, doc, {}

    # -- observability -----------------------------------------------------------

    def list_events(self, req: Request) -> Reply:
        events = self.store.list("Event", req.query.get("namespace", "default"))
        return 200, [{"involved": f"{e.spec.involved_kind}/{e.spec.involved_name}",
                      "type": e.spec.type, "reason": e.spec.reason, "message": e.spec.message,
                      "count": e.spec.count, "lastTimestamp": e.spec.last_timestamp}
                     for e in events], {}

    def metrics(self, req: Request) -> Reply:
        with self._gauge_lock:
            self._update_phase_gauges()
            return 200, REGISTRY.render(), {}

    def _update_phase_gauges(self) -> None:
        """Object counts by kind and phase, computed at scrape time (the
        store is the truth; a cached gauge would drift across restarts). A
        series that drained since the last scrape reads 0 for one scrape,
        then leaves the registry, so churn cannot grow it without bound."""
        try:
            counts = self.store.phase_counts()
        except Exception:
            return  # a transient store failure keeps the last scrape's values
        live = set(counts)
        for kind, phase in self._phase_zeroed - live:
            REGISTRY.gauge_remove("acp_objects", labels={"kind": kind, "phase": phase})
        to_zero = self._phase_series - live
        for key in to_zero:
            counts[key] = 0
        self._phase_series, self._phase_zeroed = live, to_zero
        for (kind, phase), n in counts.items():
            REGISTRY.gauge_set("acp_objects", float(n), labels={"kind": kind, "phase": phase},
                               help="live objects by kind and phase")
        engine = self.operator.engine
        if engine is None:
            return
        try:
            s = engine.stats()
            REGISTRY.gauge_set("acp_engine_active_slots", float(s["active_slots"]),
                               help="occupied decode slots")
            REGISTRY.gauge_set("acp_engine_waiting_requests", float(s["waiting"]),
                               help="admission queue depth")
            REGISTRY.gauge_set(
                "acp_engine_tokens_per_decode_step",
                float(s.get("tokens_per_decode_step", 0.0)),
                help="mean tokens committed per decode model step "
                "(> 1 means speculative decoding is paying)")
            REGISTRY.gauge_set(
                "acp_engine_prefilling_slots", float(s.get("prefilling_slots", 0)),
                help="slots admitted but still mid-prefill under the chunked "
                "token-budget scheduler")
            REGISTRY.gauge_set(
                "acp_engine_token_budget_utilization",
                float(s.get("scheduler", {}).get("budget_utilization_last", 0.0)),
                help="tokens dispatched last scheduler cycle / per-cycle token budget "
                "(chunked prefill mode)")
            mem = s.get("memory", {})
            REGISTRY.gauge_set(
                "acp_engine_host_kv_bytes",
                float(mem.get("host_kv", {}).get("used_bytes", 0)),
                help="bytes of swapped-out KV resident in the host-RAM offload tier")
            REGISTRY.gauge_set(
                "acp_engine_prefix_shared_pages",
                float(mem.get("prefix_dedup", {}).get("shared_pages", 0)),
                help="KV pages currently refcount-shared by more than one owner")
        except Exception:
            pass  # a crashed engine must not take /metrics down

    def healthz(self, req: Request) -> Reply:
        return 200, {"status": "ok"}, {}
