"""Operator composition: wires the whole control plane (the port's copy of
the reference's ``operator.py``).

Build the manager, register all six controllers with a shared
``MCPManager``, the in-tree human backend and a tracer, add the REST server
(``server/operator_rest.py``) as a runnable, leader-gated under leader
election, and start. The serving engine, when given, is handed to the LLM
client factory as the ``provider: tpu`` backend and served by the REST
chat route.

Not ported yet, and refused with ``Invalid`` at construction: the served
store (``store_address``, ``serve_store``, ``store_token``) and the fleet
router (``fleet``), both ROADMAP A.12. The engine's flight recorder
exports its finished requests' phase windows through the operator's
tracer, and the metrics registry is pushed over OTLP when
``OTEL_EXPORTER_OTLP_ENDPOINT`` is set (``observability/otel_metrics.py``).
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Optional

from .controllers import (
    AgentReconciler,
    ContactChannelReconciler,
    LLMReconciler,
    MCPServerReconciler,
    TaskReconciler,
    ToolCallReconciler,
)
from .humanlayer import (
    HumanLayerClientFactory,
    LocalHumanBackend,
    LocalHumanLayerClientFactory,
)
from .kernel import Invalid, Manager, SqliteBackend, Store
from .kernel.runtime import map_owner
from .llmclient.factory import DefaultLLMClientFactory, LLMClientFactory
from .mcp import MCPManager
from .observability import MetricsExporter, Tracer


@dataclass
class OperatorOptions:
    db_path: Optional[str] = None  # None = in-memory store
    # the served store (another replica's, or this one's for others to
    # join): ROADMAP A.12
    store_address: Optional[str] = None
    serve_store: Optional[str] = None
    store_token: str = ""
    identity: str = "acp-tpu-0"
    leader_election: bool = False
    api_port: int = 8082  # 0 binds a free port (``rest_server.bound_port``)
    # bind address; 0.0.0.0 inside a container, where loopback is
    # unreachable from outside
    api_host: str = "127.0.0.1"
    # non-empty = every REST route but the health probes needs
    # "Authorization: Bearer <token>"
    api_token: str = ""
    # cert + key = HTTPS; a client CA also demands verified client
    # certificates (mTLS). Rotated files are served without a restart.
    tls_cert_path: Optional[str] = None
    tls_key_path: Optional[str] = None
    tls_client_ca_path: Optional[str] = None
    enable_rest: bool = True
    llm_probe: bool = True
    verify_channel_credentials: bool = True
    engine: object | None = None  # engine.Engine for provider: tpu
    # a fleet router in place of one engine: ROADMAP A.12
    fleet: object | None = None
    # Reconcile concurrency for the two hot controllers. A Task worker spends
    # almost all its time awaiting the LLM send, so the worker count bounds
    # how many requests the continuous-batching engine sees at once: size it
    # to the engine's slot count, not to CPU parallelism (workers are
    # coroutines on one event loop).
    task_workers: int = 32
    toolcall_workers: int = 16


def _refuse_unported(options: OperatorOptions) -> None:
    for name in ("store_address", "serve_store", "store_token", "fleet"):
        if getattr(options, name):
            raise Invalid(f"OperatorOptions.{name} is not ported yet (ROADMAP A.12)")


class Operator:
    def __init__(
        self,
        options: OperatorOptions | None = None,
        store: Optional[Store] = None,
        llm_factory: Optional[LLMClientFactory] = None,
        hl_factory: Optional[HumanLayerClientFactory] = None,
        tracer: Optional[Tracer] = None,
    ):
        self.options = options or OperatorOptions()
        _refuse_unported(self.options)
        self.store = store or Store(
            SqliteBackend(self.options.db_path) if self.options.db_path else None
        )
        self.tracer = tracer or Tracer()
        self.mcp_manager = MCPManager(self.store)
        self.human_backend = LocalHumanBackend()
        self.hl_factory = hl_factory or LocalHumanLayerClientFactory(self.human_backend)
        if isinstance(self.hl_factory, LocalHumanLayerClientFactory):
            self.human_backend = self.hl_factory.backend
        self.engine = self.options.engine
        flight = getattr(self.engine, "flight", None)
        if flight is not None:
            # the recorder's phase windows export as child spans through
            # the operator's tracer
            flight.tracer = self.tracer
        self.llm_factory = llm_factory or DefaultLLMClientFactory(engine=self.engine)

        self.manager = Manager(
            self.store,
            identity=self.options.identity,
            leader_election=self.options.leader_election,
        )
        self.task_reconciler = TaskReconciler(
            store=self.store,
            recorder=self.manager.recorder,
            llm_factory=self.llm_factory,
            mcp_manager=self.mcp_manager,
            hl_factory=self.hl_factory,
            tracer=self.tracer,
            identity=self.options.identity,
        )
        self.toolcall_reconciler = ToolCallReconciler(
            store=self.store,
            recorder=self.manager.recorder,
            mcp_manager=self.mcp_manager,
            hl_factory=self.hl_factory,
            tracer=self.tracer,
        )
        self._register_controllers()
        # the OTLP metrics push beside the traces; a no-op unless
        # OTEL_EXPORTER_OTLP_ENDPOINT is set
        self.metrics_exporter = MetricsExporter()
        self.rest_server = None
        if self.options.enable_rest:
            from .server.operator_rest import RestServer

            self.rest_server = RestServer(self, host=self.options.api_host)
            self.manager.add_runnable(
                self.rest_server.run, leader_gated=self.options.leader_election
            )

    def _register_controllers(self) -> None:
        m = self.manager
        self.llm_reconciler = LLMReconciler(
            self.store, m.recorder, self.llm_factory, probe=self.options.llm_probe
        )
        self.contactchannel_reconciler = ContactChannelReconciler(
            self.store,
            m.recorder,
            self.hl_factory,
            verify_credentials=self.options.verify_channel_credentials,
        )
        self.mcpserver_reconciler = MCPServerReconciler(
            self.store, m.recorder, self.mcp_manager
        )
        self.agent_reconciler = AgentReconciler(self.store, m.recorder)
        m.add_controller("llm", "LLM", self.llm_reconciler)
        m.add_controller("contactchannel", "ContactChannel", self.contactchannel_reconciler)
        m.add_controller("mcpserver", "MCPServer", self.mcpserver_reconciler)
        # Agents with pending dependencies requeue themselves (every 5 s by
        # default), so no dependency watch is needed.
        m.add_controller("agent", "Agent", self.agent_reconciler)
        m.add_controller(
            "task",
            "Task",
            self.task_reconciler,
            owns=["ToolCall"],
            workers=self.options.task_workers,
        )
        m.add_controller(
            "toolcall",
            "ToolCall",
            self.toolcall_reconciler,
            watches={"Task": map_owner("ToolCall")},
            workers=self.options.toolcall_workers,
        )

    async def start(self) -> None:
        await self.manager.start()
        self.metrics_exporter.start()

    async def stop(self) -> None:
        """Stop the controllers and the REST server (a Task turn still in
        flight is cancelled: the engine frees its slot and the Task stays
        ReadyForLLM, to resume from the store), close the MCP subprocesses
        and the store."""
        self.metrics_exporter.stop()
        await self.manager.stop()
        await self.mcp_manager.close()
        closer = getattr(self.llm_factory, "aclose", None)
        if closer is not None:
            await closer()
        if self.rest_server is not None:
            await self.rest_server.stop()
        self.store.close()


async def serve_until_signalled() -> None:
    """Block until SIGTERM/SIGINT. The handlers are removed once the signal
    arrives, so a second signal during a hung cleanup still kills the
    process instead of being swallowed."""
    import signal

    done = asyncio.Event()
    loop = asyncio.get_running_loop()
    installed: list = []
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, done.set)
            installed.append(sig)
        except (NotImplementedError, RuntimeError):
            pass  # non-main thread / platform without signal support
    try:
        await done.wait()
    finally:
        for sig in installed:
            loop.remove_signal_handler(sig)


async def run_operator(options: OperatorOptions) -> None:
    """Blocking entry point: serves until signalled, then shuts everything
    down (controllers, MCP subprocesses, sqlite, REST, and the engine if one
    was given)."""
    op = Operator(options)
    await op.start()
    try:
        await serve_until_signalled()
    finally:
        await op.stop()
        engine = options.engine
        if engine is not None:
            engine.stop()  # type: ignore[attr-defined]
