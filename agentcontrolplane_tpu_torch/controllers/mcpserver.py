"""MCPServer controller: connect, discover tools, keep alive (the port's
copy of the reference's ``controllers/mcpserver.py``).

Validate the spec (and wait for an approval channel to be ready), connect
through the shared ``MCPManager``, record the discovered tools, then a
10-minute keepalive/reconnect loop; errors retry after 30 s.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..api.resources import ContactChannel, MCPServer
from ..kernel.errors import Invalid
from ..kernel.events import EventRecorder
from ..kernel.runtime import Result
from ..kernel.store import Key, Store
from ..mcp.manager import MCPManager

KEEPALIVE_INTERVAL = 600.0
ERROR_RETRY = 30.0


def validate_mcpserver_spec(server: MCPServer) -> None:
    if server.spec.transport == "stdio":
        if not server.spec.command:
            raise Invalid("stdio transport requires a command")
    elif server.spec.transport == "http":
        if not server.spec.url:
            raise Invalid("http transport requires a url")
    else:
        raise Invalid(f"unknown transport {server.spec.transport!r}")


def tools_changed(server: MCPServer, discovered: list) -> bool:
    old = [(t.name, t.description) for t in server.status.tools]
    new = [(t.name, t.description) for t in discovered]
    return old != new


@dataclass
class MCPServerReconciler:
    store: Store
    recorder: EventRecorder
    mcp_manager: MCPManager
    keepalive_interval: float = KEEPALIVE_INTERVAL

    async def reconcile(self, key: Key) -> Result:
        _, ns, name = key
        server = self.store.try_get("MCPServer", name, ns)
        if server is None:
            await self.mcp_manager.disconnect_server(name)
            return Result.done()
        assert isinstance(server, MCPServer)

        try:
            validate_mcpserver_spec(server)
        except Invalid as e:
            self._set_status(server, connected=False, status="Error", detail=str(e))
            self.recorder.event(server, "Warning", "ValidationFailed", str(e))
            return Result.done()  # spec errors are terminal until spec changes

        # approval-channel readiness gate
        if server.spec.approval_contact_channel:
            channel = self.store.try_get(
                "ContactChannel", server.spec.approval_contact_channel, ns
            )
            if not isinstance(channel, ContactChannel) or not channel.status.ready:
                self._set_status(
                    server,
                    connected=False,
                    status="Pending",
                    detail=f'Waiting for approval ContactChannel "{server.spec.approval_contact_channel}"',
                )
                return Result.after(ERROR_RETRY)

        # Ready + healthy pool entry -> keepalive check
        conn = self.mcp_manager.get_connection(name)
        if server.status.connected and conn is not None and conn.client.alive:
            return Result.after(self.keepalive_interval)

        try:
            conn = await self.mcp_manager.connect_server(server)
        except Exception as e:
            self._set_status(
                server, connected=False, status="Error", detail=f"Connection failed: {e}"
            )
            self.recorder.event(server, "Warning", "ConnectionFailed", str(e))
            return Result.after(ERROR_RETRY)

        changed = tools_changed(server, conn.tools)

        def apply(fresh) -> None:
            fresh.status.connected = True
            fresh.status.status = "Ready"
            fresh.status.status_detail = f"Connected, {len(conn.tools)} tool(s) discovered"
            fresh.status.tools = conn.tools

        self.store.mutate_status("MCPServer", name, ns, apply)
        if changed or not server.status.connected:
            self.recorder.event(
                server, "Normal", "Connected", f"Discovered {len(conn.tools)} tool(s)"
            )
        return Result.after(self.keepalive_interval)

    def _set_status(self, server: MCPServer, connected: bool, status: str, detail: str) -> None:
        if (server.status.connected, server.status.status, server.status.status_detail) == (
                connected, status, detail) and (connected or not server.status.tools):
            # unchanged: the write's own watch event would re-run this
            # reconcile at once, and a failing server would be respawned in
            # a loop instead of after ERROR_RETRY (the reference rewrites;
            # ROADMAP C)
            return

        def apply(fresh) -> None:
            fresh.status.connected = connected
            fresh.status.status = status
            fresh.status.status_detail = detail
            if not connected:
                fresh.status.tools = []

        self.store.mutate_status("MCPServer", server.name, server.namespace, apply)
