"""MCP server manager: connection pool and tool invocation (the port's
copy of the reference's ``mcp/manager.py``).

A pool name -> (client, tools) guarded by a lock; the stdio transport
(subprocess); Secret-resolved env vars (``convert_env_vars``); tool
invocation with text-content flattening (``flatten_tool_result``). The
reference's ``transport: http`` client is built on an HTTP client library
the card's machine lacks and is not ported yet (ROADMAP A.16):
``_make_client`` refuses it with ``Invalid``.
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Protocol

from ..api.resources import MCPServer, MCPTool
from ..kernel.errors import Invalid
from ..kernel.store import Store
from ..llmclient.factory import resolve_secret_key
from .stdio import MCPError, StdioMCPClient, parse_quantity


class MCPClient(Protocol):
    server_info: dict[str, Any]

    async def start(self, timeout: float = 15.0) -> None: ...
    async def list_tools(self) -> list[dict[str, Any]]: ...
    async def call_tool(self, name: str, arguments: dict[str, Any], timeout: float = 60.0) -> dict[str, Any]: ...
    async def close(self) -> None: ...
    @property
    def alive(self) -> bool: ...


@dataclass
class MCPConnection:
    name: str
    client: MCPClient
    tools: list[MCPTool] = field(default_factory=list)


def convert_env_vars(store: Store, namespace: str, server: MCPServer) -> dict[str, str]:
    """Resolve plain and Secret-sourced env vars."""
    env: dict[str, str] = {}
    for var in server.spec.env:
        if var.value is not None:
            env[var.name] = var.value
        elif var.value_from is not None:
            env[var.name] = resolve_secret_key(store, namespace, var.value_from)
        else:
            env[var.name] = ""
    return env


def flatten_tool_result(result: dict[str, Any]) -> str:
    """Flatten MCP content items to one string: text items are joined by
    newlines; non-text items are JSON-encoded."""
    if result.get("isError"):
        parts = [
            c.get("text", "") for c in result.get("content", []) if c.get("type") == "text"
        ]
        raise MCPError("tool error: " + ("\n".join(parts) or json.dumps(result)))
    out: list[str] = []
    for item in result.get("content", []):
        if item.get("type") == "text":
            out.append(item.get("text", ""))
        else:
            out.append(json.dumps(item))
    return "\n".join(out)


class MCPManager:
    """One shared pool per operator process."""

    def __init__(self, store: Optional[Store] = None):
        self._store = store
        self._connections: dict[str, MCPConnection] = {}
        self._lock = asyncio.Lock()

    def _make_client(self, server: MCPServer, env: dict[str, str]) -> MCPClient:
        if server.spec.transport == "stdio":
            if not server.spec.command:
                raise Invalid("stdio MCP server requires a command")
            mem_limit = None
            res = server.spec.resources
            if res is not None and res.limits.get("memory"):
                mem_limit = parse_quantity(res.limits["memory"])
            return StdioMCPClient(
                server.spec.command, list(server.spec.args), env, memory_limit=mem_limit
            )
        if server.spec.transport == "http":
            raise Invalid("MCP transport http is not ported yet (ROADMAP A.16)")
        raise Invalid(f"unknown MCP transport {server.spec.transport!r}")

    async def connect_server(self, server: MCPServer) -> MCPConnection:
        """Connect (or reconnect), run the handshake, discover tools, cache
        in the pool."""
        env = (
            convert_env_vars(self._store, server.metadata.namespace, server)
            if self._store is not None
            else {v.name: v.value or "" for v in server.spec.env}
        )
        client = self._make_client(server, env)
        await client.start()
        raw_tools = await client.list_tools()
        tools = [
            MCPTool(
                name=t.get("name", ""),
                description=t.get("description", ""),
                input_schema=t.get("inputSchema") or {"type": "object", "properties": {}},
            )
            for t in raw_tools
        ]
        conn = MCPConnection(name=server.metadata.name, client=client, tools=tools)
        async with self._lock:
            old = self._connections.pop(server.metadata.name, None)
            self._connections[server.metadata.name] = conn
        if old is not None:
            await old.client.close()
        return conn

    def get_connection(self, name: str) -> Optional[MCPConnection]:
        return self._connections.get(name)

    def get_tools(self, name: str) -> list[MCPTool]:
        """Tools for one server."""
        conn = self._connections.get(name)
        return list(conn.tools) if conn else []

    async def call_tool(self, server_name: str, tool_name: str, arguments: dict[str, Any]) -> str:
        """Invoke a tool; returns flattened text."""
        conn = self._connections.get(server_name)
        if conn is None:
            raise MCPError(f"MCP server {server_name!r} not connected")
        result = await conn.client.call_tool(tool_name, arguments)
        return flatten_tool_result(result)

    async def disconnect_server(self, name: str) -> None:
        async with self._lock:
            conn = self._connections.pop(name, None)
        if conn is not None:
            await conn.client.close()

    async def close(self) -> None:
        for name in list(self._connections):
            await self.disconnect_server(name)
