"""MCP stdio transport: JSON-RPC 2.0 over a subprocess's stdin/stdout (the
port's copy of the reference's ``mcp/stdio.py``).

Newline-delimited JSON-RPC: the ``initialize`` handshake, ``tools/list``,
``tools/call``. Requests are multiplexed by JSON-RPC id: a background
reader resolves per-request futures, so concurrent ``call_tool``s to one
server overlap instead of serializing behind one request-response lock.
"""

from __future__ import annotations

import asyncio
import json
import os
from typing import Any, Optional

PROTOCOL_VERSION = "2024-11-05"


class MCPError(Exception):
    pass


def parse_quantity(q: str) -> int:
    """k8s memory quantity -> bytes ("512Mi", "1Gi", "100M", "1024")."""
    q = q.strip()
    units = {
        "Ki": 1024, "Mi": 1024**2, "Gi": 1024**3, "Ti": 1024**4,
        "K": 1000, "M": 1000**2, "G": 1000**3, "T": 1000**4, "k": 1000,
    }
    for suffix, mult in units.items():
        if q.endswith(suffix):
            return int(float(q[: -len(suffix)]) * mult)
    return int(float(q))


class StdioMCPClient:
    def __init__(
        self,
        command: str,
        args: list[str],
        env: dict[str, str] | None = None,
        memory_limit: int | None = None,  # bytes (spec.resources.limits.memory)
    ):
        self.command = command
        self.args = args
        self.env = env or {}
        self.memory_limit = memory_limit
        self._proc: Optional[asyncio.subprocess.Process] = None
        self._id = 0
        self._lock = asyncio.Lock()  # serializes stdin writes only
        self._pending: dict[int, asyncio.Future] = {}
        self._reader: Optional[asyncio.Task] = None
        self._dead: Optional[str] = None  # reader's terminal error, if any
        self.server_info: dict[str, Any] = {}

    def _argv(self) -> list[str]:
        """Command line, with the memory limit (a pod's resource limit,
        standalone) applied by a ``/bin/sh ulimit`` shim rather than
        ``preexec_fn``: preexec_fn forces subprocess down the fork() path,
        which is deadlock-prone in a process with live threads (the engine's
        loop, the CUDA runtime's); the shim keeps the spawn on
        posix_spawn."""
        if not self.memory_limit or os.name != "posix":
            return [self.command, *self.args]
        kb = max(1, self.memory_limit // 1024)
        # ulimit soft-fails (';', stderr dropped): platforms that refuse
        # RLIMIT_AS still start the server, without the limit
        return [
            "/bin/sh", "-c", f'ulimit -v {kb} 2>/dev/null; exec "$0" "$@"',
            self.command, *self.args,
        ]

    async def start(self, timeout: float = 15.0) -> None:
        env = dict(os.environ)
        env.update(self.env)
        self._proc = await asyncio.create_subprocess_exec(
            *self._argv(),
            stdin=asyncio.subprocess.PIPE,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.DEVNULL,
            env=env,
        )
        self._reader = asyncio.ensure_future(self._read_loop())
        result = await self._request(
            "initialize",
            {
                "protocolVersion": PROTOCOL_VERSION,
                "capabilities": {},
                "clientInfo": {"name": "acp-tpu", "version": "0.1.0"},
            },
            timeout=timeout,
        )
        self.server_info = result.get("serverInfo", {})
        await self._notify("notifications/initialized", {})

    async def _send(self, msg: dict[str, Any]) -> None:
        assert self._proc and self._proc.stdin
        self._proc.stdin.write(json.dumps(msg).encode() + b"\n")
        await self._proc.stdin.drain()

    async def _read_loop(self) -> None:
        """Single stdout reader resolving pending requests by id. A dead
        pipe fails every in-flight and future request — concurrent callers
        must never hang on a response that can no longer arrive."""
        assert self._proc and self._proc.stdout
        error = f"MCP server {self.command} closed its stdout"
        try:
            while True:
                line = await self._proc.stdout.readline()
                if not line:
                    break
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError:
                    continue  # stray non-protocol output
                fut = self._pending.pop(msg.get("id"), None)
                if fut is not None and not fut.done():
                    fut.set_result(msg)
        except asyncio.CancelledError:
            error = "MCP client closed"
        except Exception as e:
            error = f"MCP stdout reader failed: {e}"
        self._dead = error
        pending, self._pending = self._pending, {}
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(MCPError(error))

    async def _request(self, method: str, params: dict[str, Any], timeout: float = 30.0) -> dict[str, Any]:
        if self._dead is not None:
            raise MCPError(self._dead)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        async with self._lock:  # writes serialize; responses multiplex
            self._id += 1
            rid = self._id
            self._pending[rid] = fut
            # the reader sets _dead BEFORE swapping out the pending dict:
            # if it died between the fast-path check and this registration,
            # our future landed in the post-swap dict nobody will ever
            # sweep — re-checking AFTER registering closes the window
            # (dead already set => fail fast; dead set later => the sweep
            # sees our entry)
            if self._dead is not None:
                self._pending.pop(rid, None)
                raise MCPError(self._dead)
            try:
                await self._send({"jsonrpc": "2.0", "id": rid, "method": method, "params": params})
            except Exception:
                self._pending.pop(rid, None)
                raise
        try:
            msg = await asyncio.wait_for(fut, timeout)
        finally:
            self._pending.pop(rid, None)
        if "error" in msg:
            err = msg["error"]
            raise MCPError(f"{method}: {err.get('message')} ({err.get('code')})")
        return msg.get("result", {})

    async def _notify(self, method: str, params: dict[str, Any]) -> None:
        await self._send({"jsonrpc": "2.0", "method": method, "params": params})

    async def list_tools(self) -> list[dict[str, Any]]:
        result = await self._request("tools/list", {})
        return result.get("tools", [])

    async def call_tool(self, name: str, arguments: dict[str, Any], timeout: float = 60.0) -> dict[str, Any]:
        return await self._request("tools/call", {"name": name, "arguments": arguments}, timeout=timeout)

    @property
    def alive(self) -> bool:
        return self._proc is not None and self._proc.returncode is None

    async def close(self) -> None:
        if self._reader is not None:
            self._reader.cancel()
            try:
                await self._reader
            except (asyncio.CancelledError, Exception):
                pass
            self._reader = None
        if self._proc is None:
            return
        if self._proc.returncode is None:
            try:
                self._proc.terminate()
                await asyncio.wait_for(self._proc.wait(), 3.0)
            except (asyncio.TimeoutError, ProcessLookupError):
                try:
                    self._proc.kill()
                except ProcessLookupError:
                    pass
        self._proc = None
