"""Agent controller: validates an Agent's dependencies and caches the
resolved set in its status, so the Task path never re-resolves them (the
port's copy of the reference's ``controllers/agent.py``).

It reads the LLM, MCPServer, ContactChannel and sub-Agent objects from the
store; their own controllers make them ready.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..api.resources import (
    Agent,
    AgentStatus,
    ContactChannel,
    LLM,
    MCPServer,
    ResolvedMCPServer,
    ResolvedSubAgent,
)
from ..kernel.events import EventRecorder
from ..kernel.runtime import Result
from ..kernel.store import Key, Store

REQUEUE_DELAY = 5.0


@dataclass
class AgentReconciler:
    store: Store
    recorder: EventRecorder
    requeue_delay: float = REQUEUE_DELAY
    # Ready agents are revalidated periodically so a later-broken dependency
    # (deleted LLM, disconnected MCP server) surfaces as Error/Pending rather
    # than leaving status.ready=True forever.
    revalidate_interval: float = 60.0

    async def reconcile(self, key: Key) -> Result:
        _, ns, name = key
        agent = self.store.try_get("Agent", name, ns)
        if agent is None:
            return Result.done()
        assert isinstance(agent, Agent)

        pending: list[str] = []
        errors: list[str] = []

        llm = self.store.try_get("LLM", agent.spec.llm_ref.name, ns)
        if not isinstance(llm, LLM):
            errors.append(f'LLM "{agent.spec.llm_ref.name}" not found')
        elif not llm.status.ready:
            pending.append(f'LLM "{llm.name}" not ready')

        valid_servers: list[ResolvedMCPServer] = []
        for ref in agent.spec.mcp_servers:
            server = self.store.try_get("MCPServer", ref.name, ns)
            if not isinstance(server, MCPServer):
                errors.append(f'MCPServer "{ref.name}" not found')
            elif not server.status.connected:
                pending.append(f'MCPServer "{ref.name}" not connected')
            else:
                valid_servers.append(
                    ResolvedMCPServer(
                        name=ref.name, tools=[t.name for t in server.status.tools]
                    )
                )

        valid_channels: list[str] = []
        for ref in agent.spec.human_contact_channels:
            channel = self.store.try_get("ContactChannel", ref.name, ns)
            if not isinstance(channel, ContactChannel):
                errors.append(f'ContactChannel "{ref.name}" not found')
            elif not channel.status.ready:
                pending.append(f'ContactChannel "{ref.name}" not ready')
            else:
                valid_channels.append(ref.name)

        valid_sub_agents: list[ResolvedSubAgent] = []
        for ref in agent.spec.sub_agents:
            sub = self.store.try_get("Agent", ref.name, ns)
            if not isinstance(sub, Agent):
                errors.append(f'sub-agent "{ref.name}" not found')
            elif not sub.status.ready:
                pending.append(f'sub-agent "{ref.name}" not ready')
            else:
                valid_sub_agents.append(
                    ResolvedSubAgent(name=ref.name, description=sub.spec.description)
                )

        if errors:
            ready, status, detail = False, "Error", "; ".join(errors)
        elif pending:
            ready, status, detail = False, "Pending", "; ".join(pending)
        else:
            ready, status, detail = True, "Ready", "All dependencies validated"
        desired = AgentStatus(
            ready=ready, status=status, status_detail=detail,
            valid_mcp_servers=valid_servers,
            valid_human_contact_channels=valid_channels,
            valid_sub_agents=valid_sub_agents,
        )
        if desired == agent.status:
            # unchanged: skip the write, whose own watch event would re-run
            # this reconcile at once instead of after the requeue delay (the
            # reference rewrites, and spins; ROADMAP C)
            updated = agent
        else:
            def apply(fresh) -> None:
                fresh.status = desired.model_copy(deep=True)

            updated = self.store.mutate_status("Agent", name, ns, apply)
        if errors:
            self.recorder.event(updated, "Warning", "ValidationFailed", "; ".join(errors))
            return Result.after(self.requeue_delay)
        if pending:
            self.recorder.event(updated, "Normal", "Waiting", "; ".join(pending))
            return Result.after(self.requeue_delay)
        if not agent.status.ready:
            self.recorder.event(updated, "Normal", "ValidationSucceeded", "Agent dependencies validated")
        return Result.after(self.revalidate_interval)
