"""MCP tool -> LLM tool-schema conversion (the port's copy of the
reference's ``mcp/adapters.py``).

Tool names are mangled ``server__tool`` so one flat LLM tool namespace
routes back to the right server; a missing schema becomes an empty object
schema. Sub-agents become ``delegate_to_agent__<name>`` tools.
"""

from __future__ import annotations

import json
from typing import Any

from ..api.resources import Agent, MCPTool
from ..engine.types import Tool, ToolFunction
from ..llmclient.base import MESSAGE_SCHEMA

EMPTY_SCHEMA: dict[str, Any] = {"type": "object", "properties": {}}


def convert_mcp_tools(tools: list[MCPTool], server_name: str) -> list[Tool]:
    out = []
    for t in tools:
        out.append(
            Tool(
                function=ToolFunction(
                    name=f"{server_name}__{t.name}",
                    description=t.description,
                    parameters=t.input_schema or dict(EMPTY_SCHEMA),
                ),
                acp_tool_type="MCP",
            )
        )
    return out


def convert_sub_agents(agents: list[Agent]) -> list[Tool]:
    """Delegate tools ``delegate_to_agent__<name>`` with a message parameter."""
    return [
        Tool(
            function=ToolFunction(
                name=f"delegate_to_agent__{a.metadata.name}",
                description=a.spec.description,
                parameters=dict(MESSAGE_SCHEMA),
            ),
            acp_tool_type="DelegateToAgent",
        )
        for a in agents
    ]


def split_tool_name(name: str) -> tuple[str, str]:
    """``server__tool`` -> (server, tool). Raises on unmangled names."""
    if "__" not in name:
        raise ValueError(f"tool name {name!r} is not of the form server__tool")
    server, tool = name.split("__", 1)
    return server, tool


def parse_tool_arguments(arguments: str) -> dict[str, Any]:
    """JSON arguments string -> dict."""
    try:
        parsed = json.loads(arguments or "{}")
    except json.JSONDecodeError as e:
        raise ValueError(f"failed to parse tool arguments: {e}") from e
    if not isinstance(parsed, dict):
        raise ValueError("tool arguments must be a JSON object")
    return parsed
