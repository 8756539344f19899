"""MCP: the stdio client, the connection pool and the tool adapters. The
streamable-HTTP transport is ROADMAP A.16."""

from .adapters import (
    convert_mcp_tools,
    convert_sub_agents,
    parse_tool_arguments,
    split_tool_name,
)
from .manager import MCPConnection, MCPManager, convert_env_vars, flatten_tool_result
from .stdio import MCPError, StdioMCPClient

__all__ = [
    "convert_mcp_tools", "convert_sub_agents", "parse_tool_arguments",
    "split_tool_name", "MCPConnection", "MCPManager", "convert_env_vars",
    "flatten_tool_result", "MCPError", "StdioMCPClient",
]
