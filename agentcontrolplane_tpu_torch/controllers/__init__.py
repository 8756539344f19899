"""Reconcilers: the six controllers the operator registers."""

from .agent import AgentReconciler
from .contactchannel import ContactChannelReconciler, validate_channel_config
from .llm import LLMReconciler
from .mcpserver import MCPServerReconciler, validate_mcpserver_spec
from .task import TaskReconciler, build_initial_context_window, channel_payload
from .toolcall import ToolCallReconciler

__all__ = [
    "AgentReconciler", "ContactChannelReconciler", "validate_channel_config",
    "LLMReconciler", "MCPServerReconciler", "validate_mcpserver_spec",
    "TaskReconciler", "build_initial_context_window", "channel_payload",
    "ToolCallReconciler",
]
