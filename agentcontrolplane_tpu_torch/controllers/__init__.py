"""Reconcilers. Ported: ``LLMReconciler`` and ``AgentReconciler``; the Task,
ToolCall, MCPServer and ContactChannel controllers are ROADMAP A.2(b)
part 2."""

from .agent import AgentReconciler
from .llm import LLMReconciler

__all__ = ["AgentReconciler", "LLMReconciler"]
