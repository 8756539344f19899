"""Chat message and tool types as plain dataclasses.

The reference's are pydantic models (``api/resources.py`` Message /
MessageToolCall / ToolCallFunction, ``llmclient/base.py`` Tool /
ToolFunction); the card's machine has no pydantic, so the port keeps these
field-for-field copies.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class ToolCallFunction:
    name: str
    arguments: str = "{}"  # JSON-encoded arguments, as in OpenAI tool calls


@dataclass
class MessageToolCall:
    id: str
    function: ToolCallFunction
    type: str = "function"


@dataclass
class Message:
    """One message of a context window."""

    role: str  # "system" | "user" | "assistant" | "tool"
    content: str = ""
    tool_calls: list[MessageToolCall] = field(default_factory=list)
    tool_call_id: Optional[str] = None
    name: Optional[str] = None

    def __post_init__(self):
        if self.role not in ("system", "user", "assistant", "tool"):
            raise ValueError(f"unknown message role {self.role!r}")


@dataclass
class ToolFunction:
    name: str
    description: str = ""
    parameters: dict[str, Any] = field(
        default_factory=lambda: {"type": "object", "properties": {}}
    )


@dataclass
class Tool:
    """An LLM-visible function tool."""

    function: ToolFunction
    type: str = "function"


@dataclass
class BaseConfig:
    """Sampling parameters of an LLM — the fields of the reference's
    ``api/resources.py::BaseConfig`` that the engine client reads (None =
    the engine's default)."""

    model: str = ""
    temperature: Optional[float] = None
    max_tokens: Optional[int] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
