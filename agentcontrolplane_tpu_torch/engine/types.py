"""Chat message and tool types as dataclasses.

The reference's are pydantic models (``api/resources.py`` Message /
MessageToolCall / ToolCallFunction / BaseConfig, ``llmclient/base.py`` Tool /
ToolFunction); the card's machine has no pydantic, so the port keeps these
field-for-field copies. The first four are part of the object model
(``api/resources.py`` re-exports them) and validate as it does
(``schema.APIModel``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Literal, Optional

from ..schema import APIModel


@dataclass(kw_only=True)
class ToolCallFunction(APIModel):
    name: str
    arguments: str = "{}"  # JSON-encoded arguments, as in OpenAI tool calls


@dataclass(kw_only=True)
class MessageToolCall(APIModel):
    id: str
    function: ToolCallFunction
    type: str = "function"


Role = Literal["system", "user", "assistant", "tool"]


@dataclass(kw_only=True)
class Message(APIModel):
    """One message of a context window."""

    role: Role
    content: str = ""
    tool_calls: list[MessageToolCall] = field(default_factory=list)
    tool_call_id: Optional[str] = None
    name: Optional[str] = None


@dataclass
class ToolFunction:
    name: str
    description: str = ""
    parameters: dict[str, Any] = field(
        default_factory=lambda: {"type": "object", "properties": {}}
    )


@dataclass
class Tool:
    """An LLM-visible function tool. ``acp_tool_type`` is internal routing
    metadata (MCP | HumanContact | DelegateToAgent), never sent to the
    model."""

    function: ToolFunction
    type: str = "function"
    acp_tool_type: str = "MCP"


@dataclass(kw_only=True)
class BaseConfig(APIModel):
    """Common sampling parameters of an LLM (the reference's
    ``api/resources.py::BaseConfig``; None = the engine's default)."""

    model: str = ""
    base_url: Optional[str] = None
    temperature: Optional[float] = None
    max_tokens: Optional[int] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
