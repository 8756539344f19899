"""Provider-agnostic chat-completion seam — the port's copy of the
reference's ``agentcontrolplane_tpu/llmclient/base.py`` over its dataclass
``Message`` / ``Tool`` (``engine/types.py``).

One interface, ``send_request(messages, tools) -> assistant Message``, is
the boundary the serving engine lives behind (``engine/client.py``).
``LLMRequestError`` carries the HTTP status, so a caller can treat 4xx as
terminal. ``tool_from_contact_channel`` builds the human-contact tool the
Task controller offers for each of an Agent's channels.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Optional

from ..api.resources import ContactChannel
from ..engine.types import Message, Tool, ToolFunction


class LLMRequestError(Exception):
    """LLM request failure with HTTP status semantics."""

    def __init__(self, status_code: int, message: str):
        super().__init__(f"LLM request failed with status {status_code}: {message}")
        self.status_code = status_code
        self.message = message

    @property
    def terminal(self) -> bool:
        """4xx errors are terminal, except transient 408 (timeout) and 429
        (rate limit), which retry."""
        return 400 <= self.status_code < 500 and self.status_code not in (408, 429)


MESSAGE_SCHEMA: dict[str, Any] = {
    "type": "object",
    "properties": {"message": {"type": "string"}},
    "required": ["message"],
}


def tool_from_contact_channel(channel: ContactChannel) -> Tool:
    """Human-contact tool for a channel: named
    ``<channel>__human_contact_<type>``, described from the channel's
    context."""
    if channel.spec.type == "email":
        name = f"{channel.name}__human_contact_email"
        desc = (channel.spec.email.context_about_user if channel.spec.email else "") or (
            "Contact a human via email"
        )
    elif channel.spec.type == "slack":
        name = f"{channel.name}__human_contact_slack"
        desc = (
            channel.spec.slack.context_about_channel_or_user if channel.spec.slack else ""
        ) or "Contact a human via Slack"
    else:  # pragma: no cover — the type is a closed Literal
        name = f"{channel.name}__human_contact"
        desc = f"Contact a human via {channel.spec.type} channel"
    return Tool(
        function=ToolFunction(name=name, description=desc, parameters=dict(MESSAGE_SCHEMA)),
        acp_tool_type="HumanContact",
    )


class LLMClient(ABC):
    """The seam. The port's implementation is the in-process engine client
    (``engine/client.py::TPUEngineClient``)."""

    # overlapped tool execution: a client that sets this True accepts an
    # ``on_tool_call=(index, MessageToolCall) -> None`` keyword on
    # send_request and invokes it (on the event loop) for each tool call
    # the moment its arguments close, while the completion still streams.
    # Callers gate the keyword on this flag.
    supports_early_tool_calls: bool = False

    @abstractmethod
    async def send_request(self, messages: list[Message], tools: list[Tool]) -> Message: ...

    async def close(self) -> None:  # optional
        return None


def merge_choices(choices: list[Message]) -> Message:
    """Multi-choice merge where tool calls beat content: collect the tool
    calls of every choice; if there are any, return them with empty
    content, else the first non-empty content."""
    out = Message(role="assistant", content="")
    tool_calls = []
    content: Optional[str] = None
    for choice in choices:
        if content is None and choice.content:
            content = choice.content
        tool_calls.extend(choice.tool_calls)
    if tool_calls:
        out.tool_calls = tool_calls
        out.content = ""
        return out
    if content is not None:
        out.content = content
    return out
