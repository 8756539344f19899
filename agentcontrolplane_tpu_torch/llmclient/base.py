"""Provider-agnostic chat-completion seam — the port's copy of the
reference's ``agentcontrolplane_tpu/llmclient/base.py`` over its dataclass
``Message`` / ``Tool`` (``engine/types.py``).

One interface, ``send_request(messages, tools) -> assistant Message``, is
the boundary the serving engine lives behind (``engine/client.py``).
``LLMRequestError`` carries the HTTP status, so a caller can treat 4xx as
terminal.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from ..engine.types import Message, Tool


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

