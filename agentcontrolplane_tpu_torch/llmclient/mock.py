"""Scriptable mock LLM client, the controllers' test seam (the port's copy
of the reference's ``llmclient/mock.py``): script responses or errors per
call; every request is recorded for assertions."""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass, field
from typing import Callable, Optional, Union

from ..engine.types import Message, MessageToolCall, Tool, ToolCallFunction
from .base import LLMClient


def assistant(content: str) -> Message:
    return Message(role="assistant", content=content)


def tool_call_message(*calls: tuple[str, dict]) -> Message:
    """Assistant message with tool calls: (tool_name, args_dict) pairs."""
    return Message(
        role="assistant",
        content="",
        tool_calls=[
            MessageToolCall(
                id=f"call_{i}",
                function=ToolCallFunction(name=name, arguments=json.dumps(args)),
            )
            for i, (name, args) in enumerate(calls)
        ],
    )


@dataclass
class RecordedRequest:
    messages: list[Message]
    tools: list[Tool]


Scripted = Union[Message, Exception, Callable[[list[Message], list[Tool]], Message]]


@dataclass
class MockLLMClient(LLMClient):
    script: list[Scripted] = field(default_factory=list)
    default: Optional[Message] = None
    requests: list[RecordedRequest] = field(default_factory=list)
    # simulated latency per request (provider_config.delay_s), so a test
    # can hold a task mid-request
    delay_s: float = 0.0

    async def send_request(self, messages: list[Message], tools: list[Tool]) -> Message:
        self.requests.append(RecordedRequest(messages=list(messages), tools=list(tools)))
        if self.delay_s > 0:
            await asyncio.sleep(self.delay_s)
        if self.script:
            item = self.script.pop(0)
        elif self.default is not None:
            item = self.default
        else:
            item = assistant("mock response")
        if isinstance(item, Exception):
            raise item
        if callable(item) and not isinstance(item, Message):
            return item(messages, tools)
        return item
