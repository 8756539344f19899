"""Tool-call extraction from generated text — a copy of the batch parser of
the reference's ``engine/toolparse.py`` over the port's own message types.
(The incremental ``ToolStreamParser`` belongs to overlapped tool execution,
which the port does not have yet.)

The wire convention taught in the system prompt is a bare JSON object
``{"name": ..., "arguments": {...}}`` per call. Parsing is defensive:
whole-text JSON, fenced ```json blocks, a balanced-brace scan anywhere in
the text, and ``<|python_tag|>`` stripping. If any call parses, the message
is a tool-call message with empty content.
"""

from __future__ import annotations

import json
import re
import uuid
from typing import Optional

from .types import Message, MessageToolCall, ToolCallFunction

_FENCE_RE = re.compile(r"```(?:json)?\s*(.*?)```", re.DOTALL)


def _candidate_objects(text: str):
    """Yield balanced top-level {...} substrings."""
    depth = 0
    start = -1
    in_str = False
    escape = False
    for i, ch in enumerate(text):
        if in_str:
            if escape:
                escape = False
            elif ch == "\\":
                escape = True
            elif ch == '"':
                in_str = False
            continue
        if ch == '"':
            in_str = True
        elif ch == "{":
            if depth == 0:
                start = i
            depth += 1
        elif ch == "}":
            if depth > 0:
                depth -= 1
                if depth == 0 and start >= 0:
                    yield text[start : i + 1]
                    start = -1


def _to_tool_call(obj) -> Optional[MessageToolCall]:
    if not isinstance(obj, dict):
        return None
    name = obj.get("name")
    if not isinstance(name, str) or not name:
        return None
    args = obj.get("arguments", obj.get("parameters", {}))
    if isinstance(args, str):
        try:
            args = json.loads(args)
        except json.JSONDecodeError:
            return None
    if not isinstance(args, dict):
        return None
    return MessageToolCall(
        id=f"call_{uuid.uuid4().hex[:8]}",
        function=ToolCallFunction(name=name, arguments=json.dumps(args)),
    )


def parse_tool_calls(text: str) -> list[MessageToolCall]:
    text = text.replace("<|python_tag|>", "").strip()
    # 1. whole text
    try:
        tc = _to_tool_call(json.loads(text))
        if tc is not None:
            return [tc]
    except json.JSONDecodeError:
        pass
    # 2. fenced blocks take precedence only when one yields a call;
    # 3. otherwise the balanced-brace scan
    calls: list[MessageToolCall] = []
    for src in [m.group(1) for m in _FENCE_RE.finditer(text)]:
        try:
            obj = json.loads(src.strip())
        except json.JSONDecodeError:
            continue
        tc = _to_tool_call(obj)
        if tc is not None:
            calls.append(tc)
    if calls:
        return calls
    for src in _candidate_objects(text):
        try:
            obj = json.loads(src.strip())
        except json.JSONDecodeError:
            continue
        tc = _to_tool_call(obj)
        if tc is not None:
            calls.append(tc)
    return calls


def to_message(text: str, allowed_tools: Optional[set[str]] = None) -> Message:
    """Generated text -> assistant Message. Tool calls beat content; calls to
    unknown tools are treated as plain text."""
    calls = parse_tool_calls(text)
    if allowed_tools is not None:
        calls = [c for c in calls if c.function.name in allowed_tools]
    if calls:
        return Message(role="assistant", content="", tool_calls=calls)
    return Message(role="assistant", content=text.strip())
