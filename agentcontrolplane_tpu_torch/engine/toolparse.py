"""Tool-call extraction from generated text — a copy of the reference's
``engine/toolparse.py`` over the port's own message types: the batch parser
and the incremental ``ToolStreamParser`` that the engine feeds from every
token commit (streamed tool calls, early dispatch).

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


class ToolStreamParser:
    """Resumable incremental tool-call scanner for overlapped execution.

    Consumes detokenized text deltas as the decode loop commits tokens
    (``engine.py`` feeds it from the first-token commit, forced prefix
    included, and from every decode block) and emits
    each tool call the moment its closing brace lands — O(delta) per feed,
    no full-text rescans.

    Semantics are the balanced-brace scan of :func:`parse_tool_calls`
    applied everywhere in the stream (fence markers are prose to this
    scanner; the objects inside a fence are found by the brace walk
    itself). ``<|python_tag|>`` never needs stripping here: the tag
    contains no braces, so a call following it — even a tag split across
    deltas — parses identically. For the wire convention the system prompt
    teaches (bare JSON objects, optionally fenced), the emitted calls are
    exactly ``parse_tool_calls``'s; callers that must be robust to
    degenerate mixed fenced+bare output reconcile against the final batch
    parse (as the SSE front door does, ``server/rest.py``).

    Bounded buffering: only text inside a candidate object is retained
    (prose is dropped as it streams); an object that never closes is
    abandoned as prose once it exceeds ``max_object_bytes``.
    """

    def __init__(self, max_object_bytes: int = 65536):
        self.max_object_bytes = max_object_bytes
        self._buf: list[str] = []  # current candidate object, chunked
        self._buf_len = 0
        self._depth = 0
        self._in_str = False
        self._escape = False
        self.emitted = 0  # calls emitted so far (stable indices)
        self.dropped = 0  # candidate objects abandoned (overflow / bad JSON)

    def _reset_candidate(self) -> None:
        self._buf = []
        self._buf_len = 0
        self._depth = 0
        self._in_str = False
        self._escape = False

    def feed(self, delta: str) -> list[MessageToolCall]:
        """Consume one text delta; return the calls whose braces closed in
        it (usually empty). State carries across feeds, so calls split at
        any token/dispatch boundary — mid-string, mid-escape, mid-\\uXXXX —
        assemble correctly."""
        out: list[MessageToolCall] = []
        i = 0
        n = len(delta)
        while i < n:
            if self._depth == 0:
                # outside any candidate: skip prose up to the next '{'
                start = delta.find("{", i)
                if start < 0:
                    return out
                i = start
                self._buf = ["{"]
                self._buf_len = 1
                self._depth = 1
                self._in_str = False
                self._escape = False
                i += 1
                continue
            # inside a candidate: scan this delta chunk char by char
            j = i
            while j < n:
                ch = delta[j]
                j += 1
                if self._in_str:
                    if self._escape:
                        self._escape = False
                    elif ch == "\\":
                        self._escape = True
                    elif ch == '"':
                        self._in_str = False
                    continue
                if ch == '"':
                    self._in_str = True
                elif ch == "{":
                    self._depth += 1
                elif ch == "}":
                    self._depth -= 1
                    if self._depth == 0:
                        break
            self._buf.append(delta[i:j])
            self._buf_len += j - i
            i = j
            if self._depth == 0:
                src = "".join(self._buf)
                self._reset_candidate()
                tc = None
                try:
                    tc = _to_tool_call(json.loads(src))
                except json.JSONDecodeError:
                    pass
                if tc is not None:
                    self.emitted += 1
                    out.append(tc)
                else:
                    self.dropped += 1
            elif self._buf_len > self.max_object_bytes:
                # never-closing brace: stop buffering, treat as prose. The
                # remainder of the delta is rescanned for a fresh candidate.
                self._reset_candidate()
                self.dropped += 1
        return out


def to_message(text: str, allowed_tools: Optional[set[str]] = None) -> Message:
    """Generated text -> assistant Message. Tool calls beat content; calls to
    unknown tools are treated as plain text."""
    calls = parse_tool_calls(text)
    if allowed_tools is not None:
        calls = [c for c in calls if c.function.name in allowed_tools]
    if calls:
        return Message(role="assistant", content="", tool_calls=calls)
    return Message(role="assistant", content=text.strip())
