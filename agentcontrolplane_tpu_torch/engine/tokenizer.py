"""Byte tokenizer and the Llama-3 chat template — a copy of the reference's
``engine/tokenizer.py`` over the port's own message types. The
``tokenizers``-backed HF tokenizer is not ported yet (that package is
absent where the card runs).

Tool-call turns follow the JSON convention parsed by ``toolparse``: tool
schemas go into the system prompt, assistant tool calls are serialized
JSON, tool results arrive as ``ipython`` turns.
"""

from __future__ import annotations

import json
from typing import Protocol, Sequence

from .types import Message, Tool

BOT = "<|begin_of_text|>"
EOT = "<|eot_id|>"
EOS = "<|end_of_text|>"
SH = "<|start_header_id|>"
EH = "<|end_header_id|>"

SPECIALS = [BOT, EOS, SH, EH, EOT, "<|python_tag|>", "<|pad|>", "<|unk|>"]

ROLE_HEADER = {"system": "system", "user": "user", "assistant": "assistant", "tool": "ipython"}


class Tokenizer(Protocol):
    def encode(self, text: str) -> list[int]: ...
    def decode(self, tokens: Sequence[int]) -> str: ...
    @property
    def stop_tokens(self) -> set[int]: ...
    @property
    def vocab_size(self) -> int: ...


class ByteTokenizer:
    """UTF-8 bytes at ids 0-255; specials from 256."""

    def __init__(self):
        self._specials = {s: 256 + i for i, s in enumerate(SPECIALS)}
        self._specials_rev = {v: k for k, v in self._specials.items()}

    @property
    def vocab_size(self) -> int:
        return 256 + len(SPECIALS)

    @property
    def stop_tokens(self) -> set[int]:
        return {self._specials[EOT], self._specials[EOS]}

    def encode(self, text: str) -> list[int]:
        out: list[int] = []
        i = 0
        while i < len(text):
            if text[i] == "<":
                matched = False
                for s, tid in self._specials.items():
                    if text.startswith(s, i):
                        out.append(tid)
                        i += len(s)
                        matched = True
                        break
                if matched:
                    continue
            out.extend(text[i].encode("utf-8"))
            i += 1
        return out

    def decode(self, tokens: Sequence[int]) -> str:
        parts: list[str] = []
        buf = bytearray()
        for t in tokens:
            if t >= 256:
                if buf:
                    parts.append(buf.decode("utf-8", errors="replace"))
                    buf = bytearray()
                parts.append(self._specials_rev.get(t, ""))
            else:
                buf.append(t)
        if buf:
            parts.append(buf.decode("utf-8", errors="replace"))
        return "".join(parts)


TOOL_INSTRUCTIONS = """

You have access to the following tools. To call a tool, respond with ONLY a
JSON object of the form {{"name": "<tool-name>", "arguments": {{...}}}} and
nothing else. To answer the user directly, respond with plain text.

Available tools:
{tools}"""


def render_system(system: str, tools: Sequence[Tool]) -> str:
    if not tools:
        return system
    tool_lines = "\n".join(
        json.dumps(
            {
                "name": t.function.name,
                "description": t.function.description,
                "parameters": t.function.parameters,
            }
        )
        for t in tools
    )
    return system + TOOL_INSTRUCTIONS.format(tools=tool_lines)


def _turn(role: str, content: str) -> str:
    # content trimmed like the official template's ``content | trim``
    return f"{SH}{ROLE_HEADER[role]}{EH}\n\n{content.strip()}{EOT}"


def render_turns(
    messages: Sequence[Message], tools: Sequence[Tool]
) -> list[tuple[str, str]]:
    """Context window -> [(role, rendered_segment), ...], the blocks
    :func:`render_prompt` concatenates."""
    parts: list[tuple[str, str]] = [("bot", BOT)]
    rendered_system = False
    for m in messages:
        if m.role == "system" and not rendered_system:
            parts.append(("system", _turn("system", render_system(m.content, tools))))
            rendered_system = True
            continue
        if m.role == "assistant" and m.tool_calls:
            calls = [
                {
                    "name": tc.function.name,
                    "arguments": json.loads(tc.function.arguments or "{}"),
                }
                for tc in m.tool_calls
            ]
            body = "\n".join(json.dumps(c) for c in calls)
            parts.append(("assistant", _turn("assistant", body)))
            continue
        parts.append((m.role, _turn(m.role, m.content)))
    if not rendered_system and tools:
        parts.insert(1, ("system", _turn("system", render_system("", tools))))
    return parts


def render_prompt(messages: Sequence[Message], tools: Sequence[Tool]) -> str:
    """Context window -> Llama-3 chat prompt ending at an open assistant turn."""
    parts = [t for _, t in render_turns(messages, tools)]
    parts.append(f"{SH}assistant{EH}\n\n")
    return "".join(parts)
