"""A reader and a writer for the YAML that manifests use, on the standard
library (the card's machine has no YAML library).

``load_all(text)`` reads a stream of documents as PyYAML's ``safe_load_all``
would, for this subset:

- documents separated by ``---`` (a comment may follow it) and ended by
  ``...``; ``#`` comments;
- block mappings and block sequences (a sequence may sit at its key's
  indentation, and ``- key: value`` starts a mapping inside an item);
- flow sequences and flow mappings (``[a, "b"]``, ``{name: x}``) that close
  on the line they open;
- plain, single-quoted and double-quoted scalars on one line, and ``|``
  literal block scalars (with ``-`` or ``+`` chomping);
- plain scalars resolved as YAML 1.1 does: null (``~``, ``null``, empty),
  bools (``true``/``yes``/``on`` and their opposites, in three cases),
  decimal ints, and floats with a fraction, ``.inf`` and ``.nan``.

Anything else raises ``Invalid`` naming the line: anchors, aliases, tags,
directives, ``?`` keys, ``>`` folded scalars, plain or quoted scalars that
run over several lines, tabs in indentation, and the plain forms PyYAML
would read as another type that this reader does not build (hex, octal,
binary and sexagesimal ints, underscores in numbers, timestamps, ``<<``
merge keys, ``=``). Nothing is guessed.

``dump_all(docs)`` writes documents of dicts, lists, strings, ints, floats,
bools and None in block style; ``safe_load_all`` (and ``load_all``) read
them back equal.
"""

from __future__ import annotations

import math
import re
from typing import Any, Iterable

from ..kernel.errors import Invalid

__all__ = ["load_all", "dump_all"]

# -- plain scalar resolution (PyYAML's YAML 1.1 resolver) ---------------------

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?|\.[0-9]+(?:[eE][-+][0-9]+)?")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)")
# what PyYAML's resolver reads as an int, a float or a timestamp; a plain
# scalar matching one of these and none of the forms above is refused
_OTHER_TYPED = re.compile(
    r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+"
    r"|[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9_]+(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?(?:[Tt]|[ \t]+)[0-9][0-9]?"
    r":[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?"
    r"|<<|="
)
_BREAKS = "\0 \t\r\n\x85\u2028\u2029"


def _resolve_plain(text: str, lineno: int) -> Any:
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    if _INF.fullmatch(text):
        return -math.inf if text[0] == "-" else math.inf
    if _NAN.fullmatch(text):
        return math.nan
    if _OTHER_TYPED.fullmatch(text):
        raise Invalid(f"line {lineno}: the plain scalar {text!r} is outside the supported "
                      "YAML subset (quote it to make it a string)")
    return text


# -- scalars ------------------------------------------------------------------

_ESCAPES = {
    "0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
    "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
    "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029",
}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _quoted(s: str, i: int, lineno: int) -> tuple[str, int]:
    """The quoted scalar opening at ``s[i]`` -> (value, index past it)."""
    quote = s[i]
    out: list[str] = []
    j = i + 1
    while j < len(s):
        ch = s[j]
        if quote == "'":
            if ch == "'":
                if s[j + 1:j + 2] == "'":
                    out.append("'")
                    j += 2
                    continue
                return "".join(out), j + 1
            out.append(ch)
            j += 1
            continue
        if ch == '"':
            return "".join(out), j + 1
        if ch == "\\":
            esc = s[j + 1:j + 2]
            if esc in _ESCAPES:
                out.append(_ESCAPES[esc])
                j += 2
                continue
            width = _HEX_ESCAPES.get(esc)
            digits = s[j + 2:j + 2 + width] if width else ""
            if not width or len(digits) != width or not all(
                    c in "0123456789abcdefABCDEF" for c in digits):
                raise Invalid(f"line {lineno}: unsupported escape in a double-quoted scalar")
            out.append(chr(int(digits, 16)))
            j += 2 + width
            continue
        out.append(ch)
        j += 1
    raise Invalid(f"line {lineno}: a quoted scalar must close on its line")


def _after_value(s: str, j: int, lineno: int) -> None:
    """Only blanks and a comment may follow a value on its line."""
    rest = s[j:]
    stripped = rest.lstrip(" \t")
    if stripped and not (stripped.startswith("#") and len(stripped) < len(rest)):
        raise Invalid(f"line {lineno}: unexpected text after a value: {stripped!r}")


def _strip_comment(s: str) -> str:
    """``s`` without a trailing `` #...`` comment (outside quotes is the
    caller's concern: this is used on plain text only)."""
    for m in re.finditer(r"[ \t]#", s):
        return s[:m.start()]
    return s


def _check_plain_start(text: str, lineno: int, flow: bool) -> None:
    ch = text[:1]
    nxt = text[1:2]
    if ch in "&*!|>%@`" or (ch in "-?:" and (nxt == "" or nxt in _BREAKS + (",[]{}" if flow else ""))):
        raise Invalid(f"line {lineno}: {text!r} is outside the supported YAML subset")
    if ch in "[]{}#,'\"" and ch:
        raise Invalid(f"line {lineno}: unexpected {ch!r}")


def _plain(text: str, lineno: int) -> Any:
    """A block-context plain scalar (comment already removed)."""
    text = text.strip(" \t")
    if not text:
        return None
    _check_plain_start(text, lineno, flow=False)
    if re.search(r":(?:[ \t]|$)", text):
        raise Invalid(f"line {lineno}: a mapping value is not allowed here")
    return _resolve_plain(text, lineno)


# -- flow collections (one line) ----------------------------------------------


class _Flow:
    def __init__(self, s: str, lineno: int):
        self.s, self.i, self.lineno = s, 0, lineno

    def _ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def _peek(self) -> str:
        return self.s[self.i:self.i + 1]

    def _fail(self, what: str):
        raise Invalid(f"line {self.lineno}: {what}")

    def node(self) -> Any:
        self._ws()
        ch = self._peek()
        if ch == "[":
            return self._seq()
        if ch == "{":
            return self._map()
        if ch in ("'", '"'):
            value, self.i = _quoted(self.s, self.i, self.lineno)
            return value
        if not ch:
            self._fail("a flow collection must close on its line")
        return self._plain()

    def _plain(self) -> Any:
        start = self.i
        while self.i < len(self.s):
            ch = self.s[self.i]
            nxt = self.s[self.i + 1:self.i + 2]
            if ch in ",?[]{}" or (ch == ":" and (nxt == "" or nxt in _BREAKS + ",[]{}")):
                break
            if ch == "#" and self.i > start and self.s[self.i - 1] in " \t":
                self._fail("a comment inside a flow collection")
            self.i += 1
        text = self.s[start:self.i].strip(" \t")
        if not text:
            self._fail("an empty entry in a flow collection")
        _check_plain_start(text, self.lineno, flow=True)
        return _resolve_plain(text, self.lineno)

    def _seq(self) -> list:
        self.i += 1
        out: list = []
        while True:
            self._ws()
            if self._peek() == "]":
                self.i += 1
                return out
            out.append(self.node())
            self._ws()
            ch = self._peek()
            if ch == ":":
                self._fail("a mapping inside a flow sequence is outside the supported subset")
            if ch == ",":
                self.i += 1
            elif ch != "]":
                self._fail("a flow sequence must close on its line")

    def _map(self) -> dict:
        self.i += 1
        out: dict = {}
        while True:
            self._ws()
            if self._peek() == "}":
                self.i += 1
                return out
            if self._peek() in ("[", "{"):
                self._fail("a collection as a mapping key")
            key = self.node()
            self._ws()
            if self._peek() == ":":
                self.i += 1
                self._ws()
                value = None if self._peek() in (",", "}") else self.node()
            else:
                value = None
            out[key] = value
            self._ws()
            ch = self._peek()
            if ch == ",":
                self.i += 1
            elif ch != "}":
                self._fail("a flow mapping must close on its line")


def _flow(s: str, lineno: int) -> Any:
    parser = _Flow(s, lineno)
    value = parser.node()
    _after_value(s, parser.i, lineno)
    return value


# -- block structure ----------------------------------------------------------


def _indent(line: str, lineno: int) -> int:
    n = len(line) - len(line.lstrip(" "))
    if line[n:n + 1] == "\t":
        raise Invalid(f"line {lineno}: a tab in indentation")
    return n


def _blank(line: str) -> bool:
    stripped = line.strip(" \t")
    return not stripped or stripped.startswith("#")


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith(("- ", "-\t"))


def _split_key(content: str, lineno: int) -> tuple[Any, str] | None:
    """``key: rest`` -> (key, rest) when ``content`` is a mapping entry."""
    if content[:1] in ("'", '"'):
        key, j = _quoted(content, 0, lineno)
        rest = content[j:].lstrip(" \t")
        if not rest.startswith(":") or (len(rest) > 1 and rest[1] not in " \t"):
            return None
        return key, rest[1:]
    m = re.search(r":(?:[ \t]|$)", content)
    if m is None:
        return None
    raw = content[:m.start()].rstrip(" \t")
    if "#" in content[:m.start()] and re.search(r"[ \t]#", content[:m.start()]):
        return None  # the colon is inside a comment
    if content.startswith(("? ", "?\t")) or content == "?":
        raise Invalid(f"line {lineno}: '?' keys are outside the supported subset")
    if raw[:1] in ("[", "{"):
        raise Invalid(f"line {lineno}: a collection as a mapping key")
    if not raw:
        raise Invalid(f"line {lineno}: an empty mapping key")
    _check_plain_start(raw, lineno, flow=False)
    return _resolve_plain(raw, lineno), content[m.end():]


class _Block:
    def __init__(self, lines: list[str], first_lineno: int):
        self.lines = lines
        self.first = first_lineno
        self.pos = 0

    def lineno(self, pos: int | None = None) -> int:
        return self.first + (self.pos if pos is None else pos)

    def _skip(self) -> None:
        while self.pos < len(self.lines) and _blank(self.lines[self.pos]):
            self.pos += 1

    def _fail(self, what: str):
        raise Invalid(f"line {self.lineno()}: {what}")

    def document(self) -> Any:
        self._skip()
        if self.pos >= len(self.lines):
            return None
        value = self.node(0)
        self._skip()
        if self.pos < len(self.lines):
            self._fail("unexpected content after the document's top-level node")
        return value

    def node(self, min_indent: int) -> Any:
        """The block node starting at the next non-blank line, whose
        indentation must be at least ``min_indent``."""
        self._skip()
        line = self.lines[self.pos]
        n = _indent(line, self.lineno())
        if n < min_indent:
            return None
        content = line[n:]
        if _is_item(content):
            return self._sequence(n)
        if _split_key(content, self.lineno()) is not None:
            return self._mapping(n)
        return self._inline_value(content, parent_indent=n - 1)

    def _sequence(self, n: int) -> list:
        out: list = []
        while True:
            self._skip()
            if self.pos >= len(self.lines):
                return out
            line = self.lines[self.pos]
            indent = _indent(line, self.lineno())
            if indent < n:
                return out
            if indent > n:
                self._fail("unexpected indentation in a sequence")
            content = line[n:]
            if not _is_item(content):
                return out
            rest = content[1:]
            body = rest.lstrip(" \t")
            if "\t" in rest[:len(rest) - len(body)]:
                self._fail("a tab after a sequence dash")
            if _blank(rest):
                self.pos += 1
                self._skip()
                if self.pos < len(self.lines) and _indent(self.lines[self.pos],
                                                          self.lineno()) > n:
                    out.append(self.node(n + 1))
                else:
                    out.append(None)
                continue
            if _is_item(body) or _split_key(body, self.lineno()) is not None:
                # a nested collection: the item's content as a line of its
                # own at its column
                col = n + 1 + (len(rest) - len(body))
                self.lines[self.pos] = " " * col + body
                out.append(self.node(col))
            else:
                out.append(self._inline_value(body, parent_indent=n))

    def _mapping(self, n: int) -> dict:
        out: dict = {}
        while True:
            self._skip()
            if self.pos >= len(self.lines):
                return out
            line = self.lines[self.pos]
            indent = _indent(line, self.lineno())
            if indent < n:
                return out
            if indent > n:
                self._fail("unexpected indentation in a mapping")
            content = line[n:]
            if _is_item(content):
                return out
            split = _split_key(content, self.lineno())
            if split is None:
                self._fail(f"expected 'key: value', got {content.strip()!r}")
            key, rest = split
            if isinstance(key, (dict, list)):
                self._fail("a collection as a mapping key")
            if _blank(rest):
                self.pos += 1
                self._skip()
                value = None
                if self.pos < len(self.lines):
                    nxt = self.lines[self.pos]
                    ni = _indent(nxt, self.lineno())
                    if ni > n:
                        value = self.node(n + 1)
                    elif ni == n and _is_item(nxt[n:]):
                        value = self._sequence(n)
                out[key] = value
                continue
            out[key] = self._inline_value(rest.lstrip(" \t"), parent_indent=n)

    def _inline_value(self, text: str, parent_indent: int) -> Any:
        """The value that starts on the current line (``text``), then the
        current line is consumed (with a block scalar's lines)."""
        lineno = self.lineno()
        ch = text[:1]
        if ch in ("&", "*", "!"):
            self._fail("anchors, aliases and tags are outside the supported subset")
        if ch == "|":
            header = _strip_comment(text).rstrip(" \t")
            if header not in ("|", "|-", "|+"):
                self._fail(f"block scalar header {header!r} is outside the supported subset")
            self.pos += 1
            return self._literal(parent_indent, header[1:])
        if ch == ">":
            self._fail("folded block scalars are outside the supported subset")
        if ch in ("[", "{"):
            value = _flow(text, lineno)
        elif ch in ("'", '"'):
            value, j = _quoted(text, 0, lineno)
            _after_value(text, j, lineno)
        else:
            value = _plain(_strip_comment(text), lineno)
        self.pos += 1
        # a scalar continued on the next, more indented line
        save = self.pos
        self._skip()
        if self.pos < len(self.lines) and _indent(self.lines[self.pos],
                                                  self.lineno()) > parent_indent:
            self._fail("a scalar over several lines is outside the supported subset")
        self.pos = save
        return value

    def _literal(self, parent_indent: int, chomp: str) -> str:
        body: list[str] = []
        indent = None
        while self.pos < len(self.lines):
            line = self.lines[self.pos]
            if not line.strip(" "):
                body.append("")
                self.pos += 1
                continue
            n = len(line) - len(line.lstrip(" "))
            if indent is None:
                if n <= parent_indent:
                    break
                indent = n
            if n < indent:
                break
            body.append(line[indent:])
            self.pos += 1
        # trailing blank lines belong to the scalar only under "+"
        trailing = 0
        while body and body[-1] == "":
            body.pop()
            trailing += 1
        text = "\n".join(body)
        if chomp == "-":
            return text
        if chomp == "+":
            return text + "\n" * (trailing + (1 if body else 0)) if body else "\n" * trailing
        return text + "\n" if body else ""


# -- documents ----------------------------------------------------------------


def load_all(text: str) -> list[Any]:
    """Every document of a YAML stream in the supported subset, as
    ``yaml.safe_load_all`` returns them (a list, not a generator)."""
    if text.startswith("\ufeff"):
        text = text[1:]
    lines = [ln[:-1] if ln.endswith("\r") else ln for ln in text.split("\n")]
    docs: list[Any] = []
    chunk: list[str] = []
    chunk_start = 1
    explicit = False
    ended = False

    def flush() -> None:
        if explicit or any(not _blank(ln) for ln in chunk):
            docs.append(_Block(chunk, chunk_start).document())

    for i, line in enumerate(lines, 1):
        if line.startswith("%"):
            raise Invalid(f"line {i}: directives are outside the supported subset")
        marker = line[:3]
        if marker in ("---", "...") and (len(line) == 3 or line[3] in " \t"):
            tail = line[3:].strip(" \t")
            if tail and not tail.startswith("#"):
                raise Invalid(f"line {i}: content on a document marker line")
            if marker == "---":
                if not ended:
                    flush()
                explicit, ended = True, False
            else:
                if not ended:
                    flush()
                explicit, ended = False, True
            chunk, chunk_start = [], i + 1
            continue
        if ended and not _blank(line):
            raise Invalid(f"line {i}: content after '...' without '---'")
        chunk.append(line)
    if not ended:
        flush()
    return docs


# -- writer -------------------------------------------------------------------

_PLAIN_SAFE = re.compile(r"[A-Za-z][A-Za-z0-9_./-]*(?: [A-Za-z0-9_./-]+)*")


def _scalar(value: Any) -> str:
    if value is None:
        return "null"
    if value is True:
        return "true"
    if value is False:
        return "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        if "." not in text:  # 1e-05 -> 1.0e-05: YAML 1.1 floats need a dot
            mantissa, _, exp = text.partition("e")
            text = f"{mantissa}.0e{exp if exp[:1] in '+-' else '+' + exp}" if exp else text + ".0"
        return text
    if isinstance(value, str):
        if _PLAIN_SAFE.fullmatch(value) and value not in _NULL | _TRUE | _FALSE:
            return value
        return _double_quoted(value)
    raise Invalid(f"cannot write a {type(value).__name__} as YAML")


def _double_quoted(s: str) -> str:
    out = ['"']
    for ch in s:
        o = ord(ch)
        if ch == '"':
            out.append('\\"')
        elif ch == "\\":
            out.append("\\\\")
        elif 0x20 <= o <= 0x7E or (o >= 0xA0 and o not in (0x2028, 0x2029, 0xFEFF)
                                   and not 0xD800 <= o <= 0xDFFF and o not in (0xFFFE, 0xFFFF)):
            out.append(ch)
        elif ch == "\n":
            out.append("\\n")
        elif ch == "\t":
            out.append("\\t")
        elif o <= 0xFF:
            out.append(f"\\x{o:02x}")
        elif o <= 0xFFFF:
            out.append(f"\\u{o:04x}")
        else:
            out.append(f"\\U{o:08x}")
    out.append('"')
    return "".join(out)


def _emit(value: Any, indent: int, out: list[str]) -> None:
    """Append the block lines of a dict or list at ``indent``."""
    pad = " " * indent
    if isinstance(value, dict):
        for k, v in value.items():
            key = _scalar(k)
            if isinstance(v, (dict, list)) and v:
                out.append(f"{pad}{key}:")
                _emit(v, indent + 2, out)
            else:
                out.append(f"{pad}{key}: {_inline(v)}")
    else:
        for v in value:
            if isinstance(v, (dict, list)) and v:
                sub: list[str] = []
                _emit(v, indent + 2, sub)
                out.append(f"{pad}- {sub[0][indent + 2:]}")
                out.extend(sub[1:])
            else:
                out.append(f"{pad}- {_inline(v)}")


def _inline(value: Any) -> str:
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, list):
        return "[]"
    return _scalar(value)


def dump_all(docs: Iterable[Any]) -> str:
    """Documents in block style, each after a ``---`` line but the first."""
    parts: list[str] = []
    for doc in docs:
        lines: list[str] = []
        if isinstance(doc, (dict, list)) and doc:
            _emit(doc, 0, lines)
        else:
            lines.append(_inline(doc))
        parts.append("\n".join(lines) + "\n")
    return "---\n".join(parts)
