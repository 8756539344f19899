"""Constrained decoding: structural-JSON grammar masking — the port's own
copy of the reference's ``agentcontrolplane_tpu/engine/constrain.py``
(numpy only; the port imports nothing of the JAX package).

A per-token logit mask driven by a JSON pushdown automaton (nesting capped
so the state space is finite) makes a constrained generation a
structurally valid JSON object — balanced containers, terminated/escaped
strings, legal value starts — ending exactly when the top-level object
closes (then only stop tokens are allowed).

The automaton is byte-level; ``TokenTable`` lifts it to any tokenizer by
simulating each vocab entry's bytes, yielding dense arrays the engine uses
ON DEVICE around the sampler (``ops/sampling.py``):

    allowed = token_trans[state] >= 0        # [V] mask for the next token
    state'  = token_trans[state, token]      # after sampling

Literals are matched exactly (``true``/``false``/``null``) and numbers
follow the full JSON number grammar (sign, no leading zeros, fraction,
exponent), so a constrained generation that reaches DONE always
``json.loads`` cleanly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

# modes (compound modes are tuples: (IN_NUMBER, sub) / (IN_LITERAL, rest))
START = 0  # expect '{' (or whitespace)
EXPECT_KEY = 1  # inside object: '"' or '}'
IN_KEY = 2
IN_KEY_ESC = 3
AFTER_KEY = 4  # expect ':'
EXPECT_VALUE = 5  # after ':' / '[' / ',' in array
IN_STRING = 6
IN_STRING_ESC = 7
AFTER_VALUE = 8  # expect ',' or closer
IN_NUMBER = 9  # (IN_NUMBER, sub): full JSON number DFA
IN_LITERAL = 10  # (IN_LITERAL, rest): exact true/false/null suffix
DONE = 11
EXPECT_KEY_REQ = 12  # after ',' in object: '"' only (no trailing comma)
EXPECT_VALUE_REQ = 13  # after ',' in array: value only (no trailing comma)
IN_KEY_U = 14  # (IN_KEY_U, n): n hex digits of \uXXXX left in a key
IN_STRING_U = 15  # (IN_STRING_U, n): same, in a value string

_WS = b" \t\n\r"
_DIGITS = b"0123456789"
_ESCAPABLE = b'"\\/bfnrt'  # the only legal single-char escapes
_HEX = b"0123456789abcdefABCDEF"
# EXPECT_VALUE byte -> remaining literal suffix
_LITERALS = {b"t": b"rue", b"f": b"alse", b"n": b"ull"}

OBJ, ARR = 0, 1


class JsonByteAutomaton:
    """Finite automaton over bytes: state = (mode, container stack).
    States are discovered lazily and interned to dense ids."""

    def __init__(self, max_depth: int = 8):
        self.max_depth = max_depth
        self._ids: dict[tuple, int] = {}
        self._states: list[tuple] = []
        self._trans: list[np.ndarray] = []  # per state: [256] int32 next-id or -1
        self.start = self._intern((START, ()))
        self._build()

    def _intern(self, state: tuple) -> int:
        if state not in self._ids:
            self._ids[state] = len(self._states)
            self._states.append(state)
            self._trans.append(None)  # filled by _build
        return self._ids[state]

    def _step(self, state: tuple, byte: int) -> Optional[tuple]:
        mode, stack = state
        ch = bytes([byte])

        def close_container():
            new_stack = stack[:-1]
            if not new_stack:
                return (DONE, ())
            return (AFTER_VALUE, new_stack)

        if mode == START:
            # no leading whitespace: the first sampled token must open the
            # object (whitespace here only burns the token budget)
            if ch == b"{":
                return (EXPECT_KEY, (OBJ,))
            return None
        if mode in (EXPECT_KEY, EXPECT_KEY_REQ):
            if ch in _WS:
                return state
            if ch == b'"':
                return (IN_KEY, stack)
            # '}' only legal for an EMPTY object — after a comma it would be
            # a trailing comma, which json.loads rejects
            if ch == b"}" and mode == EXPECT_KEY and stack and stack[-1] == OBJ:
                return close_container()
            return None
        if mode == IN_KEY:
            if ch == b'"':
                return (AFTER_KEY, stack)
            if ch == b"\\":
                return (IN_KEY_ESC, stack)
            if byte < 0x20:
                return None
            return state
        if mode == IN_KEY_ESC:
            if ch in _ESCAPABLE:
                return (IN_KEY, stack)
            if ch == b"u":
                return ((IN_KEY_U, 4), stack)
            return None
        if isinstance(mode, tuple) and mode[0] == IN_KEY_U:
            if ch in _HEX:
                n = mode[1] - 1
                return (IN_KEY, stack) if n == 0 else ((IN_KEY_U, n), stack)
            return None
        if mode == AFTER_KEY:
            if ch in _WS:
                return state
            if ch == b":":
                return (EXPECT_VALUE, stack)
            return None
        if mode in (EXPECT_VALUE, EXPECT_VALUE_REQ):
            if ch in _WS:
                return state
            if ch == b'"':
                return (IN_STRING, stack)
            if ch == b"{":
                if len(stack) >= self.max_depth:
                    return None
                return (EXPECT_KEY, stack + (OBJ,))
            if ch == b"[":
                if len(stack) >= self.max_depth:
                    return None
                return (EXPECT_VALUE, stack + (ARR,))
            # ']' closes only an EMPTY array (not after a comma)
            if ch == b"]" and mode == EXPECT_VALUE and stack and stack[-1] == ARR:
                return close_container()
            if ch == b"-":
                return ((IN_NUMBER, "minus"), stack)
            if ch == b"0":
                return ((IN_NUMBER, "zero"), stack)
            if ch in b"123456789":
                return ((IN_NUMBER, "int"), stack)
            if ch in _LITERALS:
                return ((IN_LITERAL, _LITERALS[ch]), stack)
            return None
        if mode == IN_STRING:
            if ch == b'"':
                return (AFTER_VALUE, stack)
            if ch == b"\\":
                return (IN_STRING_ESC, stack)
            if byte < 0x20:
                return None
            return state
        if mode == IN_STRING_ESC:
            if ch in _ESCAPABLE:
                return (IN_STRING, stack)
            if ch == b"u":
                return ((IN_STRING_U, 4), stack)
            return None
        if isinstance(mode, tuple) and mode[0] == IN_STRING_U:
            if ch in _HEX:
                n = mode[1] - 1
                return (IN_STRING, stack) if n == 0 else ((IN_STRING_U, n), stack)
            return None
        def after_value(ch):
            """',' / closer / whitespace handling shared by AFTER_VALUE and
            complete-number termination."""
            if ch in _WS:
                return (AFTER_VALUE, stack)
            if ch == b",":
                if stack and stack[-1] == OBJ:
                    return (EXPECT_KEY_REQ, stack)
                if stack and stack[-1] == ARR:
                    return (EXPECT_VALUE_REQ, stack)
                return None
            if ch == b"}" and stack and stack[-1] == OBJ:
                return close_container()
            if ch == b"]" and stack and stack[-1] == ARR:
                return close_container()
            return None

        if mode == AFTER_VALUE:
            return after_value(ch)
        if isinstance(mode, tuple) and mode[0] == IN_LITERAL:
            rest = mode[1]
            if ch == rest[:1]:
                rest = rest[1:]
                return ((IN_LITERAL, rest), stack) if rest else (AFTER_VALUE, stack)
            return None
        if isinstance(mode, tuple) and mode[0] == IN_NUMBER:
            sub = mode[1]
            if sub == "minus":  # need first digit
                if ch == b"0":
                    return ((IN_NUMBER, "zero"), stack)
                if ch in b"123456789":
                    return ((IN_NUMBER, "int"), stack)
                return None
            if sub == "frac_dot":  # '.' needs at least one digit
                return ((IN_NUMBER, "frac"), stack) if ch in _DIGITS else None
            if sub == "exp_e":  # e/E needs sign or digit
                if ch in b"+-":
                    return ((IN_NUMBER, "exp_sign"), stack)
                return ((IN_NUMBER, "exp"), stack) if ch in _DIGITS else None
            if sub == "exp_sign":
                return ((IN_NUMBER, "exp"), stack) if ch in _DIGITS else None
            # complete-number states: may extend or terminate
            if sub == "int" and ch in _DIGITS:
                return state
            if sub in ("zero", "int") and ch == b".":
                return ((IN_NUMBER, "frac_dot"), stack)
            if sub == "frac" and ch in _DIGITS:
                return state
            if sub == "exp" and ch in _DIGITS:
                return state
            if sub in ("zero", "int", "frac", "exp") and ch in b"eE":
                if sub != "exp":
                    return ((IN_NUMBER, "exp_e"), stack)
                return None
            if sub in ("zero", "int", "frac", "exp"):
                return after_value(ch)
            return None
        if mode == DONE:
            if ch in _WS:
                return state
            return None
        return None

    def _build(self) -> None:
        frontier = [0]
        while frontier:
            sid = frontier.pop()
            if self._trans[sid] is not None:
                continue
            row = np.full(256, -1, dtype=np.int32)
            state = self._states[sid]
            for byte in range(256):
                nxt = self._step(state, byte)
                if nxt is not None:
                    nid = self._intern(nxt)
                    row[byte] = nid
                    if nid >= len(self._trans) or self._trans[nid] is None:
                        while len(self._trans) < len(self._states):
                            self._trans.append(None)
                        frontier.append(nid)
            self._trans[sid] = row

    @property
    def n_states(self) -> int:
        return len(self._states)

    def is_done(self, sid: int) -> bool:
        return self._states[sid][0] == DONE

    def min_close_distances(self) -> np.ndarray:
        """[n_states] — minimum BYTES from each state to a DONE state
        (reverse BFS over the byte graph). Drives budget-aware masking: with
        k tokens left, only tokens whose next state can still close within
        k-1 are allowed, so a constrained generation ALWAYS completes inside
        its max_tokens (every closing byte is a single-byte token in
        practice: quotes, digits, braces)."""
        n = self.n_states
        rev: list[list[int]] = [[] for _ in range(n)]
        for s in range(n):
            for t in set(int(x) for x in self._trans[s] if x >= 0):
                rev[t].append(s)
        INF = np.int32(2**15 - 1)
        dist = np.full(n, INF, dtype=np.int32)
        frontier = [s for s in range(n) if self.is_done(s)]
        for s in frontier:
            dist[s] = 0
        while frontier:
            nxt_frontier = []
            for t in frontier:
                for s in rev[t]:
                    if dist[s] > dist[t] + 1:
                        dist[s] = dist[t] + 1
                        nxt_frontier.append(s)
            frontier = nxt_frontier
        return dist

    def run_bytes(self, sid: int, data: bytes) -> int:
        """-1 if the byte run is illegal from sid."""
        for b in data:
            if sid < 0:
                return -1
            sid = int(self._trans[sid][b])
        return sid


@dataclass
class TokenTable:
    """token_trans[state, token] = next state, or -1 (forbidden).
    DONE states allow only stop tokens (mapped to staying DONE)."""

    token_trans: np.ndarray  # [n_states, vocab] int32
    start_state: int
    # [n_states] min bytes to a DONE state (see min_close_distances)
    min_close: np.ndarray = None  # type: ignore[assignment]

    @property
    def n_states(self) -> int:
        return self.token_trans.shape[0]


def build_token_table(
    tokenizer,
    max_depth: int = 8,
) -> TokenTable:
    """Lift the byte automaton to the tokenizer's vocab by composing per-byte
    transition columns (vectorized over the state axis). Requires
    ``token_bytes(id) -> bytes | None`` (None = control/special token).
    int16 (the state count is small): the engine keeps it at this width on
    the device, with no padding to the model's vocabulary."""
    auto = JsonByteAutomaton(max_depth=max_depth)
    vocab = tokenizer.vocab_size
    stop = tokenizer.stop_tokens
    byte_trans = np.stack(auto._trans)  # [n_states, 256] int32
    n_states = auto.n_states
    assert n_states < 2**15
    done_mask = np.asarray([auto.is_done(s) for s in range(n_states)])

    table = np.full((n_states, vocab), -1, dtype=np.int16)
    ids = np.arange(n_states, dtype=np.int32)
    for tok in range(vocab):
        if tok in stop:
            # finishing is the only legal move, available exactly at DONE
            table[done_mask, tok] = ids[done_mask].astype(np.int16)
            continue
        data = tokenizer.token_bytes(tok)
        if not data:
            continue
        v = ids
        for b in data:
            v = np.where(v >= 0, byte_trans[np.clip(v, 0, None), b], -1)
        # DONE states admit no non-stop tokens (force immediate stop)
        v = np.where(done_mask, -1, v)
        table[:, tok] = v.astype(np.int16)
    return TokenTable(
        token_trans=table,
        start_state=auto.start,
        min_close=auto.min_close_distances().astype(np.int16),
    )
