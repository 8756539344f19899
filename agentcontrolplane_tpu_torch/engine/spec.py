"""Model-free speculative decoding: the n-gram prompt-lookup drafter and
the per-slot adaptive draft-length controller. The port's copy of
``agentcontrolplane_tpu/engine/spec.py`` (pure numpy; the functions and the
class are the reference's, line for line).

Agent traffic is self-repetitive: tool-call JSON echoes schema keys from
the prompt, ReAct loops restate tool outputs, and code edits copy spans
verbatim. The drafter matches the tail of ``prompt + generated`` against
an earlier occurrence of the same n-gram and proposes the tokens that
followed it, with no draft model. Drafts are free to be wrong: the
engine's verify pass (``models/llama.py::verify_paged_continue`` +
``ops/sampling.py::speculative_accept``) scores every proposed position in
one dispatch and only the prefix the model agrees with advances the
sequence, so greedy outputs stay byte-identical to the engine without
speculation.

Everything here is host-only state: a preempted slot saves nothing extra
(the controller is rebuilt at re-admission), and a crash rebuild starts
fresh.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# verify dispatches a slot spends at draft length 0 before probing again
# with a 1-token draft; without it a slot that decayed to 0 (its text
# stopped being self-similar) could never rejoin speculation
REPROBE_DISPATCHES = 16

# candidate match positions examined per n-gram length: drafting runs for
# every slot on every verify dispatch, and a common trailing byte (space,
# quote) can occur thousands of times in a long context. The most recent
# matches are the likeliest continuations (agent loops restate their
# latest tool output), so capping the walk loses only distant repeats; the
# rest of the per-n cost is the vectorized first-token scan
MAX_HEADS_PER_N = 64


def ngram_propose(ctx: np.ndarray, ngram_max: int, max_len: int) -> list[int]:
    """Prompt-lookup draft: match the trailing n-gram of ``ctx`` (n from
    ``ngram_max`` down to 1, longest first) against an earlier occurrence
    and propose up to ``max_len`` of the tokens that followed it.

    A match whose continuation fills ``max_len`` wins at once, scanning the
    most recent first; otherwise the longest continuation wins, with larger
    n and recency as tie-breaks. Length first matters in a repetition loop:
    the most recent match sits near the context edge with a token or two of
    continuation, while one period earlier the same match yields a full
    draft. Returns [] when nothing matches (the slot rides the dispatch
    with an empty draft, or the engine runs the plain decode block)."""
    n_ctx = int(ctx.shape[0])
    if n_ctx < 2 or max_len <= 0:
        return []
    best: list[int] = []
    for n in range(min(ngram_max, n_ctx - 1), 0, -1):
        pat = ctx[n_ctx - n :]
        # candidate windows start strictly before the tail's own window;
        # overlap WITH the tail window is allowed (period < n repetition)
        heads = np.flatnonzero(ctx[: n_ctx - n] == pat[0])
        for i in heads[-MAX_HEADS_PER_N:][::-1]:  # most recent first
            if not np.array_equal(ctx[i : i + n], pat):
                continue
            draft = ctx[i + n : i + n + max_len]
            if draft.size >= max_len:
                return [int(t) for t in draft]
            if draft.size > len(best):  # strict: larger n / recency keep ties
                best = [int(t) for t in draft]
    return best


@dataclass
class SpecState:
    """Per-slot adaptive draft length: full rejection halves the cap (8 ->
    4 -> 2 -> 1 -> 0, down to the path without speculation, never below
    it), partial acceptance adds one, full acceptance doubles it back
    toward the engine's cap. A slot at 0 re-probes with a 1-token draft
    every :data:`REPROBE_DISPATCHES` dispatches."""

    limit: int  # the engine's spec_len
    cur: int = -1  # current cap; -1 = start optimistic at limit
    idle: int = 0  # dispatches spent at cur == 0 (the re-probe timer)

    def __post_init__(self) -> None:
        if self.cur < 0:
            self.cur = self.limit

    def cap(self) -> int:
        """Draft-length cap for the next dispatch (ticks the re-probe timer
        while at 0)."""
        if self.cur == 0:
            self.idle += 1
            if self.idle >= REPROBE_DISPATCHES:
                self.cur, self.idle = 1, 0
        return self.cur

    def observe(self, proposed: int, accepted: int) -> None:
        """Feed back one verify dispatch's outcome for this slot."""
        if proposed <= 0:
            return  # no draft rode this dispatch: nothing was learned
        if accepted == 0:
            self.cur //= 2
        elif accepted >= proposed:
            self.cur = min(self.limit, max(1, self.cur * 2))
        else:
            self.cur = min(self.limit, self.cur + 1)
