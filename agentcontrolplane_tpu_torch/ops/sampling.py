"""Token sampling: greedy / temperature / top-k / top-p, batched per slot,
and the JSON-constraint masks around it.

Mirrors ``agentcontrolplane_tpu/ops/sampling.py``: temperature 0 means
greedy, all math is float32, and both masks come from a 32-step bisection
of a threshold instead of sorting the vocabulary. The bisections are the
reference's step for step, so the top-k and top-p masks match it exactly;
only the random draw differs (a ``torch.Generator`` instead of
``jax.random``), so temperature samples agree in distribution, not bits.

``constrain_logits`` / ``advance_constraint`` are the reference's functions
of the same names (``agentcontrolplane_tpu/engine/engine.py``), applied
before and after :func:`sample` for lanes under a JSON constraint
(``engine/constrain.py``). The reference pads the token table to the
model's vocabulary with -1; here it keeps the tokenizer's width T and every
logit at or past T is forbidden for a constrained lane, which gives the same
masks.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
_BISECT_ITERS = 32
# calls of constrain_logits; a batch with no constrained lane makes none
CONSTRAIN_CALLS = 0


def _topk_threshold(logits: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-row value t such that count(logits >= t) >= k and masking
    logits < t keeps the k largest (plus boundary ties). k >= V keeps all.
    [S, V], [S] -> [S, 1]."""
    lo = logits.amin(dim=-1)
    hi = logits.amax(dim=-1)
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        count = (logits >= mid[:, None]).sum(dim=-1)
        ok = count >= k  # mid keeps enough -> can raise the floor
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return lo[:, None]


def _topp_threshold(
    logits: torch.Tensor, top_p: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (prob threshold t [S, 1], probs [S, V]): keeping probs >= t
    keeps exactly the nucleus — every token whose strictly-greater-prob
    mass is < top_p.

    top_p >= 1 keeps every token above max_p * 2^-32, which is what the
    reference documents for that case. The reference reaches it by the
    f32 sum of the probabilities staying below 1.0; where that sum rounds
    up to 1.0 it also drops some tail tokens, and on which ones depends on
    the summation order, which no two frameworks share. Here the rows with
    top_p >= 1 always take the documented path."""
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    lo = torch.zeros(probs.shape[0], device=probs.device)
    hi = probs.amax(dim=-1)
    keep_all = top_p >= 1.0
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        mass_above = torch.where(probs > mid[:, None], probs, 0.0).sum(dim=-1)
        ok = (mass_above < top_p) | keep_all  # mid admits the nucleus -> go lower
        lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
    return hi[:, None], probs


def sample(
    logits: torch.Tensor,  # [S, V]
    generator: torch.Generator,
    temperature: torch.Tensor,  # [S]
    top_k: torch.Tensor,  # [S] int, 0 = disabled
    top_p: torch.Tensor,  # [S] float32, 1.0 = disabled
) -> torch.Tensor:
    """Returns sampled token ids [S] (int64). Temperature rows draw by the
    Gumbel-max trick from ``generator`` — the same method as the
    reference's ``jax.random.categorical``."""
    logits = logits.float()
    S, V = logits.shape
    k = torch.where(top_k > 0, top_k, V)
    kth = _topk_threshold(logits, k)
    logits = torch.where(logits < kth, NEG_INF, logits)
    p_thresh, probs = _topp_threshold(logits, top_p)
    logits = torch.where(probs < p_thresh, NEG_INF, logits)

    greedy = logits.argmax(dim=-1)
    temp = torch.clamp_min(temperature, 1e-6)[:, None]
    u = torch.rand((S, V), generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    sampled = (logits / temp + gumbel).argmax(dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled)


def speculative_accept(
    logits: torch.Tensor,  # [S, T, V] — logits[s, i] scores the token AFTER inputs[s, i]
    inputs: torch.Tensor,  # [S, T] — column 0 is the last sampled token, the rest the draft
    n_input: torch.Tensor,  # [S] — valid prefix of ``inputs`` (1 + draft length)
    active: torch.Tensor,  # [S] bool — inactive lanes emit nothing
    generator: torch.Generator,
    temperature: torch.Tensor,  # [S]
    top_k: torch.Tensor,  # [S]
    top_p: torch.Tensor,  # [S]
    stop_tokens: torch.Tensor,  # [n] — emission halts AFTER a stop token
    budgets: torch.Tensor,  # [S] sampled tokens left, this dispatch's included
    force_reject: bool = False,  # treat every draft token as mismatched
    constrain_fn=None,  # (logits [S, V], con_state [S], budget [S]) -> logits
    advance_fn=None,  # (con_state [S], toks [S], take [S] bool) -> con_state
    con_states: Optional[torch.Tensor] = None,  # [S]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The accept step of one speculative verify dispatch, the reference's
    function of the same name: walks the T scored positions of each lane,
    samples each from the VERIFIED logits with :func:`sample` (greedy =
    argmax, so greedy emission is the engine's choice without speculation)
    and goes on to the next position only while the sampled token equals
    the drafted one; the first mismatch emits the corrected token and
    stops, as does a stop token or a spent budget. The draft only decides
    how many positions land. Rollback is implicit: the caller advances
    ``seq_len`` by the emitted count and attention never reads the rejected
    tail's KV.

    Returns ``(out_tokens [S, T], n_emit [S], con_states [S])``:
    ``out_tokens[s, :n_emit[s]]`` are the committed tokens (-1 after them)
    and ``con_states`` advanced over exactly those tokens."""
    S, T, _V = logits.shape
    dev = logits.device
    if con_states is None:
        con_states = torch.zeros(S, dtype=torch.int32, device=dev)
    # the draft candidate for position i is the NEXT input token
    cand = torch.cat([inputs[:, 1:], torch.zeros_like(inputs[:, :1])], dim=1)
    has_draft = (torch.arange(T, device=dev)[None, :] + 1) < n_input[:, None]  # [S, T]
    emitting, state, budget = active, con_states, budgets
    outs = []
    for i in range(T):
        lg = logits[:, i]
        if constrain_fn is not None:
            lg = constrain_fn(lg, state, budget)
        tok = sample(lg, generator, temperature, top_k, top_p)
        outs.append(torch.where(emitting, tok, -1))
        take = emitting
        budget = budget - take.to(budget.dtype)
        if advance_fn is not None:
            state = advance_fn(state, tok, take)
        match = has_draft[:, i] & (tok == cand[:, i]) & (not force_reject)
        emitting = take & match & ~torch.isin(tok, stop_tokens) & (budget > 0)
    out = torch.stack(outs, dim=1)
    return out, (out >= 0).sum(dim=1).to(torch.int32), state


def constrain_logits(
    logits: torch.Tensor,  # [S, V]
    table: torch.Tensor,  # [n_states, T] int16: next state, or -1 (forbidden)
    con_state: torch.Tensor,  # [S] automaton state per lane
    constrained: torch.Tensor,  # [S] bool
    min_close: torch.Tensor,  # [n_states] bytes from each state to DONE
    budget: torch.Tensor,  # [S] sampled tokens left, this one included
) -> torch.Tensor:
    """float32 logits with every grammar-illegal token of a constrained
    lane at -1e30. Tokens are further restricted to those whose next state
    can still close the JSON within ``budget - 1``, so a constrained
    generation completes inside its max_tokens; where no legal token can,
    plain legality is kept rather than masking everything. A state index
    outside the table is clipped into it, as the reference does."""
    global CONSTRAIN_CALLS
    CONSTRAIN_CALLS += 1
    logits = logits.float()
    n_states, T = table.shape
    T = min(T, logits.shape[-1])
    nxt = table[con_state.long().clamp(0, n_states - 1), :T]  # [S, T]
    allowed = nxt >= 0
    closable = min_close[nxt.long().clamp(0, min_close.shape[0] - 1)] <= (budget[:, None] - 1)
    budget_allowed = allowed & closable
    feasible = budget_allowed.any(dim=-1, keepdim=True)
    allowed = torch.where(feasible, budget_allowed, allowed)
    lanes = constrained[:, None]
    head = torch.where(lanes & ~allowed, NEG_INF, logits[:, :T])
    tail = torch.where(lanes, NEG_INF, logits[:, T:])  # past the table: -1 there
    return torch.cat([head, tail], dim=-1)


def advance_constraint(
    table: torch.Tensor,  # [n_states, T] int16
    con_state: torch.Tensor,  # [S]
    constrained: torch.Tensor,  # [S] bool
    toks: torch.Tensor,  # [S] sampled ids
) -> torch.Tensor:
    """Each constrained lane's state after its sampled token (-1 for a token
    the grammar forbids, or one past the table); other lanes keep theirs."""
    n_states, T = table.shape
    nxt = table[con_state.long().clamp(0, n_states - 1), toks.long().clamp(0, T - 1)]
    nxt = torch.where(toks < T, nxt.to(con_state.dtype), -1)
    return torch.where(constrained, nxt, con_state)
