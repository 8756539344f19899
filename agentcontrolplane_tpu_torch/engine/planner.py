"""Admission-time chunk-rate planning and the scheduler autopilot, the
port's copy of ``agentcontrolplane_tpu/engine/planner.py`` (pure Python;
the functions and classes are the reference's, line for line).

The token-budget scheduler alone is per-cycle greedy: earliest-deadline
order decides WHICH mid-prefill slot advances first, but every slot
advances at most one chunk per cycle, so whether a deadline is met depends
on how many competitors share the cycle. This module closes the loop:

- :func:`project_quota` is the rate plan. At admission (and at every
  reprojection event: preempt -> resume, park -> adopt) the engine turns a
  request's deadline into a per-cycle chunk quota::

      chunks_left  = ceil(tokens_remaining / chunk)
      cycles_left  = max(1, floor(seconds_to_deadline / cycle_ewma) - slack)
      quota        = ceil(chunks_left / cycles_left)

  The scheduler then sizes that slot's per-cycle chunk as ``quota x
  chunk``, capped at the largest prefill bucket (which keeps chunk
  boundaries page-aligned). Slots without a deadline keep quota 1, the
  flat one-chunk cadence, so the planner is inert for deadline-free
  traffic. Deadlines are the leader's wall clock, so under a serving group
  every quota stays 1, the same rule as deadline ordering and expiry.

- :class:`CycleClock` is the cycle-time estimate behind ``cycles_left``:
  an EWMA over busy dispatch-cycle wall times (the first observation
  seeds it, outliers such as a cold first cycle decay).

- :func:`recommend` / :class:`Autopilot` turn phase-time summaries into a
  controller: every ``interval`` cycles the autopilot reads queue_wait /
  prefill / preempt_stall attribution, budget utilization and speculative
  acceptance, and nudges ``prefill_chunk`` / ``token_budget`` /
  ``spec_len`` one bounded step. A pure function and a thin applier, so the
  policy is testable without an engine. The port's engine does not run it
  yet: it needs the flight recorder's phase summaries (ROADMAP A.11).

Neither the quota plan nor the autopilot changes WHAT a request samples:
both only reshape when prompt KV is written and how large dispatches are,
the guarantee chunked prefill itself makes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


def project_quota(
    tokens_left: int,
    chunk: int,
    seconds_left: Optional[float],
    cycle_s: float,
    max_quota: int = 8,
    slack_cycles: int = 2,
) -> int:
    """Per-cycle chunk quota for one mid-prefill slot (>= 1).

    ``seconds_left`` None (no deadline) or non-positive (already past —
    expiry owns that) keeps the flat cadence of one chunk per cycle.
    ``slack_cycles`` reserves headroom so the plan lands the final chunk
    (and the first sampled token) before the wire goes taut."""
    if seconds_left is None or seconds_left <= 0 or tokens_left <= 0 or chunk <= 0:
        return 1
    chunks_left = -(-tokens_left // chunk)
    cycles_left = max(1, int(seconds_left / max(cycle_s, 1e-6)) - slack_cycles)
    quota = -(-chunks_left // cycles_left)
    return max(1, min(int(quota), max_quota))


class CycleClock:
    """EWMA of busy dispatch-cycle wall time (seconds). The first sample
    seeds the estimate; later samples decay in with ``alpha`` so one
    serving-time compile stall doesn't wreck every projection after it."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.cycle_s = 0.0

    def observe(self, dt: float) -> None:
        if dt <= 0:
            return
        if self.cycle_s == 0.0:
            self.cycle_s = dt
        else:
            self.cycle_s += self.alpha * (dt - self.cycle_s)


# -- autopilot ---------------------------------------------------------------


@dataclass(frozen=True)
class AutopilotLimits:
    """Bounds the autopilot may steer within (never beyond what the
    operator configured as safe): chunk moves along the compiled prefill
    buckets, budget within [0, budget_max] (0 = auto-sized), spec draft
    length within [0, spec_len_max]."""

    chunk_min: int
    chunk_max: int
    budget_max: int
    spec_len_max: int


def recommend(
    phases: dict,
    utilization_avg: float,
    spec_acceptance: Optional[float],
    knobs: dict,
    limits: AutopilotLimits,
) -> dict:
    """One bounded adjustment step from observed attribution.

    ``phases`` maps phase name -> p99 seconds (windowed phase-time
    summaries); ``knobs`` holds the current {prefill_chunk, token_budget, spec_len}. Returns only the
    knobs that should CHANGE (empty dict = hold). Heuristics, each one
    step per tick so the controller hunts instead of oscillating:

    - prefill p99 dominating queue_wait with the token budget saturated
      (utilization ~1.0): prefill is throttled by the scheduler, not by
      arrivals — raise ``token_budget`` 25% (auto-sized budgets move to
      explicit first).
    - queue_wait p99 dominating prefill: admission is the bottleneck —
      prompts sit queued while chunks trickle; double ``prefill_chunk``
      toward the largest bucket so each admitted prompt clears sooner.
    - preempt_stall p99 comparable to decode: thrash — smaller chunks
      lose less per preemption; halve ``prefill_chunk`` toward the floor.
    - speculative acceptance < 0.3 with drafts flowing: drafts mostly
      rejected — shrink ``spec_len``; acceptance > 0.7: drafts paying —
      grow it toward the cap.
    """
    out: dict = {}
    q99 = phases.get("queue_wait", 0.0)
    p99 = phases.get("prefill", 0.0)
    s99 = phases.get("preempt_stall", 0.0)
    d99 = phases.get("decode", 0.0)
    chunk = int(knobs.get("prefill_chunk", 0))
    budget = int(knobs.get("token_budget", 0))
    spec_len = int(knobs.get("spec_len", 0))
    if chunk > 0:
        if p99 > 2.0 * max(q99, 1e-9) and utilization_avg >= 0.95:
            base = budget if budget else max(chunk * 2, 64)
            new = min(int(base * 1.25) + 1, limits.budget_max)
            if new != budget:
                out["token_budget"] = new
        elif q99 > 2.0 * max(p99, 1e-9) and chunk < limits.chunk_max:
            out["prefill_chunk"] = min(chunk * 2, limits.chunk_max)
        elif s99 > 0.5 * max(d99, 1e-9) and s99 > 0 and chunk > limits.chunk_min:
            out["prefill_chunk"] = max(chunk // 2, limits.chunk_min)
    if spec_len > 0 and spec_acceptance is not None:
        if spec_acceptance < 0.3 and spec_len > 1:
            out["spec_len"] = spec_len - 1
        elif spec_acceptance > 0.7 and spec_len < limits.spec_len_max:
            out["spec_len"] = spec_len + 1
    return out


class Autopilot:
    """Thin stateful applier around :func:`recommend`: counts engine
    cycles, and every ``interval`` busy cycles produces the next bounded
    adjustment. The ENGINE applies the returned knob changes (and
    records them) — the autopilot itself never touches engine
    state, so it stays trivially unit-testable."""

    def __init__(self, limits: AutopilotLimits, interval: int = 128):
        self.limits = limits
        self.interval = max(1, int(interval))
        self.cycles = 0
        self.adjustments = 0

    def due(self) -> bool:
        """Count one engine cycle; True on interval boundaries. Split from
        :meth:`step` so the engine only gathers the (histogram-summary)
        inputs on the cycles that will actually use them."""
        self.cycles += 1
        return self.cycles % self.interval == 0

    def step(
        self,
        phases: dict,
        utilization_avg: float,
        spec_acceptance: Optional[float],
        knobs: dict,
    ) -> dict:
        """One adjustment step (call when :meth:`due`); returns the knob
        changes to apply (usually empty)."""
        changes = recommend(
            phases, utilization_avg, spec_acceptance, knobs, self.limits
        )
        if changes:
            self.adjustments += 1
        return changes


__all__ = [
    "Autopilot",
    "AutopilotLimits",
    "CycleClock",
    "project_quota",
    "recommend",
]
