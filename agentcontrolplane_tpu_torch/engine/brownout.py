"""Degradation ladder: shed optional features under sustained pressure (the
port's copy of the reference's ``engine/brownout.py``).

When the engine is genuinely overloaded — admission sheds landing, the
dispatch watchdog recording stalls — the right move is not to degrade
correctness but to *turn off the optional work* in a pinned order, one
bounded step per interval, and to restore everything the moment pressure
lifts. This mirrors the autopilot's apply-seam exactly: a pure-ish
controller decides, the ENGINE applies the knob change and flight-records
it, and every level move publishes ``acp_engine_brownout_level``.

The ladder (each rung sheds strictly-optional capacity, never output
bytes — every knob it touches carries a byte-identity contract):

1. ``spec_len`` → 0      — speculative decoding off: verify dispatches are
   extra compute the moment acceptance pays for itself and pure waste the
   moment the engine is starved.
2. ``park_max_s`` → 0    — park acceptance off: parked slots are
   speculative capacity held against a FUTURE turn; under pressure the
   present turn needs the pages more. (Submissions already parked keep
   their contract; only NEW parks stop.)
3. ``planner_max_quota`` → 1 — chunk quota floor: deadline-driven
   multi-chunk bursts yield to fair one-chunk-per-cycle progress.

Pressure is counter deltas, not wall clock: ``step`` consumes the
cumulative shed and stall counters and judges the delta since the last
tick. Like the autopilot, the controller is interval-gated on busy engine
cycles and moves at most ONE rung per tick in either direction, with
separate down/up streak requirements so a single calm interval doesn't
whipsaw a loaded engine back into speculative work.

Off by default (``Engine(brownout=False)``); forced off under a serving
group (shed and stall counts are the leader's own, and knobs that differ
between ranks would fork their lockstep admission, the same rule as the
autopilot).
"""

from __future__ import annotations

from dataclasses import dataclass

# the pinned ladder order: (knob, browned-out value)
LADDER: tuple[tuple[str, object], ...] = (
    ("spec_len", 0),
    ("park_max_s", 0.0),
    ("planner_max_quota", 1),
)


@dataclass(frozen=True)
class BrownoutPolicy:
    """Pressure thresholds and hysteresis for the ladder controller."""

    interval: int = 64          # busy cycles between controller decisions
    shed_threshold: int = 1     # sheds-per-interval that count as pressure
    stall_threshold: int = 1    # stalls-per-interval that count as pressure
    down_after: int = 1         # consecutive pressured ticks -> step down
    up_after: int = 2           # consecutive calm ticks -> step up


class BrownoutController:
    """Thin stateful judge around the pressure deltas: counts engine
    cycles, and every ``interval`` busy cycles emits the target level
    (0 = full service, ``len(LADDER)`` = fully browned out). The ENGINE
    applies the rung (saving/restoring knob values) and flight-records
    it — the controller never touches engine state, so the policy is
    unit-testable without an engine."""

    def __init__(self, policy: BrownoutPolicy | None = None):
        self.policy = policy or BrownoutPolicy()
        self.level = 0
        self.cycles = 0
        self.steps_down = 0
        self.steps_up = 0
        self._last_sheds = 0
        self._last_stalls = 0
        self._pressure_streak = 0
        self._calm_streak = 0

    def due(self) -> bool:
        """Count one busy engine cycle; True on interval boundaries
        (split from :meth:`step` like Autopilot.due, so the engine only
        gathers inputs on ticks that will use them)."""
        self.cycles += 1
        return self.cycles % self.policy.interval == 0

    def step(self, sheds: int, stalls: int) -> int:
        """One controller decision from the CUMULATIVE shed/stall
        counters; returns the new target level (moves at most one rung)."""
        p = self.policy
        d_sheds = max(0, sheds - self._last_sheds)
        d_stalls = max(0, stalls - self._last_stalls)
        self._last_sheds = sheds
        self._last_stalls = stalls
        pressured = d_sheds >= p.shed_threshold or d_stalls >= p.stall_threshold
        if pressured:
            self._pressure_streak += 1
            self._calm_streak = 0
            if self._pressure_streak >= p.down_after and self.level < len(LADDER):
                self.level += 1
                self.steps_down += 1
                self._pressure_streak = 0
        else:
            self._calm_streak += 1
            self._pressure_streak = 0
            if self._calm_streak >= p.up_after and self.level > 0:
                self.level -= 1
                self.steps_up += 1
                self._calm_streak = 0
        return self.level


__all__ = ["LADDER", "BrownoutController", "BrownoutPolicy"]
