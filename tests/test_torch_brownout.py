"""The stall watchdog and the brownout ladder on the CPU: the port's
``engine/brownout.py`` and its engine's control loops against the JAX
package's, replaying ``tests/engine/test_brownout.py``.

- The ladder controller's four cases run the same calls on both classes.
- The watchdog's and the ladder's arithmetic on the engines is gated with
  synthetic inputs, not wall clocks (the reference's end-to-end stall case
  fails in loaded runs, ROADMAP C): the same cycle times fed to
  ``_stall_check`` give the same stalls, floors and events on both
  engines, and the same shed and stall counts fed to ``_brownout_tick``
  walk both down and back up the ladder with the same knobs, levels,
  events and ``stats()["brownout"]``.
- One end-to-end ``engine.slow_cycle`` case on the port, with a delay 10x
  ``stall_min_s`` (itself far above a busy cycle on the tiny preset):
  the watchdog records the stall and the ladder steps down.
- Under a serving group brownout and the autopilot are forced off.
"""

import time

import pytest

from agentcontrolplane_tpu.engine import brownout as ref_brownout
from agentcontrolplane_tpu_torch.engine import brownout as port_brownout
from agentcontrolplane_tpu_torch.engine.engine import Engine
from agentcontrolplane_tpu_torch.engine.weights import params_from_jax
from agentcontrolplane_tpu_torch.faults import FAULTS as PORT_FAULTS
from agentcontrolplane_tpu_torch.parallel.mesh import ServingGroup

from .test_torch_flight import TCFG, _weights, counter, port_engine, ref_engine, sampling

MODULES = [ref_brownout, port_brownout]


def _due(mod):
    bo = mod.BrownoutController(mod.BrownoutPolicy(interval=4))
    return [i for i in range(1, 13) if bo.due()]


def _steps_down(mod):
    bo = mod.BrownoutController()
    out = [bo.step(sheds=0, stalls=0), bo.step(sheds=0, stalls=3), bo.step(sheds=1, stalls=3),
           bo.step(sheds=2, stalls=4), bo.step(sheds=9, stalls=9)]
    return out + [bo.steps_down, bo.step(sheds=9, stalls=9), len(mod.LADDER)]


def _hysteresis(mod):
    bo = mod.BrownoutController(mod.BrownoutPolicy(down_after=2, up_after=2))
    bo.step(0, 0)
    out = [bo.step(0, 5), bo.step(0, 9), bo.step(0, 9), bo.step(0, 10), bo.step(0, 10),
           bo.step(0, 10)]
    return out + [bo.steps_up, bo.step(0, 10)]


def _down_after(mod):
    bo = mod.BrownoutController(mod.BrownoutPolicy(down_after=2, up_after=1))
    bo.step(0, 0)
    return [bo.step(0, 1), bo.step(0, 1), bo.step(0, 2), bo.step(0, 3)]


LADDER_CASES = {
    "due_gates_on_interval_boundaries": (_due, [4, 8, 12]),
    "pressure_steps_down_one_rung_per_tick": (_steps_down, [0, 1, 2, 3, 3, 3, 3, 3]),
    "restore_hysteresis_and_whipsaw_guard": (_hysteresis, [0, 1, 1, 1, 1, 0, 1, 0]),
    "down_after_streak_requirement": (_down_after, [0, 0, 0, 1]),
}


@pytest.mark.parametrize("name", list(LADDER_CASES))
def test_ladder_matches_the_reference(name):
    fn, want = LADDER_CASES[name]
    assert [fn(m) for m in MODULES] == [want, want]
    assert port_brownout.LADDER == ref_brownout.LADDER


@pytest.fixture(scope="module")
def pair():
    """Idle engines (never started): the control loops are driven by hand."""
    weights = _weights()
    kw = dict(brownout=True, brownout_interval=1, stall_mult=2.0, stall_min_s=0.02,
              spec_len=3, park_max_s=30.0, planner_max_quota=8)
    return (ref_engine(weights, **kw),
            port_engine(params_from_jax(weights, TCFG, device="cpu"), **kw))


def _events(eng, kind: str) -> list:
    return [e["detail"] for e in eng.flight.events(kind=kind, last=0)]


def test_stall_watchdog_arithmetic_matches_the_reference(pair):
    """The floor is the fastest busy cycle; a cycle is a stall when it is
    over stall_mult x the floor AND over stall_min_s."""
    cycles = [0.5, 0.01, 0.019, 0.03, 0.021, 0.005, 0.011, 0.2, 0.0]
    seen = []
    for eng in pair:
        s0 = eng.stalls
        c0 = counter(eng, "acp_engine_stalls_total")
        floors = []
        for dt in cycles:
            eng._stall_check(dt)
            floors.append(eng._cycle_floor)
        seen.append((eng.stalls - s0, floors, _events(eng, "stall")[-(eng.stalls - s0):],
                     counter(eng, "acp_engine_stalls_total") - c0, eng.stats()["stalls"]))
    assert seen[1] == seen[0]
    assert seen[1][0] == 3  # 0.03, 0.021 and 0.2; 0.5 came before any floor


def test_ladder_apply_seam_matches_the_reference(pair):
    """Synthetic pressure walks both engines down the ladder (spec_len,
    then park acceptance, then the chunk quota, each saved), and calm
    ticks walk them back up with every knob restored exactly."""
    seen = []
    for eng in pair:
        base = (eng.spec_len, eng.park_max_s, eng.planner_max_quota)
        log = []
        for _ in range(4):  # pressure: one rung a tick, clamped at 3
            eng.stalls += 1
            eng._brownout_tick()
            log.append((eng._brownout_level, eng.spec_len, eng.park_max_s,
                        eng.planner_max_quota))
        for _ in range(7):  # calm: a rung back every two ticks
            eng._brownout_tick()
            log.append((eng._brownout_level, eng.spec_len, eng.park_max_s,
                        eng.planner_max_quota))
        seen.append((log, _events(eng, "brownout"), eng.stats()["brownout"],
                     (eng.spec_len, eng.park_max_s, eng.planner_max_quota) == base))
    assert seen[1] == seen[0]
    log, events, st, restored = seen[1]
    assert [lv for lv, *_ in log] == [1, 2, 3, 3, 3, 2, 2, 1, 1, 0, 0]
    assert log[2][1:] == (0, 0.0, 1) and restored
    assert st == {"enabled": True, "level": 0, "steps_down": 3, "steps_up": 3}
    assert events[0] == {"level": 1, "set_spec_len": 0}


def test_engine_slow_cycle_stall_steps_the_ladder_down():
    """End to end on the port: ``engine.slow_cycle`` stretches one busy
    cycle to 10x stall_min_s; the watchdog records a stall and the ladder
    steps down (speculation off)."""
    eng = port_engine(params_from_jax(_weights(), TCFG, device="cpu"), brownout=True,
                      brownout_interval=1, stall_mult=2.0, stall_min_s=0.1, spec_len=3)
    eng.start()
    try:
        sp = sampling(eng)
        eng.generate("warm the cadence floor", sp(temperature=0.0, max_tokens=8))
        PORT_FAULTS.arm("engine.slow_cycle", times=1, delay_s=1.0)
        eng.generate("sustained pressure", sp(temperature=0.0, max_tokens=8))
        deadline = time.monotonic() + 30
        while eng.stats()["brownout"]["steps_down"] < 1:  # monotonic, unlike the level
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert eng.stalls >= 1 and any(d["cycle_s"] >= 1.0 for d in _events(eng, "stall"))
        assert _events(eng, "brownout")[0] == {"level": 1, "set_spec_len": 0}
    finally:
        PORT_FAULTS.reset()
        eng.stop()


def test_group_forces_brownout_and_autopilot_off():
    """Both read wall clocks and would fork lockstep ranks: a group turns
    them off, as coordination does in the reference."""
    group = ServingGroup(tp=1, sp=1, rank=0, tp_rank=0, sp_rank=0)
    eng = Engine(TCFG, device="cpu", group=group, brownout=True, autopilot=True, max_slots=2,
                 max_ctx=64, prefill_buckets=(32, 64), page_size=8)
    st = eng.stats()
    assert st["brownout"]["enabled"] is False
    assert st["scheduler"]["planner"]["autopilot"] is False
    assert eng._brownout is None and eng._autopilot is None
