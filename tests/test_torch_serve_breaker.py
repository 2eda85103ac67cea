"""The port's load breaker (``h2o_tpu_torch.serve.breaker``) held against
``h2o_tpu.serve.breaker`` on one sequence of samples and one injected
clock (``time`` monkeypatched in both breaker modules): every admission's
outcome (admitted, ``ShedLoad`` or ``BreakerOpen`` with its
``retry_after_s``), the state after each step, the shrink/restore
callbacks, ``stats()`` (events included) and the process totals equal
the reference's.

Cases: the full cycle CLOSED -> SHEDDING -> OPEN -> HALF_OPEN -> CLOSED
on queue pressure, a probe failure that reopens, a still-hot probe
window, the latency signal, the evaluation interval, and seeded random
walks under chaos serve-pressure.  The reference breaker samples its
tier manager; both read a manager with no tier set up (budget 0).
"""

import numpy as np
import pytest

from h2o_tpu.core import chaos as j_chaos
from h2o_tpu.core import memory as j_memory
from h2o_tpu.serve import breaker as j_br

from h2o_tpu_torch.core import chaos as p_chaos
from h2o_tpu_torch.core import lockwitness as p_lw
from h2o_tpu_torch.serve import breaker as p_br


class _Clock:
    def __init__(self):
        self.t = 500.0

    def monotonic(self):
        return self.t

    def time(self):
        return 1.7e9 + self.t


@pytest.fixture()
def fresh(monkeypatch):
    """Injected clocks, no tier in the reference's sample, zeroed
    totals, chaos off afterwards."""
    clocks = {j_br: _Clock(), p_br: _Clock()}
    for mod, clock in clocks.items():
        monkeypatch.setattr(mod, "time", clock)
        mod.reset_totals()
    monkeypatch.setattr(j_memory, "manager", lambda: j_memory.MemoryManager(0))
    yield clocks
    j_chaos.reset()
    p_chaos.reset()
    for mod in clocks:
        mod.reset_totals()


def _run(mod, clock, ops, **kw):
    fired = []
    b = mod.LoadBreaker("dep", on_shrink=lambda: fired.append("shrink"),
                        on_restore=lambda: fired.append("restore"), **kw)
    out = []
    for op in ops:
        if op[0] == "tick":
            clock.t += op[1]
            continue
        if op[0] == "result":
            b.note_result(op[1])
            out.append(("result", b.state))
            continue
        _, q, cap, p99 = op
        try:
            b.admit(q, cap, p99)
            out.append(("admit", b.state))
        except (mod.ShedLoad, mod.BreakerOpen) as e:
            assert e.retry_after_s > 0
            out.append((type(e).__name__, round(e.retry_after_s, 9),
                        str(e), b.state))
    return out, fired, b.stats(), mod.totals()


def _both(fresh, ops, chaos_kw=None, **kw):
    res = {}
    for mod, cmod in ((j_br, j_chaos), (p_br, p_chaos)):
        if chaos_kw:
            cmod.configure(**chaos_kw)
        res[mod] = _run(mod, fresh[mod], ops, **kw)
        if chaos_kw:
            res[mod] += (cmod.chaos().counters(),)
    assert res[p_br] == res[j_br]
    return res[p_br]


def _edges(stats):
    return [(e["from"], e["to"]) for e in stats["events"]]


CYCLE = ([("admit", 0, 10, 0.0)] + [("admit", 9, 10, 0.0)] * 20 +
         [("admit", 10, 10, 0.0), ("admit", 0, 10, 0.0), ("tick", 0.06),
          ("admit", 0, 10, 0.0), ("admit", 0, 10, 0.0),
          ("admit", 0, 10, 0.0), ("result", True), ("result", True)])


def test_full_cycle_equals_reference(fresh):
    out, fired, stats, totals = _both(
        fresh, CYCLE, soft=0.6, hard=0.95, open_secs=0.05, probe_n=2,
        interval_ms=0)
    assert _edges(stats) == [("closed", "shedding"), ("shedding", "open"),
                             ("open", "half_open"), ("half_open", "closed")]
    assert fired == ["shrink", "restore"]
    kinds = [o[0] for o in out]
    assert "ShedLoad" in kinds and "BreakerOpen" in kinds
    assert totals["breaker_trips"] == 1 and totals["breaker_closes"] == 1
    assert stats["state"] == "closed" and stats["trips"] == 1


PROBE_FAIL = [("admit", 10, 10, 0.0), ("tick", 0.03), ("admit", 0, 10, 0.0),
              ("result", False), ("admit", 0, 10, 0.0), ("tick", 0.03),
              ("admit", 0, 10, 0.0), ("result", True), ("admit", 0, 10, 0.0),
              ("result", True)]


def test_probe_failure_reopens(fresh):
    out, fired, stats, totals = _both(
        fresh, PROBE_FAIL, soft=0.6, hard=0.95, open_secs=0.02, probe_n=2,
        interval_ms=0)
    assert ("result", "open") in out
    assert stats["trips"] == 2 and stats["state"] == "closed"
    assert fired == ["restore"]          # OPEN entered from CLOSED directly
    assert totals["breaker_half_opens"] == 2


HOT_PROBES = [("admit", 10, 10, 0.0), ("tick", 1.0), ("admit", 7, 10, 0.0),
              ("admit", 7, 10, 0.0), ("result", True), ("result", True),
              ("tick", 1.0), ("admit", 10, 10, 0.0), ("tick", 1.0),
              ("admit", 0, 10, 0.0), ("admit", 0, 10, 0.0),
              ("admit", 0, 10, 0.0), ("admit", 0, 10, 0.0),
              ("result", True), ("result", True), ("result", True)]


def test_hot_probe_window_reopens(fresh):
    out, _fired, stats, _totals = _both(
        fresh, HOT_PROBES, soft=0.6, hard=0.95, open_secs=0.5, probe_n=3,
        interval_ms=0)
    assert stats["trips"] >= 2 and stats["state"] == "closed"


LATENCY = [("admit", 0, 10, 50.0), ("admit", 0, 10, 90.0),
           ("admit", 0, 10, 90.0), ("admit", 0, 10, 93.0),
           ("admit", 0, 10, 30.0), ("admit", 0, 10, 30.0),
           ("admit", 0, 10, 30.0), ("admit", 0, 10, 120.0)]


def test_latency_signal(fresh):
    out, fired, stats, _totals = _both(fresh, LATENCY, p99_slo_ms=100.0,
                                       interval_ms=0)
    assert _edges(stats)[:2] == [("closed", "shedding"),
                                 ("shedding", "closed")]
    assert stats["signals"]["latency"] == 1.2


INTERVAL = [("admit", 9, 10, 0.0), ("admit", 10, 10, 0.0), ("tick", 0.04),
            ("admit", 10, 10, 0.0), ("tick", 0.02), ("admit", 10, 10, 0.0)]


def test_evaluation_interval(fresh, monkeypatch):
    monkeypatch.setenv("H2O_TPU_BREAKER_INTERVAL_MS", "50")
    out, _fired, stats, _totals = _both(fresh, INTERVAL)
    assert stats["state"] == "open"
    assert [o[-1] for o in out] == ["shedding", "shedding", "shedding",
                                    "open"]


def _walk(seed, n=400):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        r = rng.uniform()
        if r < 0.1:
            ops.append(("tick", float(rng.choice([0.01, 0.05, 0.3]))))
        elif r < 0.3:
            ops.append(("result", bool(rng.uniform() < 0.85)))
        else:
            ops.append(("admit", int(rng.integers(0, 12)), 12,
                        float(rng.uniform(0, 40))))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_chaos_walk_equals_reference(fresh, seed):
    out, fired, stats, totals, counters = _both(
        fresh, _walk(seed), chaos_kw=dict(serve_pressure_p=0.15,
                                          seed=seed),
        open_secs=0.2, probe_n=2, interval_ms=0, p99_slo_ms=50.0)
    assert counters["injected_serve_pressure"] > 0
    assert totals["breaker_trips"] >= 1
    assert {o[0] for o in out} >= {"admit", "BreakerOpen"}


def test_env_defaults_equal(fresh, monkeypatch):
    monkeypatch.setenv("H2O_TPU_BREAKER_SOFT", "0.5")
    monkeypatch.setenv("H2O_TPU_BREAKER_PROBES", "4")
    got = [mod.LoadBreaker("d").stats() for mod in (p_br, j_br)]
    assert got[0] == got[1]
    assert got[0]["soft"] == 0.5 and got[0]["probe_n"] == 4
    assert p_br.LoadBreaker._weight_share("any") == 1.0


def test_no_lock_cycle_witnessed():
    assert p_lw.enabled()
    assert p_lw.registry().find_cycles() == []
    assert p_lw.registry().held_dispatches() == []
