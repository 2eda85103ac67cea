"""The host services under the port's serving layers
(``h2o_tpu_torch.core.{chaos,store,resilience,lockwitness,diag,memory,
log}`` and ``h2o_tpu_torch.config``) held against ``h2o_tpu``'s on the
same inputs:

- ``_Chaos`` with one seed and one call order injects the same faults
  (raised types and messages, returned verdicts) with equal
  ``counters()``, programmatic and from the environment;
- ``DKV`` and ``Scope`` give the same results and raise the same
  exceptions on one op sequence; the port's process-wide store is
  ``store.dkv()``;
- ``Deadline`` on an injected clock, ``RetryPolicy.backoff`` with
  jitter 0, ``is_retryable``, a retried call's ``stats()``;
- the lock witness reports the same cycles on the same acquisition
  orders;
- the config readers under the same environment;
- ``pressure()`` at budget 0 equals a reference manager with no tier
  set up, and a non-zero budget raises by name.
"""

import threading

import numpy as np
import pytest

from h2o_tpu import config as j_config
from h2o_tpu.core import chaos as j_chaos
from h2o_tpu.core import diag as j_diag
from h2o_tpu.core import lockwitness as j_lw
from h2o_tpu.core import memory as j_memory
from h2o_tpu.core import resilience as j_res
from h2o_tpu.core import store as j_store

from h2o_tpu_torch import config as p_config
from h2o_tpu_torch.core import chaos as p_chaos
from h2o_tpu_torch.core import diag as p_diag
from h2o_tpu_torch.core import lockwitness as p_lw
from h2o_tpu_torch.core import log as p_log
from h2o_tpu_torch.core import memory as p_memory
from h2o_tpu_torch.core import resilience as p_res
from h2o_tpu_torch.core import store as p_store


@pytest.fixture(autouse=True)
def _chaos_off():
    yield
    j_chaos.reset()
    p_chaos.reset()


# -- chaos -------------------------------------------------------------------

CHAOS_KW = dict(job_p=0.2, device_put_p=0.15, persist_p=0.1, stall_p=0.1,
                stall_secs=0.0, score_slow_p=0.3, score_slow_ms=0.0,
                transfer_slow_p=0.2, transfer_slow_ms=0.0, oom_p=0.1,
                stream_slow_p=0.2, stream_slow_ms=0.0,
                stream_truncate_p=0.1, kernel_reject_p=0.2,
                serve_pressure_p=0.4, slice_loss_p=0.05,
                admission_reject_p=0.25)

CALLS = [("maybe_fail_job", ("train",)), ("maybe_fail_device_put", ()),
         ("maybe_fail_persist", ("write", "s3://b/k")),
         ("maybe_stall", ("job",)), ("maybe_slow_score", ("serve:m",)),
         ("maybe_slow_transfer", ("block",)), ("maybe_oom", ("site",)),
         ("maybe_slow_stream", ("src",)), ("maybe_truncate_stream", ("src",)),
         ("maybe_kernel_reject", ("hist",)),
         ("maybe_serve_pressure", ("alias",)),
         ("maybe_lose_slice", ("tree",)),
         ("maybe_reject_admission", ("tenant",))]


def _drive(inst, order):
    """Outcome of each call: the returned value, or the raised type's
    name and message."""
    out = []
    for i in order:
        name, args = CALLS[i]
        try:
            out.append(("ok", getattr(inst, name)(*args)))
        except Exception as e:  # noqa: BLE001 — the outcome under test
            out.append((type(e).__name__, str(e)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 7, 42])
def test_chaos_same_seed_same_injections(seed):
    order = np.random.default_rng(100 + seed).integers(0, len(CALLS), 300)
    j = j_chaos.configure(seed=seed, **CHAOS_KW)
    p = p_chaos.configure(seed=seed, **CHAOS_KW)
    assert p.enabled and j.enabled
    got, want = _drive(p, order), _drive(j, order)
    assert got == want
    assert p.counters() == j.counters()
    c = p.counters()
    assert c["injected"] > 0
    assert c["injected"] == sum(v for k, v in c.items() if k != "injected")


@pytest.mark.parametrize("mode", ["persist", "oom", "stream", "slice"])
def test_chaos_transient_modes_equal(mode):
    kw = {"persist": dict(persist_transient=2),
          "oom": dict(oom_transient=3, region_oom_transient=1),
          "stream": dict(stream_truncate_transient=2),
          "slice": dict(slice_loss_at_block=4)}[mode]
    calls = [(0, "maybe_fail_persist", ("read", "a")),
             (1, "maybe_fail_persist", ("read", "b")),
             (2, "maybe_oom", ("s1",)), (3, "maybe_oom", ("s2",)),
             (4, "maybe_region_oom", ("r",)),
             (5, "maybe_truncate_stream", ("f",)),
             (6, "maybe_lose_slice", ("blk",))] * 6
    res = []
    for mod in (j_chaos, p_chaos):
        inst = mod.configure(seed=3, **kw)
        out = []
        for _i, name, args in calls:
            try:
                out.append(getattr(inst, name)(*args))
            except Exception as e:  # noqa: BLE001 — the outcome under test
                out.append((type(e).__name__, str(e),
                            isinstance(e, OSError)))
        res.append((out, inst.counters()))
    assert res[0] == res[1]
    assert res[1][1]["injected"] > 0


def test_chaos_from_environment(monkeypatch):
    for k, v in {"H2O_TPU_CHAOS_SERVE_PRESSURE": "0.5",
                 "H2O_TPU_CHAOS_SCORE_SLOW": "0.5",
                 "H2O_TPU_CHAOS_SCORE_SLOW_MS": "0",
                 "H2O_TPU_CHAOS_SEED": "11"}.items():
        monkeypatch.setenv(k, v)
    j_chaos.reset()
    p_chaos.reset()
    j, p = j_chaos.chaos(), p_chaos.chaos()
    assert p.serve_pressure_p == j.serve_pressure_p == 0.5
    order = [10, 4] * 40
    assert _drive(p, order) == _drive(j, order)
    assert p.counters() == j.counters()
    p_chaos.reset()
    monkeypatch.delenv("H2O_TPU_CHAOS_SERVE_PRESSURE")
    monkeypatch.delenv("H2O_TPU_CHAOS_SCORE_SLOW")
    assert not p_chaos.chaos().enabled


# -- DKV and Scope -----------------------------------------------------------

def _dkv_ops(mod, d):
    """One op sequence over a DKV of package ``mod``; each step's
    result or raised type."""
    ops = [
        lambda: d.put("frame_a", {"rows": 3}),
        lambda: d.put("frame_b", [1, 2]),
        lambda: d.put("model_x", "m"),
        lambda: d.get("frame_a"),
        lambda: d.get("missing", "dflt"),
        lambda: "frame_b" in d,
        lambda: sorted(d.keys("frame_*")),
        lambda: d.write_lock("frame_a"),
        lambda: d.put("frame_a", 0),
        lambda: d.remove("frame_a"),
        lambda: d.atomic("frame_a", lambda v: v),
        lambda: d.read_lock("frame_a"),
        lambda: d.write_lock("frame_a"),
        lambda: d.unlock("frame_a"),
        lambda: d.read_lock("frame_a"),
        lambda: d.write_lock("frame_a"),
        lambda: d.read_unlock("frame_a"),
        lambda: d.write_lock("frame_a"),
        lambda: d.atomic("frame_a", lambda v: v, force=True),
        lambda: d.get("frame_a"),
        lambda: d.read_lock("nope"),
        lambda: d.write_lock("nope"),
        lambda: d.atomic("ctr", lambda v: (v or 0) + 1),
        lambda: d.atomic("ctr", lambda v: (v or 0) + 1),
        lambda: d.remove("frame_b"),
        lambda: d.remove("never"),
        lambda: sorted(d.keys()),
        lambda: isinstance(mod.Key.make("k"), str),
        lambda: mod.Key.make("k").startswith("k_"),
    ]
    out = []
    for op in ops:
        try:
            out.append(("ok", op()))
        except Exception as e:  # noqa: BLE001 — the outcome under test
            out.append((type(e).__name__, str(e)))
    return out


def test_dkv_same_results_and_exceptions():
    got = _dkv_ops(p_store, p_store.DKV())
    want = _dkv_ops(j_store, j_store.DKV())
    assert got == want
    assert ("LockedException", "frame_a is write-locked") in got
    assert any(o[0] == "KeyError" for o in got)


def _scope_ops(mod, d):
    d.put("keep", 1)
    with mod.Scope(dkv=d) as outer:
        assert mod.Scope.current() is outer
        d.put(outer.track("tmp1"), 1)
        d.put(outer.track("tmp2"), 2)
        d.write_lock("tmp2")
        with mod.Scope(dkv=d) as inner:
            assert mod.Scope.current() is inner
            d.put(inner.track("tmp3"), 3)
            inner.protect("tmp3")
        after_inner = sorted(d.keys())
        assert mod.Scope.current() is outer
    return after_inner, sorted(d.keys()), mod.Scope.current()


def test_scope_same_results():
    got = _scope_ops(p_store, p_store.DKV())
    want = _scope_ops(j_store, j_store.DKV())
    assert got == want == (["keep", "tmp1", "tmp2", "tmp3"],
                           ["keep", "tmp3"], None)


def test_process_store_is_a_singleton_and_scope_defaults_to_it():
    d = p_store.dkv()
    assert p_store.dkv() is d
    with p_store.Scope() as sc:
        assert sc.dkv is d
        d.put(sc.track("serve_core_tmp"), 1)
    assert "serve_core_tmp" not in d


# -- resilience --------------------------------------------------------------

class _Clock:
    def __init__(self, t=100.0):
        self.t = t

    def monotonic(self):
        return self.t

    def time(self):
        return 1.7e9 + self.t

    def time_ns(self):
        return int(self.time() * 1e9)

    def sleep(self, s):
        self.t += s


@pytest.mark.parametrize("seconds", [None, 0, 0.5, 2.0])
def test_deadline_on_injected_clock(monkeypatch, seconds):
    clocks = {}
    for mod in (j_res, p_res):
        clocks[mod] = _Clock()
        monkeypatch.setattr(mod, "time", clocks[mod])
    trace = {}
    for mod in (j_res, p_res):
        dl, out = mod.Deadline(seconds), []
        for step in (0.0, 0.25, 0.25, 1.0, 1.0):
            clocks[mod].t += step
            try:
                dl.check("unit")
                out.append((dl.remaining(), dl.expired, repr(dl), None))
            except TimeoutError as e:
                out.append((dl.remaining(), dl.expired, repr(dl), str(e)))
        trace[mod] = out
    assert trace[p_res] == trace[j_res]


def test_backoff_and_classification():
    for kw in ({}, dict(base_delay=0.1, multiplier=3.0, max_delay=5.0)):
        jp = j_res.RetryPolicy(jitter=0.0, **kw)
        pp = p_res.RetryPolicy(jitter=0.0, **kw)
        assert [pp.backoff(a) for a in range(1, 10)] == \
            [jp.backoff(a) for a in range(1, 10)]

    class HTTPError(OSError):
        def __init__(self, code):
            super().__init__(code)
            self.code = code
    excs = [OSError("x"), ConnectionError("x"), TimeoutError("x"),
            FileNotFoundError("x"), PermissionError("x"), ValueError("x"),
            KeyError("x"), RuntimeError("x"), HTTPError(503),
            HTTPError(404), HTTPError(429)]
    assert [p_res.is_retryable(e) for e in excs] == \
        [j_res.is_retryable(e) for e in excs]


def test_retry_call_stats(monkeypatch):
    got = {}
    for mod in (j_res, p_res):
        monkeypatch.setattr(mod, "time", _Clock())
        mod.reset_stats()
        pol = mod.RetryPolicy(max_attempts=3, base_delay=0.0, jitter=0.0)
        n = {"calls": 0}

        def flaky():
            n["calls"] += 1
            if n["calls"] < 3:
                raise ConnectionError("blip")
            return "done"

        def permanent():
            raise ValueError("bad")

        def always():
            raise OSError("down")
        out = [pol.call(flaky)]
        for fn in (permanent, always):
            try:
                pol.call(fn)
            except Exception as e:  # noqa: BLE001 — the outcome under test
                out.append(type(e).__name__)
        got[mod] = (out, mod.stats())
    assert got[p_res] == got[j_res]
    assert got[p_res][1]["recoveries"] == 1


# -- lock witness ------------------------------------------------------------

def _witness(mod):
    reg = mod.WitnessRegistry()
    a = mod.make_lock("A", _registry=reg)
    b = mod.make_lock("B", _registry=reg)
    c = mod.make_rlock("C", _registry=reg)
    d = mod.make_lock("D", _registry=reg)

    def order(*locks):
        def run():
            held = []
            for lk in locks:
                lk.acquire()
                held.append(lk)
            for lk in reversed(held):
                lk.release()
        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()

    order(a, b)
    order(b, c, c)         # re-entry records no edge
    order(c, a)            # A -> B -> C -> A
    order(a, d)
    order(b, a)            # A <-> B
    reg.note_device_dispatch("nothing held")
    with a:
        reg.note_device_dispatch("predict")
    cycles = sorted((cy["names"], [(e["outer"], e["inner"], e["count"])
                                   for e in cy["edges"]])
                    for cy in reg.find_cycles())
    st = reg.stats()
    return (cycles, sorted(reg.name_edges().items()),
            [(h["site"], h["locks"], h["count"])
             for h in reg.held_dispatches()], st)


def test_witness_reports_the_same_cycles():
    got, want = _witness(p_lw), _witness(j_lw)
    assert got == want
    assert len(got[0]) == 2 and got[2] == [("predict", ["A"], 1)]


def test_witness_switch_reads_the_same_variable(monkeypatch):
    monkeypatch.setenv("H2O_TPU_LOCK_WITNESS", "0")
    assert not p_lw.enabled()
    assert type(p_lw.make_lock("x")) is type(threading.Lock())
    monkeypatch.setenv("H2O_TPU_LOCK_WITNESS", "yes")
    assert p_lw.enabled() == j_lw.enabled() is True
    assert isinstance(p_lw.make_rlock("x"), p_lw._WitnessLock)


# -- config ------------------------------------------------------------------

READERS = list(p_config.__all__)
ENVS = [{},
        {"H2O_TPU_MEM_BUDGET": "4096", "H2O_TPU_SERVE_REPLICAS": "3",
         "H2O_TPU_BREAKER_SOFT": "0.6", "H2O_TPU_BREAKER_HARD": "0.9",
         "H2O_TPU_BREAKER_OPEN_SECS": "0.25", "H2O_TPU_BREAKER_PROBES": "0",
         "H2O_TPU_BREAKER_INTERVAL_MS": "0",
         "H2O_TPU_BREAKER_STALL_SOFT": "2", "H2O_TPU_SERVE_ADAPTIVE": "on",
         "H2O_TPU_SERVE_MIN_BATCH": "4", "H2O_TPU_SERVE_MAX_BATCH": "64",
         "H2O_TPU_STREAM_POLL_MS": "7.5"},
        {"H2O_TPU_HBM_BUDGET": "1024", "H2O_TPU_MEM_BUDGET": "9",
         "H2O_TPU_SERVE_REPLICAS": "0", "H2O_TPU_SERVE_ADAPTIVE": "no",
         "H2O_TPU_SERVE_MIN_BATCH": "", "H2O_TPU_SERVE_MAX_BATCH": "0",
         "H2O_TPU_STREAM_POLL_MS": ""}]


@pytest.mark.parametrize("env", range(len(ENVS)))
def test_config_readers_equal(monkeypatch, env):
    for k in ("H2O_TPU_HBM_BUDGET", "H2O_TPU_MEM_BUDGET"):
        monkeypatch.delenv(k, raising=False)
    for k, v in ENVS[env].items():
        monkeypatch.setenv(k, v)
    assert READERS == ["hbm_budget", "serve_replicas", "breaker_soft",
                       "breaker_hard", "breaker_open_secs", "breaker_probes",
                       "breaker_interval_ms", "breaker_stall_soft",
                       "serve_adaptive_default", "serve_min_batch",
                       "serve_max_batch", "stream_poll_ms"]
    for name in READERS:
        assert getattr(p_config, name)() == getattr(j_config, name)(), name


# -- memory telemetry --------------------------------------------------------

def test_pressure_at_budget_zero_equals_reference():
    want = j_memory.MemoryManager(0).pressure()
    got = p_memory.MemoryManager(0).pressure()
    assert got == want
    assert set(got) == {"hbm_frac", "resident_bytes", "valid_bytes",
                        "demand_page_stalls", "pages_in", "pages_out",
                        "spills"}
    assert p_memory.manager().pressure() == want


def test_nonzero_budget_raises_by_name(monkeypatch):
    with pytest.raises(NotImplementedError, match="tiered memory store"):
        p_memory.MemoryManager(1 << 30)
    monkeypatch.setattr(p_memory, "_manager", None)
    monkeypatch.setenv("H2O_TPU_HBM_BUDGET", "1000000")
    with pytest.raises(NotImplementedError, match="P14"):
        p_memory.manager()
    monkeypatch.delenv("H2O_TPU_HBM_BUDGET")
    assert p_memory.manager().budget == 0


# -- TimeLine and log --------------------------------------------------------

def test_timeline_ring_and_logger():
    for mod in (p_diag, j_diag):
        assert mod.MAX_EVENTS == 2048
    p_diag.TimeLine.record("serve", "deploy", deployment="x", version=1)
    ev = p_diag.TimeLine.snapshot()[-1]
    assert {k: ev[k] for k in ("kind", "what", "deployment", "version")} \
        == {"kind": "serve", "what": "deploy", "deployment": "x",
            "version": 1}
    assert set(ev) == {"ns", "kind", "what", "thread", "deployment",
                       "version"}
    assert p_log.get_logger("serve").name == "h2o_tpu_torch.serve"
    p_log.get_logger("serve").warning("serve_core test line")
    assert p_log.recent_lines()[-1].endswith("serve_core test line")
