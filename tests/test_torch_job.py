"""The port's job registry (``h2o_tpu_torch.core.job``) held against
``h2o_tpu.core.job`` on the CPU.

Each scenario runs the same body on a registry of each package and
compares what a client sees: statuses, progress, the exception's type
and message (job keys masked), ``expired_count``/``evicted_count`` and
``to_dict()`` without its keys and clocks.  The bodies are the
reference's own tests' (``tests/test_core.py:144-180``,
``tests/test_resilience.py:216-300``, ``tests/test_chaos.py:26``), held
by events instead of sleeps: a body waits on a gate the test opens, and
a watchdog of 20 ms expires a stalled job whatever the host's load, so
no outcome depends on how fast a thread runs.

Then the builders' progress reports, held against the reference's: a
GBM, DRF, GLM, KMeans, IsolationForest, PCA and GAM build cancelled from
its first ``update()`` ends CANCELLED with the reference's first report
and nothing published; a GBM expired by the watchdog at its first
report fails with the reference's ``TimeoutError`` and frees its slot.
Where the port goes further (one report a tree, and no model published
by a build stopped after its last report), it is held alone.

Then the port's own contract: ``train`` runs through the process
registry and publishes the model under the job's ``dest``; a failing
body raises from ``train``; two builds started together give the forests
they give alone; a tenant, the admission queue and an unknown
checkpoint key are refused by name; the process registry has the
reference's default settings.
"""

import threading

import numpy as np
import pytest

from h2o_tpu.core import chaos as j_chaos
from h2o_tpu.core import job as j_job
from h2o_tpu.core.cloud import cloud as j_cloud
from h2o_tpu.core.config import OptArgs
from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models.gam import GAM as JGAM
from h2o_tpu.models.glm import GLM as JGLM
from h2o_tpu.models.kmeans import KMeans as JKMeans
from h2o_tpu.models.pca import PCA as JPCA
from h2o_tpu.models.tree.drf import DRF as JDRF
from h2o_tpu.models.tree.gbm import GBM as JGBM
from h2o_tpu.models.tree.isofor import IsolationForest as JIsoFor

from h2o_tpu_torch.core import chaos as p_chaos
from h2o_tpu_torch.core import job as p_job
from h2o_tpu_torch.core.frame import Frame, Vec, T_CAT
from h2o_tpu_torch.core.store import dkv, unpublish_on_exit
from h2o_tpu_torch.models.gam import GAM
from h2o_tpu_torch.models.glm import GLM
from h2o_tpu_torch.models.kmeans import KMeans
from h2o_tpu_torch.models.pca import PCA
from h2o_tpu_torch.models.tree.drf import DRF
from h2o_tpu_torch.models.tree.gbm import GBM
from h2o_tpu_torch.models.tree.isofor import IsolationForest
from tests.test_torch_gam import _wiggly


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


WAIT = 20.0

#: to_dict fields that hold keys or clocks
_VOLATILE = ("key", "dest", "start_time", "msec", "last_progress",
             "exception")


@pytest.fixture(autouse=True)
def _chaos_off():
    for ch in (j_chaos, p_chaos):
        ch.reset()
    yield
    for ch in (j_chaos, p_chaos):
        ch.reset()


def _view(job):
    """What a client reads of a terminal job, keys and clocks masked."""
    d = {k: v for k, v in job.to_dict().items() if k not in _VOLATILE}
    exc = job.exception
    msg = None if exc is None else str(exc).replace(str(job.key), "<job>")
    return d, (type(exc).__name__ if exc is not None else None, msg)


def _join_outcome(job):
    try:
        return ("ok", job.join(WAIT))
    except Exception as e:  # noqa: BLE001 — the outcome under test
        return (type(e).__name__, str(e).replace(str(job.key), "<job>"))


def _both(scenario):
    """(reference outcome, port outcome) of ``scenario(module)``."""
    return scenario(j_job), scenario(p_job)


# -- lifecycle, cancel, failure (tests/test_core.py:144-180) ------------------

def _lifecycle(mod):
    reg = mod.JobRegistry(max_workers=2)
    j = mod.Job(description="test")

    def body(job):
        job.update(0.5, "halfway")
        return 42
    reg.start(j, body)
    return _join_outcome(j), j.status, j.progress, _view(j)


def test_lifecycle_equals_reference():
    want, got = _both(_lifecycle)
    assert got == want
    assert got[0] == ("ok", 42) and got[1] == "DONE" and got[2] == 1.0


def _cancel(mod):
    reg = mod.JobRegistry(max_workers=2)
    gate, entered = threading.Event(), threading.Event()
    j = mod.Job(description="cancelme")

    def body(job):
        entered.set()
        gate.wait(WAIT)
        for _ in range(100):
            job.update(0.1)
        return None
    reg.start(j, body)
    entered.wait(WAIT)
    j.cancel()
    gate.set()
    out = _join_outcome(j)
    return out, j.status, j.progress, _view(j)


def test_cancel_equals_reference():
    want, got = _both(_cancel)
    assert got == want
    assert got[0] == ("JobCancelledException", "cancelme")
    assert got[1] == "CANCELLED"


def _failure(mod):
    reg = mod.JobRegistry(max_workers=2)
    j = mod.Job(description="boom")
    reg.start(j, lambda job: 1 / 0)
    first = _join_outcome(j)
    status = j.status
    # the reference's defensive branch: FAILED without a cause
    j.exception = None
    return first, status, _join_outcome(j)


def test_failure_propagates_as_reference():
    want, got = _both(_failure)
    assert got == want
    assert got[0][0] == "ZeroDivisionError" and got[1] == "FAILED"
    assert got[2] == ("RuntimeError",
                      "job <job> FAILED with no recorded exception")


# -- registry bound (tests/test_resilience.py:216-245) ------------------------

def _lru(mod):
    reg = mod.JobRegistry(max_workers=2, jobs_cap=5)
    jobs = [reg.start(mod.Job(description=f"q{i}"), lambda j: None)
            for i in range(10)]
    for j in jobs:
        j._done.wait(WAIT)
    last = reg.start(mod.Job(description="last"), lambda j: None)
    last.join(WAIT)
    return (len(reg.list()) <= 5, reg.evicted_count >= 5,
            reg.get(str(last.key)) is not None)


def test_terminal_jobs_lru_evicted_as_reference():
    want, got = _both(_lru)
    assert got == want == (True, True, True)


def _running_kept(mod):
    reg = mod.JobRegistry(max_workers=4, jobs_cap=2)
    gate = threading.Event()
    live = [reg.start(mod.Job(description=f"live{i}"),
                      lambda j: gate.wait(WAIT)) for i in range(3)]
    try:
        done = reg.start(mod.Job(description="done"), lambda j: None)
        done.join(WAIT)
        kept = [reg.get(str(j.key)) is not None for j in live]
        return kept, reg.evicted_count, done.status
    finally:
        gate.set()
        for j in live:
            j._done.wait(WAIT)


def test_running_jobs_never_evicted_as_reference():
    want, got = _both(_running_kept)
    assert got == want
    assert got[0] == [True, True, True]


# -- deadlines and the watchdog (tests/test_resilience.py:250-300) ------------

def _stall(mod):
    """A hung job (no heartbeat) is FAILED(TimeoutError) and its pool
    slot compensated: the next job on the same one-worker pool runs."""
    reg = mod.JobRegistry(max_workers=1, watchdog_interval=0.02)
    release = threading.Event()
    stuck = reg.start(mod.Job(description="stuck", stall_secs=0.1),
                      lambda j: release.wait(WAIT))
    try:
        first = _join_outcome(stuck)
        nxt = reg.start(mod.Job(description="next"), lambda j: "ran")
        return (first, stuck.status, type(stuck.exception).__name__,
                stuck.to_dict()["timed_out"], _join_outcome(nxt),
                reg.expired_count, _view(stuck)[0])
    finally:
        release.set()


def test_stall_watchdog_expires_and_frees_slot_as_reference():
    want, got = _both(_stall)
    assert got == want
    assert got[0] == ("TimeoutError", "job <job> (stuck): no progress "
                                      "heartbeat for 0.1s (stall window)")
    assert got[4] == ("ok", "ran") and got[5] == 1


def _deadline(mod):
    """A job that heartbeats but outlives its deadline is cancelled at
    its next update() and recorded FAILED(TimeoutError)."""
    reg = mod.JobRegistry(max_workers=2, watchdog_interval=0.02)
    beat = threading.Event()

    def spin(j):
        while True:
            beat.wait(0.01)
            j.update(0.1, "spinning")

    job = reg.start(mod.Job(description="budget", deadline_secs=0.1),
                    spin)
    out = _join_outcome(job)
    d, exc = _view(job)
    # how many heartbeats landed before the deadline is the host's pace
    for k in ("progress", "progress_msg"):
        d.pop(k)
    return out, job.status, d, exc, reg.expired_count


def test_deadline_expires_cooperative_body_as_reference():
    want, got = _both(_deadline)
    assert got == want
    assert got[0][0] == "TimeoutError" and "deadline of 0.1s" in got[0][1]
    assert got[2]["deadline_secs"] == 0.1 and got[2]["status"] == "FAILED"


def _chaos_stall(mod, ch):
    ch.configure(stall_p=1.0, stall_secs=0.5, seed=0)
    reg = mod.JobRegistry(max_workers=2, watchdog_interval=0.02)
    job = reg.start(mod.Job(description="victim", stall_secs=0.1),
                    lambda j: "never-counts")
    out = _join_outcome(job)
    return out[0], job.status, ch.chaos().injected_stalls


def test_chaos_stall_injector_trips_watchdog_as_reference():
    want = _chaos_stall(j_job, j_chaos)
    got = _chaos_stall(p_job, p_chaos)
    assert got == want == ("TimeoutError", "FAILED", 1)


def _chaos_fault(mod, ch):
    """tests/test_chaos.py:26: an injected job fault fails the job and
    reaches its joiner."""
    ch.configure(job_p=1.0, seed=0)
    reg = mod.JobRegistry(max_workers=2)
    job = reg.start(mod.Job(description="gbm on frame"), lambda j: 1)
    return _join_outcome(job), job.status, ch.chaos().injected_jobs


def test_chaos_job_fault_propagates_as_reference():
    want = _chaos_fault(j_job, j_chaos)
    got = _chaos_fault(p_job, p_chaos)
    assert got == want
    assert got[0] == ("ChaosError", "injected job fault (gbm on frame)")


def _quiesce(mod):
    reg = mod.JobRegistry(max_workers=2)
    entered, gate = threading.Event(), threading.Event()

    def body(j):
        entered.set()
        gate.wait(WAIT)
        j.update(0.5)
    job = reg.start(mod.Job(description="moving"), body)
    entered.wait(WAIT)
    victims = reg.quiesce(cause="reform", wait_secs=0.0)
    gate.set()
    out = _join_outcome(job)
    return len(victims), out, job.status, _view(job)[0]


def test_quiesce_interrupts_as_reference():
    want, got = _both(_quiesce)
    assert got == want
    assert got[2] == "INTERRUPTED" and got[3]["auto_recoverable"] is True


def test_run_sync_and_system_band_as_reference():
    def go(mod):
        reg = mod.JobRegistry(max_workers=1, system_workers=1)
        gate = threading.Event()
        user = reg.start(mod.Job(description="user"),
                         lambda j: gate.wait(WAIT))
        # the system band runs while the one user slot is held
        got = reg.run_sync(mod.Job(description="admin",
                                   priority=mod.Job.SYSTEM_PRIORITY),
                           lambda j: "sys")
        gate.set()
        user.join(WAIT)
        return got, user.status
    assert go(p_job) == go(j_job) == ("sys", "DONE")


# -- the port's own contract -------------------------------------------------

def _frame(n=400, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    y = (x[:, 0] + rng.normal(size=n) * 0.5 > 0).astype(np.int32)
    return Frame(["a", "b", "c", "y"],
                 [Vec(x[:, 0]), Vec(x[:, 1]), Vec(x[:, 2]),
                  Vec(y, T_CAT, domain=["n", "p"])])


def test_train_runs_as_a_job_and_publishes():
    fr = _frame()
    b = GBM(device="cpu", ntrees=3, max_depth=3, seed=1, model_id="g1")
    job = b.train_async(y="y", training_frame=fr)
    m = job.join(WAIT)
    assert job.status == p_job.DONE and job.progress == 1.0
    assert str(job.dest) == "g1" == m.model_id
    assert dkv().get("g1") is m
    assert p_job.jobs().get(str(job.key)) is job
    assert job.to_dict()["dest"]["type"] == "Key<Model>"
    assert job.description == f"gbm on {fr.key}"
    # a second train() of the same builder replaces the published model
    m2 = b.train(y="y", training_frame=fr)
    assert dkv().get("g1") is m2 and m2 is not m


def test_failed_body_raises_from_train():
    fr = _frame()
    p_chaos.configure(job_p=1.0, seed=0)
    with pytest.raises(p_chaos.ChaosError):
        GBM(device="cpu", ntrees=2, model_id="g_fail").train(
            y="y", training_frame=fr)
    failed = [j for j in p_job.jobs().list()
              if str(j.dest) == "g_fail"]
    assert failed and failed[-1].status == p_job.FAILED
    assert "g_fail" not in dkv()
    p_chaos.reset()
    # a builder error is the job's too
    with pytest.raises(ValueError, match="ntrees"):
        GBM(device="cpu", ntrees=0).train(y="y", training_frame=fr)


def _forest(m):
    return {k: np.asarray(m.output[k]) for k in
            ("split_col", "value", "thr_bin", "na_left")}


def test_two_builds_at_once_equal_each_alone():
    fr = _frame(n=600)
    alone = [GBM(device="cpu", ntrees=4, max_depth=3, seed=1).train(
                 y="y", training_frame=fr),
             DRF(device="cpu", ntrees=3, max_depth=4, seed=2).train(
                 y="y", training_frame=fr)]
    jobs = [GBM(device="cpu", ntrees=4, max_depth=3,
                seed=1).train_async(y="y", training_frame=fr),
            DRF(device="cpu", ntrees=3, max_depth=4,
                seed=2).train_async(y="y", training_frame=fr)]
    together = [j.join(WAIT * 3) for j in jobs]
    for a, b in zip(alone, together):
        fa, fb = _forest(a), _forest(b)
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_refusals_by_name():
    with pytest.raises(NotImplementedError, match="P14b"):
        p_job.Job(description="t", tenant="acme")
    with pytest.raises(NotImplementedError, match="P14b"):
        p_job.JobRegistry().admission
    with pytest.raises(ValueError, match="checkpoint model nope not found"):
        GBM(device="cpu", ntrees=2, checkpoint="nope").train(
            y="y", training_frame=_frame())


def test_pool_reuses_an_idle_worker_and_spawns_for_a_busy_one():
    """Jobs one after another run on one thread (a new thread on the card
    makes its own cuBLAS handle and workspace); two at once on two."""
    reg = p_job.JobRegistry(max_workers=4)
    names = [reg.run_sync(p_job.Job(description=f"serial {i}"),
                          lambda j: threading.current_thread().name)
             for i in range(3)]
    assert len(set(names)) == 1 and reg._pool.live_workers == 1
    a_in, b_in = threading.Event(), threading.Event()

    def meet(mine, other):
        def body(j):
            mine.set()
            assert other.wait(WAIT), "the two jobs did not run at once"
            return threading.current_thread().name
        return body
    ja = reg.start(p_job.Job(description="a"), meet(a_in, b_in))
    jb = reg.start(p_job.Job(description="b"), meet(b_in, a_in))
    assert ja.join(WAIT) != jb.join(WAIT)
    assert reg._pool.live_workers == 2


def test_process_registry_defaults_equal_the_reference():
    a = OptArgs()
    reg = p_job.jobs()
    assert (reg.default_deadline_secs, reg.default_stall_secs,
            reg.watchdog_interval, reg.jobs_cap) == (
        a.job_deadline_secs, a.job_stall_secs, a.watchdog_interval_secs,
        a.jobs_cap)


# -- builders report progress: a cancel or a deadline reaches the build ------

def _frames(algo, n=400, seed=3):
    """(reference frame, port frame): the GAM's wiggly curve, else
    ``_frame``'s binomial data."""
    if algo == "gam":
        x, y = _wiggly()
        cols = {"x": x, "y": y}
        return (JFrame(list(cols), [JVec(v) for v in cols.values()]),
                Frame(list(cols), [Vec(v) for v in cols.values()]))
    pf = _frame(n, seed)
    jf = JFrame(pf.names, [JVec(pf.vec(c).as_float()) for c in "abc"] +
                [JVec(pf.vec("y").to_numpy(), J_CAT, domain=["n", "p"])])
    return jf, pf


_UNSUP = dict(ignored_columns=["y"])
#: algo -> (reference builder, port builder, params, response)
_BUILDERS = {
    "gbm": (JGBM, GBM, dict(ntrees=3, max_depth=3, seed=1), "y"),
    "drf": (JDRF, DRF, dict(ntrees=3, max_depth=4, seed=2), "y"),
    "glm": (JGLM, GLM, dict(family="binomial", lambda_=0.0), "y"),
    "kmeans": (JKMeans, KMeans, dict(_UNSUP, k=2, seed=1), None),
    "isofor": (JIsoFor, IsolationForest, dict(_UNSUP, ntrees=5, seed=1),
               None),
    "pca": (JPCA, PCA, dict(_UNSUP, k=2), None),
    "gam": (JGAM, GAM, dict(gam_columns=["x"], num_knots=10, bs=[1],
                            lambda_=1e-2, seed=1), "y"),
}


def _hook(monkeypatch, mod, action, before_first=False, after_msg=None):
    """Patch ``mod.Job.update``: record every (progress, msg) and run
    ``action(job)`` once, before the first call reaches the job or after
    the call whose message is ``after_msg`` returned."""
    seen, fired = [], []
    orig = mod.Job.update

    def update(job, progress, msg=""):
        seen.append((float(progress), msg))
        if before_first and not fired:
            fired.append(True)
            action(job)
        orig(job, progress, msg)
        if msg == after_msg and not fired:
            fired.append(True)
            action(job)

    monkeypatch.setattr(mod.Job, "update", update)
    return seen


def _build(mod, algo, model_id):
    """Start ``algo``'s build in ``mod``'s package: (job, its outcome)."""
    jcls, pcls, kw, y = _BUILDERS[algo]
    jf, pf = _frames(algo)
    if mod is j_job:
        job = jcls(model_id=model_id, **kw).train_async(
            y=y, training_frame=jf)
    else:
        job = pcls(device="cpu", model_id=model_id, **kw).train_async(
            y=y, training_frame=pf)
    kind, val = _join_outcome(job)
    if kind != "ok":
        val = val.replace(job.description, "<build>")
    return job, (kind, val)


def _stores():
    return {j_job: j_cloud().dkv, p_job: dkv()}


@pytest.mark.parametrize("algo", sorted(_BUILDERS))
def test_builder_cancelled_at_its_first_update_as_reference(monkeypatch,
                                                           algo):
    got = {}
    for mod in (j_job, p_job):
        seen = _hook(monkeypatch, mod, lambda j: j.cancel(),
                     before_first=True)
        job, out = _build(mod, algo, f"cancelled_{algo}")
        got[mod] = (out, job.status, seen[:1],
                    _stores()[mod].get(f"cancelled_{algo}") is None)
        monkeypatch.undo()
    assert got[p_job] == got[j_job]
    assert got[p_job][0][0] == "JobCancelledException"
    assert got[p_job][1] == p_job.CANCELLED and got[p_job][3]


def _registry(mod):
    return j_cloud().jobs if mod is j_job else p_job.jobs()


def _past_deadline(reg, job):
    """The watchdog's transition for ``job`` past the registry's default
    deadline (its scan, at a clock that reads the deadline gone)."""
    reg._expire(job, f"deadline of {reg.default_deadline_secs:g}s exceeded")


def test_gbm_past_its_deadline_fails_as_reference(monkeypatch):
    got = {}
    for mod in (j_job, p_job):
        reg = _registry(mod)
        monkeypatch.setattr(reg, "default_deadline_secs", 3600.0)
        n0 = reg.expired_count
        _hook(monkeypatch, mod, lambda j, r=reg: _past_deadline(r, j),
              before_first=True)
        job, out = _build(mod, "gbm", "late_gbm")
        got[mod] = (out, job.status, type(job.exception).__name__,
                    reg.expired_count - n0,
                    _stores()[mod].get("late_gbm") is None)
        monkeypatch.undo()
        assert reg.run_sync(mod.Job(description="next"),
                            lambda j: "ran") == "ran"
    assert got[p_job] == got[j_job]
    assert got[p_job][:4] == (
        ("TimeoutError", "job <job> (<build>): deadline of 3600s "
                         "exceeded"), p_job.FAILED, "TimeoutError", 1)


@pytest.mark.parametrize("action", ["cancel", "deadline"])
def test_gbm_stopped_after_its_last_tree_publishes_nothing(monkeypatch,
                                                           action):
    """The reference's one-call forest reports once, before it trains,
    so a stop that comes later is seen by no update(): it publishes the
    model (and a cancelled build ends DONE).  The port's body checks
    the stop before it publishes."""
    reg = p_job.jobs()
    if action == "cancel":
        act = lambda j: j.cancel()          # noqa: E731
    else:
        monkeypatch.setattr(reg, "default_deadline_secs", 3600.0)
        act = lambda j: _past_deadline(reg, j)    # noqa: E731
    seen = _hook(monkeypatch, p_job, act, after_msg="3 trees")
    job, out = _build(p_job, "gbm", "stopped_gbm")
    assert seen[-1] == (0.9, "3 trees")
    assert dkv().get("stopped_gbm") is None
    if action == "cancel":
        assert out[0] == "JobCancelledException"
        assert job.status == p_job.CANCELLED
    else:
        assert out[0] == "TimeoutError" and job.status == p_job.FAILED


def test_gbm_reports_every_tree_and_stops_between_trees(monkeypatch):
    seen = _hook(monkeypatch, p_job, lambda j: j.cancel(),
                 after_msg="1 trees")
    job, out = _build(p_job, "gbm", "between_gbm")
    assert out[0] == "JobCancelledException"
    assert seen == [(0.05, "training 3 trees"),
                    (float(np.float64(0.05) + 0.85 / 3), "1 trees"),
                    (float(np.float64(0.05) + 0.85 * 2 / 3), "2 trees")]
    assert dkv().get("between_gbm") is None
