"""Recovery snapshots and iteration checkpoints: ``h2o_tpu_torch``'s
``core/recovery.py`` and its drivers' checkpoints held against
``h2o_tpu``'s on the CPU.

The same seeded numpy frame goes to both packages.  A build is killed by
a ``BaseException`` (the stand-in for the process dying: nothing in
either package may absorb it) raised from the call each package's
driver makes at the same point: the tree driver's ``train_forest``,
GLM's IRLSM pass or L-BFGS solve, DeepLearning's ``train_block``, a
grid builder's ``_fit``.  For one crash point, ``pending_recoveries``
reports the same kind, checkpoint presence and iteration summary in
both packages, and ``info.json`` the same keys (its ``mesh`` stamp is
the port's one-device geometry).  ``auto_recover`` then resumes the
port's build, which must be **bitwise** the port's uninterrupted build:
the resume continues the same key and state, so no tolerance applies.
The resumed GBM's trees are also held against the reference's
uninterrupted forest under ``tests/test_torch_gbm.py``'s tolerances
(split columns, thresholds, NA directions and bitsets equal; values
rtol 1e-4 / atol 1e-6: the two packages sum float32 tables in different
orders).  L-BFGS's iteration count at the checkpointed lambda is held
within 2 of the reference's, as ``tests/test_torch_glm.py`` holds it:
both end on float32 noise.
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from h2o_tpu.core import recovery as jrec
from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models import deeplearning as jdl_mod
from h2o_tpu.models import glm as jglm_mod
from h2o_tpu.models.deeplearning import DeepLearning as JDL
from h2o_tpu.models.glm import GLM as JGLM
from h2o_tpu.models.tree import jit_engine as jjit
from h2o_tpu.models.tree.drf import DRF as JDRF
from h2o_tpu.models.tree.gbm import GBM as JGBM

from h2o_tpu_torch.core import chaos, persist, recovery, resilience
from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.core.store import dkv, unpublish_on_exit
from h2o_tpu_torch.models import deeplearning as pdl_mod
from h2o_tpu_torch.models import glm as pglm_mod
from h2o_tpu_torch.models.deeplearning import DeepLearning
from h2o_tpu_torch.models.glm import GLM
from h2o_tpu_torch.models.grid import GridSearch
from h2o_tpu_torch.models.tree import driver as pdriver
from h2o_tpu_torch.models.tree.drf import DRF
from h2o_tpu_torch.models.tree.gbm import GBM

pytestmark = pytest.mark.shared_dkv

TREE_ARRAYS = ("split_col", "bitset", "value", "thr_bin", "na_left")


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset_chaos():
    yield
    chaos.reset()


class Crash(BaseException):
    """Process-death stand-in: not an Exception, so no layer absorbs it."""


@contextlib.contextmanager
def killed_at(module, name: str, call: int):
    """``module.name`` raises ``Crash`` at its ``call``-th call; restored
    on exit."""
    orig = getattr(module, name)
    seen = {"n": 0}

    def dying(*a, **k):
        seen["n"] += 1
        if seen["n"] == call:
            raise Crash(f"{name} call {call}")
        return orig(*a, **k)

    setattr(module, name, dying)
    try:
        yield
    finally:
        setattr(module, name, orig)


def _data(n=600, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    X[rng.uniform(size=n) < 0.05, 1] = np.nan
    cat = rng.integers(0, 5, n).astype(np.int32)
    logit = (1.5 * X[:, 0] - X[:, 2] + 0.8 * (cat % 2) +
             0.5 * np.nan_to_num(X[:, 1]))
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.int32)
    return X, cat, y


_NAMES = ["a", "b", "c", "d", "k", "y"]
_DOM = list("vwxyz")


def _frames(n=600, seed=0):
    X, cat, y = _data(n, seed)
    jv = [JVec(X[:, j]) for j in range(4)] + \
        [JVec(cat, J_CAT, domain=_DOM), JVec(y, J_CAT, domain=["n", "p"])]
    pv = [Vec(X[:, j]) for j in range(4)] + \
        [Vec(cat, T_CAT, domain=_DOM), Vec(y, T_CAT, domain=["n", "p"])]
    return JFrame(_NAMES, jv), Frame(_NAMES, pv)


def _crash_both(tmp_path, jcls, pcls, kw, jkill, pkill, label):
    """Kill the reference's and the port's build at the same call, each
    with its own recovery dir; returns their pending snapshots."""
    jf, pf = _frames()
    jdir, pdir = str(tmp_path / f"j_{label}"), str(tmp_path / f"p_{label}")
    with jkill, pytest.raises(Crash):
        jcls(recovery_dir=jdir, model_id=label, **kw).train(
            y="y", training_frame=jf)
    with pkill, pytest.raises(Crash):
        pcls(device="cpu", recovery_dir=pdir, model_id=label, **kw).train(
            y="y", training_frame=pf)
    jp, pp = jrec.pending_recoveries(jdir), recovery.pending_recoveries(pdir)
    assert len(jp) == 1 and len(pp) == 1
    return jp[0], pp[0], pdir, pf


def _same_snapshot(jp, pp, iter_keys):
    """The two packages' pending snapshots agree for one crash point."""
    assert pp["kind"] == jp["kind"] == "model"
    assert pp["has_iteration_checkpoint"] == jp["has_iteration_checkpoint"]
    for k in iter_keys:
        assert pp["iteration"][k] == jp["iteration"][k], k
    with open(os.path.join(pp["dir"], "info.json")) as f:
        p_info = json.load(f)
    with open(os.path.join(jp["dir"], "info.json")) as f:
        j_info = json.load(f)
    assert set(p_info) == set(j_info)
    assert p_info["extra"] == j_info["extra"]
    assert p_info["mesh"] == {"device_type": "cpu", "devices": 1,
                              "data_shards": 1, "row_quantum": 1}


def _bitwise(a, b, names=TREE_ARRAYS):
    for k in names:
        x, y = np.asarray(a.output[k]), np.asarray(b.output[k])
        assert x.shape == y.shape and x.tobytes() == y.tobytes(), k


# -- the tree driver --------------------------------------------------------

GBM_KW = dict(ntrees=6, max_depth=3, seed=7, checkpoint_interval=2)


def test_gbm_killed_at_block_two_resumes_bitwise(cl, tmp_path):
    """6 trees in blocks of 2, killed as block 2 of 3 launches: both
    packages checkpointed 2 trees; the resume equals the uninterrupted
    build with and without recovery_dir, bitwise, and the reference's
    forest within test_torch_gbm's tolerances."""
    jp, pp, pdir, pf = _crash_both(
        tmp_path, JGBM, GBM, GBM_KW, killed_at(jjit, "train_forest", 2),
        killed_at(pdriver, "train_forest", 2), "gbm_mid")
    _same_snapshot(jp, pp, ("kind", "trees_done", "ntrees"))
    assert pp["iteration"]["trees_done"] == 2
    resumed = recovery.auto_recover(pdir, device="cpu")
    assert len(resumed) == 1 and str(resumed[0].key) == "gbm_mid"
    m = resumed[0]
    assert m.output["ntrees_actual"] == 6
    assert recovery.pending_recoveries(pdir) == []
    kw = {k: v for k, v in GBM_KW.items() if k != "checkpoint_interval"}
    plain = GBM(device="cpu", **kw).train(y="y", training_frame=pf)
    with_rec = GBM(device="cpu", recovery_dir=str(tmp_path / "u"),
                   **GBM_KW).train(y="y", training_frame=pf)
    _bitwise(m, plain)
    _bitwise(m, with_rec, TREE_ARRAYS + ("node_gain", "node_w", "varimp"))
    assert m.predict_raw(pf).numpy().tobytes() == \
        plain.predict_raw(pf).numpy().tobytes()
    jf, _ = _frames()
    jm = JGBM(**kw).train(y="y", training_frame=jf)
    for k in ("split_col", "thr_bin", "na_left", "bitset"):
        np.testing.assert_array_equal(m.output[k], np.asarray(jm.output[k]),
                                      err_msg=k)
    np.testing.assert_allclose(m.output["value"],
                               np.asarray(jm.output["value"]),
                               rtol=1e-4, atol=1e-6)


def test_drf_killed_mid_forest_resumes_bitwise(cl, tmp_path):
    kw = dict(ntrees=4, max_depth=5, seed=3, checkpoint_interval=2)
    jp, pp, pdir, pf = _crash_both(
        tmp_path, JDRF, DRF, kw, killed_at(jjit, "train_forest", 2),
        killed_at(pdriver, "train_forest", 2), "drf_mid")
    _same_snapshot(jp, pp, ("kind", "trees_done", "ntrees"))
    m = recovery.auto_recover(pdir, device="cpu")[0]
    plain = DRF(device="cpu", **{k: v for k, v in kw.items()
                                 if k != "checkpoint_interval"}).train(
        y="y", training_frame=pf)
    _bitwise(m, plain)
    assert m.predict_raw(pf).numpy().tobytes() == \
        plain.predict_raw(pf).numpy().tobytes()


def test_early_stopped_gbm_resumes_to_the_same_tree(cl, tmp_path):
    """Scoring every 2 trees with stopping_rounds 2: the resumed build
    carries F, the scorer's F and the ScoreKeeper's history, so it stops
    at the uninterrupted build's tree with the same history."""
    _, pf = _frames()
    kw = dict(ntrees=60, max_depth=4, seed=1, learn_rate=0.1,
              stopping_rounds=2, stopping_metric="AUC",
              stopping_tolerance=1e-2, score_tree_interval=2,
              checkpoint_interval=2)
    full = GBM(device="cpu", recovery_dir=str(tmp_path / "u"), **kw).train(
        y="y", training_frame=pf)
    stop = full.output["ntrees_actual"]
    assert 6 < stop < 60
    d = str(tmp_path / "es")
    with killed_at(pdriver, "train_forest", 3), pytest.raises(Crash):
        GBM(device="cpu", recovery_dir=d, model_id="gbm_es", **kw).train(
            y="y", training_frame=pf)
    assert recovery.pending_recoveries(d)[0]["iteration"]["trees_done"] == 4
    m = recovery.auto_recover(d, device="cpu")[0]
    assert m.output["ntrees_actual"] == stop
    strip = [{k: v for k, v in r.items() if k != "timestamp"}
             for r in full.output["scoring_history"]]
    assert [{k: v for k, v in r.items() if k != "timestamp"}
            for r in m.output["scoring_history"]] == strip
    _bitwise(m, full)


def test_torn_checkpoints(cl, tmp_path):
    """A write torn at the crash leaves ``iter.pkl.tmp`` beside the last
    good ``iter.pkl`` (writes are a rename): the resume starts from that
    boundary.  An unreadable ``iter.pkl`` starts the build over; both
    resumes are bitwise the uninterrupted build.  An unreadable
    ``info.json`` is skipped by both packages' discovery."""
    _, pf = _frames()
    plain = GBM(device="cpu", ntrees=6, max_depth=3, seed=7).train(
        y="y", training_frame=pf)
    for i, tear in enumerate(("tmp", "pkl")):
        d = str(tmp_path / f"torn_{tear}")
        with killed_at(pdriver, "train_forest", 3), pytest.raises(Crash):
            GBM(device="cpu", recovery_dir=d, model_id=f"gbm_torn{i}",
                **GBM_KW).train(y="y", training_frame=pf)
        snap = recovery.pending_recoveries(d)[0]
        assert snap["iteration"]["trees_done"] == 4
        name = "iter.pkl.tmp" if tear == "tmp" else "iter.pkl"
        with open(os.path.join(snap["dir"], name), "wb") as f:
            f.write(b"\x80\x04\x95 torn")
        rec = recovery.Recovery(d, "model", f"gbm_torn{i}", "cpu")
        assert (rec.load_iteration() is None) == (tear == "pkl")
        m = recovery.auto_recover(d, device="cpu")[0]
        _bitwise(m, plain)
    d = tmp_path / "torn_info"
    for pkg in (recovery, jrec):
        good = pkg.Recovery(str(d), "model", "fine")
        with open(os.path.join(good.dir, "info.json"), "w") as f:
            json.dump({"kind": "model", "job_id": "fine", "started": 1.0,
                       "done": False, "models": []}, f)
        bad = os.path.join(str(d), "model_torn")
        os.makedirs(bad, exist_ok=True)
        with open(os.path.join(bad, "info.json"), "w") as f:
            f.write('{"kind": "model", "job_')
        got = pkg.pending_recoveries(str(d))
        assert [g["job_id"] for g in got] == ["fine"]


def test_snapshot_needing_more_devices_is_skipped(cl, tmp_path):
    """A snapshot stamped with more row shards than this process has
    devices (the reference's 8-shard CPU mesh) is skipped."""
    jf, pf = _frames()
    d = str(tmp_path / "mesh")
    jr = jrec.Recovery(d, "model", "from_pod")
    jr.begin(dict(ntrees=2), jf, extra={"algo": "gbm", "x": None,
                                         "y": "y"})
    with open(os.path.join(jr.dir, "info.json")) as f:
        assert json.load(f)["mesh"]["data_shards"] > 1
    assert recovery.pending_recoveries(d) == []
    pr = recovery.Recovery(d, "model", "here", "cpu")
    pr.begin(dict(ntrees=2), pf, extra={"algo": "gbm", "x": None, "y": "y"})
    assert [i["job_id"] for i in recovery.pending_recoveries(d)] == ["here"]


def test_snapshot_frame_is_stored_and_loads_in_both_packages(cl, tmp_path):
    """The recovery snapshot's frame is an uncompressed npz (zlib costs
    seconds on a million rows of floats); both packages' ``load_frame``
    read it back equal to the frame."""
    import zipfile
    from h2o_tpu.core import persist as jpersist
    _, pf = _frames()
    rec = recovery.Recovery(str(tmp_path), "model", "stored", "cpu")
    rec.begin(dict(ntrees=2), pf, extra={"algo": "gbm", "x": None,
                                         "y": "y"})
    path = os.path.join(rec.dir, "train")
    with zipfile.ZipFile(os.path.join(path, "columns.npz")) as z:
        assert {i.compress_type for i in z.infolist()} == {zipfile.ZIP_STORED}
    for load in (persist.load_frame, jpersist.load_frame):
        back = load(path)
        assert back.names == pf.names
        for n in pf.names:
            np.testing.assert_array_equal(np.asarray(back.vec(n).to_numpy()),
                                          np.asarray(pf.vec(n).to_numpy()))


# -- GLM and DeepLearning ----------------------------------------------------

def test_glm_irlsm_killed_at_iteration_three(cl, tmp_path):
    """The lambda_max pass is call 1 and iteration 0's pass; the third
    call is iteration 2's: both packages checkpointed iteration 1."""
    kw = dict(family="binomial")
    jp, pp, pdir, pf = _crash_both(
        tmp_path, JGLM, GLM, kw, killed_at(jglm_mod, "_irlsm_pass", 3),
        killed_at(pglm_mod, "_irlsm_pass", 3), "glm_irlsm")
    _same_snapshot(jp, pp, ("kind", "iteration"))
    assert pp["iteration"]["iteration"] == 1
    np.testing.assert_allclose(pp["iteration"]["lambda"],
                               jp["iteration"]["lambda"], rtol=1e-5)
    m = recovery.auto_recover(pdir, device="cpu")[0]
    plain = GLM(device="cpu", **kw).train(y="y", training_frame=pf)
    assert m.output["beta"].tobytes() == plain.output["beta"].tobytes()
    assert m.predict_raw(pf).numpy().tobytes() == \
        plain.predict_raw(pf).numpy().tobytes()


def test_glm_lbfgs_killed_mid_lambda_search(cl, tmp_path):
    """L-BFGS checkpoints once a lambda; killed in the third lambda's
    solve, both packages hold the second lambda's checkpoint.  The
    lambda path's position is not carried (the reference's resume
    restarts the walk and overwrites the checkpoint at its first
    lambda), so the resumed walk is the uninterrupted one."""
    kw = dict(family="binomial", solver="L_BFGS", alpha=0.0,
              lambda_search=True, nlambdas=5)
    jp, pp, pdir, pf = _crash_both(
        tmp_path, JGLM, GLM, kw, killed_at(jglm_mod, "_lbfgs_minimize", 3),
        killed_at(pglm_mod, "_lbfgs_minimize", 3), "glm_lbfgs")
    _same_snapshot(jp, pp, ("kind",))
    assert pp["iteration"]["kind"] == "glm-lbfgs"
    assert abs(pp["iteration"]["iteration"] -
               jp["iteration"]["iteration"]) <= 2
    np.testing.assert_allclose(pp["iteration"]["lambda"],
                               jp["iteration"]["lambda"], rtol=1e-5)
    m = recovery.auto_recover(pdir, device="cpu")[0]
    plain = GLM(device="cpu", **kw).train(y="y", training_frame=pf)
    assert m.output["beta"].tobytes() == plain.output["beta"].tobytes()


def test_glm_lbfgs_killed_after_its_solve(cl, tmp_path):
    """One lambda, killed after the solve's checkpoint (in the final
    deviance pass): the resume restarts L-BFGS from the checkpointed
    optimum, whose gradient is below gtol, and ends on the same beta."""
    _, pf = _frames()
    kw = dict(family="binomial", solver="L_BFGS", alpha=0.0, lambda_=1e-3)
    d = str(tmp_path / "lbfgs1")
    with killed_at(pglm_mod, "_deviance_at", 1), pytest.raises(Crash):
        GLM(device="cpu", recovery_dir=d, model_id="glm_l1", **kw).train(
            y="y", training_frame=pf)
    snap = recovery.pending_recoveries(d)[0]
    assert snap["iteration"]["kind"] == "glm-lbfgs"
    m = recovery.auto_recover(d, device="cpu")[0]
    plain = GLM(device="cpu", **kw).train(y="y", training_frame=pf)
    assert m.output["beta"].tobytes() == plain.output["beta"].tobytes()


def test_deeplearning_killed_after_its_first_block(cl, tmp_path):
    """Two blocks of steps (BLOCK_STEPS 200), killed as the second
    starts: both packages checkpointed step 200 of the same total."""
    kw = dict(hidden=[8], epochs=300.0, seed=1, reproducible=True)
    jp, pp, pdir, pf = _crash_both(
        tmp_path, JDL, DeepLearning, kw, killed_at(jdl_mod, "train_block", 2),
        killed_at(pdl_mod, "train_block", 2), "dl_mid")
    _same_snapshot(jp, pp, ("kind", "step", "steps"))
    assert pp["iteration"]["step"] == 200 < pp["iteration"]["steps"]
    m = recovery.auto_recover(pdir, device="cpu")[0]
    plain = DeepLearning(device="cpu", **kw).train(y="y", training_frame=pf)
    for a, b in zip(m.output["weights"], plain.output["weights"]):
        assert a["W"].tobytes() == b["W"].tobytes()
        assert a["b"].tobytes() == b["b"].tobytes()


# -- the grid ----------------------------------------------------------------

def _crashy_gbm(at: int):
    calls = {"n": 0}

    class CrashyGBM(GBM):
        def _fit(self, *a, **k):
            calls["n"] += 1
            if calls["n"] == at:
                raise Crash("grid model")
            return super()._fit(*a, **k)

    return CrashyGBM


def _killed_grid(pf, rec_dir: str, grid_id: str):
    gs = GridSearch(_crashy_gbm(3), {"ntrees": [2, 3, 4]}, max_depth=2,
                    seed=1, recovery_dir=rec_dir, grid_id=grid_id,
                    device="cpu")
    with pytest.raises(Crash):
        gs.train(y="y", training_frame=pf)
    grid = dkv().get(grid_id)
    assert grid is not None and len(grid.models) == 2
    # a restarted process: the grid and its models are gone
    dkv().remove(grid_id)
    for m in grid.models:
        dkv().remove(str(m.key))
    return grid


def _same_grid(got, want):
    assert len(got.models) == len(want.models)
    by_n = {int(m.params["ntrees"]): m for m in want.models}
    for m in got.models:
        _bitwise(m, by_n[int(m.params["ntrees"])])
    assert [int(m.params["ntrees"]) for m in got.sorted_models()] == \
        [int(m.params["ntrees"]) for m in want.sorted_models()]


@pytest.mark.parametrize("how", ["auto_recover", "resume_grid"])
def test_killed_grid_resumes_the_remaining_combos(cl, tmp_path, how):
    _, pf = _frames()
    want = GridSearch("gbm", {"ntrees": [2, 3, 4]}, max_depth=2, seed=1,
                      grid_id=f"want_{how}", device="cpu").train(
        y="y", training_frame=pf)
    d = str(tmp_path / "grid")
    old = _killed_grid(pf, d, f"killed_{how}")
    snap = recovery.pending_recoveries(d)[0]
    assert snap["kind"] == "grid" and len(snap["models"]) == 2
    trained = []
    orig = GBM._fit

    def counting(self, *a, **k):
        trained.append(int(self.params["ntrees"]))
        return orig(self, *a, **k)

    GBM._fit = counting
    try:
        if how == "auto_recover":
            got = recovery.auto_recover(d, device="cpu")[0]
        else:
            got = recovery.resume_grid(f"killed_{how}", d,
                                       device="cpu").join()
    finally:
        GBM._fit = orig
    assert trained == [4]                  # the remaining combo only
    assert dkv().get(f"killed_{how}") is got and len(got.models) == 3
    for a, b in zip(got.models[:2], old.models):
        assert str(a.key) == str(b.key)
        _bitwise(a, b)
    _same_grid(got, want)
    assert recovery.pending_recoveries(d) == []
    with pytest.raises(KeyError):
        recovery.resume_grid("no_such_grid", d, device="cpu")


# -- persist faults ----------------------------------------------------------

def test_persist_chaos_soak(cl, tmp_path):
    """tests/test_chaos.py's drill on the port: under two transient
    faults a write, a frame snapshot round-trips and a GBM whose
    snapshot and checkpoints all meet the faults completes; the
    counters equal the reference's for the same build."""
    from h2o_tpu.core import chaos as jchaos, persist as jpersist, \
        resilience as jresilience
    jf, pf = _frames(300)
    counts = []
    for pkg_chaos, pkg_persist, pkg_res, builder, fr, kw in (
            (jchaos, jpersist, jresilience, JGBM, jf, {}),
            (chaos, persist, resilience, GBM, pf, dict(device="cpu"))):
        pkg_res.reset_stats()
        pkg_chaos.configure(persist_transient=2, seed=0)
        tag = "j" if builder is JGBM else "p"
        pkg_persist.save_frame(fr, str(tmp_path / f"snap_{tag}"))
        back = pkg_persist.load_frame(str(tmp_path / f"snap_{tag}"))
        np.testing.assert_array_equal(np.asarray(back.vec("a").to_numpy()),
                                      np.asarray(fr.vec("a").to_numpy()))
        m = builder(ntrees=4, max_depth=2, seed=1,
                    recovery_dir=str(tmp_path / f"rec_{tag}"),
                    checkpoint_interval=2, **kw).train(
            y="y", training_frame=fr)
        assert m.output["ntrees_actual"] == 4
        c, st = pkg_chaos.chaos(), pkg_res.stats()
        assert c.injected_persist >= 6
        assert st["retries"] >= c.injected_persist
        assert st["recoveries"] >= 3 and st["giveups"] == 0
        counts.append((c.injected_persist, st["retries"], st["recoveries"],
                       st["giveups"]))
        pkg_chaos.reset()
    assert counts[0] == counts[1]
