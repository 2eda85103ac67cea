"""The leaderboard and segment models in the port, held against
``h2o_tpu``'s on the CPU on the same seeded inputs.

- Leaderboard (``tests/test_automl.py:57-70``'s case: a 10-tree GBM and
  a binomial GLM on 2,000 x 5 rows from ``default_rng(42)``; each given
  the same ``model_id`` in both packages): rows in the reference's
  order with its columns, metrics within 1e-5; the leader; ``to_dict``;
  ``scoring_data`` pinned to train; an explicit sort metric; ranking on
  a ``leaderboard_frame`` (metrics within 1e-5); a regression board
  sorted by deviance.  The two models' AUCs differ by more than 1e-5,
  so the order is determined.
- Segment models on a 3-level categorical (``train_segments`` driven
  through a job of each package's registry, as the reference's REST
  handler drives it): the segments, statuses and errors equal; each
  segment's GBM has the reference's trees (split columns, bins, NA
  directions and bitsets equal, values rtol 1e-4 / atol 1e-6) and
  equals, bitwise, a GBM trained alone on that segment's rows;
  ``to_frame`` has the reference's names, types and domains (the model
  ids apart, which are random in both); a level given through
  ``segments_frame`` that no row holds is ``FAILED`` with ``"empty
  segment"``; ``parallelism=2`` gives the same forests; the job ends at
  progress 1 after a report a segment.

Every model and collection a test publishes is removed from the port's
DKV after it.
"""

import sys

import numpy as np
import pytest
import torch

from h2o_tpu.core.cloud import cloud as j_cloud
from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.core.job import Job as JJob
from h2o_tpu.models.glm import GLM as JGLM
from h2o_tpu.models.leaderboard import Leaderboard as JLeaderboard
from h2o_tpu.models.segment import train_segments as j_train_segments
from h2o_tpu.models.tree.gbm import GBM as JGBM

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.core.job import DONE, Job, jobs
from h2o_tpu_torch.core.store import dkv as p_dkv, unpublish_on_exit
from h2o_tpu_torch.models.glm import GLM
from h2o_tpu_torch.models.leaderboard import Leaderboard
from h2o_tpu_torch.models.segment import train_segments
from h2o_tpu_torch.models.tree.gbm import GBM


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv

_TREE_KEYS = ("split_col", "thr_bin", "na_left", "bitset")
_METRIC_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bin_frames(n=2000, seed=42, regression=False):
    """``tests/test_automl.py``'s ``bin_frame`` in both packages (a
    float response when ``regression``)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5)).astype(np.float32)
    logits = 1.5 * X[:, 0] - X[:, 1] + X[:, 2] * X[:, 3]
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(np.int32)
    names = [f"x{j}" for j in range(5)] + ["y"]
    jv = [JVec(X[:, j]) for j in range(5)]
    pv = [Vec(X[:, j]) for j in range(5)]
    if regression:
        jv.append(JVec(logits.astype(np.float32)))
        pv.append(Vec(logits.astype(np.float32)))
    else:
        jv.append(JVec(y, J_CAT, domain=["no", "yes"]))
        pv.append(Vec(y, T_CAT, domain=["no", "yes"]))
    return JFrame(names, jv), Frame(names, pv)


def _assert_rows(prows, jrows):
    assert [r["model_id"] for r in prows] == [r["model_id"] for r in jrows]
    for p, j in zip(prows, jrows):
        assert list(p) == list(j)
        assert p["algo"] == j["algo"]
        for k, v in j.items():
            if k in ("model_id", "algo", "training_time_ms"):
                continue
            if np.isnan(v):             # RMSLE of negative responses
                assert np.isnan(p[k]), k
            else:
                assert abs(p[k] - v) <= _METRIC_TOL * max(1.0, abs(v)), k
        assert p["training_time_ms"] > 0


@pytest.fixture(scope="module")
def boards(cl):
    """The test_automl case's two models in both packages, and a
    regression pair; published for the module, removed after it."""
    out = {}
    with unpublish_on_exit():
        for kind in ("binomial", "regression"):
            jf, pf = _bin_frames(regression=kind == "regression")
            fam = "binomial" if kind == "binomial" else "gaussian"
            gk = dict(ntrees=10, max_depth=3, seed=1,
                      model_id=f"lb_gbm_{kind}")
            lk = dict(family=fam, model_id=f"lb_glm_{kind}")
            out[kind] = (jf, pf,
                         [JGBM(**gk).train(y="y", training_frame=jf),
                          JGLM(**lk).train(y="y", training_frame=jf)],
                         [GBM(device="cpu", **gk).train(
                             y="y", training_frame=pf),
                          GLM(device="cpu", **lk).train(
                              y="y", training_frame=pf)])
        yield out


def test_leaderboard_ranking_as_reference(boards):
    _, _, jms, pms = boards["binomial"]
    jlb, plb = JLeaderboard("t"), Leaderboard("t")
    jlb.add(*jms)
    plb.add(*pms, pms[0])                   # a second add is ignored
    assert len(plb.models) == 2
    prows, jrows = plb.rows(), jlb.rows()
    _assert_rows(prows, jrows)
    assert abs(prows[0]["auc"] - prows[1]["auc"]) > _METRIC_TOL
    assert prows[0]["auc"] >= prows[1]["auc"]
    assert list(prows[0]) == ["model_id", "algo", "auc", "logloss",
                              "pr_auc", "mean_per_class_error", "rmse",
                              "mse", "training_time_ms"]
    assert str(plb.leader.key) == str(jlb.leader.key)
    d = plb.to_dict()
    assert d["sort_metric"] == jlb.to_dict()["sort_metric"] == "auc"
    assert d["project_name"] == "t" and d["models"] == prows
    assert str(plb.key).startswith("leaderboard_t_")
    assert "<Leaderboard t sort=auc>" in repr(plb)


@pytest.mark.parametrize("how", ["train", "logloss", "frame"])
def test_leaderboard_sources_as_reference(boards, how):
    _, _, jms, pms = boards["binomial"]
    if how == "frame":
        jlf, plf = _bin_frames(n=700, seed=9)
        jlb = JLeaderboard("f", leaderboard_frame=jlf)
        plb = Leaderboard("f", leaderboard_frame=plf)
    elif how == "train":
        jlb = JLeaderboard("s", scoring_data="train")
        plb = Leaderboard("s", scoring_data="train")
    else:
        jlb = JLeaderboard("m", sort_metric="logloss")
        plb = Leaderboard("m", sort_metric="logloss")
    jlb.add(*jms)
    plb.add(*pms)
    _assert_rows(plb.rows(), jlb.rows())
    assert plb.to_dict()["sort_metric"] == jlb.to_dict()["sort_metric"]
    if how == "train":
        xval = Leaderboard("x", scoring_data="xval")
        xval.add(pms[0])
        with pytest.raises(ValueError, match="no xval metrics"):
            xval.rows()


def test_regression_leaderboard_as_reference(boards):
    _, _, jms, pms = boards["regression"]
    jlb, plb = JLeaderboard("r"), Leaderboard("r")
    jlb.add(*jms)
    plb.add(*pms)
    prows = plb.rows()
    _assert_rows(prows, jlb.rows())
    assert plb.to_dict()["sort_metric"] == "deviance"
    assert prows[0]["mean_residual_deviance"] <= \
        prows[1]["mean_residual_deviance"]
    assert Leaderboard("empty").to_dict() == {
        "project_name": "empty", "sort_metric": "mse", "models": []}


# -- segment models -----------------------------------------------------------

_SEG_PARAMS = dict(ntrees=5, max_depth=3, seed=1)
_LEVELS = ["a", "b", "c"]


def _seg_frames(n=1800):
    rng = np.random.default_rng(3)
    X = rng.normal(size=(n, 3)).astype(np.float32)
    seg = rng.integers(0, 3, n).astype(np.int32)
    logit = X[:, 0] * (seg - 1.0) + X[:, 1]
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.int32)
    names = ["x0", "x1", "x2", "seg", "y"]
    return (JFrame(names, [JVec(X[:, j]) for j in range(3)] +
                   [JVec(seg, J_CAT, domain=_LEVELS),
                    JVec(y, J_CAT, domain=["n", "p"])]),
            Frame(names, [Vec(X[:, j]) for j in range(3)] +
                  [Vec(seg, T_CAT, domain=_LEVELS),
                   Vec(y, T_CAT, domain=["n", "p"])]))


def _segments_frame(pkg_frame, pkg_vec, cat):
    """Segments ``a`` and a level no row holds."""
    return pkg_frame(["seg"], [pkg_vec(np.array([0, 1], np.int32), cat,
                                       domain=["a", "zz"])])


def _run_both(dest, segments=False, parallelism=1):
    """``train_segments`` as a job in each package: (reference
    collection, port collection, port job, the port's frame)."""
    jf, pf = _seg_frames()
    jseg = _segments_frame(JFrame, JVec, J_CAT) if segments else None
    pseg = _segments_frame(Frame, Vec, T_CAT) if segments else None
    cols = [] if segments else ["seg"]
    jjob = JJob(dest=dest, description="segments")
    j_cloud().jobs.start(jjob, lambda j: j_train_segments(
        j, JGBM, dict(_SEG_PARAMS), None, "y", jf, None, cols, jseg,
        dest, parallelism))
    pjob = Job(dest=dest, description="segments")
    jobs().start(pjob, lambda j: train_segments(
        j, GBM, dict(_SEG_PARAMS, device="cpu"), None, "y", pf, None,
        cols, pseg, dest, parallelism))
    return jjob.join(), pjob.join(), pjob, pf


@pytest.fixture(scope="module")
def segments(cl):
    """The 3-level case in both packages, with the reference's segment
    models' outputs as numpy."""
    with unpublish_on_exit():
        jsm, psm, pjob, pf = _run_both("segs")
        jouts = [{k: np.asarray(v) for k, v in j_cloud().dkv.get(
            r["model_id"]).output.items() if k in _TREE_KEYS + ("value",)}
            for r in jsm.rows]
        yield jsm, psm, pjob, pf, jouts


def test_segment_models_as_reference(segments):
    jsm, psm, pjob, pf, jouts = segments
    assert pjob.status == DONE and pjob.progress == 1.0
    assert pjob.progress_msg == "3/3 segments"
    assert p_dkv().get("segs") is psm
    assert psm.segment_columns == jsm.segment_columns == ["seg"]
    assert [r["segment"] for r in psm.rows] == \
        [r["segment"] for r in jsm.rows] == [{"seg": s} for s in _LEVELS]
    for pr, jr, jo in zip(psm.rows, jsm.rows, jouts):
        assert (pr["status"], pr["errors"]) == \
            (jr["status"], jr["errors"]) == ("SUCCEEDED", "")
        pm = p_dkv().get(pr["model_id"])
        for k in _TREE_KEYS:
            np.testing.assert_array_equal(pm.output[k], jo[k], err_msg=k)
        np.testing.assert_allclose(pm.output["value"], jo["value"],
                                   rtol=1e-4, atol=1e-6)
        assert pm.output["x"] == ["x0", "x1", "x2"]


def test_segment_model_equals_a_gbm_on_its_rows(segments):
    _, psm, _, pf, _ = segments
    codes = pf.vec("seg").data
    for i, row in enumerate(psm.rows):
        sub = pf.slice_rows(codes == i).drop(["seg"])
        alone = GBM(device="cpu", **_SEG_PARAMS).train(
            y="y", training_frame=sub)
        m = p_dkv().get(row["model_id"])
        for k in _TREE_KEYS + ("value",):
            a, b = np.asarray(m.output[k]), np.asarray(alone.output[k])
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), k


def test_segment_frame_as_reference(segments):
    jsm, psm, _, _, _ = segments
    jfr, pfr = jsm.to_frame(), psm.to_frame()
    assert pfr.names == jfr.names == ["seg", "model", "status", "errors",
                                      "warnings"]
    for n in pfr.names:
        pv, jv = pfr.vec(n), jfr.vec(n)
        assert pv.type == jv.type, n
        if n != "model":
            assert pv.domain == jv.domain, n
            np.testing.assert_array_equal(
                pv.to_numpy(), np.asarray(jv.to_numpy())[: pfr.nrows])
    assert [pfr.vec("model").domain[c] for c in pfr.vec("model").data] == \
        [r["model_id"] for r in psm.rows]


def test_empty_segment_fails_alone(cl):
    with unpublish_on_exit():
        jsm, psm, pjob, _ = _run_both("segs_empty", segments=True)
    assert [(r["segment"], r["status"], r["errors"]) for r in psm.rows] == \
        [(r["segment"], r["status"], r["errors"]) for r in jsm.rows] == \
        [({"seg": "a"}, "SUCCEEDED", ""),
         ({"seg": "zz"}, "FAILED", "empty segment")]
    assert pjob.status == DONE and pjob.progress_msg == "2/2 segments"
    fr = psm.to_frame()
    assert fr.vec("status").domain == ["FAILED", "SUCCEEDED"]
    assert fr.vec("errors").domain == ["", "empty segment"]


def test_parallel_segments_give_the_same_forests(segments):
    _, psm, _, _, _ = segments
    _, pf = _seg_frames()
    job = Job(dest="segs_par", description="segments")
    jobs().start(job, lambda j: train_segments(
        j, GBM, dict(_SEG_PARAMS, device="cpu"), None, "y", pf, None,
        ["seg"], None, "segs_par", 2))
    par = job.join()
    for a, b in zip(par.rows, psm.rows):
        assert a["segment"] == b["segment"] and a["status"] == "SUCCEEDED"
        ma, mb = p_dkv().get(a["model_id"]), p_dkv().get(b["model_id"])
        for k in _TREE_KEYS + ("value",):
            x, y = np.asarray(ma.output[k]), np.asarray(mb.output[k])
            assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), k


def test_parallel_segments_stress_count_every_segment(cl):
    """More workers than cores, a short switch interval: every segment
    trains once, its row names its own model, and the reports count up
    to the last segment."""
    rng = np.random.default_rng(11)
    n, levels = 3200, 32
    seg = np.repeat(np.arange(levels, dtype=np.int32), n // levels)
    x = rng.normal(size=n).astype(np.float32)
    y = (x + rng.normal(size=n) > 0).astype(np.int32)
    dom = [f"s{j:02d}" for j in range(levels)]
    pf = Frame(["x", "seg", "y"], [Vec(x), Vec(seg, T_CAT, domain=dom),
                                   Vec(y, T_CAT, domain=["n", "p"])])
    job = Job(dest="segs_stress", description="segments")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        jobs().start(job, lambda j: train_segments(
            j, GBM, dict(ntrees=1, max_depth=1, seed=1, device="cpu"),
            None, "y", pf, None, ["seg"], None, "segs_stress", 16))
        sm = job.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert job.status == DONE
    assert job.progress_msg == f"{levels}/{levels} segments"
    assert [r["segment"]["seg"] for r in sm.rows] == dom
    assert all(r["status"] == "SUCCEEDED" for r in sm.rows)
    ids = [r["model_id"] for r in sm.rows]
    assert len(set(ids)) == levels
    for r in sm.rows:
        m = p_dkv().get(r["model_id"])
        assert m.output["training_metrics"]["nobs"] == n // levels
