"""AutoML in the port held against ``h2o_tpu``'s on the CPU, on the same
seeded inputs (the target-encoding case is
``tests/test_torch_automl_te.py``).

- The modeling plan: ``_default_plan(seed)`` has the reference's steps,
  algos, parameters, grids, grid caps and work weights, and
  ``_EXPLOITATION_RATIO`` is the reference's.
- ``tests/test_automl.py:72-89``'s case (``max_models=4``, ``nfolds=3``,
  ``seed=42``, GLM, GBM and stacked ensembles on 2,000 x 5 rows from
  ``default_rng(42)``).  Both packages run the plan with every
  ``ntrees`` cut to 5: the reference spends 10-25 s compiling each GBM
  shape on the CPU mesh and 0.3-0.5 s a depth-6 tree, 200 trees a
  default GBM with 3-fold CV.  The steps, the grid's shuffle, the fold
  column and the ensembles are the plan's.  Held: the same event
  stages and messages (model keys and seconds masked), the same models
  per step with the same parameters, every model's cross-validation
  metrics within 1e-5 of the reference's (``_METRIC_TOL``), the
  leaderboard in the reference's order wherever two rows' sort metrics
  differ by more than that tolerance (either order where they do not),
  both ensembles, the leader, and ``to_dict``.
- The exploitation phase (port alone; the reference's run of it costs
  ~75 s of compiles): with ``max_models=9`` the plan's GLM and GBMs fill
  7 and the phase trains the best GBM's two neighbours by the
  reference's rule (``automl.py:391-411``).
- The leader among the base models, retrained alone with its params on
  the shared fold column, gives the same forest or coefficients,
  bitwise.

Every model and frame a test publishes is removed from the port's DKV
after it.
"""

import re

import numpy as np
import pytest
import torch

from h2o_tpu.automl import automl as j_automl
from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec

from h2o_tpu_torch.automl import automl as p_automl
from h2o_tpu_torch.automl.automl import AutoML
from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.core.store import dkv as p_dkv, unpublish_on_exit
from h2o_tpu_torch.models.registry import builder_class


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv

_METRIC_TOL = 1e-5
_CUT_TREES = 5
_KEY = re.compile(r"\b(glm|gbm|targetencoder)_[0-9a-f]{12}\b")
_SECONDS = re.compile(r"\d+\.\ds")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bin_frames(n=2000):
    """``tests/test_automl.py``'s ``bin_frame`` in both packages."""
    rng = np.random.default_rng(42)
    X = rng.normal(size=(n, 5)).astype(np.float32)
    logits = 1.5 * X[:, 0] - X[:, 1] + X[:, 2] * X[:, 3]
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(np.int32)
    names = [f"x{j}" for j in range(5)] + ["y"]
    return (JFrame(names, [JVec(X[:, j]) for j in range(5)] +
                   [JVec(y, J_CAT, domain=["no", "yes"])]),
            Frame(names, [Vec(X[:, j]) for j in range(5)] +
                  [Vec(y, T_CAT, domain=["no", "yes"])]))


def _cut(plan_fn):
    """``plan_fn`` with every step's ``ntrees`` cut to ``_CUT_TREES``."""
    def plan(seed):
        out = plan_fn(seed)
        for item in out:
            if "ntrees" in item["params"]:
                item["params"] = dict(item["params"], ntrees=_CUT_TREES)
        return out
    return plan


_CASE = dict(max_models=4, seed=42, nfolds=3, project_name="t1",
             include_algos=["glm", "gbm", "stackedensemble"])


@pytest.fixture(scope="module")
def run(cl):
    """The case in both packages, the plans cut alike, and the port's
    exploitation run; published for the module, removed after it."""
    mp = pytest.MonkeyPatch()
    mp.setattr(j_automl, "_default_plan", _cut(j_automl._default_plan))
    mp.setattr(p_automl, "_default_plan", _cut(p_automl._default_plan))
    try:
        with unpublish_on_exit():
            jf, pf = _bin_frames()
            ja = j_automl.AutoML(**_CASE).train(y="y", training_frame=jf)
            pa = AutoML(device="cpu", **_CASE).train(y="y",
                                                     training_frame=pf)
            ex = AutoML(device="cpu", **dict(
                _CASE, max_models=9, project_name="ex")).train(
                y="y", training_frame=pf)
            yield ja, pa, ja.leaderboard.rows(), pf, ex
    finally:
        mp.undo()


def test_plan_is_the_references():
    for seed in (-1, 0, 42):
        assert p_automl._default_plan(seed) == j_automl._default_plan(seed)
    assert p_automl._EXPLOITATION_RATIO == j_automl._EXPLOITATION_RATIO


def _events(aml):
    return [(e["stage"], _SECONDS.sub("<s>", _KEY.sub(r"\1_<key>",
                                                      e["message"])))
            for e in aml.event_log.events]


def test_steps_and_models_as_reference(run):
    ja, pa, _, _, _ = run
    assert _events(pa) == _events(ja)
    assert [s for s, _ in _events(pa)] == [
        "init", "init", "def_glm", "def_gbm_1", "def_gbm_2", "grid_gbm",
        "ensemble", "ensemble", "done"]
    jm, pm = ja.leaderboard.models, pa.leaderboard.models
    assert [m.algo for m in pm] == [m.algo for m in jm]
    for a, b in zip(pm, jm):
        assert p_dkv().get(a.model_id) is a
        if a.algo == "stackedensemble":
            assert a.model_id == str(b.key)
            continue
        pp = {k: v for k, v in a.params.items() if k in b.params and
              k not in ("model_id", "response_column")}
        assert pp == {k: b.params[k] for k in pp}, a.algo


def test_leaderboard_as_reference(run):
    ja, pa, jrows, _, _ = run
    prows = pa.leaderboard.rows()
    assert len(prows) == len(jrows) == 6
    metric = pa.leaderboard.to_dict()["sort_metric"]
    assert metric == ja.leaderboard.to_dict()["sort_metric"] == "auc"
    # a row's model by its place in the run (the keys are random)
    p_at = [[str(m.key) for m in pa.leaderboard.models].index(r["model_id"])
            for r in prows]
    j_at = [[str(m.key) for m in ja.leaderboard.models].index(r["model_id"])
            for r in jrows]
    by_step = {i: r for i, r in zip(p_at, prows)}
    for i, jr in zip(j_at, jrows):
        for k, v in jr.items():
            if k not in ("model_id", "algo", "training_time_ms"):
                assert abs(by_step[i][k] - v) <= \
                    _METRIC_TOL * max(1.0, abs(v)), (i, k)
    # the reference's order wherever two neighbours' metrics are apart
    vals = [r[metric] for r in jrows]
    for a in range(len(vals) - 1):
        if abs(vals[a] - vals[a + 1]) > _METRIC_TOL:
            assert p_at.index(j_at[a]) < p_at.index(j_at[a + 1]), a
    got = [r[metric] for r in prows]
    assert got == sorted(got, reverse=True)
    d = pa.to_dict()
    assert d["leader"] == str(pa.leader.key) == prows[0]["model_id"]
    assert d["project_name"] == ja.to_dict()["project_name"] == "t1"
    assert d["leaderboard"] == pa.leaderboard.to_dict()
    assert p_dkv().get("t1") is pa and p_dkv().get(pa.key) is pa


def test_ensembles_and_cv_metrics(run):
    _, pa, _, _, _ = run
    ids = [str(m.key) for m in pa.leaderboard.models]
    for name in ("BestOfFamily", "AllModels"):
        assert f"StackedEnsemble_{name}_t1" in ids
    bof = p_dkv().get("StackedEnsemble_BestOfFamily_t1")
    assert sorted(m.algo for m in bof.output["base_models"]) == \
        ["gbm", "glm"]
    rows = {r["model_id"]: r for r in pa.leaderboard.rows()}
    for m in pa.leaderboard.models:
        if m.algo != "stackedensemble":
            assert rows[m.model_id]["auc"] == \
                m.output["cross_validation_metrics"]["AUC"]
            assert m.params["fold_column"] == "__automl_fold__"
            assert m.output["cross_validation_holdout_predictions_frame_id"]


def test_exploitation_refines_the_best_gbm(run):
    _, _, _, _, ex = run
    steps = [s for s, _ in _events(ex)]
    assert steps.count("grid_gbm") == 4
    assert steps[-5:] == ["exploit_lr_annealing", "exploit_sample_rate",
                          "ensemble", "ensemble", "done"]
    models = ex.leaderboard.models
    plan = [m for m in models if m.algo != "stackedensemble"][:7]
    ranked = [m for m in sorted(
        plan, key=lambda m: -m.output["cross_validation_metrics"]["AUC"])
        if m.algo == "gbm"]
    best = ranked[0].params
    lr, sr = models[7].params, models[8].params
    assert lr["ntrees"] == 2 * best["ntrees"]
    assert lr["learn_rate"] == best["learn_rate"] / 2
    assert lr["learn_rate_annealing"] == 0.99
    assert lr["max_depth"] == sr["max_depth"] == best["max_depth"]
    assert sr["sample_rate"] == min(1.0, best["sample_rate"] * 0.8 + 0.2)
    assert sr["ntrees"] == best["ntrees"]


def test_leader_retrained_alone_is_bitwise(run):
    _, pa, _, pf, _ = run
    base = next(m for m in pa.leaderboard.sorted_models()
                if m.algo != "stackedensemble")
    fold = (np.arange(pf.nrows) % 3).astype(np.float32)
    work = Frame(list(pf.names) + ["__automl_fold__"],
                 list(pf.vecs) + [Vec(fold)])
    cls = builder_class(base.algo)
    accepted = cls(device="cpu").params
    params = {k: v for k, v in base.params.items()
              if k in accepted and k != "model_id"}
    alone = cls(device="cpu", **params).train(y="y", training_frame=work)
    keys = ("beta",) if base.algo == "glm" else \
        ("split_col", "thr_bin", "na_left", "bitset", "value")
    for k in keys:
        a, b = np.asarray(alone.output[k]), np.asarray(base.output[k])
        assert a.shape == b.shape and \
            np.array_equal(a.view(np.uint8), b.view(np.uint8)), k


@pytest.mark.parametrize("runner", ["automl", "grid"])
def test_search_jobs_run_under_the_callers_thread_count(monkeypatch,
                                                        runner):
    """A pool thread keeps the intra-op thread count it last ran with.
    AutoML's and the grid's job bodies take the caller's, as a builder's
    does: the AutoML leader GLM's [X,1]'Wz (MKL's transposed ``sgemv``)
    splits its rows over its threads, so a run on a pool thread left at
    8 threads and its retrain at 1 parted in the last bits."""
    import threading
    from h2o_tpu_torch.core.job import Job, jobs
    from h2o_tpu_torch.models.grid import GridSearch
    # every live pool thread (at least one) left at 8 threads
    n = max(jobs()._pool.live_workers, 1)
    gate = threading.Barrier(n)

    def warm(j):
        torch.set_num_threads(8)
        gate.wait(timeout=30)
        return torch.get_num_threads()

    seen = []
    try:
        warmed = [jobs().start(Job(description="warm"), warm)
                  for _ in range(n)]
        assert [j.join(timeout=60) for j in warmed] == [8] * n
    finally:
        torch.set_num_threads(1)
    if runner == "automl":
        monkeypatch.setattr(AutoML, "_run", lambda self, j, *a: seen.append(
            torch.get_num_threads()))
        AutoML(device="cpu", **dict(_CASE, project_name="threads")).train(
            y="y", training_frame=_bin_frames()[1])
    else:
        monkeypatch.setattr(GridSearch, "_run", lambda self, j, *a:
                            seen.append(torch.get_num_threads()))
        GridSearch("glm", {"alpha": [0.0]}, device="cpu").train(
            y="y", training_frame=_bin_frames()[1])
    assert seen == [1]
