"""The port's training loop (``models/tree/driver.py``) on the CPU.

Blocks equal one dispatch: a forest trained in blocks of
``score_tree_interval`` trees (the last block shorter) has the split
columns, thresholds, NA directions, bitsets and child pointers of the
forest trained in one call, and its node values within 1e-6, for the
dense GBM, a GBM on the capped sparse frontier, a DRF, a 3-class
multinomial GBM, int16 stats with row and column sampling and Random
histograms, and ``learn_rate_annealing`` < 1.  The scoring history's
last row equals a full re-score of the model on the scoring frame to
1e-6: the incremental scorer adds each block's trees to a running F.

Early stopping against ``h2o_tpu``: GBM and DRF with a validation frame
on ``tests/test_model_ops.py``'s weak-signal data stop at the same tree
count, every scoring-history row is equal but its timestamp (metrics to
1e-5), the trees are equal (values rtol 1e-4 / atol 1e-6) and so are the
validation metrics.  XGBoost's gbtree takes the same loop under
``score_each_iteration``.  A runtime
budget stops training with a valid model.
"""

import numpy as np
import pytest
import torch

from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models.tree.drf import DRF as JDRF
from h2o_tpu.models.tree.gbm import GBM as JGBM
from h2o_tpu.models.tree.xgboost import XGBoost as JXGBoost

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.tree import engine
from h2o_tpu_torch.models.tree.drf import DRF
from h2o_tpu_torch.models.tree.gbm import GBM
from h2o_tpu_torch.models.tree.xgboost import XGBoost
from h2o_tpu_torch.core.store import unpublish_on_exit


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv

_DOM = list("vwxyz")
_TREE_KEYS = ("split_col", "thr_bin", "na_left", "bitset", "child")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frame(n=600, seed=0, classes=2) -> Frame:
    """Four numeric columns (NaNs in one), a categorical, and a response
    of ``classes`` levels (numeric on a 1/16 grid for ``classes=0``)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    X[rng.uniform(size=n) < 0.05, 1] = np.nan
    cat = rng.integers(0, 5, n).astype(np.int32)
    logit = (1.5 * X[:, 0] - X[:, 2] + 0.8 * (cat % 2) +
             0.5 * np.nan_to_num(X[:, 1]))
    if classes == 0:
        yv = Vec(np.round(logit * 16) / 16)
    elif classes == 2:
        yv = Vec((rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(
            np.int32), T_CAT, domain=["n", "p"])
    else:
        edges = np.quantile(logit, np.linspace(0, 1, classes + 1)[1:-1])
        yv = Vec(np.digitize(logit + 0.3 * rng.normal(size=n), edges),
                 T_CAT, domain=[f"c{k}" for k in range(classes)])
    return Frame(["a", "b", "c", "d", "k", "y"],
                 [Vec(X[:, j]) for j in range(4)] +
                 [Vec(cat, T_CAT, domain=_DOM), yv])


def _assert_same_forest(a: dict, b: dict, atol: float = 1e-6) -> None:
    for k in _TREE_KEYS:
        if a.get(k) is None:
            assert b.get(k) is None, k
            continue
        np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)
    np.testing.assert_allclose(a["value"], np.asarray(b["value"]), rtol=0,
                               atol=atol)


BLOCKED = {
    "gbm_dense": (GBM, dict(max_depth=3), 2),
    "gbm_frontier": (GBM, dict(max_depth=6, sample_rate=0.8), 2),
    "drf": (DRF, dict(max_depth=6), 2),
    "gbm_multinomial": (GBM, dict(max_depth=3), 3),
    "gbm_int16_sampled": (GBM, dict(max_depth=3, stats_dtype="int16",
                                    sample_rate=0.8, col_sample_rate=0.7,
                                    histogram_type="Random"), 2),
    "gbm_annealing": (GBM, dict(max_depth=3, learn_rate=0.3,
                                learn_rate_annealing=0.9), 0),
}


@pytest.mark.parametrize("case", sorted(BLOCKED))
def test_blocks_equal_one_dispatch(case, monkeypatch):
    cls, kw, classes = BLOCKED[case]
    monkeypatch.setattr(engine, "MAX_LIVE_LEAVES", 8)
    fr = _frame(classes=classes)
    kw = dict(device="cpu", ntrees=7, seed=3, **kw)
    one = cls(**kw).train(y="y", training_frame=fr)
    blk = cls(score_tree_interval=3, **kw).train(y="y", training_frame=fr)
    if case in ("gbm_frontier", "drf"):
        assert one.output["child"] is not None
    _assert_same_forest(blk.output, one.output)
    np.testing.assert_allclose(blk.output["varimp"], one.output["varimp"],
                               rtol=1e-5)
    hist = blk.output["scoring_history"]
    assert [r["number_of_trees"] for r in hist] == [3, 6, 7]
    assert one.output["scoring_history"] == []
    full = blk.model_metrics(fr)
    last = hist[-1]
    for k in ("mse", "logloss", "auc", "mean_residual_deviance", "err"):
        if "training_" + k in last:
            key = "AUC" if k == "auc" else k
            assert abs(last["training_" + k] - full[key]) <= 1e-6, k


def _weak_signal(rng):
    """``tests/test_model_ops.py``'s early-stopping data: a weak signal,
    so the validation logloss soon stops improving."""
    n = 2000
    X = rng.normal(size=(n, 4)).astype(np.float32)
    y = (rng.uniform(size=n) <
         1 / (1 + np.exp(-0.3 * X[:, 0]))).astype(np.int32)
    names = [f"x{j}" for j in range(4)] + ["y"]

    def mk(sl, F, V, cat):
        return F(names, [V(X[sl, j]) for j in range(4)] +
                 [V(y[sl], cat, domain=["a", "b"])])

    return ((mk(slice(0, 1500), JFrame, JVec, J_CAT),
             mk(slice(1500, n), JFrame, JVec, J_CAT)),
            (mk(slice(0, 1500), Frame, Vec, T_CAT),
             mk(slice(1500, n), Frame, Vec, T_CAT)))


STOPPING = {
    "gbm": (JGBM, GBM, dict(ntrees=100, max_depth=3, learn_rate=0.5, seed=7,
                            stopping_rounds=2, stopping_tolerance=1e-3,
                            score_tree_interval=5)),
    "drf": (JDRF, DRF, dict(ntrees=40, max_depth=4, seed=7,
                            stopping_rounds=2, stopping_tolerance=1e-2,
                            score_tree_interval=3)),
    # depth 2: at depth 3 XGBoost's min_child_weight of 1 leaves nodes of
    # a few rows whose best two splits tie to float32 rounding on this
    # weak signal, and the two packages' summation orders pick apart
    "xgboost": (JXGBoost, XGBoost, dict(ntrees=40, max_depth=2, seed=7,
                                        stopping_rounds=2,
                                        score_each_iteration=True)),
}


@pytest.fixture(scope="module", params=sorted(STOPPING))
def stopped(request, cl):
    jcls, pcls, kw = STOPPING[request.param]
    (jtr, jva), (ptr, pva) = _weak_signal(np.random.default_rng(42))
    jm = jcls(**kw).train(y="y", training_frame=jtr, validation_frame=jva)
    pm = pcls(device="cpu", **kw).train(y="y", training_frame=ptr,
                                        validation_frame=pva)
    return request.param, kw, jm, pm


def test_early_stopping_tree_count_equal(stopped):
    _, kw, jm, pm = stopped
    assert pm.output["ntrees_actual"] == jm.output["ntrees_actual"]
    assert pm.output["ntrees_actual"] < kw["ntrees"]


def test_scoring_history_equal(stopped):
    _, _, jm, pm = stopped
    jh, ph = jm.output["scoring_history"], pm.output["scoring_history"]
    assert len(ph) == len(jh) >= 4
    for a, b in zip(ph, jh):
        assert a.keys() == b.keys()
        for k in a:
            if k == "number_of_trees":
                assert a[k] == b[k]
            elif k != "timestamp":
                assert abs(a[k] - b[k]) <= 1e-5, (k, a[k], b[k])
        assert any(k.startswith("validation_") for k in a)


def test_stopped_trees_equal(stopped):
    _, _, jm, pm = stopped
    for k in _TREE_KEYS:
        if pm.output.get(k) is not None:
            np.testing.assert_array_equal(pm.output[k],
                                          np.asarray(jm.output[k]),
                                          err_msg=k)
    np.testing.assert_allclose(pm.output["value"],
                               np.asarray(jm.output["value"]), rtol=1e-4,
                               atol=1e-6)


def test_validation_metrics_equal(stopped):
    _, _, jm, pm = stopped
    jv, pv = jm.output["validation_metrics"], pm.output["validation_metrics"]
    for k in ("AUC", "logloss", "mse", "pr_auc"):
        assert abs(pv[k] - jv[k]) <= 1e-5, k
    assert abs(pm.output["training_metrics"]["AUC"] -
               jm.output["training_metrics"]["AUC"]) <= 1e-5


def test_max_runtime_stops_with_a_valid_model():
    fr = _frame(n=2000, seed=1)
    m = GBM(device="cpu", ntrees=500, max_depth=3, seed=1,
            max_runtime_secs=0.3, score_tree_interval=5).train(
        y="y", training_frame=fr)
    n = m.output["ntrees_actual"]
    assert 5 <= n < 500 and n % 5 == 0
    assert m.output["split_col"].shape[0] == n
    assert len(m.output["scoring_history"]) == n // 5
    p = m.predict(fr).vec("p").data
    assert p.shape == (2000,) and np.isfinite(p).all()
    assert m.output["training_metrics"]["AUC"] > 0.75
