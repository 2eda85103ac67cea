"""n-fold cross-validation in the port held against ``h2o_tpu`` on the CPU.

Fold assignment is equal to the reference's for AUTO, Random, Modulo and
Stratified folds and for a fold column with non-contiguous values; a
fold column with a missing value raises in both.  A 3-fold GBM on
``tests/test_model_ops.py``'s CV data has the reference's fold models
(trees equal, values rtol 1e-4 / atol 1e-6), cross-validation metrics
and per-fold summary (metrics to 1e-5) and holdout predictions (atol
1e-5), and its main model equals the reference's.  Under early stopping
the fold models' mean tree count carries to the main model, as in the
reference.  The port keeps fold models and frames on ``model.output``.
"""

import numpy as np
import pytest
import torch

from h2o_tpu.core.cloud import cloud
from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models.tree.gbm import GBM as JGBM

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.tree.gbm import GBM
from tests.test_torch_find_splits_order import hold_gbm_forest

pytestmark = pytest.mark.shared_dkv

_TREE_KEYS = ("split_col", "thr_bin", "na_left", "bitset")
_METRICS = ("AUC", "logloss", "mse", "pr_auc", "mean_per_class_error")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy_binomial(rng, n=3000, c=6, fold=None):
    """``tests/test_model_ops.py``'s CV data in both packages, with an
    optional numeric fold column."""
    X = rng.normal(size=(n, c)).astype(np.float32)
    logits = 2.0 * X[:, 0] - 1.5 * X[:, 1] + X[:, 2]
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(np.int32)
    names = [f"x{j}" for j in range(c)] + ["y"]
    jv = [JVec(X[:, j]) for j in range(c)] + \
        [JVec(y, J_CAT, domain=["no", "yes"])]
    pv = [Vec(X[:, j]) for j in range(c)] + \
        [Vec(y, T_CAT, domain=["no", "yes"])]
    if fold is not None:
        names.append("fold")
        jv.append(JVec(fold.astype(np.float32)))
        pv.append(Vec(fold.astype(np.float32)))
    return JFrame(names, jv), Frame(names, pv)


@pytest.mark.parametrize("scheme", ["AUTO", "Random", "Modulo",
                                    "Stratified"])
@pytest.mark.parametrize("seed", [7, -1])
def test_fold_assignment_equal(scheme, seed, cl):
    jf, pf = _toy_binomial(np.random.default_rng(1), n=500)
    kw = dict(nfolds=4, fold_assignment=scheme, seed=seed)
    want = JGBM(**kw)._fold_assignment(jf, "y")
    got = GBM(device="cpu", **kw)._fold_assignment(pf, "y")
    assert got.shape == (500,) and set(np.unique(got)) == {0, 1, 2, 3}
    if seed >= 0 or scheme == "Modulo":
        np.testing.assert_array_equal(got, want)


def test_fold_column_remapped_and_na_raises(cl):
    rng = np.random.default_rng(2)
    fold = rng.choice([2.0, 5.0, 9.0], size=400)
    jf, pf = _toy_binomial(rng, n=400, fold=fold)
    want = JGBM(fold_column="fold")._fold_assignment(jf, "y")
    got = GBM(device="cpu", fold_column="fold")._fold_assignment(pf, "y")
    np.testing.assert_array_equal(got, want)
    assert set(got) == {0, 1, 2}
    fold[7] = np.nan
    jf, pf = _toy_binomial(rng, n=400, fold=fold)
    with pytest.raises(ValueError, match="missing"):
        JGBM(fold_column="fold")._fold_assignment(jf, "y")
    with pytest.raises(ValueError, match="missing"):
        GBM(device="cpu", fold_column="fold")._fold_assignment(pf, "y")


@pytest.fixture(scope="module")
def cv_pair(cl):
    jf, pf = _toy_binomial(np.random.default_rng(42))
    kw = dict(ntrees=10, max_depth=3, learn_rate=0.3, seed=11, nfolds=3,
              keep_cross_validation_predictions=True,
              keep_cross_validation_fold_assignment=True)
    jm = JGBM(**kw).train(y="y", training_frame=jf)
    pm = GBM(device="cpu", **kw).train(y="y", training_frame=pf)
    return jf, pf, jm, pm


def test_cv_fold_models_equal(cv_pair):
    _, _, jm, pm = cv_pair
    jms = [cloud().dkv.get(k) for k in jm.output["cross_validation_models"]]
    pms = pm.output["cross_validation_models"]
    assert len(pms) == len(jms) == 3
    for a, b in zip(pms, jms):
        for k in _TREE_KEYS:
            np.testing.assert_array_equal(a.output[k], np.asarray(b.output[k]),
                                          err_msg=k)
        np.testing.assert_allclose(a.output["value"],
                                   np.asarray(b.output["value"]), rtol=1e-4,
                                   atol=1e-6)
        assert a.params["weights_column"] == b.params["weights_column"]
        assert abs(a.output["validation_metrics"]["AUC"] -
                   b.output["validation_metrics"]["AUC"]) <= 1e-5


def test_cv_metrics_and_summary_equal(cv_pair):
    _, _, jm, pm = cv_pair
    jc, pc = jm.output["cross_validation_metrics"], \
        pm.output["cross_validation_metrics"]
    for k in _METRICS:
        assert abs(pc[k] - jc[k]) <= 1e-5, k
    assert 0.7 < pc["AUC"] <= pm.output["training_metrics"]["AUC"] + 0.02
    js = jm.output["cross_validation_metrics_summary"]
    ps = pm.output["cross_validation_metrics_summary"]
    assert set(ps) == set(js) and "logloss" in ps
    for k in ps:
        np.testing.assert_allclose(ps[k]["values"], js[k]["values"],
                                   rtol=1e-5, atol=1e-5, err_msg=k)
        assert abs(ps[k]["mean"] - js[k]["mean"]) <= 1e-5
        assert abs(ps[k]["sd"] - js[k]["sd"]) <= 1e-5


def test_cv_frames_and_main_model_equal(cv_pair):
    jf, pf, jm, pm = cv_pair
    jp = cloud().dkv.get(
        jm.output["cross_validation_holdout_predictions_frame_id"])
    pp = pm.output["cross_validation_holdout_predictions_frame"]
    assert pp.nrows == pf.nrows == jp.nrows
    np.testing.assert_allclose(pp.vec("yes").data,
                               np.asarray(jp.vec("yes").to_numpy()), rtol=0,
                               atol=1e-5)
    fa = pm.output["cross_validation_fold_assignment_frame"]
    jfa = cloud().dkv.get(
        jm.output["cross_validation_fold_assignment_frame_id"])
    np.testing.assert_array_equal(fa.vec("fold_assignment").data,
                                  np.asarray(jfa.vec("fold_assignment")
                                             .to_numpy()))
    for k in _TREE_KEYS:
        np.testing.assert_array_equal(pm.output[k], np.asarray(jm.output[k]),
                                      err_msg=k)
    assert abs(pm.output["training_metrics"]["AUC"] -
               jm.output["training_metrics"]["AUC"]) <= 1e-5


def test_cv_early_stopping_carries_the_tree_count(cl):
    # each model's trees are held on its training rows where the two
    # packages' table sums leave them determined (``hold_gbm_forest``:
    # here fold 1's and the main model's tree 11 put the root threshold
    # one fine bin apart, in a bin none of their rows falls in); a tie
    # that parts a fold model's forest leaves its tree count to rounding
    jf, pf = _toy_binomial(np.random.default_rng(42), n=2000)
    kw = dict(ntrees=60, max_depth=3, learn_rate=0.5, seed=7, nfolds=3,
              fold_assignment="Modulo", stopping_rounds=2,
              score_tree_interval=4)
    jm = JGBM(**kw).train(y="y", training_frame=jf)
    pm = GBM(device="cpu", **kw).train(y="y", training_frame=pf)
    pms = pm.output["cross_validation_models"]
    jms = [cloud().dkv.get(k) for k in jm.output["cross_validation_models"]]
    y = pf.vec("y").to_numpy().astype(np.int64)
    fold = np.arange(pf.nrows) % 3
    parted = []
    for i, (a, b) in enumerate(zip(pms + [pm], jms + [jm])):
        rows = fold != i if i < 3 else np.ones(pf.nrows, bool)
        jo = {k: (np.asarray(v) if hasattr(v, "shape") else v)
              for k, v in b.output.items()}
        keep, _, ties = hold_gbm_forest(a, jo, b.params, pf.slice_rows(rows),
                                        y[rows], np.ones(rows.sum()))
        assert keep[:4].all()
        parted.append(ties > 0)
        if not ties:
            assert a.output["ntrees_actual"] == b.output["ntrees_actual"]
    folds = [m.output["ntrees_actual"] for m in pms]
    assert max(folds) < 60
    want = max(1, int(round(np.mean(folds))))
    assert pm.output["ntrees_actual"] == want
    if not any(parted[:3]):
        assert jm.output["ntrees_actual"] == want
