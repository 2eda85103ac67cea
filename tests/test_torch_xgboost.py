"""XGBoost: the port held against ``h2o_tpu`` on the CPU, tree for tree.

gbtree on ``test_torch_gbm``'s binomial data with XGBoost's defaults
(eta 0.3, max_bins 256 over the 1024-bin fine grid, min_child_weight 1,
force_newton) cut to 3 trees of depth 3, once with ``reg_lambda=0``
and once with 1 (the default), and a gaussian gbtree with
``reg_lambda=1`` (Newton steps on unit hessians); dart on the
reference's own case (``tests/test_xgb_extras.py``: 600 rows, 4 normal
columns, 8 trees of depth 3, ``rate_drop=0.3``, seed 7), where the drops
come from numpy's ``default_rng(7)`` in both packages and every round's
tree is tree 0 of the seed's key stream.  A JAX-trained dart forest
carried across by the converter scores like the JAX model.  The
``reg_alpha`` guard raises.  gblinear (a GLM) trains, and on the
reference's own case (``tests/test_xgb_extras.py::
test_xgboost_gblinear``: 800 rows, 3 normal columns, reg_lambda 1,
seed 1; and once with reg_alpha 0.5 for the elastic net) its
coefficients are within 1e-5 of the reference's and its predictions
within 1e-5; a JAX gblinear model carried across predicts within 1e-6.

Tolerances: split columns, thresholds, NA directions and bitsets equal;
node values rtol 1e-4 / atol 1e-6; predictions atol 1e-5; training AUC
and MSE 1e-4; the converted forest atol 1e-6.
"""

import numpy as np
import pytest
import torch

from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models.tree.xgboost import XGBoost as JXGBoost

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.model import Model
from h2o_tpu_torch.models.tree.convert import xgboost_from_jax_output
from h2o_tpu_torch.models.tree.xgboost import XGBoost

pytestmark = pytest.mark.shared_dkv

CONFIGS = {
    "gbtree_lambda0": dict(data="gbm", binomial=True, booster="gbtree",
                           reg_lambda=0.0, ntrees=3, max_depth=3, seed=1),
    "gbtree_lambda1": dict(data="gbm", binomial=True, booster="gbtree",
                           ntrees=3, max_depth=3, seed=1),
    "gbtree_gaussian": dict(data="gbm", binomial=False, booster="gbtree",
                            ntrees=3, max_depth=3, seed=1),
    "dart": dict(data="dart", binomial=True, booster="dart", ntrees=8,
                 max_depth=3, rate_drop=0.3, seed=7),
}
_DOM = list("vwxyz")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gbm_data(binomial: bool, n=600, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    X[rng.uniform(size=n) < 0.05, 1] = np.nan
    cat = rng.integers(0, 5, n).astype(np.int32)
    logit = (1.5 * X[:, 0] - X[:, 2] + 0.8 * (cat % 2) +
             0.5 * np.nan_to_num(X[:, 1]))
    if binomial:
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.int32)
    else:
        y = (logit + 0.1 * rng.normal(size=n)).astype(np.float32)
    names = ["a", "b", "c", "d", "k", "y"]
    cols = [(X[:, j], None) for j in range(4)] + [(cat, _DOM)]
    cols.append((y, ["n", "p"] if binomial else None))
    return names, cols


def _dart_data(n=600, seed=42):
    """The reference test's frame (its ``rng`` fixture is
    ``default_rng(42)``)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    logits = x[:, 0] - 0.7 * x[:, 1]
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(np.int32)
    names = [f"x{i}" for i in range(4)] + ["y"]
    return names, [(x[:, i], None) for i in range(4)] + [(y, ["n", "p"])]


def _frames(names, cols):
    jv = [JVec(a, J_CAT, domain=d) if d else JVec(a) for a, d in cols]
    pv = [Vec(a, T_CAT, domain=d) if d else Vec(a) for a, d in cols]
    return JFrame(names, jv), Frame(names, pv)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request, cl):
    cfg = dict(CONFIGS[request.param])
    data, binomial = cfg.pop("data"), cfg.pop("binomial")
    jf, pf = _frames(*(_gbm_data(binomial) if data == "gbm"
                       else _dart_data()))
    jm = JXGBoost(**cfg).train(y="y", training_frame=jf)
    pm = XGBoost(device="cpu", **cfg).train(y="y", training_frame=pf)
    return binomial, cfg, jf, pf, jm, pm


def test_trees_equal(pair):
    _, cfg, _, _, jm, pm = pair
    assert pm.output["split_col"].shape[0] == cfg["ntrees"]
    assert pm.output["nbins"] == 256 and pm.output["fine_nbins"] == 1024
    for k in ("split_col", "thr_bin", "na_left", "bitset"):
        np.testing.assert_array_equal(pm.output[k], np.asarray(jm.output[k]),
                                      err_msg=k)
    assert (pm.output["split_col"] >= 0).sum() > 9
    np.testing.assert_allclose(pm.output["value"],
                               np.asarray(jm.output["value"]), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(pm.output["f0"], np.asarray(jm.output["f0"]),
                               rtol=1e-6)


def test_predictions_and_metrics_close(pair):
    binomial, _, jf, pf, jm, pm = pair
    got = pm.predict_raw(pf).numpy()
    want = np.asarray(jm.predict_raw(jf))[: pf.nrows]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    jt, pt = jm.output["training_metrics"], pm.output["training_metrics"]
    if binomial:
        assert abs(pt["AUC"] - jt["AUC"]) <= 1e-4
        assert pt["AUC"] > 0.75
    np.testing.assert_allclose(pt["mse"], jt["mse"], rtol=1e-4)


def test_converted_forest_scores_like_reference(pair):
    _, _, jf, pf, jm, _ = pair
    out = {k: (np.asarray(v) if hasattr(v, "shape") else v)
           for k, v in jm.output.items()}
    cm = xgboost_from_jax_output(out, jm.params, device="cpu")
    got = cm.predict_raw(pf).numpy()
    want = np.asarray(jm.predict_raw(jf))[: pf.nrows]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_reg_lambda_reaches_the_leaves():
    """reg_lambda shrinks every Newton step: |value| falls as it grows."""
    pf = _frames(*_gbm_data(True))[1]
    kw = dict(device="cpu", ntrees=1, max_depth=3, seed=1)
    v0 = XGBoost(reg_lambda=0.0, **kw).train(y="y", training_frame=pf)
    v9 = XGBoost(reg_lambda=50.0, **kw).train(y="y", training_frame=pf)
    a0 = np.abs(v0.output["value"]).sum()
    a9 = np.abs(v9.output["value"]).sum()
    assert 0 < a9 < a0


def test_xgboost_guards():
    pf = _frames(*_gbm_data(True))[1]
    with pytest.raises(ValueError, match="reg_alpha"):
        XGBoost(device="cpu", booster="gbtree", reg_alpha=0.5)
    with pytest.raises(ValueError, match="tree_method"):
        XGBoost(device="cpu", tree_method="exact")
    # gblinear is a GLM: it trains
    m = XGBoost(device="cpu", booster="gblinear", ntrees=1).train(
        y="y", training_frame=pf)
    assert m.params["booster"] == "gblinear" and \
        np.isfinite(m.output["beta"]).all()
    with pytest.raises(ValueError, match="offset_column"):
        XGBoost(device="cpu", booster="dart", ntrees=1,
                offset_column="a").train(y="y", training_frame=pf)
    # XGBoost names reach the engine's params
    m = XGBoost(device="cpu", eta=0.1, subsample=0.9, max_bins=64,
                min_child_weight=3.0)
    assert (m.params["learn_rate"], m.params["sample_rate"],
            m.params["nbins"], m.params["min_rows"]) == (0.1, 0.9, 64, 3.0)


def _gblinear_frames(n=800, seed=42):
    """``test_xgb_extras.py::test_xgboost_gblinear``'s frame (its ``rng``
    fixture is ``default_rng(42)``)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    logits = 1.5 * x[:, 0] - x[:, 1]
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(np.int32)
    return _frames(["a", "b", "c", "y"], [(x[:, j], None) for j in range(3)]
                   + [(y, ["n", "p"])])


@pytest.mark.parametrize("reg", [dict(reg_lambda=1.0),
                                 dict(reg_lambda=1.0, reg_alpha=0.5)],
                         ids=["ridge", "elastic_net"])
def test_gblinear_matches_reference(cl, reg, tmp_path):
    jf, pf = _gblinear_frames()
    jm = JXGBoost(booster="gblinear", seed=1, **reg).train(
        y="y", training_frame=jf)
    pm = XGBoost(device="cpu", booster="gblinear", seed=1, **reg).train(
        y="y", training_frame=pf)
    assert pm.params["booster"] == "gblinear"
    assert pm.params["_solver_resolved"] == jm.params["_solver_resolved"]
    assert pm.output["iterations"] == jm.output["iterations"]
    np.testing.assert_allclose(pm.output["beta"],
                               np.asarray(jm.output["beta"]), atol=1e-5)
    np.testing.assert_allclose(pm.predict_raw(pf).numpy(),
                               np.asarray(jm.predict_raw(jf))[:pf.nrows],
                               atol=1e-5)
    jt, pt = jm.output["training_metrics"], pm.output["training_metrics"]
    assert abs(pt["AUC"] - jt["AUC"]) <= 1e-6 and pt["AUC"] > 0.8
    beta = pm.output["beta"]
    assert abs(beta[0]) > abs(beta[2])
    out = {k: (np.asarray(v) if hasattr(v, "shape") else v)
           for k, v in jm.output.items()}
    cm = xgboost_from_jax_output(out, jm.params, device="cpu")
    np.testing.assert_allclose(cm.predict_raw(pf).numpy(),
                               np.asarray(jm.predict_raw(jf))[:pf.nrows],
                               rtol=1e-6, atol=1e-6)
    # a saved gblinear model loads as the linear model it is
    m2 = Model.load(pm.save(str(tmp_path / "lin.bin")), device="cpu")
    assert type(m2) is type(pm)
    np.testing.assert_array_equal(m2.predict_raw(pf).numpy(),
                                  pm.predict_raw(pf).numpy())
