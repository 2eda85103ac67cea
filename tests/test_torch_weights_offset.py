"""Weights and offset columns: the port held against ``h2o_tpu`` on the
CPU, tree for tree.

``test_torch_gbm``'s columns plus a weights column (uniform over the
multiples of 1/8 in [0.5, 2], so the DRF's weighted 0/1 stats sum
exactly in both packages) and an offset column (a smooth link-scale
term).  Configurations: a
bernoulli GBM with both columns, a gaussian GBM with both, and a
binomial DRF with the weights (the reference's DRF takes no offset).
The two columns are never features, the weights enter every stat and
f0 and the training metrics, and the offset starts F and is added again
when a frame that has the column is scored.

Tolerances: split columns, thresholds, NA directions and bitsets equal;
node values rtol 1e-4 / atol 1e-6; f0 rtol 1e-5 (a weighted mean,
summed in another order); predictions atol 1e-5; training AUC, logloss
and MSE 1e-4.
"""

import numpy as np
import pytest
import torch

from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models.tree.drf import DRF as JDRF
from h2o_tpu.models.tree.gbm import GBM as JGBM

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.tree.drf import DRF
from h2o_tpu_torch.models.tree.gbm import GBM

pytestmark = pytest.mark.shared_dkv

CONFIGS = {
    "bernoulli_gbm": dict(binomial=True, algo="gbm"),
    "gaussian_gbm": dict(binomial=False, algo="gbm"),
    "binomial_drf": dict(binomial=True, algo="drf"),
}
_NAMES = ["a", "b", "c", "d", "k", "w", "off", "y"]
_DOM = list("vwxyz")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(binomial: bool, n=600, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    X[rng.uniform(size=n) < 0.05, 1] = np.nan
    cat = rng.integers(0, 5, n).astype(np.int32)
    w = (rng.integers(4, 17, n) / 8).astype(np.float32)
    off = (0.4 * np.sin(2.0 * X[:, 3])).astype(np.float32)
    logit = (1.5 * X[:, 0] - X[:, 2] + 0.8 * (cat % 2) +
             0.5 * np.nan_to_num(X[:, 1])) + off
    if binomial:
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.int32)
        jy, py = JVec(y, J_CAT, domain=["n", "p"]), Vec(y, T_CAT,
                                                        domain=["n", "p"])
    else:
        y = (logit + 0.1 * rng.normal(size=n)).astype(np.float32)
        jy, py = JVec(y), Vec(y)
    jv = [JVec(X[:, j]) for j in range(4)] + [
        JVec(cat, J_CAT, domain=_DOM), JVec(w), JVec(off), jy]
    pv = [Vec(X[:, j]) for j in range(4)] + [
        Vec(cat, T_CAT, domain=_DOM), Vec(w), Vec(off), py]
    return JFrame(_NAMES, jv), Frame(_NAMES, pv)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request, cl):
    cfg = CONFIGS[request.param]
    jf, pf = _frames(cfg["binomial"])
    if cfg["algo"] == "drf":
        kw = dict(ntrees=3, max_depth=6, seed=3, weights_column="w")
        jm = JDRF(**kw).train(y="y", training_frame=jf, x=_NAMES[:6])
        pm = DRF(device="cpu", **kw).train(y="y", training_frame=pf,
                                           x=_NAMES[:6])
    else:
        kw = dict(ntrees=3, max_depth=3, seed=3, weights_column="w",
                  offset_column="off")
        jm = JGBM(**kw).train(y="y", training_frame=jf)
        pm = GBM(device="cpu", **kw).train(y="y", training_frame=pf)
    return cfg, jf, pf, jm, pm


def test_trees_equal(pair):
    _, _, _, jm, pm = pair
    assert pm.output["x"] == list(jm.output["x"]) == list("abcdk")
    for k in ("split_col", "thr_bin", "na_left", "bitset"):
        np.testing.assert_array_equal(pm.output[k], np.asarray(jm.output[k]),
                                      err_msg=k)
    assert (pm.output["split_col"] >= 0).sum() > 9
    np.testing.assert_allclose(pm.output["value"],
                               np.asarray(jm.output["value"]), rtol=1e-4,
                               atol=1e-6)
    if "f0" in jm.output:
        np.testing.assert_allclose(pm.output["f0"],
                                   np.asarray(jm.output["f0"]), rtol=1e-5)


def test_predictions_and_metrics_close(pair):
    cfg, jf, pf, jm, pm = pair
    got = pm.predict_raw(pf).numpy()
    want = np.asarray(jm.predict_raw(jf))[: pf.nrows]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    jt, pt = jm.output["training_metrics"], pm.output["training_metrics"]
    w = pf.vec("w").data
    np.testing.assert_allclose(pt["nobs"], w.sum(), rtol=1e-6)
    if cfg["binomial"]:
        assert abs(pt["AUC"] - jt["AUC"]) <= 1e-4
        assert abs(pt["logloss"] - jt["logloss"]) <= 1e-4
        assert pt["AUC"] > 0.75
    np.testing.assert_allclose(pt["mse"], jt["mse"], rtol=1e-4)


def test_weights_and_offset_change_the_forest():
    """Each column reaches the trees: without it the forest differs."""
    _, pf = _frames(True)
    kw = dict(device="cpu", ntrees=2, max_depth=3, seed=3)
    both = GBM(weights_column="w", offset_column="off", **kw).train(
        y="y", training_frame=pf, x=list("abcdk") + ["w", "off"])
    only_off = GBM(offset_column="off", **kw).train(
        y="y", training_frame=pf, x=list("abcdk") + ["off"])
    assert both.output["x"] == list("abcdk")
    assert not np.array_equal(both.output["value"], only_off.output["value"])
    # scoring a frame without the offset column adds no offset
    no_off = Frame([n for n in pf.names if n != "off"],
                   [pf.vec(n) for n in pf.names if n != "off"])
    d = both.predict_raw(pf)[:, 2] - both.predict_raw(no_off)[:, 2]
    assert float(d.abs().max()) > 1e-3
