"""Multinomial GBM and multiclass DRF: the port held against ``h2o_tpu``
on the CPU, tree for tree.

A 3-class response on ``test_torch_gbm``'s columns (NaNs in a numeric
column, one categorical column), the label drawn from a softmax over
three strong, smooth class scores, so no split here is a near-tie.
Configurations: GBM with histogram_type AUTO (UniformAdaptive) and with
QuantilesGlobal (K1's sibling subtraction on each class tree), a
stochastic GBM with int16 stats, row and per-level column sampling (the
reference under ``H2O_TPU_STATS_DTYPE=int16``) — it holds the per-class
key order: class k of iteration t splits the running class key, and its
stats are quantized against its own tree key — and a DRF (one tree per
class on the 0/1 indicator, which sums exactly in both packages).

Tolerances: split columns, thresholds, NA directions and bitsets equal;
node values rtol 1e-4 / atol 1e-6; predictions (label and the K
probabilities) atol 1e-5; training logloss, error, MSE and mean
per-class error 1e-4.  A JAX-trained forest carried across by the
converter scores like the JAX model to atol 1e-6.
"""

import numpy as np
import pytest
import torch

from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models.tree.drf import DRF as JDRF
from h2o_tpu.models.tree.gbm import GBM as JGBM

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.tree.convert import (drf_from_jax_output,
                                               gbm_from_jax_output)
from h2o_tpu_torch.models.tree.drf import DRF
from h2o_tpu_torch.models.tree.gbm import GBM
from h2o_tpu_torch.core.store import unpublish_on_exit


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv

CONFIGS = {
    "gbm_auto": dict(algo="gbm"),
    "gbm_quantiles_global": dict(algo="gbm",
                                 histogram_type="QuantilesGlobal"),
    "gbm_int16_sampled": dict(algo="gbm", stats_dtype="int16",
                              sample_rate=0.8, col_sample_rate=0.8),
    "drf": dict(algo="drf", max_depth=6),
}
_NAMES = ["a", "b", "c", "d", "k", "y"]
_DOM = list("vwxyz")
_CLASSES = ["p", "q", "r"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(n=600, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    X[rng.uniform(size=n) < 0.05, 1] = np.nan
    cat = rng.integers(0, 5, n).astype(np.int32)
    score = np.stack([2.0 * X[:, 0],
                      -1.5 * X[:, 2] + 1.2 * (cat % 2),
                      1.2 * np.nan_to_num(X[:, 1]) - X[:, 0]], axis=1)
    p = np.exp(score - score.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    y = (rng.uniform(size=n)[:, None] > np.cumsum(p, axis=1)).sum(
        axis=1).astype(np.int32)
    jv = [JVec(X[:, j]) for j in range(4)] + [JVec(cat, J_CAT, domain=_DOM),
                                              JVec(y, J_CAT,
                                                   domain=_CLASSES)]
    pv = [Vec(X[:, j]) for j in range(4)] + [Vec(cat, T_CAT, domain=_DOM),
                                             Vec(y, T_CAT, domain=_CLASSES)]
    return JFrame(_NAMES, jv), Frame(_NAMES, pv)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request, cl):
    cfg = dict(CONFIGS[request.param])
    algo = cfg.pop("algo")
    stats_dtype = cfg.pop("stats_dtype", "f32")
    jf, pf = _frames()
    kw = dict(dict(ntrees=3, max_depth=3, seed=5), **cfg)
    if algo == "drf":
        jm = JDRF(**kw).train(y="y", training_frame=jf)
        pm = DRF(device="cpu", **kw).train(y="y", training_frame=pf)
    else:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("H2O_TPU_STATS_DTYPE", stats_dtype)
            jm = JGBM(**kw).train(y="y", training_frame=jf)
        pm = GBM(device="cpu", stats_dtype=stats_dtype, **kw).train(
            y="y", training_frame=pf)
    return algo, jf, pf, jm, pm


def test_trees_equal(pair):
    algo, _, _, jm, pm = pair
    assert pm.output["split_col"].shape[:2] == (3, 3)       # (T, K)
    for k in ("split_col", "thr_bin", "na_left", "bitset"):
        np.testing.assert_array_equal(pm.output[k], np.asarray(jm.output[k]),
                                      err_msg=k)
    assert (pm.output["split_col"] >= 0).sum() > 30
    np.testing.assert_allclose(pm.output["value"],
                               np.asarray(jm.output["value"]), rtol=1e-4,
                               atol=1e-6)
    if algo == "gbm":
        np.testing.assert_allclose(pm.output["f0"],
                                   np.asarray(jm.output["f0"]), rtol=1e-6)


def test_predictions_close(pair):
    _, jf, pf, jm, pm = pair
    got = pm.predict_raw(pf).numpy()
    want = np.asarray(jm.predict_raw(jf))[: pf.nrows]
    assert got.shape == (pf.nrows, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    pred = pm.predict(pf)
    assert pred.names == ["predict"] + _CLASSES
    assert pred.vec("predict").domain == _CLASSES


def test_training_metrics_close(pair):
    _, _, _, jm, pm = pair
    jt, pt = jm.output["training_metrics"], pm.output["training_metrics"]
    assert pt.kind == "multinomial"
    for k in ("logloss", "err", "mse", "mean_per_class_error", "nobs"):
        assert abs(pt[k] - jt[k]) <= 1e-4, (k, pt[k], jt[k])
    np.testing.assert_allclose(pt["hit_ratios"], jt["hit_ratios"],
                               atol=1e-4)
    np.testing.assert_allclose(pt["cm"], np.asarray(jt["cm"]), atol=1e-3)
    assert pt["err"] < 0.4


def test_converted_forest_scores_like_reference(pair):
    algo, jf, pf, jm, _ = pair
    out = {k: (np.asarray(v) if hasattr(v, "shape") else v)
           for k, v in jm.output.items()}
    conv = drf_from_jax_output if algo == "drf" else gbm_from_jax_output
    cm = conv(out, jm.params, device="cpu")
    got = cm.predict_raw(pf).numpy()
    want = np.asarray(jm.predict_raw(jf))[: pf.nrows]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
