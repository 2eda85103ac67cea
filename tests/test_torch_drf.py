"""The port's DRF held against ``h2o_tpu``'s DRF on the CPU, tree for
tree.

Binomial and regression responses on the same data (NaNs in a numeric
column, one categorical column), with the default UniformAdaptive
histograms and once each with Random (binomial) and QuantilesGlobal
(regression: K1's sibling subtraction on the frontier's uncapped
levels), max_depth 8 with the frontier capped
at 16 live leaves in both packages (the reference's
``H2O_TPU_MAX_LIVE_LEAVES`` and the port's ``engine.MAX_LIVE_LEAVES``),
so the sparse-frontier engine, its best-first selection, mtries column
sampling and 0.632 row sampling all run.  DRF's stats (w, w*y, w*y^2,
w) are 0/1 for the binomial response and multiples of 1/256 for the
regression one, so every histogram sums exactly in either package:
split columns, thresholds, NA directions, bitsets and child pointers are
equal, node values agree to atol 1e-6, predictions to atol 1e-5 and
training metrics to 1e-5.  A JAX-trained DRF carried across by
``drf_from_jax_output`` scores like the reference to atol 1e-6.

One DRF at the stock defaults (depth 20, frontier cap 4,096) on 300
rows trains in both packages and must give the same trees; the case
takes about 30 s on a CPU, most of it the reference's compile of 20
unrolled levels.
"""

import os

import numpy as np
import pytest
import torch

from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models.tree.drf import DRF as JDRF

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.tree import engine
from h2o_tpu_torch.models.tree.convert import drf_from_jax_output
from h2o_tpu_torch.models.tree.drf import DRF
from h2o_tpu_torch.core.store import unpublish_on_exit


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv

CAP = 16
_NAMES = ["a", "b", "c", "d", "k", "y"]
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
    logit = (1.5 * X[:, 0] - X[:, 2] + 0.8 * (cat % 2) +
             0.5 * np.nan_to_num(X[:, 1]))
    if binomial:
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.int32)
    else:
        y = (np.round((logit + 0.1 * rng.normal(size=n)) * 16) / 16).astype(
            np.float32)
    jv = [JVec(X[:, j]) for j in range(4)] + [JVec(cat, J_CAT, domain=_DOM)]
    pv = [Vec(X[:, j]) for j in range(4)] + [Vec(cat, T_CAT, domain=_DOM)]
    jv.append(JVec(y, J_CAT, domain=["n", "p"]) if binomial else JVec(y))
    pv.append(Vec(y, T_CAT, domain=["n", "p"]) if binomial else Vec(y))
    return JFrame(_NAMES, jv), Frame(_NAMES, pv)


CASES = {"binomial": {}, "regression": {},
         "binomial_random": dict(histogram_type="Random"),
         "regression_quantiles": dict(histogram_type="QuantilesGlobal")}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request, cl):
    binomial = request.param.startswith("binomial")
    jf, pf = _frames(binomial)
    kw = dict(ntrees=3, max_depth=8, seed=1, **CASES[request.param])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("H2O_TPU_MAX_LIVE_LEAVES", str(CAP))
        mp.setattr(engine, "MAX_LIVE_LEAVES", CAP)
        jm = JDRF(**kw).train(y="y", training_frame=jf)
        pm = DRF(device="cpu", **kw).train(y="y", training_frame=pf)
    return binomial, jf, pf, jm, pm


def test_trees_equal(pair):
    _, _, _, jm, pm = pair
    assert pm.output["child"] is not None
    assert pm.output["split_col"].shape == (3, 1, engine.pool_size(8, CAP))
    for k in ("split_col", "thr_bin", "na_left", "bitset", "child"):
        np.testing.assert_array_equal(pm.output[k], np.asarray(jm.output[k]),
                                      err_msg=k)
    assert (pm.output["split_col"] >= 0).sum() > 40
    np.testing.assert_allclose(pm.output["value"],
                               np.asarray(jm.output["value"]), rtol=0,
                               atol=1e-6)
    assert pm.output["ntrees_actual"] == jm.output["ntrees_actual"] == 3


def test_predictions_and_metrics_close(pair):
    binomial, jf, pf, jm, pm = pair
    got = pm.predict_raw(pf).numpy()
    want = np.asarray(jm.predict_raw(jf))[: pf.nrows]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    jt, pt = jm.output["training_metrics"], pm.output["training_metrics"]
    if binomial:
        assert abs(pt["AUC"] - jt["AUC"]) <= 1e-5
        assert pt["AUC"] > 0.8
    np.testing.assert_allclose(pt["mse"], jt["mse"], rtol=1e-5)


def test_converted_forest_scores_like_reference(pair):
    _, jf, pf, jm, _ = pair
    out = {k: (np.asarray(v) if hasattr(v, "shape") else v)
           for k, v in jm.output.items()}
    cm = drf_from_jax_output(out, jm.params, device="cpu")
    got = cm.predict_raw(pf).numpy()
    want = np.asarray(jm.predict_raw(jf))[: pf.nrows]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert cm.predict(pf).nrows == pf.nrows


def test_stock_default_depth20_drf(cl):
    jf, pf = _frames(True, n=300, seed=2)
    jm = JDRF(ntrees=2, seed=3).train(y="y", training_frame=jf)
    pm = DRF(device="cpu", ntrees=2, seed=3).train(y="y", training_frame=pf)
    assert pm.params["max_depth"] == 20 and pm.output["max_depth"] == 20
    assert pm.output["split_col"].shape[2] == engine.pool_size(20, 4096)
    for k in ("split_col", "thr_bin", "bitset", "child"):
        np.testing.assert_array_equal(pm.output[k], np.asarray(jm.output[k]),
                                      err_msg=k)
    np.testing.assert_allclose(pm.predict_raw(pf).numpy(),
                               np.asarray(jm.predict_raw(jf))[: pf.nrows],
                               rtol=0, atol=1e-5)


def test_out_of_slice_options_raise(tmp_path):
    _, pf = _frames(True)
    # recovery_dir: the snapshot, one checkpoint a block of 10 trees,
    # the snapshot dropped at the end, as in the reference
    from h2o_tpu_torch.core.recovery import pending_recoveries
    d = str(tmp_path / "r")
    m = DRF(device="cpu", ntrees=1, seed=1, recovery_dir=d).train(
        y="y", training_frame=pf)
    assert pending_recoveries(d) == [] and os.path.isdir(d)
    plain = DRF(device="cpu", ntrees=1, seed=1).train(y="y",
                                                     training_frame=pf)
    assert m.output["split_col"].tobytes() == \
        plain.output["split_col"].tobytes()
    # a custom metric that does not load records NaN, as the reference's
    # attach_custom_metric does; the model trains
    m = DRF(device="cpu", ntrees=1, custom_metric_func="f").train(
        y="y", training_frame=pf)
    tm = m.output["training_metrics"]
    assert tm["custom_metric_name"] == "f"
    assert np.isnan(tm["custom_metric_value"])
    with pytest.raises(ValueError, match="not found"):
        DRF(device="cpu", ntrees=1, checkpoint="m").train(
            y="y", training_frame=pf)
    with pytest.raises(ValueError):
        DRF(device="cpu", ntrees=1, bogus=1)
    with pytest.raises(ValueError, match="binomial_double_trees"):
        DRF(device="cpu", ntrees=1, binomial_double_trees=True)
