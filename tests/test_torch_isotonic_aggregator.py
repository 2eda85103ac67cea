"""IsotonicRegression and Aggregator in the port held against
``h2o_tpu``'s on the CPU.

IsotonicRegression on ``test_survival_misc.py``'s data (500 rows, x
uniform in [0, 10], ``y = sqrt(x) + noise``), unweighted and with
weights and NA cells, ``out_of_bounds`` clip and NA: the thresholds
equal (the same host PAV), predictions bitwise, also for rows outside
the training range and NaN x (``interp`` is ``jnp.interp``'s
arithmetic with its last step one fused multiply-add, as XLA compiles
it: bitwise on 100,000 points over 300 knots, where the unfused form is
1 ulp off in hundreds).

Aggregator on ``test_survival_misc.py``'s clustered data (3,000 rows
around 5 centers in 3 dimensions; target 100 exemplars, rel_tol 0.7)
and on a frame with a categorical column and NA cells: the exemplar
count, every row's assignment, the counts and the aggregated frame
equal; the standardized exemplars within 1e-6 and the radius within
1e-6 relative (both from the expansion's float32 standardization, whose
rollup sigma rounds differently); ``predict`` labels equal.  Rows
within float32 rounding of the radius, or of two exemplars, are not
decided by anything both packages share (their distance products round
differently): this data has none.  The row-wise ``np.sum(..., axis=1)``
the port uses against a batch's newborn exemplars equals the reference's
scalar ``np.sum`` of each row, bitwise, at P = 3, 28 and 54.

Each builder's converter scores like the reference model, ``Model.save``
and ``load`` round-trip it, and what the port refuses is refused by name.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models.aggregator import Aggregator as JAgg
from h2o_tpu.models.isotonic import IsotonicRegression as JIso

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.aggregator import (Aggregator,
                                             aggregator_from_jax_output)
from h2o_tpu_torch.models.isotonic import (IsotonicRegression,
                                           interp,
                                           isotonicregression_from_jax_output)
from h2o_tpu_torch.models.model import Model
from h2o_tpu_torch.core.store import unpublish_on_exit


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv


def _pair(cols):
    """cols: name -> (values, domain or None)."""
    jv, pv = [], []
    for v, dom in cols.values():
        if dom is None:
            jv.append(JVec(v.astype(np.float32)))
            pv.append(Vec(v.astype(np.float32)))
        else:
            jv.append(JVec(v.astype(np.int32), J_CAT, domain=dom))
            pv.append(Vec(v.astype(np.int32), T_CAT, domain=dom))
    return JFrame(list(cols), jv), Frame(list(cols), pv)


def _np(out):
    return {k: (np.asarray(v) if hasattr(v, "shape") else v)
            for k, v in out.items()}


# -- IsotonicRegression -------------------------------------------------------

def _iso_data(case):
    rng = np.random.default_rng(42)
    n = 500
    x = rng.uniform(0, 10, n).astype(np.float32)
    y = (np.sqrt(x) + 0.3 * rng.normal(size=n)).astype(np.float32)
    cols = {"x0": (x, None), "y": (y, None)}
    kw = {}
    if case == "weighted":
        x[rng.uniform(size=n) < 0.05] = np.nan
        y[rng.uniform(size=n) < 0.03] = np.nan
        cols["w"] = ((rng.integers(0, 4, n) / 2).astype(np.float32), None)
        kw = dict(weights_column="w")
    if case == "na_bounds":
        kw = dict(out_of_bounds="NA")
    return _pair(cols), kw


ISO_CASES = ("plain", "weighted", "na_bounds")


@pytest.fixture(scope="module")
def iso_fits(cl):
    out = {}
    for case in ISO_CASES:
        (jf, pf), kw = _iso_data(case)
        out[case] = (jf, pf, kw,
                     JIso(**kw).train(x=["x0"], y="y", training_frame=jf),
                     IsotonicRegression(device="cpu", **kw).train(
                         x=["x0"], y="y", training_frame=pf))
    return out


def _score_frames():
    x = np.array([-1.0, 0.0, 0.5, 3.3, 9.99, 10.0, 12.0, np.nan],
                 np.float32)
    return _pair({"x0": (x, None), "y": (np.zeros_like(x), None)})


@pytest.mark.parametrize("case", ISO_CASES)
def test_isotonic_thresholds_and_predictions(iso_fits, case):
    jf, pf, _, jm, pm = iso_fits[case]
    np.testing.assert_array_equal(pm.output["thresholds_x"],
                                  jm.output["thresholds_x"])
    np.testing.assert_array_equal(pm.output["thresholds_y"],
                                  jm.output["thresholds_y"])
    assert pm.output["nobs"] == jm.output["nobs"]
    for j, p in ((jf, pf), _score_frames()):
        np.testing.assert_array_equal(
            pm.predict_raw(p).numpy(), np.asarray(jm.predict_raw(j))[:p.nrows])
    np.testing.assert_allclose(pm.output["training_metrics"]["mse"],
                               jm.output["training_metrics"]["mse"],
                               rtol=1e-6)


def test_interp_is_jnp_interp_with_its_fma():
    rng = np.random.default_rng(0)
    xp = np.sort(rng.uniform(-5, 5, 300)).astype(np.float32)
    fp = np.cumsum(rng.uniform(0, 1, 300)).astype(np.float32)
    x = rng.uniform(xp[0], xp[-1], 100_000).astype(np.float32)
    want = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp),
                                 jnp.asarray(fp)))
    got = interp(torch.from_numpy(x), torch.from_numpy(xp),
                 torch.from_numpy(fp)).numpy()
    np.testing.assert_array_equal(got, want)
    # the unfused last step rounds twice and parts from XLA's
    xt, xpt, fpt = map(torch.from_numpy, (x, xp, fp))
    i = torch.clamp(torch.searchsorted(xpt, xt, right=True), 1, 299)
    plain = (fpt[i - 1] + (xt - xpt[i - 1]) / (xpt[i] - xpt[i - 1]) *
             (fpt[i] - fpt[i - 1])).numpy()
    assert (plain != want).sum() > 100


def test_isotonic_converter_and_save_load(iso_fits):
    jf, pf, _, jm, _ = iso_fits["plain"]
    cm = isotonicregression_from_jax_output(_np(jm.output), jm.params,
                                            device="cpu")
    want = np.asarray(jm.predict_raw(jf))[:pf.nrows]
    np.testing.assert_array_equal(cm.predict_raw(pf).numpy(), want)
    with tempfile.TemporaryDirectory() as d:
        path = cm.save(os.path.join(d, "iso.bin"))
        back = Model.load(path, device="cpu")
    assert back.algo == "isotonicregression"
    np.testing.assert_array_equal(back.predict_raw(pf).numpy(), want)


def test_isotonic_refusals():
    (_, pf), _ = _iso_data("plain")
    pf.add("x1", Vec(np.ones(pf.nrows, np.float32) +
                     np.arange(pf.nrows, dtype=np.float32)))
    with pytest.raises(ValueError, match="exactly one"):
        IsotonicRegression(device="cpu").train(y="y", training_frame=pf)
    with pytest.raises(ValueError, match="out_of_bounds"):
        IsotonicRegression(device="cpu", out_of_bounds="extrapolate")
    with pytest.raises(NotImplementedError, match="P14"):
        IsotonicRegression(device="cpu", recovery_dir="ck").train(
            x=["x0"], y="y", training_frame=pf)


# -- Aggregator ---------------------------------------------------------------

def _agg_data(case):
    rng = np.random.default_rng(42)
    n = 3000
    centers = rng.normal(size=(5, 3)) * 6
    X = (centers[rng.integers(0, 5, n)] +
         rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    cols = {f"x{j}": (X[:, j], None) for j in range(3)}
    kw = dict(target_num_exemplars=100, rel_tol_num_exemplars=0.7)
    if case == "categorical":
        X[rng.uniform(size=n) < 0.02, 1] = np.nan
        cols["x1"] = (X[:, 1], None)
        cols["c"] = ((X[:, 0] > 0).astype(np.int32) +
                     (X[:, 2] > 3).astype(np.int32), list("abc"))
        kw = dict(target_num_exemplars=60, rel_tol_num_exemplars=0.5)
    return _pair(cols), kw


AGG_CASES = ("clusters", "categorical")


@pytest.fixture(scope="module")
def agg_fits(cl):
    out = {}
    for case in AGG_CASES:
        (jf, pf), kw = _agg_data(case)
        out[case] = (jf, pf, kw, JAgg(**kw).train(training_frame=jf),
                     Aggregator(device="cpu", **kw).train(training_frame=pf))
    return out


@pytest.mark.parametrize("case", AGG_CASES)
def test_aggregator_matches_reference(agg_fits, case):
    jf, pf, _, jm, pm = agg_fits[case]
    jo, po = jm.output, pm.output
    assert po["num_exemplars"] == jo["num_exemplars"]
    assert 10 <= po["num_exemplars"] <= 1000
    np.testing.assert_array_equal(po["counts"], np.asarray(jo["counts"]))
    np.testing.assert_allclose(po["radius_scale"], jo["radius_scale"],
                               rtol=1e-6)
    np.testing.assert_allclose(po["exemplars_std"],
                               np.asarray(jo["exemplars_std"]), rtol=0,
                               atol=1e-6)
    agg_j, agg_p = jm.aggregated_frame(), pm.aggregated_frame()
    assert agg_p.names == agg_j.names and agg_p.nrows == po["num_exemplars"]
    for nm in agg_p.names:
        np.testing.assert_array_equal(agg_p.vec(nm).to_numpy(),
                                      np.asarray(agg_j.vec(nm).to_numpy()),
                                      err_msg=nm)
    assert int(agg_p.vec("counts").to_numpy().sum()) == pf.nrows
    got = pm.predict_raw(pf).numpy()
    np.testing.assert_array_equal(got, np.asarray(jm.predict_raw(jf))[
        :pf.nrows])
    assert pm.output["training_metrics"]["num_exemplars"] == \
        jm.output["training_metrics"]["num_exemplars"]


@pytest.mark.parametrize("P", [3, 28, 54])
def test_rowwise_sums_equal_scalar_sums(P):
    rng = np.random.default_rng(P)
    ex = rng.normal(size=(2000, P)).astype(np.float32)
    b = rng.normal(size=P).astype(np.float32)
    rows = np.sum((b - ex) ** 2, axis=1)
    scalar = np.array([np.sum((b - ex[k]) ** 2) for k in range(len(ex))],
                      np.float32)
    np.testing.assert_array_equal(rows, scalar)


def test_aggregator_converter_and_save_load(agg_fits):
    jf, pf, _, jm, _ = agg_fits["clusters"]
    agg_j = jm.aggregated_frame()
    agg = Frame(list(agg_j.names), [Vec(np.asarray(v.to_numpy()))
                                    for v in agg_j.vecs])
    cm = aggregator_from_jax_output(_np(jm.output), jm.params, agg,
                                    device="cpu")
    want = np.asarray(jm.predict_raw(jf))[:pf.nrows]
    np.testing.assert_array_equal(cm.predict_raw(pf).numpy(), want)
    with tempfile.TemporaryDirectory() as d:
        path = cm.save(os.path.join(d, "agg.bin"))
        back = Model.load(path, device="cpu")
    np.testing.assert_array_equal(back.predict_raw(pf).numpy(), want)
    assert back.aggregated_frame().nrows == jm.output["num_exemplars"]


def test_aggregator_refusals():
    (_, pf), _ = _agg_data("clusters")
    with pytest.raises(ValueError, match="transform"):
        Aggregator(device="cpu", transform="DEMEAN")
    with pytest.raises(ValueError, match="categorical_encoding"):
        Aggregator(device="cpu", categorical_encoding="Binary")
    with pytest.raises(ValueError, match="cross-validation"):
        Aggregator(device="cpu", nfolds=3).train(training_frame=pf)
    with pytest.raises(NotImplementedError, match="P14"):
        Aggregator(device="cpu", checkpoint_interval=1).train(
            training_frame=pf)
