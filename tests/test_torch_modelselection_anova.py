"""ModelSelection and AnovaGLM in the port held against ``h2o_tpu``'s on
the CPU.

ModelSelection on ``test_rules_selection.py``'s data: maxr up to 3 of 5
predictors (gaussian, R²) and backward from 4 (gaussian), and a
binomial maxr up to 2 of 4 (minus the logloss): every size's chosen
predictors equal and its score within 1e-5 relative (the port's GLM at
lambda 0, its solves on the host in float32: coefficients within 1e-5
of the reference's); the GLM kept at ``best_models[size]["model"]``
scores like the reference's of that size.

AnovaGLM on the same file's data (gaussian, 3 predictors) and on a
binomial frame with ``highest_interaction_term`` 2 (3 predictors and
their 3 products): the table's terms and degrees of freedom equal; the
full and every drop-one GLM's residual deviance, and the dispersion,
within 1e-5 relative.  A term's statistic is the difference of two
deviances over the dispersion, which cancels their float32 agreement:
it is held within 1e-4 relative or, where that cancellation is larger,
within 1e-5 of the two deviances over the dispersion; its p-value within
1e-4 or inside the chi-square tail of that interval (the tail is the
reference's code, equal on the same input).  The reference test's claims
hold.

Each converter (through ``glm_from_jax_output``) keeps what the
reference model holds; ``Model.save``/``load`` round-trips the held
GLMs onto the device asked for; ``predict_raw`` and unknown modes are
refused by name.
"""

import os
import tempfile

import numpy as np
import pytest

from h2o_tpu.core.cloud import cloud as jcloud
from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models.anovaglm import AnovaGLM as JAnova
from h2o_tpu.models.anovaglm import _chi2_sf as j_chi2_sf
from h2o_tpu.models.modelselection import ModelSelection as JMS

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.anovaglm import (AnovaGLM, _chi2_sf,
                                           anovaglm_from_jax_output)
from h2o_tpu_torch.models.model import Model
from h2o_tpu_torch.models.modelselection import (
    ModelSelection, modelselection_from_jax_output)
from h2o_tpu_torch.core.store import unpublish_on_exit


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv


def _pair(X, y, y_dom=None):
    names = [f"x{j}" for j in range(X.shape[1])] + ["y"]
    jv = [JVec(X[:, j]) for j in range(X.shape[1])]
    pv = [Vec(X[:, j]) for j in range(X.shape[1])]
    if y_dom:
        jv.append(JVec(y.astype(np.int32), J_CAT, domain=y_dom))
        pv.append(Vec(y.astype(np.int32), T_CAT, domain=y_dom))
    else:
        jv.append(JVec(y.astype(np.float32)))
        pv.append(Vec(y.astype(np.float32)))
    return JFrame(names, jv), Frame(names, pv)


def _np(out):
    return {k: (np.asarray(v) if hasattr(v, "shape") else v)
            for k, v in out.items()}


def _ms_data(case):
    rng = np.random.default_rng(42)
    if case == "maxr":
        n = 1500
        X = rng.normal(size=(n, 5)).astype(np.float32)
        y = 2 * X[:, 0] + X[:, 1] + 0.5 * X[:, 2] + 0.1 * rng.normal(size=n)
        return _pair(X, y), dict(mode="maxr", max_predictor_number=3)
    if case == "backward":
        n = 1000
        X = rng.normal(size=(n, 4)).astype(np.float32)
        y = X[:, 0] - 2 * X[:, 3] + 0.1 * rng.normal(size=n)
        return _pair(X, y), dict(mode="backward", max_predictor_number=4,
                                 min_predictor_number=1)
    n = 1200
    X = rng.normal(size=(n, 4)).astype(np.float32)
    logit = 1.5 * X[:, 2] - X[:, 0] + 0.3 * X[:, 1]
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.int32)
    return _pair(X, y, ["a", "b"]), dict(mode="maxr", max_predictor_number=2)


MS_CASES = ("maxr", "backward", "binomial")


@pytest.fixture(scope="module")
def ms_fits(cl):
    out = {}
    for case in MS_CASES:
        (jf, pf), kw = _ms_data(case)
        out[case] = (jf, pf, kw, JMS(seed=1, **kw).train(
            y="y", training_frame=jf), ModelSelection(
            device="cpu", seed=1, **kw).train(y="y", training_frame=pf))
    return out


@pytest.mark.parametrize("case", MS_CASES)
def test_modelselection_matches_reference(ms_fits, case):
    jf, pf, _, jm, pm = ms_fits[case]
    jb, pb = jm.best_model_per_size(), pm.best_model_per_size()
    assert sorted(pb) == sorted(jb)
    for size in jb:
        assert pb[size]["predictors"] == jb[size]["predictors"], size
        np.testing.assert_allclose(pb[size]["score"], jb[size]["score"],
                                   rtol=1e-5)
        for k, v in jb[size]["coef"].items():
            assert abs(pb[size]["coef"][k] - v) <= 1e-5 * max(1.0, abs(v))
        jg = jcloud().dkv.get(jb[size]["model_id"])
        np.testing.assert_allclose(
            pb[size]["model"].predict_raw(pf).numpy(),
            np.asarray(jg.predict_raw(jf))[: pf.nrows], rtol=0, atol=1e-5)
    assert pm.output["training_metrics"]["sizes"] == sorted(jb)
    if case == "maxr":                  # the reference test's claims
        assert pb[1]["predictors"] == ["x0"]
        assert set(pb[3]["predictors"]) == {"x0", "x1", "x2"}
        assert pb[1]["score"] < pb[2]["score"] < pb[3]["score"]
    if case == "backward":
        assert set(pb[2]["predictors"]) == {"x0", "x3"}


def test_modelselection_converter_save_load_and_refusals(ms_fits):
    jf, pf, _, jm, pm = ms_fits["maxr"]
    glm_outs = {s: _np(jcloud().dkv.get(r["model_id"]).output)
                for s, r in jm.output["best_models"].items()}
    cm = modelselection_from_jax_output(jm.output, jm.params, glm_outs,
                                        device="cpu")
    for s, r in jm.output["best_models"].items():
        assert cm.best_model_per_size()[s]["predictors"] == r["predictors"]
        np.testing.assert_allclose(
            cm.best_model_per_size()[s]["model"].predict_raw(pf).numpy(),
            np.asarray(jcloud().dkv.get(r["model_id"]).predict_raw(jf))[
                : pf.nrows], rtol=0, atol=1e-6)
    with tempfile.TemporaryDirectory() as d:
        back = Model.load(pm.save(os.path.join(d, "ms.bin")), device="cpu")
    g = back.best_model_per_size()[2]["model"]
    assert str(g.device) == "cpu"
    np.testing.assert_array_equal(
        g.predict_raw(pf).numpy(),
        pm.best_model_per_size()[2]["model"].predict_raw(pf).numpy())
    assert back.coef(2) == pm.coef(2)
    with pytest.raises(NotImplementedError, match="best_models"):
        pm.predict_raw(pf)
    with pytest.raises(ValueError, match="mode"):
        ModelSelection(device="cpu", mode="sideways")
    with pytest.raises(ValueError, match="p_values_threshold"):
        ModelSelection(device="cpu", p_values_threshold=0.05)


# -- AnovaGLM -----------------------------------------------------------------

def _anova_data(case):
    rng = np.random.default_rng(42)
    n = 1200
    X = rng.normal(size=(n, 3)).astype(np.float32)
    if case == "gaussian":
        y = 1.5 * X[:, 0] + 0.1 * rng.normal(size=n)
        return _pair(X, y), dict(family="gaussian")
    logit = X[:, 0] - 0.8 * X[:, 1] + 0.9 * X[:, 0] * X[:, 2]
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.int32)
    return _pair(X, y, ["n", "p"]), dict(highest_interaction_term=2)


ANOVA_CASES = ("gaussian", "binomial_interactions")


@pytest.fixture(scope="module")
def anova_fits(cl):
    out = {}
    for case in ANOVA_CASES:
        (jf, pf), kw = _anova_data(case)
        out[case] = (jf, pf, kw, JAnova(seed=1, **kw).train(
            y="y", training_frame=jf), AnovaGLM(
            device="cpu", seed=1, **kw).train(y="y", training_frame=pf))
    return out


@pytest.mark.parametrize("case", ANOVA_CASES)
def test_anova_matches_reference(anova_fits, case):
    _, _, _, jm, pm = anova_fits[case]
    jt, pt = jm.result(), pm.result()
    po = pm.output
    assert [r[:2] for r in pt] == [tuple(r[:2]) for r in jt]
    j_full = jcloud().dkv.get(jm.output["full_model_id"])
    dev_full = float(j_full.output["residual_deviance"])
    nobs = float(j_full.output["training_metrics"]["nobs"])
    disp = max(dev_full / max(nobs - len(j_full.coef()), 1.0), 1e-30) \
        if jm.output["family"] == "gaussian" else 1.0
    np.testing.assert_allclose(po["full_deviance"], dev_full, rtol=1e-5)
    np.testing.assert_allclose(po["dispersion"], disp, rtol=1e-5)
    for a, b, dev_sub in zip(pt, jt, po["term_deviances"]):
        # the drop-one GLM's deviance, rebuilt from the reference's row
        np.testing.assert_allclose(dev_sub, b[2] * disp + dev_full,
                                   rtol=1e-5, err_msg=a[0])
        # the statistic is a difference of two deviances: 1e-4 relative,
        # or the cancellation of their 1e-5 agreement over the dispersion
        bound = 1e-4 * abs(b[2]) + 1e-5 * (dev_sub + dev_full) / disp
        assert abs(a[2] - b[2]) <= bound, (a, b, bound)
        # p: 1e-4, or the chi-square tail over that interval
        lo = j_chi2_sf(b[2] + bound, b[1])
        hi = j_chi2_sf(max(b[2] - bound, 0.0), b[1])
        assert abs(a[3] - b[3]) <= 1e-4 or lo <= a[3] <= hi, (a, b)
    assert po["training_metrics"]["terms"] == [r[0] for r in jt]
    if case == "gaussian":              # the reference test's claims
        table = {r[0]: r for r in pt}
        assert table["x0"][3] < 1e-6 and table["x1"][3] > 0.01
    else:
        assert len(pt) == 6 and pt[-1][0] == "x1:x2"


def test_chi2_sf_is_the_reference_tail():
    for x, df in ((0.0, 1), (0.5, 1), (3.84, 1), (10.0, 3), (50.0, 2),
                  (400.0, 5), (1e-3, 4), (7.5, 7)):
        assert _chi2_sf(x, df) == j_chi2_sf(x, df)


def test_anova_converter_save_load_and_refusals(anova_fits):
    jf, pf, _, jm, pm = anova_fits["binomial_interactions"]
    full = _np(jcloud().dkv.get(jm.output["full_model_id"]).output)
    cm = anovaglm_from_jax_output(jm.output, jm.params, full, device="cpu")
    assert cm.result() == [tuple(r) for r in jm.result()]
    assert cm.output["full_model"].coef().keys() == \
        pm.output["full_model"].coef().keys()
    with tempfile.TemporaryDirectory() as d:
        back = Model.load(pm.save(os.path.join(d, "anova.bin")),
                          device="cpu")
    assert back.result() == pm.result()
    assert str(back.output["full_model"].device) == "cpu"
    with pytest.raises(NotImplementedError, match="analysis"):
        pm.predict_raw(pf)
    with pytest.raises(NotImplementedError, match="P14"):
        AnovaGLM(device="cpu", recovery_dir="ck").train(y="y",
                                                        training_frame=pf)
