"""NaiveBayes in the port held against ``h2o_tpu``'s on the CPU.

The data of ``test_anomaly_nb.py``'s three NaiveBayes tests (a binomial
Gaussian separation, a Laplace-smoothed categorical table, the
3-class sklearn-parity case) and a weighted frame with NAs, a
categorical predictor and a scoring frame with an unseen level go to
``h2o_tpu.models.naive_bayes.NaiveBayes`` (on the 8-device CPU mesh)
and to the port's ``NaiveBayes(device="cpu")``.

Tolerances: the priors, the level tables, the per-class means and
standard deviations within 1e-6 (relative, 1e-7 absolute: sums of
float32 one-hot products in another order); labels equal; class
probabilities within 1e-5; the training metrics (AUC, logloss) within
1e-5 relative.
"""

import os
import tempfile

import numpy as np
import pytest

from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models.naive_bayes import NaiveBayes as JNB

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.model import Model
from h2o_tpu_torch.models.naive_bayes import (NaiveBayes, NaiveBayesModel,
                                              naivebayes_from_jax_output)

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


def _numeric(X, y, dom):
    cols = {f"x{j}": (X[:, j], None) for j in range(X.shape[1])}
    cols["y"] = (y, dom)
    return _pair(cols)


def _data(case):
    rng = np.random.default_rng(42)
    if case == "gaussian":          # test_naive_bayes_gaussian_separation
        y = rng.integers(0, 2, 2000)
        X = rng.normal(size=(2000, 3)).astype(np.float32)
        X[:, 0] += 3.0 * y
        return _numeric(X, y, ["a", "b"]), {}
    if case == "categorical":       # test_naive_bayes_categorical_tables
        y = rng.integers(0, 2, 3000)
        c = np.where(rng.uniform(size=3000) < 0.8, y,
                     rng.integers(0, 2, 3000))
        return _pair({"c1": (c, ["u", "v"]), "y": (y, ["n", "p"])}), \
            dict(laplace=1.0)
    if case == "sklearn":           # test_naive_bayes_sklearn_parity
        y = rng.integers(0, 3, 1500)
        X = (rng.normal(size=(1500, 4)) + y[:, None]).astype(np.float32)
        return _numeric(X, y, ["a", "b", "c"]), dict(min_prob=1e-10,
                                                     min_sdev=1e-10)
    n = 1200
    y = rng.integers(0, 3, n)
    X = (rng.normal(size=(n, 2)) + 0.7 * y[:, None]).astype(np.float32)
    X[rng.uniform(size=n) < 0.05, 0] = np.nan
    c = (y + rng.integers(0, 2, n)) % 4
    c[rng.uniform(size=n) < 0.04] = -1
    w = rng.integers(1, 4, n).astype(np.float32)
    y[rng.uniform(size=n) < 0.02] = -1
    return _pair({"x0": (X[:, 0], None), "x1": (X[:, 1], None),
                  "c": (c, list("pqrs")), "w": (w, None),
                  "y": (y, ["a", "b", "c"])}), \
        dict(weights_column="w", laplace=0.5, eps_sdev=0.05, eps_prob=1e-4)


CASES = ("gaussian", "categorical", "sklearn", "weighted")


@pytest.fixture(scope="module")
def fits(cl):
    out = {}
    for case in CASES:
        (jf, pf), kw = _data(case)
        out[case] = (jf, pf, kw, JNB(**kw).train(y="y", training_frame=jf),
                     NaiveBayes(device="cpu", **kw).train(
                         y="y", training_frame=pf))
    return out


def _close(got, want, rtol=1e-6, atol=1e-7):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", CASES)
def test_tables_match_reference(fits, case):
    _, _, _, jm, pm = fits[case]
    jo, po = jm.output, pm.output
    assert po["x"] == list(jo["x"]) and po["num_names"] == jo["num_names"]
    assert po["response_domain"] == list(jo["response_domain"])
    _close(po["apriori"], jo["apriori"])
    assert sorted(po["pcond_cat"]) == sorted(jo["pcond_cat"])
    for k, v in jo["pcond_cat"].items():
        _close(po["pcond_cat"][k], v)
    if jo["num_names"]:
        _close(po["num_mean"], jo["num_mean"])
        _close(po["num_sd"], jo["num_sd"])


@pytest.mark.parametrize("case", CASES)
def test_scores_match_reference(fits, case):
    jf, pf, _, jm, pm = fits[case]
    n = pf.nrows
    got = pm.predict_raw(pf).numpy()
    want = np.asarray(jm.predict_raw(jf))[:n]
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=0, atol=1e-5)
    jt, pt = jm.output["training_metrics"], pm.output["training_metrics"]
    assert pt.kind == jt.kind
    for key in ("logloss", "AUC", "mse"):
        if key in jt.data:
            np.testing.assert_allclose(pt[key], jt[key], rtol=1e-5)
    if case == "gaussian":            # the reference test's claims
        assert pt["AUC"] > 0.95
        mu = pm.output["num_mean"]
        assert mu[1, 0] - mu[0, 0] > 2.5
    if case == "categorical":
        tab = pm.output["pcond_cat"]["c1"]
        assert tab.shape == (2, 2) and 0.8 < tab[1, 1] < 1.0
        np.testing.assert_allclose(tab.sum(axis=1), 1.0, atol=1e-5)
        y = pf.vec("y").data
        assert float((got[:, 0] == y).mean()) > 0.75


def test_unseen_and_na_levels_skip(fits):
    """A scoring frame whose categorical holds an NA and a code beyond
    the training domain: those rows skip the predictor, as the
    reference's do."""
    jf, pf, _, jm, pm = fits["weighted"]
    codes = pf.vec("c").data.copy()
    codes[:10] = 7
    codes[10:20] = -1
    dom = list("pqrstuvw")
    pf2 = Frame(pf.names, [Vec(codes, T_CAT, domain=dom) if n == "c"
                           else pf.vec(n) for n in pf.names])
    jf2 = JFrame(jf.names, [JVec(codes, J_CAT, domain=dom) if n == "c"
                            else jf.vec(n) for n in jf.names])
    got = pm.predict_raw(pf2).numpy()
    want = np.asarray(jm.predict_raw(jf2))[:pf.nrows]
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=0, atol=1e-5)


def test_converter_scores_as_reference(fits):
    for case in ("categorical", "weighted"):
        jf, pf, _, jm, _ = fits[case]
        cm = naivebayes_from_jax_output(jm.output, jm.params, device="cpu")
        assert isinstance(cm, NaiveBayesModel)
        got = cm.predict(pf)
        want = jm.predict(jf)
        assert got.names == want.names
        np.testing.assert_array_equal(
            got.vec("predict").data,
            np.asarray(want.vec("predict").to_numpy())[:pf.nrows])
        for name in got.names[1:]:
            np.testing.assert_allclose(
                got.vec(name).data,
                np.asarray(want.vec(name).to_numpy())[:pf.nrows],
                rtol=0, atol=1e-5)


def test_validation_metrics_and_save_load(fits):
    _, pf, kw, _, pm = fits["sklearn"]
    m = NaiveBayes(device="cpu", **kw).train(y="y", training_frame=pf,
                                             validation_frame=pf)
    assert m.output["validation_metrics"]["logloss"] == \
        m.output["training_metrics"]["logloss"]
    with tempfile.TemporaryDirectory() as d:
        m2 = Model.load(pm.save(os.path.join(d, "nb.bin")), device="cpu")
    assert isinstance(m2, NaiveBayesModel)
    np.testing.assert_array_equal(m2.predict_raw(pf).numpy(),
                                  pm.predict_raw(pf).numpy())


def test_refusals(fits):
    _, pf, _, _, _ = fits["gaussian"]
    fr = Frame(pf.names[:-1] + ["y"], [pf.vec(n) for n in pf.names[:-1]] +
               [Vec(np.arange(pf.nrows, dtype=np.float32))])
    with pytest.raises(ValueError, match="categorical response"):
        NaiveBayes(device="cpu").train(y="y", training_frame=fr)
    with pytest.raises(ValueError, match="requires a response"):
        NaiveBayes(device="cpu").train(training_frame=pf.drop("y"))
