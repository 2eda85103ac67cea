"""GLM in the port held against ``h2o_tpu``'s on the CPU.

Every case feeds the same seeded numpy columns (4 numerics, one with
NaNs, and a 4-level categorical with NA codes; 2,000 training rows and
400 validation rows) to ``h2o_tpu.models.glm.GLM`` and to the port's
``GLM(device="cpu")``:

- every family with IRLSM (COD inside when L1 applies): gaussian,
  binomial, quasibinomial, poisson, gamma, tweedie, fractionalbinomial,
  negativebinomial; L_BFGS on gaussian, binomial, tweedie and
  negativebinomial; multinomial by per-class IRLSM (default and with
  lambda) and by the joint-softmax L_BFGS; ordinal's Adam;
- lambda search with and without a validation frame, p-values (gaussian
  and binomial), beta constraints (dict and Frame) and non_negative;
- the AUTO solver routing of ``test_glm_lbfgs.py::test_auto_routing``,
  every reference error with the reference's exception type, a 3-fold
  CV, save/load, and models carried across by ``glm_from_jax_output``.

Tolerances: iteration counts, solvers and best-lambda indices equal,
lambda sequences within 1e-5 relative (lambda_max comes from float32
sums); coefficients and ``coef()``/``coef_norm()`` within 1e-5 and
predictions within 1e-5 absolute or relative (the Gram sums in another
order than XLA's; ordinal after its 2,000 Adam steps); metrics within
1e-5 relative; std errors 1e-5 relative, p-values 1e-6 absolute; a
carried model's predictions within 1e-6 absolute or relative.
L-BFGS ends where 30 halvings of the step find no float32 decrease of
an objective of ~10^3: its last steps are rounding noise in both
packages, so its count may differ by 2 and its coefficients and
predictions by 1e-3 (the objective's float32 resolution at this
curvature), its metrics by 1e-4 relative; the multinomial L-BFGS is
held by its probabilities (softmax coefficients are free along a
per-row constant).  The port's poisson L-BFGS differs on
purpose: the reference's gradient is NaN where a count is 0, so its
L-BFGS stops at the start (see the last test).
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models.glm import GLM as JGLM

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.glm import GLM, GLMModel, glm_from_jax_output
from h2o_tpu_torch.models.model import Model
from h2o_tpu_torch.core.store import unpublish_on_exit


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv

N, NV = 2000, 400
ATOL = 1e-5
_REG = ("mse", "mae", "r2", "mean_residual_deviance")
_BIN = ("AUC", "logloss", "mse", "mean_per_class_error")
_MULTI = ("logloss", "err", "mse", "mean_per_class_error")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _xcols(seed=0, n=N + NV):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    X[rng.uniform(size=n) < 0.05, 1] = np.nan
    cat = rng.integers(0, 4, n).astype(np.int32)
    cat[rng.uniform(size=n) < 0.03] = -1
    eta = 0.5 * X[:, 0] - 0.3 * np.nan_to_num(X[:, 1]) + 0.2 * (cat == 2)
    return rng, X, cat, eta


def _responses():
    rng, X, cat, eta = _xcols()
    n = X.shape[0]
    p = 1 / (1 + np.exp(-2 * eta))
    ym = rng.integers(0, 3, n).astype(np.int32)
    ym = np.where(X[:, 0] > 0.7, 2, np.where(X[:, 0] < -0.5, 0, ym))
    ym[rng.uniform(size=n) < 0.02] = -1          # missing responses
    return X, cat, {
        "gaussian": (eta + rng.normal(size=n)).astype(np.float32),
        "binomial": ((rng.uniform(size=n) < p).astype(np.int32),
                     ["n", "y"]),
        "quasibinomial": (rng.uniform(size=n) < p).astype(np.float32),
        "poisson": rng.poisson(np.exp(eta)).astype(np.float32),
        "gamma": rng.gamma(2.0, np.exp(eta) / 2).astype(np.float32),
        "tweedie": (rng.poisson(np.exp(eta)) *
                    rng.gamma(2.0, 0.5, n)).astype(np.float32),
        "negativebinomial": rng.poisson(np.exp(eta)).astype(np.float32),
        "fractionalbinomial": (1 / (1 + np.exp(-eta))).astype(np.float32),
        "multinomial": (ym.astype(np.int32), ["lo", "mid", "hi"]),
    }


FAMILY_KW = {"tweedie": dict(tweedie_power=1.3),
             "negativebinomial": dict(theta=0.5)}


def _pair(X, cat, y, rows):
    names = ["a", "b", "c", "d", "k", "y"]
    dom = None
    if isinstance(y, tuple):
        y, dom = y
    X, cat, y = X[rows], cat[rows], y[rows]
    jy = JVec(y, J_CAT, domain=dom) if dom else JVec(y)
    py = Vec(y, T_CAT, domain=dom) if dom else Vec(y)
    return (JFrame(names, [JVec(X[:, j]) for j in range(4)] +
                   [JVec(cat, J_CAT, domain=list("pqrs")), jy]),
            Frame(names, [Vec(X[:, j]) for j in range(4)] +
                  [Vec(cat, T_CAT, domain=list("pqrs")), py]))


@pytest.fixture(scope="module")
def data(cl):
    """response name -> (JAX train, port train, JAX valid, port valid)."""
    X, cat, ys = _responses()
    out = {}
    for name, y in ys.items():
        out[name] = _pair(X, cat, y, slice(0, N)) + \
            _pair(X, cat, y, slice(N, N + NV))
    return out


@pytest.fixture(scope="module")
def trained(data):
    """Module cache of (JAX model, port model) by a key; ``fit(key,
    response, **params)`` trains both once with the validation frame."""
    cache = {}

    def fit(key, response, valid=True, **kw):
        if key not in cache:
            jf, pf, jv, pv = data[response]
            jm = JGLM(**kw).train(y="y", training_frame=jf,
                                  validation_frame=jv if valid else None)
            pm = GLM(device="cpu", **kw).train(
                y="y", training_frame=pf,
                validation_frame=pv if valid else None)
            cache[key] = (jm, pm)
        return cache[key]
    return fit


def _metrics_close(want, got, keys, rtol=1e-5):
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-7,
                                   err_msg=k)


def _table_close(want, got, tol=ATOL):
    wc = [c["name"] for c in want["columns"]]
    assert [c["name"] for c in got["columns"]] == wc
    assert got["data"][0] == want["data"][0]
    for j in range(1, len(wc)):
        np.testing.assert_allclose(
            got["data"][j], want["data"][j],
            atol=1e-6 if wc[j] == "p_value" else tol,
            rtol=1e-5 if wc[j] in ("std_error", "z_value") else 0,
            err_msg=wc[j])


def _same_model(jm, pm, jf, pf, keys, jv=None, pv=None, beta_atol=ATOL,
                pred_tol=ATOL, metric_rtol=1e-5, iters_within=0):
    assert pm.params["_solver_resolved"] == jm.params["_solver_resolved"]
    if iters_within:
        assert abs(pm.output["iterations"] - jm.output["iterations"]) <= \
            iters_within
    else:
        assert pm.output.get("iterations") == jm.output.get("iterations")
    assert pm.output["coef_names"] == list(jm.output["coef_names"])
    key = "beta_multinomial" if jm.output.get("is_multinomial") else "beta"
    np.testing.assert_allclose(pm.output[key], np.asarray(jm.output[key]),
                               rtol=0, atol=beta_atol)
    np.testing.assert_allclose(
        pm.predict_raw(pf).numpy(),
        np.asarray(jm.predict_raw(jf))[:pf.nrows], rtol=pred_tol,
        atol=pred_tol)
    _metrics_close(jm.output["training_metrics"],
                   pm.output["training_metrics"], keys, metric_rtol)
    if jv is not None:
        _metrics_close(jm.output["validation_metrics"],
                       pm.output["validation_metrics"], keys, metric_rtol)
    if key == "beta":
        for f in ("coef", "coef_norm"):
            want, got = getattr(jm, f)(), getattr(pm, f)()
            assert list(got) == list(want)
            np.testing.assert_allclose(list(got.values()),
                                       list(want.values()), rtol=1e-5,
                                       atol=beta_atol, err_msg=f)
        _table_close(jm.output["coefficients_table"],
                     pm.output["coefficients_table"], beta_atol)


IRLSM_FAMILIES = ("gaussian", "binomial", "quasibinomial", "poisson",
                  "gamma", "tweedie", "fractionalbinomial",
                  "negativebinomial")


@pytest.mark.parametrize("family", IRLSM_FAMILIES)
def test_family_irlsm(data, trained, family):
    jf, pf, jv, pv = data[family]
    jm, pm = trained(("irlsm", family), family, family=family,
                     **FAMILY_KW.get(family, {}))
    assert pm.params["_solver_resolved"] == "IRLSM"
    keys = _BIN if family == "binomial" else _REG
    _same_model(jm, pm, jf, pf, keys, jv, pv)
    assert pm.output["lambda_used"] == pytest.approx(
        jm.output["lambda_used"], rel=1e-5)


@pytest.mark.parametrize("family", ["gaussian", "binomial", "tweedie",
                                    "negativebinomial"])
def test_family_lbfgs(data, trained, family):
    jf, pf, jv, pv = data[family]
    jm, pm = trained(("lbfgs", family), family, family=family,
                     solver="L_BFGS", **FAMILY_KW.get(family, {}))
    keys = _BIN if family == "binomial" else _REG
    _same_model(jm, pm, jf, pf, keys, jv, pv, beta_atol=1e-3,
                pred_tol=1e-3, metric_rtol=1e-4, iters_within=2)


@pytest.mark.parametrize("case", ["default", "lambda", "lbfgs"])
def test_multinomial(data, trained, case):
    jf, pf, jv, pv = data["multinomial"]
    kw = {"default": {}, "lambda": dict(lambda_=1e-3, alpha=0.5),
          "lbfgs": dict(solver="L_BFGS", alpha=0.0, lambda_=0.0)}[case]
    jm, pm = trained(("multinomial", case), "multinomial",
                     family="multinomial", **kw)
    if case == "lbfgs":
        # softmax coefficients are free along a constant per row: hold
        # the probabilities instead
        assert pm.params["_solver_resolved"] == "L_BFGS"
        np.testing.assert_allclose(
            pm.predict_raw(pf).numpy(),
            np.asarray(jm.predict_raw(jf))[:pf.nrows], rtol=0, atol=1e-3)
        _metrics_close(jm.output["training_metrics"],
                       pm.output["training_metrics"], _MULTI, 1e-4)
        return
    _same_model(jm, pm, jf, pf, _MULTI, jv, pv)


def test_ordinal(data, trained):
    jf, pf, jv, pv = data["multinomial"]
    jm, pm = trained("ordinal", "multinomial", family="ordinal",
                     max_iterations=10)
    assert pm.output["is_ordinal"]
    np.testing.assert_allclose(pm.output["ordinal_thresholds"],
                               np.asarray(jm.output["ordinal_thresholds"]),
                               rtol=0, atol=ATOL)
    _same_model(jm, pm, jf, pf, _MULTI, jv, pv)


@pytest.mark.parametrize("valid", [True, False])
def test_lambda_search(data, trained, valid):
    jf, pf, jv, pv = data["binomial"]
    kw = dict(lambda_search=True, nlambdas=20) if valid else \
        dict(lambda_search=True, alpha=0.0, nlambdas=15)
    jm, pm = trained(("search", valid), "binomial", valid=valid, **kw)
    assert pm.params["_solver_resolved"] == "COORDINATE_DESCENT"
    jo, po = jm.output, pm.output
    jr, pr = jo["reg_path"], po["reg_path"]
    assert len(pr["lambdas"]) == len(jr["lambdas"])
    np.testing.assert_allclose(pr["lambdas"], jr["lambdas"], rtol=1e-5)
    assert pr["lambdas"].index(po["lambda_best"]) == \
        jr["lambdas"].index(jo["lambda_best"])
    for k in ("lambda_max", "lambda_min", "alpha_best", "null_deviance"):
        assert po[k] == pytest.approx(jo[k], rel=1e-5), k
    np.testing.assert_allclose(pr["explained_deviance_train"],
                               jr["explained_deviance_train"], atol=1e-6)
    if valid:
        np.testing.assert_allclose(pr["explained_deviance_valid"],
                                   jr["explained_deviance_valid"],
                                   atol=1e-6)
    else:
        assert pr["explained_deviance_valid"] is None
    np.testing.assert_allclose(pr["coefficients"], jr["coefficients"],
                               atol=ATOL)
    _same_model(jm, pm, jf, pf, _BIN, jv if valid else None,
                pv if valid else None)


@pytest.mark.parametrize("family", ["gaussian", "binomial"])
def test_p_values(data, trained, family):
    jf, pf, jv, pv = data[family]
    jm, pm = trained(("pvalues", family), family, family=family,
                     lambda_=0.0, compute_p_values=True)
    jo, po = jm.output, pm.output
    np.testing.assert_allclose(po["std_errs"], jo["std_errs"], rtol=1e-5)
    np.testing.assert_allclose(po["p_values"], jo["p_values"], atol=1e-6)
    np.testing.assert_allclose(po["z_values"], jo["z_values"], rtol=1e-5,
                               atol=1e-4)
    assert (po["dispersion_df"] is None) == (jo["dispersion_df"] is None)
    assert po["dispersion"] == pytest.approx(jo["dispersion"], rel=1e-5)
    _same_model(jm, pm, jf, pf, _BIN if family == "binomial" else _REG,
                jv, pv)


def _bounds_frames():
    names, lo, hi = ["a", "b", "Intercept"], [-0.1, 0.0, -1.0], \
        [0.3, 5.0, 0.05]
    codes = np.arange(3, dtype=np.int32)
    return (JFrame(["names", "lower_bounds", "upper_bounds"],
                   [JVec(codes, J_CAT, domain=names),
                    JVec(np.asarray(lo, np.float32)),
                    JVec(np.asarray(hi, np.float32))]),
            Frame(["names", "lower_bounds", "upper_bounds"],
                  [Vec(codes, T_CAT, domain=names),
                   Vec(np.asarray(lo, np.float32)),
                   Vec(np.asarray(hi, np.float32))]))


@pytest.mark.parametrize("case", ["dict", "frame", "non_negative"])
def test_bounds(data, case):
    jf, pf, _, _ = data["binomial"]
    if case == "dict":
        jkw = pkw = dict(beta_constraints={"a": (-0.1, 0.3),
                                           "b": (0.0, None)})
    elif case == "frame":
        jb, pb = _bounds_frames()
        jkw, pkw = dict(beta_constraints=jb), dict(beta_constraints=pb)
    else:
        jkw = pkw = dict(non_negative=True)
    jm = JGLM(**jkw).train(y="y", training_frame=jf)
    pm = GLM(device="cpu", **pkw).train(y="y", training_frame=pf)
    assert pm.params["_solver_resolved"] == "COORDINATE_DESCENT"
    _same_model(jm, pm, jf, pf, _BIN)
    co = pm.coef()
    if case == "non_negative":
        assert min(v for k, v in co.items() if k != "Intercept") >= 0
    else:
        assert -0.1 - 1e-6 <= co["a"] <= 0.3 + 1e-6 and co["b"] >= -1e-6
        if case == "frame":
            assert -1.0 - 1e-6 <= co["Intercept"] <= 0.05 + 1e-6


def test_auto_routing(cl):
    """``test_glm_lbfgs.py::test_auto_routing``'s data and cases."""
    rng = np.random.default_rng(0)
    n, p_ = 300, 5
    X = rng.normal(size=(n, p_)).astype(np.float32)
    beta_true = np.array([1.5, -2.0, 0.7, 0.0, 0.5])
    yb = (rng.uniform(size=n) <
          1 / (1 + np.exp(-(X @ beta_true + 0.3)))).astype(np.int32)
    ym = np.random.default_rng(3).integers(0, 3, n).astype(np.int32)
    cols = [f"x{j}" for j in range(p_)]

    def frames(y, dom):
        return (JFrame(cols + ["y"], [JVec(X[:, j]) for j in range(p_)] +
                       [JVec(y, J_CAT, domain=dom)]),
                Frame(cols + ["y"], [Vec(X[:, j]) for j in range(p_)] +
                      [Vec(y, T_CAT, domain=dom)]))
    fb, fm = frames(yb, ["0", "1"]), frames(ym, ["a", "b", "c"])
    for (jf, pf), kw, want in (
            (fb, dict(family="binomial", lambda_=0.0), "IRLSM"),
            (fm, dict(family="multinomial", alpha=0.0, lambda_=0.0),
             "L_BFGS"),
            (fb, dict(family="binomial", lambda_search=True, nlambdas=5),
             "COORDINATE_DESCENT")):
        jm = JGLM(**kw).train(x=cols, y="y", training_frame=jf)
        pm = GLM(device="cpu", **kw).train(x=cols, y="y", training_frame=pf)
        assert jm.params["_solver_resolved"] == want
        assert pm.params["_solver_resolved"] == want


ERRORS = {
    "fractional_categorical": ("binomial", dict(family="fractionalbinomial")),
    "fractional_range": ("gaussian", dict(family="fractionalbinomial")),
    "negbin_negative": ("gaussian", dict(family="negativebinomial")),
    "p_values_lambda": ("gaussian", dict(compute_p_values=True,
                                         lambda_=0.1)),
    "p_values_search": ("gaussian", dict(compute_p_values=True,
                                         lambda_search=True)),
    "p_values_multinomial": ("multinomial", dict(compute_p_values=True)),
    "constraints_multinomial": ("multinomial",
                                dict(beta_constraints={"a": (0, 1)})),
    "constraints_unknown": ("binomial",
                            dict(beta_constraints={"zz": (0, 1)})),
    "constraints_crossed": ("binomial",
                            dict(beta_constraints={"a": (1.0, 0.0)})),
    "lbfgs_non_negative": ("binomial", dict(solver="L_BFGS",
                                            non_negative=True)),
    "lbfgs_l1": ("binomial", dict(solver="L_BFGS", alpha=0.5,
                                  lambda_=0.1)),
    "lbfgs_multinomial_l1": ("multinomial", dict(solver="L_BFGS",
                                                 alpha=0.5, lambda_=0.1)),
    "unknown_family": ("gaussian", dict(family="weibull")),
    "ordinal_numeric": ("gaussian", dict(family="ordinal")),
    "solver_admm": ("gaussian", dict(solver="ADMM")),
    "link_logit": ("gaussian", dict(link="logit")),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_reference_errors(data, case):
    response, kw = ERRORS[case]
    jf, pf, _, _ = data[response]
    with pytest.raises(Exception) as jerr:
        JGLM(**kw).train(y="y", training_frame=jf)
    with pytest.raises(jerr.type):
        GLM(device="cpu", **kw).train(y="y", training_frame=pf)


def test_refusals(data):
    """offset_column (the reference ignores it), and what comes later."""
    jf, pf, _, _ = data["gaussian"]
    with pytest.raises(ValueError, match="never reads"):
        GLM(device="cpu", offset_column="d").train(y="y", training_frame=pf)
    # the reference's silent result the refusal stands for: a constant
    # offset of 5.0 leaves its coefficients as they were
    jf5 = JFrame(jf.names + ["off"], jf.vecs + [JVec(np.full(
        N, 5.0, np.float32))])
    j0 = JGLM(lambda_=0.0).train(y="y", training_frame=jf)
    j5 = JGLM(lambda_=0.0, offset_column="off").train(y="y",
                                                      training_frame=jf5)
    np.testing.assert_array_equal(np.asarray(j5.output["beta"]),
                                  np.asarray(j0.output["beta"]))
    # recovery_dir: IRLSM checkpoints each iteration into the build's
    # snapshot, which the finished build drops, as the reference's does
    from h2o_tpu_torch.core.recovery import pending_recoveries
    with tempfile.TemporaryDirectory() as d:
        m = GLM(device="cpu", recovery_dir=d).train(y="y",
                                                   training_frame=pf)
        assert pending_recoveries(d) == [] and os.listdir(d) == []
    assert m.output["beta"].tobytes() == GLM(device="cpu").train(
        y="y", training_frame=pf).output["beta"].tobytes()
    # a key the DKV does not hold is refused as the reference refuses it;
    # a custom metric that does not load records NaN, as there
    with pytest.raises(ValueError, match="bc_key"):
        GLM(device="cpu", beta_constraints="bc_key").train(
            y="y", training_frame=pf)
    m = GLM(device="cpu", custom_metric_func="python:m=x.M").train(
        y="y", training_frame=pf)
    assert np.isnan(m.output["training_metrics"]["custom_metric_value"])
    b = GLM(device="cpu")
    b.params["_warm_start_beta"] = np.zeros(8, np.float32)
    with pytest.raises(NotImplementedError, match="P14"):
        b.train(y="y", training_frame=pf)


def test_cross_validation(data, cl):
    jf, pf, _, _ = data["binomial"]
    kw = dict(nfolds=3, fold_assignment="Modulo", seed=1)
    jm = JGLM(**kw).train(y="y", training_frame=jf)
    pm = GLM(device="cpu", **kw).train(y="y", training_frame=pf)
    _same_model(jm, pm, jf, pf, _BIN)
    _metrics_close(jm.output["cross_validation_metrics"],
                   pm.output["cross_validation_metrics"], _BIN)
    js = jm.output["cross_validation_metrics_summary"]
    ps = pm.output["cross_validation_metrics_summary"]
    for k in _BIN:
        np.testing.assert_allclose(ps[k]["values"], js[k]["values"],
                                   rtol=1e-5, err_msg=k)
    assert len(pm.output["cross_validation_models"]) == 3


def test_save_load(trained, data):
    for key, resp, kw in ((("irlsm", "binomial"), "binomial",
                           dict(family="binomial")),
                          ("ordinal", "multinomial",
                           dict(family="ordinal", max_iterations=10))):
        _, pm = trained(key, resp, **kw)
        pf = data[resp][1]
        with tempfile.TemporaryDirectory() as d:
            path = pm.save(os.path.join(d, "glm.bin"))
            m2 = Model.load(path, device="cpu")
        assert isinstance(m2, GLMModel)
        np.testing.assert_array_equal(m2.predict_raw(pf).numpy(),
                                      pm.predict_raw(pf).numpy())
        assert m2.coef_norm() == pm.coef_norm()


@pytest.mark.parametrize("case", [
    ("binomial", ("irlsm", "binomial"), dict(family="binomial")),
    ("multinomial", ("multinomial", "default"), dict(family="multinomial")),
    ("multinomial", "ordinal", dict(family="ordinal", max_iterations=10)),
    ("tweedie", ("irlsm", "tweedie"), dict(family="tweedie",
                                           tweedie_power=1.3)),
], ids=["binomial", "multinomial", "ordinal", "tweedie"])
def test_converter(trained, data, case):
    resp, key, kw = case
    jm, _ = trained(key, resp, **kw)
    jf, pf = data[resp][:2]
    out = {k: (np.asarray(v) if hasattr(v, "shape") else v)
           for k, v in jm.output.items()}
    cm = glm_from_jax_output(out, jm.params, device="cpu")
    np.testing.assert_allclose(
        cm.predict_raw(pf).numpy(),
        np.asarray(jm.predict_raw(jf))[:pf.nrows], rtol=1e-6, atol=1e-6)
    if not out.get("is_multinomial"):
        _table_close(jm.output["coefficients_table"],
                     cm.output["coefficients_table"])


def test_poisson_lbfgs_gradient(data):
    """The reference's poisson deviance takes y log(y / mu) where y > 0;
    at y = 0 the masked branch makes its gradient NaN, so its L-BFGS
    ends at its first iterate.  The port's value is the same and its
    gradient finite: its L-BFGS reaches IRLSM's solution."""
    jf, pf, _, _ = data["poisson"]
    assert (pf.vec("y").data == 0).any()
    jl = JGLM(family="poisson", solver="L_BFGS").train(y="y",
                                                       training_frame=jf)
    pl = GLM(device="cpu", family="poisson", solver="L_BFGS").train(
        y="y", training_frame=pf)
    pi = GLM(device="cpu", family="poisson", solver="IRLSM",
             alpha=0.0).train(y="y", training_frame=pf)
    assert jl.output["iterations"] == 1
    assert pl.output["iterations"] > 1
    # the same objective (alpha 0, the same lambda) solved by IRLSM
    assert pl.output["lambda_used"] == pi.output["lambda_used"]
    np.testing.assert_allclose(pl.output["beta"], pi.output["beta"],
                               atol=1e-4)
    assert pl.output["residual_deviance"] < jl.output["residual_deviance"]


def test_gam_wiring(data):
    """GAM's private wiring, set on the builders' params after
    construction as GAM does: a quadratic penalty block over (a, b) and
    a non-negative clamp on c."""
    jf, pf, jv, pv = data["binomial"]
    S = np.array([[1.0, -1.0], [-1.0, 1.0]])
    jb, pb = JGLM(), GLM(device="cpu")
    for b in (jb, pb):
        b.params["_penalty_blocks"] = [(["a", "b"], S, 50.0)]
        b.params["_nonneg_names"] = ["c"]
    jm = jb.train(y="y", training_frame=jf, validation_frame=jv)
    pm = pb.train(y="y", training_frame=pf, validation_frame=pv)
    np.testing.assert_allclose(pm.params["_penalty"], jm.params["_penalty"],
                               rtol=1e-5)
    _same_model(jm, pm, jf, pf, _BIN, jv, pv)
    assert pm.coef()["c"] >= 0


def test_default_device_is_the_card(monkeypatch, trained):
    """No device argument means cuda:0: without CUDA the builders and the
    converter raise and name device='cpu'."""
    from h2o_tpu_torch.models.tree.xgboost import XGBoost
    jm, _ = trained(("irlsm", "binomial"), "binomial", family="binomial")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (GLM, lambda: XGBoost(booster="gblinear"),
                 lambda: glm_from_jax_output(jm.output, jm.params)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


@pytest.mark.parametrize("key,resp,kw", [
    (("irlsm", "binomial"), "binomial", dict(family="binomial")),
    (("multinomial", "default"), "multinomial", dict(family="multinomial")),
], ids=["binomial", "multinomial"])
def test_predict_raw_array(trained, data, key, resp, kw):
    """The array form: raw columns in ``output['x']`` order (codes as
    floats, NaN NAs) expanded on the device, as ``predict_raw`` does a
    frame."""
    jm, pm = trained(key, resp, **kw)
    pf = data[resp][1]
    raw = np.stack([pf.vec(c).as_float() for c in pm.output["x"]], axis=1)
    got = pm.predict_raw_array(raw).numpy()
    np.testing.assert_allclose(got, pm.predict_raw(pf).numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jm.predict_raw_array(raw)),
                               rtol=ATOL, atol=ATOL)


OPTIONS = {
    "weights": ("binomial", dict(weights_column="w")),
    "weights_gaussian": ("gaussian", dict(weights_column="w",
                                          lambda_=0.0)),
    "no_standardize": ("gaussian", dict(standardize=False)),
    "all_factor_levels": ("binomial", dict(use_all_factor_levels=True)),
    "user_lambda_path": ("binomial", dict(lambda_search=True,
                                          lambda_=[1e-3, 0.05, 0.01])),
}


@pytest.mark.parametrize("case", sorted(OPTIONS))
def test_options(data, case):
    """Row weights (dyadic, on the training and the validation frame),
    unstandardized columns, every factor level, a user lambda path."""
    resp, kw = OPTIONS[case]
    jf, pf, jv, pv = data[resp]
    if "weights_column" in kw:
        frames = []
        for j, p_, seed in ((jf, pf, 1), (jv, pv, 2)):
            w = np.random.default_rng(seed).integers(
                1, 9, p_.nrows).astype(np.float32) / 4
            frames += [JFrame(j.names + ["w"], j.vecs + [JVec(w)]),
                       Frame(p_.names + ["w"], p_.vecs + [Vec(w)])]
        jf, pf, jv, pv = frames
    jm = JGLM(**kw).train(y="y", training_frame=jf, validation_frame=jv)
    pm = GLM(device="cpu", **kw).train(y="y", training_frame=pf,
                                        validation_frame=pv)
    assert "w" not in pm.output["coef_names"]
    _same_model(jm, pm, jf, pf, _BIN if resp == "binomial" else _REG,
                jv, pv)
    if case == "user_lambda_path":
        assert pm.output["reg_path"]["lambdas"] == [0.05, 0.01, 1e-3]
        assert pm.output["lambda_best"] == jm.output["lambda_best"]
