"""CoxPH in the port held against ``h2o_tpu``'s on the CPU.

The frames of ``test_survival_misc.py`` (``_cox_frame``: two normal
predictors, exponential event and censoring times) go to
``h2o_tpu.models.coxph.CoxPH`` (on the 8-device CPU mesh) and to the
port's ``CoxPH(device="cpu")``: Efron at 600 rows, Breslow at 400, both
with times rounded up to tenths (tied events), the left-truncated
``start_column`` case, and a weighted frame with a categorical
predictor.

What the float32 likelihood determines is held at the stated
tolerances: the first two Newton iterates (the betas the likelihood is
next evaluated at) within 1e-5, the log-likelihood and the null
log-likelihood within 1e-6 relative, the event count equal, Harrell's C
equal as a function (the port's ``_concordance`` and the reference's on
the same times, events and scores, subsampled or not), the linear
predictor of one set of coefficients (the converter) within 1e-5.
What it does not determine: near the optimum a Newton
step changes the float32 log-likelihood (~2,000 here, a unit in the
last place of 1.2e-4) by less than a unit in its last place, so whether
the last step is kept (``new > old + 1e-9``) and when the loop stops (a
change below 1e-9 relative: equal float32 values) follow the two
packages' rounding, which differs by a unit or two (a different order
of float32 sums, FMA contraction and log/exp).  The region the
likelihood cannot resolve spans sqrt(8 ulp / lambda_min(H)) (4 units
of noise on either side), and 1 / lambda_min(H) is at most the trace
of the covariance, the sum of the squared standard errors: iterations
are held within 1, each coefficient within sqrt(8 ulp(loglik) sum se^2)
(2.5e-3 to 6.7e-3 here), the standard errors within 1e-3 relative, and the
concordance, whose pairs flip where two scores lie within the
coefficients' gap of each other, within 1e-4 (in these runs:
coefficients 1.2e-3, concordance 2.5e-5 and one iteration apart at
most; ``tools/torch_port_probes.py coxph``).
"""

import os
import tempfile

import numpy as np
import pytest

import h2o_tpu.models.coxph as jcox
from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec

import h2o_tpu_torch.models.coxph as pcox
from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.coxph import CoxPH, CoxPHModel, \
    coxph_from_jax_output
from h2o_tpu_torch.models.model import Model

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


def _cox(n, beta=(0.8, -0.5), tenths=False, extra=None):
    """test_survival_misc._cox_frame (rng seed 42)."""
    rng = np.random.default_rng(42)
    X = rng.normal(size=(n, len(beta))).astype(np.float32)
    lam = np.exp(X @ np.asarray(beta))
    t_event = rng.exponential(1.0 / lam)
    t_cens = rng.exponential(2.0, size=n)
    time = np.minimum(t_event, t_cens).astype(np.float32)
    if tenths:
        time = np.ceil(time * 10).astype(np.float32)
    cols = {f"x{j}": (X[:, j], None) for j in range(len(beta))}
    if extra:
        cols.update(extra(rng, n))
    cols["time"] = (time, None)
    cols["event"] = ((t_event <= t_cens).astype(np.int32), ["0", "1"])
    return _pair(cols)


def _truncated():            # test_coxph_start_column_left_truncation
    rng = np.random.default_rng(42)
    n = 500
    X = rng.normal(size=(n, 1)).astype(np.float32)
    lam = np.exp(0.7 * X[:, 0])
    stop = rng.exponential(1.0 / lam).astype(np.float32) + 0.01
    start = (stop * rng.uniform(0, 0.5, n)).astype(np.float32)
    return _pair({"x0": (X[:, 0], None), "start": (start, None),
                  "stop": (stop, None),
                  "event": (np.ones(n, np.int32), ["0", "1"])})


def _weighted_extra(rng, n):
    return {"g": (rng.integers(0, 3, n), ["a", "b", "c"]),
            "w": (rng.integers(1, 4, n).astype(np.float32), None)}


CASES = {
    "efron": (lambda: _cox(600), dict(stop_column="time", ties="efron")),
    "breslow": (lambda: _cox(400), dict(stop_column="time",
                                        ties="breslow")),
    "efron_ties": (lambda: _cox(600, tenths=True),
                   dict(stop_column="time", ties="efron")),
    "breslow_ties": (lambda: _cox(600, tenths=True),
                     dict(stop_column="time", ties="breslow")),
    "start_column": (_truncated, dict(start_column="start",
                                      stop_column="stop")),
    "weighted_categorical": (
        lambda: _cox(500, tenths=True, extra=_weighted_extra),
        dict(stop_column="time", weights_column="w")),
}


def _record(mp, module, jax_side):
    """The betas each package evaluates the likelihood at, in order."""
    seen = []
    if jax_side:
        orig = module._newton_state

        def wrap(b, *a, **k):
            seen.append(np.asarray(b).copy())
            return orig(b, *a, **k)
        mp.setattr(module, "_newton_state", wrap)
        return seen
    for name in ("state", "nll"):
        orig_m = getattr(module.RiskSets, name)

        def wrap_m(self, b, _orig=orig_m):
            seen.append(np.asarray(b).copy())
            return _orig(self, b)
        mp.setattr(module.RiskSets, name, wrap_m)
    return seen


def _distinct(betas):
    out = []
    for b in betas:
        if not out or not np.array_equal(out[-1], b):
            out.append(b)
    return out


@pytest.fixture(scope="module")
def fits(cl):
    out = {}
    for case, (make, kw) in CASES.items():
        jf, pf = make()
        x = [c for c in pf.names if c not in ("time", "start", "stop",
                                              "event", "w")]
        mp = pytest.MonkeyPatch()
        jb, pb = _record(mp, jcox, True), _record(mp, pcox, False)
        try:
            jm = jcox.CoxPH(**kw).train(x=x, y="event", training_frame=jf)
            pm = CoxPH(device="cpu", **kw).train(x=x, y="event",
                                                 training_frame=pf)
        finally:
            mp.undo()
        out[case] = (jf, pf, jm, pm, _distinct(jb), _distinct(pb))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_coxph_matches_reference(fits, case):
    _, _, jm, pm, jb, pb = fits[case]
    jo, po = jm.output, pm.output
    assert po["coef_names"] == list(jo["coef_names"])
    for a, b in zip(pb[:3], jb[:3]):          # 0, then two Newton steps
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    np.testing.assert_allclose(po["loglik"], jo["loglik"], rtol=1e-6)
    np.testing.assert_allclose(po["null_loglik"], jo["null_loglik"],
                               rtol=1e-6)
    assert po["n_events"] == jo["n_events"]
    assert abs(po["concordance"] - jo["concordance"]) <= 1e-4
    assert abs(po["iterations"] - jo["iterations"]) <= 1
    unresolved = np.sqrt(8 * np.spacing(np.float32(abs(jo["loglik"]))) *
                         np.sum(np.asarray(jo["se_coef"]) ** 2))
    np.testing.assert_allclose(po["coef"], np.asarray(jo["coef"]), rtol=0,
                               atol=unresolved)
    np.testing.assert_allclose(po["se_coef"], np.asarray(jo["se_coef"]),
                               rtol=1e-3)
    np.testing.assert_allclose(po["x_mean"], np.asarray(jo["x_mean"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(po["exp_coef"], np.exp(po["coef"]),
                               rtol=1e-6)
    tm = po["training_metrics"]
    assert tm.kind == "coxph" and tm["iterations"] == po["iterations"]


@pytest.mark.parametrize("n", [3000, 6000])
def test_concordance_function_equal(n):
    """Harrell's C on the same inputs, with tied times and tied scores,
    below and above the 4,000-row subsample."""
    rng = np.random.default_rng(n)
    t = np.ceil(rng.exponential(5.0, n)).astype(np.float32)
    e = rng.uniform(size=n) < 0.7
    lp = np.round(rng.normal(size=n), 2).astype(np.float32)
    assert pcox._concordance(t, e, lp) == jcox._concordance(t, e, lp)


def test_reference_claims(fits):
    """test_survival_misc's claims, on the port's fits."""
    po = fits["efron"][3].output
    assert abs(po["coef"][0] - 0.8) < 0.2 and abs(po["coef"][1] + 0.5) < 0.2
    assert po["loglik"] > po["null_loglik"] and po["concordance"] > 0.6
    np.testing.assert_allclose(fits["efron"][3].output["coef"],
                               fits["breslow_ties"][3].output["coef"],
                               atol=0.1)
    assert 0.3 < float(fits["start_column"][3].output["coef"][0]) < 1.2


@pytest.mark.parametrize("case", ["efron_ties", "weighted_categorical"])
def test_converter_scores_as_reference(fits, case):
    jf, pf, jm, _, _, _ = fits[case]
    cm = coxph_from_jax_output(jm.output, jm.params, device="cpu")
    assert isinstance(cm, CoxPHModel)
    np.testing.assert_allclose(cm.predict_raw(pf).numpy(),
                               np.asarray(jm.predict_raw(jf))[:pf.nrows],
                               rtol=0, atol=1e-5)
    assert cm.output["training_metrics"]["loglik"] == jm.output["loglik"]


def test_save_load(fits):
    _, pf, _, pm, _, _ = fits["weighted_categorical"]
    with tempfile.TemporaryDirectory() as d:
        m2 = Model.load(pm.save(os.path.join(d, "cox.bin")), device="cpu")
    assert isinstance(m2, CoxPHModel)
    np.testing.assert_array_equal(m2.predict_raw(pf).numpy(),
                                  pm.predict_raw(pf).numpy())


def test_refusals(fits):
    _, pf, _, _, _, _ = fits["efron"]
    with pytest.raises(ValueError, match="stop_column"):
        CoxPH(device="cpu").train(x=["x0"], y="event", training_frame=pf)
    with pytest.raises(ValueError, match="ties"):
        CoxPH(device="cpu", ties="exact")
    with pytest.raises(ValueError, match="cross-validation"):
        CoxPH(device="cpu", stop_column="time", nfolds=2).train(
            x=["x0"], y="event", training_frame=pf)
