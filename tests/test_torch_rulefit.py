"""RuleFit in the port held against ``h2o_tpu``'s on the CPU.

The same seeded numpy columns go to ``h2o_tpu.models.rulefit`` (on the
8-device CPU mesh) and to the port's ``RuleFit(device="cpu")``: the
data of ``test_rules_selection.py::test_rulefit_finds_interpretable_rules``
(2,500 rows, rule lengths 2..3, 20 trees) with 15 % of its labels
flipped, a regression response with a categorical column and NaNs
(rules only, GBM rule trees, a weights column), and
``model_type="linear"``.  The unflipped labels are separable by two
rules: there both packages' logistic GLMs run to their 50-iteration cap
with coefficients of ~1e5-1e6 that float rounding moves by ~10 %
(while the saturated predictions agree), so that data is held only to
the reference test's own claims (the top rules name x0 or x1, 90 %
accuracy).  Every rule tree is grown with
``histogram_type="QuantilesGlobal"`` on both sides (the K1 path on the
card).

Tolerances: the rule forests' split columns and bitsets equal, every
row's terminal node equal, rule names, supports and descriptions equal
(strings); coefficients within 1e-4 (the inner L1 GLM's COD on rule
columns); predictions within 1e-4; training metrics within 1e-5
relative.  A model carried across by ``rulefit_from_jax_output`` scores
within 1e-6.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

import h2o_tpu.models.rulefit as jrf
from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec

import h2o_tpu_torch.models.rulefit as prf
from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.model import Model

pytestmark = pytest.mark.shared_dkv

ATOL = 1e-4


def _pair(X, y, dom=None, cat=None, w=None):
    names = [f"x{j}" for j in range(X.shape[1])]
    jv = [JVec(X[:, j]) for j in range(X.shape[1])]
    pv = [Vec(X[:, j]) for j in range(X.shape[1])]
    if cat is not None:
        names.append("k")
        jv.append(JVec(cat, J_CAT, domain=list("pqrs")))
        pv.append(Vec(cat, T_CAT, domain=list("pqrs")))
    if w is not None:
        names.append("w")
        jv.append(JVec(w))
        pv.append(Vec(w))
    names.append("y")
    jv.append(JVec(y, J_CAT, domain=dom) if dom else JVec(y))
    pv.append(Vec(y, T_CAT, domain=dom) if dom else Vec(y))
    return JFrame(names, jv), Frame(names, pv)


@pytest.fixture(scope="module")
def frames(cl):
    rng = np.random.default_rng(42)
    n = 2500
    X = rng.normal(size=(n, 4)).astype(np.float32)
    y = ((X[:, 0] > 0.5) & (X[:, 1] < 0)).astype(np.int32)
    out = {"separable": _pair(X, y, ["0", "1"])}
    flip = np.random.default_rng(5).uniform(size=n) < 0.15
    out["binomial"] = _pair(X, (y ^ flip).astype(np.int32), ["0", "1"])
    rng = np.random.default_rng(7)
    X = rng.normal(size=(2000, 3)).astype(np.float32)
    X[rng.uniform(size=2000) < 0.05, 2] = np.nan
    cat = rng.integers(0, 4, 2000).astype(np.int32)
    yr = (2.0 * (X[:, 0] > 0) - 1.5 * (cat == 1) + 0.5 * X[:, 1] +
          0.3 * rng.normal(size=2000)).astype(np.float32)
    w = rng.choice([0.5, 1.0, 2.0], size=2000).astype(np.float32)
    out["regression"] = _pair(X, yr, cat=cat, w=w)
    return out


CASES = {
    "binomial": ("binomial", dict(min_rule_length=2, max_rule_length=3,
                                  rule_generation_ntrees=20, seed=2)),
    "regression_gbm": ("regression", dict(
        algorithm="GBM", min_rule_length=2, max_rule_length=3,
        rule_generation_ntrees=8, model_type="rules", seed=3,
        weights_column="w", lambda_=1e-2)),
    "linear": ("binomial", dict(model_type="linear", seed=4,
                                rule_generation_ntrees=6)),
    "separable": ("separable", dict(min_rule_length=2, max_rule_length=3,
                                    rule_generation_ntrees=20, seed=2)),
}
COMPARED = sorted(set(CASES) - {"separable"})


@pytest.fixture(scope="module")
def trained(frames):
    cache = {}

    def fit(case):
        if case not in cache:
            data, kw = CASES[case]
            jf, pf = frames[data]
            jm = jrf.RuleFit(**kw).train(y="y", training_frame=jf)
            pm = prf.RuleFit(device="cpu", **kw).train(y="y",
                                                       training_frame=pf)
            cache[case] = (jm, pm, jf, pf)
        return cache[case]
    return fit


@pytest.mark.parametrize("case", COMPARED)
def test_rules_match_reference(trained, case):
    jm, pm, jf, pf = trained(case)
    assert pm.output["glm_output"]["iterations"] == \
        jm.output["glm_output"]["iterations"] < 50
    jo, po = jm.output, pm.output
    assert len(po["forests"]) == len(jo["forests"])
    for pfor, jfor in zip(po["forests"], jo["forests"]):
        assert pfor["depth"] == jfor["depth"]
        np.testing.assert_array_equal(pfor["split_col"],
                                      np.asarray(jfor["split_col"]))
        np.testing.assert_array_equal(pfor["bitset"],
                                      np.asarray(jfor["bitset"]))
        assert pfor["rule_nodes"] == jfor["rule_nodes"]
        assert pfor["rule_names"] == jfor["rule_names"]
    assert po["linear_names"] == jo["linear_names"]
    # every row's terminal nodes, through the binned training rows
    import jax.numpy as jnp
    from h2o_tpu.models.tree import shared_tree as jst
    from h2o_tpu_torch.models.tree import shared_tree as pst
    jbins = jst.bin_matrix(jf.as_matrix(jo["x"]),
                           jnp.asarray(jo["split_points"]), jo["is_cat"],
                           int(jo["nbins"]))
    pbins = pst.bin_matrix(pf.as_matrix(po["x"], "cpu"), po["split_points"],
                           po["is_cat"], int(po["nbins"]))
    for pfor, jfor in zip(po["forests"], jo["forests"]):
        want = np.asarray(jrf._terminal_nodes(
            jbins, jnp.asarray(jfor["split_col"]),
            jnp.asarray(jfor["bitset"]), int(jfor["depth"])))[:pf.nrows]
        got = prf._terminal_nodes(
            pbins, torch.as_tensor(pfor["split_col"]),
            torch.as_tensor(pfor["bitset"]), pfor["depth"]).numpy()
        np.testing.assert_array_equal(got, want)
    # the rule importance: names, supports and descriptions equal
    pr, jr = pm.rule_importance(), jm.rule_importance()
    assert [r[0] for r in pr] == [r[0] for r in jr]
    assert [r[2] for r in pr] == [r[2] for r in jr]
    assert [r[3] for r in pr] == [r[3] for r in jr]
    np.testing.assert_allclose([r[1] for r in pr], [r[1] for r in jr],
                               rtol=0, atol=ATOL)
    jc, pc = jm._inner().coef(), pm._inner().coef()
    assert list(pc) == list(jc)
    np.testing.assert_allclose(list(pc.values()), list(jc.values()),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(pm.predict_raw(pf).numpy(),
                               np.asarray(jm.predict_raw(jf))[:pf.nrows],
                               rtol=0, atol=ATOL)
    keys = ("AUC", "logloss") if jo["response_domain"] else ("mse", "r2")
    for k in keys:
        np.testing.assert_allclose(po["training_metrics"][k],
                                   jo["training_metrics"][k], rtol=1e-5,
                                   err_msg=k)


def test_interpretable_rules(frames):
    _, pf = frames["separable"]
    pm = prf.RuleFit(device="cpu", **CASES["separable"][1]).train(
        y="y", training_frame=pf)
    rules = pm.rule_importance()
    top = " ".join(r[3] for r in rules[:5])
    assert "x0" in top or "x1" in top
    raw = pm.predict_raw(pf).numpy()
    assert float((raw[:, 0] == pf.vec("y").data).mean()) > 0.9


def test_converter_and_save_load(trained):
    jm, pm, jf, pf = trained("binomial")

    def host(d):
        return {k: (np.asarray(v) if hasattr(v, "shape") else v)
                for k, v in d.items()}
    out = host(jm.output)
    out["glm_output"] = host(jm.output["glm_output"])
    out["forests"] = [host(f) for f in jm.output["forests"]]
    cm = prf.rulefit_from_jax_output(out, jm.params, device="cpu")
    np.testing.assert_allclose(cm.predict_raw(pf).numpy(),
                               np.asarray(jm.predict_raw(jf))[:pf.nrows],
                               rtol=1e-6, atol=1e-6)
    assert cm.rule_importance() == [tuple(r) for r in jm.rule_importance()]
    with tempfile.TemporaryDirectory() as d:
        m2 = Model.load(pm.save(os.path.join(d, "rf.bin")), device="cpu")
    assert isinstance(m2, prf.RuleFitModel)
    np.testing.assert_array_equal(m2.predict_raw(pf).numpy(),
                                  pm.predict_raw(pf).numpy())


def test_multiclass_and_device(frames, monkeypatch):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 2)).astype(np.float32)
    _, pf = _pair(X, rng.integers(0, 3, 300).astype(np.int32),
                  ["a", "b", "c"])
    with pytest.raises(ValueError, match="multiclass"):
        prf.RuleFit(device="cpu", rule_generation_ntrees=2).train(
            y="y", training_frame=pf)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prf.RuleFit()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prf.rulefit_from_jax_output({}, {})
