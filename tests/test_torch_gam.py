"""GAM in the port held against ``h2o_tpu``'s on the CPU.

The same seeded numpy columns go to ``h2o_tpu.models.gam`` (on the
8-device CPU mesh) and to the port's ``GAM(device="cpu")``: the wiggly
curve of ``test_gam_bases.py`` (1,600 rows) under each basis (cr,
thin-plate, monotone I-splines, M-splines), and a binomial response
over three smoothers (cr, I-spline, M-spline at 10 knots) beside a
plain column that is also a cr smoother, with a validation frame.

Tolerances: every basis column and penalty matrix within 1e-6 (both
come out bitwise: the reference evaluates them op by op, unfused, and
the port repeats its float32 operations); knots and means equal.
Where the penalized Gram determines the coefficients in float32 (the
I-splines' COD at lambda 0; M-splines and thin-plate with a ridge; the
binomial fit standardized at lambda 0.1, 4 IRLSM iterations in both),
coefficients (``coef()``) and predictions within 1e-4, metrics within
1e-5 relative, iteration counts equal.  At lambda 0 the cr, thin-plate
and M-spline Grams of the wiggly data have condition numbers of ~4.5e6
to ~8e7: there the reference's and the port's float32 Cholesky solves
(XLA's and LAPACK's) each land ~0.003 (M-spline), ~0.5 (cr) and ~12
(thin-plate) from the float64 solution of the same normal equations
(``tools/torch_port_probes.py gam``), so they agree with each other no
better than that; those cases hold each package against the float64
solution instead: the port's error at most twice the
reference's (plus 1e-4), the training MSE within 1 % relative.  The
I-spline coefficients are non-negative in both.  A model carried
across by ``gam_from_jax_output`` scores within 1e-6.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

import h2o_tpu.models.gam as jgam
from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec

import h2o_tpu_torch.models.gam as pgam
from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.model import Model

pytestmark = pytest.mark.shared_dkv

ATOL = 1e-4


def _wiggly(seed=0, R=1600):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3, 3, size=R)).astype(np.float32)
    y = np.sin(2.0 * x) + 0.3 * x + rng.normal(scale=0.25, size=R)
    return x, y.astype(np.float32)


def _pair(cols, y=None, dom=None):
    names = list(cols) + (["y"] if y is not None else [])
    jv = [JVec(v) for v in cols.values()]
    pv = [Vec(v) for v in cols.values()]
    if y is not None:
        jv.append(JVec(y, J_CAT, domain=dom) if dom else JVec(y))
        pv.append(Vec(y, T_CAT, domain=dom) if dom else Vec(y))
    return JFrame(names, jv), Frame(names, pv)


@pytest.fixture(scope="module")
def frames(cl):
    x, y = _wiggly()
    out = {"wiggly": _pair({"x": x}, y)}
    rng = np.random.default_rng(3)
    n = 3000
    a, b, c, d = (rng.normal(size=n).astype(np.float32) for _ in range(4))
    a[rng.uniform(size=n) < 0.03] = np.nan
    eta = np.sin(1.5 * np.nan_to_num(a)) + 0.8 * np.tanh(b) + 0.3 * c ** 2 \
        - 0.5 * d
    yb = (rng.uniform(size=n) < 1 / (1 + np.exp(-eta))).astype(np.int32)
    cols = {"a": a, "b": b, "c": c, "d": d}
    out["binomial"] = _pair({k: v[:2400] for k, v in cols.items()},
                            yb[:2400], ["n", "y"])
    out["binomial_valid"] = _pair({k: v[2400:] for k, v in cols.items()},
                                  yb[2400:], ["n", "y"])
    return out


@pytest.mark.parametrize("bs", [0, 1, 2, 3])
def test_bases_and_penalties(bs):
    x, _ = _wiggly()
    knots = np.unique(np.quantile(x, np.linspace(0, 1, 10)))
    import jax.numpy as jnp
    want = [np.asarray(c) for c in jgam._BASES[bs](jnp.asarray(x), knots)]
    got = [c.numpy() for c in pgam._BASES[bs](torch.from_numpy(x), knots)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        pgam._curvature_penalty(pgam._BASES[bs], knots),
        jgam._curvature_penalty(jgam._BASES[bs], knots), rtol=0, atol=1e-6)


def _same(jm, pm, jf, pf, keys, jv=None, pv=None):
    jo, po = jm.output, pm.output
    assert po["basis_names"] == jo["basis_names"]
    for c in jo["gam_columns"]:
        np.testing.assert_array_equal(po["knots"][c], jo["knots"][c])
        assert po["gam_col_means"][c] == jo["gam_col_means"][c]
    jc, pc = jm.coef(), pm.coef()
    assert list(pc) == list(jc)
    np.testing.assert_allclose(list(pc.values()), list(jc.values()),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(pm.predict_raw(pf).numpy(),
                               np.asarray(jm.predict_raw(jf))[:pf.nrows],
                               rtol=0, atol=ATOL)
    for which, frames_ in (("training_metrics", None),
                           ("validation_metrics", jv)):
        if which == "validation_metrics" and frames_ is None:
            continue
        for k in keys:
            np.testing.assert_allclose(po[which][k], jo[which][k],
                                       rtol=1e-5, err_msg=f"{which} {k}")


def _fit_pair(frames, **kw):
    jf, pf = frames["wiggly"]
    kw = dict(gam_columns=["x"], num_knots=10, seed=1, **kw)
    jm = jgam.GAM(**kw).train(y="y", training_frame=jf)
    pm = pgam.GAM(device="cpu", **kw).train(y="y", training_frame=pf)
    return jm, pm, jf, pf


@pytest.mark.parametrize("bs,lam", [(2, 0.0), (3, 1e-3), (1, 1e-2)])
def test_wiggly_fit_well_posed(frames, bs, lam):
    jm, pm, jf, pf = _fit_pair(frames, bs=[bs], lambda_=lam)
    assert pm.output["glm_output"]["iterations"] == \
        jm.output["glm_output"]["iterations"]
    _same(jm, pm, jf, pf, ("mse", "r2"))
    if bs == 2:
        iso = [v for k, v in pm.coef().items() if "_gam_" in k]
        assert min(iso) >= 0


@pytest.mark.parametrize("bs,scale", [(0, 1.0), (1, 1.0), (3, 1.0),
                                      (0, 100.0)])
def test_wiggly_fit_ill_conditioned(frames, bs, scale):
    """lambda 0: both packages against the float64 solution of the
    penalized normal equations the port assembles."""
    jm, pm, jf, pf = _fit_pair(frames, bs=[bs], lambda_=0.0, scale=[scale])
    assert pm.output["basis_names"] == jm.output["basis_names"]
    ef = pm.expand(pf)
    names = pm.output["glm_output"]["coef_names"]
    X1 = np.stack([ef.vec(n).data.astype(np.float64) for n in names] +
                  [np.ones(pf.nrows)], axis=1)
    G = X1.T @ X1 + pm.output["glm_params"]["_penalty"] + \
        1e-8 * np.eye(X1.shape[1])
    exact = np.linalg.solve(G, X1.T @ pf.vec("y").data.astype(np.float64))
    err_p = np.abs(pm.output["glm_output"]["beta"] - exact).max()
    err_j = np.abs(np.asarray(jm.output["glm_output"]["beta"]) - exact).max()
    assert err_p <= 2 * err_j + 1e-4, (err_p, err_j)
    np.testing.assert_allclose(pm.output["training_metrics"]["mse"],
                               jm.output["training_metrics"]["mse"],
                               rtol=1e-2)


def test_binomial_three_smoothers(frames):
    jf, pf = frames["binomial"]
    jv, pv = frames["binomial_valid"]
    kw = dict(gam_columns=["a", "b", "c"], bs=[0, 2, 3], num_knots=10,
              seed=1, family="binomial", standardize=True, lambda_=0.1)
    jm = jgam.GAM(**kw).train(x=["a", "b", "c", "d"], y="y",
                              training_frame=jf, validation_frame=jv)
    pm = pgam.GAM(device="cpu", **kw).train(
        x=["a", "b", "c", "d"], y="y", training_frame=pf,
        validation_frame=pv)
    # b is a monotone smoother: not a plain predictor; a is cr and plain
    assert pm.output["x"] == list(jm.output["x"]) == ["a", "c", "d"]
    assert pm.output["glm_output"]["iterations"] == \
        jm.output["glm_output"]["iterations"]
    _same(jm, pm, jf, pf, ("AUC", "logloss"), jv, pv)
    assert all(v >= 0 for k, v in pm.coef().items()
               if k.startswith("b_gam_"))


def test_converter_and_save_load(frames):
    jf, pf = frames["binomial"]
    kw = dict(gam_columns=["a", "c"], bs=[0, 3], num_knots=8, seed=1,
              family="binomial")
    jm = jgam.GAM(**kw).train(x=["a", "b", "c", "d"], y="y",
                              training_frame=jf)

    def host(d):
        return {k: (np.asarray(v) if hasattr(v, "shape") else v)
                for k, v in d.items()}
    out = host(jm.output)
    out["glm_output"] = host(jm.output["glm_output"])
    cm = pgam.gam_from_jax_output(out, jm.params, device="cpu")
    np.testing.assert_allclose(cm.predict_raw(pf).numpy(),
                               np.asarray(jm.predict_raw(jf))[:pf.nrows],
                               rtol=1e-6, atol=1e-6)
    pm = pgam.GAM(device="cpu", **kw).train(x=["a", "b", "c", "d"], y="y",
                                            training_frame=pf)
    with tempfile.TemporaryDirectory() as d:
        m2 = Model.load(pm.save(os.path.join(d, "gam.bin")), device="cpu")
    assert isinstance(m2, pgam.GAMModel)
    np.testing.assert_array_equal(m2.predict_raw(pf).numpy(),
                                  pm.predict_raw(pf).numpy())
    assert m2.coef() == pm.coef()


def test_reference_errors(frames):
    _, pf = frames["wiggly"]
    with pytest.raises(ValueError, match="bs=7"):
        pgam.GAM(device="cpu", gam_columns=["x"], bs=[7]).train(
            y="y", training_frame=pf)
    with pytest.raises(ValueError, match="gam_columns"):
        pgam.GAM(device="cpu").train(y="y", training_frame=pf)
    const = Frame(["x", "y"], [Vec(np.ones(50, np.float32)),
                               Vec(np.arange(50, dtype=np.float32))])
    with pytest.raises(ValueError, match="distinct knot"):
        pgam.GAM(device="cpu", gam_columns=["x"]).train(
            y="y", training_frame=const)
    with pytest.raises(ValueError, match="length mismatch"):
        pgam.GAM(device="cpu", gam_columns=["x"], bs=[0, 1]).train(
            y="y", training_frame=pf)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pgam.GAM()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pgam.gam_from_jax_output({}, {})
