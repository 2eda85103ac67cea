"""KMeans in the port held against ``h2o_tpu``'s on the CPU.

The same seeded numpy columns go to ``h2o_tpu.models.kmeans.KMeans`` (on
the 8-device CPU mesh) and to the port's ``KMeans(device="cpu")``: the
three separated clusters of ``test_algos.py::test_kmeans_recovers_clusters``
(900 rows) and the two scaled clusters of ``test_kmeans_standardized``,
each with ``Furthest``, ``PlusPlus`` and ``Random`` initialisation, and a
frame with NaNs and a categorical column (one-hot over every level) at
k = 4, standardized and not.

Tolerances: the initial centers (captured at the first Lloyd step) are
the same rows, within 1e-6 (the standardization's rollups differ in the
last bits); iteration counts and assignments equal; centers within 1e-5
(absolute; the de-standardized ones within 1e-5 of each column's
largest |center|, as de-standardizing scales by sigma); within-SS,
totss and sizes within 1e-5 relative.  The D^2-weighted draw (``choice`` with
``p``) is bitwise the reference's (``test_torch_prng.py``), so the same
row comes out unless a draw lands within rounding of a boundary.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

import h2o_tpu.models.kmeans as jkm
from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec

import h2o_tpu_torch.models.kmeans as pkm
from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.model import Model

pytestmark = pytest.mark.shared_dkv


def _pair(X, cat=None):
    names = [f"x{j}" for j in range(X.shape[1])]
    jv = [JVec(X[:, j]) for j in range(X.shape[1])]
    pv = [Vec(X[:, j]) for j in range(X.shape[1])]
    if cat is not None:
        names.append("k")
        jv.append(JVec(cat, J_CAT, domain=list("pqrs")))
        pv.append(Vec(cat, T_CAT, domain=list("pqrs")))
    return JFrame(names, jv), Frame(names, pv)


def _data(case):
    rng = np.random.default_rng(42)
    if case == "three":
        centers = np.array([[0, 0], [10, 10], [-10, 10]], np.float32)
        X = np.concatenate([c + rng.normal(size=(300, 2)).astype(np.float32)
                            for c in centers])
        return _pair(X)
    if case == "scaled":
        X = np.concatenate([
            rng.normal(size=(200, 2), scale=(1, 100)).astype(np.float32),
            np.array([8, 800], np.float32) +
            rng.normal(size=(200, 2), scale=(1, 100)).astype(np.float32)])
        return _pair(X)
    X = rng.normal(size=(1000, 3)).astype(np.float32)
    X[:500] += 3.0
    X[rng.uniform(size=1000) < 0.05, 1] = np.nan
    cat = rng.integers(0, 4, 1000).astype(np.int32)
    cat[rng.uniform(size=1000) < 0.03] = -1
    return _pair(X, cat)


CASES = {"three": dict(k=3, max_iterations=20, standardize=False, seed=5),
         "scaled": dict(k=2, max_iterations=20, standardize=True, seed=3),
         "mixed": dict(k=4, max_iterations=10, standardize=True, seed=11),
         "mixed_raw": dict(k=4, max_iterations=10, standardize=False,
                           seed=12)}


def _capture_init(monkeypatch, module, jax_side):
    """Record the centers handed to the first Lloyd step."""
    seen = []
    orig = module._lloyd_step

    def wrap(*a, **kw):
        if not seen:
            seen.append(np.asarray(a[2] if jax_side else a[1]))
        return orig(*a, **kw)
    monkeypatch.setattr(module, "_lloyd_step", wrap)
    return seen


@pytest.fixture(scope="module")
def frames(cl):
    return {c: _data("mixed" if c.startswith("mixed") else c)
            for c in CASES}


@pytest.mark.parametrize("init", ["Furthest", "PlusPlus", "Random"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kmeans_matches_reference(frames, monkeypatch, case, init):
    jf, pf = frames[case]
    kw = dict(CASES[case], init=init)
    j0 = _capture_init(monkeypatch, jkm, True)
    p0 = _capture_init(monkeypatch, pkm, False)
    jm = jkm.KMeans(**kw).train(training_frame=jf)
    pm = pkm.KMeans(device="cpu", **kw).train(training_frame=pf)
    np.testing.assert_allclose(p0[0], j0[0], rtol=0, atol=1e-6)
    jo, po = jm.output, pm.output
    assert po["iterations"] == jo["iterations"]
    assert po["coef_names"] == list(jo["coef_names"])
    np.testing.assert_allclose(po["centers_std"], np.asarray(
        jo["centers_std"]), rtol=0, atol=1e-5)
    jc = np.asarray(jo["centers"])
    scale = np.abs(jc).max(axis=0)
    np.testing.assert_allclose(po["centers"] / scale, jc / scale, rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(
        pm.predict(pf).vec("predict").data,
        np.asarray(jm.predict(jf).vec("predict").to_numpy())[:pf.nrows])
    jt, pt = jo["training_metrics"], po["training_metrics"]
    assert pt.kind == "clustering"
    for key in ("tot_withinss", "totss", "betweenss", "withinss", "size"):
        np.testing.assert_allclose(pt[key], jt[key], rtol=1e-5, err_msg=key)
    # a fresh pass over another frame (the reference's uncached branch)
    jv, pv = _pair(np.asarray(pf.as_matrix(["x0", "x1"], "cpu"))[::3]) \
        if case in ("three", "scaled") else (None, None)
    if jv is not None:
        jmm, pmm = jm.model_metrics(jv), pm.model_metrics(pv)
        for key in ("tot_withinss", "totss", "withinss", "size"):
            np.testing.assert_allclose(pmm[key], jmm[key], rtol=1e-5,
                                       err_msg=key)


def test_kmeans_recovers_clusters_and_round_trips(frames):
    _, pf = frames["three"]
    m = pkm.KMeans(device="cpu", **CASES["three"]).train(training_frame=pf)
    got = np.sort(m.output["centers"], axis=0)
    want = np.sort(np.array([[0, 0], [10, 10], [-10, 10]], np.float32),
                   axis=0)
    np.testing.assert_allclose(got, want, atol=0.5)
    tm = m.output["training_metrics"]
    assert tm["betweenss"] / tm["totss"] > 0.95
    with tempfile.TemporaryDirectory() as d:
        m2 = Model.load(m.save(os.path.join(d, "km.bin")), device="cpu")
    assert isinstance(m2, pkm.KMeansModel)
    np.testing.assert_array_equal(m2.predict_raw(pf).numpy(),
                                  m.predict_raw(pf).numpy())


@pytest.mark.parametrize("case", ["three", "mixed"])
def test_converter(frames, case):
    jf, pf = frames[case]
    jm = jkm.KMeans(**CASES[case]).train(training_frame=jf)
    out = {k: (np.asarray(v) if hasattr(v, "shape") else v)
           for k, v in jm.output.items()}
    cm = pkm.kmeans_from_jax_output(out, jm.params, device="cpu")
    np.testing.assert_array_equal(
        cm.predict_raw(pf).numpy(),
        np.asarray(jm.predict_raw(jf))[:pf.nrows])
    assert cm.output["training_metrics"]["size"] == \
        jm.output["training_metrics"]["size"]


def test_engine_fixed_and_device(monkeypatch):
    with pytest.raises(ValueError, match="estimate_k"):
        pkm.KMeans(device="cpu", estimate_k=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pkm.KMeans()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pkm.kmeans_from_jax_output({}, {})
