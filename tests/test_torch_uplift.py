"""The port's UpliftDRF held against ``h2o_tpu``'s on the CPU, tree for
tree, on ``tests/test_tree_variants.py``'s uplift data.

KL, ChiSquared and Euclidean, each with float32 stats and with int16
stats (the reference under ``H2O_TPU_STATS_DTYPE=int16``), 10 trees of
depth 4 on 800 rows; and a KL forest of depth 5 on 3,000 rows with the
frontier capped at 8 live leaves (the reference's
``H2O_TPU_MAX_LIVE_LEAVES`` and the port's ``engine.MAX_LIVE_LEAVES``),
so the best-first selection by child size runs.  The stats are 0/1
counts (or their exact int32 quantized sums), and the divergences and
gains take XLA's float32 arithmetic (``ops/xlamath.py``), so split
columns, bitsets and child pointers are equal; treatment and control
rates agree to 1e-6 (they come out equal), predictions to 1e-6, and
``auuc``, ``ate`` and ``qini`` to 1e-6 (the trees' sums in the
reference's order make them equal).  The converter carries a JAX model
across; ``Model.save``/``load`` round-trips one.
"""

import numpy as np
import pytest
import torch

from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models.tree.uplift import UpliftDRF as JUplift

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.model import Model
from h2o_tpu_torch.models.tree import engine
from h2o_tpu_torch.models.tree.convert import upliftdrf_from_jax_output
from h2o_tpu_torch.models.tree.uplift import UpliftDRF, UpliftDRFModel

pytestmark = pytest.mark.shared_dkv

TOL = 1e-6
CAP = 8


def _frames(kind: str):
    rng = np.random.default_rng(42)
    if kind == "effect":           # test_uplift_drf_detects_treatment_effect
        n = 3000
        X = rng.normal(size=(n, 3)).astype(np.float32)
        treat = rng.integers(0, 2, n)
        base = 1 / (1 + np.exp(-X[:, 1]))
        py = np.clip(base * 0.4 + treat * 0.4 * (X[:, 0] > 0), 0, 1)
    else:                          # test_uplift_metrics_variants
        n = 800
        X = rng.normal(size=(n, 2)).astype(np.float32)
        treat = rng.integers(0, 2, n)
        py = 0.3 + 0.2 * treat * (X[:, 0] > 0)
    y = (rng.uniform(size=n) < py).astype(np.int32)
    xs = [f"x{j}" for j in range(X.shape[1])]
    names = xs + ["treatment", "y"]
    t = treat.astype(np.int32)
    jf = JFrame(names, [JVec(X[:, j]) for j in range(X.shape[1])] +
                [JVec(t, J_CAT, domain=["0", "1"]),
                 JVec(y, J_CAT, domain=["0", "1"])])
    pf = Frame(names, [Vec(X[:, j]) for j in range(X.shape[1])] +
               [Vec(t, T_CAT, domain=["0", "1"]),
                Vec(y, T_CAT, domain=["0", "1"])])
    return jf, pf, xs, X


CASES = [(m, sd) for m in ("KL", "ChiSquared", "Euclidean")
         for sd in ("f32", "int16")] + [("KL", "capped")]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(c))
def pair(request, cl):
    metric, mode = request.param
    capped = mode == "capped"
    jf, pf, xs, X = _frames("effect" if capped else "variants")
    kw = dict(treatment_column="treatment", uplift_metric=metric,
              ntrees=10, max_depth=5 if capped else 4,
              seed=4 if capped else 5)
    sd = "f32" if capped else mode
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("H2O_TPU_STATS_DTYPE", sd)
        if capped:
            mp.setenv("H2O_TPU_MAX_LIVE_LEAVES", str(CAP))
            mp.setattr(engine, "MAX_LIVE_LEAVES", CAP)
        jm = JUplift(**kw).train(x=xs, y="y", training_frame=jf)
        pm = UpliftDRF(device="cpu", stats_dtype=sd, **kw).train(
            x=xs, y="y", training_frame=pf)
    return capped, jf, pf, X, jm, pm


def test_trees_equal(pair):
    capped, _, _, _, jm, pm = pair
    po, jo = pm.output, jm.output
    for k in ("split_col", "bitset", "child"):
        np.testing.assert_array_equal(po[k], np.asarray(jo[k]), err_msg=k)
    for k in ("val_t", "val_c"):
        np.testing.assert_allclose(po[k], np.asarray(jo[k]), rtol=0,
                                   atol=TOL, err_msg=k)
    depth = 5 if capped else 4
    assert po["split_col"].shape == (10, engine.pool_size(
        depth, CAP if capped else engine.MAX_LIVE_LEAVES))
    assert (po["split_col"] >= 0).sum() > 20


def test_predictions_and_metrics(pair):
    capped, jf, pf, X, jm, pm = pair
    n = pf.nrows
    got = pm.predict_raw(pf).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.predict_raw(jf))[:n],
                               rtol=0, atol=TOL)
    pt, jt = pm.output["training_metrics"], jm.output["training_metrics"]
    for k in ("auuc", "ate", "qini"):
        assert abs(pt[k] - jt[k]) <= TOL, (k, pt[k], jt[k])
    pred = pm.predict(pf)
    assert pred.names == ["uplift_predict", "p_y1_ct1", "p_y1_ct0"]
    if capped:
        u = pred.vec("uplift_predict").data
        assert u[X[:, 0] > 0.5].mean() - u[X[:, 0] < -0.5].mean() > 0.15


def test_converter_and_save_load(pair, tmp_path):
    _, jf, pf, _, jm, pm = pair
    out = {k: (np.asarray(v) if hasattr(v, "shape") else v)
           for k, v in jm.output.items()}
    cm = upliftdrf_from_jax_output(out, jm.params, device="cpu")
    np.testing.assert_allclose(cm.predict_raw(pf).numpy(),
                               np.asarray(jm.predict_raw(jf))[:pf.nrows],
                               rtol=0, atol=TOL)
    loaded = Model.load(pm.save(str(tmp_path / "u.bin")), device="cpu")
    assert isinstance(loaded, UpliftDRFModel)
    assert torch.equal(loaded.predict_raw(pf), pm.predict_raw(pf))


def test_builder_checks():
    _, pf, xs, _ = _frames("variants")
    with pytest.raises(ValueError, match="binary categorical"):
        UpliftDRF(device="cpu", treatment_column="x1").train(
            x=xs, y="y", training_frame=pf)
    with pytest.raises(ValueError, match="uplift_metric"):
        UpliftDRF(device="cpu", uplift_metric="gini").train(
            x=xs, y="y", training_frame=pf)
    with pytest.raises(ValueError, match="auuc_type"):
        UpliftDRF(device="cpu", auuc_type="gain")
    with pytest.raises(ValueError, match="cross-validation"):
        UpliftDRF(device="cpu", nfolds=3).train(x=xs, y="y",
                                                training_frame=pf)
