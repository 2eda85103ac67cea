"""DeepLearning in the port held against ``h2o_tpu``'s on the CPU.

The same seeded numpy columns go to ``h2o_tpu.models.deeplearning`` (on
the 8-device CPU mesh) and to the port's ``DeepLearning(device="cpu")``
for six configurations: ADADELTA on the XOR-like binomial data of
``test_algos.py::test_deeplearning_binomial``, rate/momentum with
Nesterov (``test_deeplearning_sgd_momentum_path``'s options), dropout
(``RectifierWithDropout`` with input dropout), gaussian and poisson
regression, a 3-class response, and the autoencoder on
``test_lambda_autoencoder.py``'s low-rank data.  The minibatch indices
and dropout masks are jax's bit for bit, so only float rounding drifts.

Tolerances: after one step (epochs = 1,024 / rows) every weight and
bias within 1e-6 relative (atol 1e-8); after a short training (200 or
400 steps, one or two blocks) predictions within 1e-3 absolute and the
training metrics within 1e-3 relative; a model carried across by
``deeplearning_from_jax_output`` scores within 1e-6.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models.deeplearning import DeepLearning as JDL

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.deeplearning import (DeepLearning,
                                               DeepLearningModel,
                                               deeplearning_from_jax_output)
from h2o_tpu_torch.models.model import Model
from h2o_tpu_torch.core.store import unpublish_on_exit


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv

N = 2000


def _pair(X, y=None, dom=None):
    names = [f"x{j}" for j in range(X.shape[1])]
    jv = [JVec(X[:, j]) for j in range(X.shape[1])]
    pv = [Vec(X[:, j]) for j in range(X.shape[1])]
    if y is not None:
        names.append("y")
        jv.append(JVec(y, J_CAT, domain=dom) if dom else JVec(y))
        pv.append(Vec(y, T_CAT, domain=dom) if dom else Vec(y))
    return JFrame(names, jv), Frame(names, pv)


@pytest.fixture(scope="module")
def frames(cl):
    rng = np.random.default_rng(42)
    X = rng.normal(size=(N, 4)).astype(np.float32)
    out = {"binomial": _pair(X, (X[:, 0] * X[:, 1] > 0).astype(np.int32),
                             ["0", "1"])}
    Xr = rng.normal(size=(N, 3)).astype(np.float32)
    out["gaussian"] = _pair(Xr, (np.sin(Xr[:, 0]) + Xr[:, 1] ** 2).astype(
        np.float32))
    out["poisson"] = _pair(Xr, rng.poisson(np.exp(0.5 * Xr[:, 0])).astype(
        np.float32))
    scores = np.stack([X[:, 0], X[:, 1], -X[:, 0] - X[:, 1]], axis=1)
    yi = np.argmax(scores + 0.3 * rng.normal(size=(N, 3)), axis=1)
    out["multinomial"] = _pair(X[:, :3], yi.astype(np.int32),
                               ["a", "b", "c"])
    Xa = rng.normal(size=(N, 8)).astype(np.float32)
    Xa[:, 2:] = Xa[:, :2] @ rng.normal(size=(2, 6)).astype(np.float32) + \
        0.05 * Xa[:, 2:]
    out["autoencoder"] = _pair(Xa)
    return out


CASES = {
    "adaptive": ("binomial", dict(hidden=[16, 16], seed=7)),
    "momentum": ("binomial", dict(hidden=[16], seed=1, adaptive_rate=False,
                                  rate=0.05, momentum_start=0.5,
                                  momentum_stable=0.9, momentum_ramp=5e4)),
    "dropout": ("binomial", dict(hidden=[16, 16], seed=3,
                                 activation="RectifierWithDropout",
                                 input_dropout_ratio=0.1, l1=1e-5, l2=1e-4)),
    "regression": ("gaussian", dict(hidden=[16, 16], seed=2,
                                    activation="Tanh")),
    "poisson": ("poisson", dict(hidden=[8], seed=4, distribution="poisson")),
    "multinomial": ("multinomial", dict(hidden=[16], seed=5)),
    "autoencoder": ("autoencoder", dict(hidden=[4], seed=3,
                                        autoencoder=True)),
}
_METRICS = {"binomial": ("AUC", "logloss", "mse"),
            "gaussian": ("mse", "mae", "r2"),
            "poisson": ("mse", "mean_residual_deviance"),
            "multinomial": ("logloss", "err", "mse"),
            "autoencoder": ("MSE", "RMSE")}


def _train(frames, case, epochs):
    data, kw = CASES[case]
    jf, pf = frames[data]
    kw = dict(kw, epochs=epochs)
    y = None if kw.get("autoencoder") else "y"
    jm = JDL(**kw).train(y=y, training_frame=jf)
    pm = DeepLearning(device="cpu", **kw).train(y=y, training_frame=pf)
    return jm, pm, jf, pf, data


def _weights_close(pm, jm, rtol, atol):
    assert len(pm.output["weights"]) == len(jm.output["weights"])
    for pl, jl in zip(pm.output["weights"], jm.output["weights"]):
        for k in ("W", "b"):
            np.testing.assert_allclose(pl[k], np.asarray(jl[k]), rtol=rtol,
                                       atol=atol, err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_step(frames, case):
    jm, pm, _, _, _ = _train(frames, case, 1024 / N)
    assert pm.output["steps"] == 1 and pm.output["batch"] == 1024
    _weights_close(pm, jm, 1e-6, 1e-8)


@pytest.mark.parametrize("case", sorted(CASES))
def test_short_training(frames, case):
    steps = 400 if case in ("adaptive", "autoencoder") else 200
    jm, pm, jf, pf, data = _train(frames, case, steps * 1024 / N)
    assert pm.output["steps"] == steps
    np.testing.assert_allclose(pm.predict_raw(pf).numpy(),
                               np.asarray(jm.predict_raw(jf))[:N],
                               rtol=0, atol=1e-3)
    jt, pt = jm.output["training_metrics"], pm.output["training_metrics"]
    assert pt.kind == jt.kind
    for k in _METRICS[data]:
        np.testing.assert_allclose(pt[k], jt[k], rtol=1e-3, err_msg=k)
    if case == "adaptive":
        assert pt["AUC"] > 0.9


def test_autoencoder_scoring_surface(frames):
    jm, pm, jf, pf, _ = _train(frames, "autoencoder", 40 * 1024 / N)
    assert pm.output["model_category"] == "AutoEncoder"
    a, ja = pm.anomaly(pf), jm.anomaly(jf)
    assert a.names == ja.names == ["Reconstruction.MSE"]
    np.testing.assert_allclose(a.vecs[0].data, np.asarray(
        ja.vecs[0].to_numpy())[:N], rtol=1e-3, atol=1e-5)
    pfa, jfa = pm.anomaly(pf, per_feature=True), jm.anomaly(
        jf, per_feature=True)
    assert pfa.names == jfa.names and len(pfa.names) == 8
    np.testing.assert_allclose(
        np.stack([v.data for v in pfa.vecs], 1),
        np.stack([np.asarray(v.to_numpy())[:N] for v in jfa.vecs], 1),
        rtol=1e-3, atol=1e-5)
    rec, jrec = pm.predict(pf), jm.predict(jf)
    assert rec.names == jrec.names
    np.testing.assert_allclose(pm.reconstruction_mse(pf),
                               jm.reconstruction_mse(jf), rtol=1e-3)
    # outliers off the manifold reconstruct worse
    Xo = np.random.default_rng(9).normal(size=(200, 8)).astype(
        np.float32) * 3.0
    _, po = _pair(Xo)
    assert pm.anomaly(po).vecs[0].data.mean() > \
        1.5 * a.vecs[0].data.mean()


@pytest.mark.parametrize("case", ["adaptive", "multinomial", "regression",
                                  "autoencoder"])
def test_converter_and_save_load(frames, case):
    jm, pm, jf, pf, _ = _train(frames, case, 1024 / N)
    out = {k: (np.asarray(v) if hasattr(v, "shape") else v)
           for k, v in jm.output.items()}
    cm = deeplearning_from_jax_output(out, jm.params, device="cpu")
    np.testing.assert_allclose(cm.predict_raw(pf).numpy(),
                               np.asarray(jm.predict_raw(jf))[:N],
                               rtol=1e-6, atol=1e-6)
    with tempfile.TemporaryDirectory() as d:
        m2 = Model.load(pm.save(os.path.join(d, "dl.bin")), device="cpu")
    assert isinstance(m2, DeepLearningModel)
    np.testing.assert_array_equal(m2.predict_raw(pf).numpy(),
                                  pm.predict_raw(pf).numpy())


def test_small_frame_batch_is_padded_rows(cl):
    """1,000 rows: the reference's padded row count is 1,024, so each
    step draws 1,024 rows, as the reference does."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(1000, 2)).astype(np.float32)
    jf, pf = _pair(X, (X[:, 0] > 0).astype(np.int32), ["0", "1"])
    kw = dict(hidden=[8], seed=1, epochs=1.024)
    pm = DeepLearning(device="cpu", **kw).train(y="y", training_frame=pf)
    jm = JDL(**kw).train(y="y", training_frame=jf)
    assert pm.output["batch"] == 1024 and pm.output["steps"] == 1
    _weights_close(pm, jm, 1e-6, 1e-8)


def test_maxout_and_model_parallel_on_one_device(frames):
    _, pf = frames["binomial"]
    with pytest.warns(UserWarning, match="Maxout"):
        m = DeepLearning(device="cpu", hidden=[8], epochs=0.5, seed=1,
                         activation="Maxout").train(y="y", training_frame=pf)
    r = DeepLearning(device="cpu", hidden=[8], epochs=0.5, seed=1,
                     activation="Rectifier").train(y="y", training_frame=pf)
    np.testing.assert_array_equal(m.output["weights"][0]["W"],
                                  r.output["weights"][0]["W"])
    mp = DeepLearning(device="cpu", hidden=[8], epochs=0.5, seed=1,
                      model_parallel=True).train(y="y", training_frame=pf)
    np.testing.assert_array_equal(mp.output["weights"][0]["W"],
                                  r.output["weights"][0]["W"])


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeepLearning()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deeplearning_from_jax_output({}, {})
