"""The port's IsolationForest and ExtendedIsolationForest held against
``h2o_tpu``'s on the CPU, on ``tests/test_anomaly_nb.py``'s data
(planted outliers shifted by +8 in every column of 4, and by +7 in
every column of 3), with a few NaNs added.

IsolationForest: the row samples (jax's shuffle), the column draws and
the thresholds (XLA's fused ``lo + u * (hi - lo)``) are reproduced
exactly, so split columns and thresholds are equal, and so are the path
lengths, the min/max path range, predictions and training metrics.

ExtendedIsolationForest, extension levels 0 and 2: normals
(``prng.normal``, jax's bits), points, leaf values (XLA's ``log`` in
``c(n)``), split flags and counts are equal; mean path lengths are equal
and anomaly scores agree to atol 1e-7 (``2^x`` is torch's, not XLA's).

Both rank the planted outliers at the top as the reference's tests
require; the converters carry JAX models across (same predictions) and
``Model.save``/``load`` round-trips both.
"""

import numpy as np
import pytest
import torch

from h2o_tpu.core.frame import Frame as JFrame, Vec as JVec
from h2o_tpu.models.tree.isofor import (ExtendedIsolationForest as JEIF,
                                        IsolationForest as JIF)

from h2o_tpu_torch.core.frame import Frame, Vec
from h2o_tpu_torch.models.model import Model
from h2o_tpu_torch.models.tree.convert import (
    extendedisolationforest_from_jax_output, isolationforest_from_jax_output)
from h2o_tpu_torch.models.tree.isofor import (ExtendedIsolationForest,
                                              IsolationForest)
from h2o_tpu_torch.core.store import unpublish_on_exit


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv


def _frames(n, cols, shift, planted, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, cols)).astype(np.float32)
    X[:planted] += shift
    X[planted + rng.integers(0, n - planted, 10), 1] = np.nan
    names = [f"x{j}" for j in range(cols)]
    return (JFrame(names, [JVec(X[:, j]) for j in range(cols)]),
            Frame(names, [Vec(X[:, j]) for j in range(cols)]))


def _host(out):
    return {k: (np.asarray(v) if hasattr(v, "shape") else v)
            for k, v in out.items()}


@pytest.fixture(scope="module")
def iforest(cl):
    jf, pf = _frames(1000, 4, 8.0, 20, 42)
    jm = JIF(ntrees=60, seed=7).train(training_frame=jf)
    pm = IsolationForest(device="cpu", ntrees=60, seed=7).train(
        training_frame=pf)
    return jf, pf, jm, pm


def test_if_trees_equal(iforest):
    _, _, jm, pm = iforest
    for k in ("split_col", "thresh"):
        np.testing.assert_array_equal(pm.output[k], np.asarray(jm.output[k]),
                                      err_msg=k)
    for k in ("min_path_length", "max_path_length", "sample_size",
              "max_depth"):
        assert pm.output[k] == jm.output[k], k
    assert (pm.output["split_col"] >= 0).sum() > 100


def test_if_scores_and_metrics_equal(iforest):
    jf, pf, jm, pm = iforest
    got = pm.predict_raw(pf).numpy()
    np.testing.assert_array_equal(got, np.asarray(jm.predict_raw(jf))[:1000])
    assert pm.output["training_metrics"].data == \
        jm.output["training_metrics"].data
    assert pm.model_metrics(pf).data == jm.model_metrics(jf).data
    pred = pm.predict(pf)
    assert pred.names == ["predict", "mean_length"]
    top = np.argsort(-pred.vec("predict").data)[:40]
    assert len(set(top) & set(range(20))) >= 15


def test_if_converter_and_save_load(iforest, tmp_path):
    jf, pf, jm, pm = iforest
    cm = isolationforest_from_jax_output(_host(jm.output), jm.params,
                                         device="cpu")
    np.testing.assert_array_equal(cm.predict_raw(pf).numpy(),
                                  np.asarray(jm.predict_raw(jf))[:1000])
    loaded = Model.load(pm.save(str(tmp_path / "if.bin")), device="cpu")
    assert type(loaded).__name__ == "IsolationForestModel"
    assert torch.equal(loaded.predict_raw(pf), pm.predict_raw(pf))


@pytest.fixture(scope="module", params=[0, 2])
def eif(request, cl):
    jf, pf = _frames(800, 3, 7.0, 15, 43)
    kw = dict(ntrees=80, extension_level=request.param, seed=3)
    jm = JEIF(**kw).train(training_frame=jf)
    pm = ExtendedIsolationForest(device="cpu", **kw).train(training_frame=pf)
    return jf, pf, jm, pm


def test_eif_trees_equal(eif):
    _, _, jm, pm = eif
    for k in ("normals", "points", "value", "is_split", "counts"):
        np.testing.assert_array_equal(pm.output[k], np.asarray(jm.output[k]),
                                      err_msg=k)
    nz = (pm.output["normals"] != 0).sum(axis=2)[pm.output["is_split"]]
    assert (nz == pm.params["extension_level"] + 1).all()


def test_eif_scores_within_tolerance(eif):
    jf, pf, jm, pm = eif
    got = pm.predict_raw(pf).numpy()
    want = np.asarray(jm.predict_raw(jf))[:800]
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=0, atol=1e-7)
    score = pm.predict(pf).vec("anomaly_score").data
    assert (score > 0).all() and (score < 1).all()
    top = np.argsort(-score)[:30]
    assert len(set(top) & set(range(15))) >= 11
    for k in ("mean_score", "mean_length"):
        assert abs(pm.output["training_metrics"][k] -
                   jm.output["training_metrics"][k]) <= 1e-7


def test_eif_converter_and_save_load(eif, tmp_path):
    jf, pf, jm, pm = eif
    cm = extendedisolationforest_from_jax_output(_host(jm.output), jm.params,
                                                 device="cpu")
    want = np.asarray(jm.predict_raw(jf))[:800]
    got = cm.predict_raw(pf).numpy()
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=0, atol=1e-7)
    loaded = Model.load(pm.save(str(tmp_path / "eif.bin")), device="cpu")
    assert torch.equal(loaded.predict_raw(pf), pm.predict_raw(pf))


def test_eif_extension_level_checked():
    _, pf = _frames(100, 3, 7.0, 5, 44)
    with pytest.raises(ValueError, match="extension_level"):
        ExtendedIsolationForest(device="cpu", extension_level=3).train(
            training_frame=pf)
