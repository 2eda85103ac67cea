"""The array fast path and the port's ``ScoringEngine``
(``h2o_tpu_torch.serve.engine``) held against ``h2o_tpu``'s on the CPU.

- ``predict_raw_array`` of the carried GBM, DRF, XGBoost gbtree,
  gblinear and binomial GLM on one raw matrix (NaN cells, NA codes and
  an unseen code 7 for ``c``) equals the reference's within the
  converter tests' tolerances (probabilities and values 1e-6 for the
  forests, 1e-5 for the linear models; labels equal where p1 is more
  than that from the threshold), and equals the port's own
  ``predict_raw(frame)`` bitwise on the training frame;
  ``predict_array`` returns the same as numpy, and the host scorer for
  a model without a fast path, by type: a ``NotImplementedError`` from
  inside a device predict propagates;
- ``encode_rows`` equals the reference engine's on JSON-like rows with
  unseen levels, missing keys, None, numbers given as strings and
  unparseable values;
- the engine's answers for n in {1, 3, 17, 64, 100} rows equal
  ``predict_raw_array`` on the same rows bitwise (the card is held so
  in ``chip_smoke.py`` phase 20d); ``buckets_for``, ``evict`` and
  ``stats`` report the buckets, the LRU capacity bounds the table;
- KMeans, with no device predict, is answered by the host scorer and
  counted in ``fallback_batches``;
- chaos slow-score at p = 1 delays ``predict`` by its ms and counts;
- a ``warm`` whose predict raises, raises (the reference moves such a
  version to the numpy scorer); out of device memory the batch splits
  into halved chunks, and at one row the error is raised.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from h2o_tpu.serve.engine import ScoringEngine as JEngine

from h2o_tpu_torch.serve import ScoringEngine
from tests.test_torch_mojo import XM, carried, dataset, raw_matrix
from h2o_tpu_torch.core.store import unpublish_on_exit


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv

FAST = {"gbm": 1e-6, "drf": 1e-6, "xgboost": 1e-6, "xgboost_linear": 1e-5,
        "glm": 1e-5}


def _raw_X():
    """The mixed frame's raw matrix with NaN cells, NA codes and an
    unseen code (7) in ``c``."""
    X = raw_matrix(dataset("mixed")[1], XM)
    X[::11, 2] = 7.0
    X[::13, 1] = np.nan
    return X


@pytest.mark.parametrize("name", sorted(FAST))
def test_predict_raw_array_matches_reference(name):
    jm, cm, _ = carried(name)
    X = _raw_X()
    want = np.asarray(jm.predict_raw_array(jnp.asarray(X, jnp.float32)))
    got = cm.predict_raw_array(X)
    assert got.device == torch.device("cpu") and got.dtype == torch.float32
    got = got.numpy()
    tol = FAST[name]
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=0, atol=tol)
    decided = np.abs(want[:, 2] - 0.5) > tol
    np.testing.assert_array_equal(got[decided, 0], want[decided, 0])
    np.testing.assert_array_equal(cm.predict_array(X), got)


@pytest.mark.parametrize("name", sorted(FAST))
def test_predict_raw_array_is_predict_raw(name):
    _, cm, _ = carried(name)
    _, pf = dataset("mixed")
    np.testing.assert_array_equal(
        cm.predict_raw_array(raw_matrix(pf, XM)).numpy(),
        cm.predict_raw(pf).numpy())


def test_predict_array_without_fast_path_uses_host_scorer():
    from h2o_tpu_torch.mojo import _flatten_arrays, scorers
    _, cm, _ = carried("kmeans")
    X = raw_matrix(dataset("numeric")[1], [f"n{j}" for j in range(4)])
    with pytest.raises(NotImplementedError, match="kmeans"):
        cm.predict_raw_array(X)
    arrays, meta = _flatten_arrays(cm.output)
    np.testing.assert_array_equal(cm.predict_array(X),
                                  scorers.score_kmeans(arrays, meta, X))


def test_predict_array_raises_from_a_device_predict(monkeypatch):
    """A model with a device predict never reaches the host scorer: a
    ``NotImplementedError`` raised inside its predict propagates."""
    # a copy: undoing a patch of an instance attribute leaves the bound
    # method on the instance, which would hide class-level spies from
    # every later test that reads the shared carried model
    cm = copy.copy(carried("gbm")[1])
    assert cm.has_device_predict()

    def fails(X):
        raise NotImplementedError("inside the device predict")
    monkeypatch.setattr(cm, "predict_raw_array", fails)
    with pytest.raises(NotImplementedError, match="inside the device"):
        cm.predict_array(_raw_X())


ROWS = [{"x0": 0.5, "x1": -1.0, "c": "cc"},
        {"x0": "1.25", "x1": 2, "c": "zz"},          # unseen level
        {"x1": 0.3},                                  # missing keys
        {"x0": None, "x1": "n/a", "c": "a"},          # None, unparseable
        {"x0": [1], "x1": 0.0, "c": 3},               # a code as number
        {}]


def test_encode_rows_equals_reference():
    jm, cm, _ = carried("gbm")
    want = JEngine().encode_rows(jm, 0, ROWS)
    got = ScoringEngine().encode_rows(cm, 0, ROWS)
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[1, 2]) and got[0, 2] == 2.0


@pytest.mark.parametrize("name", sorted(FAST))
def test_engine_answers_equal_unbucketed(name):
    """The engine's answer is ``predict_raw_array`` on the same rows,
    bitwise, and each batch is recorded under its power-of-two
    bucket."""
    _, cm, _ = carried(name)
    eng = ScoringEngine()
    X = _raw_X()
    for n in (1, 3, 17, 64, 100):
        got = eng.predict(cm, 1, X[:n])
        np.testing.assert_array_equal(got, cm.predict_raw_array(X[:n]).numpy())
    assert eng.buckets_for(cm.model_id, 1) == [1, 4, 32, 64, 128]
    assert eng.stats() == {"compiled_cache_entries": 5, "compiled_total": 5,
                           "cache_capacity": 256, "device_batches": 5,
                           "fallback_batches": 0}
    eng.evict(cm.model_id, 1)
    assert eng.buckets_for(cm.model_id, 1) == []
    assert eng.stats()["compiled_cache_entries"] == 0


def test_warm_capacity_and_lru():
    _, cm, _ = carried("gbm")
    eng = ScoringEngine()
    assert eng.capacity == 256
    eng.capacity = 2
    eng.warm(cm, 0, (1, 32, 1000))
    assert eng.buckets_for(cm.model_id, 0) == [32, 1024]
    assert eng.stats()["compiled_total"] == 3
    assert eng.stats()["device_batches"] == 0
    assert eng.supports(cm) and eng.has_device_predict(cm)


def test_kmeans_goes_to_host_scorer():
    _, cm, _ = carried("kmeans")
    eng = ScoringEngine()
    assert eng.supports(cm) and not eng.has_device_predict(cm)
    eng.warm(cm, 0, (1, 32))
    assert eng.buckets_for(cm.model_id, 0) == []
    X = raw_matrix(dataset("numeric")[1], [f"n{j}" for j in range(4)])
    np.testing.assert_array_equal(eng.predict(cm, 0, X[:10]),
                                  cm.predict_array(X[:10]))
    assert eng.stats()["fallback_batches"] == 1
    assert eng.stats()["device_batches"] == 0


class _Failing:
    """A model whose device predict fails as ``exc`` does above
    ``max_rows`` rows."""

    algo = "gbm"

    def __init__(self, model, exc, max_rows=0):
        self.model, self.exc, self.max_rows = model, exc, max_rows
        self.model_id, self.output = "failing", model.output
        self.params, self.device = model.params, model.device

    def predict_raw_array(self, X):
        if X.shape[0] > self.max_rows:
            raise self.exc
        return self.model.predict_raw_array(X)


def test_warm_raises_instead_of_falling_back(monkeypatch):
    _, cm, _ = carried("gbm")
    eng = ScoringEngine()
    monkeypatch.setattr(ScoringEngine, "has_device_predict",
                        staticmethod(lambda m: True))
    with pytest.raises(RuntimeError, match="device predict failed"):
        eng.warm(_Failing(cm, RuntimeError("device predict failed")), 0,
                 (1, 32))
    assert eng.stats()["fallback_batches"] == 0


def test_oom_halves_the_chunk_then_raises(monkeypatch):
    _, cm, _ = carried("gbm")
    monkeypatch.setattr(ScoringEngine, "has_device_predict",
                        staticmethod(lambda m: True))
    oom = torch.cuda.OutOfMemoryError("out of memory")
    X = _raw_X()[:20]
    eng = ScoringEngine()
    got = eng.predict(_Failing(cm, oom, max_rows=8), 0, X)
    np.testing.assert_array_equal(got, cm.predict_raw_array(X).numpy())
    # 20 rows: bucket 32 fails, chunks of 10 (bucket 16) fail, chunks
    # of 5 (bucket 8) answer
    assert eng.buckets_for("failing", 0) == [8, 16, 32]
    assert eng.stats()["device_batches"] == 4
    assert eng.stats()["fallback_batches"] == 0
    with pytest.raises(torch.cuda.OutOfMemoryError):
        eng.predict(_Failing(cm, oom, max_rows=0), 1, X)
    assert eng.stats()["fallback_batches"] == 0


def test_chaos_slow_score_delays_predict():
    """The engine's chaos slow-score hook (the reference's
    ``engine.py:229``): at p = 1 every ``predict`` sleeps
    ``score_slow_ms`` before scoring and counts in
    ``injected_slow_scores``; the answer does not change."""
    import time

    from h2o_tpu_torch.core import chaos as p_chaos
    _, cm, _ = carried("gbm")
    eng = ScoringEngine()
    X = _raw_X()[:5]
    want = eng.predict(cm, 0, X)
    try:
        p_chaos.configure(score_slow_p=1.0, score_slow_ms=30.0, seed=1)
        t0 = time.perf_counter()
        got = eng.predict(cm, 0, X)
        waited = time.perf_counter() - t0
        c = p_chaos.chaos().counters()
    finally:
        p_chaos.reset()
    np.testing.assert_array_equal(got, want)
    assert waited >= 0.03
    assert c["injected_slow_scores"] == 1 and c["injected"] == 1
    assert p_chaos.chaos().counters()["injected"] == 0
