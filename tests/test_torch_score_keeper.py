"""The port's ScoreKeeper held against ``h2o_tpu.models.score_keeper``.

Seeded scoring histories go through both keepers event by event: every
``stop_early`` decision, ``best_index``, the resolved metric name and its
direction must be equal, over every metric name the reference knows,
``stopping_rounds`` 1 to 4, histories of positive and of negative values
(the two branches of the relative tolerance), with and without NaN
events.  Metric names without a ModelMetrics key of their own take the
reference's fallback to the deviance, then the MSE.  The reference's own
two cases (``tests/test_model_ops.py``) run on the port's keeper.
"""

import math

import numpy as np
import pytest

from h2o_tpu.models import score_keeper as jsk
from h2o_tpu.models.metrics import ModelMetrics as JMM

from h2o_tpu_torch.models import score_keeper as psk
from h2o_tpu_torch.models.metrics import ModelMetrics

METRICS = sorted(jsk._MAXIMIZE)


def _history(seed: int, sign: float, nans: bool, n: int = 14):
    """A history that improves, then wanders about a plateau."""
    rng = np.random.default_rng(seed)
    trend = np.concatenate([np.linspace(1.0, 0.5, n // 2),
                            0.5 + 0.002 * rng.normal(size=n - n // 2)])
    vals = sign * (trend + 0.01 * rng.uniform(size=n))
    if nans:
        vals[rng.choice(n, 3, replace=False)] = np.nan
    return [float(v) for v in vals]


def _data(metric: str, v: float) -> dict:
    """A metrics dict holding ``v`` under the metric's key where it has
    one, beside an MSE that the fallback reads."""
    d = {"mse": 2.0 * v if not math.isnan(v) else v}
    key = jsk._KEYS.get(metric)
    if key is not None:
        d[key] = v
    return d


def test_tables_equal():
    assert psk._MAXIMIZE == jsk._MAXIMIZE
    assert psk._KEYS == jsk._KEYS


@pytest.mark.parametrize("nans", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["pos", "neg"])
@pytest.mark.parametrize("rounds", [1, 2, 3, 4])
@pytest.mark.parametrize("metric", METRICS)
def test_stop_early_decisions_equal(metric, rounds, sign, nans):
    seed = METRICS.index(metric) * 100 + rounds * 10 + int(nans) + \
        (5 if sign < 0 else 0)
    hist = _history(seed, sign, nans)
    j = jsk.ScoreKeeper(metric, "binomial", stopping_rounds=rounds,
                        tolerance=1e-3)
    p = psk.ScoreKeeper(metric, "binomial", stopping_rounds=rounds,
                        tolerance=1e-3)
    assert (p.metric_name, p.maximize, p.rounds) == \
        (j.metric_name, j.maximize, j.rounds)
    for i, v in enumerate(hist):
        j.add(JMM("binomial", _data(metric, v)), {"number_of_trees": i})
        p.add(ModelMetrics("binomial", _data(metric, v)),
              {"number_of_trees": i})
        assert p.stop_early() == j.stop_early(), (i, hist[: i + 1])
        np.testing.assert_array_equal(p.history, j.history)
    assert p.best_index == j.best_index
    assert len(p.events) == len(j.events)
    for a, b in zip(p.events, j.events):
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(list(a.values()), list(b.values()))


@pytest.mark.parametrize("kind", ["binomial", "multinomial", "regression",
                                  "anomaly", "clustering"])
@pytest.mark.parametrize("name", ["AUTO", "auto", None, "AUC", "Deviance"])
def test_auto_resolution_equal(name, kind):
    assert psk.resolve_stopping_metric(name, kind) == \
        jsk.resolve_stopping_metric(name, kind)


def test_metric_value_fallback_equal():
    for data in ({"mean_residual_deviance": 0.3, "mse": 0.4}, {"mse": 0.4},
                 {}, {"AUC": 0.7}):
        for metric in METRICS + ["unknown"]:
            a = psk.metric_value(ModelMetrics("x", data), metric)
            b = jsk.metric_value(JMM("x", data), metric)
            assert (a == b) or (math.isnan(a) and math.isnan(b)), \
                (metric, data)


def test_score_keeper_stops_on_plateau():
    sk = psk.ScoreKeeper("logloss", "binomial", stopping_rounds=2,
                         tolerance=1e-3)
    for v in [0.6, 0.5, 0.4, 0.3]:       # improving: no stop
        sk.add(ModelMetrics("binomial", {"logloss": v}))
        assert not sk.stop_early()
    for v in [0.3, 0.3, 0.3, 0.3]:       # plateau: stop
        sk.add(ModelMetrics("binomial", {"logloss": v}))
    assert sk.stop_early()


def test_score_keeper_maximizing_auc():
    sk = psk.ScoreKeeper("AUC", "binomial", stopping_rounds=2,
                         tolerance=1e-3)
    assert sk.maximize
    for v in [0.6, 0.7, 0.8, 0.9]:
        sk.add(ModelMetrics("binomial", {"AUC": v}))
        assert not sk.stop_early()
