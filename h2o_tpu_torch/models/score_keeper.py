"""ScoreKeeper — port of ``h2o_tpu/models/score_keeper.py`` (``_MAXIMIZE``,
``_KEYS``, ``resolve_stopping_metric``, ``metric_value``, ``ScoreKeeper``
:1-114; reference hex/ScoreKeeper.java).

A scoring event records one metric value and one scoring-history row;
``stop_early`` compares the mean of the last k events with the mean of
the k before them and stops when the relative improvement is below
``tolerance``.  Pure Python: the port keeps its own copy so that it
imports nothing of the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

#: metric -> True if larger is better (ScoreKeeper.StoppingMetric direction)
_MAXIMIZE = {
    "auc": True, "aucpr": True, "pr_auc": True, "accuracy": True,
    "r2": True, "lift_top_group": True,
    "logloss": False, "mse": False, "rmse": False, "mae": False,
    "rmsle": False, "deviance": False, "mean_residual_deviance": False,
    "err": False, "misclassification": False, "mean_per_class_error": False,
    "anomaly_score": False, "custom": False, "tot_withinss": False,
}

#: stopping-metric name -> ModelMetrics data key
_KEYS = {
    "auc": "AUC", "aucpr": "pr_auc", "pr_auc": "pr_auc",
    "logloss": "logloss", "mse": "mse", "rmse": "rmse", "mae": "mae",
    "rmsle": "rmsle", "deviance": "mean_residual_deviance",
    "mean_residual_deviance": "mean_residual_deviance", "err": "err",
    "misclassification": "err", "mean_per_class_error":
    "mean_per_class_error", "r2": "r2", "tot_withinss": "tot_withinss",
}


def resolve_stopping_metric(name: str, kind: str) -> str:
    """AUTO resolution (ScoreKeeper.StoppingMetric.AUTO): logloss for
    classification, deviance for regression, anomaly for IF."""
    n = (name or "AUTO").lower()
    if n != "auto":
        return n
    if kind in ("binomial", "multinomial"):
        return "logloss"
    if kind == "anomaly":
        return "anomaly_score"
    if kind == "clustering":
        return "tot_withinss"
    return "deviance"


def is_maximizing(metric: str) -> bool:
    return _MAXIMIZE.get(metric.lower(), False)


def metric_value(mm, metric: str) -> float:
    """A stopping metric's value in a ModelMetrics; a key the metrics do
    not hold falls back to the mean residual deviance, then the MSE."""
    m = metric.lower()
    key = _KEYS.get(m, m)
    v = mm.get(key)
    if v is None:
        v = mm.get("mean_residual_deviance", mm.get("mse"))
    if v is None:
        return float("nan")
    return float(v)


class ScoreKeeper:
    """Records scoring-event history and answers stop_early."""

    def __init__(self, metric: str = "AUTO", kind: str = "regression",
                 stopping_rounds: int = 0, tolerance: float = 1e-3):
        self.metric_name = resolve_stopping_metric(metric, kind)
        self.maximize = is_maximizing(self.metric_name)
        self.rounds = int(stopping_rounds)
        self.tolerance = float(tolerance)
        self.history: List[float] = []
        self.events: List[Dict] = []   # scoring_history rows

    def add(self, mm, extra: Optional[Dict] = None) -> None:
        v = metric_value(mm, self.metric_name)
        self.history.append(v)
        row = dict(extra or {})
        row[self.metric_name] = v
        self.events.append(row)

    def stop_early(self) -> bool:
        """Moving-average comparison over the last 2k events
        (ScoreKeeper.stopEarly: the mean of the last k against the mean
        of the previous k must improve by the relative ``tolerance``);
        NaN events are left out."""
        k = self.rounds
        if k <= 0 or len(self.history) < 2 * k:
            return False
        hist = [h for h in self.history if not math.isnan(h)]
        if len(hist) < 2 * k:
            return False
        recent = sum(hist[-k:]) / k
        ref = sum(hist[-2 * k: -k]) / k
        if self.maximize:
            improved = recent > ref * (1.0 + self.tolerance) if ref >= 0 \
                else recent > ref * (1.0 - self.tolerance)
        else:
            improved = recent < ref * (1.0 - self.tolerance) if ref >= 0 \
                else recent < ref * (1.0 + self.tolerance)
        return not improved

    @property
    def best_index(self) -> int:
        if not self.history:
            return -1
        op = max if self.maximize else min
        return self.history.index(op(self.history))
