"""Leaderboard — port of ``h2o_tpu/models/leaderboard.py`` (the
``_EXTRA_*`` columns :18-21, ``_ranking_metrics`` :24-28, ``Leaderboard``
:31-132; reference hex/leaderboard/Leaderboard.java and the AutoML
columns of ai/h2o/automl/leaderboard/).

Models rank by their cross-validation metrics, else validation, else
training; ``scoring_data`` pins one source, and a ``leaderboard_frame``
ranks every model on that frame instead (scored once a model, on the
model's device).  The sort metric is the user's, else AUC for binomial,
mean per-class error for multinomial and the stopping metric's AUTO
(deviance) otherwise.  Equal metrics keep the order models were added
in (Python's stable sort, as the reference's).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from h2o_tpu_torch.core.store import Key
from h2o_tpu_torch.models.score_keeper import (is_maximizing, metric_value,
                                               resolve_stopping_metric)

_EXTRA_BINOMIAL = ("AUC", "logloss", "pr_auc", "mean_per_class_error",
                   "rmse", "mse")
_EXTRA_MULTI = ("mean_per_class_error", "logloss", "rmse", "mse")
_EXTRA_REG = ("mean_residual_deviance", "rmse", "mse", "mae", "rmsle")


def _ranking_metrics(model) -> "tuple[object, str]":
    mm = model.output.get("cross_validation_metrics") or \
        model.output.get("validation_metrics") or \
        model.output.get("training_metrics")
    return mm, mm.kind if mm is not None else "regression"


class Leaderboard:
    """Sorted model table (Leaderboard.java)."""

    def __init__(self, project_name: str = "",
                 sort_metric: Optional[str] = None,
                 leaderboard_frame=None,
                 scoring_data: str = "auto"):
        self.key = Key.make(f"leaderboard_{project_name or 'default'}")
        self.project_name = project_name
        self.sort_metric = sort_metric
        self.leaderboard_frame = leaderboard_frame
        # 'auto' = xval > valid > train preference; 'train'/'valid'/
        # 'xval' pin the source (AstMakeLeaderboard scoringData)
        self.scoring_data = str(scoring_data or "auto").lower()
        self._lb_metrics: Dict[tuple, object] = {}
        self.models: List = []

    def _metrics_for(self, model) -> "tuple[object, str]":
        """Ranking metrics: on the leaderboard frame when one is set,
        else the pinned ``scoring_data`` source, else xval > valid >
        train."""
        if self.leaderboard_frame is None:
            if self.scoring_data in ("train", "valid", "xval"):
                key = {"train": "training_metrics",
                       "valid": "validation_metrics",
                       "xval": "cross_validation_metrics"}[
                    self.scoring_data]
                mm = model.output.get(key)
                if mm is None:
                    raise ValueError(
                        f"model {model.key} has no {self.scoring_data} "
                        "metrics")
                return mm, mm.kind
            return _ranking_metrics(model)
        k = (str(model.key), str(self.leaderboard_frame.key))
        if k not in self._lb_metrics:
            self._lb_metrics[k] = model.model_metrics(
                self.leaderboard_frame)
        mm = self._lb_metrics[k]
        return mm, mm.kind

    def add(self, *models) -> None:
        seen = {str(m.key) for m in self.models}
        for m in models:
            if str(m.key) not in seen:
                self.models.append(m)
                seen.add(str(m.key))

    def _resolve_sort(self) -> str:
        if self.sort_metric:
            return self.sort_metric
        if not self.models:
            return "mse"
        _, kind = self._metrics_for(self.models[0])
        if kind == "binomial":
            return "auc"
        if kind == "multinomial":
            return "mean_per_class_error"
        return resolve_stopping_metric("AUTO", kind)

    def sorted_models(self) -> List:
        metric = self._resolve_sort()
        return sorted(
            self.models,
            key=lambda m: metric_value(self._metrics_for(m)[0], metric),
            reverse=is_maximizing(metric))

    @property
    def leader(self):
        ms = self.sorted_models()
        return ms[0] if ms else None

    def rows(self) -> List[Dict]:
        out = []
        for m in self.sorted_models():
            mm, kind = self._metrics_for(m)
            extras = {"binomial": _EXTRA_BINOMIAL,
                      "multinomial": _EXTRA_MULTI}.get(kind, _EXTRA_REG)
            row = {"model_id": str(m.key), "algo": m.algo}
            for e in extras:
                row[e.lower()] = metric_value(mm, e)
            row["training_time_ms"] = getattr(m, "run_time_ms", 0)
            out.append(row)
        return out

    def to_dict(self) -> Dict:
        return {"project_name": self.project_name,
                "sort_metric": self._resolve_sort(),
                "models": self.rows()}

    def __repr__(self) -> str:
        lines = [f"<Leaderboard {self.project_name} "
                 f"sort={self._resolve_sort()}>"]
        for r in self.rows():
            lines.append("  " + "  ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in r.items()))
        return "\n".join(lines)
