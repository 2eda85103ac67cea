"""Infogram — port of ``h2o_tpu/models/infogram.py`` (``_model_logloss``
:30-46, ``InfogramModel`` :49-69, ``Infogram`` :72-126).

Admissible-ML feature diagnostics from the port's GBMs, so K2 (the
adaptive histogram kernel, on the card) carries every level of them:

- relevance: the ``varimp`` of a 20-tree, depth-5 GBM on every
  candidate predictor, over its largest;
- information: for each predictor, the drop in training logloss from
  the conditioning set (``protected_columns``: the fair infogram; none:
  the core infogram, whose baseline is the prior's entropy) to the set
  plus the predictor, each a 10-tree, depth-3 GBM at learn rate 0.3,
  over the largest drop.

A predictor is admissible when both indices reach their thresholds
(``net_information_threshold``, ``total_information_threshold``); the
table is sorted by the sum of the two.  ``top_n_features`` caps the
predictors, in frame order.  The GBMs run with the builder's ``seed``
(each draws its own key from it when it is < 0, as in the reference).
``predict_raw`` raises, as the reference's does.  ``recovery_dir``
snapshots the build (``models/model.py``), as the reference's does; no
iteration checkpoint.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.core.frame import Frame
from h2o_tpu_torch.models import metrics as mm
from h2o_tpu_torch.models.model import DataInfo, Model, ModelBuilder
from h2o_tpu_torch.models.tree.gbm import GBM

EPS = 1e-12


def _model_logloss(x_cols: List[str], y: str, train: Frame, seed,
                   device) -> float:
    """Cross-entropy of a small GBM using x_cols (none: the prior's)."""
    if not x_cols:
        yv = np.asarray(train.vec(y).to_numpy(), np.float64)
        yv = yv[yv >= 0]
        k = int(yv.max()) + 1 if len(yv) else 2
        ll = 0.0
        for c in range(k):
            pc = max(float((yv == c).mean()), EPS)
            ll -= pc * np.log(pc)
        return ll
    m = GBM(device=device, ntrees=10, max_depth=3, learn_rate=0.3,
            seed=seed, response_column=y)._fit(list(x_cols), y, train, None)
    return float(m.output["training_metrics"].get("logloss")
                 or m.output["training_metrics"]["mse"])


class InfogramModel(Model):
    algo = "infogram"

    def admissible_features(self) -> List[str]:
        return list(self.output["admissible_features"])

    def result(self, use_pandas: bool = False):
        """The table's rows (column, relevance_index, information_index,
        admissible), most relevant and informative first."""
        rows = self.output["infogram_table"]
        if use_pandas:
            import pandas as pd
            return pd.DataFrame(rows, columns=[
                "column", "relevance_index", "information_index",
                "admissible"])
        return rows

    def predict_raw(self, frame: Frame):
        raise NotImplementedError("Infogram is a diagnostic, not a scorer")

    def model_metrics(self, frame: Frame = None) -> mm.ModelMetrics:
        return mm.infogram_metrics(self.output["admissible_features"])


def infogram_from_jax_output(output: Dict, params: Dict,
                             device: DeviceLike = None) -> InfogramModel:
    """The port's ``InfogramModel`` from an ``h2o_tpu`` Infogram's
    output dict."""
    out = dict(infogram_table=[(str(c), float(r), float(i), bool(a))
                               for c, r, i, a in output["infogram_table"]],
               admissible_features=list(output["admissible_features"]),
               protected_columns=list(output["protected_columns"]),
               x=list(output["x"]))
    model = InfogramModel(dict(params), out, cloud(device))
    out["training_metrics"] = model.model_metrics()
    return model


class Infogram(ModelBuilder):
    algo = "infogram"
    model_cls = InfogramModel
    supports_cv = False

    def default_params(self) -> Dict:
        p = super().default_params()
        p.update(protected_columns=None, net_information_threshold=0.1,
                 total_information_threshold=0.1, top_n_features=50)
        return p

    def _fit(self, x: List[str], y: str, train: Frame,
             valid: Optional[Frame] = None) -> InfogramModel:
        p = self.params
        dev = self.device
        protected = list(p.get("protected_columns") or [])
        x = [c for c in x if c not in protected]
        di = DataInfo(train, x, y, dev, mode="tree")
        preds = list(di.x)[: int(p.get("top_n_features") or 50)]
        seed = p.get("seed", -1)

        # relevance: varimp of a GBM on all candidate predictors
        self._update(0.1, "relevance model")
        rel_model = GBM(device=dev, ntrees=20, max_depth=5, seed=seed,
                        response_column=y)._fit(preds, y, train, None)
        vi = np.asarray(rel_model.output.get("varimp"))
        rel = vi / max(vi.max(), EPS)
        rel_map = dict(zip(rel_model.output["x"], rel))

        # information: logloss reduction of [conditioning + x_j] over
        # [conditioning]
        base_ll = _model_logloss(protected, y, train, seed, dev)
        info = []
        for i, c in enumerate(preds):
            self._update(0.2 + 0.7 * i / len(preds), f"CMI {c}")
            info.append(max(base_ll - _model_logloss(
                protected + [c], y, train, seed, dev), 0.0))
        info = np.asarray(info)
        info_idx = info / max(info.max(), EPS)

        net_thr = float(p["net_information_threshold"])
        tot_thr = float(p["total_information_threshold"])
        table, admissible = [], []
        for c, ii in zip(preds, info_idx):
            ri = float(rel_map.get(c, 0.0))
            ok = bool(ri >= net_thr and ii >= tot_thr)
            table.append((c, ri, float(ii), ok))
            if ok:
                admissible.append(c)
        table.sort(key=lambda r: -(r[1] + r[2]))

        out = dict(infogram_table=table, admissible_features=admissible,
                   protected_columns=protected, x=preds)
        model = self.model_cls(dict(p, response_column=y), out, dev)
        out["training_metrics"] = model.model_metrics()
        return model
