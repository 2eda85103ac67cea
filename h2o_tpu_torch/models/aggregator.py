"""Aggregator — port of ``h2o_tpu/models/aggregator.py`` (``_nearest``
:33-40, ``_aggregate`` :43-67, ``AggregatorModel`` :70-86,
``Aggregator`` :89-167).

Rows are expanded as GLM expands them (categoricals one-hot, numerics
mean-imputed, standardized under NORMALIZE or STANDARDIZE) and streamed
in batches of 4,096 at a fixed squared radius: a row joins its nearest
exemplar when the squared distance is within the radius, else it becomes
a new exemplar.  On the model's device each batch takes its squared
distances to the exemplars born before it as one product, ``|b|^2 - 2
b e' + |e|^2`` (``torch.matmul``; TF32 stays off), and ``argmin``, which
keeps the first minimum as ``jnp.argmin`` does.  On the host, each row
of the batch is then held against the exemplars born earlier in the
same batch in the reference's order and numpy float32 arithmetic: a
squared distance ``np.sum((b - e) ** 2)`` strictly below the best so
far wins, the first of equal ones stays.  The comparisons with the
newborn exemplars of one row are one row-wise ``np.sum(..., axis=1)``,
whose float32 sums equal the scalar ``np.sum`` of each row (held by
``tests/test_torch_isotonic_aggregator.py``); the loop over rows stays
sequential, since each row may add an exemplar.

The radius is searched as the reference searches it: from the data's
spread over the target, doubled or halved until the exemplar count is
bracketed, then bisected geometrically, at most 12 trials, keeping the
trial nearest the target.  The exemplar rows in the original columns
(each exemplar's first row) with a ``counts`` column form the
aggregated frame; the reference puts it in the DKV (``:157-158``), the
port keeps it as ``output["aggregated_frame"]`` (P13 brings the DKV),
and ``aggregated_frame()`` returns it.  ``predict_raw`` gives each row's
nearest exemplar.  Iteration checkpoints (P14) are refused.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.core.frame import Frame, Vec
from h2o_tpu_torch.models import metrics as mm
from h2o_tpu_torch.models.glm import expand_for_scoring, expansion_spec
from h2o_tpu_torch.models.model import DataInfo, Model, ModelBuilder

BATCH = 4096
TRIALS = 12


def nearest(batch: torch.Tensor, exemplars: torch.Tensor):
    """(index of the nearest exemplar, its squared distance clamped at 0)
    for each row of ``batch``, by the expanded product."""
    d2 = (torch.sum(batch ** 2, dim=1, keepdim=True)
          - 2.0 * (batch @ exemplars.T)
          + torch.sum(exemplars ** 2, dim=1)[None, :])
    j = torch.argmin(d2, dim=1)
    return j, torch.clamp_min(torch.gather(d2, 1, j[:, None])[:, 0], 0.0)


def aggregate(X: torch.Tensor, radius2: float, batch: int = BATCH):
    """One aggregation pass over the rows of ``X`` (on its device) at a
    fixed squared radius: (exemplars (n, P) float32, counts (n,),
    assignment (rows,))."""
    Xh = X.cpu().numpy()
    ex = [Xh[0]]
    counts = [0]
    assign = np.zeros(len(Xh), np.int64)
    born = np.empty((batch, Xh.shape[1]), Xh.dtype)     # this batch's new
    for lo in range(0, len(Xh), batch):
        B = Xh[lo: lo + batch]
        n0 = len(ex)
        j, d2 = nearest(X[lo: lo + batch], torch.from_numpy(
            np.stack(ex)).to(X.device))
        j, d2 = j.cpu().numpy(), d2.cpu().numpy()
        for i in range(len(B)):
            best, bd = int(j[i]), float(d2[i])
            # exemplars born within this batch are not in the device matrix
            m = len(ex) - n0
            if m:
                dd = np.sum((B[i] - born[:m]) ** 2, axis=1)
                k = int(np.argmin(dd))
                if float(dd[k]) < bd:
                    best, bd = n0 + k, float(dd[k])
            if bd <= radius2:
                counts[best] += 1
                assign[lo + i] = best
            else:
                born[m] = B[i]
                ex.append(B[i])
                counts.append(1)
                assign[lo + i] = len(ex) - 1
    return np.stack(ex), np.asarray(counts), assign


class AggregatorModel(Model):
    algo = "aggregator"

    def predict_raw(self, frame: Frame) -> torch.Tensor:
        """(rows,) the nearest exemplar of each row, as float32."""
        out = self.output
        X = expand_for_scoring(frame, out["expansion_spec"], self.device)
        j, _ = nearest(X, torch.from_numpy(np.asarray(
            out["exemplars_std"], np.float32)).to(self.device))
        return j.to(torch.float32)

    def aggregated_frame(self) -> Frame:
        """The exemplar rows in the original columns and their
        ``counts`` (the frame the reference puts in the DKV)."""
        return self.output["aggregated_frame"]

    def model_metrics(self, frame: Frame = None) -> mm.ModelMetrics:
        return mm.aggregator_metrics(self.output["num_exemplars"],
                                     self.output["radius_scale"])


def aggregated_frame(train: Frame, first_row: np.ndarray,
                     counts: np.ndarray) -> Frame:
    """The rows ``first_row`` of ``train``'s numeric and categorical
    columns, and a ``counts`` column."""
    names, vecs = [], []
    for nm, v in zip(train.names, train.vecs):
        if v.data is None:
            continue
        names.append(nm)
        vecs.append(Vec(v.to_numpy()[first_row], v.type, domain=v.domain))
    names.append("counts")
    vecs.append(Vec(counts.astype(np.float32)))
    return Frame(names, vecs)


def aggregator_from_jax_output(output: Dict, params: Dict,
                               aggregated: Optional[Frame] = None,
                               device: DeviceLike = None) -> AggregatorModel:
    """The port's ``AggregatorModel`` from an ``h2o_tpu`` Aggregator's
    output dict (arrays as numpy); ``aggregated``, the reference's DKV
    frame as a port frame, becomes ``output["aggregated_frame"]``."""
    out = dict(x=list(output["x"]),
               exemplars_std=np.array(output["exemplars_std"], np.float32),
               num_exemplars=int(output["num_exemplars"]),
               counts=np.array(output["counts"]),
               radius_scale=float(output["radius_scale"]),
               expansion_spec=dict(output["expansion_spec"]),
               aggregated_frame=aggregated)
    m = AggregatorModel(dict(params), out, cloud(device))
    out["training_metrics"] = m.model_metrics()
    return m


class Aggregator(ModelBuilder):
    algo = "aggregator"
    model_cls = AggregatorModel
    supervised = False
    supports_cv = False

    ENGINE_FIXED = {
        # the expansion GLM uses: one-hot categoricals
        "categorical_encoding": ("AUTO", "OneHotInternal"),
        # the reference standardizes under both and treats every other
        # transform as NONE: those are refused
        "transform": ("NONE", "NORMALIZE", "STANDARDIZE"),
    }

    def default_params(self) -> Dict:
        p = super().default_params()
        p.update(target_num_exemplars=5000, rel_tol_num_exemplars=0.5,
                 transform="NORMALIZE", categorical_encoding="AUTO")
        return p

    def _fit(self, x: List[str], y: Optional[str], train: Frame,
             valid: Optional[Frame] = None) -> AggregatorModel:
        self.refuse_iteration_checkpoints()
        p = self.params
        di = DataInfo(train, x, None, self.device, mode="expanded",
                      standardize=(str(p["transform"]).upper() in
                                   ("NORMALIZE", "STANDARDIZE")),
                      impute_missing=True)
        X = di.matrix()
        Xh = X.cpu().numpy()
        target = int(p["target_num_exemplars"])
        tol = float(p["rel_tol_num_exemplars"])
        lo_ok = target * (1 - tol)
        # initial radius from the data spread, then doubled or halved
        # until bracketed, then bisected geometrically
        span = float(np.mean(np.var(Xh, axis=0))) * Xh.shape[1]
        radius2 = span / max(target, 1)
        best, best_dist = None, np.inf
        r_lo = r_hi = None
        for trial in range(TRIALS):
            ex, counts, assign = aggregate(X, radius2)
            n = len(ex)
            self._update(0.1 + 0.07 * trial,
                         f"radius²={radius2:.4g} -> {n} exemplars")
            dist = abs(n - target)
            if dist < best_dist:
                best, best_dist = (ex, counts, assign, radius2), dist
            if lo_ok <= n <= target:
                break
            if n > target:
                r_lo = radius2
            else:
                r_hi = radius2
            if r_lo is not None and r_hi is not None:
                radius2 = float(np.sqrt(r_lo * r_hi))
            elif n > target:
                radius2 *= 2.0
            else:
                radius2 /= 2.0
        ex, counts, assign, radius2 = best
        # each exemplar's first row carries its original values
        first_row = np.full(len(ex), -1, np.int64)
        seen = np.unique(assign, return_index=True)
        first_row[seen[0]] = seen[1]
        out = dict(x=list(di.x), exemplars_std=ex, num_exemplars=len(ex),
                   counts=counts, radius_scale=float(np.sqrt(radius2)),
                   expansion_spec=expansion_spec(di),
                   aggregated_frame=aggregated_frame(train, first_row,
                                                     counts))
        model = self.model_cls(dict(p), out, self.device)
        out["training_metrics"] = model.model_metrics()
        return model
