"""IsotonicRegression — port of ``h2o_tpu/models/isotonic.py`` (``_pav``
:25-56, ``IsotonicRegressionModel`` :59-72, ``IsotonicRegression``
:75-102).

Fitting is pool-adjacent-violators on the host, the reference's numpy
code unchanged (duplicate x merged into weighted means, then the PAV
stack), so the thresholds are the reference's by construction.  Rows
with an NA x or y, or a weight of 0, are left out.

Scoring runs on the model's device: x clipped to the threshold range
(``out_of_bounds="clip"``; with ``"NA"`` a row outside the range scores
NaN), then ``jnp.interp``'s arithmetic (``jax/_src/numpy/lax_numpy.py``
``_interp``): ``searchsorted(side="right")`` clipped to [1, n - 1], a
knot spacing of at most ``spacing(eps)`` taking the left value, else
``fp[i-1] + (delta / dx) * df`` as the one fused multiply-add XLA
contracts it to (``ops/xlamath.fma``), so a prediction equals the
reference's bit for bit.  The metrics are the regression ones
(``Model.metrics_from_raw``).  ``recovery_dir`` snapshots the build
(``models/model.py``), with no iteration checkpoint, as the reference's;
the MOJO form (``IsotonicCalibrator``) is ``mojo/genmodel.py``'s.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.core.frame import Frame
from h2o_tpu_torch.models.model import DataInfo, Model, ModelBuilder
from h2o_tpu_torch.ops.xlamath import fma

OUT_OF_BOUNDS = ("clip", "NA")
#: ``np.spacing(np.finfo(np.float32).eps)``: jnp.interp's flat-knot test
_FLAT_DX = float(np.spacing(np.finfo(np.float32).eps))


def _pav(x: np.ndarray, y: np.ndarray, w: np.ndarray):
    """Pool-adjacent-violators on sorted x.  Returns threshold (x, y)."""
    order = np.argsort(x, kind="stable")
    x, y, w = x[order], y[order], w[order]
    # merge duplicate x values first (weighted means)
    ux, inv = np.unique(x, return_inverse=True)
    wy = np.bincount(inv, weights=w * y)
    ww = np.bincount(inv, weights=w)
    my = wy / np.maximum(ww, 1e-30)
    # PAV stack
    vals, wts, lo = [], [], []
    for i in range(len(ux)):
        v, wt, l = my[i], ww[i], i
        while vals and vals[-1] > v + 1e-15:
            pv, pw = vals.pop(), wts.pop()
            l = lo.pop()
            v = (pv * pw + v * wt) / (pw + wt)
            wt = pw + wt
        vals.append(v)
        wts.append(wt)
        lo.append(l)
    # emit thresholds: block boundaries (first and last x of each block)
    tx, ty = [], []
    starts = lo + [len(ux)]
    for b in range(len(vals)):
        i0, i1 = starts[b], starts[b + 1] - 1
        tx.append(ux[i0])
        ty.append(vals[b])
        if i1 > i0:
            tx.append(ux[i1])
            ty.append(vals[b])
    return np.asarray(tx, np.float64), np.asarray(ty, np.float64)


def interp(x: torch.Tensor, xp: torch.Tensor,
           fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` in float32 as XLA computes it on the
    CPU (see the module docstring), on x's device."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    flat = torch.abs(dx) <= _FLAT_DX
    f = torch.where(flat, fp[i - 1], fma(
        delta / torch.where(flat, torch.ones_like(dx), dx), df, fp[i - 1]))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class IsotonicRegressionModel(Model):
    algo = "isotonicregression"

    def predict_raw(self, frame: Frame) -> torch.Tensor:
        """(rows,) fitted values on the model's device."""
        out, dev = self.output, self.device
        x = torch.from_numpy(frame.vec(out["x"][0]).as_float()).to(dev)
        tx = torch.from_numpy(np.asarray(out["thresholds_x"],
                                         np.float32)).to(dev)
        ty = torch.from_numpy(np.asarray(out["thresholds_y"],
                                         np.float32)).to(dev)
        yi = interp(torch.clamp(x, tx[0], tx[-1]), tx, ty)
        if out.get("out_of_bounds", "clip") != "clip":
            yi = torch.where((x < tx[0]) | (x > tx[-1]),
                             torch.full_like(yi, float("nan")), yi)
        return yi


def isotonicregression_from_jax_output(
        output: Dict, params: Dict,
        device: DeviceLike = None) -> IsotonicRegressionModel:
    """The port's ``IsotonicRegressionModel`` from an ``h2o_tpu``
    IsotonicRegression's output dict (arrays as numpy); ``params`` gives
    ``response_column``."""
    out = dict(x=list(output["x"]),
               thresholds_x=np.array(output["thresholds_x"], np.float64),
               thresholds_y=np.array(output["thresholds_y"], np.float64),
               out_of_bounds=output.get("out_of_bounds", "clip"),
               nobs=int(output["nobs"]))
    return IsotonicRegressionModel(dict(params), out, cloud(device))


class IsotonicRegression(ModelBuilder):
    algo = "isotonicregression"
    model_cls = IsotonicRegressionModel

    ENGINE_FIXED = {"out_of_bounds": OUT_OF_BOUNDS}

    def default_params(self) -> Dict:
        p = super().default_params()
        p.update(out_of_bounds="clip")
        return p

    def _fit(self, x: List[str], y: str, train: Frame,
             valid: Optional[Frame] = None) -> IsotonicRegressionModel:
        p = self.params
        di = DataInfo(train, x, y, self.device, mode="tree",
                      weights=p.get("weights_column"))
        if len(di.x) != 1:
            raise ValueError("IsotonicRegression wants exactly one "
                             f"predictor, got {di.x}")
        xv = train.vec(di.x[0]).as_float()
        yv = di.response().cpu().numpy()
        wv = di.weights().cpu().numpy()
        ok = ~np.isnan(xv) & ~np.isnan(yv) & (wv > 0)
        tx, ty = _pav(xv[ok], yv[ok], wv[ok])
        out = dict(x=list(di.x), thresholds_x=tx, thresholds_y=ty,
                   out_of_bounds=p.get("out_of_bounds", "clip"),
                   nobs=int(ok.sum()))
        model = self.model_cls(dict(p, response_column=y), out, self.device)
        out["training_metrics"] = model.model_metrics(train)
        if valid is not None:
            out["validation_metrics"] = model.model_metrics(valid)
        return model
