"""TargetEncoder — port of ``h2o_tpu/models/target_encoder.py``
(``_level_fold_aggregates`` :30-38, ``TargetEncoderModel`` :41-100,
``TargetEncoder`` :103-159).

Fitting builds, for each encoded categorical column, the weighted
(count, sum of the response) per (fold, level) as two one-hot products
on the model's device, ``F_onehot' @ L_onehot``, taken over row blocks
so that a column of many levels never holds a (rows, levels) matrix at
once (the block sums add up in float32 to the same product).  Rows with
an NA response weigh 0; an NA code counts nowhere.  Folds are the
``fold_column``'s values, or row i % nfolds under KFold (``nfolds``
means encoding folds here, not cross-validation), else one fold.  The
prior is the weighted response mean.

``transform`` appends ``<col>_te``: the level's mean response, with
``as_training`` leaving out the row's own fold (KFold) or its own
response (LeaveOneOut), blended toward the prior by the sigmoid
``1 / (1 + exp(-(n - k) / f))`` with ``blending``; an NA or unseen level
gets the prior; ``as_training`` adds uniform noise in [-noise, noise]
drawn on the host from ``default_rng(seed)`` in the reference's order
(one draw of all rows per column).  The encodings follow the
reference's numpy dtypes: the small (fold, level) tables of means and
blending weights are computed on the host in float32, exactly its
expressions, and gathered per row on the model's device; LeaveOneOut's
per-row means are float64 there, as numpy promotes them; the noise is
added in float64 and the column cast to float32.  The MOJO form is
``mojo/genmodel.py``'s.  ``recovery_dir`` snapshots the build
(``models/model.py``), as the reference's does; no iteration checkpoint.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.core.frame import Frame, Vec
from h2o_tpu_torch.models import metrics as mm
from h2o_tpu_torch.models.model import DataInfo, Model, ModelBuilder

#: rows a block of the one-hot products: (rows, levels) float32 stays
#: under ~1 GB up to 4,096 levels
BLOCK_ELEMS = 1 << 28
LEAKAGE = ("None", "KFold", "LeaveOneOut")


def level_fold_aggregates(codes: torch.Tensor, y: torch.Tensor,
                          w: torch.Tensor, fold: torch.Tensor, card: int,
                          nfolds: int):
    """(nfolds, card) float32 weighted counts and response sums per level
    and fold, on the tensors' device."""
    dev = codes.device
    levels = torch.arange(card, dtype=codes.dtype, device=dev)
    folds = torch.arange(nfolds, dtype=fold.dtype, device=dev)
    cnt = torch.zeros((nfolds, card), dtype=torch.float32, device=dev)
    s = torch.zeros_like(cnt)
    step = max(1, BLOCK_ELEMS // max(card, 1))
    for lo in range(0, codes.shape[0], step):
        sl = slice(lo, lo + step)
        lvl = (codes[sl, None] == levels[None, :]).to(torch.float32)
        fh = ((fold[sl, None] == folds[None, :]) *
              w[sl, None]).to(torch.float32)                   # (rows, F)
        cnt = cnt + fh.T @ lvl
        s = s + (fh * y[sl, None]).T @ lvl
    return cnt, s


class TargetEncoderModel(Model):
    algo = "targetencoder"

    def transform(self, frame: Frame, as_training: bool = False,
                  noise: Optional[float] = None) -> Frame:
        """``frame`` with a ``<col>_te`` column appended for each encoded
        column; ``as_training`` applies the leakage handling and noise."""
        out, p, dev = self.output, self.params, self.device
        prior = float(out["prior"])
        blend = bool(p.get("blending"))
        k = float(p.get("inflection_point", 10.0))
        f = max(float(p.get("smoothing", 20.0)), 1e-6)
        noise = float(p.get("noise", 0.01)) if noise is None else noise
        holdout = (p.get("data_leakage_handling") or "None").lower()
        seed = int(p.get("seed") if p.get("seed") is not None else -1)
        rng = np.random.default_rng(seed if seed >= 0 else None)
        loo = as_training and holdout == "leaveoneout"
        kfold = as_training and holdout == "kfold" and \
            out.get("fold_assign") is not None

        def dev_t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        res = Frame(list(frame.names), list(frame.vecs))
        for col in out["columns"]:
            enc_cnt = np.asarray(out["enc"][col]["cnt"], np.float32)
            enc_sum = np.asarray(out["enc"][col]["sum"], np.float32)
            tot_cnt = enc_cnt.sum(axis=0)                      # (card,)
            tot_sum = enc_sum.sum(axis=0)
            card = len(tot_cnt)
            codes = dev_t(frame.vec(col).data).long()
            n = codes.shape[0]
            safe = torch.clamp(codes, 0, card - 1)
            # the per-(fold, level) tables, in the reference's numpy
            if kfold:
                cnt = tot_cnt[None, :] - enc_cnt               # (F, card)
                s = tot_sum[None, :] - enc_sum
                fold = dev_t(np.asarray(out["fold_assign"], np.int64)[:n])
                idx = fold * card + safe
            elif loo:
                cnt = (tot_cnt - 1.0)[None, :]
                idx = safe
            else:
                cnt, s, idx = tot_cnt[None, :], tot_sum[None, :], safe
            lam = (1.0 / (1.0 + np.exp(-(cnt - k) / f))).ravel() \
                if blend else None
            if loo:
                # per row, in float64 as numpy promotes it
                # the response's host values (codes, -1 for NA, for a
                # categorical one), as the reference reads them
                yv = dev_t(np.asarray(frame.vec(
                    p["response_column"]).to_numpy(), np.float64))
                c_r = dev_t(cnt.ravel())[idx]
                s_r = dev_t(tot_sum)[idx].double() - torch.nan_to_num(yv)
                mean = torch.where(c_r > 0, s_r / torch.clamp_min(
                    c_r, 1e-30).double(), torch.full_like(s_r, prior))
                if blend:
                    lam_r = dev_t(lam)[idx]
                    mean = lam_r.double() * mean + \
                        ((1 - lam_r) * np.float32(prior)).double()
                mean = torch.where((codes < 0) | (codes >= card),
                                   torch.full_like(mean, prior), mean)
            else:
                tab = np.where(cnt > 0, s / np.maximum(cnt, 1e-30), prior)
                if blend:
                    tab = lam.reshape(tab.shape) * tab + \
                        (1 - lam.reshape(tab.shape)) * prior
                mean = dev_t(tab.astype(np.float32).ravel())[idx]
                mean = torch.where((codes < 0) | (codes >= card),
                                   torch.full_like(mean, prior), mean)
            if as_training and noise > 0:
                mean = mean.double() + dev_t(
                    rng.uniform(-noise, noise, size=n))
            res.add(f"{col}_te", Vec(mean.to(torch.float32).cpu().numpy()))
        return res

    def predict_raw(self, frame: Frame):
        raise NotImplementedError("TargetEncoder scores via transform()")

    def model_metrics(self, frame: Frame = None) -> mm.ModelMetrics:
        return mm.targetencoder_metrics(self.output["columns"],
                                        self.output["prior"])


def targetencoder_from_jax_output(output: Dict, params: Dict,
                                  device: DeviceLike = None
                                  ) -> TargetEncoderModel:
    """The port's ``TargetEncoderModel`` from an ``h2o_tpu``
    TargetEncoder's output dict (arrays as numpy); ``params`` gives the
    leakage handling, blending, noise, seed and response column."""
    fa = output.get("fold_assign")
    out = dict(columns=list(output["columns"]),
               enc={c: dict(cnt=np.array(v["cnt"], np.float32),
                            sum=np.array(v["sum"], np.float32))
                    for c, v in output["enc"].items()},
               prior=float(output["prior"]),
               fold_assign=None if fa is None else np.array(fa, np.int64),
               domains={c: list(d) for c, d in output["domains"].items()},
               model_category="TargetEncoder")
    m = TargetEncoderModel(dict(params), out, cloud(device))
    out["training_metrics"] = m.model_metrics()
    return m


class TargetEncoder(ModelBuilder):
    algo = "targetencoder"
    model_cls = TargetEncoderModel
    supports_cv = False

    ENGINE_FIXED = {"data_leakage_handling": LEAKAGE}

    def default_params(self) -> Dict:
        p = super().default_params()
        p.update(columns=None, data_leakage_handling="None",
                 blending=False, inflection_point=10.0, smoothing=20.0,
                 noise=0.01)
        return p

    def _use_cv(self) -> bool:
        """``nfolds`` and ``fold_column`` are the encoding's KFold
        holdout folds, never cross-validation."""
        return False

    def _fit(self, x: List[str], y: str, train: Frame,
             valid: Optional[Frame] = None) -> TargetEncoderModel:
        p = self.params
        dev = self.device
        fold_col = p.get("fold_column")
        di = DataInfo(train, x, y, dev, mode="tree",
                      weights=p.get("weights_column"))
        cols = list(p.get("columns") or di.cat_names)
        for c in cols:
            if not train.vec(c).is_categorical:
                raise ValueError(f"TargetEncoder column {c} must be "
                                 "categorical")
        yz = torch.nan_to_num(di.response())
        w = torch.where(di.valid_mask(), di.weights(), torch.zeros_like(yz))

        if fold_col:
            fv = train.vec(fold_col).as_float().astype(np.float64)
            _, fold = np.unique(fv, return_inverse=True)
        elif (p.get("data_leakage_handling") or "").lower() == "kfold":
            nf = max(int(p.get("nfolds") or 5), 2)
            fold = np.arange(train.nrows) % nf
        else:
            fold = np.zeros(train.nrows, np.int64)
        nfolds = int(fold.max()) + 1
        fold_dev = torch.from_numpy(fold.astype(np.int32)).to(dev)

        w_np = w.cpu().numpy()
        y_np = yz.cpu().numpy()
        prior = float((w_np * y_np).sum() / max(w_np.sum(), 1e-30))

        enc: Dict[str, Dict[str, np.ndarray]] = {}
        for c in cols:
            v = train.vec(c)
            cnt, s = level_fold_aggregates(
                torch.from_numpy(v.data).to(dev), yz, w, fold_dev,
                v.cardinality, nfolds)
            enc[c] = dict(cnt=cnt.cpu().numpy(), sum=s.cpu().numpy())

        out = dict(columns=cols, enc=enc, prior=prior,
                   fold_assign=fold if nfolds > 1 else None,
                   domains={c: list(train.vec(c).domain) for c in cols},
                   model_category="TargetEncoder")
        model = self.model_cls(dict(p, response_column=y), out, dev)
        out["training_metrics"] = model.model_metrics()
        return model
