"""NaiveBayes — port of ``h2o_tpu/models/naive_bayes.py``
(``_cat_counts`` :34-41, ``_num_moments`` :44-57, ``NaiveBayesModel``
:60-90, ``NaiveBayes`` :93-154).

Per response class, the weighted level counts of every categorical
predictor and the (count, sum, sum of squares) of every numeric one are
one-hot GEMMs on the model's device: ``Y_onehot' @ X_onehot`` and
``Y_onehot' @ [1, x, x^2]`` with NA cells left out.  On the host they
become the class priors (relative class weights), the Laplace-smoothed
level tables and the Gaussian means and sample standard deviations,
floored at ``eps_sdev`` (or ``min_sdev``).

Scoring sums the log prior and, per predictor, the log conditional
probability floored at ``eps_prob`` (or ``min_prob``); an NA value, and
a categorical code outside the training domain, skip their predictor.
The class probabilities are the softmax of those sums, the label their
argmax; the metrics are the binomial or multinomial ones
(``Model.metrics_from_raw``).  ``recovery_dir`` snapshots the build
(``models/model.py``), as the reference's does; no iteration checkpoint.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.core.frame import Frame
from h2o_tpu_torch.models.model import DataInfo, Model, ModelBuilder

EPS = 1e-30
SQRT_2PI = float(np.sqrt(2.0 * np.pi))


def _class_onehot(y: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """(rows, k) float32: each row's weight in its class's column."""
    cls = torch.arange(k, dtype=y.dtype, device=y.device)
    return ((y[:, None] == cls[None, :]) * w[:, None]).to(torch.float32)


def cat_counts(codes: torch.Tensor, yh: torch.Tensor,
               card: int) -> torch.Tensor:
    """(k, card) weighted level counts of one categorical predictor (an
    NA code counts nowhere)."""
    lv = torch.arange(card, dtype=codes.dtype, device=codes.device)
    return yh.T @ (codes[:, None] == lv[None, :]).to(torch.float32)


def num_moments(X: torch.Tensor, yh: torch.Tensor):
    """Per-class (count, sum, sum of squares) of every numeric predictor:
    three (k, C) tensors; NA cells contribute nothing."""
    ok = ~torch.isnan(X)
    x0 = torch.where(ok, X, torch.zeros_like(X))
    return yh.T @ ok.to(torch.float32), yh.T @ x0, yh.T @ (x0 * x0)


class NaiveBayesModel(Model):
    algo = "naivebayes"

    def predict_raw(self, frame: Frame) -> torch.Tensor:
        """(rows, 1 + K) [label, p0..pK-1] on the model's device."""
        out, p, dev = self.output, self.params, self.device
        k = len(out["response_domain"])
        apriori = torch.from_numpy(np.asarray(out["apriori"],
                                              np.float32)).to(dev)
        ll = torch.log(apriori + EPS)[None, :].expand(frame.nrows, k)
        min_prob = float(p.get("min_prob") or 1e-3)
        eps_prob = float(p.get("eps_prob") or 0.0)
        floor_p = min_prob if eps_prob <= 0 else eps_prob
        for name, tab in out["pcond_cat"].items():
            codes = torch.from_numpy(frame.vec(name).data).to(dev).long()
            t = torch.clamp_min(torch.from_numpy(np.asarray(
                tab, np.float32)).to(dev), floor_p)            # (k, card)
            contrib = torch.log(t[:, codes.clamp(0, t.shape[1] - 1)]).T
            known = (codes >= 0) & (codes < t.shape[1])
            ll = ll + torch.where(known[:, None], contrib,
                                  torch.zeros_like(contrib))
        if out["num_names"]:
            X = frame.as_matrix(out["num_names"], dev)
            mu = torch.from_numpy(np.asarray(out["num_mean"],
                                             np.float32)).to(dev)
            sd = torch.from_numpy(np.asarray(out["num_sd"],
                                             np.float32)).to(dev)
            z = (X[:, None, :] - mu[None, :, :]) / sd[None, :, :]
            pdf = torch.exp(-0.5 * z * z) / (SQRT_2PI * sd[None, :, :])
            lp = torch.log(torch.clamp_min(pdf, floor_p))
            ll = ll + torch.sum(torch.where(torch.isnan(X)[:, None, :],
                                            torch.zeros_like(lp), lp), dim=2)
        probs = torch.softmax(ll, dim=1)
        label = torch.argmax(probs, dim=1).to(torch.float32)
        return torch.cat([label[:, None], probs], dim=1)


def naivebayes_from_jax_output(output: Dict, params: Dict,
                               device: DeviceLike = None
                               ) -> NaiveBayesModel:
    """The port's ``NaiveBayesModel`` from an ``h2o_tpu`` NaiveBayes's
    output dict (arrays as numpy)."""
    def f32(a):
        return None if a is None else np.array(a, np.float32)

    out = dict(x=list(output["x"]),
               response_domain=list(output["response_domain"]),
               apriori=f32(output["apriori"]),
               pcond_cat={k: f32(v) for k, v in output["pcond_cat"].items()},
               num_names=list(output["num_names"]),
               num_mean=f32(output["num_mean"]),
               num_sd=f32(output["num_sd"]),
               domains={k: list(v) for k, v in output["domains"].items()})
    return NaiveBayesModel(dict(params), out, cloud(device))


class NaiveBayes(ModelBuilder):
    algo = "naivebayes"
    model_cls = NaiveBayesModel

    def default_params(self) -> Dict:
        p = super().default_params()
        p.update(laplace=0.0, min_sdev=1e-3, eps_sdev=0.0, min_prob=1e-3,
                 eps_prob=0.0, compute_metrics=True)
        return p

    def _fit(self, x: List[str], y: str, train: Frame,
             valid: Optional[Frame] = None) -> NaiveBayesModel:
        p = self.params
        dev = self.device
        di = DataInfo(train, x, y, dev, mode="tree",
                      weights=p.get("weights_column"))
        if di.nclasses < 2:
            raise ValueError("NaiveBayes requires a categorical response")
        k = di.nclasses
        yv = di.response()
        w = torch.where(di.valid_mask(), di.weights(),
                        torch.zeros_like(yv))
        yh = _class_onehot(torch.nan_to_num(yv), w, k)
        laplace = float(p["laplace"])
        sdev_floor = float(p["eps_sdev"]) if float(p["eps_sdev"]) > 0 \
            else float(p["min_sdev"])

        # class priors: relative class weights (NaiveBayes.java apriori)
        cls_w = torch.sum(yh, dim=0).cpu().numpy()
        apriori = cls_w / max(cls_w.sum(), EPS)

        pcond_cat: Dict[str, np.ndarray] = {}
        for name in di.cat_names:
            v = train.vec(name)
            cnt = cat_counts(torch.from_numpy(v.data).to(dev), yh,
                             v.cardinality).cpu().numpy()
            tab = (cnt + laplace) / np.maximum(
                cnt.sum(axis=1, keepdims=True) + laplace * v.cardinality,
                EPS)
            pcond_cat[name] = tab.astype(np.float32)

        num_mean = num_sd = None
        if di.num_names:
            cnt, s1, s2 = (t.cpu().numpy() for t in num_moments(
                train.as_matrix(di.num_names, dev), yh))
            num_mean = s1 / np.maximum(cnt, EPS)
            var = s2 / np.maximum(cnt, EPS) - num_mean ** 2
            var = var * cnt / np.maximum(cnt - 1, 1)        # sample variance
            num_sd = np.maximum(np.sqrt(np.maximum(var, 0.0)), sdev_floor)

        out = dict(x=list(di.x), response_domain=di.response_domain,
                   apriori=apriori.astype(np.float32), pcond_cat=pcond_cat,
                   num_names=list(di.num_names), num_mean=num_mean,
                   num_sd=num_sd,
                   domains={c: list(train.vec(c).domain)
                            for c in di.cat_names})
        model = self.model_cls(dict(p, response_column=y), out, dev)
        if p.get("compute_metrics", True):
            out["training_metrics"] = model.model_metrics(train)
            if valid is not None:
                out["validation_metrics"] = model.model_metrics(valid)
        return model
