"""PSVM — port of ``h2o_tpu/models/psvm.py`` (``_svm_fit`` :29-54,
``PSVMModel`` :57-75, ``PSVM`` :78-151).

A binary SVM solved in the primal over random Fourier features of the
gaussian kernel (the reference's engine, which replaces H2O-3's ICF
low-rank factorization; the builder says so with ``warnings.warn``).
The rows are expanded and standardized as GLM expands them; the map is
``Z = sqrt(2 / D) cos(X W + b)`` on the model's device, with
``W = normal(kw, (P, D)) * sqrt(2 gamma)`` and ``b = uniform(kb, (D,),
0, 2 pi)`` drawn by ``ops/prng`` from the builder's key split in two,
bit for bit ``jax.random``'s.  ``gamma`` <= 0 means 1 / P; ``rank_ratio``
> 0 sets D to max(16, rank_ratio * rows), else ``feature_dim``.

The fit is ``max_iterations`` averaged subgradient steps on the hinge
objective ``0.5 |beta|^2 + C sum w max(0, 1 - y f)``, each a Python
loop step of eager operations on the device: the margins (one product
with Z), the hinge mask ``margin < 1``, the subgradient (one product
with Z'), a step of ``0.5 / sqrt(t + 1)`` over ``1 + C sum(w) / R``,
where R is the reference's padded row count (``statpack.padded_rows``).
Class probabilities are a Platt sigmoid of the decision value, its 50
Newton steps on the host in the reference's numpy float32 arithmetic.
``predict_raw`` gives [label (decision >= 0), p0, p1]; the metrics are
the binomial ones.  ``kernel_type`` is gaussian only; iteration
checkpoints (P14) are refused; the npz MOJO scores it on the host
(``mojo/scorers.py`` ``score_psvm``).
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.core.frame import Frame
from h2o_tpu_torch.models.glm import expand_for_scoring, expansion_spec
from h2o_tpu_torch.models.model import DataInfo, Model, ModelBuilder
from h2o_tpu_torch.ops import prng, statpack

ENGINE_NOTE = ("PSVM solves the primal with a random-Fourier-feature "
               "kernel map on this engine (the reference's ICF low-rank "
               "approximation is replaced)")


def _f32(v: float, dev) -> torch.Tensor:
    return torch.tensor(float(np.float32(v)), dtype=torch.float32,
                        device=dev)


def fourier_features(X: torch.Tensor, W: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """``sqrt(2 / D) * cos(X @ W + b)``, float32 on X's device."""
    D = W.shape[1]
    scale = torch.sqrt(_f32(2.0 / D, X.device))
    return scale * torch.cos(X @ W + b[None, :])


def svm_fit(Z: torch.Tensor, ysign: torch.Tensor, w: torch.Tensor,
            valid: torch.Tensor, C: float, iters: int, padded_rows: int,
            step_hook=None) -> torch.Tensor:
    """The averaged iterate of ``iters`` subgradient steps (Pegasos
    style); ``step_hook(t, beta, mask)``, when given, sees every step."""
    dev = Z.device
    D = Z.shape[1]
    c = _f32(C, dev)
    wv = torch.where(valid, w, torch.zeros_like(w))
    denom = 1.0 + c * torch.sum(wv) / _f32(padded_rows, dev)
    beta = torch.zeros(D + 1, dtype=torch.float32, device=dev)
    avg = torch.zeros_like(beta)
    for t in range(iters):
        marg = ysign * (Z @ beta[:-1] + beta[-1])
        mask = valid & (marg < 1.0)
        gy = torch.where(mask, w, torch.zeros_like(w)) * ysign
        gw = beta[:-1] - c * (Z.T @ gy)
        gb = -c * torch.sum(gy)
        g = torch.cat([gw, gb[None]])
        step = np.float32(0.5) / np.sqrt(np.float32(t + 1.0))
        beta = beta - _f32(step, dev) * g / denom
        avg = avg + beta
        if step_hook is not None:
            step_hook(t, beta, mask)
    return avg / _f32(iters, dev)


def platt(fdec: np.ndarray, yy: np.ndarray):
    """Platt scaling on the training margins (host 1-d logistic fit in
    the reference's numpy arithmetic)."""
    a_, b_ = -1.0, 0.0
    for _ in range(50):
        z = np.clip(a_ * fdec + b_, -30, 30)
        pr = 1 / (1 + np.exp(-z))
        g_a = np.sum((pr - yy) * fdec)
        g_b = np.sum(pr - yy)
        h_aa = np.sum(pr * (1 - pr) * fdec * fdec) + 1e-6
        h_bb = np.sum(pr * (1 - pr)) + 1e-6
        a_ -= g_a / h_aa
        b_ -= g_b / h_bb
    return float(a_), float(b_)


class PSVMModel(Model):
    algo = "psvm"

    def decision(self, frame: Frame) -> torch.Tensor:
        """(rows,) decision values ``phi(x) beta + b``."""
        out, dev = self.output, self.device
        X = expand_for_scoring(frame, out["expansion_spec"], dev)
        W = torch.from_numpy(np.asarray(out["rff_w"], np.float32)).to(dev)
        b = torch.from_numpy(np.asarray(out["rff_b"], np.float32)).to(dev)
        beta = torch.from_numpy(np.asarray(out["beta"], np.float32)).to(dev)
        return fourier_features(X, W, b) @ beta[:-1] + beta[-1]

    def predict_raw(self, frame: Frame) -> torch.Tensor:
        """(rows, 3) [label, p0, p1] on the model's device."""
        out = self.output
        fdec = self.decision(frame)
        p1 = torch.sigmoid(_f32(out["platt_a"], fdec.device) * fdec +
                           _f32(out["platt_b"], fdec.device))
        label = (fdec >= 0).to(torch.float32)
        return torch.stack([label, 1 - p1, p1], dim=1)


def psvm_from_jax_output(output: Dict, params: Dict,
                         device: DeviceLike = None) -> PSVMModel:
    """The port's ``PSVMModel`` from an ``h2o_tpu`` PSVM's output dict
    (arrays as numpy); ``params`` gives ``response_column``."""
    out = dict(x=list(output["x"]),
               beta=np.array(output["beta"], np.float32),
               rff_w=np.array(output["rff_w"], np.float32),
               rff_b=np.array(output["rff_b"], np.float32),
               gamma=float(output["gamma"]),
               feature_dim=int(output["feature_dim"]),
               platt_a=float(output["platt_a"]),
               platt_b=float(output["platt_b"]),
               response_domain=list(output["response_domain"]),
               svs_count=int(output["svs_count"]),
               expansion_spec=dict(output["expansion_spec"]))
    if output.get("warnings"):
        out["warnings"] = list(output["warnings"])
    return PSVMModel(dict(params), out, cloud(device))


class PSVM(ModelBuilder):
    algo = "psvm"
    model_cls = PSVMModel

    ENGINE_FIXED = {"kernel_type": ("gaussian",)}

    def default_params(self) -> Dict:
        p = super().default_params()
        p.update(hyper_param=1.0, kernel_type="gaussian", gamma=-1.0,
                 rank_ratio=-1.0, positive_weight=1.0, negative_weight=1.0,
                 max_iterations=200, feature_dim=256)
        return p

    def _fit(self, x: List[str], y: str, train: Frame,
             valid: Optional[Frame] = None, step_hook=None) -> PSVMModel:
        self.refuse_iteration_checkpoints()
        p = self.params
        dev = self.device
        warnings.warn(ENGINE_NOTE)
        di = DataInfo(train, x, y, dev, mode="expanded", standardize=True,
                      weights=p.get("weights_column"), impute_missing=True)
        if di.nclasses != 2:
            raise ValueError("PSVM requires a binary response")
        X = di.matrix()
        P = X.shape[1]
        gamma = float(p["gamma"])
        if gamma <= 0:
            gamma = 1.0 / max(P, 1)
        D = int(p.get("feature_dim") or 256)
        rr = float(p.get("rank_ratio") or -1.0)
        if rr > 0:
            D = max(16, int(rr * train.nrows))
        kw, kb = prng.split(self.rng_key())
        # RFF for exp(-gamma ||x-y||^2): w ~ N(0, 2 gamma I)
        W = prng.normal(kw, (P, D), dev) * torch.sqrt(_f32(2.0 * gamma, dev))
        b = prng.uniform(kb, (D,), dev, 0.0, 2 * np.pi)
        Z = fourier_features(X, W, b)

        yv = di.response()
        ysign = torch.where(torch.nan_to_num(yv) > 0, 1.0, -1.0)
        cls_w = torch.where(ysign > 0, float(np.float32(p["positive_weight"])),
                            float(np.float32(p["negative_weight"])))
        w = di.weights() * cls_w
        self._update(0.2, f"primal SVM on {D} Fourier features")
        beta = svm_fit(Z, ysign, w, di.valid_mask(), float(p["hyper_param"]),
                       int(p["max_iterations"]),
                       statpack.padded_rows(train.nrows, statpack.ROW_QUANTUM),
                       step_hook)

        fdec = (Z @ beta[:-1] + beta[-1]).cpu().numpy()
        yy = ysign.cpu().numpy() > 0
        a_, b_ = platt(fdec, yy)
        out = dict(x=list(di.x), beta=beta.cpu().numpy(),
                   rff_w=W.cpu().numpy(), rff_b=b.cpu().numpy(),
                   gamma=gamma, feature_dim=D, platt_a=a_, platt_b=b_,
                   response_domain=di.response_domain,
                   svs_count=int(np.sum(np.abs(1 - yy * fdec) < 1)),
                   expansion_spec=expansion_spec(di))
        model = self.model_cls(dict(p, response_column=y), out, dev)
        out["training_metrics"] = model.model_metrics(train)
        if valid is not None:
            out["validation_metrics"] = model.model_metrics(valid)
        return model
