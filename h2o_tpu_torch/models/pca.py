"""PCA — port of ``h2o_tpu/models/pca.py`` (``_gram`` :28-32,
``PCAModel`` :35-57, ``PCA`` :60-105).

The GramSVD method: the expanded matrix (categoricals one-hot, numerics
mean-imputed; standardized or demeaned by ``transform``) is reduced to
its Gram X'X by one ``torch.matmul`` on the model's device, divided by
n - 1, and factored on the host (``ops/linalg.eigh_desc``: LAPACK's
float32 ``evd`` driver, whose eigenvector signs are the reference's).
``DEMEAN`` subtracts the column sums over the rows divided by the row
count: the port's frames hold no padded rows, so the reference's
rescaled padded mean is this mean.  Scores are the expanded rows times
the eigenvectors (``PC1..PCk``).  ``transform`` values other than NONE,
STANDARDIZE and DEMEAN, which the reference treats as NONE, are refused,
as are iteration checkpoints (``recovery_dir``, P14).
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
from h2o_tpu_torch.ops.linalg import eigh_desc

EPS = 1e-10
#: the transforms the decompositions implement
TRANSFORMS = ("NONE", "STANDARDIZE", "DEMEAN")


def decomposition_matrix(train: Frame, x: List[str], dev: torch.device,
                         transform: str, use_all_factor_levels: bool):
    """(DataInfo, the expanded matrix on ``dev``) of PCA and SVD: mean
    imputation, standardized with STANDARDIZE, column means subtracted
    with DEMEAN."""
    di = DataInfo(train, x, None, dev, mode="expanded",
                  standardize=(transform == "STANDARDIZE"),
                  use_all_factor_levels=use_all_factor_levels,
                  impute_missing=True)
    X = di.matrix()
    if transform == "DEMEAN":
        n = torch.full((1,), float(max(train.nrows, 1)), device=dev)
        X = X - (torch.sum(X, dim=0) / n)[None, :]
    return di, X


def gram(X: torch.Tensor) -> torch.Tensor:
    """X'X on X's device."""
    return X.T @ X


def scores_frame(scores: torch.Tensor, prefix: str) -> Frame:
    s = scores.detach().cpu().numpy()
    return Frame([f"{prefix}{i + 1}" for i in range(s.shape[1])],
                 [Vec(s[:, i]) for i in range(s.shape[1])])


class PCAModel(Model):
    algo = "pca"

    def predict_raw(self, frame: Frame) -> torch.Tensor:
        """(rows, k) principal-component scores on the model's device."""
        X = expand_for_scoring(frame, self.output["expansion_spec"],
                               self.device)
        return X @ torch.from_numpy(np.asarray(
            self.output["eigenvectors"], np.float32)).to(self.device)

    def predict(self, frame: Frame) -> Frame:
        return scores_frame(self.predict_raw(frame), "PC")

    def model_metrics(self, frame: Frame = None) -> mm.ModelMetrics:
        return mm.dimreduction_metrics(
            std_deviation=self.output["std_deviation"],
            pct_variance=self.output["pct_variance"])


def pca_from_jax_output(output: Dict, params: Dict,
                        device: DeviceLike = None) -> PCAModel:
    """The port's ``PCAModel`` from an ``h2o_tpu`` PCA's output dict
    (arrays as numpy)."""
    out = dict(k=int(output["k"]),
               eigenvectors=np.array(output["eigenvectors"], np.float32),
               std_deviation=np.array(output["std_deviation"], np.float32),
               pct_variance=np.array(output["pct_variance"], np.float32),
               cum_variance=np.array(output["cum_variance"], np.float32),
               expansion_spec=dict(output["expansion_spec"]),
               coef_names=list(output["coef_names"]),
               model_category="DimReduction")
    m = PCAModel(dict(params), out, cloud(device))
    out["training_metrics"] = m.model_metrics()
    return m


class PCA(ModelBuilder):
    algo = "pca"
    model_cls = PCAModel
    supervised = False
    supports_cv = False

    ENGINE_FIXED = {
        # one method: the full Gram and its eigendecomposition
        "pca_method": ("AUTO", "GramSVD"),
        "transform": TRANSFORMS,
    }

    def default_params(self) -> Dict:
        p = super().default_params()
        p.update(k=1, transform="NONE", pca_method="GramSVD",
                 use_all_factor_levels=False, compute_metrics=True)
        return p

    def _fit(self, x: List[str], y: Optional[str], train: Frame,
             valid: Optional[Frame] = None) -> PCAModel:
        self.refuse_iteration_checkpoints()
        p = self.params
        di, X = decomposition_matrix(train, x, self.device,
                                     (p["transform"] or "NONE").upper(),
                                     bool(p["use_all_factor_levels"]))
        G = gram(X)
        G = G / torch.full_like(G, float(max(train.nrows - 1, 1)))
        evals, evecs = eigh_desc(G)
        k = min(int(p["k"]), X.shape[1])
        tot = max(float(np.sum(evals)), EPS)
        out = dict(k=k, eigenvectors=evecs[:, :k],
                   std_deviation=np.sqrt(evals)[:k],
                   pct_variance=evals[:k] / tot,
                   cum_variance=np.cumsum(evals[:k]) / tot,
                   expansion_spec=expansion_spec(di),
                   coef_names=di.expanded_names,
                   model_category="DimReduction")
        model = self.model_cls(dict(p), out, self.device)
        out["training_metrics"] = model.model_metrics()
        self._update(1.0)
        return model
