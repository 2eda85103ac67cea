"""SVD — port of ``h2o_tpu/models/svd.py`` (``_gram`` :29-33,
``_randomized_range`` :36-54, ``SVDModel`` :57-77, ``SVD`` :80-141).

GramSVD and Power share one path, as in the reference: the Gram X'X of
the expanded matrix (one ``torch.matmul`` on the model's device) and its
eigendecomposition on the host (``ops/linalg.eigh_desc``), d the roots
of the largest ``nv`` eigenvalues.  Randomized is Halko's subspace
iteration: Omega drawn as ``jax.random.normal(key, (P, nv))`` does
(``ops/prng.normal``, bitwise), the (rows, P) products X'(X Q) on the
device, each (P, nv) sketch's QR and the projected (nv, nv) Gram's
eigendecomposition on the host (``ops/linalg``: LAPACK's routines, the
reference's bits), ``min(max_iterations, 10)`` power iterations.

``keep_u`` (on by default) writes U = X V / d, published in
``store.dkv()`` as ``svd_u_<model_id>`` under ``output["u_key"]``, as the
reference's (``:135-137``), and kept on the model as
``output["u_frame"]``.  Scores (``SVD1..SVDnv``) are the expanded rows times V.
``recovery_dir`` snapshots the build (``models/model.py``), as the
reference's does; no iteration checkpoint.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.core.frame import Frame, Vec
from h2o_tpu_torch.models import metrics as mm
from h2o_tpu_torch.models.glm import expand_for_scoring, expansion_spec
from h2o_tpu_torch.models.model import Model, ModelBuilder, publish
from h2o_tpu_torch.models.pca import (TRANSFORMS, decomposition_matrix,
                                      gram, scores_frame)
from h2o_tpu_torch.ops import prng
from h2o_tpu_torch.ops.linalg import eigh_desc, qr_q

EPS = 1e-10


def randomized_range(X: torch.Tensor, key, k: int, iters: int):
    """Halko's randomized subspace iteration on X's device: the (P, k)
    orthonormal V spanning the top right-singular subspace and the
    projected Gram's eigenvalues (largest first, clamped at 0), as
    float32 host arrays."""
    dev = X.device

    def xtx(Q: np.ndarray) -> torch.Tensor:
        Qd = torch.from_numpy(Q).to(dev)
        return X.T @ (X @ Qd)

    om = prng.normal(key, (X.shape[1], k), dev)
    Q = qr_q(X.T @ (X @ om))
    for _ in range(iters):
        Q = qr_q(xtx(Q))
    B = torch.from_numpy(Q).to(dev).T @ xtx(Q)
    evals, W = eigh_desc(B)
    return Q @ W, evals


class SVDModel(Model):
    algo = "svd"

    def predict_raw(self, frame: Frame) -> torch.Tensor:
        """Rows projected onto the right singular vectors (U D)."""
        X = expand_for_scoring(frame, self.output["expansion_spec"],
                               self.device)
        return X @ torch.from_numpy(np.asarray(self.output["v"],
                                               np.float32)).to(self.device)

    def predict(self, frame: Frame) -> Frame:
        return scores_frame(self.predict_raw(frame), "SVD")

    def model_metrics(self, frame: Frame = None) -> mm.ModelMetrics:
        return mm.dimreduction_metrics(d=self.output["d"])


def svd_from_jax_output(output: Dict, params: Dict,
                        device: DeviceLike = None) -> SVDModel:
    """The port's ``SVDModel`` from an ``h2o_tpu`` SVD's output dict
    (arrays as numpy; the reference's DKV U frame is not carried)."""
    out = dict(nv=int(output["nv"]), d=np.array(output["d"], np.float32),
               v=np.array(output["v"], np.float32),
               v_names=list(output["v_names"]),
               expansion_spec=dict(output["expansion_spec"]),
               model_category="DimReduction")
    m = SVDModel(dict(params), out, cloud(device))
    out["training_metrics"] = m.model_metrics()
    return m


class SVD(ModelBuilder):
    algo = "svd"
    model_cls = SVDModel
    supervised = False
    supports_cv = False

    ENGINE_FIXED = {
        "svd_method": ("GramSVD", "Power", "Randomized"),
        "transform": TRANSFORMS,
    }

    def default_params(self) -> Dict:
        p = super().default_params()
        p.update(nv=1, transform="NONE", svd_method="GramSVD",
                 max_iterations=100, use_all_factor_levels=True,
                 keep_u=True)
        return p

    def _fit(self, x: List[str], y: Optional[str], train: Frame,
             valid: Optional[Frame] = None) -> SVDModel:
        p = self.params
        dev = self.device
        di, X = decomposition_matrix(train, x, dev,
                                     (p["transform"] or "NONE").upper(),
                                     bool(p["use_all_factor_levels"]))
        nv = min(int(p["nv"]), X.shape[1])
        if self._norm(p["svd_method"] or "GramSVD") in ("gramsvd", "power"):
            # the reference's Power deflates one vector at a time off the
            # same Gram: its eigendecomposition gives the same vectors
            evals, evecs = eigh_desc(gram(X))
            V = evecs[:, :nv]
        else:
            V, evals = randomized_range(X, self.rng_key(), nv,
                                        min(int(p["max_iterations"]), 10))
            V = V[:, :nv]
        d = np.sqrt(evals[:nv])
        out = dict(nv=nv, d=d, v=np.ascontiguousarray(V), v_names=
                   di.expanded_names, expansion_spec=expansion_spec(di),
                   model_category="DimReduction")
        model = self.model_cls(dict(p), out, dev)
        if p.get("keep_u", True):
            Vd = torch.from_numpy(out["v"]).to(dev)
            dd = torch.from_numpy(np.maximum(d, np.float32(EPS))).to(dev)
            U = ((X @ Vd) / dd[None, :]).cpu().numpy()
            uf = Frame([f"u{i + 1}" for i in range(nv)],
                       [Vec(U[:, i]) for i in range(nv)],
                       key=f"svd_u_{model.key}")
            publish(uf.key, uf)
            out.update(u_frame=uf, u_key=str(uf.key))
        out["training_metrics"] = model.model_metrics()
        self._update(1.0)
        return model
