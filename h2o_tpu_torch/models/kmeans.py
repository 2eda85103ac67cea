"""KMeans — port of ``h2o_tpu/models/kmeans.py`` (``_lloyd_step`` :32-50,
``_min_dist2`` :53-58, ``KMeansModel`` :61-100, ``KMeans`` :103-174).

Lloyd's iterations on the expanded matrix (categoricals one-hot over
every level, numerics mean-imputed and, by default, standardized), on
the model's device: the assignment is the ``|x|^2 - 2 x C' + |c|^2``
GEMM, the new centers a one-hot GEMM, as in the reference.  No
histogram kernel: KMeans reaches no Pallas kernel in the reference
either.

Initialisation draws as jax does (``ops/prng.py``): the first center is
row ``randint(key, (), 0, nrows)``, then each next one is the row of
largest D^2 (``"Furthest"``, the first on ties) or a row drawn with
probability proportional to D^2 (every other ``init``, ``"Random"``
included, as the reference does) by ``choice(sub, n, p=...)`` over the
reference's padded row count (``statpack.padded_rows``: padded rows
have D^2 = 0 there).  Iterations stop when no center coordinate moves
by 1e-5 (float32), after ``max_iterations`` at most.

The training metrics are the last Lloyd step's (the withinss of the
assignments to the centers before its update, as the reference caches
them); ``model_metrics`` of any frame makes a fresh assignment pass.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.core.frame import Frame
from h2o_tpu_torch.models import metrics as mm
from h2o_tpu_torch.models.glm import expand_for_scoring, expansion_spec
from h2o_tpu_torch.models.model import DataInfo, Model, ModelBuilder
from h2o_tpu_torch.ops import prng, statpack

EPS = 1e-10


def _dist2(X: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(R, k) squared distances by the GEMM identity, unclamped."""
    x2 = torch.sum(X * X, dim=1, keepdim=True)
    c2 = torch.sum(centers * centers, dim=1)[None, :]
    return x2 - 2 * X @ centers.T + c2


def _lloyd_step(X: torch.Tensor, centers: torch.Tensor, k: int):
    """One iteration: (assignments, new centers, counts, within-SS)."""
    d2 = torch.clamp_min(_dist2(X, centers), 0.0)
    best, assign = torch.min(d2, dim=1)
    hotf = (assign[:, None] == torch.arange(k, device=X.device)[None, :]
            ).to(torch.float32)
    sums = hotf.T @ X                                        # (k, P)
    cnts = torch.sum(hotf, dim=0)
    wss = hotf.T @ best
    new_centers = sums / torch.clamp_min(cnts[:, None], EPS)
    # an empty cluster keeps its center
    new_centers = torch.where(cnts[:, None] > 0, new_centers, centers)
    return assign, new_centers, cnts, wss


def _min_dist2(X: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(_dist2(X, centers), 0.0).amin(dim=1)


def _totss(X: torch.Tensor) -> float:
    n = torch.full((1,), float(max(X.shape[0], 1)), device=X.device)
    gmean = torch.sum(X, dim=0) / n
    return float(torch.sum(torch.sum((X - gmean[None, :]) ** 2, dim=1)))


def clustering_data(k: int, wss, cnts, totss: float) -> Dict:
    wss = np.asarray(wss, np.float32)
    tot_w = float(np.float32(wss.sum(dtype=np.float32)))
    return dict(k=int(k), tot_withinss=tot_w, totss=float(totss),
                betweenss=float(totss) - tot_w, withinss=wss.tolist(),
                size=np.asarray(cnts).tolist())


class KMeansModel(Model):
    algo = "kmeans"

    def _expanded(self, frame: Frame) -> torch.Tensor:
        return expand_for_scoring(frame, self.output["expansion_spec"],
                                  self.device)

    def _centers(self) -> torch.Tensor:
        return torch.tensor(np.asarray(self.output["centers_std"],
                                       np.float32), device=self.device)

    def predict_raw(self, frame: Frame) -> torch.Tensor:
        """Each row's cluster, as float32."""
        d2 = _dist2(self._expanded(frame), self._centers())
        return torch.argmin(d2, dim=1).to(torch.float32)

    def model_metrics(self, frame: Frame) -> mm.ModelMetrics:
        """Clustering metrics of ``frame``: one assignment pass to the
        final centers."""
        X = self._expanded(frame)
        k = int(self.output["k"])
        _, _, cnts, wss = _lloyd_step(X, self._centers(), k)
        return mm.clustering_metrics(clustering_data(
            k, wss.cpu().numpy(), cnts.cpu().numpy(), _totss(X)))


def kmeans_from_jax_output(output: Dict, params: Dict,
                           device: DeviceLike = None) -> KMeansModel:
    """The port's ``KMeansModel`` from an ``h2o_tpu`` KMeans's output
    dict (arrays as numpy)."""
    dev = cloud(device)
    out = {k: output[k] for k in ("k", "tot_withinss", "totss",
                                  "iterations", "training_frame_key")
           if k in output}
    out.update(
        centers_std=np.array(output["centers_std"], np.float32),
        centers=np.array(output["centers"], np.float32),
        expansion_spec=dict(output["expansion_spec"]),
        coef_names=list(output["coef_names"]),
        withinss=np.array(output["withinss"], np.float32),
        size=np.array(output["size"], np.float32),
        model_category="Clustering")
    tm = output.get("training_metrics")
    if tm is not None:
        out["training_metrics"] = mm.clustering_metrics(dict(tm.data))
    return KMeansModel(dict(params), out, dev)


class KMeans(ModelBuilder):
    algo = "kmeans"
    model_cls = KMeansModel
    supervised = False
    supports_cv = False

    ENGINE_FIXED = {
        "estimate_k": (False,),           # not implemented: k is explicit
        "categorical_encoding": ("AUTO", "Enum"),
    }

    def default_params(self) -> Dict:
        p = super().default_params()
        p.update(k=1, estimate_k=False, max_iterations=10, init="Furthest",
                 standardize=True, categorical_encoding="AUTO",
                 score_each_iteration=False)
        return p

    def _fit(self, x: List[str], y: Optional[str], train: Frame,
             valid: Optional[Frame] = None) -> KMeansModel:
        p = self.params
        if p.get("recovery_dir") or int(p.get("checkpoint_interval") or 0):
            raise NotImplementedError(
                "kmeans: recovery_dir/checkpoint_interval comes with the "
                "runtime services (P14)")
        dev = self.device
        di = DataInfo(train, x, None, dev, mode="expanded",
                      standardize=bool(p["standardize"]),
                      use_all_factor_levels=True, impute_missing=True)
        X = di.matrix()
        k = int(p["k"])
        key = self.rng_key()
        nrows = train.nrows
        padded = statpack.padded_rows(nrows)

        idx0 = int(prng.randint(key, (), 0, nrows, dev))
        centers = X[idx0][None, :]
        for _ in range(1, k):
            d2 = _min_dist2(X, centers)
            if p["init"] == "Furthest":
                nxt = int(torch.argmax(d2))
            else:
                key, sub = prng.split(key)
                d2p = torch.zeros(padded, dtype=torch.float32, device=dev)
                d2p[:nrows] = d2
                tot = torch.clamp_min(torch.sum(d2p), EPS)
                nxt = int(prng.choice(sub, padded, (), dev, p=d2p / tot))
            centers = torch.cat([centers, X[nxt][None, :]], dim=0)

        max_iter = max(int(p["max_iterations"]), 1)
        for it in range(max_iter):
            _, new_centers, cnts, wss = _lloyd_step(X, centers, k)
            shift = float(torch.max(torch.abs(new_centers - centers)))
            centers = new_centers
            self._update((it + 1) / max_iter, f"iteration {it + 1}")
            if shift < 1e-5:
                break

        spec = expansion_spec(di)
        cst = centers.cpu().numpy()
        cdn = cst.copy()
        ncat = cst.shape[1] - len(spec["num_names"])
        if spec["standardize"]:
            for i, (mean, sd) in enumerate(zip(spec["means"],
                                               spec["sigmas"])):
                cdn[:, ncat + i] = cst[:, ncat + i] * (sd or 1.0) + mean
        wss_np, cnts_np = wss.cpu().numpy(), cnts.cpu().numpy()
        totss = _totss(X)
        data = clustering_data(k, wss_np, cnts_np, totss)
        out = dict(k=k, centers_std=cst, centers=cdn,
                   training_frame_key=str(train.key), expansion_spec=spec,
                   coef_names=di.expanded_names, withinss=wss_np,
                   size=cnts_np, tot_withinss=data["tot_withinss"],
                   totss=totss, iterations=it + 1,
                   model_category="Clustering",
                   training_metrics=mm.clustering_metrics(data))
        return self.model_cls(dict(p), out, dev)
