"""Isolation Forest and Extended Isolation Forest — port of
``h2o_tpu/models/tree/isofor.py`` (``avg_path_length`` :41-46,
``_build_if_trees`` :54-103, ``_if_path_lengths`` :106-128,
``AnomalyModel``, ``IsolationForestModel`` and ``IsolationForest``
:131-220; ``_build_eif_trees`` :227-293, ``_eif_mean_path`` :296-312,
``ExtendedIsolationForestModel`` and ``ExtendedIsolationForest``
:315-367).  Reference hex/tree/isofor/IsolationForest.java and
hex/tree/isoforextended/ExtendedIsolationForest.java.

Each tree draws ``sample_size`` rows without replacement
(``prng.choice``, jax's sort-based shuffle bit for bit) and grows a
depth-D heap on that sample alone, so no histogram is built and no
hand-written kernel runs: a level is a masked min/max over an (S, L, C)
view of the sample, a random draw per leaf and a routing step.

- IsolationForest: a leaf splits a uniformly chosen column whose values
  it does not hold constant at ``lo + u * (hi - lo)``; a row's score is
  its total path length over the trees, normalised against the training
  frame's min and max total ``(max - len) / (max - min)``; predictions
  are [predict, mean_length].  Scoring descends raw floats (``x <
  thresh``; NaN goes right).  The training metrics come from the path
  lengths training already computed: the frame is not scored twice.
- ExtendedIsolationForest: a random hyperplane with ``extension_level +
  1`` non-zero normal coordinates through a uniform point of the leaf's
  box; ``(x - p) . n <= 0`` goes left, and a leaf's value is its depth
  plus ``c(count)``, the average unsuccessful-search path length of a
  BST of that many rows.  The score is ``2^(-E[h] / c(sample_size))``;
  predictions are [anomaly_score, mean_length].

Exactness against the reference: the draws (``prng.normal`` included),
the masked min/max, the column choice and the routing are exact.  XLA
compiles ``lo + u * (hi - lo)`` (and EIF's ``vmin + u * span``) on the
CPU to one fused multiply-add, which the port takes in float64 and
rounds once; ``c(n)`` takes XLA's ``log`` and the mean path XLA's
multiply by the reciprocal of the tree count (``ops/xlamath.py``).  So
IsolationForest thresholds, path lengths and scores, and EIF normals,
points, values and mean path lengths equal the reference's.  Two float
differences remain: the order of the float32 sum of EIF's projection
``(x - p) . n`` over more than one non-zero coordinate (a row whose
projection lies within rounding of 0 may route differently), and
torch's ``2^x`` in the EIF score.

The trees of a forest are independent; they are grown one after the
other, each from its own key of ``prng.split(master, ntrees)``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from h2o_tpu_torch.core.frame import Frame, Vec
from h2o_tpu_torch.models import metrics as mm
from h2o_tpu_torch.models.model import DataInfo, Model, ModelBuilder
from h2o_tpu_torch.models.tree.shared_tree import check_slice
from h2o_tpu_torch.ops import prng
from h2o_tpu_torch.ops import xlamath as xm

EULER = 0.5772156649015329


def avg_path_length(n) -> torch.Tensor:
    """c(n) in float32: the average unsuccessful-search path length of a
    BST of n nodes (0 for n < 2, 1 for n = 2)."""
    n = torch.as_tensor(n).to(torch.float32)
    h = xm.log(torch.clamp_min(n - 1.0, 1.0)) + EULER
    c = 2.0 * h - 2.0 * (n - 1.0) / torch.clamp_min(n, 1.0)
    one, zero = torch.ones_like(n), torch.zeros_like(n)
    return torch.where(n > 2.0, c, torch.where(n == 2.0, one, zero))


def _level_boxes(Xs: torch.Tensor, leaf: torch.Tensor, alive: torch.Tensor,
                 L: int):
    """Per-leaf row counts (L,) and per-(leaf, column) min and max (L, C)
    of the sample's non-NaN values: +inf / -inf where a leaf holds none."""
    hot = (leaf[:, None] == torch.arange(L, device=Xs.device)[None, :]) & \
        alive[:, None]                                   # (S, L)
    cnt = hot.sum(dim=0)
    ok = hot[:, :, None] & ~torch.isnan(Xs)[:, None, :]  # (S, L, C)
    xv = Xs[:, None, :]
    inf = torch.tensor(float("inf"), device=Xs.device)
    vmin = torch.where(ok, xv, inf).amin(dim=0)
    vmax = torch.where(ok, xv, -inf).amax(dim=0)
    return cnt, vmin, vmax


def _sample(X: torch.Tensor, key, S: int, nrows: int):
    k_samp, k_tree = prng.split(key)
    return X[prng.choice(k_samp, nrows, S, X.device)], k_tree


def _full(like: torch.Tensor, v: float) -> torch.Tensor:
    """``v`` as a tensor like ``like``: a true division by it on every
    device (CUDA multiplies by the reciprocal of a Python-number
    divisor)."""
    return torch.full_like(like, float(v))


def _route(leaf, alive, go_left, can):
    nxt = 2 * leaf + torch.where(go_left, 0, 1)
    splits = can[leaf]
    return torch.where(alive & splits, nxt, leaf), alive & splits


# -- axis-parallel Isolation Forest -------------------------------------------

def build_if_trees(X: torch.Tensor, keys, S: int, D: int, nrows: int):
    """Per tree (one key each): sample S rows and grow a depth-D heap of
    uniform-random axis-parallel splits.  (T, H) split columns (-1 =
    leaf) and thresholds, H = 2^(D+1) - 1."""
    dev = X.device
    H = 2 ** (D + 1) - 1
    C = X.shape[1]
    cols, threshs = [], []
    for key in keys:
        Xs, k_tree = _sample(X, key, S, nrows)
        split_col = torch.full((H,), -1, dtype=torch.int32, device=dev)
        thresh = torch.zeros(H, dtype=torch.float32, device=dev)
        leaf = torch.zeros(S, dtype=torch.long, device=dev)
        alive = torch.ones(S, dtype=torch.bool, device=dev)
        rows = torch.arange(S, device=dev)
        for d in range(D):
            L = 2 ** d
            off = L - 1
            k_tree, kc, kt = prng.split(k_tree, 3)
            cnt, vmin, vmax = _level_boxes(Xs, leaf, alive, L)
            valid = (vmax > vmin) & torch.isfinite(vmin)       # (L, C)
            can = (cnt > 1) & valid.any(dim=1)
            r = prng.uniform(kc, (L, C), dev)
            col = torch.argmax(torch.where(valid, r, torch.full_like(r, -1.0)),
                               dim=1)
            li = torch.arange(L, device=dev)
            lo, hi = vmin[li, col], vmax[li, col]
            u = prng.uniform(kt, (L,), dev)
            th = xm.fma(u, hi - lo, lo)
            split_col[off:off + L] = torch.where(can, col.to(torch.int32),
                                                 -1)
            thresh[off:off + L] = torch.nan_to_num(th)
            # x < thresh goes left (NaN compares false: right)
            xv = Xs[rows, col[leaf].clamp(0, C - 1)]
            leaf, alive = _route(leaf, alive, xv < th[leaf], can)
        cols.append(split_col)
        threshs.append(thresh)
    return torch.stack(cols), torch.stack(threshs)


def if_path_lengths(X: torch.Tensor, split_col: torch.Tensor,
                    thresh: torch.Tensor, D: int) -> torch.Tensor:
    """(R,) int32 total path length over the trees: each tree adds the
    depth of the leaf a row reaches."""
    R, C = X.shape
    total = torch.zeros(R, dtype=torch.int32, device=X.device)
    for sc, th in zip(split_col, thresh):
        node = torch.zeros(R, dtype=torch.long, device=X.device)
        depth = torch.zeros(R, dtype=torch.int32, device=X.device)
        for _ in range(D):
            c = sc[node]
            term = c < 0
            xv = torch.gather(X, 1, c.clamp(0, C - 1).long()[:, None])[:, 0]
            nxt = 2 * node + torch.where(xv < th[node], 1, 2)
            node = torch.where(term, node, nxt)
            depth = depth + (~term).to(torch.int32)
        total = total + depth
    return total


class AnomalyModel(Model):
    """The anomaly models' surface: two prediction columns, anomaly
    metrics (``mean_score``, ``mean_length``)."""

    pred_names = ("predict", "mean_length")

    def predict(self, frame: Frame) -> Frame:
        raw = self.predict_raw(frame).cpu().numpy()
        return Frame(list(self.pred_names), [Vec(raw[:, 0]), Vec(raw[:, 1])])

    def model_metrics(self, frame: Frame) -> mm.ModelMetrics:
        return mm.anomaly_metrics(self.predict_raw(frame).cpu().numpy())


class IsolationForestModel(AnomalyModel):
    algo = "isolationforest"

    def _total_path(self, frame: Frame) -> torch.Tensor:
        out = self.output
        return if_path_lengths(
            frame.as_matrix(out["x"], self.device),
            torch.tensor(np.asarray(out["split_col"]), device=self.device),
            torch.tensor(np.asarray(out["thresh"]), device=self.device),
            int(out["max_depth"]))

    def predict_raw(self, frame: Frame) -> torch.Tensor:
        """(rows, 2) float32 [normalised score, mean path length]."""
        out = self.output
        total = self._total_path(frame).to(torch.float32)
        lo, hi = float(out["min_path_length"]), float(out["max_path_length"])
        score = (hi - total) / _full(total, hi - lo) if hi > lo else \
            torch.ones_like(total)
        mean_len = total / _full(total, max(int(out["ntrees_actual"]), 1))
        return torch.stack([score, mean_len], dim=1)


class IsolationForest(ModelBuilder):
    algo = "isolationforest"
    model_cls = IsolationForestModel
    supervised = False
    supports_cv = False
    ENGINE_FIXED = {"mtries": (-1, -2), "contamination": (-1.0,)}

    def default_params(self) -> Dict:
        p = super().default_params()
        p.update(ntrees=50, max_depth=8, sample_size=256, sample_rate=-1.0,
                 mtries=-1, contamination=-1.0,
                 score_each_iteration=False, score_tree_interval=0,
                 stopping_rounds=0, stopping_metric="AUTO",
                 stopping_tolerance=0.01)
        return p

    def _fit(self, x: List[str], y: Optional[str], train: Frame,
             valid: Optional[Frame] = None) -> IsolationForestModel:
        p = self.params
        check_slice(self.algo, p)
        di = DataInfo(train, x, None, self.device)
        X = di.matrix()
        D, T = int(p["max_depth"]), int(p["ntrees"])
        rate = float(p.get("sample_rate") or -1.0)
        S = int(round(rate * train.nrows)) if rate > 0 else \
            int(p["sample_size"])
        S = max(2, min(S, train.nrows))
        self._update(0.1, f"growing {T} isolation trees (sample={S})")
        sc, th = build_if_trees(X, prng.split(self.rng_key(), T), S, D,
                                train.nrows)
        total = if_path_lengths(X, sc, th, D).cpu().numpy()
        lo, hi = int(total.min()), int(total.max())
        out = dict(x=list(di.x), split_col=sc.cpu().numpy(),
                   thresh=th.cpu().numpy(), max_depth=D, ntrees_actual=T,
                   sample_size=S, min_path_length=lo, max_path_length=hi,
                   domains={c: list(train.vec(c).domain)
                            for c in di.cat_names})
        model = self.model_cls(dict(p), out, self.device)
        # training metrics from the path lengths in hand, in float64 on
        # the host as the reference computes them
        score = (hi - total) / (hi - lo) if hi > lo else \
            np.ones_like(total, np.float32)
        model.output["training_metrics"] = mm.anomaly_metrics(
            np.stack([score, total / max(T, 1)], axis=1))
        return model


# -- Extended Isolation Forest (random hyperplanes) ---------------------------

def build_eif_trees(X: torch.Tensor, keys, S: int, D: int, nrows: int,
                    ext: int):
    """Per tree: random-hyperplane splits (``(x - p) . n <= 0`` goes
    left) and leaf values ``depth + c(count)``.  Returns (T, H, C)
    normals and points, (T, H) values, split flags and row counts."""
    dev = X.device
    H = 2 ** (D + 1) - 1
    C = X.shape[1]
    keep_k = min(ext + 1, C)
    trees = []
    for key in keys:
        Xs, k_tree = _sample(X, key, S, nrows)
        Xz = torch.nan_to_num(Xs)
        normals = torch.zeros((H, C), dtype=torch.float32, device=dev)
        points = torch.zeros((H, C), dtype=torch.float32, device=dev)
        value = torch.zeros(H, dtype=torch.float32, device=dev)
        counts = torch.zeros(H, dtype=torch.int32, device=dev)
        is_split = torch.zeros(H, dtype=torch.bool, device=dev)
        leaf = torch.zeros(S, dtype=torch.long, device=dev)
        alive = torch.ones(S, dtype=torch.bool, device=dev)
        rows = torch.arange(S, device=dev)
        for d in range(D):
            L = 2 ** d
            off = L - 1
            k_tree, kn, kz, kp = prng.split(k_tree, 4)
            cnt, vmin, vmax = _level_boxes(Xs, leaf, alive, L)
            span = torch.where(torch.isfinite(vmin), vmax - vmin,
                               torch.zeros_like(vmin))
            can = (cnt > 1) & (span > 0).any(dim=1)
            # a normal with ext + 1 non-zero coordinates (EIF paper)
            nvec = prng.normal(kn, (L, C), dev)
            r = prng.uniform(kz, (L, C), dev)
            kth = torch.sort(r, dim=1).values[:, keep_k - 1:keep_k]
            nvec = torch.where(r <= kth, nvec, torch.zeros_like(nvec))
            pvec = xm.fma(prng.uniform(kp, (L, C), dev), span.clamp_min(0.0),
                        vmin)
            normals[off:off + L] = nvec
            points[off:off + L] = torch.nan_to_num(pvec)
            value[off:off + L] = d + avg_path_length(cnt)
            counts[off:off + L] = cnt.to(torch.int32)
            is_split[off:off + L] = can
            proj = ((Xz[:, None, :] - pvec[None]) * nvec[None]).sum(dim=2)
            leaf, alive = _route(leaf, alive, proj[rows, leaf] <= 0, can)
        # the last level's leaves: value D + c(count)
        L = 2 ** D
        cnt = ((leaf[:, None] == torch.arange(L, device=dev)[None, :]) &
               alive[:, None]).sum(dim=0)
        value[L - 1:] = D + avg_path_length(cnt)
        counts[L - 1:] = cnt.to(torch.int32)
        trees.append((normals, points, value, is_split, counts))
    return tuple(torch.stack(a) for a in zip(*trees))


def eif_mean_path(X: torch.Tensor, normals, points, value, is_split,
                  D: int) -> torch.Tensor:
    """(R,) mean over the trees of the leaf value each row reaches."""
    R = X.shape[0]
    Xz = torch.nan_to_num(X)
    total = torch.zeros(R, dtype=torch.float32, device=X.device)
    for nv, pv, vl, sp in zip(normals, points, value, is_split):
        node = torch.zeros(R, dtype=torch.long, device=X.device)
        for _ in range(D):
            proj = ((Xz - pv[node]) * nv[node]).sum(dim=1)
            nxt = 2 * node + torch.where(proj <= 0, 1, 2)
            node = torch.where(sp[node], nxt, node)
        total = total + vl[node]
    # XLA turns the division by the (static) tree count into a multiply
    # by its float32 reciprocal
    return total * float(np.float32(1.0) / np.float32(normals.shape[0]))


class ExtendedIsolationForestModel(AnomalyModel):
    algo = "extendedisolationforest"
    pred_names = ("anomaly_score", "mean_length")

    def predict_raw(self, frame: Frame) -> torch.Tensor:
        """(rows, 2) float32 [anomaly score, mean path length]."""
        out = self.output
        dev = self.device

        def t(k):
            return torch.tensor(np.asarray(out[k]), device=dev)

        mean_len = eif_mean_path(frame.as_matrix(out["x"], dev),
                                 t("normals"), t("points"), t("value"),
                                 t("is_split"), int(out["max_depth"]))
        cn = float(avg_path_length(int(out["sample_size"])))
        score = torch.pow(2.0, -mean_len / _full(mean_len, max(cn, 1e-12)))
        return torch.stack([score, mean_len], dim=1)


class ExtendedIsolationForest(ModelBuilder):
    algo = "extendedisolationforest"
    model_cls = ExtendedIsolationForestModel
    supervised = False
    supports_cv = False

    def default_params(self) -> Dict:
        p = super().default_params()
        p.update(ntrees=100, sample_size=256, extension_level=0,
                 score_each_iteration=False, score_tree_interval=0)
        return p

    def _fit(self, x: List[str], y: Optional[str], train: Frame,
             valid: Optional[Frame] = None) -> ExtendedIsolationForestModel:
        p = self.params
        check_slice(self.algo, p)
        di = DataInfo(train, x, None, self.device)
        X = di.matrix()
        C = len(di.x)
        ext = int(p["extension_level"])
        if not 0 <= ext <= C - 1:
            raise ValueError(
                f"extension_level must be in [0, {C - 1}], got {ext}")
        S = max(2, min(int(p["sample_size"]), train.nrows))
        D = max(1, int(np.ceil(np.log2(S))))
        T = int(p["ntrees"])
        self._update(0.1, f"growing {T} extended isolation trees")
        normals, points, value, is_split, counts = build_eif_trees(
            X, prng.split(self.rng_key(), T), S, D, train.nrows, ext)

        def host(a):
            return a.cpu().numpy()

        out = dict(x=list(di.x), normals=host(normals), points=host(points),
                   value=host(value), is_split=host(is_split),
                   counts=host(counts), max_depth=D, ntrees_actual=T,
                   sample_size=S,
                   domains={c: list(train.vec(c).domain)
                            for c in di.cat_names})
        model = self.model_cls(dict(p), out, self.device)
        model.output["training_metrics"] = model.model_metrics(train)
        return model
