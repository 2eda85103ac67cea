"""XGBoost — port of ``h2o_tpu/models/tree/xgboost.py`` (``_PARAM_MAP``,
``_XGB_DEFAULTS``, ``XGBoostLinearModel`` :68-84, ``ENGINE_FIXED`` and the
``reg_alpha`` guard :87-124, ``booster="gblinear"`` :136-158,
``booster="dart"`` :162-295).

The builder is GBM's histogram engine under XGBoost's names: eta ->
learn_rate, subsample -> sample_rate, colsample_bytree ->
col_sample_rate_per_tree, colsample_bylevel -> col_sample_rate,
min_child_weight -> min_rows, max_bins -> nbins, min_split_loss (gamma)
-> min_split_improvement; ``reg_lambda`` enters the Newton denominator
and ``force_newton`` gives Newton leaf values for every objective.  On
the card every level's histogram is one launch of the UniformAdaptive
kernel (max_bins 256 over a 1024-bin fine grid).

Boosters:

- ``gbtree`` — GBM's forest loop, with its validation frame, scoring
  interval, early stopping and checkpoints;
- ``dart`` — one single-tree GBM fit a round against the running
  ensemble without the dropped trees, passed in through the offset
  path; drops are drawn by numpy's ``default_rng(seed)``, and the new
  tree is scaled by 1/(k+1) and the k dropped ones by k/(k+1)
  (normalize_type "tree").  Every inner fit draws its master key from
  the same seed, so each round's tree is tree 0 of that key's stream, as
  in the reference.  The one-tree fits run with no scoring interval and
  no early stopping, and skip the final metrics (``_train_model``); a
  ``checkpoint`` raises, as in the reference;
- ``gblinear`` — the elastic-net GLM (``models/glm.py``): reg_alpha is
  the L1 and reg_lambda the L2 strength, alpha = a / (a + l) and lambda =
  (a + l) / rows in GLM's per-row convention; binomial, multinomial or
  gaussian by the response; scored as a linear model.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from h2o_tpu_torch.core.device import DeviceLike
from h2o_tpu_torch.core.frame import Frame, Vec
from h2o_tpu_torch.models.glm import GLM, GLMModel
from h2o_tpu_torch.models.tree import shared_tree as st
from h2o_tpu_torch.models.tree.gbm import GBM, GBMModel


class XGBoostModel(GBMModel):
    algo = "xgboost"


class XGBoostLinearModel(GLMModel):
    """booster="gblinear": a GLM, scored by its linear predictor."""
    algo = "xgboost"


_PARAM_MAP = {
    "eta": "learn_rate",
    "learn_rate": "learn_rate",
    "subsample": "sample_rate",
    "sample_rate": "sample_rate",
    "colsample_bytree": "col_sample_rate_per_tree",
    "col_sample_rate_per_tree": "col_sample_rate_per_tree",
    "colsample_bylevel": "col_sample_rate",
    "col_sample_rate": "col_sample_rate",
    "min_child_weight": "min_rows",
    "min_rows": "min_rows",
    "max_bins": "nbins",
    "min_split_loss": "min_split_improvement",
    "gamma": "min_split_improvement",
}

_XGB_DEFAULTS = dict(
    ntrees=50, max_depth=6, eta=0.3, subsample=1.0, colsample_bytree=1.0,
    colsample_bylevel=1.0, min_child_weight=1.0, max_bins=256,
    reg_lambda=1.0, reg_alpha=0.0, min_split_loss=0.0,
    tree_method="hist", booster="gbtree", grow_policy="depthwise",
    backend="auto", force_newton=True,
    rate_drop=0.0, skip_drop=0.0, sample_type="uniform",
    normalize_type="tree")

_DART_OFFSET = "__dart_offset__"


class XGBoost(GBM):
    algo = "xgboost"
    model_cls = XGBoostModel

    ENGINE_FIXED = {
        **GBM.ENGINE_FIXED,
        "tree_method": ("auto", "hist"),    # this engine is hist
        "grow_policy": ("depthwise",),
        "booster": ("gbtree", "dart", "gblinear"),
        "sample_type": ("uniform",),
        "normalize_type": ("tree",),
    }

    def default_params(self) -> Dict:
        p = super().default_params()
        p.update(_XGB_DEFAULTS)
        # GBM defaults that differ under XGBoost naming
        p["learn_rate"] = 0.3
        p["min_rows"] = 1.0
        p["nbins"] = 256
        return p

    def __init__(self, device: DeviceLike = None, **params):
        super().__init__(device, **params)
        # xgboost names onto the engine's (explicit user values win over
        # both defaults)
        for xgb_name, engine_name in _PARAM_MAP.items():
            if xgb_name in params and xgb_name != engine_name:
                self.params[engine_name] = params[xgb_name]
        booster = self.params.get("booster", "gbtree")
        if booster != "gblinear" and float(
                self.params.get("reg_alpha") or 0.0) != 0.0:
            raise ValueError(
                "reg_alpha (L1 leaf regularization) is only honored by "
                "booster='gblinear' on this engine; refusing to train "
                "with a silently-ignored setting")

    def _fit(self, x: List[str], y: str, train: Frame,
             valid: Optional[Frame] = None) -> XGBoostModel:
        booster = self.params.get("booster", "gbtree")
        if booster == "gblinear":
            return self._fit_gblinear(x, y, train, valid)
        if booster == "dart":
            model = self._fit_dart(x, y, train)
        else:
            model = self._train_model(x, y, train, valid)
        model.output["training_metrics"] = model.model_metrics(train)
        if valid is not None:
            model.output["validation_metrics"] = model.model_metrics(valid)
        return model

    def _fit_gblinear(self, x: List[str], y: str, train: Frame,
                      valid: Optional[Frame]) -> XGBoostLinearModel:
        """gblinear as GLM's elastic net: reg_alpha -> L1, reg_lambda ->
        L2 (alpha = a / (a + l), lambda = (a + l) / rows)."""
        a = float(self.params.get("reg_alpha") or 0.0)
        l2 = float(self.params.get("reg_lambda") or 0.0)
        tot = a + l2
        yv = train.vec(y)
        fam = "binomial" if yv.is_categorical and \
            len(yv.domain or []) == 2 else \
            ("multinomial" if yv.is_categorical else "gaussian")
        g = GLM(device=self.device, family=fam,
                alpha=(a / tot) if tot > 0 else 0.0,
                lambda_=tot / max(train.nrows, 1),
                seed=self.params.get("seed", -1))
        g.model_cls = XGBoostLinearModel
        m = g._fit(x, y, train, valid)
        m.params.update(booster="gblinear", reg_alpha=a, reg_lambda=l2)
        return m

    def _fit_dart(self, x: List[str], y: str, train: Frame) -> XGBoostModel:
        """DART: each round drops a random subset of the earlier trees,
        fits one tree against the rest through the offset path (F0 = f0
        + offset is the ensemble without the dropped trees; f0 depends
        only on the response, the weights and the distribution, so every
        round shares it) and rescales."""
        yv = train.vec(y)
        if yv.is_categorical and len(yv.domain or []) > 2:
            raise ValueError(
                "booster='dart' supports regression/binomial on this "
                "engine (multinomial K>1 has no offset path); use "
                "booster='gbtree' for multinomial")
        if self.params.get("offset_column"):
            raise ValueError("booster='dart' uses the offset path "
                             "internally; offset_column is unsupported")
        if self.params.get("checkpoint"):
            raise ValueError("booster='dart' does not support checkpoint "
                             "resume (per-tree weights are rescaled "
                             "during training)")
        p_all = dict(self.params)
        ntrees = int(p_all["ntrees"])
        rate_drop = float(p_all.get("rate_drop") or 0.0)
        skip_drop = float(p_all.get("skip_drop") or 0.0)
        seed = int(p_all.get("seed") or -1)
        rng = np.random.default_rng(seed if seed >= 0 else None)
        R = train.nrows
        fits: List[Dict] = []
        preds: List[np.ndarray] = []
        scale: List[float] = []
        bins = None
        # one-tree fits: no scoring interval and no early stopping
        self.params.update(ntrees=1, offset_column=_DART_OFFSET,
                           score_tree_interval=0, stopping_rounds=0)
        try:
            for t in range(ntrees):
                k_idx = np.array([], np.int64)
                if t > 0 and rate_drop > 0 and rng.uniform() >= skip_drop:
                    k_idx = np.flatnonzero(rng.uniform(size=t) < rate_drop)
                dropped = set(k_idx.tolist())
                off = np.zeros(R, np.float32)
                for i in range(t):
                    if i not in dropped:
                        off += preds[i] * np.float32(scale[i])
                work = Frame(list(train.names) + [_DART_OFFSET],
                             list(train.vecs) + [Vec(off)])
                out = self._train_model(x, y, work).output
                if bins is None:
                    bins = st.bin_matrix(
                        train.as_matrix(out["x"], self.device),
                        out["split_points"], out["is_cat"],
                        st.model_fine_na(out))
                Fnew = st.forest_score_out(bins, out)[:, 0].cpu().numpy()
                vl = out["value"]
                k = len(k_idx)
                if k:
                    # normalize_type "tree": the new tree 1/(k+1), the
                    # dropped trees k/(k+1) of their current weight
                    vl = vl / (k + 1)
                    Fnew = Fnew / (k + 1)
                    for i in k_idx:
                        scale[i] *= k / (k + 1)
                fits.append(dict(out, value=vl))
                preds.append(Fnew)
                scale.append(1.0)
                self._update(0.05 + 0.9 * (t + 1) / ntrees,
                             f"dart tree {t + 1}/{ntrees} (dropped {k})")
        finally:
            self.params = p_all
        out = dict(fits[0])
        for name in ("split_col", "bitset", "thr_bin", "na_left", "child",
                     "node_w"):
            out[name] = None if fits[0][name] is None else \
                np.concatenate([f[name] for f in fits])
        # dart rescales leaf values, not the routing: the covers stand,
        # the gains do not (as in the reference)
        out["node_gain"] = None
        out["value"] = np.concatenate(
            [f["value"] * np.float32(s) for f, s in zip(fits, scale)])
        out["ntrees_actual"] = ntrees
        return self.model_cls(dict(p_all), out, self.device)

