"""GBM — port of ``h2o_tpu/models/tree/gbm.py`` (``raw_from_F`` :31-47,
``GBMModel`` :50-82, ``GBM`` :85-386 with ``_mono_array`` :114-143 and
``_fit`` :145-386), training through ``driver.run_tree_driver``.

Binning, trees and scoring run on the device given to ``GBM``: ``cuda:0`` by
default, where every histogram goes through the hand-written kernels,
or the CPU when the caller passes ``device="cpu"`` (the plain PyTorch
versions).  Every distribution of ``models/distributions.py``, a
user's ``custom`` one (``custom_distribution_func``, ``core/udf.py``:
its gradient and hessian run on the engine's tensors, f0 is its
``init`` ratio through its link in float64 on the host, and scoring
applies its link by name), multinomial responses (K class trees an iteration), weights
and offset columns, monotone constraints, ``reg_lambda`` and
``force_newton`` (the XGBoost builder's), row and column sampling,
``Random`` histograms, int16/int8 stats and depths beyond the dense
engine's frontier (the sparse-frontier engine, up to depth 30) run as in
the reference, and so do the training loop's options: a validation
frame (binned with the training split points and scored incrementally),
``score_tree_interval``/``score_each_iteration``, early stopping,
``max_runtime_secs`` and ``checkpoint`` (a port model, or a path that
``Model.save`` wrote, continued in its own bin space, distribution and
f0).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np
import torch

from h2o_tpu_torch.core.frame import Frame
from h2o_tpu_torch.models.distributions import (FIRST_ORDER, Distribution,
                                                distribution_from_params)
from h2o_tpu_torch.models.model import DataInfo, Model, ModelBuilder
from h2o_tpu_torch.models.tree import engine
from h2o_tpu_torch.models.tree import shared_tree as st
from h2o_tpu_torch.models.tree.driver import (IncrementalScorer,
                                              check_checkpoint,
                                              checkpoint_bins,
                                              run_tree_driver, scoring_bins,
                                              wants_scoring)
from h2o_tpu_torch.ops import statpack

EPS = 1e-10


def raw_from_F(F: torch.Tensor, dom: Optional[List[str]],
               dist: Distribution, threshold: float = 0.5) -> torch.Tensor:
    """Link-scale forest sum -> raw predictions: regression values
    through ``dist``'s inverse link, [label, p0, p1] for a binomial
    response, [label, p0..pK-1] from the softmax for a multinomial one."""
    if dom is None:
        return dist.link_inv(F[:, 0])
    if len(dom) == 2:
        p1 = torch.sigmoid(F[:, 0])
        label = (p1 >= threshold).to(torch.float32)
        return torch.stack([label, 1 - p1, p1], dim=1)
    P = torch.softmax(F, dim=1)
    label = torch.argmax(P, dim=1).to(torch.float32)
    return torch.cat([label[:, None], P], dim=1)


class GBMModel(Model):
    algo = "gbm"

    def _forest_F(self, m: torch.Tensor) -> torch.Tensor:
        """(rows, C) raw matrix -> link-scale forest sum."""
        out = self.output
        bins = st.bin_matrix(m, out["split_points"], out["is_cat"],
                             st.model_fine_na(out))
        f0 = torch.tensor(np.asarray(out["f0"], np.float32),
                          device=m.device)
        return st.forest_score_out(bins, out) + f0[None, :]

    def _raw_from_F(self, F: torch.Tensor) -> torch.Tensor:
        if self.output.get("distribution_resolved") == "custom" and \
                self.output.get("response_domain") is None:
            from h2o_tpu_torch.core.udf import custom_link_inv
            return custom_link_inv(self.output.get("custom_link"), F[:, 0])
        return raw_from_F(F, self.output.get("response_domain"),
                          self.family(), threshold=float(self.output.get(
                              "default_threshold", 0.5)))

    def predict_raw_array(self, X) -> torch.Tensor:
        """Online fast path (serve/engine.py): a raw (rows, len(x))
        column matrix in ``output['x']`` order (categorical codes, NaN
        NAs), as float32 on the model's device, no Frame."""
        return self._raw_from_F(self._forest_F(torch.as_tensor(
            X, dtype=torch.float32, device=self.device)))

    def predict_raw(self, frame: Frame) -> torch.Tensor:
        F = self._forest_F(frame.as_matrix(self.output["x"], self.device))
        off_col = self.params.get("offset_column")
        if off_col and off_col in frame.names:
            F = F + torch.from_numpy(frame.vec(off_col).as_float()).to(
                F.device)[:, None]
        return self._raw_from_F(F)


class GBM(ModelBuilder):
    algo = "gbm"
    model_cls = GBMModel
    ENGINE_FIXED = {"histogram_type": st.HISTOGRAM_TYPES,
                    "categorical_encoding": ("AUTO", "Enum"),
                    "calibrate_model": (False,)}

    def default_params(self) -> Dict:
        p = super().default_params()
        p.update(ntrees=50, max_depth=5, min_rows=10.0, nbins=20,
                 nbins_cats=1024, learn_rate=0.1, learn_rate_annealing=1.0,
                 sample_rate=1.0, col_sample_rate=1.0,
                 col_sample_rate_per_tree=1.0, min_split_improvement=1e-5,
                 histogram_type="AUTO", nbins_top_level=1024,
                 categorical_encoding="AUTO", stats_dtype="f32",
                 score_each_iteration=False, score_tree_interval=0,
                 stopping_rounds=0, stopping_metric="AUTO",
                 stopping_tolerance=1e-3, bf16_histograms=False,
                 monotone_constraints=None,
                 # one device: every tree builds on one node already
                 build_tree_one_node=False, calibrate_model=False,
                 custom_distribution_func=None)
        return p

    def _check_slice(self) -> None:
        """Reject, by name, what the port does not run yet."""
        p = self.params
        st.check_slice(self.algo, p)
        if p.get("stats_dtype") not in statpack.STATS_DTYPES:
            raise ValueError(f"{self.algo}: stats_dtype must be one of "
                             f"{statpack.STATS_DTYPES}")

    @staticmethod
    def _mono_array(p: Dict, di: DataInfo) -> Optional[np.ndarray]:
        """monotone_constraints {'col': +1/-1/0} (or its JSON string) ->
        (C,) int32 directions over ``di.x``; None when nothing is
        constrained.  Only numeric predictors can be constrained."""
        mc = p.get("monotone_constraints")
        if not mc:
            return None
        if isinstance(mc, str):
            try:
                mc = json.loads(mc.replace("'", '"'))
            except json.JSONDecodeError:
                raise ValueError(f"bad monotone_constraints: {mc!r}")
        mono = np.zeros(len(di.x), np.int32)
        for name, d in dict(mc).items():
            if name not in di.x:
                raise ValueError(f"monotone_constraints column {name!r} "
                                 "is not a predictor")
            if name in di.cat_names:
                raise ValueError(f"monotone_constraints on categorical "
                                 f"column {name!r} is not supported")
            d = int(d)
            if d not in (-1, 0, 1):
                raise ValueError(f"monotone_constraints[{name!r}]={d}; "
                                 "must be -1, 0 or 1")
            mono[di.x.index(name)] = d
        return mono if mono.any() else None

    def _fit(self, x: List[str], y: str, train: Frame,
             valid: Optional[Frame] = None) -> GBMModel:
        model = self._train_model(x, y, train, valid)
        model.output["training_metrics"] = model.model_metrics(train)
        if valid is not None:
            model.output["validation_metrics"] = model.model_metrics(valid)
        return model

    def _train_model(self, x: List[str], y: str, train: Frame,
                     valid: Optional[Frame] = None) -> GBMModel:
        """The trained model, without its final training and validation
        metrics (dart's one-tree fits skip them, as the reference's
        ``_skip_final_metrics`` does)."""
        self._check_slice()
        p = self.params
        dev = self.device
        ckpt = self.checkpoint_model()
        co = ckpt.output if ckpt is not None else None
        di = DataInfo(train, x, y, dev, weights=p.get("weights_column"),
                      offset=p.get("offset_column"))
        if co is not None:
            # resume: the checkpoint's features, distribution and binning,
            # so the new trees share its bin space
            di.x = list(co["x"])
            di.cat_names = [c for c in di.x if train.vec(c).is_categorical]
            dist_name = co["distribution_resolved"]
        else:
            dist_name = self.resolve_distribution(di)
        nclass = di.nclasses if dist_name in ("bernoulli", "multinomial") \
            else 1
        if dist_name == "bernoulli" and nclass != 2:
            raise ValueError("bernoulli needs a two-level response")
        K = nclass if dist_name == "multinomial" else 1
        # multinomial's K class trees take softmax gradients in the engine
        dist = None if K > 1 else distribution_from_params(dist_name, p)

        binned = checkpoint_bins(di, co) if co is not None else \
            st.prepare_bins(di, int(p["nbins"]), int(p["nbins_cats"]),
                            st.resolve_histogram_type(p),
                            int(p.get("nbins_top_level") or 1024))
        bins = binned.bins
        yv = di.response()
        w = di.weights()
        active = di.valid_mask()
        R, C = bins.shape
        # f0 on the link scale
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        wa = torch.where(active, w, zero)
        if co is not None:
            f0 = torch.tensor(np.asarray(co["f0"], np.float32)[:K],
                              device=dev)
        elif dist is None:
            pri = torch.stack([torch.sum(wa * (yv == k)) for k in range(K)])
            pri = pri / torch.clamp_min(torch.sum(pri), EPS)
            f0 = torch.log(torch.clamp_min(pri, EPS))
        elif dist_name == "custom":
            mask = active.cpu().numpy()
            f0 = torch.tensor([dist.init_f0(
                np.nan_to_num(yv.cpu().numpy())[mask],
                w.cpu().numpy()[mask])], dtype=torch.float32, device=dev)
        else:
            y0 = torch.where(active, yv if dist_name == "bernoulli"
                             else torch.nan_to_num(yv), zero)
            f0 = dist.init_f0(y0, wa)[None]
        F = f0[None, :].expand(R, K).to(torch.float32).contiguous()
        offset = di.offset()
        if offset is not None:
            F = F + offset[:, None]
        depth = engine.clamp_depth(int(p["max_depth"]))
        kleaves = engine.plan_engine(depth)
        prior = 0
        if co is not None:
            prior = check_checkpoint(co, int(p["max_depth"]), depth,
                                     kleaves)
            F = st.forest_accumulate(F, bins, co, int(p["max_depth"]))
        k_cols = max(1, min(C, int(round(float(p["col_sample_rate"]) * C))))
        mono = self._mono_array(p, di)
        # XGBoost semantics under force_newton: Newton leaf values for
        # every objective (squared error has unit hessian)
        newton = dist.newton if dist_name == "custom" else \
            dist_name not in FIRST_ORDER
        newton = newton or bool(p.get("force_newton"))
        train_kwargs = dict(
            bins=bins, yv=torch.nan_to_num(yv), w=w, active=active,
            is_cat=torch.as_tensor(binned.is_cat, device=dev), dist=dist,
            K=K, max_depth=depth, nbins=binned.nbins, k_cols=k_cols,
            newton=newton, sample_rate=float(p["sample_rate"]),
            learn_rate=float(p["learn_rate"]),
            learn_rate_annealing=float(p["learn_rate_annealing"]),
            min_rows=float(p["min_rows"]),
            min_split_improvement=float(p["min_split_improvement"]),
            bf16=bool(p.get("bf16_histograms", False)),
            reg_lambda=float(p.get("reg_lambda") or 0.0),
            col_sample_rate_per_tree=float(
                p.get("col_sample_rate_per_tree") or 1.0),
            mono=torch.as_tensor(mono, device=dev) if mono is not None
            else None,
            kleaves=kleaves,
            adaptive=binned.hist_type in ("UniformAdaptive", "Random"),
            fine_nbins=binned.fine_nbins,
            hist_random=binned.hist_type == "Random",
            stats_dtype=str(p["stats_dtype"]))
        dom = di.response_domain if nclass >= 2 else None
        f0_out = f0.expand(K).cpu().numpy()

        def make_model(tf) -> GBMModel:
            out = st.forest_output(di, binned, tf, depth, dom, prior=co)
            out.update(f0=f0_out, distribution_resolved=dist_name)
            if dist_name == "custom":
                out["custom_link"] = dist.link_name
            return self.model_cls(dict(p), out, dev)

        scorer = None
        if wants_scoring(p):
            score_frame = valid if valid is not None else train
            bins_sc = scoring_bins(di, binned, valid)
            F_sc = f0[None, :].expand(bins_sc.shape[0], K).to(
                torch.float32)
            off_col = p.get("offset_column")
            if off_col and off_col in score_frame.names:
                F_sc = F_sc + torch.from_numpy(
                    score_frame.vec(off_col).as_float()).to(dev)[:, None]
            if prior:
                F_sc = F_sc + st.forest_score_out(bins_sc, co, depth)
            proto = self.model_cls(dict(p), dict(
                response_domain=dom, distribution_resolved=dist_name), dev)
            family = dist if dist_name == "custom" else proto.family()

            def to_metrics(Fv, ntot):
                return proto.metrics_from_raw(
                    raw_from_F(Fv, dom, family), score_frame)

            scorer = IncrementalScorer(bins_sc, F_sc.contiguous(), depth,
                                       to_metrics, valid is not None,
                                       fine_na=binned.fine_nbins)
        kind = "binomial" if nclass == 2 else (
            "multinomial" if nclass > 2 else "regression")
        self._update(0.05, f"training {int(p['ntrees']) - prior} trees")
        return run_tree_driver(p, train_kwargs, F, self.rng_key(),
                               make_model, scorer, kind, prior_trees=prior,
                               update=self._update)
