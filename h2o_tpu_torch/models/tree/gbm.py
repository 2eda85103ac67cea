"""GBM — port of ``h2o_tpu/models/tree/gbm.py`` (``raw_from_F`` :31-47,
``GBMModel`` :50-82, ``GBM`` :85-386) with the single-dispatch path of
``driver.py:251-271`` inlined.

Binning, trees and scoring run on the device given to ``GBM``: ``cuda:0`` by
default, where every histogram goes through the hand-written kernels,
or the CPU when the caller passes ``device="cpu"`` (the plain PyTorch
versions).  Row sampling, per-level and per-tree column sampling,
``Random`` histograms, int16/int8 stats and depths beyond the dense
engine's frontier (the sparse-frontier engine, up to depth 30) run as in
the reference.  Options outside this slice of the port raise
``NotImplementedError`` naming the slice that brings them; the blocked
training loop, scoring intervals, early stopping and recovery wait too.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from h2o_tpu_torch.core.frame import Frame
from h2o_tpu_torch.models.distributions import get_distribution
from h2o_tpu_torch.models.model import DataInfo, Model, ModelBuilder
from h2o_tpu_torch.models.tree import engine
from h2o_tpu_torch.models.tree import shared_tree as st
from h2o_tpu_torch.ops import statpack

def raw_from_F(F: torch.Tensor, dom: Optional[List[str]], dist_name: str,
               threshold: float = 0.5) -> torch.Tensor:
    """Link-scale forest sum -> raw predictions: regression values, or
    [label, p0, p1] for a binomial response."""
    if dom is None:
        return get_distribution(dist_name).link_inv(F[:, 0])
    if len(dom) == 2:
        p1 = torch.sigmoid(F[:, 0])
        label = (p1 >= threshold).to(torch.float32)
        return torch.stack([label, 1 - p1, p1], dim=1)
    raise NotImplementedError(
        "multinomial scoring comes with the multinomial slice")


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

    def predict_raw(self, frame: Frame) -> torch.Tensor:
        F = self._forest_F(frame.as_matrix(self.output["x"], self.device))
        return raw_from_F(F, self.output.get("response_domain"),
                          self.output["distribution_resolved"],
                          threshold=float(self.output.get(
                              "default_threshold", 0.5)))


class GBM(ModelBuilder):
    algo = "gbm"
    model_cls = GBMModel

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
                 monotone_constraints=None)
        return p

    def _check_slice(self) -> None:
        """Reject, by name, what this slice of the port does not run."""
        p = self.params
        st.check_slice("gbm", p)
        if str(p.get("categorical_encoding")).lower() not in ("auto",
                                                             "enum"):
            raise ValueError("gbm: categorical_encoding must be AUTO/Enum")
        if p.get("stats_dtype") not in statpack.STATS_DTYPES:
            raise ValueError(f"gbm: stats_dtype must be one of "
                             f"{statpack.STATS_DTYPES}")
        if p.get("monotone_constraints"):
            raise NotImplementedError(
                "gbm: monotone_constraints is not in this slice of the "
                "port; it comes with the monotone constraints slice")

    def _fit(self, x: List[str], y: str, train: Frame) -> GBMModel:
        self._check_slice()
        p = self.params
        dev = self.device
        di = DataInfo(train, x, y, dev)
        dist_name = self.resolve_distribution(di)
        if dist_name not in ("gaussian", "bernoulli"):
            raise NotImplementedError(
                f"gbm: distribution {dist_name!r} is not in this slice of "
                "the port; it comes with the multinomial and "
                "other-distributions slice")
        nclass = di.nclasses if dist_name == "bernoulli" else 1
        if dist_name == "bernoulli" and nclass != 2:
            raise ValueError("bernoulli needs a two-level response")

        hist_type = st.resolve_histogram_type(p)
        binned = st.prepare_bins(di, int(p["nbins"]), int(p["nbins_cats"]),
                                 hist_type, int(p.get("nbins_top_level")
                                                or 1024))
        bins = binned.bins
        yv = di.response()
        active = di.valid_mask()
        R, C = bins.shape
        w = torch.ones(R, dtype=torch.float32, device=dev)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        wa = torch.where(active, w, zero)
        dist = get_distribution(dist_name)
        if dist_name == "bernoulli":
            f0 = dist.init_f0(torch.where(active, yv, zero), wa)[None]
        else:
            f0 = dist.init_f0(torch.where(active, torch.nan_to_num(yv),
                                          zero), wa)[None]
        F = f0[None, :].expand(R, 1).to(torch.float32).contiguous()
        depth = engine.clamp_depth(int(p["max_depth"]))
        k_cols = max(1, min(C, int(round(float(p["col_sample_rate"]) * C))))
        tf = engine.train_forest(
            bins, torch.nan_to_num(yv), w, active, F,
            torch.as_tensor(binned.is_cat, device=dev), self.rng_key(),
            dist_name=dist_name, ntrees=int(p["ntrees"]), max_depth=depth,
            nbins=binned.nbins, k_cols=k_cols,
            newton=dist_name != "gaussian",
            sample_rate=float(p["sample_rate"]),
            learn_rate=float(p["learn_rate"]),
            learn_rate_annealing=float(p["learn_rate_annealing"]),
            min_rows=float(p["min_rows"]),
            min_split_improvement=float(p["min_split_improvement"]),
            bf16=bool(p.get("bf16_histograms", False)),
            col_sample_rate_per_tree=float(
                p.get("col_sample_rate_per_tree") or 1.0),
            kleaves=engine.plan_engine(depth),
            adaptive=binned.hist_type in ("UniformAdaptive", "Random"),
            fine_nbins=binned.fine_nbins,
            hist_random=binned.hist_type == "Random",
            stats_dtype=str(p["stats_dtype"]))
        out = st.forest_output(
            di, binned, tf, depth,
            di.response_domain if nclass >= 2 else None)
        out.update(f0=f0.cpu().numpy(), distribution_resolved=dist_name)
        model = self.model_cls(dict(p), out, dev)
        model.output["training_metrics"] = model.model_metrics(train)
        return model
