"""DRF — port of ``h2o_tpu/models/tree/drf.py`` (``raw_from_votes``
:27-39, ``DRFModel`` :42-60, ``DRF`` :63-247), training through
``driver.run_tree_driver``: validation frames, scoring intervals, early
stopping, ``max_runtime_secs`` and checkpoints as in GBM, the
incremental scorer's F a running sum of votes.

Bagged trees fit on the response itself (no boosting): each tree sees
a ``sample_rate`` row sample and ``mtries`` columns a split (sqrt(C)
for classification, C/3 for regression by default), leaf values are
plain (weighted) means, and a prediction is the mean over the trees.  A
response of K > 2 classes grows one tree per class an iteration on the
class indicator, and its votes are normalised into probabilities.  The
default max_depth of 20 runs on the sparse-frontier engine
(``engine.build_tree_frontier``).  ``binomial_double_trees`` is fixed at
False, as in the reference.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from h2o_tpu_torch.core.frame import Frame
from h2o_tpu_torch.models.model import DataInfo, Model, ModelBuilder
from h2o_tpu_torch.models.tree import engine
from h2o_tpu_torch.models.tree import shared_tree as st
from h2o_tpu_torch.models.tree.driver import (IncrementalScorer,
                                              check_checkpoint,
                                              checkpoint_bins,
                                              run_tree_driver, scoring_bins,
                                              wants_scoring)

EPS = 1e-10


def raw_from_votes(F: torch.Tensor, ntrees: int, dom: Optional[List[str]],
                   threshold: float = 0.5) -> torch.Tensor:
    """Summed per-tree votes -> raw predictions (mean over trees):
    regression values, [label, p0, p1] for a binomial response, or
    [label, p0..pK-1] with the class votes normalised to sum to 1."""
    F = F / max(int(ntrees), 1)
    if dom is None:
        return F[:, 0]
    if len(dom) == 2:
        p1 = F[:, 0].clamp(0.0, 1.0)
        label = (p1 >= threshold).to(torch.float32)
        return torch.stack([label, 1 - p1, p1], dim=1)
    P = F.clamp_min(0.0)
    P = P / torch.clamp_min(P.sum(dim=1, keepdim=True), EPS)
    label = torch.argmax(P, dim=1).to(torch.float32)
    return torch.cat([label[:, None], P], dim=1)


class DRFModel(Model):
    algo = "drf"

    def predict_raw_array(self, X) -> torch.Tensor:
        """Online fast path (serve/engine.py): a raw (rows, len(x))
        column matrix in ``output['x']`` order, as float32 on the
        model's device, no Frame."""
        out = self.output
        m = torch.as_tensor(X, dtype=torch.float32, device=self.device)
        bins = st.bin_matrix(m, out["split_points"], out["is_cat"],
                             st.model_fine_na(out))
        return raw_from_votes(st.forest_score_out(bins, out),
                              int(out["ntrees_actual"]),
                              out.get("response_domain"),
                              threshold=float(out.get("default_threshold",
                                                      0.5)))

    def predict_raw(self, frame: Frame) -> torch.Tensor:
        # delegates to the array fast path — one scoring implementation
        return self.predict_raw_array(
            frame.as_matrix(self.output["x"], self.device))


class DRF(ModelBuilder):
    algo = "drf"
    model_cls = DRFModel
    ENGINE_FIXED = {"histogram_type": st.HISTOGRAM_TYPES,
                    "binomial_double_trees": (False,)}

    def default_params(self) -> Dict:
        p = super().default_params()
        p.update(ntrees=50, max_depth=20, min_rows=1.0, nbins=20,
                 nbins_cats=1024, mtries=-1, sample_rate=0.632,
                 col_sample_rate_per_tree=1.0, min_split_improvement=1e-5,
                 histogram_type="AUTO", nbins_top_level=1024,
                 binomial_double_trees=False, score_each_iteration=False,
                 score_tree_interval=0, stopping_rounds=0,
                 stopping_metric="AUTO",
                 stopping_tolerance=1e-3)
        return p

    def _fit(self, x: List[str], y: str, train: Frame,
             valid: Optional[Frame] = None) -> DRFModel:
        p = self.params
        st.check_slice("drf", p)
        dev = self.device
        ckpt = self.checkpoint_model()
        co = ckpt.output if ckpt is not None else None
        di = DataInfo(train, x, y, dev, weights=p.get("weights_column"))
        if co is not None:
            di.x = list(co["x"])
            di.cat_names = [c for c in di.x if train.vec(c).is_categorical]
        nclass = di.nclasses
        K = nclass if nclass > 2 else 1
        binned = checkpoint_bins(di, co) if co is not None else \
            st.prepare_bins(di, int(p["nbins"]), int(p["nbins_cats"]),
                            st.resolve_histogram_type(p),
                            int(p.get("nbins_top_level") or 1024))
        bins = binned.bins
        R, C = bins.shape
        # mtries default: sqrt(C) classification, C/3 regression
        mtries = int(p["mtries"])
        if mtries <= 0:
            mtries = max(1, int(np.sqrt(C))) if nclass >= 2 \
                else max(1, C // 3)
        depth = engine.clamp_depth(int(p["max_depth"]))
        kleaves = engine.plan_engine(depth)
        # DRF's stats do not depend on F, so a resume needs no F either
        F0 = torch.zeros((R, K), dtype=torch.float32, device=dev)
        prior = check_checkpoint(co, depth, depth, kleaves) \
            if co is not None else 0
        train_kwargs = dict(
            bins=bins, yv=torch.nan_to_num(di.response()), w=di.weights(),
            active=di.valid_mask(),
            is_cat=torch.as_tensor(binned.is_cat, device=dev), dist=None,
            K=K, max_depth=depth, nbins=binned.nbins, k_cols=mtries,
            newton=False, sample_rate=float(p["sample_rate"]),
            learn_rate=1.0, learn_rate_annealing=1.0,
            min_rows=float(p["min_rows"]),
            min_split_improvement=float(p["min_split_improvement"]),
            mode="drf",
            col_sample_rate_per_tree=float(
                p.get("col_sample_rate_per_tree") or 1.0),
            kleaves=kleaves,
            adaptive=binned.hist_type in ("UniformAdaptive", "Random"),
            fine_nbins=binned.fine_nbins,
            hist_random=binned.hist_type == "Random")
        dom = di.response_domain if nclass >= 2 else None

        def make_model(tf) -> DRFModel:
            return self.model_cls(dict(p), st.forest_output(
                di, binned, tf, depth, dom, prior=co), dev)

        scorer = None
        if wants_scoring(p):
            score_frame = valid if valid is not None else train
            bins_sc = scoring_bins(di, binned, valid)
            F_sc = torch.zeros((bins_sc.shape[0], K), dtype=torch.float32,
                               device=dev)
            if prior:
                F_sc = F_sc + st.forest_score_out(bins_sc, co, depth)
            proto = self.model_cls(dict(p), dict(response_domain=dom), dev)

            def to_metrics(Fv, ntot):
                return proto.metrics_from_raw(
                    raw_from_votes(Fv, ntot, dom), score_frame)

            scorer = IncrementalScorer(bins_sc, F_sc, depth, to_metrics,
                                       valid is not None,
                                       fine_na=binned.fine_nbins)
        kind = "binomial" if nclass == 2 else (
            "multinomial" if nclass > 2 else "regression")
        self._update(0.05, f"training {int(p['ntrees']) - prior} trees")
        model = run_tree_driver(p, train_kwargs, F0, self.rng_key(),
                                make_model, scorer, kind, prior_trees=prior,
                                update=self._update)
        model.output["training_metrics"] = model.model_metrics(train)
        if valid is not None:
            model.output["validation_metrics"] = model.model_metrics(valid)
        return model
