"""The tree builders' training loop — port of ``h2o_tpu/models/tree/driver.py``
(``_set_node_array`` :64-88, ``IncrementalScorer`` :90-125,
``run_tree_driver`` :178-486; reference hex/tree/SharedTree.java
``scoreAndBuildTrees`` :481-530 and ``resumeFromCheckpoint`` :465-478).

Trees are trained in blocks of ``score_tree_interval`` trees when the
build scores (early stopping, a scoring interval, a runtime budget),
else in one call of ``engine.train_forest``.  Every block gets the same
master key and its absolute first-tree index ``t0``, so any partition of
the forest into blocks, and a resume from a checkpoint, reproduces the
forest of one call.  Scoring is incremental: the scoring frame's
link-scale F is carried across blocks and each block adds only its own
trees (one ``shared_tree.forest_score``), so a build scores O(T) trees
in all, never the whole model again.

Left out, each on purpose:

- the OOM ladder, chaos injection, ``TimeLine``/``DispatchStats`` and
  the memory-tier demotion of the raw frame come with the runtime
  services (P14);
- ``recovery_dir``/``checkpoint_interval`` (iteration-level recovery)
  raise ``NotImplementedError`` naming P14 (``shared_tree.check_slice``);
- the asynchronous double-buffering (block t+1 launched before block t
  is read back): the blocks run one after the other, and nothing leaves
  the device until the model is made but each scoring round's metrics.

Progress goes to the builder's job through ``update`` (its
``ModelBuilder._update``) with the reference's fractions and messages,
after every block and, beyond the reference (whose one-call forest is a
single device program), after every tree, so that a cancel, an expired
deadline or a stall window takes effect between trees.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from h2o_tpu_torch.models.score_keeper import ScoreKeeper
from h2o_tpu_torch.models.tree.engine import (TrainedForest, pool_size,
                                              train_forest)
from h2o_tpu_torch.models.tree.shared_tree import (BinnedData, bin_matrix,
                                                   forest_score)

#: scoring-history metrics, as the reference records them
_HISTORY_KEYS = ("mse", "logloss", "AUC", "mean_residual_deviance", "err")


def _set_node_array(model, name: str, new: np.ndarray) -> None:
    """Store a per-node array covering every tree of the model: a
    checkpoint's own values come first; a checkpoint without the array
    gets a prefix of -1 for ``thr_bin`` (bitset descent) and 0 else, so
    indexing stays aligned with ``split_col`` — except ``node_w``, which
    becomes None: made-up covers would make TreeSHAP silently wrong for
    the checkpoint's trees."""
    sc_all = np.asarray(model.output["split_col"])
    prior = model.output.get(name)
    if prior is not None and \
            prior.shape[0] + new.shape[0] == sc_all.shape[0]:
        new = np.concatenate([np.asarray(prior), new])
    elif new.shape[0] != sc_all.shape[0]:
        if name == "node_w":
            model.output[name] = None
            return
        fill = -1 if name == "thr_bin" else 0
        pad = np.full((sc_all.shape[0] - new.shape[0],) + new.shape[1:],
                      fill, new.dtype)
        new = np.concatenate([pad, new])
    model.output[name] = new


class IncrementalScorer:
    """Running link-scale predictions of the growing forest on one frame.

    ``to_metrics(F, ntrees_total)`` turns the accumulated F into
    ModelMetrics (the builder's link or vote semantics)."""

    def __init__(self, bins: torch.Tensor, F_init: torch.Tensor, depth: int,
                 to_metrics: Callable, is_validation: bool,
                 fine_na: int = -1):
        self.bins = bins
        self.F = F_init
        self.depth = depth
        self.to_metrics = to_metrics
        self.is_validation = is_validation
        self.fine_na = fine_na

    def add(self, tf: TrainedForest) -> None:
        """Add one block's trees to F."""
        self.F = self.F + forest_score(
            self.bins, tf.split_col, tf.bitset, tf.value, self.depth,
            child=tf.child, thr=tf.thr_bin, na_l=tf.na_left,
            fine_na=self.fine_na)

    def metrics(self, ntrees_total: int):
        return self.to_metrics(self.F, ntrees_total)


def wants_scoring(p: Dict) -> bool:
    """Whether a build scores as it trains: early stopping, a scoring
    interval or a runtime budget."""
    return int(p.get("stopping_rounds") or 0) > 0 or \
        int(p.get("score_tree_interval") or 0) > 0 or \
        bool(p.get("score_each_iteration")) or \
        float(p.get("max_runtime_secs") or 0) > 0


def scoring_bins(di, binned: BinnedData, valid) -> torch.Tensor:
    """The bins the incremental scorer scores: the validation frame's,
    binned with the training split points, else the training bins."""
    if valid is None:
        return binned.bins
    return bin_matrix(valid.as_matrix(di.x, binned.bins.device),
                      binned.split_points, binned.is_cat, binned.fine_nbins)


def checkpoint_bins(di, co: Dict) -> BinnedData:
    """The training frame binned in a checkpoint's grid (its split
    points, categorical flags and histogram type), so that new trees
    share the checkpoint's bin space."""
    fine = int(co.get("fine_nbins") or co["nbins"])
    sp = np.asarray(co["split_points"], np.float32)
    is_cat = np.asarray(co["is_cat"], bool)
    return BinnedData(bin_matrix(di.matrix(), sp, is_cat, fine), sp, is_cat,
                      int(co["nbins"]), fine,
                      co.get("hist_type", "QuantilesGlobal"))


def check_checkpoint(co: Dict, max_depth: int, depth: int,
                     kleaves: int) -> int:
    """The number of trees a checkpoint holds, after checking that the
    build continues it: the same ``max_depth`` and the same engine (dense
    heap or sparse frontier) with the same node pool."""
    if int(co["max_depth"]) != int(max_depth):
        raise ValueError("checkpoint max_depth mismatch")
    if (co.get("child") is not None) != (kleaves > 0) or \
            np.asarray(co["split_col"]).shape[2] != pool_size(depth, kleaves):
        raise ValueError(
            "checkpoint tree engine/pool mismatch (dense vs sparse-frontier, "
            "or a different frontier width); set engine.MAX_LIVE_LEAVES to "
            "match the checkpoint's engine")
    return int(co["ntrees_actual"])


def _concat(blocks: List[TrainedForest]) -> TrainedForest:
    """One forest from its blocks, in tree order; F after the last."""
    def cat(name):
        return torch.cat([getattr(b, name) for b in blocks])

    return TrainedForest(
        cat("split_col"), cat("bitset"), cat("value"),
        torch.stack([b.varimp for b in blocks]).sum(dim=0), cat("thr_bin"),
        cat("na_left"), cat("node_gain"), cat("node_w"),
        cat("child") if blocks[0].child is not None else None,
        blocks[-1].f_final)


def run_tree_driver(p: Dict, train_kwargs: Dict, F0: torch.Tensor, key,
                    make_model: Callable,
                    scorer: Optional[IncrementalScorer], kind: str,
                    prior_trees: int = 0,
                    update: Optional[Callable[[float, str], None]] = None):
    """Train ``p['ntrees']`` trees in all, ``prior_trees`` of which a
    checkpoint already holds.  With a ``scorer`` (the builder makes one
    when ``wants_scoring``), score every ``score_tree_interval`` trees
    (every tree under ``score_each_iteration``; every 10 when only
    ``stopping_rounds`` or ``max_runtime_secs`` asks for scoring) and
    stop on ``ScoreKeeper.stop_early`` or the runtime budget.

    ``make_model(tf)`` -> Model gets the new trees only (the
    builder prepends a checkpoint's trees and carries its ``varimp`` and
    node arrays); the driver then adds the new trees' importance and
    node arrays (``thr_bin``, ``na_left``, ``node_gain``, ``node_w``)
    and the scoring history.  ``update(progress, msg)`` gets the
    progress after every tree and every block."""
    ntrees = int(p["ntrees"]) - prior_trees
    if prior_trees and ntrees <= 0:
        raise ValueError(
            f"checkpoint already has {prior_trees} trees >= ntrees="
            f"{p['ntrees']}; raise ntrees to continue training")
    rounds = int(p.get("stopping_rounds") or 0)
    interval = int(p.get("score_tree_interval") or 0)
    if p.get("score_each_iteration"):
        interval = 1
    max_rt = float(p.get("max_runtime_secs") or 0.0)
    t_start = time.time()
    sk = ScoreKeeper(p.get("stopping_metric", "AUTO"), kind,
                     stopping_rounds=rounds,
                     tolerance=float(p.get("stopping_tolerance", 1e-3)))

    report = update or (lambda progress, msg="": None)
    done = 0

    def tree_done(n: int) -> None:
        report(0.05 + 0.85 * (done + n) / ntrees,
               f"{prior_trees + done + n} trees")

    if scorer is None:
        # single-dispatch path: the whole forest in one call
        tf = train_forest(F0=F0, key=key, ntrees=ntrees, t0=prior_trees,
                          progress=tree_done, **train_kwargs)
    else:
        block = interval if interval > 0 else max(1, min(ntrees, 10))
        prefix = "validation_" if scorer.is_validation else "training_"
        blocks: List[TrainedForest] = []
        F = F0
        while done < ntrees:
            n = min(block, ntrees - done)
            tf = train_forest(F0=F, key=key, ntrees=n,
                              t0=prior_trees + done, progress=tree_done,
                              **train_kwargs)
            F = tf.f_final
            blocks.append(tf)
            done += n
            scorer.add(tf)
            mm = scorer.metrics(prior_trees + done)
            row = {"number_of_trees": prior_trees + done,
                   "timestamp": time.time()}
            for k in _HISTORY_KEYS:
                if mm.get(k) is not None:
                    row[prefix + k.lower()] = mm.get(k)
            sk.add(mm, row)
            report(0.05 + 0.85 * done / ntrees,
                   f"{prior_trees + done} trees, "
                   f"{sk.metric_name}={sk.history[-1]:.5g}")
            if sk.stop_early():
                report(0.9, f"early stop at {prior_trees + done} trees")
                break
            if max_rt > 0 and time.time() - t_start > max_rt:
                report(0.9, f"max_runtime_secs hit at {done} trees")
                break
        tf = _concat(blocks)

    model = make_model(tf)
    model.output["scoring_history"] = sk.events
    prior_vi = model.output.get("varimp")
    vi = tf.varimp.cpu().numpy()
    model.output["varimp"] = vi if prior_vi is None else prior_vi + vi
    for name in ("thr_bin", "na_left", "node_gain", "node_w"):
        _set_node_array(model, name, getattr(tf, name).cpu().numpy())
    return model
