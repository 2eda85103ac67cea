"""UpliftDRF — port of ``h2o_tpu/models/tree/uplift.py`` (``_divergence``
:38-47, ``_find_uplift_splits`` :50-128, ``_train_uplift_forest``
:136-240, ``UpliftDRFModel`` :243-292, ``UpliftDRF`` :295-379; reference
hex/tree/uplift/UpliftDRF.java): an uplift random forest for a binary
response and a binary ``treatment_column``.

Each tree takes a ``sample_rate`` row sample and grows on the
sparse-frontier pool (``engine.frontier_plan``: at most
``engine.MAX_LIVE_LEAVES`` live leaves a level, explicit left-child
pointers).  A level is one histogram of four stat slots (w_t, w_t*y,
w_c, w_c*y) over the QuantilesGlobal bins — on the card one launch of
the hand-written K1 kernel (``ops/histogram.histogram_build``), on the
CPU its plain version — then the closed-form divergence gain (KL,
ChiSquared or Euclidean) over the bins' cumulative sums, vectorised
over every (leaf, column, bin, NA side) candidate.  A split's children
get their treatment and control rates from the split's own sums, so no
histogram runs after the last level.  The divergences and gains take
XLA's float32 arithmetic (``ops/xlamath.py``: its ``log`` and its fused
multiply-adds): over small integer counts many candidate splits tie in
exact arithmetic, and the last bits of their gains pick the reference's
tree.  When a level's split children
outnumber the frontier cap, the largest children (by rows) stay live,
in ``lax.top_k``'s order.  ``stats_dtype`` "int16"/"int8" quantizes each
tree's stats against its own key (``ops/statpack.py``; the reference's
``H2O_TPU_STATS_DTYPE``), so the tables sum exactly in int32.

A prediction is the mean over the trees of the leaf rates, [uplift,
p(y=1 | treated), p(y=1 | control)]; the metrics are the Qini-style
``auuc``, ``ate`` and ``qini`` (``models/metrics.uplift_metrics``).

Left out, as in the reference: validation-driven early stopping (the
builder takes no scoring interval), and ``auuc_type``/``auuc_nbins``
other than their defaults (``ENGINE_FIXED``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from h2o_tpu_torch.core.frame import Frame, Vec
from h2o_tpu_torch.models import metrics as mm
from h2o_tpu_torch.models.model import DataInfo, Model, ModelBuilder
from h2o_tpu_torch.models.tree import engine
from h2o_tpu_torch.models.tree import shared_tree as st
from h2o_tpu_torch.ops import prng, statpack
from h2o_tpu_torch.ops import xlamath as xm
from h2o_tpu_torch.ops.binpack import widen_bins
from h2o_tpu_torch.ops.histogram import histogram_build

EPS = 1e-6
UPLIFT_METRICS = ("kl", "chisquared", "euclidean")


def divergence(pt: torch.Tensor, pc: torch.Tensor,
               metric: str) -> torch.Tensor:
    """D(P_treatment || P_control) of a binary outcome, with the
    reference's float32 arithmetic (``ops/xlamath.py``)."""
    pt = torch.clamp(pt, EPS, 1 - EPS)
    pc = torch.clamp(pc, EPS, 1 - EPS)
    if metric == "kl":
        return xm.fma(pt, xm.log(pt / pc),
                      (1 - pt) * xm.log((1 - pt) / (1 - pc)))
    if metric == "chisquared":
        return (pt - pc) ** 2 / pc + (pt - pc) ** 2 / (1 - pc)
    d = pt - pc                                              # euclidean
    return xm.fma(d, d, ((1 - pt) - (1 - pc)) ** 2)


def _rate(n: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return s / torch.clamp_min(n, EPS)


def find_uplift_splits(hist: torch.Tensor, col_allowed: torch.Tensor,
                       metric: str, min_rows: float) -> Dict:
    """Best divergence-gain split per leaf from (L, C, B+1, 4) float32
    histograms of (w_t, w_t*y, w_c, w_c*y): prefix bitsets in natural bin
    order, the NA bucket tried on both sides, the first maximum of the
    (C, B, 2) candidates.  A leaf splits when its best gain is finite and
    above 1e-9.  Returns the split, the leaf's rates and size, and its
    children's rates and sizes."""
    L, C, B1, _ = hist.shape
    B = B1 - 1
    dev = hist.device
    cwt, cwty, cwc, cwcy = (torch.cumsum(hist[..., :B, k], dim=2)
                            for k in range(4))
    nat = [hist[..., B, k] for k in range(4)]
    tot = (cwt[..., -1] + nat[0], cwty[..., -1] + nat[1],
           cwc[..., -1] + nat[2], cwcy[..., -1] + nat[3])
    d_parent = divergence(_rate(tot[0], tot[1]), _rate(tot[2], tot[3]),
                          metric)                                # (L, C)
    n = (tot[0] + tot[2])[..., None]
    neg_inf = torch.tensor(float("-inf"), device=dev)

    def side_gain(na_left: bool):
        lwt, lwty, lwc, lwcy = (
            c + nat[k][..., None] if na_left else c
            for k, c in enumerate((cwt, cwty, cwc, cwcy)))
        rwt = tot[0][..., None] - lwt
        rwty = tot[1][..., None] - lwty
        rwc = tot[2][..., None] - lwc
        rwcy = tot[3][..., None] - lwcy
        nl = lwt + lwc
        nr = rwt + rwc
        dl = divergence(_rate(lwt, lwty), _rate(lwc, lwcy), metric)
        dr = divergence(_rate(rwt, rwty), _rate(rwc, rwcy), metric)
        nn = torch.clamp_min(n, EPS)
        gain = xm.fma(nl / nn, dl, (nr / nn) * dr) - d_parent[..., None]
        ok = (nl >= min_rows) & (nr >= min_rows) & \
            (lwt > 0) & (lwc > 0) & (rwt > 0) & (rwc > 0)
        return torch.where(ok, gain, neg_inf)

    gains = torch.stack([side_gain(False), side_gain(True)], dim=-1)
    gains = torch.where(col_allowed[..., None, None], gains, neg_inf)
    flat = gains.reshape(L, -1)
    best = torch.argmax(flat, dim=1)
    best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
    col = torch.div(best, B * 2, rounding_mode="floor")
    rem = best % (B * 2)
    split_b = torch.div(rem, 2, rounding_mode="floor")
    na_left = (rem % 2).bool()
    do_split = torch.isfinite(best_gain) & (best_gain > 1e-9)
    bitset = torch.cat([torch.arange(B, device=dev)[None, :] <=
                        split_b[:, None], na_left[:, None]], dim=1)
    li = torch.arange(L, device=dev)
    # the leaf's totals are the same in every column: take the chosen one
    at = [t[li, col] for t in tot]
    n_leaf = (tot[0] + tot[2])[li, col]
    zero = torch.zeros((), device=dev)

    def pick(cum, k):
        return cum[li, col, split_b] + torch.where(na_left, nat[k][li, col],
                                                   zero)

    lwt_s, lwty_s, lwc_s, lwcy_s = (pick(c, k) for k, c in
                                    enumerate((cwt, cwty, cwc, cwcy)))
    l_n = lwt_s + lwc_s
    return dict(do_split=do_split, col=col.to(torch.int32), bitset=bitset,
                p_t=_rate(at[0], at[1]), p_c=_rate(at[2], at[3]), n=n_leaf,
                l_pt=_rate(lwt_s, lwty_s), l_pc=_rate(lwc_s, lwcy_s),
                r_pt=_rate(at[0] - lwt_s, at[1] - lwty_s),
                r_pc=_rate(at[2] - lwc_s, at[3] - lwcy_s),
                l_n=l_n, r_n=n_leaf - l_n)


def train_uplift_forest(bins: torch.Tensor, treat: torch.Tensor,
                        yv: torch.Tensor, w: torch.Tensor,
                        active: torch.Tensor, key, *, ntrees: int,
                        max_depth: int, nbins: int, k_cols: int, metric: str,
                        sample_rate: float, min_rows: float,
                        kleaves: int, stats_dtype: str = "f32"):
    """The uplift forest, tree by tree on the sparse-frontier pool.  Tree
    t draws from ``prng.split(key, ntrees)[t]``: its row sample from the
    first half of that key's split, one column-sample key a level from
    the second, and its quantization noise from the tree key itself.
    Returns (T, N) split columns, (T, N, B+1) bitsets, (T, N) treatment
    and control rates and (T, N) left-child pointers."""
    R, C = bins.shape
    D, B = max_depth, nbins
    dev = bins.device
    widths = engine.frontier_plan(D, kleaves)
    N = 1 + 2 * sum(widths)
    qmax = statpack.stats_qmax(statpack.padded_rows(R), stats_dtype) \
        if stats_dtype != "f32" else 0
    neg_inf = torch.tensor(float("-inf"), device=dev)
    trees = []
    for key_t in prng.split(key, ntrees):
        ks, kc = prng.split(key_t)
        samp = (prng.uniform(ks, (R,), dev) < sample_rate) & active
        wa = torch.where(samp, w, torch.zeros_like(w))
        stats = torch.stack([wa * treat, wa * treat * yv, wa * (1 - treat),
                             wa * (1 - treat) * yv], dim=1)
        inv_sc = None
        if stats_dtype != "f32":
            stats, inv_sc = statpack.quantize_stats(stats, key_t,
                                                    stats_dtype, qmax)
        split_col = torch.full((N + 1,), -1, dtype=torch.int32, device=dev)
        bitset = torch.zeros((N + 1, B + 1), dtype=torch.bool, device=dev)
        val_t = torch.zeros(N + 1, dtype=torch.float32, device=dev)
        val_c = torch.zeros(N + 1, dtype=torch.float32, device=dev)
        child = torch.full((N + 1,), -1, dtype=torch.int32, device=dev)
        frontier = torch.zeros(1, dtype=torch.long, device=dev)
        slot = torch.where(samp, 0, -1).to(torch.int32)
        base = 1                                  # next free pool slot
        for d in range(D):
            L = widths[d]
            hist = histogram_build(bins, slot, stats, L, B)
            if inv_sc is not None:
                hist = statpack.dequant_table(hist, inv_sc)
            kc, kcol = prng.split(kc)
            if k_cols < C:
                r = prng.uniform(kcol, (L, C), dev)
                kth = torch.sort(r, dim=1).values[:, k_cols - 1:k_cols]
                col_allowed = r <= kth
            else:
                col_allowed = torch.ones((L, C), dtype=torch.bool,
                                         device=dev)
            s = find_uplift_splits(hist, col_allowed, metric, min_rows)
            do = s["do_split"] & (s["n"] > 0)
            ptr = base + 2 * torch.arange(L, dtype=torch.int32, device=dev)
            split_col[frontier] = torch.where(do, s["col"],
                                              torch.full_like(s["col"], -1))
            bitset[frontier] = s["bitset"] & do[:, None]
            # a node's own rates stand when it ends here
            val_t[frontier] = s["p_t"]
            val_c[frontier] = s["p_c"]
            child[frontier] = torch.where(do, ptr, torch.full_like(ptr, -1))
            # pre-write the children's rates at their fresh pool slots
            cmask = do.repeat_interleave(2)
            for val, lk, rk in ((val_t, "l_pt", "r_pt"),
                                (val_c, "l_pc", "r_pc")):
                cv = torch.stack([s[lk], s[rk]], dim=1).reshape(2 * L)
                val[base:base + 2 * L] = torch.where(cmask, cv,
                                                     torch.zeros_like(cv))
            if d + 1 < D:
                L_next = widths[d + 1]
                # best-first by child size: the biggest nodes have the
                # most evidence left to split on
                cn = torch.stack([s["l_n"], s["r_n"]], dim=1).reshape(2 * L)
                frontier, _, inv = engine.select_frontier(
                    torch.where(cmask, cn, neg_inf), L_next, base, N)
                act = slot >= 0
                sl = slot.clamp_min(0).long()
                c = s["col"].long()[sl]
                b = widen_bins(torch.gather(bins, 1, c[:, None])[:, 0])
                go_left = s["bitset"][sl, b.long()]
                cand = 2 * sl + torch.where(go_left, 0, 1)
                new_slot = torch.where(act & do[sl], inv[cand],
                                       torch.full_like(slot, -1))
                slot = torch.where(act, new_slot, slot)
            base += 2 * L
        trees.append((split_col[:N], bitset[:N], val_t[:N], val_c[:N],
                      child[:N]))
    return tuple(torch.stack(a) for a in zip(*trees))


class UpliftDRFModel(Model):
    algo = "upliftdrf"
    pred_names = ("uplift_predict", "p_y1_ct1", "p_y1_ct0")

    def predict_raw(self, frame: Frame) -> torch.Tensor:
        """(rows, 3) float32 [uplift, p(y=1 | treated), p(y=1 | control)]:
        two descents of the forest, one over each rate."""
        out = self.output
        dev = self.device
        bins = st.bin_matrix(frame.as_matrix(out["x"], dev),
                             out["split_points"], out["is_cat"],
                             int(out["nbins"]))
        D = int(out["max_depth"])
        T = max(int(out["ntrees_actual"]), 1)

        def t(k):
            return torch.tensor(np.asarray(out[k]), device=dev)[:, None]

        ch = t("child") if out.get("child") is not None else None
        # T as a tensor: a true division on every device (CUDA multiplies
        # by the reciprocal of a Python-number divisor)
        pt, pc = (st.forest_score(bins, t("split_col"), t("bitset"), t(k), D,
                                  child=ch)[:, 0] /
                  torch.tensor(float(T), device=dev)
                  for k in ("val_t", "val_c"))
        return torch.stack([pt - pc, pt, pc], dim=1)

    def predict(self, frame: Frame) -> Frame:
        raw = self.predict_raw(frame).cpu().numpy()
        return Frame(list(self.pred_names), [Vec(raw[:, j]) for j in range(3)])

    def model_metrics(self, frame: Frame) -> mm.ModelMetrics:
        """``auuc``, ``ate`` and ``qini`` over the rows ranked by
        predicted uplift."""
        raw = self.predict_raw(frame).cpu().numpy()
        p = self.params
        return mm.uplift_metrics(raw[:, 0],
                                 frame.vec(p["response_column"]).data,
                                 frame.vec(p["treatment_column"]).data)


class UpliftDRF(ModelBuilder):
    algo = "upliftdrf"
    model_cls = UpliftDRFModel
    supports_cv = False
    ENGINE_FIXED = {"auuc_type": ("AUTO", "qini"), "auuc_nbins": (-1,)}

    def default_params(self) -> Dict:
        p = super().default_params()
        p.update(treatment_column="treatment", uplift_metric="KL",
                 ntrees=50, max_depth=10, min_rows=10.0, nbins=20,
                 nbins_cats=1024, mtries=-2, sample_rate=0.632,
                 auuc_type="AUTO", auuc_nbins=-1, stats_dtype="f32")
        return p

    def _fit(self, x: List[str], y: str, train: Frame,
             valid: Optional[Frame] = None) -> UpliftDRFModel:
        p = self.params
        st.check_slice(self.algo, p)
        if p.get("stats_dtype") not in statpack.STATS_DTYPES:
            raise ValueError(f"{self.algo}: stats_dtype must be one of "
                             f"{statpack.STATS_DTYPES}")
        metric = str(p.get("uplift_metric") or "KL").lower()
        if metric not in UPLIFT_METRICS:
            raise ValueError(f"{self.algo}: unknown uplift_metric "
                             f"{p['uplift_metric']!r}")
        dev = self.device
        tcol = p["treatment_column"]
        tv = train.vec(tcol)
        if not tv.is_categorical or tv.cardinality != 2:
            raise ValueError("treatment_column must be a binary categorical")
        x = [c for c in x if c != tcol]
        di = DataInfo(train, x, y, dev, weights=p.get("weights_column"))
        if di.nclasses != 2:
            raise ValueError("UpliftDRF requires a binary response")
        binned = st.prepare_bins(di, int(p["nbins"]), int(p["nbins_cats"]))
        codes = torch.from_numpy(tv.data).to(dev)
        C = len(di.x)
        mtries = int(p["mtries"])
        if mtries == -1:
            mtries = max(1, int(np.sqrt(C)))
        elif mtries <= 0:
            mtries = C
        depth = engine.clamp_depth(int(p["max_depth"]))
        T = int(p["ntrees"])
        self._update(0.1, f"training {T} uplift trees")
        sc, bs, vt, vc, ch = train_uplift_forest(
            binned.bins, codes.to(torch.float32),
            torch.nan_to_num(di.response()), di.weights(),
            di.valid_mask() & (codes >= 0), self.rng_key(), ntrees=T,
            max_depth=depth, nbins=binned.nbins, k_cols=mtries,
            metric=metric, sample_rate=float(p["sample_rate"]),
            min_rows=float(p["min_rows"]), kleaves=engine.MAX_LIVE_LEAVES,
            stats_dtype=str(p["stats_dtype"]))

        def host(a):
            return a.cpu().numpy()

        out = dict(x=list(di.x), split_points=binned.split_points,
                   is_cat=binned.is_cat, nbins=binned.nbins,
                   split_col=host(sc), bitset=host(bs), val_t=host(vt),
                   val_c=host(vc), child=host(ch), max_depth=depth,
                   ntrees_actual=T, response_domain=di.response_domain,
                   domains={c: list(train.vec(c).domain)
                            for c in di.cat_names})
        model = self.model_cls(dict(p, response_column=y,
                                    treatment_column=tcol), out, dev)
        model.output["training_metrics"] = model.model_metrics(train)
        if valid is not None:
            model.output["validation_metrics"] = model.model_metrics(valid)
        return model
