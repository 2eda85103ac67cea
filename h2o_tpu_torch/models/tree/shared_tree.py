"""Shared tree machinery — port of ``h2o_tpu/models/tree/shared_tree.py``:
binning (``BinnedData``, ``_quantile_split_points``, ``prepare_bins``
:52-152; ``bin_matrix``, ``_bin_all``, ``_col_min_max``,
``_uniform_split_points`` :155-224), split finding with monotone
constraints (``find_splits`` :380-498) and forest scoring
(``_go_left``, ``forest_score``, ``forest_tree_values``,
``forest_score_out`` :531-625, and ``forest_accumulate``, which resumes
a checkpoint's F in training's order, with the child-pointer descent of
``jit_engine._tree_predict`` :708-773).

Rows are binned once: QuantilesGlobal against per-column quantiles
(F == B), UniformAdaptive against a uniform fine grid of
``nbins_top_level`` bins over each column's [min, max] (the tree
engine then places B buckets per node).  Every split is a left-
membership bitset over buckets (categoricals in mean-gradient order,
NA as the last bit), or for adaptive numeric splits a fine-bin
threshold; a tree is a heap array with node n's children at 2n+1/2n+2,
or (sparse-frontier engine) a node pool with a left-child pointer.

All of it is float32/int32 tensor code on the caller's device, except
the per-column quantile dedupe and the uniform grid, which the
reference also computes on the host.  The streamed binning of frames
larger than device memory (``shared_tree.py:229-360``) waits for a
later slice.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from h2o_tpu_torch.models.model import DataInfo
from h2o_tpu_torch.ops.binpack import cast_bins, widen_bins
from h2o_tpu_torch.ops.xlamath import cumsum, sum_leading

EPS = 1e-10


class BinnedData(NamedTuple):
    bins: torch.Tensor         # (R, C) packed in [0, F]; F = NA bucket
    split_points: np.ndarray   # (C, F-1) float32, NaN tails (model artifact)
    is_cat: np.ndarray         # (C,) bool
    nbins: int                 # histogram bucket count B
    fine_nbins: int            # fine grid F >= B (QuantilesGlobal: F == B)
    hist_type: str = "QuantilesGlobal"


def _quantile_split_points(m: torch.Tensor, nbins: int) -> torch.Tensor:
    """Per-column quantile split points from one batched sort (NaNs sort
    last).  ``probs * (cnt - 1)`` is computed in float32 before the
    truncation to int32, as in the reference."""
    xs, _ = torch.sort(m, dim=0)                         # NaNs last
    cnt = (~torch.isnan(m)).sum(dim=0).to(torch.int32)   # (C,)
    probs = torch.arange(1, nbins, dtype=torch.float32,
                         device=m.device) / nbins        # (B-1,)
    ranks = (probs[:, None] * (cnt[None, :] - 1).to(torch.float32)).to(
        torch.int32)
    ranks = torch.minimum(ranks.clamp_min(0),
                          (cnt - 1).clamp_min(0)[None, :])
    sp = torch.gather(xs, 0, ranks.long())               # (B-1, C)
    return sp.T.contiguous()                             # (C, B-1)


HISTOGRAM_TYPES = ("AUTO", "UniformAdaptive", "QuantilesGlobal", "Random")


def check_slice(algo: str, p: Dict) -> None:
    """Reject an unknown histogram type and a forest of no trees."""
    if str(p.get("histogram_type") or "AUTO") not in HISTOGRAM_TYPES:
        raise ValueError(f"{algo}: unknown histogram_type "
                         f"{p.get('histogram_type')!r}")
    if int(p["ntrees"]) < 1:
        raise ValueError(f"{algo}: ntrees must be >= 1")


def resolve_histogram_type(p: Dict) -> str:
    """AUTO means UniformAdaptive (reference DHistogram default).
    Random bins as UniformAdaptive; the engine shifts each node's bucket
    edges by random offsets."""
    ht = str(p.get("histogram_type") or "AUTO")
    return "UniformAdaptive" if ht == "AUTO" else ht


def _col_min_max(m: torch.Tensor):
    """Per-column (min, max) over non-NaN values; NaN for an all-NaN
    column (nanmin/nanmax of nothing)."""
    ok = ~torch.isnan(m)
    inf = torch.tensor(float("inf"), dtype=m.dtype, device=m.device)
    mn = torch.where(ok, m, inf).amin(dim=0)
    mx = torch.where(ok, m, -inf).amax(dim=0)
    empty = ~ok.any(dim=0)
    nan = torch.full_like(mn, float("nan"))
    return torch.where(empty, nan, mn), torch.where(empty, nan, mx)


def _uniform_split_points(col_min, col_max, is_cat, C: int,
                          F: int) -> np.ndarray:
    """The UniformAdaptive fine-grid thresholds from per-column (min,
    max): a float64 grid cast to float32, copied from the reference."""
    span = np.where(col_max > col_min, col_max - col_min, 1.0)
    sp = np.full((C, F - 1), np.nan, np.float32)
    grid = (np.arange(1, F, dtype=np.float64)[None, :] / F)
    vals = (col_min[:, None] + grid * span[:, None]).astype(np.float32)
    for j in range(C):
        if not is_cat[j]:
            sp[j] = vals[j]
    return sp


def prepare_bins(di: DataInfo, nbins: int, nbins_cats: int,
                 histogram_type: str = "QuantilesGlobal",
                 nbins_top_level: int = 1024) -> BinnedData:
    """Feature binning for the tree engine (reference DHistogram
    strategies).  Categorical columns bin by level code; B grows to the
    widest categorical's cardinality (up to ``nbins_cats``)."""
    fr, xs = di.frame, di.x
    C = len(xs)
    max_card = max([fr.vec(c).cardinality for c in di.cat_names] or [0])
    B = max(nbins, min(max_card, nbins_cats))
    is_cat = np.array([fr.vec(c).is_categorical for c in xs], bool)
    m = di.matrix()
    if histogram_type in ("UniformAdaptive", "Random"):
        F = max(int(nbins_top_level), B)
        mn, mx = _col_min_max(m)
        sp = _uniform_split_points(mn.cpu().numpy(), mx.cpu().numpy(),
                                   is_cat, C, F)
    elif histogram_type == "QuantilesGlobal":
        F = B
        sp_raw = _quantile_split_points(m, B).cpu().numpy()
        # dedupe per column (repeated quantiles collapse to one
        # threshold); categorical columns get no thresholds
        sp = np.full((C, B - 1), np.nan, np.float32)
        for j in range(C):
            if is_cat[j]:
                continue
            qs = np.unique(sp_raw[j][~np.isnan(sp_raw[j])])
            sp[j, : len(qs)] = qs
    else:
        raise ValueError(f"unknown histogram_type {histogram_type!r}")
    bins = bin_matrix(m, sp, is_cat, F)
    return BinnedData(bins, sp, is_cat, B, F, histogram_type)


def bin_matrix(m: torch.Tensor, split_points: np.ndarray,
               is_cat: np.ndarray, fine_nbins: int) -> torch.Tensor:
    """Raw values -> packed bins in [0, F], F = NA: the one binning entry
    that training and scoring share."""
    sp = torch.tensor(np.asarray(split_points, np.float32), device=m.device)
    cat = torch.tensor(np.asarray(is_cat, bool), device=m.device)
    return _bin_all(m, sp, cat, int(fine_nbins))


def _bin_all(m: torch.Tensor, split_points: torch.Tensor,
             is_cat: torch.Tensor, nbins: int) -> torch.Tensor:
    """bin = number of non-NaN thresholds <= value (thresholds are
    ascending with NaN tails); NaN -> nbins; categorical codes clip to
    [0, nbins-1].

    One ``searchsorted(right=True)`` per column serves both of the
    reference's branches (the (R, C, F-1) compare below 64 thresholds
    and the searchsorted above): on ascending thresholds both count
    the thresholds <= value.  NaN tails become +inf for the search, and
    the count is capped at the number of real thresholds."""
    if split_points.shape[1] == 0:
        num_bins = torch.zeros(m.shape, dtype=torch.int32, device=m.device)
    else:
        nan_t = torch.isnan(split_points)
        t = torch.where(nan_t, torch.full_like(split_points, float("inf")),
                        split_points).contiguous()
        num_bins = torch.searchsorted(t, m.T.contiguous(), right=True,
                                      out_int32=True).T
        n_valid = (split_points.shape[1] - nan_t.sum(dim=1)).to(torch.int32)
        num_bins = torch.minimum(num_bins, n_valid[None, :])
    nan_v = torch.isnan(m)
    cat_bins = torch.where(nan_v, torch.zeros_like(m), m).clamp(
        0, nbins - 1).to(torch.int32)
    b = torch.where(is_cat[None, :], cat_bins, num_bins)
    b = torch.where(nan_v, torch.full_like(b, nbins), b)
    return cast_bins(b, nbins).contiguous()


def forest_output(di: DataInfo, binned: BinnedData, tf, depth: int,
                  response_domain, prior: Optional[Dict] = None) -> Dict:
    """The model-output fields both tree builders write, as host arrays:
    the binning, the forest's trees (``child`` None for the dense heap)
    and the frame's domains.  With ``prior``, a checkpoint's output, its
    trees come first and its ``varimp`` and per-node arrays (``thr_bin``,
    ``na_left``, ``node_gain``, ``node_w``) are carried;
    ``driver.run_tree_driver`` adds the new trees' importance and node
    arrays."""
    def host(a):
        return a.cpu().numpy() if a is not None else None

    fr = di.frame
    out = dict(
        x=list(di.x), split_points=binned.split_points, is_cat=binned.is_cat,
        nbins=binned.nbins, fine_nbins=binned.fine_nbins,
        hist_type=binned.hist_type, split_col=host(tf.split_col),
        bitset=host(tf.bitset), value=host(tf.value), child=host(tf.child),
        varimp=None, thr_bin=None, na_left=None, node_gain=None,
        node_w=None, max_depth=depth,
        response_domain=response_domain,
        domains={c: list(fr.vec(c).domain) for c in di.cat_names},
        ntrees_actual=int(tf.split_col.shape[0]))
    if prior is not None:
        for k in ("split_col", "bitset", "value", "child"):
            if out[k] is not None:
                out[k] = np.concatenate([np.asarray(prior[k]), out[k]])
        for k in ("varimp", "thr_bin", "na_left", "node_gain", "node_w"):
            if prior.get(k) is not None:
                out[k] = np.asarray(prior[k])
        out["ntrees_actual"] += int(prior["ntrees_actual"])
    return out


# -- split finding -------------------------------------------------------------

def find_splits(hist: torch.Tensor, is_cat: torch.Tensor,
                col_allowed: torch.Tensor, min_rows: float = 10.0,
                min_split_improvement: float = 1e-5,
                mono: Optional[torch.Tensor] = None, use_mono: bool = False,
                newton: bool = False, reg_lambda: float = 0.0) -> Dict:
    """Best split per leaf from (L, C, B+1, 4) float32 histograms.

    Returns per-leaf do_split, gain, col, bitset (B+1 left membership
    incl. the NA bit), split_b, na_left, and the leaf's own and its
    children's (w, wg, wh, wgg) stats.  Numeric bins keep their natural
    order, categorical bins sort by mean gradient with a STABLE sort
    (empty bins last, ties in bin order) as ``jnp.argsort`` does, and the
    best of the (C, B, 2) candidates is the first maximum in that
    flattening order.

    ``mono`` ((C,) int, +1/-1/0) with ``use_mono`` rejects candidates
    whose child values go against the column's declared direction
    (increasing: right >= left); the values are the Newton steps
    wg / (wh + reg_lambda), or the means wg / w without ``newton``.  The
    engine also clamps the child values to the parent's bounds."""
    if not hist.dtype.is_floating_point:
        raise TypeError("find_splits needs a float32 histogram table")
    L, C, B1, _ = hist.shape
    B = B1 - 1
    w, wg, wgg, wh = (hist[..., k] for k in range(4))
    dev = hist.device

    mean = wg[..., :B] / torch.clamp_min(w[..., :B], EPS)
    empty = w[..., :B] <= 0
    key = torch.where(empty, torch.full_like(mean, float("inf")), mean)
    natural = torch.arange(B, dtype=torch.float32,
                           device=dev)[None, None, :].expand(L, C, B)
    order = torch.argsort(torch.where(is_cat[None, :, None], key, natural),
                          dim=2, stable=True)                  # (L, C, B)

    # the four stats sorted and scanned together, in XLA's CPU prefix-sum
    # order on every device (ties between candidates then break as the
    # reference breaks them)
    sorted4 = torch.gather(hist[..., :B, :].permute(3, 0, 1, 2), 3,
                           order.expand(4, L, C, B))
    cw, cwg, cwgg, cwh = cumsum(sorted4).unbind(0)
    naw, nawg, nawgg, nawh = (x[..., B] for x in (w, wg, wgg, wh))
    tot_w = cw[..., -1] + naw
    tot_wg = cwg[..., -1] + nawg
    tot_wgg = cwgg[..., -1] + nawgg
    tot_wh = cwh[..., -1] + nawh

    def se(w_, wg_, wgg_):
        return wgg_ - wg_ ** 2 / torch.clamp_min(w_, EPS)

    se_parent = se(tot_w, tot_wg, tot_wgg)                     # (L, C)
    neg_inf = torch.tensor(float("-inf"), dtype=hist.dtype, device=dev)

    def side_gain(na_left: bool):
        lw = cw + naw[..., None] if na_left else cw
        lwg = cwg + nawg[..., None] if na_left else cwg
        lwgg = cwgg + nawgg[..., None] if na_left else cwgg
        rw = tot_w[..., None] - lw
        rwg = tot_wg[..., None] - lwg
        rwgg = tot_wgg[..., None] - lwgg
        gain = se_parent[..., None] - se(lw, lwg, lwgg) - se(rw, rwg, rwgg)
        ok = (lw >= min_rows) & (rw >= min_rows)
        if use_mono:
            if newton:
                lwh = cwh + nawh[..., None] if na_left else cwh
                rwh = tot_wh[..., None] - lwh
                lv = lwg / torch.clamp_min(lwh + reg_lambda, EPS)
                rv = rwg / torch.clamp_min(rwh + reg_lambda, EPS)
            else:
                lv = lwg / torch.clamp_min(lw, EPS)
                rv = rwg / torch.clamp_min(rw, EPS)
            m = mono[None, :, None].to(hist.dtype)
            ok = ok & ((m == 0) | (m * (rv - lv) >= 0))
        return torch.where(ok, gain, neg_inf)

    gains = torch.stack([side_gain(False), side_gain(True)], dim=-1)
    # candidate axis (L, C, B, 2): split index B-1 sends everything left,
    # which never passes min_rows on the right, so it self-eliminates
    gains = torch.where(col_allowed[..., None, None], gains, neg_inf)
    flat = gains.reshape(L, -1)
    best = torch.argmax(flat, dim=1)
    best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
    col = torch.div(best, B * 2, rounding_mode="floor")
    rem = best % (B * 2)
    split_b = torch.div(rem, 2, rounding_mode="floor")
    na_left = (rem % 2).bool()

    thresh = torch.clamp_min(
        min_split_improvement *
        torch.clamp_min(se_parent, 0.0).amax(dim=1), EPS)
    do_split = best_gain > thresh

    li = torch.arange(L, device=dev)
    order_c = order[li, col]                                    # (L, B)
    rank = torch.argsort(order_c, dim=1)                        # inverse perm
    bitset_bins = rank <= split_b[:, None]
    bitset = torch.cat([bitset_bins, na_left[:, None]], dim=1)

    zero = torch.zeros((), dtype=hist.dtype, device=dev)

    def pick(cum, na):
        return cum[li, col, split_b] + torch.where(na_left, na[li, col], zero)

    lw, lwg, lwh = pick(cw, naw), pick(cwg, nawg), pick(cwh, nawh)
    lwgg = pick(cwgg, nawgg)
    leaf_stats = dict(w=tot_w[li, col], wg=tot_wg[li, col],
                      wh=tot_wh[li, col], wgg=tot_wgg[li, col])
    left_stats = dict(w=lw, wg=lwg, wh=lwh, wgg=lwgg)
    right_stats = dict(w=leaf_stats["w"] - lw, wg=leaf_stats["wg"] - lwg,
                       wh=leaf_stats["wh"] - lwh,
                       wgg=leaf_stats["wgg"] - lwgg)
    return dict(do_split=do_split, gain=best_gain, col=col.to(torch.int32),
                bitset=bitset, split_b=split_b.to(torch.int32),
                na_left=na_left, leaf=leaf_stats, left=left_stats,
                right=right_stats)


# -- forest scoring ------------------------------------------------------------

def _go_left(bs, node, b, th, na, fine_na: int, B: int):
    """thr >= 0: adaptive numeric threshold in fine-bin units (NA routed
    by ``na``); thr < 0: bitset membership (categorical splits, and
    every QuantilesGlobal split)."""
    nb = torch.clamp_max(b, B)                      # NA (fine_na) -> slot B
    gl = bs[node, nb.long()]
    if th is None:
        return gl
    tn = th[node]
    return torch.where(tn >= 0,
                       torch.where(b == fine_na, na[node], b < tn), gl)


def tree_predict(bins: torch.Tensor, split_col, bitset, value, depth: int,
                 child=None, thr=None, na_l=None,
                 fine_na: int = -1) -> torch.Tensor:
    """Descend one tree for every row: (R,) node values
    (``jit_engine._tree_predict``, gather branch).  ``child`` None = dense
    heap (children at 2n+1/2n+2), else left-child pool pointers (right =
    left + 1; -1 = no children)."""
    R = bins.shape[0]
    B = bitset.shape[-1] - 1
    node = torch.zeros(R, dtype=torch.long, device=bins.device)
    for _ in range(depth):
        c = split_col[node]
        term = c < 0
        b = widen_bins(torch.gather(bins, 1, c.clamp_min(0).long()[:, None])
                       [:, 0])
        go_left = _go_left(bitset, node, b, thr, na_l, fine_na, B)
        if child is None:
            nxt = 2 * node + torch.where(go_left, 1, 2)
        else:
            left = child[node].long()
            term = term | (left < 0)
            nxt = left + torch.where(go_left, 0, 1)
        node = torch.where(term, node, nxt)
    return value[node]


def forest_tree_values(bins, split_col, bitset, value, depth: int,
                       child=None, thr=None, na_l=None, fine_na: int = -1):
    """Per-tree outputs (T, K, R) of a forest of (T, K, H) node arrays."""
    T, K, H = split_col.shape
    out = torch.empty((T * K, bins.shape[0]), dtype=value.dtype,
                      device=bins.device)
    sc, vl = split_col.reshape(T * K, H), value.reshape(T * K, H)
    bs = bitset.reshape(T * K, H, -1)
    th = thr.reshape(T * K, H) if thr is not None else None
    na = na_l.reshape(T * K, H) if thr is not None else None
    ch = child.reshape(T * K, H) if child is not None else None
    for i in range(T * K):
        out[i] = tree_predict(bins, sc[i], bs[i], vl[i], depth,
                              child=ch[i] if ch is not None else None,
                              thr=th[i] if th is not None else None,
                              na_l=na[i] if na is not None else None,
                              fine_na=fine_na)
    return out.reshape(T, K, -1)


def forest_score(bins, split_col, bitset, value, depth: int, child=None,
                 thr=None, na_l=None, fine_na: int = -1) -> torch.Tensor:
    """Sum of tree outputs per (row, k-slot): (R, K).  One descent
    implementation only (``forest_tree_values``), so scoring and staged
    predictions cannot diverge; the trees are summed in the order the
    reference's ``jnp.sum`` takes on the CPU (``xlamath.sum_leading``)."""
    vals = forest_tree_values(bins, split_col, bitset, value, depth,
                              child=child, thr=thr, na_l=na_l,
                              fine_na=fine_na)
    return sum_leading(vals).T


def model_fine_na(out: Dict) -> int:
    """NA bin sentinel of a model's binning (fine grid when adaptive)."""
    return int(out.get("fine_nbins") or out["nbins"])


def _forest_args(out: Dict, dev, trees=slice(None)) -> Dict:
    """A model-output dict's forest (the iterations ``trees``) as the
    keyword arguments of ``forest_tree_values``, on ``dev``."""
    def t(a):
        return torch.tensor(np.asarray(a)[trees], device=dev)

    thr, child = out.get("thr_bin"), out.get("child")
    return dict(split_col=t(out["split_col"]), bitset=t(out["bitset"]),
                value=t(out["value"]),
                child=t(child) if child is not None else None,
                thr=t(thr) if thr is not None else None,
                na_l=t(out["na_left"]) if thr is not None else None,
                fine_na=model_fine_na(out) if thr is not None else -1)


def forest_score_out(bins: torch.Tensor, out: Dict,
                     depth: Optional[int] = None) -> torch.Tensor:
    """forest_score over a model-output dict of host arrays (dense heap,
    or pool layout when ``out["child"]`` is set)."""
    return forest_score(bins, depth=int(depth if depth is not None
                                        else out["max_depth"]),
                        **_forest_args(out, bins.device))


_FOREST_KEYS = ("split_col", "bitset", "value", "child", "thr_bin",
                "na_left")


def model_bins(model, m: torch.Tensor) -> torch.Tensor:
    """``bin_matrix`` of a model's binning, its split points and
    categorical flags read from the model's device-constant cache."""
    out, dev = model.output, model.device

    def upload(sp, cat):
        return (torch.tensor(np.asarray(sp, np.float32), device=dev),
                torch.tensor(np.asarray(cat, bool), device=dev))
    sp, cat = model.device_const("bins", (out["split_points"],
                                          out["is_cat"]), upload)
    return _bin_all(m, sp, cat, model_fine_na(out))


def forest_score_model(bins: torch.Tensor, model) -> torch.Tensor:
    """``forest_score_out`` of a model's whole forest, its node arrays
    read from the model's device-constant cache."""
    out = model.output
    args = model.device_const(
        "forest", tuple(out.get(k) for k in _FOREST_KEYS),
        lambda *_: _forest_args(out, model.device))
    return forest_score(bins, depth=int(out["max_depth"]), **args)


def forest_accumulate(F: torch.Tensor, bins: torch.Tensor, out: Dict,
                      depth: int) -> torch.Tensor:
    """``F`` plus a model's trees added one iteration at a time in tree
    order, as training adds them, so a build resumed from a checkpoint
    carries bit for bit the F of the build that was not interrupted."""
    for t in range(np.asarray(out["split_col"]).shape[0]):
        vals = forest_tree_values(bins, depth=depth,
                                  **_forest_args(out, bins.device,
                                                 slice(t, t + 1)))
        F = F + vals[0].T
    return F
