"""Dense-heap tree engine — port of ``h2o_tpu/models/tree/jit_engine.py``
(``plan_engine`` :87-94, adaptive helpers :114-185, ``_node_val`` and
sibling subtraction :258-303, ``build_tree_traced`` :306-489,
``_tree_predict`` :708-773 in its gather form, and the GBM path of
``_train_forest_impl`` :916-1082).

The reference traces the whole forest into one XLA program (levels
unrolled, trees a ``lax.scan``).  Here the same steps run eagerly:
level and tree loops are Python loops over device tensors, so on the
card every histogram is one launch of the kernels in
``ops/hist_kernels.py`` and nothing waits on the host until the forest
is finished.  Level d of a tree has exactly L = 2^d leaves; node n's
children sit at 2n+1 and 2n+2.

Left out on purpose: the matmul router ``_mm_route_level``
(``jit_engine.py:188-255``), which works around per-row gathers on the
TPU — a GPU gathers natively.  Not in this slice (each raises
``NotImplementedError`` in ``gbm.py``): row and column sampling,
``Random`` histograms, quantized stats in training, monotone
constraints, the sparse-frontier engine for depths beyond the dense
cap, and every mode but ``gbm`` with gaussian or bernoulli.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from h2o_tpu_torch.models.distributions import get_distribution
from h2o_tpu_torch.models.tree.shared_tree import find_splits, tree_predict
from h2o_tpu_torch.ops.binpack import widen_bins
from h2o_tpu_torch.ops.histogram import histogram_build

EPS = 1e-10
#: frontier width cap of the reference (H2O_TPU_MAX_LIVE_LEAVES default)
MAX_LIVE_LEAVES = 4096


def plan_engine(depth: int) -> int:
    """0 = dense heap (every level fits the frontier cap), else the cap
    the sparse-frontier engine would run with."""
    if depth < 1 or 2 ** (depth - 1) <= MAX_LIVE_LEAVES:
        return 0
    return MAX_LIVE_LEAVES


def _floor_div(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _numeric_thr(s: Dict, lo, hi, off, B: int) -> torch.Tensor:
    """Chosen bucket boundary -> exact fine-bin threshold: go-left is
    bucket(x) < k  <=>  x < lo + ceil((k*span - off)/B)."""
    li = torch.arange(lo.shape[0], device=lo.device)
    colc = s["col"].long()
    lo_c, hi_c, o_c = lo[li, colc], hi[li, colc], off[li, colc]
    span = (hi_c - lo_c + 1).clamp_min(1)
    k = s["split_b"] + 1
    return lo_c + _floor_div(k * span - o_c + B - 1, B)


def _refine_ranges(hist, lo, hi, off, B: int):
    """Tighten each (leaf, column) fine range to the sub-range its
    non-empty buckets cover (per-node min/max for every column)."""
    have = hist[..., 0][:, :, :B] > 0                 # (L, C, B)
    anyb = have.any(dim=2)
    hv = have.to(torch.int8)
    first = torch.argmax(hv, dim=2).to(torch.int32)
    last = (B - 1 - torch.argmax(torch.flip(hv, dims=[2]), dim=2)).to(
        torch.int32)
    span = (hi - lo + 1).clamp_min(1)
    lo_edge = lo + _floor_div(first * span - off + B - 1, B).clamp_min(0)
    hi_edge = lo + torch.minimum(
        _floor_div((last + 1) * span - off + B - 1, B).clamp_min(1),
        span) - 1
    new_lo = torch.where(anyb, lo_edge, lo)
    new_hi = torch.where(anyb, torch.maximum(hi_edge, lo_edge), hi)
    return new_lo, new_hi


def _child_ranges(new_lo, new_hi, s: Dict, thr_leaf, is_cat, do_split):
    """Children inherit the refined range; the split column is cut at
    the threshold (left [lo, thr-1], right [thr, hi]).  (2L, C),
    interleaved left/right."""
    L, C = new_lo.shape
    li = torch.arange(L, device=new_lo.device)
    colc = s["col"].long()
    num_split = do_split & ~is_cat[colc]
    big = 1 << 28
    lo2 = torch.stack([new_lo, new_lo], dim=1).reshape(2 * L, C)
    hi2 = torch.stack([new_hi, new_hi], dim=1).reshape(2 * L, C)
    thr_hi = torch.where(num_split, thr_leaf - 1,
                         torch.full_like(thr_leaf, big))
    thr_lo = torch.where(num_split, thr_leaf,
                         torch.full_like(thr_leaf, -big))
    # (2*li, colc) and (2*li+1, colc) are distinct cells per leaf, so
    # plain indexed writes equal the reference's scatter-min/max
    hi2[2 * li, colc] = torch.minimum(hi2[2 * li, colc], thr_hi)
    lo2[2 * li + 1, colc] = torch.maximum(lo2[2 * li + 1, colc], thr_lo)
    lo2 = torch.minimum(lo2, hi2)
    return lo2, hi2


def _node_val(wg, wh, w, newton: bool):
    denom = torch.clamp_min(wh if newton else w, EPS)
    return wg / denom


def _hist_level_with_sibling(bins, slot, stats, L: int, B: int, bf16: bool,
                             parent_hist, parent_split):
    """Level-d histograms by sibling subtraction: build the L/2 LEFT
    children only (slots 2p) and derive each right child as parent minus
    left, masked to parents that split."""
    half = L // 2
    left_slot = torch.where((slot >= 0) & (slot % 2 == 0),
                            _floor_div(slot, 2), torch.full_like(slot, -1))
    left = histogram_build(bins, left_slot, stats, half, B, bf16=bf16)
    right = torch.where(parent_split[:, None, None, None],
                        parent_hist - left, torch.zeros_like(left))
    return torch.stack([left, right], dim=1).reshape(L, *left.shape[1:])


class Tree(NamedTuple):
    split_col: torch.Tensor   # (H,) int32, -1 = terminal
    bitset: torch.Tensor      # (H, B+1) bool
    value: torch.Tensor       # (H,) float32
    varimp: torch.Tensor      # (C,) float32
    thr_bin: torch.Tensor     # (H,) int32 adaptive numeric threshold
    na_left: torch.Tensor     # (H,) bool NA direction of thr splits


def build_tree(bins: torch.Tensor, stats: torch.Tensor, leaf0: torch.Tensor,
               is_cat: torch.Tensor, cfg: Dict) -> Tree:
    """One tree, level by level (``build_tree_traced``).  ``cfg`` keys:
    max_depth, nbins, newton, min_rows, min_split_improvement, bf16,
    adaptive, fine_nbins.  Global-grid levels below the root histogram
    their left children only (sibling subtraction)."""
    D = cfg["max_depth"]
    B = cfg["nbins"]
    C = bins.shape[1]
    H = 2 ** (D + 1) - 1
    dev = bins.device
    newton = cfg["newton"]
    bf16 = cfg["bf16"]

    split_col = torch.full((H,), -1, dtype=torch.int32, device=dev)
    bitset = torch.zeros((H, B + 1), dtype=torch.bool, device=dev)
    value = torch.zeros(H, dtype=torch.float32, device=dev)
    varimp = torch.zeros(C, dtype=torch.float32, device=dev)
    thr_arr = torch.full((H,), -1, dtype=torch.int32, device=dev)
    na_arr = torch.zeros(H, dtype=torch.bool, device=dev)
    leaf = leaf0

    adaptive = cfg["adaptive"]
    F = int(cfg["fine_nbins"] or B)
    if adaptive:
        rlo = torch.zeros((1, C), dtype=torch.int32, device=dev)
        rhi = torch.full((1, C), F - 1, dtype=torch.int32, device=dev)
    prev_hist = prev_do = None
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for d in range(D):
        L = 2 ** d
        off = L - 1
        # halving schedule: F buckets at the root down to B
        Bd = max(B, F >> d) if adaptive else B
        if adaptive:
            # UniformAdaptive draws no bucket offsets (Random is out of
            # this slice)
            roff = torch.zeros((L, C), dtype=torch.int32, device=dev)
            hist = histogram_build(bins, leaf, stats, L, Bd, bf16=bf16,
                                   fine_map=(rlo, rhi, roff, is_cat, F))
        elif d >= 1:
            # sibling subtraction needs identical bucket edges for parent
            # and children: global-grid binning only
            hist = _hist_level_with_sibling(bins, leaf, stats, L, B, bf16,
                                            prev_hist, prev_do)
        else:
            hist = histogram_build(bins, leaf, stats, L, B, bf16=bf16)
        col_allowed = torch.ones((L, C), dtype=torch.bool, device=dev)
        s = find_splits(hist, is_cat, col_allowed,
                        min_rows=cfg["min_rows"],
                        min_split_improvement=cfg["min_split_improvement"],
                        newton=newton)
        live = s["leaf"]["w"] > 0
        do_split = s["do_split"] & live
        term = live & ~do_split
        leaf_vals = _node_val(s["leaf"]["wg"], s["leaf"]["wh"],
                              s["leaf"]["w"], newton)
        lvals = _node_val(s["left"]["wg"], s["left"]["wh"],
                          s["left"]["w"], newton)
        rvals = _node_val(s["right"]["wg"], s["right"]["wh"],
                          s["right"]["w"], newton)
        colc = s["col"].long()
        gain_pos = torch.where(do_split, s["gain"].clamp_min(0.0), zero)
        varimp.index_add_(0, colc, gain_pos)
        split_col[off:off + L] = torch.where(do_split, s["col"],
                                             torch.full_like(s["col"], -1))
        cat_choice = is_cat[colc]
        if adaptive:
            thr_leaf = _numeric_thr(s, rlo, rhi, roff, Bd)
            num_split = do_split & ~cat_choice
            thr_arr[off:off + L] = torch.where(num_split, thr_leaf,
                                               torch.full_like(thr_leaf, -1))
            na_arr[off:off + L] = num_split & s["na_left"]
            # numeric nodes carry the fine threshold; categorical codes
            # live in the first B buckets whatever Bd is: keep [:B] + NA
            bset_store = torch.cat([s["bitset"][:, :B],
                                    s["bitset"][:, Bd:Bd + 1]], dim=1)
            bset_w = bset_store & (do_split & cat_choice)[:, None]
        else:
            thr_leaf = None
            bset_w = s["bitset"] & do_split[:, None]
        bitset[off:off + L] = bset_w
        value[off:off + L] = torch.where(term, leaf_vals, zero)
        # pre-write child values (interleaved left/right) at level d+1
        child_vals = torch.stack([lvals, rvals], dim=1).reshape(2 * L)
        child_mask = do_split.repeat_interleave(2)
        coff = 2 * L - 1
        value[coff:coff + 2 * L] = torch.where(
            child_mask, child_vals, value[coff:coff + 2 * L])

        # route rows
        active = leaf >= 0
        lf = leaf.clamp_min(0).long()
        c = colc[lf]
        b = widen_bins(torch.gather(bins, 1, c[:, None])[:, 0])
        if adaptive:
            gset = s["bitset"][lf, torch.clamp_max(b, Bd).long()]
            gthr = torch.where(b == F, s["na_left"][lf], b < thr_leaf[lf])
            go_left = torch.where(cat_choice[lf], gset, gthr)
        else:
            go_left = s["bitset"][lf, b.long()]
        do_lf = do_split[lf]
        child = (2 * lf + torch.where(go_left, 0, 1)).to(torch.int32)
        leaf = torch.where(active & do_lf, child,
                           torch.where(active, torch.full_like(leaf, -1),
                                       leaf))
        if adaptive and d + 1 < D:
            new_lo, new_hi = _refine_ranges(hist, rlo, rhi, roff, Bd)
            rlo, rhi = _child_ranges(new_lo, new_hi, s, thr_leaf, is_cat,
                                     do_split)
        prev_hist, prev_do = hist, do_split
    return Tree(split_col, bitset, value, varimp, thr_arr, na_arr)


class TrainedForest(NamedTuple):
    split_col: torch.Tensor   # (T, K, H)
    bitset: torch.Tensor      # (T, K, H, B+1)
    value: torch.Tensor       # (T, K, H)
    varimp: torch.Tensor      # (C,)
    thr_bin: torch.Tensor     # (T, K, H)
    na_left: torch.Tensor     # (T, K, H)


def train_forest(bins: torch.Tensor, yv: torch.Tensor, w: torch.Tensor,
                 active: torch.Tensor, F0: torch.Tensor,
                 is_cat: torch.Tensor, *, dist_name: str, ntrees: int,
                 max_depth: int, nbins: int, newton: bool,
                 learn_rate: float, learn_rate_annealing: float,
                 min_rows: float, min_split_improvement: float,
                 bf16: bool = False, adaptive: bool = False,
                 fine_nbins: int = 0) -> TrainedForest:
    """GBM boosting (``_train_forest_impl`` with mode="gbm", K=1, every
    row sampled, every column allowed, float32 stats; ntrees >= 1): per
    tree, stats
    (w, w*g, w*g^2, w*h) from the distribution's gradient at the current
    F, one tree, F += learn_rate * tree."""
    cfg = dict(max_depth=max_depth, nbins=nbins, newton=newton,
               min_rows=min_rows, min_split_improvement=min_split_improvement,
               bf16=bf16, adaptive=adaptive, fine_nbins=fine_nbins)
    dev = bins.device
    dist = get_distribution(dist_name)
    wa = torch.where(active, w, torch.zeros_like(w))
    leaf0 = torch.where(active, 0, -1).to(torch.int32)
    fine_na = int(fine_nbins or nbins)
    lr = torch.tensor(learn_rate, dtype=torch.float32, device=dev)
    ann = torch.tensor(learn_rate_annealing, dtype=torch.float32, device=dev)
    F = F0
    trees = []
    for t in range(ntrees):
        f = F[:, 0]
        g = torch.nan_to_num(dist.gradient(yv, f))
        h = torch.nan_to_num(dist.hessian(yv, f))
        stats = torch.stack([wa, wa * g, wa * g * g, wa * h], dim=1)
        tree = build_tree(bins, stats, leaf0, is_cat, cfg)
        scale = lr * ann ** torch.tensor(float(t), dtype=torch.float32,
                                         device=dev)
        value = tree.value * scale
        trees.append(tree._replace(value=value))
        F = F + tree_predict(bins, tree.split_col, tree.bitset, value,
                             max_depth, thr=tree.thr_bin, na_l=tree.na_left,
                             fine_na=fine_na)[:, None]

    def stack(name):
        return torch.stack([getattr(tr, name) for tr in trees])[:, None]

    varimp = torch.stack([tr.varimp for tr in trees]).sum(dim=0)
    return TrainedForest(stack("split_col"), stack("bitset"), stack("value"),
                         varimp, stack("thr_bin"), stack("na_left"))
