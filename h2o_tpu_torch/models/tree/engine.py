"""Tree engines — port of ``h2o_tpu/models/tree/jit_engine.py``
(``clamp_depth``/``plan_engine``/``frontier_plan``/``pool_size``
:70-111, adaptive helpers :114-185, ``_node_val`` and sibling
subtraction :258-303, the dense ``build_tree_traced`` :306-489, the
sparse-frontier ``build_tree_frontier`` :492-705, and
``_train_forest_impl`` :916-1082, K class trees an iteration).

The reference traces the whole forest into one XLA program (levels
unrolled, trees a ``lax.scan``).  Here the same steps run eagerly:
level and tree loops are Python loops over device tensors, so on the
card every histogram is one launch of the kernels in
``ops/hist_kernels.py`` and nothing waits on the host until the forest
is finished.

Two engines, one output contract.  The dense heap gives level d exactly
L = 2^d leaves, node n's children at 2n+1 and 2n+2.  The sparse
frontier caps the live leaves of a level at ``kleaves``: when a level's
split children outnumber the cap, those with the largest residual
impurity (wgg - wg^2/w) stay live and the rest finish as leaves; nodes
sit in a pool with an explicit left-child pointer (right = left + 1).
Below the cap both build the same trees.

Randomness follows the reference's key order exactly (``ops/prng.py``
reproduces jax's threefry bits): iteration t, counted from the
forest's first tree, takes ``fold_in(master, t)`` and splits it into
(rows, class, tree-columns) keys; class k of the
iteration splits the running class key into (next class key, tree key),
in class order; each adaptive level splits the tree key once for its
``Random`` offsets (drawn or not), and a column-sampled level once more
for its (L, C) draw.  Keys are derived on the host; only the draws run
on the device.

A multinomial GBM grows K class trees an iteration on softmax gradients
from the iteration's starting F, scales their leaves by (K-1)/K and
updates F once after all K; a multiclass DRF grows one tree per class on
the 0/1 indicator.  Monotone constraints reject violating splits
(``find_splits``) and clamp node values to bounds that each split narrows
at the midpoint of its children's values; ``reg_lambda`` enters the
Newton denominator.

Every tree also carries its nodes' split gains (``node_gain``, clamped
at 0; 0 where a node does not split) and training covers (``node_w``,
the node's weight, children's covers pre-written from their parent's
split), as the reference's engines emit them for TreeSHAP.

Left out on purpose: the matmul router ``_mm_route_level``
(``jit_engine.py:188-255``), which works around per-row gathers on the
TPU — a GPU gathers natively.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch

from h2o_tpu_torch.models.distributions import Distribution
from h2o_tpu_torch.models.tree.shared_tree import find_splits, tree_predict
from h2o_tpu_torch.ops import prng, statpack
from h2o_tpu_torch.ops.binpack import widen_bins
from h2o_tpu_torch.ops.histogram import histogram_build
from h2o_tpu_torch.ops.segment import scatter_add

EPS = 1e-10
#: frontier width cap the builders run with (the reference's
#: H2O_TPU_MAX_LIVE_LEAVES default)
MAX_LIVE_LEAVES = 4096
#: depth cap (the reference's H2O_TPU_MAX_TREE_DEPTH default)
MAX_TREE_DEPTH = 30


def clamp_depth(requested: int) -> int:
    """A requested max_depth, capped at ``MAX_TREE_DEPTH``."""
    return min(int(requested), MAX_TREE_DEPTH)


def plan_engine(depth: int) -> int:
    """0 = dense heap (every level fits the frontier cap), else the cap
    the sparse-frontier engine runs with."""
    if depth < 1 or 2 ** (depth - 1) <= MAX_LIVE_LEAVES:
        return 0
    return MAX_LIVE_LEAVES


def frontier_plan(depth: int, cap: int) -> List[int]:
    """Live-frontier width per level: doubles until the cap."""
    widths, width = [], 1
    for _ in range(depth):
        widths.append(width)
        width = min(2 * width, cap)
    return widths


def pool_size(depth: int, kleaves: int) -> int:
    """Node slots of one tree: the dense heap when kleaves == 0, else the
    root and two child slots per frontier node that may split."""
    if kleaves <= 0:
        return 2 ** (depth + 1) - 1
    return 1 + 2 * sum(frontier_plan(depth, kleaves))


def select_frontier(ckey: torch.Tensor, L_next: int, base: int, N: int):
    """The next level's live leaves from the 2L split children's keys
    (-inf where no child is): all of them while they fit, else the
    ``L_next`` largest in ``lax.top_k``'s order (ties to the lower
    index).  Returns the selected children's pool ids (``base`` + child,
    or the trash slot ``N`` where a slot stays empty), the selection, and
    each child's next-level slot (-1 off the frontier)."""
    dev = ckey.device
    n = ckey.shape[0]
    if n <= L_next:
        sel = torch.arange(n, device=dev)            # identity: dense
    else:
        sel = torch.sort(ckey, descending=True, stable=True).indices[:L_next]
    sel_valid = ckey[sel] > float("-inf")
    frontier = torch.where(sel_valid, base + sel, torch.full_like(sel, N))
    inv = torch.full((n,), -1, dtype=torch.int32, device=dev)
    inv[sel] = torch.where(sel_valid, torch.arange(
        sel.shape[0], dtype=torch.int32, device=dev), -1).to(torch.int32)
    return frontier, sel, inv


def _floor_div(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _rand_offsets(key, L: int, C: int, lo, hi,
                  random_mode: bool) -> torch.Tensor:
    """Random-histogram bucket offsets in fine units, per (leaf, col):
    every node's bucket boundaries shift by a random fraction of a
    bucket (truncated toward zero, as the reference's cast)."""
    if not random_mode:
        return torch.zeros((L, C), dtype=torch.int32, device=lo.device)
    span = (hi - lo + 1).clamp_min(1)
    u = prng.uniform(key, (L, C), lo.device)
    return torch.minimum((u * span.to(torch.float32)).to(torch.int32),
                         span - 1)


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


def _node_val(wg, wh, w, newton: bool, reg_lambda: float = 0.0):
    if not newton:
        return wg / torch.clamp_min(w, EPS)
    # only XGBoost sets reg_lambda; 0 adds no operation to a level
    return wg / torch.clamp_min(wh + reg_lambda if reg_lambda else wh, EPS)


def _mono_bounds(vals, s: Dict, mono, bounds):
    """Clamp (leaf, left, right) values to the leaves' bounds and derive
    the children's, interleaved left/right (2L): an increasing column
    caps the left child and floors the right one at the midpoint of the
    two children's values, a decreasing one the other way round."""
    lo_b, hi_b = bounds
    leaf_vals, lvals, rvals = (torch.clamp(v, lo_b, hi_b) for v in vals)
    m = mono[s["col"].long()].to(torch.float32)
    mid = 0.5 * (lvals + rvals)
    l_hi = torch.where(m > 0, torch.minimum(hi_b, mid), hi_b)
    r_lo = torch.where(m > 0, torch.maximum(lo_b, mid), lo_b)
    l_lo = torch.where(m < 0, torch.maximum(lo_b, mid), lo_b)
    r_hi = torch.where(m < 0, torch.minimum(hi_b, mid), hi_b)
    child_b = (torch.stack([l_lo, r_lo], dim=1).reshape(-1),
               torch.stack([l_hi, r_hi], dim=1).reshape(-1))
    return (leaf_vals, lvals, rvals), child_b


def _root_bounds(dev):
    return (torch.full((1,), float("-inf"), device=dev),
            torch.full((1,), float("inf"), device=dev))


def _hist_level_with_sibling(bins, slot, stats, L: int, B: int, bf16: bool,
                             parent_hist, parent_split):
    """Level-d histograms by sibling subtraction: build the L/2 LEFT
    children only (slots 2p) and derive each right child as parent minus
    left, masked to parents that split.  Exact on the int32 tables of
    quantized stats."""
    half = L // 2
    left_slot = torch.where((slot >= 0) & (slot % 2 == 0),
                            _floor_div(slot, 2), torch.full_like(slot, -1))
    left = histogram_build(bins, left_slot, stats, half, B, bf16=bf16)
    right = torch.where(parent_split[:, None, None, None],
                        parent_hist - left, torch.zeros_like(left))
    return torch.stack([left, right], dim=1).reshape(L, *left.shape[1:])


class _Level(NamedTuple):
    """One level's splits, shared by both engines."""
    hist: torch.Tensor        # table as built (int32 when quantized)
    hist_f: torch.Tensor      # float32 table split finding read
    s: Dict                   # find_splits output
    do_split: torch.Tensor
    term: torch.Tensor
    leaf_vals: torch.Tensor
    lvals: torch.Tensor
    rvals: torch.Tensor
    gain_pos: torch.Tensor
    cat_choice: torch.Tensor
    thr_leaf: Optional[torch.Tensor]
    split_col: torch.Tensor   # per-leaf node payloads to store
    bitset: torch.Tensor
    thr_bin: torch.Tensor
    na_left: torch.Tensor
    Bd: int
    roff: Optional[torch.Tensor]
    child_b: Optional[tuple]  # children's monotone (lo, hi) bounds, (2L,)


def _grow_level(bins, slot, stats, key, is_cat, cfg: Dict, d: int, L: int,
                ranges, sibling, tree_cols, inv_scale, mono, bounds):
    """Histogram, column draw and split finding of level d over L leaves.
    ``sibling`` is (parent table, parent do_split) where the level may
    subtract, else None; ``bounds`` the leaves' monotone (lo, hi) value
    bounds when ``mono`` is given.  Returns (key, _Level)."""
    B = cfg["nbins"]
    C = bins.shape[1]
    dev = bins.device
    adaptive = cfg["adaptive"]
    F = int(cfg["fine_nbins"] or B)
    bf16 = cfg["bf16"] and inv_scale is None
    # halving schedule: F buckets at the root down to B
    Bd = max(B, F >> d) if adaptive else B
    roff = None
    if adaptive:
        key, sub = prng.split(key)
        rlo, rhi = ranges
        roff = _rand_offsets(sub, L, C, rlo, rhi, cfg["hist_random"])
        hist = histogram_build(bins, slot, stats, L, Bd, bf16=bf16,
                               fine_map=(rlo, rhi, roff, is_cat, F))
    elif sibling is not None:
        hist = _hist_level_with_sibling(bins, slot, stats, L, B, bf16,
                                        *sibling)
    else:
        hist = histogram_build(bins, slot, stats, L, B, bf16=bf16)
    # the one integer -> float32 crossing a level; sibling subtraction
    # keeps the exact integer table
    hist_f = hist if inv_scale is None else \
        statpack.dequant_table(hist, inv_scale)
    k_cols = cfg["k_cols"]
    if k_cols < C:
        key, sub = prng.split(key)
        r = prng.uniform(sub, (L, C), dev)
        kth = torch.sort(r, dim=1).values[:, k_cols - 1:k_cols]
        col_allowed = r <= kth
    else:
        col_allowed = torch.ones((L, C), dtype=torch.bool, device=dev)
    if tree_cols is not None:
        col_allowed = col_allowed & tree_cols[None, :]
    newton, reg_lambda = cfg["newton"], cfg["reg_lambda"]
    use_mono = mono is not None
    s = find_splits(hist_f, is_cat, col_allowed, min_rows=cfg["min_rows"],
                    min_split_improvement=cfg["min_split_improvement"],
                    mono=mono, use_mono=use_mono, newton=newton,
                    reg_lambda=reg_lambda)
    live = s["leaf"]["w"] > 0
    do_split = s["do_split"] & live
    term = live & ~do_split
    vals = [_node_val(s[k]["wg"], s[k]["wh"], s[k]["w"], newton, reg_lambda)
            for k in ("leaf", "left", "right")]
    child_b = None
    if use_mono:
        vals, child_b = _mono_bounds(vals, s, mono, bounds)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    gain_pos = torch.where(do_split, s["gain"].clamp_min(0.0), zero)
    split_col = torch.where(do_split, s["col"], torch.full_like(s["col"], -1))
    cat_choice = is_cat[s["col"].long()]
    if adaptive:
        thr_leaf = _numeric_thr(s, rlo, rhi, roff, Bd)
        num_split = do_split & ~cat_choice
        thr_bin = torch.where(num_split, thr_leaf,
                              torch.full_like(thr_leaf, -1))
        na_left = num_split & s["na_left"]
        # numeric nodes carry the fine threshold; categorical codes live
        # in the first B buckets whatever Bd is: keep [:B] + NA
        bset = torch.cat([s["bitset"][:, :B], s["bitset"][:, Bd:Bd + 1]],
                         dim=1) & (do_split & cat_choice)[:, None]
    else:
        thr_leaf = None
        thr_bin = torch.full((L,), -1, dtype=torch.int32, device=dev)
        na_left = torch.zeros(L, dtype=torch.bool, device=dev)
        bset = s["bitset"] & do_split[:, None]
    return key, _Level(hist, hist_f, s, do_split, term, *vals, gain_pos,
                       cat_choice, thr_leaf, split_col, bset, thr_bin,
                       na_left, Bd, roff, child_b)


def _route(bins, slot, lv: _Level, adaptive: bool, F: int):
    """Each row's side of its leaf's split: (active, leaf index, go_left,
    leaf split)."""
    active = slot >= 0
    sl = slot.clamp_min(0).long()
    c = lv.s["col"].long()[sl]
    b = widen_bins(torch.gather(bins, 1, c[:, None])[:, 0])
    if adaptive:
        gset = lv.s["bitset"][sl, torch.clamp_max(b, lv.Bd).long()]
        gthr = torch.where(b == F, lv.s["na_left"][sl], b < lv.thr_leaf[sl])
        go_left = torch.where(lv.cat_choice[sl], gset, gthr)
    else:
        go_left = lv.s["bitset"][sl, b.long()]
    return active, sl, go_left, lv.do_split[sl]


def _next_ranges(lv: _Level, ranges, is_cat):
    new_lo, new_hi = _refine_ranges(lv.hist_f, *ranges, lv.roff, lv.Bd)
    return _child_ranges(new_lo, new_hi, lv.s, lv.thr_leaf, is_cat,
                         lv.do_split)


class Tree(NamedTuple):
    split_col: torch.Tensor   # (H,) int32, -1 = terminal
    bitset: torch.Tensor      # (H, B+1) bool
    value: torch.Tensor       # (H,) float32
    varimp: torch.Tensor      # (C,) float32
    thr_bin: torch.Tensor     # (H,) int32 adaptive numeric threshold
    na_left: torch.Tensor     # (H,) bool NA direction of thr splits
    node_gain: torch.Tensor   # (H,) float32 split gain, clamped at 0
    node_w: torch.Tensor      # (H,) float32 training cover
    child: Optional[torch.Tensor] = None   # (H,) left-child pool ptrs


def _new_tree(H: int, B: int, C: int, dev) -> Tree:
    return Tree(torch.full((H,), -1, dtype=torch.int32, device=dev),
                torch.zeros((H, B + 1), dtype=torch.bool, device=dev),
                torch.zeros(H, dtype=torch.float32, device=dev),
                torch.zeros(C, dtype=torch.float32, device=dev),
                torch.full((H,), -1, dtype=torch.int32, device=dev),
                torch.zeros(H, dtype=torch.bool, device=dev),
                torch.zeros(H, dtype=torch.float32, device=dev),
                torch.zeros(H, dtype=torch.float32, device=dev))


def _covers(lv: _Level):
    """A level's node covers (live leaves' w, else 0) and its split
    children's, interleaved left/right (2L)."""
    s = lv.s
    live = s["leaf"]["w"] > 0
    own = torch.where(live, s["leaf"]["w"], torch.zeros_like(s["leaf"]["w"]))
    kids = torch.stack([s["left"]["w"], s["right"]["w"]], dim=1).reshape(-1)
    return own, kids


def _root_ranges(C: int, F: int, dev):
    return (torch.zeros((1, C), dtype=torch.int32, device=dev),
            torch.full((1, C), F - 1, dtype=torch.int32, device=dev))


def build_tree(bins: torch.Tensor, stats: torch.Tensor, leaf0: torch.Tensor,
               key, is_cat: torch.Tensor, cfg: Dict,
               tree_cols: Optional[torch.Tensor] = None,
               inv_scale: Optional[torch.Tensor] = None,
               mono: Optional[torch.Tensor] = None) -> Tree:
    """One dense-heap tree, level by level (``build_tree_traced``).
    ``cfg`` keys: max_depth, nbins, k_cols, newton, reg_lambda, min_rows,
    min_split_improvement, bf16, adaptive, fine_nbins, hist_random.  ``inv_scale`` not None means ``stats`` is the quantized
    carrier; ``mono`` the (C,) monotone directions, or None.  Global-grid levels
    below the root histogram their left children only (sibling
    subtraction)."""
    D, B = cfg["max_depth"], cfg["nbins"]
    C = bins.shape[1]
    dev = bins.device
    adaptive = cfg["adaptive"]
    F = int(cfg["fine_nbins"] or B)
    t = _new_tree(2 ** (D + 1) - 1, B, C, dev)
    leaf = leaf0
    ranges = _root_ranges(C, F, dev) if adaptive else None
    bounds = _root_bounds(dev) if mono is not None else None
    sibling = None
    for d in range(D):
        L = 2 ** d
        off = L - 1
        key, lv = _grow_level(bins, leaf, stats, key, is_cat, cfg, d, L,
                              ranges, sibling, tree_cols, inv_scale, mono,
                              bounds)
        bounds = lv.child_b
        scatter_add(t.varimp, lv.s["col"], lv.gain_pos)
        t.split_col[off:off + L] = lv.split_col
        t.thr_bin[off:off + L] = lv.thr_bin
        t.na_left[off:off + L] = lv.na_left
        t.bitset[off:off + L] = lv.bitset
        t.value[off:off + L] = torch.where(lv.term, lv.leaf_vals,
                                           torch.zeros_like(lv.leaf_vals))
        own_w, kid_w = _covers(lv)
        t.node_gain[off:off + L] = lv.gain_pos
        t.node_w[off:off + L] = own_w
        # pre-write child values and covers (interleaved left/right) at
        # level d+1: the last level's nodes get theirs only here
        child_vals = torch.stack([lv.lvals, lv.rvals], dim=1).reshape(2 * L)
        coff = 2 * L - 1
        cmask = lv.do_split.repeat_interleave(2)
        t.value[coff:coff + 2 * L] = torch.where(
            cmask, child_vals, t.value[coff:coff + 2 * L])
        t.node_w[coff:coff + 2 * L] = torch.where(
            cmask, kid_w, t.node_w[coff:coff + 2 * L])
        active, lf, go_left, do_lf = _route(bins, leaf, lv, adaptive, F)
        child = (2 * lf + torch.where(go_left, 0, 1)).to(torch.int32)
        leaf = torch.where(active & do_lf, child,
                           torch.where(active, torch.full_like(leaf, -1),
                                       leaf))
        if adaptive and d + 1 < D:
            ranges = _next_ranges(lv, ranges, is_cat)
        sibling = (lv.hist, lv.do_split)
    return t


def build_tree_frontier(bins: torch.Tensor, stats: torch.Tensor,
                        slot0: torch.Tensor, key, is_cat: torch.Tensor,
                        cfg: Dict, tree_cols: Optional[torch.Tensor] = None,
                        inv_scale: Optional[torch.Tensor] = None,
                        mono: Optional[torch.Tensor] = None) -> Tree:
    """One tree with at most ``cfg["max_live_leaves"]`` live leaves a
    level (``build_tree_frontier``).  Nodes live in a pool of
    ``pool_size(D, cap)`` slots with a left-child pointer; a level's
    nodes are written at their pool ids, and empty frontier slots write
    inert payloads to one trash slot past the pool.  Monotone bounds
    travel with the selected children, as the adaptive ranges do."""
    D, B = cfg["max_depth"], cfg["nbins"]
    C = bins.shape[1]
    dev = bins.device
    adaptive = cfg["adaptive"]
    F = int(cfg["fine_nbins"] or B)
    widths = frontier_plan(D, cfg["max_live_leaves"])
    N = 1 + 2 * sum(widths)
    t = _new_tree(N + 1, B, C, dev)
    child = torch.full((N + 1,), -1, dtype=torch.int32, device=dev)
    frontier = torch.zeros(1, dtype=torch.long, device=dev)  # pool ids
    slot = slot0
    ranges = _root_ranges(C, F, dev) if adaptive else None
    bounds = _root_bounds(dev) if mono is not None else None
    sibling = None
    base = 1                                      # next free pool slot
    neg_inf = torch.tensor(float("-inf"), device=dev)
    for d in range(D):
        L = widths[d]
        key, lv = _grow_level(bins, slot, stats, key, is_cat, cfg, d, L,
                              ranges, sibling, tree_cols, inv_scale, mono,
                              bounds)
        s = lv.s
        scatter_add(t.varimp, s["col"], lv.gain_pos)
        t.split_col[frontier] = lv.split_col
        t.thr_bin[frontier] = lv.thr_bin
        t.na_left[frontier] = lv.na_left
        t.bitset[frontier] = lv.bitset
        t.value[frontier] = torch.where(lv.term, lv.leaf_vals,
                                        torch.zeros_like(lv.leaf_vals))
        own_w, kid_w = _covers(lv)
        t.node_gain[frontier] = lv.gain_pos
        t.node_w[frontier] = own_w
        ptr = base + 2 * torch.arange(L, dtype=torch.int32, device=dev)
        child[frontier] = torch.where(lv.do_split, ptr,
                                      torch.full_like(ptr, -1))
        # pre-write child values and covers at their fresh, contiguous
        # pool slots
        cvals = torch.stack([lv.lvals, lv.rvals], dim=1).reshape(2 * L)
        cmask = lv.do_split.repeat_interleave(2)
        t.value[base:base + 2 * L] = torch.where(cmask, cvals,
                                                 torch.zeros_like(cvals))
        t.node_w[base:base + 2 * L] = torch.where(cmask, kid_w,
                                                  torch.zeros_like(kid_w))
        if d + 1 < D:
            L_next = widths[d + 1]
            # best-first selection: the children with the most residual
            # impurity stay live, the rest are finished leaves
            se = [s[k]["wgg"] - s[k]["wg"] ** 2 /
                  torch.clamp_min(s[k]["w"], EPS) for k in ("left", "right")]
            cse = torch.stack(se, dim=1).reshape(2 * L)
            ckey = torch.where(cmask, cse.clamp_min(0.0), neg_inf)
            frontier, sel, inv = select_frontier(ckey, L_next, base, N)
            # split-parent rows follow the split to a child; rows whose
            # child fell off the frontier finish (-1)
            active, sl, go_left, do_sl = _route(bins, slot, lv, adaptive, F)
            cand = 2 * sl + torch.where(go_left, 0, 1)
            new_slot = torch.where(active & do_sl, inv[cand],
                                   torch.full_like(slot, -1))
            slot = torch.where(active, new_slot, slot)
            if lv.child_b is not None:
                bounds = (lv.child_b[0][sel], lv.child_b[1][sel])
            if adaptive:
                clo, chi = _next_ranges(lv, ranges, is_cat)
                ranges = (clo[sel].contiguous(), chi[sel].contiguous())
            # an uncapped next level numbers children 2*parent+{0,1} in
            # parent order, so the dense sibling subtraction applies
            sibling = (lv.hist, lv.do_split) if L_next == 2 * L else None
        base += 2 * L
    return Tree(t.split_col[:N], t.bitset[:N], t.value[:N], t.varimp,
                t.thr_bin[:N], t.na_left[:N], t.node_gain[:N], t.node_w[:N],
                child[:N])


class TrainedForest(NamedTuple):
    split_col: torch.Tensor   # (T, K, N)
    bitset: torch.Tensor      # (T, K, N, B+1)
    value: torch.Tensor       # (T, K, N)
    varimp: torch.Tensor      # (C,)
    thr_bin: torch.Tensor     # (T, K, N)
    na_left: torch.Tensor     # (T, K, N)
    node_gain: torch.Tensor   # (T, K, N) split gain, clamped at 0
    node_w: torch.Tensor      # (T, K, N) training cover (TreeSHAP)
    child: Optional[torch.Tensor] = None   # (T, K, N); None = dense heap
    f_final: Optional[torch.Tensor] = None  # (R, K) F after the last tree


def train_forest(bins: torch.Tensor, yv: torch.Tensor, w: torch.Tensor,
                 active: torch.Tensor, F0: torch.Tensor,
                 is_cat: torch.Tensor, key, *,
                 dist: Optional[Distribution], ntrees: int,
                 max_depth: int, nbins: int, k_cols: int, newton: bool,
                 sample_rate: float, learn_rate: float,
                 learn_rate_annealing: float, min_rows: float,
                 min_split_improvement: float, K: int = 1,
                 bf16: bool = False, mode: str = "gbm",
                 reg_lambda: float = 0.0,
                 col_sample_rate_per_tree: float = 1.0,
                 mono: Optional[torch.Tensor] = None,
                 kleaves: int = 0, adaptive: bool = False,
                 fine_nbins: int = 0, hist_random: bool = False,
                 stats_dtype: str = "f32", t0: int = 0) -> TrainedForest:
    """The forest loop of ``_train_forest_impl``: ``ntrees`` iterations
    of K trees each (ntrees >= 1; F0 is (R, K)).

    mode="gbm": stats (w, w*g, w*g^2, w*h) from ``dist``'s gradient at
    the iteration's starting F, or with K > 1 (multinomial, ``dist``
    None) from the softmax p: g = [y == k] - p, h = max(p(1-p), EPS) for
    class k; leaf values scaled by learn_rate * annealing^t (times
    (K-1)/K for multinomial), F += the iteration's K trees.  mode="drf":
    stats (w, w*g, w*g^2, w) with g the response (K = 1) or the
    indicator [y == k], scale 1, ``dist`` unused; F is not needed (the
    caller scores votes).  kleaves=0: dense heap engine; > 0: the
    sparse frontier with that cap.  ``key`` is the forest's
    master key (``prng.key``); ``t0`` is the absolute index of the
    first tree, so iteration t draws from ``fold_in(key, t0 + t)`` and
    scales by ``annealing ** (t0 + t)``: a forest trained in blocks, or
    resumed from a checkpoint, equals the one trained in one call.
    ``f_final`` is F after the last iteration (GBM; DRF returns F0).
    ``stats_dtype`` "int16"/"int8" quantizes each (tree, class) stats
    against its tree key, with qmax from this call's row count padded to
    the reference's row quantum.  ``mono`` ((C,) int), when given,
    imposes monotone constraints; ``reg_lambda`` is added to every Newton
    denominator."""
    if mode not in ("gbm", "drf"):
        raise ValueError(f"train_forest: unknown mode {mode!r}")
    cfg = dict(max_depth=max_depth, nbins=nbins, k_cols=k_cols,
               newton=newton, reg_lambda=reg_lambda, min_rows=min_rows,
               min_split_improvement=min_split_improvement, bf16=bf16,
               adaptive=adaptive, fine_nbins=fine_nbins,
               hist_random=hist_random, max_live_leaves=kleaves)
    build = build_tree_frontier if kleaves > 0 else build_tree
    dev = bins.device
    R, C = bins.shape
    multinomial = mode == "gbm" and K > 1
    wa = torch.where(active, w, torch.zeros_like(w))
    leaf_all = torch.where(active, 0, -1).to(torch.int32)
    fine_na = int(fine_nbins or nbins)
    qmax = statpack.stats_qmax(statpack.padded_rows(R), stats_dtype) \
        if stats_dtype != "f32" else 0

    def stats_for(kcls: int, F: torch.Tensor) -> torch.Tensor:
        if mode == "drf":
            g = (yv == kcls).to(torch.float32) if K > 1 \
                else torch.nan_to_num(yv)
            return torch.stack([wa, wa * g, wa * g * g, wa], dim=1)
        if multinomial:
            p = torch.softmax(F, dim=1)[:, kcls]
            g = (yv == kcls).to(torch.float32) - p
            h = torch.clamp_min(p * (1.0 - p), EPS)
        else:
            g = torch.nan_to_num(dist.gradient(yv, F[:, 0]))
            h = torch.nan_to_num(dist.hessian(yv, F[:, 0]))
        return torch.stack([wa, wa * g, wa * g * g, wa * h], dim=1)

    # DRF's stats are the same for every iteration
    drf_stats = [stats_for(k, F0) for k in range(K)] if mode == "drf" \
        else None
    lr = torch.tensor(learn_rate, dtype=torch.float32, device=dev)
    ann = torch.tensor(learn_rate_annealing, dtype=torch.float32, device=dev)
    F = F0
    trees = []
    for t in range(t0, t0 + ntrees):
        # iteration t's stream depends only on (master key, t)
        ks, kc, kcol = prng.split(prng.fold_in(key, t), 3)
        tree_cols = None
        if col_sample_rate_per_tree < 1.0:
            rc = prng.uniform(kcol, (C,), dev)
            kth = torch.sort(rc).values[
                max(1, int(round(col_sample_rate_per_tree * C))) - 1]
            tree_cols = rc <= kth
        if sample_rate < 1.0:
            samp = prng.uniform(ks, (R,), dev) < sample_rate
            leaf0 = torch.where(samp & active, 0, -1).to(torch.int32)
        else:
            leaf0 = leaf_all
        if mode == "gbm":
            scale = lr * ann ** torch.tensor(float(t), dtype=torch.float32,
                                             device=dev)
            if multinomial:
                scale = scale * (K - 1) / K
        preds = []
        for kcls in range(K):
            kc, kk = prng.split(kc)
            stats = drf_stats[kcls] if mode == "drf" \
                else stats_for(kcls, F)
            inv_sc = None
            if stats_dtype != "f32":
                stats, inv_sc = statpack.quantize_stats(stats, kk,
                                                        stats_dtype, qmax)
            tree = build(bins, stats, leaf0, kk, is_cat, cfg, tree_cols,
                         inv_sc, mono)
            if mode == "gbm":
                tree = tree._replace(value=tree.value * scale)
                preds.append(tree_predict(
                    bins, tree.split_col, tree.bitset, tree.value, max_depth,
                    child=tree.child, thr=tree.thr_bin, na_l=tree.na_left,
                    fine_na=fine_na))
            trees.append(tree)
        if mode == "gbm":
            F = F + torch.stack(preds, dim=1)

    def stack(name):                          # (T, K, ...)
        return torch.stack([getattr(tr, name) for tr in trees]).unflatten(
            0, (ntrees, K))

    return TrainedForest(stack("split_col"), stack("bitset"), stack("value"),
                         stack("varimp").sum(dim=(0, 1)), stack("thr_bin"),
                         stack("na_left"), stack("node_gain"),
                         stack("node_w"),
                         stack("child") if kleaves > 0 else None, F)
