"""Scoring-time explain options of the tree family — port of
``h2o_tpu/models/tree/contributions.py`` (``_binned`` :37,
``_forest_arrays`` :45, ``_py_treeshap`` :83, ``_shap_matrix`` :183,
``contributions_frame`` :198, ``_sorted_contributions`` :238,
``_tree_col_names`` :288, ``leaf_assignment_frame`` :295,
``_py_leaf_assign`` :334, ``staged_proba_frame`` :366).

- ``predict_contributions``: exact TreeSHAP over the forest's node
  arrays (reference: hex/tree/SharedTreeModelWithContributions.java and
  the genmodel TreeSHAP.java recursion), by the host C++ kernel of
  ``h2o_tpu_torch/native/treeshap.cpp``, threads over rows.
- ``predict_leaf_node_assignment``: each tree's terminal node id or its
  L/R descent path (reference: hex/tree/AssignLeafNodeTask), by the same
  library.
- ``staged_predict_proba``: cumulative probabilities after each tree
  (reference: GBMModel.StagedPredictionsTask), on the model's device.

All three descend the rows in the bin space scoring uses, binned on the
model's device by ``shared_tree.bin_matrix``; TreeSHAP and leaf
assignment take one copy of the bins to the host.  Σφ + BiasTerm equals
the model's margin (GBM link scale, DRF vote mean) to float precision.
``_py_treeshap`` and ``_py_leaf_assign`` are the plain numpy versions
the tests hold the library against; no caller falls back to them.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from h2o_tpu_torch import native
from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.tree import shared_tree as st

_MULTINOMIAL = ("Calculating contributions is currently not supported for "
                "multinomial models.")


# -- shared helpers -----------------------------------------------------------

def _binned_device(model, frame: Frame) -> torch.Tensor:
    out = model.output
    m = frame.as_matrix(out["x"], model.device)
    return st.bin_matrix(m, out["split_points"], out["is_cat"],
                         st.model_fine_na(out))


def _binned(model, frame: Frame) -> np.ndarray:
    """The frame's rows binned on the model's device, copied once to the
    host (packed; the library widens them)."""
    return _binned_device(model, frame).cpu().numpy()


def _forest_arrays(model, need_cover: bool = True):
    """(T, K, N) stacks of split_col, bitset, value and node_w, and the
    None-able child, thr_bin and na_left.  ``need_cover`` requires node_w
    (TreeSHAP only: a model without covers must retrain for
    contributions; leaf assignment never reads them, and node_w may be
    None there)."""
    out = model.output
    if need_cover and out.get("node_w") is None:
        raise ValueError(
            "this model predates per-node cover tracking; retrain to "
            "compute contributions")

    def arr(k):
        return np.asarray(out[k]) if out.get(k) is not None else None

    thr = arr("thr_bin")
    return (arr("split_col"), arr("bitset"), arr("value"), arr("node_w"),
            arr("child"), thr, arr("na_left") if thr is not None else None)


def _class_slice(arrays, k: int):
    """Class ``k``'s (T, N) arrays of a (T, K, N) stack tuple."""
    return [a[:, k] if a is not None else None for a in arrays]


def _is_leaf(sc, ch, n) -> bool:
    if sc[n] < 0:
        return True
    return ch is not None and ch[n] < 0


def _children(ch, n):
    return (ch[n], ch[n] + 1) if ch is not None else (2 * n + 1, 2 * n + 2)


def _go_left(bs, th, na, n, b, fine_na: int) -> bool:
    if th is not None and th[n] >= 0:
        return bool(na[n]) if b == fine_na else b < th[n]
    return bool(bs[n, min(b, bs.shape[-1] - 1)])


# -- the plain TreeSHAP (the tests' oracle); mirrors native/treeshap.cpp ------

def _py_treeshap(bins, sc_s, bs_s, vl_s, nw_s, ch_s, th_s=None,
                 na_s=None, fine_na: int = -1) -> np.ndarray:
    R, C = bins.shape
    T = sc_s.shape[0]
    phi = np.zeros((R, C + 1))

    def tree(t):
        return (sc_s[t], ch_s[t] if ch_s is not None else None, vl_s[t],
                nw_s[t])

    def tree_mean(t, n):
        sc, ch, vl, nw = tree(t)
        if _is_leaf(sc, ch, n):
            return vl[n]
        l, r = _children(ch, n)
        w = nw[n]
        if w == 0:
            return vl[n]
        return (nw[l] * tree_mean(t, l) + nw[r] * tree_mean(t, r)) / w

    def extend(path, pz, po, pi):
        # copies: the recursion's branches must not share elements
        path = [list(e) for e in path] + \
            [[pi, pz, po, 1.0 if not path else 0.0]]
        d = len(path) - 1
        for i in range(d - 1, -1, -1):
            path[i + 1][3] += po * path[i][3] * (i + 1) / (d + 1)
            path[i][3] = pz * path[i][3] * (d - i) / (d + 1)
        return path

    def unwind(path, pidx):
        d = len(path) - 1
        po, pz = path[pidx][2], path[pidx][1]
        nxt = path[d][3]
        path = [list(e) for e in path]
        for i in range(d - 1, -1, -1):
            if po != 0:
                tmp = path[i][3]
                path[i][3] = nxt * (d + 1) / ((i + 1) * po)
                nxt = tmp - path[i][3] * pz * (d - i) / (d + 1)
            elif pz != 0:
                path[i][3] = path[i][3] * (d + 1) / (pz * (d - i))
            else:
                path[i][3] = 0.0
        for i in range(pidx, d):
            path[i][:3] = path[i + 1][:3]
        return path[:d]

    def unwound_sum(path, pidx):
        d = len(path) - 1
        po, pz = path[pidx][2], path[pidx][1]
        nxt = path[d][3]
        total = 0.0
        for i in range(d - 1, -1, -1):
            if po != 0:
                tmp = nxt * (d + 1) / ((i + 1) * po)
                total += tmp
                nxt = path[i][3] - tmp * pz * ((d - i) / (d + 1))
            elif pz != 0:
                total += (path[i][3] / pz) / ((d - i) / (d + 1))
        return total

    def recurse(t, row, ph, n, path, pz, po, pi):
        sc, ch, vl, nw = tree(t)
        path = extend(path, pz, po, pi)
        if _is_leaf(sc, ch, n):
            for i in range(1, len(path)):
                w = unwound_sum(path, i)
                ph[path[i][0]] += w * (path[i][2] - path[i][1]) * vl[n]
            return
        col = int(sc[n])
        gl = _go_left(bs_s[t], th_s[t] if th_s is not None else None,
                      na_s[t] if na_s is not None else None, n,
                      int(row[col]), fine_na)
        l, r = _children(ch, n)
        hot, cold = (l, r) if gl else (r, l)
        w = nw[n]
        hz = nw[hot] / w if w != 0 else 0.5
        cz = nw[cold] / w if w != 0 else 0.5
        iz = io = 1.0
        pidx = next((i for i, e in enumerate(path) if e[0] == col), None)
        if pidx is not None:
            iz, io = path[pidx][1], path[pidx][2]
            path = unwind(path, pidx)
        recurse(t, row, ph, hot, path, hz * iz, io, col)
        recurse(t, row, ph, cold, path, cz * iz, 0.0, col)

    bias = sum(tree_mean(t, 0) for t in range(T))
    for r in range(R):
        phi[r, C] += bias
        for t in range(T):
            recurse(t, bins[r], phi[r], 0, [], 1.0, 1.0, -1)
    return phi


def _shap_matrix(bins, sc, bs, vl, nw, ch, th=None, na=None,
                 fine_na: int = -1) -> np.ndarray:
    """One class's (T, N) stack -> (R, C+1) contributions, by the native
    kernel (a failed build raises)."""
    return native.treeshap_contribs(bins, sc, bs, vl, nw, ch, th, na,
                                    fine_na)


# -- predict_contributions ----------------------------------------------------

def contributions_frame(model, frame: Frame, top_n: int = 0,
                        bottom_n: int = 0, compare_abs: bool = False,
                        output_format: str = "Original") -> Frame:
    out = model.output
    dom = out.get("response_domain")
    if dom is not None and len(dom) > 2:
        raise NotImplementedError(_MULTINOMIAL)
    if output_format not in (None, "", "Original"):
        raise NotImplementedError(
            'Only output_format "Original" is supported for this model.')
    arrays = _forest_arrays(model)
    if arrays[0].shape[1] != 1:
        raise NotImplementedError(_MULTINOMIAL)
    phi = _shap_matrix(_binned(model, frame), *_class_slice(arrays, 0),
                       st.model_fine_na(out))
    if model.algo == "drf":
        # DRF predicts the MEAN of its trees' votes; the contributions
        # with the bias sum to that mean (DRFModel.
        # ScoreContributionsTaskDRF divides by ntrees too)
        phi = phi / max(int(out["ntrees_actual"]), 1)
    else:
        phi[:, -1] += float(np.asarray(out["f0"]).reshape(-1)[0])
    x = list(out["x"])
    if not top_n and not bottom_n:
        names = x + ["BiasTerm"]
        return Frame(names, [Vec(phi[:, j]) for j in range(len(names))])
    return _sorted_contributions(phi, x, top_n, bottom_n, compare_abs)


def _sorted_contributions(phi: np.ndarray, x: List[str], top_n: int,
                          bottom_n: int, compare_abs: bool) -> Frame:
    """ContributionComposer semantics (genmodel
    ContributionComposer.java): per row, feature ids sorted by value (or
    |value|), sliced to top_n/bottom_n; output columns are (feature,
    value) pairs and BiasTerm, the features categoricals over the
    contribution names."""
    C = len(x)
    contrib_names = x + ["BiasTerm"]

    def adjust(n):
        return C if (n < 0 or n > C) else n

    t_in, b_in = int(top_n or 0), int(bottom_n or 0)
    # ContributionComposer.composeContributions branch order: only top
    # -> descending; only bottom -> ascending (bottom_n < 0: all); both
    # with a sum >= C or either negative -> all descending; else top_n
    # descending and bottom_n ascending
    if t_in != 0 and b_in == 0:
        tn, bn = adjust(t_in), 0
    elif t_in == 0 and b_in != 0:
        tn, bn = 0, adjust(b_in)
    elif (t_in + b_in) >= C or t_in < 0 or b_in < 0:
        tn, bn = C, 0
    else:
        tn, bn = t_in, b_in
    vals = phi[:, :C]
    key = np.abs(vals) if compare_abs else vals
    desc = np.argsort(-key, axis=1, kind="stable")
    asc = np.argsort(key, axis=1, kind="stable")
    order = np.concatenate([desc[:, :tn], asc[:, :bn]], axis=1)
    cols: Dict[str, Vec] = {}
    for j in range(order.shape[1]):
        side, i = ("top", j + 1) if j < tn else ("bottom", j - tn + 1)
        cols[f"{side}_feature_{i}"] = Vec(order[:, j], T_CAT,
                                          domain=list(contrib_names))
        cols[f"{side}_value_{i}"] = Vec(np.take_along_axis(
            vals, order[:, j: j + 1], axis=1)[:, 0])
    cols["BiasTerm"] = Vec(phi[:, C])
    return Frame(list(cols), list(cols.values()))


# -- predict_leaf_node_assignment ---------------------------------------------

def _tree_col_names(T: int, K: int) -> List[str]:
    """T{t+1}[.C{c+1}] (SharedTreeModel.makeAllTreeColumnNames)."""
    if K == 1:
        return [f"T{t + 1}" for t in range(T)]
    return [f"T{t + 1}.C{c + 1}" for t in range(T) for c in range(K)]


def leaf_assignment_frame(model, frame: Frame,
                          assign_type: str = "Path") -> Frame:
    """Per tree (and class), the terminal node id ("Node_ID", numeric)
    or the root-to-leaf path ("Path", a categorical over the sorted
    paths the rows take)."""
    out = model.output
    sc, bs, _vl, _nw, ch, th, na = _forest_arrays(model, need_cover=False)
    T, K, _ = sc.shape
    bins = _binned(model, frame)
    fine_na = st.model_fine_na(out)
    per_class = [native.tree_leaf_assign(
        bins, *_class_slice((sc, bs, ch, th, na), k), fine_na=fine_na)
        for k in range(K)]
    cols: List[Vec] = []
    for t in range(T):
        for k in range(K):
            ids, paths = per_class[k]
            if assign_type == "Node_ID":
                cols.append(Vec(ids[:, t].astype(np.float32)))
            else:
                # one path per leaf: the sorted paths of the leaves the
                # rows reach (L/R bytes sort as their strings do)
                leaves, first, inv = np.unique(ids[:, t], return_index=True,
                                               return_inverse=True)
                order = np.argsort(paths[first, t], kind="stable")
                rank = np.empty(len(order), np.int32)
                rank[order] = np.arange(len(order), dtype=np.int32)
                cols.append(Vec(rank[inv.ravel()], T_CAT, domain=[
                    p.decode() for p in paths[first[order], t]]))
    return Frame(_tree_col_names(T, K), cols)


def _py_leaf_assign(bins, sc_s, bs_s, ch_s, th_s=None, na_s=None,
                    fine_na: int = -1):
    """Plain version of ``native.tree_leaf_assign``."""
    R = bins.shape[0]
    T = sc_s.shape[0]
    ids = np.zeros((R, T), np.int32)
    paths = np.zeros((R, T), "S64")
    for t in range(T):
        sc = sc_s[t]
        ch = ch_s[t] if ch_s is not None else None
        th = th_s[t] if th_s is not None else None
        na = na_s[t] if na_s is not None else None
        for r in range(R):
            n, p = 0, []
            while not _is_leaf(sc, ch, n) and len(p) < 63:
                gl = _go_left(bs_s[t], th, na, n, int(bins[r, int(sc[n])]),
                              fine_na)
                p.append("L" if gl else "R")
                l, rt = _children(ch, n)
                n = l if gl else rt
            ids[r, t] = n
            paths[r, t] = "".join(p).encode()
    return ids, paths


# -- staged_predict_proba -----------------------------------------------------

def staged_proba_frame(model, frame: Frame) -> Frame:
    """Cumulative class probabilities after each tree (GBMModel.
    StagedPredictionsTask: a binomial column carries p0).  As in the
    reference, the per-tree values are summed in float32 in tree order;
    f0 and the link then take numpy's promotion of the sum and f0 (f0 is
    float32 in every model the builders make, so float32), and the
    result is cast to float32."""
    out = model.output
    dom = out.get("response_domain")
    bins = _binned_device(model, frame)
    per_tree = st.forest_tree_values(
        bins, depth=int(out["max_depth"]),
        **st._forest_args(out, bins.device))                  # (T, K, R)
    T, K, _ = per_tree.shape
    f0 = torch.tensor(np.asarray(out["f0"]).reshape(-1), device=bins.device)
    dt = torch.promote_types(per_tree.dtype, f0.dtype)
    f0 = f0.to(dt)
    dist = out.get("distribution_resolved", "gaussian")
    F = torch.zeros_like(per_tree[0])
    cols: List[Vec] = []

    def host(v):
        return Vec(v.to(torch.float32).cpu().numpy())

    for t in range(T):
        F = F + per_tree[t]                       # float32, tree order
        if dom is not None and len(dom) == 2:
            p1 = 1.0 / (1.0 + torch.exp(-(F[0].to(dt) + f0[0])))
            cols.append(host(1.0 - p1))                         # p0
        elif dom is not None:
            logits = F.to(dt) + f0[:, None]                     # (K, R)
            e = torch.exp(logits - logits.amax(dim=0))
            P = e / e.sum(dim=0)
            cols.extend(host(P[k]) for k in range(K))
        else:
            v = F[0].to(dt) + f0[0]
            if dist in ("poisson", "gamma", "tweedie"):
                v = torch.exp(v)
            cols.append(host(v))
    return Frame(_tree_col_names(T, K), cols)
