"""The data plane's one-device verbs: sort, filter, take, group-by and
merge — a port of the one-device routes of ``h2o_tpu/core/munge.py``.

Reference map: ``DEVICE_AGGS`` / ``COMBINABLE_AGGS`` :110-113,
``mode_device_eligible`` :116-127, ``device_munge_enabled`` :130-134,
``_factorize_block`` :213-234, the
kernel bodies ``_build_sort`` :637, ``_build_factorize`` :648,
``_build_group_aggs`` :657-709, ``_build_filter`` :712, ``_build_take``
:724, ``_build_merge_match`` :737-764 and ``_build_merge_emit``
:767-789, the key and payload matrices :792-843, the verbs
``sort_frame`` :862 (global branch :884-893), ``filter_rows`` :896
(global branch :917-930), ``take_rows`` :962-981, ``groupby_frame``
:984 through ``_global_groupby`` :1053-1078 and ``_group_table``
:1081-1100, ``merge_frames`` :1138 through ``_global_merge``
:1230-1319 and ``_merge_key_cols`` :1103-1135, and ``merge_device_ok``
:1322-1330.

Frames stay on the host (``core/frame.py``).  A verb uploads the
columns it reads once, as one float32 transport matrix (categorical
codes ride as exact floats, -1 for NA); computes the keys, the order or
the group codes, and the gather of every column on the device; and
brings the result back to the host once, categorical columns as int32
codes with NaN -> -1.  ``TransferStats`` counts those bytes.

The reference pads rows to power-of-two buckets only to bound its XLA
compiles; eager PyTorch compiles nothing, so the verbs work at the true
row count.  Its shard-resident collectives (the ``_shard_*`` builders)
are the multi-device route (ROADMAP P8).  The host routes live in the
Rapids interpreter (``h2o_tpu_torch/rapids/interp.py``), which picks a
route by the reference's predicates before it calls a verb; a frame the
device verbs do not take raises ``ValueError`` by name here, and no verb
turns to the host on its own.

NA and tie semantics (the reference's):
- sort: NAs first in both directions (descending keys are negated, NA
  becomes -inf); ties keep input order (a stable ``lexsort``).
- group-by and merge keys: numeric NaN is one NA group (the -inf
  sentinel, first), categorical NA is the -1 code, its own group, also
  first; NA keys match each other in joins.  Categorical join keys
  match by label through the union domain.
- -0.0 and 0.0 are one key; a group reports its first row's key.

Group sums (``sum``, ``mean``, ``sd``, ``var``) add each group's rows in
one tree order on every device (``ops/segment.sorted_segment_sum`` over
the factorized order), so the card's aggregates equal the CPU's bit for
bit; counts, medians and modes are exact in any order.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from h2o_tpu_torch import config
from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.core.diag import TransferStats
from h2o_tpu_torch.core.frame import (T_CAT, T_NUM, Frame, Vec,
                                      frame_device_ok)
from h2o_tpu_torch.core.quantile import segment_median, segment_mode
from h2o_tpu_torch.ops import xlamath
from h2o_tpu_torch.ops.segment import (lexsort, segment_max, segment_min,
                                       segment_sum, sorted_segment_sum)

# group-by aggregates with a device form; mode on categorical columns
# only (a float column has no dense code space to count in)
DEVICE_AGGS = ("min", "max", "mean", "sum", "sd", "var", "nrow", "count",
               "median", "mode")
# the aggregates the reference's shard collective combines from
# per-shard partials (the multi-device route, P8)
COMBINABLE_AGGS = ("min", "max", "mean", "sum", "sd", "var", "nrow",
                   "count")

_BIG = 1 << 30
_HOST_ROUTE = ("; rapids_exec takes such a frame on its host route "
               "(h2o_tpu_torch/rapids/interp.py)")


def device_munge_enabled() -> bool:
    """False when ``H2O_TPU_DEVICE_MUNGE`` is ``0``, ``false`` or ``off``:
    the Rapids munge ops then take their host routes (the reference's
    parity oracle); the device routes are the default."""
    return config.device_munge()


def shard_munge_enabled() -> bool:
    """False when ``H2O_TPU_SHARD_MUNGE`` is ``0``, ``false`` or ``off``.
    The reference's verbs then run as global kernels instead of shard
    collectives; one device has only the global form, so here the gate
    decides only whether the Rapids planner fuses (the reference's
    planner declines without its collectives)."""
    return config.shard_munge()


def mode_device_eligible(fr: Frame, aggs) -> bool:
    """True when every ``mode`` aggregate targets a categorical column
    with a domain (any cardinality)."""
    for a, c, _na in aggs:
        if a != "mode":
            continue
        v = fr.vecs[c]
        if not v.is_categorical or not v.domain:
            return False
    return True


def merge_device_ok(L: Frame, R: Frame, by_x: Sequence[int],
                    by_y: Sequence[int]) -> bool:
    """True when both frames are device-eligible and every key pair is of
    one kind (categorical with categorical, by label; numeric with
    numeric, by value)."""
    if not (frame_device_ok(L) and frame_device_ok(R)):
        return False
    return all(L.vecs[jx].is_categorical == R.vecs[jy].is_categorical
               for jx, jy in zip(by_x, by_y))


def _require_frame(verb: str, fr: Frame) -> None:
    if frame_device_ok(fr):
        return
    bad = [f"{n} ({v.type})" for n, v in zip(fr.names, fr.vecs)
           if v.type not in (T_NUM, T_CAT) or v.host_data is not None]
    what = ", ".join(bad) if bad else "no columns"
    raise ValueError(f"{verb}: the device verbs take numeric and "
                     f"categorical columns only, not {what}{_HOST_ROUTE}")


# ---------------------------------------------------------------------------
# transport: one upload and one download a verb
# ---------------------------------------------------------------------------


def _upload(fr: Frame, cols: Sequence[int], dev) -> torch.Tensor:
    """(rows, len(cols)) float32 transport matrix of the columns' payloads
    (categorical codes as exact floats, -1 for NA) on ``dev``."""
    m = np.stack([fr.vecs[j].data.astype(np.float32, copy=False)
                  for j in cols], axis=1) if cols else \
        np.zeros((fr.nrows, 0), np.float32)
    TransferStats.note("to_device", m.nbytes)
    return torch.from_numpy(np.ascontiguousarray(m)).to(dev)


def _download(t: torch.Tensor) -> np.ndarray:
    out = t.cpu().numpy()
    TransferStats.note("to_host", out.nbytes)
    return out


def _vec(col: np.ndarray, like: Vec, domain=None) -> Vec:
    """A host column of ``like``'s type from a transport column."""
    if like.is_categorical:
        codes = np.where(np.isnan(col), -1.0, col).astype(np.int32)
        return Vec(codes, T_CAT, domain=list(
            domain if domain is not None else like.domain))
    return Vec(col, like.type)


# ---------------------------------------------------------------------------
# helpers on device tensors
# ---------------------------------------------------------------------------


def _factorize_block(keys: torch.Tensor, valid: torch.Tensor):
    """Rows -> dense group codes by a sort (the radix factorization):
    ``(inv codes, sort order, n_groups)``.  Validity is the primary key,
    so invalid rows sort last and take codes past ``n_groups``."""
    size, K = keys.shape
    sv = torch.where(valid, 0, 1).to(torch.int32)
    cols = [keys[:, k] for k in range(K)]
    order = lexsort(cols[::-1] + [sv])
    ks = keys[order]
    vs = valid[order]
    if size > 1:
        diff = torch.any(ks[1:] != ks[:-1], dim=1) | (vs[1:] != vs[:-1])
        new_group = torch.cat([diff.new_ones(1), diff])
    else:
        new_group = torch.ones(size, dtype=torch.bool, device=keys.device)
    gid_sorted = torch.cumsum(new_group.to(torch.int64), 0) - 1
    inv = torch.empty(size, dtype=torch.int64, device=keys.device)
    inv[order] = gid_sorted
    nvalid = int(valid.sum())
    n_groups = int(gid_sorted[nvalid - 1]) + 1 if nvalid else 0
    return inv, order, n_groups


def _sort_key_matrix(pay: torch.Tensor, is_cat: Sequence[bool],
                     ascending: Sequence[bool]) -> torch.Tensor:
    """(rows, K) sort keys: descending negates, NA (NaN or a categorical
    code below 0) becomes -inf, so NAs come first in both directions."""
    ks = []
    for k, (cat, asc) in enumerate(zip(is_cat, ascending)):
        d = pay[:, k]
        na = torch.isnan(d)
        if cat:
            na = na | (d < 0)
        ks.append(torch.where(na, torch.full_like(d, -np.inf),
                              d if asc else -d))
    return torch.stack(ks, dim=1)


def _factor_key_matrix(pay: torch.Tensor,
                       is_cat: Sequence[bool]) -> torch.Tensor:
    """(rows, K) group/join keys: categorical codes as they are (NA = -1
    its own group), numeric NaN -> -inf (one NA group, first)."""
    ks = []
    for k, cat in enumerate(is_cat):
        d = pay[:, k]
        ks.append(d if cat else torch.where(
            torch.isnan(d), torch.full_like(d, -np.inf), d))
    return torch.stack(ks, dim=1)


def _group_aggs(keys, valid, inv, order, vals, G: int,
                ops: Tuple[str, ...], cards: Tuple[int, ...]):
    """One pass over the groups: each group's key (its first row's in
    sorted order), its row count and every aggregate of the bundle.
    ``vals`` (rows, A) float32 with NaN NAs; ``cards`` the categorical
    cardinality of each ``mode`` aggregate."""
    B = keys.shape[0]
    dev = keys.device
    gid_sorted = inv[order]                             # nondecreasing
    bpos = torch.searchsorted(gid_sorted, torch.arange(G, device=dev))
    start_rows = order[torch.clamp(bpos, 0, max(B - 1, 0))]
    keyvals = keys[start_rows]
    counts = segment_sum(valid.to(torch.float32), inv, G)

    def group_sum(x):
        # the groups' rows in sorted order: one tree order on every device
        return sorted_segment_sum(x[order], gid_sorted, G)

    outs = []
    for a, op in enumerate(ops):
        d = vals[:, a]
        ok = valid & ~torch.isnan(d)
        okf = ok.to(torch.float32)
        di = torch.where(ok, d, torch.zeros_like(d))
        cnt_ok = segment_sum(okf, inv, G)
        n1 = torch.clamp_min(cnt_ok, 1.0)
        if op in ("nrow", "count"):
            out = counts
        elif op == "sum":
            out = group_sum(di)
        elif op == "mean":
            out = group_sum(di) / n1
        elif op in ("sd", "var"):
            # the reference's float32 formula, not Welford's
            m = group_sum(di) / n1
            ss = group_sum(di * di)
            # XLA's CPU backend fuses m * m into the subtraction
            var = xlamath.fma(-m, m, ss / n1)
            var = torch.clamp_min(
                var * cnt_ok / torch.clamp_min(cnt_ok - 1, 1.0), 0.0)
            out = torch.sqrt(var) if op == "sd" else var
        elif op in ("min", "max"):
            fill = np.inf if op == "min" else -np.inf
            dm = torch.where(ok, d, torch.full_like(d, fill))
            seg = segment_min if op == "min" else segment_max
            out = seg(dm, inv, G)
            out = torch.where(torch.isfinite(out), out,
                              torch.full_like(out, np.nan))
        elif op == "median":
            out = segment_median(d, ok, inv, B, G)
        else:                                # mode (groupby_frame checks)
            out = segment_mode(d, ok, inv, G, cards[a])
        outs.append(out)
    return keyvals, counts, outs


def _merge_match(lcode, rcode, lvalid, rvalid, all_x: bool, all_y: bool):
    """Per left row its run of matching right rows in the right side's
    code order, the pair offsets, and the right rows no left row
    matches, in row order."""
    PR = rcode.shape[0]
    lc = torch.where(lvalid, lcode, torch.full_like(lcode, _BIG))
    rc = torch.where(rvalid, rcode, torch.full_like(rcode, _BIG))
    r_sorted, r_order = torch.sort(rc, stable=True)
    lo = torch.searchsorted(r_sorted, lc, side="left")
    hi = torch.searchsorted(r_sorted, lc, side="right")
    counts = torch.where(lvalid, hi - lo, torch.zeros_like(lo))
    if all_x:                            # left outer: unmatched keep a slot
        counts_adj = torch.where(lvalid & (counts == 0),
                                 torch.ones_like(counts), counts)
    else:
        counts_adj = counts
    offsets = torch.cumsum(counts_adj, 0)
    n_pairs = int(offsets[-1]) if offsets.numel() else 0
    l_sorted, _ = torch.sort(lc)
    plo = torch.searchsorted(l_sorted, rc, side="left")
    phi = torch.searchsorted(l_sorted, rc, side="right")
    unmatched = rvalid & ~(phi > plo)
    u_cnt = int(unmatched.sum()) if all_y else 0
    rows = torch.arange(PR, device=rcode.device)
    _, uord = torch.sort(torch.where(unmatched, rows,
                                     torch.full_like(rows, _BIG)),
                         stable=True)
    return n_pairs + u_cnt, n_pairs, counts, offsets, lo, r_order, uord


def _merge_emit(counts, offsets, lo, r_order, uord, n_pairs: int,
                n_out: int):
    """The output's (left row, right row) pairs: matched pairs in left
    row order, each left row's matches in right row order, then the
    unmatched right rows; -1 where a side has no row."""
    PL, PR = counts.shape[0], r_order.shape[0]
    dev = counts.device
    j = torch.arange(n_out, device=dev)
    ic = torch.clamp(torch.searchsorted(offsets, j, side="right"), 0,
                     max(PL - 1, 0))
    base = torch.where(ic > 0, offsets[torch.clamp_min(ic - 1, 0)],
                       torch.zeros_like(ic)) if PL else j * 0
    k = j - base
    has = counts[ic] > 0 if PL else torch.zeros_like(j, dtype=torch.bool)
    minus1 = torch.full_like(j, -1)
    if PR:
        rpos = torch.clamp(lo[ic] + k, 0, PR - 1) if PL else j * 0
        ri_m = torch.where(has, r_order[rpos], minus1)
        ri_u = uord[torch.clamp(j - n_pairs, 0, PR - 1)]
    else:
        ri_m = ri_u = minus1
    in_pairs = j < n_pairs
    li = torch.where(in_pairs, ic, minus1)
    ri = torch.where(in_pairs, ri_m, ri_u)
    return li, ri


def _gather_or_fill(pay: torch.Tensor, idx: torch.Tensor,
                    fill: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of ``pay``, and ``fill`` where ``idx`` is -1."""
    if pay.shape[0] == 0:
        return fill.expand(idx.shape[0], -1).clone()
    g = pay[torch.clamp_min(idx, 0)]
    return torch.where((idx >= 0)[:, None], g, fill)


def _fills(fr: Frame, cols: Sequence[int], dev) -> torch.Tensor:
    """The NA of each column in transport form: -1 for a categorical
    code, NaN otherwise."""
    return torch.tensor([-1.0 if fr.vecs[j].is_categorical else np.nan
                         for j in cols], dtype=torch.float32, device=dev)


# ---------------------------------------------------------------------------
# the verbs
# ---------------------------------------------------------------------------


def sort_frame(fr: Frame, idxs: Sequence[int], ascending: Sequence[bool],
               device: DeviceLike = None) -> Frame:
    """The frame's rows in the stable order of the key columns ``idxs``
    (the first primary), each ascending or descending; NAs first."""
    _require_frame("sort", fr)
    dev = cloud(device)
    idxs = [int(j) for j in idxs]
    pay = _upload(fr, range(fr.ncols), dev)
    keys = _sort_key_matrix(pay[:, idxs],
                            [fr.vecs[j].is_categorical for j in idxs],
                            [bool(a) for a in ascending])
    order = lexsort([keys[:, k] for k in range(keys.shape[1])][::-1])
    out = _download(pay[order])
    return Frame(list(fr.names),
                 [_vec(out[:, j], v) for j, v in enumerate(fr.vecs)])


def filter_rows(fr: Frame, mask, device: DeviceLike = None) -> Frame:
    """The rows whose ``mask`` entry is above 0 (a NaN entry drops its
    row), in order; ``mask`` is a host array of one entry a row."""
    _require_frame("filter", fr)
    arr = np.ascontiguousarray(mask)
    if arr.shape != (fr.nrows,):
        raise ValueError(f"filter: a mask of {arr.shape} for {fr.nrows} "
                         "rows")
    dev = cloud(device)
    TransferStats.note("to_device", arr.nbytes)
    m = torch.from_numpy(arr).to(dev)
    pay = _upload(fr, range(fr.ncols), dev)
    keep = m.to(torch.float32) > 0
    rows = torch.nonzero(keep).reshape(-1)
    out = _download(pay[rows])
    return Frame(list(fr.names),
                 [_vec(out[:, j], v) for j, v in enumerate(fr.vecs)])


def take_rows(fr: Frame, idx, device: DeviceLike = None) -> Frame:
    """The rows ``idx`` (an index list, repeats allowed) as a device
    gather: the list uploads once, every column gathers on the
    device."""
    _require_frame("take", fr)
    idx = np.asarray(idx, np.int64).reshape(-1)
    if idx.size and idx.min() < 0:
        raise ValueError("take: negative row indices" + _HOST_ROUTE)
    if idx.size and idx.max() >= fr.nrows:
        raise IndexError(f"take: row {int(idx.max())} of a frame of "
                         f"{fr.nrows} rows")
    dev = cloud(device)
    pay = _upload(fr, range(fr.ncols), dev)
    TransferStats.note("to_device", idx.nbytes)
    out = _download(pay[torch.from_numpy(idx).to(dev)])
    return Frame(list(fr.names),
                 [_vec(out[:, j], v) for j, v in enumerate(fr.vecs)])


def groupby_frame(fr: Frame, gcols: Sequence[int],
                  aggs: Sequence[Tuple[str, int, str]],
                  device: DeviceLike = None) -> Frame:
    """One row a group of the key columns ``gcols`` (sorted, the NA
    group first), then one column ``f"{agg}_{col}"`` an aggregate of
    ``aggs`` — (name, column index, NA handling) triples, each name one
    of ``DEVICE_AGGS`` — computed in one pass over the groups."""
    _require_frame("groupby", fr)
    for a, _c, _na in aggs:
        if a not in DEVICE_AGGS:
            raise ValueError(f"groupby: no device aggregate {a!r} (device "
                             f"aggregates: {', '.join(DEVICE_AGGS)})"
                             + _HOST_ROUTE)
    if not mode_device_eligible(fr, aggs):
        raise ValueError("groupby: mode of a numeric column has no dense "
                         "code space to count in" + _HOST_ROUTE)
    dev = cloud(device)
    gcols = [int(j) for j in gcols]
    read = sorted(set(gcols) | {int(c) for _a, c, _na in aggs})
    pay = _upload(fr, read, dev)
    valid = torch.ones(fr.nrows, dtype=torch.bool, device=dev)
    return _group_rows(fr, pay, read, valid, gcols, aggs)


def _group_rows(fr: Frame, pay: torch.Tensor, read: Sequence[int],
                valid: torch.Tensor, gcols: Sequence[int],
                aggs: Sequence[Tuple[str, int, str]]) -> Frame:
    """``groupby_frame`` over the rows ``valid`` marks, from ``pay``, the
    transport matrix of the columns ``read`` (sorted); the table comes
    back to the host in one download."""
    pos = {j: i for i, j in enumerate(read)}
    acols = [int(c) for _a, c, _na in aggs]
    keys = _factor_key_matrix(pay[:, [pos[j] for j in gcols]],
                              [fr.vecs[j].is_categorical for j in gcols])
    inv, order, G = _factorize_block(keys, valid)
    vals = pay[:, [pos[c] for c in acols]]
    for a, c in enumerate(acols):                  # as_float: NA codes NaN
        if fr.vecs[c].is_categorical:
            vals[:, a] = torch.where(vals[:, a] < 0,
                                     torch.full_like(vals[:, a], np.nan),
                                     vals[:, a])
    ops = tuple(a for a, _c, _na in aggs)
    cards = tuple(len(fr.vecs[c].domain or ()) if a == "mode" else 0
                  for a, c, _na in aggs)
    keyvals, _counts, outs = _group_aggs(keys, valid, inv, order, vals, G,
                                         ops, cards)
    table = _download(torch.cat([keyvals] + [o[:, None] for o in outs],
                                dim=1))
    names: List[str] = []
    vecs: List[Vec] = []
    for k, j in enumerate(gcols):
        v = fr.vecs[j]
        col = table[:, k]
        if not v.is_categorical:                   # the NA sentinel -> NaN
            col = np.where(np.isneginf(col), np.float32(np.nan), col)
        vecs.append(_vec(col, v))
        names.append(fr.names[j])
    for a, (op, c, _na) in enumerate(aggs):
        names.append(f"{op}_{fr.names[c]}")
        vecs.append(Vec(table[:, len(gcols) + a]))
    return Frame(names, vecs)


def _merge_key_cols(L: Frame, R: Frame, by_x, by_y, lpay, rpay, dev):
    """Per key pair the union domain (categorical), the right key column
    in the left's code space, and the two key matrices."""
    unions, r_keymap = {}, {}
    lk, rk = [], []
    for jx, jy in zip(by_x, by_y):
        vl, vr = L.vecs[jx], R.vecs[jy]
        dl, dr = lpay[:, jx], rpay[:, jy]
        if vl.is_categorical:
            have = set(vl.domain)
            dom = list(vl.domain) + [d for d in vr.domain if d not in have]
            unions[jx] = dom
            where = {d: i for i, d in enumerate(dom)}
            lut = torch.tensor([where[d] for d in vr.domain] or [0],
                               dtype=torch.float32, device=dev)
            code = torch.clamp(dr, 0, lut.shape[0] - 1).long()
            remapped = torch.where(dr < 0, torch.full_like(dr, -1.0),
                                   lut[code])
            r_keymap[jy] = remapped
            lk.append(dl)
            rk.append(remapped)
        else:
            r_keymap[jy] = dr
            lk.append(torch.where(torch.isnan(dl),
                                  torch.full_like(dl, -np.inf), dl))
            rk.append(torch.where(torch.isnan(dr),
                                  torch.full_like(dr, -np.inf), dr))
    return unions, r_keymap, torch.stack(lk, 1), torch.stack(rk, 1)


def merge_frames(L: Frame, R: Frame, all_x: bool, all_y: bool,
                 by_x: Sequence[int], by_y: Sequence[int],
                 device: DeviceLike = None) -> Frame:
    """The sorted join of ``L`` and ``R`` on the key columns ``by_x`` /
    ``by_y`` (BinaryMerge analog): every left column, then the right's
    non-key columns (a clashing name gets ``_y``).  Pairs come in left
    row order, a left row's matches in right row order; ``all_x`` keeps
    unmatched left rows (left outer), ``all_y`` appends the unmatched
    right rows (right outer), their left key columns filled from the
    right."""
    by_x, by_y = [int(j) for j in by_x], [int(j) for j in by_y]
    if len(by_x) != len(by_y) or not by_x:
        raise ValueError("merge: one right key column a left one")
    _require_frame("merge", L)
    _require_frame("merge", R)
    if not merge_device_ok(L, R, by_x, by_y):
        raise ValueError("merge: a categorical key is paired with a "
                         "numeric one" + _HOST_ROUTE)
    dev = cloud(device)
    PL, PR = L.nrows, R.nrows
    lpay = _upload(L, range(L.ncols), dev)
    rpay = _upload(R, range(R.ncols), dev)
    unions, r_keymap, lkeys, rkeys = _merge_key_cols(L, R, by_x, by_y,
                                                     lpay, rpay, dev)
    ck = torch.cat([lkeys, rkeys])
    cv = torch.ones(PL + PR, dtype=torch.bool, device=dev)
    inv, _order, _g = _factorize_block(ck, cv)
    lvalid, rvalid = cv[:PL], cv[PL:]
    n_out, n_pairs, counts, offsets, lo, r_order, uord = _merge_match(
        inv[:PL], inv[PL:], lvalid, rvalid, all_x, all_y)
    li, ri = _merge_emit(counts, offsets, lo, r_order, uord, n_pairs, n_out)
    u_cnt = n_out - n_pairs
    lout = _gather_or_fill(lpay, li, _fills(L, range(L.ncols), dev))
    if u_cnt > 0:
        # right-only rows: the left key columns take the right's keys
        # (categorical codes already in the union domain)
        right_only = (li < 0) & (ri >= 0)
        for jx, jy in zip(by_x, by_y):
            rg = r_keymap[jy][torch.clamp_min(ri, 0)] if PR else lout[:, jx]
            lout[:, jx] = torch.where(right_only, rg, lout[:, jx])
    r_by = set(by_y)
    r_idx = [j for j in range(R.ncols) if j not in r_by]
    rout = _gather_or_fill(rpay[:, r_idx], ri, _fills(R, r_idx, dev))
    out = _download(torch.cat([lout, rout], dim=1))
    names: List[str] = []
    vecs: List[Vec] = []
    for j, nm in enumerate(L.names):
        dom = unions[j] if j in unions and u_cnt > 0 else None
        vecs.append(_vec(out[:, j], L.vecs[j], domain=dom))
        names.append(nm)
    for c, j in enumerate(r_idx):
        nm = R.names[j]
        vecs.append(_vec(out[:, L.ncols + c], R.vecs[j]))
        names.append(nm if nm not in names else f"{nm}_y")
    return Frame(names, vecs)
