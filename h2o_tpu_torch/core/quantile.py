"""Quantiles by iterative histogram refinement, and the per-group order
statistics the group-by needs — a port of ``h2o_tpu/core/quantile.py``
(``_refine`` :29-56, ``quantile_vec`` :59-82, ``segment_median``
:85-109, ``segment_mode`` :116-152, ``quantile`` :155-160).

``quantile_vec`` uploads a column once and refines every requested
probability's bracket ``[lo, hi]`` in parallel: each round counts the
bracket's rows into 512 bins in float32 (as the reference's ``.at[b].add``
counts, so counts above 2^24 saturate alike), takes the bin whose
cumulative count first exceeds the remaining rank, and narrows the
bracket to it.  After four rounds the result is the bracket's low end,
not an interpolated quantile.  Every step is the reference's float32
arithmetic in its order, so the card, the CPU and the reference agree
bit for bit.

``segment_median`` is an exact order statistic (one ``lexsort`` by group
and value, the middle element(s) of each group picked by its offsets);
``segment_mode`` counts each group's categorical codes in 1,024-wide
value passes and keeps the first maximal code, so ties go to the
smallest code.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.core.diag import TransferStats
from h2o_tpu_torch.core.frame import Frame, Vec
from h2o_tpu_torch.ops import xlamath
from h2o_tpu_torch.ops.segment import lexsort, segment_sum

_NBINS = 512

# per-pass value-range width of the chunked mode count table
_MODE_CHUNK = 1024


def _refine(data: torch.Tensor, ok: torch.Tensor, los: torch.Tensor,
            his: torch.Tensor, ranks: torch.Tensor, nbins: int = _NBINS):
    """One refinement round for P brackets at once: ``data`` (N,) float32,
    ``ok`` its non-NA rows, ``los``/``his``/``ranks`` (P,).  Returns the
    narrowed (los, his, ranks)."""
    P = los.shape[0]
    nb = torch.full_like(los, float(nbins))
    span = torch.maximum(his - los, torch.full_like(los, np.float32(1e-37)))
    inb = ok[None, :] & (data[None, :] >= los[:, None]) & \
        (data[None, :] <= his[:, None])
    # the reference adds 0 for every row outside a bracket; only the
    # rows inside are counted here, which gives the same sums
    p, r = torch.nonzero(inb, as_tuple=True)
    t = torch.floor((data[r] - los[p]) / span[p] * nbins)
    # the reference casts to int32 and clips; clamping first is the same
    # for every in-bracket value
    b = torch.clamp(t, 0, nbins - 1).long()
    hist = segment_sum(torch.ones_like(t), b + nbins * p,
                       P * nbins).reshape(P, nbins)
    cum = xlamath.cumsum(hist)
    # the first bin whose cumulative count exceeds the rank
    k = torch.clamp_max(torch.sum(cum <= ranks[:, None], dim=1), nbins - 1)
    below = torch.where(
        k > 0, torch.gather(cum, 1, torch.clamp_min(k - 1, 0)[:, None])[:, 0],
        torch.zeros_like(los))
    kf = k.to(torch.float32)
    new_lo = los + span * kf / nb
    new_hi = los + span * (kf + 1) / nb
    return new_lo, new_hi, ranks - below


def quantile_vec(vec: Vec, probs: Union[float, Sequence[float]],
                 rounds: int = 4, device: DeviceLike = None):
    """Quantiles of one numeric column: the low end of each
    probability's bracket after ``rounds`` refinements (the reference's
    interpolation for large data), float64 on the host; a scalar for a
    scalar ``probs``.  NaN when the column has no value."""
    scalar = np.isscalar(probs)
    ps = np.atleast_1d(np.asarray(probs, np.float64))
    r = vec.rollups
    n = r.cnt
    if n == 0:
        out = np.full(ps.shape, np.nan)
        return out[0] if scalar else out
    dev = cloud(device)
    host = np.ascontiguousarray(vec.as_float(), np.float32)
    TransferStats.note("to_device", host.nbytes)
    data = torch.from_numpy(host).to(dev)
    # the upper end is nextafter in float64, cast back to float32: r.max
    los = torch.full(ps.shape, np.float32(r.min), device=dev)
    his = torch.full(ps.shape, np.float32(np.nextafter(r.max, np.inf)),
                     device=dev)
    # target rank p*(n-1), taken in float64 and cast to float32
    ranks = torch.from_numpy((ps * (n - 1)).astype(np.float32)).to(dev)
    ok = ~torch.isnan(data)
    for _ in range(rounds):
        los, his, ranks = _refine(data, ok, los, his, ranks)
    out = los.cpu().numpy().astype(np.float64)
    TransferStats.note("to_host", 4 * out.size)
    return out[0] if scalar else out


def segment_median(vals: torch.Tensor, ok: torch.Tensor, inv: torch.Tensor,
                   B: int, Gb: int) -> torch.Tensor:
    """Each group's exact median (the mean of its two middle values, as
    ``np.median``), NaN for a group without a valid value.  ``vals`` (B,)
    float32, ``ok`` its valid non-NA rows, ``inv`` (B,) the dense group
    codes, ``Gb`` the number of groups."""
    big = torch.full_like(inv, 1 << 30)
    gkey = torch.where(ok, inv, big)
    order = lexsort((torch.where(ok, vals, torch.full_like(vals, np.inf)),
                     gkey))
    vs = vals[order]
    gs = gkey[order]
    starts = torch.searchsorted(
        gs, torch.arange(Gb, device=vals.device, dtype=gs.dtype))
    cnt = segment_sum(ok.to(torch.int32), inv, Gb)
    lo = torch.clamp(starts + torch.div(torch.clamp_min(cnt - 1, 0), 2,
                                        rounding_mode="floor"), 0, B - 1)
    hi = torch.clamp(starts + torch.div(cnt, 2, rounding_mode="floor"),
                     0, B - 1)
    med = (vs[lo] + vs[hi]) * 0.5
    return torch.where(cnt > 0, med, torch.full_like(med, np.nan))


def segment_mode(vals: torch.Tensor, ok: torch.Tensor, inv: torch.Tensor,
                 Gb: int, card: int) -> torch.Tensor:
    """Each group's most frequent code of a categorical column (``vals``
    float codes, NaN for NA) over ``card`` levels, ties to the smallest
    code, NaN for a group without a valid value.  The (groups, 1,024)
    count table is folded one value range at a time, so ``card`` is
    unbounded."""
    v = torch.clamp(torch.nan_to_num(vals, nan=0.0), 0, card - 1).long()
    inv = inv.long()
    best_cnt = torch.zeros(Gb, dtype=torch.float32, device=vals.device)
    best_val = torch.zeros(Gb, dtype=torch.float32, device=vals.device)
    for lo in range(0, card, _MODE_CHUNK):
        width = min(_MODE_CHUNK, card - lo)
        in_chunk = ok & (v >= lo) & (v < lo + width)
        idx = torch.where(in_chunk, inv * width + (v - lo),
                          torch.full_like(v, Gb * width))
        table = segment_sum(in_chunk.to(torch.float32), idx,
                            Gb * width).reshape(Gb, width)
        c_cnt = table.amax(dim=1)
        # argmax returns the first maximal index, as jnp.argmax does
        c_val = (table.argmax(dim=1) + lo).to(torch.float32)
        take = c_cnt > best_cnt
        best_val = torch.where(take, c_val, best_val)
        best_cnt = torch.where(take, c_cnt, best_cnt)
    n_ok = segment_sum(ok.to(torch.float32), inv, Gb)
    return torch.where(n_ok > 0, best_val,
                       torch.full_like(best_val, np.nan))


def quantile(frame: Frame, probs: Sequence[float],
             columns: Sequence[str] = None, device: DeviceLike = None):
    """Per-column quantiles (the /3/Quantiles shape): every numeric
    column unless ``columns`` names them."""
    cols = columns or [n for n, v in zip(frame.names, frame.vecs)
                       if v.is_numeric]
    return {c: quantile_vec(frame.vec(c), probs, device=device)
            for c in cols}
