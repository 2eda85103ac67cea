"""Segment reductions and ``lexsort`` in a fixed order on every device.

The reference reduces segments with ``jax.ops.segment_sum`` /
``segment_min`` / ``segment_max`` and ``x.at[i].add`` (a scatter-add
that XLA's CPU backend runs over the rows in order) and sorts rows with
``jnp.lexsort``.  Their PyTorch counterparts:

* ``segment_sum``: on the CPU ``index_add_``, a loop over the rows in
  order, so each segment adds its values in row order as the
  reference's scatter-add does.  On CUDA ``index_add_`` adds repeated
  indices by atomics in no fixed order, so a float sum can move in its
  last place between two calls on the same inputs, and a decision read
  from it (an AUC, a stopping test, a variable importance) can follow.
  There ``index_put_(accumulate=True)`` is used instead: it sorts the
  indices stably and reduces each segment in an order fixed by its rows'
  positions (a warp's strided partial sums folded by shuffles, then the
  remainder in row order), so the card's sums repeat bitwise from call
  to call.  They may differ from the CPU's in the last place.  A
  segment of more than ``CARD_BLOCK`` rows is summed in blocks of that
  many rows first, then across the blocks, in the same fixed way.
* ``sorted_segment_sum``: for rows already sorted by segment, a
  segmented scan of elementwise adds in one tree order on every device,
  so the card's sums equal the CPU's bit for bit (the group-by's float
  aggregates).
* ``segment_min`` / ``segment_max``: ``scatter_reduce`` with
  ``amin`` / ``amax`` over a table filled with the reduction's identity
  (+inf / -inf, or the integer type's extreme), exact in any order as
  long as no value is NaN.
* ``lexsort``: stable ``torch.sort`` passes from the least significant
  key to the primary one (the last, as in ``jnp.lexsort``).  A stable
  sort gives exactly one permutation, so the order equals
  ``jnp.lexsort``'s.  ``-0.0`` and ``0.0`` compare equal there; the
  card's radix sort orders them by their bits, so float keys are sorted
  with zeros made positive.

Indices outside ``[0, n)`` are dropped, as ``jax.ops.segment_*`` drops
them.
"""

from __future__ import annotations

from typing import Sequence

import torch


# On the card ``index_put_`` walks each segment's rows with one warp, so
# a segment of ~420,000 rows took ~80 ms on an NVIDIA H100 (binomial
# metrics over 1M rows crowding one bin); a longer segment than this is
# first reduced in blocks of this many rows
CARD_BLOCK = 1 << 14


def _in_range(index: torch.Tensor, n: int) -> torch.Tensor:
    """``index`` with every entry outside [0, n) sent to the trash slot
    ``n``."""
    index = index.long()
    ok = (index >= 0) & (index < n)
    return torch.where(ok, index, torch.full_like(index, n))


def block_partials(index: torch.Tensor, values: torch.Tensor, n: int,
                   block: int = CARD_BLOCK):
    """``(index, values)`` of the same sums with no segment longer than
    ``-(-rows // block)``: each block of ``block`` rows is reduced into
    its own copy of the ``n`` slots first (by ``index_put_``'s
    accumulate), and slot ``s`` of every block's copy then maps to
    ``s``."""
    nb = -(-index.shape[0] // block)
    blk = torch.arange(index.shape[0], device=index.device) // block
    part = values.new_zeros((nb * n,) + tuple(values.shape[1:]))
    part.index_put_((blk * n + index,), values, accumulate=True)
    return torch.arange(n, device=index.device).repeat(nb), part


def scatter_add(out: torch.Tensor, index: torch.Tensor,
                values: torch.Tensor) -> torch.Tensor:
    """``out[index[i]] += values[i]`` in place along dim 0 (the
    reference's ``out.at[index].add(values)``): on the CPU each slot takes
    its values after its current one in row order, on CUDA in the fixed
    order of the module docstring; every index must lie in range."""
    index = index.long()
    if not out.is_cuda:
        out.index_add_(0, index, values)
        return out
    n = out.shape[0]
    if index.shape[0] > CARD_BLOCK and int(torch.bincount(
            index, minlength=n).max()) > CARD_BLOCK:
        index, values = block_partials(index, values, n)
    out.index_put_((index,), values, accumulate=True)
    return out


def segment_sum(values: torch.Tensor, index: torch.Tensor,
                n: int) -> torch.Tensor:
    """Per-segment sums along dim 0: ``out[s] = sum(values[i] for i with
    index[i] == s)``, added in a fixed order on every device."""
    out = values.new_zeros((n + 1,) + tuple(values.shape[1:]))
    return scatter_add(out, _in_range(index, n), values)[:n]


def sorted_segment_sum(values: torch.Tensor, segments: torch.Tensor,
                       n: int) -> torch.Tensor:
    """Per-segment sums of rows already sorted by segment (``segments``
    nondecreasing, in [0, n)), each segment reduced in one tree order
    built from elementwise adds, so every device gives the same bits: a
    segmented inclusive scan (step ``d`` adds the value ``d`` rows back
    where it lies in the same segment, d = 1, 2, 4, ...) read at each
    segment's last row.  An empty segment sums to 0."""
    v = values
    ar = torch.arange(n, device=values.device, dtype=segments.dtype)
    ends = torch.searchsorted(segments, ar, side="right")
    starts = torch.searchsorted(segments, ar, side="left")
    longest = int((ends - starts).max()) if n else 0
    d = 1
    while d < longest:
        same = segments[d:] == segments[:-d]
        v = torch.cat([v[:d], v[d:] + torch.where(same, v[:-d],
                                                  torch.zeros_like(v[d:]))])
        d *= 2
    last = v[torch.clamp_min(ends - 1, 0)] if v.numel() else \
        values.new_zeros(n)
    # + 0.0 makes a sum of -0.0s +0.0, as a sum started from 0 is
    return torch.where(ends > starts, last, torch.zeros_like(last)) + 0.0


def _identity(dtype: torch.dtype, largest: bool):
    if dtype.is_floating_point:
        return float("inf") if largest else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if largest else info.min


def _segment_extreme(values, index, n: int, reduce: str):
    idx = _in_range(index, n)
    fill = _identity(values.dtype, largest=reduce == "amin")
    out = values.new_full((n + 1,) + tuple(values.shape[1:]), fill)
    if values.dim() > 1:
        idx = idx.view((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
    out.scatter_reduce_(0, idx, values, reduce, include_self=True)
    return out[:n]


def segment_min(values: torch.Tensor, index: torch.Tensor,
                n: int) -> torch.Tensor:
    """Per-segment minima (``jax.ops.segment_min``): an empty segment
    holds +inf (the integer type's maximum for integers)."""
    return _segment_extreme(values, index, n, "amin")


def segment_max(values: torch.Tensor, index: torch.Tensor,
                n: int) -> torch.Tensor:
    """Per-segment maxima (``jax.ops.segment_max``): an empty segment
    holds -inf (the integer type's minimum for integers)."""
    return _segment_extreme(values, index, n, "amax")


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """The stable order of rows by ``keys`` (1-d, equally long), the last
    key primary: ``jnp.lexsort(keys)``.  No key may hold NaN."""
    order = None
    for k in keys:
        if k.dtype.is_floating_point:
            k = torch.where(k == 0, torch.zeros_like(k), k)
        if order is not None:
            k = k[order]
        _, o = torch.sort(k, stable=True)
        order = o if order is None else order[o]
    return order
