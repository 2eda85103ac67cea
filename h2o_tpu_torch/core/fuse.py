"""Fused Rapids regions on one device — a port of ``h2o_tpu/core/fuse.py``.

The Rapids planner (``rapids/plan.py``) finds a chain of filter and
``na.omit`` stages feeding a sort, a group-by or a last filter, and runs
the whole chain here as one region.  Reference map: the predicate
tables :92-110, ``_pred_value`` and ``_keep_mask`` :112-145, the region
runners ``run_fused_sort`` :192-259 and :460-476, ``run_fused_filter``
:261-307 and :478-495 and ``run_fused_groupby`` :310-446 and :498-560.

Frames stay on the host (``core/frame.py``), and each verb of the eager
chain uploads the columns it reads and downloads its result
(``core/munge.py``): a chain of k predicate stages and a terminal verb
moves its rows across the bus about 2(k + 1) times.  A region moves them
twice: one ``_upload`` of the columns the region reads, the stages'
masks computed on the device, the terminal step, one ``_download`` of
the result.  The reference's regions are shard collectives that save
count syncs and repacks between shards; one device has neither, so the
saving here is the bus.

Parity with the eager chain (``H2O_TPU_RAPIDS_FUSE=0``), row for row and
bit for bit:

- A stage's mask is computed by the interpreter's own callables
  (``_PRED_BINOPS`` / ``_PRED_UNOPS`` are entries of ``rapids/interp.py``'s
  ``_BINOPS`` / ``_UNOPS``), a number operand made a float32 tensor as
  ``_elementwise`` makes it and two numbers combined by ``_scalar_op``.
  Every admitted op is elementwise and exact or correctly rounded in
  IEEE float32 (``exp`` and ``log`` are ``xlamath``'s fixed sequences of
  such ops), so a row's mask value does not depend on which other rows
  the stage's input holds: evaluating stage i over the base frame gives
  the eager value on every row that survived stages 1..i-1, and the
  stages conjoin as ``keep &= mask > 0`` does after each eager filter.
  A column is read as the eager ``as_float`` view (a categorical code
  below 0 is NaN); ``na.omit``'s ``notna`` drops a row with a NaN or, in a
  categorical column, a code below 0.
- Sort: ``lexsort`` with validity as the primary key (dropped rows last),
  then ``_sort_key_matrix``'s keys.  ``lexsort`` is a chain of stable
  sorts, so the kept rows come in the order of (keys, input row), which
  is the eager sort's order over the compacted frame; the first
  ``sum(keep)`` rows of the order are gathered and downloaded.
- Filter-only (k >= 2 stages): one device holds no ragged frame, so the
  eager chain's layout is its rows in order: the conjoined mask and one
  compaction.
- Group-by: the mask is ``_factorize_block``'s validity.  Valid rows sort
  first in the same relative order as the eager group-by over the
  filtered frame, so the group codes, each group's first row, and each
  group's positions in the sorted order are the eager ones; counts,
  minima and maxima are exact in any order, and ``sorted_segment_sum``'s
  tree for a group depends only on the group's length.  Only the
  columns the predicate, the keys and the aggregates read are uploaded,
  and the table is built by ``core/munge.py``'s ``_group_rows``, the body
  of ``groupby_frame``.

The reference's ``rapids.fuse`` autotuner lever (:563-611) measures fused
against per-verb runs; it comes with the autotuner (ROADMAP P14b).
``rapids/interp.py`` reaches this module only through the planner, which
it imports lazily, so importing its op tables here makes no cycle.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.core.frame import Frame
from h2o_tpu_torch.core.munge import (_download, _group_rows,
                                      _sort_key_matrix, _upload, _vec)
from h2o_tpu_torch.ops.segment import lexsort
from h2o_tpu_torch.rapids.interp import _BINOPS, _UNOPS, _full, _scalar_op

#: the OOM rung's site (``core/oom.py``) and the chaos injector's
SITE = "rapids.fuse"

# the operators a fused predicate admits: the reference's, each the
# interpreter's own callable
_PRED_BINOPS = {op: _BINOPS[op] for op in (
    "+", "-", "*", "/", "<", "<=", ">", ">=", "==", "!=", "&", "|")}
_PRED_UNOPS = {op: _UNOPS[op] for op in (
    "!", "is.na", "abs", "floor", "ceiling", "sqrt", "exp", "log")}


def _pred_value(pay: torch.Tensor, pos: Dict[int, int], e):
    """One static predicate expression over the region's transport matrix
    ``pay`` (frame column ``j`` at ``pay[:, pos[j]]``), as the eager
    elementwise ops compute it: a float32 tensor of one entry a row, or a
    number."""
    tag = e[0]
    if tag == "col":
        d = pay[:, pos[e[1]]]
        return torch.where(d < 0, torch.full_like(d, np.nan), d) if e[2] \
            else d
    if tag == "const":
        return e[1]
    if tag == "bin":
        op = _PRED_BINOPS[e[1]]
        a, b = _pred_value(pay, pos, e[2]), _pred_value(pay, pos, e[3])
        if not torch.is_tensor(a) and not torch.is_tensor(b):
            return _scalar_op(op, a, b)
        return op(a if torch.is_tensor(a) else _full(b, a),
                  b if torch.is_tensor(b) else _full(a, b))
    if tag == "un":
        return _PRED_UNOPS[e[1]](_pred_value(pay, pos, e[2]))
    if tag == "notna":
        ok = torch.ones(pay.shape[0], dtype=torch.bool, device=pay.device)
        for j, is_cat in enumerate(e[1]):
            d = pay[:, pos[j]]
            na = torch.isnan(d) | (d < 0) if is_cat else torch.isnan(d)
            ok = ok & ~na
        return ok.to(torch.float32)
    raise ValueError(f"bad fused predicate node {e!r}")


def _keep_mask(pay: torch.Tensor, pos: Dict[int, int],
               stages) -> torch.Tensor:
    """The rows every stage keeps: each stage applies as the eager filter
    applies its mask, ``keep &= mask > 0`` (a NaN entry drops its row)."""
    keep = torch.ones(pay.shape[0], dtype=torch.bool, device=pay.device)
    for _kind, expr in stages:
        keep = keep & (_pred_value(pay, pos, expr) > 0)
    return keep


def pred_cols(e) -> set:
    """The frame columns a predicate expression reads."""
    tag = e[0]
    if tag == "col":
        return {e[1]}
    if tag == "bin":
        return pred_cols(e[2]) | pred_cols(e[3])
    if tag == "un":
        return pred_cols(e[2])
    if tag == "notna":
        return set(range(len(e[1])))
    return set()


def _region(fr: Frame, read: Sequence[int], stages, device: DeviceLike):
    """The region's one upload, of the columns ``read`` (sorted), and the
    rows its stages keep: ``(transport matrix, keep)``."""
    pay = _upload(fr, read, cloud(device))
    return pay, _keep_mask(pay, {j: i for i, j in enumerate(read)}, stages)


def _rows_frame(fr: Frame, pay: torch.Tensor, rows: torch.Tensor) -> Frame:
    """The rows ``rows`` of every column, downloaded once."""
    out = _download(pay[rows])
    return Frame(list(fr.names),
                 [_vec(out[:, j], v) for j, v in enumerate(fr.vecs)])


def run_fused_sort(fr: Frame, stages,
                   sort_spec: Sequence[Tuple[int, bool, bool]],
                   device: DeviceLike = None) -> Frame:
    """A [stage..., sort] region: the rows every stage keeps, in the
    stable order of the ``(column, ascending, is_categorical)`` keys."""
    pay, keep = _region(fr, range(fr.ncols), stages, device)
    keys = _sort_key_matrix(pay[:, [j for j, _a, _c in sort_spec]],
                            [c for _j, _a, c in sort_spec],
                            [a for _j, a, _c in sort_spec])
    dropped = (~keep).to(torch.int32)
    order = lexsort([keys[:, k] for k in range(keys.shape[1])][::-1] +
                    [dropped])
    return _rows_frame(fr, pay, order[:int(keep.sum())])


def run_fused_filter(fr: Frame, stages, device: DeviceLike = None) -> Frame:
    """A region of k >= 2 filter and na.omit stages: the rows all of them
    keep, in order."""
    pay, keep = _region(fr, range(fr.ncols), stages, device)
    return _rows_frame(fr, pay, torch.nonzero(keep).reshape(-1))


def run_fused_groupby(fr: Frame, stages, gcols: Sequence[int],
                      aggs: Sequence[Tuple[str, int, str]],
                      device: DeviceLike = None) -> Frame:
    """A [stage, group-by] region: the group-by of the rows the stage
    keeps, the mask folded into the factorization's validity."""
    gcols = [int(j) for j in gcols]
    read = set(gcols) | {int(c) for _a, c, _na in aggs}
    for _kind, expr in stages:
        read |= pred_cols(expr)
    read = sorted(read)
    pay, keep = _region(fr, read, stages, device)
    return _group_rows(fr, pay, read, keep, gcols, aggs)
