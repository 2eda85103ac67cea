"""Segment (bulk) model building — port of ``h2o_tpu/models/segment.py``
(``SegmentModels`` :30-75, ``_segment_values`` :78-104, ``_segment_mask``
:107-119, ``train_segments`` :122-168; reference
hex/segments/{SegmentModelsBuilder,SegmentModels}.java).

``train_segments`` is a job body: the caller starts it on
``core/job.py``'s registry (as the reference's
``POST /3/SegmentModelsBuilders/{algo}`` handler does) and it reports
after each segment.  It builds one model per segment, the distinct
values of the segment columns (their Cartesian product, categorical
levels and numbers each sorted) or the rows of a ``segments_frame``.
A segment's model trains on the rows that hold its values, without the
segment columns, on the builder's device (``cuda:0`` unless
``params`` holds ``device="cpu"``), and is published under its key.
Each segment is isolated: a segment with no rows is ``FAILED`` with
``"empty segment"``, a build that raises is ``FAILED`` with its error,
and the others go on.  The result collection is published under
``dest`` before the first segment trains; ``parallelism`` > 1 builds
that many segments at a time on a thread pool.
"""

from __future__ import annotations

import itertools
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.core.log import get_logger
from h2o_tpu_torch.core.store import Key, dkv

log = get_logger("segment")


class SegmentModels:
    """DKV-resident result collection (hex/segments/SegmentModels.java)."""

    def __init__(self, key: str, segment_columns: List[str]):
        self.key = Key(key)
        self.segment_columns = list(segment_columns)
        # rows: {segment values dict, model_id, status, errors, warnings}
        self.rows: List[Dict] = []

    def to_frame(self) -> Frame:
        """One row a segment: the segment columns (numeric, or
        categorical over the sorted values), then ``model``, ``status``,
        ``errors`` and ``warnings`` as categoricals."""
        names: List[str] = list(self.segment_columns)
        cols: Dict[str, list] = {n: [] for n in names}
        meta = {"model": [], "status": [], "errors": [], "warnings": []}
        for r in self.rows:
            for n in names:
                cols[n].append(r["segment"].get(n))
            meta["model"].append(r.get("model_id") or "")
            meta["status"].append(r.get("status") or "")
            meta["errors"].append(r.get("errors") or "")
            meta["warnings"].append(r.get("warnings") or "")
        vecs, out_names = [], []
        for n in names:
            vals = cols[n]
            if all(isinstance(v, (int, float, np.floating, type(None)))
                   for v in vals):
                vecs.append(Vec(np.asarray(
                    [np.nan if v is None else float(v) for v in vals],
                    np.float32)))
            else:
                dom = sorted({str(v) for v in vals if v is not None})
                codes = np.asarray([dom.index(str(v)) if v is not None
                                    else -1 for v in vals], np.int32)
                vecs.append(Vec(codes, T_CAT, domain=dom))
            out_names.append(n)
        for n in ("model", "status", "errors", "warnings"):
            vals = meta[n]
            dom = sorted(set(vals))
            codes = np.asarray([dom.index(v) for v in vals], np.int32)
            vecs.append(Vec(codes, T_CAT, domain=dom))
            out_names.append(n)
        return Frame(out_names, vecs)


def _segment_values(train: Frame, segment_columns: List[str],
                    segments_frame: Optional[Frame]) -> List[Dict]:
    if segments_frame is not None:
        names = list(segments_frame.names)
        arrs = []
        for n in names:
            v = segments_frame.vec(n)
            arr = v.to_numpy()
            if v.is_categorical:
                dom = v.domain or []
                arr = [dom[int(c)] if c >= 0 else None for c in arr]
            arrs.append(arr)
        return [{n: a[i] for n, a in zip(names, arrs)}
                for i in range(segments_frame.nrows)]
    uniq: List[List] = []
    for n in segment_columns:
        v = train.vec(n)
        arr = v.to_numpy()
        if v.is_categorical:
            dom = v.domain or []
            vals = sorted({dom[int(c)] for c in arr if c >= 0})
        else:
            vals = sorted({float(x) for x in arr if not np.isnan(x)})
        uniq.append(vals)
    return [dict(zip(segment_columns, combo))
            for combo in itertools.product(*uniq)]


def _segment_mask(train: Frame, seg: Dict) -> np.ndarray:
    mask = np.ones(train.nrows, bool)
    for n, want in seg.items():
        v = train.vec(n)
        arr = v.to_numpy()
        if v.is_categorical:
            dom = v.domain or []
            code = dom.index(str(want)) if str(want) in dom else -2
            mask &= arr == code
        else:
            mask &= arr == float(want)
    return mask


def train_segments(job, builder_cls, params: Dict, x, y, train: Frame,
                   valid: Optional[Frame], segment_columns: List[str],
                   segments_frame: Optional[Frame],
                   dest: str, parallelism: int = 1) -> SegmentModels:
    """Build one model per segment (a job body: ``job`` gets a report
    after each segment); bounded parallel execution."""
    segs = _segment_values(train, segment_columns, segments_frame)
    seg_cols = segment_columns or (list(segments_frame.names)
                                   if segments_frame is not None else [])
    sm = SegmentModels(dest, seg_cols)
    sm.rows = [{"segment": s, "model_id": None, "status": "PENDING",
                "errors": "", "warnings": ""} for s in segs]
    dkv().put(dest, sm)
    drop = [c for c in seg_cols if c in train.names]
    n_done = [0]
    done_lock = threading.Lock()

    def build_one(i: int):
        row = sm.rows[i]
        seg = row["segment"]
        try:
            mask = _segment_mask(train, seg)
            if not mask.any():
                row["status"] = "FAILED"
                row["errors"] = "empty segment"
                return
            sub = train.slice_rows(mask).drop(drop)
            sv = valid.slice_rows(_segment_mask(valid, seg)).drop(drop) \
                if valid is not None else None
            m = builder_cls(**params).train(x=x, y=y, training_frame=sub,
                                            validation_frame=sv)
            dkv().put(m.key, m)
            row["model_id"] = str(m.key)
            row["status"] = "SUCCEEDED"
        except Exception as e:  # noqa: BLE001 — per-segment isolation
            row["status"] = "FAILED"
            row["errors"] = repr(e)
            log.warning("segment %s failed: %s", seg, e)
        finally:
            # under the lock, so the reports count up in order
            with done_lock:
                n_done[0] += 1
                job.update(n_done[0] / max(len(segs), 1),
                           f"{n_done[0]}/{len(segs)} segments")

    workers = max(int(parallelism or 1), 1)
    if workers == 1:
        for i in range(len(segs)):
            build_one(i)
    else:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(build_one, range(len(segs))))
    return sm
