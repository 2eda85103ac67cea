"""Columns and frames — a host-side port of ``h2o_tpu/core/frame.py``
(the column types :55-60, ``_merge_domains`` :78-92, the rollups
``_rollups_matrix_kernel`` :124-153 and ``RollupStats`` :167-183,
``Vec`` :185 with ``is_numeric`` :383 and ``map_inplace`` :658-675,
``frame_device_ok`` :802-810, ``Frame`` :812 with
``from_numpy`` :828, ``from_dict`` :839, ``ncols`` :860,
``__getitem__``/``__contains__``/``subframe``/``drop``/``add``/``cbind``
:902-932, ``as_matrix`` :1003 and ``types`` :1061), with the streaming
appends (``_append_capacity`` :68-76, ``Vec.append`` :534-623,
``_chunk_cols_from_frame`` :778-800, ``Frame.append_rows`` :933-968)
and the sparse codec ``SparseVec`` (:678-777).

Columns are numpy arrays: numeric ones float32 with NaN for NA,
categorical ones (``T_CAT``) int32 codes with -1 for NA and a host
domain, time ones (``T_TIME``) a float32 payload of milliseconds since
the epoch (UTC) with an exact float64 copy (``host_f64``), string and
uuid ones (``T_STR``, ``T_UUID``) host lists with None for NA.  A frame
has a DKV key (``Frame.key``, ``frame_<hex>`` unless the constructor is
given ``key=``, as ``h2o_tpu/core/frame.py:816-851``); it is published in
``store.dkv()`` only by whoever names it there.  There is no row padding
and no sharding: a frame of ``n`` rows holds exactly ``n`` rows, and
``as_matrix`` lands them on the device the caller names.  (The JAX frame pads rows and masks them; padded rows
never reach a histogram there, so no result depends on them.)

``Vec.append`` grows a column in place into a host buffer of
power-of-two capacity, so a stream of ``n`` rows in chunks copies each
row O(1) times on average instead of re-concatenating the column for
every chunk.  ``SparseVec`` keeps ``(row index, value)`` pairs of a
mostly-default column (SVMLight's one-hot blocks) and builds its dense
float32 form once, on the first read of ``data``; a write of dense
values graduates it out of the codec.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from h2o_tpu_torch.core.store import Key

T_NUM = "real"     # numeric: float32, NaN = NA
T_CAT = "enum"     # categorical: int32 codes, -1 = NA, host domain
T_TIME = "time"    # ms since the epoch: float32 payload + exact float64
T_STR = "string"   # host list of str, None = NA
T_UUID = "uuid"    # host list, None = NA
_TYPES = (T_NUM, T_CAT, T_TIME, T_STR, T_UUID)


def _merge_domains(base: Optional[List], new: Optional[List]):
    """Union categorical domain (base levels keep their codes, new levels
    append in first-seen order — the multi-file domain merge,
    ParseDataset.java:356-535) plus the remap array taking ``new``-local
    codes into the union space; its last entry maps -1 (NA) to -1."""
    union = list(base or [])
    seen = {d: i for i, d in enumerate(union)}
    remap = np.empty(len(new or []) + 1, np.int32)
    remap[-1] = -1
    for j, d in enumerate(new or []):
        if d not in seen:
            seen[d] = len(union)
            union.append(d)
        remap[j] = seen[d]
    return union, remap


def _append_capacity(n: int) -> int:
    """Host buffer capacity for ``n`` rows on the append path: the
    smallest power of two >= n (the reference's ``bucket_pow2``)."""
    return 1 if n <= 1 else 1 << int(n - 1).bit_length()


class RollupStats:
    """A column's rollups (water/fvec/RollupStats.java): the non-NA
    count ``cnt``, ``nacnt``, ``mean`` = sum / cnt and ``sigma`` = the
    square root of the sum of squared deviations over cnt - 1, both in
    float32 as the reference computes them, ``min``, ``max`` (+inf and
    -inf without a value), ``zeros`` and ``isint``.  Categorical columns
    roll up their codes, NA codes counting as NA."""

    __slots__ = ("cnt", "nacnt", "mean", "sigma", "min", "max", "zeros",
                 "isint")

    def __init__(self, x: np.ndarray):
        isna = np.isnan(x)
        self.nacnt = int(np.count_nonzero(isna))
        ok = x[~isna] if self.nacnt else x
        cnt = ok.size
        self.cnt = int(cnt)
        mean = np.float32(ok.sum(dtype=np.float32)) / np.float32(max(cnt, 1))
        dev = ok - mean
        var = np.float32(np.dot(dev, dev)) / np.float32(max(cnt - 1, 1))
        self.mean = float(mean)
        self.sigma = float(np.sqrt(var))
        self.min = float(ok.min()) if cnt else float("inf")
        self.max = float(ok.max()) if cnt else float("-inf")
        self.zeros = int(np.count_nonzero(ok == 0))
        self.isint = bool(np.array_equal(ok, np.rint(ok)))


class Vec:
    """One column, held on the host."""

    def __init__(self, data, vtype: str = T_NUM,
                 domain: Optional[List[str]] = None):
        if vtype not in _TYPES:
            raise ValueError(f"unsupported column type {vtype!r}")
        self.type = vtype
        self.domain = list(domain) if domain is not None else None
        self.host_data: Optional[List] = None
        self.host_f64: Optional[np.ndarray] = None
        self._rollups: Optional[RollupStats] = None
        if vtype in (T_STR, T_UUID):
            self.host_data = list(data)
            self.data = None
            return
        arr = np.asarray(data)
        if arr.ndim != 1:
            raise ValueError("a Vec holds one column (1-d data)")
        if vtype == T_CAT:
            if self.domain is None:
                raise ValueError("a categorical Vec needs a domain")
            self.data = arr.astype(np.int32)
        else:
            if vtype == T_TIME:
                # ms since the epoch exceed float32's precision (~131 s
                # apart at today's dates): an exact host copy stays
                # beside the float32 payload that binning reads
                self.host_f64 = arr.astype(np.float64)
            self.data = arr.astype(np.float32)

    @property
    def nrows(self) -> int:
        if self.host_data is not None:
            return len(self.host_data)
        return int(self.data.shape[0])

    @property
    def is_categorical(self) -> bool:
        return self.type == T_CAT

    @property
    def is_numeric(self) -> bool:
        return self.type in (T_NUM, T_TIME)

    @property
    def cardinality(self) -> int:
        return len(self.domain) if self.domain is not None else -1

    def as_float(self) -> np.ndarray:
        """float32 with NaN NAs (categorical codes -1 -> NaN; time the
        float32 payload)."""
        if self.data is None:
            raise ValueError(f"a {self.type} column has no numeric payload")
        if self.is_categorical:
            return np.where(self.data < 0, np.nan,
                            self.data.astype(np.float32)).astype(np.float32)
        return self.data

    def to_numpy(self) -> np.ndarray:
        """Host values: float32 numerics, int32 codes, the exact float64
        milliseconds of a time column, an object array of strings."""
        if self.host_data is not None:
            return np.asarray(self.host_data, dtype=object)
        if self.host_f64 is not None:
            return self.host_f64
        return self.data

    def take(self, sel) -> "Vec":
        """The selected rows (a slice, index array or mask) as a new Vec."""
        if self.host_data is not None:
            idx = np.arange(self.nrows)[sel]
            return Vec([self.host_data[i] for i in idx], self.type)
        return Vec(self.to_numpy()[sel], self.type, self.domain)

    @property
    def rollups(self) -> RollupStats:
        """The column's rollups, computed once and dropped by
        ``append``."""
        if self._rollups is None:
            self._rollups = RollupStats(self.as_float())
        return self._rollups

    def _grow(self, slot: str, cur: np.ndarray, new: np.ndarray):
        """``cur`` followed by ``new`` as a prefix view of the buffer in
        ``slot``, reallocated at the next power-of-two capacity when full
        (or when ``cur`` is no longer that buffer's view)."""
        n_old, n = cur.shape[0], cur.shape[0] + new.shape[0]
        buf, view = self.__dict__.get(slot) or (None, None)
        if view is not cur or buf.shape[0] < n:
            buf = np.empty(_append_capacity(n), new.dtype)
            buf[:n_old] = cur
        buf[n_old:n] = new
        out = buf[:n]
        self.__dict__[slot] = (buf, out)
        return out

    def append(self, values, domain: Optional[List[str]] = None) -> None:
        """Grow this column by ``values`` rows in place (reference
        ``Vec.append``): float payloads for numeric and time columns
        (time as float64 milliseconds), int codes for categoricals, a
        list for strings.  ``domain`` is a chunk's local categorical
        domain: new levels extend this column's domain in first-seen
        order and the chunk's codes are remapped into the union (codes
        outside it become NA).  Cached rollups are dropped."""
        self._rollups = None
        if self.host_data is not None:
            self.host_data.extend(list(values))
            return
        arr = np.asarray(values)
        if arr.shape[0] == 0:
            return
        if self.type == T_CAT:
            codes = arr.astype(np.int32)
            if domain is not None and list(domain) != list(self.domain
                                                          or []):
                self.domain, remap = _merge_domains(self.domain, domain)
                ok = (codes >= 0) & (codes < len(domain))
                codes = np.where(ok, remap[np.clip(codes, 0,
                                                   len(domain) - 1)],
                                 -1).astype(np.int32)
            self.data = self._grow("_buf", self.data, codes)
            return
        if self.type == T_TIME:
            if self.host_f64 is None:
                raise ValueError(
                    "appending to a T_TIME vec that lost its exact "
                    "float64 host copy would silently degrade "
                    "time-part extraction to f32 precision")
            self.host_f64 = self._grow("_buf64", self.host_f64,
                                       arr.astype(np.float64))
        self.data = self._grow("_buf", self.data, arr.astype(np.float32))

    def map_inplace(self, fn, *extras, device=None) -> None:
        """``payload = fn(payload, *extras)`` on the device (reference
        ``Vec.map_inplace``, :658-675): the payload (float32, or int32
        codes) is uploaded once, transformed by ``mrtask.mutate_array``
        and written back to the host; the cached rollups are dropped.  A
        time column is refused, since the transform would desync its
        exact float64 copy."""
        if self.data is None:
            raise ValueError("map_inplace needs a numeric payload, not a "
                             f"{self.type} column")
        if self.host_f64 is not None:
            raise ValueError("map_inplace would desync the exact host copy "
                             "(T_TIME)")
        from h2o_tpu_torch.core.mrtask import mutate_array
        new = mutate_array(fn, self.data, *extras, device=device)
        self.data = new.cpu().numpy().astype(
            np.int32 if self.type == T_CAT else np.float32)
        self._rollups = None

    def is_constant(self) -> bool:
        """The ``ignore_const_cols`` test DataInfo applies in both modes
        (``h2o_tpu/models/model.py:58-69``): a categorical column with at
        most one level, or a numeric column whose rollup sigma is 0 (an
        all-NA column counts too)."""
        if self.is_categorical:
            return self.cardinality <= 1
        return self.rollups.sigma == 0


class SparseVec(Vec):
    """A numeric column of ``(row index, value)`` pairs over a default
    value — the reference's ``SparseVec`` (the CXIChunk analog, store
    only the non-default values).  The dense float32 form is built once,
    on the first read of ``data`` (``as_float``, ``to_numpy``,
    ``rollups``, ``as_matrix``); assigning ``data`` (as ``append`` does)
    graduates the column out of the codec."""

    def __init__(self, idx, vals, nrows: int, default: float = 0.0,
                 vtype: str = T_NUM):
        idx = np.asarray(idx, np.int64)
        vals = np.asarray(vals, np.float32)
        if idx.shape != vals.shape or idx.ndim != 1:
            raise ValueError("a SparseVec needs one value per index")
        if vtype not in (T_NUM, T_TIME):
            raise ValueError(f"a SparseVec holds numbers, not {vtype!r}")
        self.type = vtype
        self.domain = None
        self.host_data = None
        self.host_f64 = None
        self._rollups = None
        self._n = int(nrows)
        self._sparse = (idx, vals, np.float32(default))
        self._dense: Optional[np.ndarray] = None

    @property
    def nnz(self) -> int:
        """The stored pairs (while the column is in the codec)."""
        return len(self._sparse[0])

    @property
    def nrows(self) -> int:
        return self._n if self._dense is None else int(self._dense.shape[0])

    @property
    def data(self) -> np.ndarray:
        if self._dense is None:
            idx, vals, default = self._sparse
            dense = np.full(self._n, default, np.float32)
            dense[idx] = vals
            self._dense = dense
        return self._dense

    @data.setter
    def data(self, value) -> None:
        self._sparse = None
        self._dense = value


def _chunk_cols_from_frame(target: "Frame", chunk: "Frame") -> Dict:
    """Host column payloads of a chunk frame, shaped for ``Vec.append``
    (reference ``_chunk_cols_from_frame``)."""
    if list(chunk.names) != list(target.names):
        raise ValueError(
            f"append_rows schema mismatch: frame has {target.names}, "
            f"chunk has {chunk.names}")
    cols: Dict = {}
    for name, v in zip(chunk.names, chunk.vecs):
        tv = target.vec(name)
        if v.type != tv.type:
            raise ValueError(
                f"append_rows type mismatch on {name!r}: frame is "
                f"{tv.type}, chunk is {v.type}")
        if v.host_data is not None:
            cols[name] = list(v.host_data)
        elif v.type == T_CAT:
            cols[name] = (v.to_numpy(), list(v.domain or []))
        else:
            cols[name] = v.to_numpy()
    return cols


def frame_device_ok(fr: "Frame") -> bool:
    """True when every column has a payload the device verbs compute on
    exactly: numeric and categorical columns only (reference
    ``frame_device_ok``, :802-810).  A time column keeps an exact float64
    copy on the host; strings and uuids have no numeric payload."""
    return bool(fr.vecs) and all(
        v.type in (T_NUM, T_CAT) and v.host_data is None for v in fr.vecs)


class Frame:
    """An ordered collection of equally long columns."""

    def __init__(self, names: Sequence[str] = (), vecs: Sequence[Vec] = (),
                 key: Optional[str] = None):
        if len(names) != len(vecs):
            raise ValueError("one name per column")
        self.names: List[str] = list(names)
        self.vecs: List[Vec] = list(vecs)
        for v in self.vecs[1:]:
            if v.nrows != self.vecs[0].nrows:
                raise ValueError("ragged frame: columns differ in length")
        self.key = Key(key) if key else Key.make("frame")

    @classmethod
    def from_numpy(cls, array: np.ndarray,
                   names: Optional[Sequence[str]] = None,
                   key: Optional[str] = None) -> "Frame":
        """float32 numeric columns of a 1-d or 2-d array, named C1.. unless
        ``names`` are given."""
        array = np.asarray(array, dtype=np.float32)
        if array.ndim == 1:
            array = array[:, None]
        names = list(names) if names else [f"C{i + 1}" for i in
                                           range(array.shape[1])]
        return cls(names, [Vec(array[:, j]) for j in range(array.shape[1])],
                   key=key)

    @classmethod
    def from_dict(cls, cols: Dict[str, Union[np.ndarray, list]],
                  key: Optional[str] = None) -> "Frame":
        """String columns become categoricals (sorted domain), the rest
        float32 numerics — as ``h2o_tpu`` ``Frame.from_dict``."""
        names, vecs = [], []
        for name, col in cols.items():
            names.append(name)
            arr = np.asarray(col)
            if arr.dtype.kind in "OUS":
                domain, codes = np.unique(arr.astype(str),
                                          return_inverse=True)
                vecs.append(Vec(codes.astype(np.int32), T_CAT,
                                domain=[str(d) for d in domain]))
            else:
                vecs.append(Vec(arr.astype(np.float32)))
        return cls(names, vecs, key=key)

    @property
    def nrows(self) -> int:
        return self.vecs[0].nrows if self.vecs else 0

    @property
    def ncols(self) -> int:
        return len(self.vecs)

    def vec(self, name: str) -> Vec:
        return self.vecs[self.names.index(name)]

    def __getitem__(self, name):
        if isinstance(name, str):
            return self.vec(name)
        if isinstance(name, (list, tuple)):
            return self.subframe(name)
        raise TypeError(name)

    def __contains__(self, name: str) -> bool:
        return name in self.names

    def subframe(self, names: Sequence[str]) -> "Frame":
        return Frame(list(names), [self.vec(n) for n in names])

    def drop(self, names: Union[str, Sequence[str]]) -> "Frame":
        if isinstance(names, str):
            names = [names]
        return self.subframe([n for n in self.names if n not in names])

    def add(self, name: str, vec: Vec) -> "Frame":
        """Append a column in place (``h2o_tpu`` ``Frame.add``)."""
        if name in self.names:
            raise ValueError(f"column {name!r} already exists")
        if self.vecs and vec.nrows != self.nrows:
            raise ValueError("ragged frame: columns differ in length")
        self.names.append(name)
        self.vecs.append(vec)
        return self

    def cbind(self, other: "Frame") -> "Frame":
        return Frame(self.names + other.names, self.vecs + other.vecs)

    def append_rows(self, chunk) -> "Frame":
        """Append a chunk of rows in place (reference
        ``Frame.append_rows``): ``chunk`` is a dict of host payloads
        (``name -> ndarray`` for numeric and time, ``(codes, domain)``
        for categoricals, ``list`` for strings: what ``tokenize_chunk``
        returns) or a frame of the same names and types.  Every column
        grows by the same count through ``Vec.append``; a missing column
        or columns of different lengths raise before any column grows."""
        cols = chunk if isinstance(chunk, dict) else \
            _chunk_cols_from_frame(self, chunk)
        missing = [n for n in self.names if n not in cols]
        if missing:
            raise ValueError(f"append_rows chunk is missing columns "
                             f"{missing}")
        n_new = None
        for name in self.names:
            payload = cols[name]
            n = len(payload[0] if isinstance(payload, tuple) else payload)
            if n_new is None:
                n_new = n
            elif n != n_new:
                raise ValueError(
                    f"ragged append chunk: column {name!r} has {n} rows, "
                    f"expected {n_new}")
        for name in self.names:
            payload = cols[name]
            vals, dom = (payload if isinstance(payload, tuple)
                         else (payload, None))
            self.vec(name).append(vals, domain=dom)
        return self

    def types(self) -> List[str]:
        return [v.type for v in self.vecs]

    def slice_rows(self, sel) -> "Frame":
        """New frame of the selected rows (a slice, index array or mask)."""
        return Frame(self.names, [v.take(sel) for v in self.vecs])

    def as_matrix(self, names: Optional[Sequence[str]],
                  device: Union[str, torch.device]) -> torch.Tensor:
        """(nrows, ncols) float32 matrix of the named columns (every
        column when ``names`` is None) on ``device``, which the caller
        names; categoricals appear as float codes, time as its float32
        milliseconds, NA as NaN."""
        names = list(names) if names is not None else self.names
        m = np.stack([self.vec(n).as_float() for n in names], axis=1) \
            if names else np.zeros((self.nrows, 0), np.float32)
        return torch.from_numpy(np.ascontiguousarray(m, np.float32)).to(
            device)
