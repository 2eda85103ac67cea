"""Columns and frames — a host-side port of ``h2o_tpu/core/frame.py``
(``Vec`` :185, ``Frame`` :812, ``Frame.from_dict`` :839, ``Frame.add`` :921,
``Frame.as_matrix`` :1003).

Columns are numpy arrays: numeric ones float32 with NaN for NA,
categorical ones (``T_CAT``) int32 codes with -1 for NA and a host
domain.  There is no DKV, no row padding and no sharding: a frame of
``n`` rows holds exactly ``n`` rows, and ``as_matrix`` lands them on
the device the caller names.  (The JAX frame pads rows and masks them;
padded rows never reach a histogram there, so no result depends on
them.)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

T_NUM = "real"     # numeric: float32, NaN = NA
T_CAT = "enum"     # categorical: int32 codes, -1 = NA, host domain


class Vec:
    """One column, held on the host."""

    def __init__(self, data, vtype: str = T_NUM,
                 domain: Optional[List[str]] = None):
        if vtype not in (T_NUM, T_CAT):
            raise ValueError(f"unsupported column type {vtype!r}")
        arr = np.asarray(data)
        if arr.ndim != 1:
            raise ValueError("a Vec holds one column (1-d data)")
        self.type = vtype
        self.domain = list(domain) if domain is not None else None
        if vtype == T_CAT:
            if self.domain is None:
                raise ValueError("a categorical Vec needs a domain")
            self.data = arr.astype(np.int32)
        else:
            self.data = arr.astype(np.float32)

    @property
    def nrows(self) -> int:
        return int(self.data.shape[0])

    @property
    def is_categorical(self) -> bool:
        return self.type == T_CAT

    @property
    def cardinality(self) -> int:
        return len(self.domain) if self.domain is not None else -1

    def as_float(self) -> np.ndarray:
        """float32 with NaN NAs (categorical codes -1 -> NaN)."""
        if self.is_categorical:
            return np.where(self.data < 0, np.nan,
                            self.data.astype(np.float32)).astype(np.float32)
        return self.data

    def is_constant(self) -> bool:
        """The ``ignore_const_cols`` test DataInfo applies
        (``h2o_tpu/models/model.py:58-69``): a categorical column with at
        most one level, or a numeric column whose non-NA values are all
        equal (rollup sigma == 0; an all-NA column counts too)."""
        if self.is_categorical:
            return self.cardinality <= 1
        v = self.data[~np.isnan(self.data)]
        return v.size == 0 or bool(v.min() == v.max())


class Frame:
    """An ordered collection of equally long columns."""

    def __init__(self, names: Sequence[str] = (), vecs: Sequence[Vec] = ()):
        if len(names) != len(vecs):
            raise ValueError("one name per column")
        self.names: List[str] = list(names)
        self.vecs: List[Vec] = list(vecs)
        for v in self.vecs[1:]:
            if v.nrows != self.vecs[0].nrows:
                raise ValueError("ragged frame: columns differ in length")

    @classmethod
    def from_dict(cls, cols: Dict[str, Union[np.ndarray, list]]) -> "Frame":
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
        return cls(names, vecs)

    @property
    def nrows(self) -> int:
        return self.vecs[0].nrows if self.vecs else 0

    def vec(self, name: str) -> Vec:
        return self.vecs[self.names.index(name)]

    def add(self, name: str, vec: Vec) -> "Frame":
        """Append a column in place (``h2o_tpu`` ``Frame.add``)."""
        if name in self.names:
            raise ValueError(f"column {name!r} already exists")
        if self.vecs and vec.nrows != self.nrows:
            raise ValueError("ragged frame: columns differ in length")
        self.names.append(name)
        self.vecs.append(vec)
        return self

    def slice_rows(self, sel) -> "Frame":
        """New frame of the selected rows (a slice, index array or mask)."""
        return Frame(self.names,
                     [Vec(v.data[sel], v.type, v.domain) for v in self.vecs])

    def as_matrix(self, names: Optional[Sequence[str]],
                  device: Union[str, torch.device]) -> torch.Tensor:
        """(nrows, ncols) float32 matrix of the named columns (every
        column when ``names`` is None) on ``device``, which the caller
        names; categoricals appear as float codes, NA as NaN."""
        names = list(names) if names is not None else self.names
        m = np.stack([self.vec(n).as_float() for n in names], axis=1) \
            if names else np.zeros((self.nrows, 0), np.float32)
        return torch.from_numpy(np.ascontiguousarray(m, np.float32)).to(
            device)
