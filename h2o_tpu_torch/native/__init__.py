"""Host C++ libraries of the port, loaded with ctypes — port of
``h2o_tpu/native/__init__.py`` (``lib`` :51, ``treeshap_lib`` :91,
``treeshap_contribs`` :127, ``tree_leaf_assign`` :168, ``_nthreads`` :205,
``tokenize_csv`` :209, ``spans_to_fixed_bytes`` :256).

Two libraries, each from its source in this directory:

* ``csv_tokenizer.cpp`` — the CSV byte loop of ``core/parse.py``: a
  quote-aware line index and a per-row tokenizer, threads over rows;
* ``treeshap.cpp`` — TreeSHAP and leaf assignment over a forest's node
  arrays on binned rows (``models/tree/contributions.py``), threads over
  rows.

Both are host code in the reference too (no Pallas kernel), and stay on
the host here.  Each is compiled by ``g++`` on first use into
``h2o_tpu_torch/_build/`` (gitignored), and again when its source is
newer than the library.  A failed build raises with the compiler's
output: no caller falls back to a Python version (the numpy TreeSHAP in
``contributions.py`` is the tests' oracle, not a fallback).  Nothing is
built at import.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import threading
import time
from ctypes import (CDLL, POINTER, c_char, c_char_p, c_double, c_int,
                    c_long, c_ubyte)
from pathlib import Path
from typing import Dict, NamedTuple, Optional

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")


class Built(NamedTuple):
    """A loaded library, the file it was loaded from, and the seconds
    its build and load took (0 build when the library was current)."""
    lib: CDLL
    path: Path
    seconds: float


_lock = threading.Lock()
_LIBS: Dict[str, Built] = {}


def _compile(src: Path, so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            proc = subprocess.run([CXX, *CXX_FLAGS, str(src), "-o", tmp],
                                  capture_output=True, text=True,
                                  timeout=300)
        except OSError as e:
            raise RuntimeError(
                f"h2o_tpu_torch.native: cannot run the C++ compiler "
                f"{CXX!r} to build {src.name}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"h2o_tpu_torch.native: {CXX} failed ({proc.returncode}) "
                f"building {src}:\n{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(name: str) -> Built:
    """The library built from ``<name>.cpp``, compiling it when it is
    missing or older than its source."""
    with _lock:
        got = _LIBS.get(name)
        if got is not None:
            return got
        t0 = time.perf_counter()
        src = _DIR / f"{name}.cpp"
        so = BUILD_DIR / f"lib{name}.so"
        if not (so.exists() and
                so.stat().st_mtime >= src.stat().st_mtime):
            _compile(src, so)
        lib = CDLL(str(so))
        _BIND[name](lib)
        got = Built(lib, so, time.perf_counter() - t0)
        _LIBS[name] = got
        return got


def _bind_tokenizer(L: CDLL) -> None:
    L.csv_index_lines.restype = c_long
    L.csv_index_lines.argtypes = [c_char_p, c_long, POINTER(c_long),
                                  c_long, c_int]
    L.csv_parse.restype = c_int
    L.csv_parse.argtypes = [c_char_p, c_long, POINTER(c_long), c_long,
                            c_long, c_char, c_int, POINTER(c_ubyte),
                            c_char_p, POINTER(c_int), c_int,
                            POINTER(c_double), POINTER(c_long),
                            POINTER(c_int), POINTER(c_ubyte), c_int]


def _bind_treeshap(L: CDLL) -> None:
    i64, i32p = c_long, POINTER(c_int)
    L.treeshap_contribs.restype = c_int
    L.treeshap_contribs.argtypes = [
        i32p, i64, i64, i32p, POINTER(c_ubyte),
        POINTER(c_double), POINTER(c_double), i32p, i32p,
        POINTER(c_ubyte), i64,
        i64, i64, i64, POINTER(c_double), c_int]
    L.tree_leaf_assign.restype = c_int
    L.tree_leaf_assign.argtypes = [
        i32p, i64, i64, i32p, POINTER(c_ubyte), i32p, i32p,
        POINTER(c_ubyte), i64,
        i64, i64, i64, i32p, POINTER(c_char), i64]


_BIND = {"csv_tokenizer": _bind_tokenizer, "treeshap": _bind_treeshap}


def lib() -> CDLL:
    """The CSV tokenizer library, built on first use."""
    return load("csv_tokenizer").lib


def treeshap_lib() -> CDLL:
    """The TreeSHAP / leaf-assignment library, built on first use."""
    return load("treeshap").lib


def _nthreads() -> int:
    return max(1, min(os.cpu_count() or 1, 16))


def _i32p(a: Optional[np.ndarray]):
    return a.ctypes.data_as(POINTER(c_int)) if a is not None else None


def _u8p(a: Optional[np.ndarray]):
    return a.ctypes.data_as(POINTER(c_ubyte)) if a is not None else None


def _tree_arrays(bins, split_col, bitset, child, thr, na_left):
    """Contiguous host copies in the library's types, with the shapes
    checked: bins (R, C), the forest (T, N) with (T, N, B1) bitsets."""
    bins = np.ascontiguousarray(bins, np.int32)
    sc = np.ascontiguousarray(split_col, np.int32)
    if bins.ndim != 2 or sc.ndim != 2:
        raise ValueError("bins must be (R, C) and split_col (T, N)")
    T, N = sc.shape
    bs = np.ascontiguousarray(bitset, np.uint8)
    if bs.ndim != 3 or bs.shape[:2] != (T, N):
        raise ValueError(f"bitset must be ({T}, {N}, B1)")
    out = [bins, sc, bs]
    for a, dt in ((child, np.int32), (thr, np.int32), (na_left, np.uint8)):
        if a is not None:
            a = np.ascontiguousarray(a, dt)
            if a.shape != (T, N):
                raise ValueError(f"node arrays must be ({T}, {N})")
        out.append(a)
    if (thr is None) != (na_left is None):
        raise ValueError("thr and na_left come together")
    if np.any(sc >= bins.shape[1]):
        raise ValueError("a split column lies outside the binned columns")
    ch = out[3]
    if ch is not None and np.any(ch + 1 >= N):
        raise ValueError("a child pointer lies outside the node pool")
    return out


def treeshap_contribs(bins: np.ndarray, split_col: np.ndarray,
                      bitset: np.ndarray, value: np.ndarray,
                      node_w: np.ndarray,
                      child: Optional[np.ndarray],
                      thr: Optional[np.ndarray] = None,
                      na_left: Optional[np.ndarray] = None,
                      fine_na: int = -1) -> np.ndarray:
    """SHAP contributions for one class's (T, N) tree stack on binned
    rows; returns (R, C+1) float64 with the bias in the last column."""
    L = treeshap_lib()
    bins, sc, bs, ch, th, na = _tree_arrays(bins, split_col, bitset, child,
                                            thr, na_left)
    R, C = bins.shape
    T, N = sc.shape
    vl = np.ascontiguousarray(value, np.float64)
    nw = np.ascontiguousarray(node_w, np.float64)
    if vl.shape != (T, N) or nw.shape != (T, N):
        raise ValueError(f"value and node_w must be ({T}, {N})")
    phi = np.zeros((R, C + 1), np.float64)
    rc = L.treeshap_contribs(
        _i32p(bins), R, C, _i32p(sc), _u8p(bs),
        vl.ctypes.data_as(POINTER(c_double)),
        nw.ctypes.data_as(POINTER(c_double)),
        _i32p(ch), _i32p(th), _u8p(na),
        int(fine_na), T, N, bs.shape[2],
        phi.ctypes.data_as(POINTER(c_double)), _nthreads())
    if rc != 0:
        raise RuntimeError(f"treeshap_contribs failed rc={rc}")
    return phi


def tree_leaf_assign(bins: np.ndarray, split_col: np.ndarray,
                     bitset: np.ndarray,
                     child: Optional[np.ndarray],
                     thr: Optional[np.ndarray] = None,
                     na_left: Optional[np.ndarray] = None,
                     fine_na: int = -1, max_path: int = 64):
    """Per-row/tree terminal node ids (R, T) int32 and L/R descent paths
    (R, T) ``S{max_path}``."""
    L = treeshap_lib()
    bins, sc, bs, ch, th, na = _tree_arrays(bins, split_col, bitset, child,
                                            thr, na_left)
    R, C = bins.shape
    T, N = sc.shape
    ids = np.zeros((R, T), np.int32)
    paths = np.zeros((R, T), f"S{max_path}")
    rc = L.tree_leaf_assign(
        _i32p(bins), R, C, _i32p(sc), _u8p(bs), _i32p(ch), _i32p(th),
        _u8p(na), int(fine_na), T, N, bs.shape[2], _i32p(ids),
        paths.ctypes.data_as(POINTER(c_char)), max_path)
    if rc != 0:
        raise RuntimeError(f"tree_leaf_assign failed rc={rc}")
    return ids, paths


def tokenize_csv(data: bytes, sep: str, ncols: int,
                 is_numeric: np.ndarray, na_strings=()):
    """Tokenize a CSV byte buffer.

    Returns (nrows, num (rows, n_num) float64, str_off (rows, n_str)
    int64, str_len (rows, n_str) int32, str_quoted (rows, n_str) uint8).
    Rows include any header line; the caller slices it off.
    ``na_strings`` mark numeric-column NA sentinels (NaN in the output).
    """
    L = lib()
    if len(sep) != 1:
        raise ValueError(f"the separator must be one character, got {sep!r}")
    is_numeric = np.ascontiguousarray(is_numeric, np.uint8)
    if is_numeric.shape != (ncols,):
        raise ValueError(f"is_numeric must have one flag per column "
                         f"({ncols})")
    n = len(data)
    # at most one row per newline, plus a last line without one
    max_rows = int(np.count_nonzero(
        np.frombuffer(data, np.uint8) == ord("\n"))) + 2
    offsets = np.empty(max_rows + 1, np.int64)
    nrows = L.csv_index_lines(
        data, n, offsets.ctypes.data_as(POINTER(c_long)), max_rows,
        _nthreads())
    # drop a trailing empty line (the file ends with \n)
    while nrows > 0 and offsets[nrows - 1] >= n:
        nrows -= 1
    n_num = int(is_numeric.sum())
    n_str = ncols - n_num
    na_list = [s.encode() if isinstance(s, str) else s for s in na_strings]
    na_blob = b"".join(na_list)
    na_offs = np.zeros(len(na_list) + 1, np.int32)
    np.cumsum([len(s) for s in na_list], out=na_offs[1:])
    num = np.empty((nrows, n_num), np.float64)
    soff = np.empty((nrows, max(n_str, 1)), np.int64)
    slen = np.empty((nrows, max(n_str, 1)), np.int32)
    squo = np.empty((nrows, max(n_str, 1)), np.uint8)
    rc = L.csv_parse(
        data, n, offsets.ctypes.data_as(POINTER(c_long)), 0, nrows,
        c_char(sep.encode()), ncols, _u8p(is_numeric),
        na_blob, na_offs.ctypes.data_as(POINTER(c_int)), len(na_list),
        num.ctypes.data_as(POINTER(c_double)),
        soff.ctypes.data_as(POINTER(c_long)),
        slen.ctypes.data_as(POINTER(c_int)), _u8p(squo), _nthreads())
    if rc != 0:
        raise RuntimeError(f"csv_parse failed rc={rc}")
    return (nrows, num, soff[:, :n_str], slen[:, :n_str],
            squo[:, :n_str])


def spans_to_fixed_bytes(data_np: np.ndarray, off: np.ndarray,
                         length: np.ndarray,
                         budget_bytes: int = 1 << 26) -> np.ndarray:
    """Token spans -> (rows,) fixed-width ``S`` bytes array, vectorised
    in row batches so one long outlier cell cannot inflate the transient
    (rows, maxlen) gather beyond ``budget_bytes``."""
    rows = len(off)
    if rows == 0:
        return np.empty((0,), "S1")
    global_max = max(int(length.max()), 1)

    def convert(off_b, len_b):
        maxlen = max(int(len_b.max()), 1)
        idx = off_b[:, None] + np.arange(maxlen)[None, :]
        np.clip(idx, 0, len(data_np) - 1, out=idx)
        chars = data_np[idx]                    # (batch, maxlen) uint8
        mask = np.arange(maxlen)[None, :] < len_b[:, None]
        chars = np.where(mask, chars, 0)
        # widen to the global max so batches concatenate losslessly
        return np.ascontiguousarray(chars).view(f"S{maxlen}")[:, 0].astype(
            f"S{global_max}")

    batch = max(1, budget_bytes // global_max)
    if rows <= batch:
        return convert(off, length)
    return np.concatenate([convert(off[i: i + batch], length[i: i + batch])
                           for i in range(0, rows, batch)])
