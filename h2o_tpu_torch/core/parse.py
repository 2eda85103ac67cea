"""CSV ingest — port of the CSV path of ``h2o_tpu/core/parse.py``
(``_TIME_RE``/``_NA_STRINGS`` :36-38, ``ParseSetupResult`` :41,
``_sniff_sep`` :160, ``_cell_type`` :173, the CSV branch of
``parse_setup`` :250-285, ``parse_file`` :286, ``_read_bytes`` :294,
``_parse_native`` :302, ``parse_files`` :494, ``_rbind_frames`` :639 and
``_apply_setup_overrides`` :679).

Reference design (water/parser/*): ``parse_setup`` sniffs the separator,
the header and each column's type from a sample of the first file; the
parse tokenizes every file and merges the categorical domains of all
files into one sorted domain (ParseDataset.java:356-535).  Here the
byte loop is the C++ tokenizer of ``h2o_tpu_torch/native`` (built by
g++ on first use; a failed build raises).  Each file is tokenized on its
own into a frame whose categorical domains are its sorted raw levels;
``_rbind_frames`` concatenates the files with the union-domain remap
(``core/frame._merge_domains``), and the union is then sorted by its raw
bytes and decoded, which gives exactly the domain of one ``np.unique``
over every file's cells, the reference's.  The frame stays on the host
(``core/frame.py``); a model lands its columns on its device.

Time columns are read by numpy's ``datetime64`` in UTC, each row by its
own form among those ``_TIME_RE`` admits (a date, with minutes, seconds
or fractional seconds after a space or a ``T``), to the millisecond;
other tokens and invalid dates are NA.  (The reference reads them with
pandas' ``to_datetime``, which infers one format from a column's first
row and makes rows of another form NA.)  There is no pandas route, and
no cluster timezone: naive times are UTC.

Other formats (Parquet, ORC, Avro, XLS/XLSX, ARFF, SVMLight) and remote
paths raise ``NotImplementedError``: they wait for ROADMAP P7b, and a
file of another format is never read as CSV.
"""

from __future__ import annotations

import gzip
import io
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from h2o_tpu_torch import native
from h2o_tpu_torch.core.frame import (T_CAT, T_NUM, T_STR, T_TIME, Frame,
                                      Vec, _merge_domains)

_TIME_RE = re.compile(
    r"^\d{4}-\d{2}-\d{2}([ T]\d{2}:\d{2}(:\d{2}(\.\d+)?)?)?$")
_NA_STRINGS = ("", "NA", "N/A", "na", "NaN", "nan", "null", "NULL", "?")

#: extensions and leading bytes of the formats that wait for P7b
_OTHER_EXTENSIONS = {".parquet": "Parquet", ".pq": "Parquet",
                     ".orc": "ORC", ".avro": "Avro", ".xls": "XLS",
                     ".xlsx": "XLSX", ".arff": "ARFF", ".svm": "SVMLight",
                     ".svmlight": "SVMLight"}
_OTHER_MAGIC = ((b"PAR1", "Parquet"), (b"ORC", "ORC"), (b"Obj\x01", "Avro"))


class ParseSetupResult:
    """Sniffed parse configuration (reference:
    water/parser/ParseSetup.java)."""

    def __init__(self, separator: str, header: bool,
                 column_names: List[str], column_types: List[str],
                 na_strings: Sequence[str] = _NA_STRINGS):
        self.separator = separator
        self.header = header
        self.column_names = column_names
        self.column_types = column_types
        self.na_strings = list(na_strings)


def _not_yet(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: the port reads CSV files only; this input waits for "
        "ROADMAP P7b")


def _open(path: str) -> io.TextIOBase:
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="utf-8",
                                errors="replace")
    return open(path, "r", encoding="utf-8", errors="replace")


def _looks_like_arff(path: str) -> bool:
    """An ARFF file opens (after comments) with ``@relation``."""
    with _open(path) as f:
        for _ in range(50):
            ln = f.readline()
            if not ln:
                return False
            s = ln.strip()
            if s and not s.startswith("%"):
                return s.lower().startswith("@relation")
    return False


def _csv_path(path: str) -> str:
    """A local CSV path (``file://`` stripped), or ``NotImplementedError``
    for a remote URI or a file of another format, by extension or by its
    leading bytes."""
    if "://" in path:
        scheme = path.split("://", 1)[0]
        if scheme not in ("file", "nfs"):
            raise _not_yet(f"remote path {path!r}")
        path = path.split("://", 1)[1] if scheme == "file" else path
    low = path.lower()
    for ext, fmt in _OTHER_EXTENSIONS.items():
        if low.endswith(ext):
            raise _not_yet(f"{path}: {fmt}")
    with open(path, "rb") as f:
        head = f.read(4)
    for magic, fmt in _OTHER_MAGIC:
        if head.startswith(magic):
            raise _not_yet(f"{path}: {fmt}")
    if _looks_like_arff(path):
        raise _not_yet(f"{path}: ARFF")
    return path


def _sniff_sep(sample_lines: List[str]) -> str:
    best, best_score = ",", -1
    for sep in (",", "\t", ";", "|", " "):
        counts = [ln.count(sep) for ln in sample_lines if ln.strip()]
        if not counts or min(counts) == 0:
            continue
        # prefer the separator with consistent, maximal column counts
        score = min(counts) - (max(counts) - min(counts)) * 10
        if score > best_score:
            best, best_score = sep, score
    return best


def _cell_type(tok: str) -> str:
    tok = tok.strip()
    # unquote: clients may quote EVERY cell ('"1.0"' types numeric,
    # '""' is NA)
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "\"'":
        tok = tok[1:-1].strip()
    if tok in _NA_STRINGS:
        return "na"
    try:
        float(tok)
        return T_NUM
    except ValueError:
        pass
    if _TIME_RE.match(tok):
        return T_TIME
    return T_CAT


def parse_setup(paths: Sequence[str], sample_lines: int = 200,
                force_header: Optional[bool] = None) -> ParseSetupResult:
    """Separator, header and column types from a sample of the first
    file.  ``force_header`` overrides the header detection (True: the
    first line is a header; False: it is data)."""
    paths = [_csv_path(p) for p in paths]
    with _open(paths[0]) as f:
        lines = []
        for _ in range(sample_lines):
            ln = f.readline()
            if not ln:
                break
            lines.append(ln.rstrip("\r\n"))
    if not lines:
        raise ValueError(f"empty file: {paths[0]}")
    sep = _sniff_sep(lines[:50])
    first = lines[0].split(sep)
    rest = [ln.split(sep) for ln in lines[1:] if ln.strip()]
    ncols = len(first)
    # header: a first row of all non-numeric tokens over a body with
    # numerics
    body_types = [[_cell_type(r[j]) for r in rest if len(r) == ncols]
                  for j in range(ncols)]
    first_types = [_cell_type(c) for c in first]
    if force_header is not None:
        has_header = force_header
    else:
        has_header = (any(t == T_CAT for t in first_types) and all(
            t in (T_CAT, "na") for t in first_types) and any(
            T_NUM in col for col in body_types))
    names = ([c.strip().strip('"') for c in first] if has_header
             else [f"C{j + 1}" for j in range(ncols)])
    types = []
    for j in range(ncols):
        col = body_types[j] if has_header else \
            [first_types[j]] + body_types[j]
        # a header-only sample never types a column from its header
        # token: the na-only default (numeric) applies
        nonna = [t for t in (col or ["na"]) if t != "na"]
        if not nonna or all(t == T_NUM for t in nonna):
            types.append(T_NUM)
        elif all(t == T_TIME for t in nonna):
            types.append(T_TIME)
        else:
            types.append(T_CAT)
    return ParseSetupResult(sep, has_header, names, types)


def parse_file(path: str, setup: Optional[ParseSetupResult] = None,
               column_types: Optional[Dict[str, str]] = None) -> Frame:
    return parse_files([path], setup, column_types)


def parse_files(paths: Sequence[str],
                setup: Optional[ParseSetupResult] = None,
                column_types: Optional[Dict[str, str]] = None) -> Frame:
    """Parse one or more CSV files (plain or gzip) into one Frame: rows
    concatenated in file order, categorical domains merged into one
    sorted domain.  ``column_types`` (name -> type) overrides the
    setup's types before the parse."""
    paths = [_csv_path(p) for p in paths]
    setup = setup or parse_setup(paths)
    types = list(setup.column_types)
    for name, t in (column_types or {}).items():
        types[setup.column_names.index(name)] = t
    fr = _rbind_frames([_parse_one(p, setup, types) for p in paths])
    return Frame(fr.names, [_sorted_levels(v) if v.is_categorical else v
                            for v in fr.vecs])


def _read_bytes(path: str) -> bytes:
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def _decode(b: bytes) -> str:
    """A token's text: UTF-8, with a quoted field's doubled quotes
    unescaped."""
    return b.decode("utf-8", "replace").replace('""', '"')


def _parse_times(col: np.ndarray, na: np.ndarray) -> np.ndarray:
    """float64 ms since the epoch (UTC) of byte tokens; NaN where ``na``
    or where the token is not a valid time of ``_TIME_RE``'s forms."""
    out = np.full(len(col), np.nan)
    text = [b.decode("utf-8", "replace") for b in col]
    ok = ~na & np.fromiter((bool(_TIME_RE.match(s)) for s in text), bool,
                           len(text))
    idx = np.flatnonzero(ok)
    try:
        us = np.array([text[i] for i in idx], dtype="datetime64[us]")
    except ValueError:          # an invalid date among them: row by row
        us = np.empty(len(idx), "datetime64[us]")
        for k, i in enumerate(idx):
            try:
                us[k] = np.datetime64(text[i], "us")
            except ValueError:
                us[k] = np.datetime64("NaT")
    ms = us.astype("datetime64[ms]")
    good = ~np.isnat(ms)
    out[idx[good]] = ms[good].astype(np.int64).astype(np.float64)
    return out


def _parse_one(path: str, setup: ParseSetupResult,
               types: List[str]) -> Frame:
    """One file through the native tokenizer (reference ``_parse_native``
    :302, per file): numerics as parsed, NA tokens recognised in
    unquoted tokens only, and unquoted tokens whitespace-stripped.  A
    categorical column's domain here is the file's sorted raw (bytes)
    levels without unused ones; ``parse_files`` merges and decodes."""
    ncols = len(setup.column_names)
    if len(types) != ncols:
        raise ValueError("one column type per column name")
    is_num = np.asarray([t == T_NUM for t in types], np.uint8)
    data = _read_bytes(path)
    _, num, soff, slen, squo = native.tokenize_csv(
        data, setup.separator, ncols, is_num, setup.na_strings)
    lo = 1 if setup.header else 0
    data_np = np.frombuffer(data, np.uint8)
    na_bytes = [s.encode() for s in setup.na_strings]
    # float32 columns, each contiguous
    num = np.ascontiguousarray(num[lo:].astype(np.float32).T)
    vecs: List[Vec] = []
    ni = si = 0
    for t in types:
        if t == T_NUM:
            vecs.append(Vec(num[ni]))
            ni += 1
            continue
        col = native.spans_to_fixed_bytes(data_np, soff[lo:, si],
                                          slen[lo:, si])
        quoted = squo[lo:, si].astype(bool)
        si += 1
        col = np.where(quoted, col, np.char.strip(col))
        na = np.isin(col, na_bytes) & ~quoted
        if t == T_TIME:
            vecs.append(Vec(_parse_times(col, na), T_TIME))
        elif t == T_STR:
            vecs.append(Vec([None if m else _decode(v)
                             for v, m in zip(col, na)], T_STR))
        else:
            levels, codes = np.unique(col, return_inverse=True)
            codes = codes.ravel()
            keep = np.bincount(codes[~na], minlength=len(levels)) > 0
            remap = np.full(len(levels), -1, np.int32)
            remap[keep] = np.arange(int(keep.sum()), dtype=np.int32)
            codes = remap[codes]
            codes[na] = -1
            vecs.append(Vec(codes, T_CAT, domain=list(levels[keep])))
    return Frame(setup.column_names, vecs)


def _sorted_levels(v: Vec) -> Vec:
    """A categorical Vec over raw byte levels -> the same column over its
    levels sorted by their bytes and decoded."""
    levels = np.asarray(v.domain, dtype=bytes) if v.domain else \
        np.empty(0, "S1")
    order = np.argsort(levels, kind="stable")
    rank = np.empty(len(order), np.int32)
    rank[order] = np.arange(len(order), dtype=np.int32)
    codes = np.where(v.data >= 0, rank[np.clip(v.data, 0, None)]
                     if len(rank) else -1, -1)
    return Vec(codes, T_CAT, domain=[_decode(levels[i]) for i in order])


def _rbind_frames(frames: List[Frame]) -> Frame:
    """Rows of ``frames`` concatenated: each file's categorical codes
    remapped into the union of the files' domains, in first-seen order
    (the distributed domain-merge contract, ParseDataset.java:356-535)."""
    out = frames[0]
    if len(frames) == 1:
        return out
    vecs = []
    for j, v0 in enumerate(out.vecs):
        if v0.is_categorical:
            union: List = []
            parts = []
            for f in frames:
                union, remap = _merge_domains(union, f.vecs[j].domain)
                parts.append(remap[f.vecs[j].data])       # -1 stays -1
            vecs.append(Vec(np.concatenate(parts), T_CAT, domain=union))
        elif v0.host_data is not None:
            vecs.append(Vec([x for f in frames for x in f.vecs[j].host_data],
                            v0.type))
        else:
            vecs.append(Vec(np.concatenate([f.vecs[j].to_numpy()
                                            for f in frames]), v0.type))
    return Frame(list(out.names), vecs)


def _apply_setup_overrides(fr: Frame, setup: Optional[ParseSetupResult],
                           column_types: Optional[Dict[str, str]]) -> Frame:
    """A client-edited parse setup applied to a parsed frame, in place:
    the setup's column names, then its types and ``column_types`` as
    numeric or time <-> categorical conversions (the /3/ParseSetup edit
    flow of the reference's format readers)."""
    if setup is not None and len(setup.column_names) == fr.ncols and \
            list(setup.column_names) != list(fr.names):
        fr.names = list(setup.column_names)
    overrides = dict(column_types or {})
    if setup is not None and len(setup.column_types) == fr.ncols:
        for n, t in zip(fr.names, setup.column_types):
            overrides.setdefault(n, t)
    for name, want in overrides.items():
        if name not in fr.names:
            continue
        j = fr.names.index(name)
        v = fr.vecs[j]
        if want == v.type:
            continue
        if want == T_CAT and v.type in (T_NUM, T_TIME):
            d = np.asarray(v.to_numpy(), np.float64)
            vals = np.unique(d[~np.isnan(d)])
            codes = np.where(np.isnan(d), -1,
                             np.searchsorted(vals, d)).astype(np.int32)
            dom = [str(int(x)) if np.isfinite(x) and x == int(x) else str(x)
                   for x in vals]
            fr.vecs[j] = Vec(codes, T_CAT, domain=dom)
        elif want in (T_NUM, T_TIME) and v.type == T_CAT:
            try:
                dv = np.asarray([float(x) for x in v.domain or []],
                                np.float64)
            except ValueError:
                continue             # non-numeric labels: keep enum
            codes = v.data
            vals = np.where(codes >= 0, dv[np.clip(codes, 0, None)]
                            if len(dv) else np.nan, np.nan)
            fr.vecs[j] = Vec(vals.astype(np.float32), T_NUM)
    return fr
