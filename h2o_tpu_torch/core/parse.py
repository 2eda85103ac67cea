"""Ingest — port of ``h2o_tpu/core/parse.py``: CSV (``_TIME_RE``/
``_NA_STRINGS`` :36-38, ``ParseSetupResult`` :41, ``_sniff_sep`` :160,
``_cell_type`` :173, ``parse_setup`` :191, ``parse_file`` :286,
``_read_bytes`` :294, ``_parse_native`` :302, ``tokenize_chunk`` :385,
``parse_files`` :494, ``_rbind_frames`` :639, ``_apply_setup_overrides``
:679), the cluster timezone (``_apply_cluster_tz`` :64), remote paths
(``_is_remote``, ``_cached_file``, ``localize`` :79-153) and the other
formats: XLS/XLSX (``_xls_csv_path``, ``parse_xls`` :587-612), ARFF
(``_looks_like_arff``, ``_ARFF_ATTR_RE``, ``_arff_schema``,
``parse_arff`` :719-829), Parquet/ORC (``parse_parquet``, ``parse_orc``,
``_arrow_to_frame`` :831-886), Avro (``parse_avro`` :887) and SVMLight
(``parse_svmlight_multi``, ``parse_svmlight`` :925-985).

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

Formats are told apart as the reference tells them: Parquet and ORC and
Avro by extension or leading bytes, XLS/XLSX and SVMLight by extension,
ARFF by extension or an ``@relation`` line; everything else is CSV.  A
format's reader that fails raises; no file is read as another format.
Parquet and ORC need pyarrow, imported when such a file is read; without
it they raise ``ImportError``.  A remote URI (``http(s)://``, ``s3://``,
``gcs://``, ``hdfs://``, or any scheme registered with
``core/persist.register_scheme``) is fetched once into a private
download cache by ``localize`` and then read as a local file.

Time columns (CSV and ARFF ``date`` attributes) are read by numpy's
``datetime64``, each row by its own form among those ``_TIME_RE`` admits
(a date, with minutes, seconds or fractional seconds after a space or a
``T``), to the millisecond; other tokens and invalid dates are NA.  (The
reference reads them with pandas' ``to_datetime``, which infers one
format from a column's first row and makes rows of another form NA.)
A naive time is wall-clock time in the cluster timezone
(``core/device.timezone()``), stored as UTC milliseconds; a wall time
that the zone skips or repeats is NA, as pandas' ``tz_localize(...,
ambiguous="NaT", nonexistent="NaT")`` makes it in the reference.  There
is no pandas route: ``use_native=False`` is refused as an unknown
argument.
"""

from __future__ import annotations

import csv
import gzip
import io
import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from h2o_tpu_torch import native
from h2o_tpu_torch.core.frame import (T_CAT, T_NUM, T_STR, T_TIME, Frame,
                                      SparseVec, Vec, _merge_domains)
from h2o_tpu_torch.core.log import get_logger

log = get_logger("parse")

_TIME_RE = re.compile(
    r"^\d{4}-\d{2}-\d{2}([ T]\d{2}:\d{2}(:\d{2}(\.\d+)?)?)?$")
_NA_STRINGS = ("", "NA", "N/A", "na", "NaN", "nan", "null", "NULL", "?")
#: prefix of the download caches' directories (the reference's is
#: ``h2o_tpu``), so that the two packages never read each other's entries
_CACHE_PREFIX = "h2o_tpu_torch"


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


# -- the cluster timezone -----------------------------------------------------

def _apply_cluster_tz(ms: np.ndarray) -> np.ndarray:
    """float64 milliseconds of naive wall-clock times -> UTC milliseconds
    under the cluster timezone (reference ``_apply_cluster_tz``): NaN
    where the zone skips or repeats the wall time (its offsets under
    ``fold`` 0 and 1 differ) or where it has no date.  Unchanged when no
    zone is set or the zone is UTC."""
    import datetime as dt
    import zoneinfo

    from h2o_tpu_torch.core.device import timezone
    tz = timezone()
    if not tz or tz == "UTC":
        return ms
    zone = zoneinfo.ZoneInfo(tz)
    ok = ~np.isnan(ms)
    walls, inv = np.unique(ms[ok], return_inverse=True)
    off = np.full(len(walls), np.nan)
    epoch = dt.datetime(1970, 1, 1)
    one_ms = dt.timedelta(milliseconds=1)
    for k, w in enumerate(walls):
        try:
            wall = epoch + dt.timedelta(milliseconds=int(w))
        except OverflowError:
            continue
        a = wall.replace(tzinfo=zone, fold=0).utcoffset()
        if a == wall.replace(tzinfo=zone, fold=1).utcoffset():
            off[k] = a / one_ms
    out = ms.copy()
    out[ok] = walls[inv] - off[inv]
    return out


# -- remote paths -------------------------------------------------------------

def _is_remote(path: str) -> bool:
    """A URI with a non-local scheme: ingest fetches it through the
    persist byte stores (reference water/persist/PersistManager's scheme
    dispatch)."""
    return "://" in path and \
        path.split("://", 1)[0] not in ("file", "nfs")


def _cached_file(subdir: str, key: str, suffix: str, producer,
                 max_age_s: Optional[float] = None) -> str:
    """Key-addressed temp-dir cache with an atomic materialize:
    ``producer() -> bytes`` runs only on a miss (or when the entry is
    older than ``max_age_s``).  Writes go to a unique temp file before
    the atomic replace, so concurrent callers never interleave; the temp
    is unlinked when the producer fails.  The cache is a per-user 0700
    directory: the system temp dir is world-writable, so a symlinked or
    foreign-owned cache directory is refused and a looser mode is
    tightened."""
    import hashlib
    import stat
    import tempfile
    import time
    cdir = os.path.join(tempfile.gettempdir(),
                        f"{_CACHE_PREFIX}_{subdir}_u{os.getuid()}")
    os.makedirs(cdir, mode=0o700, exist_ok=True)
    st = os.lstat(cdir)
    if stat.S_ISLNK(st.st_mode) or st.st_uid != os.getuid():
        raise PermissionError(
            f"download cache dir {cdir} is not an owned private "
            "directory; refusing to trust cached entries")
    if st.st_mode & 0o077:
        os.chmod(cdir, 0o700)
    local = os.path.join(
        cdir, hashlib.sha1(key.encode()).hexdigest()[:16] + suffix)
    try:
        age = time.time() - os.path.getmtime(local)
        if max_age_s is None or age < max_age_s:
            return local
    except OSError:
        pass
    data = producer()
    fd, tmp = tempfile.mkstemp(dir=cdir, suffix=".part")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, local)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return local


def localize(path: str, max_age_s: float = 120.0) -> str:
    """The local path of ``path``: a local path as given (``file://``
    stripped); a remote object fetched through ``core/persist.read_bytes``
    into the download cache, keyed by its URI, so a setup and a parse of
    one ingest fetch once, and fetched again once the entry is older than
    ``max_age_s``."""
    if not _is_remote(path):
        return path[7:] if path.startswith("file://") else path
    base = os.path.basename(path.split("?", 1)[0]) or "remote"

    def fetch() -> bytes:
        from h2o_tpu_torch.core.persist import read_bytes
        data = read_bytes(path)
        log.info("fetched %s (%d bytes)", path, len(data))
        return data

    return _cached_file("remote", path, "_" + base, fetch,
                        max_age_s=max_age_s)


# -- format detection ---------------------------------------------------------

def _open(path: str) -> io.TextIOBase:
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="utf-8",
                                errors="replace")
    return open(path, "r", encoding="utf-8", errors="replace")


def _head(path: str, n: int) -> bytes:
    try:
        with open(path, "rb") as f:
            return f.read(n)
    except OSError:
        return b""


def _is_parquet(path: str) -> bool:
    return _head(path, 4) == b"PAR1"


def _is_orc(path: str) -> bool:
    return _head(path, 3) == b"ORC"


def _is_avro(path: str) -> bool:
    return _head(path, 4) == b"Obj\x01"


def _looks_like_arff(path: str) -> bool:
    """An ARFF file opens (after comments and blank lines) with
    ``@relation``."""
    try:
        with _open(path) as f:
            for _ in range(50):
                ln = f.readline()
                if not ln:
                    return False
                s = ln.strip()
                if s and not s.startswith("%"):
                    return s.lower().startswith("@relation")
    except OSError:
        return False
    return False


def _format(path: str) -> str:
    """The reader of a local path, in the reference's dispatch order."""
    if path.endswith((".parquet", ".pq")) or _is_parquet(path):
        return "parquet"
    if path.endswith(".orc") or _is_orc(path):
        return "orc"
    if path.endswith(".avro") or _is_avro(path):
        return "avro"
    if path.endswith((".xls", ".xlsx")):
        return "xls"
    if path.endswith(".arff") or _looks_like_arff(path):
        return "arff"
    if path.endswith((".svm", ".svmlight")):
        return "svmlight"
    return "csv"


# -- setup --------------------------------------------------------------------

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


def _arrow_types(schema) -> List[str]:
    import pyarrow as pa
    types = []
    for f in schema:
        if pa.types.is_dictionary(f.type) or pa.types.is_string(f.type) or \
                pa.types.is_large_string(f.type):
            types.append(T_CAT)
        elif pa.types.is_timestamp(f.type) or pa.types.is_date(f.type):
            types.append(T_TIME)
        else:
            types.append(T_NUM)
    return types


def _pyarrow(fmt: str):
    """pyarrow, or ``ImportError`` naming what needs it."""
    try:
        import pyarrow
    except ImportError as e:
        raise ImportError(
            f"reading {fmt} needs pyarrow, which is not installed: the "
            "port reads Parquet and ORC only where pyarrow is (its CPU "
            "tests), not on a machine without it") from e
    return pyarrow


def parse_setup(paths: Sequence[str], sample_lines: int = 200,
                force_header: Optional[bool] = None) -> ParseSetupResult:
    """Separator, header and column types: a format's own schema, or a
    sample of the first (CSV) file.  ``force_header`` overrides the
    header detection (True: the first line is a header; False: it is
    data)."""
    paths = [localize(p) for p in paths]
    fmt = _format(paths[0])
    if fmt == "parquet":
        _pyarrow("Parquet")
        import pyarrow.parquet as pq
        sch = pq.read_schema(paths[0])
        return ParseSetupResult(",", True, list(sch.names),
                                _arrow_types(sch))
    if fmt == "xls":
        return parse_setup([_xls_csv_path(paths[0])], sample_lines,
                           force_header)
    if fmt == "orc":
        _pyarrow("ORC")
        from pyarrow import orc
        sch = orc.ORCFile(paths[0]).schema
        return ParseSetupResult(",", True, list(sch.names),
                                _arrow_types(sch))
    if fmt == "avro":
        from h2o_tpu_torch.core.avro import read_avro_schema
        names, kinds = read_avro_schema(paths[0])
        kmap = {"num": T_NUM, "time": T_TIME}
        return ParseSetupResult(",", True, names,
                                [kmap.get(k, T_CAT) for k in kinds])
    if fmt == "arff":
        names, types, _ = _arff_schema(paths[0])
        return ParseSetupResult(",", True, names, types)
    # CSV, and SVMLight, which the reference sniffs as CSV here too
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


# -- parse --------------------------------------------------------------------

def parse_file(path: str, setup: Optional[ParseSetupResult] = None,
               column_types: Optional[Dict[str, str]] = None) -> Frame:
    return parse_files([path], setup, column_types)


def parse_files(paths: Sequence[str],
                setup: Optional[ParseSetupResult] = None,
                column_types: Optional[Dict[str, str]] = None) -> Frame:
    """Parse one or more files of one format into one Frame, rows in file
    order.  CSV (plain or gzip): categorical domains merged into one
    sorted domain, ``column_types`` (name -> type) overriding the
    setup's types before the parse.  The other formats: the format's
    reader, then the setup's names and types and ``column_types``
    applied to its frame (``_apply_setup_overrides``)."""
    paths = [localize(p) for p in paths]
    fmt = _format(paths[0])
    if fmt != "csv":
        if fmt == "parquet":
            fr = parse_parquet(paths)
        elif fmt == "orc":
            fr = parse_orc(paths)
        elif fmt == "avro":
            fr = parse_avro(paths)
        elif fmt == "xls":
            fr = _rbind_frames([parse_xls(p) for p in paths])
        elif fmt == "arff":
            fr = _rbind_frames([parse_arff(p) for p in paths])
        else:
            fr = parse_svmlight_multi(paths)
        return _apply_setup_overrides(fr, setup, column_types)
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
    """float64 UTC ms since the epoch of byte tokens read as wall-clock
    times in the cluster timezone; NaN where ``na``, where the token is
    not a valid time of ``_TIME_RE``'s forms, or where the zone skips or
    repeats that wall time."""
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
    return _apply_cluster_tz(out)


def _tokenize(data: bytes, setup: ParseSetupResult, types: List[str],
              header: bool) -> List[Vec]:
    """The columns of one CSV byte buffer through the native tokenizer
    (reference ``_parse_native`` :302): numerics as parsed, NA tokens
    recognised in unquoted tokens only, and unquoted tokens
    whitespace-stripped.  A categorical column's domain is the buffer's
    sorted raw (bytes) levels without unused ones."""
    ncols = len(setup.column_names)
    if len(types) != ncols:
        raise ValueError("one column type per column name")
    is_num = np.asarray([t == T_NUM for t in types], np.uint8)
    _, num, soff, slen, squo = native.tokenize_csv(
        data, setup.separator, ncols, is_num, setup.na_strings)
    lo = 1 if header else 0
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
    return vecs


def _parse_one(path: str, setup: ParseSetupResult,
               types: List[str]) -> Frame:
    """One CSV file (categorical domains of raw bytes; ``parse_files``
    merges and decodes)."""
    return Frame(setup.column_names,
                 _tokenize(_read_bytes(path), setup, types, setup.header))


def tokenize_chunk(data: bytes, setup: ParseSetupResult,
                   header: bool = False) -> Dict[str, object]:
    """One streamed block of complete CSV records -> the host payloads
    ``Frame.append_rows`` takes (reference ``tokenize_chunk``):
    ``ndarray`` for numeric (float32) and time (float64 ms) columns,
    ``(codes, chunk-local sorted domain)`` for categoricals, ``list``
    for strings.  The whole-file parse's tokenizer, NA and quote rules,
    so a chunked parse reassembles the rows of ``parse_files`` on the
    same bytes (categorical codes differ: streamed domains merge in
    first-seen order, the whole-file parse sorts one global domain)."""
    types = list(setup.column_types)
    if not data.strip():
        return {name: [] if t == T_STR else (
            (np.empty(0, np.int32), []) if t == T_CAT
            else np.empty(0, np.float64 if t == T_TIME else np.float32))
            for name, t in zip(setup.column_names, types)}
    out: Dict[str, object] = {}
    for name, t, v in zip(setup.column_names, types,
                          _tokenize(data, setup, types, header)):
        if t == T_CAT:
            v = _sorted_levels(v)
            out[name] = (v.data, v.domain)
        elif t == T_STR:
            out[name] = v.host_data
        else:
            out[name] = v.to_numpy()
    return out


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


# -- XLS / XLSX ---------------------------------------------------------------

def _xls_csv_path(path: str) -> str:
    """The first sheet of a spreadsheet decoded once per (path, mtime)
    into a cached CSV: a setup and a parse both read the source, and the
    decode reads the whole file."""
    def decode() -> bytes:
        from h2o_tpu_torch.core import xls
        rows = xls.read_xlsx(path) if path.endswith(".xlsx") \
            else xls.read_xls(path)
        if not rows:
            raise ValueError(f"{path}: no cells in the first sheet")
        return xls.rows_to_csv(rows).encode()

    key = f"{path}:{int(os.path.getmtime(path))}"
    return _cached_file("xls", key, ".csv", decode)


def parse_xls(path: str) -> Frame:
    """XLS/XLSX (reference water/parser/XlsParser.java): the first
    sheet's grid through the CSV path's type inference, NA and domain
    rules."""
    return parse_files([_xls_csv_path(path)])


# -- ARFF ---------------------------------------------------------------------

_ARFF_ATTR_RE = re.compile(r"@attribute\s+('(?:[^']*)'|\"(?:[^\"]*)\"|\S+)"
                           r"\s+(.+)$", re.IGNORECASE)


def _arff_schema(path: str, with_data: bool = False):
    """@attribute declarations (header only unless ``with_data``): names,
    types, declared domains [, data lines]."""
    names: List[str] = []
    types: List[str] = []
    domains: List[Optional[List[str]]] = []
    data_lines: List[str] = []
    in_data = False
    with _open(path) as f:
        for ln in f:
            s = ln.strip()
            if not s or s.startswith("%"):
                continue
            low = s.lower()
            if in_data:
                data_lines.append(s)
            elif low.startswith("@attribute"):
                m = _ARFF_ATTR_RE.match(s)
                if not m:
                    raise ValueError(f"bad @attribute line: {s}")
                names.append(m.group(1).strip("'\""))
                ty = m.group(2).strip()
                if ty.startswith("{"):
                    types.append(T_CAT)
                    domains.append([t.strip().strip("'\"")
                                    for t in ty.strip("{} ").split(",")])
                elif ty.lower().split()[0] in ("numeric", "real",
                                               "integer"):
                    types.append(T_NUM)
                    domains.append(None)
                elif ty.lower().startswith("date"):
                    types.append(T_TIME)
                    domains.append(None)
                else:                       # string / relational
                    types.append(T_STR)
                    domains.append(None)
            elif low.startswith("@data"):
                if not with_data:
                    break
                in_data = True
    if not names:
        raise ValueError(f"no @attribute declarations in {path}")
    if with_data:
        return names, types, domains, data_lines
    return names, types, domains


def parse_arff(path: str) -> Frame:
    """ARFF (reference water/parser/ARFFParser.java): numeric/real/
    integer attributes are numeric, ``{a,b,c}`` categorical with the
    declared level order (an undeclared value is NA), ``date`` a time
    column (naive times in the cluster timezone), the rest strings;
    ``?`` and empty cells are NA."""
    names, types, domains, data_lines = _arff_schema(path, with_data=True)
    rows = list(csv.reader(data_lines, skipinitialspace=True))
    cols = list(zip(*rows)) if rows else [[] for _ in names]
    vecs: List[Vec] = []
    for j, (ty, dom) in enumerate(zip(types, domains)):
        raw = [c.strip().strip("'\"")
               for c in (cols[j] if j < len(cols) else [])]
        na = [c in ("?", "") for c in raw]
        if ty == T_NUM:
            vecs.append(Vec(np.asarray(
                [np.nan if n else float(c) for c, n in zip(raw, na)],
                np.float32)))
        elif ty == T_CAT:
            lut = {d: i for i, d in enumerate(dom)}
            vecs.append(Vec(np.asarray(
                [-1 if n else lut.get(c, -1) for c, n in zip(raw, na)],
                np.int32), T_CAT, domain=list(dom)))
        elif ty == T_TIME:
            tok = np.asarray([c.encode() for c in raw], dtype=bytes) \
                if raw else np.empty(0, "S1")
            vecs.append(Vec(_parse_times(tok, np.asarray(na, bool)),
                            T_TIME))
        else:
            vecs.append(Vec([None if n else c for c, n in zip(raw, na)],
                            T_STR))
    fr = Frame(names, vecs)
    log.info("parsed ARFF %s: %d rows, %d cols", path, fr.nrows, fr.ncols)
    return fr


# -- Parquet / ORC ------------------------------------------------------------

def parse_parquet(paths: Sequence[str]) -> Frame:
    """Parquet through pyarrow (reference h2o-parsers/h2o-parquet-parser)."""
    _pyarrow("Parquet")
    import pyarrow.parquet as pq
    return _arrow_to_frame([pq.read_table(p) for p in paths])


def parse_orc(paths: Sequence[str]) -> Frame:
    """ORC through pyarrow.orc (reference h2o-parsers/h2o-orc-parser)."""
    _pyarrow("ORC")
    from pyarrow import orc
    return _arrow_to_frame([orc.read_table(p) for p in paths])


def _arrow_to_frame(tables) -> Frame:
    """Arrow columns as frame columns: strings and dictionaries
    categorical (sorted domain), timestamps and dates time (ms), booleans
    and the rest float32."""
    import pyarrow as pa
    table = pa.concat_tables(tables) if len(tables) > 1 else tables[0]
    names, vecs = [], []
    for name in table.column_names:
        col = table.column(name)
        names.append(name)
        pa_t = col.type
        if pa.types.is_dictionary(pa_t) or pa.types.is_string(pa_t) or \
                pa.types.is_large_string(pa_t):
            vals = col.to_pylist()
            dom = sorted({v for v in vals if v is not None})
            lut = {d: i for i, d in enumerate(dom)}
            vecs.append(Vec(np.asarray([lut.get(v, -1) if v is not None
                                        else -1 for v in vals], np.int32),
                            T_CAT, domain=dom))
        elif pa.types.is_timestamp(pa_t) or pa.types.is_date(pa_t):
            arr = col.cast(pa.timestamp("ms")).to_numpy(
                zero_copy_only=False)
            ms = arr.astype("datetime64[ms]").astype("int64")
            vecs.append(Vec(np.where(np.isnat(arr), np.nan,
                                     ms.astype(np.float64)), T_TIME))
        elif pa.types.is_boolean(pa_t):
            vecs.append(Vec(np.asarray(
                [np.nan if v is None else float(v)
                 for v in col.to_pylist()], np.float32)))
        else:
            vecs.append(Vec(np.asarray(col.to_numpy(zero_copy_only=False),
                                       np.float32)))
    return Frame(names, vecs)


# -- Avro ---------------------------------------------------------------------

def parse_avro(paths: Sequence[str]) -> Frame:
    """Avro containers through ``core/avro.py`` (reference
    h2o-parsers/h2o-avro-parser): files of one schema, rows in file
    order; strings and enums categorical with a sorted domain."""
    from h2o_tpu_torch.core.avro import read_avro
    all_names, all_kinds, cols = None, None, None
    for p in paths:
        names, kinds, columns = read_avro(p)
        if all_names is None:
            all_names, all_kinds, cols = names, kinds, columns
            continue
        if names != all_names or kinds != all_kinds:
            raise ValueError(
                f"avro schema mismatch in {p}: "
                f"{list(zip(names, kinds))} vs "
                f"{list(zip(all_names, all_kinds))}")
        for acc, c in zip(cols, columns):
            acc.extend(c)
    vecs: List[Vec] = []
    for kind, col in zip(all_kinds, cols):
        if kind in ("num", "time"):
            arr = np.asarray(
                [np.nan if v is None else float(v) for v in col],
                np.float64 if kind == "time" else np.float32)
            vecs.append(Vec(arr, T_TIME if kind == "time" else T_NUM))
        else:
            dom = sorted({str(v) for v in col if v is not None})
            lut = {d: i for i, d in enumerate(dom)}
            vecs.append(Vec(np.asarray([lut[str(v)] if v is not None
                                        else -1 for v in col], np.int32),
                            T_CAT, domain=dom))
    return Frame(list(all_names), vecs)


# -- SVMLight -----------------------------------------------------------------

def parse_svmlight_multi(paths: Sequence[str]) -> Frame:
    """SVMLight files into one frame: each narrower file padded with zero
    columns to the widest file's, whose names the frame takes."""
    if len(paths) == 1:
        return parse_svmlight(paths[0])
    frames = [parse_svmlight(p) for p in paths]
    width = max(f.ncols for f in frames)
    names = max((f.names for f in frames), key=len)
    padded = []
    for f in frames:
        if f.ncols < width:
            f = Frame(list(names), list(f.vecs) + [
                Vec(np.zeros(f.nrows, np.float32))
                for _ in range(width - f.ncols)])
        padded.append(f)
    return _rbind_frames(padded)


def _spans(data_np: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    return native.spans_to_fixed_bytes(data_np, lo, (hi - lo).astype(
        np.int32))


def _line_starts(line: np.ndarray) -> np.ndarray:
    """True at each token that opens its line."""
    return np.concatenate(([True], line[1:] != line[:-1]))[:len(line)]


def parse_svmlight(path: str) -> Frame:
    """SVMLight (reference water/parser/SVMLightParser): a line is a
    target, then ``index:value`` pairs; ``#`` starts a comment where a
    token starts with it.  Column ``C{j+1}`` holds feature index j (from
    0); a column with fewer non-zero pairs than half the rows is a
    ``SparseVec``, the others dense.  A repeated index on one line keeps
    its last value.  The bytes are tokenized with numpy (the reference
    loops over lines in Python) into the same frame, bit for bit."""
    data_np = np.frombuffer(_read_bytes(path), np.uint8)
    nl = (data_np == 0x0A) | (data_np == 0x0D)
    sep = nl | np.isin(data_np, np.frombuffer(b" \t\x0b\x0c", np.uint8))
    word = ~sep
    start = np.flatnonzero(word & np.concatenate(([True], sep[:-1])))
    end = np.flatnonzero(word & np.concatenate((sep[1:], [True]))) + 1
    line = np.searchsorted(np.flatnonzero(nl), start)
    # drop each line's tokens from the first one that starts with '#'
    first = _line_starts(line)
    hashes = data_np[start] == ord("#")
    seen = np.cumsum(hashes)
    keep = seen == (seen - hashes)[np.flatnonzero(first)][
        np.cumsum(first) - 1]
    start, end, line = start[keep], end[keep], line[keep]
    first = _line_starts(line)
    row = np.cumsum(first) - 1
    n = int(first.sum())
    targets = _spans(data_np, start[first], end[first]).astype(
        np.float64).astype(np.float32) if n else np.zeros(0, np.float32)
    ps, pe, prow = start[~first], end[~first], row[~first]
    colons = np.flatnonzero(data_np == ord(":"))
    owner = np.searchsorted(ps, colons, side="right") - 1
    inside = (owner >= 0) & (colons < pe[np.clip(owner, 0, None)]) \
        if len(ps) else np.zeros(len(colons), bool)
    per_pair = np.bincount(owner[inside], minlength=len(ps))
    if (per_pair != 1).any():
        bad = int(np.flatnonzero(per_pair != 1)[0])
        raise ValueError(f"{path}: bad index:value pair "
                         f"{bytes(data_np[ps[bad]:pe[bad]])!r}")
    colon = colons[inside]
    keys = _spans(data_np, ps, colon).astype(np.int64) if len(ps) else \
        np.zeros(0, np.int64)
    vals = _spans(data_np, colon + 1, pe).astype(np.float64) if len(ps) \
        else np.zeros(0)
    if (keys < 0).any():
        raise ValueError(f"{path}: negative feature index "
                         f"{int(keys[keys < 0][0])}")
    ncols = int(keys.max()) + 1 if len(keys) else 1
    # one (row, index) pair each: the last of a line's repeats
    order = np.lexsort((np.arange(len(keys)), prow, keys))
    keys, prow, vals = keys[order], prow[order], vals[order]
    last = np.concatenate(((keys[1:] != keys[:-1]) |
                           (prow[1:] != prow[:-1]), [True]))
    keys, prow, vals = keys[last], prow[last], vals[last]
    bounds = np.searchsorted(keys, np.arange(ncols + 1))
    names = ["target"] + [f"C{j + 1}" for j in range(ncols)]
    vecs: List[Vec] = [Vec(targets)]
    for j in range(ncols):
        rj, vj = prow[bounds[j]:bounds[j + 1]], vals[bounds[j]:bounds[j + 1]]
        if len(rj) < 0.5 * n:
            vecs.append(SparseVec(rj, vj, n))
        else:
            dense = np.zeros(n, np.float32)
            dense[rj] = vj
            vecs.append(Vec(dense))
    return Frame(names, vecs)
