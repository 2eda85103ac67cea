"""The other ingest formats: h2o_tpu_torch's readers held against
h2o_tpu's on the CPU.

ARFF (declared level order, undeclared values, ``?`` and empty cells,
quoted attribute names, dates), SVMLight (single and multi-file, comments,
repeated indices, the sparse codec's threshold), Avro (files the port's
and the reference's writers wrote, the reference tests' hand-written
fixtures, both codecs, nullable unions in either order, enums, the
logical types, the refusals), XLS/XLSX (the reference tests' workbooks,
an SST split over CONTINUE records, a truncated SST) and Parquet/ORC
(where pyarrow is installed) are parsed by both packages from the same
files.  Setups are equal, and frames are equal bit for bit: names,
types, domains and codes, numerics with NaNs in the same places, time
columns' float64 milliseconds, strings, and which columns are
``SparseVec``s.  The one exception is the time columns' per-row rule
(``test_torch_parse.py::test_time_rows_of_mixed_forms``): the files here
hold one form per column.
"""

import shutil
import struct
import sys
import zipfile

import numpy as np
import pytest

from h2o_tpu.core import avro as javro
from h2o_tpu.core import frame as jframe
from h2o_tpu.core import parse as jp

from h2o_tpu_torch.core import avro as pavro
from h2o_tpu_torch.core import frame as pframe
from h2o_tpu_torch.core import parse as pp
from tests.test_ingest_formats import ARFF
from tests.test_torch_parse import _assert_frame_equal, _assert_setup_equal
from tests.test_xls_ingest import (_SHEET, _SST, _bstr, _biff_stream,
                                   _biff_stream_continued, _ole2, _rec)

pytestmark = pytest.mark.shared_dkv


def _write(tmp_path, name, data):
    p = tmp_path / name
    if isinstance(data, str):
        p.write_text(data)
    else:
        p.write_bytes(data)
    return str(p)


def _both(paths, setups=(None, None), column_types=None):
    """(reference frame, port frame) of one parse, held equal, with the
    sparse columns in the same places."""
    jf = jp.parse_files(paths, setup=setups[0], column_types=column_types)
    pf = pp.parse_files(paths, setup=setups[1], column_types=column_types)
    _assert_frame_equal(jf, pf)
    assert [isinstance(v, pframe.SparseVec) for v in pf.vecs] == \
        [isinstance(v, jframe.SparseVec) for v in jf.vecs]
    return jf, pf


def _setups(paths):
    js, ps = jp.parse_setup(paths), pp.parse_setup(paths)
    _assert_setup_equal(js, ps)
    return js, ps


# -- ARFF ---------------------------------------------------------------------

ARFF_EDGES = """% quoted names, an undeclared level, empty cells
@relation 'edge cases'
@attribute 'first col' numeric
@attribute "kind" {b, a, 'c c'}
@attribute n INTEGER
@attribute txt string
@attribute t date 'yyyy-MM-dd HH:mm:ss'
@data
1.25, a, 3, "x, y", '2021-06-01 10:20:30'
, zz, ?, , ?
-7e-3, 'c c', 0, plain, '1999-12-31 23:59:59'
?, b, 12, '', '2000-02-29 00:00:00'
"""


@pytest.mark.parametrize("text", [ARFF, ARFF_EDGES], ids=["weather", "edges"])
def test_arff(cl, tmp_path, text):
    p = [_write(tmp_path, "d.arff", text)]
    _setups(p)
    _, pf = _both(p)
    assert pf.types()[1] == "enum" and pf.types()[-1] == "time"


def test_arff_declared_order_and_na(cl, tmp_path):
    _, pf = _both([_write(tmp_path, "e.arff", ARFF_EDGES)])
    assert pf.names == ["first col", "kind", "n", "txt", "t"]
    assert pf.vec("kind").domain == ["b", "a", "c c"]
    np.testing.assert_array_equal(pf.vec("kind").data, [1, -1, 2, 0])
    assert np.isnan(pf.vec("first col").data[[1, 3]]).all()
    assert pf.vec("txt").host_data == ["x, y", None, "plain", None]
    assert pf.vec("t").host_f64[0] == 1622542830000.0


def test_arff_two_files_and_magic(cl, tmp_path):
    """Two ARFF files (rows concatenated, domains unioned in first-seen
    order) and one found by its ``@relation`` line, not its name."""
    a = _write(tmp_path, "a.arff", ARFF)
    b = _write(tmp_path, "b.arff", ARFF.replace("{sunny, overcast, rainy}",
                                                "{rainy, fog, sunny}")
               .replace("overcast,", "fog,"))
    _both([a, b])
    _both([_write(tmp_path, "weather.txt", ARFF)])


# -- SVMLight -----------------------------------------------------------------

def _svm_text(rng, n, width):
    """Seeded SVMLight rows: a dense first column, a column with nnz
    exactly n/2, a sparse one-hot block, an index that never appears
    (an all-zero column), a comment line, trailing comments, a repeated
    index on one line, and the highest index only on the last row."""
    lines = ["# a comment line"]
    for i in range(n):
        kv = [f"1:{rng.normal():.9g}"]
        if i % 2 == 0:
            kv.append(f"2:{rng.uniform(1, 2):.9g}")
        k = int(rng.integers(0, 4))
        kv.append(f"{4 + k}:1")
        if i == 3:
            kv += ["5:7.5", "5:-2"]            # the last value wins
        if i == n - 1:
            kv.append(f"{width}:{rng.normal():.6g}")
        tail = "  # note" if i % 7 == 0 else ""
        lines.append(f"{int(rng.integers(0, 3))} " + " ".join(kv) + tail)
    return "\n".join(lines) + "\n"


def test_svmlight(cl, tmp_path):
    rng = np.random.default_rng(0)
    p = [_write(tmp_path, "d.svm", _svm_text(rng, 40, 12))]
    _setups(p)
    _, pf = _both(p)
    assert pf.names == ["target"] + [f"C{j}" for j in range(1, 14)]
    sparse = [isinstance(v, pframe.SparseVec) for v in pf.vecs]
    # C1 (index 0) and C4 (index 3) are all zero, C3 has nnz = n/2
    assert sparse == [False, True, False, False, True, True, True, True,
                      True, True, True, True, True, True]
    assert pf.vec("C1").nnz == 0
    assert pf.vec("C6").data[3] == -2.0


def test_svmlight_multi_file_pads(cl, tmp_path):
    rng = np.random.default_rng(1)
    a = _write(tmp_path, "a.svmlight", _svm_text(rng, 20, 6))
    b = _write(tmp_path, "b.svmlight", _svm_text(rng, 30, 15))
    _, pf = _both([a, b])
    assert pf.ncols == 17 and pf.nrows == 50


def test_svmlight_bad_pair_raises(tmp_path):
    for text in ("1 1:2:3\n", "1 3\n", "1 x:2\n"):
        p = _write(tmp_path, "bad.svm", text)
        for parse in (jp.parse_files, pp.parse_files):
            with pytest.raises(ValueError):
                parse([p])


# -- Avro ---------------------------------------------------------------------

def _zig(n):
    u = (n << 1) ^ (n >> 63)
    out = b""
    while True:
        b7 = u & 0x7F
        u >>= 7
        if u:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _container(fields, body, count, codec=None, sync=bytes(range(16))):
    """An Avro container assembled byte by byte from the spec."""
    schema = ('{"type":"record","name":"r","fields":[' + ",".join(fields) +
              "]}").encode()
    meta = [(b"avro.schema", schema)]
    if codec:
        meta.append((b"avro.codec", codec))
    head = b"Obj\x01" + _zig(len(meta)) + b"".join(
        _zig(len(k)) + k + _zig(len(v)) + v for k, v in meta) + _zig(0)
    blocks = _zig(count) + _zig(len(body)) + body + sync if count else b""
    return head + sync + blocks


def _logical_fixture():
    fields = ['{"name":"ts","type":{"type":"long",'
              '"logicalType":"timestamp-millis"}}',
              '{"name":"us","type":["null",{"type":"long",'
              '"logicalType":"timestamp-micros"}]}',
              '{"name":"d","type":[{"type":"int","logicalType":"date"},'
              '"null"]}',
              '{"name":"tm","type":{"type":"int","logicalType":'
              '"time-millis"}}',
              '{"name":"tu","type":{"type":"long","logicalType":'
              '"time-micros"}}',
              '{"name":"e","type":{"type":"enum","name":"E",'
              '"symbols":["z","y","x"]}}',
              '{"name":"b","type":"boolean"}',
              '{"name":"f","type":["float","null"]}',
              '{"name":"u","type":{"type":"string","logicalType":"uuid"}}',
              '{"name":"by","type":"bytes"}']
    rows = [(1579046400000, 1579046400123456, 18000, 3600000, 5_000_000_123,
             2, 1, 1.5, "a", b"q"),
            (-86400001, None, None, 0, 999, 0, 0, None, "b", b"r"),
            (0, -1, -1, 86399999, 0, 1, 1, -0.25, "a", b"")]
    body = b""
    for ts, us, d, tm, tu, e, b_, f, u, by in rows:
        body += _zig(ts)
        body += _zig(0) if us is None else _zig(1) + _zig(us)
        body += _zig(1) if d is None else _zig(0) + _zig(d)
        body += _zig(tm) + _zig(tu) + _zig(e) + bytes([b_])
        body += _zig(1) if f is None else _zig(0) + struct.pack("<f", f)
        body += _zig(len(u)) + u.encode() + _zig(len(by)) + by
    return fields, body, len(rows)


@pytest.mark.parametrize("codec", ["null", "deflate"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_avro_written(cl, tmp_path, codec, writer):
    rng = np.random.default_rng(2)
    x = [float(v) for v in rng.normal(size=50)] + [None, float("nan")]
    lab = [str(v) for v in rng.choice(["p", "q", "r"], size=50)] + \
        [None, "q"]
    p = str(tmp_path / "w.avro")
    (pavro if writer == "port" else javro).write_avro(
        p, ["x", "label"], ["num", "str"], [x, lab], codec=codec)
    for mod in (pavro, javro):
        assert mod.read_avro(p)[:2] == (["x", "label"], ["num", "str"])
    _setups([p])
    _, pf = _both([p])
    assert pf.vec("label").domain == ["p", "q", "r"]
    shutil.copy(p, tmp_path / "noext")
    _both([str(tmp_path / "noext")])


def test_avro_fixtures(cl, tmp_path):
    """The reference test's hand-written container, and one of every
    logical type, union order, enum, boolean, float, uuid and bytes."""
    fix = _container(['{"name":"i","type":"int"}',
                      '{"name":"s","type":["null","string"]}'],
                     _zig(7) + _zig(1) + _zig(3) + b"foo" + _zig(-2) +
                     _zig(0), 2)
    p1 = _write(tmp_path, "fix.avro", fix)
    p2 = _write(tmp_path, "logical.avro", _container(*_logical_fixture(),
                                                     codec=b"null"))
    for p in (p1, p2):
        _setups([p])
        _both([p])
    _, pf = _both([p2])
    assert pf.types() == ["time"] * 5 + ["enum", "real", "real", "enum",
                                         "enum"]
    np.testing.assert_array_equal(
        pf.vec("d").host_f64, [18000 * 86400000.0, np.nan, -86400000.0])
    assert pf.vec("e").domain == ["x", "y", "z"]


def test_avro_two_files_and_schema_mismatch(cl, tmp_path):
    a, b, c = (str(tmp_path / f"{k}.avro") for k in "abc")
    pavro.write_avro(a, ["x", "k"], ["num", "str"], [[1.0, 2.0], ["u", "v"]])
    pavro.write_avro(b, ["x", "k"], ["num", "str"], [[3.0], ["a"]])
    pavro.write_avro(c, ["x", "j"], ["num", "str"], [[3.0], ["a"]])
    _, pf = _both([a, b])
    assert pf.vec("k").domain == ["a", "u", "v"]
    for parse in (jp.parse_files, pp.parse_files):
        with pytest.raises(ValueError, match="avro schema mismatch"):
            parse([a, c])


@pytest.mark.parametrize("case", ["array", "decimal", "codec", "union",
                                  "magic"])
def test_avro_refusals(cl, tmp_path, case):
    fields = {
        "array": ['{"name":"a","type":{"type":"array","items":"int"}}'],
        "decimal": ['{"name":"d","type":{"type":"bytes","logicalType":'
                    '"decimal","precision":9,"scale":2}}'],
        "union": ['{"name":"w","type":["null","int","string"]}'],
    }.get(case, ['{"name":"i","type":"int"}'])
    blob = _container(fields, _zig(1), 1,
                      codec=b"snappy" if case == "codec" else None)
    if case == "magic":
        blob = b"Obj\x02" + blob[4:]
    p = _write(tmp_path, "bad.avro", blob)
    match = {"array": "'a'", "decimal": "decimal", "codec": "snappy",
             "union": "unions", "magic": "bad magic"}[case]
    for mod in (javro, pavro):
        with pytest.raises(mod.AvroError, match=match):
            mod.read_avro(p)
    for parse in (jp.parse_files, pp.parse_files):
        with pytest.raises(ValueError, match=match):
            parse([p])


# -- XLS / XLSX ---------------------------------------------------------------

def _xlsx(tmp_path, name="t.xlsx"):
    p = tmp_path / name
    with zipfile.ZipFile(p, "w") as z:
        z.writestr("xl/sharedStrings.xml", _SST)
        z.writestr("xl/worksheets/sheet1.xml", _SHEET)
    return str(p)


@pytest.mark.parametrize("book", ["xlsx", "xls", "xls_continue"])
def test_xls(cl, tmp_path, book):
    if book == "xlsx":
        p = _xlsx(tmp_path)
    else:
        p = _write(tmp_path, f"{book}.xls", _ole2(
            _biff_stream() if book == "xls" else _biff_stream_continued()))
    _setups([p])
    _, pf = _both([p])
    assert pf.names == ["num", "color", "y"]
    assert pf.vec("color").domain == ["blue", "red"]


def test_xls_two_books(cl, tmp_path):
    a = _xlsx(tmp_path, "a.xlsx")
    b = _xlsx(tmp_path, "b.xlsx")
    _, pf = _both([a, b])
    assert pf.nrows == 6


def test_xls_truncated_sst_raises(cl, tmp_path):
    out = _rec(0x0809, struct.pack("<HH12x", 0x0600, 0x0005))
    out += _rec(0x00FC, struct.pack("<II", 9, 9) + _bstr("only"))
    out += _rec(0x000A)
    p = _write(tmp_path, "trunc.xls", _ole2(out))
    for parse in (jp.parse_files, pp.parse_files):
        with pytest.raises(ValueError, match="SST declares"):
            parse([p])


# -- Parquet / ORC ------------------------------------------------------------

def _arrow_table(seed, dictionary=True):
    """Floats with NaNs, ints, strings with nulls (and, where the format
    writes them, dictionary-encoded), nullable booleans, timestamps,
    dates."""
    pa = pytest.importorskip("pyarrow")
    rng = np.random.default_rng(seed)
    n = 30
    x = rng.normal(size=n)
    x[[3, 17]] = np.nan
    cat = [None if i % 11 == 0 else str(v) for i, v in
           enumerate(rng.choice(["k", "a", "m"], size=n))]
    ts = (1.6e12 + rng.integers(0, 10 ** 9, size=n)).astype("datetime64[ms]")
    cols = {"x": x, "n": rng.integers(-5, 5, size=n), "cat": cat}
    if dictionary:
        cols["dcat"] = pa.array(cat).dictionary_encode()
    cols.update(
        flag=[None if i % 5 == 0 else bool(i % 2) for i in range(n)],
        ts=pa.array(ts, pa.timestamp("ms")),
        day=pa.array(ts.astype("datetime64[D]"), pa.date32()),
        f32=pa.array(x.astype(np.float32)))
    return pa.table(cols)


@pytest.mark.parametrize("fmt,name", [("parquet", "t.parquet"),
                                      ("parquet", "t.pq"),
                                      ("parquet", "noext"),
                                      ("orc", "t.orc"), ("orc", "noext")])
def test_parquet_orc(cl, tmp_path, fmt, name):
    table = _arrow_table(3, dictionary=fmt == "parquet")
    p = str(tmp_path / name)
    if fmt == "parquet":
        import pyarrow.parquet as pq
        pq.write_table(table, p)
    else:
        from pyarrow import orc
        orc.write_table(table, p)
    _setups([p])
    _, pf = _both([p])
    assert pf.types() == ["real", "real"] + ["enum"] * (
        2 if fmt == "parquet" else 1) + ["real", "time", "time", "real"]
    q = str(tmp_path / ("second" + name))
    shutil.copy(p, q)
    _both([p, q])


def test_parquet_without_pyarrow_raises(tmp_path, monkeypatch):
    pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq
    p = str(tmp_path / "t.parquet")
    pq.write_table(_arrow_table(4), p)
    for mod in [m for m in sys.modules if m.split(".")[0] == "pyarrow"]:
        monkeypatch.setitem(sys.modules, mod, None)
    for call in (pp.parse_setup, pp.parse_files):
        with pytest.raises(ImportError, match="pyarrow"):
            call([p])


def test_no_reader_falls_back_to_csv(tmp_path):
    """A broken file of a format raises from its reader and is never
    read as CSV."""
    cases = {"x.avro": (b"a,b\n1,2\n", "bad magic"),
             "x.xlsx": (b"a,b\n1,2\n", "zip"),
             "x.arff": ("% c\n@relation r\n@data\n1\n", "no @attribute")}
    for name, (data, match) in cases.items():
        p = _write(tmp_path, name, data)
        with pytest.raises(Exception, match=match):
            pp.parse_files([p])


# -- setups edited by a client ------------------------------------------------

def test_setup_overrides_on_format_frames(cl, tmp_path):
    """Renames and numeric <-> categorical overrides on ARFF, Avro and
    SVMLight frames, through ``parse_files``' setup and column_types."""
    arff = _write(tmp_path, "w.arff", ARFF)
    js, ps = _setups([arff])
    for s in (js, ps):
        s.column_names = ["t", "o", "w", "n", "s"]
        s.column_types = ["enum", "enum", "enum", "string", "time"]
    _, pf = _both([arff], (js, ps), column_types={"w": "real"})
    assert pf.names == ["t", "o", "w", "n", "s"]
    assert pf.types()[0] == "enum"
    av = str(tmp_path / "c.avro")
    pavro.write_avro(av, ["code", "lab"], ["num", "str"],
                     [[10.0, 2.0, None, 2.5], ["1", "2", "2", None]])
    _, pf = _both([av], column_types={"code": "enum", "lab": "real"})
    assert pf.vec("code").domain == ["2", "2.5", "10"]
    np.testing.assert_array_equal(pf.vec("lab").data, [1, 2, 2, np.nan])
    rng = np.random.default_rng(5)
    svm = _write(tmp_path, "d.svm", _svm_text(rng, 30, 8))
    _, pf = _both([svm], column_types={"target": "enum"})
    assert pf.vec("target").domain == ["0", "1", "2"]
