"""CSV ingest: h2o_tpu_torch's parse held against h2o_tpu's on the CPU.

Each CSV of ``tests/test_native_parse.py`` (a quoted newline, custom NA
strings, quoted padding, a quoted separator, gzip, a seeded 20,000-row
round trip), two files whose categorical domains differ in content and
order, time columns of each form ``_TIME_RE`` admits, a string column
forced by ``column_types`` and numeric <-> categorical overrides are
parsed by both packages, the reference on its native path.  The sniffed
setups (separator, header, names, types) are equal, and so are the
frames: names, types, domains and codes, numerics bit for bit with NaNs
in the same places, time columns' float64 milliseconds, strings.  A GBM
trained on the parsed frames grows the reference's trees.  A file of
each other format and a URI of each remote scheme parse alike in both
(``tests/test_torch_ingest_formats.py`` holds the formats' readers in
depth).
"""

import gzip
import http.server
import shutil
import threading

import numpy as np
import pytest
import torch

from h2o_tpu.core import frame as jframe
from h2o_tpu.core import parse as jp
from h2o_tpu.models.tree.gbm import GBM as JGBM

from h2o_tpu_torch.core import frame as pframe
from h2o_tpu_torch.core import parse as pp
from h2o_tpu_torch.models.tree.gbm import GBM

pytestmark = pytest.mark.shared_dkv

CSV = ('id,age,income,city,joined,note\n'
       '1,34,55000.5,NYC,2020-01-02,"hello, world"\n'
       '2,NA,62000,SF,2021-07-15,plain\n'
       '3,45,,LA,2019-12-31,"quoted ""x"""\n'
       '4,29,48000,NYC,2022-03-01,\n'
       '5,51,71000,?,2020-06-30,last\n')
TIMES = ('d,m,s,f,g,n\n'
         '2020-01-02,2021-07-15 03:04,2019-12-31T23:59:58,'
         '2022-03-01 01:02:03.4567891,1969-12-31T23:59:59.9999,1\n'
         '1500-01-01,2500-01-01 00:00,2020-02-29T12:00:00,'
         '2020-01-02 03:04:05.5,1969-07-20T20:17:40.1,2\n'
         'NA,1999-12-31 23:59,,2038-01-19 03:14:07.999,'
         '1970-01-01T00:00:00.001,3\n'
         '2024-02-29,2000-01-01 00:01,2010-10-10T10:10:10,'
         '1900-01-01 00:00:00.0,2262-04-11T23:47:16.854775,4\n')


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _assert_setup_equal(js, ps):
    assert ps.separator == js.separator
    assert ps.header == js.header
    assert ps.column_names == js.column_names
    assert ps.column_types == js.column_types
    assert ps.na_strings == js.na_strings


def _assert_frame_equal(jf, pf):
    assert pf.names == jf.names
    assert pf.types() == jf.types()
    assert pf.nrows == jf.nrows
    for name, pv in zip(pf.names, pf.vecs):
        jv = jf.vec(name)
        want = jv.to_numpy()
        if pv.type == pframe.T_CAT:
            assert pv.domain == list(jv.domain), name
            np.testing.assert_array_equal(pv.data, want, err_msg=name)
        elif pv.type == pframe.T_STR:
            assert pv.host_data == list(want), name
        else:
            got = pv.to_numpy()
            assert got.dtype == want.dtype == (
                np.float64 if pv.type == pframe.T_TIME else np.float32), name
            nan = np.isnan(want)
            np.testing.assert_array_equal(np.isnan(got), nan, err_msg=name)
            bits = np.uint64 if got.dtype == np.float64 else np.uint32
            np.testing.assert_array_equal(got[~nan].view(bits),
                                          want[~nan].view(bits),
                                          err_msg=name)


def _both(paths, setup=None, column_types=None):
    """(reference frame, port frame) of one parse; ``setup`` is a pair of
    the packages' setups, or None to sniff."""
    js, ps = setup if setup is not None else (None, None)
    jf = jp.parse_files(paths, setup=js, column_types=column_types,
                        use_native=True)
    pf = pp.parse_files(paths, setup=ps, column_types=column_types)
    _assert_frame_equal(jf, pf)
    return jf, pf


def _sniffed(paths):
    js, ps = jp.parse_setup(paths), pp.parse_setup(paths)
    _assert_setup_equal(js, ps)
    return js, ps


def test_quoted_newline(cl, tmp_path):
    p = [_write(tmp_path, "nl.csv", 'id,note\n1,"a\nb"\n2,plain\n')]
    _, pf = _both(p, _sniffed(p))
    assert pf.nrows == 2 and "a\nb" in pf.vec("note").domain


def test_custom_na_strings(cl, tmp_path):
    p = [_write(tmp_path, "na.csv", "x,y\n1,-999\n-999,2\n3,NA\n")]
    setups = tuple(m.ParseSetupResult(",", True, ["x", "y"],
                                      ["real", "real"], na_strings=["-999"])
                   for m in (jp, pp))
    _, pf = _both(p, setups)
    assert np.isnan(pf.vec("x").data[1]) and np.isnan(pf.vec("y").data[2])


def test_quoted_padding(cl, tmp_path):
    p = [_write(tmp_path, "pad.csv", 'c,n\n" padded ",1\n plain ,2\n')]
    _, pf = _both(p, _sniffed(p))
    assert pf.vec("c").domain == [" padded ", "plain"]


def test_quoted_separator_and_types(cl, tmp_path):
    p = [_write(tmp_path, "t.csv", CSV)]
    _, pf = _both(p, _sniffed(p))
    assert pf.types() == ["real", "real", "real", "enum", "time", "enum"]
    assert "hello, world" in pf.vec("note").domain
    assert pf.vec("city").data[4] == -1


def test_gzip(cl, tmp_path):
    p = tmp_path / "t.csv.gz"
    with gzip.open(p, "wt") as f:
        f.write("x,y\n1,a\n2,b\n")
    _, pf = _both([str(p)], _sniffed([str(p)]))
    np.testing.assert_array_equal(pf.vec("x").data, [1, 2])


def test_large_round_trip(cl, tmp_path):
    rng = np.random.default_rng(42)
    n = 20000
    xs = rng.normal(size=n)
    cats = np.array(["aa", "bb", "cc", "dd"])[rng.integers(0, 4, n)]
    text = [f"{x:.9g}" for x in xs]
    p = [_write(tmp_path, "big.csv", "v,c\n" + "".join(
        f"{text[i]},{cats[i]}\n" for i in range(n)))]
    _, pf = _both(p, _sniffed(p))
    # each token as the nearest double, then float32
    np.testing.assert_array_equal(pf.vec("v").data,
                                  np.float64(text).astype(np.float32))
    assert pf.vec("c").domain == ["aa", "bb", "cc", "dd"]
    assert (np.array(pf.vec("c").domain)[pf.vec("c").data] == cats).all()


def test_two_files_merge_domains(cl, tmp_path):
    """Levels that differ in content and order across files, an unused
    NA-only level and a quoted "NA" that is a real level: one sorted
    domain over both files."""
    a = _write(tmp_path, "a.csv",
               'k,v,w\nzeta,1,x\nbeta,2,NA\nalpha,3,"NA"\nzeta,4,y\n')
    b = _write(tmp_path, "b.csv",
               'k,v,w\ngamma,5,y\nbeta,6,\nomega,7,q\nAlpha,8,x\n')
    _, pf = _both([a, b], _sniffed([a, b]))
    assert pf.vec("k").domain == ["Alpha", "alpha", "beta", "gamma", "omega",
                                  "zeta"]
    assert pf.vec("w").domain == ["NA", "q", "x", "y"]
    _both([b, a], _sniffed([b, a]))


def test_time_forms(cl, tmp_path):
    """A date, minutes after a space, seconds after a T, fractional
    seconds (truncated to the millisecond, before and after 1970), NAs
    and the float32 payload beside the exact milliseconds."""
    p = [_write(tmp_path, "times.csv", TIMES)]
    _, pf = _both(p, _sniffed(p))
    assert pf.types() == ["time"] * 5 + ["real"]
    f = pf.vec("f")
    assert f.host_f64[0] == 1646096523456.0
    np.testing.assert_array_equal(f.data, f.host_f64.astype(np.float32))
    assert pf.vec("g").host_f64[0] == -1.0
    assert np.isnan(pf.vec("d").host_f64[2])


def test_time_rows_of_mixed_forms(cl, tmp_path):
    """Each row is read by its own form, an invalid date is NA.  (The
    reference's pandas reader infers one format from a column's first
    row and reads rows of another form as NA, so this case is held
    against numpy's datetime64 only.)"""
    rows = ["2020-01-02", "2021-07-15 03:04", "2019-12-31T23:59:58",
            "2020-13-01", "2022-03-01 01:02:03.456789"]
    p = [_write(tmp_path, "mixed.csv", "t,n\n" + "".join(
        f"{r},{i}\n" for i, r in enumerate(rows)))]
    fr = pp.parse_files(p)
    want = [np.datetime64(r, "ms").astype(np.int64) if i != 3 else np.nan
            for i, r in enumerate(rows)]
    np.testing.assert_array_equal(fr.vec("t").host_f64,
                                  np.array(want, np.float64))


def test_string_column_forced(cl, tmp_path):
    p = [_write(tmp_path, "t.csv", CSV)]
    _, pf = _both(p, _sniffed(p), column_types={"note": "string",
                                                "city": "string"})
    assert pf.vec("note").host_data == [
        "hello, world", "plain", 'quoted "x"', None, "last"]
    assert pf.vec("city").host_data[4] is None


def test_numeric_enum_overrides(cl, tmp_path):
    """column_types before the parse (the CSV path) and
    ``_apply_setup_overrides`` on a parsed frame (the format readers'
    path), both ways."""
    p = [_write(tmp_path, "codes.csv",
                "code,grade,label\n10,1,a\n2,2.5,b\n33,x,a\n2,NA,b\n,1,c\n")]
    js, ps = _sniffed(p)
    assert ps.column_types == ["real", "enum", "enum"]
    _, pf = _both(p, (js, ps), column_types={"code": "enum", "grade": "real"})
    assert pf.vec("code").domain == ["10", "2", "33"]
    np.testing.assert_array_equal(pf.vec("grade").data,
                                  np.float32([1, 2.5, np.nan, np.nan, 1]))
    overrides = {"code": "enum", "label": "real"}
    jf = jp._apply_setup_overrides(jp.parse_files(p, use_native=True), None,
                                   overrides)
    pf = pp._apply_setup_overrides(pp.parse_files(p), None, overrides)
    _assert_frame_equal(jf, pf)
    assert pf.vec("code").domain == ["2", "10", "33"]
    assert pf.types() == ["enum", "enum", "enum"]     # labels stay enum
    for s in (js, ps):
        s.column_names = ["c1", "c2", "c3"]
        s.column_types = ["enum", "enum", "enum"]
    as_enum = {"code": "enum"}
    jf = jp._apply_setup_overrides(
        jp.parse_files(p, column_types=as_enum, use_native=True), js,
        {"c1": "real"})
    pf = pp._apply_setup_overrides(pp.parse_files(p, column_types=as_enum),
                                   ps, {"c1": "real"})
    _assert_frame_equal(jf, pf)
    assert pf.names == ["c1", "c2", "c3"]
    assert pf.types() == ["real", "enum", "enum"]
    np.testing.assert_array_equal(pf.vec("c1").data,
                                  np.float32([10, 2, 33, 2, np.nan]))


def test_gbm_on_parsed_frames(cl, tmp_path):
    """Numeric columns with NA tokens, a categorical, a time column (a
    numeric feature) and a string column (not a feature): the port's GBM
    on its parsed frame grows the reference's trees on the reference's
    parsed frame."""
    rng = np.random.default_rng(7)
    n = 600
    x0, x1 = rng.normal(size=n), rng.normal(size=n)
    cat = np.array(["u", "v", "w"])[rng.integers(0, 3, n)]
    days = rng.integers(0, 3650, n)
    y = (1.5 * x0 - x1 + (cat == "v") + 0.002 * days +
         rng.logistic(size=n) > 3.5)
    t0 = np.datetime64("2010-01-01")
    lines = ["x0,x1,k,when,note,y"]
    for i in range(n):
        x1s = "NA" if i % 17 == 0 else f"{x1[i]:.9g}"
        lines.append(f"{x0[i]:.9g},{x1s},{cat[i]},{t0 + days[i]},"
                     f"id{i},{'yes' if y[i] else 'no'}")
    p = [_write(tmp_path, "train.csv", "\n".join(lines) + "\n")]
    js, ps = _sniffed(p)
    jf, pf = _both(p, (js, ps), column_types={"note": "string"})
    kw = dict(ntrees=3, max_depth=3, seed=1)
    jm = JGBM(**kw).train(y="y", training_frame=jf)
    pm = GBM(device="cpu", **kw).train(y="y", training_frame=pf)
    assert pm.output["x"] == list(jm.output["x"]) == ["x0", "x1", "k",
                                                      "when"]
    for k in ("split_col", "thr_bin", "na_left", "bitset"):
        np.testing.assert_array_equal(pm.output[k], np.asarray(jm.output[k]),
                                      err_msg=k)
    assert (pm.output["split_col"] == 3).any()       # the time column
    np.testing.assert_allclose(pm.output["value"],
                               np.asarray(jm.output["value"]), rtol=1e-4,
                               atol=1e-6)


def _other_file(name, path):
    """A real file of the format ``name`` stands for: by its extension,
    or, for ``<format>.csv``, by its leading bytes or ``@relation``."""
    from h2o_tpu_torch.core import avro as pavro
    from tests.test_torch_ingest_formats import (ARFF, _arrow_table,
                                                 _svm_text, _xlsx)
    from tests.test_xls_ingest import _biff_stream, _ole2
    fmt = name.split(".")[0] if name.endswith(".csv") else \
        name.split(".")[1]
    if fmt in ("parquet", "pq"):
        import pyarrow.parquet as pq
        pq.write_table(_arrow_table(6), path)
    elif fmt == "orc":
        from pyarrow import orc
        orc.write_table(_arrow_table(7, dictionary=False), path)
    elif fmt == "avro":
        pavro.write_avro(str(path), ["x", "k"], ["num", "str"],
                         [[1.5, None, -2.0], ["b", "a", None]])
    elif fmt == "xls":
        path.write_bytes(_ole2(_biff_stream()))
    elif fmt == "xlsx":
        shutil.copy(_xlsx(path.parent, "book.xlsx"), path)
    elif fmt == "arff":
        path.write_text(ARFF if name == "x.arff" else
                        "% c\n\n@RELATION r\n@attribute a numeric\n"
                        "@data\n1\n?\n2.5\n")
    else:
        path.write_text(_svm_text(np.random.default_rng(8), 25, 9))


_OTHER = ("x.parquet", "x.pq", "x.orc", "x.avro", "x.xls", "x.xlsx",
          "x.arff", "x.svm", "x.svmlight", "parquet.csv", "orc.csv",
          "avro.csv", "arff.csv")


@pytest.mark.parametrize("name", sorted(_OTHER))
def test_other_formats_raise(cl, name, tmp_path):
    """Each file name the port once refused (by extension, by leading
    bytes, by ``@relation``) now holds a real file of its format, which
    both packages parse alike."""
    if "parquet" in name or "pq" in name or "orc" in name:
        pytest.importorskip("pyarrow")
    p = tmp_path / name
    _other_file(name, p)
    _both([str(p)], _sniffed([str(p)]))


class _Stores(http.server.BaseHTTPRequestHandler):
    """An S3-compatible, GCS JSON-API, WebHDFS and plain HTTP endpoint
    serving one CSV at each scheme's object path."""
    store = {}

    def log_message(self, *a):
        pass

    def do_GET(self):
        body = self.store.get(self.path.split("?")[0])
        self.send_response(200 if body is not None else 404)
        self.send_header("Content-Length", str(len(body or b"")))
        self.end_headers()
        self.wfile.write(body or b"")


@pytest.fixture(scope="module")
def stores():
    from h2o_tpu.core import persist as jpersist
    from h2o_tpu_torch.core import persist as ppersist
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Stores)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    for mod in (jpersist, ppersist):
        mod.register_s3(endpoint_url=base)
        mod.register_gcs(endpoint_url=base)
        mod.register_hdfs(namenode_http=base)
    yield base
    for mod in (jpersist, ppersist):
        for scheme in ("s3", "gcs", "hdfs"):
            mod.unregister_scheme(scheme)
    srv.shutdown()
    srv.server_close()


_REMOTE = {"s3": ("s3://bucket/{}.csv", "/bucket/{}.csv"),
           "http": ("{base}/{}.csv", "/{}.csv"),
           "gcs": ("gcs://b/{}.csv", "/storage/v1/b/b/o/{}.csv"),
           "hdfs": ("hdfs://n/{}.csv", "/webhdfs/v1/n/{}.csv")}


@pytest.mark.parametrize("scheme", ["s3", "http", "gcs", "hdfs", "gs"])
def test_remote_paths_raise(cl, stores, scheme, tmp_path):
    """A URI of each scheme the port once refused is fetched through the
    persist byte stores (local stubs) and parsed as the reference parses
    it; a scheme with no store (``gs://``) raises in both packages."""
    if scheme == "gs":
        for call in (jp.parse_files, pp.parse_files):
            with pytest.raises(NotImplementedError, match="scheme 'gs'"):
                call(["gs://b/x.csv"])
        return
    uri, obj = _REMOTE[scheme]
    key = f"{scheme}_{tmp_path.name}"
    _Stores.store[obj.format(key)] = CSV.encode()
    p = [uri.format(key, base=stores)]
    _, pf = _both(p, _sniffed(p))
    assert pf.nrows == 5


def test_file_uri_and_no_pandas_route(tmp_path):
    p = _write(tmp_path, "t.csv", "x,y\n1,a\n2,b\n")
    fr = pp.parse_file("file://" + p)
    assert fr.names == ["x", "y"] and fr.nrows == 2
    with pytest.raises(TypeError):
        pp.parse_files([p], use_native=False)


def test_frame_methods_and_domain_merge(cl):
    rng = np.random.default_rng(3)
    a = rng.normal(size=(6, 3)).astype(np.float32)
    jf, pf = jframe.Frame.from_numpy(a), pframe.Frame.from_numpy(a)
    assert pf.names == jf.names and pf.ncols == jf.ncols == 3
    assert pf.types() == jf.types()
    np.testing.assert_array_equal(pf["C2"].data, jf["C2"].to_numpy())
    assert "C1" in pf and "C9" not in pf
    assert pf[["C3", "C1"]].names == ["C3", "C1"]
    assert pf.drop("C2").names == jf.drop("C2").names == ["C1", "C3"]
    both = pf.cbind(pframe.Frame.from_numpy(a[:, 0], names=["z"]))
    assert both.names == ["C1", "C2", "C3", "z"]
    s = pframe.Vec(["a", None, "c"], pframe.T_STR)
    assert s.nrows == 3 and not s.is_numeric
    assert pframe.Vec([1.0], pframe.T_TIME).is_numeric
    for base, new in ((None, ["b", "a"]), (["a", "c"], ["c", "d", "a"]),
                      (["x"], [])):
        got, want = pframe._merge_domains(base, new), \
            jframe._merge_domains(base, new)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
