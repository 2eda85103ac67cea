"""The persist byte stores, remote paths and streaming ingest:
h2o_tpu_torch held against h2o_tpu on the CPU.

Persist: http(s) reads (writes refused), S3, GCS and WebHDFS against
local stubs as ``tests/test_persist_remote.py`` runs them, the download
cache of ``localize`` (one fetch within ``max_age_s``, its directory's
safety checks), retries under the chaos persist site with the retry
counters equal to the reference's, and frame snapshots that each
package's loader reads back from the other's.  Streaming:
``last_record_end``, a split point swept across a quoted multi-line
record, a chunked parse of many chunks, a transient truncation retried,
follow mode with a cursor restored mid-file, ``append_rows`` and
``Vec.append`` (domain growth, rollups, time and string columns, the
refusals).  A streamed frame equals the reference's streamed frame
(codes and domains, since both merge chunk domains in first-seen order)
and the whole-file parse by decoded labels, numerics bit for bit.
"""

import gzip
import http.server
import os
import threading

import numpy as np
import pytest

from h2o_tpu.core import chaos as jchaos
from h2o_tpu.core import frame as jframe
from h2o_tpu.core import parse as jp
from h2o_tpu.core import persist as jpersist
from h2o_tpu.core import resilience as jres
from h2o_tpu.stream import ChunkReader as JChunkReader
from h2o_tpu.stream.ingest import frame_from_chunk as jframe_from_chunk

from h2o_tpu_torch.core import chaos as pchaos
from h2o_tpu_torch.core import frame as pframe
from h2o_tpu_torch.core import parse as pp
from h2o_tpu_torch.core import persist as ppersist
from h2o_tpu_torch.core import resilience as pres
from h2o_tpu_torch.stream import ChunkReader, frame_from_chunk, \
    last_record_end
from tests.test_torch_parse import _assert_frame_equal

pytestmark = pytest.mark.shared_dkv

CSV = b"a,b,y\n1,2.5,p\n2,0.5,n\n3,1.5,p\n4,,n\n"


class _Srv(http.server.BaseHTTPRequestHandler):
    """Plain HTTP GETs (counted), a fake S3 (PUT/GET), a fake GCS upload
    endpoint and a fake WebHDFS (NameNode 307 -> DataNode PUT)."""
    store = {"/data.csv": CSV, "/data.csv.gz": gzip.compress(CSV)}
    gets = {}

    def log_message(self, *a):
        pass

    def do_GET(self):
        path = self.path.split("?")[0]
        _Srv.gets[path] = _Srv.gets.get(path, 0) + 1
        body = self.store.get(path)
        self.send_response(200 if body is not None else 404)
        self.send_header("Content-Length", str(len(body or b"")))
        self.end_headers()
        self.wfile.write(body or b"")

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        self.store["/gcs-upload/" + self.path.split("name=", 1)[-1]] = \
            self.rfile.read(n)
        self.send_response(200)
        self.send_header("Content-Length", "2")
        self.end_headers()
        self.wfile.write(b"{}")

    def do_PUT(self):
        if "op=CREATE" in self.path and "datanode" not in self.path:
            self.send_response(307)
            self.send_header("Location", f"http://{self.headers['Host']}"
                             f"{self.path}&datanode=1")
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        n = int(self.headers.get("Content-Length", 0))
        path = self.path.split("?")[0]
        if path.startswith("/webhdfs/v1"):
            path = "/hdfs" + path[len("/webhdfs/v1"):]
        self.store[path] = self.rfile.read(n)
        self.send_response(201)
        self.send_header("Content-Length", "0")
        self.end_headers()


@pytest.fixture(scope="module")
def base():
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Srv)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


@pytest.fixture()
def clean():
    """Chaos off and the retry policy and counters fresh, before and
    after, in both packages."""
    for mod, ch in ((pres, pchaos), (jres, jchaos)):
        ch.reset()
        mod.reset_stats()
        mod.set_default_policy(mod.RetryPolicy(base_delay=0.001,
                                               max_delay=0.002, jitter=0))
    yield
    for mod, ch in ((pres, pchaos), (jres, jchaos)):
        ch.reset()
        mod.reset_stats()
        mod.set_default_policy(None)


# -- byte stores --------------------------------------------------------------

def test_http_read_and_write_refused(base):
    for mod in (ppersist, jpersist):
        assert mod.read_bytes(f"{base}/data.csv") == CSV
        with pytest.raises(NotImplementedError, match="read-only"):
            mod.write_bytes(f"{base}/x", b"nope")
        with pytest.raises(Exception):
            mod.read_bytes(f"{base}/missing.csv")


@pytest.mark.parametrize("name", ["data.csv", "data.csv.gz"])
def test_http_parse(cl, base, name):
    jf = jp.parse_file(f"{base}/{name}")
    pf = pp.parse_file(f"{base}/{name}")
    _assert_frame_equal(jf, pf)
    assert pf.nrows == 4 and np.isnan(pf.vec("b").data[3])


def test_localize_fetches_once_within_max_age(base, tmp_path):
    _Srv.store["/once.csv"] = CSV
    _Srv.gets.pop("/once.csv", None)
    a = pp.localize(f"{base}/once.csv")
    b = pp.localize(f"{base}/once.csv")
    assert a == b and _Srv.gets["/once.csv"] == 1
    with open(a, "rb") as f:
        assert f.read() == CSV
    assert os.path.basename(os.path.dirname(a)).startswith(
        "h2o_tpu_torch_remote_u")
    _Srv.store["/once.csv"] = CSV + b"5,1,p\n"
    c = pp.localize(f"{base}/once.csv", max_age_s=0.0)
    assert c == a and _Srv.gets["/once.csv"] == 2
    assert pp.parse_file(f"{base}/once.csv").nrows == 5
    assert pp.localize(str(tmp_path)) == str(tmp_path)
    assert pp.localize("file://" + str(tmp_path)) == str(tmp_path)


def test_cache_directory_checks(tmp_path, monkeypatch):
    """A symlinked or foreign-owned cache directory is refused; a looser
    mode is tightened to 0700."""
    import tempfile
    monkeypatch.setattr(tempfile, "gettempdir", lambda: str(tmp_path))
    cdir = tmp_path / f"h2o_tpu_torch_t_u{os.getuid()}"
    cdir.mkdir(mode=0o755)
    os.chmod(cdir, 0o755)
    got = pp._cached_file("t", "k", ".bin", lambda: b"x")
    assert open(got, "rb").read() == b"x"
    assert os.stat(cdir).st_mode & 0o777 == 0o700
    real = tmp_path / "elsewhere"
    real.mkdir()
    (tmp_path / f"h2o_tpu_torch_s_u{os.getuid()}").symlink_to(real)
    with pytest.raises(PermissionError, match="not an owned private"):
        pp._cached_file("s", "k", ".bin", lambda: b"x")
    lstat = os.lstat

    def foreign(path):
        st = lstat(path)
        if str(path).endswith(f"_f_u{os.getuid()}"):
            fields = list(st)
            fields[4] = os.getuid() + 1               # st_uid
            return os.stat_result(fields)
        return st
    monkeypatch.setattr(os, "lstat", foreign)
    with pytest.raises(PermissionError, match="not an owned private"):
        pp._cached_file("f", "k", ".bin", lambda: b"x")


def test_s3_gcs_hdfs_stubs(cl, base, tmp_path):
    """Each registered store writes and reads back; a frame snapshot
    goes over s3:// and loads in both packages."""
    try:
        for mod in (ppersist, jpersist):
            mod.register_s3(endpoint_url=base)
            mod.register_gcs(endpoint_url=base)
            mod.register_hdfs(namenode_http=base, user="h2o")
        _Srv.store["/storage/v1/b/bkt/o/data.csv"] = CSV
        _Srv.store["/webhdfs/v1/data/in.csv"] = CSV
        for mod in (ppersist, jpersist):
            tag = mod.__name__.split(".")[0]
            mod.write_bytes(f"s3://bucket/{tag}.bin", b"hello")
            assert mod.read_bytes(f"s3://bucket/{tag}.bin") == b"hello"
            with pytest.raises(Exception):
                mod.read_bytes(f"s3://bucket/{tag}-missing")
            assert mod.read_bytes("gcs://bkt/data.csv") == CSV
            mod.write_bytes(f"gcs://bkt/{tag}.bin", b"\x01\x02")
            assert _Srv.store[f"/gcs-upload/{tag}.bin"] == b"\x01\x02"
            assert mod.read_bytes("hdfs://data/in.csv") == CSV
            mod.write_bytes(f"hdfs://data/{tag}.bin", b"\x05")
            assert _Srv.store[f"/hdfs/data/{tag}.bin"] == b"\x05"
        pf = pp.parse_file(f"{base}/data.csv")
        ppersist.save_frame(pf, "s3://bucket/snap")
        _assert_frame_equal(jpersist.load_frame("s3://bucket/snap"),
                            ppersist.load_frame("s3://bucket/snap"))
    finally:
        for mod in (ppersist, jpersist):
            for scheme in ("s3", "gcs", "hdfs"):
                mod.unregister_scheme(scheme)
    with pytest.raises(NotImplementedError, match="no persist backend"):
        ppersist.read_bytes("s3://bucket/port.bin")


def test_retries_under_chaos_persist(cl, tmp_path, clean):
    """Injected transient faults are retried and recovered from; the
    retry counters and the chaos counters equal the reference's over the
    same calls; a missing file fails at once, as a permanent error."""
    p = tmp_path / "blob.bin"
    p.write_bytes(b"payload")
    out = []
    for mod, res, ch in ((ppersist, pres, pchaos),
                         (jpersist, jres, jchaos)):
        ch.configure(persist_transient=2)
        assert mod.read_bytes(str(p)) == b"payload"
        mod.write_bytes(str(tmp_path / "out.bin"), b"w")
        with pytest.raises(FileNotFoundError):
            mod.read_bytes(str(tmp_path / "missing.bin"))
        out.append((res.stats(), ch.chaos().counters()["injected_persist"]))
    assert out[0] == out[1]
    # two faults for each (op, uri): the read, the write and the missing
    # file's read, which then fails as permanent
    assert out[0][0]["retries"] == 6 and out[0][0]["recoveries"] == 2
    assert out[0][0]["permanent_failures"] == 1 and out[0][1] == 6


def test_default_policy_from_environment(monkeypatch, clean):
    monkeypatch.setenv("H2O_TPU_RETRY_MAX_ATTEMPTS", "7")
    monkeypatch.setenv("H2O_TPU_RETRY_TOTAL_DEADLINE", "3")
    for mod in (pres, jres):
        mod.set_default_policy(None)
        got = mod.default_policy()
        assert (got.max_attempts, got.base_delay, got.max_delay,
                got.total_deadline) == (7, 0.05, 2.0, 3.0)
        assert mod.default_policy() is got


def _mixed_frames():
    """The same columns as a port and a reference frame: numeric with
    NaN, categorical with NA, time, string with None, and a sparse
    column."""
    rng = np.random.default_rng(3)
    n = 40
    x = rng.normal(size=n).astype(np.float32)
    x[5] = np.nan
    codes = rng.integers(-1, 3, size=n).astype(np.int32)
    t = 1.6e12 + rng.integers(0, 10 ** 9, size=n).astype(np.float64)
    s = [None if i % 9 == 0 else f"s{i}" for i in range(n)]
    idx, vals = np.array([2, 17, 31]), np.array([1.5, -2.0, 3.0])
    out = []
    for m in (pframe, jframe):
        out.append(m.Frame(["x", "k", "t", "s", "sp"], [
            m.Vec(x), m.Vec(codes, m.T_CAT, domain=["u", "v", "w"]),
            m.Vec(t, m.T_TIME), m.Vec(s, m.T_STR),
            m.SparseVec(idx, vals, n)]))
    return out


def test_save_load_frame_both_ways(cl, tmp_path):
    pf, jf = _mixed_frames()
    ppersist.save_frame(pf, str(tmp_path / "p"))
    jpersist.save_frame(jf, str(tmp_path / "j"))
    for d in ("p", "j"):
        back = ppersist.load_frame(str(tmp_path / d))
        _assert_frame_equal(jpersist.load_frame(str(tmp_path / d)), back)
        _assert_frame_equal(jf, back)
        assert type(back.vec("sp")) is pframe.Vec       # loads dense


# -- streaming ----------------------------------------------------------------

def test_last_record_end_quote_parity():
    assert last_record_end(b"a,b\nc,d\n") == 8
    assert last_record_end(b"a,b\nc,d") == 4
    assert last_record_end(b'1,"x\ny"\n2,z') == 8
    assert last_record_end(b'1,"open\nnever') == 0
    assert last_record_end(b'1,"a""b"\n') == 9
    assert last_record_end(b"a\r\nb\r") == 3
    rng = np.random.default_rng(0)
    for _ in range(200):
        buf = bytes(rng.choice(list(b'ab,"\n\r'), size=int(
            rng.integers(0, 40))).tolist())
        want, in_q = 0, False
        for i, c in enumerate(buf):
            if c == 0x22:
                in_q = not in_q
            elif c == 0x0A and not in_q:
                want = i + 1
        assert last_record_end(buf) == want, buf


def _stream(reader_cls, from_chunk, source, **kw):
    rd = reader_cls(source, **kw)
    fr, n = None, 0
    for cols in rd:
        fr = from_chunk(cols, rd.setup) if fr is None else \
            fr.append_rows(cols)
        n += 1
    return fr, n, rd


def _labels(v):
    dom = np.asarray(list(v.domain) + [None], dtype=object)
    return list(dom[np.asarray(v.to_numpy())[: v.nrows]])


def _hold_whole(pstream, pwhole):
    """A streamed frame against the whole-file parse: numerics bit for
    bit, categoricals by their decoded labels."""
    assert pstream.names == pwhole.names
    assert pstream.nrows == pwhole.nrows
    for a, b in zip(pstream.vecs, pwhole.vecs):
        if a.is_categorical:
            assert _labels(a) == _labels(b)
        else:
            np.testing.assert_array_equal(a.to_numpy(), b.to_numpy())


SWEEP = (b'x,lbl,when\n'
         b'1,"a\nmulti line",2020-01-02\n'
         b'2,"b,c",2021-07-15\r\n'
         b'3,plain,NA\n'
         b'4,"q""uote",1999-12-31\n'
         b'5,NA,2000-02-29\n')


def test_chunk_split_sweep_across_quoted_record(cl, tmp_path):
    """Every split point across a quoted multi-line record, a CRLF, an
    escaped quote, a quoted separator and NAs: the port's streamed frame
    equals the reference's streamed frame and the whole-file parse."""
    p = tmp_path / "sweep.csv"
    p.write_bytes(SWEEP)
    whole = pp.parse_file(str(p))
    for split in range(1, len(SWEEP)):
        blocks = [SWEEP[:split], SWEEP[split:]]
        pf, _, _ = _stream(ChunkReader, frame_from_chunk, iter(blocks),
                           chunk_bytes=4)
        jf, _, _ = _stream(JChunkReader, jframe_from_chunk, iter(blocks),
                           chunk_bytes=4)
        _assert_frame_equal(jf, pf)
        _hold_whole(pf, whole)


def _csv_bytes(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3))
    lab = rng.choice(["s", "b", "q", "z"], size=n)
    lab[n // 2] = "a"                # a level first seen mid-stream
    day = np.datetime64("2020-01-01") + rng.integers(0, 900, size=n)
    lines = ["x0,x1,x2,y,d"] + [
        f"{X[i, 0]:.6f},{X[i, 1]:.6f},{X[i, 2]:.9g},{lab[i]},{day[i]}"
        for i in range(n)]
    return ("\n".join(lines) + "\n").encode()


def test_chunked_parse_matches_whole_file(cl, tmp_path):
    p = tmp_path / "s.csv"
    p.write_bytes(_csv_bytes(300, 3))
    whole = pp.parse_file(str(p))
    pf, n, rd = _stream(ChunkReader, frame_from_chunk, str(p),
                        chunk_rows=16)
    jf, _, _ = _stream(JChunkReader, jframe_from_chunk, str(p),
                       chunk_rows=16)
    assert n > 10 and rd.chunks_read == n and rd.rows_read == 300
    _assert_frame_equal(jf, pf)
    _hold_whole(pf, whole)
    assert pf.vec("y").domain == ["b", "q", "s", "z", "a"]   # first seen
    assert whole.vec("y").domain == ["a", "b", "q", "s", "z"]


def test_stream_truncation_chaos_retries(cl, tmp_path, clean):
    """Two transient truncations of the source are retried and the
    stream recovers; the counters equal the reference reader's."""
    p = tmp_path / "t.csv"
    p.write_bytes(_csv_bytes(60, 4))
    whole = pp.parse_file(str(p))
    got, frames = [], []
    for reader, from_chunk, res, ch in (
            (ChunkReader, frame_from_chunk, pres, pchaos),
            (JChunkReader, jframe_from_chunk, jres, jchaos)):
        ch.configure(stream_truncate_transient=2)
        frames.append(_stream(reader, from_chunk, str(p),
                              chunk_rows=16)[0])
        c = ch.chaos().counters()
        assert c["injected"] == sum(v for k, v in c.items()
                                    if k != "injected")
        got.append((res.stats(), c["injected_stream_truncations"]))
    _hold_whole(frames[0], whole)
    _assert_frame_equal(frames[1], frames[0])
    assert got[0] == got[1]
    assert got[0][1] == 2 and got[0][0]["retries"] == 2
    assert got[0][0]["recoveries"] == 1


def test_follow_mode_cursor_restore(cl, tmp_path):
    """A followed file grows while it is read, its last record torn; a
    second reader restored at the first one's cursor and the first
    reader itself each deliver the rest: no record repeated or
    dropped."""
    data = _csv_bytes(50, 5)
    cut = data.index(b"\n", len(data) // 2) + 10      # inside a record
    p = tmp_path / "grow.csv"
    p.write_bytes(data[:cut])
    whole = pp.parse_file(_write_copy(tmp_path, data))

    def drain(rd):
        out = []
        while True:
            c = rd.next_chunk(wait=False)
            if c is None:
                return out
            out.append(c)

    rd = ChunkReader(str(p), follow=True, poll_ms=1, chunk_bytes=128)
    first = drain(rd)
    assert not rd.exhausted
    cursor, rows = rd.offset, rd.rows_read
    assert data[cursor - 1:cursor] == b"\n" and cursor < cut
    with open(p, "ab") as f:
        f.write(data[cut:])
    rest = drain(rd)
    rd.stop()
    assert rd.next_chunk() is None and rd.exhausted
    rd2 = ChunkReader(str(p), setup=rd.setup, follow=True, poll_ms=1,
                      chunk_bytes=128)
    rd2.restore_cursor(cursor, rows_read=rows)
    again = drain(rd2)
    rd2.stop()
    rd.close()
    rd2.close()
    for tail in (rest, again):
        fr = frame_from_chunk(first[0], rd.setup)
        for c in first[1:] + tail:
            fr.append_rows(c)
        _hold_whole(fr, whole)
    assert rd2.rows_read == 50


def _write_copy(tmp_path, data):
    q = tmp_path / "whole.csv"
    q.write_bytes(data)
    return str(q)


def test_chunk_reader_sources(cl, base, tmp_path):
    """A URI (through ``localize``), an open binary file and the empty
    stream."""
    pf, _, _ = _stream(ChunkReader, frame_from_chunk, f"{base}/data.csv",
                       chunk_bytes=8)
    _hold_whole(pf, pp.parse_file(f"{base}/data.csv"))
    p = tmp_path / "f.csv"
    p.write_bytes(CSV)
    with open(p, "rb") as f:
        pf2, _, _ = _stream(ChunkReader, frame_from_chunk, f)
    _hold_whole(pf2, pf)
    with pytest.raises(ValueError, match="empty stream source"):
        ChunkReader(iter([b""]))
    rd = ChunkReader(iter([CSV[:12], CSV[12:]]), setup=pp.parse_setup(
        [str(p)]), chunk_bytes=4, emit_partial=False)
    assert sum(len(c["a"]) for c in rd) == 4


# -- append -------------------------------------------------------------------

def test_append_categorical_time_string(cl):
    """Domain growth remapped as the reference's ``Vec.append`` remaps
    it (an out-of-range chunk code is NA), time columns' exact float64
    milliseconds extended, string lists extended."""
    kw = dict(domain=["a", "b"])
    pv = pframe.Vec(np.array([0, 1, 0, -1], np.int32), pframe.T_CAT, **kw)
    jv = jframe.Vec(np.array([0, 1, 0, -1], np.int32), jframe.T_CAT, **kw)
    for chunk, dom in (([0, 1, -1], ["b", "c"]), ([2, 0, 5], ["c", "d", "a"]),
                       ([1, 1], None), ([0], ["a", "b", "c", "d"])):
        for v in (pv, jv):
            v.append(np.array(chunk, np.int32), domain=dom)
        assert pv.domain == list(jv.domain)
        np.testing.assert_array_equal(pv.data, jv.to_numpy())
    assert pv.rollups.nacnt == int(jv.nacnt())
    t = pframe.Vec(np.array([1.7e12, 1.7e12 + 1000.0]), pframe.T_TIME)
    s = pframe.Vec(["a", "b"], pframe.T_STR)
    fr = pframe.Frame(["t", "s"], [t, s])
    fr.append_rows({"t": np.array([1.7e12 + 2000.0]), "s": ["c"]})
    np.testing.assert_array_equal(t.host_f64,
                                  [1.7e12, 1.7e12 + 1000.0, 1.7e12 + 2000.0])
    np.testing.assert_array_equal(t.data, t.host_f64.astype(np.float32))
    assert s.host_data == ["a", "b", "c"] and fr.nrows == 3


def test_append_invalidates_rollups(cl):
    pv = pframe.Vec(np.arange(10, dtype=np.float32))
    jv = jframe.Vec(np.arange(10, dtype=np.float32))
    assert pv.rollups.mean == pytest.approx(4.5)
    for v in (pv, jv):
        v.append(np.array([100.0, 200.0, np.nan], np.float32))
    r = pv.rollups
    assert (r.cnt, r.nacnt, r.min, r.max) == (12, 1, 0.0, 200.0)
    assert abs(r.mean - float(jv.mean())) <= 1e-6 * 200
    assert abs(r.sigma - float(jv.sigma())) <= 1e-6 * abs(r.sigma)
    np.testing.assert_array_equal(pv.data, jv.to_numpy())


def test_append_grows_in_powers_of_two(cl):
    """4,095 one-row appends allocate 12 buffers (2, 4, .., 4,096 rows),
    not 4,095."""
    v = pframe.Vec(np.zeros(1, np.float32))
    allocs, buf = 0, None
    for i in range(4095):
        v.append(np.array([i], np.float32))
        allocs += v.__dict__["_buf"][0] is not buf
        buf = v.__dict__["_buf"][0]
    assert v.nrows == 4096 and allocs == 12
    np.testing.assert_array_equal(v.data[1:], np.arange(4095))
    assert v.__dict__["_buf"][0].shape == (4096,)


def test_append_rows_refusals(cl):
    def fr():
        return pframe.Frame(["x", "k"], [
            pframe.Vec(np.zeros(2, np.float32)),
            pframe.Vec(np.zeros(2, np.int32), pframe.T_CAT, domain=["u"])])
    with pytest.raises(ValueError, match=r"missing columns \['k'\]"):
        fr().append_rows({"x": np.zeros(1)})
    with pytest.raises(ValueError, match="ragged append chunk: column 'k'"):
        fr().append_rows({"x": np.zeros(2), "k": (np.zeros(3), ["u"])})
    bad = pframe.Frame(["x", "k"], [pframe.Vec(np.zeros(1, np.float32)),
                                    pframe.Vec(np.zeros(1, np.float32))])
    with pytest.raises(ValueError, match="type mismatch on 'k'"):
        fr().append_rows(bad)
    with pytest.raises(ValueError, match="schema mismatch"):
        fr().append_rows(pframe.Frame(["k", "x"], list(bad.vecs)))
    f = fr()
    f.append_rows(f.slice_rows(slice(0, 1)))
    assert f.nrows == 3 and f.vec("k").domain == ["u"]
