"""The sparse column codec and the cluster timezone: h2o_tpu_torch held
against h2o_tpu on the CPU.

``SparseVec``: the dense form built only when read, ``nnz``, the values
and rollups of the reference's ``SparseVec`` over the same pairs
(counts, min and max equal; mean within 1e-6 of the largest |value|,
sigma 1e-6 relative, as ``test_torch_glm_datainfo.py`` holds rollups),
graduation out of the codec on a dense write or an append; SVMLight's
edges (a column with nnz exactly half the rows, an all-zero column, an
index first seen on the last row); and a multinomial GBM trained on an
SVMLight frame with sparse one-hot blocks, whose trees are held against
the reference's GBM on its own parse of the file through
``hold_gbm_forest`` (``test_torch_find_splits_order.py``).

The cluster timezone: ``set_timezone`` refuses what the reference's
``(setTimeZone)`` refuses, with its words; naive CSV and ARFF times
parsed under a zone equal the reference's parse under the same zone
(its ``_apply_cluster_tz``, pandas' ``tz_localize`` with ambiguous and
nonexistent times NaT), including DST gap and fold rows, and equal
``zoneinfo`` row by row; no zone or UTC changes nothing.
"""

import datetime as dt
import zoneinfo

import numpy as np
import pandas as pd
import pytest

from h2o_tpu.core import frame as jframe
from h2o_tpu.core import parse as jp
from h2o_tpu.core.cloud import cloud as jcloud
from h2o_tpu.models.tree.gbm import GBM as JGBM
from h2o_tpu.rapids.interp import rapids_exec

from h2o_tpu_torch.core import device as pdevice
from h2o_tpu_torch.core import frame as pframe
from h2o_tpu_torch.core import parse as pp
from h2o_tpu_torch.models.tree.gbm import GBM
from tests.test_torch_find_splits_order import hold_gbm_forest
from tests.test_torch_parse import _assert_frame_equal

pytestmark = pytest.mark.shared_dkv


def _hold_rollups(pv, jv):
    r, w = pv.rollups, jv.rollups
    assert (r.cnt, r.nacnt, r.zeros, r.isint) == (w.cnt, w.nacnt, w.zeros,
                                                  w.isint)
    assert (r.min, r.max) == (w.min, w.max)
    top = max(abs(r.min), abs(r.max), 1e-30)
    assert abs(r.mean - w.mean) <= 1e-6 * top
    assert abs(r.sigma - w.sigma) <= 1e-6 * abs(w.sigma)


@pytest.mark.parametrize("default", [0.0, -1.5])
def test_sparse_codec(cl, default):
    rng = np.random.default_rng(0)
    n = 1000
    idx = np.sort(rng.choice(n, size=37, replace=False))
    vals = rng.normal(size=37).astype(np.float32)
    vals[4] = 0.0
    pv = pframe.SparseVec(idx, vals, n, default=default)
    jv = jframe.SparseVec(idx, vals, n, default=default)
    assert pv.nnz == jv.nnz == 37 and pv.nrows == n
    assert pv._dense is None                     # lazy: no dense form yet
    np.testing.assert_array_equal(pv.to_numpy(), jv.to_numpy())
    assert pv._dense is not None and pv._sparse is not None
    assert pv.to_numpy().dtype == np.float32
    _hold_rollups(pv, jv)
    np.testing.assert_array_equal(
        pframe.Frame(["s"], [pv]).as_matrix(None, "cpu").numpy()[:, 0],
        jv.to_numpy())


def test_sparse_graduates(cl):
    pv = pframe.SparseVec([1, 3], [2.0, 4.0], 5)
    jv = jframe.SparseVec([1, 3], [2.0, 4.0], 5)
    for v in (pv, jv):
        v.append(np.array([7.0, 0.0], np.float32))
    assert pv._sparse is None and pv.nrows == 7
    np.testing.assert_array_equal(pv.to_numpy(), jv.to_numpy())
    _hold_rollups(pv, jv)
    pw = pframe.SparseVec([0], [1.0], 3)
    pw.data = np.array([5.0, 6.0, 7.0], np.float32)
    assert pw._sparse is None and pw.rollups.mean == 6.0
    with pytest.raises(ValueError):
        pframe.SparseVec([1, 2], [1.0], 4)
    with pytest.raises(ValueError):
        pframe.SparseVec([1], [1.0], 4, vtype=pframe.T_CAT)


def test_svmlight_edges(cl, tmp_path):
    """nnz exactly n/2 is dense in both, an index never seen gives an
    all-zero sparse column, an index first seen on the last row widens
    the frame; the sparse columns' rollups equal the reference's."""
    lines = [f"{i % 2} 2:{i + 1}" + (" 3:1.5" if i % 2 else "") for i in
             range(10)] + ["1 1:1 9:-4.25"]
    p = tmp_path / "e.svm"
    p.write_text("\n".join(lines) + "\n")
    jf = jp.parse_files([str(p)])
    pf = pp.parse_files([str(p)])
    _assert_frame_equal(jf, pf)
    kinds = [type(v).__name__ for v in pf.vecs]
    assert kinds == [type(v).__name__ for v in jf.vecs]
    # target, C1 (idx 0, none), C2 (idx 1, once), C3 (11 of 11), C4 (5 of
    # 11: below half), C5..C9 (none), C10 (once, on the last row)
    assert kinds == ["Vec", "SparseVec", "SparseVec", "Vec", "SparseVec"] + \
        ["SparseVec"] * 6
    p2 = tmp_path / "h.svm"
    p2.write_text("\n".join(lines[:10]) + "\n")
    assert isinstance(pp.parse_files([str(p2)]).vec("C4"), pframe.Vec)
    assert not isinstance(pp.parse_files([str(p2)]).vec("C4"),
                          pframe.SparseVec)              # 5 of 10
    for name in ("C1", "C2", "C4", "C10"):
        _hold_rollups(pf.vec(name), jf.vec(name))
    assert pf.vec("C1").nnz == 0 and pf.vec("C10").data[-1] == -4.25


def _covertype_svm(path, n=1500, seed=0):
    """A small covertype-shaped SVMLight file: three normal columns
    (indices 1-3), a 4-way and a 10-way one-hot block (4-7, 8-17) and 3
    classes (labels 1-3), values with 9 significant digits."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3)).astype(np.float32)
    wild = rng.choice(4, size=n, p=[0.55, 0.1, 0.3, 0.05])
    soil = rng.choice(10, size=n)
    score = X @ rng.normal(size=(3, 3)) + rng.normal(size=(4, 3))[wild] + \
        rng.normal(size=(10, 3))[soil] + rng.gumbel(size=(n, 3))
    y = score.argmax(axis=1) + 1
    with open(path, "w") as f:
        for i in range(n):
            kv = [f"{j + 1}:{X[i, j]:.9g}" for j in range(3)] + \
                [f"{4 + wild[i]}:1", f"{8 + soil[i]}:1"]
            f.write(f"{y[i]} " + " ".join(kv) + "\n")


def test_gbm_on_svmlight_frame(cl, tmp_path):
    p = str(tmp_path / "cov.svm")
    _covertype_svm(p)
    as_enum = {"target": "enum"}
    jf = jp.parse_files([p], column_types=as_enum).drop("C1")
    pf = pp.parse_files([p], column_types=as_enum).drop("C1")
    assert sum(isinstance(v, pframe.SparseVec) for v in pf.vecs) == 13
    kw = dict(ntrees=3, max_depth=4, seed=1)
    jm = JGBM(**kw).train(y="target", training_frame=jf)
    pm = GBM(device="cpu", **kw).train(y="target", training_frame=pf)
    jo = {k: (np.asarray(v) if hasattr(v, "shape") else v)
          for k, v in jm.output.items()}
    assert pm.output["x"] == list(jm.output["x"])
    keep, _, ties = hold_gbm_forest(
        pm, jo, jm.params, pf, pf.vec("target").data.astype(np.int64),
        np.ones(pf.nrows))
    assert keep[0].all()
    assert (pm.output["split_col"] >= 0).sum() > 20
    if not ties:
        np.testing.assert_allclose(pm.output["value"], jo["value"],
                                   rtol=1e-4, atol=1e-6)


# -- the cluster timezone -----------------------------------------------------

@pytest.fixture()
def zone(monkeypatch):
    """Set one timezone in both packages for a test."""
    monkeypatch.setattr(pdevice, "_timezone", None)
    monkeypatch.setattr(jcloud(), "timezone", None, raising=False)

    def set_both(tz):
        pdevice.set_timezone(tz)
        rapids_exec(f'(setTimeZone "{tz}")')
        assert jcloud().timezone == pdevice.timezone() == tz
    return set_both


def test_set_timezone_refusal(zone):
    for bad in ("Mars/Olympus", "utc+1", ""):
        with pytest.raises(ValueError) as want:
            rapids_exec(f'(setTimeZone "{bad}")')
        with pytest.raises(ValueError) as got:
            pdevice.set_timezone(bad)
        assert str(got.value) == str(want.value)
        assert "Unacceptable timezone" in str(got.value)
    assert pdevice.timezone() is None
    zone("Asia/Kolkata")
    assert pdevice.timezone() == "Asia/Kolkata"


# America/New_York's 2021 transitions: 02:00-03:00 on Mar 14 does not
# exist, 01:00-02:00 on Nov 7 happens twice
TZ_MINUTES = ["2021-03-14 01:59", "2021-03-14 02:00", "2021-03-14 02:30",
              "2021-03-14 03:00", "2021-11-07 00:59", "2021-11-07 01:00",
              "2021-11-07 01:30", "2021-11-07 02:00", "2021-07-04 12:00",
              "NA", "1950-06-01 08:15", "2038-01-19 03:14"]
TZ_SECONDS = ["2022-03-27T01:30:00", "2022-10-30T01:30:00",
              "2019-01-01T00:00:00", "2021-03-14T02:59:59",
              "2000-02-29T23:59:59", "2024-12-31T23:59:58",
              "2021-11-07T01:59:59", "2021-11-07T02:00:00",
              "2010-05-05T05:05:05", "2012-12-12T12:12:12",
              "1999-12-31T19:00:00", "2021-10-03T02:15:00"]
TZ_DATES = ["2021-03-14", "2021-11-07", "2021-10-03", "1970-01-01",
            "2011-03-27", "2022-10-30", "2020-02-29", "2021-01-01",
            "1999-04-04", "2001-09-09", "NA", "2030-06-30"]
ZONES = ["America/New_York", "Europe/London", "Australia/Lord_Howe",
         "Asia/Kolkata", "America/Santiago", "UTC"]


def _zoneinfo_ms(text, tz):
    """Row by row with ``zoneinfo``: NaN where the wall time is skipped
    or repeated."""
    out = []
    for s in text:
        if s == "NA":
            out.append(np.nan)
            continue
        wall = dt.datetime.fromisoformat(s)
        a, b = (wall.replace(tzinfo=zoneinfo.ZoneInfo(tz), fold=f)
                for f in (0, 1))
        out.append(np.nan if a.utcoffset() != b.utcoffset() else
                   a.timestamp() * 1000.0)
    return np.array(out)


@pytest.mark.parametrize("tz", ZONES)
def test_csv_times_in_zone(cl, tmp_path, zone, tz):
    p = tmp_path / "t.csv"
    p.write_text("m,s,d,n\n" + "".join(
        f"{a},{b},{c},{i}\n" for i, (a, b, c) in
        enumerate(zip(TZ_MINUTES, TZ_SECONDS, TZ_DATES))))
    zone(tz)
    jf = jp.parse_files([str(p)])
    pf = pp.parse_files([str(p)])
    _assert_frame_equal(jf, pf)
    for col, text in (("m", TZ_MINUTES), ("s", TZ_SECONDS),
                      ("d", TZ_DATES)):
        np.testing.assert_array_equal(pf.vec(col).host_f64,
                                      _zoneinfo_ms(text, tz), err_msg=col)
    if tz == "America/New_York":
        assert np.isnan(pf.vec("m").host_f64[[1, 2, 5, 6, 9]]).all()
        assert not np.isnan(pf.vec("m").host_f64[[0, 3, 4, 7]]).any()


@pytest.mark.parametrize("tz", ZONES[:3])
def test_apply_cluster_tz_against_reference(cl, zone, tz):
    """The zone applied to the same naive strings: the port's
    milliseconds against the reference's ``_apply_cluster_tz`` on pandas
    datetimes."""
    zone(tz)
    for text in (TZ_MINUTES, TZ_SECONDS, TZ_DATES):
        naive = np.array([np.nan if s == "NA" else
                          np.datetime64(s, "ms").astype(np.int64)
                          for s in text], np.float64)
        dt_ = jp._apply_cluster_tz(pd.to_datetime(
            pd.Series([None if s == "NA" else s for s in text])))
        ms = dt_.to_numpy().astype("datetime64[ms]").astype("int64")
        want = np.where(pd.isna(dt_).to_numpy(), np.nan,
                        ms.astype(np.float64))
        np.testing.assert_array_equal(pp._apply_cluster_tz(naive), want)


def test_arff_dates_in_zone(cl, tmp_path, zone):
    p = tmp_path / "z.arff"
    p.write_text("@relation z\n@attribute t date 'yyyy-MM-dd HH:mm'\n"
                 "@attribute x numeric\n@data\n" + "".join(
                     f"'{s}',{i}\n" for i, s in enumerate(TZ_MINUTES)
                     if s != "NA"))
    zone("America/New_York")
    jf = jp.parse_files([str(p)])
    pf = pp.parse_files([str(p)])
    _assert_frame_equal(jf, pf)
    assert np.isnan(pf.vec("t").host_f64).sum() == 4


def test_no_zone_and_utc_change_nothing(tmp_path, zone):
    p = tmp_path / "u.csv"
    p.write_text("m,n\n" + "".join(f"{s},{i}\n"
                                   for i, s in enumerate(TZ_MINUTES)))
    base = pp.parse_files([str(p)]).vec("m").host_f64
    want = np.array([np.nan if s == "NA" else np.datetime64(s, "ms").astype(
        np.int64) for s in TZ_MINUTES], np.float64)
    np.testing.assert_array_equal(base, want)
    zone("UTC")
    np.testing.assert_array_equal(pp.parse_files([str(p)]).vec(
        "m").host_f64, base)
