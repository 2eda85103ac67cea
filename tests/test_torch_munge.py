"""``h2o_tpu_torch.core.munge`` against ``h2o_tpu.core.munge``, verb for
verb.

The same seeded frames (the cases of ``tests/test_munge_device.py`` and
``tests/test_shard_munge.py``) go through the reference's verbs on the
test mesh and the port's with ``device="cpu"``.  The reference runs
each verb on both of its device routes: the default shard collectives
and the global kernels (``H2O_TPU_SHARD_MUNGE=0``) the port follows.

Held: names, types, domains, row order, codes and keys bitwise; group
counts, min, max, median and mode bitwise; every aggregate bitwise on
values on a 1/8 grid (sums exact in any order, and sd and var then
follow with XLA's fused ``m * m``); on random float32 values
sum and mean at rtol 1e-5, sd and var at atol 1e-5 times the group's
mean square (the reference's shard route sums per shard first, so its
two routes already differ there).  Then the refusals: a time column,
mixed key kinds, numeric ``mode``, an unknown aggregate, negative take
indices, and no device named without CUDA.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o_tpu_torch.core import munge as tm
from h2o_tpu_torch.core.diag import TransferStats
from h2o_tpu_torch.core.frame import T_CAT, T_TIME, Frame as TFrame
from h2o_tpu_torch.core.frame import Vec as TVec

ROUTES = ("shard", "global")


def _frames(cols):
    """(reference frame, port frame) from ``{name: (values, domain)}``
    (domain None for a numeric column)."""
    from h2o_tpu.core.frame import Frame, T_CAT as R_CAT, Vec
    names = list(cols)
    ref, port = [], []
    for n in names:
        vals, dom = cols[n]
        if dom is None:
            ref.append(Vec(vals.astype(np.float32)))
            port.append(TVec(vals.astype(np.float32)))
        else:
            ref.append(Vec(vals.astype(np.int32), R_CAT, domain=list(dom)))
            port.append(TVec(vals.astype(np.int32), T_CAT, domain=list(dom)))
    return Frame(names, ref), TFrame(names, port)


@pytest.fixture()
def route(request, monkeypatch):
    monkeypatch.setenv("H2O_TPU_SHARD_MUNGE",
                       "1" if request.param == "shard" else "0")
    return request.param


def _assert_same(port, ref, tol=None):
    """Names, types, domains and values equal; ``tol`` maps a column name
    to (rtol, atol) where values may differ by rounding."""
    assert port.names == ref.names
    assert port.nrows == ref.nrows
    for n in port.names:
        vp, vr = port.vec(n), ref.vec(n)
        assert vp.type == vr.type, n
        assert (vp.domain or None) == (vr.domain or None), n
        a = np.asarray(vp.to_numpy(), np.float64)
        b = np.asarray(vr.to_numpy(), np.float64)
        if vp.is_categorical:
            assert vp.to_numpy().dtype == np.int32, n
        if tol and n in tol:
            rtol, atol = tol[n]
            assert np.array_equal(np.isnan(a), np.isnan(b)), n
            ok = np.isnan(b) | (np.abs(a - b) <= atol + rtol * np.abs(b))
            assert ok.all(), (n, a[~ok], b[~ok])
        else:
            np.testing.assert_array_equal(a, b, err_msg=n)


# -------------------------------------------------------------------- sort


def _sortable(rng, n=203):
    k1 = rng.integers(0, 5, size=n).astype(np.float32)
    k1[rng.uniform(size=n) < 0.15] = np.nan           # NAs + heavy ties
    k2 = rng.normal(size=n).astype(np.float32)
    k2[rng.uniform(size=n) < 0.2] = rng.choice(
        np.array([-0.0, 0.0], np.float32))            # signed zeros tie
    cat = rng.integers(-1, 3, size=n)                 # -1 = NA code
    return _frames({"k1": (k1, None), "k2": (k2, None),
                    "c": (cat, ["a", "b", "c"]),
                    "pay": (np.arange(n), None)})


SORTS = [([0], [True]), ([0], [False]), ([0, 1], [True, False]),
         ([2, 0], [True, True]), ([2], [False]), ([1, 2], [False, True])]


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("keys", range(len(SORTS)))
def test_sort_bitwise(route, cl, keys):
    from h2o_tpu.core import munge
    ref, port = _sortable(np.random.default_rng(0))
    idxs, asc = SORTS[keys]
    _assert_same(tm.sort_frame(port, idxs, asc, device="cpu"),
                 munge.sort_frame(ref, idxs, asc))


# ------------------------------------------------------------------ filter


def _mask_ref(ref, mask):
    return jnp.asarray(np.pad(mask, (0, ref.padded_rows - ref.nrows)))


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("case", ["positive", "nan_drops", "none", "all"])
def test_filter_bitwise(route, cl, case):
    from h2o_tpu.core import munge
    rng = np.random.default_rng(1)
    x = rng.normal(size=157).astype(np.float32)
    x[rng.uniform(size=157) < 0.1] = np.nan
    ref, port = _frames({"x": (x, None), "i": (np.arange(157), None),
                         "c": (rng.integers(-1, 2, size=157), ["p", "q"])})
    mask = {"positive": x > 0, "nan_drops": (x <= 0).astype(np.float32),
            "none": x > 1e9, "all": np.ones(157, bool)}[case]
    if case == "nan_drops":
        mask[np.isnan(x)] = np.nan
    got = tm.filter_rows(port, mask, device="cpu")
    _assert_same(got, munge.filter_rows(ref, _mask_ref(ref, mask)))
    if case == "none":
        assert got.nrows == 0


# -------------------------------------------------------------------- take


@pytest.mark.parametrize("n_idx", [1, 40, 300])
def test_take_bitwise(cl, n_idx):
    from h2o_tpu.core import munge
    rng = np.random.default_rng(9)
    ref, port = _sortable(rng, n=130)
    idx = rng.integers(0, 130, size=n_idx)
    _assert_same(tm.take_rows(port, idx, device="cpu"),
                 munge.take_rows(ref, idx))


# ------------------------------------------------------------------- merge


def _merge_numeric():
    lk = np.array([1., 2., 2., np.nan, 5., -0.0], np.float32)
    rk = np.array([2., 2., 3., np.nan, 0.0, 7.], np.float32)
    L = _frames({"k": (lk, None), "x": (np.arange(6), None)})
    R = _frames({"k": (rk, None),
                 "y": (np.array([10., 20., 30., 40., 50., 60.]), None)})
    return L, R, [0], [0]


def _merge_categorical():
    # same labels, different code spaces; right-only label 'd'
    L = _frames({"k": (np.array([0, 1, 2, -1]), ["a", "b", "c"]),
                 "x": (np.array([1., 2., 3., 4.]), None)})
    R = _frames({"k": (np.array([0, 1, 2, -1, 0]), ["b", "c", "d"]),
                 "y": (np.array([20., 30., 40., 50., 60.]), None),
                 "c": (np.array([1, 0, 1, -1, 0]), ["u", "v"])})
    return L, R, [0], [0]


def _merge_multikey():
    rng = np.random.default_rng(3)
    n, m = 40, 25
    L = _frames({"a": (rng.integers(0, 4, size=n), None),
                 "b": (rng.integers(0, 3, size=n), ["p", "q", "r"]),
                 "x": (rng.normal(size=n), None)})
    R = _frames({"b": (rng.integers(-1, 3, size=m), ["r", "p", "q"]),
                 "a": (rng.integers(0, 5, size=m), None),
                 "x": (rng.normal(size=m), None)})   # clashes: x_y
    return L, R, [0, 1], [1, 0]


def _merge_dups():
    rng = np.random.default_rng(4)
    lk = rng.integers(0, 30, size=300).astype(np.float32)
    rk = rng.integers(10, 45, size=60).astype(np.float32)
    L = _frames({"k": (lk, None), "li": (np.arange(300), None)})
    R = _frames({"ri": (np.arange(60), None), "k": (rk, None)})
    return L, R, [0], [1]


MERGES = {"numeric": _merge_numeric, "categorical": _merge_categorical,
          "multikey": _merge_multikey, "duplicates": _merge_dups}
JOINS = {"inner": (False, False), "left": (True, False),
         "right": (False, True), "outer": (True, True)}


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("join", sorted(JOINS))
@pytest.mark.parametrize("case", sorted(MERGES))
def test_merge_bitwise(route, cl, case, join):
    from h2o_tpu.core import munge
    (rL, pL), (rR, pR), bx, by = MERGES[case]()
    ax, ay = JOINS[join]
    _assert_same(tm.merge_frames(pL, pR, ax, ay, bx, by, device="cpu"),
                 munge.merge_frames(rL, rR, ax, ay, bx, by))


# ----------------------------------------------------------------- groupby


def _gb(rng, n=311, grid=False):
    g = rng.integers(-1, 4, size=n)                     # -1 = NA group
    k = rng.integers(0, 3, size=n).astype(np.float32)
    k[rng.uniform(size=n) < 0.1] = np.nan               # numeric NA key
    x = (rng.integers(-80, 80, size=n) / 8.0 if grid else
         rng.normal(size=n) * 3 + 1).astype(np.float32)
    x[rng.uniform(size=n) < 0.2] = np.nan               # NA values
    m = rng.integers(-1, 4, size=n)
    m[g == 3] = -1                                      # an all-NA group
    return _frames({"g": (g, ["u", "v", "w", "z"]), "k": (k, None),
                    "x": (x, None), "m": (m, ["p", "q", "r", "s"])})


ALL_X = [(a, 2, "all") for a in ("mean", "sum", "min", "max", "sd", "var",
                                 "nrow", "count", "median")] + \
    [("mode", 3, "all")]


def _mean_square(port, gcols, col):
    """Each group's mean of the squared non-NA values of ``col``, in the
    verbs' group order (keys ascending, NA first)."""
    keys = []
    for j in gcols:
        v = port.vecs[j]
        d = v.as_float() if not v.is_categorical else \
            v.data.astype(np.float64)
        keys.append(np.where(np.isnan(d), -np.inf, d))
    _u, inv = np.unique(np.stack(keys, 1), axis=0, return_inverse=True)
    x = port.vecs[col].as_float().astype(np.float64)
    ok = ~np.isnan(x)
    inv = inv.reshape(-1)
    num = np.bincount(inv[ok], weights=x[ok] ** 2, minlength=inv.max() + 1)
    den = np.bincount(inv[ok], minlength=inv.max() + 1)
    return num / np.maximum(den, 1)


def _gb_tol(port, gcols, grid):
    """Every aggregate bitwise on 1/8-grid values (sums exact in any
    order; sd and var then bitwise too, with XLA's fused m*m); on random
    values sums at rtol 1e-5, sd and var at 1e-5 of the mean square."""
    if grid:
        return None
    tol = {f"{a}_x": (1e-5, 0) for a in ("sum", "mean")}
    ms = _mean_square(port, gcols, 2)
    tol.update({f"{a}_x": (0, 1e-5 * ms) for a in ("sd", "var")})
    return tol


GROUPBYS = {"cat_key_all_aggs": ([0], ALL_X),
            "numeric_na_key": ([1], [("mean", 2, "all"),
                                     ("nrow", 2, "all")]),
            "multikey": ([0, 1], [("sum", 2, "all"), ("count", 2, "all"),
                                  ("median", 2, "all")]),
            "median_mode": ([0], [("median", 2, "all"), ("mode", 3, "all"),
                                  ("nrow", 2, "all")])}


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("grid", [False, True], ids=["random", "grid8"])
@pytest.mark.parametrize("case", sorted(GROUPBYS))
def test_groupby(route, cl, case, grid):
    from h2o_tpu.core import munge
    ref, port = _gb(np.random.default_rng(2), grid=grid)
    gcols, aggs = GROUPBYS[case]
    got = tm.groupby_frame(port, gcols, aggs, device="cpu")
    _assert_same(got, munge.groupby_frame(ref, gcols, aggs),
                 tol=_gb_tol(port, gcols, grid))
    if case == "numeric_na_key":
        kcol = got.vec("k").to_numpy()
        assert np.isnan(kcol[0]) and not np.isnan(kcol[1:]).any()


def test_groupby_high_cardinality_key_and_mode(cl):
    from h2o_tpu.core import munge
    rng = np.random.default_rng(5)
    n, card = 2000, 1500
    key = rng.integers(0, 1200, size=n).astype(np.float32)
    m = np.where(rng.uniform(size=n) < 0.5, rng.integers(0, 8, size=n),
                 rng.integers(card - 8, card, size=n))
    m[rng.uniform(size=n) < 0.1] = -1
    x = (rng.integers(-40, 40, size=n) / 8.0).astype(np.float32)
    ref, port = _frames({"key": (key, None),
                         "m": (m, [f"v{i}" for i in range(card)]),
                         "x": (x, None)})
    aggs = [("mode", 1, "all"), ("nrow", 1, "all"), ("sum", 2, "all"),
            ("min", 2, "all"), ("max", 2, "all"), ("median", 2, "all")]
    got = tm.groupby_frame(port, [0], aggs, device="cpu")
    assert got.nrows > 900
    _assert_same(got, munge.groupby_frame(ref, [0], aggs))


def test_groupby_signed_zero_key_reports_first_row(cl):
    from h2o_tpu.core import munge
    k = np.array([-0.0, 0.0, 1.0, 0.0, -0.0], np.float32)
    ref, port = _frames({"k": (k, None), "x": (np.arange(5.0), None)})
    aggs = [("sum", 1, "all"), ("nrow", 1, "all")]
    got = tm.groupby_frame(port, [0], aggs, device="cpu")
    _assert_same(got, munge.groupby_frame(ref, [0], aggs))
    assert np.signbit(got.vec("k").to_numpy()[0])


# ----------------------------------------------------- transfers, refusals


def test_a_verb_moves_its_columns_once_each_way(cl):
    _ref, port = _sortable(np.random.default_rng(0), n=100)
    TransferStats.reset()
    out = tm.sort_frame(port, [1], [True], device="cpu")
    moved = TransferStats.snapshot()
    assert moved == {"to_device": 100 * 4 * 4, "to_host": 100 * 4 * 4}
    assert out.vec("c").to_numpy().dtype == np.int32


def _with_time():
    ms = np.arange(6, dtype=np.float64) * 86_400_000.0
    return TFrame(["t", "x", "c"],
                  [TVec(ms, T_TIME), TVec(np.arange(6.0)),
                   TVec(np.array([0, 1, 0, 1, 0, 1]), T_CAT,
                        domain=["a", "b"])])


@pytest.mark.parametrize("verb", ["sort", "filter", "take", "groupby",
                                  "merge"])
def test_time_column_is_refused_by_name(verb):
    fr = _with_time()
    calls = {"sort": lambda: tm.sort_frame(fr, [1], [True], device="cpu"),
             "filter": lambda: tm.filter_rows(fr, np.ones(6), device="cpu"),
             "take": lambda: tm.take_rows(fr, [0, 1], device="cpu"),
             "groupby": lambda: tm.groupby_frame(
                 fr, [2], [("sum", 1, "all")], device="cpu"),
             "merge": lambda: tm.merge_frames(fr, fr, False, False, [1],
                                              [1], device="cpu")}
    with pytest.raises(ValueError, match=r"t \(time\).*host route"):
        calls[verb]()


def test_refusals_name_their_reason():
    fr = _with_time().drop("t")
    with pytest.raises(ValueError, match="categorical key is paired with "
                       "a numeric one.*host route"):
        tm.merge_frames(fr, fr, False, False, [0], [1], device="cpu")
    assert not tm.merge_device_ok(fr, fr, [0], [1])
    assert tm.merge_device_ok(fr, fr, [1], [1])
    with pytest.raises(ValueError,
                       match="mode of a numeric column.*host route"):
        tm.groupby_frame(fr, [1], [("mode", 0, "all")], device="cpu")
    assert not tm.mode_device_eligible(fr, [("mode", 0, "all")])
    with pytest.raises(ValueError, match="no device aggregate 'cumsum'"):
        tm.groupby_frame(fr, [1], [("cumsum", 0, "all")], device="cpu")
    with pytest.raises(ValueError, match="negative row indices.*host route"):
        tm.take_rows(fr, [0, -1], device="cpu")
    with pytest.raises(IndexError):
        tm.take_rows(fr, [0, 6], device="cpu")


def test_no_device_named_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fr = _with_time().drop("t")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.sort_frame(fr, [0], [True])


def test_empty_frames_flow_through_every_verb():
    """Zero survivors of a filter chain into the other verbs (the
    reference's frames always hold padded rows, so this is held against
    the join's definition)."""
    L = TFrame(["k", "x"], [TVec(np.array([1., 2.], np.float32)),
                            TVec(np.array([5., 6.], np.float32))])
    R = TFrame(["k", "y"], [TVec(np.array([2., 3.], np.float32)),
                            TVec(np.array([7., 8.], np.float32))])
    E = tm.filter_rows(L, np.zeros(2), device="cpu")
    assert E.nrows == 0 and E.names == ["k", "x"]
    right = tm.merge_frames(E, R, False, True, [0], [0], device="cpu")
    np.testing.assert_array_equal(right.vec("k").to_numpy(), [2., 3.])
    assert np.isnan(right.vec("x").to_numpy()).all()
    left = tm.merge_frames(L, E.subframe(["k"]), True, False, [0], [0],
                           device="cpu")
    np.testing.assert_array_equal(left.vec("x").to_numpy(), [5., 6.])
    assert tm.merge_frames(E, E, True, True, [0], [0],
                           device="cpu").nrows == 0
    assert tm.sort_frame(E, [0], [True], device="cpu").nrows == 0
    g = tm.groupby_frame(E, [0], [("sum", 1, "all"),
                                  ("median", 1, "all")], device="cpu")
    assert g.nrows == 0 and g.names == ["k", "sum_x", "median_x"]
    assert tm.take_rows(L, [], device="cpu").nrows == 0
