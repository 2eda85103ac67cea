"""``h2o_tpu_torch.rapids`` against ``h2o_tpu.rapids``: the parser, the
session, elementwise ops, reductions and row and column selection.

The same seeded frames (300 rows with NaNs, categorical NAs, +-0,
negatives, a time column and a string column) are published under one
key in both packages' DKVs, and the same expressions go through the
reference's ``rapids_exec`` on the test mesh and the port's with
``device="cpu"``.

Held bitwise (NaN where NaN; zeros by sign): names, types, domains,
codes, every arithmetic, comparison and rounding op, ``exp``, ``log``
and ``log1p`` (XLA's CPU polynomials, ``ops/xlamath.py``), ``sign``,
min, max, median, quantiles, the row-wise (axis 1) reductions and
every selection.  Within a stated bound:

- the other transcendental ops and ``^``, which PyTorch computes with
  its own libm: ``ULP`` units in the last place, the largest distance
  measured over 100,000 uniform draws in [-5, 5] on the CPU, plus one;
- mean and sum over rollups: bitwise on values of a 1/8 grid (the sum
  is exact in any order), else within ``ROLLUP_RTOL`` of the mean or
  sum of |x|; sd and var ``ROLLUP_RTOL`` relative (numpy's float32 sum
  and dot against XLA's sharded sums);
- cumsum and cumprod: bitwise ``jnp.cumsum`` / ``jnp.cumprod`` of the
  same column on one device (XLA's blocked scan), and within
  ``SCAN_RTOL`` of the prefix sum of |x| (or of the product) from the
  reference's rapids_exec, whose 8-device mesh splits the scan over
  its shards.
"""

import numpy as np
import pytest
import torch

from h2o_tpu_torch.core.diag import TransferStats
from h2o_tpu_torch.core.frame import T_CAT, T_NUM, T_STR, T_TIME
from h2o_tpu_torch.core.frame import Frame as TFrame
from h2o_tpu_torch.core.frame import Vec as TVec
from h2o_tpu_torch.core.store import dkv, unpublish_on_exit
from h2o_tpu_torch.rapids import interp as ti

N = 300
# units in the last place, per op: the largest measured over 100,000
# uniform draws in [-5, 5] (asin and acos partly in [-1, 1]) plus one
ULP = {"^": 2, "sqrt": 2, "sin": 2, "cos": 2, "tan": 2, "sinh": 7,
       "cosh": 2, "tanh": 6, "asin": 3, "acos": 3, "atan": 2, "log10": 3,
       "log2": 3}
ROLLUP_RTOL = 1e-6
SCAN_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


# ------------------------------------------------------------------ frames


def pair(cols):
    """(reference frame, port frame) from ``{name: (type, values,
    domain)}``."""
    from h2o_tpu.core.frame import Frame, Vec
    ref, port = [], []
    for _name, (t, vals, dom) in cols.items():
        if t == T_STR:
            ref.append(Vec(list(vals), t))
            port.append(TVec(list(vals), t))
        elif t == T_CAT:
            codes = np.asarray(vals, np.int32)
            ref.append(Vec(codes, t, domain=list(dom)))
            port.append(TVec(codes, t, domain=list(dom)))
        elif t == T_TIME:
            ms = np.asarray(vals, np.float64)
            ref.append(Vec(ms, t))
            port.append(TVec(ms, t))
        else:
            x = np.asarray(vals, np.float32)
            ref.append(Vec(x))
            port.append(TVec(x))
    names = list(cols)
    return Frame(names, ref), TFrame(names, port)


def publish(key, ref, port):
    """Put the two frames under ``key`` in the two DKVs."""
    from h2o_tpu.core.cloud import cloud
    ref.key = key
    port.key = key
    cloud().dkv.put(key, ref)
    dkv().put(key, port)


def unpublish_ref(*keys):
    from h2o_tpu.core.cloud import cloud
    for k in keys:
        cloud().dkv.remove(k)


def mixed_cols(seed=7, n=N):
    """Numeric with NaN, +-0, halves and negatives; a divisor column with
    zeros; a 1/8 grid; integer keys; a 4-level categorical with NA codes;
    epoch milliseconds with NaN; strings with None."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-5, 5, n).astype(np.float32)
    x[:12] = [0.0, -0.0, 0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 1.0, -1.0, 0.25,
              -3.0]
    x[rng.uniform(size=n) < 0.1] = np.nan
    y = rng.uniform(-3, 3, n).astype(np.float32)
    y[rng.uniform(size=n) < 0.08] = 0.0
    y[rng.uniform(size=n) < 0.05] = -0.0
    y[rng.uniform(size=n) < 0.1] = np.nan
    g = (rng.integers(-32, 33, n) / 8).astype(np.float32)
    g[rng.uniform(size=n) < 0.1] = np.nan
    k = rng.integers(0, 10, n).astype(np.float32)
    k[rng.uniform(size=n) < 0.05] = np.nan
    c = rng.integers(-1, 4, n)
    t = np.round(rng.uniform(1.58e12, 1.72e12, n))
    t[rng.uniform(size=n) < 0.1] = np.nan
    s = [None if u < 0.1 else ["a", "b", "cc"][int(u * 30) % 3]
         for u in rng.uniform(size=n)]
    return {"x": (T_NUM, x, None), "y": (T_NUM, y, None),
            "g": (T_NUM, g, None), "k": (T_NUM, k, None),
            "c": (T_CAT, c, ["lo", "mid", "hi", "top"]),
            "t": (T_TIME, t, None), "s": (T_STR, s, None)}


# the device-eligible columns of mixed_cols (numeric and categorical)
NUMERIC = ("x", "y", "g", "k", "c")


@pytest.fixture()
def frames(cl):
    """``rx`` (every column type) and ``rn`` (numeric and categorical
    only) in both DKVs."""
    cols = mixed_cols()
    publish("rx", *pair(cols))
    publish("rn", *pair({n: cols[n] for n in NUMERIC}))
    yield
    unpublish_ref("rx", "rn")


def both(expr, **kw):
    """The reference's answer and the port's on the CPU."""
    from h2o_tpu.rapids.interp import Session, rapids_exec
    ref = rapids_exec(expr, Session("_ref"))
    port = ti.rapids_exec(expr, ti.Session("_port"), device="cpu", **kw)
    return ref, port


# ------------------------------------------------------------- comparisons


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Units in the last place between two float32 arrays (NaNs and
    equal infinities 0)."""
    def ordered(v):
        i = v.astype(np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    both_nan = np.isnan(a) & np.isnan(b)
    d = np.abs(ordered(a) - ordered(b))
    return np.where(both_nan | (a == b), 0, d)


def same_values(p, r, ulp=0, rtol=None, what="", zero_sign=True):
    """Two host columns equal: objects by value, floats bitwise (NaN
    where NaN, the sign of zero unless ``zero_sign`` is False), or
    within ``ulp`` / ``rtol``."""
    p, r = np.asarray(p), np.asarray(r)
    assert p.shape == r.shape, (what, p.shape, r.shape)
    if p.dtype == object or r.dtype == object:
        assert list(p) == list(r), what
        return
    pf, rf = p.astype(np.float64), r.astype(np.float64)
    assert np.array_equal(np.isnan(pf), np.isnan(rf)), what
    ok = ~np.isnan(rf)
    if rtol is not None:
        assert np.allclose(pf[ok], rf[ok], rtol=rtol, atol=0), \
            (what, pf[ok], rf[ok])
        return
    if ulp:
        assert p.dtype == np.float32 and r.dtype == np.float32, what
        worst = int(_ulps(p, r).max()) if p.size else 0
        assert worst <= ulp, (what, worst)
        return
    assert np.array_equal(pf[ok], rf[ok]), (what, pf[ok][pf[ok] != rf[ok]],
                                            rf[ok][pf[ok] != rf[ok]])
    if zero_sign:
        assert np.array_equal(np.signbit(pf[ok]), np.signbit(rf[ok])), what


def same(port, ref, ulp=0, rtol=None, zero_sign=True):
    """A port answer equals the reference's: frames by names, types,
    domains and columns; lists entry by entry; numbers as floats.  The
    reference's device verbs gather rows through mesh collectives that
    add the other shards' zeros, so a -0.0 they move comes back +0.0:
    their answers are compared with ``zero_sign=False``."""
    from h2o_tpu.core.frame import Frame
    if isinstance(ref, Frame):
        assert isinstance(port, TFrame)
        assert port.names == ref.names
        assert port.nrows == ref.nrows, (port.nrows, ref.nrows)
        for n, vp, vr in zip(port.names, port.vecs, ref.vecs):
            assert vp.type == vr.type, n
            assert (vp.domain or None) == (vr.domain or None), n
            if vp.is_categorical:
                assert vp.to_numpy().dtype == np.int32, n
            same_values(vp.to_numpy(), vr.to_numpy(), ulp, rtol, n,
                        zero_sign)
        return
    if isinstance(ref, list):
        assert isinstance(port, list) and len(port) == len(ref)
        for a, b in zip(port, ref):
            same(a, b, ulp, rtol, zero_sign)
        return
    if isinstance(ref, tuple):
        assert port == ref
        return
    same_values(np.float64(port), np.float64(ref), 0, rtol,
                zero_sign=zero_sign)


# ------------------------------------------------------------------ parser

EXPRESSIONS = [
    "(tmp= tmp_1 (mean (cols frame 'x')))",
    "(rows fr [0:5])",
    "(rows fr [2:3:4])",
    "(cols fr [0, 1, 2])",
    "(cols fr ['a', \"b c\"])",
    "(GB fr [0] mean 1 'all' nrow 1 \"all\")",
    "(:= fr -1.5 [0] [-3 4.0 1e3])",
    "(sort fr [0 1] [1 0])",
    "(merge L R 1 0 [] [] 'auto')",
    "(ifelse (is.na (cols fr [0])) NA (cols fr [0]))",
    "(== (cols fr 'c') 'lo')",
    "(quantile (cols fr [0]) [0.1 0.5 0.99])",
    "(rows fr [-2:3])",
    "(apply fr 2 { x . (mean x) })",
]


@pytest.mark.parametrize("expr", EXPRESSIONS)
def test_parse_equal(expr):
    from h2o_tpu.rapids.interp import parse
    assert ti.parse(expr) == parse(expr)


NUMPY_REPRS = [
    "(cols fr np.str_('x'))",
    "(cols fr [np.str_('x'), np.str_(\"y\")])",
    "(rows fr np.int64(3))",
    "(+ np.float32(1.5) np.float64(np.float64(2)))",
    "(replaceall fr 'np.float64(0)' np.str_('z'))",
    "(== fr np.bool_(True))",
]


@pytest.mark.parametrize("expr", NUMPY_REPRS)
def test_numpy_reprs_stripped_alike(expr):
    from h2o_tpu.rapids.interp import _normalize_numpy_reprs
    assert ti._normalize_numpy_reprs(expr) == _normalize_numpy_reprs(expr)


def test_numlist_expansion():
    from h2o_tpu.rapids.interp import _expand_numlist
    for lst in ([1.0, 4.0, ("span", 2.0, 3.0, 1.0)],
                [("span", 0.0, 4.0, 2.0), ("str", "7")],
                [("span", -2.0, 3.0, 1.0)]):
        assert ti._expand_numlist(lst) == _expand_numlist(lst)


def test_numpy_selectors_select_alike(frames):
    for expr in ("(cols rx np.str_('y'))",
                 "(cols rx [np.str_('x'), np.str_('c')])",
                 "(rows rn np.int64(7))"):
        ref, port = both(expr)
        same(port, ref, zero_sign=False)


# ------------------------------------------------------------- elementwise

BINARY_FORMS = {
    "frame_frame": "({op} (cols rx [0]) (cols rx [1]))",
    "frame_scalar": "({op} (cols rx [0]) 1.5)",
    "scalar_frame": "({op} -2 (cols rx [1]))",
    "frame_zero": "({op} (cols rx [0]) 0)",
    "frame_neg_zero": "({op} (cols rx [1]) -0)",
    "broadcast": "({op} (cols rx [0 2 4]) (cols rx [1]))",
    "broadcast_left": "({op} (cols rx [3]) (cols rx [0 1]))",
    "same_frame": "({op} (cols rx [0 1]) (cols rx [0 1]))",
    "categorical": "({op} (cols rx [4]) (cols rx [2]))",
}


@pytest.mark.parametrize("form", sorted(BINARY_FORMS))
@pytest.mark.parametrize("op", sorted(ti._BINOPS))
def test_binary_op(frames, op, form):
    ref, port = both(BINARY_FORMS[form].format(op=op))
    same(port, ref, ulp=ULP.get(op, 0))


@pytest.mark.parametrize("op", sorted(ti._NP_BINOPS))
def test_binary_op_on_time(frames, op):
    """A time column computes on its exact float64 copy; time +- number
    stays a time."""
    for expr in (f"({op} (cols rx [5]) 60000)",
                 f"({op} (cols rx [5]) (cols rx [5]))",
                 f"({op} (cols rx [0 5]) (cols rx [5]))"):
        ref, port = both(expr)
        same(port, ref)


def test_binary_op_on_two_numbers():
    """Arithmetic on two numbers is a float32 scalar in both; the
    reference's comparisons of two numbers raise, the port's give a
    float."""
    from h2o_tpu.rapids.interp import rapids_exec
    for expr in ("(+ 1.5 2.25)", "(/ 1 3)", "(- -0 0)", "(^ 2 0.5)",
                 "(% -7 3)", "(intDiv -7 2)"):
        same(ti.rapids_exec(expr, device="cpu"), rapids_exec(expr),
             ulp=ULP.get(expr[1], 0))
    assert ti.rapids_exec("(< 1 2)", device="cpu") == 1.0
    assert ti.rapids_exec("(& 1 0)", device="cpu") == 0.0
    with pytest.raises(AttributeError):
        rapids_exec("(< 1 2)")


@pytest.mark.parametrize("op", sorted(ti._UNOPS))
def test_unary_op(frames, op):
    for expr in (f"({op} (cols rx [0 1 2]))", f"({op} (cols rx [4]))",
                 f"({op} (cols rx [5]))"):
        ref, port = both(expr)
        same(port, ref, ulp=ULP.get(op, 0))


def test_sign_keeps_nan_and_signed_zero(cl):
    ref, port = pair({"z": (T_NUM, [np.nan, -0.0, 0.0, -2.0, 3.0], None)})
    publish("rz", ref, port)
    try:
        ref, port = both("(sign rz)")
    finally:
        unpublish_ref("rz")
    same(port, ref)
    got = port.vecs[0].data
    assert np.isnan(got[0]) and got[1] == 0 and np.signbit(got[1])
    assert list(got[2:]) == [0.0, -1.0, 1.0] and not np.signbit(got[2])


def test_string_compare(frames):
    for expr in ("(== (cols rx [4]) 'mid')", "(!= (cols rx [4]) 'nope')",
                 "(== (cols rx [6]) 'cc')", "(!= 'a' (cols rx [6]))",
                 "(== (cols rx [4 6]) 'b')", "(== (cols rx [6]) 1)"):
        ref, port = both(expr)
        same(port, ref)


def test_elementwise_moves_each_operand_once(frames):
    TransferStats.reset()
    ti.rapids_exec("(log1p (abs (* (cols rn [0 2]) 2)))", device="cpu")
    moved = TransferStats.snapshot()
    assert moved == {"to_device": 3 * N * 2 * 4, "to_host": 3 * N * 2 * 4}
    TransferStats.reset()
    ti.rapids_exec("(* rn rn)", device="cpu")
    assert TransferStats.snapshot() == {"to_device": N * 5 * 4,
                                        "to_host": N * 5 * 4}


def test_nested_expression(frames):
    ref, port = both("(ifelse (is.na (cols rx [0])) -1 "
                     "(log1p (abs (* (cols rx [0]) 2))))")
    same(port, ref)


# -------------------------------------------------------------- reductions

REDUCERS = ("mean", "sum", "min", "max", "sd", "var", "median")


def rollup_close(port, ref, op, cols):
    """mean within ROLLUP_RTOL of the column's mean |x|, sum of its sum
    |x| (a sum that cancels keeps no relative precision in any order),
    sd and var within ROLLUP_RTOL relative; one value a column of
    ``cols`` (host arrays), in the order of the answers."""
    p = np.atleast_1d(np.asarray(port, np.float64))
    r = np.atleast_1d(np.asarray(ref, np.float64))
    assert p.shape == r.shape == (len(cols),)
    for a, b, x in zip(p, r, cols):
        x = np.abs(x[~np.isnan(x)].astype(np.float64))
        if op in ("mean", "sum"):
            tol = ROLLUP_RTOL * (x.mean() if op == "mean" else x.sum())
        else:
            tol = ROLLUP_RTOL * abs(b)
        assert np.isnan(a) == np.isnan(b) and \
            (np.isnan(b) or abs(a - b) <= tol), (op, a, b, tol)


def _floats(expr):
    """The port frame's columns of ``expr`` as float32 with NaN NAs."""
    return [v.as_float() for v in
            ti.rapids_exec(expr, device="cpu").vecs]


@pytest.mark.parametrize("na", ["", "NA"])
@pytest.mark.parametrize("op", REDUCERS)
def test_reduction(frames, op, na):
    name = op + na
    exact = op in ("min", "max", "median")
    # a 1/8 grid: exact sums, so mean and sum are bitwise too
    ref, port = both(f"({name} (cols rx [2]))")
    if op in ("sd", "var"):
        rollup_close(port, ref, op, _floats("(cols rx [2])"))
    else:
        same(port, ref)
    ref, port = both(f"({name} (cols rx [0 1 3 4]))")
    if exact:
        same(port, ref)
    else:
        rollup_close(port, ref, op, _floats("(cols rx [0 1 3 4])"))


@pytest.mark.parametrize("op", REDUCERS)
def test_reduction_axis_forms(frames, op):
    exact = op in ("min", "max", "median")
    cols = _floats("(cols rx [0 1 2 3 4 5])")
    for na_rm in (1, 0):
        ref, port = both(f"({op} (cols rx [0 1 2 3 4 5]) {na_rm} 0)")
        assert port.names == ref.names and port.nrows == ref.nrows == 1
        if exact:
            same(port, ref)
        else:
            rollup_close([v.data[0] for v in port.vecs],
                         [v.to_numpy()[0] for v in ref.vecs], op, cols)
    for na_rm in ("True", "False"):
        ref, port = both(f"({op} (cols rx [0 1 2 3 4 5]) {na_rm} 1)")
        same(port, ref)


def test_quantile(frames):
    ref, port = both("(quantile (cols rx [0 1 2 3]) [0.01 0.1 0.5 0.9 1])")
    same(port, ref)


def test_counts_and_flags(frames):
    for expr in ("(nrow rx)", "(ncol rx)", "(naCnt rx)", "(is.factor rx)",
                 "(anyfactor rx)", "(anyfactor (cols rx [0]))",
                 "(is.numeric rx)", "(colnames rx)"):
        ref, port = both(expr)
        same(port, ref)


# ------------------------------------------------------ selection and shape

SELECTIONS = [
    "(cols rx [0 2])", "(cols rx 'y')", "(cols rx ['c', 'x'])",
    "(cols rx [1:3])", "(cols_py rx 4)",
    "(rows rx (> (cols rx [0]) 0))", "(rows rn (> (cols rn [0]) 0))",
    "(rows rn (cols rn [2]))", "(rows rx [0 5 7 299 5])",
    "(rows rn [0 5 7 299 5])", "(rows rn [10:20])", "(rows rx [10:5:3])",
    "(rows rn 3)", "(rows rx [-1 3])", "(rows rn [-1 -300])",
    "(na.omit rn)", "(na.omit rx)", "(na.omit (cols rx [5 6]))",
    "(which (> (cols rx [0]) 1))", "(cbind (cols rx [0]) (cols rx [4 5]))",
    "(rbind (cols rx [0 4 5 6]) (cols rx [0 4 5 6]))",
    "(append (cols rx [0 1]) (cols rx [4]) 'c2')",
]


@pytest.mark.parametrize("expr", SELECTIONS)
def test_selection(frames, expr):
    ref, port = both(expr)
    same(port, ref, zero_sign=False)


def test_rows_with_a_range(frames):
    ref, port = both("(rows rn (: 3 9))")
    same(port, ref, zero_sign=False)


@pytest.mark.parametrize("expr", [
    "(ifelse (is.na (cols rx [0])) -1 (cols rx [0]))",
    "(ifelse (> (cols rx [0]) 0) (cols rx [1]) (cols rx [2]))",
    "(ifelse (cols rx [4]) 1 0)",
    "(ifelse (cols rx [1]) (cols rx [1]) NA)",
    "(ifelse (< (cols rx [2]) 0) -0 (cols rx [4]))",
])
def test_ifelse(frames, expr):
    ref, port = both(expr)
    same(port, ref)


def test_factor_conversions(frames):
    for expr in ("(asfactor (cols rx [0]))", "(as.factor (cols rx [3 4]))",
                 "(asfactor (* (cols rx [2]) 0.1))",
                 "(asnumeric (cols rx [4]))", "(as.numeric (cols rx [0]))",
                 "(levels (cols rx [4]))", "(levels (cols rx [0 4]))",
                 "(unique (cols rx [3]))", "(unique (cols rx [4]))"):
        ref, port = both(expr)
        same(port, ref)
    # a categorical whose labels read as numbers converts by value
    codes = np.array([0, 1, -1, 2, 1], np.int32)
    dom = ["1", "2.5", "-3"]
    ref, port = pair({"f": (T_CAT, codes, dom)})
    publish("rf", ref, port)
    try:
        ref, port = both("(asnumeric rf)")
        same(port, ref)
    finally:
        unpublish_ref("rf")


@pytest.mark.parametrize("op", ["cummin", "cummax"])
def test_cumulative_min_max(frames, op):
    ref, port = both(f"({op} (cols rx [0 1 4]))")
    same(port, ref)


@pytest.mark.parametrize("op", ["cumsum", "cumprod"])
def test_cumulative_sum_product(frames, op):
    """XLA's one-device scan order bitwise; the reference's sharded
    scan within SCAN_RTOL."""
    import jax
    import jax.numpy as jnp
    expr = f"({op} (cols rx [0 2 4]))"
    if op == "cumprod":
        expr = f"({op} (+ (* (cols rx [0 2 4]) 0.02) 1))"
    ref, port = both(expr)
    assert port.names == ref.names
    inner = ti.rapids_exec(expr[len(op) + 2:-1], device="cpu")
    fn = jax.jit(jnp.cumsum if op == "cumsum" else jnp.cumprod)
    ident = 0.0 if op == "cumsum" else 1.0
    for vp, vr, vi in zip(port.vecs, ref.vecs, inner.vecs):
        x = vi.as_float()
        x = np.where(np.isnan(x), np.float32(ident), x)
        same_values(vp.data, np.asarray(fn(x)))
        if op == "cumsum":
            scale = np.cumsum(np.abs(x.astype(np.float64)))
        else:
            scale = np.abs(np.cumprod(x.astype(np.float64)))
        err = np.abs(vp.data.astype(np.float64) - vr.to_numpy())
        assert (err <= SCAN_RTOL * scale).all()


def test_colnames_assign(frames):
    from h2o_tpu.core.cloud import cloud
    ref, port = both("(colnames= (cols rx [0 1]) [0 1] ['p' 'q'])")
    same(port, ref)
    ref, port = both("(assign rcopy (cols rx [0 4]))")
    same(port, ref)
    assert dkv().get("rcopy") is port and port.key == "rcopy"
    assert cloud().dkv.get("rcopy") is ref
    unpublish_ref("rcopy")


# ------------------------------------------------------------- the session


def test_tmp_and_rm_publish_and_remove(frames):
    from h2o_tpu.core.cloud import cloud
    from h2o_tpu.rapids.interp import Session, rapids_exec
    rs, ps = Session("_r"), ti.Session("_p", device="cpu")
    ref = rapids_exec("(tmp= t1 (* (cols rx [0]) 2))", rs)
    port = ti.rapids_exec("(tmp= t1 (* (cols rx [0]) 2))", ps)
    same(port, ref)
    assert dkv().get("t1") is port and ps.temps["t1"] is port
    assert port.key == "t1"
    rollup_close(ti.rapids_exec("(sum (cols t1 [0]))", ps),
                 rapids_exec("(sum (cols t1 [0]))", rs), "sum",
                 [port.vecs[0].data])
    assert ti.rapids_exec("(rm t1)", ps) is None
    rapids_exec("(rm t1)", rs)
    assert "t1" not in dkv() and "t1" not in ps.temps
    assert cloud().dkv.get("t1") is None
    with pytest.raises(KeyError, match="unknown id 't1'"):
        ti.rapids_exec("(nrow t1)", ps)
    with pytest.raises(KeyError, match="unknown id 't1'"):
        rapids_exec("(nrow t1)", rs)


def test_session_device_and_the_card_by_default(frames, monkeypatch):
    """A session carries its device; with none named the card is asked
    for, and without CUDA that raises instead of using the CPU."""
    sess = ti.Session("_cpu", device="cpu")
    assert ti.rapids_exec("(nrow rn)", sess) == float(N)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ti.rapids_exec("(nrow rn)")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ti.rapids_exec("(nrow rn)", ti.Session("_card"))


def test_literals(frames):
    for expr in ("(+ TRUE 1)", "(* False 3)", "(is.na NA)"):
        try:
            from h2o_tpu.rapids.interp import rapids_exec
            ref = rapids_exec(expr)
        except Exception as e:  # noqa: BLE001 - the reference's own error
            with pytest.raises(type(e)):
                ti.rapids_exec(expr, device="cpu")
            continue
        same(ti.rapids_exec(expr, device="cpu"), ref)


# ----------------------------------------------------------------- refusals


#: the ops the port refused by name until ROADMAP P12c-ii-b ported them
P12C_II_B = (
    "not", "any.factor", "any.na", "match", "cor", "cut", "entropy",
    "columnsByType", "filterNACols", "ls", "getrow", "flatten", "rep_len",
    "t", "sumaxis", "setDomain", "appendLevels", "relevel.by.freq",
    "scale", "hist", "h2o.runif", "kfold_column", "modulo_kfold_column",
    "stratified_kfold_column", "which.max", "which.min", "topn",
    "h2o.fillna", "fillna", "skewness", "kurtosis", "dropdup", "distance",
    "melt", "pivot", "rank_within_groupby", "apply", "setLevel", "relevel",
    "difflag1", "prod", "prod.na", "any", "all")


@pytest.mark.parametrize("op", P12C_II_B)
def test_later_ops_raise_by_name(frames, op):
    """Each op the port refused by name until P12c-ii-b, called bare on a
    frame as ``(op rx)``, now gives the reference's answer or raises the
    reference's exception type (``ls`` lists each package's own DKV)."""
    from h2o_tpu.rapids.interp import Session, rapids_exec
    expr = f"({op} rx)"
    try:
        ref = rapids_exec(expr, Session("_ref"))
    except Exception as e:      # noqa: BLE001 - the port must match it
        with pytest.raises(type(e)):
            ti.rapids_exec(expr, device="cpu")
        return
    port = ti.rapids_exec(expr, device="cpu")
    if op == "ls":
        assert port.names == ref.names == ["key"]
        assert "rx" in port.vecs[0].domain and "rx" in ref.vecs[0].domain
        return
    same(port, ref)


def test_op_names():
    """The port dispatches every op the reference names (its source scan
    also picks up a regex fragment, which is no op)."""
    from h2o_tpu.rapids.interp import op_names
    assert not hasattr(ti, "_LATER")
    ref = {n for n in op_names() if not n.startswith("(")}
    assert set(ti.op_names()) == ref, sorted(set(ti.op_names()) ^ ref)


def test_unknown_op_raises(frames):
    with pytest.raises(NotImplementedError, match="'nosuchop'"):
        ti.rapids_exec("(nosuchop rx)", device="cpu")
    with pytest.raises(TypeError, match="expected frame, got number"):
        ti.rapids_exec("(abs 3)", device="cpu")
    with pytest.raises(ValueError, match="frame row mismatch"):
        ti.rapids_exec("(+ (cols rn [0]) (rows rn [0 1]))", device="cpu")


def test_take_keeps_negative_zero(cl):
    """The port's device take gathers rows as they are; the reference's
    mesh collective adds the other shards' zeros, so its -0.0 comes back
    0.0 (why munge answers are compared without the sign of zero)."""
    ref, port = pair({"z": (T_NUM, [-0.0, 1.0, -0.0], None)})
    publish("rz0", ref, port)
    try:
        ref, port = both("(rows rz0 [0 2])")
    finally:
        unpublish_ref("rz0")
    assert np.signbit(port.vecs[0].data).all()
    assert not np.signbit(ref.vecs[0].to_numpy()).any()
    same(port, ref, zero_sign=False)


@pytest.mark.parametrize("n", [1, 16, 17, 300, 5000])
def test_xlamath_cumprod_order(n):
    """``xlamath.cumprod`` is ``jnp.cumprod``'s blocked scan on the CPU,
    bit for bit."""
    import jax
    import jax.numpy as jnp
    from h2o_tpu_torch.ops import xlamath
    x = np.random.default_rng(n).uniform(0.97, 1.03, (3, n)).astype(
        np.float32)
    same_values(xlamath.cumprod(torch.from_numpy(x)).numpy(),
                np.asarray(jax.jit(lambda a: jnp.cumprod(a, axis=-1))(x)))


API_CASES = ["(mean (cols testfr 'a'))", "(tmp= t1 (* (cols testfr [0]) 2))",
             "(sum (cols t1 [0]))", "(rm t1)",
             "(tmp= t2 (rows testfr (> (cols testfr [0]) 89.5)))",
             "(rm t2)", "(tmp= t4 (asfactor (cols testfr [0])))", "(rm t4)",
             "(tmp= t5 (cbind (cols testfr [0]) (cols testfr [1])))",
             "(rm t5)", "(quantile (cols testfr [0]) [0.5])",
             "(tmp= t3 (ifelse (is.na (cols nafr [0])) -1 (cols nafr [0])))",
             "(rm t3)"]


def test_reference_api_cases(cl):
    """``tests/test_rapids_api.py``'s expressions in order, on its
    frames, in one session each."""
    from h2o_tpu.core.cloud import cloud
    from h2o_tpu.rapids.interp import Session, rapids_exec
    rng = np.random.default_rng(42)
    publish("testfr", *pair({
        "a": (T_NUM, np.arange(100, dtype=np.float32), None),
        "b": (T_NUM, rng.normal(size=100), None),
        "c": (T_CAT, [0, 1] * 50, ["x", "y"])}))
    publish("nafr", *pair({"x": (T_NUM, [1.0, np.nan, 3.0, np.nan],
                                 None)}))
    rs, ps = Session("_api_r"), ti.Session("_api_p", device="cpu")
    try:
        for expr in API_CASES:
            ref = rapids_exec(expr, rs)
            port = ti.rapids_exec(expr, ps)
            if expr.startswith("(rm"):
                assert ref is None and port is None
                assert expr[4:-1] not in dkv()
            elif expr.startswith("(sum"):
                assert port == float(2 * sum(range(100))) == ref
            else:
                same(port, ref, zero_sign=False)
    finally:
        unpublish_ref("testfr", "nafr")
        assert all(cloud().dkv.get(k) is None for k in
                   ("t1", "t2", "t3", "t4", "t5"))
