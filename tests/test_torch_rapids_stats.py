"""``h2o_tpu_torch.rapids``' fold columns, draws, column statistics,
``scale``, ``not`` and ``apply`` against ``h2o_tpu.rapids`` (ROADMAP
P12c-ii-b).

The same seeded frames are published under one key in both packages'
DKVs, and the same expressions go through the reference's
``rapids_exec`` on the test mesh and the port's with ``device="cpu"``.
The cases are the wire forms h2o-py sends for these ops (those of
``tests/test_rapids_extended.py`` and ``test_rapids_round3.py`` among
them), then an edge frame: +-inf, +-1e30 and +-0 values; keys of 0, -0,
NaN and inf; an all-NaN column; a constant column; a one-row frame; and
an empty filter result.  Where the reference raises, the port raises the
same type with the same message up to its first quoted or numbered part.

Held bitwise (names, types, domains, codes and values; NaN where NaN;
zeros by sign): every op here but ``scale`` with rollup centres or
scales.  ``h2o.runif``, the fold columns and ``stratified_kfold_column``
draw from numpy's ``default_rng(seed)`` in the reference's order; a
seed below 0 draws from entropy in both packages, so there only shape,
range and type are held.

``scale``'s rollup forms read each column's rollup mean and sigma, and
the port's rollups are numpy's float32 sums where the reference's are
XLA's sharded ones.  They are held so: the port's answer is bitwise its
own numlist form fed its own rollups; its rollups are within
``ROLLUP_RTOL`` of the reference's (the mean of the mean |x|, sigma
relative: the bound ``test_torch_rapids_interp.py`` holds them to); and
each value is within the difference those two rollups make,
|dm| / s + |x - m| |1/s' - 1/s|, plus 2 units in the last place.  A
constant column whose float32 mean is inexact (0.1) has a sigma of
rounding noise, 7.5e-9 in the reference and 1.5e-8 in the port, so its
standardized values are that noise's ratio in both; the bound above
still holds them, since it is derived from the rollups the two packages
used.

Host ops move no byte to or from a device (``core.diag.TransferStats``);
``scale``, ``not`` and a device body under ``apply`` move their columns
once each way.
"""

import re

import numpy as np
import pytest

from h2o_tpu_torch.core.diag import TransferStats
from h2o_tpu_torch.core.frame import T_CAT, T_NUM, T_STR
from h2o_tpu_torch.core.store import dkv, unpublish_on_exit
from h2o_tpu_torch.rapids import interp as ti

from tests.test_torch_rapids_interp import (mixed_cols, pair, publish,
                                            rollup_close, same, same_values,
                                            unpublish_ref)

ROLLUP_RTOL = 1e-6
NAN, INF = np.nan, np.inf


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv


def edge_cols() -> dict:
    """The edge frame: ``v`` holds +-inf, +-1e30, +-0 and NaN among
    ordinary values, ``k`` keys of 0, -0, NaN and +-inf, ``allnan`` only
    NaN, ``const`` 2.5 everywhere, ``tenth`` 0.1 everywhere, ``c`` a
    3-level categorical with NA codes and ``g`` a 1/8 grid."""
    v = [INF, -INF, 1e30, -1e30, 0.0, -0.0, NAN, 1.5, -2.25, 3.0, 1e-30,
         -7.0, 0.5, 2.0, NAN, -0.0, 4.0, 1e30, 0.25, -1.0]
    k = [0.0, -0.0, NAN, INF, 0.0, -0.0, NAN, INF, 1.0, 1.0, -INF, 2.0,
         2.0, 0.0, NAN, 3.0, -0.0, INF, 1.0, 2.0]
    c = [0, 1, -1, 2, 1, 0, 0, -1, 2, 2, 1, 0, 1, 1, -1, 0, 2, 0, 1, 0]
    g = [-1.0, 0.125, 2.5, -0.375, NAN, 3.0, 0.0, -0.0, 1.25, 1.25, 0.5,
         -2.0, 0.75, NAN, 4.0, -1.5, 0.25, 2.0, -0.125, 1.0]
    n = len(v)
    return {"v": (T_NUM, v, None), "k": (T_NUM, k, None),
            "allnan": (T_NUM, [NAN] * n, None),
            "const": (T_NUM, [2.5] * n, None),
            "tenth": (T_NUM, [0.1] * n, None),
            "c": (T_CAT, c, ["a", "b", "c"]), "g": (T_NUM, g, None)}


def ext_cols() -> dict:
    """``tests/test_rapids_extended.py``'s frame: 120 rows of ``num``
    (normal, mean 2, sd 3), ``pos``, a 3-level ``grp`` and a 7-level
    ``txt``."""
    rng = np.random.default_rng(11)
    n = 120
    num = rng.normal(loc=2.0, scale=3.0, size=n)
    pos = np.abs(rng.normal(size=n) + 2)
    return {"num": (T_NUM, num, None), "pos": (T_NUM, pos, None),
            "grp": (T_CAT, [i % 3 for i in range(n)], ["a", "b", "c"]),
            "txt": (T_CAT, [i % 7 for i in range(n)],
                    [f"item_{i}" for i in range(7)])}


def strings_cols() -> dict:
    return {"s": (T_STR, ["aaaa", "abab", None, "", "hello world", "ß",
                          "abcabc", "a", "naïve café", "aaaa"], None),
            "f": (T_CAT, [0, 1, 2, -1, 0, 3, 2, 1, 0, 3],
                  ["xyz", "aab", "", "mississippi"])}


def grid_cols(seed: int = 5, n: int = 200) -> dict:
    """Values on a 1/8 grid with NaNs, so that sums are exact in any
    order (a rollup mean in ``apply`` is then bitwise)."""
    rng = np.random.default_rng(seed)
    out = {}
    for j in range(4):
        x = (rng.integers(-64, 65, n) / 8).astype(np.float32)
        x[rng.uniform(size=n) < 0.1] = NAN
        out[f"q{j}"] = (T_NUM, x, None)
    return out


FRAMES = {
    "sx": lambda: mixed_cols(),
    "sn": lambda: {k: v for k, v in mixed_cols().items()
                   if k in ("x", "y", "g", "k", "c")},
    "se": edge_cols,
    "s1": lambda: {k: (t, vals[7:8], dom)
                   for k, (t, vals, dom) in edge_cols().items()},
    "sext": ext_cols,
    "sstr": strings_cols,
    "sq": grid_cols,
}
#: frames each package derives from those through its own rapids_exec
#: (the row selections run the munge verbs, which move bytes, so the ops
#: read their results by key): an empty filter result, and sq's first 12
#: and 5 rows
DERIVED = {"sempty": "(rows se (> (cols se 'g') 1e38))",
           "sq12": "(rows sq [0:12])", "sq5": "(rows sq [0:5])"}
EMPTY = "sempty"


@pytest.fixture(scope="module")
def frames(cl):
    from h2o_tpu.rapids.interp import Session, rapids_exec
    for key, cols in FRAMES.items():
        publish(key, *pair(cols()))
    for key, expr in DERIVED.items():
        rapids_exec(f"(tmp= {key} {expr})", Session("_ref"))
        ti.rapids_exec(f"(tmp= {key} {expr})", device="cpu")
    assert dkv().get(EMPTY).nrows == 0
    yield
    unpublish_ref(*FRAMES, *DERIVED)
    for key in (*FRAMES, *DERIVED):
        dkv().remove(key, force=True)


# --------------------------------------------------------------- harness


def stem(msg: str) -> str:
    """An error message up to its first quoted or numbered part."""
    return re.split(r"['\"0-9<({\[]", str(msg))[0]


def check(expr: str, zero_sign: bool = True):
    """The reference's answer and the port's on the CPU held equal, or
    the same exception; returns (port answer or None, bytes moved by the
    port: {"to_device": n, "to_host": n})."""
    from h2o_tpu.rapids.interp import Session, rapids_exec
    try:
        ref = rapids_exec(expr, Session("_ref"))
    except Exception as e:      # noqa: BLE001 - the port must match it
        TransferStats.reset()
        with pytest.raises(type(e)) as got:
            ti.rapids_exec(expr, ti.Session("_port"), device="cpu")
        assert stem(got.value) == stem(e), (expr, str(got.value), str(e))
        return None, TransferStats.snapshot()
    TransferStats.reset()
    port = ti.rapids_exec(expr, ti.Session("_port"), device="cpu")
    moved = TransferStats.snapshot()
    if isinstance(ref, str):
        assert port == ref, expr
    else:
        same(port, ref, zero_sign=zero_sign)
    return port, moved


def host(expr: str, zero_sign: bool = True):
    """``check``, and the port moved nothing to or from a device."""
    port, moved = check(expr, zero_sign)
    assert moved == {"to_device": 0, "to_host": 0}, (expr, moved)
    return port


# --------------------------------------------------------- folds and draws

DRAWS = [
    "(h2o.runif sx 42)", "(h2o.runif se 0)", "(h2o.runif s1 7)",
    "(kfold_column sx 4 1)", "(kfold_column se 3 0)",
    "(kfold_column s1 5 9)", "(modulo_kfold_column sx 3)",
    "(modulo_kfold_column se 7)", "(modulo_kfold_column s1 2)",
    "(stratified_kfold_column (cols sx 'c') 3 2)",
    "(stratified_kfold_column (cols sx 'k') 4 7)",
    "(stratified_kfold_column (cols se 'k') 3 11)",
    "(stratified_kfold_column (cols se 'c') 2 3)",
    "(stratified_kfold_column (cols se 'allnan') 3 1)",
    "(stratified_kfold_column (cols sext 'grp') 3 2)",
    "(stratified_kfold_column (cols s1 'k') 3 1)",
    f"(h2o.runif {EMPTY} 1)", f"(kfold_column {EMPTY} 3 1)",
    f"(stratified_kfold_column (cols {EMPTY} 'c') 3 1)",
]


@pytest.mark.parametrize("expr", DRAWS)
def test_folds_and_draws(frames, expr):
    host(expr)


@pytest.mark.parametrize("expr", ["(h2o.runif sx -1)",
                                  "(kfold_column sx 4 -1)",
                                  "(stratified_kfold_column (cols sx 'c') "
                                  "3 -5)"])
def test_draws_from_entropy(frames, expr):
    """A seed below 0 seeds from entropy in both packages: the shape,
    range and type are held."""
    from h2o_tpu.rapids.interp import Session, rapids_exec
    ref = rapids_exec(expr, Session("_ref"))
    port = ti.rapids_exec(expr, device="cpu")
    assert port.names == ref.names and port.nrows == ref.nrows == 300
    got = port.vecs[0].to_numpy()
    assert got.dtype == ref.vecs[0].to_numpy().dtype == np.float32
    hi = 1.0 if "runif" in expr else (4 if "kfold" in expr else 3)
    assert ((got >= 0) & (got < hi)).all()
    if "runif" not in expr:
        assert (got == np.floor(got)).all()


def test_extended_fold_claims(frames):
    """test_rapids_extended's claims on its frame."""
    r = host("(h2o.runif sext 42)").vecs[0].to_numpy()
    assert ((r >= 0) & (r <= 1)).all()
    kf = host("(kfold_column sext 4 1)").vecs[0].to_numpy()
    assert set(np.unique(kf)) <= {0, 1, 2, 3}
    m = host("(modulo_kfold_column sext 3)").vecs[0].to_numpy()
    assert (m == np.arange(120) % 3).all()
    s = host("(stratified_kfold_column (cols sext 'grp') 3 2)")
    assert set(np.unique(s.vecs[0].to_numpy())) <= {0, 1, 2}


# ------------------------------------------------------- column statistics

STATS = [
    # hist: a count, the three rules, a list of breaks, the edge cases
    "(hist (cols sx 'x') 5)", "(hist (cols sx 'x') \"sturges\")",
    "(hist (cols sx 'y') \"rice\")", "(hist (cols sx 'g') \"sqrt\")",
    "(hist (cols sx 'x') [-5 -1 0 0.5 5])", "(hist (cols sext 'num') 5)",
    "(hist (cols se 'v') 4)", "(hist (cols se 'g') 3)",
    "(hist (cols se 'const') 3)", "(hist (cols se 'allnan') 3)",
    "(hist (cols s1 'g') 2)", "(hist (cols sx 't') 4)",
    f"(hist (cols {EMPTY} 'g') 3)",
    # which.max / which.min on both axes, with and without skipna
    "(which.max sn True 0)", "(which.max sn False 0)",
    "(which.min sn True 0)", "(which.min sn False 0)",
    "(which.max sn True 1)", "(which.max sn False 1)",
    "(which.min sn True 1)", "(which.min sn False 1)",
    "(which.max (cols sext ['num', 'pos']) True 0)",
    "(which.min (cols sext 'num') True 0)",
    "(which.max se True 0)", "(which.min se False 0)",
    "(which.max se True 1)", "(which.min se False 1)",
    "(which.max s1 True 0)", "(which.min s1 True 1)",
    f"(which.max {EMPTY} True 0)",
    # topn
    "(topn sx 0 10 1)", "(topn sx 0 10 -1)", "(topn sx 2 50 1)",
    "(topn sext 0 10 1)", "(topn se 0 30 1)", "(topn se 0 30 -1)",
    "(topn se 2 10 1)", "(topn se 3 100 -1)", "(topn s1 0 10 1)",
    f"(topn {EMPTY} 0 10 1)",
    # moments
    "(skewness (cols sx [0 1 2 3]) True)", "(kurtosis (cols sx [0 1 2 3]) "
    "True)", "(skewness (cols sext 'num') True)",
    "(kurtosis (cols sext 'num') True)", "(skewness se True)",
    "(kurtosis se True)", "(skewness s1 True)", "(kurtosis sn True)",
    f"(skewness {EMPTY} True)",
    # products, any, all
    "(prod (cols sx [2 3]))", "(prod.na (cols sx [2 3]))",
    "(prod (cols se 'g'))", "(prod.na (cols se 'g'))", "(prod.na se)",
    "(prod.na (cols se 'const'))", "(prod s1)", f"(prod.na {EMPTY})",
    "(any sn)", "(all sn)", "(any se)", "(all se)",
    "(any (cols se 'allnan'))", "(all (cols se 'allnan'))",
    "(all (cols se 'const'))", "(any s1)", f"(all {EMPTY})",
    # correlation
    "(cor (cols sx 'x') (cols sx 'y') \"everything\" \"Pearson\")",
    "(cor (cols sx 'x') (cols sx 'y') \"complete.obs\" \"Pearson\")",
    "(cor (cols sx 'x') (cols sx 'y') \"complete.obs\" \"Spearman\")",
    "(cor (cols sx [0 1 2]) (cols sx [2 3]) \"complete.obs\" \"Spearman\")",
    "(cor (cols sx [0 1 2]) (cols sx [2 3]) \"everything\" \"Pearson\")",
    "(cor (cols sx 'g') (cols sx 'k') \"na.or.complete\" \"spearman\")",
    "(cor (cols sext 'num') (cols sext 'pos') \"everything\" \"Pearson\")",
    "(cor (cols se 'g') (cols se 'k') \"complete.obs\" \"Spearman\")",
    "(cor (cols se 'v') (cols se 'g') \"complete.obs\" \"Pearson\")",
    "(cor (cols se 'const') (cols se 'g') \"complete.obs\" \"Pearson\")",
    "(cor (cols se 'c') (cols se 'k') \"everything\" \"Spearman\")",
    # sums over an axis
    "(sumaxis sn True 0)", "(sumaxis sn False 0)", "(sumaxis sn True 1)",
    "(sumaxis sn False 1)", "(sumaxis se True 0)", "(sumaxis se False 1)",
    "(sumaxis s1 True 1)", f"(sumaxis {EMPTY} True 0)",
    # entropy
    "(entropy sstr)", "(entropy (cols sstr 's'))", "(entropy (cols sstr 'f'))",
]


@pytest.mark.parametrize("expr", STATS)
def test_column_statistics(frames, expr):
    host(expr)


def test_round3_and_extended_statistics(frames):
    """test_rapids_round3's cor, sumaxis and entropy cases and
    test_rapids_extended's which, topN, skewness and hist claims, on
    their own frames."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=200).astype(np.float32)
    y = 2 * x + rng.normal(size=200).astype(np.float32) * 0.01
    keys = {"r3x": {"x": (T_NUM, x, None)}, "r3y": {"y": (T_NUM, y, None)},
            "r3e": {"s": (T_STR, ["aaaa", "abab", None], None)},
            "r3g": {"a": (T_NUM, [1, 2], None), "b": (T_NUM, [3, 4], None)}}
    for k, cols in keys.items():
        publish(k, *pair(cols))
    try:
        r = host('(cor r3x r3y "everything" "Pearson")')
        assert 0.99 < r <= 1.0
        ent = host("(entropy r3e)").vecs[0].to_numpy()
        assert ent[0] == 0.0 and ent[1] == 1.0 and np.isnan(ent[2])
        assert host("(sumaxis r3g True 0)") == [3.0, 7.0]
        assert list(host("(sumaxis r3g True 1)").vecs[0].to_numpy()) == \
            [4.0, 6.0]
    finally:
        unpublish_ref(*keys)
    num = dkv().get("sext").vec("num").to_numpy().astype(np.float64)
    wm = host("(which.max (cols sext ['num', 'pos']) True 0)")
    assert wm.nrows == 1 and wm.vecs[0].to_numpy()[0] == np.nanargmax(num)
    t = host("(topn sext 0 10 1)")
    assert np.array_equal(np.sort(t.vecs[1].to_numpy()),
                          np.sort(num.astype(np.float32))[-t.nrows:])
    h = host("(hist (cols sext 'num') 5)")
    assert np.nansum(h.vec("counts").to_numpy()) == 120
    m = num.mean()
    s2 = ((num - m) ** 2).sum() / (len(num) - 1)
    assert host("(skewness (cols sext 'num') True)") == \
        ((num - m) ** 3).mean() / s2 ** 1.5


def test_rank_average_ties():
    """Spearman's tie ranks are the mean of the tied positions, as the
    reference's loop averages them, on runs of ties, -0.0 against 0.0,
    +-inf and NaN."""
    from h2o_tpu.rapids.interp import _rank_avg
    rng = np.random.default_rng(4)
    cols = [np.asarray([3, 1, 2, 2, NAN, 2, -0.0, 0.0, INF, -INF, 1, 3]),
            rng.integers(0, 5, 500).astype(np.float64),
            np.full(7, NAN), np.zeros(0), rng.normal(size=50)]
    for c in cols:
        assert np.array_equal(ti._rank_avg(c), _rank_avg(c), equal_nan=True)


# -------------------------------------------------------------- device ops


def _scale_refs(key, cols):
    """(means, sigmas) of the named columns in each package."""
    from h2o_tpu.core.cloud import cloud
    ref, port = cloud().dkv.get(key), dkv().get(key)
    return ([(ref.vec(c).rollups.mean, ref.vec(c).rollups.sigma)
             for c in cols],
            [(port.vec(c).rollups.mean, port.vec(c).rollups.sigma)
             for c in cols])


SCALE_FRAMES = ["(cols sx [0 1 2 3 4 5])", "(cols sext ['num', 'pos'])",
                "(cols se ['v', 'k', 'allnan', 'const', 'tenth', 'c', 'g'])"]


@pytest.mark.parametrize("fr", SCALE_FRAMES)
@pytest.mark.parametrize("lists", ["[1.5 -2 0.1 0 3 7 -0.5] [2 0.5 3 0 1 "
                                   "0.1 4]", "[0 0 0 0 0 0 0] [1 1 1 1 1 1 1]",
                                   "False False", "[0.3 1e30 -1e-3 2.5 0.1 8 "
                                   "9] False", "False [3 0.7 1e-30 1 0.1 1 1]"])
def test_scale_numlist_form(frames, fr, lists):
    """Given centres and scales (and neither) the arithmetic is held
    bitwise; each numeric column is uploaded and downloaded once."""
    port, moved = check(f"(scale {fr} {lists})")
    n = sum(v.is_numeric for v in port.vecs)
    nbytes = 4 * port.nrows * n
    assert moved["to_host"] == nbytes and \
        moved["to_device"] >= nbytes, moved


@pytest.mark.parametrize("fr", SCALE_FRAMES)
@pytest.mark.parametrize("flags", ["True True", "True False", "False True",
                                   "1 1", "TRUE FALSE"])
def test_scale_rollup_form(frames, fr, flags):
    from h2o_tpu.rapids.interp import Session, rapids_exec
    ref = rapids_exec(f"(scale {fr} {flags})", Session("_ref"))
    port = ti.rapids_exec(f"(scale {fr} {flags})", device="cpu")
    src = ti.rapids_exec(fr, device="cpu")
    center, scale = (f not in ("False", "FALSE", "0")
                     for f in flags.split())
    num = [n for n, v in zip(src.names, src.vecs) if v.is_numeric]
    key = fr.split()[1]
    r_roll, p_roll = _scale_refs(key, num)
    # the port's own rollups, through its numlist form: bitwise
    cs = " ".join(repr(float(m)) for m, _ in p_roll)
    ss = " ".join(repr(float(s) or 1.0) for _, s in p_roll)
    own = ti.rapids_exec(
        f"(scale {fr} {f'[{cs}]' if center else 'False'} "
        f"{f'[{ss}]' if scale else 'False'})", device="cpu")
    same_port(port, own)
    assert port.names == ref.names
    for n, vr, vp in zip(port.names, ref.vecs, port.vecs):
        assert vp.type == vr.type and (vp.domain or None) == (vr.domain or
                                                              None)
        if vp.is_categorical:
            same_values(vp.to_numpy(), vr.to_numpy())
    for c, (m, s), (m2, s2) in zip(num, r_roll, p_roll):
        x = src.vec(c).as_float().astype(np.float64)
        ok = ~np.isnan(x)
        mean_abs = np.abs(x[ok]).mean() if ok.any() else 0.0
        # the rollups within the bound test_torch_rapids_interp holds
        # them to; a constant column's sigma is rounding noise, within two
        # units in the last place of its mean
        assert near(m2, m, ROLLUP_RTOL * mean_abs), (c, m, m2)
        assert near(s2, s, ROLLUP_RTOL * abs(s)) or \
            near(s2, s, 2 * np.spacing(np.float32(abs(m)))), (c, s, s2)
        # each value within what those differences make
        se, se2 = (s or 1.0) if scale else 1.0, (s2 or 1.0) if scale else 1.0
        dm = abs(m2 - m) if center else 0.0
        xm = np.abs(x - (m if center else 0.0))
        bound = dm / min(se, se2) + xm * abs(1 / se2 - 1 / se)
        a = np.asarray(port.vec(c).to_numpy(), np.float64)
        b = np.asarray(ref.vec(c).to_numpy(), np.float64)
        assert np.array_equal(np.isnan(a), np.isnan(b)), c
        fin = np.isfinite(b)
        assert np.array_equal(a[~fin & ~np.isnan(b)], b[~fin & ~np.isnan(b)])
        tol = bound[fin] + 2 * np.spacing(np.abs(b[fin]).astype(np.float32))
        assert (np.abs(a[fin] - b[fin]) <= tol).all(), \
            (c, np.abs(a[fin] - b[fin]).max())


def same_port(a, b):
    """Two port frames equal: names, types, domains, values bitwise."""
    assert a.names == b.names and a.nrows == b.nrows
    for n, va, vb in zip(a.names, a.vecs, b.vecs):
        assert va.type == vb.type and va.domain == vb.domain, n
        same_values(va.to_numpy(), vb.to_numpy(), what=n)


def near(a: float, b: float, tol: float) -> bool:
    """Equal (NaN to NaN), or within ``tol``."""
    return (np.isnan(a) and np.isnan(b)) or a == b or abs(a - b) <= tol


def test_scale_extended_claim(frames):
    """test_rapids_extended: a scaled column has mean ~0 and sd ~1."""
    sc = ti.rapids_exec("(scale (cols sext ['num', 'pos']) True True)",
                        device="cpu")
    num = sc.vec("num").to_numpy().astype(np.float64)
    assert abs(num.mean()) < 1e-5 and abs(num.std(ddof=1) - 1.0) < 1e-2


@pytest.mark.parametrize("expr", ["(not sn)", "(not se)", "(not s1)",
                                  "(not (cols sx [0 1 2 3 4]))",
                                  "(not (cols sn 'c'))",
                                  f"(not {EMPTY})"])
def test_not(frames, expr):
    port, moved = check(expr)
    nbytes = 4 * port.nrows * port.ncols
    assert moved == {"to_device": nbytes, "to_host": nbytes}


@pytest.mark.parametrize("x", ["0", "3.5", "-0", "NaN", "TRUE", "FALSE"])
def test_not_of_a_number(frames, x):
    host(f"(not {x})")


def test_not_round3(frames):
    """test_rapids_round3's case: 1 where 0, NaN where NaN."""
    publish("r3a", *pair({"a": (T_NUM, [0, 1, 2, NAN], None)}))
    try:
        got = check("(not r3a)")[0].vecs[0].to_numpy()
        assert list(got[:3]) == [1, 0, 0] and np.isnan(got[3])
        assert host("(any.na r3a)") == 1.0
        assert host("(any.factor r3a)") == 0.0
    finally:
        unpublish_ref("r3a")


# ------------------------------------------------------------------ apply

APPLY_HOST = [
    "(apply sq 2 { x . (mean x) })", "(apply sq 2 { x . (max x) })",
    "(apply sq 2 { x . (sum x) })",
    "(apply se 2 { x . (min x) })", "(apply s1 2 { col . (max col) })",
    "(apply sq 1 { x . (mean x) })", "(apply sq 1 { x . (sum x) })",
    "(apply sq 1 { x . (min x) })", "(apply sq 1 { x . (max x) })",
    "(apply sq 1 { x . (median x) })", "(apply sq 1 { x . (sd x) })",
    "(apply se 1 { x . (mean x) })", "(apply se 1 { row . (max row) })",
    "(apply sq 1 { x . (mean (cols x [0 1])) })",
    "(apply sq12 1 { x . (nrow x) })", "(apply sq12 1 { x . (max x) })",
    "(apply sq 2 { x . (nrow x) })",
]


@pytest.mark.parametrize("expr", APPLY_HOST)
def test_apply_host_bodies(frames, expr):
    """Reducers over each column (rollups: exact on a 1/8 grid) and each
    row (numpy's nan-reducers, ``sd`` with ddof 1), and a lambda body
    over the transposed rows."""
    host(expr)


def test_apply_median_refines_on_the_device(frames):
    """``median`` in a column body refines on the session's device
    (``core/quantile.py``), as the reduction does outside ``apply``."""
    _port, moved = check("(apply sq 2 { x . (median x) })")
    assert moved["to_device"] > 0


APPLY_DEVICE = [("sq", "2 { x . (abs x) }"), ("sq", "2 { x . (* x 2) }"),
                ("sn", "2 { x . (not x) }"), ("se", "2 { x . (- x 0.5) }"),
                ("sq5", "1 { x . (abs x) }")]


@pytest.mark.parametrize("key,fn", APPLY_DEVICE)
def test_apply_device_bodies(frames, key, fn):
    """A device op in the body runs on the session's device: each column
    (or each transposed row) moves once each way."""
    port, moved = check(f"(apply {key} {fn})")
    cells = 4 * dkv().get(key).nrows * dkv().get(key).ncols
    assert moved == {"to_device": cells, "to_host": cells}, moved


def test_apply_extended_claim(frames):
    """test_rapids_extended's wire form on its frame: the column means,
    within the rollups' bound of numpy's mean."""
    from h2o_tpu.rapids.interp import Session, rapids_exec
    expr = "(apply (cols sext ['num', 'pos']) 2 { x . (mean x) })"
    ref = rapids_exec(expr, Session("_ref"))
    port = ti.rapids_exec(expr, device="cpu")
    assert port.names == ref.names == ["num", "pos"] and port.nrows == 1
    cols = [dkv().get("sext").vec(c).as_float() for c in ("num", "pos")]
    rollup_close([v.to_numpy()[0] for v in port.vecs],
                 [v.to_numpy()[0] for v in ref.vecs], "mean", cols)
    assert abs(float(port.vecs[0].to_numpy()[0]) -
               cols[0].astype(np.float64).mean()) < 1e-4


def test_apply_over_many_rows_raises(frames):
    """A non-reducer lambda over more than 100,000 rows is refused with
    the reference's message; a reducer takes the fast path."""
    n = 100_001
    publish("sbig", *pair({"a": (T_NUM, np.arange(n) % 7, None),
                           "b": (T_NUM, np.ones(n), None)}))
    try:
        check("(apply sbig 1 { x . (abs x) })")
        with pytest.raises(ValueError, match="limit is 100k rows"):
            ti.rapids_exec("(apply sbig 1 { x . (abs x) })", device="cpu")
        host("(apply sbig 1 { x . (sum x) })")
    finally:
        unpublish_ref("sbig")


def test_apply_binds_locals_only_inside(frames):
    """The lambda's argument shadows a DKV key only inside its body."""
    dkv().put("x", dkv().get("sx"))
    got = ti.rapids_exec("(apply sq 2 { x . (nrow x) })", device="cpu")
    assert [float(v.to_numpy()[0]) for v in got.vecs] == [200.0] * 4
    assert ti.rapids_exec("(nrow x)", device="cpu") == 300.0


# ---------------------------------------------------------------- refusals

MALFORMED = [
    "(hist (cols sx 'c') 5)", "(hist sstr 5)",
    "(cor (cols sx 'x') (cols sx 'y') \"pairwise\" \"Pearson\")",
    "(cor (cols sx 'x') (cols sx 'y') \"everything\" \"Kendall\")",
    "(apply sq 2 (mean x))", "(apply sq 2 x . (mean x))",
    "(entropy sn)", "(scale sx [1 2] [1 2])", "(topn sx 30 10 1)",
    "(which.max sstr True 1)", "(kfold_column sx 0 1)",
    "(stratified_kfold_column sstr 3 1)", "(not sstr)",
    "(sumaxis sstr True 0)", "(t sstr)",
    "(cor (cols sstr 's') (cols sstr 'f') \"everything\" \"Pearson\")",
    "(scale)",
]


@pytest.mark.parametrize("expr", MALFORMED)
def test_malformed_calls_raise_alike(frames, expr):
    port, _moved = check(expr)
    assert port is None, f"{expr} did not raise"
