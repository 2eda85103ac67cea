"""The data layer under GLM: rollups and DataInfo's expanded mode, held
against ``h2o_tpu`` on the CPU.

The same seeded numpy columns — numerics with NaNs, categoricals with
NA codes, a constant numeric, a one-level categorical and an all-NA
column — go into an ``h2o_tpu`` frame and a port frame.  A column of
0.1 everywhere stays in both: its float32 mean misses 0.1 by rounding,
so its rollup sigma is not 0, and the reference's rule keeps it (a
min == max rule would drop it).

Tolerances: the rollup counts (cnt, nacnt, zeros), min, max and isint
are equal; the mean within 1e-6 of the column's mean |x| and sigma
within 1e-6 relative (both sum in float32, in different orders:
numpy's pairwise sum here, XLA's per-shard sums over the 8-device test
mesh there, so they differ by a few ulps of the sum of magnitudes),
sigma also within 1e-6 of the mean |x|.  The dropped columns, the
expanded names and every one-hot column are equal; the standardized numerics
within 1e-6 absolute (they inherit the mean's and sigma's last bits).
``expand_for_scoring`` (a scoring frame with NA codes and a level the
training domain lacks) and ``expand_array`` are held to the same.
"""

import numpy as np
import pytest
import torch

from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models import glm as jglm
from h2o_tpu.models.model import DataInfo as JDataInfo

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models import glm as pglm
from h2o_tpu_torch.models.model import DataInfo

pytestmark = pytest.mark.shared_dkv

N = 700
NUMS = ("n0", "n1", "n2", "int", "zero_heavy")
CATS = ("c3", "c5")
DEAD = ("const", "one_level", "all_na")
TENTH = "tenth"            # 0.1 everywhere: kept (rollup sigma > 0)


def _columns(n=N, seed=0):
    rng = np.random.default_rng(seed)
    cols = {}
    cols["n0"] = rng.normal(2.0, 3.0, n).astype(np.float32)
    n1 = rng.normal(size=n).astype(np.float32)
    n1[rng.uniform(size=n) < 0.1] = np.nan
    cols["n1"] = n1
    cols["n2"] = rng.exponential(5.0, n).astype(np.float32)
    it = rng.integers(-3, 9, n).astype(np.float32)
    it[rng.uniform(size=n) < 0.05] = np.nan
    cols["int"] = it
    zh = rng.normal(size=n).astype(np.float32)
    zh[rng.uniform(size=n) < 0.6] = 0.0
    cols["zero_heavy"] = zh
    c3 = rng.integers(0, 3, n).astype(np.int32)
    c3[rng.uniform(size=n) < 0.08] = -1
    cols["c3"] = (c3, ["a", "b", "c"])
    cols["c5"] = (rng.integers(0, 5, n).astype(np.int32), list("vwxyz"))
    cols["const"] = np.full(n, 0.5, np.float32)
    cols[TENTH] = np.full(n, 0.1, np.float32)
    cols["one_level"] = (np.zeros(n, np.int32), ["only"])
    cols["all_na"] = np.full(n, np.nan, np.float32)
    cols["y"] = rng.normal(size=n).astype(np.float32)
    return cols


def _frames(cols):
    names, jv, pv = [], [], []
    for name, v in cols.items():
        names.append(name)
        if isinstance(v, tuple):
            jv.append(JVec(v[0], J_CAT, domain=v[1]))
            pv.append(Vec(v[0], T_CAT, domain=v[1]))
        else:
            jv.append(JVec(v))
            pv.append(Vec(v))
    return JFrame(names, jv), Frame(names, pv)


@pytest.fixture(scope="module")
def frames(cl):
    return _frames(_columns())


@pytest.mark.parametrize("col", NUMS + CATS + ("const", "all_na", TENTH))
def test_rollups_equal(frames, col):
    jf, pf = frames
    want, got = jf.vec(col).rollups, pf.vec(col).rollups
    for k in ("cnt", "nacnt", "zeros", "isint"):
        assert getattr(got, k) == getattr(want, k), k
    if want.cnt:
        assert got.min == want.min and got.max == want.max
    x = pf.vec(col).as_float()
    scale = float(np.nanmean(np.abs(x))) if want.cnt else 0.0
    np.testing.assert_allclose(got.mean, want.mean, rtol=0,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(got.sigma, want.sigma, rtol=1e-6,
                               atol=1e-6 * scale)


@pytest.mark.parametrize("mode", ["tree", "expanded"])
def test_constant_columns_dropped_alike(frames, mode):
    """One rule in both modes: the reference's (a categorical of at most
    one level, a numeric of rollup sigma 0, all-NA included)."""
    jf, pf = frames
    x = [c for c in pf.names if c != "y"]
    want = JDataInfo(jf, x, "y", mode=mode).x
    got = DataInfo(pf, x, "y", torch.device("cpu"), mode=mode).x
    assert got == want
    assert set(got) == set(NUMS) | set(CATS) | {TENTH}


@pytest.mark.parametrize("standardize", [True, False])
@pytest.mark.parametrize("all_levels", [False, True])
def test_expanded_matrix(frames, standardize, all_levels):
    jf, pf = frames
    # the 0.1 column standardizes to rounding residues over a sigma of
    # rounding residues in both packages: left out here
    x = [c for c in pf.names if c not in ("y", TENTH)]
    kw = dict(mode="expanded", standardize=standardize,
              use_all_factor_levels=all_levels, impute_missing=True)
    jdi = JDataInfo(jf, x, "y", **kw)
    pdi = DataInfo(pf, x, "y", torch.device("cpu"), **kw)
    want = np.asarray(jdi.matrix())[:N]
    got = pdi.matrix().numpy()
    assert pdi.expanded_names == jdi.expanded_names
    assert pdi.cat_names == list(CATS) and pdi.num_names == list(NUMS)
    n_oh = sum((3, 5)) - (0 if all_levels else 2)
    assert got.shape == want.shape == (N, n_oh + len(NUMS))
    np.testing.assert_array_equal(got[:, :n_oh], want[:, :n_oh])
    # an NA code one-hots to all zeros
    na = pf.vec("c3").data < 0
    assert not got[na, :(3 if all_levels else 2)].any()
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got[:, n_oh:], want[:, n_oh:], rtol=0,
                               atol=1e-6)
    ps, js = pglm.expansion_spec(pdi), jglm.expansion_spec(jdi)
    assert set(ps) == set(js)
    for k in js:
        if k in ("means", "sigmas"):
            np.testing.assert_allclose(ps[k], js[k], rtol=1e-6, atol=1e-7)
        else:
            assert ps[k] == js[k], k


def _scoring_frames(seed=3, n=300):
    """A scoring frame: the training columns with other values, NA codes,
    and c5 coded against a domain with one level more (code 5 is a level
    the training domain lacks)."""
    cols = _columns(n, seed)
    codes = np.random.default_rng(seed).integers(-1, 6, n).astype(np.int32)
    cols["c5"] = (codes, list("vwxyz") + ["new"])
    return _frames(cols)


@pytest.mark.parametrize("standardize", [True, False])
def test_expand_for_scoring_and_array(frames, standardize):
    jf, pf = frames
    x = [c for c in pf.names if c not in ("y", TENTH)]
    kw = dict(mode="expanded", standardize=standardize,
              impute_missing=True)
    jspec = jglm.expansion_spec(JDataInfo(jf, x, "y", **kw))
    pspec = pglm.expansion_spec(DataInfo(pf, x, "y", torch.device("cpu"),
                                         **kw))
    sj, sp = _scoring_frames()
    want = np.asarray(jglm.expand_for_scoring(sj, jspec))[:sp.nrows]
    got = pglm.expand_for_scoring(sp, pspec, torch.device("cpu")).numpy()
    n_oh = 2 + 4
    np.testing.assert_array_equal(got[:, :n_oh], want[:, :n_oh])
    np.testing.assert_allclose(got[:, n_oh:], want[:, n_oh:], rtol=0,
                               atol=1e-6)
    # the unseen level and the NA code one-hot to zeros
    c5 = sp.vec("c5").data
    assert not got[(c5 < 0) | (c5 >= 5), 2:6].any()
    # the array form over raw columns (codes as floats, NaN NAs), in a
    # column order of its own
    order = list(reversed(pspec["cat_names"] + pspec["num_names"]))
    raw = np.stack([sp.vec(c).as_float() for c in order], axis=1)
    want_a = np.asarray(jglm.expand_array(raw, jspec, order))
    got_a = pglm.expand_array(torch.from_numpy(raw), pspec, order).numpy()
    np.testing.assert_array_equal(got_a[:, :n_oh], want_a[:, :n_oh])
    np.testing.assert_allclose(got_a[:, n_oh:], want_a[:, n_oh:], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got_a, got, rtol=0, atol=1e-6)
