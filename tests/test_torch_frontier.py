"""The port's sparse-frontier engine held against ``h2o_tpu``'s.

``engine.train_forest`` and the reference's ``_train_forest_impl`` get
the same binned data, the same master key and the same explicit
``kleaves``: 4 (capped from the third level on: best-first selection
with ties to the lower index, as ``lax.top_k``) and 2^(D-1) (never
capped: the frontier builds the dense engine's trees in pool layout and
must score exactly like them).  Row sampling (0.9) runs in every case,
per-level and per-tree column sampling in one.  Pool arrays (split
columns, bitsets, child pointers) are equal, node values agree to
atol 1e-6 and the summed split gains (varimp: differences of sums, so
their rounding shows relatively more) to rtol 1e-4.

The drf cases' stats (w, w*y, w*y^2, w) are multiples of 1/256 far
below 2^24, so every table sums exactly in either package and the
trees are equal however deep they grow.  The gbm case's gradients are
not exact; it stays at the cap of 4 leaves, where no split is a
near-tie on this data.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from h2o_tpu.models.tree import jit_engine as jeng

from h2o_tpu_torch.models.distributions import get_distribution
from h2o_tpu_torch.models.tree import engine
from h2o_tpu_torch.models.tree.shared_tree import forest_score
from h2o_tpu_torch.ops import prng

pytestmark = pytest.mark.shared_dkv

DEPTH = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _binned(R=2560, C=6, B=16, seed=0):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, size=(R, C)).astype(np.int32)
    y = (rng.normal(size=R) * 0.3 + (bins[:, 0] > B // 2) +
         0.5 * (bins[:, 1] > 4))
    return bins, (np.round(y * 16) / 16).astype(np.float32)


def _kwargs(kleaves, mode, **over):
    kw = dict(dist_name="gaussian", ntrees=3, max_depth=DEPTH, nbins=16,
              k_cols=6, newton=False, sample_rate=0.9, learn_rate=0.1,
              learn_rate_annealing=1.0, min_rows=1.0,
              min_split_improvement=1e-5, mode=mode, kleaves=kleaves)
    kw.update(over)
    return kw


def _port(bins, y, dist_name, **kw):
    R, C = bins.shape
    return engine.train_forest(
        torch.from_numpy(bins), torch.from_numpy(y), torch.ones(R),
        torch.ones(R, dtype=torch.bool), torch.zeros((R, 1)),
        torch.zeros(C, dtype=torch.bool), prng.key(3),
        dist=get_distribution(dist_name), **kw)


def _reference(bins, y, **kw):
    R, C = bins.shape
    return jeng._train_forest_impl(
        jnp.asarray(bins), jnp.asarray(y), jnp.ones(R), jnp.ones(R, bool),
        jnp.zeros((R, 1)), jnp.zeros(C, bool), jax.random.key(3), K=1,
        **kw)


CASES = {
    "drf_cap4": dict(kleaves=4, mode="drf"),
    "drf_uncapped": dict(kleaves=2 ** (DEPTH - 1), mode="drf"),
    "drf_cap4_colsample": dict(kleaves=4, mode="drf", k_cols=3,
                               col_sample_rate_per_tree=0.7),
    "gbm_cap4": dict(kleaves=4, mode="gbm"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_frontier_forest_equal(cl, case):
    bins, y = _binned()
    kw = _kwargs(**CASES[case])
    want = _reference(bins, y, **kw)
    got = _port(bins, y, **kw)
    N = engine.pool_size(DEPTH, kw["kleaves"])
    assert got.split_col.shape == (3, 1, N)
    for k in ("split_col", "bitset", "child", "thr_bin", "na_left"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.varimp.numpy(), np.asarray(want.varimp),
                               rtol=1e-4)
    assert (got.split_col.numpy() >= 0).sum() > 12


def test_uncapped_frontier_scores_like_dense():
    bins, y = _binned()
    kw = _kwargs(kleaves=0, mode="drf")
    dense = _port(bins, y, **kw)
    kw["kleaves"] = 2 ** (DEPTH - 1)
    front = _port(bins, y, **kw)
    assert dense.child is None and front.child is not None
    tb = torch.from_numpy(bins)
    s_d = forest_score(tb, dense.split_col, dense.bitset, dense.value, DEPTH)
    s_f = forest_score(tb, front.split_col, front.bitset, front.value, DEPTH,
                       child=front.child)
    assert torch.equal(s_d, s_f)
    assert (dense.split_col >= 0).sum() == (front.split_col >= 0).sum()
    torch.testing.assert_close(dense.varimp, front.varimp, rtol=0, atol=0)


def test_engine_plan_matches_reference(monkeypatch):
    for depth in (1, 5, 13, 14, 20, 30):
        assert engine.plan_engine(depth) == jeng.plan_engine(depth)
        for cap in (4, 64, 4096):
            assert engine.frontier_plan(depth, cap) == \
                jeng.frontier_plan(depth, cap)
            assert engine.pool_size(depth, cap) == jeng.pool_size(depth, cap)
        assert engine.pool_size(depth, 0) == jeng.pool_size(depth, 0)
    for d in (5, 30, 31, 64):
        assert engine.clamp_depth(d) == jeng.clamp_depth(d)
    monkeypatch.setattr(engine, "MAX_LIVE_LEAVES", 16)
    monkeypatch.setenv("H2O_TPU_MAX_LIVE_LEAVES", "16")
    for depth in (5, 6, 8):
        assert engine.plan_engine(depth) == jeng.plan_engine(depth)
