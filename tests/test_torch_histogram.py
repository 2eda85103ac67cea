"""Port histogram (h2o_tpu_torch.ops.histogram / hist_kernels) held
against the JAX reference on the CPU.

The JAX side runs as its own tests run it: ``_block_hist`` directly and
the Pallas kernels through ``interpret=True``.  The port runs its plain
PyTorch versions (CPU tensors).  float32 tables agree to rtol/atol 1e-5
(the port sums in float64 and casts once, the reference in float32 in
another order); integer tables are equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h2o_tpu.ops.hist_pallas import hist_pallas, hist_pallas_adaptive
from h2o_tpu.ops.histogram import _block_hist, map_buckets as jax_map_buckets

from h2o_tpu_torch.ops import hist_kernels as hk
from h2o_tpu_torch.ops.histogram import (block_hist, histogram_build,
                                         map_buckets)

def _table_to_lcbs(flat, C, B, L, S=4):
    return np.asarray(flat).reshape(C, B + 1, L, S).transpose(2, 0, 1, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes gain nothing from intra-op threads, and the suite
    runs several workers at once: keep torch to one CPU thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("bins_dtype", ["uint8", "int16", "int32"])
@pytest.mark.parametrize("stats_dtype", ["float32", "int16", "int8"])
def test_block_hist_matches_reference(bins_dtype, stats_dtype):
    rng = np.random.default_rng(11)
    R, C, L, B = 1200, 5, 6, 14
    bins = rng.integers(0, B + 1, size=(R, C)).astype(bins_dtype)  # NA = B
    leaf = rng.integers(-1, L, size=R).astype(np.int32)
    if stats_dtype == "float32":
        stats = rng.normal(size=(R, 4)).astype(np.float32)
        stats[leaf < 0] = np.nan               # inactive rows may hold NaN
    else:
        hi = 120 if stats_dtype == "int8" else 3000
        stats = rng.integers(-hi, hi, size=(R, 4)).astype(stats_dtype)
    want = np.asarray(_block_hist(jnp.asarray(bins), jnp.asarray(leaf),
                                  jnp.asarray(stats), L, B))
    got = block_hist(torch.from_numpy(bins), torch.from_numpy(leaf),
                     torch.from_numpy(stats), L, B).numpy()
    assert got.shape == want.shape == (C * (B + 1), L * 4)
    if stats_dtype == "float32":
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    # the NA bucket (bin B) is populated and counted like any other
    assert np.abs(got.reshape(C, B + 1, L * 4)[:, B]).sum() > 0


@pytest.mark.parametrize("bins_dtype", ["int16", "int32"])
def test_map_buckets_equal(bins_dtype):
    rng = np.random.default_rng(5)
    R, C, L, B, F = 900, 7, 6, 8, 64
    bins = rng.integers(0, F, size=(R, C)).astype(bins_dtype)
    bins[rng.uniform(size=(R, C)) < 0.05] = F            # NA fine bin
    is_cat = np.zeros(C, bool)
    is_cat[2] = True
    bins[:, 2] = rng.integers(0, 12, size=R)             # cat codes > B too
    leaf = rng.integers(-1, L, size=R).astype(np.int32)
    lo = rng.integers(0, 16, size=(L, C)).astype(np.int32)
    hi = lo + rng.integers(0, 40, size=(L, C)).astype(np.int32)
    off = rng.integers(0, 4, size=(L, C)).astype(np.int32)
    want = np.asarray(jax_map_buckets(
        jnp.asarray(bins), jnp.asarray(leaf), jnp.asarray(lo),
        jnp.asarray(hi), jnp.asarray(off), jnp.asarray(is_cat), B, F))
    got = map_buckets(*(torch.from_numpy(a) for a in
                        (bins, leaf, lo, hi, off, is_cat)), B, F).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["nan_rows", "ragged_rows", "int16_stats"])
def test_histogram_build_matches_hist_pallas(case):
    """Shapes of tests/test_hist_pallas.py:17-49, plus quantized stats
    (an exact int32 table on both sides)."""
    if case == "int16_stats":
        rng = np.random.default_rng(3)
        R, C, L, B = 1000, 5, 8, 12
        bins = rng.integers(0, B + 1, size=(R, C)).astype(np.uint8)
        leaf = rng.integers(-1, L, size=R).astype(np.int32)
        stats = rng.integers(-3000, 3000, size=(R, 4)).astype(np.int16)
    elif case == "nan_rows":
        rng = np.random.default_rng(7)
        R, C, L, B = 1000, 5, 8, 12
        bins = rng.integers(0, B + 1, size=(R, C)).astype(np.int32)
        leaf = rng.integers(-1, L, size=R).astype(np.int32)
        stats = rng.normal(size=(R, 4)).astype(np.float32)
        stats[leaf < 0] = np.nan
    else:
        rng = np.random.default_rng(1)
        R, C, L, B = 777, 3, 4, 6
        bins = rng.integers(0, B, size=(R, C)).astype(np.uint8)
        leaf = rng.integers(0, L, size=R).astype(np.int32)
        stats = rng.normal(size=(R, 4)).astype(np.float32)
        stats[:, 0] = 1.0
    want = hist_pallas(jnp.asarray(bins), jnp.asarray(leaf),
                       jnp.asarray(stats), L, B, interpret=True)
    got = histogram_build(torch.from_numpy(bins), torch.from_numpy(leaf),
                          torch.from_numpy(stats), L, B).numpy()
    assert got.shape == (L, C, B + 1, 4)
    if case == "int16_stats":
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, _table_to_lcbs(want, C, B, L))
    else:
        np.testing.assert_allclose(got, _table_to_lcbs(want, C, B, L),
                                   rtol=1e-5, atol=1e-5)


def _adaptive_case():
    """Shapes of tests/test_hist_pallas.py:52-80."""
    rng = np.random.default_rng(5)
    R, C, L, B, F = 900, 7, 6, 8, 64
    bins = rng.integers(0, F, size=(R, C)).astype(np.int16)
    bins[rng.uniform(size=(R, C)) < 0.05] = F
    is_cat = np.zeros(C, bool)
    is_cat[2] = True
    bins[:, 2] = rng.integers(0, 5, size=R)
    leaf = rng.integers(-1, L, size=R).astype(np.int32)
    stats = rng.normal(size=(R, 4)).astype(np.float32)
    lo = rng.integers(0, 16, size=(L, C)).astype(np.int32)
    hi = lo + rng.integers(1, 40, size=(L, C)).astype(np.int32)
    off = rng.integers(0, 4, size=(L, C)).astype(np.int32)
    return (R, C, L, B, F), (bins, leaf, stats, lo, hi, off, is_cat)


@pytest.mark.parametrize("bf16", [False, True])
def test_histogram_build_matches_hist_pallas_adaptive(bf16):
    """bf16 rounds each stat before the sum on both sides; the reference
    then multiplies in bf16 and the port adds in float64, so the tables
    agree to rtol 1e-2 (3 significant bf16 digits)."""
    (R, C, L, B, F), arrays = _adaptive_case()
    bins, leaf, stats, lo, hi, off, is_cat = arrays
    want = hist_pallas_adaptive(*(jnp.asarray(a) for a in arrays), L, B, F,
                                bf16=bf16, interpret=True)
    t = [torch.from_numpy(a) for a in arrays]
    got = histogram_build(t[0], t[1], t[2], L, B, bf16=bf16,
                          fine_map=(t[3], t[4], t[5], t[6], F)).numpy()
    tol = 1e-2 if bf16 else 1e-5
    np.testing.assert_allclose(got, _table_to_lcbs(want, C, B, L),
                               rtol=tol, atol=tol)


# (R, C, B+1, L, adaptive): the default GBM's top and last levels, the
# QuantilesGlobal levels, the dense engine's deepest frontier, and a
# bucket count too wide for one column of shared memory
_PLAN_SHAPES = [
    (1_000_000, 28, 1025, 1, True),
    (1_000_000, 28, 65, 16, True),
    (1_000_000, 28, 65, 1, False),
    (1_000_000, 28, 65, 16, False),
    (1_000_000, 28, 65, 4096, False),
    (5_000, 3, 20_001, 2, False),
]


@pytest.mark.parametrize("R,C,B1,L,adaptive", _PLAN_SHAPES)
def test_planner_covers_every_cell_once_within_budget(R, C, B1, L, adaptive):
    plan = hk.plan_hist(R, C, B1, L, adaptive=adaptive)
    assert plan.smem_bytes <= hk.SMEM_BUDGET <= 227 * 1024
    cover = np.zeros((C, L, B1), np.int32)
    for c0, c1, l0, l1, b0, b1 in plan.groups():
        assert c0 < c1 and l0 < l1 and b0 < b1
        cell = 16 * (b1 - b0) + (12 if adaptive else 0)
        assert (c1 - c0) * ((l1 - l0) * cell + (4 if adaptive else 0)) \
            <= plan.smem_bytes
        cover[c0:c1, l0:l1, b0:b1] += 1
    np.testing.assert_array_equal(cover, 1)
    # every row lands in exactly one chunk; chunks are warp multiples
    assert plan.chunk_rows % 32 == 0
    assert (plan.n_chunks - 1) * plan.chunk_rows < R <= \
        plan.n_chunks * plan.chunk_rows
    assert plan.n_chunks * C * B1 * L * 16 <= max(hk.SCRATCH_BYTES,
                                                  C * B1 * L * 16)
