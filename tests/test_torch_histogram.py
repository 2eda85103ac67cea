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
    """float32 stats with the main path's bins: int16 fine bins for K2,
    uint8 for K1.  A cell is four 32-bit words in every stats mode, so
    int16 stats get the same groups."""
    bsize = 2 if adaptive else 1
    plan = hk.plan_hist(R, C, B1, L, adaptive=adaptive, bins_itemsize=bsize)
    assert plan.smem_bytes <= hk.SMEM_MAX == 227 * 1024
    assert hk.CELL_BYTES == 16
    p16 = hk.plan_hist(R, C, B1, L, adaptive=adaptive, bins_itemsize=bsize,
                       stats_itemsize=2)
    assert (p16.cg, p16.lg, p16.bg) == (plan.cg, plan.lg, plan.bg)
    # shared memory: barriers and scales, the ring, K2's ranges, the table
    assert plan.ranges_off == plan.ring_off + \
        plan.stages * plan.tile_rows * (C * bsize + 4 + 16)
    assert plan.ring_off % 16 == plan.ranges_off % 16 == \
        plan.table_off % 16 == 0
    cover = np.zeros((C, L, B1), np.int32)
    for c0, c1, l0, l1, b0, b1 in plan.groups():
        assert c0 < c1 and l0 < l1 and b0 < b1
        assert (c1 - c0) * (l1 - l0) * (b1 - b0) * hk.CELL_BYTES <= \
            plan.smem_bytes - plan.table_off
        assert (c1 - c0) * (l1 - l0) * 16 * adaptive <= \
            plan.table_off - plan.ranges_off
        cover[c0:c1, l0:l1, b0:b1] += 1
    np.testing.assert_array_equal(cover, 1)
    # every row lands in exactly one chunk; chunks are whole tiles
    assert plan.tile_rows in hk._TILE_ROWS and plan.stages in hk._STAGES
    assert plan.ranges_off - plan.ring_off <= hk.RING_BYTES
    assert plan.chunk_rows % plan.tile_rows == 0
    assert (plan.n_chunks - 1) * plan.chunk_rows < R <= \
        plan.n_chunks * plan.chunk_rows
    # residency: shared memory and 64 registers a thread allow it, and
    # the 1M-row shapes keep at least 32 warps on every SM
    assert plan.resident * (plan.smem_bytes + 1024) <= 228 * 1024
    assert plan.resident * plan.warps <= 32
    if R == 1_000_000:
        assert plan.resident * plan.warps >= 32
        # about one wave of CTAs (chunks are whole tiles, so a few short)
        assert plan.ncg * plan.nlg * plan.nbg * plan.n_chunks >= \
            0.95 * 132 * plan.resident


def test_planner_stages_nothing_for_rows_too_wide():
    """Rows whose tile cannot fit the ring are read from global memory."""
    plan = hk.plan_hist(10_000, 2_000, 65, 1, bins_itemsize=4)
    assert plan.tile_rows == 0
    assert plan.ranges_off == plan.ring_off
    assert plan.chunk_rows % 32 == 0 and plan.smem_bytes <= hk.SMEM_MAX
    cover = np.zeros((2_000, 1, 65), np.int32)
    for c0, c1, l0, l1, b0, b1 in plan.groups():
        cover[c0:c1, l0:l1, b0:b1] += 1
    np.testing.assert_array_equal(cover, 1)


# -- 64-bit fixed point of the float32 tables ---------------------------------

@pytest.mark.parametrize("rows", [1, 1000, 1 << 20, 1_000_000, hk.MAX_ROWS])
@pytest.mark.parametrize("amax", [1.0, 3.7e-5, 2.5, 6.1e30, 1e-38])
def test_fixed_point_scale_is_largest_without_overflow(rows, amax):
    """The largest k with amax * 2^k < 2^FIXED_POINT_BITS: one more bit
    would break the rule.  ``rows`` stats at +-amax, all of one sign, sum
    below 2^62 (the int64 table cannot overflow), and a stat at amax
    wraps its cell's 32-bit word at most once in 2^(32 - bits) adds."""
    from fractions import Fraction
    a = torch.full((4,), amax, dtype=torch.float32)
    k = hk.fixed_point_exponents(a)
    assert k.dtype == torch.int32 and bool((k == k[0]).all())
    k0, bits = int(k[0]), hk.FIXED_POINT_BITS
    exact = Fraction(float(a[0]))
    assert exact * Fraction(2) ** k0 < 2 ** bits
    if k0 < 126:
        assert exact * Fraction(2) ** (k0 + 1) >= 2 ** bits
    for sign in (1.0, -1.0):
        q = int(hk.quantize(torch.full((1, 4), sign * amax), k)[0, 0])
        assert abs(q) <= 2 ** bits
        assert abs(q) * rows < 2 ** 62
        # adds of q to a 32-bit word between two wraps
        assert q == 0 or 2 ** 32 // abs(q) >= 2 ** (32 - bits)


def _word_and_carries(q, order):
    """The kernel's float32 cell, in Python: each q is added to a 32-bit
    word that starts at 2^31, and a wrap of that word (a carry for
    q >= 0, a borrow for q < 0) adds +-2^32 to the int64 in the global
    table; the merge adds the word less 2^31.  Returns the int64 and the
    number of wraps."""
    word, glob, wraps = 2 ** 31, 0, 0
    for i in order:
        u = int(q[i]) % 2 ** 32
        old, word = word, (word + u) % 2 ** 32
        if (word < old) if q[i] >= 0 else (word > old):
            glob += 2 ** 32 if q[i] >= 0 else -2 ** 32
            wraps += 1
    return glob + word - 2 ** 31, wraps


@pytest.mark.parametrize("spread", ["one_sign_at_max", "normal"])
def test_fixed_point_word_and_carries_are_exact_in_any_order(spread):
    """Word plus carries gives the exact int64 sum of the quantized stats
    for any order of the adds; the word wraps at most once in
    2^(32 - bits) adds, as the scale rule promises, and a signed stat
    whose sum wanders around zero does not wrap at all."""
    rng = np.random.default_rng(8)
    n = 4096
    if spread == "normal":
        st = rng.normal(size=(n, 4)).astype(np.float32) * 3
    else:
        st = np.full((n, 4), 2.5, np.float32) * np.array([1, -1, 1, -1],
                                                          np.float32)
    stats = torch.from_numpy(st)
    k = hk.fixed_point_exponents(stats.abs().amax(0))
    q = hk.quantize(stats, k).numpy()
    for s in range(4):
        want = int(q[:, s].sum())
        got, wraps = _word_and_carries(q[:, s], range(n))
        assert got == want
        assert _word_and_carries(q[:, s], rng.permutation(n))[0] == want
        assert wraps <= n // 2 ** (32 - hk.FIXED_POINT_BITS) + 1
        if spread == "one_sign_at_max":
            # one wrap per 2^32 of |sum|
            assert abs(wraps - abs(want) / 2 ** 32) <= 1
        else:
            assert wraps == 0


@pytest.mark.parametrize("bf16", [False, True])
def test_fixed_point_sum_within_bound_of_float64(bf16):
    """quantize -> int64 sum -> float32 against the float64 sum of the
    same (bf16-rounded) stats: within n * 2^(-k-1) + half a float32 ulp."""
    rng = np.random.default_rng(21)
    R = 20_000
    st = rng.normal(size=(R, 4)) * np.array([1.0, 1e-3, 250.0, 7e5])
    stats = torch.from_numpy(st.astype(np.float32))
    leaf = torch.from_numpy(rng.integers(-1, 3, size=R).astype(np.int32))
    stats[leaf < 0] = float("nan")
    amax = hk.active_amax(leaf, stats, 3, bf16=bf16)
    k = hk.fixed_point_exponents(amax)
    act = leaf >= 0
    x = stats[act]
    if bf16:
        x = x.to(torch.bfloat16).to(torch.float32)
    got = hk.dequantize(hk.quantize(x, k).sum(0), k).double()
    want = x.double().sum(0)
    n = int(act.sum())
    bound = n * torch.exp2(-k.double() - 1) + want.abs() * 2.0 ** -24
    assert bool(((got - want).abs() <= bound).all()), (got, want, bound)
    # the quantum is below float32's rounding of amax: 2^-k <= 2^-25 amax
    assert bool((torch.exp2(-k.double()) <=
                 amax.double() * 2.0 ** (1 - hk.FIXED_POINT_BITS)).all())


def test_fixed_point_amax_ignores_inactive_nan():
    rng = np.random.default_rng(4)
    R, L = 500, 4
    leaf = rng.integers(0, L, size=R).astype(np.int32)
    leaf[::7] = -1
    leaf[::11] = L                       # outside [0, L): inactive too
    st = rng.normal(size=(R, 4)).astype(np.float32)
    act = (leaf >= 0) & (leaf < L)
    st[~act] = np.nan
    st[np.flatnonzero(~act)[0], 2] = np.inf
    a = hk.active_amax(torch.from_numpy(leaf), torch.from_numpy(st), L)
    np.testing.assert_array_equal(a.numpy(), np.abs(st[act]).max(0))
    assert bool(torch.isfinite(hk.fixed_point_exponents(a)).all())
    # an active NaN reaches the max of its slot only (the kernel makes
    # that slot NaN)
    st[np.flatnonzero(act)[3], 1] = np.nan
    a = hk.active_amax(torch.from_numpy(leaf), torch.from_numpy(st), L)
    assert np.isnan(a[1].item()) and bool(torch.isfinite(a[[0, 2, 3]]).all())
