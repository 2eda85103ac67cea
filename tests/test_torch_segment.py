"""``h2o_tpu_torch.ops.segment`` against the reference's segment ops.

The port's group-by, quantile counts, binomial AUC bins, multinomial
confusion matrix, variable importances and CoxPH group sums all reduce
segments through these helpers; here each is held bitwise against the
JAX op the reference calls (``x.at[i].add``, ``jax.ops.segment_sum`` /
``segment_min`` / ``segment_max``, ``jnp.lexsort``) on the CPU, on the
same seeded inputs: repeated indices, empty segments, indices out of
range, +-inf, ``-0.0``/``0.0`` keys and ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o_tpu_torch.ops import segment


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _values(rng, n, kind):
    if kind == "normal":
        return rng.normal(size=n).astype(np.float32) * 1e3
    if kind == "grid":
        return (rng.integers(-64, 64, size=n) / 8).astype(np.float32)
    v = rng.normal(size=n).astype(np.float32)
    v[rng.uniform(size=n) < 0.1] = np.inf
    v[rng.uniform(size=n) < 0.1] = -np.inf
    return v


@pytest.mark.parametrize("kind", ["normal", "grid", "inf"])
@pytest.mark.parametrize("n_seg", [1, 7, 300])
def test_segment_sum_matches_segment_sum_bitwise(kind, n_seg):
    rng = np.random.default_rng(n_seg)
    n = 2000
    vals = _values(rng, n, kind) if kind != "inf" else \
        np.where(rng.uniform(size=n) < 0.02, np.inf,
                 rng.normal(size=n)).astype(np.float32)
    # every segment index repeats; out-of-range ones are dropped
    idx = rng.integers(-2, n_seg + 2, size=n).astype(np.int32)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(vals),
                                          jnp.asarray(idx),
                                          num_segments=n_seg))
    got = segment.segment_sum(_t(vals), _t(idx), n_seg).numpy()
    np.testing.assert_array_equal(got, want)


def test_segment_sum_empty_segments_and_2d_rows():
    rng = np.random.default_rng(3)
    vals = rng.normal(size=(500, 3)).astype(np.float32)
    idx = rng.choice([0, 2, 9], size=500).astype(np.int32)  # 1, 3..8 empty
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(vals),
                                          jnp.asarray(idx), num_segments=10))
    got = segment.segment_sum(_t(vals), _t(idx), 10).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[[1, 3, 4, 5, 6, 7, 8]].any()


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_scatter_add_into_existing_matches_at_add(dtype):
    rng = np.random.default_rng(4)
    base = (rng.normal(size=16) * 10).astype(dtype)
    vals = (rng.normal(size=3000) * 100).astype(dtype)
    idx = rng.integers(0, 16, size=3000).astype(np.int32)
    want = np.asarray(jnp.asarray(base).at[jnp.asarray(idx)].add(
        jnp.asarray(vals)))
    got = segment.scatter_add(_t(base.copy()), _t(idx), _t(vals)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("kind", ["normal", "inf"])
def test_segment_min_max_match_bitwise(op, kind):
    rng = np.random.default_rng(5)
    n = 1500
    vals = _values(rng, n, kind)
    idx = rng.integers(-1, 40, size=n).astype(np.int32)
    idx[idx == 17] = 18                       # segment 17 stays empty
    ref = jax.ops.segment_min if op == "min" else jax.ops.segment_max
    want = np.asarray(ref(jnp.asarray(vals), jnp.asarray(idx),
                          num_segments=41))
    fn = segment.segment_min if op == "min" else segment.segment_max
    got = fn(_t(vals), _t(idx), 41).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[17] == (np.inf if op == "min" else -np.inf)


@pytest.mark.parametrize("op", ["min", "max"])
def test_segment_min_max_integers(op):
    rng = np.random.default_rng(6)
    vals = rng.integers(-1000, 1000, size=800).astype(np.int32)
    idx = rng.integers(0, 12, size=800).astype(np.int32)
    idx[idx == 3] = 4
    ref = jax.ops.segment_min if op == "min" else jax.ops.segment_max
    want = np.asarray(ref(jnp.asarray(vals), jnp.asarray(idx),
                          num_segments=12))
    fn = segment.segment_min if op == "min" else segment.segment_max
    np.testing.assert_array_equal(fn(_t(vals), _t(idx), 12).numpy(), want)


def _lex_cases():
    rng = np.random.default_rng(7)
    n = 3000
    ties = rng.integers(0, 4, size=n).astype(np.float32)
    zeros = rng.choice(np.array([-0.0, 0.0, 1.0, -1.0], np.float32), size=n)
    infs = rng.choice(np.array([-np.inf, np.inf, 0.5], np.float32), size=n)
    codes = rng.integers(-1, 5, size=n).astype(np.int32)
    normal = rng.normal(size=n).astype(np.float32)
    return {
        "one_float_key": (normal,),
        "ties_then_rowid": (ties,),
        "signed_zeros": (zeros,),
        "signed_zeros_two_keys": (zeros, ties),
        "inf_and_codes": (infs, codes),
        "three_keys": (normal, zeros, codes),
        "int_codes": (codes,),
    }


@pytest.mark.parametrize("case", sorted(_lex_cases()))
def test_lexsort_matches_jnp_lexsort(case):
    keys = _lex_cases()[case]
    want = np.asarray(jnp.lexsort(tuple(jnp.asarray(k) for k in keys)))
    got = segment.lexsort([_t(k) for k in keys]).numpy()
    np.testing.assert_array_equal(got, want)


def test_lexsort_is_stable_on_equal_keys():
    k = np.zeros(1000, np.float32)
    k[::2] = -0.0
    got = segment.lexsort([_t(k)]).numpy()
    np.testing.assert_array_equal(got, np.arange(1000))


@pytest.mark.parametrize("kind", ["grid", "normal"])
def test_sorted_segment_sum(kind):
    """Rows sorted by segment, summed in one tree order: exact (so equal
    to the reference's sums bitwise) on 1/8-grid values, within the
    float32 summation bound on random ones; empty segments and a
    segment of -0.0 sum to +0.0."""
    rng = np.random.default_rng(8)
    n, G = 3000, 50
    seg = np.sort(rng.integers(0, G, size=n)).astype(np.int64)
    seg[seg == 7] = 8                                   # 7 stays empty
    vals = _values(rng, n, kind)
    got = segment.sorted_segment_sum(_t(vals), _t(seg), G).numpy()
    if kind == "grid":
        want = np.asarray(jax.ops.segment_sum(jnp.asarray(vals),
                                              jnp.asarray(seg),
                                              num_segments=G))
        np.testing.assert_array_equal(got, want)
    else:
        exact = np.bincount(seg, weights=vals.astype(np.float64),
                            minlength=G)
        scale = np.bincount(seg, weights=np.abs(vals.astype(np.float64)),
                            minlength=G)
        counts = np.bincount(seg, minlength=G)
        assert np.all(np.abs(got - exact) <=
                      counts * 2.0 ** -24 * scale + 1e-30)
    assert got[7] == 0.0 and not np.signbit(got[7])
    z = segment.sorted_segment_sum(torch.tensor([-0.0, -0.0, 1.0]),
                                   torch.tensor([0, 0, 1]), 2).numpy()
    assert z[0] == 0.0 and not np.signbit(z[0]) and z[1] == 1.0
    assert segment.sorted_segment_sum(torch.zeros(0), torch.zeros(
        0, dtype=torch.long), 3).tolist() == [0.0, 0.0, 0.0]


@pytest.mark.parametrize("kind", ["grid", "normal"])
def test_block_partials_keep_the_sums(kind):
    """The card's blocked reduction of long segments (run here on the
    CPU): the same sums, exactly on 1/8-grid values, within the float32
    summation bound on random ones; at most one partial a block a
    slot."""
    rng = np.random.default_rng(9)
    n, rows, block = 12, 5000, 512
    idx = np.where(rng.uniform(size=rows) < 0.7, 0,
                   rng.integers(0, n, size=rows)).astype(np.int64)
    vals = _values(rng, rows, kind)
    pi, pv = segment.block_partials(_t(idx), _t(vals), n, block)
    assert pi.shape[0] == n * -(-rows // block)
    assert np.bincount(pi.numpy(), minlength=n).max() == -(-rows // block)
    got = segment.scatter_add(torch.zeros(n), pi, pv).numpy()
    exact = np.bincount(idx, weights=vals.astype(np.float64), minlength=n)
    if kind == "grid":
        np.testing.assert_array_equal(got, exact.astype(np.float32))
    else:
        scale = np.bincount(idx, weights=np.abs(vals.astype(np.float64)),
                            minlength=n)
        assert np.all(np.abs(got - exact) <= rows * 2.0 ** -24 * scale)
