"""The port's threefry PRNG held against jax's bit for bit.

``key``/``fold_in``/``split`` give the same 32-bit words as
``jax.random.key_data`` of jax's keys, ``bits`` the same words as
``jax.random.bits``, ``uniform`` (also with ``minval``/``maxval``) and
``normal`` the same float32 bits as ``jax.random.uniform``/``normal``,
and ``permutation``/``choice`` without replacement the same indices as
jax's (colliding sort keys included), for several seeds and shapes (jax
0.9's default ``jax_threefry_partitionable``).  Draws are prefix-stable,
which is why the reference's padded rows leave the real rows' draws
alone.
Tolerance: none; every comparison is bitwise.
"""

import numpy as np
import pytest
import torch

import jax

from h2o_tpu.models.tree.shared_tree import rng_key_to_np as j_key_to_np

from h2o_tpu_torch.models.tree.gbm import GBM
from h2o_tpu_torch.ops import prng

SEEDS = (0, 1, 42, 123456789, 2 ** 31 - 1)


def _words(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_words(seed):
    jk, pk = jax.random.key(seed), prng.key(seed)
    np.testing.assert_array_equal(pk, _words(jk))
    for d in (0, 7, 0x51A7, 2 ** 31 + 5):
        np.testing.assert_array_equal(prng.fold_in(pk, d),
                                      _words(jax.random.fold_in(jk, d)))
    for n in (2, 3):
        js = jax.random.split(jk, n)
        for i, k in enumerate(prng.split(pk, n)):
            np.testing.assert_array_equal(k, _words(js[i]))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (257,), (33, 7), (4, 5, 6)])
def test_uniform_bits(seed, shape):
    k = (3 * seed + 1) % 2 ** 32
    jk = jax.random.fold_in(jax.random.key(seed), k)
    want = np.asarray(jax.random.uniform(jk, shape))
    got = prng.uniform(prng.fold_in(prng.key(seed), k), shape, "cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


def test_uniform_prefix_stable():
    k = prng.split(prng.key(9), 3)[2]
    long = prng.uniform(k, (1000,), "cpu")
    np.testing.assert_array_equal(prng.uniform(k, (10,), "cpu").numpy(),
                                  long[:10].numpy())
    np.testing.assert_array_equal(
        prng.uniform(k, (250, 4), "cpu").reshape(-1).numpy(), long.numpy())


def test_key_round_trip_and_builder_seed():
    jk = jax.random.fold_in(jax.random.key(11), 4)
    pk = prng.fold_in(prng.key(11), 4)
    np.testing.assert_array_equal(prng.rng_key_to_np(pk), j_key_to_np(jk))
    back = prng.rng_key_from_np(prng.rng_key_to_np(pk))
    assert back.dtype == np.uint32
    np.testing.assert_array_equal(back, pk)
    np.testing.assert_array_equal(GBM(device="cpu", seed=5).rng_key(),
                                  prng.key(5))
    drawn = GBM(device="cpu", seed=-1).rng_key()
    assert drawn[0] == 0 and drawn[1] < 2 ** 31
    with pytest.raises(ValueError):
        prng.key(-3)


# -- bits, uniform(minval, maxval), permutation, choice, normal ---------------

@pytest.mark.parametrize("seed", SEEDS)
def test_bits_words(seed):
    jk, pk = jax.random.key(seed), prng.key(seed)
    want = np.asarray(jax.random.bits(jk, (37, 5)))
    got = prng.bits(pk, (37, 5), "cpu")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", [(0.3, 1.7), (-2.5, 3.1), (-1.0, 1.0)])
def test_uniform_range_bits(seed, lo, hi):
    """XLA fuses ``floats * (hi - lo) + lo`` into one FMA on the CPU; the
    port's float64 product rounded once gives the same bits."""
    jk = jax.random.fold_in(jax.random.key(seed), 5)
    want = np.asarray(jax.random.uniform(jk, (4000,), minval=lo, maxval=hi))
    got = prng.uniform(prng.fold_in(prng.key(seed), 5), (4000,), "cpu",
                       lo, hi).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 7, 256, 1625, 1626, 200_000])
def test_permutation_and_choice(seed, n):
    """jax's sort-based shuffle: one round up to n = 1,625, two above."""
    jk, pk = jax.random.key(seed), prng.key(seed)
    want = np.asarray(jax.random.permutation(jk, n))
    got = prng.permutation(pk, n, "cpu").numpy()
    np.testing.assert_array_equal(got, want)
    s = min(n, 256)
    np.testing.assert_array_equal(
        prng.choice(pk, n, s, "cpu").numpy(),
        np.asarray(jax.random.choice(jk, n, (s,), replace=False)))


def test_permutation_keeps_colliding_keys_in_order():
    """At n = 200,000 the 32-bit sort keys of a round collide; the stable
    sort keeps colliding rows in their order, as ``lax.sort_key_val``."""
    pk = prng.key(3)
    _, sub = prng.split(pk)
    keys = prng.bits(sub, (200_000,), "cpu").numpy()
    assert len(np.unique(keys)) < keys.size          # collisions exist
    np.testing.assert_array_equal(
        prng.permutation(pk, 200_000, "cpu").numpy(),
        np.asarray(jax.random.permutation(jax.random.key(3), 200_000)))
    with pytest.raises(ValueError):
        prng.choice(pk, 5, 6, "cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_bits(seed):
    """XLA's erf_inv on XLA's own log1p (``ops/xlamath.py``), each Horner
    step fused, the square root correctly rounded.  Tolerance: none."""
    jk, pk = jax.random.key(seed), prng.key(seed)
    want = np.asarray(jax.random.normal(jk, (300, 40)))
    got = prng.normal(pk, (300, 40), "cpu").numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
