"""The port's threefry PRNG held against jax's bit for bit.

``key``/``fold_in``/``split`` give the same 32-bit words as
``jax.random.key_data`` of jax's keys, and ``uniform`` the same float32
bits as ``jax.random.uniform``, for several seeds and shapes (jax 0.9's
default ``jax_threefry_partitionable``).  Draws are prefix-stable, which
is why the reference's padded rows leave the real rows' draws alone.
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
