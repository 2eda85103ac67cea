"""The port's copy of XLA's CPU float32 arithmetic held against jax on
the CPU: ``log`` and ``log1p`` equal ``jax.numpy.log``/``log1p`` bit for
bit, ``fma`` equals XLA's fused ``a * b + c``, and ``sum_leading`` sums
a leading axis in the order ``jnp.sum(axis=0)`` does, for 1 to 1,500
terms, and ``cumsum`` is ``jnp.cumsum``'s blocked float32 scan for 1 to
4,096 terms and longer padded lengths.  Tolerance: none; every comparison is bitwise."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from h2o_tpu_torch.ops import xlamath as xm


def _bits_equal(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))


@pytest.mark.parametrize("lo,hi", [(-13, -3), (-3, 0), (0, 2), (2, 13)])
def test_log_bits(lo, hi):
    x = (10.0 ** np.random.default_rng(lo + 20).uniform(
        lo, hi, 200_000)).astype(np.float32)
    _bits_equal(xm.log(torch.from_numpy(x)), jax.jit(jnp.log)(x))


def test_log_edges():
    x = np.array([0.0, -1.0, np.inf, np.nan, 1.0, 1e-38], np.float32)
    got = xm.log(torch.from_numpy(x)).numpy()
    assert got[0] == -np.inf and np.isnan(got[1]) and got[2] == np.inf
    assert np.isnan(got[3]) and got[4] == 0.0 and np.isfinite(got[5])


def test_log1p_bits():
    u = np.random.default_rng(1).uniform(-1, 1, 300_000).astype(np.float32)
    a = np.concatenate([-u * u, u]).astype(np.float32)
    _bits_equal(xm.log1p(torch.from_numpy(a)), jax.jit(jnp.log1p)(a))


def test_fma_is_xlas_fused_multiply_add():
    rng = np.random.default_rng(2)
    a, b, c = (rng.normal(size=50_000).astype(np.float32) for _ in range(3))
    want = jax.jit(lambda p, q, r: p * q + r)(a, b, c)
    _bits_equal(xm.fma(*(torch.from_numpy(v) for v in (a, b, c))), want)


@pytest.mark.parametrize("T", [1, 2, 31, 32, 33, 50, 100, 1500])
def test_sum_leading_order(T):
    v = np.random.default_rng(T).uniform(0, 1, (T, 2, 700)).astype(
        np.float32)
    _bits_equal(xm.sum_leading(torch.from_numpy(v)),
                jax.jit(lambda a: jnp.sum(a, axis=0))(v))
    assert xm.sum_leading(torch.zeros((0, 3))).shape == (3,)


@pytest.mark.parametrize("n", list(range(1, 70)) + [255, 256, 257, 960,
                                                    1000, 1024, 4095, 4096,
                                                    4097, 65_536, 1_048_576])
def test_cumsum_order(n):
    """jax's CPU cumsum is XLA's reduce-window scan rewritten at base 16:
    it differs from a sequential prefix sum from about the 17th term."""
    x = np.random.default_rng(n).uniform(0, 1, n).astype(np.float32)
    _bits_equal(xm.cumsum(torch.from_numpy(x)), jax.jit(jnp.cumsum)(x))
    if n > 40:
        assert not np.array_equal(np.cumsum(x), np.asarray(
            jax.jit(jnp.cumsum)(x)))
