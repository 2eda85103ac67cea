"""The port's quantized stats held against ``h2o_tpu.ops.statpack``.

``stats_qmax`` is equal.  ``quantize_stats`` draws the same noise (the
PRNG is bitwise jax's), but XLA on the CPU compiles ``qmax / m`` into a
multiply by a reciprocal and ``stats * scale + u`` into a fused
multiply-add, where torch divides and rounds each step as IEEE float32
does, on the CPU and on CUDA alike.  So the stated tolerance: every
quantized value within one step of the reference's and at least
99.99 % of them equal (200,000 x 4 normal stats, int16 carrier), and
``1/scale`` within one float32 ulp.  ``dequant_table`` and
``widen_stats`` are plain casts and must be equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from h2o_tpu.ops import statpack as jsp

from h2o_tpu_torch.ops import prng
from h2o_tpu_torch.ops import statpack as psp


@pytest.mark.parametrize("dt", ["int16", "int8"])
@pytest.mark.parametrize("rows", [1, 600, 65_536, 65_537, 1_000_000,
                                  1_000_448, 2 ** 31])
def test_stats_qmax_equal(rows, dt):
    assert psp.stats_qmax(rows, dt) == jsp.stats_qmax(rows, dt)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.astype(np.float32).view(np.int32).astype(np.int64) -
                  b.astype(np.float32).view(np.int32).astype(np.int64))


@pytest.mark.parametrize("dt,rows", [("int16", 200_000), ("int8", 50_000)])
def test_quantize_stats_within_one_step(dt, rows):
    rng = np.random.default_rng(3)
    stats = rng.normal(size=(rows, 4)).astype(np.float32)
    stats[:, 0] = 1.0
    stats[rng.uniform(size=rows) < 0.1] = 0.0
    qmax = jsp.stats_qmax(rows, dt)
    jq, jinv = jax.jit(lambda s, k: jsp.quantize_stats(s, k, dt, qmax))(
        jnp.asarray(stats), jax.random.key(7))
    pq, pinv = psp.quantize_stats(torch.from_numpy(stats), prng.key(7), dt,
                                  qmax)
    assert pq.dtype == psp.stats_qdtype(dt) and pinv.dtype == torch.float32
    d = np.abs(np.asarray(jq).astype(np.int32) -
               pq.numpy().astype(np.int32))
    assert d.max() <= 1
    assert (d == 0).mean() >= 0.9999
    assert np.abs(pq.numpy()).max() <= qmax
    assert _ulps(np.asarray(jinv), pinv.numpy()).max() <= 1
    # unbiased rounding: the dequantized stats sum close to the exact sums
    deq = pq.numpy().astype(np.float64) * pinv.numpy()
    step = pinv.numpy().astype(np.float64)
    assert (np.abs(deq - stats) < step).all()


def test_dequant_and_widen():
    rng = np.random.default_rng(5)
    table = rng.integers(-2 ** 30, 2 ** 30, size=(3, 4, 6, 4)).astype(
        np.int32)
    inv = np.array([1e-4, 3e-5, 7e-6, 1.0], np.float32)
    want = np.asarray(jsp.dequant_table(jnp.asarray(table),
                                        jnp.asarray(inv)))
    got = psp.dequant_table(torch.from_numpy(table), torch.from_numpy(inv))
    np.testing.assert_array_equal(got.numpy(), want)
    q = rng.integers(-127, 128, size=(50, 4)).astype(np.int8)
    np.testing.assert_array_equal(
        psp.widen_stats(torch.from_numpy(q)).numpy(),
        np.asarray(jsp.widen_stats(jnp.asarray(q))))
    with pytest.raises(ValueError):
        psp.stats_qmax(10, "int4")
