"""The port's quantized stats held against ``h2o_tpu.ops.statpack``.

``stats_qmax`` is equal, and so is the padded row count it is taken
from: the reference pads rows to ``n_nodes * row_align`` (1,024 on the
8-node test mesh with its default alignment of 128, 128 on one device).
``quantize_stats`` draws the same noise (the PRNG is bitwise jax's) and
computes what XLA compiles on the CPU: a true ``qmax / m``, ``m / qmax``
as a multiply by the reciprocal, and ``stats * scale + u`` as one fused
multiply-add (the port rounds the float64 result once).  So every
quantized value and every ``1/scale`` is equal (200,000 x 4 normal
stats, int16 carrier; 50,000 x 4, int8).  ``dequant_table`` and
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


@pytest.mark.parametrize("quantum,padded,qmax", [(1024, 1_000_448, 2146),
                                                 (128, 1_000_064, 2147)])
def test_stats_qmax_of_padded_rows(quantum, padded, qmax):
    """1,000,000 rows: the 8-node mesh pads to 1,000,448 and takes
    qmax 2,146; one device pads to 1,000,064 and takes 2,147."""
    assert psp.padded_rows(1_000_000, quantum) == padded
    assert psp.stats_qmax(psp.padded_rows(1_000_000, quantum), "int16") == \
        jsp.stats_qmax(padded, "int16") == qmax
    assert psp.padded_rows(1_000_000) == 1_000_064
    assert psp.padded_rows(1024, quantum) == 1024


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
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    assert np.abs(pq.numpy()).max() <= qmax
    assert _ulps(np.asarray(jinv), pinv.numpy()).max() == 0
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
