"""``h2o_tpu_torch.core.quantile`` against ``h2o_tpu.core.quantile``.

The same seeded columns go through the reference's ``quantile_vec`` on
the test mesh and the port's with ``device="cpu"``: the results are held
bitwise (float32 brackets, their low ends returned as float64), on the
cases of ``tests/test_compute.py`` (NAs, a scalar probability, the frame
API) and on n = 1 and 2, a constant column, an all-NA column, probs 0
and 1 and negative values.  ``segment_median`` and ``segment_mode`` are
held bitwise against the reference's on the same group codes, mode with
a cardinality above one 1,024-wide pass and count ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o_tpu_torch.core import quantile as tq
from h2o_tpu_torch.core.frame import Frame as TFrame, Vec as TVec

PROBS = [0.001, 0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 0.999]


def _both(x, probs):
    from h2o_tpu.core.frame import Vec
    from h2o_tpu.core.quantile import quantile_vec
    want = quantile_vec(Vec(x), probs)
    got = tq.quantile_vec(TVec(x), probs, device="cpu")
    return got, want


def _columns():
    rng = np.random.default_rng(0)
    nas = rng.uniform(-5, 5, size=5003).astype(np.float32)
    nas[::7] = np.nan
    heavy = rng.standard_t(2, size=4000).astype(np.float32) * 100
    heavy[rng.uniform(size=4000) < 0.01] = np.nan
    return {
        "normal_20000": rng.normal(0, 10, size=20000).astype(np.float32),
        "nas_every_7th": nas,
        "negative": -rng.exponential(3.0, size=3000).astype(np.float32),
        "heavy_tails_1pct_na": heavy,
        "ties": rng.integers(0, 5, size=2500).astype(np.float32),
        "n1": np.array([3.25], np.float32),
        "n2": np.array([-1.5, 7.0], np.float32),
        "constant": np.full(700, 2.5, np.float32),
        "all_na": np.full(64, np.nan, np.float32),
    }


@pytest.mark.parametrize("probs", [PROBS, [0.0, 1.0], [0.5]],
                         ids=["nine", "ends", "median"])
@pytest.mark.parametrize("col", sorted(_columns()))
def test_quantile_vec_bitwise(cl, col, probs):
    got, want = _both(_columns()[col], probs)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_quantile_scalar_prob(cl):
    x = _columns()["nas_every_7th"]
    got, want = _both(x, 0.5)
    assert np.isscalar(got) or np.ndim(got) == 0
    assert got == want
    assert abs(got - np.nanquantile(x, 0.5)) < 0.02


def test_quantile_frame_api(cl):
    from h2o_tpu.core.frame import Frame
    from h2o_tpu.core.quantile import quantile
    rng = np.random.default_rng(1)
    cols = {"a": rng.normal(size=1000), "b": rng.uniform(size=1000),
            "c": np.array(["x", "y"] * 500)}
    want = quantile(Frame.from_dict(cols), [0.1, 0.5, 0.9])
    got = tq.quantile(TFrame.from_dict(cols), [0.1, 0.5, 0.9],
                      device="cpu")
    assert sorted(got) == sorted(want) == ["a", "b"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    one = tq.quantile(TFrame.from_dict(cols), [0.5], columns=["b"],
                      device="cpu")
    np.testing.assert_array_equal(one["b"], want["b"][1:2])


def _groups(rng, n, G):
    inv = rng.integers(0, G, size=n).astype(np.int32)
    ok = rng.uniform(size=n) > 0.15
    ok[inv == G - 1] = False                   # a group with no value
    return inv, ok


@pytest.mark.parametrize("n,G", [(1, 1), (2, 2), (311, 5), (2000, 97)])
def test_segment_median_bitwise(cl, n, G):
    from h2o_tpu.core.quantile import segment_median
    rng = np.random.default_rng(n)
    vals = rng.normal(size=n).astype(np.float32)
    vals[rng.uniform(size=n) < 0.1] = np.nan
    inv, ok = _groups(rng, n, G)
    ok &= ~np.isnan(vals)
    want = np.asarray(segment_median(jnp.asarray(vals), jnp.asarray(ok),
                                     jnp.asarray(inv), n, G))
    got = tq.segment_median(torch.from_numpy(vals), torch.from_numpy(ok),
                            torch.from_numpy(inv).long(), n, G).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("card", [4, 1500])
def test_segment_mode_bitwise(cl, card):
    from h2o_tpu.core.quantile import segment_mode
    rng = np.random.default_rng(card)
    n, G = 600, 9
    codes = np.where(rng.uniform(size=n) < 0.5,
                     rng.integers(0, min(card, 8), size=n),
                     rng.integers(max(card - 8, 0), card, size=n))
    vals = codes.astype(np.float32)
    vals[rng.uniform(size=n) < 0.1] = np.nan
    inv, ok = _groups(rng, n, G)
    ok &= ~np.isnan(vals)
    want = np.asarray(segment_mode(jnp.asarray(vals), jnp.asarray(ok),
                                   jnp.asarray(inv), G, card))
    got = tq.segment_mode(torch.from_numpy(vals), torch.from_numpy(ok),
                          torch.from_numpy(inv).long(), G, card).numpy()
    np.testing.assert_array_equal(got, want)


def test_segment_mode_ties_go_to_the_smallest_code(cl):
    hi = tq._MODE_CHUNK + 3                    # in the second pass
    vals = torch.tensor([2, 2, hi, hi, 5, hi, hi, 7, 7, 7],
                        dtype=torch.float32)
    ok = torch.tensor([1, 1, 1, 1, 1, 1, 1, 0, 0, 0], dtype=torch.bool)
    inv = torch.tensor([0, 0, 0, 0, 1, 1, 1, 2, 2, 2])
    out = tq.segment_mode(vals, ok, inv, 4, tq._MODE_CHUNK + 10).numpy()
    assert out[0] == 2.0 and out[1] == float(hi)
    assert np.isnan(out[2]) and np.isnan(out[3])


def test_quantile_needs_a_device_named_without_cuda(cl, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tq.quantile_vec(TVec(np.arange(5, dtype=np.float32)), 0.5)
