"""``h2o_tpu_torch.core.mrtask`` and ``Vec.map_inplace`` against
``h2o_tpu.core.mrtask``.

The same seeded arrays go through the reference on the test mesh (its
map runs per shard and the partials reduce over the mesh) and through
the port with ``device="cpu"`` (one device: the reduce is the
identity).  Min and max are held bitwise, sums at rtol 1e-5 (the mesh
adds per-shard partials in another order), elementwise maps bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o_tpu_torch.core import mrtask as tmr
from h2o_tpu_torch.core.frame import T_CAT, T_TIME
from h2o_tpu_torch.core.frame import Frame as TFrame, Vec as TVec


def _x():
    return np.random.default_rng(42).normal(size=(1000, 3)).astype(
        np.float32)


def _ref_matrix_and_mask(x):
    from h2o_tpu.core.cloud import cloud
    from h2o_tpu.core.frame import Frame
    fr = Frame.from_numpy(x)
    mask = np.arange(fr.padded_rows) < fr.nrows
    return fr.as_matrix(), cloud().device_put_rows(mask)


def _j_colsum(shard, mask):
    return jnp.sum(jnp.where(mask[:, None], shard, 0.0), axis=0)


def _j_colmin(shard, mask):
    return jnp.min(jnp.where(mask[:, None], shard, jnp.inf), axis=0)


def _j_colmax(shard, mask):
    return jnp.max(jnp.where(mask[:, None], shard, -jnp.inf), axis=0)


_PORT = {"sum": lambda x: torch.sum(x, dim=0),
         "min": lambda x: torch.amin(x, dim=0),
         "max": lambda x: torch.amax(x, dim=0)}
_REF = {"sum": _j_colsum, "min": _j_colmin, "max": _j_colmax}


@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
def test_map_reduce_matches_the_reference(cl, reduce):
    from h2o_tpu.core.mrtask import map_reduce
    x = _x()
    m, msk = _ref_matrix_and_mask(x)
    want = np.asarray(map_reduce(_REF[reduce], m, msk, reduce=reduce))
    got = tmr.map_reduce(_PORT[reduce], x, reduce=reduce,
                         device="cpu").numpy()
    if reduce == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-5)
        np.testing.assert_allclose(got, x.sum(axis=0), rtol=1e-4)
    else:
        np.testing.assert_array_equal(got, want)


def _j_gram(shard, mask, scale):
    z = jnp.where(mask[:, None], shard, 0.0) * scale
    return {"gram": z.T @ z, "n": jnp.sum(mask.astype(jnp.float32))}


def test_map_reduce_pytree_and_extra_args(cl):
    from h2o_tpu.core.mrtask import map_reduce
    x = _x()
    m, msk = _ref_matrix_and_mask(x)
    want = map_reduce(_j_gram, m, msk, extra_args=(jnp.float32(0.5),))

    def gram(z, scale):
        z = z * scale
        return {"gram": z.T @ z,
                "n": torch.tensor(float(z.shape[0]))}

    got = tmr.map_reduce(gram, x, extra_args=(0.5,), device="cpu")
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["gram"].numpy(),
                               np.asarray(want["gram"]), rtol=1e-5,
                               atol=1e-3)
    assert float(got["n"]) == float(want["n"]) == 1000.0
    out = tmr.map_reduce(lambda a, b: (a.sum(), [b.amax()]), x[:, 0],
                         x[:, 1], device="cpu")
    assert isinstance(out, tuple) and isinstance(out[1], list)
    assert float(out[1][0]) == float(x[:, 1].max())


def test_unknown_reduce_raises_as_the_reference(cl):
    from h2o_tpu.core.mrtask import map_reduce
    m, msk = _ref_matrix_and_mask(_x())
    with pytest.raises(KeyError):
        map_reduce(_j_colsum, m, msk, reduce="mean")
    with pytest.raises(KeyError):
        tmr.map_reduce(_PORT["sum"], _x(), reduce="mean", device="cpu")


def test_a_tensor_on_another_device_raises():
    with pytest.raises(ValueError, match="meta"):
        tmr.map_reduce(_PORT["sum"], torch.empty(3, 2, device="meta"),
                       device="cpu")


def _j_affine(m):
    return m * 2.0 + 1.0


def test_map_frame_bitwise(cl):
    from h2o_tpu.core.frame import Frame
    from h2o_tpu.core.mrtask import map_frame
    x = _x()
    want = np.asarray(map_frame(_j_affine, Frame.from_numpy(x),
                                ["C1", "C3"]))[:1000]
    got = tmr.map_frame(lambda t: t * 2.0 + 1.0, TFrame.from_numpy(x),
                        ["C1", "C3"], device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def _j_signed_square(a):
    return jnp.abs(a) * a


def test_mutate_array_and_device_sum(cl):
    from h2o_tpu.core.mrtask import device_sum, mutate_array
    x = _x()[:, 0].copy()
    want = np.asarray(mutate_array(_j_signed_square, jnp.asarray(x)))
    got = tmr.mutate_array(lambda t: t.mul_(torch.abs(t)), x.copy(),
                           device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        float(tmr.device_sum(x, device="cpu")),
        float(device_sum(jnp.asarray(x))), rtol=1e-5)


def test_row_mask_shard(cl):
    from h2o_tpu.core.mrtask import row_mask_shard
    np.testing.assert_array_equal(
        tmr.row_mask_shard(64, 41, device="cpu").numpy(),
        np.asarray(row_mask_shard(64, 41)))


def _j_clip1(c):
    return jnp.minimum(c, 1)


@pytest.mark.parametrize("kind", ["numeric", "categorical"])
def test_vec_map_inplace_bitwise(cl, kind):
    from h2o_tpu.core.frame import T_CAT as R_CAT, Vec
    rng = np.random.default_rng(3)
    if kind == "numeric":
        x = rng.normal(size=300).astype(np.float32)
        x[::11] = np.nan
        ref, port = Vec(x), TVec(x.copy())
        ref_fn, port_fn = _j_affine, (lambda t: t * 2.0 + 1.0)
    else:
        c = rng.integers(-1, 3, size=300).astype(np.int32)
        dom = ["a", "b", "c"]
        ref, port = Vec(c, R_CAT, domain=dom), TVec(c.copy(), T_CAT,
                                                     domain=dom)
        ref_fn, port_fn = _j_clip1, (lambda t: torch.clamp_max(t, 1))
    before = port.rollups.mean
    ref.map_inplace(ref_fn)
    port.map_inplace(port_fn, device="cpu")
    np.testing.assert_array_equal(port.to_numpy(), ref.to_numpy())
    assert port.to_numpy().dtype == ref.to_numpy().dtype
    assert port.rollups.mean != before           # the rollups were dropped
    assert port.rollups.mean == pytest.approx(ref.rollups.mean, rel=1e-6)


def test_vec_map_inplace_refuses_time(cl):
    from h2o_tpu.core.frame import T_TIME as R_TIME, Vec
    ms = np.arange(5, dtype=np.float64) * 1e3
    with pytest.raises(AssertionError, match="T_TIME"):
        Vec(ms, R_TIME).map_inplace(_j_affine)
    with pytest.raises(ValueError, match="T_TIME"):
        TVec(ms, T_TIME).map_inplace(lambda t: t + 1, device="cpu")
