"""Port split finding and forest scoring held against h2o_tpu on the CPU.

``find_splits`` gets one random (L, C, B+1, 4) table with numeric and
categorical columns: the discrete choices (column, split bucket, NA
direction, bitset, do_split) are equal and the child stats agree to
rtol 1e-6.  Every table entry is a multiple of 1/16 well below 2^20,
so the float32 prefix sums are exact whatever order either side sums
in, and the table's gains are spread wide, so no choice is a near-tie.
``forest_score`` scores a forest trained by h2o_tpu, carried across
unchanged, and must give the reference's sums."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h2o_tpu.models.tree import shared_tree as jst

from h2o_tpu_torch.models.tree import shared_tree as pst
from h2o_tpu_torch.core.store import unpublish_on_exit


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes gain nothing from intra-op threads, and the suite
    runs several workers at once: keep torch to one CPU thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _table(seed, L=4, C=5, B=10):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 40, size=(L, C, B + 1)).astype(np.float32)
    w[:, :, 3] = 0                                  # an empty bin
    mean = rng.normal(size=(L, C, B + 1)).astype(np.float32) * 2
    wg = (w * mean).astype(np.float32)
    wgg = (w * (mean ** 2 + rng.uniform(0.1, 1, size=w.shape))).astype(
        np.float32)
    wh = (w * rng.uniform(0.2, 0.25, size=w.shape)).astype(np.float32)
    hist = (np.round(np.stack([w, wg, wgg, wh], axis=-1) * 16) /
            16).astype(np.float32)
    is_cat = np.zeros(C, bool)
    is_cat[1] = is_cat[4] = True
    return hist, is_cat


@pytest.mark.parametrize("seed,newton", [(0, False), (1, True)])
def test_find_splits_equal(seed, newton):
    hist, is_cat = _table(seed)
    L, C = hist.shape[:2]
    allowed = np.ones((L, C), bool)
    allowed[2, 0] = False
    want = jst.find_splits(jnp.asarray(hist), jnp.asarray(is_cat),
                           jnp.asarray(allowed), min_rows=10.0,
                           newton=newton)
    got = pst.find_splits(torch.from_numpy(hist), torch.from_numpy(is_cat),
                          torch.from_numpy(allowed), min_rows=10.0,
                          newton=newton)
    for k in ("col", "split_b", "na_left", "bitset", "do_split"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert np.asarray(want["do_split"]).any()
    for side in ("leaf", "left", "right"):
        for s in ("w", "wg", "wh", "wgg"):
            np.testing.assert_allclose(got[side][s].numpy(),
                                       np.asarray(want[side][s]),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{side}.{s}")
    np.testing.assert_allclose(got["gain"].numpy(), np.asarray(want["gain"]),
                               rtol=1e-5)


def test_forest_score_on_reference_forest(cl):
    from h2o_tpu.core.frame import Frame, T_CAT, Vec
    from h2o_tpu.models.tree.gbm import GBM
    rng = np.random.default_rng(4)
    n = 500
    a = rng.normal(size=n).astype(np.float32)
    a[::11] = np.nan
    k = rng.integers(0, 4, size=n).astype(np.int32)
    y = (2 * np.nan_to_num(a) + (k == 2) + 0.1 * rng.normal(size=n)).astype(
        np.float32)
    fr = Frame(["a", "k", "y"], [Vec(a), Vec(k, T_CAT, domain=list("wxyz")),
                                 Vec(y)])
    m = GBM(ntrees=3, max_depth=3, seed=1).train(y="y", training_frame=fr)
    out = {key: (np.asarray(v) if hasattr(v, "shape") else v)
           for key, v in m.output.items()}
    X = np.stack([a, k.astype(np.float32)], axis=1)
    jbins = jst.bin_matrix(jnp.asarray(X), jnp.asarray(out["split_points"]),
                           out["is_cat"], jst.model_fine_na(out))
    want = np.asarray(jst.forest_score_out(jbins, m.output))
    pbins = pst.bin_matrix(torch.from_numpy(X), out["split_points"],
                           out["is_cat"], pst.model_fine_na(out))
    got = pst.forest_score_out(pbins, out).numpy()
    assert got.shape == want.shape == (n, 1)
    np.testing.assert_array_equal(got, want)
