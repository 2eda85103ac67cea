"""Port binning (h2o_tpu_torch.models.tree.shared_tree.prepare_bins /
bin_matrix) held against h2o_tpu's on the CPU: split points and bin
values are equal, for QuantilesGlobal (nbins=20) and UniformAdaptive
(F=1024 fine bins: the port packs them as int16, the reference keeps
int32 off the TPU — the integers must be the same), with NaNs and a
categorical column in the data."""

import numpy as np
import pytest
import torch

from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models.model import DataInfo as JDataInfo
from h2o_tpu.models.tree import shared_tree as jst

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.model import DataInfo
from h2o_tpu_torch.models.tree import shared_tree as pst

pytestmark = pytest.mark.shared_dkv


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes gain nothing from intra-op threads, and the suite
    runs several workers at once: keep torch to one CPU thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _columns(seed=3, n=700):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=n).astype(np.float32)
    a[rng.uniform(size=n) < 0.07] = np.nan
    b = rng.exponential(size=n).astype(np.float32)
    c = np.round(rng.uniform(-3, 3, size=n), 1).astype(np.float32)  # ties
    k = rng.integers(-1, 6, size=n).astype(np.int32)                 # -1 = NA
    y = rng.normal(size=n).astype(np.float32)
    return a, b, c, k, y


def _frames():
    a, b, c, k, y = _columns()
    dom = list("pqrstu")
    jf = JFrame(["a", "b", "c", "k", "y"],
                [JVec(a), JVec(b), JVec(c), JVec(k, J_CAT, domain=dom),
                 JVec(y)])
    pf = Frame(["a", "b", "c", "k", "y"],
               [Vec(a), Vec(b), Vec(c), Vec(k, T_CAT, domain=dom), Vec(y)])
    return jf, pf


@pytest.mark.parametrize("hist_type,nbins,expect_dtype", [
    ("QuantilesGlobal", 20, torch.uint8),
    ("UniformAdaptive", 20, torch.int16),
])
def test_prepare_bins_equal(cl, hist_type, nbins, expect_dtype):
    jf, pf = _frames()
    x = ["a", "b", "c", "k"]
    jb = jst.prepare_bins(JDataInfo(jf, x, "y", mode="tree"), nbins, 1024,
                          hist_type, 1024)
    pb = pst.prepare_bins(DataInfo(pf, x, "y", torch.device("cpu")), nbins,
                          1024, hist_type, 1024)
    assert (pb.nbins, pb.fine_nbins) == (jb.nbins, jb.fine)
    np.testing.assert_array_equal(pb.is_cat, np.asarray(jb.is_cat))
    np.testing.assert_array_equal(pb.split_points,
                                  np.asarray(jb.split_points))
    assert pb.bins.dtype == expect_dtype
    n = pf.nrows
    np.testing.assert_array_equal(
        pb.bins.to(torch.int32).numpy(),
        np.asarray(jb.bins)[:n].astype(np.int32))
    # NaN and the categorical NA code both land in the NA bucket F
    F = pb.fine_nbins
    assert (pb.bins[:, 0].to(torch.int32) == F).any()
    assert (pb.bins[:, 3].to(torch.int32) == F).any()


def test_bin_matrix_scoring_rows_equal(cl):
    """Rows never seen in training (values outside the fitted range,
    NaNs) bin identically against the same split points."""
    jf, pf = _frames()
    x = ["a", "b", "c", "k"]
    jb = jst.prepare_bins(JDataInfo(jf, x, "y", mode="tree"), 20, 1024,
                          "UniformAdaptive", 1024)
    rng = np.random.default_rng(9)
    m = (rng.normal(size=(64, 4)) * 5).astype(np.float32)
    m[:, 3] = rng.integers(0, 6, size=64)
    m[::7] = np.nan
    import jax.numpy as jnp
    want = np.asarray(jst.bin_matrix(jnp.asarray(m),
                                     jnp.asarray(jb.split_points),
                                     np.asarray(jb.is_cat), jb.fine))
    got = pst.bin_matrix(torch.from_numpy(m), np.asarray(jb.split_points),
                         np.asarray(jb.is_cat), jb.fine)
    np.testing.assert_array_equal(got.to(torch.int32).numpy(),
                                  want.astype(np.int32))
