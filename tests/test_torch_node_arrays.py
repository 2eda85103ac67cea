"""Per-node split gains (``node_gain``) and training covers (``node_w``)
held against ``h2o_tpu``'s on the CPU.

Both engines emit them: the dense heap (a weighted GBM, XGBoost), the
sparse frontier capped at 16 live leaves (a depth-8 DRF; the
reference's ``H2O_TPU_MAX_LIVE_LEAVES`` and the port's
``engine.MAX_LIVE_LEAVES``) and K class trees an iteration (a 3-class
GBM).  Weights are on a 1/8 grid and DRF's stats are 0/1, so every
histogram sums exactly in either package, and ``node_w`` is equal
bit for bit.  The gradient stats' tables are summed in another order in
each package, so the GBMs' trees are held where that rounding leaves
them determined (``hold_gbm_forest`` in
``tests/test_torch_find_splits_order.py``): a split that differs must
send the node's rows the same way or tie with the reference's within
F3's rounding level, 1e-6 of the node's wgg, and a tie's subtree and
later iterations are not held (the 3-class GBM ties at tree 0).  The
DRF's and XGBoost's trees are equal.  ``node_gain`` agrees to 1e-5
relative (atol 1e-6) at every node held, but where a GBM's gain cancels
below 0.1 of its node's wgg: its float32 rounding there, up to 1e-6 of
wgg, exceeds that, so it is held within 1e-6 of wgg.  A forest trained
in blocks (``score_tree_interval=1``) and one resumed from a checkpoint
carry the same arrays as one trained in one call, and the converters
keep the reference's arrays, so a JAX model resumed in the port keeps
them for its own trees.
"""

import numpy as np
import pytest
import torch

from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models.tree.drf import DRF as JDRF
from h2o_tpu.models.tree.gbm import GBM as JGBM
from h2o_tpu.models.tree.xgboost import XGBoost as JXGB

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.tree import engine
from h2o_tpu_torch.models.tree.convert import (drf_from_jax_output,
                                               gbm_from_jax_output,
                                               xgboost_from_jax_output)
from h2o_tpu_torch.models.tree.drf import DRF
from h2o_tpu_torch.models.tree.gbm import GBM
from h2o_tpu_torch.models.tree.xgboost import XGBoost
from tests.test_torch_find_splits_order import TIE, hold_gbm_forest

pytestmark = pytest.mark.shared_dkv

CAP = 16
_NAMES = ["a", "b", "c", "d", "k", "w", "y"]
_TREE_KEYS = ("split_col", "thr_bin", "na_left", "bitset", "child")

CASES = {
    "gbm_dense": (JGBM, GBM, gbm_from_jax_output,
                  dict(ntrees=3, max_depth=4, weights_column="w"), 2, 0),
    "drf_frontier16": (JDRF, DRF, drf_from_jax_output,
                       dict(ntrees=3, max_depth=8), 2, CAP),
    "gbm_multinomial": (JGBM, GBM, gbm_from_jax_output,
                        dict(ntrees=2, max_depth=3), 3, 0),
    "xgboost": (JXGB, XGBoost, xgboost_from_jax_output,
                dict(ntrees=3, max_depth=3), 2, 0),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(nclass: int, n=600, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    X[rng.uniform(size=n) < 0.05, 1] = np.nan
    cat = rng.integers(0, 5, n).astype(np.int32)
    w = (rng.integers(4, 17, n) / 8).astype(np.float32)
    logit = (1.5 * X[:, 0] - X[:, 2] + 0.8 * (cat % 2) +
             0.5 * np.nan_to_num(X[:, 1]))
    if nclass == 2:
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.int32)
    else:
        y = np.digitize(logit + rng.logistic(size=n), [-1.0, 1.0]).astype(
            np.int32)
    dom = [f"c{k}" for k in range(nclass)]
    jv = [JVec(X[:, j]) for j in range(4)] + [
        JVec(cat, J_CAT, domain=list("vwxyz")), JVec(w),
        JVec(y, J_CAT, domain=dom)]
    pv = [Vec(X[:, j]) for j in range(4)] + [
        Vec(cat, T_CAT, domain=list("vwxyz")), Vec(w),
        Vec(y, T_CAT, domain=dom)]
    return JFrame(_NAMES, jv), Frame(_NAMES, pv)


def _x(kw):
    return [c for c in _NAMES[:-1] if c != "w" or "weights_column" in kw]


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, cl):
    jcls, pcls, conv, kw, nclass, cap = CASES[request.param]
    jf, pf = _frames(nclass)
    kw = dict(kw, seed=1)
    with pytest.MonkeyPatch.context() as mp:
        if cap:
            mp.setenv("H2O_TPU_MAX_LIVE_LEAVES", str(cap))
            mp.setattr(engine, "MAX_LIVE_LEAVES", cap)
        jm = jcls(**kw).train(x=_x(kw), y="y", training_frame=jf)
        pm = pcls(device="cpu", **kw).train(x=_x(kw), y="y",
                                            training_frame=pf)
        blk = pcls(device="cpu", score_tree_interval=1, **kw).train(
            x=_x(kw), y="y", training_frame=pf)
        first = pcls(device="cpu", **dict(kw, ntrees=1)).train(
            x=_x(kw), y="y", training_frame=pf)
        res = pcls(device="cpu", checkpoint=first, **kw).train(
            x=_x(kw), y="y", training_frame=pf)
        out = {k: (np.asarray(v) if hasattr(v, "shape") else v)
               for k, v in jm.output.items()}
        conv_m = conv(out, jm.params, device="cpu")
        resumed_conv = pcls(device="cpu", checkpoint=conv_m,
                            **dict(kw, ntrees=kw["ntrees"] + 1)).train(
            x=_x(kw), y="y", training_frame=pf)
    return dict(name=request.param, jm=jm, pm=pm, blk=blk, res=res,
                conv=conv_m, resumed_conv=resumed_conv, kw=kw, frame=pf)


def test_node_arrays_equal_reference(case):
    jo = {k: (np.asarray(v) if hasattr(v, "shape") else v)
          for k, v in case["jm"].output.items()}
    po = case["pm"].output
    nw, ng = po["node_w"], po["node_gain"]
    assert nw.dtype == np.float32 and nw.shape == po["split_col"].shape
    assert ng.shape == po["split_col"].shape
    if case["name"].startswith("gbm"):
        pf = case["frame"]
        w = (pf.vec("w").to_numpy().astype(np.float64)
             if "weights_column" in case["kw"] else np.ones(pf.nrows))
        keep, wgg, ties = hold_gbm_forest(
            case["pm"], jo, case["jm"].params, pf,
            pf.vec("y").to_numpy().astype(np.int64), w)
        assert keep[0].sum() > 10
        T = keep.shape[0]
        tol = np.maximum(1e-6 + 1e-5 * np.abs(jo["node_gain"][:T]),
                         np.where(jo["node_gain"][:T] < 0.1 * wgg,
                                  TIE * wgg, 0.0))
    else:
        for k in _TREE_KEYS:
            if po.get(k) is None:
                assert jo.get(k) is None, k
                continue
            np.testing.assert_array_equal(po[k], jo[k], err_msg=k)
        keep = np.ones(ng.shape, bool)
        T = keep.shape[0]
        tol = 1e-6 + 1e-5 * np.abs(jo["node_gain"])
    np.testing.assert_array_equal(nw[:T][keep], jo["node_w"][:T][keep])
    gap = np.abs(ng[:T] - jo["node_gain"][:T])
    assert (gap[keep] <= tol[keep]).all(), (gap - tol).max()
    split = po["split_col"] >= 0
    assert split.sum() > 5 and (ng[split] > 0).all() and \
        (ng[~split] == 0).all()
    # a split node's cover is its children's
    assert (nw[..., 0] > 0).all()


def test_blocks_and_resume_keep_node_arrays(case):
    one = case["pm"].output
    for other in (case["blk"].output, case["res"].output):
        for k in ("node_gain", "node_w") + _TREE_KEYS:
            if one.get(k) is None:
                continue
            np.testing.assert_array_equal(other[k], one[k], err_msg=k)


def test_converter_keeps_node_arrays(case):
    jo = case["jm"].output
    co = case["conv"].output
    for k in ("node_gain", "node_w"):
        np.testing.assert_array_equal(co[k], np.asarray(jo[k]), err_msg=k)
    # resumed in the port: the reference's arrays first, then the new
    # tree's own
    ro = case["resumed_conv"].output
    T = np.asarray(jo["split_col"]).shape[0]
    assert ro["node_w"].shape[0] == T + 1
    for k in ("node_gain", "node_w"):
        np.testing.assert_array_equal(ro[k][:T], np.asarray(jo[k]),
                                      err_msg=k)
    assert (ro["node_w"][T, :, 0] > 0).all()


def test_save_load_keeps_node_arrays(case, tmp_path):
    from h2o_tpu_torch.models.model import Model
    po = case["pm"].output
    lo = Model.load(case["pm"].save(str(tmp_path / "m.bin")),
                    device="cpu").output
    for k in ("node_gain", "node_w"):
        np.testing.assert_array_equal(lo[k], po[k], err_msg=k)
