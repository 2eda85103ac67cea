"""F5: ``find_splits`` takes its per-bin prefix sums in XLA's order.

The reference's ``jnp.cumsum(x, axis=2)`` over the sorted bins is XLA's
CPU scan (blocks of 16, the block totals scanned the same way); a
sequential float32 scan, ``torch.cumsum`` on the CPU (wider than
float32) and CUDA's parallel scan each round the sums differently, and
where two split candidates tie in exact arithmetic each package then
picked another.  The port's ``xlamath.cumsum`` is XLA's order on
every device; it is used in ``find_splits`` and GLM's ordinal
thresholds.

Held here, on the CPU:

- ``xlamath.cumsum`` against ``jnp.cumsum(axis=-1)``, bitwise, at lengths
  1 to 1,025 over (3, 5, n) arrays, and ``torch.cumsum``'s difference
  from it (the fault this repairs);
- a GBM (ntrees 3, seed 1) on 600 rows (seed 3): x0-x2 normal, 5 % NaN
  in x1, a 4-level categorical with 5 % NA codes, ``y = [x0 + (c == 2)
  + noise > 0]``, at max_depth 5 and 3, with and without the NaN cells:
  ``split_col``/``thr_bin``/``na_left``/``bitset`` equal to
  ``h2o_tpu``'s at every node but F3's rounding nodes (gain below 1e-6
  of the node's sum of squared gradients, where both engines split a
  pure node on float32 residues) and their subtrees, and p1 within
  1e-5.  With ``torch.cumsum`` the max_depth-5 case parted by 0.0174 in
  p1 and the max_depth-3 case without NaN cells split at other fine
  bins;
- an ordinal GLM with 6 classes: its thresholds (the first one plus 4
  softplus increments in XLA's order, the softplus in XLA's ``exp`` and
  ``log1p``: ``xlamath.softplus``) from the same params bitwise the
  reference's; ``xlamath.exp`` and ``softplus`` bitwise ``jax.numpy``'s;
- UpliftDRF's prefix sums (``uplift.py``) stay ``torch.cumsum``: a
  probe of 12 KL forests on 800 rows, with and without fractional
  weights, found no tree that it decided otherwise than XLA's order
  (0/1 counts sum exactly in any order); the weighted case is held here;
- ``hold_gbm_forest``, which the node-array and CV tests share, holds a
  GBM's trees against the reference's where the two packages' table
  sums (added in different orders) leave them determined.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models.tree.gbm import GBM as JGBM

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.tree.convert import gbm_from_jax_output
from h2o_tpu_torch.models.tree.gbm import GBM
from h2o_tpu_torch.ops import xlamath
from h2o_tpu_torch.core.store import unpublish_on_exit


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv

_NAMES = ["x0", "x1", "x2", "c", "y"]


@pytest.mark.parametrize("n", [1, 2, 3, 16, 17, 20, 256, 1025])
def test_cumsum_is_xla_order(n):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(3, 5, n)) *
         rng.uniform(0.1, 100.0, size=(3, 5, n))).astype(np.float32)
    got = xlamath.cumsum(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1))
    np.testing.assert_array_equal(got, want)
    # a vector alone scans alike
    np.testing.assert_array_equal(
        xlamath.cumsum(torch.from_numpy(x[1, 2])).numpy(), want[1, 2])


def test_torch_cumsum_parts_from_the_third_term():
    """The fault: ``torch.cumsum`` differs from XLA's scan in many
    vectors from length 3 on."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(200, 8)).astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1))
    got = torch.cumsum(torch.from_numpy(x), dim=-1).numpy()
    assert np.array_equal(got[:, :2], want[:, :2])
    assert (got[:, 2:] != want[:, 2:]).any(axis=1).sum() > 50


def _frames(nan_cells: bool):
    rng = np.random.default_rng(3)
    n = 600
    X = rng.normal(size=(n, 3)).astype(np.float32)
    if nan_cells:
        X[rng.uniform(size=n) < 0.05, 1] = np.nan
    c = rng.integers(0, 4, n).astype(np.int32)
    c[rng.uniform(size=n) < 0.05] = -1
    y = (X[:, 0] + (c == 2) + rng.normal(size=n) > 0).astype(np.int32)
    dom = list("abcd")
    jf = JFrame(_NAMES, [JVec(X[:, j]) for j in range(3)] +
                [JVec(c, J_CAT, domain=dom),
                 JVec(y, J_CAT, domain=["0", "1"])])
    pf = Frame(_NAMES, [Vec(X[:, j]) for j in range(3)] +
               [Vec(c, T_CAT, domain=dom), Vec(y, T_CAT, domain=["0", "1"])])
    return jf, pf, y


def node_rows(ids, m: int) -> np.ndarray:
    """Mask of the dense-heap node ids (a row's leaf) that lie under
    node ``m`` or are ``m``."""
    a = np.asarray(ids, np.int64).copy()
    while (a > m).any():
        a = np.where(a > m, (a - 1) // 2, a)
    return a == m


# -- held where determined: the forest against the reference's ----------------

# F3's rounding level: a node's candidate gains come from float32 table
# sums over its rows, rounded at ~1e-6 of its sum of squared gradients
# (wgg), so gains within TIE * wgg of each other tie at that rounding
TIE = 1e-6


def _leaf_ids(model, frame) -> np.ndarray:
    lf = model.predict_leaf_node_assignment(frame, "Node_ID")
    return np.stack([v.to_numpy() for v in lf.vecs], 1).astype(np.int64)


def tree_grads(model, frame, y) -> np.ndarray:
    """(T, K, R) float64: per iteration, the residuals a binomial or
    multinomial GBM's trees fit (the response's indicator less the
    probability before the iteration), from ``model``'s staged
    probabilities."""
    out = model.output
    T, K = out["split_col"].shape[:2]
    f0 = np.asarray(out["f0"], np.float64).reshape(-1)
    col = [v.to_numpy().astype(np.float64)
           for v in model.staged_predict_proba(frame).vecs]
    if K == 1:                               # a binomial stage holds p0
        p = [np.full(len(y), 1 / (1 + np.exp(-f0[0])))] + [
            1.0 - col[t] for t in range(T - 1)]
        return np.stack([(y - pt)[None] for pt in p])
    e = np.exp(f0 - f0.max())
    p = [np.broadcast_to((e / e.sum())[:, None], (K, len(y)))] + [
        np.stack(col[t * K:(t + 1) * K]) for t in range(T - 1)]
    onehot = (y[None, :] == np.arange(K)[:, None]).astype(np.float64)
    return np.stack([onehot - pt for pt in p])


def _se(w, g):
    sw, swg = w.sum(), (w * g).sum()
    return (w * g * g).sum() - (swg * swg / sw if sw > 0 else 0.0)


def hold_gbm_forest(pm, jout, jparams, frame, y, w,
                    keys=("split_col", "thr_bin", "na_left", "bitset")):
    """Hold a port GBM's dense-heap trees against the reference's
    (``jout``, its output as numpy) on the rows it trained on.

    The two packages sum a histogram table in different orders, so a
    node's candidate gains agree only to the table's rounding.  A node
    whose split differs is held to what that leaves determined: either
    the two splits send the node's rows the same way (a threshold
    elsewhere in a run of fine bins that none of them falls in, an NA
    direction with no NA row), or they tie: their gains, exact over the
    node's rows and residuals, within ``TIE`` of its wgg.  A tie's
    subtree and every later iteration follow that rounding and are not
    held.  Every other node's ``keys`` are equal.  Returns the (T, K, N)
    mask of the nodes held, their wgg, and the number of ties."""
    from h2o_tpu_torch.models.tree.convert import gbm_from_jax_output
    cm = gbm_from_jax_output(jout, jparams, device="cpu")
    po = pm.output
    Tp, K, N = po["split_col"].shape
    T = min(Tp, jout["split_col"].shape[0])
    lp, lr = _leaf_ids(pm, frame), _leaf_ids(cm, frame)
    grads = tree_grads(cm, frame, y)
    heap = np.arange(N)
    keep = np.zeros((T, K, N), bool)
    wgg = np.zeros((T, K, N))
    ties = 0
    for t in range(T):
        if ties:
            break
        for k in range(K):
            c, g = t * K + k, grads[t, k]
            keep[t, k] = True
            differ = np.zeros(N, bool)
            for key in keys:
                differ |= (po[key][t, k].reshape(N, -1) !=
                           jout[key][t, k].reshape(N, -1)).any(axis=1)
            for m in range(N):
                at = node_rows(lr[:, c], m)
                wgg[t, k, m] = (w[at] * g[at] ** 2).sum()
                if not (differ[m] and keep[t, k, m]):
                    continue
                where = f"tree {t} class {k} node {m}"
                assert po["split_col"][t, k, m] >= 0 and \
                    jout["split_col"][t, k, m] >= 0, f"{where}: one splits"
                left_p = at & node_rows(lp[:, c], 2 * m + 1)
                left_r = at & node_rows(lr[:, c], 2 * m + 1)
                if np.array_equal(left_p, left_r):
                    assert po["split_col"][t, k, m] == \
                        jout["split_col"][t, k, m], where
                    continue
                par = _se(w[at], g[at])
                gp, gr = (par - _se(w[s], g[s]) - _se(w[at & ~s], g[at & ~s])
                          for s in (left_p, left_r))
                assert abs(gp - gr) <= TIE * wgg[t, k, m], (
                    f"{where}: gains {gp} and {gr} are no tie at wgg "
                    f"{wgg[t, k, m]}")
                keep[t, k, node_rows(heap, m)] = False
                ties += 1
    if not ties:
        assert Tp == jout["split_col"].shape[0], "tree counts differ"
    return keep, wgg, ties


@pytest.mark.parametrize("depth,nan_cells", [(5, True), (5, False),
                                             (3, True), (3, False)],
                         ids=["d5", "d5_no_nan", "d3", "d3_no_nan"])
def test_probe_splits_equal_reference(cl, depth, nan_cells):
    jf, pf, y = _frames(nan_cells)
    kw = dict(ntrees=3, seed=1, max_depth=depth)
    jm = JGBM(**kw).train(y="y", training_frame=jf)
    pm = GBM(device="cpu", **kw).train(y="y", training_frame=pf)
    jo = {k: (np.asarray(v) if hasattr(v, "shape") else v)
          for k, v in jm.output.items()}
    po = pm.output
    # the reference forest's rows per node and gradients per tree
    cm = gbm_from_jax_output(jo, jm.params, device="cpu")
    leaf = cm.predict_leaf_node_assignment(pf, "Node_ID")
    staged = cm.staged_predict_proba(pf)
    f0 = np.float32(np.asarray(jo["f0"]).ravel()[0])
    p_before = [np.full(len(y), 1 / (1 + np.exp(-np.float64(f0))))] + [
        1.0 - staged.vecs[t].to_numpy().astype(np.float64)
        for t in range(2)]                    # a binomial stage holds p0
    for t in range(3):
        ids = leaf.vecs[t].to_numpy().astype(np.int64)
        g2 = (y - p_before[t]) ** 2
        sc = jo["split_col"][t, 0]
        gain = jo["node_gain"][t, 0]
        rounding = [m for m in range(sc.shape[0]) if sc[m] >= 0 and
                    gain[m] < 1e-6 * g2[node_rows(ids, m)].sum()]
        keep = [m for m in range(sc.shape[0])
                if not any(node_rows([m], r)[0] for r in rounding)]
        for k in ("split_col", "thr_bin", "na_left", "bitset"):
            np.testing.assert_array_equal(
                po[k][t, 0][keep], jo[k][t, 0][keep],
                err_msg=f"tree {t} {k}")
    assert (po["split_col"] >= 0).sum() > 10
    p1 = pm.predict_raw(pf).numpy()[:, 2]
    j1 = np.asarray(jm.predict_raw(jf))[: pf.nrows, 2]
    np.testing.assert_allclose(p1, j1, rtol=0, atol=1e-5)


def test_exp_and_softplus_are_xla():
    """XLA's CPU ``exp`` and ``jax.nn.softplus``, bitwise, over 300,000
    seeded values and the edges (subnormal results flush to 0)."""
    import jax
    rng = np.random.default_rng(1)
    x = np.concatenate([
        rng.normal(size=300_000) * rng.uniform(0.01, 40, size=300_000),
        [0.0, -0.0, 1e-30, -1e-30, 87.8, 88.8, 89.0, -87.4, -88.0, -104.0,
         1e30, -1e30, np.inf, -np.inf, np.nan]]).astype(np.float32)
    t = torch.from_numpy(x)
    for want, got in ((jnp.exp, xlamath.exp),
                      (jax.nn.softplus, xlamath.softplus)):
        np.testing.assert_array_equal(got(t).numpy(),
                                      np.asarray(want(jnp.asarray(x))))


def test_ordinal_thresholds_bitwise():
    """6 classes: the first threshold and 4 softplus increments summed in
    XLA's order, from the same params (the reference's function jitted as
    its solver runs it); the gradient flows through them."""
    import jax
    from h2o_tpu.models.glm import _ordinal_unpack as j_unpack
    from h2o_tpu_torch.models.glm import _ordinal_unpack
    P, K = 3, 6
    jit_unpack = jax.jit(j_unpack, static_argnums=(1, 2))
    rng = np.random.default_rng(0)
    for _ in range(200):
        prm = (rng.normal(size=P + K - 1) *
               rng.uniform(0.1, 5.0)).astype(np.float32)
        _, want = jit_unpack(jnp.asarray(prm), P, K)
        _, got = _ordinal_unpack(torch.from_numpy(prm), P, K)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    p = torch.from_numpy(prm).requires_grad_(True)
    _ordinal_unpack(p, P, K)[1].sum().backward()
    assert torch.all(p.grad[P + 1:] > 0)


def test_weighted_uplift_trees_equal_reference(cl):
    """UpliftDRF keeps ``torch.cumsum``: its 0/1 counts sum exactly in
    any order, and with fractional weights, where the sums round by the
    order, a weighted KL forest still equals the reference's tree for
    tree."""
    from h2o_tpu.models.tree.uplift import UpliftDRF as JUplift
    from h2o_tpu_torch.models.tree.uplift import UpliftDRF
    rng = np.random.default_rng(0)
    n = 800
    X = rng.normal(size=(n, 2)).astype(np.float32)
    treat = rng.integers(0, 2, n).astype(np.int32)
    y = (rng.uniform(size=n) < 0.3 + 0.2 * treat * (X[:, 0] > 0)).astype(
        np.int32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    names = ["x0", "x1", "w", "treatment", "y"]
    dom = ["0", "1"]
    jf = JFrame(names, [JVec(X[:, 0]), JVec(X[:, 1]), JVec(w),
                        JVec(treat, J_CAT, domain=dom),
                        JVec(y, J_CAT, domain=dom)])
    pf = Frame(names, [Vec(X[:, 0]), Vec(X[:, 1]), Vec(w),
                       Vec(treat, T_CAT, domain=dom),
                       Vec(y, T_CAT, domain=dom)])
    kw = dict(treatment_column="treatment", uplift_metric="KL", ntrees=5,
              max_depth=4, seed=5, weights_column="w")
    jm = JUplift(**kw).train(x=["x0", "x1"], y="y", training_frame=jf)
    pm = UpliftDRF(device="cpu", **kw).train(x=["x0", "x1"], y="y",
                                             training_frame=pf)
    for k in ("split_col", "bitset", "child"):
        np.testing.assert_array_equal(pm.output[k], np.asarray(jm.output[k]),
                                      err_msg=k)
    assert (pm.output["split_col"] >= 0).sum() > 5
