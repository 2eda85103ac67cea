"""The port's slice as a whole: h2o_tpu_torch GBM held against h2o_tpu
GBM on the CPU, tree for tree.

Four configurations on the same data (NaNs in a numeric column, one
categorical column): bernoulli with histogram_type AUTO (UniformAdaptive,
the default), the same with bf16_histograms, bernoulli with
QuantilesGlobal, and gaussian with AUTO.
Split columns, thresholds, NA directions and bitsets are equal; node
values agree to rtol 1e-4 / atol 1e-6, predictions to atol 1e-5 and the
training AUC to 1e-4.  The port's float32 tables are summed in another
order than the reference's 8-shard CPU mesh, so the data has a strong,
smooth signal: no split decision here is a near-tie.

The converter carries a JAX-trained forest across unchanged; it must
score like the JAX model to atol 1e-6.
"""

import numpy as np
import pytest
import torch

from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models.tree.gbm import GBM as JGBM

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.tree.convert import gbm_from_jax_output
from h2o_tpu_torch.models.tree.gbm import GBM
from h2o_tpu_torch.core.store import unpublish_on_exit


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv

CONFIGS = {
    "bernoulli_auto": dict(binomial=True, histogram_type="AUTO"),
    "bernoulli_qg": dict(binomial=True, histogram_type="QuantilesGlobal"),
    "gaussian_auto": dict(binomial=False, histogram_type="AUTO"),
    # bf16_histograms rounds each row's stats to bfloat16 before the f32
    # sums, identically in both packages, so the same tolerances hold
    "bernoulli_auto_bf16": dict(binomial=True, histogram_type="AUTO",
                                bf16_histograms=True),
}
_NAMES = ["a", "b", "c", "d", "k", "y"]
_DOM = list("vwxyz")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes gain nothing from intra-op threads, and the suite
    runs several workers at once: keep torch to one CPU thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=600, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    X[rng.uniform(size=n) < 0.05, 1] = np.nan
    cat = rng.integers(0, 5, n).astype(np.int32)
    logit = (1.5 * X[:, 0] - X[:, 2] + 0.8 * (cat % 2) +
             0.5 * np.nan_to_num(X[:, 1]))
    yb = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.int32)
    yr = (logit + 0.1 * rng.normal(size=n)).astype(np.float32)
    return X, cat, yb, yr


def _frames(binomial: bool):
    X, cat, yb, yr = _data()
    y = yb if binomial else yr
    jv = [JVec(X[:, j]) for j in range(4)] + [JVec(cat, J_CAT, domain=_DOM)]
    pv = [Vec(X[:, j]) for j in range(4)] + [Vec(cat, T_CAT, domain=_DOM)]
    jv.append(JVec(y, J_CAT, domain=["n", "p"]) if binomial else JVec(y))
    pv.append(Vec(y, T_CAT, domain=["n", "p"]) if binomial else Vec(y))
    return JFrame(_NAMES, jv), Frame(_NAMES, pv)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request, cl):
    cfg = CONFIGS[request.param]
    jf, pf = _frames(cfg["binomial"])
    kw = dict(ntrees=3, max_depth=3, seed=1,
              histogram_type=cfg["histogram_type"],
              bf16_histograms=cfg.get("bf16_histograms", False))
    jm = JGBM(**kw).train(y="y", training_frame=jf)
    pm = GBM(device="cpu", **kw).train(y="y", training_frame=pf)
    return cfg, jf, pf, jm, pm


def test_trees_equal(pair):
    _, _, _, jm, pm = pair
    for k in ("split_col", "thr_bin", "na_left", "bitset"):
        np.testing.assert_array_equal(pm.output[k], np.asarray(jm.output[k]),
                                      err_msg=k)
    assert (pm.output["split_col"] >= 0).sum() > 3
    assert pm.output["hist_type"] == jm.output["hist_type"]


def test_values_close(pair):
    _, _, _, jm, pm = pair
    np.testing.assert_allclose(pm.output["value"],
                               np.asarray(jm.output["value"]),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(pm.output["f0"], np.asarray(jm.output["f0"]),
                               rtol=1e-6)


def test_predictions_close(pair):
    _, jf, pf, jm, pm = pair
    got = pm.predict_raw(pf).numpy()
    want = np.asarray(jm.predict_raw(jf))[: pf.nrows]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_training_metrics_close(pair):
    cfg, _, _, jm, pm = pair
    jt, pt = jm.output["training_metrics"], pm.output["training_metrics"]
    if cfg["binomial"]:
        assert abs(pt["AUC"] - jt["AUC"]) <= 1e-4
        assert pt["AUC"] > 0.75
        assert abs(pt["logloss"] - jt["logloss"]) <= 1e-4
    np.testing.assert_allclose(pt["mse"], jt["mse"], rtol=1e-4)


def test_converted_forest_scores_like_reference(pair):
    _, jf, pf, jm, _ = pair
    out = {k: (np.asarray(v) if hasattr(v, "shape") else v)
           for k, v in jm.output.items()}
    cm = gbm_from_jax_output(out, jm.params, device="cpu")
    got = cm.predict_raw(pf).numpy()
    want = np.asarray(jm.predict_raw(jf))[: pf.nrows]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    pred = cm.predict(pf)
    assert pred.nrows == pf.nrows


def test_bf16_histograms_reach_the_tables():
    """The option changes the node values (rounded stats), not the
    forest's shape on this data."""
    _, pf = _frames(True)
    kw = dict(device="cpu", ntrees=2, max_depth=3, seed=1)
    f32 = GBM(**kw).train(y="y", training_frame=pf).output
    b16 = GBM(bf16_histograms=True, **kw).train(
        y="y", training_frame=pf).output
    np.testing.assert_array_equal(b16["split_col"], f32["split_col"])
    assert not np.array_equal(b16["value"], f32["value"])
    np.testing.assert_allclose(b16["value"], f32["value"], rtol=2e-2,
                               atol=1e-4)


def test_out_of_slice_options_raise():
    """Iteration-level recovery (P14) raises by name; a checkpoint that
    names no saved model, an unknown stats dtype or histogram type,
    ntrees 0 and a custom distribution without its function are errors;
    a custom metric that does not load records NaN, as the reference's
    does."""
    jf, pf = _frames(True)
    for kw in (dict(recovery_dir="r"), dict(checkpoint_interval=2)):
        with pytest.raises(NotImplementedError):
            GBM(device="cpu", ntrees=1, **kw).train(y="y", training_frame=pf)
    m = GBM(device="cpu", ntrees=1, custom_metric_func="f").train(
        y="y", training_frame=pf)
    assert np.isnan(m.output["training_metrics"]["custom_metric_value"])
    for kw in (dict(stats_dtype="int4"), dict(histogram_type="Exact"),
               dict(ntrees=0), dict(checkpoint="m"),
               dict(distribution="custom")):
        with pytest.raises(ValueError):
            GBM(device="cpu", **{"ntrees": 1, **kw}).train(
                y="y", training_frame=pf)
    assert torch.get_default_dtype() == torch.float32


# -- nodes whose gain is float32 rounding -------------------------------------

def _node_rows(bins: np.ndarray, out: dict, t: int) -> dict:
    """Heap node -> row mask of tree ``t`` (one class) of a dense
    UniformAdaptive forest."""
    sc, th, na = (np.asarray(out[k])[t, 0] for k in
                  ("split_col", "thr_bin", "na_left"))
    fine_na = int(out["fine_nbins"])
    n = bins.shape[0]
    node = np.zeros(n, np.int64)
    rows = {0: np.ones(n, bool)}
    for _ in range(int(out["max_depth"])):
        c = sc[node]
        b = bins[np.arange(n), np.maximum(c, 0)]
        go_left = np.where(b == fine_na, na[node], b < th[node])
        node = np.where(c < 0, node, 2 * node + np.where(go_left, 1, 2))
        for m in np.unique(node):
            rows[int(m)] = node == m
    return rows


def test_pure_nodes_split_on_rounding(cl):
    """A probe with pure nodes: 2,000 rows of 4 normal columns (seed 0),
    ``y = [x0 + noise > 0]``, a 3-tree default GBM.  Both engines keep the
    reference's rule and split when the best gain exceeds
    ``max(min_split_improvement * se_parent, 1e-10)``; at a node of one
    class every candidate's float32 gain is a cancellation residue of
    ``wgg - wg^2/w``, and the two packages' residues differ.

    Rule: a split is *rounding* when its gain is below 1e-6 of the node's
    sum of squared gradients wgg (its exact SE is then 0, as here, or
    within float32 rounding of it).  The first tree is equal node for
    node except in the subtrees of rounding splits; after the first such
    split the forests may differ, and predictions then hold p1 to atol
    0.02 and the training AUC to 1e-4: room for a pure node of a first
    tree split on another column."""
    rng = np.random.default_rng(0)
    n = 2000
    X = rng.normal(size=(n, 4)).astype(np.float32)
    y = (X[:, 0] + rng.normal(size=n) > 0).astype(np.int32)
    names = ["x0", "x1", "x2", "x3", "y"]
    jf = JFrame(names, [JVec(X[:, j]) for j in range(4)] +
                [JVec(y, J_CAT, domain=["0", "1"])])
    pf = Frame(names, [Vec(X[:, j]) for j in range(4)] +
               [Vec(y, T_CAT, domain=["0", "1"])])
    jm = JGBM(ntrees=3, seed=1).train(y="y", training_frame=jf)
    pm = GBM(device="cpu", ntrees=3, seed=1).train(y="y", training_frame=pf)
    jo, po = jm.output, pm.output
    from h2o_tpu_torch.models.tree import shared_tree as st
    bins = st.bin_matrix(torch.from_numpy(X), po["split_points"],
                         po["is_cat"], st.model_fine_na(po)).numpy().astype(
        np.int64)
    p0 = 1 / (1 + np.exp(-np.float32(np.asarray(jo["f0"])[0])))
    g = (y - p0).astype(np.float64)
    rows = _node_rows(bins, jo, 0)
    gain = np.asarray(jo["node_gain"])[0, 0]
    sc = np.asarray(jo["split_col"])[0, 0]
    rounding = [m for m in sorted(rows) if sc[m] >= 0 and
                gain[m] < 1e-6 * float((g[rows[m]] ** 2).sum())]
    assert rounding, "the probe has a pure node that splits"
    H = sc.shape[0]

    def under(m, r):
        while m > r:
            m = (m - 1) // 2
        return m == r

    cmp_nodes = [m for m in range(H) if not any(under(m, r) and m != r
                                                for r in rounding)]
    for k in ("split_col", "thr_bin", "na_left"):
        a, b = po[k][0, 0], np.asarray(jo[k])[0, 0]
        keep = [m for m in cmp_nodes if m not in rounding]
        np.testing.assert_array_equal(a[keep], b[keep], err_msg=k)
    p1 = pm.predict_raw(pf).numpy()[:, 2]
    j1 = np.asarray(jm.predict_raw(jf))[:n, 2]
    assert np.abs(p1 - j1).max() <= 0.02
    assert abs(po["training_metrics"]["AUC"] -
               jo["training_metrics"]["AUC"]) <= 1e-4
