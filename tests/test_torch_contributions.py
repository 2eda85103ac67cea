"""The tree family's explain options: h2o_tpu_torch held against h2o_tpu
on the CPU.

The reference's GBM (regression and binomial), DRF, XGBoost gbtree and
dart, and a GBM deep enough for the sparse-frontier pool (child
pointers, ``H2O_TPU_MAX_LIVE_LEAVES=8``) are trained once each on 400
rows of three features (one categorical, NaNs in a numeric one) and
carried across by the converters.  Both packages then run the same C++
TreeSHAP and leaf-assignment code on equal bins and equal node arrays,
so contributions, sorted contributions and leaf assignments are equal;
staged probabilities and varimp agree within 1e-6 (the link's exp is
numpy's in the reference, torch's here).  The port's own GBM, DRF and
XGBoost trained on the same rows agree with the reference's within
1e-5.  The numpy TreeSHAP agrees with the library within 1e-6 and with a
brute-force Shapley enumeration on one tree; Σφ + BiasTerm is the
margin within 1e-5.  Multinomial models are refused with the
reference's message, and a failed build of the library raises instead
of falling back to the numpy version.
"""

import itertools
import math

import numpy as np
import pytest
import torch

from h2o_tpu import native as jnative
from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models.tree.drf import DRF as JDRF
from h2o_tpu.models.tree.gbm import GBM as JGBM
from h2o_tpu.models.tree.xgboost import XGBoost as JXGB

from h2o_tpu_torch import native
from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.model import Model
from h2o_tpu_torch.models.tree import contributions as ct
from h2o_tpu_torch.models.tree import shared_tree as st
from h2o_tpu_torch.models.tree.convert import (drf_from_jax_output,
                                               gbm_from_jax_output,
                                               xgboost_from_jax_output)
from h2o_tpu_torch.models.tree.drf import DRF
from h2o_tpu_torch.models.tree.gbm import GBM
from h2o_tpu_torch.models.tree.xgboost import XGBoost
from h2o_tpu_torch.core.store import unpublish_on_exit


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv

X = ["x0", "x1", "c"]
FRONTIER_CAP = 8
#: case -> (reference builder, port builder, converter, params, response)
CASES = {
    "gbm_reg": (JGBM, GBM, gbm_from_jax_output,
                dict(ntrees=8, max_depth=4, seed=1), "yr"),
    "gbm_bin": (JGBM, GBM, gbm_from_jax_output,
                dict(ntrees=6, max_depth=3, seed=2), "yb"),
    "drf_bin": (JDRF, DRF, drf_from_jax_output,
                dict(ntrees=10, max_depth=5, seed=4), "yb"),
    "xgb_gbtree": (JXGB, XGBoost, xgboost_from_jax_output,
                   dict(ntrees=4, max_depth=3, seed=1), "yb"),
    "xgb_dart": (JXGB, XGBoost, xgboost_from_jax_output,
                 dict(ntrees=4, max_depth=3, seed=1, booster="dart",
                      rate_drop=0.3), "yb"),
    "gbm_frontier": (JGBM, GBM, gbm_from_jax_output,
                     dict(ntrees=4, max_depth=7, seed=3), "yr"),
}
SORTED = {"top2": dict(top_n=2), "top1_bottom1": dict(top_n=1, bottom_n=1),
          "bottom_all": dict(bottom_n=-1),
          "top2_abs": dict(top_n=2, compare_abs=True)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames(cl):
    rng = np.random.default_rng(0)
    n = 400
    x0 = rng.normal(size=n).astype(np.float32)
    x1 = rng.normal(size=n).astype(np.float32)
    cat = rng.integers(0, 4, n).astype(np.int32)
    yr = (2 * x0 - x1 + 0.5 * (cat % 2) +
          0.1 * rng.normal(size=n)).astype(np.float32)
    yb = (yr > 0).astype(np.int32)
    x1[rng.uniform(size=n) < 0.05] = np.nan
    names = X + ["yr", "yb"]
    jf = JFrame(names, [JVec(x0), JVec(x1),
                        JVec(cat, J_CAT, domain=list("abcd")), JVec(yr),
                        JVec(yb, J_CAT, domain=["n", "p"])])
    pf = Frame(names, [Vec(x0), Vec(x1), Vec(cat, T_CAT, domain=list("abcd")),
                       Vec(yr), Vec(yb, T_CAT, domain=["n", "p"])])
    return jf, pf


def _train(name, jf):
    jcls, _, conv, kw, y = CASES[name]
    with pytest.MonkeyPatch.context() as mp:
        if name == "gbm_frontier":
            mp.setenv("H2O_TPU_MAX_LIVE_LEAVES", str(FRONTIER_CAP))
        jm = jcls(**kw).train(x=X, y=y, training_frame=jf)
    out = {k: (np.asarray(v) if hasattr(v, "shape") else v)
           for k, v in jm.output.items()}
    return jm, conv(out, jm.params, device="cpu")


@pytest.fixture(scope="module")
def models(frames):
    assert jnative.treeshap_lib() is not None, \
        "the reference's native TreeSHAP must build: native against native"
    jf, _ = frames
    got = {name: _train(name, jf) for name in CASES}
    assert got["gbm_frontier"][1].output["child"] is not None
    return got


def _ref_cols(jfr, nrows):
    return {n: np.asarray(v.to_numpy())[:nrows]
            for n, v in zip(jfr.names, jfr.vecs)}


def _assert_frame_equal(jfr, pfr, nrows, atol=None):
    """Names, types, domains and codes equal; numeric columns equal, or
    within ``atol``."""
    assert pfr.names == jfr.names
    ref = _ref_cols(jfr, nrows)
    for name, pv in zip(pfr.names, pfr.vecs):
        jv = jfr.vec(name)
        assert pv.type == jv.type, name
        if pv.is_categorical:
            assert pv.domain == list(jv.domain), name
            np.testing.assert_array_equal(pv.data, ref[name], err_msg=name)
        elif atol is None:
            np.testing.assert_array_equal(pv.data, ref[name], err_msg=name)
        else:
            np.testing.assert_allclose(pv.data, ref[name], rtol=0,
                                       atol=atol, err_msg=name)


def _phi(fr):
    return np.stack([v.data for v in fr.vecs], axis=1).astype(np.float64)


def _margin(model, frame):
    """The raw margin Σφ + BiasTerm must reach: the GBM/XGBoost link-scale
    forest sum with f0, or DRF's mean vote."""
    out = model.output
    if model.algo == "drf":
        bins = ct._binned_device(model, frame)
        return (st.forest_score_out(bins, out)[:, 0] /
                int(out["ntrees_actual"])).numpy()
    return model._forest_F(frame.as_matrix(out["x"], model.device))[
        :, 0].numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_contributions_equal_reference(name, models, frames):
    jf, pf = frames
    jm, pm = models[name]
    want = jm.predict_contributions(jf)
    got = pm.predict_contributions(pf)
    assert got.names == X + ["BiasTerm"]
    _assert_frame_equal(want, got, pf.nrows)


@pytest.mark.parametrize("variant", sorted(SORTED))
@pytest.mark.parametrize("name", ["drf_bin", "gbm_reg"])
def test_sorted_contributions_equal_reference(name, variant, models,
                                              frames):
    jf, pf = frames
    jm, pm = models[name]
    kw = SORTED[variant]
    _assert_frame_equal(jm.predict_contributions(jf, **kw),
                        pm.predict_contributions(pf, **kw), pf.nrows)


@pytest.mark.parametrize("assign_type", ["Path", "Node_ID"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_leaf_assignment_equal_reference(name, assign_type, models, frames):
    jf, pf = frames
    jm, pm = models[name]
    got = pm.predict_leaf_node_assignment(pf, assign_type)
    _assert_frame_equal(jm.predict_leaf_node_assignment(jf, assign_type),
                        got, pf.nrows)
    if assign_type == "Path":
        assert all(set(d) <= {"L", "R"} for v in got.vecs for d in v.domain)


@pytest.mark.parametrize("name", sorted(CASES))
def test_staged_and_varimp_equal_reference(name, models, frames):
    jf, pf = frames
    jm, pm = models[name]
    if name == "drf_bin":
        for m, fr in ((jm, jf), (pm, pf)):
            with pytest.raises(NotImplementedError, match="only supported"):
                m.staged_predict_proba(fr)
    else:
        got = pm.staged_predict_proba(pf)
        _assert_frame_equal(jm.staged_predict_proba(jf), got, pf.nrows,
                            atol=1e-6)
        # the last stage is the prediction (p0 of a binomial)
        pred = pm.predict(pf)
        last = pred.vec("n").data if "n" in pred else pred.vec(
            "predict").data
        np.testing.assert_allclose(got.vecs[-1].data, last, atol=1e-6)
    want, have = jm.varimp(), pm.varimp()
    if want is None:
        assert have is None
        return
    assert [r[0] for r in have] == [r[0] for r in want]
    np.testing.assert_allclose([r[1:] for r in have], [r[1:] for r in want],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["gbm_reg", "gbm_bin", "drf_bin",
                                  "xgb_gbtree"])
def test_port_trained_against_reference(name, models, frames):
    """The port's own model of the same params on the same rows explains
    as the reference's does, within 1e-5."""
    jf, pf = frames
    jm, _ = models[name]
    _, pcls, _, kw, y = CASES[name]
    pm = pcls(device="cpu", **kw).train(x=X, y=y, training_frame=pf)
    for k in ("split_col", "thr_bin", "na_left", "bitset"):
        if pm.output.get(k) is not None:
            np.testing.assert_array_equal(pm.output[k],
                                          np.asarray(jm.output[k]),
                                          err_msg=k)
    _assert_frame_equal(jm.predict_contributions(jf),
                        pm.predict_contributions(pf), pf.nrows, atol=1e-5)
    _assert_frame_equal(jm.predict_leaf_node_assignment(jf, "Node_ID"),
                        pm.predict_leaf_node_assignment(pf, "Node_ID"),
                        pf.nrows)
    if name != "drf_bin":
        _assert_frame_equal(jm.staged_predict_proba(jf),
                            pm.staged_predict_proba(pf), pf.nrows,
                            atol=1e-5)
    np.testing.assert_allclose([r[2:] for r in pm.varimp()],
                               [r[2:] for r in jm.varimp()], atol=1e-5)


def _class0(pm):
    return ct._class_slice(ct._forest_arrays(pm), 0)


@pytest.mark.parametrize("name", ["gbm_reg", "drf_bin", "gbm_frontier"])
def test_plain_versions_match_native(name, models, frames):
    _, pf = frames
    _, pm = models[name]
    sc, bs, vl, nw, ch, th, na = _class0(pm)
    bins = ct._binned(pm, pf)[:25]
    fine_na = st.model_fine_na(pm.output)
    np.testing.assert_allclose(
        native.treeshap_contribs(bins, sc, bs, vl, nw, ch, th, na, fine_na),
        ct._py_treeshap(bins, sc, bs, vl, nw, ch, th, na, fine_na),
        rtol=0, atol=1e-6)
    ids, paths = native.tree_leaf_assign(bins, sc, bs, ch, th, na, fine_na)
    pids, ppaths = ct._py_leaf_assign(bins, sc, bs, ch, th, na, fine_na)
    np.testing.assert_array_equal(ids, pids)
    np.testing.assert_array_equal(paths, ppaths)


def test_brute_force_shapley(models, frames):
    """Exact Shapley values by subset enumeration over one tree's
    marginalised predictions equal TreeSHAP's."""
    _, pf = frames
    _, pm = models["gbm_reg"]
    sc, bs, vl, nw, ch, th, na = (a[:1] if a is not None else None
                                  for a in _class0(pm))
    bins = ct._binned(pm, pf)[:4]
    fine_na = st.model_fine_na(pm.output)
    phi = ct._shap_matrix(bins, sc, bs, vl, nw, ch, th, na, fine_na)
    C = len(X)

    def value(row, subset):
        def rec(n):
            if ct._is_leaf(sc[0], None, n):
                return vl[0, n]
            col = int(sc[0, n])
            left, right = ct._children(None, n)
            if col in subset:
                gl = ct._go_left(bs[0], th[0] if th is not None else None,
                                 na[0] if na is not None else None, n,
                                 int(row[col]), fine_na)
                return rec(left if gl else right)
            w = nw[0, n]
            if w == 0:
                return vl[0, n]
            return (nw[0, left] * rec(left) + nw[0, right] * rec(right)) / w
        return rec(0)

    for r in range(bins.shape[0]):
        brute = np.zeros(C + 1)
        for j in range(C):
            others = [i for i in range(C) if i != j]
            for k in range(C):
                for S in itertools.combinations(others, k):
                    wgt = math.factorial(k) * math.factorial(C - k - 1) / \
                        math.factorial(C)
                    brute[j] += wgt * (value(bins[r], set(S) | {j}) -
                                       value(bins[r], set(S)))
        brute[C] = value(bins[r], set())
        np.testing.assert_allclose(phi[r], brute, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", sorted(CASES))
def test_local_accuracy(name, models, frames):
    _, pf = frames
    _, pm = models[name]
    phi = _phi(pm.predict_contributions(pf))
    np.testing.assert_allclose(phi.sum(axis=1), _margin(pm, pf), rtol=0,
                               atol=1e-5)
    # the assigned leaves' values sum to the forest's trees
    ids = _phi(pm.predict_leaf_node_assignment(pf, "Node_ID")).astype(int)
    vl = pm.output["value"][:, 0]
    total = sum(vl[t][ids[:, t]] for t in range(ids.shape[1]))
    F = st.forest_score_out(ct._binned_device(pm, pf), pm.output)[:, 0]
    np.testing.assert_allclose(total, F.numpy(), rtol=0, atol=1e-5)


def test_refusals(frames):
    rng = np.random.default_rng(5)
    n = 300
    x0 = rng.normal(size=n).astype(np.float32)
    fr = Frame(["x0", "y"], [Vec(x0), Vec(rng.integers(0, 3, n), T_CAT,
                                          domain=["a", "b", "c"])])
    m = GBM(device="cpu", ntrees=2, max_depth=2, seed=1).train(
        x=["x0"], y="y", training_frame=fr)
    with pytest.raises(NotImplementedError, match=(
            r"^Calculating contributions is currently not supported for "
            r"multinomial models\.$")):
        m.predict_contributions(fr)
    assert m.staged_predict_proba(fr).names == [
        f"T{t}.C{k}" for t in (1, 2) for k in (1, 2, 3)]
    _, pf = frames
    b = GBM(device="cpu", ntrees=2, max_depth=2, seed=1).train(
        x=X, y="yb", training_frame=pf)
    with pytest.raises(NotImplementedError, match='output_format "Original"'):
        b.predict_contributions(pf, output_format="Compact")
    bare = Model({}, {}, torch.device("cpu"))
    for call in (bare.predict_contributions, bare.predict_leaf_node_assignment,
                 lambda f: GBM.model_cls({}, {}, bare.device)
                 .staged_predict_proba(f)):
        with pytest.raises(NotImplementedError, match="tree-based models"):
            call(pf)
    assert bare.varimp() is None


def test_failed_build_raises(models, frames, monkeypatch, tmp_path):
    """No compiler, or a source it rejects: the explain call raises with
    the compiler's words and never reaches the numpy TreeSHAP."""
    _, pf = frames
    _, pm = models["gbm_bin"]

    def oracle_called(*a, **k):
        raise AssertionError("fell back to the numpy TreeSHAP")

    monkeypatch.setattr(ct, "_py_treeshap", oracle_called)
    monkeypatch.setattr(ct, "_py_leaf_assign", oracle_called)
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="cannot run the C\\+\\+ compiler"):
        pm.predict_contributions(pf)
    with pytest.raises(RuntimeError, match="cannot run the C\\+\\+ compiler"):
        pm.predict_leaf_node_assignment(pf)
    monkeypatch.setattr(native, "CXX", "g++")
    src = tmp_path / "src"
    src.mkdir()
    (src / "treeshap.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "_DIR", src)
    with pytest.raises(RuntimeError, match="failed .* building"):
        pm.predict_contributions(pf)
    assert not list((tmp_path / "build").glob("*.so"))
