"""Checkpoint resume and save/load in the port, on the CPU.

A GBM (with row sampling and ``learn_rate_annealing`` < 1, so the
resumed trees need their absolute tree index for both their keys and
their learning rate) and a DRF trained to 5 trees and resumed to 10 equal
the uninterrupted 10-tree forests bit for bit: split columns,
thresholds, NA directions, bitsets, child pointers, node values and
predictions.
A GBM and a DRF trained by ``h2o_tpu`` to 5 trees, carried across by the
converters and resumed in the port to 10 equal ``h2o_tpu``'s own resume
(values rtol 1e-4 / atol 1e-6), on ``tests/test_model_ops.py``'s
checkpoint data.  A resume that does not continue its checkpoint (another
max_depth, another engine, no new trees) raises, as dart does with a
checkpoint.  ``Model.save``/``Model.load`` round-trip a model: the loaded
one predicts bitwise the same, and a saved path works as a checkpoint.
"""

import numpy as np
import pytest
import torch

from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models.tree.drf import DRF as JDRF
from h2o_tpu.models.tree.gbm import GBM as JGBM

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.model import Model
from h2o_tpu_torch.models.tree import engine
from h2o_tpu_torch.models.tree.convert import (drf_from_jax_output,
                                               gbm_from_jax_output)
from h2o_tpu_torch.models.tree.drf import DRF, DRFModel
from h2o_tpu_torch.models.tree.gbm import GBM, GBMModel
from h2o_tpu_torch.models.tree.xgboost import XGBoost

pytestmark = pytest.mark.shared_dkv

_TREE_KEYS = ("split_col", "thr_bin", "na_left", "bitset", "child")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frame(n=600, seed=0) -> Frame:
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    X[rng.uniform(size=n) < 0.05, 1] = np.nan
    cat = rng.integers(0, 5, n).astype(np.int32)
    logit = (1.5 * X[:, 0] - X[:, 2] + 0.8 * (cat % 2) +
             0.5 * np.nan_to_num(X[:, 1]))
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.int32)
    return Frame(["a", "b", "c", "d", "k", "y"],
                 [Vec(X[:, j]) for j in range(4)] +
                 [Vec(cat, T_CAT, domain=list("vwxyz")),
                  Vec(y, T_CAT, domain=["n", "p"])])


def _assert_same_forest(a: dict, b: dict, rtol=0.0, atol=1e-6) -> None:
    for k in _TREE_KEYS:
        if a.get(k) is None:
            assert b.get(k) is None, k
            continue
        np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)
    np.testing.assert_allclose(a["value"], np.asarray(b["value"]), rtol=rtol,
                               atol=atol)


RESUME = {
    "gbm": (GBM, dict(max_depth=3, sample_rate=0.8, learn_rate=0.3,
                      learn_rate_annealing=0.95)),
    "drf": (DRF, dict(max_depth=6)),
}


@pytest.mark.parametrize("algo", sorted(RESUME))
def test_resume_equals_uninterrupted(algo, monkeypatch):
    cls, kw = RESUME[algo]
    monkeypatch.setattr(engine, "MAX_LIVE_LEAVES", 16)
    fr = _frame()
    kw = dict(device="cpu", seed=5, **kw)
    m5 = cls(ntrees=5, **kw).train(y="y", training_frame=fr)
    m10 = cls(ntrees=10, checkpoint=m5, **kw).train(y="y",
                                                    training_frame=fr)
    full = cls(ntrees=10, **kw).train(y="y", training_frame=fr)
    assert m10.output["ntrees_actual"] == 10
    # the resumed F is the uninterrupted one bit for bit
    # (``shared_tree.forest_accumulate``), so the values are equal too
    _assert_same_forest(m10.output, full.output, atol=0.0)
    np.testing.assert_allclose(m10.output["varimp"], full.output["varimp"],
                               rtol=1e-5)
    assert torch.equal(m10.predict_raw(fr), full.predict_raw(fr))


def test_resume_scores_the_validation_frame_from_the_checkpoint():
    fr = _frame()
    tr, va = fr.slice_rows(slice(0, 450)), fr.slice_rows(slice(450, 600))
    kw = dict(device="cpu", max_depth=3, seed=5)
    m4 = GBM(ntrees=4, **kw).train(y="y", training_frame=tr)
    m10 = GBM(ntrees=10, checkpoint=m4, score_tree_interval=2, **kw).train(
        y="y", training_frame=tr, validation_frame=va)
    hist = m10.output["scoring_history"]
    assert [r["number_of_trees"] for r in hist] == [6, 8, 10]
    vm = m10.output["validation_metrics"]
    assert abs(hist[-1]["validation_logloss"] - vm["logloss"]) <= 1e-6
    assert abs(hist[-1]["validation_auc"] - vm["AUC"]) <= 1e-6


def _toy_binomial(rng, n=4000, c=6):
    """``tests/test_model_ops.py``'s checkpoint data, in both packages."""
    X = rng.normal(size=(n, c)).astype(np.float32)
    logits = 2.0 * X[:, 0] - 1.5 * X[:, 1] + X[:, 2]
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(np.int32)
    names = [f"x{j}" for j in range(c)] + ["y"]
    jf = JFrame(names, [JVec(X[:, j]) for j in range(c)] +
                [JVec(y, J_CAT, domain=["no", "yes"])])
    pf = Frame(names, [Vec(X[:, j]) for j in range(c)] +
               [Vec(y, T_CAT, domain=["no", "yes"])])
    return jf, pf


JAX_RESUME = {
    "gbm": (JGBM, GBM, gbm_from_jax_output,
            dict(max_depth=3, learn_rate=0.3, seed=5), 4000),
    "drf": (JDRF, DRF, drf_from_jax_output, dict(max_depth=4, seed=3),
            2000),
}


@pytest.mark.parametrize("algo", sorted(JAX_RESUME))
def test_jax_checkpoint_resumes_in_the_port(algo, cl):
    jcls, pcls, convert, kw, n = JAX_RESUME[algo]
    jf, pf = _toy_binomial(np.random.default_rng(42), n=n)
    j5 = jcls(ntrees=5, **kw).train(y="y", training_frame=jf)
    j10 = jcls(ntrees=10, checkpoint=j5, **kw).train(y="y",
                                                     training_frame=jf)
    out = {k: (np.asarray(v) if hasattr(v, "shape") else v)
           for k, v in j5.output.items()}
    c5 = convert(out, j5.params, device="cpu")
    p10 = pcls(device="cpu", ntrees=10, checkpoint=c5, **kw).train(
        y="y", training_frame=pf)
    assert p10.output["ntrees_actual"] == j10.output["ntrees_actual"] == 10
    _assert_same_forest(p10.output, j10.output, rtol=1e-4)
    np.testing.assert_allclose(p10.output["varimp"],
                               np.asarray(j10.output["varimp"]), rtol=1e-4)
    assert abs(p10.output["training_metrics"]["AUC"] -
               j10.output["training_metrics"]["AUC"]) <= 1e-5


def test_mismatched_resume_raises(monkeypatch):
    fr = _frame()
    kw = dict(device="cpu", seed=5)
    m5 = GBM(ntrees=5, max_depth=3, **kw).train(y="y", training_frame=fr)
    with pytest.raises(ValueError, match="max_depth"):
        GBM(ntrees=10, max_depth=4, checkpoint=m5, **kw).train(
            y="y", training_frame=fr)
    with pytest.raises(ValueError, match="raise ntrees"):
        GBM(ntrees=5, max_depth=3, checkpoint=m5, **kw).train(
            y="y", training_frame=fr)
    monkeypatch.setattr(engine, "MAX_LIVE_LEAVES", 2)   # depth 3: frontier
    with pytest.raises(ValueError, match="engine/pool"):
        GBM(ntrees=10, max_depth=3, checkpoint=m5, **kw).train(
            y="y", training_frame=fr)
    with pytest.raises(ValueError, match="checkpoint"):
        XGBoost(ntrees=10, max_depth=3, booster="dart", checkpoint=m5,
                **kw).train(y="y", training_frame=fr)


@pytest.mark.parametrize("cls,model_cls", [(GBM, GBMModel), (DRF, DRFModel)],
                         ids=["gbm", "drf"])
def test_save_load_round_trip(cls, model_cls, tmp_path):
    fr = _frame()
    m = cls(device="cpu", ntrees=4, max_depth=4, seed=2).train(
        y="y", training_frame=fr)
    path = m.save(str(tmp_path / "model.bin"))
    with open(path, "rb") as f:
        assert f.read(len(Model.BIN_MAGIC)) == Model.BIN_MAGIC
    got = Model.load(path, device="cpu")
    assert type(got) is model_cls and got.device == torch.device("cpu")
    assert torch.equal(got.predict_raw(fr), m.predict_raw(fr))
    for k in _TREE_KEYS + ("value", "split_points", "varimp"):
        if m.output.get(k) is not None:
            np.testing.assert_array_equal(got.output[k], m.output[k])
    assert got.output["training_metrics"]["AUC"] == \
        m.output["training_metrics"]["AUC"]
    # a saved path is a checkpoint too
    a = cls(device="cpu", ntrees=6, max_depth=4, seed=2,
            checkpoint=path).train(y="y", training_frame=fr)
    b = cls(device="cpu", ntrees=6, max_depth=4, seed=2,
            checkpoint=m).train(y="y", training_frame=fr)
    _assert_same_forest(a.output, b.output, atol=0.0)


def test_load_rejects_a_foreign_file(tmp_path):
    bad = tmp_path / "x.bin"
    bad.write_bytes(b"not a model")
    with pytest.raises(ValueError, match="not a saved"):
        Model.load(str(bad), device="cpu")
