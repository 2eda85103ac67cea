"""AutoML's target-encoding preprocessing in the port, held against
``h2o_tpu``'s on the CPU at ``tests/test_automl.py:137-162``'s case (GBM
only, ``max_models=2``, ``nfolds=3``, a 4-level categorical on 300 rows
from ``default_rng(42)``), both plans with every ``ntrees`` cut to 5 as
in ``tests/test_torch_automl.py``.

Held: the same event stages and messages (keys and seconds masked); the
encoder's KFold ``g_te`` column on the shared fold column bitwise the
reference's; each model's trees through ``hold_gbm_forest`` (equal, or a
split that differs is an exact tie of ``g`` against ``g_te`` over the
node's rows: ``g_te`` is a function of ``g`` and the fold) and its
training metrics within 1e-5; the models are ``TEPipelineModel``s over
``x``, ``g`` and ``g_te``, score a frame without ``g_te`` as the
reference's do (probabilities within 1e-5), and the MOJO writer refuses
them.

Not held: the cross-validation metrics, and so the leaderboard's order.
At 300 rows the fold models (zero-weight holdout rows) meet nodes whose
best gain is a float32 rounding residue (PERF.md's F3), split in one
package and not in the other; their CV AUCs differ by up to 4.5e-3
(CHANGES.md lists the difference).
"""

import re

import numpy as np
import pytest
import torch

from h2o_tpu.automl import automl as j_automl
from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec

from h2o_tpu_torch.automl import automl as p_automl
from h2o_tpu_torch.automl.automl import AutoML, TEPipelineModel
from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.core.store import dkv as p_dkv, unpublish_on_exit
from h2o_tpu_torch.mojo import export_genmodel_mojo
from tests.test_torch_automl import _cut, _events
from tests.test_torch_find_splits_order import hold_gbm_forest


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv

_METRIC_TOL = 1e-5
_FOLD = "__automl_fold__"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _te_frames(n=300):
    """``tests/test_automl.py:137-162``'s frame in both packages."""
    rng = np.random.default_rng(42)
    g = rng.integers(0, 4, size=n)
    x = rng.normal(size=n).astype(np.float32)
    y = (x + 0.5 * (g % 2) + rng.normal(size=n) * 0.3 > 0.4)
    cols = [(x, None), (g.astype(np.int32), ["a", "b", "c", "d"]),
            (y.astype(np.int32), ["n", "p"])]
    return tuple(
        F(["x", "g", "y"], [V(v) if d is None else V(v, C, domain=d)
                            for v, d in cols])
        for F, V, C in ((JFrame, JVec, J_CAT), (Frame, Vec, T_CAT)))


_CASE = dict(max_models=2, nfolds=3, seed=1, include_algos=["GBM"],
             preprocessing=["target_encoding"], project_name="te")


def _np(out):
    return {k: (np.asarray(v) if hasattr(v, "shape") else v)
            for k, v in out.items()}


@pytest.fixture(scope="module")
def run(cl):
    mp = pytest.MonkeyPatch()
    mp.setattr(j_automl, "_default_plan", _cut(j_automl._default_plan))
    mp.setattr(p_automl, "_default_plan", _cut(p_automl._default_plan))
    try:
        with unpublish_on_exit():
            jf, pf = _te_frames()
            ja = j_automl.AutoML(**_CASE).train(y="y", training_frame=jf)
            pa = AutoML(device="cpu", **_CASE).train(y="y",
                                                     training_frame=pf)
            jouts = [_np(m.output) for m in ja.leaderboard.models]
            jraw = [np.asarray(m.predict_raw(jf))[: pf.nrows]
                    for m in ja.leaderboard.models]
            yield jf, pf, ja, pa, jouts, jraw
    finally:
        mp.undo()


def _work(pf, te):
    """The frame the port's models trained on: the fold column and the
    encoder's training-time ``g_te``."""
    fold = (np.arange(pf.nrows) % 3).astype(np.float32)
    work = Frame(list(pf.names) + [_FOLD], list(pf.vecs) + [Vec(fold)])
    return work.add("g_te", te.transform(work, as_training=True,
                                         noise=0.0).vec("g_te"))


def test_steps_as_reference(run):
    _, _, ja, pa, _, _ = run
    assert _events(pa) == _events(ja)
    assert [s for s, _ in _events(pa)] == [
        "init", "init", "init", "def_gbm_1", "def_gbm_2", "done"]
    assert "target encoding applied to ['g'] (KFold)" in \
        " ".join(m for _, m in _events(pa))


def test_encoding_bitwise_the_references(run):
    jf, pf, ja, pa, _, _ = run
    te = pa.leaderboard.models[0].te
    assert p_dkv().get(pa.leaderboard.models[0].output[
        "preprocessing_te_key"]) is te
    fold = (np.arange(pf.nrows) % 3).astype(np.float32)
    jwork = JFrame(list(jf.names) + [_FOLD], list(jf.vecs) + [JVec(fold)])
    want = np.asarray(ja.leaderboard.models[0].te.transform(
        jwork, as_training=True, noise=0.0).vec("g_te").to_numpy())
    got = _work(pf, te).vec("g_te").to_numpy()
    np.testing.assert_array_equal(got, want[: pf.nrows])


def test_models_held_against_reference(run):
    _, pf, ja, pa, jouts, _ = run
    work = _work(pf, pa.leaderboard.models[0].te)
    y = pf.vec("y").data.astype(np.float64)
    ties = []
    for pm, jm, jo in zip(pa.leaderboard.models, ja.leaderboard.models,
                          jouts):
        assert isinstance(pm, TEPipelineModel)
        assert pm.output["x"] == list(jo["x"]) == ["x", "g", "g_te"]
        _, _, n = hold_gbm_forest(pm.inner, jo, jm.params, work, y,
                                  np.ones(pf.nrows))
        ties.append(n)
        for k in ("AUC", "logloss", "mse"):
            v = jo["training_metrics"][k]
            assert abs(pm.output["training_metrics"][k] - v) <= \
                _METRIC_TOL * max(1.0, abs(v)), k
    assert ties[1] == 0              # the depth-3 GBM: every tree equal


def test_models_score_frames_without_te_columns(run):
    _, pf, _, pa, _, jraw = run
    assert "g_te" not in pf.names
    for pm, want in zip(pa.leaderboard.models, jraw):
        raw = pm.predict_raw(pf).numpy()
        assert raw.shape == (pf.nrows, 3) and np.isfinite(raw).all()
        np.testing.assert_allclose(raw[:, 1:], want[:, 1:], rtol=0,
                                   atol=1e-5)
    with pytest.raises(NotImplementedError, match="target-encoding"):
        export_genmodel_mojo(pa.leader)
    with pytest.raises(ValueError, match="unsupported preprocessing"):
        AutoML(preprocessing=["pca"], device="cpu")
