"""Models and frames published in the port's DKV (``store.dkv()``), held
against ``h2o_tpu``'s ``cloud().dkv`` on the CPU.

- GBM, GLM and DRF with 3-fold CV, both packages given the same
  ``model_id``: the keys each publishes (the model, the fold models
  ``{id}_cv_{i}``, ``cv_holdout_prediction_{id}``,
  ``cv_fold_assignment_{id}``) and the output's key fields are equal;
  the holdout predictions within 1e-5 and the fold assignment equal;
  every published object is the one the output names;
- a ``checkpoint`` given by key resumes, bitwise the uninterrupted
  forest (``tests/test_torch_checkpoint.py``'s claim);
- Generic by ``model_key`` (an upload key whose DKV value is the MOJO's
  path) scores bitwise the reference's Generic by the same key;
- a StackedEnsemble whose base models are given by key (the reference's
  CV base models carried across and published under their keys, with
  their holdout frames): its metalearner is published under
  ``metalearner_key``; coefficients 1e-5 relative and probabilities
  1e-5 of the reference's ensemble built from the same keys;
- GLM with ``beta_constraints`` as the key of a frame in the DKV equals
  the reference's at ``tests/test_torch_glm.py``'s bounds tolerance;
- GAM ``keep_gam_cols`` publishes ``{id}_gamified`` with the
  reference's names and values (1e-6, the bases' tolerance);
- DeepLearning ``export_weights_and_biases`` publishes
  ``{id}_weights_{i}``/``{id}_biases_{i}`` with the reference's shapes,
  names and, after one step, values within 1e-6 relative;
- ``ReplicaFleet.sync`` finds a trained model in the store.

Each test removes what it published, from both DKVs, and checks that
the port's keys are back to what they were.
"""

import numpy as np
import pytest
import torch

from h2o_tpu.core.cloud import cloud as j_cloud
from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models.deeplearning import DeepLearning as JDL
from h2o_tpu.models.ensemble import StackedEnsemble as JSE
from h2o_tpu.models.gam import GAM as JGAM
from h2o_tpu.models.generic import Generic as JGeneric
from h2o_tpu.models.glm import GLM as JGLM
from h2o_tpu.models.tree.drf import DRF as JDRF
from h2o_tpu.models.tree.gbm import GBM as JGBM

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.core.store import dkv as p_dkv, unpublish_on_exit
from h2o_tpu_torch.models.deeplearning import DeepLearning
from h2o_tpu_torch.models.ensemble import StackedEnsemble
from h2o_tpu_torch.models.gam import GAM
from h2o_tpu_torch.models.generic import Generic
from h2o_tpu_torch.models.glm import GLM, glm_from_jax_output
from h2o_tpu_torch.models.tree.convert import gbm_from_jax_output
from h2o_tpu_torch.models.tree.drf import DRF
from h2o_tpu_torch.models.tree.gbm import GBM
from h2o_tpu_torch.mojo import export_genmodel_mojo
from tests.test_torch_ensemble_grep import _convert, _frames as _se_frames
from tests.test_torch_gam import _wiggly


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv

_CV_KEYS = ("cross_validation_models",
            "cross_validation_holdout_predictions_frame_id",
            "cross_validation_fold_assignment_frame_id")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def stores(cl):
    """Both DKVs; what a test adds to either is removed after it, and
    the port's keys are then what they were before."""
    pd, jd = p_dkv(), j_cloud().dkv
    p0, j0 = set(pd.keys()), set(map(str, jd.keys()))
    yield pd, jd
    for k in set(pd.keys()) - p0:
        pd.remove(k, force=True)
    for k in set(map(str, jd.keys())) - j0:
        jd.remove(k, force=True)
    assert set(pd.keys()) == p0


def _binomial(n=600, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3)).astype(np.float32)
    y = (X[:, 0] - 0.7 * X[:, 1] + rng.normal(size=n) > 0).astype(np.int32)
    names = ["a", "b", "c", "y"]
    return (JFrame(names, [JVec(X[:, j]) for j in range(3)] +
                   [JVec(y, J_CAT, domain=["n", "p"])]),
            Frame(names, [Vec(X[:, j]) for j in range(3)] +
                  [Vec(y, T_CAT, domain=["n", "p"])]))


_CV = {"gbm": (JGBM, GBM, dict(ntrees=4, max_depth=3, seed=1)),
       "drf": (JDRF, DRF, dict(ntrees=3, max_depth=4, seed=2)),
       "glm": (JGLM, GLM, dict(lambda_=0.0))}


@pytest.mark.parametrize("algo", sorted(_CV))
def test_cv_artifacts_published_under_the_reference_keys(stores, algo):
    pd, jd = stores
    jcls, pcls, kw = _CV[algo]
    jf, pf = _binomial()
    kw = dict(kw, nfolds=3, fold_assignment="Modulo",
              keep_cross_validation_predictions=True,
              keep_cross_validation_fold_assignment=True,
              model_id=f"dkv_{algo}")
    jkeys0, pkeys0 = set(map(str, jd.keys())), set(pd.keys())
    jm = jcls(**kw).train(y="y", training_frame=jf)
    pm = pcls(device="cpu", **kw).train(y="y", training_frame=pf)
    jnew = set(map(str, jd.keys())) - jkeys0
    pnew = set(pd.keys()) - pkeys0
    assert pnew == jnew
    assert pnew == {f"dkv_{algo}", f"dkv_{algo}_cv_1", f"dkv_{algo}_cv_2",
                    f"dkv_{algo}_cv_3", f"cv_holdout_prediction_dkv_{algo}",
                    f"cv_fold_assignment_dkv_{algo}"}
    for k in _CV_KEYS:
        assert pm.output[k] == jm.output[k], k
    assert pd.get(f"dkv_{algo}") is pm
    for k in pm.output["cross_validation_models"]:
        assert pd.get(k).model_id == k
    hp = pd.get(pm.output["cross_validation_holdout_predictions_frame_id"])
    hj = jd.get(jm.output["cross_validation_holdout_predictions_frame_id"])
    assert str(hp.key) == str(hj.key) and hp.names == hj.names
    for name in hp.names[1:]:
        np.testing.assert_allclose(
            hp.vec(name).data, np.asarray(hj.vec(name).to_numpy())[
                : pf.nrows], rtol=0, atol=1e-5, err_msg=name)
    fp = pd.get(pm.output["cross_validation_fold_assignment_frame_id"])
    fj = jd.get(jm.output["cross_validation_fold_assignment_frame_id"])
    np.testing.assert_array_equal(
        fp.vec("fold_assignment").data,
        np.asarray(fj.vec("fold_assignment").to_numpy())[: pf.nrows])


def test_checkpoint_by_key_resumes(stores):
    pd, _ = stores
    _, pf = _binomial()
    kw = dict(max_depth=3, seed=3)
    full = GBM(device="cpu", ntrees=6, **kw).train(y="y", training_frame=pf)
    GBM(device="cpu", ntrees=3, model_id="ck_gbm", **kw).train(
        y="y", training_frame=pf)
    resumed = GBM(device="cpu", ntrees=6, checkpoint="ck_gbm",
                  **kw).train(y="y", training_frame=pf)
    assert pd.get(resumed.model_id) is resumed
    for k in ("split_col", "thr_bin", "na_left", "value"):
        np.testing.assert_array_equal(resumed.output[k], full.output[k],
                                      err_msg=k)


def test_generic_by_model_key_equals_reference(stores, tmp_path):
    pd, jd = stores
    jf, pf = _binomial()
    jm = JGBM(ntrees=3, max_depth=3, seed=1).train(y="y", training_frame=jf)
    cm = gbm_from_jax_output(
        {k: (np.asarray(v) if hasattr(v, "shape") else v)
         for k, v in jm.output.items()},
        dict(jm.params, model_id=str(jm.key)), device="cpu")
    path = str(tmp_path / "gbm_genmodel.zip")
    with open(path, "wb") as f:
        f.write(export_genmodel_mojo(cm))
    jd.put("upload_mojo_1", path)
    pd.put("upload_mojo_1", path)
    jg = JGeneric(model_key="upload_mojo_1").train()
    pg = Generic(device="cpu", model_key="upload_mojo_1").train()
    assert pd.get(pg.model_id) is pg
    np.testing.assert_array_equal(pg.predict_raw(pf).numpy(),
                                  np.asarray(jg.predict_raw(jf))[: pf.nrows])


def test_ensemble_from_keys_equals_reference(stores):
    pd, jd = stores
    jf, pf = _se_frames()
    common = dict(fold_column="fold", keep_cross_validation_predictions=True,
                  seed=1)
    jgbm = JGBM(ntrees=10, max_depth=3, **common).train(
        y="y", training_frame=jf)
    jglm = JGLM(family="binomial", **common).train(y="y", training_frame=jf)
    _convert(jgbm, gbm_from_jax_output, pf.nrows)
    _convert(jglm, glm_from_jax_output, pf.nrows)
    keys = [str(jgbm.key), str(jglm.key)]
    assert all(k in pd for k in keys)
    jse = JSE(base_models=keys).train(y="y", training_frame=jf)
    pse = StackedEnsemble(device="cpu", base_models=keys).train(
        y="y", training_frame=pf)
    meta = pd.get(pse.output["metalearner_key"])
    assert meta is pse.output["metalearner"]
    jmeta = jd.get(jse.output["metalearner_key"])
    jc, pc = jmeta.coef(), meta.coef()
    assert set(pc) == set(jc)
    for k in pc:
        np.testing.assert_allclose(pc[k], jc[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(pse.predict_raw(pf).numpy()[:, 1:],
                               np.asarray(jse.predict_raw(jf))[: pf.nrows,
                                                               1:],
                               rtol=0, atol=1e-5)


def _bc_frames():
    names, lo, hi = ["a", "b", "Intercept"], [-0.1, 0.0, -1.0], \
        [0.3, 5.0, 0.05]
    codes = np.arange(3, dtype=np.int32)
    cols = ["names", "lower_bounds", "upper_bounds"]
    return (JFrame(cols, [JVec(codes, J_CAT, domain=names),
                          JVec(np.asarray(lo, np.float32)),
                          JVec(np.asarray(hi, np.float32))]),
            Frame(cols, [Vec(codes, T_CAT, domain=names),
                         Vec(np.asarray(lo, np.float32)),
                         Vec(np.asarray(hi, np.float32))], key="bc_frame"))


def test_beta_constraints_by_key_equals_reference(stores):
    pd, jd = stores
    jf, pf = _binomial()
    jb, pb = _bc_frames()
    jd.put("bc_frame", jb)
    pd.put(pb.key, pb)
    jm = JGLM(beta_constraints="bc_frame").train(y="y", training_frame=jf)
    pm = GLM(device="cpu", beta_constraints="bc_frame").train(
        y="y", training_frame=pf)
    by_frame = GLM(device="cpu", beta_constraints=pb).train(
        y="y", training_frame=pf)
    np.testing.assert_array_equal(pm.output["beta"], by_frame.output["beta"])
    np.testing.assert_allclose(pm.output["beta"], np.asarray(
        jm.output["beta"]), rtol=0, atol=1e-5)
    co = pm.coef()
    assert -0.1 - 1e-6 <= co["a"] <= 0.3 + 1e-6 and co["b"] >= -1e-6


def test_keep_gam_cols_publishes_the_reference_frame(stores):
    pd, jd = stores
    x, y = _wiggly()
    jf = JFrame(["x", "y"], [JVec(x), JVec(y)])
    pf = Frame(["x", "y"], [Vec(x), Vec(y)])
    kw = dict(gam_columns=["x"], num_knots=10, bs=[1], lambda_=1e-2,
              seed=1, keep_gam_cols=True, model_id="gam_keep")
    jm = JGAM(**kw).train(y="y", training_frame=jf)
    pm = GAM(device="cpu", **kw).train(y="y", training_frame=pf)
    key = "gam_keep_gamified"
    assert pm.output["gam_transformed_center_key"] == \
        jm.output["gam_transformed_center_key"] == key
    pg, jg = pd.get(key), jd.get(key)
    assert pg.names == jg.names and pg.nrows == pf.nrows
    for name in pg.names:
        np.testing.assert_allclose(
            pg.vec(name).as_float(),
            np.asarray(jg.vec(name).to_numpy())[: pf.nrows],
            rtol=0, atol=1e-6, err_msg=name)


def test_export_weights_and_biases_publishes_the_reference_frames(stores):
    pd, jd = stores
    rng = np.random.default_rng(42)
    n = 1000
    X = rng.normal(size=(n, 4)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] > 0).astype(np.int32)
    names = ["a", "b", "c", "d", "y"]
    jf = JFrame(names, [JVec(X[:, j]) for j in range(4)] +
                [JVec(y, J_CAT, domain=["0", "1"])])
    pf = Frame(names, [Vec(X[:, j]) for j in range(4)] +
               [Vec(y, T_CAT, domain=["0", "1"])])
    kw = dict(hidden=[6, 5], seed=7, epochs=1024 / n,
              export_weights_and_biases=True, model_id="dl_wb")
    jm = JDL(**kw).train(y="y", training_frame=jf)
    pm = DeepLearning(device="cpu", **kw).train(y="y", training_frame=pf)
    keys = pm.output["weights_and_biases_keys"]
    assert keys == jm.output["weights_and_biases_keys"] == [
        "dl_wb_weights_1", "dl_wb_biases_1", "dl_wb_weights_2",
        "dl_wb_biases_2", "dl_wb_weights_3", "dl_wb_biases_3"]
    for k in keys:
        pw, jw = pd.get(k), jd.get(k)
        assert pw.names == jw.names and pw.nrows == jw.nrows, k
        for name in pw.names:
            np.testing.assert_allclose(
                pw.vec(name).data, np.asarray(jw.vec(name).to_numpy())[
                    : pw.nrows], rtol=1e-6, atol=1e-8, err_msg=k)


def test_fleet_sync_finds_the_trained_model_in_the_store(stores):
    from h2o_tpu_torch.serve import replica
    pd, _ = stores
    _, pf = _binomial()
    m = GBM(device="cpu", ntrees=2, max_depth=2, seed=1,
            model_id="served_gbm").train(y="y", training_frame=pf)
    replica.reset_fleet()
    try:
        fl = replica.fleet(2)
        fl.deploy("alias", m)
        fl._models.clear()          # only the store can give it back now
        fl.kill(1)
        fl.revive(1)
        dep = fl.replicas[1].registry.get("alias")
        assert dep.active.model is pd.get("served_gbm") is m
        assert fl.converged("alias")
    finally:
        replica.reset_fleet()
