"""Every builder of the port takes the reference builder's full default
param set, as a client that sends all params does.

For each of GBM, DRF, XGBoost, DT, IsolationForest,
ExtendedIsolationForest, UpliftDRF, GLM, KMeans, DeepLearning, GAM,
RuleFit, PCA, SVD, GLRM, Word2Vec, NaiveBayes, CoxPH,
IsotonicRegression, Aggregator, TargetEncoder, ModelSelection,
AnovaGLM, PSVM, Infogram, StackedEnsemble, Grep and Generic the port's
builder is
constructed with ``h2o_tpu``'s ``default_params()`` passed explicitly
(nothing may be "unknown", no accepted default may be refused, and every
param resolves to the value the reference builder resolves it to), and
trains a small frame with them (the tree builders' ntrees cut to 2,
RuleFit's rule trees to 4, GAM given one gam column, CoxPH a stop
column, Word2Vec a token column, IsotonicRegression one predictor,
TargetEncoder a categorical, StackedEnsemble a cross-validated GLM as
its base model, Grep a regex over a text column, Generic the path of a
GLM's MOJO: it imports the model, which scores and, like the
reference's, holds no training metrics).  Each model of the
nine builders from IsotonicRegression on trained so round-trips through
``Model.save``/``load`` (the StackedEnsemble onto ``cpu:0``, another
device than the ``cpu`` it was saved from, base models and metalearner
included) and scores, transforms or reports as before.  Word2Vec's
reference refuses its own
default ``norm_model="NegSampling"`` (its ENGINE_FIXED accepts HSM
only), so its resolved params are compared with the reference's
defaults instead.
GBM and XGBoost take ``custom_distribution_func`` as the reference's do
(unused unless ``distribution="custom"``, whose function must be in the
DKV); ``calibrate_model=True`` is refused by name.  What the port
refuses by name instead of dropping: iteration checkpoints (``recovery_dir`` or ``checkpoint_interval``
for KMeans, DeepLearning, GAM, RuleFit and the six builders of PCA to
CoxPH: P14) and DeepLearning's ``model_parallel`` over
several cards (P8).
"""

import numpy as np
import pytest
import torch

from h2o_tpu.models.coxph import CoxPH as JCoxPH
from h2o_tpu.models.deeplearning import DeepLearning as JDL
from h2o_tpu.models.gam import GAM as JGAM
from h2o_tpu.models.glm import GLM as JGLM
from h2o_tpu.models.glrm import GLRM as JGLRM
from h2o_tpu.models.kmeans import KMeans as JKMeans
from h2o_tpu.models.naive_bayes import NaiveBayes as JNB
from h2o_tpu.models.pca import PCA as JPCA
from h2o_tpu.models.rulefit import RuleFit as JRuleFit
from h2o_tpu.models.svd import SVD as JSVD
from h2o_tpu.models.tree.drf import DRF as JDRF
from h2o_tpu.models.tree.dt import DT as JDT
from h2o_tpu.models.tree.gbm import GBM as JGBM
from h2o_tpu.models.tree.isofor import (ExtendedIsolationForest as JEIF,
                                        IsolationForest as JIF)
from h2o_tpu.models.tree.uplift import UpliftDRF as JUplift
from h2o_tpu.models.tree.xgboost import XGBoost as JXGB
from h2o_tpu.models.word2vec import Word2Vec as JW2V
from h2o_tpu.models.aggregator import Aggregator as JAgg
from h2o_tpu.models.anovaglm import AnovaGLM as JAnova
from h2o_tpu.models.ensemble import StackedEnsemble as JSE
from h2o_tpu.models.generic import Generic as JGeneric
from h2o_tpu.models.grep import Grep as JGrep
from h2o_tpu.models.infogram import Infogram as JInfogram
from h2o_tpu.models.isotonic import IsotonicRegression as JIso
from h2o_tpu.models.modelselection import ModelSelection as JMS
from h2o_tpu.models.psvm import PSVM as JPSVM
from h2o_tpu.models.target_encoder import TargetEncoder as JTE

from h2o_tpu_torch.core.frame import T_CAT, T_STR, Frame, Vec
from h2o_tpu_torch.models.coxph import CoxPH
from h2o_tpu_torch.models.deeplearning import DeepLearning
from h2o_tpu_torch.models.gam import GAM
from h2o_tpu_torch.models.glm import GLM
from h2o_tpu_torch.models.glrm import GLRM
from h2o_tpu_torch.models.kmeans import KMeans
from h2o_tpu_torch.models.naive_bayes import NaiveBayes
from h2o_tpu_torch.models.pca import PCA
from h2o_tpu_torch.models.rulefit import RuleFit
from h2o_tpu_torch.models.svd import SVD
from h2o_tpu_torch.models.tree.drf import DRF
from h2o_tpu_torch.models.tree.dt import DT
from h2o_tpu_torch.models.tree.gbm import GBM
from h2o_tpu_torch.models.tree.isofor import (ExtendedIsolationForest,
                                              IsolationForest)
from h2o_tpu_torch.models.tree.uplift import UpliftDRF
from h2o_tpu_torch.models.tree.xgboost import XGBoost
from h2o_tpu_torch.models.word2vec import Word2Vec
from h2o_tpu_torch.models.aggregator import Aggregator
from h2o_tpu_torch.models.anovaglm import AnovaGLM
from h2o_tpu_torch.models.ensemble import StackedEnsemble
from h2o_tpu_torch.models.generic import Generic
from h2o_tpu_torch.models.grep import Grep
from h2o_tpu_torch.models.infogram import Infogram
from h2o_tpu_torch.models.isotonic import IsotonicRegression
from h2o_tpu_torch.models.model import Model
from h2o_tpu_torch.models.modelselection import ModelSelection
from h2o_tpu_torch.models.psvm import PSVM
from h2o_tpu_torch.models.target_encoder import TargetEncoder
from h2o_tpu_torch.core.store import unpublish_on_exit


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


PAIRS = {"gbm": (JGBM, GBM), "drf": (JDRF, DRF), "xgboost": (JXGB, XGBoost),
         "dt": (JDT, DT), "isolationforest": (JIF, IsolationForest),
         "extendedisolationforest": (JEIF, ExtendedIsolationForest),
         "upliftdrf": (JUplift, UpliftDRF), "glm": (JGLM, GLM),
         "kmeans": (JKMeans, KMeans), "deeplearning": (JDL, DeepLearning),
         "gam": (JGAM, GAM), "rulefit": (JRuleFit, RuleFit),
         "pca": (JPCA, PCA), "svd": (JSVD, SVD), "glrm": (JGLRM, GLRM),
         "word2vec": (JW2V, Word2Vec), "naivebayes": (JNB, NaiveBayes),
         "coxph": (JCoxPH, CoxPH),
         "isotonicregression": (JIso, IsotonicRegression),
         "aggregator": (JAgg, Aggregator),
         "targetencoder": (JTE, TargetEncoder),
         "modelselection": (JMS, ModelSelection),
         "anovaglm": (JAnova, AnovaGLM),
         "psvm": (JPSVM, PSVM), "infogram": (JInfogram, Infogram),
         "stackedensemble": (JSE, StackedEnsemble), "grep": (JGrep, Grep),
         "generic": (JGeneric, Generic)}
#: the builders whose default-trained models also round-trip
SLICE11 = ("isotonicregression", "aggregator", "targetencoder",
           "modelselection", "anovaglm", "psvm", "infogram",
           "stackedensemble", "grep")
#: what a small training needs beyond the reference defaults
_TRAIN_KW = {"gam": dict(gam_columns=["a"]),
             "rulefit": dict(rule_generation_ntrees=4),
             "coxph": dict(stop_column="a"), "grep": dict(regex="[ae]b")}
#: the predictors of a small training where not a, b and c
_TRAIN_X = {"isotonicregression": ["a"], "targetencoder": ["a", "treatment"]}
_WORDS = [w for _ in range(60) for w in ("ab", "cd", "ef", None)]


def _frame(n=300):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, 3)).astype(np.float32)
    t = rng.integers(0, 2, n).astype(np.int32)
    y = (X[:, 0] + 0.5 * t * (X[:, 1] > 0) +
         rng.normal(size=n) > 0).astype(np.int32)
    return Frame(["a", "b", "c", "treatment", "y"],
                 [Vec(X[:, j]) for j in range(3)] +
                 [Vec(t, T_CAT, domain=["0", "1"]),
                  Vec(y, T_CAT, domain=["n", "p"])])


@pytest.mark.parametrize("algo", sorted(PAIRS))
def test_reference_defaults_are_accepted(algo):
    jcls, pcls = PAIRS[algo]
    ref = jcls().default_params()
    b = pcls(device="cpu", **ref)
    # resolved as the reference resolves them (XGBoost maps its names
    # onto the engine's)
    want = (jcls() if algo == "word2vec" else jcls(**ref)).params
    assert set(want) <= set(b.params)
    for k, v in want.items():
        assert b.params[k] == v, k


def _train_defaults(algo):
    """The port model of ``algo`` trained with the reference's defaults
    (and what a small training needs), and its training frame."""
    jcls, pcls = PAIRS[algo]
    params = jcls().default_params()
    if "ntrees" in params:
        params["ntrees"] = 2
    params.update(_TRAIN_KW.get(algo, {}))
    fr = _frame()
    if algo == "stackedensemble":
        params["base_models"] = [GLM(
            device="cpu", family="binomial", nfolds=2, seed=1,
            keep_cross_validation_predictions=True).train(
                x=["a", "b", "c"], y="y", training_frame=fr)]
    if algo == "generic":
        # the artifact is the training input: a GLM's MOJO, read at train
        import tempfile
        from h2o_tpu_torch.mojo import export_mojo
        src = GLM(device="cpu", family="binomial").train(
            x=["a", "b", "c"], y="y", training_frame=fr)
        with tempfile.TemporaryDirectory() as d:
            params["path"] = export_mojo(src, f"{d}/glm.zip")
            return pcls(device="cpu", **params).train(), fr
    b = pcls(device="cpu", **params)
    if algo in ("word2vec", "grep"):
        fr = Frame(["t"], [Vec(_WORDS, T_STR)])
        return b.train(training_frame=fr), fr
    x = _TRAIN_X.get(algo, ["a", "b", "c"])
    if b.supervised:
        return b.train(x=x, y="y", training_frame=fr), fr
    return b.train(x=x, training_frame=fr), fr


_trained = {}


def _trained_defaults(algo):
    if algo not in _trained:
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")         # PSVM's engine note
            _trained[algo] = _train_defaults(algo)
    return _trained[algo]


@pytest.mark.parametrize("algo", sorted(PAIRS))
def test_reference_defaults_train(algo):
    m, fr = _trained_defaults(algo)
    if algo == "generic":
        # an imported model scores; it carries no training metrics, as
        # the reference's GenericModel does not
        assert m.output["source_algo"] == "glm"
        assert m.predict_raw(fr).shape == (fr.nrows, 3)
        return
    if algo == "glm":
        assert m.params["_solver_resolved"] == "IRLSM"
        assert np.isfinite(m.output["beta"]).all()
    elif algo == "kmeans":
        assert m.output["k"] == 1 and m.output["iterations"] >= 1
    elif algo == "deeplearning":
        # 10 epochs of 300 rows in batches of the padded 384
        assert m.output["steps"] == 7 and m.output["batch"] == 384
    elif algo in ("gam", "rulefit"):
        assert np.isfinite(m.output["glm_output"]["beta"]).all()
    elif algo == "pca":
        assert m.output["eigenvectors"].shape == (3, 1)
    elif algo == "svd":                     # keep_u is on by default
        assert m.output["u_frame"].nrows == fr.nrows
    elif algo == "glrm":
        assert m.output["iterations"] >= 1 and m.output["k"] == 1
    elif algo == "word2vec":
        assert m.output["words"] == ["ab", "cd", "ef"]
    elif algo == "naivebayes":
        assert 0.5 < m.output["training_metrics"]["AUC"] <= 1.0
    elif algo == "coxph":
        assert m.output["coef_names"] == ["b", "c"] and \
            m.output["iterations"] >= 1
    elif algo == "isotonicregression":
        assert m.output["nobs"] == fr.nrows
    elif algo == "aggregator":
        assert m.aggregated_frame().nrows == m.output["num_exemplars"] > 0
    elif algo == "targetencoder":
        assert m.output["columns"] == ["treatment"]
    elif algo == "modelselection":
        assert sorted(m.output["best_models"]) == [1]
    elif algo == "anovaglm":
        assert [r[0] for r in m.result()] == ["a", "b", "c"]
    elif algo == "psvm":
        assert m.output["feature_dim"] == 256
    elif algo == "infogram":
        assert [r[0] for r in m.result()][0] == "a"
    elif algo == "stackedensemble":
        assert m.output["metalearner_algo"] == "glm"
    elif algo == "grep":
        assert m.output["matches"] == ["ab"] * 60
    else:
        assert m.output["ntrees_actual"] == (1 if algo == "dt" else 2)
    assert m.output["training_metrics"] is not None


def _behaviour(algo, m, fr):
    """What a model of ``algo`` gives back: scores, an encoding, a table
    or matches."""
    if algo == "targetencoder":
        return m.transform(fr).vec("treatment_te").to_numpy()
    if algo in ("modelselection", "anovaglm", "infogram"):
        return m.output["training_metrics"].data
    if algo == "grep":
        return (m.output["matches"], m.output["offsets"])
    return m.predict_raw(fr).numpy()


@pytest.mark.parametrize("algo", SLICE11)
def test_slice11_models_round_trip(algo, tmp_path):
    m, fr = _trained_defaults(algo)
    device = "cpu:0" if algo == "stackedensemble" else "cpu"
    back = Model.load(m.save(str(tmp_path / f"{algo}.bin")), device=device)
    assert type(back) is type(m) and back.model_id == m.model_id
    assert back.device == torch.device(device)
    want, got = _behaviour(algo, m, fr), _behaviour(algo, back, fr)
    if isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want
    if algo == "stackedensemble":
        assert back.device != m.device
        held = back.output["base_models"] + [back.output["metalearner"]]
        assert all(h.device == torch.device(device) for h in held)
    if algo == "modelselection":
        assert back.output["best_models"][1]["model"].device == \
            torch.device(device)


@pytest.mark.parametrize("algo", ["gbm", "xgboost"])
def test_custom_distribution_func_names_p13(algo):
    _, pcls = PAIRS[algo]
    # the reference reads the function only under distribution="custom"
    pcls(device="cpu", ntrees=1,
         custom_distribution_func="python:dist=my.Dist").train(
        y="y", training_frame=_frame())
    with pytest.raises(ValueError, match="'dist' not found"):
        pcls(device="cpu", ntrees=1, distribution="custom",
             custom_distribution_func="python:dist=my.Dist").train(
            y="y", training_frame=_frame())
    with pytest.raises(ValueError, match="calibrate_model"):
        pcls(device="cpu", calibrate_model=True)
    # a single device builds every tree on one node already
    assert pcls(device="cpu", build_tree_one_node=True).params[
        "build_tree_one_node"] is True


_SMALL = {"kmeans": dict(k=2), "deeplearning": dict(hidden=[4], epochs=1.0),
          "aggregator": dict(target_num_exemplars=10), "psvm": {},
          "infogram": {}, "modelselection": {}, "isotonicregression": {},
          "gam": dict(gam_columns=["a"]),
          "rulefit": dict(rule_generation_ntrees=2), "pca": {}, "svd": {},
          "glrm": {}, "word2vec": {}, "naivebayes": {},
          "coxph": dict(stop_column="a")}


@pytest.mark.parametrize("algo,kw,match", [
    ("kmeans", dict(recovery_dir="ck"), "P14"),
    ("deeplearning", dict(recovery_dir="ck"), "P14"),
    ("deeplearning", dict(checkpoint_interval=1), "P14"),
    ("gam", dict(recovery_dir="ck"), "P14"),
    ("rulefit", dict(recovery_dir="ck"), "P14"),
    ("pca", dict(recovery_dir="ck"), "P14"),
    ("svd", dict(checkpoint_interval=1), "P14"),
    ("glrm", dict(recovery_dir="ck"), "P14"),
    ("word2vec", dict(recovery_dir="ck"), "P14"),
    ("naivebayes", dict(checkpoint_interval=2), "P14"),
    ("coxph", dict(recovery_dir="ck"), "P14"),
    ("aggregator", dict(recovery_dir="ck"), "P14"),
    ("psvm", dict(checkpoint_interval=1), "P14"),
    ("infogram", dict(recovery_dir="ck"), "P14"),
    ("modelselection", dict(checkpoint_interval=1), "P14"),
    ("isotonicregression", dict(recovery_dir="ck"), "P14"),
], ids=["kmeans_recovery", "dl_recovery",
        "dl_checkpoint_interval", "gam_recovery", "rulefit_recovery",
        "pca_recovery", "svd_checkpoint_interval", "glrm_recovery",
        "word2vec_recovery", "naivebayes_checkpoint_interval",
        "coxph_recovery", "aggregator_recovery", "psvm_checkpoint_interval",
        "infogram_recovery", "modelselection_checkpoint_interval",
        "isotonic_recovery"])
def test_refused_by_name(algo, kw, match):
    _, pcls = PAIRS[algo]
    b = pcls(device="cpu", **_SMALL[algo], **kw)
    with pytest.raises(NotImplementedError, match=match):
        if b.supervised:
            b.train(x=["a", "b", "c"], y="y", training_frame=_frame())
        else:
            b.train(x=["a", "b", "c"], training_frame=_frame())


def test_dl_model_parallel_over_several_cards_names_p8(monkeypatch):
    """model_parallel on one device is the identity (the reference's
    one-wide model axis); on a machine with several cards it raises
    instead of training unsharded."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    b = DeepLearning(device="cuda:0", hidden=[4], model_parallel=True)
    with pytest.raises(NotImplementedError, match="P8"):
        b.train(x=["a", "b", "c"], y="y", training_frame=_frame())
