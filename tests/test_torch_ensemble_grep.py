"""StackedEnsemble and Grep in the port held against ``h2o_tpu``'s on the
CPU.

StackedEnsemble on ``test_automl.py``'s frame (2,000 rows, 5 predictors,
a logistic draw on 1.5 x0 - x1 + x2 x3):

- held against the reference: its base models (CV mode: a GBM and a
  binomial GLM with a 3-fold column and their holdout predictions;
  blending mode: a GBM and a DRF, the training frame as the blending
  frame) converted into the port with the reference's keys as their
  ``model_id``, the CV holdout frames carried across; the port's
  ensemble then trains its metalearner on the same level-one frame: the
  non-negative GLM's coefficients within 1e-5 relative (of the larger of
  1 and |coefficient|: the blending columns are the converted forests'
  predictions, within 1e-7 of the reference's) and the ensemble's
  probabilities within 1e-5, labels equal where p1 is more than 1e-5
  from the threshold;
- trained end to end in the port (base models and ensemble): the
  reference test's claims (the ensemble's AUC at least the GLM's less
  0.01; a GLM metalearner; [label, p0, p1] rows; the blending ensemble's
  AUC above 0.7), ``metalearner_nfolds`` through ``_fit_cv``, the honest
  metrics' placement;
- ``stackedensemble_from_jax_output`` scores like the reference model;
  ``Model.save``/``load`` rebuilds the base models and the metalearner on
  the device asked for (here ``cpu:0``, another device object than the
  ``cpu`` they were saved from); base models or a blending frame whose
  keys the DKV does not hold, and unknown metalearners, are refused by
  name.

Grep on ``test_xgb_extras.py``'s lines and on a file: matches and
offsets equal to the reference's and to an independent ``re.finditer``;
a missing or bad regex and a frame that is not one text column refused.
"""

import os
import re
import tempfile

import numpy as np
import pytest
import torch

from h2o_tpu.core.cloud import cloud as jcloud
from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.core.frame import T_STR as J_STR
from h2o_tpu.models.ensemble import StackedEnsemble as JSE
from h2o_tpu.models.glm import GLM as JGLM
from h2o_tpu.models.grep import Grep as JGrep
from h2o_tpu.models.tree.drf import DRF as JDRF
from h2o_tpu.models.tree.gbm import GBM as JGBM

from h2o_tpu_torch.core.frame import T_CAT, T_STR, Frame, Vec
from h2o_tpu_torch.core.store import dkv as p_dkv, unpublish_on_exit
from h2o_tpu_torch.models.ensemble import (StackedEnsemble,
                                           stackedensemble_from_jax_output)
from h2o_tpu_torch.models.glm import GLM, glm_from_jax_output
from h2o_tpu_torch.models.grep import Grep, grep_from_jax_output
from h2o_tpu_torch.models.model import Model
from h2o_tpu_torch.models.tree.convert import (drf_from_jax_output,
                                               gbm_from_jax_output)
from h2o_tpu_torch.models.tree.gbm import GBM


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv

TOL = 1e-5


def _frames():
    rng = np.random.default_rng(42)
    n = 2000
    X = rng.normal(size=(n, 5)).astype(np.float32)
    logits = 1.5 * X[:, 0] - X[:, 1] + X[:, 2] * X[:, 3]
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(np.int32)
    fold = (np.arange(n) % 3).astype(np.float32)
    names = [f"x{j}" for j in range(5)] + ["y", "fold"]
    jf = JFrame(names, [JVec(X[:, j]) for j in range(5)] +
                [JVec(y, J_CAT, domain=["no", "yes"]), JVec(fold)])
    pf = Frame(names, [Vec(X[:, j]) for j in range(5)] +
               [Vec(y, T_CAT, domain=["no", "yes"]), Vec(fold)])
    return jf, pf


def _np(out):
    return {k: (np.asarray(v) if hasattr(v, "shape") else v)
            for k, v in out.items()}


def _convert(jm, conv, n):
    """A reference base model in the port, keyed as the reference keys
    it, with its CV holdout frame carried across: read from the
    reference's DKV, published under the same key in the port's."""
    pm = conv(_np(jm.output), dict(jm.params, model_id=str(jm.key)),
              device="cpu")
    fid = jm.output.get("cross_validation_holdout_predictions_frame_id")
    if fid is not None:
        hf = jcloud().dkv.get(fid)
        dom = list(jm.output["response_domain"])
        p_dkv().put(fid, Frame(
            dom, [Vec(np.asarray(hf.vec(d).to_numpy())[:n]) for d in dom],
            key=fid))
        pm.output["cross_validation_holdout_predictions_frame_id"] = fid
    p_dkv().put(pm.key, pm)
    return pm


@pytest.fixture(scope="module")
def ref(cl):
    jf, pf = _frames()
    common = dict(fold_column="fold", keep_cross_validation_predictions=True,
                  seed=1)
    jgbm = JGBM(ntrees=10, max_depth=3, **common).train(
        y="y", training_frame=jf)
    jglm = JGLM(family="binomial", **common).train(y="y", training_frame=jf)
    jse = JSE(base_models=[jgbm, jglm], seed=1).train(
        y="y", training_frame=jf)
    bgbm = JGBM(ntrees=8, max_depth=3, seed=2).train(y="y", training_frame=jf)
    bdrf = JDRF(ntrees=8, max_depth=4, seed=2).train(y="y", training_frame=jf)
    jbl = JSE(base_models=[bgbm, bdrf], blending_frame=jf, seed=2).train(
        y="y", training_frame=jf)
    n = pf.nrows
    cv = [_convert(jgbm, gbm_from_jax_output, n),
          _convert(jglm, glm_from_jax_output, n)]
    blend = [_convert(bgbm, gbm_from_jax_output, n),
             _convert(bdrf, drf_from_jax_output, n)]
    return dict(jf=jf, pf=pf, cv=(jse, cv), blend=(jbl, blend))


def _held(jse, pse, jf, pf):
    jmeta = jcloud().dkv.get(jse.output["metalearner_key"])
    pmeta = pse.output["metalearner"]
    jc, pc = jmeta.coef(), pmeta.coef()
    assert list(pc) == list(jc)
    for k, v in jc.items():
        assert abs(pc[k] - v) <= TOL * max(1.0, abs(v)), (k, pc[k], v)
    want = np.asarray(jse.predict_raw(jf))[: pf.nrows]
    got = pse.predict_raw(pf).numpy()
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=0, atol=TOL)
    decided = np.abs(want[:, 2] - 0.5) > TOL
    np.testing.assert_array_equal(got[decided, 0], want[decided, 0])


@pytest.mark.parametrize("mode", ["cv", "blend"])
def test_metalearner_matches_reference(ref, mode):
    jf, pf = ref["jf"], ref["pf"]
    jse, bases = ref[mode]
    kw = dict(blending_frame=pf) if mode == "blend" else {}
    pse = StackedEnsemble(device="cpu", base_models=bases,
                          seed=1 if mode == "cv" else 2, **kw).train(
        y="y", training_frame=pf)
    assert pse.output["metalearner_algo"] == "glm"
    _held(jse, pse, jf, pf)
    honest = "cross_validation_metrics" if mode == "cv" else \
        "validation_metrics"
    assert abs(pse.output[honest]["AUC"] - jse.output[honest]["AUC"]) <= TOL


def test_converter_scores_like_reference(ref):
    jf, pf = ref["jf"], ref["pf"]
    jse, bases = ref["cv"]
    jmeta = jcloud().dkv.get(jse.output["metalearner_key"])
    meta = glm_from_jax_output(_np(jmeta.output), jmeta.params, "cpu")
    cm = stackedensemble_from_jax_output(jse.output, jse.params, bases,
                                         meta, device="cpu")
    np.testing.assert_allclose(cm.predict_raw(pf).numpy()[:, 1:],
                               np.asarray(jse.predict_raw(jf))[: pf.nrows,
                                                                1:],
                               rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def port_end_to_end():
    _, pf = _frames()
    common = dict(device="cpu", fold_column="fold",
                  keep_cross_validation_predictions=True, seed=1)
    gbm = GBM(ntrees=10, max_depth=3, **common).train(y="y",
                                                     training_frame=pf)
    glm = GLM(family="binomial", **common).train(y="y", training_frame=pf)
    se = StackedEnsemble(device="cpu", base_models=[gbm, glm],
                         seed=1).train(y="y", training_frame=pf)
    return pf, gbm, glm, se


def test_end_to_end_claims(port_end_to_end):
    pf, gbm, glm, se = port_end_to_end
    tm = se.output["training_metrics"]
    assert tm["AUC"] >= glm.output["training_metrics"]["AUC"] - 0.01
    assert se.output["metalearner_algo"] == "glm"
    raw = se.predict_raw(pf).numpy()
    assert raw.shape == (pf.nrows, 3)
    assert "cross_validation_metrics" in se.output
    l1 = se.output["metalearner"].output["x"]
    assert l1 == [gbm.model_id, glm.model_id]
    nf = StackedEnsemble(device="cpu", base_models=[gbm, glm], seed=1,
                         metalearner_nfolds=3).train(y="y", training_frame=pf)
    assert "cross_validation_metrics" in nf.output["metalearner"].output
    bl = StackedEnsemble(device="cpu", base_models=[gbm, glm], seed=2,
                         blending_frame=pf).train(y="y", training_frame=pf)
    assert bl.output["training_metrics"]["AUC"] > 0.7
    assert "validation_metrics" in bl.output


def test_save_load_onto_another_device(port_end_to_end):
    pf, _, _, se = port_end_to_end
    want = se.predict_raw(pf).numpy()
    with tempfile.TemporaryDirectory() as d:
        back = Model.load(se.save(os.path.join(d, "se.bin")), device="cpu:0")
    other = torch.device("cpu:0")
    assert back.device == other and back.device != se.device
    for m in back.output["base_models"] + [back.output["metalearner"]]:
        assert m.device == other
    np.testing.assert_array_equal(back.predict_raw(pf).numpy(), want)


def test_refusals(port_end_to_end):
    pf, gbm, glm, _ = port_end_to_end
    # keys resolve through the DKV, and a missing one is refused as the
    # reference refuses it
    with pytest.raises(ValueError, match="not found in DKV"):
        StackedEnsemble(device="cpu", base_models=["gbm_123", glm]).train(
            y="y", training_frame=pf)
    with pytest.raises(ValueError, match="not found in DKV"):
        StackedEnsemble(device="cpu", base_models=[gbm, glm],
                        blending_frame="frame_1").train(
            y="y", training_frame=pf)
    with pytest.raises(ValueError, match="metalearner_algorithm"):
        StackedEnsemble(device="cpu", base_models=[gbm, glm],
                        metalearner_algorithm="svm").train(
            y="y", training_frame=pf)
    with pytest.raises(ValueError, match="requires base_models"):
        StackedEnsemble(device="cpu").train(y="y", training_frame=pf)
    nocv = GBM(device="cpu", ntrees=2, seed=1).train(y="y",
                                                    training_frame=pf)
    with pytest.raises(ValueError, match="holdout"):
        StackedEnsemble(device="cpu", base_models=[nocv]).train(
            y="y", training_frame=pf)


# -- Grep ---------------------------------------------------------------------

LINES = ["error: disk full", "all fine", "error: oom", "warn: slow",
         "error: disk full", None, "error:  spaced"]
REGEX = r"error: \w+"


def test_grep_matches_reference(cl):
    jm = JGrep(regex=REGEX).train(
        training_frame=JFrame(["text"], [JVec(LINES, J_STR)]))
    pm = Grep(device="cpu", regex=REGEX).train(
        training_frame=Frame(["text"], [Vec(LINES, T_STR)]))
    assert pm.output["matches"] == list(jm.output["matches"])
    assert pm.output["offsets"] == list(jm.output["offsets"])
    text = "\n".join("" if s is None else s for s in LINES)
    ms = list(re.finditer(REGEX, text))
    assert pm.output["matches"] == [m.group(0) for m in ms]
    assert pm.output["offsets"] == [m.start() for m in ms]
    assert pm.output["training_metrics"]["n_matches"] == 3
    cm = grep_from_jax_output(jm.output, jm.params, device="cpu")
    assert cm.output["matches"] == pm.output["matches"]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "log.txt")
        with open(path, "w") as f:
            f.write(text)
        fm = Grep(device="cpu", regex=REGEX).train(training_frame=path)
        assert fm.output["offsets"] == pm.output["offsets"]
        back = Model.load(fm.save(os.path.join(d, "g.bin")), device="cpu")
    assert back.output["matches"] == fm.output["matches"]
    with pytest.raises(NotImplementedError, match="score0"):
        pm.predict_raw(None)


def test_grep_refusals():
    fr = Frame(["text"], [Vec(LINES, T_STR)])
    with pytest.raises(ValueError, match="regex is missing"):
        Grep(device="cpu").train(training_frame=fr)
    with pytest.raises(ValueError, match="bad regex"):
        Grep(device="cpu", regex="(unclosed").train(training_frame=fr)
    two = Frame(["a", "b"], [Vec(LINES, T_STR), Vec(LINES, T_STR)])
    with pytest.raises(ValueError, match="exactly 1"):
        Grep(device="cpu", regex=REGEX).train(training_frame=two)
    num = Frame(["x"], [Vec(np.arange(3, dtype=np.float32))])
    with pytest.raises(ValueError, match="exactly 1"):
        Grep(device="cpu", regex=REGEX).train(training_frame=num)
    with pytest.raises(ValueError, match="no text source"):
        Grep(device="cpu", regex=REGEX).train(
            training_frame="no/such/file.txt")
