"""The port's npz MOJO (``h2o_tpu_torch.mojo``) held against
``h2o_tpu.mojo`` on the CPU.

Small seeded data (a few hundred rows, 3 trees of depth 3) go through
the reference's builders; each model is carried into the port by its
converter under the reference's key as ``model_id``.  For each of the
13 npz scorers (gbm, drf, glm, kmeans, deeplearning, pca, svd, psvm,
naivebayes, xgboost, dt, gam, rulefit, and xgboost's gblinear form):

- ``export_mojo`` of the carried model writes a ``model.ini`` equal to
  the reference's, and a ``meta.json`` whose ``info`` and ``params`` are
  equal and whose ``output`` holds the reference's keys, the DKV keys
  (``training_frame_key``, ``glm_key``) included, with equal values;
  every key of ``meta.json`` and
  ``arrays.npz`` that the reference's scorer reads on the reference's
  file is in the port's file, equal (arrays bitwise, in dtype and
  shape);
- the port's ``load_mojo`` of the reference's file scores bitwise as the
  reference's ``load_mojo`` does;
- a model trained by the port on the same frame, written by the port and
  read by the reference's ``load_mojo``, scores as the port's
  ``predict_raw`` does within ``tests/test_mojo.py``'s tolerances (atol
  1e-4, rtol 1e-4).

``reference_case`` and ``carried`` are shared with the genmodel, POJO,
Generic and serving tests.
"""

import functools
import json
import os
import tempfile
import zipfile

import numpy as np
import pytest

from h2o_tpu.core.cloud import cloud as jcloud
from h2o_tpu.core.frame import (Frame as JFrame, T_CAT as J_CAT,
                                T_STR as J_STR, Vec as JVec)
from h2o_tpu.mojo import export_mojo as j_export_mojo
from h2o_tpu.mojo import load_mojo as j_load_mojo

from h2o_tpu_torch.core.frame import T_CAT, T_STR, Frame, Vec
from h2o_tpu_torch.core.store import dkv as p_dkv, unpublish_on_exit
from h2o_tpu_torch.mojo import export_mojo, load_mojo


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv

ATOL = RTOL = 1e-4          # tests/test_mojo.py:35


# ---------------------------------------------------------------------------
# data: one table per family, the same numpy columns in both packages
# ---------------------------------------------------------------------------

def _pair(cols):
    """(h2o_tpu Frame, port Frame) of ``cols``: name -> (values, domain
    for a categorical, "str" for a string column, or None)."""
    jn, jv, pv = [], [], []
    for name, (vals, dom) in cols.items():
        jn.append(name)
        if dom == "str":
            jv.append(JVec(list(vals), J_STR))
            pv.append(Vec(list(vals), T_STR))
        elif dom is not None:
            jv.append(JVec(vals, J_CAT, domain=list(dom)))
            pv.append(Vec(vals, T_CAT, domain=list(dom)))
        else:
            jv.append(JVec(vals))
            pv.append(Vec(vals))
    return JFrame(jn, jv), Frame(jn, pv)


@functools.lru_cache(maxsize=None)
def dataset(name):
    rng = np.random.default_rng(42)
    if name == "mixed":
        n = 400
        x0 = rng.normal(size=n).astype(np.float32)
        x1 = rng.normal(size=n).astype(np.float32)
        c = rng.integers(0, 5, size=n).astype(np.int32)
        x0[rng.integers(0, n, 20)] = np.nan
        c[rng.integers(0, n, 8)] = -1
        logits = 1.5 * np.nan_to_num(x0) - x1 + 0.7 * (c % 2)
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(
            np.int32)
        y3 = np.digitize(logits + rng.normal(size=n) * 0.5,
                         [-0.7, 0.7]).astype(np.int32)
        yr = (logits + rng.normal(size=n) * 0.3).astype(np.float32)
        return _pair({"x0": (x0, None), "x1": (x1, None),
                      "c": (c, ["a", "b", "cc", "d", "e"]),
                      "y": (y, ["no", "yes"]), "y3": (y3, ["r", "s", "t"]),
                      "yr": (yr, None)})
    if name == "numeric":
        n = 300
        W = rng.normal(size=(n, 2))
        H = rng.normal(size=(2, 4))
        X = (W @ H + rng.normal(size=(n, 4)) * 0.1).astype(np.float32)
        X[:6] += 5.0
        return _pair({f"n{j}": (X[:, j], None) for j in range(4)})
    if name == "tokens":
        toks = ["alpha", "beta", "gamma", "delta", None] * 40
        return _pair({"txt": (toks, "str")})
    if name == "iso":
        x = rng.uniform(-2, 2, size=300).astype(np.float32)
        y = (x + rng.normal(size=300) * 0.2).astype(np.float32)
        return _pair({"x": (x, None), "y": (y, None)})
    if name == "te":
        g = rng.integers(0, 3, size=400).astype(np.int32)
        y = (rng.uniform(size=400) < 0.2 + 0.3 * g).astype(np.int32)
        return _pair({"g": (g, ["a", "b", "c"]), "y": (y, ["n", "p"])})
    if name == "cox":
        n = 300
        age = rng.uniform(40, 80, size=n).astype(np.float32)
        grp = rng.integers(0, 2, size=n).astype(np.int32)
        hazard = 0.02 * np.exp(0.03 * (age - 60) + 0.5 * grp)
        t = rng.exponential(1.0 / hazard).astype(np.float32)
        event = (t < 30).astype(np.float32)
        return _pair({"age": (age, None), "grp": (grp, ["ctl", "trt"]),
                      "time": (np.minimum(t, 30).astype(np.float32), None),
                      "event": (event, None)})
    raise KeyError(name)


XM = ["x0", "x1", "c"]


def _train(name):
    """(reference model, dataset name) of case ``name``."""
    from h2o_tpu.models import (coxph, deeplearning, ensemble, gam, glm,
                                glrm, isotonic, kmeans, naive_bayes, pca,
                                psvm, rulefit, svd, target_encoder,
                                word2vec)
    from h2o_tpu.models.tree import drf, dt, gbm, isofor, xgboost
    tiny = dict(ntrees=3, max_depth=3, seed=1)
    if name in ("gbm", "gbm_multi", "gbm_reg"):
        y = {"gbm": "y", "gbm_multi": "y3", "gbm_reg": "yr"}[name]
        jf = dataset("mixed")[0]
        return gbm.GBM(nbins=16, **tiny).train(x=XM, y=y,
                                               training_frame=jf), "mixed"
    if name in ("drf", "drf_multi"):
        y = "y" if name == "drf" else "y3"
        jf = dataset("mixed")[0]
        return drf.DRF(nbins=16, **tiny).train(x=XM, y=y,
                                               training_frame=jf), "mixed"
    if name == "xgboost":
        return xgboost.XGBoost(**tiny).train(
            x=XM, y="y", training_frame=dataset("mixed")[0]), "mixed"
    if name == "xgboost_linear":
        return xgboost.XGBoost(booster="gblinear", ntrees=3, seed=1).train(
            x=XM, y="y", training_frame=dataset("mixed")[0]), "mixed"
    if name == "dt":
        return dt.DT(max_depth=3, seed=1).train(
            x=XM, y="y", training_frame=dataset("mixed")[0]), "mixed"
    if name in ("glm", "glm_multi", "glm_reg"):
        fam, y = {"glm": ("binomial", "y"), "glm_multi": ("multinomial",
                                                          "y3"),
                  "glm_reg": ("gaussian", "yr")}[name]
        return glm.GLM(family=fam, lambda_=0.0, seed=1).train(
            x=XM, y=y, training_frame=dataset("mixed")[0]), "mixed"
    if name == "deeplearning":
        return deeplearning.DeepLearning(hidden=[4], epochs=1, seed=1).train(
            x=XM, y="y", training_frame=dataset("mixed")[0]), "mixed"
    if name == "deeplearning_reg":
        return deeplearning.DeepLearning(hidden=[4], epochs=1, seed=1).train(
            x=XM, y="yr", training_frame=dataset("mixed")[0]), "mixed"
    if name == "naivebayes":
        return naive_bayes.NaiveBayes().train(
            x=XM, y="y", training_frame=dataset("mixed")[0]), "mixed"
    if name == "psvm":
        return psvm.PSVM(seed=1).train(
            x=["x1", "c"], y="y", training_frame=dataset("mixed")[0]), \
            "mixed"
    if name == "gam":
        return gam.GAM(family="binomial", gam_columns=["x1"],
                       num_knots=[5]).train(
            x=XM, y="y", training_frame=dataset("mixed")[0]), "mixed"
    if name == "rulefit":
        return rulefit.RuleFit(rule_generation_ntrees=4, min_rule_length=1,
                               max_rule_length=2,
                               seed=1).train(
            x=XM, y="y", training_frame=dataset("mixed")[0]), "mixed"
    if name == "kmeans":
        return kmeans.KMeans(k=2, seed=1).train(
            training_frame=dataset("numeric")[0]), "numeric"
    if name == "kmeans_cat":
        return kmeans.KMeans(k=2, seed=1).train(
            x=["x1", "c"], training_frame=dataset("mixed")[0]), "mixed"
    if name == "pca":
        return pca.PCA(k=2, seed=1).train(
            training_frame=dataset("numeric")[0]), "numeric"
    if name == "svd":
        return svd.SVD(nv=2, keep_u=False).train(
            training_frame=dataset("numeric")[0]), "numeric"
    if name == "glrm":
        return glrm.GLRM(k=2, seed=1, max_iterations=20).train(
            training_frame=dataset("numeric")[0]), "numeric"
    if name == "isolationforest":
        return isofor.IsolationForest(ntrees=5, seed=1).train(
            training_frame=dataset("numeric")[0]), "numeric"
    if name == "extendedisolationforest":
        return isofor.ExtendedIsolationForest(
            ntrees=5, sample_size=64, extension_level=1, seed=1).train(
            training_frame=dataset("numeric")[0]), "numeric"
    if name == "word2vec":
        return word2vec.Word2Vec(vec_size=6, epochs=1,
                                 min_word_freq=1).train(
            training_frame=dataset("tokens")[0]), "tokens"
    if name == "isotonicregression":
        return isotonic.IsotonicRegression().train(
            x=["x"], y="y", training_frame=dataset("iso")[0]), "iso"
    if name == "targetencoder":
        return target_encoder.TargetEncoder(noise=0.0).train(
            x=["g"], y="y", training_frame=dataset("te")[0]), "te"
    if name == "coxph":
        return coxph.CoxPH(stop_column="time").train(
            x=["age", "grp"], y="event", training_frame=dataset("cox")[0]), \
            "cox"
    if name == "stackedensemble":
        jf = dataset("mixed")[0]
        bases = [reference_case("gbm")[0], reference_case("glm")[0]]
        return ensemble.StackedEnsemble(
            base_models=[str(m.key) for m in bases], blending_frame=jf,
            seed=1).train(x=XM, y="y", training_frame=jf), "mixed"
    raise KeyError(name)


@functools.lru_cache(maxsize=None)
def _trained(name):
    """(reference model, dataset name, the models it reads by key)."""
    jm, ds = _train(name)
    keys = list(jm.output.get("base_models") or []) + \
        [k for k in [jm.output.get("metalearner_key")] if k]
    return jm, ds, [jcloud().dkv.get(k) for k in keys]


def reference_case(name):
    """(reference model, dataset name); trained once per process and
    published, with the models it reads by key, in the reference's
    current DKV at every call: a test of another file in this process
    may boot a new cloud, whose DKV starts empty."""
    jm, ds, held = _trained(name)
    for m in (jm, *held):
        jcloud().dkv.put(m.key, m)
    return jm, ds


def _np(out):
    return {k: (np.asarray(v) if hasattr(v, "shape") else v)
            for k, v in out.items()}


def _convert(jm, device):
    """The port's model of reference model ``jm`` (its key as
    ``model_id``), by its converter."""
    from h2o_tpu_torch.models import (coxph, deeplearning, gam, glm, glrm,
                                      isotonic, kmeans, naive_bayes, pca,
                                      psvm, rulefit, svd, target_encoder,
                                      word2vec)
    from h2o_tpu_torch.models.ensemble import stackedensemble_from_jax_output
    from h2o_tpu_torch.models.tree import convert
    conv = {"gbm": convert.gbm_from_jax_output,
            "drf": convert.drf_from_jax_output,
            "xgboost": convert.xgboost_from_jax_output,
            "dt": convert.dt_from_jax_output,
            "isolationforest": convert.isolationforest_from_jax_output,
            "extendedisolationforest":
                convert.extendedisolationforest_from_jax_output,
            "glm": glm.glm_from_jax_output,
            "kmeans": kmeans.kmeans_from_jax_output,
            "deeplearning": deeplearning.deeplearning_from_jax_output,
            "pca": pca.pca_from_jax_output,
            "svd": svd.svd_from_jax_output,
            "psvm": psvm.psvm_from_jax_output,
            "naivebayes": naive_bayes.naivebayes_from_jax_output,
            "gam": gam.gam_from_jax_output,
            "rulefit": rulefit.rulefit_from_jax_output,
            "glrm": glrm.glrm_from_jax_output,
            "word2vec": word2vec.word2vec_from_jax_output,
            "isotonicregression":
                isotonic.isotonicregression_from_jax_output,
            "targetencoder": target_encoder.targetencoder_from_jax_output,
            "coxph": coxph.coxph_from_jax_output}
    params = dict(jm.params, model_id=str(jm.key))
    if jm.algo == "stackedensemble":
        # keys resolve through the reference's DKV; each converted model
        # is published under the same key in the port's
        store = jcloud().dkv
        bases = [_convert(store.get(k), device)
                 for k in jm.output["base_models"]]
        meta = _convert(store.get(jm.output["metalearner_key"]), device)
        pm = stackedensemble_from_jax_output(jm.output, params, bases,
                                             meta, device=device)
    else:
        pm = conv[jm.algo](_np(jm.output), params, device=device)
    p_dkv().put(pm.key, pm)
    return pm


@functools.lru_cache(maxsize=None)
def _carried(name, device):
    jm, ds = reference_case(name)
    return jm, _convert(jm, device), ds


def carried(name, device="cpu"):
    """(reference model, the port's carried model, dataset name); the
    reference model published in the reference's current DKV."""
    reference_case(name)
    return _carried(name, device)


def raw_matrix(frame, cols):
    """(rows, len(cols)) float64 of a reference or port frame's columns:
    categorical codes with NA as NaN, numerics as they are."""
    out = np.full((frame.nrows, len(cols)), np.nan)
    for j, c in enumerate(cols):
        v = frame.vec(c)
        col = np.asarray(v.to_numpy(), np.float64)[: frame.nrows]
        if v.is_categorical:
            col = np.where(col < 0, np.nan, col)
        out[:, j] = col
    return out


# ---------------------------------------------------------------------------
# the npz artifact, file against file
# ---------------------------------------------------------------------------

NPZ = ["gbm", "gbm_multi", "gbm_reg", "drf", "drf_multi", "glm",
       "glm_multi", "glm_reg", "kmeans", "deeplearning", "deeplearning_reg",
       "pca", "svd", "psvm", "naivebayes", "xgboost", "xgboost_linear", "dt",
       "gam", "rulefit"]


class _Reads(dict):
    """A dict that records the keys a scorer reads."""

    def __init__(self, d, seen):
        super().__init__(d)
        self.seen = seen

    def __getitem__(self, k):
        self.seen.add(k)
        return super().__getitem__(k)

    def get(self, k, default=None):
        self.seen.add(k)
        return super().get(k, default)

    def __contains__(self, k):
        self.seen.add(k)
        return super().__contains__(k)

    def items(self):
        self.seen.update(self.keys())
        return super().items()


class _Prefixed:
    """The record of a nested model's reads, under its prefix."""

    def __init__(self, seen, prefix):
        self.seen, self.prefix = seen, prefix

    def add(self, k):
        self.seen.add(self.prefix + k)

    def update(self, ks):
        for k in ks:
            self.add(k)


def _recording_sub_model(arrays, meta, prefix):
    """``sub_model`` whose views record their reads in the parent's
    record (GAM's and RuleFit's inner GLM)."""
    p = prefix + "__"
    views = []
    for d in (arrays, meta):
        views.append(_Reads({k[len(p):]: v for k, v in dict.items(d)
                             if k.startswith(p)},
                            _Prefixed(getattr(d, "seen", set()), p)))
    return tuple(views)


def _read_zip(path):
    with zipfile.ZipFile(path) as z:
        ini = z.read("model.ini")
        meta = json.loads(z.read("meta.json"))
    return ini, meta


@pytest.fixture(scope="module")
def tmp():
    with tempfile.TemporaryDirectory() as d:
        yield d


def _exports(name, tmp):
    jm, cm, ds = carried(name)
    jp, pp = os.path.join(tmp, f"{name}_ref.zip"), \
        os.path.join(tmp, f"{name}_port.zip")
    j_export_mojo(jm, jp)
    export_mojo(cm, pp)
    return jm, cm, ds, jp, pp




@pytest.mark.parametrize("name", NPZ)
def test_export_mojo_equals_reference(name, tmp, monkeypatch):
    jm, cm, ds, jp, pp = _exports(name, tmp)
    j_ini, j_meta = _read_zip(jp)
    p_ini, p_meta = _read_zip(pp)
    assert p_ini == j_ini
    assert p_meta["info"] == j_meta["info"]
    assert p_meta["params"] == j_meta["params"]
    jo, po = j_meta["output"], p_meta["output"]
    assert set(po) == set(jo)
    for k in po:
        assert po[k] == jo[k], k
    # every key the reference's scorer reads is in the port's file, equal
    jmojo, pmojo = j_load_mojo(jp), load_mojo(pp)
    seen_m, seen_a = set(), set()
    jf = dataset(ds)[0]
    X = raw_matrix(jf, jmojo.columns)
    import h2o_tpu.mojo
    from h2o_tpu.mojo import scorers as jscorers
    monkeypatch.setattr(h2o_tpu.mojo, "sub_model", _recording_sub_model)
    getattr(jscorers, f"score_{jmojo.algo}")(
        _Reads(jmojo.arrays, seen_a), _Reads(jmojo.meta, seen_m), X)
    assert seen_a and seen_m
    for k in seen_m:
        assert (k in pmojo.meta) == (k in jmojo.meta), k
        if k in jmojo.meta:
            assert pmojo.meta[k] == jmojo.meta[k], k
    for k in seen_a:
        assert (k in pmojo.arrays) == (k in jmojo.arrays), k
        if k in jmojo.arrays:
            a, b = pmojo.arrays[k], jmojo.arrays[k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)
    for k in set(pmojo.arrays) & set(jmojo.arrays):
        np.testing.assert_array_equal(pmojo.arrays[k], jmojo.arrays[k],
                                      err_msg=k)
    # and both files score alike in both packages' readers
    np.testing.assert_array_equal(pmojo.score_matrix(X),
                                  jmojo.score_matrix(X))


@pytest.mark.parametrize("name", NPZ)
def test_port_reads_reference_file_bitwise(name, tmp):
    jm, cm, ds, jp, pp = _exports(name, tmp)
    jmojo, pmojo = j_load_mojo(jp), load_mojo(jp)
    assert pmojo.columns == jmojo.columns
    assert pmojo.response_domain == jmojo.response_domain
    X = raw_matrix(dataset(ds)[0], jmojo.columns)
    np.testing.assert_array_equal(pmojo.score_matrix(X),
                                  jmojo.score_matrix(X))


def _port_trained(name):
    """A model of case ``name`` trained by the port on the same frame."""
    from h2o_tpu_torch.models.deeplearning import DeepLearning
    from h2o_tpu_torch.models.glm import GLM
    from h2o_tpu_torch.models.kmeans import KMeans
    from h2o_tpu_torch.models.naive_bayes import NaiveBayes
    from h2o_tpu_torch.models.pca import PCA
    from h2o_tpu_torch.models.tree.drf import DRF
    from h2o_tpu_torch.models.tree.gbm import GBM
    from h2o_tpu_torch.models.tree.xgboost import XGBoost
    pf = dataset("mixed")[1]
    tiny = dict(device="cpu", ntrees=3, max_depth=3, seed=1)
    if name == "gbm":
        return GBM(nbins=16, **tiny).train(x=XM, y="y", training_frame=pf)
    if name == "gbm_multi":
        return GBM(nbins=16, **tiny).train(x=XM, y="y3", training_frame=pf)
    if name == "drf":
        return DRF(nbins=16, **tiny).train(x=XM, y="y", training_frame=pf)
    if name == "xgboost":
        return XGBoost(**tiny).train(x=XM, y="y", training_frame=pf)
    if name == "glm":
        return GLM(device="cpu", family="binomial", lambda_=0.0).train(
            x=XM, y="y", training_frame=pf)
    if name == "deeplearning":
        return DeepLearning(device="cpu", hidden=[4], epochs=1, seed=1).train(
            x=XM, y="y", training_frame=pf)
    if name == "naivebayes":
        return NaiveBayes(device="cpu").train(x=XM, y="y", training_frame=pf)
    nf = dataset("numeric")[1]
    if name == "kmeans":
        return KMeans(device="cpu", k=2, seed=1).train(training_frame=nf)
    if name == "pca":
        return PCA(device="cpu", k=2, seed=1).train(training_frame=nf)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["gbm", "gbm_multi", "drf", "xgboost",
                                  "glm", "deeplearning", "naivebayes",
                                  "kmeans", "pca"])
def test_port_trained_mojo_scores_in_reference(name, tmp):
    pm = _port_trained(name)
    path = os.path.join(tmp, f"{name}_trained.zip")
    export_mojo(pm, path)
    mojo = j_load_mojo(path)
    pf = dataset("numeric" if name in ("kmeans", "pca") else "mixed")[1]
    X = raw_matrix(pf, mojo.columns)
    np.testing.assert_allclose(mojo.score_matrix(X),
                               pm.predict_raw(pf).numpy(), atol=ATOL,
                               rtol=RTOL)


def test_export_refusals_match_reference(tmp):
    """No scorer, and a custom distribution, raise as the reference's."""
    from types import SimpleNamespace
    for out, algo in (({}, "isolationforest"),
                      ({"custom_link": "python:x"}, "gbm")):
        stub = SimpleNamespace(algo=algo, key="m", model_id="m", params={},
                               output=out)
        with pytest.raises(NotImplementedError) as want:
            j_export_mojo(stub, os.path.join(tmp, "r.zip"))
        with pytest.raises(NotImplementedError) as got:
            export_mojo(stub, os.path.join(tmp, "p.zip"))
        assert str(got.value) == str(want.value)


def test_easy_predict_wrapper_and_encode_match_reference(tmp):
    from h2o_tpu.mojo import EasyPredictModelWrapper as JWrap
    from h2o_tpu_torch.mojo import EasyPredictModelWrapper
    _, _, _, jp, pp = _exports("gbm", tmp)
    jw, pw = JWrap(j_load_mojo(jp)), EasyPredictModelWrapper(load_mojo(pp))
    for row in ({"x0": 1.0, "x1": -0.5, "c": "cc"},
                {"x0": 1.0, "x1": -0.5, "c": "purple"},
                {"x1": 0.25}):
        assert pw.predict(row) == jw.predict(row)
