"""User-defined metrics and distributions in the port
(``h2o_tpu_torch.core.udf``) held against ``h2o_tpu.core.udf`` on the
CPU.

A user function is a zip of python source whose upload key names its
path in the DKV (the stock client's ``upload_custom_metric`` /
``upload_custom_distribution`` flow); the same zip is put under the same
key in both packages' DKVs, and removed after each test.

- ``custom_link_inv`` for identity, log, logit and inverse on a seeded
  grid with the inverse link's clamp and float32's extremes: bitwise the
  reference's on the CPU;
- a ``distribution="custom"`` GBM on the asymmetric loss of
  ``tests/test_custom_metric.py`` (first order) and on a class with a
  hessian (Newton leaves): trees equal, values, f0 and predictions
  within ``tests/test_torch_gbm.py``'s tolerances (rtol 1e-4 / atol
  1e-6, rtol 1e-6, atol 1e-5);
- ``custom_metric_func`` (the MAE class of that test) on a GBM and a
  GLM: name and value equal the reference's within the builders' metric
  tolerance (1e-5 relative), the training and the validation metrics,
  and the MAE equals the builder's own ``mae``;
- what the reference refuses (an upload key the DKV lacks, a zip without
  python source, a class the source lacks) is refused alike, by
  exception type and message.
"""

import os
import zipfile

import numpy as np
import pytest
import torch

from h2o_tpu.core import udf as j_udf
from h2o_tpu.core.cloud import cloud as j_cloud
from h2o_tpu.models.glm import GLM as JGLM
from h2o_tpu.models.tree.gbm import GBM as JGBM

from h2o_tpu_torch.core import udf as p_udf
from h2o_tpu_torch.core.store import dkv as p_dkv, unpublish_on_exit
from h2o_tpu_torch.models.glm import GLM
from h2o_tpu_torch.models.tree.gbm import GBM
from tests.test_custom_metric import CUSTOM_ASYMMETRIC, CUSTOM_MAE
from tests.test_torch_gbm import _frames


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv

CUSTOM_NEWTON = """class PseudoHuber:
    def link(self):
        return "identity"

    def init(self, w, o, y):
        return [w * y, w]

    def gradient(self, y, f):
        return (y - f) / (1.0 + (y - f) * (y - f))

    def hessian(self, y, f):
        return 1.0 / (1.0 + (y - f) * (y - f)) + f * 0.0
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def upload(tmp_path):
    """``upload(source, module, cls)`` -> the ``python:<key>=...`` ref
    of a zip holding ``source`` as ``<module>.py``, its key in both
    DKVs; the reference's keys are removed after the test (the port's
    go with ``_unpublish``)."""
    keys = []

    def put(source, module, cls, member=None):
        key = f"upload_{module}_{len(keys)}"
        path = str(tmp_path / f"{key}.zip")
        with zipfile.ZipFile(path, "w") as z:
            z.writestr(member or f"{module}.py", source)
        j_cloud().dkv.put(key, path)
        p_dkv().put(key, path)
        keys.append(key)
        return f"python:{key}={module}.{cls}"
    yield put
    for k in keys:
        j_cloud().dkv.remove(k, force=True)


# -- the inverse links --------------------------------------------------------

def _grid():
    rng = np.random.default_rng(7)
    f32 = np.finfo(np.float32)
    return np.concatenate([
        rng.normal(0, 3, 4000), rng.normal(0, 30, 2000),
        np.linspace(-100, 100, 4001),
        [0.0, -0.0, 1e-6, -1e-6, 1e-5, -1e-5, 9.99e-6, -9.99e-6, 1.5e-5,
         f32.max, -f32.max, f32.tiny, -f32.tiny, 1e-40, -1e-40,
         88.7, 88.8, -87.3, -88.8, -103.9, np.inf, -np.inf]]
    ).astype(np.float32)


@pytest.mark.parametrize("link", ["identity", "log", "logit", "inverse",
                                  None])
def test_custom_link_inv_bitwise(link):
    f = _grid()
    want = np.asarray(j_udf.custom_link_inv(link, f), np.float32)
    got = p_udf.custom_link_inv(link, torch.from_numpy(f)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# -- the custom distribution in GBM ------------------------------------------

@pytest.mark.parametrize("source,cls", [(CUSTOM_ASYMMETRIC,
                                         "AsymmetricLossDist"),
                                        (CUSTOM_NEWTON, "PseudoHuber")])
def test_custom_distribution_gbm_equals_reference(upload, source, cls, cl):
    ref = upload(source, "dist", cls)
    jf, pf = _frames(False)
    kw = dict(ntrees=4, max_depth=3, seed=1, distribution="custom",
              custom_distribution_func=ref)
    jm = JGBM(**kw).train(y="y", training_frame=jf)
    pm = GBM(device="cpu", **kw).train(y="y", training_frame=pf)
    for k in ("split_col", "thr_bin", "na_left", "bitset"):
        np.testing.assert_array_equal(pm.output[k], np.asarray(jm.output[k]),
                                      err_msg=k)
    assert (pm.output["split_col"] >= 0).sum() > 3
    np.testing.assert_allclose(pm.output["value"],
                               np.asarray(jm.output["value"]),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(pm.output["f0"], np.asarray(jm.output["f0"]),
                               rtol=1e-6)
    assert pm.output["custom_link"] == jm.output["custom_link"] == \
        "identity"
    assert pm.output["distribution_resolved"] == "custom"
    got = pm.predict_raw(pf).numpy()
    want = np.asarray(jm.predict_raw(jf))[: pf.nrows]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if cls == "AsymmetricLossDist":
        # the 3x penalty on under-prediction biases the fit upward
        assert float(np.mean(pf.vec("y").data - got)) < 0.0
    np.testing.assert_allclose(pm.output["training_metrics"]["mse"],
                               jm.output["training_metrics"]["mse"],
                               rtol=1e-4)


def test_custom_distribution_refused_outside_gbm(upload, cl):
    """GBM and its XGBoost take a user's distribution; DRF has no such
    parameter, in either package."""
    from h2o_tpu.models.tree.drf import DRF as JDRF
    from h2o_tpu_torch.models.tree.drf import DRF
    ref = upload(CUSTOM_ASYMMETRIC, "dist", "AsymmetricLossDist")
    msgs = []
    for mk in (lambda: JDRF(custom_distribution_func=ref),
               lambda: DRF(device="cpu", custom_distribution_func=ref)):
        with pytest.raises(ValueError, match="unknown params") as e:
            mk()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# -- the custom metric ---------------------------------------------------------

def _metric_pair(upload, jcls, pcls, kw):
    ref = upload(CUSTOM_MAE, "mae", "CustomMaeFunc")
    jf, pf = _frames(False)
    jv, pv = _frames(False)
    kw = dict(kw, custom_metric_func=ref)
    jm = jcls(**kw).train(y="y", training_frame=jf, validation_frame=jv)
    pm = pcls(device="cpu", **kw).train(y="y", training_frame=pf,
                                        validation_frame=pv)
    return ref, jm, pm


@pytest.mark.parametrize("algo", ["gbm", "glm"])
def test_custom_metric_equals_reference(upload, algo, cl):
    jcls, pcls, kw = (JGBM, GBM, dict(ntrees=5, max_depth=3, seed=1)) \
        if algo == "gbm" else (JGLM, GLM, dict(lambda_=0.0))
    ref, jm, pm = _metric_pair(upload, jcls, pcls, kw)
    key = ref.split("=")[0].split(":")[-1]
    for mk in ("training_metrics", "validation_metrics"):
        jt, pt = jm.output[mk], pm.output[mk]
        assert pt["custom_metric_name"] == jt["custom_metric_name"] == key
        np.testing.assert_allclose(pt["custom_metric_value"],
                                   jt["custom_metric_value"], rtol=1e-5)
    # the MAE the user's class computes is the builder's own
    tm = pm.output["training_metrics"]
    y = pm.predict_raw(_frames(False)[1]).numpy()
    mae = float(np.mean(np.abs(_frames(False)[1].vec("y").data - y)))
    np.testing.assert_allclose(tm["custom_metric_value"], mae, rtol=1e-6)


def test_custom_metric_map_reduce_equals_reference():
    rng = np.random.default_rng(2)
    act = rng.normal(size=300)
    act[::17] = np.nan
    preds = rng.normal(size=(300, 3))
    w = rng.uniform(size=300)
    ns = {}
    exec(CUSTOM_MAE, ns)
    for p in (preds, preds[:, 0]):
        want = j_udf.compute_custom_metric(ns["CustomMaeFunc"](), p, act, w)
        got = p_udf.compute_custom_metric(ns["CustomMaeFunc"](), p, act, w)
        assert got == want


# -- refusals -------------------------------------------------------------------

def _refusal(fn, ref):
    try:
        fn(ref)
    except Exception as e:  # noqa: BLE001 — the outcome under test
        return type(e).__name__, str(e)
    return None


def test_refusals_as_reference(upload):
    bad_class = upload(CUSTOM_MAE, "mae", "Nope")
    no_source = upload(CUSTOM_MAE, "mae", "CustomMaeFunc",
                       member="mae.txt")
    for ref in ("python:nokey=mae.CustomMaeFunc", bad_class, no_source):
        want = _refusal(j_udf.load_custom_func, ref)
        got = _refusal(p_udf.load_custom_func, ref)
        assert got == want and got is not None and got[0] == "ValueError"
    assert p_udf.load_custom_func("") is None
    with pytest.raises(ValueError, match="custom_distribution_func"):
        GBM(device="cpu", ntrees=1, distribution="custom").train(
            y="y", training_frame=_frames(False)[1])


def test_water_stub_serves_the_generated_wrappers(upload):
    src = ("import water.udf.CMetricFunc as MetricFunc\n\n"
           "class Wrapped(MetricFunc):\n" +
           "\n".join("    " + ln for ln in
                     CUSTOM_MAE.split("\n", 1)[1].splitlines()) + "\n")
    ref = upload(src, "wrapped", "Wrapped")
    f = p_udf.load_custom_func(ref)
    assert f.metric(f.reduce([1.0, 2.0], [3.0, 2.0])) == 1.0
    assert os.path.basename(str(p_dkv().get(ref.split(":")[1].split(
        "=")[0]))).endswith(".zip")
