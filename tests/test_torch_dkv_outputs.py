"""The five builders' outputs published in the port's DKV
(``store.dkv()``), held against ``h2o_tpu``'s ``cloud().dkv`` on the CPU
on the same seeded inputs, each of the five given the same ``model_id``
in both packages:

- Aggregator's ``aggregated_<model_id>`` under ``output_frame_key``:
  names, types, domains and values equal (the reference's exemplar rows
  and counts; ``tests/test_torch_isotonic_aggregator.py``'s clustered
  rows);
- AnovaGLM's full GLM under ``full_model_id`` (a ``glm_<hex>`` key in
  both): coefficients within 1e-5 relative of the reference's;
- GLRM's ``glrm_rep_<model_id>`` under ``representation_key``: names
  ``Arch1..Archk``, one row a training row; values within 1e-4 of the
  largest |value| (the recovery case of ``tests/test_torch_glrm.py``,
  whose objectives agree to 1e-5 relative);
- SVD's ``svd_u_<model_id>`` under ``u_key``: names and U within 1e-5,
  each column's sign the reference's;
- ModelSelection's best GLM of each size under its ``model_id``
  (``glm_<hex>`` keys): predictors equal, coefficients 1e-5 relative.

The keys each package publishes are the same set (random ``glm_<hex>``
keys compared by count), and every published object is the one the
output names.  A build stopped after its last report publishes none of
them.  Each test removes what it published from both DKVs and checks
that the port's keys are back to what they were.
"""

import numpy as np
import pytest
import torch

from h2o_tpu.core.cloud import cloud as j_cloud
from h2o_tpu.models.aggregator import Aggregator as JAgg
from h2o_tpu.models.anovaglm import AnovaGLM as JAnova
from h2o_tpu.models.glrm import GLRM as JGLRM
from h2o_tpu.models.modelselection import ModelSelection as JMS
from h2o_tpu.models.svd import SVD as JSVD

from h2o_tpu_torch.core.job import JobCancelledException
from h2o_tpu_torch.core.store import dkv as p_dkv, unpublish_on_exit
from h2o_tpu_torch.models.aggregator import Aggregator
from h2o_tpu_torch.models.anovaglm import AnovaGLM
from h2o_tpu_torch.models.glrm import GLRM
from h2o_tpu_torch.models.modelselection import ModelSelection
from h2o_tpu_torch.models.svd import SVD
from h2o_tpu_torch.ops import statpack
from tests.test_torch_glrm import _low_rank, _pair as _glrm_pair
from tests.test_torch_isotonic_aggregator import _agg_data
from tests.test_torch_modelselection_anova import _anova_data, _ms_data
from tests.test_torch_pca_svd import _data as _svd_data


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv


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


def _glrm_frames():
    return _glrm_pair(_low_rank())


#: builder -> (reference class, port class, frames, params, response)
CASES = {
    "aggregator": (JAgg, Aggregator, lambda: _agg_data("categorical")[0],
                   _agg_data("categorical")[1], None),
    "anovaglm": (JAnova, AnovaGLM, lambda: _anova_data(
        "binomial_interactions")[0], dict(_anova_data(
            "binomial_interactions")[1], seed=1), "y"),
    "glrm": (JGLRM, GLRM, _glrm_frames,
             dict(k=3, max_iterations=300, seed=1), None),
    "svd": (JSVD, SVD, lambda: _svd_data("corr"), dict(nv=3, keep_u=True),
            None),
    "modelselection": (JMS, ModelSelection, lambda: _ms_data("maxr")[0],
                       dict(_ms_data("maxr")[1], seed=1), "y"),
}


def _train_both(stores, case):
    """Train both packages' builders with ``model_id`` ``dkv_<case>``:
    the two models and the keys each published."""
    pd, jd = stores
    jcls, pcls, frames, kw, y = CASES[case]
    jf, pf = frames()
    kw = dict(kw, model_id=f"dkv_{case}")
    j0, p0 = set(map(str, jd.keys())), set(pd.keys())
    with pytest.MonkeyPatch.context() as mp:
        # the GLRM of tests/test_torch_glrm.py: R is the mesh's padding
        mp.setattr(statpack, "ROW_QUANTUM", 64)
        jm = jcls(**kw).train(y=y, training_frame=jf)
        pm = pcls(device="cpu", **kw).train(y=y, training_frame=pf)
    return (jf, pf, jm, pm, set(map(str, jd.keys())) - j0,
            set(pd.keys()) - p0)


def _glm_keys(keys):
    """The random ``glm_<hex>`` keys apart, counted; the rest as a set."""
    glm = {k for k in keys if k.startswith("glm_")}
    return len(glm), keys - glm


def _same_keys(jnew, pnew):
    assert _glm_keys(pnew) == _glm_keys(jnew)


def test_aggregator_frame_published(stores):
    pd, jd = stores
    jf, pf, jm, pm, jnew, pnew = _train_both(stores, "aggregator")
    _same_keys(jnew, pnew)
    assert pnew == {"dkv_aggregator", "aggregated_dkv_aggregator"}
    key = pm.output["output_frame_key"]
    assert key == jm.output["output_frame_key"] == \
        "aggregated_dkv_aggregator"
    pfr, jfr = pd.get(key), jd.get(key)
    assert pfr is pm.aggregated_frame() and str(pfr.key) == key
    assert pfr.names == jfr.names and pfr.nrows == jfr.nrows
    for name in pfr.names:
        pv, jv = pfr.vec(name), jfr.vec(name)
        assert pv.type == jv.type and pv.domain == jv.domain, name
        np.testing.assert_array_equal(
            pv.to_numpy(), np.asarray(jv.to_numpy())[: pfr.nrows],
            err_msg=name)


def test_anovaglm_full_model_published(stores):
    pd, jd = stores
    jf, pf, jm, pm, jnew, pnew = _train_both(stores, "anovaglm")
    _same_keys(jnew, pnew)
    assert _glm_keys(pnew) == (1, {"dkv_anovaglm"})
    key = pm.output["full_model_id"]
    assert key.startswith("glm_") and key in pnew
    assert pd.get(key) is pm.output["full_model"]
    jfull = jd.get(jm.output["full_model_id"])
    pc, jc = pd.get(key).coef(), jfull.coef()
    assert list(pc) == list(jc)
    for k, v in jc.items():
        assert abs(pc[k] - v) <= 1e-5 * max(1.0, abs(v)), k


def test_glrm_representation_published(stores):
    pd, jd = stores
    jf, pf, jm, pm, jnew, pnew = _train_both(stores, "glrm")
    _same_keys(jnew, pnew)
    assert pnew == {"dkv_glrm", "glrm_rep_dkv_glrm"}
    key = pm.output["representation_key"]
    assert key == jm.output["representation_key"] == "glrm_rep_dkv_glrm"
    pfr, jfr = pd.get(key), jd.get(key)
    assert pfr is pm.output["representation_frame"]
    assert pfr.names == jfr.names == ["Arch1", "Arch2", "Arch3"]
    assert pfr.nrows == pf.nrows
    P = np.stack([pfr.vec(c).to_numpy() for c in pfr.names], 1)
    J = np.stack([np.asarray(jfr.vec(c).to_numpy())[: pf.nrows]
                  for c in jfr.names], 1)
    np.testing.assert_allclose(P, J, rtol=0, atol=1e-4 * np.abs(J).max())


def test_svd_u_published(stores):
    pd, jd = stores
    jf, pf, jm, pm, jnew, pnew = _train_both(stores, "svd")
    _same_keys(jnew, pnew)
    assert pnew == {"dkv_svd", "svd_u_dkv_svd"}
    key = pm.output["u_key"]
    assert key == jm.output["u_key"] == "svd_u_dkv_svd"
    pfr, jfr = pd.get(key), jd.get(key)
    assert pfr is pm.output["u_frame"]
    assert pfr.names == jfr.names == ["u1", "u2", "u3"]
    U = np.stack([pfr.vec(c).to_numpy() for c in pfr.names], 1)
    J = np.stack([np.asarray(jfr.vec(c).to_numpy())[: pf.nrows]
                  for c in jfr.names], 1)
    np.testing.assert_array_equal(np.sign(U[0]), np.sign(J[0]))
    np.testing.assert_allclose(U, J, rtol=0, atol=1e-5)


def test_modelselection_best_models_published(stores):
    pd, jd = stores
    jf, pf, jm, pm, jnew, pnew = _train_both(stores, "modelselection")
    _same_keys(jnew, pnew)
    jb, pb = jm.best_model_per_size(), pm.best_model_per_size()
    assert _glm_keys(pnew) == (len(jb), {"dkv_modelselection"})
    assert sorted(pb) == sorted(jb) == [1, 2, 3]
    for size, rec in pb.items():
        assert rec["model_id"] in pnew
        assert pd.get(rec["model_id"]) is rec["model"]
        jg = jd.get(jb[size]["model_id"])
        assert rec["predictors"] == jb[size]["predictors"]
        pc, jc = rec["model"].coef(), jg.coef()
        assert list(pc) == list(jc)
        for k, v in jc.items():
            assert abs(pc[k] - v) <= 1e-5 * max(1.0, abs(v)), (size, k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_stopped_after_its_last_report_publishes_nothing(
        stores, monkeypatch, case):
    """The job is cancelled when ``_fit`` returns, after every report
    and every ``publish``: the body's stop check raises, and neither the
    model nor the outputs it held back are published."""
    pd, _ = stores
    _, pcls, frames, kw, y = CASES[case]
    _, pf = frames()
    fit = pcls._fit

    def fit_then_cancel(self, *a, **k):
        out = fit(self, *a, **k)
        self._job.cancel()
        return out

    monkeypatch.setattr(pcls, "_fit", fit_then_cancel)
    monkeypatch.setattr(statpack, "ROW_QUANTUM", 64)
    keys0 = set(pd.keys())
    job = pcls(device="cpu", model_id=f"stopped_{case}", **kw).train_async(
        y=y, training_frame=pf)
    with pytest.raises(JobCancelledException):
        job.join()
    assert set(pd.keys()) == keys0
