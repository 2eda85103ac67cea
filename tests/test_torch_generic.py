"""The port's Generic builder (``h2o_tpu_torch.models.generic``) held
against ``h2o_tpu.models.generic`` on the CPU.

A carried GBM, GLM and StackedEnsemble are written by the port in both
formats (the npz MOJO and the genmodel zip); ``Generic(path=...)`` and
``import_mojo`` of each file give ``predict_raw`` and ``predict`` equal,
bitwise, to the reference's ``GenericModel`` of the same file, on the
training frame and on a frame whose categorical domain is in another
order and holds an unseen level (the adaptTestForTrain remap: known
levels move to the training codes, the unseen one scores as NA).  A
``model_key`` (a DKV upload key whose value is the file's path, or an
``nfs://`` path) imports the same model; a saved Generic model loads
and scores as before.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from h2o_tpu.models.generic import Generic as JGeneric

from h2o_tpu_torch.core.store import dkv as p_dkv, unpublish_on_exit
from h2o_tpu_torch.models.generic import Generic, GenericModel
from h2o_tpu_torch.models.model import Model
from h2o_tpu_torch.mojo import export_genmodel_mojo, export_mojo, import_mojo
from tests.test_torch_mojo import _pair, carried, dataset


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv


@pytest.fixture(scope="module")
def files():
    with tempfile.TemporaryDirectory() as d:
        out = {}
        for name in ("gbm", "glm", "stackedensemble"):
            _, cm, _ = carried(name)
            if name != "stackedensemble":
                out[(name, "npz")] = export_mojo(
                    cm, os.path.join(d, f"{name}.zip"))
            p = os.path.join(d, f"{name}_genmodel.zip")
            with open(p, "wb") as f:
                f.write(export_genmodel_mojo(cm))
            out[(name, "genmodel")] = p
        yield d, out


def _shuffled_domain():
    """The mixed frame with ``c`` re-coded over another level order that
    also holds an unseen level ("zz")."""
    jf, pf = dataset("mixed")
    old = ["a", "b", "cc", "d", "e"]
    new = ["e", "zz", "cc", "a", "d", "b"]
    codes = pf.vec("c").data
    recoded = np.where(codes < 0, -1,
                       np.array([new.index(s) for s in old])[
                           np.maximum(codes, 0)]).astype(np.int32)
    recoded[:7] = 1                                    # unseen "zz"
    cols = {n: (pf.vec(n).data, pf.vec(n).domain) for n in pf.names}
    cols["c"] = (recoded, new)
    return _pair(cols)


CASES = [("gbm", "npz"), ("gbm", "genmodel"), ("glm", "npz"),
         ("glm", "genmodel"), ("stackedensemble", "genmodel")]


@pytest.mark.parametrize("name,fmt", CASES)
@pytest.mark.parametrize("frame", ["training", "remapped"])
def test_generic_predict_equals_reference(files, name, fmt, frame):
    path = files[1][(name, fmt)]
    jg = JGeneric(path=path).train()
    for pg in (Generic(device="cpu", path=path).train(),
               import_mojo(path, device="cpu")):
        assert isinstance(pg, GenericModel)
        assert pg.output["source_algo"] == jg.output["source_algo"]
        jf, pf = dataset("mixed") if frame == "training" else \
            _shuffled_domain()
        want = np.asarray(jg.predict_raw(jf))[: pf.nrows]
        got = pg.predict_raw(pf)
        assert got.device == torch.device("cpu")
        np.testing.assert_array_equal(got.numpy(), want)
        jp, pp = jg.predict(jf), pg.predict(pf)
        assert pp.names == jp.names
        for c in pp.names:
            np.testing.assert_array_equal(
                pp.vec(c).to_numpy(),
                np.asarray(jp.vec(c).to_numpy())[: pf.nrows])


def test_remap_sends_unseen_levels_to_na(files):
    """The unseen level scores as a row whose ``c`` is NA; the known
    levels score as their training codes."""
    path = files[1][("gbm", "npz")]
    pg = Generic(device="cpu", path=path).train()
    _, pf = dataset("mixed")
    _, rf = _shuffled_domain()
    got, base = pg.predict_raw(rf).numpy(), pg.predict_raw(pf).numpy()
    np.testing.assert_array_equal(got[7:], base[7:])
    na = pf.vec("c").data.copy()
    na[:7] = -1
    cols = {n: (pf.vec(n).data, pf.vec(n).domain) for n in pf.names}
    cols["c"] = (na, pf.vec("c").domain)
    np.testing.assert_array_equal(
        got[:7], pg.predict_raw(_pair(cols)[1]).numpy()[:7])


def test_model_key_refused_by_name(files):
    path = files[1][("gbm", "genmodel")]
    by_path = Generic(device="cpu", path=path).train()
    p_dkv().put("upload_123", path)
    try:
        for mk in ("upload_123", "nfs://" + path):
            m = Generic(device="cpu", model_key=mk).train()
            assert p_dkv().get(m.model_id) is m
            p_dkv().remove(m.model_id)
            pf = dataset("mixed")[1]
            np.testing.assert_array_equal(m.predict_raw(pf).numpy(),
                                          by_path.predict_raw(pf).numpy())
    finally:
        p_dkv().remove("upload_123")
        p_dkv().remove(by_path.model_id)
    with pytest.raises(ValueError, match="path"):
        Generic(device="cpu").train()


def test_generic_model_id_and_save_load(files, tmp_path):
    path = files[1][("gbm", "genmodel")]
    pg = Generic(device="cpu", path=path, model_id="imported").train()
    assert pg.model_id == "imported"
    back = Model.load(pg.save(str(tmp_path / "g.bin")), device="cpu")
    assert type(back) is GenericModel and back.model_id == "imported"
    _, pf = dataset("mixed")
    np.testing.assert_array_equal(back.predict_raw(pf).numpy(),
                                  pg.predict_raw(pf).numpy())
