"""The port's genmodel-spec MOJO writers and reader
(``h2o_tpu_torch.mojo.genmodel``) held against ``h2o_tpu.mojo.genmodel``
on the CPU.

The reference models of ``test_torch_mojo`` are carried into the port
under their keys; for the 16 writers (gbm, drf, xgboost, dt, glm
binomial and multinomial, kmeans, isolationforest,
extendedisolationforest, word2vec, isotonicregression, pca,
targetencoder, stackedensemble, coxph, glrm, deeplearning; plus the
multinomial GBM, the gblinear XGBoost and a regression GBM/GLM/DL) every
zip entry the port writes is byte-equal to the reference writer's, in
the same order, after masking model.ini's ``timestamp`` line.  The tree
cases hold F6: the carried forests keep their categorical ``domains``
(``n_domains``, ``domains/d000.txt``).  The port's reader parses the
reference's zips into the same dict and ``GenmodelMojoModel`` scores
them bitwise as the reference's does; each refusal (ordinal GLM, a
custom distribution, AutoML TE preprocessing, KMeans on categoricals,
PCA on categoricals, an autoencoder, an unknown algo) raises the
reference's exception with its message.
"""

import io
import re
import zipfile
from types import SimpleNamespace

import numpy as np
import pytest

from h2o_tpu.mojo import genmodel as jgm

from h2o_tpu_torch.mojo import export_genmodel_mojo
from h2o_tpu_torch.mojo import genmodel as pgm
from tests.test_torch_mojo import carried, dataset, raw_matrix

pytestmark = pytest.mark.shared_dkv

WRITERS = ["gbm", "gbm_multi", "gbm_reg", "drf", "drf_multi", "xgboost",
           "xgboost_linear", "dt", "glm", "glm_multi", "glm_reg", "kmeans",
           "isolationforest", "extendedisolationforest", "word2vec",
           "isotonicregression", "pca", "targetencoder", "stackedensemble",
           "coxph", "glrm", "deeplearning", "deeplearning_reg"]

_TS = re.compile(rb"^timestamp = \d+$", re.M)


def _entries(blob):
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        return [(n, _TS.sub(b"timestamp = #", z.read(n)))
                for n in z.namelist()]


def _blobs(name):
    jm, cm, ds = carried(name)
    return jm, cm, ds, jgm.write_genmodel_mojo(jm), export_genmodel_mojo(cm)


@pytest.mark.parametrize("name", WRITERS)
def test_writer_bytes_equal_reference(name):
    _, _, _, want, got = _blobs(name)
    w, g = _entries(want), _entries(got)
    assert [n for n, _ in g] == [n for n, _ in w]
    for (n, gb), (_, wb) in zip(g, w):
        assert gb == wb, n


@pytest.mark.parametrize("name", ["gbm", "drf", "xgboost", "dt"])
def test_carried_forests_keep_domains(name):
    """F6: the converters carry ``domains``, so the categorical levels
    reach model.ini and domains/d000.txt."""
    jm, cm, _, _, got = _blobs(name)
    assert cm.output["domains"] == {"c": ["a", "b", "cc", "d", "e"]}
    with zipfile.ZipFile(io.BytesIO(got)) as z:
        ini = z.read("model.ini").decode()
        assert "n_domains = 2" in ini
        assert z.read("domains/d000.txt").decode().split() == \
            ["a", "b", "cc", "d", "e"]


def _same(a, b, path="parsed"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("name", WRITERS)
def test_reader_equals_reference_on_reference_zip(name):
    jm, _, ds, want, _ = _blobs(name)
    _same(pgm.read_genmodel_mojo(want), jgm.read_genmodel_mojo(want))
    if name == "word2vec":
        return                        # an embedding has no score_matrix
    jg, pg = jgm.GenmodelMojoModel(want), pgm.GenmodelMojoModel(want)
    assert pg.columns == jg.columns and pg.meta == jg.meta
    X = raw_matrix(dataset(ds)[0], jg.columns)
    np.testing.assert_array_equal(np.asarray(pg.score_matrix(X)),
                                  np.asarray(jg.score_matrix(X)))


def _stub(algo, **out):
    return SimpleNamespace(algo=algo, key="stub", model_id="stub",
                           params={}, output=out)


@pytest.mark.parametrize("case", ["ordinal", "custom", "te_preprocessing",
                                  "kmeans_cat", "pca_cat", "autoencoder",
                                  "unknown"])
def test_refusals_match_reference(case):
    spec_cat = dict(cat_names=["c"], num_names=[], cat_cards=[5],
                    use_all_factor_levels=False, means=[], sigmas=[],
                    standardize=True)
    if case == "kmeans_cat":
        jm, cm, _ = carried("kmeans_cat")
        models = (jm, cm)
    else:
        stub = {"ordinal": _stub("glm", is_ordinal=True),
                "custom": _stub("gbm", custom_link="python:x"),
                "te_preprocessing": _stub("gbm", preprocessing_te_key="te"),
                "pca_cat": _stub("pca", expansion_spec=spec_cat),
                "autoencoder": _stub("deeplearning", autoencoder=True),
                "unknown": _stub("aggregator")}[case]
        models = (stub, stub)
    with pytest.raises(NotImplementedError) as want:
        jgm.write_genmodel_mojo(models[0])
    with pytest.raises(NotImplementedError) as got:
        export_genmodel_mojo(models[1])
    assert str(got.value) == str(want.value)
