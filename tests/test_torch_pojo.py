"""The port's POJO source (``h2o_tpu_torch.mojo.pojo``) held against
``h2o_tpu.mojo.pojo`` on the CPU: ``pojo_source`` of the carried
binomial, multinomial and regression GBM, the binomial and multinomial
DRF, the XGBoost gbtree and gblinear forms, the DT, the binomial and
gaussian GLM, KMeans and DeepLearning is the reference's string,
character for character; the multinomial GLM, an autoencoder, a Maxout
network, KMeans on categoricals and an algo without a POJO raise the
reference's exception with its message."""

from types import SimpleNamespace

import pytest

from h2o_tpu.mojo import pojo as jpojo

from h2o_tpu_torch.mojo import pojo as ppojo
from tests.test_torch_mojo import carried
from h2o_tpu_torch.core.store import unpublish_on_exit


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv


@pytest.mark.parametrize("name", ["gbm", "gbm_multi", "gbm_reg", "drf",
                                  "drf_multi", "xgboost", "xgboost_linear",
                                  "dt", "glm", "glm_reg", "kmeans",
                                  "deeplearning", "deeplearning_reg"])
def test_pojo_source_equals_reference(name):
    jm, cm, _ = carried(name)
    want = jpojo.pojo_source(jm)
    assert "public class" in want
    assert ppojo.pojo_source(cm) == want


def _stub(algo, **out):
    return SimpleNamespace(algo=algo, key="stub", model_id="stub",
                           params={}, output=out)


@pytest.mark.parametrize("case", ["glm_multi", "kmeans_cat", "autoencoder",
                                  "maxout", "unknown"])
def test_pojo_refusals_match_reference(case):
    if case in ("glm_multi", "kmeans_cat"):
        jm, cm, _ = carried(case)
    else:
        jm = cm = {"autoencoder": _stub("deeplearning", autoencoder=True),
                   "maxout": _stub("deeplearning", activation="Maxout"),
                   "unknown": _stub("pca")}[case]
    with pytest.raises(NotImplementedError) as want:
        jpojo.pojo_source(jm)
    with pytest.raises(NotImplementedError) as got:
        ppojo.pojo_source(cm)
    assert str(got.value) == str(want.value)
