"""GBM under the other distributions: the port held against ``h2o_tpu``
on the CPU, tree for tree.

One parametrised case per family: poisson (counts), gamma (positive
values), tweedie with power 1.3 (non-negative values with zeros),
laplace, quantile with alpha 0.25 and huber with huber_alpha 0.8 (the
reference reads it as huber's delta), each on a response made for it
from ``test_torch_gbm``'s columns (NaNs in a numeric column, one
categorical column) with a strong, smooth signal.  Laplace, quantile
and huber take the mean residual as a leaf value, the log-link families
Newton steps.

Tolerances: split columns, thresholds, NA directions and bitsets equal;
node values rtol 1e-4 / atol 1e-6; f0 rtol 1e-6; predictions rtol 1e-5
(on the response scale: exp of the forest sum for the log links) / atol
1e-5; training MSE, MAE and mean residual deviance (the family's own)
rtol 1e-4.
"""

import numpy as np
import pytest
import torch

from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models.tree.gbm import GBM as JGBM

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.distributions import get_distribution
from h2o_tpu_torch.models.tree.gbm import GBM
from h2o_tpu_torch.core.store import unpublish_on_exit


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv

FAMILIES = {
    "poisson": {}, "gamma": {}, "tweedie": dict(tweedie_power=1.3),
    "laplace": {}, "quantile": dict(quantile_alpha=0.25),
    "huber": dict(huber_alpha=0.8),
}
_NAMES = ["a", "b", "c", "d", "k", "y"]
_DOM = list("vwxyz")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _response(family: str, eta: np.ndarray, rng) -> np.ndarray:
    """A response for ``family`` around the linear predictor ``eta``."""
    mu = np.exp(0.5 * eta)
    if family == "poisson":
        return rng.poisson(mu).astype(np.float32)
    if family == "gamma":
        return rng.gamma(2.0, mu / 2.0).astype(np.float32)
    if family == "tweedie":
        y = rng.gamma(1.5, mu / 1.5)
        y[rng.uniform(size=y.shape) < 0.3] = 0.0
        return y.astype(np.float32)
    return (eta + 0.5 * rng.standard_t(3, size=eta.shape)).astype(
        np.float32)


def _frames(family: str, n=600, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    X[rng.uniform(size=n) < 0.05, 1] = np.nan
    cat = rng.integers(0, 5, n).astype(np.int32)
    eta = (1.5 * X[:, 0] - X[:, 2] + 0.8 * (cat % 2) +
           0.5 * np.nan_to_num(X[:, 1]))
    y = _response(family, eta, rng)
    jv = [JVec(X[:, j]) for j in range(4)] + [JVec(cat, J_CAT, domain=_DOM),
                                              JVec(y)]
    pv = [Vec(X[:, j]) for j in range(4)] + [Vec(cat, T_CAT, domain=_DOM),
                                             Vec(y)]
    return JFrame(_NAMES, jv), Frame(_NAMES, pv)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_gbm_distribution_matches_reference(cl, family):
    jf, pf = _frames(family)
    kw = dict(ntrees=3, max_depth=3, seed=1, distribution=family,
              **FAMILIES[family])
    jm = JGBM(**kw).train(y="y", training_frame=jf)
    pm = GBM(device="cpu", **kw).train(y="y", training_frame=pf)
    assert pm.output["distribution_resolved"] == family
    for k in ("split_col", "thr_bin", "na_left", "bitset"):
        np.testing.assert_array_equal(pm.output[k], np.asarray(jm.output[k]),
                                      err_msg=k)
    assert (pm.output["split_col"] >= 0).sum() > 9
    np.testing.assert_allclose(pm.output["value"],
                               np.asarray(jm.output["value"]), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(pm.output["f0"], np.asarray(jm.output["f0"]),
                               rtol=1e-6)
    got = pm.predict_raw(pf).numpy()
    want = np.asarray(jm.predict_raw(jf))[: pf.nrows]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    jt, pt = jm.output["training_metrics"], pm.output["training_metrics"]
    for k in ("mse", "mae", "mean_residual_deviance"):
        np.testing.assert_allclose(pt[k], jt[k], rtol=1e-4, err_msg=k)
    # the trees learn: the forest beats its constant start
    f0 = get_distribution(family, **FAMILIES[family]).link_inv(
        torch.tensor(pm.output["f0"][0])).item()
    y = pf.vec("y").data
    assert pt["mse"] < float(np.mean((y - f0) ** 2))


def test_custom_distribution_names_its_slice():
    # the family needs the user's function (core/udf.py), which only
    # distribution_from_params reads from a builder's params
    with pytest.raises(ValueError, match="custom_distribution_func"):
        get_distribution("custom")
    with pytest.raises(ValueError, match="tweedie_power"):
        get_distribution("tweedie", tweedie_power=2.5)
