"""Every builder of the port takes the reference builder's full default
param set, as a client that sends all params does.

For each of GBM, DRF, XGBoost, DT, IsolationForest,
ExtendedIsolationForest and UpliftDRF the port's builder is constructed
with ``h2o_tpu``'s ``default_params()`` passed explicitly (nothing may be
"unknown", no accepted default may be refused, and every param resolves
to the value the reference builder resolves it to), and trains a small
frame with them (ntrees cut to 2).  ``custom_distribution_func`` other
than None raises NotImplementedError naming P13, as
``distribution="custom"`` does; ``calibrate_model=True`` is refused by
name.
"""

import numpy as np
import pytest

from h2o_tpu.models.tree.drf import DRF as JDRF
from h2o_tpu.models.tree.dt import DT as JDT
from h2o_tpu.models.tree.gbm import GBM as JGBM
from h2o_tpu.models.tree.isofor import (ExtendedIsolationForest as JEIF,
                                        IsolationForest as JIF)
from h2o_tpu.models.tree.uplift import UpliftDRF as JUplift
from h2o_tpu.models.tree.xgboost import XGBoost as JXGB

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.tree.drf import DRF
from h2o_tpu_torch.models.tree.dt import DT
from h2o_tpu_torch.models.tree.gbm import GBM
from h2o_tpu_torch.models.tree.isofor import (ExtendedIsolationForest,
                                              IsolationForest)
from h2o_tpu_torch.models.tree.uplift import UpliftDRF
from h2o_tpu_torch.models.tree.xgboost import XGBoost

PAIRS = {"gbm": (JGBM, GBM), "drf": (JDRF, DRF), "xgboost": (JXGB, XGBoost),
         "dt": (JDT, DT), "isolationforest": (JIF, IsolationForest),
         "extendedisolationforest": (JEIF, ExtendedIsolationForest),
         "upliftdrf": (JUplift, UpliftDRF)}


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
    want = jcls(**ref).params
    assert set(want) <= set(b.params)
    for k, v in want.items():
        assert b.params[k] == v, k


@pytest.mark.parametrize("algo", sorted(PAIRS))
def test_reference_defaults_train(algo):
    jcls, pcls = PAIRS[algo]
    params = dict(jcls().default_params(), ntrees=2)
    fr = _frame()
    b = pcls(device="cpu", **params)
    if b.supervised:
        m = b.train(x=["a", "b", "c"], y="y", training_frame=fr)
    else:
        m = b.train(x=["a", "b", "c"], training_frame=fr)
    assert m.output["ntrees_actual"] == (1 if algo == "dt" else 2)
    assert m.output["training_metrics"] is not None


@pytest.mark.parametrize("algo", ["gbm", "xgboost"])
def test_custom_distribution_func_names_p13(algo):
    _, pcls = PAIRS[algo]
    with pytest.raises(NotImplementedError, match="P13"):
        pcls(device="cpu", ntrees=1,
             custom_distribution_func="python:dist=my.Dist").train(
            y="y", training_frame=_frame())
    with pytest.raises(ValueError, match="calibrate_model"):
        pcls(device="cpu", calibrate_model=True)
    # a single device builds every tree on one node already
    assert pcls(device="cpu", build_tree_one_node=True).params[
        "build_tree_one_node"] is True
