"""The port's DT held against ``h2o_tpu``'s DT on the CPU, tree for
tree, on ``tests/test_tree_variants.py``'s data (1,200 rows of 4 normal
columns, ``y = (x0 > 0.3) xor (x1 < -0.2)``).

A DT is a DRF with one unsampled tree over every column (AUTO =
UniformAdaptive histograms, the dense heap).  Its stats (w, w*y, w*y^2,
w) are 0/1 counts, so every table sums exactly in either package: the
split columns, thresholds, NA directions and bitsets are equal, node
values agree to atol 1e-6 and predictions to atol 1e-6, at the
reference test's max_depth 6 (the default depth 10 runs on the card in
``chip_smoke.py``).  ``dt_from_jax_output`` carries a JAX DT
across and scores like it; ``Model.save``/``load`` round-trips a DT.
"""

import numpy as np
import pytest
import torch

from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models.tree.dt import DT as JDT

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.model import Model
from h2o_tpu_torch.models.tree.convert import dt_from_jax_output
from h2o_tpu_torch.models.tree.dt import DT, DTModel

pytestmark = pytest.mark.shared_dkv


def _frames(n=1200, seed=42):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    y = ((X[:, 0] > 0.3) ^ (X[:, 1] < -0.2)).astype(np.int32)
    names = ["x0", "x1", "x2", "x3", "y"]
    jf = JFrame(names, [JVec(X[:, j]) for j in range(4)] +
                [JVec(y, J_CAT, domain=["0", "1"])])
    pf = Frame(names, [Vec(X[:, j]) for j in range(4)] +
               [Vec(y, T_CAT, domain=["0", "1"])])
    return jf, pf, y


@pytest.fixture(scope="module")
def pair(cl):
    jf, pf, y = _frames()
    kw = dict(max_depth=6, seed=3)
    jm = JDT(**kw).train(y="y", training_frame=jf)
    pm = DT(device="cpu", **kw).train(y="y", training_frame=pf)
    return jf, pf, y, jm, pm


def test_same_tree(pair):
    _, _, _, jm, pm = pair
    assert pm.output["ntrees_actual"] == jm.output["ntrees_actual"] == 1
    assert pm.output["child"] is None            # the dense heap
    for k in ("split_col", "thr_bin", "na_left", "bitset"):
        np.testing.assert_array_equal(pm.output[k], np.asarray(jm.output[k]),
                                      err_msg=k)
    np.testing.assert_allclose(pm.output["value"],
                               np.asarray(jm.output["value"]), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(pm.output["node_w"],
                                  np.asarray(jm.output["node_w"]))
    assert pm.params["mtries"] == 4 and pm.params["sample_rate"] == 1.0


def test_predictions_and_metrics(pair):
    jf, pf, y, jm, pm = pair
    got = pm.predict_raw(pf).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.predict_raw(jf))[:len(y)],
                               rtol=0, atol=1e-6)
    assert (got[:, 0] == y).mean() > 0.9
    pt, jt = pm.output["training_metrics"], jm.output["training_metrics"]
    assert pt["AUC"] > 0.9 and abs(pt["AUC"] - jt["AUC"]) <= 1e-6


def test_converter_and_save_load(pair, tmp_path):
    jf, pf, y, jm, pm = pair
    out = {k: (np.asarray(v) if hasattr(v, "shape") else v)
           for k, v in jm.output.items()}
    cm = dt_from_jax_output(out, jm.params, device="cpu")
    assert isinstance(cm, DTModel)
    np.testing.assert_allclose(cm.predict_raw(pf).numpy(),
                               np.asarray(jm.predict_raw(jf))[:len(y)],
                               rtol=0, atol=1e-6)
    loaded = Model.load(pm.save(str(tmp_path / "dt.bin")), device="cpu")
    assert isinstance(loaded, DTModel)
    assert torch.equal(loaded.predict_raw(pf), pm.predict_raw(pf))
