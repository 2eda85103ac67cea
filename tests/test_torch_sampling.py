"""The port's stochastic GBM options held against ``h2o_tpu``'s GBM on
the CPU, tree for tree.

Each option alone and two together, on ``test_torch_gbm``'s data (a
strong, smooth signal: no split here is a near-tie):
``sample_rate``, ``col_sample_rate`` (per-level column draw),
``col_sample_rate_per_tree``, ``histogram_type="Random"`` (random
bucket offsets on every adaptive level), and int16 stats (the reference
under ``H2O_TPU_STATS_DTYPE=int16``, the port with
``stats_dtype="int16"``), the last also with QuantilesGlobal so that
sibling subtraction runs on the exact int32 tables.  The port draws the
reference's random bits exactly (``ops/prng.py``), so split columns,
thresholds, NA directions and bitsets are equal.

Tolerances as in ``test_torch_gbm``: node values rtol 1e-4 / atol
1e-6, predictions atol 1e-5, AUC 1e-4.  They hold for int16 stats too:
a quantized stat may sit one step (max|stat|/32767) off the
reference's (``test_torch_statpack``), which moves a node value by far
less than 1e-6 here.
"""

import numpy as np
import pytest
import torch

from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models.tree.gbm import GBM as JGBM

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.tree import engine
from h2o_tpu_torch.models.tree.gbm import GBM

pytestmark = pytest.mark.shared_dkv

CONFIGS = {
    "sample_rate": dict(sample_rate=0.7),
    "col_sample_rate": dict(col_sample_rate=0.6),
    "col_sample_rate_per_tree": dict(col_sample_rate_per_tree=0.7),
    "random": dict(histogram_type="Random"),
    "int16": dict(stats_dtype="int16"),
    "int16_qg_sampled": dict(stats_dtype="int16",
                             histogram_type="QuantilesGlobal",
                             sample_rate=0.8),
    "random_all": dict(histogram_type="Random", sample_rate=0.8,
                       col_sample_rate=0.8, col_sample_rate_per_tree=0.9),
}
_NAMES = ["a", "b", "c", "d", "k", "y"]
_DOM = list("vwxyz")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(n=600, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    X[rng.uniform(size=n) < 0.05, 1] = np.nan
    cat = rng.integers(0, 5, n).astype(np.int32)
    logit = (1.5 * X[:, 0] - X[:, 2] + 0.8 * (cat % 2) +
             0.5 * np.nan_to_num(X[:, 1]))
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.int32)
    jv = [JVec(X[:, j]) for j in range(4)] + [JVec(cat, J_CAT, domain=_DOM),
                                              JVec(y, J_CAT,
                                                   domain=["n", "p"])]
    pv = [Vec(X[:, j]) for j in range(4)] + [Vec(cat, T_CAT, domain=_DOM),
                                             Vec(y, T_CAT, domain=["n", "p"])]
    return JFrame(_NAMES, jv), Frame(_NAMES, pv)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request, cl):
    cfg = dict(CONFIGS[request.param])
    jf, pf = _frames()
    kw = dict(ntrees=3, max_depth=3, seed=7)
    stats_dtype = cfg.pop("stats_dtype", "f32")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("H2O_TPU_STATS_DTYPE", stats_dtype)
        jm = JGBM(**kw, **cfg).train(y="y", training_frame=jf)
    pm = GBM(device="cpu", stats_dtype=stats_dtype, **kw, **cfg).train(
        y="y", training_frame=pf)
    return stats_dtype, jf, pf, jm, pm


def test_trees_equal(pair):
    _, _, _, jm, pm = pair
    for k in ("split_col", "thr_bin", "na_left", "bitset"):
        np.testing.assert_array_equal(pm.output[k], np.asarray(jm.output[k]),
                                      err_msg=k)
    assert (pm.output["split_col"] >= 0).sum() > 9
    assert pm.output["hist_type"] == jm.output["hist_type"]


def test_values_and_predictions_close(pair):
    _, jf, pf, jm, pm = pair
    np.testing.assert_allclose(pm.output["value"],
                               np.asarray(jm.output["value"]), rtol=1e-4,
                               atol=1e-6)
    got = pm.predict_raw(pf).numpy()
    want = np.asarray(jm.predict_raw(jf))[: pf.nrows]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    jt, pt = jm.output["training_metrics"], pm.output["training_metrics"]
    assert abs(pt["AUC"] - jt["AUC"]) <= 1e-4
    assert pt["AUC"] > 0.75


def test_options_change_the_forest():
    """Each option draws something: its forest differs from the
    deterministic default's on the same seed."""
    _, pf = _frames()
    kw = dict(device="cpu", ntrees=2, max_depth=3, seed=7)
    base = GBM(**kw).train(y="y", training_frame=pf).output
    for name, cfg in CONFIGS.items():
        out = GBM(**kw, **cfg).train(y="y", training_frame=pf).output
        assert not np.array_equal(out["value"], base["value"]), name


def test_deep_gbm_takes_the_frontier_engine(monkeypatch):
    monkeypatch.setattr(engine, "MAX_LIVE_LEAVES", 8)
    _, pf = _frames()
    m = GBM(device="cpu", ntrees=2, max_depth=7, seed=7,
            sample_rate=0.8).train(y="y", training_frame=pf)
    assert m.output["child"] is not None
    assert m.output["split_col"].shape[2] == engine.pool_size(7, 8)
    assert m.output["training_metrics"]["AUC"] > 0.8
