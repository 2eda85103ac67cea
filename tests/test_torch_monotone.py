"""Monotone constraints: the port held against ``h2o_tpu`` on the CPU,
tree for tree, on both tree engines, and ``_mono_array``'s errors.

A regression response increasing in ``a`` and decreasing in ``c``, each
with a wiggle strong enough that an unconstrained forest follows it,
plus NaNs in ``b`` and a categorical column.  ``monotone_constraints
{"a": 1, "c": -1}`` on the dense heap (max_depth 4) and on the sparse
frontier (max_depth 7 with the frontier capped at 8 live leaves in both
packages: the reference's ``H2O_TPU_MAX_LIVE_LEAVES`` and the port's
``engine.MAX_LIVE_LEAVES``), where the bounds travel with the selected
children; and a bernoulli GBM with the JSON-string form of the
constraints (Newton values in the rejection test).  Every forest's
predictions are monotone along a grid of each constrained column with
the other columns held at the data's rows.

Tolerances: split columns, thresholds, NA directions and bitsets equal;
node values rtol 1e-4 / atol 1e-6; predictions atol 1e-5.
"""

import numpy as np
import pytest
import torch

from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models.tree.gbm import GBM as JGBM

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models.tree import engine
from h2o_tpu_torch.models.tree.gbm import GBM
from h2o_tpu_torch.core.store import unpublish_on_exit


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv

CAP = 8
CONFIGS = {
    "dense": dict(max_depth=4),
    "frontier": dict(max_depth=7),
    "bernoulli_json": dict(max_depth=4, binomial=True,
                           monotone_constraints='{"a": 1, "c": -1}'),
}
_NAMES = ["a", "b", "c", "d", "k", "y"]
_DOM = list("vwxyz")
MONO = {"a": 1, "c": -1}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(binomial=False, n=800, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, size=(n, 4)).astype(np.float32)
    X[rng.uniform(size=n) < 0.05, 1] = np.nan
    cat = rng.integers(0, 5, n).astype(np.int32)
    eta = (0.8 * X[:, 0] + 0.4 * np.sin(4 * X[:, 0]) - 0.7 * X[:, 2]
           + 0.3 * np.cos(5 * X[:, 2]) + 0.5 * (cat % 2)
           + 0.4 * np.nan_to_num(X[:, 1]))
    if binomial:
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-2 * eta))).astype(
            np.int32)
        jy, py = JVec(y, J_CAT, domain=["n", "p"]), Vec(y, T_CAT,
                                                        domain=["n", "p"])
    else:
        y = (eta + 0.2 * rng.normal(size=n)).astype(np.float32)
        jy, py = JVec(y), Vec(y)
    jv = [JVec(X[:, j]) for j in range(4)] + [JVec(cat, J_CAT, domain=_DOM),
                                              jy]
    pv = [Vec(X[:, j]) for j in range(4)] + [Vec(cat, T_CAT, domain=_DOM),
                                             py]
    return JFrame(_NAMES, jv), Frame(_NAMES, pv)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request, cl):
    cfg = dict(CONFIGS[request.param])
    binomial = cfg.pop("binomial", False)
    jf, pf = _frames(binomial)
    kw = dict(dict(ntrees=4, seed=2, learn_rate=0.3, min_rows=5.0,
                   monotone_constraints=dict(MONO)), **cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("H2O_TPU_MAX_LIVE_LEAVES", str(CAP))
        mp.setattr(engine, "MAX_LIVE_LEAVES", CAP)
        jm = JGBM(**kw).train(y="y", training_frame=jf)
        pm = GBM(device="cpu", **kw).train(y="y", training_frame=pf)
    return request.param, jf, pf, jm, pm


def _grid_monotone(model, fr: Frame, col: str, sign: int,
                   n_grid: int = 24) -> None:
    """Every row's prediction is monotone in ``col`` (the others held)."""
    rows = min(fr.nrows, 200)
    base = fr.slice_rows(slice(0, rows))
    preds = []
    for v in np.linspace(-2, 2, n_grid, dtype=np.float32):
        vecs = [Vec(np.full(rows, v, np.float32)) if n == col
                else base.vec(n) for n in base.names]
        raw = model.predict_raw(Frame(base.names, vecs))
        preds.append((raw[:, 2] if raw.dim() == 2 else raw).numpy())
    d = sign * np.diff(np.stack(preds), axis=0)
    assert d.min() >= -1e-6, (col, float(d.min()))
    assert float(np.abs(np.stack(preds)[-1] - preds[0]).max()) > 1e-3


def test_trees_equal(pair):
    name, _, _, jm, pm = pair
    if name == "frontier":
        assert pm.output["child"] is not None
    for k in ("split_col", "thr_bin", "na_left", "bitset"):
        np.testing.assert_array_equal(pm.output[k], np.asarray(jm.output[k]),
                                      err_msg=k)
    assert (pm.output["split_col"] >= 0).sum() > 12
    np.testing.assert_allclose(pm.output["value"],
                               np.asarray(jm.output["value"]), rtol=1e-4,
                               atol=1e-6)


def test_predictions_close_and_monotone(pair):
    _, jf, pf, jm, pm = pair
    got = pm.predict_raw(pf).numpy()
    want = np.asarray(jm.predict_raw(jf))[: pf.nrows]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for col, sign in MONO.items():
        _grid_monotone(pm, pf, col, sign)


def test_constraints_bind():
    """Unconstrained, the same forest is not monotone in ``a``."""
    _, pf = _frames()
    m = GBM(device="cpu", ntrees=4, max_depth=4, seed=2, learn_rate=0.3,
            min_rows=5.0).train(y="y", training_frame=pf)
    with pytest.raises(AssertionError):
        _grid_monotone(m, pf, "a", 1)


def test_mono_array_errors():
    _, pf = _frames()
    for mc, msg in (({"nope": 1}, "not a predictor"),
                    ({"a": 5}, "must be -1, 0 or 1"),
                    ({"k": 1}, "categorical"),
                    ("{a: 1", "bad monotone_constraints")):
        with pytest.raises(ValueError, match=msg):
            GBM(device="cpu", ntrees=1, monotone_constraints=mc).train(
                y="y", training_frame=pf)
    # all-zero constraints are no constraints
    a = GBM(device="cpu", ntrees=1, seed=1,
            monotone_constraints={"a": 0}).train(y="y", training_frame=pf)
    b = GBM(device="cpu", ntrees=1, seed=1).train(y="y", training_frame=pf)
    np.testing.assert_array_equal(a.output["value"], b.output["value"])
