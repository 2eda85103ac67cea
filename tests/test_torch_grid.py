"""Grid search and the builder registry in the port, held against
``h2o_tpu``'s on the CPU, at ``tests/test_grid.py``'s cases (1,500 x 4
binomial rows from ``default_rng(42)``):

- the registry: the reference's algos in its order, each resolved to the
  port's builder; an unknown algo raises naming the known ones, and an
  algo whose module failed to import raises that import error;
- a Cartesian GBM grid and a RandomDiscrete one (``max_models=3``,
  ``seed=7``) walk the same combos in the same order as the reference's;
  each model's trees have the reference's split columns, bins, NA
  directions and bitsets, and values within rtol 1e-4 / atol 1e-6
  (``tests/test_torch_cv.py``'s tolerance); ``summary()`` has the
  reference's sort metric, rows in its order, metrics within 1e-5;
- search-level early stopping (``stopping_rounds``) and
  ``max_runtime_secs`` stop after as many models as the reference's;
- a ``max_depth=-5`` combo is collected as a failure with its stack
  trace, and the other combo trains;
- a GLM grid's coefficients within 1e-5 of the reference's; export and
  import give the same models back, published under their keys;
- ``parallelism=2`` gives the same set of forests, bitwise, as the
  sequential walk; ``recovery_dir`` snapshots the search and its
  finished models and drops the snapshot when the walk ends
  (``tests/test_torch_recovery.py`` kills and resumes one).

Every grid and model a test publishes is removed from the port's DKV
after it.
"""

import importlib
import sys

import numpy as np
import pytest
import torch

from h2o_tpu.core.frame import Frame as JFrame, T_CAT as J_CAT, Vec as JVec
from h2o_tpu.models import registry as j_registry
from h2o_tpu.models.grid import GridSearch as JGridSearch

from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.core.store import dkv as p_dkv, unpublish_on_exit
from h2o_tpu_torch.models import registry
from h2o_tpu_torch.models.grid import (GridSearch, export_grid, get_grid,
                                       import_grid)


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv

_TREE_KEYS = ("split_col", "thr_bin", "na_left", "bitset")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(n=1500, c=4):
    """``tests/test_grid.py``'s frame in both packages."""
    rng = np.random.default_rng(42)
    X = rng.normal(size=(n, c)).astype(np.float32)
    y = (rng.uniform(size=n) <
         1 / (1 + np.exp(-(1.5 * X[:, 0] - X[:, 1])))).astype(np.int32)
    names = [f"x{j}" for j in range(c)] + ["y"]
    return (JFrame(names, [JVec(X[:, j]) for j in range(c)] +
                   [JVec(y, J_CAT, domain=["n", "p"])]),
            Frame(names, [Vec(X[:, j]) for j in range(c)] +
                  [Vec(y, T_CAT, domain=["n", "p"])]))


#: case -> (algo, hyper params, search criteria, base params)
CASES = {
    "cartesian": ("gbm", {"max_depth": [2, 3], "learn_rate": [0.1, 0.3]},
                  None, dict(ntrees=5, seed=42)),
    "random": ("gbm", {"max_depth": [1, 2, 3, 4],
                       "learn_rate": [0.05, 0.1, 0.2, 0.3]},
               {"strategy": "RandomDiscrete", "max_models": 3, "seed": 7},
               dict(ntrees=3, seed=42)),
    "early_stop": ("gbm", {"max_depth": [1, 2, 3, 4],
                           "learn_rate": [0.05, 0.1, 0.2, 0.3]},
                   {"strategy": "RandomDiscrete", "seed": 3,
                    "stopping_rounds": 1, "stopping_tolerance": 0.5},
                   dict(ntrees=3, seed=42)),
    "failure": ("gbm", {"max_depth": [2, -5]}, None, dict(ntrees=3, seed=1)),
    "glm": ("glm", {"alpha": [0.0, 0.5]}, None, dict(family="binomial")),
}


def _np(out):
    return {k: (np.asarray(v) if hasattr(v, "shape") else v)
            for k, v in out.items()}


@pytest.fixture(scope="module")
def grids(cl):
    """Each case's grid in both packages, trained once; the reference's
    models' outputs as numpy.  The port's grids and models stay
    published for the module and are removed after it."""
    jf, pf = _frames()
    out = {}
    with unpublish_on_exit():
        for case, (algo, hyper, crit, base) in CASES.items():
            jg = JGridSearch(algo, hyper, search_criteria=crit,
                             **base).train(y="y", training_frame=jf)
            pg = GridSearch(algo, hyper, search_criteria=crit,
                            device="cpu", **base).train(
                y="y", training_frame=pf)
            out[case] = (jg, pg, [_np(m.output) for m in jg.models])
        yield jf, pf, out


def _assert_forest(po, jo, where):
    for k in _TREE_KEYS:
        np.testing.assert_array_equal(po[k], jo[k], err_msg=f"{where} {k}")
    np.testing.assert_allclose(po["value"], jo["value"], rtol=1e-4,
                               atol=1e-6, err_msg=where)


def test_registry_is_the_references():
    assert [a for a, _, _ in registry._ALGOS] == \
        [a for a, _, _ in j_registry._ALGOS]
    reg = registry.builders()
    assert list(reg) == [a for a, _, _ in registry._ALGOS]
    for algo, cls in reg.items():
        assert cls.algo == algo
        assert cls.__module__.startswith("h2o_tpu_torch.")
        assert registry.builder_class(algo.upper()) is cls
        assert registry.model_class(algo) is cls.model_cls
    with pytest.raises(KeyError, match="unknown algo 'nope'.*'gbm'"):
        registry.builder_class("nope")


def test_registry_raises_an_import_failure(monkeypatch):
    real = importlib.import_module

    def failing(name, *a):
        if name == "h2o_tpu_torch.models.glrm":
            raise ImportError("glrm is broken")
        return real(name, *a)

    monkeypatch.setattr(registry, "_cache", {})
    monkeypatch.setattr(registry, "_failed", {})
    monkeypatch.setattr(registry.importlib, "import_module", failing)
    assert "glrm" not in registry.builders() and "gbm" in registry.builders()
    with pytest.raises(ImportError, match="glrm.*glrm is broken"):
        registry.builder_class("glrm")


@pytest.mark.parametrize("case", ["cartesian", "random", "early_stop"])
def test_gbm_grid_walks_and_trains_as_reference(grids, case):
    _, _, out = grids
    jg, pg, jouts = out[case]
    assert pg.hyper_values == jg.hyper_values
    assert len(pg.models) == len(jg.models) > 0
    if case == "random":
        assert len(pg.models) == 3
    if case == "early_stop":
        assert len(pg.models) == 2
    for i, (pm, jo) in enumerate(zip(pg.models, jouts)):
        _assert_forest(pm.output, jo, f"{case} model {i}")
        assert p_dkv().get(pm.model_id) is pm
    assert pg.failures == [] and pg.sort_metric == jg.sort_metric


def test_random_discrete_is_numpys_shuffle(grids):
    _, _, out = grids
    _, pg, _ = out["random"]
    hyper = CASES["random"][1]
    combos = [dict(max_depth=d, learn_rate=r) for d in hyper["max_depth"]
              for r in hyper["learn_rate"]]
    np.random.default_rng(7).shuffle(combos)
    assert pg.hyper_values == combos[:3]


@pytest.mark.parametrize("case", ["cartesian", "random", "glm"])
def test_summary_as_reference(grids, case):
    _, _, out = grids
    jg, pg, _ = out[case]
    js, ps = jg.summary(), pg.summary()
    assert ps["sort_metric"] == js["sort_metric"] == "logloss"
    assert ps["hyper_names"] == js["hyper_names"]
    assert ps["failure_count"] == js["failure_count"] == 0
    names = ps["hyper_names"]
    assert [[r[n] for n in names] for r in ps["summary_rows"]] == \
        [[r[n] for n in names] for r in js["summary_rows"]]
    got = [r["logloss"] for r in ps["summary_rows"]]
    np.testing.assert_allclose(
        got, [r["logloss"] for r in js["summary_rows"]], rtol=0, atol=1e-5)
    assert got == sorted(got)
    d = pg.to_dict()
    assert [m["name"] for m in d["model_ids"]] == pg.model_ids


def test_failure_collected(grids):
    _, _, out = grids
    jg, pg, jouts = out["failure"]
    assert len(pg.models) == len(jg.models) == 1
    assert pg.hyper_values == jg.hyper_values == [{"max_depth": 2}]
    assert [f["params"] for f in pg.failures] == \
        [f["params"] for f in jg.failures] == [{"max_depth": -5}]
    assert "Traceback" in pg.failures[0]["stacktrace"]
    assert pg.to_dict()["failure_details"] == [pg.failures[0]["error"]]
    _assert_forest(pg.models[0].output, jouts[0], "failure model")


def test_max_runtime_stops_as_reference(cl):
    jf, pf = _frames(n=300)
    crit = {"max_runtime_secs": 1e-9}
    jg = JGridSearch("gbm", {"max_depth": [2, 3]}, search_criteria=crit,
                     ntrees=2).train(y="y", training_frame=jf)
    pg = GridSearch("gbm", {"max_depth": [2, 3]}, search_criteria=crit,
                    ntrees=2, device="cpu").train(y="y", training_frame=pf)
    assert len(pg.models) == len(jg.models) == 0


def test_glm_grid_export_import(grids, tmp_path):
    _, pf, out = grids
    jg, pg, jouts = out["glm"]
    assert pg.hyper_values == jg.hyper_values
    for pm, jm in zip(pg.models, jg.models):
        pc, jc = pm.coef(), jm.coef()
        assert list(pc) == list(jc)
        for k, v in jc.items():
            assert abs(pc[k] - v) <= 1e-5 * max(1.0, abs(v)), k
    assert get_grid(str(pg.key)) is pg
    export_grid(pg, str(tmp_path))
    before = [pm.predict_raw(pf).numpy() for pm in pg.models]
    for k in [pg.key] + pg.model_ids:
        p_dkv().remove(k)
    g2 = import_grid(str(tmp_path), str(pg.key), device="cpu")
    assert get_grid(str(pg.key)) is g2
    assert g2.model_ids == pg.model_ids
    assert g2.hyper_values == pg.hyper_values
    for m, want in zip(g2.models, before):
        assert p_dkv().get(m.model_id) is m
        np.testing.assert_array_equal(m.predict_raw(pf).numpy(), want)


def test_parallel_grid_gives_the_same_forests(grids):
    _, pf, out = grids
    _, pg, _ = out["cartesian"]
    algo, hyper, crit, base = CASES["cartesian"]
    gs = GridSearch(algo, hyper, search_criteria=crit, parallelism=2,
                    device="cpu", **base)
    assert gs.parallelism == 2
    par = gs.train(y="y", training_frame=pf)
    assert sorted(map(str, par.hyper_values)) == \
        sorted(map(str, pg.hyper_values))
    for hv, m in zip(par.hyper_values, par.models):
        seq = pg.models[pg.hyper_values.index(hv)]
        for k in _TREE_KEYS + ("value",):
            a, b = np.asarray(m.output[k]), np.asarray(seq.output[k])
            assert a.shape == b.shape and \
                np.array_equal(a.view(np.uint8), b.view(np.uint8)), (hv, k)


def test_grid_published_before_its_models_and_refusals(cl, tmp_path,
                                                       monkeypatch):
    _, pf = _frames(n=300)
    gs = GridSearch("gbm", {"max_depth": [2]}, grid_id="early_grid",
                    ntrees=2, device="cpu")
    job = gs.train_async(y="y", training_frame=pf)
    assert p_dkv().get("early_grid") is not None
    g = job.join()
    assert job.dest == "early_grid" and p_dkv().get("early_grid") is g
    assert len(g.models) == 1
    from h2o_tpu_torch.core import recovery
    calls = []
    for name in ("begin", "model_done", "done"):
        orig = getattr(recovery.Recovery, name)
        monkeypatch.setattr(recovery.Recovery, name,
                            lambda self, *a, _o=orig, _n=name, **k:
                            (calls.append(_n), _o(self, *a, **k))[1])
    d = str(tmp_path / "rec")
    g = GridSearch("gbm", {"max_depth": [2, 3]}, recovery_dir=d,
                   grid_id="rec_grid", ntrees=2, device="cpu").train(
        y="y", training_frame=pf)
    assert len(g.models) == 2
    assert calls == ["begin", "model_done", "model_done", "done"]
    assert recovery.pending_recoveries(d) == []
    with pytest.raises(KeyError, match="unknown algo"):
        GridSearch("nope", {"x": [1]})


def test_parallel_grid_stress_keeps_models_with_their_combos(cl):
    """More workers than cores, a short switch interval: every combo
    trains once and each model sits beside its own hyper values."""
    _, pf = _frames(n=300)
    rates = [round(0.01 * k, 2) for k in range(1, 33)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        g = GridSearch("gbm", {"learn_rate": rates}, parallelism=16,
                       ntrees=1, max_depth=1, seed=1,
                       device="cpu").train_async(
            y="y", training_frame=pf).join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert len(g.models) == len(g.hyper_values) == len(rates)
    # appended as they finish, as the reference's are
    assert sorted(hv["learn_rate"] for hv in g.hyper_values) == rates
    for hv, m in zip(g.hyper_values, g.models):
        assert m.params["learn_rate"] == hv["learn_rate"]
        assert p_dkv().get(m.model_id) is m
