"""The Rapids planner of ``h2o_tpu_torch`` (``rapids/plan.py``,
``core/fuse.py``, ``core/oom.py``'s region rung) against its eager chain
and against ``h2o_tpu``'s planner.

The frames are the reference's torture frame (``tests/test_rapids_plan.py``:
NaNs in the filter and sort column, repeated keys, categorical NA codes)
at seeds 7 and 11, published under one key in both DKVs; the expressions
are its four region shapes.  Held:

- every region fused (``H2O_TPU_RAPIDS_FUSE=1``) is the port's eager
  chain (``=0``) bit for bit, the sign of zero included, and fused once;
- the port's fused frame equals the reference's fused frame as
  ``tests/test_torch_rapids_munge.py`` compares munge answers: names,
  types, domains, row order and codes bitwise, zeros without their sign
  (the reference's collectives return -0.0 as 0.0), the group-by on a
  frame whose aggregated values lie on a 1/8 grid;
- ``PlanStats`` deltas equal the reference's under ``=1``, ``=0`` and
  unset, and for every decline;
- the region OOM drill degrades to the eager chain bit for bit, counts
  once and fuses again; a fused region moves one upload and one
  download; the fused predicate tables are the interpreter's callables;
  the planner's modules import neither JAX nor ``h2o_tpu``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from h2o_tpu_torch import config as p_config
from h2o_tpu_torch.core import chaos as p_chaos
from h2o_tpu_torch.core import fuse as p_fuse
from h2o_tpu_torch.core import oom as p_oom
from h2o_tpu_torch.core.diag import TransferStats
from h2o_tpu_torch.core.frame import T_CAT, T_NUM, T_STR
from h2o_tpu_torch.core.store import unpublish_on_exit
from h2o_tpu_torch.rapids import interp as ti
from h2o_tpu_torch.rapids import plan as p_plan
from tests.test_torch_rapids_interp import pair, publish, same, unpublish_ref

ROOT = Path(__file__).resolve().parent.parent

K = "rp_f"
SHAPES = (
    ("filter_sort", f"(sort (rows {K} (> (cols {K} [1]) 2)) [0] [1])"),
    ("naomit_filter_sort",
     f"(sort (na.omit (rows {K} (> (cols {K} [1]) 0))) [2 0] [0 1])"),
    ("filter_only", f"(na.omit (rows {K} (> (cols {K} [1]) 1)))"),
    ("filter_gb",
     f"(GB (rows {K} (<= (cols {K} [1]) 3)) [2] mean 0 'all' "
     "nrow 0 'all' sum 1 'all' sd 0 'all' min 0 'all' max 0 'all')"),
)
_NK = f"(na.omit {K})"
_NKP = f"(rows {_NK} (> (cols {_NK} [1]) 0))"
#: more regions: a group-by under na.omit, three stages, keys by name,
#: arithmetic, ``exp``/``log``, the literals and ``!`` in predicates
MORE = (
    ("naomit_gb", f"(GB {_NK} [2] mean 0 'all' max 1 'all' count 0 'all')"),
    ("three_stages", f"(rows {_NKP} (!= (cols {_NKP} [0]) NA))"),
    ("sort_by_name", f"(sort (rows {K} (& (>= (cols {K} 'y') 1) "
     f"(! (is.na (cols {K} 'x'))))) ['c' 'y'] [1 0])"),
    ("arithmetic", f"(sort (rows {K} (> (abs (- (cols {K} [0]) "
     f"(/ (cols {K} [1]) 4))) (* 0.5 1))) [0] [0])"),
    ("exp_log", f"(na.omit (rows {_NK} (| (< (log (exp (cols {_NK} [0]))) "
     f"0.5) (== (floor (ceiling (sqrt (cols {_NK} [1])))) TRUE))))"),
)
KINDS = {"filter_sort": "filter_sort", "naomit_filter_sort": "filter_sort",
         "filter_only": "filter_only", "filter_gb": "filter_gb",
         "naomit_gb": "filter_gb", "three_stages": "filter_only",
         "sort_by_name": "filter_sort", "arithmetic": "filter_sort",
         "exp_log": "filter_only"}
SEEDS = (7, 11)
FUSE_ENV = ("H2O_TPU_RAPIDS_FUSE", "H2O_TPU_AUTOTUNE",
            "H2O_TPU_RAPIDS_FUSE_MAX_VERBS", "H2O_TPU_DEVICE_MUNGE",
            "H2O_TPU_SHARD_MUNGE", "H2O_TPU_CHAOS_REGION_OOM_TRANSIENT")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Each test starts with the planner's variables unset and both
    packages' chaos and OOM counters zero; what it publishes in the
    port's DKV is removed after it."""
    from h2o_tpu.core import chaos as j_chaos
    from h2o_tpu.core import oom as j_oom
    for k in FUSE_ENV:
        monkeypatch.delenv(k, raising=False)
    for mod in (p_chaos, j_chaos):
        mod.reset()
    for mod in (p_oom, j_oom):
        mod.reset_stats()
    with unpublish_on_exit():
        yield
    for mod in (p_chaos, j_chaos):
        mod.reset()
    for mod in (p_oom, j_oom):
        mod.reset_stats()


def torture(seed, grid=False, zeros=False):
    """The reference's torture frame (``tests/test_rapids_plan.py``
    ``_torture``) as column specs; ``grid`` puts x on a 1/8 grid (sums
    exact in any order), ``zeros`` makes a tenth of x signed zeros."""
    rng = np.random.default_rng(seed)
    n = 203
    x = rng.standard_normal(n).astype(np.float32)
    x[rng.random(n) < 0.15] = np.nan
    y = rng.integers(0, 5, n).astype(np.float32)
    c = rng.integers(-1, 3, n).astype(np.int32)
    if grid:
        x = (np.round(x * 8) / 8).astype(np.float32)
    if zeros:
        z = np.random.default_rng(seed + 1).random(n)
        x[z < 0.05] = -0.0
        x[(z >= 0.05) & (z < 0.1)] = 0.0
    return {"x": (T_NUM, x, None), "y": (T_NUM, y, None),
            "c": (T_CAT, c, ["a", "b", "d"])}


@pytest.fixture()
def frames(cl):
    """Publish (key, column specs) pairs in both DKVs; unpublished from
    the reference's after the test."""
    keys = []

    def put(key, cols):
        publish(key, *pair(cols))
        keys.append(key)

    yield put
    unpublish_ref(*keys)


def set_fuse(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("H2O_TPU_RAPIDS_FUSE", raising=False)
    else:
        monkeypatch.setenv("H2O_TPU_RAPIDS_FUSE", value)


def port_run(expr, monkeypatch, fuse="1"):
    set_fuse(monkeypatch, fuse)
    return ti.rapids_exec(expr, ti.Session("plan_port"), device="cpu")


def ref_run(expr, monkeypatch, fuse="1"):
    from h2o_tpu.rapids.interp import Session, rapids_exec
    set_fuse(monkeypatch, fuse)
    return rapids_exec(expr, Session("plan_ref"))


def bitwise(a, b):
    """Two port frames equal: names, types, domains and every column's
    bits (NaN payloads and the sign of zero included)."""
    assert a.names == b.names and a.nrows == b.nrows
    for n, va, vb in zip(a.names, a.vecs, b.vecs):
        assert va.type == vb.type, n
        assert (va.domain or None) == (vb.domain or None), n
        x, w = va.to_numpy(), vb.to_numpy()
        assert x.dtype == w.dtype, n
        assert x.tobytes() == w.tobytes(), n


def delta(stats_cls, fn):
    """(fn(), the PlanStats counters it moved, kinds included)."""
    b = stats_cls.snapshot()
    out = fn()
    a = stats_cls.snapshot()
    d = {k: a[k] - b[k] for k in a if k != "kinds"}
    d["kinds"] = {k: v - b["kinds"].get(k, 0) for k, v in a["kinds"].items()
                  if v != b["kinds"].get(k, 0)}
    return out, d


# -- the four region shapes --------------------------------------------------


@pytest.mark.parametrize("zeros", (False, True), ids=("torture", "zeros"))
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("tag,expr", SHAPES + MORE,
                         ids=[t for t, _ in SHAPES + MORE])
def test_fused_is_the_eager_chain_bitwise(frames, monkeypatch, tag, expr,
                                          seed, zeros):
    frames(K, torture(seed, zeros=zeros))
    fused, d = delta(p_plan.PlanStats, lambda: port_run(expr, monkeypatch))
    assert d["regions_fused"] == 1 and d["fallbacks_unfused"] == 0
    assert d["planner_errors"] == 0
    assert d["kinds"] == {KINDS[tag]: 1}
    eager, d0 = delta(p_plan.PlanStats,
                      lambda: port_run(expr, monkeypatch, "0"))
    assert not any(v for k, v in d0.items() if k != "kinds")
    bitwise(fused, eager)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("tag,expr", SHAPES + MORE,
                         ids=[t for t, _ in SHAPES + MORE])
def test_fused_equals_the_reference_fused(frames, monkeypatch, tag, expr,
                                          seed):
    frames(K, torture(seed, grid=KINDS[tag] == "filter_gb"))
    ref = ref_run(expr, monkeypatch)
    port = port_run(expr, monkeypatch)
    same(port, ref, zero_sign=False)


@pytest.mark.parametrize("fuse", ("1", "0", None), ids=("on", "off", "unset"))
@pytest.mark.parametrize("tag,expr", SHAPES + MORE,
                         ids=[t for t, _ in SHAPES + MORE])
def test_plan_stats_equal_the_reference(frames, monkeypatch, tag, expr, fuse):
    from h2o_tpu.rapids.plan import PlanStats as JStats
    frames(K, torture(7, grid=True))
    ref, dr = delta(JStats, lambda: ref_run(expr, monkeypatch, fuse))
    port, dp = delta(p_plan.PlanStats,
                     lambda: port_run(expr, monkeypatch, fuse))
    assert dp == dr
    # the CPU keeps per-verb unless told: one region fused only under =1,
    # and unset every region considered (an inner chain the eager sort
    # offers again too) keeps per-verb
    assert dp["regions_fused"] == (fuse == "1")
    assert dp["lever_per_verb"] == (dp["regions_considered"]
                                    if fuse is None else 0)
    if tag in dict(SHAPES):
        # MORE's chains filter a filter's output, which the reference's
        # eager chain gets wrong on its shards: see the next test
        same(port, ref, zero_sign=False)


@pytest.mark.parametrize("fuse", ("1", "0"))
def test_chained_filters_keep_numpys_rows(frames, monkeypatch, fuse):
    """A filter of a filter's (or na.omit's) output keeps the rows numpy
    keeps, fused or not.  The reference's eager chain keeps others on
    its 8-shard test mesh (62 of 110 rows for ``three_stages`` and 114
    of 130 for ``two_filters`` at seed 7 on the 1/8 grid); its fused
    regions keep numpy's."""
    cols = torture(7, grid=True)
    frames(K, cols)
    x, y, c = (cols[n][1] for n in ("x", "y", "c"))
    first = f"(rows {K} (> (cols {K} [1]) 0))"
    chains = {"three_stages": (dict(MORE)["three_stages"],
                               ~(np.isnan(x) | (c < 0)) & (y > 0)),
              "two_filters": (f"(rows {first} (> (cols {first} [1]) 1))",
                              y > 1)}
    for tag, (expr, keep) in chains.items():
        out = port_run(expr, monkeypatch, fuse)
        for n, col in (("x", x), ("y", y), ("c", c)):
            np.testing.assert_array_equal(out.vec(n).to_numpy(), col[keep],
                                          err_msg=tag)


# -- declines ----------------------------------------------------------------

S = "rp_s"
G = "rp_g"
DECLINES = (
    # (name, expression, extra environment)
    ("sort_without_chain", f"(sort {K} [0] [1])", {}),
    ("median", f"(GB (rows {K} (> (cols {K} [1]) 0)) [1] median 0 'all')",
     {}),
    ("mode", f"(GB (rows {K} (> (cols {K} [1]) 0)) [1] mode 2 'all')", {}),
    ("foreign_frame",
     f"(na.omit (rows {K} (> (cols {G} [1]) 1)))", {}),
    ("string_frame", f"(sort (rows {S} (> (cols {S} [0]) 9)) [0] [0])", {}),
    ("one_filter", f"(rows {K} (> (cols {K} [1]) 1))", {}),
    ("string_literal",
     f"(sort (rows {K} (== (cols {K} [2]) 'a')) [0] [1])", {}),
    ("environment_id",
     f"(sort (rows {K} (> (cols {K} [1]) {G})) [0] [1])", {}),
    ("multi_column_selector",
     f"(sort (rows {K} (> (cols {K} [0 1]) 0)) [0] [1])", {}),
    ("foreign_op",
     f"(sort (rows {K} (> (log10 (cols {K} [1])) 0)) [0] [1])", {}),
    ("gb_two_stages", f"(GB (na.omit (rows {K} (> (cols {K} [1]) 0))) "
     "[2] nrow 0 'all' mean 0 'all')", {}),
    ("device_munge_off", SHAPES[1][1], {"H2O_TPU_DEVICE_MUNGE": "0"}),
    ("shard_munge_off", SHAPES[1][1], {"H2O_TPU_SHARD_MUNGE": "off"}),
    ("max_verbs_2", SHAPES[1][1], {"H2O_TPU_RAPIDS_FUSE_MAX_VERBS": "2"}),
    ("autotune_off", SHAPES[0][1], {"H2O_TPU_AUTOTUNE": "off"}),
)


@pytest.fixture()
def decline_frames(frames):
    frames(K, torture(3, grid=True))
    frames(G, torture(3, grid=True))
    n = 64
    frames(S, {"x": (T_NUM, np.arange(n, dtype=np.float32), None),
               "s": (T_STR, [f"r{i}" for i in range(n)], None)})


#: the cuts whose base is a filter's output: the reference's base is then
#: ragged over its shards, and its eager chain's repack of it counts as
#: one more repack elided; one device holds no ragged frame
RAGGED_BASE = ("max_verbs_2",)


@pytest.mark.parametrize("name,expr,env", DECLINES,
                         ids=[d[0] for d in DECLINES])
def test_declines_count_as_the_reference(decline_frames, monkeypatch, name,
                                         expr, env):
    """Each decline stays eager (a chain the gate cuts fuses its outer
    part only, as the reference's) and moves the counters as the
    reference's does, under ``=1`` and unset."""
    from h2o_tpu.rapids.plan import PlanStats as JStats
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for fuse in ("1", None):
        ref, dr = delta(JStats, lambda: ref_run(expr, monkeypatch, fuse))
        port, dp = delta(p_plan.PlanStats,
                         lambda: port_run(expr, monkeypatch, fuse))
        if name in RAGGED_BASE and fuse == "1":
            assert dr["repacks_elided"] - dp["repacks_elided"] == 1, \
                (dp, dr)
            dr["repacks_elided"] = dp["repacks_elided"]
        assert dp == dr, (fuse, dp, dr)
        same(port, ref, zero_sign=False)
        assert dp["planner_errors"] == 0
    bitwise(port, port_run(expr, monkeypatch, "0"))


def test_unary_op_on_a_number_declines(frames, monkeypatch):
    """A unary op over a number raises in the eager chain (it takes a
    frame); the port's planner declines it after counting the region, so
    the eager error reaches the caller.  The reference fuses it."""
    frames(K, torture(7))
    expr = f"(sort (rows {K} (> (cols {K} [1]) (abs 2))) [0] [1])"
    b = p_plan.PlanStats.snapshot()
    with pytest.raises(TypeError, match="expected frame"):
        port_run(expr, monkeypatch)
    a = p_plan.PlanStats.snapshot()
    assert a["regions_considered"] - b["regions_considered"] == 1
    assert a["regions_fused"] == b["regions_fused"]
    with pytest.raises(TypeError, match="expected frame"):
        port_run(expr, monkeypatch, "0")


def test_numbers_fold_as_the_eager_chain(frames, monkeypatch):
    """Two numbers combine through ``_scalar_op`` in float32, the
    literals read as numbers, before they meet a column."""
    frames(K, torture(11))
    expr = (f"(sort (rows {K} (& (> (cols {K} [1]) (- 3 1.5)) "
            f"(!= (cols {K} [0]) NA))) [0] [1])")
    fused, d = delta(p_plan.PlanStats, lambda: port_run(expr, monkeypatch))
    assert d["regions_fused"] == 1
    bitwise(fused, port_run(expr, monkeypatch, "0"))


# -- the lever ---------------------------------------------------------------


@pytest.mark.parametrize("fuse,autotune,device,want", [
    (None, None, "cpu", False), (None, None, "cuda", True),
    (None, "force", "cpu", True), (None, "off", "cuda", False),
    ("1", "off", "cpu", True), ("0", "force", "cuda", False),
    ("on", None, "cpu", True), ("auto", None, "cpu", False),
    ("auto", None, "cuda", True), (" OFF ", None, "cuda", False)])
def test_lever_decision(monkeypatch, fuse, autotune, device, want):
    set_fuse(monkeypatch, fuse)
    if autotune is not None:
        monkeypatch.setenv("H2O_TPU_AUTOTUNE", autotune)
    assert p_plan._lever_fuses(torch.device(device)) is want


def test_autotune_force_fuses_on_the_cpu(frames, monkeypatch):
    frames(K, torture(7))
    monkeypatch.setenv("H2O_TPU_AUTOTUNE", "force")
    expr = SHAPES[1][1]
    fused, d = delta(p_plan.PlanStats,
                     lambda: port_run(expr, monkeypatch, None))
    assert d["regions_fused"] == 1 and d["lever_fused"] == 1
    bitwise(fused, port_run(expr, monkeypatch, "0"))


ENVS = [{}, {"H2O_TPU_RAPIDS_FUSE": "ON", "H2O_TPU_AUTOTUNE": "0",
             "H2O_TPU_RAPIDS_FUSE_MAX_VERBS": "1",
             "H2O_TPU_SHARD_MUNGE": "False"},
        {"H2O_TPU_RAPIDS_FUSE": "no", "H2O_TPU_AUTOTUNE": "Force",
         "H2O_TPU_RAPIDS_FUSE_MAX_VERBS": "5", "H2O_TPU_SHARD_MUNGE": "1"},
        {"H2O_TPU_RAPIDS_FUSE": " 1 ", "H2O_TPU_AUTOTUNE": "auto",
         "H2O_TPU_RAPIDS_FUSE_MAX_VERBS": "", "H2O_TPU_SHARD_MUNGE": "off"}]


@pytest.mark.parametrize("env", range(len(ENVS)))
def test_knobs_read_as_the_reference(monkeypatch, env):
    from h2o_tpu import config as j_config
    from h2o_tpu.core import autotune as j_autotune
    from h2o_tpu.core import munge as j_munge
    from h2o_tpu_torch.core import munge as p_munge
    for k, v in ENVS[env].items():
        monkeypatch.setenv(k, v)
    assert p_config.rapids_fuse_mode() == j_config.rapids_fuse_mode()
    assert p_config.rapids_fuse_max_verbs() == \
        j_config.rapids_fuse_max_verbs()
    assert p_config.autotune_mode() == j_autotune.autotune_mode()
    for var in ("H2O_TPU_RAPIDS_FUSE", "H2O_TPU_AUTOTUNE"):
        assert p_config.tri_state(var) == j_autotune.tri_state(var)
    assert p_munge.shard_munge_enabled() == j_munge.shard_munge_enabled()


# -- the OOM rung ------------------------------------------------------------


def test_region_oom_drill_degrades_bitwise(frames, monkeypatch):
    """``H2O_TPU_CHAOS_REGION_OOM_TRANSIENT=1``: the first fused region
    degrades to the eager chain (bitwise), counted once by the planner
    and by the OOM rung as the reference counts it; the next region
    fuses."""
    from h2o_tpu.core import chaos as j_chaos
    from h2o_tpu.core import oom as j_oom
    from h2o_tpu.rapids.plan import PlanStats as JStats
    frames(K, torture(7))
    expr = SHAPES[1][1]
    eager = port_run(expr, monkeypatch, "0")
    monkeypatch.setenv("H2O_TPU_CHAOS_REGION_OOM_TRANSIENT", "1")
    for mod in (p_chaos, j_chaos):
        mod.reset()                 # chaos() reads the variable anew
    degraded, dp = delta(p_plan.PlanStats,
                         lambda: port_run(expr, monkeypatch))
    _ref, dr = delta(JStats, lambda: ref_run(expr, monkeypatch))
    assert dp == dr
    assert dp["fallbacks_unfused"] == 1 and dp["regions_fused"] == 0
    bitwise(degraded, eager)
    st, jst = p_oom.stats(), j_oom.stats()
    assert st["sites"][p_fuse.SITE]["unfused_fallbacks"] == 1 == \
        jst["sites"]["rapids.fuse"]["unfused_fallbacks"]
    assert st["degradations"] == jst["degradations"] == 1
    assert p_chaos.chaos().injected_region_ooms == 1
    again, d2 = delta(p_plan.PlanStats, lambda: port_run(expr, monkeypatch))
    assert d2["regions_fused"] == 1 and d2["fallbacks_unfused"] == 0
    bitwise(again, eager)
    assert p_oom.stats()["degradations"] == 1


def test_fused_fallback_takes_only_device_ooms():
    calls = []

    def eager():
        calls.append("eager")
        return "eager"

    def raising(exc):
        def run():
            raise exc
        return run

    assert p_oom.fused_fallback("t", lambda: "fused", eager) == "fused"
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory")
    assert p_oom.fused_fallback("t", raising(oom), eager) == "eager"
    assert p_oom.fused_fallback(
        "t", raising(p_chaos.ChaosOOMError("x")), eager) == "eager"
    for exc in (RuntimeError("out of memory"), ValueError("x"),
                p_chaos.ChaosSliceLossError("device unavailable")):
        with pytest.raises(type(exc)):
            p_oom.fused_fallback("t", raising(exc), eager)
    assert calls == ["eager", "eager"]
    st = p_oom.stats()
    assert st["degradations"] == 2
    assert st["sites"] == {"t": {r: 2 if r == "unfused_fallbacks" else 0
                                 for r in p_oom._RUNGS}}
    p_oom.reset_stats()
    assert p_oom.stats()["degradations"] == 0
    assert p_oom.stats()["sites"] == {}


def test_fused_run_errors_propagate(frames, monkeypatch):
    """A failure of the fused run that is not an OOM reaches the caller
    and is not replayed."""
    frames(K, torture(7))

    def broken(*a, **k):
        raise RuntimeError("fused run failed")

    monkeypatch.setattr(p_fuse, "run_fused_sort", broken)
    b = p_plan.PlanStats.snapshot()
    with pytest.raises(RuntimeError, match="fused run failed"):
        port_run(SHAPES[0][1], monkeypatch)
    a = p_plan.PlanStats.snapshot()
    assert a["fallbacks_unfused"] == b["fallbacks_unfused"]
    assert a["regions_fused"] == b["regions_fused"]


def test_planner_errors_run_the_eager_chain(frames, monkeypatch):
    frames(K, torture(7))
    expr = SHAPES[3][1]

    def broken(*a, **k):
        raise RuntimeError("planning failed")

    eager = port_run(expr, monkeypatch, "0")
    monkeypatch.setattr(p_plan, "_resolve_stages", broken)
    out, d = delta(p_plan.PlanStats, lambda: port_run(expr, monkeypatch))
    assert d["planner_errors"] == 1 and d["regions_fused"] == 0
    bitwise(out, eager)


# -- transport, tables, isolation --------------------------------------------


@pytest.mark.parametrize("tag,expr", SHAPES, ids=[t for t, _ in SHAPES])
def test_a_region_moves_one_upload_and_one_download(frames, monkeypatch, tag,
                                                    expr):
    frames(K, torture(11))
    ups, downs = [], []
    real_up, real_down = p_fuse._upload, p_fuse._download
    from h2o_tpu_torch.core import munge as p_munge
    monkeypatch.setattr(p_fuse, "_upload",
                        lambda *a: ups.append(a[1]) or real_up(*a))
    monkeypatch.setattr(p_fuse, "_download",
                        lambda t: downs.append(1) or real_down(t))
    monkeypatch.setattr(p_munge, "_download",
                        lambda t: downs.append(1) or real_down(t))
    TransferStats.reset()
    out = port_run(expr, monkeypatch)
    moved = TransferStats.snapshot()
    assert len(ups) == 1 and len(downs) == 1
    # every shape reads x, y and c: the group-by its key, its aggregates
    # and its predicate's column
    assert moved["to_device"] == 203 * 3 * 4
    assert moved["to_host"] == out.nrows * out.ncols * 4
    TransferStats.reset()
    port_run(expr, monkeypatch, "0")
    eager_moved = TransferStats.snapshot()
    assert eager_moved["to_device"] > moved["to_device"]
    assert eager_moved["to_host"] > moved["to_host"]


def test_groupby_region_uploads_only_what_it_reads(frames, monkeypatch):
    cols = torture(7)
    cols["w"] = (T_NUM, np.arange(203, dtype=np.float32), None)
    frames(K, cols)
    TransferStats.reset()
    out = port_run(f"(GB (rows {K} (> (cols {K} [1]) 1)) [2] sum 0 'all')",
                   monkeypatch)
    moved = TransferStats.snapshot()
    assert moved["to_device"] == 203 * 3 * 4      # y, c and x; not w
    assert moved["to_host"] == out.nrows * 2 * 4


def test_predicate_tables_are_the_interpreters():
    from h2o_tpu.core import fuse as j_fuse
    assert sorted(p_fuse._PRED_BINOPS) == sorted(j_fuse._PRED_BINOPS)
    assert sorted(p_fuse._PRED_UNOPS) == sorted(j_fuse._PRED_UNOPS)
    for op, fn in p_fuse._PRED_BINOPS.items():
        assert fn is ti._BINOPS[op], op
    for op, fn in p_fuse._PRED_UNOPS.items():
        assert fn is ti._UNOPS[op], op


def test_planner_modules_import_no_jax():
    code = ("import sys\n"
            "import h2o_tpu_torch.rapids.plan, h2o_tpu_torch.core.fuse, "
            "h2o_tpu_torch.core.oom\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'h2o_tpu'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
