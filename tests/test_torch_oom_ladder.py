"""The OOM degradation ladder of ``h2o_tpu_torch.core.oom`` held against
``h2o_tpu.core.oom`` on the CPU (the counterparts of
``tests/test_oom_ladder.py:36-262``; its tiered-memory sweep test waits
for the tiered store, ROADMAP P14b).

Both packages' chaos injectors fail the first N attempts at each site
(``configure(oom_transient=N)``, the variable
``H2O_TPU_CHAOS_OOM_TRANSIENT``), so the same calls walk the same rungs:

- classification: an injected ``ChaosOOMError`` is a device OOM in both,
  the port's typed ``torch.cuda.OutOfMemoryError`` where the reference
  reads XLA's message; a terminal ``OOMError`` and other errors are not;
  every non-OOM error propagates untouched;
- the four rungs in order (sweep, shrink, host fallback, terminal) and
  transients absorbed by sweeps, with every site's rung counters equal
  to the reference's, and the terminal diagnostic naming what is held;
- GBM training (the blocked driver, ``tree.block``), a group-by and a
  sort through the Rapids interpreter (``munge.groupby``,
  ``munge.sort``) and the serving engine (``serve.predict``) under
  injected OOMs: bitwise the fault-free answer while the device rungs
  absorb them, the host rung's answer bitwise (sort) or within the
  reference test's 1e-5 (the group-by's float sums, the host scorer);
  the site counters equal the reference's;
- a terminal OOM fails its job, not the process: the next job runs.
"""

import numpy as np
import pytest
import torch

from h2o_tpu.core import chaos as j_chaos
from h2o_tpu.core import oom as j_oom

from h2o_tpu_torch.core import chaos as p_chaos
from h2o_tpu_torch.core import oom as p_oom
from h2o_tpu_torch.core.store import dkv, unpublish_on_exit


@pytest.fixture(autouse=True)
def _reset(cl):
    for mod in (j_oom, p_oom):
        mod.reset_stats()
    with unpublish_on_exit():
        yield
    for mod in (j_chaos, p_chaos):
        mod.reset()
    for mod in (j_oom, p_oom):
        mod.reset_stats()


def configure(n):
    """The same transient injection in both packages."""
    for mod in (j_chaos, p_chaos):
        mod.configure(oom_transient=n, seed=0)


def site(mod, name):
    return mod.stats()["sites"].get(name, {})


def same_site(name):
    """The port's rung counters at ``name`` equal the reference's."""
    p, j = site(p_oom, name), site(j_oom, name)
    assert p == j, (name, p, j)
    return p


# -- classification ----------------------------------------------------------

def test_classification():
    inj_p = p_chaos.ChaosOOMError("injected device OOM")
    inj_j = j_chaos.ChaosOOMError("injected device OOM")
    assert p_oom.is_device_oom(inj_p) and j_oom.is_device_oom(inj_j)
    assert p_oom.is_device_oom(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 1.00 GiB"))
    for mod in (p_oom, j_oom):
        assert not mod.is_device_oom(ValueError("Out of memory"))
        assert not mod.is_device_oom(mod.OOMError("site", "diag"))
    # the port classifies by type: PyTorch raises its typed error, never
    # a plain RuntimeError, for a failed CUDA allocation
    assert not p_oom.is_device_oom(RuntimeError("out of memory"))
    assert not p_oom.is_device_oom(p_chaos.ChaosSliceLossError("lost"))


def test_non_oom_errors_propagate_untouched():
    def attempt():
        raise ValueError("not an OOM")

    for mod in (p_oom, j_oom):
        with pytest.raises(ValueError):
            mod.oom_ladder("t.unrelated", attempt)
        assert mod.stats()["oom_events"] == 0
    assert p_oom.stats() == j_oom.stats()


def test_oom_error_keeps_its_text_when_cloned():
    e = p_oom.OOMError("t.site", "diag text")
    assert str(e) == str(j_oom.OOMError("t.site", "diag text"))
    assert e.site == "t.site"
    assert str(type(e)(*e.args)) == str(e)


# -- ladder rung order -------------------------------------------------------

def _walk(mod, name):
    calls = {"n": 0}
    quantum = {"q": 8}

    def attempt():
        calls["n"] += 1
        return "device"

    def shrink():
        if quantum["q"] <= 1:
            return False
        quantum["q"] //= 2
        return True

    out = mod.oom_ladder(name, attempt, shrink=shrink,
                         host_fallback=lambda: "host")
    return out, calls["n"]


def test_ladder_walks_sweep_shrink_fallback_terminal():
    configure(1000)
    for mod in (p_oom, j_oom):
        assert _walk(mod, "t.full") == ("host", 0)
    s = same_site("t.full")
    assert s["sweeps"] == p_oom.sweep_retries() == 2
    assert s["shrinks"] == 3          # 8 -> 4 -> 2 -> 1
    assert s["host_fallbacks"] == 1 and s["terminal"] == 0
    for mod in (p_oom, j_oom):
        with pytest.raises(mod.OOMError) as ei:
            mod.oom_ladder("t.terminal", lambda: "never")
        assert "resident_bytes" in str(ei.value)
        assert "budget" in str(ei.value)
        assert "t.terminal" in str(ei.value)
    assert same_site("t.terminal")["terminal"] == 1
    assert p_oom.stats()["terminal_failures"] == 1
    assert p_oom.stats()["degradations"] == \
        j_oom.stats()["degradations"] == 4


def test_sweep_retries_from_the_environment(monkeypatch):
    monkeypatch.setenv("H2O_TPU_OOM_SWEEP_RETRIES", "3")
    configure(1000)
    assert p_oom.sweep_retries() == j_oom.sweep_retries() == 3
    for mod in (p_oom, j_oom):
        assert _walk(mod, "t.env") == ("host", 0)
    assert same_site("t.env")["sweeps"] == 3


def test_transient_faults_absorbed_by_sweeps():
    configure(2)
    for mod in (p_oom, j_oom):
        assert mod.oom_ladder("t.sweep", lambda: "device") == "device"
    s = same_site("t.sweep")
    assert s["oom_events"] == 2 and s["sweeps"] == 2
    assert s["shrinks"] == 0 and s["terminal"] == 0
    assert p_chaos.chaos().injected_oom == j_chaos.chaos().injected_oom == 2
    # the site's injections are spent: the next call sails through
    for mod in (p_oom, j_oom):
        assert mod.oom_ladder("t.sweep", lambda: "device") == "device"
    assert p_chaos.chaos().injected_oom == 2


def test_on_oom_sees_every_classified_oom():
    configure(2)
    seen = {"p": [], "j": []}
    for mod, k in ((p_oom, "p"), (j_oom, "j")):
        mod.oom_ladder("t.hook", lambda: 1, shrink=lambda: False,
                       on_oom=lambda e, k=k: seen[k].append(type(e).__name__))
    assert seen["p"] == seen["j"] == ["ChaosOOMError"] * 2
    same_site("t.hook")


def test_fused_fallback_also_takes_a_terminal_oom():
    """The region rung replays eagerly when the fused run's own ladder
    ended in ``OOMError``, as the reference's does."""
    def fused():
        raise p_oom.OOMError("rapids.fuse", "diag")

    assert p_oom.fused_fallback("t.region", fused, lambda: "eager") == "eager"
    assert site(p_oom, "t.region")["unfused_fallbacks"] == 1


# -- choke points ------------------------------------------------------------

def _gbm_frames(seed=42):
    from h2o_tpu.core.frame import T_CAT, Frame, Vec
    from h2o_tpu_torch.core.frame import Frame as TFrame
    from h2o_tpu_torch.core.frame import Vec as TVec
    rng = np.random.default_rng(seed)
    x = rng.normal(size=300).astype(np.float32)
    y = (x + rng.normal(size=300) * 0.3 > 0).astype(np.int32)

    def ref():
        return Frame(["x", "y"], [Vec(x), Vec(y, T_CAT, domain=["a", "b"])])

    def port():
        return TFrame(["x", "y"], [TVec(x), TVec(y, T_CAT,
                                                  domain=["a", "b"])])
    return ref, port


GBM_KW = dict(ntrees=8, max_depth=3, seed=7, sample_rate=0.7,
              score_tree_interval=4)


@pytest.mark.parametrize("transient", [2, 4])
def test_gbm_train_bitwise_under_injected_oom(transient):
    """Fail-first-2 is absorbed by sweeps; fail-first-4 reaches the
    shrink rung, which halves the block for the rest of the run.  The
    forest and its predictions are bitwise the fault-free run's, and
    the ``tree.block`` counters equal the reference's."""
    from h2o_tpu.models.tree.gbm import GBM as JGBM
    from h2o_tpu_torch.models.tree.gbm import GBM
    ref, port = _gbm_frames()

    def train():
        return GBM(device="cpu", **GBM_KW).train(y="y",
                                                 training_frame=port())

    clean = train()
    want = clean.predict_raw(port()).numpy()
    configure(transient)
    m = train()
    JGBM(**GBM_KW).train(y="y", training_frame=ref())
    np.testing.assert_array_equal(m.predict_raw(port()).numpy(), want)
    for k in ("split_col", "bitset", "value", "thr_bin", "na_left"):
        np.testing.assert_array_equal(np.asarray(m.output[k]),
                                      np.asarray(clean.output[k]), k)
    s = same_site("tree.block")
    assert s["oom_events"] == transient and s["sweeps"] == 2
    assert s["shrinks"] == (2 if transient == 4 else 0)
    assert s["host_fallbacks"] == s["terminal"] == 0


def test_one_call_forest_sweeps_under_injected_oom():
    """Without scoring the forest is one call: two sweeps absorb two
    OOMs, and there is no block to shrink."""
    from h2o_tpu.models.tree.gbm import GBM as JGBM
    from h2o_tpu_torch.models.tree.gbm import GBM
    ref, port = _gbm_frames(3)
    kw = dict(ntrees=4, max_depth=3, seed=7)
    clean = GBM(device="cpu", **kw).train(y="y", training_frame=port())
    configure(2)
    m = GBM(device="cpu", **kw).train(y="y", training_frame=port())
    JGBM(**kw).train(y="y", training_frame=ref())
    np.testing.assert_array_equal(m.predict_raw(port()).numpy(),
                                  clean.predict_raw(port()).numpy())
    s = same_site("tree.block")
    assert (s["oom_events"], s["sweeps"], s["shrinks"]) == (2, 2, 0)


def _munge_frame(rng):
    from tests.test_torch_rapids_interp import pair, publish
    from h2o_tpu_torch.core.frame import T_NUM
    g = rng.integers(0, 7, size=200).astype(np.float32)
    v = rng.normal(size=200).astype(np.float32)
    ref, port = pair({"g": (T_NUM, g, None), "v": (T_NUM, v, None)})
    publish("oomgb", ref, port)


def _cols(fr):
    return [np.asarray(v.to_numpy()).copy() for v in fr.vecs]


def _rapids_both(expr):
    from tests.test_torch_rapids_interp import both
    ref, port = both(expr)
    return _cols(ref), _cols(port)


GB = '(GB oomgb [0] sum 1 "all" mean 1 "all" nrow 1 "all")'
SORT = "(sort oomgb [1] [1])"


@pytest.mark.parametrize("expr,name", [(GB, "munge.groupby"),
                                       (SORT, "munge.sort")])
def test_munge_verbs_bitwise_under_injected_oom(expr, name, rng,
                                                monkeypatch):
    """Two OOMs are absorbed by sweeps, the frame bitwise; a persisting
    OOM ends in the verb's host route: the sort bitwise, the group-by's
    float sums within 1e-5 as the reference's test holds its own."""
    from tests.test_torch_rapids_interp import unpublish_ref
    monkeypatch.setenv("H2O_TPU_DEVICE_MUNGE", "1")
    _munge_frame(rng)
    try:
        _, want = _rapids_both(expr)
        configure(2)
        _, got = _rapids_both(expr)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, b)
        s = same_site(name)
        assert s["oom_events"] == 2 and s["sweeps"] == 2
        configure(1000)
        for mod in (p_oom, j_oom):
            mod.reset_stats()
        _, host = _rapids_both(expr)
        for a, b in zip(want, host):
            if name == "munge.sort":
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        s = same_site(name)
        assert s["host_fallbacks"] == 1 and s["terminal"] == 0
    finally:
        unpublish_ref("oomgb")
        dkv().remove("oomgb")


def test_serve_predict_bitwise_under_injected_oom(rng):
    """Two sweeps and two batch splits answer bitwise; a persisting OOM
    ends in the numpy scorer, within 1e-5 of the device answer; the
    ``serve.predict`` counters equal the reference engine's."""
    from h2o_tpu.core.frame import T_CAT, Frame, Vec
    from h2o_tpu.models.tree.gbm import GBM as JGBM
    from h2o_tpu.serve.engine import ScoringEngine as JEngine
    from h2o_tpu_torch.core.frame import Frame as TFrame
    from h2o_tpu_torch.core.frame import Vec as TVec
    from h2o_tpu_torch.models.tree.gbm import GBM
    from h2o_tpu_torch.serve.engine import ScoringEngine
    x = rng.normal(size=300).astype(np.float32)
    y = (x > 0).astype(np.int32)
    jm = JGBM(ntrees=3, max_depth=3, seed=1).train(
        y="y", training_frame=Frame(["x", "y"], [
            Vec(x), Vec(y, T_CAT, domain=["n", "p"])]))
    m = GBM(ntrees=3, max_depth=3, seed=1, device="cpu").train(
        y="y", training_frame=TFrame(["x", "y"], [
            TVec(x), TVec(y, T_CAT, domain=["n", "p"])]))
    eng, jeng = ScoringEngine(), JEngine()
    rows = [{"x": float(v)} for v in x[:16]]
    X, JX = eng.encode_rows(m, 0, rows), jeng.encode_rows(jm, 0, rows)
    want = eng.predict(m, 0, X)
    jeng.predict(jm, 0, JX)
    try:
        configure(4)
        np.testing.assert_array_equal(eng.predict(m, 0, X), want)
        jeng.predict(jm, 0, JX)
        s = same_site("serve.predict")
        assert s["sweeps"] == 2 and s["shrinks"] == 2
        configure(1000)
        for mod in (p_oom, j_oom):
            mod.reset_stats()
        host = eng.predict(m, 0, X)
        jeng.predict(jm, 0, JX)
        assert host.shape == want.shape
        np.testing.assert_allclose(host, want, rtol=0, atol=1e-5)
        assert same_site("serve.predict")["host_fallbacks"] == 1
        assert eng.stats()["fallback_batches"] == 1
    finally:
        eng.evict(m.model_id, 0)
        jeng.evict(str(jm.key), 0)


def test_terminal_oom_fails_job_not_process():
    """An OOM no rung absorbs fails its job with ``OOMError``; the
    registry runs the next job."""
    from h2o_tpu_torch.core.job import FAILED, Job, jobs
    configure(1000)
    job = Job(description="oom drill")
    jobs().start(job, lambda j: p_oom.oom_ladder("t.job", lambda: "never"))
    with pytest.raises(p_oom.OOMError, match="t.job"):
        job.join(timeout=30)
    assert job.status == FAILED
    assert isinstance(job.exception, p_oom.OOMError)
    ok = Job(description="after oom")
    jobs().start(ok, lambda j: 42)
    assert ok.join(timeout=30) == 42
    assert site(p_oom, "t.job")["terminal"] == 1


def test_sweep_holds_nothing_at_budget_zero():
    from h2o_tpu_torch.core.memory import manager
    assert manager().sweep() == 0
    st = manager().stats()
    assert st["resident_bytes"] == 0 and st["budget"] == 0
