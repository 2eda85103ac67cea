"""The executable store of ``h2o_tpu_torch.core.exec_store`` held against
``h2o_tpu.core.exec_store`` on the CPU (the counterparts of
``tests/test_exec_store.py``'s ``test_bucket_pow2``,
``test_hit_miss_and_eviction``,
``test_engine_bookkeeping_reconciles_with_store``,
``test_serve_engine_routes_through_store`` and
``test_dispatch_walks_sweep_rung_on_injected_oom``; the donation and
disk tests have no counterpart: the port donates nothing, and a CUDA
graph cannot be written to disk).

On the CPU an entry is the built callable, run eagerly, and the store
counts it as the reference counts an executable: the same sequence of
calls gives the same hits, misses, evictions, entries and per-phase
``DispatchStats`` deltas in both packages, and the serving engine keys
its predict entries ``("serve", "predict", model_id, version, bucket)``
as the reference's does, with answers within the converter tests'
1e-6 of the reference engine's.  On the card an entry is a captured
CUDA graph (``chip_smoke.py`` phase 30a holds its answers bitwise the
eager predict's).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from h2o_tpu.core import exec_store as j_es
from h2o_tpu.core.diag import DispatchStats as JStats

from h2o_tpu_torch.core import exec_store as p_es
from h2o_tpu_torch.core.diag import DispatchStats as PStats
from h2o_tpu_torch.core.store import unpublish_on_exit
from tests.test_torch_mojo import XM, carried, dataset, raw_matrix


@pytest.fixture(autouse=True)
def _unpublish():
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv


def _scale(x):
    return x * 3.0


def _add(x, y):
    return x + y


def test_bucket_pow2():
    ns = list(range(0, 2100)) + [4095, 4096, 4097, 1 << 20]
    assert [p_es.bucket_pow2(n) for n in ns] == \
        [j_es.bucket_pow2(n) for n in ns]
    assert [p_es.bucket_pow2(n) for n in (0, 1, 2, 3, 4, 5, 8, 9, 17)] == \
        [1, 1, 2, 4, 4, 8, 8, 16, 32]


def _counters(st):
    s = st.stats()
    return (st.misses, st.hits, st.evictions, s["entries"], s["capacity"],
            s["disk_hits"], s["kernels"], st.keys())


def _phase_delta(stats, before, phase):
    snap = stats.snapshot()
    return {k: snap[k].get(phase, 0) - before[k].get(phase, 0)
            for k in ("compiles", "cache_hits", "dispatches", "disk_hits")}


def test_hit_miss_and_eviction():
    """The reference test's sequence on both stores: a miss is a build,
    a hit is not, the LRU bound evicts oldest-first; every counter, the
    live keys and the per-phase dispatch stats equal."""
    jb, pb = JStats.snapshot(), PStats.snapshot()
    stores = {}
    for pkg, es, arr in (("j", j_es, jnp.ones((8,))),
                         ("p", p_es, torch.ones(8))):
        st = es.ExecStore(max_entries=2)
        fn = st.get_or_build("t", ("k1",), lambda: _scale)
        np.testing.assert_allclose(np.asarray(fn(arr)), 3.0 * np.ones(8))
        assert (st.misses, st.hits) == (1, 0)
        st.get_or_build("t", ("k1",), lambda: _scale)
        assert (st.misses, st.hits) == (1, 1)
        st.get_or_build("t", ("k2",), lambda: _scale)
        st.get_or_build("t", ("k3",), lambda: _scale)     # evicts k1
        assert st.stats()["entries"] == 2
        assert st.evictions == 1
        st.get_or_build("t", ("k1",), lambda: _scale)     # miss again
        assert st.misses == 4
        stores[pkg] = st
    j, p = _counters(stores["j"]), _counters(stores["p"])
    assert [list(k) for k in p[-1]] == [[*k[:-1]] for k in j[-1]]
    assert p[:-1] == j[:-1]
    assert _phase_delta(PStats, pb, "t") == _phase_delta(JStats, jb, "t")


def test_evict_keys_clear_and_kernel_names():
    out = {}
    for pkg, es in (("j", j_es), ("p", p_es)):
        st = es.ExecStore(max_entries=8)
        for name in ("sort", "gb", "sort"):
            st.get_or_build("munge", (name, 1), lambda: _scale)
        st.get_or_build("serve", ("predict", "m", 0, 8), lambda: _scale)
        n = st.evict(lambda k: k[0] == "serve")
        out[pkg] = (n, st.kernel_names(), len(st.keys()), st.misses,
                    st.hits)
        st.clear()
        assert st.keys() == [] and st.stats()["entries"] == 0
    assert out["p"] == out["j"] == (1, {"munge": ["gb", "sort"]}, 2, 3, 1)


@pytest.mark.parametrize("var", ["H2O_TPU_EXEC_STORE",
                                 "H2O_TPU_DISPATCH_CACHE"])
def test_capacity_from_the_environment(var, monkeypatch):
    monkeypatch.delenv("H2O_TPU_EXEC_STORE", raising=False)
    monkeypatch.delenv("H2O_TPU_DISPATCH_CACHE", raising=False)
    assert p_es.ExecStore().max_entries == j_es.ExecStore().max_entries \
        == 256
    monkeypatch.setenv(var, "7")
    assert p_es.ExecStore().max_entries == j_es.ExecStore().max_entries == 7
    assert p_es.ExecStore(max_entries=3).max_entries == 3


def test_stable_fn_name_and_aval_key():
    assert p_es.stable_fn_name(_add) == j_es.stable_fn_name(_add) == \
        f"{__name__}._add"

    def local(x):
        return x

    y = 2.0
    for fn in (local, lambda x: x * y):
        assert p_es.stable_fn_name(fn) is None is j_es.stable_fn_name(fn)
    a = p_es.aval_key(torch.zeros((4, 3)))
    assert a == p_es.aval_key(torch.ones((4, 3)))
    assert a != p_es.aval_key(torch.zeros((4, 3), dtype=torch.float64))
    assert a != p_es.aval_key(torch.zeros((8, 3)))
    assert p_es.aval_key(np.zeros((2, 2), np.float32)) == \
        j_es.aval_key(np.zeros((2, 2), np.float32))
    assert p_es.aval_key([1, (2.5, "s")]) == j_es.aval_key([1, (2.5, "s")])
    assert p_es.aval_key({"b": 1, "a": 2}) == j_es.aval_key({"b": 1, "a": 2})


def test_no_donation_and_no_disk_layer():
    st = p_es.ExecStore(max_entries=4)
    assert st.donation_on() is False
    st.get_or_build("t", ("x",), lambda: _scale, args=(torch.ones(2),))
    s = st.stats()
    assert s["disk_hits"] == 0 and s["graph_entries"] == 0
    assert s["misses"] == 1


def test_dispatch_walks_sweep_rung_on_injected_oom(cl):
    """One injected OOM: the dispatch sweeps and retries, the answer is
    the entry's, and the site counters, the store's counters and the
    phase's dispatch stats equal the reference's."""
    from h2o_tpu.core import chaos as j_chaos
    from h2o_tpu.core import oom as j_oom
    from h2o_tpu_torch.core import chaos as p_chaos
    from h2o_tpu_torch.core import oom as p_oom
    site = "exec_store.test_sweep"
    jb, pb = JStats.snapshot(), PStats.snapshot()
    stores = {}
    try:
        for pkg, es, chaos, arr in (
                ("j", j_es, j_chaos, jnp.arange(8, dtype=jnp.float32)),
                ("p", p_es, p_chaos, torch.arange(8, dtype=torch.float32))):
            st = es.ExecStore(max_entries=8)
            chaos.configure(oom_transient=1)
            out = st.dispatch("t2", ("sweep",), lambda: _scale, (arr,),
                              site=site)
            np.testing.assert_allclose(np.asarray(out), 3.0 * np.arange(8))
            stores[pkg] = st
        p_site = p_oom.stats()["sites"][site]
        assert p_site == j_oom.stats()["sites"][site]
        assert p_site["oom_events"] == 1 and p_site["sweeps"] == 1
        assert _counters(stores["p"])[:-1] == _counters(stores["j"])[:-1]
        assert _phase_delta(PStats, pb, "t2") == \
            _phase_delta(JStats, jb, "t2")
    finally:
        for mod in (j_chaos, p_chaos):
            mod.reset()
        for mod in (j_oom, p_oom):
            mod.reset_stats()


def test_dispatch_passes_other_errors_and_retries_a_failed_build():
    """A build that fails with a device OOM is built again by the retry
    (a capture that ran out of memory walks the ladder); other errors
    propagate untouched."""
    from h2o_tpu_torch.core import oom as p_oom
    st = p_es.ExecStore(max_entries=4)
    tries = []

    def build():
        tries.append(1)
        if len(tries) == 1:
            raise torch.cuda.OutOfMemoryError("out of memory at capture")
        return _scale

    try:
        out = st.dispatch("t3", ("b",), build, (torch.ones(3),),
                          site="t3.site")
        assert out.tolist() == [3.0, 3.0, 3.0] and len(tries) == 2
        assert st.misses == 1 and st.hits == 0
        assert p_oom.stats()["sites"]["t3.site"]["sweeps"] == 1

        def bad():
            raise KeyError("not memory")
        with pytest.raises(KeyError):
            st.dispatch("t3", ("bad",), lambda: lambda x: bad(),
                        (torch.ones(1),))
    finally:
        p_oom.reset_stats()


def test_engine_bookkeeping_reconciles_with_store():
    """The engine never reports a bucket the shared store does not hold
    (an entry another phase's traffic evicted, or one never built)."""
    from h2o_tpu.serve.engine import ScoringEngine as JEngine
    from h2o_tpu_torch.serve.engine import ScoringEngine
    for eng in (ScoringEngine(), JEngine()):
        with eng._lock:
            eng._keys.add(("ghost_model", 0, 8))
        assert eng.buckets_for("ghost_model", 0) == []
        assert ("ghost_model", 0, 8) not in eng._keys


def test_serve_engine_routes_through_store():
    """Both engines put a 5-row batch in bucket 8 of their store, under
    the same key shape; evict empties it; the answers agree."""
    from h2o_tpu.serve.engine import ScoringEngine as JEngine
    from h2o_tpu_torch.serve.engine import ScoringEngine
    jm, cm, _ = carried("gbm")
    X = raw_matrix(dataset("mixed")[1], XM)[:5]
    out = {}
    for eng, m, mid, es in ((JEngine(), jm, str(jm.key), j_es),
                            (ScoringEngine(), cm, cm.model_id, p_es)):
        before = es.exec_store().stats()["misses"]
        out[mid] = np.asarray(eng.predict(m, 1, X))
        in_store = [k for k in es.exec_store().keys()
                    if k[:4] == ("serve", "predict", mid, 1)]
        assert [k[2:5] for k in in_store] == [(mid, 1, 8)]
        assert es.exec_store().stats()["misses"] - before == 1
        assert eng.buckets_for(mid, 1) == [8]
        assert eng.stats()["compiled_cache_entries"] == 1
        assert eng.stats()["store_disk_hits"] == 0
        eng.evict(mid, 1)
        assert eng.buckets_for(mid, 1) == []
        assert not [k for k in es.exec_store().keys()
                    if k[:4] == ("serve", "predict", mid, 1)]
    got, want = out[cm.model_id], out[str(jm.key)]
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=0, atol=1e-6)


def test_engine_answers_and_counters_equal_the_reference():
    """The same batches through both engines: hits, misses and the
    serve phase's compiles and cache hits move alike (warm buckets 1
    and 32, then batches of 1..40 rows: 4 misses, 4 hits)."""
    from h2o_tpu.serve.engine import ScoringEngine as JEngine
    from h2o_tpu_torch.serve.engine import ScoringEngine
    jm, cm, _ = carried("gbm")
    X = raw_matrix(dataset("mixed")[1], XM)
    deltas, answers = {}, {}
    for tag, eng, m, es, stats in (
            ("j", JEngine(), jm, j_es, JStats),
            ("p", ScoringEngine(), cm, p_es, PStats)):
        st, snap = es.exec_store(), stats.snapshot()
        h0, m0 = st.hits, st.misses
        eng.warm(m, 7, (1, 32))
        answers[tag] = [np.asarray(eng.predict(m, 7, X[:n]))
                        for n in (1, 3, 17, 32, 40, 3)]
        deltas[tag] = (st.hits - h0, st.misses - m0,
                       _phase_delta(stats, snap, "serve"),
                       eng.buckets_for(str(m.key), 7))
        eng.evict(str(m.key), 7)
    assert deltas["p"][:2] == deltas["j"][:2] == (4, 4)
    p_d, j_d = deltas["p"][2], deltas["j"][2]
    assert (p_d["compiles"], p_d["cache_hits"]) == \
        (j_d["compiles"], j_d["cache_hits"])
    assert deltas["p"][3] == deltas["j"][3] == [1, 4, 32, 64]
    for got, want in zip(answers["p"], answers["j"]):
        np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=0,
                                   atol=1e-6)


def test_device_constants_upload_once_and_follow_the_output():
    """A model's device predict reads its arrays from a cache it owns:
    a second predict uploads nothing, a replaced output array is
    uploaded again, and ``clear_device_consts`` empties the cache."""
    import copy
    _, cm, _ = carried("gbm")
    m = copy.copy(cm)
    m.__dict__.pop("_dev_consts", None)
    X = raw_matrix(dataset("mixed")[1], XM)[:20]
    want = m.predict_raw_array(X).numpy()
    first = {id(t) for t in _flat(m.device_consts())}
    np.testing.assert_array_equal(m.predict_raw_array(X).numpy(), want)
    assert {id(t) for t in _flat(m.device_consts())} == first
    m.output = dict(m.output, f0=np.asarray(m.output["f0"]) + 1.0)
    shifted = m.predict_raw_array(X).numpy()
    assert not np.array_equal(shifted, want)
    m.clear_device_consts()
    assert m.device_consts() == []


def _flat(vals):
    out = []
    for v in vals:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, dict):
            out.extend(t for t in v.values() if isinstance(t, torch.Tensor))
        elif isinstance(v, (tuple, list)):
            out.extend(t for t in v if isinstance(t, torch.Tensor))
    return out
