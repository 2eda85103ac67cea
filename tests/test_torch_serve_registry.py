"""The port's deployment registry (``h2o_tpu_torch.serve.registry``) held
against ``h2o_tpu.serve.registry`` on the CPU:

- ``score_rows`` of the carried GBM, DRF, XGBoost and GLM against the
  reference's registry serving the reference's models, on the same JSON
  rows with NA, missing keys and unseen levels, within
  ``test_torch_serve_engine.py``'s ``FAST`` tolerances (labels equal
  where p1 is decided);
- deploy / hot swap / rollback / undeploy: ``describe()`` keys and the
  values that do not depend on the clock equal the reference's, a
  rolled-back or undeployed version's buckets are empty, the TimeLine
  records each transition;
- the undeploy/score race answers each request completely or with a
  ``KeyError`` (404), never with a half-removed answer;
- canary routing, promotion and auto-rollback equal the reference's
  (the versions clients see, the rollback and fallback counters);
- a shadow of the same model counts 0 mismatches, a GLM shadow of the
  GBM mismatches as the reference's does;
- a model built with ``device="cpu"`` serves on the CPU and a model
  with a device predict never reaches the host scorer;
- no lock cycle is witnessed.
"""

import importlib
import threading
import time

import numpy as np
import pytest

from h2o_tpu_torch.core import lockwitness as p_lw
from h2o_tpu_torch.core.diag import TimeLine
from h2o_tpu_torch.models.model import Model
from h2o_tpu_torch.serve.registry import ServingConfig
from tests.test_torch_mojo import carried, dataset
from tests.test_torch_serve_engine import FAST

pytestmark = pytest.mark.shared_dkv

# both packages' ``serve`` export a ``registry()`` function under the
# module's name
j_reg_mod = importlib.import_module("h2o_tpu.serve.registry")
p_reg_mod = importlib.import_module("h2o_tpu_torch.serve.registry")

WAIT = 30.0
LEVELS = ["a", "b", "cc", "d", "e"]


def rows(idx):
    """JSON rows of the mixed frame: level strings, with an unseen
    level, None, missing keys and numbers as strings mixed in."""
    frame = dataset("mixed")[1]
    x0, x1 = frame.vec("x0").data, frame.vec("x1").data
    c = frame.vec("c").data
    out = []
    for i in idx:
        r = {"x0": float(x0[i]), "x1": float(x1[i])}
        if c[i] >= 0:
            r["c"] = LEVELS[int(c[i])]
        if i % 7 == 3:
            r["c"] = "unseen"
        if i % 11 == 5:
            r["x1"] = None
        if i % 13 == 6:
            del r["x0"]
        if i % 17 == 2:
            r["x1"] = repr(r["x1"])
        out.append(r)
    return out


REQUESTS = [list(range(s, s + 4)) for s in range(0, 40, 4)] + [[41], [53]]


def _pair(names, **cfg):
    """(reference registry, port registry) with ``names`` deployed
    under their own names."""
    jr, pr = j_reg_mod.ServingRegistry(), p_reg_mod.ServingRegistry()
    for n in names:
        jm, cm, _ = carried(n)
        jr.deploy(n, jm, j_reg_mod.ServingConfig(**cfg))
        pr.deploy(n, cm, ServingConfig(**cfg))
    return jr, pr


@pytest.fixture(scope="module")
def served():
    jr, pr = _pair(sorted(FAST))
    yield jr, pr
    jr.reset()
    pr.reset()


@pytest.mark.parametrize("name", sorted(FAST))
def test_score_rows_matches_reference(served, name):
    jr, pr = served
    tol = FAST[name]
    for idx in REQUESTS:
        want, jver = jr.score_rows(name, rows(idx))
        got, pver = pr.score_rows(name, rows(idx))
        assert got.shape == want.shape and got.dtype == np.float32
        assert (pver.version, pver.model_id) == (jver.version,
                                                 jver.model_id)
        np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=0,
                                   atol=tol)
        decided = np.abs(want[:, 2] - 0.5) > tol
        np.testing.assert_array_equal(got[decided, 0], want[decided, 0])
    st = pr.describe(pr.get(name))["stats"]
    assert st["request_count"] == st["batch_count"] == len(REQUESTS)
    assert st["rows_scored"] == sum(len(r) for r in REQUESTS)
    assert pr.engine.stats()["fallback_batches"] == 0


@pytest.mark.parametrize("name", sorted(FAST))
def test_answers_equal_the_engine_alone(served, name):
    """A request's answer is the engine's on its rows alone, bitwise."""
    _jr, pr = served
    _jm, cm, _ = carried(name)
    for idx in REQUESTS[:3]:
        got, ver = pr.score_rows(name, rows(idx))
        X = pr.engine.encode_rows(cm, ver.version, rows(idx))
        np.testing.assert_array_equal(got, pr.engine.predict(
            cm, ver.version, X))


def _clockless(d):
    """``describe()`` without the values the clock decides."""
    d = dict(d)
    d["stats"] = {k: v for k, v in d["stats"].items()
                  if not k.endswith("_ms")}
    b = dict(d["breaker"])
    b["events"] = [{k: v for k, v in e.items() if k != "time"}
                   for e in b["events"]]
    d["breaker"] = b
    return d


def _keys(d):
    if isinstance(d, dict):
        return {k: _keys(v) for k, v in d.items()}
    return None


def _lifecycle(reg, m1, m2, id2):
    out = [reg.deploy("alias", m1)]
    out.append(reg.deploy("alias", m2))
    o, ver = reg.score_rows("alias", rows(range(4)))
    out.append((ver.version, ver.model_id))
    out.append(reg.rollback("alias"))
    out.append(reg.engine.buckets_for(id2, 2))
    try:
        reg.rollback("alias")
    except ValueError as e:
        out.append(str(e))
    o, ver = reg.score_rows("alias", rows([0]))
    out.append((ver.version, ver.model_id))
    out.append([_clockless(d) for d in reg.list()])
    und = reg.undeploy("alias", drain_secs=5.0)
    out.append((und["name"], und["drained"],
                {k: v for k, v in und["stats"].items()
                 if not k.endswith("_ms")}))
    out.append(reg.engine.buckets_for(out[0]["model_id"], 1))
    try:
        reg.score_rows("alias", rows([0]))
    except KeyError as e:
        out.append(str(e))
    out.append(reg.get("alias"))
    return [_clockless(o) if isinstance(o, dict) and "breaker" in o else o
            for o in out]


def test_lifecycle_equals_reference():
    jg, cg, _ = carried("gbm")
    jl, cl_, _ = carried("glm")
    TimeLine.clear()
    got = _lifecycle(p_reg_mod.ServingRegistry(), cg, cl_, cl_.model_id)
    want = _lifecycle(j_reg_mod.ServingRegistry(), jg, jl, str(jl.key))
    assert _keys(got[0]) == _keys(want[0])
    assert got == want
    assert got[1]["version"] == 2 and got[3]["version"] == 1
    assert got[4] == [] and got[-3] == [] and got[-1] is None
    kinds = {e["what"] for e in TimeLine.snapshot() if e["kind"] == "serve"}
    assert {"deploy", "hot_swap", "rollback", "undeploy", "batch"} <= kinds


def test_deploy_refuses_what_it_cannot_serve():
    reg = p_reg_mod.ServingRegistry()

    class Unservable:
        algo, model_id, device = "nothing", "u", "cpu"
        predict_raw_array = Model.predict_raw_array
    with pytest.raises(p_reg_mod.UnsupportedModelError, match="nothing"):
        reg.deploy("u", Unservable())
    with pytest.raises(KeyError, match="no deployment named u"):
        reg.score_rows("u", rows([0]))
    with pytest.raises(KeyError):
        reg.rollback("u")


def test_undeploy_score_race_is_404_never_halfway():
    _jm, cm, _ = carried("gbm")
    reg = p_reg_mod.ServingRegistry()
    X = reg.engine.encode_rows(cm, 1, rows(range(60)))
    ref = cm.predict_raw_array(X).numpy()
    gones = []
    for attempt in range(3):
        alias = f"racy{attempt}"
        reg.deploy(alias, cm, ServingConfig(max_batch=4, max_delay_ms=1,
                                            queue_cap=512))
        oks, bad = [], []
        lock = threading.Lock()
        start = threading.Barrier(7, timeout=WAIT)

        def scorer(tid, alias=alias):
            start.wait()
            for i in range(tid, 60, 6):
                try:
                    out, ver = reg.score_rows(alias, rows([i]))
                    with lock:
                        oks.append((i, out[0], ver))
                except KeyError:
                    with lock:
                        gones.append(i)
                except Exception as e:  # noqa: BLE001 — must stay empty
                    with lock:
                        bad.append((i, repr(e)))

        threads = [threading.Thread(target=scorer, args=(t,))
                   for t in range(6)]
        for t in threads:
            t.start()
        start.wait()
        reg.undeploy(alias, drain_secs=5.0)
        for t in threads:
            t.join(WAIT)
            assert not t.is_alive()
        assert not bad, bad
        for i, p, ver in oks:
            assert ver.version == 1
            np.testing.assert_array_equal(p, ref[i])
        assert reg.get(alias) is None
        assert reg.engine.buckets_for(cm.model_id, 1) == []
        if gones:
            break
    assert gones, "undeploy never raced a score in 3 attempts"


def _canary(reg, primary, candidate):
    reg.deploy("canp", primary)
    out = [reg.set_canary("canp", candidate, fraction=0.5)["canary"]]
    seen = [reg.score_rows("canp", rows([i]))[1].version for i in range(8)]
    out.append(seen)
    out.append(reg.promote_canary("canp")["version"])
    out.append(reg.score_rows("canp", rows([0]))[1].version)
    # a canary that fails: every canary-lane request falls back to the
    # stable lane, and the windowed check rolls the canary back
    reg.set_canary("canp", primary, fraction=0.5)
    dep = reg.get("canp")
    bad = dep.canary.version
    orig = reg.engine.predict

    def boom(model, version, X):
        if version == bad:
            raise RuntimeError("canary regression (injected)")
        return orig(model, version, X)
    reg.engine.predict = boom
    versions = []
    try:
        for i in range(30):
            versions.append(reg.score_rows("canp", rows([i]))[1].version)
            if dep.canary is None:
                break
    finally:
        reg.engine.predict = orig
    out += [versions, dep.canary_rollbacks, dep.canary_fallbacks,
            {k: v for k, v in reg.describe(dep)["canary"].items()}]
    reg.undeploy("canp", drain_secs=5.0)
    return out


def test_canary_promote_and_auto_rollback_equal_reference():
    jg, cg, _ = carried("gbm")
    jd, cd, _ = carried("drf")
    TimeLine.clear()
    got = _canary(p_reg_mod.ServingRegistry(), cg, cd)
    want = _canary(j_reg_mod.ServingRegistry(), jg, jd)
    assert got == want
    assert set(got[1]) == {1, 2} and got[2] == 2 and got[3] == 2
    assert set(got[4]) == {2} and got[5] == 1 and got[6] >= 5
    events = [e for e in TimeLine.snapshot()
              if e["kind"] == "serve" and e["what"] == "canary_rollback"]
    assert any("auto-rollback" in e.get("reason", "") for e in events)


def _shadow(reg, primary, shadow, n=8):
    reg.deploy("shad", primary)
    reg.set_shadow("shad", shadow)
    dep = reg.get("shad")
    outs = [reg.score_rows("shad", rows([i]))[0] for i in range(n)]
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        with dep.lock:
            done = dep.shadow_compared + dep.shadow_errors + \
                dep.shadow_dropped
        if done >= n:
            break
        time.sleep(0.01)
    info = reg.describe(dep)["shadow"]
    reg.clear_shadow("shad")
    assert reg.get("shad").shadow is None
    reg.undeploy("shad", drain_secs=5.0)
    return outs, info


def test_shadow_same_model_no_mismatch():
    _jg, cg, _ = carried("gbm")
    outs, info = _shadow(p_reg_mod.ServingRegistry(), cg, cg)
    assert info["compared"] == 8 and info["mismatches"] == 0
    assert info["errors"] == 0 and info["dropped"] == 0
    X = p_reg_mod.ServingRegistry().engine.encode_rows(cg, 1,
                                                        rows(range(8)))
    np.testing.assert_array_equal(np.concatenate(outs),
                                  cg.predict_raw_array(X).numpy())


def test_shadow_glm_counts_as_reference():
    jg, cg, _ = carried("gbm")
    jl, cl_, _ = carried("glm")
    _, got = _shadow(p_reg_mod.ServingRegistry(), cg, cl_)
    _, want = _shadow(j_reg_mod.ServingRegistry(), jg, jl)
    got.pop("model_id")
    want.pop("model_id")
    assert got == want and got["mismatches"] > 0


def test_serves_on_the_models_device_and_never_the_host_scorer():
    """A CPU model serves on the CPU; the device predict answers every
    batch (the host scorer's counter stays 0)."""
    _jg, cg, _ = carried("gbm")
    reg = p_reg_mod.ServingRegistry()
    reg.deploy("dev", cg)
    assert str(cg.device) == "cpu"
    seen = []
    orig = type(cg).predict_raw_array

    def spy(self, X):
        seen.append((X.device.type, threading.current_thread().name))
        return orig(self, X)
    type(cg).predict_raw_array = spy
    try:
        out, _ver = reg.score_rows("dev", rows(range(4)))
    finally:
        type(cg).predict_raw_array = orig
    assert seen == [("cpu", "h2o-serve-dev")]
    assert reg.engine.stats()["fallback_batches"] == 0
    assert p_reg_mod.serving_stats()["breaker_trips"] >= 0
    reg.undeploy("dev", drain_secs=5.0)


def test_no_lock_cycle_witnessed():
    assert p_lw.enabled()
    assert p_lw.registry().find_cycles() == []
    assert p_lw.registry().held_dispatches() == []
