"""The port's replica fleet (``h2o_tpu_torch.serve.replica``) held against
``h2o_tpu.serve.replica`` on the CPU:

- the records the fleet publishes under ``serve.fleet/<alias>`` in the
  port's DKV (``store.dkv()``) equal the reference's in its
  ``cloud().dkv`` after the same deploy, canary, promote, shadow, hot
  swap, rollback and undeploy steps, apart from ``published`` (a
  clock);
- deploy converges every replica; round-robin routing spreads requests
  the same way; a replica that dies unannounced costs each request at
  most one retry and is health-gated out; ``revive`` rebuilds it from
  the records; ``kill`` of every replica gives ``NoHealthyReplica``
  with a ``retry_after_s`` — the fleet's stats equal the reference's
  along the way;
- no lock cycle is witnessed.
"""

import importlib

import numpy as np
import pytest

from h2o_tpu.core import chaos as j_chaos
from h2o_tpu.core.cloud import cloud as j_cloud

from h2o_tpu_torch.core import chaos as p_chaos
from h2o_tpu_torch.core import lockwitness as p_lw
from h2o_tpu_torch.core import store as p_store
from tests.test_torch_serve_registry import rows
from tests.test_torch_mojo import carried
from h2o_tpu_torch.core.store import unpublish_on_exit


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv

j_rep = importlib.import_module("h2o_tpu.serve.replica")
p_rep = importlib.import_module("h2o_tpu_torch.serve.replica")
j_reg = importlib.import_module("h2o_tpu.serve.registry")
p_reg = importlib.import_module("h2o_tpu_torch.serve.registry")


@pytest.fixture()
def clean():
    # chaos off in both packages: a fault injector another test module
    # left configured in this process must not shed or slow a request
    for ch in (j_chaos, p_chaos):
        ch.reset()
    for rep, reg in ((j_rep, j_reg), (p_rep, p_reg)):
        rep.reset_fleet()
        reg.registry().reset()
    yield
    for rep, reg in ((j_rep, j_reg), (p_rep, p_reg)):
        rep.reset_fleet()
        reg.registry().reset()


def _records(rep):
    return {k: {f: v for f, v in r.items() if f != "published"}
            for k, r in rep.fleet().records().items()}


def _record_steps(rep, m):
    fl = rep.fleet(2)
    steps = []
    fl.deploy("f", m["gbm"])
    steps.append(_records(rep))
    fl.set_canary("f", m["drf"], fraction=0.25)
    steps.append(_records(rep))
    fl.promote_canary("f")
    steps.append(_records(rep))
    fl.set_shadow("f", m["gbm"])
    steps.append(_records(rep))
    fl.clear_shadow("f")
    fl.deploy("f", m["glm"])
    steps.append(_records(rep))
    fl.rollback("f")
    steps.append(_records(rep))
    fl.deploy("g", m["drf"])
    steps.append(_records(rep))
    fl.undeploy("f", drain_secs=5.0)
    steps.append(_records(rep))
    steps.append([fl.converged("g"), fl.routed("f"), fl.routed("g")])
    fl.undeploy("g", drain_secs=5.0)
    steps.append(_records(rep))
    return steps


def test_records_equal_reference(clean):
    names = ("gbm", "drf", "glm")
    got = _record_steps(p_rep, {n: carried(n)[1] for n in names})
    want = _record_steps(j_rep, {n: carried(n)[0] for n in names})
    assert got == want
    assert got[0]["f"]["version"] == 1 and got[2]["f"]["version"] == 2
    assert got[3]["f"]["shadow"] == {"model_id": carried("gbm")[1].model_id}
    assert got[-2] == [True, False, True] and got[-1] == {}
    assert p_store.dkv().keys("serve.fleet/*") == []
    assert j_cloud().dkv.keys("serve.fleet/*") == []


def _failover(rep, model):
    fl = rep.fleet(3)
    # no load breaker: the counts held here are routing's, and a latency
    # or pressure reading taken under a busy host must not shed one
    reg = j_reg if rep is j_rep else p_reg
    fl.deploy("failover", model, reg.ServingConfig(breaker_enabled=False))
    out = [fl.converged("failover"), fl.routed("failover")]
    answers = []
    for i in range(12):
        o, ver = fl.score_rows("failover", rows([i]))
        answers.append(o)
        out.append(ver.version)
    out.append([r.served for r in fl.replicas])
    # an unannounced death: replica 1's batchers stop, its health bit
    # stays up; the first request routed there fails over once
    for dep in fl.replicas[1].registry._deployments.values():
        dep.batcher.stop(timeout=5.0)
    for i in range(24):
        o, _ver = fl.score_rows("failover", rows([i]))
        answers.append(o)
    st = fl.stats()
    out.append({k: st[k] for k in ("replicas", "healthy", "retries",
                                   "redistributed", "kills")})
    out.append([m["served"] for m in st["members"]])
    fl.revive(1)
    out += [fl.stats()["healthy"], fl.converged("failover")]
    answers.append(fl.score_rows("failover", rows([0]))[0])
    for rid in range(3):
        fl.kill(rid)
    try:
        fl.score_rows("failover", rows([0]))
    except rep.NoHealthyReplica as e:
        out.append(("NoHealthyReplica", str(e), e.retry_after_s))
    out.append(fl.stats()["kills"])
    return out, answers


def test_failover_equals_reference(clean):
    jm, cm, _ = carried("gbm")
    got, answers = _failover(p_rep, cm)
    want, janswers = _failover(j_rep, jm)
    assert got == want
    assert got[:2] == [True, True]
    assert got[15]["healthy"] == 2 and got[15]["redistributed"] >= 1
    assert got[15]["retries"] == got[15]["redistributed"]
    assert got[-2][0] == "NoHealthyReplica" and got[-2][2] > 0
    X = p_reg.registry().engine.encode_rows(cm, 1, rows(range(24)))
    ref = cm.predict_raw_array(X).numpy()
    idx = list(range(12)) + list(range(24)) + [0]
    for i, a in zip(idx, answers):
        np.testing.assert_array_equal(a[0], ref[i])
        np.testing.assert_allclose(a[0, 1:], janswers[idx.index(i)][0, 1:],
                                   atol=1e-6)


def test_undeploy_of_an_unknown_alias_and_the_singleton(clean):
    fl = p_rep.fleet(2)
    assert p_rep.fleet() is fl and p_rep.fleet(2) is fl
    assert len(p_rep.fleet(3).replicas) == 3
    with pytest.raises(KeyError, match="no deployment named nope"):
        p_rep.fleet().undeploy("nope")
    assert p_rep.fleet().replicas[0].registry is p_reg.registry()


def test_sync_prefers_the_store_then_the_deployed_models(clean):
    _jm, cm, _ = carried("gbm")
    # the conversion publishes the model (in this test or an earlier
    # one of this process): the fallback is held with the key absent
    p_store.dkv().remove(cm.model_id)
    fl = p_rep.fleet(2)
    fl.deploy("s", cm)
    fl.kill(1)
    assert fl._model(cm.model_id) is cm
    p_store.dkv().put(cm.model_id, cm)
    fl.revive(1)
    assert fl.converged("s") and fl.stats()["healthy"] == 2


def test_no_lock_cycle_witnessed():
    assert p_lw.enabled()
    assert p_lw.registry().find_cycles() == []
    assert p_lw.registry().held_dispatches() == []
