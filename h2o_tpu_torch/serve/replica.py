"""ReplicaFleet — N serve replicas behind one routing layer; port of
``h2o_tpu/serve/replica.py``.

Reference: H2O-3 serves predictions from EVERY node of the cloud at
once — a scoring request can land anywhere because the model lives in
the replicated DKV and each node holds the same metadata.  This module
rebuilds that property for the serving layer: N replicas (in-process
registries, the multi-controller idiom from core/store.py — every host
runs the same program, so thread-replicas here are the single-host
degenerate case of host-replicas on a pod), sharing:

- **the deployment table** through the DKV: every fleet-level
  ``deploy``/``undeploy``/canary/shadow mutation publishes an
  authoritative record under ``serve.fleet/<alias>``, so replicas
  converge on the same alias -> version bindings and a late-joining or
  revived replica rebuilds its whole registry from the records
  (:meth:`ReplicaFleet.sync`);
- **one ScoringEngine** — its bucket table and schema views are
  shared, so a new replica finds its alias's buckets already warm.

The records live in the port's process-wide DKV (``core/store.py``
:func:`dkv`; ``cloud().dkv`` in the reference).  ``sync`` reads each
record's model back from the DKV, where its training published it
(``ModelBuilder.train``, ``models/model.py``).  A model that was never
published there (built outside a job, or carried from another package)
is found among the models this fleet deployed (``_models``, by
``model_id``).

Routing is alias-level round-robin over HEALTHY replicas.  A dead
replica (killed via the :meth:`ReplicaFleet.kill` test hook, or
detected by a stopped batcher) is health-gated out and its traffic
redistributes with AT MOST ONE bounded retry on another replica — the
client never sees an error for a fleet-side death beyond that retry.
Protection errors (429 shed, 503 breaker-open, 408 deadline) propagate
unchanged: they are the fleet working as designed,
not replica failures.

Ordering contracts (the undeploy/score race):

- ``deploy`` activates the alias on every replica FIRST, then publishes
  the DKV record — a request racing the deploy sees an honest 404;
- ``undeploy`` removes the DKV record FIRST (routing stops), then
  drains each replica — a request racing the undeploy gets 404/retry,
  never a result scored against a half-removed deployment.

LOCK DISCIPLINE: ``_fleet_supervisor_lock`` only
guards membership snapshots and the round-robin cursor.  Scoring,
deploys, drains, and every other blocking call runs OUTSIDE it.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

from h2o_tpu_torch.core.diag import TimeLine
from h2o_tpu_torch.core.lockwitness import make_lock
from h2o_tpu_torch.core.log import get_logger
from h2o_tpu_torch.core.store import dkv
from h2o_tpu_torch.serve.registry import (Deployment, ServingConfig,
                                          ServingRegistry, registry)

log = get_logger("serve")

FLEET_KEY_PREFIX = "serve.fleet/"


class NoHealthyReplica(RuntimeError):
    """Every replica is health-gated out — HTTP 503 + Retry-After."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class Replica:
    """One serve replica: an id, a registry, and a health bit."""

    def __init__(self, rid: int, reg: ServingRegistry):
        self.rid = rid
        self.registry = reg
        self.healthy = True
        self.served = 0
        self.died_at: Optional[float] = None

    def describe(self) -> Dict[str, Any]:
        return {"replica": self.rid, "healthy": self.healthy,
                "served": self.served,
                "deployments": sorted(self.registry._deployments)}


class ReplicaFleet:
    """The fleet: replica 0 wraps the process-global registry (so the
    single-replica path is the registry's own), replicas 1..N-1 are
    fresh registries sharing replica 0's engine."""

    def __init__(self, n: Optional[int] = None):
        from h2o_tpu_torch import config
        n = config.serve_replicas() if n is None else max(1, int(n))
        base = registry()
        self.engine = base.engine
        self.replicas: List[Replica] = [Replica(0, base)]
        for i in range(1, n):
            self.replicas.append(
                Replica(i, ServingRegistry(engine=self.engine)))
        self._fleet_supervisor_lock = make_lock(
            "replica.ReplicaFleet._fleet_supervisor_lock")
        self._rr = 0
        self.retries = 0
        self.redistributed = 0
        self.kills = 0
        self._models: Dict[str, Any] = {}

    # -- DKV records ---------------------------------------------------------

    @staticmethod
    def _record_key(name: str) -> str:
        return f"{FLEET_KEY_PREFIX}{name}"

    def _publish(self, name: str, dep: Deployment) -> None:
        with dep.lock:
            rec = {"name": name,
                   "model_id": dep.active.model_id if dep.active else None,
                   "version": dep.active.version if dep.active else None,
                   "config": dep.config.as_dict(),
                   "canary": ({"model_id": dep.canary.model_id,
                               "fraction": dep.canary_fraction}
                              if dep.canary else None),
                   "shadow": ({"model_id": dep.shadow.model_id}
                              if dep.shadow else None),
                   "published": time.time()}
        dkv().put(self._record_key(name), rec)

    def _unpublish(self, name: str) -> None:
        dkv().remove(self._record_key(name), force=True)

    def routed(self, name: str) -> bool:
        """Does the fleet-level routing table still know the alias?"""
        return dkv().get(self._record_key(name)) is not None

    def records(self) -> Dict[str, dict]:
        store = dkv()
        out = {}
        for k in store.keys(f"{FLEET_KEY_PREFIX}*"):
            rec = store.get(k)
            if rec is not None:
                out[rec["name"]] = rec
        return out

    # -- membership ----------------------------------------------------------

    def _snapshot(self) -> List[Replica]:
        with self._fleet_supervisor_lock:
            return [r for r in self.replicas if r.healthy]

    def _pick(self, exclude: Optional[Replica] = None) -> Replica:
        with self._fleet_supervisor_lock:
            live = [r for r in self.replicas
                    if r.healthy and r is not exclude]
            if not live:
                raise NoHealthyReplica(
                    "no healthy serve replica available; retry shortly")
            self._rr += 1
            return live[self._rr % len(live)]

    def _mark_dead(self, rep: Replica, why: str) -> None:
        with self._fleet_supervisor_lock:
            if not rep.healthy:
                return
            rep.healthy = False
            rep.died_at = time.time()
        TimeLine.record("serve", "replica_dead", replica=rep.rid, why=why)
        log.warning("serve: replica %d health-gated out (%s)", rep.rid,
                    why)

    def kill(self, rid: int) -> None:
        """Test hook: simulate a replica death — health-gate it out and
        stop its batchers so in-flight work fails over."""
        rep = self.replicas[rid]
        self._mark_dead(rep, "killed")
        with self._fleet_supervisor_lock:
            self.kills += 1
        for dep in list(rep.registry._deployments.values()):
            dep.batcher.stop(timeout=1.0)
            if dep.canary_batcher is not None:
                dep.canary_batcher.stop(timeout=1.0)

    def revive(self, rid: int) -> None:
        """Bring a killed replica back: rebuild its registry from the
        fleet's DKV records (the shared engine's buckets stay warm),
        then re-admit it to routing."""
        rep = self.replicas[rid]
        self.sync(rep)
        with self._fleet_supervisor_lock:
            rep.healthy = True
            rep.died_at = None
        TimeLine.record("serve", "replica_revived", replica=rep.rid)
        log.info("serve: replica %d revived", rep.rid)

    def sync(self, rep: Replica) -> int:
        """Converge one replica onto the DKV records (late join /
        revive): drop aliases the fleet no longer routes, (re)deploy
        the rest at the published config.  Returns deploys applied."""
        recs = self.records()
        applied = 0
        for name in list(rep.registry._deployments):
            if name not in recs:
                try:
                    rep.registry.undeploy(name, drain_secs=1.0)
                except KeyError:
                    pass
        for name, rec in recs.items():
            dep = rep.registry.get(name)
            stale = (dep is None or dep.batcher.stopped
                     or dep.active is None
                     or dep.active.model_id != rec["model_id"])
            if not stale:
                continue
            if dep is not None:
                with rep.registry._lock:
                    rep.registry._deployments.pop(name, None)
                dep.batcher.stop(timeout=1.0)
            model = self._model(rec["model_id"])
            if model is None:
                log.warning("serve: sync skipped %s (model %s gone)",
                            name, rec["model_id"])
                continue
            rep.registry.deploy(name, model,
                                ServingConfig(**rec["config"]))
            applied += 1
        return applied

    def _model(self, model_id: str):
        """A record's model: the DKV's, else the one this fleet
        deployed under that id."""
        model = dkv().get(model_id)
        return self._models.get(model_id) if model is None else model

    # -- fleet-wide lifecycle ------------------------------------------------

    def _fanout(self, fn, *args, **kw) -> List[Any]:
        """Apply a registry mutation on every healthy replica."""
        out = []
        for rep in self._snapshot():
            out.append(fn(rep.registry, *args, **kw))
        return out

    def deploy(self, name: str, model,
               config: Optional[ServingConfig] = None,
               warm: bool = True) -> Dict[str, Any]:
        config = config or ServingConfig()
        results = self._fanout(
            lambda reg: reg.deploy(name, model, config, warm=warm))
        self._models[str(model.model_id)] = model
        dep = self.replicas[0].registry.get(name)
        if dep is not None:
            self._publish(name, dep)
        return results[0]

    def rollback(self, name: str) -> Dict[str, Any]:
        results = self._fanout(lambda reg: reg.rollback(name))
        dep = self.replicas[0].registry.get(name)
        if dep is not None:
            self._publish(name, dep)
        return results[0]

    def undeploy(self, name: str, drain_secs: float = 10.0) -> Dict:
        if not any(name in r.registry._deployments
                   for r in self._snapshot()):
            raise KeyError(f"no deployment named {name}")
        self._unpublish(name)       # routing stops before any drain
        results = []
        for rep in self._snapshot():
            try:
                results.append(rep.registry.undeploy(name, drain_secs))
            except KeyError:
                pass
        if not results:
            raise KeyError(f"no deployment named {name}")
        return results[0]

    def set_canary(self, name: str, model,
                   fraction: float = 0.1) -> Dict[str, Any]:
        results = self._fanout(
            lambda reg: reg.set_canary(name, model, fraction))
        self._models[str(model.model_id)] = model
        dep = self.replicas[0].registry.get(name)
        if dep is not None:
            self._publish(name, dep)
        return results[0]

    def promote_canary(self, name: str) -> Dict[str, Any]:
        results = self._fanout(lambda reg: reg.promote_canary(name))
        dep = self.replicas[0].registry.get(name)
        if dep is not None:
            self._publish(name, dep)
        return results[0]

    def clear_canary(self, name: str,
                     reason: str = "cleared") -> Dict[str, Any]:
        results = self._fanout(
            lambda reg: reg.clear_canary(name, reason))
        dep = self.replicas[0].registry.get(name)
        if dep is not None:
            self._publish(name, dep)
        return results[0]

    def set_shadow(self, name: str, model) -> Dict[str, Any]:
        results = self._fanout(lambda reg: reg.set_shadow(name, model))
        self._models[str(model.model_id)] = model
        dep = self.replicas[0].registry.get(name)
        if dep is not None:
            self._publish(name, dep)
        return results[0]

    def clear_shadow(self, name: str) -> Dict[str, Any]:
        results = self._fanout(lambda reg: reg.clear_shadow(name))
        dep = self.replicas[0].registry.get(name)
        if dep is not None:
            self._publish(name, dep)
        return results[0]

    # -- scoring -------------------------------------------------------------

    def score_rows(self, name: str, rows: Sequence[dict],
                   deadline_ms: Optional[float] = None,
                   tenant: Optional[str] = None):
        """Route one request to a healthy replica.  A replica that
        turns out to be dead (killed mid-flight) is health-gated out
        and the request retries ONCE on another replica; every other
        error propagates with its own protocol (429/503/408/404)."""
        rep = self._pick()
        try:
            out = rep.registry.score_rows(name, rows, deadline_ms,
                                          tenant=tenant)
            rep.served += 1
            return out
        except KeyError as e:
            if len(self.replicas) == 1 or not self.routed(name):
                raise               # honest 404: alias really is gone
            dep = rep.registry.get(name)
            if dep is None or dep.batcher.stopped or dep.removed:
                # the alias is still routed fleet-wide but THIS replica
                # lost it: a dead/half-removed replica, not a client
                # error — gate it out and redistribute
                self._mark_dead(rep, f"lost {name}: {e}")
            with self._fleet_supervisor_lock:
                self.redistributed += 1
                self.retries += 1
            rep2 = self._pick(exclude=rep)
            TimeLine.record("serve", "replica_retry", deployment=name,
                            from_replica=rep.rid, to_replica=rep2.rid)
            out = rep2.registry.score_rows(name, rows, deadline_ms,
                                           tenant=tenant)
            rep2.served += 1
            return out

    # -- introspection -------------------------------------------------------

    def get(self, name: str) -> Optional[Deployment]:
        for rep in self._snapshot():
            dep = rep.registry.get(name)
            if dep is not None:
                return dep
        return None

    def describe(self, name: str) -> Dict[str, Any]:
        for rep in self._snapshot():
            dep = rep.registry.get(name)
            if dep is not None:
                out = rep.registry.describe(dep)
                out["fleet"] = {"replica": rep.rid,
                                "routed": self.routed(name)}
                return out
        raise KeyError(f"no deployment named {name}")

    def list(self) -> List[Dict[str, Any]]:
        return self.replicas[0].registry.list()

    def converged(self, name: str) -> bool:
        """True when every healthy replica serves the same active
        (model_id, version) for the alias."""
        seen = set()
        for rep in self._snapshot():
            dep = rep.registry.get(name)
            if dep is None or dep.active is None:
                return False
            seen.add((dep.active.model_id, dep.active.version))
        return len(seen) == 1

    def stats(self) -> Dict[str, Any]:
        with self._fleet_supervisor_lock:
            reps = [r.describe() for r in self.replicas]
            healthy = sum(1 for r in self.replicas if r.healthy)
            out = {"replicas": len(self.replicas), "healthy": healthy,
                   "retries": self.retries,
                   "redistributed": self.redistributed,
                   "kills": self.kills}
        out["members"] = reps
        return out

    def reset(self) -> None:
        """Tear down fleet state (test teardown): undeploy everything
        everywhere, clear the routing records, revive the dead."""
        for name in list(self.records()):
            self._unpublish(name)
        for rep in self.replicas:
            rep.registry.reset()
            with self._fleet_supervisor_lock:
                rep.healthy = True
                rep.died_at = None


_fleet: Optional[ReplicaFleet] = None
_fleet_lock = make_lock("replica._fleet_lock")


def fleet(n: Optional[int] = None) -> ReplicaFleet:
    """The process fleet (sized from ``H2O_TPU_SERVE_REPLICAS`` on
    first use; pass ``n`` to force a size, rebuilding if it differs)."""
    global _fleet
    with _fleet_lock:
        current = _fleet
    if current is not None and (n is None
                                or len(current.replicas) == n):
        return current
    built = ReplicaFleet(n)
    with _fleet_lock:
        _fleet = built
    return built


def reset_fleet() -> None:
    """Drop the fleet singleton (test teardown)."""
    global _fleet
    with _fleet_lock:
        f, _fleet = _fleet, None
    if f is not None:
        f.reset()
