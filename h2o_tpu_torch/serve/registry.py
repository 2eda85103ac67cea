"""ServingRegistry — versioned model deployments behind stable aliases;
port of ``h2o_tpu/serve/registry.py``.

Reference: H2O Steam's scoring-service registry — a deployed model gets a
stable endpoint name, new versions roll out behind it, and operators can
roll back without clients noticing.  Here a *deployment* is an alias
name bound to a stack of ``(model_id, version)`` entries; the active
binding switches atomically under the deployment lock:

- ``deploy(name, model)`` — first call creates the alias at version 1;
  deploying again to the same name is a HOT SWAP (version n+1 becomes
  active; in-flight micro-batches finish on whichever version they
  started encoding against);
- ``rollback(name)`` — pop the active version, reactivate the previous
  one, and evict the popped version's bucket entries;
- ``undeploy(name)`` — mark the alias draining (new requests 404), wait
  for in-flight requests to finish, stop the batcher, evict everything.

Per-deployment stats: request/reject/deadline-expired counters and
p50/p95/p99 latency over a fixed-size ring buffer (the TimeLine-ring
idiom from core/diag.py applied to serving latency).

Each deployment is a protected, self-tuning unit:

- a :class:`~h2o_tpu_torch.serve.breaker.LoadBreaker` gates every admission
  (pre-emptive shed/trip on memory-tier pressure, queue depth, p99);
- an optional :class:`~h2o_tpu_torch.serve.batcher.AdaptiveBatchTuner`
  retunes the micro-batcher from measured load (paused while the
  breaker is anything but CLOSED — never fight the protection);
- **canary**: ``set_canary`` routes a deterministic fraction of
  requests to a candidate version on its own batcher lane; a windowed
  error-rate/p99 comparison against the primary auto-rolls the canary
  back, and a canary-lane failure falls back to the stable lane so the
  blast radius is zero client-visible errors;
- **shadow**: ``set_shadow`` mirrors scored traffic to a shadow
  version on a bounded drop-oldest queue; results are compared
  (mismatch counter) but NEVER returned.

Where the port differs:

- a version's identity is ``model.model_id`` (the reference reads
  ``model.key``, ``registry.py:153``);
- the reference asks ``monitor().check_serving()`` at admission and in
  both batch bodies (``registry.py:332-333``, ``:477-478``,
  ``:496-497``); membership comes with ROADMAP P14, and until then
  there is no mesh to re-form, so the port has no such gate;
- device work runs on the model's device: a model built without a
  device argument serves on ``cuda:0``, one built with ``device="cpu"``
  on the CPU.  The batcher's worker and the shadow thread name that
  device around each batch (:func:`_on_device`), since the current CUDA
  device is per thread; results leave the card through the engine's own
  copy.  A model with a device predict is never scored by the host
  scorer.
"""

from __future__ import annotations

import contextlib
import queue as _queue
import threading
import time
from collections import deque
from concurrent.futures import TimeoutError as _FuturesTimeout
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

import torch

from h2o_tpu_torch.core.diag import TimeLine
from h2o_tpu_torch.core.exec_store import bucket_pow2
from h2o_tpu_torch.core.lockwitness import make_lock
from h2o_tpu_torch.core.log import get_logger
from h2o_tpu_torch.core.resilience import Deadline
from h2o_tpu_torch.serve.batcher import (AdaptiveBatchTuner,
                                         BatcherStopped, MicroBatcher,
                                         QueueFull)
from h2o_tpu_torch.serve.breaker import BreakerOpen, LoadBreaker, ShedLoad
from h2o_tpu_torch.serve.engine import ScoringEngine

log = get_logger("serve")

LATENCY_RING = 1024


def _on_device(model):
    """Context that makes the model's CUDA device current on this
    thread (a no-op for a CPU model)."""
    dev = torch.device(getattr(model, "device", "cpu"))
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class UnsupportedModelError(ValueError):
    """Model type has neither a device predict nor a numpy scorer."""


class ServingConfig:
    """Per-deployment tuning (REST params of POST /3/Serving)."""

    def __init__(self, max_batch: int = 32, max_delay_ms: float = 2.0,
                 queue_cap: int = 64, deadline_ms: float = 0.0,
                 adaptive: Optional[bool] = None, p99_slo_ms: float = 0.0,
                 breaker_enabled: bool = True):
        from h2o_tpu_torch import config as _cfg
        self.max_batch = int(max_batch)
        self.max_delay_ms = float(max_delay_ms)
        self.queue_cap = int(queue_cap)
        self.deadline_ms = float(deadline_ms)   # 0 = unbounded
        self.adaptive = (_cfg.serve_adaptive_default() if adaptive is None
                         else bool(adaptive))
        self.p99_slo_ms = float(p99_slo_ms)     # 0 = no latency signal
        self.breaker_enabled = bool(breaker_enabled)

    def as_dict(self) -> Dict[str, Any]:
        return {"max_batch": self.max_batch,
                "max_delay_ms": self.max_delay_ms,
                "queue_cap": self.queue_cap,
                "deadline_ms": self.deadline_ms,
                "adaptive": self.adaptive,
                "p99_slo_ms": self.p99_slo_ms,
                "breaker_enabled": self.breaker_enabled}


class DeploymentStats:
    def __init__(self):
        self.lock = make_lock("registry.DeploymentStats.lock")
        self.requests = 0
        self.rejected = 0
        self.expired = 0
        self.errors = 0
        self.batches = 0
        self.rows_scored = 0
        self.max_observed_batch = 0
        self.latency_ms: deque = deque(maxlen=LATENCY_RING)
        self._p99 = 0.0
        self._p99_at = 0.0

    def record_batch(self, n_requests: int, n_rows: int) -> None:
        with self.lock:
            self.batches += 1
            self.rows_scored += n_rows
            self.max_observed_batch = max(self.max_observed_batch, n_rows)

    def p99_ms(self) -> float:
        """Cheap cached p99 for the breaker's admission-path sampling
        (recomputed at most every 100ms — never a per-request
        percentile over the full ring)."""
        now = time.monotonic()
        with self.lock:
            if now - self._p99_at < 0.1:
                return self._p99
            lat = list(self.latency_ms)
        p = float(np.percentile(lat, 99)) if lat else 0.0
        with self.lock:
            self._p99, self._p99_at = p, now
        return p

    def snapshot(self) -> Dict[str, Any]:
        with self.lock:
            lat = list(self.latency_ms)
            out = {"request_count": self.requests,
                   "reject_count": self.rejected,
                   "deadline_expired_count": self.expired,
                   "error_count": self.errors,
                   "batch_count": self.batches,
                   "rows_scored": self.rows_scored,
                   "max_observed_batch": self.max_observed_batch}
        if lat:
            p50, p95, p99 = np.percentile(lat, [50, 95, 99])
            out.update(p50_ms=float(p50), p95_ms=float(p95),
                       p99_ms=float(p99))
        else:
            out.update(p50_ms=0.0, p95_ms=0.0, p99_ms=0.0)
        return out


class DeploymentVersion:
    __slots__ = ("version", "model_id", "model")

    def __init__(self, version: int, model):
        self.version = version
        self.model_id = str(model.model_id)
        self.model = model


class Deployment:
    def __init__(self, name: str, config: ServingConfig,
                 batcher: MicroBatcher):
        self.name = name
        self.config = config
        self.batcher = batcher
        self.lock = make_lock("registry.Deployment.lock")
        self.versions: List[DeploymentVersion] = []
        self.active: Optional[DeploymentVersion] = None
        self.draining = False
        self.removed = False        # set before eviction: no straggler
        self.stats = DeploymentStats()
        self.created = time.time()
        self.breaker: Optional[LoadBreaker] = None
        self.tuner: Optional[AdaptiveBatchTuner] = None
        # canary lane (candidate version on its own batcher)
        self.canary: Optional[DeploymentVersion] = None
        self.canary_batcher: Optional[MicroBatcher] = None
        self.canary_fraction = 0.0
        self.canary_stats = DeploymentStats()
        self.canary_rollbacks = 0
        self.canary_fallbacks = 0
        self._route_counter = 0
        # shadow lane (mirrored, compared, never returned)
        self.shadow: Optional[DeploymentVersion] = None
        self._shadow_q: Optional["_queue.Queue"] = None
        self._shadow_thread: Optional[threading.Thread] = None
        self.shadow_compared = 0
        self.shadow_mismatches = 0
        self.shadow_errors = 0
        self.shadow_dropped = 0


class ServingRegistry:
    """Process-wide deployment table (the /3/Serving backing store)."""

    def __init__(self, engine: Optional[ScoringEngine] = None):
        self.engine = engine or ScoringEngine()
        self._lock = make_lock("registry.ServingRegistry._lock")
        self._deployments: Dict[str, Deployment] = {}

    # -- lifecycle -----------------------------------------------------------

    def deploy(self, name: str, model,
               config: Optional[ServingConfig] = None,
               warm: bool = True) -> Dict[str, Any]:
        """Create or hot-swap the alias ``name`` to ``model``.  The cache
        is warmed (bucket 1 + the max-batch bucket) BEFORE the atomic
        alias switch, so a swap never exposes a cold version."""
        if not self.engine.supports(model):
            raise UnsupportedModelError(
                f"model type '{model.algo}' is not servable: no device "
                "predict_raw_array and no standalone MOJO scorer")
        config = config or ServingConfig()
        with self._lock:
            dep = self._deployments.get(name)
            if dep is None:
                dep = Deployment(name, config, batcher=None)
                dep.batcher = MicroBatcher(
                    score_fn=lambda rows, _d=dep: self._score_batch(
                        _d, rows),
                    max_batch=config.max_batch,
                    max_delay_ms=config.max_delay_ms,
                    queue_cap=config.queue_cap, name=name,
                    on_batch=lambda k, n, _d=dep: self._on_batch(_d, k, n))
                dep.breaker = LoadBreaker(
                    name, p99_slo_ms=config.p99_slo_ms,
                    on_shrink=lambda _d=dep: self._shrink_batch(_d),
                    on_restore=lambda _d=dep: self._restore_batch(_d))
                self._deployments[name] = dep
            elif dep.draining:
                raise RuntimeError(f"deployment {name} is draining")
        with dep.lock:
            version = (dep.versions[-1].version + 1) if dep.versions else 1
        ver = DeploymentVersion(version, model)
        if warm:
            self.engine.warm(model, version,
                             batch_sizes=(1, config.max_batch))
        with dep.lock:
            dep.config = config
            dep.batcher.configure(config.max_batch, config.max_delay_ms,
                                  config.queue_cap)
            dep.breaker.p99_slo_ms = config.p99_slo_ms
            if config.adaptive and dep.tuner is None:
                dep.tuner = AdaptiveBatchTuner(dep.batcher)
            elif not config.adaptive:
                dep.tuner = None
            dep.versions.append(ver)
            swapped = dep.active is not None
            dep.active = ver
        TimeLine.record("serve", "hot_swap" if swapped else "deploy",
                        deployment=name, model=ver.model_id,
                        version=version)
        log.info("serve: %s %s -> %s v%d",
                 "hot-swapped" if swapped else "deployed", name,
                 ver.model_id, version)
        return self.describe(dep)

    def rollback(self, name: str) -> Dict[str, Any]:
        dep = self._get(name)
        with dep.lock:
            if len(dep.versions) < 2:
                raise ValueError(
                    f"deployment {name} has no previous version to "
                    "roll back to")
            dropped = dep.versions.pop()
            dep.active = dep.versions[-1]
            active = dep.active
        self.engine.evict(dropped.model_id, dropped.version)
        TimeLine.record("serve", "rollback", deployment=name,
                        from_version=dropped.version,
                        to_version=active.version)
        log.info("serve: rolled back %s v%d -> v%d", name,
                 dropped.version, active.version)
        return self.describe(dep)

    def undeploy(self, name: str, drain_secs: float = 10.0) -> Dict:
        """Drain in-flight requests, then remove the alias.

        Ordering is the undeploy/score race fix: ``draining`` turns new
        admissions into 404 immediately; the table entry is popped and
        ``removed`` is set BEFORE any version is evicted, so a straggler
        batch that slipped past the admission gate fails its requests
        with 404 in ``_score_batch`` rather than ever scoring against a
        half-removed deployment."""
        dep = self._get(name)
        with dep.lock:
            dep.draining = True
        deadline = Deadline(drain_secs)
        while dep.batcher.pending > 0 and not deadline.expired:
            time.sleep(0.005)
        drained = dep.batcher.pending == 0
        dep.batcher.stop()
        if dep.canary_batcher is not None:
            dep.canary_batcher.stop()
        if dep._shadow_q is not None:
            dep._shadow_q.put(None)     # shadow worker exit sentinel
        with self._lock:
            self._deployments.pop(name, None)
        with dep.lock:
            dep.removed = True
        for ver in dep.versions:
            self.engine.evict(ver.model_id, ver.version)
        if dep.canary is not None:
            self.engine.evict(dep.canary.model_id, dep.canary.version)
        if dep.shadow is not None:
            self.engine.evict(dep.shadow.model_id, dep.shadow.version)
        TimeLine.record("serve", "undeploy", deployment=name,
                        drained=drained)
        log.info("serve: undeployed %s (drained=%s)", name, drained)
        return {"name": name, "drained": drained,
                "stats": dep.stats.snapshot()}

    def reset(self) -> None:
        """Undeploy everything (test teardown)."""
        for name in list(self._deployments):
            try:
                self.undeploy(name, drain_secs=1.0)
            except KeyError:
                pass

    # -- scoring -------------------------------------------------------------

    def score_rows(self, name: str, rows: Sequence[dict],
                   deadline_ms: Optional[float] = None,
                   tenant: Optional[str] = None):
        """Encode+score ``rows`` through the deployment's micro-batcher.

        Raises ``KeyError`` (unknown/draining alias), :class:`QueueFull`
        or :class:`ShedLoad` (shed — HTTP 429 + Retry-After),
        :class:`BreakerOpen` (HTTP 503 + Retry-After while the breaker
        is open) and ``TimeoutError`` (per-request deadline)."""
        dep = self._get(name)
        if dep.draining:
            raise KeyError(f"deployment {name} is draining")
        if dep.active is None:
            # first-deploy window: the alias row exists (the batcher is
            # being wired) but no version has been activated yet — a
            # request here must 404 like an unknown alias, not reach the
            # scorer and 500 on a None version
            raise KeyError(f"deployment {name} has no active version yet")
        st = dep.stats
        with st.lock:
            st.requests += 1
        if dep.breaker is not None and dep.config.breaker_enabled:
            p99 = (st.p99_ms() if dep.breaker.p99_slo_ms > 0 else 0.0)
            try:
                dep.breaker.admit(dep.batcher.pending,
                                  dep.batcher.queue_cap, p99,
                                  tenant=tenant)
            except (ShedLoad, BreakerOpen):
                with st.lock:
                    st.rejected += 1
                TimeLine.record("serve", "breaker_reject",
                                deployment=name)
                raise
        if deadline_ms is None:
            deadline_ms = dep.config.deadline_ms
        dl = Deadline(deadline_ms / 1000.0) if deadline_ms else Deadline(0)
        # deterministic canary routing: every k-th request takes the
        # candidate lane (a whole batch is one version, so the lanes
        # are separate batchers rather than per-request version mixes)
        lane = dep.batcher
        canary = None
        if dep.canary is not None and dep.canary_fraction > 0:
            with dep.lock:
                canary = dep.canary
                if canary is not None:
                    dep._route_counter += 1
                    k = max(1, int(round(1.0 / dep.canary_fraction)))
                    if dep._route_counter % k == 0:
                        lane = dep.canary_batcher
        on_canary = lane is not dep.batcher
        lane_stats = dep.canary_stats if on_canary else st
        if on_canary:
            with lane_stats.lock:
                lane_stats.requests += 1
        t0 = time.monotonic()
        try:
            fut = lane.submit(rows, deadline=dl)
        except QueueFull:
            if on_canary:
                # canary lane over capacity: fall back to the stable
                # lane rather than shedding a request the primary could
                # have served
                return self._primary_fallback(dep, name, rows, dl,
                                              deadline_ms, t0)
            with st.lock:
                st.rejected += 1
            TimeLine.record("serve", "shed", deployment=name)
            raise
        except BatcherStopped:
            raise KeyError(f"deployment {name} was undeployed")
        timeout = dl.remaining()
        try:
            raw = fut.result(timeout=None if timeout == float("inf")
                             else timeout)
        except (TimeoutError, _FuturesTimeout):
            # worker-side expiry or wait timeout — same contract (408)
            with lane_stats.lock:
                lane_stats.expired += 1
            if dep.breaker is not None:
                dep.breaker.note_result(False)
            if on_canary:
                self._note_canary(dep)
            raise TimeoutError(
                f"scoring request on {name} exceeded its "
                f"{deadline_ms:g}ms deadline")
        except BatcherStopped:
            raise KeyError(f"deployment {name} was undeployed")
        except Exception:
            with lane_stats.lock:
                lane_stats.errors += 1
            if dep.breaker is not None:
                dep.breaker.note_result(False)
            if on_canary:
                # candidate version misbehaving: count it against the
                # canary and serve the client from the stable lane
                self._note_canary(dep)
                with dep.lock:
                    dep.canary_fallbacks += 1
                return self._primary_fallback(dep, name, rows, dl,
                                              deadline_ms, t0)
            raise
        with lane_stats.lock:
            lane_stats.latency_ms.append((time.monotonic() - t0) * 1000.0)
        if dep.breaker is not None:
            dep.breaker.note_result(True)
        if on_canary:
            self._note_canary(dep)
        ver = canary if on_canary else dep.active
        out = np.asarray(raw)
        if not on_canary:
            self._mirror_shadow(dep, rows, out)
        return out, ver

    def _primary_fallback(self, dep: Deployment, name: str,
                          rows: Sequence[dict], dl: Deadline,
                          deadline_ms: float, t0: float):
        """Stable-lane fallback for a failed/overfull canary request."""
        st = dep.stats
        try:
            fut = dep.batcher.submit(rows, deadline=dl)
        except QueueFull:
            with st.lock:
                st.rejected += 1
            TimeLine.record("serve", "shed", deployment=name)
            raise
        except BatcherStopped:
            raise KeyError(f"deployment {name} was undeployed")
        timeout = dl.remaining()
        try:
            raw = fut.result(timeout=None if timeout == float("inf")
                             else timeout)
        except (TimeoutError, _FuturesTimeout):
            with st.lock:
                st.expired += 1
            raise TimeoutError(
                f"scoring request on {name} exceeded its "
                f"{deadline_ms:g}ms deadline")
        except BatcherStopped:
            raise KeyError(f"deployment {name} was undeployed")
        with st.lock:
            st.latency_ms.append((time.monotonic() - t0) * 1000.0)
        out = np.asarray(raw)
        self._mirror_shadow(dep, rows, out)
        return out, dep.active

    def _score_batch(self, dep: Deployment, rows: List[dict]):
        """Batch body run on the worker thread: resolve the ACTIVE
        version once, encode every request's rows against it, one device
        dispatch."""
        if dep.removed:
            # the undeploy/score race, closed: the deployment's entry is
            # gone and its versions are being (or have been) evicted — a
            # straggler batch must 404 its requests, never hand back a
            # result scored against a half-removed deployment
            raise KeyError(f"deployment {dep.name} was undeployed")
        ver = dep.active
        if ver is None:
            # belt-and-braces for the same first-deploy window: a batch
            # admitted just before the None-active check landed
            raise KeyError(
                f"deployment {dep.name} has no active version yet")
        X = self.engine.encode_rows(ver.model, ver.version, rows)
        with _on_device(ver.model):
            return self.engine.predict(ver.model, ver.version, X)

    def _score_canary_batch(self, dep: Deployment, rows: List[dict]):
        """Canary-lane batch body: score against the CANDIDATE."""
        if dep.removed:
            raise KeyError(f"deployment {dep.name} was undeployed")
        ver = dep.canary
        if ver is None:
            raise KeyError(
                f"deployment {dep.name} has no canary version")
        X = self.engine.encode_rows(ver.model, ver.version, rows)
        with _on_device(ver.model):
            return self.engine.predict(ver.model, ver.version, X)

    def _on_batch(self, dep: Deployment, n_requests: int,
                  n_rows: int) -> None:
        dep.stats.record_batch(n_requests, n_rows)
        # adaptive retune from measured load — paused unless the
        # breaker is CLOSED (never regrow batches under pressure)
        if dep.tuner is not None and (
                dep.breaker is None or dep.breaker.state == "closed"):
            dep.tuner.observe(dep.batcher.pending, n_rows)
        TimeLine.record("serve", "batch", deployment=dep.name,
                        requests=n_requests, rows=n_rows)

    def _shrink_batch(self, dep: Deployment) -> None:
        """Breaker SHEDDING entry: halve the batch quantum (pow2, floor
        1) — smaller dispatches mean smaller transient HBM while the
        pressure lasts."""
        cur = bucket_pow2(max(1, dep.batcher.max_batch))
        new = max(1, cur // 2)
        dep.batcher.configure(max_batch=new)
        TimeLine.record("serve", "batch_shrink", deployment=dep.name,
                        max_batch=new)
        log.warning("serve: %s under pressure, batch quantum %d -> %d",
                    dep.name, cur, new)

    def _restore_batch(self, dep: Deployment) -> None:
        """Breaker re-close: restore the configured knobs (the adaptive
        tuner takes it from there if enabled)."""
        dep.batcher.configure(max_batch=dep.config.max_batch,
                              max_delay_ms=dep.config.max_delay_ms)
        TimeLine.record("serve", "batch_restore", deployment=dep.name,
                        max_batch=dep.config.max_batch)

    # -- canary / shadow -----------------------------------------------------

    def set_canary(self, name: str, model,
                   fraction: float = 0.1) -> Dict[str, Any]:
        """Stage ``model`` as the canary for alias ``name``: a
        deterministic ``fraction`` of requests scores on the candidate
        lane; a windowed regression check auto-rolls it back."""
        if not self.engine.supports(model):
            raise UnsupportedModelError(
                f"model type '{model.algo}' is not servable: no device "
                "predict_raw_array and no standalone MOJO scorer")
        fraction = min(0.5, max(0.0, float(fraction)))
        dep = self._get(name)
        if dep.draining:
            raise KeyError(f"deployment {name} is draining")
        with dep.lock:
            if dep.canary is not None:
                raise ValueError(
                    f"deployment {name} already has a canary "
                    f"(v{dep.canary.version}); promote or clear it first")
            version = (dep.versions[-1].version + 1) if dep.versions else 1
        ver = DeploymentVersion(version, model)
        self.engine.warm(model, version,
                         batch_sizes=(1, dep.config.max_batch))
        with dep.lock:
            if dep.canary_batcher is None:
                dep.canary_batcher = MicroBatcher(
                    score_fn=lambda rows, _d=dep: self._score_canary_batch(
                        _d, rows),
                    max_batch=dep.config.max_batch,
                    max_delay_ms=dep.config.max_delay_ms,
                    queue_cap=max(2, dep.config.queue_cap // 4),
                    name=f"{name}#canary")
            dep.canary = ver
            dep.canary_fraction = fraction
            dep.canary_stats = DeploymentStats()
            dep._route_counter = 0
        TimeLine.record("serve", "canary_start", deployment=name,
                        model=ver.model_id, version=version,
                        fraction=fraction)
        log.info("serve: canary on %s -> %s v%d at %.0f%%", name,
                 ver.model_id, version, fraction * 100)
        return self.describe(dep)

    def promote_canary(self, name: str) -> Dict[str, Any]:
        """Make the canary the active version (hot swap semantics)."""
        dep = self._get(name)
        with dep.lock:
            ver = dep.canary
            if ver is None:
                raise ValueError(f"deployment {name} has no canary")
            dep.canary = None
            dep.canary_fraction = 0.0
            dep.versions.append(ver)
            dep.active = ver
        TimeLine.record("serve", "canary_promote", deployment=name,
                        version=ver.version)
        log.info("serve: promoted canary on %s -> v%d", name, ver.version)
        return self.describe(dep)

    def clear_canary(self, name: str,
                     reason: str = "cleared") -> Dict[str, Any]:
        """Drop the canary (manual clear or auto-rollback): routing
        stops first, then the candidate's programs are evicted."""
        dep = self._get(name)
        with dep.lock:
            ver = dep.canary
            dep.canary = None
            dep.canary_fraction = 0.0
        if ver is not None:
            self.engine.evict(ver.model_id, ver.version)
            TimeLine.record("serve", "canary_rollback", deployment=name,
                            version=ver.version, reason=reason)
            log.warning("serve: canary on %s rolled back (v%d): %s",
                        name, ver.version, reason)
        return self.describe(dep)

    def _note_canary(self, dep: Deployment) -> None:
        """Windowed canary-vs-primary regression check, run after every
        canary-lane outcome (the caller has already recorded the
        outcome in ``canary_stats``): an error rate more than 10 points
        over the primary's, or a p99 beyond 2x the primary's,
        auto-rolls back."""
        cs = dep.canary_stats
        with cs.lock:
            creq = cs.requests
            cerr = cs.errors + cs.expired
        if creq < 5:
            return
        st = dep.stats
        with st.lock:
            preq = max(1, st.requests)
            perr = st.errors + st.expired
        c_rate = cerr / creq
        p_rate = perr / preq
        regression = None
        if c_rate > p_rate + 0.10:
            regression = (f"error rate {c_rate:.0%} vs primary "
                          f"{p_rate:.0%}")
        elif creq >= 20:
            c99, p99 = cs.p99_ms(), st.p99_ms()
            if p99 > 0 and c99 > 2.0 * p99:
                regression = (f"p99 {c99:.1f}ms vs primary "
                              f"{p99:.1f}ms")
        if regression is None:
            return
        with dep.lock:
            if dep.canary is None:      # another thread rolled it back
                return
            dep.canary_rollbacks += 1
        self.clear_canary(dep.name, reason=f"auto-rollback: {regression}")

    def set_shadow(self, name: str, model) -> Dict[str, Any]:
        """Mirror scored traffic to ``model`` on a bounded drop-oldest
        queue; predictions are compared against the primary's (mismatch
        counter on describe()) and NEVER returned to a client."""
        if not self.engine.supports(model):
            raise UnsupportedModelError(
                f"model type '{model.algo}' is not servable: no device "
                "predict_raw_array and no standalone MOJO scorer")
        dep = self._get(name)
        if dep.draining:
            raise KeyError(f"deployment {name} is draining")
        with dep.lock:
            version = (dep.versions[-1].version + 1) if dep.versions else 1
        ver = DeploymentVersion(version, model)
        self.engine.warm(model, version,
                         batch_sizes=(1, dep.config.max_batch))
        with dep.lock:
            dep.shadow = ver
            dep.shadow_compared = 0
            dep.shadow_mismatches = 0
            dep.shadow_errors = 0
            dep.shadow_dropped = 0
            if dep._shadow_q is None:
                dep._shadow_q = _queue.Queue(maxsize=64)
                dep._shadow_thread = threading.Thread(
                    target=self._shadow_loop, args=(dep,), daemon=True,
                    name=f"h2o-shadow-{name}")
                dep._shadow_thread.start()
        TimeLine.record("serve", "shadow_start", deployment=name,
                        model=ver.model_id, version=version)
        log.info("serve: shadowing %s with %s v%d", name, ver.model_id,
                 version)
        return self.describe(dep)

    def clear_shadow(self, name: str) -> Dict[str, Any]:
        dep = self._get(name)
        with dep.lock:
            ver = dep.shadow
            dep.shadow = None
        if ver is not None:
            self.engine.evict(ver.model_id, ver.version)
            TimeLine.record("serve", "shadow_stop", deployment=name,
                            version=ver.version)
        return self.describe(dep)

    def _mirror_shadow(self, dep: Deployment, rows: Sequence[dict],
                       primary: np.ndarray) -> None:
        """Primary-path mirror: enqueue-or-drop, never block scoring."""
        if dep.shadow is None or dep._shadow_q is None:
            return
        item = (list(rows), primary)
        try:
            dep._shadow_q.put_nowait(item)
        except _queue.Full:
            with dep.lock:
                dep.shadow_dropped += 1
            try:
                dep._shadow_q.get_nowait()      # drop-oldest
            except _queue.Empty:
                pass
            try:
                dep._shadow_q.put_nowait(item)
            except _queue.Full:
                pass

    def _shadow_loop(self, dep: Deployment) -> None:
        """Shadow worker: score mirrored rows on the shadow version and
        compare — results stay in the counters, never in a response."""
        while True:
            item = dep._shadow_q.get()
            if item is None:
                return
            ver = dep.shadow
            if ver is None or dep.removed:
                continue
            rows, primary = item
            try:
                X = self.engine.encode_rows(ver.model, ver.version, rows)
                with _on_device(ver.model):
                    out = np.asarray(
                        self.engine.predict(ver.model, ver.version, X))
                match = (out.shape == primary.shape and np.allclose(
                    out, primary, rtol=1e-3, atol=1e-5, equal_nan=True))
                with dep.lock:
                    dep.shadow_compared += 1
                    if not match:
                        dep.shadow_mismatches += 1
            except Exception as e:  # noqa: BLE001 — shadow never hurts
                with dep.lock:
                    dep.shadow_errors += 1
                log.debug("serve: shadow scoring on %s failed: %s",
                          dep.name, e)

    # -- introspection -------------------------------------------------------

    def _get(self, name: str) -> Deployment:
        dep = self._deployments.get(name)
        if dep is None:
            raise KeyError(f"no deployment named {name}")
        return dep

    def get(self, name: str) -> Optional[Deployment]:
        return self._deployments.get(name)

    def response_domain(self, dep: Deployment,
                        ver: DeploymentVersion) -> Optional[List[str]]:
        return self.engine.view(ver.model, ver.version).response_domain

    def describe(self, dep: Deployment) -> Dict[str, Any]:
        with dep.lock:
            active = dep.active
            versions = [{"version": v.version, "model_id": v.model_id,
                         "active": v is active} for v in dep.versions]
        return {
            "name": dep.name,
            "model_id": active.model_id if active else None,
            "version": active.version if active else None,
            "algo": active.model.algo if active else None,
            "status": "draining" if dep.draining else "active",
            "device_predict": self.engine.has_device_predict(
                active.model) if active else False,
            "compiled_buckets": self.engine.buckets_for(
                active.model_id, active.version) if active else [],
            "versions": versions,
            "config": dep.config.as_dict(),
            "queue_depth": dep.batcher.pending,
            "stats": dep.stats.snapshot(),
            "breaker": dep.breaker.stats() if dep.breaker else None,
            "adaptive": (dep.tuner.stats() if dep.tuner
                         else {"enabled": False}),
            "canary": self._describe_canary(dep),
            "shadow": self._describe_shadow(dep),
        }

    def _describe_canary(self, dep: Deployment) -> Dict[str, Any]:
        with dep.lock:
            ver = dep.canary
            out = {"rollbacks": dep.canary_rollbacks,
                   "fallbacks": dep.canary_fallbacks}
        if ver is not None:
            out.update(model_id=ver.model_id, version=ver.version,
                       fraction=dep.canary_fraction,
                       stats=dep.canary_stats.snapshot())
        return out

    def _describe_shadow(self, dep: Deployment) -> Dict[str, Any]:
        with dep.lock:
            ver = dep.shadow
            out = {"compared": dep.shadow_compared,
                   "mismatches": dep.shadow_mismatches,
                   "errors": dep.shadow_errors,
                   "dropped": dep.shadow_dropped}
        if ver is not None:
            out.update(model_id=ver.model_id, version=ver.version)
        return out

    def list(self) -> List[Dict[str, Any]]:
        with self._lock:
            deps = list(self._deployments.values())
        return [self.describe(d) for d in deps]


_instance: Optional[ServingRegistry] = None
_instance_lock = make_lock("registry._instance_lock")


def registry() -> ServingRegistry:
    global _instance
    if _instance is None:
        with _instance_lock:
            if _instance is None:
                _instance = ServingRegistry()
    return _instance


def serving_stats() -> Dict[str, Any]:
    """The ``serving`` block of the reference's ``GET /3/Resilience``
    (the REST layer is ROADMAP P13): process-wide
    breaker totals plus per-deployment protection state (cheap — no
    device work).  Safe to call before any deployment exists."""
    from h2o_tpu_torch.serve import breaker as _breaker
    out: Dict[str, Any] = dict(_breaker.totals())
    deployments: Dict[str, Any] = {}
    canary_rollbacks = 0
    shadow_mismatches = 0
    reg = _instance
    if reg is not None:
        with reg._lock:
            deps = list(reg._deployments.values())
        for dep in deps:
            canary_rollbacks += dep.canary_rollbacks
            shadow_mismatches += dep.shadow_mismatches
            deployments[dep.name] = {
                "breaker_state": (dep.breaker.state if dep.breaker
                                  else None),
                "breaker_trips": (dep.breaker.trips if dep.breaker
                                  else 0),
                "queue_depth": dep.batcher.pending,
            }
    out.update(canary_rollbacks=canary_rollbacks,
               shadow_mismatches=shadow_mismatches,
               deployments=deployments)
    return out
