"""LoadBreaker — a pre-emptive, self-resetting serving circuit breaker;
port of ``h2o_tpu/serve/breaker.py``.

Reference: the cluster-side scoring path simply dies when a node OOMs
mid-BigScore (Model.java:2189 runs on every node's heap at once); the
classic serving answer (Netflix Hystrix / Envoy's admission control +
Polly's circuit breaker) is to refuse work BEFORE the resource wall,
not after.  This breaker is that answer wired to the telemetry this
engine actually has:

- **memory** — ``MemoryManager.pressure()`` (core/memory.py): device
  residency as a fraction of the tier budget, plus demand-page stalls
  and page in/out deltas between samples.  The port has no tiered store
  yet (ROADMAP P14): its manager gives the reference's reading at the
  default budget of 0 (``hbm_frac`` 0.0, no paging), so this signal is
  quiet and the queue, latency and chaos signals drive the protocol;
- **queue** — the micro-batcher's admission depth as a fraction of its
  cap (a queue holding multiple full batches means latency is already
  compounding);
- **latency** — the deployment's observed p99 against an optional SLO.

The state machine (hysteresis on every edge):

    CLOSED --score>=soft--> SHEDDING --score>=hard--> OPEN
      ^                        |                        |
      |                        v (score low for          v (cooldown)
      +------ exit_ok ---- CLOSED                   HALF_OPEN
                                                    |      |
                                probes ok + calm -> CLOSED |
                                probe fails / still hot -> OPEN

- **CLOSED**: everything admits.  Crossing the SOFT threshold enters
  SHEDDING and fires ``on_shrink`` (the registry halves the batcher's
  batch quantum — smaller dispatches, smaller transient HBM).
- **SHEDDING**: a deterministic fraction of requests (proportional to
  how far past soft the score sits) is refused with :class:`ShedLoad`
  — HTTP 429 + ``Retry-After``.  Crossing HARD trips OPEN.
- **OPEN**: every request is refused with :class:`BreakerOpen` —
  HTTP 503 + ``Retry-After`` carrying the remaining cooldown.  The trip
  happened BEFORE a RESOURCE_EXHAUSTED could reach the OOM ladder's
  terminal rung: that ordering is the drill's invariant.
- **HALF_OPEN**: after the cooldown, up to ``probe_n`` live requests
  are admitted as probes; their outcomes arrive via
  :meth:`note_result`.  All probes succeeding while the score sits
  below the EXIT threshold (soft minus the hysteresis margin) closes
  the breaker and fires ``on_restore``; any failure or a still-hot
  score re-trips OPEN with a fresh cooldown.

The chaos injector ``H2O_TPU_CHAOS_SERVE_PRESSURE`` (core/chaos.py)
biases a telemetry sample to critical, so tests drive the full protocol
without a real memory squeeze.

Tenants: :meth:`LoadBreaker._weight_share` returns 1.0, the reference's
answer whenever no tenant is registered (``h2o_tpu/serve/breaker.py:315-329``); the
port has no tenant registry until ROADMAP P14, so no tenant ever looks
noisy, and the per-tenant window only counts.

LOCK DISCIPLINE: ``_breaker_lock`` only ever guards state
transitions and counter publishes.  Telemetry sampling (which takes the
memory-manager lock) and the shrink/restore callbacks (which take
batcher locks) run OUTSIDE it — a breaker consulted on every admission
must never hold its lock across anything that can block.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

from h2o_tpu_torch.core.chaos import chaos
from h2o_tpu_torch.core.diag import TimeLine
from h2o_tpu_torch.core.lockwitness import make_lock
from h2o_tpu_torch.core.log import get_logger
from h2o_tpu_torch.core.memory import manager

log = get_logger("serve")

CLOSED = "closed"
SHEDDING = "shedding"
OPEN = "open"
HALF_OPEN = "half_open"

_EVENT_RING = 64
_TENANT_WINDOW = 256


class ShedLoad(RuntimeError):
    """Pre-emptively shed under pressure — HTTP 429 + ``Retry-After``."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class BreakerOpen(RuntimeError):
    """Breaker tripped open — HTTP 503 + ``Retry-After`` (remaining
    cooldown).  Deliberately NOT an OOMError: a tripped breaker is the
    protection *working*, not a device failure."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


# process-wide totals (the /3/Resilience "serving" block) — every
# LoadBreaker instance publishes into these under _totals_lock
_totals_lock = make_lock("breaker._totals_lock")
_totals = {"breaker_trips": 0, "breaker_sheds": 0,
           "breaker_half_opens": 0, "breaker_closes": 0}


def totals() -> Dict[str, int]:
    with _totals_lock:
        return dict(_totals)


def reset_totals() -> None:
    with _totals_lock:
        for k in _totals:
            _totals[k] = 0


def _bump(key: str, n: int = 1) -> None:
    with _totals_lock:
        _totals[key] += n


class LoadBreaker:
    """Per-deployment breaker (one per alias per replica)."""

    def __init__(self, name: str,
                 soft: Optional[float] = None,
                 hard: Optional[float] = None,
                 open_secs: Optional[float] = None,
                 probe_n: Optional[int] = None,
                 interval_ms: Optional[float] = None,
                 stall_soft: Optional[float] = None,
                 p99_slo_ms: float = 0.0,
                 on_shrink: Optional[Callable[[], None]] = None,
                 on_restore: Optional[Callable[[], None]] = None):
        from h2o_tpu_torch import config
        self.name = name
        self.soft = config.breaker_soft() if soft is None else float(soft)
        self.hard = config.breaker_hard() if hard is None else float(hard)
        self.open_secs = (config.breaker_open_secs() if open_secs is None
                          else float(open_secs))
        self.probe_n = (config.breaker_probes() if probe_n is None
                        else int(probe_n))
        self.interval_s = (config.breaker_interval_ms() if interval_ms
                           is None else float(interval_ms)) / 1000.0
        self.stall_soft = (config.breaker_stall_soft() if stall_soft
                           is None else float(stall_soft))
        self.p99_slo_ms = float(p99_slo_ms)
        # exit threshold sits BELOW soft (hysteresis): a score bouncing
        # around soft must not flap the breaker every sample
        self.exit = max(0.0, self.soft - 0.15)
        self.on_shrink = on_shrink
        self.on_restore = on_restore
        # guards ONLY the published state below (no telemetry
        # sampling, no callbacks, no blocking under it)
        self._breaker_lock = make_lock(
            "breaker.LoadBreaker._breaker_lock")
        self.state = CLOSED
        self.score = 0.0
        self.signals: Dict[str, float] = {}
        self.trips = 0
        self.sheds = 0
        self.calm_samples = 0
        self._admitted = 0                 # shed-modulus counter
        self._opened_at = 0.0
        self._last_eval = 0.0
        self._last_stalls: Optional[int] = None
        self._last_pages: Optional[int] = None
        self._probes_out = 0
        self._probe_fail = False
        self._probe_ok = 0
        self._events: List[Dict[str, Any]] = []
        # per-tenant fairness (multi-tenant clusters): a rolling window
        # of who the admitted traffic belongs to.  In SHEDDING, a tenant
        # whose observed traffic share exceeds 1.5x its fair weight
        # share is shed FIRST — the noisy tenant pays for the pressure
        # it creates, quiet tenants keep flowing.  Counts halve when the
        # window total reaches _TENANT_WINDOW so the signal tracks
        # recent traffic, not all-time.
        self._tenant_seen: Dict[str, int] = {}
        self._seen_total = 0
        self._tenant_sheds: Dict[str, int] = {}

    # -- telemetry ----------------------------------------------------------

    def _sample(self, queue_depth: int, queue_cap: int,
                p99_ms: float) -> Dict[str, float]:
        """One pressure sample (NO breaker lock held): the max of the
        normalized memory / stall / queue / latency components, with
        the chaos injector able to force a critical reading."""
        p = manager().pressure()
        mem = float(p["hbm_frac"])
        stalls, pages = p["demand_page_stalls"], (p["pages_in"] +
                                                  p["pages_out"])
        stall_delta = (0 if self._last_stalls is None
                       else stalls - self._last_stalls)
        page_delta = (0 if self._last_pages is None
                      else pages - self._last_pages)
        self._last_stalls, self._last_pages = stalls, pages
        stall = min(1.0, stall_delta / self.stall_soft) \
            if self.stall_soft > 0 else 0.0
        queue = (queue_depth / queue_cap) if queue_cap > 0 else 0.0
        lat = (p99_ms / self.p99_slo_ms) if self.p99_slo_ms > 0 else 0.0
        sig = {"mem": mem, "stall": stall, "queue": queue,
               "latency": lat, "page_delta": float(page_delta)}
        c = chaos()
        if c.enabled and c.maybe_serve_pressure(self.name):
            sig["injected"] = 1.0
        sig["score"] = max(mem, stall, queue, lat,
                           sig.get("injected", 0.0))
        return sig

    # -- state machine ------------------------------------------------------

    def _transition(self, new_state: str, why: str) -> None:
        """Publish a state edge (callers hold NO breaker lock; the edge
        itself is re-checked under it so concurrent evaluators agree)."""
        fire = None
        with self._breaker_lock:
            old = self.state
            if old == new_state:
                return
            self.state = new_state
            if new_state == OPEN:
                self.trips += 1
                self._opened_at = time.monotonic()
                self._probes_out = 0
                self._probe_ok = 0
                self._probe_fail = False
            if new_state == SHEDDING and old == CLOSED:
                fire = "shrink"
            if new_state == CLOSED and old in (SHEDDING, HALF_OPEN):
                fire = "restore"
            if new_state == HALF_OPEN:
                self._probes_out = 0
                self._probe_ok = 0
                self._probe_fail = False
            self.calm_samples = 0
            ev = {"time": time.time(), "from": old, "to": new_state,
                  "why": why, "score": self.score}
            self._events.append(ev)
            del self._events[:-_EVENT_RING]
        if new_state == OPEN:
            _bump("breaker_trips")
        elif new_state == HALF_OPEN:
            _bump("breaker_half_opens")
        elif new_state == CLOSED:
            _bump("breaker_closes")
        TimeLine.record("serve", f"breaker_{new_state}",
                        deployment=self.name, why=why)
        log.warning("serve: breaker[%s] %s -> %s (%s)", self.name, old,
                    new_state, why)
        if fire == "shrink" and self.on_shrink is not None:
            self.on_shrink()
        elif fire == "restore" and self.on_restore is not None:
            self.on_restore()

    def _evaluate(self, queue_depth: int, queue_cap: int,
                  p99_ms: float) -> None:
        """Rate-limited re-evaluation: sample OUTSIDE the lock, then
        walk the state machine on the fresh score."""
        now = time.monotonic()
        with self._breaker_lock:
            if now - self._last_eval < self.interval_s:
                return
            self._last_eval = now
            state = self.state
        sig = self._sample(queue_depth, queue_cap, p99_ms)
        score = sig["score"]
        with self._breaker_lock:
            self.score = score
            self.signals = sig
        if state == CLOSED:
            if score >= self.hard:
                self._transition(OPEN, f"score {score:.2f} >= hard "
                                       f"{self.hard:.2f}")
            elif score >= self.soft:
                self._transition(SHEDDING, f"score {score:.2f} >= soft "
                                           f"{self.soft:.2f}")
        elif state == SHEDDING:
            if score >= self.hard:
                self._transition(OPEN, f"score {score:.2f} >= hard "
                                       f"{self.hard:.2f}")
            elif score < self.exit:
                # hysteresis: two consecutive calm samples to close
                close = False
                with self._breaker_lock:
                    self.calm_samples += 1
                    close = self.calm_samples >= 2
                if close:
                    self._transition(CLOSED, f"score {score:.2f} < exit "
                                             f"{self.exit:.2f}")
            else:
                with self._breaker_lock:
                    self.calm_samples = 0
        elif state == OPEN:
            if now - self._opened_at >= self.open_secs:
                self._transition(HALF_OPEN, "cooldown elapsed")
        elif state == HALF_OPEN:
            if score >= self.hard:
                self._transition(OPEN, f"probe window still hot "
                                       f"({score:.2f})")

    # -- admission ----------------------------------------------------------

    def _note_tenant_locked(self, tenant: str) -> None:
        """Record one observed request for ``tenant`` (lock HELD)."""
        self._tenant_seen[tenant] = self._tenant_seen.get(tenant, 0) + 1
        self._seen_total += 1
        if self._seen_total >= _TENANT_WINDOW:
            for k in list(self._tenant_seen):
                self._tenant_seen[k] //= 2
            self._seen_total = sum(self._tenant_seen.values())

    @staticmethod
    def _weight_share(tenant: str) -> float:
        """Fair traffic share for ``tenant``: 1.0, the reference's answer
        when no tenant is registered (single-tenant clusters never look
        noisy); the port's tenant registry is ROADMAP P14."""
        return 1.0

    def admit(self, queue_depth: int, queue_cap: int,
              p99_ms: float = 0.0,
              tenant: Optional[str] = None) -> None:
        """Admission check for one request: returns normally or raises
        :class:`ShedLoad` (429) / :class:`BreakerOpen` (503).  When
        ``tenant`` is given, SHEDDING sheds a tenant running past 1.5x
        its fair weight share before touching anyone else."""
        self._evaluate(queue_depth, queue_cap, p99_ms)
        with self._breaker_lock:
            state = self.state
            score = self.score
            if tenant is not None:
                self._note_tenant_locked(tenant)
        if state == CLOSED:
            return
        if state == OPEN:
            remaining = max(0.5, self.open_secs -
                            (time.monotonic() - self._opened_at))
            with self._breaker_lock:
                self.sheds += 1
            _bump("breaker_sheds")
            raise BreakerOpen(
                f"serving breaker for {self.name} is open "
                f"(pressure {score:.2f}); retry after the cooldown",
                retry_after_s=remaining)
        if state == HALF_OPEN:
            with self._breaker_lock:
                if self._probes_out < self.probe_n:
                    self._probes_out += 1
                    return                      # admitted as a probe
                self.sheds += 1
            _bump("breaker_sheds")
            raise BreakerOpen(
                f"serving breaker for {self.name} is half-open and its "
                f"probe window is full; retry shortly",
                retry_after_s=1.0)
        # SHEDDING: a tenant whose observed traffic share runs past
        # 1.5x its fair weight share is shed outright — it is the one
        # creating the pressure.  The share is read OUTSIDE the breaker
        # lock.
        if tenant is not None:
            share = self._weight_share(tenant)
            with self._breaker_lock:
                seen = self._tenant_seen.get(tenant, 0)
                tot = self._seen_total
            if tot >= 16 and seen / tot > 1.5 * max(share, 1e-9):
                with self._breaker_lock:
                    self.sheds += 1
                    self._tenant_sheds[tenant] = \
                        self._tenant_sheds.get(tenant, 0) + 1
                _bump("breaker_sheds")
                raise ShedLoad(
                    f"serving breaker for {self.name} is shedding "
                    f"tenant {tenant} (observed share {seen / tot:.2f} "
                    f"> 1.5x fair share {share:.2f} under pressure "
                    f"{score:.2f})", retry_after_s=0.5)
        # everyone else: refuse a deterministic fraction proportional to
        # how far past soft the score sits (1-in-10 up to 9-in-10)
        frac = (score - self.soft) / max(1e-9, self.hard - self.soft)
        shed_in_10 = min(9, max(1, int(round(frac * 10))))
        with self._breaker_lock:
            self._admitted += 1
            shed = (self._admitted % 10) < shed_in_10
            if shed:
                self.sheds += 1
                if tenant is not None:
                    self._tenant_sheds[tenant] = \
                        self._tenant_sheds.get(tenant, 0) + 1
        if shed:
            _bump("breaker_sheds")
            raise ShedLoad(
                f"serving breaker for {self.name} is shedding load "
                f"(pressure {score:.2f} >= {self.soft:.2f}); retry "
                f"shortly", retry_after_s=0.5)

    def note_result(self, ok: bool) -> None:
        """Outcome of an admitted request — drives the HALF_OPEN
        verdict (all ``probe_n`` probes back + calm score => CLOSED;
        any failure => OPEN again)."""
        verdict = None
        with self._breaker_lock:
            if self.state != HALF_OPEN:
                return
            if not ok:
                self._probe_fail = True
            else:
                self._probe_ok += 1
            if self._probe_fail:
                verdict = "reopen"
            elif self._probe_ok >= self.probe_n:
                verdict = "close" if self.score < self.exit else "reopen"
        if verdict == "close":
            self._transition(CLOSED, f"{self.probe_n} probes ok, score "
                                     f"{self.score:.2f} < exit")
        elif verdict == "reopen":
            self._transition(OPEN, "half-open probe failed or still hot")

    # -- introspection ------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._breaker_lock:
            return {"state": self.state,
                    "score": round(self.score, 4),
                    "signals": {k: round(v, 4)
                                for k, v in self.signals.items()},
                    "trips": self.trips,
                    "sheds": self.sheds,
                    "tenant_sheds": dict(self._tenant_sheds),
                    "soft": self.soft, "hard": self.hard,
                    "exit": self.exit,
                    "open_secs": self.open_secs,
                    "probe_n": self.probe_n,
                    "p99_slo_ms": self.p99_slo_ms,
                    "events": [dict(e) for e in self._events[-8:]]}
