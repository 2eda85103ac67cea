"""Fault injection — the `-random_udp_drop` analog (SURVEY §4/§5.3); port
of ``h2o_tpu/core/chaos.py``, copied whole: the same flags, the same
``np.random.default_rng(seed)``, so one seed and one call order inject
the same faults in both packages.

Wired in the port so far: slow-score in the engine
(``serve/engine.py`` ``predict``) and serve-pressure in the breaker
(``serve/breaker.py`` ``_sample``).  The other injectors' sites (job,
device-put, persist, stall, transfer, OOM, stream, kernel-reject,
slice-loss, admission) come with the slices that port those layers
(ROADMAP).

The reference exercises its retry/dedup machinery by randomly dropping
UDP packets (water/H2O.java:446) and by a client-disconnect attack
thread.  The TPU rebuild's failure surface is different — XLA collectives
either complete or the program faults — so the injectable faults live at
the HOST layer the framework owns:

- job-body faults: a configured probability that any job body raises
  mid-run (exercises Job FAILED propagation, grid failure collection,
  AutoML skip-and-continue, and Recovery resume);
- device-put faults: a probability that a host->HBM transfer raises
  (exercises ingest/training error paths without corrupting state);
- persist-I/O faults: byte-store reads/writes raise — either with a
  probability, or in TRANSIENT mode (fail the first N attempts of each
  distinct operation, then succeed) so tests prove the retry layer in
  core/resilience.py actually recovers rather than merely re-raising;
- stall faults: a job body sleeps without emitting a progress heartbeat,
  exercising the JobRegistry watchdog (deadline/stall detection);
- slow-score faults: the online-scoring engine (serve/engine.py) sleeps
  inside a device batch, exercising the micro-batcher's admission-queue
  load shedding (429) and per-request deadline expiry (408);
- device-OOM faults: a dispatch choke point raises a synthetic
  RESOURCE_EXHAUSTED — either with a probability, or in TRANSIENT mode
  (fail the first N attempts of each distinct SITE, then succeed,
  mirroring the persist-transient design) — so the full OOM degradation
  ladder (core/oom.py: sweep -> shrink -> host fallback -> terminal) is
  exercisable on CPU CI without real HBM pressure;
- stream faults: a chunk read raises as a truncated source
  (probability or fail-first-N-per-source transient mode) or stalls,
  exercising the streaming-ingest retry loop and lag accounting;
- kernel-reject faults: a fused-kernel dispatch raises a synthetic
  Pallas/VMEM-gate rejection, proving kernel_fallback degrades to the
  portable XLA path;
- serve-pressure faults: the serving circuit breaker's telemetry read
  reports a synthetic critical memory-pressure sample, so the full
  breaker protocol (serve/breaker.py: shrink quanta -> shed 429 ->
  trip open -> half-open probe -> close) is exercisable on CPU CI
  without a real HBM budget or traffic storm;
- slice-loss faults: a dispatch choke point raises a synthetic
  "device unavailable" (a preempted TPU slice / ICI fault) — either
  with a probability, or DETERMINISTICALLY at the Nth dispatch of each
  distinct site (``maybe_lose_slice`` counts calls per site and fires
  exactly once when the count reaches N) — so the elastic-membership
  recovery protocol (core/membership.py: quiesce -> Cloud.reform ->
  auto_recover, bitwise) is exercisable on CPU CI without preempting
  real capacity.

The authoritative flag table (all off by default; zero overhead when
off; seedable with ``H2O_TPU_CHAOS_SEED``; programmatic via
``configure()`` — the README mirrors this table):

=========================================== ===========================
Flag                                        Meaning
=========================================== ===========================
H2O_TPU_CHAOS_JOB                           P(job body raises at start)
H2O_TPU_CHAOS_DEVICE_PUT                    P(host->HBM transfer raises)
H2O_TPU_CHAOS_PERSIST                       P(byte-store read/write raises)
H2O_TPU_CHAOS_PERSIST_TRANSIENT=N           fail first N attempts of each
                                            persist op, then succeed
H2O_TPU_CHAOS_STALL / _STALL_SECS           P/duration of a heartbeat-free
                                            stall (watchdog drill)
H2O_TPU_CHAOS_SCORE_SLOW / _SCORE_SLOW_MS   P/duration of a slow serving
                                            batch (429/408 drill)
H2O_TPU_CHAOS_TRANSFER_SLOW /               P/duration of a slow
  _TRANSFER_SLOW_MS                         device->host block pull
H2O_TPU_CHAOS_OOM                           P(synthetic RESOURCE_EXHAUSTED)
H2O_TPU_CHAOS_OOM_TRANSIENT=N               fail first N attempts at each
                                            dispatch site, then succeed
H2O_TPU_CHAOS_REGION_OOM_TRANSIENT=N        fail first N fused Rapids
                                            regions at each region site
                                            beyond the inner ladder
                                            (unfused-fallback drill)
H2O_TPU_CHAOS_STREAM_TRUNCATE               P(chunk read raises truncated)
H2O_TPU_CHAOS_STREAM_TRUNCATE_TRANSIENT=N   fail first N reads of each
                                            source, then succeed
H2O_TPU_CHAOS_STREAM_SLOW / _STREAM_SLOW_MS P/duration of a stalled read
H2O_TPU_CHAOS_KERNEL_REJECT                 P(synthetic Pallas/VMEM-gate
                                            kernel rejection)
H2O_TPU_CHAOS_SERVE_PRESSURE                P(breaker telemetry read sees
                                            synthetic critical pressure)
H2O_TPU_CHAOS_SLICE_LOSS                    P(synthetic device-unavailable
                                            slice loss)
H2O_TPU_CHAOS_SLICE_LOSS_AT_BLOCK=N         lose the slice exactly once,
                                            at the Nth dispatch of each
                                            site (deterministic)
H2O_TPU_CHAOS_ADMISSION_REJECT              P(fair-share admission refuses
                                            a tenant job with a classified
                                            429 AdmissionRejected)
=========================================== ===========================

COUNTER DISCIPLINE:
every ``maybe_*`` injector increments a DEDICATED ``injected_*``
counter (plus the ``injected`` grand total), and every counter appears
in the ``GET /3/Resilience`` payload — so a soak run can prove that
every injected fault is accounted for (``injected`` equals the sum of
the per-type counters).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from h2o_tpu_torch.core.log import get_logger

log = get_logger("chaos")


class ChaosError(RuntimeError):
    """Injected failure (never raised unless chaos is enabled)."""


class ChaosIOError(ChaosError, IOError):
    """Injected persist-I/O failure.  Also an OSError, so the retry
    layer classifies it transient — exactly like a real flaky store."""


class ChaosOOMError(ChaosError):
    """Injected device-OOM.  core/oom.py classifies it exactly like a
    real XLA RESOURCE_EXHAUSTED, so the degradation ladder walks its
    rungs without needing real HBM pressure."""


class ChaosKernelRejectError(ChaosError):
    """Injected Pallas/Mosaic kernel rejection (a VMEM-gate or lowering
    failure).  The message carries the Pallas marker so
    core/oom.is_kernel_compile_failure classifies it exactly like a real
    Mosaic compile error — kernel_fallback must degrade the dispatch to
    the portable XLA path without CI needing real TPU VMEM pressure."""


class ChaosSliceLossError(ChaosError):
    """Injected slice loss (a preempted TPU slice / ICI fault).  The
    message carries the "device unavailable" marker so
    core/oom.is_device_loss classifies it exactly like a real XLA
    device-unavailable/halted error — the membership layer must quiesce,
    reform the mesh on the survivors, and resume every job bitwise,
    without CI needing real preemptible capacity.  Deliberately NOT a
    ChaosOOMError: slice loss must never walk the OOM shrink ladder."""


class _Chaos:
    def __init__(self):
        e = os.environ.get
        self.job_p = float(e("H2O_TPU_CHAOS_JOB", 0) or 0)
        self.device_put_p = float(e("H2O_TPU_CHAOS_DEVICE_PUT", 0) or 0)
        self.persist_p = float(e("H2O_TPU_CHAOS_PERSIST", 0) or 0)
        self.persist_transient = int(
            e("H2O_TPU_CHAOS_PERSIST_TRANSIENT", 0) or 0)
        self.stall_p = float(e("H2O_TPU_CHAOS_STALL", 0) or 0)
        self.stall_secs = float(e("H2O_TPU_CHAOS_STALL_SECS", 30) or 30)
        self.score_slow_p = float(e("H2O_TPU_CHAOS_SCORE_SLOW", 0) or 0)
        self.score_slow_ms = float(
            e("H2O_TPU_CHAOS_SCORE_SLOW_MS", 200) or 200)
        self.transfer_slow_p = float(
            e("H2O_TPU_CHAOS_TRANSFER_SLOW", 0) or 0)
        self.transfer_slow_ms = float(
            e("H2O_TPU_CHAOS_TRANSFER_SLOW_MS", 100) or 100)
        self.oom_p = float(e("H2O_TPU_CHAOS_OOM", 0) or 0)
        self.oom_transient = int(e("H2O_TPU_CHAOS_OOM_TRANSIENT", 0) or 0)
        self.region_oom_transient = int(
            e("H2O_TPU_CHAOS_REGION_OOM_TRANSIENT", 0) or 0)
        self.stream_truncate_p = float(
            e("H2O_TPU_CHAOS_STREAM_TRUNCATE", 0) or 0)
        self.stream_truncate_transient = int(
            e("H2O_TPU_CHAOS_STREAM_TRUNCATE_TRANSIENT", 0) or 0)
        self.stream_slow_p = float(e("H2O_TPU_CHAOS_STREAM_SLOW", 0) or 0)
        self.stream_slow_ms = float(
            e("H2O_TPU_CHAOS_STREAM_SLOW_MS", 100) or 100)
        self.kernel_reject_p = float(
            e("H2O_TPU_CHAOS_KERNEL_REJECT", 0) or 0)
        self.serve_pressure_p = float(
            e("H2O_TPU_CHAOS_SERVE_PRESSURE", 0) or 0)
        self.slice_loss_p = float(e("H2O_TPU_CHAOS_SLICE_LOSS", 0) or 0)
        self.slice_loss_at_block = int(
            e("H2O_TPU_CHAOS_SLICE_LOSS_AT_BLOCK", 0) or 0)
        self.admission_reject_p = float(
            e("H2O_TPU_CHAOS_ADMISSION_REJECT", 0) or 0)
        seed = e("H2O_TPU_CHAOS_SEED")
        self._rng = np.random.default_rng(
            int(seed) if seed is not None else None)
        self._lock = threading.Lock()
        self._transient_seen: Dict[Tuple[str, str], int] = {}
        self._oom_seen: Dict[str, int] = {}
        self._region_oom_seen: Dict[str, int] = {}
        self._stream_seen: Dict[str, int] = {}
        self._slice_calls: Dict[str, int] = {}
        self.injected = 0
        self.injected_jobs = 0
        self.injected_device_puts = 0
        self.injected_persist = 0
        self.injected_stalls = 0
        self.injected_slow_scores = 0
        self.injected_slow_transfers = 0
        self.injected_oom = 0
        self.injected_region_ooms = 0
        self.injected_stream_truncations = 0
        self.injected_slow_streams = 0
        self.injected_kernel_rejects = 0
        self.injected_slice_losses = 0
        self.injected_serve_pressure = 0
        self.injected_admission_rejects = 0

    @property
    def enabled(self) -> bool:
        return (self.job_p > 0 or self.device_put_p > 0 or
                self.persist_p > 0 or self.persist_transient > 0 or
                self.stall_p > 0 or self.score_slow_p > 0 or
                self.transfer_slow_p > 0 or self.oom_p > 0 or
                self.oom_transient > 0 or
                self.region_oom_transient > 0 or
                self.stream_truncate_p > 0 or
                self.stream_truncate_transient > 0 or
                self.stream_slow_p > 0 or self.kernel_reject_p > 0 or
                self.serve_pressure_p > 0 or
                self.slice_loss_p > 0 or self.slice_loss_at_block > 0 or
                self.admission_reject_p > 0)

    def counters(self) -> Dict[str, int]:
        """All injected-fault counters (the /3/Resilience chaos block).
        Invariant the soak harness asserts: ``injected`` equals the sum
        of every ``injected_*`` per-type counter — no unaccounted
        faults."""
        with self._lock:
            return {k: getattr(self, k) for k in (
                "injected", "injected_jobs", "injected_device_puts",
                "injected_persist", "injected_stalls",
                "injected_slow_scores", "injected_slow_transfers",
                "injected_oom", "injected_region_ooms",
                "injected_stream_truncations",
                "injected_slow_streams", "injected_kernel_rejects",
                "injected_slice_losses", "injected_serve_pressure",
                "injected_admission_rejects")}

    def _roll(self, p: float) -> bool:
        if p <= 0:
            return False
        with self._lock:
            hit = bool(self._rng.uniform() < p)
            if hit:
                self.injected += 1
        return hit

    def maybe_fail_job(self, what: str) -> None:
        if self._roll(self.job_p):
            with self._lock:
                self.injected_jobs += 1
            log.warning("chaos: injecting job failure into %s", what)
            raise ChaosError(f"injected job fault ({what})")

    def maybe_fail_device_put(self) -> None:
        if self._roll(self.device_put_p):
            with self._lock:
                self.injected_device_puts += 1
            log.warning("chaos: injecting device_put failure")
            raise ChaosError("injected device_put fault")

    def maybe_oom(self, site: str) -> None:
        """Device-OOM injector: called once per ATTEMPT by the OOM
        ladder (core/oom.py oom_ladder), so transient mode
        deterministically fails the first N attempts at each distinct
        site and then lets it through — the ladder must absorb exactly
        N faults (sweeps, then quantum shrinks / host fallback) to
        succeed."""
        if self.oom_transient > 0:
            with self._lock:
                n = self._oom_seen.get(site, 0)
                if n < self.oom_transient:
                    self._oom_seen[site] = n + 1
                    self.injected += 1
                    self.injected_oom += 1
                else:
                    return
            log.warning("chaos: transient device OOM %d/%d at %s",
                        n + 1, self.oom_transient, site)
            raise ChaosOOMError(
                f"injected device OOM {n + 1}/{self.oom_transient} at "
                f"{site}: RESOURCE_EXHAUSTED (synthetic)")
        if self._roll(self.oom_p):
            with self._lock:
                self.injected_oom += 1
            log.warning("chaos: injecting device OOM at %s", site)
            raise ChaosOOMError(
                f"injected device OOM at {site}: RESOURCE_EXHAUSTED "
                f"(synthetic)")

    def maybe_region_oom(self, site: str) -> None:
        """Fused-region OOM injector: called by core/oom.fused_fallback
        once per planner-fused Rapids region, so CI can prove a region
        that OOMs BEYOND its inner ladder degrades to the eager
        per-verb chain (the bitwise oracle) instead of failing — the
        per-verb sites are untouched, exactly the real asymmetry (the
        fused program's working set is the sum of its stages; the
        individual verbs still fit)."""
        if self.region_oom_transient <= 0:
            return
        with self._lock:
            n = self._region_oom_seen.get(site, 0)
            if n >= self.region_oom_transient:
                return
            self._region_oom_seen[site] = n + 1
            self.injected += 1
            self.injected_region_ooms += 1
        log.warning("chaos: transient fused-region OOM %d/%d at %s",
                    n + 1, self.region_oom_transient, site)
        raise ChaosOOMError(
            f"injected fused-region OOM {n + 1}/"
            f"{self.region_oom_transient} at {site}: RESOURCE_EXHAUSTED "
            f"(synthetic, beyond the inner ladder)")

    def maybe_kernel_reject(self, site: str) -> None:
        """Kernel-rejection injector: called by core/oom.kernel_fallback
        once per fused-kernel dispatch, so CI can prove a Pallas
        VMEM-gate/Mosaic rejection degrades the dispatch to the portable
        XLA path (run(False)) instead of failing the training job."""
        if self._roll(self.kernel_reject_p):
            with self._lock:
                self.injected_kernel_rejects += 1
            log.warning("chaos: injecting Pallas kernel rejection at %s",
                        site)
            raise ChaosKernelRejectError(
                f"injected Pallas kernel rejection at {site}: working "
                f"set exceeds VMEM (synthetic)")

    def maybe_serve_pressure(self, site: str) -> bool:
        """Serve-pressure injector: called by the serving circuit
        breaker (serve/breaker.py) each time it samples its telemetry.
        Returns True when the sample must be treated as CRITICAL
        memory pressure — the breaker then walks its protocol (shrink
        quanta -> shed -> trip open) exactly as it would under a real
        HBM squeeze, without CI needing a budget or a traffic storm.
        Unlike the raising injectors this one only biases a reading, so
        no exception type: the breaker's response IS the behavior under
        test."""
        if self._roll(self.serve_pressure_p):
            with self._lock:
                self.injected_serve_pressure += 1
            log.warning("chaos: injecting serve pressure at %s", site)
            return True
        return False

    def maybe_lose_slice(self, site: str) -> None:
        """Slice-loss injector: called at dispatch choke points (the
        tree driver's per-block launch, the membership liveness probe).
        AT_BLOCK mode counts calls per distinct SITE and fires exactly
        once, on call number N — so a drill can lose the slice
        mid-forest and the RESUMED run (whose calls keep counting past
        N) completes untouched.  Probability mode rolls per call."""
        if self.slice_loss_at_block > 0:
            with self._lock:
                n = self._slice_calls.get(site, 0) + 1
                self._slice_calls[site] = n
                if n != self.slice_loss_at_block:
                    return
                self.injected += 1
                self.injected_slice_losses += 1
            log.warning("chaos: losing slice at %s (dispatch %d)",
                        site, n)
            raise ChaosSliceLossError(
                f"injected slice loss at {site} (dispatch {n}): device "
                f"unavailable — slice preempted (synthetic)")
        if self._roll(self.slice_loss_p):
            with self._lock:
                self.injected_slice_losses += 1
            log.warning("chaos: losing slice at %s", site)
            raise ChaosSliceLossError(
                f"injected slice loss at {site}: device unavailable — "
                f"slice preempted (synthetic)")

    def maybe_reject_admission(self, tenant: str) -> bool:
        """Admission-rejection injector: called by the fair-share queue
        (core/tenant.py FairShareAdmission.submit) before a tenant job
        enqueues.  Returns True when the admission must refuse with a
        classified ``AdmissionRejected(reason="injected")`` — a 429, not
        a crash — so soaks prove every refusal under chaos stays typed
        and the submitter's retry path is exercised.  Like
        ``maybe_serve_pressure`` this biases a decision rather than
        raising: the admission layer owns the exception."""
        if self._roll(self.admission_reject_p):
            with self._lock:
                self.injected_admission_rejects += 1
            log.warning("chaos: rejecting admission for tenant %s", tenant)
            return True
        return False

    def maybe_truncate_stream(self, source: str) -> None:
        """Streaming-ingest truncation injector: a chunk read raises as
        if the source was cut off mid-record — retried by the stream
        reader's retry policy (ChaosIOError is an OSError, so it
        classifies transient).  Transient mode fails the first N reads
        of each distinct SOURCE then lets it through, proving the retry
        loop absorbs exactly N faults (the persist-transient design)."""
        if self.stream_truncate_transient > 0:
            with self._lock:
                n = self._stream_seen.get(source, 0)
                if n < self.stream_truncate_transient:
                    self._stream_seen[source] = n + 1
                    self.injected += 1
                    self.injected_stream_truncations += 1
                else:
                    return
            log.warning("chaos: transient stream truncation %d/%d (%s)",
                        n + 1, self.stream_truncate_transient, source)
            raise ChaosIOError(
                f"injected stream truncation {n + 1}/"
                f"{self.stream_truncate_transient} ({source})")
        if self._roll(self.stream_truncate_p):
            with self._lock:
                self.injected_stream_truncations += 1
            log.warning("chaos: injecting stream truncation (%s)", source)
            raise ChaosIOError(f"injected stream truncation ({source})")

    def maybe_slow_stream(self, what: str = "stream") -> None:
        """Slow-source injector: a chunk read stalls — the pipeline's
        job heartbeat must keep beating (no watchdog expiry) and lag
        accounting must reflect the stalled ingest."""
        if self._roll(self.stream_slow_p):
            with self._lock:
                self.injected_slow_streams += 1
            log.warning("chaos: slowing %s read by %.0fms", what,
                        self.stream_slow_ms)
            time.sleep(self.stream_slow_ms / 1000.0)

    def maybe_fail_persist(self, op: str, uri: str) -> None:
        """Persist-I/O injector: called once per ATTEMPT by the byte-store
        layer, so transient mode deterministically fails the first N
        attempts of each distinct (op, uri) and then lets it through —
        the retry loop must absorb exactly N faults to succeed."""
        if self.persist_transient > 0:
            k = (op, uri)
            with self._lock:
                n = self._transient_seen.get(k, 0)
                if n < self.persist_transient:
                    self._transient_seen[k] = n + 1
                    self.injected += 1
                    self.injected_persist += 1
                else:
                    return
            log.warning("chaos: transient persist fault %d/%d (%s %s)",
                        n + 1, self.persist_transient, op, uri)
            raise ChaosIOError(
                f"injected transient persist fault {n + 1}/"
                f"{self.persist_transient} ({op} {uri})")
        if self._roll(self.persist_p):
            with self._lock:
                self.injected_persist += 1
            log.warning("chaos: injecting persist failure (%s %s)", op, uri)
            raise ChaosIOError(f"injected persist fault ({op} {uri})")

    def maybe_slow_score(self, what: str = "score") -> None:
        """Slow-score injector: sleep inside an online-scoring device
        batch — the micro-batcher's admission queue must back up (shed
        as 429) and queued requests must hit their deadlines (408)."""
        if self._roll(self.score_slow_p):
            with self._lock:
                self.injected_slow_scores += 1
            log.warning("chaos: slowing %s by %.0fms", what,
                        self.score_slow_ms)
            time.sleep(self.score_slow_ms / 1000.0)

    def maybe_slow_transfer(self, what: str = "transfer") -> None:
        """Slow-transfer injector: sleep inside a device->host block
        materialization — in the async tree driver this widens the host
        window block *t+1*'s device build must hide, making the overlap
        (or its absence) visible to timed assertions."""
        if self._roll(self.transfer_slow_p):
            with self._lock:
                self.injected_slow_transfers += 1
            log.warning("chaos: slowing %s transfer by %.0fms", what,
                        self.transfer_slow_ms)
            time.sleep(self.transfer_slow_ms / 1000.0)

    def maybe_stall(self, what: str) -> None:
        """Stall injector: sleep without a progress heartbeat — the job
        watchdog (core/job.py) must detect and expire the job."""
        if self._roll(self.stall_p):
            with self._lock:
                self.injected_stalls += 1
            log.warning("chaos: stalling %s for %.1fs", what,
                        self.stall_secs)
            time.sleep(self.stall_secs)


_instance: Optional[_Chaos] = None


def chaos() -> _Chaos:
    global _instance
    if _instance is None:
        _instance = _Chaos()
    return _instance


def configure(job_p: float = 0.0, device_put_p: float = 0.0,
              seed: Optional[int] = None, persist_p: float = 0.0,
              persist_transient: int = 0, stall_p: float = 0.0,
              stall_secs: float = 30.0, score_slow_p: float = 0.0,
              score_slow_ms: float = 200.0,
              transfer_slow_p: float = 0.0,
              transfer_slow_ms: float = 100.0,
              oom_p: float = 0.0, oom_transient: int = 0,
              region_oom_transient: int = 0,
              stream_truncate_p: float = 0.0,
              stream_truncate_transient: int = 0,
              stream_slow_p: float = 0.0,
              stream_slow_ms: float = 100.0,
              kernel_reject_p: float = 0.0,
              serve_pressure_p: float = 0.0,
              slice_loss_p: float = 0.0,
              slice_loss_at_block: int = 0,
              admission_reject_p: float = 0.0) -> _Chaos:
    """Programmatic enable (tests); returns the active instance."""
    global _instance
    _instance = _Chaos()
    _instance.stream_truncate_p = float(stream_truncate_p)
    _instance.stream_truncate_transient = int(stream_truncate_transient)
    _instance.stream_slow_p = float(stream_slow_p)
    _instance.stream_slow_ms = float(stream_slow_ms)
    _instance.job_p = float(job_p)
    _instance.device_put_p = float(device_put_p)
    _instance.persist_p = float(persist_p)
    _instance.persist_transient = int(persist_transient)
    _instance.stall_p = float(stall_p)
    _instance.stall_secs = float(stall_secs)
    _instance.score_slow_p = float(score_slow_p)
    _instance.score_slow_ms = float(score_slow_ms)
    _instance.transfer_slow_p = float(transfer_slow_p)
    _instance.transfer_slow_ms = float(transfer_slow_ms)
    _instance.oom_p = float(oom_p)
    _instance.oom_transient = int(oom_transient)
    _instance.region_oom_transient = int(region_oom_transient)
    _instance.kernel_reject_p = float(kernel_reject_p)
    _instance.serve_pressure_p = float(serve_pressure_p)
    _instance.slice_loss_p = float(slice_loss_p)
    _instance.slice_loss_at_block = int(slice_loss_at_block)
    _instance.admission_reject_p = float(admission_reject_p)
    if seed is not None:
        _instance._rng = np.random.default_rng(seed)
    return _instance


def reset() -> None:
    global _instance
    _instance = None
