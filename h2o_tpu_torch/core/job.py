"""Async job tracking — port of ``h2o_tpu/core/job.py`` (``Job`` :60-233,
``ResizablePool`` :236-321, ``JobRegistry`` :324-575; reference
water/Job.java, water/api/JobsHandler.java).

Jobs run on a host thread pool (the FJ-pool analog for *control* work —
the compute is dispatched to the card inside the job body).  Progress,
cooperative cancellation, exception propagation and the DKV key of the
result (``dest``) follow the reference's Job<T> semantics:

- per-job DEADLINES: a job may declare ``deadline_secs`` (or inherit the
  registry default); a watchdog thread expires jobs that outlive it,
  marking them FAILED with a ``TimeoutError`` and compensating the pool
  slot so later jobs are never starved behind a hang;
- STALL detection: ``update()`` doubles as a progress heartbeat; a job
  with no heartbeat inside its ``stall_secs`` window is expired the same
  way;
- bounded registry: terminal jobs past ``jobs_cap`` are LRU-evicted.

The process-wide registry is :func:`jobs` (``cloud().jobs`` in the
reference; the port's ``cloud()`` is a ``torch.device``), with the
constructor's defaults: no deadline and no stall window unless a job
sets one, a 0.5 s watchdog interval and 512 jobs kept.  The reference's
``OptArgs`` environment fields for these defaults come with the cluster
options (P14).

What comes with later slices (ROADMAP P14): tenants and the fair-share
admission queue (a job given a ``tenant`` raises by name), and device
loss and membership: no exception counts as a device loss yet, so every
exception a body raises makes its job FAILED and is re-raised by
``join()``.  ``quiesce``/``interrupt`` and the INTERRUPTED state are
kept, since a caller can interrupt a job without a membership monitor.
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from typing import Any, Callable, Dict, Optional

from h2o_tpu_torch.core.diag import TimeLine
from h2o_tpu_torch.core.lockwitness import make_lock
from h2o_tpu_torch.core.log import get_logger
from h2o_tpu_torch.core.store import Key

log = get_logger("job")

CREATED = "CREATED"
RUNNING = "RUNNING"
DONE = "DONE"
CANCELLED = "CANCELLED"
FAILED = "FAILED"
# INTERRUPTED is terminal for this job object but not for the work: the
# job was stopped resumably (``interrupt``/``quiesce``); distinct from
# FAILED so a dashboard can tell "the work died" from "the work moved"
INTERRUPTED = "INTERRUPTED"
TERMINAL = (DONE, CANCELLED, FAILED, INTERRUPTED)


class JobCancelledException(Exception):
    pass


class JobInterruptedException(Exception):
    """Raised inside a job body at its next ``update()`` after an
    interrupt, and to joiners of an INTERRUPTED job."""


def _refuse_tenant(tenant: Optional[str]) -> None:
    if tenant is not None:
        raise NotImplementedError(
            f"h2o_tpu_torch: job tenant {tenant!r} needs the tenant "
            "registry and its fair-share admission queue, which are not "
            "ported yet (ROADMAP P14b)")


class Job:
    """A tracked unit of async work producing a DKV-visible result."""

    # priority bands (reference water/H2O.java:1470-1560: user work
    # 0-118, system work 119+ can never be starved by it)
    USER_PRIORITY = 50
    SYSTEM_PRIORITY = 119

    def __init__(self, dest: Optional[str] = None, description: str = "",
                 dest_type: str = "Key<Frame>",
                 priority: int = USER_PRIORITY,
                 deadline_secs: Optional[float] = None,
                 stall_secs: Optional[float] = None,
                 tenant: Optional[str] = None):
        _refuse_tenant(tenant)
        self.priority = int(priority)
        self.tenant = None
        self._admission_queued = False
        self.key = Key.make("job")
        self.dest = Key(dest) if dest else Key.make("result")
        self.dest_type = dest_type
        self.description = description
        self.status = CREATED
        self.progress = 0.0
        self.progress_msg = ""
        self.warnings: list = []
        self.exception: Optional[BaseException] = None
        self.start_time = 0.0
        self.end_time = 0.0
        # None = inherit the registry default; 0 = explicitly unbounded
        self.deadline_secs = deadline_secs
        self.stall_secs = stall_secs
        self.last_progress = 0.0
        self._timed_out = False
        self._cancel_requested = threading.Event()
        self._interrupt_requested = threading.Event()
        self.interrupted_by = ""
        self.requeued_as: Optional[str] = None
        self._done = threading.Event()
        # serializes the terminal transition between the worker thread
        # and the watchdog (JobRegistry._expire)
        self._state_lock = make_lock("job.Job._state_lock")
        self.result: Any = None

    # -- body-side API ------------------------------------------------------

    def update(self, progress: float, msg: str = "") -> None:
        """Called from inside the job body; the watchdog's progress
        heartbeat, and raises if a cancel or an interrupt was requested
        (cooperative cancellation, the reference's Job.stop_requested)."""
        self.progress = float(progress)
        self.last_progress = time.time()
        if msg:
            self.progress_msg = msg
        if self._interrupt_requested.is_set():
            raise JobInterruptedException(
                f"{self.description}: {self.interrupted_by or 'interrupted'}")
        if self._cancel_requested.is_set():
            raise JobCancelledException(self.description)

    def warn(self, msg: str) -> None:
        """Attach a client-visible warning (reference Job.warn)."""
        if msg not in self.warnings:
            self.warnings.append(msg)

    @property
    def stop_requested(self) -> bool:
        return self._cancel_requested.is_set()

    # -- control-side API ---------------------------------------------------

    def cancel(self) -> None:
        self._cancel_requested.set()

    def interrupt(self, cause: str = "") -> None:
        """Request a resumable stop: the body exits at its next
        ``update()`` with the job INTERRUPTED.  Also sets the cancel
        event, so bodies polling ``stop_requested`` exit too."""
        self.interrupted_by = cause or "membership interrupt"
        self._interrupt_requested.set()
        self._cancel_requested.set()

    def join(self, timeout: Optional[float] = None) -> Any:
        """The body's result; a FAILED job re-raises a same-type clone of
        its exception chained from the original (so the worker thread's
        traceback survives on the cause)."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"job {self.key} still running")
        if self.status == FAILED:
            exc = self.exception
            if exc is None:
                raise RuntimeError(
                    f"job {self.key} FAILED with no recorded exception")
            try:
                clone = type(exc)(*exc.args)
            except Exception:        # exotic ctor signature — raise as-is
                raise exc
            raise clone from exc
        if self.status == CANCELLED:
            raise JobCancelledException(self.description)
        if self.status == INTERRUPTED:
            exc = self.exception
            if exc is not None:
                try:
                    clone = type(exc)(*exc.args)
                except Exception:
                    raise exc
                raise clone from exc
            raise JobInterruptedException(
                f"{self.description}: {self.interrupted_by}")
        return self.result

    @property
    def is_running(self) -> bool:
        return self.status in (CREATED, RUNNING)

    def to_dict(self) -> Dict[str, Any]:
        """The /3/Jobs schema-shaped summary (the REST view is P13c)."""
        ms = lambda t: int(t * 1000) if t else 0  # noqa: E731
        return {
            "__meta": {"schema_version": 3, "schema_name": "JobV3",
                       "schema_type": "Job"},
            "key": {"name": str(self.key), "type": "Key<Job>",
                    "URL": f"/3/Jobs/{self.key}"},
            "dest": {"name": str(self.dest), "type": self.dest_type,
                     "URL": f"/3/Models/{self.dest}"
                     if "Model" in self.dest_type
                     else f"/3/Frames/{self.dest}"},
            "description": self.description,
            "status": self.status,
            "progress": self.progress,
            "progress_msg": self.progress_msg,
            "start_time": ms(self.start_time),
            "msec": ms((self.end_time or time.time()) - self.start_time)
            if self.start_time else 0,
            "warnings": list(self.warnings),
            "exception": repr(self.exception) if self.exception else None,
            "stacktrace": None,
            "ready_for_view": self.status == "DONE",
            "auto_recoverable": self.status == INTERRUPTED,
            "interrupted_by": self.interrupted_by or None,
            "requeued_as": self.requeued_as,
            "deadline_secs": self.deadline_secs,
            "stall_secs": self.stall_secs,
            "last_progress": ms(self.last_progress),
            "timed_out": self._timed_out,
            "tenant": self.tenant,
            "admission_queued": self._admission_queued,
        }


#: retire token — a worker that dequeues it exits iff the pool is over
#: its target size (a concurrent grow() makes the token a no-op)
_RETIRE = object()


class ResizablePool:
    """An owned daemon-thread work pool with grow/shrink.

    - ``submit`` never blocks: tasks queue and lazily spawn workers up
      to ``_max_workers``, a new one only when the tasks not yet done
      outnumber the live workers (the reference spawns one a submit up
      to the cap; on the card a new thread pays for its own cuBLAS
      handle and workspace, so an idle worker is reused);
    - ``grow`` adds one slot and spawns its worker at once (the
      watchdog's compensation runs while an expired job's thread is
      still wedged in its body);
    - ``shrink`` lowers the target (floor 1) and enqueues a retire
      token; whichever worker dequeues it exits only if the pool is
      still over target."""

    def __init__(self, max_workers: int, thread_name_prefix: str = "h2o-pool"):
        self._tasks: "queue.SimpleQueue" = queue.SimpleQueue()
        self._size_lock = threading.Lock()
        self._max_workers = max(1, int(max_workers))
        self._live = 0
        self._spawned = 0
        # tasks submitted and not yet done (retire tokens not counted)
        self._inflight = 0
        self._prefix = thread_name_prefix

    @property
    def max_workers(self) -> int:
        return self._max_workers

    @property
    def live_workers(self) -> int:
        return self._live

    def submit(self, fn: Callable[..., Any], *args: Any) -> None:
        with self._size_lock:
            self._inflight += 1
        self._tasks.put((fn, args))
        self._ensure_worker()

    def grow(self) -> bool:
        """Add one worker slot, effective immediately: a task queued
        behind the wedged one starts now."""
        with self._size_lock:
            self._max_workers += 1
        self._ensure_worker()
        return True

    def shrink(self) -> None:
        """Give back a compensated slot once the wedged thread exits."""
        with self._size_lock:
            if self._max_workers <= 1:
                return
            self._max_workers -= 1
        self._tasks.put(_RETIRE)

    def _ensure_worker(self) -> None:
        with self._size_lock:
            if self._live >= self._max_workers or \
                    self._inflight <= self._live:
                return
            self._live += 1
            self._spawned += 1
            n = self._spawned
        t = threading.Thread(target=self._worker, daemon=True,
                             name=f"{self._prefix}-{n}")
        t.start()

    def _worker(self) -> None:
        while True:
            item = self._tasks.get()
            if item is _RETIRE:
                with self._size_lock:
                    if self._live > self._max_workers:
                        self._live -= 1
                        return
                continue  # grow() raced the token — stay alive, drop it
            fn, args = item
            try:
                fn(*args)
            except BaseException:  # noqa: BLE001 — job bodies report their
                # own outcomes; a leak to here must not kill the worker
                log.exception("pool worker: task leaked an exception")
            finally:
                with self._size_lock:
                    self._inflight -= 1


class JobRegistry:
    """Two-band priority scheduler (the FJPS[0..126] analog): user jobs
    share a bounded pool; jobs at SYSTEM_PRIORITY and above run on a
    reserved pool, so control work is never starved behind long builds.
    A daemon watchdog enforces deadlines and stall windows; ``jobs_cap``
    bounds the registry by LRU-evicting terminal jobs."""

    def __init__(self, max_workers: int = 8, system_workers: int = 2,
                 default_deadline_secs: float = 0.0,
                 default_stall_secs: float = 0.0,
                 watchdog_interval: float = 0.5,
                 jobs_cap: int = 512):
        self._jobs: Dict[Key, Job] = {}
        self._pool = ResizablePool(max_workers,
                                   thread_name_prefix="h2o-job")
        self._sys_pool = ResizablePool(system_workers,
                                       thread_name_prefix="h2o-sysjob")
        self._lock = make_lock("job.JobRegistry._lock")
        self.default_deadline_secs = float(default_deadline_secs)
        self.default_stall_secs = float(default_stall_secs)
        self.watchdog_interval = float(watchdog_interval)
        self.jobs_cap = int(jobs_cap)
        self.expired_count = 0
        self.evicted_count = 0
        self._watchdog: Optional[threading.Thread] = None

    @property
    def admission(self):
        """The fair-share admission queue comes with tenants (P14b)."""
        raise NotImplementedError(
            "h2o_tpu_torch: the fair-share admission queue comes with the "
            "tenant registry (ROADMAP P14b)")

    # -- watchdog -----------------------------------------------------------

    def _ensure_watchdog(self) -> None:
        if self._watchdog is not None and self._watchdog.is_alive():
            return
        t = threading.Thread(target=self._watch, daemon=True,
                             name="h2o-job-watchdog")
        self._watchdog = t
        t.start()

    def _watch(self) -> None:
        while True:
            time.sleep(self.watchdog_interval)
            self._scan(time.time())

    def _scan(self, now: float) -> None:
        """One watchdog pass: expire every RUNNING job past its deadline
        or its stall window at ``now``."""
        for job in self.list():
            if job.status != RUNNING or job._timed_out:
                continue
            dl = job.deadline_secs if job.deadline_secs is not None \
                else self.default_deadline_secs
            if dl and now - job.start_time > dl:
                self._expire(job, f"deadline of {dl:g}s exceeded")
                continue
            stall = job.stall_secs if job.stall_secs is not None \
                else self.default_stall_secs
            beat = job.last_progress or job.start_time
            if stall and now - beat > stall:
                self._expire(job, "no progress heartbeat for "
                                  f"{stall:g}s (stall window)")

    def _expire(self, job: Job, why: str) -> None:
        """Watchdog-side terminal transition: FAILED + TimeoutError, the
        done event set (joiners unblock now), a cooperative cancel
        requested so the body exits at its next update(), and the pool
        compensated in case the body never does."""
        with job._state_lock:
            if job.status in TERMINAL:
                return
            log.warning("watchdog: expiring job %s (%s): %s", job.key,
                        job.description, why)
            job._timed_out = True
            job.exception = TimeoutError(
                f"job {job.key} ({job.description}): {why}")
            job.cancel()
            job.status = FAILED
            job.end_time = time.time()
            self.expired_count += 1
            job._done.set()
        pool = self._sys_pool if job.priority >= Job.SYSTEM_PRIORITY \
            else self._pool
        if pool.grow():
            job._compensated_pool = pool

    # -- registry bound -----------------------------------------------------

    def _evict_terminal(self) -> None:
        """LRU-evict terminal jobs past jobs_cap (oldest end_time first);
        live jobs are never evicted."""
        with self._lock:
            over = len(self._jobs) - self.jobs_cap
            if over <= 0:
                return
            dead = sorted((j for j in self._jobs.values()
                           if j.status in TERMINAL),
                          key=lambda j: j.end_time)
            for j in dead[:over]:
                del self._jobs[j.key]
                self.evicted_count += 1

    # -- scheduling ---------------------------------------------------------

    def start(self, job: Job, body: Callable[[Job], Any]) -> Job:
        """Register and schedule a job on its priority band's pool."""
        with self._lock:
            self._jobs[job.key] = job
        self._evict_terminal()
        self._ensure_watchdog()
        pool = self._sys_pool if job.priority >= Job.SYSTEM_PRIORITY \
            else self._pool
        pool.submit(self._runner(job, body))
        return job

    def _runner(self, job: Job,
                body: Callable[[Job], Any]) -> Callable[[], None]:
        def run():
            TimeLine.record("job", "start", key=str(job.key),
                            description=job.description)
            job.status = RUNNING
            job.start_time = time.time()
            job.last_progress = job.start_time
            try:
                from h2o_tpu_torch.core.chaos import chaos
                if chaos().enabled:
                    chaos().maybe_fail_job(job.description)
                    chaos().maybe_stall(job.description)
                result = body(job)
                with job._state_lock:
                    if not job._timed_out:
                        job.result = result
                        job.status = DONE
                        job.progress = 1.0
            except JobInterruptedException as e:
                with job._state_lock:
                    if not job._timed_out:
                        job.status = INTERRUPTED
                        job.exception = None
                log.warning("job %s interrupted (%s): %s", job.key,
                            job.description, e)
            except JobCancelledException:
                interrupted = job._interrupt_requested.is_set()
                with job._state_lock:
                    if not job._timed_out:
                        job.status = INTERRUPTED if interrupted \
                            else CANCELLED
            except BaseException as e:  # noqa: BLE001 — propagate to joiner
                with job._state_lock:
                    if not job._timed_out:
                        job.status = FAILED
                        job.exception = e
                log.error("job %s failed: %s\n%s", job.key, e,
                          traceback.format_exc())
            finally:
                with job._state_lock:
                    if not job._timed_out:
                        job.end_time = time.time()
                pool = getattr(job, "_compensated_pool", None)
                if pool is not None:
                    pool.shrink()
                TimeLine.record("job", "end", key=str(job.key),
                                status=job.status)
                job._done.set()

        return run

    def run_sync(self, job: Job, body: Callable[[Job], Any]) -> Any:
        self.start(job, body)
        return job.join()

    def quiesce(self, cause: str = "membership reform",
                wait_secs: float = 15.0, exclude=()) -> list:
        """Interrupt every live job (resumably) and wait a bounded
        window for their bodies to exit.  Returns the interrupted jobs;
        a body wedged past the window is left to the watchdog."""
        victims = []
        for job in self.list():
            if str(job.key) in exclude:
                continue
            if job.status in (CREATED, RUNNING):
                job.interrupt(cause)
                victims.append(job)
        deadline = time.time() + max(0.0, wait_secs)
        for job in victims:
            job._done.wait(max(0.0, deadline - time.time()))
        return victims

    def get(self, key: str) -> Optional[Job]:
        with self._lock:
            return self._jobs.get(Key(key))

    def list(self) -> list:
        with self._lock:
            return list(self._jobs.values())


_instance: Optional[JobRegistry] = None
_instance_lock = make_lock("job._instance_lock")


def jobs() -> JobRegistry:
    """The process-wide registry (``cloud().jobs`` in ``h2o_tpu``)."""
    global _instance
    if _instance is None:
        with _instance_lock:
            if _instance is None:
                _instance = JobRegistry()
    return _instance
