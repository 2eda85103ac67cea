"""MicroBatcher — coalesce concurrent score requests into device batches;
port of ``h2o_tpu/serve/batcher.py``.

Reference: the in-cluster scoring path amortizes per-row cost by design
(BigScore is an MRTask over whole chunks); a low-latency serving layer
has to recreate that batching from the other direction — many tiny
concurrent requests, one device dispatch.  The shape here is the classic
serving micro-batch (TF-Serving BatchingSession / Triton dynamic
batcher):

- requests enqueue a future and block; a per-deployment worker drains
  the queue, waiting at most ``max_delay_ms`` beyond the first request
  and closing the batch at ``max_batch`` rows;
- admission control: a bounded queue (``queue_cap`` in-flight requests)
  sheds load by raising :class:`QueueFull` — the REST surface maps it
  to HTTP 429 so clients back off instead of piling onto a cold cache;
- per-request deadlines (core/resilience.Deadline): a request that
  expires while queued is failed with ``TimeoutError`` without wasting
  a device slot on an answer nobody is waiting for.

The worker scores through a caller-supplied ``score_fn(rows)`` so the
batch is encoded against the deployment's CURRENT active version —
requests racing a hot-swap all score consistently.

Hot-reconfigure contract (the adaptive tuner calls ``configure()``
LIVE): the worker takes one consistent snapshot of
``(max_batch, max_delay_ms)`` under ``_plock`` at batch OPEN and uses
only that snapshot for the whole drain — a reconfigure landing mid-batch
affects the next batch, never tears the current one, and no request is
lost or double-scored across the switch (test_serving.py hammers this).

:class:`AdaptiveBatchTuner` retunes ``max_batch``/``max_delay_ms`` from
measured queue depth and batch fill, autotuner-style (windowed
observations, then one measured decision).  Moves are bounded to the
pow2 buckets the engine captures (``core/exec_store.py``
``bucket_pow2``) between ``H2O_TPU_SERVE_MIN_BATCH`` and
``H2O_TPU_SERVE_MAX_BATCH``, so a move never needs a new graph.

The worker thread scores through ``score_fn``; the registry's batch
bodies name the model's device there, since the current CUDA device is
per thread.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence

from h2o_tpu_torch.core.diag import TimeLine
from h2o_tpu_torch.core.exec_store import bucket_pow2
from h2o_tpu_torch.core.lockwitness import make_lock
from h2o_tpu_torch.core.log import get_logger
from h2o_tpu_torch.core.resilience import Deadline

log = get_logger("serve")


class QueueFull(RuntimeError):
    """Admission queue over capacity — shed load (HTTP 429)."""


class BatcherStopped(RuntimeError):
    """Submitted to (or queued on) a stopped batcher — the deployment
    is gone from this replica, so the REST surface maps it to 404 and
    the fleet router retries the request once on a healthy replica."""


class _Item:
    __slots__ = ("rows", "n", "future", "deadline")

    def __init__(self, rows: Sequence[dict], deadline: Optional[Deadline]):
        self.rows = list(rows)
        self.n = len(self.rows)
        self.future: Future = Future()
        self.deadline = deadline


class MicroBatcher:
    """One worker thread per deployment, coalescing requests."""

    def __init__(self, score_fn: Callable[[List[dict]], "object"],
                 max_batch: int = 32, max_delay_ms: float = 2.0,
                 queue_cap: int = 64, name: str = "serve",
                 on_batch: Optional[Callable[[int, int], None]] = None):
        self.score_fn = score_fn
        self.max_batch = int(max_batch)
        self.max_delay_ms = float(max_delay_ms)
        self.queue_cap = int(queue_cap)
        self.name = name
        self.on_batch = on_batch
        self._q: "queue.Queue[_Item]" = queue.Queue()
        self._pending = 0                 # queued + being scored
        self._plock = make_lock("batcher.MicroBatcher._plock")
        self._stop_evt = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"h2o-serve-{name}")
        self._thread.start()

    # -- admission -----------------------------------------------------------

    @property
    def pending(self) -> int:
        with self._plock:
            return self._pending

    @property
    def stopped(self) -> bool:
        return self._stop_evt.is_set()

    def configure(self, max_batch: Optional[int] = None,
                  max_delay_ms: Optional[float] = None,
                  queue_cap: Optional[int] = None) -> None:
        """Re-tune live (hot-swap or the adaptive tuner).  All three
        knobs land atomically under ``_plock``; the worker snapshots
        them per batch, so a mid-batch call affects only later
        batches."""
        with self._plock:
            if max_batch is not None:
                self.max_batch = int(max_batch)
            if max_delay_ms is not None:
                self.max_delay_ms = float(max_delay_ms)
            if queue_cap is not None:
                self.queue_cap = int(queue_cap)

    def _snapshot(self) -> "tuple[int, float]":
        """One consistent (max_batch, max_delay_ms) view per batch."""
        with self._plock:
            return self.max_batch, self.max_delay_ms

    def submit(self, rows: Sequence[dict],
               deadline: Optional[Deadline] = None) -> Future:
        """Enqueue a request; returns its future.  Raises
        :class:`QueueFull` when the admission queue is at capacity."""
        if self._stop_evt.is_set():
            raise BatcherStopped(f"batcher {self.name} is stopped")
        with self._plock:
            if self._pending >= self.queue_cap:
                raise QueueFull(
                    f"serving queue for {self.name} at capacity "
                    f"({self.queue_cap} in flight); retry later")
            self._pending += 1
        item = _Item(rows, deadline)
        self._q.put(item)
        return item.future

    def _done(self) -> None:
        with self._plock:
            self._pending -= 1

    # -- worker --------------------------------------------------------------

    def _loop(self) -> None:
        while True:
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._stop_evt.is_set():
                    return
                continue
            batch = [first]
            nrows = first.n
            max_batch, max_delay_ms = self._snapshot()
            t_close = time.monotonic() + max_delay_ms / 1000.0
            while nrows < max_batch:
                remaining = t_close - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    it = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                batch.append(it)
                nrows += it.n
            live: List[_Item] = []
            for it in batch:
                if it.deadline is not None and it.deadline.expired:
                    it.future.set_exception(TimeoutError(
                        f"request expired after its "
                        f"{it.deadline.seconds:g}s deadline while queued "
                        f"on {self.name}"))
                    TimeLine.record("serve", "deadline_expired",
                                    deployment=self.name)
                    self._done()
                else:
                    live.append(it)
            if not live:
                continue
            rows: List[dict] = []
            for it in live:
                rows.extend(it.rows)
            try:
                raw = self.score_fn(rows)
            except Exception as e:  # noqa: BLE001 — fan the fault out
                for it in live:
                    it.future.set_exception(e)
                    self._done()
                continue
            if self.on_batch is not None:
                self.on_batch(len(live), len(rows))
            off = 0
            for it in live:
                it.future.set_result(raw[off:off + it.n])
                off += it.n
                self._done()

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the worker (it drains the queue first), then fail
        anything still queued."""
        self._stop_evt.set()
        self._thread.join(timeout)
        while True:
            try:
                it = self._q.get_nowait()
            except queue.Empty:
                break
            it.future.set_exception(BatcherStopped(
                f"deployment {self.name} was undeployed"))
            self._done()


def _pow2(n: int) -> int:
    return bucket_pow2(max(1, int(n)))


class AdaptiveBatchTuner:
    """Measured, bounded retuning of a live :class:`MicroBatcher`.

    Autotuner shape (core/autotune.py): observe a window, decide once,
    apply, observe again — never oscillate per-request.  Signals per
    completed batch: queue depth as a fraction of ``queue_cap`` (demand)
    and batch rows as a fraction of ``max_batch`` (fill).

    - sustained demand (queue > half full on average) doubles
      ``max_batch`` to the next pow2 bucket and stretches
      ``max_delay_ms`` (bigger dispatches amortize better);
    - a sustained idle window (near-empty queue, batches under a
      quarter full) halves ``max_batch`` and relaxes the delay back
      toward its configured base (snappier tail latency).

    Both moves clamp to pow2 within ``[lo, hi]``
    (``H2O_TPU_SERVE_MIN_BATCH`` / ``H2O_TPU_SERVE_MAX_BATCH``), the
    engine's buckets.  Decisions are collected under the tuner's own
    lock and applied through ``MicroBatcher.configure()`` OUTSIDE it
    (no nested lock hold across the batcher's ``_plock``).
    """

    def __init__(self, batcher: MicroBatcher,
                 lo: Optional[int] = None, hi: Optional[int] = None,
                 window: int = 8):
        from h2o_tpu_torch import config
        self.batcher = batcher
        self.lo = _pow2(config.serve_min_batch() if lo is None else lo)
        self.hi = max(self.lo, _pow2(config.serve_max_batch()
                                     if hi is None else hi))
        self.window = max(2, int(window))
        self.base_delay_ms = batcher.max_delay_ms
        self._lock = make_lock("batcher.AdaptiveBatchTuner._lock")
        self._queue_fracs: List[float] = []
        self._fill_fracs: List[float] = []
        self.retunes = 0
        self.grows = 0
        self.shrinks = 0

    def observe(self, queue_depth: int, batch_rows: int) -> None:
        """Feed one completed batch; may apply one bounded retune."""
        apply: Optional["tuple[int, float]"] = None
        with self._lock:
            cur, _ = self.batcher._snapshot()
            cap = max(1, self.batcher.queue_cap)
            self._queue_fracs.append(min(1.0, queue_depth / cap))
            self._fill_fracs.append(min(1.0, batch_rows / max(1, cur)))
            if len(self._queue_fracs) < self.window:
                return
            demand = sum(self._queue_fracs) / len(self._queue_fracs)
            fill = sum(self._fill_fracs) / len(self._fill_fracs)
            del self._queue_fracs[:], self._fill_fracs[:]
            cur = _pow2(min(self.hi, max(self.lo, cur)))
            if demand > 0.5 and cur < self.hi:
                new = min(self.hi, cur * 2)
                delay = min(self.base_delay_ms * 4,
                            self.batcher.max_delay_ms * 1.5)
                self.grows += 1
            elif demand < 0.05 and fill <= 0.25 and cur > self.lo:
                new = max(self.lo, cur // 2)
                delay = max(self.base_delay_ms,
                            self.batcher.max_delay_ms / 1.5)
                self.shrinks += 1
            else:
                if cur != self.batcher.max_batch:
                    apply = (cur, self.batcher.max_delay_ms)  # clamp only
                new, delay = None, None
            if new is not None:
                self.retunes += 1
                apply = (new, delay)
        if apply is not None:
            self.batcher.configure(max_batch=apply[0],
                                   max_delay_ms=apply[1])
            TimeLine.record("serve", "batch_retune",
                            deployment=self.batcher.name,
                            max_batch=apply[0],
                            max_delay_ms=round(apply[1], 3))

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": True, "lo": self.lo, "hi": self.hi,
                    "window": self.window, "retunes": self.retunes,
                    "grows": self.grows, "shrinks": self.shrinks,
                    "max_batch": self.batcher.max_batch,
                    "max_delay_ms": round(self.batcher.max_delay_ms, 3)}
