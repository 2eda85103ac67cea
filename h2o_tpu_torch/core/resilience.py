"""Resilience primitives: retry/backoff policies and deadlines — port of
``h2o_tpu/core/resilience.py``, copied.

The reference platform survives an unreliable substrate by retrying and
deduplicating every RPC (exercised by ``-random_udp_drop``,
water/H2O.java:446) and by bounding work with cooperative stop checks.
The TPU rebuild's equivalent fault surface is HOST I/O (persist byte
stores, recovery snapshots) and hung control-plane jobs, so the
machinery lives here:

- :class:`RetryPolicy` — exponential backoff + jitter with
  retryable-vs-permanent error classification, a per-call attempt cap
  and a total wall-clock deadline across attempts;
- :class:`Deadline` — a monotonic-clock budget that cooperating loops
  poll (``check()`` raises ``TimeoutError`` once expired), shared by the
  retry loop and the serving layers' per-request deadlines
  (serve/batcher.py, serve/registry.py).

The process-wide ``default_policy()`` (the persist byte stores' and the
stream reader's retries) is built once from the environment, as the
reference's (``resilience.py:197-221``):

- ``H2O_TPU_RETRY_MAX_ATTEMPTS``   (default 4)
- ``H2O_TPU_RETRY_BASE_DELAY``     (seconds, default 0.05)
- ``H2O_TPU_RETRY_MAX_DELAY``      (seconds, default 2.0)
- ``H2O_TPU_RETRY_TOTAL_DEADLINE`` (seconds across all attempts,
  default 60; 0 disables)

Every retry is observable: ``stats()`` returns cumulative counters
(attempts/retries/recoveries/giveups) that chaos tests assert against
and a later ``GET /3/Resilience`` exposes.
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
from typing import Callable, Optional, Tuple

from h2o_tpu_torch.core.log import get_logger

log = get_logger("resilience")


# -- observability -----------------------------------------------------------

_stats_lock = threading.Lock()
_stats = {"attempts": 0, "retries": 0, "recoveries": 0, "giveups": 0,
          "permanent_failures": 0}


def stats() -> dict:
    """Cumulative retry counters (process-wide)."""
    with _stats_lock:
        return dict(_stats)


def reset_stats() -> None:
    with _stats_lock:
        for k in _stats:
            _stats[k] = 0


def _bump(key: str, n: int = 1) -> None:
    with _stats_lock:
        _stats[key] += n


# -- deadlines ---------------------------------------------------------------

class Deadline:
    """A wall-clock budget on the monotonic clock.

    ``Deadline(0)`` / ``Deadline(None)`` never expires, so callers can
    thread one through unconditionally.
    """

    def __init__(self, seconds: Optional[float] = None):
        self.seconds = float(seconds) if seconds else 0.0
        self._t_end = (time.monotonic() + self.seconds) \
            if self.seconds > 0 else None

    def remaining(self) -> float:
        """Seconds left (``inf`` when unbounded, clamped at 0)."""
        if self._t_end is None:
            return float("inf")
        return max(0.0, self._t_end - time.monotonic())

    @property
    def expired(self) -> bool:
        return self._t_end is not None and time.monotonic() >= self._t_end

    def check(self, what: str = "operation") -> None:
        """Cooperative poll: raise once the budget is spent."""
        if self.expired:
            raise TimeoutError(
                f"{what} exceeded its {self.seconds:g}s deadline")

    def __repr__(self):
        return f"Deadline({self.seconds:g}s, {self.remaining():.3g}s left)"


# -- error classification ----------------------------------------------------

# OSError covers ConnectionError, socket errors, and (3.10+) the builtin
# TimeoutError — the transient-substrate surface.  Filesystem errors that
# retrying cannot fix are carved back out below.
_RETRYABLE_DEFAULT: Tuple[type, ...] = (OSError,)
_PERMANENT_DEFAULT: Tuple[type, ...] = (
    FileNotFoundError, PermissionError, IsADirectoryError,
    NotADirectoryError, NotImplementedError, ValueError, TypeError,
    KeyError)

# HTTP status codes worth retrying (timeouts, throttles, server faults)
_RETRYABLE_HTTP = frozenset({408, 425, 429, 500, 502, 503, 504})


def is_retryable(exc: BaseException,
                 retryable: Tuple[type, ...] = _RETRYABLE_DEFAULT,
                 permanent: Tuple[type, ...] = _PERMANENT_DEFAULT) -> bool:
    """Transient (worth another attempt) vs permanent classification."""
    # HTTPError first: it is an OSError subclass but carries a status
    code = getattr(exc, "code", None)
    if code is not None and isinstance(code, int) and \
            exc.__class__.__name__ == "HTTPError":
        return code in _RETRYABLE_HTTP
    if isinstance(exc, permanent):
        return False
    return isinstance(exc, retryable)


# -- retry policy ------------------------------------------------------------

@dataclasses.dataclass
class RetryPolicy:
    """Exponential backoff + full jitter over a classified error set.

    ``call(fn, *args)`` runs ``fn`` up to ``max_attempts`` times, sleeping
    ``min(base_delay * multiplier**attempt, max_delay)`` scaled by a
    uniform jitter between attempts, and giving up early when the
    ``total_deadline`` (or an explicit :class:`Deadline`) runs out or the
    error classifies as permanent.
    """

    max_attempts: int = 4
    base_delay: float = 0.05
    max_delay: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5            # delay *= uniform(1-jitter, 1)
    total_deadline: float = 60.0   # 0 = unbounded
    retryable: Tuple[type, ...] = _RETRYABLE_DEFAULT
    permanent: Tuple[type, ...] = _PERMANENT_DEFAULT

    def backoff(self, attempt: int) -> float:
        """Sleep before attempt ``attempt`` (1-based retry index)."""
        d = min(self.base_delay * (self.multiplier ** (attempt - 1)),
                self.max_delay)
        if self.jitter > 0:
            d *= random.uniform(1.0 - self.jitter, 1.0)
        return d

    def call(self, fn: Callable, *args, what: str = "",
             deadline: Optional[Deadline] = None, **kwargs):
        """Run ``fn(*args, **kwargs)`` with retries; returns its result."""
        what = what or getattr(fn, "__name__", "operation")
        dl = deadline or Deadline(self.total_deadline)
        attempt = 0
        while True:
            attempt += 1
            _bump("attempts")
            try:
                result = fn(*args, **kwargs)
                if attempt > 1:
                    _bump("recoveries")
                    log.info("%s recovered on attempt %d", what, attempt)
                return result
            except BaseException as e:  # noqa: BLE001 — reclassified below
                if not is_retryable(e, self.retryable, self.permanent):
                    _bump("permanent_failures")
                    raise
                if attempt >= self.max_attempts:
                    _bump("giveups")
                    raise
                pause = self.backoff(attempt)
                if dl.expired or pause > dl.remaining():
                    _bump("giveups")
                    raise
                _bump("retries")
                log.warning("%s failed (attempt %d/%d): %r — retrying "
                            "in %.3fs", what, attempt, self.max_attempts,
                            e, pause)
                time.sleep(pause)


# -- process default (env-tunable, like core/chaos.py) -----------------------

_default: Optional[RetryPolicy] = None
_default_lock = threading.Lock()


def default_policy() -> RetryPolicy:
    """The process-wide policy, built once from ``H2O_TPU_RETRY_*`` env."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                e = os.environ.get
                _default = RetryPolicy(
                    max_attempts=int(e("H2O_TPU_RETRY_MAX_ATTEMPTS", 4)),
                    base_delay=float(e("H2O_TPU_RETRY_BASE_DELAY", 0.05)),
                    max_delay=float(e("H2O_TPU_RETRY_MAX_DELAY", 2.0)),
                    total_deadline=float(
                        e("H2O_TPU_RETRY_TOTAL_DEADLINE", 60.0)))
    return _default


def set_default_policy(policy: Optional[RetryPolicy]) -> None:
    """Override (or with ``None`` re-derive from env) the process policy."""
    global _default
    with _default_lock:
        _default = policy
