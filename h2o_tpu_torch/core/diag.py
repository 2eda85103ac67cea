"""Diagnostics — the parts of ``h2o_tpu/core/diag.py`` the port uses:
:class:`TimeLine` (``diag.py:240-266``), the fixed-size event ring of
water/TimeLine.java, and :class:`TransferStats`, the byte counts of the
reference's ``DispatchStats.note_transfer`` / host pulls.

The reference module also holds the rest of ``DispatchStats`` with its
XLA compile listener, the water meters, ``jstack``, ``Profiler`` and
``device_memory``; they come with later slices (ROADMAP P13/P14).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List

MAX_EVENTS = 2048


class TimeLine:
    """Fixed-size event ring (water/TimeLine.java)."""

    _events: deque = deque(maxlen=MAX_EVENTS)
    _lock = threading.Lock()
    _enabled = True

    @classmethod
    def record(cls, kind: str, what: str, **info) -> None:
        if not cls._enabled:
            return
        ev = {"ns": time.time_ns(), "kind": kind, "what": what,
              "thread": threading.get_ident(), **info}
        with cls._lock:
            cls._events.append(ev)

    @classmethod
    def snapshot(cls) -> List[Dict[str, Any]]:
        """Consistent copy of the ring (TimelineSnapshot analog)."""
        with cls._lock:
            return list(cls._events)

    @classmethod
    def clear(cls) -> None:
        with cls._lock:
            cls._events.clear()


class TransferStats:
    """Bytes the data-plane verbs moved between the host and the device,
    by direction (``to_device``, ``to_host``)."""

    _bytes: Dict[str, int] = {"to_device": 0, "to_host": 0}
    _lock = threading.Lock()

    @classmethod
    def note(cls, direction: str, nbytes: int) -> None:
        with cls._lock:
            cls._bytes[direction] += int(nbytes)

    @classmethod
    def snapshot(cls) -> Dict[str, int]:
        with cls._lock:
            return dict(cls._bytes)

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            for k in cls._bytes:
                cls._bytes[k] = 0
