"""Diagnostics — the parts of ``h2o_tpu/core/diag.py`` the port uses:
:class:`DispatchStats` (``diag.py:33-237``), the per-phase compile,
dispatch and transfer counters; :class:`TimeLine` (``diag.py:240-266``),
the fixed-size event ring of water/TimeLine.java; and
:class:`TransferStats`, the bytes the data-plane verbs moved each way.

A "compile" here is a miss of the executable store
(``core/exec_store.py``): a CUDA graph captured on the card, the first
build of an eager entry on the CPU.  A hit is a cache hit; ``disk_hits``
stays empty, since a CUDA graph cannot be written to disk.

Not ported: the XLA compile listener (``xla_compiles``, there is no
XLA), the per-axis collective accounting (it comes with several
devices, ROADMAP P8), the water meters, ``jstack``, ``Profiler`` and
``device_memory`` (P14b).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

MAX_EVENTS = 2048


class DispatchStats:
    """Per-phase compile/dispatch/transfer counters: a hot loop that
    recompiles a call shows up here as compiles growing with dispatches
    instead of staying flat.  Phases are free-form strings ("serve",
    "tree_block", "munge", ...)."""

    _lock = threading.Lock()
    _compiles: Dict[str, int] = {}
    _dispatches: Dict[str, int] = {}
    _cache_hits: Dict[str, int] = {}
    _disk_hits: Dict[str, int] = {}
    _transfers: Dict[str, int] = {}
    _transfer_bytes: Dict[str, int] = {}
    _host_pulls: Dict[str, int] = {}
    _host_pull_bytes: Dict[str, int] = {}
    _phase_local = threading.local()

    @classmethod
    def _bump(cls, d: Dict[str, int], phase: str, n: int = 1) -> None:
        with cls._lock:
            d[phase] = d.get(phase, 0) + n

    @classmethod
    def note_compile(cls, phase: str) -> None:
        cls._bump(cls._compiles, phase)
        TimeLine.record("dispatch", "compile", phase=phase)

    @classmethod
    def note_dispatch(cls, phase: str) -> None:
        cls._bump(cls._dispatches, phase)

    @classmethod
    def note_cache_hit(cls, phase: str) -> None:
        cls._bump(cls._cache_hits, phase)

    @classmethod
    def note_disk_hit(cls, phase: str) -> None:
        cls._bump(cls._disk_hits, phase)
        TimeLine.record("dispatch", "disk_hit", phase=phase)

    @classmethod
    def note_transfer(cls, phase: str, nbytes: int = 0) -> None:
        cls._bump(cls._transfers, phase)
        cls._bump(cls._transfer_bytes, phase, int(nbytes))

    @classmethod
    def current_phase(cls) -> str:
        """The phase the calling thread attributes host pulls to
        ("unattributed" outside any ``phase_scope``)."""
        return getattr(cls._phase_local, "stack", ["unattributed"])[-1]

    @classmethod
    @contextlib.contextmanager
    def phase_scope(cls, phase: str):
        """Host pulls on this thread inside the scope are attributed to
        ``phase`` (the munge host routes run in ``phase_scope("munge")``)."""
        stack = getattr(cls._phase_local, "stack", None)
        if stack is None:
            stack = cls._phase_local.stack = ["unattributed"]
        stack.append(phase)
        try:
            yield
        finally:
            stack.pop()

    @classmethod
    def note_host_pull(cls, nbytes: int, phase: Optional[str] = None) -> None:
        """One device->host copy of ``nbytes``."""
        p = phase if phase is not None else cls.current_phase()
        cls._bump(cls._host_pulls, p)
        cls._bump(cls._host_pull_bytes, p, int(nbytes))

    @classmethod
    def host_pulls(cls, phase: str) -> int:
        with cls._lock:
            return cls._host_pulls.get(phase, 0)

    @classmethod
    def snapshot(cls) -> Dict[str, Any]:
        with cls._lock:
            return {"compiles": dict(cls._compiles),
                    "dispatches": dict(cls._dispatches),
                    "cache_hits": dict(cls._cache_hits),
                    "disk_hits": dict(cls._disk_hits),
                    "transfers": dict(cls._transfers),
                    "transfer_bytes": dict(cls._transfer_bytes),
                    "host_pulls": dict(cls._host_pulls),
                    "host_pull_bytes": dict(cls._host_pull_bytes)}

    @classmethod
    def reset(cls) -> None:
        """Zero the per-phase counters."""
        with cls._lock:
            for d in (cls._compiles, cls._dispatches, cls._cache_hits,
                      cls._disk_hits, cls._transfers, cls._transfer_bytes,
                      cls._host_pulls, cls._host_pull_bytes):
                d.clear()


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
