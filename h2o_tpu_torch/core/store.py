"""DKV — the host key/value store; port of ``h2o_tpu/core/store.py``.

In the reference, every distributed object (Frame, Vec, Chunk, Model, Job) is
a ``Value`` homed on a node by its ``Key`` hash, with cached remote reads and
invalidate-on-put coherence (water/DKV.java:1-52, water/Key.java:91-182,
water/TaskInvalidateKey.java).  What remains on one host is a metadata
store for named objects with the reference's locking discipline
(water/Lockable.java) and leak-tracked scopes (water/Scope.java).

One difference from ``h2o_tpu``: there the process-wide store hangs off
the cloud object (``cloud().dkv``); the port's ``cloud()`` is a
``torch.device`` (core/device.py), so the process-wide store is the
module singleton :func:`dkv`, which :class:`Scope` and the serving fleet
(serve/replica.py) read.  Builds publish their models and frames in it
(``models/model.py``), and grids, segment models and AutoML runs too.
"""

from __future__ import annotations

import contextlib
import fnmatch
import threading
import time
import uuid
from typing import Any, Dict, Iterator, List, Optional

from h2o_tpu_torch.core.diag import TimeLine
from h2o_tpu_torch.core.lockwitness import make_lock, make_rlock


class Key(str):
    """A DKV key: just a unique name.  ``make`` mirrors water.Key.make()."""

    @staticmethod
    def make(prefix: str = "key") -> "Key":
        return Key(f"{prefix}_{uuid.uuid4().hex[:12]}")


class LockedException(Exception):
    pass


class _Entry:
    __slots__ = ("value", "write_locked", "read_locks", "put_time")

    def __init__(self, value: Any):
        self.value = value
        self.write_locked = False
        self.read_locks = 0
        self.put_time = time.time()


class DKV:
    """Host metadata store with Lockable semantics."""

    def __init__(self):
        self._store: Dict[Key, _Entry] = {}
        self._lock = make_rlock("store.DKV._lock")

    # -- basic ops (DKV.put/get/remove) ------------------------------------

    def put(self, key: str, value: Any) -> Key:
        key = Key(key)
        with self._lock:
            e = self._store.get(key)
            if e is not None and e.write_locked:
                raise LockedException(f"{key} is write-locked")
            self._store[key] = _Entry(value)
        TimeLine.record("dkv", "put", key=str(key),
                        type=type(value).__name__)
        return key

    def get(self, key: str, default=None) -> Any:
        with self._lock:
            e = self._store.get(Key(key))
            return default if e is None else e.value

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return Key(key) in self._store

    def remove(self, key: str, force: bool = False) -> None:
        """Delete a key.  Respects the Lockable discipline like ``put``:
        removing a write-locked entry raises :class:`LockedException`
        unless ``force=True`` — the escape hatch for job-cleanup paths
        (Scope teardown, remove-all, shutdown) that legitimately tear
        down mid-build state."""
        with self._lock:
            e = self._store.get(Key(key))
            if e is not None and e.write_locked and not force:
                raise LockedException(f"{key} is write-locked")
            self._store.pop(Key(key), None)

    def keys(self, pattern: str = "*") -> List[Key]:
        with self._lock:
            return [k for k in self._store if fnmatch.fnmatch(k, pattern)]

    # -- locking (water/Lockable.java) -------------------------------------

    def write_lock(self, key: str) -> None:
        with self._lock:
            e = self._store.get(Key(key))
            if e is None:
                raise KeyError(key)
            if e.write_locked or e.read_locks:
                raise LockedException(f"{key} already locked")
            e.write_locked = True

    def unlock(self, key: str) -> None:
        with self._lock:
            e = self._store.get(Key(key))
            if e is not None:
                e.write_locked = False

    def read_lock(self, key: str) -> None:
        with self._lock:
            e = self._store.get(Key(key))
            if e is None:
                raise KeyError(key)
            if e.write_locked:
                raise LockedException(f"{key} is write-locked")
            e.read_locks += 1

    def read_unlock(self, key: str) -> None:
        with self._lock:
            e = self._store.get(Key(key))
            if e is not None and e.read_locks > 0:
                e.read_locks -= 1

    # -- atomic update (water/Atomic.java CAS-on-home-node) ----------------

    def atomic(self, key: str, fn, force: bool = False) -> Any:
        """Atomically transform the value under ``key``; returns new
        value.  A write-locked entry raises :class:`LockedException`
        (the same discipline ``put`` enforces — an atomic update is
        still a replace) unless ``force=True``."""
        with self._lock:
            e = self._store.get(Key(key))
            if e is not None and e.write_locked and not force:
                raise LockedException(f"{key} is write-locked")
            old = None if e is None else e.value
            new = fn(old)
            self._store[Key(key)] = _Entry(new)
            return new


class Scope:
    """Leak tracking for temporary keys (water/Scope.java).

    Used as a context manager: keys entered via ``track`` are removed on exit
    unless protected.  The reference's H2ORunner leaked-key check (SURVEY §4)
    becomes: assert the store is empty of scope-tracked keys after each test.
    """

    _tls = threading.local()

    def __init__(self, dkv: Optional[DKV] = None):
        self.dkv = dkv or _dkv_singleton()
        self.tracked: List[Key] = []
        self.protected: set = set()

    def __enter__(self) -> "Scope":
        stack = getattr(Scope._tls, "stack", None)
        if stack is None:
            stack = Scope._tls.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        Scope._tls.stack.pop()
        for k in self.tracked:
            if k not in self.protected:
                # cleanup path: a tracked temp may die write-locked when
                # its builder failed mid-run — force the leak purge
                self.dkv.remove(k, force=True)
        return None

    def track(self, key: str) -> Key:
        self.tracked.append(Key(key))
        return Key(key)

    def protect(self, key: str) -> Key:
        self.protected.add(Key(key))
        return Key(key)

    @staticmethod
    def current() -> Optional["Scope"]:
        stack = getattr(Scope._tls, "stack", None)
        return stack[-1] if stack else None


_instance: Optional[DKV] = None
_instance_lock = make_lock("store._instance_lock")


def dkv() -> DKV:
    """The process-wide store (``cloud().dkv`` in ``h2o_tpu``)."""
    global _instance
    if _instance is None:
        with _instance_lock:
            if _instance is None:
                _instance = DKV()
    return _instance


@contextlib.contextmanager
def unpublish_on_exit(store: Optional[DKV] = None) -> Iterator[DKV]:
    """On exit, remove every key put in ``store`` (the process DKV by
    default) since entry, forced as a leaked key is: the models and
    frames a test or a smoke phase published."""
    s = store or dkv()
    before = set(s.keys())
    try:
        yield s
    finally:
        for k in set(s.keys()) - before:
            s.remove(k, force=True)


# Scope's parameter keeps the reference's name ``dkv``; this reaches the
# function from inside it
_dkv_singleton = dkv
