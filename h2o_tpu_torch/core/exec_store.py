"""One executable store under the device dispatch caches; port of
``h2o_tpu/core/exec_store.py`` (``bucket_pow2`` :111, ``aval_key`` :118,
``stable_fn_name`` :196, ``ExecStore`` :209-617, ``exec_store`` :620).

The reference's store owns the compiled XLA programs of the serving
engine, the MRTask verbs and the munge kernels: one bounded LRU
(``H2O_TPU_EXEC_STORE`` entries, default 256; ``H2O_TPU_DISPATCH_CACHE``
the legacy spelling), the power-of-two shape buckets, the OOM ladder
around every dispatch, and per-phase counters (``core/diag.py``
``DispatchStats``): a miss is a compile, a hit a cache hit.

PyTorch's counterpart of "compile once for each shape, dispatch
forever" is a captured CUDA graph.  On the card an entry is one
``torch.cuda.CUDAGraph`` (:class:`GraphEntry`):

- static input tensors at the key's shapes; a warm-up call on the
  store's capture stream (lazy initialisations, cuBLAS's workspace, the
  model's device constants) and then the capture, with
  ``capture_error_mode="thread_local"``, so other threads keep running
  eager work meanwhile;
- every graph allocates its intermediates from one memory pool that the
  store shares (``torch.cuda.graph_pool_handle()``); the output is
  copied, inside the graph, into a buffer allocated outside that pool,
  so one graph's replay never writes over another graph's output;
- a call takes the entry's lock, copies its arguments into the static
  inputs, replays the graph and clones the output before it releases
  the lock.  The store's device lock spans each capture and the enqueue
  of each replay, and replays run on the device's default stream, which
  the capture stream is ordered with: no two graphs that share the
  pool's intermediates (or the capture stream's cuBLAS workspace) ever
  run at once;
- an evicted entry's graph is destroyed with its last reference (a call
  in flight finishes on it), which gives its memory back to the pool;
  once no graph of the pool is left, ``torch.cuda.empty_cache()`` gives
  the pool back to the device, and the next capture opens a new pool.

A graph replays the kernels its capture recorded, at the captured
shapes, so its answer is bitwise the eager call's at the same shapes.
On the CPU an entry is the built callable itself, run eagerly; the store
counts it the same way (a miss is one compile, a hit a cache hit), so
the counters equal the reference's for the same sequence of calls.

Differences kept on purpose:

- no donation: :meth:`ExecStore.donation_on` is False, as the
  reference's own policy is on a backend without donation, and there
  is no donating twin;
- no disk layer: a CUDA graph cannot be serialized, so ``disk_hits``
  stays 0 and the reference's ``_disk_*``, trust checks and content
  fingerprint have no counterpart;
- ``cached_kernel`` (the munge verbs' row buckets) and graphs of the
  tree engine's levels come with ROADMAP P14a-ii.
"""

from __future__ import annotations

import os
import threading
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from h2o_tpu_torch.core import lockwitness
from h2o_tpu_torch.core.diag import DispatchStats

_DEFAULT_ENTRIES = 256


def _env_capacity() -> int:
    raw = os.environ.get("H2O_TPU_EXEC_STORE") or \
        os.environ.get("H2O_TPU_DISPATCH_CACHE")
    return int(raw or _DEFAULT_ENTRIES)


def bucket_pow2(n: int) -> int:
    """Smallest power of two >= n — THE shape bucket (serve batches):
    a deployment captures at most log2(max)+1 programs instead of one
    per distinct batch size."""
    return 1 if n <= 1 else 1 << int(n - 1).bit_length()


def aval_key(x) -> Tuple:
    """Hashable signature of one argument: shape, dtype and device for a
    tensor (another device is another program), shape and dtype for a
    numpy array, the value for a hashable static; containers recurse."""
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), str(x.dtype), str(x.device))
    if isinstance(x, np.ndarray):
        return ("np", x.shape, str(x.dtype))
    if isinstance(x, (list, tuple)):
        return ("seq", type(x).__name__, tuple(aval_key(v) for v in x))
    if isinstance(x, dict):
        return ("dict", tuple((k, aval_key(v))
                              for k, v in sorted(x.items())))
    return ("static", type(x).__name__, x)


def stable_fn_name(fn) -> Optional[str]:
    """Cross-process-stable identity for a function, or None when there
    is none: only a plain module-level function qualifies (a closure or
    a ``<locals>`` qualname can capture per-call state)."""
    closure = getattr(fn, "__closure__", None)
    qualname = getattr(fn, "__qualname__", "")
    module = getattr(fn, "__module__", "")
    if closure or not qualname or not module or "<locals>" in qualname:
        return None
    return f"{module}.{qualname}"


def _device_of(args, device) -> torch.device:
    """An entry's device: ``device`` when given, else the first tensor
    argument's, else the CPU."""
    if device is not None:
        return torch.device(device)
    for a in args or ():
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


class GraphEntry:
    """One captured CUDA graph of ``fn`` (module docstring): its
    arguments, tensors or numpy arrays, become static inputs on the
    card; it returns one tensor.  ``pins()``, when given, is called
    after the capture; the entry keeps what it returns alive, since the
    graph reads its memory (a model's device constants)."""

    def __init__(self, fn: Callable, device: torch.device, store: "ExecStore",
                 pins: Optional[Callable[[], Any]] = None):
        self.fn, self.device, self._store = fn, device, store
        self._pins_fn, self._pins = pins, None
        self._lock = threading.Lock()
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._static: list = []
        self._out: Optional[torch.Tensor] = None

    def _copy_in(self, args) -> None:
        for st, a in zip(self._static, args):
            st.copy_(_as_tensor(a))

    def capture(self, args) -> None:
        """Warm up and capture at ``args``' shapes (the store's miss)."""
        dev = self.device
        self._static = [torch.empty(tuple(a.shape), dtype=_as_tensor(a).dtype,
                                    device=dev) for a in args]
        self._copy_in(args)
        s = self._store._capture_stream(dev)
        cur = torch.cuda.current_stream(dev)
        with self._store._device_lock, torch.cuda.device(dev):
            s.wait_stream(cur)
            with torch.cuda.stream(s):
                warm = self.fn(*self._static)
            cur.wait_stream(s)
            self._out = torch.empty_like(warm)
            del warm
            s.wait_stream(cur)
            g = torch.cuda.CUDAGraph()
            pool, _keep = self._store._pool(dev)
            with torch.cuda.stream(s):
                g.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    self._out.copy_(self.fn(*self._static))
                except BaseException:
                    try:
                        g.capture_end()
                    except Exception:  # noqa: BLE001 — the capture's own
                        pass           # error is the one to raise
                    raise
                g.capture_end()
            cur.wait_stream(s)
        self.graph = g
        self._store._note_graph(dev, self)
        if self._pins_fn is not None:
            self._pins = self._pins_fn()

    def __call__(self, *args) -> torch.Tensor:
        with self._lock:
            if self.graph is None:
                self.capture(args)
            dev = self.device
            cur = torch.cuda.current_stream(dev)
            rs = torch.cuda.default_stream(dev)
            with self._store._device_lock, torch.cuda.device(dev):
                if cur != rs:
                    rs.wait_stream(cur)
                with torch.cuda.stream(rs):
                    self._copy_in(args)
                    self.graph.replay()
                    res = self._out.clone()
                if cur != rs:
                    cur.wait_stream(rs)
                    res.record_stream(cur)
        return res


class ExecStore:
    """Bounded LRU of executables: CUDA graphs on the card, eager
    callables on the CPU.  ``misses`` is the capture-or-build count of
    everything routed through the store."""

    def __init__(self, max_entries: Optional[int] = None):
        self.max_entries = int(max_entries or _env_capacity())
        self._lock = lockwitness.make_rlock("exec_store.ExecStore._lock")
        # orders device work across entries: captures, and the enqueue
        # of each replay (copy in, replay, clone out)
        self._device_lock = threading.RLock()
        self._entries: "OrderedDict[Tuple, Any]" = OrderedDict()
        self._pools: Dict[torch.device, Any] = {}
        self._pool_graphs: Dict[torch.device, Any] = {}
        self._streams: Dict[torch.device, Any] = {}
        self.hits = 0
        self.misses = 0
        self.disk_hits = 0
        self.evictions = 0

    # -- donation policy -----------------------------------------------------

    @staticmethod
    def donation_on() -> bool:
        """No buffer donation on this backend (module docstring)."""
        return False

    # -- CUDA resources ------------------------------------------------------

    def _pool(self, dev: torch.device):
        """(the shared pool's handle, a live entry of it).  While a graph
        of the pool lives, the next capture joins it (the returned entry
        keeps the pool alive until the capture has begun); once none is
        left the pool is gone, and a new one is opened: a dead pool's
        handle may not be captured into again."""
        with self._lock:
            keep = next(iter(self._pool_graphs.get(dev, ())), None)
            if keep is None or dev not in self._pools:
                self._pools[dev] = torch.cuda.graph_pool_handle()
                self._pool_graphs[dev] = weakref.WeakSet()
            return self._pools[dev], keep

    def _note_graph(self, dev: torch.device, entry: "GraphEntry") -> None:
        with self._lock:
            self._pool_graphs.setdefault(dev, weakref.WeakSet()).add(entry)

    def _capture_stream(self, dev: torch.device):
        with self._lock:
            if dev not in self._streams:
                self._streams[dev] = torch.cuda.Stream(dev)
            return self._streams[dev]

    # -- fetch-or-build ------------------------------------------------------

    def get_or_build(self, phase: str, key: Tuple,
                     build: Callable[[], Callable], *,
                     args: Optional[Tuple] = None, device=None,
                     pins: Optional[Callable[[], Any]] = None):
        """Fetch the executable for ``key``, building it at most once
        process-wide.  ``build()`` returns the raw callable.  On a CUDA
        ``device`` (else the first tensor argument's) the entry is a
        :class:`GraphEntry`, captured here at ``args``' shapes when
        ``args`` is given, else at its first call; on the CPU it is the
        callable itself."""
        k = (phase,) + tuple(key)
        with self._lock:
            fn = self._entries.get(k)
            if fn is not None:
                self._entries.move_to_end(k)
                self.hits += 1
        if fn is not None:
            DispatchStats.note_cache_hit(phase)
            return fn
        # build outside the lock: a capture can be slow; a rare
        # concurrent double build is harmless (last writer wins)
        dev = _device_of(args, device)
        fn = build()
        if dev.type == "cuda":
            fn = GraphEntry(fn, dev, self, pins)
            if args is not None:
                fn.capture(tuple(args))
        self._insert(k, fn)
        DispatchStats.note_compile(phase)
        return fn

    def _insert(self, k: Tuple, fn) -> None:
        with self._lock:
            self._entries[k] = fn
            self.misses += 1
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.evictions += 1

    # -- dispatch under the OOM ladder --------------------------------------

    def dispatch(self, phase: str, key: Tuple,
                 build: Callable[[], Callable], args: Tuple, *,
                 site: Optional[str] = None, device=None,
                 pins: Optional[Callable[[], Any]] = None,
                 shrink: Optional[Callable[[], bool]] = None,
                 host_fallback: Optional[Callable[[], object]] = None,
                 on_oom: Optional[Callable] = None):
        """Fetch-or-build, then run under the OOM degradation ladder
        (``core/oom.py``).  The fetch is inside the ladder's attempt, so
        an OOM while a graph is captured walks the ladder as one at its
        replay or its output's copy does; a fetch that succeeded is not
        repeated by a retry."""
        from h2o_tpu_torch.core.oom import oom_ladder
        lockwitness.note_device_dispatch(site or phase)
        DispatchStats.note_dispatch(phase)
        state: Dict[str, Any] = {}

        def attempt():
            if "fn" not in state:
                state["fn"] = self.get_or_build(phase, key, build, args=args,
                                                device=device, pins=pins)
            return state["fn"](*args)

        return oom_ladder(site or phase, attempt, shrink=shrink,
                          host_fallback=host_fallback, on_oom=on_oom)

    # -- lifecycle / observability ------------------------------------------

    def evict(self, match: Callable[[Tuple], bool]) -> int:
        """Drop every entry whose full key (phase-prefixed tuple)
        matches — undeploy/rollback of a serve version, tests."""
        with self._lock:
            victims = [k for k in self._entries if match(k)]
            for k in victims:
                self._entries.pop(k, None)
            return len(victims)

    def keys(self) -> list:
        """Snapshot of live entry keys (the serve engine reconciles its
        bucket bookkeeping against it)."""
        with self._lock:
            return list(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def kernel_names(self) -> Dict[str, list]:
        """Distinct named entries per phase (keys shaped ``(phase, name,
        ...)``)."""
        out: Dict[str, set] = {}
        with self._lock:
            for k in self._entries:
                if len(k) >= 2 and isinstance(k[0], str) and \
                        isinstance(k[1], str):
                    out.setdefault(k[0], set()).add(k[1])
        return {ph: sorted(names) for ph, names in sorted(out.items())}

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            graphs = sum(isinstance(e, GraphEntry)
                         for e in self._entries.values())
            return {"entries": len(self._entries),
                    "capacity": self.max_entries,
                    "hits": self.hits, "misses": self.misses,
                    "graph_entries": graphs,
                    "evictions": self.evictions,
                    "disk_hits": self.disk_hits,
                    "kernels": self.kernel_names()}


_STORE: Optional[ExecStore] = None
_STORE_LOCK = lockwitness.make_lock("exec_store._STORE_LOCK")


def exec_store() -> ExecStore:
    """The process-wide executable store."""
    global _STORE
    if _STORE is None:
        with _STORE_LOCK:
            if _STORE is None:
                _STORE = ExecStore()
    return _STORE
