"""Runtime lock witness — port of ``h2o_tpu/core/lockwitness.py``,
copied.

It records what threads actually do with the port's named locks:

- :func:`make_lock` / :func:`make_rlock` are drop-in factories the store,
  serving layers and the host services under them use instead of
  ``threading.Lock()`` / ``threading.RLock()``.  With
  ``H2O_TPU_LOCK_WITNESS`` unset they return the plain ``threading``
  primitive — zero overhead by construction, not by branch.  With the
  knob on (the test suite's conftest sets it) they return a thin
  wrapper that appends to a per-thread held-stack and records
  first-seen acquisition-order edges;
- the edge graph is keyed on lock INSTANCES (``(name, id)``) — many
  ``Deployment.lock`` instances share a name, and two deployments' locks
  taken around the registry lock in opposite orders is NOT a deadlock,
  so name-keyed edges would cry wolf.  Names are collapsed only for
  display;
- each new edge stores the acquiring thread's stack at the moment the
  inner lock was taken while the outer was held — :meth:`find_cycles`
  renders BOTH witnessed stacks of an inversion;
- :func:`note_device_dispatch` records device work dispatched while any
  witnessed lock is held (device work can block for a long time; no
  guarded lock may span it).

Steady-state cost when on: one thread-local list append per acquire and
one dict hit per already-seen edge; stacks are captured only the first
time an edge appears.  The witness never blocks witnessed threads on
each other — its one internal mutex is private and leaf-level.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Dict, List, Optional, Tuple

_TRUE = ("1", "on", "true", "yes")

_MAX_EDGES = 4096          # distinct (outer, inner) instance pairs kept
_MAX_DISPATCH_SITES = 512  # distinct (site, held-locks) records
_STACK_LIMIT = 18


def enabled() -> bool:
    """H2O_TPU_LOCK_WITNESS: instrument the named lock families at
    CREATION time (the conftest sets it before any h2o_tpu_torch import, so
    module-level locks are covered too)."""
    return os.environ.get("H2O_TPU_LOCK_WITNESS", "").strip().lower() \
        in _TRUE


Node = Tuple[str, int]            # (registered name, id(wrapper))


class WitnessRegistry:
    """One acquisition-order graph + held-dispatch record set.  The
    package uses the module singleton; tests plant deliberate
    inversions on PRIVATE registries so the real graph stays clean."""

    def __init__(self):
        self._mu = threading.Lock()       # internal — never witnessed
        self._tls = threading.local()
        # (outer Node, inner Node) -> {"count", "stack", "thread"}
        self._edges: Dict[Tuple[Node, Node], Dict] = {}
        self._held_dispatches: Dict[Tuple, Dict] = {}
        self.acquisitions = 0
        self.locks_created = 0
        self.edges_dropped = 0            # past _MAX_EDGES

    # -- held stack ---------------------------------------------------------

    def _held(self) -> List[List]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st                          # entries: [witness, count]

    def held_names(self) -> List[str]:
        return [w._name for w, _n in self._held()]

    # -- event hooks (called by the wrappers) -------------------------------

    def _on_acquire(self, witness: "_WitnessLock") -> None:
        held = self._held()
        self.acquisitions += 1
        for entry in held:
            if entry[0] is witness:        # RLock re-entry: no new edge
                entry[1] += 1
                return
        node = (witness._name, id(witness))
        new_edges = []
        for outer, _n in held:
            pair = ((outer._name, id(outer)), node)
            if pair not in self._edges:
                new_edges.append(pair)
        if new_edges:
            stack = "".join(traceback.format_stack(limit=_STACK_LIMIT)[:-2])
            with self._mu:
                for pair in new_edges:
                    if pair in self._edges:
                        self._edges[pair]["count"] += 1
                    elif len(self._edges) >= _MAX_EDGES:
                        self.edges_dropped += 1
                    else:
                        self._edges[pair] = {
                            "count": 1, "stack": stack,
                            "thread": threading.current_thread().name}
        elif held:
            with self._mu:
                for outer, _n in held:
                    pair = ((outer._name, id(outer)), node)
                    if pair in self._edges:
                        self._edges[pair]["count"] += 1
        held.append([witness, 1])

    def _on_release(self, witness: "_WitnessLock") -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is witness:
                held[i][1] -= 1
                if held[i][1] <= 0:
                    del held[i]
                return

    def note_device_dispatch(self, site: str) -> None:
        held = self._held()
        if not held:
            return
        names = tuple(w._name for w, _n in held)
        key = (site, names)
        if key in self._held_dispatches:
            with self._mu:
                rec = self._held_dispatches.get(key)
                if rec is not None:
                    rec["count"] += 1
            return
        stack = "".join(traceback.format_stack(limit=_STACK_LIMIT)[:-1])
        with self._mu:
            if len(self._held_dispatches) < _MAX_DISPATCH_SITES:
                self._held_dispatches.setdefault(key, {
                    "site": site, "locks": list(names), "count": 0,
                    "stack": stack,
                    "thread": threading.current_thread().name})
                self._held_dispatches[key]["count"] += 1

    # -- analysis -----------------------------------------------------------

    def instance_edges(self) -> Dict[Tuple[Node, Node], Dict]:
        with self._mu:
            return dict(self._edges)

    def name_edges(self) -> Dict[Tuple[str, str], int]:
        """Edge multiset collapsed to names — the display graph
        (instance identity dropped)."""
        out: Dict[Tuple[str, str], int] = {}
        with self._mu:
            for (a, b), rec in self._edges.items():
                k = (a[0], b[0])
                out[k] = out.get(k, 0) + rec["count"]
        return out

    def held_dispatches(self) -> List[Dict]:
        with self._mu:
            return [dict(v) for v in self._held_dispatches.values()]

    def find_cycles(self) -> List[Dict]:
        """Cycles in the INSTANCE-level acquisition graph.  Each cycle
        carries every participating edge with its first-seen stack —
        the two-edge case is the classic A->B / B->A inversion and the
        finding renders both witnessed stacks."""
        edges = self.instance_edges()
        adj: Dict[Node, List[Node]] = {}
        for a, b in edges:
            adj.setdefault(a, []).append(b)
        cycles, seen = [], set()
        state: Dict[Node, int] = {}        # 0 absent, 1 on path, 2 done

        def dfs(n: Node, path: List[Node]):
            state[n] = 1
            path.append(n)
            for m in adj.get(n, ()):
                if state.get(m, 0) == 1:
                    cyc = path[path.index(m):]
                    lo = min(range(len(cyc)), key=lambda i: cyc[i])
                    canon = tuple(cyc[lo:] + cyc[:lo])
                    if canon in seen:
                        continue
                    seen.add(canon)
                    ring = list(canon) + [canon[0]]
                    cycles.append({
                        "names": [n0[0] for n0 in canon],
                        "edges": [
                            {"outer": ring[i][0], "inner": ring[i + 1][0],
                             **{k: v for k, v in edges[
                                 (ring[i], ring[i + 1])].items()}}
                            for i in range(len(canon))],
                    })
                elif state.get(m, 0) == 0:
                    dfs(m, path)
            path.pop()
            state[n] = 2

        for n in list(adj):
            if state.get(n, 0) == 0:
                dfs(n, [])
        return cycles

    def stats(self) -> Dict:
        with self._mu:
            return {"locks_created": self.locks_created,
                    "acquisitions": self.acquisitions,
                    "edges": len(self._edges),
                    "edges_dropped": self.edges_dropped,
                    "held_dispatches": len(self._held_dispatches)}

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()
            self._held_dispatches.clear()
            self.acquisitions = 0
            self.edges_dropped = 0


class _WitnessLock:
    """Context-manager/acquire-release wrapper over one threading
    primitive.  All witnessed call sites use ``with``; acquire/release
    are kept API-compatible for completeness."""

    def __init__(self, name: str, inner, registry: WitnessRegistry):
        self._name = name
        self._inner = inner
        self._reg = registry
        registry.locks_created += 1

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._reg._on_acquire(self)
        return ok

    def release(self):
        self._reg._on_release(self)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    def __repr__(self):
        return f"<witness {self._name} over {self._inner!r}>"


_REGISTRY = WitnessRegistry()


def registry() -> WitnessRegistry:
    """The process-wide witness graph (the tests read its cycles)."""
    return _REGISTRY


def make_lock(name: str, _registry: Optional[WitnessRegistry] = None):
    """``threading.Lock()`` replacement for the named lock families.
    Plain lock when the witness is off (decided at creation)."""
    if _registry is None and not enabled():
        return threading.Lock()
    return _WitnessLock(name, threading.Lock(), _registry or _REGISTRY)


def make_rlock(name: str, _registry: Optional[WitnessRegistry] = None):
    """``threading.RLock()`` replacement — re-entrant acquisitions by
    the owning thread record no order edge."""
    if _registry is None and not enabled():
        return threading.RLock()
    return _WitnessLock(name, threading.RLock(), _registry or _REGISTRY)


def note_device_dispatch(site: str) -> None:
    """Device dispatch hook: record when device work is
    dispatched while the calling thread holds any witnessed lock."""
    if not enabled():
        return
    _REGISTRY.note_device_dispatch(site)
