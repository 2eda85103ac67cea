"""Device-OOM recovery — the degradation ladder; port of
``h2o_tpu/core/oom.py`` (``OOMError`` :61-84, ``fused_fallback``
:126-150, ``is_device_oom`` :153-172, the rung counters :205-238,
``sweep_retries`` :243, ``_diagnostic`` :251, ``oom_ladder`` :269-327).

``oom_ladder(site, attempt, ...)`` wraps the device dispatch choke
points — the executable store's ``dispatch`` (``core/exec_store.py``),
the serving engine's batch predict, the tree driver's blocks and the
Rapids munge verbs — and walks a ladder on :func:`is_device_oom`
failures:

(a) **sweep** — ``MemoryManager.sweep()`` (the caching allocator hands
    its free blocks back to the device) and retry at the same work
    quantum, ``sweep_retries()`` times (``H2O_TPU_OOM_SWEEP_RETRIES``,
    default 2);
(b) **shrink** — the caller's ``shrink()`` reduces the work quantum
    (halve the tree block, split the serve micro-batch) and the call is
    retried until ``shrink()`` returns False: smaller quanta, the same
    answer;
(c) **host fallback** — the caller's host route (the numpy scorer, the
    munge verbs' host routes);
(d) **terminal** — :class:`OOMError` with a diagnostic of what the
    caching allocator holds.  It is an ordinary exception: it fails the
    job through the job registry, never the process.

A device OOM is ``torch.cuda.OutOfMemoryError`` or the chaos injector's
``ChaosOOMError`` (``H2O_TPU_CHAOS_OOM_TRANSIENT=N`` fails the first N
attempts at each site, ``core/chaos.py`` ``maybe_oom``); every other
exception propagates untouched.  ``fused_fallback`` is the planner's
region rung: a fused Rapids region that runs out of device memory (its
own ``H2O_TPU_CHAOS_REGION_OOM_TRANSIENT``) replays as the eager
per-verb chain, bitwise the same frame.

Not ported: ``kernel_fallback`` and ``is_kernel_compile_failure``
(:90-123) — a hand-written kernel that fails to build or launch raises,
and never gives way to its plain version, so the ``kernel_fallbacks``
counter stays 0; ``is_device_loss`` (:184) comes with membership
(ROADMAP P14b).
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, Optional

import torch

from h2o_tpu_torch.core.chaos import ChaosOOMError, chaos
from h2o_tpu_torch.core.log import get_logger

log = get_logger("oom")


class OOMError(RuntimeError):
    """Terminal rung of the ladder: device memory exhausted at ``site``
    and every recovery rung failed.  Fails the job, never the process.

    Single-argument construction keeps a preformatted message — the job
    registry clones a failed job's exception as ``type(exc)(*exc.args)``
    and must get the same text back."""

    def __init__(self, site: str, diagnostic: Optional[str] = None):
        if diagnostic is None:
            super().__init__(str(site))
            self.site = ""
        else:
            super().__init__(
                f"device out of memory at {site} after exhausting the "
                f"degradation ladder (sweep -> shrink -> fallback); "
                f"{diagnostic}")
            self.site = site


def is_device_oom(exc: BaseException) -> bool:
    """True for a recoverable device allocation failure: PyTorch's CUDA
    ``OutOfMemoryError`` or an injected ``ChaosOOMError``.  A terminal
    :class:`OOMError` is not recoverable: the ladder already ran."""
    return isinstance(exc, (torch.cuda.OutOfMemoryError, ChaosOOMError))


# -- observability -----------------------------------------------------------

_RUNGS = ("oom_events", "sweeps", "shrinks", "host_fallbacks",
          "kernel_fallbacks", "unfused_fallbacks", "terminal")

_stats_lock = threading.Lock()
_sites: Dict[str, Dict[str, int]] = {}


def _note(site: str, rung: str, n: int = 1) -> None:
    with _stats_lock:
        d = _sites.setdefault(site, {r: 0 for r in _RUNGS})
        d[rung] += n


def stats() -> dict:
    """Cumulative ladder counters: totals plus the per-site breakdown."""
    with _stats_lock:
        sites = {s: dict(d) for s, d in _sites.items()}
    return {
        "oom_events": sum(d["oom_events"] for d in sites.values()),
        "sweeps": sum(d["sweeps"] for d in sites.values()),
        "degradations": sum(d["shrinks"] + d["host_fallbacks"] +
                            d["kernel_fallbacks"] + d["unfused_fallbacks"]
                            for d in sites.values()),
        "terminal_failures": sum(d["terminal"] for d in sites.values()),
        "sites": sites,
    }


def reset_stats() -> None:
    with _stats_lock:
        _sites.clear()


# -- the region rung ---------------------------------------------------------

def fused_fallback(site: str, run_fused: Callable[[], object],
                   run_unfused: Callable[[], object]):
    """Run a planner-fused Rapids region; on a device OOM or a terminal
    :class:`OOMError` count the ``unfused_fallbacks`` rung at ``site``
    and return ``run_unfused()``, the eager per-verb chain.  Everything
    else propagates.  The chaos injector's region OOM fires here, before
    the fused run.  The replay starts after the exception is dropped, so
    the fused run's tensors, which its traceback holds, are free by
    then."""
    try:
        chaos().maybe_region_oom(site)
        return run_fused()
    except Exception as e:  # noqa: BLE001 — reclassified below
        if not (isinstance(e, OOMError) or is_device_oom(e)):
            raise
        why = str(e)[:200]
    _note(site, "unfused_fallbacks")
    log.warning("%s: fused region ran out of device memory (%s); "
                "degrading to the unfused per-verb chain", site, why)
    return run_unfused()


# -- the ladder --------------------------------------------------------------

def sweep_retries() -> int:
    """Rung (a) bound: sweep-then-retry attempts a site gets before it
    descends to shrink and fallback (``H2O_TPU_OOM_SWEEP_RETRIES``,
    default 2)."""
    return int(os.environ.get("H2O_TPU_OOM_SWEEP_RETRIES", "2") or 2)


def _diagnostic(site: str) -> str:
    """Terminal message: what the memory manager holds, its budget, and
    what PyTorch's caching allocator has allocated and reserved on the
    current card."""
    try:
        from h2o_tpu_torch.core.memory import manager
        s = manager().stats()
        card = ""
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            card = (f"cuda_allocated_bytes={torch.cuda.memory_allocated()} "
                    f"cuda_reserved_bytes={torch.cuda.memory_reserved()} ")
        return (f"resident_bytes={s['resident_bytes']} "
                f"budget={s['budget'] or 'unlimited'} {card}— lower the "
                f"working set (smaller frame / fewer columns) or shrink "
                f"the work quantum for {site}")
    except Exception:  # noqa: BLE001 — diagnostics must never mask OOM
        return "memory manager diagnostics unavailable"


def oom_ladder(site: str, attempt: Callable[[], object], *,
               shrink: Optional[Callable[[], bool]] = None,
               host_fallback: Optional[Callable[[], object]] = None,
               on_oom: Optional[Callable[[BaseException], None]] = None):
    """Run ``attempt()`` under the OOM recovery ladder (module
    docstring).  ``shrink()`` reduces the caller's work quantum and
    returns False once it cannot shrink further; ``host_fallback()``
    computes the result off the device; ``on_oom(exc)`` is called on
    every classified OOM.  Non-OOM exceptions propagate untouched."""
    c = chaos()

    def _run():
        c.maybe_oom(site)
        return attempt()

    def _swallow_oom(e: BaseException) -> None:
        if not is_device_oom(e):
            raise e
        _note(site, "oom_events")
        if on_oom is not None:
            on_oom(e)

    try:
        return _run()
    except Exception as e:  # noqa: BLE001 — reclassified by _swallow_oom
        _swallow_oom(e)
    # rung (a): sweep and retry at the same quantum
    for i in range(sweep_retries()):
        _note(site, "sweeps")
        from h2o_tpu_torch.core.memory import manager
        freed = manager().sweep()
        log.warning("%s: device OOM — swept %d bytes, retry %d/%d", site,
                    freed, i + 1, sweep_retries())
        try:
            return _run()
        except Exception as e:  # noqa: BLE001
            _swallow_oom(e)
    # rung (b): shrink the work quantum and retry until it bottoms out
    if shrink is not None:
        while shrink():
            _note(site, "shrinks")
            log.warning("%s: device OOM persists — degraded to a "
                        "smaller work quantum", site)
            try:
                return _run()
            except Exception as e:  # noqa: BLE001
                _swallow_oom(e)
    # rung (c): the host route
    if host_fallback is not None:
        _note(site, "host_fallbacks")
        log.warning("%s: device OOM persists — falling back to the "
                    "host path", site)
        return host_fallback()
    # rung (d): fail the job with a diagnostic, never the process
    _note(site, "terminal")
    raise OOMError(site, _diagnostic(site))
