"""Device-OOM recovery: the fused-region rung of ``h2o_tpu/core/oom.py``.

Reference map: ``fused_fallback`` :126-150, ``is_device_oom`` :153-172,
the rung counters ``_note`` / ``stats`` / ``reset_stats`` :205-238.

A Rapids region the planner fused (``rapids/plan.py``) holds the working
set of all its stages at once, where the per-verb chain holds one verb's.
When the fused run fails with a device OOM, ``fused_fallback`` counts the
``unfused_fallbacks`` rung at its site and replays the region as the
eager per-verb chain, which gives the same frame bit for bit (the
planner's parity contract).  A device OOM is ``torch.cuda.OutOfMemoryError``
or the chaos injector's ``ChaosOOMError``
(``H2O_TPU_CHAOS_REGION_OOM_TRANSIENT``, ``core/chaos.py``
``maybe_region_oom``); every other exception propagates untouched, so a
fused region never hides a failure that is not about memory.

The rest of the reference's ladder waits for ROADMAP P14a: ``oom_ladder``
(:269, sweep, shrink, host fallback and the terminal ``OOMError`` around
every dispatch), the kernel rung ``kernel_fallback`` (:101) and the
resilience report that reads these counters.  Until then a device OOM
anywhere else propagates to the caller.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict

import torch

from h2o_tpu_torch.core.chaos import ChaosOOMError, chaos
from h2o_tpu_torch.core.log import get_logger

log = get_logger("oom")

_RUNGS = ("unfused_fallbacks",)

_stats_lock = threading.Lock()
_sites: Dict[str, Dict[str, int]] = {}


def _note(site: str, rung: str, n: int = 1) -> None:
    with _stats_lock:
        d = _sites.setdefault(site, {r: 0 for r in _RUNGS})
        d[rung] += n


def stats() -> dict:
    """Cumulative rung counters: the degradations in all, and per site."""
    with _stats_lock:
        sites = {s: dict(d) for s, d in _sites.items()}
    return {"degradations": sum(d["unfused_fallbacks"]
                                for d in sites.values()),
            "sites": sites}


def reset_stats() -> None:
    with _stats_lock:
        _sites.clear()


def is_device_oom(exc: BaseException) -> bool:
    """True for a device allocation failure: PyTorch's CUDA
    ``OutOfMemoryError`` or an injected ``ChaosOOMError``."""
    return isinstance(exc, (torch.cuda.OutOfMemoryError, ChaosOOMError))


def fused_fallback(site: str, run_fused: Callable[[], object],
                   run_unfused: Callable[[], object]):
    """Run a planner-fused Rapids region; on a device OOM count the
    ``unfused_fallbacks`` rung at ``site`` and return ``run_unfused()``,
    the eager per-verb chain.  Everything else propagates.  The chaos
    injector's region OOM fires here, before the fused run.  The replay
    starts after the exception is dropped, so the fused run's tensors,
    which its traceback holds, are free by then."""
    try:
        chaos().maybe_region_oom(site)
        return run_fused()
    except Exception as e:  # noqa: BLE001 — reclassified below
        if not is_device_oom(e):
            raise
        why = str(e)[:200]
    _note(site, "unfused_fallbacks")
    log.warning("%s: fused region ran out of device memory (%s); "
                "degrading to the unfused per-verb chain", site, why)
    return run_unfused()
