"""Memory telemetry — the half of ``h2o_tpu/core/memory.py`` the serving
breaker and the OOM ladder read: :class:`MemoryManager` with its
``budget``, :meth:`MemoryManager.pressure` (the keys of
``memory.py:700-710``), :meth:`MemoryManager.sweep` (rung (a) of
``core/oom.py``'s ladder, ``memory.py:512``), :meth:`MemoryManager.stats`
(the keys the ladder's terminal diagnostic reads) and the process-wide
:func:`manager`.

The reference's manager is a three-tier store (device, host, persist)
that registers every frame column's device bytes, spills the least
recently used ones past ``H2O_TPU_HBM_BUDGET`` and pages them back on
access.  Nothing in the port registers resident bytes yet, so the port
keeps only the reading the reference gives at its default budget of 0,
where no tier is set up: ``hbm_frac`` 0.0 and zero paging counters.  A
non-zero budget raises by name, because the port could not honour it:
the tiered store is ROADMAP P14.
"""

from __future__ import annotations

from typing import Optional

import torch

from h2o_tpu_torch.core.lockwitness import make_lock


class MemoryManager:
    """Budget and pressure telemetry (no tiers yet)."""

    def __init__(self, budget_bytes: int = 0):
        self.budget = int(budget_bytes)
        if self.budget != 0:
            raise NotImplementedError(
                f"h2o_tpu_torch: an HBM budget of {self.budget} bytes "
                "needs the tiered memory store, which is not ported yet "
                "(ROADMAP P14); leave H2O_TPU_HBM_BUDGET unset or 0")

    def pressure(self) -> dict:
        """One memory-pressure sample for the serving circuit breaker
        (serve/breaker.py), the keys of ``h2o_tpu/core/memory.py:700-710``:
        ``hbm_frac`` (valid bytes over the budget, 0.0 when unbounded),
        resident and valid bytes, and the cumulative paging counters the
        breaker differentiates between samples.  With no tier set up
        every one is 0."""
        return {"hbm_frac": 0.0, "resident_bytes": 0, "valid_bytes": 0,
                "demand_page_stalls": 0, "pages_in": 0, "pages_out": 0,
                "spills": 0}

    def sweep(self) -> int:
        """Rung (a) of the OOM ladder: spill every resident column and
        return the bytes freed.  The manager holds nothing at budget 0,
        so it spills 0 bytes; on CUDA it first has PyTorch's caching
        allocator hand its cached free blocks back to the device, which
        is what a retry after an out-of-memory error can use."""
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.empty_cache()
        return 0

    def stats(self) -> dict:
        """What is resident (nothing at budget 0) and the budget, as the
        reference's ``stats()`` names them for the ladder's diagnostic."""
        return {"resident_bytes": 0, "budget": self.budget,
                "resident_vecs": 0, "largest_holders": [], "spills": 0}


_manager: Optional[MemoryManager] = None
_manager_lock = make_lock("memory._manager_lock")


def manager() -> MemoryManager:
    """The process-wide manager, its budget read from
    ``H2O_TPU_HBM_BUDGET`` on first use."""
    global _manager
    if _manager is None:
        with _manager_lock:
            if _manager is None:
                from h2o_tpu_torch.config import hbm_budget
                _manager = MemoryManager(hbm_budget())
    return _manager
