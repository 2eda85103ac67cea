"""Environment knobs — port of the readers of ``h2o_tpu/config.py`` that
the serving layers read: ``hbm_budget`` (``config.py:154-158``) and the
serving and breaker readers (``config.py:203-255``).  Same variable
names and defaults; each is read at CALL time, never cached at import,
so tests can monkeypatch ``os.environ``.

``H2O_TPU_HBM_BUDGET`` (alias ``H2O_TPU_MEM_BUDGET``) — bytes of device
    memory the tier manager may hold resident; ``0`` (default) means
    unbounded.  The port's memory manager (core/memory.py) accepts only
    0 until the tiered store is ported.
``H2O_TPU_SERVE_REPLICAS`` — serve-fleet size (default 1).
``H2O_TPU_BREAKER_SOFT`` / ``_HARD`` — pressure scores that enter
    SHEDDING (0.85) and trip OPEN (0.97).
``H2O_TPU_BREAKER_OPEN_SECS`` — OPEN cooldown before HALF_OPEN (5.0).
``H2O_TPU_BREAKER_PROBES`` — live probes while HALF_OPEN (3).
``H2O_TPU_BREAKER_INTERVAL_MS`` — minimum ms between re-evaluations (50).
``H2O_TPU_BREAKER_STALL_SOFT`` — demand-page stalls per sample that
    saturate the stall signal (4).
``H2O_TPU_SERVE_ADAPTIVE`` — new deployments default to the adaptive
    batch tuner (off).
``H2O_TPU_SERVE_MIN_BATCH`` / ``_MAX_BATCH`` — the tuner's pow2 bounds
    (1, 128).
``H2O_TPU_STREAM_POLL_MS`` — follow-mode re-poll interval of a quiet
    stream source (50 ms; ``config.py:272-274``).
``H2O_TPU_DEVICE_MUNGE`` — ``0``, ``false`` or ``off`` sends the Rapids
    munge ops to their host routes; anything else, or unset, keeps the
    device routes.  The reference reads it in ``core/munge.py:130-134``,
    not in its ``config.py``, so ``device_munge`` stays out of
    ``__all__``, the readers that mirror that file.
``H2O_TPU_SHARD_MUNGE`` — ``0``, ``false`` or ``off`` sends the
    reference's munge verbs to its global kernels, and its Rapids planner
    then declines every region (``core/munge.py:137-143`` there).  One
    device has no shard collectives, so the port reads it only for the
    planner's gate: the same environment takes the same route in both
    packages.
``H2O_TPU_RAPIDS_FUSE`` — the Rapids planner's lever
    (``rapids/plan.py``): ``1``/``on`` fuses every fusable region, ``0``/
    ``off`` runs every verb alone, unset defers to ``H2O_TPU_AUTOTUNE``
    and the session's device (``config.py:187-193``).
``H2O_TPU_RAPIDS_FUSE_MAX_VERBS`` — the most verbs one fused region
    takes, at least 2 (8; ``config.py:196-200``).
``H2O_TPU_AUTOTUNE`` — ``off``/``0``, ``force`` or ``auto`` (unset);
    read by ``autotune_mode`` and the levers' ``tri_state`` spellings, as
    ``core/autotune.py:96-133`` reads them.  The rest of the autotuner
    comes with ROADMAP P14b.

The readers of the last four, like ``device_munge``, stay out of
``__all__``.  The other readers of the reference (tiers, the stream
holdout, tenants) come with their slices.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["hbm_budget", "serve_replicas", "breaker_soft", "breaker_hard", "breaker_open_secs", "breaker_probes", "breaker_interval_ms", "breaker_stall_soft", "serve_adaptive_default", "serve_min_batch", "serve_max_batch", "stream_poll_ms"]


def hbm_budget() -> int:
    """Device-HBM residency budget in bytes; 0 = unbounded."""
    return int(os.environ.get("H2O_TPU_HBM_BUDGET")
               or os.environ.get("H2O_TPU_MEM_BUDGET")
               or 0)


def serve_replicas() -> int:
    """Serve-fleet size (default 1 = single-registry path)."""
    return max(1, int(os.environ.get("H2O_TPU_SERVE_REPLICAS", "1") or 1))


def breaker_soft() -> float:
    """Pressure score that enters SHEDDING (shrink + 429s)."""
    return float(os.environ.get("H2O_TPU_BREAKER_SOFT", "0.85") or 0.85)


def breaker_hard() -> float:
    """Pressure score that trips OPEN (503s until cooldown)."""
    return float(os.environ.get("H2O_TPU_BREAKER_HARD", "0.97") or 0.97)


def breaker_open_secs() -> float:
    """OPEN cooldown seconds before HALF_OPEN probes are admitted."""
    return float(os.environ.get("H2O_TPU_BREAKER_OPEN_SECS", "5.0") or 5.0)


def breaker_probes() -> int:
    """Live requests admitted while HALF_OPEN."""
    return max(1, int(os.environ.get("H2O_TPU_BREAKER_PROBES", "3") or 3))


def breaker_interval_ms() -> float:
    """Minimum ms between breaker telemetry re-evaluations."""
    return float(os.environ.get("H2O_TPU_BREAKER_INTERVAL_MS", "50")
                 or 50.0)


def breaker_stall_soft() -> float:
    """Demand-page stalls per sample that saturate the stall signal."""
    return float(os.environ.get("H2O_TPU_BREAKER_STALL_SOFT", "4") or 4.0)


def serve_adaptive_default() -> bool:
    """Whether new deployments default to the adaptive batch tuner."""
    return os.environ.get("H2O_TPU_SERVE_ADAPTIVE", "0").lower() in (
        "1", "on", "true", "yes")


def serve_min_batch() -> int:
    """Lower pow2 bound for the adaptive tuner's ``max_batch``."""
    return max(1, int(os.environ.get("H2O_TPU_SERVE_MIN_BATCH", "1") or 1))


def serve_max_batch() -> int:
    """Upper pow2 bound for the adaptive tuner's ``max_batch``."""
    return max(1, int(os.environ.get("H2O_TPU_SERVE_MAX_BATCH", "128")
                      or 128))


def stream_poll_ms() -> float:
    """Follow-mode re-poll interval for a quiet stream source (ms)."""
    return float(os.environ.get("H2O_TPU_STREAM_POLL_MS", "50") or 50.0)


def device_munge() -> bool:
    """Whether the Rapids munge ops take their device routes (default)
    rather than their host routes."""
    return os.environ.get("H2O_TPU_DEVICE_MUNGE", "1").lower() not in (
        "0", "false", "off")


def shard_munge() -> bool:
    """False when ``H2O_TPU_SHARD_MUNGE`` is ``0``, ``false`` or ``off``."""
    return os.environ.get("H2O_TPU_SHARD_MUNGE", "1").lower() not in (
        "0", "false", "off")


def rapids_fuse_mode() -> str:
    """``auto`` (defer to the lever) | ``on``/``1`` | ``off``/``0``."""
    v = os.environ.get("H2O_TPU_RAPIDS_FUSE", "").lower()
    if v in ("1", "on", "true", "yes"):
        return "on"
    if v in ("0", "off", "false", "no"):
        return "off"
    return "auto"


def rapids_fuse_max_verbs() -> int:
    """Max verbs per fused region (longer chains split at the cap)."""
    return max(2, int(os.environ.get("H2O_TPU_RAPIDS_FUSE_MAX_VERBS",
                                     "8") or 8))


_TRUE = ("1", "on", "true", "yes")
_FALSE = ("0", "off", "false", "no")


def _env_value(var: str) -> str:
    return os.environ.get(var, "").strip().lower()


def tri_state(var: str) -> Optional[bool]:
    """1/on -> forced True, 0/off -> forced False, auto/unset/other ->
    None (defer to the measured decision)."""
    v = _env_value(var)
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    return None


def autotune_mode() -> str:
    """``H2O_TPU_AUTOTUNE``: ``off`` (0) = reference variants everywhere,
    ``force`` = measure on any device, default ``auto``."""
    v = _env_value("H2O_TPU_AUTOTUNE")
    if v in _FALSE:
        return "off"
    if v == "force":
        return "force"
    return "auto"
