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

The other readers of the reference (tiers, the stream holdout, tenants,
the Rapids planner) come with their slices.
"""

from __future__ import annotations

import os

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
