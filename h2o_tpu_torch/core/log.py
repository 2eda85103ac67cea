"""Logging — port of ``h2o_tpu/core/log.py``, copied.

Analog of the reference's ``water.util.Log`` (log4j wrapper with buffered
pre-boot messages and per-node files).  Here: stdlib logging with an in-memory
ring buffer so a later REST ``/3/Logs`` endpoint can serve recent lines
without touching disk (the reference's per-node log-file download).  The
port logs under its own ``h2o_tpu_torch`` logger, so a process that imports
both packages keeps their handlers apart.
"""

from __future__ import annotations

import collections
import logging
import threading

_RING_CAPACITY = 4096


class _RingHandler(logging.Handler):
    def __init__(self, capacity: int = _RING_CAPACITY):
        super().__init__()
        self.ring = collections.deque(maxlen=capacity)
        self._lock2 = threading.Lock()

    def emit(self, record: logging.LogRecord) -> None:
        with self._lock2:
            self.ring.append(self.format(record))

    def lines(self) -> list:
        with self._lock2:
            return list(self.ring)


_ring = _RingHandler()
_ring.setFormatter(logging.Formatter(
    "%(asctime)s %(levelname)1.1s %(name)s: %(message)s"))

logger = logging.getLogger("h2o_tpu_torch")
if not logger.handlers:
    _stream = logging.StreamHandler()
    _stream.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)1.1s %(name)s: %(message)s"))
    logger.addHandler(_stream)
    logger.addHandler(_ring)
    logger.setLevel(logging.INFO)
    logger.propagate = False


def get_logger(name: str) -> logging.Logger:
    return logger.getChild(name)


def recent_lines() -> list:
    """Recent log lines for the /3/Logs REST endpoint."""
    return _ring.lines()


def set_level(level: str) -> None:
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
