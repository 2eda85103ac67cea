"""Quantized per-row gradient/hessian stats — port of
``h2o_tpu/ops/statpack.py:64-140`` (``STATS_DTYPES``, ``stats_qmax``,
``quantize_stats``, ``dequant_table``, ``widen_stats``).

Each tree's (R, S) float32 stats become an int16/int8 carrier with one
scale per stat slot and stochastic rounding; the histogram kernels sum
the carrier into exact int32 tables (so sibling subtraction is exact),
and each level's table is dequantized once before split finding.

* ``qmax = min(carrier max, (2^31 - 1) // rows)``: an int32 sum over
  every row cannot overflow;
* ``scale[s] = qmax / max_r |stats[r, s]|`` and ``q = clip(floor(stats *
  scale + u), -qmax, qmax)`` with ``u`` the ``uniform`` draw of
  ``fold_in(key, 0x51A7)``, so ``E[q] = stats * scale``;
* ``dequant(q) = q * max|stats| / qmax``, off by less than one step.

The port computes what XLA compiles on the CPU for the reference:
``qmax / m`` divides, ``m / qmax`` multiplies by the float32 reciprocal
of the constant ``qmax``, and ``stats * scale + u`` is one fused
multiply-add, which the port takes in float64 and rounds once to
float32 (equal to the FMA except on a double-rounding tie).  The same
arithmetic runs on every device.  ``qmax`` comes from the row count
padded to the reference's row quantum (``padded_rows``), as the
reference pads its frames before it quantizes.

The reference's autotuner lever and the ``H2O_TPU_STATS_DTYPE``
environment tri-state are not ported: the builders take an explicit
``stats_dtype``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from h2o_tpu_torch.ops import prng

#: quantized stats carriers by name; "f32" is the reference (no-op)
STATS_DTYPES = ("f32", "int16", "int8")
_CARRIER = {"int16": (torch.int16, 32767), "int8": (torch.int8, 127)}

#: the reference pads a frame's rows to ``n_nodes * row_align``; on one
#: device that is its default ``row_align`` of 128
ROW_QUANTUM = 128
_TINY = 1e-30
_QKEY_SALT = 0x51A7  # fold_in tag of the quantization noise stream


def stats_qdtype(stats_dtype: str) -> torch.dtype:
    if stats_dtype == "f32":
        return torch.float32
    try:
        return _CARRIER[stats_dtype][0]
    except KeyError:
        raise ValueError(f"unknown stats dtype {stats_dtype!r}; one of "
                         f"{STATS_DTYPES}") from None


def padded_rows(rows: int, quantum: int = ROW_QUANTUM) -> int:
    """``rows`` rounded up to a multiple of ``quantum``: the row count
    the reference's ``stats_qmax`` sees."""
    q = max(int(quantum), 1)
    return -(-int(rows) // q) * q


def stats_qmax(rows: int, stats_dtype: str) -> int:
    """Carrier max, tightened so an int32 sum of ``rows`` values of
    |q| <= qmax cannot overflow."""
    stats_qdtype(stats_dtype)
    cmax = _CARRIER[stats_dtype][1]
    return max(1, min(cmax, (2 ** 31 - 1) // max(int(rows), 1)))


def quantize_stats(stats: torch.Tensor, key, stats_dtype: str,
                   qmax: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, S) float32 stats -> (carrier (R, S), (S,) float32 1/scale).
    ``key`` is the per-(tree, class) key; the noise comes from its
    ``fold_in`` with 0x51A7."""
    m = stats.abs().amax(dim=0).clamp_min(_TINY)
    # a true division: torch's ``int / tensor`` multiplies by reciprocal
    scale = torch.full_like(m, float(qmax)) / m
    u = prng.uniform(prng.fold_in(key, _QKEY_SALT), stats.shape,
                     stats.device)
    # one rounding of stats * scale + u, as the fused multiply-add
    fma = (stats.double() * scale.double()[None, :] + u.double()).float()
    q = torch.floor(fma).clamp_(-qmax, qmax)
    inv_qmax = float(np.float32(1) / np.float32(qmax))
    return q.to(stats_qdtype(stats_dtype)), m * inv_qmax


def dequant_table(table: torch.Tensor, inv_scale: torch.Tensor) -> torch.Tensor:
    """int32 histogram table (..., S) -> float32: one convert and one
    multiply a level, on the table, never on the rows."""
    return table.to(torch.float32) * inv_scale


def widen_stats(q: torch.Tensor) -> torch.Tensor:
    """Carrier stats -> int32."""
    return q.to(torch.int32)
