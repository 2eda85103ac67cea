"""float32 arithmetic as XLA compiles it for the CPU, where the
reference's results depend on its last bits.

XLA's CPU backend contracts a multiply feeding an add into one fused
multiply-add, and computes ``log`` with its own Cephes polynomial, not
with the C library's.  Where a split is chosen by comparing gains that
tie in exact arithmetic (the uplift divergences over small integer
counts), those last bits decide the tree, so the port evaluates those
expressions the way XLA does:

* ``fma(a, b, c)`` is ``a * b + c`` in float64, rounded once to float32:
  the fused operation (up to a double rounding, which is rare);
* ``log(x)`` is XLA's float32 log (``polynomial_approximations.cc``,
  Cephes' ``logf``): the degree-8 polynomial in three Horner parts, each
  step fused, and the exponent terms added as XLA contracts them.  It
  equals ``jax.numpy.log`` on the CPU bit for bit on positive finite
  float32 (``tests/test_torch_xlamath.py``: 800,000 values, 1e-13 to
  1e13);
* ``log1p(x)`` is XLA's (``ElementalIrEmitter::EmitLog1p``): ``log(1 +
  x)`` above |x| = sqrt(2) - 1, below it Cephes' rational approximation
  with fused Horner steps; equal to ``jax.numpy.log1p`` on the CPU
  (the same test: u and -u^2 for 300,000 u uniform in (-1, 1));
* ``sum_leading(x)`` is XLA's CPU float32 sum over the leading axis: the
  axis padded with zeros to a multiple of 32 (half the padding in front),
  each window of 32 summed in order, then the windows in order — the
  order a forest's per-tree predictions are summed in.

All of it is plain tensor code, the same on every device.
"""

from __future__ import annotations

import numpy as np
import torch

# Cephes logf coefficients, as float32
_LOG_P = tuple(float(np.float32(v)) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1 = float(np.float32(-2.12194440e-4))
_LOG_Q2 = float(np.float32(0.693359375))
_SQRTHF = float(np.float32(0.707106781186547524))
_MIN_NORMAL = float(np.finfo(np.float32).tiny)


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once; a float operand is taken as
    the float32 constant XLA would hold."""
    def wide(v):
        if torch.is_tensor(v):
            return v.double()
        return float(np.float32(v))

    return (wide(a) * wide(b) + wide(c)).float()


def log(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 natural log: -inf at 0, NaN below 0 and for
    NaN, +inf at +inf."""
    x = x.to(torch.float32)
    t0 = torch.clamp_min(x, _MIN_NORMAL)
    word = t0.view(torch.int32)
    e = 1.0 + ((word >> 23) - 0x7F).to(torch.float32)
    # the significand in [0.5, 1)
    frac = ((word & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = frac < _SQRTHF
    t = (frac - 1.0) + torch.where(small, frac, torch.zeros_like(frac))
    e = e - small.to(torch.float32)
    x2 = t * t
    x3 = x2 * t
    y = fma(t, _LOG_P[0], _LOG_P[1])
    y1 = fma(t, _LOG_P[3], _LOG_P[4])
    y2 = fma(t, _LOG_P[6], _LOG_P[7])
    y = fma(y, t, _LOG_P[2])
    y1 = fma(y1, t, _LOG_P[5])
    y2 = fma(y2, t, _LOG_P[8])
    y = fma(y, x3, y1)
    y = fma(y, x3, y2)
    y = fma(y, x3, _LOG_Q1 * e)
    t = (t - 0.5 * x2) + y
    out = t + _LOG_Q2 * e
    out = torch.where(x == float("inf"), x, out)
    out = torch.where(x == 0, torch.full_like(out, float("-inf")), out)
    return torch.where((x < 0) | torch.isnan(x),
                       torch.full_like(out, float("nan")), out)


# Cephes log1p rational approximation, highest order first
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    r = torch.zeros_like(x)
    for c in coeffs:
        r = fma(r, x, c)
    return r


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 log(1 + x)."""
    x = x.to(torch.float32)
    x2 = x * x
    small = (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)) * (x * x2)
    small = x + ((-0.5 * x2) + small)
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       log(x + 1.0))


_REDUCE_WINDOW = 32


def _in_order(parts) -> torch.Tensor:
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def sum_leading(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0 in XLA's CPU order (see the module docstring)."""
    T = x.shape[0]
    if T == 0:
        return torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    if T <= _REDUCE_WINDOW:
        return _in_order(list(x))
    pad = -T % _REDUCE_WINDOW
    starts = range(-(pad // 2), T, _REDUCE_WINDOW)
    parts = torch.stack([_in_order(list(x[max(s, 0):s + _REDUCE_WINDOW]))
                         for s in starts])
    return sum_leading(parts)
