"""jax's threefry2x32 PRNG, bit for bit — the counterpart of
``jax.random.key``/``fold_in``/``split``/``bits``/``uniform``/
``permutation``/``choice`` (without replacement) and ``normal`` as the
reference uses them (``jax_threefry_partitionable`` on, jax's default;
jax 0.9's ``jax/_src/random.py``), plus
``rng_key_to_np``/``rng_key_from_np`` (``h2o_tpu/models/tree/
shared_tree.py:362-371``).

* ``key(seed)`` is the word pair ``(seed >> 32, seed & 0xFFFFFFFF)``;
* ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``;
* ``split(k, n)[i]`` is ``threefry2x32(k, (0, i))``;
* ``uniform(k, shape)`` runs threefry on the counters ``(i >> 32,
  i & 0xFFFFFFFF)`` of each element's row-major flat index ``i``, takes
  the bits ``x0 ^ x1`` and makes the float32 ``bitcast((bits >> 9) |
  0x3F800000) - 1``.  So draws are prefix-stable: the first n of a
  longer draw are the draw of n.  ``bits`` is that word ``x0 ^ x1``;
  with ``minval``/``maxval`` the float is ``max(minval, floats *
  (maxval - minval) + minval)``, which XLA compiles on the CPU to one
  fused multiply-add: the port takes it in float64 and rounds once;
* ``permutation(k, n)`` is jax's ``_shuffle``: ``ceil(3 ln n / ln(2^32 -
  1))`` rounds, each splitting the key and sorting by 32-bit ``bits``
  with a STABLE sort, so colliding sort keys keep their order;
  ``choice(k, n, s)`` without replacement is its first ``s`` entries;
* ``normal(k, shape)`` is ``sqrt(2) * erf_inv(u)`` with ``u`` uniform on
  ``[nextafter(-1, 0), 1)`` and XLA's float32 ``erf_inv`` (Giles'
  polynomial, its Horner steps fused multiply-adds, on XLA's own
  ``log1p``: ``ops/xlamath.py``).

A key is a (2,) uint32 numpy array and is derived on the host: deriving
one launches nothing on the device.  The draws run on the device, in
int64 tensors that hold 32-bit words (every op they need exists for
int64 on the CPU and on CUDA).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from h2o_tpu_torch.ops import xlamath

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (jax's ``threefry2x32``) on 32-bit
    words held in Python ints or in int64 tensors: every sum is masked
    back to 32 bits, and a left rotation by r < 32 of a word below 2^32
    stays below 2^63."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _MASK
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _words(k) -> tuple:
    k = np.asarray(k, dtype=np.uint32).reshape(2)
    return int(k[0]), int(k[1])


def _key(w0: int, w1: int) -> np.ndarray:
    return np.array([w0, w1], dtype=np.uint32)


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)``'s words for a seed in [0, 2^64)."""
    seed = int(seed)
    if seed < 0:
        raise ValueError("prng.key: the seed must be >= 0")
    return _key((seed >> 32) & _MASK, seed & _MASK)


def fold_in(k, data: int) -> np.ndarray:
    return _key(*threefry2x32(*_words(k), 0, int(data) & _MASK))


def split(k, n: int = 2) -> List[np.ndarray]:
    k0, k1 = _words(k)
    return [_key(*threefry2x32(k0, k1, 0, i)) for i in range(int(n))]


def bits(k, shape: Sequence[int], device) -> torch.Tensor:
    """``jax.random.bits(k, shape)``: uint32 words, held in int64."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape, dtype=np.int64))
    i = torch.arange(n, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(*_words(k), i >> 32, i & _MASK)
    return (x0 ^ x1).reshape(shape)


def uniform(k, shape: Sequence[int], device, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 draws in [minval, maxval) of ``shape`` on ``device``."""
    word = (bits(k, shape, device) >> 9) | 0x3F800000
    floats = word.to(torch.int32).view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:
        return floats                   # floats * 1 + 0, exactly
    lo = float(np.float32(minval))
    span = float(np.float32(np.float32(maxval) - np.float32(minval)))
    return torch.clamp_min((floats.double() * span + lo).float(), lo)


def permutation(k, n: int, device) -> torch.Tensor:
    """``jax.random.permutation(k, n)``: int64 (n,) on ``device``."""
    n = int(n)
    rounds = int(np.ceil(3 * np.log(max(1, n)) /
                         np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(rounds):
        k, sub = split(k)
        order = torch.sort(bits(sub, (n,), device), stable=True).indices
        x = x[order]
    return x


def choice(k, n: int, size: int, device) -> torch.Tensor:
    """``jax.random.choice(k, n, (size,), replace=False)``."""
    if size > n:
        raise ValueError(f"choice: cannot take {size} of {n} without "
                         "replacement")
    return permutation(k, n, device)[:int(size)]


# XLA's float32 erf_inv (Giles, "Approximating the erfinv function"): the
# coefficients for w < 5 and for w >= 5, highest order first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, XLA's: Giles' polynomial in
    ``w = -log1p(-x^2)``, each Horner step one fused multiply-add."""
    w = -xlamath.log1p(-x * x)
    lt = w < 5.0
    # sqrt in float64, rounded once: the correctly rounded float32 root
    # XLA computes (torch's CPU kernel is not always correctly rounded)
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0
                    ).double()

    def coef(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], device=x.device),
                           torch.tensor(_ERFINV_GE5[i], device=x.device)
                           ).float().double()

    p = coef(0).float()
    for i in range(1, len(_ERFINV_LT5)):
        p = (coef(i) + p.double() * w).float()
    edge = x * torch.finfo(torch.float32).max
    return torch.where(x.abs() == 1.0, edge, p * x)


def normal(k, shape: Sequence[int], device) -> torch.Tensor:
    """Standard normal float32 draws (``jax.random.normal``)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(k, shape, device, float(lo), 1.0)
    return float(np.float32(np.sqrt(2))) * erf_inv(u)


def rng_key_to_np(k) -> np.ndarray:
    """A key as a raw uint32 host array (checkpointable)."""
    return np.array(_words(k), dtype=np.uint32)


def rng_key_from_np(data) -> np.ndarray:
    """Inverse of ``rng_key_to_np``: a resumed build continues the exact
    stream."""
    return _key(*_words(data))
