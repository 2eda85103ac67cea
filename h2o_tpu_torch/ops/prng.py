"""jax's threefry2x32 PRNG, bit for bit — the counterpart of
``jax.random.key``/``fold_in``/``split``/``uniform`` as the reference
uses them (``jax_threefry_partitionable`` on, jax's default), plus
``rng_key_to_np``/``rng_key_from_np`` (``h2o_tpu/models/tree/
shared_tree.py:362-371``).

* ``key(seed)`` is the word pair ``(seed >> 32, seed & 0xFFFFFFFF)``;
* ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``;
* ``split(k, n)[i]`` is ``threefry2x32(k, (0, i))``;
* ``uniform(k, shape)`` runs threefry on the counters ``(i >> 32,
  i & 0xFFFFFFFF)`` of each element's row-major flat index ``i``, takes
  the bits ``x0 ^ x1`` and makes the float32 ``bitcast((bits >> 9) |
  0x3F800000) - 1``.  So draws are prefix-stable: the first n of a
  longer draw are the draw of n.

A key is a (2,) uint32 numpy array and is derived on the host: deriving
one launches nothing on the device.  Only ``uniform`` runs on the
device, in int64 tensors that hold 32-bit words (every op it needs
exists for int64 on the CPU and on CUDA).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

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


def uniform(k, shape: Sequence[int], device) -> torch.Tensor:
    """float32 draws in [0, 1) of ``shape`` on ``device``."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape, dtype=np.int64))
    i = torch.arange(n, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(*_words(k), i >> 32, i & _MASK)
    bits = ((x0 ^ x1) >> 9) | 0x3F800000
    return (bits.to(torch.int32).view(torch.float32) - 1.0).reshape(shape)


def rng_key_to_np(k) -> np.ndarray:
    """A key as a raw uint32 host array (checkpointable)."""
    return np.array(_words(k), dtype=np.uint32)


def rng_key_from_np(data) -> np.ndarray:
    """Inverse of ``rng_key_to_np``: a resumed build continues the exact
    stream."""
    return _key(*_words(data))
