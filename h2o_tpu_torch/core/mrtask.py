"""map_reduce — the MRTask analog, a port of the one-device part of
``h2o_tpu/core/mrtask.py`` (``REDUCERS`` :52-56, ``map_reduce`` :67-118,
``map_frame`` :121-136, ``mutate_array`` :139-156, ``device_sum``
:159-169, ``row_mask_shard`` :172-176).

The reference runs the user's map function per mesh shard under
``shard_map`` and reduces its pytree of accumulators across the shards
with ``psum`` / ``pmin`` / ``pmax``.  On one card there is one shard, so
the cross-device reduce is the identity: ``map_reduce`` places its
arrays on the device, runs ``map_fn`` there once and returns its pytree
of tensors (tuples, lists and dicts).  The reduce name is still checked,
as ``REDUCERS[reduce]`` checks it.  Eager PyTorch compiles nothing, so
the reference's executable store and its dispatch ladder have no
counterpart here.

The blocked streamer over the tiered column store
(``FrameBlockStreamer``, ``map_reduce_blocked``, :191-370) stands on that
store, which the port refuses at any non-zero budget
(``core/memory.py``); it comes with it (ROADMAP P14b).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.core.diag import TransferStats
from h2o_tpu_torch.core.frame import Frame

#: the reduce names the reference accepts; on one device each is the
#: identity
REDUCERS = ("sum", "min", "max")


def _check_reduce(reduce: str) -> None:
    if reduce not in REDUCERS:
        raise KeyError(reduce)


def _place(x, dev: torch.device):
    """A host array on ``dev``; a tensor must already live there."""
    if torch.is_tensor(x):
        if x.device != dev:
            raise ValueError(f"map_reduce: a tensor on {x.device} was "
                             f"given for a run on {dev}")
        return x
    host = np.ascontiguousarray(x)
    TransferStats.note("to_device", host.nbytes)
    return torch.from_numpy(host).to(dev)


def map_reduce(map_fn: Callable, *arrays, reduce: str = "sum",
               extra_args: Sequence = (), device: DeviceLike = None):
    """``map_fn(*arrays, *extra_args)`` on the device; its result (a
    tensor or a pytree of them) is the reduced value, since one device
    holds every row.  numpy ``arrays`` are placed on the device; tensors
    on another device raise.  An unknown ``reduce`` raises ``KeyError``,
    as the reference's lookup does."""
    _check_reduce(reduce)
    dev = cloud(device)
    xs = [_place(a, dev) for a in arrays]
    return map_fn(*xs, *extra_args)


def map_frame(map_fn: Callable, frame: Frame,
              names: Sequence[str] = None, device: DeviceLike = None):
    """A row-local transform of the frame's (rows, columns) float32
    matrix (``Frame.as_matrix``) on the device: the NewChunk analog, its
    output aligned with the input rows."""
    return map_fn(frame.as_matrix(names, cloud(device)))


def mutate_array(map_fn: Callable, array, *extras,
                 device: DeviceLike = None) -> torch.Tensor:
    """``map_fn(array, *extras)`` on the device.  The caller treats
    ``array`` as consumed: ``map_fn`` may reuse a device input's storage
    in place, as the reference donates its buffer."""
    dev = cloud(device)
    return map_fn(_place(array, dev), *extras)


def device_sum(x, device: DeviceLike = None) -> torch.Tensor:
    """The sum of every element of ``x`` on the device (0-d)."""
    return _place(x, cloud(device)).sum()


def row_mask_shard(padded_rows: int, nrows: int,
                   device: DeviceLike = None) -> torch.Tensor:
    """The row-validity mask ``arange(padded_rows) < nrows`` on the
    device (one device holds every row: no sharding)."""
    return torch.arange(padded_rows, device=cloud(device)) < nrows
