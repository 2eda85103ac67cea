"""Bin-dtype packing — port of ``h2o_tpu/ops/binpack.py:53-82``.

A binned matrix holds integers in ``[0, F]``, ``F`` being the NA
sentinel.  It is stored in the narrowest dtype that holds ``F``:
uint8 when F <= 255, int16 when F <= 32767, else int32.

Decode contract (unchanged from the reference): a packed matrix holds
exactly the integers of its int32 form — no offset, no remap — so
unpacking is a plain widening cast.  The JAX package packs only under
an autotuner lever; the port always packs, which the contract makes
invisible to every consumer.  The kernels widen in registers; the
plain PyTorch code widens a block at a time.
"""

from __future__ import annotations

import torch

#: dtypes the packer may select, narrowest first
PACKED_DTYPES = (torch.uint8, torch.int16, torch.int32)


def bins_dtype_for(fine_nbins: int) -> torch.dtype:
    """Narrowest dtype holding every bin value in ``[0, fine_nbins]``."""
    f = int(fine_nbins)
    if f <= 255:
        return torch.uint8
    if f <= 32767:
        return torch.int16
    return torch.int32


def cast_bins(b: torch.Tensor, fine_nbins: int) -> torch.Tensor:
    """The narrowing cast; values must already lie in [0, fine_nbins]."""
    return b.to(bins_dtype_for(fine_nbins))


def widen_bins(b: torch.Tensor) -> torch.Tensor:
    """Widening cast for arithmetic on a block of bins."""
    return b.to(torch.int32)
