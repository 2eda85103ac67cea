"""Device selection — the one-device part of ``h2o_tpu/core/cloud.py``
(``Cloud`` at :136, ``cloud()`` at :345).

The JAX package boots a mesh over every visible device; this slice of
the port runs on one device.  The mesh, ``hpsum`` and the other
collectives wait for the multi-GPU slice.

Nothing moves to the CPU on its own: with no argument the device is
``cuda:0`` and a box without CUDA raises, so a run that was meant for
the card can never quietly measure the CPU.  Tests pass
``device="cpu"`` explicitly, which selects the plain PyTorch version of
every kernel.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def cloud(device: DeviceLike = None) -> torch.device:
    """The device this process computes on (``h2o_tpu.cloud()`` analog):
    ``None`` -> ``cuda:0`` (raises when CUDA is absent), anything else as
    given, so ``cloud("cpu")`` selects the CPU.  Selecting a CUDA device
    also pins float32 matmuls and convolutions to full precision: TF32
    keeps about three decimal digits, and the reference computes in
    float32."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "h2o_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch versions on the CPU")
        device = "cuda:0"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"h2o_tpu_torch: device {dev} requested but "
                               "CUDA is not available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
