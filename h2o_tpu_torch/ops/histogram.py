"""(leaf, column, bin) histogram — port of ``h2o_tpu/ops/histogram.py``
(stat slots :48-50, ``_block_hist`` :105-149, ``map_buckets`` :152-178,
``histogram_build_traced`` :181-277).

``histogram_build`` is the one entry the tree engine calls.  On a CUDA
tensor it launches the hand-written kernels of ``ops/hist_kernels.py``
(K1 for global bins, K2 when a ``fine_map`` asks for per-node adaptive
buckets) or raises: there is no fallback and no size gate, because the
kernels' planner handles every shape.  On a CPU tensor it runs the
plain PyTorch versions below, which are also the yardstick the kernels
are held against on the card.

Left out on purpose: the reference's ``kernel_fallback``
(``core/oom.py:101``), its autotuner levers and the ``_pallas_eligible``
VMEM gate (``ops/histogram.py:70-102``) — a kernel that cannot run must
fail loudly, not hand the work to another path.  The cross-device
``hpsum`` waits for the multi-GPU slice.

Table layout (both paths): ``(C*(B+1), L*S)`` with element
``[c*(B+1) + b, l*S + s]`` — the TPU kernels' layout — reshaped by
``histogram_build`` to ``(L, C, B+1, S)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from h2o_tpu_torch.ops.binpack import widen_bins

# stats slots
W, WG, WGG, WH = 0, 1, 2, 3
N_STATS = 4

# elements (rows x columns x stats) one block of the plain version
# scatters at a time: bounds its index/value temporaries to ~64 MB
_PLAIN_BLOCK_ELEMS = 1 << 22

FineMap = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, int]


def _floor_div(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def map_buckets(bins: torch.Tensor, leaf: torch.Tensor, lo: torch.Tensor,
                hi: torch.Tensor, off: torch.Tensor, is_cat: torch.Tensor,
                nbins: int, fine_na: int) -> torch.Tensor:
    """Fine bins -> per-node histogram buckets (UniformAdaptive/Random),
    all-integer so bucketing and the recovered fine threshold agree
    exactly: ``bucket(x) = ((x - lo)*B + off) // span``, span = hi-lo+1.
    lo/hi/off are (L, C) int32; categorical columns pass their code
    through (capped at B); the NA fine bin maps to bucket B."""
    b = widen_bins(bins)
    lf = leaf.clamp_min(0).long()
    lo_b, hi_b, o_b = lo[lf], hi[lf], off[lf]               # (R, C)
    span = (hi_b - lo_b + 1).clamp_min(1)
    x = torch.minimum((b - lo_b).clamp_min(0), span - 1)
    nb = _floor_div(x * nbins + o_b, span).clamp(0, nbins - 1)
    out = torch.where(is_cat.bool()[None, :],
                      torch.clamp_max(b, nbins), nb)
    return torch.where(b == fine_na, torch.full_like(out, nbins), out)


def block_hist(bins: torch.Tensor, leaf: torch.Tensor, stats: torch.Tensor,
               n_leaves: int, nbins: int,
               bf16: bool = False) -> torch.Tensor:
    """One block's table ``(C*(B+1), L*S)`` by ``index_add_`` over the
    flat index ``((c*(B+1) + b)*L + l)*S + s``.  Rows with leaf outside
    [0, L) add nothing even when their stats are NaN, and bins outside
    [0, B] match no bucket, as with the reference's one-hot.

    float32 stats accumulate in float64 (integer stats in int64) and are
    cast at the end, so this version's only rounding is the final cast.
    ``bf16`` first rounds each float32 stat to bfloat16 (the reference's
    ``astype(bf16)`` of the matmul operand)."""
    quantized = not stats.dtype.is_floating_point
    return _block_hist_acc(bins, leaf, stats, n_leaves, nbins, bf16).to(
        torch.int32 if quantized else torch.float32)


def hist_plain(bins: torch.Tensor, leaf: torch.Tensor, stats: torch.Tensor,
               n_leaves: int, nbins: int, bf16: bool = False,
               fine_map: Optional[FineMap] = None) -> torch.Tensor:
    """The plain PyTorch version of K1 (``fine_map`` None) and K2: the
    whole shard's ``(C*(B+1), L*S)`` table, accumulated over row blocks
    that bound memory.  It runs on any device; only CPU tensors reach it
    from ``histogram_build``."""
    R, C = bins.shape
    S = stats.shape[1]
    quantized = not stats.dtype.is_floating_point
    blk = max(1, _PLAIN_BLOCK_ELEMS // max(C * S, 1))
    acc_dtype = torch.int64 if quantized else torch.float64
    acc = torch.zeros(C * (nbins + 1), n_leaves * S, dtype=acc_dtype,
                      device=bins.device)
    for r0 in range(0, R, blk):
        bb, lb, sb = bins[r0:r0 + blk], leaf[r0:r0 + blk], stats[r0:r0 + blk]
        if fine_map is not None:
            lo, hi, off, is_cat, fine_na = fine_map
            bb = map_buckets(bb, lb, lo, hi, off, is_cat, nbins, fine_na)
        acc += _block_hist_acc(bb, lb, sb, n_leaves, nbins, bf16)
    return acc.to(torch.int32 if quantized else torch.float32)


def _block_hist_acc(bins, leaf, stats, n_leaves, nbins, bf16):
    """``block_hist`` before its final cast (float64 / int64), so blocks
    sum without intermediate rounding."""
    C = bins.shape[1]
    S = stats.shape[1]
    B1 = nbins + 1
    L = int(n_leaves)
    quantized = not stats.dtype.is_floating_point
    if bf16 and not quantized:
        stats = stats.to(torch.bfloat16).to(torch.float32)
    acc_dtype = torch.int64 if quantized else torch.float64
    b = widen_bins(bins)
    keep = ((leaf >= 0) & (leaf < L))[:, None] & (b >= 0) & (b < B1)
    vals = torch.where(keep[:, :, None], stats.to(acc_dtype)[:, None, :],
                       torch.zeros((), dtype=acc_dtype, device=bins.device))
    cell = ((torch.arange(C, device=bins.device)[None, :] * B1 +
             b.clamp(0, B1 - 1)) * L +
            leaf.clamp(0, L - 1)[:, None].long()) * S
    idx = cell[:, :, None] + torch.arange(S, device=bins.device)
    out = torch.zeros(C * B1 * L * S, dtype=acc_dtype, device=bins.device)
    out.index_add_(0, idx.reshape(-1), vals.reshape(-1))
    return out.view(C * B1, L * S)


def histogram_build(bins: torch.Tensor, leaf: torch.Tensor,
                    stats: torch.Tensor, n_leaves: int, nbins: int,
                    bf16: bool = False,
                    fine_map: Optional[FineMap] = None) -> torch.Tensor:
    """(L, C, B+1, S) histogram of every row with leaf in [0, L).

    bins:  (R, C) packed uint8/int16/int32 in [0, B] (fine bins in
           [0, F] when ``fine_map`` is given)
    leaf:  (R,) int32, < 0 = row inactive
    stats: (R, 4) float32 (w, wg, wgg, wh), or int16/int8 quantized
           stats, which give an exact int32 table
    fine_map: None for global bins, else (lo, hi, off, is_cat, fine_na)
           for per-node adaptive buckets (K2).
    """
    C, S = bins.shape[1], stats.shape[1]
    B1 = nbins + 1
    if bins.is_cuda:
        from h2o_tpu_torch.ops import hist_kernels as hk
        if fine_map is None:
            flat = hk.hist_cuda(bins, leaf, stats, n_leaves, nbins,
                                bf16=bf16)
        else:
            lo, hi, off, is_cat, fine_na = fine_map
            flat = hk.hist_cuda_adaptive(bins, leaf, stats, lo, hi, off,
                                         is_cat, n_leaves, nbins, fine_na,
                                         bf16=bf16)
    elif bins.device.type == "cpu":
        flat = hist_plain(bins, leaf, stats, n_leaves, nbins, bf16=bf16,
                          fine_map=fine_map)
    else:
        raise RuntimeError(f"histogram_build: no kernel for device "
                           f"{bins.device}")
    return flat.view(C, B1, n_leaves, S).permute(2, 0, 1, 3).contiguous()
