#!/usr/bin/env python3
"""Time and inspect the histogram kernels of one checkout of the
PyTorch/CUDA port on one GPU.

    python3 tools/torch_hist_timing.py TREE [--check] [--sass] [--modes f32,int16]

TREE is the root of a checkout of this repository (``.`` for this one).
The script imports TREE's ``chip_smoke.py`` helpers and TREE's
``h2o_tpu_torch``, builds its kernels, and prints one JSON line per
(kernel, shape, mode): the median device milliseconds of one launch
(``chip_smoke.time_ms``: L2 evicted before each launch, the wrapper's
host enqueue covered by a spin kernel), at the main-path shapes and
seeded inputs of ``chip_smoke.py`` phases 2-3.  ``--check`` holds every
result against the plain version (leave it off for a variant that is
wrong on purpose); ``--profile`` adds each launch's device operations by
name (torch.profiler); ``--sass`` counts, per kernel of the built
library, the SASS instructions that matter to these kernels (warp
matching, shared and global atomics, bulk copies, barriers), from
``cuobjdump``.  ``--modes`` picks from f32, bf16, int16 and int8 (int8
stats are the int16 ones over 16, as in ``chip_smoke.py``).

Two checkouts are compared by running the script for both, in turns, in
one call on one card.  The last line is a JSON summary with the sums
over the five shapes per kernel and mode, and the card's name and power
limit.
"""

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

OPS = ("MATCH", "REDUX", "VOTE", "ATOMS", "ATOMG", "ATOM", "RED", "UBLKCP",
       "SYNCS", "BAR", "LDS", "STS", "LDG", "SHFL")


def sass_counts(so: Path) -> dict:
    """{kernel name: {mnemonic: count}} for the library's kernels."""
    cuobjdump = "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)"
                      r"((?:\.[A-Z0-9_]+)*)", line)
        if name and m:
            op, mods = m.group(1), m.group(2)
            if op in OPS:
                key = op + mods
                out[name][key] = out[name].get(key, 0) + 1
    return out


def profile_launch(torch, kern, n: int = 4) -> dict:
    """Device ms per launch of every device operation one launch makes
    (its own kernels and the PyTorch ones around them), by name, from
    torch.profiler over ``n`` launches."""
    from torch.profiler import ProfilerActivity, profile
    kern()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            kern()
        torch.cuda.synchronize()
    per = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            key = ev.name[:60]
            per[key] = per.get(key, 0.0) + ev.device_time_total / 1e3 / n
    return per


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--modes", default="f32,int16",
                    help="of f32, bf16, int16, int8")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch
    import chip_smoke as cs
    from h2o_tpu_torch.ops import hist_kernels as hk
    from h2o_tpu_torch.ops.histogram import hist_plain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    lib = hk.build()
    regs = [ln.strip() for ln in lib.log.splitlines()
            if "registers" in ln or "spill" in ln]
    print(json.dumps(dict(tree=str(tree), library=lib.path.name,
                          build_s=lib.seconds, ptxas=regs)), flush=True)
    if args.sass:
        for fn, counts in sass_counts(lib.path).items():
            print(json.dumps(dict(sass=fn, counts=counts)), flush=True)

    modes = args.modes.split(",")
    rng = np.random.default_rng(0)
    sums = {}
    for name, shapes, make, run in (
            ("K1", [(L, 64) for L in (1, 2, 4, 8, 16)],
             cs.k1_inputs(rng), cs.run_k1),
            ("K2", [(1, 1024), (2, 512), (4, 256), (8, 128), (16, 64)],
             cs.k2_inputs(rng), cs.run_k2)):
        for (L, B) in shapes:
            bins, leaf, stats_f, stats_i, fm = make(L, B)
            for mode in modes:
                stats = {"int16": stats_i,
                         "int8": torch.div(stats_i, 16, rounding_mode="floor"
                                           ).to(torch.int8)}.get(mode, stats_f)
                bf16 = mode == "bf16"

                def kern():
                    return run(bins, leaf, stats, L, B, bf16, fm)

                rec = dict(kernel=name, L=L, B=B, mode=mode,
                           ms=cs.time_ms(kern))
                if args.profile:
                    rec["device_ms_per_launch"] = profile_launch(torch, kern)
                if args.check:
                    got = kern()
                    want = hist_plain(bins, leaf, stats, L, B, bf16=bf16,
                                      fine_map=fm)
                    rec["max_abs_err"] = (got.double() - want.double()).abs(
                    ).max().item()
                    rec["max_abs_plain"] = want.double().abs().max().item()
                print(json.dumps(rec), flush=True)
                sums[f"{name}_{mode}"] = sums.get(f"{name}_{mode}", 0.0) + \
                    rec["ms"]
            del bins, leaf, stats_f, stats_i
            torch.cuda.empty_cache()
    print(json.dumps(dict(tree=str(tree), nvidia_smi=smi,
                          sums_ms=sums)), flush=True)


if __name__ == "__main__":
    main()
