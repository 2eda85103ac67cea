#!/usr/bin/env python3
"""Wall time of a full-width GBM training for one checkout of the
PyTorch/CUDA port on one GPU.

    python3 h2o_tpu_torch/tools/train_walls.py TREE [--config NAME]
        [--repeats 3]

TREE is the root of a checkout of this repository (``.`` for this one).
The script imports TREE's ``chip_smoke.py`` helpers and TREE's
``h2o_tpu_torch``, builds its kernels, makes ``chip_smoke.py``'s seeded
1,000,000 x 28 frame, trains once to warm up, then ``--repeats`` more
times: the GBM of ``chip_smoke.py`` phase 4 (``default``), phase 5
(``qg``) or phase 8 (``random_int16``, ``qg_int16``), 20 trees of depth
5, each wall ending in ``torch.cuda.synchronize()``.  One JSON line
per timed training (wall, training AUC), then a summary with the
median, the card's name and power limit, and the operations of one more
fit under ``torch.profiler``: the ``aten::`` calls on the host (nested
ones included) and the device operations.  The profiled fit is the
builder's ``_fit`` on the script's own thread, the work ``train`` does
in either checkout, wherever ``train`` runs it (a job's pool thread, in
a checkout with jobs).  Those counts do not vary between runs, so two
checkouts that show the same ones do the same work a tree.

Two checkouts are compared by running the script for both, in turns
(parent, change, change, parent), in one call on one card.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

#: phase 8's stochastic options with int16 stats
_INT16 = dict(sample_rate=0.7, col_sample_rate=0.8,
              col_sample_rate_per_tree=0.9, stats_dtype="int16")
CONFIGS = {"default": {},
           "qg": dict(histogram_type="QuantilesGlobal", nbins=64),
           "random_int16": dict(histogram_type="Random", **_INT16),
           "qg_int16": dict(histogram_type="QuantilesGlobal", nbins=64,
                            **_INT16)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree")
    ap.add_argument("--config", default="default", choices=sorted(CONFIGS))
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import chip_smoke as cs
    from h2o_tpu_torch.ops import hist_kernels as hk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    hk.build()
    X, y = cs.make_data(cs.R, cs.C, seed=0)
    fr = cs.frame(X, y)
    kw = CONFIGS[args.config]
    cs.train(fr, **kw)
    walls = []
    for i in range(args.repeats):
        m, wall = cs.train(fr, **kw)
        walls.append(wall)
        print(json.dumps(dict(tree=str(tree), config=args.config, run=i,
                              wall_s=wall, train_auc=m.output[
                                  "training_metrics"]["AUC"])), flush=True)
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    b = cs.GBM(**{"ntrees": 20, "max_depth": 5, "seed": 1, **kw})
    x, yname = b._columns(None, "y", fr)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        b._fit(x, yname, fr, None)
        cs.sync()
    evs = prof.events()
    print(json.dumps(dict(
        tree=str(tree), config=args.config,
        median_wall_s=statistics.median(walls), walls_s=walls, device=smi,
        host_aten_ops=sum(ev.device_type == DeviceType.CPU
                          and ev.name.startswith("aten::") for ev in evs),
        device_ops=sum(ev.device_type == DeviceType.CUDA for ev in evs))),
        flush=True)


if __name__ == "__main__":
    main()
