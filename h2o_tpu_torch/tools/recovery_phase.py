#!/usr/bin/env python3
"""Phase 31 of ``chip_smoke.py`` alone: recovery snapshots and iteration
checkpoints, builds killed and resumed by ``auto_recover``.

    python3 h2o_tpu_torch/tools/recovery_phase.py [--cpu]

On the card it builds the histogram kernels, makes ``chip_smoke.py``'s
seeded 1,000,000 x 28 frame and runs ``phase_slice25``: one JSON line a
hold, then the launch counts of its trainings.  ``--cpu`` rehearses it
on the CPU at 20,000 rows (its 100,000-row builds on 5,000): ``cloud(None)``
and ``"cuda"`` map to the CPU and each plain histogram call is counted
as its kernel's launch, so it checks the phase's control flow, holds and
counters, and gives no device number.
"""

import os
import subprocess
import sys
import time


def main() -> None:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import torch
    cpu = "--cpu" in sys.argv
    if cpu:
        torch.cuda.is_available = lambda: True
    import chip_smoke as cs
    if cpu:
        import h2o_tpu_torch.core.device as devmod
        from h2o_tpu_torch.ops import hist_kernels as hk
        from h2o_tpu_torch.ops import histogram as hmod
        real_cloud = devmod.cloud

        def cpu_cloud(device=None):
            if device is None or str(device).startswith("cuda"):
                device = "cpu"
            return real_cloud(device)

        for name, mod in list(sys.modules.items()):
            if name.startswith("h2o_tpu_torch") and \
                    getattr(mod, "cloud", None) is real_cloud:
                mod.cloud = cpu_cloud
        plain = hmod.hist_plain

        def counted(*a, fine_map=None, **k):
            f = hk.hist_cuda if fine_map is None else hk.hist_cuda_adaptive
            with hk._COUNT_LOCK:
                f.launches += 1
            return plain(*a, fine_map=fine_map, **k)

        hmod.hist_plain = counted
        cs.DEV = torch.device("cpu")
        cs.sync = lambda: None
        torch.cuda.empty_cache = lambda: None
        torch.cuda.device_count = lambda: 0
        rows, smi = 20_000, "cpu rehearsal"
        cs.REC_SUB_ROWS = 5_000
    else:
        cs.hk.build()
        rows = cs.R
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    X, y = cs.make_data(rows, cs.C, seed=0)
    fr = cs.frame(X, y)
    paths = {}
    t0 = time.perf_counter()
    cs.phase_slice25(fr, smi, paths)
    cs.emit(dict(phase="recovery_done", seconds=time.perf_counter() - t0,
                 paths={k: list(v) for k, v in paths.items()}))


if __name__ == "__main__":
    main()
