#!/usr/bin/env python3
"""Phase 30 of ``chip_smoke.py`` alone: the serving engine's CUDA graphs
through the executable store and the OOM ladder drill.

    python3 h2o_tpu_torch/tools/serving_phase.py [--cpu]

On the card it builds the histogram kernels, makes ``chip_smoke.py``'s
seeded 1,000,000 x 28 frame, trains the deployments phase 30 reads (the
default GBM, the default DRF with ``DRF_TREES`` trees and the default
binomial GLM, as phases 4, 9 and 16 train them) and runs
``phase_slice24``: one JSON line a hold, then the launch counts.
``--cpu`` rehearses it on the CPU at 20,000 rows: ``cloud(None)`` and
``"cuda"`` map to the CPU, each plain histogram call is counted as its
kernel's launch, the CUDA memory readings read 0 and 30c (a real device
OOM) is skipped; the engine's entries run eagerly there, so it checks
the phase's control flow and counters, and gives no device number.
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
        for fn in ("memory_allocated", "memory_reserved"):
            setattr(torch.cuda, fn, lambda *a, **k: 0)
        torch.cuda.empty_cache = lambda: None
        torch.cuda.synchronize = lambda *a, **k: None
        rows, smi = 20_000, "cpu rehearsal"
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
    m_def, _ = cs.train(fr)
    m_drf, _ = cs.train_drf(fr)
    m_glm = cs.fit_glm(fr)[0]
    t0 = time.perf_counter()
    cs.phase_slice24(X, fr, dict(gbm=m_def, drf=m_drf, glm=m_glm), smi,
                     paths)
    cs.emit(dict(phase="serving_done", seconds=time.perf_counter() - t0,
                 oom_outside=cs.oom_outside("the end"),
                 paths={k: list(v) for k, v in paths.items()}))


if __name__ == "__main__":
    main()
