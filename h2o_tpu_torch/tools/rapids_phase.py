#!/usr/bin/env python3
"""Phase 26, 27, 28 or 29 of ``chip_smoke.py`` alone: the Rapids
interpreter on the port.

    python3 h2o_tpu_torch/tools/rapids_phase.py [--cpu] [--phase 26|27|28|29]

On the card it builds the histogram kernels, makes ``chip_smoke.py``'s
seeded 1,000,000 x 28 frame and runs ``phase_slice20`` (26a-26c, the
default), one JSON line an expression and a hold, then the launch counts
path by path; or ``phase_slice21`` (27: the string, time, date, text and
model ops), after training the models it reads: the default GBM and a
2-tree DRF on the frame, RuleFit at its defaults on the first 100,000
rows, a one-epoch Word2Vec on phase 18's 100,000-token corpus and phase
25b's segment GBMs; or ``phase_slice22`` (28: the frame and statistics
ops and the munged, cross-validated GBM) on phase 26's frame; or
``phase_slice23`` (29: the planner's fused regions against the same
expressions run verb by verb, the drill and the GBM on a fused frame)
on phase 26's frame.  ``--cpu`` rehearses the phase on the CPU at
20,000 rows (5,000 for phase 26's card-against-CPU and host-route runs
and the right frame, for phase 27's cut runs, for phase 28's cut,
card-against-CPU and GBM rows and for phase 29's card-against-CPU rows
and drill;
1,000 for phase 27's strDistance and 28's ``t``, 200 for 28's
``distance``): ``cloud(None)`` and
``"cuda"`` map to the CPU, and each plain histogram call is counted as
its kernel's launch, so the launch holds read what the card would
count.  It gives no device number.
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
        cs.RAPIDS_SUB_ROWS = cs.DP_RIGHT_ROWS = cs.R27_CUT_ROWS = 5_000
        cs.R27_DIST_ROWS = cs.R28_T_ROWS = 1_000
        cs.R28_CUT_ROWS, cs.R28_DIST_ROWS, cs.R28_CV_ROWS = 5_000, 200, 2_000
        cs.PVI_SAMPLES = 2_000
        cs.R29_SUB_ROWS = 5_000
        rows, smi = 20_000, "cpu rehearsal"
    else:
        cs.hk.build()
        rows = cs.R
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    phase = sys.argv[sys.argv.index("--phase") + 1] \
        if "--phase" in sys.argv else "26"
    X, y = cs.make_data(rows, cs.C, seed=0)
    fr = cs.frame(X, y)
    paths = {}
    t0 = time.perf_counter()
    if phase == "26":
        cs.phase_slice20(X, y, fr, smi, paths)
    elif phase == "28":
        cs.phase_slice22(cs.rapids_frames(fr)[0], smi, paths)
    elif phase == "29":
        cs.phase_slice23(cs.rapids_frames(fr)[0], smi, paths)
    else:
        models = phase27_models(cs, X, y, fr, paths)
        t0 = time.perf_counter()
        cs.phase_slice21(cs.rapids_frames(fr)[0], smi, *models)
    cs.emit(dict(phase="rapids_done", seconds=time.perf_counter() - t0,
                 paths={k: list(v) for k, v in paths.items()}))


def phase27_models(cs, X, y, fr, paths) -> tuple:
    """The models phase 27 reads, trained here: (GBM, DRF, {rulefit,
    word2vec, segments})."""
    import warnings
    from h2o_tpu_torch.core.frame import T_STR, Frame, Vec
    m_def, _ = cs.train(fr)
    m_drf, _ = cs.train_drf(fr, ntrees=2)
    rf, _ = cs.fit(cs.RuleFit, fr.slice_rows(slice(0, 100_000)), seed=1)
    corpus = Frame(["tokens"], [Vec(cs.zipf_tokens(
        cs.W2V_SUB_TOKENS, cs.W2V_TYPES, cs.W2V_SENTENCE, seed=2), T_STR)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        w2v, _ = cs.fit(cs.Word2Vec, corpus, epochs=1, seed=1)
    seg = cs.segments_25b(X, y, paths)
    return m_def, m_drf, dict(rulefit=rf, word2vec=w2v, segments=seg)


if __name__ == "__main__":
    main()
