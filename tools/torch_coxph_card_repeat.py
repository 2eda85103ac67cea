"""Card probe: does CoxPH's Newton state repeat bitwise at one beta?

    python3 tools/torch_coxph_card_repeat.py

Needs one CUDA card. On ``chip_smoke.py``'s 1M x 28 CoxPH frame, for
Efron and Breslow ties, it fits the model, then evaluates at the fitted
beta with the likelihood's group sums as ``index_add_`` (atomics) and as
the port's ``RiskSets.segsum`` (``index_put_``'s sorted accumulate): 20
likelihood calls (distinct values), 5 Newton states (is the Hessian
bitwise the same?) and a state's mean host-clock ms over 5 more. Then it
fits 100,000 rows four times on the card (identical fits? iterations).
Prints the card's name and power limit, then one JSON line per case.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs                                   # noqa: E402
from h2o_tpu_torch.models import coxph as cm              # noqa: E402


def atomic_segsum(self, v):
    out = torch.zeros(self.n_groups, dtype=v.dtype, device=v.device)
    return out.index_add(0, self.group, v)


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    X, _ = cs.make_data(cs.R, cs.C, seed=0)
    fr = cs.cox_frame(X)
    sub = cs.cox_frame(X[:cs.SUB_ROWS], seed=5)
    sorted_segsum = cm.RiskSets.segsum
    for ties in ("efron", "breslow"):
        with cs.CoxProbe() as pr:
            m, _ = cs.fit_cox(fr, ties=ties)
        rs, b = pr.rs, m.output["coef"]
        try:
            for name, fn in (("index_add", atomic_segsum),
                             ("index_put", sorted_segsum)):
                cm.RiskSets.segsum = fn
                nlls = [rs.nll(b) for _ in range(20)]
                Hs = [rs.state(b)[2] for _ in range(5)]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    rs.state(b)
                torch.cuda.synchronize()
                print(json.dumps(dict(
                    ties=ties, segsum=name, rows=cs.R,
                    distinct_nll=len(set(nlls)),
                    hessian_bitwise_stable=all(np.array_equal(Hs[0], h)
                                               for h in Hs),
                    state_ms=(time.perf_counter() - t0) / 5 * 1e3)),
                    flush=True)
        finally:
            cm.RiskSets.segsum = sorted_segsum
        fits = []
        for _ in range(4):
            g, _ = cs.fit_cox(sub, ties=ties)
            fits.append((g.output["iterations"], float(g.output["loglik"]),
                         g.output["coef"].tobytes()))
        print(json.dumps(dict(ties=ties, rows=cs.SUB_ROWS,
                              fits_identical=all(f == fits[0] for f in fits),
                              iterations=[f[0] for f in fits])), flush=True)


if __name__ == "__main__":
    main()
