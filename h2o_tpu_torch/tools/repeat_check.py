#!/usr/bin/env python3
"""Card probe: do the port's decisions repeat bitwise over three runs?

    python3 h2o_tpu_torch/tools/repeat_check.py TREE [--runs 3]

TREE is the root of a checkout of this repository (``.`` for this one).
The script imports TREE's ``chip_smoke.py`` helpers and TREE's
``h2o_tpu_torch``, builds its kernels, and trains on the card, ``--runs``
times each with one seed:

* a binomial GBM on the first 100,000 rows of ``chip_smoke.py``'s
  1,000,000 x 28 frame, with weights drawn uniform in [0.5, 2) and
  ``stopping_metric="AUC"``, ``stopping_rounds=3``,
  ``score_tree_interval=1``;
* a 7-class GBM on the first 100,000 rows of the covertype-shaped frame,
  with the same weights, ``stopping_rounds=3`` and
  ``score_tree_interval=1``.

Each run's scoring history, tree count, variable importances and final
training metrics (the threshold table built from the AUC bins ``pos`` /
``neg``, the confusion matrix) are compared with the first run's, and
the final model's ``pos`` / ``neg`` bins are recomputed ``--runs`` times.
Then KMeans' Lloyd step and GLRM's alternating step and objective, the
GEMMs of ``models/kmeans.py`` and ``models/glrm.py``, run ``--runs``
times at one state.  Then ``--runs`` trainings each of a weighted
binomial GLM by IRLSM and by L-BFGS (their betas, iterations, deviances)
and of one DeepLearning step (its weights and biases: ``epochs`` sized to
one minibatch of 1,024 rows) on the same weighted rows.  Fractional
weights make the sums order-dependent in their last place, so an
``index_add_`` (atomics on the card) shows here.

Prints the card's name and power limit, one JSON line per case (which
parts repeated bitwise, and where a part moved, its largest difference)
and a summary.  ``chip_smoke.py`` phase 23g calls :func:`repeat_check`.

With ``--costs`` it times instead the metrics whose sums the repair
moved (:func:`metric_costs`); compare two checkouts in turns (parent,
change, change, parent) in one call.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROWS = 100_000
WEIGHT_SEED = 23
BINOMIAL = dict(ntrees=50, max_depth=5, seed=1, weights_column="w",
                stopping_metric="AUC", stopping_rounds=3,
                score_tree_interval=1)
MULTINOMIAL = dict(ntrees=10, max_depth=5, seed=1, weights_column="w",
                   stopping_rounds=3, score_tree_interval=1)
KM_K = 10
GLRM_K = 10
GLM_SOLVERS = {"glm_irlsm": dict(solver="IRLSM"),
               "glm_lbfgs": dict(solver="L_BFGS")}
#: one step: DeepLearning takes max(1, epochs * rows / 1,024) minibatches
DL = dict(hidden=[200, 200], epochs=1024 / ROWS, seed=1)


def weighted(fr, seed: int = WEIGHT_SEED):
    """The frame's first ROWS rows with a weights column ``w`` drawn
    uniform in [0.5, 2)."""
    from h2o_tpu_torch.core.frame import Vec
    sub = fr.slice_rows(slice(0, ROWS))
    w = np.random.default_rng(seed).uniform(0.5, 2.0, size=sub.nrows)
    return sub.add("w", Vec(w.astype(np.float32)))


def _plain(obj):
    """A host copy of a model output part: tensors as numpy arrays."""
    if isinstance(obj, dict):
        return {str(k): _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if torch.is_tensor(obj):
        return obj.cpu().numpy()
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    return obj


def _same(a, b) -> bool:
    """Bitwise equality of two parts (NaN equal to NaN of the same bits)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and \
            all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and \
            all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.shape == b.shape and \
            a.dtype == b.dtype and a.tobytes() == b.tobytes()
    if isinstance(a, float):
        return isinstance(b, float) and \
            np.float64(a).tobytes() == np.float64(b).tobytes()
    return a == b


def _numbers(obj) -> np.ndarray:
    """Every number of a part, in order, as float64."""
    if isinstance(obj, dict):
        parts = [_numbers(obj[k]) for k in sorted(obj)]
    elif isinstance(obj, list):
        parts = [_numbers(x) for x in obj]
    elif isinstance(obj, np.ndarray) and obj.dtype.kind in "biuf":
        return obj.astype(np.float64).ravel()
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        return np.array([float(obj)])
    else:
        return np.zeros(0)
    return np.concatenate(parts) if parts else np.zeros(0)


def _max_diff(a: np.ndarray, b: np.ndarray) -> float:
    """The largest absolute difference of two number lists (inf where
    their lengths differ)."""
    if a.shape != b.shape:
        return float("inf")
    both_nan = np.isnan(a) & np.isnan(b)
    d = np.abs(a - b)[~both_nan]
    return float(np.nan_to_num(d, nan=np.inf).max()) if d.size else 0.0


def compare(parts: list) -> dict:
    """``{"equal": {part: bool}, "max_abs_diff": {part: x}}`` of each
    run's parts against the first run's."""
    first = parts[0]
    equal, diff = {}, {}
    for k in first:
        equal[k] = all(_same(first[k], p[k]) for p in parts[1:])
        if not equal[k]:
            diff[k] = max(_max_diff(_numbers(first[k]), _numbers(p[k]))
                          for p in parts[1:])
    return dict(equal=equal, max_abs_diff=diff)


def _gbm_parts(m, fr, device) -> dict:
    from h2o_tpu_torch.models import metrics as mm
    out = m.output
    tm = out["training_metrics"]
    # a history row's wall-clock timestamp is the one part that may move
    history = [{k: v for k, v in row.items() if k != "timestamp"}
               for row in out["scoring_history"]]
    parts = dict(scoring_history=_plain(history),
                 ntrees=int(out["ntrees_actual"]),
                 varimp=_plain(out["varimp"]))
    if tm.get("thresholds_and_metric_scores") is not None:
        parts["threshold_table"] = _plain(tm["thresholds_and_metric_scores"])
        parts["auc"] = tm["AUC"]
        pred = m.predict(fr)
        p1 = torch.from_numpy(pred.vecs[-1].data).to(device)
        y = torch.from_numpy(fr.vec("y").as_float()).to(device)
        w = torch.from_numpy(fr.vec("w").as_float()).to(device)
        valid = torch.ones_like(p1, dtype=torch.bool)
        parts["pos_neg"] = [_plain({k: r[k] for k in ("pos", "neg")})
                            for r in (mm._binomial_reduce(p1, y, w, valid)
                                      for _ in range(3))]
    else:
        parts["confusion_matrix"] = _plain(tm["cm"])
        parts["logloss"] = tm["logloss"]
    return parts


def _train(cls, fr, kw, device):
    """(model, wall s) of one training on ``device``."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    m = cls(device=device, **kw).train(y="y", training_frame=fr)
    sync()
    return m, time.perf_counter() - t0


def gbm_repeat(name: str, fr, kw: dict, runs: int, device) -> dict:
    """``runs`` trainings of one GBM and what repeated."""
    from h2o_tpu_torch.models.tree.gbm import GBM
    parts, walls = [], []
    for _ in range(runs):
        m, wall = _train(GBM, fr, kw, device)
        walls.append(wall)
        parts.append(_gbm_parts(m, fr, device))
    rec = compare(parts)
    if "pos_neg" in parts[0]:
        # the bins of one model recomputed: equal calls of one function
        bins = parts[0]["pos_neg"]
        rec["equal"]["pos_neg_within_a_run"] = all(
            _same(b, bins[0]) for b in bins)
    return dict(case=name, rows=fr.nrows, runs=runs,
                trees=[p["ntrees"] for p in parts], walls_s=walls, **rec)


def kmeans_repeat(fr, runs: int, device) -> dict:
    """Lloyd steps and minimum distances at one state, ``runs`` times."""
    from h2o_tpu_torch.models import kmeans as km
    X = fr.as_matrix([n for n in fr.names if n.startswith("x")], device)
    centers = X[:KM_K].clone()
    parts = []
    for _ in range(runs):
        assign, new_c, cnts, wss = km._lloyd_step(X, centers, KM_K)
        parts.append(dict(assign=_plain(assign), centers=_plain(new_c),
                          counts=_plain(cnts), wss=_plain(wss),
                          min_dist2=_plain(km._min_dist2(X, new_c))))
    return dict(case="kmeans_lloyd_step", rows=X.shape[0], k=KM_K,
                runs=runs, **compare(parts))


def glrm_repeat(fr, runs: int, device) -> dict:
    """GLRM's alternating step and objective at one state, ``runs``
    times, on the matrix with 10 % of its cells missing."""
    from h2o_tpu_torch.models import glrm
    A = fr.as_matrix([n for n in fr.names if n.startswith("x")], device)
    g = torch.Generator(device="cpu").manual_seed(3)
    miss = (torch.rand(A.shape, generator=g) < 0.1).to(device)
    A = torch.where(miss, torch.full_like(A, float("nan")), A)
    prob = glrm._Problem(A, ~miss, "Quadratic", "Quadratic", "Quadratic",
                         0.1, 0.1)
    X0 = torch.randn(A.shape[0], GLRM_K, generator=g).to(device)
    Y0 = torch.randn(GLRM_K, A.shape[1], generator=g).to(device)
    alpha = torch.tensor(1e-6, device=device)
    parts = []
    for _ in range(runs):
        Xn, Yn = prob.step(X0, Y0, alpha)
        parts.append(dict(x=_plain(Xn), y=_plain(Yn),
                          objective=prob.objective(Xn, Yn)))
    return dict(case="glrm_step", rows=A.shape[0], k=GLRM_K, runs=runs,
                **compare(parts))


def glm_repeat(name: str, fr, kw: dict, runs: int, device) -> dict:
    """``runs`` weighted binomial GLM fits by one solver: what
    repeated."""
    from h2o_tpu_torch.models.glm import GLM
    parts, walls = [], []
    for _ in range(runs):
        m, wall = _train(GLM, fr, dict(family="binomial",
                                       weights_column="w", **kw), device)
        walls.append(wall)
        out = m.output
        parts.append(dict(beta=_plain(out["beta"]),
                          iterations=_plain(out.get("iterations")),
                          residual_deviance=_plain(
                              out.get("residual_deviance"))))
    return dict(case=name, rows=fr.nrows, runs=runs, walls_s=walls,
                **compare(parts))


def dl_repeat(fr, runs: int, device) -> dict:
    """``runs`` one-step DeepLearning trainings: their weights and
    biases."""
    from h2o_tpu_torch.models.deeplearning import DeepLearning
    parts, walls = [], []
    for _ in range(runs):
        m, wall = _train(DeepLearning, fr, dict(DL, weights_column="w"),
                         device)
        walls.append(wall)
        parts.append(dict(steps=int(m.output["steps"]),
                          weights=_plain(m.output["weights"])))
    return dict(case="deeplearning_step", rows=fr.nrows, runs=runs,
                steps=parts[0]["steps"], walls_s=walls, **compare(parts))


def repeat_check(fr, cov, runs: int = 3, device="cuda") -> list:
    """Every case of the probe on ``fr`` (a 1M x 28 binomial frame) and
    ``cov`` (the covertype-shaped frame); a list of records."""
    dev = torch.device(device)
    fb, fc = weighted(fr), weighted(cov)
    return [gbm_repeat("binomial_gbm_weighted_auc_stopping", fb, BINOMIAL,
                       runs, dev),
            gbm_repeat("multinomial_gbm_weighted", fc, MULTINOMIAL, runs,
                       dev),
            kmeans_repeat(fb, runs, dev),
            glrm_repeat(fb, runs, dev)] + \
        [glm_repeat(name, fb, kw, runs, dev)
         for name, kw in GLM_SOLVERS.items()] + [dl_repeat(fb, runs, dev)]


def metric_costs(device, reps: int = 20) -> list:
    """Host-clock ms (median of ``reps`` synchronized calls) of the
    metrics whose sums F8 touched: binomial metrics over 250,000 rows
    (the training loop's validation frame) and over 1M rows whose
    scores crowd the lowest bins, and multinomial metrics over the
    covertype frame's 581,012 rows; fractional weights."""
    from h2o_tpu_torch.models import metrics as mm
    g = torch.Generator(device="cpu").manual_seed(5)
    cases = []
    for name, n, power in (("binomial_250k", 250_000, 1),
                           ("binomial_1m_low_scores", 1_000_000, 8)):
        p = torch.rand(n, generator=g) ** power
        y = (torch.rand(n, generator=g) < p).to(torch.float32)
        w = 0.5 + 1.5 * torch.rand(n, generator=g)
        args = [t.to(device) for t in (p, y, w)]
        cases.append((name, n, mm.binomial_metrics, args))
    n = 581_012
    probs = torch.softmax(2 * torch.randn(n, 7, generator=g), dim=1)
    y = torch.randint(0, 7, (n,), generator=g).to(torch.float32)
    w = 0.5 + 1.5 * torch.rand(n, generator=g)
    cases.append(("multinomial_581k", n, mm.multinomial_metrics,
                  [t.to(device) for t in (probs, y, w)]))
    out = []
    for name, rows, fn, args in cases:
        fn(*args)
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize(device)
            walls.append((time.perf_counter() - t0) * 1e3)
        out.append(dict(case=name, rows=rows, reps=reps,
                        median_ms=float(np.median(walls)),
                        min_ms=float(np.min(walls))))
    return out


def all_equal(records: list) -> bool:
    return all(all(r["equal"].values()) for r in records)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--costs", action="store_true",
                    help="time the metrics F8 touched instead")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import chip_smoke as cs
    from h2o_tpu_torch.ops import hist_kernels as hk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if args.costs:
        for r in metric_costs(torch.device("cuda")):
            print(json.dumps(dict(tree=str(tree), gpu=smi, **r)), flush=True)
        return
    hk.build()
    X, y = cs.make_data(cs.R, cs.C, seed=0)
    records = repeat_check(cs.frame(X, y), cs.make_covertype(seed=0),
                           args.runs)
    for r in records:
        print(json.dumps(dict(tree=str(tree), **r)), flush=True)
    print(json.dumps(dict(tree=str(tree), summary=True, gpu=smi,
                          all_equal=all_equal(records),
                          moved=[f"{r['case']}.{k}" for r in records
                                 for k, v in r["equal"].items() if not v])),
          flush=True)


if __name__ == "__main__":
    main()
