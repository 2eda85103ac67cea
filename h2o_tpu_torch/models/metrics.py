"""Model metrics — port of ``h2o_tpu/models/metrics.py``
(``_binomial_kernel`` :27-45, ``_auc_from_hist`` :48-69,
``_regression_kernel`` :72-92 with RMSLE, ``_multinomial_kernel`` :96-116,
``ModelMetrics`` :118-142, ``regression_metrics`` :145-166,
``twodim_json`` :169-186, ``_threshold_tables`` :189-255,
``binomial_metrics`` :258-280, ``multinomial_metrics`` :283-307), and of
the anomaly metrics (``h2o_tpu/models/tree/isofor.py:147-151``), the
uplift metrics (``h2o_tpu/models/tree/uplift.py:272-292``), KMeans's
clustering metrics (``h2o_tpu/models/kmeans.py:79-100``), the
autoencoder's reconstruction metrics
(``h2o_tpu/models/deeplearning.py:287-294``), and the metrics of PCA and
SVD (``pca.py:54-57``, ``svd.py:75-77``), GLRM (``glrm.py:197-201``),
Word2Vec (``word2vec.py:153-156``), CoxPH (``coxph.py:110-115``),
Aggregator (``aggregator.py:83-86``), TargetEncoder
(``target_encoder.py:97-100``), ModelSelection
(``modelselection.py:55-58``), AnovaGLM (``anovaglm.py:92-94``),
Infogram (``infogram.py:67-69``) and Grep (``grep.py:34-36``).

Binomial AUC comes from a fixed 1024-bin histogram of the scores (the
reference's AUC2 analog), so it reduces in O(bins).  Reductions are
float32 tensor code on the scores' device; the bin sweep, the threshold
tables (``thresholds_and_metric_scores`` and
``max_criteria_and_metric_scores``, in the TwoDimTableV3 layout the
clients read), the anomaly means and the uplift curve run in numpy on
the host, copied from the reference.  Every metric a stopping metric can
name (``models/score_keeper.py`` ``_KEYS``) is produced where the
reference produces it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from h2o_tpu_torch.ops.segment import segment_sum

_NBINS_AUC = 1024
EPS = 1e-15


def _binomial_reduce(p, y, w, valid, nbins: int = _NBINS_AUC):
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    w = torch.where(valid, w, zero)
    y = torch.where(valid, y, zero)
    p = torch.where(valid, p, torch.full_like(p, 0.5))
    wsum = torch.clamp_min(torch.sum(w), EPS)
    logloss = torch.sum(-w * torch.where(
        y > 0.5, torch.log(torch.clamp_min(p, EPS)),
        torch.log(torch.clamp_min(1.0 - p, EPS))))
    mse = torch.sum(w * (y - p) ** 2)
    b = torch.clamp((p * nbins).to(torch.int32), 0, nbins - 1).long()
    pos = segment_sum(w * y, b, nbins)
    neg = segment_sum(w * (1 - y), b, nbins)
    return dict(logloss=(logloss / wsum).item(), mse=(mse / wsum).item(),
                pos=pos.cpu().numpy(), neg=neg.cpu().numpy(),
                wsum=wsum.item())


def _auc_from_hist(pos: np.ndarray, neg: np.ndarray) -> Dict[str, float]:
    """Exact bin-sweep AUC/PR-AUC/max-F1 from score histograms
    (thresholds descend bin edges; trapezoids between)."""
    tp = np.cumsum(pos[::-1])
    fp = np.cumsum(neg[::-1])
    P, N = max(tp[-1], EPS), max(fp[-1], EPS)
    tpr = np.concatenate([[0.0], tp / P])
    fpr = np.concatenate([[0.0], fp / N])
    auc = float(np.trapezoid(tpr, fpr))
    prec = tp / np.maximum(tp + fp, EPS)
    rec = tp / P
    pr_auc = float(np.sum(np.diff(np.concatenate([[0.0], rec])) * prec))
    f1 = 2 * prec * rec / np.maximum(prec + rec, EPS)
    k = int(np.argmax(f1))
    nb = len(pos)
    thr = 1.0 - (k + 1) / nb
    cm = dict(tp=float(tp[k]), fp=float(fp[k]),
              fn=float(P - tp[k]), tn=float(N - fp[k]))
    return dict(AUC=auc, pr_auc=pr_auc, gini=2 * auc - 1,
                max_f1=float(f1[k]), max_f1_threshold=thr, cm=cm)


def twodim_json(name, col_header, col_types, rows, description=""):
    """TwoDimTableV3 wire JSON (column-major ``data``, one column spec a
    header), the layout h2o-py's ``two_dim_table.py`` parses."""
    ncol = len(col_header)
    data = [[r[j] for r in rows] for j in range(ncol)]
    return {
        "__meta": {"schema_version": 3, "schema_name": "TwoDimTableV3",
                   "schema_type": "TwoDimTable"},
        "name": name, "description": description,
        "columns": [{"__meta": {"schema_version": -1,
                                "schema_name": "ColumnSpecsBase",
                                "schema_type": "Iced"},
                     "name": n, "type": t, "format": "%s", "description": n}
                    for n, t in zip(col_header, col_types)],
        "rowcount": len(rows),
        "data": data,
    }


# AUC2.ThresholdCriterion.VALUES order (hex/AUC2.java:43-95): clients
# index a thresholds_and_metric_scores row by position
_THRESHOLD_CRITERIA = (
    "f1", "f2", "f0point5", "accuracy", "precision", "recall",
    "specificity", "absolute_mcc", "min_per_class_accuracy",
    "mean_per_class_accuracy", "tns", "fns", "fps", "tps",
    "tnr", "fnr", "fpr", "tpr")
_INT_CRITERIA = ("tns", "fns", "fps", "tps")


def _threshold_tables(pos: np.ndarray, neg: np.ndarray):
    """thresholds_and_metric_scores and max_criteria_and_metric_scores
    from the AUC score histograms, one row a non-empty bin, thresholds
    descending (ModelMetricsBinomialV3.java:70-120); (None, None) when
    every bin is empty."""
    nb = len(pos)
    pos_d, neg_d = pos[::-1], neg[::-1]
    keep = (pos_d + neg_d) > 0
    tp = np.cumsum(pos_d)[keep]
    fp = np.cumsum(neg_d)[keep]
    ths = (1.0 - (np.arange(nb) + 1.0) / nb)[keep]
    n = len(tp)
    if n == 0:
        return None, None
    P = max(tp[-1], EPS)
    N = max(fp[-1], EPS)
    fn, tn = P - tp, N - fp
    with np.errstate(divide="ignore", invalid="ignore"):
        prec = tp / np.maximum(tp + fp, EPS)
        tpr = tp / P
        tnr = tn / N
        vals = {
            "f1": 2 * prec * tpr / np.maximum(prec + tpr, EPS),
            "f2": 5 * prec * tpr / np.maximum(4 * prec + tpr, EPS),
            "f0point5": 1.25 * prec * tpr / np.maximum(
                0.25 * prec + tpr, EPS),
            "accuracy": (tp + tn) / (P + N),
            "precision": prec, "recall": tpr, "specificity": tnr,
            "absolute_mcc": np.abs(
                (tp * tn - fp * fn) / np.sqrt(np.maximum(
                    (tp + fp) * (tp + fn) * (tn + fp) * (tn + fn), EPS))),
            "min_per_class_accuracy": np.minimum(tpr, tnr),
            "mean_per_class_accuracy": 0.5 * (tpr + tnr),
            "tns": tn, "fns": fn, "fps": fp, "tps": tp,
            "tnr": tnr, "fnr": fn / P, "fpr": fp / N, "tpr": tpr,
        }
    rows = []
    for i in range(n):
        row = [float(ths[i])]
        for c in _THRESHOLD_CRITERIA:
            v = vals[c][i]
            row.append(int(v) if c in _INT_CRITERIA else float(v))
        row.append(i)
        rows.append(row)
    thresh_tbl = twodim_json(
        "Metrics for Thresholds",
        ["threshold"] + list(_THRESHOLD_CRITERIA) + ["idx"],
        ["double"] + ["long" if c in _INT_CRITERIA else "double"
                      for c in _THRESHOLD_CRITERIA] + ["int"],
        rows, "Binomial metrics as a function of classification thresholds")
    max_rows = []
    for c in _THRESHOLD_CRITERIA:
        k = int(np.argmax(vals[c]))
        max_rows.append([f"max {c}", float(ths[k]), float(vals[c][k]), k])
    max_tbl = twodim_json(
        "Maximum Metrics", ["metric", "threshold", "value", "idx"],
        ["string", "double", "double", "long"], max_rows,
        "Maximum metrics at their respective thresholds")
    return thresh_tbl, max_tbl


class ModelMetrics:
    """Host-side metrics bundle."""

    def __init__(self, kind: str, data: Dict):
        self.kind = kind
        self.data = data

    def __getitem__(self, k):
        return self.data[k]

    def get(self, k, default=None):
        return self.data.get(k, default)

    def __repr__(self):
        keys = ("mse rmse mae r2 mean_residual_deviance logloss AUC "
                "err").split()
        parts = [f"{k}={self.data[k]:.5g}" for k in keys
                 if isinstance(self.data.get(k), (int, float))]
        return f"<ModelMetrics{self.kind.capitalize()} {' '.join(parts)}>"


def binomial_metrics(p1: torch.Tensor, y: torch.Tensor,
                     w: Optional[torch.Tensor] = None,
                     valid: Optional[torch.Tensor] = None,
                     domain=None) -> ModelMetrics:
    """p1: P(class 1); y: {0, 1} float with NaN = missing response."""
    y = y.to(torch.float32)
    valid = torch.ones_like(p1, dtype=torch.bool) if valid is None else valid
    valid = valid & ~torch.isnan(y)
    w = torch.ones_like(p1) if w is None else w
    r = _binomial_reduce(p1, y, w, valid)
    sweep = _auc_from_hist(r["pos"], r["neg"])
    cm = sweep["cm"]
    data = dict(mse=r["mse"], rmse=float(np.sqrt(r["mse"])),
                logloss=r["logloss"], nobs=r["wsum"],
                mean_per_class_error=float(
                    0.5 * (cm["fn"] / max(cm["fn"] + cm["tp"], EPS) +
                           cm["fp"] / max(cm["fp"] + cm["tn"], EPS))),
                domain=list(domain) if domain else ["0", "1"], **sweep)
    data["thresholds_and_metric_scores"], \
        data["max_criteria_and_metric_scores"] = _threshold_tables(
            r["pos"], r["neg"])
    return ModelMetrics("binomial", data)


def regression_metrics(pred: torch.Tensor, y: torch.Tensor,
                       w: Optional[torch.Tensor] = None,
                       valid: Optional[torch.Tensor] = None,
                       distribution=None) -> ModelMetrics:
    """Regression metrics; the deviance is the distribution's (its
    log-link families read ``pred`` on the response scale), else the
    weighted squared error."""
    valid = torch.ones_like(pred, dtype=torch.bool) if valid is None \
        else valid
    valid = valid & ~torch.isnan(y) & ~torch.isnan(pred)
    w = torch.ones_like(pred) if w is None else w
    if distribution is not None:
        dev = distribution.deviance(
            w, y, distribution.link_fn(torch.clamp_min(pred, EPS))
            if distribution.link == "log" else pred)
    else:
        dev = w * (y - pred) ** 2
    zero = torch.zeros((), dtype=pred.dtype, device=pred.device)
    w = torch.where(valid, w, zero)
    y = torch.where(valid, y, zero)
    pred = torch.where(valid, pred, zero)
    wsum = torch.clamp_min(torch.sum(w), EPS)
    err = y - pred
    mse = torch.sum(w * err ** 2) / wsum
    mae = torch.sum(w * torch.abs(err)) / wsum
    ymean = torch.sum(w * y) / wsum
    sstot = torch.sum(w * (y - ymean) ** 2) / wsum
    mean_dev = torch.sum(torch.where(valid, dev, zero)) / wsum
    ok_log = (y > -1) & (pred > -1)
    lo = torch.tensor(-1 + EPS, dtype=pred.dtype, device=pred.device)
    rmsle2 = torch.sum(torch.where(ok_log, w, zero) *
                       (torch.log1p(torch.maximum(y, lo)) -
                        torch.log1p(torch.maximum(pred, lo))) ** 2) / wsum
    rmsle_ok = bool(torch.all(ok_log | ~valid))
    data = dict(mse=mse.item(), rmse=float(np.sqrt(mse.item())),
                mae=mae.item(),
                r2=(1 - mse / torch.clamp_min(sstot, EPS)).item(),
                mean_residual_deviance=mean_dev.item(), nobs=wsum.item(),
                rmsle=float(np.sqrt(rmsle2.item())) if rmsle_ok
                else float("nan"))
    return ModelMetrics("regression", data)


def multinomial_metrics(probs: torch.Tensor, y: torch.Tensor,
                        w: Optional[torch.Tensor] = None,
                        valid: Optional[torch.Tensor] = None,
                        domain=None) -> ModelMetrics:
    """probs: (rows, K) class probabilities; y: class codes as float
    with NaN = missing.  Logloss, error rate, MSE (1 - p_true)^2, the
    confusion matrix (rows actual, columns predicted), mean per-class
    error and top-k hit ratios (k = 1..min(10, K))."""
    K = probs.shape[1]
    valid = torch.ones(probs.shape[:1], dtype=torch.bool,
                       device=probs.device) if valid is None else valid
    valid = valid & ~torch.isnan(y)
    w = torch.ones(probs.shape[:1], dtype=probs.dtype,
                   device=probs.device) if w is None else w
    zero = torch.zeros((), dtype=probs.dtype, device=probs.device)
    w = torch.where(valid, w, zero)
    y = torch.where(valid, y, zero)
    probs = torch.where(valid[:, None], probs,
                        torch.full_like(probs, 1.0 / K))
    wsum = torch.clamp_min(torch.sum(w), EPS)
    yi = torch.clamp(y.to(torch.int32), 0, K - 1).long()
    py = torch.gather(probs, 1, yi[:, None])[:, 0]
    logloss = torch.sum(-w * torch.log(torch.clamp(py, EPS, 1.0))) / wsum
    pred = torch.argmax(probs, dim=1)
    err = torch.sum(w * (pred != yi)) / wsum
    cm = segment_sum(w, yi * K + pred, K * K)
    rank = torch.sum(probs > py[:, None], dim=1)
    hits = torch.stack([torch.sum(w * (rank <= k)) / wsum
                        for k in range(min(10, K))])
    mse = torch.sum(w * (1.0 - py) ** 2) / wsum
    cmat = cm.reshape(K, K).cpu().numpy()
    row_tot = cmat.sum(axis=1)
    per_class_err = np.where(row_tot > 0, 1.0 - np.diagonal(cmat) /
                             np.maximum(row_tot, 1e-12), 0.0)
    data = dict(logloss=logloss.item(), err=err.item(), mse=mse.item(),
                rmse=float(np.sqrt(mse.item())),
                mean_per_class_error=float(per_class_err.mean()), cm=cmat,
                hit_ratios=hits.cpu().numpy().tolist(), nobs=wsum.item(),
                domain=list(domain) if domain else
                [str(i) for i in range(K)])
    return ModelMetrics("multinomial", data)


def anomaly_metrics(raw: np.ndarray) -> ModelMetrics:
    """Mean anomaly score and mean path length of (rows, 2) host
    predictions [score, mean_length]."""
    return ModelMetrics("anomaly", dict(
        mean_score=float(raw[:, 0].mean()),
        mean_length=float(raw[:, 1].mean())))


def clustering_metrics(data: Dict) -> ModelMetrics:
    """KMeans's metrics: ``k``, ``tot_withinss``, ``totss``,
    ``betweenss`` and the per-cluster ``withinss`` and ``size``."""
    keys = ("k", "tot_withinss", "totss", "betweenss", "withinss", "size")
    return ModelMetrics("clustering", {k: data[k] for k in keys})


def autoencoder_metrics(mse: float) -> ModelMetrics:
    """An autoencoder's mean reconstruction MSE and its root."""
    return ModelMetrics("autoencoder", dict(MSE=float(mse),
                                            RMSE=float(mse) ** 0.5))


def uplift_metrics(uplift: np.ndarray, y: np.ndarray,
                   treat: np.ndarray) -> ModelMetrics:
    """Qini-style uplift metrics over the rows ranked by predicted uplift
    (ModelMetricsBinomialUplift analog): the Qini curve ``yt - yc * nt /
    max(nc, 1)`` at every cut, its trapezoid area over the row count
    (``auuc``), its last value (``qini``) and the mean predicted uplift
    (``ate``).  Host numpy, as the reference computes it."""
    order = np.argsort(-uplift)
    y = np.asarray(y, np.float64)[order]
    t = np.asarray(treat, np.float64)[order]
    nt = np.cumsum(t)
    nc = np.cumsum(1 - t)
    yt = np.cumsum(y * t)
    yc = np.cumsum(y * (1 - t))
    qini = yt - yc * nt / np.maximum(nc, 1)
    auuc = float(np.trapezoid(qini) / max(len(y), 1))
    return ModelMetrics("uplift", dict(auuc=auuc, ate=float(uplift.mean()),
                                       qini=float(qini[-1])))


def dimreduction_metrics(**data) -> ModelMetrics:
    """PCA's ``std_deviation`` and ``pct_variance``, or SVD's ``d``, as
    lists."""
    return ModelMetrics("dimreduction", {
        k: np.asarray(v).tolist() for k, v in data.items()})


def glrm_metrics(objective: float, numerr: float,
                 iterations: int) -> ModelMetrics:
    """GLRM's final objective, squared reconstruction error over the
    observed cells and iteration count."""
    return ModelMetrics("glrm", dict(objective=float(objective),
                                     numerr=float(numerr),
                                     iterations=int(iterations)))


def word2vec_metrics(vocab_size: int, vec_size: int) -> ModelMetrics:
    return ModelMetrics("word2vec", dict(vocab_size=int(vocab_size),
                                         vec_size=int(vec_size)))


def coxph_metrics(out: Dict) -> ModelMetrics:
    """CoxPH's ``loglik``, ``null_loglik``, ``concordance``,
    ``n_events`` and ``iterations`` from its output."""
    keys = ("loglik", "null_loglik", "concordance", "n_events",
            "iterations")
    return ModelMetrics("coxph", {k: out[k] for k in keys})


def aggregator_metrics(num_exemplars: int,
                       radius_scale: float) -> ModelMetrics:
    return ModelMetrics("aggregator", dict(
        num_exemplars=int(num_exemplars), radius_scale=float(radius_scale)))


def targetencoder_metrics(columns, prior: float) -> ModelMetrics:
    return ModelMetrics("targetencoder", dict(
        encoded_columns=list(columns), prior=float(prior)))


def modelselection_metrics(mode: str, sizes) -> ModelMetrics:
    return ModelMetrics("modelselection", dict(mode=mode,
                                               sizes=sorted(sizes)))


def anovaglm_metrics(terms) -> ModelMetrics:
    return ModelMetrics("anovaglm", dict(terms=list(terms)))


def infogram_metrics(admissible) -> ModelMetrics:
    return ModelMetrics("infogram", dict(admissible_features=list(admissible)))


def grep_metrics(n_matches: int) -> ModelMetrics:
    return ModelMetrics("grep", dict(n_matches=int(n_matches)))
