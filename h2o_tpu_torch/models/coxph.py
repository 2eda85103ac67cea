"""CoxPH — port of ``h2o_tpu/models/coxph.py`` (the negative partial
log-likelihood ``_neg_partial_loglik`` :34-81, ``_newton_state`` :84-96,
``CoxPHModel`` :99-115, ``_concordance`` :118-138, ``CoxPH`` :141-271).

Cox proportional hazards by Newton-Raphson on the partial likelihood,
Efron (default) or Breslow ties; ``stop_column`` is the event time, an
optional ``start_column`` makes interval data (left truncation), the
response is the event indicator.

On the host, as in the reference: the rows sorted by descending stop time
(stable), the tie groups of equal times, the expanded matrix centered by its
column means, the largest tie count rounded up to a power of two, and with a
start column the rows reordered by descending start and, per tie group, the
count of rows that have not yet entered. On the model's device: the partial
log-likelihood over the sorted risk sets — the risk-set sums a prefix sum in
XLA's blocked order (``ops/xlamath.cumsum``, as ``jnp.cumsum`` computes it on
the CPU), the per-group sums ``ops/segment.segment_sum`` (a fixed order
on every device, the same at every call), Efron's tie terms a (groups, max
ties) masked sum — and its gradient and
Hessian by ``torch.autograd`` (one backward pass for the gradient, one
batched backward pass over the P unit vectors for the Hessian).  The Newton
step solves the P x P system on the host (float32), halving it while the
likelihood gets worse (at most 20 times); iterations stop when the
log-likelihood moves by less than 10^-lre of its size, after
``max_iterations`` at most.  The covariance is the float64 inverse of the
final Hessian; the concordance is Harrell's C on the
host over at most 4,000 rows drawn by ``default_rng(0)``.  Scores are the
centered linear predictor.  Cross-validation is refused;
``recovery_dir`` snapshots the build (``models/model.py``), as the
reference's does, with no iteration checkpoint.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.core.frame import Frame
from h2o_tpu_torch.models import metrics as mm
from h2o_tpu_torch.models.glm import expand_for_scoring, expansion_spec
from h2o_tpu_torch.models.model import DataInfo, Model, ModelBuilder
from h2o_tpu_torch.ops import xlamath
from h2o_tpu_torch.ops.segment import segment_sum

EPS = 1e-10


class RiskSets:
    """The sorted rows and their risk-set structure on one device."""

    def __init__(self, Xc: np.ndarray, event: np.ndarray, w: np.ndarray,
                 group: np.ndarray, efron: bool, max_ties: int, dev,
                 start_perm: Optional[np.ndarray] = None,
                 start_cnt: Optional[np.ndarray] = None):
        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=dev, dtype=dtype)

        self.X = put(Xc, torch.float32)
        self.event = put(event, torch.float32)
        self.w = put(w, torch.float32)
        self.group = put(group, torch.int64)
        self.n_groups = int(group[-1]) + 1 if len(group) else 1
        # the last row of each group: the risk set of a group is every
        # row up to it (the reference's segment_max of the row index)
        last = np.r_[np.flatnonzero(np.diff(group)), len(group) - 1]
        self.grp_last = put(last, torch.int64)
        self.efron = efron
        self.max_ties = max_ties
        self.start_perm = None if start_perm is None else \
            put(start_perm, torch.int64)
        self.start_cnt = None if start_cnt is None else \
            put(start_cnt, torch.int64)

    def segsum(self, v: torch.Tensor) -> torch.Tensor:
        # a fixed order on every device: index_add_'s atomics on the card
        # moved the likelihood in its last place between calls at one
        # beta, and the float32 stop test followed it
        return segment_sum(v, self.group, self.n_groups)

    def neg_loglik(self, beta: torch.Tensor) -> torch.Tensor:
        """The negative partial log-likelihood at ``beta`` (0-d)."""
        eta = self.X @ beta
        r = self.w * torch.exp(eta)
        risk = xlamath.cumsum(r)[self.grp_last]
        if self.start_perm is not None:
            # rows whose start >= t_g have not entered the risk set at t_g
            cum_s = xlamath.cumsum(r[self.start_perm])
            ent = cum_s[torch.clamp_min(self.start_cnt - 1, 0)]
            risk = risk - torch.where(self.start_cnt > 0, ent,
                                      torch.zeros_like(ent))
        ev = self.w * self.event
        d = self.segsum(ev)
        s_eta = self.segsum(ev * eta)
        if not self.efron:                              # Breslow
            return -torch.sum(
                s_eta - d * torch.log(torch.clamp_min(risk, EPS)))
        tie_r = self.segsum(ev * torch.exp(eta))
        cnt = self.segsum(self.event)
        ls = torch.arange(self.max_ties, dtype=torch.float32,
                          device=eta.device)[None, :]
        c1 = torch.clamp_min(cnt, 1.0)[:, None]
        act = ls < cnt[:, None]
        zero = torch.zeros((), dtype=torch.float32, device=eta.device)
        frac = torch.where(act, ls / c1, zero)
        t = torch.log(torch.clamp_min(risk[:, None] - frac * tie_r[:, None],
                                      EPS))
        terms = torch.sum(torch.where(act, t, zero), dim=1) / c1[:, 0] * d
        return -torch.sum(s_eta - terms)

    def state(self, beta: np.ndarray):
        """(nll, gradient, Hessian) at ``beta`` as float32 host values."""
        b = torch.from_numpy(np.asarray(beta, np.float32)).to(
            self.X.device).requires_grad_(True)
        nll = self.neg_loglik(b)
        g, = torch.autograd.grad(nll, b, create_graph=True)
        # the Hessian's P rows in one batched backward pass
        H, = torch.autograd.grad(g, b, grad_outputs=torch.eye(
            len(beta), dtype=g.dtype, device=g.device), is_grads_batched=True)
        return (float(nll.detach()), g.detach().cpu().numpy(),
                H.detach().cpu().numpy())

    def nll(self, beta: np.ndarray) -> float:
        with torch.no_grad():
            return float(self.neg_loglik(torch.from_numpy(
                np.asarray(beta, np.float32)).to(self.X.device)))


def _concordance(time, event, lp, cap: int = 4000) -> float:
    """Pairwise concordance (Harrell's C); subsampled beyond ``cap``
    rows."""
    n = len(time)
    if n > cap:
        idx = np.random.default_rng(0).choice(n, cap, replace=False)
        time, event, lp = time[idx], event[idx], lp[idx]
    conc = ties = disc = 0
    order = np.argsort(time)
    time, event, lp = time[order], event[order], lp[order]
    for i in range(len(time)):
        if not event[i]:
            continue
        later = time > time[i]
        if not later.any():
            continue
        d = lp[later]
        conc += int((lp[i] > d).sum())
        ties += int((lp[i] == d).sum())
        disc += int((lp[i] < d).sum())
    tot = conc + ties + disc
    return (conc + 0.5 * ties) / tot if tot else 0.5


class CoxPHModel(Model):
    algo = "coxph"

    def predict_raw(self, frame: Frame) -> torch.Tensor:
        """The centered linear predictor (hazard ratios are its exp)."""
        out, dev = self.output, self.device
        X = expand_for_scoring(frame, out["expansion_spec"], dev)

        def t(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(dev)
        return (X - t(out["x_mean"])[None, :]) @ t(out["coef"])

    def model_metrics(self, frame: Frame = None) -> mm.ModelMetrics:
        return mm.coxph_metrics(self.output)


def coxph_from_jax_output(output: Dict, params: Dict,
                          device: DeviceLike = None) -> CoxPHModel:
    """The port's ``CoxPHModel`` from an ``h2o_tpu`` CoxPH's output dict
    (arrays as numpy)."""
    out = {k: output[k] for k in ("loglik", "null_loglik", "iterations",
                                  "n_events", "concordance", "ties")}
    out.update({k: np.array(output[k], np.float32)
                for k in ("coef", "exp_coef", "x_mean")})
    out.update({k: np.array(output[k], np.float64)
                for k in ("se_coef", "z_coef")})
    out.update(coef_names=list(output["coef_names"]),
               expansion_spec=dict(output["expansion_spec"]))
    m = CoxPHModel(dict(params), out, cloud(device))
    out["training_metrics"] = m.model_metrics()
    return m


class CoxPH(ModelBuilder):
    algo = "coxph"
    model_cls = CoxPHModel
    supports_cv = False

    ENGINE_FIXED = {"ties": ("efron", "breslow")}

    def default_params(self) -> Dict:
        p = super().default_params()
        p.update(start_column=None, stop_column=None, ties="efron",
                 max_iterations=20, lre=9.0, use_all_factor_levels=False)
        return p

    def _fit(self, x: List[str], y: str, train: Frame,
             valid: Optional[Frame] = None) -> CoxPHModel:
        p = self.params
        dev = self.device
        stop_col, start_col = p.get("stop_column"), p.get("start_column")
        if not stop_col:
            raise ValueError("CoxPH requires stop_column (event time)")
        x = [c for c in x if c not in (stop_col, start_col)]
        di = DataInfo(train, x, y, dev, mode="expanded",
                      weights=p.get("weights_column"),
                      use_all_factor_levels=bool(p["use_all_factor_levels"]),
                      impute_missing=True)
        X_full = di.matrix().cpu().numpy()
        event = np.nan_to_num(di.response().cpu().numpy())
        w_full = di.weights().cpu().numpy()
        t_np = train.vec(stop_col).as_float()
        v_np = di.valid_mask().cpu().numpy() & ~np.isnan(t_np)

        # rows by descending stop time, tie groups of equal times
        order = np.argsort(-t_np, kind="stable")
        order = order[v_np[order]]
        t_s = t_np[order]
        group = np.zeros(len(order), np.int32)
        if len(order) > 1:
            group[1:] = np.cumsum(t_s[1:] != t_s[:-1]).astype(np.int32)

        Xh = X_full[order]
        x_mean = Xh.mean(axis=0)
        ev_np = event[order]
        efron = (p.get("ties") or "efron").lower() == "efron"
        P = Xh.shape[1]
        # the largest number of tied events, rounded up to a power of two
        max_cnt = int(np.bincount(group, weights=ev_np).max()) \
            if len(group) else 1
        max_ties = 1 << max(int(np.ceil(np.log2(max(max_cnt, 1)))), 0)

        start_perm = start_cnt = None
        if start_col:
            s_s = train.vec(start_col).as_float()[order]
            start_perm = np.argsort(-s_s, kind="stable")
            _, first_idx = np.unique(group, return_index=True)
            # rows with start >= t_g have not entered at t_g; the starts
            # descend, so count through searchsorted on -s
            start_cnt = np.searchsorted(-s_s[start_perm], -t_s[first_idx],
                                        side="right")
        rs = RiskSets(Xh - x_mean[None, :], ev_np, w_full[order], group,
                      efron, max_ties, dev, start_perm, start_cnt)

        beta = np.zeros(P, np.float32)
        ridge = np.eye(P, dtype=np.float32) * np.float32(1e-6)
        nll_prev = rs.nll(beta)
        nll0 = nll_prev
        tol = 10.0 ** (-float(p["lre"]))
        it = 0
        from scipy.linalg import solve
        for it in range(1, int(p["max_iterations"]) + 1):
            nll, g, H = rs.state(beta)
            step = solve(H + ridge, g).astype(np.float32)
            beta_new = beta - step
            nll_new = rs.nll(beta_new)
            # step halving while the likelihood gets worse
            halvings = 0
            while not np.isfinite(nll_new) or nll_new > nll + 1e-9:
                step = step / np.float32(2)
                beta_new = beta - step
                nll_new = rs.nll(beta_new)
                halvings += 1
                if halvings > 20:
                    break
            beta = beta_new
            self._update(min(0.9, it / int(p["max_iterations"])),
                         f"iter {it} loglik {-float(nll_new):.5g}")
            done = abs(nll_prev - nll_new) < tol * max(1.0, abs(nll_prev))
            nll_prev = nll_new
            if done:
                break

        nll_f, _, H_f = rs.state(beta)
        cov = np.linalg.inv(H_f + np.eye(P) * 1e-8)
        se = np.sqrt(np.maximum(np.diag(cov), 0.0))
        lp = Xh @ beta - x_mean @ beta
        conc = _concordance(t_s[::-1], ev_np[::-1].astype(bool), lp[::-1])
        out = dict(
            coef=beta, exp_coef=np.exp(beta), se_coef=se,
            z_coef=beta / np.maximum(se, EPS),
            coef_names=di.expanded_names, x_mean=x_mean, loglik=-nll_f,
            null_loglik=-nll0, iterations=it, n_events=int(ev_np.sum()),
            concordance=float(conc), ties=p["ties"],
            expansion_spec=expansion_spec(di))
        model = self.model_cls(dict(p, response_column=y), out, dev)
        out["training_metrics"] = model.model_metrics()
        return model
