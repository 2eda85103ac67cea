"""GLM — port of ``h2o_tpu/models/glm.py``: the families (:40-214), the
data pass ``_irlsm_pass_impl`` (:248-270) and ``_deviance_at``
(:313-329), the solves ``_cod_solve`` (:273-310) and ``_chol_solve``
(:525-530), ``_lbfgs_minimize`` (:332-400) with the objective
``_glm_obj``/``_glm_objective_fn`` (:403-455), ordinal's
``_ordinal_unpack`` and Adam (:458-523), the expansion helpers
``_beta_constraint_rows``, ``expand_for_scoring``, ``expand_array``,
``expansion_spec``, ``_destandardize`` and ``build_coef_table``
(:533-691), ``GLMModel`` (:694-751) and the builder ``GLM`` (:754-1427:
the AUTO solver, the response checks, ``_assemble_penalty``,
``_irlsm_at_lambda``, ``_lbfgs_at_lambda``, ``_fit_binomial_ish`` with
lambda search, ``_p_values``, ``_fit_ordinal`` and
``_fit_multinomial``).

Where the work runs.  Every pass over the rows runs on the model's
device: the IRLS weights, the weighted Gram [X,1]'W[X,1] (one
``torch.matmul``), [X,1]'Wz and the deviance; the deviance of a fixed
beta; the L-BFGS objective and its gradient (``torch.autograd``); every
step of ordinal's Adam.  The solves on the (P+1) x (P+1) Gram —
coordinate descent (elastic net, non-negative, box bounds), the Cholesky
solve and the p-values' inverse — run on the host, in float32 (the
inverse in float64, as in the reference), on one copy of the Gram an
iteration.  H2O-3 solves on its driver node too (gram/Gram.java:452-534);
here it spares the card the ~8 tiny launches per coordinate of 50 COD
sweeps.  This is the same code whatever the device, not a fallback: a
data pass that fails on the card raises.

Not in the port yet, each refused by name: iteration checkpoints
(``recovery_dir``) and the stream refresh's warm start
(``_warm_start_beta``), which come with the runtime services (P14).
``beta_constraints`` may be a Frame, a dict, or the key of a frame in
``store.dkv()``; ``custom_metric_func`` is attached by the job body
(``models/model.py``).  The reference's executable store and OOM ladder (``_solver_
dispatch``) are P14 as well; the port calls its passes directly.
``offset_column`` is refused: the reference accepts it and never reads
it (``glm.py:788`` hands it to DataInfo, ``:255`` forms eta without it),
so a model trained with one equals the model trained without.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.core.frame import Frame
from h2o_tpu_torch.models.metrics import twodim_json
from h2o_tpu_torch.models.model import (DataInfo, Model, ModelBuilder,
                                        expand_columns, expand_numeric)
from h2o_tpu_torch.ops.xlamath import cumsum, softplus

EPS = 1e-10
_F32 = np.float32


# ---------------------------------------------------------------------------
# families (reference GLMModel.GLMParameters.Family): tensor functions
# ---------------------------------------------------------------------------

class _Family:
    name = "gaussian"

    def link_inv(self, eta):
        return eta

    def mu_eta(self, eta):          # d mu / d eta
        return torch.ones_like(eta)

    def variance(self, mu):
        return torch.ones_like(mu)

    def null_mu(self, y, w):
        return torch.sum(w * y) / torch.clamp_min(torch.sum(w), EPS)

    def link(self, mu):
        return mu

    def deviance(self, y, mu, w):
        return torch.sum(w * (y - mu) ** 2)


class _Binomial(_Family):
    name = "binomial"

    def link_inv(self, eta):
        return torch.sigmoid(eta)

    def mu_eta(self, eta):
        p = torch.sigmoid(eta)
        return p * (1 - p)

    def variance(self, mu):
        return torch.clamp_min(mu * (1 - mu), EPS)

    def link(self, mu):
        mu = torch.clamp(mu, EPS, 1 - EPS)
        return torch.log(mu / (1 - mu))

    def deviance(self, y, mu, w):
        mu = torch.clamp(mu, EPS, 1 - EPS)
        return -2 * torch.sum(w * (y * torch.log(mu) +
                                   (1 - y) * torch.log(1 - mu)))


class _LogLink(_Family):
    """The log-link families' inverse link and its derivative."""

    def link_inv(self, eta):
        return torch.exp(torch.clamp(eta, -30, 30))

    def mu_eta(self, eta):
        return torch.exp(torch.clamp(eta, -30, 30))

    def link(self, mu):
        return torch.log(torch.clamp_min(mu, EPS))


class _Poisson(_LogLink):
    name = "poisson"

    def variance(self, mu):
        return torch.clamp_min(mu, EPS)

    def deviance(self, y, mu, w):
        # the reference's y log(y / mu) at y = 0 is masked in the value
        # but makes its gradient NaN (0 / 0 through the log), so its
        # L-BFGS returns the starting point when a count is 0; the log
        # here reads 1 at y = 0: the same value, a finite gradient
        mu = torch.clamp_min(mu, EPS)
        ylogy = torch.where(y > 0, y * torch.log(
            torch.where(y > 0, y, torch.ones_like(y)) / mu),
            torch.zeros_like(y))
        return 2 * torch.sum(w * (ylogy - (y - mu)))


class _Gamma(_LogLink):
    name = "gamma"

    def variance(self, mu):
        return torch.clamp_min(mu * mu, EPS)

    def deviance(self, y, mu, w):
        mu = torch.clamp_min(mu, EPS)
        ys = torch.clamp_min(y, EPS)
        return 2 * torch.sum(w * (-torch.log(ys / mu) + (ys - mu) / mu))


class _Tweedie(_LogLink):
    name = "tweedie"

    def __init__(self, p=1.5):
        self.p = p

    def variance(self, mu):
        return torch.clamp_min(mu, EPS) ** self.p

    def deviance(self, y, mu, w):
        p = self.p
        mu = torch.clamp_min(mu, EPS)
        return 2 * torch.sum(w * (
            torch.clamp_min(y, 0.0) ** (2 - p) / ((1 - p) * (2 - p))
            - y * mu ** (1 - p) / (1 - p) + mu ** (2 - p) / (2 - p)))


class _FractionalBinomial(_Binomial):
    """Fractional response in [0, 1] with binomial mechanics: the logit
    link, variance and deviance are defined for non-integer y."""
    name = "fractionalbinomial"


class _NegativeBinomial(_LogLink):
    """Log link, variance mu + theta mu^2 (theta -> 0 is Poisson)."""
    name = "negativebinomial"

    def __init__(self, theta=1.0):
        self.theta = max(float(theta), 1e-10)

    def variance(self, mu):
        return torch.clamp_min(mu + self.theta * mu * mu, EPS)

    def deviance(self, y, mu, w):
        t = self.theta
        mu = torch.clamp_min(mu, EPS)
        ylogy = torch.where(y > 0, y * torch.log(torch.clamp_min(y, EPS) / mu),
                            torch.zeros_like(y))
        return 2 * torch.sum(w * (
            ylogy - (y + 1.0 / t) *
            torch.log((1.0 + t * y) / (1.0 + t * mu))))


_FAMILIES = {"gaussian": _Family, "binomial": _Binomial,
             "quasibinomial": _Binomial, "poisson": _Poisson,
             "gamma": _Gamma,
             "fractionalbinomial": _FractionalBinomial}


def _family(name: str, tweedie_power=1.5, theta=1.0) -> _Family:
    if name == "tweedie":
        return _Tweedie(tweedie_power)
    if name == "negativebinomial":
        return _NegativeBinomial(theta)
    cls = _FAMILIES.get(name)
    if cls is None:
        # ordinal is fit by _fit_ordinal, not by the IRLS family machinery
        known = sorted(_FAMILIES) + ["tweedie", "negativebinomial",
                                     "ordinal"]
        raise ValueError(
            f"unsupported GLM family '{name}'; supported: {known}")
    return cls()


# ---------------------------------------------------------------------------
# the passes over the rows (on the device)
# ---------------------------------------------------------------------------

def _masked(y, w, valid):
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    return torch.where(valid, y, zero), torch.where(valid, w, zero)


def _eta(X: torch.Tensor, beta: np.ndarray) -> torch.Tensor:
    b = torch.tensor(np.asarray(beta, _F32), device=X.device)
    return X @ b[:-1] + b[-1]


def _irlsm_pass(X, y, w, valid, beta: np.ndarray, fam: _Family
                ) -> Tuple[np.ndarray, np.ndarray, float]:
    """One data pass at ``beta`` (the GLMIterationTask): the weighted Gram
    G = [X,1]'W[X,1], q = [X,1]'Wz with the IRLS weights W and working
    response z, and the deviance — on X's device, copied to the host in
    one transfer as float32 G (P+1, P+1), q (P+1,) and the deviance."""
    y, w = _masked(y, w, valid)
    eta = _eta(X, beta)
    mu = fam.link_inv(eta)
    d = torch.clamp_min(fam.mu_eta(eta), 1e-6)
    v = fam.variance(mu)
    wir = w * d * d / v                      # IRLS working weights
    z = eta + (y - mu) / d                   # working response
    Xw = X * wir[:, None]
    G = torch.matmul(Xw.T, X)
    xsum = torch.sum(Xw, dim=0)
    G = torch.cat([torch.cat([G, xsum[:, None]], dim=1),
                   torch.cat([xsum, torch.sum(wir)[None]])[None, :]], dim=0)
    q = torch.cat([torch.matmul(Xw.T, z), torch.sum(wir * z)[None]])
    dev = fam.deviance(y, mu, w)
    P1 = G.shape[0]
    host = torch.cat([G.reshape(-1), q, dev[None]]).cpu().numpy()
    return (host[:P1 * P1].reshape(P1, P1), host[P1 * P1:-1],
            float(host[-1]))


def _deviance_at(X, y, w, valid, beta: np.ndarray, fam: _Family) -> float:
    """Deviance of a fixed beta on a (possibly held-out) split: the
    lambda path's selection criterion."""
    y, w = _masked(y, w, valid)
    return float(fam.deviance(y, fam.link_inv(_eta(X, beta)), w))


# ---------------------------------------------------------------------------
# the (P+1) x (P+1) solves (on the host)
# ---------------------------------------------------------------------------

def _cod_solve(G: np.ndarray, q: np.ndarray, beta0: np.ndarray,
               lam_l1: float, lam_l2: float, n_sweeps: int = 50,
               intercept_pen: bool = False, non_negative: bool = False,
               nonneg_mask=None, lo=None, hi=None) -> np.ndarray:
    """Cyclic coordinate descent on the Gram, in float32 on the host:
    argmin 1/2 b'Gb - q'b + lam_l1 |b| + lam_l2/2 |b|^2 with the
    intercept (the last coefficient) unpenalized, ``n_sweeps`` sweeps.
    ``non_negative`` clamps every non-intercept coefficient at 0 (the
    ones ``nonneg_mask`` selects, when given); ``lo``/``hi`` are per-
    coefficient box bounds (user beta_constraints), projected exactly
    inside each coordinate step."""
    G = np.asarray(G, _F32)
    q = np.asarray(q, _F32)
    P = G.shape[0]
    diag = np.diagonal(G).copy()
    pen = np.ones(P, _F32)
    pen[-1] = 1.0 if intercept_pen else 0.0
    clamp = pen if nonneg_mask is None else np.asarray(nonneg_mask, _F32)
    l1 = pen * _F32(lam_l1)
    den = np.maximum(diag + pen * _F32(lam_l2), _F32(EPS))
    lo = None if lo is None else np.asarray(lo, _F32)
    hi = None if hi is None else np.asarray(hi, _F32)
    zero = _F32(0.0)
    b = np.array(beta0, _F32)
    rows = list(G)
    for _ in range(n_sweeps):
        for j in range(P):
            r = q[j] - (rows[j] @ b - diag[j] * b[j])
            bj = np.sign(r) * max(abs(r) - l1[j], zero) / den[j]
            if non_negative and clamp[j] > 0:
                bj = max(bj, zero)
            if lo is not None:
                bj = min(max(bj, lo[j]), hi[j])
            b[j] = bj
    return b


def _chol_solve(G: np.ndarray, q: np.ndarray, lam_l2: float) -> np.ndarray:
    """(G + lam_l2 I' + 1e-8 I) b = q by Cholesky in float32 on the host
    (I' leaves the intercept unpenalized).  A Gram that is not positive
    definite gives NaN coefficients, as the reference's solve does."""
    from scipy.linalg import cho_factor, cho_solve
    P = G.shape[0]
    ridge = np.eye(P, dtype=_F32) * _F32(lam_l2)
    ridge[-1, -1] = 0.0
    A = np.asarray(G, _F32) + ridge + _F32(1e-8) * np.eye(P, dtype=_F32)
    try:
        return cho_solve(cho_factor(A), np.asarray(q, _F32)).astype(_F32)
    except np.linalg.LinAlgError:
        return np.full(P, np.nan, _F32)


# ---------------------------------------------------------------------------
# L-BFGS (host loop; objective and gradient on the device)
# ---------------------------------------------------------------------------

def _lbfgs_minimize(value_and_grad, x0, max_iter: int = 200, m: int = 10,
                    gtol: float = 1e-7, progress=None):
    """Limited-memory BFGS: two-loop recursion + Armijo backtracking
    (hex/optimization/L_BFGS.java).  The loop runs on the host; each
    evaluation is one forward and backward pass on the device.

    Returns (x, f, n_iters)."""
    x = np.asarray(x0, np.float64)
    f, g = value_and_grad(x)
    f, g = float(f), np.asarray(g, np.float64)
    S, Y, RHO = [], [], []
    it = 0
    for it in range(1, max_iter + 1):
        gnorm = float(np.max(np.abs(g)))
        if gnorm < gtol:
            break
        # two-loop recursion
        d = -g
        alphas = []
        for s, yv_, rho in zip(reversed(S), reversed(Y), reversed(RHO)):
            a = rho * float(s @ d)
            alphas.append(a)
            d = d - a * yv_
        if S:
            gamma = float(S[-1] @ Y[-1]) / max(float(Y[-1] @ Y[-1]),
                                               1e-300)
            d = gamma * d
        for (s, yv_, rho), a in zip(zip(S, Y, RHO), reversed(alphas)):
            b = rho * float(yv_ @ d)
            d = d + (a - b) * s
        # Armijo backtracking
        dg = float(g @ d)
        if dg >= 0:                    # not a descent direction: reset
            d, dg = -g, -float(g @ g)
            S, Y, RHO = [], [], []
        step = 1.0
        f_new, g_new, x_new = f, g, x
        for _ in range(30):
            x_new = x + step * d
            f_new, g_new = value_and_grad(x_new)
            f_new = float(f_new)
            if np.isfinite(f_new) and f_new <= f + 1e-4 * step * dg:
                break
            step *= 0.5
        else:
            break                      # line search failed: converged
        g_new = np.asarray(g_new, np.float64)
        s, yvec = x_new - x, g_new - g
        sy = float(s @ yvec)
        if sy > 1e-12:                 # curvature condition
            S.append(s)
            Y.append(yvec)
            RHO.append(1.0 / sy)
            if len(S) > m:
                S.pop(0)
                Y.pop(0)
                RHO.pop(0)
        if abs(f - f_new) <= 1e-12 * max(1.0, abs(f)):
            x, f, g = x_new, f_new, g_new
            break
        x, f, g = x_new, f_new, g_new
        if progress is not None and it % 10 == 0:
            progress(it, f)
    return x, f, it


def _glm_obj(params, X, yz, wz, l2, pen, fam_name: str, tweedie_power,
             theta, n_icpt: int):
    """Penalized negative log-likelihood (deviance / 2) + l2/2 ||b||^2
    (+ 1/2 b'Sb with a penalty matrix S); multinomial: the softmax NLL
    of the flat (K (P+1),) params with n_icpt = K."""
    P = X.shape[1]
    if fam_name == "multinomial":
        B = params.reshape(n_icpt, P + 1)
        eta = X @ B[:, :-1].T + B[:, -1][None, :]          # (R, K)
        lse = torch.logsumexp(eta, dim=1)
        yk = torch.clamp(yz.to(torch.int32), 0, n_icpt - 1).long()
        ll = torch.gather(eta, 1, yk[:, None])[:, 0] - lse
        nll = -torch.sum(wz * ll)
        return nll + 0.5 * l2 * torch.sum(B[:, :-1] ** 2)
    fam = _family(fam_name, tweedie_power, theta)
    eta = X @ params[:-1] + params[-1]
    mu = fam.link_inv(eta)
    val = 0.5 * fam.deviance(yz, mu, wz) + \
        0.5 * l2 * torch.sum(params[:-1] ** 2)
    if pen is not None:
        val = val + 0.5 * params @ (pen @ params)
    return val


def _glm_objective_fn(X, yv, w, valid_m, fam_name: str, tweedie_power,
                      theta, l2, pen=None, n_icpt: int = 1):
    """value_and_grad(x) for L-BFGS: the objective at float32 params on
    X's device, its gradient by ``torch.autograd``, both copied to the
    host in one transfer.  ``pen`` is an optional quadratic penalty
    matrix in Gram units."""
    zero = torch.zeros((), dtype=X.dtype, device=X.device)
    yz = torch.where(valid_m, torch.nan_to_num(yv), zero)
    wz = torch.where(valid_m, w, zero)
    l2t = torch.tensor(float(_F32(l2)), dtype=torch.float32, device=X.device)
    pen_t = None if pen is None else torch.as_tensor(
        np.asarray(pen, _F32), device=X.device)

    def value_and_grad(x):
        prm = torch.tensor(np.asarray(x, _F32), device=X.device,
                           requires_grad=True)
        f = _glm_obj(prm, X, yz, wz, l2t, pen_t, fam_name,
                     float(tweedie_power), float(theta), int(n_icpt))
        g, = torch.autograd.grad(f, prm)
        host = torch.cat([f.detach()[None], g]).cpu().numpy()
        return float(host[0]), host[1:].astype(np.float64)
    return value_and_grad


# ---------------------------------------------------------------------------
# ordinal: full-batch Adam on the device
# ---------------------------------------------------------------------------

def _xla_increments(x: torch.Tensor) -> torch.Tensor:
    """cumsum(softplus(x)) as XLA computes both on the CPU (~260 small
    operations), detached."""
    return cumsum(softplus(x))


class _Increments:
    """``_xla_increments`` of an Adam run's (n,) increment params.  On
    the card its small operations are one CUDA graph, captured once and
    replayed each step, so the launch-bound loop pays two launches for
    them instead of ~260."""

    def __init__(self, n: int, device: torch.device):
        self.graph = None
        if device.type != "cuda":
            return
        self.inp = torch.zeros(n, dtype=torch.float32, device=device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            _xla_increments(self.inp)                        # warm-up
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = _xla_increments(self.inp)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.graph is None:
            return _xla_increments(x)
        self.inp.copy_(x.detach())
        self.graph.replay()
        return self.out.clone()


def _ordinal_unpack(params, P: int, K: int, increments=_xla_increments):
    """(beta, monotone thresholds) from the flat ordinal params: the
    softplus-increment parametrization keeps them strictly increasing."""
    beta = params[:P]
    t0 = params[P]
    if K > 2:
        # softplus increments summed in order, both as XLA computes them
        # on the CPU: the thresholds are the reference's bit for bit.  The
        # gradient flows through torch's softplus (the sigmoid) and the
        # same scan, added as a term whose value is exactly 0.
        inc = params[P + 1:]
        c = increments(inc)
        if inc.requires_grad:
            s = cumsum(torch.nn.functional.softplus(inc))
            c = c + (s - s.detach())
        thr = torch.cat([t0[None], t0 + c])
    else:
        thr = t0[None]
    return beta, thr


def _ordinal_gd(params0, X, yk, wa, n_obs, l1, l2, pen_dev, proj_mask, *,
                P: int, K: int, steps: int):
    """``steps`` full-batch Adam steps on the cumulative-logit negative
    log-likelihood, in optax's arithmetic: ``adam(exponential_decay(0.5,
    steps // 4, 0.3))`` with b1 0.9, b2 0.999, eps 1e-8 — the moments
    (1 - b) g^k + b m, the bias corrections m / (1 - b^t) at the
    incremented count t, the update m^ / (sqrt(v^ + 0) + eps) scaled by
    minus the schedule at the count before the increment.  Returns
    (params, the last step's loss)."""
    dev = X.device
    f32 = torch.float32

    def c(v):
        return torch.tensor(float(_F32(v)), dtype=f32, device=dev)

    b1, b2, eps = c(0.9), c(0.999), c(1e-8)
    one_m_b1, one_m_b2 = c(1 - 0.9), c(1 - 0.999)
    lr0, rate = c(0.5), c(0.3)
    tsteps = c(steps // 4)
    yk = yk.long()[:, None]

    increments = _Increments(K - 2, dev) if K > 2 else _xla_increments

    def nll(params):
        beta, thr = _ordinal_unpack(params, P, K, increments)
        eta = X @ beta
        cc = torch.sigmoid(thr[None, :] - eta[:, None])       # (R, K-1)
        cc = torch.cat([torch.zeros_like(cc[:, :1]), cc,
                        torch.ones_like(cc[:, :1])], dim=1)
        p_hi = torch.gather(cc, 1, yk + 1)[:, 0]
        p_lo = torch.gather(cc, 1, yk)[:, 0]
        pk = torch.clamp(p_hi - p_lo, EPS, 1.0)
        obj = -torch.sum(wa * torch.log(pk)) / n_obs
        if pen_dev is not None:
            bf = torch.cat([beta, torch.zeros(1, dtype=f32, device=dev)])
            obj = obj + 0.5 * (bf @ pen_dev @ bf) / n_obs
        return obj + 0.5 * l2 * torch.sum(beta ** 2) + \
            l1 * torch.sum(torch.abs(beta))

    prm = params0.clone()
    mu = torch.zeros_like(prm)
    nu = torch.zeros_like(prm)
    loss = None
    for count in range(steps):
        p_ = prm.detach().requires_grad_(True)
        loss = nll(p_)
        g, = torch.autograd.grad(loss, p_)
        mu = one_m_b1 * g + b1 * mu
        nu = one_m_b2 * (g ** 2) + b2 * nu
        t = c(count + 1)
        mu_hat = mu / (1 - b1 ** t)
        nu_hat = nu / (1 - b2 ** t)
        upd = mu_hat / (torch.sqrt(nu_hat + 0.0) + eps)
        lr = lr0 if count <= 0 else lr0 * rate ** (c(count) / tsteps)
        prm = prm.detach() + (-1 * lr) * upd
        if proj_mask is not None:
            prm = torch.where(proj_mask > 0, torch.clamp_min(prm, 0.0), prm)
    return prm.detach(), float(loss.detach())


# ---------------------------------------------------------------------------
# the expansion helpers
# ---------------------------------------------------------------------------

def _beta_constraint_rows(bc) -> List[tuple]:
    """The beta_constraints input (a dict, or a Frame of names and
    lower/upper bounds) as (name, lower, upper) tuples."""
    if isinstance(bc, dict):
        out = []
        for name, v in bc.items():
            if isinstance(v, dict):
                out.append((str(name), v.get("lower_bounds"),
                            v.get("upper_bounds")))
            else:
                lb, ub = v
                out.append((str(name), lb, ub))
        return out
    if isinstance(bc, str):
        from h2o_tpu_torch.core.store import dkv
        fr = dkv().get(bc)
        if fr is None:
            raise ValueError(f"beta_constraints frame {bc!r} not found")
        bc = fr
    nv = bc.vec("names")
    if nv.host_data is not None:
        names = [str(s) for s in nv.host_data]
    elif nv.is_categorical:
        names = [nv.domain[int(float(c))] for c in np.asarray(nv.to_numpy())]
    else:
        names = [str(s) for s in nv.to_numpy()]
    lbs = np.asarray(bc.vec("lower_bounds").to_numpy(), np.float64) \
        if "lower_bounds" in bc.names else [None] * len(names)
    ubs = np.asarray(bc.vec("upper_bounds").to_numpy(), np.float64) \
        if "upper_bounds" in bc.names else [None] * len(names)
    return list(zip(names, lbs, ubs))


def expand_for_scoring(frame: Frame, spec: Dict,
                       device: torch.device) -> torch.Tensor:
    """A training expansion spec applied to a scoring frame on
    ``device``: one-hot with the training domains' codes (an NA or
    unseen code one-hots to all zeros), mean-impute and standardize with
    the training means and sigmas (Model.java adaptTestForTrain)."""
    return expand_columns(frame, spec["cat_names"], spec["cat_cards"],
                          spec["num_names"], spec["means"], spec["sigmas"],
                          spec["standardize"],
                          spec["use_all_factor_levels"], device)


def expand_array(X: torch.Tensor, spec: Dict,
                 order: Optional[Sequence[str]] = None) -> torch.Tensor:
    """A training expansion spec applied to a raw column matrix (codes
    and floats in ``order``, NAs as NaN) on X's device: the array form
    of ``expand_for_scoring``."""
    order = list(order or (list(spec["cat_names"]) +
                           list(spec["num_names"])))
    pos = {c: i for i, c in enumerate(order)}
    X = X.to(torch.float32)
    cols = []
    lo = 0 if spec["use_all_factor_levels"] else 1
    for c, card in zip(spec["cat_names"], spec["cat_cards"]):
        levels = torch.arange(lo, card, dtype=torch.float32, device=X.device)
        cols.append((X[:, pos[c]][:, None] == levels[None, :]).to(
            torch.float32))
    for c, mean, sigma in zip(spec["num_names"], spec["means"],
                              spec["sigmas"]):
        cols.append(expand_numeric(X[:, pos[c]], mean, sigma,
                                   spec["standardize"])[:, None])
    if not cols:
        return torch.zeros((X.shape[0], 0), dtype=torch.float32,
                           device=X.device)
    return torch.cat(cols, dim=1)


def expansion_spec(di: DataInfo) -> Dict:
    return dict(
        cat_names=list(di.cat_names),
        cat_cards=[di.frame.vec(c).cardinality for c in di.cat_names],
        cat_domains=[list(di.frame.vec(c).domain) for c in di.cat_names],
        num_names=list(di.num_names),
        means=[float(di.frame.vec(c).rollups.mean) for c in di.num_names],
        sigmas=[float(di.frame.vec(c).rollups.sigma) for c in di.num_names],
        standardize=di.standardize,
        use_all_factor_levels=di.use_all_factor_levels)


def _destandardize(spec: Dict, beta_std: np.ndarray, cov_std=None):
    """Standardized-space (beta, cov) -> raw space through the affine
    map [x_raw, 1] = [x_std, 1] @ A: beta_raw = inv(A) beta_std, cov_raw
    = inv(A) cov inv(A)'.  Exact for every coefficient, the intercept
    included."""
    P1 = len(beta_std)
    if not spec.get("standardize"):
        return beta_std, cov_std
    A = np.eye(P1)
    n_num = len(spec["num_names"])
    num_off = P1 - 1 - n_num
    for j in range(n_num):
        sig = float(spec["sigmas"][j]) or 1.0
        A[num_off + j, num_off + j] = sig
        A[-1, num_off + j] = float(spec["means"][j])
    Ainv = np.linalg.inv(A)
    beta_raw = Ainv @ beta_std
    cov_raw = Ainv @ cov_std @ Ainv.T if cov_std is not None else None
    return beta_raw, cov_raw


def build_coef_table(out: Dict) -> Optional[Dict]:
    """The coefficients table (GLMModel coefficients_table as a
    TwoDimTable): names, de-standardized coefficients, std_error /
    z_value / p_value when computed, standardized_coefficients."""
    if out.get("is_multinomial") or out.get("beta") is None:
        return None
    spec = out["expansion_spec"]
    names = list(out["coef_names"]) + ["Intercept"]
    beta_std = np.asarray(out["beta"], np.float64)
    se = out.get("std_errs")
    cov = None
    if se is not None:
        cov = np.asarray(out["coef_cov"], np.float64) \
            if out.get("coef_cov") is not None \
            else np.diag(np.asarray(se, np.float64) ** 2)
    beta_raw, cov_raw = _destandardize(spec, beta_std, cov)
    cols = ["names", "coefficients"]
    types = ["string", "double"]
    rows = [[n, float(b)] for n, b in zip(names, beta_raw)]
    if se is not None:
        se_raw = np.sqrt(np.maximum(np.diag(cov_raw), 0.0))
        z = np.divide(beta_raw, se_raw, out=np.zeros_like(beta_raw),
                      where=se_raw > 0)
        from scipy import stats
        if out.get("dispersion_df"):
            pv = 2.0 * stats.t.sf(np.abs(z), out["dispersion_df"])
        else:
            pv = 2.0 * stats.norm.sf(np.abs(z))
        cols += ["std_error", "z_value", "p_value"]
        types += ["double", "double", "double"]
        for r, s_, z_, p_ in zip(rows, se_raw, z, pv):
            r.extend([float(s_), float(z_), float(p_)])
    cols.append("standardized_coefficients")
    types.append("double")
    for r, b in zip(rows, beta_std):
        r.append(float(b))
    return twodim_json("Coefficients", cols, types, rows,
                       "GLM coefficients" +
                       (" (with inference)" if se is not None else ""))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class GLMModel(Model):
    algo = "glm"

    def predict_raw(self, frame: Frame) -> torch.Tensor:
        return self._raw_from_expanded(expand_for_scoring(
            frame, self.output["expansion_spec"], self.device))

    def predict_raw_array(self, X) -> torch.Tensor:
        """Raw predictions of a raw column matrix in ``output['x']``
        order (categorical codes, NaN NAs), expanded on the device."""
        out = self.output
        X = torch.as_tensor(X, dtype=torch.float32, device=self.device)
        return self._raw_from_expanded(
            expand_array(X, out["expansion_spec"], out.get("x")))

    def _raw_from_expanded(self, X: torch.Tensor) -> torch.Tensor:
        out = self.output
        dom = out.get("response_domain")
        dev = X.device
        if out.get("is_ordinal"):
            beta = torch.tensor(np.asarray(out["beta"], _F32), device=dev)
            thr = torch.tensor(np.asarray(out["ordinal_thresholds"], _F32),
                                  device=dev)
            eta = X @ beta[:-1] + beta[-1]
            c = torch.sigmoid(thr[None, :] - eta[:, None])
            c = torch.cat([torch.zeros_like(c[:, :1]), c,
                           torch.ones_like(c[:, :1])], dim=1)
            P_ = torch.clamp_min(torch.diff(c, dim=1), 0.0)
            P_ = P_ / torch.clamp_min(torch.sum(P_, dim=1, keepdim=True), EPS)
            label = torch.argmax(P_, dim=1).to(torch.float32)
            return torch.cat([label[:, None], P_], dim=1)
        if out.get("is_multinomial"):
            B = torch.tensor(np.asarray(out["beta_multinomial"], _F32),
                                device=dev)                      # (K, P+1)
            eta = X @ B[:, :-1].T + B[:, -1][None, :]
            P_ = torch.softmax(eta, dim=1)
            label = torch.argmax(P_, dim=1).to(torch.float32)
            return torch.cat([label[:, None], P_], dim=1)
        eta = _eta(X, np.asarray(out["beta"], _F32))
        fam = _family(out["family_resolved"],
                      self.params.get("tweedie_power", 1.5),
                      self.params.get("theta") or 1.0)
        mu = fam.link_inv(eta)
        if dom is not None:
            thr = float(out.get("default_threshold", 0.5))
            label = (mu >= thr).to(torch.float32)
            return torch.stack([label, 1 - mu, mu], dim=1)
        return mu

    def coef(self) -> Dict[str, float]:
        """De-standardized coefficients (the standardized solution is
        ``coef_norm()``)."""
        names = self.output["coef_names"] + ["Intercept"]
        beta_raw, _ = _destandardize(
            self.output["expansion_spec"],
            np.asarray(self.output["beta"], np.float64))
        return dict(zip(names, beta_raw.tolist()))

    def coef_norm(self) -> Dict[str, float]:
        names = self.output["coef_names"] + ["Intercept"]
        return dict(zip(names, np.asarray(self.output["beta"]).tolist()))


def glm_from_jax_output(output: Dict, params: Dict,
                        device: DeviceLike = None, cls=None) -> GLMModel:
    """The port's ``GLMModel`` (or ``cls``) from an ``h2o_tpu`` GLM's
    output dict (arrays as numpy): ``beta`` or ``beta_multinomial``,
    ``ordinal_thresholds``, ``expansion_spec``, ``family_resolved``,
    ``coef_names``, ``response_domain`` and ``x``; ``params`` gives
    ``response_column``, ``tweedie_power`` and ``theta``."""
    fam = str(output["family_resolved"])
    out = dict(x=list(output["x"]), family_resolved=fam,
               coef_names=list(output["coef_names"]),
               is_multinomial=fam == "multinomial",
               expansion_spec=dict(output["expansion_spec"]))
    dom = output.get("response_domain")
    out["response_domain"] = list(dom) if dom is not None else None
    if fam == "multinomial":
        out["beta_multinomial"] = np.array(output["beta_multinomial"], _F32)
    else:
        out["beta"] = np.array(output["beta"], _F32)
    if fam == "ordinal":
        out["is_ordinal"] = True
        out["ordinal_thresholds"] = np.array(output["ordinal_thresholds"],
                                             _F32)
    for k in ("default_threshold", "lambda_used", "std_errs", "coef_cov",
              "dispersion_df", "iterations", "null_deviance",
              "residual_deviance"):
        if output.get(k) is not None:
            out[k] = output[k]
    out["coefficients_table"] = build_coef_table(out)
    return (cls or GLMModel)(dict(params), out, cloud(device))


# ---------------------------------------------------------------------------
# the builder
# ---------------------------------------------------------------------------

def _first(v):
    """A list-valued param's first entry (the reference's lambda_/alpha
    lists), else the value."""
    if isinstance(v, (list, tuple)):
        return v[0] if v else None
    return v


class GLM(ModelBuilder):
    algo = "glm"
    model_cls = GLMModel

    # engine-fixed: links are family-default, NAs mean-impute,
    # collinear-removal absent.  Solvers: IRLSM/COD, L_BFGS, and
    # ordinal's gradient descent
    ENGINE_FIXED = {
        "solver": ("AUTO", "IRLSM", "COORDINATE_DESCENT",
                   "GRADIENT_DESCENT_LH", "L_BFGS"),
        "link": ("family_default",),
        "missing_values_handling": ("MeanImputation",),
        "remove_collinear_columns": (False,),
        "intercept": (True,),
    }

    def default_params(self) -> Dict:
        p = super().default_params()
        p.update(family="AUTO", solver="AUTO", alpha=None, lambda_=None,
                 lambda_search=False, nlambdas=-1, lambda_min_ratio=-1.0,
                 standardize=True, intercept=True, non_negative=False,
                 max_iterations=-1, beta_epsilon=1e-4, objective_epsilon=-1.0,
                 gradient_epsilon=-1.0, link="family_default",
                 missing_values_handling="MeanImputation",
                 compute_p_values=False, remove_collinear_columns=False,
                 use_all_factor_levels=False, theta=1e-10,
                 beta_constraints=None)
        return p

    def _check_slice(self, p: Dict) -> None:
        if p.get("offset_column"):
            raise ValueError(
                "glm: offset_column is refused: the reference GLM "
                "(h2o_tpu/models/glm.py) accepts the column but never reads "
                "it — glm.py:788 hands it to DataInfo and glm.py:255 forms "
                "eta = X beta + b0 without it — so its model equals the "
                "model without the offset; the port gives an error instead "
                "of that silent result")
        if p.get("recovery_dir") or int(p.get("checkpoint_interval") or 0):
            raise NotImplementedError(
                "glm: recovery_dir/checkpoint_interval (iteration "
                "checkpoints) is not in the port yet; it comes with the "
                "runtime services (P14)")
        if p.get("_warm_start_beta") is not None:
            raise NotImplementedError(
                "glm: the stream refresh's warm start (_warm_start_beta) "
                "comes with the runtime services (P14)")

    def _fit(self, x: List[str], y: str, train: Frame,
             valid: Optional[Frame] = None) -> GLMModel:
        p = self.params
        self._check_slice(p)
        di = DataInfo(train, x, y, self.device, mode="expanded",
                      weights=p.get("weights_column"),
                      standardize=bool(p["standardize"]),
                      use_all_factor_levels=bool(p["use_all_factor_levels"]),
                      impute_missing=True)
        fam_name = p["family"].lower() if p["family"] and \
            p["family"] != "AUTO" else (
            "binomial" if di.nclasses == 2 else
            "multinomial" if di.nclasses > 2 else "gaussian")
        X = di.matrix()
        yv = di.response()
        w = di.weights()
        valid_m = di.valid_mask()
        if fam_name in ("fractionalbinomial", "negativebinomial") and \
                di.response_domain:
            raise ValueError(f"family='{fam_name}' needs a numeric "
                             "response, not a categorical")
        if fam_name == "fractionalbinomial":
            ok = torch.where(valid_m, (yv >= 0.0) & (yv <= 1.0), True)
            if not bool(torch.all(ok)):
                raise ValueError("family='fractionalbinomial' needs a "
                                 "numeric response in [0, 1]")
        if fam_name == "negativebinomial":
            ok = torch.where(valid_m, yv >= 0.0, True)
            if not bool(torch.all(ok)):
                raise ValueError("family='negativebinomial' needs a "
                                 "non-negative response")
        if bool(p.get("compute_p_values")):
            lam_req = _first(p.get("lambda_"))
            if p.get("lambda_search") or (lam_req or 0.0) != 0.0:
                raise ValueError(
                    "compute_p_values requires lambda=0 (no "
                    "regularization), as in the reference GLM")
            if fam_name in ("multinomial", "ordinal"):
                raise ValueError("compute_p_values is not available for "
                                 f"family='{fam_name}'")
            p["lambda_"] = 0.0
        if p.get("beta_constraints") is not None and \
                fam_name in ("multinomial", "ordinal"):
            raise ValueError("beta_constraints are not supported for "
                             f"family='{fam_name}' (reference GLM has "
                             "the same restriction)")
        P = X.shape[1]
        solver = str(p.get("solver") or "AUTO").upper()
        alpha_in = _first(p["alpha"])
        if alpha_in is not None:
            alpha_in = float(alpha_in)
        if solver == "AUTO":
            # defaultSolver() (GLM.java:3971-3997): lambda search /
            # bounds -> COD; wide data or multinomial ridge -> L_BFGS
            # (the wide-data branch only without L1: L-BFGS here is
            # smooth-objective only)
            if p.get("lambda_search"):
                solver = "COORDINATE_DESCENT"
            elif p.get("beta_constraints") is not None or \
                    p.get("non_negative"):
                solver = "COORDINATE_DESCENT"
            elif P >= 5000 and (alpha_in is None or alpha_in == 0):
                solver = "L_BFGS"
            elif fam_name == "multinomial" and alpha_in == 0:
                solver = "L_BFGS"
            else:
                solver = "IRLSM"
        # alpha defaults to 0 under L-BFGS, 0.5 otherwise — after the AUTO
        # resolution, so the default never feeds L1 into L-BFGS
        alpha = alpha_in if alpha_in is not None else \
            (0.0 if solver == "L_BFGS" else 0.5)
        if solver == "L_BFGS" and (
                p.get("beta_constraints") is not None or
                p.get("non_negative") or p.get("_nonneg_mask") is not None):
            raise ValueError(
                "solver='L_BFGS' does not support beta constraints / "
                "non_negative; use COORDINATE_DESCENT")
        p["_solver_resolved"] = solver
        max_iter = int(p["max_iterations"])
        if max_iter <= 0:
            max_iter = 300 if solver == "L_BFGS" else 50

        spec = expansion_spec(di)
        self._assemble_penalty(p, di, spec, X)
        if fam_name == "ordinal":
            if not di.response_domain or di.nclasses < 2:
                raise ValueError("family='ordinal' needs a categorical "
                                 "response with ordered levels")
            beta, thresholds = self._fit_ordinal(X, yv, w, valid_m, di, p,
                                                 alpha, max_iter)
            out = dict(x=x, beta=beta, is_multinomial=False,
                       is_ordinal=True, ordinal_thresholds=thresholds,
                       expansion_spec=spec, family_resolved="ordinal",
                       coef_names=di.expanded_names,
                       response_domain=di.response_domain)
        elif fam_name == "multinomial":
            betas = self._fit_multinomial(X, yv, w, valid_m, di, p, alpha,
                                          max_iter)
            out = dict(x=x, beta_multinomial=betas, is_multinomial=True,
                       expansion_spec=spec, family_resolved="multinomial",
                       coef_names=di.expanded_names,
                       response_domain=di.response_domain)
        else:
            lam = _first(p["lambda_"])
            if lam is not None:
                lam = float(lam)
            # the validation split drives lambda selection when searching
            vdata = None
            if p.get("lambda_search") and valid is not None:
                Xv = expand_for_scoring(valid, spec, self.device)
                yval = torch.from_numpy(valid.vec(y).as_float()).to(
                    self.device)
                wc = p.get("weights_column")
                wv = torch.from_numpy(valid.vec(wc).as_float()).to(
                    self.device) if wc and wc in valid.names else \
                    torch.ones(valid.nrows, dtype=torch.float32,
                               device=self.device)
                vdata = (Xv, torch.nan_to_num(yval), wv, ~torch.isnan(yval))
            beta, lambda_used, dev, extra = self._fit_binomial_ish(
                X, yv, w, valid_m, fam_name, p, alpha, lam, max_iter,
                vdata=vdata)
            out = dict(x=x, beta=beta, is_multinomial=False,
                       expansion_spec=spec, family_resolved=fam_name,
                       coef_names=di.expanded_names,
                       lambda_used=float(lambda_used),
                       residual_deviance=float(dev),
                       response_domain=di.response_domain
                       if fam_name in ("binomial", "quasibinomial")
                       else None, **extra)
        out["coefficients_table"] = build_coef_table(out)
        model = self.model_cls(dict(p), out, self.device)
        model.params["response_column"] = y
        model.output["training_metrics"] = model.model_metrics(train)
        if valid is not None:
            model.output["validation_metrics"] = model.model_metrics(valid)
        return model

    @staticmethod
    def _assemble_penalty(p, di, spec, X):
        """GAM's wiring: name-keyed quadratic-penalty blocks
        (``_penalty_blocks``: [(coef_names, S, scale)]) assembled into one
        (P+1, P+1) matrix in the expanded coefficient layout, and
        ``_nonneg_names`` into a per-coefficient clamp mask;
        ``beta_constraints`` into box bounds in the solved (standardized)
        space.  Standardization maps S to S / (sigma sigma') and a raw
        bound b to b sigma."""
        blocks = p.get("_penalty_blocks")
        names = list(di.expanded_names)
        idx_of = {n: i for i, n in enumerate(names)}
        if blocks:
            P1 = X.shape[1] + 1
            S = np.zeros((P1, P1))
            sig = dict(zip(spec["num_names"], spec["sigmas"])) \
                if spec["standardize"] else {}
            # each block calibrated against its own data-Gram energy: a
            # scale of 1 adds 0.1 % of tr(G_block) of curvature penalty
            col_ss = torch.sum(X * X, dim=0).cpu().numpy().astype(np.float64)
            RHO = 1e-3
            for bnames, Sb, scale in blocks:
                idx = [idx_of[n] for n in bnames]
                Sb = np.asarray(Sb, np.float64)
                if sig:
                    d = np.array([1.0 / ((sig.get(n) or 1.0) or 1.0)
                                  for n in bnames])
                    Sb = Sb * d[:, None] * d[None, :]
                tr_s = max(np.trace(Sb), 1e-12)
                tr_g = max(float(col_ss[idx].sum()), 1e-12)
                S[np.ix_(idx, idx)] += Sb * (scale * RHO * tr_g / tr_s)
            p["_penalty"] = S
        nn = p.get("_nonneg_names")
        if nn:
            mask = np.zeros((X.shape[1] + 1,), _F32)
            for n in nn:
                mask[idx_of[n]] = 1.0
            p["_nonneg_mask"] = mask
        bc = p.get("beta_constraints")
        if bc is not None:
            rows = _beta_constraint_rows(bc)
            P1 = X.shape[1] + 1
            lo = np.full((P1,), -np.inf, np.float64)
            hi = np.full((P1,), np.inf, np.float64)
            sig = dict(zip(spec["num_names"], spec["sigmas"])) \
                if spec["standardize"] else {}
            for name, lb, ub in rows:
                if name == "Intercept":
                    j, s = P1 - 1, 1.0
                elif name in idx_of:
                    j = idx_of[name]
                    s = float(sig.get(name, 1.0) or 1.0)
                else:
                    raise ValueError(
                        f"beta_constraints names unknown coefficient "
                        f"{name!r}; valid: {names[:8]}... + Intercept")
                if lb is not None and np.isfinite(lb):
                    lo[j] = lb * s
                if ub is not None and np.isfinite(ub):
                    hi[j] = ub * s
            if np.any(lo > hi):
                raise ValueError("beta_constraints: lower_bound > "
                                 "upper_bound for some coefficient")
            p["_beta_lo"], p["_beta_hi"] = lo, hi

    # -- solvers ------------------------------------------------------------

    def _irlsm_at_lambda(self, X, yv, w, valid_m, fam, p, alpha, lam, beta,
                         max_iter, n_obs, first_pass=None):
        """IRLSM to convergence at one lambda from ``beta``;
        ``first_pass`` is an already computed (G, q, dev) at ``beta``.  A
        quadratic penalty S folds into the Gram (1/2 b'(G+S)b - q'b); COD
        solves when L1, non-negativity or bounds apply, else Cholesky;
        the loop stops when no coefficient moved by beta_epsilon, and a
        gaussian after its second solve."""
        nonneg = bool(p.get("non_negative"))
        pen = p.get("_penalty")
        mask = p.get("_nonneg_mask")
        if mask is not None:
            nonneg = True
        lo, hi = p.get("_beta_lo"), p.get("_beta_hi")
        dev_prev, dev = None, None
        self._last_iters = 0
        for it in range(max_iter):
            if it == 0 and first_pass is not None:
                G, q, dev = first_pass
            else:
                G, q, dev = _irlsm_pass(X, yv, w, valid_m, beta, fam)
            self._last_iters = it + 1
            if pen is not None:
                G = (G + np.asarray(pen, _F32)).astype(_F32)
            l1 = lam * alpha * n_obs
            l2 = lam * (1 - alpha) * n_obs
            if l1 > 0 or nonneg or lo is not None:
                beta_new = _cod_solve(G, q, beta, l1, l2,
                                      non_negative=nonneg,
                                      nonneg_mask=mask, lo=lo, hi=hi)
            else:
                beta_new = _chol_solve(G, q, l2)
            delta = float(np.max(np.abs(beta_new - beta)))
            beta = beta_new
            if dev_prev is not None and fam.name == "gaussian":
                break  # gaussian converges in one weighted solve
            if delta < float(p["beta_epsilon"]):
                break
            dev_prev = dev
        return beta, float(dev)

    def _lbfgs_at_lambda(self, X, yv, w, valid_m, fam, p, alpha, lam, beta,
                         max_iter, n_obs, first_pass=None):
        """L-BFGS to convergence at one lambda (GLM.fitLBFGS); L1 and
        coefficient bounds are refused (no OWL-QN)."""
        l1 = lam * alpha * n_obs
        if l1 > 0:
            raise ValueError(
                "solver='L_BFGS' supports only L2 regularization "
                "(alpha=0); use IRLSM/COORDINATE_DESCENT for elastic "
                "net")
        if p.get("_nonneg_mask") is not None or \
                p.get("_beta_lo") is not None:
            raise ValueError(
                "solver='L_BFGS' does not support coefficient bounds; "
                "use COORDINATE_DESCENT")
        l2 = lam * (1 - alpha) * n_obs
        vg = _glm_objective_fn(X, yv, w, valid_m, fam.name,
                               p["tweedie_power"],
                               float(p.get("theta") or 1.0), l2,
                               pen=p.get("_penalty"))
        beta_np, _f, iters = _lbfgs_minimize(
            vg, np.asarray(beta, np.float64), max_iter,
            gtol=float(p.get("gradient_epsilon") or 0) or 1e-7)
        self._last_iters = iters
        beta = np.asarray(beta_np, _F32)
        return beta, _deviance_at(X, yv, w, valid_m, beta, fam)

    def _fit_binomial_ish(self, X, yv, w, valid_m, fam_name, p, alpha, lam,
                          max_iter, vdata=None):
        """One lambda, or the lambda search (GLM.java:987-988,1236-1254):
        ``nlambdas`` values from lambda_max (the null model's gradient)
        down to lambda_min_ratio lambda_max, each warm-started from the
        last; the model is the best by validation deviance when a
        validation split is given (stopping after 3 worse in a row), else
        by training deviance, and the walk stops once 99.9 % of the null
        deviance is explained."""
        P = X.shape[1]
        fam = _family(fam_name, p["tweedie_power"],
                      float(p.get("theta") or 1.0))
        zero = torch.zeros((), dtype=torch.float32, device=X.device)
        yz = torch.where(valid_m, torch.nan_to_num(yv), zero)
        wa = torch.where(valid_m, w, zero)
        mu0 = fam.null_mu(yz, wa)
        beta = np.zeros(P + 1, _F32)
        beta[-1] = float(fam.link(mu0))
        n_obs = float(torch.clamp_min(torch.sum(wa), 1.0))
        null_dev = float(fam.deviance(yz, torch.full_like(yv, float(mu0)),
                                      wa))
        extra = dict(null_deviance=null_dev)

        search = bool(p.get("lambda_search"))
        first_pass = None
        if lam is None or search:
            # lambda_max from the null model's gradient; the pass is reused
            # as iteration 0 of the first solve (same beta)
            G0, q0, dev0 = _irlsm_pass(X, yv, w, valid_m, beta, fam)
            grad = q0 - G0 @ beta
            lam_max = float(_F32(np.max(np.abs(grad[:-1]))) /
                            _F32(max(alpha, 1e-3)) / _F32(n_obs))
            first_pass = (G0, q0, dev0)

        solver = p.get("_solver_resolved", "IRLSM")
        solve = self._lbfgs_at_lambda if solver == "L_BFGS" \
            else self._irlsm_at_lambda
        if not search:
            if lam is None:
                lam = 1e-3 * lam_max   # the default single lambda
            beta, dev = solve(X, yv, w, valid_m, fam, p, alpha, lam, beta,
                              max_iter, n_obs, first_pass=first_pass)
            extra["iterations"] = self._last_iters
            if bool(p.get("compute_p_values")):
                extra.update(self._p_values(X, yv, w, valid_m, fam, p,
                                            beta, n_obs))
            self._update(1.0, f"{solver} converged")
            return beta, lam, dev, extra

        # ---- the lambda search path ----
        user_lams = p.get("lambda_")
        if isinstance(user_lams, (list, tuple)) and len(user_lams) > 1:
            # a user path, walked largest first (warm starts descend)
            lams = np.sort(np.asarray(
                [float(v) for v in user_lams], np.float64))[::-1]
            nlam = len(lams)
        else:
            nlam = int(p.get("nlambdas") or -1)
            if nlam <= 0:
                nlam = 30 if alpha == 0 else 100   # GLM.java:988
            lmr = float(p.get("lambda_min_ratio") or -1.0)
            if lmr <= 0:
                lmr = 1e-4 if (n_obs / 16.0) > P else 1e-2  # GLM.java:1237
                if alpha == 0:
                    lmr *= 1e-2                              # GLM.java:1239
            lams = lam_max * lmr ** (np.arange(nlam) / max(nlam - 1, 1))
        inner = min(max_iter, 10)
        null_dev_v = None
        if vdata is not None:
            Xv, yval, wv, vmask = vdata
            beta_null = np.zeros(P + 1, _F32)
            beta_null[-1] = float(fam.link(mu0))
            null_dev_v = _deviance_at(Xv, yval, wv, vmask, beta_null, fam)
        path_lams, path_dev_t, path_dev_v, path_coefs = [], [], [], []
        best = None                          # (crit, beta, lam, dev_train)
        total_iters = 0
        worse_streak = 0
        for k, lam_k in enumerate(lams):
            beta, dev = solve(X, yv, w, valid_m, fam, p, alpha, float(lam_k),
                              beta, inner, n_obs,
                              first_pass=first_pass if k == 0 else None)
            total_iters += self._last_iters
            dev_v = None
            if vdata is not None:
                dev_v = _deviance_at(Xv, yval, wv, vmask, beta, fam)
            crit = dev_v if dev_v is not None else dev
            path_lams.append(float(lam_k))
            path_dev_t.append(dev)
            path_dev_v.append(dev_v)
            path_coefs.append(np.asarray(beta))
            self._update((k + 1) / len(lams),
                         f"lambda {k + 1}/{len(lams)} = {lam_k:.4g}")
            # NaN-safe: the first path point always seeds best
            if best is None or crit < best[0] - 1e-12:
                best = (crit, beta, float(lam_k), dev)
                worse_streak = 0
            else:
                worse_streak += 1
            dev_explained = 1.0 - dev / max(null_dev, EPS)
            if dev_explained > 0.999:       # nothing left to explain
                break
            if vdata is not None and worse_streak >= 3:
                break                        # validation deviance rising
        _, beta_best, lam_best, dev_best = best
        extra.update(
            iterations=total_iters,
            lambda_best=lam_best, lambda_max=float(lam_max),
            lambda_min=float(lams[-1]), alpha_best=float(alpha),
            reg_path=dict(
                lambdas=path_lams, alphas=[float(alpha)] * len(path_lams),
                explained_deviance_train=[
                    1.0 - d / max(null_dev, EPS) for d in path_dev_t],
                explained_deviance_valid=(
                    None if vdata is None else
                    [None if d is None else
                     1.0 - d / max(null_dev_v, EPS) for d in path_dev_v]),
                coefficients=[c.tolist() for c in path_coefs]))
        return beta_best, lam_best, dev_best, extra

    def _p_values(self, X, yv, w, valid_m, fam, p, beta, n_obs) -> Dict:
        """Std errors, z and p of an unregularized fit: the covariance is
        dispersion x inv(X'WX) at the converged beta — one more data
        pass, the inverse in float64 on the host (computePValues).
        Estimated-dispersion families use Student-t tails; binomial and
        poisson the standard normal."""
        G, _q, _d = _irlsm_pass(X, yv, w, valid_m, beta, fam)
        Gn = np.asarray(G, np.float64)
        P1 = Gn.shape[0]
        cov = np.linalg.inv(Gn + 1e-10 * np.eye(P1))
        df = max(n_obs - P1, 1.0)
        if fam.name in ("binomial", "quasibinomial", "fractionalbinomial",
                        "poisson"):
            disp, use_t = 1.0, False
        else:
            mu = fam.link_inv(_eta(X, beta))
            zero = torch.zeros((), dtype=torch.float32, device=X.device)
            wa = torch.where(valid_m, w, zero)
            pearson = float(torch.sum(
                wa * (torch.nan_to_num(yv) - mu) ** 2 /
                torch.clamp_min(fam.variance(mu), EPS)))
            disp, use_t = pearson / df, True
        se = np.sqrt(np.maximum(np.diag(cov) * disp, 0.0))
        b = np.asarray(beta, np.float64)
        z = np.divide(b, se, out=np.zeros_like(b), where=se > 0)
        from scipy import stats
        pv = 2.0 * (stats.t.sf(np.abs(z), df) if use_t
                    else stats.norm.sf(np.abs(z)))
        return dict(std_errs=se, z_values=z, p_values=pv,
                    dispersion=float(disp), coef_cov=cov * disp,
                    dispersion_df=float(df) if use_t else None)

    def _fit_ordinal(self, X, yv, w, valid_m, di, p, alpha, max_iter):
        """Proportional odds (cumulative logit): P(y <= k) =
        sigmoid(thr_k - x'beta), one beta and K-1 increasing thresholds,
        by full-batch Adam on the exact likelihood (the reference's
        GRADIENT_DESCENT_LH path); 200 max(max_iterations, 10) steps."""
        K = di.nclasses
        P = X.shape[1]
        lam = _first(p.get("lambda_"))
        lam = float(lam) if lam is not None else 0.0
        l1 = lam * alpha
        l2 = lam * (1 - alpha)
        dev = X.device
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        wa = torch.where(valid_m, w, zero)
        yk = torch.where(valid_m, torch.nan_to_num(yv), zero).to(torch.int32)
        n_obs = torch.clamp_min(torch.sum(wa), 1.0)

        # thresholds start at the empirical cumulative logits of the
        # class priors
        pri = torch.stack([torch.sum(wa * (yk == k)) for k in range(K)]
                          ).cpu().numpy()
        pri = np.maximum(pri / max(pri.sum(), 1e-12), 1e-6)
        cum = np.clip(np.cumsum(pri)[:-1], 1e-6, 1 - 1e-6)
        thr0 = np.log(cum / (1 - cum))
        incr0 = np.maximum(np.diff(thr0), 1e-3)
        s0 = np.log(np.expm1(incr0)) if K > 2 else np.zeros((0,))
        params0 = torch.from_numpy(np.concatenate([
            np.zeros(P, _F32), np.asarray([thr0[0]], _F32),
            np.asarray(s0, _F32)])).to(dev)

        # GAM's wiring: the penalty (calibrated on the sum-scale Gram, so
        # divided by n_obs in this mean-scale objective) and the
        # non-negative mask, by projection
        pen = p.get("_penalty")
        pen_dev = None if pen is None else torch.as_tensor(
            np.asarray(pen, _F32), device=dev)
        mask = p.get("_nonneg_mask")
        proj_mask = None
        if mask is not None:
            proj_mask = torch.cat([
                torch.as_tensor(np.asarray(mask, _F32)[:P], device=dev),
                torch.zeros(params0.shape[0] - P, device=dev)])
        steps = 200 * max(max_iter, 10)
        params, loss = _ordinal_gd(
            params0, X, yk, wa, n_obs,
            torch.tensor(float(_F32(l1)), device=dev),
            torch.tensor(float(_F32(l2)), device=dev),
            pen_dev, proj_mask, P=P, K=K, steps=steps)
        self._update(0.9, f"ordinal GD {steps} steps, "
                          f"nll={float(loss):.5g}")
        beta, thr = _ordinal_unpack(params, P, K)
        beta_full = np.concatenate([beta.cpu().numpy(),
                                    np.zeros(1, _F32)])   # intercept in thr
        return beta_full, thr.cpu().numpy()

    def _fit_multinomial(self, X, yv, w, valid_m, di, p, alpha, max_iter):
        """Per-class IRLSM (one-vs-rest binomial passes a class, each
        class's betas its own warm start, GLM.java's multinomial loop),
        or with solver L_BFGS the joint softmax NLL of all classes."""
        K = di.nclasses
        P = X.shape[1]
        betas = np.zeros((K, P + 1), _F32)
        lam = _first(p["lambda_"])
        lam = float(lam) if lam is not None else 0.0
        zero = torch.zeros((), dtype=torch.float32, device=X.device)
        n_obs = float(torch.clamp_min(torch.sum(
            torch.where(valid_m, w, zero)), 1.0))
        pen = p.get("_penalty")
        mask = p.get("_nonneg_mask")
        if p.get("_solver_resolved") == "L_BFGS" and pen is None and \
                mask is None and not p.get("non_negative"):
            if lam * alpha > 0:
                raise ValueError(
                    "solver='L_BFGS' supports only L2 regularization "
                    "(alpha=0) for multinomial")
            l2 = lam * (1 - alpha) * n_obs
            vg = _glm_objective_fn(X, yv, w, valid_m, "multinomial",
                                   p["tweedie_power"],
                                   float(p.get("theta") or 1.0), l2,
                                   n_icpt=K)
            flat, _f, iters = _lbfgs_minimize(
                vg, np.zeros((K * (P + 1),), np.float64),
                max(max_iter, 300),
                gtol=float(p.get("gradient_epsilon") or 0) or 1e-7,
                progress=lambda i, f: self._update(
                    min(0.9, i / max(max_iter, 300)),
                    f"L-BFGS iter {i} obj={f:.5g}"))
            self._last_iters = iters
            return np.asarray(flat.reshape(K, P + 1), _F32)
        binom = _Binomial()
        self._last_iters = 0
        for it in range(max_iter):
            max_delta = 0.0
            for k in range(K):
                # NaN responses are no class (their rows are masked)
                yk = (yv == k).to(torch.float32)
                G, q, _ = _irlsm_pass(X, yk, w, valid_m, betas[k], binom)
                if pen is not None:
                    G = (G + np.asarray(pen, _F32)).astype(_F32)
                l1 = lam * alpha * n_obs
                l2 = lam * (1 - alpha) * n_obs
                nonneg = bool(p.get("non_negative")) or mask is not None
                bk = _cod_solve(G, q, betas[k], l1, l2,
                                non_negative=nonneg, nonneg_mask=mask) \
                    if (l1 > 0 or nonneg) else _chol_solve(G, q, l2)
                max_delta = max(max_delta,
                                float(np.max(np.abs(bk - betas[k]))))
                betas[k] = bk
            self._last_iters = it + 1
            self._update((it + 1) / max_iter, f"multinomial iter {it + 1}")
            if max_delta < float(p["beta_epsilon"]):
                break
        return betas
