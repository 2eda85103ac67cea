"""GAM — port of ``h2o_tpu/models/gam.py``: the smoother bases
(``_ncs_basis`` :38-54, ``_tp_basis`` :57-63, the Cox-de Boor
``_bspline_cols`` :66-98, ``_ms_basis`` :101-106, ``_is_basis``
:109-121), ``_curvature_penalty`` (:128-151), ``_expand_gam`` (:154-179),
``GAMModel`` (:182-206) and ``GAM`` (:209-337).

Each ``gam_columns`` entry is expanded into its basis columns at knots
on the column's quantiles (``bs`` 0 cubic regression splines, 1
thin-plate, 2 monotone I-splines with non-negative coefficients, 3
M-splines), and the expanded frame goes to the port's GLM with one
curvature penalty block per smoother (``_penalty_blocks``) and the
I-splines' non-negative mask (``_nonneg_names``), which
``glm.GLM._assemble_penalty`` folds into the Gram.

The bases are float32 tensor code on the model's device, written as
XLA evaluates the reference's: ``** 3`` is XLA's ``integer_pow``, that
is ``x * x * x``, and a division by a knot difference divides by a
float32 tensor.  The penalty matrices integrate the bases' second
differences on a 512-point grid on the host, in float64 from the
float32 basis values, once per smoother.  Scoring re-expands a frame
with the stored knots and training means.  ``keep_gam_cols`` publishes
the expanded training frame in ``store.dkv()`` as
``{model_id}_gamified`` (``output["gam_transformed_center_key"]``, the
reference's ``gam.py:322-330``).  Refused by name: iteration
checkpoints (``recovery_dir``, P14).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.core.frame import Frame, Vec
from h2o_tpu_torch.core.store import Key, dkv
from h2o_tpu_torch.models.glm import GLM, GLMModel, glm_from_jax_output
from h2o_tpu_torch.models.model import Model, ModelBuilder

BS_CR, BS_TP, BS_IS, BS_MS = 0, 1, 2, 3
_BS_NAMES = {BS_CR: "cr", BS_TP: "thin-plate", BS_IS: "monotone-I-spline",
             BS_MS: "M-spline"}


def _f32(v) -> float:
    return float(np.float32(v))


def _div(x: torch.Tensor, d) -> torch.Tensor:
    """``x / d`` by a float32 tensor (a CUDA tensor divided by a number
    is multiplied by its reciprocal)."""
    return x / torch.full_like(x, _f32(d))


def _cube(a: torch.Tensor) -> torch.Tensor:
    return a * a * a


def _ncs_basis(x: torch.Tensor, knots: np.ndarray) -> List[torch.Tensor]:
    """Natural cubic spline basis (ESL 5.2.1): [x, N_1..N_{K-2}]."""
    K = len(knots)
    xk = np.asarray(knots, np.float32)

    def d(k):
        num = _cube(torch.clamp_min(x - _f32(xk[k]), 0.0)) - \
            _cube(torch.clamp_min(x - _f32(xk[K - 1]), 0.0))
        return _div(num, max(np.float32(xk[K - 1] - xk[k]),
                             np.float32(1e-12)))

    cols = [x]
    dK2 = d(K - 2)
    for k in range(K - 2):
        cols.append(d(k) - dK2)
    return cols


def _tp_basis(x: torch.Tensor, knots: np.ndarray) -> List[torch.Tensor]:
    """1-D thin-plate basis: [x, |x - k|^3 / scale^3 per knot]."""
    xk = np.asarray(knots, np.float32)
    scale = max(float(knots[-1] - knots[0]), 1e-6)
    return [x] + [_div(_cube(torch.abs(x - _f32(xk[k]))), scale ** 3)
                  for k in range(len(knots))]


def _bspline_cols(x: torch.Tensor, knots: np.ndarray,
                  degree: int = 3) -> List[torch.Tensor]:
    """Every B-spline on the padded knot vector by the Cox-de Boor
    recursion, x clamped to the knot span (extrapolation holds the
    boundary value)."""
    t = np.concatenate([[knots[0]] * degree, knots, [knots[-1]] * degree])
    t = t.astype(np.float64)
    n_basis = len(t) - degree - 1
    x = torch.clamp(x, _f32(t[0]), _f32(t[-1]))
    B = []
    for i in range(len(t) - 1):
        if t[i + 1] > t[i]:
            hi = (x <= _f32(t[i + 1])) if t[i + 1] >= t[-1] else \
                (x < _f32(t[i + 1]))
            B.append(((x >= _f32(t[i])) & hi).to(torch.float32))
        else:
            B.append(torch.zeros_like(x))
    for d in range(1, degree + 1):
        Bn = []
        for i in range(len(t) - d - 1):
            den1 = t[i + d] - t[i]
            den2 = t[i + d + 1] - t[i + 1]
            term = None
            if den1 > 0:
                term = _div(x - _f32(t[i]), den1) * B[i]
            if den2 > 0:
                right = _div(_f32(t[i + d + 1]) - x, den2) * B[i + 1]
                term = right if term is None else term + right
            Bn.append(term if term is not None else torch.zeros_like(x))
        B = Bn
    return B[:n_basis]


def _ms_basis(x: torch.Tensor, knots: np.ndarray) -> List[torch.Tensor]:
    """Cubic B-splines without the first (the full set sums to one, the
    intercept's column)."""
    return _bspline_cols(x, knots, degree=3)[1:]


def _is_basis(x: torch.Tensor, knots: np.ndarray) -> List[torch.Tensor]:
    """I-splines: I_j = sum over m >= j of the cubic B-splines B_m (the
    first dropped), monotone non-decreasing."""
    B = _bspline_cols(x, knots, degree=3)
    cols = []
    acc = torch.zeros_like(x)
    for b in reversed(B[1:]):
        acc = acc + b
        cols.append(acc)
    return list(reversed(cols))


_BASES = {BS_CR: _ncs_basis, BS_TP: _tp_basis, BS_IS: _is_basis,
          BS_MS: _ms_basis}


def _curvature_penalty(basis_fn, knots: np.ndarray,
                       npts: int = 512) -> np.ndarray:
    """S_jk = integral of b_j'' b_k'' over the knot span: trapezoid
    quadrature of second differences on the host, normalized to trace
    P, plus a 1e-3 ridge that keeps the penalized Gram definite."""
    lo, hi = float(knots[0]), float(knots[-1])
    pad = (hi - lo) * 1e-6
    g = np.linspace(lo + pad, hi - pad, npts)
    cols = basis_fn(torch.from_numpy(g.astype(np.float32)), knots)
    Bm = np.stack([c.numpy().astype(np.float64) for c in cols], axis=1)
    h = g[1] - g[0]
    d2 = (Bm[2:] - 2 * Bm[1:-1] + Bm[:-2]) / (h * h)
    S = d2.T @ d2 * h
    tr = np.trace(S)
    if tr > 0:
        S = S * (S.shape[0] / tr)
    return S + 1e-3 * np.eye(S.shape[0])


def _expand_gam(frame: Frame, gam_cols: List[str],
                knots_map: Dict[str, np.ndarray], means: Dict[str, float],
                bs_map: Dict[str, int], device,
                plain_x: Optional[List[str]] = None) -> Frame:
    """``frame`` with each gam column's basis columns appended
    (``<col>_gam_<i>``), NaN imputed with the training mean; a cr or
    thin-plate column that is also a plain predictor skips its linear
    element.  The bases are computed on ``device``."""
    plain = set(plain_x or [])
    out = Frame(list(frame.names), list(frame.vecs))
    for c in gam_cols:
        x = torch.nan_to_num(torch.from_numpy(frame.vec(c).as_float()).to(
            device), nan=_f32(means[c]))
        linear_first = bs_map[c] in (BS_CR, BS_TP)
        for i, b in enumerate(_BASES[bs_map[c]](x, knots_map[c])):
            if linear_first and i == 0 and c in plain:
                continue
            out.add(f"{c}_gam_{i}", Vec(b.cpu().numpy()))
    return out


class GAMModel(Model):
    algo = "gam"

    def _inner(self) -> GLMModel:
        return GLMModel(self.output["glm_params"], self.output["glm_output"],
                        self.device)

    def expand(self, frame: Frame) -> Frame:
        out = self.output
        return _expand_gam(frame, out["gam_columns"], out["knots"],
                           out["gam_col_means"], out["bs_map"], self.device,
                           plain_x=out.get("x"))

    def predict_raw(self, frame: Frame) -> torch.Tensor:
        return self._inner().predict_raw(self.expand(frame))

    def coef(self) -> Dict[str, float]:
        return self._inner().coef()


def gam_from_jax_output(output: Dict, params: Dict,
                        device: DeviceLike = None) -> GAMModel:
    """The port's ``GAMModel`` from an ``h2o_tpu`` GAM's output dict
    (arrays as numpy), its inner GLM carried by
    ``glm_from_jax_output``."""
    dev = cloud(device)
    inner = glm_from_jax_output(output["glm_output"], output["glm_params"],
                                device=dev)
    out = {k: output[k] for k in ("gam_columns", "input_columns",
                                  "gam_col_means", "bs_map", "scale_map",
                                  "num_knots", "basis_names", "x")}
    dom = output.get("response_domain")
    if "glm_key" in output:
        out["glm_key"] = str(output["glm_key"])
    out.update(knots={c: np.asarray(v, np.float64)
                      for c, v in output["knots"].items()},
               glm_params=dict(output["glm_params"]),
               glm_output=inner.output,
               response_domain=list(dom) if dom is not None else None)
    return GAMModel(dict(params), out, dev)


class GAM(ModelBuilder):
    algo = "gam"
    model_cls = GAMModel

    def default_params(self) -> Dict:
        p = super().default_params()
        p.update(gam_columns=None, num_knots=None, bs=None, scale=None,
                 family="AUTO", solver="AUTO", lambda_=0.0, alpha=0.0,
                 standardize=False, keep_gam_cols=False,
                 splines_non_negative=None)
        return p

    @staticmethod
    def _per_col(val, gam_cols: Sequence[str], default):
        if val is None:
            return {c: default for c in gam_cols}
        if isinstance(val, (int, float)):
            return {c: val for c in gam_cols}
        if len(val) != len(gam_cols):
            raise ValueError("per-gam-column list length mismatch: "
                             f"{val!r} vs {list(gam_cols)!r}")
        return dict(zip(gam_cols, val))

    def _fit(self, x: List[str], y: str, train: Frame,
             valid: Optional[Frame] = None) -> GAMModel:
        p = self.params
        if p.get("recovery_dir") or int(p.get("checkpoint_interval") or 0):
            raise NotImplementedError(
                "gam: recovery_dir/checkpoint_interval comes with the "
                "runtime services (P14)")
        gam_cols = list(p.get("gam_columns") or [])
        if not gam_cols:
            raise ValueError("GAM requires gam_columns")
        nk_map = {c: int(v) for c, v in
                  self._per_col(p.get("num_knots"), gam_cols, 10).items()}
        bs_map = {c: int(v) for c, v in
                  self._per_col(p.get("bs"), gam_cols, BS_CR).items()}
        for c, b in bs_map.items():
            if b not in _BASES:
                raise ValueError(f"bs={b} for {c!r}: supported bs values "
                                 f"are {sorted(_BASES)} ({_BS_NAMES})")
        scale_map = {c: float(v) for c, v in
                     self._per_col(p.get("scale"), gam_cols, 1.0).items()}

        knots_map: Dict[str, np.ndarray] = {}
        means: Dict[str, float] = {}
        for c in gam_cols:
            vals = train.vec(c).as_float()
            vals = vals[~np.isnan(vals)]
            qs = np.quantile(vals, np.linspace(0.0, 1.0, max(nk_map[c], 3)))
            knots_map[c] = np.unique(qs)
            if len(knots_map[c]) < 3:
                raise ValueError(
                    f"gam column {c!r} has only {len(knots_map[c])} "
                    "distinct knot value(s); GAM smoothers need >= 3 — "
                    "drop the column or use it as a plain predictor")
            means[c] = float(vals.mean()) if len(vals) else 0.0

        input_columns = list(dict.fromkeys(list(x) + gam_cols))
        # a monotone smoother's raw column is no plain predictor
        x = [c for c in x if not (c in gam_cols and bs_map[c] == BS_IS)]
        dev = self.device
        expanded = _expand_gam(train, gam_cols, knots_map, means, bs_map,
                               dev, plain_x=list(x))
        exp_valid = _expand_gam(valid, gam_cols, knots_map, means, bs_map,
                                dev, plain_x=list(x)) \
            if valid is not None else None
        basis_names = [n for n in expanded.names if n not in train.names]
        self._update(0.2, f"spline basis: {len(basis_names)} columns")

        penalty_blocks = []
        nonneg_names: List[str] = []
        plain = set(x)
        snn = p.get("splines_non_negative")
        for c in gam_cols:
            names_c = [n for n in basis_names if n.startswith(f"{c}_gam_")]
            S = _curvature_penalty(_BASES[bs_map[c]], knots_map[c])
            if bs_map[c] in (BS_CR, BS_TP) and c in plain:
                S = S[1:, 1:]       # the skipped linear element
            penalty_blocks.append((names_c, S, scale_map[c]))
            nn_default = bs_map[c] == BS_IS
            if self._per_col(snn, gam_cols, nn_default).get(
                    c, nn_default) and bs_map[c] == BS_IS:
                nonneg_names.extend(names_c)

        glm_params = dict(
            family=p.get("family", "AUTO"), solver=p.get("solver", "AUTO"),
            lambda_=p.get("lambda_", 0.0), alpha=p.get("alpha", 0.0),
            standardize=bool(p.get("standardize")), seed=p.get("seed", -1),
            weights_column=p.get("weights_column"))
        glm = GLM(device=dev, **{k: v for k, v in glm_params.items()
                                 if v is not None})
        glm.params["_penalty_blocks"] = penalty_blocks
        if nonneg_names:
            glm.params["_nonneg_names"] = nonneg_names
        inner = glm._fit(list(x) + basis_names, y, expanded, exp_valid)

        out = dict(gam_columns=gam_cols, input_columns=input_columns,
                   knots=knots_map, gam_col_means=means, bs_map=bs_map,
                   scale_map=scale_map,
                   num_knots=[nk_map[c] for c in gam_cols],
                   basis_names=basis_names, glm_key=inner.model_id,
                   glm_params=inner.params,
                   glm_output=inner.output,
                   response_domain=inner.output.get("response_domain"),
                   x=list(x),
                   training_metrics=inner.output.get("training_metrics"))
        if valid is not None:
            out["validation_metrics"] = \
                inner.output.get("validation_metrics")
        model = self.model_cls(dict(p), out, dev)
        model.params["response_column"] = y
        if p.get("keep_gam_cols"):
            key = f"{model.model_id}_gamified"
            expanded.key = Key(key)
            dkv().put(key, expanded)
            out["gam_transformed_center_key"] = key
        return model
