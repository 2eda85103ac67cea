"""GLRM — port of ``h2o_tpu/models/glrm.py`` (the losses ``_loss_fn``
:37-63, the proximal operators ``_prox`` :66-82, the objective and the
alternating step ``_make_step`` :85-124, the fixed-Y scoring solve
``_x_solver`` :131-154 with ``_observed_mask`` :157-169, ``GLRMModel``
:172-201 and ``GLRM`` :204-319).

A ~ X Y on the expanded matrix (categoricals one-hot over every level,
numerics optionally standardized, NaN cells unobserved): X (rows, k)
and Y (k, P) live on the model's device.  A step is the X gradient, the
prox, then the Y gradient at the new X and its prox; the gradients are
the losses' closed-form derivatives (the ones ``jax.grad`` takes, a
maximum's tie split in halves as jax splits it) masked to the observed
cells, times Y' and X'.  The step size grows by 1.05 on each accepted
step and halves (the step reverted) on each rejected one, until it
falls below ``min_step_size``, ``max_iterations`` pass, or the last two
accepted objectives are within 1e-8 (1 + objective).

Init ``SVD`` is two iterations of SVD's randomized range on the matrix
with its unobserved cells at 0 (``models/svd.randomized_range``);
``Random`` draws X as ``jax.random.normal(key, (R, k))`` and Y from the
key's first split, both times 0.01; either is projected through the
prox at step 0.  The reference's R is its padded row count, which it
also reads in the starting step ``init_step_size / max(1, observed /
R)``: the port takes R from ``statpack.padded_rows`` (one device's row
quantum), so the two agree where their paddings do.

Scoring solves X for new rows with Y fixed: 30 prox-gradient iterations
from 0 at step 1 / max(|Y|^2, 1), under the mask of observed raw values
(an NA categorical masks its one-hot columns).  ``predict`` gives the
reconstruction ``reconstr_<col>``, ``transform`` the archetype
coordinates ``Arch1..Archk``.  The training representation X is
published in ``store.dkv()`` as ``glrm_rep_<model_id>`` under
``output["representation_key"]``, as the reference's (``:313-315``),
and kept as ``output["representation_frame"]``.

Refused by name: regularizers other than None, Quadratic, L1 and
NonNegative (the reference has no prox for them), ``init`` other than
SVD and Random (the reference trains PlusPlus and User from a random
init), ``transform`` other than NONE and STANDARDIZE (the reference
ignores DEMEAN), and the reference's own fixed ``multi_loss`` and
``recover_svd``.  ``recovery_dir`` snapshots the build
(``models/model.py``), as the reference's does; no iteration checkpoint.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.core.frame import Frame, Vec
from h2o_tpu_torch.models import metrics as mm
from h2o_tpu_torch.models.glm import expand_for_scoring, expansion_spec
from h2o_tpu_torch.models.model import DataInfo, Model, ModelBuilder, publish
from h2o_tpu_torch.models.svd import randomized_range
from h2o_tpu_torch.ops import prng, statpack

#: fixed-Y scoring solve iterations (``glrm.py:129``)
GLRM_X_ITERS = 30

LOSSES = ("Quadratic", "Absolute", "Huber", "Poisson", "Logistic", "Hinge")
REGULARIZERS = ("None", "Quadratic", "L1", "NonNegative")


def _key(name: Optional[str], default: str) -> str:
    return (name or default).lower().replace("_", "")


def _loss(name: str) -> Tuple[Callable, Callable]:
    """(loss(u, a), dloss/du(u, a)) of the named loss."""
    name = _key(name, "Quadratic")

    def sgn(a):
        return 2 * a - 1

    if name == "quadratic":
        return (lambda u, a: (u - a) ** 2,
                lambda u, a: 2.0 * (u - a))
    if name == "absolute":
        return (lambda u, a: torch.abs(u - a),
                lambda u, a: torch.sign(u - a))

    if name == "huber":
        def huber(u, a):
            d = u - a
            return torch.where(torch.abs(d) <= 1.0, 0.5 * d * d,
                               torch.abs(d) - 0.5)

        def dhuber(u, a):
            d = u - a
            return torch.where(torch.abs(d) <= 1.0, d, torch.sign(d))
        return huber, dhuber
    if name == "poisson":
        return (lambda u, a: torch.exp(u) - a * u,
                lambda u, a: torch.exp(u) - a)
    if name == "logistic":
        def dlogistic(u, a):
            e = torch.exp(-sgn(a) * u)
            return -sgn(a) * (e / (1.0 + e))
        return (lambda u, a: torch.log1p(torch.exp(-sgn(a) * u)),
                dlogistic)

    def dhinge(u, a):
        m = 1.0 - sgn(a) * u
        # jax splits a maximum's gradient in halves at a tie
        return -sgn(a) * torch.where(m > 0, 1.0, torch.where(m == 0, 0.5,
                                                             0.0))
    return (lambda u, a: torch.clamp_min(1.0 - sgn(a) * u, 0.0), dhinge)


def _prox(name: str) -> Callable:
    """The proximal operator of step * gamma * r(.) (``sg``: a 0-d
    float32 tensor on the operand's device)."""
    name = _key(name, "None")
    if name == "none":
        return lambda u, sg: u
    if name == "quadratic":
        return lambda u, sg: u / (1.0 + 2.0 * sg)
    if name == "l1":
        return lambda u, sg: torch.sign(u) * torch.clamp_min(
            torch.abs(u) - sg, 0.0)
    return lambda u, sg: torch.clamp_min(u, 0.0)


class _Problem:
    """The masked objective and the alternating step of one
    configuration on one matrix."""

    def __init__(self, A: torch.Tensor, mask: torch.Tensor, loss: str,
                 rx: str, ry: str, gx: float, gy: float):
        self.Az = torch.nan_to_num(A)
        self.mask = mask
        self.loss, self.dloss = _loss(loss)
        self.rx, self.ry = _key(rx, "None"), _key(ry, "None")
        self.prox_x, self.prox_y = _prox(rx), _prox(ry)
        dev = A.device
        self.gx = torch.tensor(gx, dtype=torch.float32, device=dev)
        self.gy = torch.tensor(gy, dtype=torch.float32, device=dev)

    def _cotangent(self, X, Y) -> torch.Tensor:
        g = self.dloss(X @ Y, self.Az)
        return torch.where(self.mask, g, torch.zeros_like(g))

    @staticmethod
    def _reg(name, gamma, M) -> torch.Tensor:
        if name == "quadratic":
            return gamma * torch.sum(M * M)
        if name == "l1":
            return gamma * torch.sum(torch.abs(M))
        return torch.zeros((), dtype=torch.float32, device=M.device)

    def objective(self, X, Y) -> float:
        lo = self.loss(X @ Y, self.Az)
        lo = torch.sum(torch.where(self.mask, lo, torch.zeros_like(lo)))
        return float(lo + self._reg(self.rx, self.gx, X) +
                     self._reg(self.ry, self.gy, Y))

    def x_step(self, X, Y, alpha: torch.Tensor) -> torch.Tensor:
        return self.prox_x(X - alpha * (self._cotangent(X, Y) @ Y.T),
                           alpha * self.gx)

    def step(self, X, Y, alpha: torch.Tensor):
        Xn = self.x_step(X, Y, alpha)
        Yn = self.prox_y(Y - alpha * (Xn.T @ self._cotangent(Xn, Y)),
                         alpha * self.gy)
        return Xn, Yn


def _observed_mask(frame: Frame, spec: Dict, dev) -> torch.Tensor:
    """(rows, expanded columns) mask of the cells backed by observed raw
    values: an NA numeric masks its column, an NA categorical code its
    one-hot columns."""
    cols = []
    lo = 0 if spec["use_all_factor_levels"] else 1
    for c, card in zip(spec["cat_names"], spec["cat_cards"]):
        ok = torch.from_numpy(frame.vec(c).data >= 0).to(dev)
        cols.extend([ok] * (card - lo))
    for c in spec["num_names"]:
        cols.append(~torch.isnan(torch.from_numpy(
            frame.vec(c).as_float()).to(dev)))
    if not cols:
        return torch.zeros((frame.nrows, 0), dtype=torch.bool, device=dev)
    return torch.stack(cols, dim=1)


class GLRMModel(Model):
    algo = "glrm"

    def _archetypes(self) -> torch.Tensor:
        return torch.from_numpy(np.asarray(self.output["archetypes"],
                                           np.float32)).to(self.device)

    def _solve_x(self, frame: Frame,
                 iters: int = GLRM_X_ITERS) -> torch.Tensor:
        """X for ``frame``'s rows with Y fixed; unobserved cells carry no
        loss."""
        out = self.output
        dev = self.device
        A = expand_for_scoring(frame, out["expansion_spec"], dev)
        Y = self._archetypes()
        prob = _Problem(A, _observed_mask(frame, out["expansion_spec"], dev),
                        out["loss"], out["regularization_x"], "None",
                        float(out["gamma_x"]), 0.0)
        alpha = torch.tensor(1.0 / max(float(torch.sum(Y * Y)), 1.0),
                             dtype=torch.float32, device=dev)
        X = torch.zeros((A.shape[0], Y.shape[0]), dtype=torch.float32,
                        device=dev)
        for _ in range(iters):
            X = prob.x_step(X, Y, alpha)
        return X

    def predict_raw(self, frame: Frame) -> torch.Tensor:
        """The reconstruction X Y of ``frame``'s expanded rows."""
        return self._solve_x(frame) @ self._archetypes()

    def predict(self, frame: Frame) -> Frame:
        """Reconstructed columns, ``reconstr_<expanded name>``."""
        recon = self.predict_raw(frame).cpu().numpy()
        names = self.output["feature_names"]
        return Frame([f"reconstr_{n}" for n in names],
                     [Vec(recon[:, j]) for j in range(len(names))])

    def transform(self, frame: Frame) -> Frame:
        """Rows in archetype space, ``Arch1..Archk``."""
        X = self._solve_x(frame).cpu().numpy()
        return Frame([f"Arch{i + 1}" for i in range(X.shape[1])],
                     [Vec(X[:, i]) for i in range(X.shape[1])])

    def model_metrics(self, frame: Frame = None) -> mm.ModelMetrics:
        out = self.output
        return mm.glrm_metrics(out["objective"], out["numerr"],
                               out["iterations"])


def glrm_from_jax_output(output: Dict, params: Dict,
                         device: DeviceLike = None) -> GLRMModel:
    """The port's ``GLRMModel`` from an ``h2o_tpu`` GLRM's output dict
    (arrays as numpy; the reference's DKV representation frame is not
    carried)."""
    out = {k: output[k] for k in ("k", "loss", "regularization_x",
                                  "regularization_y", "gamma_x", "gamma_y",
                                  "objective", "numerr", "iterations",
                                  "step_size")}
    out.update(archetypes=np.array(output["archetypes"], np.float32),
               history=list(output["history"]),
               feature_names=list(output["feature_names"]),
               expansion_spec=dict(output["expansion_spec"]),
               model_category="DimReduction")
    m = GLRMModel(dict(params), out, cloud(device))
    out["training_metrics"] = m.model_metrics()
    return m


class GLRM(ModelBuilder):
    algo = "glrm"
    model_cls = GLRMModel
    supervised = False
    supports_cv = False

    ENGINE_FIXED = {
        "multi_loss": ("Categorical",),
        "recover_svd": (False,),
        "loss": LOSSES,
        "regularization_x": REGULARIZERS,
        "regularization_y": REGULARIZERS,
        "init": ("SVD", "Random"),
        "transform": ("NONE", "STANDARDIZE"),
    }

    def default_params(self) -> Dict:
        p = super().default_params()
        p.update(k=1, loss="Quadratic", multi_loss="Categorical",
                 regularization_x="None", regularization_y="None",
                 gamma_x=0.0, gamma_y=0.0, max_iterations=500,
                 init_step_size=1.0, min_step_size=1e-4, transform="NONE",
                 init="SVD", recover_svd=False)
        return p

    def _fit(self, x: List[str], y: Optional[str], train: Frame,
             valid: Optional[Frame] = None) -> GLRMModel:
        p = self.params
        dev = self.device
        di = DataInfo(train, x, None, dev, mode="expanded",
                      standardize=(p["transform"] or "NONE").upper() ==
                      "STANDARDIZE", use_all_factor_levels=True,
                      impute_missing=False)
        A = di.matrix()
        nrows, P = A.shape
        R = statpack.padded_rows(nrows, statpack.ROW_QUANTUM)
        k = min(int(p["k"]), P)
        mask = ~torch.isnan(A)
        prob = _Problem(A, mask, p["loss"], p["regularization_x"],
                        p["regularization_y"], float(p["gamma_x"]),
                        float(p["gamma_y"]))
        key = self.rng_key()
        if _key(p["init"], "SVD") == "svd":
            A0 = prob.Az          # unobserved cells are NaN, now 0
            V, _ = randomized_range(A0, key, k, 2)
            Vd = torch.from_numpy(np.ascontiguousarray(V[:, :k])).to(dev)
            Y = Vd.T.contiguous()
            X = A0 @ Vd
        else:
            X = prng.normal(key, (R, k), dev)[:nrows] * 0.01
            Y = prng.normal(prng.split(key)[0], (k, P), dev) * 0.01
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        X = prob.prox_x(X, zero)
        Y = prob.prox_y(Y, zero)

        alpha = float(p["init_step_size"]) / max(
            1.0, float(torch.sum(mask)) / R)
        min_alpha = float(p["min_step_size"])
        obj = prob.objective(X, Y)
        history = [obj]
        it = 0
        for it in range(1, int(p["max_iterations"]) + 1):
            Xn, Yn = prob.step(X, Y, torch.tensor(
                alpha, dtype=torch.float32, device=dev))
            new_obj = prob.objective(Xn, Yn)
            if np.isfinite(new_obj) and new_obj < obj:
                X, Y, obj = Xn, Yn, new_obj
                alpha *= 1.05
                history.append(obj)
            else:
                alpha /= 2.0
                if alpha < min_alpha:
                    break
            if it % 20 == 0:
                self._update(min(0.9, it / int(p["max_iterations"])),
                             f"iter {it} objective {obj:.5g}")
            if len(history) > 2 and \
                    abs(history[-2] - history[-1]) < 1e-8 * (1 + obj):
                break

        res = torch.where(mask, (prob.Az - X @ Y) ** 2,
                          torch.zeros_like(prob.Az))
        Xh = X.cpu().numpy()
        out = dict(k=k, archetypes=Y.cpu().numpy(), loss=p["loss"],
                   regularization_x=p["regularization_x"],
                   regularization_y=p["regularization_y"],
                   gamma_x=float(p["gamma_x"]), gamma_y=float(p["gamma_y"]),
                   objective=obj, numerr=float(torch.sum(res)),
                   iterations=it, step_size=alpha, history=history,
                   feature_names=di.expanded_names,
                   expansion_spec=expansion_spec(di),
                   model_category="DimReduction")
        model = self.model_cls(dict(p), out, dev)
        xf = Frame([f"Arch{i + 1}" for i in range(k)],
                   [Vec(Xh[:, i]) for i in range(k)],
                   key=f"glrm_rep_{model.key}")
        publish(xf.key, xf)
        out.update(representation_frame=xf, representation_key=str(xf.key))
        out["training_metrics"] = model.model_metrics()
        self._update(1.0)
        return model
