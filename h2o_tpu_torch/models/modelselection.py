"""ModelSelection — port of ``h2o_tpu/models/modelselection.py``
(``_fit_glm`` :24-27, ``_score`` :30-36, ``ModelSelectionModel`` :39-58,
``ModelSelection`` :61-150).

Every candidate subset is the port's GLM with ``lambda_=0`` and
``standardize=False`` (its data passes on the model's device, its solves
on the host), scored by R² (gaussian) or minus the logloss.  ``maxr``
(and ``maxrsweep``, ``allsubsets``, ``forward``) grows the subset one
predictor at a time, the best score winning (the first of equal ones,
in predictor order); from size 2 on ``maxr``, ``maxrsweep`` and
``allsubsets`` then try replacing each chosen predictor but the newest
with each unchosen one, taking any replacement that beats the best score
by more than 1e-10, until none does.  ``backward`` starts from every
predictor and drops the one whose removal scores best, down to
``min_predictor_number``.

The reference puts each size's best GLM in the DKV (``:87-92``); the
port keeps the model itself at ``output["best_models"][size]["model"]``,
beside its ``predictors``, ``coef`` and ``score`` (P13 brings the DKV).
``predict_raw`` raises, as the reference's does: score a size's GLM.
``p_values_threshold`` runs at 0 only; iteration checkpoints (P14) are
refused.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.core.frame import Frame
from h2o_tpu_torch.models import metrics as mm
from h2o_tpu_torch.models.glm import GLM, glm_from_jax_output
from h2o_tpu_torch.models.model import DataInfo, Model, ModelBuilder

MODES = ("maxr", "maxrsweep", "allsubsets", "forward", "backward")


def _fit_glm(x_sub: List[str], y: str, train: Frame, family: str, seed,
             device):
    glm = GLM(device=device, family=family, lambda_=0.0, standardize=False,
              seed=seed)
    return glm._fit(list(x_sub), y, train, None)


def _score(model) -> float:
    """R² for gaussian, -logloss otherwise (maxr criterion analog)."""
    tm = model.output["training_metrics"]
    r2 = tm.get("r2")
    if r2 is not None:
        return float(r2)
    return -float(tm.get("logloss") or tm.get("mse") or np.inf)


class ModelSelectionModel(Model):
    algo = "modelselection"

    def best_model_per_size(self) -> Dict[int, Dict]:
        return self.output["best_models"]

    def coef(self, predictor_size: Optional[int] = None) -> Dict:
        best = self.output["best_models"]
        size = predictor_size or max(best)
        return best[size]["coef"]

    def predict_raw(self, frame: Frame):
        raise NotImplementedError(
            "score the per-size GLMs: output['best_models'][size]['model']")

    def model_metrics(self, frame: Frame = None) -> mm.ModelMetrics:
        return mm.modelselection_metrics(self.output["mode"],
                                         self.output["best_models"])


def modelselection_from_jax_output(output: Dict, params: Dict,
                                   glm_outputs: Dict[int, Dict],
                                   device: DeviceLike = None
                                   ) -> ModelSelectionModel:
    """The port's ``ModelSelectionModel`` from an ``h2o_tpu``
    ModelSelection's output dict; ``glm_outputs`` maps each size to the
    output dict (arrays as numpy) of the GLM the reference put in its
    DKV, converted by ``glm_from_jax_output``."""
    dev = cloud(device)
    y = params.get("response_column")
    best = {}
    for size, rec in output["best_models"].items():
        m = glm_from_jax_output(glm_outputs[size], dict(
            params, response_column=y), dev)
        best[int(size)] = dict(predictors=list(rec["predictors"]), model=m,
                               coef=dict(rec["coef"]),
                               score=float(rec["score"]))
    out = dict(mode=output["mode"], best_models=best,
               family=output["family"], x=list(output["x"]))
    model = ModelSelectionModel(dict(params), out, dev)
    out["training_metrics"] = model.model_metrics()
    return model


class ModelSelection(ModelBuilder):
    algo = "modelselection"
    model_cls = ModelSelectionModel
    supports_cv = False

    ENGINE_FIXED = {"p_values_threshold": (0.0,), "mode": MODES}

    def default_params(self) -> Dict:
        p = super().default_params()
        p.update(mode="maxr", max_predictor_number=1,
                 min_predictor_number=1, family="AUTO", p_values_threshold=0.0)
        return p

    def _fit(self, x: List[str], y: str, train: Frame,
             valid: Optional[Frame] = None) -> ModelSelectionModel:
        self.refuse_iteration_checkpoints()
        p = self.params
        dev = self.device
        di = DataInfo(train, x, y, dev, mode="tree")
        family = p.get("family", "AUTO")
        if family in (None, "AUTO"):
            family = "binomial" if di.nclasses == 2 else "gaussian"
        mode = (p.get("mode") or "maxr").lower()
        preds = list(di.x)
        max_k = min(int(p["max_predictor_number"]), len(preds))
        seed = p.get("seed", -1)
        fits = [0]

        def fit(sub):
            fits[0] += 1
            return _fit_glm(sub, y, train, family, seed, dev)

        best_models: Dict[int, Dict] = {}

        def record(size: int, subset: List[str], m) -> None:
            best_models[size] = dict(predictors=list(subset), model=m,
                                     coef=m.coef(), score=_score(m))

        if mode != "backward":
            # greedy forward growth; maxr also tries replacing each
            # chosen predictor (sequential replacement)
            chosen: List[str] = []
            for size in range(1, max_k + 1):
                self._update(size / (max_k + 1.0),
                             f"{mode}: best subset of size {size}")
                cands = [c for c in preds if c not in chosen]
                if not cands:
                    break
                scored = []
                for c in cands:
                    m = fit(chosen + [c])
                    scored.append((_score(m), c, m))
                scored.sort(key=lambda t: -t[0])
                _, add, m_best = scored[0]
                chosen.append(add)
                if mode in ("maxr", "maxrsweep", "allsubsets") and size > 1:
                    improved = True
                    while improved:
                        improved = False
                        for i in range(len(chosen) - 1):
                            for c in [c for c in preds if c not in chosen]:
                                trial = chosen[:i] + [c] + chosen[i + 1:]
                                m_t = fit(trial)
                                if _score(m_t) > _score(m_best) + 1e-10:
                                    chosen = trial
                                    m_best = m_t
                                    improved = True
                record(size, chosen, m_best)
        else:
            chosen = list(preds)
            record(len(chosen), chosen, fit(chosen))
            while len(chosen) > max(int(p["min_predictor_number"]), 1):
                self._update(1 - len(chosen) / (len(preds) + 1.0),
                             f"backward: {len(chosen) - 1} predictors")
                scored = []
                for c in chosen:
                    sub = [q for q in chosen if q != c]
                    m_s = fit(sub)
                    scored.append((_score(m_s), c, m_s))
                scored.sort(key=lambda t: -t[0])
                _, drop, m_best = scored[0]
                chosen.remove(drop)
                record(len(chosen), chosen, m_best)

        out = dict(mode=mode, best_models=best_models, family=family,
                   x=list(di.x), glm_fits=fits[0])
        model = self.model_cls(dict(p, response_column=y), out, dev)
        out["training_metrics"] = model.model_metrics()
        return model
