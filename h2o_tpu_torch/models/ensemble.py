"""StackedEnsemble — port of ``h2o_tpu/models/ensemble.py``
(``_base_pred_columns`` :35-48, ``StackedEnsembleModel`` :51-63,
``StackedEnsemble`` :66-177).

A super learner over port models.  The level-one frame holds, per base
model in the given order, its predictions named by its ``model_id``: p1
for a binomial model, every class probability (``<id>/<level>``) for a
multinomial one, the value for a regression; then the response (and the
weights column).  In CV mode they are the base model's cross-validation
holdout predictions, ``output["cross_validation_holdout_predictions_
frame"]`` (train the base models with ``keep_cross_validation_
predictions=True``; the reference reads the frame from its DKV); in
blending mode, each base model's predictions on ``blending_frame``.

The metalearner trains on that frame: AUTO (and glm) is the port's GLM
with ``non_negative`` (binomial or multinomial from the base models'
response), else the named builder with ``metalearner_params``;
``metalearner_nfolds`` cross-validates it through ``_fit_cv``.  It is
kept as ``output["metalearner"]`` and the base models as
``output["base_models"]``, the model objects themselves (the reference
keeps DKV keys: ``base_models`` given as keys, and a ``blending_frame``
given as a key, are refused until P13 brings the DKV).  Scoring runs
every base model, then the metalearner on their predictions, on the
model's device.  The honest metrics are the metalearner's on the
level-one frame: ``cross_validation_metrics`` in CV mode, else
``validation_metrics`` when no validation frame was given.  The
genmodel MOJO nests the metalearner's and base models' artifacts
(``mojo/genmodel.py``); iteration checkpoints (P14) are refused.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Optional

import torch

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.core.frame import Frame, Vec
from h2o_tpu_torch.models.model import Model, ModelBuilder

#: the metalearners: algo -> (module, builder class)
_METALEARNERS = {
    "glm": ("h2o_tpu_torch.models.glm", "GLM"),
    "gbm": ("h2o_tpu_torch.models.tree.gbm", "GBM"),
    "drf": ("h2o_tpu_torch.models.tree.drf", "DRF"),
    "xgboost": ("h2o_tpu_torch.models.tree.xgboost", "XGBoost"),
    "deeplearning": ("h2o_tpu_torch.models.deeplearning", "DeepLearning"),
    "naivebayes": ("h2o_tpu_torch.models.naive_bayes", "NaiveBayes"),
}


def _resolve_model(m) -> Model:
    if isinstance(m, Model):
        return m
    raise NotImplementedError(
        f"stackedensemble: base model {m!r} is a DKV key; pass the port "
        "Model objects (the DKV comes with P13)")


def _base_pred_columns(model: Model, raw: torch.Tensor) -> Dict[str, Vec]:
    """Level-one columns of one base model's raw predictions."""
    name = model.model_id
    raw = raw.detach().cpu().numpy()
    dom = model.output.get("response_domain")
    if dom is None:
        return {name: Vec(raw)}
    if len(dom) == 2:
        return {name: Vec(raw[:, 2])}
    return {f"{name}/{dom[k]}": Vec(raw[:, 1 + k]) for k in range(len(dom))}


def level_one_columns(base_models: List[Model],
                      frame: Frame) -> Dict[str, Vec]:
    """Every base model's level-one columns of its predictions on
    ``frame``."""
    cols: Dict[str, Vec] = {}
    for bm in base_models:
        cols.update(_base_pred_columns(bm, bm.predict_raw(frame)))
    return cols


class StackedEnsembleModel(Model):
    algo = "stackedensemble"

    def predict_raw(self, frame: Frame) -> torch.Tensor:
        """The metalearner's raw predictions on the base models'."""
        cols = level_one_columns(self.output["base_models"], frame)
        return self.output["metalearner"].predict_raw(
            Frame(list(cols), list(cols.values())))


def stackedensemble_from_jax_output(output: Dict, params: Dict,
                                    base_models: List[Model],
                                    metalearner: Model,
                                    device: DeviceLike = None
                                    ) -> StackedEnsembleModel:
    """The port's ``StackedEnsembleModel`` from an ``h2o_tpu``
    StackedEnsemble's output dict, with its base models and metalearner
    (the reference's DKV entries) converted by their own converters, in
    the reference's order.  A base model's ``model_id`` must be the
    reference's key, which names its level-one column."""
    out = dict(base_models=list(base_models), metalearner=metalearner,
               metalearner_algo=output["metalearner_algo"],
               response_domain=output.get("response_domain"),
               x=list(output["x"]))
    return StackedEnsembleModel(dict(params), out, cloud(device))


class StackedEnsemble(ModelBuilder):
    algo = "stackedensemble"
    model_cls = StackedEnsembleModel
    supports_cv = False

    def default_params(self) -> Dict:
        p = super().default_params()
        p.update(base_models=[], metalearner_algorithm="AUTO",
                 metalearner_params=None, metalearner_nfolds=0,
                 blending_frame=None)
        return p

    def _level_one_frame(self, base_models: List[Model], y: str,
                         train: Frame, blending: Optional[Frame]) -> Frame:
        if blending is not None:
            cols = level_one_columns(base_models, blending)
            src = blending
        else:
            cols = {}
            for bm in base_models:
                pf = bm.output.get(
                    "cross_validation_holdout_predictions_frame")
                if pf is None:
                    raise ValueError(
                        f"base model {bm.model_id} lacks CV holdout "
                        "predictions; train with "
                        "keep_cross_validation_predictions=True or pass a "
                        "blending_frame")
                dom = bm.output.get("response_domain")
                if dom is None:
                    cols[bm.model_id] = pf.vec("predict")
                elif len(dom) == 2:
                    cols[bm.model_id] = pf.vec(dom[1])
                else:
                    for d in dom:
                        cols[f"{bm.model_id}/{d}"] = pf.vec(d)
            src = train
        l1 = Frame(list(cols), list(cols.values()))
        l1.add(y, src.vec(y))
        wc = self.params.get("weights_column")
        if wc and wc in src:
            l1.add(wc, src.vec(wc))
        return l1

    def _metalearner(self, p: Dict, base_models: List[Model]) -> ModelBuilder:
        algo = (p.get("metalearner_algorithm") or "AUTO").lower()
        mp = dict(p.get("metalearner_params") or {})
        mp.setdefault("seed", p.get("seed", -1))
        nf = int(p.get("metalearner_nfolds") or 0)
        if nf:
            mp["nfolds"] = nf
        if algo == "auto":
            algo = "glm"
        if algo not in _METALEARNERS:
            raise ValueError(f"stackedensemble: metalearner_algorithm "
                             f"{algo!r} is not one of "
                             f"{['AUTO'] + sorted(_METALEARNERS)}")
        if algo == "glm":
            dom = base_models[0].output.get("response_domain")
            if dom is not None:
                mp.setdefault("family",
                              "binomial" if len(dom) == 2 else "multinomial")
            # the AUTO metalearner: a non-negative GLM
            mp.setdefault("non_negative", True)
        mod, name = _METALEARNERS[algo]
        return getattr(importlib.import_module(mod), name)(
            device=self.device, **mp)

    def _fit(self, x: List[str], y: str, train: Frame,
             valid: Optional[Frame] = None) -> StackedEnsembleModel:
        self.refuse_iteration_checkpoints()
        p = self.params
        base_models = [_resolve_model(m) for m in p["base_models"]]
        if not base_models:
            raise ValueError("StackedEnsemble requires base_models")
        blending = p.get("blending_frame")
        if blending is not None and not isinstance(blending, Frame):
            raise NotImplementedError(
                f"stackedensemble: blending_frame {blending!r} is a DKV "
                "key; pass a Frame (the DKV comes with P13)")
        l1 = self._level_one_frame(base_models, y, train, blending)

        builder = self._metalearner(p, base_models)
        builder.params["response_column"] = y
        x_meta = [c for c in l1.names if c != y]
        if builder.supports_cv and int(
                builder.params.get("nfolds") or 0) > 1:
            meta_model = builder._fit_cv(x_meta, y, l1, None)
        else:
            meta_model = builder._fit(x_meta, y, l1, None)
        meta_model.params["response_column"] = y

        out = dict(base_models=base_models, metalearner=meta_model,
                   metalearner_algo=builder.algo,
                   response_domain=base_models[0].output.get(
                       "response_domain"),
                   x=list(x))
        model = self.model_cls(dict(p, response_column=y), out, self.device)
        out["training_metrics"] = model.model_metrics(train)
        if valid is not None:
            out["validation_metrics"] = model.model_metrics(valid)
        # honest metrics: the metalearner on the level-one frame, whose
        # base columns are out-of-fold or out-of-sample predictions
        honest = model.metrics_from_raw(meta_model.predict_raw(l1), l1)
        if blending is None:
            out["cross_validation_metrics"] = honest
        elif "validation_metrics" not in out:
            out["validation_metrics"] = honest
        return model
