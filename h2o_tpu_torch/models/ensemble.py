"""StackedEnsemble — port of ``h2o_tpu/models/ensemble.py``
(``_base_pred_columns`` :35-48, ``StackedEnsembleModel`` :51-63,
``StackedEnsemble`` :66-177).

A super learner over port models.  The level-one frame holds, per base
model in the given order, its predictions named by its ``model_id``: p1
for a binomial model, every class probability (``<id>/<level>``) for a
multinomial one, the value for a regression; then the response (and the
weights column).  In CV mode they are the base model's cross-validation
holdout predictions, the frame published under
``output["cross_validation_holdout_predictions_frame_id"]`` (train the
base models with ``keep_cross_validation_predictions=True``); in
blending mode, each base model's predictions on ``blending_frame``.
Base models may be given as port Models or as their keys in
``store.dkv()``, and ``blending_frame`` as a Frame or its key.

The metalearner trains on that frame: AUTO (and glm) is the port's GLM
with ``non_negative`` (binomial or multinomial from the base models'
response), else the named builder with ``metalearner_params``;
``metalearner_nfolds`` cross-validates it through ``_fit_cv``.  It is
published in the DKV under ``output["metalearner_key"]``, as the
reference does (``ensemble.py:154``).  The model also keeps the
metalearner and the base models themselves (``output["metalearner"]``,
``output["base_models"]``), which scoring, ``Model.save`` and the
genmodel MOJO writer read, so a saved or exported ensemble does not
depend on the DKV.  Scoring runs every base model, then the
metalearner on their predictions, on the model's device.  The honest
metrics are the metalearner's on the level-one frame:
``cross_validation_metrics`` in CV mode, else ``validation_metrics``
when no validation frame was given.  The genmodel MOJO nests the
metalearner's and base models' artifacts (``mojo/genmodel.py``).
``recovery_dir`` snapshots the build (``models/model.py``), as the
reference's does; no iteration checkpoint.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Optional

import torch

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.core.frame import Frame, Vec
from h2o_tpu_torch.core.store import dkv
from h2o_tpu_torch.models.model import Model, ModelBuilder, publish

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
    """A base model given as a Model or as its key in the DKV."""
    if isinstance(m, Model):
        return m
    mdl = dkv().get(str(m))
    if not isinstance(mdl, Model):
        raise ValueError(f"base model {m} not found in DKV")
    return mdl


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
               metalearner_key=str(output["metalearner_key"]),
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
                fid = bm.output.get(
                    "cross_validation_holdout_predictions_frame_id")
                if fid is None:
                    raise ValueError(
                        f"base model {bm.model_id} lacks CV holdout "
                        "predictions; train with "
                        "keep_cross_validation_predictions=True or pass a "
                        "blending_frame")
                pf = dkv().get(fid)
                if pf is None:
                    raise ValueError(f"CV holdout predictions {fid} of "
                                     f"base model {bm.model_id} not found "
                                     "in DKV")
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
        p = self.params
        base_models = [_resolve_model(m) for m in p["base_models"]]
        if not base_models:
            raise ValueError("StackedEnsemble requires base_models")
        blending = p.get("blending_frame")
        if isinstance(blending, str):
            fr = dkv().get(blending)
            if not isinstance(fr, Frame):
                raise ValueError(f"blending_frame {blending} not found in "
                                 "DKV")
            blending = fr
        l1 = self._level_one_frame(base_models, y, train, blending)
        self._update(0.3, "level-one frame assembled")

        builder = self._metalearner(p, base_models)
        builder.params["response_column"] = y
        x_meta = [c for c in l1.names if c != y]
        if builder.supports_cv and int(
                builder.params.get("nfolds") or 0) > 1:
            meta_model = builder._fit_cv(x_meta, y, l1, None)
        else:
            meta_model = builder._fit(x_meta, y, l1, None)
        meta_model.params["response_column"] = y
        publish(meta_model.key, meta_model)
        self._update(0.9, "metalearner trained")

        out = dict(base_models=base_models, metalearner=meta_model,
                   metalearner_key=str(meta_model.key),
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
