"""Model / ModelBuilder lifecycle — port of ``h2o_tpu/models/model.py``
(``DataInfo`` :34-106 in tree mode, ``_raw_to_frame`` :156-166,
``Model`` :169-380 with ``metrics_from_raw`` :270-303 and ``save``/``load``
:338-380, ``ModelBuilder`` :383-696 with ``_validate_fixed`` :397-416,
``train`` :447-470, ``_fold_assignment`` :545-572, ``_fit_cv`` :574-666,
``checkpoint_model`` :668-679 and ``rng_key`` :691-696).

The reference runs a build as an asynchronous Job that stores the model
and its cross-validation artifacts in the DKV under keys; the port has
no DKV: it trains synchronously, returns the model, and keeps the fold
models, the holdout predictions frame and the fold assignment frame on
``model.output`` itself (``cross_validation_models``,
``cross_validation_holdout_predictions_frame``,
``cross_validation_fold_assignment_frame``).  A ``checkpoint`` is a port
``Model`` or the path of a file ``Model.save`` wrote.  Frames hold no
padded rows, so the holdout predictions need no padding either.
"""

from __future__ import annotations

import copy
import importlib
import json
import os
import pickle
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models import metrics as mm
from h2o_tpu_torch.models.distributions import (Distribution,
                                                distribution_from_params)
from h2o_tpu_torch.ops import prng


class DataInfo:
    """Tree-mode feature extraction (reference hex/DataInfo.java):
    categoricals stay integer codes, NAs stay NaN, constant columns are
    dropped (``ignore_const_cols``, ``model.py:58-69``), and the
    response, weights and offset columns are never features."""

    def __init__(self, frame: Frame, x: Sequence[str], y: Optional[str],
                 device: torch.device, weights: Optional[str] = None,
                 offset: Optional[str] = None):
        self.frame = frame
        self.device = device
        self.response_name = y
        self.weights_name = weights
        self.offset_name = offset
        self.x = [c for c in x if c not in (y, weights, offset)
                  and not frame.vec(c).is_constant()]
        self.cat_names = [c for c in self.x if frame.vec(c).is_categorical]

    def response(self) -> torch.Tensor:
        """float32 response on the device; NaN where missing."""
        return torch.from_numpy(
            self.frame.vec(self.response_name).as_float()).to(self.device)

    @property
    def response_domain(self) -> Optional[List[str]]:
        return self.frame.vec(self.response_name).domain

    @property
    def nclasses(self) -> int:
        d = self.response_domain
        return len(d) if d else 1

    def weights(self) -> torch.Tensor:
        """float32 row weights on the device (ones without a weights
        column)."""
        if self.weights_name:
            return torch.from_numpy(
                self.frame.vec(self.weights_name).as_float()).to(self.device)
        return torch.ones(self.frame.nrows, dtype=torch.float32,
                          device=self.device)

    def offset(self) -> Optional[torch.Tensor]:
        """float32 link-scale offsets on the device, or None."""
        if not self.offset_name:
            return None
        return torch.from_numpy(
            self.frame.vec(self.offset_name).as_float()).to(self.device)

    def valid_mask(self) -> torch.Tensor:
        """Rows usable for training: response present."""
        return ~torch.isnan(self.response())

    def matrix(self) -> torch.Tensor:
        return self.frame.as_matrix(self.x, self.device)


def _raw_to_frame(raw, dom: Optional[List[str]]) -> Frame:
    """raw predictions (a tensor or an array) -> prediction Frame
    ([predict, p0..pK-1])."""
    raw = raw.detach().cpu().numpy() if torch.is_tensor(raw) \
        else np.asarray(raw)
    if dom is None:
        return Frame(["predict"], [Vec(raw)])
    vecs = [Vec(raw[:, 0].astype(np.int32), T_CAT, domain=list(dom))]
    vecs += [Vec(raw[:, 1 + k]) for k in range(len(dom))]
    return Frame(["predict"] + list(dom), vecs)


class Model:
    """A trained model: params + output, scoring capable."""

    algo = "base"

    def __init__(self, params: Dict[str, Any], output: Dict[str, Any],
                 device: torch.device):
        self.params = params
        self.output = output
        self.device = device

    def predict_raw(self, frame: Frame) -> torch.Tensor:
        """(rows,) regression values or (rows, 1+K) [label, p0..] on
        the model's device."""
        raise NotImplementedError

    def predict(self, frame: Frame) -> Frame:
        return _raw_to_frame(self.predict_raw(frame),
                             self.output.get("response_domain"))

    def model_metrics(self, frame: Frame) -> mm.ModelMetrics:
        return self.metrics_from_raw(self.predict_raw(frame), frame)

    def family(self) -> Optional[Distribution]:
        """The distribution the model was fitted under: its resolved name
        with the params' family parameters; None for a model without one
        (DRF)."""
        name = self.output.get("distribution_resolved")
        return None if name is None else \
            distribution_from_params(name, self.params)

    def metrics_from_raw(self, raw: torch.Tensor, frame: Frame,
                         w: Optional[torch.Tensor] = None
                         ) -> mm.ModelMetrics:
        """Metrics of raw predictions against ``frame``'s response,
        weighted by ``w``, else by the weights column where the frame
        has it; a regression's deviance is its distribution's (gaussian
        and DRF: plain regression metrics)."""
        p = self.params
        yv = frame.vec(p["response_column"])
        y = torch.from_numpy(yv.as_float()).to(raw.device)
        wc = p.get("weights_column")
        if w is None and wc and wc in frame.names:
            w = torch.from_numpy(frame.vec(wc).as_float()).to(raw.device)
        dom = self.output.get("response_domain")
        if dom is None:
            dist = self.family()
            if dist is not None and dist.name == "gaussian":
                dist = None
            return mm.regression_metrics(raw, y, w=w, distribution=dist)
        if len(dom) == 2:
            return mm.binomial_metrics(raw[:, 2], y, w=w, domain=dom)
        return mm.multinomial_metrics(raw[:, 1:], y, w=w, domain=dom)


    # -- persistence: a versioned envelope (magic, format version, JSON
    # descriptor) before a pickle of params and output, whose arrays the
    # builders keep on the host.  Like the reference's binary models, the
    # payload is a trusted artifact of this framework: load only files
    # you wrote.

    BIN_MAGIC = b"H2OTPUBIN\x00"
    BIN_VERSION = 1

    def save(self, path: str) -> str:
        from h2o_tpu_torch import __version__
        blob = {"algo": self.algo, "key": None, "params": self.params,
                "output": self.output}
        desc = json.dumps({"format_version": self.BIN_VERSION,
                           "framework": "h2o-tpu-torch",
                           "framework_version": __version__,
                           "algo": self.algo}).encode()
        with open(path, "wb") as f:
            f.write(self.BIN_MAGIC)
            f.write(self.BIN_VERSION.to_bytes(2, "little"))
            f.write(len(desc).to_bytes(4, "little"))
            f.write(desc)
            pickle.dump(blob, f)
        return path

    @staticmethod
    def load(path: str, device: DeviceLike = None) -> "Model":
        """The model a ``save`` wrote, scoring on ``device`` (``cuda:0``
        by default)."""
        with open(path, "rb") as f:
            if f.read(len(Model.BIN_MAGIC)) != Model.BIN_MAGIC:
                raise ValueError(f"{path} is not a saved h2o_tpu_torch model")
            version = int.from_bytes(f.read(2), "little")
            if version > Model.BIN_VERSION:
                raise ValueError(
                    f"model file {path} has format version {version}; "
                    f"this build reads <= {Model.BIN_VERSION}")
            desc = json.loads(f.read(int.from_bytes(f.read(4), "little")))
            if desc.get("framework") != "h2o-tpu-torch":
                raise ValueError(f"{path} was written by "
                                 f"{desc.get('framework')!r}, not by "
                                 "h2o-tpu-torch")
            blob = pickle.load(f)
        mod, name = _MODEL_CLASSES[blob["algo"]]
        cls = getattr(importlib.import_module(mod), name)
        return cls(blob["params"], blob["output"], cloud(device))


#: saved algo -> (module, class) of the model that loads it
_MODEL_CLASSES = {
    "gbm": ("h2o_tpu_torch.models.tree.gbm", "GBMModel"),
    "drf": ("h2o_tpu_torch.models.tree.drf", "DRFModel"),
    "xgboost": ("h2o_tpu_torch.models.tree.xgboost", "XGBoostModel"),
    "dt": ("h2o_tpu_torch.models.tree.dt", "DTModel"),
    "isolationforest": ("h2o_tpu_torch.models.tree.isofor",
                        "IsolationForestModel"),
    "extendedisolationforest": ("h2o_tpu_torch.models.tree.isofor",
                                "ExtendedIsolationForestModel"),
    "upliftdrf": ("h2o_tpu_torch.models.tree.uplift", "UpliftDRFModel"),
}


class ModelBuilder:
    """Train lifecycle: params -> validate -> ``_fit`` -> Model."""

    algo = "base"
    model_cls = Model
    #: False for the anomaly builders, which train without a response
    supervised = True
    #: False where fold metrics do not apply (anomaly and uplift models):
    #: nfolds or a fold_column then raises
    supports_cv = True
    #: params the engine runs at given values only (param -> accepted
    #: values; strings compare case-insensitively with -_ collapsed):
    #: anything else raises instead of being ignored
    ENGINE_FIXED: Dict[str, tuple] = {}

    def __init__(self, device: DeviceLike = None, **params):
        self.params = self.default_params()
        unknown = set(params) - set(self.params)
        if unknown:
            raise ValueError(f"{self.algo}: unknown params {sorted(unknown)}")
        self._validate_fixed(params)
        self.params.update(params)
        self.device = cloud(device)

    @staticmethod
    def _norm(v):
        if isinstance(v, str):
            return v.lower().replace("_", "").replace("-", "")
        return v

    def _validate_fixed(self, user_params: Dict) -> None:
        for k, accepted in self.ENGINE_FIXED.items():
            if k not in user_params:
                continue
            v = self._norm(user_params[k])
            if not any(v == self._norm(a) for a in accepted):
                raise ValueError(
                    f"{self.algo}: param '{k}'={user_params[k]!r} is not "
                    f"supported by this engine (accepted: "
                    f"{sorted(map(str, accepted))}); refusing to train "
                    "with a silently-ignored setting")

    def default_params(self) -> Dict[str, Any]:
        return dict(response_column=None, ignored_columns=None,
                    weights_column=None, offset_column=None, seed=-1,
                    max_runtime_secs=0.0, distribution="auto",
                    tweedie_power=1.5, quantile_alpha=0.5, huber_alpha=0.9,
                    nfolds=0, fold_assignment="AUTO", fold_column=None,
                    keep_cross_validation_models=True,
                    keep_cross_validation_predictions=False,
                    keep_cross_validation_fold_assignment=False,
                    checkpoint=None, custom_metric_func=None,
                    recovery_dir=None, checkpoint_interval=0)

    def train(self, x: Optional[Sequence[str]] = None,
              y: Optional[str] = None, training_frame: Frame = None,
              validation_frame: Optional[Frame] = None) -> Model:
        """Train on ``training_frame``; ``validation_frame``, when given,
        is scored as the model trains (early stopping watches it) and
        gives ``validation_metrics``.  ``nfolds`` > 1 or a
        ``fold_column`` cross-validates first."""
        if training_frame is None:
            raise ValueError("training_frame is required")
        y = y or self.params.get("response_column")
        if self.supervised:
            if not y:
                raise ValueError(f"{self.algo} requires a response column")
            self.params["response_column"] = y
        ignored = set(self.params.get("ignored_columns") or ())
        if self.params.get("fold_column"):
            ignored.add(self.params["fold_column"])
        x = [c for c in (x or training_frame.names)
             if c != y and c not in ignored]
        if int(self.params.get("nfolds") or 0) > 1 or \
                self.params.get("fold_column"):
            if not self.supports_cv:
                raise ValueError(f"{self.algo}: n-fold cross-validation is "
                                 "not supported by this builder")
            return self._fit_cv(x, y, training_frame, validation_frame)
        return self._fit(x, y, training_frame, validation_frame)

    def _fit(self, x: List[str], y: str, train: Frame,
             valid: Optional[Frame] = None) -> Model:
        raise NotImplementedError

    # -- n-fold cross-validation (reference hex/ModelBuilder.java:535-690):
    # fold models trained with zero-weight holdout rows, their combined
    # holdout predictions scored once, the early-stopped tree count
    # carried to the main model, then the main model on every row.

    def _fold_assignment(self, train: Frame, y: Optional[str]) -> np.ndarray:
        """Each row's fold: the fold column's values remapped to 0..n-1
        (an NA raises), or ``nfolds`` folds by Modulo, Stratified (per
        class, shuffled) or AUTO/Random (uniform draws), the draws from
        ``default_rng(seed)``."""
        p = self.params
        nrows = train.nrows
        if p.get("fold_column"):
            fv = train.vec(p["fold_column"])
            vals = fv.as_float().astype(np.float64)
            if np.isnan(vals).any():
                raise ValueError("fold_column contains missing values")
            _, codes = np.unique(vals, return_inverse=True)
            return codes
        n = int(p["nfolds"])
        scheme = (p.get("fold_assignment") or "AUTO").lower()
        seed = int(p.get("seed") or -1)
        rng = np.random.default_rng(seed if seed >= 0 else None)
        if scheme == "modulo":
            return np.arange(nrows) % n
        if scheme == "stratified" and y and train.vec(y).is_categorical:
            yv = train.vec(y).data
            fold = np.zeros(nrows, np.int64)
            for k in np.unique(yv):
                idx = np.flatnonzero(yv == k)
                rng.shuffle(idx)
                fold[idx] = np.arange(len(idx)) % n
            return fold
        return rng.integers(0, n, nrows)

    def _fit_cv(self, x: List[str], y: str, train: Frame,
                valid: Optional[Frame]) -> Model:
        p = self.params
        fold = self._fold_assignment(train, y)
        nfolds = int(fold.max()) + 1
        user_w = train.vec(p["weights_column"]).as_float() \
            if p.get("weights_column") else np.ones(train.nrows, np.float32)

        cv_models, raw_combined = [], None
        for i in range(nfolds):
            hold = fold == i
            w_i = np.where(hold, 0.0, user_w).astype(np.float32)
            wname = f"__cv_weights_{i}"
            fr_i = Frame(train.names + [wname], train.vecs + [Vec(w_i)])
            # the holdout rows are the fold model's validation frame, so
            # early stopping watches out-of-fold metrics
            fr_hold = train.slice_rows(hold)
            fr_hold.add(wname, Vec(user_w[hold]))
            sub = copy.copy(self)
            sub.params = dict(p, nfolds=0, fold_column=None,
                              weights_column=wname, checkpoint=None,
                              recovery_dir=None)
            m_i = sub._fit(x, y, fr_i, fr_hold)
            cv_models.append(m_i)
            raw_i = m_i.predict_raw(train).cpu().numpy()
            if raw_combined is None:
                raw_combined = np.zeros_like(raw_i)
            raw_combined = np.where(hold[:, None] if raw_i.ndim == 2
                                    else hold, raw_i, raw_combined)

        # optimal-parameter transfer: the tree count early stopping found
        if int(p.get("stopping_rounds") or 0) > 0 and \
                all("ntrees_actual" in m.output for m in cv_models):
            p = dict(p)
            p["ntrees"] = max(1, int(round(np.mean(
                [m.output["ntrees_actual"] for m in cv_models]))))
            p["stopping_rounds"] = 0
            self.params = p

        model = self._fit(x, y, train, valid)
        raw_t = torch.from_numpy(raw_combined).to(self.device)
        cvm = model.metrics_from_raw(raw_t, train)
        fold_mms = [model.metrics_from_raw(raw_t, train, w=torch.from_numpy(
            np.where(fold == i, user_w, 0.0).astype(np.float32)).to(
                self.device)) for i in range(nfolds)]
        summary: Dict[str, Any] = {}
        for k, v in fold_mms[0].data.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                vals = [float(m.data[k]) for m in fold_mms
                        if isinstance(m.data.get(k), (int, float))]
                if vals:
                    summary[k] = dict(mean=float(np.mean(vals)),
                                      sd=float(np.std(vals)), values=vals)
        model.output["cross_validation_metrics"] = cvm
        model.output["cross_validation_metrics_summary"] = summary
        if p.get("keep_cross_validation_models", True):
            model.output["cross_validation_models"] = cv_models
        if p.get("keep_cross_validation_predictions"):
            model.output["cross_validation_holdout_predictions_frame"] = \
                _raw_to_frame(raw_combined,
                              model.output.get("response_domain"))
        if p.get("keep_cross_validation_fold_assignment"):
            model.output["cross_validation_fold_assignment_frame"] = Frame(
                ["fold_assignment"], [Vec(fold.astype(np.float32))])
        return model

    def checkpoint_model(self) -> Optional[Model]:
        """The ``checkpoint`` param as a Model: a port model as given, or
        one loaded from the path ``Model.save`` wrote, on this builder's
        device."""
        ck = self.params.get("checkpoint")
        if not ck:
            return None
        if isinstance(ck, Model):
            return ck
        if not os.path.isfile(str(ck)):
            raise ValueError(f"checkpoint model {ck} not found")
        return Model.load(str(ck), self.device)

    def rng_key(self) -> np.ndarray:
        """The forest's master key from ``seed``; a seed < 0 draws one
        from the OS's entropy."""
        seed = self.params.get("seed")
        seed = int(seed) if seed is not None else -1
        if seed < 0:
            seed = np.random.SeedSequence().entropy % (2 ** 31)
        return prng.key(seed)

    def resolve_distribution(self, di: DataInfo) -> str:
        d = self.params.get("distribution", "auto")
        if d and d != "auto":
            return d
        if di.nclasses == 2:
            return "bernoulli"
        if di.nclasses > 2:
            return "multinomial"
        return "gaussian"
