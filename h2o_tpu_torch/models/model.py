"""Model / ModelBuilder lifecycle — port of ``h2o_tpu/models/model.py``
(``DataInfo`` :34-153 in tree and expanded modes, ``_raw_to_frame``
:156-166, ``Model`` :169-380 with the explain options :229-265,
``metrics_from_raw`` :270-303, ``varimp`` :303 and ``save``/``load``
:338-380, ``ModelBuilder`` :383-696 with ``_validate_fixed`` :397-416,
``train``/``train_async`` :447-532, ``_fold_assignment`` :545-572,
``_fit_cv`` :574-664, ``checkpoint_model`` :668-679 and ``rng_key``
:691-696).

A build runs as a job of the process-wide registry (``core/job.py``
:func:`jobs`): ``train_async`` pins the model key (``model_id``, else
``<algo>_<hex>``), starts a job whose ``dest`` is that key and returns
it; ``train`` joins it.  The body runs on a pool thread with the
builder's CUDA device current, fits (cross-validating first with
``nfolds`` or a ``fold_column``), attaches a ``custom_metric_func``
(``core/udf.py``) to the training and validation metrics, and publishes
the model in ``store.dkv()`` under its key, with what ``publish`` held
back for it (fold models, a builder's output frames), unless the job
was stopped after its last report.  A body that raises makes
the job FAILED and ``train`` re-raises it; nothing is retried on
another device.  Cross-validation publishes, as the reference does, the
fold models as ``{model_id}_cv_{i}``, the holdout predictions as
``cv_holdout_prediction_{model_id}`` and the fold assignment as
``cv_fold_assignment_{model_id}``, and ``model.output`` holds their keys
(``cross_validation_models``,
``cross_validation_holdout_predictions_frame_id``,
``cross_validation_fold_assignment_frame_id``).  A ``checkpoint`` is a
port ``Model``, the key of one in the DKV, or the path of a file
``Model.save`` wrote.  Frames hold no padded rows, so the holdout
predictions need no padding either.

With ``recovery_dir`` (reference ``:437-443``, ``:477-490``, ``:525``),
``train_async`` snapshots the params and the training frame before the
build (``core/recovery.py`` ``Recovery.begin``, unless the builder is
resuming one) and the body deletes the snapshot after a successful
build; the builder's ``_recovery`` is what the GBM, DRF, GLM and
DeepLearning drivers write their iteration checkpoints to, every
``checkpoint_interval`` units (trees for the tree drivers; 0 = the
driver's default).  Fold models build without it, and so does a build
without a training frame (Generic's import, whose reference builder
never snapshots; Grep over a file).
"""

from __future__ import annotations

import contextlib
import copy
import importlib
import json
import os
import pickle
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.core.frame import T_CAT, T_STR, T_UUID, Frame, Vec
from h2o_tpu_torch.core.job import Job, JobCancelledException, jobs
from h2o_tpu_torch.core.store import Key, dkv
from h2o_tpu_torch.models import metrics as mm
from h2o_tpu_torch.models.distributions import (Distribution,
                                                distribution_from_params)
from h2o_tpu_torch.ops import prng


class DataInfo:
    """Feature extraction (reference hex/DataInfo.java:23,112-115).
    String and uuid columns and constant columns are dropped
    (``ignore_const_cols``, ``model.py:58-69``: a categorical with at
    most one level, a numeric with rollup sigma 0), and the response,
    weights and offset columns are never features.  Two modes:

    - ``"tree"``: categoricals stay integer codes, time columns are
      numeric features (their float32 milliseconds), NAs stay NaN;
    - ``"expanded"`` (GLM): categoricals first, one-hot from level 1 (from
      level 0 with ``use_all_factor_levels``), an NA code one-hot to all
      zeros; then the numerics, NaN imputed with the rollup mean
      (``impute_missing``) and standardized by the rollup mean and sigma
      (``standardize``).  ``expanded_names`` names the columns.

    The matrix lives on ``device``."""

    def __init__(self, frame: Frame, x: Sequence[str], y: Optional[str],
                 device: torch.device, weights: Optional[str] = None,
                 offset: Optional[str] = None, mode: str = "tree",
                 standardize: bool = False,
                 use_all_factor_levels: bool = False,
                 impute_missing: bool = False):
        if mode not in ("tree", "expanded"):
            raise ValueError(f"unknown DataInfo mode {mode!r}")
        self.frame = frame
        self.device = device
        self.mode = mode
        self.response_name = y
        self.weights_name = weights
        self.offset_name = offset
        self.x = [c for c in x if c not in (y, weights, offset)
                  and frame.vec(c).type not in (T_STR, T_UUID)
                  and not frame.vec(c).is_constant()]
        self.cat_names = [c for c in self.x if frame.vec(c).is_categorical]
        self.num_names = [c for c in self.x
                          if not frame.vec(c).is_categorical]
        self.standardize = standardize
        self.use_all_factor_levels = use_all_factor_levels
        self.impute_missing = impute_missing
        self._matrix: Optional[torch.Tensor] = None
        self._names_expanded: Optional[List[str]] = None

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
        """The feature matrix on the device (built once in expanded
        mode)."""
        if self.mode == "tree":
            return self.frame.as_matrix(self.x, self.device)
        if self._matrix is None:
            names = []
            for c in self.cat_names:
                v = self.frame.vec(c)
                lo = 0 if self.use_all_factor_levels else 1
                names += [f"{c}.{v.domain[k]}" for k in range(lo,
                                                               v.cardinality)]
            names += self.num_names
            self._matrix = expand_columns(
                self.frame, self.cat_names,
                [self.frame.vec(c).cardinality for c in self.cat_names],
                self.num_names,
                [self.frame.vec(c).rollups.mean for c in self.num_names],
                [self.frame.vec(c).rollups.sigma for c in self.num_names],
                self.standardize, self.use_all_factor_levels, self.device,
                impute=self.impute_missing)
            self._names_expanded = names
        return self._matrix

    @property
    def expanded_names(self) -> List[str]:
        if self.mode == "tree":
            return list(self.x)
        if self._names_expanded is None:
            self.matrix()
        return self._names_expanded


def expand_columns(frame: Frame, cat_names: Sequence[str],
                   cat_cards: Sequence[int], num_names: Sequence[str],
                   means: Sequence[float], sigmas: Sequence[float],
                   standardize: bool, use_all_factor_levels: bool,
                   device: torch.device, impute: bool = True
                   ) -> torch.Tensor:
    """The expanded float32 matrix of ``frame`` on ``device``: each
    categorical's codes one-hot over levels 1..card-1 (0..card-1 with
    ``use_all_factor_levels``; an NA code and a code outside the domain
    one-hot to all zeros), then each numeric with NaN replaced by its
    mean (``impute``) and, with ``standardize``, (x - mean) / sigma (a
    sigma of 0 divides by 1).  DataInfo's expansion and the scoring
    expansion of a trained model (``glm.expand_for_scoring``) are this
    one function, so training and scoring rows expand alike."""
    cols = []
    lo = 0 if use_all_factor_levels else 1
    for c, card in zip(cat_names, cat_cards):
        codes = torch.from_numpy(frame.vec(c).data).to(device)
        levels = torch.arange(lo, card, dtype=codes.dtype, device=device)
        cols.append((codes[:, None] == levels[None, :]).to(torch.float32))
    for c, mean, sigma in zip(num_names, means, sigmas):
        d = torch.from_numpy(frame.vec(c).as_float()).to(device)
        cols.append(expand_numeric(d, mean, sigma, standardize, impute)[:,
                                                                         None])
    if not cols:
        return torch.zeros((frame.nrows, 0), dtype=torch.float32,
                           device=device)
    return torch.cat(cols, dim=1)


def expand_numeric(d: torch.Tensor, mean: float, sigma: float,
                   standardize: bool, impute: bool = True) -> torch.Tensor:
    """One numeric column as the expansion writes it: NaN -> mean, then
    (d - mean) / (sigma or 1).  The divisor is a float32 tensor, not a
    Python number: a CUDA tensor divided by a number is multiplied by
    the number's float32 reciprocal, which the CPU does not do."""
    if impute:
        d = torch.nan_to_num(d, nan=float(np.float32(mean)))
    if standardize:
        m = torch.full_like(d, float(np.float32(mean)))
        sd = torch.full_like(d, float(np.float32(sigma or 1.0)))
        d = (d - m) / sd
    return d


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
    #: the wall of the build that made it (``train``), as the reference's
    run_time_ms = 0

    def __init__(self, params: Dict[str, Any], output: Dict[str, Any],
                 device: torch.device):
        self.params = params
        self.output = output
        self.device = device
        # the reference's model key: the builder's ``model_id``, else
        # the algo and a random suffix; kept in params, so saved with them
        if not params.get("model_id"):
            params["model_id"] = f"{self.algo}_{uuid.uuid4().hex[:12]}"

    @property
    def model_id(self) -> str:
        return str(self.params["model_id"])

    @property
    def key(self) -> Key:
        """The model's DKV key (its ``model_id``)."""
        return Key(self.model_id)

    def predict_raw(self, frame: Frame) -> torch.Tensor:
        """(rows,) regression values or (rows, 1+K) [label, p0..] on
        the model's device."""
        raise NotImplementedError

    def predict(self, frame: Frame) -> Frame:
        return _raw_to_frame(self.predict_raw(frame),
                             self.output.get("response_domain"))

    def model_metrics(self, frame: Frame) -> mm.ModelMetrics:
        return self.metrics_from_raw(self.predict_raw(frame), frame)

    # -- online fast path (serve/engine.py) ---------------------------------

    def predict_raw_array(self, X) -> torch.Tensor:
        """Predictions on the model's device over a raw (rows,
        len(output['x'])) matrix of column values in training order
        (categoricals as domain codes, NAs as NaN) — no Frame, so the
        serving engine can call it per batch bucket.  Families with a
        device scoring path override this (GBM/DRF/XGBoost/GLM);
        ``predict_raw(frame)`` delegates to it where possible."""
        raise NotImplementedError(
            f"{self.algo} has no device array-predict fast path")

    # -- device constants (the arrays a device predict reads) --------------

    _dev_lock = threading.Lock()

    def device_const(self, name: str, srcs: tuple, make: Callable):
        """``make(*srcs)`` — tensors of host arrays in ``output`` on the
        model's device — uploaded once and kept in a cache the model
        owns.  Every device predict reads its constants here, so
        ``predict_raw``, ``predict_raw_array`` and the serving engine's
        graphs compute the same bits, and a capture (which may not copy
        from host memory) finds them uploaded.  An entry is valid while
        ``srcs`` are the same objects and the model's device the same:
        replacing an output array uploads it again."""
        with Model._dev_lock:
            cache = self.__dict__.setdefault("_dev_consts", {})
            ent = cache.get(name)
        if ent is not None and ent[1] == self.device and \
                len(ent[0]) == len(srcs) and \
                all(a is b for a, b in zip(ent[0], srcs)):
            return ent[2]
        val = make(*srcs)
        with Model._dev_lock:
            self.__dict__.setdefault("_dev_consts", {})[name] = (
                srcs, self.device, val)
        return val

    def device_consts(self) -> list:
        """What the cache holds now (a captured graph keeps it alive)."""
        with Model._dev_lock:
            return [e[2] for e in self.__dict__.get("_dev_consts",
                                                    {}).values()]

    def clear_device_consts(self) -> None:
        """Drop the cache (a retrain or a checkpoint resume)."""
        with Model._dev_lock:
            self.__dict__.pop("_dev_consts", None)

    def has_device_predict(self) -> bool:
        """Whether the model's family overrides ``predict_raw_array``
        (decided by type, so a failure inside a device predict raises
        instead of moving the model to the host scorer)."""
        return type(self).predict_raw_array is not Model.predict_raw_array

    def predict_array(self, X: np.ndarray) -> np.ndarray:
        """Online scoring entry: raw ndarray in, raw predictions out as
        numpy.  Uses the device fast path when the model family
        implements one, else the pure-NumPy MOJO scorer over the same
        flattened artifact arrays."""
        X = np.asarray(X)
        if self.has_device_predict():
            return self.predict_raw_array(torch.as_tensor(
                X, dtype=torch.float32, device=self.device)).cpu().numpy()
        from h2o_tpu_torch.mojo import _flatten_arrays, scorers
        fn = getattr(scorers, f"score_{self.algo}", None)
        if fn is None:
            raise NotImplementedError(
                f"{self.algo} has neither a device predict_raw_array "
                "nor a standalone numpy scorer")
        arrays, meta = _flatten_arrays(self.output)
        return np.asarray(fn(arrays, meta, np.asarray(X, np.float64)))

    # -- the tree family's explain options (hex/Model.java scoring
    # flags); binning and staged values on the model's device, TreeSHAP
    # and leaf assignment in the host library (models/tree/contributions)

    def _require_forest(self, what: str) -> None:
        if self.output.get("split_col") is None:
            raise NotImplementedError(
                f"{what} is only supported for tree-based models "
                f"(this model is {self.algo})")

    def predict_contributions(self, frame: Frame, top_n: int = 0,
                              bottom_n: int = 0, compare_abs: bool = False,
                              output_format: str = "Original") -> Frame:
        """TreeSHAP feature contributions and BiasTerm
        (SharedTreeModelWithContributions.scoreContributions); with
        ``top_n``/``bottom_n``, each row's largest and smallest ones."""
        self._require_forest("predict_contributions")
        from h2o_tpu_torch.models.tree.contributions import \
            contributions_frame
        return contributions_frame(self, frame, top_n=top_n,
                                   bottom_n=bottom_n,
                                   compare_abs=compare_abs,
                                   output_format=output_format)

    def predict_leaf_node_assignment(self, frame: Frame,
                                     assign_type: str = "Path") -> Frame:
        """Terminal node per tree, as a path ("Path") or a node id
        ("Node_ID") (hex/tree/AssignLeafNodeTask)."""
        self._require_forest("predict_leaf_node_assignment")
        from h2o_tpu_torch.models.tree.contributions import \
            leaf_assignment_frame
        return leaf_assignment_frame(self, frame, assign_type=assign_type)

    def staged_predict_proba(self, frame: Frame) -> Frame:
        """Cumulative probabilities after each tree
        (GBMModel.StagedPredictionsTask)."""
        if self.algo not in ("gbm", "xgboost"):
            raise NotImplementedError(
                "staged_predict_proba is only supported for GBM models")
        self._require_forest("staged_predict_proba")
        from h2o_tpu_torch.models.tree.contributions import \
            staged_proba_frame
        return staged_proba_frame(self, frame)

    def varimp(self, use_pandas: bool = False):
        """Variable importance as rows (variable, relative, scaled,
        percentage), most important first: the relative importances, the
        same over the largest, and their shares of the total (the
        reference's SharedTreeModel convention).  None without
        importances; a pandas DataFrame with ``use_pandas``."""
        vi = self.output.get("varimp")
        if vi is None:
            return None
        vi = np.asarray(vi, np.float64)
        names = list(self.output.get("x") or
                     [f"C{i}" for i in range(len(vi))])
        order = np.argsort(-vi)
        rel = vi[order]
        scaled = rel / rel[0] if len(rel) and rel[0] > 0 else rel
        pct = rel / rel.sum() if rel.sum() > 0 else rel
        rows = [(names[i], float(r), float(s), float(p))
                for i, r, s, p in zip(order, rel, scaled, pct)]
        if use_pandas:
            import pandas as pd
            return pd.DataFrame(rows, columns=[
                "variable", "relative_importance", "scaled_importance",
                "percentage"])
        return rows

    def family(self) -> Optional[Distribution]:
        """The distribution the model was fitted under: its resolved name
        with the params' family parameters; None for a model without one
        (DRF) and for a custom one, whose metrics are plain regression
        metrics (``h2o_tpu/models/model.py:287-289``)."""
        name = self.output.get("distribution_resolved")
        return None if name in (None, "custom") else \
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
        algo = blob["algo"]
        if algo == "xgboost" and blob["params"].get("booster") == "gblinear":
            algo = "xgboost_gblinear"
        mod, name = _MODEL_CLASSES[algo]
        cls = getattr(importlib.import_module(mod), name)
        dev = cloud(device)
        _rehome(blob["output"], dev)
        return cls(blob["params"], blob["output"], dev)


def _rehome(obj, device: torch.device) -> None:
    """Point every model held in a loaded output (CV models, an
    ensemble's base models and metalearner, ModelSelection's GLMs) at
    ``device``, through nested dicts and lists."""
    if isinstance(obj, Model):
        obj.device = device
        _rehome(obj.output, device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _rehome(v, device)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _rehome(v, device)


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
    "glm": ("h2o_tpu_torch.models.glm", "GLMModel"),
    "xgboost_gblinear": ("h2o_tpu_torch.models.tree.xgboost",
                         "XGBoostLinearModel"),
    "kmeans": ("h2o_tpu_torch.models.kmeans", "KMeansModel"),
    "deeplearning": ("h2o_tpu_torch.models.deeplearning",
                     "DeepLearningModel"),
    "gam": ("h2o_tpu_torch.models.gam", "GAMModel"),
    "rulefit": ("h2o_tpu_torch.models.rulefit", "RuleFitModel"),
    "pca": ("h2o_tpu_torch.models.pca", "PCAModel"),
    "svd": ("h2o_tpu_torch.models.svd", "SVDModel"),
    "glrm": ("h2o_tpu_torch.models.glrm", "GLRMModel"),
    "word2vec": ("h2o_tpu_torch.models.word2vec", "Word2VecModel"),
    "naivebayes": ("h2o_tpu_torch.models.naive_bayes", "NaiveBayesModel"),
    "coxph": ("h2o_tpu_torch.models.coxph", "CoxPHModel"),
    "isotonicregression": ("h2o_tpu_torch.models.isotonic",
                           "IsotonicRegressionModel"),
    "aggregator": ("h2o_tpu_torch.models.aggregator", "AggregatorModel"),
    "targetencoder": ("h2o_tpu_torch.models.target_encoder",
                      "TargetEncoderModel"),
    "modelselection": ("h2o_tpu_torch.models.modelselection",
                       "ModelSelectionModel"),
    "anovaglm": ("h2o_tpu_torch.models.anovaglm", "AnovaGLMModel"),
    "psvm": ("h2o_tpu_torch.models.psvm", "PSVMModel"),
    "infogram": ("h2o_tpu_torch.models.infogram", "InfogramModel"),
    "stackedensemble": ("h2o_tpu_torch.models.ensemble",
                        "StackedEnsembleModel"),
    "grep": ("h2o_tpu_torch.models.grep", "GrepModel"),
    "generic": ("h2o_tpu_torch.models.generic", "GenericModel"),
}


#: per thread, the job whose body runs there (``ModelBuilder._job``)
#: and what its build has yet to publish (``publish``)
_running = threading.local()


def publish(key: str, value: Any) -> None:
    """Put ``value`` in ``store.dkv()`` under ``key``: at once outside a
    build; inside one (also from a builder it nests on its thread, as a
    fold model), when the body publishes its model, so a build stopped
    after its last report publishes nothing."""
    pending = getattr(_running, "pending", None)
    if pending is None:
        dkv().put(key, value)
    else:
        pending.append((key, value))


def in_caller_threads(body: Callable[[Job], Any]) -> Callable[[Job], Any]:
    """A job body that runs under the calling thread's intra-op thread
    count and grad mode: a pool thread keeps the count it last ran with
    (and a CPU sum's order follows it: MKL's transposed ``sgemv``, the
    GLM's [X,1]'Wz, splits its rows over its threads), and grad mode is
    per thread."""
    n_threads, grad = torch.get_num_threads(), torch.is_grad_enabled()

    def run(j: Job):
        if torch.get_num_threads() != n_threads:
            torch.set_num_threads(n_threads)
        with torch.set_grad_enabled(grad):
            return body(j)

    return run


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
    #: the build's recovery snapshot (``core/recovery.py``), set by
    #: ``train_async`` when ``recovery_dir`` is given; the builders
    #: ``auto_recover`` makes set ``_recovery_resuming``
    _recovery = None
    _recovery_resuming = False

    def __init__(self, device: DeviceLike = None, **params):
        self.params = self.default_params()
        # ``model_id`` names the model (the reference's key), as there
        unknown = set(params) - set(self.params) - {"model_id"}
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

    @property
    def _job(self) -> Optional[Job]:
        """The job whose body runs on this thread: the build's own, also
        for the builders a build nests (CV folds, a metalearner, a
        relevance GBM), as the reference passes its job down."""
        return getattr(_running, "job", None)

    def train(self, x: Optional[Sequence[str]] = None,
              y: Optional[str] = None, training_frame: Frame = None,
              validation_frame: Optional[Frame] = None) -> Model:
        """Train on ``training_frame``; ``validation_frame``, when given,
        is scored as the model trains (early stopping watches it) and
        gives ``validation_metrics``.  ``nfolds`` > 1 or a
        ``fold_column`` cross-validates first.  Runs as a job
        (``train_async(...).join()``)."""
        return self.train_async(x, y, training_frame,
                                validation_frame).join()

    def train_async(self, x: Optional[Sequence[str]] = None,
                    y: Optional[str] = None, training_frame: Frame = None,
                    validation_frame: Optional[Frame] = None) -> Job:
        """Start the build as a job of :func:`jobs` and return it; its
        ``dest`` is the model key, under which the body publishes the
        model in ``store.dkv()``."""
        x, y = self._columns(x, y, training_frame)
        use_cv = self._use_cv()
        # pin the key now, so the job's dest and the stored model agree
        if not self.params.get("model_id"):
            self.params["model_id"] = str(Key.make(self.algo))
        job = Job(dest=self.params["model_id"], dest_type="Key<Model>",
                  description=self._job_description(training_frame))
        dev = self.device
        # job-level fault tolerance: the params and the training frame
        # first; the drivers add iteration checkpoints
        rec = None
        if self.params.get("recovery_dir") and \
                isinstance(training_frame, Frame):
            from h2o_tpu_torch.core.recovery import Recovery
            rec = Recovery(self.params["recovery_dir"], "model",
                           self.params["model_id"], dev)
            if not self._recovery_resuming:
                rec.begin({k: v for k, v in self.params.items()
                           if not str(k).startswith("_")},
                          training_frame,
                          extra={"algo": self.algo, "x": list(x), "y": y})
        self._recovery = rec

        def body(j: Job) -> Model:
            # a thread starts on device 0; another card is made current
            ctx = torch.cuda.device(dev) if dev.type == "cuda" and \
                (dev.index or 0) != 0 else contextlib.nullcontext()
            _running.job, _running.pending = j, []
            try:
                with ctx:
                    return self._train_body(j, x, y, training_frame,
                                            validation_frame, use_cv, rec)
            finally:
                _running.job = _running.pending = None

        jobs().start(job, in_caller_threads(body))
        return job

    def _train_body(self, j: Job, x: List[str], y: Optional[str],
                    train: Frame, valid: Optional[Frame],
                    use_cv: bool, rec=None) -> Model:
        t0 = time.time()
        model = self._fit_cv(x, y, train, valid) if use_cv \
            else self._fit(x, y, train, valid)
        model.params["model_id"] = str(j.dest)
        cmf = self.params.get("custom_metric_func")
        if cmf:
            from h2o_tpu_torch.core.udf import attach_custom_metric
            for mkey, fr_m in (("training_metrics", train),
                               ("validation_metrics", valid)):
                mm_obj = model.output.get(mkey)
                if mm_obj is not None and fr_m is not None:
                    attach_custom_metric(model, mm_obj, fr_m, cmf)
        # a job cancelled, or expired by the watchdog, after its last
        # update() publishes nothing
        if j.stop_requested:
            raise JobCancelledException(j.description)
        model.run_time_ms = int((time.time() - t0) * 1000)
        if rec is not None:
            rec.done()          # success: drop the snapshot
        for key, value in _running.pending:
            dkv().put(key, value)
        dkv().put(model.key, model)
        return model

    def _job_description(self, training_frame: Frame) -> str:
        return f"{self.algo} on {getattr(training_frame, 'key', None)}"

    def _use_cv(self) -> bool:
        """Whether ``nfolds`` > 1 or a ``fold_column`` asks for
        cross-validation; a builder without it refuses them."""
        use_cv = int(self.params.get("nfolds") or 0) > 1 or \
            bool(self.params.get("fold_column"))
        if use_cv and not self.supports_cv:
            raise ValueError(f"{self.algo}: n-fold cross-validation is "
                             "not supported by this builder")
        return use_cv

    def _update(self, progress: float, msg: str = "") -> None:
        """Report progress to the running job (its heartbeat; raises at
        a requested cancel); a no-op outside a job."""
        job = self._job
        if job is not None:
            job.update(progress, msg)

    def _columns(self, x: Optional[Sequence[str]], y: Optional[str],
                 training_frame: Frame):
        """The predictors and the response ``train`` fits: ``x`` (every
        column by default) less the response, ``ignored_columns`` and the
        fold column."""
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
        return [c for c in (x or training_frame.names)
                if c != y and c not in ignored], y

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

        # the fold models' key prefix: the model key, else the algo (a
        # _fit_cv outside train, as the ensemble's metalearner's)
        cv_base = str(p.get("model_id") or self.algo)
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
                              recovery_dir=None,
                              model_id=f"{cv_base}_cv_{i + 1}")
            sub._recovery = None
            self._update(i / (nfolds + 1.0), f"CV model {i + 1}/{nfolds}")
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

        self._update(nfolds / (nfolds + 1.0), "main model on full data")
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
            for m_i in cv_models:
                publish(m_i.key, m_i)
            model.output["cross_validation_models"] = \
                [str(m.key) for m in cv_models]
        if p.get("keep_cross_validation_predictions"):
            pf = _raw_to_frame(raw_combined,
                               model.output.get("response_domain"))
            pf.key = Key(f"cv_holdout_prediction_{model.key}")
            publish(pf.key, pf)
            model.output["cross_validation_holdout_predictions_frame_id"] = \
                str(pf.key)
        if p.get("keep_cross_validation_fold_assignment"):
            ff = Frame(["fold_assignment"], [Vec(fold.astype(np.float32))],
                       key=f"cv_fold_assignment_{model.key}")
            publish(ff.key, ff)
            model.output["cross_validation_fold_assignment_frame_id"] = \
                str(ff.key)
        return model

    def checkpoint_model(self) -> Optional[Model]:
        """The ``checkpoint`` param as a Model: a port model as given,
        the model published in the DKV under that key, or one loaded
        from the path ``Model.save`` wrote, on this builder's device."""
        ck = self.params.get("checkpoint")
        if not ck:
            return None
        if isinstance(ck, Model):
            return ck
        m = dkv().get(str(ck))
        if isinstance(m, Model):
            return m
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
