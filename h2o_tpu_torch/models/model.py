"""Model / ModelBuilder lifecycle — port of ``h2o_tpu/models/model.py``
(``DataInfo`` :34-106 in tree mode, ``_raw_to_frame`` :156-166,
``Model`` :169-301 with ``metrics_from_raw`` :270-303, ``ModelBuilder``
:383-696 with ``_validate_fixed`` :397-416, ``rng_key`` :691-696).

The reference runs a build as an asynchronous Job that stores the model
in the DKV; the port trains synchronously and returns the model.
Validation frames come with the blocked training loop and its
incremental scorer; cross-validation, recovery and custom metrics with
the model-orchestration slice.
"""

from __future__ import annotations

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


def _raw_to_frame(raw: torch.Tensor, dom: Optional[List[str]]) -> Frame:
    """raw predictions -> prediction Frame ([predict, p0..pK-1])."""
    raw = raw.detach().cpu().numpy()
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

    def metrics_from_raw(self, raw: torch.Tensor,
                         frame: Frame) -> mm.ModelMetrics:
        """Metrics of raw predictions against ``frame``'s response,
        weighted by the weights column where the frame has it; a
        regression's deviance is its distribution's (gaussian and DRF:
        plain regression metrics)."""
        p = self.params
        yv = frame.vec(p["response_column"])
        y = torch.from_numpy(yv.as_float()).to(raw.device)
        wc = p.get("weights_column")
        w = torch.from_numpy(frame.vec(wc).as_float()).to(raw.device) \
            if wc and wc in frame.names else None
        dom = self.output.get("response_domain")
        if dom is None:
            dist = self.family()
            if dist is not None and dist.name == "gaussian":
                dist = None
            return mm.regression_metrics(raw, y, w=w, distribution=dist)
        if len(dom) == 2:
            return mm.binomial_metrics(raw[:, 2], y, w=w, domain=dom)
        return mm.multinomial_metrics(raw[:, 1:], y, w=w, domain=dom)


class ModelBuilder:
    """Train lifecycle: params -> validate -> ``_fit`` -> Model."""

    algo = "base"
    model_cls = Model
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
                    nfolds=0, fold_column=None, checkpoint=None)

    def train(self, x: Optional[Sequence[str]] = None,
              y: Optional[str] = None, training_frame: Frame = None,
              validation_frame: Optional[Frame] = None) -> Model:
        if training_frame is None:
            raise ValueError("training_frame is required")
        if validation_frame is not None:
            raise NotImplementedError(
                "validation frames are not in the port yet; they come with "
                "the blocked training loop and its incremental scorer "
                "(the rest of P6)")
        y = y or self.params.get("response_column")
        if not y:
            raise ValueError(f"{self.algo} requires a response column")
        self.params["response_column"] = y
        ignored = set(self.params.get("ignored_columns") or ())
        x = [c for c in (x or training_frame.names)
             if c != y and c not in ignored]
        return self._fit(x, y, training_frame)

    def _fit(self, x: List[str], y: str, train: Frame) -> Model:
        raise NotImplementedError

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
