"""Model / ModelBuilder lifecycle — port of ``h2o_tpu/models/model.py``
(``DataInfo`` :34-153 in tree mode, ``_raw_to_frame`` :156-166,
``Model`` :169-301, ``ModelBuilder`` :383-696, ``rng_key`` :691-696).

The reference runs a build as an asynchronous Job that stores the model
in the DKV; this slice trains synchronously and returns the model.
Cross-validation, checkpoints, recovery and custom metrics wait for
later slices.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.core.frame import T_CAT, Frame, Vec
from h2o_tpu_torch.models import metrics as mm
from h2o_tpu_torch.ops import prng


class DataInfo:
    """Tree-mode feature extraction (reference hex/DataInfo.java):
    categoricals stay integer codes, NAs stay NaN, and constant columns
    are dropped (``ignore_const_cols``, ``model.py:58-69``)."""

    def __init__(self, frame: Frame, x: Sequence[str], y: Optional[str],
                 device: torch.device):
        self.frame = frame
        self.device = device
        self.response_name = y
        self.x = [c for c in x if c != y and not frame.vec(c).is_constant()]
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

    def metrics_from_raw(self, raw: torch.Tensor,
                         frame: Frame) -> mm.ModelMetrics:
        yv = frame.vec(self.params["response_column"])
        y = torch.from_numpy(yv.as_float()).to(raw.device)
        dom = self.output.get("response_domain")
        if dom is None:
            return mm.regression_metrics(raw, y)
        if len(dom) == 2:
            return mm.binomial_metrics(raw[:, 2], y, domain=dom)
        raise NotImplementedError(
            "multinomial metrics come with the multinomial slice")


class ModelBuilder:
    """Train lifecycle: params -> validate -> ``_fit`` -> Model."""

    algo = "base"
    model_cls = Model

    def __init__(self, device: DeviceLike = None, **params):
        self.params = self.default_params()
        unknown = set(params) - set(self.params)
        if unknown:
            raise ValueError(f"{self.algo}: unknown params {sorted(unknown)}")
        self.params.update(params)
        self.device = cloud(device)

    def default_params(self) -> Dict[str, Any]:
        return dict(response_column=None, ignored_columns=None,
                    weights_column=None, offset_column=None, seed=-1,
                    max_runtime_secs=0.0, distribution="auto",
                    nfolds=0, fold_column=None, checkpoint=None)

    def train(self, x: Optional[Sequence[str]] = None,
              y: Optional[str] = None, training_frame: Frame = None,
              validation_frame: Optional[Frame] = None) -> Model:
        if training_frame is None:
            raise ValueError("training_frame is required")
        if validation_frame is not None:
            raise NotImplementedError(
                "validation frames come with the incremental-scoring slice")
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
