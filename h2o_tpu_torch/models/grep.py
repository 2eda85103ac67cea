"""Grep — port of ``h2o_tpu/models/grep.py`` (``GrepModel`` :22-36,
``Grep`` :39-86).

A regular expression run by Python's ``re`` on the host over raw text:
a frame's one string column (its ``host_data`` joined with newlines, NA
as an empty line) or the file at a path.  The model holds every match
and its character offset, as the reference's GrepModel holds
``_matches``/``_offsets``.  A missing regex, one ``re`` cannot compile,
and a frame that is not exactly one text column are refused, as in the
reference; ``predict_raw`` raises, as GrepModel.score0 does.  The
builder's device is the port's default, though nothing runs there.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.core.frame import Frame
from h2o_tpu_torch.models import metrics as mm
from h2o_tpu_torch.models.model import Model, ModelBuilder


class GrepModel(Model):
    algo = "grep"

    def predict_raw(self, frame: Frame):
        raise NotImplementedError("Grep models report matches; they do "
                                  "not score rows (GrepModel.score0 "
                                  "throws in the reference too)")

    def model_metrics(self, frame: Frame = None) -> mm.ModelMetrics:
        return mm.grep_metrics(len(self.output.get("matches", [])))


def text_of(train) -> str:
    """The text a Grep runs over: a one-text-column frame, or a path."""
    if isinstance(train, Frame):
        col = next((v for v in train.vecs if v.host_data is not None), None)
        if col is None or train.ncols != 1:
            raise ValueError("Grep wants exactly 1 raw-text column "
                             "(reference: a single ByteVec)")
        return "\n".join("" if s is None else str(s) for s in col.host_data)
    path = str(train)
    if os.path.exists(path):
        with open(path, "r", errors="replace") as f:
            return f.read()
    raise ValueError(f"no text source at {train!r}")


def grep_from_jax_output(output: Dict, params: Dict,
                         device: DeviceLike = None) -> GrepModel:
    """The port's ``GrepModel`` from an ``h2o_tpu`` Grep's output dict."""
    out = dict(matches=list(output["matches"]),
               offsets=[int(o) for o in output["offsets"]],
               model_category="Unknown")
    model = GrepModel(dict(params), out, cloud(device))
    out["training_metrics"] = model.model_metrics()
    return model


class Grep(ModelBuilder):
    algo = "grep"
    model_cls = GrepModel
    supervised = False
    supports_cv = False

    def default_params(self) -> Dict:
        p = super().default_params()
        p.update(regex=None)
        return p

    def _columns(self, x, y, training_frame):
        """``training_frame`` is a one-text-column frame or a path; no
        predictors, no response."""
        if training_frame is None:
            raise ValueError("training_frame is required")
        return [], None

    def _fit(self, x: List[str], y: Optional[str], train,
             valid: Optional[Frame] = None) -> GrepModel:
        self.refuse_iteration_checkpoints()
        p = self.params
        if not p.get("regex"):
            raise ValueError("regex is missing")
        try:
            pattern = re.compile(str(p["regex"]))
        except re.error as e:
            raise ValueError(f"bad regex: {e}")
        text = text_of(train)
        matches: List[str] = []
        offsets: List[int] = []
        n = max(len(text), 1)
        for i, m in enumerate(pattern.finditer(text)):
            matches.append(m.group(0))
            offsets.append(m.start())
            if i % 4096 == 0:
                self._update(m.start() / n, f"{len(matches)} matches")
        out = dict(matches=matches, offsets=offsets,
                   model_category="Unknown")
        model = self.model_cls(dict(p), out, self.device)
        out["training_metrics"] = model.model_metrics()
        return model
