"""Generic — import an external scoring artifact as a first-class Model;
port of ``h2o_tpu/models/generic.py`` (``GenericModel`` :23-90 with
``from_mojo`` :26-36, ``_mojo`` :38-54 and ``predict_raw`` :56-90,
``Generic`` :93-136).

Reference: hex/generic/Generic.java + GenericModel.java (1.3k LoC) — wraps a
MOJO so it can serve predictions and join ensembles/leaderboards like any
trained model.

Scoring routes the frame through the MOJO's pure-numpy scorer on the host
(artifacts may come from other builds and carry no device program), as
the reference does, and hands the predictions to the model's device
(``cuda:0`` unless the caller asks for the CPU).  ``from_mojo``
publishes the model in ``store.dkv()`` under its key, as the
reference's does (``generic.py:35``); ``Generic.train`` runs the import
as a job through ``ModelBuilder.train_async``; a ``model_key`` is an
upload key whose DKV value is the path of the MOJO (``upload_mojo``),
or the path itself with an ``nfs://`` prefix (reference
``generic.py:103-113``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.core.frame import Frame
from h2o_tpu_torch.core.store import dkv
from h2o_tpu_torch.models.model import Model, ModelBuilder


class GenericModel(Model):
    algo = "generic"

    @classmethod
    def from_mojo(cls, mojo, model_id: str = None,
                  device: DeviceLike = None) -> "GenericModel":
        """The model of a loaded MOJO (npz ``MojoModel`` or
        ``GenmodelMojoModel``), named ``model_id``, scoring onto
        ``device``."""
        dev = cloud(device)
        params = dict(mojo.params)
        params["model_id"] = model_id
        out = dict(mojo.meta)
        out["__arrays__"] = {k: np.asarray(v)
                             for k, v in mojo.arrays.items()}
        out["source_algo"] = mojo.algo
        m = cls(params, out, dev)
        dkv().put(m.key, m)
        return m

    def _mojo(self):
        arrays = self.output["__arrays__"]
        if "__genmodel_zip__" in arrays:
            # parse once per model: nested artifacts (StackedEnsemble)
            # are expensive to re-decode on every predict
            cached = getattr(self, "_mojo_cache", None)
            if cached is not None:
                return cached
            from h2o_tpu_torch.mojo.genmodel import GenmodelMojoModel
            self._mojo_cache = GenmodelMojoModel(
                arrays["__genmodel_zip__"].tobytes())
            return self._mojo_cache
        from h2o_tpu_torch.mojo import MojoModel
        return MojoModel(self.output["source_algo"], self.params,
                         {k: v for k, v in self.output.items()
                          if k != "__arrays__"},
                         arrays)

    def predict_raw(self, frame: Frame) -> torch.Tensor:
        mojo = self._mojo()
        cols = mojo.columns
        X = np.full((frame.nrows, len(cols)), np.nan, np.float64)
        for j, c in enumerate(cols):
            if c in frame:
                v = frame.vec(c)
                col = np.asarray(v.to_numpy(), np.float64)
                if v.is_categorical:
                    # adaptTestForTrain: remap the frame's domain codes to
                    # the artifact's training domain; unseen levels -> NA
                    # (NaN is score_matrix's NA convention; frame NA = -1)
                    col = np.where(col < 0, np.nan, col)
                    mdom = mojo.domain_of(c)
                    fdom = v.domain or []
                    if mdom is not None and list(mdom) != list(fdom):
                        lut = {s: i for i, s in enumerate(mdom)}
                        remap = np.array(
                            [lut.get(s, np.nan) for s in fdom], np.float64)
                        if len(fdom):
                            # NaN-safe: index with NA rows pinned to 0,
                            # then restore NaN (NaN.astype(int64) is UB)
                            idx = np.clip(np.nan_to_num(col), 0,
                                          len(fdom) - 1).astype(np.int64)
                            col = np.where(np.isnan(col), np.nan,
                                           remap[idx])
                        else:
                            col = np.full_like(col, np.nan)
                X[:, j] = col
        raw = np.asarray(mojo.score_matrix(X), np.float32)
        return torch.from_numpy(np.ascontiguousarray(raw)).to(self.device)


class Generic(ModelBuilder):
    algo = "generic"
    model_cls = GenericModel
    supervised = False

    def default_params(self) -> Dict:
        p = super().default_params()
        p.update(path=None, model_key=None)
        return p

    def _resolve_path(self) -> str:
        path = self.params.get("path")
        if not path and self.params.get("model_key"):
            # upload_mojo: model_key is the upload key whose DKV value is
            # the spooled path
            mk = str(self.params["model_key"])
            src = dkv().get(mk)
            path = str(src) if src else mk.replace("nfs://", "")
        if not path:
            raise ValueError("Generic requires path or model_key to a MOJO")
        return path

    def _columns(self, x, y, training_frame):
        """The artifact is the training input: every frame argument is
        ignored, as in the reference."""
        return [], None

    def _job_description(self, training_frame) -> str:
        return "generic model import"

    def _fit(self, x, y, train, valid=None) -> GenericModel:
        from h2o_tpu_torch.mojo import load_mojo
        return GenericModel.from_mojo(
            load_mojo(self._resolve_path()),
            model_id=self.params["model_id"], device=self.device)
