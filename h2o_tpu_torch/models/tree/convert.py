"""Carry a model trained by ``h2o_tpu`` across to the port.

``gbm_from_jax_output``, ``drf_from_jax_output``,
``xgboost_from_jax_output``, ``dt_from_jax_output``,
``isolationforest_from_jax_output``,
``extendedisolationforest_from_jax_output`` and
``upliftdrf_from_jax_output`` take the numpy arrays of an ``h2o_tpu``
model's output (plain host arrays: nothing of JAX is imported here) and
build the port's model, which scores the same forest on the port's
device: dense-heap forests and sparse-frontier forests with their
``child`` pointers, one tree or K class trees an iteration, and
XGBoost's gbtree and dart forests (dart's trees carry their rescaled
values).  Every converted forest carries the categorical predictors'
training ``domains``, which the MOJO writers, the POJO and the serving
engine's row encoder read.  A converted GBM or DRF carries what a
checkpoint needs (tree count, f0, split points, fine grid, node arrays
and importance) and the per-node gains and covers (``node_gain``,
``node_w``), so it can be given to the port's builder as
``checkpoint`` and trained on.  An
XGBoost gblinear model is a GLM and goes through
``models.glm.glm_from_jax_output``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.models.glm import glm_from_jax_output
from h2o_tpu_torch.models.tree.drf import DRFModel
from h2o_tpu_torch.models.tree.dt import DTModel
from h2o_tpu_torch.models.tree.gbm import GBMModel
from h2o_tpu_torch.models.tree.isofor import (ExtendedIsolationForestModel,
                                              IsolationForestModel)
from h2o_tpu_torch.models.tree.uplift import UpliftDRFModel
from h2o_tpu_torch.models.tree.xgboost import (XGBoostLinearModel,
                                               XGBoostModel)

_KEYS = ("x", "split_points", "is_cat", "nbins", "fine_nbins", "hist_type",
         "split_col", "bitset", "value", "thr_bin", "na_left", "child",
         "max_depth", "response_domain", "ntrees_actual")
_ARRAYS = ("split_points", "is_cat", "split_col", "bitset", "value",
           "thr_bin", "na_left", "child", "f0", "varimp", "node_gain",
           "node_w")
#: carried when the reference's output has them (its models made before
#: the per-node gain and cover arrays lack them)
_OPTIONAL = ("varimp", "node_gain", "node_w")
#: carried only where the reference's output holds them, so a carried
#: model's artifact metadata holds the reference's keys
_IF_PRESENT = ("effective_max_depth", "custom_link")


def _port_output(output: Dict[str, Any], keys: Tuple[str, ...],
                 what: str) -> Dict[str, Any]:
    missing = [k for k in keys if k not in output]
    if missing:
        raise ValueError(f"h2o_tpu {what} output lacks {missing}")
    out = {k: output[k] for k in keys}
    for k in _OPTIONAL:
        out[k] = output.get(k)
    out.update((k, output[k]) for k in _IF_PRESENT if k in output)
    for k in _ARRAYS:
        if out.get(k) is not None:
            out[k] = np.asarray(out[k])
    out["x"] = list(out["x"])
    out["nbins"] = int(out["nbins"])
    out["fine_nbins"] = int(out["fine_nbins"] or out["nbins"])
    out["max_depth"] = int(out["max_depth"])
    out["ntrees_actual"] = int(out["ntrees_actual"])
    dom = out["response_domain"]
    out["response_domain"] = list(dom) if dom is not None else None
    out["domains"] = _domains(output)
    return out


def _domains(output: Dict[str, Any]) -> Dict[str, list]:
    """The training domains of the categorical predictors, which the
    MOJO writers, the POJO and the serving engine's row encoder read."""
    return {c: list(d) for c, d in (output.get("domains") or {}).items()}


def _boosted(cls, what: str, output: Dict[str, Any],
             params: Dict[str, Any], device: DeviceLike):
    dev = cloud(device)
    out = _port_output(output, _KEYS + ("f0", "distribution_resolved"),
                       what)
    out["distribution_resolved"] = str(out["distribution_resolved"])
    return cls(dict(params), out, dev)


def gbm_from_jax_output(output: Dict[str, Any], params: Dict[str, Any],
                        device: DeviceLike = None) -> GBMModel:
    """Port ``GBMModel`` from an ``h2o_tpu`` GBM's output dict (arrays
    converted with ``np.asarray``) and its params (``response_column``,
    and the ``offset_column``/``tweedie_power`` scoring reads)."""
    return _boosted(GBMModel, "GBM", output, params, device)


def drf_from_jax_output(output: Dict[str, Any], params: Dict[str, Any],
                        device: DeviceLike = None) -> DRFModel:
    """Port ``DRFModel`` from an ``h2o_tpu`` DRF's output dict, as
    ``gbm_from_jax_output`` does for a GBM."""
    dev = cloud(device)
    return DRFModel(dict(params), _port_output(output, _KEYS, "DRF"), dev)


def xgboost_from_jax_output(output: Dict[str, Any], params: Dict[str, Any],
                            device: DeviceLike = None) -> XGBoostModel:
    """Port ``XGBoostModel`` (booster gbtree or dart) or
    ``XGBoostLinearModel`` (gblinear, a GLM) from an ``h2o_tpu``
    XGBoost's output dict."""
    if str(params.get("booster", "gbtree")) == "gblinear":
        return glm_from_jax_output(output, params, device,
                                   cls=XGBoostLinearModel)
    return _boosted(XGBoostModel, "XGBoost", output, params, device)


def dt_from_jax_output(output: Dict[str, Any], params: Dict[str, Any],
                       device: DeviceLike = None) -> DTModel:
    """Port ``DTModel`` from an ``h2o_tpu`` DT's output dict (a DRF of
    one tree)."""
    dev = cloud(device)
    return DTModel(dict(params), _port_output(output, _KEYS, "DT"), dev)


def _host_output(output: Dict[str, Any], keys: Tuple[str, ...],
                 arrays: Tuple[str, ...], what: str) -> Dict[str, Any]:
    missing = [k for k in keys if k not in output]
    if missing:
        raise ValueError(f"h2o_tpu {what} output lacks {missing}")
    out = {k: output[k] for k in keys}
    for k in arrays:
        out[k] = np.asarray(out[k])
    out["x"] = list(out["x"])
    out["domains"] = _domains(output)
    return out


def isolationforest_from_jax_output(
        output: Dict[str, Any], params: Dict[str, Any],
        device: DeviceLike = None) -> IsolationForestModel:
    """Port ``IsolationForestModel`` from an ``h2o_tpu`` IsolationForest's
    output dict: its trees and the training frame's path-length range."""
    dev = cloud(device)
    out = _host_output(output, (
        "x", "split_col", "thresh", "max_depth", "ntrees_actual",
        "sample_size", "min_path_length", "max_path_length"),
        ("split_col", "thresh"), "IsolationForest")
    return IsolationForestModel(dict(params), out, dev)


def extendedisolationforest_from_jax_output(
        output: Dict[str, Any], params: Dict[str, Any],
        device: DeviceLike = None) -> ExtendedIsolationForestModel:
    """Port ``ExtendedIsolationForestModel`` from an ``h2o_tpu``
    ExtendedIsolationForest's output dict."""
    dev = cloud(device)
    arrays = ("normals", "points", "value", "is_split", "counts")
    out = _host_output(output, ("x", "max_depth", "ntrees_actual",
                                "sample_size") + arrays, arrays,
                       "ExtendedIsolationForest")
    return ExtendedIsolationForestModel(dict(params), out, dev)


def upliftdrf_from_jax_output(output: Dict[str, Any], params: Dict[str, Any],
                              device: DeviceLike = None) -> UpliftDRFModel:
    """Port ``UpliftDRFModel`` from an ``h2o_tpu`` UpliftDRF's output dict;
    ``params`` names the response and treatment columns its metrics
    read."""
    dev = cloud(device)
    arrays = ("split_points", "is_cat", "split_col", "bitset", "val_t",
              "val_c", "child")
    out = _host_output(output, ("nbins", "max_depth", "ntrees_actual",
                                "response_domain", "x") + arrays, arrays,
                       "UpliftDRF")
    dom = out["response_domain"]
    out["response_domain"] = list(dom) if dom is not None else None
    return UpliftDRFModel(dict(params), out, dev)
