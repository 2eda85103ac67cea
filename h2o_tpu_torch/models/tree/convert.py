"""Carry a model trained by ``h2o_tpu`` across to the port.

``gbm_from_jax_output`` takes the numpy arrays of an ``h2o_tpu``
``GBMModel.output`` (plain host arrays: nothing of JAX is imported
here) and builds a port ``GBMModel`` that scores the same forest on the
port's device.  Dense-heap forests only; the sparse-frontier layout
(a ``child`` array) waits for its slice.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.models.tree.gbm import GBMModel

_KEYS = ("x", "split_points", "is_cat", "nbins", "fine_nbins", "hist_type",
         "split_col", "bitset", "value", "thr_bin", "na_left", "f0",
         "max_depth", "distribution_resolved", "response_domain")


def gbm_from_jax_output(output: Dict[str, Any], params: Dict[str, Any],
                        device: DeviceLike = None) -> GBMModel:
    """Port ``GBMModel`` from an ``h2o_tpu`` GBM's output dict (arrays
    converted with ``np.asarray``) and its params (for
    ``response_column``)."""
    missing = [k for k in _KEYS if k not in output]
    if missing:
        raise ValueError(f"h2o_tpu GBM output lacks {missing}")
    if output.get("child") is not None:
        raise NotImplementedError(
            "sparse-frontier forests come with the frontier-engine slice")
    dist = str(output["distribution_resolved"])
    if dist not in ("gaussian", "bernoulli"):
        raise NotImplementedError(
            f"distribution {dist!r} is not in this slice of the port")
    out = {k: output[k] for k in _KEYS}
    for k in ("split_points", "is_cat", "split_col", "bitset", "value",
              "thr_bin", "na_left", "f0"):
        out[k] = np.asarray(out[k]) if out[k] is not None else None
    out["x"] = list(out["x"])
    out["nbins"] = int(out["nbins"])
    out["fine_nbins"] = int(out["fine_nbins"] or out["nbins"])
    out["max_depth"] = int(out["max_depth"])
    out["child"] = None
    dom = out["response_domain"]
    out["response_domain"] = list(dom) if dom is not None else None
    return GBMModel(dict(params), out, cloud(device))
