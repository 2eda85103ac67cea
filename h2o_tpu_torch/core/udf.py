"""User-defined functions: custom model metrics and custom distributions —
port of ``h2o_tpu/core/udf.py`` (``_install_water_stub`` :33-58,
``load_custom_func`` :61-92, ``custom_link_inv`` :95-108,
``CustomDistribution`` :111-171, ``load_custom_distribution`` :174-178,
``compute_custom_metric`` :181-205, ``attach_custom_metric`` :208-226).

The stock client's ``h2o.upload_custom_metric`` /
``upload_custom_distribution`` zips python source, uploads it, and
passes ``python:<key>=<module>.<Class>`` as the builder's
``custom_metric_func`` / ``custom_distribution_func``; ``<key>``'s value
in ``store.dkv()`` is the path of the uploaded zip.  The source is real
python, so it runs as is; its ``import water.udf.CMetricFunc`` is
satisfied by a stub module.

A custom distribution's ``gradient``/``hessian`` receive the tree
engine's tensors on the model's device, so a class written with
operators (``(y - f) * ((y > f) * 3.0 + (y <= f) * 1.0)``) runs there
unchanged.  The inverse links take XLA's CPU arithmetic
(``ops/xlamath.exp``, results below float32's smallest normal flushed to
zero), so the log and logit links equal the reference's bit for bit on
the CPU.  A custom metric's map/reduce/metric loop runs on the host over
the scored rows, as in the reference (custom metrics are O(rows) scalar
reductions; the scoring stays on the device).
"""

from __future__ import annotations

import io
import sys
import types
import zipfile
from typing import Optional

import numpy as np
import torch

from h2o_tpu_torch.core.log import get_logger
from h2o_tpu_torch.models.distributions import Distribution
from h2o_tpu_torch.ops import xlamath

log = get_logger("udf")

_MIN_NORMAL = float(np.finfo(np.float32).tiny)


def _install_water_stub() -> None:
    """Satisfy ``import water.udf.{CMetricFunc,CDistributionFunc}`` in
    uploaded sources."""
    if "water.udf.CMetricFunc" in sys.modules:
        return
    water = sys.modules.setdefault("water", types.ModuleType("water"))
    udf = types.ModuleType("water.udf")
    cmf = types.ModuleType("water.udf.CMetricFunc")
    cdf = types.ModuleType("water.udf.CDistributionFunc")

    class CMetricFunc:  # the interface marker (map/reduce/metric)
        pass

    class CDistributionFunc:  # link/init/gradient/gammaNum/gammaDenom
        pass

    cmf.CMetricFunc = CMetricFunc
    cdf.CDistributionFunc = CDistributionFunc
    # `import water.udf.CMetricFunc as MetricFunc` binds the alias via
    # getattr(water.udf, "CMetricFunc") and uses it as a base class
    udf.CMetricFunc = CMetricFunc
    udf.CDistributionFunc = CDistributionFunc
    water.udf = udf
    sys.modules["water.udf"] = udf
    sys.modules["water.udf.CMetricFunc"] = cmf
    sys.modules["water.udf.CDistributionFunc"] = cdf


def load_custom_func(ref: str):
    """Resolve ``python:<key>=<module>.<Class>`` to an instance: ``<key>``
    is the upload key whose DKV value is the path of the zip;
    ``<module>.py`` inside it holds the source."""
    from h2o_tpu_torch.core.store import dkv
    if not ref:
        return None
    spec = ref.split(":", 1)[1] if ref.startswith("python:") else ref
    key, _, target = spec.partition("=")
    module_name, _, class_name = target.rpartition(".")
    path = dkv().get(key)
    if path is None:
        raise ValueError(f"custom func upload {key!r} not found")
    with open(str(path), "rb") as f:
        blob = f.read()
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        names = z.namelist()
        want = f"{module_name}.py"
        src_name = want if want in names else next(
            (n for n in names if n.endswith(".py")), None)
        if src_name is None:
            raise ValueError(f"no python source in custom func {key!r}")
        source = z.read(src_name).decode()
    _install_water_stub()
    mod = types.ModuleType(module_name or "custom_metric")
    exec(compile(source, src_name, "exec"), mod.__dict__)
    cls = mod.__dict__.get(class_name)
    if cls is None:
        raise ValueError(f"class {class_name!r} not found in {src_name}")
    return cls()


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """Subnormal results flushed to (signed) zero, as XLA's CPU does."""
    return torch.where(x.abs() < _MIN_NORMAL, x * 0.0, x)


def custom_link_inv(link_name: Optional[str], f: torch.Tensor
                    ) -> torch.Tensor:
    """Inverse link by name (the CDistributionFunc ``link()`` vocabulary:
    identity/log/logit/inverse), shared by training and every scoring
    path."""
    link = (link_name or "identity").lower()
    if link == "log":
        return xlamath.exp(f)
    if link == "logit":
        one = torch.ones_like(f)
        return _ftz(one / (one + xlamath.exp(-f)))
    if link == "inverse":
        lim = torch.where(f < 0, torch.full_like(f, -1e-5),
                          torch.full_like(f, 1e-5))
        return _ftz(torch.ones_like(f) /
                    torch.where(f.abs() < 1e-5, lim, f))
    return f


class CustomDistribution(Distribution):
    """The CDistributionFunc contract (link/init/gradient, and
    ``hessian`` where the class has one) as a tree-engine distribution.
    Leaf values are the engine's Newton ratio sum(w*g)/sum(w*h) with
    ``h = hessian(y, f)`` when the class provides it, else the mean
    residual (the reference's documented simplification of the
    gammaNum/gammaDenom pass)."""

    name = "custom"

    def __init__(self, func):
        self.func = func
        link = "identity"
        if hasattr(func, "link"):
            link = str(func.link()).lower()
        self.link_name = link
        self.link = link

    @property
    def newton(self) -> bool:
        return hasattr(self.func, "hessian")

    def gradient(self, y, f):
        return self.func.gradient(y, f)

    def hessian(self, y, f):
        if hasattr(self.func, "hessian"):
            return self.func.hessian(y, f)
        return torch.ones_like(f)

    def link_inv(self, f):
        return custom_link_inv(self.link_name, f)

    def link_fn(self, mu):
        if self.link_name == "log":
            return float(np.log(max(mu, 1e-12)))
        if self.link_name == "logit":
            mu = min(max(mu, 1e-12), 1 - 1e-12)
            return float(np.log(mu / (1 - mu)))
        if self.link_name == "inverse":
            return float(1.0 / mu) if mu else 0.0
        return float(mu)

    def init_f0(self, y, w) -> float:
        """f0 = link(init ratio), in float64 on the host:
        CDistributionFunc.init returns [weighted numerator, weight sum]."""
        ya = np.asarray(y, np.float64)
        wa = np.asarray(w, np.float64)
        if hasattr(self.func, "init"):
            num, den = self.func.init(wa, np.zeros_like(wa), ya)
            num, den = float(np.sum(num)), float(np.sum(den))
        else:
            num, den = float(np.sum(wa * ya)), float(np.sum(wa))
        return self.link_fn(num / max(den, 1e-12))


def load_custom_distribution(ref: str) -> CustomDistribution:
    """A ``custom_distribution_func`` reference as a distribution."""
    return CustomDistribution(load_custom_func(ref))


def compute_custom_metric(func, preds: np.ndarray, actual: np.ndarray,
                          weights: Optional[np.ndarray] = None,
                          offsets: Optional[np.ndarray] = None,
                          model=None) -> float:
    """The CMetricFunc contract: per-row map, pairwise reduce, final
    metric (a row's preds are H2O's [label, p0, p1...] or [value])."""
    preds = np.atleast_2d(np.asarray(preds, np.float64))
    if preds.shape[0] == 1 and preds.shape[1] == len(actual):
        preds = preds.T
    n = len(actual)
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    o = np.zeros(n) if offsets is None else np.asarray(offsets, np.float64)
    acc = None
    for i in range(n):
        a = actual[i]
        if a is None or (isinstance(a, float) and np.isnan(a)):
            continue
        l = func.map(preds[i].tolist(), [float(a)], float(w[i]),
                     float(o[i]), model)
        acc = l if acc is None else func.reduce(acc, l)
    if acc is None:
        return float("nan")
    return float(func.metric(acc))


def attach_custom_metric(model, metrics, frame, ref: str,
                         name: Optional[str] = None) -> None:
    """Compute and record the custom metric on a ModelMetrics object
    (``custom_metric_name``, ``custom_metric_value``).  A failure of the
    user's function records NaN, as the reference does; a failure of the
    model's own scoring raises."""
    raw = model.predict_raw(frame)
    raw = (raw.detach().cpu().numpy() if torch.is_tensor(raw)
           else np.asarray(raw))[: frame.nrows]
    try:
        func = load_custom_func(ref)
        y_name = model.params.get("response_column")
        act = frame.vec(y_name).as_float().astype(np.float64)
        wc = model.params.get("weights_column")
        w = frame.vec(wc).as_float().astype(np.float64) \
            if wc and wc in frame else None
        value = compute_custom_metric(func, raw, act, w, model=model)
        metrics.data["custom_metric_name"] = \
            name or ref.split("=")[0].split(":")[-1]
        metrics.data["custom_metric_value"] = value
    except Exception as e:  # noqa: BLE001 — a user metric must not kill
        log.warning("custom metric %r failed: %s", ref, e)
        metrics.data["custom_metric_name"] = ref
        metrics.data["custom_metric_value"] = float("nan")
