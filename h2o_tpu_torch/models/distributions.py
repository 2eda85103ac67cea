"""Distribution families for boosting — port of
``h2o_tpu/models/distributions.py`` (``Distribution``/``Gaussian``/
``Bernoulli`` :20-89, ``Multinomial`` :92-98, ``Poisson`` :101-123,
``Gamma`` :126-148, ``Tweedie`` :151-183, ``Laplace``/``QuantileDist``/
``Huber`` :186-229, ``get_distribution`` :232-242).

gradient/hessian are taken with respect to f, the link-scale
prediction: residual r = -dL/df, Newton denominator h = d2L/df2.  All
functions are elementwise float32 tensor code; formulas are written as
in the reference (e.g. ``1 / (1 + exp(-f))``, not ``torch.sigmoid``) so
the two round alike.

Multinomial is a marker: the tree engine builds K class trees on
softmax gradients itself.  ``"custom"`` is a user's distribution
function: ``distribution_from_params`` loads it from the params'
``custom_distribution_func`` (``core/udf.py``, the reference's
``gbm.py:187-200``); ``get_distribution`` alone cannot build it.
"""

from __future__ import annotations

from typing import Dict

import torch

EPS = 1e-10


class Distribution:
    name = "base"
    link = "identity"

    def init_f0(self, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Initial constant prediction on the link scale."""
        m = torch.sum(w * y) / torch.clamp_min(torch.sum(w), EPS)
        return self.link_fn(m)

    def link_fn(self, mu):
        return mu

    def link_inv(self, f):
        return f

    def gradient(self, y, f):
        raise NotImplementedError

    def hessian(self, y, f):
        return torch.ones_like(f)

    def deviance(self, w, y, f):
        raise NotImplementedError


class Gaussian(Distribution):
    name = "gaussian"

    def gradient(self, y, f):
        return y - f

    def deviance(self, w, y, f):
        return w * (y - f) ** 2


class Bernoulli(Distribution):
    name = "bernoulli"
    link = "logit"

    def init_f0(self, y, w):
        p = torch.clamp(torch.sum(w * y) / torch.clamp_min(torch.sum(w), EPS),
                        EPS, 1 - EPS)
        return torch.log(p / (1 - p))

    def link_fn(self, mu):
        mu = torch.clamp(mu, EPS, 1 - EPS)
        return torch.log(mu / (1 - mu))

    def link_inv(self, f):
        return 1.0 / (1.0 + torch.exp(-f))

    def gradient(self, y, f):
        return y - self.link_inv(f)

    def hessian(self, y, f):
        p = self.link_inv(f)
        return p * (1.0 - p)

    def deviance(self, w, y, f):
        p = torch.clamp(self.link_inv(f), EPS, 1 - EPS)
        return -2.0 * w * (y * torch.log(p) + (1 - y) * torch.log(1 - p))


class Multinomial(Distribution):
    """Handled by the builders and the engine (K trees on softmax
    gradients); only the name and link live here."""

    name = "multinomial"
    link = "log"


class _LogLink(Distribution):
    """Log-link families: f0 = log(weighted mean), floored at EPS."""

    link = "log"

    def init_f0(self, y, w):
        return torch.log(torch.clamp_min(
            torch.sum(w * y) / torch.clamp_min(torch.sum(w), EPS), EPS))

    def link_fn(self, mu):
        return torch.log(torch.clamp_min(mu, EPS))

    def link_inv(self, f):
        return torch.exp(f)


class Poisson(_LogLink):
    name = "poisson"

    def gradient(self, y, f):
        return y - torch.exp(f)

    def hessian(self, y, f):
        return torch.exp(f)

    def deviance(self, w, y, f):
        mu = torch.clamp_min(torch.exp(f), EPS)
        ylogy = torch.where(y > 0, y * torch.log(torch.clamp_min(y, EPS) / mu),
                            torch.zeros_like(y))
        return 2.0 * w * (ylogy - (y - mu))


class Gamma(_LogLink):
    name = "gamma"

    def gradient(self, y, f):
        return y * torch.exp(-f) - 1.0

    def hessian(self, y, f):
        return y * torch.exp(-f)

    def deviance(self, w, y, f):
        mu = torch.clamp_min(torch.exp(f), EPS)
        ys = torch.clamp_min(y, EPS)
        return 2.0 * w * (-torch.log(ys / mu) + (ys - mu) / mu)


class Tweedie(_LogLink):
    name = "tweedie"

    def __init__(self, power: float = 1.5):
        if not 1.0 < power < 2.0:
            raise ValueError(f"tweedie_power must lie in (1, 2), got {power}")
        self.p = power

    def gradient(self, y, f):
        p = self.p
        return y * torch.exp(f * (1 - p)) - torch.exp(f * (2 - p))

    def hessian(self, y, f):
        p = self.p
        return ((p - 1) * y * torch.exp(f * (1 - p)) +
                (2 - p) * torch.exp(f * (2 - p)))

    def deviance(self, w, y, f):
        p = self.p
        mu = torch.clamp_min(torch.exp(f), EPS)
        return 2.0 * w * (
            torch.clamp_min(y, 0.0) ** (2 - p) / ((1 - p) * (2 - p))
            - y * mu ** (1 - p) / (1 - p) + mu ** (2 - p) / (2 - p))


class Laplace(Distribution):
    name = "laplace"

    def gradient(self, y, f):
        return torch.sign(y - f)

    def deviance(self, w, y, f):
        return w * torch.abs(y - f)


class QuantileDist(Distribution):
    name = "quantile"

    def __init__(self, alpha: float = 0.5):
        self.alpha = alpha

    def gradient(self, y, f):
        return torch.where(y > f, torch.full_like(f, self.alpha),
                           torch.full_like(f, self.alpha - 1.0))

    def deviance(self, w, y, f):
        d = y - f
        return w * torch.where(d > 0, self.alpha * d, (self.alpha - 1) * d)


class Huber(Distribution):
    name = "huber"

    def __init__(self, delta: float = 1.0):
        self.delta = delta

    def gradient(self, y, f):
        return torch.clamp(y - f, -self.delta, self.delta)

    def deviance(self, w, y, f):
        d = torch.abs(y - f)
        return w * torch.where(d <= self.delta, 0.5 * d * d,
                               self.delta * (d - 0.5 * self.delta))


_FAMILIES = {
    "gaussian": Gaussian, "bernoulli": Bernoulli, "binomial": Bernoulli,
    "multinomial": Multinomial, "poisson": Poisson, "gamma": Gamma,
    "laplace": Laplace, "huber": Huber,
}

#: families whose leaf values are Newton steps wg / wh (the rest take the
#: mean residual wg / w), ``h2o_tpu/models/tree/gbm.py:254-255``
FIRST_ORDER = ("gaussian", "laplace", "quantile", "huber")


def get_distribution(name: str, **kw) -> Distribution:
    """The family ``name``; ``tweedie_power``, ``quantile_alpha`` and
    ``huber_alpha`` parametrise tweedie, quantile and huber (huber's
    alpha is used as its delta, as in the reference)."""
    name = name.lower()
    if name == "auto":
        raise ValueError("resolve AUTO before calling get_distribution")
    if name == "custom":
        raise ValueError("distribution='custom' requires "
                         "custom_distribution_func")
    if name == "tweedie":
        return Tweedie(kw.get("tweedie_power", 1.5))
    if name == "quantile":
        return QuantileDist(kw.get("quantile_alpha", 0.5))
    if name == "huber":
        return Huber(kw.get("huber_alpha", 1.0))
    if name not in _FAMILIES:
        raise ValueError(f"unknown distribution {name!r}")
    return _FAMILIES[name]()


#: the builder params that parametrise a family
FAMILY_PARAMS = ("tweedie_power", "quantile_alpha", "huber_alpha")


def distribution_from_params(name: str, params: Dict) -> Distribution:
    """The family ``name`` with the family parameters a builder's
    ``params`` set (absent ones take ``get_distribution``'s defaults);
    ``"custom"`` is the user's ``custom_distribution_func``."""
    if name.lower() == "custom":
        ref = params.get("custom_distribution_func")
        if not ref:
            raise ValueError("distribution='custom' requires "
                             "custom_distribution_func")
        from h2o_tpu_torch.core.udf import load_custom_distribution
        return load_custom_distribution(ref)
    return get_distribution(name, **{k: float(params[k])
                                     for k in FAMILY_PARAMS
                                     if params.get(k) is not None})
