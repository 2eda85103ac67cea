"""Distribution families for boosting — port of
``h2o_tpu/models/distributions.py`` (``Distribution``/``Gaussian``/
``Bernoulli`` :20-89, ``get_distribution`` :232-242).

gradient/hessian are taken with respect to f, the link-scale
prediction: residual r = -dL/df, Newton denominator h = d2L/df2.  All
functions are elementwise float32 tensor code; formulas are written as
in the reference (e.g. ``1 / (1 + exp(-f))``, not ``torch.sigmoid``) so
the two round alike.

Only gaussian and bernoulli are in this slice; the other families (and
multinomial) raise ``NotImplementedError`` until the slice that ports
the rest of the distributions.
"""

from __future__ import annotations

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


_FAMILIES = {"gaussian": Gaussian, "bernoulli": Bernoulli,
             "binomial": Bernoulli}


def get_distribution(name: str, **kw) -> Distribution:
    name = name.lower()
    if name == "auto":
        raise ValueError("resolve AUTO before calling get_distribution")
    if name not in _FAMILIES:
        raise NotImplementedError(
            f"distribution {name!r} is not in this slice of the port "
            "(gaussian and bernoulli only); multinomial and the other "
            "families come with the slice that ports the rest of "
            "models/distributions.py")
    return _FAMILIES[name]()
