"""AnovaGLM — port of ``h2o_tpu/models/anovaglm.py`` (``_chi2_sf``
:26-62, ``_deviance`` :65-75, ``AnovaGLMModel`` :78-94, ``AnovaGLM``
:97-161).

A type-III analysis of deviance: the port's GLM (``lambda_``, no
standardization) on every term, then once without each term; a term's
statistic is the deviance its removal adds (divided by the full model's
dispersion for gaussian), with the coefficients it removes as degrees
of freedom, and its p-value the chi-square tail, copied from the
reference (series or Lentz continued fraction, no scipy).  With
``highest_interaction_term`` >= 2 each pair of predictors adds a term,
the product of the two NaN-as-0 columns in float32.  The GLMs' data
passes run on the model's device, their solves on the host.

The reference puts the full GLM in the DKV (``:156-157``); the port
keeps it as ``output["full_model"]`` (P13 brings the DKV), with the
full and each drop-one model's residual deviance and the dispersion.
``predict_raw`` raises, as the reference's does.  Iteration checkpoints
(P14) are refused.
"""

from __future__ import annotations

from itertools import combinations
from typing import Dict, List, Optional

import numpy as np

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.core.frame import Frame, Vec
from h2o_tpu_torch.models import metrics as mm
from h2o_tpu_torch.models.glm import GLM, glm_from_jax_output
from h2o_tpu_torch.models.model import DataInfo, Model, ModelBuilder


def _chi2_sf(x: float, df: int) -> float:
    """Chi-square survival function via the regularized upper gamma
    (scipy-free; series/continued-fraction like Numerical Recipes)."""
    from math import exp, lgamma, log
    if x <= 0 or df <= 0:
        return 1.0
    a, half = df / 2.0, x / 2.0
    if half < a + 1:
        # lower series
        term = 1.0 / a
        total = term
        for n in range(1, 500):
            term *= half / (a + n)
            total += term
            if abs(term) < abs(total) * 1e-12:
                break
        p_lower = total * exp(-half + a * log(half) - lgamma(a))
        return max(0.0, 1.0 - p_lower)
    # upper continued fraction (Lentz)
    tiny = 1e-300
    b = half + 1.0 - a
    c = 1.0 / tiny
    d = 1.0 / b
    h = d
    for i in range(1, 500):
        an = -i * (i - a)
        b += 2.0
        d = an * d + b
        d = tiny if abs(d) < tiny else d
        c = b + an / c
        c = tiny if abs(c) < tiny else c
        d = 1.0 / d
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < 1e-12:
            break
    return max(0.0, min(1.0, exp(-half + a * log(half) - lgamma(a)) * h))


def _deviance(model) -> float:
    """Total residual deviance (GLM stores it; else rebuilt from the mean
    metrics: binomial deviance = 2 * logloss * n)."""
    rd = model.output.get("residual_deviance")
    if rd is not None:
        return float(rd)
    tm = model.output["training_metrics"]
    if tm.get("logloss") is not None and tm.get("nobs"):
        return 2.0 * float(tm["logloss"]) * float(tm["nobs"])
    mrd = tm.get("mean_residual_deviance") or tm.get("mse")
    return float(mrd) * float(tm.get("nobs") or 1.0)


class AnovaGLMModel(Model):
    algo = "anovaglm"

    def result(self, use_pandas: bool = False):
        """The table's rows (term, df, deviance, p_value)."""
        rows = self.output["anova_table"]
        if use_pandas:
            import pandas as pd
            return pd.DataFrame(rows, columns=[
                "term", "df", "deviance", "p_value"])
        return rows

    def predict_raw(self, frame: Frame):
        raise NotImplementedError("ANOVA-GLM is an analysis, not a scorer")

    def model_metrics(self, frame: Frame = None) -> mm.ModelMetrics:
        return mm.anovaglm_metrics(r[0] for r in self.output["anova_table"])


def anovaglm_from_jax_output(output: Dict, params: Dict,
                             full_glm_output: Dict,
                             device: DeviceLike = None) -> AnovaGLMModel:
    """The port's ``AnovaGLMModel`` from an ``h2o_tpu`` AnovaGLM's
    output dict; ``full_glm_output`` is the output dict (arrays as numpy)
    of the full GLM the reference put in its DKV."""
    dev = cloud(device)
    out = dict(anova_table=[(str(t), int(df), float(d), float(pv))
                            for t, df, d, pv in output["anova_table"]],
               family=output["family"], x=list(output["x"]),
               full_model=glm_from_jax_output(full_glm_output, dict(params),
                                              dev))
    model = AnovaGLMModel(dict(params), out, dev)
    out["training_metrics"] = model.model_metrics()
    return model


class AnovaGLM(ModelBuilder):
    algo = "anovaglm"
    model_cls = AnovaGLMModel
    supports_cv = False

    def default_params(self) -> Dict:
        p = super().default_params()
        p.update(family="AUTO", highest_interaction_term=1, lambda_=0.0)
        return p

    def _fit(self, x: List[str], y: str, train: Frame,
             valid: Optional[Frame] = None) -> AnovaGLMModel:
        self.refuse_iteration_checkpoints()
        p = self.params
        dev = self.device
        di = DataInfo(train, x, y, dev, mode="tree")
        family = p.get("family", "AUTO")
        if family in (None, "AUTO"):
            family = "binomial" if di.nclasses == 2 else "gaussian"
        preds = list(di.x)
        seed = p.get("seed", -1)

        # interaction columns: products of the NaN-as-0 pairs
        work = Frame(list(train.names), list(train.vecs))
        terms: List[Dict] = [dict(name=c, cols=[c]) for c in preds]
        if int(p.get("highest_interaction_term") or 1) >= 2:
            for a, b in combinations(preds, 2):
                nm = f"{a}:{b}"
                va = np.nan_to_num(train.vec(a).as_float())
                vb = np.nan_to_num(train.vec(b).as_float())
                work.add(nm, Vec(va * vb))
                terms.append(dict(name=nm, cols=[nm]))
        all_cols = [c for t in terms for c in t["cols"]]

        def fit(sub: List[str]):
            glm = GLM(device=dev, family=family,
                      lambda_=float(p.get("lambda_") or 0.0),
                      standardize=False, seed=seed)
            return glm._fit(sub, y, work, None)

        full = fit(all_cols)
        dev_full = _deviance(full)
        ncoef_full = len(full.coef())
        nobs = float(full.output["training_metrics"].get("nobs")
                     or train.nrows)
        # gaussian deviance differences are SSE in response units; divide
        # by the full model's dispersion so the statistic is ~chi-square
        disp = max(dev_full / max(nobs - ncoef_full, 1.0), 1e-30) \
            if family == "gaussian" else 1.0
        table, term_dev = [], []
        for i, t in enumerate(terms):
            self._update(0.1 + 0.8 * i / len(terms), f"drop {t['name']}")
            m = fit([c for c in all_cols if c not in t["cols"]])
            term_dev.append(_deviance(m))
            dd = max(term_dev[-1] - dev_full, 0.0) / disp
            df = max(ncoef_full - len(m.coef()), 1)
            table.append((t["name"], df, dd, _chi2_sf(dd, df)))

        out = dict(anova_table=table, family=family, x=preds,
                   full_model=full, full_deviance=dev_full,
                   term_deviances=term_dev, dispersion=disp,
                   glm_fits=len(terms) + 1)
        model = self.model_cls(dict(p, response_column=y), out, dev)
        out["training_metrics"] = model.model_metrics()
        return model
