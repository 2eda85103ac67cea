"""RuleFit — port of ``h2o_tpu/models/rulefit.py`` (``_terminal_nodes``
:29-52, ``_describe_rule`` :55-90, ``RuleFitModel`` :93-144, ``RuleFit``
:147-264): a sparse linear model over tree-derived rules.

Rule forests are the port's DRF (or GBM with ``algorithm="GBM"``) at
each depth of ``min_rule_length..max_rule_length``, with
``rule_generation_ntrees`` split evenly over the depths and
``histogram_type="QuantilesGlobal"`` pinned, so on the card the
histogram kernel K1 (``hist_cuda``) builds every level of every rule
tree.  Each leaf a tree reaches with support strictly between 0 and 1
becomes a 0/1 rule column (``rule.d<depth>.t<tree>.n<heap node>``),
found by one heap descent of the binned rows per tree on the device
(``_terminal_nodes``); ``rules_and_linear`` (the default) and
``linear`` append each numeric column as ``linear.<col>`` (NAs as 0).
An L1 GLM (alpha 1, lambda 1e-3 unless given, standardized) over those
columns gives the rule importance: the rules and linear terms with a
non-zero coefficient, largest |coefficient| first, with their support
and their conditions as text.

A multiclass response raises before training: the reference reads one
coefficient vector (``GLMModel.coef``) and fails on a multinomial GLM.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.core.frame import Frame, Vec
from h2o_tpu_torch.models.glm import GLM, GLMModel, glm_from_jax_output
from h2o_tpu_torch.models.model import DataInfo, Model, ModelBuilder
from h2o_tpu_torch.models.tree import shared_tree as st
from h2o_tpu_torch.ops.binpack import widen_bins


def _terminal_nodes(bins: torch.Tensor, split_col: torch.Tensor,
                    bitset: torch.Tensor, depth: int) -> torch.Tensor:
    """(R, T) heap index of each row's terminal node in every tree of
    (T, H) split columns and (T, H, B+1) left-membership bitsets."""
    R, T = bins.shape[0], split_col.shape[0]
    out = torch.empty((R, T), dtype=torch.long, device=bins.device)
    for t in range(T):
        sc, bs = split_col[t].long(), bitset[t]
        node = torch.zeros(R, dtype=torch.long, device=bins.device)
        for _ in range(depth):
            c = sc[node]
            b = widen_bins(torch.gather(bins, 1, c.clamp_min(0)[:, None])
                           [:, 0]).long()
            nxt = 2 * node + torch.where(bs[node, b], 1, 2)
            node = torch.where(c < 0, node, nxt)
        out[:, t] = node
    return out


def _describe_rule(node: int, sc, bs, xs, split_points, is_cat,
                   domains) -> str:
    """The root path's conditions of a heap node, joined by ``&``."""
    conds = []
    n = node
    while n > 0:
        parent = (n - 1) // 2
        went_left = (n == 2 * parent + 1)
        c = int(sc[parent])
        if c >= 0:
            bits_left = bs[parent]                # (B+1,) left-membership
            bits = bits_left if went_left else ~bits_left
            col = xs[c]
            if is_cat[c]:
                dom = domains.get(col, [])
                levels = [dom[b] for b in range(min(len(dom), len(bits) - 1))
                          if bits[b]]
                cond = f"{col} in {{{', '.join(levels)}}}"
            else:
                sp = split_points[c]
                # the split index from the un-flipped prefix bitset
                k = int(bits_left[:-1].sum()) - 1
                thr = sp[k] if 0 <= k < len(sp) and np.isfinite(sp[k]) \
                    else None
                op = "<" if went_left else ">="
                cond = f"{col} {op} {thr:.6g}" if thr is not None \
                    else f"{col} {op} ?"
            if bits[-1]:
                cond += " or NA"
            conds.append(cond)
        n = parent
    return " & ".join(reversed(conds)) if conds else "(root)"


class RuleFitModel(Model):
    algo = "rulefit"

    def _rule_frame(self, frame: Frame) -> Frame:
        """The rule and linear columns the inner GLM reads."""
        out = self.output
        dev = self.device
        m = frame.as_matrix(out["x"], dev)
        bins = st.bin_matrix(m, out["split_points"], out["is_cat"],
                             int(out["nbins"]))
        names: List[str] = []
        cols: List[Vec] = []
        for f in out["forests"]:
            nodes = _terminal_nodes(
                bins, torch.as_tensor(np.asarray(f["split_col"]),
                                      device=dev),
                torch.as_tensor(np.asarray(f["bitset"]), device=dev),
                int(f["depth"]))
            if not f["rule_nodes"]:
                continue
            t_idx = torch.tensor([t for t, _ in f["rule_nodes"]], device=dev)
            h_idx = torch.tensor([h for _, h in f["rule_nodes"]], device=dev)
            hits = (nodes[:, t_idx] == h_idx[None, :]).to(
                torch.float32).cpu().numpy()
            names += f["rule_names"]
            cols += [Vec(hits[:, j]) for j in range(hits.shape[1])]
        rf = Frame(names, cols)
        for c in out["linear_names"]:
            rf.add(f"linear.{c}", Vec(np.nan_to_num(frame.vec(c).as_float())))
        return rf

    def _inner(self) -> GLMModel:
        return GLMModel(self.output["glm_params"], self.output["glm_output"],
                        self.device)

    def predict_raw(self, frame: Frame) -> torch.Tensor:
        return self._inner().predict_raw(self._rule_frame(frame))

    def rule_importance(self, use_pandas: bool = False):
        """(rule_id, coefficient, support, rule) rows, largest
        |coefficient| first; a pandas DataFrame with ``use_pandas``."""
        rows = self.output["rule_importance"]
        if use_pandas:
            import pandas as pd
            return pd.DataFrame(rows, columns=[
                "rule_id", "coefficient", "support", "rule"])
        return rows


def rulefit_from_jax_output(output: Dict, params: Dict,
                            device: DeviceLike = None) -> RuleFitModel:
    """The port's ``RuleFitModel`` from an ``h2o_tpu`` RuleFit's output
    dict (arrays as numpy), its inner GLM carried by
    ``glm_from_jax_output``."""
    dev = cloud(device)
    inner = glm_from_jax_output(output["glm_output"], output["glm_params"],
                                device=dev)
    dom = output.get("response_domain")
    out = dict(
        x=list(output["x"]),
        split_points=np.array(output["split_points"], np.float32),
        is_cat=np.array(output["is_cat"], bool),
        nbins=int(output["nbins"]),
        forests=[dict(split_col=np.array(f["split_col"], np.int32),
                      bitset=np.array(f["bitset"], bool),
                      depth=int(f["depth"]),
                      rule_nodes=[(int(t), int(h))
                                  for t, h in f["rule_nodes"]],
                      rule_names=list(f["rule_names"]))
                 for f in output["forests"]],
        linear_names=list(output["linear_names"]),
        response_domain=list(dom) if dom is not None else None,
        glm_params=dict(output["glm_params"]), glm_output=inner.output,
        rule_importance=[tuple(r) for r in output["rule_importance"]])
    return RuleFitModel(dict(params), out, dev)


class RuleFit(ModelBuilder):
    algo = "rulefit"
    model_cls = RuleFitModel

    def default_params(self) -> Dict:
        p = super().default_params()
        p.update(algorithm="AUTO", min_rule_length=3, max_rule_length=3,
                 max_num_rules=-1, model_type="rules_and_linear",
                 rule_generation_ntrees=50, lambda_=None)
        return p

    def _rule_forest(self, depth: int, ntrees: int, x: List[str], y: str,
                     train: Frame) -> Dict:
        """The rule trees of one depth, as a host forest dict."""
        from h2o_tpu_torch.models.tree.drf import DRF
        from h2o_tpu_torch.models.tree.gbm import GBM
        p = self.params
        gbm = (p.get("algorithm") or "AUTO").upper() == "GBM"
        cls = GBM if gbm else DRF
        tm = cls(device=self.device, response_column=y, ntrees=ntrees,
                 max_depth=depth,
                 seed=int(p.get("seed") or -1),
                 histogram_type="QuantilesGlobal",
                 **({"learn_rate": 0.1} if gbm else {"sample_rate": 0.632}))
        to = tm._fit(x, y, train, None).output
        if to.get("child") is not None:
            raise ValueError(
                "RuleFit rule generation needs dense-heap trees; "
                f"max_rule_length={depth} exceeded the frontier cap — "
                "lower max_rule_length")
        sc = np.asarray(to["split_col"])
        bs = np.asarray(to["bitset"])
        return dict(split_col=sc.reshape(-1, sc.shape[2]),
                    bitset=bs.reshape(-1, *bs.shape[2:]), depth=depth)

    def _fit(self, x: List[str], y: str, train: Frame,
             valid: Optional[Frame] = None) -> RuleFitModel:
        p = self.params
        st.check_slice("rulefit", dict(p, ntrees=1))
        dev = self.device
        di = DataInfo(train, x, y, dev, weights=p.get("weights_column"))
        nclass = di.nclasses
        if nclass > 2:
            raise ValueError(
                "rulefit: a multiclass response is not supported — the "
                "rule importance reads one coefficient vector, which a "
                "multinomial GLM does not have (the reference fails there)")
        depths = list(range(int(p["min_rule_length"]),
                            int(p["max_rule_length"]) + 1))
        ntrees = max(1, int(p["rule_generation_ntrees"]) // len(depths))
        model_type = (p.get("model_type") or "rules_and_linear").lower()

        binned = st.prepare_bins(di, 20, 1024)
        forests, support_total = [], []
        nrows = train.nrows
        for depth in depths:
            f = self._rule_forest(depth, ntrees, list(di.x), y, train)
            nodes = _terminal_nodes(
                binned.bins, torch.as_tensor(f["split_col"], device=dev),
                torch.as_tensor(f["bitset"], device=dev), depth)
            H = f["split_col"].shape[1]
            counts = torch.stack([torch.bincount(nodes[:, t], minlength=H)
                                  for t in range(nodes.shape[1])]
                                 ).cpu().numpy()                 # (T, H)
            rule_nodes, rule_names = [], []
            for t in range(counts.shape[0]):
                for h in np.flatnonzero(counts[t]):
                    sup = float(counts[t, h] / nrows)
                    if sup <= 0.0 or sup >= 1.0:
                        continue
                    rule_nodes.append((int(t), int(h)))
                    rule_names.append(f"rule.d{depth}.t{t}.n{h}")
                    support_total.append(sup)
            forests.append(dict(f, rule_nodes=rule_nodes,
                                rule_names=rule_names))

        linear_names = list(di.num_names) \
            if model_type in ("rules_and_linear", "linear") else []
        out_proto = dict(x=list(di.x), split_points=binned.split_points,
                         is_cat=binned.is_cat, nbins=binned.nbins,
                         forests=forests, linear_names=linear_names,
                         response_domain=di.response_domain
                         if nclass >= 2 else None)
        proto = self.model_cls(dict(p), out_proto, dev)
        rf = proto._rule_frame(train)
        rf.add(y, train.vec(y))
        wc = p.get("weights_column")
        if wc:
            rf.add(wc, train.vec(wc))

        lam = p.get("lambda_")
        glm = GLM(device=dev, family="binomial" if nclass == 2 else
                  "gaussian", alpha=1.0,
                  lambda_=lam if lam is not None else 1e-3,
                  standardize=True, seed=p.get("seed", -1),
                  weights_column=wc)
        inner = glm._fit([n for n in rf.names if n not in (y, wc)], y, rf,
                         None)

        coef = inner.coef()
        rules_flat = []
        domains = {c: list(train.vec(c).domain) for c in di.cat_names}
        i = 0
        for f in forests:
            for (t, h), name in zip(f["rule_nodes"], f["rule_names"]):
                beta = float(coef.get(name, 0.0))
                if abs(beta) > 1e-12:
                    desc = _describe_rule(h, f["split_col"][t],
                                          f["bitset"][t], list(di.x),
                                          binned.split_points,
                                          binned.is_cat, domains)
                    rules_flat.append((name, beta, support_total[i], desc))
                i += 1
        for c in linear_names:
            beta = float(coef.get(f"linear.{c}", 0.0))
            if abs(beta) > 1e-12:
                rules_flat.append((f"linear.{c}", beta, 1.0, c))
        rules_flat.sort(key=lambda r: -abs(r[1]))
        max_rules = int(p.get("max_num_rules") or -1)
        if max_rules > 0:
            rules_flat = rules_flat[:max_rules]

        out = dict(out_proto, glm_params=inner.params,
                   glm_output=inner.output, rule_importance=rules_flat,
                   training_metrics=inner.output.get("training_metrics"))
        model = self.model_cls(dict(p), out, dev)
        model.params["response_column"] = y
        if valid is not None:
            model.output["validation_metrics"] = model.model_metrics(valid)
        return model
