"""DeepLearning — port of ``h2o_tpu/models/deeplearning.py`` (``_act``
:37-40, ``init_params`` :43-55, ``mlp_forward`` :94-109, ``_loss_fn``
:112-144, ``_train_block_impl`` :170-247, ``DeepLearningModel``
:250-316, ``DeepLearning`` :319-496): a multi-layer perceptron, and its
autoencoder, trained by synchronous minibatch steps.

The reference scans a block of up to 200 steps in one dispatch; the
port runs the same steps from a Python loop on the model's device, the
gradient by ``torch.autograd`` over the batched MLP (full GEMMs), the
optimizer updates as tensor arithmetic.  The draws are jax's, bit for
bit (``ops/prng.py``): a step's keys are ``split(key, 3)`` of the
running key, its minibatch ``randint(kb, (batch,), 0, nrows)`` and its
dropout masks ``bernoulli`` under ``split`` of ``kd``; the block's
minibatch indices and each layer's dropout masks are drawn at once
(``prng.randint_rows``, ``prng.bernoulli_rows``), and each block's key
is ``split`` of the last.  ADADELTA runs as ``_foreach`` ops over all
the layers' tensors.  So the port trains on the
reference's minibatches; only float rounding differs.

The batch is ``min(max(1024, mini_batch_size), R)`` with R the
reference's padded row count (``statpack.padded_rows``), as the
reference caps it at ``X.shape[0]``: a 1,000-row frame draws batches of
1,024 rows.  ``Maxout`` runs as Rectifier (with the reference's warning)
and ``model_parallel`` on one device is the identity, as on the
reference's one-wide model axis.  ``export_weights_and_biases``
publishes each layer's weight and bias frames in ``store.dkv()``
(``{model_id}_weights_{i}``, ``{model_id}_biases_{i}``).  Each block of
steps reports progress to the build's job (its heartbeat, and where a
cancel lands).  With a ``recovery_dir`` (``models/model.py``) each block
ends in an iteration checkpoint (weights, optimizer state, key; the
reference's ``deeplearning.py:414-460``) from which a resumed build
continues.  Refused by name: ``model_parallel`` over several cards
(P8).  No histogram kernel: DeepLearning reaches no Pallas kernel in
the reference either.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.core.frame import Frame, Vec
from h2o_tpu_torch.models import metrics as mm
from h2o_tpu_torch.models.distributions import get_distribution
from h2o_tpu_torch.models.glm import expand_for_scoring, expansion_spec
from h2o_tpu_torch.models.model import (DataInfo, Model, ModelBuilder,
                                        publish)
from h2o_tpu_torch.ops import prng, statpack

EPS = 1e-10
BLOCK_STEPS = 200


def _act(name: str):
    name = name.lower().replace("withdropout", "")
    return {"rectifier": torch.relu, "tanh": torch.tanh,
            "maxout": torch.relu}[name]  # maxout approximated by relu


def init_params(key, layer_sizes: List[int], device) -> List[Dict]:
    """UniformAdaptive: W ~ U(+-sqrt(6 / (fan_in + fan_out))), b = 0."""
    params = []
    for i in range(len(layer_sizes) - 1):
        key, sub = prng.split(key)
        fan_in, fan_out = layer_sizes[i], layer_sizes[i + 1]
        lim = float(np.sqrt(6.0 / (fan_in + fan_out)))
        W = prng.uniform(sub, (fan_in, fan_out), device, -lim, lim)
        b = torch.zeros(fan_out, dtype=torch.float32, device=device)
        params.append({"W": W, "b": b})
    return params


def _tree_map(fn, obj):
    """``fn`` over the leaves of nested lists and dicts."""
    if isinstance(obj, dict):
        return {k: _tree_map(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_tree_map(fn, v) for v in obj]
    return fn(obj)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` by a float32 tensor: a CUDA tensor divided by a number
    is multiplied by its reciprocal, which the CPU does not do."""
    return x / torch.full_like(x, float(np.float32(c)))


def _keep(h: torch.Tensor, keep: torch.Tensor, ratio: float) -> torch.Tensor:
    return torch.where(keep, _div(h, 1 - ratio), torch.zeros_like(h))


def _dropout_keys(dropout_key, input_dropout: float, hidden_dropout: float,
                  n_hidden: int) -> List:
    """The subkeys ``mlp_forward`` draws its masks under: the input's
    (None without input dropout), then each hidden layer's."""
    keys = [None]
    if input_dropout > 0:
        dropout_key, keys[0] = prng.split(dropout_key)
    for _ in range(n_hidden if hidden_dropout > 0 else 0):
        dropout_key, sub = prng.split(dropout_key)
        keys.append(sub)
    return keys


def mlp_forward(params, X: torch.Tensor, activation: str,
                input_dropout: float = 0.0, hidden_dropout: float = 0.0,
                masks=None) -> torch.Tensor:
    """The MLP's output; ``masks`` are the dropout keep-masks (the
    input's or None, then each hidden layer's), the reference's
    ``bernoulli`` draws under its dropout key's ``split`` chain, drawn
    ahead for a block of steps (``train_block``)."""
    masks = masks or [None]
    h = X if masks[0] is None else _keep(X, masks[0], input_dropout)
    act = _act(activation)
    for i, layer in enumerate(params):
        h = h @ layer["W"] + layer["b"]
        if i < len(params) - 1:
            h = act(h)
            if i + 1 < len(masks):
                h = _keep(h, masks[i + 1], hidden_dropout)
    return h


def _loss_fn(params, X, y, w, activation: str, nclass: int, dist_name: str,
             l1: float, l2: float, masks, input_dropout: float,
             hidden_dropout: float) -> torch.Tensor:
    """nclass >= 2: weighted cross-entropy; 1: the distribution's
    deviance; 0: the autoencoder's weighted reconstruction MSE (target X).
    Plus l1 |W| and l2 / 2 W^2 over every layer's weights."""
    out = mlp_forward(params, X, activation, input_dropout=input_dropout,
                      hidden_dropout=hidden_dropout, masks=masks)
    wsum = torch.clamp_min(torch.sum(w), EPS)
    if nclass == 0:
        loss = torch.sum(w * torch.sum((out - X) ** 2, dim=1)) / wsum
    elif nclass >= 2:
        logp = torch.log_softmax(out, dim=1)
        yi = torch.clamp(y.to(torch.int64), 0, nclass - 1)
        ce = -torch.gather(logp, 1, yi[:, None])[:, 0]
        loss = torch.sum(w * ce) / wsum
    else:
        loss = torch.sum(get_distribution(dist_name).deviance(
            w, y, out[:, 0])) / wsum
    if l1 > 0 or l2 > 0:
        for layer in params:
            loss = loss + l1 * torch.sum(torch.abs(layer["W"])) + \
                0.5 * l2 * torch.sum(layer["W"] ** 2)
    return loss


def _step_keys(key, n: int):
    """The scan's per-step keys: (next key, batch keys, dropout keys)."""
    kbs, kds = [], []
    for _ in range(n):
        key, kb, kd = prng.split(key, 3)
        kbs.append(kb)
        kds.append(kd)
    return kbs, kds


def _adadelta(p: List, g: List, eg2: List, edx2: List, rho: float,
              epsilon: float):
    """ADADELTA over lists of tensors, as ``rho * eg2 + (1 - rho) * g * g``,
    ``dx = -sqrt(edx2 + eps) / sqrt(eg2 + eps) * g``, ``rho * edx2 + (1 -
    rho) * dx * dx`` and ``p + dx`` compute elementwise, in ``_foreach``
    ops (a few launches for all the layers)."""
    fe = torch
    eg2 = fe._foreach_add(fe._foreach_mul(eg2, rho), fe._foreach_mul(
        fe._foreach_mul(g, 1 - rho), g))
    num = fe._foreach_sqrt(fe._foreach_add(edx2, epsilon))
    fe._foreach_neg_(num)
    dx = fe._foreach_mul(fe._foreach_div(
        num, fe._foreach_sqrt(fe._foreach_add(eg2, epsilon))), g)
    edx2 = fe._foreach_add(fe._foreach_mul(edx2, rho), fe._foreach_mul(
        fe._foreach_mul(dx, 1 - rho), dx))
    return fe._foreach_add(p, dx), eg2, edx2


def _momentum_scalars(t0: int, i: int, cfg: Dict):
    """(learning rate, momentum) of step ``t0 + i`` in float32, as the
    reference's scan computes them from its float32 step counter."""
    f = np.float32
    t = f(f(t0) + f(i)) * f(cfg["batch"])
    lr = f(cfg["rate"]) / (f(1) + f(cfg["rate_annealing"]) * t)
    ramp = f(max(cfg["momentum_ramp"], 1.0))
    ms, mt = f(cfg["momentum_start"]), f(cfg["momentum_stable"])
    mo = mt if t > ramp else ms + (mt - ms) * t / ramp
    return float(lr), float(mo)


def train_block(params, opt_state, X, y, w, key, t0: int, n_steps: int,
                cfg: Dict):
    """``n_steps`` optimizer steps from the block key ``key``; returns
    (params, opt_state, the last step's loss as a 0-d tensor)."""
    dev = X.device
    batch = cfg["batch"]
    kbs, kds = _step_keys(key, n_steps)
    idx_all = prng.randint_rows(kbs, batch, 0, cfg["nrows"], dev)
    # the block's dropout masks in one draw a layer: step i's row of
    # each is bernoulli(k, p, (batch, width)) under its key chain
    masks_all = None
    if cfg["input_dropout"] > 0 or cfg["hidden_dropout"] > 0:
        chains = [_dropout_keys(kd, cfg["input_dropout"],
                                cfg["hidden_dropout"], len(params) - 1)
                  for kd in kds]
        widths = [X.shape[1]] + [l["W"].shape[1] for l in params[:-1]]
        masks_all = [None if chains[0][j] is None else prng.bernoulli_rows(
            [c[j] for c in chains],
            1 - (cfg["input_dropout"] if j == 0 else cfg["hidden_dropout"]),
            batch * widths[j], dev).reshape(n_steps, batch, widths[j])
            for j in range(len(chains[0]))]
    loss = None
    for i in range(n_steps):
        idx = idx_all[i]
        flat = [t.requires_grad_(True) for layer in params
                for t in (layer["W"], layer["b"])]
        masks = None if masks_all is None else \
            [None if m is None else m[i] for m in masks_all]
        loss = _loss_fn(params, X[idx], y[idx], w[idx], cfg["activation"],
                        cfg["nclass"], cfg["dist_name"], cfg["l1"],
                        cfg["l2"], masks, cfg["input_dropout"],
                        cfg["hidden_dropout"])
        grads = torch.autograd.grad(loss, flat)
        with torch.no_grad():
            new_params, new_state = [], []
            if cfg["adaptive"]:
                keys = [(j, k) for j in range(len(params)) for k in "Wb"]
                ps, eg2, edx2 = _adadelta(
                    [params[j][k] for j, k in keys], list(grads),
                    [opt_state[j][k]["eg2"] for j, k in keys],
                    [opt_state[j][k]["edx2"] for j, k in keys],
                    cfg["rho"], cfg["epsilon"])
                for j in range(len(params)):
                    new_params.append({"W": ps[2 * j], "b": ps[2 * j + 1]})
                    new_state.append(
                        {k: {"eg2": eg2[2 * j + o], "edx2": edx2[2 * j + o]}
                         for o, k in enumerate("Wb")})
            else:
                lr, mo = _momentum_scalars(t0, i, cfg)
                for j, (p, m) in enumerate(zip(params, opt_state)):
                    gW, gb = grads[2 * j], grads[2 * j + 1]
                    vW = mo * m["W"] - lr * gW
                    vb = mo * m["b"] - lr * gb
                    if cfg["nesterov"]:
                        W = p["W"] + mo * vW - lr * gW
                        b = p["b"] + mo * vb - lr * gb
                    else:
                        W, b = p["W"] + vW, p["b"] + vb
                    new_params.append({"W": W, "b": b})
                    new_state.append({"W": vW, "b": vb})
            if cfg["max_w2"] < 1e38:
                # rescale the incoming weights of a unit whose squared
                # norm exceeds max_w2
                for p in new_params:
                    ss = torch.sum(p["W"] ** 2, dim=0, keepdim=True)
                    scale = torch.where(
                        ss > cfg["max_w2"],
                        torch.sqrt(torch.full_like(ss, cfg["max_w2"]) / ss),
                        torch.ones_like(ss))
                    p["W"] = p["W"] * scale
        params, opt_state = new_params, new_state
    return params, opt_state, loss.detach()


def _weights_on(out: Dict, device) -> List[Dict]:
    return [{"W": torch.as_tensor(np.asarray(l["W"], np.float32),
                                  device=device),
             "b": torch.as_tensor(np.asarray(l["b"], np.float32),
                                  device=device)}
            for l in out["weights"]]


class DeepLearningModel(Model):
    algo = "deeplearning"

    def _reconstruct(self, frame: Frame):
        """The forward pass and the expanded input matrix."""
        out = self.output
        X = expand_for_scoring(frame, out["expansion_spec"], self.device)
        return mlp_forward(_weights_on(out, self.device), X,
                           out["activation"]), X

    def anomaly(self, frame: Frame, per_feature: bool = False) -> Frame:
        """Reconstruction error per row (``Reconstruction.MSE``) or per
        expanded feature (``reconstr_<name>.SE``)."""
        recon, X = self._reconstruct(frame)
        se = ((recon - X) ** 2)
        names = self.output["expansion_spec_names"]
        if per_feature:
            se = se.cpu().numpy()
            return Frame([f"reconstr_{n}.SE" for n in names],
                         [Vec(se[:, j]) for j in range(se.shape[1])])
        return Frame(["Reconstruction.MSE"],
                     [Vec(torch.mean(se, dim=1).cpu().numpy())])

    def reconstruction_mse(self, frame: Frame) -> float:
        recon, X = self._reconstruct(frame)
        se = torch.mean((recon - X) ** 2, dim=1)
        n = torch.full((1,), float(max(frame.nrows, 1)), device=se.device)
        return float(torch.sum(se) / n)

    def model_metrics(self, frame: Frame) -> mm.ModelMetrics:
        if self.output.get("autoencoder"):
            return mm.autoencoder_metrics(self.reconstruction_mse(frame))
        return super().model_metrics(frame)

    def predict(self, frame: Frame) -> Frame:
        if self.output.get("autoencoder"):
            recon = self._reconstruct(frame)[0].cpu().numpy()
            names = self.output["expansion_spec_names"]
            return Frame([f"reconstr_{n}" for n in names],
                         [Vec(recon[:, j]) for j in range(recon.shape[1])])
        return super().predict(frame)

    def predict_raw(self, frame: Frame) -> torch.Tensor:
        out = self.output
        o, _ = self._reconstruct(frame)
        if out.get("autoencoder"):
            return o
        dom = out.get("response_domain")
        if dom is None:
            return get_distribution(out["distribution_resolved"]).link_inv(
                o[:, 0])
        P = torch.softmax(o, dim=1)
        if len(dom) == 2:
            thr = float(out.get("default_threshold", 0.5))
            return torch.stack([(P[:, 1] >= thr).to(torch.float32),
                                P[:, 0], P[:, 1]], dim=1)
        label = torch.argmax(P, dim=1).to(torch.float32)
        return torch.cat([label[:, None], P], dim=1)


def deeplearning_from_jax_output(output: Dict, params: Dict,
                                 device: DeviceLike = None
                                 ) -> DeepLearningModel:
    """The port's ``DeepLearningModel`` from an ``h2o_tpu``
    DeepLearning's output dict (arrays as numpy): the layers' weights,
    the activation, the expansion and the response."""
    dev = cloud(device)
    out = {k: output[k] for k in ("activation", "hidden", "autoencoder",
                                  "distribution_resolved", "epochs_trained",
                                  "model_category") if k in output}
    dom = output.get("response_domain")
    out.update(x=list(output["x"]),
               expansion_spec=dict(output["expansion_spec"]),
               expansion_spec_names=list(output["expansion_spec_names"]),
               weights=[{"W": np.array(l["W"], np.float32),
                         "b": np.array(l["b"], np.float32)}
                        for l in output["weights"]],
               response_domain=list(dom) if dom is not None else None)
    return DeepLearningModel(dict(params), out, dev)


class DeepLearning(ModelBuilder):
    algo = "deeplearning"
    model_cls = DeepLearningModel

    # loss follows the resolved distribution; one learning-rate schedule
    ENGINE_FIXED = {
        "loss": ("Automatic", "CrossEntropy", "Quadratic"),
        "rate_decay": (1.0,),
    }

    @property
    def supervised(self):
        return not bool(self.params.get("autoencoder"))

    @property
    def supports_cv(self):
        return not bool(self.params.get("autoencoder"))

    def default_params(self) -> Dict:
        p = super().default_params()
        p.update(hidden=[200, 200], epochs=10.0, activation="Rectifier",
                 adaptive_rate=True, rho=0.99, epsilon=1e-8,
                 rate=0.005, rate_annealing=1e-6, rate_decay=1.0,
                 momentum_start=0.0, momentum_ramp=1e6, momentum_stable=0.0,
                 nesterov_accelerated_gradient=True,
                 input_dropout_ratio=0.0, hidden_dropout_ratios=None,
                 l1=0.0, l2=0.0, max_w2=3.4e38, loss="Automatic",
                 standardize=True, mini_batch_size=1,
                 train_samples_per_iteration=-2, score_interval=5.0,
                 use_all_factor_levels=True, autoencoder=False,
                 stopping_rounds=5, stopping_metric="AUTO",
                 stopping_tolerance=0.0, reproducible=False,
                 export_weights_and_biases=False, model_parallel=False)
        return p

    def _check_slice(self, p: Dict) -> None:
        if p.get("model_parallel") and self.device.type == "cuda" and \
                torch.cuda.device_count() > 1:
            raise NotImplementedError(
                "deeplearning: model_parallel over several cards needs the "
                "multi-GPU mesh (P8); on one device it is the identity")

    def _fit(self, x: List[str], y: Optional[str], train: Frame,
             valid: Optional[Frame] = None) -> DeepLearningModel:
        p = self.params
        self._check_slice(p)
        dev = self.device
        if "maxout" in str(p.get("activation", "")).lower():
            warnings.warn("activation='Maxout' is approximated by Rectifier "
                          "on this engine (models/deeplearning.py _act)")
        ae = bool(p.get("autoencoder"))
        di = DataInfo(train, x, None if ae else y, dev, mode="expanded",
                      weights=p.get("weights_column"),
                      standardize=bool(p["standardize"]),
                      use_all_factor_levels=bool(p["use_all_factor_levels"]),
                      impute_missing=True)
        X = di.matrix()
        w = di.weights()
        if ae:
            yv = torch.zeros(X.shape[0], dtype=torch.float32, device=dev)
            active = torch.ones(X.shape[0], dtype=torch.bool, device=dev)
            nclass, dist_name = 0, "gaussian"
        else:
            yv = di.response()
            active = di.valid_mask()
            nclass = di.nclasses
            dist_name = "gaussian" if nclass >= 2 else \
                self.resolve_distribution(di)
        n_in = X.shape[1]
        n_out = n_in if ae else (nclass if nclass >= 2 else 1)
        hidden = [int(h) for h in p["hidden"]]
        sizes = [n_in] + hidden + [n_out]
        key = self.rng_key()
        key, kinit = prng.split(key)
        params = init_params(kinit, sizes, dev)
        adaptive = bool(p["adaptive_rate"])
        if adaptive:
            opt_state = [{"W": {"eg2": torch.zeros_like(l["W"]),
                                "edx2": torch.zeros_like(l["W"])},
                          "b": {"eg2": torch.zeros_like(l["b"]),
                                "edx2": torch.zeros_like(l["b"])}}
                         for l in params]
        else:
            opt_state = [{"W": torch.zeros_like(l["W"]),
                          "b": torch.zeros_like(l["b"])} for l in params]

        nrows = train.nrows
        R = statpack.padded_rows(nrows)
        batch = int(min(max(1024, int(p["mini_batch_size"])), R))
        steps = max(1, int(float(p["epochs"]) * nrows / batch))
        yv_f = torch.where(active, torch.nan_to_num(yv),
                           torch.zeros_like(yv))
        w_act = torch.where(active, w, torch.zeros_like(w))
        activation = str(p["activation"])
        hdr = p["hidden_dropout_ratios"]
        hdrop = float(hdr[0]) if hdr else (
            0.5 if "withdropout" in activation.lower() else 0.0)
        cfg = dict(
            activation=activation, nclass=nclass, dist_name=dist_name,
            batch=batch, nrows=nrows, adaptive=adaptive,
            rho=float(p["rho"]), epsilon=float(p["epsilon"]),
            rate=float(p["rate"]), rate_annealing=float(p["rate_annealing"]),
            momentum_start=float(p["momentum_start"]),
            momentum_stable=float(p["momentum_stable"]),
            momentum_ramp=max(float(p["momentum_ramp"]), 1.0),
            l1=float(p["l1"]), l2=float(p["l2"]),
            input_dropout=float(p["input_dropout_ratio"]),
            hidden_dropout=hdrop,
            nesterov=bool(p["nesterov_accelerated_gradient"]),
            max_w2=float(p["max_w2"]))
        block = min(steps, BLOCK_STEPS)
        done = 0
        # a resumed build continues from the last block's checkpoint:
        # weights, optimizer state and key as they were
        rec = self._recovery
        if rec is not None:
            st = rec.load_iteration()
            if st and st.get("kind") == "dl" and \
                    st.get("steps") == steps and st.get("sizes") == sizes:
                done = int(st["done"])
                params = _tree_map(lambda a: torch.from_numpy(a).to(dev),
                                   st["params"])
                opt_state = _tree_map(
                    lambda a: torch.from_numpy(a).to(dev), st["opt"])
                key = st["key"]
                self._update(done / steps, f"resumed at step {done}/{steps}")
        while done < steps:
            n = min(block, steps - done)
            key, sub = prng.split(key)
            params, opt_state, loss = train_block(params, opt_state, X,
                                                  yv_f, w_act, sub, done, n,
                                                  cfg)
            done += n
            if self._job is not None:
                self._update(done / steps, f"step {done}/{steps} "
                                           f"loss={float(loss):.4f}")
            if rec is not None:
                rec.save_iteration(
                    {"kind": "dl", "steps": steps, "sizes": sizes,
                     "done": done, "params": _tree_map(_host, params),
                     "opt": _tree_map(_host, opt_state),
                     "key": np.asarray(key)},
                    meta={"kind": "dl", "step": done, "steps": steps})

        out = dict(
            x=list(di.x), expansion_spec=expansion_spec(di),
            expansion_spec_names=list(di.expanded_names),
            weights=[{"W": l["W"].detach().cpu().numpy(),
                      "b": l["b"].detach().cpu().numpy()} for l in params],
            activation=activation, hidden=hidden, autoencoder=ae,
            distribution_resolved=dist_name,
            response_domain=di.response_domain
            if (not ae and nclass >= 2) else None,
            epochs_trained=steps * batch / max(nrows, 1), steps=steps,
            batch=batch)
        if ae:
            out["model_category"] = "AutoEncoder"
        model = self.model_cls(dict(p), out, dev)
        model.params["response_column"] = y
        model.output["training_metrics"] = model.model_metrics(train)
        if valid is not None:
            model.output["validation_metrics"] = model.model_metrics(valid)
        if p.get("export_weights_and_biases"):
            # weight and bias frames in the DKV (DeepLearningModel
            # _weights/_biases keys), as the reference's :483-500
            names = []
            for i, layer in enumerate(out["weights"]):
                W = np.asarray(layer["W"])
                wk, bk = f"{model.key}_weights_{i + 1}", \
                    f"{model.key}_biases_{i + 1}"
                wf = Frame([f"w{j}" for j in range(W.shape[1])],
                           [Vec(W[:, j]) for j in range(W.shape[1])],
                           key=wk)
                bf = Frame(["bias"], [Vec(np.asarray(layer["b"]))], key=bk)
                publish(wk, wf)
                publish(bk, bf)
                names += [wk, bk]
            model.output["weights_and_biases_keys"] = names
        return model
