"""MOJO — Model Object, Optimized: standalone scoring artifacts; port of
``h2o_tpu/mojo/__init__.py`` (``_flatten_arrays`` :36-81, ``sub_model``
:84-90, ``export_mojo`` :93-136, ``MojoModel`` :139-198, ``load_mojo``
:201-224, ``export_genmodel_mojo`` :227-231, ``import_mojo`` :234-238,
``_encode`` :241-264, ``EasyPredictModelWrapper`` :267-282).

Reference: h2o-genmodel (MojoModel.java, ModelMojoReader, per-algo readers in
genmodel/algos/{gbm,drf,glm,kmeans,deeplearning,pca}, and
EasyPredictModelWrapper.java:65) — a zip artifact scoreable WITHOUT a running
cluster.

The zip keeps the reference's contract (a ``model.ini`` manifest and a
payload; standalone scoring with no cluster and no device) and stores
the payload as ``arrays.npz`` + ``meta.json``; the scorers in
``h2o_tpu_torch.mojo.scorers`` are pure numpy, so a MOJO scores anywhere
numpy imports (the genmodel-JAR analog).  Scoring a MOJO stays on the
host by design; only ``import_mojo`` and ``Generic`` hand the
predictions to the model's device.

Where the reference names a model by its DKV key, the port names it by
``model.model_id``; output values the port holds as tensors (on the card
or the CPU) are written as numpy.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from h2o_tpu_torch.mojo import scorers

_FORMAT_VERSION = "1.00"


_SKIP_KEYS = ("training_metrics", "validation_metrics",
              "cross_validation_metrics",
              "cross_validation_metrics_summary", "scoring_history")


def _host(v):
    """A tensor (on any device) as a numpy array; anything else as is."""
    return v.detach().cpu().numpy() if torch.is_tensor(v) else v


def _host_tree(v):
    """``v`` with every tensor in it, through dicts, lists and tuples, as
    numpy (models held in it stay as they are)."""
    if torch.is_tensor(v):
        return _host(v)
    if isinstance(v, dict):
        return {k: _host_tree(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_host_tree(x) for x in v)
    return v


class _HostView:
    """What a writer reads of a model — ``algo``, ``params``,
    ``model_id`` and an ``output`` whose tensors are numpy arrays."""

    def __init__(self, model):
        self.algo = model.algo
        self.params = model.params
        self.model_id = model.model_id
        self.output = _host_tree(model.output)


def host_view(model) -> _HostView:
    """The writers' boundary: ``model`` as they read it, on the host."""
    return model if isinstance(model, _HostView) else _HostView(model)


def _flatten_arrays(output: Dict, prefix: str = "") -> \
        (Dict[str, np.ndarray], Dict):
    """Split model output into npz-able arrays and JSON-able metadata.

    Nested dicts flatten recursively with ``parent__child`` keys (GAM's
    per-column knots, composite models carrying an inner model's output);
    scorers reconstruct a sub-model view with ``sub_model``.  Tensors
    count as arrays."""
    arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, Any] = {}
    for k, v in output.items():
        if k in _SKIP_KEYS:
            continue
        fk = f"{prefix}{k}"
        v = _host(v)
        if isinstance(v, np.ndarray):
            arrays[fk] = v
        elif k == "weights" and isinstance(v, list):     # DL layer list
            meta[f"{prefix}n_layers"] = len(v)
            for i, layer in enumerate(v):
                arrays[f"{prefix}W{i}"] = np.asarray(_host(layer["W"]))
                arrays[f"{prefix}b{i}"] = np.asarray(_host(layer["b"]))
        elif isinstance(v, dict):
            try:                       # keep json-able dicts as one value
                json.dumps(v)
                meta[fk] = v
            except TypeError:
                sub_a, sub_m = _flatten_arrays(v, prefix=f"{fk}__")
                arrays.update(sub_a)
                meta.update(sub_m)
        elif isinstance(v, list) and v and \
                all(isinstance(x, dict) for x in v):
            try:                       # e.g. RuleFit forests
                json.dumps(v)
                meta[fk] = v
            except TypeError:
                meta[f"{fk}__len"] = len(v)
                for i, item in enumerate(v):
                    sub_a, sub_m = _flatten_arrays(
                        item, prefix=f"{fk}__{i}__")
                    arrays.update(sub_a)
                    meta.update(sub_m)
        else:
            try:
                json.dumps(v)
                meta[fk] = v
            except TypeError:
                pass
    return arrays, meta


def sub_model(arrays: Dict, meta: Dict, prefix: str) -> (Dict, Dict):
    """View of a nested model's flattened arrays/meta: strips
    ``<prefix>__`` (scorers for composite models — GAM's inner GLM)."""
    p = prefix + "__"
    return ({k[len(p):]: v for k, v in arrays.items()
             if k.startswith(p)},
            {k[len(p):]: v for k, v in meta.items() if k.startswith(p)})


def export_mojo(model, path: str) -> str:
    """Write a model as a standalone MOJO zip (ModelMojoWriter analog).

    Fails fast for algos without a standalone scorer — exporting would
    produce an artifact that load_mojo can open but never score.  The
    model's ``model_id`` is written in ``[info]``, not among the params
    (the reference's params do not hold its key either)."""
    if getattr(scorers, f"score_{model.algo}", None) is None:
        raise NotImplementedError(
            f"algo '{model.algo}' has no MOJO scorer; supported: "
            f"{sorted(n[6:] for n in dir(scorers) if n.startswith('score_'))}")
    if model.output.get("custom_link") is not None:
        raise NotImplementedError(
            "models trained with a custom distribution carry a python "
            "UDF the standalone artifact cannot embed; score through "
            "the cluster or retrain with a built-in distribution")
    arrays, meta = _flatten_arrays(model.output)
    params = {}
    for k, v in model.params.items():
        if k == "model_id":
            continue
        try:
            json.dumps(v)
            params[k] = v
        except TypeError:
            params[k] = str(v)
    info = {
        "algorithm": model.algo,
        "mojo_version": _FORMAT_VERSION,
        "model_id": model.model_id,
        "supervised": model.output.get("response_domain") is not None or
        model.params.get("response_column") is not None,
    }
    ini = io.StringIO()
    ini.write("[info]\n")
    for k, v in info.items():
        ini.write(f"{k} = {v}\n")
    ini.write("\n[columns]\n")
    for c in meta.get("x", []):
        ini.write(f"{c}\n")
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("model.ini", ini.getvalue())
        z.writestr("meta.json", json.dumps(
            {"info": info, "params": params, "output": meta}, default=str))
        buf = io.BytesIO()
        np.savez_compressed(buf, **arrays)
        z.writestr("arrays.npz", buf.getvalue())
    return path


class MojoModel:
    """A loaded MOJO: pure-numpy scoring, no cluster required
    (genmodel MojoModel analog)."""

    def __init__(self, algo: str, params: Dict, meta: Dict,
                 arrays: Dict[str, np.ndarray]):
        self.algo = algo
        self.params = params
        self.meta = meta
        self.arrays = arrays

    # -- introspection ------------------------------------------------------

    @property
    def columns(self) -> List[str]:
        return list(self.meta.get("input_columns") or
                    self.meta.get("x") or
                    self._spec_columns())

    def _spec_columns(self) -> List[str]:
        spec = self.meta.get("expansion_spec") or {}
        return list(spec.get("cat_names", [])) + \
            list(spec.get("num_names", []))

    @property
    def response_domain(self) -> Optional[List[str]]:
        return self.meta.get("response_domain")

    @property
    def nclasses(self) -> int:
        d = self.response_domain
        return len(d) if d else 1

    def domain_of(self, col: str) -> Optional[List[str]]:
        doms = self.meta.get("domains") or {}
        if col in doms:
            return doms[col]
        spec = self.meta.get("expansion_spec") or {}
        for c, d in zip(spec.get("cat_names", []),
                        spec.get("cat_domains", [])):
            if c == col:
                return d
        return None

    # -- scoring ------------------------------------------------------------

    def score_matrix(self, X: np.ndarray) -> np.ndarray:
        """Score a (rows, len(columns)) float matrix of raw column values
        (categoricals as domain codes, NA as NaN).  Returns regression
        values (rows,) or [label, p0..pK-1] (rows, 1+K)."""
        fn = getattr(scorers, f"score_{self.algo}", None)
        if fn is None:
            raise NotImplementedError(
                f"no MOJO scorer for algo '{self.algo}'")
        return fn(self.arrays, self.meta, np.asarray(X, np.float64))

    def predict(self, data) -> np.ndarray:
        """Score raw tabular data (a DataFrame-like object or a dict of
        columns)."""
        X = _encode(self, data)
        return self.score_matrix(X)


def load_mojo(path: str):
    """Read a MOJO zip (ModelMojoReader analog).

    Sniffs the layout: zips carrying `meta.json` are this package's npz
    format; anything else is treated as a genmodel-spec MOJO (including
    artifacts produced by a real H2O cluster) and parsed by
    h2o_tpu_torch.mojo.genmodel."""
    with zipfile.ZipFile(path) as z:
        names = set(z.namelist())
        if "meta.json" not in names:
            from h2o_tpu_torch.mojo.genmodel import GenmodelMojoModel
            if hasattr(path, "read"):
                path.seek(0)
                data = path.read()
            else:
                with open(path, "rb") as f:
                    data = f.read()
            return GenmodelMojoModel(data)
        meta_all = json.loads(z.read("meta.json"))
        with z.open("arrays.npz") as f:
            npz = np.load(io.BytesIO(f.read()), allow_pickle=False)
            arrays = {k: npz[k] for k in npz.files}
    return MojoModel(meta_all["info"]["algorithm"], meta_all["params"],
                     meta_all["output"], arrays)


def export_genmodel_mojo(model) -> bytes:
    """Model -> genmodel-spec MOJO zip bytes; the format the stock
    client's download_mojo/import_mojo round-trips."""
    from h2o_tpu_torch.mojo.genmodel import write_genmodel_mojo
    return write_genmodel_mojo(model)


def import_mojo(path: str, device=None):
    """Import a MOJO as a first-class Model (the `generic` algo,
    reference hex/generic/Generic.java) whose predictions land on
    ``device`` (``cuda:0`` unless ``device="cpu"``)."""
    from h2o_tpu_torch.models.generic import GenericModel
    return GenericModel.from_mojo(load_mojo(path), device=device)


def _encode(mojo: MojoModel, data) -> np.ndarray:
    """Raw columns -> codes/float matrix in mojo.columns order.  Unseen
    categorical levels -> NaN (scored as NA, the EasyPredict
    convertUnknownCategoricalLevelsToNa behavior)."""
    cols = {}
    if hasattr(data, "to_dict") and hasattr(data, "columns"):  # DataFrame
        cols = {c: np.asarray(data[c]) for c in data.columns}
    elif isinstance(data, dict):
        cols = {c: np.atleast_1d(np.asarray(v)) for c, v in data.items()}
    else:
        raise TypeError("predict() wants a DataFrame or dict of columns")
    n = len(next(iter(cols.values()))) if cols else 0
    X = np.full((n, len(mojo.columns)), np.nan, np.float64)
    for j, c in enumerate(mojo.columns):
        if c not in cols:
            continue                      # missing column -> all NA
        v = cols[c]
        dom = mojo.domain_of(c)
        if dom is not None and v.dtype.kind in "OUS":
            lut = {s: i for i, s in enumerate(dom)}
            X[:, j] = [lut.get(str(s), np.nan) for s in v]
        else:
            X[:, j] = np.asarray(v, np.float64)
    return X


class EasyPredictModelWrapper:
    """Row-oriented convenience scorer (EasyPredictModelWrapper.java:65)."""

    def __init__(self, model: MojoModel):
        self.model = model

    def predict(self, row: Dict[str, Any]) -> Dict[str, Any]:
        data = {k: [v] for k, v in row.items()}
        raw = self.model.predict(data)
        dom = self.model.response_domain
        if dom is None:
            return {"value": float(np.ravel(raw)[0])}
        r = np.atleast_2d(raw)[0]
        label_idx = int(r[0])
        return {"label": dom[label_idx],
                "classProbabilities": [float(p) for p in r[1:]]}
