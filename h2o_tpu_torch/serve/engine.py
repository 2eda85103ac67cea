"""ScoringEngine — online predict with batch bucketing on the executable
store; port of ``h2o_tpu/serve/engine.py`` (``_bucket`` :48-51,
``ScoringEngine`` :54-319).

Reference: the genmodel scoring path keeps one parsed MOJO per deployed
model and scores rows against it with zero per-request setup
(EasyPredictModelWrapper.java:65).  On the card the engine keeps that
contract with one CUDA graph for each ``(model_id, version,
batch_bucket)``:

- batches pad with zeros to the next power of two (``_bucket``), so a
  deployment captures at most log2(max_batch)+1 predict graphs, each
  replayed by every batch that rounds up to it; the padding is sliced
  back off;
- the graphs live in the process-wide executable store
  (``core/exec_store.py``, one bounded LRU) under ``("serve", "predict",
  model_id, version, bucket)``; hot-swapped or undeployed versions are
  evicted, and the engine's bucket bookkeeping reconciles with the
  store, so an entry the LRU dropped is never reported warm;
- ``warm`` captures each bucket at deploy time, under the engine's
  lock, so the first real request never pays a capture; a graph replays
  the eager predict's kernels, so an answer is bitwise the eager
  predict of the same padded rows (and, for a tree model, whose scoring
  is elementwise over rows, of the unpadded rows);
- a batch predicts under the OOM ladder (``core/oom.py``, site
  ``serve.predict``): sweep and retry, then split the batch into halved
  chunks (smaller buckets, a recorded degradation), then the pure-NumPy
  ``mojo`` scorer, counted in ``fallback_batches``;
- model types without a device ``predict_raw_array`` (KMeans, PCA,
  DeepLearning, ...) score with the ``mojo`` scorer, by their type.

On the CPU the store's entries run the predict eagerly at the padded
shape; the bookkeeping and counters are the card's.

What differs from the reference, on purpose:

- a model that has a device predict is never moved to the host scorer
  at deploy: a ``warm`` whose capture or predict fails raises (the
  reference marks the version for the numpy scorer);
- no disk layer (``stats()``'s ``store_disk_hits`` stays 0: a CUDA graph
  cannot be serialized) and no membership gate (ROADMAP P14b).  The
  chaos slow-score injector sits where the reference's does
  (``h2o_tpu/serve/engine.py:229``), first in ``predict``.

Row encoding reuses the MOJO view of the model's training schema
(columns in training order, categorical domain lookup, unseen level /
missing column -> NaN), so online JSON rows and standalone artifact
scoring agree by construction.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from h2o_tpu_torch.core.chaos import chaos
from h2o_tpu_torch.core.exec_store import bucket_pow2, exec_store
from h2o_tpu_torch.core.lockwitness import make_rlock, note_device_dispatch
from h2o_tpu_torch.core.oom import oom_ladder
from h2o_tpu_torch.models.model import Model


def _bucket(n: int) -> int:
    """Smallest power of two >= n (the store's shape bucket)."""
    return bucket_pow2(n)


def _batch_tensor(Xp: np.ndarray, model) -> torch.Tensor:
    """A padded batch as the predict entry takes it: a host tensor for a
    graph on the card (the replay copies it into its static input), a
    tensor on the model's device for an eager entry."""
    X = torch.from_numpy(Xp)
    return X if model.device.type == "cuda" else X.to(model.device)


class ScoringEngine:
    """Schema encoding + the store's predict graphs for online scoring."""

    def __init__(self):
        # graphs live in the process-wide store (capacity:
        # H2O_TPU_EXEC_STORE); the engine tracks which (model_id,
        # version, bucket) entries it opened, reconciled with the store
        self._lock = make_rlock("engine.ScoringEngine._lock")
        self._keys: set = set()
        # (model_id, version) -> MojoModel schema/host-scorer view
        self._views: Dict[Tuple[str, int], Any] = {}
        self.compiled_entries = 0          # entries this engine opened
        self.device_batches = 0
        self.fallback_batches = 0

    # -- schema view ---------------------------------------------------------

    def view(self, model, version: int = 0):
        """MOJO view of a live model: training columns, categorical
        domains, and the standalone numpy scorer — built once per
        (model_id, version)."""
        key = (model.model_id, int(version))
        with self._lock:
            v = self._views.get(key)
        if v is not None:
            return v
        from h2o_tpu_torch.mojo import MojoModel, _flatten_arrays
        arrays, meta = _flatten_arrays(model.output)
        v = MojoModel(model.algo, dict(model.params), meta, arrays)
        with self._lock:
            self._views[key] = v
        return v

    def supports(self, model) -> bool:
        """Deployable: a device predict OR a standalone numpy scorer."""
        from h2o_tpu_torch.mojo import scorers
        return self.has_device_predict(model) or \
            getattr(scorers, f"score_{model.algo}", None) is not None

    @staticmethod
    def has_device_predict(model) -> bool:
        return Model.has_device_predict(model)

    # -- row encoding --------------------------------------------------------

    def encode_rows(self, model, version: int,
                    rows: Sequence[Dict[str, Any]]) -> np.ndarray:
        """JSON row dicts -> (rows, C) float64 matrix in training-column
        order.  Categorical strings map through the training domain;
        unseen levels, missing columns and unparseable values score as
        NA (NaN) — the convertUnknownCategoricalLevelsToNa behavior."""
        view = self.view(model, version)
        cols = view.columns
        luts = {}
        for c in cols:
            dom = view.domain_of(c)
            if dom is not None:
                luts[c] = {str(s): float(i) for i, s in enumerate(dom)}
        X = np.full((len(rows), len(cols)), np.nan, np.float64)
        for i, row in enumerate(rows):
            for j, c in enumerate(cols):
                v = row.get(c)
                if v is None:
                    continue
                if isinstance(v, str) and c in luts:
                    X[i, j] = luts[c].get(v, np.nan)
                else:
                    try:
                        X[i, j] = float(v)
                    except (TypeError, ValueError):
                        pass                      # unparseable -> NA
        return X

    # -- the store's predict graphs -----------------------------------------

    def _get_compiled(self, model, version: int, bucket: int,
                      example: torch.Tensor):
        """The predict entry of (model, version, bucket) from the store:
        a CUDA graph captured at ``example``'s shape on the card (it
        keeps the model's device constants alive), the eager predict on
        the CPU."""
        key = (model.model_id, int(version), int(bucket))
        fn = exec_store().get_or_build(
            "serve", ("predict",) + key,
            lambda: lambda X: model.predict_raw_array(X),
            args=(example,), device=model.device,
            pins=getattr(model, "device_consts", None))
        with self._lock:
            if key not in self._keys:
                self._keys.add(key)
                self.compiled_entries += 1
        return fn

    def warm(self, model, version: int,
             batch_sizes: Sequence[int] = (1,)) -> None:
        """Capture the deployment's predict graphs, one a bucket, under
        the engine's lock (deploy-time warm, so first requests never pay
        a capture).  A capture or predict that fails raises: the
        deployment is refused, never moved to the host scorer."""
        if not self.has_device_predict(model):
            return
        ncols = len(self.view(model, version).columns)
        with self._lock:
            for n in batch_sizes:
                b = _bucket(int(n))
                X0 = _batch_tensor(np.zeros((b, ncols), np.float32), model)
                self._get_compiled(model, version, b, X0)(X0).cpu()

    def predict(self, model, version: int, X: np.ndarray) -> np.ndarray:
        """Score one (already encoded) micro-batch: pad its rows to the
        power-of-two bucket, replay the bucket's graph, slice the
        padding off.  Under the OOM ladder a device OOM sweeps and
        retries, then splits the batch into halved chunks, then scores
        on the host.  The chaos slow-score injector lives here so
        overload shedding and deadline expiry are testable."""
        chaos().maybe_slow_score(f"serve:{model.model_id}")
        n = X.shape[0]
        if not self.has_device_predict(model):
            return self._predict_host(model, version, X)
        state = {"chunk": n}

        def attempt():
            c = state["chunk"]
            if c >= n:
                return self._predict_bucketed(model, version, X)
            outs = [self._predict_bucketed(model, version, X[i:i + c])
                    for i in range(0, n, c)]
            return np.concatenate(outs, axis=0)

        def shrink() -> bool:
            if state["chunk"] <= 1:
                return False
            state["chunk"] = max(1, state["chunk"] // 2)
            return True

        return oom_ladder(
            "serve.predict", attempt, shrink=shrink,
            host_fallback=lambda: self._predict_host(model, version, X))

    def _predict_host(self, model, version: int, X: np.ndarray) \
            -> np.ndarray:
        """Pure-NumPy mojo-scorer path: a model type with no device
        predict, and the OOM ladder's last rung."""
        raw = self.view(model, version).score_matrix(
            np.asarray(X, np.float64))
        with self._lock:
            self.fallback_batches += 1
        return np.asarray(raw)

    def _predict_bucketed(self, model, version: int,
                          X: np.ndarray) -> np.ndarray:
        """One predict at X's power-of-two bucket."""
        n = X.shape[0]
        b = _bucket(n)
        Xp = np.zeros((b, X.shape[1]), np.float32)
        Xp[:n] = X
        Xp = _batch_tensor(Xp, model)
        fn = self._get_compiled(model, version, b, Xp)
        note_device_dispatch("serve.predict")
        raw = fn(Xp).cpu().numpy()
        with self._lock:
            self.device_batches += 1
        return raw[:n]

    # -- lifecycle -----------------------------------------------------------

    def _reconcile(self) -> None:
        """Drop bookkeeping for entries the shared store has evicted:
        ``buckets_for`` and ``stats`` never report a warm graph that
        the next request would capture again."""
        live = {(k[2], k[3], k[4]) for k in exec_store().keys()
                if len(k) >= 5 and k[0] == "serve" and k[1] == "predict"}
        with self._lock:
            self._keys &= live

    def buckets_for(self, model_id: str, version: int) -> List[int]:
        self._reconcile()
        with self._lock:
            return sorted(b for (mid, ver, b) in self._keys
                          if mid == str(model_id) and ver == int(version))

    def evict(self, model_id: str, version: int) -> None:
        """Drop a version's graphs + schema view (undeploy / rollback of
        a hot-swapped version) from the store."""
        key = (str(model_id), int(version))
        with self._lock:
            self._views.pop(key, None)
            self._keys = {k for k in self._keys if k[:2] != key}
        exec_store().evict(
            lambda k: len(k) >= 5 and k[0] == "serve" and
            k[1] == "predict" and (k[2], k[3]) == key)

    def stats(self) -> Dict[str, Any]:
        self._reconcile()
        store = exec_store().stats()
        with self._lock:
            return {"compiled_cache_entries": len(self._keys),
                    "compiled_total": self.compiled_entries,
                    "cache_capacity": store["capacity"],
                    "store_disk_hits": store["disk_hits"],
                    "device_batches": self.device_batches,
                    "fallback_batches": self.fallback_batches}
