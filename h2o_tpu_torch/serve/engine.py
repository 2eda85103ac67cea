"""ScoringEngine — online predict with batch-size bookkeeping; port of
``h2o_tpu/serve/engine.py`` (``_bucket`` :48-51, ``ScoringEngine``
:54-319).

Reference: the genmodel scoring path keeps one parsed MOJO per deployed
model and scores rows against it with zero per-request setup
(EasyPredictModelWrapper.java:65).  The engine keeps that contract for a
model on the card:

- every batch belongs to the power-of-two bucket that holds its row
  count (``_bucket``); the engine keeps a bounded LRU table (256 entries)
  of the ``(model_id, version, batch_bucket)`` keys it has served, which
  ``buckets_for``, ``evict`` and ``stats`` report; hot-swapped or
  undeployed versions are evicted;
- ``warm`` runs each bucket once on the model's device at deploy time,
  so the first real request meets allocated memory and loaded kernels;
- model types without a device ``predict_raw_array`` (KMeans, PCA,
  DeepLearning, ...) score with the pure-NumPy ``mojo`` scorer, by their
  type, and count in ``fallback_batches``.

What differs from the reference, on purpose:

- a batch is scored at its own row count, not zero-padded to its
  bucket: PyTorch runs eagerly, so a padded shape would buy no reused
  program (the reference pads so that XLA compiles one executable per
  bucket), only up to twice the rows;
- a model that has a device predict never falls back to the host
  scorer: a ``warm`` whose predict fails raises (the reference marks the
  version for the numpy scorer), and the out-of-memory ladder halves the
  chunk on ``torch.cuda.OutOfMemoryError`` and re-raises at a chunk of
  one row (the reference's last rung is the host scorer);
- the executable store's disk layer and the membership gate come with
  P14: ``stats()`` has no ``store_disk_hits``, and ``predict`` has no
  mesh-reform hook.  The chaos slow-score injector sits where the
  reference's does (``h2o_tpu/serve/engine.py:229``), first in
  ``predict``.

Row encoding reuses the MOJO view of the model's training schema
(columns in training order, categorical domain lookup, unseen level /
missing column -> NaN), so online JSON rows and standalone artifact
scoring agree by construction.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from h2o_tpu_torch.core.chaos import chaos
from h2o_tpu_torch.core.lockwitness import make_rlock, note_device_dispatch
from h2o_tpu_torch.models.model import Model


def _bucket(n: int) -> int:
    """Smallest power of two >= n (the batch's bucket)."""
    return 1 if n <= 1 else 1 << int(n - 1).bit_length()


class ScoringEngine:
    """Schema encoding + bucket bookkeeping for online scoring."""

    #: bound of the served-bucket table (the reference store's default)
    capacity = 256

    def __init__(self):
        self._lock = make_rlock("engine.ScoringEngine._lock")
        # (model_id, version, bucket) keys served, LRU order
        self._entries: "OrderedDict[Tuple[str, int, int], None]" = \
            OrderedDict()
        # (model_id, version) -> MojoModel schema/host-scorer view
        self._views: Dict[Tuple[str, int], Any] = {}
        self.compiled_entries = 0          # keys this engine opened
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

    # -- bucketed predict ----------------------------------------------------

    def _touch(self, model, version: int, bucket: int) -> None:
        """Record a (model, version, bucket) key as the most recently
        served (the least recently served goes when the table is
        full)."""
        key = (model.model_id, int(version), int(bucket))
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return
            self._entries[key] = None
            self.compiled_entries += 1
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def warm(self, model, version: int,
             batch_sizes: Sequence[int] = (1,)) -> None:
        """Run the deployment's predict once per bucket on the model's
        device (deploy-time warm, so first requests find their memory
        and kernels ready).  A device predict that fails raises: the
        deployment is refused, never moved to the host scorer."""
        if not self.has_device_predict(model):
            return
        ncols = len(self.view(model, version).columns)
        for n in batch_sizes:
            b = _bucket(int(n))
            self._touch(model, version, b)
            X0 = torch.zeros((b, ncols), dtype=torch.float32,
                             device=model.device)
            model.predict_raw_array(X0).cpu()

    def predict(self, model, version: int, X: np.ndarray) -> np.ndarray:
        """Score one (already encoded) micro-batch on the model's
        device.  Out of device memory, the batch splits into halved
        chunks (smaller buckets, a recorded degradation) down to one
        row, where the error is raised.  The chaos slow-score injector
        lives here so overload shedding and deadline expiry are
        testable."""
        chaos().maybe_slow_score(f"serve:{model.model_id}")
        n = X.shape[0]
        if not self.has_device_predict(model):
            return self._predict_host(model, version, X)
        chunk = n
        while True:
            try:
                if chunk >= n:
                    return self._predict_bucketed(model, version, X)
                outs = [self._predict_bucketed(model, version, X[i:i + chunk])
                        for i in range(0, n, chunk)]
                return np.concatenate(outs, axis=0)
            except torch.cuda.OutOfMemoryError:
                if chunk <= 1:
                    raise
                chunk = max(1, chunk // 2)
                torch.cuda.empty_cache()

    def _predict_host(self, model, version: int, X: np.ndarray) \
            -> np.ndarray:
        """Pure-NumPy mojo-scorer path for a model type with no device
        predict."""
        raw = self.view(model, version).score_matrix(
            np.asarray(X, np.float64))
        with self._lock:
            self.fallback_batches += 1
        return np.asarray(raw)

    def _predict_bucketed(self, model, version: int,
                          X: np.ndarray) -> np.ndarray:
        """One predict of X's rows on the model's device, recorded under
        X's bucket."""
        self._touch(model, version, _bucket(X.shape[0]))
        note_device_dispatch("serve.predict")
        raw = model.predict_raw_array(torch.from_numpy(
            np.asarray(X, np.float32)).to(model.device)).cpu().numpy()
        with self._lock:
            self.device_batches += 1
        return raw

    # -- lifecycle -----------------------------------------------------------

    def buckets_for(self, model_id: str, version: int) -> List[int]:
        with self._lock:
            return sorted(b for (mid, ver, b) in self._entries
                          if mid == str(model_id) and ver == int(version))

    def evict(self, model_id: str, version: int) -> None:
        """Drop a version's bucket entries + schema view (undeploy /
        rollback of a hot-swapped version)."""
        key = (str(model_id), int(version))
        with self._lock:
            self._views.pop(key, None)
            for k in [k for k in self._entries if k[:2] == key]:
                del self._entries[k]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"compiled_cache_entries": len(self._entries),
                    "compiled_total": self.compiled_entries,
                    "cache_capacity": self.capacity,
                    "device_batches": self.device_batches,
                    "fallback_batches": self.fallback_batches}
