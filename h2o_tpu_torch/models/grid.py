"""Grid search over hyper-parameter spaces — port of
``h2o_tpu/models/grid.py`` (``Grid`` :54-98, ``GridSearch`` :101-300,
``resume_from_recovery`` :298-326, ``get_grid``, ``export_grid``,
``import_grid`` :313-361; reference
hex/grid/GridSearch.java:70, HyperSpaceWalker.java:213-215,
HyperSpaceSearchCriteria.java, hex/grid/Grid.java).

The Cartesian walker visits ``itertools.product`` of the hyper values in
their given order; RandomDiscrete shuffles that list with
``np.random.default_rng(seed).shuffle`` (a seed < 0 draws fresh
entropy), so a seed picks the reference's combos in the reference's
order.  ``max_models``, ``max_runtime_secs`` and the search-level early
stopping (best-so-far not moved by ``stopping_tolerance`` over the last
``stopping_rounds`` models) end the walk.  A combo whose build raises is
collected in ``Grid.failures`` with its stack trace.

The grid is published in ``store.dkv()`` under its id before any model
trains, and every model under its own key as it finishes; the search
runs as a job of ``core/job.py``'s registry, and each model as the job
its builder's ``train`` starts (on the builder's device: ``cuda:0``
unless ``device="cpu"`` is among the base params).  ``parallelism=N``
trains batches of N combos on a thread pool; the stop criteria are
read at batch boundaries.

With ``recovery_dir`` the search snapshots its params and training frame
before the first model (``core/recovery.py``), saves every finished
model into the snapshot (``Model.save``) and deletes it when the walk
ends; after a crash ``auto_recover`` (or ``resume_grid``, as a job)
calls ``resume_from_recovery``, which publishes the finished models in
a new grid and trains only the remaining combinations.
"""

from __future__ import annotations

import itertools
import os
import pickle
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.core.job import Job, jobs
from h2o_tpu_torch.core.log import get_logger
from h2o_tpu_torch.core.store import Key, dkv
from h2o_tpu_torch.models.model import _rehome, in_caller_threads
from h2o_tpu_torch.models.score_keeper import (is_maximizing, metric_value,
                                               resolve_stopping_metric)

log = get_logger("grid")


def _model_kind(model) -> str:
    mm = model.output.get("training_metrics")
    if mm is not None and getattr(mm, "kind", None):
        return mm.kind
    dom = model.output.get("response_domain")
    if dom is None:
        return "regression"
    return "binomial" if len(dom) == 2 else "multinomial"


def _model_sort_metric(model, metric: str) -> float:
    """Metric for ranking: CV metrics if present, else validation, else
    training (the Leaderboard's preference order)."""
    mm = model.output.get("cross_validation_metrics") or \
        model.output.get("validation_metrics") or \
        model.output.get("training_metrics")
    return metric_value(mm, metric)


class Grid:
    """A trained grid: hyper combos -> models, sortable summary."""

    def __init__(self, key: str, algo: str, hyper_names: List[str]):
        self.key = Key(key)
        self.algo = algo
        self.hyper_names = hyper_names
        self.models: List = []            # Model objects (also in DKV)
        self.hyper_values: List[Dict] = []
        self.failures: List[Dict] = []
        self.sort_metric: Optional[str] = None

    @property
    def model_ids(self) -> List[str]:
        return [str(m.key) for m in self.models]

    def sorted_models(self, metric: Optional[str] = None,
                      decreasing: Optional[bool] = None) -> List:
        metric = metric or self.sort_metric or "mse"
        if decreasing is None:
            decreasing = is_maximizing(metric)
        return sorted(self.models,
                      key=lambda m: _model_sort_metric(m, metric),
                      reverse=decreasing)

    def summary(self, metric: Optional[str] = None) -> Dict[str, Any]:
        metric = metric or self.sort_metric or "mse"
        rows = []
        for m in self.sorted_models(metric):
            hv = self.hyper_values[self.models.index(m)]
            rows.append({**{k: hv.get(k) for k in self.hyper_names},
                         "model_id": str(m.key),
                         metric: _model_sort_metric(m, metric)})
        return {"grid_id": str(self.key), "hyper_names": self.hyper_names,
                "sort_metric": metric, "summary_rows": rows,
                "failure_count": len(self.failures)}

    def to_dict(self) -> Dict[str, Any]:
        d = self.summary()
        d["model_ids"] = [{"name": i, "type": "Key<Model>"}
                          for i in self.model_ids]
        d["failed_params"] = [f["params"] for f in self.failures]
        d["failure_details"] = [f["error"] for f in self.failures]
        return d


class GridSearch:
    """Cartesian or RandomDiscrete hyper-space walk over one builder."""

    def __init__(self, builder_cls, hyper_params: Dict[str, Sequence],
                 search_criteria: Optional[Dict] = None,
                 grid_id: Optional[str] = None,
                 recovery_dir: Optional[str] = None,
                 parallelism: int = 1, **base_params):
        if isinstance(builder_cls, str):
            from h2o_tpu_torch.models.registry import builder_class
            builder_cls = builder_class(builder_cls)
        # ParallelModelBuilder.java: 0 = adaptive (the host's CPU count)
        p = int(parallelism if parallelism is not None else 1)
        self.parallelism = (os.cpu_count() or 4) if p == 0 else max(p, 1)
        self.builder_cls = builder_cls
        self.hyper_params = {k: list(v) for k, v in hyper_params.items()}
        sc = dict(search_criteria or {})
        self.strategy = sc.pop("strategy", "Cartesian")
        self.criteria = sc
        self.base_params = base_params
        self.recovery_dir = recovery_dir
        self._resuming = False
        self.grid_id = grid_id or str(Key.make(f"grid_{builder_cls.algo}"))

    # -- walkers (HyperSpaceWalker.java:213-215) ---------------------------

    def _combos(self) -> List[Dict]:
        names = list(self.hyper_params)
        combos = [dict(zip(names, vs)) for vs in
                  itertools.product(*(self.hyper_params[n] for n in names))]
        if self.strategy.lower() in ("randomdiscrete", "random"):
            seed = int(self.criteria.get("seed", -1))
            rng = np.random.default_rng(seed if seed >= 0 else None)
            rng.shuffle(combos)
        return combos

    # -- search ------------------------------------------------------------

    def train_async(self, x=None, y=None, training_frame=None,
                    validation_frame=None) -> Job:
        """Publish the grid (so a caller can poll it mid-run, and a
        cancelled search keeps its models) and start the walk as a job
        whose ``dest`` is the grid id."""
        if dkv().get(self.grid_id) is None:
            dkv().put(self.grid_id, Grid(self.grid_id, self.builder_cls.algo,
                                         list(self.hyper_params)))
        job = Job(dest=self.grid_id, dest_type="Key<Grid>",
                  description=f"grid {self.grid_id} over "
                              f"{list(self.hyper_params)}")
        jobs().start(job, in_caller_threads(
            lambda j: self._run(j, x, y, training_frame, validation_frame)))
        return job

    def train(self, x=None, y=None, training_frame=None,
              validation_frame=None) -> Grid:
        return self.train_async(x=x, y=y, training_frame=training_frame,
                                validation_frame=validation_frame).join()

    def _run(self, job: Job, x, y, train, valid) -> Grid:
        grid = dkv().get(self.grid_id)
        if grid is None:
            grid = Grid(self.grid_id, self.builder_cls.algo,
                        list(self.hyper_params))
        rec = None
        if self.recovery_dir:
            from h2o_tpu_torch.core.recovery import Recovery, _jsonable
            rec = Recovery(self.recovery_dir, "grid", self.grid_id,
                           self.base_params.get("device"))
            if not self._resuming:
                rec.begin(dict(self.base_params), train, extra=_jsonable(
                    dict(algo=self.builder_cls.algo,
                         hyper_params={k: [_py(v) for v in vs] for k, vs
                                       in self.hyper_params.items()},
                         strategy=self.strategy,
                         criteria=_jsonable(self.criteria),
                         base_params=_jsonable(self.base_params),
                         x=list(x) if x is not None else None, y=y)))
        combos = self._combos()
        # skip combos already trained (a grid id given again)
        done = {tuple(sorted(hv.items())) for hv in grid.hyper_values}
        combos = [c for c in combos
                  if tuple(sorted(c.items())) not in done]

        max_models = int(self.criteria.get("max_models", 0) or 0)
        max_rt = float(self.criteria.get("max_runtime_secs", 0.0) or 0.0)
        rounds = int(self.criteria.get("stopping_rounds", 0) or 0)
        tol = float(self.criteria.get("stopping_tolerance", 1e-3))
        t0 = time.time()
        best_so_far: List[float] = []
        metric = None
        maximize = False
        append_lock = threading.Lock()

        def train_one(combo):
            params = dict(self.base_params)
            params.update(combo)
            try:
                m = self.builder_cls(**params).train(
                    x=x, y=y, training_frame=train, validation_frame=valid)
                # hyper_values first: a concurrent poll of the published
                # grid indexes hyper_values[models.index(m)]
                with append_lock:
                    grid.hyper_values.append(dict(combo))
                    grid.models.append(m)
                dkv().put(m.key, m)
                if rec is not None:
                    # model_done rewrites info.json: one writer at a time
                    with append_lock:
                        rec.model_done(m)
                return m
            except Exception as e:  # noqa: BLE001 — grid collects failures
                log.warning("grid model failed (%s): %s", combo, e)
                with append_lock:
                    grid.failures.append({"params": dict(combo),
                                          "error": repr(e),
                                          "stacktrace":
                                          traceback.format_exc()})
                return None

        def note_trained(m) -> bool:
            """Update best-so-far; True => early-stop the search."""
            nonlocal metric, maximize
            if metric is None:
                metric = resolve_stopping_metric(
                    self.criteria.get("stopping_metric", "AUTO"),
                    _model_kind(m))
                maximize = is_maximizing(metric)
                grid.sort_metric = metric
            v = _model_sort_metric(m, metric)
            best = v if not best_so_far else (
                max(best_so_far[-1], v) if maximize
                else min(best_so_far[-1], v))
            best_so_far.append(best)
            # best-so-far has not moved by tol over the last `rounds`
            # models (RandomDiscrete criteria)
            if rounds and len(best_so_far) > rounds:
                prev = best_so_far[-rounds - 1]
                rel = abs(best - prev) / max(abs(prev), 1e-12)
                if rel < tol:
                    log.info("grid %s: early stop after %d models",
                             self.grid_id, len(grid.models))
                    return True
            return False

        # batches of `parallelism` concurrent builders, stop criteria at
        # batch ends (sequential == batch size 1)
        P = self.parallelism
        i = 0
        stop = False
        pool = ThreadPoolExecutor(max_workers=P) if P > 1 else None
        try:
            while i < len(combos) and not stop:
                if max_models and len(grid.models) >= max_models:
                    break
                if max_rt and time.time() - t0 > max_rt:
                    log.info("grid %s: max_runtime_secs reached",
                             self.grid_id)
                    break
                n = 1 if P == 1 else min(
                    P, len(combos) - i,
                    (max_models - len(grid.models)) if max_models
                    else len(combos))
                batch = combos[i: i + n]
                i += n
                if pool is None:
                    trained = [train_one(batch[0])]
                else:
                    trained = list(pool.map(train_one, batch))
                for m in trained:
                    if m is not None and note_trained(m):
                        stop = True
                        break
                best = best_so_far[-1] if best_so_far else float("nan")
                job.update(i / max(len(combos), 1),
                           f"{len(grid.models)} models, best "
                           f"{metric}={best:.5g}")
        finally:
            if pool is not None:
                pool.shutdown(wait=True)
        dkv().put(grid.key, grid)
        if rec is not None:
            rec.done()
        return grid

    # -- recovery (the Recovery.autoRecover target) ------------------------

    @classmethod
    def resume_from_recovery(cls, info: Dict, train, done_models,
                             sync: bool = True, device: DeviceLike = None):
        """Rebuild the search from a recovery snapshot, publish its
        finished models in a new grid and train only the remaining
        combinations on ``device`` (``cuda:0`` by default); with
        ``sync=False`` return the search's ``Job``
        (hex/faulttolerance/Recovery.java:21-86, R's
        ``h2o.resumeGrid``)."""
        extra = info["extra"]
        base = dict(extra["base_params"])
        base["device"] = device
        gs = cls(extra["algo"], extra["hyper_params"],
                 dict(extra["criteria"], strategy=extra["strategy"]),
                 grid_id=info["job_id"],
                 recovery_dir=os.path.dirname(info["dir"]), **base)
        gs._resuming = True
        hyper = list(extra["hyper_params"])
        grid = Grid(gs.grid_id, extra["algo"], hyper)
        grid.models = list(done_models)
        grid.hyper_values = [{k: m.params.get(k) for k in hyper}
                             for m in done_models]
        dkv().put(grid.key, grid)
        run = gs.train if sync else gs.train_async
        return run(x=extra.get("x"), y=extra.get("y"), training_frame=train)


def _py(v):
    """A numpy scalar as a Python scalar, for the snapshot's JSON."""
    return v.item() if hasattr(v, "item") else v


def get_grid(grid_id: str) -> Optional[Grid]:
    return dkv().get(grid_id)


# -- grid export/import (api/GridImportExportHandler.java) ------------------

def export_grid(grid: Grid, path: str) -> str:
    """The grid and its models pickled into ``<path>/<grid id>.grid``."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, f"{grid.key}.grid"), "wb") as f:
        pickle.dump(grid, f)
    return path


def import_grid(path: str, grid_id: Optional[str] = None,
                device: DeviceLike = None) -> Grid:
    """The grid ``export_grid`` wrote under ``path`` (``grid_id``, else
    the first ``.grid`` file), its models scoring on ``device``
    (``cuda:0`` by default); the grid and each model published."""
    import glob
    files = glob.glob(os.path.join(path, f"{grid_id or '*'}.grid"))
    if not files:
        raise FileNotFoundError(f"no .grid file under {path}")
    with open(files[0], "rb") as f:
        grid = pickle.load(f)
    _rehome(grid.models, cloud(device))
    dkv().put(grid.key, grid)
    for m in grid.models:
        dkv().put(m.key, m)
    return grid
