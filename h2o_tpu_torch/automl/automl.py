"""AutoML — automatic model selection and ensembling; port of
``h2o_tpu/automl/automl.py`` (``EventLog`` :34-47, ``_Budget`` :50-70,
``_default_plan`` :75-110, ``_EXPLOITATION_RATIO`` :115, ``TEPipelineModel``
:118-154, ``AutoML`` :157-461; reference
h2o-automl/src/main/java/ai/h2o/automl/AutoML.java:49, ModelingPlans.java,
WorkAllocations.java, events/EventLog.java).

A run executes the reference's plan: default models, random-search
grids (each shuffled by ``np.random.default_rng(seed)``), an
exploitation step that refines the best GBM or XGBoost, then the
BestOfFamily and AllModels stacked ensembles.  Every model shares one
fold assignment, a Modulo fold column on the training rows, so the base
models' holdout predictions line up in the ensembles' level-one frame.
With ``preprocessing=["target_encoding"]`` a TargetEncoder (KFold on
that fold column) adds ``<col>_te`` columns for the tree steps, whose
models are wrapped in ``TEPipelineModel`` so that a frame without those
columns is encoded first.  ``max_models`` and ``max_runtime_secs`` bound
the run (a step's share of the remaining clock, as WorkAllocations).

The run is a job of ``core/job.py``'s registry; each model trains as its
own builder's job on ``device`` (``cuda:0`` unless the caller passes
``device="cpu"``).  The AutoML object is published under its project
name and its key before the first model, and every model, the target
encoder and both ensembles under their keys.
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Dict, List, Optional

import numpy as np

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.core.frame import Frame, Vec
from h2o_tpu_torch.core.job import Job, jobs
from h2o_tpu_torch.core.log import get_logger
from h2o_tpu_torch.core.store import Key, dkv
from h2o_tpu_torch.models.leaderboard import Leaderboard
from h2o_tpu_torch.models.model import Model, in_caller_threads
from h2o_tpu_torch.models.registry import builder_class

log = get_logger("automl")


class EventLog:
    """Timestamped AutoML event journal (events/EventLog.java)."""

    def __init__(self):
        self.events: List[Dict] = []

    def info(self, stage: str, message: str) -> None:
        self.events.append({"timestamp": time.time(), "level": "Info",
                            "stage": stage, "message": message})
        log.info("[%s] %s", stage, message)

    def to_dict(self) -> List[Dict]:
        return list(self.events)


class _Budget:
    """Work allocation: per-step time budget from max_runtime_secs
    (WorkAllocations.java)."""

    def __init__(self, max_runtime_secs: float, max_models: int):
        self.t0 = time.time()
        self.max_runtime = max_runtime_secs
        self.max_models = max_models
        self.n_models = 0

    def exhausted(self) -> bool:
        if self.max_models and self.n_models >= self.max_models:
            return True
        if self.max_runtime and time.time() - self.t0 > self.max_runtime:
            return True
        return False

    def remaining(self) -> float:
        if not self.max_runtime:
            return 0.0
        return max(self.max_runtime - (time.time() - self.t0), 0.0)


# The modeling plan: (step name, algo, params, work weight) in execution
# order (ModelingPlans.defaultPlan: defaults → grids → exploitation →
# ensembles; work weights follow WorkAllocations.java's per-step units).
# The XGBoost steps keep the reference's shallower-but-more-trees
# settings (its dense tree heap's depth remap), so both packages walk
# the same plan.
def _default_plan(seed: int) -> List[Dict]:
    return [
        dict(step="def_glm", algo="glm", params={}, work=10),
        dict(step="def_xgb_1", algo="xgboost",
             params=dict(ntrees=60, max_depth=6, min_rows=5, nbins=64,
                         sample_rate=0.6, col_sample_rate_per_tree=0.8),
             work=10),
        dict(step="def_gbm_1", algo="gbm",
             params=dict(ntrees=50, max_depth=6, learn_rate=0.1),
             work=10),
        dict(step="def_gbm_2", algo="gbm",
             params=dict(ntrees=50, max_depth=3, learn_rate=0.1),
             work=10),
        dict(step="def_drf", algo="drf", params=dict(ntrees=50), work=10),
        dict(step="def_dl", algo="deeplearning",
             params=dict(hidden=[32, 32], epochs=5), work=10),
        dict(step="grid_xgb", algo="xgboost", grid=dict(
            max_depth=[4, 6, 8], learn_rate=[0.05, 0.1, 0.3],
            sample_rate=[0.6, 0.8, 1.0]),
            params=dict(ntrees=60, nbins=64), max_grid_models=3, work=90),
        dict(step="grid_gbm", algo="gbm", grid=dict(
            max_depth=[3, 5, 7], learn_rate=[0.05, 0.1, 0.2],
            sample_rate=[0.8, 1.0]),
            params=dict(ntrees=50), max_grid_models=4, work=60),
        dict(step="grid_dl", algo="deeplearning", grid=dict(
            hidden=[[16], [32, 32], [64]],
            input_dropout_ratio=[0.0, 0.1]),
            params=dict(epochs=5), max_grid_models=2, work=30),
    ]


# exploration:exploitation budget split (AutoML.java:346 — by default 0.1
# of the remaining budget refines the incumbent best GBM/XGBoost)
_EXPLOITATION_RATIO = 0.1

_TREE_FAMILY = {"gbm", "drf", "xgboost", "extendedisolationforest",
                "isolationforest"}


class TEPipelineModel(Model):
    """A trained model plus its target-encoding step: a scoring frame
    missing the ``_te`` columns is transformed first, then delegated.
    Shares the inner model's params (so its key), output dict and
    device, so leaderboards see the real model; the MOJO writers refuse
    it by ``output["preprocessing_te_key"]``."""

    def __init__(self, inner: Model, te_model, te_cols: List[str]):
        self.inner = inner
        self.te = te_model
        self.te_cols = list(te_cols)
        self.algo = inner.algo
        self.params = inner.params
        self.output = inner.output
        self.device = inner.device
        self.run_time_ms = inner.run_time_ms
        self.output["preprocessing_te_key"] = str(te_model.key)

    def _augment(self, frame: Frame) -> Frame:
        if all(c in frame.names for c in self.te_cols):
            return frame
        enc = self.te.transform(frame, as_training=False, noise=0.0)
        out = Frame(list(frame.names), list(frame.vecs))
        for c in self.te_cols:
            if c not in out.names:
                out.add(c, enc.vec(c))
        return out

    def predict_raw(self, frame: Frame):
        return self.inner.predict_raw(self._augment(frame))

    def predict(self, frame: Frame) -> Frame:
        return self.inner.predict(self._augment(frame))

    def model_metrics(self, frame: Frame = None):
        return self.inner.model_metrics(
            self._augment(frame) if frame is not None else None)


class AutoML:
    """The h2o.automl.H2OAutoML surface: train many models, rank,
    ensemble."""

    def __init__(self, max_models: int = 0, max_runtime_secs: float = 0.0,
                 seed: int = -1, nfolds: int = 5,
                 include_algos: Optional[List[str]] = None,
                 exclude_algos: Optional[List[str]] = None,
                 stopping_rounds: int = 3, stopping_metric: str = "AUTO",
                 stopping_tolerance: float = -1.0,
                 sort_metric: Optional[str] = None,
                 preprocessing: Optional[List[str]] = None,
                 project_name: str = "", device: DeviceLike = None):
        preprocessing = list(preprocessing or [])
        bad = [s for s in preprocessing if s != "target_encoding"]
        if bad:
            raise ValueError(f"unsupported preprocessing steps {bad}; "
                             "only ['target_encoding'] is supported "
                             "(matches the reference's experimental "
                             "surface)")
        if not max_models and not max_runtime_secs:
            max_runtime_secs = 3600.0   # reference default budget
        self.device = cloud(device)
        self.params = dict(max_models=max_models,
                           max_runtime_secs=max_runtime_secs, seed=seed,
                           nfolds=nfolds, include_algos=include_algos,
                           exclude_algos=exclude_algos,
                           stopping_rounds=stopping_rounds,
                           stopping_metric=stopping_metric,
                           stopping_tolerance=stopping_tolerance,
                           preprocessing=preprocessing,
                           project_name=project_name)
        self.project_name = project_name or f"automl_{int(time.time())}"
        self.leaderboard = Leaderboard(self.project_name,
                                       sort_metric=sort_metric)
        self.event_log = EventLog()
        self.key = Key.make(f"automl_{self.project_name}")
        self._job: Optional[Job] = None

    # -- public surface -----------------------------------------------------

    @property
    def leader(self):
        return self.leaderboard.leader

    def train_async(self, x=None, y=None, training_frame=None,
                    validation_frame=None, leaderboard_frame=None) -> Job:
        """Publish the run under its project name and key (the ids a
        client polls mid-run) and start it as a job."""
        job = Job(dest=self.project_name, dest_type="Key<AutoML>",
                  description=f"AutoML {self.project_name}")
        self._job = job
        dkv().put(self.project_name, self)
        dkv().put(self.key, self)
        jobs().start(job, in_caller_threads(
            lambda j: self._run(j, x, y, training_frame, validation_frame,
                                leaderboard_frame)))
        return job

    def train(self, x=None, y=None, training_frame=None,
              validation_frame=None, leaderboard_frame=None):
        self.train_async(x=x, y=y, training_frame=training_frame,
                         validation_frame=validation_frame,
                         leaderboard_frame=leaderboard_frame).join()
        return self

    # -- plan execution -----------------------------------------------------

    def _allowed(self, algo: str) -> bool:
        inc = self.params.get("include_algos")
        exc = self.params.get("exclude_algos") or []
        if inc is not None:
            return algo.lower() in [a.lower() for a in inc]
        return algo.lower() not in [a.lower() for a in exc]

    def _run(self, job: Job, x, y, train: Frame, valid, lb_frame):
        p = self.params
        seed = int(p["seed"] if p["seed"] is not None else -1)
        dev = self.device
        ev = self.event_log
        ev.info("init", f"project {self.project_name}: AutoML build started")
        if lb_frame is not None:
            self.leaderboard.leaderboard_frame = lb_frame
            ev.info("init", f"ranking on leaderboard frame {lb_frame.key}")
        budget = _Budget(float(p["max_runtime_secs"] or 0),
                         int(p["max_models"] or 0))

        # one shared fold assignment for every model (Modulo on a fold
        # column); nfolds == 0 disables CV (and the ensembles with it)
        nfolds = int(p["nfolds"])
        if nfolds != 0 and nfolds < 2:
            raise ValueError(f"AutoML nfolds must be 0 (CV off) or >= 2; "
                             f"got {nfolds}")
        if nfolds == 0:
            work = train
            common = dict(seed=seed)
            ev.info("init", "cross-validation disabled (nfolds=0)")
        else:
            fold_name = "__automl_fold__"
            fold = (np.arange(train.nrows) % nfolds).astype(np.float32)
            work = Frame(list(train.names) + [fold_name],
                         list(train.vecs) + [Vec(fold)])
            ev.info("init",
                    f"{nfolds}-fold Modulo CV on a shared fold column")
            common = dict(fold_column=fold_name,
                          keep_cross_validation_predictions=True, seed=seed)
        x_cols = [c for c in (x or train.names) if c != y]

        # preprocessing: target encoding (ai/h2o/automl/preprocessing/
        # TargetEncoding.java) — CV-safe encodings on the shared fold
        # column, appended for the tree-family steps (originals kept)
        te, te_cols = None, []
        if "target_encoding" in (p.get("preprocessing") or []):
            cat_x = [c for c in x_cols
                     if c in work.names and work.vec(c).is_categorical]
            if cat_x:
                te_p = dict(noise=0.0, seed=seed)
                if nfolds:
                    te_p.update(data_leakage_handling="KFold",
                                fold_column=fold_name)
                te = builder_class("targetencoder")(device=dev, **te_p).train(
                    x=cat_x, y=y, training_frame=work)
                dkv().put(te.key, te)
                enc = te.transform(work, as_training=bool(nfolds),
                                   noise=0.0)
                for c in cat_x:
                    nm = f"{c}_te"
                    work = Frame(list(work.names) + [nm],
                                 list(work.vecs) + [enc.vec(nm)])
                    te_cols.append(nm)
                ev.info("init", f"target encoding applied to {cat_x} "
                                f"({'KFold' if nfolds else 'simple'})")
            else:
                ev.info("init", "target_encoding requested but no "
                                "categorical predictors; skipped")

        valid_te = None
        if te_cols and valid is not None:
            enc_v = te.transform(valid, as_training=False, noise=0.0)
            valid_te = Frame(list(valid.names), list(valid.vecs))
            for c in te_cols:
                valid_te.add(c, enc_v.vec(c))

        def train_one(algo: str, prm: Dict, step: str, work_share=None):
            if budget.exhausted():
                return None
            prm = dict(prm)
            prm.update(common)
            if budget.max_runtime:
                # WorkAllocations: a step gets its weighted share of the
                # remaining clock, never more than what is left
                prm["max_runtime_secs"] = min(
                    budget.remaining(),
                    work_share or budget.remaining())
            try:
                t = time.time()
                use_te = bool(te_cols) and algo in _TREE_FAMILY
                x_step = x_cols + te_cols if use_te else x_cols
                m = builder_class(algo)(device=dev, **prm).train(
                    x=x_step, y=y, training_frame=work,
                    validation_frame=valid_te if use_te else valid)
                if use_te:
                    m = TEPipelineModel(m, te, te_cols)
                dkv().put(m.key, m)
                budget.n_models += 1
                self.leaderboard.add(m)
                ev.info(step, f"{algo} trained in {time.time() - t:.1f}s "
                              f"-> {m.key}")
                return m
            except Exception as e:  # noqa: BLE001 — log + continue the plan
                ev.info(step, f"{algo} FAILED: {e!r}")
                return None

        plan = _default_plan(seed)
        allowed = [it for it in plan if self._allowed(it["algo"])]
        total_work = sum(it.get("work", 10) for it in allowed) or 1
        explore_budget = budget.remaining() * (1 - _EXPLOITATION_RATIO) \
            if budget.max_runtime else 0.0
        n_steps = len(plan) + 2
        for i, item in enumerate(plan):
            job.update(i / n_steps, item["step"])
            if not self._allowed(item["algo"]) or budget.exhausted():
                continue
            share = explore_budget * item.get("work", 10) / total_work \
                if budget.max_runtime else None
            if "grid" in item:
                self._run_grid(item, train_one, seed, share)
            else:
                train_one(item["algo"], item["params"], item["step"],
                          share)

        # exploitation phase (AutoML.java:457-460): refine the incumbent
        # best GBM/XGBoost with its own hyper-neighborhood
        job.update((n_steps - 2) / n_steps, "exploitation")
        if not budget.exhausted():
            self._exploitation(train_one, budget)

        job.update((n_steps - 1) / n_steps, "stacked ensembles")
        if self._allowed("stackedensemble") and \
                len(self.leaderboard.models) >= 2:
            self._build_ensembles(budget, work, y, valid, seed)

        ev.info("done", f"AutoML build done: {budget.n_models} models")
        return self

    def _run_grid(self, item: Dict, train_one, seed: int,
                  work_share=None) -> None:
        """Random-discrete mini-grid inside the plan (grids phase)."""
        names = list(item["grid"])
        rng = np.random.default_rng(None if seed < 0 else seed)
        combos = [dict(zip(names, vs)) for vs in
                  itertools.product(*(item["grid"][n] for n in names))]
        rng.shuffle(combos)
        n = max(1, int(item.get("max_grid_models", 3)))
        per_model = work_share / n if work_share else None
        for combo in combos[:n]:
            prm = dict(item["params"])
            prm.update(combo)
            train_one(item["algo"], prm, item["step"], per_model)

    def _exploitation(self, train_one, budget: _Budget) -> None:
        """Refine the incumbent best tree model (the reference's
        exploitation steps: GBM lr_annealing, XGBoost lr search —
        modeling/{GBM,XGBoost}StepsProvider exploitation groups)."""
        ranked = self.leaderboard.sorted_models()
        best_tree = next((m for m in ranked
                          if m.algo in ("gbm", "xgboost", "drf")), None)
        if best_tree is None or best_tree.algo == "drf":
            return
        base = {k: v for k, v in best_tree.params.items()
                if k in ("ntrees", "max_depth", "learn_rate",
                         "sample_rate", "min_rows",
                         "col_sample_rate_per_tree") and v is not None}
        share = budget.remaining() * 0.5 if budget.max_runtime else None
        # lr annealing: same depth, slower schedule, more trees
        accepted = builder_class(best_tree.algo)(device=self.device).params
        prm = dict(base)
        prm.update(ntrees=int(base.get("ntrees", 50) * 2),
                   learn_rate=float(base.get("learn_rate", 0.1)) / 2)
        if "learn_rate_annealing" in accepted:
            prm["learn_rate_annealing"] = 0.99
        train_one(best_tree.algo, prm, "exploit_lr_annealing", share)
        # sample-rate neighborhood
        prm2 = dict(base)
        prm2["sample_rate"] = min(
            1.0, float(base.get("sample_rate", 1.0)) * 0.8 + 0.2)
        train_one(best_tree.algo, prm2, "exploit_sample_rate", share)

    def _build_ensembles(self, budget: _Budget, work: Frame, y: str, valid,
                         seed: int) -> None:
        ranked = self.leaderboard.sorted_models()
        with_cv = [m for m in ranked if m.output.get(
            "cross_validation_holdout_predictions_frame_id")]
        if len(with_cv) < 2:
            return
        # best of family: the best model of each algo
        bof, seen = [], set()
        for m in with_cv:
            if m.algo not in seen:
                bof.append(m)
                seen.add(m.algo)
        for name, base in (("BestOfFamily", bof), ("AllModels", with_cv)):
            if len(base) < 2:
                continue
            if budget.max_runtime and budget.remaining() <= 0:
                self.event_log.info(
                    "ensemble", f"StackedEnsemble {name} skipped: "
                                "runtime budget exhausted")
                continue
            try:
                t = time.time()
                se = builder_class("stackedensemble")(
                    device=self.device,
                    base_models=[str(m.key) for m in base], seed=seed,
                    max_runtime_secs=budget.remaining(),
                    model_id=f"StackedEnsemble_{name}_"
                             f"{self.project_name}").train(
                    y=y, training_frame=work, validation_frame=valid)
                dkv().put(se.key, se)
                budget.n_models += 1
                self.leaderboard.add(se)
                self.event_log.info(
                    "ensemble", f"StackedEnsemble {name} trained in "
                                f"{time.time() - t:.1f}s -> {se.key}")
            except Exception as e:  # noqa: BLE001
                self.event_log.info("ensemble",
                                    f"StackedEnsemble {name} FAILED: {e!r}")

    def to_dict(self) -> Dict[str, Any]:
        return {"project_name": self.project_name,
                "leaderboard": self.leaderboard.to_dict(),
                "event_log": self.event_log.to_dict(),
                "leader": str(self.leader.key) if self.leader else None}
