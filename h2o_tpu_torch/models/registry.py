"""Algorithm registry — port of ``h2o_tpu/models/registry.py`` (``_ALGOS``
:14-44, ``builders`` :49-57, ``builder_class`` :60-65, ``model_class``
:68-69; reference hex/api/RegisterAlgos.java:17-42).

Grid search and AutoML resolve a builder by its algo name here.  The
table keeps the reference's order, mapped to the port's modules.  A
module that fails to import is logged and left out of ``builders()``;
``builder_class`` of that algo raises the import error instead of
treating the algo as unknown.
"""

from __future__ import annotations

import importlib
from typing import Dict

from h2o_tpu_torch.core.lockwitness import make_lock
from h2o_tpu_torch.core.log import get_logger

log = get_logger("registry")

# (algo key, module, class) — order mirrors RegisterAlgos registration
_ALGOS = [
    ("gbm", "h2o_tpu_torch.models.tree.gbm", "GBM"),
    ("drf", "h2o_tpu_torch.models.tree.drf", "DRF"),
    ("xgboost", "h2o_tpu_torch.models.tree.xgboost", "XGBoost"),
    ("dt", "h2o_tpu_torch.models.tree.dt", "DT"),
    ("isolationforest", "h2o_tpu_torch.models.tree.isofor",
     "IsolationForest"),
    ("extendedisolationforest", "h2o_tpu_torch.models.tree.isofor",
     "ExtendedIsolationForest"),
    ("upliftdrf", "h2o_tpu_torch.models.tree.uplift", "UpliftDRF"),
    ("glm", "h2o_tpu_torch.models.glm", "GLM"),
    ("gam", "h2o_tpu_torch.models.gam", "GAM"),
    ("kmeans", "h2o_tpu_torch.models.kmeans", "KMeans"),
    ("deeplearning", "h2o_tpu_torch.models.deeplearning", "DeepLearning"),
    ("pca", "h2o_tpu_torch.models.pca", "PCA"),
    ("svd", "h2o_tpu_torch.models.svd", "SVD"),
    ("glrm", "h2o_tpu_torch.models.glrm", "GLRM"),
    ("word2vec", "h2o_tpu_torch.models.word2vec", "Word2Vec"),
    ("naivebayes", "h2o_tpu_torch.models.naive_bayes", "NaiveBayes"),
    ("coxph", "h2o_tpu_torch.models.coxph", "CoxPH"),
    ("isotonicregression", "h2o_tpu_torch.models.isotonic",
     "IsotonicRegression"),
    ("aggregator", "h2o_tpu_torch.models.aggregator", "Aggregator"),
    ("targetencoder", "h2o_tpu_torch.models.target_encoder",
     "TargetEncoder"),
    ("rulefit", "h2o_tpu_torch.models.rulefit", "RuleFit"),
    ("modelselection", "h2o_tpu_torch.models.modelselection",
     "ModelSelection"),
    ("anovaglm", "h2o_tpu_torch.models.anovaglm", "AnovaGLM"),
    ("psvm", "h2o_tpu_torch.models.psvm", "PSVM"),
    ("infogram", "h2o_tpu_torch.models.infogram", "Infogram"),
    ("generic", "h2o_tpu_torch.models.generic", "Generic"),
    ("stackedensemble", "h2o_tpu_torch.models.ensemble", "StackedEnsemble"),
    ("grep", "h2o_tpu_torch.models.grep", "Grep"),
]

_cache: Dict[str, type] = {}
#: algo -> the exception its module's import raised
_failed: Dict[str, Exception] = {}
_lock = make_lock("registry._lock")


def _load() -> None:
    with _lock:
        if _cache or _failed:
            return
        for algo, module, cls in _ALGOS:
            try:
                _cache[algo] = getattr(importlib.import_module(module), cls)
            except Exception as e:  # noqa: BLE001 — raised by builder_class
                _failed[algo] = e
                log.warning("algo %s unavailable: %r", algo, e)


def builders() -> Dict[str, type]:
    """Every builder whose module imported, by algo key."""
    _load()
    return dict(_cache)


def builder_class(algo: str) -> type:
    _load()
    key = algo.lower()
    if key in _failed:
        raise ImportError(f"algo '{algo}' failed to import: "
                          f"{_failed[key]!r}") from _failed[key]
    if key not in _cache:
        raise KeyError(f"unknown algo '{algo}'; have {sorted(_cache)}")
    return _cache[key]


def model_class(algo: str) -> type:
    return builder_class(algo).model_cls
