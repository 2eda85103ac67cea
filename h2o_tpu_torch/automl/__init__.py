"""AutoML — port of ``h2o_tpu/automl/``."""

from h2o_tpu_torch.automl.automl import AutoML  # noqa: F401
