"""Online scoring — port of ``h2o_tpu/serve/``, its first part.

:mod:`h2o_tpu_torch.serve.engine` holds ``ScoringEngine``: row-dict ->
padded ndarray encoding from the model's training schema, a bounded
table of predict callables with power-of-two batch bucketing on the
model's device, and the pure-NumPy ``mojo`` scorer for model types
without a device predict.

The reference's micro-batcher, deployment registry, load breaker and
replica fleet (``batcher.py``, ``registry.py``, ``breaker.py``,
``replica.py``) are not ported yet (ROADMAP P10b).
"""

from h2o_tpu_torch.serve.engine import ScoringEngine  # noqa: F401
