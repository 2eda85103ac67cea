"""Online scoring — port of ``h2o_tpu/serve/``.

- :mod:`h2o_tpu_torch.serve.engine` — ``ScoringEngine``: row-dict ->
  matrix encoding from the model's training schema, power-of-two batch
  bookkeeping, the model's device predict, and the pure-NumPy ``mojo``
  scorer for model types without one;
- :mod:`h2o_tpu_torch.serve.batcher` — micro-batching of concurrent
  requests into one engine call with a bounded admission queue (load
  shedding), per-request deadlines, and an adaptive tuner that retunes
  ``max_batch``/``max_delay_ms`` from measured load within pow2 bounds;
- :mod:`h2o_tpu_torch.serve.breaker` — the pre-emptive load-shedding
  circuit breaker (memory pressure + queue depth + p99 -> shrink / shed
  429 / trip 503, with hysteresis and half-open probes);
- :mod:`h2o_tpu_torch.serve.registry` — versioned deployments behind a
  stable alias (deploy / hot-swap / rollback / draining undeploy,
  canary, shadow) with per-deployment stats;
- :mod:`h2o_tpu_torch.serve.replica` — the replica fleet: N registries
  sharing one engine, DKV-published deployment records, health-gated
  round-robin routing with one bounded retry.

The REST surface over them (``/3/Serving``, the 429/503/408 mapping with
``Retry-After``) is ROADMAP P13.
"""

from h2o_tpu_torch.serve.batcher import (AdaptiveBatchTuner,  # noqa: F401
                                         BatcherStopped, MicroBatcher,
                                         QueueFull)
from h2o_tpu_torch.serve.breaker import (BreakerOpen,  # noqa: F401
                                         LoadBreaker, ShedLoad)
from h2o_tpu_torch.serve.engine import ScoringEngine  # noqa: F401
from h2o_tpu_torch.serve.registry import (ServingConfig,  # noqa: F401
                                          UnsupportedModelError, registry,
                                          serving_stats)
from h2o_tpu_torch.serve.replica import (NoHealthyReplica,  # noqa: F401
                                         ReplicaFleet, fleet)
