"""Continuous-batching serving engine.

Port of ``uccl_tpu/serving``: request scheduler, KV slot pool and serving
metrics over the port's dense and MoE serving stacks. Requests arrive at any
time, share one fixed KV slot pool, and each engine step admits, prefills,
decodes and retires, with every request's tokens equal to its own run
alone on the same slot programs (``replay_alone``), and on the CPU to the
one-shot ``generate`` oracle's. The prefix cache, speculative decoding, adapters,
the router, health, KV tiers, disaggregation and the fleet are not ported
yet (ROADMAP queue A item 10).
"""

from uccl_tpu_torch.serving.engine import (  # noqa: F401
    DenseBackend, MoEBackend, ServingEngine, replay_alone, replicate_backend,
)
from uccl_tpu_torch.serving.metrics import (  # noqa: F401
    ServingMetrics, percentile, percentiles_ms,
)
from uccl_tpu_torch.serving.request import Request, RequestState  # noqa: F401
from uccl_tpu_torch.serving.sampling import SamplingParams  # noqa: F401
from uccl_tpu_torch.serving.scheduler import (  # noqa: F401
    PRIORITY_CLASSES, FIFOScheduler, PriorityScheduler, TenantFairScheduler,
)
from uccl_tpu_torch.serving.slots import SlotPool  # noqa: F401

__all__ = [
    "DenseBackend", "MoEBackend", "ServingEngine", "replay_alone", "replicate_backend",
    "ServingMetrics", "percentile", "percentiles_ms", "Request", "RequestState",
    "SamplingParams", "PRIORITY_CLASSES", "FIFOScheduler", "PriorityScheduler",
    "TenantFairScheduler", "SlotPool",
]
