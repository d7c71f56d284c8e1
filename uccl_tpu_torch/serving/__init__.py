"""Continuous-batching serving engine.

Port of ``uccl_tpu/serving``: request scheduler, KV slot pool and serving
metrics over the port's dense and MoE serving stacks, with chunked prefill
and preemption, speculative decoding (``spec``), the prefix cache and its
host tier (``prefix_cache``, ``kv_tiers``), per-tenant LoRA adapters
(``adapters``), failure detection (``health``) and the replica router
(``router``). Requests arrive at any time, share one fixed KV slot pool,
and each engine step admits, prefills, decodes and retires, with every
request's tokens equal to its own run alone on the same slot programs
(``replay_alone``), and on the CPU to the one-shot ``generate`` oracle's.
Disaggregated prefill (``disagg``) and the fleet prefix directory
(``fleet``) ride the p2p plane and are imported explicitly by their
consumers: they pull in the p2p runtime.
"""

from uccl_tpu_torch.serving.adapters import AdapterStore, make_lora, materialize  # noqa: F401
from uccl_tpu_torch.serving.engine import (  # noqa: F401
    ChunkEvent, DenseBackend, MoEBackend, ServingEngine, replay_alone, replicate_backend,
)
from uccl_tpu_torch.serving.health import FailureDetector, abandon_engine  # noqa: F401
from uccl_tpu_torch.serving.kv_tiers import HostKVTier, TieredKVCache, TierRef  # noqa: F401
from uccl_tpu_torch.serving.metrics import (  # noqa: F401
    ServingMetrics, percentile, percentiles_ms,
)
from uccl_tpu_torch.serving.prefix_cache import PrefixCache  # noqa: F401
from uccl_tpu_torch.serving.request import Request, RequestState  # noqa: F401
from uccl_tpu_torch.serving.router import Router, replica_signals  # noqa: F401
from uccl_tpu_torch.serving.sampling import SamplingParams  # noqa: F401
from uccl_tpu_torch.serving.scheduler import (  # noqa: F401
    PRIORITY_CLASSES, FIFOScheduler, PriorityScheduler, TenantFairScheduler,
)
from uccl_tpu_torch.serving.slots import SlotPool  # noqa: F401
from uccl_tpu_torch.serving.spec import Drafter, NGramDrafter  # noqa: F401

__all__ = [
    "AdapterStore", "make_lora", "materialize", "ChunkEvent", "DenseBackend", "MoEBackend",
    "ServingEngine", "replay_alone", "replicate_backend", "FailureDetector", "abandon_engine",
    "HostKVTier", "TieredKVCache", "TierRef", "ServingMetrics", "percentile", "percentiles_ms",
    "PrefixCache", "Request", "RequestState", "Router", "replica_signals", "SamplingParams",
    "PRIORITY_CLASSES", "FIFOScheduler", "PriorityScheduler", "TenantFairScheduler",
    "SlotPool", "Drafter", "NGramDrafter",
]
