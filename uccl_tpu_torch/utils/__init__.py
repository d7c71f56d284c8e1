"""Shared substrate: config, logging, latency histograms, topology.

Port of ``uccl_tpu/utils`` (the equivalent of the reference's
``include/util`` + ``param.h`` layer), under the JAX package's names.
"""

from uccl_tpu_torch.utils.config import Param, param, set_env_file
from uccl_tpu_torch.utils.latency import LatencyHistogram
from uccl_tpu_torch.utils.logging import CHECK, DCHECK, get_logger, log

__all__ = [
    "param",
    "set_env_file",
    "Param",
    "get_logger",
    "log",
    "CHECK",
    "DCHECK",
    "LatencyHistogram",
]
