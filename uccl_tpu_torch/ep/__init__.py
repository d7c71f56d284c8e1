"""Expert-parallel engine: MoE dispatch and combine over a W-member EP world.

Port of ``uccl_tpu/ep/__init__.py``:

* :mod:`uccl_tpu_torch.ep.ops` — routing, dispatch and combine, at world 1
  and member-stacked at world W, and the MoE layer ``moe_ffn``.
* :mod:`uccl_tpu_torch.ep.gather` — the sorted dispatch's and combine's row
  gathers on hand-written kernels, each backward the other's gather.
* :mod:`uccl_tpu_torch.ep.ll` — the packed low-latency path.
* :mod:`uccl_tpu_torch.ep.pallas_a2a` — the member-major exchange on the
  hand-written kernels B9 (all-to-all) and B10 (one scheduled round).
* :class:`Buffer` — the DeepEP-shaped host API, with :class:`EventOverlap`,
  :class:`Config` and the handles.
* :class:`CrossPodMoE` — experts across DCN-connected pods, forward and
  backward (``ep.cross_pod``).
* :class:`ElasticBuffer` / :class:`ElasticKVCache` — HBM with pinned-host
  spill (``ep.elastic``).
* :class:`EngramTable` / :func:`mesh_fetch` — global row fetch across
  hosts and on the members' device (``ep.engram``).
"""

from uccl_tpu_torch.ep import gather, ll, ops, pallas_a2a
from uccl_tpu_torch.ep.buffer import Buffer, Config, EventOverlap, LowLatencyHandle
from uccl_tpu_torch.ep.cross_pod import CrossPodMoE
from uccl_tpu_torch.ep.elastic import ElasticBuffer, ElasticKVCache
from uccl_tpu_torch.ep.engram import EngramTable, mesh_fetch

__all__ = ["ops", "gather", "ll", "pallas_a2a", "Buffer", "Config", "EventOverlap", "LowLatencyHandle",
           "CrossPodMoE", "ElasticBuffer", "ElasticKVCache", "EngramTable", "mesh_fetch"]
