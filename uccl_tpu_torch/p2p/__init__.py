"""P2P transfer engine: NIXL-style register/connect/one-sided read-write
over the network, with a C++ host runtime underneath.

Port of ``uccl_tpu/p2p`` with the JAX package's exports. The C++ engine is
``native/``'s, built into ``build/uccl_tpu_torch/native/`` at first use;
:class:`Endpoint` binds it via ctypes. Everything here is host code: CUDA
tensors cross through pinned staging (``Endpoint.send_device`` /
``recv_device``) or are staged by the caller (``WeightPublisher.publish``).
"""

from uccl_tpu_torch.p2p.endpoint import Endpoint, FIFO_ITEM_BYTES
from uccl_tpu_torch.p2p.ray_api import XferEndpoint
from uccl_tpu_torch.p2p.channel import Channel, FifoItem
from uccl_tpu_torch.p2p.eqds import PullPacer
from uccl_tpu_torch.p2p.sack import PathQuality, SackTxWindow
from uccl_tpu_torch.p2p.weight_push import (WeightPublisher, WeightSnapshot,
                                            fetch as fetch_weights)

__all__ = ["Endpoint", "FIFO_ITEM_BYTES", "Channel", "FifoItem", "PullPacer",
           "PathQuality", "SackTxWindow", "XferEndpoint", "WeightPublisher",
           "WeightSnapshot", "fetch_weights"]
