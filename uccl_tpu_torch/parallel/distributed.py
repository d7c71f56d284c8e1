"""Multi-host session bootstrap.

Port of ``uccl_tpu/parallel/distributed.py``. One call per process:

* :func:`initialize` — brings up ``torch.distributed`` on the coordinator's
  address (the ``gloo`` backend: the card's collectives are the port's own
  :class:`~uccl_tpu_torch.collective.Communicator`, and NCCL cannot put two
  ranks on one card) and stands up the OOB rendezvous (rank 0 serves a
  :class:`~uccl_tpu_torch.p2p.store.StoreServer`, everyone gets a client).
* :func:`exchange` — all-gather style metadata exchange through the store
  (the analog of the reference's PeerMeta allgather, ep/src/proxy.cpp:210).
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional

from uccl_tpu_torch.p2p.store import StoreClient, StoreServer
from uccl_tpu_torch.utils.logging import get_logger

_log = get_logger("PARALLEL")


@dataclasses.dataclass
class Session:
    rank: int
    world: int
    store: StoreClient
    _server: Optional[StoreServer] = None
    _torch_pg: bool = False  # this session brought up torch.distributed

    def close(self):
        self.store.close()
        if self._server is not None:
            self._server.close()
        if self._torch_pg:
            import torch.distributed as td

            if td.is_initialized():
                td.destroy_process_group()
            self._torch_pg = False


def _init_torch(coordinator: str, rank: int, world: int) -> bool:
    """``torch.distributed`` over gloo at ``tcp://coordinator`` (rank 0
    hosts its TCP store on the coordinator port). Returns False when a
    process group is already up (the caller owns it)."""
    import torch.distributed as td

    if td.is_initialized():
        return False
    td.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                          world_size=world, rank=rank)
    return True


def initialize(
    coordinator: str,
    rank: int,
    world: int,
    *,
    store_port: int = 0,
    init_torch: bool = True,
) -> Session:
    """Bring up the distributed session.

    coordinator: ``ip:port`` of rank 0 (the ``torch.distributed``
    coordinator); the OOB store binds on rank 0 at ``store_port`` (or
    coordinator port + 1 when 0).
    """
    ip, port_s = coordinator.rsplit(":", 1)
    torch_pg = False
    if init_torch and world > 1:
        torch_pg = _init_torch(coordinator, rank, world)
    server = None
    sport = store_port or int(port_s) + 1
    try:
        if rank == 0:
            server = StoreServer(sport)
            sport = server.port
        client = StoreClient(ip if rank != 0 else "127.0.0.1", sport)
    except Exception:
        if server is not None:
            server.close()  # don't leak the bound port on a failed bootstrap
        if torch_pg:
            import torch.distributed as td

            td.destroy_process_group()
        raise
    sess = Session(rank=rank, world=world, store=client, _server=server,
                   _torch_pg=torch_pg)
    _log.info("session up: rank %d/%d store %s:%d", rank, world, ip, sport)
    return sess


def initialize_from_env() -> Session:
    """Bring up the session from launcher-provided environment variables
    (``scripts/launch.py`` sets them — the torchrun-shaped entry):

      UCCL_TPU_COORD     rank 0's ip:port
      UCCL_TPU_RANK      this process's global rank
      UCCL_TPU_WORLD     total processes
      UCCL_TPU_INIT_JAX  "0" to skip torch.distributed (default on; the
                         launcher's name for the runtime bring-up)
    """
    import os

    coord = os.environ["UCCL_TPU_COORD"]
    rank = int(os.environ["UCCL_TPU_RANK"])
    world = int(os.environ["UCCL_TPU_WORLD"])
    init_torch = os.environ.get("UCCL_TPU_INIT_JAX", "1") != "0"
    return initialize(coord, rank, world, init_torch=init_torch)


def exchange(sess: Session, key: str, payload: bytes, timeout_s: float = 60.0) -> List[bytes]:
    """Every rank contributes ``payload`` under ``key``; returns all ranks'
    payloads in rank order (the PeerMeta allgather)."""
    sess.store.set(f"{key}/{sess.rank}", payload)
    return [
        sess.store.wait(f"{key}/{r}", timeout_s=timeout_s)
        for r in range(sess.world)
    ]


def exchange_json(sess: Session, key: str, obj, timeout_s: float = 60.0) -> list:
    blobs = exchange(sess, key, json.dumps(obj).encode(), timeout_s)
    return [json.loads(b.decode()) for b in blobs]
