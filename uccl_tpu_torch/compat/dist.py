"""torch.distributed-shaped process-group API over the DCN engine.

Port of ``uccl_tpu/compat/dist.py``. The reference plugs under
``torch.distributed`` (NCCL plugin) so its users write
``dist.init_process_group / all_reduce / all_gather / barrier``. This module
keeps those verbs for buffers across processes — backed by the rendezvous
store + DcnGroup ring — so reference-style launch scripts port with a
changed import. Member collectives on the card live in
``uccl_tpu_torch.collective.Communicator``; this is the process-group face.

Ops mutate in place like torch.distributed: ``all_reduce(x)`` leaves the
global sum in ``x`` and returns None. numpy arrays keep the JAX package's
in-place rules. A torch tensor on either device is reduced in place too
(the JAX package returns a new array only because a jax array cannot
change): a CUDA tensor is staged through pinned host memory, the DCN
collective runs on the host copy, and the result is copied back into the
tensor. Dtypes numpy lacks (bfloat16, fp8) move as same-width integers and
are summed in float32, then cast back.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from uccl_tpu_torch.collective.hierarchical import DcnGroup
from uccl_tpu_torch.p2p.endpoint import host_array, host_copy
from uccl_tpu_torch.parallel.distributed import Session
from uccl_tpu_torch.utils.logging import get_logger

_log = get_logger("COLL")

_group: Optional[DcnGroup] = None
_session: Optional[Session] = None


def init_process_group(
    rank: int,
    world_size: int,
    *,
    master_addr: str = "127.0.0.1",
    master_port: int = 29500,
    n_paths: int = 2,
) -> None:
    """Bring up the default process group (rank 0 hosts the store)."""
    global _group, _session
    if _group is not None:
        raise RuntimeError("process group already initialized")
    from uccl_tpu_torch.parallel.distributed import initialize

    try:
        # Reuse the session bootstrap (rank 0 serves the store at master_port
        # and connects to itself via loopback; failures close the server).
        _session = initialize(
            f"{master_addr}:{master_port}",
            rank,
            world_size,
            store_port=master_port,
            init_torch=False,
        )
        _group = DcnGroup(_session, n_paths=n_paths, tag="default_pg")
    except Exception:
        destroy_process_group()  # release partial state so retry can succeed
        raise
    _log.info("process group up: rank %d/%d", rank, world_size)


def is_initialized() -> bool:
    return _group is not None


def _require() -> DcnGroup:
    if _group is None:
        raise RuntimeError("call init_process_group first")
    return _group


def get_rank() -> int:
    """This rank's POSITION in the active group (torch.distributed invariant
    rank < world_size holds across elastic heals; == the global rank until a
    lower-numbered rank dies). Collective row indices use the same positions."""
    return _require().pos


def get_world_size() -> int:
    """Size of the ACTIVE group (shrinks after an elastic heal)."""
    return _require().active_world


_NUMPY_FLOATS = (torch.float16, torch.float32, torch.float64)


def _host(x: torch.Tensor, reduce: bool) -> np.ndarray:
    """A host numpy copy of ``x`` for the DCN collective: pinned staging for
    a CUDA tensor; float32 for a reduction of a dtype numpy cannot sum."""
    t = x.detach()
    if reduce and t.is_floating_point() and t.dtype not in _NUMPY_FLOATS:
        t = t.float()
    return host_array(host_copy(t))


def _into(x: torch.Tensor, host: np.ndarray) -> None:
    """Copy a host result back into ``x`` (its dtype, its device)."""
    src = torch.from_numpy(np.ascontiguousarray(host))
    if src.dtype != x.dtype:
        # a float32 sum casts back; an integer view of bf16/fp8 bytes
        # reinterprets
        src = src.to(x.dtype) if src.is_floating_point() else src.view(x.dtype)
    x.copy_(src.reshape(x.shape))


def all_reduce(x):
    """Sum across the group, in place (torch.distributed semantics);
    returns None. numpy arrays and torch tensors on either device."""
    g = _require()
    if isinstance(x, torch.Tensor):
        _into(x, g.all_reduce(_host(x, reduce=True)))
        return None
    x[...] = g.all_reduce(x)
    return None


def all_gather(out_list: Optional[List], x):
    """Fill out_list[i] with the i-th ACTIVE rank's x (== rank i before any
    heal; after a heal, positions close the gap and the list shrinks)."""
    g = _require()
    if out_list is None or len(out_list) != g.active_world:
        # validate BEFORE participating: a caller error must fail fast, not
        # after this rank already joined the collective (which would leave
        # the group skewed for the other ranks)
        raise ValueError(
            f"out_list has {0 if out_list is None else len(out_list)} "
            f"entries; active world size is {g.active_world}"
        )
    is_t = isinstance(x, torch.Tensor)
    gathered = g.all_gather(_host(x, reduce=False) if is_t else x)
    for i in range(g.active_world):
        if isinstance(out_list[i], torch.Tensor):
            _into(out_list[i], gathered[i])
        else:
            out_list[i][...] = gathered[i]
    return None


def all_to_all(out, x):
    """out[i] receives the i-th active rank's row for us; x[j] goes to the
    j-th active rank."""
    g = _require()
    if isinstance(x, torch.Tensor):
        res = g.all_to_all(_host(x, reduce=False))
    else:
        res = g.all_to_all(x)
    if isinstance(out, torch.Tensor):
        _into(out, res)
    else:
        out[...] = res
    return None


def broadcast(x, src: int = 0):
    """Every rank ends with src's x (binomial tree over the DCN full mesh —
    log(world) rounds, no gather blow-up), in place."""
    g = _require()
    if isinstance(x, torch.Tensor):
        _into(x, g.broadcast(_host(x, reduce=False), root=src))
        return None
    x[...] = g.broadcast(x, root=src)
    return None


def barrier() -> None:
    _require().barrier()


def destroy_process_group() -> None:
    global _group, _session
    if _group is not None:
        _group.close()
        _group = None
    if _session is not None:
        _session.close()  # closes store client and (on rank 0) the server
        _session = None
