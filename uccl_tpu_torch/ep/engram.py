"""Engram-style remote-memory row fetch (reference: lite-ep's experimental
"0 SM Engram" primitive — deep_ep.ElasticBuffer.engram_write/engram_fetch,
tests/elastic/test_engram.py; csrc/kernels/elastic/engram.hpp).

Port of ``uccl_tpu/ep/engram.py``. Every rank owns a contiguous shard of a
global row table ``[world * entries, hidden]``; ``engram_fetch(indices)``
gathers rows by GLOBAL index from the owning ranks' memory, returning a hook
to overlap the fetch. Two deployment shapes, as in the JAX package:

* **on the members' device** (:func:`mesh_fetch`): the table is one tensor
  on the card holding every member's shard (``[rows, hidden]``, or
  member-stacked ``[W, entries, hidden]``) and the fetch is one
  ``index_select`` there.
* **cross-host** (:class:`EngramTable`): each host registers its shard as
  an advertised window on the transfer engine; ``fetch`` groups the
  requested global indices by owner and issues ONE batched one-sided
  ``readv`` per owner (vectorized descriptors: one ring pass, one proxy
  wake — engine.h readv), reassembling rows into their requested order.
  ``fetch_async`` returns a ``wait()`` hook so the caller overlaps the
  remote reads with local work — the reference's hook contract.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np


def mesh_fetch(table, indices):
    """Global-row gather on the members' device. ``table``: ``[rows,
    hidden]`` or member-stacked ``[W, entries, hidden]`` (global row ``g``
    is member ``g // entries``'s row ``g % entries``); ``indices``: [T]
    global row ids. Returns [T, hidden] on the table's device."""
    import torch

    table = torch.as_tensor(table)
    flat = table.reshape(-1, table.shape[-1])
    idx = torch.as_tensor(np.asarray(indices) if not torch.is_tensor(indices)
                          else indices).to(device=flat.device, dtype=torch.long)
    return torch.index_select(flat, 0, idx.reshape(-1))


class EngramTable:
    """One rank's view of a cross-host row table over the transfer engine.

    ``local_rows`` ([entries, hidden], c-contiguous; numpy or a CPU tensor)
    is registered and advertised once; :meth:`link` wires the per-peer
    connections and swaps window descriptors (symmetric send-then-recv, like the channel probe
    handshake). Global row ``g`` lives on rank ``g // entries`` at local
    offset ``g % entries``.
    """

    def __init__(self, ep, local_rows: np.ndarray, rank: int, world: int):
        from uccl_tpu_torch.p2p.endpoint import host_array

        local_rows = host_array(local_rows, "engram table")  # a CPU tensor: its view
        if not local_rows.flags["C_CONTIGUOUS"]:
            raise ValueError("local_rows must be C-contiguous")
        self.ep = ep
        self.rank = rank
        self.world = world
        self.rows = local_rows
        self.entries, self.hidden = local_rows.shape
        self.row_bytes = int(local_rows.strides[0])
        self._mr = ep.reg(local_rows)
        self._fifo = ep.advertise(self._mr)
        self._conns: Dict[int, int] = {}
        self._peer_fifos: Dict[int, bytes] = {}

    def link(self, peers: Dict[int, int]) -> None:
        """peers: {rank: conn_id} for every OTHER rank. Exchanges window
        descriptors so both directions can fetch."""
        from uccl_tpu_torch.p2p.channel import FifoItem  # noqa: F401 (doc link)

        self._conns = dict(peers)
        for r, conn in sorted(peers.items()):
            self.ep.send(conn, b"EG" + self._fifo)
        for r, conn in sorted(peers.items()):
            msg = self.ep.recv(conn, timeout_ms=30000)
            if not msg.startswith(b"EG"):
                raise IOError(f"engram link broken with rank {r}: {msg[:8]!r}")
            self._peer_fifos[r] = msg[2:]

    def _plan(self, indices: np.ndarray):
        owners = indices // self.entries
        offsets = indices % self.entries
        if (owners >= self.world).any() or (indices < 0).any():
            raise ValueError("global index out of range")
        return owners, offsets

    def fetch_async(self, indices) -> Tuple[np.ndarray, Callable[[], np.ndarray]]:
        """Start fetching rows by global index; returns ``(out, wait)``
        where ``wait()`` blocks until ``out`` ([T, hidden], requested
        order) is fully populated — the reference's hook contract, for
        overlapping remote reads with local compute."""
        from uccl_tpu_torch.p2p.channel import FifoItem

        idx = np.asarray(indices, np.int64).reshape(-1)
        owners, offsets = self._plan(idx)
        out = np.empty((idx.size, self.hidden), self.rows.dtype)
        pending: List[Tuple[int, int]] = []  # (conn, xid) batches
        for r in np.unique(owners):
            rows_here = np.nonzero(owners == r)[0]
            if r == self.rank:
                out[rows_here] = self.rows[offsets[rows_here]]
                continue
            item = FifoItem.unpack(self._peer_fifos[int(r)])
            dsts = [out[i] for i in rows_here]
            fifos = [
                item.slice(int(offsets[i]) * self.row_bytes, self.row_bytes
                           ).pack()
                for i in rows_here
            ]
            conn = self._conns[int(r)]
            for x in self.ep.readv_async(conn, dsts, fifos):
                pending.append((conn, x))

        def wait(timeout_ms: int = 30000) -> np.ndarray:
            failed = [
                x for _, x in pending if not self.ep.wait(x, timeout_ms)
            ]
            if failed:
                raise IOError(
                    f"engram fetch: {len(failed)}/{len(pending)} rows failed"
                )
            return out

        return out, wait

    def fetch(self, indices) -> np.ndarray:
        """Blocking fetch: rows [T, hidden] in requested order."""
        _, wait = self.fetch_async(indices)
        return wait()

    def close(self) -> None:
        self.ep.dereg(self._mr)
