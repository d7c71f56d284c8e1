"""Hierarchical cross-pod collectives: the card's members inside a pod, DCN
between pods.

Port of ``uccl_tpu/collective/hierarchical.py``. Within a pod the
collectives are the port's :class:`~uccl_tpu_torch.collective.Communicator`
verbs on the members' device (the ring kernels B4/B5/B7); between pods,
where the host owns the wire, the transfer engine moves the data. The
canonical hierarchical allreduce:

  1. reduce_scatter over the pod's members (B5 when the plan is the ring) —
     each member ends with a reduced shard,
  2. allreduce of the shards across pods over DCN (ring over Channels, on
     host buffers: the shard is staged device to host),
  3. all_gather back over the members.

``DcnGroup`` is the cross-pod communicator: N processes (or threads), rank i
connected to its ring neighbors through multipath Channels, bootstrap via
the OOB store. Its wire protocol and its reduction order are the JAX
package's, so a port rank and a JAX rank share one ring and their sums are
bit-equal. One addition between two port ranks: a broadcast's receiver acks
the landing once it has copied it out (``BA``), because the JAX protocol
lets the root's next ``all_to_all`` write into the same bytes before the
receiver has read them; a JAX rank neither sends nor expects that ack. Works between any processes with TCP reach — the same code path
drives pod-to-pod DCN on real deployments and localhost pairs in tests.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np

from uccl_tpu_torch.p2p.channel import Channel, ChannelAcceptor, FifoItem
from uccl_tpu_torch.p2p.endpoint import Endpoint, host_copy
from uccl_tpu_torch.parallel.distributed import Session, exchange_json
from uccl_tpu_torch.utils.config import param
from uccl_tpu_torch.utils.logging import get_logger

_log = get_logger("COLL")

# DCN congestion control (reference: kSenderCCA, transport_config.h:96).
# One controller per group, on the ring tx channel — every write on this
# endpoint shares the one token-bucket pacer it actuates.
_cc_algo = param("cc", "off", help="DCN congestion control: off|timely|swift")


def _local_ip() -> str:
    """Address peers should dial: UCCL_TPU_HOST_IP env, else the hostname's
    address, else loopback (single-host default)."""
    import os
    import socket

    ip = os.environ.get("UCCL_TPU_HOST_IP")
    if ip:
        return ip
    try:
        ip = socket.gethostbyname(socket.gethostname())
        if ip and not ip.startswith("127."):
            return ip
    except OSError:
        pass
    return "127.0.0.1"


class DcnGroup:
    """Cross-process collective group over the DCN transfer engine.

    Bootstraps a bidirectional ring: every rank connects a Channel to its
    next neighbor and accepts one from its previous neighbor (addresses via
    the session's OOB store). ``tag`` must be unique per group per session
    (ranks must create groups in the same order).
    """

    def __init__(self, sess: Session, n_paths: int = 2, tag: str = "0"):
        self.rank = sess.rank
        self.world = sess.world
        self.n_paths = n_paths
        self.ep = Endpoint(n_engines=max(2, n_paths))
        self._addrs = exchange_json(
            sess,
            f"dcn_group/{tag}/addr",
            # "bcast_ack": this rank acks a broadcast landing once it has
            # copied it out (see broadcast); a JAX rank's entry lacks the
            # key and ignores it
            {"ip": _local_ip(), "port": self.ep.port, "bcast_ack": 1},
        )
        self._next: Optional[Channel] = None
        self._prev: Optional[Channel] = None
        self._ring_mr: Optional[int] = None
        self._ring_recv: Optional[np.ndarray] = None
        self._peer_fifo: Optional[bytes] = None
        # full-mesh state (built lazily on first pairwise op)
        self._mesh: dict = {}  # peer rank -> Channel
        self._mesh_buf: Optional[np.ndarray] = None
        self._mesh_mr: Optional[int] = None
        self._mesh_seg = 0  # bytes per source region in the landing buffer
        self._mesh_fifos: dict = {}  # peer -> FifoItem into MY region on peer
        # all_to_all pipelined-license state (parity double buffering):
        # per-peer call counters, received-consume-license high-water marks,
        # and an epoch bumped on every landing-buffer regrow so stale
        # license messages from the previous buffer generation are discarded
        self._a2a_w: dict = {}  # peer -> my completed writes toward it
        self._a2a_r: dict = {}  # peer -> my completed reads from it
        self._a2a_lic: dict = {}  # peer -> highest C index received
        self._a2a_epoch = 0
        # Inbound channels arrive tagged by the dialer's meta; the acceptor
        # dispatches any interleaving of concurrent dialers (full mesh).
        self._inbound: dict = {}
        self._inbound_cv = threading.Condition()
        self._broken = False  # poisoned after a failed descriptor exchange
        # Elastic membership: collectives run over the ACTIVE ranks; heal()
        # drops dead peers and re-links the ring among survivors (the group-
        # level closure of the reference's add/remove_remote_endpoint,
        # p2p/engine.h:269,273 — the endpoint-level verbs are connect()/
        # remove_conn() on self.ep).
        self._active: List[int] = list(range(self.world))
        self._heal_epoch = 0
        self._acceptor = (
            ChannelAcceptor(self.ep, self._on_inbound) if self.world > 1 else None
        )
        if self.world > 1:
            try:
                self._ring_connect()
            except Exception:
                # Don't leak the acceptor thread + native endpoint when the
                # bootstrap dies (a peer crashed post-rendezvous).
                self.close()
                raise

    def _member_tag(self) -> bytes:
        """Digest of the ACTIVE membership. Channel metas carry it so two
        ranks only pair channels when their membership views agree — and a
        survivor that healed through different intermediate batches (e.g.
        heal([2]) then heal([2,3]) vs one heal([2,3])) still converges with
        peers once the views match, which a per-rank call counter cannot
        guarantee."""
        import hashlib

        return hashlib.md5(
            ",".join(map(str, self._active)).encode()
        ).hexdigest()[:8].encode()

    def _ring_connect(self) -> None:
        """(Re)link the bidirectional ring over the active ranks; channel
        metas carry the membership digest so survivors with diverged views
        never cross-wire."""
        n = len(self._active)
        if n <= 1:
            self._next = self._prev = None
            return
        pos = self._active.index(self.rank)
        nxt_rank = self._active[(pos + 1) % n]
        prv_rank = self._active[(pos - 1) % n]
        a = self._addrs[nxt_rank]
        self._next = Channel.connect(
            self.ep, a["ip"], a["port"], self.n_paths,
            meta=b"ring:%s:%d" % (self._member_tag(), self.rank),
        )
        self._prev = self._wait_inbound(
            b"ring:%s:%d" % (self._member_tag(), prv_rank)
        )
        algo = str(_cc_algo.get())
        if algo != "off":
            self._next.enable_cc(algo)

    def _on_inbound(self, chan: Channel):
        with self._inbound_cv:
            self._inbound[bytes(chan.meta)] = chan
            self._inbound_cv.notify_all()

    def _wait_inbound(self, meta: bytes, timeout_s: float = 60.0) -> Channel:
        with self._inbound_cv:
            if not self._inbound_cv.wait_for(
                lambda: meta in self._inbound, timeout=timeout_s
            ):
                raise ConnectionError(
                    f"bootstrap failed: no inbound channel {meta!r}"
                )
            return self._inbound[meta]

    def heal(self, dead_ranks) -> None:
        """Drop dead peers and re-link the ring among survivors.

        Every survivor must call heal() with the same dead set (e.g. from a
        HeartbeatMonitor on_failure, or after a collective raised). After it
        returns, ring collectives and broadcast run over the survivors; the
        positions of remaining ranks shift to close the gap.
        """
        dead = set(dead_ranks)
        if self.rank in dead:
            raise RuntimeError("cannot heal a group from a dead rank")
        if not dead & set(self._active):
            return
        self._active = [r for r in self._active if r not in dead]
        self._heal_epoch += 1
        # Mesh channels are torn down WHOLESALE, survivors included: an
        # aborted collective may have left half-consumed R/D control bytes
        # (or a poisoned descriptor exchange) on any of them; fresh epoch-
        # tagged channels re-establish lazily with clean queues.
        for r, ch in list(self._mesh.items()):
            ch.close()
        self._mesh.clear()
        self._mesh_fifos.clear()
        self._mesh_buf = None
        self._mesh_seg = 0
        if self._mesh_mr is not None:
            self.ep.dereg(self._mesh_mr)
            self._mesh_mr = None
        self._broken = False
        for ch in (self._next, self._prev):
            if ch is not None:
                ch.close()
        self._next = self._prev = None
        # ring landing state must re-exchange over the new neighbors
        self._ring_recv = None
        self._peer_fifo = None
        if self._ring_mr is not None:
            self.ep.dereg(self._ring_mr)
            self._ring_mr = None
        self._ring_connect()
        _log.warning(
            "healed ring: epoch %d, active ranks %s", self._heal_epoch,
            self._active,
        )

    @property
    def active_world(self) -> int:
        return len(self._active)

    @property
    def pos(self) -> int:
        return self._active.index(self.rank)

    def close(self):
        if self._next is not None:
            self._next.disable_cc()
        if self._acceptor is not None:
            self._acceptor.close()
        self.ep.close()

    # ------------------------------------------------------------------
    def _setup_ring_buf(self, nbytes: int, dtype) -> np.ndarray:
        """(Re)advertise the hop landing buffer: one byte-window serves every
        hop of every collective (no per-hop registrations to leak); it only
        regrows — and re-exchanges descriptors — when a larger payload
        arrives, which happens in lockstep on all ranks (SPMD collectives)."""
        if self._ring_recv is None or self._ring_recv.nbytes < nbytes:
            if self._ring_mr is not None:
                self.ep.dereg(self._ring_mr)
            self._ring_recv = np.empty(max(nbytes, 1), np.uint8)
            self._ring_mr = self.ep.reg(self._ring_recv)
            fifo = self.ep.advertise(self._ring_mr)
            self._prev.send(b"FIFO" + fifo)
            msg = self._next.recv(timeout_ms=30000)
            if not msg.startswith(b"FIFO"):
                raise IOError(f"ring fifo exchange broken: {msg[:16]!r}")
            self._peer_fifo = msg[4:]
        return self._ring_recv[:nbytes].view(dtype)

    def _ring_hop(self, send_arr: np.ndarray):
        """One hop: signal ready, one-sided write to next, confirm done.

        The per-hop READY from the receiver is what licenses the writer to
        reuse the landing window — without it hop s+1 could overwrite data
        the receiver is still consuming from hop s.
        """
        self._prev.send(b"R")
        if self._next.recv(timeout_ms=30000) != b"R":
            raise IOError("ring protocol: expected READY")
        item = FifoItem.unpack(self._peer_fifo)
        self._next.write(
            send_arr, item.slice(0, send_arr.nbytes).pack()
        )
        self._next.send(b"D")
        if self._prev.recv(timeout_ms=30000) != b"D":
            raise IOError("ring protocol: expected DONE")

    def all_reduce(self, x: np.ndarray) -> np.ndarray:
        """Ring allreduce of a host array across the process group (sum).

        Chunked ring: reduce-scatter then all-gather, n-1 hops each, every
        hop a one-sided chunked write through the channel. Runs over the
        ACTIVE ranks (post-heal survivors included).
        """
        n = self.active_world
        if n == 1:
            return x.copy()
        flat = np.ascontiguousarray(x).reshape(-1).astype(x.dtype)
        pad = (-flat.size) % n
        if pad:
            flat = np.concatenate([flat, np.zeros(pad, x.dtype)])
        buf = flat.reshape(n, -1).copy()
        recv = self._setup_ring_buf(buf[0].nbytes, buf.dtype)
        r = self.pos
        # reduce-scatter: chunk j accumulates around the ring, lands at member j
        for s in range(n - 1):
            send_slot = (r - s - 1) % n
            recv_slot = (r - s - 2) % n
            self._ring_hop(buf[send_slot])
            buf[recv_slot] += recv
        # all-gather: circulate owned slots
        for s in range(n - 1):
            send_slot = (r - s) % n
            recv_slot = (r - s - 1) % n
            self._ring_hop(buf[send_slot])
            buf[recv_slot] = recv
        out = buf.reshape(-1)
        if pad:
            out = out[:-pad]
        return out.reshape(x.shape)

    def all_gather(self, x: np.ndarray) -> np.ndarray:
        """Gather equal-shaped host arrays from every active rank:
        out[i] = the array of the i-th ACTIVE rank (== rank i before any
        heal)."""
        n = self.active_world
        out = np.empty((n,) + x.shape, x.dtype)
        out[self.pos] = x
        if n == 1:
            return out
        recv = self._setup_ring_buf(x.nbytes, x.dtype).reshape(x.shape)
        cur = np.ascontiguousarray(x)
        for s in range(n - 1):
            self._ring_hop(cur)
            src = (self.pos - s - 1) % n
            out[src] = recv
            cur = recv.copy()  # a real copy: recv is reused as the landing
            # buffer next hop while cur is simultaneously being sent
        return out

    # ------------------------------------------------------------------
    # Pairwise-mesh machinery (channels built per edge, on demand)

    def _ensure_peers(self, peers):
        """Direct channels to the given peers (SPMD: both ends of every edge
        must request it in the same collective call).

        Dialing rule: the lower rank dials, the higher rank waits for the
        acceptor to file the inbound channel — deterministic and
        deadlock-free since accepting happens on a background thread.
        """
        for j in sorted(peers):
            if j == self.rank or j in self._mesh:
                continue
            if self.rank < j:
                a = self._addrs[j]
                self._mesh[j] = Channel.connect(
                    self.ep, a["ip"], a["port"], self.n_paths,
                    meta=b"mesh:%s:%d" % (self._member_tag(), self.rank),
                )
            else:
                self._mesh[j] = self._wait_inbound(
                    b"mesh:%s:%d" % (self._member_tag(), j)
                )

    def _setup_mesh_buf(self, seg: int, peers):
        """Per-source landing regions: one buffer of world segments; peer j
        may only write region j (its own advertised window — the engine
        enforces the byte range). Regrows in lockstep (SPMD payload sizes).

        Descriptor exchange: a regrow re-exchanges over EVERY existing mesh
        channel (both ends of each channel are in the same collective, so
        sends and receives pair up); otherwise only new peers exchange.
        State commits after the exchange completes — a mid-exchange failure
        poisons the group (control channels may hold half-consumed MF
        messages; no later op can be trusted)."""
        if self._broken:
            raise IOError("DcnGroup poisoned by an earlier failed exchange")
        peers = set(peers) - {self.rank}
        self._ensure_peers(peers)
        seg_needed = max(seg, 1)
        regrow = self._mesh_buf is None or seg_needed > self._mesh_seg
        if regrow:
            exchange = dict(self._mesh)  # every existing channel
        else:
            exchange = {j: self._mesh[j] for j in peers if j not in self._mesh_fifos}
        if not exchange:
            return
        try:
            if regrow:
                new_buf = np.empty(self.world * seg_needed, np.uint8)
                new_mr = self.ep.reg(new_buf)
            else:
                new_buf, new_mr, seg_needed = (
                    self._mesh_buf, self._mesh_mr, self._mesh_seg
                )
            for j, ch in exchange.items():
                fifo = self.ep.advertise(
                    new_mr, offset=j * seg_needed, length=seg_needed
                )
                ch.send(b"MF" + fifo)
            fifos = {}
            for j, ch in exchange.items():
                # _ctrl_recv, not raw recv: up to two deferred all_to_all
                # consume-acks can sit queued on a mesh channel (consumed
                # lazily at call i+2), and a regrow right after an
                # all_to_all must skip them, not poison the group
                msg = self._ctrl_recv(ch, j)
                if not msg.startswith(b"MF"):
                    raise IOError(f"mesh fifo exchange broken: {msg[:8]!r}")
                fifos[j] = FifoItem.unpack(msg[2:])
        except Exception:
            self._broken = True
            raise
        if regrow:
            if self._mesh_mr is not None:
                self.ep.dereg(self._mesh_mr)
            self._mesh_buf, self._mesh_mr = new_buf, new_mr
            self._mesh_seg = seg_needed
            self._mesh_fifos = fifos
            # New buffer generation: outstanding all_to_all consume-licenses
            # refer to the old regions — bump the epoch (stale messages get
            # discarded on receipt) and restart the parity counters, which
            # is collectively consistent because regrow itself is (SPMD
            # payload sizes).
            self._a2a_epoch += 1
            self._a2a_w.clear()
            self._a2a_r.clear()
            self._a2a_lic.clear()
        else:
            self._mesh_fifos.update(fifos)

    def _mesh_region(self, src: int, nbytes: int) -> np.ndarray:
        off = src * self._mesh_seg
        return self._mesh_buf[off : off + nbytes]

    def _ctrl_recv(self, ch, peer: int, timeout_ms: int = 30000) -> bytes:
        """recv for the broadcast R/D handshake that tolerates lagging
        all_to_all consume-licenses on the shared mesh channel (an AC for
        my call i is only consumed at my call i+2, so up to two can sit
        queued when another verb takes the channel)."""
        import struct

        while True:
            m = ch.recv(timeout_ms=timeout_ms)
            if len(m) == 10 and m[:2] == b"AC":
                ep_, i_ = struct.unpack("<II", m[2:])
                if ep_ == self._a2a_epoch and i_ > self._a2a_lic.get(peer, -1):
                    self._a2a_lic[peer] = i_
                continue
            return m

    # -- all_to_all pipelined-license protocol -------------------------
    #
    # The old protocol paid TWO serialized round trips per step (send R,
    # wait R before any byte moves; then D both ways). With parity
    # double-buffered landing regions the license becomes deferred: call i
    # writes parity i%2 and only needs the peer's consume-ack of call i-2 —
    # which, at steady state, arrived during an earlier wait. One blocking
    # round trip (the data-arrival AD) per step remains; measured on the
    # loopback cross-pod bench this roughly halves control latency. The
    # reference gets the same effect from pre-posted receive FIFOs
    # (UcclFlow::post_fifo advertisement, collective/rdma/transport.h:1457
    # — receivers advertise ahead so senders never wait to start).
    #
    # Wire messages (tagged so broadcast's R/D and stale generations can
    # never be confused): b"AD"/b"AC" + <epoch u32, call-index u32>.

    @staticmethod
    def _a2a_msg(kind: bytes, epoch: int, idx: int) -> bytes:
        import struct

        return kind + struct.pack("<II", epoch, idx)

    def _a2a_wait(self, ch, peer: int, kind: str, idx: int,
                  timeout_ms: int = 30000) -> None:
        """Consume tagged messages from ``peer`` until the wanted one:
        kind "C" waits for a consume-license with index >= idx (stashing the
        high-water mark); kind "D" waits for the data-arrival of exactly
        call idx. Messages from older epochs (pre-regrow) are discarded."""
        import struct

        while True:
            if kind == "C" and self._a2a_lic.get(peer, -1) >= idx:
                return
            m = ch.recv(timeout_ms=timeout_ms)
            if len(m) == 10 and m[:2] in (b"AD", b"AC"):
                ep_, i_ = struct.unpack("<II", m[2:])
                if ep_ != self._a2a_epoch:
                    continue  # stale generation (buffer since regrown)
                if m[:2] == b"AC":
                    if i_ > self._a2a_lic.get(peer, -1):
                        self._a2a_lic[peer] = i_
                    continue
                if kind == "D" and i_ == idx:
                    return
                raise IOError(
                    f"all_to_all: data frame {i_} while awaiting "
                    f"{kind}:{idx} from rank {peer}"
                )
            raise IOError(f"all_to_all: unexpected control message {m[:8]!r}")

    def all_to_all(self, x: np.ndarray, schedule=None,
                   path_floor: Optional[float] = None) -> np.ndarray:
        """x: [world, ...] — row j goes to rank j; out[i] = rank i's row for us.

        This is the cross-pod EP exchange primitive (the DCN leg of a
        pod-spanning dispatch/combine — reference EP proxies post direct
        per-peer writes the same way, ep/src/rdma.cpp:1554,1718). Pairwise
        stepped schedule over the full mesh: at step s, write your row for
        rank (r+s) directly into its landing region while rank (r-s) writes
        yours — each rank moves (world-1) rows total. Writes are licensed by
        the deferred parity protocol above, so the only blocking wait per
        step is the peer's data arrival.

        ``schedule`` — an optional ``(rounds, K)`` pair from
        :func:`uccl_tpu_torch.ep.a2a_sched.wire_schedule` — replaces the fixed
        hop order with the contention-aware round order: each round's
        K-designated edges form a partial matching (no pod's NIC carries
        two transfers at once) and heavy inter-pod flows go first. Only
        K-designated edges cross the DCN — the device wire's shadow
        padding never ships here (host predication has no rendezvous to
        deadlock). Every write still rides the multipath Channel (SACK +
        PathQuality steering). Same bytes, same result, any order; all
        pods must pass the SAME schedule (it is SPMD state).

        ``path_floor`` (scheduled path only) — consult each
        mesh channel's cross-transfer
        :meth:`~uccl_tpu_torch.p2p.channel.Channel.link_score`: edges whose
        link EWMA has sunk below the floor are **demoted** to the tail of
        this invocation instead of stalling the healthy rounds behind a
        sick link. The execution order becomes all sends (healthy rounds
        first, degraded last — a send never blocks on peer progress
        within an invocation: the deferred license it waits for was
        shipped two invocations ago and the write itself is one-sided),
        then all recvs (same split — each blocks only on its own peer's
        data frame, on an independent channel, tagged with its exact call
        index). That makes the reordering a purely LOCAL decision: ranks
        may disagree about which edges are degraded (link scores are
        per-endpoint observations, not SPMD state) and the exchange still
        cannot deadlock — only the waits' order changes, never the
        landing regions or call indices. Demotions land on
        ``dcn_a2a_demotions_total{dir}``.
        """
        n = self.active_world
        if x.shape[0] != n:
            raise ValueError(f"all_to_all needs leading dim {n}, got {x.shape}")
        x = np.ascontiguousarray(x)
        out = np.empty_like(x)
        me = self.pos
        out[me] = x[me]
        if n == 1:
            return out
        row = x[0]
        self._setup_mesh_buf(2 * row.nbytes, self._active)  # parity pair
        epoch = self._a2a_epoch

        def _send_row(dst_pos: int) -> None:
            dst = self._active[dst_pos]
            ch_dst = self._mesh[dst]
            wi = self._a2a_w.get(dst, 0)
            if wi >= 2:  # license: dst consumed call wi-2 from this parity
                self._a2a_wait(ch_dst, dst, "C", wi - 2)
            item = self._mesh_fifos[dst]
            ch_dst.write(
                x[dst_pos],
                item.slice((wi % 2) * row.nbytes, row.nbytes).pack(),
            )
            ch_dst.send(self._a2a_msg(b"AD", epoch, wi))
            self._a2a_w[dst] = wi + 1

        def _recv_row(src_pos: int) -> None:
            src = self._active[src_pos]
            ch_src = self._mesh[src]
            ri = self._a2a_r.get(src, 0)
            self._a2a_wait(ch_src, src, "D", ri)
            off = src * self._mesh_seg + (ri % 2) * row.nbytes
            out[src_pos] = (
                self._mesh_buf[off: off + row.nbytes]
                .view(x.dtype)
                .reshape(row.shape)
            )
            ch_src.send(self._a2a_msg(b"AC", epoch, ri))
            self._a2a_r[src] = ri + 1

        if schedule is None:
            for s in range(1, n):
                _send_row((me + s) % n)
                _recv_row((me - s) % n)
            return out

        rounds, k_mat = schedule
        perms = [tuple(getattr(rnd, "perm", rnd)) for rnd in rounds]
        k_mat = np.asarray(k_mat)
        # completeness BEFORE any wire traffic: K must designate every
        # off-diagonal pair to a round that actually carries it, or some
        # row would never arrive
        if k_mat.shape != (n, n):
            raise ValueError(f"schedule K is {k_mat.shape}, want {(n, n)}")
        for s in range(n):
            for d in range(n):
                if s == d:
                    continue
                r = int(k_mat[s, d])
                if not (0 <= r < len(perms)) or perms[r][s] != d:
                    raise ValueError(
                        f"schedule round {r} does not carry pair ({s}, {d})"
                    )
        sends: List[int] = []  # designated peer positions, round order
        recvs: List[int] = []
        for r, perm in enumerate(perms):
            if sorted(perm) != list(range(n)):
                raise ValueError(
                    f"schedule round {perm} is not a permutation of "
                    f"range({n})"
                )
            dst_pos = perm[me]
            src_pos = perm.index(me)
            if dst_pos != me and int(k_mat[me, dst_pos]) == r:
                sends.append(dst_pos)
            if src_pos != me and int(k_mat[src_pos, me]) == r:
                recvs.append(src_pos)
        if path_floor is None:
            # round-interleaved (the contention-aware order the schedule
            # encodes): K designates each of my edges to exactly one
            # round, so zipping the two lists back is the original loop
            si = ri = 0
            for r, perm in enumerate(perms):
                if si < len(sends) and int(k_mat[me, sends[si]]) == r:
                    _send_row(sends[si])
                    si += 1
                if ri < len(recvs) and int(k_mat[recvs[ri], me]) == r:
                    _recv_row(recvs[ri])
                    ri += 1
            return out

        def _degraded(pos: int) -> bool:
            score = self._mesh[self._active[pos]].link_score()
            return score is not None and score < path_floor

        demoted_s = [p for p in sends if _degraded(p)]
        demoted_r = [p for p in recvs if _degraded(p)]
        if demoted_s or demoted_r:
            from uccl_tpu_torch.obs import counters as _obsc

            c = _obsc.counter(
                "dcn_a2a_demotions_total",
                "scheduled-a2a edges pushed to the invocation tail "
                "because their link-quality EWMA sank below path_floor",
            )
            if demoted_s:
                c.inc(len(demoted_s), dir="send")
            if demoted_r:
                c.inc(len(demoted_r), dir="recv")
        for p in [q for q in sends if q not in demoted_s] + demoted_s:
            _send_row(p)
        for p in [q for q in recvs if q not in demoted_r] + demoted_r:
            _recv_row(p)
        return out

    def broadcast(self, x: np.ndarray, root: int = 0) -> np.ndarray:
        """Rooted broadcast: every rank returns root's x. Binomial tree —
        ceil(log2 world) rounds; each rank walks only its own edges of the
        SHARED tree schedule (``utils.topology.bcast_tree_rounds`` — the
        same arithmetic the on-mesh ``plan.tree_broadcast`` lowers and the
        planner's tree cost features charge, so the host and device trees
        cannot drift) and sends at most log(world) copies. The decision
        lands on ``collective_plan_total{verb="broadcast", algo="tree"}``
        beside the on-mesh verbs (compat/dist.broadcast shims here)."""
        from uccl_tpu_torch.obs import counters as _obsc
        from uccl_tpu_torch.utils.topology import bcast_tree_rounds

        n = self.active_world
        if n == 1:
            return x.copy()
        if root not in self._active:
            raise ValueError(f"broadcast root {root} is not an active rank")
        root_pos = self._active.index(root)
        me = self.pos
        rounds = bcast_tree_rounds(n, root_pos)  # position-space pairs
        # Only this rank's tree edges — log(world) channels, not a full mesh.
        partners = set()
        for pairs in rounds:
            for s, d in pairs:
                if s == me:
                    partners.add(self._active[d])
                elif d == me:
                    partners.add(self._active[s])
        _obsc.counter("collective_plan_total").inc(
            algo="tree", chunks=1, wire_dtype="none", outcome="explicit",
            verb="broadcast",
        )
        self._setup_mesh_buf(x.nbytes, partners)
        buf = (np.ascontiguousarray(x).copy() if me == root_pos
               else np.empty_like(x))
        for pairs in rounds:
            for s, d in pairs:
                if s == me:  # this round's holder: fan out
                    dst = self._active[d]
                    ch = self._mesh[dst]
                    if self._ctrl_recv(ch, dst) != b"R":
                        raise IOError("broadcast: expected READY")
                    item = self._mesh_fifos[dst]
                    ch.write(buf, item.slice(0, buf.nbytes).pack())
                    ch.send(b"D")
                    if self._addrs[dst].get("bcast_ack"):
                        # the landing region is also the first two
                        # all_to_all writes' target (offset 0 of MY
                        # region on the peer, no license before call 2):
                        # return only once the peer has copied it out
                        if self._ctrl_recv(ch, dst) != b"BA":
                            raise IOError("broadcast: expected ACK")
                elif d == me:  # this round's receiver
                    src = self._active[s]
                    ch = self._mesh[src]
                    ch.send(b"R")
                    if self._ctrl_recv(ch, src) != b"D":
                        raise IOError("broadcast: expected DONE")
                    flat = self._mesh_region(src, buf.nbytes).view(buf.dtype)
                    buf = flat.reshape(x.shape).copy()
                    if self._addrs[src].get("bcast_ack"):
                        ch.send(b"BA")
        return buf

    def barrier(self):
        self.all_reduce(np.zeros(1, np.float32))


def hierarchical_all_reduce(comm, dcn: DcnGroup, x):
    """Two-level allreduce: member reduce-scatter → DCN allreduce →
    member all-gather.

    ``comm`` is a :class:`~uccl_tpu_torch.collective.Communicator` (rank-dim
    convention, x: [local_world, N] on the members' device); ``dcn`` spans
    pods. Each member's N/local_world shard crosses the host link (one
    device-to-host copy of the reduce-scatter's output, one host-to-device
    copy of the DCN sum) and the pod-internal legs stay on the card. Result:
    [local_world, N] on the members' device, every member holding the
    global sum, NCCL-allreduce shaped.
    """
    import torch

    from uccl_tpu_torch.collective import plan as _plan

    local = comm.world
    n = x.shape[1]
    # the cross-pod decision rides the same plan surface as the member
    # algos: ring legs at (alpha, beta) + the DCN ring middle at the dcn
    # beta — "hier" lands beside "bidir"/"hd" on collective_plan_total
    model = _plan.get_planner().model
    itemsize = (x.element_size() if isinstance(x, torch.Tensor)
                else np.dtype(x.dtype).itemsize)
    pred = model.predict("hier", local, n * itemsize,
                         dcn_world=max(dcn.active_world, 1))
    _plan.PLAN_TOTAL.inc(algo="hier", chunks=1, wire_dtype="none",
                         outcome="explicit")
    _plan.PLAN_PREDICTED.set(pred, algo="hier", chunks=1, wire_dtype="none")
    shard = comm.reduce_scatter(x)  # [local_world, N/local]: row i = chunk i
    # host staging (a pinned buffer for a CUDA shard) + DCN exchange
    reduced = dcn.all_reduce(host_copy(shard).numpy())
    shard_dev = comm.device_put(reduced)
    # the AG leg stays the plain lowering: the cross-pod schedule was
    # already planned as ONE "hier" decision above — re-planning its inner
    # leg would double-emit and could swap a kernel into a path priced as
    # the plain one
    gathered = comm.all_gather(shard_dev, algo="xla")  # replicated
    return gathered.reshape(1, -1).expand(local, n).contiguous()
