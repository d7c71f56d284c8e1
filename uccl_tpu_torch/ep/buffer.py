"""DeepEP-shaped host API for expert-parallel dispatch and combine.

Port of ``uccl_tpu/ep/buffer.py``: the reference's ``Buffer`` surface
(``get_dispatch_layout``, ``dispatch``, ``combine``,
``low_latency_dispatch``, ``low_latency_combine``) over a W-member EP world.
Arrays carry a leading EP-rank dim, one row per member, as in the JAX
package; here that is the port's member-stacked layout, all members on the
mesh's device, and each verb runs the member-stacked primitives of
:mod:`uccl_tpu_torch.ep.ops` and :mod:`uccl_tpu_torch.ep.ll` eagerly (the
JAX Buffer's jit/shard_map cache has no counterpart).

Every resolution rule is the JAX Buffer's: wire (call > Config > Buffer),
chunk depth, wire dtype, the round schedule (``a2a_sched`` off | on | auto,
memoized per static config) and capacity. ``wire="pallas"`` runs the
member-major exchanges on the hand-written kernels (B9, B10 per scheduled
round); anything else the stock wire. Each verb counts its payload's wire
bytes on ``ep_bytes_total`` and opens an ``ep.<verb>`` span on the
tracer's ``wire`` track.

:class:`EventOverlap` is DeepEP's: a ``torch.cuda.Event`` recorded after a
verb's launches; ``current_stream_wait()`` makes the current stream wait on
it, and a verb given it as ``previous_event`` waits on it before its first
launch. On the CPU it only holds the verb's tensors.

A verb reads its kernels' error words once, after its last launch
(``collective/lanes.one_check``), and raises on a spin-wait timeout. With
``async_finish`` it does not wait for that read: its :class:`EventOverlap`
carries it, and ``synchronize()`` (the receive hook) or the next verb that
waits raises.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from uccl_tpu_torch.collective import lanes as _lanes
from uccl_tpu_torch.ep import ll as ep_ll
from uccl_tpu_torch.ep import ops as ep_ops
from uccl_tpu_torch.obs import counters as _obsc
from uccl_tpu_torch.obs import tracer as _obst
from uccl_tpu_torch.ops import quant as _quant
from uccl_tpu_torch.parallel.mesh import AXIS, Mesh, get_mesh, mesh_axis_size

# Wire bytes of the payload handed to each EP verb (the member-stacked [W,
# ...] tensor, what the exchange moves end to end): quantized payload + f32
# scales under a wire_dtype, raw element bytes otherwise; by verb, wire and
# wire_dtype. The family ring_ccl registers under the same name.
EP_BYTES = _obsc.counter(
    "ep_bytes_total",
    "actual wire bytes moved by EP verbs and ring collectives (quantized "
    "payload + f32 scale sidecar when a wire_dtype applies, raw element "
    "bytes otherwise), by verb, wire, and wire_dtype",
)


def _observed_call(verb: str, fn, *, wire: str, n_chunks: int, payload: torch.Tensor,
                   wire_dtype=None, async_finish: bool = False):
    """Run one verb under the bytes counter and its host span on the wire
    track, its launches' error words read once at its end: (result, the
    read still pending under ``async_finish``, else None)."""
    nbytes = ep_ops.wire_bytes_of(payload.shape, payload.dtype, wire_dtype)
    EP_BYTES.inc(nbytes, verb=verb, wire=wire, wire_dtype=wire_dtype or "none")
    with _obst.span(f"ep.{verb}", track="wire", wire=wire, n_chunks=n_chunks, bytes=nbytes,
                    wire_dtype=wire_dtype or "none"):
        with _lanes.one_check(blocking=not async_finish) as scope:
            out = fn()
    return out, scope.pending


class EventOverlap:
    """The overlap half of the DeepEP contract. On a CUDA tensor, a CUDA
    event recorded on the current stream after the verb's launches:
    ``current_stream_wait()`` makes the current stream wait on it (no host
    sync), and a verb given it as ``previous_event`` waits on it before its
    first launch. ``pending`` is the verb's error-word read
    (``lanes.Pending``): ``synchronize()`` resolves it, and so does
    ``current_stream_wait()`` once the verb has run. On the CPU, where
    everything runs in order, it only holds the verb's tensors."""

    def __init__(self, tensors, pending: Optional[_lanes.Pending] = None):
        self.tensors, self.pending = tensors, pending
        first = tensors[0] if isinstance(tensors, (tuple, list)) else tensors
        self.event = None
        if first.device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(first.device))

    def current_stream_wait(self) -> None:
        if self.event is not None:
            torch.cuda.current_stream().wait_event(self.event)
        if self.pending is not None and self.pending.ready():
            self.pending.resolve()

    wait = current_stream_wait

    def synchronize(self) -> None:
        """Block the host until the verb's launches have run; raise if one
        timed out."""
        if self.event is not None:
            self.event.synchronize()
        if self.pending is not None:
            self.pending.resolve()


def _wait_previous(previous_event: Optional[EventOverlap]) -> None:
    if previous_event is not None:
        previous_event.current_stream_wait()


def _check_overlap(previous_event, async_finish: bool, allocate_on_comm_stream: bool) -> None:
    if allocate_on_comm_stream and not (previous_event is not None and async_finish):
        raise ValueError("allocate_on_comm_stream requires previous_event and async_finish "
                         "(reference precondition, buffer.py:826)")


@dataclasses.dataclass(frozen=True)
class Config:
    """Tuning hints, the mapping of the reference ``Config``. A Config only
    fills knobs the caller left unset; an explicit keyword always wins.
    ``wire``: ``ragged``/``dense`` (the LL layouts on the stock wire),
    ``pallas`` (the kernels, both the normal and LL verbs) or ``auto``;
    ``n_chunks``: the pallas wire's chunk depth (0 = auto); ``wire_dtype``:
    the quantized payload ("fp8" | "int8"); ``a2a_sched``: off | on | auto."""

    max_tokens_per_rank: Optional[int] = None  # LL recv-buffer sizing
    pair_capacity_factor: Optional[float] = None  # dense-wire pair capacity
    wire: str = "auto"  # ragged | dense | pallas | auto
    wire_fp8: bool = True
    n_chunks: Optional[int] = None  # pallas chunk-pipeline depth (0 = auto)
    wire_dtype: Optional[str] = None  # fp8 | int8 | None (full precision)
    a2a_sched: Optional[str] = None  # off | on | auto (None = Buffer's)


class DispatchHandle(NamedTuple):
    """Threaded from dispatch to combine: the sorted-form routing (O(T·K)
    per member) and what carried dispatch, so combine retraces it.
    ``recv_counts[w, s, le]`` is how many of source s's rows landed for
    member w's local expert le (the occupancy of ``recv_x[w, le, s*C:
    (s+1)*C]``)."""

    slot: torch.Tensor  # [W, T, K] int32 slot per assignment (E*C = dropped)
    weights: torch.Tensor  # [W, T, K] f32 gate weights
    recv_counts: torch.Tensor  # [W, W_src, E_local] int32
    wire: str = "lax"  # lax | pallas
    n_chunks: int = 1
    wire_dtype: Optional[str] = None  # dispatch's quantized payload
    a2a_sched: bool = False  # dispatch rode scheduled rounds; combine rebuilds the
    #   transposed schedule


class LowLatencyHandle(NamedTuple):
    """Handle of the packed low-latency path: the member-stacked
    :class:`uccl_tpu_torch.ep.ll.LLState` and the wire choice."""

    send_slot: torch.Tensor  # [W, T, K]
    weights: torch.Tensor  # [W, T, K]
    send_mat: torch.Tensor  # [W, W, E_local]
    recv_mat: torch.Tensor  # [W, W, E_local]
    regroup: torch.Tensor  # [W, R_max]
    src_in_offsets: torch.Tensor  # [W, W]
    wire: str
    wire_fp8: bool
    n_chunks: int = 1
    wire_dtype: Optional[str] = None  # resolved quantized payload (None: wire_fp8 decides)


class Buffer:
    """Expert-parallel buffer bound to a mesh's EP axes.

    ``wire`` selects the transport every verb rides unless a call overrides
    it: ``"auto"`` (the stock wire; the LL verbs' ragged wire on the card),
    or ``"pallas"`` (the member-major exchanges of both the normal and
    low-latency formats on the hand-written kernels). ``n_chunks`` is the
    pallas wire's chunk depth (0 = auto, 1 = phased), ``wire_dtype``
    quantizes every verb's payload ("fp8" | "int8"), and ``a2a_sched``
    orders the pallas wire's exchange as contention-free permutation rounds
    built from ``a2a_traffic`` (a host [W, W] routing matrix): "on" pins
    the schedule, "auto" lets the planner choose it off the traffic's skew,
    "off" keeps the fixed streams. The same bits in every case."""

    def __init__(self, mesh: Optional[Mesh] = None, axis=AXIS.EP, *, num_experts: int,
                 num_selected: int = 2, capacity_factor: float = 1.25, wire: str = "auto",
                 n_chunks: int = 1, wire_dtype: Optional[str] = None, a2a_sched: str = "off",
                 a2a_traffic=None):
        self.mesh = mesh if mesh is not None else get_mesh()
        self.axes = (axis,) if isinstance(axis, str) else tuple(axis)
        for a in self.axes:
            if a not in self.mesh.shape:
                raise ValueError(f"mesh has no axis {a!r} (axes {tuple(self.mesh.shape)})")
        self.world = mesh_axis_size(self.mesh, self.axes)
        self.device = self.mesh.device
        if num_experts % self.world:
            raise ValueError(f"num_experts {num_experts} must divide EP world {self.world}")
        if wire not in ("auto", "ragged", "dense", "pallas"):
            raise ValueError(f"unknown wire {wire!r} (want 'auto', 'ragged', 'dense', or "
                             "'pallas')")
        if n_chunks < 0:
            raise ValueError(f"n_chunks must be >= 0 (0 = auto), got {n_chunks}")
        if a2a_sched not in ("off", "on", "auto"):
            raise ValueError(f"unknown a2a_sched {a2a_sched!r} (want 'off', 'on', or 'auto')")
        self.num_experts = num_experts
        self.num_local_experts = num_experts // self.world
        self.num_selected = num_selected
        self.capacity_factor = capacity_factor
        self.wire = wire
        self.n_chunks = n_chunks
        self.wire_dtype = _quant.resolve_wire_dtype(wire_dtype)
        self.a2a_sched = a2a_sched
        self.a2a_traffic = None if a2a_traffic is None else np.asarray(a2a_traffic, float)
        # host resolutions memoize per static config, so a decision's
        # counters fire once, not once per call of a serving loop
        self._resolve_memo = {}
        self._op_counts = {"dispatch": 0, "combine": 0, "low_latency_dispatch": 0,
                           "low_latency_combine": 0, "get_dispatch_layout": 0}
        self._last_dispatch = None  # (topk_idx, capacity)
        self._last_ll = None  # (group_sizes, r_max, hidden, quantized)
        from uccl_tpu_torch.obs import flight as _obsf

        _obsf.register_provider("ep_buffer", self._flight_state)

    def _flight_state(self) -> dict:
        """Host-resident state only: a post-mortem dump must not sync."""
        return {"world": self.world, "num_experts": self.num_experts, "wire": self.wire,
                "wire_dtype": str(self.wire_dtype), "a2a_sched": self.a2a_sched,
                "ops": dict(self._op_counts)}

    # ------------------------------------------------------------------
    def _to(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    def _resolve_wire(self, requested, config) -> str:
        """Effective wire of a verb: the call's value, else the Config's,
        else the Buffer's."""
        wire = requested if requested is not None else "auto"
        if wire == "auto" and config is not None:
            wire = config.wire
        if wire == "auto":
            wire = self.wire
        return wire

    def _resolve_chunks(self, requested, config, wire: str) -> int:
        """Effective chunk depth of a verb: the call's value, else the
        Config's, else the Buffer's; 1 off the pallas wire or at world 1 (an
        explicit depth > 1 on the pallas wire at world 1 counted once); 0
        stays 0 (auto) for the layer's resolver."""
        n = requested
        if n is None and config is not None:
            n = config.n_chunks
        if n is None:
            n = self.n_chunks
        n = int(n)
        if n < 0:
            raise ValueError(f"n_chunks must be >= 0 (0 = auto), got {n}")
        if wire != "pallas" or self.world <= 1:
            if n > 1 and wire == "pallas" and self.world <= 1 \
                    and "chunks_world" not in self._resolve_memo:
                self._resolve_memo["chunks_world"] = True
                from uccl_tpu_torch.collective import dma

                dma.record_fallback("buffer_verb", "world_size", detail=self.world)
            return 1
        return n

    def _resolve_wire_dtype(self, wire_dtype, wire_fp8, config, default_fp8: bool = False):
        """Effective quantized payload of a verb: the explicit ``wire_dtype``,
        else the explicit ``wire_fp8`` bool, else the Config's (wire_dtype,
        then wire_fp8), else the Buffer's, else ``default_fp8`` (the LL
        verbs' fp8-on default)."""
        if wire_dtype is not None:
            return _quant.resolve_wire_dtype(wire_dtype)
        if wire_fp8 is not None:
            return "fp8" if wire_fp8 else None
        if config is not None:
            if config.wire_dtype is not None:
                return _quant.resolve_wire_dtype(config.wire_dtype)
            if config.wire_fp8 is not None:
                return "fp8" if config.wire_fp8 else None
        if self.wire_dtype is not None:
            return self.wire_dtype
        return "fp8" if default_fp8 else None

    def _sched_chunk_charge(self, n_chunks: int, cap: int, slot_elems: int):
        """Per-chunk per-peer elements of the chunked scheduled wire
        (``pallas_a2a._scheduled_chunked``'s own arithmetic), or None when
        the depth degenerates to 1."""
        from uccl_tpu_torch.collective import dma as _dma

        nc = min(int(n_chunks), int(cap))
        if nc <= 1:
            return None
        return int(slot_elems) * (_dma.pad_capacity(int(cap), nc) // nc)

    def _resolve_a2a_sched(self, config, wire: str, verb: str, payload_shape, dtype,
                           wire_dtype, n_chunks: int = 1):
        """Effective round schedule of a verb's exchange, or None for the
        fixed streams: Config > Buffer mode; on the pallas wire at world > 1
        the schedule is built from the Buffer's traffic matrix (combine sees
        it transposed) and pinned ("on", an explicit plan) or arbitrated by
        the planner off the skew ("auto", ``plan_ep_a2a``). Memoized per
        static config, so the decision and its counters fire once."""
        mode = None
        if config is not None and config.a2a_sched is not None:
            mode = config.a2a_sched
        if mode is None:
            mode = self.a2a_sched
        if mode not in ("off", "on", "auto"):
            raise ValueError(f"unknown a2a_sched {mode!r} (want 'off', 'on', or 'auto')")
        if mode == "off" or self.world <= 1:
            return None
        if wire != "pallas":
            if mode == "on" and "a2a_sched_wire" not in self._resolve_memo:
                self._resolve_memo["a2a_sched_wire"] = True
                from uccl_tpu_torch.collective import dma

                dma.record_fallback(
                    "ep_a2a_sched", "wire", detail=wire,
                    msg="a2a_sched='on' needs the pallas wire (the stock wire has no round "
                        "order to steer); riding the fixed streams")
            return None
        mat = self.a2a_traffic
        if mat is None:
            mat = np.ones((self.world, self.world), float)
            np.fill_diagonal(mat, 0.0)
        mat = np.asarray(mat, float)
        if verb == "combine":
            mat = mat.T
        key = ("a2a_sched", mode, verb, tuple(payload_shape), str(dtype), wire_dtype, n_chunks,
               mat.tobytes())
        if key in self._resolve_memo:
            return self._resolve_memo[key]
        from uccl_tpu_torch.collective.plan import get_planner
        from uccl_tpu_torch.ep import a2a_sched as _sched

        schedule = _sched.wire_schedule(mat, self.world)
        n_rounds = len(schedule[0])
        planner = get_planner()
        if mode == "on":
            planner.plan_explicit("ep_sched", payload_shape, dtype, self.world,
                                  wire_dtype=wire_dtype, verb="ep_a2a")
            algo = "ep_sched"
        else:
            # the wire buffer is [W, E_local, C, H] for both verbs; its
            # chunked slot axis is C. dispatch's payload_shape is that
            # buffer, combine's the [E_local, W*C, H] expert view
            elems = int(np.prod(payload_shape))
            cap = int(payload_shape[-2])
            if verb != "dispatch":
                cap //= self.world
            slot_elems = elems // self.world // max(cap, 1)
            cep = (self._sched_chunk_charge(n_chunks, cap, slot_elems)
                   if n_chunks > 1 and cap else None)
            algo = planner.plan_ep_a2a(
                payload_shape, dtype, self.world, skew=_sched.skew(mat), n_rounds=n_rounds,
                wire_dtype=wire_dtype, n_chunks=n_chunks if cep is not None else 1,
                chunk_elems_per_peer=cep).algo
        _sched.record_decision(algo, self.world,
                               n_rounds=n_rounds if algo == "ep_sched" else None, matrix=mat)
        result = schedule if algo == "ep_sched" else None
        self._resolve_memo[key] = result
        return result

    def stats(self) -> dict:
        """Per-op stats: op counters, and aggregates of the last dispatch of
        each mode (routed/kept/dropped rows of the capacity path, by the
        sorted layout's drop rule; received rows and payload bytes of the
        low-latency path). Reading syncs with the device."""
        out = {"ops": dict(self._op_counts)}
        if self._last_dispatch is not None:
            idx, cap = self._last_dispatch
            idx_np = idx.cpu().numpy()  # [W, T, K]
            routed = kept = 0
            for r in range(idx_np.shape[0]):
                flat = idx_np[r].reshape(-1)
                flat = flat[flat >= 0]  # -1 = "no expert" claims no slot
                d = np.bincount(flat, minlength=self.num_experts)
                routed += int(d.sum())
                kept += int(np.minimum(d, cap).sum())
            out["dispatch"] = {"capacity": int(cap), "routed_rows": routed, "kept_rows": kept,
                               "dropped_rows": routed - kept,
                               "drop_fraction": float((routed - kept) / max(1, routed))}
        if self._last_ll is not None:
            counts, r_max, hidden, quantized = self._last_ll
            rows = int(counts.sum().item())
            out["low_latency"] = {"recv_rows": rows, "r_max_per_rank": int(r_max),
                                  "wire_payload_bytes": rows * hidden * (1 if quantized else 2)}
        return out

    @staticmethod
    def get_dispatch_config(num_ranks: int) -> Config:
        """Recommended dispatch config per EP world size: small worlds ride
        the ragged wire; larger worlds shrink the dense wire's pair capacity."""
        if num_ranks <= 8:
            return Config(wire="auto", wire_fp8=True)
        if num_ranks <= 32:
            return Config(wire="auto", wire_fp8=True, pair_capacity_factor=1.0)
        return Config(wire="auto", wire_fp8=True, pair_capacity_factor=0.75)

    @staticmethod
    def get_combine_config(num_ranks: int) -> Config:
        """Recommended combine config: the dispatch one at full precision
        (the gate weights would amplify a quantized combine's error)."""
        return dataclasses.replace(Buffer.get_dispatch_config(num_ranks), wire_fp8=False)

    def capacity(self, num_tokens: int) -> int:
        return max(1, int(self.capacity_factor * num_tokens * self.num_selected
                          / self.num_experts))

    # ------------------------------------------------------------------
    def get_dispatch_layout(self, topk_idx: torch.Tensor):
        """topk_idx ``[W, T, K]`` global expert ids (-1 = none) → (tokens per
        rank ``[W, W]``, tokens per expert ``[W, E]``, is_token_in_rank
        ``[W, T, W]``), the counting contract of the reference's
        get_dispatch_layout."""
        topk_idx = self._to(topk_idx)
        e, w = self.num_experts, self.world
        onehot = (topk_idx[..., None] == torch.arange(e, device=topk_idx.device)) \
            .to(torch.int32)  # [W, T, K, E]
        per_expert = onehot.sum((1, 2), dtype=torch.int32)
        in_rank = onehot.sum(2).reshape(w, -1, w, self.num_local_experts).sum(-1) > 0
        per_rank = in_rank.sum(1, dtype=torch.int32)
        self._op_counts["get_dispatch_layout"] += 1
        return per_rank, per_expert, in_rank

    def dispatch(self, x: torch.Tensor, topk_idx: torch.Tensor,
                 topk_weights: Optional[torch.Tensor] = None, *,
                 wire_fp8: Optional[bool] = None, wire_dtype: Optional[str] = None,
                 config: Optional[Config] = None,
                 previous_event: Optional[EventOverlap] = None, async_finish: bool = False,
                 allocate_on_comm_stream: bool = False):
        """x ``[W, T, H]``, topk_idx ``[W, T, K]``, topk_weights ``[W, T, K]``
        (default uniform 1/K) → (recv_x ``[W, E_local, W*C, H]``, handle),
        plus an :class:`EventOverlap` with ``async_finish``. ``wire_dtype``
        quantizes the wire payload (explicit keyword > Config > Buffer)."""
        wire_dtype = self._resolve_wire_dtype(wire_dtype, wire_fp8, config)
        _check_overlap(previous_event, async_finish, allocate_on_comm_stream)
        wire = "pallas" if self._resolve_wire(None, config) == "pallas" else "lax"
        x, topk_idx = self._to(x), self._to(topk_idx)
        w, t, h = x.shape
        k = topk_idx.shape[-1]
        cap = self.capacity(t)
        e = self.num_experts
        n_chunks = self._resolve_chunks(None, config, wire)
        if n_chunks != 1:
            rkey = ("chunks", n_chunks, wire, cap, h, wire_dtype, str(x.dtype))
            if rkey not in self._resolve_memo:
                self._resolve_memo[rkey] = ep_ops.resolve_chunks(
                    n_chunks, wire, self.world, cap, self.num_local_experts, h,
                    ep_ops.wire_itemsize(False, h, x.dtype, wire_dtype=wire_dtype),
                    wire_dtype=wire_dtype, device=x.device)
            n_chunks = self._resolve_memo[rkey]
        schedule = self._resolve_a2a_sched(config, wire, "dispatch",
                                           (self.world, self.num_local_experts, cap, h),
                                           x.dtype, wire_dtype, n_chunks=n_chunks)
        if topk_weights is None:
            topk_weights = torch.full(topk_idx.shape, 1.0 / k, dtype=torch.float32,
                                      device=x.device)

        def run():
            _wait_previous(previous_event)
            plan = ep_ops.plan_slots(topk_idx, e, cap)
            recv = ep_ops.dispatch_sorted(x, plan, e, cap, self.axes, wire_dtype=wire_dtype,
                                          wire=wire, n_chunks=n_chunks, schedule=schedule)
            # per-(source, local expert) received rows: each member's kept
            # counts per global expert, exchanged (always on, as DeepEP's
            # handle always carries its receive bookkeeping)
            rc = ep_ops.counts_exchange(plan.kept.reshape(w, w, self.num_local_experts))
            return recv, plan.slot, rc

        (recv, slot, recv_counts), pending = _observed_call(
            "dispatch", run, wire=wire, n_chunks=n_chunks, payload=x, wire_dtype=wire_dtype,
            async_finish=async_finish)
        self._op_counts["dispatch"] += 1
        self._last_dispatch = (topk_idx, cap)
        handle = DispatchHandle(slot, self._to(topk_weights), recv_counts, wire, n_chunks,
                                wire_dtype, schedule is not None)
        if async_finish:
            return recv, handle, EventOverlap((recv, slot, recv_counts), pending)
        return recv, handle

    def combine(self, expert_out: torch.Tensor, handle: DispatchHandle, *,
                wire_fp8: Optional[bool] = None, wire_dtype: Optional[str] = None,
                config: Optional[Config] = None, previous_event: Optional[EventOverlap] = None,
                async_finish: bool = False, allocate_on_comm_stream: bool = False):
        """expert_out ``[W, E_local, W*C, H]`` → ``[W, T, H]`` (plus an
        :class:`EventOverlap` with ``async_finish``). The return exchange
        rides the wire and chunk depth of the handle's dispatch; its
        ``wire_dtype`` resolves on its own (``get_combine_config`` keeps it
        full precision)."""
        wire_dtype = self._resolve_wire_dtype(wire_dtype, wire_fp8, config)
        _check_overlap(previous_event, async_finish, allocate_on_comm_stream)
        expert_out = self._to(expert_out)
        wire, n_chunks = handle.wire, handle.n_chunks
        schedule = None
        if handle.a2a_sched:
            # the return exchange is the transposed traffic: its own schedule
            schedule = self._resolve_a2a_sched(config, wire, "combine", expert_out.shape[1:],
                                               expert_out.dtype, wire_dtype,
                                               n_chunks=n_chunks)

        def run():
            _wait_previous(previous_event)
            return ep_ops.combine_sorted(expert_out, handle.slot, handle.weights, self.axes,
                                         wire_dtype=wire_dtype, wire=wire, n_chunks=n_chunks,
                                         schedule=schedule)

        self._op_counts["combine"] += 1
        out, pending = _observed_call("combine", run, wire=wire, n_chunks=n_chunks,
                                      payload=expert_out, wire_dtype=wire_dtype,
                                      async_finish=async_finish)
        if async_finish:
            return out, EventOverlap(out, pending)
        return out

    # -- low-latency mode: packed payloads + receive counts -------------
    def low_latency_dispatch(self, x: torch.Tensor, topk_idx: torch.Tensor,
                             num_max_dispatch_tokens_per_rank: Optional[int] = None,
                             topk_weights: Optional[torch.Tensor] = None, *,
                             pair_capacity_factor: Optional[float] = None, wire: str = "auto",
                             wire_fp8: Optional[bool] = None, wire_dtype: Optional[str] = None,
                             n_chunks: Optional[int] = None, config: Optional[Config] = None,
                             previous_event: Optional[EventOverlap] = None,
                             async_finish: bool = False, return_recv_hook: bool = False):
        """DeepEP's low-latency contract: packed per-expert buffers sized by
        ``num_max_dispatch_tokens_per_rank`` and per-expert receive counts,
        fp8 on the wire by default. x ``[W, T, H]``, topk_idx ``[W, T, K]``
        (-1 = no expert: no wire slot, zero in combine) → (recv_x ``[W,
        R_max, H]`` group-major, recv_count ``[W, E_local]``, handle); with
        ``async_finish``/``return_recv_hook`` the reference's 5-tuple
        ``(recv_x, recv_count, handle, event, hook)``, the hook blocking
        until the receive buffers have landed."""
        wire_dtype = self._resolve_wire_dtype(wire_dtype, wire_fp8, config, default_fp8=True)
        if config is not None:
            if num_max_dispatch_tokens_per_rank is None:
                num_max_dispatch_tokens_per_rank = config.max_tokens_per_rank
            if pair_capacity_factor is None:
                pair_capacity_factor = config.pair_capacity_factor
            if wire == "auto":
                wire = config.wire
        x, topk_idx = self._to(x), self._to(topk_idx)
        w, t, h = x.shape
        k = topk_idx.shape[-1]
        wire = self._resolve_wire(wire, None)
        if wire == "auto":
            wire = "ragged" if ep_ll.wire_supports_ragged(x.device) else "dense"
        per_pair, _ = ep_ll.ll_bounds(t, k, self.num_local_experts, self.world,
                                      num_max_dispatch_tokens_per_rank, pair_capacity_factor)
        n_chunks = ep_ll.resolve_ll_chunks(self._resolve_chunks(n_chunks, config, wire), wire,
                                           self.world, per_pair)
        if topk_weights is None:
            topk_weights = torch.full(topk_idx.shape, 1.0 / k, dtype=torch.float32,
                                      device=x.device)
        topk_weights = self._to(topk_weights)

        def run():
            _wait_previous(previous_event)
            return ep_ll.ll_dispatch(
                x, topk_idx, topk_weights, self.num_experts,
                num_max_dispatch_tokens_per_rank=num_max_dispatch_tokens_per_rank,
                pair_capacity_factor=pair_capacity_factor, wire=wire, wire_fp8=False,
                wire_dtype=wire_dtype, n_chunks=n_chunks)

        r, pending = _observed_call("low_latency_dispatch", run, wire=wire, n_chunks=n_chunks,
                                    payload=x, wire_dtype=wire_dtype,
                                    async_finish=async_finish or return_recv_hook)
        s = r.state
        handle = LowLatencyHandle(s.send_slot, s.weights, s.send_mat, s.recv_mat, s.regroup,
                                  s.src_in_offsets, wire, wire_dtype == "fp8", n_chunks,
                                  wire_dtype)
        self._op_counts["low_latency_dispatch"] += 1
        self._last_ll = (r.group_sizes, r.recv_x.shape[1], h, wire_dtype is not None)
        if async_finish or return_recv_hook:
            ev = EventOverlap((r.recv_x, r.group_sizes), pending)
            hook: Optional[Callable[[], None]] = ev.synchronize if return_recv_hook else None
            return r.recv_x, r.group_sizes, handle, ev if async_finish else None, hook
        return r.recv_x, r.group_sizes, handle

    def low_latency_combine(self, expert_out: torch.Tensor, handle: LowLatencyHandle, *,
                            previous_event: Optional[EventOverlap] = None,
                            async_finish: bool = False, return_recv_hook: bool = False):
        """expert_out ``[W, R_max, H]`` group-major → ``[W, T, H]``; with
        ``async_finish``/``return_recv_hook``, the reference's
        ``(combined_x, event, hook)``."""
        wire_dtype = handle.wire_dtype or ("fp8" if handle.wire_fp8 else None)
        expert_out = self._to(expert_out)
        state = ep_ll.LLState(handle.send_slot, handle.weights, handle.send_mat,
                              handle.recv_mat, handle.regroup, handle.src_in_offsets,
                              handle.wire, handle.n_chunks)

        def run():
            _wait_previous(previous_event)
            return ep_ll.ll_combine(expert_out, state, wire_fp8=False, wire_dtype=wire_dtype)

        self._op_counts["low_latency_combine"] += 1
        out, pending = _observed_call("low_latency_combine", run, wire=handle.wire,
                                      n_chunks=handle.n_chunks, payload=expert_out,
                                      wire_dtype=wire_dtype,
                                      async_finish=async_finish or return_recv_hook)
        if async_finish or return_recv_hook:
            ev = EventOverlap(out, pending)
            hook: Optional[Callable[[], None]] = ev.synchronize if return_recv_hook else None
            return out, ev if async_finish else None, hook
        return out
