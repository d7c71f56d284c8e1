"""Chunk-graph collective planner: plan → lower → execute, on member-stacked tensors.

Port of ``uccl_tpu/collective/plan.py``:

* :class:`RingPlan` and the ``plan_*`` builders — the schedules, pure data,
  unchanged.
* The lowerings (:func:`execute`, :func:`ring_all_reduce`,
  :func:`ring_reduce_scatter`, :func:`ring_all_gather`,
  :func:`hd_all_reduce`, :func:`torus_all_reduce` over a
  :class:`ChunkGraph`, :func:`tree_broadcast`). In JAX they run per shard
  inside ``shard_map``, each hop a ``lax.ppermute``. Here they take the
  member-stacked tensor ``[world, ...]`` (row r is member r's buffer) and
  return the same layout; a hop gathers every member's send slot and lands
  it at its ring neighbor, so ``lax.ppermute`` becomes an index along the
  member dimension. Same slot arithmetic, same adds in the input dtype, so
  results are bit-identical to the JAX lowerings. These are plain torch:
  the ``ring``, ``hd`` and ``torus`` algos, and the budget fallbacks of the
  ring kernels (``ring_ccl``).
* The alpha-beta-gamma cost model and :class:`CollectivePlanner`. Its
  constants default to the JAX package's values (fits to a TPU's ICI, not
  to an H100) so that ``algo="auto"`` decides as the JAX package does;
  refitting them on the card is open work (ROADMAP). With a ``wire_dtype``
  every byte term is the actual wire size (``ops/quant.py``'s
  ``wire_bytes_of``: 1-byte payload + f32 scale sidecar), the quiet budget
  probes charge the quantized kernels' gates, and a winner that cannot
  carry a quantized wire is re-labelled and re-priced at the full-precision
  bytes it will ship, as in ``uccl_tpu/collective/plan.py``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Sequence, Tuple

import torch

from uccl_tpu_torch.collective import dma as _dma
from uccl_tpu_torch.obs import counters as _obsc
from uccl_tpu_torch.ops import quant as _quant
from uccl_tpu_torch.utils import config as _config
from uccl_tpu_torch.utils.topology import bcast_tree_rounds


@dataclasses.dataclass(frozen=True)
class RingStep:
    """One hop of a ring schedule, in rank-relative slot arithmetic.

    Member ``r`` sends chunk slot ``(r + dir*send_off) % n`` to its
    ``dir``-neighbor; the chunk received lands in slot
    ``(r + dir*recv_off) % n``, reduced into it (``combine``) or
    overwriting it."""

    dir: int  # +1 = forward ring, -1 = reverse ring
    send_off: int
    recv_off: int
    combine: bool


@dataclasses.dataclass(frozen=True)
class RingPlan:
    """A full collective schedule over one ring of ``world`` members."""

    world: int
    n_slots: int  # chunks the buffer is split into
    steps: Tuple[RingStep, ...]
    name: str = "ring"

    @property
    def n_steps(self) -> int:
        return len(self.steps)

    def validate(self) -> None:
        for st in self.steps:
            if st.dir not in (-1, 1):
                raise ValueError(f"bad direction {st.dir}")


def plan_reduce_scatter(world: int, direction: int = 1) -> RingPlan:
    """Ring reduce-scatter: n-1 steps. Step s: member r sends slot
    (r - dir*(s+1)) and reduces the received chunk into slot (r - dir*(s+2));
    chunk j accumulates along the ring and lands fully-reduced at member j."""
    steps = tuple(
        RingStep(direction, send_off=-(s + 1), recv_off=-(s + 2), combine=True)
        for s in range(world - 1)
    )
    return RingPlan(world, world, steps, "reduce_scatter")


def plan_all_gather(world: int, direction: int = 1) -> RingPlan:
    """Ring all-gather: n-1 steps circulating owned slots; member r owns slot
    r at entry (which is exactly where reduce-scatter leaves things)."""
    steps = tuple(
        RingStep(direction, send_off=-s, recv_off=-(s + 1), combine=False)
        for s in range(world - 1)
    )
    return RingPlan(world, world, steps, "all_gather")


def plan_all_reduce(world: int, direction: int = 1) -> RingPlan:
    """Ring allreduce = reduce-scatter phase then all-gather phase."""
    rs = plan_reduce_scatter(world, direction).steps
    ag = plan_all_gather(world, direction).steps
    return RingPlan(world, world, rs + ag, "all_reduce")


def _hop(slots: Sequence[torch.Tensor], ranks: Sequence[int], src: Sequence[int],
         n: int, dir: int, send_off: int, recv_off: int, combine: bool) -> None:
    """The core ring-hop primitive, in place. ``slots[i]`` is member i's
    view whose dim 0 indexes the ring's chunk slots, ``ranks[i]`` its rank
    on the ring and ``src[i]`` the member it receives from (the
    ``lax.ppermute`` pairs). Every send is read before any slot is written,
    as the ppermute's exchange is simultaneous."""
    sends = [s[(r + dir * send_off) % n].clone() for s, r in zip(slots, ranks)]
    for i, (s, r) in enumerate(zip(slots, ranks)):
        slot = (r + dir * recv_off) % n
        got = sends[src[i]]
        if combine:
            s[slot] = s[slot] + got
        else:
            s[slot] = got


def _flat_ring(n: int, dir: int):
    """ranks and senders of a flat ring of n members in direction dir."""
    return list(range(n)), [(i - dir) % n for i in range(n)]


def lower(plan: RingPlan):
    """Lower a plan to ``step_fn(bufs, s)``: run step s in place on the
    members' ``[n_slots, ...]`` buffers."""
    plan.validate()
    n = plan.world

    def step_fn(bufs, s):
        st = plan.steps[s]
        ranks, src = _flat_ring(n, st.dir)
        _hop(bufs, ranks, src, n, st.dir, st.send_off, st.recv_off, st.combine)

    return step_fn


def execute(plan: RingPlan, x: torch.Tensor) -> torch.Tensor:
    """Run a plan on member-stacked ``x`` ``[world, ...]``: each member's
    payload is flattened, tail-padded to a multiple of ``n_slots`` and split
    into slots. Returns the members' buffers in ``x``'s shape."""
    if x.shape[0] != plan.world:
        raise ValueError(f"{plan.name}: {x.shape[0]} members, plan world {plan.world}")
    n = plan.n_slots
    size = x[0].numel()
    pad = (-size) % n
    flat = x.reshape(x.shape[0], -1)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(x.shape[0], pad)], dim=1)
    bufs = [m.reshape(n, -1).clone() for m in flat.unbind(0)]
    step_fn = lower(plan)
    for s in range(plan.n_steps):
        step_fn(bufs, s)
    out = torch.stack(bufs).reshape(x.shape[0], -1)[:, :size]
    return out.reshape(x.shape)


def ring_all_reduce(x: torch.Tensor, *, bidirectional: bool = True,
                    direction: int = 1) -> torch.Tensor:
    """Ring allreduce (sum) of member-stacked ``x``. With ``bidirectional``
    each member's buffer is split in half and the halves ride two
    counter-rotating rings; ``direction`` rotates the single ring
    otherwise (a directed ring kernel's mirror must hop, and therefore add,
    in the same order to stay bit-identical)."""
    n = x.shape[0]
    if n == 1:
        return x.clone()
    if not bidirectional:
        return execute(plan_all_reduce(n, direction), x)
    flat = x.reshape(n, -1)
    half = flat.shape[1] // 2
    fwd = execute(plan_all_reduce(n), flat[:, :half])
    rev_plan = RingPlan(
        n, n,
        tuple(dataclasses.replace(s, dir=-s.dir) for s in plan_all_reduce(n).steps),
        "all_reduce_rev",
    )
    bwd = execute(rev_plan, flat[:, half:])
    return torch.cat([fwd, bwd], dim=1).reshape(x.shape)


def ring_reduce_scatter(x: torch.Tensor) -> torch.Tensor:
    """x: ``[n, n*k, ...]`` → ``[n, k, ...]``: member r keeps reduced slot r."""
    n = x.shape[0]
    if n == 1:
        return x.clone()
    out = execute(plan_reduce_scatter(n), x)
    per = x.shape[1] // n
    return torch.stack([out[r, r * per:(r + 1) * per] for r in range(n)])


def ring_all_gather(x: torch.Tensor) -> torch.Tensor:
    """x: ``[n, k, ...]`` → ``[n, n*k, ...]``: every member holds all slots."""
    n = x.shape[0]
    if n == 1:
        return x.clone()
    k = x.shape[1]
    bufs = []
    for r in range(n):
        b = x.new_zeros((n,) + tuple(x.shape[1:]))
        b[r] = x[r]
        bufs.append(b)
    step_fn = lower(plan_all_gather(n))
    for s in range(n - 1):
        step_fn(bufs, s)
    return torch.stack(bufs).reshape((n, n * k) + tuple(x.shape[2:]))


# ---------------------------------------------------------------------------
# Chunk DAG: ops with dependencies, executed by BFS layer


@dataclasses.dataclass(frozen=True)
class ChunkOp:
    """One DAG node: a ring hop on ``axes[axis_idx]`` over chunk stream
    ``stream``. ``shard_axis``: when set, the op first restricts the slot
    view to this member's OWN slot group along that axis and rings only that
    group (the 2D torus middle phase rings 1/a of the buffer)."""

    id: int
    deps: Tuple[int, ...]
    axis_idx: int
    dir: int
    send_off: int
    recv_off: int
    combine: bool
    stream: int = 0
    shard_axis: int | None = None


@dataclasses.dataclass(frozen=True)
class ChunkGraph:
    """A collective as a dependency DAG of chunk ops over mesh axes;
    ``worlds[i]`` is the ring size of ``axes[i]``."""

    axes: Tuple[str, ...]
    worlds: Tuple[int, ...]
    n_streams: int
    ops: Tuple[ChunkOp, ...]
    name: str = "graph"

    def validate(self) -> None:
        ids = {op.id for op in self.ops}
        if len(ids) != len(self.ops):
            raise ValueError("duplicate op ids")
        for op in self.ops:
            if not 0 <= op.axis_idx < len(self.axes):
                raise ValueError(f"op {op.id}: bad axis index {op.axis_idx}")
            if op.dir not in (-1, 1):
                raise ValueError(f"op {op.id}: bad direction {op.dir}")
            if not 0 <= op.stream < self.n_streams:
                raise ValueError(f"op {op.id}: bad stream {op.stream}")
            if op.shard_axis is not None:
                if not 0 <= op.shard_axis < len(self.axes):
                    raise ValueError(f"op {op.id}: bad shard axis")
                if op.shard_axis == op.axis_idx:
                    raise ValueError(f"op {op.id}: shard axis == ring axis")
            for d in op.deps:
                if d not in ids:
                    raise ValueError(f"op {op.id}: unknown dep {d}")

    def layers(self) -> List[List[ChunkOp]]:
        """Topological BFS layers. Raises on cycles."""
        remaining = {op.id: op for op in self.ops}
        done: set = set()
        out: List[List[ChunkOp]] = []
        while remaining:
            layer = [op for op in remaining.values() if all(d in done for d in op.deps)]
            if not layer:
                raise ValueError(f"cycle in chunk graph {self.name}")
            layer.sort(key=lambda op: op.id)
            out.append(layer)
            for op in layer:
                done.add(op.id)
                del remaining[op.id]
        return out


def graph_bidirectional_all_reduce(world: int, axis: str) -> ChunkGraph:
    """Two counter-rotating rings on independent streams."""
    fwd = plan_all_reduce(world, 1).steps
    ops: List[ChunkOp] = []
    for i, st in enumerate(fwd):
        ops.append(ChunkOp(2 * i, (2 * (i - 1),) if i else (), 0, st.dir,
                           st.send_off, st.recv_off, st.combine, stream=0))
        ops.append(ChunkOp(2 * i + 1, (2 * (i - 1) + 1,) if i else (), 0,
                           -st.dir, st.send_off, st.recv_off, st.combine, stream=1))
    return ChunkGraph((axis,), (world,), 2, tuple(ops), "all_reduce_bidir")


def graph_torus_all_reduce(worlds: Tuple[int, int], axes: Tuple[str, str]) -> ChunkGraph:
    """2D-torus (axis-pair) allreduce: reduce-scatter along axis 0, allreduce
    the scattered shard along axis 1, all-gather back along axis 0."""
    a, b = worlds
    ops: List[ChunkOp] = []
    nid = 0
    last = None

    def add(axis_idx, st, shard_axis=None):
        nonlocal nid, last
        ops.append(ChunkOp(nid, (last,) if last is not None else (), axis_idx,
                           st.dir, st.send_off, st.recv_off, st.combine,
                           shard_axis=shard_axis))
        last = nid
        nid += 1

    for st in plan_reduce_scatter(a).steps:
        add(0, st)
    for st in plan_all_reduce(b).steps:
        add(1, st, shard_axis=0)
    for st in plan_all_gather(a).steps:
        add(0, st)
    return ChunkGraph(tuple(axes), (a, b), 1, tuple(ops), "all_reduce_torus2d")


def execute_graph(graph: ChunkGraph, x: torch.Tensor) -> torch.Tensor:
    """Run a chunk graph on member-stacked ``x`` ``[prod(worlds), ...]``;
    member i sits at the row-major coordinates of i over ``graph.worlds``
    (the linearization of a tuple of mesh axes). Each member's buffer splits
    into ``n_streams`` streams of ``prod(worlds)`` slots laid out
    hierarchically (``[w0, w1, ..., payload]``)."""
    graph.validate()
    worlds = graph.worlds
    n_members = math.prod(worlds)
    if x.shape[0] != n_members:
        raise ValueError(f"{x.shape[0]} members, plan worlds {worlds}")
    coords = [_unravel(i, worlds) for i in range(n_members)]
    size = x[0].numel()
    per_stream = graph.n_streams * n_members
    pad = (-size) % per_stream
    flat = x.reshape(n_members, -1)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(n_members, pad)], dim=1)
    # streams[member][stream] viewed as [w0, w1, ..., payload]
    streams = [[s.clone().reshape(worlds + (-1,)) for s in
                m.reshape(graph.n_streams, n_members, -1).unbind(0)]
               for m in flat.unbind(0)]

    def apply_op(op: ChunkOp) -> None:
        n = worlds[op.axis_idx]
        views, ranks = [], []
        for i in range(n_members):
            v = streams[i][op.stream]
            dim = op.axis_idx
            if op.shard_axis is not None:
                v = v.select(op.shard_axis, coords[i][op.shard_axis])
                dim -= 1 if op.axis_idx > op.shard_axis else 0
            views.append(v.movedim(dim, 0))
            ranks.append(coords[i][op.axis_idx])
        src = []
        for i in range(n_members):
            c = list(coords[i])
            c[op.axis_idx] = (c[op.axis_idx] - op.dir) % n
            src.append(_ravel(c, worlds))
        _hop(views, ranks, src, n, op.dir, op.send_off, op.recv_off, op.combine)

    for layer in graph.layers():
        for op in layer:
            apply_op(op)
    out = torch.stack([torch.stack(s).reshape(-1) for s in streams])[:, :size]
    return out.reshape(x.shape)


def _unravel(i: int, worlds: Sequence[int]) -> Tuple[int, ...]:
    out = []
    for w in reversed(worlds):
        out.append(i % w)
        i //= w
    return tuple(reversed(out))


def _ravel(c: Sequence[int], worlds: Sequence[int]) -> int:
    i = 0
    for ci, w in zip(c, worlds):
        i = i * w + ci
    return i


def torus_all_reduce(x: torch.Tensor, worlds: Tuple[int, int],
                     axes: Tuple[str, str] = ("a0", "a1")) -> torch.Tensor:
    """Axis-pair allreduce over a 2D grid of members of sizes ``worlds``."""
    if worlds[0] == 1 or worlds[1] == 1:
        return ring_all_reduce(x)
    return execute_graph(graph_torus_all_reduce(tuple(worlds), tuple(axes)), x)


def tree_broadcast(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """Binomial-tree broadcast: at round t, members with virtual rank < 2^t
    forward to virtual rank + 2^t; everyone else passes zeros and keeps its
    value (``utils.topology.bcast_tree_rounds``)."""
    n = x.shape[0]
    if n == 1:
        return x.clone()
    vr = [(r - root) % n for r in range(n)]
    cur = [x[r].clone() if vr[r] == 0 else torch.zeros_like(x[r]) for r in range(n)]
    mask = 1
    for pairs in bcast_tree_rounds(n, root):
        got = [torch.zeros_like(x[0]) for _ in range(n)]
        for s, d in pairs:
            got[d] = cur[s]
        cur = [got[r] if mask <= vr[r] < 2 * mask else cur[r] for r in range(n)]
        mask <<= 1
    return torch.stack(cur)


def hd_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """Recursive-halving reduce-scatter + recursive-doubling all-gather of
    member-stacked ``x``. Power-of-two worlds; the ring plan otherwise.
    Reduce-scatter consumes rank bits MSB-first (distance W/2 .. 1); member
    r ends owning chunk slot r; the all-gather mirrors LSB-first."""
    n = x.shape[0]
    if n == 1:
        return x.clone()
    if n & (n - 1):
        return ring_all_reduce(x)
    size = x[0].numel()
    pad = (-size) % n
    flat = x.reshape(n, -1)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(n, pad)], dim=1)
    bufs = [m.reshape(n, -1).clone() for m in flat.unbind(0)]
    base = [0] * n
    span, dist = n, n // 2
    while dist >= 1:
        half = span // 2
        keep = [base[r] + (half if r & dist else 0) for r in range(n)]
        send = [base[r] + (0 if r & dist else half) for r in range(n)]
        chunks = [bufs[r][send[r]:send[r] + half].clone() for r in range(n)]
        for r in range(n):
            k = keep[r]
            bufs[r][k:k + half] = bufs[r][k:k + half] + chunks[r ^ dist]
        base, span, dist = keep, half, dist // 2
    span, dist = 1, 1
    while dist < n:
        chunks = [bufs[r][base[r]:base[r] + span].clone() for r in range(n)]
        for r in range(n):
            dst = base[r] ^ dist
            bufs[r][dst:dst + span] = chunks[r ^ dist]
        base = [b & ~dist for b in base]
        span, dist = span * 2, dist * 2
    out = torch.stack(bufs).reshape(n, -1)[:, :size]
    return out.reshape(x.shape)


# ---------------------------------------------------------------------------
# The cost-model planner. The constants are the JAX package's defaults, fit
# to a TPU's ICI; they are carried as the defaults of the same knobs so that
# ``auto`` decides as the JAX package does, and are not fit to an H100.

_AR_SMALL_BYTES = _config.param(
    "AR_HD_MAX_BYTES", 1 << 18, int,
    "all_reduce planner: wire payloads at or under this many bytes are "
    "eligible for the log-step halving-doubling plan",
)
_AR_FORCE_ALGO = _config.param(
    "AR_ALGO", "", str,
    "override the all_reduce planner with a fixed algorithm "
    "(xla|ring|hd|torus|pallas|bidir) — forced calibration: the planner "
    "still runs and emits its decision, with outcome 'forced'",
)
_PLAN_ALPHA = _config.param(
    "PLAN_ALPHA_US", 1.0, float, "planner cost model: per-ring-hop latency (alpha)")
_PLAN_BETA = _config.param(
    "PLAN_BETA_US_PER_BYTE", 1.0e-3, float,
    "planner cost model: serial wire time per byte per member (beta)")
_PLAN_GAMMA = _config.param(
    "PLAN_GAMMA_US", 5.0, float, "planner cost model: per-kernel-launch overhead (gamma)")
_PLAN_XLA_ALPHA = _config.param(
    "PLAN_XLA_ALPHA_US", 40.0, float,
    "planner cost model: fixed dispatch cost of one library collective")
_PLAN_XLA_BETA = _config.param(
    "PLAN_XLA_BETA_US_PER_BYTE", 1.7e-3, float,
    "planner cost model: per-byte time of the library collective on one axis")
_PLAN_XLA_SNAKE = _config.param(
    "PLAN_XLA_SNAKE", 2.0, float,
    "planner cost model: byte-time penalty of a flat library schedule over "
    "two axes relative to one")
_PLAN_DCN_BETA = _config.param(
    "PLAN_DCN_BETA_US_PER_BYTE", 1.0e-2, float,
    "planner cost model: per-byte time of the cross-pod leg (hierarchical)")

PLAN_TOTAL = _obsc.counter(
    "collective_plan_total",
    "collective planner decisions by algorithm, chunk/stream depth, wire "
    "dtype and outcome (model = cost model chose, forced = UCCL_TPU_AR_ALGO"
    " calibration override, explicit = caller named the algo, fallback = a "
    "planned kernel degraded to its counted lax mirror)",
)
PLAN_PREDICTED = _obsc.gauge(
    "collective_plan_predicted_us",
    "the cost model's predicted time (us) of the last plan decision per "
    "{algo, chunks, wire_dtype}",
)


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Alpha-beta-gamma constants of the planner (all in us / us-per-byte)."""

    alpha_us: float
    beta_us_per_byte: float
    gamma_us: float
    xla_alpha_us: float
    xla_beta_us_per_byte: float
    xla_snake: float
    dcn_beta_us_per_byte: float = 1.0e-2

    @classmethod
    def from_env(cls) -> "CostModel":
        return cls(
            alpha_us=_PLAN_ALPHA.get(),
            beta_us_per_byte=_PLAN_BETA.get(),
            gamma_us=_PLAN_GAMMA.get(),
            xla_alpha_us=_PLAN_XLA_ALPHA.get(),
            xla_beta_us_per_byte=_PLAN_XLA_BETA.get(),
            xla_snake=_PLAN_XLA_SNAKE.get(),
            dcn_beta_us_per_byte=_PLAN_DCN_BETA.get(),
        )

    def predict(self, algo: str, world: int, wire_bytes: int,
                n_axes: int = 1, worlds=None, dcn_world: int = 1) -> float:
        """Predicted us of one allreduce of ``wire_bytes`` per member."""
        if world <= 1 and dcn_world <= 1:
            return 0.0
        if algo == "xla":
            snake = self.xla_snake if n_axes > 1 else 1.0
            return self.xla_alpha_us + self.xla_beta_us_per_byte * snake * wire_bytes
        hops, serial_bytes, launches = cost_features(algo, world, wire_bytes, worlds=worlds)
        t = (self.alpha_us * hops + self.beta_us_per_byte * serial_bytes
             + self.gamma_us * launches)
        if algo == "hier" and dcn_world > 1:
            t += self.dcn_beta_us_per_byte * 2.0 * (dcn_world - 1) / dcn_world * wire_bytes
        return t

    def predict_verb(self, verb: str, algo: str, world: int, wire_bytes: int,
                     n_axes: int = 1, worlds=None) -> float:
        """Predicted us of one ``verb`` collective under the same constants."""
        if verb == "all_reduce":
            return self.predict(algo, world, wire_bytes, n_axes, worlds)
        if world <= 1:
            return 0.0
        if algo in ("xla", "psum"):
            snake = self.xla_snake if n_axes > 1 else 1.0
            vol = xla_wire_volume(verb, world, wire_bytes)
            return self.xla_alpha_us + self.xla_beta_us_per_byte * snake * vol
        hops, serial_bytes, launches = verb_cost_features(verb, algo, world, wire_bytes,
                                                          worlds=worlds)
        return (self.alpha_us * hops + self.beta_us_per_byte * serial_bytes
                + self.gamma_us * launches)


def torus_split(world: int) -> Tuple[int, int]:
    """The (a, b) factor pair of ``world`` closest to square."""
    a = int(world ** 0.5)
    while a > 1 and world % a:
        a -= 1
    return (max(a, 1), world // max(a, 1))


def cost_features(algo: str, world: int, wire_bytes: int,
                  worlds=None) -> Tuple[float, float, int]:
    """(hops, serial wire bytes per member, kernel launches) of one
    allreduce under ``algo``."""
    w = world
    b = float(wire_bytes)
    if algo in ("ring", "pallas"):
        return 2.0 * (w - 1), 2.0 * (w - 1) / w * b, 1
    if algo == "bidir":
        return 2.0 * (w - 1), (w - 1) / w * b, 2
    if algo == "hd":
        if w & (w - 1):
            return 2.0 * (w - 1), 2.0 * (w - 1) / w * b, 1
        return 2.0 * math.log2(w), 2.0 * (w - 1) / w * b, 1
    if algo == "torus":
        a, bb = worlds if worlds and len(worlds) == 2 else torus_split(w)
        if a == 1 or bb == 1:
            return 2.0 * (w - 1), 2.0 * (w - 1) / w * b, 1
        hops = 2.0 * (a - 1) + 2.0 * (bb - 1)
        vol = (2.0 * (a - 1) / a + 2.0 * (bb - 1) / (a * bb)) * b
        return hops, vol, 1
    if algo == "hier":
        return 2.0 * (w - 1), 2.0 * (w - 1) / w * b, 1
    if algo == "xla":
        return 1.0, b, 1
    raise ValueError(f"unknown plan algo {algo!r}")


def xla_wire_volume(verb: str, world: int, wire_bytes: int) -> float:
    """Per-member byte volume the xla line of ``verb`` is priced over."""
    if verb == "all_gather":
        return float((world - 1) * wire_bytes)
    if verb == "reduce_scatter":
        return float(world - 1) / float(world) * wire_bytes
    return float(wire_bytes)


def verb_cost_features(verb: str, algo: str, world: int, wire_bytes: int,
                       worlds=None) -> Tuple[float, float, int]:
    """(hops, serial wire bytes per member, kernel launches) of one
    broadcast / all_gather / reduce_scatter under ``algo``."""
    w = world
    b = float(wire_bytes)
    if verb == "all_reduce":
        return cost_features(algo, w, b, worlds=worlds)
    if verb == "broadcast":
        if algo == "tree":
            r = math.ceil(math.log2(max(w, 2)))
            return float(r), float(r) * b, 1
        if algo == "scatter_ag":
            return 2.0 * (w - 1), 1.5 * (w - 1) / w * b, 2
        if algo == "xla":
            return 1.0, b, 1
        raise ValueError(f"unknown broadcast algo {algo!r}")
    if verb == "all_gather":
        if algo in ("ring", "pallas"):
            return float(w - 1), float(w - 1) * b, 1
        if algo == "bidir":
            return float(w - 1), (w - 1) * b / 2.0, 2
        if algo == "xla":
            return 1.0, float(w - 1) * b, 1
        raise ValueError(f"unknown all_gather algo {algo!r}")
    if verb == "reduce_scatter":
        if algo in ("ring", "pallas"):
            return float(w - 1), (w - 1) / float(w) * b, 1
        if algo == "xla":
            return 1.0, (w - 1) / float(w) * b, 1
        raise ValueError(f"unknown reduce_scatter algo {algo!r}")
    raise ValueError(f"unknown plan verb {verb!r}")


@dataclasses.dataclass(frozen=True)
class Plan:
    """One planner decision: what will carry the collective and why."""

    algo: str
    chunks: int  # concurrent streams/kernels (bidir = 2) or chunk depth
    wire_dtype: Optional[str]
    world: int
    wire_bytes: int
    predicted_us: float
    outcome: str  # "model" | "forced" | "explicit"
    verb: str = "all_reduce"


def _elems(payload_shape) -> int:
    return math.prod(int(s) for s in payload_shape)


# the algos of each verb that can carry a quantized wire (the ring kernels)
_QUANT_CARRIERS = {
    "all_reduce": ("pallas", "bidir"),
    "all_gather": ("ring", "bidir"),
    "reduce_scatter": ("ring",),
    "broadcast": ("scatter_ag",),
}


class CollectivePlanner:
    """Cost-model-driven algorithm selection for the collective verbs.
    Every decision — modeled, forced via ``UCCL_TPU_AR_ALGO``, or named by
    the caller — is emitted on ``collective_plan_total`` and
    ``collective_plan_predicted_us``."""

    def __init__(self, model: Optional[CostModel] = None):
        self._model = model

    @property
    def model(self) -> CostModel:
        return self._model if self._model is not None else CostModel.from_env()

    @staticmethod
    def wire_bytes(payload_shape, dtype: torch.dtype, wire_dtype=None) -> int:
        """Bytes one exchange of the payload moves on the wire: quantized
        payload + scale sidecar under a ``wire_dtype``, element bytes
        otherwise."""
        return _quant.wire_bytes_of(tuple(payload_shape), dtype,
                                    _quant.resolve_wire_dtype(wire_dtype))

    def _best(self, verb, candidates, world, wire_bytes, n_axes, worlds):
        m = self.model
        best, best_cost = "xla", None
        for algo in candidates:
            cost = m.predict_verb(verb, algo, world, wire_bytes, n_axes, worlds)
            if best_cost is None or cost < best_cost:
                best, best_cost = algo, cost
        return best, best_cost

    def _final(self, verb, algo, payload_shape, dtype, wire_dtype, world, cost, outcome,
               n_axes, worlds, emit) -> Plan:
        """The decision as a Plan. Selection was priced at wire bytes; a
        winner that cannot carry a quantized wire ships full precision, so
        it is re-labelled and re-priced at those bytes (the caller counts
        the quant downgrade)."""
        if wire_dtype is not None and algo not in _QUANT_CARRIERS[verb]:
            wire_dtype, cost = None, None
        wire_bytes = self.wire_bytes(payload_shape, dtype, wire_dtype)
        if cost is None:
            cost = self.model.predict_verb(verb, algo, world, wire_bytes, n_axes, worlds)
        chunks = 2 if algo == "bidir" or (verb == "broadcast" and algo == "scatter_ag") else 1
        plan_ = Plan(algo, chunks, wire_dtype, world, wire_bytes, cost, outcome, verb)
        return self._emit(plan_) if emit else plan_

    def plan_all_reduce(self, payload_shape, dtype, world: int, *, n_axes: int = 1,
                        worlds=None, wire_dtype=None, pallas_ok: bool = False,
                        emit: bool = True) -> Plan:
        """Pick the allreduce algorithm for a per-member payload.
        ``pallas_ok`` gates the device-kernel candidate (bidir): the caller
        asserts its mesh is kernel-addressable; the planner also asks the
        arena budget quietly, so auto never picks a kernel that would
        immediately fall back."""
        wire_dtype = _quant.resolve_wire_dtype(wire_dtype)
        wire_bytes = self.wire_bytes(payload_shape, dtype, wire_dtype)
        final = (payload_shape, dtype, wire_dtype, world)
        forced = _AR_FORCE_ALGO.get()
        if forced:
            return self._final("all_reduce", forced, *final, None, "forced", n_axes, worlds,
                               emit)
        if world <= 1:
            return self._final("all_reduce", "xla", *final, 0.0, "model", n_axes, worlds, emit)
        candidates = ["xla"]
        if world & (world - 1) == 0 and wire_bytes <= _AR_SMALL_BYTES.get():
            candidates.append("hd")
        if n_axes == 2:
            candidates.append("torus")
        if pallas_ok and n_axes == 1 and self._bidir_budget_ok(payload_shape, dtype,
                                                               wire_dtype, world):
            candidates.append("bidir")
        best, cost = self._best("all_reduce", candidates, world, wire_bytes, n_axes, worlds)
        return self._final("all_reduce", best, *final, cost, "model", n_axes, worlds, emit)

    def plan_explicit(self, algo: str, payload_shape, dtype, world: int, *,
                      n_axes: int = 1, worlds=None, wire_dtype=None, emit: bool = True,
                      outcome: str = "explicit", verb: str = "all_reduce") -> Plan:
        """Record a caller-named algorithm as a plan, with the model's
        predicted cost beside it (0 for an algo the model does not price)."""
        wire_dtype = _quant.resolve_wire_dtype(wire_dtype)
        wire_bytes = self.wire_bytes(payload_shape, dtype, wire_dtype)
        try:
            pred = self.model.predict_verb(verb, algo, world, wire_bytes, n_axes, worlds)
        except ValueError:
            pred = 0.0
        plan_ = Plan(algo, 2 if algo in ("bidir", "scatter_ag") else 1, wire_dtype, world,
                     wire_bytes, pred, outcome, verb)
        return self._emit(plan_) if emit else plan_

    def _plan_verb(self, verb, kernel_candidates, payload_shape, dtype, world, n_axes,
                   worlds, wire_dtype, pallas_ok, emit) -> Plan:
        """The decision of a non-allreduce verb: ``xla`` (and ``tree`` for a
        broadcast), plus each kernel candidate whose quiet budget probe
        passes."""
        wire_dtype = _quant.resolve_wire_dtype(wire_dtype)
        wire_bytes = self.wire_bytes(payload_shape, dtype, wire_dtype)
        final = (payload_shape, dtype, wire_dtype, world)
        if world <= 1:
            return self._final(verb, "xla", *final, 0.0, "model", n_axes, worlds, emit)
        candidates = ["xla", "tree"] if verb == "broadcast" else ["xla"]
        if pallas_ok and n_axes == 1:
            candidates += [algo for algo, probe in kernel_candidates
                           if probe(payload_shape, dtype, wire_dtype, world)]
        best, cost = self._best(verb, candidates, world, wire_bytes, n_axes, worlds)
        return self._final(verb, best, *final, cost, "model", n_axes, worlds, emit)

    def plan_broadcast(self, payload_shape, dtype, world: int, *, n_axes: int = 1,
                       worlds=None, wire_dtype=None, pallas_ok: bool = False,
                       emit: bool = True) -> Plan:
        """Pick the broadcast algorithm: ``xla``, ``tree`` or ``scatter_ag``."""
        return self._plan_verb("broadcast", [("scatter_ag", self._bcast_budget_ok)],
                               payload_shape, dtype, world, n_axes, worlds, wire_dtype,
                               pallas_ok, emit)

    def plan_all_gather(self, payload_shape, dtype, world: int, *, n_axes: int = 1,
                        worlds=None, wire_dtype=None, pallas_ok: bool = False,
                        emit: bool = True) -> Plan:
        """Pick the all-gather algorithm for one member's CONTRIBUTED
        payload: ``xla``, ``ring`` or ``bidir``."""
        probes = [("ring", functools.partial(self._ag_budget_ok, pair=False)),
                  ("bidir", functools.partial(self._ag_budget_ok, pair=True))]
        return self._plan_verb("all_gather", probes, payload_shape, dtype, world, n_axes,
                               worlds, wire_dtype, pallas_ok, emit)

    def plan_reduce_scatter(self, payload_shape, dtype, world: int, *, n_axes: int = 1,
                            worlds=None, wire_dtype=None, pallas_ok: bool = False,
                            emit: bool = True) -> Plan:
        """Pick the reduce-scatter algorithm for one member's FULL
        ``[world*k, ...]`` input: ``xla`` or ``ring``."""
        return self._plan_verb("reduce_scatter", [("ring", self._rs_budget_ok)],
                               payload_shape, dtype, world, n_axes, worlds, wire_dtype,
                               pallas_ok, emit)

    # -- quiet budget probes: each charges exactly what its kernel's gate
    # charges (ring_ccl's charge functions, at the wire dtype), against the
    # same limit

    @staticmethod
    def _probe(charge_fn, payload_shape, dtype, wire_dtype, world) -> bool:
        charge = charge_fn(_elems(payload_shape), dtype.itemsize, world, wire_dtype)
        return _dma.check_budget(charge, "planner_probe", quiet=True)

    def _rs_budget_ok(self, payload_shape, dtype, wire_dtype, world: int) -> bool:
        from uccl_tpu_torch.collective import ring_ccl

        return self._probe(ring_ccl.rs_charge, payload_shape, dtype, wire_dtype, world)

    def _bidir_budget_ok(self, payload_shape, dtype, wire_dtype, world: int) -> bool:
        from uccl_tpu_torch.collective import ring_ccl

        return self._probe(ring_ccl.bidir_pair_charge, payload_shape, dtype, wire_dtype, world)

    def _ag_budget_ok(self, payload_shape, dtype, wire_dtype, world: int, *,
                      pair: bool) -> bool:
        from uccl_tpu_torch.collective import ring_ccl

        fn = ring_ccl.ag_pair_charge if pair else ring_ccl.ag_charge
        return self._probe(fn, payload_shape, dtype, wire_dtype, world)

    def _bcast_budget_ok(self, payload_shape, dtype, wire_dtype, world: int) -> bool:
        from uccl_tpu_torch.collective import ring_ccl

        return self._probe(ring_ccl.bcast_pair_charge, payload_shape, dtype, wire_dtype, world)

    def _emit(self, plan_: Plan) -> Plan:
        # allreduce keeps its label set without a verb label, as in the JAX
        # package; the other verbs carry verb=
        extra = {} if plan_.verb == "all_reduce" else {"verb": plan_.verb}
        PLAN_TOTAL.inc(algo=plan_.algo, chunks=plan_.chunks,
                       wire_dtype=plan_.wire_dtype or "none", outcome=plan_.outcome, **extra)
        PLAN_PREDICTED.set(plan_.predicted_us, algo=plan_.algo, chunks=plan_.chunks,
                           wire_dtype=plan_.wire_dtype or "none", **extra)
        return plan_


_PLANNER = CollectivePlanner()


def get_planner() -> CollectivePlanner:
    """The process-wide planner (model constants re-read from the params on
    every decision, so overrides take effect live)."""
    return _PLANNER


def select_all_reduce_algo(nbytes: int, world: int, n_axes: int = 1) -> str:
    """One planner decision on a flat ``nbytes`` f32 payload, without the
    device-kernel candidates."""
    return get_planner().plan_all_reduce(
        (max(1, nbytes // 4),), torch.float32, world, n_axes=n_axes).algo
