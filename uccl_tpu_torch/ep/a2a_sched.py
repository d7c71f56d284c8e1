"""Contention-aware scheduling of the EP all-to-all traffic matrix.

The EP dispatch/combine wire ships every (src, dst) pair simultaneously on
fixed counter-rotating streams (ep/pallas_a2a.py): under skewed expert
routing — the common case in real MoE traffic — the hottest link serializes
while cold links idle. FAST (PAPERS.md: "An Efficient Scheduler for
All-to-All GPU Communication") recovers that bandwidth by decomposing the
traffic matrix into load-ordered contention-free permutation rounds: each
round every member sends to at most one peer and receives from at most one
peer, so no ICI port carries two transfers at once, and the heaviest flows
go first so stragglers overlap the tail instead of gating it.

This module is the HOST side of that design: pure-numpy schedule
construction over a [W, W] traffic matrix, consumed on the device side
(:func:`ep.pallas_a2a.scheduled_all_to_all`) which runs one Birkhoff round
per kernel on rotated collective ids (B10 in ``csrc/ep_a2a.cu``).

Port copy of ``uccl_tpu/ep/a2a_sched.py`` (numpy only there too), on this
package's counter registry: for the same matrix it gives the same rounds,
the same designated-round matrix and the same counter series. Nothing here traces — the matrix must
be host-available (benches/serving derive it from routing counts via
:func:`traffic_from_topk`; inside a jit the counts are traced, so callers
pass the matrix through the ``a2a_sched`` knob instead).

Vocabulary: a *round* is a partial permutation ``perm[W]`` (``perm[s]`` =
destination of member ``s``'s transfer this round, ``-1`` = idle). The
greedy heaviest-first first-fit below is the classic Birkhoff-von-Neumann
style decomposition relaxed to partial matchings: every nonzero
off-diagonal entry lands in exactly one round, no round has a source or
destination conflict, and the round count is bounded by the greedy
edge-coloring bound ``2·Δ − 1`` (Δ = max in/out degree of the nonzero
pattern) — each edge (s, d) conflicts with at most Δ−1 other edges at s
plus Δ−1 at d, so first-fit always finds a free round among the first
``2Δ − 1``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from uccl_tpu_torch.obs import counters as _obsc

# get-or-create: the scheduled-a2a observability pair (OBSERVABILITY.md).
ROUNDS_TOTAL = _obsc.counter(
    "ep_a2a_rounds_total",
    "permutation rounds driven by the scheduled EP all-to-all, by algo "
    "(sched = contention-free Birkhoff rounds, streams = the fixed "
    "counter-rotating wire counted as its W-1 implicit rounds)",
)
SKEW_GAUGE = _obsc.gauge(
    "ep_a2a_skew",
    "hottest-port/mean-port load of the last EP traffic matrix the a2a "
    "planner saw (1.0 = uniform; the sched/streams crossover input)",
)


@dataclasses.dataclass(frozen=True)
class Round:
    """One contention-free permutation round of the decomposition.

    ``perm[s]`` is the destination member of source ``s`` (``-1`` = idle
    this round); ``load`` is the round's total traffic (sum of the matrix
    entries it carries) — the heaviest-first sort key.
    """

    perm: Tuple[int, ...]
    load: float

    @property
    def n_edges(self) -> int:
        return sum(1 for d in self.perm if d >= 0)

    def inverse(self) -> Tuple[int, ...]:
        """``inv[d]`` = source sending to member ``d`` this round (-1 = none)."""
        inv = [-1] * len(self.perm)
        for s, d in enumerate(self.perm):
            if d >= 0:
                inv[d] = s
        return tuple(inv)


def _as_matrix(matrix) -> np.ndarray:
    m = np.asarray(matrix, np.float64)
    if m.ndim != 2 or m.shape[0] != m.shape[1]:
        raise ValueError(f"traffic matrix must be square, got {m.shape}")
    if (m < 0).any():
        raise ValueError("traffic matrix entries must be non-negative")
    return m


def skew(matrix) -> float:
    """Hottest-port / mean-port load of the OFF-DIAGONAL traffic — the
    planner's contention feature. Row s = bytes member s's send port ships,
    column d = bytes member d's receive port absorbs; the fixed streams
    serialize behind whichever port is hottest (real MoE skew is usually a
    hot COLUMN — everyone routing to the members that own the popular
    experts), while the mean row is what a perfectly balanced schedule
    would pay. Uniform (and all-zero) matrices score 1.0. Symmetric under
    transposition, so dispatch and its transposed combine matrix see the
    same value."""
    m = _as_matrix(matrix).copy()
    np.fill_diagonal(m, 0.0)
    rows = m.sum(axis=1)
    mean = rows.mean()
    if mean <= 0.0:
        return 1.0
    return float(max(rows.max(), m.sum(axis=0).max()) / mean)


def max_degree(matrix) -> int:
    """Max nonzero in/out degree of the off-diagonal pattern (the Δ of the
    ``2Δ − 1`` greedy round bound)."""
    m = _as_matrix(matrix).copy()
    np.fill_diagonal(m, 0.0)
    nz = m > 0.0
    if not nz.any():
        return 0
    return int(max(nz.sum(axis=1).max(), nz.sum(axis=0).max()))


def decompose(matrix) -> List[Round]:
    """Greedy heaviest-first Birkhoff-style decomposition into partial
    permutation rounds.

    Edges (off-diagonal nonzero entries) are processed by descending weight
    (ties broken by (src, dst) for determinism) and first-fit assigned to
    the earliest round where both the source's send port and the
    destination's receive port are free. The result is returned sorted by
    round load, heaviest first. Properties (tested host-only in
    tests/test_a2a_sched.py, and the copy against it in
    tests/test_torch_a2a_sched.py):

    * each round is a partial permutation — no port contention;
    * every nonzero off-diagonal entry is carried by exactly one round, so
      the per-edge sum over rounds reproduces the matrix exactly;
    * ``len(rounds) ≤ max(1, 2·max_degree(matrix) − 1)``;
    * round loads are non-increasing (heaviest-first ordering).

    The diagonal (local traffic) never crosses the wire and is ignored.
    A zero matrix decomposes to no rounds.
    """
    m = _as_matrix(matrix)
    w = m.shape[0]
    edges = [
        (float(m[s, d]), s, d)
        for s in range(w)
        for d in range(w)
        if s != d and m[s, d] > 0.0
    ]
    edges.sort(key=lambda e: (-e[0], e[1], e[2]))

    perms: List[List[int]] = []
    loads: List[float] = []
    src_used: List[set] = []
    dst_used: List[set] = []
    for wgt, s, d in edges:
        for i in range(len(perms)):
            if s not in src_used[i] and d not in dst_used[i]:
                break
        else:
            i = len(perms)
            perms.append([-1] * w)
            loads.append(0.0)
            src_used.append(set())
            dst_used.append(set())
        perms[i][s] = d
        loads[i] += wgt
        src_used[i].add(s)
        dst_used[i].add(d)

    rounds = [Round(tuple(p), l) for p, l in zip(perms, loads)]
    rounds.sort(key=lambda r: -r.load)
    return rounds


def full_rounds(world: int) -> List[Round]:
    """The unscheduled wire's implicit schedule as rounds: W−1 full rotation
    permutations (round s sends s+1 hops forward) — what the fixed streams
    ship when every pair talks. Used to complete a partial decomposition to
    total coverage (:func:`complete_rounds`) and as the streams-side round
    count on :data:`ROUNDS_TOTAL`."""
    return [
        Round(tuple((s + h) % world for s in range(world)), 0.0)
        for h in range(1, world)
    ]


def wire_schedule(matrix, world: int) -> Tuple[List[Round], np.ndarray]:
    """The device-side schedule: full-permutation rounds + the
    designated-round matrix.

    The fixed-capacity EP wire ships ALL W·(W−1) off-diagonal slots
    (zero-count pairs carry empty capacity rows), so the device schedule
    must cover the complete bipartite pattern regardless of which matrix
    entries were nonzero — and under the interpret-mode substrate a remote
    DMA is a rendezvous collective over ALL mesh members, so every round
    must keep every member participating: rounds are FULL permutations,
    never partial (a member with nothing useful to send this round ships a
    shadow edge — a self-loop is a cheap local copy, a duplicate pair is
    dead bandwidth on a port that was idle anyway). Construction:

    1. :func:`decompose` the matrix (heaviest-first partial matchings);
    2. first-fit the uncovered zero-load off-diagonal pairs into the
       existing rounds' free ports (new trailing rounds only when full) —
       after this every off-diagonal pair has exactly ONE designated round,
       recorded in ``K[s, d]``;
    3. pad each round's remaining holes to a full permutation with shadow
       edges (self-loops first, then a rotation of the leftover ports) —
       shadow receptions are never read back: assembly gathers each slot
       from its designated round via ``K`` and overwrites the diagonal with
       the local chunk.

    Returns ``(rounds, K)``: ``rounds[i].perm`` is a total permutation of
    ``range(world)``; ``K`` is int32 [W, W] with ``K[s, d]`` = the round
    carrying pair (s, d) for s != d (diagonal entries are 0 and unused).
    The heavy prefix — and therefore the heaviest-first ordering — is
    preserved by steps 2-3 (they only touch free ports).
    """
    m = _as_matrix(matrix)
    if m.shape[0] != world:
        raise ValueError(
            f"traffic matrix is {m.shape[0]}x{m.shape[0]}, world is {world}"
        )
    base = decompose(m)
    perms = [list(r.perm) for r in base]
    loads = [r.load for r in base]
    k_mat = np.zeros((world, world), np.int32)
    covered = set()
    for i, r in enumerate(base):
        for s, d in enumerate(r.perm):
            if d >= 0:
                covered.add((s, d))
                k_mat[s, d] = i
    src_used = [set(s for s, d in enumerate(p) if d >= 0) for p in perms]
    dst_used = [set(d for d in p if d >= 0) for p in perms]
    missing = [
        (s, d) for s in range(world) for d in range(world)
        if s != d and (s, d) not in covered
    ]
    # hop-ordered fill packs the zero-load pairs into rotation-shaped
    # rounds (an empty matrix completes to exactly the W-1 rotations the
    # fixed streams would drive, not a ragged lexicographic packing)
    missing.sort(key=lambda sd: ((sd[1] - sd[0]) % world, sd[0]))
    for s, d in missing:
        for i in range(len(perms)):
            if s not in src_used[i] and d not in dst_used[i]:
                break
        else:
            i = len(perms)
            perms.append([-1] * world)
            loads.append(0.0)
            src_used.append(set())
            dst_used.append(set())
        perms[i][s] = d
        src_used[i].add(s)
        dst_used[i].add(d)
        k_mat[s, d] = i
    # pad holes to total permutations with shadow edges (not recorded in K)
    for i, p in enumerate(perms):
        free_src = [s for s in range(world) if s not in src_used[i]]
        free_dst = [d for d in range(world) if d not in dst_used[i]]
        self_loops = sorted(set(free_src) & set(free_dst))
        for s in self_loops:
            p[s] = s
            free_src.remove(s)
            free_dst.remove(s)
        # leftover ports are disjoint after self-loop extraction, so any
        # pairing is a valid (duplicate-pair) shadow edge
        for s, d in zip(free_src, free_dst):
            p[s] = d
    return [Round(tuple(p), l) for p, l in zip(perms, loads)], k_mat


def traffic_from_topk(topk_idx, num_experts: int, capacity: int,
                      world: int) -> np.ndarray:
    """Host-side [W, W] traffic matrix from per-member top-k routing.

    ``topk_idx``: [W, T, K] expert ids per source member. Mirrors the
    sorted-path drop semantics exactly (ops.sorted_from_topk): per (member,
    expert) demand is clipped at ``capacity`` — ``kept = min(count, C)`` —
    and expert ``e`` lives on member ``e // (E // W)``. Entry [s, d] is the
    number of routed rows member ``s`` sends to member ``d``'s experts
    (the diagonal counts local rows; :func:`decompose` ignores it).
    """
    idx = np.asarray(topk_idx)
    if idx.ndim != 3 or idx.shape[0] != world:
        raise ValueError(f"topk_idx must be [world, T, K], got {idx.shape}")
    if num_experts % world:
        raise ValueError(f"num_experts {num_experts} not divisible by world {world}")
    e_local = num_experts // world
    traffic = np.zeros((world, world), np.int64)
    for s in range(world):
        counts = np.bincount(idx[s].reshape(-1), minlength=num_experts)
        kept = np.minimum(counts[:num_experts], capacity)
        traffic[s] = kept.reshape(world, e_local).sum(axis=1)
    return traffic


def zipf_topk(rng: np.random.Generator, world: int, tokens: int, k: int,
              num_experts: int, alpha: float) -> np.ndarray:
    """Synthetic skewed routing for benches/tests: [W, T, K] expert ids with
    Zipf(alpha) expert popularity (alpha=0 → uniform). Every member draws
    from the same popularity law, so hot experts concentrate traffic on
    their owner members — the skewed-column pattern the scheduler exists
    for."""
    ranks = np.arange(1, num_experts + 1, dtype=np.float64)
    p = ranks ** (-float(alpha))
    p /= p.sum()
    return rng.choice(
        num_experts, size=(world, tokens, k), p=p
    ).astype(np.int32)


def record_decision(algo: str, world: int, n_rounds: Optional[int] = None,
                    matrix=None) -> None:
    """Land one a2a scheduling decision on the obs pair: the skew the
    planner saw (gauge) and the round count the chosen algo will drive
    (counter; the fixed streams count their W−1 implicit rotation rounds).
    The planner's algo choice itself goes on collective_plan_total via
    plan.CollectivePlanner.plan_ep_a2a — this records the schedule shape.
    """
    if matrix is not None:
        SKEW_GAUGE.set(skew(matrix))
    if n_rounds is None:
        n_rounds = max(0, world - 1)
    if n_rounds > 0:
        ROUNDS_TOTAL.inc(n_rounds, algo=algo)
