"""Ring topology helpers.

The reference's multipath "packet spraying" picks among 32 QP paths per flow
(reference: collective/rdma/transport_config.h:40 PORT_ENTROPY, transport.cc:2186
EventOnSelectPath). Its analog here is *ring selection*: which member
orderings a chunk-graph collective schedule rotates around, and how many
independent rings (one per direction) a collective can spray chunks across.

Pure-python; used by the chunk-graph planner (``collective/plan.py``) and
the Communicator.

Port copy of ``uccl_tpu/utils/topology.py`` (jax-free there too), kept so
the port never imports the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple


@dataclass(frozen=True)
class TorusAxis:
    """One axis of a (possibly multi-dim) torus of members."""

    name: str
    size: int


def ring_order(n: int, offset: int = 0, reverse: bool = False) -> List[int]:
    """Member ordering for a logical ring of n members.

    offset rotates the starting point; reverse flips direction. Two rings with
    reverse=False/True spray chunks over both directions simultaneously —
    the analog of UCCL's dual-direction path diversity.
    """
    order = [(i + offset) % n for i in range(n)]
    if reverse:
        order = [order[0]] + order[1:][::-1]
    return order


def ring_neighbors(rank: int, n: int, reverse: bool = False) -> Tuple[int, int]:
    """(prev, next) neighbors of `rank` on the ring."""
    step = -1 if reverse else 1
    return ((rank - step) % n, (rank + step) % n)


def ppermute_pairs(n: int, shift: int = 1) -> List[Tuple[int, int]]:
    """(src, dst) pairs of a ring rotation by shift (``lax.ppermute``'s form)."""
    return [(i, (i + shift) % n) for i in range(n)]


def bidirectional_rings(n: int) -> List[List[int]]:
    """The two directed rings of n members."""
    return [ring_order(n), ring_order(n, reverse=True)]


def factor_2d(n: int) -> Tuple[int, int]:
    """Factor n into the most-square (rows, cols) grid — used to lay a logical
    2-D torus over a flat member list when the physical topology is unknown."""
    best = (1, n)
    r = 1
    while r * r <= n:
        if n % r == 0:
            best = (r, n // r)
        r += 1
    return best


def bcast_tree_rounds(n: int, root: int = 0) -> List[List[Tuple[int, int]]]:
    """Binomial-tree broadcast schedule: per round, the (src, dst) member
    pairs (absolute indices on a ring of ``n`` rooted at ``root``). Round t
    doubles the holder set — members at virtual rank < 2^t forward to
    virtual rank + 2^t — so the whole tree is ceil(log2 n) rounds and every
    member sends at most log2(n) copies.

    THE one tree-edge arithmetic: the plain lowering
    (``collective.plan.tree_broadcast``) and the planner's tree cost
    features derive their schedule from this list, so they cannot drift."""
    rounds: List[List[Tuple[int, int]]] = []
    mask = 1
    while mask < n:
        rounds.append(
            [((v + root) % n, (v + mask + root) % n)
             for v in range(mask) if v + mask < n]
        )
        mask <<= 1
    return rounds


def recursive_halving_peers(rank: int, n: int) -> List[int]:
    """Peer schedule for recursive-halving/doubling collectives (n power of two)."""
    if n & (n - 1):
        raise ValueError(f"recursive halving needs power-of-two size, got {n}")
    peers = []
    d = n // 2
    while d >= 1:
        peers.append(rank ^ d)
        d //= 2
    return peers
