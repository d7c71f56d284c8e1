"""Collective wrappers on member-stacked tensors.

Port of ``uccl_tpu/collective/ops.py``. The JAX wrappers run per shard
inside ``shard_map`` over a mesh axis; these take the member-stacked tensor
``[world, ...]`` (row r is member r's shard) and return the members'
results stacked the same way, so a per-shard result ``[k, ...]`` becomes
``[world, k, ...]``. They are plain torch, as their JAX twins are XLA
collectives.

Telemetry: every wrapper tallies itself on
``collective_traced_calls_total`` / ``collective_traced_bytes_total``
(labeled by op, bytes per member). The JAX wrappers count once per compiled
program; these run eagerly and count once per call.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from uccl_tpu_torch.obs import counters as _obsc

_CALLS = _obsc.counter(
    "collective_traced_calls_total",
    "collective ops traced into compiled programs, by op",
)
_BYTES = _obsc.counter(
    "collective_traced_bytes_total",
    "per-shard payload bytes of traced collective ops, by op",
)


def _tally(op: str, x: torch.Tensor) -> None:
    _CALLS.inc(op=op)
    _BYTES.inc(x[0].numel() * x.element_size(), op=op)


def _replicate(v: torch.Tensor, n: int) -> torch.Tensor:
    return v.unsqueeze(0).expand((n,) + tuple(v.shape)).clone()


def reduce_members(x: torch.Tensor, op: str) -> torch.Tensor:
    """The library reduction over the member dim, every member receiving
    the result: ``psum``/``pmax``/``pmin``/``pmean`` (and ``prod`` as the
    JAX Communicator's gather-then-prod)."""
    n = x.shape[0]
    if op == "sum":
        red = x.sum(0)
    elif op == "max":
        red = x.amax(0)
    elif op == "min":
        red = x.amin(0)
    elif op == "mean":
        red = x.sum(0) / n
    elif op == "prod":
        red = x.prod(0)
    else:
        raise ValueError(f"unsupported reduce op {op!r}")
    return _replicate(red.to(x.dtype), n)


def all_reduce(x: torch.Tensor, op: str = "sum", algo: str = "xla") -> torch.Tensor:
    """``algo="auto"`` routes a sum through the planner. As in the JAX
    package, only a forced ``UCCL_TPU_AR_ALGO`` names a kernel algo here;
    the members share one device, so ``pallas`` and ``bidir`` launch the
    ring kernels (B7, or its bidir pair) like the Communicator's verbs. A
    forced algo it cannot lower (``torus`` needs two mesh axes) runs xla,
    counted on ``ep_wire_fallback_total``. Any other op, or ``algo="xla"``,
    is the library reduction."""
    _tally("all_reduce", x)
    if op == "sum" and algo == "auto":
        from uccl_tpu_torch.collective import dma as _dma
        from uccl_tpu_torch.collective import plan as _plan
        from uccl_tpu_torch.collective import ring_ccl as _ring

        world = x.shape[0]
        planner = _plan.get_planner()
        shape = tuple(x.shape[1:]) or (1,)
        plan_ = planner.plan_all_reduce(shape, x.dtype, world, emit=False)
        lowerable = ("xla", "hd", "ring", "pallas", "bidir")
        exec_algo = plan_.algo if plan_.algo in lowerable else "xla"
        if exec_algo != plan_.algo:
            _dma.record_fallback(
                "ops_all_reduce", "no_lowering", detail=plan_.algo,
                msg=f"all_reduce cannot lower planned {plan_.algo!r}; running xla",
            )
        planner.plan_explicit(exec_algo, shape, x.dtype, world, outcome=plan_.outcome)
        if exec_algo == "pallas":
            return _ring.ring_all_reduce(x)
        if exec_algo == "bidir":
            return _ring.bidir_all_reduce(x)
        if exec_algo == "hd":
            return _plan.hd_all_reduce(x)
        if exec_algo == "ring":
            return _plan.ring_all_reduce(x)
        return reduce_members(x, "sum")
    if op in ("sum", "max", "min", "mean"):
        return reduce_members(x, op)
    raise ValueError(f"unsupported reduce op {op!r}")


def all_gather(x: torch.Tensor, *, dim: int = 0, tiled: bool = True) -> torch.Tensor:
    """Every member receives all members' shards, concatenated along the
    shard's ``dim`` (``tiled``) or stacked in a new leading dim."""
    _tally("all_gather", x)
    n = x.shape[0]
    g = torch.cat(list(x.unbind(0)), dim=dim) if tiled else x
    return _replicate(g, n)


def reduce_scatter(x: torch.Tensor, *, dim: int = 0) -> torch.Tensor:
    """Member r receives block r (along the shard's ``dim``) of the sum."""
    _tally("reduce_scatter", x)
    n = x.shape[0]
    return torch.stack(x.sum(0).chunk(n, dim=dim))


def all_to_all(x: torch.Tensor, *, split_dim: int, concat_dim: int,
               tiled: bool = True) -> torch.Tensor:
    """Member r splits its shard along ``split_dim`` into world blocks and
    sends block j to member j; what it receives from member j lands at
    block j along ``concat_dim``. Untiled (``lax.all_to_all(tiled=False)``):
    the shard's ``split_dim`` must have size world and is removed, and what
    member j sent lands at index j of a new dimension inserted at
    ``concat_dim``."""
    _tally("all_to_all", x)
    n = x.shape[0]
    if not tiled:
        nd = x.dim() - 1
        split_dim, concat_dim = split_dim % nd, concat_dim % nd
        if x.shape[1 + split_dim] != n:
            raise ValueError(f"all_to_all(tiled=False): split_dim {split_dim} has size "
                             f"{x.shape[1 + split_dim]}, not the world size {n}")
        return torch.stack([torch.stack([x[j].select(split_dim, i) for j in range(n)],
                                        dim=concat_dim) for i in range(n)])
    blocks = [m.chunk(n, dim=split_dim) for m in x.unbind(0)]
    return torch.stack([torch.cat([blocks[j][i] for j in range(n)], dim=concat_dim)
                        for i in range(n)])


def ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """out[dst] = x[src] for each (src, dst); members named as no dst
    receive zeros (``lax.ppermute`` semantics)."""
    _tally("ppermute", x)
    out = torch.zeros_like(x)
    for s, d in perm:
        out[d] = x[s]
    return out


def ring_shift(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """Rotate shards around the ring: member i's value goes to member i+shift."""
    _tally("ring_shift", x)
    return torch.roll(x, shifts=shift, dims=0)


def broadcast(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """Every member ends with the root member's value."""
    _tally("broadcast", x)
    return _replicate(x[root], x.shape[0])
