"""Partition specs over the member grid, and the collectives on its dims.

Port of ``uccl_tpu/parallel/sharding.py``. There a ``PartitionSpec`` tells
XLA how an array is laid over a device mesh, and ``shard_map`` hands each
device its shard. Here every member of a :class:`~.mesh.Mesh` lives on one
device, so the shards of all members are one **member-grid** tensor: its
leading dims are the mesh axes ``[pp, dp, cp, tp]`` (``AXIS.ALL``'s order,
all four, size 1 where the axis is), the rest is one member's shard. Entry
``[i, j, k, l]`` is what member (pp=i, dp=j, cp=k, tp=l) holds inside the
JAX ``shard_map``.

* :func:`put` is ``in_specs``: the grid view of a global tensor (a reshape,
  a permute and an ``expand`` over the axes the spec does not name, so no
  copy is made and autograd sums a replicated leaf's gradient over its
  replicas, as ``shard_map``'s transpose does).
* :func:`gather` is ``out_specs``: the global tensor from a grid one
  (shards concatenated along the named axes, replica 0 of the others).
* :func:`to_front` / :func:`from_front` move a named axis (or a tuple of
  them, flattened) to dim 0 and back, so the member-stacked verbs of
  ``collective/ops`` apply (the ring's ``ppermute``, Ulysses'
  all-to-alls and the vocab-parallel loss's ``pmax`` take the axis there);
  :func:`psum` and :func:`pmean` are ``all_reduce`` on a grid dim (the
  identity over an axis of size 1, as in JAX), :func:`axis_index` is
  ``lax.axis_index``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Optional, Sequence, Tuple, Union

import torch

from uccl_tpu_torch.collective import ops as cops
from uccl_tpu_torch.parallel.mesh import AXIS, Mesh

Axes = Union[str, Tuple[str, ...]]
GRID_DIMS = len(AXIS.ALL)  # the leading dims of a member-grid tensor


class PartitionSpec(tuple):
    """One entry per leading dim of a global tensor: ``None`` (not
    sharded), an axis name, or a tuple of axis names (sharded over their
    product, the first outermost), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""

    mesh: Mesh
    spec: PartitionSpec


def spec(*axes) -> PartitionSpec:
    """PartitionSpec from axis names (None entries = replicated dims)."""
    return PartitionSpec(*axes)


def named(mesh: Mesh, pspec: PartitionSpec) -> NamedSharding:
    return NamedSharding(mesh, pspec)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


# Canonical activation layout: [batch, seq, hidden] with batch over dp, seq
# over cp (context parallel), hidden replicated (tp shards weights).
def activation_spec(seq_sharded: bool = True) -> PartitionSpec:
    return P(AXIS.DP, AXIS.CP if seq_sharded else None, None)


def batch_spec() -> PartitionSpec:
    return P(AXIS.DP, None, None)


def constrain(x: Any, pspec: PartitionSpec) -> Any:
    """``with_sharding_constraint``: the identity. A grid tensor's layout is
    its shape, so there is nothing for a compiler to be told."""
    return x


def _axes_of(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    if isinstance(part, str):
        return (part,)
    return tuple(part)


def _check_axes(axes: Sequence[str]) -> None:
    for a in axes:
        if a not in AXIS.ALL:
            raise ValueError(f"unknown mesh axis {a!r} (want one of {AXIS.ALL})")


def put(mesh: Mesh, x: torch.Tensor, pspec: Optional[PartitionSpec] = None) -> torch.Tensor:
    """The member-grid view ``[pp, dp, cp, tp, *shard]`` of global ``x``
    laid out by ``pspec`` (default: replicated). A view where ``x`` is
    contiguous; differentiable."""
    pspec = P() if pspec is None else pspec
    if len(pspec) > x.dim():
        raise ValueError(f"spec {pspec} has more entries than x has dims {tuple(x.shape)}")
    sizes = mesh.shape
    shape, pos = [], {}
    for i, n in enumerate(x.shape):
        part = _axes_of(pspec[i]) if i < len(pspec) else ()
        _check_axes(part)
        k = math.prod(sizes[a] for a in part)
        if n % k:
            raise ValueError(f"dim {i} of {tuple(x.shape)} ({n}) does not divide over "
                             f"{part} ({k} members)")
        for a in part:
            if a in pos:
                raise ValueError(f"spec {pspec} names axis {a!r} twice")
            pos[a] = len(shape)
            shape.append(sizes[a])
        shape.append(n // k)
    if all(sizes[a] == 1 for a in AXIS.ALL):  # one member: its shard is x
        return x.reshape((1,) * GRID_DIMS + tuple(x.shape))
    for a in AXIS.ALL:
        if a not in pos:
            pos[a] = len(shape)
            shape.append(1)
    grid = [pos[a] for a in AXIS.ALL]
    y = x.reshape(shape).permute(grid + [d for d in range(len(shape)) if d not in grid])
    return y.expand(tuple(sizes[a] for a in AXIS.ALL) + tuple(y.shape[GRID_DIMS:]))


def gather(mesh: Mesh, g: torch.Tensor, pspec: Optional[PartitionSpec] = None) -> torch.Tensor:
    """The global tensor of grid tensor ``g`` laid out by ``pspec``: the
    shards concatenated along the axes the spec names, replica 0 taken on
    the others (what ``out_specs`` does)."""
    pspec = P() if pspec is None else pspec
    used = {a for part in pspec for a in _axes_of(part)}
    y = g[tuple(slice(None) if a in used else slice(0, 1) for a in AXIS.ALL)]
    perm = [AXIS.ALL.index(a) for a in AXIS.ALL if a not in used]
    shape = []
    for i, n in enumerate(g.shape[GRID_DIMS:]):
        part = _axes_of(pspec[i]) if i < len(pspec) else ()
        perm += [AXIS.ALL.index(a) for a in part] + [GRID_DIMS + i]
        shape.append(n * math.prod(mesh.shape[a] for a in part))
    return y.permute(perm).reshape(shape)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest`` alike in structure)."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def put_tree(mesh: Mesh, tree, specs):
    return tree_map(lambda x, s: put(mesh, x, s), tree, specs)


def gather_tree(mesh: Mesh, tree, specs):
    return tree_map(lambda g, s: gather(mesh, g, s), tree, specs)


# ---------------------------------------------------------------------------
# Named axes of a grid tensor


def _dims(axes: Axes) -> Tuple[int, ...]:
    axes = _axes_of(axes)
    _check_axes(axes)
    return tuple(AXIS.ALL.index(a) for a in axes)


def axis_size(g: torch.Tensor, axes: Axes) -> int:
    """``lax.axis_size``: read off the grid dims of ``g``."""
    return math.prod(g.shape[d] for d in _dims(axes))


def to_front(g: torch.Tensor, axes: Axes) -> torch.Tensor:
    """Grid ``g`` with the named axis (a tuple: flattened, the first
    outermost) as dim 0 ``[n, *other grid dims, *shard]``: the member-stacked
    form ``collective/ops`` takes."""
    dims = _dims(axes)
    y = g.movedim(dims, tuple(range(len(dims))))
    return y.reshape((-1,) + tuple(y.shape[len(dims):]))


def from_front(x: torch.Tensor, g_shape: Sequence[int], axes: Axes) -> torch.Tensor:
    """Inverse of :func:`to_front`: ``g_shape`` is the grid tensor's shape
    (its grid dims are what matter)."""
    dims = _dims(axes)
    y = x.reshape(tuple(g_shape[d] for d in dims) + tuple(x.shape[1:]))
    return y.movedim(tuple(range(len(dims))), dims)


def _verb(g: torch.Tensor, axes: Axes, fn: Callable) -> torch.Tensor:
    if axis_size(g, axes) == 1:
        return g
    out = fn(to_front(g, axes))
    return from_front(out, g.shape, axes)


def psum(g: torch.Tensor, axes: Axes) -> torch.Tensor:
    return _verb(g, axes, lambda x: cops.all_reduce(x, "sum"))


def pmean(g: torch.Tensor, axes: Axes) -> torch.Tensor:
    return _verb(g, axes, lambda x: cops.all_reduce(x, "mean"))


def axis_index(g: torch.Tensor, axis: str, n_shard_dims: int = 0) -> torch.Tensor:
    """``lax.axis_index``: each member's index along ``axis``, shaped to
    broadcast against a grid tensor with ``n_shard_dims`` shard dims."""
    (d,) = _dims(axis)
    shape = [1] * (GRID_DIMS + n_shard_dims)
    shape[d] = g.shape[d]
    return torch.arange(g.shape[d], device=g.device).reshape(shape)


def members(g: torch.Tensor) -> int:
    """How many members the grid tensor ``g`` holds."""
    return math.prod(g.shape[:GRID_DIMS])


def member0(g: torch.Tensor) -> torch.Tensor:
    """Member 0's shard of grid ``g`` (a result every member holds alike): a
    view, whose backward at one member is a view too."""
    shard = tuple(g.shape[GRID_DIMS:])
    return g.reshape(shard) if members(g) == 1 else g.reshape((-1,) + shard)[0]
