"""Parameters drawn from the run's seed, on the device, in the program's layout.

A layout is a list of ``(path, shape, scale)``: ``path`` a tuple of keys into
the nested parameter dict, ``scale`` the standard deviation of a normal draw,
or ``None`` for a leaf of ones (a norm's gain). One generator on the device,
seeded once, draws the leaves in layout order, one call a leaf, so the same
seed gives the same tensors every time: the program and the reference get
the same weights, and a leaf can be drawn again later, one at a time, to
measure how far training moved it.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import torch

Layout = Sequence[Tuple[Tuple[str, ...], Tuple[int, ...], float]]

_GOLDEN = 0x9E3779B97F4A7C15


def stream_seed(seed: int, stream: int) -> int:
    """A 64-bit seed for one of the run's random streams (0: weights, 1:
    batches), so streams of nearby seeds do not coincide."""
    return (seed * _GOLDEN + stream * 0xBF58476D1CE4E5B9 + 1) % 2**64


def leaves(layout: Layout, seed: int, device) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    """Each ``(path, float32 tensor)`` of the layout, drawn in order."""
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, 0))
    for path, shape, scale in layout:
        if scale is None:
            yield path, torch.ones(shape, dtype=torch.float32, device=device)
        else:
            t = torch.randn(shape, generator=g, dtype=torch.float32, device=device)
            yield path, t.mul_(scale)


def tree(layout: Layout, seed: int, device) -> Dict:
    """The nested parameter dict of the layout."""
    out: Dict = {}
    for path, t in leaves(layout, seed, device):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return out


def get(tree_: Dict, path: Tuple[str, ...]) -> torch.Tensor:
    node = tree_
    for key in path:
        node = node[key]
    return node


def slices(path: Tuple[str, ...], t: torch.Tensor) -> List[Tuple[str, torch.Tensor]]:
    """The leaves a comparison counts: a leaf under ``blocks`` is stacked
    over the layers and counts as one leaf a layer."""
    name = ".".join(path)
    if path[0] == "blocks":
        return [(f"{name}.{i}", t[i]) for i in range(t.shape[0])]
    return [(name, t)]


def norms(layout: Layout, tree_: Dict, scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """Per counted leaf, the norm of the tree's tensor times ``scale``, as
    0-d device tensors (read them once, later)."""
    out = {}
    for path, _, _ in layout:
        for name, t in slices(path, get(tree_, path).detach()):
            out[name] = torch.linalg.vector_norm(t.float()) * scale
    return out


def change_norms(layout: Layout, tree_: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Per counted leaf, the norm of how far ``tree_`` has moved from the
    seed's initial weights, drawing those again one leaf at a time."""
    out = {}
    for path, t0 in leaves(layout, seed, device):
        t = get(tree_, path).detach()
        for (name, a), (_, b) in zip(slices(path, t), slices(path, t0)):
            out[name] = torch.linalg.vector_norm(a.float() - b)
        del t0
    return out
