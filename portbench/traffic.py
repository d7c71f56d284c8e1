"""The one traffic generator: a pool of training batches from a mix's file.

A mix (``portbench/traffic/<name>.json``) gives:

- ``batch``, ``seq``: the shape of one step's tokens, ``[batch, seq]``;
- ``pool``: how many distinct batches are made; step ``i`` of a run takes
  batch ``i mod pool``.

Ids are drawn uniformly from the model's vocabulary. Targets are the next
token: each batch row is drawn ``seq + 1`` long and split. Everything is
drawn on the device from the run's seed, in one call, so the same seed gives
the same batches and every seed the same shapes.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from weights import stream_seed

KEYS = {"batch", "seq", "pool"}


def check(mix: Dict) -> None:
    if set(mix) != KEYS:
        raise ValueError(f"traffic mix keys {sorted(mix)}, want {sorted(KEYS)}")
    for key in KEYS:
        if not (isinstance(mix[key], int) and mix[key] >= 1):
            raise ValueError(f"traffic mix: {key} must be a whole number >= 1, got {mix[key]!r}")


def pool(mix: Dict, vocab: int, seed: int, device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``mix['pool']`` pairs of (tokens, targets), each ``[batch, seq]`` int64."""
    check(mix)
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, 1))
    shape = (mix["pool"], mix["batch"], mix["seq"] + 1)
    ids = torch.randint(0, vocab, shape, generator=g, device=device)
    return [(ids[i, :, :-1].contiguous(), ids[i, :, 1:].contiguous()) for i in range(shape[0])]
