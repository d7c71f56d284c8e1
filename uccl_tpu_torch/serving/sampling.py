"""Per-request sampling policy for the serving engine.

Port copy of ``uccl_tpu/serving/sampling.py`` (numpy, as there):
:class:`SamplingParams` is the request-side knob set (temperature, top-p /
top-k truncation, a seed); the math lives in
:mod:`uccl_tpu_torch.models.sampling`, whose keys are JAX's threefry keys
bit for bit. This module owns the policy object, its validation, and the
host-side per-slot arrays the engine ships to the slot primitives.

Determinism contract: a request's sample at output position ``i`` depends
only on (seed, i, the logits row): ``fold_in(PRNGKey(seed), i)`` is the
key, whatever path produced the row. The engine's tokens equal the sampled
one-shot ``generate`` oracle's at equal seeds.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# re-exported: the one sampling definition both stacks and the oracles use
from uccl_tpu_torch.models.sampling import (  # noqa: F401
    broadcast_params, fold_key, sample_tokens, sample_window,
)


@dataclass(frozen=True)
class SamplingParams:
    """One request's sampling policy.

    ``temperature <= 0`` means greedy (the per-row rule the compiled
    sampler applies, so mixed greedy/sampled batches share one program);
    ``top_k <= 0`` disables top-k; ``top_p >= 1`` disables nucleus
    truncation. ``seed`` is the request's whole entropy source.
    """

    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    seed: int = 0

    def __post_init__(self):
        if not np.isfinite(self.temperature):
            raise ValueError(f"temperature must be finite, got "
                             f"{self.temperature}")
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not (-(2 ** 31) <= int(self.seed) < 2 ** 31):
            raise ValueError(f"seed must fit int32, got {self.seed}")


#: the arrays a slot batch feeds the sampled primitives, in order
FIELDS = ("seeds", "pos0", "temp", "top_p", "top_k")


def slot_arrays(n_slots: int):
    """Fresh host-side per-slot sampling arrays, all greedy (temp=0) —
    the engine mutates rows at admit/retire and ships copies per call."""
    return {
        "seeds": np.zeros(n_slots, np.int32),
        "pos0": np.zeros(n_slots, np.int32),
        "temp": np.zeros(n_slots, np.float32),
        "top_p": np.ones(n_slots, np.float32),
        "top_k": np.zeros(n_slots, np.int32),
    }


def stamp_slot(arrays, slot: int, params: "SamplingParams | None") -> None:
    """Write one request's params into its slot row (None → greedy row)."""
    if params is None:
        arrays["seeds"][slot] = 0
        arrays["temp"][slot] = 0.0
        arrays["top_p"][slot] = 1.0
        arrays["top_k"][slot] = 0
    else:
        arrays["seeds"][slot] = np.int32(int(params.seed))
        arrays["temp"][slot] = np.float32(params.temperature)
        arrays["top_p"][slot] = np.float32(params.top_p)
        arrays["top_k"][slot] = np.int32(params.top_k)


def pack(arrays, pos0) -> tuple:
    """The positional tuple the backends accept: (seeds, pos0, temp,
    top_p, top_k), with ``pos0`` supplied per call (each slot's output
    index for the first token this call emits)."""
    return (arrays["seeds"].copy(), np.asarray(pos0, np.int32),
            arrays["temp"].copy(), arrays["top_p"].copy(),
            arrays["top_k"].copy())
