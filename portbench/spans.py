"""Charging each kernel of a ``torch.profiler`` trace to the program's layer
span above it.

While a capture runs, the program opens a ``record_function`` range for each
of its layer spans (``uccl_tpu_torch.obs.span``). A kernel's device time goes
to exactly one bucket of :data:`BUCKETS`:

1. the host op that launched it holds it in its ``kernels`` (the profiler
   links the two by correlation id);
2. up that op's ``cpu_parent`` chain, the innermost span named in
   :data:`SPANS` gives the bucket;
3. a backward node met first (``autograd::engine::evaluate_function: X``)
   stands for the forward op that created it, found by the node's
   (``fwd_thread``, ``sequence_nr``), and the chain goes on from that op.

A kernel with no launching op, or under no named span, goes to ``other``. A
remat recompute re-enters the spans of the block it re-runs, so its kernels
are charged to them directly. The names live here, so that the yardstick
does not move with the program.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

# span name -> bucket; flagship.block holds a block's residual adds, ln2 and
# aux sum, and stops a recompute's unnamed work from reaching the backward
# node that triggered it
SPANS = {
    "flagship.embed": "embed",
    "flagship.attention": "attention",
    "moe.route": "route",
    "moe.dispatch": "dispatch",
    "moe.experts": "expert",
    "moe.combine": "combine",
    "flagship.head": "head",
    "flagship.stack_slice": "stack_grad",
    "adamw": "adamw",
    "flagship.block": "other",
}
BUCKETS = ("embed", "attention", "route", "dispatch", "expert", "combine", "head",
           "stack_grad", "adamw", "other")
BACKWARD = "autograd::engine::evaluate_function: "


class Attribution:
    """The forward op that created each autograd node, to follow a backward
    node to the span its forward ran under."""

    def __init__(self, events):
        self.created: Dict[Tuple[int, int], object] = {}
        in_backward: Dict[int, bool] = {}
        for ev in events:
            if (ev.device_type != torch.autograd.DeviceType.CPU or ev.sequence_nr < 0
                    or self._in_backward(ev, in_backward)):
                continue
            # ops that peek one sequence number nest in or precede the one
            # that creates its node, which starts last
            key = (ev.thread, ev.sequence_nr)
            prev = self.created.get(key)
            if prev is None or ev.time_range.start >= prev.time_range.start:
                self.created[key] = ev

    @staticmethod
    def _in_backward(ev, memo: Dict[int, bool]) -> bool:
        chain, found = [], False
        while ev is not None:
            known = memo.get(id(ev))
            if known is not None:
                found = known
                break
            chain.append(ev)
            if ev.name.startswith(BACKWARD):
                found = True
                break
            ev = ev.cpu_parent
        for e in chain:
            memo[id(e)] = found
        return found

    def span(self, op) -> Optional[str]:
        """The innermost span of :data:`SPANS` above a host op, through the
        forward op of each backward node met on the way; None if none."""
        ev = op
        while ev is not None:
            name = ev.name
            if name in SPANS:
                return name
            if name.startswith(BACKWARD):
                ev = self.created.get((ev.fwd_thread, ev.sequence_nr))
                continue
            ev = ev.cpu_parent
        return None

    def bucket(self, op) -> str:
        """The bucket of a host op (what its kernels are charged to)."""
        return SPANS.get(self.span(op), "other")


def split_us(events, kernels) -> Dict[str, float]:
    """Device microseconds of each bucket, and ``unlinked``. The buckets sum
    to the time of ``kernels``, a ``tracekit.Trace``'s (clipped to its
    window): ``other`` takes the kernels under no named span, and the rest of
    that time, which no host op of ``events`` holds; ``unlinked`` is that
    rest alone, so a small one shows the ops' kernels add up to the trace's."""
    events = list(events)
    att = Attribution(events)
    out = dict.fromkeys(BUCKETS, 0.0)
    for ev in events:
        if ev.device_type == torch.autograd.DeviceType.CPU and ev.kernels:
            # a span's own shadow on the device is no kernel
            shadow = ev.name if ev.is_user_annotation else None
            out[att.bucket(ev)] += sum(k.duration for k in ev.kernels if k.name != shadow)
    unlinked = sum(e - s for _, s, e in kernels) - sum(out.values())
    out["other"] += unlinked
    out["unlinked"] = unlinked
    return out
