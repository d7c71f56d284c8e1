"""Reading a ``torch.profiler`` trace of the traced steps.

``kernel_class`` and ``union_us`` are copies of ``uccl_tpu_torch/
profile_step.py``'s ``kernel_class`` and ``_union_us``, kept here so that the
classes and the busy time a metric reads cannot move with the program.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch

Interval = Tuple[str, float, float]  # (name, start us, end us)

WINDOW_SPAN = "portbench.traced_steps"

_CLASSES = (
    ("flash", re.compile(r"flash_(fwd|bwd)")),
    ("gemm", re.compile(r"gemm|xmma|cutlass|sm90_|nvjet|cublas", re.I)),
    ("sort", re.compile(r"sort|radix", re.I)),
    ("index", re.compile(r"index|scatter|gather|embedding", re.I)),
    ("reduce", re.compile(r"reduce|softmax|norm|sum|mean|max", re.I)),
    ("copy", re.compile(r"copy|cast|memcpy|memset|cat", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized|unrolled|foreach", re.I)),
)


def kernel_class(name: str) -> str:
    for cls, pat in _CLASSES:
        if pat.search(name):
            return cls
    return "other"


def union_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


class Trace:
    """The device kernels and host ops of one traced window: the span
    :data:`WINDOW_SPAN` that the harness opens around the traced steps."""

    def __init__(self, kernels: List[Interval], host_ops: List[Interval],
                 window: Tuple[float, float]):
        self.window = window
        lo, hi = window
        self.kernels = [(n, max(s, lo), min(e, hi)) for n, s, e in kernels if e > lo and s < hi]
        self.host_ops = host_ops

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        kernels, host_ops, window = [], [], None
        for ev in prof.events():
            iv = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
            marker = (ev.is_user_annotation or ev.name == WINDOW_SPAN
                      or ev.name.startswith("ProfilerStep"))
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                if not marker:  # a span's shadow on the device is no kernel
                    kernels.append(iv)
            elif ev.name == WINDOW_SPAN:
                window = iv[1:]
            elif not marker:
                host_ops.append(iv)
        if window is None:
            raise RuntimeError(f"the trace has no {WINDOW_SPAN!r} span")
        return cls(kernels, host_ops, window)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    @property
    def busy_s(self) -> float:
        return union_us((s, e) for _, s, e in self.kernels) * 1e-6

    def seconds_in_classes(self, classes: Sequence[str]) -> float:
        """Device seconds in the kernels of the given classes."""
        return sum(e - s for n, s, e in self.kernels if kernel_class(n) in classes) * 1e-6

    def top_kernels(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, s, e in self.kernels:
            by[name] = by.get(name, 0.0) + (e - s) * 1e-6
        return [[k[:160], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The ``n`` longest stretches of the window in which no kernel ran,
        each named by the innermost host op open at its middle."""
        gaps, end = [], self.window[0]
        for _, s, e in sorted(self.kernels, key=lambda iv: iv[1]):
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.window[1] > end:
            gaps.append((end, self.window[1]))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        return [[self._host_at((a + b) / 2), (b - a) * 1e-6] for a, b in gaps]

    def _host_at(self, t: float) -> str:
        best: Optional[Interval] = None
        for iv in self.host_ops:
            if iv[1] <= t <= iv[2] and (best is None or iv[1] >= best[1]):
                best = iv
        return "host: " + (best[0][:120] if best else "python, no op open")
