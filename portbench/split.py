"""A traced run of one cell whose kernels are also charged to the program's
layer spans (``spans.py``).

    python3 portbench/split.py --workload <cell> --seed <n> --seconds <s>

Runs ``run.py``'s ``main`` with ``--trace 1`` and, after its JSON line,
prints one more: ``split_ms``, the traced steps' device ms a step by bucket
(``spans.BUCKETS``); ``unlinked_ms``, the part of ``other`` that no host
op holds; ``kernel_ms``, their kernels' ms a step, which the buckets sum
to; ``busy_ms`` and ``traced_step_ms``, the union of those kernels and the
traced window, a step. It wraps ``tracekit.Trace.from_profiler`` in its own
process, so ``run.py`` and ``tracekit.py`` run as they are: a stopgap until
``Trace`` keeps the split itself and readers of ``BENCHMARK.json`` read it.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import run  # noqa: E402
import spans  # noqa: E402
import tracekit  # noqa: E402


def main(argv=None, **kwargs) -> int:
    """``run.main`` on ``argv`` with ``--trace 1``; ``kwargs`` go to it."""
    argv = list(sys.argv[1:] if argv is None else argv) + ["--trace", "1"]
    plain = tracekit.Trace.from_profiler.__func__
    kept = []

    def from_profiler(cls, prof):
        trace = plain(cls, prof)
        kept.append((trace, spans.split_us(prof.events(), trace.kernels)))
        return trace

    tracekit.Trace.from_profiler = classmethod(from_profiler)
    try:
        rc = run.main(argv, **kwargs)
    finally:
        tracekit.Trace.from_profiler = classmethod(plain)
    if rc != 0 or not kept:
        return rc
    trace, us = kept[-1]
    n = run.TRACE_STEPS
    print(json.dumps({
        "split_ms": {b: us[b] / 1e3 / n for b in spans.BUCKETS},
        "unlinked_ms": us["unlinked"] / 1e3 / n,
        "kernel_ms": sum(e - s for _, s, e in trace.kernels) / 1e3 / n,
        "busy_ms": trace.busy_s * 1e3 / n,
        "traced_step_ms": trace.window_s * 1e3 / n,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
