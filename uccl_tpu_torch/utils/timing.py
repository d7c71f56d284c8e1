"""Chained timing harnesses, shared by probe scripts and benchmarks.

Port of ``uccl_tpu/utils/timing.py``, with the same functions, signatures and
returns. The JAX harness chains each iteration to a carry inside one jitted
``fori_loop`` so that XLA cannot hoist a loop-invariant body out of the loop,
and consumes outputs with full reductions so that it cannot narrow them away.
Eager PyTorch hoists and prunes nothing, but the carry chaining is kept: it
is the contract the probes are written against, and it keeps every
iteration's inputs data-dependent on the last one's outputs, as a real loop's
are.

Time is taken by a host read of the carry at the end of the timed run (the
read waits for every queued launch) and, on the card, by CUDA events around
the run:

  chained_timeit — per-iteration time of fn(a0, *rest, c) -> carry; use for
    ms-scale probes where one run's fixed cost (launch queue fill, the final
    read) amortizes away.
  slope_timeit — per-op = (t(base+n) - t(base)) / n over a pytree of args;
    the differencing cancels the fixed launch and host-read overhead of a
    run exactly, which µs-scale ops need.
"""

from __future__ import annotations

import time

import torch
from torch.utils import _pytree as pytree


def perturb(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Couple tensor `a` to the carry so each iteration depends on the last.
    Float: + c*1e-12 (negligible). Int: + min(|c|, 0) cast — zero for any
    carry value, negative included, yet data-dependent, so values are
    bit-unchanged."""
    if a.is_floating_point():
        return a + (c * 1e-12).to(a.dtype)
    return a + torch.clamp(c.abs(), max=0.0).to(a.dtype)


def _timed(run, device: torch.device) -> float:
    """Seconds of ``run()``, which returns the carry: CUDA events around it
    for a carry on the card, the host clock otherwise, each ending in a host
    read of the carry."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        c = run()
        end.record()
        float(c)
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    float(run())
    return time.perf_counter() - t0


def chained_timeit(name, fn, *args, iters=10, flops=None, width=34):
    """Time fn over `iters` chained iterations in ONE run.
    fn(a0, *rest, c) -> new carry scalar; a0 is perturbed by the carry.
    Returns seconds per iteration; prints `name`, ms, and TF/s if `flops`
    (per-iteration FLOPs) is given."""
    def run(n, c):
        for _ in range(n):
            c = fn(perturb(args[0], c), *args[1:], c)
        return c

    c0 = torch.zeros((), dtype=torch.float32, device=args[0].device)
    t0 = time.perf_counter()
    float(run(2, c0))  # warm: first use builds and allocates
    tw = time.perf_counter() - t0
    dt = _timed(lambda: run(iters, c0), c0.device) / iters
    tf = f"  {flops / dt / 1e12:6.1f} TF/s" if flops else ""
    print(f"{name:{width}s} {dt * 1e3:8.3f} ms{tf}  (warm-up {tw:.1f}s)",
          flush=True)
    return dt


def slope_timeit(fn, args, iters, signal_floor=0.02, n_cap=20000):
    """Per-op seconds for fn(*args) via the SLOPE of two chained runs:
    (t(base+n) - t(base)) / n, median of 3 pairs. The first tensor leaf of
    `args` (float or int — see perturb) is carry-coupled each iteration;
    every output leaf is consumed by a full reduction. n escalates ×10
    until the differenced signal (slope × n) clears `signal_floor` seconds
    or n reaches `n_cap` — µs-scale ops need thousands of chained
    iterations to rise above run-to-run jitter."""
    flat, spec = pytree.tree_flatten(tuple(args))
    pi = next((i for i, leaf in enumerate(flat) if isinstance(leaf, torch.Tensor)), None)
    dev = flat[pi].device if pi is not None else torch.device("cpu")
    c0 = torch.zeros((), dtype=torch.float32, device=dev)

    def run(n):
        c = c0
        for _ in range(n):
            leaves = list(flat)
            if pi is not None:
                leaves[pi] = perturb(leaves[pi], c)
            out = fn(*pytree.tree_unflatten(leaves, spec))
            s = sum(leaf.float().sum() for leaf in pytree.tree_leaves(out)
                    if isinstance(leaf, torch.Tensor))
            c = c + s * 1e-9
        return c

    float(run(2))  # warm, host-scalar sync

    base, n = 3, max(1, iters)
    while True:
        slopes = sorted(
            (_timed(lambda: run(base + n), dev) - _timed(lambda: run(base), dev)) / n
            for _ in range(3)
        )
        if slopes[1] * n > signal_floor or n >= n_cap:
            break
        n = min(n * 10, n_cap)
    return max(slopes[1], 1e-9)  # clamp: noise can make a tiny op negative
