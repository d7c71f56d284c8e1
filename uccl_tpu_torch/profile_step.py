"""Where the flagship train step's time goes on the card:
``python -m uccl_tpu_torch.profile_step``.

Trains the benchmark's base configuration (``flagship.bench_config``) for a
few warm-up steps, then runs ``--steps`` more under ``torch.profiler`` and
prints one JSON line: the step's wall time, the device's busy and idle
share of it (union of kernel intervals over the window), device time by
kernel class and by the top kernels and PyTorch ops that launched them.

Kernel classes come from kernel names: ``flash`` (this port's attention
kernels), ``gemm`` (cuBLAS/CUTLASS matrix products), ``elementwise``,
``reduce``, ``index`` (gathers, scatters, index_put), ``sort``, ``copy``
(casts and copies) and ``other``. Needs a GPU.

JAX counterpart: the TPU-side decomposition scripts of the JAX package
(``scripts/onchip_profile.py``).
"""

from __future__ import annotations

import argparse
import json
import re
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from uccl_tpu_torch import resolve_device
from uccl_tpu_torch.models import flagship
from uccl_tpu_torch.train import _batch_for_step

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


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m uccl_tpu_torch.profile_step")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--trace-out", default="", help="also write a Chrome trace here")
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    cfg = flagship.bench_config()
    params = flagship.init_params(cfg, torch.Generator().manual_seed(0), dev)
    train_step, init_opt = flagship.make_train_step(cfg, dev)
    opt_state = init_opt(params)
    batches = [_batch_for_step(i, args.batch, args.seq, cfg.vocab)
               for i in range(args.warmup + args.steps)]
    for tokens, targets in batches[:args.warmup]:
        params, opt_state, m = train_step(params, opt_state, tokens, targets)
    torch.cuda.synchronize(dev)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for tokens, targets in batches[args.warmup:]:
            params, opt_state, m = train_step(params, opt_state, tokens, targets)
        torch.cuda.synchronize(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    if args.trace_out:
        prof.export_chrome_trace(args.trace_out)

    kernels, by_class, by_name = [], defaultdict(float), defaultdict(float)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            s, e = ev.time_range.start, ev.time_range.end
            kernels.append((s, e))
            by_class[kernel_class(ev.name)] += e - s
            by_name[ev.name[:90]] += e - s
    if not kernels:
        raise RuntimeError("the profiler saw no device kernel; time with CUDA events instead")
    busy_us = _union_us(kernels)
    ops = sorted(
        ((e.key, e.self_device_time_total) for e in prof.key_averages()
         if e.self_device_time_total > 0 and e.device_type != torch.autograd.DeviceType.CUDA),
        key=lambda kv: -kv[1],
    )
    per = 1e-3 / args.steps  # us over all steps -> ms per step
    print(json.dumps({
        "bench": "profile_step", "device": torch.cuda.get_device_name(dev),
        "batch": args.batch, "seq": args.seq, "steps": args.steps,
        "step_ms": wall_us * per, "device_busy_ms": busy_us * per,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "kernels_per_step": len(kernels) / args.steps,
        "by_class_ms": {k: v * per for k, v in sorted(by_class.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms": {k: v * per for k, v in
                           sorted(by_name.items(), key=lambda kv: -kv[1])[:args.top]},
        "top_ops_self_device_ms": {k: v * per for k, v in ops[:args.top]},
        "final_loss": float(m["loss"]),
    }), flush=True)


if __name__ == "__main__":
    main()
