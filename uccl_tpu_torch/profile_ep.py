"""Where the EP layer's time goes on the card: ``python -m uccl_tpu_torch.profile_ep``.

The MoE layer of the benchmark's base configuration (``flagship.bench_config``:
dim 1024, 8 experts top-2, ffn 2816, bf16) at EP world 4 on one card, each
member one batch of 8 x 1024 tokens: layer 0's input and router logits from
the seed-0 weights, its experts sharded two per member. For each arm (the
stock wire, and the kernel wire at chunk depth 1, 2 and the planner's) it
prints one JSON line with host milliseconds (median of ``--reps`` warm
runs):

* ``verbs_ms``: ``Buffer.dispatch``, the SwiGLU expert GEMMs and
  ``Buffer.combine``, each followed by a host wait;
* ``layer_ms``: layout, dispatch, GEMMs and combine with one wait, at the
  end (each kernel-wire verb still reads its error words, a wait, at its
  own end); ``layer_async_ms`` the same with ``async_finish`` on both
  verbs, which leaves those reads to the events;
* ``enqueue_ms``: the part of ``layer_async_ms`` the host spends before
  its final wait, with no wait at all (equal to ``layer_async_ms`` when
  the host, not the card, is what the layer waits for);
* ``moe_ffn_ms``: ``ep.ops.moe_ffn`` at W = 4 on the same arm, one wait;
* ``device_busy_ms``: the union of the layer's kernel intervals in one
  ``torch.profiler`` pass, and the idle share of that pass's wall time;
* ``host_top_ms``: the ``TOP`` PyTorch ops by host (self CPU) time in a
  second pass that traces the host too, of the ``async_finish`` layer (the
  trace slows the host, so read its shares, not its sum).

Every run checks that the kernel wire's layer equals the stock wire's, bit
for bit. Runs on the card (``--device cpu`` runs the kernels' plain
versions, for tests at a small size). To time another checkout of the port
with the same code, run this file by path with that checkout first on
``PYTHONPATH``: it uses only ``Buffer``, ``moe_ffn`` and the flagship's
constructors.

JAX counterpart: none (``benchmarks/ep_bench.py`` times the JAX EP verbs).
"""

from __future__ import annotations

import sys

if __name__ == "__main__" and __package__ in (None, ""):
    # run by path: import the port from PYTHONPATH, not from beside this file
    sys.path.pop(0)

import argparse
import json
import statistics
import time

import torch
from torch.profiler import ProfilerActivity, profile

from uccl_tpu_torch import resolve_device
from uccl_tpu_torch.ep import Buffer
from uccl_tpu_torch.ep import ops as ep_ops
from uccl_tpu_torch.models import flagship
from uccl_tpu_torch.models.sampling import prng_key
from uccl_tpu_torch.models.layers import rms_norm
from uccl_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from uccl_tpu_torch.train import _batch_for_step

WORLD = 4
TOP = 12
ARMS = (("lax", dict()), ("pallas", dict(wire="pallas")),
        ("pallas n_chunks=2", dict(wire="pallas", n_chunks=2)),
        ("pallas n_chunks=0", dict(wire="pallas", n_chunks=0)))


def layer_inputs(dev, batch: int, seq: int):
    """Layer 0's MoE input [W, T, H] bf16 on each member's own batch, its
    router logits [W, T, E] f32 and the experts sharded [W, E_local, ...]."""
    cfg = flagship.bench_config()
    params = flagship.init_params(prng_key(0), cfg, dev)
    lp = {k: params["blocks"][k][0] for k in flagship._BLOCK_KEYS}
    xs = []
    with torch.no_grad():
        for r in range(WORLD):
            tokens = torch.as_tensor(_batch_for_step(200 + r, batch, seq, cfg.vocab)[0],
                                     device=dev)
            x = params["embed"][tokens.long()].to(cfg.dtype)
            one = (1,) * 4  # a one-member grid: flagship._attention's form
            x = x + flagship._attention(rms_norm(x, lp["ln1"], cfg.norm_eps).reshape(one + x.shape),
                                        {k: v.reshape(one + v.shape) for k, v in lp.items()},
                                        cfg).reshape(x.shape)
            xs.append(rms_norm(x, lp["ln2"], cfg.norm_eps).reshape(-1, cfg.dim))
    x = torch.stack(xs)
    logits = x.float() @ lp["router"]
    e_local = cfg.moe_experts // WORLD
    experts = [lp[k].to(cfg.dtype).reshape(WORLD, e_local, *lp[k].shape[1:]).contiguous()
               for k in ("we_gate", "we_up", "we_down")]
    return cfg, x, logits, experts


def union_ms(spans) -> float:
    """Milliseconds covered by the union of ``(start, end)`` spans in µs."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m uccl_tpu_torch.profile_ep")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    activity = ProfilerActivity.CUDA if dev.type == "cuda" else ProfilerActivity.CPU
    cfg, x, logits, (wg, wu, wd) = layer_inputs(dev, args.batch, args.seq)
    mesh = make_mesh(MeshConfig(dp=WORLD), device=dev.type)
    vals, idx = ep_ops._per_member(ep_ops._gate_topk, logits, cfg.moe_topk, True)[:2]
    combine_cfg = Buffer.get_combine_config(WORLD)
    kw = dict(num_selected=cfg.moe_topk, capacity_factor=cfg.capacity_factor)
    ref = None
    for name, bkw in ARMS:
        buf = Buffer(mesh, "dp", num_experts=cfg.moe_experts, num_selected=cfg.moe_topk,
                     capacity_factor=cfg.capacity_factor, **bkw)

        def verbs():
            marks = [time.perf_counter()]
            recv, handle = buf.dispatch(x, idx, vals)
            sync()
            marks.append(time.perf_counter())
            ye = ep_ops._member_gemms(recv, wg, wu, wd)
            sync()
            marks.append(time.perf_counter())
            buf.combine(ye, handle, config=combine_cfg)
            sync()
            marks.append(time.perf_counter())
            return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]

        def layer(async_finish=False):
            sync()
            t0 = time.perf_counter()
            buf.get_dispatch_layout(idx)
            if async_finish:
                recv, handle, ev = buf.dispatch(x, idx, vals, async_finish=True)
                ev.current_stream_wait()
                out, ev2 = buf.combine(ep_ops._member_gemms(recv, wg, wu, wd), handle,
                                       config=combine_cfg, async_finish=True)
                t1 = time.perf_counter()
                ev2.synchronize()
                ev.synchronize()
            else:
                recv, handle = buf.dispatch(x, idx, vals)
                out = buf.combine(ep_ops._member_gemms(recv, wg, wu, wd), handle,
                                  config=combine_cfg)
                t1 = time.perf_counter()
            sync()
            return out, (t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3

        def moe_ffn():
            sync()
            t0 = time.perf_counter()
            ep_ops.moe_ffn(x, logits, wg, wu, wd, "dp", wire=bkw.get("wire", "lax"),
                           n_chunks=bkw.get("n_chunks", 1), **kw)
            sync()
            return (time.perf_counter() - t0) * 1e3

        out = layer()[0]  # warm-up
        moe_ffn()
        if ref is None:
            ref = out
        elif not torch.equal(out, ref):
            raise RuntimeError(f"arm {name}: the layer differs from the stock wire's")
        timed = [verbs() for _ in range(args.reps)]
        runs = [layer()[2] for _ in range(args.reps)]
        async_runs = [layer(True) for _ in range(args.reps)]
        moe = [moe_ffn() for _ in range(args.reps)]
        with profile(activities=[activity]) as prof:
            t0 = time.perf_counter()
            layer()
            wall = (time.perf_counter() - t0) * 1e3
        spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]  # none on the CPU
        busy = union_ms(spans)
        with profile(activities=sorted({ProfilerActivity.CPU, activity}, key=str)) as host_prof:
            layer(True)
        host_top = sorted(((e.key, e.self_cpu_time_total / 1e3)
                           for e in host_prof.key_averages()
                           if not getattr(e, "is_user_annotation", False)),  # the ep.* spans
                          key=lambda kv: -kv[1])
        print(json.dumps({
            "bench": "profile_ep", "arm": name,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "world": WORLD, "tokens_per_member": args.batch * args.seq,
            "verbs_ms": dict(zip(("dispatch", "expert_gemms", "combine"),
                                 [statistics.median(c) for c in zip(*timed)])),
            "layer_ms": statistics.median(runs),
            "enqueue_ms": statistics.median(r[1] for r in async_runs),
            "layer_async_ms": statistics.median(r[2] for r in async_runs),
            "moe_ffn_ms": statistics.median(moe),
            "device_busy_ms": busy, "profiled_wall_ms": wall,
            "device_idle_share": 1.0 - busy / wall if wall else None,
            "host_top_ms": dict(host_top[:TOP]),
        }), flush=True)


if __name__ == "__main__":
    main()
