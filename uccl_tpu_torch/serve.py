"""Serving entry: ``python -m uccl_tpu_torch.serve``.

Port of ``uccl_tpu/serve.py``. It generates through
:class:`uccl_tpu_torch.models.moe_inference.MoEServer`: EP-sharded KV-cache
prefill (sorted throughput path) and decode (packed low-latency path, the
DeepEP LL regime), on ``cuda`` unless ``--device cpu`` is given. Params
initialise from ``--seed``; prompts are synthetic token ids (no tokenizer
in scope). ``--devices N`` / ``--dp W`` serve over W members of an EP world
that all live on the one device (the port's member-stacked convention), so

    python -m uccl_tpu_torch.serve --dp 4 --batch 8 --prompt-len 8 --new-tokens 16

runs the one-shot fixed batch at EP world 4 and prints its TTFT and
decode-step windows. ``--server`` switches to the continuous-batching
engine (``uccl_tpu_torch/serving``): a synthetic Poisson arrival stream of
mixed-length prompts flows through the scheduler into a fixed KV slot
pool, requests join and leave mid-decode, and the summary reports TTFT /
TPOT percentiles, goodput and slot occupancy. ``--check-oracle``
additionally holds every completed request, token for token, to its own
run alone on the engine's slot programs (``serving.replay_alone``: the
same shapes, every other slot idle), and checks that no slot leaked:

    python -m uccl_tpu_torch.serve --server --dp 4 --slots 8 --requests 12 \\
        --prompt-len 16 --new-tokens 8 --arrival-rate 50 --check-oracle

The JAX package's oracle is the one-shot ``generate`` (for the MoE stack at
world 1). On a GPU that oracle runs other GEMM and reduction shapes than the
engine's batch, whose kernels sum in another order, so a near-tie can fall
the other way there; the port's tests hold the engine to ``generate`` on the
CPU, where it is exact, and the replay holds it on any device.

Not ported yet, and refused if passed: ``--ckpt-dir`` (the port's trainer
writes no checkpoints yet, ROADMAP queue A item 6), and the engine knobs of
later serving modules (``--prefill-chunk``, ``--step-tokens``,
``--spec-k``, ``--replicas`` above 1, ``--adapter-rank``), each named with
its ROADMAP item. The EP wire is ``MoEServeConfig.moe_wire`` (``lax`` by
default); the JAX CLI has no flag for it, so neither has this one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from uccl_tpu_torch import obs, resolve_device
from uccl_tpu_torch.serving.metrics import percentile, percentiles_ms

_UNPORTED_SERVER_FLAGS = (
    # (flag, attribute, ROADMAP queue A item, module)
    ("--prefill-chunk", "prefill_chunk", "10g", "chunked prefill"),
    ("--step-tokens", "step_tokens", "10g", "chunked prefill"),
    ("--spec-k", "spec_k", "10a", "serving/spec.py"),
    ("--adapter-rank", "adapter_rank", "10c", "serving/adapters.py"),
)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_windows(run_full, run_one, batch, new_tokens, reps, device):
    """Measure the one-shot serving windows ``reps`` times; returns (last
    full-window output, last full-window seconds, extra summary).

    The 1-token window is the TTFT window (prompt -> first token), and the
    per-rep delta (full - one)/(N-1) is the decode-step window: prefill and
    the fixed dispatch cost cancel in the delta. ``run_one`` is None when
    N == 1 (the full window then doubles as the TTFT window). Each window
    ends with a device sync, so it covers the device work."""
    ttft, steps, fulls = [], [], []
    out = None
    for _ in range(max(1, reps)):
        if run_one is not None:
            t0 = time.perf_counter()
            with obs.span("serve.ttft_window", track="serve"):
                run_one()
                _sync(device)
            ttft.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        with obs.span("serve.full_window", track="serve", new_tokens=new_tokens):
            out = run_full()
            _sync(device)
        fulls.append(time.perf_counter() - t0)
        if run_one is not None and fulls[-1] > ttft[-1]:
            steps.append((fulls[-1] - ttft[-1]) / (new_tokens - 1))
    if run_one is None:
        ttft = list(fulls)
    extra = {"ttft_ms": percentiles_ms(ttft)}
    if steps:
        extra["decode_step_ms"] = percentiles_ms(steps)
        med_one, med_full = percentile(ttft, 50), percentile(fulls, 50)
        if med_full > med_one:
            extra["decode_tokens_per_sec"] = round(
                batch * (new_tokens - 1) / (med_full - med_one), 1)
    return out, fulls[-1], extra


def _world(args) -> int:
    """The EP world: ``--dp``, else ``--devices``, else 1; all its members
    live on the one device."""
    n = args.devices or max(1, args.dp)
    world = args.dp or n
    if world > n:
        raise SystemExit(f"--dp {world} exceeds the {n} members of --devices")
    return world


def moe_config(args, **fields):
    """The MoE stack's config from the CLI widths; ``fields`` set the
    ``MoEServeConfig`` fields the CLI has no flag for (``moe_wire``,
    ``moe_chunks``)."""
    from uccl_tpu_torch.models.moe_inference import MoEServeConfig

    return MoEServeConfig(
        vocab=args.vocab, dim=args.dim, n_layers=args.layers, n_heads=args.heads,
        n_kv_heads=args.kv_heads, head_dim=args.dim // args.heads, moe_experts=args.experts,
        moe_ffn=args.ffn, **fields)


def dense_config(args):
    from uccl_tpu_torch.models.dense import DenseConfig

    return DenseConfig(
        vocab=args.vocab, dim=args.dim, n_layers=args.layers, n_heads=args.heads,
        n_kv_heads=args.kv_heads, head_dim=args.dim // args.heads, ffn=args.ffn)


def _generator(args) -> torch.Generator:
    return torch.Generator().manual_seed(args.seed)


def build_stack(args, device, **fields):
    """The serving backend ``--stack`` names, as ``serve --server`` builds it:
    returns (backend, world, vocab). ``fields`` go to :func:`moe_config`."""
    from uccl_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from uccl_tpu_torch.serving.engine import DenseBackend, MoEBackend

    max_seq = args.max_seq or (args.prompt_len + args.new_tokens)
    if args.stack == "dense":
        from uccl_tpu_torch.models.dense import init_params

        cfg = dense_config(args)
        backend = DenseBackend(init_params(cfg, _generator(args), device), cfg,
                               n_slots=args.slots, max_seq=max_seq)
        return backend, 1, cfg.vocab

    from uccl_tpu_torch.models.moe_inference import MoEServer, init_params

    cfg = moe_config(args, **fields)
    world = _world(args)
    if args.slots % world:
        raise SystemExit(f"--slots {args.slots} must divide by the serving world {world} "
                         "(one slot pool row per member batch row)")
    impl = args.impl if args.impl != "auto" else ("sort" if world == 1 else "ll")
    server = MoEServer(cfg, make_mesh(MeshConfig(dp=world), device, world))
    backend = MoEBackend(server, server.shard_params(init_params(cfg, _generator(args), device)),
                         batch_local=args.slots // world, max_seq=max_seq, decode_impl=impl)
    return backend, world, cfg.vocab


def oracle_check(engine, reqs) -> dict:
    """``--check-oracle`` on a drained engine (before ``close``): every
    request's tokens against :func:`serving.replay_alone` on the engine's
    backend, no slot leaked, the queue empty, the conservation check holding
    and every request completed. ``mismatches`` lists each request that
    differs, with its first diverging output position and the two tokens
    there."""
    from uccl_tpu_torch.serving import replay_alone

    mismatched = []
    for r in reqs:
        want = replay_alone(engine.backend, r).tolist()
        if r.out_tokens != want:
            pos = next(i for i, (a, b) in enumerate(zip(r.out_tokens, want)) if a != b)
            mismatched.append({"rid": r.rid, "pos": pos, "got": r.out_tokens[pos],
                               "want": want[pos], "sampled": r.sampling is not None})
    leaked = engine.pool.leaked()
    conserved = engine.conservation_holds()
    ok = (not leaked and not mismatched and engine.sched.qsize == 0 and conserved
          and engine.snapshot()["completed"] == len(reqs))
    return {"oracle_match": bool(ok), "leaked_slots": leaked, "conservation": conserved,
            "mismatches": mismatched}


def _refuse_unported(args) -> None:
    if args.ckpt_dir:
        raise SystemExit("--ckpt-dir: the port's trainer writes no checkpoints yet "
                         "(ROADMAP queue A item 6); serve initialises params from --seed")
    if args.server:
        for flag, attr, item, module in _UNPORTED_SERVER_FLAGS:
            if getattr(args, attr):
                raise SystemExit(f"{flag} needs {module}, which is not ported yet "
                                 f"(ROADMAP queue A item {item})")
        if args.replicas != 1:
            raise SystemExit("--replicas above 1 needs serving/router.py, which is not "
                             "ported yet (ROADMAP queue A item 10d)")


def serve_continuous(args):
    """``--server``: the continuous-batching engine under Poisson arrivals.
    Returns (summary, requests). With ``--check-oracle`` the summary
    carries :func:`oracle_check`'s reading, and a failed check raises
    ``SystemExit``."""
    from uccl_tpu_torch.serving import SamplingParams, ServingEngine, ServingMetrics
    from uccl_tpu_torch.serving.loadgen import assign_classes, drive, synth_workload, warm_engine

    device = resolve_device(args.device)
    if args.slots < 1:
        raise SystemExit(f"--slots must be >= 1, got {args.slots}")
    if not (0.0 <= args.interactive_frac <= 1.0):
        raise SystemExit("--interactive-frac must be in [0, 1]")
    if args.temperature < 0:
        raise SystemExit(f"--temperature must be >= 0, got {args.temperature}")
    if not (0.0 < args.top_p <= 1.0):
        raise SystemExit(f"--top-p must be in (0, 1], got {args.top_p}")
    if args.top_k < 0:
        raise SystemExit(f"--top-k must be >= 0, got {args.top_k}")
    if args.tenants < 0:
        raise SystemExit(f"--tenants must be >= 0, got {args.tenants}")
    if args.tenants and args.priority_classes:
        raise SystemExit("--tenants and --priority-classes are mutually exclusive admission "
                         "policies (per-tenant DRR has no class ladder)")
    max_seq = args.max_seq or (args.prompt_len + args.new_tokens)
    if args.prompt_len + args.new_tokens > max_seq:
        raise SystemExit("--prompt-len + --new-tokens exceed --max-seq")
    if args.stack == "auto":
        args.stack = "moe"

    backend, world, vocab = build_stack(args, device)
    engine = ServingEngine(backend, max_queue=args.max_queue or None, register_stats=True,
                           priority_classes=args.priority_classes,
                           tenant_fair=bool(args.tenants) or None)

    rng = np.random.default_rng(args.seed)
    prompts, lens, arrivals = synth_workload(rng, args.requests, args.prompt_len, vocab,
                                             args.arrival_rate)
    priorities = (assign_classes(rng, args.requests, args.interactive_frac,
                                 pattern=args.class_pattern)
                  if args.priority_classes else None)
    tenant_labels = ([f"t{i % args.tenants}" for i in range(args.requests)]
                     if args.tenants else None)
    samplings = None
    if args.temperature > 0:
        # request i samples under seed --seed + i (lockstep counter keys)
        samplings = [
            SamplingParams(temperature=args.temperature, top_p=args.top_p, top_k=args.top_k,
                           seed=args.seed + i)
            for i in range(args.requests)
        ]
    warm_engine(engine, lens, max_seq, args.new_tokens)
    metrics_srv = None
    if args.metrics_port:
        metrics_srv = obs.MetricsServer(
            args.metrics_port,
            extra_lines_fn=lambda: ServingMetrics.prometheus_lines(engine.snapshot()))
        print(f"metrics: http://127.0.0.1:{metrics_srv.port}/metrics (+ /snapshot)", flush=True)
    try:
        reqs, wall = drive(engine, prompts, arrivals, args.new_tokens, priorities=priorities,
                           tenants=tenant_labels, samplings=samplings)
    finally:
        if metrics_srv is not None:
            metrics_srv.close()

    snap = engine.snapshot()
    check = oracle_check(engine, reqs) if args.check_oracle else None
    engine.close()
    from uccl_tpu_torch.serving.metrics import TTFT_HIST

    ttft_hist_ms = {f"p{q}": round(v * 1e3, 3) for q in (50, 95)
                    for v in [TTFT_HIST.quantile(q)] if v is not None}
    for path in obs.dump_from_args(args, extra_lines=ServingMetrics.prometheus_lines(snap)):
        print(f"wrote {path}", flush=True)
    summary = {
        "mode": "serve-continuous", "schema_version": obs.SCHEMA_VERSION,
        "stack": args.stack, "device": str(device), "ckpt_step": None,
        "world": world, "slots": args.slots, "requests": args.requests,
        "arrival_rate": args.arrival_rate, "new_tokens": args.new_tokens,
        "priority_classes": bool(args.priority_classes),
        "interactive_frac": args.interactive_frac if args.priority_classes else None,
        "temperature": args.temperature or None,
        "top_p": args.top_p if args.temperature else None,
        "top_k": args.top_k if args.temperature else None,
        "tenants": args.tenants or None,
        "wall_s": round(wall, 3), "ttft_hist_ms": ttft_hist_ms, **snap,
    }
    if reqs:
        print(f"first request: {reqs[0].out_tokens}", flush=True)
    if check is not None:
        summary.update(check)
    print(json.dumps(summary), flush=True)
    if check is not None:
        if not check["oracle_match"]:
            for m in check["mismatches"]:
                print(f"request {m['rid']}: first diverging output position {m['pos']} "
                      f"(got {m['got']}, want {m['want']})", file=sys.stderr)
            raise SystemExit(f"oracle check FAILED: leaked={check['leaked_slots']} "
                             f"mismatched={len(check['mismatches'])} "
                             f"conservation={check['conservation']}")
        print(f"oracle check: {len(reqs)} requests token-exact, 0 leaked slots", flush=True)
    return summary, reqs


def serve_oneshot(args) -> dict:
    """The one-shot fixed batch through ``MoEServer.generate`` at the EP
    world; prints the first sequence and the summary line."""
    from uccl_tpu_torch.models.moe_inference import MoEServer, init_params
    from uccl_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    device = resolve_device(args.device)
    cfg = moe_config(args)
    world = _world(args)
    if args.batch % world:
        raise SystemExit(f"--batch {args.batch} must divide by world {world}")
    max_seq = args.max_seq or (args.prompt_len + args.new_tokens)
    if args.prompt_len + args.new_tokens > max_seq:
        raise SystemExit(f"--prompt-len {args.prompt_len} + --new-tokens {args.new_tokens} "
                         f"exceed --max-seq {max_seq}")
    impl = args.impl if args.impl != "auto" else ("sort" if world == 1 else "ll")
    server = MoEServer(cfg, make_mesh(MeshConfig(dp=world), device, world))
    placed = server.shard_params(init_params(cfg, _generator(args), device))
    rng = np.random.default_rng(args.seed)
    prompt = rng.integers(0, cfg.vocab, (world, args.batch // world, args.prompt_len))

    def run(n):
        return server.generate(placed, prompt, n, max_seq, impl=impl)

    run(args.new_tokens)  # warm: the first call pays the kernels' build and load
    run_one = None
    if args.new_tokens > 1:
        run(1)
        run_one = lambda: run(1)  # noqa: E731
    out, dt, extra = _timed_windows(lambda: run(args.new_tokens), run_one, args.batch,
                                    args.new_tokens, args.timing_reps, device)
    summary = {
        "mode": "serve", "schema_version": obs.SCHEMA_VERSION, "ckpt_step": None,
        "impl": impl, "world": world, "device": str(device), "batch": args.batch,
        "new_tokens": args.new_tokens, "window": "prefill+decode",
        "tokens_per_sec": round(args.batch * args.new_tokens / dt, 1), **extra,
    }
    print(f"first sequence: {out[0, 0].tolist()}", flush=True)
    print(json.dumps(summary), flush=True)
    return summary


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m uccl_tpu_torch.serve")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--devices", type=int, default=0,
                    help="members of the EP world, all on the one device")
    ap.add_argument("--dp", type=int, default=0, help="serving world (default: --devices)")
    ap.add_argument("--batch", type=int, default=8, help="global batch")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=0, help="KV capacity (default: prompt+new)")
    ap.add_argument("--impl", default="auto", choices=["auto", "ll", "sort"],
                    help="decode-step EP path (prefill always uses sort); 'auto' is sort at "
                         "world 1 and ll on multi-member worlds")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timing-reps", type=int, default=3,
                    help="one-shot mode: repetitions of the timing windows")
    ap.add_argument("--server", action="store_true",
                    help="continuous-batching engine under a synthetic Poisson arrival stream")
    ap.add_argument("--slots", type=int, default=4,
                    help="server: KV slot pool size (MoE: must divide by the serving world)")
    ap.add_argument("--requests", type=int, default=16, help="server: synthetic requests")
    ap.add_argument("--arrival-rate", type=float, default=8.0,
                    help="server: Poisson arrival rate in req/s (0 = all at t=0)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="server: bounded queue depth (0 = unbounded)")
    ap.add_argument("--stack", default="auto", choices=["auto", "dense", "moe"],
                    help="server: model stack ('auto': MoE)")
    ap.add_argument("--prefill-chunk", type=int, default=0, help="server: not ported yet")
    ap.add_argument("--step-tokens", type=int, default=0, help="server: not ported yet")
    ap.add_argument("--spec-k", type=int, default=0, help="server: not ported yet")
    ap.add_argument("--replicas", type=int, default=1, help="server: only 1 (router not ported)")
    ap.add_argument("--priority-classes", action="store_true",
                    help="server: SLO classes ('interactive' admits before 'batch'), drawn per "
                         "request at --interactive-frac")
    ap.add_argument("--interactive-frac", type=float, default=0.5)
    ap.add_argument("--class-pattern", default="bernoulli", choices=["bernoulli", "batch-first"])
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="server: sampling temperature (0 = greedy); request i samples under "
                         "seed --seed+i with lockstep keys")
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--tenants", type=int, default=0,
                    help="server: N synthetic tenants, admitted by per-tenant deficit "
                         "round-robin")
    ap.add_argument("--adapter-rank", type=int, default=0, help="server: not ported yet")
    ap.add_argument("--check-oracle", action="store_true",
                    help="server: hold every completed request to the one-shot generate "
                         "oracle token for token, and check that no KV slot leaked")
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--kv-heads", type=int, default=2)
    ap.add_argument("--ffn", type=int, default=128)
    ap.add_argument("--experts", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="", help="not ported yet")
    ap.add_argument("--step", type=int, default=None, help="not ported yet")
    obs.add_cli_args(ap)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    _refuse_unported(args)
    obs.setup_from_args(args)
    obs.dump_at_exit(args)
    if args.server:
        return serve_continuous(args)
    summary = serve_oneshot(args)
    obs.dump_from_args(args)
    return summary


if __name__ == "__main__":
    main()
