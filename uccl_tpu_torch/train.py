"""World-1 flagship trainer: ``python -m uccl_tpu_torch.train``.

Port of ``uccl_tpu/train.py`` for one device. Same size flags, plus
``--device`` (default ``cuda``). Activations are bfloat16 on the card (what
the flash kernels take) and float32 on the CPU:

    python -m uccl_tpu_torch.train --steps 20 --batch 8 --seq 1024 \
        --vocab 16384 --dim 1024 --layers 4 --heads 16 --kv-heads 4 \
        --ffn 2816 --experts 8

Data is the same seeded synthetic stream as the JAX trainer's: step i's
batch depends only on i. Weights are random from ``--seed``: the JAX trainer's init for the same
seed (``init_params(prng_key(seed), cfg)``).
Prints ``step N loss X ce Y`` every ``--log-every`` steps and one summary
JSON line at the end.

Not ported yet, and refused if passed: ``--mesh``, ``--data``,
``--ckpt-dir``/``--ckpt-every``/``--resume`` and ``--model dense``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from uccl_tpu_torch import resolve_device
from uccl_tpu_torch.models import flagship
from uccl_tpu_torch.models.sampling import prng_key

def _batch_for_step(step_i, batch, seq, vocab):
    """Deterministic synthetic batch (host arrays), a function of the step
    index only: the JAX trainer's stream."""
    rng = np.random.default_rng(10_000 + step_i)
    tokens = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    targets = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    return tokens, targets


def build(args, device):
    """Returns (cfg, params, train_step, init_opt)."""
    cfg = flagship.FlagshipConfig(
        vocab=args.vocab, dim=args.dim, n_layers=args.layers,
        n_heads=args.heads, n_kv_heads=args.kv_heads,
        head_dim=args.dim // args.heads,
        n_microbatches=args.microbatches,
        moe_experts=args.experts, moe_ffn=args.ffn, moe_topk=2,
        remat=args.remat,
        dtype=torch.bfloat16 if device.type == "cuda" else torch.float32,
    )
    params = flagship.init_params(prng_key(args.seed), cfg, device)
    train_step, init_opt = flagship.make_train_step(cfg, device, learning_rate=args.lr)
    return cfg, params, train_step, init_opt


def _refuse_unported(ap, args):
    unported = {
        "--model dense": args.model != "flagship",
        "--mesh": bool(args.mesh),
        "--data": bool(args.data),
        "--ckpt-dir": bool(args.ckpt_dir),
        "--ckpt-every": bool(args.ckpt_every),
        "--resume": args.resume,
    }
    passed = [flag for flag, given in unported.items() if given]
    if passed:
        ap.error(f"{', '.join(passed)}: not ported to uccl_tpu_torch yet "
                 "(world-1 flagship training only)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m uccl_tpu_torch.train")
    ap.add_argument("--model", default="flagship", choices=["flagship", "dense"])
    ap.add_argument("--mesh", default="", help="not ported yet")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    # model size
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--kv-heads", type=int, default=2)
    ap.add_argument("--ffn", type=int, default=128)
    ap.add_argument("--experts", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="full", choices=["full", "none"],
                    help="backward recompute schedule (dots/mlp not ported yet)")
    ap.add_argument("--data", default="", help="not ported yet")
    ap.add_argument("--ckpt-dir", default="", help="not ported yet")
    ap.add_argument("--ckpt-every", type=int, default=0, help="not ported yet")
    ap.add_argument("--resume", action="store_true", help="not ported yet")
    args = ap.parse_args(argv)
    _refuse_unported(ap, args)

    device = resolve_device(args.device)
    cfg, params, train_step, init_opt = build(args, device)
    opt_state = init_opt(params)

    t0 = time.perf_counter()
    metrics = None
    for i in range(args.steps):
        tokens, targets = _batch_for_step(i, args.batch, args.seq, args.vocab)
        params, opt_state, metrics = train_step(params, opt_state, tokens, targets)
        if args.log_every and (i + 1) % args.log_every == 0:
            print(f"step {i + 1:5d} loss {float(metrics['loss']):.6f} "
                  f"ce {float(metrics['ce']):.6f}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    summary = {
        "model": args.model,
        "mesh": {"dp": 1},
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "dtype": str(cfg.dtype).replace("torch.", ""),
        "steps": args.steps,
        "final_loss": round(float(metrics["loss"]), 6) if metrics else None,
        "steps_per_sec": round(args.steps / dt, 3) if args.steps else 0.0,
    }
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
