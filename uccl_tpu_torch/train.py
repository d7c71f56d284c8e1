"""The trainer: ``python -m uccl_tpu_torch.train``.

Port of ``uccl_tpu/train.py``, with its flags and ``--device`` (default
``cuda``). It trains in float32 on every device, as the JAX trainer does
(its configs take the models' default dtype): on the card the attention runs
the float32 flash kernels. At the benchmark's widths:

    python -m uccl_tpu_torch.train --steps 20 --batch 8 --seq 1024 \\
        --vocab 16384 --dim 1024 --layers 4 --heads 16 --kv-heads 4 \\
        --ffn 2816 --experts 8 --ckpt-dir run1 --ckpt-every 10
    # later, continue from the newest checkpoint:
    python -m uccl_tpu_torch.train ... --ckpt-dir run1 --resume

``--model flagship`` (the MoE, default) or ``dense``; ``--remat full | dots
| mlp | none``. ``--mesh pp=2,cp=2,tp=2`` (unnamed axes 1) trains over that
mesh with all of its members on ``--device`` (``models/flagship``'s member
grid); ``--batch`` must divide by dp and ``--seq`` by cp, and
``--microbatches`` feeds the pipeline. Without ``--mesh`` the run is world
1. Data is the JAX trainer's: without ``--data`` a seeded
synthetic stream, with it next-token windows of a 1-D integer token
``.npy`` (memory-mapped) at step-indexed offsets; either way step i's batch
depends only on i, so a resumed run replays the uninterrupted one. Weights
are random from ``--seed``: the JAX trainer's init for the same seed
(``init_params(prng_key(seed), cfg)``).

Checkpoints (``--ckpt-dir``, every ``--ckpt-every`` steps) are
``<dir>/step_N/state.pt``, one ``torch.save`` of ``{"params", "opt"}``
(AdamW's moments and step count) written under a temporary name and
renamed into place in one ``os.replace``, so no half-written step is ever
visible, and ``<dir>/config.json`` (written once: the model family and
size flags under the JAX trainer's keys), which ``serve --ckpt-dir`` reads.
The layout is this package's own (torch format, not the JAX trainer's
orbax). The parameters and moments are the global trees at every mesh, so a
checkpoint holds no trace of the mesh that wrote it; a run resumed at the
same mesh replays the uninterrupted one. ``--resume`` continues from the
newest ``step_N``; a directory that already holds checkpoints is refused
without it.

Prints ``step N loss X [ce Y]`` every ``--log-every`` steps and one summary
JSON line at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import time
from typing import Any, Dict, List, NamedTuple

import numpy as np
import torch

from uccl_tpu_torch import resolve_device
from uccl_tpu_torch.models import dense, flagship
from uccl_tpu_torch.models.sampling import prng_key
from uccl_tpu_torch.parallel.mesh import MeshConfig, make_mesh

STATE_FILE = "state.pt"


def _batch_for_step(step_i, batch, seq, vocab, corpus=None):
    """Deterministic batch (host arrays), a function of the step index
    only, so resumed runs see the same stream: the JAX trainer's. With a
    ``corpus`` (a 1-D int token memmap from --data) rows are contiguous
    windows at step-indexed offsets and targets the next-token shift;
    without one the stream is seeded synthetic noise."""
    rng = np.random.default_rng(10_000 + step_i)
    if corpus is not None:
        n = corpus.shape[0] - seq - 1
        starts = rng.integers(0, n, batch)
        tokens = np.stack([corpus[s:s + seq] for s in starts])
        targets = np.stack([corpus[s + 1:s + seq + 1] for s in starts])
        return tokens.astype(np.int32), targets.astype(np.int32)
    tokens = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    targets = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    return tokens, targets


def _open_corpus(path, vocab, seq):
    """Memmap a 1-D int token file (.npy), checked once over the whole
    corpus: every id in [0, vocab), long enough for one window (an id out
    of range would index past the embedding)."""
    corpus = np.load(path, mmap_mode="r")
    if corpus.ndim != 1 or not np.issubdtype(corpus.dtype, np.integer):
        raise SystemExit(f"--data {path}: want a 1-D integer token array")
    if corpus.shape[0] < seq + 2:
        raise SystemExit(f"--data {path}: {corpus.shape[0]} tokens < one {seq}-token window")
    hi, lo = int(corpus.max()), int(corpus.min())
    if lo < 0 or hi >= vocab:
        raise SystemExit(f"--data {path}: token ids span [{lo}, {hi}], outside [0, {vocab})")
    return corpus


def _latest_step(ckpt_dir):
    steps = [int(m.group(1)) for name in os.listdir(ckpt_dir)
             for m in [re.fullmatch(r"step_(\d+)", name)] if m]
    return max(steps) if steps else None


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach() if torch.is_tensor(tree) else tree


def _save(ckpt_dir, step_i, params, opt_state, model_cfg=None):
    """One ``torch.save`` of the combined state into ``step_N/state.pt``,
    built under a temporary directory name and renamed into place, so an
    interrupted run never leaves a step that ``_latest_step`` would pick
    but ``_restore`` could not load. ``model_cfg`` (model family and size
    flags) is written once as ``config.json`` beside the steps."""
    os.makedirs(ckpt_dir, exist_ok=True)
    if model_cfg is not None:
        cfg_path = os.path.join(ckpt_dir, "config.json")
        if not os.path.exists(cfg_path):
            tmp = f"{cfg_path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(model_cfg, f)
            os.replace(tmp, cfg_path)
    path = os.path.join(ckpt_dir, f"step_{step_i}")
    tmp = os.path.join(ckpt_dir, f".step_{step_i}.{os.getpid()}.tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({"params": _detached(params), "opt": _detached(opt_state)},
               os.path.join(tmp, STATE_FILE))
    os.replace(tmp, path)


def load_state(ckpt_dir, step_i) -> Dict[str, Any]:
    """The ``{"params", "opt"}`` tree of ``step_N`` (``weights_only``: plain
    tensors, dicts and numbers only), its tensors memory-mapped on the CPU:
    a tensor's bytes are read when it is first used."""
    path = os.path.join(ckpt_dir, f"step_{step_i}", STATE_FILE)
    if not os.path.exists(path):
        raise SystemExit(f"{path}: no such checkpoint")
    return torch.load(path, map_location="cpu", mmap=True, weights_only=True)


def _copy_into(live, saved, where):
    """Copy ``saved`` into the live tree in place (its device and dtype);
    numbers (AdamW's step count) are returned as saved."""
    if isinstance(live, dict):
        if not isinstance(saved, dict) or saved.keys() != live.keys():
            raise SystemExit(f"checkpoint {where}: its keys differ from the model's "
                             f"{sorted(live)}")
        return {k: _copy_into(live[k], saved[k], f"{where}/{k}") for k in live}
    if not torch.is_tensor(live):
        return saved
    if tuple(saved.shape) != tuple(live.shape):
        raise SystemExit(f"checkpoint {where} {tuple(saved.shape)} != model "
                         f"{tuple(live.shape)}: pass the training run's size flags")
    with torch.no_grad():
        live.copy_(saved)
    return live


def _restore(ckpt_dir, step_i, params, opt_state):
    """Restore ``step_N`` into the live trees: every tensor lands on the
    live tensor's device and dtype, and AdamW's step count comes back too."""
    state = load_state(ckpt_dir, step_i)
    return (_copy_into(params, state["params"], "params"),
            _copy_into(opt_state, state["opt"], "opt"))


def parse_mesh(spec: str) -> MeshConfig:
    """"dp=2,cp=2,tp=2" -> MeshConfig (unnamed axes default to 1)."""
    sizes = {}
    if spec:
        for part in spec.split(","):
            m = re.fullmatch(r"(pp|dp|cp|tp)=(\d+)", part.strip())
            if not m:
                raise SystemExit(f"bad --mesh entry {part!r} (want e.g. dp=2,tp=2)")
            sizes[m.group(1)] = int(m.group(2))
    return MeshConfig(**sizes)


def build(args, mesh):
    """Returns (cfg, params, train_step, init_opt) for the model family over
    ``mesh``, at float32 as the JAX trainer builds them."""
    fam = flagship if args.model == "flagship" else dense
    size_kw = dict(vocab=args.vocab, dim=args.dim, n_layers=args.layers, n_heads=args.heads,
                   n_kv_heads=args.kv_heads, head_dim=args.dim // args.heads,
                   n_microbatches=args.microbatches, remat=args.remat)
    if args.model == "flagship":
        cfg = flagship.FlagshipConfig(**size_kw, moe_experts=args.experts, moe_ffn=args.ffn,
                                      moe_topk=2)
    else:
        cfg = dense.DenseConfig(**size_kw, ffn=args.ffn)
    params = fam.init_params(prng_key(args.seed), cfg, mesh.device)
    train_step, init_opt = fam.make_train_step(cfg, mesh, learning_rate=args.lr)
    return cfg, params, train_step, init_opt


class TrainRun(NamedTuple):
    """What :func:`main` returns: the summary it printed, the final state
    and each step's metrics (its loss as a float under ``"loss"``)."""

    summary: Dict[str, Any]
    params: Dict[str, Any]
    opt_state: Dict[str, Any]
    metrics: List[Dict[str, float]]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m uccl_tpu_torch.train")
    ap.add_argument("--model", default="flagship", choices=["flagship", "dense"])
    ap.add_argument("--mesh", default="", help="e.g. pp=2,dp=2,tp=2 (members on --device)")
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
    ap.add_argument("--remat", default="full", choices=list(flagship.REMAT_MODES),
                    help="backward recompute schedule (mlp: save the expert GEMMs, "
                         "recompute attention; for --model dense it is dots)")
    ap.add_argument("--data", default="",
                    help="1-D int token .npy (memory-mapped); batches are next-token "
                         "windows at step-indexed offsets")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    return ap


def main(argv=None) -> TrainRun:
    ap = parser()
    args = ap.parse_args(argv)
    mcfg = parse_mesh(args.mesh)
    if args.batch % mcfg.dp or args.seq % mcfg.cp:
        ap.error(f"--batch {args.batch} must divide by dp={mcfg.dp} and --seq {args.seq} by "
                 f"cp={mcfg.cp} (data is sharded [batch/dp, seq/cp])")

    device = resolve_device(args.device)
    mesh = make_mesh(mcfg, device)
    corpus = _open_corpus(args.data, args.vocab, args.seq) if args.data else None
    cfg, params, train_step, init_opt = build(args, mesh)
    opt_state = init_opt(params)

    start = 0
    if args.resume:
        if not (args.ckpt_dir and os.path.isdir(args.ckpt_dir)):
            raise SystemExit("--resume needs an existing --ckpt-dir")
        latest = _latest_step(args.ckpt_dir)
        if latest is None:
            raise SystemExit(f"no step_N checkpoints in {args.ckpt_dir}")
        params, opt_state = _restore(args.ckpt_dir, latest, params, opt_state)
        start = latest
        print(f"resumed from {args.ckpt_dir}/step_{latest}", flush=True)
    elif args.ckpt_dir and os.path.isdir(args.ckpt_dir) \
            and _latest_step(args.ckpt_dir) is not None:
        # fail before training, not at the first save
        raise SystemExit(f"{args.ckpt_dir} already holds checkpoints; pass --resume to "
                         "continue from them or choose a fresh --ckpt-dir")

    t0 = time.perf_counter()
    history = []
    for i in range(start, args.steps):
        tokens, targets = _batch_for_step(i, args.batch, args.seq, args.vocab, corpus)
        params, opt_state, metrics = train_step(params, opt_state, tokens, targets)
        history.append(metrics)  # device scalars: read at a log line or at the end
        if args.log_every and (i + 1) % args.log_every == 0:
            extra = f" ce {float(metrics['ce']):.6f}" if "ce" in metrics else ""
            print(f"step {i + 1:5d} loss {float(metrics['loss']):.6f}{extra}", flush=True)
        if args.ckpt_dir and args.ckpt_every and (i + 1) % args.ckpt_every == 0:
            _save(args.ckpt_dir, i + 1, params, opt_state, model_cfg={
                "model": args.model, "vocab": args.vocab, "dim": args.dim,
                "layers": args.layers, "heads": args.heads, "kv_heads": args.kv_heads,
                "ffn": args.ffn, "experts": args.experts,
            })
            print(f"checkpointed step {i + 1}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    history = [{k: float(v) for k, v in m.items()} for m in history]
    done = args.steps - start
    summary = {
        "model": args.model,
        "mesh": {"pp": mcfg.pp, "dp": mcfg.dp, "cp": mcfg.cp, "tp": mcfg.tp}
        if args.mesh else {"dp": 1},
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "dtype": str(cfg.dtype).replace("torch.", ""),
        "steps": done,
        "final_loss": round(history[-1]["loss"], 6) if history else None,
        "steps_per_sec": round(done / dt, 3) if done else 0.0,
    }
    print(json.dumps(summary), flush=True)
    return TrainRun(summary, params, opt_state, history)


if __name__ == "__main__":
    main()
