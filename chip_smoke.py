#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (uccl_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one Hopper GPU and the CUDA
toolkit. It builds the CUDA kernels from the checkout's sources, holds each
against its plain PyTorch version on the card element by element (and shows
that the same rule rejects planted faults), times them, then trains the
flagship MoE model at the benchmark's base configuration for a few steps and
checks that the step went through the kernels. At that size it also holds
the kernels' autograd path, on layer 0's q/k/v, to the plain backward, and
the first two losses to the same steps through plain attention. Every phase
raises on failure; nothing is caught. Each phase prints one JSON line; the
last three lines are the card's name and power limit (nvidia-smi), the
per-kernel JSON summary and

    {"ok": true, "device": {"platform": "gpu", "kind": "<GPU name>", "count": 1}}

It exits non-zero, before printing anything, when PyTorch sees no GPU.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: torch.cuda.is_available() is False; this script needs a GPU")

from uccl_tpu_torch.collective import Communicator, dma, plan  # noqa: E402
from uccl_tpu_torch.collective import ring_ccl as rc  # noqa: E402
from uccl_tpu_torch.models import flagship  # noqa: E402
from uccl_tpu_torch.parallel.mesh import AXIS, MeshConfig, make_mesh  # noqa: E402
from uccl_tpu_torch.models.layers import rms_norm, rope  # noqa: E402
from uccl_tpu_torch.ops import flash_attention as fa  # noqa: E402
from uccl_tpu_torch.ops.attention import _NEG_INF, _repeat_kv  # noqa: E402
from uccl_tpu_torch.train import _batch_for_step  # noqa: E402
from uccl_tpu_torch.utils import build  # noqa: E402

DEV = torch.device("cuda", 0)
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12  # H100 SXM HBM3

# The main path: the benchmark's base config (flagship.bench_config) at
# B=8, S=1024.
BATCH, SEQ, STEPS = 8, 1024, 5

# Each kernel is held element by element to its plain f32 version on the
# same bf16 inputs (fa.kernel_error: |got - want| <= ATOL * row rms + RTOL *
# |want|, see ops/flash_attention.py for why); lse, f32 with no bf16 product
# in its path, to LSE_ATOL absolute. The train step's first two losses are
# held to the same steps through plain attention to LOSS_RTOL relative.
LSE_ATOL = 1e-3
LOSS_RTOL = 1e-3

SOURCE = "uccl_tpu_torch/csrc/flash_attention.cu"
REPLACES = {
    "flash_fwd": "uccl_tpu/ops/pallas_attention.py:56",
    "flash_bwd_dq": "uccl_tpu/ops/pallas_attention.py:184",
    "flash_bwd_dkv": "uccl_tpu/ops/pallas_attention.py:234",
}
PRODUCTS = {"flash_fwd": 2, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}

def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)

def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")

def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

# ---------------------------------------------------------------------------
# 1. Toolchain

def toolchain() -> None:
    nvcc = build.find_nvcc()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()
    try:
        import triton
        triton_ver = triton.__version__
    except ImportError:
        triton_ver = None
    emit("toolchain", gpu=nvidia_smi_line(), torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=[ln for ln in nvcc_ver if "release" in ln][0],
         triton=triton_ver, cutlass=os.path.isdir("/usr/local/cutlass/include"),
         python=sys.version.split()[0], device_count=torch.cuda.device_count())

# ---------------------------------------------------------------------------
# 2. Build

def ptxas_report(source: str, short) -> list:
    """Registers per kernel from nvcc's -Xptxas -v report (``short`` cuts
    the mangled name); fails on spills."""
    ptxas, kernel = [], None
    for line in build.build_log(source).splitlines():
        if "Compiling entry function" in line:
            kernel = short(line.split("'")[1])
        elif "registers" in line and kernel:
            ptxas.append({"kernel": kernel, "registers": int(line.split("Used ")[1].split()[0])})
        elif "spill stores" in line and kernel:
            spills = int(line.split("bytes spill stores")[0].split(",")[-1])
            if spills:
                fail(f"{kernel} spills {spills} bytes")
    return ptxas

def build_kernels() -> None:
    """Both CUDA sources, one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor

    def timed(name):
        t0 = time.perf_counter()
        return build.build(name), time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        fa_job, ring_job = pool.submit(timed, "flash_attention"), pool.submit(timed, "ring_ccl")
        (lib, seconds), (ring_lib, ring_seconds) = fa_job.result(), ring_job.result()
    root = build.PACKAGE_DIR.parent
    emit("build", library=str(lib.relative_to(root)), seconds=round(seconds, 3),
         ptxas=ptxas_report("flash_attention",
                           lambda n: n[n.find("flash_"):n.find("EEEv") + 3]))
    emit("ring_ccl_build", library=str(ring_lib.relative_to(root)),
         seconds=round(ring_seconds, 3), both_seconds=round(time.perf_counter() - t0, 3),
         ptxas=ptxas_report("ring_ccl", lambda n: n[n.find("ring_"):]))

# ---------------------------------------------------------------------------
# 3. Kernels against their plain versions

def attn_inputs(b, s, h, hkv, d, seed):
    g = torch.Generator(device=DEV).manual_seed(seed)

    def t(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=DEV).to(dtype)

    return dict(q=t(b, s, h, d), k=t(b, s, hkv, d), v=t(b, s, hkv, d),
                dout=t(b, s, h, d), g_lse=t(b, h, s, dtype=torch.float32) * 0.5)

def held(name, got, want, shape) -> dict:
    """got against want by fa.kernel_error; fails past the limit."""
    if not torch.isfinite(got.float()).all():
        fail(f"{name} has non-finite values at q {shape}")
    e = fa.kernel_error(got, want)
    if e["worst"] > 1:
        fail(f"{name} at q {shape}: {e} (worst > 1)")
    return e

def check_kernels(b, s, h, hkv, d, causal, seed) -> tuple:
    """Each kernel against its plain version on the same inputs, with a
    nonzero lse cotangent; returns the readings by name (out, lse, dq, dk,
    dv) and the plain results, for the planted faults."""
    x = attn_inputs(b, s, h, hkv, d, seed)
    q, k, v, dout = x["q"], x["k"], x["v"], x["dout"]
    shape = tuple(q.shape)
    out, lse = fa.flash_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, causal)
    delta = fa.flash_delta(out_p, dout, x["g_lse"])
    dq = fa.flash_bwd_dq(q, k, v, dout, lse_p, delta, causal)
    torch.cuda.synchronize()
    dk, dv = fa.flash_bwd_dkv(q, k, v, dout, lse_p, delta, causal)
    torch.cuda.synchronize()
    dq_p = fa.flash_bwd_dq_plain(q, k, v, dout, lse_p, delta, causal)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, dout, lse_p, delta, causal)
    readings = {name: held(name, got, want, shape) for name, got, want in (
        ("out", out, out_p), ("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv, dv_p))}
    lse_err = (lse - lse_p).abs().max().item()
    if not lse_err <= LSE_ATOL:
        fail(f"lse: max abs err {lse_err} > {LSE_ATOL}")
    readings["lse"] = {"max_abs_err": lse_err}
    emit("kernels_vs_plain", shape=dict(B=b, S=s, H=h, Hkv=hkv, D=d, causal=causal),
         readings=readings, rtol=fa.KERNEL_RTOL, atol_of_row_rms=fa.KERNEL_ATOL_OF_ROW_RMS,
         lse_atol=LSE_ATOL)
    plain = dict(out=out_p, lse=lse_p, delta=delta, dq=dq_p, dk=dk_p, dv=dv_p)
    return readings, x, plain

def out_without_kv_tile(q, k, v, tile, rows=64):
    """The causal forward's output had it skipped KV tile ``tile`` for every
    q row past that tile."""
    n_rep = q.shape[2] // k.shape[2]
    kk, vv = (_repeat_kv(t.float(), n_rep) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) / math.sqrt(q.shape[-1])
    pos = torch.arange(q.shape[1], device=DEV)
    keep = pos[:, None] >= pos[None, :]
    keep[(tile + 1) * rows:, tile * rows:(tile + 1) * rows] = False
    p = torch.softmax(s.masked_fill(~keep, _NEG_INF), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vv).to(q.dtype)

def planted_faults(x, plain) -> None:
    """The readings of faults the check must reject, at the same inputs: a
    forward that drops KV tile 1 and a dK/dV pass that drops q tile 1 (both
    made with the plain version), and the dQ and dK/dV kernels run with the
    lse cotangent left out of delta. Fails if any would pass."""
    q, k, v, dout = x["q"], x["k"], x["v"], x["dout"]
    lse, delta = plain["lse"], plain["delta"]
    delta_no_glse = fa.flash_delta(plain["out"], dout)
    rows = slice(64, 128)
    dout_drop, delta_drop = dout.clone(), delta.clone()
    dout_drop[:, rows], delta_drop[:, :, rows] = 0, 0
    dk_drop, dv_drop = fa.flash_bwd_dkv_plain(q, k, v, dout_drop, lse, delta_drop, True)
    dk_glse, dv_glse = fa.flash_bwd_dkv(q, k, v, dout, lse, delta_no_glse, True)
    faults = {
        "out: KV tile 1 dropped": (out_without_kv_tile(q, k, v, 1), plain["out"]),
        "dk: q tile 1 dropped": (dk_drop, plain["dk"]),
        "dv: q tile 1 dropped": (dv_drop, plain["dv"]),
        "dq: g_lse ignored": (fa.flash_bwd_dq(q, k, v, dout, lse, delta_no_glse, True),
                              plain["dq"]),
        "dk: g_lse ignored": (dk_glse, plain["dk"]),
    }
    readings = {name: fa.kernel_error(got, want) for name, (got, want) in faults.items()}
    passed = [name for name, r in readings.items() if not r["worst"] > 1]
    if passed:
        fail(f"planted faults pass the check: {passed}")
    emit("planted_faults", shape=list(q.shape), readings=readings)

# ---------------------------------------------------------------------------
# 4. Kernel timing

def time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn, L2 flushed before each run (the train
    step reaches attention with the expert weights, not q/k/v, in L2). A
    device-side sleep before the start event lets the host enqueue the
    launch, so host overhead stays out of the window."""
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=DEV)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)

def bound_ms(name, b, s, h, hkv, d, causal) -> tuple:
    """Least time on the card: the larger of the kernel's tensor-core
    operations over the bf16 peak and its bytes (inputs read once, outputs
    written once) over the HBM rate. Causal work counts only the unmasked
    (q, k) pairs. Returns (ms, "operations" | "bytes")."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = PRODUCTS[name] * 2 * d * pairs * b * h
    qo, kv, rows = b * s * h * d * 2, b * s * hkv * d * 2, b * h * s * 4
    nbytes = {
        "flash_fwd": 2 * qo + 2 * kv + rows,  # q, k, v, out, lse
        "flash_bwd_dq": 3 * qo + 2 * kv + 2 * rows,  # q, dout, k, v, lse, delta, dq
        "flash_bwd_dkv": 2 * qo + 4 * kv + 2 * rows,  # q, dout, k, v, lse, delta, dk, dv
    }[name]
    op_ms, byte_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(op_ms, byte_ms), ("operations" if op_ms >= byte_ms else "bytes")

def time_kernels(b, s, h, hkv, d) -> dict:
    import torch.nn.functional as F

    x = attn_inputs(b, s, h, hkv, d, seed=2)
    q, k, v, dout = x["q"], x["k"], x["v"], x["dout"]
    out, lse = fa.flash_fwd(q, k, v, True)
    delta = fa.flash_delta(out, dout)
    runs = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, True),
                      lambda: fa.flash_fwd_plain(q, k, v, True)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, dout, lse, delta, True),
                         lambda: fa.flash_bwd_dq_plain(q, k, v, dout, lse, delta, True)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, dout, lse, delta, True),
                          lambda: fa.flash_bwd_dkv_plain(q, k, v, dout, lse, delta, True)),
    }
    res = {}
    for name, (kernel, plain) in runs.items():
        bnd, by = bound_ms(name, b, s, h, hkv, d, True)
        ms = time_ms(kernel, 50)
        res[name] = dict(ms=ms, plain_ms=time_ms(plain, 5), bound_ms=bnd, bound_by=by,
                         share_of_bound=bnd / ms)
    # The library yardsticks (never called by the port), on the same q/k/v
    # viewed as [B, H, S, D], KV heads expanded beforehand: PyTorch's fused
    # SDPA forward, and its flash-attention backward, one call that returns
    # dq, dk and dv together (with no lse cotangent) and so stands beside
    # B2 + B3.
    rep = h // hkv
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(rep, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    go = dout.transpose(1, 2)
    lib_fwd = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)  # noqa: E731
    o, lse_l, cq, ck, mq, mk, seed, offset, _ = \
        torch.ops.aten._scaled_dot_product_flash_attention(qt, kt, vt, 0.0, True)
    lib_bwd = lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(  # noqa: E731
        go, qt, kt, vt, o, lse_l, cq, ck, mq, mk, 0.0, True, seed, offset)
    lib_dq = lib_bwd()[0].transpose(1, 2)
    ours_dq = fa.flash_bwd_dq(q, k, v, dout, lse, delta, True).float()
    lib_dq_norm_ratio = ((lib_dq.float() - ours_dq).norm() / ours_dq.norm()).item()
    res["flash_fwd"]["library_ms"] = time_ms(lib_fwd, 50)
    res["flash_fwd"]["library_call"] = "F.scaled_dot_product_attention"
    lib_bwd_ms = time_ms(lib_bwd, 50)
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        res[name]["library_ms"] = lib_bwd_ms
        res[name]["library_call"] = ("aten._scaled_dot_product_flash_attention_backward "
                                     "(dq, dk and dv in one call: B2 + B3)")
    emit("kernel_timing", shape=dict(B=b, S=s, H=h, Hkv=hkv, D=d, causal=True),
         kernels=res, ours_bwd_ms=res["flash_bwd_dq"]["ms"] + res["flash_bwd_dkv"]["ms"],
         library_bwd_ms=lib_bwd_ms, library_dq_norm_ratio_vs_ours=lib_dq_norm_ratio)
    return res

# ---------------------------------------------------------------------------
# 5. The main path: the flagship train step

def model_flops_per_token(cfg, seq: int) -> float:
    """bench.py:139's MFU numerator: matmul FLOPs per token for one step
    (fwd + bwd = 3x fwd), causal attention at half the score cost, remat
    recompute not counted."""
    h, hd = cfg.dim, cfg.head_dim
    qd, kvd = cfg.n_heads * hd, cfg.n_kv_heads * hd
    per_layer = h * qd + 2 * h * kvd + qd * h + h * cfg.moe_experts \
        + cfg.moe_topk * 3 * h * cfg.moe_ffn
    n_active = cfg.n_layers * per_layer + h * cfg.vocab
    attn_core = cfg.n_layers * 2 * cfg.n_heads * hd * seq
    return 3.0 * (2.0 * n_active + attn_core)

def layer0_qkv(params, cfg, tokens):
    """Layer 0's q, k and v for these tokens, as the train step forms them."""
    b, s = tokens.shape
    lp = {n: params["blocks"][n][0] for n in ("ln1", "wq", "wk", "wv")}
    x = rms_norm(params["embed"][tokens.long()].to(cfg.dtype), lp["ln1"], cfg.norm_eps)
    pos = torch.arange(s, device=DEV)
    q, k, v = ((x @ lp[n].to(x.dtype)).reshape(b, s, heads, cfg.head_dim)
               for n, heads in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads),
                                ("wv", cfg.n_kv_heads)))
    return rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta), v

def autograd_vs_plain(q, k, v) -> dict:
    """The kernels' autograd path (flash_attention_lse: the forward kernel,
    then dQ and dK/dV with the lse cotangent folded into delta), given
    nonzero cotangents for out and lse, against the plain dQ and dK/dV
    functions on the out and lse the forward returned. The forward is held
    to its plain version in check_kernels; the backward's delta reads the
    stored bf16 out (as the JAX kernels' does), so autograd through the f32
    plain forward would differ from it by out's rounding, not by a fault."""
    g = torch.Generator(device=DEV).manual_seed(3)
    g_out = torch.randn(q.shape, generator=g, device=DEV).to(q.dtype)
    g_lse = torch.randn(q.shape[0], q.shape[2], q.shape[1], generator=g, device=DEV) * 0.5
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out, lse = fa.flash_attention_lse(*leaves, True)
    got = torch.autograd.grad((out, lse), leaves, (g_out, g_lse))
    out, lse = out.detach(), lse.detach()
    delta = fa.flash_delta(out, g_out, g_lse)
    want = (fa.flash_bwd_dq_plain(q, k, v, g_out, lse, delta, True),
            *fa.flash_bwd_dkv_plain(q, k, v, g_out, lse, delta, True))
    return {name: held(name, a, b, tuple(q.shape))
            for name, a, b in zip(("dq", "dk", "dv"), got, want)}

def against_plain_attention(cfg, params, batches) -> dict:
    """Checks of the main path's backward at its own size: the kernels'
    autograd path on layer 0's q/k/v of the first batch against plain
    autograd, and the first two train-step losses through plain attention
    from the same weights and batches."""
    tokens = torch.as_tensor(batches[0][0], device=DEV)
    with torch.no_grad():
        q, k, v = layer0_qkv(params, cfg, tokens)
    grads = autograd_vs_plain(q, k, v)
    del q, k, v
    step, init_opt = flagship.make_train_step(dataclasses.replace(cfg, attn_impl="xla"), DEV)
    p = {k: (v.detach().clone() if torch.is_tensor(v) else
             {n: t.detach().clone() for n, t in v.items()}) for k, v in params.items()}
    opt_state = init_opt(p)
    losses = []
    for tokens, targets in batches[:2]:
        p, opt_state, metrics = step(p, opt_state, tokens, targets)
        losses.append(metrics["loss"].item())
    return {"losses": losses, "layer0_grads": grads}

def main_path() -> dict:
    cfg = flagship.bench_config()
    params = flagship.init_params(cfg, torch.Generator().manual_seed(0), DEV)
    train_step, init_opt = flagship.make_train_step(cfg, DEV)
    opt_state = init_opt(params)
    batches = [_batch_for_step(i, BATCH, SEQ, cfg.vocab) for i in range(STEPS)]
    plain = against_plain_attention(cfg, params, batches)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(DEV)
    fa.reset_launch_counts()
    losses, step_ms = [], []
    for tokens, targets in batches:
        t = time.perf_counter()
        params, opt_state, metrics = train_step(params, opt_state, tokens, targets)
        losses.append(metrics["loss"].item())  # host read: the step has finished
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches = dict(fa.launch_counts)

    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite losses {losses}")
    want = {"flash_fwd": 2 * cfg.n_layers * STEPS, "flash_bwd_dq": cfg.n_layers * STEPS,
            "flash_bwd_dkv": cfg.n_layers * STEPS}
    if launches != want:
        fail(f"kernel launches {launches} over {STEPS} steps, expected {want}")
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain["losses"])]
    if not max(loss_rel) <= LOSS_RTOL:
        fail(f"losses {losses[:2]} vs plain attention's {plain['losses']}: rel {loss_rel}")
    steady = statistics.median(step_ms[1:])
    tokens_per_s = BATCH * SEQ / (steady / 1e3)
    mfu = model_flops_per_token(cfg, SEQ) * tokens_per_s / PEAK_BF16_FLOPS
    emit("main_path", config={k: str(v) for k, v in dataclasses.asdict(cfg).items()},
         batch=BATCH, seq=SEQ, losses=losses, plain_attention_losses=plain["losses"],
         loss_rel_diff=loss_rel, layer0_autograd_vs_plain=plain["layer0_grads"],
         step_ms=step_ms, steady_step_ms=steady, tokens_per_s=tokens_per_s, mfu=mfu,
         peak_mem_gib=torch.cuda.max_memory_allocated(DEV) / 2**30,
         launches=launches, launches_per_step={k: v // STEPS for k, v in launches.items()})
    return launches

# ---------------------------------------------------------------------------
# 6. The collective plane: ring kernels B4, B5, B7 over a W-member world

# The gradient bucket of the bench config (a DDP replica of the model above
# syncs it every step), at W = 4 members on this one card.
WORLD = 4
BUCKET = 320_906_240  # f32 elements per member: flagship.bench_config()'s parameters
SWEEP_MIB = (1, 16, 256)
RING_SOURCE = "uccl_tpu_torch/csrc/ring_ccl.cu"
RING_REPLACES = {
    "ring_all_gather": "uccl_tpu/collective/pallas_ccl.py:434",
    "ring_reduce_scatter": "uccl_tpu/collective/pallas_ccl.py:546",
    "ring_all_reduce": "uccl_tpu/collective/pallas_ccl.py:645",
}
UNIT_ROUNDOFF = {torch.float32: 2.0 ** -24, torch.bfloat16: 2.0 ** -8}

def ring_rule(kind, got, plain, x, w, dtype) -> dict:
    """The check a ring kernel's output passes: bit-identical to its plain
    version, and right by itself — an all-gather equal to the members'
    contributions, a sum within (W-1)·u·Σ|x| of the float64 sum over
    members (the bound of W-1 correctly rounded adds). ``x`` is the
    members' payloads ``[W, ...]``; ``got`` and ``plain`` the per-member
    results in the layout the rule's ``kind`` names."""
    r = {"bit_identical": bool(torch.equal(got, plain)),
         "max_abs_err_vs_plain": (got.double() - plain.double()).abs().max().item()}
    if kind == "gather":  # every member holds all contributions
        r["exact"] = bool(torch.equal(got, x.reshape(1, -1).expand(w, -1).reshape(got.shape)))
        r["ok"] = r["bit_identical"] and r["exact"]
        return r
    exact = x.double().sum(0)
    bound = (w - 1) * UNIT_ROUNDOFF[dtype] * x.double().abs().sum(0)
    if kind == "scatter":  # member r keeps block r
        exact, bound = exact.reshape(w, -1), bound.reshape(w, -1)
    err = (got.double() - exact).abs()
    r["worst_over_bound"] = (err / bound.clamp_min(1e-300)).max().item()
    r["ok"] = r["bit_identical"] and bool((err <= bound).all())
    return r

def run_ring(kind, x, d, dirs=None):
    """One kernel launch and its plain version on ``x`` [W, N]; returns the
    per-member results (kernel, plain) in the rule's layout."""
    w, size = x.shape
    if kind == "gather":
        chunk, _, m = rc._dma.pad_chunks(x, 1)
        chunk = chunk.reshape(w, m)
        lane, got = rc._ag_kernel(chunk, d, 0)
        lane.check("ring_all_gather")
        plain = rc.ag_plain(chunk, d)
        return got[:, :, :size].reshape(w, -1), plain[:, :, :size].reshape(w, -1)
    if kind == "scatter":
        chunks, per, m = rc._dma.pad_chunks(x, w)
        chunks = chunks.reshape(w, w, m)
        lane, got = rc._rs_kernel(chunks, d, 0)
        lane.check("ring_reduce_scatter")
        return got[:, :per], rc.rs_plain(chunks, d)[:, :per]
    view, k, _ = rc._ar_layout(x, len(dirs))
    lane, got = rc._ar_kernel(view, dirs, 0)
    lane.check("ring_all_reduce")
    return rc._ar_unlayout(got, k, x), rc._ar_unlayout(rc.ar_plain(view, dirs), k, x)

def ring_inputs(w, size, dtype, seed):
    g = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn((w, size), generator=g, device=DEV)
    return (x * 1000).to(torch.int32) if dtype == torch.int32 else x.to(dtype)

RING_CASES = [  # (W, elements per member, dtype, direction); odd sizes need padding
    (2, 1_000_003, torch.float32, 1),
    (3, 777_777, torch.bfloat16, -1),
    (4, 4_194_309, torch.float32, -1),
    (8, 2_000_001, torch.bfloat16, 1),
]

def ring_vs_plain() -> dict:
    """Each ring kernel against its plain version, bit for bit, and against
    the float64 sum; W in {2, 3, 4, 8}, f32 and bf16 (int32 for B4 too),
    sizes that need padding, both directions, B7 with one and two streams."""
    rc.reset_launch_counts()
    readings = []
    for w, size, dtype, d in RING_CASES:
        x = ring_inputs(w, size, dtype, seed=w)
        cases = [("ring_all_gather", "gather", dict()),
                 ("ring_reduce_scatter", "scatter", dict()),
                 ("ring_all_reduce S=1", "reduce", dict(dirs=(d,))),
                 ("ring_all_reduce S=2", "reduce", dict(dirs=(1, -1)))]
        for name, kind, kw in cases:
            xin = x[:, : size - size % w] if kind == "scatter" else x
            got, plain = run_ring(kind, xin, d, **kw)
            r = ring_rule(kind, got, plain, xin, w, dtype)
            readings.append({"kernel": name, "W": w, "size": size, "dtype": str(dtype),
                             "dir": d, **r})
            if not r["ok"]:
                fail(f"{name} W={w} size={size} {dtype} dir={d}: {r}")
    xi = ring_inputs(3, 1_234_567, torch.int32, seed=9)
    got, plain = run_ring("gather", xi, -1)
    r = ring_rule("gather", got, plain, xi, 3, torch.int32)
    readings.append({"kernel": "ring_all_gather", "W": 3, "size": 1_234_567,
                     "dtype": "torch.int32", "dir": -1, **r})
    if not r["ok"]:
        fail(f"ring_all_gather int32: {r}")
    emit("ring_ccl_vs_plain", readings=readings, launches=dict(rc.launch_counts))
    return {"cases": len(readings)}

def ring_planted_faults() -> None:
    """Faults made with the plain versions must fail the rule the kernels
    pass: RS with its last hop dropped, AG with every slot off by one, and
    B7 whose AG phase starts before its RS phase's last fold landed."""
    w, size, dtype = 4, 1_000_000, torch.float32
    x = ring_inputs(w, size, dtype, seed=11)
    r_idx = torch.arange(w, device=DEV)

    def rs_hops_but_last(buf):
        """The RS phase on [W, W, m] in place (direction +1), last hop left out."""
        for s in range(w - 2):
            send = (r_idx - (s + 1)) % w
            arrived = buf[r_idx, send].clone()
            buf[(r_idx + 1) % w, send] = buf[(r_idx + 1) % w, send] + arrived
        return buf

    faults = {}
    # RS without its last hop
    chunks, per, m = rc._dma.pad_chunks(x, w)
    buf = rs_hops_but_last(chunks.reshape(w, w, m).clone())
    ok_rs, _ = run_ring("scatter", x, 1)
    faults["rs: last hop dropped"] = ring_rule("scatter", buf[r_idx, r_idx][:, :per], ok_rs,
                                               x, w, dtype)
    # AG with each slot one off
    ok_ag, plain_ag = run_ring("gather", x, 1)
    shifted = plain_ag.reshape(w, w, size).roll(1, dims=1).reshape(w, -1)
    faults["ag: slot off by one"] = ring_rule("gather", shifted, ok_ag, x, w, dtype)
    # B7 whose AG phase forwards slots before the RS phase's last fold
    view, k, _ = rc._ar_layout(x, 1)
    ok_ar, _ = run_ring("reduce", x, 1, dirs=(1,))
    buf = rs_hops_but_last(view[:, :, 0].clone())
    rc._ag_hops(buf, 1)
    early = rc._ar_unlayout(buf.unsqueeze(2), k, x)
    faults["ar: no phase barrier data"] = ring_rule("reduce", early, ok_ar, x, w, dtype)
    passed = [name for name, r in faults.items() if r["ok"]]
    if passed:
        fail(f"planted ring faults pass the check: {passed}")
    emit("ring_ccl_planted_faults", W=w, size=size, readings=faults)

def ring_bound_ms(name, w, p_elems, itemsize) -> float:
    """Compulsory HBM bytes over 3.35 TB/s, each input read once and each
    output written once, with P the per-member payload: B7 reads W·P and
    writes W·P; B5 reads W·P and writes P (P/W per member); B4 reads P
    (P/W contributed per member) and writes W·P."""
    p = p_elems * itemsize
    nbytes = {"ring_all_reduce": 2 * w * p, "ring_reduce_scatter": (w + 1) * p,
              "ring_all_gather": (w + 1) * p}[name]
    return nbytes / PEAK_BYTES * 1e3

def ring_launchers(w, p_elems):
    """Preallocated operands at a per-member payload of ``p_elems`` f32 and
    a launch function per kernel (no sync, no check: the lanes are checked
    after timing), plus the plain version and the library call beside each."""
    g = torch.Generator(device=DEV).manual_seed(5)
    x = torch.randn((w, p_elems), generator=g, device=DEV)
    view, _, m_ar = rc._ar_layout(x, 2)
    ar_out, ar_stage = torch.empty_like(view), view.new_empty((w, 2, 2, m_ar))
    chunks, _, m_rs = rc._dma.pad_chunks(x, w)
    chunks = chunks.reshape(w, w, m_rs)
    rs_buf, rs_stage = torch.empty_like(chunks), chunks.new_empty((w, 2, m_rs))
    rs_out = chunks.new_empty((w, m_rs))
    contrib = x[:, : p_elems // w].contiguous()
    chunk, _, m_ag = rc._dma.pad_chunks(contrib, 1)
    chunk = chunk.reshape(w, m_ag)
    ag_out = chunk.new_empty((w, w, m_ag))
    lanes = []

    def launch(fn, *args):
        return lambda: lanes.append(fn(*args))

    red = torch.empty_like(x[0])
    ar_lib_out = torch.empty_like(x)
    xv = x[:, : p_elems - p_elems % w].reshape(w, w, -1)
    runs = {
        "ring_all_reduce": (launch(rc.launch_ar, view, ar_out, ar_stage, (1, -1), 0),
                            lambda: rc.ar_plain(view, (1, -1)),
                            lambda: ar_lib_out.copy_(torch.sum(x, 0, out=red).expand_as(x)),
                            "torch.sum(x, 0, out=red) then out.copy_(red.expand_as(x))"),
        "ring_reduce_scatter": (launch(rc.launch_rs, chunks, rs_buf, rs_stage, rs_out, 1, 0),
                                lambda: rc.rs_plain(chunks, 1),
                                lambda: xv.sum(0),
                                "x.view(W, W, P/W).sum(0)"),
        "ring_all_gather": (launch(rc.launch_ag, chunk, ag_out, 1, 0),
                            lambda: rc.ag_plain(chunk, 1),
                            lambda: contrib.reshape(1, -1).repeat(w, 1),
                            "x.reshape(1, P).repeat(W, 1)"),
    }
    return runs, lanes

def ring_timing() -> dict:
    """CUDA-event medians of each ring kernel at the gradient bucket, W = 4,
    beside its bound, its plain version and the library call; and a sweep of
    smaller payloads per member."""
    res = {}
    runs, lanes = ring_launchers(WORLD, BUCKET)
    for name, (kernel, plain, library, call) in runs.items():
        ms = time_ms(kernel, 10)
        bnd = ring_bound_ms(name, WORLD, BUCKET, 4)
        res[name] = dict(ms=ms, bound_ms=bnd, bound_by="bytes", share_of_bound=bnd / ms,
                         plain_ms=time_ms(plain, 3), library_ms=time_ms(library, 10),
                         library_call=call)
    for lane in lanes:
        lane.check("ring timing")
    del runs, lanes
    torch.cuda.empty_cache()
    sweep = []
    for mib in SWEEP_MIB:
        p = mib * 2 ** 20 // 4
        runs, lanes = ring_launchers(WORLD, p)
        for name, (kernel, _, library, _) in runs.items():
            ms = time_ms(kernel, 20)
            bnd = ring_bound_ms(name, WORLD, p, 4)
            sweep.append(dict(kernel=name, mib_per_member=mib, ms=ms, bound_ms=bnd,
                              share_of_bound=bnd / ms, library_ms=time_ms(library, 20)))
        for lane in lanes:
            lane.check("ring sweep")
    emit("ring_ccl_timing", W=WORLD, bucket_elems_per_member=BUCKET, dtype="float32",
         kernels=res, sweep=sweep,
         note="one card: every hop is an HBM-to-HBM store; no NVLink or bus-bandwidth claim")
    return res

def gradient_bucket() -> torch.Tensor:
    """The members' payloads [W, BUCKET]: each member's gradient of the
    bench-config flagship on its own batch (B=8, S=1024), flattened in
    parameter order."""
    cfg = flagship.bench_config()
    params = flagship.init_params(cfg, torch.Generator().manual_seed(0), DEV)
    leaves = [p.requires_grad_() for p in flagship.tree_leaves(params)]
    total = sum(p.numel() for p in leaves)
    if total != BUCKET:
        fail(f"bench config has {total} parameters, expected {BUCKET}")
    x = torch.empty((WORLD, BUCKET), device=DEV)
    for r in range(WORLD):
        tokens, targets = _batch_for_step(100 + r, BATCH, SEQ, cfg.vocab)
        loss, _ = flagship.loss_fn(params, torch.as_tensor(tokens, device=DEV),
                                   torch.as_tensor(targets, device=DEV), cfg)
        grads = torch.autograd.grad(loss, leaves)
        x[r].copy_(torch.cat([g.reshape(-1) for g in grads]))
        del grads, loss
    del params, leaves
    torch.cuda.empty_cache()
    if not torch.isfinite(x).all():
        fail("non-finite gradients in the bucket")
    return x

def plain_all_reduce(x, dirs):
    view, k, _ = rc._ar_layout(x, len(dirs))
    return rc._ar_unlayout(rc.ar_plain(view, dirs), k, x)

_SPLIT = (("ring_kernels", re.compile(r"ring_(ag|rs|ar)_kernel")),
          ("fill", re.compile(r"fill|memset", re.I)),
          ("copy", re.compile(r"copy|memcpy|cat", re.I)))

def verb_breakdown(verbs) -> list:
    """Where one verb call's time goes once its buffers exist: the host
    clock around warm calls (median of 3, ending in a sync), and one
    profiled warm call's device time split into the ring kernels, zero
    fills (``pad_chunks``' padded buffers), copies (into the padded layout,
    the cut back out, ``cat``) and other kernels, with the device's busy
    time (union of kernel intervals). The first call's excess over the warm
    median is first-use allocation."""
    out = []
    for verb, algo, run, cold_ms in verbs:
        warm = []
        for _ in range(3):
            t = time.perf_counter()
            got = run()
            torch.cuda.synchronize()
            warm.append((time.perf_counter() - t) * 1e3)
            del got
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            got = run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        del got
        split, spans = {name: 0.0 for name, _ in _SPLIT}, []
        split["other"] = 0.0
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            spans.append((ev.time_range.start, ev.time_range.end))
            cls = next((name for name, pat in _SPLIT if pat.search(ev.name)), "other")
            split[cls] += (ev.time_range.end - ev.time_range.start) / 1e3
        if not split["ring_kernels"]:
            fail(f"{verb} {algo}: the profiler saw no ring kernel")
        warm_ms = statistics.median(warm)
        out.append(dict(verb=verb, algo=algo, first_call_host_ms=cold_ms, warm_host_ms=warm_ms,
                        first_use_ms=cold_ms - warm_ms, profiled_host_ms=wall_ms,
                        device_ms=split, device_busy_ms=_union_ms(spans)))
    return out

def _union_ms(spans) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3

def collective_path() -> tuple:
    """The Communicator verbs at the gradient bucket, W = 4, through the
    kernels: each result against its plain counterpart, launches per call,
    and no fallback. Counts are set to 0 just before and read just after."""
    x = gradient_bucket()
    comm = Communicator(make_mesh(MeshConfig(dp=WORLD)), AXIS.DP)
    w = WORLD
    contrib = x[:, : BUCKET // w].contiguous()  # all-gather: P/W per member
    fb0 = dma.WIRE_FALLBACK.total()
    torch.cuda.synchronize()
    rc.reset_launch_counts()
    calls, errs = [], {name: 0.0 for name in rc.KERNELS}
    verbs = [
        ("all_reduce", "pallas", lambda: comm.all_reduce(x, algo="pallas"),
         lambda: plain_all_reduce(x, (1, -1)), {"ring_all_reduce": 1}),
        ("all_reduce", "bidir", lambda: comm.all_reduce(x, algo="bidir"),
         lambda: torch.cat([plain_all_reduce(h, (d,)) for h, d in
                            zip((x[:, : BUCKET // 2], x[:, BUCKET // 2:]), (1, -1))], 1),
         {"ring_all_reduce": 2}),
        ("all_gather", "ring", lambda: comm.all_gather(contrib, algo="ring"),
         lambda: contrib, {"ring_all_gather": 1}),
        ("all_gather", "bidir", lambda: comm.all_gather(contrib, algo="bidir"),
         lambda: contrib, {"ring_all_gather": 2}),
        ("reduce_scatter", "ring", lambda: comm.reduce_scatter(x, algo="ring"),
         lambda: rc.rs_plain(rc._dma.pad_chunks(x, w)[0].reshape(w, w, -1))[:, : BUCKET // w],
         {"ring_reduce_scatter": 1}),
        ("broadcast", "scatter_ag", lambda: comm.broadcast(x, 0, algo="scatter_ag"),
         lambda: x[0].expand_as(x), {"ring_all_gather": 2}),
    ]
    for verb, algo, run, plain, want in verbs:
        before = dict(rc.launch_counts)
        t = time.perf_counter()
        got = run()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) * 1e3
        delta = {k: rc.launch_counts[k] - before[k] for k in rc.KERNELS}
        expect = {k: want.get(k, 0) for k in rc.KERNELS}
        if delta != expect:
            fail(f"{verb} {algo}: launches {delta}, expected {expect}")
        ref = plain()
        if got.shape != ref.shape or not torch.isfinite(got).all():
            fail(f"{verb} {algo}: shape {tuple(got.shape)} vs {tuple(ref.shape)} or non-finite")
        err = (got - ref).abs().max().item()
        if not torch.equal(got, ref):
            fail(f"{verb} {algo}: differs from its plain counterpart (max abs {err})")
        for k, v in want.items():
            errs[k] = max(errs[k], err)
        calls.append(dict(verb=verb, algo=algo, launches=delta, host_ms=host_ms,
                          shape=list(got.shape), max_abs_err_vs_plain=err))
        del got, ref
    launches = dict(rc.launch_counts)
    fallbacks = dma.WIRE_FALLBACK.total() - fb0
    if fallbacks:
        fail(f"the collective path fell back {fallbacks} times")
    # The Communicator returns one member's copy of a gather; the kernels
    # write every member's. Hold all W copies at the bucket.
    for name, fn in (("ring", rc.ring_all_gather), ("bidir", rc.bidir_all_gather)):
        got = fn(contrib.unsqueeze(1)).reshape(w, -1)
        err = (got - contrib.reshape(1, -1)).abs().max().item()
        if not torch.equal(got, contrib.reshape(1, -1).expand(w, -1)):
            fail(f"all_gather {name}: a member's copy differs at the bucket (max abs {err})")
        errs["ring_all_gather"] = max(errs["ring_all_gather"], err)
        del got
    breakdown = verb_breakdown([(v, a, run, c["host_ms"])
                                for (v, a, run, _, _), c in zip(verbs, calls)])
    planner = plan.get_planner()
    auto = {
        "all_reduce": planner.plan_all_reduce((BUCKET,), x.dtype, w, pallas_ok=True,
                                              emit=False).algo,
        "all_gather": planner.plan_all_gather((BUCKET // w,), x.dtype, w, pallas_ok=True,
                                              emit=False).algo,
        "reduce_scatter": planner.plan_reduce_scatter((BUCKET,), x.dtype, w, pallas_ok=True,
                                                      emit=False).algo,
        "broadcast": planner.plan_broadcast((BUCKET,), x.dtype, w, pallas_ok=True,
                                            emit=False).algo,
    }
    emit("collective_path", W=w, bucket_elems_per_member=BUCKET,
         bucket_bytes_per_member=BUCKET * 4, calls=calls, launches=launches,
         fallbacks=fallbacks, auto_picks=auto, warm_breakdown=breakdown,
         peak_mem_gib=torch.cuda.max_memory_allocated(DEV) / 2**30)
    return launches, errs

def main() -> None:
    t_start = time.perf_counter()
    toolchain()
    build_kernels()
    readings, x, plain = check_kernels(8, 1024, 16, 4, 64, True, seed=0)  # main-path shape
    planted_faults(x, plain)
    del x, plain
    check_kernels(2, 256, 4, 4, 64, False, seed=1)  # small, non-causal, n_rep = 1
    errs = {"flash_fwd": readings["out"]["max_abs_err"],
            "flash_bwd_dq": readings["dq"]["max_abs_err"],
            "flash_bwd_dkv": max(readings["dk"]["max_abs_err"], readings["dv"]["max_abs_err"])}
    timing = time_kernels(8, 1024, 16, 4, 64)
    launches = main_path()
    torch.cuda.empty_cache()
    ring_vs_plain()
    ring_planted_faults()
    ring_time = ring_timing()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(DEV)
    ring_launches, ring_errs = collective_path()
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
         "bound_ms": timing[name]["bound_ms"], "bound_by": timing[name]["bound_by"],
         "library_ms": timing[name]["library_ms"],
         "library_call": timing[name]["library_call"]}
        for name in fa.KERNELS
    ] + [
        {"name": name, "route": "cuda", "source": RING_SOURCE, "replaces": RING_REPLACES[name],
         "launches": ring_launches[name], "max_abs_err": ring_errs[name],
         "ms": ring_time[name]["ms"], "plain_ms": ring_time[name]["plain_ms"],
         "bound_ms": ring_time[name]["bound_ms"], "bound_by": ring_time[name]["bound_by"],
         "library_ms": ring_time[name]["library_ms"],
         "library_call": ring_time[name]["library_call"]}
        for name in rc.KERNELS
    ]
    for k in kernels:
        if not k["launches"]:
            fail(f"kernel {k['name']} was not launched on its main path")
    emit("done", seconds=time.perf_counter() - t_start)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)

if __name__ == "__main__":
    if shutil.which("nvidia-smi") is None:
        sys.exit("chip_smoke.py: nvidia-smi not found")
    main()
