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
import shutil
import statistics
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: torch.cuda.is_available() is False; this script needs a GPU")

from uccl_tpu_torch.models import flagship  # noqa: E402
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

def build_kernels() -> None:
    t0 = time.perf_counter()
    lib = build.build("flash_attention")
    seconds = time.perf_counter() - t0
    ptxas, kernel = [], None
    for line in build.build_log("flash_attention").splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            kernel = name[name.find("flash_"):name.find("EEEv") + 3]
        elif "registers" in line and kernel:
            ptxas.append({"kernel": kernel, "registers": int(line.split("Used ")[1].split()[0])})
        elif "spill stores" in line and kernel:
            spills = int(line.split("bytes spill stores")[0].split(",")[-1])
            if spills:
                fail(f"{kernel} spills {spills} bytes")
    emit("build", library=str(lib.relative_to(build.PACKAGE_DIR.parent)),
         seconds=round(seconds, 3), ptxas=ptxas)

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
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
         "bound_ms": timing[name]["bound_ms"], "bound_by": timing[name]["bound_by"],
         "library_ms": timing[name]["library_ms"],
         "library_call": timing[name]["library_call"]}
        for name in fa.KERNELS
    ]
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
