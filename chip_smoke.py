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
the first two losses to the same steps through plain attention. Then the
collective plane at the model's gradient bucket over a 4-member world: the
ring kernels and the Communicator verbs, first on the full-precision wire,
then on the quantized one (fp8 and int8). Then the EP plane over a 4-member
world: the all-to-all kernels against their plain versions and the
transpose, their timing at the MoE layer's dispatch buffer, and the
DeepEP-shaped Buffer verbs through layer 0 of the bench config on every
wire. Every phase raises on failure; nothing is caught. Each phase prints one JSON line; the
last three lines are the card's name and power limit (nvidia-smi), the
per-kernel JSON summary and

    {"ok": true, "device": {"platform": "gpu", "kind": "<GPU name>", "count": 1}}

It exits non-zero, before printing anything, when PyTorch sees no GPU.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: torch.cuda.is_available() is False; this script needs a GPU")

from uccl_tpu_torch import profile_ep  # noqa: E402
from uccl_tpu_torch.collective import Communicator, dma, plan  # noqa: E402
from uccl_tpu_torch.collective import ring_ccl as rc  # noqa: E402
from uccl_tpu_torch.ep import Buffer, a2a_sched  # noqa: E402
from uccl_tpu_torch.ep import ll as ep_ll  # noqa: E402
from uccl_tpu_torch.ep import ops as ep_ops  # noqa: E402
from uccl_tpu_torch.ep import pallas_a2a as pa  # noqa: E402
from uccl_tpu_torch.models import flagship  # noqa: E402
from uccl_tpu_torch.parallel.mesh import AXIS, MeshConfig, make_mesh  # noqa: E402
from uccl_tpu_torch.models.layers import rms_norm, rope  # noqa: E402
from uccl_tpu_torch.ops import flash_attention as fa  # noqa: E402
from uccl_tpu_torch.ops import quant  # noqa: E402
from uccl_tpu_torch.ops.attention import _NEG_INF, HOPPER_TILES, _repeat_kv  # noqa: E402
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
    """Registers, spills and static shared memory per kernel from nvcc's
    -Xptxas -v report (``short`` cuts the mangled name); fails on spills and
    on wgmma serialized for want of registers (ptxas warning C7512)."""
    ptxas, kernel, spills = [], None, 0
    for line in build.build_log(source).splitlines():
        if "C7512" in line:
            fail(f"ptxas: {line.strip()}")
        if "Compiling entry function" in line:
            kernel = short(line.split("'")[1])
        elif "spill stores" in line and kernel:
            spills = int(line.split("bytes spill stores")[0].split(",")[-1])
            if spills:
                fail(f"{kernel} spills {spills} bytes")
        elif "registers" in line and kernel:
            smem = re.search(r"(\d+) bytes smem", line)
            ptxas.append({"kernel": kernel, "registers": int(line.split("Used ")[1].split()[0]),
                          "spill_bytes": spills, "static_smem": int(smem[1]) if smem else 0})
    return ptxas

def ring_kernel_name(mangled: str) -> str:
    """A ring kernel's name and template arguments from its mangled name
    (which names the source file, ``ring_ccl_cu``, first)."""
    m = re.search(r"ring_[a-z]+_kernel\w*", mangled)
    return m[0] if m else mangled

def build_kernels() -> None:
    """The three CUDA sources, one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor

    def timed(name):
        t0 = time.perf_counter()
        return build.build(name), time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(timed, name) for name in ("flash_attention", "ring_ccl", "ep_a2a")]
        (lib, seconds), (ring_lib, ring_seconds), (ep_lib, ep_seconds) = \
            [j.result() for j in jobs]
    root = build.PACKAGE_DIR.parent
    name = re.compile(r"flash_(fwd|bwd_dq|bwd_dkv)_kernelILi\d+ELi\d+E")
    ptxas = ptxas_report("flash_attention", lambda n: name.search(n)[0])
    for k in ptxas:  # each kernel's resident tiles and ring of stages are dynamic shared memory
        m = re.match(r"flash_(fwd|bwd_dq|bwd_dkv)_kernelILi(\d+)ELi(\d+)E", k["kernel"])
        d, tile = int(m[2]), int(m[3])
        k["dynamic_smem"] = (fa._lib().uccl_flash_fwd_smem(d, tile) if m[1] == "fwd" else
                             fa._lib().uccl_flash_bwd_smem(int(m[1] == "bwd_dkv"), d, tile))
    emit("build", library=str(lib.relative_to(root)), seconds=round(seconds, 3), ptxas=ptxas)
    # every ring kernel is built for two blocks of 512 threads per SM
    # (__launch_bounds__), so ptxas caps it at 64 registers and would spill
    # past them: ptxas_report's spill check is what guards the occupancy
    ring_ptxas = ptxas_report("ring_ccl", ring_kernel_name)
    emit("ring_ccl_build", library=str(ring_lib.relative_to(root)),
         seconds=round(ring_seconds, 3), all_seconds=round(time.perf_counter() - t0, 3),
         ptxas=ring_ptxas)
    emit("ep_a2a_build", library=str(ep_lib.relative_to(root)), seconds=round(ep_seconds, 3),
         ptxas=ptxas_report("ep_a2a", lambda n: "sched_round_kernel" if "sched_round" in n
                            else "a2a_kernel"))

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

def dq_without_kv_tile(q, k, v, dout, lse, delta, tile, rows=64):
    """The causal dQ had it skipped KV tile ``tile`` for every q row past
    that tile."""
    _, ds, n_rep = fa._plain_p_ds(q, k, v, dout, lse, delta, True)
    ds[:, :, (tile + 1) * rows:, tile * rows:(tile + 1) * rows] = 0
    return torch.einsum("bhqk,bkhd->bqhd", ds, _repeat_kv(k.float(), n_rep)).to(q.dtype)

def planted_faults(x, plain) -> None:
    """The readings of faults the check must reject, at the same inputs
    (made with the plain version): a forward and a dQ that drop KV tile 1, a
    dK/dV pass that drops q tile 1, and one whose GQA sum drops query head 1
    of each KV head's group; and the dQ and dK/dV kernels run with the lse
    cotangent left out of delta. Fails if any would pass."""
    q, k, v, dout = x["q"], x["k"], x["v"], x["dout"]
    lse, delta = plain["lse"], plain["delta"]
    delta_no_glse = fa.flash_delta(plain["out"], dout)
    rows = slice(64, 128)
    dout_drop, delta_drop = dout.clone(), delta.clone()
    dout_drop[:, rows], delta_drop[:, :, rows] = 0, 0
    dk_drop, dv_drop = fa.flash_bwd_dkv_plain(q, k, v, dout_drop, lse, delta_drop, True)
    n_rep = q.shape[2] // k.shape[2]
    heads = torch.arange(q.shape[2], device=DEV) % n_rep == 1  # query head 1 of each group
    dout_head, delta_head = dout.clone(), delta.clone()
    dout_head[:, :, heads], delta_head[:, heads] = 0, 0
    dk_head, dv_head = fa.flash_bwd_dkv_plain(q, k, v, dout_head, lse, delta_head, True)
    dk_glse, dv_glse = fa.flash_bwd_dkv(q, k, v, dout, lse, delta_no_glse, True)
    faults = {
        "out: KV tile 1 dropped": (out_without_kv_tile(q, k, v, 1), plain["out"]),
        "dq: KV tile 1 dropped": (dq_without_kv_tile(q, k, v, dout, lse, delta, 1),
                                  plain["dq"]),
        "dk: q tile 1 dropped": (dk_drop, plain["dk"]),
        "dv: q tile 1 dropped": (dv_drop, plain["dv"]),
        "dk: GQA query head 1 dropped": (dk_head, plain["dk"]),
        "dv: GQA query head 1 dropped": (dv_head, plain["dv"]),
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
    # The kernels' arms beside the library's: both CTA tiles, causal or not
    # (twice the tiles per CTA, the same CTAs), and twice the batch (twice
    # the CTAs). B1 beside SDPA; B2 and B3 beside the flash backward.
    arms, bwd_arms = {}, {}
    for causal, bb in ((True, b), (False, b), (True, 2 * b)):
        xa = x if bb == b else attn_inputs(bb, s, h, hkv, d, seed=3)
        qa, ka, va, da = xa["q"], xa["k"], xa["v"], xa["dout"]
        for bq in HOPPER_TILES:
            arms[f"B1 B={bb} causal={causal} block_q={bq}"] = time_ms(
                lambda: fa.flash_fwd(qa, ka, va, causal, bq), 20)
        qs, ks, vs = (t.repeat_interleave(rep, dim=2) if t is not qa else t for t in (qa, ka, va))
        qs, ks, vs, gs = (t.transpose(1, 2) for t in (qs, ks, vs, da))
        arms[f"SDPA B={bb} causal={causal}"] = time_ms(
            lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal), 20)
        oa, la = fa.flash_fwd(qa, ka, va, causal)
        dla = fa.flash_delta(oa, da)
        for tile in HOPPER_TILES:
            bwd_arms[f"B2 B={bb} causal={causal} block_q={tile}"] = time_ms(
                lambda: fa.flash_bwd_dq(qa, ka, va, da, la, dla, causal, tile), 20)
            bwd_arms[f"B3 B={bb} causal={causal} block_k={tile}"] = time_ms(
                lambda: fa.flash_bwd_dkv(qa, ka, va, da, la, dla, causal, tile), 20)
        o, lse_l, cq, ck, mq, mk, seed, offset, _ = \
            torch.ops.aten._scaled_dot_product_flash_attention(qs, ks, vs, 0.0, causal)
        bwd_arms[f"library bwd B={bb} causal={causal}"] = time_ms(
            lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
                gs, qs, ks, vs, o, lse_l, cq, ck, mq, mk, 0.0, causal, seed, offset), 20)
    emit("kernel_timing", shape=dict(B=b, S=s, H=h, Hkv=hkv, D=d, causal=True),
         kernels=res, ours_bwd_ms=res["flash_bwd_dq"]["ms"] + res["flash_bwd_dkv"]["ms"],
         library_bwd_ms=lib_bwd_ms, library_dq_norm_ratio_vs_ours=lib_dq_norm_ratio,
         b1_arms=arms, bwd_arms=bwd_arms)
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
    "ring_reduce_scatter_q": "uccl_tpu/collective/pallas_ccl.py:621",
    "ring_all_reduce_q": "uccl_tpu/collective/pallas_ccl.py:742",
}
FULL_PRECISION = ("ring_all_gather", "ring_reduce_scatter", "ring_all_reduce")
QUANTIZED = {"ring_reduce_scatter_q": "ring_reduce_scatter",  # its full-precision twin
             "ring_all_reduce_q": "ring_all_reduce"}
WIRES = ("fp8", "int8")
UNIT_ROUNDOFF = {torch.float32: 2.0 ** -24, torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11,
                 torch.int32: 0.0}  # int32 sums of these inputs are exact

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
    """One kernel launch and its plain version on ``x`` [W, N] (unpadded
    rows, at any stride); returns the per-member results (kernel, plain) in
    the rule's layout. B4's, B5's and B7's plain versions are their one-pass
    contracts, each held here to the ring's hop schedule on padded slots."""
    w, size = x.shape
    if kind == "gather":  # B4: member r contributes row r
        lane, got = rc._ag_kernel(x, 0)
        lane.check("ring_all_gather")
        plain = rc.ag_rows_plain(x)
        chunk, _, m = rc._dma.pad_chunks(x, 1)
        if not torch.equal(plain, rc.ag_plain(chunk.reshape(w, m), d)[:, :, :size]):
            fail(f"ag_rows_plain differs from ag_plain's hops at W={w}, {size} elements")
        return got.reshape(w, -1), plain.reshape(w, -1)
    if kind == "scatter":  # B5 on the unpadded rows; its plain version equals the hops'
        lane, got = rc._rs_kernel(x, d, 0)
        lane.check("ring_reduce_scatter")
        plain = rc.rs_chain_plain(x, d)
        chunks, per, m = rc._dma.pad_chunks(x, w)
        if not torch.equal(plain, rc.rs_plain(chunks.reshape(w, w, m), d)[:, :per]):
            fail(f"rs_chain_plain differs from rs_plain's hops at W={w}, {size} elements")
        return got, plain
    lane, got = rc._ar_kernel(x, dirs, 0)  # B7
    lane.check("ring_all_reduce")
    plain = rc.ar_chain_plain(x, dirs)
    if not torch.equal(plain, plain_all_reduce(x, dirs)):
        fail(f"ar_chain_plain differs from ar_plain's hops at W={w}, {size} elements, {dirs}")
    return got, plain

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
# B5 on contiguous payloads whose slot starts k·per·itemsize are off 16
# bytes: (W, per, dtype, direction). Rows 16-byte aligned (vectors between a
# ragged head and tail) except W = 2 f32, W = 3 bf16 and W = 5 int32 (the
# terms offset differently: funnel-shifted vectors)
RS_RAGGED = [
    (4, 1_000_001, torch.float32, 1),
    (8, 300_003, torch.bfloat16, -1),
    (4, 777_777, torch.int32, 1),
    (8, 123_457, torch.float16, -1),
    (2, 500_001, torch.float32, -1),
    (3, 333_335, torch.bfloat16, 1),
    (5, 65_539, torch.int32, -1),
]
# B4 and B7 on payloads whose chunks start off 16 bytes: (W, elements per
# member, dtype, direction), each on three views of one [W, size + 1]
# tensor: contiguous rows, the same rows at a stride one element longer
# (rows offset differently mod 16), and a payload starting one element in.
# The W outputs of a B7 chunk or a B4 slot then lie at different offsets
# mod 16 wherever size·itemsize is no multiple of 16. (8, 11) leaves chunks
# empty; (16, 333) is the largest world.
DIRECT_RAGGED = [
    (2, 500_001, torch.float32, -1),
    (3, 333_335, torch.bfloat16, 1),
    (4, 1_000_001, torch.float32, 1),
    (4, 777_777, torch.int32, -1),
    (5, 65_539, torch.int32, 1),
    (7, 9_999, torch.float16, 1),
    (8, 123_457, torch.float16, -1),
    (8, 300_003, torch.bfloat16, 1),
    (8, 11, torch.bfloat16, -1),
    (16, 333, torch.float32, -1),
]

# B6 and B8 on slots, chunks and rows off 16 bytes: (W, elements per slot,
# dtype, direction), each on ragged_views of one [W, W*per + 1] tensor, and
# B8 on the two halves of one output at an odd split. Slot starts lie an
# odd number of elements apart (16-bit types: single-element units), rows
# at other offsets mod 16 in the strided and offset views; (16, 333) is the
# largest world, its slots under three rows long.
Q_RAGGED = [
    (2, 500_001, torch.float32, -1),
    (3, 333_335, torch.bfloat16, 1),
    (4, 250_001, torch.float32, 1),
    (5, 65_539, torch.float16, -1),
    (8, 123_457, torch.bfloat16, -1),
    (16, 333, torch.float32, 1),
]

def ragged_views(x):
    """Three [W, size] views of ``x`` [W, size + 1] (DIRECT_RAGGED)."""
    w, size = x.shape[0], x.shape[1] - 1
    return (("contiguous", x[:, 1:].contiguous()), ("strided rows", x[:, 1:]),
            ("offset start", x.reshape(-1)[1: 1 + w * size].view(w, size)))

def bidir_halves(x, d):
    """B7 (two one-stream launches, directions +1 and -1) and B4 (two
    launches) on the halves of ``x`` [W, size], each pair writing one
    output; the B4 pair's output is filled with 0xFF bytes first, so a
    column it misses shows. Returns ((B7 out, plain), (B4 out, plain))."""
    w, size = x.shape
    half = size // 2
    ar = x.new_empty((w, size))
    ag = x.new_empty((w, w, size))
    ag.view(torch.uint8).fill_(0xFF)
    lanes = [rc.launch_ar(x[:, :half], ar[:, :half], (1,), 0),
             rc.launch_ar(x[:, half:], ar[:, half:], (-1,), 1),
             rc.launch_ag(x[:, :half], ag[:, :, :half], 2),
             rc.launch_ag(x[:, half:], ag[:, :, half:], 3)]
    for lane in lanes:
        lane.check("bidir halves")
    ar_plain = torch.cat([rc.ar_chain_plain(x[:, :half], (1,)),
                          rc.ar_chain_plain(x[:, half:], (-1,))], 1)
    return (ar, ar_plain), (ag.reshape(w, -1), rc.ag_rows_plain(x).reshape(w, -1))

def ring_vs_plain() -> dict:
    """Each ring kernel against its plain version, bit for bit, and against
    the float64 sum; W in {2, 3, 4, 8}, f32 and bf16 (int32 for B4 too),
    sizes that need padding, both directions, B7 with one and two streams;
    B4 and B7 (against ``ag_rows_plain`` / ``ar_chain_plain``, each held to
    its hop schedule) and B5 (against ``rs_chain_plain`` and ``rs_plain``)
    also on strided rows and on chunks or slots whose starts are off 16
    bytes, in f32, bf16, f16 and int32, W 2-16, and B4 and B7 on the halves
    of one output, as the bidir pairs write them."""
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
    for w, per, dtype, d in RS_RAGGED:
        x = ring_inputs(w, w * per, dtype, seed=per)
        got, plain = run_ring("scatter", x, d)
        r = ring_rule("scatter", got, plain, x, w, dtype)
        readings.append({"kernel": "ring_reduce_scatter ragged slots", "W": w, "per": per,
                         "dtype": str(dtype), "dir": d, **r})
        if not r["ok"]:
            fail(f"ring_reduce_scatter W={w} per={per} {dtype} dir={d}: {r}")
    for w, size, dtype, d in DIRECT_RAGGED:
        x = ring_inputs(w, size + 1, dtype, seed=size)
        for view, xs in ragged_views(x):
            cases = [("ring_all_gather", "gather", dict()),
                     ("ring_all_reduce S=1", "reduce", dict(dirs=(d,))),
                     ("ring_all_reduce S=2", "reduce", dict(dirs=(1, -1)))]
            for name, kind, kw in cases:
                got, plain = run_ring(kind, xs, d, **kw)
                r = ring_rule(kind, got, plain, xs, w, dtype)
                readings.append({"kernel": f"{name} {view}", "W": w, "size": size,
                                 "dtype": str(dtype), "dir": d, **r})
                if not r["ok"]:
                    fail(f"{name} {view} W={w} size={size} {dtype} dir={d}: {r}")
        (ar, ar_plain), (ag, ag_plain) = bidir_halves(x[:, 1:], d)
        for name, kind, got, plain in (("ring_all_reduce bidir halves", "reduce", ar, ar_plain),
                                       ("ring_all_gather bidir halves", "gather", ag, ag_plain)):
            r = ring_rule(kind, got, plain, x[:, 1:], w, dtype)
            readings.append({"kernel": name, "W": w, "size": size, "dtype": str(dtype), **r})
            if not r["ok"]:
                fail(f"{name} W={w} size={size} {dtype}: {r}")
        del x
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
    pass: RS with its last hop dropped, AG with every slot off by one, B7
    whose AG phase starts before its RS phase's last fold landed, two of
    B5's own: the members summed in ascending order instead of the chain's
    (bf16), and slots whose misaligned starts are read one element off; and
    three of the one-pass B7 and B4: B7's members summed in ascending order
    (bf16), B7's stream 1 summed in direction +1, and B4's output with one
    member's slot left as it was in a 0xFF-filled buffer."""
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
    # B5 summing its members in ascending order, not the chain's
    xb = ring_inputs(w, size, torch.bfloat16, seed=12)
    ok_b, _ = run_ring("scatter", xb, 1)
    slots = xb.reshape(w, w, -1)
    ascending = slots[0, r_idx]
    for j in range(1, w):
        ascending = ascending + slots[j, r_idx]
    faults["rs: members in ascending order (bf16)"] = ring_rule("scatter", ascending, ok_b, xb,
                                                               w, torch.bfloat16)
    # B5 reading slots k >= 1 (starts 4k bytes off 16) one element late
    per = 250_001
    xm = ring_inputs(w, w * per, dtype, seed=13)
    ok_m, _ = run_ring("scatter", xm, 1)
    late = rc.rs_chain_plain(xm, 1)
    late[1:] = rc.rs_chain_plain(xm.roll(-1, 1), 1)[1:]
    faults["rs: misaligned slots read one element off"] = ring_rule("scatter", late, ok_m, xm, w,
                                                                   dtype)
    # B7 summing its members in ascending order, and B7 summing stream 1 in
    # direction +1 (bf16)
    ok_ar2, _ = run_ring("reduce", xb, 1, dirs=(1, -1))
    ascending = xb[0]
    for j in range(1, w):
        ascending = ascending + xb[j]
    faults["ar: members in ascending order (bf16)"] = ring_rule(
        "reduce", ascending.expand(w, -1), ok_ar2, xb, w, torch.bfloat16)
    faults["ar: stream 1 summed in direction +1 (bf16)"] = ring_rule(
        "reduce", rc.ar_chain_plain(xb, (1, 1)), ok_ar2, xb, w, torch.bfloat16)
    # B4 with member 1's slot 2 as a 0xFF-filled output held it before
    left = x.new_empty((w, w, size))
    left.view(torch.uint8).fill_(0xFF)
    rc.launch_ag(x, left, 0).check("ring_all_gather")
    left[1, 2].view(torch.uint8).fill_(0xFF)
    faults["ag: a slot left from a 0xFF-filled buffer"] = ring_rule(
        "gather", left.reshape(w, -1), ok_ag, x, w, dtype)
    del left
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
    ar_out = torch.empty_like(x)
    xs = x[:, : p_elems - p_elems % w]
    rs_out = x.new_empty((w, xs.shape[1] // w))
    contrib = x[:, : p_elems // w].contiguous()
    ag_out = contrib.new_empty((w, w, contrib.shape[1]))
    lanes = []

    def launch(fn, *args):
        return lambda: lanes.append(fn(*args))

    red = torch.empty_like(x[0])
    ar_lib_out = torch.empty_like(x)
    xv = xs.reshape(w, w, -1)
    runs = {
        "ring_all_reduce": (launch(rc.launch_ar, x, ar_out, (1, -1), 0),
                            lambda: rc.ar_chain_plain(x, (1, -1)),
                            lambda: ar_lib_out.copy_(torch.sum(x, 0, out=red).expand_as(x)),
                            "torch.sum(x, 0, out=red) then out.copy_(red.expand_as(x))"),
        "ring_reduce_scatter": (launch(rc.launch_rs, xs, rs_out, 1, 0),
                                lambda: rc.rs_chain_plain(xs, 1),
                                lambda: xv.sum(0),
                                "x.view(W, W, P/W).sum(0)"),
        "ring_all_gather": (launch(rc.launch_ag, contrib, ag_out, 0),
                            lambda: rc.ag_rows_plain(contrib),
                            lambda: contrib.reshape(1, -1).repeat(w, 1),
                            "x.reshape(1, P).repeat(W, 1)"),
    }
    return runs, lanes

def rows_off_16(name) -> dict:
    """B5 or B7 (two streams) on a bf16 bucket of the f32 bucket's bytes
    whose row length is 4 mod 8 elements, so the rows lie alternately 0 and
    8 bytes off 16: B5 reads every other term as funnel-shifted vectors, and
    each B7 chunk's W outputs fall in two classes, whose vectors it computes
    once each (the second time from L2). Its time beside its bound and the
    library call, and its bits against its plain version."""
    p = 2 * BUCKET - WORLD  # a multiple of W, 4 mod 8
    g = torch.Generator(device=DEV).manual_seed(6)
    x = torch.randn((WORLD, p), generator=g, device=DEV, dtype=torch.bfloat16)
    lanes = []
    if name == "ring_reduce_scatter":
        out = x.new_empty((WORLD, p // WORLD))
        ms = time_ms(lambda: lanes.append(rc.launch_rs(x, out, 1, 0)), 10)
        plain = rc.rs_chain_plain(x, 1)
        library = lambda: x.view(WORLD, WORLD, -1).sum(0)  # noqa: E731
    else:
        out, red, lib_out = torch.empty_like(x), torch.empty_like(x[0]), torch.empty_like(x)
        ms = time_ms(lambda: lanes.append(rc.launch_ar(x, out, (1, -1), 0)), 10)
        plain = rc.ar_chain_plain(x, (1, -1))
        library = lambda: lib_out.copy_(torch.sum(x, 0, out=red).expand_as(x))  # noqa: E731
    for lane in lanes:
        lane.check("ring timing, rows off 16 bytes")
    if not torch.equal(out, plain):
        fail(f"{name} on bf16 rows off 16 bytes differs from its plain version")
    del plain
    bnd = ring_bound_ms(name, WORLD, p, 2)
    library_ms = time_ms(library, 10)
    res = dict(dtype="bfloat16", elems_per_member=p, ms=ms, bound_ms=bnd,
               share_of_bound=bnd / ms, library_ms=library_ms)
    del x, out, library
    torch.cuda.empty_cache()
    return res

def ring_timing() -> dict:
    """CUDA-event medians of each ring kernel at the gradient bucket, W = 4,
    beside its bound, its plain version and the library call; B5 and B7
    also on a bf16 bucket whose rows are offset differently mod 16 bytes;
    and a sweep of smaller payloads per member."""
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
    res["ring_reduce_scatter"]["rows_off_16"] = rows_off_16("ring_reduce_scatter")
    res["ring_all_reduce"]["rows_off_16"] = rows_off_16("ring_all_reduce")
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

_SPLIT = (("ring_kernels", re.compile(r"ring_(ag|rs|ar|rsq|arq)_kernel")),
          ("readback", re.compile(r"DtoH|Device -> P", re.I)),
          ("fill", re.compile(r"fill|memset", re.I)),
          ("copy", re.compile(r"copy|memcpy|cat", re.I)))

def verb_breakdown(verbs) -> list:
    """Where one verb call's time goes once its buffers exist: the host
    clock around warm calls (median of 3, ending in a sync), and one
    profiled warm call's device time split into the ring kernels, the
    error words' read back to the host, zero fills (``pad_chunks``' padded
    buffers), copies (into the padded layout, the cut back out, ``cat``) and
    other kernels (for a quantized all-gather or broadcast: the codec's
    torch passes), with the device's busy time
    (union of kernel intervals). The first call's excess over the warm
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
        # The verb's launches are counted by collective_path / quant_path; a
        # trace with no ring kernel in it is a trace the profiler lost
        # (seen on the card now and then), so the profiled call is taken
        # again, up to three times in all, before the phase fails.
        for attempt in range(1, 4):
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
            if split["ring_kernels"]:
                break
        else:
            fail(f"{verb} {algo}: the profiler saw no ring kernel in {attempt} traces")
        warm_ms = statistics.median(warm)
        out.append(dict(verb=verb, algo=algo, first_call_host_ms=cold_ms, warm_host_ms=warm_ms,
                        first_use_ms=cold_ms - warm_ms, profiled_host_ms=wall_ms,
                        device_ms=split, device_busy_ms=profile_ep.union_ms(spans),
                        profile_attempts=attempt))
    return out

def collective_path(x) -> tuple:
    """The Communicator verbs at the gradient bucket ``x`` [W, BUCKET], W = 4,
    through the kernels: each result against its plain counterpart, launches
    per call, and no fallback. Counts are set to 0 just before and read just
    after. Also returns what the quantized path is held against: one
    member's all-reduce result, the reduce-scatter result, and each verb's
    wire bytes (``ep_bytes_total``)."""
    comm = Communicator(make_mesh(MeshConfig(dp=WORLD)), AXIS.DP)
    w = WORLD
    contrib = x[:, : BUCKET // w].contiguous()  # all-gather: P/W per member
    fb0 = dma.WIRE_FALLBACK.total()
    torch.cuda.synchronize()
    rc.reset_launch_counts()
    calls, errs, refs = [], {name: 0.0 for name in FULL_PRECISION}, {"wire_bytes": {}}
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
        before, bytes0 = dict(rc.launch_counts), rc._WIRE_BYTES.total()
        t = time.perf_counter()
        got = run()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) * 1e3
        refs["wire_bytes"][verb, algo] = rc._WIRE_BYTES.total() - bytes0
        if (verb, algo) == ("all_reduce", "pallas"):
            refs["all_reduce"] = got[0].clone()
        elif verb == "reduce_scatter":
            refs["reduce_scatter"] = got.clone()
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
    # B4, B5 and B7 take the payload as it is and write each result in its
    # final place: no verb fills or copies (a pair's check stacks its two
    # error words, a cat of a few microseconds)
    for b in breakdown:
        if b["device_ms"]["fill"] > 0 or b["device_ms"]["copy"] > 0.05:
            fail(f"{b['verb']} {b['algo']}: fills or copies on the card {b['device_ms']}")
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
    return launches, errs, refs

# ---------------------------------------------------------------------------
# 7. The quantized wire: ring kernels B6, B8 and every verb's wire_dtype

def same(a, b) -> bool:
    """Bit-identical, a nan equal to a nan (a poisoned block is nan in both)."""
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())

def row_max(a, parts, split=None):
    """``a`` [..., N] → the max of each 128-lane row of the ring layout its
    values ride in (``parts`` padded chunks per member; with ``split``, the
    payload's elements before it and after it each laid out on their own,
    as the bidir pairs lay out their halves), at every element of the
    row."""
    if split is not None:
        return torch.cat([row_max(a[..., :split], parts), row_max(a[..., split:], parts)], -1)
    view, k, m = dma.pad_chunks(a, parts)  # [..., parts, rows, 128]
    rm = view.amax(-1, keepdim=True).expand_as(view)
    return rm.reshape(*a.shape[:-1], parts, m)[..., :k].reshape(*a.shape[:-1], -1)[
        ..., : a.shape[-1]]

def quant_bound(a_row, trips, wd, w, dtype):
    """The error budget of ``trips`` quantize round trips whose blocks'
    amax is at most ``a_row`` (the row max of the members' summed absolute
    values): each trip at most amax / ROUND_TRIP_DIVISOR, a partial sum's
    amax above ``a_row`` by at most the error so far, plus the input
    dtype's rounding of the W-1 adds and of the dequantized values."""
    div = quant.ROUND_TRIP_DIVISOR[wd]
    return a_row.double() * (trips / div * (1 + trips / div)
                             + (w + trips) * UNIT_ROUNDOFF[dtype])

def ring_q_rule(kind, got, plain, x, w, dtype, wd, parts, split=None) -> dict:
    """The check a quantized ring kernel's output passes, on the members'
    unpadded rows ``x`` [W, N]: equal to its plain version bit for bit;
    where the members' values are finite, within the round-trip budget of
    the float64 sum (W-1 trips for B6, W for B8), each element's amax that
    of its 128-element row of the ring layout (``parts`` chunks a row, or
    each side of ``split`` cut so on its own: see row_max); non-finite wherever the
    float64 sum is; and, for B8, every member's copy the same. ``got`` and
    ``plain`` are B6's [W, N/W] or B8's [W, N]."""
    r = {"bit_identical": same(got, plain)}
    exact = x.double().sum(0)
    a_row = row_max(x.abs().double().sum(0), parts, split)
    trips = w - 1 if kind == "scatter" else w
    bound = quant_bound(a_row, trips, wd, w, dtype)
    if kind == "scatter":  # member r holds slot r
        exact, bound, a_row = (t.reshape(w, -1) for t in (exact, bound, a_row))
        mine = got.double()
    else:
        mine = got.double()[0]
        r["members_identical"] = all(same(got[i], got[0]) for i in range(1, w))
    finite = torch.isfinite(a_row)
    err = (mine - exact).abs()
    r["worst_over_bound"] = (err[finite] / bound[finite].clamp_min(1e-300)).max().item()
    r["nonfinite_kept"] = bool((~torch.isfinite(mine[~torch.isfinite(exact)])).all())
    r["ok"] = (r["bit_identical"] and r["nonfinite_kept"] and r.get("members_identical", True)
               and bool((err[finite] <= bound[finite]).all()))
    return r

def ring_q_inputs(w, size, dtype, seed):
    """Members' payloads whose 128-element blocks span magnitudes of e^±3,
    so that a row's scale matters."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    mag = torch.exp(3 * torch.randn((w, size // 128 + 1), generator=g, device=DEV))
    x = torch.randn((w, size), generator=g, device=DEV)
    return (x * mag.repeat_interleave(128, 1)[:, :size]).to(dtype)

def run_ring_q(kind, x, d, wd, dirs=None):
    """One B6 or B8 launch on the unpadded rows ``x`` [W, N] (at any stride
    and offset) and its plain version, the one-pass contract
    (``rs_q_chain_plain`` / ``ar_q_chain_plain``), which is first held to
    the ring's hop schedule on padded slots (``rs_q_plain`` /
    ``ar_q_plain``). Returns (kernel, plain, parts: the chunks a row is cut
    into)."""
    w, size = x.shape
    if kind == "scatter":
        lane, got = rc._rs_kernel(x, d, 0, wd)
        lane.check("ring_reduce_scatter_q")
        plain = rc.rs_q_chain_plain(x, d, wd)
        chunks, per, m = dma.pad_chunks(x, w)
        if not same(plain, rc.rs_q_plain(chunks.reshape(w, w, m), d, wd)[:, :per]):
            fail(f"rs_q_chain_plain differs from rs_q_plain's hops at W={w}, {size}, {wd}")
        return got, plain, w
    lane, got = rc._ar_kernel(x, dirs, 0, wd)
    lane.check("ring_all_reduce_q")
    plain = rc.ar_q_chain_plain(x, dirs, wd)
    view, k, _ = rc._ar_layout(x, len(dirs))
    if not same(plain, rc._ar_unlayout(rc.ar_q_plain(view, dirs, wd), k, x)):
        fail(f"ar_q_chain_plain differs from ar_q_plain's hops at W={w}, {size}, {dirs}, {wd}")
    return got, plain, w * len(dirs)

def ring_q_vs_plain() -> dict:
    """B6 and B8 on the members' unpadded rows against their one-pass
    contracts (bit for bit; each contract held first to its hop schedule on
    padded slots) and the float64 sum (within the round-trip budget): the
    ring cases' worlds, dtypes, sizes and directions, fp8 and int8, B8 with
    one and two streams; on slots, chunks and rows off 16 bytes (f32, bf16
    and f16: contiguous, strided rows and an offset start); B8 on the two
    halves of one output at an odd split, as the bidir pair writes them;
    then a payload with an inf, a nan, an all-zero and a denormal row."""
    rc.reset_launch_counts()
    readings, worst = [], 0.0

    def hold(name, kind, got, plain, xs, w, dtype, d, wd, parts, split=None):
        nonlocal worst
        r = ring_q_rule(kind, got, plain, xs, w, dtype, wd, parts, split)
        readings.append({"kernel": name, "W": w, "size": xs.shape[1], "dtype": str(dtype),
                         "dir": d, "wire": wd, "split": split, **r})
        if not r["ok"]:
            fail(f"{name} W={w} size={xs.shape[1]} {dtype} dir={d} {wd} split={split}: {r}")
        worst = max(worst, torch.nan_to_num(got.double() - plain.double()).abs().max().item())

    for w, size, dtype, d in RING_CASES:
        x = ring_q_inputs(w, size, dtype, seed=20 + w)
        for wd in WIRES:
            for name, kind, kw in (("ring_reduce_scatter_q", "scatter", dict()),
                                   ("ring_all_reduce_q S=1", "reduce", dict(dirs=(d,))),
                                   ("ring_all_reduce_q S=2", "reduce", dict(dirs=(1, -1)))):
                xin = x[:, : size - size % w] if kind == "scatter" else x
                got, plain, parts = run_ring_q(kind, xin, d, wd, **kw)
                hold(name, kind, got, plain, xin, w, dtype, d, wd, parts)
    for w, per, dtype, d in Q_RAGGED:
        x = ring_q_inputs(w, w * per + 1, dtype, seed=per)
        for view, xs in ragged_views(x):
            for wd in WIRES:
                for name, kind, kw in (("ring_reduce_scatter_q", "scatter", dict()),
                                       ("ring_all_reduce_q S=1", "reduce", dict(dirs=(d,))),
                                       ("ring_all_reduce_q S=2", "reduce", dict(dirs=(1, -1)))):
                    got, plain, parts = run_ring_q(kind, xs, d, wd, **kw)
                    hold(f"{name} {view}", kind, got, plain, xs, w, dtype, d, wd, parts)
        xs, size = x[:, 1:], w * per
        half = size // 2 + (size // 2) % 2 - 1  # odd
        for wd in WIRES:
            out = xs.new_empty((w, size))
            lanes = [rc.launch_ar(xs[:, :half], out[:, :half], (1,), 0, wd),
                     rc.launch_ar(xs[:, half:], out[:, half:], (-1,), 1, wd)]
            for lane in lanes:
                lane.check("bidir halves")
            plain = torch.cat([rc.ar_q_chain_plain(xs[:, :half], (1,), wd),
                               rc.ar_q_chain_plain(xs[:, half:], (-1,), wd)], 1)
            hold("ring_all_reduce_q bidir halves", "reduce", out, plain, xs, w, dtype, 0, wd, w,
                 split=half)
        del x, xs
    x = ring_q_inputs(4, 1_000_000, torch.float32, seed=31)
    x[0, 5], x[1, 70_000] = float("inf"), float("nan")
    x[:, 1024:1152], x[2, 4096:4224] = 0.0, 1e-42
    for wd in WIRES:
        for name, kind, kw in (("ring_reduce_scatter_q", "scatter", dict()),
                               ("ring_all_reduce_q S=1", "reduce", dict(dirs=(1,)))):
            got, plain, parts = run_ring_q(kind, x, 1, wd, **kw)
            r = ring_q_rule(kind, got, plain, x, 4, torch.float32, wd, parts)
            r["zero_row_exact"] = bool((got.reshape(4, -1)[0, 1024:1152] == 0).all())
            readings.append({"kernel": name, "W": 4, "size": 1_000_000, "dtype": "torch.float32",
                             "dir": 1, "wire": wd, "planted": "inf, nan, zero and denormal rows",
                             **r})
            if not (r["ok"] and r["zero_row_exact"]):
                fail(f"{name} with non-finite and zero rows, {wd}: {r}")
    emit("ring_q_vs_plain", readings=readings, launches=dict(rc.launch_counts),
         rule="bit-identical to the one-pass contract (nan equal to nan), itself equal to "
              "the hop schedule on padded slots; within trips * rowmax(sum|x|) / "
              "ROUND_TRIP_DIVISOR of the float64 sum (see quant_bound); non-finite where "
              "the sum is; B8's members identical")
    return {"max_abs_err_vs_plain": worst}

def _chain_q_faulty(x, d, wd, kind, fault):
    """B6's (``kind`` "scatter") or B8's one-direction contract on ``x``
    [W, N] with one planted fault: ``drop_link`` (link 2's term never
    added), ``scale_shift`` (each row dequantized with the next row's
    scale), ``nan_to_zero`` (a poisoned row's +inf scale read as 0: the row
    arrives as zeros), ``no_final_trip`` (B8's sum stored without its last
    round trip)."""
    def rt(v):
        q, sc = quant.quantize_block(v, wd, 128)
        if fault == "nan_to_zero":
            sc = torch.where(torch.isinf(sc), 0.0, sc)
        if fault == "scale_shift":
            sc = sc.roll(1, -1)
        return quant.dequantize_block(q, sc, 128, v.dtype)

    def chain(terms):  # terms[j]: the chain's (j+1)-th term
        acc = terms[0]
        for j in range(1, len(terms)):
            acc = rt(acc) if fault == "drop_link" and j == 1 else terms[j] + rt(acc)
        return acc

    w, size = x.shape
    r = torch.arange(w, device=x.device)
    if kind == "scatter":
        slots = x.reshape(w, w, -1)
        return chain([slots[(r + j * d) % w, r] for j in range(1, w + 1)])
    k = -(-size // w)
    out = x.new_empty((w, size))
    for o in range(w):
        lo, hi = o * k, min(size, (o + 1) * k)
        if lo < hi:
            acc = chain([x[(o + j * d) % w, lo:hi] for j in range(1, w + 1)])
            out[:, lo:hi] = acc if fault == "no_final_trip" else rt(acc)
    return out

def ring_q_planted_faults() -> None:
    """Faults made on the one-pass contracts must fail the rule the kernels
    pass, on both wires: a link dropped (B6, B8), scales applied one row off
    (B6, B8), B8's final round trip skipped, and a nan row that arrives as
    zeros (B6)."""
    w, size, dtype = 4, 1_000_000, torch.float32
    x = ring_q_inputs(w, size, dtype, seed=41)
    xn = x.clone()
    xn[1, 70_000] = float("nan")
    readings = {}
    for wd in WIRES:
        faults = readings[wd] = {}
        ok_rs, _, _ = run_ring_q("scatter", x, 1, wd)
        ok_ar, _, _ = run_ring_q("reduce", x, 1, wd, dirs=(1,))
        ok_n, _, _ = run_ring_q("scatter", xn, 1, wd)
        for name, kind, fault, ok, xs in (
                ("rs: link 2 dropped", "scatter", "drop_link", ok_rs, x),
                ("rs: scales one row off", "scatter", "scale_shift", ok_rs, x),
                ("rs: nan row arrives as zeros", "scatter", "nan_to_zero", ok_n, xn),
                ("ar: link 2 dropped", "reduce", "drop_link", ok_ar, x),
                ("ar: scales one row off", "reduce", "scale_shift", ok_ar, x),
                ("ar: final round trip skipped", "reduce", "no_final_trip", ok_ar, x)):
            faults[name] = ring_q_rule(kind, _chain_q_faulty(xs, 1, wd, kind, fault), ok, xs, w,
                                       dtype, wd, w)
        passed = [name for name, r in faults.items() if r["ok"]]
        if passed:
            fail(f"planted quantized-ring faults pass the check on the {wd} wire: {passed}")
    emit("ring_q_planted_faults", W=w, size=size, readings=readings)

def ring_q_launchers(w, p_elems):
    """Preallocated operands at ``p_elems`` f32 per member and, per
    quantized kernel and wire dtype, a launch function (no sync, no check)
    and its plain version."""
    g = torch.Generator(device=DEV).manual_seed(5)
    x = torch.randn((w, p_elems), generator=g, device=DEV)
    xs = x[:, : p_elems - p_elems % w]
    ar_out, rs_out = torch.empty_like(x), x.new_empty((w, xs.shape[1] // w))
    lanes, runs = [], {}
    for wd in WIRES:
        runs["ring_reduce_scatter_q", wd] = (
            lambda wd=wd: lanes.append(rc.launch_rs(xs, rs_out, 1, 0, wd)),
            lambda wd=wd: rc.rs_q_chain_plain(xs, 1, wd))
        runs["ring_all_reduce_q", wd] = (
            lambda wd=wd: lanes.append(rc.launch_ar(x, ar_out, (1, -1), 0, wd)),
            lambda wd=wd: rc.ar_q_chain_plain(x, (1, -1), wd))
    return runs, lanes

def q_rows_off_16(name, wd) -> dict:
    """B6 or B8 (two streams) on the bf16 bucket of rows_off_16 (rows 4 mod
    8 elements long, so the rows lie alternately 0 and 8 bytes off 16): B8's
    terms and outputs move in 4-byte units, and B6's slots, whose starts are
    an odd number of elements apart, in single elements. Its time beside its
    bound and its full-precision twin's on the same rows, and its bits
    against its contract."""
    p = 2 * BUCKET - WORLD
    g = torch.Generator(device=DEV).manual_seed(6)
    x = torch.randn((WORLD, p), generator=g, device=DEV, dtype=torch.bfloat16)
    lanes = []
    if name == "ring_reduce_scatter_q":
        out = x.new_empty((WORLD, p // WORLD))
        ms = time_ms(lambda: lanes.append(rc.launch_rs(x, out, 1, 0, wd)), 10)
        plain = rc.rs_q_chain_plain(x, 1, wd)
    else:
        out = torch.empty_like(x)
        ms = time_ms(lambda: lanes.append(rc.launch_ar(x, out, (1, -1), 0, wd)), 10)
        plain = rc.ar_q_chain_plain(x, (1, -1), wd)
    for lane in lanes:
        lane.check("quantized ring timing, rows off 16 bytes")
    if not same(out, plain):
        fail(f"{name} {wd} on bf16 rows off 16 bytes differs from its contract")
    bnd = ring_bound_ms(QUANTIZED[name], WORLD, p, 2)
    del x, out, plain
    torch.cuda.empty_cache()
    return dict(dtype="bfloat16", elems_per_member=p, ms=ms, bound_ms=bnd,
                share_of_bound=bnd / ms)

def ring_q_timing(full) -> dict:
    """CUDA-event medians of B6 and B8, fp8 and int8, at the gradient bucket
    (W = 4) and the smaller payloads, beside B5's and B7's times from this
    run (``full``), and on the bf16 bucket whose rows lie off 16 bytes
    (beside B5's and B7's ``rows_off_16``). Their bound is the same
    compulsory traffic as B5's and B7's: the quantized wire changes what a
    hop moves, not what the function reads and writes. No single PyTorch
    call computes a per-hop quantized sum, so there is no library time of
    their own."""
    res = {}
    runs, lanes = ring_q_launchers(WORLD, BUCKET)
    for (name, wd), (kernel, plain) in runs.items():
        twin = full[QUANTIZED[name]]
        ms = time_ms(kernel, 10)
        res.setdefault(name, {})[wd] = dict(
            ms=ms, bound_ms=twin["bound_ms"], bound_by="bytes",
            share_of_bound=twin["bound_ms"] / ms, plain_ms=time_ms(plain, 2),
            full_precision_ms=twin["ms"], ratio_to_full_precision=ms / twin["ms"])
    for lane in lanes:
        lane.check("quantized ring timing")
    del runs, lanes
    torch.cuda.empty_cache()
    for name, twin in QUANTIZED.items():
        for wd in WIRES:
            r = q_rows_off_16(name, wd)
            r["full_precision_ms"] = full[twin]["rows_off_16"]["ms"]
            res[name][wd]["rows_off_16"] = r
    sweep = []
    for mib in SWEEP_MIB:
        p = mib * 2 ** 20 // 4
        runs, lanes = ring_q_launchers(WORLD, p)
        for (name, wd), (kernel, _) in runs.items():
            ms = time_ms(kernel, 20)
            bnd = ring_bound_ms(QUANTIZED[name], WORLD, p, 4)
            sweep.append(dict(kernel=name, wire=wd, mib_per_member=mib, ms=ms, bound_ms=bnd,
                              share_of_bound=bnd / ms))
        for lane in lanes:
            lane.check("quantized ring sweep")
    emit("ring_q_timing", W=WORLD, bucket_elems_per_member=BUCKET, dtype="float32",
         kernels=res, sweep=sweep,
         library="none computes a per-hop quantized sum; B5's and B7's library calls "
                 "(ring_ccl_timing) are the verbs' yardstick",
         note="one card: every hop is an HBM-to-HBM store; no NVLink or bus-bandwidth claim")
    return res

def quant_held_at_bucket(x) -> list:
    """Each kernel launch of the quantized path once more, at the shapes the
    path gave it and on the bucket's own data, against its plain version:
    bit for bit, for both wires. B6 on the bucket's unpadded rows; B8 with
    two streams on the bucket (``pallas``) and with one stream on each half
    in its direction, the halves' columns of one output (``bidir``), each
    against its one-pass contract; B4 on the quantized payload and on the
    packed scales of a member's contribution (``ring``) and of its halves in
    their directions (``bidir``; the broadcast's pair gathers chunks of the
    same size). Returns one reading per case."""
    w = WORLD
    half = BUCKET // 2
    contrib = x[:, : BUCKET // w]
    chalf = contrib.shape[1] // 2
    readings = []

    def hold(kernel, case, wd, pairs):
        ok = all(same(got, plain) for got, plain in pairs)
        err = max(torch.nan_to_num(got.double() - plain.double()).abs().max().item()
                  for got, plain in pairs)
        readings.append(dict(kernel=kernel, case=case, wire=wd, bit_identical=ok,
                             max_abs_err_vs_plain=err))
        if not ok:
            fail(f"{kernel} {case} {wd} at the bucket differs from its plain version "
                 f"by up to {err}")

    for wd in WIRES:
        lane, got = rc._rs_kernel(x, 1, 0, wd)
        lane.check("ring_reduce_scatter_q")
        hold("ring_reduce_scatter_q", f"slots of {BUCKET // w}", wd,
             [(got, rc.rs_q_chain_plain(x, 1, wd))])
        del got
        lane, got = rc._ar_kernel(x, (1, -1), 0, wd)
        lane.check("ring_all_reduce_q")
        hold("ring_all_reduce_q", f"S=2, chunks of {-(-BUCKET // (2 * w))}", wd,
             [(got, rc.ar_q_chain_plain(x, (1, -1), wd))])
        del got
        out = torch.empty_like(x)
        for i, (lo, hi, d) in enumerate(((0, half, 1), (half, BUCKET, -1))):
            rc.launch_ar(x[:, lo:hi], out[:, lo:hi], (d,), i, wd).check("ring_all_reduce_q")
        hold("ring_all_reduce_q", "S=1 on each half in its direction, into one output", wd,
             [(out[:, :half], rc.ar_q_chain_plain(x[:, :half], (1,), wd)),
              (out[:, half:], rc.ar_q_chain_plain(x[:, half:], (-1,), wd))])
        del out
        for case, part, d in (("contribution +1", contrib, 1),
                              ("first half +1", contrib[:, :chalf], 1),
                              ("second half -1", contrib[:, chalf:], -1)):
            ring = rc._AgQuant(part, wd)
            lanes, gathered = ring.start(0)
            for lane in lanes:
                lane.check("ring_all_gather")
            hold("ring_all_gather", f"payload and packed scales, {case}, chunk of {ring.m}", wd,
                 list(zip(gathered, ring.plain(d))))
            del ring, gathered
        torch.cuda.empty_cache()
    return readings

def quant_path(x, refs) -> tuple:
    """Every Communicator verb with a wire_dtype at the gradient bucket,
    W = 4, fp8 and int8: launches per call exact, no fallback, each result
    within its round-trip budget of the full-precision verb's, members'
    copies identical, and the wire bytes (``ep_bytes_total``) beside the
    full-precision verb's. Counts are set to 0 just before and read just
    after; then every kernel of the path is held to its plain version at
    the bucket (:func:`quant_held_at_bucket`). Returns the path's launches
    and the largest difference from a plain version."""
    comm = Communicator(make_mesh(MeshConfig(dp=WORLD)), AXIS.DP)
    w = WORLD
    contrib = x[:, : BUCKET // w].contiguous()
    a_sum = x.abs().sum(0)  # every partial sum's magnitude is under it
    fb0 = dma.WIRE_FALLBACK.total()
    torch.cuda.synchronize()
    rc.reset_launch_counts()
    calls = []
    # (verb, algo, run(wd), reference, row magnitude bound, trips, launches)
    verbs = [
        ("all_reduce", "pallas", lambda wd: comm.all_reduce(x, algo="pallas", wire_dtype=wd),
         lambda: refs["all_reduce"], lambda: row_max(a_sum, 2 * w), w,
         {"ring_all_reduce_q": 1}),
        ("all_reduce", "bidir", lambda wd: comm.all_reduce(x, algo="bidir", wire_dtype=wd),
         lambda: refs["all_reduce"], lambda: row_max(a_sum, w, split=BUCKET // 2), w,
         {"ring_all_reduce_q": 2}),
        ("all_gather", "ring", lambda wd: comm.all_gather(contrib, algo="ring", wire_dtype=wd),
         lambda: contrib, lambda: row_max(contrib.abs(), 1), 1, {"ring_all_gather": 2}),
        ("all_gather", "bidir",
         lambda wd: comm.all_gather(contrib, algo="bidir", wire_dtype=wd),
         lambda: contrib, lambda: row_max(contrib.abs(), 1, split=contrib.shape[1] // 2), 1,
         {"ring_all_gather": 4}),
        ("reduce_scatter", "ring",
         lambda wd: comm.reduce_scatter(x, algo="ring", wire_dtype=wd),
         lambda: refs["reduce_scatter"],
         lambda: row_max(a_sum, w).reshape(w, -1), w - 1, {"ring_reduce_scatter_q": 1}),
        ("broadcast", "scatter_ag",
         lambda wd: comm.broadcast(x, 0, algo="scatter_ag", wire_dtype=wd),
         lambda: x[0], lambda: row_max(x[0].abs(), w), 1, {"ring_all_gather": 4}),
    ]
    for verb, algo, run, ref, rows, trips, want in verbs:
        for wd in WIRES:
            before, bytes0 = dict(rc.launch_counts), rc._WIRE_BYTES.total()
            t = time.perf_counter()
            got = run(wd)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t) * 1e3
            wire_bytes = rc._WIRE_BYTES.total() - bytes0
            delta = {k: rc.launch_counts[k] - before[k] for k in rc.KERNELS}
            expect = {k: want.get(k, 0) for k in rc.KERNELS}
            if delta != expect:
                fail(f"{verb} {algo} {wd}: launches {delta}, expected {expect}")
            if not torch.isfinite(got).all():
                fail(f"{verb} {algo} {wd}: non-finite result")
            mine = got[0] if verb in ("all_reduce", "broadcast") else got
            if mine.shape != ref().shape:
                fail(f"{verb} {algo} {wd}: shape {tuple(mine.shape)} vs {tuple(ref().shape)}")
            if verb in ("all_reduce", "broadcast") and not all(
                    torch.equal(got[i], got[0]) for i in range(1, w)):
                fail(f"{verb} {algo} {wd}: the members' results differ")
            # the full-precision verb's own rounding is inside quant_bound's
            # second term; all_gather and broadcast move the input itself
            bound = quant_bound(rows(), trips, wd, w, torch.float32)
            err = (mine.double() - ref().double()).abs()
            over = (err / bound.clamp_min(1e-300)).max().item()
            if not bool((err <= bound).all()):
                fail(f"{verb} {algo} {wd}: {over} of the round-trip budget")
            full_bytes = refs["wire_bytes"][verb, algo]
            calls.append(dict(verb=verb, algo=algo, wire=wd, launches=delta, host_ms=host_ms,
                              max_abs_err_vs_full_precision=err.max().item(),
                              worst_over_bound=over, wire_bytes=wire_bytes,
                              full_precision_wire_bytes=full_bytes,
                              wire_byte_reduction=full_bytes / wire_bytes))
            del got, mine, bound, err
    launches = dict(rc.launch_counts)
    fallbacks = dma.WIRE_FALLBACK.total() - fb0
    if fallbacks:
        fail(f"the quantized path fell back {fallbacks} times")
    # The Communicator returns one member's copy of a gather: hold all W.
    for wd in WIRES:
        got = rc.ring_all_gather(contrib.unsqueeze(1), wire_dtype=wd)
        if not all(torch.equal(got[i], got[0]) for i in range(1, w)):
            fail(f"all_gather ring {wd}: the members' copies differ at the bucket")
        del got
    cold = {(c["verb"], c["algo"]): c["host_ms"] for c in calls if c["wire"] == "fp8"}
    breakdown = verb_breakdown([(verb, f"{algo} fp8", functools.partial(run, "fp8"),
                                 cold[verb, algo]) for verb, algo, run, *_ in verbs])
    # B6 and B8 take the payload as it is and write each result in its final
    # place: the quantized AR and RS verbs fill and copy nothing (a pair's
    # check stacks its two error words, a cat of a few microseconds)
    for b in breakdown:
        if b["verb"] in ("all_reduce", "reduce_scatter") and (
                b["device_ms"]["fill"] > 0 or b["device_ms"]["copy"] > 0.05):
            fail(f"{b['verb']} {b['algo']}: fills or copies on the card {b['device_ms']}")
    planner = plan.get_planner()
    auto = {wd: {
        "all_reduce": planner.plan_all_reduce((BUCKET,), x.dtype, w, wire_dtype=wd,
                                              pallas_ok=True, emit=False).algo,
        "all_gather": planner.plan_all_gather((BUCKET // w,), x.dtype, w, wire_dtype=wd,
                                              pallas_ok=True, emit=False).algo,
        "reduce_scatter": planner.plan_reduce_scatter((BUCKET,), x.dtype, w, wire_dtype=wd,
                                                      pallas_ok=True, emit=False).algo,
        "broadcast": planner.plan_broadcast((BUCKET,), x.dtype, w, wire_dtype=wd,
                                            pallas_ok=True, emit=False).algo,
    } for wd in WIRES}
    held_plain = quant_held_at_bucket(x)
    emit("quant_path", W=w, bucket_elems_per_member=BUCKET, calls=calls, launches=launches,
         fallbacks=fallbacks, auto_picks=auto, warm_breakdown=breakdown,
         kernels_vs_plain_at_bucket=held_plain,
         peak_mem_gib=torch.cuda.max_memory_allocated(DEV) / 2**30)
    return launches, max(r["max_abs_err_vs_plain"] for r in held_plain)

# ---------------------------------------------------------------------------
# 8. The EP plane: the all-to-all kernels B9, B10 and the Buffer verbs

# The bench config's MoE layer (flagship.bench_config(): dim 1024, 8 experts
# top-2, ffn 2816, capacity factor 1.25, bf16) at EP world 4, E_local = 2,
# each member carrying one bench batch (B=8 x S=1024 = 8192 tokens), so C =
# 2560 and the dispatch buffer is [W, E_local, C, H] per member. The
# low-latency verbs run at a decode batch of 128 tokens per member.
EP_WORLD, EP_TOKENS, EP_LL_TOKENS = 4, BATCH * SEQ, 128
EP_SOURCE = "uccl_tpu_torch/csrc/ep_a2a.cu"
EP_REPLACES = {"a2a": "uccl_tpu/ep/pallas_a2a.py:83",
               "sched_round": "uccl_tpu/ep/pallas_a2a.py:318"}
ZIPF_ALPHA = 1.2  # the largest alpha benchmarks/ep_bench.py gives as an example

def ep_rule(got, plain, x) -> dict:
    """The check an exchange passes: bit for bit equal to its plain version
    and to ``x.transpose(0, 1)`` (compared as bytes, any dtype)."""
    def raw(t):
        return t.contiguous().view(torch.uint8)

    want = x.transpose(0, 1)
    r = {"bit_identical_to_plain": got.shape == plain.shape and torch.equal(raw(got), raw(plain)),
         "bit_identical_to_transpose": got.shape == want.shape
         and torch.equal(raw(got), raw(want))}
    r["ok"] = r["bit_identical_to_plain"] and r["bit_identical_to_transpose"]
    return r

def ep_inputs(n, shape, dtype, seed):
    g = torch.Generator(device=DEV).manual_seed(seed)
    if dtype == torch.int32:
        return torch.randint(-2 ** 30, 2 ** 30, (n, n) + shape, generator=g, device=DEV,
                             dtype=dtype)
    x = torch.randn((n, n) + shape, generator=g, device=DEV)
    return (x * 40).to(dtype) if dtype.itemsize == 1 else x.to(dtype)

def zipf_schedule(n, seed):
    idx = a2a_sched.zipf_topk(np.random.default_rng(seed), n, 256, 2, 2 * n, ZIPF_ALPHA)
    return a2a_sched.wire_schedule(a2a_sched.traffic_from_topk(idx, 2 * n, 64, n), n)

EP_CASES = [  # (W, trailing shape per member, dtype); sizes that need padding
    (2, (3, 1_000_003), torch.float32),
    (3, (2, 2560, 96), torch.bfloat16),
    (4, (2, 640, 1024), torch.bfloat16),
    (5, (7, 33_333), torch.int32),
    (8, (2, 320, 1024), torch.float8_e4m3fn),
    (8, (1, 40, 8), torch.float32),  # a chunk of scales
    (16, (3, 12_345), torch.bfloat16),
]

def ep_a2a_vs_plain() -> dict:
    """B9 and B10 against their plain versions and the transpose, bit for
    bit: worlds 2-16, bf16/f32/int32/fp8 payloads and the scales' f32,
    padded sizes; B9 unchunked and in 2 and 3 chunks, B10 over a uniform and
    a Zipf schedule, chunked too. Then planted faults that must fail the
    same rule. Returns each kernel's largest difference from its plain
    version (float payloads of 2 and 4 bytes)."""
    pa.reset_launch_counts()
    readings, worst = [], {"a2a": 0.0, "sched_round": 0.0}

    def diff(got, plain):  # 1-byte payloads move as uint8, int32 is exact
        if got.dtype.is_floating_point:
            return (got.double() - plain.double()).abs().max().item()
        return 0.0

    for n, shape, dtype in EP_CASES:
        x = ep_inputs(n, shape, dtype, seed=n)
        xb, _ = pa._as_bytes(x)
        view, k, _ = pa._view(xb)
        out = torch.empty_like(view)
        pa.launch_a2a(view, out, dma.CID_A2A).check("a2a")
        got, plain = pa._unview(out, k, xb), pa._unview(pa.a2a_plain(view), k, xb)
        worst["a2a"] = max(worst["a2a"], diff(got, plain))
        cases = [("a2a", 1, ep_rule(got, plain, xb))]
        for nc in (2, 3):
            got = pa.all_to_all(x, n_chunks=nc, chunk_axis=1)
            cases.append(("a2a", nc, ep_rule(got, x.transpose(0, 1), x)))
        for kind, sched in (("uniform", a2a_sched.wire_schedule(np.ones((n, n)), n)),
                            ("zipf", zipf_schedule(n, seed=n))):
            # every round on its own, into one sentinel-filled receive buffer:
            # after each round it equals the plain round's, so a pair is
            # written in its designated round only and a shadow duplicate
            # writes nothing
            perms = [r_.perm for r_ in sched[0]]
            got, plain = sched_out(view), sched_out(view)
            for i, pi in enumerate(perms):
                send, local = pa.round_bits(perms, sched[1], i)
                pa.launch_sched_round(view, got, pi, send, local, dma.CID_SCHED).check(
                    "sched_round")
                pa.sched_round_plain(view, plain, pi, send, local)
                if not torch.equal(got.view(torch.uint8), plain.view(torch.uint8)):
                    fail(f"sched_round W={n} {dtype} round {i} {pi} differs from its plain "
                         "version")
            worst["sched_round"] = max(worst["sched_round"], diff(got, plain))
            if not torch.equal(got.view(torch.uint8), view.transpose(0, 1).contiguous().view(
                    torch.uint8)):
                fail(f"sched_round W={n} {dtype} {kind}: the rounds are not the transpose")
            for nc in (1, 2):
                got = pa.scheduled_all_to_all(x, sched, n_chunks=nc, chunk_axis=1)
                cases.append((f"sched_round {kind} R={len(sched[0])}", nc,
                              ep_rule(got, x.transpose(0, 1), x)))
        for name, nc, r in cases:
            readings.append({"kernel": name, "W": n, "shape": list(shape), "dtype": str(dtype),
                             "n_chunks": nc, **r})
            if not r["ok"]:
                fail(f"{name} W={n} {shape} {dtype} n_chunks={nc}: {r}")
    ep_planted_faults()
    emit("ep_a2a_vs_plain", readings=readings, launches=dict(pa.launch_counts),
         rule="bit-identical to the plain version and to x.transpose(0, 1), as bytes")
    return {"max_abs_err_vs_plain": worst}

def sched_out(view):
    """A receive buffer for B10's rounds, every byte 0xFF (a NaN in every
    float type): a slot no round writes stays so."""
    return torch.full_like(view.view(torch.uint8), 0xFF).view(view.dtype)

def run_schedule(view, perms, k_mat, out, rounds=None):
    """B10's rounds ``rounds`` (all by default) of the schedule into ``out``."""
    for i in range(len(perms)) if rounds is None else rounds:
        send, local = pa.round_bits(perms, k_mat, i)
        pa.launch_sched_round(view, out, perms[i], send, local,
                              dma.chunk_collective_id(dma.CID_SCHED, i)).check("sched_round")
    return out

def ep_planted_faults() -> None:
    """Faults made from the kernels' own results must fail the rule they
    pass: one pair's chunk zeroed, every slot one off (B9), and B10's
    schedule into a sentinel-filled buffer with round 0 left out (its pairs
    and the diagonal keep the sentinel) or with one pair designated to a
    round that does not carry it (that pair is never written)."""
    n = 4
    x = ep_inputs(n, (2, 640, 1024), torch.bfloat16, seed=50)
    view, k, _ = pa._view(x)
    out = torch.empty_like(view)
    pa.launch_a2a(view, out, dma.CID_A2A).check("a2a")
    plain = pa._unview(pa.a2a_plain(view), k, x)
    ok = pa._unview(out, k, x)
    faults = {}
    zeroed = ok.clone()
    zeroed[2, 1] = 0
    faults["a2a: pair (1, 2) zeroed"] = ep_rule(zeroed, plain, x)
    faults["a2a: slots one off"] = ep_rule(ok.roll(1, dims=1), plain, x)
    rounds, k_mat = zipf_schedule(n, seed=51)
    perms = [r.perm for r in rounds]
    whole = pa._unview(run_schedule(view, perms, k_mat, sched_out(view)), k, x)
    if not ep_rule(whole, plain, x)["ok"]:
        fail("the planted faults' schedule is wrong itself")
    faults["sched: round 0 missing"] = ep_rule(pa._unview(run_schedule(
        view, perms, k_mat, sched_out(view), range(1, len(perms))), k, x), plain, x)
    wrong = np.array(k_mat)
    s, d, r = next((s, d, r) for s in range(n) for d in range(n) for r in range(len(perms))
                   if s != d and perms[r][s] != d)
    wrong[s, d] = r
    faults["sched: pair mis-designated"] = ep_rule(
        pa._unview(run_schedule(view, perms, wrong, sched_out(view)), k, x), plain, x)
    passed = [name for name, r in faults.items() if r["ok"]]
    if passed:
        fail(f"planted EP faults pass the check: {passed}")
    emit("ep_planted_faults", W=n, readings=faults)

def ep_bound_ms(nbytes_in: int) -> float:
    """The exchange reads its input once and writes its output once."""
    return 2 * nbytes_in / PEAK_BYTES * 1e3

def ep_launchers(x, sched):
    """Preallocated operands for ``x`` [W, W, ...]: B9 on the whole view,
    the B9 pair on the two halves of per-member axis 2 (chunk kernels on
    parity-twin ids), and B10's whole schedule, its rounds writing into one
    receive buffer; each beside its plain version."""
    view, _, _ = pa._view(x)
    out = torch.empty_like(view)
    halves = [pa._view(h.contiguous())[0] for h in x.chunk(2, dim=3)]
    houts = [torch.empty_like(h) for h in halves]
    perms, k_mat = [r.perm for r in sched[0]], sched[1]
    bits = [pa.round_bits(perms, k_mat, i) for i in range(len(perms))]
    sched_buf = torch.empty_like(view)
    lanes = []

    def b9():
        lanes.append(pa.launch_a2a(view, out, dma.CID_A2A))

    def b9_pair():
        for c, (h, o) in enumerate(zip(halves, houts)):
            lanes.append(pa.launch_a2a(h, o, dma.chunk_collective_id(dma.CID_EP_DISPATCH, c)))

    def b10():
        for i, (pi, (send, local)) in enumerate(zip(perms, bits)):
            lanes.append(pa.launch_sched_round(view, sched_buf, pi, send, local,
                                               dma.chunk_collective_id(dma.CID_SCHED, i)))

    def b10_plain():
        buf = torch.empty_like(view)
        for pi, (send, local) in zip(perms, bits):
            pa.sched_round_plain(view, buf, pi, send, local)
        return buf

    runs = {"a2a": (b9, lambda: pa.a2a_plain(view)),
            "a2a chunk pair": (b9_pair, lambda: [pa.a2a_plain(h) for h in halves]),
            "sched_round schedule": (b10, b10_plain)}
    return runs, lanes

def ep_a2a_timing() -> dict:
    """CUDA-event medians (L2 flushed, median of 10) at the MoE layer's
    dispatch buffer, [W, E_local, C, H] bf16 per member: B9, the B9 chunk
    pair, and B10's whole Zipf schedule (its rounds write the receive buffer
    itself: nothing to assemble), each beside the bound, its plain version
    and the library call ``x.transpose(0, 1).contiguous()``; then a
    1/16/256 MiB-per-member sweep."""
    cap = int(1.25 * EP_TOKENS * 2 / 8)
    x = ep_inputs(EP_WORLD, (2, cap, 1024), torch.bfloat16, seed=60)
    sched = ep_zipf_routing()[2]
    res = {}
    runs, lanes = ep_launchers(x, sched)
    lib_ms = time_ms(lambda: x.transpose(0, 1).contiguous(), 10)
    bnd = ep_bound_ms(x.numel() * x.element_size())
    for name, (kernel, plain) in runs.items():
        ms = time_ms(kernel, 10)
        res[name] = dict(ms=ms, bound_ms=bnd, bound_by="bytes", share_of_bound=bnd / ms,
                         plain_ms=time_ms(plain, 3), library_ms=lib_ms,
                         library_call="x.transpose(0, 1).contiguous()")
    for lane in lanes:
        lane.check("ep timing")
    res["sched_round schedule"]["rounds"] = len(sched[0])
    del runs, lanes
    sweep = []
    for mib in SWEEP_MIB:
        per_chunk = mib * 2 ** 20 // 2 // EP_WORLD  # bf16 elements per destination chunk
        xs = ep_inputs(EP_WORLD, (per_chunk,), torch.bfloat16, seed=61)
        runs, lanes = ep_launchers(xs.reshape(EP_WORLD, EP_WORLD, 1, 2, -1), sched)
        bnd = ep_bound_ms(xs.numel() * 2)
        lib = time_ms(lambda: xs.transpose(0, 1).contiguous(), 20)
        for name, (kernel, _) in runs.items():
            ms = time_ms(kernel, 20)
            sweep.append(dict(kernel=name, mib_per_member=mib, ms=ms, bound_ms=bnd,
                              share_of_bound=bnd / ms, library_ms=lib))
        for lane in lanes:
            lane.check("ep sweep")
    emit("ep_a2a_timing", W=EP_WORLD, dispatch_buffer_per_member=[EP_WORLD, 2, cap, 1024],
         dtype="bfloat16", bytes_per_member=x[0].numel() * 2, kernels=res, sweep=sweep,
         note="one card: every copy is HBM to HBM; no NVLink or contention claim")
    return res

def ep_zipf_routing():
    """The scheduled arms' routing: a2a_sched.zipf_topk(rng(0), 4, T, 2, 8,
    alpha=1.2), its [W, W] traffic at capacity C, and that matrix's wire
    schedule."""
    cap = int(1.25 * EP_TOKENS * 2 / 8)
    idx = a2a_sched.zipf_topk(np.random.default_rng(0), EP_WORLD, EP_TOKENS, 2, 8, ZIPF_ALPHA)
    mat = a2a_sched.traffic_from_topk(idx, 8, cap, EP_WORLD)
    return idx, mat, a2a_sched.wire_schedule(mat, EP_WORLD)

def ep_layer_inputs():
    """Layer 0 of the bench config (seed-0 weights) on each member's own
    batch: ``profile_ep.layer_inputs``, the one construction of the EP
    cell's inputs."""
    out = profile_ep.layer_inputs(DEV, BATCH, SEQ)
    torch.cuda.empty_cache()
    return out

_EP_SPLIT = (("ep_kernels", re.compile(r"a2a_kernel|sched_round_kernel")),
             ("gemm", re.compile(r"gemm|nvjet|sm90|cutlass|xmma|matmul", re.I)),
             ("gather_scatter", re.compile(r"index|gather|scatter", re.I)),
             ("copy_fill", re.compile(r"copy|memcpy|memset|fill|cat", re.I)),
             ("sort", re.compile(r"sort|radix", re.I)))

def ep_profile(run) -> dict:
    """One profiled warm call's device ms by class (EP kernels, GEMMs,
    gathers, copies and fills, sorts; ``other`` holds the elementwise and
    reduce passes, the codec's among them) and the device's busy time."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    split, spans = {name: 0.0 for name, _ in _EP_SPLIT}, []
    split["other"] = 0.0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        cls = next((name for name, pat in _EP_SPLIT if pat.search(ev.name)), "other")
        split[cls] += (ev.time_range.end - ev.time_range.start) / 1e3
    return {"device_ms": split, "device_busy_ms": profile_ep.union_ms(spans)}

def ep_path() -> dict:
    """The EP plane end to end at the configuration: get_dispatch_layout →
    dispatch → SwiGLU expert GEMMs → combine through the Buffer, on every
    arm (wire lax/pallas, n_chunks 1/2/0, a2a_sched off/on/auto on the Zipf
    routing, dispatch wire_dtype None/fp8/int8 with combine at full
    precision), the low-latency verbs at 128 tokens per member, and
    moe_ffn at W = 4 against world 1 per member. Launch counts per verb
    exact, pallas arms bit-identical to the lax arm, quantized arms within
    the codec's round trip, zero fallbacks. Counts are set to 0 just before
    and read just after."""
    cfg, x, logits, (wg, wu, wd) = ep_layer_inputs()
    w, t, h = x.shape
    mesh = make_mesh(MeshConfig(dp=w))
    vals, idx = ep_ops._per_member(ep_ops._gate_topk, logits, cfg.moe_topk, True)[:2]
    z_idx, z_mat, z_sched = ep_zipf_routing()
    z_idx = torch.as_tensor(z_idx, device=DEV)
    combine_cfg = Buffer.get_combine_config(w)
    cap = int(cfg.capacity_factor * t * cfg.moe_topk / cfg.moe_experts)
    # (name, Buffer kwargs, routing, dispatch wire_dtype, per-verb launches)
    r_d, r_c = len(z_sched[0]), len(a2a_sched.wire_schedule(z_mat.T, w)[0])
    # n_chunks=0: the planner's depth for one exchange of the dispatch buffer
    depth = plan.get_planner().ep_auto_depth(w * (cfg.moe_experts // w) * cap * h * 2, cap)
    arms = [
        ("lax", dict(), "router", None, (0, 0, 0, 0)),
        ("pallas", dict(wire="pallas"), "router", None, (1, 0, 1, 0)),
        ("pallas n_chunks=2", dict(wire="pallas", n_chunks=2), "router", None, (2, 0, 2, 0)),
        ("pallas n_chunks=0", dict(wire="pallas", n_chunks=0), "router", None,
         (depth, 0, depth, 0)),
        ("pallas fp8", dict(wire="pallas"), "router", "fp8", (2, 0, 1, 0)),
        ("pallas int8", dict(wire="pallas"), "router", "int8", (2, 0, 1, 0)),
        ("lax zipf", dict(), "zipf", None, (0, 0, 0, 0)),
        ("pallas zipf a2a_sched=off", dict(wire="pallas", a2a_traffic=z_mat), "zipf", None,
         (1, 0, 1, 0)),
        ("pallas zipf a2a_sched=on", dict(wire="pallas", a2a_sched="on", a2a_traffic=z_mat),
         "zipf", None, (0, r_d, 0, r_c)),
        ("pallas zipf a2a_sched=on n_chunks=2",
         dict(wire="pallas", a2a_sched="on", a2a_traffic=z_mat, n_chunks=2), "zipf", None,
         (0, 2 * r_d, 0, 2 * r_c)),
        ("pallas zipf a2a_sched=auto", dict(wire="pallas", a2a_sched="auto", a2a_traffic=z_mat),
         "zipf", None, None),
    ]
    fb0 = dma.WIRE_FALLBACK.total()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(DEV)
    pa.reset_launch_counts()
    calls, refs, runs = [], {}, {}
    for name, kw, routing, wdt, want in arms:
        buf = Buffer(mesh, "dp", num_experts=cfg.moe_experts, num_selected=cfg.moe_topk,
                     capacity_factor=cfg.capacity_factor, **kw)
        ridx, rw = (idx, vals) if routing == "router" else (z_idx, None)

        def run(buf=buf, ridx=ridx, rw=rw, wdt=wdt, timed=None):
            laid = buf.get_dispatch_layout(ridx)
            marks = [time.perf_counter()]
            recv, handle = buf.dispatch(x, ridx, rw, wire_dtype=wdt)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            ye = ep_ops._member_gemms(recv, wg, wu, wd)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            out = buf.combine(ye, handle, config=combine_cfg)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            if timed is not None:
                timed.append([(b - a) * 1e3 for a, b in zip(marks, marks[1:])])
            return laid, recv, handle, out

        before = dict(pa.launch_counts)
        laid, recv, handle, out = run()
        mid = dict(pa.launch_counts)
        counts = (mid["a2a"] - before["a2a"], mid["sched_round"] - before["sched_round"])
        # the launches of dispatch alone: rerun it and count
        d0 = dict(pa.launch_counts)
        buf.dispatch(x, idx if routing == "router" else z_idx,
                     vals if routing == "router" else None, wire_dtype=wdt)
        d_counts = (pa.launch_counts["a2a"] - d0["a2a"],
                    pa.launch_counts["sched_round"] - d0["sched_round"])
        got = (d_counts[0], d_counts[1], counts[0] - d_counts[0], counts[1] - d_counts[1])
        if want is None:  # auto: the planner's pick decides the launches
            want = (0, r_d, 0, r_c) if handle.a2a_sched else (1, 0, 1, 0)
        if got != want:
            fail(f"EP arm {name}: launches (dispatch B9, B10, combine B9, B10) {got}, "
                 f"expected {want}")
        if not torch.isfinite(out.float()).all() or out.shape != (w, t, h):
            fail(f"EP arm {name}: combine {tuple(out.shape)} or non-finite")
        base = "lax" if routing == "router" else "lax zipf"
        reading = dict(arm=name, launches=dict(zip(("dispatch_a2a", "dispatch_sched_round",
                                                    "combine_a2a", "combine_sched_round"), got)),
                       n_chunks=handle.n_chunks, a2a_sched=handle.a2a_sched,
                       wire_dtype=handle.wire_dtype)
        if name == base:
            refs[routing] = (recv, out, laid)
            stats = buf.stats()["dispatch"]
            reading["stats"] = stats
            reading["layout_tokens_per_rank"] = laid[0].tolist()
        elif wdt is None:
            ref_recv, ref_out, ref_laid = refs[routing]
            same = (torch.equal(recv, ref_recv) and torch.equal(out, ref_out)
                    and all(torch.equal(a, b) for a, b in zip(laid, ref_laid)))
            if not same:
                fail(f"EP arm {name}: differs from the lax arm "
                     f"(recv max abs {(recv.float() - ref_recv.float()).abs().max().item()})")
            reading["bit_identical_to_lax"] = True
        else:
            ref_recv, ref_out, _ = refs[routing]
            r = recv.float().reshape(*recv.shape[:-1], -1, 128)
            ref = ref_recv.float().reshape(r.shape)
            amax = ref.abs().amax(-1, keepdim=True)
            div = quant.ROUND_TRIP_DIVISOR[wdt]
            bound = amax / div + 2.0 ** -8 * (ref.abs() + amax / div)
            err = (r - ref).abs()
            over = (err / bound.clamp_min(1e-30)).max().item()
            if not bool((err <= bound).all()):
                fail(f"EP arm {name}: dispatch {over} of the round-trip budget")
            reading.update(worst_over_bound=over, dispatch_max_abs_err=err.max().item(),
                           combine_rel_err=((out.float() - ref_out.float()).norm()
                                            / ref_out.float().norm()).item())
        runs[name] = run
        calls.append(reading)
        del recv, handle, out, laid
    launches = dict(pa.launch_counts)
    # warm host ms per verb (median of 3), one profiled call per arm kind;
    # the layer timed with one wait is python -m uccl_tpu_torch.profile_ep's
    for reading in calls:
        if reading["arm"] in ("lax", "pallas", "pallas n_chunks=2", "pallas n_chunks=0",
                              "pallas fp8", "pallas zipf a2a_sched=on"):
            timed = []
            for _ in range(3):
                runs[reading["arm"]](timed=timed)
            reading["warm_host_ms"] = dict(zip(("dispatch", "expert_gemms", "combine"),
                                               [statistics.median(c) for c in zip(*timed)]))
            reading["profile"] = ep_profile(runs[reading["arm"]])
    ll_readings = ep_low_latency(cfg, x, logits, (wg, wu, wd), mesh)
    moe = ep_moe_ffn(cfg, x, logits, (wg, wu, wd), depth)
    fallbacks = dma.WIRE_FALLBACK.total() - fb0
    if fallbacks:
        fail(f"the EP path fell back {fallbacks} times")
    path_launches = dict(pa.launch_counts)
    emit("ep_path", W=w, tokens_per_member=t, capacity=cap, hidden=h,
         dispatch_bytes_per_member=w * (cfg.moe_experts // w) * cap * h * 2,
         zipf_rounds={"dispatch": r_d, "combine": r_c}, zipf_skew=a2a_sched.skew(z_mat),
         auto_depth=depth,
         calls=calls, low_latency=ll_readings, moe_ffn=moe, launches_buffer_arms=launches,
         launches=path_launches, fallbacks=fallbacks,
         peak_mem_gib=torch.cuda.max_memory_allocated(DEV) / 2 ** 30)
    return path_launches

def ep_low_latency(cfg, x, logits, experts, mesh) -> list:
    """The low-latency verbs at 128 tokens per member (num_max 128), the
    wire's default fp8: dispatch → grouped GEMMs → combine on the pallas,
    dense and ragged wires. The pallas wire launches B9 twice per verb
    (payload and scales); every wire gives the dense wire's bits."""
    tl = EP_LL_TOKENS
    xl, ll_logits = x[:, :tl].contiguous(), logits[:, :tl].contiguous()
    vals, idx = ep_ops._per_member(ep_ops._gate_topk, ll_logits, cfg.moe_topk, True)[:2]
    out, ref = [], None
    for wire, want in (("dense", 0), ("pallas", 2), ("ragged", 0)):
        buf = Buffer(mesh, "dp", num_experts=cfg.moe_experts, num_selected=cfg.moe_topk)
        a0 = pa.launch_counts["a2a"]
        t0 = time.perf_counter()
        recv_x, counts, handle = buf.low_latency_dispatch(xl, idx, tl, vals, wire=wire)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        d_launch = pa.launch_counts["a2a"] - a0
        y = ep_ll.grouped_ffn(recv_x, counts, *experts)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        combined = buf.low_latency_combine(y, handle)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        c_launch = pa.launch_counts["a2a"] - a0 - d_launch
        if (d_launch, c_launch) != (want, want):
            fail(f"low-latency {wire}: B9 launches {d_launch}/{c_launch}, expected {want}")
        if ref is None:
            ref = (recv_x, counts, combined)
        elif not (torch.equal(recv_x, ref[0]) and torch.equal(counts, ref[1])
                  and torch.equal(combined, ref[2])):
            fail(f"low-latency {wire}: differs from the dense wire")
        if not torch.isfinite(combined.float()).all():
            fail(f"low-latency {wire}: non-finite combine")
        out.append(dict(wire=wire, wire_dtype=handle.wire_dtype, r_max=recv_x.shape[1],
                        recv_rows=int(counts.sum()), launches={"dispatch": d_launch,
                                                               "combine": c_launch},
                        host_ms={"dispatch": (t1 - t0) * 1e3, "grouped_ffn": (t2 - t1) * 1e3,
                                 "combine": (t3 - t2) * 1e3},
                        stats=buf.stats()["low_latency"]))
    return out

def ep_moe_ffn(cfg, x, logits, experts, depth) -> dict:
    """moe_ffn at W = 4 on the pallas wire, phased and at the auto chunk
    depth, against world 1 on each member's tokens with all experts: the
    same routing and drops, so the same rows through GEMMs of other shapes
    (bf16, so held to 2^-7 of the output's norm)."""
    kw = dict(num_selected=cfg.moe_topk, capacity_factor=cfg.capacity_factor)
    a0 = pa.launch_counts["a2a"]
    phased = ep_ops.moe_ffn(x, logits, *experts, "dp", wire="pallas", **kw)[0]
    auto = ep_ops.moe_ffn(x, logits, *experts, "dp", wire="pallas", n_chunks=0, **kw)[0]
    launches = pa.launch_counts["a2a"] - a0
    if launches != 2 + 2 * depth:
        fail(f"moe_ffn: {launches} B9 launches, expected 2 phased + {2 * depth} at auto depth "
             f"{depth}")
    full = [e.reshape(cfg.moe_experts, *e.shape[2:]) for e in experts]
    worst = {"phased": 0.0, "auto_depth": 0.0}
    for r in range(x.shape[0]):
        want = ep_ops.moe_ffn(x[r], logits[r], *full, **kw)[0].float()
        for name, got in (("phased", phased[r]), ("auto_depth", auto[r])):
            rel = ((got.float() - want).norm() / want.norm()).item()
            worst[name] = max(worst[name], rel)
    if not max(worst.values()) <= 2.0 ** -7:
        fail(f"moe_ffn at W=4 against world 1 per member: relative norm errors {worst}")

    return {"launches_a2a": launches, "rel_norm_err_vs_world1": worst,
            "auto_depth_equals_phased": bool(torch.equal(phased, auto))}

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
    q_err = ring_q_vs_plain()["max_abs_err_vs_plain"]
    ring_q_planted_faults()
    q_time = ring_q_timing(ring_time)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(DEV)
    bucket = gradient_bucket()
    ring_launches, ring_errs, refs = collective_path(bucket)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(DEV)
    q_launches, q_err_bucket = quant_path(bucket, refs)
    q_err = max(q_err, q_err_bucket)
    del bucket, refs
    torch.cuda.empty_cache()
    ep_fb0 = dma.WIRE_FALLBACK.total()
    ep_errs = ep_a2a_vs_plain()["max_abs_err_vs_plain"]
    ep_time = ep_a2a_timing()
    torch.cuda.empty_cache()
    ep_launches = ep_path()
    if dma.WIRE_FALLBACK.total() != ep_fb0:
        fail(f"the EP phases fell back {dma.WIRE_FALLBACK.total() - ep_fb0} times")
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
        for name in FULL_PRECISION
    ] + [
        # ms is the fp8 wire's; int8's stands beside it. The bound is the
        # full-precision twin's: the same compulsory bytes.
        {"name": name, "route": "cuda", "source": RING_SOURCE, "replaces": RING_REPLACES[name],
         "launches": q_launches[name], "max_abs_err": q_err,
         "ms": q_time[name]["fp8"]["ms"], "int8_ms": q_time[name]["int8"]["ms"],
         "plain_ms": q_time[name]["fp8"]["plain_ms"],
         "bound_ms": q_time[name]["fp8"]["bound_ms"], "bound_by": "bytes",
         "library_ms": None,
         "library_call": f"none computes a per-hop quantized sum; see {twin}'s"}
        for name, twin in QUANTIZED.items()
    ] + [
        # B10's time is its whole schedule (one launch per round) at the Zipf
        # routing's rounds: the exchange's cost
        {"name": name, "route": "cuda", "source": EP_SOURCE, "replaces": EP_REPLACES[name],
         "launches": ep_launches[name], "max_abs_err": ep_errs[name],
         "ms": ep_time[timed]["ms"], "plain_ms": ep_time[timed]["plain_ms"],
         "bound_ms": ep_time[timed]["bound_ms"], "bound_by": "bytes",
         "library_ms": ep_time[timed]["library_ms"],
         "library_call": ep_time[timed]["library_call"], "timed": timed}
        for name, timed in (("a2a", "a2a"), ("sched_round", "sched_round schedule"))
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
