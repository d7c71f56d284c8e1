#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (uccl_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one Hopper GPU and the CUDA
toolkit. It builds the CUDA kernels from the checkout's sources, holds each
against its plain PyTorch version on the card element by element (and shows
that the same rule rejects planted faults), times them, then trains the
flagship MoE model at the benchmark's base configuration (bf16) for a few
steps and checks that the step went through the kernels. At that size it
also holds the kernels' autograd path, on layer 0's q/k/v, to the plain
backward, and the first two losses to the same steps through plain
attention. Then the trainer's own path (train_path): ``python -m
uccl_tpu_torch.train`` at the same widths in float32 through the f32 flash
kernels (held first to their plain versions, planted faults too), on a
seeded token corpus, with checkpoints, a bit-exact resume, every remat mode,
dense and ``moe_impl="ll"``, and ``serve --ckpt-dir`` on its checkpoint. Then the
flagship at world > 1 with every member on the card (mesh_path): meshes
dp=2/cp=2/tp=2 (ring and Ulysses attention on the f32 kernels) and
pp=2/cp=2/tp=2 (GPipe, and 1F1B against it) held to world 1, the EP wire on
B9 bit for bit, and ``train --mesh`` with a bit-exact resume. Then the
collective plane at the model's gradient bucket over a 4-member world: the
ring kernels and the Communicator verbs, first on the full-precision wire,
then on the quantized one (fp8 and int8). Then the EP plane over a 4-member
world: the all-to-all kernels against their plain versions and the
transpose, their timing at the MoE layer's dispatch buffer (B9 also at the
serving drives' exchanges), and the
DeepEP-shaped Buffer verbs through layer 0 of the bench config on every
wire. Then the sorted MoE layer's gather pair (csrc/moe_gather.cu) at both
benchmark cells' layers: each launch held to its plain version's bits and
timed beside its bytes bound and the launches it replaced (main_path counts
its launches: forward, recompute and backward of every layer). Then the
serving slice: ``python -m uccl_tpu_torch.serve --server``'s
engine on the MoE stack at the bench config's widths, EP world 4 on the
pallas wire (B9 in prefill and decode), every request held token for token
to the world-1 oracle, the same requests on the lax wire, and the dense
stack at world 1. Then the p2p plane (p2p_path): the MoE model's params
published from the card and pushed down a relay chain over loopback into a
server that must serve the source server's tokens, the remote KV tier, and
CUDA-tensor staging (mesh_path also holds interleaved 1F1B to sequential
autograd). Then the multi-process planes: dist_path (two pods, threads
over loopback DcnGroups: hierarchical_all_reduce at the gradient bucket
with its reduce-scatter leg on B5, compat.dist on CUDA tensors in two
processes, DDP gradients, the engram fetch, cross-pod EP forward and
backward against its oracle) and disagg_path (a prefill and a decode
worker on the MoE stack, B9 on both, every request equal to its replay;
the fleet prefix directory; the elastic KV cache, bit-equal to
decode_step). Last, resnet_path: ResNet-50 data-parallel at full width
(examples/ddp_train.py's mesh path, 4 members of 32 224x224 images, 5 steps),
its [4, 25,557,032] gradient bucket through the Communicator's "pallas"
all-reduce (B7) once a step, each sum bit-identical to ar_chain_plain, the
params bit-equal to the same steps with ar_chain_plain, each member's step 1
within a float64 rule that a planted TF32 run fails; with a traced step,
B7 timed three ways, an SLO burn read by doctor and two members' metrics
federated. Every phase raises on failure; nothing is caught. Each
phase prints one JSON line; the last three lines are the card's name and power limit (nvidia-smi), the
per-kernel JSON summary and

    {"ok": true, "device": {"platform": "gpu", "kind": "<GPU name>", "count": 1}}

It exits non-zero, before printing anything, when PyTorch sees no GPU.
"""

from __future__ import annotations

import contextlib
import ctypes
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
import tempfile
import threading
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: torch.cuda.is_available() is False; this script needs a GPU")

from uccl_tpu_torch import doctor, obs, profile_ep  # noqa: E402
from uccl_tpu_torch.collective import Communicator, dma, plan  # noqa: E402
from uccl_tpu_torch.collective import ring_ccl as rc  # noqa: E402
from uccl_tpu_torch.collective.lanes import SPIN_TIMEOUT_MS  # noqa: E402
from uccl_tpu_torch.ep import Buffer, a2a_sched  # noqa: E402
from uccl_tpu_torch.ep import gather  # noqa: E402
from uccl_tpu_torch.ep import ll as ep_ll  # noqa: E402
from uccl_tpu_torch.ep import ops as ep_ops  # noqa: E402
from uccl_tpu_torch.ep import pallas_a2a as pa  # noqa: E402
from uccl_tpu_torch.models import flagship, resnet  # noqa: E402
from uccl_tpu_torch.models.sampling import prng_key  # noqa: E402
from uccl_tpu_torch.parallel.mesh import AXIS, MeshConfig, make_mesh  # noqa: E402
from uccl_tpu_torch.models.layers import rms_norm, rope  # noqa: E402
from uccl_tpu_torch.ops import flash_attention as fa  # noqa: E402
from uccl_tpu_torch.ops import quant  # noqa: E402
from uccl_tpu_torch.ops.attention import _NEG_INF, HOPPER_TILES, _repeat_kv  # noqa: E402
from uccl_tpu_torch.train import _batch_for_step  # noqa: E402
from uccl_tpu_torch.obs import aggregate  # noqa: E402
from uccl_tpu_torch.utils import build, timing, tracing  # noqa: E402

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

# The f32 kernels (what the trainer runs): held to their plain versions by
# the f32 rule (fa.kernel_error at F32_KERNEL_ATOL_OF_ROW_RMS and
# F32_KERNEL_RTOL, 2^-14 each; lse to fa.F32_LSE_ATOL, 1e-5 absolute). Their
# bound is f32-accurate products at the 3xTF32 rate (three TF32 products
# each: 495 / 3 = 165 TFLOP/s), the FP32-FMA bound beside it.
PEAK_FP32_FLOPS = 66.9e12  # H100 SXM float32, non-tensor (an FMA is 2 operations)
PEAK_TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor-core peak
F32_REPLACES = {f"{name}_f32": path for name, path in REPLACES.items()}
F32_PRODUCTS = {f"{name}_f32": n for name, n in PRODUCTS.items()}
# Planted faults of the f32 kernels: text substitutions of the source,
# each built as a variant library (build.build_variant) beside the real
# ones. Each must fail the f32 rule at the main path's shape.
F32_FAULTS = {
    "out: causal mask off by one (the key past the diagonal let in)":
        ("fwd", [("(causal && key > row)", "(causal && key > row + 1)")]),
    "out: KV tile 2 dropped (the ring still streams it)":
        ("fwd", [("const int cols = Sk - k0;", "const int cols = k0 == 2 * kF32Rows ? 0 : Sk - k0;"),
                 ("return k0 + kF32Rows > Sk ||", "return k0 == 2 * kF32Rows || k0 + kF32Rows > Sk ||")]),
    "out: lo terms dropped (a single TF32 pass)":
        ("fwd", [("constexpr int kF32FwdTerms = 3;", "constexpr int kF32FwdTerms = 1;")]),
    "out: one cross term (lo hi) dropped":
        ("fwd", [("constexpr int kF32FwdTerms = 3;", "constexpr int kF32FwdTerms = 2;")]),
    "dq: KV tile 2 dropped (the ring still streams it)":
        ("dq", [("const float* sK = ring + (kt % R)",
                 "if (kt == 2) continue;\n    const float* sK = ring + (kt % R)")]),
    "dk: GQA sum over the next KV head's group":
        ("dkv", [("const int h_first = hk * n_rep;",
                  "const int h_first = ((hk + 1) % Hkv) * n_rep;")]),
    "dq: lo terms dropped (a single TF32 pass)":
        ("dq", [("constexpr int kDqTerms = 3;", "constexpr int kDqTerms = 1;")]),
    "dk: one cross term (lo hi) dropped":
        ("dkv", [("constexpr int kDkvTerms = 3;", "constexpr int kDkvTerms = 2;")]),
}
F32_FAULT_LIBS = {}  # fault -> built variant library path
FLASH_BUILD = {}  # flash kernel -> registers, spills, static and dynamic shared memory

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
    for tool in ("make", "g++"):  # the p2p plane's native runtime builds with make
        if shutil.which(tool) is None:
            fail(f"`{tool}` is not on PATH: the native p2p runtime (native/) cannot be built")
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
    """The three CUDA sources and the f32 kernels' planted-fault variants,
    one nvcc each, and the p2p plane's native runtime (make), all started
    together."""
    from concurrent.futures import ThreadPoolExecutor

    from uccl_tpu_torch.p2p import endpoint as p2p_endpoint

    def timed(name):
        t0 = time.perf_counter()
        return build.build(name), time.perf_counter() - t0

    t0 = time.perf_counter()
    def native():
        t0 = time.perf_counter()
        return p2p_endpoint._build_if_needed(), time.perf_counter() - t0

    with ThreadPoolExecutor(4 + len(F32_FAULTS)) as pool:
        native_job = pool.submit(native)
        jobs = [pool.submit(timed, name) for name in ("flash_attention", "ring_ccl", "ep_a2a")]
        faults = {fault: pool.submit(build.build_variant, "flash_attention", f"f32_fault_{i}",
                                     subs)
                  for i, (fault, (_, subs)) in enumerate(F32_FAULTS.items())}
        (lib, seconds), (ring_lib, ring_seconds), (ep_lib, ep_seconds) = \
            [j.result() for j in jobs]
        F32_FAULT_LIBS.update({fault: job.result() for fault, job in faults.items()})
        native_lib, native_seconds = native_job.result()
    root = build.PACKAGE_DIR.parent
    emit("p2p_native_build", library=os.path.relpath(native_lib, root),
         seconds=round(native_seconds, 3))
    name = re.compile(r"flash_(fwd|bwd_dq|bwd_dkv)(_f32)?_kernelILi(\d+)E(?:Li(\d+)E)?")
    ptxas = ptxas_report("flash_attention", lambda n: name.search(n)[0])
    f32_kind = {"fwd": 0, "bwd_dq": 1, "bwd_dkv": 2}
    for k in ptxas:  # each kernel's resident tiles and ring of stages are dynamic shared memory
        m = name.match(k["kernel"])
        d = int(m[3])
        if m[2]:
            k["dynamic_smem"] = fa._lib().uccl_flash_f32_smem(f32_kind[m[1]], d)
            continue
        tile = int(m[4])
        k["dynamic_smem"] = (fa._lib().uccl_flash_fwd_smem(d, tile) if m[1] == "fwd" else
                             fa._lib().uccl_flash_bwd_smem(int(m[1] == "bwd_dkv"), d, tile))
    FLASH_BUILD.update({k["kernel"]: k for k in ptxas})
    emit("build", library=str(lib.relative_to(root)), seconds=round(seconds, 3), ptxas=ptxas,
         f32_fault_variants=len(F32_FAULT_LIBS))
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

def attn_inputs(b, s, h, hkv, d, seed, dtype=torch.bfloat16, sk=None):
    g = torch.Generator(device=DEV).manual_seed(seed)
    sk = sk or s

    def t(*shape, dtype=dtype):
        return torch.randn(shape, generator=g, device=DEV).to(dtype)

    return dict(q=t(b, s, h, d), k=t(b, sk, hkv, d), v=t(b, sk, hkv, d),
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

def out_without_kv_tile(q, k, v, tile, rows=64, causal=True):
    """The forward's output had it skipped KV tile ``tile`` for every q row
    past that tile (causal), or for every q row."""
    n_rep = q.shape[2] // k.shape[2]
    kk, vv = (_repeat_kv(t.float(), n_rep) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) / math.sqrt(q.shape[-1])
    pos = torch.arange(q.shape[1], device=DEV)
    keep = pos[:, None] >= pos[None, :] if causal else torch.ones_like(s[0, 0], dtype=bool)
    keep[(tile + 1) * rows if causal else 0:, tile * rows:(tile + 1) * rows] = False
    p = torch.softmax(s.masked_fill(~keep, _NEG_INF), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vv).to(q.dtype)

def dq_without_kv_tile(q, k, v, dout, lse, delta, tile, rows=64, causal=True):
    """The dQ had it skipped KV tile ``tile`` for every q row past that tile
    (causal), or for every q row."""
    _, ds, n_rep = fa._plain_p_ds(q, k, v, dout, lse, delta, causal)
    ds[:, :, (tile + 1) * rows if causal else 0:, tile * rows:(tile + 1) * rows] = 0
    return torch.einsum("bhqk,bkhd->bqhd", ds, _repeat_kv(k.float(), n_rep)).to(q.dtype)

def planted_faults(x, plain, causal=True) -> None:
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
    dk_drop, dv_drop = fa.flash_bwd_dkv_plain(q, k, v, dout_drop, lse, delta_drop, causal)
    n_rep = q.shape[2] // k.shape[2]
    heads = torch.arange(q.shape[2], device=DEV) % n_rep == 1  # query head 1 of each group
    dout_head, delta_head = dout.clone(), delta.clone()
    dout_head[:, :, heads], delta_head[:, heads] = 0, 0
    dk_head, dv_head = fa.flash_bwd_dkv_plain(q, k, v, dout_head, lse, delta_head, causal)
    dk_glse, dv_glse = fa.flash_bwd_dkv(q, k, v, dout, lse, delta_no_glse, causal)
    faults = {
        "out: KV tile 1 dropped": (out_without_kv_tile(q, k, v, 1, causal=causal),
                                   plain["out"]),
        "dq: KV tile 1 dropped": (dq_without_kv_tile(q, k, v, dout, lse, delta, 1,
                                                     causal=causal), plain["dq"]),
        "dk: q tile 1 dropped": (dk_drop, plain["dk"]),
        "dv: q tile 1 dropped": (dv_drop, plain["dv"]),
        "dk: GQA query head 1 dropped": (dk_head, plain["dk"]),
        "dv: GQA query head 1 dropped": (dv_head, plain["dv"]),
        "dq: g_lse ignored": (fa.flash_bwd_dq(q, k, v, dout, lse, delta_no_glse, causal),
                              plain["dq"]),
        "dk: g_lse ignored": (dk_glse, plain["dk"]),
    }
    readings = {name: fa.kernel_error(got, want) for name, (got, want) in faults.items()}
    passed = [name for name, r in readings.items() if not r["worst"] > 1]
    if passed:
        fail(f"planted faults pass the check: {passed}")
    emit("planted_faults", shape=list(q.shape), causal=causal, readings=readings)

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
# 4b. The f32 kernels: against their plain versions, planted faults, timing

F32_RUN = {"fwd": fa.flash_fwd_f32, "dq": fa.flash_bwd_dq_f32, "dkv": fa.flash_bwd_dkv_f32}


def grads_float64(q, k, v, dout, lse, delta, causal) -> tuple:
    """dq, dk and dv of the backward's function in float64 from the same
    inputs, lse and delta (the plain versions' formulas)."""
    n_rep = q.shape[2] // k.shape[2]
    q, k, v, dout, lse, delta = (t.double() for t in (q, k, v, dout, lse, delta))
    kk, vv = (_repeat_kv(t, n_rep) for t in (k, v))
    scale = 1.0 / math.sqrt(q.shape[-1])
    sc = torch.einsum("bqhd,bkhd->bhqk", q, kk) * scale
    if causal:
        pos = torch.arange(q.shape[1], device=q.device)
        sc = sc.masked_fill(pos[:, None] < pos[None, :], _NEG_INF)
    p = torch.exp(sc - lse[..., None])
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dout, vv) - delta[..., None]) * scale
    b, sk, hkv, d = k.shape
    return (torch.einsum("bhqk,bkhd->bqhd", ds, kk),
            torch.einsum("bhqk,bqhd->bkhd", ds, q).reshape(b, sk, hkv, n_rep, d).sum(3),
            torch.einsum("bhqk,bqhd->bkhd", p, dout).reshape(b, sk, hkv, n_rep, d).sum(3))


def check_kernels_f32(b, s, h, hkv, d, causal, seed, sk=None, float64=False) -> tuple:
    """Each f32 kernel against its plain version on the same f32 inputs, with
    a nonzero lse cotangent, by the f32 rule; returns the readings, the
    inputs and the plain results (for the planted faults). With ``float64``
    the plain versions and the kernels are also read against the backward
    in float64 by the same rule: where dS = P (dP - delta) cancels (causal
    rows whose P sits on one column), the plain f32 result itself is off
    the float64 one, and only a kernel that rounds dP as the plain version
    does (B2's in-order FMA) meets the rule there."""
    x = attn_inputs(b, s, h, hkv, d, seed, dtype=torch.float32, sk=sk)
    q, k, v, dout = x["q"], x["k"], x["v"], x["dout"]
    shape = tuple(q.shape)
    out, lse = fa.flash_fwd_f32(q, k, v, causal)
    torch.cuda.synchronize()
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, causal)
    delta = fa.flash_delta(out_p, dout, x["g_lse"])
    dq = fa.flash_bwd_dq_f32(q, k, v, dout, lse_p, delta, causal)
    torch.cuda.synchronize()
    dk, dv = fa.flash_bwd_dkv_f32(q, k, v, dout, lse_p, delta, causal)
    torch.cuda.synchronize()
    dq_p = fa.flash_bwd_dq_plain(q, k, v, dout, lse_p, delta, causal)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, dout, lse_p, delta, causal)
    readings = {name: held(name, got, want, shape) for name, got, want in (
        ("out", out, out_p), ("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv, dv_p))}
    lse_err = (lse - lse_p).abs().max().item()
    if not lse_err <= fa.F32_LSE_ATOL:
        fail(f"f32 lse at q {shape}: max abs err {lse_err} > {fa.F32_LSE_ATOL}")
    readings["lse"] = {"max_abs_err": lse_err}
    vs_float64 = None
    if float64:
        exact = grads_float64(q, k, v, dout, lse_p, delta, causal)
        vs_float64 = {who: {name: fa.kernel_error(got, want.float())["worst"]
                            for name, got, want in zip(("dq", "dk", "dv"), grads, exact)}
                      for who, grads in (("plain", (dq_p, dk_p, dv_p)), ("kernel", (dq, dk, dv)))}
        del exact
    emit("f32_kernels_vs_plain",
         shape=dict(B=b, Sq=s, Sk=sk or s, H=h, Hkv=hkv, D=d, causal=causal),
         readings=readings, rtol=fa.F32_KERNEL_RTOL,
         atol_of_row_rms=fa.F32_KERNEL_ATOL_OF_ROW_RMS, lse_atol=fa.F32_LSE_ATOL,
         worst_vs_float64=vs_float64)
    plain = dict(out=out_p, lse=lse_p, delta=delta, dq=dq_p, dk=dk_p, dv=dv_p)
    return readings, x, plain


def f32_planted_faults(x, plain, causal=True) -> None:
    """Each planted fault of F32_FAULTS (a variant build of the source) run
    on the given inputs (the main path's; non-causal, those that are not of
    the causal mask): every one must fail the f32 rule."""
    q, k, v, dout = x["q"], x["k"], x["v"], x["dout"]
    lse, delta = plain["lse"], plain["delta"]
    real, readings = fa._lib, {}
    for fault, (kernel, _) in F32_FAULTS.items():
        if not causal and "causal mask" in fault:
            continue
        lib = fa.declare(ctypes.CDLL(str(F32_FAULT_LIBS[fault])))
        fa._lib = lambda lib=lib: lib
        try:
            if kernel == "fwd":
                got, want = fa.flash_fwd_f32(q, k, v, causal)[0], plain["out"]
            elif kernel == "dq":
                got, want = fa.flash_bwd_dq_f32(q, k, v, dout, lse, delta, causal), plain["dq"]
            else:
                got, want = (fa.flash_bwd_dkv_f32(q, k, v, dout, lse, delta, causal)[0],
                             plain["dk"])
            torch.cuda.synchronize()
        finally:
            fa._lib = real
        readings[fault] = fa.kernel_error(got, want)
    passed = [f for f, r in readings.items() if not r["worst"] > 1]
    if passed:
        fail(f"planted f32 faults pass the check: {passed}")
    emit("f32_planted_faults", shape=list(q.shape), causal=causal, readings=readings)


def f32_bound_ms(name, b, s, h, hkv, d, causal) -> tuple:
    """bound_ms's rule for an f32 kernel: its operations as f32-accurate
    products at the 3xTF32 rate (3 x operations over the TF32 peak), its f32
    bytes over the HBM rate; causal work counts the unmasked pairs. Returns
    (ms, "operations" | "bytes", the FP32-FMA bound: operations over the
    FP32 peak)."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = F32_PRODUCTS[name] * 2 * d * pairs * b * h
    qo, kv, rows = b * s * h * d * 4, b * s * hkv * d * 4, b * h * s * 4
    nbytes = {"flash_fwd_f32": 2 * qo + 2 * kv + rows,
              "flash_bwd_dq_f32": 3 * qo + 2 * kv + 2 * rows,
              "flash_bwd_dkv_f32": 2 * qo + 4 * kv + 2 * rows}[name]
    op_ms, byte_ms = 3 * flops / PEAK_TF32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else "bytes",
            max(flops / PEAK_FP32_FLOPS * 1e3, byte_ms))


def time_kernels_f32(b, s, h, hkv, d) -> dict:
    """The f32 kernels at the main path's shape: ms, the plain version's,
    the bound, and PyTorch's SDPA on the same f32 tensors (KV heads expanded
    beforehand) as the library yardstick: its forward, and its backward
    (dq, dk and dv in one autograd call: B2 + B3)."""
    import torch.nn.functional as F

    x = attn_inputs(b, s, h, hkv, d, seed=2, dtype=torch.float32)
    q, k, v, dout = x["q"], x["k"], x["v"], x["dout"]
    out, lse = fa.flash_fwd_f32(q, k, v, True)
    delta = fa.flash_delta(out, dout)
    runs = {
        "flash_fwd_f32": (lambda: fa.flash_fwd_f32(q, k, v, True),
                          lambda: fa.flash_fwd_plain(q, k, v, True)),
        "flash_bwd_dq_f32": (lambda: fa.flash_bwd_dq_f32(q, k, v, dout, lse, delta, True),
                             lambda: fa.flash_bwd_dq_plain(q, k, v, dout, lse, delta, True)),
        "flash_bwd_dkv_f32": (lambda: fa.flash_bwd_dkv_f32(q, k, v, dout, lse, delta, True),
                              lambda: fa.flash_bwd_dkv_plain(q, k, v, dout, lse, delta, True)),
    }
    res = {}
    for name, (kernel, plain) in runs.items():
        bnd, by, fma_bnd = f32_bound_ms(name, b, s, h, hkv, d, True)
        ms = time_ms(kernel, 30)
        res[name] = dict(ms=ms, plain_ms=time_ms(plain, 5), bound_ms=bnd, bound_by=by,
                         share_of_bound=bnd / ms, fp32_fma_bound_ms=fma_bnd,
                         share_of_fp32_fma_bound=fma_bnd / ms)
    rep = h // hkv
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt = k.repeat_interleave(rep, dim=2).transpose(1, 2).detach().requires_grad_()
    vt = v.repeat_interleave(rep, dim=2).transpose(1, 2).detach().requires_grad_()
    go = dout.transpose(1, 2)
    lib_fwd = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)  # noqa: E731
    lib_out = lib_fwd()
    lib_bwd = lambda: torch.autograd.grad(lib_out, (qt, kt, vt), go,  # noqa: E731
                                          retain_graph=True)
    lib_dq = lib_bwd()[0].transpose(1, 2)
    ours_dq = fa.flash_bwd_dq_f32(q, k, v, dout, lse, delta, True)
    with torch.no_grad():
        fwd_ms = time_ms(lib_fwd, 30)
    bwd_ms = time_ms(lib_bwd, 30)
    res["flash_fwd_f32"].update(library_ms=fwd_ms,
                                library_call="F.scaled_dot_product_attention (f32)")
    for name in ("flash_bwd_dq_f32", "flash_bwd_dkv_f32"):
        res[name].update(library_ms=bwd_ms,
                         library_call="autograd of F.scaled_dot_product_attention (f32: dq, "
                                      "dk and dv in one call: B2 + B3)")
    emit("f32_kernel_timing", shape=dict(B=b, S=s, H=h, Hkv=hkv, D=d, causal=True),
         kernels=res, ours_bwd_ms=res["flash_bwd_dq_f32"]["ms"] + res["flash_bwd_dkv_f32"]["ms"],
         library_bwd_ms=bwd_ms,
         library_dq_norm_ratio_vs_ours=((lib_dq - ours_dq).norm() / ours_dq.norm()).item(),
         build={k: FLASH_BUILD[k] for k in FLASH_BUILD if "_f32_" in k})
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
    params = flagship.init_params(prng_key(0), cfg, DEV)
    train_step, init_opt = flagship.make_train_step(cfg, DEV)
    opt_state = init_opt(params)
    batches = [_batch_for_step(i, BATCH, SEQ, cfg.vocab) for i in range(STEPS)]
    plain = against_plain_attention(cfg, params, batches)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(DEV)
    fa.reset_launch_counts()
    gather.reset_launch_counts()
    losses, step_ms = [], []
    for tokens, targets in batches:
        t = time.perf_counter()
        params, opt_state, metrics = train_step(params, opt_state, tokens, targets)
        losses.append(metrics["loss"].item())  # host read: the step has finished
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches = dict(fa.launch_counts)
    launches.update({f"moe_{role}": n for role, n in gather.launch_counts.items()})

    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite losses {losses}")
    # remat full: each layer's forward runs twice (the recompute), its
    # backward once
    want = {"flash_fwd": 2 * cfg.n_layers * STEPS, "flash_bwd_dq": cfg.n_layers * STEPS,
            "flash_bwd_dkv": cfg.n_layers * STEPS, **{n: 0 for n in fa.F32_KERNELS},
            **{f"moe_{role}": (1 if role.endswith("_bwd") else 2) * cfg.n_layers * STEPS
               for role in gather.ROLES}}
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
# 5b. The slice's path: python -m uccl_tpu_torch.train in float32

# The bench widths, float32 (the trainer's dtype on every device), through
# the trainer's own entry point.
TRAIN_WIDTHS = dict(vocab=16384, dim=1024, layers=4, heads=16, kv_heads=4, ffn=2816, experts=8)
TRAIN_STEPS = 4
# serve --ckpt-dir on the trained checkpoint: a few requests at EP world 1
SERVE_CKPT_TRAFFIC = dict(requests=4, prompt_len=128, min_prompt_len=32, new_tokens=16,
                          max_seq=160, arrival_rate=1.0, world=1, slots=4)
CORPUS_TOKENS = 4 * 2**20
# Step 1's loss through the f32 kernels against the same step through plain
# attention: every attention output differs by a few ulp (summation order),
# which moves the mean loss by ~1e-7 relative; a router near-tie that the
# ulps flip sends a token to another expert and moves the mean of 8192
# tokens' losses by ~1e-5 at most.
F32_LOSS_RTOL = 1e-4
# The ll path against the sort path at a capacity that drops nothing: the
# same routing and the same products, summed in another order (per-segment
# bmm against the capacity-padded einsum); tests/test_torch_flagship.py's
# tolerances, which the CPU holds the port to against JAX.
LL_LOSS_RTOL = 1e-5
LL_GRAD_RTOL, LL_GRAD_ATOL = 1e-3, 1e-5


def tree_items(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def tree_diff(a, b) -> float:
    """The largest |a - b| over two trees of the same structure (numbers
    count as tensors; a tensor of ``a`` is compared on ``b``'s device); 0.0
    when they are bit-identical."""
    worst = 0.0
    for (na, x), (nb, y) in zip(tree_items(a), tree_items(b), strict=True):
        if na != nb:
            fail(f"trees differ in structure at {na} / {nb}")
        if not torch.is_tensor(x):
            worst = worst if x == y else float("inf")
        elif x.shape != y.shape:
            worst = float("inf")
        elif not torch.equal(x := x.to(y.device), y):
            worst = max(worst, (x.double() - y.double()).abs().max().item())
    return worst


def grads_of(cfg, params, batch):
    """(loss, grads in tree_leaves order, ms, peak GiB) of one forward and
    backward of ``cfg``'s loss: the train step's products, without the
    update."""
    from uccl_tpu_torch.models import dense

    loss_fn = dense.loss_fn if isinstance(cfg, dense.DenseConfig) else \
        (lambda *a: flagship.loss_fn(*a)[0])
    leaves = [p.requires_grad_() for p in flagship.tree_leaves(params)]
    tokens, targets = (torch.as_tensor(t, device=DEV) for t in batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(DEV)
    t0 = time.perf_counter()
    loss = loss_fn(params, tokens, targets, cfg)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return loss.item(), grads, ms, torch.cuda.max_memory_allocated(DEV) / 2**30


def grads_diff(a, b) -> float:
    return max((x.double() - y.double()).abs().max().item() if not torch.equal(x, y) else 0.0
               for x, y in zip(a, b, strict=True))


def grads_close(got, want, rtol, atol) -> float:
    """The largest |got - want| / (atol + rtol |want|) over every leaf."""
    return max(((g - w).abs() / (atol + rtol * w.abs())).max().item()
               for g, w in zip(got, want, strict=True))


def train_flags() -> list:
    return ["--batch", str(BATCH), "--seq", str(SEQ), "--log-every", "1",
            "--device", DEV.type, *(f for k, v in TRAIN_WIDTHS.items()
                                    for f in (f"--{k.replace('_', '-')}", str(v)))]


def train_run(argv) -> tuple:
    """train.main on the card, with its wall seconds and peak GiB."""
    from uccl_tpu_torch import train

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(DEV)
    t0 = time.perf_counter()
    run = train.main([*train_flags(), *argv])
    torch.cuda.synchronize()
    return run, time.perf_counter() - t0, torch.cuda.max_memory_allocated(DEV) / 2**30


def time_steps(fam, cfg, batch, n=3, mesh=None) -> dict:
    """``n`` train steps of ``fam.make_train_step(cfg)`` (over ``mesh``, else
    at world 1) from the seed's weights on ``batch``, each waited for: the
    median ms of all but the first, the first's, the peak GiB and the first
    loss."""
    step, init_opt = fam.make_train_step(cfg, mesh or DEV)
    params = fam.init_params(prng_key(0), cfg, DEV)
    opt_state = init_opt(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(DEV)
    ms, losses = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, *batch)
        losses.append(metrics["loss"].item())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    if not all(map(math.isfinite, losses)):
        fail(f"non-finite losses {losses} for {cfg}")
    return dict(step_ms=statistics.median(ms[1:]), first_step_ms=ms[0], loss=losses[0],
                peak_gib=torch.cuda.max_memory_allocated(DEV) / 2**30)


def serve_checkpoint(ckpt_dir, params) -> dict:
    """serve --ckpt-dir's stack on the checkpoint against the same engine
    given ``params`` directly: a few requests (greedy and sampled), each
    one's tokens equal."""
    from uccl_tpu_torch import serve
    from uccl_tpu_torch.models.moe_inference import MoEServer
    from uccl_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from uccl_tpu_torch.serving.engine import MoEBackend

    traffic = SERVE_CKPT_TRAFFIC
    args = serve_args(TRAIN_WIDTHS, traffic, stack="moe", device=DEV.type,
                      slots=traffic["slots"])
    args.ckpt_dir = ckpt_dir
    serve.read_ckpt_config(args, serve.parser().parse_args([]))
    loaded, _, vocab = serve.build_stack(args, DEV)
    server = MoEServer(serve.moe_config(args), make_mesh(MeshConfig(dp=1), DEV, 1))
    direct = MoEBackend(server, server.shard_params(params), batch_local=args.slots,
                        max_seq=traffic["max_seq"], decode_impl="sort")
    workload = serve_workload(traffic, vocab, traffic["requests"], poisson=False)
    outs = [[r.out_tokens for r in serve_drive(b, workload, traffic, check=False)[1]]
            for b in (loaded, direct)]
    if outs[0] != outs[1] or not all(len(t) == traffic["new_tokens"] for t in outs[0]):
        fail(f"serve --ckpt-dir's tokens {outs[0]} != the engine's on the same params {outs[1]}")
    return {"ckpt_step": args.ckpt_step, "requests": len(outs[0]), "tokens_equal": True,
            "first_request": outs[0][0]}


def train_path() -> dict:
    """The slice's path on the card: python -m uccl_tpu_torch.train at the
    bench widths in float32 on a seeded token corpus (--data), 4 steps with
    a checkpoint every 2 (the flash f32 launches of this run are the
    kernels' main-path counts), the checkpoint round trip, serve --ckpt-dir
    on it, the same 4 steps again, a --resume from step 2 to 4, step 1
    against plain attention, every remat mode's gradients and one step each
    of dense, every remat mode and moe_impl="ll" (held to sort at a capacity
    that drops nothing). Returns the f32 launch counts of the first run."""
    from uccl_tpu_torch import train
    from uccl_tpu_torch.models import dense

    with tempfile.TemporaryDirectory(prefix="train_path_") as tmp:
        corpus = os.path.join(tmp, "corpus.npy")
        tokens = np.random.default_rng(0).integers(0, TRAIN_WIDTHS["vocab"], CORPUS_TOKENS,
                                                   dtype=np.int32)
        np.save(corpus, tokens)
        data = ["--data", corpus, "--steps", str(TRAIN_STEPS)]
        run_a_dir = os.path.join(tmp, "ckpt")
        fa.reset_launch_counts()
        a, a_s, a_gib = train_run([*data, "--ckpt-dir", run_a_dir, "--ckpt-every", "2"])
        launches = {n: fa.launch_counts[n] for n in fa.F32_KERNELS}
        if any(fa.launch_counts[n] for n in fa.BF16_KERNELS):
            fail(f"the f32 trainer launched bf16 kernels: {fa.launch_counts}")
        per_step = {n: c // TRAIN_STEPS for n, c in launches.items()}
        if per_step != {"flash_fwd_f32": 8, "flash_bwd_dq_f32": 4, "flash_bwd_dkv_f32": 4} \
                or any(c % TRAIN_STEPS for c in launches.values()):
            fail(f"f32 flash launches {launches} over {TRAIN_STEPS} steps, want 8/4/4 a step")
        losses = [m["loss"] for m in a.metrics]
        if a.summary["dtype"] != "float32" or not all(map(math.isfinite, losses)):
            fail(f"train run: {a.summary}, losses {losses}")
        state_a = {"params": a.params, "opt": a.opt_state}
        # the checkpoint round trip: every tensor of the state, exactly; then
        # serve --ckpt-dir on it
        last = os.path.join(run_a_dir, f"step_{TRAIN_STEPS}")
        if tree_diff(train.load_state(run_a_dir, TRAIN_STEPS), state_a) != 0.0:
            fail(f"step_{TRAIN_STEPS} does not load back bit for bit")
        served = serve_checkpoint(run_a_dir, a.params)
        # the same 4 steps again, and a resume from step 2 (the directory's
        # newest once step 4 is gone: a checkpoint is 3.85 GB at these widths)
        b, b_s, _ = train_run(data)
        spread = max(tree_diff({"params": b.params, "opt": b.opt_state}, state_a),
                     max(abs(x["loss"] - y["loss"]) for x, y in zip(a.metrics, b.metrics)))
        del b
        shutil.rmtree(last)
        c, c_s, _ = train_run([*data, "--ckpt-dir", run_a_dir, "--ckpt-every", "2",
                               "--resume"])
        resumed = max(tree_diff({"params": c.params, "opt": c.opt_state}, state_a),
                      max(abs(x["loss"] - y["loss"]) for x, y in zip(a.metrics[2:], c.metrics)))
        if c.summary["steps"] != 2 or resumed > spread or not os.path.isdir(last):
            fail(f"the resumed run differs from the uninterrupted one by {resumed} (the two "
                 f"uninterrupted runs by {spread}; steps {c.summary['steps']})")
        del c
        del a, state_a
    torch.cuda.empty_cache()

    # step 1 through the kernels against the same step through plain attention
    args = train.parser().parse_args(train_flags())
    cfg, params, _, _ = train.build(args, make_mesh(MeshConfig(), DEV))
    batch = _batch_for_step(0, BATCH, SEQ, cfg.vocab, tokens)
    with torch.no_grad():
        xla_loss = flagship.loss_fn(params, *(torch.as_tensor(t, device=DEV) for t in batch),
                                    dataclasses.replace(cfg, attn_impl="xla"))[0].item()
    loss_rel = abs(losses[0] - xla_loss) / abs(xla_loss)
    if not loss_rel <= F32_LOSS_RTOL:
        fail(f"step 1 loss {losses[0]} vs plain attention's {xla_loss}: rel {loss_rel}")

    # every remat mode's gradients (and full's twice: is the step deterministic?)
    modes, grads = {}, {}
    for mode in ("full", "full", "dots", "mlp", "none"):
        fa.reset_launch_counts()
        loss, g, ms, gib = grads_of(dataclasses.replace(cfg, remat=mode), params, batch)
        key = mode if mode not in modes else "full (again)"
        modes[key] = dict(loss=loss, fwd_bwd_ms=ms, peak_gib=gib,
                          f32_launches={n: fa.launch_counts[n] for n in fa.F32_KERNELS})
        grads[key] = g
    grad_spread = grads_diff(grads["full"], grads["full (again)"])
    for mode in ("dots", "mlp", "none"):
        modes[mode]["grad_diff_vs_full"] = d = grads_diff(grads[mode], grads["full"])
        if d > grad_spread:
            fail(f"remat {mode}'s gradients differ from full's by {d} (full against itself: "
                 f"{grad_spread})")
    full_grads = grads.pop("full")
    grads.clear()
    # moe_impl="ll" against sort at a capacity that drops nothing (E / k)
    ll_loss, ll_grads, ll_ms, ll_gib = grads_of(dataclasses.replace(cfg, moe_impl="ll"),
                                                params, batch)
    cf = cfg.moe_experts / cfg.moe_topk
    sort_loss, sort_grads, _, _ = grads_of(dataclasses.replace(cfg, capacity_factor=cf),
                                           params, batch)
    ll_rel = abs(ll_loss - sort_loss) / abs(sort_loss)
    ll_worst = grads_close(ll_grads, sort_grads, LL_GRAD_RTOL, LL_GRAD_ATOL)
    if not (ll_rel <= LL_LOSS_RTOL and ll_worst <= 1):
        fail(f"ll against sort at capacity factor {cf}: loss rel {ll_rel}, grads {ll_worst} "
             "of the limit")
    modes["ll"] = dict(loss=ll_loss, fwd_bwd_ms=ll_ms, peak_gib=ll_gib,
                       loss_rel_vs_sort=ll_rel, grads_worst_vs_sort=ll_worst)
    del ll_grads, sort_grads, full_grads, params
    torch.cuda.empty_cache()

    # one step each through the trainer's entry point: dense and each remat mode
    steps = {}
    for name, argv in (("dense", ["--model", "dense"]), ("dots", ["--remat", "dots"]),
                       ("mlp", ["--remat", "mlp"]), ("none", ["--remat", "none"])):
        fa.reset_launch_counts()
        run = train_run([*argv, "--steps", "1"])[0]
        steps[name] = dict(loss=run.metrics[0]["loss"],
                           f32_launches={n: fa.launch_counts[n] for n in fa.F32_KERNELS})
        if not math.isfinite(steps[name]["loss"]) or not all(steps[name]["f32_launches"].values()):
            fail(f"one {name} step: {steps[name]}")
        del run
    torch.cuda.empty_cache()
    # the step's time and peak memory in every mode (ll through the same step)
    dense_cfg = dense.DenseConfig(vocab=cfg.vocab, dim=cfg.dim, n_layers=cfg.n_layers,
                                  n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                                  head_dim=cfg.head_dim, ffn=cfg.moe_ffn)
    step_time = {mode: time_steps(flagship, dataclasses.replace(cfg, remat=mode), batch)
                 for mode in flagship.REMAT_MODES}
    step_time["ll"] = time_steps(flagship, dataclasses.replace(cfg, moe_impl="ll"), batch)
    step_time["dense"] = time_steps(dense, dense_cfg, batch)
    torch.cuda.empty_cache()
    emit("train_path", config={"flags": train_flags(), "dtype": "float32",
                               "steps": TRAIN_STEPS, "corpus_tokens": CORPUS_TOKENS},
         losses=losses, f32_launches=launches, f32_launches_per_step=per_step,
         run_s={"ckpt_every_2": a_s, "again": b_s, "resumed_2": c_s}, peak_gib=a_gib,
         straight_runs_max_diff=spread, deterministic=spread == 0.0, resumed_max_diff=resumed,
         step1_vs_plain_attention={"loss": losses[0], "plain": xla_loss, "rel": loss_rel,
                                   "rtol": F32_LOSS_RTOL},
         remat=modes, grad_spread_full_vs_full=grad_spread, one_step=steps,
         step_time=step_time, serve_ckpt=served)
    return launches

# ---------------------------------------------------------------------------
# 5c. The flagship at world > 1, every member on this one card

# Mesh A is the JAX trainer's own example (EP world 4, ring attention over
# cp); mesh B puts a 2-stage GPipe (2 microbatches) in front of cp and tp.
# Both at the bench widths in float32 on seed-0 weights, B = 8, S = 1024.
MESH_A = MeshConfig(dp=2, cp=2, tp=2)
MESH_B = MeshConfig(pp=2, cp=2, tp=2)
MESH_B_MICROBATCHES = 2
# One ring step's launch per member at mesh A (B/dp, S/cp, heads/tp, D): the
# shape the kernels are held to non-causally in main() as well
RING_SHARD = (4, 512, 8, 2, 64)
# A mesh against world 1 on the same params and batch, at capacity factor
# E/k (nothing drops, so capacity per member does not matter) and without
# the aux losses (a member computes them on its own tokens' routing, by
# design): the same function summed in another order (tp splits each
# product's reduction, the ring merges softmax blocks, 3xTF32 kernels).
MESH_LOSS_RTOL = 1e-5
MESH_GRAD_RTOL = 1e-4  # each leaf, relative in norm
# 1F1B against GPipe at the same mesh: tests/test_flagship.py:195-205's
ONE_F_ONE_B_LOSS_RTOL, ONE_F_ONE_B_GRAD_RTOL, ONE_F_ONE_B_GRAD_ATOL = 1e-5, 5e-3, 1e-5
MESH_TRAIN_STEPS = 4


@contextlib.contextmanager
def routing_capture(calls: list):
    """Record (router logits, top-k ids) of every routing decision made in
    the block: ``ep_ops._gate_topk``, which every sorted dispatch runs once
    per member."""
    real = ep_ops._gate_topk

    def spy(logits, k, renormalize):
        out = real(logits, k, renormalize)
        calls.append((logits.detach(), out[1].detach()))
        return out

    ep_ops._gate_topk = spy
    try:
        yield
    finally:
        ep_ops._gate_topk = real


def global_routing(calls, mcfg, m, n_layers, b, s):
    """The captured calls of one forward at mesh ``mcfg`` (``m`` microbatches)
    laid out globally: (top-k ids [L, B, S, K], router logits [L, B, S, E]).
    Calls come in GPipe slot order, then a stage's layers, then (pp, tp)
    groups, then EP members (dp outer); tp replicas route identically, so
    tp 0's are kept, and a stage's calls outside its valid slots dropped."""
    pp, dp, cp, tp = mcfg.axis_sizes()
    b_loc, s_loc = b // dp, s // cp
    b_mb, lps = b_loc // m, n_layers // pp
    k, e = calls[0][1].shape[-1], calls[0][0].shape[-1]
    idx = torch.full((n_layers, b, s, k), -1, dtype=torch.long, device=DEV)
    logits = torch.zeros((n_layers, b, s, e), device=DEV)
    it = iter(calls)
    for t in range(m + pp - 1):
        for i in range(lps):
            for g in range(pp * tp):
                stage, t_idx = divmod(g, tp)
                for r in range(dp * cp):
                    lg, ix = next(it)
                    mb = t - stage
                    if t_idx or not 0 <= mb < m:
                        continue
                    d, c = divmod(r, cp)
                    rows = slice(d * b_loc + mb * b_mb, d * b_loc + (mb + 1) * b_mb)
                    cols = slice(c * s_loc, (c + 1) * s_loc)
                    idx[stage * lps + i, rows, cols] = ix.reshape(b_mb, s_loc, k).long()
                    logits[stage * lps + i, rows, cols] = lg.reshape(b_mb, s_loc, e)
    if next(it, None) is not None or (idx < 0).any():
        fail(f"routing capture does not fit mesh {mcfg} with {m} microbatches")
    return idx, logits


def routing_vs_world1(got, want) -> dict:
    """Tokens whose top-k differs from world 1's; each must be a near tie in
    world 1's own router logits (C7): the smallest gap between its top k+1
    logits within NEAR_TIE of its largest |logit|."""
    idx, _ = got
    idx1, logits1 = want
    differs = (idx != idx1).any(-1)
    top = torch.sort(logits1, dim=-1, descending=True).values[..., :idx.shape[-1] + 1]
    gap = (top[..., :-1] - top[..., 1:]).amin(-1)
    near = gap <= NEAR_TIE * logits1.abs().amax(-1)
    if (differs & ~near).any():
        fail(f"{int((differs & ~near).sum())} tokens route differently from world 1 "
             "away from a near tie")
    return {"tokens_differing": int(differs.sum()), "token_layers": differs.numel(),
            "near_ties_in_world1": int(near.sum())}


def expected_flash_launches(cfg, mcfg, m) -> dict:
    """f32 flash launches of one GPipe forward and backward with remat full:
    each layer call launches once per ring step (cp) or once (cp = 1,
    Ulysses); forward and the recompute each launch B1, the backward B2 and
    B3 once."""
    per_call = mcfg.cp if mcfg.cp > 1 and cfg.seq_mode == "ring" else 1
    calls = (m + mcfg.pp - 1) * (cfg.n_layers // mcfg.pp)
    return {"flash_fwd_f32": 2 * calls * per_call, "flash_bwd_dq_f32": calls * per_call,
            "flash_bwd_dkv_f32": calls * per_call}


def expected_1f1b_launches(cfg, mcfg, m) -> dict:
    """f32 flash launches of one manual 1F1B step with remat full: a slot in
    which some stage runs a forward launches B1 once per layer call; one in
    which some stage runs a backward recomputes the stage (B1), the remat
    recompute (B1 again) and the backward (B2, B3)."""
    from uccl_tpu_torch.parallel.pipeline import _simulate_1f1b

    do_f, _, do_b, _ = _simulate_1f1b(m, mcfg.pp)
    per_slot = (mcfg.cp if mcfg.cp > 1 and cfg.seq_mode == "ring" else 1) * (
        cfg.n_layers // mcfg.pp)
    f_slots, b_slots = int(do_f.any(axis=1).sum()), int(do_b.any(axis=1).sum())
    return {"flash_fwd_f32": (f_slots + 2 * b_slots) * per_slot,
            "flash_bwd_dq_f32": b_slots * per_slot, "flash_bwd_dkv_f32": b_slots * per_slot}


def mesh_grads(cfg, mesh, params, batch, manual=False) -> dict:
    """One forward and backward of ``cfg``'s total loss over ``mesh``
    (autograd through GPipe, or the manual 1F1B schedule): loss, gradients
    in tree_leaves order, wall ms, peak GiB, f32 flash launches and the
    forward's routing calls."""
    leaves = [p.requires_grad_() for p in flagship.tree_leaves(params)]
    tokens, targets = (torch.as_tensor(t, device=DEV) for t in batch)
    calls = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(DEV)
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    if manual:
        total, ce, g = flagship.manual_loss_and_grads(params, tokens, targets, cfg, mesh)
        grads = flagship.tree_leaves(g)
    else:
        with routing_capture(calls):
            total, ce = flagship.loss_fn(params, tokens, targets, cfg, mesh)
        grads = torch.autograd.grad(total, leaves)
    loss = total.item()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if not math.isfinite(loss) or not all(torch.isfinite(x).all() for x in grads):
        fail(f"non-finite loss or gradients at {mesh.config}: {loss}")
    return dict(loss=loss, ce=ce.item(), grads=grads, ms=ms,
                peak_gib=torch.cuda.max_memory_allocated(DEV) / 2**30,
                launches={n: fa.launch_counts[n] for n in fa.F32_KERNELS}, calls=calls)


def grads_rel_norm(got, want) -> float:
    """The largest ||got - want|| / ||want|| over the leaves."""
    return max(((g.double() - w.double()).norm() / w.double().norm()).item()
               for g, w in zip(got, want, strict=True))


# Interleaved 1F1B (parallel/pipeline.interleaved_1f1b) on
# tests/test_pipeline.py::TestInterleaved's stage MLPs, y = tanh(x @ w + b),
# at width 1024 (weights drawn at 0.3 / sqrt(h / 8), the test's 0.3 at its
# width 8), P = 2 stages of V = 2 chunks, M = 4 microbatches of 8 rows, in
# float32 with every member on the card; held to sequential autograd at the
# test's tolerances.
INTERLEAVED = dict(p=2, v=2, m=4, rows=8, width=1024)
INTERLEAVED_TOL = dict(loss_rtol=1e-5, grad_rtol=1e-4, grad_atol=1e-5)

def interleaved_vs_sequential(device=DEV, sizes=INTERLEAVED) -> dict:
    from uccl_tpu_torch.parallel.pipeline import _simulate_interleaved, interleaved_1f1b

    p, v, m, b, h = (sizes[k] for k in ("p", "v", "m", "rows", "width"))
    n = p * v
    g = torch.Generator(device=device).manual_seed(0)
    ws = torch.randn(n, h, h, device=device, generator=g) * (0.3 / math.sqrt(h / 8))
    bs = torch.randn(n, h, device=device, generator=g) * 0.1
    xmb = torch.randn(m, b, h, device=device, generator=g)

    def chunks(a):  # [L, ...] stage-major -> [P, V, ...]: chunk c of stage s is c*P + s
        return a.reshape((v, p) + tuple(a.shape[1:])).transpose(0, 1).contiguous()

    def stage(prm, x):
        return torch.tanh(x @ prm[0] + prm[1][:, None])

    def loss(y):
        return (y * y).sum(dim=(1, 2))

    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    got_l, (dw, db) = interleaved_1f1b(stage, loss, (chunks(ws), chunks(bs)),
                                       xmb.expand((p,) + tuple(xmb.shape)).contiguous(),
                                       n_chunks=v)
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    w_seq, b_seq = ws.clone().requires_grad_(), bs.clone().requires_grad_()
    total = 0.0
    for k in range(m):
        x = xmb[k]
        for i in range(n):
            x = torch.tanh(x @ w_seq[i] + b_seq[i])
        total = total + (x * x).sum()
    gw, gb = torch.autograd.grad(total, [w_seq, b_seq])
    tol = INTERLEAVED_TOL

    def of_tol(got, want):  # max |got - want| / (atol + rtol |want|): <= 1 passes
        return ((got - want).abs() / (tol["grad_atol"] + tol["grad_rtol"] * want.abs())).max().item()

    loss_rel = max(abs(got_l[s].item() - total.item()) for s in range(p)) / abs(total.item())
    grads = max(of_tol(dw, chunks(gw)), of_tol(db, chunks(gb)))
    if not (loss_rel <= tol["loss_rtol"] and grads <= 1):
        fail(f"interleaved 1F1B against sequential autograd: loss rel {loss_rel}, gradients "
             f"{grads} of the tolerance")
    return dict(sizes=sizes, tolerances=tol, loss=got_l[0].item(), sequential_loss=total.item(),
                loss_rel=loss_rel, grads_of_tolerance=grads, ms=ms,
                slots=int(_simulate_interleaved(m, p, v)["do_f"].shape[0]))

def mesh_path() -> dict:
    """The flagship at world > 1 with every member on the card, at the bench
    widths in float32: mesh A (dp=2, cp=2, tp=2: ring attention on the f32
    kernels, EP world 4) and Ulysses, then mesh B (pp=2, cp=2, tp=2, GPipe
    over 2 microbatches), each forward and backward held against world 1 on
    the same params and batch (loss, every gradient leaf, every token's
    top-2 routing) with exact f32 flash launches; mesh B's 1F1B against its
    GPipe; mesh A's forward on the pallas wire (B9) against the lax wire,
    bit for bit; the step time of each; then ``python -m
    uccl_tpu_torch.train --mesh dp=2,cp=2,tp=2`` on a seeded corpus with
    checkpoints and a bit-exact --resume. Returns the f32 flash launches of
    that trainer run and B9's launches."""
    from uccl_tpu_torch import train

    t_start = time.perf_counter()
    w = TRAIN_WIDTHS
    size = dict(vocab=w["vocab"], dim=w["dim"], n_layers=w["layers"], n_heads=w["heads"],
                n_kv_heads=w["kv_heads"], head_dim=w["dim"] // w["heads"], moe_experts=w["experts"],
                moe_topk=2, moe_ffn=w["ffn"])
    cfg = flagship.FlagshipConfig(**size, capacity_factor=size["moe_experts"] / 2,
                                  aux_loss_weight=0.0, z_loss_weight=0.0)
    params = flagship.init_params(prng_key(0), cfg, DEV)
    corpus = np.random.default_rng(0).integers(0, w["vocab"], CORPUS_TOKENS, dtype=np.int32)
    batch = _batch_for_step(0, BATCH, SEQ, w["vocab"], corpus)
    mesh_a, mesh_b = make_mesh(MESH_A, DEV), make_mesh(MESH_B, DEV)
    readings = {}

    def held(name, run, ref, mcfg, m, run_cfg):
        want = expected_flash_launches(run_cfg, mcfg, m)
        if run["launches"] != want:
            fail(f"{name}: f32 flash launches {run['launches']}, want {want}")
        loss_rel = abs(run["loss"] - ref["loss"]) / abs(ref["loss"])
        grad_rel = grads_rel_norm(run["grads"], ref["grads"])
        if not (loss_rel <= MESH_LOSS_RTOL and grad_rel <= MESH_GRAD_RTOL):
            fail(f"{name} against world 1: loss rel {loss_rel}, gradient rel {grad_rel}")
        routing = routing_vs_world1(global_routing(run["calls"], mcfg, m, cfg.n_layers, BATCH,
                                                   SEQ),
                                    global_routing(ref["calls"], MeshConfig(), m, cfg.n_layers,
                                                   BATCH, SEQ))
        readings[name] = dict(loss=run["loss"], world1_loss=ref["loss"], loss_rel=loss_rel,
                              grad_rel_norm=grad_rel, routing=routing, ms=run["ms"],
                              world1_ms=ref["ms"], peak_gib=run["peak_gib"],
                              launches=run["launches"])

    world1 = mesh_grads(cfg, None, params, batch)
    want1 = expected_flash_launches(cfg, MeshConfig(), 1)
    if world1["launches"] != want1:
        fail(f"world 1: f32 flash launches {world1['launches']}, want {want1}")
    held("mesh_a_ring", mesh_grads(cfg, mesh_a, params, batch), world1, MESH_A, 1, cfg)
    ulysses = dataclasses.replace(cfg, seq_mode="ulysses")
    held("mesh_a_ulysses", mesh_grads(ulysses, mesh_a, params, batch), world1, MESH_A, 1,
         ulysses)
    del world1
    # the pallas wire (B9; forward only) against the lax wire
    fb0 = dma.WIRE_FALLBACK.total()
    tokens = torch.as_tensor(batch[0], device=DEV)
    with torch.no_grad():
        lax_logits = flagship.forward(params, tokens, cfg, mesh_a)
        a0 = pa.launch_counts["a2a"]
        pallas_logits = flagship.forward(params, tokens,
                                         dataclasses.replace(cfg, moe_wire="pallas"), mesh_a)
        b9 = pa.launch_counts["a2a"] - a0
    if not torch.equal(pallas_logits, lax_logits) or not b9 \
            or dma.WIRE_FALLBACK.total() != fb0:
        fail(f"mesh A on the pallas wire: equal {torch.equal(pallas_logits, lax_logits)}, "
             f"{b9} B9 launches, {dma.WIRE_FALLBACK.total() - fb0} fallbacks")
    readings["mesh_a_pallas_wire"] = dict(bit_identical=True, b9_launches=b9,
                                          max_abs_logit=lax_logits.abs().max().item())
    del lax_logits, pallas_logits
    torch.cuda.empty_cache()

    cfg_b = dataclasses.replace(cfg, n_microbatches=MESH_B_MICROBATCHES)
    world1 = mesh_grads(cfg_b, None, params, batch)
    gpipe = mesh_grads(cfg_b, mesh_b, params, batch)
    held("mesh_b_gpipe", gpipe, world1, MESH_B, MESH_B_MICROBATCHES, cfg_b)
    del world1
    manual = mesh_grads(dataclasses.replace(cfg_b, pp_schedule="1f1b"), mesh_b, params, batch,
                        manual=True)
    loss_rel = abs(manual["loss"] - gpipe["loss"]) / abs(gpipe["loss"])
    close = grads_close(manual["grads"], gpipe["grads"], ONE_F_ONE_B_GRAD_RTOL,
                        ONE_F_ONE_B_GRAD_ATOL)
    if not (loss_rel <= ONE_F_ONE_B_LOSS_RTOL and close <= 1):
        fail(f"1F1B against GPipe at mesh B: loss rel {loss_rel}, gradients {close} of the "
             "tolerance")
    want = expected_1f1b_launches(cfg_b, MESH_B, MESH_B_MICROBATCHES)
    if manual["launches"] != want:
        fail(f"1F1B at mesh B: f32 flash launches {manual['launches']}, want {want}")
    readings["mesh_b_1f1b"] = dict(loss=manual["loss"], gpipe_loss=gpipe["loss"],
                                   loss_rel=loss_rel, grads_of_tolerance=close,
                                   grad_rel_norm=grads_rel_norm(manual["grads"], gpipe["grads"]),
                                   ms=manual["ms"], gpipe_ms=gpipe["ms"],
                                   peak_gib=manual["peak_gib"], launches=manual["launches"])
    del gpipe, manual, params
    torch.cuda.empty_cache()
    readings["interleaved_1f1b"] = interleaved_vs_sequential()
    torch.cuda.empty_cache()

    # the step at each mesh, as a user trains (the aux losses on, capacity
    # factor 1.25)
    train_cfg = flagship.FlagshipConfig(**size, capacity_factor=1.25)
    step_time = {
        "mesh_a": time_steps(flagship, train_cfg, batch, mesh=mesh_a),
        "mesh_b_gpipe": time_steps(flagship, dataclasses.replace(
            train_cfg, n_microbatches=MESH_B_MICROBATCHES), batch, mesh=mesh_b),
        "mesh_b_1f1b": time_steps(flagship, dataclasses.replace(
            train_cfg, n_microbatches=MESH_B_MICROBATCHES, pp_schedule="1f1b"), batch,
            mesh=mesh_b),
    }
    for t in step_time.values():
        t["tokens_per_s"] = BATCH * SEQ / (t["step_ms"] / 1e3)
    torch.cuda.empty_cache()

    # the trainer's --mesh: 4 steps with a checkpoint every 2, a resume from 2
    with tempfile.TemporaryDirectory(prefix="mesh_path_") as tmp:
        path = os.path.join(tmp, "corpus.npy")
        np.save(path, corpus)
        flags = ["--mesh", "dp=2,cp=2,tp=2", "--data", path, "--steps", str(MESH_TRAIN_STEPS)]
        ckpt = os.path.join(tmp, "ckpt")
        fa.reset_launch_counts()
        a, a_s, a_gib = train_run([*flags, "--ckpt-dir", ckpt, "--ckpt-every", "2"])
        launches = {n: fa.launch_counts[n] for n in fa.F32_KERNELS}
        want = {n: c * MESH_TRAIN_STEPS for n, c in expected_flash_launches(
            dataclasses.replace(cfg, capacity_factor=1.25), MESH_A, 1).items()}
        losses = [m["loss"] for m in a.metrics]
        if launches != want or not all(map(math.isfinite, losses)) \
                or a.summary["mesh"] != {"pp": 1, "dp": 2, "cp": 2, "tp": 2}:
            fail(f"train --mesh: launches {launches} (want {want}), {a.summary}")
        state_a = {"params": a.params, "opt": a.opt_state}
        shutil.rmtree(os.path.join(ckpt, f"step_{MESH_TRAIN_STEPS}"))
        c, c_s, _ = train_run([*flags, "--ckpt-dir", ckpt, "--resume"])
        resumed = max(tree_diff({"params": c.params, "opt": c.opt_state}, state_a),
                      max(abs(x["loss"] - y["loss"]) for x, y in zip(a.metrics[2:], c.metrics)))
        del c
        spread = None
        if resumed != 0.0:  # train_path's rule: within two straight runs' spread
            b, _, _ = train_run(flags)
            spread = max(tree_diff({"params": b.params, "opt": b.opt_state}, state_a),
                         max(abs(x["loss"] - y["loss"]) for x, y in zip(a.metrics, b.metrics)))
            del b
            if resumed > spread:
                fail(f"train --mesh resumed differs by {resumed}, two straight runs by {spread}")
        del a, state_a
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_start
    emit("mesh_path", config={"widths": w, "batch": BATCH, "seq": SEQ, "dtype": "float32",
                              "mesh_a": MESH_A.axis_sizes(), "mesh_b": MESH_B.axis_sizes(),
                              "mesh_b_microbatches": MESH_B_MICROBATCHES,
                              "parity_capacity_factor": cfg.capacity_factor},
         tolerances={"loss_rtol": MESH_LOSS_RTOL, "grad_rel_norm": MESH_GRAD_RTOL,
                     "one_f_one_b": [ONE_F_ONE_B_LOSS_RTOL, ONE_F_ONE_B_GRAD_RTOL,
                                     ONE_F_ONE_B_GRAD_ATOL], "near_tie": NEAR_TIE},
         readings=readings, step_time=step_time,
         train_mesh={"losses": losses, "run_s": a_s, "resumed_s": c_s, "peak_gib": a_gib,
                     "launches": launches, "resumed_max_diff": resumed,
                     "straight_runs_max_diff": spread},
         card=nvidia_smi_line(), seconds=seconds)
    return {**launches, "a2a": b9}

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

BUCKET_SHAPES = []  # the bench config's parameter shapes, in bucket order

def gradient_bucket() -> torch.Tensor:
    """The members' payloads [W, BUCKET]: each member's gradient of the
    bench-config flagship on its own batch (B=8, S=1024), flattened in
    parameter order."""
    cfg = flagship.bench_config()
    params = flagship.init_params(prng_key(0), cfg, DEV)
    leaves = [p.requires_grad_() for p in flagship.tree_leaves(params)]
    BUCKET_SHAPES[:] = [tuple(p.shape) for p in leaves]
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
    timed_out = missing_arrival(view)
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
    emit("ep_planted_faults", W=n, readings=faults, a2a_missing_arrival=timed_out)

def missing_arrival(view) -> str:
    """B9's protocol fault: pair (1, 3)'s piece 0 copied but its arrival
    word never raised must time out through the error word (member 3's
    receive wait, waiting on member 1) and return; the flag region must
    work again afterwards. Returns the wrapper's error message."""
    SPIN_TIMEOUT_MS.set(200)
    try:
        lane = pa._launch("a2a", view, torch.empty_like(view), dma.CID_A2A, drop=(1, 3))
        try:
            lane.check("a2a")
        except RuntimeError as e:
            message = str(e)
            if "receive wait (member 3," not in message or "member 1," not in message:
                fail(f"a2a missing arrival: the error word names another wait: {e}")
        else:
            fail("a2a missing arrival: the launch did not time out")
    finally:
        SPIN_TIMEOUT_MS.set(None)
    out = torch.empty_like(view)
    pa.launch_a2a(view, out, dma.CID_A2A).check("a2a")
    if not torch.equal(out, pa.a2a_plain(view)):
        fail("a2a after a missing arrival differs from a2a_plain")
    return message

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

# The serving drives' f32 exchanges, member-stacked [W, W, ...]: an LL
# decode of 4 rows a member, a verify window ([16, 3] tokens sorted into 2
# experts at capacity 6), a 128-token chunk prefill at capacity 128
SERVE_A2A_SHAPES = {"decode": (4, 4, 4, 1024), "verify": (4, 4, 2, 6, 1024),
                    "chunk_prefill": (4, 4, 2, 128, 1024)}
EP_SWEEP_MIB = (1 / 16, 1 / 4) + SWEEP_MIB

def b9_at_serving_shapes() -> dict:
    """B9 at the serving drives' exchanges, on synthetic f32 inputs of their
    shapes: CUDA-event medians (L2 flushed, median of 10) beside the bound
    (2 x bytes / 3.35 TB/s), its plain version, the library call and the
    pair grid (pieces per pair, blocks per member) the kernel chose."""
    out = {}
    for kind, shape in SERVE_A2A_SHAPES.items():
        x = ep_inputs(shape[0], shape[2:], torch.float32, seed=70)
        view, _, _ = pa._view(x)
        res = torch.empty_like(view)
        pending = []
        ms = time_ms(lambda: pending.append(pa.launch_a2a(view, res, dma.CID_A2A)), 10)
        for lane in pending:
            lane.check("b9 at serving shapes")
        if not torch.equal(res, pa.a2a_plain(view)):
            fail(f"B9 at the {kind} shape differs from a2a_plain")
        p, xb, blocks = pa.kernel_grid(shape[0], view[0, 0].numel() * view.element_size())
        bnd = ep_bound_ms(x.numel() * x.element_size())
        lib = time_ms(lambda: x.transpose(0, 1).contiguous(), 10)
        out[kind] = dict(shape=list(shape), dtype="float32", ms=ms, bound_ms=bnd,
                         bound_by="bytes", share_of_bound=bnd / ms,
                         plain_ms=time_ms(lambda: pa.a2a_plain(view), 3), library_ms=lib,
                         library_call="x.transpose(0, 1).contiguous()",
                         vs_library=ms / lib, pieces_per_pair=p, blocks_per_member=xb,
                         resident_blocks=blocks)
    return out

def ep_a2a_timing() -> dict:
    """CUDA-event medians (L2 flushed, median of 10) at the MoE layer's
    dispatch buffer, [W, E_local, C, H] bf16 per member: B9, the B9 chunk
    pair, and B10's whole Zipf schedule (its rounds write the receive buffer
    itself: nothing to assemble), each beside the bound, its plain version
    and the library call ``x.transpose(0, 1).contiguous()``; B9 at the
    serving drives' f32 exchanges (b9_at_serving_shapes); then a
    1/16-to-256 MiB-per-member sweep."""
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
    res["a2a"]["serving"] = b9_at_serving_shapes()
    del runs, lanes
    sweep = []
    for mib in EP_SWEEP_MIB:
        per_chunk = int(mib * 2 ** 20) // 2 // EP_WORLD  # bf16 elements per destination chunk
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

# ---------------------------------------------------------------------------
# 8b. The sorted MoE layer's gather pair (csrc/moe_gather.cu, ep/gather.py)

GATHER_SOURCE = "uccl_tpu_torch/csrc/moe_gather.cu"
GATHER_REPLACES = ("none: uccl_tpu/ep/ops.py's dispatch_sorted and combine_sorted are "
                   "jnp.take and an einsum under XLA")
# (cell, tokens, hidden, capacity): each benchmark cell's MoE layer at world
# 1, 8 experts, top-2, bf16, routed as by a random router
GATHER_CELLS = (("flagship", 131072, 1024, 40960), ("mixtral", 4096, 4096, 4096))
GATHER_LIBRARY = "the replaced path: the zero-padded gathers, their index_put backward"

def gather_bytes(plan, t, h, e, c, k=2, itemsize=2) -> dict:
    """Compulsory bytes of each launch of the pair: each row it needs read
    once, each output row written once, the int32 maps and float32 weights
    once."""
    kept, n, row = int((plan.slot < e * c).sum()), e * c, h * itemsize
    return {"dispatch": (kept + n) * row + 4 * n,
            "dispatch_bwd": (kept + t) * row + 4 * t * k,
            "combine": (kept + t) * row + 8 * t * k,
            "combine_bwd": (t + kept + n) * row + 12 * t * k}

def moe_gather_timing() -> dict:
    """Each launch of the gather pair at the two cells' MoE layers, held to
    its plain version (the bits; dw within its float32 rounding), then
    CUDA-event medians (L2 flushed, median of 10) beside its bytes bound,
    its plain version and the launch it replaced: the gather from a
    zero-padded copy forward, and through autograd backward (index_put
    accumulating into the padded rows; the combine's [T, K, H] sum)."""
    res = {}
    for cell, t, h, c in GATHER_CELLS:
        e, k = 8, 2
        g = torch.Generator(device=DEV).manual_seed(70)
        topk = torch.randn((1, t, e), generator=g, device=DEV).argsort(-1, descending=True)
        plan = ep_ops.plan_slots(topk[..., :k], e, c)
        tfs, slot = plan.token_for_slot, plan.slot
        x, y, dxe = (torch.randn(shape, generator=g, device=DEV).bfloat16()
                     for shape in ((1, t, h), (1, e * c, h), (1, e * c, h)))
        wts = torch.rand((1, t, k), generator=g, device=DEV)
        dout = torch.randn((1, t, h), generator=g, device=DEV).bfloat16()
        runs = {"dispatch": (lambda: gather.gather_rows(x, tfs),
                             lambda: gather.gather_rows_plain(x, tfs)),
                "dispatch_bwd": (lambda: gather.gather_sum(dxe, slot, role="dispatch_bwd"),
                                 lambda: gather.gather_sum_plain(dxe, slot)),
                "combine": (lambda: gather.gather_sum(y, slot, wts),
                            lambda: gather.gather_sum_plain(y, slot, wts)),
                "combine_bwd": (lambda: gather.scatter_rows(dout, y, slot, wts),
                                lambda: gather.scatter_rows_plain(dout, y, slot, wts))}
        for role, (kernel, plain) in runs.items():
            got, want = kernel(), plain()
            if role == "combine_bwd":
                (got, dw), (want, dw_p) = got, want
                index, _ = gather._choices(slot, e * c)
                mag = torch.stack([(dout.float().abs() * gather._rows_at(y, index[..., j])
                                    .float().abs()).sum(-1) for j in range(k)], -1)
                dw_err = float((dw - dw_p).abs().max())
                if not bool(((dw - dw_p).abs() <= h * 2**-24 * mag).all()):
                    fail(f"moe gather {cell} dw: off its plain version by {dw_err}")
            if not torch.equal(got, want):
                fail(f"moe gather {cell} {role}: not its plain version's bits")
        del got, want
        leaves = [a.clone().requires_grad_() for a in (x, y, wts)]
        old_xe = ep_ops._take_member_rows(leaves[0], tfs)
        old_out = ep_ops._weighted_sum(leaves[2], ep_ops._take_member_rows(leaves[1], slot))
        replaced = {
            "dispatch": lambda: ep_ops._take_member_rows(x, tfs),
            "dispatch_bwd": lambda: torch.autograd.grad(old_xe, leaves[0], dxe,
                                                        retain_graph=True),
            "combine": lambda: ep_ops._weighted_sum(wts, ep_ops._take_member_rows(y, slot)),
            "combine_bwd": lambda: torch.autograd.grad(old_out, leaves[1:], dout,
                                                       retain_graph=True)}
        nbytes = gather_bytes(plan, t, h, e, c, k)
        res[cell] = {}
        for role, (kernel, plain) in runs.items():
            ms, bnd = time_ms(kernel, 10), nbytes[role] / PEAK_BYTES * 1e3
            res[cell][role] = dict(ms=ms, bound_ms=bnd, bound_by="bytes",
                                   share_of_bound=bnd / ms, plain_ms=time_ms(plain, 3),
                                   library_ms=time_ms(replaced[role], 5),
                                   library_call=GATHER_LIBRARY, bytes=nbytes[role])
        layer = {key: sum(r[key] for r in res[cell].values())
                 for key in ("ms", "bound_ms", "library_ms")}
        res[cell]["combine_bwd"]["dw_max_abs_err"] = dw_err
        res[cell]["layer"] = dict(layer, share_of_bound=layer["bound_ms"] / layer["ms"],
                                  kept=int((slot < e * c).sum()),
                                  empty_slots=int((tfs == t).sum()))
        del runs, replaced, leaves, old_xe, old_out, x, y, dxe, dout
        torch.cuda.empty_cache()
    emit("moe_gather_timing", cells={cell: [t, h, 8, c] for cell, t, h, c in GATHER_CELLS},
         dtype="bfloat16", kernels=res)
    return res

# The serving slice: python -m uccl_tpu_torch.serve --server on the MoE stack
# at the bench config's widths (flagship.bench_config: vocab 16384, dim 1024,
# 4 layers, 16/4 heads of 64, 8 experts top-2, ffn 2816) with the serving
# capacity factor 8.0, EP world 4 on the one card, 16 slots, on the pallas
# wire; 8 Poisson requests (8 req/s) of 128-896 prompt tokens and 64 new
# tokens, half greedy and half sampled (T 0.8, top-p 0.95, top-k 50, one
# seed each): 32 until serve_features_path came, cut to keep the script
# near half its time limit. Then the dense stack at world 1, same widths,
# 8 requests.
SERVE_WIDTHS = dict(vocab=16384, dim=1024, layers=4, heads=16, kv_heads=4, ffn=2816, experts=8)
SERVE_TRAFFIC = dict(requests=8, prompt_len=896, min_prompt_len=128, new_tokens=64,
                     max_seq=1024, arrival_rate=8.0, slots=16, world=4)
SERVE_DENSE_REQUESTS = 8
# the backend call whose first B9 input serve_path keeps (the pool is full
# by then), or the last call of that kind when the drive has fewer
B9_CAPTURE_CALL = {"prefill": 2, "decode": 32}
# The near-tie rule that holds the drive to the world-1 generate oracle,
# which on the card runs other shapes than the engine (ROADMAP C7): a
# request may differ from it only where the oracle met a near tie, a gap
# within NEAR_TIE of the largest |value| compared: at its first router top-2
# flip, the gap between the oracle's 2nd and 3rd router logits of that
# token; with no flip, the top-2 score gap of the diverging output itself.
NEAR_TIE = 1e-4

def serve_args(widths, traffic, *, stack, device, slots):
    from uccl_tpu_torch import serve

    argv = ["--server", "--device", device, "--stack", stack, "--seed", "0",
            "--slots", str(slots), "--prompt-len", str(traffic["prompt_len"]),
            "--new-tokens", str(traffic["new_tokens"]), "--max-seq", str(traffic["max_seq"])]
    if stack == "moe":
        argv += ["--dp", str(traffic["world"])]
    for k in ("vocab", "dim", "layers", "heads", "kv_heads", "ffn", "experts"):
        argv += [f"--{k.replace('_', '-')}", str(widths[k])]
    return serve.parser().parse_args(argv)

def serve_workload(traffic, vocab, requests, *, poisson=True, seed=0):
    """synth_workload's recipe with the prompt lengths drawn from
    ``min_prompt_len`` up: uniform lengths, Poisson arrivals (all at once
    when not ``poisson``), every second request sampled under its own
    seed."""
    from uccl_tpu_torch.serving import SamplingParams

    rng = np.random.default_rng(seed)
    lens = rng.integers(traffic["min_prompt_len"], traffic["prompt_len"] + 1, requests)
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    arrivals = (np.cumsum(rng.exponential(1.0 / traffic["arrival_rate"], requests)) if poisson
                else np.zeros(requests))
    samplings = [SamplingParams(temperature=0.8, top_p=0.95, top_k=50, seed=seed + i)
                 if i % 2 else None for i in range(requests)]
    return prompts, lens, arrivals, samplings

def serve_drive(backend, workload, traffic, hook=None, check=True):
    """What serve --server runs after building its stack: the engine warmed
    on every prefill bucket, ``hook(engine)`` just before the measured
    drive, the arrival stream driven to the end, and with ``check``
    serve.oracle_check (every request against its run alone on the
    engine's slot programs). Returns (summary, requests)."""
    from uccl_tpu_torch import serve
    from uccl_tpu_torch.serving import ServingEngine
    from uccl_tpu_torch.serving.loadgen import drive, warm_engine

    prompts, lens, arrivals, samplings = workload
    engine = ServingEngine(backend, register_stats=True)
    warm_engine(engine, lens, traffic["max_seq"], traffic["new_tokens"])
    if hook is not None:
        hook(engine)
    reqs, wall = drive(engine, prompts, arrivals, traffic["new_tokens"], samplings=samplings)
    summary = {**engine.snapshot(), "wall_s": wall}
    if check:
        t0 = time.perf_counter()
        summary.update(serve.oracle_check(engine, reqs), oracle_check_s=time.perf_counter() - t0)
    engine.close()
    return summary, reqs

def serve_readings(summary, reqs) -> dict:
    """The end-to-end serving numbers of one drive: TTFT / TPOT p50/p95/p99,
    output tokens per second of wall time, slot occupancy (mean active
    slots per decode step over the pool), prefill and decode call ms."""
    from uccl_tpu_torch.serving.metrics import percentiles_ms

    qs = (50, 95, 99)
    return {
        "ttft_ms": percentiles_ms([r.ttft for r in reqs], qs),
        "tpot_ms": percentiles_ms([r.tpot for r in reqs if r.tpot is not None], qs),
        "output_tok_s": summary["output_tokens"] / summary["wall_s"],
        "goodput_tok_s": summary.get("goodput_tok_s"),
        "mean_slot_occupancy": summary["decode_tokens"] / max(1, summary["decode_calls"])
                               / summary["n_slots"],
        "prefill_ms": summary["prefill_ms"], "decode_step_ms": summary["decode_step_ms"],
        "prefill_calls": summary["prefill_calls"], "decode_calls": summary["decode_calls"],
        "wall_s": summary["wall_s"], "output_tokens": summary["output_tokens"],
    }

def b9_held_on(x, out) -> dict:
    """One B9 exchange of the serving path, held as ep_a2a_vs_plain holds
    its cases: ``out``, what the drive's all_to_all returned on ``x``, and
    a fresh launch on the same bytes, each bit for bit against a2a_plain
    and ``x.transpose(0, 1)`` (every slot, the idle rows' too)."""
    xb, _ = pa._as_bytes(x)
    view, k, _ = pa._view(xb)
    got = torch.empty_like(view)
    pa.launch_a2a(view, got, dma.CID_A2A).check("a2a")
    got, plain = pa._unview(got, k, xb), pa._unview(pa.a2a_plain(view), k, xb)
    fresh = ep_rule(got, plain, xb)
    drove = ep_rule(pa._as_bytes(out)[0], plain, xb)
    return {"shape": list(x.shape), "dtype": str(x.dtype).removeprefix("torch."),
            "drive_output_ok": drove["ok"], "fresh_launch_ok": fresh["ok"]}

def moe_block_trace(run):
    """Run ``run()`` with every MoE block's input rows and router logits
    recorded, in call order (one call a layer, a forward's layers in
    turn)."""
    calls, real = [], ep_ops.moe_ffn

    def recorded(x, router_logits, *a, **kw):
        calls.append((x.detach().clone(), router_logits.detach().float().clone()))
        return real(x, router_logits, *a, **kw)

    ep_ops.moe_ffn = recorded
    try:
        run()
    finally:
        ep_ops.moe_ffn = real
    return calls

def router_flip(backend, srv1, placed1, req, pos, layers) -> dict:
    """Where a request's run alone at EP world 4 (replay_alone: the engine's
    own programs) and the world-1 ``generate`` first part ways: layer by
    layer over the forward steps up to output ``pos`` (step 0 the prefill,
    step i the decode that emits output i), the first token whose router
    top-2 experts differ, each run's gap between its 2nd and 3rd router
    logit there, the difference of the block's input rows and router
    logits at that step and layer and the largest before it (relative to
    the world-1 values' largest)."""
    from uccl_tpu_torch.serving import replay_alone

    b_loc = backend.b_loc
    member, row, size = req.slot // b_loc, req.slot % b_loc, req.prompt.size
    w4 = moe_block_trace(lambda: replay_alone(backend, req))
    w1 = moe_block_trace(lambda: srv1.generate(placed1, req.prompt[None, None], pos + 1,
                                               backend.max_seq, impl="ll",
                                               sampling=req.sampling))

    def rows(calls, k, world4):
        x, logits = calls[k]
        if k < layers:  # the prefill
            if world4:
                x = x.reshape(x.shape[0], b_loc, -1, x.shape[-1])[member, row, :size]
                logits = logits.reshape(logits.shape[0], b_loc, -1, logits.shape[-1])
                return x, logits[member, row, :size]
            return x[0, :size], logits[0, :size]
        return (x[member, row:row + 1], logits[member, row:row + 1]) if world4 else \
            (x[0], logits[0])

    def gap23(z):
        top = torch.sort(z.double(), descending=True).values
        return float(top[1] - top[2])

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    worst = {"x": 0.0, "router": 0.0}
    for k in range((pos + 1) * layers):
        (x4, z4), (x1, z1) = rows(w4, k, True), rows(w1, k, False)
        top4 = torch.sort(torch.sort(z4, dim=-1, descending=True, stable=True).indices[:, :2])[0]
        top1 = torch.sort(torch.sort(z1, dim=-1, descending=True, stable=True).indices[:, :2])[0]
        differ = (top4 != top1).any(-1).nonzero()
        if len(differ):
            t = int(differ[0])
            return {"step": k // layers, "layer": k % layers,
                    "token": t if k < layers else size + k // layers - 1,
                    "experts_world4": top4[t].tolist(), "experts_world1": top1[t].tolist(),
                    "gap_2nd_3rd_world4": gap23(z4[t]), "gap_2nd_3rd_world1": gap23(z1[t]),
                    "router_logit_max_world1": float(z1[t].abs().max()),
                    "rel_diff_at_flip": {"x": rel(x4, x1), "router": rel(z4, z1)},
                    "max_rel_diff_before": worst}
        worst["x"] = max(worst["x"], rel(x4, x1))
        worst["router"] = max(worst["router"], rel(z4, z1))
    return {"step": None, "max_rel_diff_before": worst}

def world1_comparison(backend, reqs, layers) -> dict:
    """Each request of the drive against the JAX package's oracle, the
    one-shot ``generate`` of a world-1 server on the same weights, held to
    the NEAR_TIE rule: for each request that differs, the first diverging
    output, the oracle's margin there (sample_margins: the top-2 score
    gap), where the router first chose other experts (router_flip), and
    whether a near tie explains it."""
    from uccl_tpu_torch.models.moe_inference import MoEServer, init_params
    from uccl_tpu_torch.models.sampling import sample_margins

    srv = backend.server
    srv1 = MoEServer(srv.cfg, make_mesh(MeshConfig(dp=1), srv.device, 1))
    placed1 = srv1.shard_params(init_params(prng_key(0), srv.cfg,
                                            srv.device))  # serve's weights: --seed 0
    diverged = []
    for r in reqs:
        want = srv1.generate(placed1, r.prompt[None, None], r.n_generated, backend.max_seq,
                             impl="ll", sampling=r.sampling)[0, 0].tolist()
        if want == r.out_tokens:
            continue
        pos = next(i for i, (a, b) in enumerate(zip(r.out_tokens, want)) if a != b)
        seq = np.concatenate([r.prompt, np.asarray(want[:pos], np.int32)])
        logits, _ = srv1.prefill(placed1, seq[None, None], backend.max_seq)
        sp = r.sampling
        margin = sample_margins(sp.seed if sp else 0, pos, logits[0, 0],
                                sp.temperature if sp else 0.0, sp.top_p if sp else 1.0,
                                sp.top_k if sp else 0)
        flip = router_flip(backend, srv1, placed1, r, pos, layers)
        if flip["step"] is not None:
            explained = flip["gap_2nd_3rd_world1"] <= NEAR_TIE * flip["router_logit_max_world1"]
        else:
            scale = float(logits[0, 0].abs().max()) / (sp.temperature if sp else 1.0)
            explained = margin["score_gap"] <= NEAR_TIE * scale
        diverged.append({"rid": r.rid, "pos": pos, "sampled": sp is not None, **margin,
                         "router": flip, "near_tie": bool(explained)})
    return {"requests": len(reqs), "differing": len(diverged), "near_tie_rule": NEAR_TIE,
            "diverged": diverged}

def serve_path(device=DEV, widths=SERVE_WIDTHS, traffic=SERVE_TRAFFIC,
               dense_requests=SERVE_DENSE_REQUESTS) -> dict:
    """The serve entry end to end (build_stack, the engine, its warmup, the
    arrival stream and oracle_check: what ``python -m uccl_tpu_torch.serve
    --server --check-oracle`` runs) on the MoE stack at EP world 4 on the
    pallas wire, in float32 as the JAX package serves. Raises unless every
    finished request equals its run alone on the engine's slot programs
    token for token, no slot leaked, the conservation check holds, B9
    launched in prefill and in decode and no wire fell back; one prefill
    and one decode B9 exchange of the drive, and a fresh launch on each,
    must equal a2a_plain and the transpose bit for bit. The same requests
    queued at once on the lax wire and on the pallas wire at chunk depth 1
    (drives that differ in the wire alone) must give the same tokens. A
    request may differ from the world-1 generate oracle only at a near tie
    (NEAR_TIE, world1_comparison). One more drive under torch.profiler gives the
    device's idle share. Then the dense stack at world 1, each request
    against its replay. Returns the B9 launches of the pallas drive, by
    phase."""
    from uccl_tpu_torch import serve

    is_cuda = torch.device(device).type == "cuda"
    dev = "cuda" if is_cuda else "cpu"
    args = serve_args(widths, traffic, stack="moe", device=dev, slots=traffic["slots"])
    backend, _, vocab = serve.build_stack(args, dev, moe_wire="pallas")
    workload = serve_workload(traffic, vocab, traffic["requests"])
    launches = {"prefill": 0, "decode": 0}
    calls = {"prefill": 0, "decode": 0}
    phase, captured = [None], {}

    def count_b9(engine):
        pa.reset_launch_counts()
        if is_cuda:
            torch.cuda.reset_peak_memory_stats(device)
        be = engine.backend
        for name in launches:
            fn = getattr(be, name)

            def counted(*a, _fn=fn, _name=name, **kw):
                calls[_name] += 1
                phase[0], a0 = _name, pa.launch_counts["a2a"]
                try:
                    return _fn(*a, **kw)
                finally:
                    launches[_name] += pa.launch_counts["a2a"] - a0
                    phase[0] = None

            setattr(be, name, counted)

    real_a2a = pa.all_to_all

    def capturing(x, **kw):
        out = real_a2a(x, **kw)
        name = phase[0]
        if name is not None and calls[name] <= B9_CAPTURE_CALL[name] and \
                captured.get(name, (0,))[0] < calls[name]:
            captured[name] = (calls[name], x.clone(), out.clone())
        return out

    fb0 = dma.WIRE_FALLBACK.total()
    pa.all_to_all = capturing
    try:
        summary, reqs = serve_drive(backend, workload, traffic, count_b9)
    finally:
        pa.all_to_all = real_a2a
    peak_gib = torch.cuda.max_memory_allocated(device) / 2 ** 30 if is_cuda else None
    if not (summary["oracle_match"] and summary["leaked_slots"] == 0 and summary["conservation"]):
        fail(f"serve_path: oracle_match={summary['oracle_match']} "
             f"leaked={summary['leaked_slots']} conservation={summary['conservation']} "
             f"mismatches={summary['mismatches']}")
    if not (launches["prefill"] and launches["decode"]):
        fail(f"serve_path: B9 launches {launches}; the pallas wire must run in prefill and decode")
    fallbacks = dma.WIRE_FALLBACK.total() - fb0
    if fallbacks:
        fail(f"serve_path: the EP wire fell back {fallbacks} times")
    if len(reqs) != traffic["requests"] or any(len(r.out_tokens) != traffic["new_tokens"]
                                                 for r in reqs):
        fail("serve_path: not every request finished with its token budget")
    b9_held = {}
    for name in launches:
        if name not in captured:
            fail(f"serve_path: no B9 input was captured in {name}")
        b9_held[name] = {"call": captured[name][0], **b9_held_on(*captured[name][1:])}
        if not (b9_held[name]["drive_output_ok"] and b9_held[name]["fresh_launch_ok"]):
            fail(f"serve_path: B9 on the {name} exchange differs from a2a_plain or the "
                 f"transpose: {b9_held[name]}")
    captured.clear()
    world1 = world1_comparison(backend, reqs, widths["layers"])
    unexplained = [d for d in world1["diverged"] if not d["near_tie"]]
    if unexplained:
        fail(f"serve_path: requests differ from the world-1 generate oracle with no near tie "
             f"(NEAR_TIE {NEAR_TIE}): {unexplained}")
    del backend
    # the wire alone: the same requests queued at once (so both drives batch
    # them alike) on the lax wire and on the pallas wire at chunk depth 1
    at_once = serve_workload(traffic, vocab, traffic["requests"], poisson=False)
    wires = {}
    for wire, chunks in (("pallas", 1), ("lax", 0)):
        be, _, _ = serve.build_stack(args, dev, moe_wire=wire, moe_chunks=chunks)
        wires[wire] = serve_drive(be, at_once, traffic, check=False)
        del be
    lax_diff = [r.rid for r, q in zip(wires["pallas"][1], wires["lax"][1])
                if r.out_tokens != q.out_tokens]
    if len(wires["lax"][1]) != len(reqs) or lax_diff:
        fail(f"serve_path: the lax wire's tokens differ from the pallas wire's on requests "
             f"{lax_diff}")
    busy = {}

    def start_profile(engine):
        busy["prof"] = profile(activities=[ProfilerActivity.CUDA] if is_cuda
                               else [ProfilerActivity.CPU])
        busy["prof"].__enter__()

    be, _, _ = serve.build_stack(args, dev, moe_wire="pallas")
    prof_summary, _ = serve_drive(be, workload, traffic, start_profile, check=False)
    del be
    if is_cuda:
        torch.cuda.synchronize(device)
    busy["prof"].__exit__(None, None, None)
    spans = [(ev.time_range.start, ev.time_range.end) for ev in busy["prof"].events()
             if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = profile_ep.union_ms(spans)
    dense_args = serve_args(widths, traffic, stack="dense", device=dev, slots=dense_requests)
    dense_be, _, _ = serve.build_stack(dense_args, dev)
    dense_summary, dense_reqs = serve_drive(dense_be, serve_workload(traffic, vocab,
                                                                     dense_requests),
                                            traffic)
    del dense_be
    if not (dense_summary["oracle_match"] and dense_summary["leaked_slots"] == 0
            and dense_summary["conservation"]):
        fail(f"serve_path dense: oracle_match={dense_summary['oracle_match']} "
             f"leaked={dense_summary['leaked_slots']} mismatches={dense_summary['mismatches']}")
    emit("serve_path", widths=widths, traffic=traffic, capacity_factor=8.0, wire="pallas",
         dtype="float32", decode_impl="ll", b9_launches=launches, fallbacks=fallbacks,
         b9_held_on_the_drive=b9_held,
         oracle="each request run alone on the engine's slot programs (replay_alone), "
                "token for token", requests_exact=len(reqs),
         sampled_requests=sum(r.sampling is not None for r in reqs),
         oracle_check_s=summary["oracle_check_s"],
         pallas=serve_readings(summary, reqs),
         wire_alone={"lax_same_tokens_as_pallas_depth_1": True,
                     **{w: serve_readings(*wires[w]) for w in wires}},
         world1_generate=world1,
         profiled_drive={"wall_s": prof_summary["wall_s"], "device_busy_ms": busy_ms,
                         "idle_share": 1.0 - busy_ms / (prof_summary["wall_s"] * 1e3),
                         "device_events": len(spans)},
         peak_mem_gib=peak_gib,
         dense={"requests_exact": len(dense_reqs), **serve_readings(dense_summary, dense_reqs)},
         card=nvidia_smi_line() if is_cuda else None)
    return launches

# The serving slice's local features (chunked prefill and preemption,
# speculative decoding, the prefix cache and its host tier, health and the
# router) on the MoE stack at SERVE_WIDTHS, float32, EP world 4 on the one
# card on the pallas wire, 16 slots, max_seq 1024. Drive A: one engine with
# prefill chunk 128, a 1024-token step budget, a prefix cache of chunk 128
# behind a lossless host tier of about four 512-token entries, spec_k 2 with
# the n-gram drafter, SLO classes with preemption; 32 Poisson requests at
# 8 req/s of 64 new tokens, 25% interactive (batch first), half of them on a
# shared 512-token system prompt (synth_shared_workload) and half repetitive
# (synth_repeat_workload), each half half greedy and half sampled. Drive B:
# a Router over 2 replicas of one server, prefill chunk 128, 16 greedy
# requests, one replica killed after its 4th step.
SERVE_FEATURES = dict(requests=32, prompt_len=896, shared_len=512, hit_rate=0.75, new_tokens=64,
                      max_seq=1024, arrival_rate=8.0, slots=16, world=4, interactive_frac=0.25,
                      prefill_chunk=128, step_tokens=1024, spec_k=2, host_entries=4,
                      router_requests=16, router_min_prompt_len=128, kill_after_steps=4)
FEATURE_KINDS = ("chunk_prefill", "decode", "verify")

def features_workload(traffic, vocab, seed=0):
    """Drive A's requests: Poisson arrivals first, then the shared-prompt
    and repetitive prompts interleaved, the batch-first class pattern, and
    within each workload every second request sampled under its own seed."""
    from uccl_tpu_torch.serving import SamplingParams
    from uccl_tpu_torch.serving.loadgen import (
        assign_classes, synth_repeat_workload, synth_shared_workload,
    )

    n = traffic["requests"]
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / traffic["arrival_rate"], n))
    shared, _, _ = synth_shared_workload(rng, n // 2, traffic["prompt_len"], vocab, 0.0,
                                         traffic["hit_rate"], traffic["shared_len"])
    repeat, _, _ = synth_repeat_workload(rng, n - n // 2, traffic["prompt_len"], vocab, 0.0)
    prompts = [p for pair in zip(shared, repeat) for p in pair]
    classes = assign_classes(rng, n, traffic["interactive_frac"], pattern="batch-first")
    samplings = [SamplingParams(temperature=0.8, top_p=0.95, top_k=50, seed=seed + i)
                 if (i // 2) % 2 else None for i in range(n)]
    return prompts, np.asarray([p.size for p in prompts]), arrivals, classes, samplings

def feature_counters() -> dict:
    """The serving counters drive A must move, read off the obs registry."""
    c = obs.counter
    return {"prefix_cache_hits": c("prefix_cache_hits_total").total(),
            "prefill_tokens_skipped": c("serving_prefill_tokens_total").get(kind="skipped"),
            "prefill_tokens_computed": c("serving_prefill_tokens_total").get(kind="computed"),
            "tier_demotions": c("kv_tier_demotions_total").get(tier="t1"),
            "tier_promotions": c("kv_tier_promotions_total").get(tier="t1"),
            "tier_drops": c("kv_tier_drops_total").get(tier="t1"),
            "preempted": c("serving_preempted_total").total(),
            "resumed": c("serving_resumed_total").total(),
            "spec_accepted": c("spec_tokens_total").get(outcome="accepted"),
            "spec_rejected": c("spec_tokens_total").get(outcome="rejected")}

class CallMeter:
    """Wraps a backend's prefill / decode / verify: B9 launches and host ms
    per call kind (a prefill with a ``start`` is a chunk), and the first B9
    input and output of a chosen call of each kind, kept for the bit checks
    and the timing at the serving shapes."""

    def __init__(self, capture_call=3):
        self.launches = {k: 0 for k in FEATURE_KINDS}
        self.calls = {k: 0 for k in FEATURE_KINDS}
        self.seconds = {k: [] for k in FEATURE_KINDS}
        self.captured = {}
        self.capture_call = capture_call
        self.kind = None

    def wrap(self, backend):
        for name in ("prefill", "decode", "verify"):
            fn = getattr(backend, name)

            def counted(*a, _fn=fn, _name=name, **kw):
                kind = "chunk_prefill" if _name == "prefill" else _name
                self.calls[kind] += 1
                self.kind, a0, t0 = kind, pa.launch_counts["a2a"], time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    self.seconds[kind].append(time.perf_counter() - t0)
                    self.launches[kind] += pa.launch_counts["a2a"] - a0
                    self.kind = None

            setattr(backend, name, counted)

    def capture(self, real):
        def capturing(x, **kw):
            out = real(x, **kw)
            kind, call = self.kind, self.calls.get(self.kind)
            # each call up to the chosen one keeps its first exchange: the
            # chosen call's when the drive reaches it, else the last call's
            if kind is not None and x.dtype == torch.float32 and call <= self.capture_call \
                    and self.captured.get(kind, (0,))[0] < call:
                self.captured[kind] = (call, x.clone(), out.clone())
            return out
        return capturing

def output_gap(backend, req, pos) -> dict:
    """The top-2 logit gap of output ``pos`` of ``req``'s own sequence (the
    server's one-shot prefill over prompt + the tokens before it), against
    NEAR_TIE times the largest |logit|."""
    seq = np.concatenate([req.prompt, np.asarray(req.out_tokens[:pos], np.int32)])
    srv = backend.server
    logits, _ = srv.prefill(backend.params, np.tile(seq, (srv.world, 1, 1)), backend.max_seq)
    z = logits[0, 0].double()
    top = torch.topk(z, 2).values
    gap = float(top[0] - top[1])
    return {"gap": gap, "near_tie": gap <= NEAR_TIE * float(z.abs().max())}

def features_engine(backend, traffic, host_bytes):
    from uccl_tpu_torch.serving import PrefixCache, ServingEngine, TieredKVCache

    return ServingEngine(backend, register_stats=True, prefill_chunk=traffic["prefill_chunk"],
                         step_tokens=traffic["step_tokens"],
                         prefix_cache=PrefixCache(traffic["prefill_chunk"]),
                         kv_tiers=TieredKVCache(host_bytes), spec_k=traffic["spec_k"],
                         priority_classes=True, preempt=True)

def features_drive_a(backend, traffic, workload, meter=None, hook=None):
    """Drive A once: the engine warmed (loadgen.warm_engine: the chunk
    program, the hit path and the verify window), then the arrival stream
    driven to the end. Returns (engine, requests, wall seconds, counter
    deltas)."""
    from uccl_tpu_torch.serving.loadgen import drive, warm_engine

    prompts, lens, arrivals, classes, samplings = workload
    cfg = backend.server.cfg
    entry = 2 * cfg.n_layers * traffic["shared_len"] * cfg.n_kv_heads * cfg.head_dim * 4
    engine = features_engine(backend, traffic, traffic["host_entries"] * entry + 1)
    warm_engine(engine, lens, traffic["max_seq"], traffic["new_tokens"])
    if meter is not None:
        meter.wrap(engine.backend)
    if hook is not None:
        hook()
    c0 = feature_counters()
    reqs, wall = drive(engine, prompts, arrivals, traffic["new_tokens"], priorities=classes,
                       samplings=samplings)
    c1 = feature_counters()
    return engine, reqs, wall, {k: c1[k] - c0[k] for k in c0}

def features_drive_b(args, dev, traffic, vocab, meter):
    """Drive B: a Router over 2 replicas of one server (replicate_backend),
    prefill chunk 128, 16 greedy requests queued at once; replica 1 is
    killed after its 4th step and the FailureDetector's DEAD fire moves its
    requests to replica 0. Returns (router, submitted, finished, replica 1's
    steps before the kill, routed counts at the kill)."""
    from uccl_tpu_torch import serve
    from uccl_tpu_torch.serving import Router, ServingEngine, replicate_backend

    proto, _, _ = serve.build_stack(args, dev, moe_wire="pallas")
    engines = [ServingEngine(b, prefill_chunk=traffic["prefill_chunk"])
               for b in replicate_backend(proto, 2)]
    for e in engines:
        meter.wrap(e.backend)
    router = Router(engines)
    router.enable_health(suspect_after_s=0.05, dead_after_s=0.1)
    rng = np.random.default_rng(1)
    n = traffic["router_requests"]
    lens = rng.integers(traffic["router_min_prompt_len"], traffic["prompt_len"] + 1, n)
    submitted = [router.submit(rng.integers(0, vocab, int(m)).astype(np.int32),
                               max_new_tokens=traffic["new_tokens"]) for m in lens]
    steps, real_step, at_kill = [0], engines[1].step, {}

    def step():
        out = real_step()
        steps[0] += 1
        if steps[0] == traffic["kill_after_steps"]:
            at_kill["routed"] = list(router.routed)
            engines[1].kill()
        return out

    engines[1].step = step
    finished = []
    t_end = time.perf_counter() + 600
    while router.has_work():
        finished += router.step()
        if time.perf_counter() > t_end:
            fail("serve_features_path: drive B did not drain in 600 s")
    return router, submitted, finished, steps[0], at_kill.get("routed")

def serve_features_path(device=DEV, widths=SERVE_WIDTHS, traffic=SERVE_FEATURES) -> dict:
    """Drive A and drive B (see SERVE_FEATURES) through the serve entry's
    stack (serve.build_stack on the pallas wire) and the serving modules a
    user calls. Raises unless: every finished request of both drives equals
    its replay_alone token for token (its chunk boundaries, its verify
    windows, on the replica that ran it) and finishes exactly once,
    conservation holds and no slot leaks; the wire never fell back; B9 is
    bit-identical to a2a_plain and the transpose on a chunk-prefill and a
    verify exchange of drive A; B9 launched in chunk prefills, decodes and
    verifies; prefix hits, skipped prefill tokens, tier demotions and
    promotions, preemptions (equal to resumes) and accepted drafts are all
    above zero; both replicas of drive B served requests. Greedy requests of
    drive A are also replayed without speculation (other shapes: the
    [n_slots, 3] verify window against [n_slots, 1] decodes on the LL path)
    and the ones that differ are reported with their output's top-2 gap.
    Then drive A runs once more under torch.profiler for the device's idle
    share (B9's time at these exchanges' shapes is ep_a2a_timing's).
    Returns the B9 launches by call kind."""
    from uccl_tpu_torch import serve
    from uccl_tpu_torch.serving import replay_alone

    is_cuda = torch.device(device).type == "cuda"
    dev = "cuda" if is_cuda else "cpu"
    args = serve_args(widths, traffic, stack="moe", device=dev, slots=traffic["slots"])
    backend, _, vocab = serve.build_stack(args, dev, moe_wire="pallas")
    workload = features_workload(traffic, vocab)
    meter = CallMeter()
    real_a2a = pa.all_to_all
    fb0 = dma.WIRE_FALLBACK.total()
    pa.all_to_all = meter.capture(real_a2a)
    try:
        engine, reqs, wall, moved = features_drive_a(backend, traffic, workload, meter,
                                                     pa.reset_launch_counts)
        snap = engine.snapshot()
        t0 = time.perf_counter()
        check = serve.oracle_check(engine, reqs)
        oracle_s = time.perf_counter() - t0
        launches_a = dict(meter.launches)
        router, submitted, finished, b_steps, routed_at_kill = features_drive_b(
            args, dev, traffic, vocab, meter)
    finally:
        pa.all_to_all = real_a2a
    fallbacks = dma.WIRE_FALLBACK.total() - fb0
    if not (check["oracle_match"] and check["leaked_slots"] == 0 and check["conservation"]):
        fail(f"serve_features_path drive A: oracle_match={check['oracle_match']} "
             f"leaked={check['leaked_slots']} conservation={check['conservation']} "
             f"mismatches={check['mismatches']}")
    if len(reqs) != traffic["requests"] or len({r.trace_id for r in reqs}) != len(reqs) or \
            any(r.state.value != "finished" or r.n_generated != traffic["new_tokens"]
                for r in reqs):
        fail("serve_features_path drive A: not every request finished once with its budget")
    for key in ("prefix_cache_hits", "prefill_tokens_skipped", "tier_demotions",
                "tier_promotions", "preempted", "spec_accepted"):
        if moved[key] <= 0:
            fail(f"serve_features_path drive A: {key} did not move: {moved}")
    if moved["preempted"] != moved["resumed"]:
        fail(f"serve_features_path drive A: preemptions {moved['preempted']} != resumes "
             f"{moved['resumed']}")
    if fallbacks:
        fail(f"serve_features_path: the EP wire fell back {fallbacks} times")
    b9_held = {}
    for kind in ("chunk_prefill", "verify"):
        if kind not in meter.captured:
            fail(f"serve_features_path: no B9 input was captured in {kind}")
        b9_held[kind] = {"call": meter.captured[kind][0],
                         **b9_held_on(*meter.captured[kind][1:])}
        if not (b9_held[kind]["drive_output_ok"] and b9_held[kind]["fresh_launch_ok"]):
            fail(f"serve_features_path: B9 on the {kind} exchange differs from a2a_plain or "
                 f"the transpose: {b9_held[kind]}")
    if not all(meter.launches.values()):
        fail(f"serve_features_path: B9 launches by call kind {meter.launches}")
    # drive B: each trace finished exactly once, on the replica that ran it
    traces = [r.trace_id for r in submitted]
    done = [r.trace_id for r in finished]
    bsnap = router.snapshot()
    by_pid = dict(zip(router._pids, router.engines))
    b_mismatch = [r.rid for r in finished
                  if replay_alone(by_pid[r.replica].backend, r).tolist() != r.out_tokens]
    if sorted(done) != sorted(traces) or len(set(done)) != len(done) or b_mismatch or \
            router.leaked() or not router.recoveries or bsnap["dead_replicas"] != 1 or \
            bsnap["submitted"] != (bsnap["completed"] + bsnap["active"] + bsnap["queued"]
                                   + bsnap["rejected"] + bsnap["expired"] + bsnap["lost"]):
        fail(f"serve_features_path drive B: finished {len(done)}/{len(traces)} once="
             f"{len(set(done)) == len(done)} replay mismatches {b_mismatch} leaked "
             f"{router.leaked()} recoveries {len(router.recoveries)} snapshot "
             f"{ {k: bsnap[k] for k in ('submitted', 'completed', 'lost', 'dead_replicas')} }")
    if not routed_at_kill or min(routed_at_kill) == 0 or b_steps < traffic["kill_after_steps"]:
        fail(f"serve_features_path drive B: both replicas must serve: routed {routed_at_kill}, "
             f"replica 1 stepped {b_steps} times")
    # greedy speculating requests against their vanilla replay (other shapes)
    vanilla = []
    for r in reqs:
        if r.sampling is not None:
            continue
        want = replay_alone(backend, dataclasses.replace(r, spec_k=None)).tolist()
        if want != r.out_tokens:
            pos = next(i for i, (a, b) in enumerate(zip(r.out_tokens, want)) if a != b)
            vanilla.append({"rid": r.rid, "pos": pos, **output_gap(backend, r, pos)})
    meter.captured.clear()
    n_recoveries = len(router.recoveries)
    del router, finished, submitted
    busy = {}

    def start_profile():
        busy["prof"] = profile(activities=[ProfilerActivity.CUDA] if is_cuda
                               else [ProfilerActivity.CPU])
        busy["prof"].__enter__()

    be, _, _ = serve.build_stack(args, dev, moe_wire="pallas")
    _, _, prof_wall, _ = features_drive_a(be, traffic, workload, hook=start_profile)
    if is_cuda:
        torch.cuda.synchronize(device)
    busy["prof"].__exit__(None, None, None)
    spans = [(ev.time_range.start, ev.time_range.end) for ev in busy["prof"].events()
             if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = profile_ep.union_ms(spans)
    del be
    from uccl_tpu_torch.serving.metrics import percentiles_ms

    p50 = {k: percentiles_ms(v)["p50"] if v else None for k, v in meter.seconds.items()}
    emit("serve_features_path", widths=widths, traffic=traffic, wire="pallas", dtype="float32",
         card=nvidia_smi_line() if is_cuda else None,
         prompt_lens={"min": int(workload[1].min()), "max": int(workload[1].max())},
         drive_a={"requests_exact": len(reqs), "oracle_check_s": oracle_s,
                  "sampled_requests": sum(r.sampling is not None for r in reqs),
                  "ttft_ms": percentiles_ms([r.ttft for r in reqs]),
                  "tpot_ms": percentiles_ms([r.tpot for r in reqs if r.tpot is not None]),
                  "output_tok_s": snap["output_tokens"] / wall, "wall_s": wall,
                  "acceptance_rate": snap.get("spec_acceptance_rate"),
                  "cache_hits": moved["prefix_cache_hits"],
                  "prefill_tokens_skipped": moved["prefill_tokens_skipped"],
                  "counters": moved, "b9_launches": launches_a,
                  "vanilla_replay_differs": vanilla},
         drive_b={"requests_exact": len(done), "routed_at_kill": routed_at_kill,
                  "replica_1_steps": b_steps, "recoveries": n_recoveries,
                  "lost_copies": bsnap["lost"], "completed": bsnap["completed"]},
         call_p50_ms=p50, b9_launches=meter.launches, b9_held_on_the_drive=b9_held,
         fallbacks=fallbacks,
         profiled_drive={"wall_s": prof_wall, "device_busy_ms": busy_ms,
                         "idle_share": 1.0 - busy_ms / (prof_wall * 1e3),
                         "device_events": len(spans)})
    return dict(meter.launches)

# ---------------------------------------------------------------------------
# 10. The p2p plane: weight push into a server, the remote KV tier, staging

# (a) The MoE model's global f32 params (init_params, seed 0, at
# SERVE_WIDTHS: 320,906,240 floats, the gradient bucket's count) published
# from the card with wire None and fp8 and pushed down a relay chain
# publisher -> relay -> leaf over loopback; then a server at EP world 4 on the
# pallas wire built on the leaf's snapshot serves P2P_TRAFFIC's 8 requests
# beside the same engine on the source params. (b) A features-style engine
# at KV_TIER_TRAFFIC whose one-entry host tier spills to a KvTierServer on a
# second endpoint; each request is submitted once the one before it has
# finished. (c) A 256 MiB CUDA tensor through send_device / recv_device at
# 8 MiB chunks.
P2P_TRAFFIC = dict(requests=8, prompt_len=256, min_prompt_len=64, new_tokens=16, max_seq=512,
                   arrival_rate=8.0, slots=16, world=4)
P2P_PATHS = 4  # channel paths per hop of the relay chain
KV_TIER_TRAFFIC = dict(slots=4, world=4, prefill_chunk=128, prefix_len=256, suffix_len=64,
                       donors=6, revisits=3, new_tokens=16, max_seq=512)
STAGE_BYTES = 256 << 20
STAGE_CHUNK = 8 << 20

def chan_pair(server_ep, client_ep, n_paths):
    """A p2p Channel between two endpoints: (server side, client side)."""
    from uccl_tpu_torch.p2p import Channel

    res = {}
    t = threading.Thread(target=lambda: res.setdefault("c", Channel.accept(server_ep)))
    t.start()
    client = Channel.connect(client_ep, "127.0.0.1", server_ep.port, n_paths=n_paths)
    t.join(timeout=60)
    if "c" not in res:
        fail("p2p: a channel handshake did not complete in 60 s")
    return res["c"], client

def same_bits(a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return torch.equal(a.contiguous().view(ints), b.contiguous().view(ints))

def push_chain(pub, version) -> tuple:
    """Serve ``version`` of "moe" from ``pub`` down publisher -> relay ->
    leaf (three endpoints, P2P_PATHS paths a hop): returns the relay's and
    the leaf's snapshots and the seconds from the first fetch to the last
    verified group."""
    from uccl_tpu_torch.p2p import Endpoint
    from uccl_tpu_torch.p2p import weight_push as wp

    eps = [Endpoint(n_engines=P2P_PATHS) for _ in range(3)]
    try:
        d0, up_relay = chan_pair(eps[0], eps[1], P2P_PATHS)
        d1, up_leaf = chan_pair(eps[1], eps[2], P2P_PATHS)
        snaps, errs = {}, []

        def node(name, up, downs):
            try:
                snaps[name] = wp.fetch(up, "moe", version=version, forward_to=downs)
            except BaseException as e:  # re-raised below
                errs.append(e)

        ts = [threading.Thread(target=node, args=("relay", up_relay, [d1])),
              threading.Thread(target=node, args=("leaf", up_leaf, []))]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        pub.serve(d0)
        for t in ts:
            t.join(timeout=600)
        seconds = time.perf_counter() - t0
        if errs or any(t.is_alive() for t in ts):
            fail(f"p2p_path: the relay chain failed: {errs}")
        for c in (d0, up_relay, d1, up_leaf):
            c.close()
    finally:
        for ep in eps:
            ep.close()
    return snaps["relay"], snaps["leaf"], seconds

def stage_roundtrip(x, reps=3) -> dict:
    """send_device / recv_device of ``x`` at STAGE_CHUNK over loopback:
    bit-exact each time; the median GB/s of ``reps`` timed runs after one
    warm run."""
    from uccl_tpu_torch.p2p import Endpoint

    out = {"gbps": []}
    with Endpoint() as server, Endpoint() as client:
        conn_c = client.connect("127.0.0.1", server.port)
        conn_s = server.accept()
        for i in range(reps + 1):
            errs = []

            def send():
                try:
                    client.send_device(conn_c, x, chunk_bytes=STAGE_CHUNK)
                except BaseException as e:
                    errs.append(e)

            sync = torch.cuda.synchronize if x.device.type == "cuda" else (lambda: None)
            sync()
            t0 = time.perf_counter()
            t = threading.Thread(target=send)
            t.start()
            y = server.recv_device(conn_s, tuple(x.shape), x.dtype, device=x.device,
                                   timeout_ms=120000)
            t.join(timeout=120)
            sync()
            dt = time.perf_counter() - t0
            if errs or not same_bits(y, x):
                fail(f"p2p staging: the {x.nbytes} B tensor did not arrive bit-exact {errs}")
            if i:
                out["gbps"].append(x.nbytes / dt / 1e9)
        try:
            server.reg(x)
            refused = None
        except ValueError as e:
            refused = str(e)
    if x.device.type == "cuda" and not refused:
        fail("p2p staging: reg of a CUDA tensor did not raise")
    out["reg_refused"] = refused
    return out

def kv_tier_drive(backend, traffic) -> dict:
    """Drive (b): prefixes of ``prefix_len`` tokens, each request a prefix and
    ``suffix_len`` fresh tokens, submitted one after another once the one
    before has finished (no clock in it): ``donors`` distinct prefixes, then
    ``revisits`` requests on the oldest prefixes, whose donors by then were
    evicted from the slots, demoted to the one-entry host tier and spilled to
    the remote peer. Every request against replay_alone."""
    from uccl_tpu_torch import serve
    from uccl_tpu_torch.p2p import Endpoint
    from uccl_tpu_torch.serving import PrefixCache, ServingEngine
    from uccl_tpu_torch.serving.kv_tiers import KvTierServer, RemoteKVTier, TieredKVCache

    cfg = backend.server.cfg
    entry = 2 * cfg.n_layers * traffic["prefix_len"] * cfg.n_kv_heads * cfg.head_dim * 4
    rng = np.random.default_rng(3)
    vocab = cfg.vocab
    prefixes = [rng.integers(0, vocab, traffic["prefix_len"]).astype(np.int32)
                for _ in range(traffic["donors"])]
    order = list(range(traffic["donors"])) + list(range(traffic["revisits"]))
    fams = ("kv_tier_demotions_total", "kv_tier_promotions_total", "kv_tier_drops_total")

    def counts():
        return {f"{f.split('_')[2]}_{t}": obs.counter(f).get(tier=t) for f in fams
                for t in ("t1", "t2")} | {
            "p2p_kv_tier_bytes": obs.counter("p2p_bytes_total").get(verb="kv_tier")}

    server = KvTierServer(capacity_bytes=64 * entry)
    with Endpoint(n_engines=2) as peer, Endpoint(n_engines=2) as host:
        schan, cchan = chan_pair(peer, host, 2)
        serving = server.serve_forever(schan, timeout_ms=120000)
        remote = RemoteKVTier(cchan, max_entry_bytes=2 * entry, timeout_ms=120000)
        tiers = TieredKVCache(host_bytes=entry + 1, remote=remote)
        engine = ServingEngine(backend, prefill_chunk=traffic["prefill_chunk"],
                               prefix_cache=PrefixCache(traffic["prefill_chunk"]),
                               kv_tiers=tiers)
        c0 = counts()
        reqs, t0 = [], time.perf_counter()
        for i in order:
            prompt = np.concatenate([prefixes[i], rng.integers(0, vocab, traffic["suffix_len"])
                                     ]).astype(np.int32)
            reqs.append(engine.submit(prompt, max_new_tokens=traffic["new_tokens"]))
            engine.drain()
        wall = time.perf_counter() - t0
        moved = {k: v - c0[k] for k, v in counts().items()}
        check = serve.oracle_check(engine, reqs)
        hits = [r.cache_hit_len for r in reqs]
        engine.prefix_cache.clear(engine.pool)
        engine.close()
        remote.close()
        cchan.send(b"UKT1" + b'{"op": "stop"}')  # the serve loop exits on an op it cannot serve
        serving.join(timeout=120)
        if serving.is_alive():
            fail("p2p_path: the KV tier server did not stop")
    if not (check["oracle_match"] and check["leaked_slots"] == 0 and check["conservation"]):
        fail(f"p2p_path kv tier: oracle_match={check['oracle_match']} leaked="
             f"{check['leaked_slots']} conservation={check['conservation']} mismatches="
             f"{check['mismatches']}")
    if not (moved["demotions_t2"] > 0 and moved["promotions_t2"] > 0):
        fail(f"p2p_path kv tier: no T2 put or get: {moved}")
    return {"requests_exact": len(reqs), "wall_s": wall, "counters": moved,
            "cache_hit_len": hits, "entry_bytes": entry, "remote_entries_left": len(server)}

def p2p_path(device=DEV, widths=SERVE_WIDTHS, traffic=P2P_TRAFFIC,
             kv_traffic=KV_TIER_TRAFFIC) -> int:
    """The p2p plane's main path (see P2P_TRAFFIC above). Raises unless every
    peer's snapshot of each push is bit-equal to the published version, the
    publisher's counted egress is one snapshot per push, every request of the
    pushed server equals the source server's token for token with B9
    launched and no wire fallback, the KV-tier drive put and got through the
    remote peer with every request equal to its replay_alone, and the staged
    tensor arrived bit-exact with reg of a CUDA tensor refused. Returns B9's
    launches in the two serving drives."""
    from uccl_tpu_torch import serve
    from uccl_tpu_torch.models import moe_inference as tmoe
    from uccl_tpu_torch.p2p import WeightPublisher
    from uccl_tpu_torch.serving import replicate_backend
    from uccl_tpu_torch.serving.engine import MoEBackend

    t_start = time.perf_counter()
    is_cuda = torch.device(device).type == "cuda"
    dev = "cuda" if is_cuda else "cpu"
    args = serve_args(widths, traffic, stack="moe", device=dev, slots=traffic["slots"])
    backend, _, vocab = serve.build_stack(args, dev, moe_wire="pallas")
    params = tmoe.init_params(prng_key(0), backend.server.cfg, dev)
    n_floats = sum(v.numel() for _, v in tree_items(params))
    (source,) = replicate_backend(backend, 1, weights=params)

    # (a) the pushes
    pub = WeightPublisher()
    egress = obs.counter("weight_push_bytes_total")
    pushes, leaf_raw = {}, None
    for wire in (None, "fp8"):
        t0 = time.perf_counter()
        version = pub.publish("moe", params, wire=wire)
        publish_s = time.perf_counter() - t0
        snap = pub.get("moe", version)
        root0 = egress.get(role="tx", name="moe", src="publisher")
        relay, leaf, push_s = push_chain(pub, version)
        root = egress.get(role="tx", name="moe", src="publisher") - root0
        canon = snap.flat()
        for name, peer in (("relay", relay), ("leaf", leaf)):
            got = peer.flat()
            if peer.manifest != snap.manifest or set(got) != set(canon) or \
                    not all(same_bits(got[k], canon[k]) for k in canon):
                fail(f"p2p_path: the {name}'s tree differs from the published version "
                     f"(wire {wire})")
        if root != snap.total_bytes:
            fail(f"p2p_path: the publisher shipped {root} B for a {snap.total_bytes} B "
                 f"snapshot (wire {wire})")
        pushes[wire or "none"] = {"snapshot_bytes": snap.total_bytes, "publish_s": publish_s,
                                  "chain_s": push_s, "publisher_egress_bytes": root,
                                  "leaf_GBps": snap.total_bytes / push_s / 1e9,
                                  "groups": len(snap.manifest["groups"])}
        if wire is None:
            leaf_raw = leaf
        del relay, leaf, canon
    del pub
    (pushed,) = replicate_backend(backend, 1, weights=leaf_raw)
    del leaf_raw
    workload = serve_workload(traffic, vocab, traffic["requests"], poisson=False)
    fb0 = dma.WIRE_FALLBACK.total()
    pa.reset_launch_counts()
    out, seconds = {}, {}
    for name, be in (("source", source), ("pushed", pushed)):
        t0 = time.perf_counter()
        out[name] = serve_drive(be, workload, traffic, check=False)[1]
        seconds[name] = time.perf_counter() - t0
    b9 = pa.launch_counts["a2a"]
    differ = [r.rid for r, q in zip(out["pushed"], out["source"]) if r.out_tokens != q.out_tokens]
    if differ or len(out["pushed"]) != traffic["requests"]:
        fail(f"p2p_path: the pushed server's tokens differ from the source's on {differ}")
    if not b9 or dma.WIRE_FALLBACK.total() != fb0:
        fail(f"p2p_path: B9 launched {b9} times, {dma.WIRE_FALLBACK.total() - fb0} fallbacks")
    del source, pushed, out
    if is_cuda:
        torch.cuda.empty_cache()

    # (b) the remote KV tier, on a 4-slot backend over the same server
    kv_backend = MoEBackend(backend.server, backend.params, batch_local=kv_traffic["slots"]
                            // kv_traffic["world"], max_seq=kv_traffic["max_seq"],
                            decode_impl=backend.decode_impl)
    kv = kv_tier_drive(kv_backend, kv_traffic)
    del kv_backend, backend, params
    if is_cuda:
        torch.cuda.empty_cache()

    # (c) staging
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(STAGE_BYTES // 4, device=device, generator=g)
    staged = stage_roundtrip(x)
    del x
    gbps = statistics.median(staged["gbps"])
    card = nvidia_smi_line() if is_cuda else "cpu"
    print(f"p2p staging: {gbps:.3f} GB/s for a {STAGE_BYTES >> 20} MiB tensor at "
          f"{STAGE_CHUNK >> 20} MiB chunks (card -> pinned host -> loopback TCP -> pinned host "
          f"-> card: a loopback host number, not a network number) | {card}", flush=True)
    emit("p2p_path", widths=widths, traffic=traffic, kv_traffic=kv_traffic, wire="pallas",
         params_floats=n_floats, paths_per_hop=P2P_PATHS, push=pushes,
         serve={"requests_exact": len(workload[0]), "b9_launches": b9, "seconds": seconds},
         kv_tier=kv, staging={"bytes": STAGE_BYTES, "chunk_bytes": STAGE_CHUNK,
                              "GBps": staged["gbps"], "GBps_median": gbps,
                              "reg_refused": staged["reg_refused"],
                              "what": "loopback host number, not a network number"},
         card=card, seconds=time.perf_counter() - t_start)
    return b9

# ---------------------------------------------------------------------------
# 11. The multi-process planes (dist_path, disagg_path): the distributed
# session and its DcnGroup (threads as ranks over loopback, one store),
# hierarchical_all_reduce at the gradient bucket with its reduce-scatter leg
# on B5, compat.dist on CUDA tensors in two processes, DDP gradients, the
# engram fetch and cross-pod EP; then disaggregated serving on the MoE stack
# (B9 on both workers), the fleet prefix directory and the elastic KV cache.

DIST_PODS = 2
DIST_SUM_CHUNK = 1 << 24  # elements per float64 reference slice
COMPAT_ELEMS = 16 << 20  # f32 elements per rank through compat.dist (64 MiB)
ENGRAM = dict(entries=65536, hidden=1024, fetch=4096)
XPOD = dict(experts=8, dim=1024, ffn=2816, tokens=4096, topk=2, chunks=2)
XPOD_FWD_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_ep.py::TestCrossPod's
XPOD_GRAD_TOL = dict(rtol=2e-3, atol=2e-4)  # tests/test_ep.py::TestCrossPodTraining's
DISAGG_TRAFFIC = dict(requests=8, prompt_len=896, min_prompt_len=128, new_tokens=64,
                      max_seq=1024, arrival_rate=8.0, prefill_chunk=128, slots=8, world=4)
FLEET_TRAFFIC = dict(shared_len=512, suffix_len=64, new_tokens=16)
ELASTIC = dict(context=1000, steps=24, block_tokens=128, hot_budget_blocks=2)

def pods(n, body, tag):
    """``body(dcn, p)`` on ``n`` threads, one DcnGroup rank each over one
    store; raises on any rank's failure. Returns {p: result}."""
    import traceback

    from uccl_tpu_torch.collective.hierarchical import DcnGroup
    from uccl_tpu_torch.p2p.store import StoreClient, StoreServer
    from uccl_tpu_torch.parallel.distributed import Session

    server = StoreServer()
    out, errors = {}, []

    def rank_main(p):
        try:
            client = StoreClient("127.0.0.1", server.port)
            g = DcnGroup(Session(rank=p, world=n, store=client), n_paths=2, tag=tag)
            try:
                out[p] = body(g, p)
            finally:
                g.close()
                client.close()
        except BaseException:
            errors.append(traceback.format_exc())

    ts = [threading.Thread(target=rank_main, args=(p,)) for p in range(n)]
    [t.start() for t in ts]
    [t.join(timeout=600) for t in ts]
    server.close()
    if errors or len(out) != n:
        fail(f"{tag}: a rank failed:\n{errors[0] if errors else 'timed out'}")
    return out

def sum_rule(got, xs, what) -> dict:
    """``got`` [N] against the float64 sum of every row of ``xs`` (a list of
    [W, N]), within (R-1)·u·Σ|x| for R rows, in slices."""
    rows = sum(x.shape[0] for x in xs)
    worst, ratio = 0.0, 0.0
    for lo in range(0, got.numel(), DIST_SUM_CHUNK):
        hi = min(lo + DIST_SUM_CHUNK, got.numel())
        ref = sum(x[:, lo:hi].double().sum(0) for x in xs)
        mag = sum(x[:, lo:hi].double().abs().sum(0) for x in xs)
        err = (got[lo:hi].double() - ref).abs()
        bound = (rows - 1) * UNIT_ROUNDOFF[torch.float32] * mag
        if (err > bound).any():
            fail(f"{what}: outside (R-1)·u·Σ|x| of the float64 sum "
                 f"(max err {err.max().item()})")
        worst = max(worst, err.max().item())
        ratio = max(ratio, (err / bound.clamp_min(1e-300)).max().item())
        del ref, mag, err, bound
    return {"max_abs_err_vs_float64": worst, "max_err_over_rule": ratio}

def hier_run(xs, device, named_ring) -> tuple:
    """Two pods (threads), each a one-card Communicator at local world 4:
    ``hierarchical_all_reduce`` (the planner's choice), or with
    ``named_ring`` its three legs with the ring named (B5, the DCN ring,
    B4). Returns (the pods' results, seconds, B5 and B4 launches)."""
    from uccl_tpu_torch.collective.hierarchical import hierarchical_all_reduce
    from uccl_tpu_torch.p2p.endpoint import host_copy

    comms = [Communicator(make_mesh(MeshConfig(dp=WORLD), device), AXIS.DP)
             for _ in range(DIST_PODS)]

    def body(g, p):
        comm, x = comms[p], xs[p]
        if not named_ring:
            out = hierarchical_all_reduce(comm, g, x)
        else:
            shard = comm.reduce_scatter(x, algo="ring")
            reduced = g.all_reduce(host_copy(shard).numpy())
            gathered = comm.all_gather(comm.device_put(reduced), algo="ring")
            out = gathered.reshape(1, -1).expand(WORLD, x.shape[1]).contiguous()
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
        return out

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    rc.reset_launch_counts()
    t0 = time.perf_counter()
    out = pods(DIST_PODS, body, "hier_ring" if named_ring else "hier_auto")
    seconds = time.perf_counter() - t0
    return out, seconds, rc.launch_counts["ring_reduce_scatter"], rc.launch_counts[
        "ring_all_gather"]

COMPAT_RANK = r"""
import json, sys, time, torch
from uccl_tpu_torch.compat import dist
rank, world, port, elems = (int(a) for a in sys.argv[1:5])
dev = torch.device("cuda", 0)
dist.init_process_group(rank, world, master_port=port)
base = (torch.arange(elems, device=dev) % 1000).float() * 0.5  # sums are exact in f32
x = base + rank
ptr = x.data_ptr()
dist.barrier()
torch.cuda.synchronize()
t0 = time.perf_counter()
dist.all_reduce(x)
torch.cuda.synchronize()
ar_s = time.perf_counter() - t0
outs = [torch.empty(elems // 16, device=dev) for _ in range(world)]
dist.all_gather(outs, base[: elems // 16] * (rank + 1))
b = torch.full((1024,), float(rank), device=dev)
dist.broadcast(b, src=1)
a = torch.arange(world, dtype=torch.float32, device=dev) + 10 * rank
a_out = torch.empty(world, device=dev)
dist.all_to_all(a_out, a)
dist.barrier()
ok = {"in_place": x.data_ptr() == ptr and x.device.type == "cuda",
      "all_reduce": bool(torch.equal(x, world * base + sum(range(world)))),
      "all_gather": all(bool(torch.equal(o, base[: elems // 16] * (i + 1)))
                        for i, o in enumerate(outs)),
      "broadcast": bool((b == 1.0).all()),
      "all_to_all": a_out.tolist() == [rank + 10.0 * j for j in range(world)]}
dist.destroy_process_group()
print(json.dumps({"rank": rank, "ok": ok, "all_reduce_s": ar_s}))
"""

def compat_check(elems=COMPAT_ELEMS) -> dict:
    """compat.dist in two processes, one a rank, on CUDA tensors in place:
    each rank checks its own results (the sums are exact by construction)
    and reports them as JSON."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, "-c", COMPAT_RANK, str(r), str(DIST_PODS),
                               str(port), str(elems)], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(DIST_PODS)]
    res = {}
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=300)
            if p.returncode != 0:
                fail(f"dist_path compat: rank {r} exited {p.returncode}: {err[-2000:]}")
            res[r] = json.loads(out.strip().splitlines()[-1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = {r: v["ok"] for r, v in res.items() if not all(v["ok"].values())}
    if bad:
        fail(f"dist_path compat: {bad}")
    s = max(v["all_reduce_s"] for v in res.values())
    return {"elems_per_rank": elems, "bytes_per_rank": elems * 4, "all_reduce_s": s,
            "all_reduce_GBps": elems * 4 / s / 1e9, "in_place": True}

def ddp_check(bucket) -> dict:
    """allreduce_gradients on the flagship's gradients: rank r's grads are
    bucket row r (one member's gradient of the bench config), laid out as
    the model's parameters; the averages equal (g0 + g1) / 2 on the host,
    bit for bit."""
    from uccl_tpu_torch.interop import allreduce_gradients

    shapes = BUCKET_SHAPES or [(bucket.shape[1],)]
    ranks = []
    for r in range(DIST_PODS):
        params, off = [], 0
        for shape in shapes:
            n = math.prod(shape)
            p = torch.empty(shape, device=bucket.device)
            p.grad = bucket[r, off:off + n].view(shape).clone()
            params.append(p)
            off += n
        ranks.append(params)
    want = (bucket[0].cpu() + bucket[1].cpu()) / DIST_PODS
    if bucket.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    pods(DIST_PODS, lambda g, p: allreduce_gradients(ranks[p], g), "ddp")
    seconds = time.perf_counter() - t0
    for params in ranks:
        got = torch.cat([p.grad.reshape(-1) for p in params]).cpu()
        if not torch.equal(got, want):
            fail(f"dist_path ddp: averaged gradients differ "
                 f"(max abs {(got - want).abs().max().item()})")
        del got
    del ranks
    return {"leaves": len(shapes), "bytes_per_rank": bucket.shape[1] * 4, "seconds": seconds,
            "GBps": bucket.shape[1] * 4 / seconds / 1e9}

def engram_check(device, sizes=ENGRAM) -> dict:
    """EngramTable.fetch across two endpoints (half the rows remote), and
    mesh_fetch on the card, both against the global table."""
    from uccl_tpu_torch.ep.engram import EngramTable, mesh_fetch
    from uccl_tpu_torch.p2p import Endpoint

    rng = np.random.default_rng(7)
    e, h = sizes["entries"], sizes["hidden"]
    shards = [rng.standard_normal((e, h)).astype(np.float32) for _ in range(2)]
    table = np.concatenate(shards)
    idx = rng.integers(0, 2 * e, sizes["fetch"])
    with Endpoint() as a, Endpoint() as b:
        ta, tb = EngramTable(a, shards[0], 0, 2), EngramTable(b, shards[1], 1, 2)
        acc = {}
        t = threading.Thread(target=lambda: acc.setdefault("c", b.accept(10000)))
        t.start()
        conn = a.connect("127.0.0.1", b.port)
        t.join()
        t = threading.Thread(target=lambda: tb.link({0: acc["c"]}))
        t.start()
        ta.link({1: conn})
        t.join()
        ta.fetch(idx[:64])  # warm
        t0 = time.perf_counter()
        got = ta.fetch(idx)
        fetch_s = time.perf_counter() - t0
        if not np.array_equal(got, table[idx]) or not np.array_equal(tb.fetch(idx), table[idx]):
            fail("dist_path engram: fetched rows differ from the global table")
        ta.close()
        tb.close()
    dev_table = torch.from_numpy(table).to(device)
    dev_idx = torch.from_numpy(idx).to(device)
    mesh_fetch(dev_table, dev_idx)
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    rows = mesh_fetch(dev_table, dev_idx)
    sync()
    mesh_s = time.perf_counter() - t0
    if not np.array_equal(rows.cpu().numpy(), table[idx]):
        fail("dist_path engram: mesh_fetch differs from the global table")
    nbytes = idx.size * h * 4
    remote = int((idx >= e).sum()) * h * 4
    return {"rows": int(idx.size), "bytes": nbytes, "remote_bytes": remote, "fetch_s": fetch_s,
            "fetch_GBps": nbytes / fetch_s / 1e9, "mesh_fetch_s": mesh_s,
            "mesh_fetch_GBps": 2 * nbytes / mesh_s / 1e9}

def xpod_oracle_grads(x, ti, tv, wg, wu, wd, device) -> tuple:
    """The single-process oracle on ``device``: every pod's tokens through
    their top-k experts (grouped by expert), loss = Σ_p sum(out_p²), and
    torch.autograd's gradients for x, the top-k weights and the experts."""
    import torch.nn.functional as F

    xs = torch.tensor(x, device=device, requires_grad=True)
    tvs = torch.tensor(tv, device=device, requires_grad=True)
    ws = [torch.tensor(w, device=device, requires_grad=True) for w in (wg, wu, wd)]
    tis = torch.as_tensor(ti, device=device)
    loss, outs = 0.0, []
    for p in range(x.shape[0]):
        out = torch.zeros_like(xs[p])
        for j in range(ti.shape[-1]):
            for e in range(wg.shape[0]):
                rows = (tis[p, :, j] == e).nonzero().squeeze(1)
                if rows.numel() == 0:
                    continue
                hsel = xs[p].index_select(0, rows)
                y = (F.silu(hsel @ ws[0][e]) * (hsel @ ws[1][e])) @ ws[2][e]
                out = out.index_add(0, rows, tvs[p].index_select(0, rows)[:, j:j + 1] * y)
        outs.append(out)
        loss = loss + (out ** 2).sum()
    grads = torch.autograd.grad(loss, [xs, tvs] + ws)
    return [o.detach() for o in outs], [g.detach() for g in grads]

def xpod_check(device, sizes=XPOD) -> dict:
    """CrossPodMoE forward and backward across two pods (threads), the
    local experts SwiGLU through ep.ops on the card, n_chunks overlap and
    the scheduled DCN order; held to the oracle on the card within the JAX
    tests' tolerances: the output within TestCrossPod's, the gradients
    within TestCrossPodTraining's."""
    from uccl_tpu_torch.ep.cross_pod import CrossPodMoE

    rng = np.random.default_rng(11)
    e, h, f, t, k = (sizes[n] for n in ("experts", "dim", "ffn", "tokens", "topk"))
    epp = e // DIST_PODS
    w = [(rng.standard_normal(s) * 0.02).astype(np.float32)
         for s in ((e, h, f), (e, h, f), (e, f, h))]
    x = rng.standard_normal((DIST_PODS, t, h)).astype(np.float32)
    logits = torch.from_numpy(rng.standard_normal((DIST_PODS, t, e)).astype(np.float32))
    gates = torch.softmax(logits, dim=-1)
    tv_t, ti_t = torch.topk(gates, k, dim=-1)
    ti = ti_t.to(torch.int32).numpy()
    tv = (tv_t / tv_t.sum(-1, keepdim=True)).numpy()
    dev_w = [torch.from_numpy(a).to(device) for a in w]

    def expert_fn(buf, ww):
        return ep_ops._expert_gemms(buf, ww["wg"], ww["wu"], ww["wd"])

    def body(g, p):
        moe = CrossPodMoE(g, make_mesh(MeshConfig(dp=WORLD), device), num_global_experts=e,
                          num_selected=k, capacity_factor=1.0, n_chunks=sizes["chunks"],
                          a2a_sched="on")
        local = {n: a[p * epp:(p + 1) * epp] for n, a in zip(("wg", "wu", "wd"), dev_w)}
        t0 = time.perf_counter()
        out = moe.forward(x[p], ti[p], tv[p], {"fn": expert_fn, **local})
        fwd_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        dx, dw, dwarr = moe.backward(2.0 * out)
        bwd_s = time.perf_counter() - t0
        return out, dx, dw, dwarr, fwd_s, bwd_s

    res = pods(DIST_PODS, body, "xpod")
    outs, grads = xpod_oracle_grads(x, ti, tv, *w, device)
    worst = {"forward": 0.0, "gradients": 0.0}

    def held(name, got, want, part, tol):
        got = torch.as_tensor(got).to(want.device)
        if not torch.isfinite(got).all() or not torch.allclose(got, want, **tol):
            fail(f"dist_path cross-pod {name}: outside rtol {tol['rtol']} / atol "
                 f"{tol['atol']} of the oracle (max abs {(got - want).abs().max().item()})")
        worst[part] = max(worst[part], (got - want).abs().max().item())

    for p in range(DIST_PODS):
        out, dx, dw, dwarr, _, _ = res[p]
        held(f"pod {p} out", out, outs[p], "forward", XPOD_FWD_TOL)
        held(f"pod {p} d_x", dx, grads[0][p], "gradients", XPOD_GRAD_TOL)
        held(f"pod {p} d_topk_weights", dw, grads[1][p], "gradients", XPOD_GRAD_TOL)
        for i, n in enumerate(("wg", "wu", "wd")):
            held(f"pod {p} d_{n}", dwarr[n], grads[2 + i][p * epp:(p + 1) * epp],
                 "gradients", XPOD_GRAD_TOL)
    wire = DIST_PODS * t * (h + 2 * k) * 4  # one pod's dispatch wire, forward
    return {"pods": DIST_PODS, "tokens_per_pod": t, "topk": k, "experts": e, "dim": h,
            "ffn": f, "n_chunks": sizes["chunks"], "a2a_sched": "on",
            "forward_s": max(r[4] for r in res.values()),
            "backward_s": max(r[5] for r in res.values()),
            "dispatch_wire_bytes_per_pod": wire,
            "forward_max_abs_err_vs_oracle": worst["forward"], "forward_tolerance": XPOD_FWD_TOL,
            "grad_max_abs_err_vs_oracle": worst["gradients"], "grad_tolerance": XPOD_GRAD_TOL}

def dist_path(bucket, device=DEV, engram=ENGRAM, xpod=XPOD, compat_elems=COMPAT_ELEMS) -> dict:
    """The multi-process collective planes (the section comment above).
    ``bucket`` is the gradient bucket [W, BUCKET]; pod 1 holds it reversed
    along the payload. Returns the launches of B5 and B4 counted on the
    hierarchical legs."""
    t_start = time.perf_counter()
    is_cuda = torch.device(device).type == "cuda"
    card = nvidia_smi_line() if is_cuda else "cpu"
    xs = [bucket, torch.flip(bucket, dims=[1])]
    n = bucket.shape[1]
    rs_auto = plan.get_planner().plan_reduce_scatter((n,), bucket.dtype, WORLD, pallas_ok=True,
                                                     emit=False).algo
    hier = {}
    launches = {"ring_reduce_scatter": 0, "ring_all_gather": 0}
    for name, named in (("auto", False), ("ring", True)):
        out, seconds, b5, b4 = hier_run(xs, device, named)
        want = {"ring_reduce_scatter": DIST_PODS if (named or rs_auto == "ring") else 0,
                "ring_all_gather": DIST_PODS if named else 0}
        if (b5, b4) != (want["ring_reduce_scatter"], want["ring_all_gather"]):
            fail(f"dist_path hierarchical {name}: B5/B4 launched {b5}/{b4}, expected {want}")
        launches["ring_reduce_scatter"] += b5
        launches["ring_all_gather"] += b4
        ref = out[0][0]
        for p in range(DIST_PODS):
            if out[p].shape != bucket.shape or not all(torch.equal(out[p][i], ref)
                                                        for i in range(WORLD)):
                fail(f"dist_path hierarchical {name}: the members' results differ")
        hier[name] = {"seconds": seconds, "payload_bytes_per_pod": bucket.numel() * 4,
                      "GBps_per_pod": bucket.numel() * 4 / seconds / 1e9,
                      "dcn_bytes_per_pod": n * 4, "b5_launches": b5, "b4_launches": b4,
                      **sum_rule(ref, xs, f"dist_path hierarchical {name}")}
        if name == "auto":
            auto_ref = ref.clone()
        elif rs_auto == "ring" and not torch.equal(ref, auto_ref):
            # the same sums in the same order when the planner picked B5
            fail("dist_path hierarchical: the named ring differs from the planned run")
        del out, ref
        if is_cuda:
            torch.cuda.empty_cache()
    del xs, auto_ref
    planner = {"reduce_scatter_auto": rs_auto,
               "hier_predicted_us": plan.PLAN_PREDICTED.get(algo="hier", chunks=1,
                                                            wire_dtype="none")}
    compat = compat_check(compat_elems) if is_cuda else None
    ddp = ddp_check(bucket)
    eng = engram_check(device, engram)
    xp = xpod_check(device, xpod)
    emit("dist_path", pods=DIST_PODS, local_world=WORLD, bucket_elems_per_member=n,
         hierarchical=hier, planner=planner, compat=compat, ddp=ddp, engram=eng, cross_pod=xp,
         launches=launches, card=card, seconds=time.perf_counter() - t_start)
    return launches

def disagg_pair(backend, traffic):
    """A PrefillWorker and a DecodeWorker in one process over loopback, on
    two replicas of ``backend`` (the MoE server shared)."""
    from uccl_tpu_torch.serving import ServingEngine, replicate_backend
    from uccl_tpu_torch.serving.disagg import make_local_pair

    pb, db = replicate_backend(backend, 2)
    pe = ServingEngine(pb, prefill_chunk=traffic["prefill_chunk"])
    de = ServingEngine(db)
    return make_local_pair(pe, de)

def b9_counted(engine, tally, key):
    """Wrap ``engine.step`` to add its B9 launches to ``tally[key]``."""
    real = engine.step

    def step(*a, **kw):
        before = pa.launch_counts["a2a"]
        try:
            return real(*a, **kw)
        finally:
            tally[key] += pa.launch_counts["a2a"] - before

    engine.step = step

def replayed(backend, req, chunk):
    """An adopted request's tokens replayed alone on ``backend``: its prompt
    through the prefill worker's chunks, then its decodes."""
    import copy

    from uccl_tpu_torch.serving.engine import replay_alone

    r = copy.copy(req)
    r.prefill_chunk = chunk
    return replay_alone(backend, r).tolist()

def fleet_check(backend, traffic, chunk) -> dict:
    """Two FleetWorkers on replicas of ``backend``: a request on worker B,
    submitted after its donor finished on worker A, takes A's prefix from
    the directory; both equal their replays."""
    from uccl_tpu_torch.p2p import Endpoint
    from uccl_tpu_torch.p2p.store import StoreClient, StoreServer
    from uccl_tpu_torch.serving import PrefixCache, ServingEngine, replicate_backend
    from uccl_tpu_torch.serving.engine import replay_alone
    from uccl_tpu_torch.serving.fleet import FleetWorker

    cfg = backend.server.cfg
    entry = 2 * cfg.n_layers * traffic["shared_len"] * cfg.n_kv_heads * cfg.head_dim * 4
    srv = StoreServer()
    made, engines = [], []
    tally = {"a": 0, "b": 0}
    try:
        for name, be in zip("ab", replicate_backend(backend, 2)):
            sc = StoreClient("127.0.0.1", srv.port)
            eng = ServingEngine(be, prefill_chunk=chunk, prefix_cache=PrefixCache(chunk))
            fw = FleetWorker(name, sc, Endpoint(), chunk=chunk, capacity_bytes=8 * entry,
                             max_entry_bytes=2 * entry, timeout_ms=60000)
            eng.attach_fleet(fw)
            b9_counted(eng, tally, name)
            made.append((fw, sc))
            engines.append(eng)
        rng = np.random.default_rng(13)
        shared = rng.integers(0, cfg.vocab, traffic["shared_len"])
        prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, traffic["suffix_len"])
                                   ]).astype(np.int32) for _ in range(2)]
        donor = engines[0].submit(prompts[0], max_new_tokens=traffic["new_tokens"])
        engines[0].drain()
        h0 = obs.counter("fleet_cache_hits_total").get()
        b0 = obs.counter("p2p_bytes_total").get(verb="kv_tier")
        t0 = time.perf_counter()
        req = engines[1].submit(prompts[1], max_new_tokens=traffic["new_tokens"])
        engines[1].drain()
        hit_s = time.perf_counter() - t0
        wire = obs.counter("p2p_bytes_total").get(verb="kv_tier") - b0
        if obs.counter("fleet_cache_hits_total").get() != h0 + 1 or \
                req.cache_hit_len != traffic["shared_len"]:
            fail(f"disagg_path fleet: no directory hit (cache_hit_len {req.cache_hit_len})")
        for eng, r in zip(engines, (donor, req)):
            if replay_alone(eng.backend, r).tolist() != r.out_tokens:
                fail(f"disagg_path fleet: request {r.rid} differs from its replay")
            if eng.pool.leaked():
                fail("disagg_path fleet: a slot leaked")
        for eng in engines:
            eng.prefix_cache.clear(eng.pool)
    finally:
        for fw, sc in made:
            fw.close()
            fw.ep.close()
            sc.close()
        srv.close()
    if not (tally["a"] and tally["b"]):
        fail(f"disagg_path fleet: B9 launched {tally} times")
    return {"shared_len": traffic["shared_len"], "cache_hit_len": req.cache_hit_len,
            "fetched_bytes": wire, "hit_request_s": hit_s, "b9_launches": tally,
            "requests_exact": 2}

def elastic_check(widths, device, sizes=ELASTIC) -> dict:
    """ElasticKVCache on the dense stack at the serving widths: a context
    of ``context`` tokens with a hot budget of ``hot_budget_blocks`` blocks,
    the rest in pinned host memory; every decode_step_elastic's logits
    equal decode_step's on the same rows, bit for bit."""
    from uccl_tpu_torch.ep.elastic import ElasticKVCache
    from uccl_tpu_torch.models import dense
    from uccl_tpu_torch.models import inference as inf

    cfg = dense.DenseConfig(vocab=widths["vocab"], dim=widths["dim"], n_layers=widths["layers"],
                            n_heads=widths["heads"], n_kv_heads=widths["kv_heads"],
                            head_dim=widths["dim"] // widths["heads"], ffn=widths["ffn"])
    params = dense.init_params(prng_key(2), cfg, device)
    block = sizes["block_tokens"]
    block_bytes = 2 * cfg.n_layers * block * cfg.n_kv_heads * cfg.head_dim * 4
    budget = sizes["hot_budget_blocks"] * block_bytes
    max_seq = sizes["context"] + sizes["steps"] + block
    prompt = np.random.default_rng(17).integers(0, cfg.vocab, (1, sizes["context"]))
    logits, cache = inf.prefill(params, prompt, cfg, max_seq)
    ekv = ElasticKVCache.from_cache(cache, block_tokens=block,
                                    hot_blocks=budget // block_bytes)
    if ekv.has_host != (torch.device(device).type == "cuda") or \
            not all(k.device.type == "cpu" for k, _ in ekv._cold) or not ekv.cold_blocks:
        fail("disagg_path elastic: the cold blocks are not in host memory")
    if ekv.has_host and not all(k.is_pinned() for k, _ in ekv._cold):
        fail("disagg_path elastic: the cold blocks are not pinned")
    cold0 = ekv.cold_blocks
    elastic_s = 0.0
    sync = torch.cuda.synchronize if ekv.has_host else (lambda: None)
    for _ in range(sizes["steps"]):
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        rows = (len(ekv._cold) + len(ekv._hot) + 1) * block
        same_rows = inf.KVCache(cache.k[:, :, :rows].clone(), cache.v[:, :, :rows].clone(),
                                cache.length)
        want, _ = inf.decode_step(params, tok, same_rows, cfg)
        _, cache = inf.decode_step(params, tok, cache, cfg)
        sync()
        t0 = time.perf_counter()
        logits = inf.decode_step_elastic(params, tok, ekv, cfg)
        sync()
        elastic_s += time.perf_counter() - t0
        if not torch.equal(logits, want):
            fail("disagg_path elastic: decode_step_elastic differs from decode_step")
    staged = ekv.cold_blocks * block_bytes
    return {"context": sizes["context"] + sizes["steps"], "block_tokens": block,
            "hot_budget_bytes": budget, "cold_blocks": [cold0, ekv.cold_blocks],
            "device_committed_bytes": ekv.device_committed_bytes(), "steps": sizes["steps"],
            "step_ms": elastic_s / sizes["steps"] * 1e3,
            "staged_bytes_per_step": staged,
            "staging_GBps": staged * sizes["steps"] / elastic_s / 1e9, "bit_equal": True}

def disagg_path(device=DEV, widths=SERVE_WIDTHS, traffic=DISAGG_TRAFFIC,
                fleet=FLEET_TRAFFIC, elastic=ELASTIC) -> int:
    """Disaggregated serving on the MoE stack at EP world 4 on the pallas
    wire: a PrefillWorker and a DecodeWorker in one process, every request
    equal to its replay_alone, B9 counted on both sides; then the fleet
    directory and the elastic KV cache. Returns B9's launches."""
    from uccl_tpu_torch import serve
    from uccl_tpu_torch.serving.disagg import drive_pair, warm_pair

    t_start = time.perf_counter()
    is_cuda = torch.device(device).type == "cuda"
    dev = "cuda" if is_cuda else "cpu"
    card = nvidia_smi_line() if is_cuda else "cpu"
    args = serve_args(widths, traffic, stack="moe", device=dev, slots=traffic["slots"])
    backend, _, vocab = serve.build_stack(args, dev, moe_wire="pallas")
    pw, dw = disagg_pair(backend, traffic)
    tally = {"prefill": 0, "decode": 0}
    fb0 = dma.WIRE_FALLBACK.total()
    try:
        warm_pair(pw, dw, prompt_len=traffic["prefill_chunk"])
        b9_counted(pw.engine, tally, "prefill")
        b9_counted(dw.engine, tally, "decode")
        prompts, lens, arrivals, _ = serve_workload(traffic, vocab, traffic["requests"])
        chunks0 = obs.counter("kv_stream_chunks_total").get(role="tx")
        done, wall = drive_pair(pw, dw, prompts, arrivals, traffic["new_tokens"])
        chunks = obs.counter("kv_stream_chunks_total").get(role="tx") - chunks0
        if len(done) != traffic["requests"]:
            fail(f"disagg_path: {len(done)} of {traffic['requests']} requests finished")
        t0 = time.perf_counter()
        differ = [r.rid for r in done if not r.adopted or r.n_generated != traffic["new_tokens"]
                  or replayed(dw.engine.backend, r, traffic["prefill_chunk"]) != r.out_tokens]
        replay_s = time.perf_counter() - t0
        if differ:
            fail(f"disagg_path: requests {differ} differ from their replay_alone")
        if pw.engine.pool.leaked() or dw.engine.pool.leaked():
            fail("disagg_path: a slot leaked")
        snap = dw.engine.snapshot()
        pw.close()
    finally:
        pw.ep.close()
        dw.ep.close()
    if not (tally["prefill"] and tally["decode"]) or dma.WIRE_FALLBACK.total() != fb0:
        fail(f"disagg_path: B9 launched {tally}, {dma.WIRE_FALLBACK.total() - fb0} fallbacks")
    cfg = backend.server.cfg
    kv_bytes = int(sum(lens)) * 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 4
    transfer = snap.get("disagg_transfer_ms", {})
    pair = {"requests_exact": len(done), "wall_s": wall, "replay_s": replay_s,
            "kv_slabs": chunks, "kv_bytes": kv_bytes, "kv_GBps": kv_bytes / wall / 1e9,
            "b9_launches": dict(tally), "ttft_ms": snap.get("disagg_ttft_ms"),
            "transfer_ms": transfer}
    fl = fleet_check(backend, fleet, traffic["prefill_chunk"])
    el = elastic_check(widths, device, elastic)
    emit("disagg_path", widths=widths, traffic=traffic, wire="pallas", pair=pair, fleet=fl,
         elastic=el, card=card, seconds=time.perf_counter() - t_start)
    return tally["prefill"] + tally["decode"] + sum(fl["b9_launches"].values())

# ---------------------------------------------------------------------------
# 12. ResNet-50 data-parallel: the reference's DDP workload, its sync on B7

# examples/ddp_train.py's mesh path at full width: W members on the card, 32
# 224x224 images each, each member its own BN state, one [W, K] f32
# gradient bucket a step through the Communicator's "pallas" all-reduce (B7),
# SGD with momentum as optax.sgd
RESNET = dict(world=4, per_member=32, image=224, steps=5, lr=0.05, momentum=0.9, seed=0)
RESNET_BUCKET = 25_557_032  # f32 elements per member: ResNet-50's parameters
# Each member's step 1 against the same step in float64 on the card,
# through the port's module. f32 convolutions and sums in another order
# than float64's: logits within 1e-4 relative in norm, each gradient leaf
# within 1e-2 relative in norm plus 1e-5 of the whole gradient's norm. The
# leaves lie downstream of train-mode BN's backward, which subtracts each
# channel's means of dy and dy·x̂: a cancellation that leaves f32 gradients
# up to a few 1e-3 off in places (the phase reports each member's worst
# leaf), and the floor covers leaves that are small sums of many cancelling
# terms (a stage-1 BN bias sums 100,352 products). TF32 convolutions
# (10-bit operands) must fail the rule: the phase plants them and reports
# how far they miss.
RESNET_LOGITS_RTOL = 1e-4
RESNET_GRAD_RTOL = 1e-2
RESNET_GRAD_FLOOR = 1e-5
RESNET_SCOPES = ("resnet.fwd_bwd", "resnet.sync", "resnet.update")
RESNET_B7 = {}  # B7's times at the ResNet bucket, for the kernel line
_CONV_KERNEL = re.compile(r"conv|cudnn|xmma|fprop|dgrad|wgrad|implicit|winograd", re.I)

def resnet_batches(r=RESNET) -> list:
    """examples/ddp_train.py:102-117's global batches from the seed: x
    [W, B, 224, 224, 3] f32 normal draws, label 5 where an image's mean is
    above 0, else 0."""
    rng = np.random.default_rng(r["seed"])
    out = []
    for _ in range(r["steps"]):
        x = rng.standard_normal((r["world"], r["per_member"], r["image"], r["image"], 3))
        x = x.astype(np.float32)
        y = (x.mean(axis=(2, 3, 4)) > 0).astype(np.int64) * 5 % 10
        out.append((torch.from_numpy(x).to(DEV), torch.from_numpy(y).to(DEV)))
    return out

def resnet_run(params, state, w) -> dict:
    """A DDP run's state: its own copy of the params (leaves in the bucket's
    order, jax.tree's), momentum traces, each member's BN state, the bucket."""
    params = resnet._tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    leaves = resnet.tree_leaves(params)
    k = sum(p.numel() for p in leaves)
    return dict(params=params, leaves=leaves, momentum=[torch.zeros_like(p) for p in leaves],
                states=[state] * w, bucket=torch.empty((w, k), device=DEV))

def resnet_step(cfg, run, x, y, sync, member_hists=None, r=RESNET) -> tuple:
    """One step of ddp_train.py's mesh path: each member's forward and
    backward into its bucket row, ``sync(bucket)``, the average of member 0's
    copy unflattened, then optax.sgd's update (trace = g + momentum·trace;
    p -= lr·trace). Each phase ends in a sync. Returns the members' losses
    and the reduced bucket."""
    w, losses = x.shape[0], []
    with tracing.annotate("resnet.fwd_bwd"), tracing.timed_scope("resnet.fwd_bwd"):
        for m in range(w):
            t0 = time.perf_counter()
            loss, run["states"][m] = resnet.loss_fn(run["params"], run["states"][m], x[m], y[m],
                                                    cfg)
            grads = torch.autograd.grad(loss, run["leaves"])
            torch.cat([g.reshape(-1) for g in grads], out=run["bucket"][m])
            losses.append(loss.detach())
            del grads, loss
            torch.cuda.synchronize()
            if member_hists is not None:
                member_hists[m].observe(time.perf_counter() - t0)
    with tracing.annotate("resnet.sync"), tracing.timed_scope("resnet.sync"):
        reduced = sync(run["bucket"])
        torch.cuda.synchronize()
    with tracing.annotate("resnet.update"), tracing.timed_scope("resnet.update"), \
            torch.no_grad():
        avg, off = reduced[0] / w, 0
        for p, trace in zip(run["leaves"], run["momentum"]):
            trace.mul_(r["momentum"]).add_(avg[off:off + p.numel()].view(p.shape))
            p.sub_(trace * r["lr"])
            off += p.numel()
        torch.cuda.synchronize()
    return losses, reduced

def resnet_float64(cfg, params, state, x, y) -> tuple:
    """One member's step on ``x``, ``y`` in float64 through the port's
    module: its logits and its gradient leaves."""
    cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
    p64 = resnet._tree_map(lambda t: t.detach().double().requires_grad_(), params)
    loss64, _ = resnet.loss_fn(p64, state, x, y, cfg64)
    g64 = torch.autograd.grad(loss64, resnet.tree_leaves(p64))
    with torch.no_grad():
        logits64 = resnet.forward(p64, state, x, cfg64, train=True)[0]
    return logits64, g64

def resnet_vs_float64(logits, grads, ref) -> dict:
    """f32 ``logits`` and flat gradients ``grads`` (a bucket row) against
    the float64 step ``ref``; ``worst`` is the largest error over its rule
    (pass: <= 1). Also the whole gradient's relative error in norm and the
    largest leaf's (of the leaves above 1% of the whole gradient's norm)."""
    logits64, g64 = ref
    total = math.sqrt(sum(g.square().sum().item() for g in g64))
    worst_g, leaf_rel, sq, off = 0.0, 0.0, 0.0, 0
    for g in g64:
        err = (grads[off:off + g.numel()].double() - g.reshape(-1)).norm().item()
        norm = g.norm().item()
        worst_g = max(worst_g, err / (RESNET_GRAD_RTOL * norm + RESNET_GRAD_FLOOR * total))
        if norm > 1e-2 * total:
            leaf_rel = max(leaf_rel, err / norm)
        sq += err * err
        off += g.numel()
    rel = ((logits.double() - logits64).norm() / logits64.norm()).item()
    out = dict(logits_rel=rel, grads_rel=math.sqrt(sq) / total, worst_leaf_rel=leaf_rel,
               worst_logits=rel / RESNET_LOGITS_RTOL, worst_grads=worst_g)
    out["worst"] = max(out["worst_logits"], worst_g)
    return out

@contextlib.contextmanager
def tf32_convs():
    """The planted fault: the convolutions' guard turns TF32 on."""
    real = resnet._exact_f32

    @contextlib.contextmanager
    def faulty():
        with real():
            torch.backends.cudnn.allow_tf32 = True
            yield

    resnet._exact_f32 = faulty
    try:
        yield
    finally:
        resnet._exact_f32 = real

def resnet_member_grads(cfg, params, state, x, y) -> torch.Tensor:
    """One member's flat gradients, on a copy of ``params``."""
    params = resnet._tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    leaves = resnet.tree_leaves(params)
    loss, _ = resnet.loss_fn(params, state, x, y, cfg)
    return torch.cat([g.reshape(-1) for g in torch.autograd.grad(loss, leaves)])

def resnet_trace(cfg, run, batch, sync) -> dict:
    """One step (on a copy of ``run``) under utils.tracing's capture; the
    trace must hold B7, convolution kernels and the step's annotations. A
    trace without B7 is retaken, up to three captures (C6). Also where the
    traced step's device time went: kernel ms of B7, the convolutions
    (cuDNN's fprop/dgrad/wgrad) and everything else (the BN, ReLU, pooling,
    loss and update passes), the device's busy ms (union of kernel
    intervals) and the traced step's span."""
    log_dir = tempfile.mkdtemp(prefix="resnet_trace_")
    try:
        for attempt in range(1, 4):
            copy = resnet_run(run["params"], run["states"][0], len(run["states"]))
            copy["states"] = list(run["states"])
            tracing.start_trace(log_dir)
            try:
                resnet_step(cfg, copy, *batch, sync)
            finally:
                path = tracing.stop_trace()
            with open(path) as f:
                events = json.load(f)["traceEvents"]
            del copy
            kernels = [e for e in events if e.get("cat") == "kernel"]
            notes = {e["name"] for e in events if e.get("cat") == "user_annotation"}
            split = {"b7": [0, 0.0], "conv": [0, 0.0], "other": [0, 0.0]}
            for e in kernels:
                cls = ("b7" if "ring_ar_kernel" in e["name"] else
                       "conv" if _CONV_KERNEL.search(e["name"]) else "other")
                split[cls][0] += 1
                split[cls][1] += e["dur"] / 1e3
            b7, convs = split["b7"][0], split["conv"][0]
            if b7:
                break
        else:
            fail(f"resnet_path: the profiler saw no ring_ar_kernel in {attempt} traces")
        if not convs or not set(RESNET_SCOPES) <= notes:
            fail(f"resnet_path trace: {convs} conv kernels, annotations {sorted(notes)}")
        spans = [(e["ts"], e["ts"] + e["dur"]) for e in kernels]
        return dict(profile_attempts=attempt, kernels=len(kernels),
                    kernel_count_ms={cls: {"count": n, "ms": ms} for cls, (n, ms) in split.items()},
                    device_busy_ms=profile_ep.union_ms(spans),
                    device_span_ms=(max(e for _, e in spans) - min(b for b, _ in spans)) / 1e3,
                    annotations=sorted(set(RESNET_SCOPES) & notes))
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)

def resnet_b7_timing(bucket) -> dict:
    """B7 at the ResNet bucket: CUDA events (median of 10, L2 flushed),
    utils.timing's chained and slope estimators (each iteration also runs
    the harness's perturb pass over the bucket, and the slope's a full
    reduction of the output), beside its HBM bound, its plain version and
    the library call."""
    w, k = bucket.shape
    out, lanes = torch.empty_like(bucket), []
    red, lib_out = torch.empty_like(bucket[0]), torch.empty_like(bucket)

    def b7(x):
        o = torch.empty_like(x)
        lanes.append(rc.launch_ar(x, o, (1, -1), 0))
        return o

    res = dict(ms=time_ms(lambda: lanes.append(rc.launch_ar(bucket, out, (1, -1), 0)), 10),
               bound_ms=ring_bound_ms("ring_all_reduce", w, k, 4), bound_by="bytes",
               plain_ms=time_ms(lambda: rc.ar_chain_plain(bucket, (1, -1)), 3),
               library_ms=time_ms(lambda: lib_out.copy_(torch.sum(bucket, 0, out=red)
                                                        .expand_as(bucket)), 10),
               library_call="torch.sum(x, 0, out=red) then out.copy_(red.expand_as(x))")
    res["chained_ms"] = 1e3 * timing.chained_timeit(
        "resnet_path B7 chained", lambda x, c: c + b7(x)[0, 0], bucket, iters=10)
    res["slope_ms"] = 1e3 * timing.slope_timeit(b7, (bucket,), 10, signal_floor=0.02, n_cap=200)
    for lane in lanes:
        lane.check("resnet_path B7 timing")
    res["share_of_bound"] = res["bound_ms"] / res["ms"]
    return res

def resnet_slo(step_s, flight_dir) -> dict:
    """A burn-rate monitor on the steps' time histogram, its threshold the
    largest bucket edge below the fastest step: it must alert, write a
    slo_burn bundle, and doctor must read it as slo_violation."""
    reg = obs.Registry()
    hist = reg.histogram("resnet_step_seconds", "ResNet-50 DDP step wall time")
    threshold = max(b for b in hist.uppers if b < min(step_s))
    mon = obs.BurnRateMonitor([obs.Objective("step", "resnet_step_seconds", threshold, 0.99)],
                              windows=((60.0, 1.0),), registry=reg)
    mon.sample(now=0.0)
    for s in step_s:
        hist.observe(s)
    rec = obs.enable_flight(flight_dir, min_interval_s=0.0)
    try:
        alerts = mon.evaluate(now=61.0)
    finally:
        obs.disable_flight()
    if len(alerts) != 1 or len(rec.bundles) != 1:
        fail(f"resnet_path slo: {len(alerts)} alerts, {len(rec.bundles)} bundles")
    verdict = doctor.diagnose(doctor.load_bundle(rec.bundles[0]))
    if verdict["root_cause"] != "slo_violation":
        fail(f"resnet_path slo: doctor read {verdict['root_cause']}")
    return dict(threshold_s=threshold, alert=alerts[0].as_dict(),
                bundle=os.path.basename(rec.bundles[0]), root_cause=verdict["root_cause"],
                narrative=verdict["narrative"][0])

def resnet_path(r=RESNET) -> int:
    """ResNet-50 data-parallel on the card (examples/ddp_train.py's mesh
    path): 5 steps at W = 4 members of 32 images, the gradient bucket
    through Communicator.all_reduce(algo="pallas"), B7, once a step. Gates:
    B7 launched once a step; each reduced bucket bit-identical to
    ar_chain_plain and within (W-1)·u·Σ|x| of the float64 sum (the xla and
    ring arms on step 1's bucket within the same rule); the 5 steps' params
    bit-equal to the same steps with ar_chain_plain in B7's place; each
    member's step 1 within the float64 rule, a TF32 step outside it; finite losses,
    moved BN stats, eval mode leaving the state. Then a traced step, the
    scopes, B7 timed three ways, an SLO burn read by doctor, and two
    members' metrics federated. Returns B7's launches."""
    t_start = time.perf_counter()
    cfg = resnet.ResNetConfig()
    w = r["world"]
    torch.cuda.empty_cache()
    params0, state0 = resnet.init_params(prng_key(r["seed"]), cfg, DEV)
    torch.cuda.reset_peak_memory_stats(DEV)
    if resnet.num_params(params0) != RESNET_BUCKET:
        fail(f"ResNet-50 has {resnet.num_params(params0)} parameters, expected {RESNET_BUCKET}")
    batches = resnet_batches(r)
    comm = Communicator(make_mesh(MeshConfig(dp=w)), AXIS.DP)
    pallas = lambda b: comm.all_reduce(b, algo="pallas")  # noqa: E731
    regs = [obs.Registry() for _ in range(w)]
    member_hists = [reg.histogram("resnet_member_fwd_bwd_seconds", "one member's fwd+bwd")
                    for reg in regs]
    tracing.reset_scopes()
    run, step_s, losses, checks = resnet_run(params0, state0, w), [], [], []
    fb0 = dma.WIRE_FALLBACK.total()
    torch.cuda.synchronize()
    rc.reset_launch_counts()
    for step, batch in enumerate(batches):
        before = rc.launch_counts["ring_all_reduce"]
        t0 = time.perf_counter()
        step_losses, reduced = resnet_step(cfg, run, *batch, pallas, member_hists, r)
        step_s.append(time.perf_counter() - t0)
        launched = rc.launch_counts["ring_all_reduce"] - before
        x = run["bucket"]
        rule = ring_rule("sum", reduced, rc.ar_chain_plain(x, (1, -1)), x, w, torch.float32)
        if launched != 1 or not rule["ok"]:
            fail(f"resnet_path step {step + 1}: B7 launched {launched} times, {rule}")
        check = dict(step=step + 1, b7_launches=launched, **rule)
        if step == 0:
            first_grads = x.clone()  # the members' step-1 gradients
            for algo in ("xla", "ring"):  # the other arms, within the same rule
                got = comm.all_reduce(x, algo=algo)
                check[f"{algo}_worst_over_bound"] = ring_rule("sum", got, got, x, w,
                                                              torch.float32)["worst_over_bound"]
                if check[f"{algo}_worst_over_bound"] > 1:
                    fail(f"resnet_path: the {algo} arm is outside (W-1)·u·Σ|x|: {check}")
                del got
        checks.append(check)
        losses.append([v.item() for v in step_losses])
        if not all(math.isfinite(v) for v in losses[-1]):
            fail(f"resnet_path step {step + 1}: losses {losses[-1]}")
        del reduced
    launches = rc.launch_counts["ring_all_reduce"]
    other = {k: v for k, v in rc.launch_counts.items() if k != "ring_all_reduce" and v}
    if launches != r["steps"] or other or dma.WIRE_FALLBACK.total() != fb0:
        fail(f"resnet_path: B7 {launches} launches, others {other}, "
             f"{dma.WIRE_FALLBACK.total() - fb0} fallbacks")
    peak_gib = torch.cuda.max_memory_allocated(DEV) / 2**30
    scopes = {name: tracing.scope_stats(name) for name in RESNET_SCOPES}
    for m in range(w):  # every member's BN statistics moved off their init
        still = [i for i, (a, b) in enumerate(zip(resnet.tree_leaves(run["states"][m]),
                                                  resnet.tree_leaves(state0)))
                 if torch.equal(a, b)]
        if still:
            fail(f"resnet_path: member {m}'s BN state leaves {still} did not move")
    x0, y0 = batches[0][0][0], batches[0][1][0]
    eval_state = run["states"][0]
    with torch.no_grad():
        eval_logits, after = resnet.forward(run["params"], eval_state, x0, cfg, train=False)
    if not all(torch.equal(a, b) for a, b in zip(resnet.tree_leaves(after),
                                                 resnet.tree_leaves(eval_state))) \
            or not torch.isfinite(eval_logits).all():
        fail("resnet_path: train=False changed the BN state or gave non-finite logits")
    # the same 5 steps with ar_chain_plain in B7's place
    shadow = resnet_run(params0, state0, w)
    for batch in batches:
        resnet_step(cfg, shadow, *batch, lambda b: rc.ar_chain_plain(b, (1, -1)), None, r)
    differ = [i for i, (a, b) in enumerate(zip(run["leaves"], shadow["leaves"]))
              if not torch.equal(a, b)]
    if differ:
        fail(f"resnet_path: after {r['steps']} steps, param leaves {differ} differ from "
             "the run with ar_chain_plain in B7's place")
    del shadow
    torch.cuda.empty_cache()
    # each member's step 1 against float64, then the planted TF32 fault on
    # member 0's
    vs64 = []
    for m in range(w):
        xm, ym = batches[0][0][m], batches[0][1][m]
        ref = resnet_float64(cfg, params0, state0, xm, ym)
        with torch.no_grad():
            logits = resnet.forward(params0, state0, xm, cfg, train=True)[0]
        vs64.append(resnet_vs_float64(logits, first_grads[m], ref))
        if vs64[-1]["worst"] > 1:
            fail(f"resnet_path: member {m}'s step 1 is outside the float64 rule: {vs64[-1]}")
    ref = resnet_float64(cfg, params0, state0, x0, y0)
    with tf32_convs(), torch.no_grad():
        logits = resnet.forward(params0, state0, x0, cfg, train=True)[0]
    with tf32_convs():
        tf32_vs64 = resnet_vs_float64(logits, resnet_member_grads(cfg, params0, state0, x0, y0),
                                      ref)
    if tf32_vs64["worst"] <= 1:
        fail(f"resnet_path: TF32 convolutions passed the float64 rule: {tf32_vs64}")
    del ref, logits, first_grads
    torch.cuda.empty_cache()
    traced = resnet_trace(cfg, run, batches[0], pallas)
    b7 = resnet_b7_timing(run["bucket"])
    flight_dir = tempfile.mkdtemp(prefix="resnet_flight_")
    try:
        slo = resnet_slo(step_s, flight_dir)
    finally:
        shutil.rmtree(flight_dir, ignore_errors=True)
    texts = [("member0", obs.prometheus_text(regs[0])), ("member1", obs.prometheus_text(regs[1]))]
    fleet = aggregate.aggregate(texts)
    counts = fleet["fleet"]["resnet_member_fwd_bwd_seconds_count"][()]
    if counts != 2 * r["steps"]:
        fail(f"resnet_path: the federated histogram counts {counts}, not {2 * r['steps']}")
    step_ms = statistics.median(step_s[1:]) * 1e3
    images = w * r["per_member"]
    emit("resnet_path", config={f.name: str(getattr(cfg, f.name))
                                for f in dataclasses.fields(cfg)},
         world=w, images_per_member=r["per_member"], image=r["image"],
         bucket_elems_per_member=RESNET_BUCKET, bucket_bytes_per_member=RESNET_BUCKET * 4,
         steps=r["steps"], losses=losses, step_ms=[s * 1e3 for s in step_s],
         step_ms_median_2_5=step_ms, images_per_s=images / step_ms * 1e3,
         peak_mem_gib=peak_gib, b7_launches=launches, checks=checks,
         vs_float64=vs64, tf32_fault_vs_float64=tf32_vs64,
         scopes_us={k: v and {q: v[q] for q in ("count", "p50_us", "max_us")}
                    for k, v in scopes.items()},
         trace=traced, b7=b7, b7_share_of_step=b7["ms"] / step_ms, slo=slo,
         federated=dict(fleet_count=counts,
                        fleet_p50_s=aggregate.fleet_quantile(
                            fleet, "resnet_member_fwd_bwd_seconds", 50)),
         card=nvidia_smi_line(), seconds=time.perf_counter() - t_start)
    RESNET_B7.update(b7)
    return launches

def main() -> None:
    t_start = time.perf_counter()
    toolchain()
    build_kernels()
    readings, x, plain = check_kernels(8, 1024, 16, 4, 64, True, seed=0)  # main-path shape
    planted_faults(x, plain)
    del x, plain
    check_kernels(2, 256, 4, 4, 64, False, seed=1)  # small, non-causal, n_rep = 1
    # a ring step's shard at mesh_path's mesh A: non-causal, GQA n_rep = 4,
    # a nonzero lse cotangent (what the LSE merge sends back)
    _, x, plain = check_kernels(*RING_SHARD, False, seed=5)
    planted_faults(x, plain, causal=False)
    del x, plain
    errs = {"flash_fwd": readings["out"]["max_abs_err"],
            "flash_bwd_dq": readings["dq"]["max_abs_err"],
            "flash_bwd_dkv": max(readings["dk"]["max_abs_err"], readings["dv"]["max_abs_err"])}
    timing = time_kernels(8, 1024, 16, 4, 64)
    # the f32 kernels: the main path's shape, its planted faults, then odd
    # lengths, Sq != Sk, GQA and D = 128, causal and not
    f32_readings, x, plain = check_kernels_f32(8, 1024, 16, 4, 64, True, seed=0, float64=True)
    f32_planted_faults(x, plain)
    del x, plain
    check_kernels_f32(2, 77, 4, 1, 64, True, seed=1)
    check_kernels_f32(2, 200, 8, 2, 64, False, seed=2, sk=136)
    check_kernels_f32(1, 320, 8, 2, 128, True, seed=3)
    check_kernels_f32(1, 130, 4, 4, 128, False, seed=4)
    _, x, plain = check_kernels_f32(*RING_SHARD, False, seed=5)
    f32_planted_faults(x, plain, causal=False)
    del x, plain
    for name, reading in (("flash_fwd", "out"), ("flash_bwd_dq", "dq")):
        errs[f"{name}_f32"] = f32_readings[reading]["max_abs_err"]
    errs["flash_bwd_dkv_f32"] = max(f32_readings["dk"]["max_abs_err"],
                                    f32_readings["dv"]["max_abs_err"])
    timing.update(time_kernels_f32(8, 1024, 16, 4, 64))
    launches = main_path()
    torch.cuda.empty_cache()
    launches.update(train_path())
    torch.cuda.empty_cache()
    mesh_launches = mesh_path()
    for name in fa.F32_KERNELS:
        launches[name] += mesh_launches[name]
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
    del refs
    torch.cuda.empty_cache()
    for name, n in dist_path(bucket).items():
        ring_launches[name] += n
    del bucket
    torch.cuda.empty_cache()
    ep_fb0 = dma.WIRE_FALLBACK.total()
    ep_errs = ep_a2a_vs_plain()["max_abs_err_vs_plain"]
    ep_time = ep_a2a_timing()
    torch.cuda.empty_cache()
    ep_launches = ep_path()
    if dma.WIRE_FALLBACK.total() != ep_fb0:
        fail(f"the EP phases fell back {dma.WIRE_FALLBACK.total() - ep_fb0} times")
    torch.cuda.empty_cache()
    gather_time = moe_gather_timing()
    torch.cuda.empty_cache()
    serve_launches = serve_path()
    torch.cuda.empty_cache()
    serve_launches["serve_features_path"] = serve_features_path()
    torch.cuda.empty_cache()
    serve_launches["p2p_path"] = p2p_path()
    torch.cuda.empty_cache()
    serve_launches["disagg_path"] = disagg_path()
    torch.cuda.empty_cache()
    ring_launches["ring_all_reduce"] += resnet_path()
    torch.cuda.empty_cache()
    ep_launches["a2a"] += (mesh_launches["a2a"] + serve_launches["prefill"]
                           + serve_launches["decode"]
                           + sum(serve_launches["serve_features_path"].values())
                           + serve_launches["p2p_path"] + serve_launches["disagg_path"])
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": {**REPLACES, **F32_REPLACES}[name],
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
         "library_call": ring_time[name]["library_call"],
         **({"resnet_bucket": RESNET_B7} if name == "ring_all_reduce" else {})}
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
         "library_call": ep_time[timed]["library_call"], "timed": timed,
         **({"serve_launches": serve_launches,
             "serving": {kind: {key: t[key] for key in ("ms", "bound_ms", "library_ms",
                                                        "plain_ms", "pieces_per_pair",
                                                        "blocks_per_member")}
                         for kind, t in ep_time["a2a"]["serving"].items()}}
            if name == "a2a" else {})}
        for name, timed in (("a2a", "a2a"), ("sched_round", "sched_round schedule"))
    ] + [
        # the flagship cell's layer; the Mixtral cell's beside it. Bits equal
        # to the plain versions' but dw's, whose dot products sum in
        # another order
        {"name": f"moe_{role}", "route": "cuda", "source": GATHER_SOURCE,
         "replaces": GATHER_REPLACES, "launches": launches[f"moe_{role}"],
         "max_abs_err": gather_time["flagship"][role].get("dw_max_abs_err", 0.0),
         **{key: gather_time["flagship"][role][key]
            for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_call")},
         "mixtral": gather_time["mixtral"][role]}
        for role in gather.ROLES
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
