"""Design arms of the flash-attention kernels on the card:
``python -m uccl_tpu_torch.flash_arms [--set bf16|f32|all] [--arms NAME ...]``.

Builds copies of ``csrc/flash_attention.cu`` that differ from the source in
one choice, with :func:`~uccl_tpu_torch.utils.build.build_variant` (one
``nvcc`` each, started together); an arm is one list of ``(old, new)`` text
substitutions. ``ARMS`` are the bf16 kernels' (the ring's stage count),
timed at both CTA tiles; ``F32_ARMS`` the f32 kernels' (3xTF32): B1's
``mma.sync`` design against its ``wgmma`` one (at 128 and 64 CTA rows), its
``wgmma`` design at 64 rows (one warpgroup) and on one ring stage; B2's and
B3's other ring depth (one stage against two) and CTA rows (64 against
128), B3's fragments split in registers against split tiles, P and dS
through a warp's shared-memory tile against straight from the accumulators,
and the ring on 1-D bulk copies (TMA's copy engine, one a row, completing
on an mbarrier) against ``cp.async``. It times each copy beside the
source's own build at the main path's shapes (B=8, S=1024, H=16, Hkv=4,
D=64, causal): B2 and B3 in bf16, B1, B2 and B3 in f32. Each timing runs in
a process of its own (each build carries its own CUDA runtime), in turns
(source, arm, arm, source) so that drift on the card shows, after holding
that build's kernels to their plain versions (``fa.kernel_error``, with a
nonzero lse cotangent; the f32 lse to ``fa.F32_LSE_ATOL``). ``--arms``
times only the arms named. Prints one JSON line. Needs a GPU.

JAX counterpart: none (the TPU kernels' tiles were chosen by hand).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from uccl_tpu_torch import resolve_device
from uccl_tpu_torch.ops import flash_attention as fa
from uccl_tpu_torch.ops.attention import HOPPER_TILES
from uccl_tpu_torch.utils import build

ARMS = {
    "stages 2": [("constexpr int kStages = 4;", "constexpr int kStages = 2;")],
    "stages 3": [("constexpr int kStages = 4;", "constexpr int kStages = 3;")],
}
_B3_64_ROWS = ("constexpr int kF32DkvRows = D == 64 ? 128 : 64;",
                "constexpr int kF32DkvRows = 64;")
_B1_MMA = ("constexpr bool kF32FwdWgmma = D == 64;", "constexpr bool kF32FwdWgmma = false;")
_B1_64_ROWS = ("constexpr int kF32FwdRows = D == 64 ? 128 : 64;", "constexpr int kF32FwdRows = 64;")
F32_ARMS = {
    "f32 B1 mma.sync": [_B1_MMA],
    "f32 B1 mma.sync 64-row CTAs": [_B1_MMA, _B1_64_ROWS],
    "f32 B1 64-row CTAs": [_B1_64_ROWS],
    "f32 B1 one stage": [("constexpr int kF32FwdRing = 2;", "constexpr int kF32FwdRing = 1;")],
    "f32 B2 two stages": [("constexpr int kF32DqRing = 1;", "constexpr int kF32DqRing = 2;")],
    "f32 B3 one stage": [("constexpr int kF32DkvRing = 2;", "constexpr int kF32DkvRing = 1;")],
    "f32 B2 128-row CTAs": [("constexpr int kF32DqRows = 64;",
                             "constexpr int kF32DqRows = D == 64 ? 128 : 64;")],
    "f32 B3 64-row CTAs": [_B3_64_ROWS],
    "f32 B3 fragments split in registers": [("constexpr bool kF32PreSplit = D == 64;",
                                             "constexpr bool kF32PreSplit = false;")],
    # at 128 rows B3's warps' P/dS tiles do not fit beside its split tiles
    "f32 dS through shared memory, B3 64-row CTAs": [
        ("constexpr bool kF32DsInRegisters = true;", "constexpr bool kF32DsInRegisters = false;"),
        _B3_64_ROWS],
    "f32 TMA bulk ring": [("constexpr bool kF32BulkRing = false;",
                           "constexpr bool kF32BulkRing = true;")],
}
SHAPE = dict(B=8, S=1024, H=16, Hkv=4, D=64, causal=True)


def time_ms(fn, reps: int, dev) -> float:
    """Median CUDA-event time of fn, L2 flushed before each run (as
    chip_smoke.py times every kernel)."""
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
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


def registers(log: str) -> dict:
    """Registers of each f32 kernel in nvcc's -Xptxas -v report."""
    out, kernel = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = re.search(r"flash_(fwd|bwd_dq|bwd_dkv)_f32_kernelILi\d+E", line)
        elif "registers" in line and kernel:
            out[kernel[0]] = int(line.split("Used ")[1].split()[0])
    return out


def spill_bytes(log: str) -> int:
    """Spill stores of the flash kernels in nvcc's -Xptxas -v report."""
    total, flash = 0, False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            flash = "flash_" in line
        elif "spill stores" in line and flash:
            total += int(line.split("bytes spill stores")[0].split(",")[-1])
    return total


def smem_bytes(lib_path: str) -> dict:
    """Dynamic shared memory per CTA of a build's f32 kernels at D = 64."""
    lib = fa.declare(ctypes.CDLL(lib_path))
    return {name: lib.uccl_flash_f32_smem(kind, SHAPE["D"])
            for kind, name in enumerate(fa.F32_KERNELS)}


def time_build(lib_path: str, tile: int, reps: int, f32: bool = False) -> dict:
    """One build's B2 and B3 at SHAPE (bf16 at ``tile``), or its f32 B1, B2
    and B3: held to the plain versions (``fa.kernel_error``), then timed."""
    dev = resolve_device("cuda")
    lib = fa.declare(ctypes.CDLL(lib_path))
    b, s, h, hkv, d, causal = (SHAPE[k] for k in ("B", "S", "H", "Hkv", "D", "causal"))
    dtype = torch.float32 if f32 else torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(2)
    q, dout = (torch.randn((b, s, h, d), generator=g, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn((b, s, hkv, d), generator=g, device=dev).to(dtype) for _ in range(2))
    g_lse = torch.randn((b, h, s), generator=g, device=dev) * 0.5
    out, lse = fa.flash_fwd_plain(q, k, v, causal)
    delta = fa.flash_delta(out, dout, g_lse)
    x = (q, k, v, dout, lse, delta)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dims = (b, s, s, h, hkv, d, int(causal), *(() if f32 else (tile,)), fa._stream(q))
    dq_fn, dkv_fn = ((lib.uccl_flash_bwd_dq_f32, lib.uccl_flash_bwd_dkv_f32) if f32 else
                     (lib.uccl_flash_bwd_dq, lib.uccl_flash_bwd_dkv))

    def b2():
        fa._raise_on(dq_fn(*map(fa._ptr, (*x, dq)), *dims), "B2")

    def b3():
        fa._raise_on(dkv_fn(*map(fa._ptr, (*x, dk, dv)), *dims), "B3")

    o, l = torch.empty_like(q), torch.empty_like(lse)

    def b1():
        fa._raise_on(lib.uccl_flash_fwd_f32(*map(fa._ptr, (q, k, v, o, l)), *dims), "B1")

    b2()
    b3()
    got, want = [dq, dk, dv], [fa.flash_bwd_dq_plain(*x, causal),
                               *fa.flash_bwd_dkv_plain(*x, causal)]
    if f32:
        b1()
        got.append(o)
        want.append(out)
    worst = max(fa.kernel_error(a, w)["worst"] for a, w in zip(got, want))
    lse_err = (l - lse).abs().max().item() if f32 else 0.0
    if not (worst <= 1 and lse_err <= fa.F32_LSE_ATOL):
        raise RuntimeError(f"{lib_path} at tile {tile}: worst {worst}, lse {lse_err}")
    return {"worst": worst, "B2_ms": time_ms(b2, reps, dev), "B3_ms": time_ms(b3, reps, dev),
            **({"B1_ms": time_ms(b1, reps, dev), "lse_err": lse_err} if f32 else {})}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m uccl_tpu_torch.flash_arms")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--lib", help="time this build only (one process a build)")
    ap.add_argument("--tile", type=int, default=64)
    ap.add_argument("--f32", action="store_true", help="with --lib: the f32 kernels")
    ap.add_argument("--set", choices=("bf16", "f32", "all"), default="all",
                    help="which kernels' arms to build and time")
    ap.add_argument("--arms", nargs="+", help="only these arms (names of ARMS or F32_ARMS)")
    args = ap.parse_args(argv)
    if args.lib:
        print(json.dumps(time_build(args.lib, args.tile, args.reps, args.f32)), flush=True)
        return
    resolve_device("cuda")
    arms = {**(ARMS if args.set != "f32" else {}), **(F32_ARMS if args.set != "bf16" else {})}
    if args.arms:
        unknown = set(args.arms) - set(arms)
        if unknown:
            raise SystemExit(f"flash_arms: no arm {sorted(unknown)} in --set {args.set}")
        arms = {name: arms[name] for name in args.arms}
    with ThreadPoolExecutor(len(arms) + 1) as pool:
        jobs = {name: pool.submit(build.build_variant, "flash_attention",
                                  name.replace(" ", "_"), subs)
                for name, subs in arms.items()}
        libs = {"source": str(pool.submit(build.build, "flash_attention").result()),
                **{name: str(j.result()) for name, j in jobs.items()}}

    def run(name, tile, f32):
        proc = subprocess.run(
            [sys.executable, "-m", "uccl_tpu_torch.flash_arms", "--lib", libs[name],
             "--tile", str(tile), "--reps", str(args.reps), *(["--f32"] if f32 else [])],
            capture_output=True, text=True, check=True,
            env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                [str(build.PACKAGE_DIR.parent), *filter(None, [os.environ.get("PYTHONPATH")])])))
        return json.loads(proc.stdout.strip().splitlines()[-1])

    logs = {name: (Path(path).parent / "nvcc.log").read_text() for name, path in libs.items()
            if name != "source"}
    logs["source"] = build.build_log("flash_attention")
    cases = [(name, tile, False) for tile in HOPPER_TILES for name in arms if name in ARMS]
    cases += [(name, 64, True) for name in arms if name in F32_ARMS]
    rows = []
    for name, tile, f32 in cases:
        runs = [run(which, tile, f32) for which in ("source", name, name, "source")]
        rows.append({"arm": name, "tile": None if f32 else tile, "f32": f32,
                     "order": "source, arm, arm, source",
                     **({"B1_ms": [r["B1_ms"] for r in runs]} if f32 else {}),
                     "B2_ms": [r["B2_ms"] for r in runs], "B3_ms": [r["B3_ms"] for r in runs],
                     "worst": max(r["worst"] for r in runs),
                     "spill_bytes": spill_bytes(logs[name]), "registers": registers(logs[name]),
                     "f32_smem": smem_bytes(libs[name]) if f32 else None})
    print(json.dumps({"flash_arms": rows, "shape": SHAPE, "source_registers": registers(
        logs["source"]), "source_f32_smem": smem_bytes(libs["source"]),
        "gpu": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
