"""Design arms of the flash-attention backward (B2, B3) on the card:
``python -m uccl_tpu_torch.flash_arms``.

Builds copies of ``csrc/flash_attention.cu`` that differ from the source in
one choice, with :func:`~uccl_tpu_torch.utils.build.build_variant` (one
``nvcc`` each, started together), here the ring's stage count; an arm is
one list of ``(old, new)`` text substitutions in ``ARMS``. It times B2 and
B3 of each copy beside
the source's own build at the main path's shapes (B=8, S=1024, H=16, Hkv=4,
D=64, causal, bf16) at both CTA tiles. Each timing runs in a process of its
own (each build carries its own CUDA runtime), in turns (source, arm, arm,
source) so that drift on the card shows, after holding that build's B2 and
B3 to their plain versions. Prints one JSON line. Needs a GPU.

JAX counterpart: none (the TPU kernels' tiles were chosen by hand).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
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


def spill_bytes(log: str) -> int:
    """Spill stores of the backward kernels in nvcc's -Xptxas -v report."""
    total, backward = 0, False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            backward = "flash_bwd_" in line
        elif "spill stores" in line and backward:
            total += int(line.split("bytes spill stores")[0].split(",")[-1])
    return total


def time_build(lib_path: str, tile: int, reps: int) -> dict:
    """One build's B2 and B3 at SHAPE and ``tile``: held to the plain
    versions (``fa.kernel_error``), then timed."""
    dev = resolve_device("cuda")
    lib = fa.declare(ctypes.CDLL(lib_path))
    b, s, h, hkv, d, causal = (SHAPE[k] for k in ("B", "S", "H", "Hkv", "D", "causal"))
    g = torch.Generator(device=dev).manual_seed(2)
    q, dout = (torch.randn((b, s, h, d), generator=g, device=dev).bfloat16() for _ in range(2))
    k, v = (torch.randn((b, s, hkv, d), generator=g, device=dev).bfloat16() for _ in range(2))
    out, lse = fa.flash_fwd_plain(q, k, v, causal)
    delta = fa.flash_delta(out, dout)
    x = (q, k, v, dout, lse, delta)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dims = (b, s, s, h, hkv, d, int(causal), tile, fa._stream(q))

    def b2():
        fa._raise_on(lib.uccl_flash_bwd_dq(*map(fa._ptr, (*x, dq)), *dims), "flash_bwd_dq")

    def b3():
        fa._raise_on(lib.uccl_flash_bwd_dkv(*map(fa._ptr, (*x, dk, dv)), *dims), "flash_bwd_dkv")

    b2()
    b3()
    worst = max(fa.kernel_error(got, want)["worst"] for got, want in zip(
        (dq, dk, dv), (fa.flash_bwd_dq_plain(*x, causal), *fa.flash_bwd_dkv_plain(*x, causal))))
    if not worst <= 1:
        raise RuntimeError(f"{lib_path} at tile {tile}: worst {worst} > 1")
    return {"worst": worst, "B2_ms": time_ms(b2, reps, dev), "B3_ms": time_ms(b3, reps, dev)}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m uccl_tpu_torch.flash_arms")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--lib", help="time this build only (one process a build)")
    ap.add_argument("--tile", type=int, default=64)
    args = ap.parse_args(argv)
    if args.lib:
        print(json.dumps(time_build(args.lib, args.tile, args.reps)), flush=True)
        return
    resolve_device("cuda")
    with ThreadPoolExecutor(len(ARMS) + 1) as pool:
        jobs = {name: pool.submit(build.build_variant, "flash_attention",
                                  name.replace(" ", "_"), subs)
                for name, subs in ARMS.items()}
        libs = {"source": str(pool.submit(build.build, "flash_attention").result()),
                **{name: str(j.result()) for name, j in jobs.items()}}

    def run(name, tile):
        proc = subprocess.run(
            [sys.executable, "-m", "uccl_tpu_torch.flash_arms", "--lib", libs[name],
             "--tile", str(tile), "--reps", str(args.reps)],
            capture_output=True, text=True, check=True,
            env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                [str(build.PACKAGE_DIR.parent), *filter(None, [os.environ.get("PYTHONPATH")])])))
        return json.loads(proc.stdout.strip().splitlines()[-1])

    logs = {name: (Path(path).parent / "nvcc.log").read_text() for name, path in libs.items()
            if name != "source"}
    logs["source"] = build.build_log("flash_attention")
    rows = []
    for tile in HOPPER_TILES:
        for name in ARMS:
            runs = [run(which, tile) for which in ("source", name, name, "source")]
            rows.append({"arm": name, "tile": tile, "order": "source, arm, arm, source",
                         "B2_ms": [r["B2_ms"] for r in runs], "B3_ms": [r["B3_ms"] for r in runs],
                         "worst": max(r["worst"] for r in runs),
                         "spill_bytes": spill_bytes(logs[name])})
    print(json.dumps({"flash_arms": rows, "shape": SHAPE,
                      "gpu": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
