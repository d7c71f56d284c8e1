"""Design arms of the quantized ring kernels (B6, B8) on the card:
``python -m uccl_tpu_torch.ring_q_arms``.

Builds copies of ``csrc/ring_ccl.cu`` that differ from the source in one
choice, with :func:`~uccl_tpu_torch.utils.build.build_variant` (one ``nvcc``
each, started together); an arm is one list of ``(old, new)`` text
substitutions in ``ARMS``: a third term loaded ahead, and the terms loaded
with B5's L2 evict-first hint instead of the plain non-coherent path. It
times B6 and B8 (fp8, two streams) of each copy beside the source's own
build on the gradient bucket (W = 4, 320,906,240 f32 per member) and on
bf16 rows 8 bytes off 16 (B8's terms and outputs in 4-byte units, B6's
slots in single elements), in turns (source, arm, arm, source) so that
drift on the card shows, after holding each build's results to their
contracts (``rs_q_chain_plain``, ``ar_q_chain_plain``) bit for bit. Reports
each arm's spill bytes too (a spilling arm is one ``chip_smoke.py`` would
refuse). Prints one JSON line. Needs a GPU.

JAX counterpart: none (the TPU kernels' schedule was fixed by the ring).
"""

from __future__ import annotations

import argparse
import ctypes
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from uccl_tpu_torch import resolve_device
from uccl_tpu_torch.collective import ring_ccl as rc
from uccl_tpu_torch.flash_arms import time_ms
from uccl_tpu_torch.utils import build

_HINTED_LOADS = '''__device__ __forceinline__ unsigned ld_hint_u32(const void* p) {
  unsigned v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::cache_hint.u32 %0, [%1], %2;"
               : "=r"(v) : "l"(p), "l"(l2_evict_first()));
  return v;
}

__device__ __forceinline__ unsigned short ld_hint_u16(const void* p) {
  unsigned short v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::cache_hint.u16 %0, [%1], %2;"
               : "=h"(v) : "l"(p), "l"(l2_evict_first()));
  return v;
}

'''
ARMS = {
    "ahead 3": [("  constexpr int kAhead = 2;", "  constexpr int kAhead = 3;")],
    "L2 evict-first loads": [
        ("// Element i of the lane at ``l`` (0..15) in its half warp",
         _HINTED_LOADS + "// Element i of the lane at ``l`` (0..15) in its half warp"),
        ("__ldg(reinterpret_cast<const int4*>(p))",
         "ld_once(reinterpret_cast<const int4*>(p), l2_evict_first())"),
        ("__ldg(reinterpret_cast<const unsigned*>(p))", "ld_hint_u32(p)"),
        ("__ldg(reinterpret_cast<const unsigned short*>(p))", "ld_hint_u16(p)"),
        ("__ldg(reinterpret_cast<const unsigned*>(row) + x)",
         "ld_hint_u32(reinterpret_cast<const unsigned*>(row) + x)"),
        ("__ldg(reinterpret_cast<const unsigned short*>(row) + x)",
         "ld_hint_u16(reinterpret_cast<const unsigned short*>(row) + x)"),
    ],
}
WORLD, BUCKET = 4, 320_906_240


def quant_spill_bytes(log: str) -> int:
    """Spill stores of B6 and B8 in nvcc's -Xptxas -v report."""
    total, quant = 0, False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            quant = "ring_rsq_kernel" in line or "ring_arq_kernel" in line
        elif "spill stores" in line and quant:
            total += int(line.split("bytes spill stores")[0].split(",")[-1])
    return total


def _use(lib_path: str) -> None:
    """Route ring_ccl's launches through the library at ``lib_path``."""
    lib = rc.declare(ctypes.CDLL(lib_path))
    rc._lib = lambda: lib


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m uccl_tpu_torch.ring_q_arms")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    with ThreadPoolExecutor(len(ARMS) + 1) as pool:
        jobs = {name: pool.submit(build.build_variant, "ring_ccl", name.replace(" ", "_"), subs)
                for name, subs in ARMS.items()}
        libs = {"source": str(pool.submit(build.build, "ring_ccl").result()),
                **{name: str(j.result()) for name, j in jobs.items()}}
    spills = {name: quant_spill_bytes((Path(path).parent / "nvcc.log").read_text())
              for name, path in libs.items() if name != "source"}
    spills["source"] = quant_spill_bytes(build.build_log("ring_ccl"))
    g = torch.Generator(device=dev).manual_seed(5)
    p16 = 2 * BUCKET - WORLD  # rows 4 mod 8 elements: alternately 0 and 8 bytes off 16
    cases = {"f32 bucket": torch.randn((WORLD, BUCKET), generator=g, device=dev),
             "bf16 rows off 16": torch.randn((WORLD, p16), generator=g, device=dev,
                                             dtype=torch.bfloat16)}
    runs = {}
    for case, x in cases.items():
        rs_out, ar_out = x.new_empty((WORLD, x.shape[1] // WORLD)), torch.empty_like(x)
        want = (rc.rs_q_chain_plain(x, 1, "fp8"), rc.ar_q_chain_plain(x, (1, -1), "fp8"))
        runs[case] = (x, rs_out, ar_out, want)
    rows = []
    for name in ARMS:
        times = {case: {"B6_ms": [], "B8_ms": []} for case in cases}
        for which in ("source", name, name, "source"):
            _use(libs[which])
            for case, (x, rs_out, ar_out, want) in runs.items():
                lanes = [rc.launch_rs(x, rs_out, 1, 0, "fp8"),
                         rc.launch_ar(x, ar_out, (1, -1), 0, "fp8")]
                for lane in lanes:
                    lane.check("ring_q_arms")
                for got, plain in zip((rs_out, ar_out), want):
                    if not bool(((got == plain) | (got.isnan() & plain.isnan())).all()):
                        raise RuntimeError(f"{which} on {case} differs from its contract")
                times[case]["B6_ms"].append(time_ms(
                    lambda: lanes.append(rc.launch_rs(x, rs_out, 1, 0, "fp8")), args.reps, dev))
                times[case]["B8_ms"].append(time_ms(
                    lambda: lanes.append(rc.launch_ar(x, ar_out, (1, -1), 0, "fp8")), args.reps,
                    dev))
                for lane in lanes:
                    lane.check("ring_q_arms")
        rows.append({"arm": name, "order": "source, arm, arm, source", **times,
                     "spill_bytes": spills[name], "source_spill_bytes": spills["source"]})
    print(json.dumps({"ring_q_arms": rows, "W": WORLD, "bucket_elems_per_member": BUCKET,
                      "gpu": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
