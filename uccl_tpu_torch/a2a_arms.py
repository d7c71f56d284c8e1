"""Design arms of the EP all-to-all kernel (B9) on the card:
``python -m uccl_tpu_torch.a2a_arms``.

Builds copies of ``csrc/ep_a2a.cu`` that differ from the source in one
choice, with :func:`~uccl_tpu_torch.utils.build.build_variant` (one ``nvcc``
each, started together); an arm is one list of ``(old, new)`` text
substitutions in ``ARMS``:

* ``two-stream schedule``: the kernel this one replaced, for the record:
  channels sized by one member's chunk slot, a full-peer entry barrier, the
  W-1 sends one after another on two counter-rotating streams with a fence
  after each, and a wait for all W-1 arrivals in every block;
* ``full-peer entry``: the pair grid, but each block waits for every
  member's ready word, as the old entry barrier did, instead of its
  receiver's alone;
* ``loads before ready``: the receiver's ready word awaited after the
  block's first loads, so the two overlap;
* ``fence before release``: a ``__threadfence`` between the block barrier
  and the arrival word's release, as the ring kernels' ``signal`` has;
* ``256 threads``: half the block and half the least piece (the first
  design of this kernel: twice the blocks);
* ``streaming stores``: ``st.global.cs`` (evict first) for the copies;
* ``bulk copy``: each piece through shared memory with the bulk copy engine
  (``cp.async.bulk``, four 8 KiB stages in flight, one thread issuing)
  instead of the threads' 16-byte loads and stores;
* ``no ready wait``, ``no exit wait``: one of the two waits left out;
  ``no flags`` / ``no flags, ordinary launch``: the grid's floor, the
  copies alone (no ready, arrival or exit word), with the cooperative
  launch and with ``<<<>>>``. These four are wrong across cards and say
  where the flags' time goes.

It times B9 of each copy beside the source's own build, in turns (source,
arm, arm, source) so that drift on the card shows, at the serving drives'
f32 exchanges (decode, verify, chunk prefill) and the EP cell's bf16
dispatch buffer, after holding each build's result to ``a2a_plain`` and the
transpose bit for bit; beside each, the bound (each byte read once and
written once at 3.35 TB/s) and ``x.transpose(0, 1).contiguous()``. Prints
one JSON line. Needs a GPU. No serving or EP path loads a variant.

JAX counterpart: none (the TPU kernel's schedule was fixed by its DMA
semaphores).
"""

from __future__ import annotations

import argparse
import ctypes
import json
from concurrent.futures import ThreadPoolExecutor

import torch

from uccl_tpu_torch import resolve_device
from uccl_tpu_torch.collective import dma
from uccl_tpu_torch.ep import pallas_a2a as pa
from uccl_tpu_torch.flash_arms import time_ms
from uccl_tpu_torch.utils import build

_RING_KERNEL = '''// The two-stream kernel: member r sends its chunk ``dst`` into member dst's
// slot r, then raises its arrival word there.
__device__ __forceinline__ void send(const A2AArgs& a, int r, int c, int dst, Range rg) {
  copy16(a.out[dst] + (long long)r * a.slot_bytes, a.x[r] + (long long)dst * a.slot_bytes, rg);
  signal(flag(a, dst, c, r), mark(a));
}

__global__ void __launch_bounds__(kThreads) a2a_ring_kernel(A2AArgs a) {
  const int n = a.n, r = blockIdx.y, c = blockIdx.x;
  const Range rg = channel_range(a, c);
  if (!entry_barrier(a, r, c)) return;
  copy16(a.out[r] + (long long)r * a.slot_bytes, a.x[r] + (long long)r * a.slot_bytes, rg);
  const int s_fwd = n / 2, s_bwd = (n - 1) / 2;
  for (int s = 1; s <= s_fwd; ++s) {
    send(a, r, c, (r + s) % n, rg);
    if (s <= s_bwd) send(a, r, c, (r - s + n) % n, rg);
  }
  wait_peers(a, r, c, s_fwd, kWaitRecv, -1);
}

'''

_BULK_COPY = '''constexpr int kBulkStages = 4;
constexpr int kBulkBytes = 8192;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Thread 0: vectors [lo, hi) of ``src`` into ``dst`` through shared memory
// with the bulk copy engine, kBulkStages segments of kBulkBytes in flight;
// a stage is refilled once the store of its last segment has read it. A
// wait past 2 s traps.
__device__ void bulk_piece(char* dst, const char* src, long long lo, long long hi) {
  __shared__ __align__(128) char buf[kBulkStages][kBulkBytes];
  __shared__ __align__(8) unsigned long long bar[kBulkStages];
  if (threadIdx.x != 0) return;
  const long long bytes = (hi - lo) * 16, nseg = (bytes + kBulkBytes - 1) / kBulkBytes;
  dst += lo * 16;
  src += lo * 16;
  for (int k = 0; k < kBulkStages; ++k)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&bar[k])) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  auto seg = [&](long long g) -> uint32_t {
    const long long left = bytes - g * kBulkBytes;
    return (uint32_t)(left < kBulkBytes ? left : kBulkBytes);
  };
  auto load = [&](long long g) {
    const int st = (int)(g % kBulkStages);
    const uint32_t b = smem_u32(&bar[st]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(seg(g))
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_u32(buf[st])), "l"(reinterpret_cast<uint64_t>(src + g * kBulkBytes)),
        "r"(seg(g)), "r"(b) : "memory");
  };
  for (long long g = 0; g < nseg && g < kBulkStages; ++g) load(g);
  for (long long g = 0; g < nseg; ++g) {
    const int st = (int)(g % kBulkStages);
    const uint32_t b = smem_u32(&bar[st]), parity = (uint32_t)((g / kBulkStages) & 1);
    const unsigned long long t0 = globaltimer();
    for (;;) {
      uint32_t done;
      asm volatile(
          "{\\n .reg .pred p;\\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\\n"
          " selp.u32 %0, 1, 0, p;\\n}\\n" : "=r"(done) : "r"(b), "r"(parity) : "memory");
      if (done) break;
      if (globaltimer() - t0 > 2000000000ull) __trap();
    }
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 ::"l"(reinterpret_cast<uint64_t>(dst + g * kBulkBytes)),
                 "r"(smem_u32(buf[st])), "r"(seg(g)) : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    if (g >= 1 && g - 1 + kBulkStages < nseg) {
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      load(g - 1 + kBulkStages);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

'''

_GATED_COPY = '''// copy_piece with ``open`` (a wait of the whole block) run once, after
// the first loads and before the first store; false when it fails.
template <typename Open>
__device__ __forceinline__ bool copy_piece_gated(char* dst, const char* src, long long lo,
                                                 long long hi, Open open) {
  int4* d = reinterpret_cast<int4*>(dst);
  const int4* s = reinterpret_cast<const int4*>(src);
  for (long long base = lo; base < hi; base += kInFlight * kPairThreads) {
    const long long i = base + threadIdx.x;
    int4 v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (i + u * kPairThreads < hi) v[u] = __ldcg(s + i + u * kPairThreads);
    if (base == lo && !open()) return false;
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (i + u * kPairThreads < hi) __stcg(d + i + u * kPairThreads, v[u]);
  }
  return true;
}

'''

_KERNEL = "__global__ void __launch_bounds__(kPairThreads) a2a_kernel(A2AArgs a) {"
_WAIT = "    if (d != s && !wait_peers(a, s, x, off, kWaitEntry, d)) return;  // d is ready\n"
_COPY = ("    copy_piece(a.out[d] + (long long)s * a.slot_bytes, a.x[s] + (long long)d * "
         "a.slot_bytes,\n               vecs * p / P, vecs * (p + 1) / P);\n")
_LAUNCH = ("  return coop_launch(a2a_kernel, dim3((unsigned)g.X, (unsigned)live), kPairThreads, a, "
           "stream);")
_NO_FLAGS = [
    ("  if (threadIdx.x == 0) st_release(flag(a, s, x, kEntry), mark(a));  // ready", ""),
    (_WAIT, ""),
    ("    if (d != s && !(p == 0 && s * n + d == a.drop)) announce(flag(a, d, p, s), mark(a));",
     ""),
    ("  if (x < P) wait_peers(a, s, x, x, kWaitRecv, -1);  // piece x's arrivals", ""),
]
_ORDINARY_LAUNCH = [(_LAUNCH, "  a2a_kernel<<<dim3((unsigned)g.X, (unsigned)live), kPairThreads, "
                              "0, (cudaStream_t)stream>>>(a);\n  return (int)cudaGetLastError();")]
ARMS = {
    "two-stream schedule": [
        ("// B9's grid for a world of n, chunk slots", _RING_KERNEL
         + "// B9's grid for a world of n, chunk slots"),
        ("return kernel == kA2A ? launch_pairs(a, live, stream)",
         "return kernel == kA2A ? launch(a2a_ring_kernel, a, live, stream)"),
    ],
    "full-peer entry": [(_WAIT, "    if (!wait_peers(a, s, x, off, kWaitEntry, -1)) return;\n")],
    "loads before ready": [
        (_KERNEL, _GATED_COPY + _KERNEL),
        (_WAIT + _COPY,
         "    const auto ready = [&] { return d == s || wait_peers(a, s, x, off, kWaitEntry, d); "
         "};\n    if (!copy_piece_gated(a.out[d] + (long long)s * a.slot_bytes, a.x[s] + "
         "(long long)d * a.slot_bytes,\n                          vecs * p / P, vecs * (p + 1) / "
         "P, ready))\n      return;\n")],
    "loads before ready, 64 registers": [
        (_KERNEL, _GATED_COPY + "__global__ void __launch_bounds__(kPairThreads, 2) "
         "a2a_kernel(A2AArgs a) {"),
        (_WAIT + _COPY,
         "    const auto ready = [&] { return d == s || wait_peers(a, s, x, off, kWaitEntry, d); "
         "};\n    if (!copy_piece_gated(a.out[d] + (long long)s * a.slot_bytes, a.x[s] + "
         "(long long)d * a.slot_bytes,\n                          vecs * p / P, vecs * (p + 1) / "
         "P, ready))\n      return;\n")],
    "fence before release": [
        ("    if (d != s && !(p == 0 && s * n + d == a.drop)) announce(",
         "    if (d != s && !(p == 0 && s * n + d == a.drop)) signal(")],
    "256 threads": [
        ("constexpr int kPairThreads = 512;", "constexpr int kPairThreads = 256;"),
        ("constexpr long long kPieceVecs = 512;", "constexpr long long kPieceVecs = 256;")],
    "streaming stores": [("      if (i + u * kPairThreads < hi) __stcg(",
                          "      if (i + u * kPairThreads < hi) __stcs(")],
    "bulk copy": [
        (_KERNEL, _BULK_COPY + _KERNEL),
        ("    copy_piece(a.out[d]", "    bulk_piece(a.out[d]"),
    ],
    # where the flags' time goes: without the ready wait, without the exit
    # wait, and the floor of this grid with no flags at all, with the
    # cooperative launch and with an ordinary one (all wrong across cards)
    "no ready wait": [(_WAIT, "")],
    "no exit wait": [_NO_FLAGS[-1]],
    "no flags": _NO_FLAGS,
    "no flags, ordinary launch": _NO_FLAGS + _ORDINARY_LAUNCH,
}
# The serving drives' f32 exchanges and the EP cell's dispatch buffer,
# member-stacked [W, W, ...] (chip_smoke.py's SERVE_A2A_SHAPES and ep_path).
SHAPES = {
    "decode": ((4, 4, 4, 1024), torch.float32),
    "verify": ((4, 4, 2, 6, 1024), torch.float32),
    "chunk prefill": ((4, 4, 2, 128, 1024), torch.float32),
    "EP cell": ((4, 4, 2, 2560, 1024), torch.bfloat16),
}
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


def _use(lib_path: str) -> None:
    """Route pallas_a2a's launches through the library at ``lib_path``."""
    lib = pa.declare(ctypes.CDLL(lib_path))
    pa._lib = lambda: lib


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m uccl_tpu_torch.a2a_arms")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--arms", nargs="*", default=list(ARMS), choices=list(ARMS))
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    real_lib = pa._lib
    with ThreadPoolExecutor(len(args.arms) + 1) as pool:
        jobs = {name: pool.submit(build.build_variant, "ep_a2a",
                                  name.replace(" ", "_").replace("(", "").replace(")", ""),
                                  ARMS[name]) for name in args.arms}
        libs = {"source": str(pool.submit(build.build, "ep_a2a").result()),
                **{name: str(j.result()) for name, j in jobs.items()}}
    g = torch.Generator(device=dev).manual_seed(7)
    cases = {}
    for case, (shape, dtype) in SHAPES.items():
        x = torch.randn(shape, generator=g, device=dev).to(dtype)
        view, _, _ = pa._view(x)
        cases[case] = (x, view, torch.empty_like(view), pa.a2a_plain(view),
                       2 * x.numel() * x.element_size() / PEAK_BYTES * 1e3)
    lanes = []

    def b9(view, out):
        lanes.append(pa.launch_a2a(view, out, dma.CID_A2A))

    rows = []
    try:
        for name in args.arms:
            times = {case: {"source_ms": [], "arm_ms": [], "library_ms": []} for case in cases}
            grids = {}
            for which in ("source", name, name, "source"):
                _use(libs[which])
                for case, (x, view, out, plain, _) in cases.items():
                    out.zero_()
                    pa.launch_a2a(view, out, dma.CID_A2A).check("a2a_arms")
                    if not (torch.equal(out, plain)
                            and torch.equal(out, view.transpose(0, 1).contiguous())):
                        raise RuntimeError(f"{which} on {case} differs from a2a_plain")
                    key = "source_ms" if which == "source" else "arm_ms"
                    times[case][key].append(time_ms(lambda: b9(view, out), args.reps, dev))
                    times[case]["library_ms"].append(
                        time_ms(lambda: x.transpose(0, 1).contiguous(), args.reps, dev))
                    grids[(which, case)] = pa.kernel_grid(x.shape[0], view[0, 0].numel()
                                                          * view.element_size())
                    for lane in lanes:
                        lane.check("a2a_arms")
                    lanes.clear()
            rows.append({"arm": name, "order": "source, arm, arm, source",
                         "cases": {case: {**t, "bound_ms": cases[case][4],
                                          "grid_P_X_blocks": {"source": grids[("source", case)],
                                                              "arm": grids[(name, case)]}}
                                   for case, t in times.items()}})
    finally:
        pa._lib = real_lib
    print(json.dumps({"a2a_arms": rows, "shapes": {c: [list(s), str(d)]
                                                   for c, (s, d) in SHAPES.items()},
                      "gpu": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
