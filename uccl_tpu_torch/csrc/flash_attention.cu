// Flash attention for Hopper (sm_90a): forward, dQ backward and dK/dV backward.
//
// These three kernels replace the Pallas TPU kernels of
// uccl_tpu/ops/pallas_attention.py: _fwd_kernel (B1), _bwd_dq_kernel (B2) and
// _bwd_dkv_kernel (B3). They compute the same functions; the block structure
// is Hopper's own. Each comes twice: for bf16 q/k/v on wgmma (most of this
// file), and for f32 q/k/v (the sections "B1-B3 in float32", "B2 and B3 in
// float32: 3xTF32" and "B1 in float32: 3xTF32" near the end: on the tensor
// cores as three TF32 products per f32 product; the Pallas kernels take
// either dtype).
//
// Layout. q/out/dout/dq are [B, Sq, H, D] and k/v/dk/dv are [B, Sk, Hkv, D],
// contiguous bf16 (or f32), read in place: a D = 64 bf16 row is 128 contiguous bytes,
// so the TPU wrapper's [B*H, S, D] transposes are not needed. lse and delta
// are [B, H, Sq] f32. Query head h reads KV head h / (H / Hkv) (GQA).
//
// What bounds them on the H100. At the flagship's shapes (S = 1024, D = 64,
// causal) each kernel does 2-4 S x S x D matrix products per (batch, head)
// and moves only the O(S * D) tensors, so all three are bound by tensor-core
// operations, not by bytes (see chip_smoke.py for the bound it computes).
// All three run on wgmma, fed by a multi-stage ring of TMA loads that a
// producer warp keeps ahead of the consumer warpgroups. The notes before
// each kernel say how.
//
// The pipeline-wait rule. Every wait of these kernels is on an mbarrier of
// its own CTA: a stage's data arriving, or a stage being released. Such a
// wait can stall only on a fault of the kernel itself (a wrong byte count,
// a missed arrival); no other member, process or card is involved. So each
// wait is bounded by one constant for all three kernels (kWaitNs, 2 s) and
// then traps: the launch ends with an error and the process's CUDA context
// with it, instead of the card hanging. The ring kernels of ring_ccl.cu and
// ep_a2a.cu wait on other members, which may be missing as an operating
// condition; those waits write an error word that the wrapper raises on,
// and the process lives on.
//
// Semantics kept from the Pallas kernels: the finite mask value -1e30 and the
// row-sum floor 1e-20 (so no row becomes NaN), causal masking with aligned
// positions (q position >= k position), scale 1 / sqrt(D), f32 lse, dq in
// q's type and dk/dv in k's type.
//
// Each C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 on success). The tensor maps are encoded on
// the host per call and passed by value.

#include <cuda.h>  // CUtensorMap and its enums; the driver call itself is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // pallas_attention.py _NEG_INF

// ---------------------------------------------------------------------------
// Small device helpers

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// Hopper primitives: mbarriers, TMA, wgmma

constexpr int kChunkBytes = 64 * 128;  // one [64 rows][64 bf16] swizzled chunk
constexpr int kStages = 4;             // streamed tiles in flight in each kernel's ring
constexpr unsigned long long kWaitNs = 2000000000ull;  // a pipeline wait past 2 s traps

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// One arrival that also tells the barrier to expect ``bytes`` of TMA data.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the barrier's phase of parity ``parity`` has completed. A wait
// past kWaitNs traps (the pipeline-wait rule in the note at the top).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = globaltimer();
  while (!mbar_try_wait(bar, parity))
    if (globaltimer() - t0 > kWaitNs) __trap();
}

// TMA: the box at coordinates (c0, c1, c2, c3) of ``map`` into shared
// memory at ``dst``, completing on ``bar``. Rows past the tensor's end
// arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets, layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of an accumulator or an A fragment
// across the asynchronous wgmma that reads it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D[64x64] (+)= A[64x16] B[16x64], bf16 in, f32 accumulate; A and B in
// shared memory, both K-major. ``accumulate`` 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64x64] += A[64x16] B[16x64]: A from registers (the m16n8k16 A layout
// per warp, warp w holding rows 16w..16w+15), B in shared memory MN-major
// (the transpose bit: N runs along the 128-byte rows).
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---------------------------------------------------------------------------
// The steps of one consumer warpgroup on one 64-row tile: B1's, and B2 and
// B3 reuse issue_qk, issue_pv, to_a_operand and release

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T of one 64 x 64 tile into sc, issued and committed, not waited
// for: D / 16 steps of 16 along D, each 32 bytes further into the 128-byte
// swizzled rows (the next 64 columns are the next chunk).
template <int NC>
__device__ __forceinline__ void issue_qk(float (&sc)[32], uint32_t q_tile, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < NC * 4; ++kk) {
    const uint32_t off = (kk / 4) * kChunkBytes + (kk % 4) * 32;
    wgmma_ss(sc, sw128_desc(q_tile + off, 16, 1024), sw128_desc(k_tile + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// O += P V of one tile, issued and committed: 4 steps of 16 KV rows (2048
// bytes each) for every 64 columns of D.
template <int NC>
__device__ __forceinline__ void issue_pv(float (&acc)[NC][32], const uint32_t (&pa)[4][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      wgmma_rs_t(acc[c], pa[kc], sw128_desc(v_tile + c * kChunkBytes + kc * 2048, 1024, 1024));
  wgmma_commit();
}

template <int NC>
__device__ __forceinline__ void fence_all(float (&acc)[NC][32], uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) reg_fence(acc[c]);
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) reg_fence(pa[kc]);
}

template <int N>
constexpr int kLog2 = N <= 1 ? 0 : 1 + kLog2<N / 2>;

// The online softmax of one S tile, in log2 units. sc holds this lane's
// raw scores: register i is row ``(i >> 1) & 1`` (0: row0, 1: row0 + 8) of
// the warp's 16, column 8 (i / 4) + 2 t + (i & 1) of the tile. kMask (the
// causal diagonal tile) masks each column past its row, ``diag`` being this
// lane's first row less the tile's first column. On return sc holds P,
// (m, l) are updated and (c0, c1) are the factors by which the rows'
// running outputs must be rescaled. Maxima and sums reduce as trees.
template <bool kMask>
__device__ __forceinline__ void tile_softmax(float (&sc)[32], float& m0, float& m1, float& l0,
                                             float& l1, float& c0, float& c1, float scale_log2,
                                             int diag, int t) {
  constexpr int N = 32, G = 8;  // registers, 8-column groups
  if (kMask) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if ((i / 4) * 8 + 2 * t + (i & 1) > diag + 8 * ((i >> 1) & 1)) sc[i] = kNegInf;
  }
  float r[2][G];
#pragma unroll
  for (int n = 0; n < G; ++n) {
    r[0][n] = fmaxf(sc[4 * n], sc[4 * n + 1]);
    r[1][n] = fmaxf(sc[4 * n + 2], sc[4 * n + 3]);
  }
#pragma unroll
  for (int k = 0; k < kLog2<G>; ++k)  // a linear trip count, so it unrolls
#pragma unroll
    for (int n = 0; n < G; n += 2 << k) {
      r[0][n] = fmaxf(r[0][n], r[0][n + (1 << k)]);
      r[1][n] = fmaxf(r[1][n], r[1][n + (1 << k)]);
    }
  const float mx0 = fmaxf(m0, quad_max(r[0][0]) * scale_log2);
  const float mx1 = fmaxf(m1, quad_max(r[1][0]) * scale_log2);
  c0 = ex2(m0 - mx0);
  c1 = ex2(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
#pragma unroll
  for (int i = 0; i < N; ++i) sc[i] = ex2(fmaf(sc[i], scale_log2, -((i >> 1) & 1 ? m1 : m0)));
#pragma unroll
  for (int n = 0; n < G; ++n) {
    r[0][n] = sc[4 * n] + sc[4 * n + 1];
    r[1][n] = sc[4 * n + 2] + sc[4 * n + 3];
  }
#pragma unroll
  for (int k = 0; k < kLog2<G>; ++k)
#pragma unroll
    for (int n = 0; n < G; n += 2 << k) {
      r[0][n] += r[0][n + (1 << k)];
      r[1][n] += r[1][n + (1 << k)];
    }
  l0 = l0 * c0 + r[0][0];
  l1 = l1 * c1 + r[1][0];
}

// P as the A operand of O += P V, rounded to bf16: k step kc covers the
// tile's columns 16 kc .. 16 kc + 15.
__device__ __forceinline__ void to_a_operand(uint32_t (&pa)[4][4], const float (&sc)[32]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    pa[kc][0] = pack_bf16(sc[8 * kc + 0], sc[8 * kc + 1]);
    pa[kc][1] = pack_bf16(sc[8 * kc + 2], sc[8 * kc + 3]);
    pa[kc][2] = pack_bf16(sc[8 * kc + 4], sc[8 * kc + 5]);
    pa[kc][3] = pack_bf16(sc[8 * kc + 6], sc[8 * kc + 7]);
  }
}

// This warp is done with a buffer: one arrival on its "empty" barrier.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// ---------------------------------------------------------------------------
// B1. Forward. Replaces pallas_attention.py::_fwd_kernel (redesigned for
// Hopper in PR 5).
//
// What bounds it: tensor-core operations (2 S x S x D products per head, the
// causal half of them), then the softmax's exponentials, which at D = 64
// cost about as many SM cycles as the products. PR 1's version ran
// mma.sync from 4 warps that loaded each K/V tile through registers between
// two __syncthreads, so the tensor cores idled during every load and never
// reached the wgmma rate; it ran at 0.16 of its bound.
//
// What still holds this design back at D = 64 is the number of warpgroups
// an SM keeps in flight (three CTAs of one warpgroup each, by registers)
// against the latency of each warpgroup's chain of waits, and the K/V tiles
// every 64-row q tile streams again from L2. Measured on the card and
// dropped, as slower: 128-row KV tiles, Q held in registers, 2-4 query
// heads of one KV head per CTA, clusters sharing K/V tiles by TMA
// multicast, a persistent grid, and setmaxnreg to fit two 128-row CTAs per
// SM (PERF.md, PR 5).
//
// This design: one CTA per (batch*head, q tile of BQ rows) with BQ / 64
// consumer warpgroups, each owning 64 q rows, and one producer warp. The
// producer streams K and V tiles of 64 rows through a ring of kStages
// stages in shared memory with TMA (4-d tensor maps over the strided
// [B, S, heads, D] layouts, 128-byte swizzle, 64 x 64 boxes), completing on
// one "full" mbarrier per stage, and refills a stage once every consumer
// warp has arrived on its "empty" mbarrier; Q arrives once, the same way.
// Each warpgroup computes S = Q K^T with wgmma m64n64k16 (Q and K from
// shared memory, K-major), the online softmax in registers (exp2 with the
// scale folded into log2 e, the mask applied on the diagonal tile only), and
// O += P V with P from registers and V from shared memory through the B
// operand's transpose bit. The two products overlap the softmax: S of tile
// j is issued together with O += P V of tile j - 1, and the softmax of j
// runs while the latter is in flight. The loop over KV tiles takes the place
// of the TPU's sequential jk grid axis; causal warpgroups stop at their
// diagonal tile, and heavier q tiles are scheduled first.

// One consumer warpgroup of B1: rows wg_first .. wg_first + 63 of (b, h),
// over the CTA's n_iter K/V tiles.
template <int D>
__device__ __forceinline__ void flash_fwd_consumer(uint32_t q_tile, uint32_t bar_q, uint32_t sK,
                                                   uint32_t sV, uint32_t bar_full,
                                                   uint32_t bar_empty, bf16* __restrict__ o,
                                                   float* __restrict__ lse, int b, int h,
                                                   int wg_first, int n_iter, int Sq, int H,
                                                   float scale_log2, int causal, int warp,
                                                   int lane) {
  constexpr int NC = D / 64;
  const int g = lane >> 2, t = lane & 3;
  // a warpgroup may end one tile before the CTA (the upper half of a
  // causal 128-row q tile); that tile's stage is never refilled
  const int wg_iter = causal ? min(n_iter, wg_first / 64 + 1) : n_iter;
  const int row0 = wg_first + (warp & 3) * 16 + g;  // this lane's rows: row0, row0 + 8
  auto stage = [](int j) { return j % kStages; };
  auto wait_tile = [&](int j) { mbar_wait(bar_full + 8 * stage(j), (j / kStages) & 1); };

  float acc[NC][32], sc[32];
  uint32_t pa[4][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f, c0, c1;
  mbar_wait(bar_q, 0);

  // Software pipeline within the warpgroup: S of tile j is issued together
  // with O += P V of tile j - 1, and the softmax of j runs while the latter
  // is in flight.
  wait_tile(0);
  wgmma_fence();
  issue_qk<NC>(sc, q_tile, sK + stage(0) * NC * kChunkBytes);
  wgmma_wait<0>();
  reg_fence(sc);
  if (causal && 63 > wg_first)
    tile_softmax<true>(sc, m0, m1, l0, l1, c0, c1, scale_log2, row0, t);
  else
    tile_softmax<false>(sc, m0, m1, l0, l1, c0, c1, scale_log2, 0, t);
  to_a_operand(pa, sc);
  for (int j = 1; j < wg_iter; ++j) {
    wait_tile(j);
    fence_all<NC>(acc, pa);
    wgmma_fence();
    issue_qk<NC>(sc, q_tile, sK + stage(j) * NC * kChunkBytes);
    issue_pv<NC>(acc, pa, sV + stage(j - 1) * NC * kChunkBytes);
    wgmma_wait<1>();  // S of tile j is in; O += P V of tile j - 1 may still run
    reg_fence(sc);
    if (causal && j * 64 + 63 > wg_first)
      tile_softmax<true>(sc, m0, m1, l0, l1, c0, c1, scale_log2, row0 - j * 64, t);
    else
      tile_softmax<false>(sc, m0, m1, l0, l1, c0, c1, scale_log2, 0, t);
    wgmma_wait<0>();
    fence_all<NC>(acc, pa);
    release(bar_empty + 8 * stage(j - 1), lane);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] *= ((i >> 1) & 1) ? c1 : c0;
    to_a_operand(pa, sc);
  }
  fence_all<NC>(acc, pa);
  wgmma_fence();
  issue_pv<NC>(acc, pa, sV + stage(wg_iter - 1) * NC * kChunkBytes);
  wgmma_wait<0>();
  fence_all<NC>(acc, pa);
  release(bar_empty + 8 * stage(wg_iter - 1), lane);

  l0 = fmaxf(quad_sum(l0), 1e-20f);
  l1 = fmaxf(quad_sum(l1), 1e-20f);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const long long q_pitch = (long long)H * D;
  bf16* o0 = o + ((long long)b * Sq + row0) * q_pitch + (long long)h * D + 2 * t;
  bf16* o1 = o0 + 8 * q_pitch;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float* a = &acc[c][4 * n];
      *reinterpret_cast<uint32_t*>(o0 + c * 64 + n * 8) = pack_bf16(a[0] * inv0, a[1] * inv0);
      *reinterpret_cast<uint32_t*>(o1 + c * 64 + n * 8) = pack_bf16(a[2] * inv1, a[3] * inv1);
    }
  if (t == 0) {
    float* lr = lse + ((long long)b * H + h) * Sq;
    constexpr float kLn2 = 0.69314718055994531f;
    lr[row0] = (m0 + log2f(l0)) * kLn2;
    lr[row0 + 8] = (m1 + log2f(l1)) * kLn2;
  }
}

template <int D, int BQ>
__global__ void __launch_bounds__(BQ * 2 + 32)
    flash_fwd_kernel(__grid_constant__ const CUtensorMap tq,
                     __grid_constant__ const CUtensorMap tk,
                     __grid_constant__ const CUtensorMap tv, bf16* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int H, int Hkv, float scale_log2,
                     int causal) {
  constexpr int NC = D / 64;    // 128-byte chunks across a row of D
  constexpr int NWG = BQ / 64;  // consumer warpgroups
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];  // Q, full[], empty[]
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;  // [NWG][NC] chunks
  const uint32_t sK = sQ + NWG * NC * kChunkBytes;           // [kStages][NC] chunks
  const uint32_t sV = sK + kStages * NC * kChunkBytes;       // [kStages][NC] chunks
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]), bar_empty = smem_u32(&bars[1 + kStages]);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hkv);
  const int q_first = (gridDim.y - 1 - blockIdx.y) * BQ;  // heavier q tiles first
  const int n_kv = Sk / 64;
  const int n_iter = causal ? min(n_kv, (q_first + BQ - 1) / 64 + 1) : n_kv;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NWG * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == NWG * 4) {  // the producer warp: one lane issues every copy
    if (lane != 0) return;
    mbar_expect_tx(bar_q, BQ * D * 2);
    for (int wg = 0; wg < NWG; ++wg)
      for (int c = 0; c < NC; ++c)
        tma_load(sQ + (wg * NC + c) * kChunkBytes, &tq, bar_q, c * 64, h, q_first + wg * 64, b);
    for (int j = 0; j < n_iter; ++j) {
      const int s = j % kStages;
      if (j >= kStages) mbar_wait(bar_empty + 8 * s, (j / kStages - 1) & 1);
      mbar_expect_tx(bar_full + 8 * s, 2 * 64 * D * 2);
      for (int c = 0; c < NC; ++c) {
        tma_load(sK + (s * NC + c) * kChunkBytes, &tk, bar_full + 8 * s, c * 64, hk, j * 64, b);
        tma_load(sV + (s * NC + c) * kChunkBytes, &tv, bar_full + 8 * s, c * 64, hk, j * 64, b);
      }
    }
    return;
  }
  const int wg = warp >> 2;
  flash_fwd_consumer<D>(sQ + wg * NC * kChunkBytes, bar_q, sK, sV, bar_full, bar_empty, o, lse,
                        b, h, q_first + wg * 64, n_iter, Sq, H, scale_log2, causal, warp, lane);
}

// ---------------------------------------------------------------------------
// B2 and B3. The backward.
//
// What bounds them: tensor-core operations (3 and 4 S x S x D products per
// head, the causal half of them), then one exponential per score, as B1.
// Their first versions ran mma.sync from 4 warps that loaded every streamed
// tile through registers between two __syncthreads, so the tensor cores
// idled during each load; they ran at 0.18 and 0.17 of their bounds.
//
// This design is B1's: a producer warp streams 64-row tiles with TMA
// through a ring of kStages stages (full/empty mbarriers), and each
// consumer warpgroup owns 64 rows of the CTA's tile and runs every product
// on wgmma m64n64k16. Every product of the backward takes one of B1's two
// forms, so one 128-byte-swizzled copy of each tile serves both of its
// products:
//
//   B2  S = Q K^T, dP = dO V^T    wgmma_ss   (issue_qk)
//       dQ += dS K                wgmma_rs_t (issue_pv; K through the transpose bit)
//   B3  S^T = K Q^T, dP^T = V dO^T  wgmma_ss
//       dV += P^T dO, dK += dS^T Q  wgmma_rs_t (dO and Q through the transpose bit)
//
// P = exp2(S * scale * log2 e - lse * log2 e) from the saved lse (natural-log
// units, converted once per row in B2 and per column read in B3); masked
// elements are set to exactly 0 on the causal diagonal tile only, so no
// masked exponent reaches ex2. dS = P (dP - delta) scale is formed from the
// f32 P, then both are rounded to bf16 A fragments (to_a_operand).
//
// Overlap. B2 does as B1: S and dP of tile j are issued together with
// dQ += dS K of tile j - 1, and the elementwise work of j runs while the
// latter is in flight; a stage is released once its last reader has
// completed. B3 does not: it issues dV and dK of a step right after that
// step's elementwise work and waits for them, and the other CTAs on the SM
// fill the gap. Issuing them with the next step's products measured 1.9x
// slower at 64-row tiles and 1.3x at 128 (PERF.md), where B2's overlap
// gains 3%.
//
// The narrower design at D = 128: both kernels run 64-row CTAs whichever
// tile is asked for (kBwdRows). A CTA of two consumer warpgroups and the
// producer warp (288 threads) gets at most 168 registers a thread (each
// quarter of the register file holds 16,384, and 9 warps put 3 in one
// quarter); at D = 128 its accumulators do not fit (ptxas spilled and
// serialized the wgmma, B3 holding dK and dV in 128 f32 a thread), and
// setmaxnreg, with the producer a whole warpgroup, did not lift ptxas's
// limit.
//
// B2: one CTA per (batch*head, q tile of BQ rows), heavier q tiles first.
// Q and dO arrive once; the K and V tiles stream, up to the causal
// diagonal. Each lane keeps its two rows' lse and delta in registers.
//
// B3: one CTA per (batch, KV head, KV tile of BKV rows), heavier (earlier)
// KV tiles first. K and V arrive once; the producer walks the n_rep query
// heads of the GQA group and, for each, the q tiles from the causal start,
// streaming the Q tile, the dO tile and the tile's 64 lse and 64 delta
// values (one 1-D bulk copy each) into one stage. The GQA sum stays in the
// accumulators over the n_rep heads: no atomics and no f32 round trip
// through device memory, so the result is the same from run to run. With
// BKV = 128 the upper warpgroup's first q tile of each head lies wholly
// above the diagonal: it waits for that stage and releases it unread.

// The 1-D bulk copy of ``bytes`` contiguous bytes (a multiple of 16, both
// addresses 16-byte aligned) into shared memory, completing on ``bar``.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

constexpr float kLog2e = 1.4426950408889634f;

// dS of one B2 tile from S (sc) and dP (dp), in place in sc. Register i is
// row ``(i >> 1) & 1`` (0: row0, 1: row0 + 8) and KV column 8 (i / 4) + 2 t
// + (i & 1); l0/l1 are the rows' lse in log2 units, d0/d1 their delta.
// kMask (the diagonal tile) zeroes P past each row, ``diag`` being this
// lane's first row less the tile's first column.
template <bool kMask>
__device__ __forceinline__ void dq_tile_ds(float (&sc)[32], const float (&dp)[32], float l0,
                                           float l1, float d0, float d1, float scale,
                                           float scale_log2, int diag, int t) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hi = (i >> 1) & 1;
    float p = ex2(fmaf(sc[i], scale_log2, -(hi ? l1 : l0)));
    if (kMask && (i / 4) * 8 + 2 * t + (i & 1) > diag + 8 * hi) p = 0.f;
    sc[i] = p * (dp[i] - (hi ? d1 : d0)) * scale;
  }
}

// P^T (into sc) and dS^T (into dp) of one B3 step from S^T and dP^T.
// Register i is KV row ``(i >> 1) & 1`` of the lane's two and q column c =
// 8 (i / 4) + 2 t + (i & 1), whose lse and delta the stage holds at ld[c]
// and ld[64 + c]. kMask (the diagonal step) zeroes P where the q position
// precedes the KV row's, ``diag`` being this lane's first KV row less the
// tile's first q position.
template <bool kMask>
__device__ __forceinline__ void dkv_tile_p_ds(float (&sc)[32], float (&dp)[32],
                                              const float* __restrict__ ld, float scale,
                                              float scale_log2, int diag, int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 l = *reinterpret_cast<const float2*>(ld + 8 * n + 2 * t);
    const float2 d = *reinterpret_cast<const float2*>(ld + 64 + 8 * n + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * n + e, c = 8 * n + 2 * t + (e & 1);
      float p = ex2(fmaf(sc[i], scale_log2, -(e & 1 ? l.y : l.x) * kLog2e));
      if (kMask && c < diag + 8 * (e >> 1)) p = 0.f;
      sc[i] = p;
      dp[i] = p * (dp[i] - (e & 1 ? d.y : d.x)) * scale;
    }
  }
}

// Store one warpgroup's 64 x D f32 accumulator as bf16 rows row0, row0 + 8
// of a [.., pitch] tensor at ``base`` (this lane's first row, column 2 t).
template <int NC>
__device__ __forceinline__ void store_rows(bf16* base, long long pitch, const float (&acc)[NC][32]) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float* a = &acc[c][4 * n];
      *reinterpret_cast<uint32_t*>(base + c * 64 + n * 8) = pack_bf16(a[0], a[1]);
      *reinterpret_cast<uint32_t*>(base + 8 * pitch + c * 64 + n * 8) = pack_bf16(a[2], a[3]);
    }
}

// ---------------------------------------------------------------------------
// B2. dQ. Replaces pallas_attention.py::_bwd_dq_kernel.

// One consumer warpgroup of B2: q rows wg_first .. wg_first + 63 of (b, h),
// over the CTA's n_iter K/V tiles.
template <int D>
__device__ __forceinline__ void flash_dq_consumer(uint32_t q_tile, uint32_t o_tile, uint32_t bar_q,
                                                  uint32_t sK, uint32_t sV, uint32_t bar_full,
                                                  uint32_t bar_empty,
                                                  const float* __restrict__ lse,
                                                  const float* __restrict__ delta,
                                                  bf16* __restrict__ dq, int b, int h,
                                                  int wg_first, int n_iter, int Sq, int H,
                                                  float scale, float scale_log2, int causal,
                                                  int warp, int lane) {
  constexpr int NC = D / 64;
  const int g = lane >> 2, t = lane & 3;
  // the lower warpgroup of a causal 128-row q tile ends one tile early
  const int wg_iter = causal ? min(n_iter, wg_first / 64 + 1) : n_iter;
  const int row0 = wg_first + (warp & 3) * 16 + g;
  auto stage = [](int j) { return j % kStages; };
  auto wait_tile = [&](int j) { mbar_wait(bar_full + 8 * stage(j), (j / kStages) & 1); };
  auto k_tile = [&](int j) { return sK + stage(j) * NC * kChunkBytes; };
  auto v_tile = [&](int j) { return sV + stage(j) * NC * kChunkBytes; };
  const long long rows = ((long long)b * H + h) * Sq;
  const float l0 = lse[rows + row0] * kLog2e, l1 = lse[rows + row0 + 8] * kLog2e;
  const float d0 = delta[rows + row0], d1 = delta[rows + row0 + 8];

  float acc[NC][32], sc[32], dp[32];
  uint32_t da[4][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  mbar_wait(bar_q, 0);

  wait_tile(0);
  wgmma_fence();
  issue_qk<NC>(sc, q_tile, k_tile(0));
  issue_qk<NC>(dp, o_tile, v_tile(0));
  wgmma_wait<0>();
  reg_fence(sc);
  reg_fence(dp);
  if (causal && 63 > wg_first)
    dq_tile_ds<true>(sc, dp, l0, l1, d0, d1, scale, scale_log2, row0, t);
  else
    dq_tile_ds<false>(sc, dp, l0, l1, d0, d1, scale, scale_log2, 0, t);
  to_a_operand(da, sc);
  for (int j = 1; j < wg_iter; ++j) {
    wait_tile(j);
    fence_all<NC>(acc, da);
    wgmma_fence();
    issue_qk<NC>(sc, q_tile, k_tile(j));
    issue_qk<NC>(dp, o_tile, v_tile(j));
    issue_pv<NC>(acc, da, k_tile(j - 1));  // dQ += dS K of tile j - 1
    wgmma_wait<1>();  // S and dP of tile j are in; dQ of tile j - 1 may still run
    reg_fence(sc);
    reg_fence(dp);
    if (causal && j * 64 + 63 > wg_first)
      dq_tile_ds<true>(sc, dp, l0, l1, d0, d1, scale, scale_log2, row0 - j * 64, t);
    else
      dq_tile_ds<false>(sc, dp, l0, l1, d0, d1, scale, scale_log2, 0, t);
    wgmma_wait<0>();
    fence_all<NC>(acc, da);
    release(bar_empty + 8 * stage(j - 1), lane);
    to_a_operand(da, sc);
  }
  fence_all<NC>(acc, da);
  wgmma_fence();
  issue_pv<NC>(acc, da, k_tile(wg_iter - 1));
  wgmma_wait<0>();
  fence_all<NC>(acc, da);
  release(bar_empty + 8 * stage(wg_iter - 1), lane);

  const long long q_pitch = (long long)H * D;
  store_rows<NC>(dq + ((long long)b * Sq + row0) * q_pitch + (long long)h * D + 2 * t, q_pitch,
                 acc);
}

template <int D, int BQ>
__global__ void __launch_bounds__(BQ * 2 + 32, 1)
    flash_bwd_dq_kernel(__grid_constant__ const CUtensorMap tq,
                        __grid_constant__ const CUtensorMap tdo,
                        __grid_constant__ const CUtensorMap tk,
                        __grid_constant__ const CUtensorMap tv, const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dq, int Sq, int Sk,
                        int H, int Hkv, float scale, int causal) {
  constexpr int NC = D / 64, NWG = BQ / 64;
  constexpr uint32_t kv_stage_bytes = 2 * 64 * D * 2;  // one K and one V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];  // Q and dO, full[], empty[]
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;  // [NWG][NC] chunks
  const uint32_t sO = sQ + NWG * NC * kChunkBytes;           // [NWG][NC] chunks (dO)
  const uint32_t sK = sO + NWG * NC * kChunkBytes;           // [kStages][NC] chunks
  const uint32_t sV = sK + kStages * NC * kChunkBytes;       // [kStages][NC] chunks
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]), bar_empty = smem_u32(&bars[1 + kStages]);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hkv);
  const int q_first = (gridDim.y - 1 - blockIdx.y) * BQ;  // heavier q tiles first
  const int n_kv = Sk / 64;
  const int n_iter = causal ? min(n_kv, (q_first + BQ - 1) / 64 + 1) : n_kv;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NWG * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == NWG * 4) {  // the producer warp: one lane issues every copy
    if (lane != 0) return;
    mbar_expect_tx(bar_q, 2 * BQ * D * 2);
    for (int wg = 0; wg < NWG; ++wg)
      for (int c = 0; c < NC; ++c) {
        const int row = q_first + wg * 64;
        tma_load(sQ + (wg * NC + c) * kChunkBytes, &tq, bar_q, c * 64, h, row, b);
        tma_load(sO + (wg * NC + c) * kChunkBytes, &tdo, bar_q, c * 64, h, row, b);
      }
    for (int j = 0; j < n_iter; ++j) {
      const int s = j % kStages;
      if (j >= kStages) mbar_wait(bar_empty + 8 * s, (j / kStages - 1) & 1);
      mbar_expect_tx(bar_full + 8 * s, kv_stage_bytes);
      for (int c = 0; c < NC; ++c) {
        tma_load(sK + (s * NC + c) * kChunkBytes, &tk, bar_full + 8 * s, c * 64, hk, j * 64, b);
        tma_load(sV + (s * NC + c) * kChunkBytes, &tv, bar_full + 8 * s, c * 64, hk, j * 64, b);
      }
    }
    return;
  }
  const int wg = warp >> 2;
  flash_dq_consumer<D>(sQ + wg * NC * kChunkBytes, sO + wg * NC * kChunkBytes, bar_q, sK, sV,
                       bar_full, bar_empty, lse, delta, dq, b, h, q_first + wg * 64, n_iter, Sq,
                       H, scale, scale * kLog2e, causal, warp, lane);
}

// ---------------------------------------------------------------------------
// B3. dK and dV. Replaces pallas_attention.py::_bwd_dkv_kernel.

// One consumer warpgroup of B3: KV rows wg_first .. wg_first + 63 of
// (b, hk), over the CTA's n_steps (query head, q tile) steps, n_i q tiles
// from tile i0 for each head. dV and dK of a step are issued right after
// its elementwise work (see the note above).
template <int D>
__device__ __forceinline__ void flash_dkv_consumer(uint32_t k_tile, uint32_t v_tile,
                                                   uint32_t bar_kv, uint32_t sQ, uint32_t sO,
                                                   const float* sLD, uint32_t bar_full,
                                                   uint32_t bar_empty, bf16* __restrict__ dk,
                                                   bf16* __restrict__ dv, int b, int hk,
                                                   int wg_first, int n_steps, int n_i, int i0,
                                                   int Sk, int Hkv, float scale,
                                                   float scale_log2, int causal, int warp,
                                                   int lane) {
  constexpr int NC = D / 64;
  const int g = lane >> 2, t = lane & 3;
  const int krow0 = wg_first + (warp & 3) * 16 + g;  // this lane's KV rows: krow0, krow0 + 8

  float dka[NC][32], dva[NC][32], sc[32], dp[32];
  uint32_t pa[4][4], da[4][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[c][i] = dva[c][i] = 0.f;
  mbar_wait(bar_kv, 0);

  for (int j = 0; j < n_steps; ++j) {
    const int s = j % kStages, q_first = (i0 + j % n_i) * 64;
    const uint32_t q_tile = sQ + s * NC * kChunkBytes, o_tile = sO + s * NC * kChunkBytes;
    mbar_wait(bar_full + 8 * s, (j / kStages) & 1);
    if (causal && q_first < wg_first) {  // wholly above the diagonal for these rows
      release(bar_empty + 8 * s, lane);
      continue;
    }
    wgmma_fence();
    issue_qk<NC>(sc, k_tile, q_tile);  // S^T = K Q^T
    issue_qk<NC>(dp, v_tile, o_tile);  // dP^T = V dO^T
    wgmma_wait<0>();
    reg_fence(sc);
    reg_fence(dp);
    if (causal && q_first == wg_first)
      dkv_tile_p_ds<true>(sc, dp, sLD + s * 128, scale, scale_log2, krow0 - q_first, t);
    else
      dkv_tile_p_ds<false>(sc, dp, sLD + s * 128, scale, scale_log2, 0, t);
    to_a_operand(pa, sc);
    to_a_operand(da, dp);
    fence_all<NC>(dka, pa);
    fence_all<NC>(dva, da);
    wgmma_fence();
    issue_pv<NC>(dva, pa, o_tile);  // dV += P^T dO
    issue_pv<NC>(dka, da, q_tile);  // dK += dS^T Q
    wgmma_wait<0>();
    fence_all<NC>(dka, pa);
    fence_all<NC>(dva, da);
    release(bar_empty + 8 * s, lane);
  }

  const long long k_pitch = (long long)Hkv * D;
  const long long off = ((long long)b * Sk + krow0) * k_pitch + (long long)hk * D + 2 * t;
  store_rows<NC>(dk + off, k_pitch, dka);
  store_rows<NC>(dv + off, k_pitch, dva);
}

template <int D, int BKV>
__global__ void __launch_bounds__(BKV * 2 + 32, 1)
    flash_bwd_dkv_kernel(__grid_constant__ const CUtensorMap tq,
                         __grid_constant__ const CUtensorMap tdo,
                         __grid_constant__ const CUtensorMap tk,
                         __grid_constant__ const CUtensorMap tv, const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int Sq, int Sk, int H, int Hkv, float scale,
                         int causal) {
  constexpr int NC = D / 64, NWG = BKV / 64;
  constexpr uint32_t qo_stage_bytes = 2 * 64 * D * 2 + 2 * 64 * 4;  // Q, dO, lse, delta
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];  // K and V, full[], empty[]
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = base;                              // [NWG][NC] chunks
  const uint32_t sV = sK + NWG * NC * kChunkBytes;       // [NWG][NC] chunks
  const uint32_t sQ = sV + NWG * NC * kChunkBytes;       // [kStages][NC] chunks
  const uint32_t sO = sQ + kStages * NC * kChunkBytes;   // [kStages][NC] chunks (dO)
  const uint32_t sLD = sO + kStages * NC * kChunkBytes;  // [kStages][lse 64, delta 64] f32
  const float* ld = reinterpret_cast<const float*>(smem_raw + (sLD - smem_u32(smem_raw)));
  const uint32_t bar_kv = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]), bar_empty = smem_u32(&bars[1 + kStages]);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv, n_rep = H / Hkv;
  const int k_first = blockIdx.y * BKV;  // heavier (earlier) KV tiles first
  const int n_q = Sq / 64, i0 = causal ? min(k_first / 64, n_q) : 0;
  const int n_i = n_q - i0, n_steps = n_rep * n_i;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NWG * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == NWG * 4) {  // the producer warp: one lane issues every copy
    if (lane != 0) return;
    mbar_expect_tx(bar_kv, 2 * BKV * D * 2);
    for (int wg = 0; wg < NWG; ++wg)
      for (int c = 0; c < NC; ++c) {
        const int row = k_first + wg * 64;
        tma_load(sK + (wg * NC + c) * kChunkBytes, &tk, bar_kv, c * 64, hk, row, b);
        tma_load(sV + (wg * NC + c) * kChunkBytes, &tv, bar_kv, c * 64, hk, row, b);
      }
    for (int j = 0; j < n_steps; ++j) {
      const int s = j % kStages, h = hk * n_rep + j / n_i, q_first = (i0 + j % n_i) * 64;
      const float* rows = lse + ((long long)b * H + h) * Sq + q_first;
      const float* drows = delta + ((long long)b * H + h) * Sq + q_first;
      if (j >= kStages) mbar_wait(bar_empty + 8 * s, (j / kStages - 1) & 1);
      mbar_expect_tx(bar_full + 8 * s, qo_stage_bytes);
      for (int c = 0; c < NC; ++c) {
        tma_load(sQ + (s * NC + c) * kChunkBytes, &tq, bar_full + 8 * s, c * 64, h, q_first, b);
        tma_load(sO + (s * NC + c) * kChunkBytes, &tdo, bar_full + 8 * s, c * 64, h, q_first, b);
      }
      bulk_load(sLD + s * 512, rows, 256, bar_full + 8 * s);
      bulk_load(sLD + s * 512 + 256, drows, 256, bar_full + 8 * s);
    }
    return;
  }
  const int wg = warp >> 2;
  flash_dkv_consumer<D>(sK + wg * NC * kChunkBytes, sV + wg * NC * kChunkBytes, bar_kv, sQ, sO,
                        ld, bar_full, bar_empty, dk, dv, b, hk, k_first + wg * 64, n_steps, n_i,
                        i0, Sk, Hkv, scale, scale * kLog2e, causal, warp, lane);
}

// ---------------------------------------------------------------------------
// B1-B3 in float32. Replace the same Pallas kernels (pallas_attention.py::
// _fwd_kernel, _bwd_dq_kernel, _bwd_dkv_kernel) on float32 q/k/v/dout: those
// cast each tile to f32 and write in the input's dtype, so f32 in means f32
// arithmetic throughout and f32 out.
//
// What bounds them: operations. At the flagship's shapes the three do 2, 3
// and 4 S x S x D products per head, and float32 has no tensor-core rate on
// the H100 that keeps its 24-bit mantissa in one pass (TF32 keeps 10 bits).
// All three run their products as three TF32 products each (3xTF32, the
// next section), at a third of the TF32 rate: 165 TFLOP/s of f32-accurate
// products against 67 for FP32 FMA on the CUDA cores. The bytes (each
// tensor read once) are far below either bound. B2 and B3 run mma.sync
// (next section), B1 wgmma fed by a TMA ring (the section after B3).
//
// Kept in all three: the longest causal rows first, causal tiles past the
// diagonal skipped, any length (rows and columns past a sequence's end read
// as zeros, are masked and are not written), -1e30 for a masked score (only
// whole masked rows would see it, and causal rows never are), the 1e-20
// row-sum floor, f32 lse, delta from the stored out, and the GQA sum of B3
// in registers over the group's query heads (no atomics: the same inputs
// give the same bits).

constexpr int kF32Rows = 64;  // rows of every streamed f32 tile

// Causal: the KV tiles that ``rows`` q rows starting at q0 reach.
__device__ __forceinline__ int kv_tiles_f32(int q0, int rows, int Sq, int Sk, int causal) {
  const int all = (Sk + kF32Rows - 1) / kF32Rows;
  return causal ? min(all, (min(q0 + rows, Sq) - 1) / kF32Rows + 1) : all;
}

// ---------------------------------------------------------------------------
// B2 and B3 in float32: 3xTF32 on the tensor cores.
//
// What bounds them: operations (see above). The products run on the tensor
// cores as three TF32 products each: x = hi + lo with
// hi = tf32(x) and lo = tf32(x - hi), both rounded as cvt.rna.tf32.f32
// rounds, and a b = lo hi + hi lo + hi hi accumulated in f32 (lo lo, some
// 2^-22 of the product, is dropped). That keeps f32's accuracy at a third
// of the TF32 rate: 165 TFLOP/s of f32-accurate products against 67 for
// FP32 FMA (of which mma.sync reaches less than wgmma would). One product stays
// on FP32 FMA: B2's dP = dO V^T, whose rounding must be the plain version's
// (see fma_abt).
//
// Why mma.sync (m16n8k8 .tf32) and not wgmma: wgmma reads tf32 operands from
// shared memory in K-major layout only, and the products that take P or dS
// (B2's dQ = dS K, B3's dV = P^T dO and dK = dS^T Q) read both operands
// transposed. Each would need its own transposed hi/lo copy of a tile. With
// mma.sync every tf32 element of a fragment is one 32-bit register, so a
// transpose is another address pattern.
//
// The layout. A CTA holds its rows (q rows for B2, KV rows for B3), 16 a
// warp, resident in shared memory as padded [rows][D + 4] f32 rows; the
// streamed 64-row tiles (K and V for B2; Q, dO, lse and delta for B3) come
// through a ring of cp.async copies (16 bytes each, zero-filled past a
// sequence's end). B2 runs 64-row CTAs on one stage: some 70 KB, so two
// CTAs share an SM and one's copies overlap the other's products. B3 at
// D = 64 runs 128-row CTAs on two stages, the next step's copies in flight
// while this step's products run, and splits each streamed Q and dO tile
// into a hi and a lo tile once (kF32PreSplit), so its eight warps load B
// fragments ready-made instead of each warp splitting every element for
// both products it reads them in (205 KB: one CTA an SM). Elsewhere the B
// fragments are split in registers as they are loaded, and a warp always
// splits its own A rows. (flash_arms measured the other choices: see the
// arms below.)
//
// A warp computes its 16 x NC block of S and dP (NC streamed columns at a
// time, to keep the accumulators in registers), turns them into P and dS in
// place, and feeds dS (and B3's P) straight from the accumulators into the
// next product as its A fragment: the accumulator of m16n8k8 holds columns
// 2t and 2t + 1 (t = lane % 4) where the A fragment wants k slots t and t +
// 4, so those slots take columns 2t and 2t + 1 and the B operand's k rows
// are read as rows 2t and 2t + 1. At a row stride of D + 4 floats every
// fragment read is free of bank conflicts: a row-major read (S = Q K^T)
// hits bank 4g + t (g = lane / 4), a transposed one (rows 2t, 2t + 1,
// column g) bank 8t + g.
//
// Accumulation. The tensor cores round their own accumulator toward zero;
// kept across a whole long sum that bias grows with its length, past the
// f32 rule for B3's dK over four heads of 1024 rows. S and dP (k over D)
// keep one chain; dQ, dK and dV take each chunk of NC streamed rows into a
// fresh accumulator (at D = 128 one a column group, for registers) that is
// added to the running sum in f32, rounding to nearest.
//
// Inside the diagonal tile, a warp's column chunks that lie wholly above it
// are skipped too.
//
// The design's arms (python -m uccl_tpu_torch.flash_arms times each beside
// the source): the other stage count and CTA rows of each kernel, B3's
// fragments split in registers, P and dS through shared memory, and the
// ring on 1-D bulk copies (TMA's copy engine, one a row, completing on an
// mbarrier).

template <int D>
constexpr int kF32DqRows = 64;  // B2's CTA rows
constexpr int kF32DqRing = 1;  // B2's ring stages
template <int D>
constexpr int kF32DkvRows = D == 64 ? 128 : 64;  // B3's CTA rows
constexpr int kF32DkvRing = 2;  // B3's ring stages
template <int D>
constexpr bool kF32PreSplit = D == 64;  // B3's Q and dO split into hi and lo tiles once a CTA
constexpr bool kF32DsInRegisters = true;  // false: P and dS through a warp's shared-memory tile
constexpr bool kF32BulkRing = false;  // true: the ring on 1-D bulk copies instead of cp.async

// B2's (kDkv false) or B3's shapes at head dim D.
template <int D, bool kDkv>
struct BwdF32 {
  static constexpr int BR = kDkv ? kF32DkvRows<D> : kF32DqRows<D>;  // CTA rows
  static constexpr int RING = kDkv ? kF32DkvRing : kF32DqRing;
  static constexpr int LD = D + 4;                 // row stride (floats) of every tile
  static constexpr int NT = 2 * BR;                // threads: a warp per 16 rows
  static constexpr int TILE = kF32Rows * LD;       // one streamed tile, floats
  static constexpr int NC = D == 64 ? 64 : 16;     // streamed columns of a warp's S block
  static constexpr int NJ = NC / 8;                // its m16n8 accumulators
  static constexpr bool PRE = kDkv && kF32PreSplit<D>;
  static constexpr int LO = PRE ? TILE : 0;        // floats from a split tile's hi to its lo
  static constexpr int PW = 16 * (NC + 4);         // a warp's P or dS tile (the shared-memory arm)
  static constexpr int PWS = kF32DsInRegisters ? 0 : (NT / 32) * PW;
};

// x rounded to tf32 as cvt.rna.tf32.f32 rounds it (to 10 explicit mantissa
// bits, ties away from zero), on the integer pipe: half the dropped 13
// bits' range added to the magnitude, then those bits cleared. Two
// instructions where the cvt takes four; the same bits for every finite x.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as hi + lo, two tf32 values.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// A B fragment element: split here (LO = 0), or read from a split tile's hi
// at ``p`` and its lo LO floats on.
template <int LO>
__device__ __forceinline__ void load_b(const float* p, uint32_t& hi, uint32_t& lo) {
  if constexpr (LO > 0) {
    hi = __float_as_uint(p[0]);
    lo = __float_as_uint(p[LO]);
  } else {
    split_tf32(p[0], hi, lo);
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32, the two small terms first. kTerms < 3 drops terms (a
// planted fault's knob: 2 drops lo hi, 1 leaves a single TF32 pass).
template <int kTerms>
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  if (kTerms > 2) mma_tf32(c, al, bh[0], bh[1]);
  if (kTerms > 1) mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

// The A fragment of a warp's 16 rows at ``A`` (row stride LD), k slots t
// and t + 4 at columns k + t and k + t + 4, split in registers.
template <int LD>
__device__ __forceinline__ void load_a(const float* A, int k, int g, int t, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  split_tf32(A[g * LD + k + t], ah[0], al[0]);
  split_tf32(A[(g + 8) * LD + k + t], ah[1], al[1]);
  split_tf32(A[g * LD + k + t + 4], ah[2], al[2]);
  split_tf32(A[(g + 8) * LD + k + t + 4], ah[3], al[3]);
}

// c[j] = A B^T over k < D: a warp's 16 x 8 NJ block, A's 16 rows at ``A``
// and B's 8 NJ rows at ``B``, both row-major tiles of row stride D + 4
// (reads at bank 4g + t); B split in registers or pre-split (LO).
template <int D, int NJ, int kTerms, int LO>
__device__ __forceinline__ void mma_abt(float (&c)[NJ][4], const float* A, const float* B, int g,
                                        int t) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int j = 0; j < NJ; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int k = 0; k < D; k += 8) {
    uint32_t ah[4], al[4];
    load_a<LD>(A, k, g, t, ah, al);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t bh[2], bl[2];
      const float* b = B + (8 * j + g) * LD + k + t;
      load_b<LO>(b, bh[0], bl[0]);
      load_b<LO>(b + 4, bh[1], bl[1]);
      mma_3xtf32<kTerms>(c[j], ah, al, bh, bl);
    }
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float c) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, c))));
}

// c[j] = A B^T over k < D as FP32 FMA, k in order: the same 16 x 8 NJ block
// as mma_abt, in its accumulator layout (rows g, g + 8; columns 8j + 2t,
// 8j + 2t + 1). B2's dP runs this way: dS = P (dP - delta) cancels down to
// the lse cotangent where P sits on one column (causal row 0), and there
// only the rounding of an f32 dot product taken in order, as the plain
// version's f32 GEMM takes it, meets the f32 rule; any other order, however
// exact, reads several times over it (the plain version itself reads 4.9
// of the rule against float64 at the main path's shape: chip_smoke.py,
// f32_kernels_vs_plain's worst_vs_float64). Reads: 16 bytes at banks 4g (A)
// and 8t (B, a broadcast across g).
template <int D, int NJ>
__device__ __forceinline__ void fma_abt(float (&c)[NJ][4], const float* A, const float* B, int g,
                                        int t) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int j = 0; j < NJ; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll 2
  for (int k = 0; k < D; k += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(A + g * LD + k);
    const float4 a1 = *reinterpret_cast<const float4*>(A + (g + 8) * LD + k);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 b0 = *reinterpret_cast<const float4*>(B + (8 * j + 2 * t) * LD + k);
      const float4 b1 = *reinterpret_cast<const float4*>(B + (8 * j + 2 * t + 1) * LD + k);
      c[j][0] = dot4(a0, b0, c[j][0]);
      c[j][1] = dot4(a0, b1, c[j][1]);
      c[j][2] = dot4(a1, b0, c[j][2]);
      c[j][3] = dot4(a1, b1, c[j][3]);
    }
  }
}

// The A fragment of k-step j from accumulators p (rows g, g + 8; columns
// 8j + 2t, 8j + 2t + 1): k slots t and t + 4 take columns 2t and 2t + 1.
template <int NJ>
__device__ __forceinline__ void acc_to_a(const float (&p)[NJ][4], int j, uint32_t (&ah)[4],
                                         uint32_t (&al)[4]) {
  split_tf32(p[j][0], ah[0], al[0]);
  split_tf32(p[j][2], ah[1], al[1]);
  split_tf32(p[j][1], ah[2], al[2]);
  split_tf32(p[j][3], ah[3], al[3]);
}

// c[n] += P V: P is a warp's 16 x 8 NJ block as accumulators, used as A
// fragments in place (acc_to_a); V's 8 NJ rows at ``V`` (row stride D + 4,
// split in registers or pre-split, LO) are read to match, rows 8j + 2t and
// 8j + 2t + 1 (bank 8t + g); n runs over D / 8 column groups. The chunk
// sums into a fresh accumulator added to c once: at D = 64 one for all n
// (k-steps outside), at D = 128 (for registers) one a column group, the
// chunk's A fragments held.
template <int D, int NJ, int kTerms, int LO>
__device__ __forceinline__ void mma_pv(float (&c)[D / 8][4], const float (&p)[NJ][4],
                                       const float* V, int g, int t) {
  constexpr int LD = D + 4, N = D / 8;
  if constexpr (D == 64) {
    float d[N][4];
#pragma unroll
    for (int n = 0; n < N; ++n) d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t ah[4], al[4];
      acc_to_a<NJ>(p, j, ah, al);
      const float* v = V + (8 * j + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        uint32_t bh[2], bl[2];
        load_b<LO>(v + 8 * n, bh[0], bl[0]);
        load_b<LO>(v + LD + 8 * n, bh[1], bl[1]);
        mma_3xtf32<kTerms>(d[n], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[n][e] += d[n][e];
  } else {
    uint32_t ah[NJ][4], al[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc_to_a<NJ>(p, j, ah[j], al[j]);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t bh[2], bl[2];
        const float* v = V + (8 * j + 2 * t) * LD + 8 * n + g;
        load_b<LO>(v, bh[0], bl[0]);
        load_b<LO>(v + LD, bh[1], bl[1]);
        mma_3xtf32<kTerms>(d, ah[j], al[j], bh, bl);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) c[n][e] += d[e];
    }
  }
}

// mma_pv through shared memory (the kF32DsInRegisters = false arm): the
// warp stores P into its own [16][8 NJ + 4] tile ``sP`` and reads it back as
// A fragments in k order; one fresh accumulator a k-step.
template <int D, int NJ, int kTerms, int LO>
__device__ __forceinline__ void mma_pv_smem(float (&c)[D / 8][4], const float (&p)[NJ][4],
                                            float* sP, const float* V, int g, int t) {
  constexpr int LD = D + 4, LP = 8 * NJ + 4;
  __syncwarp();  // the warp's last read of sP is done
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    *reinterpret_cast<float2*>(sP + g * LP + 8 * j + 2 * t) = make_float2(p[j][0], p[j][1]);
    *reinterpret_cast<float2*>(sP + (g + 8) * LP + 8 * j + 2 * t) = make_float2(p[j][2], p[j][3]);
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 8 * NJ; k += 8) {
    uint32_t ah[4], al[4];
    load_a<LP>(sP, k, g, t, ah, al);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t bh[2], bl[2];
      load_b<LO>(V + (k + t) * LD + 8 * n + g, bh[0], bl[0]);
      load_b<LO>(V + (k + t + 4) * LD + 8 * n + g, bh[1], bl[1]);
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      mma_3xtf32<kTerms>(s, ah, al, bh, bl);
#pragma unroll
      for (int e = 0; e < 4; ++e) c[n][e] += s[e];
    }
  }
}

// A streamed [64][D + 4] tile ``src`` split into a hi tile ``hi`` and a lo
// tile LO floats after it, by NT threads, 16 bytes each.
template <int D, int NT, int LO>
__device__ __forceinline__ void split_tile(float* hi, const float* src) {
  constexpr int C4 = D / 4, LD = D + 4;
  for (int i = threadIdx.x; i < kF32Rows * C4; i += NT) {
    const int off = (i / C4) * LD + 4 * (i % C4);
    const float4 x = *reinterpret_cast<const float4*>(src + off);
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(hi + LO + off) = l;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows [r0, r0 + ROWS) of one head of a [B, S, heads, D] f32 tensor (``src``
// at that head's row 0, ``stride`` floats from row to row) into a padded
// [ROWS][D + 4] tile, asynchronously: cp.async, 16 bytes a thread, or with
// kBulk one 1-D bulk copy a row completing on ``bar`` (whose expected bytes
// the caller sets). Rows at or past S arrive as zeros.
template <int D, int ROWS, int NT, bool kBulk>
__device__ __forceinline__ void async_tile_f32(float* dst, const float* __restrict__ src, int r0,
                                               int S, int stride, uint32_t bar) {
  constexpr int C4 = D / 4, LD = D + 4;
  if constexpr (kBulk) {
    for (int r = threadIdx.x; r < ROWS; r += NT) {
      if (r0 + r < S) {
        bulk_load(smem_u32(dst + r * LD), src + (long long)(r0 + r) * stride, D * 4, bar);
      } else {
        for (int c = 0; c < C4; ++c)
          *reinterpret_cast<float4*>(dst + r * LD + 4 * c) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * C4; i += NT) {
      const int r = i / C4, c = i % C4;
      const bool in = r0 + r < S;
      cp_async16(dst + r * LD + 4 * c, in ? src + (long long)(r0 + r) * stride + 4 * c : src, in);
    }
  }
}

// The bulk arm's stage barriers, at the base of dynamic shared memory (the
// tiles start 64 bytes in); initialised before the first copy.
template <int R>
__device__ __forceinline__ void init_ring_bars(uint64_t* bars) {
  if (kF32BulkRing) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < R; ++s) mbar_init(smem_u32(bars + s), 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }
}

// Bytes of the in-range rows of a 64-row tile at r0 (the bulk arm's count).
__device__ __forceinline__ uint32_t tile_bytes_f32(int r0, int S, int D) {
  return (uint32_t)(min(kF32Rows, S - r0) * D * 4);
}

// The top of step i of a ring of R stages: wait for its stage (every
// thread's copies, then the barrier makes them everyone's) and, past the
// barrier, which also says that every warp is done with step i - 1's stage,
// start the copies of step i + R - 1 into that stage. With one stage the
// copies of step i start here, after every warp is done with step i - 1.
// ``issue(i)`` starts step i's copies.
template <int R, typename Issue>
__device__ __forceinline__ void ring_step(int i, int n, uint64_t* bars, Issue issue) {
  if constexpr (R == 1) {
    if (i) __syncthreads();  // every warp is done with the one stage
    if (kF32BulkRing) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    issue(i);
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    cp_async_wait<R - 2>();
  }
  if constexpr (kF32BulkRing) mbar_wait(smem_u32(bars + i % R), (i / R) & 1);
  __syncthreads();
  if constexpr (R > 1) {
    if (kF32BulkRing) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (i + R - 1 < n) issue(i + R - 1);
    cp_async_commit();
  }
}

// Before step 0: the copies of steps 0 .. R - 2, one group each.
template <int R, typename Issue>
__device__ __forceinline__ void ring_prologue(int n, Issue issue) {
  for (int s = 0; s < R - 1; ++s) {
    if (s < n) issue(s);
    cp_async_commit();
  }
}

// A warp's 16 x D accumulators (rows r and r + 8 of its block) stored as
// f32 rows of a [B, S, heads, D] tensor at ``dst`` (that head's row 0);
// rows at or past S are not written.
template <int D>
__device__ __forceinline__ void store_frag_rows(float* __restrict__ dst, const float (&c)[D / 8][4],
                                                int r, int S, int stride, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (r + 8 * half >= S) continue;
    float* row = dst + (long long)(r + 8 * half) * stride + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(row + 8 * n) = make_float2(c[n][2 * half], c[n][2 * half + 1]);
  }
}

// B2 in f32: one CTA per (batch * head, BR q rows) with Q and dO resident,
// K/V tiles streaming; per tile and column chunk a warp computes S = Q K^T
// (3xTF32, K split in registers) and dP = dO V^T (FP32 FMA), dS = P (dP -
// delta) scale in registers, then dQ += dS K.
template <int D>
__global__ void __launch_bounds__(2 * BwdF32<D, false>::BR, 1)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dq, int Sq, int Sk, int H, int Hkv, float scale,
                            float scale_log2, int causal) {
  using T = BwdF32<D, false>;
  constexpr int BR = T::BR, R = T::RING;
  constexpr int kDqTerms = 3;  // TF32 products per f32 product
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  float* sQ = reinterpret_cast<float*>(smem_raw + 64);
  float* sO = sQ + BR * T::LD;  // dO
  float* ring = sO + BR * T::LD;  // stage s: K tile, then V tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* sPw = ring + R * 2 * T::TILE + warp * T::PW;
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;  // the longest causal rows first
  const int qstride = H * D, kstride = Hkv * D;
  const long long qhead = ((long long)b * Sq * H + h) * D;
  const float* kb = k + ((long long)b * Sk * Hkv + hk) * D;
  const float* vb = v + ((long long)b * Sk * Hkv + hk) * D;
  init_ring_bars<R>(bars);
  async_tile_f32<D, BR, T::NT, false>(sQ, q + qhead, q0, Sq, qstride, 0);
  async_tile_f32<D, BR, T::NT, false>(sO, dout + qhead, q0, Sq, qstride, 0);
  auto issue = [&](int kt) {
    float* st = ring + (kt % R) * 2 * T::TILE;
    const uint32_t bar = smem_u32(bars + kt % R);
    if (kF32BulkRing && threadIdx.x == 0)
      mbar_expect_tx(bar, 2 * tile_bytes_f32(kt * kF32Rows, Sk, D));
    async_tile_f32<D, kF32Rows, T::NT, kF32BulkRing>(st, kb, kt * kF32Rows, Sk, kstride, bar);
    async_tile_f32<D, kF32Rows, T::NT, kF32BulkRing>(st + T::TILE, vb, kt * kF32Rows, Sk,
                                                     kstride, bar);
  };
  const int dq_tiles = kv_tiles_f32(q0, BR, Sq, Sk, causal);
  ring_prologue<R>(dq_tiles, issue);

  const int r = q0 + 16 * warp + g;  // this lane's rows: r and r + 8
  const long long rows = ((long long)b * H + h) * Sq;
  float l2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l2[i] = r + 8 * i < Sq ? lse[rows + r + 8 * i] * kLog2e : 0.f;
    dl[i] = r + 8 * i < Sq ? delta[rows + r + 8 * i] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float* sQw = sQ + 16 * warp * T::LD;
  const float* sOw = sO + 16 * warp * T::LD;
  for (int kt = 0; kt < dq_tiles; ++kt) {
    ring_step<R>(kt, dq_tiles, bars, issue);
    const float* sK = ring + (kt % R) * 2 * T::TILE;
    const float* sV = sK + T::TILE;
    const int k0 = kt * kF32Rows;
#pragma unroll 1
    for (int c = 0; c < kF32Rows; c += T::NC) {
      if (causal && k0 + c > q0 + 16 * warp + 15) break;  // the chunk lies above the diagonal
      float s[T::NJ][4], dp[T::NJ][4];
      mma_abt<D, T::NJ, kDqTerms, 0>(s, sQw, sK + c * T::LD, g, t);
      fma_abt<D, T::NJ>(dp, sOw, sV + c * T::LD, g, t);
#pragma unroll
      for (int j = 0; j < T::NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r + 8 * (e >> 1), col = k0 + c + 8 * j + 2 * t + (e & 1);
          const bool dq_masked = col >= Sk || (causal && col > row);
          const float p = dq_masked ? 0.f : exp2f(fmaf(s[j][e], scale_log2, -l2[e >> 1]));
          s[j][e] = p * (dp[j][e] - dl[e >> 1]) * scale;
        }
      if constexpr (kF32DsInRegisters)
        mma_pv<D, T::NJ, kDqTerms, 0>(acc, s, sK + c * T::LD, g, t);
      else
        mma_pv_smem<D, T::NJ, kDqTerms, 0>(acc, s, sPw, sK + c * T::LD, g, t);
    }
  }
  store_frag_rows<D>(dq + qhead, acc, r, Sq, qstride, t);
}

// B3 in f32: one CTA per (batch * KV head, BR KV rows) with K and V
// resident; the ring streams, over the group's query heads and each q tile
// that reaches these rows, the Q and dO tiles and the tile's lse and delta
// (Q and dO split into hi and lo once a step, T::PRE). Per step and column
// chunk a warp computes S^T = K Q^T and dP^T = V dO^T, P^T and dS^T in
// registers, then dV += P^T dO and dK += dS^T Q, all in 3xTF32. The GQA sum
// is the loop over heads, in registers.
template <int D>
__global__ void __launch_bounds__(2 * BwdF32<D, true>::BR, 1)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk,
                             int H, int Hkv, float scale, float scale_log2, int causal) {
  using T = BwdF32<D, true>;
  constexpr int BR = T::BR, R = T::RING;
  constexpr int kDkvTerms = 3;  // TF32 products per f32 product
  constexpr int STAGE = 2 * T::TILE + 2 * kF32Rows;  // Q, dO, lse, delta
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  float* sK = reinterpret_cast<float*>(smem_raw + 64);
  float* sV = sK + BR * T::LD;
  float* ring = sV + BR * T::LD;
  float* sS = ring + R * STAGE;  // Q's hi and lo tiles, then dO's (T::PRE)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* sPw = sS + (T::PRE ? 4 * T::TILE : 0) + warp * T::PW;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int k0 = blockIdx.y * BR;  // the longest causal column of q tiles first
  const int qstride = H * D, kstride = Hkv * D;
  const long long khead = ((long long)b * Sk * Hkv + hk) * D;
  init_ring_bars<R>(bars);
  async_tile_f32<D, BR, T::NT, false>(sK, k + khead, k0, Sk, kstride, 0);
  async_tile_f32<D, BR, T::NT, false>(sV, v + khead, k0, Sk, kstride, 0);

  const int n_rep = H / Hkv;
  const int h_first = hk * n_rep;
  const int q_tiles = (Sq + kF32Rows - 1) / kF32Rows;
  const int q_first = causal ? k0 / kF32Rows : 0;
  const int n_q = q_tiles - q_first;
  const int steps = n_rep * n_q;  // (head, q tile) pairs, head-major
  auto issue = [&](int i) {
    const int h = h_first + i / n_q, q0 = (q_first + i % n_q) * kF32Rows;
    const long long qhead = ((long long)b * Sq * H + h) * D;
    const long long rows = ((long long)b * H + h) * Sq;
    float* st = ring + (i % R) * STAGE;
    const uint32_t bar = smem_u32(bars + i % R);
    if (kF32BulkRing && threadIdx.x == 0) mbar_expect_tx(bar, 2 * tile_bytes_f32(q0, Sq, D));
    async_tile_f32<D, kF32Rows, T::NT, kF32BulkRing>(st, q + qhead, q0, Sq, qstride, bar);
    async_tile_f32<D, kF32Rows, T::NT, kF32BulkRing>(st + T::TILE, dout + qhead, q0, Sq,
                                                     qstride, bar);
    for (int j = threadIdx.x; j < 2 * kF32Rows; j += T::NT) {  // lse, then delta
      const int row = q0 + j % kF32Rows;
      const float* src = (j < kF32Rows ? lse : delta) + rows + row;
      cp_async4(st + 2 * T::TILE + j, row < Sq ? src : lse, row < Sq);
    }
  };
  ring_prologue<R>(steps, issue);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  const int r = k0 + 16 * warp + g;  // this lane's KV rows: r and r + 8
  const float* sKw = sK + 16 * warp * T::LD;
  const float* sVw = sV + 16 * warp * T::LD;
  for (int i = 0; i < steps; ++i) {
    ring_step<R>(i, steps, bars, issue);
    const float* sQ = ring + (i % R) * STAGE;
    const float* sO = sQ + T::TILE;  // dO
    const float* sL = sO + T::TILE;  // lse
    const float* sD = sL + kF32Rows;  // delta
    if constexpr (T::PRE) {
      split_tile<D, T::NT, T::LO>(sS, sQ);
      split_tile<D, T::NT, T::LO>(sS + 2 * T::TILE, sO);
      __syncthreads();
    }
    const float* sQb = T::PRE ? sS : sQ;  // Q and dO as the tensor cores read them
    const float* sOb = T::PRE ? sS + 2 * T::TILE : sO;
    const int q0 = (q_first + i % n_q) * kF32Rows;
#pragma unroll 1
    for (int c = 0; c < kF32Rows; c += T::NC) {
      if (causal && q0 + c + T::NC <= k0 + 16 * warp) continue;  // the chunk lies above the diagonal
      float s[T::NJ][4], dp[T::NJ][4];
      mma_abt<D, T::NJ, kDkvTerms, T::LO>(s, sKw, sQb + c * T::LD, g, t);
      mma_abt<D, T::NJ, kDkvTerms, T::LO>(dp, sVw, sOb + c * T::LD, g, t);
#pragma unroll
      for (int j = 0; j < T::NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int krow = r + 8 * (e >> 1), qc = c + 8 * j + 2 * t + (e & 1);
          const bool dkv_masked = q0 + qc >= Sq || (causal && krow > q0 + qc);
          const float p =
              dkv_masked ? 0.f : exp2f(fmaf(s[j][e], scale_log2, -(sL[qc] * kLog2e)));
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - sD[qc]) * scale;
        }
      if constexpr (kF32DsInRegisters) {
        mma_pv<D, T::NJ, kDkvTerms, T::LO>(dv_acc, s, sOb + c * T::LD, g, t);
        mma_pv<D, T::NJ, kDkvTerms, T::LO>(dk_acc, dp, sQb + c * T::LD, g, t);
      } else {
        mma_pv_smem<D, T::NJ, kDkvTerms, T::LO>(dv_acc, s, sPw, sOb + c * T::LD, g, t);
        mma_pv_smem<D, T::NJ, kDkvTerms, T::LO>(dk_acc, dp, sPw, sQb + c * T::LD, g, t);
      }
    }
  }
  store_frag_rows<D>(dk + khead, dk_acc, r, Sk, kstride, t);
  store_frag_rows<D>(dv + khead, dv_acc, r, Sk, kstride, t);
}

// ---------------------------------------------------------------------------
// B1 in float32: 3xTF32 on the tensor cores.
//
// What bounds it: operations (2 S x S x D products per head, the causal half
// of them), here as 3xTF32 (the arithmetic of the section above: hi and lo
// rounded as cvt.rna rounds, lo hi + hi lo + hi hi). S over D keeps one
// accumulator chain; each KV tile's P V goes into a fresh accumulator that
// is added in f32 (round to nearest) to the output after the output is
// rescaled by the online softmax's correction, so the tensor cores' rounding
// toward zero never runs across a long sum. The online softmax is B1's
// (tile_softmax: exp2 with the scale folded into log2 e, the running max and
// sum in registers), lse = m ln 2 + log l.
//
// Unlike the backward's, the forward's products read their operands as the
// tf32 wgmma wants them, K-major: S = Q K^T reads Q and K rows as stored,
// and O += P V takes P from registers. Only V needs a copy with the keys
// contiguous (V^T), and the CTA writes that copy itself once a tile, when it
// splits V into hi and lo.
//
// The wgmma design (kF32FwdWgmma, D = 64): one CTA per (batch * head, BR q
// rows) with BR / 64 warpgroups. Raw f32 K and V tiles of 64 rows stream
// through a ring of kF32FwdRing stages by TMA (4-d tensor maps over the
// strided [B, S, heads, D] layouts, 128-byte swizzle, boxes of 64 rows x 32
// floats, zeros past a sequence's end), each stage completing on an
// mbarrier; one thread issues every copy, a stage's next tile as soon as the
// CTA has split its last one. (A producer warp, as the bf16 B1 has, makes a
// 288-thread CTA, for which ptxas allows 168 registers a thread: the design
// spilled.) Q arrives once and is split in place (hi over the raw tile, lo
// beside it). Per tile the CTA splits K into hi and lo tiles (the same
// swizzled layout, element for element) and V into a V^T hi and lo tile
// (keys along the 128-byte rows); then each warpgroup issues S = Q K^T as
// three chains of wgmma m64n64k8 .tf32 from shared memory together with O
// += P V of the previous tile (A, P's hi and lo, from registers), and runs
// the softmax of this tile while the latter is in flight. The accumulator of
// S holds columns 2t and 2t + 1 (t = lane % 4) where an A fragment wants k
// slots t and t + 4, so P's k slots t and t + 4 take keys 2t and 2t + 1 of
// each 8-key group, and V^T stores each group's keys in that order (even
// keys in the first 16 bytes, odd keys in the second). K's split tiles are
// single and V^T's double: two barriers a tile keep every warp's reads of a
// split tile ahead of its next writes, and its writes (and reads of the raw
// stage) ahead of the wgmma that read them (and the copy that refills the
// stage). Splitting V while the products run and K once every S is in, so
// that no split idles the tensor cores, measured no faster on an H100: the
// splits and the products likely share the shared-memory bandwidth, which
// S (both operands from shared memory, 4 KB a 32-cycle wgmma) uses whole.
//
// The mma.sync design (D = 128, where the wgmma design's split tiles do not
// fit beside a ring, and the arm at D = 64): a warp per 16 q rows, Q
// resident as padded f32 rows, K and V through a cp.async ring (the
// backward's async_tile_f32 / ring_step), every fragment split in registers
// as it is loaded; S with mma_abt, P V with mma_pv (P fed from the
// accumulators, a fresh accumulator a tile). python -m uccl_tpu_torch.flash_arms --set f32 times the arms.

template <int D>
constexpr bool kF32FwdWgmma = D == 64;  // false: the mma.sync design
template <int D>
constexpr int kF32FwdRows = D == 64 ? 128 : 64;  // CTA q rows
constexpr int kF32FwdRing = 2;  // raw K/V stages in the ring
constexpr int kF32FwdTerms = 3;  // TF32 products per f32 product

template <int D>
struct FwdF32 {
  static constexpr bool WG = kF32FwdWgmma<D>;
  static constexpr int BR = kF32FwdRows<D>;  // CTA rows
  static constexpr int R = kF32FwdRing;
  static constexpr int NWG = BR / 64;  // wgmma: warpgroups
  static constexpr int NT = BR * 2;  // threads: a warp per 16 rows
  static constexpr int NCH = D / 32;  // wgmma: 128-byte chunks across a row of D
  static constexpr int BLOCK = NCH * kChunkBytes;  // wgmma: one 64-row tile, bytes
  static constexpr int VT = 2 * D * 128;  // wgmma: a V^T tile (two 32-key chunks of D rows), bytes
  static constexpr int LD = D + 4;  // mma.sync: row stride (floats) of every tile
  static constexpr int TILE = kF32Rows * LD;  // mma.sync: one streamed tile, floats
};

// Whether a 64-key tile at k0 holds any masked score for rows from
// ``row_first`` on: keys at or past Sk and, with causal, keys past a row.
__device__ __forceinline__ bool fwd_tile_masked(int k0, int Sk, int row_first, int causal) {
  return k0 + kF32Rows > Sk || (causal && k0 + kF32Rows - 1 > row_first);
}

// Those scores set to -1e30, in tile_softmax's register layout (``row0``:
// this lane's first row).
__device__ __forceinline__ void fwd_mask_tile(float (&sc)[32], int k0, int Sk, int row0,
                                              int causal, int t) {
  const int cols = Sk - k0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int key = (i / 4) * 8 + 2 * t + (i & 1), row = row0 - k0 + 8 * ((i >> 1) & 1);
    if (key >= cols || (causal && key > row)) sc[i] = kNegInf;
  }
}

// Rows row0 and row0 + 8 of a warp's 16 x D output, divided by their row
// sums and stored as f32, with their lse; rows at or past Sq are not written.
template <int D>
__device__ __forceinline__ void fwd_f32_epilogue(float (&acc)[D / 8][4], float m0, float m1,
                                                 float l0, float l1, float* __restrict__ o,
                                                 float* __restrict__ lse_rows, int row0, int Sq,
                                                 int stride, int t) {
  constexpr float kLn2 = 0.69314718055994531f;
  l0 = fmaxf(quad_sum(l0), 1e-20f);
  l1 = fmaxf(quad_sum(l1), 1e-20f);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[n][0] *= inv0;
    acc[n][1] *= inv0;
    acc[n][2] *= inv1;
    acc[n][3] *= inv1;
  }
  store_frag_rows<D>(o, acc, row0, Sq, stride, t);
  if (t == 0) {
    if (row0 < Sq) lse_rows[row0] = (m0 + log2f(l0)) * kLn2;
    if (row0 + 8 < Sq) lse_rows[row0 + 8] = (m1 + log2f(l1)) * kLn2;
  }
}

// D[64x64] (+)= A[64x8] B[8x64], tf32 in, f32 accumulate; A and B in shared
// memory, K-major. ``accumulate`` 0 overwrites D.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64x64] (+)= A[64x8] B[8x64]: A from registers (the m16n8k8 .tf32 A
// layout per warp, warp w holding rows 16w..16w+15), B K-major in shared
// memory.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// S = Q K^T of one 64 x 64 tile in 3xTF32 (lo hi, hi lo, hi hi a k-step),
// issued and committed: k-steps of 8 along D, each 32 bytes further into the
// 128-byte swizzled rows (the next 32 columns are the next chunk).
template <int NCH, int kTerms>
__device__ __forceinline__ void issue_qk_tf32(float (&sc)[32], uint32_t qh, uint32_t ql,
                                              uint32_t kh, uint32_t kl) {
#pragma unroll
  for (int ks = 0; ks < NCH * 4; ++ks) {
    const uint32_t off = (ks / 4) * kChunkBytes + (ks % 4) * 32;
    if (kTerms > 2)
      wgmma_tf32_ss(sc, sw128_desc(ql + off, 16, 1024), sw128_desc(kh + off, 16, 1024), ks > 0);
    if (kTerms > 1)
      wgmma_tf32_ss(sc, sw128_desc(qh + off, 16, 1024), sw128_desc(kl + off, 16, 1024),
                    ks > 0 || kTerms > 2);
    wgmma_tf32_ss(sc, sw128_desc(qh + off, 16, 1024), sw128_desc(kh + off, 16, 1024),
                  ks > 0 || kTerms > 1);
  }
  wgmma_commit();
}

// F = P V of one tile in 3xTF32 into a fresh accumulator, issued and
// committed: P's hi and lo A fragments from registers, k-step ks (8 keys)
// of the V^T hi and lo tiles at vh and vl (32 bytes a k-step into the
// 128-byte rows; keys 32-63 in the second chunk of D rows).
template <int D, int kTerms>
__device__ __forceinline__ void issue_pv_tf32(float (&f)[32], const uint32_t (&ph)[8][4],
                                              const uint32_t (&pl)[8][4], uint32_t vh,
                                              uint32_t vl) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const uint32_t off = (ks / 4) * (D * 128) + (ks % 4) * 32;
    if (kTerms > 2) wgmma_tf32_rs(f, pl[ks], sw128_desc(vh + off, 16, 1024), ks > 0);
    if (kTerms > 1) wgmma_tf32_rs(f, ph[ks], sw128_desc(vl + off, 16, 1024), ks > 0 || kTerms > 2);
    wgmma_tf32_rs(f, ph[ks], sw128_desc(vh + off, 16, 1024), ks > 0 || kTerms > 1);
  }
  wgmma_commit();
}

__device__ __forceinline__ void split4(const float4& x, uint4& hi, uint4& lo) {
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
}

// A ring stage's raw K tile (``raw``, [NCH] swizzled chunks) into K's hi and
// lo tiles at kt and kt + BLOCK, element for element, and its raw V tile
// (BLOCK bytes on) into V^T's hi and lo tiles at vt and vt + VT: row d of
// V^T holds column d of V, key chunk c (keys 32c..32c+31) at c * D * 128,
// 128-byte swizzled; each 8-key group's even keys fill its first 16 bytes
// and its odd keys its second (the k slots P's A fragments put them in).
// By the CTA's threads, thread ``tid``; every read and write free of bank
// conflicts.
template <int D>
__device__ __forceinline__ void split_kv_tf32(const unsigned char* raw, unsigned char* kt,
                                              unsigned char* vt, int tid) {
  using T = FwdF32<D>;
  for (int i = tid; i < T::BLOCK / 16; i += T::NT) {
    uint4 hi, lo;
    split4(reinterpret_cast<const float4*>(raw)[i], hi, lo);
    reinterpret_cast<uint4*>(kt)[i] = hi;
    reinterpret_cast<uint4*>(kt + T::BLOCK)[i] = lo;
  }
  const unsigned char* rv = raw + T::BLOCK;
  for (int i = tid; i < D * 16; i += T::NT) {
    const int d = i % D, grp = i / D, jg = grp >> 1, hh = grp & 1;
    const unsigned char* src = rv + (d / 32) * kChunkBytes + (d & 3) * 4;
    float4 x;
    float* xe = &x.x;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 8 * jg + hh + 2 * e;
      xe[e] = *reinterpret_cast<const float*>(src + r * 128 + ((((d & 31) >> 2) ^ (r & 7)) << 4));
    }
    uint4 hi, lo;
    split4(x, hi, lo);
    const int off = (jg >> 2) * (D * 128) + d * 128 + (((2 * (jg & 3) + hh) ^ (d & 7)) << 4);
    *reinterpret_cast<uint4*>(vt + off) = hi;
    *reinterpret_cast<uint4*>(vt + T::VT + off) = lo;
  }
}

// B1 in f32, the wgmma design (see the section's note).
template <int D>
__device__ __forceinline__ void fwd_f32_wgmma(const CUtensorMap& tq, const CUtensorMap& tk,
                                              const CUtensorMap& tv, float* __restrict__ o,
                                              float* __restrict__ lse, int Sq, int Sk, int H,
                                              int Hkv, float scale_log2, int causal) {
  static_assert(D == 64, "the wgmma design's S and P V are m64n64 products");
  using T = FwdF32<D>;
  constexpr int NWG = T::NWG, R = T::R, BLOCK = T::BLOCK, NT = T::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + R];  // Q, full[]
  unsigned char* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // [NWG] tiles
  unsigned char* sQl = sQ + NWG * BLOCK;  // Q's lo tiles (its hi tiles: sQ, split in place)
  unsigned char* ring = sQl + NWG * BLOCK;  // stage s: raw K, then raw V
  unsigned char* sK = ring + R * 2 * BLOCK;  // K's hi tile, then its lo tile
  unsigned char* sV = sK + 2 * BLOCK;  // V^T: [2 buffers][hi, lo]
  const uint32_t bar_q = smem_u32(&bars[0]), bar_full = smem_u32(&bars[1]);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2, t = lane & 3;
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hkv);
  const int q_first = (gridDim.y - 1 - blockIdx.y) * T::BR;  // the longest causal rows first
  const int n_iter = kv_tiles_f32(q_first, T::BR, Sq, Sk, causal);
  auto load_kv = [&](int j) {  // tile j's raw K and V into stage j % R
    const int s = j % R;
    mbar_expect_tx(bar_full + 8 * s, 2 * BLOCK);
    for (int c = 0; c < T::NCH; ++c) {
      tma_load(smem_u32(ring + 2 * s * BLOCK + c * kChunkBytes), &tk, bar_full + 8 * s, c * 32,
               hk, j * kF32Rows, b);
      tma_load(smem_u32(ring + (2 * s + 1) * BLOCK + c * kChunkBytes), &tv, bar_full + 8 * s,
               c * 32, hk, j * kF32Rows, b);
    }
  };
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < R; ++s) mbar_init(bar_full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, NWG * BLOCK);
    for (int w = 0; w < NWG; ++w)
      for (int c = 0; c < T::NCH; ++c)
        tma_load(smem_u32(sQ + w * BLOCK + c * kChunkBytes), &tq, bar_q, c * 32, h,
                 q_first + w * 64, b);
    for (int j = 0; j < R && j < n_iter; ++j) load_kv(j);
  }

  const int wg_first = q_first + wg * 64;
  // a warpgroup may end one tile before the CTA (the upper half of a causal
  // q tile); it still splits every tile with the others
  const int wg_iter = kv_tiles_f32(wg_first, 64, Sq, Sk, causal);
  const int row0 = wg_first + (warp & 3) * 16 + (lane >> 2);  // this lane's rows: row0, row0 + 8

  mbar_wait(bar_q, 0);
  for (int i = tid; i < NWG * BLOCK / 16; i += NT) {
    uint4 hi, lo;
    split4(reinterpret_cast<const float4*>(sQ)[i], hi, lo);
    reinterpret_cast<uint4*>(sQ)[i] = hi;
    reinterpret_cast<uint4*>(sQl)[i] = lo;
  }
  const uint32_t qh = smem_u32(sQ + wg * BLOCK), ql = smem_u32(sQl + wg * BLOCK);
  const uint32_t kh = smem_u32(sK), kl = kh + BLOCK;

  float acc[32], f[32], sc[32];
  uint32_t ph[8][4], pl[8][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = f[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f, c0 = 0.f, c1 = 0.f;
  // Iteration j splits tile j, issues S of tile j with O += P V of tile
  // j - 1, runs tile j's softmax while the latter is in flight, then adds
  // the latter's fresh accumulator to O.
  for (int j = 0; j <= n_iter; ++j) {
    if (j < n_iter) {
      __syncthreads();  // S of j - 1 and P V of j - 2 are done: K's and V^T[j % 2] are free
      const int s = j % R;
      mbar_wait(bar_full + 8 * s, (j / R) & 1);
      split_kv_tf32<D>(ring + 2 * s * BLOCK, sK, sV + (j & 1) * 2 * T::VT, tid);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // for the wgmma reads
      __syncthreads();  // every split tile of j is written, and stage s read
      if (tid == 0 && j + R < n_iter) load_kv(j + R);
    }
    const bool do_s = j < wg_iter, do_pv = j >= 1 && j <= wg_iter;
    if (!do_s && !do_pv) continue;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      reg_fence(ph[ks]);
      reg_fence(pl[ks]);
    }
    reg_fence(f);
    reg_fence(sc);
    wgmma_fence();
    if (do_s) issue_qk_tf32<T::NCH, kF32FwdTerms>(sc, qh, ql, kh, kl);
    if (do_pv) {
      const uint32_t vh = smem_u32(sV + ((j - 1) & 1) * 2 * T::VT);
      issue_pv_tf32<D, kF32FwdTerms>(f, ph, pl, vh, vh + T::VT);
    }
    const float cp0 = c0, cp1 = c1;  // tile j - 1's correction
    if (do_s) {
      if (do_pv)
        wgmma_wait<1>();  // S of tile j is in; P V of tile j - 1 may still run
      else
        wgmma_wait<0>();
      reg_fence(sc);
      const int k0 = j * kF32Rows;
      if (fwd_tile_masked(k0, Sk, wg_first, causal)) fwd_mask_tile(sc, k0, Sk, row0, causal, t);
      tile_softmax<false>(sc, m0, m1, l0, l1, c0, c1, scale_log2, 0, t);
    }
    if (do_pv) {
      wgmma_wait<0>();
      reg_fence(f);
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        reg_fence(ph[ks]);
        reg_fence(pl[ks]);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = acc[i] * (((i >> 1) & 1) ? cp1 : cp0) + f[i];
    }
    if (do_s) {
      const float(&p)[8][4] = reinterpret_cast<const float(&)[8][4]>(sc);
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) acc_to_a<8>(p, ks, ph[ks], pl[ks]);
    }
  }
  fwd_f32_epilogue<D>(reinterpret_cast<float(&)[D / 8][4]>(acc), m0, m1, l0, l1,
                      o + ((long long)b * Sq * H + h) * D, lse + ((long long)b * H + h) * Sq,
                      row0, Sq, H * D, t);
}

// B1 in f32, the mma.sync design (see the section's note).
template <int D>
__device__ __forceinline__ void fwd_f32_mma(const float* __restrict__ q,
                                            const float* __restrict__ k,
                                            const float* __restrict__ v, float* __restrict__ o,
                                            float* __restrict__ lse, int Sq, int Sk, int H,
                                            int Hkv, float scale_log2, int causal) {
  using T = FwdF32<D>;
  constexpr int BR = T::BR, R = T::R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  float* sQ = reinterpret_cast<float*>(smem_raw + 64);
  float* ring = sQ + BR * T::LD;  // stage s: K tile, then V tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;  // the longest causal rows first
  const int qstride = H * D, kstride = Hkv * D;
  const long long qhead = ((long long)b * Sq * H + h) * D;
  const float* kb = k + ((long long)b * Sk * Hkv + hk) * D;
  const float* vb = v + ((long long)b * Sk * Hkv + hk) * D;
  init_ring_bars<R>(bars);
  async_tile_f32<D, BR, T::NT, false>(sQ, q + qhead, q0, Sq, qstride, 0);
  auto issue = [&](int kt) {
    float* st = ring + (kt % R) * 2 * T::TILE;
    const uint32_t bar = smem_u32(bars + kt % R);
    if (kF32BulkRing && threadIdx.x == 0)
      mbar_expect_tx(bar, 2 * tile_bytes_f32(kt * kF32Rows, Sk, D));
    async_tile_f32<D, kF32Rows, T::NT, kF32BulkRing>(st, kb, kt * kF32Rows, Sk, kstride, bar);
    async_tile_f32<D, kF32Rows, T::NT, kF32BulkRing>(st + T::TILE, vb, kt * kF32Rows, Sk,
                                                     kstride, bar);
  };
  const int n_tiles = kv_tiles_f32(q0, BR, Sq, Sk, causal);
  ring_prologue<R>(n_tiles, issue);

  const int r = q0 + 16 * warp + g;  // this lane's rows: r and r + 8
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f, c0, c1;
  const float* sQw = sQ + 16 * warp * T::LD;
  for (int kt = 0; kt < n_tiles; ++kt) {
    ring_step<R>(kt, n_tiles, bars, issue);
    const float* kr = ring + (kt % R) * 2 * T::TILE;  // the stage's K, then V
    const int k0 = kt * kF32Rows;
    if (causal && k0 > q0 + 16 * warp + 15) continue;  // the tile lies above the warp's rows
    float s[8][4];
    mma_abt<D, 8, kF32FwdTerms, 0>(s, sQw, kr, g, t);
    float(&sc)[32] = reinterpret_cast<float(&)[32]>(s);
    if (fwd_tile_masked(k0, Sk, q0 + 16 * warp, causal)) fwd_mask_tile(sc, k0, Sk, r, causal, t);
    tile_softmax<false>(sc, m0, m1, l0, l1, c0, c1, scale_log2, 0, t);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= c0;
      acc[n][1] *= c0;
      acc[n][2] *= c1;
      acc[n][3] *= c1;
    }
    mma_pv<D, 8, kF32FwdTerms, 0>(acc, s, kr + T::TILE, g, t);
  }
  fwd_f32_epilogue<D>(acc, m0, m1, l0, l1, o + qhead, lse + ((long long)b * H + h) * Sq, r, Sq,
                      qstride, t);
}

// B1 in f32: the design kF32FwdWgmma picks (the tensor maps are used by the
// wgmma design, the pointers by the mma.sync one).
template <int D>
__global__ void __launch_bounds__(FwdF32<D>::NT, 1)
    flash_fwd_f32_kernel(__grid_constant__ const CUtensorMap tq,
                         __grid_constant__ const CUtensorMap tk,
                         __grid_constant__ const CUtensorMap tv, const float* __restrict__ q,
                         const float* __restrict__ k, const float* __restrict__ v,
                         float* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int H,
                         int Hkv, float scale_log2, int causal) {
  if constexpr (FwdF32<D>::WG)
    fwd_f32_wgmma<D>(tq, tk, tv, o, lse, Sq, Sk, H, Hkv, scale_log2, causal);
  else
    fwd_f32_mma<D>(q, k, v, o, lse, Sq, Sk, H, Hkv, scale_log2, causal);
}

// ---------------------------------------------------------------------------
// Host launchers

template <typename K>
int prepare(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// cuTensorMapEncodeTiled, fetched from the driver at first use, so the
// library links against the runtime only.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// The tensor map of a contiguous bf16 (or, with ``f32``, float32) [B, S,
// heads, D] tensor, boxes of ``rows`` rows x 128 bytes (64 bf16 or 32 f32
// columns) of one head, 128-byte swizzle; boxes past S arrive as zeros.
// Encoded on the host into ``map`` (the kernel takes it by value); nothing
// is allocated.
int tensor_map(CUtensorMap* map, const void* base, int B, int S, int heads, int D, int rows,
               bool f32 = false) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t e = f32 ? 4 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * e, (cuuint64_t)heads * D * e,
                                 (cuuint64_t)S * heads * D * e};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / e), 1, (cuuint32_t)rows, 1},
                   step[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        4, const_cast<void*>(base), dims,
                        strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// B1's dynamic shared memory: Q's chunks and the K/V ring, plus room to
// align the base to 1024 bytes (the 128-byte swizzle's period).
constexpr size_t fwd_smem(int D, int BQ) {
  return (size_t)(BQ / 64 + 2 * kStages) * (D / 64) * kChunkBytes + 1024;
}

template <int D, int BQ>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
               int Sq, int Sk, int H, int Hkv, int causal, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  if (int err = tensor_map(&tq, q, B, Sq, H, D, 64)) return err;
  if (int err = tensor_map(&tk, k, B, Sk, Hkv, D, 64)) return err;
  if (int err = tensor_map(&tv, v, B, Sk, Hkv, D, 64)) return err;
  const size_t smem = fwd_smem(D, BQ);
  auto kern = flash_fwd_kernel<D, BQ>;
  if (int err = prepare(kern, smem)) return err;
  dim3 grid(B * H, Sq / BQ);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  kern<<<grid, BQ * 2 + 32, smem, st>>>(tq, tk, tv, (bf16*)o, (float*)lse, Sq, Sk, H, Hkv,
                                        scale_log2, causal);
  return (int)cudaGetLastError();
}

// B2's and B3's dynamic shared memory: the CTA's two resident tiles (Q and
// dO, or K and V), the ring's two streamed tiles a stage, B3's lse and
// delta (512 bytes a stage), and room to align the base to 1024 bytes.
constexpr size_t dq_smem(int D, int BQ) {
  return (size_t)(2 * (BQ / 64) + 2 * kStages) * (D / 64) * kChunkBytes + 1024;
}
constexpr size_t dkv_smem(int D, int BKV) {
  return (size_t)(2 * (BKV / 64) + 2 * kStages) * (D / 64) * kChunkBytes + kStages * 512 + 1024;
}

// CTA rows of the backward kernels for a requested tile: at D = 128 always
// 64 (see the note before B2 and B3).
template <int D, int T>
constexpr int kBwdRows = D == 128 ? 64 : T;

template <int D, int T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int Sq, int Sk, int H,
              int Hkv, int causal, cudaStream_t st) {
  constexpr int BQ = kBwdRows<D, T>;
  CUtensorMap tq, tdo, tk, tv;
  if (int err = tensor_map(&tq, q, B, Sq, H, D, 64)) return err;
  if (int err = tensor_map(&tdo, dout, B, Sq, H, D, 64)) return err;
  if (int err = tensor_map(&tk, k, B, Sk, Hkv, D, 64)) return err;
  if (int err = tensor_map(&tv, v, B, Sk, Hkv, D, 64)) return err;
  const size_t smem = dq_smem(D, BQ);
  auto kern = flash_bwd_dq_kernel<D, BQ>;
  if (int err = prepare(kern, smem)) return err;
  dim3 grid(B * H, Sq / BQ);
  kern<<<grid, BQ * 2 + 32, smem, st>>>(
      tq, tdo, tk, tv, (const float*)lse, (const float*)delta, (bf16*)dq, Sq, Sk, H, Hkv,
      1.f / sqrtf((float)D), causal);
  return (int)cudaGetLastError();
}

template <int D, int T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B, int Sq,
               int Sk, int H, int Hkv, int causal, cudaStream_t st) {
  constexpr int BKV = kBwdRows<D, T>;
  CUtensorMap tq, tdo, tk, tv;
  if (int err = tensor_map(&tq, q, B, Sq, H, D, 64)) return err;
  if (int err = tensor_map(&tdo, dout, B, Sq, H, D, 64)) return err;
  if (int err = tensor_map(&tk, k, B, Sk, Hkv, D, 64)) return err;
  if (int err = tensor_map(&tv, v, B, Sk, Hkv, D, 64)) return err;
  const size_t smem = dkv_smem(D, BKV);
  auto kern = flash_bwd_dkv_kernel<D, BKV>;
  if (int err = prepare(kern, smem)) return err;
  dim3 grid(B * Hkv, Sk / BKV);
  kern<<<grid, BKV * 2 + 32, smem, st>>>(
      tq, tdo, tk, tv, (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, Sq, Sk, H,
      Hkv, 1.f / sqrtf((float)D), causal);
  return (int)cudaGetLastError();
}

// The f32 kernels' dynamic shared memory in bytes: B1's (kernel 0) Q's hi
// and lo tiles, the ring's raw K and V, K's and (twice) V^T's hi and lo
// tiles, and room to align the base to 1024 bytes (the wgmma design), or its
// barriers, Q and the ring's K and V (mma.sync); B2's (1)
// barriers, Q and dO, and the ring's K and V; B3's (2) barriers, K and V,
// the ring's Q, dO, lse and delta, and Q and dO split (and in the
// shared-memory dS arm, each warp's P/dS tile).
template <int D>
constexpr size_t f32_smem(int kernel) {
  using F = FwdF32<D>;
  using Q = BwdF32<D, false>;
  using K = BwdF32<D, true>;
  return kernel == 0
             ? (F::WG ? (size_t)(2 * F::NWG + 2 * F::R + 2) * F::BLOCK + 4 * F::VT + 1024
                      : 64 + sizeof(float) * (F::BR * F::LD + F::R * 2 * F::TILE))
         : kernel == 1
             ? 64 + sizeof(float) * ((2 * Q::BR + Q::RING * 2 * kF32Rows) * Q::LD + Q::PWS)
             : 64 + sizeof(float) * (2 * K::BR * K::LD + K::RING * (2 * K::TILE + 2 * kF32Rows) +
                                     (K::PRE ? 4 * K::TILE : 0) + K::PWS);
}

template <int D>
int launch_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                   int Sq, int Sk, int H, int Hkv, int causal, cudaStream_t st) {
  using T = FwdF32<D>;
  CUtensorMap tq{}, tk{}, tv{};
  if constexpr (T::WG) {
    if (int err = tensor_map(&tq, q, B, Sq, H, D, kF32Rows, true)) return err;
    if (int err = tensor_map(&tk, k, B, Sk, Hkv, D, kF32Rows, true)) return err;
    if (int err = tensor_map(&tv, v, B, Sk, Hkv, D, kF32Rows, true)) return err;
  }
  const size_t smem = f32_smem<D>(0);
  auto kern = flash_fwd_f32_kernel<D>;
  if (int err = prepare(kern, smem)) return err;
  dim3 grid(B * H, (Sq + T::BR - 1) / T::BR);
  kern<<<grid, T::NT, smem, st>>>(tq, tk, tv, (const float*)q, (const float*)k, (const float*)v,
                                  (float*)o, (float*)lse, Sq, Sk, H, Hkv,
                                  kLog2e / sqrtf((float)D), causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dq, int B, int Sq, int Sk, int H,
                  int Hkv, int causal, cudaStream_t st) {
  using T = BwdF32<D, false>;
  const size_t smem = f32_smem<D>(1);
  auto kern = flash_bwd_dq_f32_kernel<D>;
  if (int err = prepare(kern, smem)) return err;
  dim3 grid(B * H, (Sq + T::BR - 1) / T::BR);
  const float scale = 1.f / sqrtf((float)D);
  kern<<<grid, T::NT, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse,
      (const float*)delta, (float*)dq, Sq, Sk, H, Hkv, scale, scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, int B, int Sq,
                   int Sk, int H, int Hkv, int causal, cudaStream_t st) {
  using T = BwdF32<D, true>;
  const size_t smem = f32_smem<D>(2);
  auto kern = flash_bwd_dkv_f32_kernel<D>;
  if (int err = prepare(kern, smem)) return err;
  dim3 grid(B * Hkv, (Sk + T::BR - 1) / T::BR);
  const float scale = 1.f / sqrtf((float)D);
  kern<<<grid, T::NT, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse,
      (const float*)delta, (float*)dk, (float*)dv, Sq, Sk, H, Hkv, scale, scale * kLog2e,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes). The Python wrappers check shapes, types,
// divisibility and contiguity before calling; these return
// cudaErrorInvalidValue for a head dim or tile they were not built for.

// CALL(d, t) is defined around each use.
#define UCCL_DISPATCH(D_, T_)                        \
  if (D_ == 64 && T_ == 64) return CALL(64, 64);     \
  if (D_ == 64 && T_ == 128) return CALL(64, 128);   \
  if (D_ == 128 && T_ == 64) return CALL(128, 64);   \
  if (D_ == 128 && T_ == 128) return CALL(128, 128); \
  return (int)cudaErrorInvalidValue;

extern "C" int uccl_flash_fwd(const void* q, const void* k, const void* v, void* o,
                              void* lse, int B, int Sq, int Sk, int H, int Hkv, int D,
                              int causal, int block_q, void* stream) {
#define CALL(d, t) \
  launch_fwd<d, t>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, (cudaStream_t)stream)
  UCCL_DISPATCH(D, block_q)
#undef CALL
}

// Dynamic shared memory per CTA, in bytes (for the build report): B1's, and
// B2's (dkv = 0) or B3's (dkv = 1).
extern "C" int uccl_flash_fwd_smem(int D, int block_q) { return (int)fwd_smem(D, block_q); }
extern "C" int uccl_flash_bwd_smem(int dkv, int D, int tile) {
  const int rows = D == 128 ? 64 : tile;
  return (int)(dkv ? dkv_smem(D, rows) : dq_smem(D, rows));
}

extern "C" int uccl_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dq, int B, int Sq, int Sk, int H, int Hkv, int D,
                                 int causal, int block_q, void* stream) {
#define CALL(d, t)                                                             \
  launch_dq<d, t>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, Hkv, causal, \
                  (cudaStream_t)stream)
  UCCL_DISPATCH(D, block_q)
#undef CALL
}

extern "C" int uccl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dk, void* dv, int B, int Sq, int Sk, int H,
                                  int Hkv, int D, int causal, int block_k, void* stream) {
#define CALL(d, t)                                                                  \
  launch_dkv<d, t>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, Hkv, causal, \
                   (cudaStream_t)stream)
  UCCL_DISPATCH(D, block_k)
#undef CALL
}

// The f32 kernels: any sequence lengths, D = 64 or 128, 64-row tiles.
#define UCCL_DISPATCH_F32(D_)      \
  if (D_ == 64) return CALL(64);   \
  if (D_ == 128) return CALL(128); \
  return (int)cudaErrorInvalidValue;

extern "C" int uccl_flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int B, int Sq, int Sk, int H, int Hkv, int D,
                                  int causal, void* stream) {
#define CALL(d) launch_fwd_f32<d>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, (cudaStream_t)stream)
  UCCL_DISPATCH_F32(D)
#undef CALL
}

extern "C" int uccl_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dq, int B, int Sq, int Sk, int H, int Hkv, int D,
                                     int causal, void* stream) {
#define CALL(d)                                                                 \
  launch_dq_f32<d>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, Hkv, causal, \
                   (cudaStream_t)stream)
  UCCL_DISPATCH_F32(D)
#undef CALL
}

extern "C" int uccl_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv, int B, int Sq, int Sk, int H,
                                      int Hkv, int D, int causal, void* stream) {
#define CALL(d)                                                                      \
  launch_dkv_f32<d>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, Hkv, causal, \
                    (cudaStream_t)stream)
  UCCL_DISPATCH_F32(D)
#undef CALL
}

// Dynamic shared memory per CTA of f32 kernel 0 (B1), 1 (B2) or 2 (B3).
extern "C" int uccl_flash_f32_smem(int kernel, int D) {
  return D == 64 ? (int)f32_smem<64>(kernel) : D == 128 ? (int)f32_smem<128>(kernel) : 0;
}
