// Flash attention for Hopper (sm_90a): forward, dQ backward and dK/dV backward.
//
// These three kernels replace the Pallas TPU kernels of
// uccl_tpu/ops/pallas_attention.py: _fwd_kernel (B1), _bwd_dq_kernel (B2) and
// _bwd_dkv_kernel (B3). They compute the same functions; the block structure
// is Hopper's own.
//
// Layout. q/out/dout/dq are [B, Sq, H, D] and k/v/dk/dv are [B, Sk, Hkv, D],
// contiguous bf16, read in place: a D = 64 bf16 row is 128 contiguous bytes,
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

// The tensor map of a contiguous bf16 [B, S, heads, D] tensor, boxes of
// ``rows`` rows x 64 columns of one head, 128-byte swizzle. Encoded on the
// host into ``map`` (the kernel takes it by value); nothing is allocated.
int tensor_map(CUtensorMap* map, const void* base, int B, int S, int heads, int D, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1}, step[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
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
