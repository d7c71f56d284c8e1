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
// The forward (redesigned in PR 5) runs on wgmma with a TMA-fed, multi-stage
// K/V ring and a producer warp; its note below says how. The two backward
// kernels are still PR 1's simple and right first version: mma.sync
// m16n8k16 bf16 products with f32 accumulation, the backward row terms in
// registers, and one synchronous shared-memory stage for the streamed tile.
//
// Semantics kept from the Pallas kernels: the finite mask value -1e30 and the
// row-sum floor 1e-20 (so no row becomes NaN), causal masking with aligned
// positions (q position >= k position), scale 1 / sqrt(D), f32 lse, dq in
// q's type and dk/dv in k's type.
//
// Each C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 on success). The forward's tensor maps are
// encoded on the host per call and passed by value.

#include <cuda.h>  // CUtensorMap and its enums; the driver call itself is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // pallas_attention.py _NEG_INF
constexpr int kPad = 8;            // bf16 padding per shared-memory row (B2, B3)
constexpr int kTile = 64;          // rows of the streamed tile (B2, B3; B1's is 64 too)

// ---------------------------------------------------------------------------
// Small device helpers

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D[16x8] += A[16x16] * B[16x8], bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices, transposed on the way into registers.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3,
                                              const bf16* p) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// A operand (16 rows x 16 k) of a row-major shared tile: rows row0..row0+15,
// k columns k0..k0+15. Lane (g = lane/4, t = lane%4) holds rows g and g+8,
// columns 2t, 2t+1 and 2t+8, 2t+9.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s, int ld,
                                       int row0, int k0, int g, int t) {
  const bf16* p = s + (row0 + g) * ld + k0 + 2 * t;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * ld);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * ld + 8);
}

// B operand (16 k x 8 n) whose n index runs over the ROWS of a row-major
// shared tile and whose k index runs along the row (B = tile^T).
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1, const bf16* s,
                                       int ld, int n0, int k0, int g, int t) {
  const bf16* p = s + (n0 + g) * ld + k0 + 2 * t;
  b0 = lds32(p);
  b1 = lds32(p + 8);
}

// B operands for two n-tiles (n0, n0+8) whose k index runs over the ROWS of a
// row-major shared tile (B = tile): k rows k0..k0+15, columns n0..n0+15.
__device__ __forceinline__ void load_b_trans2(uint32_t (&b)[4], const bf16* s,
                                              int ld, int k0, int n0, int lane) {
  ldsm_x4_trans(b[0], b[1], b[2], b[3],
                s + (k0 + (lane & 15)) * ld + n0 + ((lane >> 4) << 3));
}

// The accumulator of a 16 x 8n product, as the A operand of the next product
// (k over the accumulator's columns 16*kc .. 16*kc+15), rounded to bf16.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c)[N][4],
                                         int kc) {
  a[0] = pack_bf16(c[2 * kc][0], c[2 * kc][1]);
  a[1] = pack_bf16(c[2 * kc][2], c[2 * kc][3]);
  a[2] = pack_bf16(c[2 * kc + 1][0], c[2 * kc + 1][1]);
  a[3] = pack_bf16(c[2 * kc + 1][2], c[2 * kc + 1][3]);
}

// Copy ROWS rows of D bf16 (row pitch gpitch elements) into a shared tile
// with row stride D + kPad, 16 bytes per thread per step.
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, long long gpitch,
                                          int tid) {
  constexpr int CH = D / 8;
  constexpr int LD = D + kPad;
#pragma unroll
  for (int i = tid; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    *reinterpret_cast<uint4*>(s + r * LD + c * 8) =
        *reinterpret_cast<const uint4*>(g + r * gpitch + c * 8);
  }
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
// Hopper primitives for B1: mbarriers, TMA, wgmma

constexpr int kChunkBytes = 64 * 128;  // one [64 rows][64 bf16] swizzled chunk
constexpr int kStages = 4;             // K/V tiles in flight in B1's ring
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
// past kWaitNs traps: a fault in the pipeline ends the launch with an error
// instead of hanging the card.
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
// B1's steps, for one consumer warpgroup and one KV tile of 64 columns

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
// B2. dQ. Replaces pallas_attention.py::_bwd_dq_kernel.
//
// One CTA per (batch*head, q tile); each warp owns 16 q rows and keeps its Q
// and dO operands and the dQ accumulator in registers while it streams the
// KV tiles. P = exp(S*scale - lse) is recomputed from the saved lse;
// delta = rowsum(dO*O) - g_lse comes in precomputed (one torch expression, as
// it was XLA code outside the Pallas kernels).

template <int D, int BQ>
__global__ void __launch_bounds__(BQ * 2)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int Sq, int Sk, int H, int Hkv,
                        float scale, int causal) {
  constexpr int BK = kTile, NT = BQ * 2, LD = D + kPad;
  constexpr int KC = D / 16, NS = BK / 8, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* sO = sQ + BQ * LD;                       // [BQ][LD] dO
  bf16* sK = sO + BQ * LD;                       // [BK][LD]
  bf16* sV = sK + BK * LD;                       // [BK][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int iq = gridDim.y - 1 - blockIdx.y;
  const long long q_pitch = (long long)H * D, k_pitch = (long long)Hkv * D;
  const int q_first = iq * BQ;
  const long long q_off = ((long long)b * Sq + q_first) * q_pitch + (long long)h * D;

  load_tile<BQ, D, NT>(sQ, q + q_off, q_pitch, tid);
  load_tile<BQ, D, NT>(sO, dout + q_off, q_pitch, tid);
  __syncthreads();
  uint32_t qf[KC][4], of[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    load_a(qf[kc], sQ, LD, warp * 16, kc * 16, g, t);
    load_a(of[kc], sO, LD, warp * 16, kc * 16, g, t);
  }
  const int row0 = q_first + warp * 16 + g;
  const float lse0 = lse[(long long)bh * Sq + row0], lse1 = lse[(long long)bh * Sq + row0 + 8];
  const float dl0 = delta[(long long)bh * Sq + row0], dl1 = delta[(long long)bh * Sq + row0 + 8];

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int n_kv = Sk / BK;
  const int n_iter = causal ? min(n_kv, (q_first + BQ - 1) / BK + 1) : n_kv;
  const bf16* kg = k + (long long)b * Sk * k_pitch + (long long)hk * D;
  const bf16* vg = v + (long long)b * Sk * k_pitch + (long long)hk * D;

  for (int j = 0; j < n_iter; ++j) {
    __syncthreads();
    load_tile<BK, D, NT>(sK, kg + (long long)j * BK * k_pitch, k_pitch, tid);
    load_tile<BK, D, NT>(sV, vg + (long long)j * BK * k_pitch, k_pitch, tid);
    __syncthreads();

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t b0, b1;
        load_b(b0, b1, sK, LD, n * 8, kc * 16, g, t);
        mma16816(s[n], qf[kc], b0, b1);
        load_b(b0, b1, sV, LD, n * 8, kc * 16, g, t);
        mma16816(dp[n], of[kc], b0, b1);
      }
    }
    const bool masked = causal && (j * BK + BK - 1 > q_first);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1;
        float p = __expf(s[n][e] * scale - (hi ? lse1 : lse0));
        if (masked) {
          const int col = j * BK + n * 8 + 2 * t + (e & 1);
          if (col > row0 + (hi << 3)) p = 0.f;
        }
        s[n][e] = p * (dp[n][e] - (hi ? dl1 : dl0)) * scale;  // dS
      }
    }
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t a[4];
      acc_to_a<NS>(a, s, kc);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t bb[4];
        load_b_trans2(bb, sK, LD, kc * 16, n * 8, lane);
        mma16816(acc[n], a, bb[0], bb[1]);
        mma16816(acc[n + 1], a, bb[2], bb[3]);
      }
    }
  }

  bf16* d0 = dq + ((long long)b * Sq + row0) * q_pitch + (long long)h * D + 2 * t;
  bf16* d1 = d0 + 8 * q_pitch;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<uint32_t*>(d0 + n * 8) = pack_bf16(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(d1 + n * 8) = pack_bf16(acc[n][2], acc[n][3]);
  }
}

// ---------------------------------------------------------------------------
// B3. dK and dV. Replaces pallas_attention.py::_bwd_dkv_kernel.
//
// One CTA per (batch, KV head, KV tile of BKV rows); each warp owns 16 KV
// rows and keeps its dK and dV accumulators in registers. The CTA loops over
// the n_rep query heads of its GQA group and, for each, over the q tiles at
// or after its KV tile (causal), so the GQA sum happens in registers: no
// f32 [B*H, S, D] dk/dv round trip and no fold afterwards, and no atomics.
// Heavier (earlier) KV tiles are scheduled first.

template <int D, int BKV>
__global__ void __launch_bounds__(BKV * 2)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk,
                         int H, int Hkv, float scale, int causal) {
  constexpr int BQ = kTile, NT = BKV * 2, LD = D + kPad;
  constexpr int KC = D / 16, NS = BQ / 8, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [BKV][LD]
  bf16* sV = sK + BKV * LD;                      // [BKV][LD]
  bf16* sQ = sV + BKV * LD;                      // [BQ][LD]
  bf16* sO = sQ + BQ * LD;                       // [BQ][LD] dO
  float* sL = reinterpret_cast<float*>(sO + BQ * LD);  // [BQ] lse
  float* sD = sL + BQ;                                 // [BQ] delta

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bhk = blockIdx.x, b = bhk / Hkv, hk = bhk % Hkv, n_rep = H / Hkv;
  const int jk = blockIdx.y;
  const long long q_pitch = (long long)H * D, k_pitch = (long long)Hkv * D;
  const int k_first = jk * BKV, k_last = k_first + BKV - 1;
  const long long k_off = ((long long)b * Sk + k_first) * k_pitch + (long long)hk * D;

  load_tile<BKV, D, NT>(sK, k + k_off, k_pitch, tid);
  load_tile<BKV, D, NT>(sV, v + k_off, k_pitch, tid);

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }
  const int krow0 = k_first + warp * 16 + g;  // this lane's KV rows: krow0, krow0 + 8
  const int n_q = Sq / BQ;
  const int i0 = causal ? k_first / BQ : 0;

  for (int r = 0; r < n_rep; ++r) {
    const int h = hk * n_rep + r;
    const float* lrow = lse + ((long long)b * H + h) * Sq;
    const float* drow = delta + ((long long)b * H + h) * Sq;
    for (int i = i0; i < n_q; ++i) {
      const int q_first = i * BQ;
      __syncthreads();
      const long long q_off = ((long long)b * Sq + q_first) * q_pitch + (long long)h * D;
      load_tile<BQ, D, NT>(sQ, q + q_off, q_pitch, tid);
      load_tile<BQ, D, NT>(sO, dout + q_off, q_pitch, tid);
      for (int x = tid; x < BQ; x += NT) {
        sL[x] = lrow[q_first + x];
        sD[x] = drow[q_first + x];
      }
      __syncthreads();

      // S^T = K Q^T for this warp's 16 KV rows x BQ q columns.
      float st[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t a[4];
        load_a(a, sK, LD, warp * 16, kc * 16, g, t);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          uint32_t b0, b1;
          load_b(b0, b1, sQ, LD, n * 8, kc * 16, g, t);
          mma16816(st[n], a, b0, b1);
        }
      }
      const bool masked = causal && (q_first < k_last);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t + (e & 1);
          float p = __expf(st[n][e] * scale - sL[c]);
          if (masked && q_first + c < krow0 + ((e >> 1) << 3)) p = 0.f;
          st[n][e] = p;  // P^T
        }
      }
      // dV += P^T dO
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
        uint32_t a[4];
        acc_to_a<NS>(a, st, kc);
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t bb[4];
          load_b_trans2(bb, sO, LD, kc * 16, n * 8, lane);
          mma16816(dva[n], a, bb[0], bb[1]);
          mma16816(dva[n + 1], a, bb[2], bb[3]);
        }
      }
      // dP^T = V dO^T, then dS^T = P^T (dP^T - delta) * scale
      float dp[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t a[4];
        load_a(a, sV, LD, warp * 16, kc * 16, g, t);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          uint32_t b0, b1;
          load_b(b0, b1, sO, LD, n * 8, kc * 16, g, t);
          mma16816(dp[n], a, b0, b1);
        }
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t + (e & 1);
          dp[n][e] = st[n][e] * (dp[n][e] - sD[c]) * scale;
        }
      }
      // dK += dS^T Q
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
        uint32_t a[4];
        acc_to_a<NS>(a, dp, kc);
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t bb[4];
          load_b_trans2(bb, sQ, LD, kc * 16, n * 8, lane);
          mma16816(dka[n], a, bb[0], bb[1]);
          mma16816(dka[n + 1], a, bb[2], bb[3]);
        }
      }
    }
  }

  const long long out0 = ((long long)b * Sk + krow0) * k_pitch + (long long)hk * D + 2 * t;
  const long long out1 = out0 + 8 * k_pitch;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<uint32_t*>(dk + out0 + n * 8) = pack_bf16(dka[n][0], dka[n][1]);
    *reinterpret_cast<uint32_t*>(dk + out1 + n * 8) = pack_bf16(dka[n][2], dka[n][3]);
    *reinterpret_cast<uint32_t*>(dv + out0 + n * 8) = pack_bf16(dva[n][0], dva[n][1]);
    *reinterpret_cast<uint32_t*>(dv + out1 + n * 8) = pack_bf16(dva[n][2], dva[n][3]);
  }
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

template <int D, int BQ>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int Sq, int Sk, int H,
              int Hkv, int causal, cudaStream_t st) {
  const size_t smem = (size_t)(2 * BQ + 2 * kTile) * (D + kPad) * sizeof(bf16);
  auto kern = flash_bwd_dq_kernel<D, BQ>;
  if (int err = prepare(kern, smem)) return err;
  dim3 grid(B * H, Sq / BQ);
  kern<<<grid, BQ * 2, smem, st>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                   (const bf16*)dout, (const float*)lse,
                                   (const float*)delta, (bf16*)dq, Sq, Sk, H, Hkv,
                                   1.f / sqrtf((float)D), causal);
  return (int)cudaGetLastError();
}

template <int D, int BKV>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B, int Sq,
               int Sk, int H, int Hkv, int causal, cudaStream_t st) {
  const size_t smem = (size_t)(2 * BKV + 2 * kTile) * (D + kPad) * sizeof(bf16) +
                      2 * kTile * sizeof(float);
  auto kern = flash_bwd_dkv_kernel<D, BKV>;
  if (int err = prepare(kern, smem)) return err;
  dim3 grid(B * Hkv, Sk / BKV);
  kern<<<grid, BKV * 2, smem, st>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                    (const bf16*)dout, (const float*)lse,
                                    (const float*)delta, (bf16*)dk, (bf16*)dv, Sq, Sk, H,
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

// B1's dynamic shared memory per CTA, in bytes (for the build report).
extern "C" int uccl_flash_fwd_smem(int D, int block_q) { return (int)fwd_smem(D, block_q); }

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
