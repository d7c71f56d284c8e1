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
// This first version keeps them simple and right: mma.sync m16n8k16 bf16
// products with f32 accumulation, the online softmax and the backward row
// terms in registers, and one synchronous shared-memory stage for the
// streamed tile. wgmma, TMA and a multi-stage pipeline are later work.
//
// Semantics kept from the Pallas kernels: the finite mask value -1e30 and the
// row-sum floor 1e-20 (so no row becomes NaN), causal masking with aligned
// positions (q position >= k position), scale 1 / sqrt(D), f32 lse, dq in
// q's type and dk/dv in k's type.
//
// Each C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // pallas_attention.py _NEG_INF
constexpr int kPad = 8;            // bf16 padding per shared-memory row
constexpr int kTile = 64;          // rows of the streamed tile in every kernel

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
// B1. Forward. Replaces pallas_attention.py::_fwd_kernel.
//
// One CTA per (batch*head, q tile of BQ rows); each warp owns 16 q rows. The
// loop over KV tiles takes the place of the TPU's sequential jk grid axis and
// its VMEM scratch carry: the running max, row sum and output accumulator
// live in registers for the whole loop. Causal CTAs stop at the last KV tile
// that holds a position <= their last q row. Heavier (later) q tiles are
// scheduled first.

template <int D, int BQ>
__global__ void __launch_bounds__(BQ * 2)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int H, int Hkv,
                     float scale, int causal) {
  constexpr int BK = kTile, NT = BQ * 2, LD = D + kPad;
  constexpr int KC = D / 16, NS = BK / 8, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* sK = sQ + BQ * LD;                       // [BK][LD]
  bf16* sV = sK + BK * LD;                       // [BK][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int iq = gridDim.y - 1 - blockIdx.y;
  const long long q_pitch = (long long)H * D, k_pitch = (long long)Hkv * D;
  const int q_first = iq * BQ;

  load_tile<BQ, D, NT>(sQ, q + ((long long)b * Sq + q_first) * q_pitch + (long long)h * D,
                       q_pitch, tid);
  __syncthreads();
  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) load_a(qf[kc], sQ, LD, warp * 16, kc * 16, g, t);

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const int row0 = q_first + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  const int n_kv = Sk / BK;
  const int n_iter = causal ? min(n_kv, (q_first + BQ - 1) / BK + 1) : n_kv;
  const bf16* kg = k + (long long)b * Sk * k_pitch + (long long)hk * D;
  const bf16* vg = v + (long long)b * Sk * k_pitch + (long long)hk * D;

  for (int j = 0; j < n_iter; ++j) {
    __syncthreads();
    load_tile<BK, D, NT>(sK, kg + (long long)j * BK * k_pitch, k_pitch, tid);
    load_tile<BK, D, NT>(sV, vg + (long long)j * BK * k_pitch, k_pitch, tid);
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t b0, b1;
        load_b(b0, b1, sK, LD, n * 8, kc * 16, g, t);
        mma16816(s[n], qf[kc], b0, b1);
      }
    }
    const bool masked = causal && (j * BK + BK - 1 > q_first);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (masked) {
          const int col = j * BK + n * 8 + 2 * t + (e & 1);
          const int row = row0 + ((e >> 1) << 3);
          if (col > row) x = kNegInf;
        }
        s[n][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float c0 = __expf(m0 - mx0), c1 = __expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = __expf(s[n][0] - m0);
      s[n][1] = __expf(s[n][1] - m0);
      s[n][2] = __expf(s[n][2] - m1);
      s[n][3] = __expf(s[n][3] - m1);
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= c0;
      acc[n][1] *= c0;
      acc[n][2] *= c1;
      acc[n][3] *= c1;
    }
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t a[4];
      acc_to_a<NS>(a, s, kc);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t bb[4];
        load_b_trans2(bb, sV, LD, kc * 16, n * 8, lane);
        mma16816(acc[n], a, bb[0], bb[1]);
        mma16816(acc[n + 1], a, bb[2], bb[3]);
      }
    }
  }

  l0 = fmaxf(quad_sum(l0), 1e-20f);
  l1 = fmaxf(quad_sum(l1), 1e-20f);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  bf16* o0 = o + ((long long)b * Sq + row0) * q_pitch + (long long)h * D + 2 * t;
  bf16* o1 = o0 + 8 * q_pitch;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<uint32_t*>(o0 + n * 8) = pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    *reinterpret_cast<uint32_t*>(o1 + n * 8) = pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  if (t == 0) {
    float* lr = lse + (long long)bh * Sq;
    lr[row0] = m0 + logf(l0);
    lr[row0 + 8] = m1 + logf(l1);
  }
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

template <int D, int BQ>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
               int Sq, int Sk, int H, int Hkv, int causal, cudaStream_t st) {
  const size_t smem = (size_t)(BQ + 2 * kTile) * (D + kPad) * sizeof(bf16);
  auto kern = flash_fwd_kernel<D, BQ>;
  if (int err = prepare(kern, smem)) return err;
  dim3 grid(B * H, Sq / BQ);
  kern<<<grid, BQ * 2, smem, st>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                   (bf16*)o, (float*)lse, Sq, Sk, H, Hkv,
                                   1.f / sqrtf((float)D), causal);
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
