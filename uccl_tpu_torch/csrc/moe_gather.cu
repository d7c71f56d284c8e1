// The sorted MoE layer's dispatch and combine, for Hopper (sm_90a): one pair
// of row gathers, each backward the other's gather, with no accumulating
// scatter.
//
// Replaces no Pallas kernel. The JAX package's sorted dispatch and combine
// (uccl_tpu/ep/ops.py dispatch_sorted, combine_sorted) are jnp.take(...,
// mode="fill") and an einsum, left to XLA. Their direct translation, a
// gather from a copy of the rows padded with one zero row, has an
// accumulating index_put for its backward: PyTorch sorts the indices and
// adds each run of equal ones in series, and every empty slot and every
// dropped choice reads the one padding row.
//
// A slot plan (ep/ops.py SlotPlan) is a partial permutation between one
// member's (token, choice) pairs and its E*C expert slots: token_for_slot[s]
// is the token of slot s (T when it is empty), slot[t][k] the slot of choice
// (t, k) (E*C when it is dropped). Each occupied slot holds exactly one pair
// and each kept pair exactly one slot, so each gather's backward is a
// gather through the other map:
//
//   moe_gather_rows_kernel   dispatch forward, a warp a slot:
//                            xe[s] = x[token_for_slot[s]], zeros if empty
//   moe_gather_sum_kernel    combine forward, a warp a token:
//                            out[t] = sum_k w[t][k] y[slot[t][k]];
//                            with w = 1 the dispatch's backward:
//                            dx[t] = sum_k dxe[slot[t][k]]
//   moe_scatter_rows_kernel  combine backward, a warp a token:
//                            dy[slot[t][k]] = w[t][k] dout[t],
//                            dw[t][k] = <dout[t], y[slot[t][k]]>,
//                            and a mark on each slot it wrote
//   moe_scatter_zero_kernel  combine backward, a warp a slot: dy[s] = 0
//                            where no choice left a mark
//
// Every output row is written once, by one warp: no atomics, no sort.
// Sums run in float32 in the order k = 0, 1, ..., each product and each sum
// rounded once (__fmul_rn, __fadd_rn: nothing contracts), and a row is
// rounded to its dtype once, so the gathers and dy give the plain versions'
// bits (ep/gather.py); dw's dot products sum in another order than torch's.
// Dropped choices are skipped. One launch covers every member of a
// member-stacked [W, ...] tensor (the member is the row's leading index).
//
// Bound. Each kernel reads the rows it needs once and writes each output
// row once, with a few flops an element: HBM bandwidth bounds all four
// (3.35 TB/s on an H100 SXM). A warp moves its row (2 KiB at H = 1024, 8 KiB
// at H = 4096 in bf16) in 16-byte vectors, each lane with kUnroll of them in
// flight, so 64 resident warps an SM keep 128 KiB of loads outstanding. The
// row's slots and weights are loaded once, before the loop over H, lane j
// holding choice j, and broadcast by shuffles. Rows whose bytes are not a
// whole number of 16-byte vectors, or whose tensors are not 16-byte
// aligned, take the same kernels one element a lane.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows a block
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;  // vectors in flight a lane
constexpr int kMaxChoices = 32;  // choices a token: one lane each
constexpr unsigned kFull = 0xffffffffu;

enum DType { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V elements of T, moved by one load or store: 16 bytes, or one element
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T e[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> zeros() {
  Vec<T, V> z;
#pragma unroll
  for (int v = 0; v < V; ++v) z.e[v] = from_float<T>(0.f);
  return z;
}

__device__ __forceinline__ long long warp_row() {
  return (long long)blockIdx.x * kWarps + threadIdx.x / 32;
}

// Lane j < k takes choice j of token `row`: its slot (-1 when dropped) and
// its weight (1 without weights).
__device__ __forceinline__ void load_choices(const int* slot, const float* weights,
                                             long long row, int k, int slots, int lane,
                                             int& s, float& w) {
  s = -1;
  w = 1.f;
  if (lane < k) {
    const int v = slot[row * k + lane];
    s = (v >= 0 && v < slots) ? v : -1;
    if (weights != nullptr) w = weights[row * k + lane];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename T, int V>
__device__ __forceinline__ void zero_row(Vec<T, V>* dst, int nvec, int lane) {
  const Vec<T, V> z = zeros<T, V>();
  for (int i = lane; i < nvec; i += 32) dst[i] = z;
}

// rows = members * slots; out[s] = x[member][token_for_slot[s]], zeros when
// that token is out of [0, tokens)
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
moe_gather_rows_kernel(const T* __restrict__ x, const int* __restrict__ token_for_slot,
                       T* __restrict__ out, int tokens, int slots, long long rows, int nvec) {
  using R = Vec<T, V>;
  const long long row = warp_row();
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long member = row / slots;
  const int t = token_for_slot[row];
  R* dst = reinterpret_cast<R*>(out) + row * nvec;
  if (t < 0 || t >= tokens) {
    zero_row<T, V>(dst, nvec, lane);
    return;
  }
  const R* src = reinterpret_cast<const R*>(x) + (member * tokens + t) * nvec;
  for (int c = 0; c < nvec; c += 32 * kUnroll) {
    R r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = c + 32 * u + lane;
      if (i < nvec) r[u] = src[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = c + 32 * u + lane;
      if (i < nvec) dst[i] = r[u];
    }
  }
}

// rows = members * tokens; out[t] = sum_j w[t][j] src[member][slot[t][j]]
// over the kept choices, in float32, rounded once (weights may be null: 1)
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
moe_gather_sum_kernel(const T* __restrict__ src, const int* __restrict__ slot,
                      const float* __restrict__ weights, T* __restrict__ out, int tokens, int k,
                      int slots, long long rows, int nvec) {
  using R = Vec<T, V>;
  const long long row = warp_row();
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long member = row / tokens;
  int my_s;
  float my_w;
  load_choices(slot, weights, row, k, slots, lane, my_s, my_w);
  const R* base = reinterpret_cast<const R*>(src) + member * slots * nvec;
  R* dst = reinterpret_cast<R*>(out) + row * nvec;
  for (int c = 0; c < nvec; c += 32 * kUnroll) {  // warp-uniform: the shuffles below
    float acc[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[u][v] = 0.f;
    for (int j = 0; j < k; ++j) {
      const int s = __shfl_sync(kFull, my_s, j);
      const float w = __shfl_sync(kFull, my_w, j);
      if (s < 0) continue;
      const R* row_j = base + (long long)s * nvec;
      R r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = c + 32 * u + lane;
        if (i < nvec) r[u] = row_j[i];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (c + 32 * u + lane < nvec) {
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[u][v] = __fadd_rn(acc[u][v], __fmul_rn(w, to_float(r[u].e[v])));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = c + 32 * u + lane;
      if (i < nvec) {
        R o;
#pragma unroll
        for (int v = 0; v < V; ++v) o.e[v] = from_float<T>(acc[u][v]);
        dst[i] = o;
      }
    }
  }
}

// rows = members * tokens; for each kept choice j of token t:
// dy[member][slot[t][j]] = w[t][j] dout[t], dw[t][j] = <dout[t], y[...]>,
// marks[member][slot] = 1; dw = 0 for a dropped choice
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
moe_scatter_rows_kernel(const T* __restrict__ dout, const T* __restrict__ y,
                        const int* __restrict__ slot, const float* __restrict__ weights,
                        T* __restrict__ dy, float* __restrict__ dw, int* __restrict__ marks,
                        int tokens, int k, int slots, long long rows, int nvec) {
  using R = Vec<T, V>;
  const long long row = warp_row();
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long member = row / tokens;
  int my_s;
  float my_w;
  load_choices(slot, weights, row, k, slots, lane, my_s, my_w);
  const R* g = reinterpret_cast<const R*>(dout) + row * nvec;
  const R* y_base = reinterpret_cast<const R*>(y) + member * slots * nvec;
  R* dy_base = reinterpret_cast<R*>(dy) + member * slots * nvec;
  float my_dot = 0.f;  // lane j: choice j's dot product
  for (int c = 0; c < nvec; c += 32 * kUnroll) {  // warp-uniform: the shuffles below
    float d[kUnroll][V];
    {
      R r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = c + 32 * u + lane;
        if (i < nvec) r[u] = g[i];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int v = 0; v < V; ++v)
          d[u][v] = c + 32 * u + lane < nvec ? to_float(r[u].e[v]) : 0.f;
    }
    for (int j = 0; j < k; ++j) {
      const int s = __shfl_sync(kFull, my_s, j);
      const float w = __shfl_sync(kFull, my_w, j);
      if (s < 0) continue;
      const R* y_j = y_base + (long long)s * nvec;
      R* dy_j = dy_base + (long long)s * nvec;
      R r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = c + 32 * u + lane;
        if (i < nvec) r[u] = y_j[i];
      }
      float part = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = c + 32 * u + lane;
        if (i < nvec) {
          R o;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            part = fmaf(d[u][v], to_float(r[u].e[v]), part);
            o.e[v] = from_float<T>(__fmul_rn(w, d[u][v]));
          }
          dy_j[i] = o;
        }
      }
      part = warp_sum(part);
      if (lane == j) my_dot += part;
    }
  }
  if (lane < k) {
    dw[row * k + lane] = my_s >= 0 ? my_dot : 0.f;
    if (my_s >= 0) marks[member * slots + my_s] = 1;
  }
}

// rows = members * slots; dy[s] = 0 where no kept choice marked slot s
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
moe_scatter_zero_kernel(T* __restrict__ dy, const int* __restrict__ marks, long long rows,
                        int nvec) {
  const long long row = warp_row();
  if (row >= rows || marks[row]) return;
  zero_row<T, V>(reinterpret_cast<Vec<T, V>*>(dy) + row * nvec, nvec, threadIdx.x & 31);
}

unsigned blocks(long long rows) { return (unsigned)((rows + kWarps - 1) / kWarps); }

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// 16-byte vectors when every row is a whole number of them and every
// tensor starts on one, else one element a lane
template <typename T>
bool vectors(int hidden, const void* a, const void* b, const void* c = nullptr) {
  return (hidden * (int)sizeof(T)) % 16 == 0 && aligned16(a) && aligned16(b) &&
         (c == nullptr || aligned16(c));
}

template <typename T, int V>
int gather_rows(const void* x, const int* tfs, void* out, int tokens, int slots,
                long long rows, int hidden, cudaStream_t st) {
  moe_gather_rows_kernel<T, V><<<blocks(rows), kThreads, 0, st>>>(
      static_cast<const T*>(x), tfs, static_cast<T*>(out), tokens, slots, rows, hidden / V);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int gather_sum(const void* src, const int* slot, const float* weights, void* out, int tokens,
               int k, int slots, long long rows, int hidden, cudaStream_t st) {
  moe_gather_sum_kernel<T, V><<<blocks(rows), kThreads, 0, st>>>(
      static_cast<const T*>(src), slot, weights, static_cast<T*>(out), tokens, k, slots, rows,
      hidden / V);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int scatter_rows(const void* dout, const void* y, const int* slot, const float* weights,
                 void* dy, float* dw, int* marks, int members, int tokens, int k, int slots,
                 int hidden, cudaStream_t st) {
  const long long n_slots = (long long)members * slots, n_tokens = (long long)members * tokens;
  cudaError_t err = cudaMemsetAsync(marks, 0, n_slots * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  if (n_tokens > 0) {
    moe_scatter_rows_kernel<T, V><<<blocks(n_tokens), kThreads, 0, st>>>(
        static_cast<const T*>(dout), static_cast<const T*>(y), slot, weights,
        static_cast<T*>(dy), dw, marks, tokens, k, slots, n_tokens, hidden / V);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n_slots > 0)
    moe_scatter_zero_kernel<T, V><<<blocks(n_slots), kThreads, 0, st>>>(
        static_cast<T*>(dy), marks, n_slots, hidden / V);
  return (int)cudaGetLastError();
}

bool bad_sizes(int dtype, int members, int tokens, int slots, int hidden, int k) {
  return (dtype != kFloat32 && dtype != kBFloat16) || members < 0 || tokens < 0 || slots < 0 ||
         hidden < 1 || k < 1 || k > kMaxChoices;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 rows. Index tensors are int32, weights and dw
// float32, every tensor contiguous and member-stacked; weights may be null
// (all 1). Each returns 0, a cudaError_t, or -1 for arguments out of range.

// x [members, tokens, hidden], token_for_slot [members, slots] -> out
// [members, slots, hidden]
int uccl_moe_gather_rows(int dtype, const void* x, const int* token_for_slot, void* out,
                         int members, int tokens, int slots, int hidden, void* stream) {
  if (bad_sizes(dtype, members, tokens, slots, hidden, 1)) return -1;
  const long long rows = (long long)members * slots;
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return vectors<__nv_bfloat16>(hidden, x, out)
               ? gather_rows<__nv_bfloat16, 8>(x, token_for_slot, out, tokens, slots, rows,
                                               hidden, st)
               : gather_rows<__nv_bfloat16, 1>(x, token_for_slot, out, tokens, slots, rows,
                                               hidden, st);
  return vectors<float>(hidden, x, out)
             ? gather_rows<float, 4>(x, token_for_slot, out, tokens, slots, rows, hidden, st)
             : gather_rows<float, 1>(x, token_for_slot, out, tokens, slots, rows, hidden, st);
}

// src [members, slots, hidden], slot and weights [members, tokens, k] -> out
// [members, tokens, hidden]
int uccl_moe_gather_sum(int dtype, const void* src, const int* slot, const float* weights,
                        void* out, int members, int tokens, int k, int slots, int hidden,
                        void* stream) {
  if (bad_sizes(dtype, members, tokens, slots, hidden, k)) return -1;
  const long long rows = (long long)members * tokens;
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return vectors<__nv_bfloat16>(hidden, src, out)
               ? gather_sum<__nv_bfloat16, 8>(src, slot, weights, out, tokens, k, slots, rows,
                                              hidden, st)
               : gather_sum<__nv_bfloat16, 1>(src, slot, weights, out, tokens, k, slots, rows,
                                              hidden, st);
  return vectors<float>(hidden, src, out)
             ? gather_sum<float, 4>(src, slot, weights, out, tokens, k, slots, rows, hidden, st)
             : gather_sum<float, 1>(src, slot, weights, out, tokens, k, slots, rows, hidden, st);
}

// dout [members, tokens, hidden], y [members, slots, hidden], slot and
// weights [members, tokens, k] -> dy [members, slots, hidden], dw [members,
// tokens, k]; marks [members, slots] int32 is scratch
int uccl_moe_scatter_rows(int dtype, const void* dout, const void* y, const int* slot,
                          const float* weights, void* dy, float* dw, int* marks, int members,
                          int tokens, int k, int slots, int hidden, void* stream) {
  if (bad_sizes(dtype, members, tokens, slots, hidden, k)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return vectors<__nv_bfloat16>(hidden, dout, y, dy)
               ? scatter_rows<__nv_bfloat16, 8>(dout, y, slot, weights, dy, dw, marks, members,
                                                tokens, k, slots, hidden, st)
               : scatter_rows<__nv_bfloat16, 1>(dout, y, slot, weights, dy, dw, marks, members,
                                                tokens, k, slots, hidden, st);
  return vectors<float>(hidden, dout, y, dy)
             ? scatter_rows<float, 4>(dout, y, slot, weights, dy, dw, marks, members, tokens, k,
                                      slots, hidden, st)
             : scatter_rows<float, 1>(dout, y, slot, weights, dy, dw, marks, members, tokens, k,
                                      slots, hidden, st);
}

}  // extern "C"
