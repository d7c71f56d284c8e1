// Ring collectives over a W-member world: all-gather (B4), reduce-scatter
// (B5) and the fused all-reduce (B7), and the two whose wire is quantized
// (B6, B8), for Hopper (sm_90a).
//
// Replaces the Pallas remote-DMA kernels of uccl_tpu/collective/pallas_ccl.py:
//   ring_ag_kernel        <- _ag_ring (pallas_ccl.py:434, call :450)
//   ring_rs_kernel<T>     <- ring_reduce_scatter's full-precision kernel (:546, call :593)
//   ring_ar_kernel<T>     <- ring_all_reduce's full-precision kernel (:645, call :710)
//   ring_rsq_kernel<T,W>  <- ring_reduce_scatter's quantized kernel (:621, call :632)
//   ring_arq_kernel<T,W>  <- ring_all_reduce's quantized kernel (:742, call :773)
//
// Members. Each kernel takes a table of per-member base addresses into a
// symmetric arena: inputs, data slots, 2-slot staging and flag words. One
// launch runs every member of the world: blockIdx.y is the member, and
// blockIdx.x splits each chunk slot into independent channels (and, for B7,
// the two counter-rotating streams), each with its own flags, so many SMs
// move each member's bytes. On one card every address in the table lies in
// the same HBM, so a "hop" is an HBM-to-HBM store; members on separate cards
// need only another table (peer or IPC addresses) and the .sys memory scope.
//
// Schedule, exactly the JAX package's slot arithmetic (d = direction):
//   AG step s sends slot (r - d*s) mod n straight into the right
//     neighbor's slot of the same index (write-once slots);
//   RS step s sends slot (r - d*(s+1)) mod n into the right neighbor's
//     staging slot s%2, and folds the partial that arrives from the left
//     into slot (r - d*(s+2)) mod n, in the input dtype, one rounding per
//     hop (buf + stage, pallas_ccl.py:242);
//   B7 runs the RS phase, a phase barrier, then the AG phase, on a payload
//     laid out slot-major, then by stream ([n][S][m], pallas_ccl.py:673-676).
//
// Synchronization. The TPU kernels' DMA, credit and barrier semaphores
// become 64-bit flag words holding (epoch << 32) | count. A sender stores its
// data, then the count with st.release.gpu; the receiver spins with
// ld.acquire.gpu until the flag reaches (epoch << 32) | target. Each flag has
// exactly one writer and only grows within a launch, and the host gives
// every launch on a flag region a new epoch, so a stale flag from an earlier
// launch can never let a wait through (no signal/wait balance is needed).
// Credit window as in pallas_ccl.py:172-197: two staging slots start free,
// and from step 2 on a sender waits until its right neighbor has consumed
// step s-2. Entry barrier with both neighbors; B7 keeps the phase barrier
// (its AG stores into the right neighbor's slots only after that neighbor's
// RS phase, which reads and folds those slots, is done).
//
// Deadlock and faults, as csrc/collective.cuh sets out for every collective
// kernel: cooperative launches on at most half the card (the two kernels of
// a bidirectional pair can both be resident), and every spin bounded by
// %globaltimer with an error word (kernel, member, step, collective id,
// stream, channel, which wait) that the host wrapper raises on.
//
// Quantized wire (B6, B8; wire = fp8 e4m3fn or int8). Every RS hop crosses
// block-quantized: the sender computes each 128-element row's amax and f32
// scale (uccl_tpu/ops/quant.py's rule: scale = amax * (1 / QMAX) floored at
// the smallest normal f32, 1.0 for an all-zero row, +inf for a row holding
// any inf or nan), and writes the 1-byte payload and the row's scale straight
// into the right neighbor's staging slot s%2. The TPU kernel's send scratch
// (qsend, ssend) and its second DMA semaphore set have no counterpart:
// payload and scales of a hop ride ONE release flag. The receiver
// dequantizes (payload * scale, rounded to the input dtype) and adds in the
// input dtype with one correctly rounded add: partial sums never live in
// wire precision. One warp owns a row (32 lanes x 4 values) and reduces its
// amax with shuffles; a channel covers whole rows. B8 then quantizes its
// reduced slot ONCE, forwards payload and scale bytes verbatim (write-once
// slots), and dequantizes EVERY slot, its own included, from the wire
// bytes, so all members end bit-identical. The codec is plain CUDA
// arithmetic here: an IEEE division by the scale, __fmul_rn/__fadd_rn so
// that no multiply and add contract into an fma, no fast-math.
//
// Bound. All five move bytes and do a handful of operations per element per
// hop: HBM bandwidth bounds them (3.35 TB/s on an H100 SXM). Copies and
// folds use 16-byte vector loads and stores through L2 (ld.global.cg /
// st.global.cg), since staging slots are rewritten every other step by
// another SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <math_constants.h>
#include <stdint.h>

#include "collective.cuh"

namespace {

using namespace uccl;

constexpr int kFlagWords = 4;  // recv, ack, phase, entry

constexpr int kWarps = kThreads / 32;
// Rows a warp has in flight. The quantized kernels are built for two blocks
// per SM (64 registers a thread), like B5 and B7: at one block per SM the
// cooperative grid has half the blocks and the kernels run 1.4-1.5x slower
// (measured). Three rows fit those registers; four spill in B8.
constexpr int kRowUnroll = 3;
constexpr int kLanes = 128;     // elements of one quantization row
constexpr float kScaleTiny = 1.17549435e-38f;  // smallest normal f32

enum Kernel { kAG = 0, kRS = 1, kAR = 2, kRSQ = 3, kARQ = 4 };
enum Wire { kFp8 = 0, kInt8 = 1 };
enum Wait { kWaitEntry = 0, kWaitCredit = 1, kWaitRecv = 2, kWaitPhase = 3 };

struct RingArgs {
  const char* x[kMaxMembers];        // member inputs
  char* buf[kMaxMembers];            // member data slots ([n][S][slot_bytes])
  char* stage[kMaxMembers];          // member staging ([S][2][slot_bytes])
  char* out[kMaxMembers];            // B5: member output ([slot_bytes])
  unsigned long long* flags[kMaxMembers];  // member flags ([2][kMaxChannels][kFlagWords])
  // quantized wire: B6/B8 stage payload bytes in ``stage`` ([S][2][m]) and
  // row scales in ``sstage`` ([S][2][srow]); B8 gathers into ``qbuf``
  // ([n][S][m]) and ``sbuf`` ([n][S][srow])
  float* sstage[kMaxMembers];
  char* qbuf[kMaxMembers];
  float* sbuf[kMaxMembers];
  long long rows, srow;              // rows of a slot; f32 scales per scale slot
  int* err;                          // error word of the flag region: 8 ints
  long long slot_bytes;              // bytes of one chunk slot of one stream
  int n, S, C;                       // world, streams, channels
  int dir[2];                        // direction of each stream
  int cid, kernel;
  unsigned long long epoch;
  unsigned long long timeout_ns;
};

__device__ __forceinline__ unsigned long long* flag(const RingArgs& a, int member, int h,
                                                    int c, int word) {
  return a.flags[member] + ((size_t)h * kMaxChannels + c) * kFlagWords + word;
}

__device__ __forceinline__ unsigned long long mark(const RingArgs& a, long long count) {
  return (a.epoch << 32) | (unsigned long long)count;
}

// All threads: spin (thread 0) until *f >= target. False when the wait timed
// out or another block of the launch already failed; the caller returns.
__device__ bool wait_geq(const RingArgs& a, const unsigned long long* f,
                         unsigned long long target, int member, int h, int c, int step,
                         int what) {
  __shared__ int ok;
  __syncthreads();  // every thread has read the previous wait's verdict
  if (threadIdx.x == 0)
    ok = spin_geq(f, target, a.err, a.timeout_ns, {a.kernel, member, step, a.cid, h, c, what});
  __syncthreads();
  return ok != 0;
}

__device__ __forceinline__ int mod(int v, int n) { return ((v % n) + n) % n; }

// Element-wise a + b of two 16-byte vectors in T, correctly rounded once.
template <typename T> __device__ __forceinline__ int4 add16(int4 a, int4 b);

template <> __device__ __forceinline__ int4 add16<float>(int4 a, int4 b) {
  float4 x = *reinterpret_cast<float4*>(&a), y = *reinterpret_cast<float4*>(&b), z;
  z.x = __fadd_rn(x.x, y.x); z.y = __fadd_rn(x.y, y.y);
  z.z = __fadd_rn(x.z, y.z); z.w = __fadd_rn(x.w, y.w);
  return *reinterpret_cast<int4*>(&z);
}

template <> __device__ __forceinline__ int4 add16<int>(int4 a, int4 b) {
  // wrapping two's-complement adds, as torch's and XLA's int32
  return make_int4((int)((unsigned)a.x + (unsigned)b.x), (int)((unsigned)a.y + (unsigned)b.y),
                   (int)((unsigned)a.z + (unsigned)b.z), (int)((unsigned)a.w + (unsigned)b.w));
}

template <> __device__ __forceinline__ int4 add16<__nv_bfloat16>(int4 a, int4 b) {
  __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&a);
  __nv_bfloat162* y = reinterpret_cast<__nv_bfloat162*>(&b);
#pragma unroll
  for (int k = 0; k < 4; ++k) x[k] = __hadd2(x[k], y[k]);
  return a;
}

template <> __device__ __forceinline__ int4 add16<__half>(int4 a, int4 b) {
  __half2* x = reinterpret_cast<__half2*>(&a);
  __half2* y = reinterpret_cast<__half2*>(&b);
#pragma unroll
  for (int k = 0; k < 4; ++k) x[k] = __hadd2(x[k], y[k]);
  return a;
}

// dst = own + arrived (the fold of one hop)
template <typename T>
__device__ __forceinline__ void fold16(char* dst, const char* own, const char* arrived, Range rg) {
  int4* d = reinterpret_cast<int4*>(dst);
  const int4* o = reinterpret_cast<const int4*>(own);
  const int4* s = reinterpret_cast<const int4*>(arrived);
  long long i = rg.lo + threadIdx.x;
  for (; i + kThreads < rg.hi; i += 2 * kThreads) {
    int4 o0 = __ldcg(o + i), o1 = __ldcg(o + i + kThreads);
    int4 s0 = __ldcg(s + i), s1 = __ldcg(s + i + kThreads);
    __stcg(d + i, add16<T>(o0, s0));
    __stcg(d + i + kThreads, add16<T>(o1, s1));
  }
  for (; i < rg.hi; i += kThreads) __stcg(d + i, add16<T>(__ldcg(o + i), __ldcg(s + i)));
}

__device__ __forceinline__ long long slot_off(const RingArgs& a, int slot, int h) {
  return ((long long)slot * a.S + h) * a.slot_bytes;
}

// Entry barrier with both ring neighbors (dma.py:292 ring_barrier).
__device__ bool entry_barrier(const RingArgs& a, int r, int h, int c, int right, int left) {
  signal(flag(a, r, h, c, 3), mark(a, 1));
  return wait_geq(a, flag(a, right, h, c, 3), mark(a, 1), r, h, c, -1, kWaitEntry) &&
         wait_geq(a, flag(a, left, h, c, 3), mark(a, 1), r, h, c, -1, kWaitEntry);
}

// The reduce-scatter phase of one stream (pallas_ccl.py:206 _rs_phase).
// Slots of x are never folded before they are read, so a fold reads x and
// the arrived partial, and writes the member's data slot (B5 writes its own
// slot r, the last one folded, to its output).
template <typename T>
__device__ bool rs_phase(const RingArgs& a, int r, int h, int c, int d, Range rg,
                         char* last_dst) {
  const int n = a.n, right = mod(r + d, n), left = mod(r - d, n);
  const char* x = a.x[r];
  char* buf = a.buf[r];
  for (int s = 0; s < n - 1; ++s) {
    const int send_slot = mod(r - d * (s + 1), n);
    if (s >= 2 && !wait_geq(a, flag(a, r, h, c, 1), mark(a, s - 1), r, h, c, s, kWaitCredit))
      return false;
    const char* src = (s == 0 ? x : buf) + slot_off(a, send_slot, h);
    copy16(a.stage[right] + ((long long)h * 2 + (s & 1)) * a.slot_bytes, src, rg);
    signal(flag(a, right, h, c, 0), mark(a, s + 1));
    if (!wait_geq(a, flag(a, r, h, c, 0), mark(a, s + 1), r, h, c, s, kWaitRecv)) return false;
    const int recv_slot = mod(r - d * (s + 2), n);
    char* dst = (s == n - 2 && last_dst) ? last_dst : buf + slot_off(a, recv_slot, h);
    fold16<T>(dst, x + slot_off(a, recv_slot, h),
              a.stage[r] + ((long long)h * 2 + (s & 1)) * a.slot_bytes, rg);
    signal(flag(a, left, h, c, 1), mark(a, s + 1));
  }
  return true;
}

// The all-gather phase of one stream (pallas_ccl.py:153 _ag_phase): n-1
// write-once hops from the member's slot into the right neighbor's slot of
// the same index. ``first`` is where step 0's slot (the member's own) is
// read from; ``t0`` numbers the steps after an earlier phase's.
__device__ bool ag_phase(const RingArgs& a, int r, int h, int c, int d, Range rg,
                         const char* first, int t0) {
  const int n = a.n, right = mod(r + d, n), left = mod(r - d, n);
  for (int s = 0; s < n - 1; ++s) {
    const int t = t0 + s;
    const int send_slot = mod(r - d * s, n);
    if (s >= 2 && !wait_geq(a, flag(a, r, h, c, 1), mark(a, t - 1), r, h, c, t, kWaitCredit))
      return false;
    const long long off = slot_off(a, send_slot, h);
    copy16(a.buf[right] + off, s == 0 ? first : a.buf[r] + off, rg);
    signal(flag(a, right, h, c, 0), mark(a, t + 1));
    if (!wait_geq(a, flag(a, r, h, c, 0), mark(a, t + 1), r, h, c, t, kWaitRecv)) return false;
    signal(flag(a, left, h, c, 1), mark(a, t + 1));
  }
  return true;
}

__global__ void __launch_bounds__(kThreads) ring_ag_kernel(RingArgs a) {
  const int r = blockIdx.y, c = blockIdx.x, d = a.dir[0];
  const Range rg = channel_range(a, c);
  // the member's own chunk lands in its slot r
  copy16(a.buf[r] + slot_off(a, r, 0), a.x[r], rg);
  if (!entry_barrier(a, r, 0, c, mod(r + d, a.n), mod(r - d, a.n))) return;
  ag_phase(a, r, 0, c, d, rg, a.x[r], 0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ring_rs_kernel(RingArgs a) {
  const int r = blockIdx.y, c = blockIdx.x, d = a.dir[0];
  const Range rg = channel_range(a, c);
  if (!entry_barrier(a, r, 0, c, mod(r + d, a.n), mod(r - d, a.n))) return;
  rs_phase<T>(a, r, 0, c, d, rg, a.out[r]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ring_ar_kernel(RingArgs a) {
  const int r = blockIdx.y, h = blockIdx.x / a.C, c = blockIdx.x % a.C, d = a.dir[h];
  const int right = mod(r + d, a.n), left = mod(r - d, a.n);
  const Range rg = channel_range(a, c);
  if (!entry_barrier(a, r, h, c, right, left)) return;
  if (!rs_phase<T>(a, r, h, c, d, rg, nullptr)) return;
  // Phase barrier: my AG stores into the right neighbor's slots must land
  // after its RS phase has read and folded them (pallas_ccl.py:701-706).
  signal(flag(a, r, h, c, 2), mark(a, 1));
  if (!wait_geq(a, flag(a, right, h, c, 2), mark(a, 1), r, h, c, a.n - 1, kWaitPhase)) return;
  ag_phase(a, r, h, c, d, rg, a.buf[r] + slot_off(a, r, h), a.n - 1);
}

// ---------------------------------------------------------------------------
// The quantized wire (B6, B8)

// Four consecutive elements of T, one lane's share of a 128-element row.
template <typename T> struct Quad;

template <> struct Quad<float> {
  float4 v;
  __device__ __forceinline__ static Quad load(const char* row, int lane) {
    return {__ldcg(reinterpret_cast<const float4*>(row) + lane)};
  }
  __device__ __forceinline__ void store(char* row, int lane) const {
    __stcg(reinterpret_cast<float4*>(row) + lane, v);
  }
  __device__ __forceinline__ void to_float(float f[4]) const {
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  __device__ __forceinline__ static Quad rounded(const float f[4]) {
    return {make_float4(f[0], f[1], f[2], f[3])};
  }
  __device__ __forceinline__ Quad plus(const Quad& o) const {
    return {make_float4(__fadd_rn(v.x, o.v.x), __fadd_rn(v.y, o.v.y),
                        __fadd_rn(v.z, o.v.z), __fadd_rn(v.w, o.v.w))};
  }
};

template <> struct Quad<__nv_bfloat16> {
  __nv_bfloat162 lo, hi;
  __device__ __forceinline__ static Quad load(const char* row, int lane) {
    uint2 t = __ldcg(reinterpret_cast<const uint2*>(row) + lane);
    Quad q;
    q.lo = *reinterpret_cast<__nv_bfloat162*>(&t.x);
    q.hi = *reinterpret_cast<__nv_bfloat162*>(&t.y);
    return q;
  }
  __device__ __forceinline__ void store(char* row, int lane) const {
    uint2 t;
    t.x = *reinterpret_cast<const unsigned*>(&lo);
    t.y = *reinterpret_cast<const unsigned*>(&hi);
    __stcg(reinterpret_cast<uint2*>(row) + lane, t);
  }
  __device__ __forceinline__ void to_float(float f[4]) const {
    f[0] = __low2float(lo); f[1] = __high2float(lo);
    f[2] = __low2float(hi); f[3] = __high2float(hi);
  }
  __device__ __forceinline__ static Quad rounded(const float f[4]) {
    Quad q;
    q.lo = __halves2bfloat162(__float2bfloat16_rn(f[0]), __float2bfloat16_rn(f[1]));
    q.hi = __halves2bfloat162(__float2bfloat16_rn(f[2]), __float2bfloat16_rn(f[3]));
    return q;
  }
  __device__ __forceinline__ Quad plus(const Quad& o) const {
    Quad q;
    q.lo = __hadd2(lo, o.lo);
    q.hi = __hadd2(hi, o.hi);
    return q;
  }
};

template <> struct Quad<__half> {
  __half2 lo, hi;
  __device__ __forceinline__ static Quad load(const char* row, int lane) {
    uint2 t = __ldcg(reinterpret_cast<const uint2*>(row) + lane);
    Quad q;
    q.lo = *reinterpret_cast<__half2*>(&t.x);
    q.hi = *reinterpret_cast<__half2*>(&t.y);
    return q;
  }
  __device__ __forceinline__ void store(char* row, int lane) const {
    uint2 t;
    t.x = *reinterpret_cast<const unsigned*>(&lo);
    t.y = *reinterpret_cast<const unsigned*>(&hi);
    __stcg(reinterpret_cast<uint2*>(row) + lane, t);
  }
  __device__ __forceinline__ void to_float(float f[4]) const {
    f[0] = __low2float(lo); f[1] = __high2float(lo);
    f[2] = __low2float(hi); f[3] = __high2float(hi);
  }
  __device__ __forceinline__ static Quad rounded(const float f[4]) {
    Quad q;
    q.lo = __halves2half2(__float2half_rn(f[0]), __float2half_rn(f[1]));
    q.hi = __halves2half2(__float2half_rn(f[2]), __float2half_rn(f[3]));
    return q;
  }
  __device__ __forceinline__ Quad plus(const Quad& o) const {
    Quad q;
    q.lo = __hadd2(lo, o.lo);
    q.hi = __hadd2(hi, o.hi);
    return q;
  }
};

template <int W> struct WireCodec;

template <> struct WireCodec<kFp8> {
  static constexpr float kQmax = 448.0f;  // max normal of e4m3fn
  __device__ __forceinline__ static unsigned encode(float q) {
    return __nv_cvt_float_to_fp8(q, __NV_SATFINITE, __NV_E4M3);  // nan stays nan
  }
  __device__ __forceinline__ static float decode(unsigned b) {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)b, __NV_E4M3)));
  }
};

template <> struct WireCodec<kInt8> {
  static constexpr float kQmax = 127.0f;
  __device__ __forceinline__ static unsigned encode(float q) {
    return (unsigned)__float2int_rn(q) & 0xffu;  // nearest even; nan -> 0
  }
  __device__ __forceinline__ static float decode(unsigned b) {
    return (float)(signed char)b;
  }
};

// One warp quantizes one row: the row's scale (every lane gets it) and this
// lane's four payload bytes, element 0 in the low byte.
template <int W>
__device__ __forceinline__ unsigned quantize_quad(const float f[4], float* scale_out) {
  float amax = fmaxf(fmaxf(fabsf(f[0]), fabsf(f[1])), fmaxf(fabsf(f[2]), fabsf(f[3])));
  // fmaxf drops a nan, so non-finite elements are tracked beside the amax
  bool bad = !(isfinite(f[0]) && isfinite(f[1]) && isfinite(f[2]) && isfinite(f[3]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  bad = __any_sync(0xffffffffu, bad);
  constexpr float qmax = WireCodec<W>::kQmax;
  // amax * (1 / QMAX), the reciprocal rounded to f32 once: the codec's rule
  // (XLA compiles the JAX package's amax / QMAX to this product)
  constexpr float inv_qmax = 1.0f / qmax;
  float scale = amax > 0.0f ? fmaxf(__fmul_rn(amax, inv_qmax), kScaleTiny) : 1.0f;
  if (bad) scale = CUDART_INF_F;
  unsigned packed = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float q = __fdiv_rn(f[k], scale);
    q = q < -qmax ? -qmax : (q > qmax ? qmax : q);  // a nan passes through
    packed |= WireCodec<W>::encode(q) << (8 * k);
  }
  *scale_out = scale;
  return packed;
}

// This lane's four dequantized values of a row, rounded to T:
// (payload * scale) with a nan scale or one under the floor read as 0.
template <typename T, int W>
__device__ __forceinline__ Quad<T> dequantize_quad(unsigned packed, float scale) {
  const float s = (isnan(scale) || scale < kScaleTiny) ? 0.0f : scale;
  float f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __fmul_rn(WireCodec<W>::decode((packed >> (8 * k)) & 0xffu), s);
  return Quad<T>::rounded(f);
}

__device__ __forceinline__ Range row_range(const RingArgs& a, int c) {
  return {a.rows * c / a.C, a.rows * (c + 1) / a.C};
}

// Rows [rg.lo, rg.hi) of ``src`` (T) -> payload bytes at ``qdst`` and one
// scale per row at ``sdst``. With ``back`` the round-tripped row is also
// written there in T (B8's own slot is dequantized from its wire bytes).
template <typename T, int W>
__device__ __forceinline__ void quantize_rows(char* qdst, float* sdst, const char* src,
                                              char* back, Range rg) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr long long kRowBytes = kLanes * (long long)sizeof(T);
  for (long long row0 = rg.lo + warp; row0 < rg.hi; row0 += kWarps * kRowUnroll) {
    Quad<T> in[kRowUnroll];
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      const long long row = row0 + u * kWarps;
      if (row < rg.hi) in[u] = Quad<T>::load(src + row * kRowBytes, lane);
    }
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      const long long row = row0 + u * kWarps;
      if (row >= rg.hi) break;
      float f[4], scale;
      in[u].to_float(f);
      const unsigned packed = quantize_quad<W>(f, &scale);
      __stcg(reinterpret_cast<unsigned*>(qdst + row * kLanes) + lane, packed);
      if (lane == 0) __stcg(sdst + row, scale);
      if (back) dequantize_quad<T, W>(packed, scale).store(back + row * kRowBytes, lane);
    }
  }
}

// dst = own + dequantize(payload, scales) over rows [rg.lo, rg.hi), or
// dst = dequantize(...) when ``own`` is null.
template <typename T, int W>
__device__ __forceinline__ void dequantize_rows(char* dst, const char* own, const char* qsrc,
                                                const float* ssrc, Range rg) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr long long kRowBytes = kLanes * (long long)sizeof(T);
  for (long long row0 = rg.lo + warp; row0 < rg.hi; row0 += kWarps * kRowUnroll) {
    unsigned packed[kRowUnroll];
    float scale[kRowUnroll];
    Quad<T> mine[kRowUnroll];
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      const long long row = row0 + u * kWarps;
      if (row < rg.hi) {
        packed[u] = __ldcg(reinterpret_cast<const unsigned*>(qsrc + row * kLanes) + lane);
        scale[u] = __ldcg(ssrc + row);
        if (own) mine[u] = Quad<T>::load(own + row * kRowBytes, lane);
      }
    }
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      const long long row = row0 + u * kWarps;
      if (row >= rg.hi) break;
      Quad<T> deq = dequantize_quad<T, W>(packed[u], scale[u]);
      (own ? mine[u].plus(deq) : deq).store(dst + row * kRowBytes, lane);
    }
  }
}

// The quantized reduce-scatter phase of one stream (pallas_ccl.py:262
// _rs_phase_q): rs_phase's slots, credits and flags, with the send path
// quantizing into the right neighbor's staging and the fold dequantizing
// before it adds. Payload and scales of a hop share the receive flag.
template <typename T, int W>
__device__ bool rs_phase_q(const RingArgs& a, int r, int h, int c, int d, Range rg,
                           char* last_dst) {
  const int n = a.n, right = mod(r + d, n), left = mod(r - d, n);
  const long long m = a.rows * kLanes;
  const char* x = a.x[r];
  char* buf = a.buf[r];
  for (int s = 0; s < n - 1; ++s) {
    const int send_slot = mod(r - d * (s + 1), n);
    const long long st = (long long)h * 2 + (s & 1);
    if (s >= 2 && !wait_geq(a, flag(a, r, h, c, 1), mark(a, s - 1), r, h, c, s, kWaitCredit))
      return false;
    const char* src = (s == 0 ? x : buf) + slot_off(a, send_slot, h);
    quantize_rows<T, W>(a.stage[right] + st * m, a.sstage[right] + st * a.srow, src, nullptr,
                        rg);
    signal(flag(a, right, h, c, 0), mark(a, s + 1));
    if (!wait_geq(a, flag(a, r, h, c, 0), mark(a, s + 1), r, h, c, s, kWaitRecv)) return false;
    const int recv_slot = mod(r - d * (s + 2), n);
    char* dst = (s == n - 2 && last_dst) ? last_dst : buf + slot_off(a, recv_slot, h);
    dequantize_rows<T, W>(dst, x + slot_off(a, recv_slot, h), a.stage[r] + st * m,
                          a.sstage[r] + st * a.srow, rg);
    signal(flag(a, left, h, c, 1), mark(a, s + 1));
  }
  return true;
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 2) ring_rsq_kernel(RingArgs a) {
  const int r = blockIdx.y, c = blockIdx.x, d = a.dir[0];
  if (!entry_barrier(a, r, 0, c, mod(r + d, a.n), mod(r - d, a.n))) return;
  rs_phase_q<T, W>(a, r, 0, c, d, row_range(a, c), a.out[r]);
}

// B8 (pallas_ccl.py:742): the quantized RS phase, the phase barrier, the
// reduced slot quantized once, payload and scales forwarded verbatim, and
// every slot dequantized from its wire bytes into the member's output.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 2) ring_arq_kernel(RingArgs a) {
  const int n = a.n, r = blockIdx.y, h = blockIdx.x / a.C, c = blockIdx.x % a.C, d = a.dir[h];
  const int right = mod(r + d, n), left = mod(r - d, n);
  const Range rg = row_range(a, c);
  const long long m = a.rows * kLanes;
  if (!entry_barrier(a, r, h, c, right, left)) return;
  if (!rs_phase_q<T, W>(a, r, h, c, d, rg, nullptr)) return;
  // Phase barrier, as in B7: the all-gather phase reuses the receive and
  // credit flags, and starts once the right neighbor has left its RS loop.
  signal(flag(a, r, h, c, 2), mark(a, 1));
  if (!wait_geq(a, flag(a, right, h, c, 2), mark(a, 1), r, h, c, n - 1, kWaitPhase)) return;
  char* out = a.buf[r];
  auto qslot = [&](int member, int slot) {
    return a.qbuf[member] + ((long long)slot * a.S + h) * m;
  };
  auto sslot = [&](int member, int slot) {
    return a.sbuf[member] + ((long long)slot * a.S + h) * a.srow;
  };
  quantize_rows<T, W>(qslot(r, r), sslot(r, r), out + slot_off(a, r, h), out + slot_off(a, r, h),
                      rg);
  const Range bytes = {rg.lo * (kLanes / 16), rg.hi * (kLanes / 16)};
  for (int s = 0; s < n - 1; ++s) {
    const int t = n - 1 + s;
    const int send_slot = mod(r - d * s, n), recv_slot = mod(r - d * (s + 1), n);
    if (s >= 2 && !wait_geq(a, flag(a, r, h, c, 1), mark(a, t - 1), r, h, c, t, kWaitCredit))
      return;
    if (s == 0) __syncthreads();  // the own slot's bytes were written by other warps
    copy16(qslot(right, send_slot), qslot(r, send_slot), bytes);
    const float* ss = sslot(r, send_slot);
    float* sd = sslot(right, send_slot);
    for (long long i = rg.lo + threadIdx.x; i < rg.hi; i += kThreads)
      __stcg(sd + i, __ldcg(ss + i));
    signal(flag(a, right, h, c, 0), mark(a, t + 1));
    if (!wait_geq(a, flag(a, r, h, c, 0), mark(a, t + 1), r, h, c, t, kWaitRecv)) return;
    dequantize_rows<T, W>(out + slot_off(a, recv_slot, h), nullptr, qslot(r, recv_slot),
                          sslot(r, recv_slot), rg);
    signal(flag(a, left, h, c, 1), mark(a, t + 1));
  }
}

}  // namespace

extern "C" {

// kernel: 0 = all-gather (B4), 1 = reduce-scatter (B5), 2 = all-reduce (B7),
// 3 = quantized reduce-scatter (B6), 4 = quantized all-reduce (B8).
// dtype (B5-B8): 0 float32, 1 bfloat16, 2 float16, 3 int32 (B5, B7 only); B4
// moves bytes. wire (B6, B8): 0 fp8 e4m3fn, 1 int8. slot_bytes is one chunk
// slot in the input dtype. Tables hold one address per member; B6 and B8
// take their payload staging in ``stage`` and their scale staging in
// ``sstage``, B8 its gather buffers in ``qbuf`` and ``sbuf``. ``live``
// launches members [0, live) only (live < n is a test of the spin bound: the
// missing members' peers time out). Returns 0, a cudaError_t, or -1 for
// arguments out of range.
int uccl_ring_launch(int kernel, int dtype, int wire, int n, int live, int S, int dir0, int dir1,
                     long long slot_bytes, const void* const* x, void* const* buf,
                     void* const* stage, void* const* out, void* const* sstage,
                     void* const* qbuf, void* const* sbuf, void* const* flags, void* err,
                     int cid, unsigned long long epoch, unsigned long long timeout_ns,
                     void* stream) {
  const bool quant = kernel == kRSQ || kernel == kARQ;
  if (n < 2 || n > kMaxMembers || live < 1 || live > n || (S != 1 && S != 2) ||
      (kernel != kAR && kernel != kARQ && S != 1) || slot_bytes <= 0 || slot_bytes % 16)
    return -1;
  RingArgs a = {};
  for (int r = 0; r < n; ++r) {
    a.x[r] = static_cast<const char*>(x[r]);
    a.buf[r] = static_cast<char*>(buf[r]);
    a.stage[r] = stage ? static_cast<char*>(stage[r]) : nullptr;
    a.out[r] = out ? static_cast<char*>(out[r]) : nullptr;
    a.sstage[r] = sstage ? static_cast<float*>(sstage[r]) : nullptr;
    a.qbuf[r] = qbuf ? static_cast<char*>(qbuf[r]) : nullptr;
    a.sbuf[r] = sbuf ? static_cast<float*>(sbuf[r]) : nullptr;
    a.flags[r] = static_cast<unsigned long long*>(flags[r]);
  }
  a.err = static_cast<int*>(err);
  a.slot_bytes = slot_bytes;
  a.n = n; a.S = S; a.C = 1;
  a.dir[0] = dir0; a.dir[1] = dir1;
  a.cid = cid; a.kernel = kernel; a.epoch = epoch; a.timeout_ns = timeout_ns;
  if (quant) {
    // whole 128-element rows, a float dtype, staging for payload and scales
    const long long row_bytes = kLanes * (dtype == 0 ? 4 : 2);
    if (dtype < 0 || dtype > 2 || (wire != kFp8 && wire != kInt8) || slot_bytes % row_bytes ||
        !stage || !sstage || (kernel == kRSQ ? !out : (!qbuf || !sbuf)))
      return -1;
    a.rows = slot_bytes / row_bytes;
    a.srow = (a.rows + kLanes - 1) / kLanes * kLanes;
  }
  if (kernel == kAG) return launch(ring_ag_kernel, a, live, stream, a.S);
  if (kernel == kRS) {
    switch (dtype) {
      case 0: return launch(ring_rs_kernel<float>, a, live, stream, a.S);
      case 1: return launch(ring_rs_kernel<__nv_bfloat16>, a, live, stream, a.S);
      case 2: return launch(ring_rs_kernel<__half>, a, live, stream, a.S);
      case 3: return launch(ring_rs_kernel<int>, a, live, stream, a.S);
    }
    return -1;
  }
  if (kernel == kAR) {
    switch (dtype) {
      case 0: return launch(ring_ar_kernel<float>, a, live, stream, a.S);
      case 1: return launch(ring_ar_kernel<__nv_bfloat16>, a, live, stream, a.S);
      case 2: return launch(ring_ar_kernel<__half>, a, live, stream, a.S);
      case 3: return launch(ring_ar_kernel<int>, a, live, stream, a.S);
    }
    return -1;
  }
#define UCCL_QUANT_CASE(K, D, T)                                         \
  case D:                                                                \
    return wire == kFp8 ? launch(K<T, kFp8>, a, live, stream, a.S)       \
                        : launch(K<T, kInt8>, a, live, stream, a.S);
  if (kernel == kRSQ) {
    switch (dtype) {
      UCCL_QUANT_CASE(ring_rsq_kernel, 0, float)
      UCCL_QUANT_CASE(ring_rsq_kernel, 1, __nv_bfloat16)
      UCCL_QUANT_CASE(ring_rsq_kernel, 2, __half)
    }
    return -1;
  }
  if (kernel == kARQ) {
    switch (dtype) {
      UCCL_QUANT_CASE(ring_arq_kernel, 0, float)
      UCCL_QUANT_CASE(ring_arq_kernel, 1, __nv_bfloat16)
      UCCL_QUANT_CASE(ring_arq_kernel, 2, __half)
    }
  }
#undef UCCL_QUANT_CASE
  return -1;
}

// Limits the Python side checks against.
int uccl_ring_max_members() { return kMaxMembers; }
int uccl_ring_max_channels() { return kMaxChannels; }
int uccl_ring_flag_words() { return kFlagWords; }

}  // extern "C"
