// Ring collectives over a W-member world: all-gather (B4), reduce-scatter
// (B5) and the fused all-reduce (B7), for Hopper (sm_90a).
//
// Replaces the Pallas remote-DMA kernels of uccl_tpu/collective/pallas_ccl.py:
//   ring_ag_kernel     <- _ag_ring (pallas_ccl.py:434, call :450)
//   ring_rs_kernel<T>  <- ring_reduce_scatter's full-precision kernel (:546, call :593)
//   ring_ar_kernel<T>  <- ring_all_reduce's full-precision kernel (:645, call :710)
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
// Deadlock and faults. A member spins on another member's flag, so every
// block of a launch must be resident at once: the launch is cooperative
// (cudaLaunchCooperativeKernel refuses a grid that cannot be), and the grid
// takes at most half the card so that the two kernels of a bidirectional
// pair can both be resident. Every spin is bounded by %globaltimer; a wait
// that times out writes an error word (kernel, member, step, collective id,
// stream, channel, which wait) and returns, other blocks see the word and
// return too, and the host wrapper raises on it.
//
// Bound. All three move bytes and do at most one add per element per hop:
// HBM bandwidth bounds them (3.35 TB/s on an H100 SXM). Copies and folds use
// 16-byte vector loads and stores through L2 (ld.global.cg / st.global.cg),
// since staging slots are rewritten every other step by another SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kMaxMembers = 16;
constexpr int kMaxChannels = 64;
constexpr int kThreads = 512;
constexpr int kFlagWords = 4;  // recv, ack, phase, entry

enum Kernel { kAG = 0, kRS = 1, kAR = 2 };
enum Wait { kWaitEntry = 0, kWaitCredit = 1, kWaitRecv = 2, kWaitPhase = 3 };

struct RingArgs {
  const char* x[kMaxMembers];        // member inputs
  char* buf[kMaxMembers];            // member data slots ([n][S][slot_bytes])
  char* stage[kMaxMembers];          // member staging ([S][2][slot_bytes])
  char* out[kMaxMembers];            // B5: member output ([slot_bytes])
  unsigned long long* flags[kMaxMembers];  // member flags ([2][kMaxChannels][kFlagWords])
  int* err;                          // error word of the flag region: 8 ints
  long long slot_bytes;              // bytes of one chunk slot of one stream
  int n, S, C;                       // world, streams, channels
  int dir[2];                        // direction of each stream
  int cid, kernel;
  unsigned long long epoch;
  unsigned long long timeout_ns;
};

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned long long* flag(const RingArgs& a, int member, int h,
                                                    int c, int word) {
  return a.flags[member] + ((size_t)h * kMaxChannels + c) * kFlagWords + word;
}

__device__ __forceinline__ unsigned long long mark(const RingArgs& a, long long count) {
  return (a.epoch << 32) | (unsigned long long)count;
}

// All threads: the block's stores so far become visible before the flag.
__device__ __forceinline__ void signal(unsigned long long* f, unsigned long long v) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(f, v);
  }
}

// All threads: spin (thread 0) until *f >= target. False when the wait timed
// out or another block of the launch already failed; the caller returns.
__device__ bool wait_geq(const RingArgs& a, const unsigned long long* f,
                         unsigned long long target, int member, int h, int c, int step,
                         int what) {
  __shared__ int ok;
  __syncthreads();  // every thread has read the previous wait's verdict
  if (threadIdx.x == 0) {
    ok = 1;
    const unsigned long long t0 = globaltimer();
    while (ld_acquire(f) < target) {
      if (*(volatile int*)a.err != 0) { ok = 0; break; }
      if (globaltimer() - t0 > a.timeout_ns) {
        if (atomicCAS(a.err, 0, 1) == 0) {
          a.err[1] = a.kernel; a.err[2] = member; a.err[3] = step; a.err[4] = a.cid;
          a.err[5] = h; a.err[6] = c; a.err[7] = what;
          __threadfence();
        }
        ok = 0;
        break;
      }
      __nanosleep(64);
    }
  }
  __syncthreads();
  return ok != 0;
}

__device__ __forceinline__ int mod(int v, int n) { return ((v % n) + n) % n; }

// This channel's range of 16-byte vectors within a slot.
struct Range { long long lo, hi; };

__device__ __forceinline__ Range channel_range(const RingArgs& a, int c) {
  const long long v = a.slot_bytes / 16;
  return {v * c / a.C, v * (c + 1) / a.C};
}

__device__ __forceinline__ void copy16(char* dst, const char* src, Range rg) {
  int4* d = reinterpret_cast<int4*>(dst);
  const int4* s = reinterpret_cast<const int4*>(src);
  long long i = rg.lo + threadIdx.x;
  for (; i + 3 * kThreads < rg.hi; i += 4 * kThreads) {
    int4 v0 = __ldcg(s + i), v1 = __ldcg(s + i + kThreads);
    int4 v2 = __ldcg(s + i + 2 * kThreads), v3 = __ldcg(s + i + 3 * kThreads);
    __stcg(d + i, v0); __stcg(d + i + kThreads, v1);
    __stcg(d + i + 2 * kThreads, v2); __stcg(d + i + 3 * kThreads, v3);
  }
  for (; i < rg.hi; i += kThreads) __stcg(d + i, __ldcg(s + i));
}

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

template <typename K>
int launch(K kernel, RingArgs& a, int live, void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  // At most half the card's resident blocks, so both kernels of a pair fit.
  const long long vecs = a.slot_bytes / 16;
  long long c = (long long)per_sm * sms / (2LL * a.S * a.n);
  const long long by_size = (vecs + 4LL * kThreads - 1) / (4LL * kThreads);
  if (c > by_size) c = by_size;
  if (c > kMaxChannels) c = kMaxChannels;
  if (c < 1) c = 1;
  a.C = (int)c;
  dim3 grid((unsigned)(a.C * a.S), (unsigned)live), block(kThreads);
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)kernel, grid, block, args, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// kernel: 0 = all-gather (B4), 1 = reduce-scatter (B5), 2 = all-reduce (B7).
// dtype (B5, B7): 0 float32, 1 bfloat16, 2 float16, 3 int32; B4 moves bytes.
// Tables hold one address per member; ``live`` launches members [0, live)
// only (live < n is a test of the spin bound: the missing members' peers
// time out). Returns 0, a cudaError_t, or -1 for arguments out of range.
int uccl_ring_launch(int kernel, int dtype, int n, int live, int S, int dir0, int dir1,
                     long long slot_bytes, const void* const* x, void* const* buf,
                     void* const* stage, void* const* out, void* const* flags, void* err,
                     int cid, unsigned long long epoch, unsigned long long timeout_ns,
                     void* stream) {
  if (n < 2 || n > kMaxMembers || live < 1 || live > n || (S != 1 && S != 2) ||
      (kernel != kAR && S != 1) || slot_bytes <= 0 || slot_bytes % 16)
    return -1;
  RingArgs a = {};
  for (int r = 0; r < n; ++r) {
    a.x[r] = static_cast<const char*>(x[r]);
    a.buf[r] = static_cast<char*>(buf[r]);
    a.stage[r] = stage ? static_cast<char*>(stage[r]) : nullptr;
    a.out[r] = out ? static_cast<char*>(out[r]) : nullptr;
    a.flags[r] = static_cast<unsigned long long*>(flags[r]);
  }
  a.err = static_cast<int*>(err);
  a.slot_bytes = slot_bytes;
  a.n = n; a.S = S; a.C = 1;
  a.dir[0] = dir0; a.dir[1] = dir1;
  a.cid = cid; a.kernel = kernel; a.epoch = epoch; a.timeout_ns = timeout_ns;
  if (kernel == kAG) return launch(ring_ag_kernel, a, live, stream);
  if (kernel == kRS) {
    switch (dtype) {
      case 0: return launch(ring_rs_kernel<float>, a, live, stream);
      case 1: return launch(ring_rs_kernel<__nv_bfloat16>, a, live, stream);
      case 2: return launch(ring_rs_kernel<__half>, a, live, stream);
      case 3: return launch(ring_rs_kernel<int>, a, live, stream);
    }
    return -1;
  }
  if (kernel == kAR) {
    switch (dtype) {
      case 0: return launch(ring_ar_kernel<float>, a, live, stream);
      case 1: return launch(ring_ar_kernel<__nv_bfloat16>, a, live, stream);
      case 2: return launch(ring_ar_kernel<__half>, a, live, stream);
      case 3: return launch(ring_ar_kernel<int>, a, live, stream);
    }
  }
  return -1;
}

// Limits the Python side checks against.
int uccl_ring_max_members() { return kMaxMembers; }
int uccl_ring_max_channels() { return kMaxChannels; }
int uccl_ring_flag_words() { return kFlagWords; }

}  // extern "C"
