// Ring collectives over a W-member world: all-gather (B4), reduce-scatter
// (B5) and all-reduce (B7), and the two whose wire is quantized (B6, B8),
// for Hopper (sm_90a).
//
// Replaces the Pallas remote-DMA kernels of uccl_tpu/collective/pallas_ccl.py:
//   ring_ag_kernel        <- _ag_ring (pallas_ccl.py:434, call :450)
//   ring_rs_kernel<T>     <- ring_reduce_scatter's full-precision kernel (:546, call :593)
//   ring_ar_kernel<T>     <- ring_all_reduce's full-precision kernel (:645, call :710)
//   ring_rsq_kernel<T,W>  <- ring_reduce_scatter's quantized kernel (:621, call :632)
//   ring_arq_kernel<T,W>  <- ring_all_reduce's quantized kernel (:742, call :773)
//
// Members. Each kernel takes a table of per-member base addresses: inputs,
// outputs and, for the quantized ring, data slots, 2-slot staging and flag
// words. One launch runs every member of the world: blockIdx.y is the
// member, and blockIdx.x splits its work into independent channels (and,
// for B7 and B8, the two counter-rotating streams), each with its own flags,
// so many SMs move each member's bytes. On one card every address in the
// table lies in the same HBM, so a "hop" is an HBM-to-HBM store; members on
// separate cards need only another table (peer or IPC addresses) and the
// .sys memory scope.
//
// B4, B5 and B7 are no ring on this card: each is one pass that reads every
// input byte once and writes every result byte once, in its final place
// (set out above ring_rs_kernel). B6 and B8 keep the ring, exactly the JAX
// package's slot arithmetic (d = direction):
//   RS step s sends slot (r - d*(s+1)) mod n into the right neighbor's
//     staging slot s%2, and folds the partial that arrives from the left
//     into slot (r - d*(s+2)) mod n, in the input dtype, one rounding per hop
//     (buf + stage, pallas_ccl.py:242);
//   B8 runs the RS phase, a phase barrier, then the AG phase (step s sends
//     slot (r - d*s) mod n straight into the right neighbor's slot of the
//     same index), on a payload laid out slot-major, then by stream
//     ([n][S][m], pallas_ccl.py:673-676).
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
// step s-2. Entry barrier with both neighbors; B8 keeps the phase barrier
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
// Bound. All five move bytes and do a handful of operations per element:
// HBM bandwidth bounds them (3.35 TB/s on an H100 SXM). The ring kernels'
// copies and folds use 16-byte vector loads and stores through L2
// (ld.global.cg / st.global.cg), since staging slots are rewritten every
// other step by another SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <math_constants.h>
#include <stdint.h>
#include <type_traits>

#include "collective.cuh"

namespace {

using namespace uccl;

constexpr int kFlagWords = 4;  // recv, ack, phase (B4, B5, B7: exit), entry

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
// The full-peer barriers of B4, B5 and B7 (kWaitPeers at entry,
// kWaitPeersExit at exit): the error word's step is the peer awaited
enum Wait {
  kWaitEntry = 0, kWaitCredit = 1, kWaitRecv = 2, kWaitPhase = 3, kWaitPeers = 4,
  kWaitPeersExit = 5
};

struct RingArgs {
  const char* x[kMaxMembers];        // member inputs (B4: contributions)
  char* buf[kMaxMembers];            // B6, B8: member data slots ([n][S][slot_bytes])
  char* stage[kMaxMembers];          // B6, B8: member staging ([S][2][slot_bytes])
  char* out[kMaxMembers];            // B4, B5, B7: member output rows; B6: member output
  unsigned long long* flags[kMaxMembers];  // member flags ([2][kMaxChannels][kFlagWords])
  // quantized wire: B6/B8 stage payload bytes in ``stage`` ([S][2][m]) and
  // row scales in ``sstage`` ([S][2][srow]); B8 gathers into ``qbuf``
  // ([n][S][m]) and ``sbuf`` ([n][S][srow])
  float* sstage[kMaxMembers];
  char* qbuf[kMaxMembers];
  float* sbuf[kMaxMembers];
  long long rows, srow;              // rows of a slot; f32 scales per scale slot
  int* err;                          // error word of the flag region: 8 ints
  long long slot_bytes;              // one chunk slot of one stream (B4: one contribution)
  long long row_elems;               // B5, B7: elements of a member's input row
  long long slot_stride, extent;     // B4: bytes between an output row's slots, and
                                     // bytes of an output row from its base that are written
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

// B4 runs the sums' pass on bytes (T = unsigned char) with one term: a copy,
// which never names add16
template <typename T> constexpr bool kAdds = !std::is_same<T, unsigned char>::value;

__device__ __forceinline__ long long slot_off(const RingArgs& a, int slot, int h) {
  return ((long long)slot * a.S + h) * a.slot_bytes;
}

// Entry barrier with both ring neighbors (dma.py:292 ring_barrier): B6, B8.
__device__ bool entry_barrier(const RingArgs& a, int r, int h, int c, int right, int left) {
  signal(flag(a, r, h, c, 3), mark(a, 1));
  return wait_geq(a, flag(a, right, h, c, 3), mark(a, 1), r, h, c, -1, kWaitEntry) &&
         wait_geq(a, flag(a, left, h, c, 3), mark(a, 1), r, h, c, -1, kWaitEntry);
}

// ---------------------------------------------------------------------------
// B4, B5 and B7: one pass each (replace _ag_ring, pallas_ccl.py:434, and the
// full-precision kernels of ring_reduce_scatter, :546, and ring_all_reduce,
// :645)
//
// What they compute, bit for bit as the JAX kernels and the hop schedules
// (ag_plain, rs_plain, ar_plain in collective/ring_ccl.py). Slot k summed
// along the chain the ring's hops make (d = direction, member indices mod W):
//   sum_k = x[k][k] + (x[k-d][k] + (... + (x[k+2d][k] + x[k+d][k])))
// Each "+" is one correctly rounded add in the input dtype (f32, bf16, f16,
// or wrapping int32), in that order, because that is the order the ring's
// RS phase folds in: step s adds the partial arriving from the left into
// the member's own slot. Summing in f32 and rounding once would be more
// accurate, and no longer bit-identical to the reference for bf16 and f16.
//   B5: member k's output is sum_k.
//   B7: every member's output holds every sum, in its place in the payload
//     (the ring's AG phase moves bits verbatim). A row of ``size`` elements
//     is cut into W·S chunks of k = ceil(size / (W·S)) elements (pad_chunks'
//     split: the last short, any after it empty); chunk q is slot q / S of
//     stream h = q % S, summed in direction dir[h].
//   B4: every member's output row holds every member's contribution in
//     member order: slot j is member j's.
//
// Bound: HBM bytes, each input read once, each output written once. B5
// reads W·P (every member's row of P elements) and writes P; B7 reads W·P
// and writes W·P; B4 reads P (P/W contributed per member) and writes W·P.
// The ring moved 2-3x that (each hop a staging copy and a fold, or a copy,
// through HBM), with a flag wait between hops and a credit window on top.
// On one card every member's input is in the same HBM before the launch,
// so a block works for one member (blockIdx.y) and strides over its share.
// B5 and B7: for each 16-byte vector of the member's chunk, load its W
// terms from the member table (peer addresses can fill it later), add them
// in the chain's order and store the result once into each output that
// holds it (B5: the member's own; B7: every member's). B4 (a push): load
// each vector of the member's contribution once and store it into that
// member's slot of every output row. (The pull, where member r's blocks
// read all W contributions and write row r once, measured 0.3-1.4% slower
// on the H100 at the gradient bucket, the L2 serving its W reads of each
// contribution; PERF.md.) That moves exactly the bound's bytes, with no
// staging, no padding, no credits and no per-hop wait.
//
// Loads and stores. The inputs are read once and never written during the
// launch: loads take the non-coherent path, skip L1 and mark their lines
// first out of L2; results are stored streaming. A thread has kVecs vectors
// of up to kRsGroup terms in flight at once (B5, B7: 2 x 4; B4: 4 x 1); at
// two blocks of 512 threads per SM that is 64-128 KB per SM, several times
// what HBM's latency-bandwidth product needs. A member's blocks take turns
// over runs of its range, so the whole card reads a narrow window of each
// term at a time: with one contiguous range per block (1,280 streams spread
// over the 6.4 GB of the gradient bucket) B5 reached 0.72 of the bound on
// the H100, with the turns 0.87. That is past 0.8, so plain vector loads and
// no TMA ring in shared memory: the bytes already stream straight from HBM
// into the registers that add them, and a bulk copy would add a
// shared-memory round trip.
//
// Ragged ranges. The wrappers hand over the caller's payload as it is: a
// chunk or slot need not start on 16 bytes, rows need not lie at the same
// offset mod 16 (a bf16 row whose length is no multiple of 8), and the W
// outputs of one range (B4, B7) can lie at different offsets mod 16. The
// outputs of a range are grouped by their offset mod 16 (Dests: one class
// per offset), and each class's vectors are aligned on its outputs: the
// elements up to its first 16-byte boundary and its ragged tail are summed
// one by one, the vectors in between as above. A term that lies at another
// offset mod 16 than the class is read as the two aligned vectors around
// each of its vectors, funnel-shifted into place: its HBM bytes stay the
// same (the second load is the next thread's first, from L2), and such a
// pass keeps half the vectors a thread so that both loads of every term
// stay in registers. With more than one class, each turn computes its
// vectors once per class, the later classes reading the terms' lines again
// from L2, where the first class's loads have just put them. On the H100,
// B7 on bf16 rows 8 bytes off 16 (two classes) reached 0.61 of its bound,
// against 0.83 on aligned rows; building the second class's vectors from
// the first's by warp shuffles (each warp summing 32 vectors and storing
// 31, the terms loaded and added once) measured 3.6% slower. No load
// touches a 16-byte block that holds no byte of its range, so nothing past
// a row's end is read.
//
// Contract, as csrc/collective.cuh's: a full-peer entry barrier on the flag
// words (a member reads or writes every peer's rows, not only its
// neighbors': B9's barrier), each wait bounded by %globaltimer with the
// error word, new epochs per launch. The entry barrier guards the start: no
// member reads a peer's input or stores into a peer's output before that
// peer's launch has begun, and so before the peer's own earlier work on
// them is done. The exit barrier guards the end: a member's launch ends only
// when every member has read its share of that member's input (B5, B7: the
// member may rewrite its input once its launch ends) and written its share
// of that member's output (B4, B7: every member writes into every member's
// row, so a member's result is complete only then). On one card the stream
// already orders every reader and writer around the launch, so both matter
// only on separate cards; the exit barrier cost B5 under 0.1% at the bucket
// (measured on the H100). The grid is half the card, as every ring
// kernel's: the whole card measured no faster for B5 at the bucket.

constexpr int kRsVecs = 2;   // vectors of a range a thread sums at once (B5, B7)
constexpr int kRsGroup = 4;  // terms whose loads go out together
constexpr int kAgVecs = 4;   // vectors of a range a thread moves at once (B4)

__device__ __forceinline__ unsigned long long l2_evict_first() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// A 16-byte load of an input no one writes during the launch.
__device__ __forceinline__ int4 ld_once(const int4* p, unsigned long long policy) {
  int4 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.s32 {%0, %1, %2, %3}, [%4], %5;"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p), "l"(policy));
  return v;
}

// The 16 bytes that start ``sh`` bytes into the aligned vector ``lo``
// (0 < sh < 16), the rest from the next vector ``hi``.
__device__ __forceinline__ int4 shift16(int4 lo, int4 hi, int sh) {
  unsigned t0, t1, t2, t3, t4;
  switch (sh >> 2) {
    case 0: t0 = lo.x; t1 = lo.y; t2 = lo.z; t3 = lo.w; t4 = hi.x; break;
    case 1: t0 = lo.y; t1 = lo.z; t2 = lo.w; t3 = hi.x; t4 = hi.y; break;
    case 2: t0 = lo.z; t1 = lo.w; t2 = hi.x; t3 = hi.y; t4 = hi.z; break;
    default: t0 = lo.w; t1 = hi.x; t2 = hi.y; t3 = hi.z; t4 = hi.w; break;
  }
  const unsigned b = (sh & 3) * 8;
  return make_int4(__funnelshift_r(t0, t1, b), __funnelshift_r(t1, t2, b),
                   __funnelshift_r(t2, t3, b), __funnelshift_r(t3, t4, b));
}

// a + b in T by add16's rule (the one element in lane 0 of two vectors)
template <typename T>
__device__ __forceinline__ T add1(T a, T b) {
  int4 va = {}, vb = {};
  *reinterpret_cast<T*>(&va) = a;
  *reinterpret_cast<T*>(&vb) = b;
  int4 s = add16<T>(va, vb);
  return *reinterpret_cast<T*>(&s);
}

// All threads: a full-peer barrier of stream h, channel c, on flag ``word``
// (3 at entry, 2 at exit). Member k raises its word, and thread p waits for
// member p's: every peer's, since k reads or writes them all. False when a
// wait timed out or another block already failed.
__device__ bool peer_barrier(const RingArgs& a, int k, int h, int c, int word, int what) {
  __shared__ int bad;
  signal(flag(a, k, h, c, word), mark(a, 1));
  if (threadIdx.x == 0) bad = 0;
  __syncthreads();
  const int p = threadIdx.x;
  if (p < a.n && p != k &&
      !spin_geq(flag(a, p, h, c, word), mark(a, 1), a.err, a.timeout_ns,
                {a.kernel, k, p, a.cid, h, c, what}))
    atomicOr(&bad, 1);
  __syncthreads();
  return bad == 0;
}

// The outputs of one range grouped by their offset mod 16 bytes (a class),
// in shared memory.
struct Dests {
  char* dst[kMaxMembers];      // the outputs, grouped by class
  int first[kMaxMembers + 1];  // class g holds dst[first[g] .. first[g+1])
  int offset[kMaxMembers];     // class g's offset mod 16
  long long head[kMaxMembers]; // elements before class g's first 16-byte boundary
  long long vecs[kMaxMembers]; // class g's whole vectors after them
  long long len;               // elements of the range
  int classes;
  bool shifted;                // a term lies at another offset mod 16 than a class
};

__device__ __forceinline__ int mod16(const void* p) {
  return (int)(reinterpret_cast<uintptr_t>(p) & 15);
}

// One thread: ``g`` for ``nd`` outputs (``dst(i)``: output i) of a range
// of ``len`` elements of T whose ``nt`` terms start at ``term``.
template <typename T, typename Dst>
__device__ void group_dests(Dests& g, Dst dst, int nd, const char* const* term, int nt,
                            long long len) {
  constexpr long long kElems = 16 / sizeof(T);
  g.len = len;
  g.classes = 0;
  g.shifted = false;
  for (int i = 0; i < nd; ++i) {
    int c = 0;
    while (c < g.classes && g.offset[c] != mod16(dst(i))) ++c;
    if (c == g.classes) g.offset[g.classes++] = mod16(dst(i));
  }
  int k = 0;
  for (int c = 0; c < g.classes; ++c) {
    g.first[c] = k;
    for (int i = 0; i < nd; ++i)
      if (mod16(dst(i)) == g.offset[c]) g.dst[k++] = dst(i);
    const long long to_vector = ((16 - g.offset[c]) & 15) / (long long)sizeof(T);
    g.head[c] = len < to_vector ? len : to_vector;
    g.vecs[c] = (len - g.head[c]) / kElems;
    for (int j = 0; j < nt; ++j) g.shifted |= mod16(term[j] + g.head[c] * sizeof(T)) != 0;
  }
  g.first[g.classes] = k;
}

// One turn of a thread: vectors i, i + kThreads, ... (kVecs of them, those
// below ``vecs``) of the range ``off`` bytes into every term and output.
// The chain's sum of the terms' vectors is stored into each of the ``nd``
// outputs (dst + off is 16-byte aligned; with kShift a term need not be).
// With one term it is a copy.
template <typename T, bool kShift, int kVecs>
__device__ __forceinline__ void chain_turn(const char* const* term, int n, long long off,
                                           char* const* dst, int nd, long long i, long long vecs,
                                           unsigned long long policy) {
  int4 acc[kVecs];
  for (int j0 = 0; j0 < n; j0 += kRsGroup) {
    int4 v[kRsGroup][kVecs], w[kRsGroup][kVecs];  // w: the next aligned vectors (kShift)
    int sh[kRsGroup];
#pragma unroll
    for (int g = 0; g < kRsGroup; ++g) {
      if (j0 + g >= n) break;
      const char* p = term[j0 + g] + off;
      sh[g] = kShift ? mod16(p) : 0;
      const int4* s = reinterpret_cast<const int4*>(p - sh[g]);
#pragma unroll
      for (int u = 0; u < kVecs; ++u) {
        if (i + u * kThreads >= vecs) continue;
        v[g][u] = ld_once(s + i + u * kThreads, policy);
        if (kShift && sh[g]) w[g][u] = ld_once(s + i + u * kThreads + 1, policy);
      }
    }
#pragma unroll
    for (int g = 0; g < kRsGroup; ++g) {
      if (j0 + g >= n) break;
#pragma unroll
      for (int u = 0; u < kVecs; ++u) {
        const int4 t = kShift && sh[g] ? shift16(v[g][u], w[g][u], sh[g]) : v[g][u];
        if constexpr (kAdds<T>)
          acc[u] = j0 + g == 0 ? t : add16<T>(t, acc[u]);
        else
          acc[u] = t;
      }
    }
  }
  for (int e = 0; e < nd; ++e) {
    int4* out = reinterpret_cast<int4*>(dst[e] + off);
#pragma unroll
    for (int u = 0; u < kVecs; ++u)
      if (i + u * kThreads < vecs) __stcs(out + i + u * kThreads, acc[u]);
  }
}

// The C blocks of a member take turns over runs of kVecs·kThreads vectors,
// so that the card reads a narrow window of each term at a time.
template <typename T, bool kShift, int kVecs>
__device__ __forceinline__ void chain_vectors(const char* const* term, int n, long long off,
                                              char* const* dst, int nd, long long vecs, int c,
                                              int C, unsigned long long policy) {
  for (long long i = (long long)c * kVecs * kThreads + threadIdx.x; i < vecs;
       i += (long long)C * kVecs * kThreads)
    chain_turn<T, kShift, kVecs>(term, n, off, dst, nd, i, vecs, policy);
}

// This block's share of the range of ``D``, as channel c of C (the block
// index mod C, taken here so that it is not live across the entry
// barrier): the chain's sum of the ``n`` terms, stored into every output
// of ``D``.
template <typename T, int kVecs>
__device__ void chain_range(const char* const* term, int n, const Dests& D, int C,
                            unsigned long long policy) {
  constexpr long long kElems = 16 / sizeof(T), kSize = sizeof(T);
  const int c = blockIdx.x % C;
  if (D.classes == 1 && !D.shifted) {
    chain_vectors<T, false, kVecs>(term, n, D.head[0] * kSize, D.dst, D.first[1], D.vecs[0], c,
                                   C, policy);
  } else if (D.classes == 1) {
    chain_vectors<T, true, (kVecs + 1) / 2>(term, n, D.head[0] * kSize, D.dst, D.first[1],
                                            D.vecs[0], c, C, policy);
  } else {
    long long most = 0;
    for (int g = 0; g < D.classes; ++g) most = max(most, D.vecs[g]);
    for (long long i = (long long)c * kThreads + threadIdx.x; i < most;
         i += (long long)C * kThreads)
      for (int g = 0; g < D.classes; ++g)
        chain_turn<T, true, 1>(term, n, D.head[g] * kSize, D.dst + D.first[g],
                               D.first[g + 1] - D.first[g], i, D.vecs[g], policy);
  }
  // each class's elements [0, head) and [head + vecs·kElems, len), one by one
  for (int g = 0; g < D.classes; ++g) {
    const long long head = D.head[g], rest = head + D.vecs[g] * kElems,
                    singles = head + D.len - rest;
    for (long long t = (long long)c * kThreads + threadIdx.x; t < singles;
         t += (long long)C * kThreads) {
      const long long e = t < head ? t : rest + (t - head);
      T acc = __ldcs(reinterpret_cast<const T*>(term[0]) + e);
      if constexpr (kAdds<T>)
        for (int j = 1; j < n; ++j)
          acc = add1<T>(__ldcs(reinterpret_cast<const T*>(term[j]) + e), acc);
      for (int k = D.first[g]; k < D.first[g + 1]; ++k)
        __stcs(reinterpret_cast<T*>(D.dst[k]) + e, acc);
    }
  }
}

// B5: member k's slot k. ``x`` holds the members' unpadded rows of W·per
// elements; slot k starts k·per elements in.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ring_rs_kernel(RingArgs a) {
  const int n = a.n, k = blockIdx.y, c = blockIdx.x, d = a.dir[0];
  const long long per = a.slot_bytes / (long long)sizeof(T);
  // term[j]: the chain's (j+1)-th term, slot k of member k + (j+1)·d
  __shared__ const char* term[kMaxMembers];
  __shared__ Dests dests;
  if (threadIdx.x < n)
    term[threadIdx.x] = a.x[mod(k + ((int)threadIdx.x + 1) * d, n)] + k * a.slot_bytes;
  __syncthreads();
  if (threadIdx.x == 0) group_dests<T>(dests, [&](int) { return a.out[k]; }, 1, term, n, per);
  if (!peer_barrier(a, k, 0, c, 3, kWaitPeers)) return;  // its __syncthreads publish dests
  chain_range<T, kRsVecs>(term, n, dests, a.C, l2_evict_first());
  // channel c of every member has read its share of this member's row
  peer_barrier(a, k, 0, c, 2, kWaitPeersExit);
}

// B7: member o's blocks of stream h sum chunk q = o·S + h of every row and
// store it into every member's output row.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ring_ar_kernel(RingArgs a) {
  const int n = a.n, o = blockIdx.y, h = blockIdx.x / a.C, c = blockIdx.x % a.C, d = a.dir[h];
  const long long k = a.slot_bytes / (long long)sizeof(T);  // elements of a chunk
  const long long lo = ((long long)o * a.S + h) * k;
  const long long len = max(0LL, min(k, a.row_elems - lo));
  // term[j]: the chain's (j+1)-th term, chunk q of member o + (j+1)·d
  __shared__ const char* term[kMaxMembers];
  __shared__ Dests dests;
  if (threadIdx.x < n)
    term[threadIdx.x] = a.x[mod(o + ((int)threadIdx.x + 1) * d, n)] + lo * (long long)sizeof(T);
  __syncthreads();
  if (threadIdx.x == 0)
    group_dests<T>(dests, [&](int r) { return a.out[r] + lo * (long long)sizeof(T); }, n, term,
                   n, len);
  if (!peer_barrier(a, o, h, c, 3, kWaitPeers)) return;
  chain_range<T, kRsVecs>(term, n, dests, a.C, l2_evict_first());
  // channel (h, c) of every member has read this member's chunks and
  // written its own into this member's row (the indices taken anew: fewer
  // registers live across the sum)
  peer_barrier(a, blockIdx.y, blockIdx.x / a.C, blockIdx.x % a.C, 2, kWaitPeersExit);
}

// B4: bytes. Contribution j (``slot_bytes`` from x[j], cut where it would
// pass ``extent`` bytes of an output row) lands slot_stride·j bytes into
// every member's output row.
__global__ void __launch_bounds__(kThreads, 2) ring_ag_kernel(RingArgs a) {
  const int n = a.n, m = blockIdx.y, c = blockIdx.x;
  auto bytes = [&](int j) { return max(0LL, min(a.slot_bytes, a.extent - j * a.slot_stride)); };
  __shared__ const char* src[1];
  __shared__ Dests dests;
  // member m's contribution into slot m of every row
  if (threadIdx.x == 0) {
    src[0] = a.x[m];
    group_dests<unsigned char>(dests, [&](int r) { return a.out[r] + m * a.slot_stride; }, n,
                               src, 1, bytes(m));
  }
  if (!peer_barrier(a, m, 0, c, 3, kWaitPeers)) return;
  chain_range<unsigned char, kAgVecs>(src, 1, dests, a.C, l2_evict_first());
  // channel c of every member has written its share into this member's row
  peer_barrier(a, m, 0, c, 2, kWaitPeersExit);
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
// _rs_phase_q): the RS step of the schedule at the top of this file, with
// its credits and flags, the send path quantizing into the right neighbor's
// staging and the fold dequantizing before it adds. Payload and scales of a
// hop share the receive flag.
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
  // Phase barrier (pallas_ccl.py:701-706): the all-gather phase reuses the
  // receive and credit flags, and its stores into the right neighbor's slots
  // land only after that neighbor's RS phase has read and folded them.
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
// moves bytes. wire (B6, B8): 0 fp8 e4m3fn, 1 int8. Tables hold one address
// per member. B4, B5 and B7 take the caller's unpadded rows and no scratch
// (``buf`` and ``stage`` null), at any element alignment:
//   B4: ``x`` holds each member's contribution of slot_bytes bytes, ``out``
//     each member's output row; contribution j lands slot_stride·j bytes
//     into every row, cut where it would pass ``extent`` bytes of the row.
//   B5: ``x`` holds each member's row of row_elems = n * per elements,
//     slot_bytes is per * itemsize, ``out`` each member's per results.
//   B7: ``x`` and ``out`` hold each member's row of row_elems elements, and
//     slot_bytes is one chunk, ceil(row_elems / (n * S)) * itemsize.
// B6 and B8 take padded slots of slot_bytes, a whole number of 16-byte
// vectors: ``x`` the members' [n][S][slot] payloads, B6 ``buf`` its data
// slots, ``stage`` its payload staging, ``sstage`` its scale staging and
// ``out`` its output; B8 ``buf`` its output and ``qbuf`` and ``sbuf`` its
// gather buffers besides. ``live`` launches members [0, live) only
// (live < n is a test of the spin bound: the missing members' peers time
// out). Returns 0, a cudaError_t, or -1 for arguments out of range.
int uccl_ring_launch(int kernel, int dtype, int wire, int n, int live, int S, int dir0, int dir1,
                     long long slot_bytes, long long row_elems, long long slot_stride,
                     long long extent, const void* const* x, void* const* buf,
                     void* const* stage, void* const* out, void* const* sstage,
                     void* const* qbuf, void* const* sbuf, void* const* flags, void* err,
                     int cid, unsigned long long epoch, unsigned long long timeout_ns,
                     void* stream) {
  static const int kItem[] = {4, 2, 2, 4};
  const bool quant = kernel == kRSQ || kernel == kARQ;
  if (n < 2 || n > kMaxMembers || live < 1 || live > n || (S != 1 && S != 2) ||
      (kernel != kAR && kernel != kARQ && S != 1) || kernel < kAG || kernel > kARQ)
    return -1;
  if (kernel == kAG || kernel == kRS || kernel == kAR) {
    for (int r = 0; r < n; ++r)
      if ((buf && buf[r]) || (stage && stage[r]) || !out || !out[r] || !x[r]) return -1;
  }
  if (kernel == kAG) {
    if (slot_bytes <= 0 || slot_stride < slot_bytes || extent <= 0) return -1;
  } else if (kernel == kRS) {
    if (dtype < 0 || dtype > 3 || slot_bytes <= 0 || slot_bytes % kItem[dtype] ||
        row_elems != n * (slot_bytes / kItem[dtype]))
      return -1;
  } else if (kernel == kAR) {
    if (dtype < 0 || dtype > 3 || row_elems <= 0 ||
        slot_bytes != (row_elems + n * S - 1) / (n * S) * kItem[dtype])
      return -1;
  } else if (slot_bytes <= 0 || slot_bytes % 16) {
    return -1;
  }
  RingArgs a = {};
  for (int r = 0; r < n; ++r) {
    a.x[r] = static_cast<const char*>(x[r]);
    a.buf[r] = buf ? static_cast<char*>(buf[r]) : nullptr;
    a.stage[r] = stage ? static_cast<char*>(stage[r]) : nullptr;
    a.out[r] = out ? static_cast<char*>(out[r]) : nullptr;
    a.sstage[r] = sstage ? static_cast<float*>(sstage[r]) : nullptr;
    a.qbuf[r] = qbuf ? static_cast<char*>(qbuf[r]) : nullptr;
    a.sbuf[r] = sbuf ? static_cast<float*>(sbuf[r]) : nullptr;
    a.flags[r] = static_cast<unsigned long long*>(flags[r]);
  }
  a.err = static_cast<int*>(err);
  a.slot_bytes = slot_bytes;
  a.row_elems = row_elems;
  a.slot_stride = slot_stride;
  a.extent = extent;
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
