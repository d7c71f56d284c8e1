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
// Members. Each kernel takes a table of per-member base addresses: the
// caller's inputs and outputs, as they are, and flag words. One launch runs
// every member of the world: blockIdx.y is the member, and blockIdx.x
// splits its work into independent channels (and, for B7 and B8, the two
// counter-rotating streams), each with its own flags, so many SMs move each
// member's bytes. On one card every address in the table lies in the same
// HBM; members on separate cards need only another table (peer or IPC
// addresses) and the .sys memory scope.
//
// None of the five is a ring on this card: each is one pass that reads
// every input byte once and writes every result byte once, in its final
// place (set out above ring_rs_kernel, and for the quantized wire above
// ring_rsq_kernel). They compute the ring's result bit for bit, in the
// order its hops would add, without running its hops: no staging, no
// per-hop flags, no credit window.
//
// Synchronization. The TPU kernels' barrier semaphores become 64-bit flag
// words holding (epoch << 32) | count (csrc/collective.cuh): a full-peer
// entry barrier and a full-peer exit barrier per channel (peer_barrier).
// Each flag has exactly one writer, and the host gives every launch on a
// flag region a new epoch, so a stale flag from an earlier launch can never
// let a wait through.
//
// Deadlock and faults, as csrc/collective.cuh sets out for every collective
// kernel: cooperative launches on at most half the card (the two kernels of
// a bidirectional pair can both be resident), and every spin bounded by
// %globaltimer with an error word (kernel, member, peer awaited, collective
// id, stream, channel, which wait) that the host wrapper raises on.
//
// Bound. All five move bytes and do a handful of operations per element
// (B6 and B8 a codec round trip per element and link): HBM bandwidth bounds
// them (3.35 TB/s on an H100 SXM).

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

constexpr int kFlagWords = 2;  // the full-peer barriers' words: entry, exit
constexpr int kEntry = 0, kExit = 1;

constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 128;     // elements of one quantization row
constexpr float kScaleTiny = 1.17549435e-38f;  // smallest normal f32

enum Kernel { kAG = 0, kRS = 1, kAR = 2, kRSQ = 3, kARQ = 4 };
enum Wire { kFp8 = 0, kInt8 = 1 };
// The full-peer barriers (kWaitPeers at entry, kWaitPeersExit at exit): the
// error word's step is the peer awaited
enum Wait { kWaitPeers = 0, kWaitPeersExit = 1 };

struct RingArgs {
  const char* x[kMaxMembers];        // member inputs (B4: contributions)
  char* out[kMaxMembers];            // member outputs
  unsigned long long* flags[kMaxMembers];  // member flags ([2][kMaxChannels][kFlagWords])
  int* err;                          // error word of the flag region: 8 ints
  long long slot_bytes;              // B5, B6: one slot; B7, B8: one chunk;
                                     // B4: one contribution
  long long row_elems;               // B5-B8: elements of a member's input row
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
// (kEntry or kExit). Member k raises its word, and thread p waits for
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
  if (!peer_barrier(a, k, 0, c, kEntry, kWaitPeers)) return;  // its __syncthreads publish dests
  chain_range<T, kRsVecs>(term, n, dests, a.C, l2_evict_first());
  // channel c of every member has read its share of this member's row
  peer_barrier(a, k, 0, c, kExit, kWaitPeersExit);
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
  if (!peer_barrier(a, o, h, c, kEntry, kWaitPeers)) return;
  chain_range<T, kRsVecs>(term, n, dests, a.C, l2_evict_first());
  // channel (h, c) of every member has read this member's chunks and
  // written its own into this member's row (the indices taken anew: fewer
  // registers live across the sum)
  peer_barrier(a, blockIdx.y, blockIdx.x / a.C, blockIdx.x % a.C, kExit, kWaitPeersExit);
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
  if (!peer_barrier(a, m, 0, c, kEntry, kWaitPeers)) return;
  chain_range<unsigned char, kAgVecs>(src, 1, dests, a.C, l2_evict_first());
  // channel c of every member has written its share into this member's row
  peer_barrier(a, m, 0, c, kExit, kWaitPeersExit);
}

// ---------------------------------------------------------------------------
// B6 and B8: the quantized wire, one pass each (replace the quantized
// kernels of ring_reduce_scatter, pallas_ccl.py:621, and ring_all_reduce,
// :742)
//
// What they compute, bit for bit as the JAX kernels and the hop schedules
// (rs_q_plain, ar_q_plain; the contracts rs_q_chain_plain and
// ar_q_chain_plain in collective/ring_ccl.py). On the ring every RS hop
// crosses the wire block-quantized: the sender quantizes its partial sum
// per 128-element row (wire = fp8 e4m3fn or int8; the uccl_tpu/ops/quant.py
// rule: scale = amax * (1 / QMAX) floored at the smallest normal f32, 1.0
// for an all-zero row, +inf for a row holding any inf or nan), and the
// receiver dequantizes it (payload * scale, rounded to the input dtype)
// before one correctly rounded add of its own term in the input dtype. So
// slot k is the chain of B5 with one round trip RT at every link:
//   acc = x[k+d][k];  acc = x[k+j·d][k] + RT(acc) for j = 2..W
// RT works on 128-element rows counted from the slot's (B8: the chunk's)
// start; a last short row's missing elements are the zeros the ring's
// padded slots hold there.
//   B6: member k's output is acc.
//   B8: the chunks of B7, each summed so in its stream's direction, then
//     round-tripped once more: the ring's owner quantizes its reduced slot
//     once and every member, the owner too, dequantizes the same wire
//     bytes. That value goes into every member's row.
//
// How. Half a warp owns a 128-element row of the range and each of its 16
// lanes holds 8 of the row's elements, so the row's amax is a register max
// and 4 shuffles and a round trip never leaves the registers; a warp works
// two rows at once. It loads a row's W terms in the chain's order, folds
// each into the partial sum with one codec round trip, and stores the
// result once (B6: into the member's output; B8: into every member's). So
// each input is read once and each output written once, the bound's bytes,
// as for B5 and B7: no staging slot, no gather buffer, no flag between
// neighbours. The codec is most of the instructions here (a division, a
// conversion each way and the row's reduction per element and link), so a
// lane's 8 elements are 8 independent chains of them. Loads of the next
// terms run ahead of the sums: a lane loads kAhead terms ahead, streaming
// across its rows, where W terms of a row in flight would not fit the 64
// registers a thread has at two blocks per SM for W = 16 (a third term
// ahead spills, and moved the times by 2% either way; ring_q_arms). The
// codec is plain CUDA arithmetic: an IEEE division by the scale, __fmul_rn
// and one rounding to T, adds with no fma contraction, no fast-math.
//
// Alignment. A row starts anywhere (a chunk starts q·k elements into a
// member's row, a bidir half size/2 elements in). A lane moves its 8
// elements in units of U bytes, the largest of 16, 4 and the element on
// which every term and output of the range starts: unit u of lane l holds
// elements e·(l + 16·u) .. e·(l + 16·u) + e - 1 (e = U / itemsize), so every
// access of a half warp is one contiguous run (the same bytes whatever U,
// more instructions for a smaller one). The elements' assignment to lanes
// does not change any result: the codec is element-wise but for the row's
// amax, which its half warp takes.
//
// Contract: B5's and B7's, the full-peer entry and exit barriers.

template <typename T> struct Elem;  // conversions and the add in T

template <> struct Elem<float> {
  __device__ __forceinline__ static float to_f(float v) { return v; }
  __device__ __forceinline__ static float from_f(float f) { return f; }
  __device__ __forceinline__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ __forceinline__ static float from_bits(unsigned b) { return __uint_as_float(b); }
  __device__ __forceinline__ static unsigned bits(float v) { return __float_as_uint(v); }
};

template <> struct Elem<__nv_bfloat16> {
  __device__ __forceinline__ static float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ __forceinline__ static __nv_bfloat16 from_f(float f) {
    return __float2bfloat16_rn(f);
  }
  __device__ __forceinline__ static __nv_bfloat16 add(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __hadd(a, b);
  }
  __device__ __forceinline__ static __nv_bfloat16 from_bits(unsigned b) {
    return __ushort_as_bfloat16((unsigned short)b);
  }
  __device__ __forceinline__ static unsigned bits(__nv_bfloat16 v) {
    return __bfloat16_as_ushort(v);
  }
};

template <> struct Elem<__half> {
  __device__ __forceinline__ static float to_f(__half v) { return __half2float(v); }
  __device__ __forceinline__ static __half from_f(float f) { return __float2half_rn(f); }
  __device__ __forceinline__ static __half add(__half a, __half b) { return __hadd(a, b); }
  __device__ __forceinline__ static __half from_bits(unsigned b) {
    return __ushort_as_half((unsigned short)b);
  }
  __device__ __forceinline__ static unsigned bits(__half v) { return __half_as_ushort(v); }
};

constexpr int kPer = 8;  // elements of a row a lane holds

// A lane's kPer elements of a row as raw words (f32: one word each; 16-bit:
// two to a word, the lower element in the low half), the form loads fill.
template <typename T> struct Raw {
  static constexpr int kWords = kPer * sizeof(T) / 4;
  unsigned w[kWords];
  __device__ __forceinline__ T get(int i) const {
    return Elem<T>::from_bits(sizeof(T) == 4 ? w[i] : w[i >> 1] >> (16 * (i & 1)));
  }
};

// Element i of the lane at ``l`` (0..15) in its half warp, moved in units of
// kUnit bytes.
template <typename T, int kUnit>
__device__ __forceinline__ int elem_of(int l, int i) {
  constexpr int e = kUnit / sizeof(T);
  return e * (l + 16 * (i / e)) + i % e;
}

// This lane's share of the row at ``row`` (``len`` <= 128 elements of it
// exist, none when ``len`` is 0; the missing ones read as zeros). The loads
// take the non-coherent path: the terms are read once and never written
// during the launch (with B5's L2 evict-first hint as well, B6 and B8
// measured 2-10% slower; ring_q_arms).
template <typename T, int kUnit>
__device__ __forceinline__ Raw<T> load_row(const char* row, int l, int len) {
  Raw<T> r;
  constexpr int e = kUnit / sizeof(T);
  if (len == kLanes) {
#pragma unroll
    for (int u = 0; u < kPer / e; ++u) {
      const char* p = row + (size_t)elem_of<T, kUnit>(l, u * e) * sizeof(T);
      if constexpr (kUnit == 16) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(p));
        r.w[4 * u] = v.x; r.w[4 * u + 1] = v.y; r.w[4 * u + 2] = v.z; r.w[4 * u + 3] = v.w;
      } else if constexpr (kUnit == 4) {
        r.w[u] = __ldg(reinterpret_cast<const unsigned*>(p));
      } else {
        const unsigned h = __ldg(reinterpret_cast<const unsigned short*>(p));
        r.w[u >> 1] = (u & 1) ? r.w[u >> 1] | h << 16 : h;
      }
    }
    return r;
  }
#pragma unroll
  for (int k = 0; k < Raw<T>::kWords; ++k) r.w[k] = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int x = elem_of<T, kUnit>(l, i);
    if (x >= len) continue;
    if constexpr (sizeof(T) == 4)
      r.w[i] = __ldg(reinterpret_cast<const unsigned*>(row) + x);
    else
      r.w[i >> 1] |= (unsigned)__ldg(reinterpret_cast<const unsigned short*>(row) + x)
                     << (16 * (i & 1));
  }
  return r;
}

// This lane's kPer values into the row at ``row`` (``len`` elements of it).
template <typename T, int kUnit>
__device__ __forceinline__ void store_row(char* row, int l, int len, const T v[kPer]) {
  constexpr int e = kUnit / sizeof(T);
  auto word = [&](int i) {  // the word of elements i (and i + 1 for 16-bit)
    return sizeof(T) == 4 ? Elem<T>::bits(v[i])
                          : Elem<T>::bits(v[i]) | Elem<T>::bits(v[i + 1]) << 16;
  };
  if (len == kLanes) {
#pragma unroll
    for (int u = 0; u < kPer / e; ++u) {
      char* p = row + (size_t)elem_of<T, kUnit>(l, u * e) * sizeof(T);
      constexpr int step = 4 / sizeof(T);  // elements of a word
      if constexpr (kUnit == 16)
        __stcs(reinterpret_cast<uint4*>(p),
               make_uint4(word(u * e), word(u * e + step), word(u * e + 2 * step),
                          word(u * e + 3 * step)));
      else if constexpr (kUnit == 4)
        __stcs(reinterpret_cast<unsigned*>(p), word(u * e));
      else
        __stcs(reinterpret_cast<unsigned short*>(p), (unsigned short)Elem<T>::bits(v[u]));
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int x = elem_of<T, kUnit>(l, i);
    if (x >= len) continue;
    if constexpr (sizeof(T) == 4)
      __stcs(reinterpret_cast<unsigned*>(row) + x, Elem<T>::bits(v[i]));
    else
      __stcs(reinterpret_cast<unsigned short*>(row) + x, (unsigned short)Elem<T>::bits(v[i]));
  }
}

template <int W> struct WireCodec;

template <> struct WireCodec<kFp8> {
  static constexpr float kQmax = 448.0f;  // max normal of e4m3fn
  // q0 and q1 into two bytes, q0 in the low one. satfinite is the codec's
  // clip to ±QMAX (no finite quotient is past it by more than a rounding,
  // and no quotient is infinite); a nan stays nan.
  __device__ __forceinline__ static unsigned encode2(float q0, float q1) {
    return __nv_cvt_float2_to_fp8x2(make_float2(q0, q1), __NV_SATFINITE, __NV_E4M3);
  }
  __device__ __forceinline__ static float2 decode2(unsigned b) {
    return __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
        (__nv_fp8x2_storage_t)(b & 0xffffu), __NV_E4M3)));
  }
};

template <> struct WireCodec<kInt8> {
  static constexpr float kQmax = 127.0f;
  __device__ __forceinline__ static unsigned encode1(float q) {
    q = q < -kQmax ? -kQmax : (q > kQmax ? kQmax : q);  // a nan passes through
    return (unsigned)__float2int_rn(q) & 0xffu;           // nearest even; nan -> 0
  }
  __device__ __forceinline__ static unsigned encode2(float q0, float q1) {
    return encode1(q0) | encode1(q1) << 8;
  }
  __device__ __forceinline__ static float2 decode2(unsigned b) {
    return make_float2((float)(signed char)(b & 0xffu), (float)(signed char)(b >> 8));
  }
};

// One half warp, one row: the row's quantize -> dequantize round trip of
// this lane's kPer values (of T, held in f32), rounded to T. The scale:
// amax * (1 / QMAX), the reciprocal rounded to f32 once (XLA compiles the
// JAX package's amax / QMAX to this product), floored at the smallest
// normal f32; 1.0 for an all-zero row; +inf for a row holding any inf or
// nan. Dequantized as payload * scale (the codec reads a nan scale or one
// under the floor as 0; this scale is neither).
template <typename T, int W>
__device__ __forceinline__ void round_trip(const float f[kPer], T out[kPer]) {
  float amax = 0.0f;
  bool bad = false;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    amax = fmaxf(amax, fabsf(f[i]));
    bad |= !isfinite(f[i]);  // fmaxf drops a nan: non-finite elements tracked beside
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)  // within the half warp
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  bad = (__ballot_sync(0xffffffffu, bad) >> (threadIdx.x & 16)) & 0xffffu;
  constexpr float inv_qmax = 1.0f / WireCodec<W>::kQmax;
  float scale = amax > 0.0f ? fmaxf(__fmul_rn(amax, inv_qmax), kScaleTiny) : 1.0f;
  if (bad) scale = CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < kPer; i += 2) {
    const float2 d = WireCodec<W>::decode2(
        WireCodec<W>::encode2(__fdiv_rn(f[i], scale), __fdiv_rn(f[i + 1], scale)));
    out[i] = Elem<T>::from_f(__fmul_rn(d.x, scale));
    out[i + 1] = Elem<T>::from_f(__fmul_rn(d.y, scale));
  }
}

// This block's share of the range (``len`` elements from each of the ``n``
// terms and ``nd`` outputs; channel blockIdx.x mod C of C): warp w of
// channel c takes row pairs c·kWarps + w, then every C·kWarps-th, the lower
// half warp the pair's first row. Each row's terms are folded in the
// chain's order, one round trip a link (and one more with kFinal), and the
// result stored into every output. The partial sum lives in f32 registers
// (each value one of T's), and row indices are 32-bit: a row is 128
// elements, so a range would need 2^38 of them to overflow.
template <typename T, int W, int kUnit, bool kFinal>
__device__ void quant_chain(const char* const* term, int n, char* const* dst, int nd,
                            long long len, int C) {
  constexpr int kAhead = 2;  // terms a lane loads ahead: 64 bytes f32, 32 bytes 16-bit
  constexpr long long kRowBytes = kLanes * (long long)sizeof(T);
  const int l = threadIdx.x & 15, half = (threadIdx.x >> 4) & 1;
  const int rows = (int)((len + kLanes - 1) / kLanes);
  const int tail = (int)(len - (long long)(rows - 1) * kLanes);  // elements of the last row
  const int pairs = (rows + 1) / 2;
  const int first = (int)(blockIdx.x % C) * kWarps + (threadIdx.x >> 5), stride = C * kWarps;
  if (first >= pairs) return;
  auto row_len = [&](int row) { return row < rows - 1 ? kLanes : row == rows - 1 ? tail : 0; };
  const int loads = (pairs - first + stride - 1) / stride * n;
  // the load cursor: kAhead terms ahead of the fold
  int lpair = first, lj = 0;
  auto next = [&](bool live) {
    Raw<T> r = {};
    const int row = 2 * lpair + half;
    if (live)
      r = load_row<T, kUnit>(term[lj] + row * kRowBytes, l, row_len(row));
    if (++lj == n) { lj = 0; lpair += stride; }
    return r;
  };
  Raw<T> ring[kAhead];
#pragma unroll
  for (int s = 0; s < kAhead; ++s) ring[s] = next(s < loads);
  int pair = first, j = 0;
  float acc[kPer];
  for (int t0 = 0; t0 < loads; t0 += kAhead) {
#pragma unroll
    for (int s = 0; s < kAhead; ++s) {
      if (t0 + s >= loads) break;
      const Raw<T>& v = ring[s];  // refilled once folded
      if (j == 0) {
#pragma unroll
        for (int i = 0; i < kPer; ++i) acc[i] = Elem<T>::to_f(v.get(i));
      } else {
        T rt[kPer];
        round_trip<T, W>(acc, rt);
#pragma unroll
        for (int i = 0; i < kPer; ++i) acc[i] = Elem<T>::to_f(Elem<T>::add(v.get(i), rt[i]));
      }
      if (++j == n) {
        T out[kPer];
        if (kFinal) {
          round_trip<T, W>(acc, out);
        } else {
#pragma unroll
          for (int i = 0; i < kPer; ++i) out[i] = Elem<T>::from_f(acc[i]);  // exact: a T
        }
        const int row = 2 * pair + half, rl = row_len(row);
        if (rl)
          for (int e = 0; e < nd; ++e) store_row<T, kUnit>(dst[e] + row * kRowBytes, l, rl, out);
        j = 0;
        pair += stride;
      }
      ring[s] = next(t0 + s + kAhead < loads);
    }
  }
}

// One thread: the largest unit (16 bytes, 4, the element) on which every
// term and output of the range starts.
template <typename T>
__device__ int quant_unit(const char* const* term, int n, char* const* dst, int nd) {
  uintptr_t bits = 0;
  for (int j = 0; j < n; ++j) bits |= reinterpret_cast<uintptr_t>(term[j]);
  for (int e = 0; e < nd; ++e) bits |= reinterpret_cast<uintptr_t>(dst[e]);
  return (bits & 15) == 0 ? 16 : (bits & 3) == 0 ? 4 : (int)sizeof(T);
}

template <typename T, int W, bool kFinal>
__device__ __forceinline__ void quant_range(const char* const* term, int n, char* const* dst,
                                            int nd, long long len, int unit, int C) {
  if (unit == 16) {
    quant_chain<T, W, 16, kFinal>(term, n, dst, nd, len, C);
  } else if constexpr (sizeof(T) == 4) {
    quant_chain<T, W, 4, kFinal>(term, n, dst, nd, len, C);
  } else {
    if (unit == 4)
      quant_chain<T, W, 4, kFinal>(term, n, dst, nd, len, C);
    else
      quant_chain<T, W, 2, kFinal>(term, n, dst, nd, len, C);
  }
}

// B6: member k's slot k, as B5's (``x`` the members' unpadded rows of W·per
// elements; slot k starts k·per elements in).
template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 2) ring_rsq_kernel(RingArgs a) {
  const int n = a.n, k = blockIdx.y, c = blockIdx.x, d = a.dir[0];
  const long long per = a.slot_bytes / (long long)sizeof(T);
  // term[j]: the chain's (j+1)-th term, slot k of member k + (j+1)·d
  __shared__ const char* term[kMaxMembers];
  __shared__ char* dst[1];
  __shared__ int unit;
  if (threadIdx.x < n)
    term[threadIdx.x] = a.x[mod(k + ((int)threadIdx.x + 1) * d, n)] + k * a.slot_bytes;
  if (threadIdx.x == 0) dst[0] = a.out[k];
  __syncthreads();
  if (threadIdx.x == 0) unit = quant_unit<T>(term, n, dst, 1);
  if (!peer_barrier(a, k, 0, c, kEntry, kWaitPeers)) return;  // its __syncthreads publish unit
  quant_range<T, W, false>(term, n, dst, 1, per, unit, a.C);
  peer_barrier(a, blockIdx.y, 0, blockIdx.x, kExit, kWaitPeersExit);
}

// B8: member o's blocks of stream h sum chunk q = o·S + h of every row, as
// B7's, and store its last round trip into every member's output row.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 2) ring_arq_kernel(RingArgs a) {
  const int n = a.n, o = blockIdx.y, h = blockIdx.x / a.C, c = blockIdx.x % a.C, d = a.dir[h];
  const long long k = a.slot_bytes / (long long)sizeof(T);  // elements of a chunk
  const long long lo = ((long long)o * a.S + h) * k;
  const long long len = max(0LL, min(k, a.row_elems - lo));
  __shared__ const char* term[kMaxMembers];
  __shared__ char* dst[kMaxMembers];
  __shared__ int unit;
  if (threadIdx.x < n) {
    term[threadIdx.x] = a.x[mod(o + ((int)threadIdx.x + 1) * d, n)] + lo * (long long)sizeof(T);
    dst[threadIdx.x] = a.out[threadIdx.x] + lo * (long long)sizeof(T);
  }
  __syncthreads();
  if (threadIdx.x == 0) unit = quant_unit<T>(term, n, dst, n);
  if (!peer_barrier(a, o, h, c, kEntry, kWaitPeers)) return;
  quant_range<T, W, true>(term, n, dst, n, len, unit, a.C);
  peer_barrier(a, blockIdx.y, blockIdx.x / a.C, blockIdx.x % a.C, kExit, kWaitPeersExit);
}

}  // namespace

extern "C" {

// kernel: 0 = all-gather (B4), 1 = reduce-scatter (B5), 2 = all-reduce (B7),
// 3 = quantized reduce-scatter (B6), 4 = quantized all-reduce (B8).
// dtype (B5-B8): 0 float32, 1 bfloat16, 2 float16, 3 int32 (B5, B7 only); B4
// moves bytes. wire (B6, B8): 0 fp8 e4m3fn, 1 int8. Tables hold one address
// per member. Every kernel takes the caller's unpadded rows and no scratch,
// at any element alignment:
//   B4: ``x`` holds each member's contribution of slot_bytes bytes, ``out``
//     each member's output row; contribution j lands slot_stride·j bytes
//     into every row, cut where it would pass ``extent`` bytes of the row.
//   B5, B6: ``x`` holds each member's row of row_elems = n * per elements,
//     slot_bytes is per * itemsize, ``out`` each member's per results.
//   B7, B8: ``x`` and ``out`` hold each member's row of row_elems elements,
//     and slot_bytes is one chunk, ceil(row_elems / (n * S)) * itemsize.
// ``live`` launches members [0, live) only (live < n is a test of the spin
// bound: the missing members' peers time out). Returns 0, a cudaError_t, or
// -1 for arguments out of range.
int uccl_ring_launch(int kernel, int dtype, int wire, int n, int live, int S, int dir0, int dir1,
                     long long slot_bytes, long long row_elems, long long slot_stride,
                     long long extent, const void* const* x, void* const* out,
                     void* const* flags, void* err, int cid, unsigned long long epoch,
                     unsigned long long timeout_ns, void* stream) {
  static const int kItem[] = {4, 2, 2, 4};
  const bool quant = kernel == kRSQ || kernel == kARQ;
  if (n < 2 || n > kMaxMembers || live < 1 || live > n || (S != 1 && S != 2) ||
      (kernel != kAR && kernel != kARQ && S != 1) || kernel < kAG || kernel > kARQ || !x ||
      !out || !flags)
    return -1;
  for (int r = 0; r < n; ++r)
    if (!x[r] || !out[r] || !flags[r]) return -1;
  // the quantized wire takes the float dtypes
  if (kernel != kAG && (dtype < 0 || dtype > (quant ? 2 : 3))) return -1;
  if (quant && wire != kFp8 && wire != kInt8) return -1;
  if (kernel == kAG) {
    if (slot_bytes <= 0 || slot_stride < slot_bytes || extent <= 0) return -1;
  } else if (kernel == kRS || kernel == kRSQ) {
    if (slot_bytes <= 0 || slot_bytes % kItem[dtype] ||
        row_elems != n * (slot_bytes / kItem[dtype]))
      return -1;
  } else if (row_elems <= 0 ||
             slot_bytes != (row_elems + n * S - 1) / (n * S) * kItem[dtype]) {
    return -1;
  }
  RingArgs a = {};
  for (int r = 0; r < n; ++r) {
    a.x[r] = static_cast<const char*>(x[r]);
    a.out[r] = static_cast<char*>(out[r]);
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
  switch (dtype) {
    UCCL_QUANT_CASE(ring_arq_kernel, 0, float)
    UCCL_QUANT_CASE(ring_arq_kernel, 1, __nv_bfloat16)
    UCCL_QUANT_CASE(ring_arq_kernel, 2, __half)
  }
#undef UCCL_QUANT_CASE
  return -1;
}

// Limits the Python side checks against.
int uccl_ring_max_members() { return kMaxMembers; }
int uccl_ring_max_channels() { return kMaxChannels; }
int uccl_ring_flag_words() { return kFlagWords; }

}  // extern "C"
