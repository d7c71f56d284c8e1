// The expert-parallel all-to-all over a W-member world, for Hopper (sm_90a):
// the fixed-schedule exchange (B9) and one round of the contention-aware
// schedule (B10).
//
// Replaces the Pallas remote-DMA kernels of uccl_tpu/ep/pallas_a2a.py:
//   a2a_kernel          <- _a2a_kernel (pallas_a2a.py:83, call :278)
//   sched_round_kernel  <- _sched_round_kernel (pallas_a2a.py:318, call :359)
//
// Contract (lax.all_to_all(x, 0, 0, tiled=True) on every member at once):
// member r's send view holds W chunks, and chunk d lands in slot r of member
// d's receive buffer: out[d][r] = x[r][d]. The kernels copy bytes; the dtype
// does not matter (bf16 and f32 payloads, the quantized wire's 1-byte
// payloads and f32 scales, int32). A chunk slot is a whole number of
// 16-byte vectors (the wrapper pads chunks to 1024 elements).
//
// B9 is one pass over every (source, destination) pair at once. The TPU
// kernel's schedule (a full-peer entry barrier, then the W-1 exchanges in
// ceil((W-1)/2) steps on two counter-rotating DMA streams, their
// semaphores rotating between two credit slots) is the TPU's DMA engines'
// and is not carried over: sized by one member's chunk slot, it ran a
// 16 KiB slot on 4 blocks of a 132-SM card, each sending its W chunks one
// after another with a fence after each, behind two full-peer waits. Here
// the grid is (X, live): member s's blocks x < X share its W x P items
// (destination offset j / P, piece j % P; block x takes items x, x + X,
// ...), so normally each block copies ONE piece of ONE pair. P and X come
// from the whole exchange (pair_grid): pieces of at least kPieceVecs
// vectors, as many as half the card holds. Piece p of a pair is vectors
// [V p / P, V (p + 1) / P) of its slot. Slots are write-once per source:
// the sender addresses the destination's slot by its own rank, so nothing
// is ever written twice.
//
// Synchronization, per pair, not per world:
// * ready: block x of member s raises its ready word (s, x) first thing,
//   before any wait: member s's stream has reached this launch, so nothing
//   before it on that stream still reads s's receive slots. A block about
//   to write into member d's slots waits on d's ready word (d, x) alone,
//   never on every member's.
// * arrival: each (receiver d, piece p, source s) has one word with one
//   writer, the block that copies that piece, which raises it once, after
//   its one copy: (epoch << 32) | 1 with st.release.gpu behind a
//   __syncthreads (announce). No block fences between copies.
// * exit: block x < P of member d waits for piece x's W-1 arrival words
//   (the TPU kernel's wait_recv, cut to the block's own piece); the other
//   blocks return after their copy. The local pair needs no flag.
// The host gives every launch on a flag region a new epoch, so a word left
// by an earlier launch (of any grid) never lets a wait through.
//
// Members on separate cards (ROADMAP W7) need this protocol and nothing
// else: the tables would hold peer (IPC) addresses and the flag accesses
// the .sys scope. The ready wait is what keeps a sender whose stream runs
// ahead from writing into slots its receiver's earlier work still reads;
// the exit wait is what keeps the receiver's next kernel from reading
// slots still in flight. On one card the launch boundary alone would order
// both. Deadlock: every ready word is raised before its block waits on
// anything, and the cooperative launch makes every block of the grid
// resident at once, so each ready wait ends; each arrival word is raised
// by a block that waits only on a ready word, so each exit wait ends. The
// launch takes at most half the card, so two chunk launches on
// collective-id parity twins are resident together.
//
// B10 is one full-permutation round of a schedule (redesigned in PR 5). On
// a TPU the round kernel's output had to be a fresh VMEM block, so each
// round wrote every member's chunk for pi[r] into a single round slot and
// the wrapper stacked the R rounds and gathered each pair from its
// designated round: two more copies of the whole buffer, 0.93 of the
// schedule's 1.11 ms on the H100 at the EP cell. A launch here can write at
// any offset, so every round now writes straight into the one receive
// buffer B9 writes (out[d][s] = x[s][d]): member r copies x[r][pi[r]] into
// out[pi[r]][r] only when this round is that pair's designated round (its
// bit of ``send_mask``, computed on the host from K), and round 0 (``local``) copies
// every member's diagonal chunk. A shadow duplicate (a pair an earlier
// round carries, kept so that each round stays a full permutation) copies
// nothing but still raises its arrival word, so every member's one wait is
// the same in every round. The whole schedule then moves B9's compulsory
// bytes; what it adds over B9 is R - 1 launches and entry barriers. One
// launch per round, as before; the wrapper rotates collective ids over the
// global launch sequence.
//
// Deadlock and faults, as csrc/collective.cuh sets out for every collective
// kernel (the flag primitives, the bounded spin, B10's vector copy and the
// cooperative launch are that header's, shared with ring_ccl.cu): a launch
// takes at most half the card, so two chunk kernels on collective-id
// parity twins can both be resident, and a wait that times out writes the
// error word (kernel, member, step, collective id, the peer awaited,
// channel, which wait) that the host wrapper raises on. B9's step is the
// destination offset of a ready wait and the piece of an exit wait, its
// channel the block x.
//
// Bound: HBM bandwidth. Each kernel reads every byte it sends once and
// writes it once; B9's compulsory traffic at the EP dispatch buffer is
// 2 x 167.8 MB (0.100 ms at 3.35 TB/s), and so is a whole B10 schedule's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "collective.cuh"

namespace {

using namespace uccl;

constexpr int kEntry = kMaxMembers;          // flag word of B10's entry barrier, B9's ready
constexpr int kFlagWords = kMaxMembers + 1;  // one arrival word per source, then entry
constexpr int kPairThreads = 512;            // B9's block
constexpr int kInFlight = 8;                 // B9's 16-byte loads in flight a thread
constexpr long long kPieceVecs = 512;        // B9's least piece: a vector a thread (8 KiB)

enum Kernel { kA2A = 0, kRound = 1 };
enum Wait { kWaitEntry = 0, kWaitRecv = 1 };

struct A2AArgs {
  const char* x[kMaxMembers];              // member send views ([n][slot_bytes])
  char* out[kMaxMembers];                  // receive slots ([n][slot_bytes])
  unsigned long long* flags[kMaxMembers];  // member flags ([kMaxChannels][kFlagWords])
  int pi[kMaxMembers];                     // B10: destination of each member
  int inv[kMaxMembers];                    // B10: the member that targets each member
  unsigned send_mask;                      // B10: bit r set when member r's pair is due
  int local;                               // B10: this round copies the diagonal
  int* err;                                // error word of the flag region: 8 ints
  long long slot_bytes;                    // one chunk slot
  int n, C;                                // world; B10's channels, B9's pieces per pair
  int drop;                                // B9: s * n + d, a pair whose piece 0 never arrives
  int cid, kernel;
  unsigned long long epoch;
  unsigned long long timeout_ns;
};

__device__ __forceinline__ unsigned long long* flag(const A2AArgs& a, int member, int c,
                                                    int word) {
  return a.flags[member] + (size_t)c * kFlagWords + word;
}

__device__ __forceinline__ unsigned long long mark(const A2AArgs& a) {
  return (a.epoch << 32) | 1ull;
}

// All threads: wait until this launch's mark is in the flags of member r's
// channel c named by ``what``: every other member's entry word
// (kWaitEntry), or r's arrival words of every source but r (kWaitRecv,
// only < 0) or of the one source ``only``. Thread p watches peer p. False
// when a wait timed out or another block of the launch already failed.
__device__ bool wait_peers(const A2AArgs& a, int r, int c, int step, int what, int only) {
  __shared__ int bad;
  if (threadIdx.x == 0) bad = 0;
  __syncthreads();
  const int p = threadIdx.x;
  const bool mine = only >= 0 ? p == only : (p < a.n && p != r);
  if (mine) {
    const unsigned long long* f = what == kWaitEntry ? flag(a, p, c, kEntry) : flag(a, r, c, p);
    if (!spin_geq(f, mark(a), a.err, a.timeout_ns, {a.kernel, r, step, a.cid, p, c, what}))
      atomicOr(&bad, 1);
  }
  __syncthreads();
  return bad == 0;
}

__device__ __forceinline__ bool entry_barrier(const A2AArgs& a, int r, int c) {
  signal(flag(a, r, c, kEntry), mark(a));
  return wait_peers(a, r, c, -1, kWaitEntry, -1);
}

// All threads: vectors [lo, hi) of ``src`` into ``dst``, kInFlight 16-byte
// loads in flight a thread before the first of their stores.
__device__ __forceinline__ void copy_piece(char* dst, const char* src, long long lo,
                                           long long hi) {
  int4* d = reinterpret_cast<int4*>(dst);
  const int4* s = reinterpret_cast<const int4*>(src);
  for (long long i = lo + threadIdx.x; i < hi; i += kInFlight * kPairThreads) {
    int4 v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (i + u * kPairThreads < hi) v[u] = __ldcg(s + i + u * kPairThreads);
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (i + u * kPairThreads < hi) __stcg(d + i + u * kPairThreads, v[u]);
  }
}

// All threads: the block's stores so far become visible before the flag.
// The block barrier orders every thread's stores before thread 0's
// st.release.gpu, and release is cumulative over them, so no separate
// fence (the pattern of CUTLASS's semaphore release).
__device__ __forceinline__ void announce(unsigned long long* f, unsigned long long v) {
  __syncthreads();
  if (threadIdx.x == 0) st_release(f, v);
}

__global__ void __launch_bounds__(kPairThreads) a2a_kernel(A2AArgs a) {
  const int n = a.n, s = blockIdx.y, x = blockIdx.x, P = a.C;
  if (threadIdx.x == 0) st_release(flag(a, s, x, kEntry), mark(a));  // ready
  const long long vecs = a.slot_bytes / 16;
  for (int j = x; j < n * P; j += gridDim.x) {
    const int off = j / P, p = j - off * P, d = (s + off) % n;
    if (d != s && !wait_peers(a, s, x, off, kWaitEntry, d)) return;  // d is ready
    copy_piece(a.out[d] + (long long)s * a.slot_bytes, a.x[s] + (long long)d * a.slot_bytes,
               vecs * p / P, vecs * (p + 1) / P);
    if (d != s && !(p == 0 && s * n + d == a.drop)) announce(flag(a, d, p, s), mark(a));
  }
  if (x < P) wait_peers(a, s, x, x, kWaitRecv, -1);  // piece x's arrivals
}

__global__ void __launch_bounds__(kThreads) sched_round_kernel(A2AArgs a) {
  const int r = blockIdx.y, c = blockIdx.x;
  const Range rg = channel_range(a, c);
  if (!entry_barrier(a, r, c)) return;
  if (a.local)
    copy16(a.out[r] + (long long)r * a.slot_bytes, a.x[r] + (long long)r * a.slot_bytes, rg);
  const int dst = a.pi[r];
  // a shadow duplicate or a self-loop copies nothing; the arrival word is
  // raised either way (a self-loop raises its own)
  if ((a.send_mask >> r) & 1u)
    copy16(a.out[dst] + (long long)r * a.slot_bytes, a.x[r] + (long long)dst * a.slot_bytes, rg);
  signal(flag(a, dst, c, r), mark(a));
  wait_peers(a, r, c, 0, kWaitRecv, a.inv[r]);
}

// B9's grid for a world of n, chunk slots of ``vecs`` 16-byte vectors, on a
// card that holds ``blocks`` of its blocks at once: P pieces per pair, of
// at least kPieceVecs vectors each (one piece where the slot is smaller),
// and X blocks per member, so that the launch takes at most half the card
// (X n <= blocks / 2, or one block a member on a card too small for that)
// and X, P <= kMaxChannels (a flag channel each). X = n P, one piece of one
// pair a block, unless half the card holds fewer than n blocks a member;
// then P = 1 and a block copies several pairs. Mirrored by pair_grid in
// uccl_tpu_torch/ep/pallas_a2a.py.
struct PairGrid {
  int P, X;
};

PairGrid pair_grid(int n, long long vecs, int blocks) {
  int x_max = blocks / (2 * n);
  if (x_max > kMaxChannels) x_max = kMaxChannels;
  if (x_max < 1) x_max = 1;
  const int p_max = x_max / n > 1 ? x_max / n : 1;
  long long p = vecs / kPieceVecs;
  if (p > p_max) p = p_max;
  if (p < 1) p = 1;
  const int P = (int)p;
  return {P, n * P < x_max ? n * P : x_max};
}

int launch_pairs(A2AArgs& a, int live, void* stream) {
  int blocks = 0;
  const int e = resident_blocks((const void*)a2a_kernel, kPairThreads, &blocks);
  if (e != 0) return e;
  const PairGrid g = pair_grid(a.n, a.slot_bytes / 16, blocks);
  a.C = g.P;
  return coop_launch(a2a_kernel, dim3((unsigned)g.X, (unsigned)live), kPairThreads, a, stream);
}

}  // namespace

extern "C" {

// kernel: 0 = all-to-all (B9), 1 = one scheduled round (B10). Tables hold
// one address per member: ``x`` the send views ([n][slot_bytes]), ``out``
// the receive slots ([n][slot_bytes]), ``flags`` the flag words. For B10,
// ``pi`` is the round's permutation (n destinations), bit r of ``send_mask``
// says member r copies its chunk for pi[r] (never for pi[r] == r), and
// ``local`` that the round copies the diagonal. Two tests of the spin
// bound: ``live`` launches members [0, live) only (live < n: the missing
// members' peers time out), and for B9 ``drop`` >= 0 names a pair s * n + d
// (s != d) whose piece 0 is copied but never announced (d's exit wait
// times out); -1 for none. Returns 0, a cudaError_t, or -1 for arguments
// out of range.
int uccl_a2a_launch(int kernel, int n, int live, long long slot_bytes, const void* const* x,
                    void* const* out, void* const* flags, void* err, const int* pi,
                    unsigned send_mask, int local, int drop, int cid, unsigned long long epoch,
                    unsigned long long timeout_ns, void* stream) {
  if (n < 2 || n > kMaxMembers || live < 1 || live > n || slot_bytes <= 0 || slot_bytes % 16 ||
      (kernel != kA2A && kernel != kRound) || drop < -1 || drop >= n * n ||
      (drop >= 0 && (kernel != kA2A || drop / n == drop % n)))
    return -1;
  A2AArgs a = {};
  for (int r = 0; r < n; ++r) {
    a.x[r] = static_cast<const char*>(x[r]);
    a.out[r] = static_cast<char*>(out[r]);
    a.flags[r] = static_cast<unsigned long long*>(flags[r]);
    a.inv[r] = -1;
  }
  if (kernel == kRound) {
    if (!pi || (send_mask >> n) != 0) return -1;
    for (int r = 0; r < n; ++r) {
      if (pi[r] < 0 || pi[r] >= n || a.inv[pi[r]] >= 0) return -1;  // not a permutation
      if (pi[r] == r && ((send_mask >> r) & 1u)) return -1;  // the diagonal is ``local``'s
      a.pi[r] = pi[r];
      a.inv[pi[r]] = r;
    }
    a.send_mask = send_mask;
    a.local = local != 0;
  }
  a.err = static_cast<int*>(err);
  a.slot_bytes = slot_bytes;
  a.n = n; a.C = 1; a.drop = drop;
  a.cid = cid; a.kernel = kernel; a.epoch = epoch; a.timeout_ns = timeout_ns;
  return kernel == kA2A ? launch_pairs(a, live, stream)
                        : launch(sched_round_kernel, a, live, stream);
}

// B9's grid (pair_grid) for a world of n and chunk slots of ``slot_bytes``
// on a card holding ``blocks`` of its blocks at once, or, for blocks <= 0,
// on the current device: out = {P, X, blocks}. Returns 0, a cudaError_t,
// or -1 for arguments out of range.
int uccl_a2a_grid(int n, long long slot_bytes, int blocks, int* out) {
  if (n < 2 || n > kMaxMembers || slot_bytes <= 0 || slot_bytes % 16) return -1;
  if (blocks <= 0) {
    const int e = resident_blocks((const void*)a2a_kernel, kPairThreads, &blocks);
    if (e != 0) return e;
  }
  const PairGrid g = pair_grid(n, slot_bytes / 16, blocks);
  out[0] = g.P; out[1] = g.X; out[2] = blocks;
  return 0;
}

// Limits the Python side checks against.
int uccl_a2a_max_members() { return kMaxMembers; }
int uccl_a2a_max_channels() { return kMaxChannels; }
int uccl_a2a_flag_words() { return kFlagWords; }

}  // extern "C"
