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
// Members. As in csrc/ring_ccl.cu, one launch runs every member of the world
// from a table of per-member base addresses: blockIdx.y is the member and
// blockIdx.x splits each chunk slot into channels, each with its own flags,
// so many SMs move each member's bytes. On one card every address lies in
// the same HBM and a "remote copy" is an HBM-to-HBM store; members on
// separate cards need only another table (peer or IPC addresses) and the
// .sys memory scope.
//
// B9 keeps the JAX kernel's schedule: a full-peer entry barrier (dma.py's
// all_barrier: the first copy may target any member), the local chunk
// short-circuits, and the W-1 exchanges run in ceil((W-1)/2) steps on two
// counter-rotating streams (step s: chunk r+s forward, chunk r-s backward;
// for even W the antipodal chunk rides the forward stream alone). Slots are
// write-once per source: the sender addresses the destination's slot by its
// own rank, so no slot is written twice and nothing is ever overwritten.
//
// Synchronization. Each (receiver, source, channel) has one arrival flag
// with exactly one writer, the source, which stores its chunk and then
// (epoch << 32) | 1 with st.release.gpu; the host gives every launch on a
// flag region a new epoch, so a flag left by an earlier launch never lets a
// wait through. A member's part of the launch returns only after all W-1
// arrivals (the TPU kernel's wait_recv). On one card the launch boundary
// alone would order the copies before any consumer; the flags stay because
// members on separate cards need nothing else. The TPU kernel's two-parity
// credit rotation exists because its DMA semaphores rotate between two
// slots per stream; with write-once slots and flags that only grow within an
// epoch nothing is reused inside a launch, so the port needs no credits (the
// finding of B4 in ring_ccl.cu) and the per-step receive waits, which gated
// those credits, all move to the end of the launch.
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
// kernel (the flag primitives, the bounded spin, the vector copy and the
// cooperative launch are that header's, shared with ring_ccl.cu): the
// launch takes at most half the card, so two chunk kernels on
// collective-id parity twins can both be resident, and a wait that times out
// writes the error word (kernel, member, step, collective id, the peer
// awaited, channel, which wait) that the host wrapper raises on.
//
// Bound: HBM bandwidth. Each kernel reads every byte it sends once and
// writes it once; B9's compulsory traffic at the EP dispatch buffer is
// 2 x 167.8 MB (0.100 ms at 3.35 TB/s), and so is a whole B10 schedule's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "collective.cuh"

namespace {

using namespace uccl;

constexpr int kEntry = kMaxMembers;          // flag word of the entry barrier
constexpr int kFlagWords = kMaxMembers + 1;  // one arrival word per source, then entry

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
  int n, C;                                // world, channels
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

// Member r sends its chunk ``dst`` into member dst's slot r, then raises
// its arrival word there.
__device__ __forceinline__ void send(const A2AArgs& a, int r, int c, int dst, Range rg) {
  copy16(a.out[dst] + (long long)r * a.slot_bytes, a.x[r] + (long long)dst * a.slot_bytes, rg);
  signal(flag(a, dst, c, r), mark(a));
}

__global__ void __launch_bounds__(kThreads) a2a_kernel(A2AArgs a) {
  const int n = a.n, r = blockIdx.y, c = blockIdx.x;
  const Range rg = channel_range(a, c);
  if (!entry_barrier(a, r, c)) return;
  // the local chunk short-circuits: no flag
  copy16(a.out[r] + (long long)r * a.slot_bytes, a.x[r] + (long long)r * a.slot_bytes, rg);
  const int s_fwd = n / 2, s_bwd = (n - 1) / 2;  // ceil((n-1)/2) and floor
  for (int s = 1; s <= s_fwd; ++s) {
    send(a, r, c, (r + s) % n, rg);                 // forward stream
    if (s <= s_bwd) send(a, r, c, (r - s + n) % n, rg);  // backward stream
  }
  wait_peers(a, r, c, s_fwd, kWaitRecv, -1);  // all W-1 arrivals
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

}  // namespace

extern "C" {

// kernel: 0 = all-to-all (B9), 1 = one scheduled round (B10). Tables hold
// one address per member: ``x`` the send views ([n][slot_bytes]), ``out``
// the receive slots ([n][slot_bytes]), ``flags`` the flag words. For B10,
// ``pi`` is the round's permutation (n destinations), bit r of ``send_mask``
// says member r copies its chunk for pi[r] (never for pi[r] == r), and
// ``local`` that the round copies the diagonal. ``live`` launches members
// [0, live) only (live < n is a test of the spin bound: the missing
// members' peers time out). Returns 0, a cudaError_t, or -1 for arguments
// out of range.
int uccl_a2a_launch(int kernel, int n, int live, long long slot_bytes, const void* const* x,
                    void* const* out, void* const* flags, void* err, const int* pi,
                    unsigned send_mask, int local, int cid, unsigned long long epoch,
                    unsigned long long timeout_ns, void* stream) {
  if (n < 2 || n > kMaxMembers || live < 1 || live > n || slot_bytes <= 0 || slot_bytes % 16 ||
      (kernel != kA2A && kernel != kRound))
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
  a.n = n; a.C = 1;
  a.cid = cid; a.kernel = kernel; a.epoch = epoch; a.timeout_ns = timeout_ns;
  return kernel == kA2A ? launch(a2a_kernel, a, live, stream)
                        : launch(sched_round_kernel, a, live, stream);
}

// Limits the Python side checks against.
int uccl_a2a_max_members() { return kMaxMembers; }
int uccl_a2a_max_channels() { return kMaxChannels; }
int uccl_a2a_flag_words() { return kFlagWords; }

}  // extern "C"
