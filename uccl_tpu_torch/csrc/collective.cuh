// What the collective kernels share: csrc/ring_ccl.cu (B4-B8) and
// csrc/ep_a2a.cu (B9, B10), for Hopper (sm_90a).
//
// Flags. Members synchronize through single-writer 64-bit flag words holding
// (epoch << 32) | count. A writer stores its data, then the flag with
// st.release.gpu (signal); a reader spins with ld.acquire.gpu until the flag
// reaches its target (spin_geq). The host gives every launch on a flag
// region a new epoch, so a flag left by an earlier launch never lets a wait
// through.
//
// Faults. Every spin is bounded by %globaltimer. A wait past the bound
// writes the launch's error word (kernel, member, step, collective id, the
// kernel's own sixth word, channel, which wait) if it is still clear; a wait
// that sees the word set gives up too. So a launch with a missing member
// returns, and the host wrapper raises on the word
// (uccl_tpu_torch/collective/lanes.py).
//
// Residency. A member spins on other members' flags, so every block of a
// launch must be resident at once: launch() is cooperative
// (cudaLaunchCooperativeKernel refuses a grid that cannot be) and takes at
// most half the card's resident blocks, so two launches in flight together
// (a bidirectional pair, or two chunk kernels on collective-id parity twins)
// can both be resident.
//
// Copies (B9, B10) move 16-byte vectors through L2 (ld.global.cg /
// st.global.cg), four in flight a thread.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace uccl {

constexpr int kMaxMembers = 16;
constexpr int kMaxChannels = 64;
constexpr int kThreads = 512;

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

// All threads: the block's stores so far become visible before the flag.
__device__ __forceinline__ void signal(unsigned long long* f, unsigned long long v) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(f, v);
  }
}

// Where a wait stands, for the error word's words 1-7.
struct WaitSite {
  int kernel, member, step, cid, peer, channel, what;
};

// One thread: spin until *f >= target. False when the wait timed out (the
// first timeout of the launch writes ``err``) or another wait of the launch
// already failed.
__device__ __forceinline__ bool spin_geq(const unsigned long long* f, unsigned long long target,
                                         int* err, unsigned long long timeout_ns,
                                         const WaitSite& at) {
  const unsigned long long t0 = globaltimer();
  while (ld_acquire(f) < target) {
    if (*(volatile int*)err != 0) return false;
    if (globaltimer() - t0 > timeout_ns) {
      if (atomicCAS(err, 0, 1) == 0) {
        err[1] = at.kernel; err[2] = at.member; err[3] = at.step; err[4] = at.cid;
        err[5] = at.peer; err[6] = at.channel; err[7] = at.what;
        __threadfence();
      }
      return false;
    }
    __nanosleep(64);
  }
  return true;
}

// A channel's range of 16-byte vectors within a slot of ``a.slot_bytes``.
struct Range { long long lo, hi; };

template <typename Args>
__device__ __forceinline__ Range channel_range(const Args& a, int c) {
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

// Cooperative launch of ``kernel`` on members [0, live): a grid of
// (channels x streams, live) blocks, the channel count ``a.C`` chosen here
// from the slot size and half the card. Returns 0 or a cudaError_t.
template <typename K, typename Args>
int launch(K kernel, Args& a, int live, void* stream, int streams = 1) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  const long long vecs = a.slot_bytes / 16;
  long long c = (long long)per_sm * sms / (2LL * streams * a.n);
  const long long by_size = (vecs + 4LL * kThreads - 1) / (4LL * kThreads);
  if (c > by_size) c = by_size;
  if (c > kMaxChannels) c = kMaxChannels;
  if (c < 1) c = 1;
  a.C = (int)c;
  dim3 grid((unsigned)(a.C * streams), (unsigned)live), block(kThreads);
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)kernel, grid, block, args, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace uccl
