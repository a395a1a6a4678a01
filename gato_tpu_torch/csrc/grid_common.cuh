// Shared machinery of the cooperative-grid kernels: a round of problems,
// and how a problem's CTAs meet (meet: a grid barrier for a round of one
// problem, flagged partials for several, both summing the CTAs' partials
// in one order), for longk.cu's rows 8/10 and 9 and probes.cu's grid-scope
// row 16, whose plans are kernels/longk.py's pcg_rounds; every kernel with
// a large dynamic shared memory takes opt_in_smem.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "pcg_common.cuh"
#include "smem_limit.cuh"

namespace cg = cooperative_groups;

namespace gato {

// Threads of a cooperative CTA.
constexpr int kGridThreads = 256;

// Sets `kernel`'s dynamic shared-memory limit to at least `bytes` where
// that passes the default 48 KB (smem_limit.cuh: once a kernel and device,
// and again for a larger size, never lowered by another thread).
inline cudaError_t opt_in_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return raise_smem_limit(kernel, bytes, false);
}

// One cooperative launch: problems first .. first + nprob - 1, per CTAs
// each, counter done[index].
struct Round {
  int first, nprob, per, index;
};

// Sum of a problem's per partials, to every thread: lane j of warp 0 adds
// partials j, j + 32, ... in order (loads issued four at a time), then a
// shuffle tree; every CTA of the problem computes the same bits.
__device__ __forceinline__ float sum_parts(const float* part, int per, float* red) {
  if (threadIdx.x < 32) {
    float v = 0.f;
    int j = threadIdx.x;
    for (; j + 96 < per; j += 128) {
      const float a0 = __ldcg(part + j), a1 = __ldcg(part + j + 32);
      const float a2 = __ldcg(part + j + 64), a3 = __ldcg(part + j + 96);
      v += a0;
      v += a1;
      v += a2;
      v += a3;
    }
    for (; j < per; j += 32) v += __ldcg(part + j);
    v = warp_sum(v);
    if (threadIdx.x == 0) red[32] = v;
  }
  __syncthreads();
  const float out = red[32];
  __syncthreads();
  return out;
}

constexpr int kBarrierOnly = -1;

// Where a CTA meets the other CTAs of its problem.  kFlags: `slots` holds
// two 8-byte {partial, tag} words a CTA of the launch and two {sum, tag}
// words a problem (at its first CTA's index, past the CTAs' words), by the
// parity of `seq`, the meeting's number (from 1; the words zeroed before
// the launch); else `parts` two floats a CTA (nu's and eta's partials) for
// a grid barrier.
struct PcgMeet {
  int part, per, base;
  unsigned seq;
  unsigned long long* slots;
  float* parts;
};

__device__ __forceinline__ unsigned long long load_word(const unsigned long long* w) {
  return *reinterpret_cast<const volatile unsigned long long*>(w);
}

// The float of the 8-byte word at w once its tag is `seq`, x its first
// read.  A poll that spins ~2^24 times (seconds) traps, so a fault cannot
// hang the card.
__device__ __forceinline__ float wait_word(const unsigned long long* w, unsigned seq,
                                           unsigned long long x) {
  for (unsigned spins = 0; (unsigned)(x >> 32) != seq; x = load_word(w))
    if (++spins == (1u << 24)) __trap();
  return __uint_as_float((unsigned)x);
}

__device__ __forceinline__ void post_word(unsigned long long* w, float v, unsigned seq) {
  *reinterpret_cast<volatile unsigned long long*>(w) =
      ((unsigned long long)seq << 32) | __float_as_uint(v);
}

// A barrier over the CTAs of this CTA's problem that returns the sum, in CTA
// order, of their thread 0's `v`, to every thread (kind: which partial, 0
// nu or 1 eta, for the grid barrier's slots; kBarrierOnly for a barrier
// whose sum is not used, which with a grid barrier touches no slot: a slot
// written while a slower CTA still reads it would race).  kFlags: thread 0
// fences this CTA's earlier stores (the published rows) and posts {v, seq}
// in one 8-byte store; the problem's first CTA gathers the words (lane j of
// warp 0 adds words j, j + 32, ... in order, then a shuffle tree), fences,
// and posts {sum, seq} in the problem's word, which the other CTAs' thread
// 0 polls; every polling thread fences after its waits: two trips through L2 after the last CTA's store, and the polls
// of all but one CTA on one word.  Else a grid barrier
// (cg::grid_group::sync) and sum_parts.  Both add in the same order, so
// they give the same bits.
template <bool kFlags>
__device__ __forceinline__ float meet(cg::grid_group& grid, PcgMeet& m, float v, int kind,
                                      float* red) {
  if (!kFlags) {
    if (kind == kBarrierOnly) {
      grid.sync();
      return 0.f;
    }
    float* slot = m.parts + kind * gridDim.x + m.base;
    if (threadIdx.x == 0) slot[m.part] = v;
    grid.sync();
    return sum_parts(slot, m.per, red);
  }
  ++m.seq;
  unsigned long long* words = m.slots + (m.seq & 1) * gridDim.x + m.base;
  unsigned long long* sum_word = m.slots + (2 + (m.seq & 1)) * gridDim.x + m.base;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    post_word(words + m.part, v, m.seq);
  }
  if (m.part == 0) {
    if (threadIdx.x < 32) {
      // Four words in flight a lane, added in order j, j + 32, ...
      float acc = 0.f;
      for (int j = threadIdx.x; j < m.per; j += 128) {
        unsigned long long x[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (j + 32 * u < m.per) x[u] = load_word(words + j + 32 * u);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (j + 32 * u < m.per) acc += wait_word(words + j + 32 * u, m.seq, x[u]);
      }
      // Each lane that saw a word orders its CTA's later reads (the
      // neighbours' published rows) after it, whatever cache they go by.
      __threadfence();
      acc = warp_sum(acc);
      if (threadIdx.x == 0) {
        __threadfence();
        post_word(sum_word, acc, m.seq);
        red[32] = acc;
      }
    }
  } else if (threadIdx.x == 0) {
    red[32] = wait_word(sum_word, m.seq, load_word(sum_word));
    __threadfence();
  }
  __syncthreads();
  const float out = red[32];
  __syncthreads();
  return out;
}

// This CTA's meeting place in a round: its problem's slots of `parts`
// (two floats a CTA of the launch for grid barriers, eight for flagged
// partials, zeroed before the launch).
__device__ __forceinline__ PcgMeet round_meet(float* parts, const Round& rd) {
  PcgMeet m;
  m.part = blockIdx.x % rd.per;
  m.per = rd.per;
  m.base = blockIdx.x - m.part;
  m.seq = 0;
  m.slots = reinterpret_cast<unsigned long long*>(parts);
  m.parts = parts;
  return m;
}

}  // namespace gato
