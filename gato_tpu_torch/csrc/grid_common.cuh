// Shared machinery of the cooperative-grid kernels: the grid's size from
// the occupancy query, the split of a launch's problems over its CTAs, and
// the sum of a problem's per-CTA partials after a grid barrier, for
// probes.cu's grid-scope row 16; longk.cu's rows 8/10 and 9 take the Round
// and the thread count (their plans are longk.cu's own); every kernel
// with a large dynamic shared memory takes opt_in_smem.
#pragma once

#include <cuda_runtime.h>

#include "pcg_common.cuh"

namespace gato {

// Threads of a cooperative CTA.
constexpr int kGridThreads = 256;
// Resident cooperative CTAs an SM takes, at most: every CTA arrives at every
// grid barrier, so more CTAs make each barrier dearer.
constexpr int kMaxCtasPerSm = 2;

// Sets `kernel`'s dynamic shared-memory limit to at least `bytes`: once a
// kernel and device (and again for a larger size), not on every launch.
inline cudaError_t opt_in_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static thread_local const void* seen_kernel[16] = {};
  static thread_local int seen_device[16] = {};
  static thread_local size_t seen_bytes[16] = {};
  int slot = 0;
  while (slot < 15 && seen_kernel[slot] != nullptr &&
         (seen_kernel[slot] != kernel || seen_device[slot] != device))
    ++slot;
  if (seen_kernel[slot] == kernel && seen_device[slot] == device &&
      seen_bytes[slot] >= bytes)
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  seen_kernel[slot] = kernel;
  seen_device[slot] = device;
  seen_bytes[slot] = bytes;
  return cudaSuccess;
}

// One cooperative launch: problems first .. first + nprob - 1, per CTAs
// each, counter done[index].
struct Round {
  int first, nprob, per, index;
};

// Problems of a round and CTAs a problem: as many problems as CTAs fit
// (grid_max), and no more CTAs to a problem than it has rows for.
inline Round next_round(int first, int B, long long rows, int grid_max,
                        int index) {
  Round rd;
  rd.first = first;
  rd.index = index;
  rd.nprob = B - first < grid_max ? B - first : grid_max;
  long long per = grid_max / rd.nprob;
  const long long useful = (rows + kGridThreads - 1) / kGridThreads;
  if (per > useful) per = useful;
  rd.per = per < 1 ? 1 : (int)per;
  return rd;
}

// Rows [i0, i1) of a problem of K knots of width s that CTA `part` of its
// `per` owns: a contiguous range of ceil(K / per) knots (empty past K).
struct OwnRows {
  int i0, i1;
};

__device__ __forceinline__ OwnRows own_rows(int K, int s, int per, int part) {
  const int nk = (K + per - 1) / per;
  const int k0 = part * nk < K ? part * nk : K;
  const int k1 = k0 + nk < K ? k0 + nk : K;
  return OwnRows{k0 * s, k1 * s};
}

// Sum of a problem's per-CTA partials, returned to every thread: lane j of
// warp 0 adds partials j, j + 32, ... in order, then a shuffle tree.  Every
// CTA of the problem computes the same bits.  The loads bypass L1: the
// partials were written by other CTAs before the last grid barrier.
__device__ inline float sum_partials(const float* part, int per, float* red) {
  if (threadIdx.x < 32) {
    float v = 0.f;
    for (int j = threadIdx.x; j < per; j += 32) v += __ldcg(part + j);
    v = warp_sum(v);
    if (threadIdx.x == 0) red[32] = v;
  }
  __syncthreads();
  const float out = red[32];
  __syncthreads();
  return out;
}

// Resident CTAs of `kernel` (kGridThreads threads) with `smem` bytes of
// dynamic shared memory: blocks per SM (at most kMaxCtasPerSm) times SMs; 0
// if none fits, a negative CUDA error code if a query fails.
inline int coresident_ctas(const void* kernel, size_t smem) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 0)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kGridThreads, smem);
  if (err != cudaSuccess) return -(int)err;
  if (!coop) return -(int)cudaErrorNotSupported;
  if (per_sm > kMaxCtasPerSm) per_sm = kMaxCtasPerSm;
  return per_sm * sms;
}

}  // namespace gato
