// Shared device code of one-block kernels: block-wide sums, the
// block-tridiagonal matvec btd_row, with kFrozenEta, and a warp's cp.async
// copy (rows 5, 6, 12 and the unpeel); they serve the exact kernels
// (condense.cuh's users), the long-K tier (longk.cu, longk_direct.cu,
// grid_common.cuh) and the probes (probes.cu).  Kernel A (pcg.cu) runs
// kernel B's cluster PCG stage (cluster_body.cuh) instead.
//
// Pointers to operators are plain `const float*`, never `__restrict__`: a
// kernel may write S earlier in the same launch, and a read-only-cache
// load could then see stale data.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gato {

constexpr int kMaxThreads = 1024;
constexpr float kFrozenEta = 1e30f;

// Threads per block for n vector elements: a whole number of warps, at
// least two, at most 1024.
inline int threads_for(int n) {
  int t = ((n + 31) / 32) * 32;
  if (t < 64) t = 64;
  if (t > kMaxThreads) t = kMaxThreads;
  return t;
}

// n floats from global src into the warp's shared dst with cp.async: 16
// bytes a copy where both ends are 16-byte aligned and n a multiple of 4,
// else 4.  The caller commits and waits.
__device__ __forceinline__ void warp_async_copy(float* dst, const float* src, int n) {
  const int lane = threadIdx.x & 31;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0 &&
      (n & 3) == 0) {
    for (int i = lane; i < n / 4; i += 32) __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
  } else {
    for (int i = lane; i < n; i += 32) __pipeline_memcpy_async(dst + i, src + i, 4);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum of `v` over the block, returned to every thread.  `red` holds at
// least 33 floats of shared memory.  blockDim.x is a multiple of 32.  The
// order of the sum is fixed, so a run is deterministic.
__device__ inline float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nwarps ? red[lane] : 0.f;
    w = warp_sum(w);
    if (lane == 0) red[32] = w;
  }
  __syncthreads();
  const float out = red[32];
  __syncthreads();
  return out;
}

// Row (k, a) of M x for a block-tridiagonal M (K, 3, s, s):
// L_k x_{k-1} + D_k x_k + U_k x_{k+1}, with no neighbour past either end.
__device__ __forceinline__ float btd_row(const float* M, const float* x,
                                         int K, int s, int k, int a) {
  const float* row = M + ((size_t)k * 3 * s + a) * s;  // M[k][0][a][:]
  const size_t slot = (size_t)s * s;
  float left = 0.f, mid = 0.f, right = 0.f;
  if (k > 0) {
    const float* xm = x + (k - 1) * s;
    for (int b = 0; b < s; ++b) left = fmaf(row[b], xm[b], left);
  }
  {
    const float* rm = row + slot;
    const float* xk = x + k * s;
    for (int b = 0; b < s; ++b) mid = fmaf(rm[b], xk[b], mid);
  }
  if (k < K - 1) {
    const float* rp = row + 2 * slot;
    const float* xp = x + (k + 1) * s;
    for (int b = 0; b < s; ++b) right = fmaf(rp[b], xp[b], right);
  }
  return (left + right) + mid;
}

}  // namespace gato
