// Shared device code of the two Hopper kernels (pcg.cu, fused_solve.cu):
// block-wide sums, the block-tridiagonal matvec and the PCG loop.
//
// One thread block solves one problem.  Threads stride over the K*s
// (knot, row) pairs of the problem's vectors; the vectors live in shared
// memory, the operators S and Pinv (K, 3, s, s) in global memory.  The loop
// is the PCG of gato_tpu/kernels/pcg_pallas.py::pcg_loop and
// gato_tpu/pcg.py::pcg: the same update order, the exit test on
// |r . M r| < exit_tol, the 0-based exit index as the iteration count
// (max_iters when the test never fires), alpha = 0 when p.Sp == 0,
// beta = 0 when eta == 0, and M in Horner form for poly_degree > 1.
//
// Pointers to operators are plain `const float*`, never `__restrict__`: the
// fused kernel writes S and Pinv earlier in the same launch, and a
// read-only-cache load could then see stale data.
#pragma once

#include <cuda_runtime.h>

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

// y = M r, with M = Pinv (poly_degree 1) or its Horner polynomial
// y = P r;  y += P (r - S y)  (poly_degree - 1 times).  Uses tmp.
// Ends synchronised.
__device__ inline void apply_precond(const float* S, const float* P,
                                     const float* r, float* y, float* tmp,
                                     int K, int s, int poly_degree) {
  const int n = K * s;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    y[i] = btd_row(P, r, K, s, i / s, i % s);
  __syncthreads();
  for (int d = 1; d < poly_degree; ++d) {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      tmp[i] = r[i] - btd_row(S, y, K, s, i / s, i % s);
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      y[i] += btd_row(P, tmp, K, s, i / s, i % s);
    __syncthreads();
  }
}

// Shared-memory vectors of one problem, K*s floats each, and the reduction
// scratch.
struct PcgVectors {
  float* lam;
  float* r;
  float* p;
  float* y;
  float* ups;
  float* tmp;
  float* red;
};

struct PcgOutcome {
  int iters;
  int converged;
  float eta;
};

// The PCG loop for one problem.  On entry v.lam holds lambda_0 and v.r holds
// gamma; on exit v.lam holds the solution.  A `frozen` problem (a zero
// pivot clamped during condensation) performs no update, never converges,
// and reports max_iters and eta = 1e30, as pcg_loop's `bad` mask does.
__device__ inline PcgOutcome pcg_block(const float* S, const float* P, int K,
                                       int s, const PcgVectors& v,
                                       float exit_tol, int max_iters,
                                       int poly_degree, bool frozen) {
  const int n = K * s;
  // r = gamma - S lambda_0
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    v.r[i] = v.r[i] - btd_row(S, v.lam, K, s, i / s, i % s);
  __syncthreads();
  apply_precond(S, P, v.r, v.y, v.tmp, K, s, poly_degree);
  float part = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    v.p[i] = v.y[i];
    part = fmaf(v.r[i], v.y[i], part);
  }
  float eta = block_sum(part, v.red);

  PcgOutcome out{max_iters, 0, 0.f};
  if (frozen) {
    out.eta = kFrozenEta;
    return out;
  }
  for (int it = 0; it < max_iters; ++it) {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      v.ups[i] = btd_row(S, v.p, K, s, i / s, i % s);
    __syncthreads();
    part = 0.f;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      part = fmaf(v.p[i], v.ups[i], part);
    const float nu = block_sum(part, v.red);
    const float alpha = nu != 0.f ? eta / nu : 0.f;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      v.lam[i] = fmaf(alpha, v.p[i], v.lam[i]);
      v.r[i] = fmaf(-alpha, v.ups[i], v.r[i]);
    }
    __syncthreads();
    apply_precond(S, P, v.r, v.y, v.tmp, K, s, poly_degree);
    part = 0.f;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      part = fmaf(v.r[i], v.y[i], part);
    const float eta_new = block_sum(part, v.red);
    const float beta = eta != 0.f ? eta_new / eta : 0.f;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      v.p[i] = fmaf(beta, v.p[i], v.y[i]);
    __syncthreads();
    eta = eta_new;
    if (fabsf(eta_new) < exit_tol) {
      out.iters = it;
      out.converged = 1;
      break;
    }
  }
  out.eta = fabsf(eta);
  return out;
}

// Lays the PcgVectors out at the start of `smem`, each `len` floats long.
__device__ __forceinline__ PcgVectors carve_vectors(float* smem, int len,
                                                    float* red) {
  PcgVectors v;
  v.lam = smem;
  v.r = smem + len;
  v.p = smem + 2 * len;
  v.y = smem + 3 * len;
  v.ups = smem + 4 * len;
  v.tmp = smem + 5 * len;
  v.red = red;
  return v;
}

}  // namespace gato
