// Kernel A: the whole PCG loop on a given block-tridiagonal system, batched.
//
// Replaces gato_tpu/kernels/pcg_pallas.py::_pcg_kernel (the pallas_call in
// pcg_fused_batched, loop body pcg_loop).  Plain version and wrapper:
// gato_tpu_torch/kernels/pcg_kernel.py.
//
// Design: one thread block per problem, so the loop needs no grid-wide
// barrier; threads stride over the K*s (knot, row) pairs; the six work
// vectors (lambda, r, p, M r, S p and a Horner temporary) live in dynamic
// shared memory; each dot product is a warp-shuffle sum plus one pass over
// the per-warp partials.  The TPU layout (knots x problems packed on 128
// lanes, MXU segment-matmul reductions, VMEM budgets) has no counterpart.
//
// What bounds it on an H100: every iteration reads S (and Pinv once per
// Horner term) from global memory, 2 * 3*K*s*s floats per iteration, and
// runs 2 + 2*(poly_degree-1) dependent matvecs and two block reductions,
// each ending in __syncthreads().  At IIWA (s=14, K=50) S and Pinv are
// 117,600 B each, 235,200 B together: more than the 232,448 B of shared
// memory a block may use, so they cannot both be kept on chip in this
// shape; they are read from global memory and stay hot in L1/L2 across
// iterations.  A single solve is latency-bound (one SM does all the work);
// a batch of B problems fills the card with B blocks.  Which operator to
// keep in shared memory or registers is left to a later change.
//
// Shapes are runtime values: s <= 32 (the wrapper's MAX_BLOCK) and 6*K*s
// floats of shared memory within the device's per-block opt-in limit; the
// wrapper checks both before launching.
#include <cuda_runtime.h>

#include "pcg_common.cuh"

namespace gato {

__global__ void __launch_bounds__(kMaxThreads)
pcg_batched_kernel(const float* S, const float* P, const float* gamma,
                   const float* lam0, float* lam_out, int* iters_out,
                   int* conv_out, float* eta_out, int K, int s,
                   float exit_tol, int max_iters, int poly_degree) {
  extern __shared__ float smem[];
  __shared__ float red[33];
  const int n = K * s;
  const size_t b = blockIdx.x;
  const size_t op = (size_t)K * 3 * s * s;
  S += b * op;
  P += b * op;
  gamma += b * n;
  lam0 += b * n;

  const PcgVectors v = carve_vectors(smem, n, red);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    v.lam[i] = lam0[i];
    v.r[i] = gamma[i];
  }
  __syncthreads();
  const PcgOutcome res = pcg_block(S, P, K, s, v, exit_tol, max_iters,
                                   poly_degree, false);
  for (int i = threadIdx.x; i < n; i += blockDim.x) lam_out[b * n + i] = v.lam[i];
  if (threadIdx.x == 0) {
    iters_out[b] = res.iters;
    conv_out[b] = res.converged;
    eta_out[b] = res.eta;
  }
}

}  // namespace gato

extern "C" {

// Dynamic shared memory of one pcg_batched_kernel block, in bytes.
long long gato_pcg_smem_bytes(int K, int s) {
  return 6LL * K * s * (long long)sizeof(float);
}

// Launches kernel A on `stream` for B problems.  Returns the CUDA error
// code of the launch (0 on success); nothing is synchronised.
int gato_pcg_batched(const float* S, const float* P, const float* gamma,
                     const float* lam0, float* lam, int* iters, int* conv,
                     float* eta, int B, int K, int s, float exit_tol,
                     int max_iters, int poly_degree, void* stream) {
  const int n = K * s;
  const int threads = gato::threads_for(n);
  const size_t smem = (size_t)gato_pcg_smem_bytes(K, s);
  cudaError_t err = cudaFuncSetAttribute(
      gato::pcg_batched_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gato::pcg_batched_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      S, P, gamma, lam0, lam, iters, conv, eta, K, s, exit_tol, max_iters,
      poly_degree);
  return (int)cudaGetLastError();
}

const char* gato_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
