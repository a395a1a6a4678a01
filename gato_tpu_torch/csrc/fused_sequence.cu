// Row 3: a warm-started MPC farm, T dependent fused solves for each of B
// streams, in one launch.
//
// Replaces the inner `kernel` of gato_tpu/kernels/fused_solve.py::
// _call_fused_sequence (entries solve_fused_sequence_batched and
// solve_fused_sequence): a (T, groups) grid whose step (t, i) runs
// _fused_kernel's body warm-started from step t-1's lambda, kept in VMEM
// scratch, with rho = rhos[t].  Plain version and wrapper:
// gato_tpu_torch/kernels/fused_sequence.py.
//
// Design: one cluster of C CTAs a stream, C from the same cluster_size of
// the stream count that kernel B takes of its batch.  The TPU runs its grid
// in order, so the T axis there is sequential; here the cluster walks
// t = 0..T-1 in a loop of its own, a cluster barrier between steps.  Step t
// runs cluster_body.cuh, kernel B's body, on the inputs at (t, b) with
// rho = rhos[t]; at t > 0 lambda_0 is the lambda step t-1 left in the CTAs'
// shared memory (with its halo rows), which step t-1 also wrote to
// lam[t-1, b].  Each step clears the zero-pivot flag, so a singular step
// freezes only itself and hands its lambda_0 on unchanged, as
// `carry[i] = lam_out` does on the TPU.  A stream's records (shared memory,
// or its global scratch slice) are reused by every step.
//
// A step computes exactly what kernel B computes for the same inputs, rho,
// lambda_0 and C: the same body, thread count and reduction order, so the
// farm equals T chained kernel-B launches bit for bit.
//
// What bounds it on an H100: per step, what bounds kernel B; a stream's T
// steps are dependent, so the launch ends with its slowest stream.  One
// launch replaces T launches and their host round trips.
#include <cuda_runtime.h>

#include "cluster_body.cuh"

namespace gato {

template <int kS, int kC>
__global__ void __launch_bounds__(cl::kMaxThreads, 1)
fused_sequence_kernel(const float* Qg, const float* Rg, const float* Ag,
                      const float* Bg, const float* qg, const float* rg,
                      const float* cg, const float* lam0g, const float* rhos,
                      float* scratch, float* lam_out, float* dzx_out,
                      float* dzu_out, int* iters_out, bool* conv_out,
                      float* eta_out, int T, int B, int K, int s, int c,
                      float exit_tol, int max_iters, int poly_degree,
                      int precond, int C) {
  extern __shared__ float smem[];
  if (C > 1) cooperative_groups::this_cluster().sync();  // all CTAs running
  const long long b = blockIdx.x / C;
  const long long ss = (long long)s * s, sc = (long long)s * c,
                  cc2 = (long long)c * c;
  const long long n = (long long)K * s, nu = (long long)(K - 1) * c;
  float* scr = scratch == nullptr ? nullptr : scratch + b * K * cl::record_floats(s, c);
  for (int t = 0; t < T; ++t) {
    const long long p = (long long)t * B + b;  // (t, b) in the (T, B) stacks
    cl::Problem pb{Qg + p * K * ss,      Rg + p * (K - 1) * cc2,
                   Ag + p * (K - 1) * ss, Bg + p * (K - 1) * sc,
                   qg + p * n,           rg + p * nu,
                   cg + p * n,           t == 0 ? lam0g + b * n : nullptr,
                   lam_out + p * n,      dzx_out + p * n,
                   dzu_out + p * nu,     iters_out + p,
                   conv_out + p,         eta_out + p};
    cl::cluster_body<kS, kC>(pb, smem, scr, K, s, c, C, rhos[t], exit_tol,
                             max_iters, poly_degree, precond);
    // No CTA starts step t+1 (whose Gauss-Jordan reuses the shared memory)
    // while another still recovers step t.
    if (C > 1)
      cooperative_groups::this_cluster().sync();
    else
      __syncthreads();
  }
}

using SequenceKernel = void (*)(const float*, const float*, const float*,
                                const float*, const float*, const float*,
                                const float*, const float*, const float*,
                                float*, float*, float*, float*, int*, bool*,
                                float*, int, int, int, int, int, float, int,
                                int, int, int);
// The kernel for (s, c): compiled-in widths for IIWA and the pendulum.
inline SequenceKernel sequence_kernel_for(int s, int c) {
  if (s == 14 && c == 7) return fused_sequence_kernel<14, 7>;
  if (s == 2 && c == 1) return fused_sequence_kernel<2, 1>;
  return fused_sequence_kernel<0, 0>;
}

}  // namespace gato

extern "C" {

// Clusters of C CTAs of the farm kernel the card holds at once; 0 means
// such a cluster cannot run, a negative value is a negated CUDA error.
int gato_sequence_max_clusters(int K, int s, int c, int C, int ops_in_smem) {
  return gato::cl::max_active_clusters(gato::sequence_kernel_for(s, c), K, s, c, C,
                                       ops_in_smem);
}

// Launches the farm kernel on `stream` for B streams of T steps in
// clusters of C CTAs.  Inputs are (T, B, ...) stacks, lam0 (B, K, s), rhos
// (T,) on the device; `scratch` holds B * gato_fused_scratch_floats(K, s,
// c) floats (one slice a stream) when ops_in_smem is 0, else it is null.
// Returns the CUDA error code of the launch (0 on success); nothing is
// synchronised.
int gato_fused_sequence(const float* Q, const float* R, const float* A,
                        const float* Bm, const float* q, const float* r,
                        const float* c, const float* lam0, const float* rhos,
                        float* scratch, float* lam, float* dzx, float* dzu,
                        int* iters, bool* conv, float* eta, int T, int B, int K,
                        int s, int cdim, float exit_tol, int max_iters,
                        int poly_degree, int precond, int C, int ops_in_smem,
                        void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const auto kernel = gato::sequence_kernel_for(s, cdim);
  cudaError_t err = gato::cl::launch_config(kernel, B, K, s, cdim, C, ops_in_smem,
                                             (cudaStream_t)stream, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, kernel, Q, R, A, Bm, q, r, c, lam0, rhos,
                           ops_in_smem ? nullptr : scratch, lam, dzx, dzu, iters,
                           conv, eta, T, B, K, s, cdim, exit_tol, max_iters,
                           poly_degree, precond, C);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
