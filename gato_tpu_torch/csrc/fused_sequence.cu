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
// Design: one thread block per stream b.  The TPU runs its grid in order,
// so the T axis there is sequential; blocks of a CUDA grid run in no order,
// so the block walks t = 0..T-1 in a loop of its own (the hopper-kernels
// translation of a sequential grid axis).  Step t runs the body of
// fused_body.cuh, kernel B's body, on the inputs at (t, b), with
// rho = rhos[t] and lambda_0 = lam0[b] at t = 0 and the lambda that step
// t-1 wrote to the global output lam[t-1, b] afterwards.  That lambda is
// visible to the whole block after the barrier that ends step t-1; it is
// not kept in shared memory, where the next step's Gauss-Jordan overwrites
// the PCG vectors.  Each step clears the zero-pivot flag, so a singular
// step freezes only itself and hands its lambda_0 on unchanged, as
// `carry[i] = lam_out` does on the TPU.  The block's scratch slice
// (S, Pinv, Qinv, ...: ~342 KB at IIWA) is reused by every step.
//
// A step computes exactly what kernel B computes for the same inputs, rho
// and lambda_0: the same body, the same thread count (threads_for of the
// vector length) and the same fixed-order block sums, so the farm equals T
// chained kernel-B launches bit for bit.
//
// What bounds it on an H100: per step, what bounds kernel B (the dependent
// chain of one block's PCG loop, operators read from L1/L2); the T steps of
// a stream are dependent, so a block's time is the sum of its steps and the
// launch ends with its slowest stream.  One launch replaces T launches and
// their host round trips.
//
// Occupancy: with one block per SM (launch bounds 1024 threads) ptxas gives
// this kernel 64 registers a thread, so at IIWA (704 threads) one block
// fits an SM and 256 streams run in two waves on 132 SMs; asked for two
// blocks per SM it caps the registers at 32 and spills more, which makes
// one block slower but fits 264 blocks in one wave.  (Kernel B gets 32
// from ptxas unasked.)  The kernel is built both ways and the launcher
// takes two blocks per SM only when the streams outnumber the SMs.
// Register allocation does not change the arithmetic.
#include <cuda_runtime.h>

#include "fused_body.cuh"

namespace gato {

template <int kMinBlocksPerSm>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocksPerSm)
fused_sequence_kernel(const float* Qg, const float* Rg, const float* Ag,
                      const float* Bg, const float* qg, const float* rg,
                      const float* cg, const float* lam0g, const float* rhos,
                      float* scratch, float* lam_out, float* dzx_out,
                      float* dzu_out, int* iters_out, int* conv_out,
                      float* eta_out, int T, int B, int K, int s, int c,
                      float exit_tol, int max_iters, int poly_degree,
                      int precond, int arena_floats,
                      long long scratch_floats) {
  extern __shared__ float smem[];
  __shared__ float red[33];
  __shared__ int bad;
  const size_t b = blockIdx.x;
  const size_t ss = (size_t)s * s, sc = (size_t)s * c, cc2 = (size_t)c * c;
  const size_t n = (size_t)K * s, nu = (size_t)(K - 1) * c;
  float* scr = scratch + b * scratch_floats;
  for (int t = 0; t < T; ++t) {
    const size_t p = (size_t)t * B + b;  // (t, b) in the (T, B) stacks
    const float* lam0 = t == 0 ? lam0g + b * n : lam_out + (p - B) * n;
    fused_body(Qg + p * K * ss, Rg + p * (K - 1) * cc2, Ag + p * (K - 1) * ss,
               Bg + p * (K - 1) * sc, qg + p * n, rg + p * nu, cg + p * n,
               lam0, scr, lam_out + p * n, dzx_out + p * n, dzu_out + p * nu,
               iters_out + p, conv_out + p, eta_out + p, K, s, c, rhos[t],
               exit_tol, max_iters, poly_degree, precond, arena_floats, smem,
               red, &bad);
    // Step t's lam_out, written by every thread, is step t+1's lambda_0.
    __syncthreads();
  }
}

}  // namespace gato

extern "C" {

// Launches the sequence kernel on `stream` for B streams of T steps.
// Inputs are (T, B, ...) stacks, lam0 (B, K, s), rhos (T,) on the device;
// `scratch` holds B * gato_fused_scratch_floats(K, s, c) floats (one slice
// per stream, reused by its steps).  Returns the CUDA error code of the
// launch (0 on success); nothing is synchronised.
int gato_fused_sequence(const float* Q, const float* R, const float* A,
                        const float* Bm, const float* q, const float* r,
                        const float* c, const float* lam0, const float* rhos,
                        float* scratch, float* lam, float* dzx, float* dzu,
                        int* iters, int* conv, float* eta, int T, int B, int K,
                        int s, int cdim, float exit_tol, int max_iters,
                        int poly_degree, int precond, void* stream) {
  const long long arena = gato::fused_arena_floats(K, s, cdim);
  const size_t smem = (size_t)arena * sizeof(float);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const auto kernel = B <= sms ? gato::fused_sequence_kernel<1>
                               : gato::fused_sequence_kernel<2>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = gato::threads_for(gato::vec_len(K, s, cdim));
  kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      Q, R, A, Bm, q, r, c, lam0, rhos, scratch, lam, dzx, dzu, iters, conv,
      eta, T, B, K, s, cdim, exit_tol, max_iters, poly_degree, precond,
      (int)arena, gato::fused_scratch_floats(K, s, cdim));
  return (int)cudaGetLastError();
}

}  // extern "C"
