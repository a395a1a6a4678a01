// Kernel B: the whole KKT solve (condense, preconditioner, PCG, recovery)
// in one launch, batched.
//
// Replaces gato_tpu/kernels/fused_solve.py::_fused_kernel (the pallas_call
// in _call_fused, entry solve_fused_batched), with its helpers
// _condense_cols, _gj_inv_flag, the preconditioner assembly, pcg_loop and
// _recover_cols.  Plain version and wrapper:
// gato_tpu_torch/kernels/fused_solve.py.
//
// Design: one thread block per problem, which runs the per-problem body of
// fused_body.cuh once (its note gives the stages and the memory layout).
//
// What bounds it on an H100: S and Pinv do not fit one block's shared
// memory at IIWA, so they live in a global scratch tensor that the wrapper
// allocates and are read back from L1/L2 in the PCG loop.  The
// condensation is about (K s^3) multiply-adds per stage, done by up to
// 1024 threads of one SM; the PCG loop is bound as kernel A's is, by the
// dependent matvec/reduction chain and the operator reads.
//
// Registers: 40 a thread (__maxnreg__), so that at IIWA two 704-thread
// blocks share an SM and 256 problems run in one wave on 132 SMs.  Left
// alone, ptxas gives this body 32 registers and 1,072 B of spill loads a
// thread since its condensation and recovery moved into condense.cuh (356
// B before); at 40 it spills 564 B.  Register allocation does not change
// the arithmetic.
//
// Shapes are runtime values: s, c <= 32; the wrapper checks the shared
// memory against the device's per-block limit before launching.
#include <cuda_runtime.h>

#include "fused_body.cuh"

namespace gato {

__global__ void __maxnreg__(40)
fused_solve_kernel(const float* Qg, const float* Rg, const float* Ag,
                   const float* Bg, const float* qg, const float* rg,
                   const float* cg, const float* lam0g, float* scratch,
                   float* lam_out, float* dzx_out, float* dzu_out,
                   int* iters_out, int* conv_out, float* eta_out, int K, int s,
                   int c, float rho, float exit_tol, int max_iters,
                   int poly_degree, int precond, int arena_floats,
                   long long scratch_floats) {
  extern __shared__ float smem[];
  __shared__ float red[33];
  __shared__ int bad;
  const size_t b = blockIdx.x;
  const size_t ss = (size_t)s * s, sc = (size_t)s * c, cc2 = (size_t)c * c;
  const size_t n = (size_t)K * s, nu = (size_t)(K - 1) * c;
  fused_body(Qg + b * K * ss, Rg + b * (K - 1) * cc2, Ag + b * (K - 1) * ss,
             Bg + b * (K - 1) * sc, qg + b * n, rg + b * nu, cg + b * n,
             lam0g + b * n, scratch + b * scratch_floats, lam_out + b * n,
             dzx_out + b * n, dzu_out + b * nu, iters_out + b, conv_out + b,
             eta_out + b, K, s, c, rho, exit_tol, max_iters, poly_degree,
             precond, arena_floats, smem, red, &bad);
}

}  // namespace gato

extern "C" {

// Floats of global scratch one problem needs: S, Pinv, Qinv, Rinv, B Rinv
// and a product temporary.
long long gato_fused_scratch_floats(int K, int s, int c) {
  return gato::fused_scratch_floats(K, s, c);
}

// Dynamic shared memory of one fused_solve_kernel block, in bytes.
long long gato_fused_smem_bytes(int K, int s, int c) {
  return gato::fused_arena_floats(K, s, c) * (long long)sizeof(float);
}

// Launches kernel B on `stream` for B problems.  `scratch` holds
// B * gato_fused_scratch_floats(K, s, c) floats.  Returns the CUDA error
// code of the launch (0 on success); nothing is synchronised.
int gato_fused_solve(const float* Q, const float* R, const float* A,
                     const float* Bm, const float* q, const float* r,
                     const float* c, const float* lam0, float* scratch,
                     float* lam, float* dzx, float* dzu, int* iters, int* conv,
                     float* eta, int B, int K, int s, int cdim, float rho,
                     float exit_tol, int max_iters, int poly_degree,
                     int precond, void* stream) {
  const long long arena = gato::fused_arena_floats(K, s, cdim);
  const size_t smem = (size_t)arena * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gato::fused_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = gato::threads_for(gato::vec_len(K, s, cdim));
  gato::fused_solve_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      Q, R, A, Bm, q, r, c, lam0, scratch, lam, dzx, dzu, iters, conv, eta, K,
      s, cdim, rho, exit_tol, max_iters, poly_degree, precond, (int)arena,
      gato_fused_scratch_floats(K, s, cdim));
  return (int)cudaGetLastError();
}

}  // extern "C"
