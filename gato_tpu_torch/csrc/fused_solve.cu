// Kernel B: the whole KKT solve (condense, preconditioner, PCG, recovery)
// in one launch, batched.
//
// Replaces gato_tpu/kernels/fused_solve.py::_fused_kernel (the pallas_call
// in _call_fused, entry solve_fused_batched), with its helpers
// _condense_cols, _gj_inv_flag, the preconditioner assembly, pcg_loop and
// _recover_cols.  Plain version and wrapper:
// gato_tpu_torch/kernels/fused_solve.py.
//
// Design: one thread-block cluster of C CTAs a problem, which runs the body
// of cluster_body.cuh once (its note gives the layout, the halos and the
// reductions).  C comes from cluster_size (kernels/fused_solve.py gives the
// rule and its reasons): at B = 1 one IIWA problem spreads over 16 SMs with
// its operators in shared memory; at large B, C = 1 keeps one CTA a
// problem with its records in a global scratch slice.
//
// What bounds it on an H100: latency, not bytes or FLOPs (PERF.md §5-6):
// at B = 1 a PCG iteration of ~3.4 us (two matvecs over a few knots, two
// cluster-wide reductions, each a cluster barrier) and, before it, three
// Gauss-Jordan batches of s pivot steps, two CTA barriers a step; at
// B = 256 the same chain on 512 CTAs of C = 2 in four waves.
//
// Widths: compiled-in bodies for IIWA (14, 7), the pendulum (2, 1) and a
// quadruped's whole-body MPC (36, 12: ANYmal's 36-wide state tangent and 12
// joint torques), the generic <0, 0> body for any other s, c <= 32.  No
// other width launches (kernels/fused_solve.py's fits; gato_fused_compiled
// lists the compiled pairs).  At (36, 12, K = 57) a knot's record is 38.6 KB,
// and at C = 16 four of them sit in shared memory beside the plan.
//
// Registers: __launch_bounds__(384, 1).  ptxas (CUDA 12.8) gives the
// <14, 7> kernel 168 registers and 4 bytes of spill (the farm kernel's
// <14, 7> 168 and 12 bytes); the generic <0, 0> kernel keeps its per-row
// arrays of width <= 32 in a 1,408-byte stack frame; the <36, 12> kernel
// runs the wide bodies of cluster_body.cuh in the same 168 registers, with
// 120 bytes of spill stores and 156 of loads (nvcc 12.9) since its
// Gauss-Jordan holds [M | I] in registers, 81 floats a lane
// (gauss_jordan.cuh; 12 bytes with the shared-memory batch).  (The
// one-CTA kernel's __maxnreg__(40), for two 704-thread CTAs an SM, went
// with it: here C = 1 is the rule's choice only where the records fit
// shared memory, one CTA an SM.)
#include <cuda_runtime.h>

#include "cluster_body.cuh"

namespace gato {

template <int kS, int kC>
__global__ void __launch_bounds__(cl::kMaxThreads, 1)
fused_solve_kernel(const float* Qg, const float* Rg, const float* Ag,
                   const float* Bg, const float* qg, const float* rg,
                   const float* cg, const float* lam0g, float* scratch,
                   float* lam_out, float* dzx_out, float* dzu_out,
                   int* iters_out, bool* conv_out, float* eta_out, int K, int s,
                   int c, float rho, float exit_tol, int max_iters,
                   int poly_degree, int precond, int C) {
  extern __shared__ float smem[];
  if (C > 1) cooperative_groups::this_cluster().sync();  // all CTAs running
  const long long b = blockIdx.x / C;
  const long long ss = (long long)s * s, sc = (long long)s * c,
                  cc2 = (long long)c * c;
  const long long n = (long long)K * s, nu = (long long)(K - 1) * c;
  cl::Problem pb{Qg + b * K * ss,      Rg + b * (K - 1) * cc2,
                 Ag + b * (K - 1) * ss, Bg + b * (K - 1) * sc,
                 qg + b * n,           rg + b * nu,
                 cg + b * n,           lam0g + b * n,
                 lam_out + b * n,      dzx_out + b * n,
                 dzu_out + b * nu,     iters_out + b,
                 conv_out + b,         eta_out + b};
  float* scr = scratch == nullptr ? nullptr : scratch + b * K * cl::record_floats(s, c);
  cl::cluster_body<kS, kC>(pb, smem, scr, K, s, c, C, rho, exit_tol, max_iters,
                           poly_degree, precond);
}


using FusedKernel = void (*)(const float*, const float*, const float*,
                             const float*, const float*, const float*,
                             const float*, const float*, float*, float*,
                             float*, float*, int*, bool*, float*, int, int, int,
                             float, float, int, int, int, int);
// The kernel for (s, c): compiled-in widths for IIWA, the pendulum and the
// quadruped, else the generic body (s, c <= 32).
inline FusedKernel fused_kernel_for(int s, int c) {
  if (s == 14 && c == 7) return fused_solve_kernel<14, 7>;
  if (s == 2 && c == 1) return fused_solve_kernel<2, 1>;
  if (s == 36 && c == 12) return fused_solve_kernel<36, 12>;
  return fused_solve_kernel<0, 0>;
}

}  // namespace gato

extern "C" {

// The plan's mirrors (kernels/fused_solve.py holds the same functions).
long long gato_cluster_smem_bytes(int K, int s, int c, int C, int ops_in_smem) {
  return gato::cl::cluster_smem_floats(K, s, c, C, ops_in_smem) * 4;
}
int gato_cluster_threads(int K, int s, int c, int C) {
  return gato::cl::cluster_threads(K, s, c, C);
}
int gato_cluster_size(int B, int K, int s, int c, int n_sms, long long limit) {
  return gato::cl::cluster_size(B, K, s, c, n_sms, limit);
}
// 1 iff kernel B has a body compiled for (s, c), else 0 (the generic body).
int gato_fused_compiled(int s, int c) {
  const gato::FusedKernel generic = gato::fused_solve_kernel<0, 0>;
  return gato::fused_kernel_for(s, c) != generic;
}
long long gato_fused_scratch_floats(int K, int s, int c) {
  return (long long)K * gato::cl::record_floats(s, c);
}

// Clusters of C CTAs of kernel B at (K, s, c) that the card holds at once
// (cudaOccupancyMaxActiveClusters); 0 means such a cluster cannot run.
// A negative value is a CUDA error code, negated.
int gato_fused_max_clusters(int K, int s, int c, int C, int ops_in_smem) {
  return gato::cl::max_active_clusters(gato::fused_kernel_for(s, c), K, s, c, C,
                                       ops_in_smem);
}

// Launches kernel B on `stream` for B problems in clusters of C CTAs;
// `scratch` holds B * gato_fused_scratch_floats(K, s, c) floats when the
// records do not fit shared memory (ops_in_smem 0), else it is null.
// Returns the CUDA error code of the launch (0 on success); nothing is
// synchronised.
int gato_fused_solve(const float* Q, const float* R, const float* A,
                     const float* Bm, const float* q, const float* r,
                     const float* c, const float* lam0, float* scratch,
                     float* lam, float* dzx, float* dzu, int* iters, bool* conv,
                     float* eta, int B, int K, int s, int cdim, float rho,
                     float exit_tol, int max_iters, int poly_degree,
                     int precond, int C, int ops_in_smem, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const auto kernel = gato::fused_kernel_for(s, cdim);
  cudaError_t err = gato::cl::launch_config(kernel, B, K, s, cdim, C, ops_in_smem,
                                             (cudaStream_t)stream, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, kernel, Q, R, A, Bm, q, r, c, lam0,
                           ops_in_smem ? nullptr : scratch, lam, dzx, dzu, iters,
                           conv, eta, K, s, cdim, rho, exit_tol, max_iters,
                           poly_degree, precond, C);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The stage stamps of the last launch (CTA 0; %globaltimer, ns) into
// out[0..kStamps) (cluster_body.cuh lists the points).  Returns kStamps,
// or 0 in a build without GATO_STAGE_STAMPS.
int gato_fused_stage_stamps(unsigned long long* out) {
#ifdef GATO_STAGE_STAMPS
  return cudaMemcpyFromSymbol(out, gato::cl::stage_stamps,
                              sizeof(gato::cl::stage_stamps)) == cudaSuccess
             ? gato::cl::kStamps
             : -1;
#else
  (void)out;
  return 0;
#endif
}

}  // extern "C"
