// Kernel A: the whole PCG loop on given block-tridiagonal systems, batched.
//
// Replaces gato_tpu/kernels/pcg_pallas.py::_pcg_kernel (the pallas_call in
// pcg_fused_batched, loop body pcg_loop).  Plain version and wrapper:
// gato_tpu_torch/kernels/pcg_kernel.py.
//
// Design: one thread-block cluster of C CTAs a problem, which runs kernel
// B's PCG stage (cluster_body.cuh's pcg_setup and pcg_loop: halo rows
// pushed through distributed shared memory, two cluster barriers an
// iteration at poly degree 1, each dot product summed over the CTAs in rank
// order, so every CTA takes the same exit).  CTA r owns the knots
// [r K / C, (r+1) K / C) and copies their S_k and Pinv_k (each knot's three
// blocks one contiguous 3 s^2 run in both tensors) into a record of 6 s^2
// floats in its shared memory once, with cp.async, before the loop.  Where
// the records do not fit beside the vectors (pcg_smem_floats), the loop
// reads the global tensors instead: one pointer choice for the launch
// (`ops_in_smem`), one code.  C comes from kernels/pcg_kernel.py's
// cluster_size: kernel B's rule (fused_solve.py) with this kernel's record.
// s is compiled in for IIWA (14) and the pendulum (2); <0> reads it at run
// time (s <= 32).
//
// What bounds it on an H100: latency.  At IIWA K = 50, B = 1 the one-CTA
// kernel ran ~26 iterations of ~9 us on one SM, S and Pinv (235,200 B
// together, more than a CTA's 232,448 B) streamed from L2 each iteration;
// here 16 CTAs hold ~4 knots each (18.8 KB of operators), and an iteration
// is two short matvecs and two cluster barriers (kernel B's ~3.5 us).  A
// wide batch takes the rule's floor (C = 2 at IIWA: records in shared
// memory), B C CTAs in waves of the card's SMs.
//
// With GATO_STAGE_STAMPS defined (gato_tpu_torch/tools/direct_stamps.py
// builds that way; the default build does not), block 0 stamps
// %globaltimer at its start, after the operator copy, after the PCG set-up,
// after the loop and at its end.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_body.cuh"

namespace gato {

constexpr int kPcgStamps = 8;
#ifdef GATO_STAGE_STAMPS
static __device__ unsigned long long pcg_stamps[kPcgStamps];
static __device__ int pcg_stamp_count;
__global__ void pcg_stamp_reset() { pcg_stamp_count = 0; }
__device__ __forceinline__ void pcg_stamp() {
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0 && pcg_stamp_count < kPcgStamps) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    pcg_stamps[pcg_stamp_count++] = t;
  }
}
#else
__device__ __forceinline__ void pcg_stamp() {}
#endif

// ---- The plan (host and device; mirrored in kernels/pcg_kernel.py) ----

// One knot's record: S_k and Pinv_k, three blocks each.
inline __host__ __device__ long long pcg_record_floats(int s) { return 6LL * s * s; }

// Threads a CTA: one a row of its knots, a whole number of warps, from 64
// to 384.
inline __host__ __device__ int pcg_threads(int K, int s, int C) {
  const int t = (cl::cluster_knots(K, C) * s + 31) / 32 * 32;
  return t < 64 ? 64 : (t > cl::kMaxThreads ? cl::kMaxThreads : t);
}

// Dynamic shared memory of one CTA, in floats: the fixed area, the records
// (ops_in_smem), lambda's rows, the halo rows of the eight vectors and the
// seven other vectors.
inline __host__ __device__ long long pcg_smem_floats(int K, int s, int C,
                                                     int ops_in_smem) {
  const long long kn = cl::cluster_knots(K, C);
  return cl::kFixedFloats + (ops_in_smem ? kn * pcg_record_floats(s) : 0) + kn * s +
         2LL * cl::kNumVec * s + 7 * kn * s;
}

template <int kS>
__global__ void __launch_bounds__(cl::kMaxThreads, 1)
pcg_cluster_kernel(const float* S, const float* P, const float* gamma,
                   const float* lam0, float* lam_out, int* iters_out,
                   int* conv_out, float* eta_out, int K, int s_rt,
                   float exit_tol, int max_iters, int poly, int C,
                   int ops_in_smem) {
  extern __shared__ __align__(16) float smem[];
  if (C > 1) cooperative_groups::this_cluster().sync();  // all CTAs running
  pcg_stamp();
  const int s = kS > 0 ? kS : s_rt;
  const long long b = blockIdx.x / C;
  const long long n = (long long)K * s;
  const int run = 3 * s * s;  // floats of one knot's three blocks
  cl::Ctx x = cl::make_ctx_layout(smem, nullptr, K, s, 0, C,
                                  ops_in_smem ? 2 * run : 0, 0);
  const int k0 = x.k0, rows = x.kn * s;
  const float* Sg = S + (b * K + k0) * run;
  const float* Pg = P + (b * K + k0) * run;
  cl::Blocks Sm{Sg, run}, Pm{Pg, run};
  if (ops_in_smem) {
    // Own knots' S_k and Pinv_k into the records, in 16-byte pieces where
    // the runs and both tensors allow it.
    const bool wide = (run & 3) == 0 && ((uintptr_t)S & 15) == 0 && ((uintptr_t)P & 15) == 0;
    const int w = wide ? 4 : 1, q = run / w, total = x.kn * 2 * q;
    for (int i = x.tid; i < total; i += x.nt) {
      const int kl = i / (2 * q), rem = i - kl * 2 * q, which = rem / q, j = rem - which * q;
      const float* src = (which ? Pg : Sg) + (long long)kl * run + j * w;
      float* dst = x.rec + (long long)kl * 2 * run + which * run + j * w;
      if (wide)
        __pipeline_memcpy_async(dst, src, 16);
      else
        __pipeline_memcpy_async(dst, src, 4);
    }
    __pipeline_commit();
    Sm = cl::Blocks{x.rec, 2 * run};
    Pm = cl::Blocks{x.rec + run, 2 * run};
  }
  // gamma into r, lambda_0 with its halo rows.
  const float* g = gamma + b * n + (long long)k0 * s;
  const float* l0 = lam0 + b * n;
  for (int t = x.tid; t < rows; t += x.nt) {
    cl::vec(x, cl::kR0)[t] = g[t];
    x.lam[t] = l0[(long long)k0 * s + t];
  }
  for (int t = x.tid; t < s; t += x.nt) {
    if (k0 > 0) cl::hleft(x, cl::kLam)[t] = l0[(long long)(k0 - 1) * s + t];
    if (x.k1 < K) cl::hright(x, cl::kLam)[t] = l0[(long long)x.k1 * s + t];
  }
  if (ops_in_smem) __pipeline_wait_prior(0);
  __syncthreads();
  pcg_stamp();

  float eta = cl::pcg_setup<kS>(x, Sm, Pm, poly, nullptr);
  pcg_stamp();
  int iters, conv;
  eta = cl::pcg_loop<kS>(x, Sm, Pm, eta, exit_tol, max_iters, poly, &iters, &conv);
  pcg_stamp();
  for (int t = x.tid; t < rows; t += x.nt) lam_out[b * n + (long long)k0 * s + t] = x.lam[t];
  if (x.tid == 0 && x.rank == 0) {
    iters_out[b] = iters;
    conv_out[b] = conv;
    eta_out[b] = eta;
  }
  pcg_stamp();
}

using PcgKernel = void (*)(const float*, const float*, const float*, const float*,
                           float*, int*, int*, float*, int, int, float, int, int, int,
                           int);
// The kernel for s: compiled-in widths for IIWA and the pendulum.
inline PcgKernel pcg_kernel_for(int s) {
  if (s == 14) return pcg_cluster_kernel<14>;
  if (s == 2) return pcg_cluster_kernel<2>;
  return pcg_cluster_kernel<0>;
}

}  // namespace gato

extern "C" {

// The shared memory of the one-CTA-a-problem kernel A (six K s vectors),
// in bytes: it no longer sizes a launch; kernels/longk.py's routing to the
// long-K tier reads its Python copy (pcg_kernel.smem_bytes).
long long gato_pcg_smem_bytes(int K, int s) {
  return 6LL * K * s * (long long)sizeof(float);
}

// The plan's mirrors (kernels/pcg_kernel.py holds the same functions).
long long gato_pcg_cluster_smem_bytes(int K, int s, int C, int ops_in_smem) {
  return gato::pcg_smem_floats(K, s, C, ops_in_smem) * 4;
}
int gato_pcg_cluster_threads(int K, int s, int C) { return gato::pcg_threads(K, s, C); }

// Clusters of C CTAs of kernel A at (K, s) that the card holds at once
// (cudaOccupancyMaxActiveClusters); 0 means such a cluster cannot run.  A
// negative value is a CUDA error code, negated.
int gato_pcg_max_clusters(int K, int s, int C, int ops_in_smem) {
  return gato::cl::max_active_clusters_sized(
      gato::pcg_kernel_for(s), C, gato::pcg_threads(K, s, C),
      (size_t)gato::pcg_smem_floats(K, s, C, ops_in_smem) * 4);
}

// Launches kernel A on `stream` for B problems in clusters of C CTAs, the
// operators in shared memory when ops_in_smem.  Returns the CUDA error code
// of the launch (0 on success); nothing is synchronised.
int gato_pcg_batched(const float* S, const float* P, const float* gamma,
                     const float* lam0, float* lam, int* iters, int* conv,
                     float* eta, int B, int K, int s, float exit_tol,
                     int max_iters, int poly_degree, int C, int ops_in_smem,
                     void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const auto kernel = gato::pcg_kernel_for(s);
  cudaError_t err = gato::cl::launch_config_sized(
      kernel, B, C, gato::pcg_threads(K, s, C),
      (size_t)gato::pcg_smem_floats(K, s, C, ops_in_smem) * 4, (cudaStream_t)stream,
      &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
#ifdef GATO_STAGE_STAMPS
  gato::pcg_stamp_reset<<<1, 1, 0, (cudaStream_t)stream>>>();
#endif
  err = cudaLaunchKernelEx(&cfg, kernel, S, P, gamma, lam0, lam, iters, conv, eta, K,
                           s, exit_tol, max_iters, poly_degree, C, ops_in_smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The stamps of the last launch (block 0; %globaltimer, ns) into
// out[0..kPcgStamps); returns their count, 0 in a build without
// GATO_STAGE_STAMPS.
int gato_pcg_stamps(unsigned long long* out) {
#ifdef GATO_STAGE_STAMPS
  int n = 0;
  if (cudaMemcpyFromSymbol(&n, gato::pcg_stamp_count, sizeof(int)) != cudaSuccess ||
      cudaMemcpyFromSymbol(out, gato::pcg_stamps, sizeof(gato::pcg_stamps)) != cudaSuccess)
    return 0;
  return n;
#else
  (void)out;
  return 0;
#endif
}

const char* gato_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
