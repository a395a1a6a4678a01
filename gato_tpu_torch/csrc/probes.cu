// Rows 16, 17 and 18: the three measurement probes, latency floors of the
// primitives the solver's kernels are built from.  Wrappers and plain
// versions: gato_tpu_torch/kernels/probes.py; the tools that time them:
// gato_tpu_torch/tools/probe_dispatch.py, probe_iter_floor.py and
// probe_throughput.py.
//
// Row 18, null_copy (replaces bench.py's null_kernel, pallas_call at :899,
// the dispatch-floor probe): out = q * 1.0000001 on the rhs of B problems
// (B K s floats).  Its bound (2 B K s 4 bytes over 3.35 TB/s) is
// nanoseconds: what bounds it on an H100 is the launch and one round trip
// to memory, and the probe exists to show that floor, so the kernel must
// add nothing to it.  One float4 a thread (16-byte loads and stores, at
// IIWA K s = 700 175 float4 in one round trip of one CTA, not a
// grid-stride walk of 4-byte loads), over a grid of 256-thread CTAs that
// covers B K s / 4 float4; threads 0-2 also take the 1-3 floats past the
// last whole float4.  Where q or out does not start on a 16-byte boundary
// (a view of q one float in), every thread takes one float instead.  The
// product is a rounded float32 multiply (__fmul_rn, no contraction), bit
// for bit q * 1.0000001.
//
// Row 16, null_chain (replaces tools/probe_iter_floor.py's null kernel,
// pallas_call at :105): the dependent op chain of one PCG iteration without
// the algorithm.  One trip, on y (K, s) of each problem:
//   n_mv times   y <- 0.25 (0.01 M) y + 0.5 y, M (K, 3, s, s) the port's
//                block-tridiagonal operator (btd_row: zeros past either
//                end, where the TPU kernel rolled its lanes cyclically);
//   n_dot times  sc = sum y^2 (a whole-vector reduction, its scalar
//                broadcast), y <- y + a (0.125 y), a = 1 / (1 + sc) (0 if
//                sc = 0): the nu -> alpha -> axpy chain;
//   three freeze selects on live = (y[0] > -1e30), as the loop's masked
//                freeze (the TPU kernel tested its first row's lane sum;
//                both are true for every finite y).
// n_mv, n_dot and the trip count are runtime arguments, so nvcc cannot fold
// the loop; the scaled operator 0.01 M is written once, by the thread that
// reads it, as the TPU kernel scaled its tiles once.  Two scopes:
//   block scope: one CTA a problem, y double-buffered in shared memory, the
//     reductions through pcg_common.cuh's block_sum: the barriers of kernels
//     A and B (a __syncthreads after each matvec, dot update and freeze);
//   grid scope: one cooperative grid, y double-buffered in global memory,
//     each reduction a CTA partial, a grid barrier and the sum of the
//     partials, a grid barrier after each matvec, dot update and freeze.
//     The grid's size (the occupancy query, at most 2 CTAs an SM), the
//     split of a problem's knots over `per` CTAs and the sum of the
//     partials are grid_common.cuh's: the schedule rows 8/10 ran before
//     their two-meeting design (longk.cu), a grid barrier after every
//     phase, which this scope measures.
// What bounds it: the chain of barriers, not bytes or operations (a trip at
// IIWA K = 50 is ~0.13 MFLOP, 2 ns at 67 TFLOP/s).
//
// Row 17, fma_chain (replaces tools/probe_throughput.py's probe D kernel,
// pallas_call at :222): trips x depth dependent matvecs on y (K, s) of each
// problem at kernel B's layout, s = 14 (IIWA's state size, the TPU probe's
// fixed width), one CTA a problem, y double-buffered in shared memory, one
// thread an output row (k, a) holding its row of 0.01 M (K, s, s) in
// registers: acc = sum_b (0.01 M)[k, a, b] y[k, b] (s dependent FMAs),
// y <- 0.25 acc + 0.5 y, a __syncthreads between matvecs.
// The block-diagonal matvec is the TPU kernel's (s column-FMAs on a tile of
// knots in lanes).  Bound: the dependent FMA latency of one thread.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_common.cuh"
#include "pcg_common.cuh"

namespace cg = cooperative_groups;

namespace gato {

constexpr int kCopyThreads = 256;
constexpr float kCopyFactor = 1.0000001f;
// Row 17's width: its row of 0.01 M lives in registers.
constexpr int kFmaWidth = 14;

// n floats; vec: q and out both 16-byte aligned.
__global__ void __launch_bounds__(kCopyThreads)
null_copy_kernel(const float* __restrict__ q, float* __restrict__ out,
                 long long n, int vec) {
  const long long i = (long long)blockIdx.x * kCopyThreads + threadIdx.x;
  if (!vec) {
    if (i < n) out[i] = __fmul_rn(__ldg(q + i), kCopyFactor);
    return;
  }
  const long long n4 = n >> 2;
  if (i < n4) {
    float4 v = __ldg(reinterpret_cast<const float4*>(q) + i);
    v.x = __fmul_rn(v.x, kCopyFactor);
    v.y = __fmul_rn(v.y, kCopyFactor);
    v.z = __fmul_rn(v.z, kCopyFactor);
    v.w = __fmul_rn(v.w, kCopyFactor);
    reinterpret_cast<float4*>(out)[i] = v;
  }
  if (i < (n & 3)) out[4 * n4 + i] = __fmul_rn(__ldg(q + 4 * n4 + i), kCopyFactor);
}

// What the chain kernels read and write.  M (B, K, 3, s, s), y0 and out
// (B, K s); Mc the scaled operator (as M); buf (B, 2, K s) the grid scope's
// vectors; parts one float a CTA (grid scope).
struct ChainArgs {
  const float* M;
  const float* y0;
  float* Mc;
  float* out;
  float* buf;
  float* parts;
  int K, s, n_mv, n_dot, trips;
};

// Mc = 0.01 M on rows [i0, i1) of one problem, strided by (tid, nt): the
// three (s,)-rows of knot k, row a that btd_row reads for element (k, a).
__device__ inline void scale_rows(const float* M, float* Mc, int s, int i0,
                                  int i1) {
  for (int i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
    const int k = i / s, a = i - (i / s) * s;
    for (int slot = 0; slot < 3; ++slot) {
      const size_t row = (((size_t)k * 3 + slot) * s + a) * s;
      for (int b = 0; b < s; ++b) Mc[row + b] = M[row + b] * 0.01f;
    }
  }
}

__device__ __forceinline__ float freeze(float v, bool live) {
  v = live ? v : v * 0.5f;
  v = live ? v : v + 1.f;
  return live ? v : v * 0.25f;
}

__global__ void __launch_bounds__(kMaxThreads)
null_chain_block_kernel(ChainArgs a) {
  extern __shared__ float smem[];
  __shared__ float red[33];
  const int K = a.K, s = a.s, n = K * s, tid = threadIdx.x, nt = blockDim.x;
  const size_t b = blockIdx.x;
  const float* M = a.M + b * n * 3 * s;
  float* Mc = a.Mc + b * n * 3 * s;
  scale_rows(M, Mc, s, 0, n);
  float* y = smem;
  float* z = smem + n;
  for (int i = tid; i < n; i += nt) y[i] = a.y0[b * n + i];
  __syncthreads();
  for (int t = 0; t < a.trips; ++t) {
    for (int m = 0; m < a.n_mv; ++m) {
      for (int i = tid; i < n; i += nt)
        z[i] = fmaf(0.25f, btd_row(Mc, y, K, s, i / s, i % s), 0.5f * y[i]);
      __syncthreads();
      float* w = y;
      y = z;
      z = w;
    }
    for (int d = 0; d < a.n_dot; ++d) {
      float part = 0.f;
      for (int i = tid; i < n; i += nt) part = fmaf(y[i], y[i], part);
      const float sc = block_sum(part, red);
      const float g = sc != 0.f ? 1.f / (1.f + sc) : 0.f;
      for (int i = tid; i < n; i += nt) y[i] = fmaf(g, y[i] * 0.125f, y[i]);
      __syncthreads();
    }
    const bool live = y[0] > -1e30f;
    for (int i = tid; i < n; i += nt) z[i] = freeze(y[i], live);
    __syncthreads();
    float* w = y;
    y = z;
    z = w;
  }
  for (int i = tid; i < n; i += nt) a.out[b * n + i] = y[i];
}

__global__ void __launch_bounds__(kGridThreads)
null_chain_grid_kernel(ChainArgs a, int per) {
  __shared__ float red[33];
  cg::grid_group grid = cg::this_grid();
  const int K = a.K, s = a.s, n = K * s, tid = threadIdx.x, nt = blockDim.x;
  const size_t b = blockIdx.x / per;
  const int part = blockIdx.x % per;
  const OwnRows own = own_rows(K, s, per, part);
  const int i0 = own.i0, i1 = own.i1;
  const float* M = a.M + b * n * 3 * s;
  float* Mc = a.Mc + b * n * 3 * s;
  float* parts = a.parts + b * per;
  scale_rows(M, Mc, s, i0, i1);
  float* y = a.buf + b * 2 * n;
  float* z = y + n;
  for (int i = i0 + tid; i < i1; i += nt) y[i] = a.y0[b * n + i];
  grid.sync();
  for (int t = 0; t < a.trips; ++t) {
    for (int m = 0; m < a.n_mv; ++m) {
      for (int i = i0 + tid; i < i1; i += nt)
        z[i] = fmaf(0.25f, btd_row(Mc, y, K, s, i / s, i % s), 0.5f * y[i]);
      grid.sync();
      float* w = y;
      y = z;
      z = w;
    }
    for (int d = 0; d < a.n_dot; ++d) {
      float acc = 0.f;
      for (int i = i0 + tid; i < i1; i += nt) acc = fmaf(y[i], y[i], acc);
      const float v = block_sum(acc, red);
      if (tid == 0) parts[part] = v;
      grid.sync();
      const float sc = sum_partials(parts, per, red);
      const float g = sc != 0.f ? 1.f / (1.f + sc) : 0.f;
      for (int i = i0 + tid; i < i1; i += nt) y[i] = fmaf(g, y[i] * 0.125f, y[i]);
      grid.sync();
    }
    const bool live = __ldcg(y) > -1e30f;
    for (int i = i0 + tid; i < i1; i += nt) z[i] = freeze(y[i], live);
    grid.sync();
    float* w = y;
    y = z;
    z = w;
  }
  for (int i = i0 + tid; i < i1; i += nt) a.out[b * n + i] = y[i];
}

__global__ void __launch_bounds__(kMaxThreads)
fma_chain_kernel(const float* __restrict__ M, const float* __restrict__ y0,
                 float* __restrict__ out, int K, int depth, int trips) {
  constexpr int S = kFmaWidth;
  extern __shared__ float smem[];
  const int n = K * S, i = threadIdx.x;
  const bool own = i < n;
  const int k = own ? i / S : 0, a = own ? i % S : 0;
  const size_t b = blockIdx.x;
  float m[S];
#pragma unroll
  for (int c = 0; c < S; ++c)
    m[c] = own ? M[((b * K + k) * S + a) * S + c] * 0.01f : 0.f;
  float* y = smem;
  float* z = smem + n;
  if (own) y[i] = y0[b * n + i];
  __syncthreads();
  for (int t = 0; t < trips; ++t) {
    for (int d = 0; d < depth; ++d) {
      if (own) {
        const float* yk = y + k * S;
        float acc = m[0] * yk[0];
#pragma unroll
        for (int c = 1; c < S; ++c) acc = fmaf(m[c], yk[c], acc);
        z[i] = fmaf(0.25f, acc, 0.5f * y[i]);
      }
      __syncthreads();
      float* w = y;
      y = z;
      z = w;
    }
  }
  if (own) out[b * n + i] = y[i];
}

}  // namespace gato

extern "C" {

// Launches row 18 on `stream`: out = q * 1.0000001 on B problems of n
// floats each.  Returns the CUDA error code (0 on success); nothing is
// synchronised.
int gato_null_copy(const float* q, float* out, int B, int n, void* stream) {
  const long long total = (long long)B * n;
  if (total <= 0) return 0;
  const int vec = (((uintptr_t)q | (uintptr_t)out) & 15u) == 0;
  const long long n4 = total >> 2;
  const long long threads = vec ? (n4 > (total & 3) ? n4 : (total & 3)) : total;
  const long long grid = (threads + gato::kCopyThreads - 1) / gato::kCopyThreads;
  gato::null_copy_kernel<<<(unsigned)grid, gato::kCopyThreads, 0,
                           (cudaStream_t)stream>>>(q, out, total, vec);
  return (int)cudaGetLastError();
}

// Resident CTAs of the grid-scope chain kernel on the current device
// (grid_common.cuh's occupancy query); 0 if none fits, a
// negative CUDA error code if a query fails.
int gato_null_chain_grid_ctas(void) {
  return gato::coresident_ctas((const void*)gato::null_chain_grid_kernel, 0);
}

// CTAs a problem of n = K s floats gets at grid scope: grid_common.cuh's
// next_round split of the resident grid (grid_max) over B problems in one
// round.
int gato_null_chain_grid_per(int B, int n, int grid_max) {
  return gato::next_round(0, B, n, grid_max, 0).per;
}

// Launches row 16 on `stream` for B problems: scope 0 block (one CTA a
// problem, 2 K s floats of dynamic shared memory), 1 grid (one cooperative
// launch of B * per CTAs, B <= grid_max; buf B * 2 K s floats, parts
// B * per).  Mc (as M) is scratch.  Returns the CUDA error code.
int gato_null_chain(const float* M, const float* y0, float* Mc, float* out,
                    float* buf, float* parts, int B, int K, int s, int n_mv,
                    int n_dot, int trips, int scope, int grid_max,
                    void* stream) {
  gato::ChainArgs a{M, y0, Mc, out, buf, parts, K, s, n_mv, n_dot, trips};
  if (scope == 0) {
    const size_t smem = 2 * (size_t)K * s * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        gato::null_chain_block_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    gato::null_chain_block_kernel<<<B, gato::threads_for(K * s), smem,
                                    (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  if (B < 1 || B > grid_max) return (int)cudaErrorCooperativeLaunchTooLarge;
  int per = gato::next_round(0, B, (long long)K * s, grid_max, 0).per;
  void* args[] = {&a, &per};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)gato::null_chain_grid_kernel, dim3(B * per),
      dim3(gato::kGridThreads), args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Launches row 17 on `stream`: B problems of K knots of width 14
// (K * 14 <= 1024), depth x trips matvecs.  Returns the CUDA error code.
int gato_fma_chain(const float* M, const float* y0, float* out, int B, int K,
                   int depth, int trips, void* stream) {
  const size_t smem = 2 * (size_t)K * gato::kFmaWidth * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gato::fma_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gato::fma_chain_kernel<<<B, gato::threads_for(K * gato::kFmaWidth), smem,
                           (cudaStream_t)stream>>>(M, y0, out, K, depth,
                                                   trips);
  return (int)cudaGetLastError();
}

}  // extern "C"
