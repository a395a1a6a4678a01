// The long-horizon exact solve: block cyclic reduction of the condensed
// system S lambda = gamma, for horizons past row 4's shared memory.
//
// Replaces the solve stage of gato_tpu/kernels/longk.py's direct ladder:
//   cr_longk_kernel         the inner kernel of _direct_xl_call (row 11,
//                           pallas_call at :860) with _cr_solve_scratch
//   peel_invert_kernel,     _peel_kernel (row 12, pallas_call at :1171),
//   peel_reduce_kernel      one compacting CR level, in two launches
//   unpeel_kernel           the back-substitution of a peeled level, which
//                           gato_tpu does in XLA (_cr_unpeel)
// Plain versions and wrappers: gato_tpu_torch/kernels/longk.py.  Layout:
// S (B, K, 3, s, s) row-major blocks, slots 0 = L (row k, column k-1),
// 1 = D, 2 = U (column k+1); vectors (B, K, s).
//
// Design.  The unit of work is one block row, given to one warp:
//
// * warp_gj inverts one s x s block in the registers of a warp (lane l
//   holds columns l and l + 32 of [M | I]), the Gauss-Jordan of condense.cuh
//   (no pivoting, the pivot row divided explicitly, a zero pivot divided by
//   1), and reports a clamped zero pivot in a block whose diagonal is not
//   all zero.  A template on the widest block (16 or 32) keeps the
//   registers of s <= 16 at one column a lane.
// * warp_reduce_row eliminates an even row's two odd neighbours (the
//   algebra of direct.cr_level), staging the blocks it multiplies in the
//   warp's slice of shared memory; warp_back_row back-substitutes one odd
//   row (direct.cr_back_level).
// * cr_longk_kernel (row 11) is one cooperative launch sized by the
//   occupancy query, with its warps striding over the (problem, row) tasks
//   of every problem of the batch.  Level l (h = 2^l) touches the rows
//   k = 0 mod h, in place on a working copy W of S: the odd rows (k = h mod
//   2h) are inverted into their D slot, a grid barrier, the even rows
//   (k = 0 mod 2h) reduced, a grid barrier.  Level 0 reads S and gamma and
//   writes every row of W and bv, so S is never written and needs no copy
//   pass.  Then the root (row 0), a barrier, and the back-substitution
//   levels, one barrier each.  No row's time on an SM grows with K: a
//   level's rows run on every resident warp, log2 K levels deep.
// * The peel (row 12) is one such level that compacts: peel_invert_kernel
//   inverts every odd row of a batch into D_o^{-1}; peel_reduce_kernel
//   writes the ceil(W/2) reduced even rows into half-width buffers (no lane
//   padding: a level of W rows writes all of them, where the TPU kernel's
//   chunk schedule leaves tail lanes unwritten).  The odd rows' L, U and b
//   stay in the level's input, which the caller keeps for unpeel_kernel.
//
// A clamped zero pivot raises the problem's flag (bad, or the peel's per
// odd row flags): the caller adds gato_tpu's +1e30 to that problem's lambda
// and eta.  The kernels leave lambda unpoisoned, so the back-substitution
// of a peeled level never multiplies the poison.
//
// What bounds them on an H100: the levels together eliminate ~K odd rows
// and reduce ~K even rows, 2 s^3 + 12 s^3 flops a pair (an inverse, six
// s x s products), ~14 K s^3 in all, about twice block Thomas's ~6 K s^3;
// the operator (2,352 B a row at IIWA) moves through L2 a few times.  Each
// row's products are a chain of dependent FMAs on one warp, so the first
// levels are bound by how many warps run at once (at B = 15, K = 8192,
// 61,440 rows at level 0), and the last ones, a few rows and a grid
// barrier each, by latency.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "pcg_common.cuh"

namespace cg = cooperative_groups;

namespace gato {

constexpr int kCrThreads = 256;
constexpr int kCrWarps = kCrThreads / 32;
// Resident cooperative CTAs an SM takes, at most: every CTA arrives at
// every grid barrier.
constexpr int kCrMaxCtasPerSm = 4;

// Shared memory of one warp, in floats: A, B and four staged blocks.
inline __host__ __device__ int warp_floats(int s) { return 6 * s * s; }

inline long long cr_smem_bytes(int s) {
  return (long long)kCrWarps * warp_floats(s) * (long long)sizeof(float);
}

// src (n x n) inverted into dst by the warp; src may equal dst (everything
// is read before anything is written).  Returns 1 on every lane where a
// zero pivot was clamped in a block whose diagonal is not all zero.
template <int kN>
__device__ int warp_gj(const float* src, float* dst, int n) {
  constexpr int kC = kN / 16;  // columns of [M | I] a lane holds
  const int lane = threadIdx.x & 31;
  float col[kC][kN];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int j = c * 32 + lane;
#pragma unroll
    for (int r = 0; r < kN; ++r)
      if (r < n) col[c][r] = j < n ? src[r * n + j] : (j - n == r ? 1.f : 0.f);
  }
  float d = 0.f;
#pragma unroll
  for (int r = 0; r < kN; ++r)
    if (r == lane && r < n) d = fabsf(col[0][r]);
  const float dabs = __shfl_sync(0xffffffffu, warp_sum(d), 0);
  int zero = 0;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    if (i < n) {
      // Column i (i < n <= 32) lives in slot 0 of lane i.
      const float piv = __shfl_sync(0xffffffffu, col[0][i], i);
      zero |= piv == 0.f;
      const float div = piv != 0.f ? piv : 1.f;
      float rv[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) rv[c] = col[c][i] / div;
#pragma unroll
      for (int r = 0; r < kN; ++r) {
        if (r < n && r != i) {
          const float f = __shfl_sync(0xffffffffu, col[0][r], i);
#pragma unroll
          for (int c = 0; c < kC; ++c) col[c][r] = col[c][r] - f * rv[c];
        }
      }
#pragma unroll
      for (int c = 0; c < kC; ++c) col[c][i] = rv[c];
    }
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int j = c * 32 + lane;
#pragma unroll
    for (int r = 0; r < kN; ++r)
      if (r < n && j >= n && j < 2 * n) dst[r * n + j - n] = col[c][r];
  }
  return zero && dabs > 0.f;
}

// n floats from src to the warp's shared dst, then a warp barrier.
__device__ __forceinline__ void warp_stage(float* dst, const float* src, int n) {
  for (int e = threadIdx.x & 31; e < n; e += 32) dst[e] = src[e];
  __syncwarp();
}

// (a, j) entry of the s x s product X Y, both row-major in shared memory.
__device__ __forceinline__ float mm_entry(const float* X, const float* Y,
                                          int s, int a, int j) {
  float acc = 0.f;
  for (int e2 = 0; e2 < s; ++e2) acc = fmaf(X[a * s + e2], Y[e2 * s + j], acc);
  return acc;
}

// One odd neighbour of an even row: its D^{-1}, L, U and b (null where the
// row has no such neighbour).
struct OddRow {
  const float* Dinv;
  const float* L;
  const float* U;
  const float* b;
};

// The even row (Li, Di, Ui, bi) with its left and right odd neighbours
// eliminated (direct.cr_level's algebra): L' = -A L_l, U' = -B U_r,
// D' = (D - A U_l) - B L_r, b' = (b - A b_l) - B b_r, A = L D_l^{-1},
// B = U D_r^{-1}, an absent neighbour contributing zero.  The outputs may
// alias the inputs (the cyclic reduction updates in place).  ws: the warp's
// warp_floats(s) floats of shared memory.
__device__ void warp_reduce_row(const float* Li, const float* Di,
                                const float* Ui, const float* bi, OddRow l,
                                OddRow r, float* Lo, float* Do, float* Uo,
                                float* bo, int s, float* ws) {
  const int lane = threadIdx.x & 31;
  const int ss = s * s;
  float* A = ws;
  float* Bm = A + ss;
  float* T0 = Bm + ss;
  float* T1 = T0 + ss;
  float* T2 = T1 + ss;
  float* T3 = T2 + ss;
  const bool hl = l.Dinv != nullptr, hr = r.Dinv != nullptr;
  if (hl) {
    warp_stage(T0, Li, ss);
    warp_stage(T1, l.Dinv, ss);
  }
  if (hr) {
    warp_stage(T2, Ui, ss);
    warp_stage(T3, r.Dinv, ss);
  }
  for (int e = lane; e < ss; e += 32) {
    const int a = e / s, j = e % s;
    A[e] = hl ? mm_entry(T0, T1, s, a, j) : 0.f;
    Bm[e] = hr ? mm_entry(T2, T3, s, a, j) : 0.f;
  }
  __syncwarp();
  if (hl) {
    warp_stage(T0, l.L, ss);
    warp_stage(T1, l.U, ss);
  }
  if (hr) {
    warp_stage(T2, r.L, ss);
    warp_stage(T3, r.U, ss);
  }
  for (int e = lane; e < ss; e += 32) {
    const int a = e / s, j = e % s;
    float lv = 0.f, au = 0.f, u = 0.f, bl = 0.f;
    if (hl) {
      lv = mm_entry(A, T0, s, a, j);
      au = mm_entry(A, T1, s, a, j);
    }
    if (hr) {
      bl = mm_entry(Bm, T2, s, a, j);
      u = mm_entry(Bm, T3, s, a, j);
    }
    const float d = Di[e];
    Lo[e] = -lv;
    Do[e] = (d - au) - bl;
    Uo[e] = -u;
  }
  if (lane < s) {
    float ab = 0.f, bb = 0.f;
    if (hl)
      for (int e2 = 0; e2 < s; ++e2) ab = fmaf(A[lane * s + e2], l.b[e2], ab);
    if (hr)
      for (int e2 = 0; e2 < s; ++e2) bb = fmaf(Bm[lane * s + e2], r.b[e2], bb);
    const float v = bi[lane];
    bo[lane] = (v - ab) - bb;
  }
  __syncwarp();
}

// x_k = D_k^{-1} ((b_k - L_k x_l) - U_k x_r) of one odd row, x_r null past
// the end (direct.cr_back_level).  ws: the warp's shared memory.
__device__ void warp_back_row(const float* Lk, const float* Dinv,
                              const float* Uk, const float* bk,
                              const float* xl, const float* xr, float* xk,
                              int s, float* ws) {
  const int lane = threadIdx.x & 31;
  if (lane < s) {
    float lx = 0.f, ux = 0.f;
    for (int e2 = 0; e2 < s; ++e2) lx = fmaf(Lk[lane * s + e2], xl[e2], lx);
    if (xr != nullptr)
      for (int e2 = 0; e2 < s; ++e2) ux = fmaf(Uk[lane * s + e2], xr[e2], ux);
    ws[lane] = (bk[lane] - lx) - ux;
  }
  __syncwarp();
  if (lane < s) {
    float acc = 0.f;
    for (int e2 = 0; e2 < s; ++e2) acc = fmaf(Dinv[lane * s + e2], ws[e2], acc);
    xk[lane] = acc;
  }
  __syncwarp();
}

// What the cyclic reduction reads and writes: S (B, K, 3, s, s) and gamma
// (B, K, s), read only; W (B, K, 3, s, s) and bv (B, K, s) the working
// system; x (B, K, s) the solution; bad (B,) zeroed by the caller.
struct CrArrays {
  const float* S;
  const float* gamma;
  float* W;
  float* bv;
  float* x;
  int* bad;
  int B, K, s;
};

// Row 11: the whole block cyclic reduction of every problem of the batch,
// one cooperative launch.
template <int kN>
__global__ void __launch_bounds__(kCrThreads) cr_longk_kernel(CrArrays a) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int K = a.K, s = a.s, B = a.B;
  const size_t ss = (size_t)s * s, slot3 = 3 * ss;
  const int lane = threadIdx.x & 31;
  const int warp = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int nwarps = (int)((gridDim.x * blockDim.x) >> 5);
  float* ws = smem + (threadIdx.x >> 5) * warp_floats(s);
  const float* src = a.S;       // the level's input rows
  const float* bsrc = a.gamma;
  int h = 1;
  for (; h < K; h *= 2) {
    const int h2 = 2 * h;
    const int n_odd = (K - 1 - h) / h2 + 1;   // rows h, 3h, ... < K
    const int n_even = (K - 1) / h2 + 1;      // rows 0, 2h, ... < K
    for (int t = warp; t < B * n_odd; t += nwarps) {
      const size_t b = t / n_odd;
      const size_t row = b * K + h + (size_t)(t % n_odd) * h2;
      const float* in = src + row * slot3;
      float* w = a.W + row * slot3;
      const int hit = warp_gj<kN>(in + ss, w + ss, s);
      if (lane == 0 && hit) a.bad[b] = 1;
      if (in != w) {   // level 0: the row's L, U and b into the working copy
        for (int e = lane; e < (int)ss; e += 32) {
          w[e] = in[e];
          w[2 * ss + e] = in[2 * ss + e];
        }
        if (lane < s) a.bv[row * s + lane] = bsrc[row * s + lane];
      }
    }
    grid.sync();
    for (int t = warp; t < B * n_even; t += nwarps) {
      const size_t b = t / n_even;
      const int k = (t % n_even) * h2;
      const size_t row = b * K + k;
      const float* in = src + row * slot3;
      float* w = a.W + row * slot3;
      OddRow l{nullptr, nullptr, nullptr, nullptr};
      OddRow r{nullptr, nullptr, nullptr, nullptr};
      if (k >= h) {
        const float* o = a.W + (row - h) * slot3;
        l = OddRow{o + ss, o, o + 2 * ss, a.bv + (row - h) * s};
      }
      if (k + h < K) {
        const float* o = a.W + (row + h) * slot3;
        r = OddRow{o + ss, o, o + 2 * ss, a.bv + (row + h) * s};
      }
      warp_reduce_row(in, in + ss, in + 2 * ss, bsrc + row * s, l, r, w, w + ss,
                      w + 2 * ss, a.bv + row * s, s, ws);
    }
    grid.sync();
    src = a.W;
    bsrc = a.bv;
  }
  // The root: row 0 alone, inverted into the warp's shared memory (for
  // K = 1 it is S's own row, which is never written).
  for (int t = warp; t < B; t += nwarps) {
    const size_t row = (size_t)t * K;
    const float* in = src + row * slot3;
    float* dinv = ws + s;
    const int hit = warp_gj<kN>(in + ss, dinv, s);
    if (lane == 0 && hit) a.bad[t] = 1;
    __syncwarp();
    if (lane < s) {
      float acc = 0.f;
      for (int e2 = 0; e2 < s; ++e2)
        acc = fmaf(dinv[lane * s + e2], bsrc[row * s + e2], acc);
      a.x[row * s + lane] = acc;
    }
    __syncwarp();
  }
  // Back-substitution, level by level: this level's odd rows hold D^{-1}
  // in their D slot.
  for (h /= 2; h >= 1; h /= 2) {
    grid.sync();
    const int h2 = 2 * h;
    const int n_odd = (K - 1 - h) / h2 + 1;
    for (int t = warp; t < B * n_odd; t += nwarps) {
      const size_t b = t / n_odd;
      const int k = h + (t % n_odd) * h2;
      const size_t row = b * K + k;
      const float* w = a.W + row * slot3;
      const float* xr = k + h < K ? a.x + (row + h) * s : nullptr;
      warp_back_row(w, w + ss, w + 2 * ss, a.bv + row * s, a.x + (row - h) * s,
                    xr, a.x + row * s, s, ws);
    }
  }
}

// Row 12, phase 1: D_o^{-1} of every odd row 2j+1 of a level of W rows into
// Doinv (B, W/2, s, s), and its clamp flag into flags (B, W/2).
template <int kN>
__global__ void __launch_bounds__(kCrThreads)
peel_invert_kernel(const float* S, float* Doinv, int* flags, int B, int W,
                   int s) {
  const size_t ss = (size_t)s * s;
  const int wo = W / 2;
  const int t = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  if (t >= B * wo) return;
  const size_t b = t / wo, j = t % wo;
  const float* in = S + ((b * W + 2 * j + 1) * 3 + 1) * ss;
  const int hit = warp_gj<kN>(in, Doinv + (size_t)t * ss, s);
  if ((threadIdx.x & 31) == 0) flags[t] = hit;
}

// Row 12, phase 2: the reduced system of even row 2j into row j of Sh
// (B, ceil(W/2), 3, s, s) and bh (B, ceil(W/2), s).
__global__ void __launch_bounds__(kCrThreads)
peel_reduce_kernel(const float* S, const float* bvec, const float* Doinv,
                   float* Sh, float* bh, int B, int W, int s) {
  extern __shared__ float smem[];
  const size_t ss = (size_t)s * s, slot3 = 3 * ss;
  const int wo = W / 2, we = (W + 1) / 2;
  const int t = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  if (t >= B * we) return;
  float* ws = smem + (threadIdx.x >> 5) * warp_floats(s);
  const size_t b = t / we;
  const int j = t % we;
  const size_t row = b * W + 2 * j;
  const float* in = S + row * slot3;
  OddRow l{nullptr, nullptr, nullptr, nullptr};
  OddRow r{nullptr, nullptr, nullptr, nullptr};
  if (j >= 1) {
    const float* o = in - slot3;
    l = OddRow{Doinv + (b * wo + j - 1) * ss, o, o + 2 * ss, bvec + (row - 1) * s};
  }
  if (j < wo) {
    const float* o = in + slot3;
    r = OddRow{Doinv + (b * wo + j) * ss, o, o + 2 * ss, bvec + (row + 1) * s};
  }
  float* out = Sh + (size_t)t * slot3;
  warp_reduce_row(in, in + ss, in + 2 * ss, bvec + row * s, l, r, out, out + ss,
                  out + 2 * ss, bh + (size_t)t * s, s, ws);
}

// The back-substitution of a peeled level: x (B, W, s) from the reduced
// system's solution xh (B, ceil(W/2), s), the level's input S, b and the
// peel's Doinv: x_{2j} = xh_j, x_{2j+1} = D_o^{-1} ((b_o - L_o xh_j) - U_o
// xh_{j+1}).
__global__ void __launch_bounds__(kCrThreads)
unpeel_kernel(const float* S, const float* bvec, const float* Doinv,
              const float* xh, float* x, int B, int W, int s) {
  extern __shared__ float smem[];
  const size_t ss = (size_t)s * s, slot3 = 3 * ss;
  const int wo = W / 2, we = (W + 1) / 2;
  const int t = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  if (t >= B * we) return;
  const int lane = threadIdx.x & 31;
  float* ws = smem + (threadIdx.x >> 5) * s;
  const size_t b = t / we;
  const int j = t % we;
  const size_t row = b * W + 2 * j;
  if (lane < s) x[row * s + lane] = xh[(size_t)t * s + lane];
  if (j < wo) {
    const float* o = S + (row + 1) * slot3;
    const float* xr = j + 1 < we ? xh + ((size_t)t + 1) * s : nullptr;
    warp_back_row(o, Doinv + (b * wo + j) * ss, o + 2 * ss, bvec + (row + 1) * s,
                  xh + (size_t)t * s, xr, x + (row + 1) * s, s, ws);
  }
}

// Resident CTAs of the cooperative kernel: blocks per SM (at most
// kCrMaxCtasPerSm) times SMs; 0 if none fits, a negative CUDA error code if
// a query fails.
template <int kN>
int cr_resident_ctas(int s) {
  const void* kernel = (const void*)cr_longk_kernel<kN>;
  const size_t smem = (size_t)cr_smem_bytes(s);
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kCrThreads, smem);
  if (err != cudaSuccess) return -(int)err;
  if (!coop) return -(int)cudaErrorNotSupported;
  if (per_sm > kCrMaxCtasPerSm) per_sm = kCrMaxCtasPerSm;
  return per_sm * sms;
}

// Blocks of kCrThreads for one warp per task.
inline unsigned warp_blocks(long long tasks) {
  return (unsigned)((tasks + kCrWarps - 1) / kCrWarps);
}

}  // namespace gato

extern "C" {

// Dynamic shared memory of a CTA of the cyclic reduction or the peel's
// reduction, in bytes.
long long gato_longk_cr_smem_bytes(int s) { return gato::cr_smem_bytes(s); }

// Resident CTAs of row 11's cooperative kernel on the current device at
// block width s; 0 if none fits, a negative CUDA error code if a query
// fails.
int gato_longk_cr_grid(int s) {
  return s <= 16 ? gato::cr_resident_ctas<16>(s) : gato::cr_resident_ctas<32>(s);
}

// Launches row 11 on `stream`: x (B, K, s) with S x = gamma for B problems,
// W (B, K, 3, s, s) and bv (B, K, s) scratch, bad (B) zeroed ints.  Up to
// grid_max CTAs (gato_longk_cr_grid), no more than the first level has
// rows for.  Returns the CUDA error code (0 on success).
int gato_longk_cr(const float* S, const float* gamma, float* W, float* bv,
                  float* x, int* bad, int B, int K, int s, int grid_max,
                  void* stream) {
  if (grid_max < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long rows = (long long)B * ((K + 1) / 2);
  long long grid = (rows + gato::kCrWarps - 1) / gato::kCrWarps;
  if (grid > grid_max) grid = grid_max;
  if (grid < 1) grid = 1;
  gato::CrArrays a{S, gamma, W, bv, x, bad, B, K, s};
  void* args[] = {&a};
  const size_t smem = (size_t)gato::cr_smem_bytes(s);
  const void* kernel = s <= 16 ? (const void*)gato::cr_longk_kernel<16>
                               : (const void*)gato::cr_longk_kernel<32>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchCooperativeKernel(kernel, dim3((unsigned)grid),
                                    dim3(gato::kCrThreads), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Launches row 12 on `stream` (both phases) for a level of W >= 2 rows of B
// problems: Sh (B, ceil(W/2), 3, s, s), bh (B, ceil(W/2), s), Doinv
// (B, W/2, s, s) and flags (B, W/2).  Returns the CUDA error code.
int gato_longk_peel(const float* S, const float* b, float* Sh, float* bh,
                    float* Doinv, int* flags, int B, int W, int s,
                    void* stream) {
  const long long odd = (long long)B * (W / 2), even = (long long)B * ((W + 1) / 2);
  if (s <= 16)
    gato::peel_invert_kernel<16><<<gato::warp_blocks(odd), gato::kCrThreads, 0,
                                   (cudaStream_t)stream>>>(S, Doinv, flags, B, W, s);
  else
    gato::peel_invert_kernel<32><<<gato::warp_blocks(odd), gato::kCrThreads, 0,
                                   (cudaStream_t)stream>>>(S, Doinv, flags, B, W, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)gato::cr_smem_bytes(s);
  err = cudaFuncSetAttribute(gato::peel_reduce_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gato::peel_reduce_kernel<<<gato::warp_blocks(even), gato::kCrThreads, smem,
                             (cudaStream_t)stream>>>(S, b, Doinv, Sh, bh, B, W, s);
  return (int)cudaGetLastError();
}

// Launches the back-substitution of a peeled level on `stream`: x (B, W, s)
// from xh (B, ceil(W/2), s) and the level's S, b and Doinv.  Returns the
// CUDA error code.
int gato_longk_unpeel(const float* S, const float* b, const float* Doinv,
                      const float* xh, float* x, int B, int W, int s,
                      void* stream) {
  const long long even = (long long)B * ((W + 1) / 2);
  gato::unpeel_kernel<<<gato::warp_blocks(even), gato::kCrThreads,
                        (size_t)gato::kCrWarps * s * sizeof(float),
                        (cudaStream_t)stream>>>(S, b, Doinv, xh, x, B, W, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
