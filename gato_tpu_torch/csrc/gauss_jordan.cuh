// The Gauss-Jordan batch of small inverses in shared memory, shared by
// kernel B and the farm kernel (cluster_body.cuh) and the long-K
// condensation tiles (longk.cu, rows 7 and 9).
//
// A pivot step is two phases: the (matrix, column) threads divide pivot row
// i by its diagonal into `rowb`; then the (matrix, row) threads update their
// rows, each loading its row and the pivot row into registers before it
// writes (so the loads overlap).  Two __syncthreads a pivot, the loads of a
// phase issued ahead of its stores: the design that took kernel B's Q batch
// from 40 us (rows in registers, one barrier a step) to 8 us on an H100.
// A row of [M | I] wider than kGjRowRegs (n = 36: 72 columns) is updated
// in its two halves, each loaded whole before it is written: the same
// fmaf a column, in half the registers.
#pragma once

#include <cuda_runtime.h>

namespace gato {

// Columns of [M | I] a thread's row update holds in registers at once.
constexpr int kGjRowRegs = 64;

// Shared floats of one Gauss-Jordan round of `chunk` n x n matrices: [M | I]
// of each, its pivot row and its zero-pivot mark.
inline __host__ __device__ long long gj_round_floats(int chunk, int n) {
  return 2LL * chunk * n * n + 2LL * chunk * n + chunk;
}

// Inverts `count` n x n matrices, matrix m at src + m src_stride (+ rho on
// the diagonal), into dst + m dst_stride (matrix 0 into `dst0` when it is
// not null), by Gauss-Jordan on [M | I] in the shared area W with no
// pivoting and an explicit division of the pivot row (gato_tpu/blocktri.py::
// block_inv).  Threads tid of nt; matrices go in rounds of nt / n, each
// round's working set gj_round_floats(nt / n, n) floats of W.  A zero pivot
// divides by 1 and, in a matrix whose diagonal is not all zero, sets *bad
// (an int or a bool; when bad is not null).  kN > 0 compiles n in; 0 reads
// n_rt.  Ends synchronised.
template <int kN, class Flag>
__device__ __forceinline__ void gj_invert_smem(float* W, int tid, int nt,
                                               const float* src, int src_stride,
                                               float* dst, int dst_stride,
                                               float* dst0, int count, int n_rt,
                                               float rho, Flag* bad) {
  const int n = kN > 0 ? kN : n_rt;
  const int w2 = 2 * n, mat = n * w2;
  int chunk = nt / n;
  if (chunk > count) chunk = count;
  float* rowb = W + chunk * mat;          // [chunk][2n]
  int* zp = reinterpret_cast<int*>(rowb + chunk * w2);
  for (int m0 = 0; m0 < count; m0 += chunk) {
    const int cm = count - m0 < chunk ? count - m0 : chunk;
    if (tid < cm) zp[tid] = 0;
    for (int t = tid; t < cm * n; t += nt) {
      const int m = t / n, rr = t - m * n;
      const float* sr = src + (long long)(m0 + m) * src_stride + rr * n;
      float* w = W + m * mat + rr * w2;
      for (int cc = 0; cc < n; ++cc) {
        const float v = sr[cc];
        w[cc] = cc == rr ? v + rho : v;
        w[n + cc] = cc == rr ? 1.f : 0.f;
      }
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      for (int t = tid; t < cm * w2; t += nt) {
        const int m = t / w2, cc = t - m * w2;
        const float* wi = W + m * mat + i * w2;
        const float piv = wi[i];
        if (cc == 0 && piv == 0.f) zp[m] = 1;
        rowb[m * w2 + cc] = wi[cc] / (piv != 0.f ? piv : 1.f);
      }
      __syncthreads();
      for (int t = tid; t < cm * n; t += nt) {
        const int m = t / n, rr = t - m * n;
        float* w = W + m * mat + rr * w2;
        const float* rb = rowb + m * w2;
        if constexpr (2 * kN > kGjRowRegs) {
          const float f = w[i];
#pragma unroll
          for (int h = 0; h < 2 * kN; h += kN) {
            float wv[kN], rv[kN];
#pragma unroll
            for (int cc = 0; cc < kN; ++cc) {
              wv[cc] = w[h + cc];
              rv[cc] = rb[h + cc];
            }
#pragma unroll
            for (int cc = 0; cc < kN; ++cc)
              wv[cc] = rr == i ? rv[cc] : fmaf(-f, rv[cc], wv[cc]);
#pragma unroll
            for (int cc = 0; cc < kN; ++cc) w[h + cc] = wv[cc];
          }
        } else if (kN > 0) {
          float wv[2 * (kN > 0 ? kN : 1)], rv[2 * (kN > 0 ? kN : 1)];
#pragma unroll
          for (int cc = 0; cc < 2 * kN; ++cc) {
            wv[cc] = w[cc];
            rv[cc] = rb[cc];
          }
          const float f = w[i];
#pragma unroll
          for (int cc = 0; cc < 2 * kN; ++cc)
            wv[cc] = rr == i ? rv[cc] : fmaf(-f, rv[cc], wv[cc]);
#pragma unroll
          for (int cc = 0; cc < 2 * kN; ++cc) w[cc] = wv[cc];
        } else {
          const float f = w[i];
          for (int cc = 0; cc < w2; ++cc)
            w[cc] = rr == i ? rb[cc] : fmaf(-f, rb[cc], w[cc]);
        }
      }
      __syncthreads();
    }
    for (int t = tid; t < cm * n * n; t += nt) {
      const int m = t / (n * n), e = t - m * n * n, rr = e / n, cc = e - rr * n;
      const int mm = m0 + m;
      float* d = mm == 0 && dst0 != nullptr ? dst0 : dst + (long long)mm * dst_stride;
      d[e] = W[m * mat + rr * w2 + n + cc];
    }
    if (tid < cm && zp[tid] != 0 && bad != nullptr) {
      // A flag only for a matrix whose diagonal (+ rho) is not all zero.
      const float* sm = src + (long long)(m0 + tid) * src_stride;
      bool live = false;
      for (int d = 0; d < n; ++d) live |= sm[d * n + d] + rho != 0.f;
      if (live) *bad = 1;
    }
    __syncthreads();
  }
}

}  // namespace gato
