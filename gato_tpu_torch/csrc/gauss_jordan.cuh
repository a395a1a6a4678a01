// The Gauss-Jordan batch of small inverses, shared by kernel B and the farm
// kernel (cluster_body.cuh) and the long-K condensation tiles (longk.cu,
// rows 7 and 9).
//
// Widths up to 32, in shared memory.  A pivot step is two phases: the
// (matrix, column) threads divide pivot row i by its diagonal into `rowb`;
// then the (matrix, row) threads update their rows, each loading its row
// and the pivot row into registers before it writes (so the loads
// overlap).  Two __syncthreads a pivot, the loads of a phase issued ahead
// of its stores: the design that took kernel B's Q batch at IIWA's width
// from 40 us (rows in registers, one barrier a step) to 8 us on an H100.
//
// Widths above 32 (kernel B's <36, 12>), one warp a matrix (gj_invert_warp):
// there the two phases cost two CTA barriers a pivot, and rows of [M | I]
// 72 floats apart fell on four banks.  Warp w inverts matrices w, w +
// nwarps, ... with [M | I] in registers in warp_gj_pad's layout: column J
// in lane J % 32, slot J / 32, for the kF = 2n / 32 whole slots, which
// hold all of M's columns.  The rest, kRem = 2n - 32 kF columns of I (8 at
// n = 36), would leave most of a further slot empty, so lane l holds
// column 32 kF + l % kRem for the rows r with r % kG = l / kRem, kG = 32 /
// kRem groups: 81 floats a lane at n = 36, not 108.  A pivot step is
// shuffles and arithmetic alone: the pivot and each row's factor from the
// pivot column's lane, the rest's pivot-row entry from its group's lane;
// no barrier inside the pivot loop, one at the end.
//
// Both paths compute every entry of [M | I] alike, so the wide path keeps
// the bits of the shared-memory one: the same [M | I] with + rho on M's
// diagonal, the pivot row divided by its diagonal with '/', each row's
// factor read before the row is written, fmaf(-f, pivot row, row) for
// every other row; only the order of the rows within a step differs (the
// next pivot's row first), and no entry depends on it.
#pragma once

#include <cuda_runtime.h>

namespace gato {

// Shared floats of one Gauss-Jordan round of `chunk` n x n matrices: [M | I]
// of each, its pivot row and its zero-pivot mark.
inline __host__ __device__ long long gj_round_floats(int chunk, int n) {
  return 2LL * chunk * n * n + 2LL * chunk * n + chunk;
}

// gj_invert_smem's work for kN > 32, one warp a matrix with [M | I] in
// registers (the header gives the layout).  Ends synchronised.
template <int kN, class Flag>
__device__ __forceinline__ void gj_invert_warp(int tid, int nt, const float* src,
                                               int src_stride, float* dst,
                                               int dst_stride, float* dst0,
                                               int count, float rho, Flag* bad) {
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int kF = 2 * kN / 32, kRem = 2 * kN - 32 * kF;
  constexpr int kG = kRem > 0 ? 32 / kRem : 1;
  constexpr int kP = kRem > 0 ? (kN + kG - 1) / kG : 0;
  static_assert(32 * kF >= kN, "M's columns lie in the whole slots");
  const int lane = tid & 31;
  const int g = kRem > 0 ? lane / kRem : 0;
  const int jr = 32 * kF + (kRem > 0 ? lane % kRem : 0) - kN;  // the rest's I column
  for (int m = tid >> 5; m < count; m += nt >> 5) {
    const float* sm = src + (long long)m * src_stride;
    float col[kF][kN], part[kP > 0 ? kP : 1];
    bool nz = false;
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      const int J = 32 * f + lane;
#pragma unroll
      for (int r = 0; r < kN; ++r) {
        if (J < kN) {
          float v = sm[r * kN + J];
          if (r == J) {
            v = v + rho;
            nz |= v != 0.f;
          }
          col[f][r] = v;
        } else {
          col[f][r] = J - kN == r ? 1.f : 0.f;
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kP; ++p) part[p] = jr == kG * p + g ? 1.f : 0.f;
    // A flag only for a matrix whose diagonal (+ rho) is not all zero.
    const bool live = __any_sync(kAll, nz);
    int zero = 0;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const float piv = __shfl_sync(kAll, col[i / 32][i], i % 32);
      zero |= piv == 0.f;
      const float d = piv != 0.f ? piv : 1.f;
      float rv[kF], rp = 0.f;
#pragma unroll
      for (int f = 0; f < kF; ++f) rv[f] = col[f][i] / d;
      if (kP > 0)
        rp = __shfl_sync(kAll, part[i / kG], (i % kG) * kRem + lane % kRem) / d;
#pragma unroll
      for (int t = 1; t < kN; ++t) {
        const int r = (i + t) % kN;
        const float fr = __shfl_sync(kAll, col[i / 32][r], i % 32);
#pragma unroll
        for (int f = 0; f < kF; ++f) col[f][r] = fmaf(-fr, rv[f], col[f][r]);
        if (kP > 0 && g == r % kG) part[r / kG] = fmaf(-fr, rp, part[r / kG]);
      }
#pragma unroll
      for (int f = 0; f < kF; ++f) col[f][i] = rv[f];
      if (kP > 0 && g == i % kG) part[i / kG] = rp;
    }
    float* dm = m == 0 && dst0 != nullptr ? dst0 : dst + (long long)m * dst_stride;
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      const int J = 32 * f + lane - kN;
      if (J >= 0) {
#pragma unroll
        for (int r = 0; r < kN; ++r) dm[r * kN + J] = col[f][r];
      }
    }
    if (g < kG) {
#pragma unroll
      for (int p = 0; p < kP; ++p)
        if (kG * p + g < kN) dm[(kG * p + g) * kN + jr] = part[p];
    }
    if (lane == 0 && zero && live && bad != nullptr) *bad = 1;
  }
  __syncthreads();
}

// Inverts `count` n x n matrices, matrix m at src + m src_stride (+ rho on
// the diagonal), into dst + m dst_stride (matrix 0 into `dst0` when it is
// not null), by Gauss-Jordan on [M | I] with no pivoting and an explicit
// division of the pivot row (gato_tpu/blocktri.py::block_inv).  Threads tid
// of nt.  n <= 32: in the shared area W, matrices in rounds of nt / n, each
// round's working set gj_round_floats(nt / n, n) floats of W; kN > 32: one
// warp a matrix in registers (gj_invert_warp; W unused).  A zero pivot
// divides by 1 and, in a matrix whose diagonal is not all zero, sets *bad
// (an int or a bool; when bad is not null).  kN > 0 compiles n in; 0 reads
// n_rt.  Ends synchronised.
template <int kN, class Flag>
__device__ __forceinline__ void gj_invert_smem(float* W, int tid, int nt,
                                               const float* src, int src_stride,
                                               float* dst, int dst_stride,
                                               float* dst0, int count, int n_rt,
                                               float rho, Flag* bad) {
  if constexpr (kN > 32) {
    gj_invert_warp<kN>(tid, nt, src, src_stride, dst, dst_stride, dst0, count, rho,
                       bad);
  } else {
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
          if (kN > 0) {
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
}

}  // namespace gato
