// Condensation device code of the one-block exact kernel: the
// cyclic-reduction kernel (direct_fused.cu, row 4); the block-Thomas
// reverse pass (thomas_batch.cu, row 6) takes its constants, the long-K
// recovery (longk.cu, row 13) recover_dz.  Kernel B and the farm kernel
// condense on a cluster (cluster_body.cuh), the long-K tiles (rows 7 and
// 9) and row 5 in condense_tile.cuh's tiles on gauss_jordan.cuh.  One
// block condenses one problem; the functions below are that block's
// stages, each a loop of threads striding over entries:
//
//   gj_invert          (Q_k + rho I)^{-1}, (R_k + rho I)^{-1} and any other
//                      batch of small inverses, with the zero-pivot flag;
//   condense_products  phi_{k+1} = A_k Qinv_k, B_k Rinv_k, theta_k and
//                      phi_{k+1}^T (assemble.condense's formulas);
//   gamma_row          one entry of the condensed right-hand side;
//   recover_dz         dz_x, dz_u from the multipliers (recover.recover_dz).
//
// Every product is an explicit fmaf loop in a fixed order, so two kernels
// that call these functions on the same inputs compute the same bits.  A
// change here is checked by the card tests of rows 4, 6 and 13.
#pragma once

#include <cuda_runtime.h>

#include "pcg_common.cuh"

namespace gato {

// Gauss-Jordan working set of one n x n matrix, in floats: [M | I], the
// pivot row, the pivot column, |diag| and a zero-pivot mark.
inline __host__ __device__ int gj_floats(int n) { return 2 * n * n + 3 * n + 2; }

// Shared work area of the Gauss-Jordan stage when all matrices do not fit.
constexpr long long kGjArenaFloats = 16384;  // 64 KB

// Length of one problem's vectors: K*s multipliers or (K-1)*c controls.
inline __host__ __device__ int vec_len(int K, int s, int c) {
  const int a = K * s, b = (K - 1) * c;
  return a > b ? a : b;
}

inline long long lmax(long long a, long long b) { return a > b ? a : b; }
inline long long lmin(long long a, long long b) { return a < b ? a : b; }

// Gauss-Jordan work area of a block that inverts K s x s matrices at once
// (chunked past kGjArenaFloats) and single c x c ones, in floats.
inline long long gj_arena_floats(int K, int s, int c) {
  const long long n = lmax(gj_floats(s), gj_floats(c));
  return lmax(n, lmin((long long)K * gj_floats(s), kGjArenaFloats));
}

// DIRECT_CONV_RTOL^2 of direct.residual_converged: an exact solve converged
// when eta <= kDirectRtolSq * (1 + ||gamma||^2).
constexpr float kDirectRtolSq = 1e-6f;

// Inverts `count` n x n matrices, matrix m at src + m*src_stride (+ rho on
// the diagonal), into dst + m*dst_stride, by Gauss-Jordan on [M | I] with no
// pivoting and an explicit division of the pivot row
// (gato_tpu/blocktri.py::block_inv).  Zero pivots divide by 1; a zero pivot
// in a matrix whose diagonal is not all zero sets *bad (if `bad` is not
// null) and, with kFlags, flags[m] = 1 (else flags[m] = 0).  src may equal
// dst.  Threads stride over the (matrix, row, column) entries of the work
// area `arena` (`arena_floats` floats of shared memory), chunked when the
// matrices do not all fit; each pivot step is two __syncthreads()-separated
// phases.  Ends synchronised.  `static`: each kernel source that includes
// this header keeps its own copy (and its own host stub).  The per-matrix
// flags are a template choice, not a null test, so that the kernels that
// take none compile as they did before this header existed (the same
// registers and spills, checked with ptxas).
template <bool kFlags>
static __device__ void gj_invert_impl(const float* src, size_t src_stride,
                                      float* dst, size_t dst_stride, int count,
                                      int n, float rho, float* arena,
                                      int arena_floats, int* bad, int* flags) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int w2 = 2 * n;
  const int mat = n * w2;
  int chunk = arena_floats / gj_floats(n);
  if (chunk > count) chunk = count;
  for (int start = 0; start < count; start += chunk) {
    const int cnt = count - start < chunk ? count - start : chunk;
    float* W = arena;
    float* rowb = W + cnt * mat;
    float* colb = rowb + cnt * w2;
    float* dabs = colb + cnt * n;
    float* zp = dabs + cnt;
    for (int e = tid; e < cnt * mat; e += nt) {
      const int m = e / mat, rem = e % mat, rr = rem / w2, cc = rem % w2;
      float val;
      if (cc < n) {
        val = src[(start + m) * src_stride + rr * n + cc];
        if (rr == cc) val += rho;
      } else {
        val = (cc - n == rr) ? 1.f : 0.f;
      }
      W[e] = val;
    }
    for (int m = tid; m < cnt; m += nt) zp[m] = 0.f;
    __syncthreads();
    for (int m = tid; m < cnt; m += nt) {
      float a = 0.f;
      for (int i = 0; i < n; ++i) a += fabsf(W[m * mat + i * w2 + i]);
      dabs[m] = a;
    }
    for (int i = 0; i < n; ++i) {
      for (int e = tid; e < cnt * w2; e += nt) {
        const int m = e / w2, cc = e % w2;
        const float* Wm = W + m * mat;
        const float piv = Wm[i * w2 + i];
        rowb[e] = Wm[i * w2 + cc] / (piv != 0.f ? piv : 1.f);
        if (cc == 0 && piv == 0.f) zp[m] = 1.f;
      }
      for (int e = tid; e < cnt * n; e += nt) {
        const int m = e / n, rr = e % n;
        colb[e] = rr == i ? 0.f : W[m * mat + rr * w2 + i];
      }
      __syncthreads();
      for (int e = tid; e < cnt * mat; e += nt) {
        const int m = e / mat, rem = e % mat, rr = rem / w2, cc = rem % w2;
        const float rv = rowb[m * w2 + cc];
        W[e] = rr == i ? rv : W[e] - colb[m * n + rr] * rv;
      }
      __syncthreads();
    }
    for (int e = tid; e < cnt * n * n; e += nt) {
      const int m = e / (n * n), rem = e % (n * n), rr = rem / n, cc = rem % n;
      dst[(start + m) * dst_stride + rr * n + cc] = W[m * mat + rr * w2 + n + cc];
    }
    for (int m = tid; m < cnt; m += nt) {
      const bool hit = zp[m] != 0.f && dabs[m] > 0.f;
      if (bad != nullptr && hit) *bad = 1;
      if (kFlags) flags[start + m] = hit ? 1 : 0;
    }
    __syncthreads();
  }
}

static __device__ __forceinline__ void gj_invert(
    const float* src, size_t src_stride, float* dst, size_t dst_stride,
    int count, int n, float rho, float* arena, int arena_floats, int* bad) {
  gj_invert_impl<false>(src, src_stride, dst, dst_stride, count, n, rho, arena,
                        arena_floats, bad, nullptr);
}

// gj_invert with one zero-pivot flag per matrix in flags[0..count).
static __device__ __forceinline__ void gj_invert(
    const float* src, size_t src_stride, float* dst, size_t dst_stride,
    int count, int n, float rho, float* arena, int arena_floats, int* bad,
    int* flags) {
  gj_invert_impl<true>(src, src_stride, dst, dst_stride, count, n, rho, arena,
                       arena_floats, bad, flags);
}

// phi_{k+1} = A_k Qinv_k into phi + (k+1)*stride (phi_0 = 0), B_k Rinv_k
// into BR (K-1, s, c), theta_k into theta + k*stride and, with kPhiT,
// phi_{k+1}^T into phiT + k*stride (phiT_{K-1} = 0): the blocks of
// S = btd(phi, theta, phi^T).  Each block is s x s, row-major.  Qinv
// (K, s, s) and Rinv (K-1, c, c) are inputs, computed before with
// gj_invert; A (K-1, s, s), Bm (K-1, s, c).  Ends synchronised.
template <bool kPhiT>
__device__ __forceinline__ void condense_products(
    const float* A, const float* Bm, const float* Qinv, const float* Rinv,
    float* phi, float* theta, float* phiT, size_t stride, float* BR, int K,
    int s, int c) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t ss = (size_t)s * s, sc = (size_t)s * c, cc2 = (size_t)c * c;
  for (size_t e = tid; e < (K - 1) * ss; e += nt) {
    const size_t k = e / ss;
    const int a = (e % ss) / s, j = e % s;
    const float* Ar = A + k * ss + a * s;
    const float* Qi = Qinv + k * ss + j;
    float acc = 0.f;
    for (int e2 = 0; e2 < s; ++e2) acc = fmaf(Ar[e2], Qi[e2 * s], acc);
    phi[(k + 1) * stride + a * s + j] = acc;
  }
  for (size_t e = tid; e < (K - 1) * sc; e += nt) {
    const size_t k = e / sc;
    const int a = (e % sc) / c, j = e % c;
    const float* Br = Bm + k * sc + a * c;
    const float* Ri = Rinv + k * cc2 + j;
    float acc = 0.f;
    for (int e2 = 0; e2 < c; ++e2) acc = fmaf(Br[e2], Ri[e2 * c], acc);
    BR[k * sc + a * c + j] = acc;
  }
  for (size_t e = tid; e < ss; e += nt) {
    phi[e] = 0.f;                                        // phi_0
    if (kPhiT) phiT[(K - 1) * stride + e] = 0.f;  // phi_K^T
  }
  __syncthreads();

  for (size_t e = tid; e < K * ss; e += nt) {
    const size_t k = e / ss;
    const int a = (e % ss) / s, j = e % s;
    float th;
    if (k == 0) {
      th = Qinv[a * s + j];
    } else {
      const float* ph = phi + k * stride + a * s;   // phi_k, row a
      const float* Ak = A + (k - 1) * ss + j * s;   // A_{k-1}, row j
      float t1 = 0.f;
      for (int e2 = 0; e2 < s; ++e2) t1 = fmaf(ph[e2], Ak[e2], t1);
      const float* br = BR + (k - 1) * sc + a * c;
      const float* Bk = Bm + (k - 1) * sc + j * c;
      float t2 = 0.f;
      for (int e2 = 0; e2 < c; ++e2) t2 = fmaf(br[e2], Bk[e2], t2);
      th = (t1 + t2) + Qinv[k * ss + a * s + j];
    }
    theta[k * stride + a * s + j] = th;
    if (kPhiT && k + 1 < (size_t)K)
      phiT[k * stride + a * s + j] = phi[(k + 1) * stride + j * s + a];
  }
  __syncthreads();
}

// gamma entry i = (k, a): Qinv_k q_k + phi_k q_{k-1} + B_{k-1} Rinv_{k-1}
// r_{k-1} - c_k (the interval terms only for k >= 1), with phi_k at
// phi + k*stride as condense_products writes it.
__device__ __forceinline__ float gamma_row(const float* Qinv, const float* phi,
                                           size_t stride, const float* BR,
                                           const float* q, const float* r,
                                           const float* cv, int s, int c,
                                           int i) {
  const size_t ss = (size_t)s * s, sc = (size_t)s * c;
  const int k = i / s, a = i % s;
  const float* qi = Qinv + k * ss + a * s;
  const float* qk = q + k * s;
  float g = 0.f;
  for (int e2 = 0; e2 < s; ++e2) g = fmaf(qi[e2], qk[e2], g);
  if (k == 0) return g - cv[i];
  const float* ph = phi + k * stride + a * s;
  const float* qp = q + (k - 1) * s;
  float t1 = 0.f;
  for (int e2 = 0; e2 < s; ++e2) t1 = fmaf(ph[e2], qp[e2], t1);
  const float* br = BR + (size_t)(k - 1) * sc + a * c;
  const float* rp = r + (k - 1) * c;
  float t2 = 0.f;
  for (int e2 = 0; e2 < c; ++e2) t2 = fmaf(br[e2], rp[e2], t2);
  return ((t1 + t2) + g) - cv[i];
}

// dz_x = Qinv (q - lam - A^T lam_next), dz_u = Rinv (r - B^T lam_next), the
// last state row without the A^T term.  rx (K*s) and ru ((K-1)*c) are
// temporaries; lam must not alias them.  A non-null lam_copy receives lam
// (the fused body's lambda output) in the dz_x loop.  Does not end
// synchronised.
__device__ __forceinline__ void recover_dz(
    const float* Qinv, const float* Rinv, const float* A, const float* Bm,
    const float* q, const float* r, const float* lam, float* rx, float* ru,
    float* dzx_out, float* dzu_out, int K, int s, int c,
    float* lam_copy = nullptr) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t ss = (size_t)s * s, sc = (size_t)s * c, cc2 = (size_t)c * c;
  const int n = K * s;
  for (int i = tid; i < n; i += nt) {
    const int k = i / s, a = i % s;
    float at = 0.f;
    if (k < K - 1) {
      const float* Ak = A + k * ss + a;
      const float* ln = lam + (k + 1) * s;
      for (int e2 = 0; e2 < s; ++e2) at = fmaf(Ak[e2 * s], ln[e2], at);
    }
    rx[i] = (q[i] - lam[i]) - at;
  }
  for (int i = tid; i < (K - 1) * c; i += nt) {
    const int k = i / c, a = i % c;
    const float* Bk = Bm + k * sc + a;
    const float* ln = lam + (k + 1) * s;
    float bt = 0.f;
    for (int e2 = 0; e2 < s; ++e2) bt = fmaf(Bk[e2 * c], ln[e2], bt);
    ru[i] = r[i] - bt;
  }
  __syncthreads();
  for (int i = tid; i < n; i += nt) {
    const int k = i / s, a = i % s;
    const float* qi = Qinv + k * ss + a * s;
    const float* xr = rx + k * s;
    float acc = 0.f;
    for (int e2 = 0; e2 < s; ++e2) acc = fmaf(qi[e2], xr[e2], acc);
    dzx_out[i] = acc;
    if (lam_copy != nullptr) lam_copy[i] = lam[i];
  }
  for (int i = tid; i < (K - 1) * c; i += nt) {
    const int k = i / c, a = i % c;
    const float* ri = Rinv + k * cc2 + a * c;
    const float* xu = ru + k * c;
    float acc = 0.f;
    for (int e2 = 0; e2 < c; ++e2) acc = fmaf(ri[e2], xu[e2], acc);
    dzu_out[i] = acc;
  }
}

}  // namespace gato
