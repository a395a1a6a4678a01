// The per-problem body of the fused whole solve: condense, preconditioner,
// PCG and recovery for one problem, run by one thread block.
//
// Kernel B (fused_solve.cu) runs it once per block; the sequence kernel
// (fused_sequence.cu) runs it T times per block, one step after another,
// each step warm-started from the previous step's multipliers.  Both
// compile this one body, so a step of the sequence computes exactly what
// kernel B computes for the same inputs, lambda_0 and rho.
//
// The body:
//   1. inverts Q_k + rho I and R_k + rho I by Gauss-Jordan on [M | I] with
//      no pivoting and an explicit division of the pivot row
//      (gato_tpu/blocktri.py::block_inv); a zero pivot is divided by 1 and,
//      in a block whose diagonal is not all zero, flags the problem;
//   2. forms phi, theta, S (K, 3, s, s) and gamma;
//   3. assembles the preconditioner: scalar Jacobi, block Jacobi
//      (theta_k^{-1} by the same Gauss-Jordan) or the symmetric stair, whose
//      right blocks are computed directly as
//      -theta_k^{-1} phi_{k+1}^T theta_{k+1}^{-1};
//   4. runs the PCG loop shared with kernel A (pcg_common.cuh); a flagged
//      problem is frozen out of it: it runs no iteration, keeps lambda_0,
//      reports max_iters, not converged and eta = 1e30;
//   5. recovers dz_x, dz_u.
// The Gauss-Jordan runs on all knots at once, threads striding over the
// (matrix, row, column) entries of [M | I] held in shared memory, chunked
// when K matrices do not fit the 64 KB work area; each pivot step is two
// __syncthreads()-separated phases (read the pivot row and column, then
// update).  Every product is an explicit loop in this file.
//
// Memory: S and Pinv (K, 3, s, s) cannot both stay in shared memory at
// IIWA (s=14, K=50): 117,600 B each, 235,200 B together, above the
// 232,448 B a block may use.  They are written to a per-problem global
// scratch slice, with Qinv, Rinv, B Rinv and a product temporary, and read
// back from L1/L2 in the loop; the shared memory holds the Gauss-Jordan
// work area and, after it, the PCG vectors (the same floats, reused).
#pragma once

#include <cuda_runtime.h>

#include "pcg_common.cuh"

namespace gato {

enum Precond { kJacobi = 0, kBlockJacobi = 1, kStair = 2 };

// Gauss-Jordan working set of one n x n matrix, in floats: [M | I], the
// pivot row, the pivot column, |diag| and a zero-pivot mark.
inline __host__ __device__ int gj_floats(int n) { return 2 * n * n + 3 * n + 2; }

// Shared work area of the Gauss-Jordan stage when all K matrices do not fit.
constexpr long long kGjArenaFloats = 16384;  // 64 KB

inline __host__ __device__ int vec_len(int K, int s, int c) {
  const int a = K * s, b = (K - 1) * c;
  return a > b ? a : b;
}

inline long long lmax(long long a, long long b) { return a > b ? a : b; }
inline long long lmin(long long a, long long b) { return a < b ? a : b; }

// Dynamic shared memory of one block, in floats: the Gauss-Jordan work area
// and, reusing it, the six PCG vectors.
inline long long fused_arena_floats(int K, int s, int c) {
  long long n = 6LL * vec_len(K, s, c);
  n = lmax(n, gj_floats(s));
  n = lmax(n, gj_floats(c));
  n = lmax(n, lmin((long long)K * gj_floats(s), kGjArenaFloats));
  return n;
}

// Floats of global scratch one problem needs: S, Pinv, Qinv, Rinv, B Rinv
// and a product temporary.
inline long long fused_scratch_floats(int K, int s, int c) {
  const long long ss = (long long)s * s;
  return 2LL * K * 3 * ss + K * ss + (K - 1LL) * c * c + (K - 1LL) * s * c +
         K * ss;
}

// Inverts `count` n x n matrices, matrix m at src + m*src_stride (+ rho on
// the diagonal), into dst + m*dst_stride.  Zero pivots divide by 1; with
// `bad` non-null, a zero pivot in a matrix whose diagonal is not all zero
// sets *bad.  Ends synchronised.  `static`: each kernel source that
// includes this header keeps its own copy (and its own host stub).
static __device__ void gj_invert(const float* src, size_t src_stride, float* dst,
                                 size_t dst_stride, int count, int n,
                                 float rho, float* arena, int arena_floats,
                                 int* bad) {
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
    if (bad != nullptr)
      for (int m = tid; m < cnt; m += nt)
        if (zp[m] != 0.f && dabs[m] > 0.f) *bad = 1;
    __syncthreads();
  }
}

// One problem's whole solve.  Inputs and outputs point at this problem's
// slices: Q (K, s, s), R (K-1, c, c), A (K-1, s, s), Bm (K-1, s, c),
// q, cv, lam0, lam_out, dzx_out (K, s), r, dzu_out (K-1, c), one int or
// float each at iters_out, conv_out, eta_out.  `scratch` holds
// fused_scratch_floats(K, s, c) floats; `smem` is the block's dynamic
// shared memory of fused_arena_floats(K, s, c) floats, `red` 33 floats of
// shared memory, `bad` one shared int.  Opens with a barrier after
// clearing *bad, so a block may run it again on the same scratch, smem and
// flag; lam0 may then be the previous run's lam_out.
__device__ __forceinline__ void fused_body(
    const float* Q, const float* R, const float* A, const float* Bm,
    const float* q, const float* r, const float* cv, const float* lam0,
    float* scratch, float* lam_out, float* dzx_out, float* dzu_out,
    int* iters_out, int* conv_out, float* eta_out, int K, int s, int c,
    float rho, float exit_tol, int max_iters, int poly_degree, int precond,
    int arena_floats, float* smem, float* red, int* bad) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t ss = (size_t)s * s, sc = (size_t)s * c, cc2 = (size_t)c * c;
  const size_t slot3 = 3 * ss;
  const int n = K * s;
  float* Sg = scratch;                       // (K, 3, s, s)
  float* Pg = Sg + K * slot3;                // (K, 3, s, s)
  float* Qinv = Pg + K * slot3;              // (K, s, s)
  float* Rinv = Qinv + K * ss;               // (K-1, c, c)
  float* BR = Rinv + (K - 1) * cc2;          // (K-1, s, c)
  float* T = BR + (K - 1) * sc;              // (K, s, s)
  if (tid == 0) *bad = 0;
  __syncthreads();

  // 1. (Q_k + rho I)^{-1} and (R_k + rho I)^{-1}, with the zero-pivot flag.
  gj_invert(Q, ss, Qinv, ss, K, s, rho, smem, arena_floats, bad);
  gj_invert(R, cc2, Rinv, cc2, K - 1, c, rho, smem, arena_floats, bad);

  // 2. phi_{k+1} = A_k Qinv_k into S[k+1][0]; B_k Rinv_k; the edge zeros.
  for (size_t e = tid; e < (K - 1) * ss; e += nt) {
    const size_t k = e / ss;
    const int a = (e % ss) / s, j = e % s;
    const float* Ar = A + k * ss + a * s;
    const float* Qi = Qinv + k * ss + j;
    float acc = 0.f;
    for (int e2 = 0; e2 < s; ++e2) acc = fmaf(Ar[e2], Qi[e2 * s], acc);
    Sg[(k + 1) * slot3 + a * s + j] = acc;
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
    Sg[e] = 0.f;                                // S[0][0]
    Sg[(K - 1) * slot3 + 2 * ss + e] = 0.f;     // S[K-1][2]
  }
  __syncthreads();

  // 3. theta_k into S[k][1]; phi_{k+1}^T into S[k][2].
  for (size_t e = tid; e < K * ss; e += nt) {
    const size_t k = e / ss;
    const int a = (e % ss) / s, j = e % s;
    float th;
    if (k == 0) {
      th = Qinv[a * s + j];
    } else {
      const float* ph = Sg + k * slot3 + a * s;     // phi_k, row a
      const float* Ak = A + (k - 1) * ss + j * s;   // A_{k-1}, row j
      float t1 = 0.f;
      for (int e2 = 0; e2 < s; ++e2) t1 = fmaf(ph[e2], Ak[e2], t1);
      const float* br = BR + (k - 1) * sc + a * c;
      const float* Bk = Bm + (k - 1) * sc + j * c;
      float t2 = 0.f;
      for (int e2 = 0; e2 < c; ++e2) t2 = fmaf(br[e2], Bk[e2], t2);
      th = (t1 + t2) + Qinv[k * ss + a * s + j];
    }
    Sg[k * slot3 + ss + a * s + j] = th;
    if (k + 1 < (size_t)K) Sg[k * slot3 + 2 * ss + a * s + j] = Sg[(k + 1) * slot3 + j * s + a];
  }
  __syncthreads();

  // 4. The preconditioner.
  if (precond == kJacobi) {
    for (size_t e = tid; e < K * slot3; e += nt) {
      const size_t k = e / slot3, rem = e % slot3;
      const int jslot = rem / ss, a = (rem % ss) / s, j = rem % s;
      float val = 0.f;
      if (jslot == 1 && a == j) {
        const float d = Sg[k * slot3 + ss + a * s + a];
        val = 1.f / (d != 0.f ? d : 1.f);
      }
      Pg[e] = val;
    }
  } else {
    // theta_k^{-1} into Pinv[k][1].
    gj_invert(Sg + ss, slot3, Pg + ss, slot3, K, s, 0.f, smem, arena_floats,
              nullptr);
    if (precond == kBlockJacobi) {
      for (size_t e = tid; e < K * ss; e += nt) {
        const size_t k = e / ss, rem = e % ss;
        Pg[k * slot3 + rem] = 0.f;
        Pg[k * slot3 + 2 * ss + rem] = 0.f;
      }
    } else {
      // T_k = theta_k^{-1} phi_k  (k >= 1)
      for (size_t e = tid; e < (K - 1) * ss; e += nt) {
        const size_t k = 1 + e / ss;
        const int a = (e % ss) / s, j = e % s;
        const float* ti = Pg + k * slot3 + ss + a * s;
        const float* ph = Sg + k * slot3 + j;
        float acc = 0.f;
        for (int e2 = 0; e2 < s; ++e2) acc = fmaf(ti[e2], ph[e2 * s], acc);
        T[k * ss + a * s + j] = acc;
      }
      __syncthreads();
      // Pinv[k][0] = -(T_k theta_{k-1}^{-1})
      for (size_t e = tid; e < K * ss; e += nt) {
        const size_t k = e / ss;
        const int a = (e % ss) / s, j = e % s;
        float val = 0.f;
        if (k > 0) {
          const float* tr = T + k * ss + a * s;
          const float* tp = Pg + (k - 1) * slot3 + ss + j;
          float acc = 0.f;
          for (int e2 = 0; e2 < s; ++e2) acc = fmaf(tr[e2], tp[e2 * s], acc);
          val = -acc;
        }
        Pg[k * slot3 + a * s + j] = val;
      }
      __syncthreads();
      // T_k = theta_k^{-1} phi_{k+1}^T  (k <= K-2)
      for (size_t e = tid; e < (K - 1) * ss; e += nt) {
        const size_t k = e / ss;
        const int a = (e % ss) / s, j = e % s;
        const float* ti = Pg + k * slot3 + ss + a * s;
        const float* sr = Sg + k * slot3 + 2 * ss + j;
        float acc = 0.f;
        for (int e2 = 0; e2 < s; ++e2) acc = fmaf(ti[e2], sr[e2 * s], acc);
        T[k * ss + a * s + j] = acc;
      }
      __syncthreads();
      // Pinv[k][2] = -(T_k theta_{k+1}^{-1})
      for (size_t e = tid; e < K * ss; e += nt) {
        const size_t k = e / ss;
        const int a = (e % ss) / s, j = e % s;
        float val = 0.f;
        if (k + 1 < (size_t)K) {
          const float* tr = T + k * ss + a * s;
          const float* tn = Pg + (k + 1) * slot3 + ss + j;
          float acc = 0.f;
          for (int e2 = 0; e2 < s; ++e2) acc = fmaf(tr[e2], tn[e2 * s], acc);
          val = -acc;
        }
        Pg[k * slot3 + 2 * ss + a * s + j] = val;
      }
    }
  }
  __syncthreads();

  // 5. gamma into v.r and lambda_0 into v.lam; the Gauss-Jordan area is
  // free again.
  const PcgVectors v = carve_vectors(smem, vec_len(K, s, c), red);
  for (int i = tid; i < n; i += nt) {
    const int k = i / s, a = i % s;
    const float* qi = Qinv + k * ss + a * s;
    const float* qk = q + k * s;
    float g = 0.f;
    for (int e2 = 0; e2 < s; ++e2) g = fmaf(qi[e2], qk[e2], g);
    float gam;
    if (k == 0) {
      gam = g - cv[i];
    } else {
      const float* ph = Sg + k * slot3 + a * s;
      const float* qp = q + (k - 1) * s;
      float t1 = 0.f;
      for (int e2 = 0; e2 < s; ++e2) t1 = fmaf(ph[e2], qp[e2], t1);
      const float* br = BR + (size_t)(k - 1) * sc + a * c;
      const float* rp = r + (k - 1) * c;
      float t2 = 0.f;
      for (int e2 = 0; e2 < c; ++e2) t2 = fmaf(br[e2], rp[e2], t2);
      gam = ((t1 + t2) + g) - cv[i];
    }
    v.r[i] = gam;
    v.lam[i] = lam0[i];
  }
  __syncthreads();

  // 6. PCG.
  const PcgOutcome res = pcg_block(Sg, Pg, K, s, v, exit_tol, max_iters,
                                   poly_degree, *bad != 0);

  // 7. Recovery: dz_x = Qinv (q - lam - A^T lam_next), dz_u = Rinv (r - B^T lam_next).
  float* rx = v.tmp;
  float* ru = v.ups;
  for (int i = tid; i < n; i += nt) {
    const int k = i / s, a = i % s;
    float at = 0.f;
    if (k < K - 1) {
      const float* Ak = A + k * ss + a;
      const float* ln = v.lam + (k + 1) * s;
      for (int e2 = 0; e2 < s; ++e2) at = fmaf(Ak[e2 * s], ln[e2], at);
    }
    rx[i] = (q[i] - v.lam[i]) - at;
  }
  for (int i = tid; i < (K - 1) * c; i += nt) {
    const int k = i / c, a = i % c;
    const float* Bk = Bm + k * sc + a;
    const float* ln = v.lam + (k + 1) * s;
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
    lam_out[i] = v.lam[i];
  }
  for (int i = tid; i < (K - 1) * c; i += nt) {
    const int k = i / c, a = i % c;
    const float* ri = Rinv + k * cc2 + a * c;
    const float* xu = ru + k * c;
    float acc = 0.f;
    for (int e2 = 0; e2 < c; ++e2) acc = fmaf(ri[e2], xu[e2], acc);
    dzu_out[i] = acc;
  }
  if (tid == 0) {
    *iters_out = res.iters;
    *conv_out = res.converged;
    *eta_out = res.eta;
  }
}

}  // namespace gato
