// The per-problem body of the fused whole solve: condense, preconditioner,
// PCG and recovery for one problem, run by one thread block.
//
// Kernel B (fused_solve.cu) runs it once per block; the sequence kernel
// (fused_sequence.cu) runs it T times per block, one step after another,
// each step warm-started from the previous step's multipliers.  Both
// compile this one body, so a step of the sequence computes exactly what
// kernel B computes for the same inputs, lambda_0 and rho.  A change here
// must leave both bit-identical to the parent's build: check it on the
// card with gato_tpu_torch/tools/bitcheck.py.
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
// Stages 1, 2 and 5 are the device functions of condense.cuh (gj_invert,
// condense_products, gamma_row, recover_dz), which the direct kernels
// (direct_fused.cu, thomas_batch.cu) call too.  The Gauss-Jordan runs on
// all knots at once, threads striding over the (matrix, row, column)
// entries of [M | I] held in shared memory, chunked when K matrices do not
// fit the 64 KB work area.  Every product is an explicit fmaf loop.
//
// Memory: S and Pinv (K, 3, s, s) cannot both stay in shared memory at
// IIWA (s=14, K=50): 117,600 B each, 235,200 B together, above the
// 232,448 B a block may use.  They are written to a per-problem global
// scratch slice, with Qinv, Rinv, B Rinv and a product temporary, and read
// back from L1/L2 in the loop; the shared memory holds the Gauss-Jordan
// work area and, after it, the PCG vectors (the same floats, reused).
#pragma once

#include <cuda_runtime.h>

#include "condense.cuh"

namespace gato {

enum Precond { kJacobi = 0, kBlockJacobi = 1, kStair = 2 };

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

  // 1-2. (Q_k + rho I)^{-1} and (R_k + rho I)^{-1} with the zero-pivot
  // flag; phi into S[k][0], theta into S[k][1], phi^T into S[k][2].
  gj_invert(Q, ss, Qinv, ss, K, s, rho, smem, arena_floats, bad);
  gj_invert(R, cc2, Rinv, cc2, K - 1, c, rho, smem, arena_floats, bad);
  condense_products<true>(A, Bm, Qinv, Rinv, Sg, Sg + ss, Sg + 2 * ss, slot3,
                          BR, K, s, c);

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
    v.r[i] = gamma_row(Qinv, Sg, slot3, BR, q, r, cv, s, c, i);
    v.lam[i] = lam0[i];
  }
  __syncthreads();

  // 6. PCG.
  const PcgOutcome res = pcg_block(Sg, Pg, K, s, v, exit_tol, max_iters,
                                   poly_degree, *bad != 0);

  // 7. Recovery: dz_x = Qinv (q - lam - A^T lam_next), dz_u = Rinv (r - B^T
  // lam_next), with lam_out.
  recover_dz(Qinv, Rinv, A, Bm, q, r, v.lam, v.tmp, v.ups, dzx_out, dzu_out, K,
             s, c, lam_out);
  if (tid == 0) {
    *iters_out = res.iters;
    *conv_out = res.converged;
    *eta_out = res.eta;
  }
}

}  // namespace gato
