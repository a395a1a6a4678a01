// Device code that the one-block exact kernels kept from the condensation
// of the first exact kernel: the convergence constant of an exact solve
// (the block-Thomas reverse pass, thomas_batch.cu, row 6) and recover_dz,
// dz_x and dz_u from the multipliers (recover.recover_dz; the long-K
// recovery, longk.cu, row 13).  Kernel B, the farm kernel and row 4
// condense on a cluster (cluster_body.cuh), the long-K tiles (rows 7 and
// 9) and row 5 in condense_tile.cuh's tiles.
//
// Every product is an explicit fmaf loop in a fixed order.  A change here
// is checked by the card tests of rows 6 and 13.
#pragma once

#include <cuda_runtime.h>

#include "pcg_common.cuh"

namespace gato {

// DIRECT_CONV_RTOL^2 of direct.residual_converged: an exact solve converged
// when eta <= kDirectRtolSq * (1 + ||gamma||^2).
constexpr float kDirectRtolSq = 1e-6f;

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
