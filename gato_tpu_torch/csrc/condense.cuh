// Device code that the exact kernels and the long-K recovery share: the
// convergence constant of an exact solve (the block-Thomas reverse pass,
// thomas_batch.cu, row 6) and warp_recover_dz, one knot's dz_x and dz_u
// from the multipliers on one warp (recover.recover_dz; row 6's epilogue
// and the long-K recovery, longk.cu, row 13).  Kernel B, the farm kernel
// and row 4 recover on a cluster (cluster_body.cuh).
//
// Every product is an explicit fmaf loop in a fixed order.  A change here
// is checked by the card tests of rows 6 and 13 and by
// tools/bitcheck.py's groups row6 and row13.
#pragma once

#include <cuda_runtime.h>

#include "pcg_common.cuh"

namespace gato {

// DIRECT_CONV_RTOL^2 of direct.residual_converged: an exact solve converged
// when eta <= kDirectRtolSq * (1 + ||gamma||^2).
constexpr float kDirectRtolSq = 1e-6f;

// v[0..n) = src[0..n) (v has kN entries), 16 bytes a load: src is
// 16-byte aligned and round4(n) floats may be read.
template <int kN>
__device__ __forceinline__ void load4(float* v, const float* src, int n) {
#pragma unroll
  for (int e = 0; e < kN; e += 4) {
    if (e < n) {
      const float4 t = *reinterpret_cast<const float4*>(src + e);
      v[e] = t.x;
      if (e + 1 < kN) v[e + 1] = t.y;
      if (e + 2 < kN) v[e + 2] = t.z;
      if (e + 3 < kN) v[e + 3] = t.w;
    }
  }
}

// One knot's dz on one warp, from the knot's window in shared memory:
//   rx   = (q - x) - A^T x_next,  dz_x = Qinv rx   (lane a on row a < n)
//   ru   = r - B^T x_next,        dz_u = Rinv ru   (lanes a < c)
// recover.recover_dz's algebra; the last knot (`right` false) has no A^T
// term and no dz_u.  A (n x n) and B (n x c) are row-major as stored (a
// lane reads a column), Qinv's rows sit at stride ldq and Rinv's at ldr
// (padded strides against bank conflicts where the caller pads); rx and ru
// are the warp's temporaries, x_next and rx 16-byte aligned with round4(n)
// floats readable.  Each product is an fmaf chain from 0.f in
// column order: the order of the block-level loops that rows 6 and 13 ran
// before they took a warp a knot, so their bits stay.  kN is n compiled in
// (14) or its bound (16, 32).  Writes dzx[0..n) and, where `right`,
// dzu[0..c); ends with no barrier.
template <int kN>
__device__ __forceinline__ void warp_recover_dz(
    const float* Qinv, int ldq, const float* Rinv, int ldr, const float* A,
    const float* Bm, const float* q, const float* x, const float* x_next,
    const float* r, float* rx, float* ru, int n, int c, bool right,
    float* dzx, float* dzu) {
  const int lane = threadIdx.x & 31;
  // x_next and rx in registers, four floats a load (their areas are 16-byte
  // aligned and hold round4(n) floats).
  float xv[kN];
  if (right) load4<kN>(xv, x_next, n);
  if (lane < n) {
    float at = 0.f;
    if (right) {
#pragma unroll
      for (int e = 0; e < kN; ++e)
        if (e < n) at = fmaf(A[e * n + lane], xv[e], at);
    }
    rx[lane] = (q[lane] - x[lane]) - at;
  }
  if (right && lane < c) {
    float bt = 0.f;
#pragma unroll
    for (int e = 0; e < kN; ++e)
      if (e < n) bt = fmaf(Bm[e * c + lane], xv[e], bt);
    ru[lane] = r[lane] - bt;
  }
  __syncwarp();
  if (lane < n) {
    load4<kN>(xv, rx, n);
    const float* qrow = Qinv + lane * ldq;
    float acc = 0.f;
    if (kN == 14 && ldq == 14) {
      // IIWA's rows (56 bytes, 8-byte aligned) two floats a load.
#pragma unroll
      for (int e = 0; e < 14; e += 2) {
        const float2 m = *reinterpret_cast<const float2*>(qrow + e);
        acc = fmaf(m.x, xv[e], acc);
        acc = fmaf(m.y, xv[e + 1], acc);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kN; ++e)
        if (e < n) acc = fmaf(qrow[e], xv[e], acc);
    }
    dzx[lane] = acc;
  }
  if (right && lane < c) {
    float acc = 0.f;
    for (int e = 0; e < c; ++e) acc = fmaf(Rinv[lane * ldr + e], ru[e], acc);
    dzu[lane] = acc;
  }
}

}  // namespace gato
