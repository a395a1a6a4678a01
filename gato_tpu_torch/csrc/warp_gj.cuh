// One warp's Gauss-Jordan inverse of one small block, shared by row 11's
// cyclic reduction (longk_direct.cu) and row 4's (direct_fused.cu).
#pragma once

#include <cuda_runtime.h>

namespace gato {

// The block widths of warp_gj_pad's users: kN = 14 compiles IIWA's width
// in (n = 14, no predicates); other kN take any n up to kN.
template <int kN>
__device__ __forceinline__ int width(int n) {
  return kN == 14 ? 14 : n;
}

// src (n x n) inverted into dst on one warp, src may equal dst.
// The Gauss-Jordan of warp_gj (no pivoting, the pivot row scaled, a zero
// pivot taken as 1) on [M | I] padded to kN x kN with the identity, so that
// every loop runs kN steps with no predicate on n: column J of the padded
// [M | I] sits in lane J % 32, slot J / 32, the pivot column i in lane i.
// The pivot row is scaled by the correctly rounded reciprocal (where
// warp_gj divides): the division and the predicates on n were most of
// warp_gj's time on an H100 (gato_tpu_torch/tools/gj_bench.cu).  Returns 1 on every lane
// where a zero pivot was clamped in a block whose diagonal is not all zero.
template <int kN>
__device__ int warp_gj_pad(const float* src, float* dst, int n_rt) {
  constexpr int kC = (2 * kN + 31) / 32;
  constexpr unsigned kAll = 0xffffffffu;
  const int n = width<kN>(n_rt);
  const int lane = threadIdx.x & 31;
  float col[kC][kN];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int J = c * 32 + lane;
#pragma unroll
    for (int r = 0; r < kN; ++r) {
      if (J < kN)
        col[c][r] = r < n && J < n ? src[r * n + J] : (r == J ? 1.f : 0.f);
      else
        col[c][r] = J - kN == r ? 1.f : 0.f;
    }
  }
  float d = 0.f;
#pragma unroll
  for (int r = 0; r < kN; ++r)
    if (r == lane && r < n) d = col[0][r];
  const bool live = __any_sync(kAll, d != 0.f);
  int zero = 0;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const float piv = __shfl_sync(kAll, col[0][i], i);
    zero |= piv == 0.f;
    const float inv = __frcp_rn(piv != 0.f ? piv : 1.f);
    float rv[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) rv[c] = col[c][i] * inv;
#pragma unroll
    for (int r = 0; r < kN; ++r) {
      if (r != i) {
        const float f = __shfl_sync(kAll, col[0][r], i);
#pragma unroll
        for (int c = 0; c < kC; ++c) col[c][r] = fmaf(-f, rv[c], col[c][r]);
      }
    }
#pragma unroll
    for (int c = 0; c < kC; ++c) col[c][i] = rv[c];
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int J = c * 32 + lane - kN;
#pragma unroll
    for (int r = 0; r < kN; ++r)
      if (r < n && J >= 0 && J < n) dst[r * n + J] = col[c][r];
  }
  return zero && live;
}

}  // namespace gato
