// Rows 5 and 6: the exact solve as block-Thomas elimination, one forward
// and one reverse launch, batched.
//
// Replace gato_tpu/kernels/thomas_batch.py::_fwd_kernel (the pallas_call in
// _fwd_call) and ::_rev_kernel (in _rev_call); entry
// solve_direct_thomas_batched.  Plain versions and wrapper:
// gato_tpu_torch/kernels/thomas_batch.py.
//
// Forward (thomas_fwd_kernel), one thread block per problem:
//   1. Qinv and Rinv of every knot at once (gj_invert, count = K and K-1,
//      with one zero-pivot flag per block), then phi_j = A_{j-1} Qinv_{j-1},
//      theta_j and gamma_j of every knot at once, with the shared device
//      functions of condense.cuh: none of them depends on the elimination;
//   2. the walk j = 0..K-1, in a loop of the block's own (the TPU walks K
//      as a sequential grid axis; CUDA blocks run in no order):
//        M_j = phi_j Cinv_{j-1};  Dhat_j = theta_j - M_j phi_j^T;
//        bhat_j = gamma_j - M_j bhat_{j-1};  Cinv_j = Dhat_j^{-1}
//      one thread per entry of an s x s product, Cinv_{j-1} and bhat_{j-1}
//      carried in shared memory.  For s <= 16 warp 0 inverts Dhat_j in
//      registers (warp_gj_invert), with no barrier, instead of the
//      block-wide Gauss-Jordan with its two barriers a pivot (PERF.md has
//      the forward pass's time both ways).
//   It writes the stacks Cinv, bhat, Qinv, Rinv, phi, theta and gamma.  A
//   clamped zero pivot (in a block whose diagonal is not all zero) in Q_j,
//   R_{j-1} or Dhat_j adds +inf to bhat_j: the problem's lambda, dz and eta
//   turn non-finite and its converged False, and no other problem changes
//   (the TPU's contract, which differs from row 4's finite 1e30).
//
// Reverse (thomas_rev_kernel), one warp per problem, thread a on row a,
// walks j = K-1..0:
//   x_j = Cinv_j (bhat_j - phi_{j+1}^T x_{j+1}),
// fused with the dz recovery (dz_u_{j-1} completes at step j) and the
// squared true residual of the original system (row j+1 completes at step
// j, from the partial carried from step j+1), and ||gamma||^2.
//
// Not carried over from the TPU: the batch-in-lanes packing (plan_packing,
// _lane_budget), the shifted interval arrays and the group relabelling of
// _call_thomas.  The stacks are (B, K, ...) in the public layout.
//
// What bounds it on an H100: the walks are chains of dependent small steps
// (per knot of the forward: two s x s products and an s-pivot Gauss-Jordan,
// each barrier-separated), so one problem's time is latency; many blocks
// share an SM (224 threads forward, 32 reverse at IIWA) and a batch is
// bound by how many walks run at once.  The stacks (~172 KB a problem at
// IIWA) go through global memory once each way.
#include <cuda_runtime.h>

#include "condense.cuh"

namespace gato {

// Floats of global scratch one problem needs in the forward pass: B Rinv
// (K-1, s, c) and the per-knot zero-pivot flags of Q and R (2K ints).
inline long long thomas_scratch_floats(int K, int s, int c) {
  return (K - 1LL) * s * c + 2LL * K;
}

// Threads of a forward block: one per entry of an s x s product.
inline int thomas_fwd_threads(int s) { return threads_for(s * s); }

// The walk's one inversion a knot, for n <= 16, in the registers of one
// warp: lane l holds column l of [M | I] (2n <= 32 columns), the pivot
// column reaches every lane by shuffles, and no barrier is needed.  The
// same Gauss-Jordan as gj_invert (no pivoting, explicit division of the
// pivot row, a zero pivot divided by 1); returns 1 where gj_invert would
// set *bad.  src (n x n, row-major) is read, dst written, by warp 0 only.
constexpr int kWarpGjMax = 16;

__device__ int warp_gj_invert(const float* src, float* dst, int n) {
  const int lane = threadIdx.x & 31;
  float col[kWarpGjMax];
#pragma unroll
  for (int r = 0; r < kWarpGjMax; ++r)
    if (r < n) col[r] = lane < n ? src[r * n + lane] : (lane - n == r ? 1.f : 0.f);
  float d = 0.f;
#pragma unroll
  for (int r = 0; r < kWarpGjMax; ++r)
    if (r == lane && r < n) d = fabsf(col[r]);
  const float dabs = __shfl_sync(0xffffffffu, warp_sum(d), 0);
  int zero = 0;
#pragma unroll
  for (int i = 0; i < kWarpGjMax; ++i) {
    if (i < n) {
      const float piv = __shfl_sync(0xffffffffu, col[i], i);
      zero |= piv == 0.f;
      const float rv = col[i] / (piv != 0.f ? piv : 1.f);
#pragma unroll
      for (int r = 0; r < kWarpGjMax; ++r) {
        if (r < n && r != i) {
          const float f = __shfl_sync(0xffffffffu, col[r], i);
          col[r] = col[r] - f * rv;
        }
      }
      col[i] = rv;
    }
  }
#pragma unroll
  for (int r = 0; r < kWarpGjMax; ++r)
    if (r < n && lane >= n && lane < 2 * n) dst[r * n + lane - n] = col[r];
  return zero && dabs > 0.f;
}

__global__ void __launch_bounds__(kMaxThreads)
thomas_fwd_kernel(const float* Qg, const float* Rg, const float* Ag,
                  const float* Bg, const float* qg, const float* rg,
                  const float* cg, float* scratch, float* Cinv_out,
                  float* bhat_out, float* Qinv_out, float* Rinv_out,
                  float* phi_out, float* theta_out, float* gam_out, int K,
                  int s, int c, float rho, int arena_floats,
                  long long scratch_floats) {
  extern __shared__ float smem[];
  __shared__ int dbad;     // this knot's Dhat flag
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t b = blockIdx.x;
  const size_t ss = (size_t)s * s, sc = (size_t)s * c, cc2 = (size_t)c * c;
  const int n = K * s;
  const size_t nu = (size_t)(K - 1) * c;
  const float* Q = Qg + b * K * ss;
  const float* R = Rg + b * (K - 1) * cc2;
  const float* A = Ag + b * (K - 1) * ss;
  const float* Bm = Bg + b * (K - 1) * sc;
  const float* q = qg + b * n;
  const float* r = rg + b * nu;
  const float* cv = cg + b * n;
  float* Cinv = Cinv_out + b * K * ss;
  float* bhat = bhat_out + b * n;
  float* Qinv = Qinv_out + b * K * ss;
  float* Rinv = Rinv_out + b * (K - 1) * cc2;
  float* phi = phi_out + b * K * ss;
  float* theta = theta_out + b * K * ss;
  float* gam = gam_out + b * n;
  float* BR = scratch + b * scratch_floats;               // (K-1, s, c)
  int* qflag = reinterpret_cast<int*>(BR + (K - 1) * sc);  // (K,)
  int* rflag = qflag + K;                                  // (K-1,)
  float* arena = smem;
  float* Cp = smem + arena_floats;   // Cinv_{j-1}, then Cinv_j
  float* M = Cp + ss;
  float* Dh = M + ss;
  float* bp = Dh + ss;               // bhat_{j-1}
  float* bc = bp + s;                // bhat_j before the flag

  // 1. Every knot's inverses and condensed blocks.
  gj_invert(Q, ss, Qinv, ss, K, s, rho, arena, arena_floats, nullptr, qflag);
  gj_invert(R, cc2, Rinv, cc2, K - 1, c, rho, arena, arena_floats, nullptr,
            rflag);
  condense_products<false>(A, Bm, Qinv, Rinv, phi, theta, nullptr, ss, BR, K,
                           s, c);
  for (int i = tid; i < n; i += nt)
    gam[i] = gamma_row(Qinv, phi, ss, BR, q, r, cv, s, c, i);
  __syncthreads();

  // 2. The elimination walk.
  for (int j = 0; j < K; ++j) {
    const float* ph = phi + j * ss;
    const float* th = theta + j * ss;
    if (j == 0) {
      for (int e = tid; e < (int)ss; e += nt) Dh[e] = th[e];
      for (int a = tid; a < s; a += nt) bc[a] = gam[a];
    } else {
      for (int e = tid; e < (int)ss; e += nt) {
        const int a = e / s, col = e % s;
        float acc = 0.f;
        for (int e2 = 0; e2 < s; ++e2) acc = fmaf(ph[a * s + e2], Cp[e2 * s + col], acc);
        M[e] = acc;
      }
      __syncthreads();
      for (int e = tid; e < (int)ss; e += nt) {
        const int a = e / s, col = e % s;
        float acc = 0.f;
        for (int e2 = 0; e2 < s; ++e2) acc = fmaf(M[a * s + e2], ph[col * s + e2], acc);
        Dh[e] = th[e] - acc;
      }
      for (int a = tid; a < s; a += nt) {
        float acc = 0.f;
        for (int e2 = 0; e2 < s; ++e2) acc = fmaf(M[a * s + e2], bp[e2], acc);
        bc[a] = gam[j * s + a] - acc;
      }
    }
    if (tid == 0) dbad = 0;
    __syncthreads();
    if (s <= kWarpGjMax) {
      if (tid < 32) {
        const int hit = warp_gj_invert(Dh, Cp, s);
        if (tid == 0) dbad = hit;
      }
      __syncthreads();
    } else {
      gj_invert(Dh, 0, Cp, 0, 1, s, 0.f, arena, arena_floats, &dbad);
    }
    const bool poison = qflag[j] != 0 || (j > 0 && rflag[j - 1] != 0) || dbad != 0;
    for (int e = tid; e < (int)ss; e += nt) Cinv[j * ss + e] = Cp[e];
    for (int a = tid; a < s; a += nt) {
      const float v = bc[a] + (poison ? __int_as_float(0x7f800000) : 0.f);
      bhat[j * s + a] = v;
      bp[a] = v;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(32)
thomas_rev_kernel(const float* Cinv_g, const float* bhat_g, const float* Qinv_g,
                  const float* Rinv_g, const float* phi_g, const float* theta_g,
                  const float* gam_g, const float* qg, const float* Ag,
                  const float* Bg, const float* rg, float* lam_out,
                  float* dzx_out, float* dzu_out, int* conv_out,
                  float* eta_out, int K, int s, int c) {
  __shared__ float x[32], xn[32], ut[32], rhs[32], ru[32];
  const int a = threadIdx.x;
  const size_t b = blockIdx.x;
  const size_t ss = (size_t)s * s, sc = (size_t)s * c, cc2 = (size_t)c * c;
  const int n = K * s;
  const size_t nu = (size_t)(K - 1) * c;
  const float* Cinv = Cinv_g + b * K * ss;
  const float* bhat = bhat_g + b * n;
  const float* Qinv = Qinv_g + b * K * ss;
  const float* Rinv = Rinv_g + b * (K - 1) * cc2;
  const float* phi = phi_g + b * K * ss;
  const float* theta = theta_g + b * K * ss;
  const float* gam = gam_g + b * n;
  const float* q = qg + b * n;
  const float* A = Ag + b * (K - 1) * ss;
  const float* Bm = Bg + b * (K - 1) * sc;
  const float* r = rg + b * nu;
  float* lam = lam_out + b * n;
  float* dzx = dzx_out + b * n;
  float* dzu = dzu_out + b * nu;
  const bool row = a < s;
  float part = 0.f;     // row a of step j+1's partial residual
  float atl = 0.f;      // (A_j^T x_{j+1})[a]
  float eta = 0.f, gnorm = 0.f;
  if (row) xn[a] = 0.f;
  __syncwarp();
  for (int j = K - 1; j >= 0; --j) {
    const bool last = j == K - 1;
    const float* phn = phi + (j + 1) * ss;   // phi_{j+1}, read when j < K-1
    // u = phi_{j+1}^T x_{j+1}; rhs = bhat_j - u.
    float u = 0.f;
    if (row && !last)
      for (int e2 = 0; e2 < s; ++e2) u = fmaf(phn[e2 * s + a], xn[e2], u);
    if (row) {
      ut[a] = u;
      rhs[a] = bhat[j * s + a] - u;
    }
    __syncwarp();
    float xa = 0.f;
    if (row) {
      const float* ci = Cinv + j * ss + a * s;
      for (int e2 = 0; e2 < s; ++e2) xa = fmaf(ci[e2], rhs[e2], xa);
      x[a] = xa;
      lam[j * s + a] = xa;
    }
    __syncwarp();
    // The true residual: row j+1 completes with phi_{j+1} x_j; row j's
    // partial is gamma_j - theta_j x_j - u.
    float res = 0.f, pj = 0.f, g = 0.f;
    if (row) {
      if (!last) {
        const float* pr = phn + a * s;
        float acc = 0.f;
        for (int e2 = 0; e2 < s; ++e2) acc = fmaf(pr[e2], x[e2], acc);
        res = part - acc;
      }
      const float* tr = theta + j * ss + a * s;
      float acc = 0.f;
      for (int e2 = 0; e2 < s; ++e2) acc = fmaf(tr[e2], x[e2], acc);
      g = gam[j * s + a];
      pj = (g - acc) - ut[a];
    }
    eta += warp_sum(res * res);
    if (j == 0) eta += warp_sum(pj * pj);
    gnorm += warp_sum(g * g);
    part = pj;
    // Recovery: dz_x_j = Qinv_j (q_j - x_j - A_j^T x_{j+1});
    // dz_u_{j-1} = Rinv_{j-1} (r_{j-1} - B_{j-1}^T x_j).
    if (row) rhs[a] = (q[j * s + a] - xa) - atl;
    if (j > 0 && a < c) {
      const float* Bk = Bm + (j - 1) * sc + a;
      float bt = 0.f;
      for (int e2 = 0; e2 < s; ++e2) bt = fmaf(Bk[e2 * c], x[e2], bt);
      ru[a] = r[(j - 1) * c + a] - bt;
    }
    __syncwarp();
    if (row) {
      const float* qi = Qinv + j * ss + a * s;
      float acc = 0.f;
      for (int e2 = 0; e2 < s; ++e2) acc = fmaf(qi[e2], rhs[e2], acc);
      dzx[j * s + a] = acc;
      atl = 0.f;
      if (j > 0) {
        const float* Ak = A + (j - 1) * ss + a;
        for (int e2 = 0; e2 < s; ++e2) atl = fmaf(Ak[e2 * s], x[e2], atl);
      }
    }
    if (j > 0 && a < c) {
      const float* ri = Rinv + (j - 1) * cc2 + a * c;
      float acc = 0.f;
      for (int e2 = 0; e2 < c; ++e2) acc = fmaf(ri[e2], ru[e2], acc);
      dzu[(j - 1) * c + a] = acc;
    }
    if (row) xn[a] = xa;
    __syncwarp();
  }
  if (a == 0) {
    eta_out[b] = eta;
    conv_out[b] = eta <= kDirectRtolSq * (1.f + gnorm) ? 1 : 0;
  }
}

}  // namespace gato

extern "C" {

long long gato_thomas_scratch_floats(int K, int s, int c) {
  return gato::thomas_scratch_floats(K, s, c);
}

// Dynamic shared memory of one forward block, in bytes: the Gauss-Jordan
// work area, three s x s blocks and two s-vectors.
long long gato_thomas_smem_bytes(int K, int s, int c) {
  return (gato::gj_arena_floats(K, s, c) + 3LL * s * s + 2LL * s) *
         (long long)sizeof(float);
}

// Launches row 5 on `stream` for B problems.  `scratch` holds
// B * gato_thomas_scratch_floats(K, s, c) floats; the seven outputs are the
// (B, K, ...) factor stacks (Rinv (B, K-1, c, c)).  Returns the CUDA error
// code of the launch (0 on success); nothing is synchronised.
int gato_thomas_fwd(const float* Q, const float* R, const float* A,
                    const float* Bm, const float* q, const float* r,
                    const float* c, float* scratch, float* Cinv, float* bhat,
                    float* Qinv, float* Rinv, float* phi, float* theta,
                    float* gam, int B, int K, int s, int cdim, float rho,
                    void* stream) {
  const size_t smem = (size_t)gato_thomas_smem_bytes(K, s, cdim);
  cudaError_t err = cudaFuncSetAttribute(
      gato::thomas_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gato::thomas_fwd_kernel<<<B, gato::thomas_fwd_threads(s), smem,
                            (cudaStream_t)stream>>>(
      Q, R, A, Bm, q, r, c, scratch, Cinv, bhat, Qinv, Rinv, phi, theta, gam, K,
      s, cdim, rho, (int)gato::gj_arena_floats(K, s, cdim),
      gato::thomas_scratch_floats(K, s, cdim));
  return (int)cudaGetLastError();
}

// Launches row 6 on `stream` for B problems, on the stacks of
// gato_thomas_fwd.  Returns the CUDA error code of the launch.
int gato_thomas_rev(const float* Cinv, const float* bhat, const float* Qinv,
                    const float* Rinv, const float* phi, const float* theta,
                    const float* gam, const float* q, const float* A,
                    const float* Bm, const float* r, float* lam, float* dzx,
                    float* dzu, int* conv, float* eta, int B, int K, int s,
                    int cdim, void* stream) {
  gato::thomas_rev_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
      Cinv, bhat, Qinv, Rinv, phi, theta, gam, q, A, Bm, r, lam, dzx, dzu,
      conv, eta, K, s, cdim);
  return (int)cudaGetLastError();
}

}  // extern "C"
