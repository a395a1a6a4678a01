// Row 4: the whole exact solve (condensation, block cyclic reduction,
// recovery and the true residual) in one launch, batched.
//
// Replaces gato_tpu/kernels/direct_fused.py::_direct_kernel (the pallas_call
// in _call_direct, entry solve_direct_fused_batched) with its _cr_solve.
// Plain version and wrapper: gato_tpu_torch/kernels/direct_fused.py.
//
// Per problem, one thread block:
//   1. condenses with the shared device functions of condense.cuh: Q and R
//      inverses with the zero-pivot flag, S = btd(phi, theta, phi^T) into a
//      global scratch slice, gamma;
//   2. solves S lambda = gamma by block cyclic reduction, the recurrences of
//      direct.btd_solve_cr on a copy W of S (L, D, U per row, in place):
//      level l eliminates the rows k = h mod 2h (h = 2^l) of the surviving
//      rows k = 0 mod h.  All odd rows of a level are inverted at once
//      (gj_invert with count = rows of the level, each inverse stored in
//      that row's D slot, which the row never needs again), then threads
//      stride over the even rows' products: A = L_e D_{k-h}^{-1},
//      B = U_e D_{k+h}^{-1} into two temporaries, then L', U', D' and b' in
//      place.  A neighbour past either end is zero.  The root row 0 is
//      inverted last; back-substitution runs level by level;
//   3. eta = ||gamma - S lambda||^2 against the original S, ||gamma||^2,
//      converged = eta <= 1e-6 (1 + ||gamma||^2) (direct.residual_converged);
//   4. recovers dz_x, dz_u.
// A problem in which a used inversion (Q, R, a level's odd rows or the
// root) clamped a zero pivot in a block whose diagonal is not all zero gets
// eta += 1e30 (finite, as on the TPU) and so converged = False; its lambda
// and dz stay finite.  Only the used inversions flag.
//
// Not carried over from the TPU: the knots-in-lanes packing with its
// K_sub = round_up(K, 8) pad lanes, the masked blends and the lane rolls.
// Rows are indexed by stride here and every even row does real work.
//
// What bounds it on an H100: the operators (S and its copy, ~235 KB at
// IIWA) live in a per-problem global scratch slice read back from L1/L2;
// each level is a chain of barriers (a Gauss-Jordan of s pivot steps, then
// two product phases), ceil(log2 K) levels and as many back-substitution
// steps, on one SM per problem.  At B = 1 that chain of dependent steps
// sets the time; at large B, 2 blocks share an SM (704 threads each at
// IIWA) and the operations of the Gauss-Jordan and products do.
#include <cuda_runtime.h>

#include "condense.cuh"

namespace gato {

// Floats of global scratch one problem needs: S and its working copy W
// (K, 3, s, s), Qinv (K, s, s), Rinv (K-1, c, c), B Rinv (K-1, s, c) and two
// (K, s, s) product temporaries.
inline long long direct_scratch_floats(int K, int s, int c) {
  const long long ss = (long long)s * s;
  return 2LL * K * 3 * ss + K * ss + (K - 1LL) * c * c + (K - 1LL) * s * c +
         2LL * K * ss;
}

__global__ void __launch_bounds__(kMaxThreads)
direct_fused_kernel(const float* Qg, const float* Rg, const float* Ag,
                    const float* Bg, const float* qg, const float* rg,
                    const float* cg, float* scratch, float* lam_out,
                    float* dzx_out, float* dzu_out, int* conv_out,
                    float* eta_out, int K, int s, int c, float rho,
                    int arena_floats, long long scratch_floats) {
  extern __shared__ float smem[];
  __shared__ float red[33];
  __shared__ int bad;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t b = blockIdx.x;
  const size_t ss = (size_t)s * s, sc = (size_t)s * c, cc2 = (size_t)c * c;
  const size_t slot3 = 3 * ss;
  const int n = K * s;
  const size_t nu = (size_t)(K - 1) * c;
  const float* Q = Qg + b * K * ss;
  const float* R = Rg + b * (K - 1) * cc2;
  const float* A = Ag + b * (K - 1) * ss;
  const float* Bm = Bg + b * (K - 1) * sc;
  const float* q = qg + b * n;
  const float* r = rg + b * nu;
  const float* cv = cg + b * n;
  float* Sg = scratch + b * scratch_floats;   // (K, 3, s, s), kept
  float* W = Sg + K * slot3;                  // (K, 3, s, s), reduced
  float* Qinv = W + K * slot3;                // (K, s, s)
  float* Rinv = Qinv + K * ss;                // (K-1, c, c)
  float* BR = Rinv + (K - 1) * cc2;           // (K-1, s, c)
  float* TA = BR + (K - 1) * sc;              // (K, s, s)
  float* TB = TA + K * ss;                    // (K, s, s)
  const int len = vec_len(K, s, c);
  float* arena = smem;
  float* gam = smem + arena_floats;           // gamma, kept
  float* bv = gam + len;                      // right-hand side, reduced
  float* x = bv + len;                        // lambda
  float* tmp = x + len;
  if (tid == 0) bad = 0;
  __syncthreads();

  // 1. Condensation.
  gj_invert(Q, ss, Qinv, ss, K, s, rho, arena, arena_floats, &bad);
  gj_invert(R, cc2, Rinv, cc2, K - 1, c, rho, arena, arena_floats, &bad);
  condense_products<true>(A, Bm, Qinv, Rinv, Sg, Sg + ss, Sg + 2 * ss, slot3,
                          BR, K, s, c);
  for (int i = tid; i < n; i += nt) {
    const float g = gamma_row(Qinv, Sg, slot3, BR, q, r, cv, s, c, i);
    gam[i] = g;
    bv[i] = g;
  }
  for (size_t e = tid; e < K * slot3; e += nt) W[e] = Sg[e];
  __syncthreads();

  // 2. Block cyclic reduction.  Row k's L, D, U are W[k][0..2].
  int h = 1;
  for (; h < K; h *= 2) {
    const int h2 = 2 * h;
    const int n_odd = (K - 1 - h) / h2 + 1;   // rows h, 3h, ... < K
    const int n_even = (K - 1) / h2 + 1;      // rows 0, 2h, ... < K
    gj_invert(W + h * slot3 + ss, h2 * slot3, W + h * slot3 + ss, h2 * slot3,
              n_odd, s, 0.f, arena, arena_floats, &bad);
    for (size_t e = tid; e < n_even * ss; e += nt) {
      const size_t t = e / ss;
      const int a = (e % ss) / s, j = e % s;
      const size_t i = t * h2;
      float acc_a = 0.f, acc_b = 0.f;
      if (i >= (size_t)h) {
        const float* Le = W + i * slot3 + a * s;
        const float* Dl = W + (i - h) * slot3 + ss + j;
        for (int e2 = 0; e2 < s; ++e2) acc_a = fmaf(Le[e2], Dl[e2 * s], acc_a);
      }
      if (i + h < (size_t)K) {
        const float* Ue = W + i * slot3 + 2 * ss + a * s;
        const float* Dr = W + (i + h) * slot3 + ss + j;
        for (int e2 = 0; e2 < s; ++e2) acc_b = fmaf(Ue[e2], Dr[e2 * s], acc_b);
      }
      TA[t * ss + a * s + j] = acc_a;
      TB[t * ss + a * s + j] = acc_b;
    }
    __syncthreads();
    // L' = -A L_left, U' = -B U_right, D' = D - A U_left - B L_right,
    // b' = b - A b_left - B b_right.  Threads read only odd rows, the
    // temporaries and the entry they write.
    for (size_t e = tid; e < n_even * ss; e += nt) {
      const size_t t = e / ss;
      const int a = (e % ss) / s, j = e % s;
      const size_t i = t * h2;
      const float* ta = TA + t * ss + a * s;
      const float* tb = TB + t * ss + a * s;
      float l = 0.f, u = 0.f, au = 0.f, bl = 0.f;
      if (i >= (size_t)h) {
        const float* Lo = W + (i - h) * slot3 + j;
        const float* Uo = Lo + 2 * ss;
        for (int e2 = 0; e2 < s; ++e2) {
          l = fmaf(ta[e2], Lo[e2 * s], l);
          au = fmaf(ta[e2], Uo[e2 * s], au);
        }
      }
      if (i + h < (size_t)K) {
        const float* Lo = W + (i + h) * slot3 + j;
        const float* Uo = Lo + 2 * ss;
        for (int e2 = 0; e2 < s; ++e2) {
          u = fmaf(tb[e2], Uo[e2 * s], u);
          bl = fmaf(tb[e2], Lo[e2 * s], bl);
        }
      }
      float* row = W + i * slot3 + a * s + j;
      row[0] = -l;
      row[ss] = (row[ss] - au) - bl;
      row[2 * ss] = -u;
    }
    for (int e = tid; e < n_even * s; e += nt) {
      const int t = e / s, a = e % s;
      const int i = t * h2;
      const float* ta = TA + t * ss + a * s;
      const float* tb = TB + t * ss + a * s;
      float ab = 0.f, bb = 0.f;
      if (i >= h)
        for (int e2 = 0; e2 < s; ++e2) ab = fmaf(ta[e2], bv[(i - h) * s + e2], ab);
      if (i + h < K)
        for (int e2 = 0; e2 < s; ++e2) bb = fmaf(tb[e2], bv[(i + h) * s + e2], bb);
      bv[i * s + a] = (bv[i * s + a] - ab) - bb;
    }
    __syncthreads();
  }

  // The root: row 0 alone.
  gj_invert(W + ss, 0, W + ss, 0, 1, s, 0.f, arena, arena_floats, &bad);
  for (int a = tid; a < s; a += nt) {
    const float* di = W + ss + a * s;
    float acc = 0.f;
    for (int e2 = 0; e2 < s; ++e2) acc = fmaf(di[e2], bv[e2], acc);
    x[a] = acc;
  }
  __syncthreads();

  // Back-substitution, level by level: x_k = D_k^{-1} (b_k - L_k x_{k-h}
  // - U_k x_{k+h}) for the odd rows of each level, x_{k+h} zero past the end.
  for (h /= 2; h >= 1; h /= 2) {
    const int h2 = 2 * h;
    const int n_odd = (K - 1 - h) / h2 + 1;
    for (int e = tid; e < n_odd * s; e += nt) {
      const int k = h + (e / s) * h2, a = e % s;
      const float* Lk = W + (size_t)k * slot3 + a * s;
      const float* xl = x + (k - h) * s;
      float lx = 0.f, ux = 0.f;
      for (int e2 = 0; e2 < s; ++e2) lx = fmaf(Lk[e2], xl[e2], lx);
      if (k + h < K) {
        const float* Uk = Lk + 2 * ss;
        const float* xr = x + (k + h) * s;
        for (int e2 = 0; e2 < s; ++e2) ux = fmaf(Uk[e2], xr[e2], ux);
      }
      tmp[k * s + a] = (bv[k * s + a] - lx) - ux;
    }
    __syncthreads();
    for (int e = tid; e < n_odd * s; e += nt) {
      const int k = h + (e / s) * h2, a = e % s;
      const float* di = W + (size_t)k * slot3 + ss + a * s;
      const float* rk = tmp + k * s;
      float acc = 0.f;
      for (int e2 = 0; e2 < s; ++e2) acc = fmaf(di[e2], rk[e2], acc);
      x[k * s + a] = acc;
    }
    __syncthreads();
  }

  // 3. The true residual against the original S, and ||gamma||^2.
  float part = 0.f, gpart = 0.f;
  for (int i = tid; i < n; i += nt) {
    const float res = gam[i] - btd_row(Sg, x, K, s, i / s, i % s);
    part = fmaf(res, res, part);
    gpart = fmaf(gam[i], gam[i], gpart);
  }
  float eta = block_sum(part, red);
  const float gnorm = block_sum(gpart, red);
  if (bad != 0) eta += kFrozenEta;

  // 4. Recovery (bv is free again: it holds the control temporary).
  recover_dz(Qinv, Rinv, A, Bm, q, r, x, tmp, bv, dzx_out + b * n,
             dzu_out + b * nu, K, s, c);
  for (int i = tid; i < n; i += nt) lam_out[b * n + i] = x[i];
  if (tid == 0) {
    eta_out[b] = eta;
    conv_out[b] = eta <= kDirectRtolSq * (1.f + gnorm) ? 1 : 0;
  }
}

}  // namespace gato

extern "C" {

long long gato_direct_scratch_floats(int K, int s, int c) {
  return gato::direct_scratch_floats(K, s, c);
}

// Dynamic shared memory of one direct_fused_kernel block, in bytes: the
// Gauss-Jordan work area and four vectors.
long long gato_direct_smem_bytes(int K, int s, int c) {
  return (gato::gj_arena_floats(K, s, c) + 4LL * gato::vec_len(K, s, c)) *
         (long long)sizeof(float);
}

// Launches row 4 on `stream` for B problems.  `scratch` holds
// B * gato_direct_scratch_floats(K, s, c) floats.  Returns the CUDA error
// code of the launch (0 on success); nothing is synchronised.
int gato_direct_fused(const float* Q, const float* R, const float* A,
                      const float* Bm, const float* q, const float* r,
                      const float* c, float* scratch, float* lam, float* dzx,
                      float* dzu, int* conv, float* eta, int B, int K, int s,
                      int cdim, float rho, void* stream) {
  const size_t smem = (size_t)gato_direct_smem_bytes(K, s, cdim);
  cudaError_t err = cudaFuncSetAttribute(
      gato::direct_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = gato::threads_for(gato::vec_len(K, s, cdim));
  gato::direct_fused_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      Q, R, A, Bm, q, r, c, scratch, lam, dzx, dzu, conv, eta, K, s, cdim, rho,
      (int)gato::gj_arena_floats(K, s, cdim),
      gato::direct_scratch_floats(K, s, cdim));
  return (int)cudaGetLastError();
}

}  // extern "C"
