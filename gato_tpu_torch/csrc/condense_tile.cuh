// Row 7's condensation tile, shared by the long-K tier (longk.cu: rows 7
// and 9) and the block-Thomas forward pass (thomas_batch.cu: row 5), and
// the plan of its shared memory (kernels/longk.py mirrors tile_plan,
// tile_threads and chooses the tile's knots with tile_knots).
//
// A CTA condenses the own knots [k0, k1) of one tile of one problem.  CUDA
// blocks run in no order, so a tile recomputes, in its own shared memory,
// the neighbour knots it needs: a window of two knots to the left
// (theta_{k0-1} needs phi_{k0-1} = A_{k0-2} Qinv_{k0-2}) and one to the
// right (theta_{k1} for the stair).  A recomputed knot goes through the
// same arithmetic as in the tile that owns it, so it has the same bits and
// the outputs do not depend on the tile size.  Stages (kernel B's design,
// cluster_body.cuh): Gauss-Jordan of the window's Q and R blocks in shared
// memory (gauss_jordan.cuh: two phases a pivot, loads ahead of stores, a
// thread a (matrix, row)); the products, a thread a (knot, row) holding
// phi_k, B_{k-1} Rinv_{k-1} and theta_k's row in registers, which also
// writes S, gamma and the scalar Jacobi Pinv; Gauss-Jordan of theta; the
// stair's two off-diagonal blocks a thread a (knot, row), with no barrier.
// Every stage is inlined (no context struct in local memory).
//
// The Thomas instantiation (kThomas) stops after the products, computes
// them for its own knots alone, and writes what block Thomas reads: phi_k
// (zero at k = 0) and theta_k as separate stacks, gamma, Qinv, Rinv, and a
// per-knot flag (a clamped zero pivot in Q_k or R_{k-1}) instead of the
// problem's one.
#pragma once

#include <cuda_runtime.h>

#include "gauss_jordan.cuh"
#include "grid_common.cuh"

namespace gato {

enum LongkPrecond { kLkJacobi = 0, kLkBlockJacobi = 1, kLkStair = 2 };

inline __host__ __device__ long long round4(long long f) { return (f + 3) & ~3LL; }

// Shared-memory layout of a condensation tile of nk own knots, in floats:
// a window of nw = nk + 3 knots (two left of the tile, one right).
struct TilePlan {
  int nk;
  long long qinv, rinv, ops, thinv, gj, total;
};

inline __host__ __device__ TilePlan tile_plan(int nk, int s, int c) {
  TilePlan L;
  L.nk = nk;
  const int nw = nk + 3, nt = kGridThreads;
  const long long ss = (long long)s * s;
  L.qinv = 0;                                        // (nw, s, s) Qinv
  L.rinv = L.qinv + round4(nw * ss);                 // (nw-1, c, c) Rinv
  L.ops = L.rinv + round4((nw - 1LL) * c * c);       // (nw, 3, s, s) phi, theta, phi^T
  L.thinv = L.ops + round4(3LL * nw * ss);           // (nw, s, s) theta^{-1}
  L.gj = L.thinv + round4(nw * ss);                  // Gauss-Jordan rounds
  const long long gq = gj_round_floats(nt / s < nw ? nt / s : nw, s);
  const long long gr = gj_round_floats(nt / c < nw - 1 ? nt / c : nw - 1, c);
  L.total = L.gj + (gq > gr ? gq : gr);
  return L;
}

// Threads of a row 7 CTA: a row of the window's Gauss-Jordan batch each,
// whole warps, from 64 to kGridThreads (row 9 runs its tiles on the PCG
// loop's kGridThreads).
inline __host__ __device__ int tile_threads(int nk, int s, int c) {
  const int w = s > c ? s : c;
  const int t = ((nk + 3) * w + 31) / 32 * 32;
  return t < 64 ? 64 : (t > kGridThreads ? kGridThreads : t);
}

namespace lk {

// Dot of p[0..n) and q[0..n), in order.
template <int kN>
__device__ __forceinline__ float dot(const float* p, const float* q, int n) {
  float acc = 0.f;
  if (kN > 0) {
#pragma unroll
    for (int e = 0; e < kN; ++e) acc = fmaf(p[e], q[e], acc);
  } else {
    for (int e = 0; e < n; ++e) acc = fmaf(p[e], q[e], acc);
  }
  return acc;
}

// Dot of a[0..n) with column j of the row-major n-wide matrix M, in order.
template <int kN>
__device__ __forceinline__ float dot_col(const float* a, const float* M, int j, int n) {
  float acc = 0.f;
  if (kN > 0) {
#pragma unroll
    for (int e = 0; e < kN; ++e) acc = fmaf(a[e], M[e * kN + j], acc);
  } else {
    for (int e = 0; e < n; ++e) acc = fmaf(a[e], M[e * n + j], acc);
  }
  return acc;
}

}  // namespace lk

// The KKT blocks of a batch (formats.KKTBlocks with a leading batch axis).
struct KktArrays {
  const float* Q;
  const float* R;
  const float* A;
  const float* Bm;
  const float* q;
  const float* r;
  const float* cv;
  int K, s, c;
  float rho;
  int precond;
};

// What the condensation writes: S, P (B, K, 3, s, s), gamma (B, K, s), Qinv
// (B, K, s, s), Rinv (B, K-1, c, c), and one zero-pivot flag a problem
// (false from the caller).
struct OpArrays {
  float* S;
  float* P;
  float* gamma;
  float* Qinv;
  float* Rinv;
  bool* bad;
  // The Thomas instantiation's outputs in place of S, P and bad: phi and
  // theta (B, K, s, s) and the per-knot flags (B, K).
  float* phi;
  float* theta;
  int* knot_bad;
};

// A Gauss-Jordan flag held by the thread that writes it: in a round that
// holds every matrix, gj_invert_smem's thread m flags matrix m alone.
struct GjHit {
  int v;
  __device__ __forceinline__ void operator=(int x) { v = x; }
};

// Condenses tile `tile` of problem b (its own knots [k0, k1), k0 = tile nk)
// into the problem's rows of S, P, gamma and Qinv and its intervals k0 ..
// min(k1, K-1) - 1 of Rinv; a clamped zero pivot in a live Q or R block of
// the window sets bad[b].  With kThomas, phi, theta, gamma, Qinv and Rinv
// of its own knots, and knot_bad[b, k] = a clamped zero pivot in Q_k or
// R_{k-1}; the window must be one Gauss-Jordan round (tile_knots plans
// so).  `smem` holds tile_plan(L.nk, s, c).total floats.  Ends
// synchronised.
template <int kS, int kC, bool kThomas = false>
__device__ __forceinline__ void condense_tile(const KktArrays& in, const OpArrays& out,
                                              const TilePlan& L, size_t b, int tile,
                                              float* smem) {
  constexpr int kCapS = kS > 0 ? kS : 32, kCapC = kC > 0 ? kC : 32;
  const int s = kS > 0 ? kS : in.s, c = kC > 0 ? kC : in.c, K = in.K;
  const int ss = s * s, sc = s * c, cc = c * c, kf = 3 * ss;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int k0 = tile * L.nk, k1 = k0 + L.nk < K ? k0 + L.nk : K, nk = k1 - k0;
  const int w0 = k0 >= 2 ? k0 - 2 : 0, w1 = k1 + 1 < K ? k1 + 1 : K;
  const int nw = w1 - w0, j0 = k0 - w0;
  const float* Q = in.Q + b * K * ss;
  const float* R = in.R + b * (K - 1) * cc;
  const float* A = in.A + b * (K - 1) * ss;
  const float* Bm = in.Bm + b * (K - 1) * sc;
  const float* q = in.q + b * K * s;
  const float* r = in.r + b * (K - 1) * c;
  const float* cv = in.cv + b * K * s;
  float* S_out = out.S + b * K * kf;
  float* P_out = out.P + b * K * kf;
  float* Qw = smem + L.qinv;
  float* Rw = smem + L.rinv;
  float* Sw = smem + L.ops;
  float* thw = smem + L.thinv;
  float* gj = smem + L.gj;

  // 1. (Q_k + rho I)^{-1} of the window's knots, (R_k + rho I)^{-1} of its
  // intervals; the own ones out.
  if (kThomas) {
    // Thread m's flags are window matrix m's; the window's knot flags go
    // into the theta^{-1} area, which this instantiation does not use.
    int* kb = reinterpret_cast<int*>(thw);
    GjHit hit{0};
    gj_invert_smem<kS>(gj, tid, nt, Q + (size_t)w0 * ss, ss, Qw, ss, nullptr, nw, s,
                       in.rho, &hit);
    if (tid < nw) kb[tid] = hit.v;
    hit.v = 0;
    gj_invert_smem<kC>(gj, tid, nt, R + (size_t)w0 * cc, cc, Rw, cc, nullptr, nw - 1,
                       c, in.rho, &hit);
    if (tid < nw - 1 && hit.v) kb[tid + 1] = 1;
    __syncthreads();
  } else {
    gj_invert_smem<kS>(gj, tid, nt, Q + (size_t)w0 * ss, ss, Qw, ss, nullptr, nw, s,
                       in.rho, out.bad + b);
    gj_invert_smem<kC>(gj, tid, nt, R + (size_t)w0 * cc, cc, Rw, cc, nullptr, nw - 1,
                       c, in.rho, out.bad + b);
  }
  {
    float* Qi = out.Qinv + (b * K + k0) * ss;
    for (int e = tid; e < nk * ss; e += nt) Qi[e] = Qw[j0 * ss + e];
    const int nr = (k1 < K ? k1 : K - 1) - k0;
    float* Ri = out.Rinv + (b * (K - 1) + k0) * cc;
    for (int e = tid; e < nr * cc; e += nt) Ri[e] = Rw[j0 * cc + e];
  }

  // 2. A thread a (window knot, row a): phi_k, B_{k-1} Rinv_{k-1} and
  // theta_k's row a in registers (all loads before any store); for own
  // knots also phi_{k+1}^T, the rows of S, gamma and the scalar Jacobi
  // Pinv.  Window knot 0 has no phi when the window starts past knot 0.
  // The Thomas instantiation computes its own knots alone.
  const int jlo = kThomas ? j0 : (w0 > 0 ? 1 : 0);
  const int jhi = kThomas ? j0 + nk : nw;
  for (int t = tid; t < (jhi - jlo) * s; t += nt) {
    const int j = jlo + t / s, a = t % s, k = w0 + j;
    float ph[kCapS], th[kCapS], br[kCapC];
    if (k > 0) {
      const float* Ap = A + (size_t)(k - 1) * ss;
      const float* Bp = Bm + (size_t)(k - 1) * sc;
      const float* Qp = Qw + (j - 1) * ss;
      const float* Rp = Rw + (j - 1) * cc;
      float ar[kCapS], brow[kCapC];
#pragma unroll
      for (int e = 0; e < s; ++e) ar[e] = Ap[a * s + e];
#pragma unroll
      for (int e = 0; e < c; ++e) brow[e] = Bp[a * c + e];
#pragma unroll
      for (int jj = 0; jj < s; ++jj) ph[jj] = lk::dot_col<kS>(ar, Qp, jj, s);
#pragma unroll
      for (int jj = 0; jj < c; ++jj) br[jj] = lk::dot_col<kC>(brow, Rp, jj, c);
#pragma unroll
      for (int jj = 0; jj < s; ++jj) {
        const float t1 = lk::dot<kS>(ph, Ap + jj * s, s);
        const float t2 = lk::dot<kC>(br, Bp + jj * c, c);
        th[jj] = (t1 + t2) + Qw[j * ss + a * s + jj];
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < s; ++jj) {
        ph[jj] = 0.f;
        th[jj] = Qw[j * ss + a * s + jj];
      }
    }
    float ut[kCapS];
    if (kThomas) {
      const size_t row = ((b * K + k) * s + a) * s;
#pragma unroll
      for (int jj = 0; jj < s; ++jj) {
        out.phi[row + jj] = ph[jj];
        out.theta[row + jj] = th[jj];
      }
      if (a == 0) out.knot_bad[b * K + k] = reinterpret_cast<const int*>(thw)[j];
    } else {
      float* Sj = Sw + j * kf + a * s;
#pragma unroll
      for (int jj = 0; jj < s; ++jj) {
        Sj[jj] = ph[jj];
        Sj[ss + jj] = th[jj];
      }
      if (k < k0 || k >= k1) continue;
      if (k < K - 1) {
        const float* Ak = A + (size_t)k * ss;
        float qc[kCapS];
#pragma unroll
        for (int e = 0; e < s; ++e) qc[e] = Qw[j * ss + e * s + a];
#pragma unroll
        for (int jj = 0; jj < s; ++jj) ut[jj] = lk::dot<kS>(Ak + jj * s, qc, s);
      } else {
#pragma unroll
        for (int jj = 0; jj < s; ++jj) ut[jj] = 0.f;
      }
    }
    const float* qk = q + (size_t)k * s;
    float g = lk::dot<kS>(Qw + j * ss + a * s, qk, s);
    if (k > 0) {
      const float t1 = lk::dot<kS>(ph, qk - s, s);
      const float t2 = lk::dot<kC>(br, r + (size_t)(k - 1) * c, c);
      g = (t1 + t2) + g;
    }
    out.gamma[(b * K + k) * s + a] = g - cv[(size_t)k * s + a];
    if (kThomas) continue;
    float* Sj = Sw + j * kf + a * s;
    float* So = S_out + (size_t)k * kf + a * s;
#pragma unroll
    for (int jj = 0; jj < s; ++jj) {
      Sj[2 * ss + jj] = ut[jj];
      So[jj] = ph[jj];
      So[ss + jj] = th[jj];
      So[2 * ss + jj] = ut[jj];
    }
    if (in.precond == kLkJacobi) {
      float d = 0.f;
#pragma unroll
      for (int jj = 0; jj < s; ++jj)
        if (jj == a) d = th[jj];
      const float dinv = 1.f / (d != 0.f ? d : 1.f);
      float* Po = P_out + (size_t)k * kf + a * s;
#pragma unroll
      for (int jj = 0; jj < s; ++jj) {
        Po[jj] = 0.f;
        Po[ss + jj] = jj == a ? dinv : 0.f;
        Po[2 * ss + jj] = 0.f;
      }
    }
  }
  __syncthreads();
  if (kThomas || in.precond == kLkJacobi) return;

  // 3. theta^{-1} of the own knots and, for the stair, of one neighbour on
  // each side.
  const bool stair = in.precond == kLkStair;
  const int lo = stair && k0 > 0 ? j0 - 1 : j0;
  const int hi = stair && k1 < K ? j0 + nk + 1 : j0 + nk;
  gj_invert_smem<kS>(gj, tid, nt, Sw + lo * kf + ss, kf, thw + lo * ss, ss, nullptr,
                     hi - lo, s, 0.f, static_cast<bool*>(nullptr));

  // 4. Pinv, a thread a (own knot, row a): theta_k^{-1} and, for the stair,
  // -(theta_k^{-1} phi_k) theta_{k-1}^{-1} and
  // -(theta_k^{-1} phi_{k+1}^T) theta_{k+1}^{-1} (zero past either end).
  for (int t = tid; t < nk * s; t += nt) {
    const int kl = t / s, a = t % s, j = j0 + kl, k = k0 + kl;
    float ti[kCapS], pl[kCapS], pu[kCapS];
#pragma unroll
    for (int e = 0; e < s; ++e) ti[e] = thw[j * ss + a * s + e];
#pragma unroll
    for (int jj = 0; jj < s; ++jj) pl[jj] = pu[jj] = 0.f;
    if (stair) {
      float tr[kCapS];
      if (k > 0) {
#pragma unroll
        for (int jj = 0; jj < s; ++jj) tr[jj] = lk::dot_col<kS>(ti, Sw + j * kf, jj, s);
#pragma unroll
        for (int jj = 0; jj < s; ++jj)
          pl[jj] = -lk::dot_col<kS>(tr, thw + (j - 1) * ss, jj, s);
      }
      if (k < K - 1) {
#pragma unroll
        for (int jj = 0; jj < s; ++jj)
          tr[jj] = lk::dot_col<kS>(ti, Sw + j * kf + 2 * ss, jj, s);
#pragma unroll
        for (int jj = 0; jj < s; ++jj)
          pu[jj] = -lk::dot_col<kS>(tr, thw + (j + 1) * ss, jj, s);
      }
    }
    float* Po = P_out + (size_t)k * kf + a * s;
#pragma unroll
    for (int jj = 0; jj < s; ++jj) {
      Po[jj] = pl[jj];
      Po[ss + jj] = ti[jj];
      Po[2 * ss + jj] = pu[jj];
    }
  }
  __syncthreads();
}


}  // namespace gato
