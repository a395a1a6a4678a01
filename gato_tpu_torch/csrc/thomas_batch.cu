// Rows 5 and 6: the exact solve as block-Thomas elimination, one forward
// and one reverse pass, batched.
//
// Replace gato_tpu/kernels/thomas_batch.py::_fwd_kernel (the pallas_call in
// _fwd_call) and ::_rev_kernel (in _rev_call); entry
// solve_direct_thomas_batched.  Plain versions, wrappers and the Python
// mirror of the launch plan: gato_tpu_torch/kernels/thomas_batch.py.
//
// Forward (row 5), two launches:
//   1. thomas_condense_kernel: every knot's Qinv, Rinv, phi_k = A_{k-1}
//      Qinv_{k-1}, theta_k and gamma_k, in row 7's condensation tiles
//      (condense_tile.cuh, its Thomas instantiation) spread over the card,
//      B x ceil(K / nk) CTAs (nk from kernels/longk.py's tile_knots);
//      none of it depends on the elimination.  A clamped zero pivot in Q_k
//      or R_{k-1} sets knot k's flag.
//   2. thomas_walk_kernel: the walk j = 0..K-1 of each problem on one warp,
//        M_j = phi_j Cinv_{j-1};  Dhat_j = theta_j - M_j phi_j^T
//        bhat_j = gamma_j - M_j bhat_{j-1};  Cinv_j = Dhat_j^{-1}
//      in registers: column J of [Dhat_j | I] (J < 2 kN, kN = 16 or 32)
//      sits in lane J mod 32, slot J / 32, Dhat's columns at J = P.. and
//      the identity's at the other half.  The lanes holding Cinv_{j-1}'s
//      columns form M's columns from phi_j (shared memory, a broadcast
//      read), M's columns go round the warp by shuffles to form Dhat_j in
//      the same registers and bhat_j in every lane, and the Gauss-Jordan
//      (no pivoting, the pivot row divided explicitly, a zero pivot divided
//      by 1; the pivot column reaches every lane by shuffles) leaves
//      Cinv_j where the identity was, so P alternates between the halves
//      and nothing moves between knots.  No block barrier and no shared-
//      memory round trip sit between the products and the inverse.  phi,
//      theta, gamma and the flag of knots j+1..j+3 are in flight into a
//      ring of the warp's own shared memory (cp.async) while knot j is
//      walked.  A CTA carries `walks` problems, a warp each, with nothing
//      shared between them (no __syncthreads).
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
// here on one warp with shuffles), so one problem's time is the latency
// of that chain, K steps long; the condensation is knot-parallel and runs
// on the whole card.  A batch is bound by how many walks run at once (a
// warp each).  The stacks (~172 KB a problem at IIWA) go through global
// memory once each way.
//
// With GATO_STAGE_STAMPS defined (gato_tpu_torch/tools/direct_stamps.py
// builds that way; the default build does not): stamp 0 is the first
// condensation CTA's start, stamp 1 the last one's end, stamp 2 + j the end
// of knot j of problem 0's walk (the first kThomasStamps - 2 knots).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "condense.cuh"
#include "condense_tile.cuh"

namespace gato {

// Knots a walk keeps in its ring: the one walked and three in flight.
constexpr int kWalkRing = 4;
// Walks (warps) a forward CTA carries, at most.
constexpr int kMaxWalks = 8;

// The walk's padded width: 14 compiles IIWA's width in; 16 and 32 take
// any s up to them, the blocks padded (phi with zeros, theta with the
// identity) so that no loop of the walk depends on s.
inline __host__ __device__ int walk_width(int s) { return s == 14 ? 14 : (s <= 16 ? 16 : 32); }

// Floats of one ring slot: phi_j, theta_j (kN x kN each), gamma_j (kN) and
// knot j's flag.
inline __host__ __device__ int walk_slot_floats(int s) {
  const int w = walk_width(s);
  return (int)(2 * round4((long long)w * w) + round4(w) + 4);
}

// Dynamic shared memory of a walk CTA of `walks` warps, in bytes.
inline long long walk_smem_bytes(int s, int walks) {
  return 4LL * walks * kWalkRing * walk_slot_floats(s);
}

constexpr int kThomasStamps = 66;
#ifdef GATO_STAGE_STAMPS
static __device__ unsigned long long thomas_stamps[kThomasStamps];
static __device__ int thomas_stamp_count;
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__global__ void thomas_stamp_reset() {
  thomas_stamps[0] = ~0ULL;
  thomas_stamps[1] = 0;
  thomas_stamp_count = 2;
}
// Stamp 0 (i = 0) or 1 (i = 1) of a condensation CTA: the earliest start,
// the latest end.
__device__ __forceinline__ void condense_stamp(int i) {
  __syncthreads();
  if (threadIdx.x == 0) {
    if (i == 0)
      atomicMin(&thomas_stamps[0], global_ns());
    else
      atomicMax(&thomas_stamps[1], global_ns());
  }
}
__device__ __forceinline__ void walk_stamp(size_t b, int j) {
  if (b == 0 && (threadIdx.x & 31) == 0 && 2 + j < kThomasStamps) {
    thomas_stamps[2 + j] = global_ns();
    thomas_stamp_count = 3 + j;
  }
}
#else
__device__ __forceinline__ void condense_stamp(int) {}
__device__ __forceinline__ void walk_stamp(size_t, int) {}
#endif

// Row 5, launch 1: one CTA a (problem, tile), condense_tile's Thomas
// instantiation.
template <int kS, int kC>
__global__ void __launch_bounds__(kGridThreads)
thomas_condense_kernel(KktArrays in, OpArrays out, TilePlan L, int ntiles) {
  extern __shared__ float4 smem4[];
  condense_stamp(0);
  condense_tile<kS, kC, true>(in, out, L, blockIdx.x / ntiles, blockIdx.x % ntiles,
                              reinterpret_cast<float*>(smem4));
  condense_stamp(1);
}

// What the walk reads (the condensation's stacks, (B, K, ...)) and writes.
struct WalkArrays {
  const float* phi;
  const float* theta;
  const float* gamma;
  const int* knot_bad;
  float* Cinv;
  float* bhat;
  int B, K, s, walks;
};

// n floats from global src into the warp's shared dst with cp.async: 16
// bytes a copy where both ends are 16-byte aligned and n a multiple of 4,
// else 4.
__device__ __forceinline__ void warp_async_copy(float* dst, const float* src, int n) {
  const int lane = threadIdx.x & 31;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0 &&
      (n & 3) == 0) {
    for (int i = lane; i < n / 4; i += 32) __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
  } else {
    for (int i = lane; i < n; i += 32) __pipeline_memcpy_async(dst + i, src + i, 4);
  }
}

// Knot j of problem b into a ring slot (nothing past the horizon), one
// commit group either way; an n x n block goes to the top left of the
// slot's kN x kN one, whose padding walk_init wrote.
template <int kN>
__device__ __forceinline__ void walk_load(const WalkArrays& a, size_t b, int j, float* slot) {
  if (j < a.K) {
    const int n = kN == 14 ? 14 : a.s, nn = kN * kN, ss4 = (int)round4(nn);
    const size_t kn = b * a.K + j;
    const float* ph = a.phi + kn * n * n;
    const float* th = a.theta + kn * n * n;
    if (n == kN) {
      warp_async_copy(slot, ph, nn);
      warp_async_copy(slot + ss4, th, nn);
    } else {
      for (int e = threadIdx.x & 31; e < n * n; e += 32) {
        const int r = e / n, c = e - r * n;
        __pipeline_memcpy_async(slot + r * kN + c, ph + e, 4);
        __pipeline_memcpy_async(slot + ss4 + r * kN + c, th + e, 4);
      }
    }
    warp_async_copy(slot + 2 * ss4, a.gamma + kn * n, n);
    if ((threadIdx.x & 31) == 0)
      __pipeline_memcpy_async(slot + 2 * ss4 + round4(kN), a.knot_bad + kn, 4);
  }
  __pipeline_commit();
}

// The padding of every ring slot: phi and gamma zero, theta the identity
// past n (written once; the copies never touch it).
template <int kN>
__device__ __forceinline__ void walk_init(float* ring, int n) {
  const int slot_floats = (int)(2 * round4(kN * kN) + round4(kN) + 4);
  const int ss4 = (int)round4(kN * kN);
  for (int e = threadIdx.x & 31; e < kWalkRing * slot_floats; e += 32) {
    const int o = e % slot_floats, r = (o - ss4) / kN, c = (o - ss4) % kN;
    ring[e] = o >= ss4 && o < ss4 + kN * kN && r == c && r >= n ? 1.f : 0.f;
  }
  __syncwarp();
}

// One knot of the walk on one warp.  Column J of [Dhat_j | I] (kN x kN
// each) is held by lane J % 32 in slot J / 32: Dhat_j's columns at J = kP
// + c, the identity's (Cinv_j after the Gauss-Jordan) at J = kQ + c.  On
// entry the kP columns hold Cinv_{j-1} (j > 0) and every lane holds
// bhat_{j-1} in bh; on exit the kQ columns hold Cinv_j and bh holds bhat_j
// (poisoned).  The pivot row is scaled by the correctly rounded reciprocal
// of the pivot (longk_direct.cu's warp_gj_pad, which has the numbers).
template <int kN, int kP>
__device__ __forceinline__ void walk_step(const WalkArrays& a, size_t b, int j,
                                          const float* slot,
                                          float (&col)[(2 * kN + 31) / 32][kN],
                                          float (&bh)[kN]) {
  constexpr int kC = (2 * kN + 31) / 32;
  constexpr int kQ = (kP + kN) % (2 * kN);
  constexpr int kSP = kP / 32, kSQ = kQ / 32, kLP = kP % 32, kLQ = kQ % 32;
  constexpr int kSS4 = (kN * kN + 3) / 4 * 4;
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31, n = kN == 14 ? 14 : a.s;
  const int cP = lane - kLP, cQ = lane - kLQ;
  const bool ownP = cP >= 0 && cP < kN, ownQ = cQ >= 0 && cQ < kN;
  const int cc = ownP ? cP : 0;  // a valid column for the other lanes' reads
  const float* ph = slot;
  const float* th = slot + kSS4;
  const float* gm = slot + 2 * kSS4;
  const int knot_bad = reinterpret_cast<const int*>(gm + (kN + 3) / 4 * 4)[0];
  float bc[kN];
  if (j == 0) {
#pragma unroll
    for (int r = 0; r < kN; ++r) {
      col[kSP][r] = th[r * kN + cc];
      bc[r] = gm[r];
    }
  } else {
    // Column cP of M_j = phi_j Cinv_{j-1}.
    float m[kN];
#pragma unroll
    for (int r = 0; r < kN; ++r) {
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < kN; ++e) acc = fmaf(ph[r * kN + e], col[kSP][e], acc);
      m[r] = acc;
    }
    // Dhat_j = theta_j - M_j phi_j^T into the kP columns, bhat_j = gamma_j -
    // M_j bhat_{j-1} in every lane: M's column e from lane kLP + e.
    float bacc[kN];
#pragma unroll
    for (int r = 0; r < kN; ++r) col[kSP][r] = bacc[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const float pe = ph[cc * kN + e];
#pragma unroll
      for (int r = 0; r < kN; ++r) {
        const float me = __shfl_sync(kAll, m[r], kLP + e);
        col[kSP][r] = fmaf(me, pe, col[kSP][r]);
        bacc[r] = fmaf(me, bh[e], bacc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kN; ++r) {
      col[kSP][r] = th[r * kN + cc] - col[kSP][r];
      bc[r] = gm[r] - bacc[r];
    }
  }
  // [Dhat_j | I]: the identity's columns, zero elsewhere.
#pragma unroll
  for (int k = 0; k < kC; ++k) {
#pragma unroll
    for (int r = 0; r < kN; ++r) {
      if (k == kSQ && ownQ)
        col[k][r] = cQ == r ? 1.f : 0.f;
      else if (!(k == kSP && ownP))
        col[k][r] = 0.f;
    }
  }
  float d = 0.f;
#pragma unroll
  for (int r = 0; r < kN; ++r)
    if (r == cP && r < n) d = col[kSP][r];
  const bool live = __any_sync(kAll, d != 0.f);
  int zero = 0;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const float piv = __shfl_sync(kAll, col[kSP][i], kLP + i);
    zero |= piv == 0.f;
    const float inv = __frcp_rn(piv != 0.f ? piv : 1.f);
    float rv[kC];
#pragma unroll
    for (int k = 0; k < kC; ++k) rv[k] = col[k][i] * inv;
#pragma unroll
    for (int r = 0; r < kN; ++r) {
      if (r != i) {
        const float f = __shfl_sync(kAll, col[kSP][r], kLP + i);
#pragma unroll
        for (int k = 0; k < kC; ++k) col[k][r] = fmaf(-f, rv[k], col[k][r]);
      }
    }
#pragma unroll
    for (int k = 0; k < kC; ++k) col[k][i] = rv[k];
  }
  const bool poison = knot_bad != 0 || (zero && live);
  const float add = poison ? __int_as_float(0x7f800000) : 0.f;
  const size_t kn = b * a.K + j;
  float* bj = a.bhat + kn * n;
#pragma unroll
  for (int r = 0; r < kN; ++r) {
    bh[r] = r < n ? bc[r] + add : 0.f;
    if (r < n && r == lane) bj[r] = bh[r];
  }
  if (ownQ && cQ < n) {
    float* Cj = a.Cinv + kn * n * n + cQ;
#pragma unroll
    for (int r = 0; r < kN; ++r)
      if (r < n) Cj[r * n] = col[kSQ][r];
  }
}

// Knot j: wait for its slot, walk it, refill the slot with knot j + ring.
template <int kN, int kP>
__device__ __forceinline__ void walk_knot(const WalkArrays& a, size_t b, int j, float* ring,
                                          int slot_floats,
                                          float (&col)[(2 * kN + 31) / 32][kN],
                                          float (&bh)[kN]) {
  float* slot = ring + (j % kWalkRing) * slot_floats;
  __pipeline_wait_prior(kWalkRing - 1);
  __syncwarp();
  walk_step<kN, kP>(a, b, j, slot, col, bh);
  walk_stamp(b, j);
  __syncwarp();
  walk_load<kN>(a, b, j + kWalkRing, slot);
}

// Row 5, launch 2: warp w of block x walks problem x walks + w.
template <int kN>
__global__ void __launch_bounds__(32 * kMaxWalks) thomas_walk_kernel(WalkArrays a) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5;
  const size_t b = (size_t)blockIdx.x * a.walks + warp;
  if (b >= (size_t)a.B) return;
  const int slot_floats = walk_slot_floats(a.s);
  float* ring = reinterpret_cast<float*>(smem4) + (size_t)warp * kWalkRing * slot_floats;
  if (kN != 14) walk_init<kN>(ring, a.s);
  for (int i = 0; i < kWalkRing; ++i) walk_load<kN>(a, b, i, ring + i * slot_floats);
  float col[(2 * kN + 31) / 32][kN];
  float bh[kN];
  for (int j = 0; j < a.K; j += 2) {
    walk_knot<kN, 0>(a, b, j, ring, slot_floats, col, bh);
    if (j + 1 < a.K) walk_knot<kN, kN>(a, b, j + 1, ring, slot_floats, col, bh);
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

// The forward pass's stamps of the last launch (%globaltimer, ns; the
// source's note) into out[kThomasStamps]; returns how many were written,
// or 0 in a build without GATO_STAGE_STAMPS.
int gato_thomas_stamps(unsigned long long* out) {
#ifdef GATO_STAGE_STAMPS
  int n = 0;
  if (cudaMemcpyFromSymbol(&n, gato::thomas_stamp_count, sizeof(int)) != cudaSuccess ||
      cudaMemcpyFromSymbol(out, gato::thomas_stamps, sizeof(gato::thomas_stamps)) !=
          cudaSuccess)
    return 0;
  return n;
#else
  (void)out;
  return 0;
#endif
}

// Dynamic shared memory of a walk CTA of `walks` warps, in bytes.
long long gato_thomas_walk_smem_bytes(int s, int walks) {
  return gato::walk_smem_bytes(s, walks);
}

// Launches row 5 on `stream` for B problems: the condensation in tiles of
// `tile_knots` own knots (kernels/longk.py's tile_knots), then the walks,
// `walks` a CTA (kernels/thomas_batch.py's walks_per_cta).  The seven
// outputs are the (B, K, ...) factor stacks (Rinv (B, K-1, c, c)),
// knot_bad (B, K) ints scratch.  Returns the CUDA error code of the
// launches (0 on success); nothing is synchronised.
int gato_thomas_fwd(const float* Q, const float* R, const float* A,
                    const float* Bm, const float* q, const float* r,
                    const float* c, float* Cinv, float* bhat, float* Qinv,
                    float* Rinv, float* phi, float* theta, float* gam,
                    int* knot_bad, int B, int K, int s, int cdim, float rho,
                    int tile_knots, int walks, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const gato::TilePlan L = gato::tile_plan(tile_knots, s, cdim);
  const size_t tile_smem = (size_t)L.total * sizeof(float);
  const bool iiwa = s == 14 && cdim == 7;
  const void* condense = iiwa ? (const void*)gato::thomas_condense_kernel<14, 7>
                              : (const void*)gato::thomas_condense_kernel<0, 0>;
  const size_t walk_smem = (size_t)gato::walk_smem_bytes(s, walks);
  const int kw = gato::walk_width(s);
  const void* walk = kw == 14   ? (const void*)gato::thomas_walk_kernel<14>
                     : kw == 16 ? (const void*)gato::thomas_walk_kernel<16>
                                : (const void*)gato::thomas_walk_kernel<32>;
  cudaError_t err = gato::opt_in_smem(condense, tile_smem);
  if (err == cudaSuccess) err = gato::opt_in_smem(walk, walk_smem);
  if (err != cudaSuccess) return (int)err;
#ifdef GATO_STAGE_STAMPS
  gato::thomas_stamp_reset<<<1, 1, 0, st>>>();
#endif
  const int ntiles = (K + L.nk - 1) / L.nk;
  const int threads = gato::tile_threads(tile_knots, s, cdim);
  gato::KktArrays in{Q, R, A, Bm, q, r, c, K, s, cdim, rho, gato::kLkJacobi};
  gato::OpArrays out{nullptr, nullptr, gam, Qinv, Rinv, nullptr, phi, theta, knot_bad};
  if (iiwa)
    gato::thomas_condense_kernel<14, 7><<<(unsigned)B * ntiles, threads, tile_smem, st>>>(
        in, out, L, ntiles);
  else
    gato::thomas_condense_kernel<0, 0><<<(unsigned)B * ntiles, threads, tile_smem, st>>>(
        in, out, L, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gato::WalkArrays wa{phi, theta, gam, knot_bad, Cinv, bhat, B, K, s, walks};
  const unsigned blocks = (unsigned)((B + walks - 1) / walks);
  if (kw == 14)
    gato::thomas_walk_kernel<14><<<blocks, 32 * walks, walk_smem, st>>>(wa);
  else if (kw == 16)
    gato::thomas_walk_kernel<16><<<blocks, 32 * walks, walk_smem, st>>>(wa);
  else
    gato::thomas_walk_kernel<32><<<blocks, 32 * walks, walk_smem, st>>>(wa);
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
