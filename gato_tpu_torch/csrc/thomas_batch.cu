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
// Reverse (row 6), two launches:
//   1. thomas_rev_walk_kernel: only the chain
//        x_j = Cinv_j (bhat_j - phi_{j+1}^T x_{j+1}),  j = K-1..0,
//      on one warp a problem, lane a on row a: x_{j+1} stays in registers
//      and reaches the lanes by shuffles, Cinv_j, phi_{j+1} and bhat_j of
//      the next seven knots are in flight into a ring of the warp's shared
//      memory (cp.async; row 5's pattern, reversed), so no global load sits
//      in the chain; the width is compiled in (14, or 16 and 32 padded
//      with zeros).  `walks` problems a CTA.
//   2. thomas_rev_epilogue_kernel: knot-parallel across the card, a warp a
//      knot: dz_x and dz_u from lambda (recover_dz's algebra), residual
//      row j of the original system and ||gamma_j||^2; each problem's eta,
//      ||gamma||^2 and converged summed in a fixed order (per CTA, then
//      the problem's last CTA over its tiles), with no float atomics.
//
// Not carried over from the TPU: the batch-in-lanes packing (plan_packing,
// _lane_budget), the shifted interval arrays and the group relabelling of
// _call_thomas.  The stacks are (B, K, ...) in the public layout.
//
// What bounds it on an H100: the walks are chains of dependent small steps
// (per knot of the forward: two s x s products and an s-pivot Gauss-Jordan,
// here on one warp with shuffles; of the reverse two s x s matrix-vector
// products), so one problem's time is the latency of that chain, K steps
// long; the condensation and the reverse epilogue are knot-parallel and
// run on the whole card.  A batch is bound by how many walks run at once
// (a warp each).  The stacks (~172 KB a problem at IIWA) go through global
// memory once each way.
//
// With GATO_STAGE_STAMPS defined (gato_tpu_torch/tools/direct_stamps.py
// builds that way; the default build does not): stamp 0 is the first
// condensation CTA's start, stamp 1 the last one's end, stamp 2 + j the end
// of knot j of problem 0's walk (the first kThomasStamps - 2 knots).  Row
// 6's own stamps (gato_thomas_rev_stamps): 0 its walk's start and 1 its end
// in problem 0, 2 and 3 its epilogue launch's first CTA's start and last
// CTA's end, 4 + i the end of step i (knot K - 1 - i) of problem 0's walk
// (the first kRevStamps - 4).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "condense.cuh"
#include "condense_tile.cuh"

namespace gato {

// Knots a walk keeps in its ring: the one walked and three in flight.
constexpr int kWalkRing = 4;
// Walks (warps) a forward or reverse CTA carries, at most.
constexpr int kMaxWalks = 8;
// Knots the reverse walk keeps in its ring: the one walked and seven in
// flight (a knot of it is a few hundred cycles, a copy's latency ~1 us).
constexpr int kRevRing = 8;
// Knots of an epilogue CTA, a warp each.
constexpr int kEpiKnots = 4;

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
constexpr int kRevStamps = 68;
static __device__ unsigned long long rev_stamps[kRevStamps];
static __device__ int rev_stamp_count;
__global__ void rev_stamp_reset() {
  rev_stamps[2] = ~0ULL;
  rev_stamps[3] = 0ULL;
  rev_stamp_count = 4;
}
// Stamp i (< 4) of problem 0's walk, by its lane 0.
__device__ __forceinline__ void rev_stamp(size_t b, int i) {
  if (b == 0 && (threadIdx.x & 31) == 0) rev_stamps[i] = global_ns();
}
// The end of step i of problem 0's walk.
__device__ __forceinline__ void rev_knot_stamp(size_t b, int i) {
  if (b == 0 && (threadIdx.x & 31) == 0 && 4 + i < kRevStamps) {
    rev_stamps[4 + i] = global_ns();
    rev_stamp_count = 5 + i;
  }
}
// Stamp 2 (the epilogue's first CTA's start) or 3 (its last CTA's end).
__device__ __forceinline__ void epi_stamp(int i) {
  __syncthreads();
  if (threadIdx.x == 0) {
    if (i == 2)
      atomicMin(&rev_stamps[2], global_ns());
    else
      atomicMax(&rev_stamps[3], global_ns());
  }
}
#else
__device__ __forceinline__ void epi_stamp(int) {}
__device__ __forceinline__ void condense_stamp(int) {}
__device__ __forceinline__ void walk_stamp(size_t, int) {}
__device__ __forceinline__ void rev_stamp(size_t, int) {}
__device__ __forceinline__ void rev_knot_stamp(size_t, int) {}
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

// Row 6's plan.  The reverse walk's ring row stride: 14 (IIWA's width,
// compiled in; lane a reading row a of Cinv_j at stride 14 meets no bank
// conflict), else kN + 1 (odd, so that no two lanes of a column read share
// a bank).
inline __host__ __device__ int rev_ld(int s) {
  const int w = walk_width(s);
  return w == 14 ? 14 : w + 1;
}

// Floats of one reverse ring slot: Cinv_j and phi_{j+1} (kN rows of
// rev_ld each, the padding zero) and bhat_j.
inline __host__ __device__ int rev_slot_floats(int s) {
  const int w = walk_width(s);
  return (int)(2 * round4((long long)w * rev_ld(s)) + round4(w));
}

// Dynamic shared memory of a reverse walk CTA of `walks` warps, in bytes.
inline long long rev_smem_bytes(int s, int walks) {
  return 4LL * walks * kRevRing * rev_slot_floats(s);
}

// An epilogue warp's shared memory, in floats (offsets rounded to 4, so
// that 16-byte copies land aligned): theta_j, Qinv_j, phi_j, phi_{j+1} and
// A_j (n x n), B_j (n x c), Rinv_j (c x c), x_{j-1}, x_j, x_{j+1}, gamma_j,
// q_j and the recovery's right side (n), r_j and its right side (c).
struct EpiLayout {
  int th, qi, p0, p1, at, bt, ri, xm, x0, xp, g, qv, rx, rv, ru, total;
};
inline __host__ __device__ EpiLayout epi_layout(int n, int c) {
  EpiLayout L;
  const int ss = (int)round4((long long)n * n), v = (int)round4(n), u = (int)round4(c);
  L.th = 0;
  L.qi = L.th + ss;
  L.p0 = L.qi + ss;
  L.p1 = L.p0 + ss;
  L.at = L.p1 + ss;
  L.bt = L.at + ss;
  L.ri = L.bt + (int)round4((long long)n * c);
  L.xm = L.ri + (int)round4((long long)c * c);
  L.x0 = L.xm + v;
  L.xp = L.x0 + v;
  L.g = L.xp + v;
  L.qv = L.g + v;
  L.rx = L.qv + v;
  L.rv = L.rx + v;
  L.ru = L.rv + u;
  L.total = L.ru + u;
  return L;
}

// Dynamic shared memory of an epilogue CTA (kEpiKnots warps), in bytes.
inline long long epi_smem_bytes(int s, int c) {
  return 4LL * kEpiKnots * epi_layout(s, c).total;
}

// What row 6 reads and writes: the factor stacks and the KKT vectors
// (B, K, ...), lambda, dz_x, dz_u, converged and eta; part (B, tiles, 2)
// and ticket (B) scratch.
struct RevArrays {
  const float* Cinv;
  const float* bhat;
  const float* Qinv;
  const float* Rinv;
  const float* phi;
  const float* theta;
  const float* gamma;
  const float* q;
  const float* A;
  const float* Bm;
  const float* r;
  float* lam;
  float* dzx;
  float* dzu;
  int* conv;
  float* eta;
  float* part;
  unsigned* ticket;
  int B, K, s, c, walks, tiles;
};

// Knot j of problem b into a reverse ring slot (nothing below 0): Cinv_j,
// phi_{j+1} (not past the horizon) and bhat_j, one commit group either way;
// an n x n block goes to the top left of the slot's kN rows of kLd, whose
// padding the walk zeroed.
template <int kN>
__device__ __forceinline__ void rev_load(const RevArrays& a, size_t b, int j, float* slot) {
  if (j >= 0) {
    constexpr int kLd = kN == 14 ? 14 : kN + 1;
    constexpr int kSS4 = (kN * kLd + 3) / 4 * 4;
    const int n = kN == 14 ? 14 : a.s;
    const size_t kn = b * a.K + j;
    const float* ci = a.Cinv + kn * n * n;
    const float* ph = a.phi + (kn + 1) * n * n;
    const bool next = j + 1 < a.K;
    if (kN == 14) {
      warp_async_copy(slot, ci, 196);
      if (next) warp_async_copy(slot + kSS4, ph, 196);
    } else {
      for (int e = threadIdx.x & 31; e < n * n; e += 32) {
        const int r = e / n, col = e - r * n;
        __pipeline_memcpy_async(slot + r * kLd + col, ci + e, 4);
        if (next) __pipeline_memcpy_async(slot + kSS4 + r * kLd + col, ph + e, 4);
      }
    }
    warp_async_copy(slot + 2 * kSS4, a.bhat + kn * n, n);
  }
  __pipeline_commit();
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

// Row 6, launch 1: warp w of block x walks problem x walks + w back,
//   x_j = Cinv_j (bhat_j - phi_{j+1}^T x_{j+1}),  j = K-1..0,
// and writes lambda.  Lane a holds x_{j+1}[a] (lanes past kN repeat rows
// kN apart and store nothing); both products take their other factor's
// entries from the lanes by shuffles and their blocks from the ring slot,
// whose Cinv_j, phi_{j+1} and bhat_j were copied in kRevRing - 1 knots
// earlier.  Lane 0 zeroes the problem's ticket for the epilogue.
template <int kN>
__global__ void __launch_bounds__(32 * kMaxWalks) thomas_rev_walk_kernel(RevArrays a) {
  extern __shared__ float4 smem4[];
  constexpr int kLd = kN == 14 ? 14 : kN + 1;
  constexpr int kSS4 = (kN * kLd + 3) / 4 * 4;
  constexpr unsigned kAll = 0xffffffffu;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t b = (size_t)blockIdx.x * a.walks + warp;
  if (b >= (size_t)a.B) return;
  const int K = a.K, n = kN == 14 ? 14 : a.s, row = lane % kN;
  const int slot_floats = rev_slot_floats(a.s);
  float* ring = reinterpret_cast<float*>(smem4) + (size_t)warp * kRevRing * slot_floats;
  if (lane == 0) a.ticket[b] = 0u;
  if (kN != 14) {
    for (int e = lane; e < kRevRing * slot_floats; e += 32) ring[e] = 0.f;
    __syncwarp();
  }
  rev_stamp(b, 0);
  for (int i = 0; i < kRevRing; ++i) rev_load<kN>(a, b, K - 1 - i, ring + i * slot_floats);
  float* lam = a.lam + b * K * n;
  float x = 0.f;
  for (int i = 0; i < K; ++i) {
    const int j = K - 1 - i;
    float* slot = ring + (i % kRevRing) * slot_floats;
    __pipeline_wait_prior(kRevRing - 1);
    __syncwarp();
    const float* ci = slot;
    const float* ph = slot + kSS4;
    float rhs = slot[2 * kSS4 + row];
    if (i > 0) {
      float u = 0.f;
#pragma unroll
      for (int e = 0; e < kN; ++e) u = fmaf(ph[e * kLd + row], __shfl_sync(kAll, x, e), u);
      rhs -= u;
    }
    float xj = 0.f;
#pragma unroll
    for (int e = 0; e < kN; ++e) xj = fmaf(ci[row * kLd + e], __shfl_sync(kAll, rhs, e), xj);
    x = xj;
    if (lane < n) lam[(size_t)j * n + lane] = x;
    rev_knot_stamp(b, i);
    __syncwarp();
    rev_load<kN>(a, b, j - kRevRing, slot);
  }
  rev_stamp(b, 1);
}

// Row 6, launch 2: a warp a knot j of problem b, kEpiKnots knots a CTA
// (tile t = j / kEpiKnots), every block the knot needs copied into the
// warp's shared memory at once; lane a takes row a:
//   dz_x_j = Qinv_j ((q_j - x_j) - A_j^T x_{j+1})
//   dz_u_j = Rinv_j (r_j - B_j^T x_{j+1})              (j < K-1)
//   res_j  = ((gamma_j - theta_j x_j) - phi_{j+1}^T x_{j+1}) - phi_j x_{j-1}
// (condense.cuh's warp_recover_dz and thomas_rev_plain's residual; an absent
// term is 0).  ||res_j||^2 and ||gamma_j||^2 are warp sums; thread 0 sums
// its CTA's knots in order into part[b][t], and the CTA that finishes a
// problem's last tile (an integer ticket) sums its tiles in a fixed order
// (lane l tiles l, l + 32, ..., then a warp sum) into eta and converged.
// No float atomics: a problem's bits do not depend on the schedule.
template <int kN>
__global__ void __launch_bounds__(32 * kEpiKnots) thomas_rev_epilogue_kernel(RevArrays a) {
  extern __shared__ float4 smem4[];
  __shared__ float red[kEpiKnots][2];
  __shared__ int last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int K = a.K, n = kN == 14 ? 14 : a.s, c = a.c;
  const size_t b = blockIdx.x / a.tiles;
  const int tile = blockIdx.x % a.tiles, j = tile * kEpiKnots + warp;
  epi_stamp(2);
  float rsq = 0.f, gsq = 0.f;
  if (j < K) {
    const EpiLayout L = epi_layout(n, c);
    float* w = reinterpret_cast<float*>(smem4) + (size_t)warp * L.total;
    const size_t ss = (size_t)n * n, kn = b * K + j, ku = b * (K - 1) + j;
    const bool left = j > 0, right = j + 1 < K;
    warp_async_copy(w + L.th, a.theta + kn * ss, n * n);
    warp_async_copy(w + L.qi, a.Qinv + kn * ss, n * n);
    warp_async_copy(w + L.x0, a.lam + kn * n, n);
    warp_async_copy(w + L.g, a.gamma + kn * n, n);
    warp_async_copy(w + L.qv, a.q + kn * n, n);
    if (left) {
      warp_async_copy(w + L.p0, a.phi + kn * ss, n * n);
      warp_async_copy(w + L.xm, a.lam + (kn - 1) * n, n);
    }
    if (right) {
      warp_async_copy(w + L.p1, a.phi + (kn + 1) * ss, n * n);
      warp_async_copy(w + L.at, a.A + ku * ss, n * n);
      warp_async_copy(w + L.bt, a.Bm + ku * n * c, n * c);
      warp_async_copy(w + L.ri, a.Rinv + ku * c * c, c * c);
      warp_async_copy(w + L.xp, a.lam + (kn + 1) * n, n);
      warp_async_copy(w + L.rv, a.r + ku * c, c);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();
    float res = 0.f, gv = 0.f;
    if (lane < n) {
      const float* x0 = w + L.x0;
      const float* xm = w + L.xm;
      const float* xp = w + L.xp;
      float tx = 0.f, px = 0.f, u = 0.f;
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        if (e < n) {
          tx = fmaf(w[L.th + lane * n + e], x0[e], tx);
          if (left) px = fmaf(w[L.p0 + lane * n + e], xm[e], px);
          if (right) u = fmaf(w[L.p1 + e * n + lane], xp[e], u);
        }
      }
      gv = w[L.g + lane];
      res = ((gv - tx) - u) - px;
    }
    warp_recover_dz<kN>(w + L.qi, n, w + L.ri, c, w + L.at, w + L.bt, w + L.qv,
                        w + L.x0, w + L.xp, w + L.rv, w + L.rx, w + L.ru, n, c, right,
                        a.dzx + kn * n, a.dzu + ku * c);
    rsq = warp_sum(res * res);
    gsq = warp_sum(gv * gv);
  }
  if (lane == 0) {
    red[warp][0] = rsq;
    red[warp][1] = gsq;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float e = 0.f, g = 0.f;
    for (int k = 0; k < kEpiKnots; ++k) {
      e += red[k][0];
      g += red[k][1];
    }
    float* p = a.part + 2 * (b * a.tiles + tile);
    p[0] = e;
    p[1] = g;
    __threadfence();
    last = atomicAdd(&a.ticket[b], 1u) == (unsigned)a.tiles - 1u;
  }
  __syncthreads();
  if (last && warp == 0) {
    __threadfence();
    const volatile float* p = a.part + 2 * b * a.tiles;
    float e = 0.f, g = 0.f;
    for (int k = lane; k < a.tiles; k += 32) {
      e += p[2 * k];
      g += p[2 * k + 1];
    }
    e = warp_sum(e);
    g = warp_sum(g);
    if (lane == 0) {
      a.eta[b] = e;
      a.conv[b] = e <= kDirectRtolSq * (1.f + g) ? 1 : 0;
    }
  }
  epi_stamp(3);
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

// Row 6's stamps of the last call (the source's note) into
// out[kRevStamps]; returns how many were written, or 0 in a build without
// GATO_STAGE_STAMPS.
int gato_thomas_rev_stamps(unsigned long long* out) {
#ifdef GATO_STAGE_STAMPS
  int n = 0;
  if (cudaMemcpyFromSymbol(&n, gato::rev_stamp_count, sizeof(int)) != cudaSuccess ||
      cudaMemcpyFromSymbol(out, gato::rev_stamps, sizeof(gato::rev_stamps)) != cudaSuccess)
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

// Row 6's plan mirrors (kernels/thomas_batch.py): a reverse walk CTA's
// and an epilogue CTA's dynamic shared memory, in bytes.
long long gato_thomas_rev_smem_bytes(int s, int walks) { return gato::rev_smem_bytes(s, walks); }
long long gato_thomas_epi_smem_bytes(int s, int c) { return gato::epi_smem_bytes(s, c); }

// Launches row 6 on `stream` for B problems, on the stacks of
// gato_thomas_fwd: the walks, `walks` a CTA (kernels/thomas_batch.py's
// rev_walks_per_cta), then the epilogue, B ceil(K / kEpiKnots) CTAs;
// scratch holds 2 B ceil(K / kEpiKnots) + B floats.  Returns the CUDA
// error code of the launches (0 on success); nothing is synchronised.
int gato_thomas_rev(const float* Cinv, const float* bhat, const float* Qinv,
                    const float* Rinv, const float* phi, const float* theta,
                    const float* gam, const float* q, const float* A,
                    const float* Bm, const float* r, float* lam, float* dzx,
                    float* dzu, int* conv, float* eta, float* scratch, int B, int K,
                    int s, int cdim, int walks, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (K + gato::kEpiKnots - 1) / gato::kEpiKnots;
  float* part = scratch;
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch + 2LL * B * tiles);
  gato::RevArrays a{Cinv, bhat, Qinv, Rinv, phi, theta, gam, q, A, Bm, r, lam, dzx, dzu,
                    conv, eta, part, ticket, B, K, s, cdim, walks, tiles};
  const int kw = gato::walk_width(s);
  const void* walk = kw == 14   ? (const void*)gato::thomas_rev_walk_kernel<14>
                     : kw == 16 ? (const void*)gato::thomas_rev_walk_kernel<16>
                                : (const void*)gato::thomas_rev_walk_kernel<32>;
  const void* epi = kw == 14   ? (const void*)gato::thomas_rev_epilogue_kernel<14>
                    : kw == 16 ? (const void*)gato::thomas_rev_epilogue_kernel<16>
                               : (const void*)gato::thomas_rev_epilogue_kernel<32>;
  const size_t wsmem = (size_t)gato::rev_smem_bytes(s, walks);
  const size_t esmem = (size_t)gato::epi_smem_bytes(s, cdim);
  cudaError_t err = gato::opt_in_smem(walk, wsmem);
  if (err == cudaSuccess) err = gato::opt_in_smem(epi, esmem);
  if (err != cudaSuccess) return (int)err;
#ifdef GATO_STAGE_STAMPS
  gato::rev_stamp_reset<<<1, 1, 0, st>>>();
#endif
  const unsigned blocks = (unsigned)((B + walks - 1) / walks);
  if (kw == 14)
    gato::thomas_rev_walk_kernel<14><<<blocks, 32 * walks, wsmem, st>>>(a);
  else if (kw == 16)
    gato::thomas_rev_walk_kernel<16><<<blocks, 32 * walks, wsmem, st>>>(a);
  else
    gato::thomas_rev_walk_kernel<32><<<blocks, 32 * walks, wsmem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned eblocks = (unsigned)((long long)B * tiles);
  const unsigned ethreads = 32 * gato::kEpiKnots;
  if (kw == 14)
    gato::thomas_rev_epilogue_kernel<14><<<eblocks, ethreads, esmem, st>>>(a);
  else if (kw == 16)
    gato::thomas_rev_epilogue_kernel<16><<<eblocks, ethreads, esmem, st>>>(a);
  else
    gato::thomas_rev_epilogue_kernel<32><<<eblocks, ethreads, esmem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
