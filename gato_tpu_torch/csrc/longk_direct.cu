// The long-horizon exact solve: block cyclic reduction of the condensed
// system S lambda = gamma, for horizons past row 4's shared memory.
//
// Replaces the solve stage of gato_tpu/kernels/longk.py's direct ladder:
//   cr_grid_kernel,         the inner kernel of _direct_xl_call (row 11,
//   cr_tail_kernel          pallas_call at :860) with _cr_solve_scratch, in
//                           up to three launches
//   peel_invert_kernel,     _peel_kernel (row 12, pallas_call at :1171),
//   peel_reduce_kernel      one compacting CR level, in two launches
//   unpeel_kernel           the back-substitution of a peeled level, which
//                           gato_tpu does in XLA (_cr_unpeel)
// Plain versions and wrappers: gato_tpu_torch/kernels/longk.py.  Layout:
// S (B, K, 3, s, s) row-major blocks, slots 0 = L (row k, column k-1),
// 1 = D, 2 = U (column k+1); vectors (B, K, s).
//
// Row 11.  The TPU kernel keeps one problem's whole operator in VMEM and
// runs every level there; a CTA's shared memory holds a problem's last
// ~71 rows at IIWA (kernels/longk.py's cr_tail_stride: the rows k = 0 mod
// ht), so the levels below ht run on a cooperative grid and the rest in
// one CTA a problem:
// * cr_grid_kernel<kUp = false>: levels h = 1 .. ht / 2 in place on a
//   working copy W of S (level 0 reads S and gamma, so S is never
//   written).  A level of few even rows is one grid barrier: each even row
//   goes to a group of 2-8 warps that inverts both its odd neighbours on two
//   warps at once, reduces the row with a thread an entry, and owns its
//   right neighbour's D^{-1} (stored into Dinv).  A level of more rows than
//   that has a warp invert each odd row into Dinv, a grid barrier, then a
//   warp reduce each even row from it.
// * cr_tail_kernel: one CTA of 512 threads a problem loads its rows k = 0
//   mod ht into shared memory and runs the remaining levels there with CTA
//   barriers (every odd row inverted in place by a warp; A and B, then the
//   reduced rows, a thread an entry), the root and these levels' back-
//   substitution, and writes x of its rows.
// * cr_grid_kernel<kUp = true>: the back-substitution of the grid levels,
//   a warp an odd row, a grid barrier a level.
// warp_gj_pad (warp_gj.cuh) inverts one block on a warp with no predicate
// on the width (padded to kN; IIWA's 14 compiled in) and the pivot row
// scaled by the correctly rounded reciprocal of the pivot; warp_back_row
// back-substitutes one odd row (direct.cr_back_level).
// * The peel (row 12) is one level that compacts, on row 11's level-0
//   bodies: peel_invert_kernel inverts every odd row of a batch into
//   D_o^{-1} (warp_gj_pad); peel_reduce_kernel copies each even row, its
//   neighbours' L, U, b and D^{-1} into its warp's shared memory at once
//   (cp.async) and reduces it there (warp_reduce_rows), writing the
//   ceil(W/2) reduced even rows into half-width buffers (no lane padding:
//   a level of W rows writes all of them, where the TPU kernel's chunk
//   schedule leaves tail lanes unwritten).  Row 11's one-meeting schedule
//   in one launch (a pair of warps an even row inverting both neighbours)
//   was slower on an H100 at every shape 'hybrid' peels (PERF.md §6).
//   The odd rows' L, U and b stay in the level's input, which the
//   caller keeps for unpeel_kernel (a warp an even row and the odd row
//   after it, its blocks in flight at once).
//
// A clamped zero pivot raises the problem's flag (bad, or the peel's per
// odd row flags): the caller adds gato_tpu's +1e30 to that problem's lambda
// and eta.  The kernels leave lambda unpoisoned, so the back-substitution
// of a peeled level never multiplies the poison.
//
// What bounds them on an H100: the levels together eliminate ~K odd rows
// and reduce ~K even rows, 2 s^3 + 12 s^3 flops a pair (an inverse, six
// s x s products), ~14 K s^3 in all, about twice block Thomas's ~6 K s^3;
// the operator (2,352 B a row at IIWA) moves through L2 a few times.  The
// first levels of a wide batch are bound by how many warps run at once
// (B = 15, K = 8192: 61,440 rows at level 0); a level of few rows by the
// latency of one inverse, two product phases and a barrier, which the
// tail pays in shared memory with CTA barriers.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_common.cuh"
#include "pcg_common.cuh"
#include "warp_gj.cuh"

namespace cg = cooperative_groups;

namespace gato {

constexpr int kCrThreads = 256;
constexpr int kCrWarps = kCrThreads / 32;
// Resident cooperative CTAs an SM takes, at most: every CTA arrives at
// every grid barrier.
constexpr int kCrMaxCtasPerSm = 4;
// Threads of row 11's tail CTA.
constexpr int kTailThreads = 512;

// With GATO_STAGE_STAMPS defined (gato_tpu_torch/tools/direct_stamps.py
// builds that way; the default build does not), block 0 of each of row
// 11's launches appends %globaltimer stamps: the grid levels' start and the
// end of each level, the tail's start, its rows loaded, each of its
// levels, its root, its back-substitution, then the end of each grid back
// level.
constexpr int kCrStamps = 64;
#ifdef GATO_STAGE_STAMPS
static __device__ unsigned long long cr_stamps[kCrStamps];
static __device__ int cr_stamp_count;
__global__ void cr_stamp_reset() { cr_stamp_count = 0; }
__device__ __forceinline__ void cr_stamp() {
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0 && cr_stamp_count < kCrStamps) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    cr_stamps[cr_stamp_count++] = t;
  }
}
#else
__device__ __forceinline__ void cr_stamp() {}
#endif

// Row 12's and the unpeel's stamps (gato_peel_stamps, under the same
// define): 0 and 1 the first CTA's start and the last CTA's end of the
// peel's first launch, 2 and 3 those of its second, 4 and 5 the unpeel's.
constexpr int kPeelStamps = 6;
#ifdef GATO_STAGE_STAMPS
static __device__ unsigned long long peel_stamps[kPeelStamps];
__global__ void peel_stamp_reset(int first, int n) {
  for (int i = first; i < first + n; ++i) peel_stamps[i] = i & 1 ? 0ULL : ~0ULL;
}
__device__ __forceinline__ void peel_stamp(int i) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (i & 1)
      atomicMax(&peel_stamps[i], t);
    else
      atomicMin(&peel_stamps[i], t);
  }
}
#else
__device__ __forceinline__ void peel_stamp(int) {}
#endif

// x_k = D_k^{-1} ((b_k - L_k x_l) - U_k x_r) of one odd row, x_r null past
// the end (direct.cr_back_level).  ws: the warp's shared memory.
__device__ void warp_back_row(const float* Lk, const float* Dinv,
                              const float* Uk, const float* bk,
                              const float* xl, const float* xr, float* xk,
                              int s, float* ws) {
  const int lane = threadIdx.x & 31;
  if (lane < s) {
    float lx = 0.f, ux = 0.f;
    for (int e2 = 0; e2 < s; ++e2) lx = fmaf(Lk[lane * s + e2], xl[e2], lx);
    if (xr != nullptr)
      for (int e2 = 0; e2 < s; ++e2) ux = fmaf(Uk[lane * s + e2], xr[e2], ux);
    ws[lane] = (bk[lane] - lx) - ux;
  }
  __syncwarp();
  if (lane < s) {
    float acc = 0.f;
    for (int e2 = 0; e2 < s; ++e2) acc = fmaf(Dinv[lane * s + e2], ws[e2], acc);
    xk[lane] = acc;
  }
  __syncwarp();
}

// (a, j) of X Y, X and Y n x n row-major (global or shared memory), the
// sum in e order (mm_entry's order).
template <int kN>
__device__ __forceinline__ float mm_at(const float* X, const float* Y, int n_rt, int a,
                                       int j) {
  const int n = width<kN>(n_rt);
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < kN; ++e)
    if (e < n) acc = fmaf(X[a * n + e], Y[e * n + j], acc);
  return acc;
}

// Row a of X times v, in order.
template <int kN>
__device__ __forceinline__ float mv_at(const float* X, const float* v, int n_rt, int a) {
  const int n = width<kN>(n_rt);
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < kN; ++e)
    if (e < n) acc = fmaf(X[a * n + e], v[e], acc);
  return acc;
}

// One block row: its L, D, U blocks (row-major, s x s, consecutive) and b.
struct Row {
  const float* blk;
  const float* b;
};

// The reduction of an even row given its odd neighbours' inverses, the
// algebra of direct.cr_level in warp_reduce_row's order:
//   A = L Dinv_l, B = U Dinv_r               (reduce_factor)
//   L' = -A L_l,  U' = -B U_r,  D' = (D - A U_l) - B L_r,
//   b' = (b - A b_l) - B b_r                 (reduce_entry)
// one entry a call, so that any group of threads (a warp's group in the
// grid, the tail's CTA) spreads a row's entries over its threads.  hl / hr
// say whether the left / right neighbour exists (where not, its entries are
// 0 and its pointers are not read; the tail passes pointers into its shared
// memory even then, so that its loads stay shared-memory loads).
// Entry e2 (< 2 n^2) of [A | B].
template <int kN>
__device__ __forceinline__ float reduce_factor(const float* blk, const float* DinvL, bool hl,
                                               const float* DinvR, bool hr, int n, int e2) {
  const int ss = n * n, e = e2 < ss ? e2 : e2 - ss, ai = e / n, j = e - ai * n;
  if (e2 < ss) return hl ? mm_at<kN>(blk, DinvL, n, ai, j) : 0.f;
  return hr ? mm_at<kN>(blk + 2 * ss, DinvR, n, ai, j) : 0.f;
}

// Entry t (< n^2 + n) of the reduced row given A and B: L', D', U' at t <
// n^2, else b'.  The outputs may alias the row's own blocks (entry t of D'
// and b' reads only entry t of D and b; L and U are read only by
// reduce_factor).
template <int kN>
__device__ __forceinline__ void reduce_entry(Row row, Row l, bool hl, Row r, bool hr,
                                             const float* A, const float* Bm, float* out,
                                             float* outb, int n, int t) {
  const int ss = n * n;
  if (t < ss) {
    const int ai = t / n, j = t - ai * n;
    float lv = 0.f, au = 0.f, u = 0.f, bl = 0.f;
    if (hl) {
      lv = mm_at<kN>(A, l.blk, n, ai, j);
      au = mm_at<kN>(A, l.blk + 2 * ss, n, ai, j);
    }
    if (hr) {
      bl = mm_at<kN>(Bm, r.blk, n, ai, j);
      u = mm_at<kN>(Bm, r.blk + 2 * ss, n, ai, j);
    }
    const float d = row.blk[ss + t];
    out[t] = -lv;
    out[ss + t] = (d - au) - bl;
    out[2 * ss + t] = -u;
  } else {
    const int ai = t - ss;
    const float ab = hl ? mv_at<kN>(A, l.b, n, ai) : 0.f;
    const float bb = hr ? mv_at<kN>(Bm, r.b, n, ai) : 0.f;
    outb[ai] = (row.b[ai] - ab) - bb;
  }
}

// The reduction of an even row by a group of threads (gtid of gthreads)
// given its odd neighbours' inverses (DinvL, DinvR; null where absent): A
// and B into the group's A, Bm, `sync`, the reduced row into out, outb,
// `sync`.
template <int kN, class Sync>
__device__ __forceinline__ void group_reduce(Row row, Row l, const float* DinvL, Row r,
                                             const float* DinvR, float* A, float* Bm,
                                             float* out, float* outb, int n, int gtid,
                                             int gthreads, Sync sync) {
  const int ss = n * n;
  const bool hl = DinvL != nullptr, hr = DinvR != nullptr;
  for (int t = gtid; t < 2 * ss; t += gthreads)
    (t < ss ? A[t] : Bm[t - ss]) = reduce_factor<kN>(row.blk, DinvL, hl, DinvR, hr, n, t);
  sync();
  for (int t = gtid; t < ss + n; t += gthreads)
    reduce_entry<kN>(row, l, hl, r, hr, A, Bm, out, outb, n, t);
  sync();
}

// acc[c] = (X Y)(a, j0 + c), c < kJ, X and Y n x n row-major: row a of X
// read once, each sum in e order (mm_at's bits).
template <int kN, int kJ>
__device__ __forceinline__ void row_times(const float* X, const float* Y, int n, int a,
                                          int j0, float (&acc)[kJ]) {
#pragma unroll
  for (int c = 0; c < kJ; ++c) acc[c] = 0.f;
#pragma unroll
  for (int e = 0; e < kN; ++e) {
    if (e < n) {
      const float x = X[a * n + e];
#pragma unroll
      for (int c = 0; c < kJ; ++c)
        if (j0 + c < n) acc[c] = fmaf(x, Y[e * n + j0 + c], acc[c]);
    }
  }
}

// group_reduce on one warp, for a level of more even rows than warps: a
// lane takes row a of each product and kJ of its columns (two lanes a row
// for kN <= 16), so that it loads a row of the left factor once for kJ
// sums instead of once a sum.  The same sums in the same order as
// group_reduce.  Ends after a __syncwarp.
template <int kN>
__device__ __forceinline__ void warp_reduce_rows(Row row, Row l, const float* DinvL, Row r,
                                                 const float* DinvR, float* A, float* Bm,
                                                 float* out, float* outb, int n_rt) {
  constexpr int kH = kN <= 16 ? 2 : 1, kJ = kN / kH;
  const int n = width<kN>(n_rt), ss = n * n;
  const int lane = threadIdx.x & 31, a = lane / kH, j0 = (lane % kH) * kJ;
  float p[kJ], q[kJ];
  if (a < n) {
    if (DinvL != nullptr) row_times<kN, kJ>(row.blk, DinvL, n, a, j0, p);
#pragma unroll
    for (int c = 0; c < kJ; ++c)
      if (j0 + c < n) A[a * n + j0 + c] = DinvL != nullptr ? p[c] : 0.f;
    if (DinvR != nullptr) row_times<kN, kJ>(row.blk + 2 * ss, DinvR, n, a, j0, p);
#pragma unroll
    for (int c = 0; c < kJ; ++c)
      if (j0 + c < n) Bm[a * n + j0 + c] = DinvR != nullptr ? p[c] : 0.f;
  }
  __syncwarp();
  if (a < n) {
    const int e0 = a * n + j0;
    if (DinvL != nullptr) row_times<kN, kJ>(A, l.blk, n, a, j0, p);
#pragma unroll
    for (int c = 0; c < kJ; ++c)
      if (j0 + c < n) out[e0 + c] = -(DinvL != nullptr ? p[c] : 0.f);
    if (DinvR != nullptr) row_times<kN, kJ>(Bm, r.blk + 2 * ss, n, a, j0, p);
#pragma unroll
    for (int c = 0; c < kJ; ++c)
      if (j0 + c < n) out[2 * ss + e0 + c] = -(DinvR != nullptr ? p[c] : 0.f);
    if (DinvL != nullptr) row_times<kN, kJ>(A, l.blk + 2 * ss, n, a, j0, p);
    if (DinvR != nullptr) row_times<kN, kJ>(Bm, r.blk, n, a, j0, q);
#pragma unroll
    for (int c = 0; c < kJ; ++c) {
      if (j0 + c < n) {
        const float au = DinvL != nullptr ? p[c] : 0.f, bl = DinvR != nullptr ? q[c] : 0.f;
        out[ss + e0 + c] = (row.blk[ss + e0 + c] - au) - bl;
      }
    }
  }
  if (lane < n) {
    const float ab = DinvL != nullptr ? mv_at<kN>(A, l.b, n, lane) : 0.f;
    const float bb = DinvR != nullptr ? mv_at<kN>(Bm, r.b, n, lane) : 0.f;
    outb[lane] = (row.b[lane] - ab) - bb;
  }
  __syncwarp();
}

// What row 11 reads and writes: S (B, K, 3, s, s) and gamma (B, K, s), read
// only; W (B, K, 3, s, s) and bv (B, K, s) the working system; Dinv (B, K,
// s, s) the odd rows' inverses of the grid levels; x (B, K, s) the
// solution; bad (B,) zeroed by the caller.  ht: the tail's stride (rows
// k = 0 mod ht go to the tail), a power of two.
struct CrArrays {
  const float* S;
  const float* gamma;
  float* W;
  float* bv;
  float* Dinv;
  float* x;
  int* bad;
  int B, K, s, ht;
};

// A group's shared scratch, in floats: Dinv of both neighbours, A and B.
inline __host__ __device__ int group_floats(int s) { return 4 * ((4 * s * s + 3) / 4); }

// A grid CTA's dynamic shared memory, in bytes: kCrWarps groups (one warp a
// group at most).
inline long long cr_grid_smem_bytes(int s) {
  return (long long)kCrWarps * group_floats(s) * (long long)sizeof(float);
}

// The tail's layout, in floats: `rows` rows of [L D U | b | x] (row_floats
// each), then A and B of the ceil(rows / 2) even rows of a level.
inline __host__ __device__ int tail_row_floats(int s) {
  return 4 * ((3 * s * s + 2 * s + 3) / 4);
}
inline __host__ __device__ long long tail_floats(int rows, int s) {
  return (long long)rows * tail_row_floats(s) + (long long)((rows + 1) / 2) * 2 * s * s;
}

// Warps of a group at a level of `tasks` even rows on `warps` resident
// warps: 8 (a CTA) down to 1, the most that still gives every task a group.
// GATO_CR_TWO_MEETINGS (tools/direct_stamps.py --two-meetings) makes it 1,
// every grid level two meetings, to time one schedule against the other.
__device__ __forceinline__ int group_warps(long long tasks, long long warps) {
#ifdef GATO_CR_TWO_MEETINGS
  return 1;
#else
  int g = kCrWarps;
  while (g > 1 && tasks * g > warps) g /= 2;
  return g;
#endif
}

// Row 11, the grid levels h = 1 .. ht / 2 (kUp false) or their back-
// substitution, h = ht / 2 .. 1 (kUp true), one cooperative launch each.
// A level of few even rows (at least two resident warps each) is one
// meeting: each even row k (k = 0 mod 2h) goes to a group of G >= 2 warps,
// warp 0 inverting its left odd neighbour's D and warp 1 its right one
// (an odd row is inverted twice, by identical arithmetic, in exchange for
// a grid barrier), which then reduces the row into W and owns its right
// neighbour k + h: it stores that row's D^{-1} into Dinv (and at level 0
// its L, U and b into W, bv), which no one reads before the back-
// substitution.  A level of more even rows than that is two meetings, as
// rows outnumber warps: a warp inverts each odd row into Dinv (level 0:
// and copies it), a grid barrier, a warp reduces each even row from Dinv
// (warp_reduce_rows).
// A back level gives each odd row to a warp.
template <int kN, bool kUp>
__global__ void __launch_bounds__(kCrThreads) cr_grid_kernel(CrArrays a) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int K = a.K, s = width<kN>(a.s), B = a.B;
  const size_t ss = (size_t)s * s, slot3 = 3 * ss;
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const long long warps = (long long)gridDim.x * kCrWarps;
  const long long warp = (long long)blockIdx.x * kCrWarps + wib;
  if (kUp) {
    float* ws = smem + wib * group_floats(s);
    for (int h = a.ht / 2; h >= 1; h /= 2) {
      const int h2 = 2 * h, n_odd = (K - 1 - h) / h2 + 1;
      for (long long t = warp; t < (long long)B * n_odd; t += warps) {
        const size_t b = t / n_odd;
        const int k = h + (int)(t % n_odd) * h2;
        const size_t row = b * K + k;
        const float* w = a.W + row * slot3;
        const float* xr = k + h < K ? a.x + (row + h) * s : nullptr;
        warp_back_row(w, a.Dinv + row * ss, w + 2 * ss, a.bv + row * s,
                      a.x + (row - h) * s, xr, a.x + row * s, s, ws);
      }
#ifndef GATO_STAGE_STAMPS
      if (h > 1)
#endif
      {
        grid.sync();
        cr_stamp();
      }
    }
    return;
  }
  cr_stamp();
  for (int h = 1; h < a.ht; h *= 2) {
    const int h2 = 2 * h, n_even = (K - 1) / h2 + 1, n_odd = (K - 1 - h) / h2 + 1;
    const long long tasks = (long long)B * n_even;
    const int G = group_warps(tasks, warps), g = wib / G, wig = wib - g * G;
    const bool two = G == 1;
    const int gtid = threadIdx.x - g * G * 32;
    float* scratch = smem + g * G * group_floats(s);
    const auto sync = [&]() {
      if (G == 1)
        __syncwarp();
      else
        asm volatile("bar.sync %0, %1;" ::"r"(1 + g), "r"(32 * G) : "memory");
    };
    const float* src = h == 1 ? a.S : a.W;
    const float* bsrc = h == 1 ? a.gamma : a.bv;
    if (two) {
      // Every odd row inverted into Dinv by a warp (level 0: and copied).
      for (long long t = warp; t < (long long)B * n_odd; t += warps) {
        const size_t b = t / n_odd;
        const size_t row = b * K + h + (size_t)(t % n_odd) * h2;
        const int hit = warp_gj_pad<kN>(src + row * slot3 + ss, a.Dinv + row * ss, s);
        if (lane == 0 && hit) a.bad[b] = 1;
        if (h == 1) {
          for (int e = lane; e < (int)ss; e += 32) {
            a.W[row * slot3 + e] = src[row * slot3 + e];
            a.W[row * slot3 + 2 * ss + e] = src[row * slot3 + 2 * ss + e];
          }
          if (lane < s) a.bv[row * s + lane] = bsrc[row * s + lane];
        }
      }
      grid.sync();
    }
    const long long groups = (long long)gridDim.x * (kCrWarps / G);
    for (long long t = blockIdx.x * (kCrWarps / G) + g; t < tasks; t += groups) {
      const size_t b = t / n_even;
      const int k = (int)(t % n_even) * h2;
      const size_t row = b * K + k;
      const bool hl = k >= h, hr = k + h < K;
      const float* DinvL = nullptr;
      const float* DinvR = nullptr;
      if (two) {
        if (hl) DinvL = a.Dinv + (row - h) * ss;
        if (hr) DinvR = a.Dinv + (row + h) * ss;
      } else {
        float* dl = scratch;
        float* dr = scratch + ss;
        int hit = 0;
        if (wig == 0 && hl) hit = warp_gj_pad<kN>(src + (row - h) * slot3 + ss, dl, s);
        if (wig == 1 && hr) hit = warp_gj_pad<kN>(src + (row + h) * slot3 + ss, dr, s);
        if (lane == 0 && hit) a.bad[b] = 1;
        sync();
        if (hr) {  // the right neighbour's owner
          const size_t o = row + h;
          for (int e = gtid; e < (int)ss; e += 32 * G) {
            a.Dinv[o * ss + e] = dr[e];
            if (h == 1) {
              a.W[o * slot3 + e] = src[o * slot3 + e];
              a.W[o * slot3 + 2 * ss + e] = src[o * slot3 + 2 * ss + e];
            }
          }
          if (h == 1 && gtid < s) a.bv[o * s + gtid] = bsrc[o * s + gtid];
        }
        if (hl) DinvL = dl;
        if (hr) DinvR = dr;
      }
      // At level 0 the odd rows' L, U and b are read from S, gamma (their
      // copies in W may still be in flight).
      const Row l{hl ? src + (row - h) * slot3 : nullptr, hl ? bsrc + (row - h) * s : nullptr};
      const Row r{hr ? src + (row + h) * slot3 : nullptr, hr ? bsrc + (row + h) * s : nullptr};
      if (two)
        warp_reduce_rows<kN>(Row{src + row * slot3, bsrc + row * s}, l, DinvL, r, DinvR,
                             scratch + 2 * ss, scratch + 3 * ss, a.W + row * slot3,
                             a.bv + row * s, s);
      else
        group_reduce<kN>(Row{src + row * slot3, bsrc + row * s}, l, DinvL, r, DinvR,
                         scratch + 2 * ss, scratch + 3 * ss, a.W + row * slot3,
                         a.bv + row * s, s, gtid, 32 * G, sync);
    }
#ifndef GATO_STAGE_STAMPS
    if (2 * h < a.ht)
#endif
    {
      grid.sync();
      cr_stamp();
    }
  }
}

// Row 11, the tail: one CTA a problem takes the rows k = 0 mod ht (the
// grid levels' output in W, bv; S, gamma when ht = 1) into shared memory
// and runs the remaining levels there, each as three CTA-barrier phases
// (every odd row inverted in place by a warp; A and B of every even row;
// the even rows reduced in place), then the root and the back-substitution
// of these levels, and writes x of its rows.
template <int kN>
__global__ void __launch_bounds__(kTailThreads) cr_tail_kernel(CrArrays a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int K = a.K, s = width<kN>(a.s), ht = a.ht;
  const int ss = s * s, rf = tail_row_floats(s);
  const int rows = (K - 1) / ht + 1;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, wib = tid >> 5;
  const int nw = nt >> 5;
  float* AB = sm + (size_t)rows * rf;
  const float* src = ht == 1 ? a.S : a.W;
  const float* bsrc = ht == 1 ? a.gamma : a.bv;
  cr_stamp();
  // The rows' blocks in 16-byte cp.async copies where both ends allow (an
  // even s), and b.
  const int q4 = (3 * ss) % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0
                     ? 3 * ss / 4 : 0;
  for (int t = tid; t < rows * q4; t += nt) {
    const int i = t / q4, q = t - i * q4;
    const size_t k = b * K + (size_t)i * ht;
    __pipeline_memcpy_async(sm + i * rf + 4 * q, src + k * 3 * ss + 4 * q, 16);
  }
  __pipeline_commit();
  const int rest = 3 * ss - 4 * q4 + s;
  for (int t = tid; t < rows * rest; t += nt) {
    const int i = t / rest, e = 4 * q4 + t - i * rest;
    const size_t k = b * K + (size_t)i * ht;
    sm[i * rf + e] = e < 3 * ss ? src[k * 3 * ss + e] : bsrc[k * s + e - 3 * ss];
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  cr_stamp();
  int bad = 0;
  const auto blk = [&](int i) { return sm + i * rf; };
  int h = 1;
  for (; h < rows; h *= 2) {
    const int h2 = 2 * h, n_odd = (rows - 1 - h) / h2 + 1, n_even = (rows - 1) / h2 + 1;
    for (int t = wib; t < n_odd; t += nw) {
      float* d = blk(h + t * h2) + ss;
      bad |= warp_gj_pad<kN>(d, d, s);
    }
    __syncthreads();
    // A and B of every even row, then every even row reduced: the group is
    // the CTA, its tasks the (even row, entry) pairs.
    for (int t = tid; t < n_even * 2 * ss; t += nt) {
      const int m = t / (2 * ss), i = m * h2;
      const bool hl = i >= h, hr = i + h < rows;
      AB[t] = reduce_factor<kN>(blk(i), blk(hl ? i - h : i) + ss, hl,
                                blk(hr ? i + h : i) + ss, hr, s, t - m * 2 * ss);
    }
    __syncthreads();
    for (int t = tid; t < n_even * (ss + s); t += nt) {
      const int m = t / (ss + s), i = m * h2;
      const bool hl = i >= h, hr = i + h < rows;
      const int il = hl ? i - h : i, ir = hr ? i + h : i;
      reduce_entry<kN>(Row{blk(i), blk(i) + 3 * ss}, Row{blk(il), blk(il) + 3 * ss}, hl,
                       Row{blk(ir), blk(ir) + 3 * ss}, hr, AB + m * 2 * ss,
                       AB + m * 2 * ss + ss, blk(i), blk(i) + 3 * ss, s, t - m * (ss + s));
    }
    __syncthreads();
    cr_stamp();
  }
  // The root: row 0 alone.
  if (wib == 0) {
    float* d = blk(0) + ss;
    bad |= warp_gj_pad<kN>(d, d, s);
    __syncwarp();
    if (lane < s) blk(0)[3 * ss + s + lane] = mv_at<kN>(d, blk(0) + 3 * ss, s, lane);
  }
  __syncthreads();
  cr_stamp();
  // Back-substitution: x_i = D_i^{-1} ((b_i - L_i x_{i-h}) - U_i x_{i+h}),
  // the bracket into b_i's slot first.
  for (h /= 2; h >= 1; h /= 2) {
    const int h2 = 2 * h, n_odd = (rows - 1 - h) / h2 + 1;
    for (int t = tid; t < n_odd * s; t += nt) {
      const int i = h + (t / s) * h2, ai = t % s;
      float* row = blk(i);
      const float lx = mv_at<kN>(row, blk(i - h) + 3 * ss + s, s, ai);
      const float ux = i + h < rows ? mv_at<kN>(row + 2 * ss, blk(i + h) + 3 * ss + s, s, ai)
                                    : 0.f;
      row[3 * ss + ai] = (row[3 * ss + ai] - lx) - ux;
    }
    __syncthreads();
    for (int t = tid; t < n_odd * s; t += nt) {
      const int i = h + (t / s) * h2, ai = t % s;
      float* row = blk(i);
      row[3 * ss + s + ai] = mv_at<kN>(row + ss, row + 3 * ss, s, ai);
    }
    __syncthreads();
  }
  cr_stamp();
  for (int t = tid; t < rows * s; t += nt) {
    const int i = t / s, ai = t - i * s;
    a.x[(b * K + (size_t)i * ht) * s + ai] = blk(i)[3 * ss + s + ai];
  }
  if (lane == 0 && bad) a.bad[b] = 1;
}

// Row 12's plan (mirrors in kernels/longk.py).  A reduction warp's staged
// rows, in floats: the even row's [L D U] and its neighbours' L and U (in
// the same places; their D is not copied), both neighbours' D^{-1}, A and
// B, then the three rows' b; every offset a multiple of 4 where s s is.
inline __host__ __device__ int peel_floats(int s) { return 4 * ((13 * s * s + 3 * s + 3) / 4); }

// Threads of a reduction CTA, a warp an even row.
constexpr int kPeelThreads = 128;

inline long long peel_smem_bytes(int s) {
  return (long long)(kPeelThreads / 32) * peel_floats(s) * (long long)sizeof(float);
}

// The unpeel's staged odd row, in floats: L_o, U_o, D_o^{-1}, b_o, x_half
// of both neighbours and the bracket (b_o - L_o xl) - U_o xr.
inline __host__ __device__ int unpeel_floats(int s) { return 4 * ((3 * s * s + 4 * s + 3) / 4); }

// Even row 2j of a peeled level (global row `row` = b W + 2j) and its
// neighbours' L, U and b into a warp's staged rows `w` by cp.async, one
// commit group; the caller waits.
__device__ __forceinline__ void peel_stage(const float* S, const float* bvec, size_t row,
                                           bool hl, bool hr, int s, float* w) {
  const size_t ss = (size_t)s * s, slot3 = 3 * ss;
  float* wb = w + 13 * ss;
  warp_async_copy(w, S + row * slot3, (int)slot3);
  warp_async_copy(wb, bvec + row * s, s);
  if (hl) {
    const float* o = S + (row - 1) * slot3;
    warp_async_copy(w + 3 * ss, o, (int)ss);
    warp_async_copy(w + 5 * ss, o + 2 * ss, (int)ss);
    warp_async_copy(wb + s, bvec + (row - 1) * s, s);
  }
  if (hr) {
    const float* o = S + (row + 1) * slot3;
    warp_async_copy(w + 6 * ss, o, (int)ss);
    warp_async_copy(w + 8 * ss, o + 2 * ss, (int)ss);
    warp_async_copy(wb + 2 * s, bvec + (row + 1) * s, s);
  }
  __pipeline_commit();
}

// Row 12, the peel of a level of W rows, its first launch: D_o^{-1} of every odd row 2j+1 into Doinv (B, W/2, s, s) and its
// clamp flag into flags (B, W/2), a warp a row on warp_gj_pad.
template <int kN>
__global__ void __launch_bounds__(kCrThreads)
peel_invert_kernel(const float* S, float* Doinv, int* flags, int B, int W, int s_rt) {
  const int s = width<kN>(s_rt), wo = W / 2;
  const size_t ss = (size_t)s * s;
  const long long t = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  peel_stamp(0);
  if (t < (long long)B * wo) {
    const size_t b = t / wo, j = t % wo;
    const int hit = warp_gj_pad<kN>(S + ((b * W + 2 * j + 1) * 3 + 1) * ss, Doinv + t * ss, s);
    if ((threadIdx.x & 31) == 0) flags[t] = hit;
  }
  peel_stamp(1);
}

// Row 12, its second launch: a warp an even row 2j, its rows,
// its neighbours' L, U, b and D^{-1} (from the first launch) copied into
// its shared memory at once, then reduced by warp_reduce_rows (a lane a
// product row and kJ columns; row 11's level-0 body) into row j of Sh
// (B, ceil(W/2), 3, s, s) and bh (B, ceil(W/2), s).
template <int kN>
__global__ void __launch_bounds__(kPeelThreads)
peel_reduce_kernel(const float* S, const float* bvec, const float* Doinv, float* Sh,
                   float* bh, int B, int W, int s_rt) {
  extern __shared__ float4 smem4[];
  const int s = width<kN>(s_rt), wo = W / 2, we = (W + 1) / 2;
  const size_t ss = (size_t)s * s;
  const long long t = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  peel_stamp(2);
  if (t < (long long)B * we) {
    float* w = reinterpret_cast<float*>(smem4) + (threadIdx.x >> 5) * peel_floats(s);
    const size_t b = t / we;
    const int j = (int)(t % we);
    const bool hl = j >= 1, hr = j < wo;
    peel_stage(S, bvec, b * W + 2 * j, hl, hr, s, w);
    if (hl) warp_async_copy(w + 9 * ss, Doinv + (b * wo + j - 1) * ss, (int)ss);
    if (hr) warp_async_copy(w + 10 * ss, Doinv + (b * wo + j) * ss, (int)ss);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();
    float* wb = w + 13 * ss;
    warp_reduce_rows<kN>(Row{w, wb}, Row{w + 3 * ss, wb + s}, hl ? w + 9 * ss : nullptr,
                         Row{w + 6 * ss, wb + 2 * s}, hr ? w + 10 * ss : nullptr, w + 11 * ss,
                         w + 12 * ss, Sh + t * 3 * ss, bh + t * s, s);
  }
  peel_stamp(3);
}

// The back-substitution of a peeled level: x (B, W, s) from the reduced
// system's solution xh (B, ceil(W/2), s), the level's input S, b and the
// peel's Doinv, a warp an even row j: x_{2j} = xh_j and, for the odd row
// after it, L_o, U_o, D_o^{-1}, b_o, xh_j and xh_{j+1} in flight into the
// warp's shared memory at once, then a lane a row:
// x_{2j+1} = D_o^{-1} ((b_o - L_o xh_j) - U_o xh_{j+1}) (warp_back_row's
// sums).
template <int kN>
__global__ void __launch_bounds__(kCrThreads)
unpeel_kernel(const float* S, const float* bvec, const float* Doinv, const float* xh,
              float* x, int B, int W, int s_rt) {
  extern __shared__ float4 smem4[];
  const int s = width<kN>(s_rt), wo = W / 2, we = (W + 1) / 2;
  const size_t ss = (size_t)s * s;
  const long long t = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  peel_stamp(4);
  if (t < (long long)B * we) {
    const int lane = threadIdx.x & 31;
    float* w = reinterpret_cast<float*>(smem4) + (threadIdx.x >> 5) * unpeel_floats(s);
    const size_t b = t / we;
    const int j = (int)(t % we);
    const size_t row = b * W + 2 * j;
    const bool odd = j < wo, hr = j + 1 < we;
    float* wv = w + 3 * ss;  // b_o, xl, xr, the bracket
    if (odd) {
      const float* o = S + (row + 1) * 3 * ss;
      warp_async_copy(w, o, (int)ss);
      warp_async_copy(w + ss, o + 2 * ss, (int)ss);
      warp_async_copy(w + 2 * ss, Doinv + (b * wo + j) * ss, (int)ss);
      warp_async_copy(wv, bvec + (row + 1) * s, s);
      warp_async_copy(wv + s, xh + t * s, s);
      if (hr) warp_async_copy(wv + 2 * s, xh + (t + 1) * s, s);
      __pipeline_commit();
    }
    if (lane < s) x[row * s + lane] = xh[t * s + lane];
    if (odd) {
      __pipeline_wait_prior(0);
      __syncwarp();
      if (lane < s) {
        const float lx = mv_at<kN>(w, wv + s, s, lane);
        const float ux = hr ? mv_at<kN>(w + ss, wv + 2 * s, s, lane) : 0.f;
        wv[3 * s + lane] = (wv[lane] - lx) - ux;
      }
      __syncwarp();
      if (lane < s) x[(row + 1) * s + lane] = mv_at<kN>(w + 2 * ss, wv + 3 * s, s, lane);
    }
  }
  peel_stamp(5);
}

// Resident CTAs of a cooperative kernel of kCrThreads threads and
// cr_grid_smem_bytes(s): blocks per SM (at most kCrMaxCtasPerSm) times
// SMs; 0 if none fits, a negative CUDA error code if a query fails.
inline int cr_resident_ctas(const void* kernel, int s) {
  const size_t smem = (size_t)cr_grid_smem_bytes(s);
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = opt_in_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kCrThreads, smem);
  if (err != cudaSuccess) return -(int)err;
  if (!coop) return -(int)cudaErrorNotSupported;
  if (per_sm > kCrMaxCtasPerSm) per_sm = kCrMaxCtasPerSm;
  return per_sm * sms;
}

template <int kN>
int cr_grid(int s) {
  const int down = cr_resident_ctas((const void*)cr_grid_kernel<kN, false>, s);
  const int up = cr_resident_ctas((const void*)cr_grid_kernel<kN, true>, s);
  return down < 0 ? down : (up < 0 ? up : (down < up ? down : up));
}

// Launches row 11 (its grid levels, tail and grid back levels) on `st`.
template <int kN>
cudaError_t cr_launch(CrArrays a, int grid_max, cudaStream_t st) {
  void* args[] = {&a};
  const long long tasks = (long long)a.B * ((a.K + 1) / 2);
  const unsigned grid = (unsigned)(tasks < grid_max ? tasks : grid_max);
  const size_t gsmem = (size_t)cr_grid_smem_bytes(a.s);
  cudaError_t err = cudaSuccess;
#ifdef GATO_STAGE_STAMPS
  cr_stamp_reset<<<1, 1, 0, st>>>();
#endif
  if (a.ht > 1) {
    if (grid_max < 1) return cudaErrorCooperativeLaunchTooLarge;
    const void* down = (const void*)cr_grid_kernel<kN, false>;
    err = opt_in_smem(down, gsmem);
    if (err == cudaSuccess)
      err = cudaLaunchCooperativeKernel(down, dim3(grid), dim3(kCrThreads), args, gsmem, st);
    if (err != cudaSuccess) return err;
  }
  const int rows = (a.K - 1) / a.ht + 1;
  const size_t tsmem = (size_t)tail_floats(rows, a.s) * sizeof(float);
  const void* tail = (const void*)cr_tail_kernel<kN>;
  err = opt_in_smem(tail, tsmem);
  if (err != cudaSuccess) return err;
  cr_tail_kernel<kN><<<a.B, kTailThreads, tsmem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.ht == 1) return err;
  const void* up = (const void*)cr_grid_kernel<kN, true>;
  err = opt_in_smem(up, gsmem);
  if (err == cudaSuccess)
    err = cudaLaunchCooperativeKernel(up, dim3(grid), dim3(kCrThreads), args, gsmem, st);
  return err;
}

// Blocks of kCrThreads for one warp per task.
inline unsigned warp_blocks(long long tasks) {
  return (unsigned)((tasks + kCrWarps - 1) / kCrWarps);
}

}  // namespace gato

extern "C" {

// Row 11's stamps of the last launch (block 0; %globaltimer, ns) into
// out[kCrStamps]; returns how many were written, or 0 in a build without
// GATO_STAGE_STAMPS.
int gato_longk_cr_stamps(unsigned long long* out) {
#ifdef GATO_STAGE_STAMPS
  int n = 0;
  if (cudaMemcpyFromSymbol(&n, gato::cr_stamp_count, sizeof(int)) != cudaSuccess ||
      cudaMemcpyFromSymbol(out, gato::cr_stamps, sizeof(gato::cr_stamps)) != cudaSuccess)
    return 0;
  return n;
#else
  (void)out;
  return 0;
#endif
}

// Row 12's and the unpeel's stamps of their last launches (the note at
// kPeelStamps; %globaltimer, ns) into out[kPeelStamps]; returns
// kPeelStamps, or 0 in a build without GATO_STAGE_STAMPS.
int gato_peel_stamps(unsigned long long* out) {
#ifdef GATO_STAGE_STAMPS
  if (cudaMemcpyFromSymbol(out, gato::peel_stamps, sizeof(gato::peel_stamps)) != cudaSuccess)
    return 0;
  return gato::kPeelStamps;
#else
  (void)out;
  return 0;
#endif
}

// Row 11's plan mirrors (kernels/longk.py): a grid CTA's dynamic shared
// memory and the tail's, in bytes.
long long gato_longk_cr_grid_smem_bytes(int s) { return gato::cr_grid_smem_bytes(s); }
long long gato_longk_cr_tail_smem_bytes(int rows, int s) {
  return gato::tail_floats(rows, s) * (long long)sizeof(float);
}

// Resident CTAs of row 11's cooperative kernels on the current device at
// block width s; 0 if none fits, a negative CUDA error code if a query
// fails.
int gato_longk_cr_grid(int s) {
  return s == 14 ? gato::cr_grid<14>(s)
                 : (s <= 16 ? gato::cr_grid<16>(s) : gato::cr_grid<32>(s));
}

// Launches row 11 on `stream`: x (B, K, s) with S x = gamma for B problems;
// rows k = 0 mod ht (a power of two, kernels/longk.py's cr_tail_stride) go
// to the tail; below it the grid levels, on up to grid_max CTAs
// (gato_longk_cr_grid), with W (B, K, 3, s, s), bv (B, K, s) and Dinv (B,
// K, s, s) scratch (unused, and may be null, when ht = 1); bad (B) zeroed
// ints.  Returns the CUDA error code (0 on success).
int gato_longk_cr(const float* S, const float* gamma, float* W, float* bv, float* Dinv,
                  float* x, int* bad, int B, int K, int s, int ht, int grid_max,
                  void* stream) {
  gato::CrArrays a{S, gamma, W, bv, Dinv, x, bad, B, K, s, ht};
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = s == 14   ? gato::cr_launch<14>(a, grid_max, st)
                          : s <= 16 ? gato::cr_launch<16>(a, grid_max, st)
                                    : gato::cr_launch<32>(a, grid_max, st);
  return (int)err;
}

// Row 12's and the unpeel's plan mirrors (kernels/longk.py): the dynamic
// shared memory of a CTA of the peel's reduction and of the unpeel, in
// bytes.
long long gato_longk_peel_smem_bytes(int s) { return gato::peel_smem_bytes(s); }
long long gato_longk_unpeel_smem_bytes(int s) {
  return (long long)gato::kCrWarps * gato::unpeel_floats(s) * (long long)sizeof(float);
}

// Launches row 12 on `stream` for a level of W >= 2 rows of B problems:
// Sh (B, ceil(W/2), 3, s, s), bh (B, ceil(W/2), s), Doinv (B, W/2, s, s)
// and flags (B, W/2), every entry written, in two launches: the odd rows'
// inverses, then the even rows' reductions.  Returns the CUDA error code
// (0 on success).
int gato_longk_peel(const float* S, const float* b, float* Sh, float* bh, float* Doinv,
                    int* flags, int B, int W, int s, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int kw = s == 14 ? 14 : (s <= 16 ? 16 : 32);
  const long long odd = (long long)B * (W / 2), even = (long long)B * ((W + 1) / 2);
#ifdef GATO_STAGE_STAMPS
  gato::peel_stamp_reset<<<1, 1, 0, st>>>(0, 4);
#endif
  const unsigned iblocks = gato::warp_blocks(odd);
  if (kw == 14)
    gato::peel_invert_kernel<14><<<iblocks, gato::kCrThreads, 0, st>>>(S, Doinv, flags, B, W, s);
  else if (kw == 16)
    gato::peel_invert_kernel<16><<<iblocks, gato::kCrThreads, 0, st>>>(S, Doinv, flags, B, W, s);
  else
    gato::peel_invert_kernel<32><<<iblocks, gato::kCrThreads, 0, st>>>(S, Doinv, flags, B, W, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int per = gato::kPeelThreads / 32;
  const size_t smem = (size_t)gato::peel_smem_bytes(s);
  const unsigned rblocks = (unsigned)((even + per - 1) / per);
  const void* k = kw == 14   ? (const void*)gato::peel_reduce_kernel<14>
                  : kw == 16 ? (const void*)gato::peel_reduce_kernel<16>
                             : (const void*)gato::peel_reduce_kernel<32>;
  err = gato::opt_in_smem(k, smem);
  if (err != cudaSuccess) return (int)err;
  if (kw == 14)
    gato::peel_reduce_kernel<14><<<rblocks, gato::kPeelThreads, smem, st>>>(S, b, Doinv, Sh, bh,
                                                                            B, W, s);
  else if (kw == 16)
    gato::peel_reduce_kernel<16><<<rblocks, gato::kPeelThreads, smem, st>>>(S, b, Doinv, Sh, bh,
                                                                            B, W, s);
  else
    gato::peel_reduce_kernel<32><<<rblocks, gato::kPeelThreads, smem, st>>>(S, b, Doinv, Sh, bh,
                                                                            B, W, s);
  return (int)cudaGetLastError();
}

// Launches the back-substitution of a peeled level on `stream`: x (B, W, s)
// from xh (B, ceil(W/2), s) and the level's S, b and Doinv.  Returns the
// CUDA error code.
int gato_longk_unpeel(const float* S, const float* b, const float* Doinv, const float* xh,
                      float* x, int B, int W, int s, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int kw = s == 14 ? 14 : (s <= 16 ? 16 : 32);
  const unsigned blocks = gato::warp_blocks((long long)B * ((W + 1) / 2));
  const size_t smem = (size_t)gato_longk_unpeel_smem_bytes(s);
  const void* k = kw == 14   ? (const void*)gato::unpeel_kernel<14>
                  : kw == 16 ? (const void*)gato::unpeel_kernel<16>
                             : (const void*)gato::unpeel_kernel<32>;
  const cudaError_t err = gato::opt_in_smem(k, smem);
  if (err != cudaSuccess) return (int)err;
#ifdef GATO_STAGE_STAMPS
  gato::peel_stamp_reset<<<1, 1, 0, st>>>(4, 2);
#endif
  if (kw == 14)
    gato::unpeel_kernel<14><<<blocks, gato::kCrThreads, smem, st>>>(S, b, Doinv, xh, x, B, W, s);
  else if (kw == 16)
    gato::unpeel_kernel<16><<<blocks, gato::kCrThreads, smem, st>>>(S, b, Doinv, xh, x, B, W, s);
  else
    gato::unpeel_kernel<32><<<blocks, gato::kCrThreads, smem, st>>>(S, b, Doinv, xh, x, B, W, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
