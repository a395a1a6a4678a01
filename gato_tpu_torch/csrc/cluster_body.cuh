// The per-problem body of kernel B (fused_solve.cu) and the farm kernel
// (fused_sequence.cu): condense, preconditioner, PCG and recovery for one
// problem, run by one thread-block cluster of C CTAs (C in 1, 2, 4, 8, 16).
//
// Layout.  CTA r of a cluster owns the contiguous knots [k0, k1) with
// k0 = r K / C (knot_begin): ranges balanced to within one knot.  Knot
// k >= 1 also owns the interval k-1 (R_{k-1}, B_{k-1}, dz_u_{k-1}).  A
// CTA keeps one record per own knot: S_k (L = phi_k, D = theta_k,
// U = phi_{k+1}^T), Pinv_k (three blocks), Qinv_k, Rinv_{k-1} and
// B_{k-1} Rinv_{k-1}: 7 s^2 + c^2 + s c floats, 6,076 B at IIWA.  The
// records sit in the CTA's own shared memory when they fit beside the rest
// of its plan (cluster_smem_floats), else in a global scratch slice of
// the problem: one pointer choice for the launch (`ops_in_smem`), one code.
// The CTA's range of the PCG vectors, the halo rows of its two neighbours
// and the Gauss-Jordan pivot rows are always in shared memory.
//
// Halos.  Knot k0 needs its left neighbour's Qinv_{k0-1} for phi_{k0}:
// each CTA inverts Q_{k0-1} itself as one more matrix of its Gauss-Jordan
// batch (the same arithmetic, so the same bits as the owner's).  The
// symmetric stair needs theta^{-1} of both neighbouring knots: each CTA
// pushes its first and last theta_k^{-1} into its neighbours' shared
// memory (distributed shared memory, cluster.map_shared_rank) before one
// cluster barrier.  Every other halo is pushed the same way, never pulled:
// the boundary rows of S p and of the preconditioned residual y go to the
// neighbours before the reduction barrier that follows them, and each CTA
// then forms the new halo rows of r and p itself, with the same fmaf the
// owner uses (r_next = r - alpha ups, p_next = y + beta p), into double
// buffers.  A poly_degree > 1 preconditioner takes two more barriers a
// degree.  So a PCG iteration of degree 1 has two cluster barriers, both
// the dot products' reductions.
//
// Dot products: each CTA's partial is summed over its warps in a fixed
// order (a shuffle tree in each warp, then the warps in turn), and lanes
// 0..C-1 of warp 0 push it into slot `rank` of every CTA
// of the cluster; after the barrier every thread of every CTA adds the C
// slots in rank order.  So every CTA holds the same bits of alpha, beta and
// eta, takes the same exit, and a run is deterministic.  The loop is the
// PCG of gato_tpu/kernels/pcg_pallas.py::pcg_loop: its update order, the
// exit test on |r . M r| < exit_tol, the 0-based exit index (max_iters when
// the test never fires), alpha = 0 when p.Sp = 0, beta = 0 when eta = 0 and
// Horner form for poly_degree > 1.  A problem with a clamped zero pivot in
// a live Q or R block (the flag is OR-ed over the cluster with the first
// reduction) is frozen: no iteration, lambda_0 kept, max_iters, not
// converged, eta = 1e30.
//
// Indexing: a thread takes a (knot, row) pair and loops over columns (the
// Gauss-Jordan's pivot-row division a (matrix, column) pair).  s and c are
// template parameters for IIWA (14, 7) and the pendulum (2, 1); <0, 0>
// reads them at run time (s, c <= kMaxWidth = 32).  No 64-bit division
// anywhere, and every product is an explicit fmaf in float32.
//
// Wide bodies (kS > kMaxWidth; kernel B's <36, 12>, a quadruped's
// whole-body state and controls): a row of 36 no longer fits the registers
// that __launch_bounds__(384, 1) leaves (168) four or five times over, as
// the condensation's and the stair's rows do at 14.  So condense_rows_wide
// and stair_rows_wide hold only the row that later sums read (phi_k's,
// B Rinv's, theta_k^{-1}'s and one product row) and store theta_k's,
// phi_{k+1}^T's and the stair's blocks kWideChunk columns at a time as they
// are made, and the Gauss-Jordan runs one warp a matrix with [M | I] in
// registers (gauss_jordan.cuh's gj_invert_warp).  Every entry is the same
// fmaf chain in the same order as the narrow code's, so the sums, the exit
// and the determinism are the same; only when each store happens differs.
//
// The farm: one cluster a stream walks t = 0..T-1, a cluster barrier
// between steps; step t's lambda stays in the CTAs' shared memory (an area
// the next Gauss-Jordan does not touch) and, with the halo rows pushed
// before the recovery, is step t+1's lambda_0.  A step computes what
// kernel B computes for the same inputs, lambda_0, rho and C, bit for bit.
//
// With GATO_STAGE_STAMPS defined (tools/stage_split.py builds that way;
// the default build does not), CTA 0 stamps %globaltimer at the start and
// after each stage (kStamps points).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "gauss_jordan.cuh"
#include "smem_limit.cuh"

namespace gato {
namespace cl {

namespace cg = cooperative_groups;

enum Precond { kJacobi = 0, kBlockJacobi = 1, kStair = 2 };

constexpr int kMaxCluster = 16;
// Threads a CTA at most: __launch_bounds__(384, 1) leaves ptxas up to 168
// registers a thread; the <14, 7> and <36, 12> builds take all 168 (spills
// of 4 to 12 bytes at <14, 7>, 120 at <36, 12>; fused_solve.cu).
constexpr int kMaxThreads = 384;
// The widest s, c of the generic <0, 0> body (its row arrays' size).
constexpr int kMaxWidth = 32;
// Columns of a row stored at once by the wide bodies (a divisor of their s).
constexpr int kWideChunk = 12;
constexpr float kFrozenEta = 1e30f;
// Fixed area at the start of the dynamic shared memory, in 4-byte words:
// 32 warp partials, 2 x 16 reduction slots, 16 flag slots, the CTA's flag.
constexpr int kRed = 0, kSlots = 32, kFlagSlots = 64, kBad = 80;
constexpr int kFixedFloats = 96;
// Vectors with halo rows; all but kLam live in the union area.
enum Vec { kLam = 0, kR0, kR1, kP0, kP1, kY, kUps, kTmp, kNumVec };

// ---- The plan (host and device; mirrored in kernels/fused_solve.py) ----

inline __host__ __device__ int knot_begin(int K, int C, int r) {
  return (int)(((long long)r * K) / C);
}
inline __host__ __device__ int cluster_knots(int K, int C) {
  return (K + C - 1) / C;
}
inline __host__ __device__ long long record_floats(int s, int c) {
  return 7LL * s * s + (long long)c * c + (long long)s * c;
}
// Threads a CTA: one a row of its Gauss-Jordan batch (its knots, plus the
// halo Q_{k0-1} when C > 1), a whole number of warps, from 64 to 384.
inline __host__ __device__ int cluster_threads(int K, int s, int c, int C) {
  const int w = s > c ? s : c;
  int t = ((cluster_knots(K, C) + (C > 1 ? 1 : 0)) * w + 31) / 32 * 32;
  return t < 64 ? 64 : (t > kMaxThreads ? kMaxThreads : t);
}
// Gauss-Jordan area: [M | I] of each matrix of a round, its pivot row and
// its zero-pivot mark.
inline __host__ __device__ long long gj_area_floats(int count, int n, int nt) {
  int chunk = nt / n;
  if (chunk > count) chunk = count;
  return gj_round_floats(chunk, n);
}
// Dynamic shared memory of one CTA, in floats: the fixed area, the
// records (ops_in_smem), lambda's rows, the halo rows of the eight vectors
// and three halo blocks, and a union of the Gauss-Jordan pivot rows and
// the seven other vectors with the recovery's dz_u temporary.
inline __host__ __device__ long long cluster_smem_floats(int K, int s, int c,
                                                         int C, int ops_in_smem) {
  const int kn = cluster_knots(K, C), nt = cluster_threads(K, s, c, C);
  long long gj = gj_area_floats(kn + 1, s, nt);
  const long long gjc = gj_area_floats(kn, c, nt);
  if (gjc > gj) gj = gjc;
  const long long vec = 7LL * kn * s + (long long)kn * c;
  return kFixedFloats + (ops_in_smem ? kn * record_floats(s, c) : 0) +
         (long long)kn * s + 2LL * kNumVec * s + 3LL * s * s + (gj > vec ? gj : vec);
}
// 1 iff the records fit in shared memory at this C under `limit` bytes.
inline __host__ __device__ int cluster_ops_in_smem(int K, int s, int c, int C,
                                                   long long limit) {
  return cluster_smem_floats(K, s, c, C, 1) * 4 <= limit;
}
inline __host__ __device__ int cluster_fits(int K, int s, int c, int C,
                                            long long limit) {
  return C <= K && cluster_smem_floats(K, s, c, C, 0) * 4 <= limit;
}
// The cluster size the launchers use for B problems (or streams): the
// largest C that fits with B C <= n_sms, but never below the floor, the
// smallest C whose records fit shared memory (else the smallest C that
// fits); 0 if none fits.  kernels/fused_solve.py's cluster_size gives the
// reasons.
inline __host__ __device__ int cluster_size(int B, int K, int s, int c,
                                            int n_sms, long long limit) {
  int floor = 0, any = 0, pick = 0;
  for (int C = 1; C <= kMaxCluster; C *= 2) {
    if (!cluster_fits(K, s, c, C, limit)) continue;
    if (any == 0) any = C;
    if (floor == 0 && cluster_ops_in_smem(K, s, c, C, limit)) floor = C;
    if ((long long)B * C <= n_sms) pick = C;
  }
  if (floor == 0) floor = any;
  return pick > floor ? pick : floor;
}

// The launch configuration of `kernel` for `clusters` clusters of C CTAs
// of `threads` threads and `smem` bytes of dynamic shared memory (C = 16 is
// non-portable).
template <class Kernel>
cudaError_t launch_config_sized(Kernel kernel, int clusters, int C, int threads,
                                size_t smem, cudaStream_t stream,
                                cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  // The attributes are set once a kernel and device (and again for a
  // larger size): a launch of a shape seen before pays no attribute call.
  cudaError_t err = raise_smem_limit((const void*)kernel, smem, true);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)clusters * (unsigned)C);
  cfg->blockDim = dim3((unsigned)threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// The launch configuration of `kernel` (kernel B or the farm kernel) for
// `clusters` clusters of C CTAs at (K, s, c): the plan's threads and
// shared memory.
template <class Kernel>
cudaError_t launch_config(Kernel kernel, int clusters, int K, int s, int c,
                          int C, int ops_in_smem, cudaStream_t stream,
                          cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  return launch_config_sized(kernel, clusters, C, cluster_threads(K, s, c, C),
                             (size_t)cluster_smem_floats(K, s, c, C, ops_in_smem) * 4,
                             stream, cfg, attr);
}

// Clusters of `kernel` the card holds at once (cudaOccupancyMaxActiveClusters)
// for a launch configured as launch_config_sized does; 0 means such a
// cluster cannot run, a negative value is a negated CUDA error.
template <class Kernel>
int max_active_clusters_sized(Kernel kernel, int C, int threads, size_t smem) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = launch_config_sized(kernel, 1, C, threads, smem, nullptr, &cfg, &attr);
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// The same for kernel B or the farm kernel at (K, s, c).
template <class Kernel>
int max_active_clusters(Kernel kernel, int K, int s, int c, int C, int ops_in_smem) {
  return max_active_clusters_sized(kernel, C, cluster_threads(K, s, c, C),
                                   (size_t)cluster_smem_floats(K, s, c, C, ops_in_smem) * 4);
}

// ---- Device helpers ----

// Stamps: start, Q and R inverted, condensed (S), theta inverted,
// preconditioned, PCG set up, PCG done, recovered.
constexpr int kStamps = 9;
#ifdef GATO_STAGE_STAMPS
static __device__ unsigned long long stage_stamps[kStamps];
__device__ __forceinline__ void stamp(int i) {
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    stage_stamps[i] = t;
  }
}
#else
__device__ __forceinline__ void stamp(int) {}
#endif

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// A CTA's view of its problem: geometry, its shared-memory areas and the
// problem's global slices.
struct Ctx {
  int K, s, c, C, rank, k0, k1, kn, tid, nt;
  int recsz;
  float* rec;    // own knot records, knot k0 first (shared or global)
  float* lam;    // own lambda rows (kn s), persistent across farm steps
  float* halo;   // kNumVec x [left s | right s]
  float* hb;     // theta^{-1}_{k0-1}, theta^{-1}_{k1}, Qinv_{k0-1}
  float* uni;    // union area
  float* fixed;  // reduction area
  int par;       // reduction slot parity
};

__device__ __forceinline__ void csync(const Ctx& x) {
  if (x.C > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

template <typename T>
__device__ __forceinline__ T* peer(const Ctx& x, T* p, int r) {
  return x.C > 1 ? cg::this_cluster().map_shared_rank(p, (unsigned)r) : p;
}

__device__ __forceinline__ float* vec(const Ctx& x, int v) {
  return v == kLam ? x.lam : x.uni + (long long)(v - 1) * x.kn * x.s;
}
__device__ __forceinline__ float* hleft(const Ctx& x, int v) { return x.halo + 2 * v * x.s; }
__device__ __forceinline__ float* hright(const Ctx& x, int v) { return x.halo + (2 * v + 1) * x.s; }

// Writes value `val` of own row (kl, a) of vector v into the neighbours'
// halo rows where kl is a boundary knot of this CTA.
__device__ __forceinline__ void push_row(const Ctx& x, int v, int kl, int a,
                                         float val) {
  if (kl == 0 && x.rank > 0) peer(x, hright(x, v), x.rank - 1)[a] = val;
  if (kl == x.kn - 1 && x.rank < x.C - 1) peer(x, hleft(x, v), x.rank + 1)[a] = val;
}

// Sum over the cluster of every thread's `part`, the same bits in every
// thread of every CTA; with `flag`, also ORs *flag over the cluster into
// it.  Contains one cluster barrier (which also synchronises the CTA).
__device__ __forceinline__ float cluster_sum(Ctx& x, float part, int* flag = nullptr) {
  float* red = x.fixed + kRed;
  float* slot = x.fixed + kSlots + 16 * x.par;
  int* fslot = reinterpret_cast<int*>(x.fixed + kFlagSlots);
  const int lane = x.tid & 31, warp = x.tid >> 5;
  part = warp_sum(part);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  if (warp == 0 && lane < x.C) {
    // Each of these lanes adds the warps' partials in the same order.
    float w = red[0];
    for (int i = 1; i < (x.nt >> 5); ++i) w += red[i];
    peer(x, slot, lane)[x.rank] = w;
    if (flag != nullptr) peer(x, fslot, lane)[x.rank] = *flag;
  }
  csync(x);
  float total = slot[0];
  for (int r = 1; r < x.C; ++r) total += slot[r];
  if (flag != nullptr) {
    int any = 0;
    for (int r = 0; r < x.C; ++r) any |= fslot[r];
    *flag = any;
  }
  x.par ^= 1;
  return total;
}

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

// One knot-indexed block-tridiagonal operator of a CTA: own knot kl's three
// s x s blocks (L, D, U) at base + kl stride (in the records, or a global
// tensor).
struct Blocks {
  const float* base;
  int stride;
};

// Row a of knot kl (knot k = k0 + kl) of M x: L_k x_{k-1} + D_k x_k +
// U_k x_{k+1}, the neighbours' rows from the halo of vector v.
template <int kS>
__device__ __forceinline__ float btd_row(const Ctx& x, Blocks M, int v, int kl,
                                         int a) {
  const int s = kS > 0 ? kS : x.s;
  const int ss = s * s, k = x.k0 + kl;
  const float* X = vec(x, v);
  const float* row = M.base + (long long)kl * M.stride + a * s;
  float left = 0.f, right = 0.f;
  if (k > 0) left = dot<kS>(row, kl == 0 ? hleft(x, v) : X + (kl - 1) * s, s);
  const float mid = dot<kS>(row + ss, X + kl * s, s);
  if (k < x.K - 1)
    right = dot<kS>(row + 2 * ss, kl == x.kn - 1 ? hright(x, v) : X + (kl + 1) * s, s);
  return (left + right) + mid;
}

// Dot of a[0..n) with column j of the row-major n-wide matrix M, in order.
template <int kN>
__device__ __forceinline__ float dot_col(const float* a, const float* M, int j,
                                         int n) {
  float acc = 0.f;
  if (kN > 0) {
#pragma unroll
    for (int e = 0; e < kN; ++e) acc = fmaf(a[e], M[e * kN + j], acc);
  } else {
    for (int e = 0; e < n; ++e) acc = fmaf(a[e], M[e * n + j], acc);
  }
  return acc;
}

// Gauss-Jordan inverses of `count` n x n matrices (gauss_jordan.cuh's
// gj_invert_smem) with this CTA's threads, in the union area.
template <int kN>
__device__ __forceinline__ void gj_invert(const Ctx& x, const float* src,
                                       int src_stride, float* dst,
                                       int dst_stride, float* dst0, int count,
                                       int n_rt, float rho, int* bad) {
  gj_invert_smem<kN>(x.uni, x.tid, x.nt, src, src_stride, dst, dst_stride, dst0,
                     count, n_rt, rho, bad);
}

// One problem's slices of the inputs and outputs:
// Q (K, s, s), R (K-1, c, c), A (K-1, s, s), Bm (K-1, s, c), q, cv, lam_out,
// dzx (K, s), r, dzu (K-1, c); lam0 (K, s) or null for the farm's carry;
// one int, bool and float at iters, conv, eta.
struct Problem {
  const float *Q, *R, *A, *Bm, *q, *r, *cv, *lam0;
  float *lam_out, *dzx, *dzu;
  int* iters;
  bool* conv;
  float* eta;
};

// The Ctx of this CTA for records of `recsz` floats a knot: in shared
// memory (`scratch` null) or in the problem's global slice `scratch`, then
// lambda's rows, the halo rows, `hb_floats` floats of halo blocks and the
// union area.
__device__ __forceinline__ Ctx make_ctx_layout(float* smem, float* scratch, int K,
                                               int s, int c, int C, int recsz,
                                               int hb_floats) {
  Ctx x;
  x.K = K;
  x.s = s;
  x.c = c;
  x.C = C;
  x.rank = C > 1 ? (int)cg::this_cluster().block_rank() : 0;
  x.k0 = knot_begin(K, C, x.rank);
  x.k1 = knot_begin(K, C, x.rank + 1);
  x.kn = x.k1 - x.k0;
  x.tid = threadIdx.x;
  x.nt = blockDim.x;
  x.recsz = recsz;
  const int kmax = cluster_knots(K, C);
  x.fixed = smem;
  float* p = smem + kFixedFloats;
  if (scratch == nullptr) {
    x.rec = p;
    p += (long long)kmax * x.recsz;
  } else {
    x.rec = scratch + (long long)x.k0 * x.recsz;
  }
  x.lam = p;
  p += kmax * s;
  x.halo = p;
  p += 2 * kNumVec * s;
  x.hb = p;
  p += hb_floats;
  x.uni = p;
  x.par = 0;
  return x;
}

// The Ctx of kernel B's and the farm's CTA; `scratch` is the problem's
// global record slice or null when the records are in shared memory.
__device__ __forceinline__ Ctx make_ctx(float* smem, float* scratch, int K,
                                        int s, int c, int C) {
  return make_ctx_layout(smem, scratch, K, s, c, C, (int)record_floats(s, c), 3 * s * s);
}

// Preconditioned residual of vector `rv` into y: y = P r, then Horner
// y += P (r - S y) for poly_degree - 1 rounds; y's (and tmp's) boundary
// rows go to the neighbours.  Returns this thread's partial r . y.
template <int kS>
__device__ __forceinline__ float precond_pass(Ctx& x, Blocks Sm, Blocks Pm, int rv,
                                              int poly) {
  const int s = kS > 0 ? kS : x.s;
  const int rows = x.kn * s;
  const float* r = vec(x, rv);
  float* y = vec(x, kY);
  float* tmp = vec(x, kTmp);
  float part = 0.f;
  for (int t = x.tid; t < rows; t += x.nt) {
    const int kl = t / s, a = t - kl * s;
    const float v = btd_row<kS>(x, Pm, rv, kl, a);
    y[t] = v;
    push_row(x, kY, kl, a, v);
    if (poly == 1) part = fmaf(r[t], v, part);
  }
  for (int d = 1; d < poly; ++d) {
    csync(x);
    for (int t = x.tid; t < rows; t += x.nt) {
      const int kl = t / s, a = t - kl * s;
      const float v = r[t] - btd_row<kS>(x, Sm, kY, kl, a);
      tmp[t] = v;
      push_row(x, kTmp, kl, a, v);
    }
    csync(x);
    for (int t = x.tid; t < rows; t += x.nt) {
      const int kl = t / s, a = t - kl * s;
      const float v = y[t] + btd_row<kS>(x, Pm, kTmp, kl, a);
      y[t] = v;
      push_row(x, kY, kl, a, v);
      if (d == poly - 1) part = fmaf(r[t], v, part);
    }
  }
  return part;
}

// The stages of one problem's solve on this CTA's knots, each ending
// synchronised (the CTA; the cluster where it says so).  Kernel B and the
// farm kernel run them all (cluster_body); kernel A (pcg.cu) the PCG
// stage on given operators; row 4 (direct_fused.cu) stages 1, 2, 4 and 6
// around its cyclic reduction.  Record offsets: S 0, Pinv 3ss (row 4: the
// working copy W of S), Qinv 6ss, Rinv 7ss, B Rinv 7ss + cc.

// 1. (Q_k + rho I)^{-1} for own knots and Q_{k0-1}; (R_{k-1} + rho I)^{-1}
// for own intervals.  kStamp: kernel B's stamps 1 and 2.
template <int kS, int kC, bool kStamp>
__device__ __forceinline__ void invert_qr(const Ctx& x, const Problem& pb, float rho,
                                          int* bad) {
  const int s = kS > 0 ? kS : x.s, c = kC > 0 ? kC : x.c;
  const int ss = s * s, cc2 = c * c, k0 = x.k0;
  const int oQi = 6 * ss, oRi = 7 * ss;
  const int kq0 = k0 > 0 ? k0 - 1 : 0;
  gj_invert<kS>(x, pb.Q + (long long)kq0 * ss, ss,
                x.rec + oQi - (kq0 < k0 ? x.recsz : 0), x.recsz,
                kq0 < k0 ? x.hb + 2 * ss : nullptr, x.k1 - kq0, s, rho, bad);
  if (kStamp) stamp(1);
  const int ki0 = k0 > 0 ? k0 : 1;  // first own knot with an interval
  gj_invert<kC>(x, pb.R + (long long)(ki0 - 1) * cc2, cc2,
                x.rec + (long long)(ki0 - k0) * x.recsz + oRi, x.recsz, nullptr,
                x.k1 - ki0, c, rho, bad);
  if (kStamp) stamp(2);
}

// Row 4's code for condense_rows: S's blocks also into the Pinv slot (the
// working copy W), no preconditioner.
constexpr int kCopyW = -1;

// 2. S: phi_k, B_{k-1} Rinv_{k-1} and theta_k from row a of each, phi_{k+1}^T;
// scalar Jacobi's Pinv, and block Jacobi's zero off-diagonal blocks (kCopyW:
// W = S instead).  A thread reads everything its row needs before it
// writes any of it, so that its loads overlap (a store through a generic
// pointer may alias them).
template <int kS, int kC>
__device__ __forceinline__ void condense_rows(const Ctx& x, const Problem& pb,
                                              int precond) {
  constexpr int kCapS = kS > 0 ? kS : kMaxWidth;
  constexpr int kCapC = kC > 0 ? kC : kMaxWidth;
  const int s = kS > 0 ? kS : x.s, c = kC > 0 ? kC : x.c;
  const int ss = s * s, sc = s * c, cc2 = c * c;
  const int K = x.K, k0 = x.k0, rows = x.kn * s;
  const int oP = 3 * ss, oQi = 6 * ss, oRi = 7 * ss, oBR = 7 * ss + cc2;
  for (int t = x.tid; t < rows; t += x.nt) {
    const int kl = t / s, a = t - kl * s, k = k0 + kl;
    float* Rk = x.rec + (long long)kl * x.recsz;
    const float* Qi = Rk + oQi;
    float ph[kCapS], th[kCapS], ut[kCapS], br[kCapC];
    if (k > 0) {
      const float* Ap = pb.A + (long long)(k - 1) * ss;
      const float* Bp = pb.Bm + (long long)(k - 1) * sc;
      const float* Qp = kl == 0 ? x.hb + 2 * ss : Rk - x.recsz + oQi;
      float ar[kCapS], brow[kCapC];
#pragma unroll
      for (int e = 0; e < s; ++e) ar[e] = Ap[a * s + e];
#pragma unroll
      for (int e = 0; e < c; ++e) brow[e] = Bp[a * c + e];
#pragma unroll
      for (int j = 0; j < s; ++j) ph[j] = dot_col<kS>(ar, Qp, j, s);
#pragma unroll
      for (int j = 0; j < c; ++j) br[j] = dot_col<kC>(brow, Rk + oRi, j, c);
#pragma unroll
      for (int j = 0; j < s; ++j) {
        const float t1 = dot<kS>(ph, Ap + j * s, s);
        const float t2 = dot<kC>(br, Bp + j * c, c);
        th[j] = (t1 + t2) + Qi[a * s + j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < s; ++j) {
        ph[j] = 0.f;
        th[j] = Qi[a * s + j];
      }
    }
    if (k < K - 1) {
      const float* Ak = pb.A + (long long)k * ss;
      float qc[kCapS];
#pragma unroll
      for (int e = 0; e < s; ++e) qc[e] = Qi[e * s + a];
#pragma unroll
      for (int j = 0; j < s; ++j) ut[j] = dot<kS>(Ak + j * s, qc, s);
    } else {
#pragma unroll
      for (int j = 0; j < s; ++j) ut[j] = 0.f;
    }
    float dinv = 0.f;
    if (precond == kJacobi) {
      float d = 0.f;
#pragma unroll
      for (int j = 0; j < s; ++j)
        if (j == a) d = th[j];
      dinv = 1.f / (d != 0.f ? d : 1.f);
    }
#pragma unroll
    for (int j = 0; j < s; ++j) {
      Rk[a * s + j] = ph[j];
      Rk[ss + a * s + j] = th[j];
      Rk[2 * ss + a * s + j] = ut[j];
    }
    if (k > 0) {
#pragma unroll
      for (int j = 0; j < c; ++j) Rk[oBR + a * c + j] = br[j];
    }
    if (precond == kCopyW) {
#pragma unroll
      for (int j = 0; j < s; ++j) {
        Rk[oP + a * s + j] = ph[j];
        Rk[oP + ss + a * s + j] = th[j];
        Rk[oP + 2 * ss + a * s + j] = ut[j];
      }
    } else if (precond != kStair) {
#pragma unroll
      for (int j = 0; j < s; ++j) {
        Rk[oP + a * s + j] = 0.f;
        Rk[oP + 2 * ss + a * s + j] = 0.f;
      }
    }
    if (precond == kJacobi) {
#pragma unroll
      for (int j = 0; j < s; ++j) Rk[oP + ss + a * s + j] = j == a ? dinv : 0.f;
    }
  }
  __syncthreads();
}

// 2, for kS > kMaxWidth (kernel B only: no kCopyW).  The same entries as
// condense_rows; phi_k's and B Rinv's rows stay in registers for theta_k's
// sums, and theta_k's and phi_{k+1}^T's rows are stored kWideChunk columns
// at a time.  theta_k's diagonal entry is kept for scalar Jacobi.
template <int kS, int kC>
__device__ __forceinline__ void condense_rows_wide(const Ctx& x, const Problem& pb,
                                                   int precond) {
  static_assert(kS % kWideChunk == 0, "a wide body's s is a multiple of kWideChunk");
  constexpr int s = kS, c = kC, ss = s * s, sc = s * c, cc2 = c * c;
  constexpr int oP = 3 * ss, oQi = 6 * ss, oRi = 7 * ss, oBR = 7 * ss + cc2;
  constexpr int kW = kWideChunk;
  const int K = x.K, k0 = x.k0, rows = x.kn * s;
  for (int t = x.tid; t < rows; t += x.nt) {
    const int kl = t / s, a = t - kl * s, k = k0 + kl;
    float* Rk = x.rec + (long long)kl * x.recsz;
    const float* Qi = Rk + oQi;
    float d = 0.f;
    if (k > 0) {
      const float* Ap = pb.A + (long long)(k - 1) * ss;
      const float* Bp = pb.Bm + (long long)(k - 1) * sc;
      const float* Qp = kl == 0 ? x.hb + 2 * ss : Rk - x.recsz + oQi;
      float ph[kS], br[kC];
      {
        float ar[kS];
#pragma unroll
        for (int e = 0; e < s; ++e) ar[e] = Ap[a * s + e];
#pragma unroll
        for (int j = 0; j < s; ++j) ph[j] = dot_col<kS>(ar, Qp, j, s);
      }
      {
        float brow[kC];
#pragma unroll
        for (int e = 0; e < c; ++e) brow[e] = Bp[a * c + e];
#pragma unroll
        for (int j = 0; j < c; ++j) br[j] = dot_col<kC>(brow, Rk + oRi, j, c);
      }
#pragma unroll 1
      for (int j0 = 0; j0 < s; j0 += kW) {
        float th[kW];
#pragma unroll
        for (int jj = 0; jj < kW; ++jj) {
          const int j = j0 + jj;
          const float t1 = dot<kS>(ph, Ap + j * s, s);
          const float t2 = dot<kC>(br, Bp + j * c, c);
          th[jj] = (t1 + t2) + Qi[a * s + j];
        }
#pragma unroll
        for (int jj = 0; jj < kW; ++jj) {
          Rk[ss + a * s + j0 + jj] = th[jj];
          if (j0 + jj == a) d = th[jj];
        }
      }
#pragma unroll
      for (int j = 0; j < s; ++j) Rk[a * s + j] = ph[j];
#pragma unroll
      for (int j = 0; j < c; ++j) Rk[oBR + a * c + j] = br[j];
    } else {
      d = Qi[a * s + a];
#pragma unroll 1
      for (int j = 0; j < s; ++j) {
        Rk[a * s + j] = 0.f;
        Rk[ss + a * s + j] = Qi[a * s + j];
      }
    }
    if (k < K - 1) {
      const float* Ak = pb.A + (long long)k * ss;
      float qc[kS];
#pragma unroll
      for (int e = 0; e < s; ++e) qc[e] = Qi[e * s + a];
#pragma unroll 1
      for (int j0 = 0; j0 < s; j0 += kW) {
        float ut[kW];
#pragma unroll
        for (int jj = 0; jj < kW; ++jj) ut[jj] = dot<kS>(Ak + (j0 + jj) * s, qc, s);
#pragma unroll
        for (int jj = 0; jj < kW; ++jj) Rk[2 * ss + a * s + j0 + jj] = ut[jj];
      }
    } else {
#pragma unroll 1
      for (int j = 0; j < s; ++j) Rk[2 * ss + a * s + j] = 0.f;
    }
    if (precond != kStair) {
#pragma unroll 1
      for (int j = 0; j < s; ++j) {
        Rk[oP + a * s + j] = 0.f;
        Rk[oP + 2 * ss + a * s + j] = 0.f;
      }
    }
    if (precond == kJacobi) {
      const float dinv = 1.f / (d != 0.f ? d : 1.f);
#pragma unroll 1
      for (int j = 0; j < s; ++j) Rk[oP + ss + a * s + j] = j == a ? dinv : 0.f;
    }
  }
  __syncthreads();
}

// 3b, the stair's off-diagonal blocks for kS > kMaxWidth: the entries of
// cluster_body's narrow loop, theta_k^{-1}'s row and one product row in
// registers, each block stored kWideChunk columns at a time.
template <int kS>
__device__ __forceinline__ void stair_rows_wide(const Ctx& x) {
  constexpr int s = kS, ss = s * s, oP = 3 * ss, kW = kWideChunk;
  const int K = x.K, k0 = x.k0, kn = x.kn, rows = kn * s;
  for (int t = x.tid; t < rows; t += x.nt) {
    const int kl = t / s, a = t - kl * s, k = k0 + kl;
    float* Rk = x.rec + (long long)kl * x.recsz;
    float ti[kS], tr[kS];
#pragma unroll
    for (int e = 0; e < s; ++e) ti[e] = Rk[oP + ss + a * s + e];
#pragma unroll 1
    for (int side = 0; side < 2; ++side) {
      // side 0: the L block, -(theta_k^{-1} phi_k) theta_{k-1}^{-1};
      // side 1: the U block, -(theta_k^{-1} phi_{k+1}^T) theta_{k+1}^{-1}.
      float* out = Rk + oP + 2 * side * ss + a * s;
      if (side == 0 ? k == 0 : k == K - 1) {
#pragma unroll 1
        for (int j = 0; j < s; ++j) out[j] = 0.f;
        continue;
      }
      const float* nb = side == 0 ? (kl == 0 ? x.hb : Rk - x.recsz + oP + ss)
                                  : (kl == kn - 1 ? x.hb + ss : Rk + x.recsz + oP + ss);
      const float* blk = Rk + 2 * side * ss;
#pragma unroll
      for (int j = 0; j < s; ++j) tr[j] = dot_col<kS>(ti, blk, j, s);
#pragma unroll 1
      for (int j0 = 0; j0 < s; j0 += kW) {
        float pv[kW];
#pragma unroll
        for (int jj = 0; jj < kW; ++jj) pv[jj] = -dot_col<kS>(tr, nb, j0 + jj, s);
#pragma unroll
        for (int jj = 0; jj < kW; ++jj) out[j0 + jj] = pv[jj];
      }
    }
  }
}

// 4. gamma of own rows into g: Qinv_k q_k + phi_k q_{k-1} + B_{k-1}
// Rinv_{k-1} r_{k-1} - c_k.  Does not end synchronised.
template <int kS, int kC>
__device__ __forceinline__ void gamma_rows(const Ctx& x, const Problem& pb, float* g) {
  const int s = kS > 0 ? kS : x.s, c = kC > 0 ? kC : x.c;
  const int ss = s * s, cc2 = c * c, rows = x.kn * s;
  const int oQi = 6 * ss, oBR = 7 * ss + cc2;
  for (int t = x.tid; t < rows; t += x.nt) {
    const int kl = t / s, a = t - kl * s, k = x.k0 + kl;
    const float* Rk = x.rec + (long long)kl * x.recsz;
    const float* qk = pb.q + (long long)k * s;
    float v = dot<kS>(Rk + oQi + a * s, qk, s);
    if (k > 0) {
      const float t1 = dot<kS>(Rk + a * s, qk - s, s);
      const float t2 = dot<kC>(Rk + oBR + a * c, pb.r + (long long)(k - 1) * c, c);
      v = (t1 + t2) + v;
    }
    g[t] = v - pb.cv[(long long)k * s + a];
  }
}

// 5a. PCG set-up on S lambda = gamma (gamma in r = vector kR0, lambda_0 in
// lambda with its halo rows): r = gamma - S lambda_0, y = M r, p = y.
// Returns eta = r . y, summed over the cluster; with `bad`, ORs *bad over
// the cluster into it.  Ends synchronised.
template <int kS>
__device__ __forceinline__ float pcg_setup(Ctx& x, Blocks Sm, Blocks Pm, int poly,
                                           int* bad) {
  const int s = kS > 0 ? kS : x.s;
  const int rows = x.kn * s;
  {
    float* r0 = vec(x, kR0);
    for (int t = x.tid; t < rows; t += x.nt) {
      const int kl = t / s, a = t - kl * s;
      const float v = r0[t] - btd_row<kS>(x, Sm, kLam, kl, a);
      r0[t] = v;
      push_row(x, kR0, kl, a, v);
    }
  }
  csync(x);
  float part = precond_pass<kS>(x, Sm, Pm, kR0, poly);
  {
    float* p0 = vec(x, kP0);
    const float* y = vec(x, kY);
    for (int t = x.tid; t < rows; t += x.nt) p0[t] = y[t];
  }
  const float eta = cluster_sum(x, part, bad);
  for (int t = x.tid; t < 2 * s; t += x.nt) hleft(x, kP0)[t] = hleft(x, kY)[t];
  __syncthreads();
  return eta;
}

// 5b. The PCG loop from pcg_setup's state: lambda in place, *iters the
// exit index (max_iters when the test never fires), *conv; returns |eta|.
template <int kS>
__device__ __forceinline__ float pcg_loop(Ctx& x, Blocks Sm, Blocks Pm, float eta,
                                          float exit_tol, int max_iters, int poly,
                                          int* iters, int* conv) {
  const int s = kS > 0 ? kS : x.s;
  const int rows = x.kn * s;
  float* lam = x.lam;
  *iters = max_iters;
  *conv = 0;
  int cur = 0;
  float* ups = vec(x, kUps);
  const float* y = vec(x, kY);
  for (int it = 0; it < max_iters; ++it) {
    const int pc = kP0 + cur, pn = kP0 + (cur ^ 1);
    const int rc = kR0 + cur, rn = kR0 + (cur ^ 1);
    float* P = vec(x, pc);
    float part = 0.f;
    for (int t = x.tid; t < rows; t += x.nt) {
      const int kl = t / s, a = t - kl * s;
      const float u = btd_row<kS>(x, Sm, pc, kl, a);
      ups[t] = u;
      push_row(x, kUps, kl, a, u);
      part = fmaf(P[t], u, part);
    }
    const float nu = cluster_sum(x, part);
    const float alpha = nu != 0.f ? eta / nu : 0.f;
    {
      const float* Rc = vec(x, rc);
      float* Rn = vec(x, rn);
      for (int t = x.tid; t < rows; t += x.nt) {
        lam[t] = fmaf(alpha, P[t], lam[t]);
        Rn[t] = fmaf(-alpha, ups[t], Rc[t]);
      }
      for (int t = x.tid; t < 2 * s; t += x.nt)
        hleft(x, rn)[t] = fmaf(-alpha, hleft(x, kUps)[t], hleft(x, rc)[t]);
    }
    __syncthreads();
    part = precond_pass<kS>(x, Sm, Pm, rn, poly);
    const float eta_new = cluster_sum(x, part);
    const float beta = eta != 0.f ? eta_new / eta : 0.f;
    {
      float* Pn = vec(x, pn);
      for (int t = x.tid; t < rows; t += x.nt) Pn[t] = fmaf(beta, P[t], y[t]);
      for (int t = x.tid; t < 2 * s; t += x.nt)
        hleft(x, pn)[t] = fmaf(beta, hleft(x, pc)[t], hleft(x, kY)[t]);
    }
    __syncthreads();
    cur ^= 1;
    eta = eta_new;
    if (fabsf(eta_new) < exit_tol) {
      *iters = it;
      *conv = 1;
      break;
    }
  }
  return fabsf(eta);
}

// 6a. Lambda's boundary rows into the neighbours' halo rows (also the
// farm's next lambda_0 halo); a cluster barrier must follow.
__device__ __forceinline__ void push_lam(const Ctx& x) {
  for (int t = x.tid; t < x.kn * x.s; t += x.nt) {
    const int kl = t / x.s, a = t - kl * x.s;
    push_row(x, kLam, kl, a, x.lam[t]);
  }
}

// 6b. Recovery of own rows after push_lam and a cluster barrier: dz_x =
// Qinv (q - lam - A^T lam_next), dz_u = Rinv (r - B^T lam_next), with
// lam_out.  Uses vector kR0 and the union area past the seven vectors.
template <int kS, int kC>
__device__ __forceinline__ void recover_rows(const Ctx& x, const Problem& pb) {
  const int s = kS > 0 ? kS : x.s, c = kC > 0 ? kC : x.c;
  const int ss = s * s, sc = s * c;
  const int K = x.K, k0 = x.k0, kn = x.kn, rows = kn * s;
  const int oQi = 6 * ss, oRi = 7 * ss;
  const float* lam = x.lam;
  float* rx = vec(x, kR0);
  float* ru = x.uni + 7LL * kn * s;
  const int ki0 = k0 > 0 ? k0 : 1;
  const int nint = x.k1 - ki0;
  for (int t = x.tid; t < rows; t += x.nt) {
    const int kl = t / s, a = t - kl * s, k = k0 + kl;
    float at = 0.f;
    if (k < K - 1) {
      const float* Ak = pb.A + (long long)k * ss + a;
      const float* ln = kl == kn - 1 ? hright(x, kLam) : lam + (kl + 1) * s;
      for (int e = 0; e < s; ++e) at = fmaf(Ak[e * s], ln[e], at);
    }
    rx[t] = (pb.q[(long long)k * s + a] - lam[t]) - at;
  }
  for (int t = x.tid; t < nint * c; t += x.nt) {
    const int u = t / c, a = t - u * c, j = ki0 - 1 + u;  // interval j
    const float* Bk = pb.Bm + (long long)j * sc + a;
    const float* ln = lam + (j + 1 - k0) * s;
    float bt = 0.f;
    for (int e = 0; e < s; ++e) bt = fmaf(Bk[e * c], ln[e], bt);
    ru[t] = pb.r[(long long)j * c + a] - bt;
  }
  __syncthreads();
  for (int t = x.tid; t < rows; t += x.nt) {
    const int kl = t / s, a = t - kl * s;
    const float* Rk = x.rec + (long long)kl * x.recsz;
    pb.dzx[(long long)k0 * s + t] = dot<kS>(Rk + oQi + a * s, rx + kl * s, s);
    pb.lam_out[(long long)k0 * s + t] = lam[t];
  }
  for (int t = x.tid; t < nint * c; t += x.nt) {
    const int u = t / c, a = t - u * c, j = ki0 - 1 + u;
    const float* Rk = x.rec + (long long)(j + 1 - k0) * x.recsz;
    pb.dzu[(long long)j * c + a] = dot<kC>(Rk + oRi + a * c, ru + u * c, c);
  }
}

// One problem's whole solve on this CTA's knots.  `smem` is the dynamic
// shared memory of cluster_smem_floats(K, s, c, C, scratch == null) floats;
// `scratch` the problem's K records in global memory, or null.  A farm
// runs it again on the same smem with pb.lam0 null: lambda_0 is then the
// previous run's lambda, in place.
template <int kS, int kC>
__device__ void cluster_body(const Problem& pb, float* smem, float* scratch,
                             int K, int s_rt, int c_rt, int C, float rho,
                             float exit_tol, int max_iters, int poly, int precond) {
  constexpr int kCapS = kS > 0 ? kS : kMaxWidth;
  const int s = kS > 0 ? kS : s_rt, c = kC > 0 ? kC : c_rt;
  const int ss = s * s;
  Ctx x = make_ctx(smem, scratch, K, s, c, C);
  const int kn = x.kn, k0 = x.k0, rows = kn * s;
  const int oP = 3 * ss;
  int* bad = reinterpret_cast<int*>(x.fixed + kBad);
  if (x.tid == 0) *bad = 0;
  __syncthreads();
  stamp(0);

  invert_qr<kS, kC, true>(x, pb, rho, bad);
  if constexpr (kS > kMaxWidth)
    condense_rows_wide<kS, kC>(x, pb, precond);
  else
    condense_rows<kS, kC>(x, pb, precond);
  stamp(3);

  // 3. theta_k^{-1} into Pinv[k][1]; the stair's off-diagonal blocks
  // -(theta_k^{-1} phi_k) theta_{k-1}^{-1} and
  // -(theta_k^{-1} phi_{k+1}^T) theta_{k+1}^{-1}, the neighbours' inverses
  // pushed into hb.
  if (precond != kJacobi) {
    gj_invert<kS>(x, x.rec + ss, x.recsz, x.rec + oP + ss, x.recsz, nullptr, kn,
                  s, 0.f, nullptr);
  }
  stamp(4);
  if (precond == kStair) {
    for (int t = x.tid; t < ss; t += x.nt) {
      if (x.rank > 0) peer(x, x.hb + ss, x.rank - 1)[t] = x.rec[oP + ss + t];
      if (x.rank < C - 1)
        peer(x, x.hb, x.rank + 1)[t] = x.rec[(long long)(kn - 1) * x.recsz + oP + ss + t];
    }
    csync(x);
    if constexpr (kS > kMaxWidth) {
      stair_rows_wide<kS>(x);
    } else {
      for (int t = x.tid; t < rows; t += x.nt) {
        const int kl = t / s, a = t - kl * s, k = k0 + kl;
        float* Rk = x.rec + (long long)kl * x.recsz;
        float ti[kCapS], tr[kCapS], pl[kCapS], pu[kCapS];
#pragma unroll
        for (int e = 0; e < s; ++e) ti[e] = Rk[oP + ss + a * s + e];
        if (k > 0) {
          const float* tp = kl == 0 ? x.hb : Rk - x.recsz + oP + ss;
#pragma unroll
          for (int j = 0; j < s; ++j) tr[j] = dot_col<kS>(ti, Rk, j, s);
#pragma unroll
          for (int j = 0; j < s; ++j) pl[j] = -dot_col<kS>(tr, tp, j, s);
        } else {
#pragma unroll
          for (int j = 0; j < s; ++j) pl[j] = 0.f;
        }
        if (k < K - 1) {
          const float* tn = kl == kn - 1 ? x.hb + ss : Rk + x.recsz + oP + ss;
#pragma unroll
          for (int j = 0; j < s; ++j) tr[j] = dot_col<kS>(ti, Rk + 2 * ss, j, s);
#pragma unroll
          for (int j = 0; j < s; ++j) pu[j] = -dot_col<kS>(tr, tn, j, s);
        } else {
#pragma unroll
          for (int j = 0; j < s; ++j) pu[j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < s; ++j) {
          Rk[oP + a * s + j] = pl[j];
          Rk[oP + 2 * ss + a * s + j] = pu[j];
        }
      }
    }
  }
  __syncthreads();
  stamp(5);

  // 4. gamma into r; lambda_0 (kernel B: from global, with its halo rows;
  // the farm's carry: in place).
  gamma_rows<kS, kC>(x, pb, vec(x, kR0));
  if (pb.lam0 != nullptr) {
    for (int t = x.tid; t < rows; t += x.nt) x.lam[t] = pb.lam0[(long long)k0 * s + t];
    for (int t = x.tid; t < s; t += x.nt) {
      if (k0 > 0) hleft(x, kLam)[t] = pb.lam0[(long long)(k0 - 1) * s + t];
      if (x.k1 < K) hright(x, kLam)[t] = pb.lam0[(long long)x.k1 * s + t];
    }
  }
  __syncthreads();

  // 5. PCG.
  const Blocks Sm{x.rec, x.recsz}, Pm{x.rec + oP, x.recsz};
  float eta = pcg_setup<kS>(x, Sm, Pm, poly, bad);
  const bool frozen = *bad != 0;
  stamp(6);
  int iters = max_iters, conv = 0;
  if (frozen)
    eta = kFrozenEta;
  else
    eta = pcg_loop<kS>(x, Sm, Pm, eta, exit_tol, max_iters, poly, &iters, &conv);
  stamp(7);

  // 6. Recovery.
  push_lam(x);
  csync(x);
  recover_rows<kS, kC>(x, pb);
  if (x.tid == 0 && x.rank == 0) {
    *pb.iters = iters;
    *pb.conv = conv != 0;
    *pb.eta = eta;
  }
  stamp(8);
}

}  // namespace cl
}  // namespace gato
