// The long-horizon PCG tier: condensation, PCG, condensation + PCG in one
// launch, and dz recovery, for horizons whose PCG vectors do not fit one
// block's shared memory (past kernels A and B, K*s above ~9,600 floats).
//
// Replaces gato_tpu/kernels/longk.py's PCG tiers:
//   condense_longk_kernel  _condense_kernel (row 7, pallas_call at :352)
//   pcg_longk_kernel       the inner kernel of _pcg_xl_call (row 8, :430)
//                          and _pcg_stream_kernel (row 10, :661)
//   fused_longk_kernel     _fused_xl_kernel (row 9, :547)
//   recover_longk_kernel   _recover_kernel (row 13, :1464)
// Plain versions and wrappers: gato_tpu_torch/kernels/longk.py.
//
// Design.  Several thread blocks (CTAs) share one problem, each owning a
// contiguous range of knots.
//
// * Condensation works in tiles of up to kTileKnots knots.  The TPU kernel
//   walks lane chunks in order and carries the one-knot dependency (phi,
//   theta, theta^{-1} of the chunk's last knot) between grid steps; CUDA
//   blocks run in no order, so a tile instead recomputes, in its own shared
//   memory, the neighbour knots it needs: two to the left (theta_{k0-1}
//   needs phi_{k0-1} = A_{k0-2} Qinv_{k0-2}) and one to the right (theta_k1
//   for the stair).  Tiles are independent, and the stair's next-neighbour
//   block -theta_k^{-1} phi_{k+1}^T theta_{k+1}^{-1} is computed directly,
//   as kernel B does, with no lane shift.  The stages are condense.cuh's
//   (gj_invert, condense_products, gamma_row) run on the tile's window; a
//   recomputed knot gets the same bits as in the tile that owns it.
// * PCG (rows 8 and 10 compute one function; the TPU split them by whether
//   the operators fit VMEM) is the original's cooperative parallelPCG: one
//   cooperative launch, its grid sized by the occupancy query so that every
//   CTA is resident, a range of CTAs per problem, the vectors in global
//   memory (L2-resident: 5 vectors of 458 KB at IIWA, K = 8192), S and Pinv
//   read from global memory on every matvec (4,704 B a knot at IIWA: 38.5
//   MB at K = 8192, which the 50 MB L2 may hold; whether they stay there is
//   the cache's business).  A vector that a CTA's neighbours read is
//   written before a grid barrier: four barriers an iteration (after S p,
//   after the lambda / r update, after M r, after the p update) and two
//   more per Horner term.  A dot product is a block sum per CTA written to
//   global memory; after the barrier every CTA of the problem sums its
//   problem's partials in one fixed order, so all of them see the same eta
//   and take the same exit decision, and a run is deterministic.  A problem
//   that has left the loop keeps meeting the barriers; the loop ends when
//   every problem of the launch has left, read from a counter that is only
//   written between the third and fourth barriers.  More problems than
//   resident CTAs run in rounds, one launch each.
// * The fused kernel condenses every tile of its problem (CTA j takes tiles
//   j, j + per, ...), meets a grid barrier, and runs the same PCG.
// * Recovery is knot-parallel: a block reads lambda_{k+1} of the knot past
//   its range directly (no shifted copy), through condense.cuh's
//   recover_dz on its window, the last-row rule included.
//
// What bounds them on an H100.  The PCG loop streams S and Pinv (2 * 3 K s^2
// floats) per iteration at ~0.5 flop a byte: bytes, from L2 or device
// memory; at short K and B = 1 the grid barriers (four an iteration) are
// the floor.  Condensation is ~25 s^3 flops a knot on Gauss-Jordan and
// small products with __syncthreads between pivots; recovery is a pass over
// Qinv, Rinv, A and B.
//
// Shapes are runtime values: s, c <= 32 (the wrapper checks).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "condense.cuh"
#include "grid_common.cuh"

namespace cg = cooperative_groups;

namespace gato {

constexpr int kLongkThreads = kGridThreads;
// Own knots of a condensation tile, at most, and the shared memory a tile
// aims to stay under (three tiles of 74 KB share an SM at IIWA).
constexpr int kTileKnots = 8;
constexpr long long kTileBudgetBytes = 100 * 1024;
// Knots of one recovery block.
constexpr int kRecoverKnots = 32;

enum LongkPrecond { kLkJacobi = 0, kLkBlockJacobi = 1, kLkStair = 2 };

// Shared-memory layout of a condensation tile of nk own knots, in floats:
// a window of nw = nk + 3 knots (two left of the tile, one right).
struct TileLayout {
  int nk, nw, arena;
  long long qinv, rinv, ops, br, thinv, t, gj, total;
};

__host__ __device__ inline TileLayout tile_layout(int nk, int s, int c) {
  TileLayout L;
  L.nk = nk;
  L.nw = nk + 3;
  const long long ss = (long long)s * s;
  const int a1 = L.nw * gj_floats(s), a2 = (L.nw - 1) * gj_floats(c);
  L.arena = a1 > a2 ? a1 : a2;
  L.qinv = 0;                                  // (nw, s, s)   Qinv
  L.rinv = L.qinv + L.nw * ss;                 // (nw-1, c, c) Rinv
  L.ops = L.rinv + (L.nw - 1LL) * c * c;       // (nw, 3, s, s) phi, theta, phi^T
  L.br = L.ops + 3LL * L.nw * ss;              // (nw-1, s, c) B Rinv
  L.thinv = L.br + (L.nw - 1LL) * s * c;       // (nw, s, s)   theta^{-1}
  L.t = L.thinv + L.nw * ss;                   // (nk, s, s)   stair product
  L.gj = L.t + nk * ss;                        // Gauss-Jordan work area
  L.total = L.gj + L.arena;
  return L;
}

// The largest tile (at most kTileKnots) within kTileBudgetBytes, else one
// knot.
inline TileLayout choose_tile(int s, int c) {
  for (int nk = kTileKnots; nk > 1; --nk) {
    const TileLayout L = tile_layout(nk, s, c);
    if (L.total * (long long)sizeof(float) <= kTileBudgetBytes) return L;
  }
  return tile_layout(1, s, c);
}

// Condenses the own knots [k0, k1) of one problem (pointers at the
// problem's slices, the KKTBlocks layout) into S_out, P_out (K, 3, s, s),
// gam_out (K, s), Qinv_out (K, s, s) and Rinv_out (K-1, c, c): the knots'
// rows and the intervals k0 .. min(k1, K-1) - 1.  A zero pivot clamped in a
// Q or R block of the window sets *bad.  Ends synchronised.
__device__ void condense_tile(const float* Q, const float* R, const float* A,
                              const float* Bm, const float* q, const float* r,
                              const float* cv, float rho, int precond, int K,
                              int s, int c, int k0, int k1,
                              const TileLayout& L, float* smem, float* S_out,
                              float* P_out, float* gam_out, float* Qinv_out,
                              float* Rinv_out, int* bad) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t ss = (size_t)s * s, sc = (size_t)s * c, cc2 = (size_t)c * c;
  const size_t slot3 = 3 * ss;
  const int w0 = k0 >= 2 ? k0 - 2 : 0;
  const int w1 = k1 + 1 < K ? k1 + 1 : K;
  const int nw = w1 - w0, j0 = k0 - w0, nk = k1 - k0;
  const int nr = (k1 < K ? k1 : K - 1) - k0;  // own intervals
  float* Qw = smem + L.qinv;
  float* Rw = smem + L.rinv;
  float* Sw = smem + L.ops;
  float* BRw = smem + L.br;
  float* thw = smem + L.thinv;
  float* Tw = smem + L.t;
  float* arena = smem + L.gj;

  // The window's inverses and blocks: window knot j is knot w0 + j, and
  // its phi, theta and phi^T are those of the whole problem wherever the
  // window holds their inputs (all but phi and theta of window knot 0 when
  // w0 > 0, and phi^T of the last window knot when w1 < K; none of these is
  // read below).
  gj_invert(Q + w0 * ss, ss, Qw, ss, nw, s, rho, arena, L.arena, bad);
  gj_invert(R + w0 * cc2, cc2, Rw, cc2, nw - 1, c, rho, arena, L.arena, bad);
  condense_products<true>(A + w0 * ss, Bm + w0 * sc, Qw, Rw, Sw, Sw + ss,
                          Sw + 2 * ss, slot3, BRw, nw, s, c);

  for (int e = tid; e < nk * s; e += nt)
    gam_out[(size_t)k0 * s + e] =
        gamma_row(Qw, Sw, slot3, BRw, q + (size_t)w0 * s, r + (size_t)w0 * c,
                  cv + (size_t)w0 * s, s, c, j0 * s + e);
  for (size_t e = tid; e < nk * slot3; e += nt)
    S_out[k0 * slot3 + e] = Sw[j0 * slot3 + e];
  for (size_t e = tid; e < nk * ss; e += nt)
    Qinv_out[k0 * ss + e] = Qw[j0 * ss + e];
  for (size_t e = tid; e < nr * cc2; e += nt)
    Rinv_out[k0 * cc2 + e] = Rw[j0 * cc2 + e];

  if (precond == kLkJacobi) {
    for (size_t e = tid; e < nk * slot3; e += nt) {
      const size_t kl = e / slot3, rem = e % slot3;
      const int jslot = rem / ss, a = (rem % ss) / s, j = rem % s;
      float val = 0.f;
      if (jslot == 1 && a == j) {
        const float d = Sw[(j0 + kl) * slot3 + ss + a * s + a];
        val = 1.f / (d != 0.f ? d : 1.f);
      }
      P_out[k0 * slot3 + e] = val;
    }
    __syncthreads();
    return;
  }
  // theta^{-1} of the own knots and, for the stair, of one neighbour on
  // each side.
  const bool stair = precond == kLkStair;
  const int lo = stair && k0 > 0 ? j0 - 1 : j0;
  const int hi = stair && k1 < K ? j0 + nk + 1 : j0 + nk;
  gj_invert(Sw + lo * slot3 + ss, slot3, thw + lo * ss, ss, hi - lo, s, 0.f,
            arena, L.arena, nullptr);
  for (size_t e = tid; e < nk * ss; e += nt) {
    const size_t kl = e / ss, rem = e % ss;
    float* Pk = P_out + (k0 + kl) * slot3;
    Pk[ss + rem] = thw[(j0 + kl) * ss + rem];
    if (!stair) {
      Pk[rem] = 0.f;
      Pk[2 * ss + rem] = 0.f;
    }
  }
  if (!stair) {
    __syncthreads();
    return;
  }
  // The stair, in kernel B's order (cluster_body.cuh): T_k = theta_k^{-1}
  // phi_k, Pinv[k][0] = -(T_k theta_{k-1}^{-1}); T_k = theta_k^{-1}
  // phi_{k+1}^T, Pinv[k][2] = -(T_k theta_{k+1}^{-1}); zero past either end.
  for (size_t e = tid; e < nk * ss; e += nt) {
    const int kl = e / ss, a = (e % ss) / s, j = e % s, jw = j0 + kl;
    const float* ti = thw + jw * ss + a * s;
    const float* ph = Sw + jw * slot3 + j;
    float acc = 0.f;
    for (int e2 = 0; e2 < s; ++e2) acc = fmaf(ti[e2], ph[e2 * s], acc);
    Tw[kl * ss + a * s + j] = acc;
  }
  __syncthreads();
  for (size_t e = tid; e < nk * ss; e += nt) {
    const int kl = e / ss, a = (e % ss) / s, j = e % s, jw = j0 + kl;
    float val = 0.f;
    if (k0 + kl > 0) {
      const float* tr = Tw + kl * ss + a * s;
      const float* tp = thw + (jw - 1) * ss + j;
      float acc = 0.f;
      for (int e2 = 0; e2 < s; ++e2) acc = fmaf(tr[e2], tp[e2 * s], acc);
      val = -acc;
    }
    P_out[(k0 + kl) * slot3 + a * s + j] = val;
  }
  __syncthreads();
  for (size_t e = tid; e < nk * ss; e += nt) {
    const int kl = e / ss, a = (e % ss) / s, j = e % s, jw = j0 + kl;
    const float* ti = thw + jw * ss + a * s;
    const float* sr = Sw + jw * slot3 + 2 * ss + j;
    float acc = 0.f;
    for (int e2 = 0; e2 < s; ++e2) acc = fmaf(ti[e2], sr[e2 * s], acc);
    Tw[kl * ss + a * s + j] = acc;
  }
  __syncthreads();
  for (size_t e = tid; e < nk * ss; e += nt) {
    const int kl = e / ss, a = (e % ss) / s, j = e % s, jw = j0 + kl;
    float val = 0.f;
    if (k0 + kl + 1 < K) {
      const float* tr = Tw + kl * ss + a * s;
      const float* tn = thw + (jw + 1) * ss + j;
      float acc = 0.f;
      for (int e2 = 0; e2 < s; ++e2) acc = fmaf(tr[e2], tn[e2 * s], acc);
      val = -acc;
    }
    P_out[(k0 + kl) * slot3 + 2 * ss + a * s + j] = val;
  }
  __syncthreads();
}

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
// (zeroed by the caller).
struct OpArrays {
  float* S;
  float* P;
  float* gamma;
  float* Qinv;
  float* Rinv;
  int* bad;
};

// Condenses the tile `tile` of problem b.
__device__ __forceinline__ void condense_problem_tile(const KktArrays& in,
                                                      const OpArrays& out,
                                                      const TileLayout& L,
                                                      size_t b, int tile,
                                                      float* smem) {
  const int K = in.K, s = in.s, c = in.c;
  const size_t ss = (size_t)s * s, sc = (size_t)s * c, cc2 = (size_t)c * c;
  const int k0 = tile * L.nk, k1 = k0 + L.nk < K ? k0 + L.nk : K;
  condense_tile(in.Q + b * K * ss, in.R + b * (K - 1) * cc2,
                in.A + b * (K - 1) * ss, in.Bm + b * (K - 1) * sc,
                in.q + b * K * s, in.r + b * (K - 1) * c, in.cv + b * K * s,
                in.rho, in.precond, K, s, c, k0, k1, L, smem,
                out.S + b * K * 3 * ss, out.P + b * K * 3 * ss,
                out.gamma + b * K * s, out.Qinv + b * K * ss,
                out.Rinv + b * (K - 1) * cc2, out.bad + b);
}

// Row 7: one block per (problem, tile).
__global__ void __launch_bounds__(kLongkThreads)
condense_longk_kernel(KktArrays in, OpArrays out, TileLayout L, int ntiles) {
  extern __shared__ float smem[];
  condense_problem_tile(in, out, L, blockIdx.x / ntiles, blockIdx.x % ntiles,
                        smem);
}

// What the PCG loop reads and writes.  S, P, gamma, lam0, lam (B, K, ...);
// frozen (B,) or null; iters, conv, eta (B,); vec (B, 5, K s) the loop's
// vectors r, p, M r, S p and a Horner temporary; parts two floats a CTA of
// a launch (the partial sums of the two dot products); done one counter a
// round, zeroed by the caller.
struct PcgArrays {
  const float* S;
  const float* P;
  const float* gamma;
  const float* lam0;
  const int* frozen;
  float* lam;
  int* iters;
  int* conv;
  float* eta;
  float* vec;
  float* parts;
  int* done;
  int K, s, max_iters, poly_degree;
  float exit_tol;
};

// y = M r on the rows [i0, i1), M = P or its Horner polynomial (a grid
// barrier before each read of a neighbour's y or tmp).  Every CTA of the
// grid calls it (the barriers); only active ones compute.
__device__ void precond_rows(cg::grid_group& grid, const float* S,
                             const float* P, const float* r, float* y,
                             float* tmp, int K, int s, int i0, int i1,
                             int poly_degree, bool active) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (active)
    for (int i = i0 + tid; i < i1; i += nt) y[i] = btd_row(P, r, K, s, i / s, i % s);
  for (int d = 1; d < poly_degree; ++d) {
    grid.sync();
    if (active)
      for (int i = i0 + tid; i < i1; i += nt)
        tmp[i] = r[i] - btd_row(S, y, K, s, i / s, i % s);
    grid.sync();
    if (active)
      for (int i = i0 + tid; i < i1; i += nt)
        y[i] += btd_row(P, tmp, K, s, i / s, i % s);
  }
}

// The PCG loop of problem first + blockIdx.x / per, rows of CTA
// blockIdx.x % per: pcg_common.cuh's pcg_block (the same updates, exit test
// on |r . M r| < exit_tol, 0-based exit index, alpha = 0 when p.Sp = 0,
// beta = 0 when eta = 0, Horner form) spread over the problem's CTAs.  A
// frozen problem runs no iteration, keeps lambda_0, and reports max_iters,
// not converged and eta = 1e30.
__device__ void pcg_longk_rows(cg::grid_group& grid, const PcgArrays& a,
                               const Round& rd, bool frozen, float* red,
                               int* flag) {
  const int K = a.K, s = a.s, tid = threadIdx.x, nt = blockDim.x;
  const size_t n = (size_t)K * s;
  const int pl = blockIdx.x / rd.per, part = blockIdx.x % rd.per;
  const size_t b = rd.first + pl;
  const float* S = a.S + b * n * 3 * s;
  const float* P = a.P + b * n * 3 * s;
  const float* gamma = a.gamma + b * n;
  const float* lam0 = a.lam0 + b * n;
  float* lam = a.lam + b * n;
  float* r = a.vec + b * 5 * n;
  float* p = r + n;
  float* y = p + n;
  float* ups = y + n;
  float* tmp = ups + n;
  float* nu_part = a.parts + pl * rd.per;
  float* eta_part = a.parts + gridDim.x + pl * rd.per;
  int* done = a.done + rd.index;
  const OwnRows own = own_rows(K, s, rd.per, part);
  const int i0 = own.i0, i1 = own.i1;
  const bool lead = part == 0 && tid == 0;
  bool active = !frozen;

  // r = gamma - S lambda_0
  for (int i = i0 + tid; i < i1; i += nt) {
    lam[i] = lam0[i];
    if (active) r[i] = gamma[i] - btd_row(S, lam0, K, s, i / s, i % s);
  }
  if (frozen && lead) atomicAdd(done, 1);
  grid.sync();
  precond_rows(grid, S, P, r, y, tmp, K, s, i0, i1, a.poly_degree, active);
  float acc = 0.f;
  if (active)
    for (int i = i0 + tid; i < i1; i += nt) {
      p[i] = y[i];
      acc = fmaf(r[i], y[i], acc);
    }
  float v = block_sum(acc, red);
  if (tid == 0) eta_part[part] = v;
  grid.sync();
  float eta = active ? sum_partials(eta_part, rd.per, red) : 0.f;

  int iters = a.max_iters, conv = 0;
  for (int it = 0; it < a.max_iters; ++it) {
    if (tid == 0) *flag = atomicAdd(done, 0);
    __syncthreads();
    if (*flag == rd.nprob) break;
    // upsilon = S p, nu = p . upsilon
    acc = 0.f;
    if (active)
      for (int i = i0 + tid; i < i1; i += nt) {
        const float u = btd_row(S, p, K, s, i / s, i % s);
        ups[i] = u;
        acc = fmaf(p[i], u, acc);
      }
    v = block_sum(acc, red);
    if (tid == 0) nu_part[part] = v;
    grid.sync();
    if (active) {
      const float nu = sum_partials(nu_part, rd.per, red);
      const float alpha = nu != 0.f ? eta / nu : 0.f;
      for (int i = i0 + tid; i < i1; i += nt) {
        lam[i] = fmaf(alpha, p[i], lam[i]);
        r[i] = fmaf(-alpha, ups[i], r[i]);
      }
    }
    grid.sync();
    // M r, eta_new = r . M r
    precond_rows(grid, S, P, r, y, tmp, K, s, i0, i1, a.poly_degree, active);
    acc = 0.f;
    if (active)
      for (int i = i0 + tid; i < i1; i += nt) acc = fmaf(r[i], y[i], acc);
    v = block_sum(acc, red);
    if (tid == 0) eta_part[part] = v;
    grid.sync();
    if (active) {
      const float eta_new = sum_partials(eta_part, rd.per, red);
      const float beta = eta != 0.f ? eta_new / eta : 0.f;
      for (int i = i0 + tid; i < i1; i += nt) p[i] = fmaf(beta, p[i], y[i]);
      eta = eta_new;
      if (fabsf(eta_new) < a.exit_tol) {
        iters = it;
        conv = 1;
        active = false;
        if (lead) atomicAdd(done, 1);
      }
    }
    grid.sync();
  }
  if (lead) {
    a.iters[b] = iters;
    a.conv[b] = conv;
    a.eta[b] = frozen ? kFrozenEta : fabsf(eta);
  }
}

// Rows 8 and 10: PCG on condensed operators, one cooperative launch a
// round.
__global__ void __launch_bounds__(kLongkThreads)
pcg_longk_kernel(PcgArrays a, Round rd) {
  __shared__ float red[33];
  __shared__ int flag;
  cg::grid_group grid = cg::this_grid();
  const size_t b = rd.first + blockIdx.x / rd.per;
  const bool frozen = a.frozen != nullptr && a.frozen[b] != 0;
  pcg_longk_rows(grid, a, rd, frozen, red, &flag);
}

// Row 9: condensation of every tile of the round's problems, a grid
// barrier, then the PCG loop on what they wrote.
__global__ void __launch_bounds__(kLongkThreads)
fused_longk_kernel(KktArrays in, OpArrays ops, PcgArrays a, Round rd,
                   TileLayout L) {
  extern __shared__ float smem[];
  __shared__ float red[33];
  __shared__ int flag;
  cg::grid_group grid = cg::this_grid();
  const size_t b = rd.first + blockIdx.x / rd.per;
  const int part = blockIdx.x % rd.per;
  const int ntiles = (in.K + L.nk - 1) / L.nk;
  for (int t = part; t < ntiles; t += rd.per)
    condense_problem_tile(in, ops, L, b, t, smem);
  grid.sync();
  const bool frozen = __ldcg(ops.bad + b) != 0;
  pcg_longk_rows(grid, a, rd, frozen, red, &flag);
}

// Row 13: dz_x, dz_u of kRecoverKnots knots a block, from Qinv (B, K, s, s),
// Rinv (B, K-1, c, c), A, B, q, r and lambda; recover_dz on the window of
// the block's knots and the next one (whose lambda the last knot's A^T and
// B^T terms read), into shared memory, then the block's own rows out.
__global__ void __launch_bounds__(kLongkThreads)
recover_longk_kernel(const float* Qinv, const float* Rinv, const float* A,
                     const float* Bm, const float* q, const float* r,
                     const float* lam, float* dzx, float* dzu, int K, int s,
                     int c, int ntiles) {
  extern __shared__ float smem[];
  const size_t ss = (size_t)s * s, sc = (size_t)s * c, cc2 = (size_t)c * c;
  const size_t b = blockIdx.x / ntiles;
  const int k0 = (blockIdx.x % ntiles) * kRecoverKnots;
  const int k1 = k0 + kRecoverKnots < K ? k0 + kRecoverKnots : K;
  const int nw = (k1 < K ? k1 + 1 : K) - k0;
  const int nr = (k1 < K ? k1 : K - 1) - k0;
  float* rx = smem;                              // (nw, s)
  float* dx = rx + (kRecoverKnots + 1) * s;      // (nw, s)
  float* ru = dx + (kRecoverKnots + 1) * s;      // (nw-1, c)
  float* du = ru + kRecoverKnots * c;            // (nw-1, c)
  const size_t kq = b * K + k0, ki = b * (K - 1) + k0;
  recover_dz(Qinv + kq * ss, Rinv + ki * cc2, A + ki * ss, Bm + ki * sc,
             q + kq * s, r + ki * c, lam + kq * s, rx, ru, dx, du, nw, s, c);
  __syncthreads();
  for (int e = threadIdx.x; e < (k1 - k0) * s; e += blockDim.x)
    dzx[kq * s + e] = dx[e];
  for (int e = threadIdx.x; e < nr * c; e += blockDim.x)
    dzu[ki * c + e] = du[e];
}

inline long long recover_smem_bytes(int s, int c) {
  return (2LL * (kRecoverKnots + 1) * s + 2LL * kRecoverKnots * c) *
         (long long)sizeof(float);
}

}  // namespace gato

extern "C" {

// Own knots of one condensation tile, and its dynamic shared memory in bytes.
int gato_longk_tile_knots(int s, int c) { return gato::choose_tile(s, c).nk; }

long long gato_longk_tile_smem_bytes(int s, int c) {
  return gato::choose_tile(s, c).total * (long long)sizeof(float);
}

// Resident CTAs of the cooperative kernels on the current device: kind 0
// the PCG kernel, 1 the fused kernel (with its tile's shared memory); 0 if
// none fits, a negative CUDA error code if a query fails.
int gato_longk_grid(int kind, int s, int c) {
  if (kind == 0)
    return gato::coresident_ctas((const void*)gato::pcg_longk_kernel, 0);
  return gato::coresident_ctas((const void*)gato::fused_longk_kernel,
                               (size_t)gato_longk_tile_smem_bytes(s, c));
}

// Launches row 7 on `stream`: S, P, gamma, Qinv, Rinv and the zero-pivot
// flags (`bad`, zeroed by the caller) of B problems.  Returns the CUDA error
// code (0 on success); nothing is synchronised.
int gato_longk_condense(const float* Q, const float* R, const float* A,
                        const float* Bm, const float* q, const float* r,
                        const float* cv, float* S, float* P, float* gamma,
                        float* Qinv, float* Rinv, int* bad, int B, int K,
                        int s, int c, float rho, int precond, void* stream) {
  const gato::TileLayout L = gato::choose_tile(s, c);
  const size_t smem = (size_t)L.total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gato::condense_longk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (K + L.nk - 1) / L.nk;
  gato::KktArrays in{Q, R, A, Bm, q, r, cv, K, s, c, rho, precond};
  gato::OpArrays out{S, P, gamma, Qinv, Rinv, bad};
  gato::condense_longk_kernel<<<(unsigned)B * ntiles, gato::kLongkThreads,
                                smem, (cudaStream_t)stream>>>(in, out, L,
                                                              ntiles);
  return (int)cudaGetLastError();
}

// Launches rows 8/10 on `stream` for B problems, in rounds of at most
// grid_max resident CTAs (gato_longk_grid(0, ...)).  `vec` holds B * 5 * K
// * s floats, `parts` 2 * grid_max, `done` one zeroed int a round (B
// suffice).  Returns the CUDA error code (0 on success).
int gato_longk_pcg(const float* S, const float* P, const float* gamma,
                   const float* lam0, const int* frozen, float* lam,
                   int* iters, int* conv, float* eta, float* vec, float* parts,
                   int* done, int B, int K, int s, float exit_tol,
                   int max_iters, int poly_degree, int grid_max,
                   void* stream) {
  if (grid_max < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  gato::PcgArrays a{S, P, gamma, lam0, frozen, lam, iters, conv, eta, vec,
                    parts, done, K, s, max_iters, poly_degree, exit_tol};
  for (int first = 0, index = 0; first < B; ++index) {
    gato::Round rd = gato::next_round(first, B, (long long)K * s, grid_max, index);
    void* args[] = {&a, &rd};
    cudaError_t err = cudaLaunchCooperativeKernel(
        (const void*)gato::pcg_longk_kernel, dim3(rd.nprob * rd.per),
        dim3(gato::kLongkThreads), args, 0, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    first += rd.nprob;
  }
  return (int)cudaGetLastError();
}

// Launches row 9 on `stream` for B problems, in rounds of at most grid_max
// resident CTAs (gato_longk_grid(1, ...)).  S, P (B, K, 3, s, s) and gamma
// (B, K, s) are scratch, Qinv and Rinv outputs for the recovery, `bad` B
// zeroed ints; vec, parts and done as for gato_longk_pcg.
int gato_longk_fused(const float* Q, const float* R, const float* A,
                     const float* Bm, const float* q, const float* r,
                     const float* cv, const float* lam0, float* lam,
                     int* iters, int* conv, float* eta, float* Qinv,
                     float* Rinv, float* S, float* P, float* gamma, int* bad,
                     float* vec, float* parts, int* done, int B, int K, int s,
                     int c, float rho, float exit_tol, int max_iters,
                     int poly_degree, int precond, int grid_max,
                     void* stream) {
  if (grid_max < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  gato::TileLayout L = gato::choose_tile(s, c);
  const size_t smem = (size_t)L.total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gato::fused_longk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gato::KktArrays in{Q, R, A, Bm, q, r, cv, K, s, c, rho, precond};
  gato::OpArrays ops{S, P, gamma, Qinv, Rinv, bad};
  gato::PcgArrays a{S, P, gamma, lam0, nullptr, lam, iters, conv, eta, vec,
                    parts, done, K, s, max_iters, poly_degree, exit_tol};
  for (int first = 0, index = 0; first < B; ++index) {
    gato::Round rd = gato::next_round(first, B, (long long)K * s, grid_max, index);
    void* args[] = {&in, &ops, &a, &rd, &L};
    err = cudaLaunchCooperativeKernel((const void*)gato::fused_longk_kernel,
                                      dim3(rd.nprob * rd.per),
                                      dim3(gato::kLongkThreads), args, smem,
                                      (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    first += rd.nprob;
  }
  return (int)cudaGetLastError();
}

// Launches row 13 on `stream`: dz_x (B, K, s) and dz_u (B, K-1, c).
int gato_longk_recover(const float* Qinv, const float* Rinv, const float* A,
                       const float* Bm, const float* q, const float* r,
                       const float* lam, float* dzx, float* dzu, int B, int K,
                       int s, int c, void* stream) {
  const int ntiles = (K + gato::kRecoverKnots - 1) / gato::kRecoverKnots;
  gato::recover_longk_kernel<<<(unsigned)B * ntiles, gato::kLongkThreads,
                               (size_t)gato::recover_smem_bytes(s, c),
                               (cudaStream_t)stream>>>(
      Qinv, Rinv, A, Bm, q, r, lam, dzx, dzu, K, s, c, ntiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
