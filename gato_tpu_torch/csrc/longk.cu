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
// Plain versions, wrappers and the Python mirror of the launch plans below:
// gato_tpu_torch/kernels/longk.py.
//
// Row 7, condensation tiles (the tile body and its plan are in
// condense_tile.cuh, which row 5 shares).  A CTA condenses the own knots
// [k0, k1) of one tile (kernels/longk.py's tile_knots: enough tiles to
// cover the card's SMs, the window's rows one Gauss-Jordan round).  The TPU kernel
// walks lane chunks in order and carries the one-knot dependency between
// grid steps; CUDA blocks run in no order, so a tile recomputes, in its own
// shared memory, the neighbour knots it needs: a window of two knots to the
// left (theta_{k0-1} needs phi_{k0-1} = A_{k0-2} Qinv_{k0-2}) and one to
// the right (theta_{k1} for the stair).  A recomputed knot goes through the
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
// Rows 8/10, PCG (one function; the TPU split it by whether the operators
// fit VMEM) in one cooperative launch a round of problems: `per` CTAs a
// problem (kernels/longk.py's pcg_per), CTA `part` owning the knots
// [part nk, (part + 1) nk) (nk = ceil(K / per)) and a one-knot halo on
// each side of its r and p.
// An iteration meets two grid barriers, one after each dot product:
//   A  ups = S p on own rows, its boundary rows published (global memory),
//      nu's block partial written;                          grid barrier 1
//   B  nu = the problem's partials summed in one fixed order (every CTA
//      gets the same bits), alpha; lambda += alpha p; r -= alpha ups on own
//      AND halo knots (the neighbours' published ups, the owner's fmaf, so
//      the owner's bits); y = M r on own rows, its boundary rows published,
//      eta's partial written;                               grid barrier 2
//   C  eta, beta; p = y + beta p on own and halo knots; the exit test.
// A problem's CTAs all see the same eta and take the same exit.  How they
// meet (meet()): a round of one problem on cg::grid_group::sync and the
// partials summed after it; a round of several on flagged partials, where
// the problem's first CTA gathers its CTAs' {partial, tag} words and posts
// the sum, so each problem meets only its own CTAs and leaves the loop at
// its own exit.  Both add the partials in the same order (the same bits);
// grid barriers bind the whole launch, so the launcher takes them only for
// a round of one problem.  A Horner term (poly degree >= 2) adds two
// barriers (tmp = r - S y, then y += P tmp).  Each published slot
// is written in one phase and read in the next, and written again only
// after the following barrier, so one buffer of each suffices.  The
// operators: S and Pinv of a CTA's knots are copied once into its shared
// memory (16-byte cp.async copies) where they fit (kernels/longk.py's
// pcg_flags: the vectors first, then S, then Pinv); an operator that does
// not fit is streamed a matvec through a two-buffer ring, the next chunk in
// flight while the current one is used.  Either way a thread takes rows
// t = tid, tid + 256, ... in order, and each row is btd_row's fmaf order,
// so the bits do not depend on where an operator sits, and at the parent
// design's CTA count (rows / 256 a problem) they are that design's bits.
//
// Row 9 condenses every tile of its problem on the round's CTAs (CTA j
// takes tiles j, j + per, ...), meets its problem's CTAs, and runs the same
// PCG on what they wrote: rows 7 and 8/10's bits.
//
// Recovery (row 13) takes a warp a knot, kRecoverKnots knots a CTA (B
// ceil(K / 4) CTAs: 256 at K = 1024, B = 1, on 132 SMs), the design of row
// 6's epilogue (thomas_batch.cu): the warp copies the knot's window into
// its slice of shared memory with cp.async, all at once, then runs
// condense.cuh's warp_recover_dz (the fmaf order of the block-level loops
// it replaced, so the same bits).  lambda_{k+1} is read directly (no
// shifted copy); the last knot has no A^T term and no dz_u.  Bytes in
// flight: an IIWA window is 588 floats (2.35 KB; a warp's slice 624
// floats, 2,496 B, so a CTA 9,984 B); at 3.35 TB/s and ~1 us of latency an
// SM needs ~25 KB in flight, ~10 knots.  Shared memory allows 22 CTAs an
// SM (232,448 B over 9,984 + 1,024 reserved), the warp limit 16 (64 warps
// of 4), the registers 65,536 / (128 x regs): 16 CTAs at <= 32 a thread.
// The IIWA kernel is held to 32 (__launch_bounds__(128, 16); ptxas: no
// spill), so 16 CTAs, 64 knots, ~150 KB are in flight on an SM where the
// batch is wide (at 56 registers, 9 CTAs: K = 8192, B = 16 took 0.117 ms
// against 0.110 on an H100, tools/direct_stamps.py's row13 group); the
// padded widths, whose unrolled loops hold more, take 8 CTAs (<= 64
// registers).  At K = 1024, B = 1 the 256 CTAs give each SM ~8 knots, ~19
// KB, in one wave.
//
// What bounds them on an H100.  Rows 8/10 stream S and Pinv (2 * 3 K s^2
// floats) per iteration at ~0.5 flop a byte where they do not sit in
// shared memory (B = 16: every iteration reads them from device memory);
// at B = 1 the operators sit on chip and the iteration is the latency of
// its two meetings (a grid barrier and its sum, ~2.1 us each on row 16's
// probe) and two reductions.
// Condensation is ~25 s^3 flops a knot, each Gauss-Jordan a chain of 2 s
// CTA barriers; a tile's time is that chain's latency, and the tiles of
// a batch run in waves.  Recovery is a pass over Qinv, Rinv, A and B:
// bytes where the batch fills the card, one round trip to memory at B = 1.
//
// Shapes are runtime values: s, c <= 32 (the wrapper checks); IIWA's
// (14, 7) is compiled in as well.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "condense.cuh"
#include "condense_tile.cuh"
#include "grid_common.cuh"

namespace cg = cooperative_groups;

namespace gato {

constexpr int kLongkThreads = kGridThreads;
// Knots of one recovery CTA, a warp each.
constexpr int kRecoverKnots = 4;

// What a PCG CTA holds in shared memory (kernels/longk.py's pcg_flags).
enum PcgFlags { kVecInSmem = 1, kSResident = 2, kPResident = 4 };

// ---- The layouts of the plans (kernels/longk.py chooses the plan and
// mirrors these) ----

// A PCG CTA's layout, in floats: lambda's own rows and five halo vectors
// (r, p, y, S p, tmp; (nk + 2) s each) when kVecInSmem, S's and Pinv's own
// blocks when resident, and the two-buffer ring of `ring` knots a buffer
// when either streams.
struct PcgPlan {
  int per, nk, flags, ring;
  long long vec_floats, off_S, off_P, off_ring, total;
};

inline __host__ __device__ PcgPlan pcg_plan(int K, int s, int per, int flags, int ring) {
  PcgPlan P;
  P.per = per;
  P.nk = (K + per - 1) / per;
  P.flags = flags;
  P.ring = ring;
  const long long kf = 3LL * s * s;
  P.vec_floats = round4((long long)P.nk * s + 5LL * (P.nk + 2) * s);
  long long off = (flags & kVecInSmem) ? P.vec_floats : 0;
  P.off_S = off;
  if (flags & kSResident) off += round4(P.nk * kf);
  P.off_P = off;
  if (flags & kPResident) off += round4(P.nk * kf);
  P.off_ring = off;
  if ((flags & (kSResident | kPResident)) != (kSResident | kPResident))
    off += 2 * round4(ring * kf);
  P.total = off;
  return P;
}

// ---- Row 13's plan (kernels/longk.py mirrors it) ----

// The recovery's width: 14 compiles IIWA's in; 16 and 32 bound any s up
// to them.
inline __host__ __device__ int recover_width(int s) {
  return s == 14 ? 14 : (s <= 16 ? 16 : 32);
}

// A recovery warp's slice of shared memory, in floats (offsets rounded to
// 4, so that 16-byte copies land aligned): Qinv_k (s rows of ldq), A_k
// (s x s), B_k (s x c), Rinv_k (c rows of ldr), q_k, lambda_k,
// lambda_{k+1} and the right side rx (s each), r_k and ru (c each).  ldq
// is 14 at IIWA's width (lane a reading row a at stride 14 meets no bank
// conflict among 14 lanes) and kN + 1 past it (odd, as row 6's ring,
// thomas_batch.cu's rev_ld); ldr is c made odd.  A and B keep their
// stored layout: a lane reads a column, consecutive lanes consecutive
// words.
struct RecoverLayout {
  int ldq, ldr, qi, at, bt, ri, qv, x0, xp, rx, rv, ru, total;
};
inline __host__ __device__ RecoverLayout recover_layout(int s, int c) {
  RecoverLayout L;
  const int w = recover_width(s);
  L.ldq = w == 14 ? 14 : w + 1;
  L.ldr = c | 1;
  const int v = (int)round4(s), u = (int)round4(c);
  L.qi = 0;
  L.at = L.qi + (int)round4((long long)s * L.ldq);
  L.bt = L.at + (int)round4((long long)s * s);
  L.ri = L.bt + (int)round4((long long)s * c);
  L.qv = L.ri + (int)round4((long long)c * L.ldr);
  L.x0 = L.qv + v;
  L.xp = L.x0 + v;
  L.rx = L.xp + v;
  L.rv = L.rx + v;
  L.ru = L.rv + u;
  L.total = L.ru + u;
  return L;
}

// Dynamic shared memory of a recovery CTA (kRecoverKnots warps), in bytes.
inline long long recover_smem_bytes(int s, int c) {
  return 4LL * kRecoverKnots * recover_layout(s, c).total;
}

// What row 13 reads and writes: Qinv (B, K, s, s), Rinv (B, K-1, c, c), A,
// Bm, q, r, lambda; dz_x (B, K, s) and dz_u (B, K-1, c); `tiles` CTAs a
// problem.
struct RecoverArrays {
  const float* Qinv;
  const float* Rinv;
  const float* A;
  const float* Bm;
  const float* q;
  const float* r;
  const float* lam;
  float* dzx;
  float* dzu;
  int K, s, c, tiles;
};

// rows x cols floats of a row-major global block into the warp's shared
// rows of stride ld with cp.async: warp_async_copy's copies where ld ==
// cols, else 4 bytes a copy.  The caller commits and waits.
__device__ __forceinline__ void warp_copy_rows(float* dst, int ld, const float* src,
                                               int rows, int cols) {
  if (ld == cols) {
    warp_async_copy(dst, src, rows * cols);
    return;
  }
  for (int e = threadIdx.x & 31; e < rows * cols; e += 32) {
    const int row = e / cols;
    __pipeline_memcpy_async(dst + row * ld + (e - row * cols), src + e, 4);
  }
}

// Row 7: one CTA a (problem, tile).
template <int kS, int kC>
__global__ void __launch_bounds__(kLongkThreads)
condense_longk_kernel(KktArrays in, OpArrays out, TilePlan L, int ntiles) {
  extern __shared__ float4 smem4[];
  condense_tile<kS, kC>(in, out, L, blockIdx.x / ntiles, blockIdx.x % ntiles,
                        reinterpret_cast<float*>(smem4));
}

// What the PCG loop reads and writes.  S, P, gamma, lam0, lam (B, K, ...);
// frozen (B,) bools or null; iters, conv, eta (B,); vec the CTAs' vectors when
// they are not in shared memory (vec_floats a CTA of the launch), xch six
// boundary rows a CTA (S p, y, tmp at its first and last knot), parts two
// floats a CTA (the dot products' partials) or the flagged meetings'
// words.
struct PcgArrays {
  const float* S;
  const float* P;
  const float* gamma;
  const float* lam0;
  const bool* frozen;
  float* lam;
  int* iters;
  bool* conv;
  float* eta;
  float* vec;
  float* xch;
  float* parts;
  int K, s, max_iters, poly_degree;
  float exit_tol;
};

// Published boundary rows: kinds, a side's s floats each.
enum Xch { kXUps = 0, kXY = 1, kXTmp = 2 };

// One CTA's view of its problem in the PCG loop.
struct PcgCta {
  int K, s, k0, nk, rows;
  bool hasL, hasR;
  float* lam;          // own rows
  float* r;            // own knot 0 of each halo vector; [-s, 0) and
  float* p;            // [nk s, nk s + s) are the halo knots
  float* y;
  float* ups;
  float* tmp;
  const float* Sres;   // resident own blocks in shared memory, or null
  const float* Pres;
  const float* Sg;     // own blocks in global memory
  const float* Pg;
  float* ring;
  int ring_knots;
  float* xme;          // this CTA's published rows
  const float* xl;     // the left neighbour's, the right one's
  const float* xr;
};

// Row a of knot k's block row of M (blocks at M: L, D, U) times the halo
// vector x (xk = knot k's rows): btd_row's order, L x_{k-1} and U x_{k+1}
// only where they exist, (left + right) + mid.
template <int kS>
__device__ __forceinline__ float btd_local(const float* M, const float* xk, int s, int a,
                                           bool left_, bool right_) {
  const int ss = s * s;
  const float* row = M + a * s;
  float left = 0.f, right = 0.f;
  if (left_) left = lk::dot<kS>(row, xk - s, s);
  const float mid = lk::dot<kS>(row + ss, xk, s);
  if (right_) right = lk::dot<kS>(row + 2 * ss, xk + s, s);
  return (left + right) + mid;
}

// Copies count floats from global src into shared dst with cp.async (16
// bytes a copy where both are aligned), one commit group.
__device__ __forceinline__ void stage(float* dst, const float* src, long long count) {
  const int tid = threadIdx.x, nt = blockDim.x;
  long long head = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    const long long n4 = count >> 2;
    for (long long i = tid; i < n4; i += nt) __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
    head = 4 * n4;
  }
  for (long long i = head + tid; i < count; i += nt) __pipeline_memcpy_async(dst + i, src + i, 4);
  __pipeline_commit();
}

// f(t, row t of M x) for this thread's own rows t = tid, tid + nt, ... in
// order; M resident (Mres) or streamed from Mg through the ring.  Ends
// synchronised only when streamed.
template <int kS, class F>
__device__ __forceinline__ void apply_op(const PcgCta& x, const float* Mres, const float* Mg,
                                         const float* xv, F&& f) {
  const int s = kS > 0 ? kS : x.s;
  const int tid = threadIdx.x, nt = blockDim.x, kf = 3 * s * s;
  if (Mres != nullptr) {
    for (int t = tid; t < x.rows; t += nt) {
      const int kl = t / s, a = t - kl * s, k = x.k0 + kl;
      f(t, btd_local<kS>(Mres + kl * kf, xv + kl * s, s, a, k > 0, k < x.K - 1));
    }
    return;
  }
  const int rk = x.ring_knots, nch = (x.nk + rk - 1) / rk;
  const long long buf = round4((long long)rk * kf);
  if (nch > 0) stage(x.ring, Mg, (long long)(rk < x.nk ? rk : x.nk) * kf);
  for (int ch = 0; ch < nch; ++ch) {
    const int kc = ch * rk, n = x.nk - kc < rk ? x.nk - kc : rk;
    if (ch + 1 < nch) {
      const int nn = x.nk - kc - rk < rk ? x.nk - kc - rk : rk;
      stage(x.ring + ((ch + 1) & 1) * buf, Mg + (size_t)(kc + rk) * kf, (long long)nn * kf);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const float* blk = x.ring + (ch & 1) * buf;
    const int r0 = kc * s, r1 = r0 + n * s;
    for (int t = r0 + ((tid - r0 % nt) % nt + nt) % nt; t < r1; t += nt) {
      const int kl = t / s, a = t - kl * s, k = x.k0 + kl;
      f(t, btd_local<kS>(blk + (kl - kc) * kf, xv + kl * s, s, a, k > 0, k < x.K - 1));
    }
    __syncthreads();
  }
}

// Writes value v of own row t into this CTA's published boundary rows of
// kind `kind` where row t lies in its first or last knot.
__device__ __forceinline__ void publish(const PcgCta& x, int kind, int t, float v) {
  const int kl = t / x.s, a = t - kl * x.s;
  if (kl == 0 && x.hasL) x.xme[kind * 2 * x.s + a] = v;
  if (kl == x.nk - 1 && x.hasR) x.xme[kind * 2 * x.s + x.s + a] = v;
}

// Halo rows of kind `kind` from the neighbours' published rows into the
// halo knots of v.  Call after a grid barrier; synchronise before reading.
__device__ __forceinline__ void pull(const PcgCta& x, int kind, float* v) {
  const int s = x.s;
  for (int e = threadIdx.x; e < 2 * s; e += blockDim.x) {
    if (e < s) {
      if (x.hasL) v[e - s] = __ldcg(x.xl + kind * 2 * s + s + e);
    } else if (x.hasR) {
      v[x.nk * s + e - s] = __ldcg(x.xr + kind * 2 * s + e - s);
    }
  }
}

// y = M r on own rows: P r, then y += P (r - S y) for poly_degree - 1
// Horner terms (two barriers each), y's (and tmp's) boundary rows
// published.  Every CTA that meets calls it; only active ones compute.
// Returns this thread's partial of r . y, in row order.
template <int kS, bool kFlags>
__device__ __forceinline__ float precond_rows(cg::grid_group& grid, const PcgCta& x,
                                              PcgMeet& m, int poly, bool active, float* red) {
  float part = 0.f;
  if (active)
    apply_op<kS>(x, x.Pres, x.Pg, x.r, [&](int t, float v) {
      x.y[t] = v;
      publish(x, kXY, t, v);
      if (poly == 1) part = fmaf(x.r[t], v, part);
    });
  for (int d = 1; d < poly; ++d) {
    meet<kFlags>(grid, m, 0.f, kBarrierOnly, red);
    if (active) {
      pull(x, kXY, x.y);
      __syncthreads();
      apply_op<kS>(x, x.Sres, x.Sg, x.y, [&](int t, float v) {
        const float u = x.r[t] - v;
        x.tmp[t] = u;
        publish(x, kXTmp, t, u);
      });
    }
    meet<kFlags>(grid, m, 0.f, kBarrierOnly, red);
    if (active) {
      pull(x, kXTmp, x.tmp);
      __syncthreads();
      apply_op<kS>(x, x.Pres, x.Pg, x.tmp, [&](int t, float v) {
        const float u = x.y[t] + v;
        x.y[t] = u;
        publish(x, kXY, t, u);
        if (d == poly - 1) part = fmaf(x.r[t], u, part);
      });
    }
  }
  return part;
}

// The PCG loop of problem rd.first + blockIdx.x / per on the own knots of
// CTA blockIdx.x % per: cluster_body.cuh's pcg_loop (the same updates, exit
// test on |r . M r| < exit_tol, 0-based exit index, alpha = 0 when p.Sp =
// 0, beta = 0 when eta = 0, Horner form) with two barriers an iteration.
// A frozen problem runs no iteration, keeps lambda_0, and reports
// max_iters, not converged and eta = 1e30.  `m` comes in with the
// problem's meetings so far.
template <int kS, bool kFlags>
__device__ __forceinline__ void pcg_longk_rows(cg::grid_group& grid, const PcgArrays& a,
                                               const Round& rd, const PcgPlan& pl,
                                               PcgMeet& m, bool frozen, float* smem,
                                               float* red) {
  const int s = kS > 0 ? kS : a.s;
  const int K = a.K, kf = 3 * s * s, tid = threadIdx.x, nt = blockDim.x;
  const size_t n = (size_t)K * s;
  const size_t b = rd.first + blockIdx.x / rd.per;
  PcgCta x;
  x.K = K;
  x.s = s;
  x.k0 = m.part * pl.nk < K ? m.part * pl.nk : K;
  const int k1 = x.k0 + pl.nk < K ? x.k0 + pl.nk : K;
  x.nk = k1 - x.k0;
  x.rows = x.nk * s;
  x.hasL = x.k0 > 0 && x.nk > 0;
  x.hasR = k1 < K && x.nk > 0;
  const bool vec_in = (pl.flags & kVecInSmem) != 0;
  float* vb = vec_in ? smem : a.vec + (size_t)blockIdx.x * pl.vec_floats;
  x.lam = vec_in ? vb : a.lam + b * n + (size_t)x.k0 * s;
  const int vl = (pl.nk + 2) * s;
  x.r = vb + pl.nk * s + s;
  x.p = x.r + vl;
  x.y = x.p + vl;
  x.ups = x.y + vl;
  x.tmp = x.ups + vl;
  const float* Sprob = a.S + b * n * 3 * s;
  x.Sg = Sprob + (size_t)x.k0 * kf;
  x.Pg = a.P + b * n * 3 * s + (size_t)x.k0 * kf;
  x.Sres = (pl.flags & kSResident) ? smem + pl.off_S : nullptr;
  x.Pres = (pl.flags & kPResident) ? smem + pl.off_P : nullptr;
  x.ring = smem + pl.off_ring;
  x.ring_knots = pl.ring;
  x.xme = a.xch + (size_t)blockIdx.x * 6 * s;
  x.xl = a.xch + (size_t)(blockIdx.x - (x.hasL ? 1 : 0)) * 6 * s;
  x.xr = a.xch + (size_t)(blockIdx.x + (x.hasR ? 1 : 0)) * 6 * s;
  const float* gamma = a.gamma + b * n;
  const float* lam0 = a.lam0 + b * n;
  const bool lead = m.part == 0 && tid == 0;
  bool active = !frozen;

  // The resident operators, once; lambda_0; r = gamma - S lambda_0 on own
  // and halo knots (the halo's blocks from global memory, the same
  // arithmetic as their owner's).
  if (x.Sres != nullptr) stage(smem + pl.off_S, x.Sg, (long long)x.nk * kf);
  if (x.Pres != nullptr) stage(smem + pl.off_P, x.Pg, (long long)x.nk * kf);
  __pipeline_wait_prior(0);
  for (int t = tid; t < x.rows; t += nt) x.lam[t] = lam0[(size_t)x.k0 * s + t];
  __syncthreads();
  if (active)
    for (int e = tid; e < (x.nk + 2) * s; e += nt) {
      const int kl = e / s - 1, ar = e - (kl + 1) * s, k = x.k0 + kl;
      if ((kl < 0 && !x.hasL) || (kl >= x.nk && !x.hasR)) continue;
      const float* M = x.Sres != nullptr && kl >= 0 && kl < x.nk ? x.Sres + kl * kf
                                                                  : Sprob + (size_t)k * kf;
      x.r[kl * s + ar] = gamma[(size_t)k * s + ar] -
                         btd_local<kS>(M, lam0 + (size_t)k * s, s, ar, k > 0, k < K - 1);
    }
  __syncthreads();
  // y = M r, p = y, eta = r . y
  float acc = precond_rows<kS, kFlags>(grid, x, m, a.poly_degree, active, red);
  if (active)
    for (int t = tid; t < x.rows; t += nt) x.p[t] = x.y[t];
  float v = block_sum(acc, red);
  float eta = meet<kFlags>(grid, m, v, 1, red);
  if (active) pull(x, kXY, x.p);
  __syncthreads();

  int iters = a.max_iters, conv = 0;
  for (int it = 0; active && it < a.max_iters; ++it) {
    // A: upsilon = S p, nu's partial.
    acc = 0.f;
    apply_op<kS>(x, x.Sres, x.Sg, x.p, [&](int t, float u) {
      x.ups[t] = u;
      publish(x, kXUps, t, u);
      acc = fmaf(x.p[t], u, acc);
    });
    v = block_sum(acc, red);
    const float nu = meet<kFlags>(grid, m, v, 0, red);
    // B: alpha; lambda, r (own and halo); y = M r, eta's partial.
    const float alpha = nu != 0.f ? eta / nu : 0.f;
    for (int t = tid; t < x.rows; t += nt) {
      x.lam[t] = fmaf(alpha, x.p[t], x.lam[t]);
      x.r[t] = fmaf(-alpha, x.ups[t], x.r[t]);
    }
    for (int e = tid; e < 2 * s; e += nt) {
      if (e < s) {
        if (x.hasL)
          x.r[e - s] = fmaf(-alpha, __ldcg(x.xl + kXUps * 2 * s + s + e), x.r[e - s]);
      } else if (x.hasR) {
        const int h = x.nk * s + e - s;
        x.r[h] = fmaf(-alpha, __ldcg(x.xr + kXUps * 2 * s + e - s), x.r[h]);
      }
    }
    __syncthreads();
    acc = precond_rows<kS, kFlags>(grid, x, m, a.poly_degree, true, red);
    v = block_sum(acc, red);
    const float eta_new = meet<kFlags>(grid, m, v, 1, red);
    // C: beta; p (own and halo); the exit test.
    const float beta = eta != 0.f ? eta_new / eta : 0.f;
    for (int t = tid; t < x.rows; t += nt) x.p[t] = fmaf(beta, x.p[t], x.y[t]);
    for (int e = tid; e < 2 * s; e += nt) {
      if (e < s) {
        if (x.hasL)
          x.p[e - s] = fmaf(beta, x.p[e - s], __ldcg(x.xl + kXY * 2 * s + s + e));
      } else if (x.hasR) {
        const int h = x.nk * s + e - s;
        x.p[h] = fmaf(beta, x.p[h], __ldcg(x.xr + kXY * 2 * s + e - s));
      }
    }
    eta = eta_new;
    if (fabsf(eta_new) < a.exit_tol) {
      iters = it;
      conv = 1;
      active = false;
    }
    __syncthreads();
  }
  if (vec_in)
    for (int t = tid; t < x.rows; t += nt) a.lam[b * n + (size_t)x.k0 * s + t] = x.lam[t];
  if (lead) {
    a.iters[b] = iters;
    a.conv[b] = conv != 0;
    a.eta[b] = frozen ? kFrozenEta : fabsf(eta);
  }
}

// This CTA's meeting place: its problem's slots of the launch.
__device__ __forceinline__ PcgMeet pcg_meet(const PcgArrays& a, const Round& rd) {
  return round_meet(a.parts, rd);
}

// Rows 8 and 10: PCG on condensed operators, one cooperative launch a
// round (every CTA resident, which both meetings need); grid barriers
// (!kFlags) only for a round of one problem (the launcher refuses more).
template <int kS, bool kFlags>
__global__ void __launch_bounds__(kLongkThreads, 2)
pcg_longk_kernel(PcgArrays a, Round rd, PcgPlan pl) {
  extern __shared__ float4 smem4[];
  __shared__ float red[33];
  cg::grid_group grid = cg::this_grid();
  const size_t b = rd.first + blockIdx.x / rd.per;
  const bool frozen = a.frozen != nullptr && a.frozen[b];
  PcgMeet m = pcg_meet(a, rd);
  pcg_longk_rows<kS, kFlags>(grid, a, rd, pl, m, frozen, reinterpret_cast<float*>(smem4),
                             red);
}

// Row 9: condensation of every tile of the round's problems (CTA j of a
// problem takes tiles j, j + per, ...), a barrier over the problem's CTAs,
// then the PCG loop on what they wrote.  Grid barriers (!kFlags) only for
// a round of one problem (the launcher refuses more).
template <int kS, int kC, bool kFlags>
__global__ void __launch_bounds__(kLongkThreads, 1)
fused_longk_kernel(KktArrays in, OpArrays ops, PcgArrays a, Round rd, PcgPlan pl,
                   TilePlan L) {
  extern __shared__ float4 smem4[];
  __shared__ float red[33];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const size_t b = rd.first + blockIdx.x / rd.per;
  PcgMeet m = pcg_meet(a, rd);
  const int ntiles = (in.K + L.nk - 1) / L.nk;
  for (int t = m.part; t < ntiles; t += rd.per) condense_tile<kS, kC>(in, ops, L, b, t, smem);
  meet<kFlags>(grid, m, 0.f, kBarrierOnly, red);
  const bool frozen = __ldcg(reinterpret_cast<const unsigned char*>(ops.bad + b)) != 0;
  pcg_longk_rows<kS, kFlags>(grid, a, rd, pl, m, frozen, smem, red);
}

// Row 13, a warp a knot: knot k of problem b (tile t = k / kRecoverKnots,
// CTA b tiles + t) copies its window into the warp's slice of shared memory
// with cp.async, every copy issued before the first product and one commit
// group: Qinv_k (rows at the padded stride), q_k and lambda_k, and for
// k < K-1 A_k, B_k, Rinv_k, r_k and lambda_{k+1}.  Then condense.cuh's
// warp_recover_dz: lane a on row a of dz_x, lanes a < c on dz_u, the last
// knot without the A^T term and without dz_u.  The warps of a CTA share
// nothing (no __syncthreads), so a warp past K leaves at once.
template <int kN>
__global__ void __launch_bounds__(32 * kRecoverKnots, kN == 14 ? 16 : 8)
recover_longk_kernel(RecoverArrays a) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5;
  const int K = a.K, n = kN == 14 ? 14 : a.s, c = a.c;
  const size_t b = blockIdx.x / a.tiles;
  const int k = (int)(blockIdx.x % a.tiles) * kRecoverKnots + warp;
  if (k >= K) return;
  const RecoverLayout L = recover_layout(n, c);
  float* w = reinterpret_cast<float*>(smem4) + (size_t)warp * L.total;
  const size_t kn = b * K + k, ku = b * (K - 1) + k;
  const bool right = k + 1 < K;
  warp_copy_rows(w + L.qi, L.ldq, a.Qinv + kn * n * n, n, n);
  warp_async_copy(w + L.qv, a.q + kn * n, n);
  warp_async_copy(w + L.x0, a.lam + kn * n, n);
  if (right) {
    warp_async_copy(w + L.at, a.A + ku * n * n, n * n);
    warp_async_copy(w + L.bt, a.Bm + ku * n * c, n * c);
    warp_copy_rows(w + L.ri, L.ldr, a.Rinv + ku * c * c, c, c);
    warp_async_copy(w + L.rv, a.r + ku * c, c);
    warp_async_copy(w + L.xp, a.lam + (kn + 1) * n, n);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncwarp();
  warp_recover_dz<kN>(w + L.qi, L.ldq, w + L.ri, L.ldr, w + L.at, w + L.bt, w + L.qv,
                      w + L.x0, w + L.xp, w + L.rv, w + L.rx, w + L.ru, n, c, right,
                      a.dzx + kn * n, a.dzu + ku * c);
}

}  // namespace gato

extern "C" {

// The plans' layouts (kernels/longk.py holds the same functions).
long long gato_longk_tile_smem_bytes(int nk, int s, int c) {
  return gato::tile_plan(nk, s, c).total * 4;
}
int gato_longk_tile_threads(int nk, int s, int c) { return gato::tile_threads(nk, s, c); }
long long gato_longk_pcg_smem_bytes(int K, int s, int per, int flags, int ring) {
  return gato::pcg_plan(K, s, per, flags, ring).total * 4;
}
long long gato_longk_pcg_vec_floats(int K, int s, int per) {
  return gato::pcg_plan(K, s, per, 0, 0).vec_floats;
}

// Launches row 7 on `stream`: S, P, gamma, Qinv, Rinv and the zero-pivot
// flags (`bad`, zeroed here) of B problems, in tiles of
// `tile_knots` knots (kernels/longk.py's tile_knots).  Returns the CUDA error code
// (0 on success); nothing is synchronised.
int gato_longk_condense(const float* Q, const float* R, const float* A,
                        const float* Bm, const float* q, const float* r,
                        const float* cv, float* S, float* P, float* gamma,
                        float* Qinv, float* Rinv, bool* bad, int B, int K,
                        int s, int c, float rho, int precond, int tile_knots,
                        void* stream) {
  const gato::TilePlan L = gato::tile_plan(tile_knots, s, c);
  const size_t smem = (size_t)L.total * sizeof(float);
  const bool iiwa = s == 14 && c == 7;
  const void* kernel = iiwa ? (const void*)gato::condense_longk_kernel<14, 7>
                            : (const void*)gato::condense_longk_kernel<0, 0>;
  cudaError_t err = gato::opt_in_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(bad, 0, (size_t)B * sizeof(bool), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (K + L.nk - 1) / L.nk;
  const int threads = gato::tile_threads(tile_knots, s, c);
  gato::KktArrays in{Q, R, A, Bm, q, r, cv, K, s, c, rho, precond};
  gato::OpArrays out{S, P, gamma, Qinv, Rinv, bad};
  if (iiwa)
      gato::condense_longk_kernel<14, 7><<<(unsigned)B * ntiles, threads, smem,
                                         (cudaStream_t)stream>>>(in, out, L, ntiles);
  else
    gato::condense_longk_kernel<0, 0><<<(unsigned)B * ntiles, threads, smem,
                                        (cudaStream_t)stream>>>(in, out, L, ntiles);
  return (int)cudaGetLastError();
}

// Launches rows 8/10 on `stream` for one round: problems first .. first +
// nprob - 1, `per` CTAs each, shared memory by `flags` and `ring` (the plan
// of kernels/longk.py's pcg_rounds), one cooperative launch of nprob per
// CTAs; `flag_meet` 1 meets a problem's CTAs through flagged partials, 0
// through grid barriers (only for nprob 1).  `vec` holds nprob per
// gato_longk_pcg_vec_floats floats (or is null when flags put the vectors
// in shared memory), `xch` nprob per 6 s floats, `parts` 8 nprob per
// (zeroed here for flag_meet).  Returns the CUDA error code (0 on success).
int gato_longk_pcg(const float* S, const float* P, const float* gamma,
                   const float* lam0, const bool* frozen, float* lam,
                   int* iters, bool* conv, float* eta, float* vec, float* xch,
                   float* parts, int first, int nprob, int per, int flags, int ring,
                   int K, int s, float exit_tol, int max_iters, int poly_degree,
                   int flag_meet, void* stream) {
  if (!flag_meet && nprob != 1) return (int)cudaErrorInvalidValue;
  gato::PcgPlan pl = gato::pcg_plan(K, s, per, flags, ring);
  const size_t smem = (size_t)pl.total * sizeof(float);
  const void* kernel =
      s == 14 ? (flag_meet ? (const void*)gato::pcg_longk_kernel<14, true>
                           : (const void*)gato::pcg_longk_kernel<14, false>)
              : (flag_meet ? (const void*)gato::pcg_longk_kernel<0, true>
                           : (const void*)gato::pcg_longk_kernel<0, false>);
  cudaError_t err = gato::opt_in_smem(kernel, smem);
  if (err == cudaSuccess && flag_meet)
    err = cudaMemsetAsync(parts, 0, (size_t)nprob * per * 8 * sizeof(float),
                          (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  gato::PcgArrays a{S, P, gamma, lam0, frozen, lam, iters, conv, eta, vec, xch,
                    parts, K, s, max_iters, poly_degree, exit_tol};
  gato::Round rd{first, nprob, per, 0};
  void* args[] = {&a, &rd, &pl};
  err = cudaLaunchCooperativeKernel(kernel, dim3(nprob * per), dim3(gato::kLongkThreads),
                                    args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no sticky error behind
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// Launches row 9 on `stream` for one round (as gato_longk_pcg; grid
// barriers, flag_meet 0, only for nprob 1), its tiles of `tile_knots`
// knots.  S, P (B, K, 3, s, s) and gamma (B, K, s) are scratch, Qinv and
// Rinv outputs for the recovery, `bad` B false bools; vec, xch and parts
// as for gato_longk_pcg.
int gato_longk_fused(const float* Q, const float* R, const float* A,
                     const float* Bm, const float* q, const float* r,
                     const float* cv, const float* lam0, float* lam,
                     int* iters, bool* conv, float* eta, float* Qinv,
                     float* Rinv, float* S, float* P, float* gamma, bool* bad,
                     float* vec, float* xch, float* parts, int first, int nprob,
                     int per, int flags, int ring, int tile_knots, int K, int s, int c,
                     float rho, float exit_tol, int max_iters, int poly_degree,
                     int precond, int flag_meet, void* stream) {
  if (!flag_meet && nprob != 1) return (int)cudaErrorInvalidValue;
  gato::TilePlan L = gato::tile_plan(tile_knots, s, c);
  gato::PcgPlan pl = gato::pcg_plan(K, s, per, flags, ring);
  const size_t smem = (size_t)(L.total > pl.total ? L.total : pl.total) * sizeof(float);
  const bool iiwa = s == 14 && c == 7;
  const void* kernel =
      iiwa ? (flag_meet ? (const void*)gato::fused_longk_kernel<14, 7, true>
                        : (const void*)gato::fused_longk_kernel<14, 7, false>)
           : (flag_meet ? (const void*)gato::fused_longk_kernel<0, 0, true>
                        : (const void*)gato::fused_longk_kernel<0, 0, false>);
  cudaError_t err = gato::opt_in_smem(kernel, smem);
  if (err == cudaSuccess && flag_meet)
    err = cudaMemsetAsync(parts, 0, (size_t)nprob * per * 8 * sizeof(float),
                          (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  gato::KktArrays in{Q, R, A, Bm, q, r, cv, K, s, c, rho, precond};
  gato::OpArrays ops{S, P, gamma, Qinv, Rinv, bad};
  gato::PcgArrays a{S, P, gamma, lam0, nullptr, lam, iters, conv, eta, vec, xch,
                    parts, K, s, max_iters, poly_degree, exit_tol};
  gato::Round rd{first, nprob, per, 0};
  void* args[] = {&in, &ops, &a, &rd, &pl, &L};
  err = cudaLaunchCooperativeKernel(kernel, dim3(nprob * per), dim3(gato::kLongkThreads),
                                    args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no sticky error behind
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a recovery CTA (kernels/longk.py mirrors it).
long long gato_longk_recover_smem_bytes(int s, int c) { return gato::recover_smem_bytes(s, c); }

// Launches row 13 on `stream`: dz_x (B, K, s) and dz_u (B, K-1, c), B
// ceil(K / kRecoverKnots) CTAs of kRecoverKnots warps.  Returns the CUDA
// error code (0 on success); nothing is synchronised.
int gato_longk_recover(const float* Qinv, const float* Rinv, const float* A,
                       const float* Bm, const float* q, const float* r,
                       const float* lam, float* dzx, float* dzu, int B, int K,
                       int s, int c, void* stream) {
  const int tiles = (K + gato::kRecoverKnots - 1) / gato::kRecoverKnots;
  const int w = gato::recover_width(s);
  const void* kernel = w == 14   ? (const void*)gato::recover_longk_kernel<14>
                       : w == 16 ? (const void*)gato::recover_longk_kernel<16>
                                 : (const void*)gato::recover_longk_kernel<32>;
  const size_t smem = (size_t)gato::recover_smem_bytes(s, c);
  cudaError_t err = gato::opt_in_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  gato::RecoverArrays a{Qinv, Rinv, A, Bm, q, r, lam, dzx, dzu, K, s, c, tiles};
  const dim3 grid((unsigned)((long long)B * tiles)), block(32 * gato::kRecoverKnots);
  const cudaStream_t st = (cudaStream_t)stream;
  if (w == 14)
    gato::recover_longk_kernel<14><<<grid, block, smem, st>>>(a);
  else if (w == 16)
    gato::recover_longk_kernel<16><<<grid, block, smem, st>>>(a);
  else
    gato::recover_longk_kernel<32><<<grid, block, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
