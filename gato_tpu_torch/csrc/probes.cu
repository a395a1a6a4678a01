// Rows 16, 17 and 18: the three measurement probes, latency floors of the
// primitives the solver's kernels are built from.  Wrappers and plain
// versions: gato_tpu_torch/kernels/probes.py; the tools that time them:
// gato_tpu_torch/tools/probe_dispatch.py, probe_iter_floor.py and
// probe_throughput.py.
//
// Row 18, null_copy (replaces bench.py's null_kernel, pallas_call at :899,
// the dispatch-floor probe): out = q * 1.0000001 on the rhs of B problems
// (B K s floats).  Its bound (2 B K s 4 bytes over 3.35 TB/s) is
// nanoseconds: what bounds it on an H100 is the launch and one round trip
// to memory, and the probe exists to show that floor, so the kernel must
// add nothing to it.  One float4 a thread (16-byte loads and stores, at
// IIWA K s = 700 175 float4 in one round trip of one CTA, not a
// grid-stride walk of 4-byte loads), over a grid of 256-thread CTAs that
// covers B K s / 4 float4; threads 0-2 also take the 1-3 floats past the
// last whole float4.  Where q or out does not start on a 16-byte boundary
// (a view of q one float in), every thread takes one float instead.  The
// product is a rounded float32 multiply (__fmul_rn, no contraction), bit
// for bit q * 1.0000001.
//
// Row 16, null_chain (replaces tools/probe_iter_floor.py's null kernel,
// pallas_call at :105): the dependent op chain of one PCG iteration without
// the algorithm.  One trip, on y (K, s) of each problem:
//   n_mv times   y <- 0.25 (0.01 M) y + 0.5 y, M (K, 3, s, s) the port's
//                block-tridiagonal operator (zeros past either end, where
//                the TPU kernel rolled its lanes cyclically);
//   n_dot times  sc = sum y^2 (a whole-vector reduction, its scalar
//                broadcast), y <- y + a (0.125 y), a = 1 / (1 + sc) (0 if
//                sc = 0): the nu -> alpha -> axpy chain;
//   three freeze selects on live = (y[0] > -1e30), y[0] the problem's first
//                row (the TPU kernel tested its first row's lane sum; both
//                are true for every finite y).
// n_mv, n_dot and the trip count are runtime arguments, so nvcc cannot fold
// the loop.  The probe gives the least time an iteration of the kernel it
// bounds can take, so it runs that kernel's schedule and nothing more:
//   cluster scope (kernel B's, cluster_body.cuh): one problem on a cluster
//     of C CTAs (kernels/probes.py: fused_solve.cluster_size's C for the
//     same B and K, 16 at IIWA K = 50, B = 1), CTA r owning kernel B's knots
//     [r K / C, (r + 1) K / C), their 0.01 M scaled once into its shared
//     memory, y in shared memory; halo rows pushed into the neighbours'
//     shared memory before the barrier that follows (never pulled); each
//     reduction one cluster_sum (a shuffle tree, the warps in order, the C
//     slots in rank order: every CTA the same bits);
//   grid scope (rows 8/10's, longk.cu): one cooperative launch a round of
//     longk.pcg_rounds's plan for the same B and K (per CTAs a problem,
//     ceil(K / per) knots each, 128 CTAs at IIWA K = 1024, B = 1; 0.01 M in
//     shared memory where the plan holds S there, else read from M and
//     scaled as it is used), boundary rows published to global memory and
//     pulled after the meeting, each reduction a CTA partial (the warps in
//     order, one __syncthreads) and grid_common.cuh's meet (a grid barrier
//     for a round of one problem, flagged partials for several).
// Both scopes share the trip.  A CTA holds a halo of H knots each side
// (kernels/probes.py's plans: n_mv or the fewest own knots of a CTA, the
// smaller) and meets only where the chain's dependences require it:
//   - matvecs run in groups of H: the group's first reads the halo rows
//     the neighbours sent, the group's j-th computes the own knots and
//     H - 1 - j more each side (the owner's fmaf, so the owner's bits), a
//     __syncthreads between matvecs of a group, and the group's last sends
//     its first and last H knots to the neighbours; one meeting (a barrier,
//     no sum) between groups;
//   - each dot step is one meeting with a sum; a thread's partial of the
//     first is taken in the trip's last matvec, of each later one in the
//     loop that applies the previous step's axpy to its own rows, and the
//     halo rows take the same axpy in each CTA (so no barrier orders them);
//   - the freeze needs y[0], on the problem's first CTA: that CTA sends its
//     first row, as the trip's last matvec wrote it, before the next
//     meeting (at the cluster scope lane q of its warp 0 to rank q; at the
//     grid scope one store, loaded with the halo rows), and every CTA
//     applies the dot steps' axpys to its copy;
//   - the last axpy and the freeze are left pending on y: the next trip's
//     first matvec applies them to each operand it reads.
// So a trip meets ceil(n_mv / H) - 1 + n_dot times (n_dot >= 1; one more
// where n_dot = 0 and n_mv >= 1) and takes n_mv - ceil(n_mv / H)
// __syncthreads: at (n_mv, n_dot) = (2, 2) and H = 2 two meetings (cluster
// barriers, or grid meetings) and one __syncthreads, as few meetings as
// kernel B's and rows 8/10's iterations take.  A one-knot halo (forced)
// takes three meetings and no __syncthreads; on an H100 it ran slower at
// both scopes (a meeting costs more than a __syncthreads and a knot more of
// work each side).  The schedules they replace met 2 n_mv + 2 n_dot + 1
// times a trip (block scope: __syncthreads on one CTA, the operator in
// global memory; grid scope: a grid barrier after every phase).
// What bounds it: the chain of meetings, not bytes or operations (a trip at
// IIWA K = 50 is ~0.13 MFLOP, 2 ns at 67 TFLOP/s).
//
// Row 17, fma_chain (replaces tools/probe_throughput.py's probe D kernel,
// pallas_call at :222): trips x depth dependent block-diagonal matvecs
// y <- 0.25 (0.01 M) y + 0.5 y on y (K, s) of each problem, s = 14 (IIWA's
// state size, the TPU probe's fixed width), one CTA a problem.  Every output
// row (k, a) keeps the one order acc = m[a][0] y[0], acc = fmaf(m[a][c],
// y[c], acc) for c = 1..13, y[a] <- fmaf(0.25, acc, 0.5 y[a]), m = M * 0.01
// rounded once, so every layout computes the same bits.  Each knot's rows
// sit in one warp, so nothing waits on another warp; the knot's y lives in
// registers at each of its lanes; the layout (fma_lanes, mirrored by
// kernels/probes.py::fma_plan) is the faster of two at K knots on an H100
// (tools/fma_bench.cu, PERF.md §6):
//   up to kFmaWarpKnots = 40 knots, 16 lanes a knot (lanes 14, 15 idle), a
//     row of 0.01 M in each lane's registers, the exchange through the
//     knot's 64-byte slot in shared memory (double-buffered: the lane's row
//     stored, a __syncwarp, four 16-byte loads): at one warp a scheduler
//     (K <= 8) a matvec is its latency, 15 dependent FMAs and the exchange,
//     and each further warp a scheduler adds its ~25 instructions;
//   past that, two lanes a knot, seven rows each (98 values of 0.01 M in
//     registers, seven independent chains a lane), 14 shuffles from the
//     pair's two lanes a matvec, no shared memory and no barrier: up to 64
//     knots one warp a scheduler, whose issue (112 FP32 instructions and
//     the shuffles a matvec) bounds it.
// tools/fma_bench.cu times both beside the one-thread-a-row schedule they
// replace (y read from shared memory a row at a time, a __syncthreads a
// matvec) and other layouts.  With GATO_STAGE_STAMPS defined
// (tools/direct_stamps.py's row17 group builds that way), block 0 stamps
// %globaltimer at its start, after the loads of 0.01 M and y, after the
// first matvec, after the last and at its end, each after a
// __syncthreads.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_body.cuh"
#include "grid_common.cuh"
#include "pcg_common.cuh"

namespace cg = cooperative_groups;

namespace gato {

constexpr int kCopyThreads = 256;
constexpr float kCopyFactor = 1.0000001f;
// Row 17's width: its rows of 0.01 M live in registers.
constexpr int kFmaWidth = 14;

// n floats; vec: q and out both 16-byte aligned.
__global__ void __launch_bounds__(kCopyThreads)
null_copy_kernel(const float* __restrict__ q, float* __restrict__ out,
                 long long n, int vec) {
  const long long i = (long long)blockIdx.x * kCopyThreads + threadIdx.x;
  if (!vec) {
    if (i < n) out[i] = __fmul_rn(__ldg(q + i), kCopyFactor);
    return;
  }
  const long long n4 = n >> 2;
  if (i < n4) {
    float4 v = __ldg(reinterpret_cast<const float4*>(q) + i);
    v.x = __fmul_rn(v.x, kCopyFactor);
    v.y = __fmul_rn(v.y, kCopyFactor);
    v.z = __fmul_rn(v.z, kCopyFactor);
    v.w = __fmul_rn(v.w, kCopyFactor);
    reinterpret_cast<float4*>(out)[i] = v;
  }
  if (i < (n & 3)) out[4 * n4 + i] = __fmul_rn(__ldg(q + 4 * n4 + i), kCopyFactor);
}

__device__ __forceinline__ float freeze(float v, bool live) {
  v = live ? v : v * 0.5f;
  v = live ? v : v + 1.f;
  return live ? v : v * 0.25f;
}

// ---- Row 16's plan (kernels/probes.py chooses C, the rounds and H, and
// mirrors the layout and the threads) ----

// Threads of a cluster-scope CTA, at most: cluster_body.cuh's bound, so
// that its unrolled dot products keep their loads in registers (168 a
// thread, as kernel B).
constexpr int kChainMaxThreads = cl::kMaxThreads;

inline __host__ __device__ long long chain_round4(long long f) { return (f + 3) & ~3LL; }

// A chain CTA's dynamic shared memory, in floats, for `kn` own knots (the
// most a CTA of the launch owns) and a halo of H knots each side: at the
// cluster scope cluster_sum's fixed area first; two slots of the
// problem's first row (by trip parity); the halo rows received, by
// parity, [2][left H knots | right H knots] of s; the windows Y and Z of
// kn + 2 H knots (own knot kl at kl + H); and, where resident, 0.01 M of
// the knots [-(H - 1), kn + H - 1).
struct ChainPlan {
  int y00, inbox, Y, Z, ops, total;
};
inline __host__ __device__ ChainPlan chain_plan(int kn, int s, int H, int cluster,
                                                int resident) {
  ChainPlan P;
  long long off = cluster ? cl::kFixedFloats : 0;
  P.y00 = (int)off;
  off += 4;
  P.inbox = (int)off;
  off += chain_round4(4LL * H * s);
  const long long win = chain_round4((long long)(kn + 2 * H) * s);
  P.Y = (int)off;
  off += win;
  P.Z = (int)off;
  off += win;
  P.ops = (int)off;
  if (resident) off += chain_round4((long long)(kn + 2 * (H - 1)) * 3 * s * s);
  P.total = (int)off;
  return P;
}

// Threads of a cluster-scope CTA: one a row of its widest matvec (its own
// knots and H - 1 more each side), whole warps, from 64 to
// kChainMaxThreads.
inline __host__ __device__ int chain_threads(int kn, int s, int H) {
  const int t = ((kn + 2 * (H - 1)) * s + 31) / 32 * 32;
  return t < 64 ? 64 : (t > kChainMaxThreads ? kChainMaxThreads : t);
}

// What the chain kernels read and write: M (B, K, 3, s, s), y0 and out
// (B, K s); at the grid scope xch four H s floats a CTA of the launch (its
// first and last H knots' rows by parity), y00 two floats a problem, parts
// the meetings' words (grid_common.cuh).
struct ChainArgs {
  const float* M;
  const float* y0;
  float* out;
  float* xch;
  float* y00;
  float* parts;
  int K, s, n_mv, n_dot, trips, H;
};

// One CTA's view of its problem.
struct ChainCta {
  int K, s, k0, kn, H;
  float* Y;          // y's window: own knot kl at (kl + H) s
  float* Z;          // the next matvec's window
  float* inbox;      // halo rows received: [parity][side][H s]; side 0 knots
                     // k0 - H .., side 1 knots k0 + kn ..
  const float* ops;  // 0.01 M, knot kl at (kl + H - 1) 3 s^2, or null
  const float* Mg;   // the problem's M in global memory
};

// The steps a trip leaves pending on y: the last dot step's axpy (has_g)
// and the freeze (live false).  The next trip's first matvec applies them
// to each operand it reads, as kernel B's CTAs form their halo rows.
struct Pend {
  float g;
  bool has_g, live;
};
__device__ __forceinline__ bool idle(const Pend& p) { return !p.has_g && p.live; }
__device__ __forceinline__ float pend(float v, const Pend& p) {
  if (p.has_g) v = fmaf(p.g, v * 0.125f, v);
  return p.live ? v : freeze(v, false);
}
// How a matvec applies them: kMode 0 none, 1 the axpy alone (live), 2 all.
__device__ __forceinline__ int pend_mode(const Pend& p) {
  return idle(p) ? 0 : (p.has_g && p.live ? 1 : 2);
}
template <int kMode>
__device__ __forceinline__ float pendm(float v, const Pend& p) {
  if (kMode == 0) return v;
  if (kMode == 1) return fmaf(p.g, v * 0.125f, v);
  return pend(v, p);
}

// Knot kl's rows of the matvec's input: the halo rows received for a
// group's first matvec, else the window.
template <int kS>
__device__ __forceinline__ const float* knot_x(const ChainCta& x, int kl, bool first,
                                               int par) {
  const int s = kS > 0 ? kS : x.s;
  if (first && kl < 0) return x.inbox + 2 * par * x.H * s + (kl + x.H) * s;
  if (first && kl >= x.kn) return x.inbox + (2 * par + 1) * x.H * s + (kl - x.kn) * s;
  return x.Y + (kl + x.H) * s;
}

// Sum of m[b] x[b] in order, m scaled by 0.01 where it is M itself (kRes
// false: the same bits as the scaled copy) and x through the pending steps
// (kMode).
template <int kS, int kMode, bool kRes>
__device__ __forceinline__ float chain_dot(const float* m, const float* xv, int s_rt,
                                           const Pend& p) {
  float acc = 0.f;
  if (kS == 14) {
    // IIWA's rows and operands start on 8-byte boundaries: two floats a load.
#pragma unroll
    for (int b = 0; b < 14; b += 2) {
      const float2 mm = *reinterpret_cast<const float2*>(m + b);
      const float2 xx = *reinterpret_cast<const float2*>(xv + b);
      acc = fmaf(kRes ? mm.x : mm.x * 0.01f, pendm<kMode>(xx.x, p), acc);
      acc = fmaf(kRes ? mm.y : mm.y * 0.01f, pendm<kMode>(xx.y, p), acc);
    }
  } else if (kS > 0) {
#pragma unroll
    for (int b = 0; b < kS; ++b)
      acc = fmaf(kRes ? m[b] : m[b] * 0.01f, pendm<kMode>(xv[b], p), acc);
  } else {
    for (int b = 0; b < s_rt; ++b)
      acc = fmaf(kRes ? m[b] : m[b] * 0.01f, pendm<kMode>(xv[b], p), acc);
  }
  return acc;
}

// Row a of knot kl of 0.25 (0.01 M) y + 0.5 y: L y_{k-1} and U y_{k+1}
// only where they exist, (left + right) + mid.
template <int kS, int kMode, bool kRes>
__device__ __forceinline__ float chain_row(const ChainCta& x, int kl, int a, bool first,
                                           int par, const Pend& p) {
  const int s = kS > 0 ? kS : x.s, ss = s * s, k = x.k0 + kl;
  const float* row = kRes ? x.ops + (long long)(kl + x.H - 1) * 3 * ss + a * s
                          : x.Mg + (long long)k * 3 * ss + a * s;
  const float* xk = knot_x<kS>(x, kl, first, par);
  float left = 0.f, right = 0.f;
  if (k > 0) left = chain_dot<kS, kMode, kRes>(row, knot_x<kS>(x, kl - 1, first, par), s, p);
  const float mid = chain_dot<kS, kMode, kRes>(row + ss, xk, s, p);
  if (k < x.K - 1)
    right = chain_dot<kS, kMode, kRes>(row + 2 * ss, knot_x<kS>(x, kl + 1, first, par), s, p);
  const float y = pendm<kMode>(xk[a], p);
  return fmaf(0.25f, (left + right) + mid, 0.5f * y);
}

// One matvec into Z over the own knots and `ext` more each side (within
// [0, K)), a thread a row; each row of a group's last matvec (ext 0, rows
// in own order) goes to send(kl, a, v).
template <int kS, int kMode, bool kRes, class Send>
__device__ __forceinline__ void chain_mv(const ChainCta& x, int ext, bool first, int par,
                                         const Pend& p, Send& send) {
  const int s = kS > 0 ? kS : x.s;
  const int lo = -(ext < x.k0 ? ext : x.k0);
  const int hi = x.kn + ext < x.K - x.k0 ? x.kn + ext : x.K - x.k0;
  const int rows = (hi - lo) * s;
  for (int t = threadIdx.x; t < rows; t += blockDim.x) {
    const int kl = lo + t / s, a = t - (t / s) * s;
    const float v = chain_row<kS, kMode, kRes>(x, kl, a, first, par, p);
    x.Z[(kl + x.H) * s + a] = v;
    if (ext == 0) send(kl, a, v);
  }
}

// The trips on this CTA's knots (the note at the top), then its rows of
// out.  `y00` comes in as y0's first row.  Comm: the scope's halo and
// first-row delivery and its meetings.
template <int kS, bool kRes, class Comm>
__device__ __forceinline__ void chain_trips(ChainCta& x, const ChainArgs& a, Comm& cm,
                                            float y00, float* out) {
  const int s = kS > 0 ? kS : x.s, H = x.H, hs = H * s, n = x.kn * s;
  const int tid = threadIdx.x, nt = blockDim.x;
  Pend p{0.f, false, true};
  int par = 0;
  for (int t = 0; t < a.trips; ++t) {
    // The first dot step's partial, taken in the trip's last matvec (the
    // thread's own rows in order, as a dot step's loop takes them).
    float part0 = 0.f;
    for (int m = 0; m < a.n_mv; ++m) {
      const int j = m % H, size = H < a.n_mv - (m - j) ? H : a.n_mv - (m - j);
      const bool first = j == 0, last = j == size - 1;
      const bool tail = m == a.n_mv - 1;
      auto send = [&](int kl, int r, float v) {
        cm.send_row(x, par ^ 1, kl, r, v);
        if (tail) part0 = fmaf(v, v, part0);
      };
      const int ext = size - 1 - j;
      const int mode = m == 0 ? pend_mode(p) : 0;
      if (mode == 0)
        chain_mv<kS, 0, kRes>(x, ext, first, par, p, send);
      else if (mode == 1)
        chain_mv<kS, 1, kRes>(x, ext, first, par, p, send);
      else
        chain_mv<kS, 2, kRes>(x, ext, first, par, p, send);
      p = Pend{0.f, false, true};
      float* w = x.Y;
      x.Y = x.Z;
      x.Z = w;
      if (!last) {
        __syncthreads();
      } else if (m < a.n_mv - 1) {
        cm.barrier();
        par ^= 1;
        cm.receive(x, par, t & 1);
      }
    }
    // y[0] as the trip's last matvec wrote it (thread 0's row 0, read back
    // by its warp) to every CTA of the problem.
    if (a.n_mv > 0 && x.k0 == 0 && tid < 32) {
      __syncwarp();
      cm.send_y00(x.Y[hs], t & 1);
    }
    // Whether the last matvec's rows were sent and not yet received.
    bool sent = a.n_mv > 0;
    if (sent && a.n_dot == 0) {
      cm.barrier();
      par ^= 1;
      y00 = cm.receive(x, par, t & 1);
      sent = false;
    }
    for (int d = 0; d < a.n_dot; ++d) {
      const bool apply = !idle(p);
      float part = 0.f;
      if (d == 0 && a.n_mv > 0) {
        part = part0;
      } else {
        for (int i = tid; i < n; i += nt) {
          float v = x.Y[hs + i];
          if (apply) {
            v = pend(v, p);
            x.Y[hs + i] = v;
          }
          part = fmaf(v, v, part);
        }
      }
      if (apply && a.n_mv > 0)
        for (int e = tid; e < 2 * hs; e += nt)
          x.inbox[2 * par * hs + e] = pend(x.inbox[2 * par * hs + e], p);
      const float sc = cm.reduce(part);
      if (sent) {
        par ^= 1;
        y00 = cm.receive(x, par, t & 1);
        sent = false;
      }
      const float g = sc != 0.f ? 1.f / (1.f + sc) : 0.f;
      y00 = fmaf(g, y00 * 0.125f, y00);
      p = Pend{g, true, true};
    }
    const bool live = y00 > -1e30f;
    y00 = freeze(y00, live);
    p.live = live;
    if (a.n_mv == 0 && !idle(p)) {
      // No matvec takes the pending steps: apply them to the own rows.
      for (int i = tid; i < n; i += nt) x.Y[hs + i] = pend(x.Y[hs + i], p);
      p = Pend{0.f, false, true};
    }
  }
  for (int i = tid; i < n; i += nt) out[(long long)x.k0 * s + i] = pend(x.Y[hs + i], p);
}

// The operator window (scaled once, where resident), the own rows of y
// and the first halo rows from y0.
template <int kS, bool kRes>
__device__ __forceinline__ void chain_setup(ChainCta& x, const float* y0p, float* ops) {
  const int s = kS > 0 ? kS : x.s, H = x.H, hs = H * s, kf = 3 * s * s;
  const int tid = threadIdx.x, nt = blockDim.x;
  if (kRes) {
    const long long base = (long long)(x.k0 - H + 1) * kf;
    const int total = (x.kn + 2 * (H - 1)) * kf;
    for (int i = tid; i < total; i += nt) {
      const long long g = base + i;
      if (g >= 0 && g < (long long)x.K * kf) ops[i] = x.Mg[g] * 0.01f;
    }
  }
  for (int i = tid; i < x.kn * s; i += nt) x.Y[hs + i] = y0p[(long long)x.k0 * s + i];
  for (int e = tid; e < 2 * hs; e += nt) {
    const int side = e / hs, i = e - side * hs;
    const int k = (side == 0 ? x.k0 - H : x.k0 + x.kn) + i / s;
    if (k >= 0 && k < x.K) x.inbox[e] = y0p[(long long)k * s + i % s];
  }
}

// Cluster scope: halos and the first row pushed into the peers' shared
// memory; a barrier is a cluster barrier, a reduction cluster_sum.
struct ClusterComm {
  cl::Ctx c;
  float* y00s;
  __device__ void send_row(const ChainCta& x, int np, int kl, int r, float v) {
    const int hs = x.H * x.s;
    if (kl < x.H && c.rank > 0)
      cl::peer(c, x.inbox, c.rank - 1)[(2 * np + 1) * hs + kl * x.s + r] = v;
    if (kl >= x.kn - x.H && c.rank < c.C - 1)
      cl::peer(c, x.inbox, c.rank + 1)[2 * np * hs + (kl - x.kn + x.H) * x.s + r] = v;
  }
  // Lane q of warp 0 sends to rank q.
  __device__ void send_y00(float v, int tp) {
    if (c.tid < c.C) cl::peer(c, y00s, c.tid)[tp] = v;
  }
  __device__ void barrier() { cl::csync(c); }
  __device__ float reduce(float part) { return cl::cluster_sum(c, part); }
  // The halo rows were pushed before the barrier; returns y[0].
  __device__ float receive(ChainCta&, int, int tp) { return y00s[tp]; }
};

// Row 16 at cluster scope: cluster b / C of C CTAs is problem b, CTA rank r
// owns kernel B's knots of rank r.
template <int kS>
__global__ void __launch_bounds__(kChainMaxThreads, 1) null_chain_cluster_kernel(ChainArgs a,
                                                                                 int C) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int K = a.K, s = kS > 0 ? kS : a.s;
  const int rank = C > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const size_t b = blockIdx.x / C;
  const ChainPlan P = chain_plan(cl::cluster_knots(K, C), s, a.H, 1, 1);
  ChainCta x;
  x.K = K;
  x.s = s;
  x.k0 = cl::knot_begin(K, C, rank);
  x.kn = cl::knot_begin(K, C, rank + 1) - x.k0;
  x.H = a.H;
  x.Y = smem + P.Y;
  x.Z = smem + P.Z;
  x.inbox = smem + P.inbox;
  x.ops = smem + P.ops;
  x.Mg = a.M + b * K * 3 * s * s;
  ClusterComm cm;
  cm.c.C = C;
  cm.c.rank = rank;
  cm.c.tid = threadIdx.x;
  cm.c.nt = blockDim.x;
  cm.c.fixed = smem;
  cm.c.par = 0;
  cm.y00s = smem + P.y00;
  const float* y0p = a.y0 + b * K * s;
  chain_setup<kS, true>(x, y0p, smem + P.ops);
  cl::csync(cm.c);
  chain_trips<kS, true>(x, a, cm, y0p[0], a.out + b * K * s);
  cl::csync(cm.c);
}

// Grid scope: rows published to global memory and pulled after the
// meeting; a barrier is meet's, a reduction a block sum and meet's sum.
template <bool kFlags>
struct GridComm {
  cg::grid_group grid;
  PcgMeet m;
  float* red;
  float* xme;        // this CTA's published rows [parity][first H knots | last H knots]
  const float* xl;   // the left neighbour's, the right one's
  const float* xr;
  float* y00g;       // the problem's two first-row slots
  bool hasL, hasR;
  int kind;
  __device__ void send_row(const ChainCta& x, int np, int kl, int r, float v) {
    const int hs = x.H * x.s;
    if (kl < x.H && hasL) xme[2 * np * hs + kl * x.s + r] = v;
    if (kl >= x.kn - x.H && hasR) xme[(2 * np + 1) * hs + (kl - x.kn + x.H) * x.s + r] = v;
  }
  __device__ void send_y00(float v, int tp) {
    if (threadIdx.x == 0) y00g[tp] = v;
  }
  __device__ void barrier() { meet<kFlags>(grid, m, 0.f, kBarrierOnly, red); }
  // The CTA's partial (a shuffle tree a warp, then thread 0 adds the warps
  // in order, as cluster_sum does), then meet's sum over the problem's CTAs.
  __device__ float reduce(float part) {
    part = warp_sum(part);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = part;
    __syncthreads();
    float v = 0.f;
    if (threadIdx.x == 0) {
      v = red[0];
      for (int w = 1; w < (int)(blockDim.x >> 5); ++w) v += red[w];
    }
    const float sum = meet<kFlags>(grid, m, v, kind, red);
    kind ^= 1;
    return sum;
  }
  // Pulls the neighbours' rows into the halo rows of parity `par` and
  // returns y[0] (its load issued with theirs, one trip through L2).
  __device__ float receive(ChainCta& x, int par, int tp) {
    const int hs = x.H * x.s;
    const float y00 = __ldcg(y00g + tp);
    for (int e = threadIdx.x; e < 2 * hs; e += blockDim.x) {
      if (e < hs) {
        if (hasL) x.inbox[2 * par * hs + e] = __ldcg(xl + (2 * par + 1) * hs + e);
      } else if (hasR) {
        x.inbox[2 * par * hs + e] = __ldcg(xr + 2 * par * hs + e - hs);
      }
    }
    __syncthreads();
    return y00;
  }
};

// Row 16 at grid scope: one round of longk.pcg_rounds's plan, per CTAs a
// problem, CTA `part` owning the knots [part nk, (part + 1) nk).
template <int kS, bool kRes, bool kFlags>
__global__ void __launch_bounds__(kGridThreads, 2) null_chain_grid_kernel(ChainArgs a,
                                                                          Round rd) {
  extern __shared__ float4 smem4[];
  __shared__ float red[33];
  float* smem = reinterpret_cast<float*>(smem4);
  const int K = a.K, s = kS > 0 ? kS : a.s, hs = a.H * s;
  const size_t b = rd.first + blockIdx.x / rd.per;
  const int nk = (K + rd.per - 1) / rd.per;
  const ChainPlan P = chain_plan(nk, s, a.H, 0, kRes);
  ChainCta x;
  x.K = K;
  x.s = s;
  x.k0 = (int)(blockIdx.x % rd.per) * nk < K ? (int)(blockIdx.x % rd.per) * nk : K;
  x.kn = (x.k0 + nk < K ? x.k0 + nk : K) - x.k0;
  x.H = a.H;
  x.Y = smem + P.Y;
  x.Z = smem + P.Z;
  x.inbox = smem + P.inbox;
  x.ops = kRes ? smem + P.ops : nullptr;
  x.Mg = a.M + b * K * 3 * s * s;
  const bool hasL = x.k0 > 0, hasR = x.k0 + x.kn < K;
  GridComm<kFlags> cm{cg::this_grid(),
                      round_meet(a.parts, rd),
                      red,
                      a.xch + (size_t)blockIdx.x * 4 * hs,
                      a.xch + (size_t)(blockIdx.x - (hasL ? 1 : 0)) * 4 * hs,
                      a.xch + (size_t)(blockIdx.x + (hasR ? 1 : 0)) * 4 * hs,
                      a.y00 + 2 * b,
                      hasL,
                      hasR,
                      0};
  const float* y0p = a.y0 + b * K * s;
  chain_setup<kS, kRes>(x, y0p, smem + P.ops);
  __syncthreads();
  chain_trips<kS, kRes>(x, a, cm, y0p[0], a.out + b * K * s);
}

// ---- Row 17's plan (kernels/probes.py::fma_plan mirrors it) ----

// Floats of a knot's slot of y in shared memory (14 and two of padding).
constexpr int kFmaSlot = 16;
// The most knots the 16-lane layout takes (640 threads), and the most the
// two-lane one takes (256 threads: the 98 values of 0.01 M and the chains
// need ~146 registers a thread).
constexpr int kFmaWarpKnots = 40;
constexpr int kFmaMaxKnots = 128;

inline __host__ __device__ int fma_lanes(int K) { return K <= kFmaWarpKnots ? 16 : 2; }
inline __host__ __device__ int fma_threads(int K) { return (fma_lanes(K) * K + 31) / 32 * 32; }
inline __host__ __device__ int fma_smem_bytes(int K) {
  return fma_lanes(K) == 16 ? 2 * K * kFmaSlot * 4 : 0;
}

constexpr int kFmaStamps = 5;
#ifdef GATO_STAGE_STAMPS
static __device__ unsigned long long fma_stamps[kFmaStamps];
static __device__ int fma_stamp_count;
__global__ void fma_stamp_reset() { fma_stamp_count = 0; }
__device__ __forceinline__ void fma_stamp() {
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0 && fma_stamp_count < kFmaStamps) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    fma_stamps[fma_stamp_count++] = t;
  }
}
#else
__device__ __forceinline__ void fma_stamp() {}
#endif

// L lanes a knot, lane q of knot k owning rows q R .. q R + R - 1 (R = 1 at
// L = 16, 7 at L = 2; rows past 13 idle).  Lanes past the last knot take
// its inputs and write nothing, so that every lane of a warp runs each
// __syncwarp and shuffle.
template <int L>
__global__ void __launch_bounds__(L == 16 ? 16 * kFmaWarpKnots : 2 * kFmaMaxKnots, 1)
    fma_chain_kernel(const float* __restrict__ M, const float* __restrict__ y0,
                     float* __restrict__ out, int K, int depth, int trips) {
  constexpr int S = kFmaWidth, R = L == 16 ? 1 : S / 2;
  extern __shared__ float4 slots4[];  // L = 16: [2][K][kFmaSlot]
  fma_stamp();
  const int q = threadIdx.x % L, k = threadIdx.x / L;
  const int kk = k < K ? k : K - 1;
  const bool own = k < K && q * R < S;
  const int base = (threadIdx.x & 31) - q;
  const size_t b = blockIdx.x;
  const float* Mk = M + (b * K + kk) * S * S;
  const float* yk = y0 + (b * K + kk) * S;
  float m[R][S], y[kFmaSlot], yo[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = q * R + r;
#pragma unroll
    for (int c = 0; c < S; ++c) m[r][c] = row < S ? Mk[row * S + c] * 0.01f : 0.f;
    yo[r] = row < S ? yk[row] : 0.f;
  }
#pragma unroll
  for (int c = 0; c < kFmaSlot; ++c) y[c] = c < S ? yk[c] : 0.f;
  float* slots = reinterpret_cast<float*>(slots4);
  // One matvec on the lane's rows, then the knot's new y into every lane.
  auto matvec = [&](int par) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = m[r][0] * y[0];
#pragma unroll
    for (int c = 1; c < S; ++c)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(m[r][c], y[c], acc[r]);
#pragma unroll
    for (int r = 0; r < R; ++r) yo[r] = fmaf(0.25f, acc[r], 0.5f * yo[r]);
    if (L == 16) {
      float* slot = slots + (par * K + kk) * kFmaSlot;
      if (own) slot[q] = yo[0];
      __syncwarp();
#pragma unroll
      for (int v = 0; v < kFmaSlot / 4; ++v) {
        const float4 t = reinterpret_cast<const float4*>(slot)[v];
        y[4 * v] = t.x;
        y[4 * v + 1] = t.y;
        y[4 * v + 2] = t.z;
        y[4 * v + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int src = 0; src < L; ++src)
#pragma unroll
        for (int r = 0; r < R; ++r) y[src * R + r] = __shfl_sync(0xffffffffu, yo[r], base + src);
    }
  };
  fma_stamp();
  // trips x depth matvecs; the first alone (for the stamps), then in pairs
  // so that the slots' parity is fixed in the code.
  const long long n = (long long)trips * depth;
  if (n > 0) matvec(1);
  fma_stamp();
  long long i = 1;
  for (; i + 1 < n; i += 2) {
    matvec(0);
    matvec(1);
  }
  if (i < n) matvec(0);
  fma_stamp();
  if (k < K) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (q * R + r < S) out[(b * K + k) * S + q * R + r] = yo[r];
  }
  fma_stamp();
}

}  // namespace gato

extern "C" {

// Launches row 18 on `stream`: out = q * 1.0000001 on B problems of n
// floats each.  Returns the CUDA error code (0 on success); nothing is
// synchronised.
int gato_null_copy(const float* q, float* out, int B, int n, void* stream) {
  const long long total = (long long)B * n;
  if (total <= 0) return 0;
  const int vec = (((uintptr_t)q | (uintptr_t)out) & 15u) == 0;
  const long long n4 = total >> 2;
  const long long threads = vec ? (n4 > (total & 3) ? n4 : (total & 3)) : total;
  const long long grid = (threads + gato::kCopyThreads - 1) / gato::kCopyThreads;
  gato::null_copy_kernel<<<(unsigned)grid, gato::kCopyThreads, 0,
                           (cudaStream_t)stream>>>(q, out, total, vec);
  return (int)cudaGetLastError();
}

// Row 16's layout and threads (kernels/probes.py mirrors them).
long long gato_null_chain_smem_bytes(int kn, int s, int H, int cluster, int resident) {
  return gato::chain_plan(kn, s, H, cluster, resident).total * 4LL;
}
int gato_null_chain_threads(int kn, int s, int H) { return gato::chain_threads(kn, s, H); }

// Launches row 16 at cluster scope on `stream`: B clusters of C CTAs of
// `threads` threads (kernels/probes.py's plan: C, H, threads), halo depth
// H.  Returns the CUDA error code (0 on success); nothing is synchronised.
int gato_null_chain_cluster(const float* M, const float* y0, float* out, int B, int K,
                            int s, int n_mv, int n_dot, int trips, int C, int H,
                            int threads, void* stream) {
  gato::ChainArgs a{M, y0, out, nullptr, nullptr, nullptr, K, s, n_mv, n_dot, trips, H};
  const size_t smem =
      (size_t)gato::chain_plan(gato::cl::cluster_knots(K, C), s, H, 1, 1).total * 4;
  const auto kernel =
      s == 14 ? gato::null_chain_cluster_kernel<14> : gato::null_chain_cluster_kernel<0>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = gato::cl::launch_config_sized(kernel, B, C, threads, smem,
                                                  (cudaStream_t)stream, &cfg, &attr);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, a, C);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Launches row 16 at grid scope on `stream` for one round of
// longk.pcg_rounds's plan: problems first .. first + nprob - 1, `per` CTAs
// each, 0.01 M in shared memory iff `resident`, meeting by flagged
// partials (flag_meet 1) or grid barriers (0, only for nprob 1); halo
// depth H.  xch holds nprob per 4 H s floats, y00 two floats a problem of
// the call, parts 8 nprob per (zeroed here for flag_meet).  Returns the
// CUDA error code (0 on success).
int gato_null_chain_grid(const float* M, const float* y0, float* out, float* xch,
                         float* y00, float* parts, int first, int nprob, int per,
                         int resident, int flag_meet, int K, int s, int n_mv, int n_dot,
                         int trips, int H, void* stream) {
  if (!flag_meet && nprob != 1) return (int)cudaErrorInvalidValue;
  const int nk = (K + per - 1) / per;
  const size_t smem = (size_t)gato::chain_plan(nk, s, H, 0, resident).total * 4;
  const bool w = s == 14;
  const void* kernel =
      resident ? (flag_meet ? (w ? (const void*)gato::null_chain_grid_kernel<14, true, true>
                                 : (const void*)gato::null_chain_grid_kernel<0, true, true>)
                            : (w ? (const void*)gato::null_chain_grid_kernel<14, true, false>
                                 : (const void*)gato::null_chain_grid_kernel<0, true, false>))
               : (flag_meet ? (w ? (const void*)gato::null_chain_grid_kernel<14, false, true>
                                 : (const void*)gato::null_chain_grid_kernel<0, false, true>)
                            : (w ? (const void*)gato::null_chain_grid_kernel<14, false, false>
                                 : (const void*)gato::null_chain_grid_kernel<0, false, false>));
  cudaError_t err = gato::opt_in_smem(kernel, smem);
  if (err == cudaSuccess && flag_meet)
    err = cudaMemsetAsync(parts, 0, (size_t)nprob * per * 8 * sizeof(float),
                          (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  gato::ChainArgs a{M, y0, out, xch, y00, parts, K, s, n_mv, n_dot, trips, H};
  gato::Round rd{first, nprob, per, 0};
  void* args[] = {&a, &rd};
  err = cudaLaunchCooperativeKernel(kernel, dim3(nprob * per), dim3(gato::kGridThreads),
                                    args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no sticky error behind
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// Row 17's plan (kernels/probes.py mirrors it): lanes a knot, threads and
// dynamic shared bytes of a CTA at K knots.
int gato_fma_chain_lanes(int K) { return gato::fma_lanes(K); }
int gato_fma_chain_threads(int K) { return gato::fma_threads(K); }
long long gato_fma_chain_smem_bytes(int K) { return gato::fma_smem_bytes(K); }

// Launches row 17 on `stream`: B problems of K knots of width 14 (1 <= K <=
// 128), one CTA each, depth x trips matvecs.  Returns the CUDA error code.
int gato_fma_chain(const float* M, const float* y0, float* out, int B, int K,
                   int depth, int trips, void* stream) {
  if (K < 1 || K > gato::kFmaMaxKnots) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#ifdef GATO_STAGE_STAMPS
  gato::fma_stamp_reset<<<1, 1, 0, st>>>();
#endif
  const int threads = gato::fma_threads(K);
  if (gato::fma_lanes(K) == 16)
    gato::fma_chain_kernel<16><<<B, threads, gato::fma_smem_bytes(K), st>>>(M, y0, out, K,
                                                                            depth, trips);
  else
    gato::fma_chain_kernel<2><<<B, threads, 0, st>>>(M, y0, out, K, depth, trips);
  return (int)cudaGetLastError();
}

// The stamps of row 17's last launch (block 0; %globaltimer, ns) into
// out[0..5); returns their count, 0 in a build without GATO_STAGE_STAMPS.
int gato_fma_stamps(unsigned long long* out) {
#ifdef GATO_STAGE_STAMPS
  int n = 0;
  if (cudaMemcpyFromSymbol(&n, gato::fma_stamp_count, sizeof(int)) != cudaSuccess ||
      cudaMemcpyFromSymbol(out, gato::fma_stamps, sizeof(gato::fma_stamps)) != cudaSuccess)
    return 0;
  return n;
#else
  (void)out;
  return 0;
#endif
}

}  // extern "C"
