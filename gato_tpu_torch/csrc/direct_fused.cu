// Row 4: the whole exact solve (condensation, block cyclic reduction, the
// true residual and the recovery) in one launch, batched.
//
// Replaces gato_tpu/kernels/direct_fused.py::_direct_kernel (the pallas_call
// in _call_direct, entry solve_direct_fused_batched) with its _cr_solve.
// Plain version and wrapper: gato_tpu_torch/kernels/direct_fused.py.
//
// Design: one thread-block cluster of C CTAs a problem, kernel B's layout
// (cluster_body.cuh): CTA r owns the knots [r K / C, (r+1) K / C) and one
// record of each (S, its working copy W in kernel B's Pinv slot, Qinv,
// Rinv, B Rinv), in its shared memory where the records fit
// (direct_smem_floats), else in a global scratch slice: one pointer choice
// for the launch (`ops_in_smem`).  C comes from kernels/direct_fused.py's
// cluster_size: kernel B's rule with this kernel's plan.
//   1. The condensation is kernel B's stages 1, 2 and 4 (invert_qr,
//      condense_rows writing W = S and no preconditioner, gamma_rows);
//      gamma is kept, b = gamma is reduced.
//   2. Cyclic reduction, the recurrences of direct.btd_solve_cr on W in
//      place: level h eliminates the rows k = h mod 2h of the surviving
//      rows k = 0 mod h.  Each CTA inverts its own odd rows' D in place, a
//      warp a row (warp_gj.cuh's warp_gj_pad), then one cluster barrier;
//      then it copies the at most two odd neighbours that other CTAs hold
//      (the left one of its first even row, the right one of its last:
//      L, D^{-1}, U and b) into its shared memory (from distributed shared
//      memory, or the global slice) and reduces its even rows, an entry a
//      thread in two phases, eight even rows at a time: A = L D_l^{-1},
//      B = U D_r^{-1}, then L' = -A L_l, D' = (D - A U_l) - B L_r,
//      U' = -B U_r, b' = (b - A b_l) - B b_r.  (A thread a row of an even
//      row, A and B in registers, took 8-17 us a level on an H100 at IIWA
//      K = 50, B = 1.)  No other cluster barrier: a level reads only its
//      odd rows, which nothing writes again, and each CTA writes only its
//      own rows.  The root (row 0, on CTA 0), then back-substitution level
//      by level, a cluster barrier each: x_k = D_k^{-1} ((b_k - L_k
//      x_{k-h}) - U_k x_{k+h}) for the odd rows, the two even neighbours
//      held by other CTAs copied first.
//   3. eta = ||gamma - S lambda||^2 against the kept S (lambda's boundary
//      rows pushed into the neighbours' halos, as kernel B's recovery
//      does), ||gamma||^2, converged = eta <= 1e-6 (1 + ||gamma||^2)
//      (direct.residual_converged); two cluster sums in rank order.
//   4. The recovery: kernel B's stage 6 (recover_rows).
// A problem in which a used inversion (Q, R, a level's odd rows or the
// root) clamped a zero pivot in a block whose diagonal is not all zero gets
// eta += 1e30 (finite, as on the TPU) and so converged = False; its lambda
// and dz stay finite.
//
// What bounds it on an H100: latency.  The one-CTA kernel this replaces
// spent most of its ~0.55 ms at IIWA K = 50, B = 1 in a one-block
// Gauss-Jordan condensation (a barrier a pivot) and ran ceil(log2 K) levels
// of three barrier phases on S's copy in global memory, on one SM.  Here
// the condensation is kernel B's (~15 us on 16 CTAs) and a level is a warp
// inverse, one cluster barrier and a product phase; a wide batch takes the
// rule's floor (C = 2 at IIWA: records in shared memory), B C CTAs in
// waves of the card's SMs.
//
// With GATO_STAGE_STAMPS defined (gato_tpu_torch/tools/direct_stamps.py
// builds that way; the default build does not), block 0 stamps
// %globaltimer at its start, after the condensation, after each level,
// the root and each back-substitution level, after the residual and at
// its end.
#include <cuda_runtime.h>

#include "cluster_body.cuh"
#include "warp_gj.cuh"

namespace gato {

constexpr int kDirectStamps = 64;
#ifdef GATO_STAGE_STAMPS
static __device__ unsigned long long direct_stamps[kDirectStamps];
static __device__ int direct_stamp_count;
__global__ void direct_stamp_reset() { direct_stamp_count = 0; }
__device__ __forceinline__ void direct_stamp() {
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0 && direct_stamp_count < kDirectStamps) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    direct_stamps[direct_stamp_count++] = t;
  }
}
#else
__device__ __forceinline__ void direct_stamp() {}
#endif

// DIRECT_CONV_RTOL^2 of direct.residual_converged: an exact solve converged
// when eta <= kDirectRtolSq * (1 + ||gamma||^2).
constexpr float kDirectRtolSq = 1e-6f;

// ---- The plan (host and device; mirrored in kernels/direct_fused.py) ----

// Even rows whose A and B a level keeps at a time.
constexpr int kCrChunk = 8;

// Shared floats of the copies of two odd rows held by other CTAs: L, D^{-1}
// and U (3 s^2) and b (s) each.
inline __host__ __device__ long long cr_copy_floats(int s) { return 2LL * (3LL * s * s + s); }

// Dynamic shared memory of one CTA, in floats: kernel B's plan
// (cluster_smem_floats) with a union area that also holds gamma, b, the
// back-substitution's temporary, the copied odd rows and A and B of up to
// kCrChunk even rows.
inline __host__ __device__ long long direct_smem_floats(int K, int s, int c, int C,
                                                        int ops_in_smem) {
  const int kn = cl::cluster_knots(K, C), nt = cl::cluster_threads(K, s, c, C);
  long long uni = cl::gj_area_floats(kn + 1, s, nt);
  const long long gjc = cl::gj_area_floats(kn, c, nt);
  const long long rec = 7LL * kn * s + (long long)kn * c;
  const int chunk = (kn + 1) / 2 < kCrChunk ? (kn + 1) / 2 : kCrChunk;
  const long long cr = 3LL * kn * s + cr_copy_floats(s) + chunk * 2LL * s * s;
  if (gjc > uni) uni = gjc;
  if (rec > uni) uni = rec;
  if (cr > uni) uni = cr;
  return cl::kFixedFloats + (ops_in_smem ? kn * cl::record_floats(s, c) : 0) +
         (long long)kn * s + 2LL * cl::kNumVec * s + 3LL * s * s + uni;
}

// The first k >= k0 with k = off mod h2, and how many such k lie below k1.
__device__ __forceinline__ int first_at(int k0, int h2, int off) {
  return k0 + ((off - k0) % h2 + h2) % h2;
}
__device__ __forceinline__ int count_below(int first, int k1, int h2) {
  return first < k1 ? (k1 - 1 - first) / h2 + 1 : 0;
}

// The CTA of the cluster that owns knot k (the inverse of knot_begin).
__device__ __forceinline__ int owner(const cl::Ctx& x, int k) {
  return (int)(((long long)(k + 1) * x.C - 1) / x.K);
}

// Knot k's record, any CTA's: through distributed shared memory, or in the
// problem's global slice (where x.rec is the slice at knot k0).
__device__ __forceinline__ const float* record_of(const cl::Ctx& x, int k, bool in_smem) {
  if (!in_smem || (k >= x.k0 && k < x.k1)) return x.rec + (long long)(k - x.k0) * x.recsz;
  const int o = owner(x, k);
  return cl::peer(x, x.rec, o) + (long long)(k - cl::knot_begin(x.K, x.C, o)) * x.recsz;
}

// Knot k's rows of vector v, any CTA's (the union area's vectors are laid
// out by each CTA's own knot count).
__device__ __forceinline__ const float* rows_of(const cl::Ctx& x, int v, int k) {
  if (k >= x.k0 && k < x.k1) return cl::vec(x, v) + (k - x.k0) * x.s;
  const int o = owner(x, k), k0 = cl::knot_begin(x.K, x.C, o);
  const int kn = cl::knot_begin(x.K, x.C, o + 1) - k0;
  float* base = v == cl::kLam ? x.lam : x.uni + (long long)(v - 1) * kn * x.s;
  return cl::peer(x, base, o) + (k - k0) * x.s;
}

// The rows another CTA holds that a level reads, into `copy`: W's three
// blocks (`run` floats; none where run = 0) then the s entries of a vector,
// of the left row (wl, vl) then the right one (wr, vr); a null vector
// skips its side.  Four independent loads a thread at a time, so that the
// latencies of distributed shared memory overlap.  Ends synchronised.
__device__ __forceinline__ void copy_rows(float* copy, const float* wl, const float* vl,
                                          const float* wr, const float* vr, int run, int s,
                                          int tid, int nt) {
  const int per = run + s;
  for (int e0 = tid; e0 < 2 * per; e0 += 4 * nt) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * nt, side = e >= per, f = e - side * per;
      const float* vec = side ? vr : vl;
      v[u] = 0.f;
      if (e < 2 * per && vec != nullptr) v[u] = f < run ? (side ? wr : wl)[f] : vec[f - run];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * nt;
      if (e < 2 * per && (e >= per ? vr : vl) != nullptr) copy[e] = v[u];
    }
  }
  __syncthreads();
}

// D (s x s, in place) inverted by the calling warp; 1 on every lane where a
// zero pivot was clamped in a block whose diagonal is not all zero.
template <int kS>
__device__ __forceinline__ int warp_invert(float* D, int s) {
  if (kS > 0) return warp_gj_pad<(kS > 0 ? kS : 1)>(D, D, s);
  return s <= 16 ? warp_gj_pad<16>(D, D, s) : warp_gj_pad<32>(D, D, s);
}

template <int kS, int kC>
__global__ void __launch_bounds__(cl::kMaxThreads, 1)
direct_cluster_kernel(const float* Qg, const float* Rg, const float* Ag,
                      const float* Bg, const float* qg, const float* rg,
                      const float* cg, float* scratch, float* lam_out,
                      float* dzx_out, float* dzu_out, int* conv_out,
                      float* eta_out, int K, int s_rt, int c_rt, float rho, int C) {
  constexpr int kCapS = kS > 0 ? kS : cl::kMaxWidth;
  extern __shared__ float smem[];
  if (C > 1) cooperative_groups::this_cluster().sync();  // all CTAs running
  const int s = kS > 0 ? kS : s_rt, c = kC > 0 ? kC : c_rt;
  const int ss = s * s;
  const long long b = blockIdx.x / C;
  const long long sc = (long long)s * c, cc2 = (long long)c * c;
  const long long n = (long long)K * s, nu = (long long)(K - 1) * c;
  const cl::Problem pb{Qg + b * K * ss,      Rg + b * (K - 1) * cc2,
                       Ag + b * (K - 1) * ss, Bg + b * (K - 1) * sc,
                       qg + b * n,           rg + b * nu,
                       cg + b * n,           nullptr,
                       lam_out + b * n,      dzx_out + b * n,
                       dzu_out + b * nu,     nullptr,
                       nullptr,              nullptr};
  const bool in_smem = scratch == nullptr;
  cl::Ctx x = cl::make_ctx(smem, in_smem ? nullptr : scratch + b * K * cl::record_floats(s, c),
                           K, s, c, C);
  const int k0 = x.k0, k1 = x.k1, rows = x.kn * s;
  const int oW = 3 * ss;  // W's blocks in a record: L, D, U
  const int lane = x.tid & 31, warp = x.tid >> 5, nwarps = x.nt >> 5;
  int* bad = reinterpret_cast<int*>(x.fixed + cl::kBad);
  if (x.tid == 0) *bad = 0;
  __syncthreads();
  direct_stamp();

  // 1. Condensation: Qinv, Rinv, S and W = S, gamma (kept) and b = gamma.
  cl::invert_qr<kS, kC, false>(x, pb, rho, bad);
  cl::condense_rows<kS, kC>(x, pb, cl::kCopyW);
  float* gam = cl::vec(x, cl::kR0);
  float* bv = cl::vec(x, cl::kR1);
  float* tmp = cl::vec(x, cl::kP0);
  float* copy = x.uni + 3LL * x.kn * s;  // two odd rows, or two rows of x
  float* fac = copy + cr_copy_floats(s);  // A and B of kCrChunk even rows
  cl::gamma_rows<kS, kC>(x, pb, gam);
  for (int t = x.tid; t < rows; t += x.nt) bv[t] = gam[t];
  __syncthreads();
  direct_stamp();

  // 2. Block cyclic reduction.
  int h = 1;
  for (; h < K; h *= 2) {
    const int h2 = 2 * h;
    const int fo = first_at(k0, h2, h), no = count_below(fo, k1, h2);
    for (int i = warp; i < no; i += nwarps) {
      float* D = x.rec + (long long)(fo + i * h2 - k0) * x.recsz + oW + ss;
      if (warp_invert<kS>(D, s) && lane == 0) *bad = 1;
    }
    cl::csync(x);
    const int fe = first_at(k0, h2, 0), ne = count_below(fe, k1, h2);
    const int jl = fe - h, jr = fe + (ne - 1) * h2 + h;
    const bool copy_l = ne > 0 && jl >= 0 && jl < k0;
    const bool copy_r = ne > 0 && jr < K && jr >= k1;
    if (copy_l || copy_r) {
      const float* wl = copy_l ? record_of(x, jl, in_smem) + oW : nullptr;
      const float* wr = copy_r ? record_of(x, jr, in_smem) + oW : nullptr;
      const float* vl = copy_l ? rows_of(x, cl::kR1, jl) : nullptr;
      const float* vr = copy_r ? rows_of(x, cl::kR1, jr) : nullptr;
      copy_rows(copy, wl, vl, wr, vr, 3 * ss, s, x.tid, x.nt);
    }
    // A = L D_l^{-1} and B = U D_r^{-1} of kCrChunk even rows at a time,
    // an entry a thread; then L' = -A L_l, D' = (D - A U_l) - B L_r,
    // U' = -B U_r, b' = (b - A b_l) - B b_r, an entry a thread, in place (a
    // thread reads only its own entry of the even row).
    for (int c0 = 0; c0 < ne; c0 += kCrChunk) {
      const int nc = ne - c0 < kCrChunk ? ne - c0 : kCrChunk;
      for (int t = x.tid; t < nc * ss; t += x.nt) {
        const int ic = t / ss, e = t - ic * ss, a = e / s, j = e - a * s;
        const int i = fe + (c0 + ic) * h2;
        const float* Wi = x.rec + (long long)(i - k0) * x.recsz + oW;
        const float* Wl = i - h < k0 ? copy : x.rec + (long long)(i - h - k0) * x.recsz + oW;
        const float* Wr = i + h >= k1 ? copy + 3 * ss + s
                                      : x.rec + (long long)(i + h - k0) * x.recsz + oW;
        float* T = fac + (long long)ic * 2 * ss;
        T[e] = i >= h ? cl::dot_col<kS>(Wi + a * s, Wl + ss, j, s) : 0.f;
        T[ss + e] = i + h < K ? cl::dot_col<kS>(Wi + 2 * ss + a * s, Wr + ss, j, s) : 0.f;
      }
      __syncthreads();
      for (int t = x.tid; t < nc * (ss + s); t += x.nt) {
        const int ic = t / (ss + s), e = t - ic * (ss + s), i = fe + (c0 + ic) * h2;
        const bool hl = i >= h, hr = i + h < K;
        float* Wi = x.rec + (long long)(i - k0) * x.recsz + oW;
        const float* Wl = i - h < k0 ? copy : x.rec + (long long)(i - h - k0) * x.recsz + oW;
        const float* Wr = i + h >= k1 ? copy + 3 * ss + s
                                      : x.rec + (long long)(i + h - k0) * x.recsz + oW;
        const float* TA = fac + (long long)ic * 2 * ss;
        const float* TB = TA + ss;
        if (e < ss) {
          const int a = e / s, j = e - a * s;
          float l = 0.f, au = 0.f, u = 0.f, bl = 0.f;
          if (hl) {
            l = cl::dot_col<kS>(TA + a * s, Wl, j, s);
            au = cl::dot_col<kS>(TA + a * s, Wl + 2 * ss, j, s);
          }
          if (hr) {
            u = cl::dot_col<kS>(TB + a * s, Wr + 2 * ss, j, s);
            bl = cl::dot_col<kS>(TB + a * s, Wr, j, s);
          }
          Wi[e] = -l;
          Wi[ss + e] = (Wi[ss + e] - au) - bl;
          Wi[2 * ss + e] = -u;
        } else {
          const int a = e - ss;
          const float* bl = i - h < k0 ? copy + 3 * ss : bv + (i - h - k0) * s;
          const float* br = i + h >= k1 ? copy + 6 * ss + s : bv + (i + h - k0) * s;
          const float ab = hl ? cl::dot<kS>(TA + a * s, bl, s) : 0.f;
          const float bb = hr ? cl::dot<kS>(TB + a * s, br, s) : 0.f;
          float* bi = bv + (i - k0) * s + a;
          *bi = (*bi - ab) - bb;
        }
      }
      __syncthreads();
    }
    direct_stamp();
  }

  // The root: row 0 alone, on CTA 0.
  if (x.rank == 0) {
    float* D0 = x.rec + oW + ss;
    if (warp == 0 && warp_invert<kS>(D0, s) && lane == 0) *bad = 1;
    __syncthreads();
    for (int a = x.tid; a < s; a += x.nt) x.lam[a] = cl::dot<kS>(D0 + a * s, bv, s);
  }
  direct_stamp();

  // Back-substitution, level by level: x_k = D_k^{-1} ((b_k - L_k x_{k-h})
  // - U_k x_{k+h}) for the odd rows of each level, x_{k+h} zero past the end.
  for (h /= 2; h >= 1; h /= 2) {
    const int h2 = 2 * h;
    cl::csync(x);
    const int fo = first_at(k0, h2, h), no = count_below(fo, k1, h2);
    const int jl = fo - h, jr = fo + (no - 1) * h2 + h;
    const bool copy_l = no > 0 && jl < k0, copy_r = no > 0 && jr < K && jr >= k1;
    if (copy_l || copy_r) {
      copy_rows(copy, nullptr, copy_l ? rows_of(x, cl::kLam, jl) : nullptr, nullptr,
                copy_r ? rows_of(x, cl::kLam, jr) : nullptr, 0, s, x.tid, x.nt);
    }
    for (int t = x.tid; t < no * s; t += x.nt) {
      const int io = t / s, a = t - io * s, k = fo + io * h2, kl = k - k0;
      const float* Wk = x.rec + (long long)kl * x.recsz + oW;
      const float* xl = k - h < k0 ? copy : x.lam + (kl - h) * s;
      const float lx = cl::dot<kS>(Wk + a * s, xl, s);
      float ux = 0.f;
      if (k + h < K)
        ux = cl::dot<kS>(Wk + 2 * ss + a * s, k + h >= k1 ? copy + s : x.lam + (kl + h) * s, s);
      tmp[kl * s + a] = (bv[kl * s + a] - lx) - ux;
    }
    __syncthreads();
    for (int t = x.tid; t < no * s; t += x.nt) {
      const int io = t / s, a = t - io * s, kl = fo + io * h2 - k0;
      const float* Wk = x.rec + (long long)kl * x.recsz + oW;
      x.lam[kl * s + a] = cl::dot<kS>(Wk + ss + a * s, tmp + kl * s, s);
    }
    __syncthreads();
    direct_stamp();
  }

  // 3. The true residual against the kept S, and ||gamma||^2.
  cl::push_lam(x);
  cl::csync(x);
  float part = 0.f, gpart = 0.f;
  const cl::Blocks Sm{x.rec, x.recsz};
  for (int t = x.tid; t < rows; t += x.nt) {
    const int kl = t / s, a = t - kl * s;
    const float res = gam[t] - cl::btd_row<kS>(x, Sm, cl::kLam, kl, a);
    part = fmaf(res, res, part);
    gpart = fmaf(gam[t], gam[t], gpart);
  }
  float eta = cl::cluster_sum(x, part, bad);
  const float gnorm = cl::cluster_sum(x, gpart);
  if (*bad != 0) eta += cl::kFrozenEta;
  direct_stamp();

  // 4. Recovery (gamma's vector holds its temporary).
  cl::recover_rows<kS, kC>(x, pb);
  if (x.tid == 0 && x.rank == 0) {
    eta_out[b] = eta;
    conv_out[b] = eta <= kDirectRtolSq * (1.f + gnorm) ? 1 : 0;
  }
  direct_stamp();
}

using DirectKernel = void (*)(const float*, const float*, const float*, const float*,
                              const float*, const float*, const float*, float*, float*,
                              float*, float*, int*, float*, int, int, int, float, int);
// The kernel for (s, c): compiled-in widths for IIWA and the pendulum.
inline DirectKernel direct_kernel_for(int s, int c) {
  if (s == 14 && c == 7) return direct_cluster_kernel<14, 7>;
  if (s == 2 && c == 1) return direct_cluster_kernel<2, 1>;
  return direct_cluster_kernel<0, 0>;
}

}  // namespace gato

extern "C" {

// The shared memory of the one-CTA-a-problem row 4 (its Gauss-Jordan
// arena of at most 64 KB and four vectors), in bytes: it no longer sizes a
// launch; it fixes the horizons row 4 serves (kernels/direct_fused.py's
// smem_bytes and fits), so that the routing stays where it was.
long long gato_direct_smem_bytes(int K, int s, int c) {
  auto gj = [](long long m) { return 2 * m * m + 3 * m + 2; };
  long long arena = gj(s) > gj(c) ? gj(s) : gj(c);
  const long long wide = (long long)K * gj(s) < 16384 ? (long long)K * gj(s) : 16384;
  if (wide > arena) arena = wide;
  const long long a = (long long)K * s, v = (K - 1LL) * c;
  return (arena + 4 * (a > v ? a : v)) * (long long)sizeof(float);
}

// The plan's mirrors (kernels/direct_fused.py holds the same functions).
long long gato_direct_cluster_smem_bytes(int K, int s, int c, int C, int ops_in_smem) {
  return gato::direct_smem_floats(K, s, c, C, ops_in_smem) * 4;
}

// Floats of global scratch one problem needs when its records do not fit
// shared memory: K records.
long long gato_direct_scratch_floats(int K, int s, int c) {
  return (long long)K * gato::cl::record_floats(s, c);
}

// Clusters of C CTAs of row 4 at (K, s, c) that the card holds at once
// (cudaOccupancyMaxActiveClusters); 0 means such a cluster cannot run.  A
// negative value is a CUDA error code, negated.
int gato_direct_max_clusters(int K, int s, int c, int C, int ops_in_smem) {
  return gato::cl::max_active_clusters_sized(
      gato::direct_kernel_for(s, c), C, gato::cl::cluster_threads(K, s, c, C),
      (size_t)gato::direct_smem_floats(K, s, c, C, ops_in_smem) * 4);
}

// Launches row 4 on `stream` for B problems in clusters of C CTAs;
// `scratch` holds B * gato_direct_scratch_floats(K, s, c) floats when the
// records do not fit shared memory (ops_in_smem 0), else it is null.
// Returns the CUDA error code of the launch (0 on success); nothing is
// synchronised.
int gato_direct_fused(const float* Q, const float* R, const float* A,
                      const float* Bm, const float* q, const float* r,
                      const float* c, float* scratch, float* lam, float* dzx,
                      float* dzu, int* conv, float* eta, int B, int K, int s,
                      int cdim, float rho, int C, int ops_in_smem, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const auto kernel = gato::direct_kernel_for(s, cdim);
  cudaError_t err = gato::cl::launch_config_sized(
      kernel, B, C, gato::cl::cluster_threads(K, s, cdim, C),
      (size_t)gato::direct_smem_floats(K, s, cdim, C, ops_in_smem) * 4,
      (cudaStream_t)stream, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
#ifdef GATO_STAGE_STAMPS
  gato::direct_stamp_reset<<<1, 1, 0, (cudaStream_t)stream>>>();
#endif
  err = cudaLaunchKernelEx(&cfg, kernel, Q, R, A, Bm, q, r, c,
                           ops_in_smem ? nullptr : scratch, lam, dzx, dzu, conv, eta,
                           K, s, cdim, rho, C);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The stamps of the last launch (block 0; %globaltimer, ns) into
// out[0..kDirectStamps); returns their count, 0 in a build without
// GATO_STAGE_STAMPS.
int gato_direct_stamps(unsigned long long* out) {
#ifdef GATO_STAGE_STAMPS
  int n = 0;
  if (cudaMemcpyFromSymbol(&n, gato::direct_stamp_count, sizeof(int)) != cudaSuccess ||
      cudaMemcpyFromSymbol(out, gato::direct_stamps, sizeof(gato::direct_stamps)) !=
          cudaSuccess)
    return 0;
  return n;
#else
  (void)out;
  return 0;
#endif
}

}  // extern "C"
