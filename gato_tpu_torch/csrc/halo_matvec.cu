// Row 15: the block-tridiagonal matvec of one knot shard, its halo rows
// taken from the neighbouring shards.
//
// Replaces gato_tpu/parallel/sharded.py's _mv_halo_kernel (pallas_call at
// :136, through _packed_matvec):
//
//   y_k = L_k x_{k-1} + D_k x_k + U_k x_{k+1},   k = 0 .. Kl-1,
//
// with x_{-1} = left and x_{Kl} = right, the boundary rows of the shards on
// either side; a null left or right is zeros (the trajectory's two ends),
// so no caller allocates or fills a halo.  Plain version and wrapper:
// gato_tpu_torch/kernels/halo_matvec.py.  Layout: S (Kl, 3, s, s) row-major
// blocks, slots 0 = L (column k-1), 1 = D, 2 = U (column k+1); x and y
// (Kl, s); left and right (s).
//
// What bounds it on an H100.  A launch reads 12 s^2 Kl bytes of operator
// and 8 s Kl of vectors and does 6 s^2 Kl flops, half a flop a byte: memory,
// 0.19 us at IIWA's s = 14, Kl = 256 (602 KB) and 1.5 us at Kl = 2048
// (4.8 MB) over 3.35 TB/s.  Every float of S is used exactly once, so
// nothing is gained by keeping it anywhere on the SM: what matters is how
// many loads are in flight at once, on how many SMs, and how few
// instructions each loaded float costs after it arrives.  At the sharded
// loop's Kl = 256 the launch itself and one round trip to memory are most
// of the time.
//
// Design.  One warp a block row, two warps a CTA: Kl = 256 launches 128
// CTAs over the card's 132 SMs, Kl = 2048 1,024, all resident at once.
// The vector path (even s, S 16-byte aligned: every block row, slot and
// pair of rows then starts on a 16-byte boundary):
//  1. The warp cuts each slot's s x s block into groups of r rows, r = 1
//     if 4 divides s, else 2, so that a group is m = r s / 4 whole float4;
//     a load instruction covers G = 32 / m groups, lane q m + p taking
//     float4 p of group G i + q.  At s = 14: groups of two rows (7 float4),
//     4 groups (28 lanes, 448 contiguous bytes) an instruction, 6 16-byte
//     loads a lane for the row's 3 s^2 floats.  Each lane issues all of
//     them, through the read-only path (__ldg), before any arithmetic, and
//     neighbouring lanes read neighbouring addresses.  S is not staged in
//     shared memory; the default L2 policy is kept, since the sharded PCG
//     loop reads the same S at every iteration.
//  2. Because every load covers whole groups, a lane's four floats always
//     sit in the same four columns of the group: it loads the 3 x 4 halo
//     entries it needs (x_{k-1}, x_k, x_{k+1} at those columns, left/right
//     or zeros past the shard's ends) into registers once, beside the
//     operator loads.  A product is then one multiply, with no index
//     arithmetic and no shared-memory lookup per float.
//  3. The products go to the warp's 3 s^2 floats of shared memory with
//     16-byte stores, a small transpose, so that lanes own output rows:
//     for s <= 16 lanes a and a + 16 sum the first and second half of
//     row a's columns in each slot (one __shfl_xor_sync joins them), for
//     larger s lane a sums the row (at a run-time width from a rotated
//     column, so that the lanes' shared reads fall in distinct banks).
//     y = (left + right) + main, the TPU kernel's combination
//     (sharded.py:111-120).  Inside a slot the sum is of rounded products,
//     half by half, not the TPU kernel's column-by-column accumulation: the
//     two differ by float32 round-off.
//  4. IIWA's s = 14 is compiled in.  At Kl = 256 each SM holds about two
//     warps, so a warp's own instruction stream is the critical path: the
//     divisions and loop control a run-time width needs (the group shape,
//     the lane's group, the sums' bounds) would cost more than the loads.
// The scalar path (odd s, whose block rows start off 16-byte boundaries,
// or a view of S that does): lane a < s runs row a's three FMA chains on
// 4-byte loads.  Neither path has a CTA barrier.
// No tensor cores and no TMA: the sums are full float32 (no TF32), and at
// half a flop a byte the tensor cores would idle behind memory; with each
// byte used once there is nothing for a shared-memory ring, a cluster or a
// TMA multicast to reuse.
#include <cuda_runtime.h>
#include <stdint.h>

namespace gato {

constexpr int kHaloWarps = 2;  // block rows (warps) a CTA
constexpr int kHaloThreads = 32 * kHaloWarps;

// The row pointer x_{k-1+j} (j = 0, 1, 2): a row of x, or past the shard's
// ends the halo (null for zeros).
__device__ __forceinline__ const float* halo_row(const float* x,
                                                 const float* left,
                                                 const float* right, int Kl,
                                                 int s, int k, int j) {
  const int r = k - 1 + j;
  return r < 0 ? left : (r >= Kl ? right : x + (long long)r * s);
}

// The vector path.  S_: the width s where it is compiled in (0: s at run
// time).  NL: loads a lane a slot, at least ceil((s / r) / G).
template <int S_, int NL>
__global__ void __launch_bounds__(kHaloThreads)
halo_matvec_vec_kernel(const float* __restrict__ S, const float* __restrict__ x,
                       const float* __restrict__ left,
                       const float* __restrict__ right, float* __restrict__ y,
                       int Kl, int s_) {
  extern __shared__ __align__(16) float smem[];
  const int s = S_ ? S_ : s_;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x * kHaloWarps + warp;
  if (k >= Kl) return;  // a whole warp; the kernel has no CTA barrier
  const int ss = s * s;
  const int r = (s & 3) ? 2 : 1;  // rows a group
  const int m = r * s / 4;        // float4 a group
  const int G = 32 / m;           // groups a load instruction
  const int ng = s / r;           // groups a slot
  const int q = lane / m, p = lane - q * m;
  const bool on = q < G;

  // 1. Every 16-byte load of the row's operator, before any arithmetic.
  const float4* src = reinterpret_cast<const float4*>(S + (long long)k * 3 * ss);
  float4 v[3][NL];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int i = 0; i < NL; ++i)
      if (on && G * i + q < ng) v[j][i] = __ldg(src + j * (ss / 4) + (G * i + q) * m + p);

  // 2. The halo entries of the lane's four columns.
  int col[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int f = 4 * p + c;
    col[c] = f < s ? f : f - s;
  }
  float h[3][4];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float* row = halo_row(x, left, right, Kl, s, k, j);
#pragma unroll
    for (int c = 0; c < 4; ++c) h[j][c] = on && row ? __ldg(row + col[c]) : 0.f;
  }

  // 3. The products, P[j s^2 + a s + b] = S[k, j, a, b] h_j[b].
  float* P = smem + warp * 3 * ss;
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int i = 0; i < NL; ++i)
      if (on && G * i + q < ng) {
        const float4 w = v[j][i];
        const float4 out = make_float4(w.x * h[j][0], w.y * h[j][1],
                                       w.z * h[j][2], w.w * h[j][3]);
        reinterpret_cast<float4*>(P + j * ss)[(G * i + q) * m + p] = out;
      }
  __syncwarp();

  // 4. Row a's three slot sums over its columns [b0, b0 + nb), then y.
  // At a width compiled in, the loop is unrolled and starts at column 0
  // (at s = 14 the lanes' reads already fall in distinct banks).
  const bool split = s <= 16;
  const int a = split ? (lane & 15) : lane;
  const int half = split ? (lane >> 4) : 0;
  const int hs = split ? (s + 1) >> 1 : s;
  const int b0 = half * hs;
  const int nb = min(s, b0 + hs) - b0;
  float l = 0.f, d = 0.f, u = 0.f;
  if (a < s) {
    const float* row = P + a * s + b0;
    if (S_) {
#pragma unroll
      for (int t = 0; t < (S_ <= 16 ? (S_ + 1) / 2 : S_); ++t)
        if (t < nb) {
          l += row[t];
          d += row[ss + t];
          u += row[2 * ss + t];
        }
    } else {
      int b = a % nb;
#pragma unroll 4
      for (int t = 0; t < nb; ++t) {
        l += row[b];
        d += row[ss + b];
        u += row[2 * ss + b];
        if (++b == nb) b = 0;
      }
    }
  }
  if (split) {
    l += __shfl_xor_sync(0xffffffffu, l, 16);
    d += __shfl_xor_sync(0xffffffffu, d, 16);
    u += __shfl_xor_sync(0xffffffffu, u, 16);
  }
  if (half == 0 && a < s) y[(long long)k * s + a] = (l + u) + d;
}

// The scalar path: lane a < s runs row a's three FMA chains.
__global__ void __launch_bounds__(kHaloThreads)
halo_matvec_scalar_kernel(const float* __restrict__ S,
                          const float* __restrict__ x,
                          const float* __restrict__ left,
                          const float* __restrict__ right,
                          float* __restrict__ y, int Kl, int s) {
  const int warp = threadIdx.x >> 5, a = threadIdx.x & 31;
  const int k = blockIdx.x * kHaloWarps + warp;
  if (k >= Kl || a >= s) return;
  const float* M = S + ((long long)k * 3 * s + a) * s;  // row a of slot 0
  float acc[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float* Mj = M + j * s * s;
    const float* h = halo_row(x, left, right, Kl, s, k, j);
    float t = 0.f;
    for (int b = 0; b < s; ++b) t = fmaf(__ldg(Mj + b), h ? __ldg(h + b) : 0.f, t);
    acc[j] = t;
  }
  y[(long long)k * s + a] = (acc[0] + acc[2]) + acc[1];
}

}  // namespace gato

extern "C" {

// Launches row 15 on `stream`: y (Kl, s) from S (Kl, 3, s, s), x (Kl, s)
// and the halo rows left, right (s; null for zeros), for Kl >= 1 and
// 1 <= s <= 32.  Returns the CUDA error code (0 on success); nothing is
// synchronised.
int gato_halo_matvec(const float* S, const float* x, const float* left,
                     const float* right, float* y, int Kl, int s,
                     void* stream) {
  const int grid = (Kl + gato::kHaloWarps - 1) / gato::kHaloWarps;
  cudaStream_t st = (cudaStream_t)stream;
  if (s % 2 != 0 || ((uintptr_t)S & 15u) != 0) {
    gato::halo_matvec_scalar_kernel<<<grid, gato::kHaloThreads, 0, st>>>(
        S, x, left, right, y, Kl, s);
  } else {
    const size_t smem = (size_t)gato::kHaloWarps * 3 * s * s * sizeof(float);
    // IIWA's s = 14 compiled in (the index arithmetic folds, the sums
    // unroll); other widths at run time.  Loads a lane a slot: at most 2
    // for s <= 16, 8 up to s = 32.
    if (s == 14)
      gato::halo_matvec_vec_kernel<14, 2><<<grid, gato::kHaloThreads, smem, st>>>(
          S, x, left, right, y, Kl, s);
    else if (s <= 16)
      gato::halo_matvec_vec_kernel<0, 2><<<grid, gato::kHaloThreads, smem, st>>>(
          S, x, left, right, y, Kl, s);
    else
      gato::halo_matvec_vec_kernel<0, 8><<<grid, gato::kHaloThreads, smem, st>>>(
          S, x, left, right, y, Kl, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
