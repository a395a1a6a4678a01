// Row 15: the block-tridiagonal matvec of one knot shard, its halo rows
// taken from the neighbouring shards.
//
// Replaces gato_tpu/parallel/sharded.py's _mv_halo_kernel (pallas_call at
// :136, through _packed_matvec):
//
//   y_k = L_k x_{k-1} + D_k x_k + U_k x_{k+1},   k = 0 .. Kl-1,
//
// with x_{-1} = left and x_{Kl} = right, the boundary rows of the shards on
// either side (zeros at the trajectory's two ends).  Plain version and
// wrapper: gato_tpu_torch/kernels/halo_matvec.py.  Layout: S (Kl, 3, s, s)
// row-major blocks, slots 0 = L (column k-1), 1 = D, 2 = U (column k+1);
// x and y (Kl, s); left and right (s).
//
// Design.  The TPU kernel kept the shard's knots on lanes and rolled x by
// one lane each way; here a CTA takes `rows` consecutive block rows
// (halo_rows: at most 256 outputs and 48 KB of shared memory, 18 rows at
// IIWA's s = 14).  Their operator blocks are one contiguous run of
// rows * 3 s^2 floats: the CTA stages it into shared memory with 16-byte
// loads on neighbouring addresses (a scalar head and tail where the run is
// not 16-byte aligned, and the shared copy shifted to match, so the stores
// are 16 bytes too), with the rows + 2 vectors x_{r0-1} .. x_{r0+rows}
// around them.  Then one thread computes one output element: three
// per-slot sums of s float32 FMAs, added (left + right) + main, the order
// of the TPU kernel (sharded.py:111-120).
//
// What bounds it on an H100: a launch reads 12 s^2 Kl bytes of operator and
// 8 s Kl of vectors and does 6 s^2 Kl flops, half a flop a byte, so memory:
// 1.5 us at IIWA, Kl = 2048, over 3.35 TB/s.  A launch costs a few us of
// its own, so at the shard sizes of the sharded PCG loop it is bound by
// launch latency, not by either.
#include <cuda_runtime.h>
#include <stdint.h>

namespace gato {

constexpr int kHaloThreads = 256;
constexpr int kHaloSmemBytes = 48 * 1024;
// Floats of slack in front of the staged operator: it is shifted by up to
// three floats so that the 16-byte loads land on 16-byte shared addresses.
constexpr int kHaloSlack = 3;

// Block rows of one CTA at block width s: at most one output element a
// thread, and the operator, the vectors and the slack within 48 KB (the
// dynamic shared memory a launch takes without opting in).
inline int halo_rows(int s) {
  int rows = kHaloThreads / s;
  const int fit = (kHaloSmemBytes / (int)sizeof(float) - kHaloSlack - 2 * s) /
                  (3 * s * s + s);
  if (rows > fit) rows = fit;
  return rows < 1 ? 1 : rows;
}

inline size_t halo_smem_bytes(int s, int rows) {
  return (size_t)(kHaloSlack + rows * 3 * s * s + (rows + 2) * s) * sizeof(float);
}

__global__ void __launch_bounds__(kHaloThreads)
halo_matvec_kernel(const float* __restrict__ S, const float* __restrict__ x,
                   const float* __restrict__ left,
                   const float* __restrict__ right, float* __restrict__ y,
                   int Kl, int s, int rows) {
  extern __shared__ __align__(16) float smem[];
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, Kl - r0);
  const int ss = s * s;

  // The operator of rows r0 .. r0+nr-1: n floats from src, of which the
  // first `head` precede src's first 16-byte boundary.
  const float* src = S + (long long)r0 * 3 * ss;
  const int n = nr * 3 * ss;
  const int head = min(n, (int)(((16u - ((uintptr_t)src & 15u)) & 15u) >> 2));
  float* sS = smem + ((4 - head) & 3);  // sS + head is 16-byte aligned
  for (int i = threadIdx.x; i < head; i += blockDim.x) sS[i] = src[i];
  const int n4 = (n - head) >> 2;
  const float4* src4 = reinterpret_cast<const float4*>(src + head);
  float4* dst4 = reinterpret_cast<float4*>(sS + head);
  for (int i = threadIdx.x; i < n4; i += blockDim.x) dst4[i] = __ldg(src4 + i);
  for (int i = head + 4 * n4 + threadIdx.x; i < n; i += blockDim.x)
    sS[i] = src[i];

  // x_{r0-1} .. x_{r0+nr}: the halos where they fall outside the shard.
  float* sx = smem + kHaloSlack + rows * 3 * ss;
  for (int i = threadIdx.x; i < (nr + 2) * s; i += blockDim.x) {
    const int k = r0 - 1 + i / s, a = i % s;
    sx[i] = k < 0 ? left[a] : (k >= Kl ? right[a] : x[(long long)k * s + a]);
  }
  __syncthreads();

  for (int t = threadIdx.x; t < nr * s; t += blockDim.x) {
    const int k = t / s, a = t - k * s;
    const float* M = sS + k * 3 * ss + a * s;  // row a of slot 0
    const float* h = sx + k * s;               // x_{k-1}, x_k, x_{k+1}
    float acc[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float* Mj = M + j * ss;
      const float* hj = h + j * s;
      float v = Mj[0] * hj[0];
      for (int b = 1; b < s; ++b) v = fmaf(Mj[b], hj[b], v);
      acc[j] = v;
    }
    y[(long long)(r0 + k) * s + a] = (acc[0] + acc[2]) + acc[1];
  }
}

}  // namespace gato

extern "C" {

// Launches row 15 on `stream`: y (Kl, s) from S (Kl, 3, s, s), x (Kl, s)
// and the halo rows left, right (s), for Kl >= 1.  Returns the CUDA error
// code (0 on success); nothing is synchronised.
int gato_halo_matvec(const float* S, const float* x, const float* left,
                     const float* right, float* y, int Kl, int s,
                     void* stream) {
  const int rows = gato::halo_rows(s);
  const int grid = (Kl + rows - 1) / rows;
  gato::halo_matvec_kernel<<<grid, gato::kHaloThreads,
                             gato::halo_smem_bytes(s, rows),
                             (cudaStream_t)stream>>>(S, x, left, right, y, Kl,
                                                     s, rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
