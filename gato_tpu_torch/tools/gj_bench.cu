// One warp's Gauss-Jordan of one block, as rows 11 and 12 run it: cycles a
// 14 x 14 inverse for row 12's warp_gj<16> (n at run time, the pivot row
// divided) and row 11's warp_gj_pad<14> (n compiled in) and
// warp_gj_pad<16> (padded to 16, n at run time), both scaling the pivot
// row by the reciprocal.  One warp inverts the block 2,000 times, from one
// shared buffer into another and back; clock64 around the loop.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/gj_bench gato_tpu_torch/tools/gj_bench.cu && build/gj_bench
//
// Prints one JSON line: cycles and microseconds (CUDA events) an inverse
// for each, and the largest entry of the last inverse's difference from
// warp_gj's.
#include <cstdio>

#include "../csrc/longk_direct.cu"

namespace {

constexpr int kN = 14, kReps = 2000;

template <int kMode>
__global__ void gj_loop(const float* M, float* out, long long* cycles) {
  __shared__ float a[kN * kN], b[kN * kN];
  for (int e = threadIdx.x; e < kN * kN; e += 32) a[e] = M[e];
  __syncwarp();
  int z = 0;
  const long long t0 = clock64();
  for (int k = 0; k < kReps; ++k) {
    const float* src = (k & 1) ? b : a;
    float* dst = (k & 1) ? a : b;
    if (kMode == 0) z += gato::warp_gj<16>(src, dst, kN);
    if (kMode == 1) z += gato::warp_gj_pad<14>(src, dst, kN);
    if (kMode == 2) z += gato::warp_gj_pad<16>(src, dst, kN);
    __syncwarp();
  }
  const long long t1 = clock64();
  for (int e = threadIdx.x; e < kN * kN; e += 32) out[e] = b[e] + z;
  if (threadIdx.x == 0) *cycles = t1 - t0;
}

}  // namespace

int main() {
  float h[kN * kN];
  for (int r = 0; r < kN; ++r)
    for (int c = 0; c < kN; ++c)
      h[r * kN + c] = r == c ? 4.f : 0.1f * (float)((r * 7 + c * 3) % 5 - 2);
  float *M, *out;
  long long* cyc;
  cudaMalloc(&M, sizeof h);
  cudaMalloc(&out, 3 * sizeof h);
  cudaMalloc(&cyc, 3 * sizeof(long long));
  cudaMemcpy(M, h, sizeof h, cudaMemcpyHostToDevice);
  const char* names[] = {"warp_gj<16>", "warp_gj_pad<14>", "warp_gj_pad<16>"};
  double cycles[3], us[3];
  for (int mode = 0; mode < 3; ++mode) {
    for (int warm = 0; warm < 2; ++warm) {
      cudaEvent_t e0, e1;
      cudaEventCreate(&e0);
      cudaEventCreate(&e1);
      cudaEventRecord(e0);
      float* o = out + mode * kN * kN;
      if (mode == 0) gj_loop<0><<<1, 32>>>(M, o, cyc + mode);
      if (mode == 1) gj_loop<1><<<1, 32>>>(M, o, cyc + mode);
      if (mode == 2) gj_loop<2><<<1, 32>>>(M, o, cyc + mode);
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms = 0.f;
      cudaEventElapsedTime(&ms, e0, e1);
      long long c = 0;
      cudaMemcpy(&c, cyc + mode, sizeof c, cudaMemcpyDeviceToHost);
      cycles[mode] = (double)c / kReps;
      us[mode] = 1e3 * ms / kReps;
    }
  }
  float res[3][kN * kN];
  cudaMemcpy(res, out, sizeof res, cudaMemcpyDeviceToHost);
  double diff = 0.0;
  for (int m = 1; m < 3; ++m)
    for (int e = 0; e < kN * kN; ++e) {
      const double d = res[m][e] > res[0][e] ? res[m][e] - res[0][e] : res[0][e] - res[m][e];
      diff = d > diff ? d : diff;
    }
  const cudaError_t err = cudaGetLastError();
  printf("{\"n\": %d, \"reps\": %d", kN, kReps);
  for (int m = 0; m < 3; ++m)
    printf(", \"%s\": {\"cycles\": %.1f, \"us\": %.4f}", names[m], cycles[m], us[m]);
  printf(", \"max_abs_diff_from_warp_gj\": %.3e, \"error\": \"%s\"}\n", diff,
         cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
