// Row 17's schedules side by side on one card: trips x depth dependent
// block-diagonal matvecs y <- 0.25 (0.01 M) y + 0.5 y on y (B, K, 14), one
// CTA a problem, every output row's fmaf order the same (acc = m[0] y[0],
// then fmaf(m[c], y[c], acc) for c = 1..13, then fmaf(0.25, acc, 0.5 y)),
// so every schedule's outputs are bit for bit the others':
//
//   row           one thread an output row, y double-buffered in shared
//                 memory, read a row at a time, a __syncthreads a matvec
//                 (the kernel csrc/probes.cu shipped before its redesign,
//                 kept here as the baseline);
//   warp16_lds    16 lanes a knot, a row a lane (lanes 14, 15 idle), each
//                 knot's y a 64-byte slot in shared memory, double-buffered:
//                 the lane's row stored, a __syncwarp, four 16-byte loads;
//   pair2_shfl    two lanes a knot, seven rows a lane (seven independent
//                 chains), the knot's y by 14 shuffles from the pair's two
//                 lanes, no shared memory, no barrier;
//   quad4_shfl,   four lanes a knot, four rows a lane (rows 14, 15 idle),
//   quad4_lds     y by shuffles or through the slot;
//   oct8_lds      eight lanes a knot, two rows a lane, through the slot;
//   pair2_lds     two lanes a knot, eight rows a lane, through the slot;
//   quad4_pipe    four lanes and rows a lane, two knots a lane (k and
//                 k + ceil(K / 2)), each knot's y loaded while the other's
//                 chains run;
//   pair2_shfl128 pair2_shfl bound to 128 threads a CTA.
//
// Every schedule but row and quad4_pipe holds each lane's y in registers
// and runs the first matvec alone, then the rest in pairs.  For each
// schedule that takes K, at K in {4, 50, 64} (or the comma-separated list
// given) and B = 1 and 132 CTAs, launches of R and 2R trips at depth 2 and
// 6 (CUDA events, median of 5) give ns a matvec as
// gato_tpu_torch/tools/probe_throughput.py's probe D takes it (the trip's
// own cost cancels), GFLOP/s (K s (2 s + 2) a matvec) and a launch of 100
// trips of depth 2 (median of 25).  A stamped build of each (%globaltimer,
// block 0, a __syncthreads before each stamp) splits one launch at K = 50
// and 4, B = 1, 100 trips of depth 2, into the load of M and y, the first
// matvec, the steady matvecs and the store.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas=-v \
//        -o build/fma_bench gato_tpu_torch/tools/fma_bench.cu && build/fma_bench [K,...]
//
// Prints one JSON line a schedule and shape (with how many of its outputs
// differ from the first schedule's that takes K), then the stamps, then
// whether all were bit for bit the same (exit 1 if not).  Each kernel's
// SASS counts: probe_throughput.sass_ops("kernel", "build/fma_bench").
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int S = 14;
constexpr int kStamps = 5;
__device__ unsigned long long g_stamps[kStamps];

template <bool kStamp>
__device__ __forceinline__ void stamp(int i) {
  if (!kStamp) return;
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamps[i] = t;
  }
}

template <bool kStamp>
__global__ void __launch_bounds__(1024) row_kernel(const float* __restrict__ M,
                                                   const float* __restrict__ y0,
                                                   float* __restrict__ out, int K, int depth,
                                                   int trips) {
  extern __shared__ float smem[];
  stamp<kStamp>(0);
  const int n = K * S, i = threadIdx.x;
  const bool own = i < n;
  const int k = own ? i / S : 0, a = own ? i % S : 0;
  const size_t b = blockIdx.x;
  float m[S];
#pragma unroll
  for (int c = 0; c < S; ++c) m[c] = own ? M[((b * K + k) * S + a) * S + c] * 0.01f : 0.f;
  float* y = smem;
  float* z = smem + n;
  if (own) y[i] = y0[b * n + i];
  __syncthreads();
  stamp<kStamp>(1);
  for (int t = 0; t < trips; ++t) {
    for (int d = 0; d < depth; ++d) {
      if (own) {
        const float* yk = y + k * S;
        float acc = m[0] * yk[0];
#pragma unroll
        for (int c = 1; c < S; ++c) acc = fmaf(m[c], yk[c], acc);
        z[i] = fmaf(0.25f, acc, 0.5f * y[i]);
      }
      __syncthreads();
      float* w = y;
      y = z;
      z = w;
      if (t == 0 && d == 0) stamp<kStamp>(2);
    }
  }
  stamp<kStamp>(3);
  if (own) out[b * n + i] = y[i];
  stamp<kStamp>(4);
}

// L lanes a knot, RT rows a lane (lane q of the knot owns rows q RT ..
// q RT + RT - 1; rows past 13 are padding, computed on zeros and never
// written out), the knot's y in registers (y[16]) at every lane.  kLds: y
// comes from the knot's 64-byte slot in shared memory (double-buffered:
// the lane's rows stored, a __syncwarp, four 16-byte loads), else by
// shuffles from the lane that owns each row.  The first matvec is peeled so
// that the stamped and the unstamped loop are the same code.
template <int L, bool kLds, bool kStamp, bool kTight = false>
__global__ void __launch_bounds__(kTight ? 128 : (L >= 8 ? 1024 : (L == 4 ? 512 : 256)), 1)
    lanes_kernel(const float* __restrict__ M, const float* __restrict__ y0,
                 float* __restrict__ out, int K, int depth, int trips) {
  constexpr int RT = (L == 2 && !kLds) ? 7 : 16 / L;
  extern __shared__ float4 slots[];  // kLds: [2][K][4] float4
  stamp<kStamp>(0);
  const int lane = threadIdx.x & 31, q = threadIdx.x % L;
  const int base = lane - q;
  const int k = threadIdx.x / L;
  const bool own = k < K;
  const int kk = own ? k : 0;
  const size_t b = blockIdx.x;
  const float* Mk = M + (b * K + kk) * S * S;
  const float* yk = y0 + (b * K + kk) * S;
  float m[RT][S], y[16], yo[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int row = q * RT + r;
#pragma unroll
    for (int c = 0; c < S; ++c) m[r][c] = row < S ? Mk[row * S + c] * 0.01f : 0.f;
    yo[r] = row < S ? yk[row] : 0.f;
  }
#pragma unroll
  for (int c = 0; c < 16; ++c) y[c] = c < S ? yk[c] : 0.f;
  float* buf = reinterpret_cast<float*>(slots);
  auto matvec = [&](int par) {
    float acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = m[r][0] * y[0];
#pragma unroll
    for (int c = 1; c < S; ++c)
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] = fmaf(m[r][c], y[c], acc[r]);
#pragma unroll
    for (int r = 0; r < RT; ++r) yo[r] = fmaf(0.25f, acc[r], 0.5f * yo[r]);
    if (kLds) {
      float* slot = buf + (par * K + kk) * 16;
      if (own) {
        if (RT == 1) slot[q] = yo[0];
        if (RT == 2) reinterpret_cast<float2*>(slot)[q] = make_float2(yo[0], yo[1 % RT]);
        if (RT >= 4)
#pragma unroll
          for (int v = 0; v < RT / 4; ++v)
            reinterpret_cast<float4*>(slot)[q * (RT / 4) + v] =
                make_float4(yo[(4 * v) % RT], yo[(4 * v + 1) % RT], yo[(4 * v + 2) % RT],
                            yo[(4 * v + 3) % RT]);
      }
      __syncwarp();
#pragma unroll
      for (int v = 0; v < 4; ++v) {
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
        for (int r = 0; r < RT; ++r)
          if (src * RT + r < S) y[src * RT + r] = __shfl_sync(0xffffffffu, yo[r], base + src);
    }
  };
  stamp<kStamp>(1);
  const int n = trips * depth;
  if (n > 0) matvec(1);
  stamp<kStamp>(2);
  int i = 1;
  for (; i + 1 < n; i += 2) {
    matvec(0);
    matvec(1);
  }
  if (i < n) matvec(0);
  stamp<kStamp>(3);
  if (own) {
#pragma unroll
    for (int r = 0; r < RT; ++r)
      if (q * RT + r < S) out[(b * K + k) * S + q * RT + r] = yo[r];
  }
  stamp<kStamp>(4);
}

// Four lanes a knot, four rows a lane, two knots a lane (A: knot k, B:
// knot k + ceil(K / 2)) in a two-stage pipeline: each knot's y is loaded
// from its slot while the other knot's chains run, so the exchange's
// latency hides behind the other knot's arithmetic.
template <bool kStamp>
__global__ void __launch_bounds__(256, 1)
    pipe_kernel(const float* __restrict__ M, const float* __restrict__ y0,
                float* __restrict__ out, int K, int depth, int trips) {
  constexpr int RT = 4;
  extern __shared__ float4 slots[];  // [2][K][4] float4
  stamp<kStamp>(0);
  const int q = threadIdx.x & 3, half = (K + 1) / 2;
  const int kA = threadIdx.x >> 2, kB = kA + half;
  const bool ownA = kA < half, ownB = kB < K;
  const int ka = ownA ? kA : 0, kb = ownB ? kB : 0;
  const size_t b = blockIdx.x;
  float mA[RT][S], mB[RT][S], yA[16], yB[16], oA[RT], oB[RT];
  auto init = [&](int kk, float (&m)[RT][S], float (&y)[16], float (&o)[RT]) {
    const float* Mk = M + (b * K + kk) * S * S;
    const float* yk = y0 + (b * K + kk) * S;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int row = q * RT + r;
#pragma unroll
      for (int c = 0; c < S; ++c) m[r][c] = row < S ? Mk[row * S + c] * 0.01f : 0.f;
      o[r] = row < S ? yk[row] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < 16; ++c) y[c] = c < S ? yk[c] : 0.f;
  };
  init(ka, mA, yA, oA);
  init(kb, mB, yB, oB);
  float* buf = reinterpret_cast<float*>(slots);
  auto chains = [&](const float (&m)[RT][S], const float (&y)[16], float (&o)[RT]) {
    float acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = m[r][0] * y[0];
#pragma unroll
    for (int c = 1; c < S; ++c)
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] = fmaf(m[r][c], y[c], acc[r]);
#pragma unroll
    for (int r = 0; r < RT; ++r) o[r] = fmaf(0.25f, acc[r], 0.5f * o[r]);
  };
  auto store = [&](bool own, int kk, int par, const float (&o)[RT]) {
    if (own)
      reinterpret_cast<float4*>(buf + (par * K + kk) * 16)[q] = make_float4(o[0], o[1], o[2], o[3]);
    __syncwarp();
  };
  auto load = [&](int kk, int par, float (&y)[16]) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float4 t = reinterpret_cast<const float4*>(buf + (par * K + kk) * 16)[v];
      y[4 * v] = t.x;
      y[4 * v + 1] = t.y;
      y[4 * v + 2] = t.z;
      y[4 * v + 3] = t.w;
    }
  };
  stamp<kStamp>(1);
  const int n = trips * depth;
  if (n > 0) {
    chains(mA, yA, oA);
    store(ownA, ka, 1, oA);
  }
  stamp<kStamp>(2);
  for (int i = 1; i < n; ++i) {
    load(ka, i & 1, yA);
    chains(mB, yB, oB);
    store(ownB, kb, i & 1, oB);
    load(kb, i & 1, yB);
    chains(mA, yA, oA);
    store(ownA, ka, (i + 1) & 1, oA);
  }
  if (n > 0) chains(mB, yB, oB);
  stamp<kStamp>(3);
#pragma unroll
  for (int r = 0; r < RT; ++r)
    if (q * RT + r < S) {
      if (ownA) out[(b * K + kA) * S + q * RT + r] = oA[r];
      if (ownB) out[(b * K + kB) * S + q * RT + r] = oB[r];
    }
  stamp<kStamp>(4);
}

const char* kNames[] = {"row", "warp16_lds", "pair2_shfl", "quad4_shfl", "quad4_lds",
                        "oct8_lds", "pair2_lds", "quad4_pipe", "pair2_shfl128"};
constexpr int kSchedules = 9;
constexpr int kLanes[kSchedules] = {0, 16, 2, 4, 4, 8, 2, 2, 2};
constexpr bool kLdsOf[kSchedules] = {false, true, false, false, true, true, true, true, false};

int threads_of(int v, int K) {
  const int t = v == 0 ? K * S : (v == 7 ? 4 * ((K + 1) / 2) : kLanes[v] * K);
  return (t + 31) / 32 * 32;
}

size_t smem_of(int v, int K) {
  return v == 0 ? 2 * (size_t)K * S * 4 : (kLdsOf[v] ? 2 * (size_t)K * 64 : 0);
}

// Whether schedule v takes K knots (its CTA's threads within its bound).
bool runs(int v, int K) {
  const int bound = v == 0 ? 1024 : (v == 8 ? 128 : (v == 7 ? 256 :
                    (kLanes[v] >= 8 ? 1024 : (kLanes[v] == 4 ? 512 : 256))));
  return (v == 0 ? K * S : threads_of(v, K)) <= bound;
}

void launch(int v, bool stamped, const float* M, const float* y0, float* out, int B, int K,
            int depth, int trips) {
  using Kern = void (*)(const float*, const float*, float*, int, int, int);
  const Kern kerns[2][kSchedules] = {
      {row_kernel<false>, lanes_kernel<16, true, false>, lanes_kernel<2, false, false>,
       lanes_kernel<4, false, false>, lanes_kernel<4, true, false>,
       lanes_kernel<8, true, false>, lanes_kernel<2, true, false>, pipe_kernel<false>,
       lanes_kernel<2, false, false, true>},
      {row_kernel<true>, lanes_kernel<16, true, true>, lanes_kernel<2, false, true>,
       lanes_kernel<4, false, true>, lanes_kernel<4, true, true>, lanes_kernel<8, true, true>,
       lanes_kernel<2, true, true>, pipe_kernel<true>, lanes_kernel<2, false, true, true>}};
  if (!runs(v, K)) return;
  kerns[stamped][v]<<<B, threads_of(v, K), smem_of(v, K)>>>(M, y0, out, K, depth, trips);
}

float launch_ms(int v, const float* M, const float* y0, float* out, int B, int K, int depth,
                int trips, int reps) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  std::vector<float> t;
  for (int r = 0; r <= reps; ++r) {
    cudaEventRecord(e0);
    launch(v, false, M, y0, out, B, K, depth, trips);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms = 0.f;
    cudaEventElapsedTime(&ms, e0, e1);
    if (r > 0) t.push_back(ms);  // the first is a warm-up
  }
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  std::sort(t.begin(), t.end());
  return t[t.size() / 2];
}

// Each knot's step 0.5 I + 0.0025 M a Householder reflection (orthogonal),
// so y keeps its size; y0 in [-1, 1).
void inputs(int B, int K, std::vector<float>& M, std::vector<float>& y0) {
  unsigned long long st = 17;
  auto rnd = [&]() {
    st = st * 6364136223846793005ULL + 1442695040888963407ULL;
    return (double)(st >> 11) / 9007199254740992.0 * 2.0 - 1.0;
  };
  M.assign((size_t)B * K * S * S, 0.f);
  y0.assign((size_t)B * K * S, 0.f);
  for (size_t p = 0; p < (size_t)B * K; ++p) {
    double v[S], n2 = 0.0;
    for (int i = 0; i < S; ++i) {
      v[i] = rnd();
      n2 += v[i] * v[i];
    }
    for (int i = 0; i < S; ++i)
      for (int j = 0; j < S; ++j) {
        const double q = (i == j ? 1.0 : 0.0) - 2.0 * v[i] * v[j] / n2;
        M[p * S * S + i * S + j] = (float)((q - 0.5 * (i == j)) / 0.0025);
      }
    for (int i = 0; i < S; ++i) y0[p * S + i] = (float)rnd();
  }
}

}  // namespace

int main(int argc, char** argv) {
  const int R = 20000, reps = 5, Bs[] = {1, 132};
  std::vector<int> Ks = {4, 50, 64};
  if (argc > 1) {
    Ks.clear();
    for (char* tok = std::strtok(argv[1], ","); tok; tok = std::strtok(nullptr, ","))
      Ks.push_back(std::atoi(tok));
  }
  std::vector<float> hM, hy;
  const int kmax = *std::max_element(Ks.begin(), Ks.end());
  inputs(132, kmax, hM, hy);
  float *M, *y0, *out;
  cudaMalloc(&M, hM.size() * 4);
  cudaMalloc(&y0, hy.size() * 4);
  cudaMalloc(&out, hy.size() * 4);
  bool same = true;
  for (int K : Ks)
    for (int B : Bs) {
      // This shape's inputs: the first B K knots of the draw.
      std::vector<float> res[kSchedules];
      cudaMemcpy(M, hM.data(), (size_t)B * K * S * S * 4, cudaMemcpyHostToDevice);
      cudaMemcpy(y0, hy.data(), (size_t)B * K * S * 4, cudaMemcpyHostToDevice);
      int ref = -1;  // the first schedule that takes K: the others' reference
      for (int v = 0; v < kSchedules; ++v) {
        if (!runs(v, K)) continue;
        if (ref < 0) ref = v;
        float t[2][2];
        for (int di = 0; di < 2; ++di)
          for (int ri = 0; ri < 2; ++ri)
            t[di][ri] = launch_ms(v, M, y0, out, B, K, di ? 6 : 2, ri ? 2 * R : R, reps);
        const double trip2 = (t[0][1] - t[0][0]) / R * 1e6, trip6 = (t[1][1] - t[1][0]) / R * 1e6;
        const double ns = (trip6 - trip2) / 4.0;
        const double gflops = (double)K * S * (2 * S + 2) * B / ns;
        const float ms100 = launch_ms(v, M, y0, out, B, K, 2, 100, 25);
        launch(v, false, M, y0, out, B, K, 2, 100);
        res[v].resize((size_t)B * K * S);
        cudaMemcpy(res[v].data(), out, res[v].size() * 4, cudaMemcpyDeviceToHost);
        long long differ = 0;
        for (size_t e = 0; e < res[v].size(); ++e)
          if (std::memcmp(&res[v][e], &res[ref][e], 4) != 0 || !std::isfinite(res[v][e]))
            ++differ;
        same = same && differ == 0;
        printf("{\"schedule\": \"%s\", \"K\": %d, \"B\": %d, \"threads\": %d, \"smem\": %zu, "
               "\"ns_per_matvec\": %.2f, \"trip_d2_ns\": %.2f, \"gflops\": %.1f, "
               "\"ms_100_trips_d2\": %.5f, \"outputs_differing\": %lld, \"from\": \"%s\"}\n",
               kNames[v], K, B, threads_of(v, K), smem_of(v, K), ns, trip2, gflops, ms100,
               differ, kNames[ref]);
        fflush(stdout);
      }
    }
  for (int K : {50, 4}) {
    if (K > kmax) continue;  // inputs drawn for fewer knots
    cudaMemcpy(M, hM.data(), (size_t)K * S * S * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(y0, hy.data(), (size_t)K * S * 4, cudaMemcpyHostToDevice);
    for (int v = 0; v < kSchedules; ++v) {
      if (!runs(v, K)) continue;
      for (int rep = 0; rep < 2; ++rep) launch(v, true, M, y0, out, 1, K, 2, 100);
      cudaDeviceSynchronize();
      unsigned long long st[kStamps];
      cudaMemcpyFromSymbol(st, g_stamps, sizeof st);
      const double steady = (double)(st[3] - st[2]) / 199.0;
      printf("{\"stamps\": \"%s\", \"K\": %d, \"B\": 1, \"depth\": 2, \"trips\": 100, "
             "\"load_ns\": %llu, \"first_matvec_ns\": %llu, \"steady_ns_per_matvec\": %.2f, "
             "\"store_ns\": %llu, \"kernel_ns\": %llu}\n",
             kNames[v], K, st[1] - st[0], st[2] - st[1], steady, st[4] - st[3],
             st[4] - st[0]);
    }
  }
  const cudaError_t err = cudaGetLastError();
  printf("{\"bit_for_bit\": %s, \"error\": \"%s\"}\n", same ? "true" : "false",
         cudaGetErrorString(err));
  return same && err == cudaSuccess ? 0 : 1;
}
