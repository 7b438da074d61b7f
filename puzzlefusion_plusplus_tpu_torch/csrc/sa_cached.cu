// Kernel S: one fused PointNet++ set-abstraction stage over cached grouped geometry.
//
// Replaces puzzlefusion_plusplus_tpu/ops/sa_fused_pallas.py::sa_stage_fused_cached
// (_sa_cached_kernel, 'onehot' semantics). Per cloud m and centre s, over its K neighbours:
//   h1 = relu(g_rel[m,s,k] @ W_eff[m] + proj[m, gidx[m,s,k]] + b1)      [K, C1]
//   h2 = relu(h1 @ W2 + b2)                                             [K, C2]
//   out[m, s] = max_k relu(h2 @ W3 + b3)                                [C3]
// with BatchNorm folded into W2/W3 and the rotation into W_eff on the host. The TPU kernel
// gathers proj rows with a one-hot matmul; here the gather is a plain load.
//
// Bound: FP32 operations (2*rows*(C1*C2 + C2*C3) per stage, ~157 GFLOP per denoise step at
// 96 clouds) on the CUDA cores, since the port works in full float32. Design: one block of
// 256 threads owns 64 rows (64/K centres) of one cloud. h1 and h2 stay in shared memory,
// channel-major with a padded stride, and never touch device memory. The two GEMMs run as
// 64-column passes: each thread keeps a 4x4 register tile, weights are staged through
// shared memory 32 input channels at a time, and both operands are read as float4. The
// max over K is folded into each W3 pass through a small shared reduction, so SA3's
// 256x512 W3 (512 KB) is streamed in column chunks and never held whole. Shared memory
// reaches 149 KB at SA3, above the default 48 KB, hence cudaFuncSetAttribute per launch.
#include "common.cuh"

namespace {

constexpr int kRows = 64;         // (centre, neighbour) rows per block
constexpr int kHS = kRows + 4;    // channel stride of h1/h2 in shared memory (float4-aligned)
constexpr int kThreads = 256;     // 16 row groups x 16 column groups, 4x4 outputs each
constexpr int kKT = 32;           // input channels per staged weight tile
constexpr int kCT = 64;           // output columns per pass

size_t smem_bytes(int C1, int C2) {
  return sizeof(float) *
         ((size_t)(C1 + C2) * kHS + kKT * kCT + 16 * kCT + kRows * 3 + kRows);
}

// acc[i][j] = sum_k hin[k][rg*4 + i] * W[k][c0 + cg*4 + j] for k < Cin.
__device__ __forceinline__ void dense_pass(const float* hin, int Cin,
                                           const float* __restrict__ W, int Cout, int c0,
                                           float* ws, float (&acc)[4][4]) {
  const int tid = threadIdx.x, cg = tid % 16, rg = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < Cin; k0 += kKT) {
    __syncthreads();  // earlier readers of ws (and writers of hin) are done
    for (int v = tid; v < kKT * kCT / 4; v += kThreads) {
      const int kk = v / (kCT / 4), cc = (v % (kCT / 4)) * 4;
      *reinterpret_cast<float4*>(&ws[kk * kCT + cc]) =
          *reinterpret_cast<const float4*>(&W[(size_t)(k0 + kk) * Cout + c0 + cc]);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kKT; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&hin[(k0 + kk) * kHS + rg * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&ws[kk * kCT + cg * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
  }
}

__global__ void __launch_bounds__(kThreads) sa_cached_kernel(
    const float* __restrict__ g, const float* __restrict__ weff,
    const float* __restrict__ proj, const int* __restrict__ gidx,
    const float* __restrict__ b1, const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ w3, const float* __restrict__ b3, float* __restrict__ out,
    int S, int K, int N2, int C1, int C2, int C3) {
  extern __shared__ float4 smem4[];
  float* h1 = reinterpret_cast<float*>(smem4);  // [C1][kHS]
  float* h2 = h1 + (size_t)C1 * kHS;             // [C2][kHS]
  float* ws = h2 + (size_t)C2 * kHS;             // [kKT][kCT]
  float* red = ws + kKT * kCT;                   // [16][kCT] per-row-group column maxima
  float* gs = red + 16 * kCT;                    // [kRows][3]
  int* gi = reinterpret_cast<int*>(gs + kRows * 3);

  const int m = blockIdx.y;
  const int cpb = kRows / K;  // centres per block
  const int s0 = blockIdx.x * cpb;
  const int tid = threadIdx.x, cg = tid % 16, rg = tid / 16;

  for (int r = tid; r < kRows; r += kThreads) {
    const int s = s0 + r / K;
    const bool ok = s < S;
    const size_t row = ((size_t)m * S + (ok ? s : 0)) * K + r % K;
    gs[r * 3 + 0] = ok ? g[row * 3 + 0] : 0.f;
    gs[r * 3 + 1] = ok ? g[row * 3 + 1] : 0.f;
    gs[r * 3 + 2] = ok ? g[row * 3 + 2] : 0.f;
    gi[r] = (ok && gidx != nullptr) ? gidx[row] : 0;
  }
  __syncthreads();

  // layer 1: rotation-folded xyz term + gathered feature projection + bias, ReLU
  const float* we = weff + (size_t)m * 3 * C1;
  for (int e = tid; e < kRows * C1; e += kThreads) {
    const int r = e / C1, c = e % C1;
    float v = gs[r * 3 + 0] * we[c] + gs[r * 3 + 1] * we[C1 + c] + gs[r * 3 + 2] * we[2 * C1 + c];
    if (proj != nullptr) v += proj[((size_t)m * N2 + gi[r]) * C1 + c];
    h1[c * kHS + r] = fmaxf(v + b1[c], 0.f);
  }

  float acc[4][4];
  // layer 2 -> h2
  for (int c0 = 0; c0 < C2; c0 += kCT) {
    dense_pass(h1, C1, w2, C2, c0, ws, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + cg * 4 + j;
      const float bias = b2[c];
      *reinterpret_cast<float4*>(&h2[c * kHS + rg * 4]) =
          make_float4(fmaxf(acc[0][j] + bias, 0.f), fmaxf(acc[1][j] + bias, 0.f),
                      fmaxf(acc[2][j] + bias, 0.f), fmaxf(acc[3][j] + bias, 0.f));
    }
  }

  // layer 3 + max over the K neighbours of each centre, one 64-column pass at a time
  const int gpc = K / 4;  // row groups per centre
  for (int c0 = 0; c0 < C3; c0 += kCT) {
    dense_pass(h2, C2, w3, C3, c0, ws, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float bias = b3[c0 + cg * 4 + j];
      float mx = 0.f;  // every term is a ReLU output, so 0 is the identity of this max
#pragma unroll
      for (int i = 0; i < 4; ++i) mx = fmaxf(mx, fmaxf(acc[i][j] + bias, 0.f));
      red[rg * kCT + cg * 4 + j] = mx;
    }
    __syncthreads();
    for (int e = tid; e < cpb * kCT; e += kThreads) {
      const int ct = e / kCT, col = e % kCT, s = s0 + ct;
      if (s >= S) continue;
      float mx = red[(ct * gpc) * kCT + col];
      for (int q = 1; q < gpc; ++q) mx = fmaxf(mx, red[(ct * gpc + q) * kCT + col]);
      out[((size_t)m * S + s) * C3 + c0 + col] = mx;
    }
  }
}

}  // namespace

// Shapes: g [M,S,K,3], weff [M,3,C1], proj [M,N2,C1] or null, gidx [M,S,K] or null,
// w2 [C1,C2], w3 [C2,C3], out [M,S,C3]. Requires 64 % K == 0, K % 4 == 0, C1 % 32 == 0,
// C2 % 64 == 0, C3 % 64 == 0 and 16-byte aligned w2/w3 (checked by the Python wrapper).
PFPP_EXPORT int pfpp_sa_cached(const float* g, const float* weff, const float* proj,
                               const int* gidx, const float* b1, const float* w2,
                               const float* b2, const float* w3, const float* b3, float* out,
                               int M, int S, int K, int N2, int C1, int C2, int C3,
                               void* stream) {
  if (M == 0 || S == 0) return 0;
  const size_t smem = smem_bytes(C1, C2);
  cudaError_t err = cudaFuncSetAttribute(
      sa_cached_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int cpb = kRows / K;
  const dim3 grid((S + cpb - 1) / cpb, M);
  sa_cached_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      g, weff, proj, gidx, b1, w2, b2, w3, b3, out, S, K, N2, C1, C2, C3);
  return (int)cudaGetLastError();
}
