// Device code shared by the two fused set-abstraction kernels: S (sa_cached.cu, cached
// grouped geometry) and R (sa_raw.cu, raw clouds gathered in the kernel).
//
// Both run the same block layout: 256 threads own 64 (centre, neighbour) rows of one
// cloud, activations live in shared memory channel-major ([C][kHS], a padded row stride so
// that a thread's four rows load as one float4), and every Dense layer runs as 64-column
// passes in which each thread keeps a 4x4 register tile and the weights are staged through
// shared memory 32 input channels at a time. The tail (layers 2 and 3 with the max over K
// folded into each layer-3 pass) is the same function for both kernels.
#pragma once

#include "common.cuh"

namespace sa {

constexpr int kRows = 64;         // (centre, neighbour) rows per block
constexpr int kHS = kRows + 4;    // channel stride of the activations in shared memory
constexpr int kThreads = 256;     // 16 row groups x 16 column groups, 4x4 outputs each
constexpr int kKT = 32;           // input channels per staged weight tile
constexpr int kCT = 64;           // output columns per pass

// Floats of shared memory the tail needs besides h1 and h2: the staged weight tile and the
// per-row-group column maxima.
constexpr int kTailScratch = kKT * kCT + 16 * kCT;

// acc[i][j] = sum_k hin[k][rg*4 + i] * W[k][c0 + cg*4 + j] for k < Cin (Cin % kKT == 0,
// W row-major [Cin][Cout], 16-byte aligned, Cout % 4 == 0).
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

// Layers 2 and 3 and the max over the K neighbours of each centre:
//   h2 = relu(h1 @ W2 + b2);  out[m, s] = max_k relu(h2 @ W3 + b3)
// h1 [C1][kHS] must be complete once the first barrier inside dense_pass is passed.
// scratch holds kTailScratch floats. Rows of centres s >= S are computed and dropped.
__device__ __forceinline__ void mlp_tail(const float* h1, float* h2, float* scratch,
                                         const float* __restrict__ w2,
                                         const float* __restrict__ b2,
                                         const float* __restrict__ w3,
                                         const float* __restrict__ b3,
                                         float* __restrict__ out, int m, int S, int K, int s0,
                                         int C1, int C2, int C3) {
  float* ws = scratch;            // [kKT][kCT]
  float* red = ws + kKT * kCT;    // [16][kCT] per-row-group column maxima
  const int tid = threadIdx.x, cg = tid % 16, rg = tid / 16;
  const int cpb = kRows / K;      // centres per block
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

}  // namespace sa
