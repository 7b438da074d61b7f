// Kernel R: one fused PointNet++ set-abstraction stage over a raw cloud and cached indices.
//
// Replaces puzzlefusion_plusplus_tpu/ops/sa_fused_pallas.py::sa_stage_fused (_sa_kernel),
// the stage that the frozen encoder's fused='always' mode runs. Per cloud m and centre s,
// over its K neighbours n = gidx[m,s,k] and the centre c = fidx[m,s]:
//   x  = pts[m, n] with its first 3 (xyz) channels minus pts[m, c, :3]      [K, Cin]
//   h1 = relu(x @ W1 + b1);  h2 = relu(h1 @ W2 + b2)                         [K, C1], [K, C2]
//   out[m, s] = max_k relu(h2 @ W3 + b3)                                     [C3]
// with BatchNorm folded into W1..W3 on the host. The TPU kernel gathers both row sets with
// byte-plane one-hot matmuls (its matrix unit rounds f32 operands to bf16); here a gather is
// a load, and every product is an FP32 FMA.
//
// Bound: FP32 operations (2*rows*(Cin*C1 + C1*C2 + C2*C3)), as for S. Design: S's block
// layout (sa_common.cuh). The block loads its 64 neighbour rows and their centres itself:
// the recentred xyz go to a [64][3] tile and the D = Cin - 3 feature channels to a
// channel-major [D][kHS] tile, read with scalar loads because Cin = 131 and 259 leave the
// rows without 16-byte alignment. Layer 1 stays in the kernel: the feature block
// x[:, 3:] @ W1[3:] runs as the tail's 64-column dense passes (D is a multiple of 32 at
// every stage: 0, 128, 256), and the xyz block W1[:3] and the bias are added in the
// epilogue of each pass; with D = 0 (SA1) layer 1 is S's direct 3-term loop. The feature
// tile is dead once h1 is written, so it shares its memory with h2 (D <= C2 at every
// stage); shared memory then peaks at SA3 at S's own 149 KB.
// Layers 2-3 and the max over K are mlp_tail, S's own code.
#include "sa_common.cuh"

namespace {

using sa::kCT;
using sa::kHS;
using sa::kRows;
using sa::kThreads;

size_t smem_bytes(int D, int C1, int C2) {
  const int shared_rows = D > C2 ? D : C2;  // the feature tile, then h2
  return sizeof(float) *
         ((size_t)(C1 + shared_rows) * kHS + sa::kTailScratch + kRows * 3 + kRows);
}

__global__ void __launch_bounds__(kThreads) sa_raw_kernel(
    const float* __restrict__ pts, const int* __restrict__ fidx, const int* __restrict__ gidx,
    const float* __restrict__ w1, const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ w3, const float* __restrict__ b3,
    float* __restrict__ out, int N, int Cin, int S, int K, int C1, int C2, int C3) {
  extern __shared__ float4 smem4[];
  const int D = Cin - 3;
  float* h1 = reinterpret_cast<float*>(smem4);  // [C1][kHS]
  float* h2 = h1 + (size_t)C1 * kHS;             // [max(D, C2)][kHS]: x's features, then h2
  float* xf = h2;
  float* scratch = h2 + (size_t)(D > C2 ? D : C2) * kHS;
  float* gs = scratch + sa::kTailScratch;        // [kRows][3] recentred xyz
  int* gi = reinterpret_cast<int*>(gs + kRows * 3);

  const int m = blockIdx.y;
  const int s0 = blockIdx.x * (kRows / K);
  const int tid = threadIdx.x, cg = tid % 16, rg = tid / 16;
  const float* cloud = pts + (size_t)m * N * Cin;

  for (int r = tid; r < kRows; r += kThreads) {
    const int s = s0 + r / K;
    const bool ok = s < S;
    const int n = ok ? gidx[((size_t)m * S + s) * K + r % K] : 0;
    const int c = ok ? fidx[(size_t)m * S + s] : 0;
    const float* pn = cloud + (size_t)n * Cin;
    const float* pc = cloud + (size_t)c * Cin;
    gs[r * 3 + 0] = ok ? pn[0] - pc[0] : 0.f;
    gs[r * 3 + 1] = ok ? pn[1] - pc[1] : 0.f;
    gs[r * 3 + 2] = ok ? pn[2] - pc[2] : 0.f;
    gi[r] = ok ? n : -1;
  }
  __syncthreads();

  if (D == 0) {  // layer 1 of SA1: the recentred xyz alone
    for (int e = tid; e < kRows * C1; e += kThreads) {
      const int r = e / C1, c = e % C1;
      const float v = gs[r * 3 + 0] * w1[c] + gs[r * 3 + 1] * w1[C1 + c] +
                      gs[r * 3 + 2] * w1[2 * C1 + c];
      h1[c * kHS + r] = fmaxf(v + b1[c], 0.f);
    }
  } else {
    // gather the neighbours' feature channels: neighbouring threads read neighbouring
    // channels of one row
    for (int e = tid; e < kRows * D; e += kThreads) {
      const int r = e / D, c = e % D;
      xf[c * kHS + r] = gi[r] >= 0 ? cloud[(size_t)gi[r] * Cin + 3 + c] : 0.f;
    }
    float acc[4][4];
    for (int c0 = 0; c0 < C1; c0 += kCT) {
      sa::dense_pass(xf, D, w1 + 3 * C1, C1, c0, scratch, acc);  // barriers cover xf
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + cg * 4 + j;
        const float wx = w1[c], wy = w1[C1 + c], wz = w1[2 * C1 + c], bias = b1[c];
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = rg * 4 + i;
          v[i] = fmaxf(acc[i][j] + gs[r * 3 + 0] * wx + gs[r * 3 + 1] * wy +
                           gs[r * 3 + 2] * wz + bias, 0.f);
        }
        *reinterpret_cast<float4*>(&h1[c * kHS + rg * 4]) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
  // the tail's first barrier orders the h1 writes (and the last reads of xf) before h2
  sa::mlp_tail(h1, h2, scratch, w2, b2, w3, b3, out, m, S, K, s0, C1, C2, C3);
}

}  // namespace

// Shapes: pts [M,N,Cin] (xyz ++ features), fidx [M,S], gidx [M,S,K], w1 [Cin,C1],
// w2 [C1,C2], w3 [C2,C3], out [M,S,C3]. Requires 64 % K == 0, K % 4 == 0, (Cin - 3) % 32 == 0,
// C1 % 64 == 0, C2 % 64 == 0, C3 % 64 == 0 and 16-byte aligned w1/w2/w3 (checked by the
// Python wrapper). Indices are not checked.
PFPP_EXPORT int pfpp_sa_raw(const float* pts, const int* fidx, const int* gidx,
                            const float* w1, const float* b1, const float* w2, const float* b2,
                            const float* w3, const float* b3, float* out, int M, int N, int Cin,
                            int S, int K, int C1, int C2, int C3, void* stream) {
  if (M == 0 || S == 0) return 0;
  const size_t smem = smem_bytes(Cin - 3, C1, C2);
  cudaError_t err = cudaFuncSetAttribute(
      sa_raw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int cpb = kRows / K;
  const dim3 grid((S + cpb - 1) / cpb, M);
  sa_raw_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      pts, fidx, gidx, w1, b1, w2, b2, w3, b3, out, N, Cin, S, K, C1, C2, C3);
  return (int)cudaGetLastError();
}
