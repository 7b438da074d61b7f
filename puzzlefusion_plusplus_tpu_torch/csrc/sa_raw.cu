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
// a load.
//
// Bound: the products (2*rows*(C1*C2 + C2*C3) plus layer 1's feature block, which the
// bound charges once per point), FP32-accurate as 3xTF32 on the tensor cores, as for S.
// Design: S's block layout and tail (sa_common.cuh). The block loads its 128 (SA1) or 64
// (SA2, SA3; sa::with_block_shape) neighbour rows and their centres itself: the recentred xyz go to a [BM][3] tile
// and the D = Cin - 3 feature channels to a row-major [BM][D + 4] tile by 4-byte cp.async
// (Cin = 131 and 259 leave the rows without 16-byte alignment), all in flight at once.
// Layer 1 stays in the kernel and per row: the feature block x[:, 3:] @ W1[3:] is the first
// layer of the weight stream (3xTF32 MMA passes, D a multiple of 32: 0, 128, 256), and
// the xyz block W1[:3] and the bias are added in its epilogue; with D = 0 (SA1) layer 1 is
// S's direct 3-term loop. The feature tile is dead once h1 is written, so it shares its
// memory with h2.
#include "sa_common.cuh"

namespace {

using sa::kThreads;
using sa::ld_act;

size_t smem_bytes(int BM, int stages, int K, int D, int C1, int C2) {
  const int shared_width = D > C2 ? D : C2;  // the feature tile, then h2
  return sizeof(float) * (sa::base_floats(BM, stages, K) +
                          (size_t)BM * (ld_act(C1) + ld_act(shared_width)));
}

template <int BM, int kStages>
__global__ void __launch_bounds__(kThreads, 2) sa_raw_kernel(
    const float* __restrict__ pts, const int* __restrict__ fidx, const int* __restrict__ gidx,
    const float* __restrict__ w1, const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ w3, const float* __restrict__ b3,
    float* __restrict__ out, int N, int Cin, int S, int K, int C1, int C2, int C3) {
  extern __shared__ float4 smem4[];
  const int D = Cin - 3;
  float* ring = reinterpret_cast<float*>(smem4);   // [kStages][kKT][kLDW]
  float* h1 = ring + kStages * sa::kTileFloats;     // [BM][C1 + 4]
  float* h2 = h1 + (size_t)BM * ld_act(C1);         // [BM][C2 + 4], first x's features
  float* xf = h2;                                   // [BM][D + 4]
  float* red = h2 + (size_t)BM * ld_act(D > C2 ? D : C2);
  float* gs = red + (BM / (K < 32 ? K : 32)) * sa::kBN;  // [BM][3] recentred xyz
  int* gi = reinterpret_cast<int*>(gs + BM * 3);

  const int m = blockIdx.y;
  const int s0 = blockIdx.x * (BM / K);
  const int tid = threadIdx.x;
  const float* cloud = pts + (size_t)m * N * Cin;

  sa::WeightStream<kStages> ws;
  ws.ring = ring;
  if (D > 0) ws.add(w1 + 3 * C1, C1, D, C1);
  ws.add(w2, C2, C1, C2);
  ws.add(w3, C3, C2, C3);
  ws.prologue();  // the first weight tiles load while the rows are gathered

  for (int r = tid; r < BM; r += kThreads) {
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

  int t = 0;
  if (D == 0) {  // layer 1 of SA1: the recentred xyz alone
    sa::xyz_layer<BM>(gs, w1, b1, h1, C1, false);
  } else {
    // the neighbours' feature channels, one warp a row (4-byte cp.async: the rows are not
    // 16-byte aligned; all in flight at once)
    const int lane = tid & 31, warp = tid >> 5, ldx = ld_act(D);
    for (int r = warp; r < BM; r += kThreads / 32) {  // one warp a row
      const int n = gi[r];
      for (int c = lane; c < D; c += 32) {
        if (n >= 0)
          sa::cp_async4(xf + r * ldx + c, cloud + (size_t)n * Cin + 3 + c);
        else
          xf[r * ldx + c] = 0.f;
      }
    }
    sa::cp_async_commit();
    sa::cp_async_wait<0>();
    // the feature block on the tensor cores; the xyz block and the bias in the epilogue
    // (the layer's first tile barrier publishes xf)
    sa::dense<BM>(ws, t, xf, D, C1, [&](auto& acc, int col0, int row0, int q) {
      sa::store_relu<BM>(acc, col0, row0, q, h1, C1, b1, [&](int r, int c) {
        return gs[r * 3 + 0] * w1[c] + gs[r * 3 + 1] * w1[C1 + c] + gs[r * 3 + 2] * w1[2 * C1 + c];
      });
    });
  }
  // the tail's first tile barrier orders the h1 writes (and the last reads of xf) before h2
  sa::mlp_tail<BM>(ws, t, h1, h2, red, b2, b3, out, m, S, K, s0, C1, C2, C3);
}

template <int BM, int kStages>
int launch(const float* pts, const int* fidx, const int* gidx, const float* w1,
           const float* b1, const float* w2, const float* b2, const float* w3, const float* b3,
           float* out, int M, int N, int Cin, int S, int K, int C1, int C2, int C3,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(BM, kStages, K, Cin - 3, C1, C2);
  cudaError_t err = cudaFuncSetAttribute(sa_raw_kernel<BM, kStages>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int cpb = BM / K;
  const dim3 grid((S + cpb - 1) / cpb, M);
  sa_raw_kernel<BM, kStages><<<grid, kThreads, smem, stream>>>(
      pts, fidx, gidx, w1, b1, w2, b2, w3, b3, out, N, Cin, S, K, C1, C2, C3);
  return (int)cudaGetLastError();
}

}  // namespace

// Rows of one block at these widths (128 or 64; 0: the layers do not fit shared memory).
PFPP_EXPORT int pfpp_sa_raw_rows(int K, int Cin, int C1, int C2) {
  return sa::with_block_shape(
      K, [&](int BM, int stages) { return smem_bytes(BM, stages, K, Cin - 3, C1, C2); },
      [](auto shape) { return decltype(shape)::BM; }, 0);
}

// Shapes: pts [M,N,Cin] (xyz ++ features), fidx [M,S], gidx [M,S,K], w1 [Cin,C1],
// w2 [C1,C2], w3 [C2,C3], out [M,S,C3]. Requires 64 % K == 0, K % 4 == 0, (Cin - 3) % 32 == 0,
// C1 % 64 == 0, C2 % 64 == 0, C3 % 64 == 0 and 16-byte aligned w1/w2/w3 (checked by the
// Python wrapper); C1 + max(Cin - 3, C2) above 808 do not fit shared memory
// (cudaErrorInvalidValue). Indices are not checked.
PFPP_EXPORT int pfpp_sa_raw(const float* pts, const int* fidx, const int* gidx,
                            const float* w1, const float* b1, const float* w2, const float* b2,
                            const float* w3, const float* b3, float* out, int M, int N, int Cin,
                            int S, int K, int C1, int C2, int C3, void* stream) {
  if (M == 0 || S == 0) return 0;
  return sa::with_block_shape(
      K, [&](int BM, int stages) { return smem_bytes(BM, stages, K, Cin - 3, C1, C2); },
      [&](auto shape) {
        using Sh = decltype(shape);
        return launch<Sh::BM, Sh::kStages>(pts, fidx, gidx, w1, b1, w2, b2, w3, b3, out, M, N,
                                           Cin, S, K, C1, C2, C3, (cudaStream_t)stream);
      },
      (int)cudaErrorInvalidValue);
}
