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
// Bound: the two products (2*rows*(C1*C2 + C2*C3) FLOP per stage, ~157 GFLOP per denoise
// step at 96 clouds), FP32-accurate on the tensor cores as 3xTF32 (three TF32 MMAs per
// product: 0.97 ms a step at 495 TFLOP/s, against 2.40 ms for FP32 on the CUDA cores).
// Design (sa_common.cuh): a block of 256 threads owns 128 rows at SA1 and 64 at SA2 and SA3
// (sa::with_block_shape: two blocks an SM at SA1 and SA2, one at SA3, where h1 and h2 of
// 128 rows would need 266 KB), so each W2/W3 byte read from L2 serves that many rows.
// Layer 1 (the 3-term xyz product, the gathered proj row and the bias) is FP32 elementwise
// work: the block's proj rows land in h1 by cp.async, all in flight at once, while the
// ring's first weight tiles load. Layers 2 and 3 run as mma.sync 3xTF32 passes from the
// ring, and the max over K is fused into layer 3's epilogue. h1 and h2 never leave shared
// memory.
#include "sa_common.cuh"

namespace {

using sa::kThreads;
using sa::ld_act;

size_t smem_bytes(int BM, int stages, int K, int C1, int C2) {
  return sizeof(float) *
         (sa::base_floats(BM, stages, K) + (size_t)BM * (ld_act(C1) + ld_act(C2)));
}

template <int BM, int kStages>
__global__ void __launch_bounds__(kThreads, 2) sa_cached_kernel(
    const float* __restrict__ g, const float* __restrict__ weff,
    const float* __restrict__ proj, const int* __restrict__ gidx,
    const float* __restrict__ b1, const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ w3, const float* __restrict__ b3, float* __restrict__ out,
    int S, int K, int N2, int C1, int C2, int C3) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);   // [kStages][kKT][kLDW]
  float* h1 = ring + kStages * sa::kTileFloats;     // [BM][C1 + 4]
  float* h2 = h1 + (size_t)BM * ld_act(C1);         // [BM][C2 + 4]
  float* red = h2 + (size_t)BM * ld_act(C2);        // [BM / min(K, 32)][kBN]
  float* gs = red + (BM / (K < 32 ? K : 32)) * sa::kBN;  // [BM][3]
  int* gi = reinterpret_cast<int*>(gs + BM * 3);

  const int m = blockIdx.y;
  const int s0 = blockIdx.x * (BM / K);
  const int tid = threadIdx.x;

  sa::WeightStream<kStages> ws;
  ws.ring = ring;
  ws.add(w2, C2, C1, C2);
  ws.add(w3, C3, C2, C3);
  ws.prologue();  // W2's first tiles load while layer 1 runs

  for (int r = tid; r < BM; r += kThreads) {
    const int s = s0 + r / K;
    const bool ok = s < S;
    const size_t row = ((size_t)m * S + (ok ? s : 0)) * K + r % K;
    gs[r * 3 + 0] = ok ? g[row * 3 + 0] : 0.f;
    gs[r * 3 + 1] = ok ? g[row * 3 + 1] : 0.f;
    gs[r * 3 + 2] = ok ? g[row * 3 + 2] : 0.f;
    gi[r] = (ok && gidx != nullptr) ? gidx[row] : 0;
  }
  __syncthreads();

  // the rows' proj vectors straight into h1 (cp.async: all of them in flight at once)
  const int lane = tid & 31, warp = tid >> 5, ld1 = ld_act(C1);
  if (proj != nullptr) {  // one warp a row
    for (int r = warp; r < BM; r += kThreads / 32) {
      const float* src = proj + ((size_t)m * N2 + gi[r]) * C1;
      for (int c = lane * 4; c < C1; c += 128) sa::cp_async16(h1 + r * ld1 + c, src + c);
    }
  }
  sa::cp_async_commit();
  sa::cp_async_wait<0>();
  __syncthreads();

  // layer 1: rotation-folded xyz term + gathered feature projection + bias, ReLU
  sa::xyz_layer<BM>(gs, weff + (size_t)m * 3 * C1, b1, h1, C1, proj != nullptr);

  int t = 0;  // the first tile barrier of layer 2 publishes h1
  sa::mlp_tail<BM>(ws, t, h1, h2, red, b2, b3, out, m, S, K, s0, C1, C2, C3);
}

template <int BM, int kStages>
int launch(const float* g, const float* weff, const float* proj, const int* gidx,
           const float* b1, const float* w2, const float* b2, const float* w3, const float* b3,
           float* out, int M, int S, int K, int N2, int C1, int C2, int C3,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(BM, kStages, K, C1, C2);
  cudaError_t err = cudaFuncSetAttribute(sa_cached_kernel<BM, kStages>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int cpb = BM / K;
  const dim3 grid((S + cpb - 1) / cpb, M);
  sa_cached_kernel<BM, kStages><<<grid, kThreads, smem, stream>>>(
      g, weff, proj, gidx, b1, w2, b2, w3, b3, out, S, K, N2, C1, C2, C3);
  return (int)cudaGetLastError();
}

}  // namespace

// Rows of one block at these widths (128 or 64; 0: the layers do not fit shared memory).
PFPP_EXPORT int pfpp_sa_cached_rows(int K, int C1, int C2) {
  return sa::with_block_shape(
      K, [&](int BM, int stages) { return smem_bytes(BM, stages, K, C1, C2); },
      [](auto shape) { return decltype(shape)::BM; }, 0);
}

// Shapes: g [M,S,K,3], weff [M,3,C1], proj [M,N2,C1] or null, gidx [M,S,K] or null,
// w2 [C1,C2], w3 [C2,C3], out [M,S,C3]. Requires 64 % K == 0, K % 4 == 0, C1 % 32 == 0,
// C2 % 64 == 0, C3 % 64 == 0 and 16-byte aligned w2/w3 (checked by the Python wrapper);
// C1 + C2 above 808 do not fit shared memory (cudaErrorInvalidValue).
PFPP_EXPORT int pfpp_sa_cached(const float* g, const float* weff, const float* proj,
                               const int* gidx, const float* b1, const float* w2,
                               const float* b2, const float* w3, const float* b3, float* out,
                               int M, int S, int K, int N2, int C1, int C2, int C3,
                               void* stream) {
  if (M == 0 || S == 0) return 0;
  return sa::with_block_shape(
      K, [&](int BM, int stages) { return smem_bytes(BM, stages, K, C1, C2); },
      [&](auto shape) {
        using Sh = decltype(shape);
        return launch<Sh::BM, Sh::kStages>(g, weff, proj, gidx, b1, w2, b2, w3, b3, out, M, S,
                                           K, N2, C1, C2, C3, (cudaStream_t)stream);
      },
      (int)cudaErrorInvalidValue);
}
