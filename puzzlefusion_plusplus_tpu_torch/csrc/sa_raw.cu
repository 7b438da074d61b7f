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
// Design: S's block layout and tail (sa_common.cuh), the weights split by the wrapper. The
// block loads its 128 (or 64, sa::with_block_shape) neighbour rows and their centres
// itself: the recentred xyz go to a [BM][3] tile and the D = Cin - 3 feature channels to a
// row-major [BM][D + 4] tile by 4-byte cp.async (Cin = 131 and 259 leave the rows without
// 16-byte alignment), all in flight at once. Layer 1 stays in the kernel and per row: the
// feature block x[:, 3:] @ W1[3:] is the first layer of the weight stream (3xTF32 wgmma
// passes, D a multiple of 32: 0, 128, 256), and the xyz block W1[:3] and the bias are added
// in its epilogue; with D = 0 (SA1) layer 1 is S's direct 3-term loop. Each layer of one
// pass writes its output in place over its input (sa::Buffers).
#include "sa_common.cuh"

namespace {

// R's shared memory in floats from the base: the ring's mbarriers, the weight ring of
// `stages` tiles, activation buffers 0 and 1
// (the chain x features, h1, h2, or h1, h2 without features), the layer-3 maxima, the rows'
// recentred xyz and neighbour index; bytes is the total.
template <class Sh>
struct Smem {
  sa::Buffers buf;
  size_t act[2], red, gs, gi, bytes;
  __host__ __device__ Smem(int K, int D, int C1, int C2, int stages)
      : buf(D > 0 ? 3 : 2, D > 0 ? D : C1, D > 0 ? C1 : C2, C2, Sh::N) {
    act[0] = sa::kBarrierFloats + (size_t)stages * Sh::kTileFloats;
    act[1] = act[0] + (size_t)Sh::BM * buf.ld(0);
    red = act[1] + (size_t)Sh::BM * buf.ld(1);
    gs = red + (size_t)(Sh::BM / sa::rows_in_warp(K)) * Sh::N;
    gi = gs + Sh::BM * 3;
    bytes = sizeof(float) * (gi + Sh::BM);
  }
};

template <class Sh>
__global__ void __launch_bounds__(Sh::kBlockThreads, Sh::kMinBlocks) sa_raw_kernel(
    const float* __restrict__ pts, const int* __restrict__ fidx, const int* __restrict__ gidx,
    const float* __restrict__ w1, const float* __restrict__ w1f, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2, const float* __restrict__ w3,
    const float* __restrict__ b3, float* __restrict__ out, int N, int Cin, int S, int K,
    int C1, int C2, int C3, int stages) {
  constexpr int BM = Sh::BM, kThreads = Sh::kThreads;
  extern __shared__ float4 smem4[];
  const int D = Cin - 3;
  float* base = reinterpret_cast<float*>(smem4);
  const Smem<Sh> L(K, D, C1, C2, stages);
  const int f = D > 0 ? 1 : 0;  // the chain's index of h1
  float* xf = base + L.act[L.buf.in[0]];  // [BM][ldx] (D > 0)
  float* h1 = base + L.act[L.buf.in[f]];
  float* h2 = base + L.act[L.buf.in[f + 1]];
  const int ldx = L.buf.ld(L.buf.in[0]), ld1 = L.buf.ld(L.buf.in[f]);
  const int ld2 = L.buf.ld(L.buf.in[f + 1]);
  float* red = base + L.red;
  float* gs = base + L.gs;  // [BM][3] recentred xyz
  int* gi = reinterpret_cast<int*>(base + L.gi);

  const int m = blockIdx.y;
  const int s0 = blockIdx.x * (BM / K);
  const int tid = threadIdx.x;
  const float* cloud = pts + (size_t)m * N * Cin;

  sa::WeightStream<Sh> ws;
  if (D > 0) ws.add(w1f, D, C1);
  ws.add(w2, C1, C2);
  ws.add(w3, C2, C3);
  ws.init(base + sa::kBarrierFloats, reinterpret_cast<uint64_t*>(base), stages);
  __syncthreads();
  if (tid >= kThreads) {  // the producer warp: the first tiles load while the rows are gathered
    if (tid == kThreads) ws.produce();
    return;
  }

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
  sa::bar_sync(1, kThreads);

  int t = 0;
  if (D == 0) {  // layer 1 of SA1: the recentred xyz alone
    sa::xyz_layer<Sh>(gs, w1, b1, h1, ld1, C1, false);
    sa::bar_sync(1, kThreads);  // publishes h1
  } else {
    // the neighbours' feature channels, one warp a row (4-byte cp.async: the rows are not
    // 16-byte aligned; all in flight at once)
    const int lane = tid & 31, warp = tid >> 5;
    for (int r = warp; r < BM; r += kThreads / 32) {
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
    sa::bar_sync(1, kThreads);  // publishes xf
    // the feature block on the tensor cores; the xyz block and the bias in the epilogue,
    // each warp's rows written by the warp itself
    sa::dense<Sh>(ws, t, xf, ldx, D, C1, [&](auto& acc, int c0, int row0, int q) {
      sa::store_relu<Sh::N>(acc, c0, row0, q, h1, ld1, b1, [&](int r, int c) {
        return gs[r * 3 + 0] * w1[c] + gs[r * 3 + 1] * w1[C1 + c] + gs[r * 3 + 2] * w1[2 * C1 + c];
      });
    });
  }
  sa::mlp_tail<Sh>(ws, t, h1, ld1, h2, ld2, red, b2, b3, out, m, S, K, s0, C1, C2, C3);
}

template <class Sh>
int launch(const float* pts, const int* fidx, const int* gidx, const float* w1,
           const float* w1f, const float* b1, const float* w2, const float* b2,
           const float* w3, const float* b3, float* out, int M, int N, int Cin, int S, int K,
           int C1, int C2, int C3, int stages, cudaStream_t stream) {
  const size_t smem = Smem<Sh>(K, Cin - 3, C1, C2, stages).bytes;
  cudaError_t err = cudaFuncSetAttribute(sa_raw_kernel<Sh>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int cpb = Sh::BM / K;
  const dim3 grid((S + cpb - 1) / cpb, M);
  sa_raw_kernel<Sh><<<grid, Sh::kBlockThreads, smem, stream>>>(
      pts, fidx, gidx, w1, w1f, b1, w2, b2, w3, b3, out, N, Cin, S, K, C1, C2, C3, stages);
  return (int)cudaGetLastError();
}

// Calls f(shape, stages) for the block shape of these widths (see sa::with_block_shape).
template <class F>
int with_shape(int K, int Cin, int C1, int C2, int C3, F&& f, int none) {
  const int N = Cin > 3 ? sa::pass_width({C1, C2, C3}) : sa::pass_width({C2, C3});
  return sa::with_block_shape(
      K, N,
      [&](auto shape, int stages) {
        return Smem<decltype(shape)>(K, Cin - 3, C1, C2, stages).bytes;
      },
      f, none);
}

}  // namespace

// Rows of one block at these widths (128 or 64; 0: the layers do not fit shared memory).
PFPP_EXPORT int pfpp_sa_raw_rows(int K, int Cin, int C1, int C2, int C3) {
  return with_shape(K, Cin, C1, C2, C3, [](auto shape, int) { return decltype(shape)::BM; },
                    0);
}

// Shapes: pts [M,N,Cin] (xyz ++ features), fidx [M,S], gidx [M,S,K], w1 [Cin,C1] (its xyz
// rows are read), w1f, w2, w3 the TF32 planes of W1[3:] (null when Cin == 3), W2 [C1,C2]
// and W3 [C2,C3] (ops/sa_fused.py::tf32_planes), out [M,S,C3]. Requires 64 % K == 0,
// K % 4 == 0, (Cin - 3) % 32 == 0, C1 % 64 == 0, C2 % 64 == 0, C3 % 64 == 0 and 16-byte
// aligned w1/w1f/w2/w3 (checked by the Python wrapper); widths whose activations do not fit
// shared memory even at 64 rows return cudaErrorInvalidValue. Indices are not checked.
PFPP_EXPORT int pfpp_sa_raw(const float* pts, const int* fidx, const int* gidx,
                            const float* w1, const float* w1f, const float* b1,
                            const float* w2, const float* b2, const float* w3, const float* b3,
                            float* out, int M, int N, int Cin, int S, int K, int C1, int C2,
                            int C3, void* stream) {
  if (M == 0 || S == 0) return 0;
  return with_shape(
      K, Cin, C1, C2, C3,
      [&](auto shape, int stages) {
        return launch<decltype(shape)>(pts, fidx, gidx, w1, w1f, b1, w2, b2, w3, b3, out, M,
                                       N, Cin, S, K, C1, C2, C3, stages, (cudaStream_t)stream);
      },
      (int)cudaErrorInvalidValue);
}
