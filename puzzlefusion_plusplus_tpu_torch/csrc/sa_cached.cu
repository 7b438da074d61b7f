// Kernel S: one fused PointNet++ set-abstraction stage over cached grouped geometry.
//
// Replaces puzzlefusion_plusplus_tpu/ops/sa_fused_pallas.py::sa_stage_fused_cached
// (_sa_cached_kernel). Per cloud m and centre s, over its K neighbours:
//   h1 = relu(g_rel[m,s,k] @ W_eff[m] + proj[m, gidx[m,s,k]] + b1)      [K, C1]
//   h2 = relu(h1 @ W2 + b2)                                             [K, C2]
//   out[m, s] = max_k relu(h2 @ W3 + b3)                                [C3]
// with BatchNorm folded into W2/W3 and the rotation into W_eff on the host. The TPU kernel
// gathers proj rows with a one-hot matmul; here the gather is a plain load. Two
// instantiations: the exact gather of f32 proj rows (the 'onehot' and 'dynamic' modes), and
// the 'int8' mode, where proj arrives as int8 codes q [M, N2, C1] with a scale per cloud and
// column [M, C1] and layer 1 adds float(q[m, gidx]) * scale[m] in place of the proj row.
// pfpp_sa_quantize makes those codes, as the JAX package does outside its kernel.
//
// Bound: the two products (2*rows*(C1*C2 + C2*C3) FLOP per stage, ~157 GFLOP per denoise
// step at 96 clouds), FP32-accurate on the tensor cores as 3xTF32 (three TF32 MMAs per
// product: 0.97 ms a step at 495 TFLOP/s, against 2.40 ms for FP32 on the CUDA cores).
// Design (sa_common.cuh): W2 and W3 arrive split into their TF32 planes; a block of one
// warpgroup per 64 rows owns 128 rows at SA1, SA2 and SA3 (sa::with_block_shape; SA3's h2
// overwrites h1 in place), so each weight byte read from L2 serves that many rows. Layer 1
// (the 3-term xyz product, the gathered proj row and the bias) is FP32 elementwise work:
// the block's proj rows land in h1 by cp.async (int8: its codes in a [BM][C1] byte buffer,
// 16 codes a copy), all in flight at once, while the ring's first weight tiles load. Layers
// 2 and 3 run as wgmma 3xTF32 passes of N columns from the ring, and the max over K is fused
// into layer 3's epilogue. h1 and h2 never leave shared memory.
#include "sa_common.cuh"

namespace {

// S's shared memory in floats from the base: the ring's mbarriers, the weight ring of
// `stages` tiles, activation buffers 0 and 1
// (h1 in 0; h2 in place of h1 or in 1), the layer-3 maxima, the rows' xyz and gather index,
// then (int8) the rows' codes; bytes is the total.
template <class Sh>
struct Smem {
  sa::Buffers buf;
  size_t act[2], red, gs, gi, codes, bytes;
  __host__ __device__ Smem(int K, int C1, int C2, bool int8, int stages)
      : buf(2, C1, C2, 0, Sh::N) {
    act[0] = sa::kBarrierFloats + (size_t)stages * Sh::kTileFloats;
    act[1] = act[0] + (size_t)Sh::BM * buf.ld(0);
    red = act[1] + (size_t)Sh::BM * buf.ld(1);
    gs = red + (size_t)(Sh::BM / sa::rows_in_warp(K)) * Sh::N;
    gi = gs + Sh::BM * 3;
    codes = gi + Sh::BM;
    bytes = sizeof(float) * codes + (int8 ? (size_t)Sh::BM * C1 : 0);
  }
};

// kInt8: `proj` holds int8 codes and `scale` [M, C1] their dequantization scales.
template <class Sh, bool kInt8>
__global__ void __launch_bounds__(Sh::kBlockThreads, Sh::kMinBlocks) sa_cached_kernel(
    const float* __restrict__ g, const float* __restrict__ weff,
    const void* __restrict__ proj, const float* __restrict__ scale,
    const int* __restrict__ gidx, const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ w3, const float* __restrict__ b3,
    float* __restrict__ out, int S, int K, int N2, int C1, int C2, int C3, int stages) {
  constexpr int BM = Sh::BM, kThreads = Sh::kThreads;
  extern __shared__ float4 smem4[];
  float* base = reinterpret_cast<float*>(smem4);
  const Smem<Sh> L(K, C1, C2, kInt8, stages);
  float* h1 = base + L.act[L.buf.in[0]];  // [BM][ld1]
  float* h2 = base + L.act[L.buf.in[1]];  // [BM][ld2]
  const int ld1 = L.buf.ld(L.buf.in[0]), ld2 = L.buf.ld(L.buf.in[1]);
  float* red = base + L.red;  // [BM / min(K, 16)][N]
  float* gs = base + L.gs;    // [BM][3]
  int* gi = reinterpret_cast<int*>(base + L.gi);
  int8_t* codes = reinterpret_cast<int8_t*>(base + L.codes);  // kInt8: [BM][C1], 16-B aligned

  const int m = blockIdx.y;
  const int s0 = blockIdx.x * (BM / K);
  const int tid = threadIdx.x;

  sa::WeightStream<Sh> ws;
  ws.add(w2, C1, C2);
  ws.add(w3, C2, C3);
  ws.init(base + sa::kBarrierFloats, reinterpret_cast<uint64_t*>(base), stages);
  __syncthreads();
  if (tid >= kThreads) {  // the producer warp: W2's first tiles load while layer 1 runs
    if (tid == kThreads) ws.produce();
    return;
  }

  for (int r = tid; r < BM; r += kThreads) {
    const int s = s0 + r / K;
    const bool ok = s < S;
    const size_t row = ((size_t)m * S + (ok ? s : 0)) * K + r % K;
    gs[r * 3 + 0] = ok ? g[row * 3 + 0] : 0.f;
    gs[r * 3 + 1] = ok ? g[row * 3 + 1] : 0.f;
    gs[r * 3 + 2] = ok ? g[row * 3 + 2] : 0.f;
    gi[r] = (ok && gidx != nullptr) ? gidx[row] : 0;
  }
  sa::bar_sync(1, kThreads);

  // the rows' proj vectors (or codes) straight into shared memory, one warp a row (cp.async:
  // all of them in flight at once)
  const int lane = tid & 31, warp = tid >> 5;
  if (proj != nullptr) {
    for (int r = warp; r < BM; r += kThreads / 32) {
      if constexpr (kInt8) {
        const int8_t* src = static_cast<const int8_t*>(proj) + ((size_t)m * N2 + gi[r]) * C1;
        for (int c = lane * 16; c < C1; c += 512)
          sa::cp_async16(reinterpret_cast<float*>(codes + r * C1 + c),
                         reinterpret_cast<const float*>(src + c));
      } else {
        const float* src = static_cast<const float*>(proj) + ((size_t)m * N2 + gi[r]) * C1;
        for (int c = lane * 4; c < C1; c += 128) sa::cp_async16(h1 + r * ld1 + c, src + c);
      }
    }
  }
  sa::cp_async_commit();
  sa::cp_async_wait<0>();
  sa::bar_sync(1, kThreads);

  // layer 1: rotation-folded xyz term + gathered feature projection + bias, ReLU
  if constexpr (kInt8)
    sa::xyz_layer<Sh>(gs, weff + (size_t)m * 3 * C1, b1, h1, ld1, C1, false, codes,
                      scale + (size_t)m * C1);
  else
    sa::xyz_layer<Sh>(gs, weff + (size_t)m * 3 * C1, b1, h1, ld1, C1, proj != nullptr);
  sa::bar_sync(1, kThreads);  // publishes h1

  int t = 0;
  sa::mlp_tail<Sh>(ws, t, h1, ld1, h2, ld2, red, b2, b3, out, m, S, K, s0, C1, C2, C3);
}

template <class Sh, bool kInt8>
int launch(const float* g, const float* weff, const void* proj, const float* scale,
           const int* gidx, const float* b1, const float* w2, const float* b2, const float* w3,
           const float* b3, float* out, int M, int S, int K, int N2, int C1, int C2, int C3,
           int stages, cudaStream_t stream) {
  const size_t smem = Smem<Sh>(K, C1, C2, kInt8, stages).bytes;
  cudaError_t err = cudaFuncSetAttribute(sa_cached_kernel<Sh, kInt8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int cpb = Sh::BM / K;
  const dim3 grid((S + cpb - 1) / cpb, M);
  sa_cached_kernel<Sh, kInt8><<<grid, Sh::kBlockThreads, smem, stream>>>(
      g, weff, proj, scale, gidx, b1, w2, b2, w3, b3, out, S, K, N2, C1, C2, C3, stages);
  return (int)cudaGetLastError();
}

// Calls f(shape, stages) for the block shape of these widths (see sa::with_block_shape).
template <class F>
int with_shape(int K, int C1, int C2, int C3, bool int8, F&& f, int none) {
  return sa::with_block_shape(
      K, sa::pass_width({C2, C3}),
      [&](auto shape, int stages) {
        return Smem<decltype(shape)>(K, C1, C2, int8, stages).bytes;
      },
      f, none);
}

template <bool kInt8>
int dispatch(const float* g, const float* weff, const void* proj, const float* scale,
             const int* gidx, const float* b1, const float* w2, const float* b2,
             const float* w3, const float* b3, float* out, int M, int S, int K, int N2, int C1,
             int C2, int C3, void* stream) {
  if (M == 0 || S == 0) return 0;
  return with_shape(
      K, C1, C2, C3, kInt8,
      [&](auto shape, int stages) {
        return launch<decltype(shape), kInt8>(g, weff, proj, scale, gidx, b1, w2, b2, w3, b3,
                                              out, M, S, K, N2, C1, C2, C3, stages,
                                              (cudaStream_t)stream);
      },
      (int)cudaErrorInvalidValue);
}

// The 'int8' mode's codes (sa_fused_pallas.py:318-323): per cloud m and column c,
//   scale[m, c] = max(max_n |proj[m, n, c]| / 127, 1e-30)
//   q[m, n, c] = clamp(rint(proj[m, n, c] / scale[m, c]), -127, 127)
// in IEEE arithmetic (the division correctly rounded, rint to nearest even), so the codes are
// bit-equal to the plain version's. A block of 32 columns x 8 row lanes owns one cloud's
// column tile: the 8 lanes reduce the max over their rows, the first combines them, then all
// write the tile's codes. Bound: bytes (proj read twice, here counted once, codes written).
constexpr int kQThreads = 256, kQCols = 32, kQRows = kQThreads / kQCols;

__global__ void __launch_bounds__(kQThreads) sa_quantize_kernel(
    const float* __restrict__ proj, float* __restrict__ scale, int8_t* __restrict__ q, int N2,
    int C1) {
  __shared__ float red[kQRows][kQCols];
  const int m = blockIdx.y, tx = threadIdx.x % kQCols, ty = threadIdx.x / kQCols;
  const int c = blockIdx.x * kQCols + tx;
  const bool ok = c < C1;
  const float* col = proj + (size_t)m * N2 * C1 + c;
  float amax = 0.f;
  if (ok)
    for (int n = ty; n < N2; n += kQRows) amax = fmaxf(amax, fabsf(col[(size_t)n * C1]));
  red[ty][tx] = amax;
  __syncthreads();
  if (ty == 0) {
    for (int k = 1; k < kQRows; ++k) amax = fmaxf(amax, red[k][tx]);
    const float s = fmaxf(__fdiv_rn(amax, 127.f), 1e-30f);
    red[0][tx] = s;
    if (ok) scale[(size_t)m * C1 + c] = s;
  }
  __syncthreads();
  const float s = red[0][tx];
  if (!ok) return;
  int8_t* qc = q + (size_t)m * N2 * C1 + c;
  for (int n = ty; n < N2; n += kQRows) {
    const float v = rintf(__fdiv_rn(col[(size_t)n * C1], s));
    qc[(size_t)n * C1] = (int8_t)fminf(fmaxf(v, -127.f), 127.f);
  }
}

}  // namespace

// Rows of one block at these widths (128 or 64; 0: the layers do not fit shared memory), of
// the exact instantiation or (int8 != 0) the int8 one.
PFPP_EXPORT int pfpp_sa_cached_rows(int K, int C1, int C2, int C3, int int8) {
  return with_shape(K, C1, C2, C3, int8 != 0,
                    [](auto shape, int) { return decltype(shape)::BM; }, 0);
}

// Shapes: g [M,S,K,3], weff [M,3,C1], proj [M,N2,C1] or null, gidx [M,S,K] or null,
// w2 and w3 the TF32 planes of W2 [C1,C2] and W3 [C2,C3] (ops/sa_fused.py::tf32_planes),
// out [M,S,C3]. Requires 64 % K == 0, K % 4 == 0, C1 % 32 == 0, C2 % 64 == 0, C3 % 64 == 0
// and 16-byte aligned w2/w3 (checked by the Python wrapper); widths whose activations do
// not fit shared memory even at 64 rows return cudaErrorInvalidValue.
PFPP_EXPORT int pfpp_sa_cached(const float* g, const float* weff, const float* proj,
                               const int* gidx, const float* b1, const float* w2,
                               const float* b2, const float* w3, const float* b3, float* out,
                               int M, int S, int K, int N2, int C1, int C2, int C3,
                               void* stream) {
  return dispatch<false>(g, weff, proj, nullptr, gidx, b1, w2, b2, w3, b3, out, M, S, K, N2,
                         C1, C2, C3, stream);
}

// The 'int8' mode: as pfpp_sa_cached with the codes q [M,N2,C1] int8 and their scales
// [M,C1] f32 (both 16-byte aligned) in place of proj; gidx is required.
PFPP_EXPORT int pfpp_sa_cached_int8(const float* g, const float* weff, const int8_t* q,
                                    const float* scale, const int* gidx, const float* b1,
                                    const float* w2, const float* b2, const float* w3,
                                    const float* b3, float* out, int M, int S, int K, int N2,
                                    int C1, int C2, int C3, void* stream) {
  return dispatch<true>(g, weff, q, scale, gidx, b1, w2, b2, w3, b3, out, M, S, K, N2, C1,
                        C2, C3, stream);
}

// proj [M,N2,C1] f32 -> scale [M,C1] f32, q [M,N2,C1] int8 (see sa_quantize_kernel).
PFPP_EXPORT int pfpp_sa_quantize(const float* proj, float* scale, int8_t* q, int M, int N2,
                                 int C1, void* stream) {
  if (M == 0 || C1 == 0) return 0;
  const dim3 grid((C1 + kQCols - 1) / kQCols, M);
  sa_quantize_kernel<<<grid, kQThreads, 0, (cudaStream_t)stream>>>(proj, scale, q, N2, C1);
  return (int)cudaGetLastError();
}
