// Kernel D: y = x @ W^T (+ b) for the denoiser's inference linears, FP32-accurate as 3xTF32
// on the tensor cores (wgmma).
//
// Replaces no TPU kernel: the JAX denoiser's Dense layers go to XLA's own matrix products.
// Added because cuBLAS, with TF32 off (inference/run.py::resolve_device), runs these fp32
// products as SIMT FFMA kernels that never touch the tensor cores, about two thirds of the
// engine's step at batch 8. Shapes (K -> N for M = 25 * batch * part pad rows): the fused
// q|k|v 512 -> 1536, the attention out-projection 512 -> 512, the GEGLU projection 512 -> 4096
// (its epilogue writes h * gelu(gate), [M, 2048]) and the feed-forward out-projection
// 2048 -> 512.
//
// Bound: the products, three TF32 MMAs each (big*big + big*small + small*big of the split
// operands, sa_common.cuh), 6 * M * K * N FLOP at 495 TFLOP/s, against 2 * M * K * N at
// 67 TFLOP/s for FP32 on the CUDA cores.
//
// Design:
// - The weights arrive split (ops/dense.py::weight_planes, once per weight version): W^T in
//   the TF32 planes of ops/sa_fused.py::tf32_planes, its inputs permuted inside each run of 16
//   so that a lane's four inputs of two k8 slices are four consecutive floats of x. A lane then
//   loads its A fragments as one float4 per row and 16 inputs, straight from device memory
//   into registers (no shared memory for A), and splits them there, once per block tile.
// - A block owns BM = 64 or 128 rows (one warpgroup per 64) by BN = 64 or 128 columns. Its
//   producer warp streams the weight planes' stages (2 planes x 32 inputs x BN columns) by
//   cp.async.bulk onto mbarriers; each warpgroup runs, per 64 columns of a stage, three wgmma
//   m64n64k8 per k8 slice, with the next stage's A loads in flight under them.
// - Two-level sums: the MMAs of a stage's 64 columns accumulate into a fresh register tile,
//   which an FP32 add then puts into the running sum. The tensor cores' own accumulation
//   rounds less carefully than an FP32 add: summed over all of K = 2048 in the MMAs, the error
//   reached 1.7e-5 of the largest output (cuBLAS fp32: 2e-6); in 12-MMA tiles, 4e-7 to 7e-7.
//   A 64-column tile at a time keeps a 128-column block within the registers the compiler
//   grants 288 threads (168 a thread).
// - Split K: a thread block cluster of 2 or 4 blocks along z shares one output tile, each
//   block a contiguous share of K; the blocks park their accumulators in their shared memory
//   and the cluster's first block adds them in rank order (distributed shared memory), so the
//   sum is a fixed sequence of operations. No atomics anywhere: launches are bit-reproducible.
// - The epilogue adds the bias and, for the GEGLU projection, whose planes interleave 8
//   columns of h with the matching 8 of gate, applies h * gelu(gate) (exact erf, as F.gelu).
// - The block shape and the split come from ops/dense.py::tile_shape, from (M, N, K).
//
// What holds it back (measured on the H100, PERF.md section 6): D runs at 2.0-3.0x its bound
// at the b8 engine's shapes, 2.3x over a denoising step. While a wave of blocks runs, a ring
// stage takes 1.26 us at 128 x 128 for 0.84 us of MMAs (66% of the tensor rate), 0.75 for 0.42
// at 128 x 64 (56%), 0.60 for 0.42 at 64 x 64 with two blocks an SM (70%): each warpgroup waits
// for its MMAs before its FP32 add, and the other warpgroup covers the wait only in part. Each
// wave also pays 2.5-11 us of prologue, epilogue and cluster sum, and the last wave runs part
// full.
#include "sa_common.cuh"

namespace {

// BM rows (a warpgroup per 64) by BN columns; a ring stage holds KT inputs of both planes.
template <int BM_, int BN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, KT = 32;
  static constexpr int kConsumers = 2 * BM;           // the warpgroups' threads
  static constexpr int kThreads = kConsumers + 32;    // and the producer warp
  static constexpr int kMinBlocks = BM == 64 ? 2 : 1;
  static constexpr int kStageFloats = 2 * KT * BN;
  static constexpr int kChunks = KT / 16, kSlices = KT / 8;
  static_assert(BM == 64 || BM == 128, "one or two warpgroups");
  static_assert(BN == 64 || BN == 128, "64-column MMA tiles");
};

__device__ __forceinline__ float4 load4(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// A phase that does not complete within about a second of tries traps: a launch error, not
// a hung card.
__device__ __forceinline__ void wait_or_trap(uint64_t* bar, int parity) {
  const uint32_t a = sa::smem_addr(bar);
  uint32_t done = 0;
  for (int tries = 0; !done; ++tries) {
    if (tries == (1 << 20)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void cluster_barrier() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The float at shared address `addr` of block `rank` of the cluster.
__device__ __forceinline__ float peer_load(uint32_t addr, int rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

__device__ __forceinline__ float gelu(float g) {
  return g * 0.5f * (1.f + erff(g * 0.70710678118654752440f));
}

// out[M, N] (N / 2 with kGeglu) = x[M, K] @ W^T + b over the cluster's share of K (gridDim.z
// blocks a cluster, each K / gridDim.z inputs). w: the planes [K/8][2][N/8][2][8][4] of
// ops/dense.py::weight_planes; bias in the planes' column order, or null.
template <class T, bool kGeglu>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
dense_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, float* __restrict__ out, int M, int N, int K,
             int stages) {
  constexpr int BN = T::BN, KT = T::KT;
  extern __shared__ float4 smem4[];
  float* base = reinterpret_cast<float*>(smem4);
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + sa::kMaxStages;
  float* ring = base + sa::kBarrierFloats;

  const int tid = threadIdx.x;
  const int split = gridDim.z, rank = split > 1 ? (int)cluster_rank() : 0;
  const int kbeg = rank * (K / split), ntiles = K / split / KT;
  const int m0 = blockIdx.y * T::BM, c0 = blockIdx.x * BN;

  if (tid == T::kConsumers) {
    for (int s = 0; s < stages; ++s) {
      sa::mbar_init(full + s, 1);
      sa::mbar_init(empty + s, T::kConsumers / 32);
    }
    sa::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= T::kConsumers) {  // the producer warp
    if (tid == T::kConsumers) {
      constexpr uint32_t kChunk = BN * 8 * sizeof(float);  // one k8 slice of one plane
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % stages;
        if (t >= stages) wait_or_trap(empty + s, (t / stages - 1) & 1);
        sa::mbar_expect_tx(full + s, T::kStageFloats * sizeof(float));
        const int kb = (kbeg + t * KT) / 8;
        float* dst = ring + (size_t)s * T::kStageFloats;
        for (int c = 0; c < KT / 4; ++c)  // (slice, plane) chunks, as the planes lie
          sa::bulk_copy(dst + c * BN * 8, w + ((size_t)(2 * kb + c) * N + c0) * 8, kChunk,
                        full + s);
      }
    }
    __syncwarp();
    if (split > 1) {  // the consumers' reduction barriers
      sa::bar_sync(1, T::kThreads);
      cluster_barrier();
      cluster_barrier();
    }
    return;
  }

  const int lane = tid & 31, warp = tid >> 5, q = lane & 3;
  const int row0 = m0 + warp * 16 + (lane >> 2);  // the lane's rows row0 and row0 + 8
  const float* xa = x + (size_t)min(row0, M - 1) * K + kbeg + 4 * q;
  const float* xb = x + (size_t)min(row0 + 8, M - 1) * K + kbeg + 4 * q;

  float acc[BN / 2], part[32];  // the running sum; one stage's MMAs on 64 columns
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  float4 raw[T::kChunks][2];  // the stage's A: per 16 inputs, the lane's rows row0, row0 + 8
#pragma unroll
  for (int c = 0; c < T::kChunks; ++c)
    raw[c][0] = load4(xa + 16 * c), raw[c][1] = load4(xb + 16 * c);

  for (int t = 0; t < ntiles; ++t) {
    // slice 2c + h of chunk c takes inputs 2h, 2h + 1 of the lane's four: a[0], a[1] the
    // rows' first, a[2], a[3] their second (weight_planes orders W's inputs to match)
    uint32_t ab[T::kSlices][4], as[T::kSlices][4];
#pragma unroll
    for (int c = 0; c < T::kChunks; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int sl = 2 * c + h;
        sa::split_tf32(at(raw[c][0], 2 * h), ab[sl][0], as[sl][0]);
        sa::split_tf32(at(raw[c][1], 2 * h), ab[sl][1], as[sl][1]);
        sa::split_tf32(at(raw[c][0], 2 * h + 1), ab[sl][2], as[sl][2]);
        sa::split_tf32(at(raw[c][1], 2 * h + 1), ab[sl][3], as[sl][3]);
      }
#pragma unroll
    for (int sl = 0; sl < T::kSlices; ++sl) sa::hold(ab[sl]), sa::hold(as[sl]);
    const int s = t % stages;
    wait_or_trap(full + s, (t / stages) & 1);  // stage t's planes have landed
    const float* tile = ring + (size_t)s * T::kStageFloats;
#pragma unroll
    for (int n0 = 0; n0 < BN; n0 += 64) {  // a 64-column MMA tile, then its FP32 add
#pragma unroll
      for (int i = 0; i < 32; ++i) part[i] = 0.f;
      sa::hold(part);
      sa::wgmma_fence();
#pragma unroll
      for (int sl = 0; sl < T::kSlices; ++sl) {
        const uint64_t big = sa::plane_desc(tile + 2 * sl * BN * 8 + n0 * 8);
        const uint64_t small = sa::plane_desc(tile + (2 * sl + 1) * BN * 8 + n0 * 8);
        sa::Wgmma<64>::run(part, as[sl], big);
        sa::Wgmma<64>::run(part, ab[sl], small);
        sa::Wgmma<64>::run(part, ab[sl], big);
      }
      sa::wgmma_commit();
      if (n0 == 0 && t + 1 < ntiles) {  // the next stage's A, in flight under the MMAs
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c)
          raw[c][0] = load4(xa + (t + 1) * KT + 16 * c),
          raw[c][1] = load4(xb + (t + 1) * KT + 16 * c);
      }
      sa::wgmma_wait<0>();
      // the split operands stay live until the MMAs that read them are done, so that the
      // loads above are never given their registers
#pragma unroll
      for (int sl = 0; sl < T::kSlices; ++sl) sa::hold(ab[sl]), sa::hold(as[sl]);
      sa::hold(part);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[n0 / 2 + i] += part[i];
    }
    __syncwarp();
    if (lane == 0) sa::mbar_arrive(empty + s);
  }

  if (split > 1) {
    // the ring is free once every warp is past its last MMA; each thread parks its
    // accumulators at [i][tid], and the first block adds the others' in rank order
    sa::bar_sync(1, T::kThreads);
    if (rank > 0) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) ring[i * T::kConsumers + tid] = acc[i];
    }
    cluster_barrier();
    if (rank == 0) {
      const uint32_t red = sa::smem_addr(ring) + 4u * tid;
      for (int r = 1; r < split; ++r)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
          acc[i] += peer_load(red + 4u * i * T::kConsumers, r);
    }
    cluster_barrier();  // no block leaves while the first may still read it
    if (rank > 0) return;
  }

  // acc[4j + r]: row row0 (+ 8 for r >= 2), column c0 + 8j + 2q (+ 1 for odd r)
  const int ld = kGeglu ? N / 2 : N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= M) continue;
    float* orow = out + (size_t)row * ld;
    if constexpr (kGeglu) {
#pragma unroll
      for (int i = 0; i < BN / 16; ++i) {  // column group 2i holds h, 2i + 1 its gate
        const int ch = c0 + 16 * i + 2 * q, cg = ch + 8;
        const float h0 = acc[8 * i + 2 * h] + bias[ch], h1 = acc[8 * i + 2 * h + 1] + bias[ch + 1];
        const float g0 = acc[8 * i + 4 + 2 * h] + bias[cg];
        const float g1 = acc[8 * i + 4 + 2 * h + 1] + bias[cg + 1];
        *reinterpret_cast<float2*>(orow + c0 / 2 + 8 * i + 2 * q) =
            make_float2(h0 * gelu(g0), h1 * gelu(g1));
      }
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = c0 + 8 * j + 2 * q;
        const float b0 = bias != nullptr ? bias[col] : 0.f;
        const float b1 = bias != nullptr ? bias[col + 1] : 0.f;
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(acc[4 * j + 2 * h] + b0, acc[4 * j + 2 * h + 1] + b1);
      }
    }
  }
}

// The ring's stages: as many as shared memory holds at kMinBlocks blocks an SM (at most
// sa::kMaxStages); 0 where a split's sums do not fit in them.
template <class T>
int stages_of(int split) {
  const size_t budget = sa::kSmemPerSM / T::kMinBlocks - sa::kSmemReserved;
  const size_t stage = sizeof(float) * T::kStageFloats, fixed = sizeof(float) * sa::kBarrierFloats;
  const int n = (int)((budget - fixed) / stage);
  const int stages = n < sa::kMaxStages ? n : sa::kMaxStages;
  if (stages < 2) return 0;
  if (split > 1 && (size_t)stages * T::kStageFloats < (size_t)T::BM * T::BN) return 0;
  return stages;
}

template <class T, bool kGeglu>
int launch(const float* x, const float* w, const float* bias, float* out, int M, int N, int K,
           int split, cudaStream_t stream) {
  const int stages = stages_of<T>(split);
  if (stages == 0 || N % T::BN || K % (split * T::KT)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (sa::kBarrierFloats + (size_t)stages * T::kStageFloats);
  cudaError_t err = cudaFuncSetAttribute(dense_kernel<T, kGeglu>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / T::BN, (M + T::BM - 1) / T::BM, split);
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, dense_kernel<T, kGeglu>, x, w, bias, out, M, N, K, stages);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <class T>
int launch_g(const float* x, const float* w, const float* bias, float* out, int M, int N, int K,
             int geglu, int split, cudaStream_t stream) {
  return geglu ? launch<T, true>(x, w, bias, out, M, N, K, split, stream)
               : launch<T, false>(x, w, bias, out, M, N, K, split, stream);
}

}  // namespace

// x [M,K] f32 (16-byte aligned, K % 4 == 0), w the planes of ops/dense.py::weight_planes
// [K/8][2][N/8][2][8][4] f32 (16-byte aligned), bias [N] in the planes' column order or null
// (required with geglu), out [M, N] or, with geglu, [M, N/2]. Block shape (bm, bn) in
// {(128, 128), (128, 64), (64, 64)} and split in {1, 2, 4}; requires N % bn == 0 and
// K % (32 * split) == 0, else returns cudaErrorInvalidValue.
PFPP_EXPORT int pfpp_dense(const float* x, const float* w, const float* bias, float* out, int M,
                           int N, int K, int geglu, int bm, int bn, int split, void* stream) {
  if (M == 0) return 0;
  if ((split != 1 && split != 2 && split != 4) || (geglu && (bias == nullptr || N % 16)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (bm == 128 && bn == 128)
    return launch_g<Tile<128, 128>>(x, w, bias, out, M, N, K, geglu, split, s);
  if (bm == 128 && bn == 64)
    return launch_g<Tile<128, 64>>(x, w, bias, out, M, N, K, geglu, split, s);
  if (bm == 64 && bn == 64)
    return launch_g<Tile<64, 64>>(x, w, bias, out, M, N, K, geglu, split, s);
  return (int)cudaErrorInvalidValue;
}
