// Kernel G: exact batched point gather, out[b, r, :] = points[b, idx[b, r], :]; kernel A
// launches it too.
//
// Replaces puzzlefusion_plusplus_tpu/ops/gather_pallas.py::gather_points_pallas
// (_gather_kernel) and gather_pallas.py::gather_points_approx (_gather_approx_kernel), whose
// bf16 rounding comes only from the TPU's matrix unit: here both are the same exact load,
// told apart by their wrappers' launch counters. The TPU kernel splits each f32 into four
// byte planes and selects them with one-hot matmuls because its matrix unit rounds f32
// operands to bf16; on Hopper a gather is a load.
//
// Bound: bytes (the source read once, idx read once, each output element written once). At
// the SA feature gathers the output is about 30x the source (671 MB from 21 MB at SA2 with
// M = 160), so the kernel is a store stream; at C = 3 (the xyz gathers) rows are 12 bytes,
// the outputs 9-16 MB, and scattered 4-byte loads, not bytes, set the pace.
//
// Design. The work unit is a tile of 32 consecutive rows of one cloud, whose output is one
// contiguous run of 32 * C floats. A warp takes a tile: lane l loads idx of the tile's row l
// (one coalesced load, each index read once) and the next tile's indices are loaded before
// this tile's rows, so that latency overlaps. The warp then walks the tile's output in
// 32-unit steps: unit e belongs to row k = e / V of the tile (V units a row), found with a
// 32-bit multiply by a reciprocal (exact for V <= 8192) and its index fetched with a
// shuffle from lane k. So every store instruction of a warp writes consecutive addresses
// whatever C is: at C = 3 a warp writes 96 consecutive floats in three stores. Each lane
// loads kUnroll units before its first store, and stores stream past L2 (st.global.cs) so
// that the output does not evict the source, which later rows read again. No 64-bit
// division anywhere: a tile's cloud is one 32-bit division a tile, and 64-bit offsets are
// formed by a wide multiply-add.
//
// Two kernels share that walk. pfpp_gather_rows_kernel reads the source through L1 in
// float4 units when C % 4 == 0 and both bases are 16-byte aligned (the wrapper decides; the
// launch refuses a misaligned float4 request), else in floats; its grid is one wave of
// resident blocks striding over all tiles. pfpp_gather_staged_kernel takes the float path
// when a cloud fits 48 KB (N * C <= 12288: every xyz gather of the engine and the trainers):
// a block copies its cloud into shared memory once and serves up to 64 tiles of it from
// there (fewer where the grid would leave SMs idle), because a warp's scattered 4-byte loads
// of 12-byte rows cost L1 about one pass per row touched, and shared memory one bank access:
// through L1 this path ran slower on the H100 than torch.gather, staged it runs faster.
//
// bfloat16 rows (the composable encode under trainer.precision=bf16 gathers bf16 features):
// the copy needs no arithmetic, so pfpp_gather_bf16 launches the same rows kernel on
// 16-byte units (8 bf16 values, the float4 instantiation) when C % 8 == 0 and both bases
// are 16-byte aligned, else on 2-byte units (its unsigned short instantiation). No upcast:
// the kernel moves the bf16 bytes and nothing more.
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;        // warps a block
constexpr int kUnroll = 8;       // units each lane loads before it stores
constexpr int kMaxUnits = 8192;  // units a row: the reciprocal division is exact below it
constexpr int kStagedFloats = 12288;  // clouds up to 48 KB are staged in shared memory
constexpr int kStagedTiles = 64;      // tiles a block of the staged kernel takes, at most

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    pfpp_gather_rows_kernel(const T* __restrict__ points, const int* __restrict__ idx,
                            T* __restrict__ out, int N, int R, int V, unsigned magic,
                            int tiles_per_cloud, int total_tiles) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarps;
  int tile = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (tile >= total_tiles) return;  // the whole warp leaves together
  auto load_idx = [&](int t) {
    const int b = t / tiles_per_cloud;
    const int r = (t - b * tiles_per_cloud) * 32 + lane;
    return r < R ? __ldg(idx + (size_t)b * R + r) : 0;
  };
  int next = load_idx(tile);
  for (; tile < total_tiles; tile += stride) {
    const int mine = next;
    if (tile + stride < total_tiles) next = load_idx(tile + stride);
    const int b = tile / tiles_per_cloud;
    const int r0 = (tile - b * tiles_per_cloud) * 32;
    const int units = min(32, R - r0) * V;
    const T* src = points + (size_t)b * N * V;
    T* dst = out + ((size_t)b * R + r0) * V;
    for (int e0 = 0; e0 < units; e0 += 32 * kUnroll) {
      T v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = e0 + u * 32 + lane;
        const int k = V == 1 ? e : (int)__umulhi((unsigned)e, magic);
        const int n = __shfl_sync(0xffffffffu, mine, k & 31);
        if (e < units) v[u] = __ldg(src + (size_t)n * V + (e - k * V));
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = e0 + u * 32 + lane;
        if (e < units) __stcs(dst + e, v[u]);
      }
    }
  }
}

// Scalar units from a cloud staged in shared memory: block (x, y) stages cloud y's N * V
// floats, then its warps take `span` tiles of that cloud, as above.
__global__ void __launch_bounds__(kWarps * 32)
    pfpp_gather_staged_kernel(const float* __restrict__ points, const int* __restrict__ idx,
                              float* __restrict__ out, int B, int N, int R, int V,
                              unsigned magic, int span) {
  extern __shared__ float cloud[];
  const int lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * span;
  const int t1 = min((R + 31) / 32, t0 + span);
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const int* ib = idx + (size_t)b * R;
    auto load_idx = [&](int t) {
      const int r = t * 32 + lane;
      return t < t1 && r < R ? __ldg(ib + r) : 0;
    };
    int tile = t0 + (threadIdx.x >> 5);
    int next = load_idx(tile);  // in flight while the cloud is staged
    const float* src = points + (size_t)b * N * V;
    __syncthreads();  // the previous cloud's reads are done
    for (int i = threadIdx.x; i < N * V; i += blockDim.x) cloud[i] = __ldg(src + i);
    __syncthreads();
    for (; tile < t1; tile += kWarps) {
      const int mine = next;
      next = load_idx(tile + kWarps);
      const int r0 = tile * 32;
      const int units = min(32, R - r0) * V;
      float* dst = out + ((size_t)b * R + r0) * V;
      for (int e0 = 0; e0 < units; e0 += 32 * kUnroll) {
        float v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int e = e0 + u * 32 + lane;
          const int k = V == 1 ? e : (int)__umulhi((unsigned)e, magic);
          const int n = __shfl_sync(0xffffffffu, mine, k & 31);
          if (e < units) v[u] = cloud[n * V + (e - k * V)];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int e = e0 + u * 32 + lane;
          if (e < units) __stcs(dst + e, v[u]);
        }
      }
    }
  }
}

// ceil(2^32 / V): __umulhi(e, it) == e / V for e < 32 * V when V <= kMaxUnits
unsigned reciprocal(int V) {
  return V > 1 ? (unsigned)((0x100000000ULL + V - 1) / V) : 0u;
}

int sm_count() {
  static int sms = 0;  // one card a process
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

int resident_blocks(const void* kernel) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarps * 32, 0);
  return sm_count() * (per_sm > 0 ? per_sm : 1);
}

template <typename T>
int launch(const T* points, const int* idx, T* out, int B, int N, int R, int V,
           cudaStream_t stream) {
  static int wave = 0;  // resident blocks of one wave on the card (one card a process)
  if (wave == 0) wave = resident_blocks((const void*)pfpp_gather_rows_kernel<T>);
  const int tiles_per_cloud = (R + 31) / 32;
  const long long total = (long long)B * tiles_per_cloud;
  if (total > INT_MAX) return (int)cudaErrorInvalidValue;
  long long blocks = (total + kWarps - 1) / kWarps;
  if (blocks > wave) blocks = wave;
  pfpp_gather_rows_kernel<T><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      points, idx, out, N, R, V, reciprocal(V), tiles_per_cloud, (int)total);
  return (int)cudaGetLastError();
}

}  // namespace

// vec != 0: float4 units (C % 4 == 0 and 16-byte aligned bases, else cudaErrorInvalidValue).
PFPP_EXPORT int pfpp_gather(const float* points, const int* idx, float* out, int B, int N,
                            int R, int C, int vec, void* stream) {
  if ((long long)B * R * C == 0) return 0;
  const int V = vec ? C / 4 : C;
  if (V > kMaxUnits) return (int)cudaErrorInvalidValue;
  if (vec) {
    if (C % 4 != 0 || ((uintptr_t)points | (uintptr_t)out) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    return launch((const float4*)points, idx, (float4*)out, B, N, R, V,
                  (cudaStream_t)stream);
  }
  if ((long long)N * C > kStagedFloats)
    return launch(points, idx, out, B, N, R, V, (cudaStream_t)stream);
  // kStagedTiles a block amortise its staging; fewer where that would leave SMs idle
  const int tiles = (R + 31) / 32;
  int span = kStagedTiles;
  while (span > kWarps && (long long)B * ((tiles + span - 1) / span) < 4LL * sm_count())
    span /= 2;
  const dim3 grid((tiles + span - 1) / span, B < 65535 ? B : 65535);
  pfpp_gather_staged_kernel<<<grid, kWarps * 32, N * C * 4, (cudaStream_t)stream>>>(
      points, idx, out, B, N, R, V, reciprocal(V), span);
  return (int)cudaGetLastError();
}

// bf16 rows: vec != 0: 16-byte units of 8 values (C % 8 == 0 and 16-byte aligned bases,
// else cudaErrorInvalidValue), else one 2-byte unit a value.
PFPP_EXPORT int pfpp_gather_bf16(const void* points, const int* idx, void* out, int B, int N,
                                 int R, int C, int vec, void* stream) {
  if ((long long)B * R * C == 0) return 0;
  const int V = vec ? C / 8 : C;
  if (V > kMaxUnits) return (int)cudaErrorInvalidValue;
  if (vec) {
    if (C % 8 != 0 || ((uintptr_t)points | (uintptr_t)out) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    return launch((const float4*)points, idx, (float4*)out, B, N, R, V,
                  (cudaStream_t)stream);
  }
  return launch((const unsigned short*)points, idx, (unsigned short*)out, B, N, R, V,
                (cudaStream_t)stream);
}

PFPP_EXPORT const char* pfpp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
