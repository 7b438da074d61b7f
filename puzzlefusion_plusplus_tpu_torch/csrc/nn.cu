// Kernels N and M: nearest-neighbour squared distance between point clouds.
//
// N replaces puzzlefusion_plusplus_tpu/ops/chamfer_pallas.py::nn_distance_pallas
// (_nn_kernel): x [B, N, 3], y [B, M, 3] -> (min_m |x_n - y_m|^2 [B, N], argmin [B, N]).
// M replaces chamfer_pallas.py::masked_pairwise_nn (_masked_pair_nn_kernel), batched over
// samples: pts [B, P, N, 3], pair_mask [B, P, P] -> out [B, P, P, N] holding
// min_m |pts[b, i, n] - pts[b, j, m]|^2 for active (i, j) and 3.9e12 elsewhere.
//
// The TPU kernels use the expanded |x|^2 + |y|^2 - 2 x.y form on the matrix unit and, for M,
// a hi/lo split of the coordinates, both only because that unit rounds f32 operands to bf16.
// Here the distance is three differences on the CUDA cores (sq_dist3: 8 separately rounded
// operations in the plain version's order), so distances are bit-identical to the plain
// PyTorch version and indices equal its first-minimum argmin.
//
// Bound: instruction issue. Each (query, target) pair costs the 8 unfused operations of
// sq_dist3 and its share of loads and bookkeeping, and nothing else on the card is close to
// saturated: the clouds are read once per block from L2, and a tile of targets feeds
// thousands of pairs. The design cuts the issue slots a pair takes from about 14 to about 9:
// * Q queries a thread (a template parameter, 2 or 4), in registers. Targets are staged in
//   shared memory as float4 (x, y, z, pad), so one broadcast 128-bit load feeds Q pairs.
// * Only a min in the inner loop: best = fminf(best, d), one FMNMX. The index is recovered
//   from chunks of kChunk targets: after each chunk a query records the chunk's first index
//   when its best fell strictly inside it. The recorded chunk is the last one in which best
//   fell, so no earlier target reaches the final value and the chunk's first target at that
//   value is the lowest index overall, which a rescan of kChunk targets finds after the scan
//   (from shared memory when the targets fit one tile, else from L2). A query whose best
//   never falls (every distance +inf or NaN) keeps index 0. fminf ignores NaN as the strict <
//   of an ascending scan did.
// * G target groups a block (a template parameter, 1, 2 or 4), of 64 threads each: every group
//   holds the block's 64 * Q queries and scans its own contiguous share of every tile, in
//   ascending order. At the end the groups' (distance, index) pairs are merged
//   lexicographically in shared memory, which is exact because "min, then lowest index" is
//   associative. Groups multiply the warps of small batches. N launches Q = 2, G = 1 when the
//   targets fit one tile, else Q = 4, G = 2 (4 warps a block of 256 queries); M launches
//   Q = 2, G = 4 (8 warps a block of 128 queries, so one pair of 1000-point parts spreads
//   over 64 warps, each scanning 256 targets). These are the fastest, or within 1% of it, of
//   Q in {2, 4} and G in {1, 2, 4, 8} timed on an H100 (PERF.md section 6).
// The ragged edge of a tile is padded with +inf points, which never lower a best and never
// equal one that fell. M runs the same scan without the index (a min is exact in any order)
// over the active (pair, query block) items of a persistent grid, which ranks the active
// pairs on the device and writes the sentinel of inactive pairs with float4 stores.
#include "common.cuh"

namespace {

constexpr int kGroupThreads = 64;  // threads of one target group
constexpr int kTile = 1024;        // target points a shared-memory tile (float4: 16 KB)
constexpr int kChunk = 16;         // targets between two records of where a best fell
constexpr float kInactive = 3.9e12f;

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Queries a block; the block's shared memory is one target tile, which the groups' (best,
// index) records reuse at the end (a float and an int each).
template <int Q, int G>
struct Block {
  static constexpr int kQueries = kGroupThreads * Q;
  static_assert(G * kQueries * 8 <= kTile * 16, "the records must fit the tile");
};

// The first index in [c0, c0 + kChunk) whose target lies at `best` from (x, y, z); targets
// come through at(j). Iterating downwards without a branch leaves the lowest hit.
template <class At>
__device__ __forceinline__ int first_hit(At at, int c0, float x, float y, float z,
                                         float best) {
  int hit = c0;
#pragma unroll
  for (int j = kChunk - 1; j >= 0; --j) {
    const float4 t = at(c0 + j);
    if (sq_dist3(x, y, z, t.x, t.y, t.z) == best) hit = c0 + j;
  }
  return hit;
}

// One block's 64 * Q queries [n0, n0 + 64 * Q) of q (nq points) against all nt targets of t:
// writes the min squared distance to dout[n] and, with kIndex, the lowest index reaching it
// to iout[n]. Every thread of the block calls it (it holds barriers).
template <int Q, int G, bool kIndex>
__device__ __forceinline__ void nn_block(const float* __restrict__ q, int nq,
                                         const float* __restrict__ t, int nt, int n0,
                                         float* __restrict__ dout, int* __restrict__ iout,
                                         float4* smem) {
  constexpr int kThreads = kGroupThreads * G, kQueries = Block<Q, G>::kQueries;
  const int g = threadIdx.x / kGroupThreads, l = threadIdx.x % kGroupThreads;
  float qx[Q], qy[Q], qz[Q], best[Q];
  int chunk[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int n = n0 + l + k * kGroupThreads;
    const bool in = n < nq;
    qx[k] = in ? q[(size_t)n * 3 + 0] : 0.f;
    qy[k] = in ? q[(size_t)n * 3 + 1] : 0.f;
    qz[k] = in ? q[(size_t)n * 3 + 2] : 0.f;
    best[k] = INFINITY;
    chunk[k] = -1;
  }
  for (int t0 = 0; t0 < nt; t0 += kTile) {
    const int cnt = min(kTile, nt - t0);
    const int span = ceil_div(ceil_div(cnt, G), kChunk) * kChunk;  // a group's targets
    __syncthreads();  // the previous tile (or item's records) is no longer read
    for (int j = threadIdx.x; j < G * span; j += kThreads) {
      float4 p = make_float4(INFINITY, INFINITY, INFINITY, 0.f);
      if (j < cnt) {
        const float* s = t + (size_t)(t0 + j) * 3;
        p = make_float4(s[0], s[1], s[2], 0.f);
      }
      smem[j] = p;
    }
    __syncthreads();
    const float4* p = smem + g * span;
    for (int c = 0; c < span; c += kChunk, p += kChunk) {
      float prev[Q];
#pragma unroll
      for (int k = 0; k < Q; ++k) prev[k] = best[k];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float4 s = p[j];  // one broadcast load for Q pairs
#pragma unroll
        for (int k = 0; k < Q; ++k)
          best[k] = fminf(best[k], sq_dist3(qx[k], qy[k], qz[k], s.x, s.y, s.z));
      }
      if (kIndex) {
#pragma unroll
        for (int k = 0; k < Q; ++k)
          if (best[k] < prev[k]) chunk[k] = t0 + g * span + c;
      }
    }
  }
  int bi[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    bi[k] = 0;
    if (kIndex && chunk[k] >= 0) {
      if (nt <= kTile) {  // the one tile is still staged; its padding ends at G * span
        bi[k] = first_hit([&](int j) { return smem[j]; }, chunk[k], qx[k], qy[k], qz[k],
                          best[k]);
      } else {  // from L2; indices past the end repeat the last point, which comes first
        bi[k] = first_hit(
            [&](int j) {
              const float* s = t + (size_t)min(j, nt - 1) * 3;
              return make_float4(__ldg(s), __ldg(s + 1), __ldg(s + 2), 0.f);
            },
            chunk[k], qx[k], qy[k], qz[k], best[k]);
      }
    }
  }
  // merge the groups: the least distance, then the lowest index
  if (G == 1) {  // the next item's first barrier guards the tile
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const int n = n0 + l + k * kGroupThreads;
      if (n < nq) {
        dout[n] = best[k];
        if (kIndex) iout[n] = bi[k];
      }
    }
    return;
  }
  float* rd = reinterpret_cast<float*>(smem);
  int* ri = reinterpret_cast<int*>(rd + G * kQueries);
  __syncthreads();  // the tile is no longer read
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    rd[g * kQueries + l + k * kGroupThreads] = best[k];
    if (kIndex) ri[g * kQueries + l + k * kGroupThreads] = bi[k];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kQueries && n0 + i < nq; i += kThreads) {
    float d = rd[i];
    int j = kIndex ? ri[i] : 0;
#pragma unroll
    for (int h = 1; h < G; ++h) {
      const float e = rd[h * kQueries + i];
      if (kIndex) {
        const int f = ri[h * kQueries + i];
        if (e < d || (e == d && f < j)) {
          d = e;
          j = f;
        }
      } else {
        d = fminf(d, e);
      }
    }
    dout[n0 + i] = d;
    if (kIndex) iout[n0 + i] = j;
  }
}

template <int Q, int G>
__global__ void __launch_bounds__(kGroupThreads * G) nn_kernel(const float* __restrict__ x,
                                                               const float* __restrict__ y,
                                                               int N, int M,
                                                               float* __restrict__ dist,
                                                               int* __restrict__ idx) {
  __shared__ float4 smem[kTile];
  const size_t b = blockIdx.y;
  nn_block<Q, G, true>(x + b * N * 3, N, y + b * M * 3, M, blockIdx.x * Block<Q, G>::kQueries,
                       dist + b * N, idx + b * N, smem);
}

// Kernel M on a persistent grid. Its warps first write the sentinel rows of inactive pairs,
// one pair a warp (float4 stores where N % 4 == 0). Then every block ranks the active pairs
// itself, with no host sync and no pre-pass: each thread counts the active pairs of its
// contiguous segment of the mask, a block-wide scan gives each segment's first rank, and the
// block takes the active (pair, query block) items blockIdx.x, + gridDim.x, ..., finding an
// item's pair by a binary search over the segments. So the active work spreads evenly over
// the blocks, whichever pairs the mask selects, and no block walks the inactive ones.
template <int Q, int G>
__global__ void __launch_bounds__(kGroupThreads * G) masked_pair_kernel(
    const float* __restrict__ pts, const bool* __restrict__ mask, int B, int P, int N,
    float* __restrict__ out) {
  constexpr int kThreads = kGroupThreads * G, kWarps = kThreads / 32;
  constexpr int kQueries = Block<Q, G>::kQueries;
  __shared__ float4 smem[kTile];
  __shared__ int first[kThreads + 1];  // active pairs before each thread's segment
  __shared__ int warp_total[kWarps];
  const int pairs = B * P * P, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int p = blockIdx.x * kWarps + warp; p < pairs; p += gridDim.x * kWarps) {
    if (mask[p]) continue;
    float* o = out + (size_t)p * N;
    if ((N & 3) == 0) {  // rows start 16-byte aligned (out comes from the allocator)
      const float4 v = make_float4(kInactive, kInactive, kInactive, kInactive);
      for (int i = lane; i < N / 4; i += 32) reinterpret_cast<float4*>(o)[i] = v;
    } else {
      for (int i = lane; i < N; i += 32) o[i] = kInactive;
    }
  }
  const int seg = ceil_div(pairs, kThreads);
  const int s0 = min((int)threadIdx.x * seg, pairs), s1 = min(s0 + seg, pairs);
  int count = 0;
  for (int p = s0; p < s1; ++p) count += mask[p];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {  // inclusive scan over the warp
    const int v = __shfl_up_sync(~0u, count, o);
    if (lane >= o) count += v;
  }
  if (lane == 31) warp_total[warp] = count;
  __syncthreads();
  for (int w = 0; w < warp; ++w) count += warp_total[w];
  first[threadIdx.x + 1] = count;
  if (threadIdx.x == 0) first[0] = 0;
  __syncthreads();
  const int blocks = ceil_div(N, kQueries);
  for (long long a = blockIdx.x; a < (long long)first[kThreads] * blocks; a += gridDim.x) {
    const int r = (int)(a / blocks);
    int t = 0;  // the last segment whose first rank is at most r: it holds the r-th pair
    for (int step = kThreads / 2; step > 0; step /= 2)
      if (first[t + step] <= r) t += step;
    int p = t * seg;
    for (int k = r - first[t];; ++p)
      if (mask[p] && k-- == 0) break;
    const int i = (p / P) % P, j = p % P;
    const float* cloud = pts + (size_t)(p / (P * P)) * P * N * 3;
    nn_block<Q, G, false>(cloud + (size_t)i * N * 3, N, cloud + (size_t)j * N * 3, N,
                          (int)(a % blocks) * kQueries, out + (size_t)p * N, nullptr, smem);
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  return count;
}

template <int Q, int G>
void launch_nn(const float* x, const float* y, int B, int N, int M, float* dist, int* idx,
               cudaStream_t stream) {
  const dim3 grid(ceil_div(N, Block<Q, G>::kQueries), B);
  nn_kernel<Q, G><<<grid, kGroupThreads * G, 0, stream>>>(x, y, N, M, dist, idx);
}

template <int Q, int G>
void launch_masked(const float* pts, const bool* mask, int B, int P, int N, float* out,
                   cudaStream_t stream) {
  const long long items = (long long)B * P * P * ceil_div(N, Block<Q, G>::kQueries);
  const int grid = (int)(items < 2LL * sm_count() ? items : 2LL * sm_count());
  masked_pair_kernel<Q, G><<<grid, kGroupThreads * G, 0, stream>>>(pts, mask, B, P, N, out);
}

}  // namespace

// Kernel N: Q = 2, G = 1 when the targets fit one tile, else Q = 4, G = 2.
PFPP_EXPORT int pfpp_nn_distance(const float* x, const float* y, int B, int N, int M,
                                 float* dist, int* idx, void* stream) {
  if (B == 0 || N == 0) return 0;
  if (M <= kTile)
    launch_nn<2, 1>(x, y, B, N, M, dist, idx, (cudaStream_t)stream);
  else
    launch_nn<4, 2>(x, y, B, N, M, dist, idx, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// Kernel M at Q = 2, G = 4, on a grid of at most two blocks an SM, fewer when there are
// fewer (pair, query block) items.
PFPP_EXPORT int pfpp_masked_pairwise_nn(const float* pts, const bool* mask, int B, int P,
                                        int N, float* out, void* stream) {
  if (B == 0 || P == 0 || N == 0) return 0;
  launch_masked<2, 4>(pts, mask, B, P, N, out, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
