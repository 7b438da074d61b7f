// Kernel F: masked farthest-point sampling, xyz [B, N, 3] (+ mask [B, N]) -> idx [B, npoint].
//
// Replaces puzzlefusion_plusplus_tpu/ops/fps.py::_fps_pallas_batched (_fps_batched_kernel).
// Semantics: start at the first valid point (0 if none), then npoint greedy max-min
// selections; ties go to the lowest index; invalid points never win (their running distance
// is pinned at -1e10, and min(-1e10, d >= 0) keeps it there, so the mask is read once).
//
// Bound: latency. The npoint selections are sequential and each ends in a block-wide
// (value, index) argmax, so the design is one block per cloud with the running
// min-distance in shared memory (N floats: 80 KB at the merge resample's 20000 points,
// which is why xyz is not staged too — 240 KB more would not fit one SM's 227 KB) and
// the coordinates read from global memory, where they stay L2-resident across selections.
// Distances go through sq_dist3 (no FMA), so indices equal the plain version's exactly.
#include "common.cuh"

#include <cooperative_groups.h>

#include <climits>

namespace {

constexpr float kBig = 1e10f;
constexpr int kSliceTarget = 2560;  // P: points per block the cluster size aims for (40 KB)
constexpr int kSliceMax = 12288;    // P: points per block at most (192 KB of shared memory)

__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void fps_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ mask,
                           int N, int npoint, int* __restrict__ out) {
  extern __shared__ float dist[];  // [N] running min distance
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int sel;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* p = xyz + (size_t)b * N * 3;
  const uint8_t* mk = mask ? mask + (size_t)b * N : nullptr;

  int first = INT_MAX;  // first valid point of the cloud
  for (int n = tid; n < N; n += blockDim.x) {
    const bool valid = mk == nullptr || mk[n] != 0;
    dist[n] = valid ? kBig : -kBig;
    if (valid && n < first) first = n;
  }
  for (int off = 16; off > 0; off >>= 1) first = min(first, __shfl_down_sync(~0u, first, off));
  if (lane == 0) red_i[warp] = first;
  __syncthreads();
  if (warp == 0) {
    int v = lane < nwarps ? red_i[lane] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_down_sync(~0u, v, off));
    if (lane == 0) sel = v == INT_MAX ? 0 : v;
  }
  __syncthreads();
  int farthest = sel;

  for (int i = 0; i < npoint; ++i) {
    if (tid == 0) out[(size_t)b * npoint + i] = farthest;
    const float cx = p[farthest * 3 + 0], cy = p[farthest * 3 + 1], cz = p[farthest * 3 + 2];
    float best = -INFINITY;
    int bi = INT_MAX;
    for (int n = tid; n < N; n += blockDim.x) {  // ascending n: strict > keeps the lowest
      const float d = sq_dist3(p[n * 3 + 0], p[n * 3 + 1], p[n * 3 + 2], cx, cy, cz);
      const float nd = fminf(dist[n], d);
      dist[n] = nd;
      if (nd > best) {
        best = nd;
        bi = n;
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      argmax_merge(best, bi, __shfl_down_sync(~0u, best, off), __shfl_down_sync(~0u, bi, off));
    if (lane == 0) {
      red_v[warp] = best;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      float v = lane < nwarps ? red_v[lane] : -INFINITY;
      int vi = lane < nwarps ? red_i[lane] : INT_MAX;
      for (int off = 16; off > 0; off >>= 1)
        argmax_merge(v, vi, __shfl_down_sync(~0u, v, off), __shfl_down_sync(~0u, vi, off));
      if (lane == 0) sel = vi;
    }
    __syncthreads();
    farthest = sel;
  }
}

// Kernel P: the same function with each cloud resident on chip, for few clouds of many
// points (the merge resample: B*K clouds of up to P*1000 = 20000 points -> 1000).
//
// Replaces puzzlefusion_plusplus_tpu/ops/fps.py::farthest_point_sample_pallas (_fps_kernel),
// which keeps a whole cloud and its running distance in VMEM across all selections. One
// Hopper block cannot: 20000 points x 16 B is 320 KB. So a thread block cluster of CL <= 8
// blocks (the portable size) takes one cloud, each block holding a contiguous slice of its
// coordinates and running distance in its own shared memory (2500 points x 16 B = 40 KB at
// N = 20000), and nothing is read from device memory after the first load. Each selection
// is a block argmax, one cluster barrier, and a cluster argmax in which warp 0 of every
// block reads the CL block winners through distributed shared memory; the winner's
// coordinates are read from its owner block the same way. The winners sit in a buffer of
// two slots that alternate with the selection, so one cluster barrier per selection keeps a
// slot from being rewritten while another block still reads it. Bound: latency of npoint
// dependent cluster-wide reductions. Semantics and arithmetic are F's, so the indices are.
__global__ void fps_cluster_kernel(const float* __restrict__ xyz,
                                   const uint8_t* __restrict__ mask, int N, int slice,
                                   int npoint, int* __restrict__ out) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / CL;
  extern __shared__ float sm[];
  float* xs = sm;  // [slice] each: this block's coordinates and running distance
  float* ys = xs + slice;
  float* zs = ys + slice;
  float* dist = zs + slice;
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ float win_v[2];  // this block's winner, by selection parity
  __shared__ int win_i[2];
  __shared__ int first_i;     // this block's first valid point
  __shared__ float sel_xyz[3];
  __shared__ int sel;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int base = rank * slice;
  const int cnt = max(0, min(slice, N - base));
  const float* p = xyz + (size_t)b * N * 3;
  const uint8_t* mk = mask ? mask + (size_t)b * N : nullptr;

  int first = INT_MAX;
  for (int j = tid; j < cnt; j += blockDim.x) {
    const int n = base + j;
    xs[j] = p[n * 3 + 0];
    ys[j] = p[n * 3 + 1];
    zs[j] = p[n * 3 + 2];
    const bool valid = mk == nullptr || mk[n] != 0;
    dist[j] = valid ? kBig : -kBig;
    if (valid && n < first) first = n;
  }
  for (int off = 16; off > 0; off >>= 1) first = min(first, __shfl_down_sync(~0u, first, off));
  if (lane == 0) red_i[warp] = first;
  __syncthreads();
  if (warp == 0) {
    int v = lane < nwarps ? red_i[lane] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_down_sync(~0u, v, off));
    if (lane == 0) first_i = v;
  }
  cluster.sync();  // every block's first valid point and coordinates are in place

  // warp 0: the cluster-wide choice -> sel and its coordinates, from the owner block
  auto choose = [&](int chosen) {
    if (lane == 0) {
      const int owner = chosen / slice, j = chosen - owner * slice;
      sel = chosen;
      sel_xyz[0] = *cluster.map_shared_rank(xs + j, owner);
      sel_xyz[1] = *cluster.map_shared_rank(ys + j, owner);
      sel_xyz[2] = *cluster.map_shared_rank(zs + j, owner);
    }
  };
  if (warp == 0) {
    int v = lane < CL ? *cluster.map_shared_rank(&first_i, lane) : INT_MAX;
    for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_down_sync(~0u, v, off));
    const int f = __shfl_sync(~0u, v, 0);
    choose(f == INT_MAX ? 0 : f);
  }
  __syncthreads();

  for (int i = 0; i < npoint; ++i) {
    const int farthest = sel;
    const float cx = sel_xyz[0], cy = sel_xyz[1], cz = sel_xyz[2];
    if (rank == 0 && tid == 0) out[(size_t)b * npoint + i] = farthest;
    float best = -INFINITY;
    int bi = INT_MAX;
    for (int j = tid; j < cnt; j += blockDim.x) {  // ascending n: strict > keeps the lowest
      const float d = sq_dist3(xs[j], ys[j], zs[j], cx, cy, cz);
      const float nd = fminf(dist[j], d);
      dist[j] = nd;
      if (nd > best) {
        best = nd;
        bi = base + j;
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      argmax_merge(best, bi, __shfl_down_sync(~0u, best, off), __shfl_down_sync(~0u, bi, off));
    if (lane == 0) {
      red_v[warp] = best;
      red_i[warp] = bi;
    }
    __syncthreads();
    const int slot = i & 1;
    if (warp == 0) {
      float v = lane < nwarps ? red_v[lane] : -INFINITY;
      int vi = lane < nwarps ? red_i[lane] : INT_MAX;
      for (int off = 16; off > 0; off >>= 1)
        argmax_merge(v, vi, __shfl_down_sync(~0u, v, off), __shfl_down_sync(~0u, vi, off));
      if (lane == 0) {
        win_v[slot] = v;
        win_i[slot] = vi;
      }
    }
    cluster.sync();  // every block's winner of selection i is in place
    if (warp == 0) {
      float v = lane < CL ? *cluster.map_shared_rank(&win_v[slot], lane) : -INFINITY;
      int vi = lane < CL ? *cluster.map_shared_rank(&win_i[slot], lane) : INT_MAX;
      for (int off = 16; off > 0; off >>= 1)
        argmax_merge(v, vi, __shfl_down_sync(~0u, v, off), __shfl_down_sync(~0u, vi, off));
      choose(__shfl_sync(~0u, vi, 0));
    }
    __syncthreads();
  }
  cluster.sync();  // no block leaves while another may still read its shared memory
}

}  // namespace

PFPP_EXPORT int pfpp_fps(const float* xyz, const uint8_t* mask, int B, int N, int npoint,
                         int* out, void* stream) {
  if (B == 0 || npoint == 0) return 0;
  const int threads = N <= 2048 ? 256 : 1024;
  const size_t smem = (size_t)N * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  fps_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(xyz, mask, N, npoint, out);
  return (int)cudaGetLastError();
}

// Kernel P: clusters of 1, 2, 4 or 8 blocks, the fewest whose slices hold kSliceTarget
// points; returns cudaErrorInvalidValue when N > 8 * kSliceMax (the wrapper checks first).
PFPP_EXPORT int pfpp_fps_cluster(const float* xyz, const uint8_t* mask, int B, int N,
                                 int npoint, int* out, void* stream) {
  if (B == 0 || npoint == 0) return 0;
  int cl = 1;
  while (cl < 8 && (N + cl - 1) / cl > kSliceTarget) cl *= 2;
  const int slice = (N + cl - 1) / cl;
  if (slice > kSliceMax) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)4 * slice * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fps_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cl);
  cfg.blockDim = dim3(slice > 4096 ? 512 : 256);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fps_cluster_kernel, xyz, mask, N, slice, npoint, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
