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

#include <climits>

namespace {

constexpr float kBig = 1e10f;

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
