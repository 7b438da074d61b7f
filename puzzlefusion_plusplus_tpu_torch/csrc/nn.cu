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
// Here the distance is three differences on the CUDA cores (sq_dist3), bit-identical to the
// plain PyTorch version. Bound: FP32 operations (8 per pair). One thread per query point;
// target points are staged through shared memory in tiles and scanned in ascending order
// with a strict <, so ties resolve to the lowest index. The ragged edge is masked, which
// replaces the TPU wrapper's 1e6 padding. Blocks of inactive pairs write the sentinel and
// return before touching the clouds; compacting the active pairs is later work.
#include "common.cuh"

namespace {

constexpr int kQ = 256;  // queries (threads) per block
constexpr int kT = 512;  // target points per shared-memory tile
constexpr float kInactive = 3.9e12f;

template <bool kIndex>
__device__ __forceinline__ void nn_rows(const float* __restrict__ q, int nq,
                                        const float* __restrict__ t, int nt,
                                        float* __restrict__ dout, int* __restrict__ iout) {
  __shared__ float sx[kT], sy[kT], sz[kT];
  const int n = blockIdx.x * kQ + threadIdx.x;
  const bool active = n < nq;
  const float qx = active ? q[n * 3 + 0] : 0.f;
  const float qy = active ? q[n * 3 + 1] : 0.f;
  const float qz = active ? q[n * 3 + 2] : 0.f;
  float best = INFINITY;
  int bi = 0;
  for (int t0 = 0; t0 < nt; t0 += kT) {
    const int cnt = min(kT, nt - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += kQ) {
      sx[j] = t[(size_t)(t0 + j) * 3 + 0];
      sy[j] = t[(size_t)(t0 + j) * 3 + 1];
      sz[j] = t[(size_t)(t0 + j) * 3 + 2];
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float d = sq_dist3(qx, qy, qz, sx[j], sy[j], sz[j]);
      if (d < best) {
        best = d;
        bi = t0 + j;
      }
    }
  }
  if (active) {
    dout[n] = best;
    if (kIndex) iout[n] = bi;
  }
}

__global__ void __launch_bounds__(kQ) nn_kernel(const float* __restrict__ x,
                                                const float* __restrict__ y, int N, int M,
                                                float* __restrict__ dist,
                                                int* __restrict__ idx) {
  const size_t b = blockIdx.y;
  nn_rows<true>(x + b * N * 3, N, y + b * M * 3, M, dist + b * N, idx + b * N);
}

__global__ void __launch_bounds__(kQ) masked_pair_kernel(const float* __restrict__ pts,
                                                         const uint8_t* __restrict__ mask,
                                                         int P, int N,
                                                         float* __restrict__ out) {
  const size_t b = blockIdx.z;
  const int i = blockIdx.y / P, j = blockIdx.y % P;
  float* o = out + ((b * P + i) * P + j) * N;
  if (mask[(b * P + i) * P + j] == 0) {  // uniform per block: no barrier is skipped unevenly
    const int n = blockIdx.x * kQ + threadIdx.x;
    if (n < N) o[n] = kInactive;
    return;
  }
  const float* cloud = pts + b * P * N * 3;
  nn_rows<false>(cloud + (size_t)i * N * 3, N, cloud + (size_t)j * N * 3, N, o, nullptr);
}

}  // namespace

PFPP_EXPORT int pfpp_nn_distance(const float* x, const float* y, int B, int N, int M,
                                 float* dist, int* idx, void* stream) {
  if (B == 0 || N == 0) return 0;
  const dim3 grid((N + kQ - 1) / kQ, B);
  nn_kernel<<<grid, kQ, 0, (cudaStream_t)stream>>>(x, y, N, M, dist, idx);
  return (int)cudaGetLastError();
}

PFPP_EXPORT int pfpp_masked_pairwise_nn(const float* pts, const uint8_t* mask, int B, int P,
                                        int N, float* out, void* stream) {
  if (B == 0 || P == 0 || N == 0) return 0;
  const dim3 grid((N + kQ - 1) / kQ, P * P, B);
  masked_pair_kernel<<<grid, kQ, 0, (cudaStream_t)stream>>>(pts, mask, P, N, out);
  return (int)cudaGetLastError();
}
