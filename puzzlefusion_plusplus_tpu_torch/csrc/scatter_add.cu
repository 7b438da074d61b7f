// Kernel B: batched scatter-add, dpoints[b, n, :] = sum over r with idx[b, r] == n of
// g[b, r, :]; rows no index hits stay zero. It is the backward of the point gathers (G and
// A) and the target-side gradient of the chamfer loss.
//
// Replaces puzzlefusion_plusplus_tpu/ops/gather_pallas.py::_gather_bwd_pallas
// (_scatter_add_kernel). The TPU kernel walks the rows in grid order and accumulates into an
// output block that stays resident across that sequential grid dimension; CUDA blocks run in
// parallel and in no order, so that carry has no counterpart here. Instead each block owns
// one cloud and a tile of TC channels outright: thread c keeps the column
// acc[0..N-1][c] of one cloud in shared memory, adds the rows g[b, r, c] in ascending r, then
// writes the column out. No two threads touch one accumulator, so there are no atomics and
// no barriers, and the sum is taken in row order: the result is deterministic and equals a
// sequential index_add_ over the rows in order (the CPU plain version) bit for bit.
//
// Bound: bytes. Every g element is read once (B*R*C*4 bytes, 671 MB for the SA2 backward at
// M = 160) against B*N*C*4 written. The row loop reads idx[b, r] as a warp-wide broadcast
// and g[b, r, c0 + c] as one coalesced segment per warp; rows are fetched kUnroll at a time
// into registers before their shared-memory adds so that global loads stay in flight. The
// price of determinism is parallelism: a block's threads walk all R rows, so a cloud runs on
// C / TC warps, and small C leaves lanes idle (the chamfer gradient has C = 3).
#include "common.cuh"

namespace {

constexpr int kUnroll = 8;
constexpr int kMaxSmem = 232448;  // 227 KB opt-in limit of one block on sm_90

__global__ void scatter_add_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                                   float* __restrict__ out, int N, long long R, int C,
                                   int TC) {
  extern __shared__ float acc[];  // [N][TC]
  const int b = blockIdx.y;
  const int c = threadIdx.x;
  const int cg = blockIdx.x * TC + c;  // global channel
  if (cg >= C) return;  // no barrier follows, so idle lanes may leave
  for (int n = 0; n < N; ++n) acc[n * TC + c] = 0.f;
  const int* ib = idx + (long long)b * R;
  const float* gb = g + (long long)b * R * C + cg;
  long long r = 0;
  for (; r + kUnroll <= R; r += kUnroll) {
    int ii[kUnroll];
    float vv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ii[u] = ib[r + u];
      vv[u] = gb[(r + u) * C];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc[ii[u] * TC + c] += vv[u];
  }
  for (; r < R; ++r) acc[ib[r] * TC + c] += gb[r * C];
  float* ob = out + (long long)b * N * C + cg;
  for (int n = 0; n < N; ++n) ob[(long long)n * C] = acc[n * TC + c];
}

}  // namespace

// Channel-tile width: a warp's 32 channels where C allows, halved until one cloud's
// [N][TC] accumulator fits the block's shared memory. 0 when not even TC = 1 fits.
PFPP_EXPORT int pfpp_scatter_add_tile(int N, int C) {
  int tc = C < 32 ? C : 32;
  while (tc > 0 && (long long)N * tc * 4 > kMaxSmem) tc /= 2;
  return tc;
}

PFPP_EXPORT int pfpp_scatter_add(const float* g, const int* idx, float* out, int B, int N,
                                 long long R, int C, void* stream) {
  if (B == 0 || N == 0 || C == 0) return 0;
  const int tc = pfpp_scatter_add_tile(N, C);
  if (tc == 0) return (int)cudaErrorInvalidValue;
  const int smem = N * tc * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        scatter_add_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((C + tc - 1) / tc, B);
  scatter_add_kernel<<<grid, tc, smem, (cudaStream_t)stream>>>(g, idx, out, N, R, C, tc);
  return (int)cudaGetLastError();
}
