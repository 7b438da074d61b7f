// Kernel G: exact batched point gather, out[b, r, :] = points[b, idx[b, r], :]; kernel A
// launches it too.
//
// Replaces puzzlefusion_plusplus_tpu/ops/gather_pallas.py::gather_points_pallas
// (_gather_kernel) and gather_pallas.py::gather_points_approx (_gather_approx_kernel), whose
// bf16 rounding comes only from the TPU's matrix unit: here both are the same exact load,
// told apart by their wrappers' launch counters. The TPU kernel splits each f32 into four
// byte planes and selects them with one-hot matmuls because its matrix unit rounds f32
// operands to bf16; on Hopper a gather is a load. Bound: bytes moved (the source read once,
// each output element stored once). One thread per output element, grid-stride, 64-bit
// offsets; neighbouring threads write neighbouring channels, so stores are coalesced and
// loads are coalesced within a row.
#include "common.cuh"

__global__ void gather_kernel(const float* __restrict__ points, const int* __restrict__ idx,
                              float* __restrict__ out, long long N, long long R, long long C,
                              long long total) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const long long c = e % C;
    const long long br = e / C;  // flat (b, r)
    const long long b = br / R;
    out[e] = points[(b * N + idx[br]) * C + c];
  }
}

PFPP_EXPORT int pfpp_gather(const float* points, const int* idx, float* out, long long B,
                            long long N, long long R, long long C, void* stream) {
  const long long total = B * R * C;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  gather_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(points, idx, out, N,
                                                                        R, C, total);
  return (int)cudaGetLastError();
}

PFPP_EXPORT const char* pfpp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
