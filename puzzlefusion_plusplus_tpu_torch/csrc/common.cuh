// Shared declarations of the port's CUDA kernels.
//
// Every source in this directory is compiled on its own by nvcc for sm_90a into a shared
// library with a plain C interface (ops/cuda_build.py) and called through ctypes. Each
// exported function launches on the stream it is given, allocates nothing, and returns the
// cudaGetLastError() code of its launch (0 on success) for the Python wrapper to raise on.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#define PFPP_EXPORT extern "C" __attribute__((visibility("default")))

// Squared distance with every operation rounded on its own, in the order of the plain
// PyTorch version ((dx*dx + dy*dy) + dz*dz): no FMA contraction, so the kernel's distances
// are bit-identical to the plain version's and argmin/argmax indices agree exactly.
__device__ __forceinline__ float sq_dist3(float ax, float ay, float az,
                                          float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}
