// pfpp_native — host-side native core for puzzlefusion_plusplus_tpu.
//
// The reference ships an in-repo CUDA chamfer extension
// (Jigsaw_matching/utils/chamfer/cuda/chamfer_kernel.cu) and leans on native deps
// (torch_cluster FPS, chamferdist) for its hot geometry. On TPU the device-side equivalents
// are Pallas kernels (ops/chamfer_pallas.py, ops/fps.py); THIS library is the host-side
// runtime counterpart: an OpenMP-parallel chamfer / FPS / batched-augmentation core used by
// the data pipeline (preprocessing at dataset-build time) and as a CPU oracle for kernel
// verification. C ABI, consumed through ctypes (no pybind11 in the image).
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC pfpp_native.cpp -o libpfpp_native.so

#include <cstdint>
#include <cstring>
#include <cmath>
#include <limits>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// For every point in x[b], squared distance to (and index of) its nearest neighbor in y[b].
// x: [B, N, 3], y: [B, M, 3] -> dist: [B, N], idx: [B, N].
// Tiled over y for cache locality (the CPU analogue of the reference CUDA kernel's
// shared-memory tiling, chamfer_kernel.cu:32-94).
void pfpp_nn_distance(const float* x, const float* y, int B, int N, int M,
                      float* dist, int32_t* idx) {
#pragma omp parallel for collapse(2) schedule(static)
  for (int b = 0; b < B; ++b) {
    for (int i = 0; i < N; ++i) {
      const float* xb = x + ((int64_t)b * N + i) * 3;
      const float px = xb[0], py = xb[1], pz = xb[2];
      float best = std::numeric_limits<float>::infinity();
      int32_t best_j = 0;
      const float* yb = y + (int64_t)b * M * 3;
      for (int j = 0; j < M; ++j) {
        const float dx = px - yb[3 * j];
        const float dy = py - yb[3 * j + 1];
        const float dz = pz - yb[3 * j + 2];
        const float d = dx * dx + dy * dy + dz * dz;
        if (d < best) { best = d; best_j = j; }
      }
      dist[(int64_t)b * N + i] = best;
      idx[(int64_t)b * N + i] = best_j;
    }
  }
}

// Deterministic farthest point sampling, first-valid start, lowest-index tie-break —
// bit-identical to ops/fps.py farthest_point_sample_xla.
// xyz: [B, N, 3], mask: [B, N] (0/1) or nullptr, out: [B, npoint].
void pfpp_fps(const float* xyz, const uint8_t* mask, int B, int N, int npoint,
              int32_t* out) {
#pragma omp parallel for schedule(dynamic)
  for (int b = 0; b < B; ++b) {
    const float* pb = xyz + (int64_t)b * N * 3;
    const uint8_t* mb = mask ? mask + (int64_t)b * N : nullptr;
    float* dist = new float[N];
    const float big = 1e10f;
    int32_t cur = 0;
    for (int i = 0; i < N; ++i) {
      const bool valid = !mb || mb[i];
      dist[i] = valid ? big : -big;
    }
    for (int i = 0; i < N; ++i) {
      if (!mb || mb[i]) { cur = i; break; }
    }
    for (int s = 0; s < npoint; ++s) {
      out[(int64_t)b * npoint + s] = cur;
      const float cx = pb[3 * cur], cy = pb[3 * cur + 1], cz = pb[3 * cur + 2];
      float best = -std::numeric_limits<float>::infinity();
      int32_t next = 0;
      for (int i = 0; i < N; ++i) {
        const float dx = pb[3 * i] - cx;
        const float dy = pb[3 * i + 1] - cy;
        const float dz = pb[3 * i + 2] - cz;
        float d = dx * dx + dy * dy + dz * dz;
        if (mb && !mb[i]) d = -big;
        if (d < dist[i]) dist[i] = d;
        if (dist[i] > best) { best = dist[i]; next = i; }
      }
      cur = next;
    }
    delete[] dist;
  }
}

// Batched part augmentation: out[p] = R[p] @ (pc[p] - centroid(pc[p])), then per-part
// max-abs scale capture — the data-loader hot loop (denoiser/dataset/dataset.py:119-129,
// :210-213) for all parts of a batch at once.
// pcs: [P, N, 3], rots: [P, 3, 3] (row-major), out: [P, N, 3], centroids: [P, 3],
// scales: [P].
void pfpp_augment_parts(const float* pcs, const float* rots, int P, int N,
                        float* out, float* centroids, float* scales,
                        int do_normalize) {
#pragma omp parallel for schedule(static)
  for (int p = 0; p < P; ++p) {
    const float* pc = pcs + (int64_t)p * N * 3;
    const float* R = rots + (int64_t)p * 9;
    float cx = 0, cy = 0, cz = 0;
    for (int i = 0; i < N; ++i) {
      cx += pc[3 * i]; cy += pc[3 * i + 1]; cz += pc[3 * i + 2];
    }
    cx /= N; cy /= N; cz /= N;
    centroids[3 * p] = cx; centroids[3 * p + 1] = cy; centroids[3 * p + 2] = cz;
    float maxabs = 0.f;
    float* ob = out + (int64_t)p * N * 3;
    for (int i = 0; i < N; ++i) {
      const float x = pc[3 * i] - cx;
      const float y = pc[3 * i + 1] - cy;
      const float z = pc[3 * i + 2] - cz;
      const float rx = R[0] * x + R[1] * y + R[2] * z;
      const float ry = R[3] * x + R[4] * y + R[5] * z;
      const float rz = R[6] * x + R[7] * y + R[8] * z;
      ob[3 * i] = rx; ob[3 * i + 1] = ry; ob[3 * i + 2] = rz;
      const float a = std::fmax(std::fabs(rx), std::fmax(std::fabs(ry), std::fabs(rz)));
      if (a > maxabs) maxabs = a;
    }
    if (maxabs == 0.f) maxabs = 1.f;
    scales[p] = maxabs;
    if (do_normalize) {
      const float inv = 1.f / maxabs;
      for (int i = 0; i < 3 * N; ++i) ob[i] *= inv;
    }
  }
}

int pfpp_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
