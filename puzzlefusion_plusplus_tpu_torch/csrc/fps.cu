// Kernels F and P: masked farthest-point sampling, xyz [B, N, 3] (+ mask [B, N]) -> idx [B, npoint].
//
// F replaces puzzlefusion_plusplus_tpu/ops/fps.py::_fps_pallas_batched (_fps_batched_kernel):
// one block per cloud, for many clouds of up to a few thousand points (the encoder's stages).
// P replaces ops/fps.py::farthest_point_sample_pallas (_fps_kernel), which keeps a whole cloud
// in VMEM across all selections: a thread block cluster of CL <= 8 blocks per cloud (the
// portable size), block r holding the contiguous slice [r * slice, (r + 1) * slice), for few
// clouds of many points (the engine's merge resample). P with CL = 1 is F's design. Both
// compute one function: start at the first valid point (0 if none), then npoint greedy
// max-min selections; ties go to the lowest index; invalid points never win (their running
// distance is pinned at -1e10, and min(-1e10, d >= 0) keeps it there, so the mask is read
// once). Distances go through sq_dist3 (no FMA), so indices equal the plain version's exactly.
//
// Bound: latency. The selections are sequential and each is an argmax over the cloud, so the
// time is npoint times the latency of one selection; the bytes (the cloud, read once) and
// the operations (9 a point a selection) are far below it. The design keeps what a selection
// needs on chip and cuts its critical path to one exchange:
// * Points in registers. Thread t owns the points base + t + k * T, k < PPT (a template
//   parameter, 1 to 16), and keeps their coordinates and running distance in registers from
//   the one read of device memory to the end. No global or distributed-shared load is left in
//   the selection loop. A thread's argmax over its points is a pairwise tree (adjacent pairs,
//   so the lower index wins ties), not a serial chain. PPT = 0 is the streaming variant for
//   slices of more than 8192 points (512 threads x 16), which no engine or training path
//   gives F: the running distance lives in shared memory and the coordinates are read from L2
//   on every selection.
// * One 64-bit key per candidate: orderable(dist) << 32 | (0xFFFFFFFF - index), where
//   orderable is the total-order map of a float onto an unsigned int, so an unsigned max is
//   the argmax with ties to the lowest index. A valid point at distance 0 stays above an
//   invalid one at -1e10, a slot without a point (distance -inf) below both, and an
//   all-invalid cloud ties at -1e10 and returns index 0 throughout. Candidates of one warp
//   have distinct indices, so keys are distinct. A warp reduces them with two redux.sync:
//   max of the high word, then max of the low word among the lanes that hold it.
// * One exchange per selection. The lane holding its warp's winning key writes a record (key,
//   x, y, z) into slot [parity][warp]. In F one bar.sync follows; in P the lane pushes the
//   record into that slot of every block of the cluster with st.async, whose bytes complete
//   the receiving block's mbarrier of that parity, and every thread waits on its own block's
//   mbarrier: no cluster-wide barrier and no load of a peer's memory is left in the loop. Then
//   every warp reduces all records itself (each lane reads them all when there are at most
//   four, else one each and two redux.sync) and takes the winner's coordinates from the
//   winning record, so no broadcast or second barrier follows. The two parity slots make this
//   safe: a slot is rewritten two selections later, after its writer has seen every record
//   of the selection between, which every warp of the cluster sends only after its last read
//   of the slot.
#include "common.cuh"

#include <cooperative_groups.h>

namespace {

namespace cg = cooperative_groups;
typedef unsigned long long u64;

constexpr float kBig = 1e10f;
constexpr int kRegMaxThreads = 512;  // register tiers: at most 128 registers a thread
constexpr int kStreamMaxThreads = 1024;
constexpr int kAllLanesRecords = 4;  // records each lane reads whole; above, one a lane
constexpr int kRecordBytes = 24;     // a record's bytes pushed into a peer: key + x, y, z, 0

__device__ __forceinline__ unsigned orderable(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ u64 make_key(float dist, unsigned idx) {
  return (u64)orderable(dist) << 32 | (u64)~idx;
}

// The warp's largest key, in every lane: max of the high word, then of the low word among the
// lanes holding that high word.
__device__ __forceinline__ u64 warp_max(u64 key) {
  const unsigned hi = (unsigned)(key >> 32);
  const unsigned mh = __reduce_max_sync(~0u, hi);
  const unsigned ml = __reduce_max_sync(~0u, hi == mh ? (unsigned)key : 0u);
  return (u64)mh << 32 | ml;
}

// Every thread of the cluster; the warp is converged first, as the .aligned form requires.
__device__ __forceinline__ void cluster_barrier() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The address of the same shared variable in block `rank` of the cluster.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Wait for the phase of the mbarrier at `bar` with parity `phase` to complete. A phase that
// does not complete within about a second of tries traps: a launch error, not a hung card.
__device__ __forceinline__ void mbarrier_wait(uint32_t bar, uint32_t phase) {
  uint32_t done = 0;
  for (int tries = 0; !done; ++tries) {
    if (tries == (1 << 20)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(phase) : "memory");
  }
}

template <int PPT, bool CLUSTER>
__device__ __forceinline__ void fps_body(const float* __restrict__ xyz,
                                         const uint8_t* __restrict__ mask, int N, int slice,
                                         int npoint, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int CL = 1, rank = 0;
  if constexpr (CLUSTER) {
    CL = (int)cg::this_cluster().num_blocks();
    rank = (int)cg::this_cluster().block_rank();
  }
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = T >> 5, nrec = CL * nwarps;
  u64* const keys = reinterpret_cast<u64*>(smem);                         // [2][nrec]
  float4* const coords = reinterpret_cast<float4*>(keys + 2 * nrec);       // [2][nrec]
  u64* const bars = reinterpret_cast<u64*>(coords + 2 * nrec);             // [2], P only
  float* const dist_s = reinterpret_cast<float*>(bars + (CLUSTER ? 2 : 0));  // PPT = 0: [slice]
  const int b = blockIdx.x / CL;
  const int base = rank * slice;
  const int cnt = max(0, min(slice, N - base));
  const float* __restrict__ p = xyz + (size_t)b * N * 3;
  const uint8_t* __restrict__ mk = mask ? mask + (size_t)b * N : nullptr;

  // Selection s: this thread's candidate `key` at (x, y, z) -> the cloud's largest key, its
  // point's coordinates in (cx, cy, cz); every thread of the cluster gets the same.
  float cx, cy, cz;
  auto select = [&](u64 key, float x, float y, float z, int s) -> u64 {
    const int par = s & 1;
    u64* const kp = keys + par * nrec;
    float4* const cp = coords + par * nrec;
    const u64 wk = warp_max(key);
    if constexpr (CLUSTER) {
      const uint32_t bar = smem_addr(bars + par);
      if (tid == 0) {  // this phase completes once every record of the cluster has landed
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     ::"r"(bar), "r"(nrec * kRecordBytes) : "memory");
      }
      if (key == wk) {  // exactly one lane: the keys of a warp are distinct
        const int slot = rank * nwarps + warp;
        const uint32_t ka = smem_addr(kp + slot), ca = smem_addr(cp + slot);
        for (int q = 0; q < CL; ++q) {
          const uint32_t pb = peer_addr(bar, q);
          asm volatile(
              "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];\n"
              ::"r"(peer_addr(ka, q)), "l"(wk), "r"(pb) : "memory");
          asm volatile(
              "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
              "{%1, %2, %3, %4}, [%5];\n"
              ::"r"(peer_addr(ca, q)), "r"(__float_as_uint(x)), "r"(__float_as_uint(y)),
              "r"(__float_as_uint(z)), "r"(0u), "r"(pb) : "memory");
        }
      }
      mbarrier_wait(bar, (uint32_t)(s >> 1) & 1u);
    } else {
      if (key == wk) {
        kp[warp] = wk;
        cp[warp] = make_float4(x, y, z, 0.f);
      }
      __syncthreads();
    }
    u64 best = 0;
    int bw = 0;
    if (nrec <= kAllLanesRecords) {
      for (int w = 0; w < nrec; ++w) {
        const u64 v = kp[w];
        if (v > best) {
          best = v;
          bw = w;
        }
      }
    } else {
      for (int w = lane; w < nrec; w += 32) {
        const u64 v = kp[w];
        if (v > best) {
          best = v;
          bw = w;
        }
      }
      const u64 m = warp_max(best);
      bw = __shfl_sync(~0u, bw, __ffs(__ballot_sync(~0u, best == m)) - 1);
      best = m;
    }
    const float4 c = cp[bw];
    cx = c.x;
    cy = c.y;
    cz = c.z;
    return best;
  };

  // The first selection's key: high word 2 for a valid point, 1 for an invalid one, 0 for no
  // point, so the lowest valid index wins, or index 0 when the cloud has no valid point.
  constexpr int R = PPT > 0 ? PPT : 1;
  float px[R], py[R], pz[R], pd[R];
  u64 key = 0;
  float wx = 0.f, wy = 0.f, wz = 0.f;
  if constexpr (PPT > 0) {
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int j = tid + k * T, n = base + j;
      const bool real = j < cnt;
      const bool valid = real && (mk == nullptr || mk[n] != 0);
      px[k] = real ? p[n * 3 + 0] : 0.f;
      py[k] = real ? p[n * 3 + 1] : 0.f;
      pz[k] = real ? p[n * 3 + 2] : 0.f;
      pd[k] = real ? (valid ? kBig : -kBig) : -INFINITY;  // -inf: never beats a point
      const u64 kk = (u64)(real ? (valid ? 2u : 1u) : 0u) << 32 | (u64)~(unsigned)n;
      if (kk > key) {
        key = kk;
        wx = px[k];
        wy = py[k];
        wz = pz[k];
      }
    }
  } else {
    key = (u64)~(unsigned)(base + tid);  // no point: distinct from the other lanes' keys
    for (int j = tid; j < cnt; j += T) {
      const int n = base + j;
      const bool valid = mk == nullptr || mk[n] != 0;
      dist_s[j] = valid ? kBig : -kBig;
      const u64 kk = (u64)(valid ? 2u : 1u) << 32 | (u64)~(unsigned)n;
      if (kk > key) {
        key = kk;
        wx = p[n * 3 + 0];
        wy = p[n * 3 + 1];
        wz = p[n * 3 + 2];
      }
    }
  }
  if constexpr (CLUSTER) {
    if (tid == 0) {
      for (int q = 0; q < 2; ++q)  // one arrival a phase: thread 0's expect_tx
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bars + q)),
                     "r"(1));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster_barrier();  // every block runs, its mbarriers ready, before the first push
  }

  u64 win = select(key, wx, wy, wz, 0);
  for (int i = 0;; ++i) {
    if (rank == 0 && tid == 0) out[(size_t)b * npoint + i] = (int)~(unsigned)win;
    if (i + 1 == npoint) break;
    if constexpr (PPT > 0) {
      float v[PPT], X[PPT], Y[PPT], Z[PPT];
      int kk[PPT];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        pd[k] = fminf(pd[k], sq_dist3(px[k], py[k], pz[k], cx, cy, cz));
        v[k] = pd[k];
        X[k] = px[k];
        Y[k] = py[k];
        Z[k] = pz[k];
        kk[k] = k;
      }
#pragma unroll
      for (int w = 1; w < PPT; w *= 2) {  // adjacent pairs: the left one has the lower index
#pragma unroll
        for (int k = 0; k + w < PPT; k += 2 * w) {
          if (v[k + w] > v[k]) {
            v[k] = v[k + w];
            kk[k] = kk[k + w];
            X[k] = X[k + w];
            Y[k] = Y[k + w];
            Z[k] = Z[k + w];
          }
        }
      }
      key = make_key(v[0], (unsigned)(base + tid + kk[0] * T));
      win = select(key, X[0], Y[0], Z[0], i + 1);
    } else {
      float best = -INFINITY;  // ascending index: strict > keeps the lowest
      unsigned bi = (unsigned)(base + tid);
      for (int j = tid; j < cnt; j += T) {
        const int n = base + j;
        const float x = p[n * 3 + 0], y = p[n * 3 + 1], z = p[n * 3 + 2];
        const float nd = fminf(dist_s[j], sq_dist3(x, y, z, cx, cy, cz));
        dist_s[j] = nd;
        if (nd > best) {
          best = nd;
          bi = (unsigned)n;
          wx = x;
          wy = y;
          wz = z;
        }
      }
      win = select(make_key(best, bi), wx, wy, wz, i + 1);
    }
  }
  if constexpr (CLUSTER) cluster_barrier();  // no block leaves while a peer may write into it
}

// F: one block per cloud. A kernel of its own name, so that profiles tell F from P.
template <int PPT>
__global__ void __launch_bounds__(PPT > 0 ? kRegMaxThreads : kStreamMaxThreads)
fps_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ mask, int N, int npoint,
           int* __restrict__ out) {
  fps_body<PPT, false>(xyz, mask, N, N, npoint, out);
}

// P: one cluster of CL blocks per cloud (CLUSTER = false: CL = 1, F's design under P's name).
template <int PPT, bool CLUSTER>
__global__ void __launch_bounds__(PPT > 0 ? kRegMaxThreads : kStreamMaxThreads)
fps_cluster_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ mask, int N,
                   int slice, int npoint, int* __restrict__ out) {
  fps_body<PPT, CLUSTER>(xyz, mask, N, slice, npoint, out);
}

template <int PPT>
int launch(const float* xyz, const uint8_t* mask, int B, int N, int npoint, int* out, int cl,
           int threads, bool as_p, cudaStream_t stream) {
  const int slice = (N + cl - 1) / cl;
  const size_t smem = (sizeof(u64) + sizeof(float4)) * 2 * cl * (threads / 32) +
                      (cl > 1 ? 2 * sizeof(u64) : 0) + (PPT == 0 ? sizeof(float) * slice : 0);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cl);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cl > 1 ? 1 : 0;
  cudaError_t err;
  if (!as_p) {
    err = cudaFuncSetAttribute(fps_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, fps_kernel<PPT>, xyz, mask, N,
                                                     npoint, out);
  } else {
    auto kernel = cl > 1 ? &fps_cluster_kernel<PPT, true> : &fps_cluster_kernel<PPT, false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, xyz, mask, N, slice, npoint,
                                                     out);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int dispatch(const float* xyz, const uint8_t* mask, int B, int N, int npoint, int* out, int cl,
             int ppt, int threads, bool as_p, void* stream) {
  if (B == 0 || npoint == 0) return 0;
  const int slice = N > 0 && cl > 0 ? (N + cl - 1) / cl : 0;
  const bool shape_ok =
      N > 0 && (cl == 1 || cl == 2 || cl == 4 || cl == 8) && threads >= 32 &&
      threads % 32 == 0 && threads <= (ppt > 0 ? kRegMaxThreads : kStreamMaxThreads) &&
      (ppt == 0 || (long long)threads * ppt >= slice);
  if (!shape_ok) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ppt) {
    case 0: return launch<0>(xyz, mask, B, N, npoint, out, cl, threads, as_p, s);
    case 1: return launch<1>(xyz, mask, B, N, npoint, out, cl, threads, as_p, s);
    case 2: return launch<2>(xyz, mask, B, N, npoint, out, cl, threads, as_p, s);
    case 4: return launch<4>(xyz, mask, B, N, npoint, out, cl, threads, as_p, s);
    case 8: return launch<8>(xyz, mask, B, N, npoint, out, cl, threads, as_p, s);
    case 16: return launch<16>(xyz, mask, B, N, npoint, out, cl, threads, as_p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Kernel F: one block of `threads` threads per cloud, `ppt` points a thread in registers (1, 2,
// 4, 8 or 16, threads * ppt >= N, threads <= 512) or 0 for the streaming variant (threads <=
// 1024). ops/fps.py::block_shape picks them; a shape outside these returns
// cudaErrorInvalidValue.
PFPP_EXPORT int pfpp_fps(const float* xyz, const uint8_t* mask, int B, int N, int npoint,
                         int ppt, int threads, int* out, void* stream) {
  return dispatch(xyz, mask, B, N, npoint, out, 1, ppt, threads, false, stream);
}

// Kernel P: clusters of cl = 1, 2, 4 or 8 blocks per cloud, each block's slice of
// ceil(N / cl) points held as F holds its cloud (ops/fps.py::cluster_shape picks the shape).
PFPP_EXPORT int pfpp_fps_cluster(const float* xyz, const uint8_t* mask, int B, int N,
                                 int npoint, int cl, int ppt, int threads, int* out,
                                 void* stream) {
  return dispatch(xyz, mask, B, N, npoint, out, cl, ppt, threads, true, stream);
}
