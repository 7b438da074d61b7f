// Kernel B: batched scatter-add, dpoints[b, n, :] = sum over r with idx[b, r] == n of
// g[b, r, :]; rows no index hits stay zero. It is the backward of the point gathers (G and
// A) and the target-side gradient of the chamfer loss.
//
// Replaces puzzlefusion_plusplus_tpu/ops/gather_pallas.py::_gather_bwd_pallas
// (_scatter_add_kernel). The TPU kernel walks the rows in grid order and accumulates into an
// output block that stays resident across that sequential grid dimension; CUDA blocks run in
// parallel and in no order, so that carry has no counterpart here.
//
// Bound: bytes. Every g element is read once (B*R*C*4 bytes, 671 MB for the SA2 backward at
// M = 160) against B*N*C*4 written. The sum must be deterministic without float atomics and
// equal to a sequential index_add_ over the rows in order (the CPU plain version) bit for
// bit, so each output is added in ascending r; the design spreads that over outputs rather
// than channels, so that its parallelism does not depend on C (C = 3 at the chamfer loss).
//
// Each cloud's rows are first put in CSR order: for each output row n, the rows r with
// idx[b, r] == n, ascending. One block a cloud runs a stable counting sort of idx in shared
// memory (stable_sort_rows): W sorting warps (a power of two, one per 256 rows, at most 16)
// each own a contiguous segment of rows and a count per key (integer atomics, exact); all
// 512 threads of the block then scan the counts into each (key, warp)'s first slot, keys in
// order and warps in order within a key; then each sorting warp places its segment 32 rows
// at a time in order, ranking the lanes that share a key with __match_any_sync and __popc.
// A warp loads its keys kBatch chunks at a time, so that it waits on global memory once per
// 256 rows. The W * N counts bound N: 58112 with one warp, whose block is then that warp.
//
// Two routes, chosen by the wrapper (ops/gather.py::scatter_fused, which mirrors the sizes
// here). A cloud whose g is small (R * C <= 8192 floats: the chamfer loss) runs in one
// launch, pfpp_scatter_fused_kernel: the block's loads of g stay in flight through the count
// before they land in shared memory, the placement moves whole rows into CSR order there,
// and thread n adds key n's run, four channels side by side. A run longer than kLongRun
// rows (every row to one key is the chamfer's skewed case) is left to threads (n, c), one
// channel each, that keep the next kUnroll rows in flight: its R dependent adds are the
// price of the fixed order. This route is latency-bound: each phase is a few shared-memory
// round trips between block barriers, the placement's 32-row steps the longest. A larger
// cloud runs two launches: pfpp_scatter_csr_kernel writes the CSR lists and row pointers to
// scratch, then pfpp_scatter_sum_kernel, one thread an output element (b, n, c) over the
// whole card, adds g[b, r, c] over n's list in order, kUnroll rows loaded before their adds;
// threads of a warp take neighbouring channels, so where C >= 32 a warp reads 128
// contiguous bytes of a g row, and the pass runs near the bytes bound.
#include "common.cuh"

namespace {

constexpr int kMaxSmem = 232448;    // 227 KB opt-in limit of one block on sm_90
constexpr int kFusedFloats = 8192;  // a cloud's g up to this size takes the fused route
constexpr int kThreads = 512;       // threads of a sorting block
constexpr int kMaxWarps = 16;       // sorting warps of a block, at most
constexpr int kBatch = 8;           // 32-row chunks whose keys a warp loads at once
constexpr int kUnroll = 8;          // rows a summing thread loads before adding them
constexpr int kLongRun = 32;        // rows of a key's run that the fused route splits by channel

// Shared memory of a sorting block: W * N counts, `extra` words, one sum per warp of the
// block's scan (none when the block is a single warp).
long long sort_bytes(int W, int threads, int N, long long extra) {
  return ((long long)W * N + extra + (threads > 32 ? threads / 32 : 0)) * 4;
}

// Sorting warps of a block (a power of two): one per 256 rows (one batch), at most 16,
// halved while the shared memory exceeds half the SM's (two blocks an SM). When even one
// warp's counts do not fit beside a scan over the block's 16 warps, the block is that one
// warp (threads = 32); 0 when nothing fits (N > 58112 on the two-launch route).
int sort_warps(int N, int R, long long extra, int* threads) {
  *threads = kThreads;
  int w = 1;
  while (w < kMaxWarps && w * 256 < R) w *= 2;
  while (w > 1 && sort_bytes(w, kThreads, N, extra) > kMaxSmem / 2) w /= 2;
  if (sort_bytes(w, kThreads, N, extra) <= kMaxSmem) return w;
  *threads = 32;
  return sort_bytes(1, 32, N, extra) <= kMaxSmem ? 1 : 0;
}

// The stable counting sort of one cloud's keys ib[0, R) (see the note) by the block's first
// W warps; every thread of the block zeroes and scans. cnt holds W * N ints, wsum one int a
// warp. stage() runs between the count and the scan; place(slot, r) puts row r at its
// CSR slot; rp, if not null, gets the N + 1 row pointers. On return (after a block barrier)
// cnt[(W - 1) * N + k] is the end of key k's list.
template <int W, typename Stage, typename Place>
__device__ void stable_sort_rows(const int* __restrict__ ib, int N, int R, int* cnt,
                                 int* wsum, int* __restrict__ rp, Stage stage, Place place) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // warp w's segment: whole 32-row chunks, in row order across warps; empty for w >= W
  const int seg = ((R + W - 1) / W + 31) / 32 * 32;
  const int lo = min(R, w * seg), hi = min(R, lo + seg);
  int key[kBatch];
  auto load_keys = [&](int base) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int r = base + u * 32 + lane;
      key[u] = r < hi ? __ldg(ib + r) : -1 - lane;  // dead lanes: keys no one shares
    }
  };
  load_keys(lo);
  for (int i = threadIdx.x; i < W * N; i += blockDim.x) cnt[i] = 0;
  __syncthreads();

  int* mine = cnt + w * N;
  for (int base = lo; base < hi; base += 32 * kBatch) {
    if (base != lo) load_keys(base);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (key[u] >= 0) atomicAdd(&mine[key[u]], 1);
  }
  stage();
  __syncthreads();

  // exclusive scan over (key, warp), keys major: each thread takes a run of keys
  const int per = (N + blockDim.x - 1) / blockDim.x;
  const int k0 = min(N, (int)threadIdx.x * per), k1 = min(N, k0 + per);
  int sum = 0;
  for (int k = k0; k < k1; ++k) {
    int c[W];
#pragma unroll
    for (int v = 0; v < W; ++v) c[v] = cnt[v * N + k];
#pragma unroll
    for (int v = 0; v < W; ++v) sum += c[v];
  }
  int incl = sum;  // inclusive scan within the warp, then across warps
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  int first = incl - sum;
  if (blockDim.x > 32) {
    if (lane == 31) wsum[w] = incl;
    __syncthreads();
    for (int v = 0; v < w; ++v) first += wsum[v];
  }
  for (int k = k0; k < k1; ++k) {
    if (rp) rp[k] = first;
    int c[W];
#pragma unroll
    for (int v = 0; v < W; ++v) c[v] = cnt[v * N + k];
#pragma unroll
    for (int v = 0; v < W; ++v) {
      cnt[v * N + k] = first;
      first += c[v];
    }
  }
  if (rp && threadIdx.x == 0) rp[N] = R;
  __syncthreads();

  // stable placement; only warp w moves its slots, so no atomics. A segment of one batch
  // still holds its keys from the count.
  const unsigned below = (1u << lane) - 1;
  for (int base = lo; base < hi; base += 32 * kBatch) {
    if (hi - lo > 32 * kBatch) load_keys(base);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (base + u * 32 >= hi) break;  // the same for the whole warp
      const int r = base + u * 32 + lane;
      const unsigned peers = __match_any_sync(0xffffffffu, key[u]);
      int slot = 0;
      if (r < hi) {
        slot = mine[key[u]];
        place(slot + __popc(peers & below), r);
      }
      __syncwarp();
      if (r < hi && lane == __ffs(peers) - 1) mine[key[u]] = slot + __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
}

// One launch: one block a cloud; g staged in shared memory, its rows placed in CSR order,
// then thread n adds key n's run in each channel, or, for a run longer than kLongRun,
// threads (n, c) add it channel by channel with the next kUnroll rows in flight.
template <int W>
__global__ void __launch_bounds__(kThreads)
    pfpp_scatter_fused_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                              float* __restrict__ out, int N, int R, int C) {
  // [W][N] counts | g [R][C] | g in CSR order | long runs' count | warp sums
  extern __shared__ int smem[];
  const int RC = R * C;
  int* cnt = smem;
  float* staged = (float*)(smem + W * N);
  float* sorted = staged + RC;
  int* nlong = (int*)(sorted + RC);
  const float* gb = g + (size_t)blockIdx.x * RC;
  // g's loads are in flight through the count (a one-warp block copies it in a loop instead)
  constexpr int kHeld = kFusedFloats / kThreads;
  const bool held_fits = RC <= kHeld * (int)blockDim.x;
  float held[kHeld];
#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    held[k] = held_fits && i < RC ? __ldg(gb + i) : 0.f;
  }
  stable_sort_rows<W>(
      idx + (size_t)blockIdx.x * R, N, R, cnt, nlong + 1, nullptr,
      [&] {
        if (held_fits) {
#pragma unroll
          for (int k = 0; k < kHeld; ++k) {
            const int i = threadIdx.x + k * blockDim.x;
            if (i < RC) staged[i] = held[k];
          }
        } else {
          for (int i = threadIdx.x; i < RC; i += blockDim.x) staged[i] = __ldg(gb + i);
        }
      },
      [&](int slot, int r) {
        for (int c = 0; c < C; ++c) sorted[slot * C + c] = staged[r * C + c];
      });
  const int* ends = cnt + (W - 1) * N;
  float* ob = out + (size_t)blockIdx.x * N * C;
  int* longs = (int*)staged;  // free once the rows are placed
  if (threadIdx.x == 0) *nlong = 0;
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const int end = ends[n], first = n ? ends[n - 1] : 0;
    if (end - first > kLongRun) {
      longs[atomicAdd(nlong, 1)] = n;  // any order: each run is summed on its own
      continue;
    }
    for (int c0 = 0; c0 < C; c0 += 4) {  // four channels side by side
      float acc[4] = {};
      for (int j = first; j < end; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (c0 + u < C) acc[u] += sorted[j * C + c0 + u];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c0 + u < C) ob[n * C + c0 + u] = acc[u];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < *nlong * C; e += blockDim.x) {
    const int n = longs[e / C], c = e % C;
    const float* col = sorted + c;
    const int end = ends[n];
    int j = n ? ends[n - 1] : 0;  // end - j > kLongRun >= 2 * kUnroll
    float acc = 0.f, cur[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = col[(j + u) * C];
    for (; j + 2 * kUnroll <= end; j += kUnroll) {
      float nxt[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) nxt[u] = col[(j + kUnroll + u) * C];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        acc += cur[u];
        cur[u] = nxt[u];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc += cur[u];
    for (j += kUnroll; j < end; ++j) acc += col[j * C];
    ob[n * C + c] = acc;
  }
}

// Two launches, first: the CSR lists (perm) and row pointers of each cloud, to scratch.
template <int W>
__global__ void __launch_bounds__(kThreads)
    pfpp_scatter_csr_kernel(const int* __restrict__ idx, int* __restrict__ perm,
                            int* __restrict__ row_ptr, int N, int R) {
  extern __shared__ int cnt[];  // [W][N] counts, then warp sums
  int* pb = perm + (size_t)blockIdx.x * R;
  stable_sort_rows<W>(idx + (size_t)blockIdx.x * R, N, R, cnt, cnt + W * N,
                      row_ptr + (size_t)blockIdx.x * (N + 1), [] {},
                      [&](int slot, int r) { pb[slot] = r; });
}

// Two launches, second: one thread an output element, its list added in order.
__global__ void __launch_bounds__(256)
    pfpp_scatter_sum_kernel(const float* __restrict__ g, const int* __restrict__ perm,
                            const int* __restrict__ row_ptr, float* __restrict__ out, int B,
                            int N, int R, int C) {
  const int NC = N * C;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const int* rp = row_ptr + (size_t)b * (N + 1);
    const int* pb = perm + (size_t)b * R;
    const float* gb = g + (size_t)b * R * C;
    float* ob = out + (size_t)b * NC;
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < NC; e += gridDim.x * blockDim.x) {
      const int n = e / C;
      const float* gc = gb + (e - n * C);
      const int end = rp[n + 1];
      float acc = 0.f;
      for (int j = rp[n]; j < end; j += kUnroll) {
        float v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          v[u] = j + u < end ? __ldg(gc + (size_t)__ldg(pb + j + u) * C) : 0.f;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (j + u < end) acc += v[u];
      }
      ob[e] = acc;
    }
  }
}

int allow_smem(const void* kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int W>
int launch(const float* g, const int* idx, float* out, int* scratch, int B, int N, int R,
           int C, int threads, int smem, cudaStream_t s) {
  if (scratch == nullptr) {
    int e = allow_smem((const void*)pfpp_scatter_fused_kernel<W>, smem);
    if (e) return e;
    pfpp_scatter_fused_kernel<W><<<B, threads, smem, s>>>(g, idx, out, N, R, C);
    return (int)cudaGetLastError();
  }
  int e = allow_smem((const void*)pfpp_scatter_csr_kernel<W>, smem);
  if (e) return e;
  int* perm = scratch;
  int* row_ptr = scratch + (size_t)B * R;
  pfpp_scatter_csr_kernel<W><<<B, threads, smem, s>>>(idx, perm, row_ptr, N, R);
  e = (int)cudaGetLastError();
  if (e) return e;
  const int sum_threads = 256;
  const long long bx = ((long long)N * C + sum_threads - 1) / sum_threads;
  const dim3 grid((unsigned)(bx < 65535 ? bx : 65535), B < 65535 ? B : 65535);
  pfpp_scatter_sum_kernel<<<grid, sum_threads, 0, s>>>(g, perm, row_ptr, out, B, N, R, C);
  return (int)cudaGetLastError();
}

}  // namespace

// scratch null: the fused route (R * C <= 8192, else cudaErrorInvalidValue);
// else B * (R + N + 1) ints for the CSR lists and row pointers of the two-launch route.
PFPP_EXPORT int pfpp_scatter_add(const float* g, const int* idx, float* out, int* scratch,
                                 int B, int N, int R, int C, void* stream) {
  if (B == 0 || N == 0 || C == 0) return 0;
  if ((long long)N * C > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool fused = scratch == nullptr;
  if (fused && (long long)R * C > kFusedFloats)
    return (int)cudaErrorInvalidValue;
  const long long extra = fused ? 2LL * R * C + 1 : 0;
  int threads = 0;
  const int W = sort_warps(N, R, extra, &threads);
  const int smem = (int)sort_bytes(W, threads, N, extra);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (W) {
    case 1: return launch<1>(g, idx, out, scratch, B, N, R, C, threads, smem, s);
    case 2: return launch<2>(g, idx, out, scratch, B, N, R, C, threads, smem, s);
    case 4: return launch<4>(g, idx, out, scratch, B, N, R, C, threads, smem, s);
    case 8: return launch<8>(g, idx, out, scratch, B, N, R, C, threads, smem, s);
    case 16: return launch<16>(g, idx, out, scratch, B, N, R, C, threads, smem, s);
    default: return (int)cudaErrorInvalidValue;  // W == 0: N does not fit
  }
}
