// Device code shared by the two fused set-abstraction kernels: S (sa_cached.cu, cached
// grouped geometry) and R (sa_raw.cu, raw clouds gathered in the kernel).
//
// Every Dense layer that is a matrix product (layers 2 and 3 of both kernels, and the
// feature block of R's layer 1) runs on the tensor cores in 3xTF32: each operand x becomes
// big = tf32(x) (round to nearest, ties away) and small = x - big (exact in FP32; the tensor
// core keeps its top 19 bits), and the product is small*big + big*small + big*big,
// accumulated in FP32. The dropped small*small term and the truncation of small are about
// 2^-21 of each product, so the layers stay within 1e-6 of an FP32 product where plain TF32
// is off by about 3e-4 (tests/test_torch_port_ops.py). The bound is therefore three TF32
// MMAs per product at 495 TFLOP/s.
//
// Operands split once. The weights arrive split: the wrapper (ops/sa_fused.py::tf32_planes;
// the frozen encoder does it once when it is built) lays each folded W [cin][cout] out as
// [cin/8][big, small][cout/8][2][8][4], the K-major 8x4 core matrices that wgmma reads from
// shared memory, so a ring tile is a straight copy and the kernel spends no ALU on B. The
// activations are split in registers, once per element and layer: a warpgroup (4 warps, 64
// rows) runs each layer as passes of N = 64, 128 or 256 output columns (the widest that
// divides every layer's width), one wgmma m64nNk8 per product and k8 slice, so each A split
// serves the whole pass.
//
// Block layout: one warpgroup per 64 (centre, neighbour) rows, BM = 128 rows (two
// warpgroups) where it fits shared memory, else 64; each weight byte read from L2 serves BM
// rows. Activations stay in shared memory, row-major with a row stride of C + 4 floats, so
// a warp's A-fragment loads hit 32 distinct banks. Each warp reads and writes only its own
// 16 rows, so a layer whose output is one pass (cout == N) writes it in place over its
// input: the activations of SA3 (256 wide) fit twice the rows of two buffers. Weights
// stream through a ring of 16 KB tiles (2048 / N inputs x N columns x 2 planes) filled by
// the copy engine (cp.async.bulk) on mbarriers: thread 0 keeps the ring full, a
// warp waits only for the tile it needs and releases it once its MMAs on it are done, so no
// block barrier sits in the main loop and the ring, as deep as shared memory allows, runs
// up to its size ahead across passes and layers. The max over K is fused into layer 3's
// epilogue: warp shuffles over the rows of a centre inside a warp, then a small shared
// reduction across the warps of a centre. No float atomics: every output is a fixed
// sequence of operations, so launches are bit-reproducible.
//
// Block shape (with_block_shape): 128 rows, else 64; the shared memory of two blocks an SM
// where each still gets a ring of 2 tiles, else of one. SA1 (N = 64) runs two blocks of 128
// rows an SM; SA2 (N = 128) gets a 2-tile ring, but its registers hold it to one block an SM
// (capping them serializes the wgmmas; the 2-tile ring measured faster than the deepest);
// SA3 (N = 256) one block with a 5-tile ring.
//
// What holds it back (measured on the H100, PERF.md section 6): S runs at 2.05x its bound at
// 96 clouds (SA1 2.6x, SA2 2.1x, SA3 1.8x; 3.9x with the mma.sync tail this replaced, which
// split both operands in registers for every 16-column warp tile). Each block's serial
// phases, layer 1 with its gathered rows and the epilogues, are not overlapped with MMAs where
// one block holds an SM. Kept out: 8 KB tiles (more waits a tile: slower), a second MMA group
// in flight per warpgroup (its A registers are rewritten under it), weights replicated to
// spread L2 reads (no change).
#pragma once

#include <initializer_list>

#include "common.cuh"


namespace sa {

constexpr size_t kMaxSmem = 232448;          // 227 KB, the most one block may have
constexpr size_t kSmemPerSM = 233472;        // 228 KB an SM, of which each block
constexpr size_t kSmemReserved = 1024;       // holds 1 KB for the system

__host__ __device__ constexpr int ld_act(int C) { return C + 4; }  // activation row stride

// Rows of one centre that lie in one warp (a warp holds 16 rows).
__host__ __device__ constexpr int rows_in_warp(int K) { return K < 16 ? K : 16; }

// The widest pass, 256, 128 or 64 columns, that divides every layer's output width; 0 if
// none does.
inline int pass_width(std::initializer_list<int> couts) {
  for (const int n : {256, 128, 64}) {
    bool ok = true;
    for (const int c : couts) ok = ok && c % n == 0;
    if (ok) return n;
  }
  return 0;
}

// --------------------------------------------------------------------------- block shape

// BM rows, one warpgroup per 64; N columns a pass; weight tiles of KT inputs x N columns in
// their big and small planes (16 KB whatever N: 384 MMA cycles of a warpgroup), in a ring
// of as many stages as shared memory holds (at most kMaxStages).
template <int BM_, int N_>
struct Shape {
  static constexpr int BM = BM_, N = N_, KT = 2048 / N;
  static constexpr int kThreads = 2 * BM;               // the consumer warps
  static constexpr int kBlockThreads = kThreads + 32;   // and the producer warp
  static constexpr int kMinBlocks = N == 64 ? 2 : 1;    // the accumulators' registers
  static constexpr int kTileFloats = 2 * KT * N;
  static_assert(BM == 64 || BM == 128, "one or two warpgroups");
};

constexpr int kMaxStages = 8;
constexpr int kBarrierFloats = 4 * kMaxStages;  // full and empty mbarriers, 8 bytes each

// The activation buffers of a chain of n <= 3 layer widths w0, w1, w2 (a layer between each
// two): w0 lives in buffer 0, and each next width in place of the one before when its
// layer is one pass (width == N), else in the other buffer. ld(b) is buffer b's row stride
// (0: unused).
struct Buffers {
  int in[3];
  int width[2];
  __host__ __device__ Buffers(int n, int w0, int w1, int w2, int N) {
    width[0] = width[1] = 0;
    int b = 0;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int c = i == 0 ? w0 : i == 1 ? w1 : w2;
      if (i > 0 && c != N) b ^= 1;
      in[i] = b;
      if (i < n) width[b] = width[b] > c ? width[b] : c;
    }
  }
  __host__ __device__ int ld(int b) const { return width[b] ? ld_act(width[b]) : 0; }
};

template <int N, class Smem, class F>
int with_block_shape_n(const Smem& smem, F&& f, int none) {
  const auto fit = [&](auto shape, size_t limit) {
    const size_t fixed = smem(shape, 0), tile = sizeof(float) * decltype(shape)::kTileFloats;
    const size_t n = fixed < limit ? (limit - fixed) / tile : 0;
    return (int)(n < (size_t)kMaxStages ? n : kMaxStages);
  };
  constexpr size_t kTwo = kSmemPerSM / 2 - kSmemReserved;
  if (const int st = fit(Shape<128, N>{}, kTwo); st >= 2) return f(Shape<128, N>{}, st);
  if (const int st = fit(Shape<128, N>{}, kMaxSmem); st >= 1) return f(Shape<128, N>{}, st);
  if (const int st = fit(Shape<64, N>{}, kTwo); st >= 2) return f(Shape<64, N>{}, st);
  if (const int st = fit(Shape<64, N>{}, kMaxSmem); st >= 1) return f(Shape<64, N>{}, st);
  return none;
}

// Returns f(Shape<BM, N>{}, stages) for the pass width N (64, 128 or 256): 128 rows where
// they fit, else 64; two blocks an SM where each gets a ring of 2 tiles or more, else one
// block with the deepest ring shared memory holds; else `none`. smem(shape, stages) is a
// block's shared memory in bytes. K must divide 64.
template <class Smem, class F>
int with_block_shape(int K, int N, const Smem& smem, F&& f, int none) {
  if (K <= 0 || 64 % K) return none;
  switch (N) {
    case 64: return with_block_shape_n<64>(smem, f, none);
    case 128: return with_block_shape_n<128>(smem, f, none);
    case 256: return with_block_shape_n<256>(smem, f, none);
    default: return none;
  }
}

// --------------------------------------------------------------------------- primitives

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x -> (big, small): big rounds x to TF32 (10 mantissa bits, ties away from zero, by the
// integer add on the magnitude bits), small = x - big is exact. ops/sa_fused.py::tf32_planes
// splits the weights by the same rule.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// mbarriers of the weight ring: `full` completes when a tile's bulk copies have landed,
// `empty` when every warp's MMAs on it are done.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}
// A barrier of `threads` threads (a multiple of 32) under id (1-15; 0 is __syncthreads).
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// bytes (a multiple of 16, both addresses 16-byte aligned) from global to shared memory by
// the copy engine, completing on bar.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins registers an asynchronous wgmma reads or writes, so that the compiler moves no access
// to them across the fences and waits.
template <int n>
__device__ __forceinline__ void hold(float (&r)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int n>
__device__ __forceinline__ void hold(uint32_t (&r)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// The wgmma descriptor of one plane of a k8 slice of a staged tile: N/8 K-major core
// matrices of 8 columns x 4 inputs (128 bytes), the slice's two input halves 128 bytes
// apart (leading byte offset), column groups 256 bytes apart (stride byte offset), no
// swizzle.
__device__ __forceinline__ uint64_t plane_desc(const float* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3ffff) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// d[64 x N] += a[64 x 8] @ b[8 x N]: a warpgroup's TF32 MMA, A from registers (the
// m16n8k8 fragment of the warp's 16 rows), B by descriptor; d[4j + r] holds the warp's rows
// g (r < 2) and g + 8 and columns 8j + 2q (+1 for odd r).
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void run(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// ------------------------------------------------------------------------- weight stream

// The split weights of up to three Dense layers, streamed through the ring in the order the
// layers consume them: per layer, N-column passes, each over its KT-input tiles. w[l] holds
// the planes [cin/8][2][cout/8][2][8][4] (16-byte aligned); a tile is 2 * KT / 8 chunks of
// N * 8 floats, one per k8 slice and plane, laid out in the ring as in w (one contiguous copy
// when the layer is one pass). The producer warp's lane 0 loads every tile in turn, each
// once every consumer warp has released its stage; tile t lives in stage t % stages, and
// full[s] and empty[s] complete once per use of stage s.
template <class Sh>
struct WeightStream {
  const float* w[3];
  int cin[3], cout[3];
  int n = 0;
  float* ring;
  uint64_t* full;
  uint64_t* empty;
  int stages;

  // bars: 2 * kMaxStages mbarriers in shared memory. Every thread of the block calls it;
  // a block barrier must follow before any other use of the ring.
  __device__ void init(float* ring_, uint64_t* bars, int stages_) {
    ring = ring_, full = bars, empty = bars + kMaxStages, stages = stages_;
    if (threadIdx.x == Sh::kThreads) {
      for (int s = 0; s < stages; ++s) {
        mbar_init(full + s, 1);
        mbar_init(empty + s, Sh::kThreads / 32);
      }
      mbar_init_fence();
    }
  }
  __device__ void add(const float* w_, int cin_, int cout_) {
    w[n] = w_, cin[n] = cin_, cout[n] = cout_;
    ++n;
  }
  // The producer: every tile of every layer, in the order dense() consumes them.
  __device__ void produce() {
    constexpr uint32_t kChunk = Sh::N * 8 * sizeof(float);  // one k8 slice's plane
    constexpr uint32_t kTile = Sh::kTileFloats * sizeof(float);
    int i = 0;
    for (int l = 0; l < n; ++l)
      for (int c0 = 0; c0 < cout[l]; c0 += Sh::N)
        for (int k0 = 0; k0 < cin[l]; k0 += Sh::KT, ++i) {
          const int s = i % stages;
          if (i >= stages) mbar_wait(empty + s, (i / stages - 1) & 1);
          const float* from = w[l] + (size_t)(k0 / 4) * cout[l] * 8 + c0 * 8;
          float* dst = ring + (size_t)s * Sh::kTileFloats;
          mbar_expect_tx(full + s, kTile);
          if (cout[l] == Sh::N) {
            bulk_copy(dst, from, kTile, full + s);
          } else {
            for (int c = 0; c < Sh::KT / 4; ++c)
              bulk_copy(dst + c * Sh::N * 8, from + (size_t)c * cout[l] * 8, kChunk, full + s);
          }
        }
  }
  // A consumer warp, once its MMAs on tile t are done.
  __device__ void release(int t) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + t % stages);
  }
};

// One Dense layer over the activations hin [BM][ldin] in shared memory: for each N-column
// pass c0, acc = hin @ W[:, c0:c0+N] on the tensor cores, then epi(acc, c0, row0, q) with the
// lane's first row row0 (warp * 16 + lane / 4) and its quad q (lane % 4): acc[4j + r] holds
// row row0 (+ 8 for r >= 2) and column c0 + 8j + 2q (+ 1 for odd r). t counts the ring's
// tiles consumed so far. Every consumer thread must call it; the layer's tiles are the
// stream's next ones. A warp reads only its own rows of hin (written by itself, or published
// by a barrier of the consumers).
template <class Sh, class Epi>
__device__ __forceinline__ void dense(WeightStream<Sh>& ws, int& t, const float* hin, int ldin,
                                      int cin, int cout, Epi&& epi) {
  constexpr int N = Sh::N, kSlices = Sh::KT / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = lane & 3, row0 = warp * 16 + (lane >> 2);
  const float* arow = hin + row0 * ldin + q;
  for (int c0 = 0; c0 < cout; c0 += N) {
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    for (int k0 = 0; k0 < cin; k0 += Sh::KT, ++t) {
      uint32_t ab[kSlices][4], as[kSlices][4];
#pragma unroll
      for (int s = 0; s < kSlices; ++s)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_tf32(arow[8 * (r & 1) * ldin + k0 + 8 * s + 4 * (r >> 1)], ab[s][r], as[s][r]);
#pragma unroll
      for (int s = 0; s < kSlices; ++s) hold(ab[s]), hold(as[s]);
      hold(acc);
      const int stage = t % ws.stages;
      mbar_wait(ws.full + stage, (t / ws.stages) & 1);  // tile t has landed
      const float* tile = ws.ring + (size_t)stage * Sh::kTileFloats;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kSlices; ++s) {
        const uint64_t big = plane_desc(tile + 2 * s * N * 8);
        const uint64_t small = plane_desc(tile + (2 * s + 1) * N * 8);
        Wgmma<N>::run(acc, as[s], big);
        Wgmma<N>::run(acc, ab[s], small);
        Wgmma<N>::run(acc, ab[s], big);
      }
      wgmma_commit();
      wgmma_wait<0>();
      hold(acc);
      ws.release(t);
    }
    epi(acc, c0, row0, q);
    __syncwarp();  // the warp's in-place writes before its next reads
  }
}

// Epilogue writing hout[row][col] = relu(acc + bias[col] + extra(row, col)) into shared
// memory, row stride ld (the warp's own rows: hout may be the layer's input when the layer
// is one pass).
template <int N, class Extra>
__device__ __forceinline__ void store_relu(float (&acc)[N / 2], int c0, int row0, int q,
                                           float* hout, int ld,
                                           const float* __restrict__ bias, Extra&& extra) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = c0 + 8 * j + 2 * q;
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      *reinterpret_cast<float2*>(&hout[row * ld + col]) =
          make_float2(fmaxf(acc[4 * j + 2 * h] + b0 + extra(row, col), 0.f),
                      fmaxf(acc[4 * j + 2 * h + 1] + b1 + extra(row, col + 1), 0.f));
    }
  }
}

// Layer 3's epilogue: out[m, s, c] = max over the K rows of centre s of
// relu(acc + b3[c]) for the pass's N columns. A centre's rows are K consecutive rows of the
// block, inside one warpgroup (K divides 64); kw = min(K, 16) of them lie in one warp and are
// reduced there (rows g and g + 8 of a lane, then shuffles over the lane's row bits), one
// value per (kw-row slot, column) goes to red [BM / kw][N], and K / kw slots make a centre,
// reduced by the warpgroup alone. Centres s >= S are dropped.
template <class Sh>
__device__ __forceinline__ void max_over_k(float (&acc)[Sh::N / 2], int c0, int row0, int q,
                                           float* red, const float* __restrict__ b3,
                                           float* __restrict__ out, int m, int S, int K,
                                           int s0, int C3) {
  constexpr int N = Sh::N;
  const int kw = rows_in_warp(K);
  const int g = (threadIdx.x & 31) >> 2, wg = threadIdx.x >> 7;
  const bool lead = (g & ((kw < 8 ? kw : 8) - 1)) == 0;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float b[2] = {b3[c0 + 8 * j + 2 * q], b3[c0 + 8 * j + 2 * q + 1]};
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[4 * j + r] = fmaxf(acc[4 * j + r] + b[r & 1], 0.f);
  }
  // acc[4j + e] (rows g) and acc[4j + 2 + e] (rows g + 8) -> the max of the lane's kw-row
  // slots, over the row bits held by other lanes (K >= 4)
  if (kw >= 16) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) acc[4 * j + e] = fmaxf(acc[4 * j + e], acc[4 * j + 2 + e]);
#pragma unroll
    for (int lanes = 4; lanes <= 16; lanes *= 2)
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          acc[4 * j + e] = fmaxf(acc[4 * j + e], __shfl_xor_sync(0xffffffffu, acc[4 * j + e], lanes));
  } else {
#pragma unroll
    for (int lanes = 4; lanes <= 16; lanes *= 2) {
      if (lanes == 16 && kw < 8) break;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = fmaxf(acc[i], __shfl_xor_sync(0xffffffffu, acc[i], lanes));
    }
  }
  if (lead) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * q + e;
        red[row0 / kw * N + col] = acc[4 * j + e];
        if (kw < 16) red[(row0 + 8) / kw * N + col] = acc[4 * j + 2 + e];
      }
  }
  bar_sync(2 + wg, 128);  // the warpgroup's slots are in red
  const int per = K / kw, cpw = 64 / K;  // slots a centre, centres a warpgroup
  for (int e = threadIdx.x & 127; e < cpw * N; e += 128) {
    const int ct = wg * cpw + e / N, col = e % N, s = s0 + ct;
    if (s >= S) continue;
    float mx = red[ct * per * N + col];
    for (int p = 1; p < per; ++p) mx = fmaxf(mx, red[(ct * per + p) * N + col]);
    out[((size_t)m * S + s) * C3 + c0 + col] = mx;
  }
  bar_sync(2 + wg, 128);  // red is free for the next pass
}

// Layer 1's xyz term, h[r][c] = relu(x_r * w[c] + y_r * w[C1 + c] + z_r * w[2 * C1 + c]
// + p[r][c] + b[c]) for the block's rows, with (x, y, z)_r = xyz[3r..3r+2] and p the
// gathered feature term: h[r][c] itself if acc, float(codes[r * C1 + c]) * scale[c] if codes
// (int8 codes [BM][C1] in shared memory, dequantized by their column's scale), else 0. One
// warp a row, each lane 4 channels at a time, w, b and scale held in registers across the
// rows (w [3][C1], b and scale 16-byte aligned, C1 % 4 == 0; h row stride ld).
template <class Sh>
__device__ __forceinline__ void xyz_layer(const float* xyz, const float* __restrict__ w,
                                          const float* __restrict__ b, float* h, int ld,
                                          int C1, bool acc, const int8_t* codes = nullptr,
                                          const float* __restrict__ scale = nullptr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = lane * 4; c < C1; c += 128) {
    const float4 wx = *reinterpret_cast<const float4*>(w + c);
    const float4 wy = *reinterpret_cast<const float4*>(w + C1 + c);
    const float4 wz = *reinterpret_cast<const float4*>(w + 2 * C1 + c);
    const float4 bb = *reinterpret_cast<const float4*>(b + c);
    const float4 sc = codes != nullptr ? *reinterpret_cast<const float4*>(scale + c)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = warp; r < Sh::BM; r += Sh::kThreads / 32) {
      const float x = xyz[r * 3 + 0], y = xyz[r * 3 + 1], z = xyz[r * 3 + 2];
      float4* hp = reinterpret_cast<float4*>(h + r * ld + c);
      float4 p = acc ? *hp : make_float4(0.f, 0.f, 0.f, 0.f);
      if (codes != nullptr) {
        const char4 q = *reinterpret_cast<const char4*>(codes + r * C1 + c);
        p = make_float4((float)q.x * sc.x, (float)q.y * sc.y, (float)q.z * sc.z,
                        (float)q.w * sc.w);
      }
      *hp = make_float4(fmaxf(x * wx.x + y * wy.x + z * wz.x + p.x + bb.x, 0.f),
                        fmaxf(x * wx.y + y * wy.y + z * wz.y + p.y + bb.y, 0.f),
                        fmaxf(x * wx.z + y * wy.z + z * wz.z + p.z + bb.z, 0.f),
                        fmaxf(x * wx.w + y * wy.w + z * wz.w + p.w + bb.w, 0.f));
    }
  }
}

// Layers 2 and 3 and the max over the K neighbours of each centre:
//   h2 = relu(h1 @ W2 + b2);  out[m, s] = max_k relu(h2 @ W3 + b3)
// h1 [BM][ld1] must be complete and published by a barrier of the consumers; h2 [BM][ld2]
// may be h1 (Buffers: layer 2 one pass). W2's and W3's tiles are the stream's next ones.
// The consumer threads call it.
template <class Sh>
__device__ __forceinline__ void mlp_tail(WeightStream<Sh>& ws, int& t, const float* h1,
                                         int ld1, float* h2, int ld2, float* red,
                                         const float* __restrict__ b2,
                                         const float* __restrict__ b3,
                                         float* __restrict__ out, int m, int S, int K, int s0,
                                         int C1, int C2, int C3) {
  dense<Sh>(ws, t, h1, ld1, C1, C2, [&](auto& acc, int c0, int row0, int q) {
    store_relu<Sh::N>(acc, c0, row0, q, h2, ld2, b2, [](int, int) { return 0.f; });
  });
  dense<Sh>(ws, t, h2, ld2, C2, C3, [&](auto& acc, int c0, int row0, int q) {
    max_over_k<Sh>(acc, c0, row0, q, red, b3, out, m, S, K, s0, C3);
  });
}

}  // namespace sa
