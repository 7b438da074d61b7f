// Device code shared by the two fused set-abstraction kernels: S (sa_cached.cu, cached
// grouped geometry) and R (sa_raw.cu, raw clouds gathered in the kernel).
//
// Every Dense layer that is a matrix product (layers 2 and 3 of both kernels, and the
// feature block of R's layer 1) runs on the tensor cores as mma.sync m16n8k8 TF32 with the
// 3xTF32 split: each operand x becomes big = tf32(x) (round to nearest, ties away) and
// small = x - big (exact in FP32; the tensor core keeps its top 19 bits), and the product is
// small*big + big*small + big*big, accumulated in FP32. The dropped small*small term and the
// truncation of small are about 2^-21 of each product, so the layers stay within 1e-6 of an
// FP32 product where plain TF32 is off by about 3e-4 (tests/test_torch_port_ops.py). The
// bound is therefore three TF32 MMAs per product at 495 TFLOP/s.
//
// Block layout: 256 threads (8 warps) own BM = 128 or 64 (centre, neighbour) rows of one
// cloud, so each weight byte read from L2 serves BM rows. Activations stay in shared memory,
// row-major with a row stride of C + 4 floats, so a warp's A-fragment loads hit 32 distinct
// banks. A layer runs as 64-column passes; each warp owns a 32-row x (BM/4)-column tile of
// the pass and keeps its accumulators in registers. Weights stream through a ring of 4 (or
// 2) 32x64 tiles filled by cp.async (L2 only): the ring runs its size less one tile ahead
// across passes and layers, so a tile's L2 load overlaps the MMAs of the tiles before it,
// and one barrier per tile both publishes it and frees the stage the next load overwrites.
// The tile stride (72 floats) makes B-fragment loads conflict-free too. The max over K is
// fused into layer 3's epilogue: warp shuffles over the rows of a centre inside a warp, then
// a small shared reduction across the warps of a centre (K = 64 spans two). No float
// atomics: every output is a fixed sequence of operations, so launches are bit-reproducible.
//
// Block shape (with_block_shape): the first of 128 rows / 4 stages, 64 / 4, 64 / 2 with which
// two blocks share an SM, else the first that fits one block. The block is latency-bound
// (below), so a second block an SM beats halving the weight bytes: SA1 takes 128 rows (two
// blocks an SM), SA2 64 rows (two blocks; 128 would hold the SM alone) and SA3 64 (one
// block). The 2-stage ring only serves the widest layers (C1 + C2 up to 808 at 64 rows).
//
// What holds it back (measured on the H100, PERF.md): the block is latency-bound, not
// MMA-bound. With the MMAs taken out it keeps about 80% of its time (fragment loads, the
// in-register split, the per-tile barrier, layer 1). A wgmma version of the same tail (A
// split in registers, B split into K-major core matrices) measured slower at every stage.
#pragma once

#include <initializer_list>

#include "common.cuh"


namespace sa {

constexpr int kThreads = 256;                // 8 warps
constexpr int kKT = 32;                      // input channels per weight tile
constexpr int kBN = 64;                      // output columns per pass
constexpr int kLDW = kBN + 8;                // row stride of a staged weight tile (floats)
constexpr int kTileFloats = kKT * kLDW;     // one stage of the weight ring
constexpr size_t kMaxSmem = 232448;          // 227 KB, the most one block may have
constexpr size_t kSmemPerSM = 233472;        // 228 KB an SM, of which each block
constexpr size_t kSmemReserved = 1024;       // holds 1 KB for the system

__host__ __device__ constexpr int ld_act(int C) { return C + 4; }  // activation row stride

// Shared memory (floats) of the parts every kernel has: the ring of `stages` weight tiles,
// the layer-3 maxima of each warp's centres, the rows' xyz and their gather index.
__host__ __device__ inline size_t base_floats(int BM, int stages, int K) {
  const int kw = K < 32 ? K : 32;
  return (size_t)stages * kTileFloats + (size_t)(BM / kw) * kBN + BM * 3 + BM;
}

// --------------------------------------------------------------------------- block shape

template <int BM_, int Stages_>
struct Shape {
  static constexpr int BM = BM_, kStages = Stages_;
};

// Returns f(Shape<BM, Stages>{}) for the first of (128, 4), (64, 4), (64, 2) that takes K
// (BM % K == 0) and with which two blocks share an SM, else for the first that fits one
// block, else `none`. smem(BM, stages) is a block's shared memory in bytes.
template <class Smem, class F>
int with_block_shape(int K, const Smem& smem, F&& f, int none) {
  for (const size_t limit : {kSmemPerSM / 2 - kSmemReserved, kMaxSmem}) {
    if (128 % K == 0 && smem(128, 4) <= limit) return f(Shape<128, 4>{});
    if (64 % K == 0 && smem(64, 4) <= limit) return f(Shape<64, 4>{});
    if (64 % K == 0 && smem(64, 2) <= limit) return f(Shape<64, 2>{});
  }
  return none;
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
// integer add on the magnitude bits), small = x - big is exact.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ------------------------------------------------------------------------- weight stream

// The weights of up to three Dense layers, streamed through the ring in the order the
// layers consume them: per layer, 64-column passes, each over its 32-row input tiles.
// w[l] is row-major [cin[l]][ldw[l]], 16-byte aligned, ldw[l] % 4 == 0. The ring holds
// kStages tiles.
template <int kStages>
struct WeightStream {
  const float* w[3];
  int ldw[3], cin[3], cout[3];
  int n = 0;
  float* ring;
  int l = 0, k0 = 0, c0 = 0, issued = 0;  // the next tile to load

  __device__ void add(const float* w_, int ldw_, int cin_, int cout_) {
    w[n] = w_, ldw[n] = ldw_, cin[n] = cin_, cout[n] = cout_;
    ++n;
  }
  // Load the next tile into its stage (nothing past the last layer) and commit a group.
  __device__ void issue() {
    if (l < n) {
      const float* src = l == 0 ? w[0] : l == 1 ? w[1] : w[2];
      const int ld = l == 0 ? ldw[0] : l == 1 ? ldw[1] : ldw[2];
      float* dst = ring + (issued % kStages) * kTileFloats;
#pragma unroll
      for (int it = 0; it < kKT * kBN / 4 / kThreads; ++it) {
        const int v = threadIdx.x + it * kThreads;
        const int kk = v / (kBN / 4), cc = (v % (kBN / 4)) * 4;
        cp_async16(dst + kk * kLDW + cc, src + (size_t)(k0 + kk) * ld + c0 + cc);
      }
      k0 += kKT;
      if (k0 == (l == 0 ? cin[0] : l == 1 ? cin[1] : cin[2])) {
        k0 = 0;
        c0 += kBN;
        if (c0 == (l == 0 ? cout[0] : l == 1 ? cout[1] : cout[2])) c0 = 0, ++l;
      }
    }
    ++issued;
    cp_async_commit();
  }
  // Fill the ring ahead of the first tile (before any other work of the block).
  __device__ void prologue() {
    for (int s = 0; s < kStages - 1; ++s) issue();
  }
};

// Warp geometry of a BM-row block: kWarpsM x kWarpsN warps, each 32 rows x kWN columns of
// a 64-column pass, kNT n8 tiles wide.
template <int BM>
struct Geom {
  static constexpr int kWarpsM = BM / 32, kWarpsN = 8 / kWarpsM;
  static constexpr int kWN = kBN / kWarpsN, kNT = kWN / 8;
  static_assert(kWarpsM * kWarpsN == kThreads / 32 && kNT >= 1, "bad block geometry");
};

// One Dense layer over the activations hin [BM][ld_act(cin)] in shared memory: for each
// 64-column pass c0, acc = hin @ W[:, c0:c0+64] on the tensor cores, then
// epi(acc, col0, row0, q) with the warp's first column col0 (absolute), its first row row0
// (+ lane / 4) and the lane's quad q: acc[i][j] holds rows row0 + 16i (+ 8 for [2], [3]) and
// columns col0 + 8j + 2q (+ 1 for [1], [3]). t counts the ring's tiles consumed so far.
// Every thread of the block must call it; the layer's tiles are the stream's next ones.
template <int BM, int kStages, class Epi>
__device__ __forceinline__ void dense(WeightStream<kStages>& ws, int& t, const float* hin,
                                      int cin, int cout, Epi&& epi) {
  using G = Geom<BM>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3, wm = warp % G::kWarpsM, wn = warp / G::kWarpsM;
  const int ldin = ld_act(cin);
  const float* arow = hin + (wm * 32 + g) * ldin + q;
  for (int c0 = 0; c0 < cout; c0 += kBN) {
    float acc[2][G::kNT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < G::kNT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
    for (int k0 = 0; k0 < cin; k0 += kKT, ++t) {
      cp_async_wait<kStages - 2>();  // this thread's copies of tile t have landed
      __syncthreads();               // everyone's have; tile t - 1's stage is free
      ws.issue();                    // tile t + kStages - 1 into that stage
      const float* wt = ws.ring + (t % kStages) * kTileFloats + q * kLDW + wn * G::kWN + g;
      const float* at = arow + k0;
#pragma unroll
      for (int kk = 0; kk < kKT; kk += 8) {
        uint32_t ab[2][4], as[2][4], bb[G::kNT][2], bs[G::kNT][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            split_tf32(at[(16 * i + 8 * (r & 1)) * ldin + kk + 4 * (r >> 1)], ab[i][r],
                       as[i][r]);
#pragma unroll
        for (int j = 0; j < G::kNT; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            split_tf32(wt[(kk + 4 * r) * kLDW + 8 * j], bb[j][r], bs[j][r]);
        // three sweeps over the warp's tiles, so that the MMAs into one accumulator are
        // 2 * kNT instructions apart
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < G::kNT; ++j) mma_tf32(acc[i][j], as[i], bb[j]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < G::kNT; ++j) mma_tf32(acc[i][j], ab[i], bs[j]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < G::kNT; ++j) mma_tf32(acc[i][j], ab[i], bb[j]);
      }
    }
    epi(acc, c0 + wn * G::kWN, wm * 32 + g, q);
  }
}

// Epilogue writing hout[row][col] = relu(acc + bias[col] + extra(row, col)) into shared
// memory, row stride ld_act(cout).
template <int BM, class Extra>
__device__ __forceinline__ void store_relu(float (&acc)[2][Geom<BM>::kNT][4], int col0,
                                           int row0, int q, float* hout, int cout,
                                           const float* __restrict__ bias, Extra&& extra) {
  const int ld = ld_act(cout);
#pragma unroll
  for (int j = 0; j < Geom<BM>::kNT; ++j) {
    const int col = col0 + 8 * j + 2 * q;
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 16 * i + 8 * h;
        *reinterpret_cast<float2*>(&hout[row * ld + col]) =
            make_float2(fmaxf(acc[i][j][2 * h] + b0 + extra(row, col), 0.f),
                        fmaxf(acc[i][j][2 * h + 1] + b1 + extra(row, col + 1), 0.f));
      }
  }
}

// Layer 3's epilogue: out[m, s, c] = max over the K rows of centre s of
// relu(acc + b3[c]) for the pass's 64 columns. A centre's rows are K consecutive rows of the
// block; kw = min(K, 32) of them lie in one warp and are reduced there (within a lane and
// by shuffles over the lane's row bits), one value per (kw-row slot, column) goes to red
// [BM / kw][kBN], and K / kw slots make a centre. Centres s >= S are dropped.
template <int BM>
__device__ __forceinline__ void max_over_k(float (&acc)[2][Geom<BM>::kNT][4], int col0,
                                           int row0, int q, float* red,
                                           const float* __restrict__ b3, int c0,
                                           float* __restrict__ out, int m, int S, int K,
                                           int s0, int C3) {
  const int kw = K < 32 ? K : 32;
  const int g = (threadIdx.x & 31) >> 2;
  const int lead = (g & ((kw < 8 ? kw : 8) - 1)) == 0;
#pragma unroll
  for (int j = 0; j < Geom<BM>::kNT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + 8 * j + 2 * q + e;
      const float bias = b3[col];
      float v[2][2];  // rows 16i + 8h + g of the warp
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) v[i][h] = fmaxf(acc[i][j][2 * h + e] + bias, 0.f);
      if (kw >= 16)  // rows g and g + 8 belong to one centre
#pragma unroll
        for (int i = 0; i < 2; ++i) v[i][0] = fmaxf(v[i][0], v[i][1]);
      if (kw >= 32) v[0][0] = fmaxf(v[0][0], v[1][0]);  // and both m16 tiles
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // over the row's low bits held by other lanes
          float x = v[i][h];
          x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
          x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
          if (kw >= 8) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
          v[i][h] = x;
        }
      if (lead) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if ((kw >= 16 && h) || (kw >= 32 && i)) continue;
            red[(row0 + 16 * i + 8 * h) / kw * kBN + (col - c0)] = v[i][h];
          }
      }
    }
  __syncthreads();
  const int per = K / kw, cpb = BM / K;
  for (int e = threadIdx.x; e < cpb * kBN; e += kThreads) {
    const int ct = e / kBN, col = e % kBN, s = s0 + ct;
    if (s >= S) continue;
    float mx = red[ct * per * kBN + col];
    for (int p = 1; p < per; ++p) mx = fmaxf(mx, red[(ct * per + p) * kBN + col]);
    out[((size_t)m * S + s) * C3 + c0 + col] = mx;
  }
}

// Layer 1's xyz term, h[r][c] = relu(x_r * w[c] + y_r * w[C1 + c] + z_r * w[2 * C1 + c]
// + p[r][c] + b[c]) for the block's rows, with (x, y, z)_r = xyz[3r..3r+2] and p the
// gathered feature term: h[r][c] itself if acc, float(codes[r * C1 + c]) * scale[c] if codes
// (int8 codes [BM][C1] in shared memory, dequantized by their column's scale), else 0. One
// warp a row, each lane 4 channels at a time, w, b and scale held in registers across the
// rows (w [3][C1], b and scale 16-byte aligned, C1 % 4 == 0; h row stride ld_act(C1)).
template <int BM>
__device__ __forceinline__ void xyz_layer(const float* xyz, const float* __restrict__ w,
                                          const float* __restrict__ b, float* h, int C1,
                                          bool acc, const int8_t* codes = nullptr,
                                          const float* __restrict__ scale = nullptr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, ld = ld_act(C1);
  for (int c = lane * 4; c < C1; c += 128) {
    const float4 wx = *reinterpret_cast<const float4*>(w + c);
    const float4 wy = *reinterpret_cast<const float4*>(w + C1 + c);
    const float4 wz = *reinterpret_cast<const float4*>(w + 2 * C1 + c);
    const float4 bb = *reinterpret_cast<const float4*>(b + c);
    const float4 sc = codes != nullptr ? *reinterpret_cast<const float4*>(scale + c)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = warp; r < BM; r += kThreads / 32) {
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
// h1 [BM][ld_act(C1)] must be complete before the layer's first tile barrier; W2's and W3's
// tiles are the stream's next ones.
template <int BM, int kStages>
__device__ __forceinline__ void mlp_tail(WeightStream<kStages>& ws, int& t, const float* h1,
                                         float* h2, float* red, const float* __restrict__ b2,
                                         const float* __restrict__ b3,
                                         float* __restrict__ out, int m, int S, int K, int s0,
                                         int C1, int C2, int C3) {
  dense<BM>(ws, t, h1, C1, C2, [&](auto& acc, int col0, int row0, int q) {
    store_relu<BM>(acc, col0, row0, q, h2, C2, b2, [](int, int) { return 0.f; });
  });
  dense<BM>(ws, t, h2, C2, C3, [&](auto& acc, int col0, int row0, int q) {
    max_over_k<BM>(acc, col0, row0, q, red, b3, col0 - col0 % kBN, out, m, S, K, s0, C3);
  });
}

}  // namespace sa
