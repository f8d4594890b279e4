// The convolution core shared by the port's two conv kernels (K1 conv2d.cu,
// K2 halo_conv.cu), which replace the Pallas TPU kernel
// src/repro/kernels/conv2d/conv2d.py: _conv_kernel / conv2d_tiles (K2's
// halo_conv2d reaches it too): an implicit GEMM on NHWC x HWIO -> NHWC with
// f32 accumulation on the tensor cores, and a depthwise branch.  The kernels
// differ only in where an input row comes from, so the core is a template
// over an input source `Src`:
//
//   typename Src::Px              per-pixel state, computed once per output pixel
//   Px  src.pixel(long long nb)   from the batch index
//   Row<T> src.row(Px, int r)     the input row r, in the *padded* row
//                                 coordinates where output row oh reads rows
//                                 oh*s .. oh*s+k-1: its column-0 address and
//                                 column stride, or a null address where the
//                                 padded input holds zeros there (padding, an
//                                 absent halo, overhang, a pixel past the end:
//                                 any r < 0)
//   int src.w, src.pad            the width and the zero columns on each side
//   bool src.vec16()  (host)      every row base and stride is 16-byte aligned
//
// What it computes: y[n,oh,ow,co] = T(T(sum_{ky,kx,ci} in[n, oh*s+ky,
//   ow*s+kx, ci] * w[ky,kx,ci,co]) + bias[co]): the f32 sum is rounded to the
//   output type T (f32 or bf16) and the bias added in T, the order of the
//   reference (JAX models/layers.py: conv2d and the Pallas kernels' wrappers
//   round the conv output, then add the bias).
//
// Bound on an H100 SXM: every dense VGG-16 and ViT-L/16 layer does 2*k*k*Cin
// FLOPs per output element against a few bytes moved per element (hundreds
// of FLOP/byte), so it is bounded by operations: in float32 by the 3xTF32
// rate, a third of the TF32 tensor-core peak (495 / 3 = 165 TFLOP/s; 67
// TFLOP/s on the CUDA cores' FMAs), in bf16 by 989 TFLOP/s; the HBM bytes at
// 3.35 TB/s are 10-100x below that.  The depthwise branch (groups == Cin ==
// Cout) does 2*k*k FLOPs per output against about two elements moved (an
// input read, an output written: 2-25 FLOP/byte in float32), so it is bounded
// by bytes at 3.35 TB/s.
//
// Design of the implicit GEMM (dense convs).  M = N*Ho*Wo output pixels,
// N = Cout, K = k*k*Cin in HWIO order, so
// the weights are the row-major [K, Cout] B matrix as they lie.  A 256-thread
// block owns a 128-pixel x 64-channel output tile; its eight warps each own
// 32 x 32 of it.
//  * K steps.  In HWIO order the K rows of one tap row ky -- all (kx, ci) --
//    are a run of k*Cin, and so are a pixel's inputs along that row: k*Cin
//    consecutive NHWC elements when the column stride is Cin.  Each K step is
//    one tap row and a chunk of BK = 32 of its run.  A pixel's row is
//    resolved by the source once per tap row (K1: batch base, row, padding;
//    K2: top halo / shard / bottom halo / zero), then every copy of the step
//    only checks its column against the width padding.
//  * Copies.  A and B tiles go to a ring of 3 shared-memory stages with
//    cp.async, so the next two steps' loads are in flight while a step
//    multiplies.  Padding, an absent halo and the ragged M/N/K edges are
//    copies of src-size 0, which zero-fill: no branch and no memory read.
//    The 16-byte copies need every row base and stride 16-byte aligned and
//    Cin (for A) or Cout (for B) a multiple of 16 bytes; the launcher picks
//    the 4-byte (f32) or element-wise (bf16, synchronous) variant for an
//    operand that is not, before the launch (conv1_1 and the ViT patch embed
//    have Cin = 3; VGG-NP's filter slices have Cout 13, 19, 26, ... 154).
//  * Products.  mma.sync on the tensor cores: float32 as 3xTF32 (x = hi + lo,
//    both TF32, and a_lo*b_hi + a_hi*b_lo + a_hi*b_hi accumulated in f32,
//    about 2^-21 relative per product: float32 accuracy; a fresh partial
//    per 8-deep K slice, see mma_stage); bf16 as m16n8k16
//    with exact products.  Stage rows are padded (A by 16 bytes, B by 8
//    elements) so the fragment reads hit 32 distinct banks.
//  * Split-K.  When the tiles leave the card's two blocks per SM mostly idle
//    (VGG's conv4/conv5 slots and shards, the 1-row fix-up convs, ViT's
//    row-split 1x1 convs) the K steps are cut into S contiguous ranges, one
//    per grid z.  S is a pure function of (M, Cout, k, Cin, SM count), so a
//    shape always sums in the same order.  Each range writes f32 partials to
//    a workspace, and a second kernel adds the S partials in order z = 0..S-1
//    and runs the epilogue: no atomics, bit-identical from run to run.  With
//    S = 1 the main kernel runs the epilogue itself.
// wgmma and TMA are not used: 3xTF32 splits both operands in registers, which
// wgmma (B read from shared memory as it lies) does not allow.
//
// Design of the depthwise branch (dwconv2d; w [k,k,1,C]).  It is bound by
// bytes, so the design reads each input element from HBM about once and
// keeps 16-byte loads in flight:
//  * Block tile.  A block owns one image, TH x TW output pixels and a slab
//    of CB channels: one 128-byte line per pixel (32 f32 / 64 bf16; fewer
//    when C is smaller, 16 bytes per channel vector).  The grid is direct
//    (one block per tile and slab); its index math is 32-bit, once per block.
//  * Staging.  The block resolves each of its ((TH-1)*s+k) input rows once
//    through the source (Src::row, into a row table in shared memory), then
//    copies the ((TH-1)*s+k) x ((TW-1)*s+k) x CB input tile and the k*k x CB
//    weights of the slab into shared memory with cp.async.  Padding, an
//    absent halo and the ragged row / column / channel edges are copies of
//    src-size 0, which zero-fill.  16-byte copies need every row base and
//    stride 16-byte aligned and C a multiple of 16 bytes; otherwise the
//    launcher picks 4-byte cp.async (f32) or element copies (bf16) before
//    the launch, with the same tile and the same sum.
//  * Threads.  Each thread owns one 16-byte channel vector (4 f32 / 8 bf16
//    channels) x R = 4 consecutive outputs along W, with R x vector f32
//    accumulators in registers.  For each tap row it holds the row's k
//    weight vectors and streams the (R-1)*s+k input vectors of its window
//    from shared memory once, each feeding the outputs whose taps it is.
//  * The sum is the reference's: from 0.f, ky outer, kx inner, one
//    fmaf(x, w, acc) per tap in f32 (taps outside the input read the
//    staged zeros), then finish<T>.  Only where the data lives and which
//    thread computes which output differ from a per-element loop, so the
//    output does not depend on the tile, and in bf16 (exact products) it is
//    bit-equal to the plain version conv2d_ref.
//  * Parameters.  (TH, TW) is a pure function of the shape (k, s, C, dtype,
//    Ho, Wo) (dw_tile), so a shape always launches the same way: the tile
//    of at most 256 threads and kDwSmemCap bytes that costs the least over
//    the map, counting the staged pixels (halo and ragged tiles) and the
//    shared-memory reads of the outputs computed.  Measured on the card and
//    kept out: 8 outputs a thread for k 3 / 5, a register cap of 3 or 4
//    blocks an SM, and persistent blocks staging the next tile into a second
//    buffer while computing one (each slower in float32 on EfficientNet-B7's
//    calls: PERF.md §6).
//    The window lives in registers for the (k, s) the vision models use
//    (3 / 5 at stride 1 / 2, 7 at stride 1); any other (k, s) reads each tap
//    from shared memory (K = S = 0).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

#include "sm90_ops.cuh"

namespace conv_igemm {

struct Shape {
  int n, cin, cout, k, stride;
  int ho, wo;  // output [n, ho, wo, cout], contiguous
};

template <typename T>
struct Row {
  const T* p;     // column 0 of the row; null: a row of zeros
  long long sw;   // column stride, in elements
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The epilogue, in the reference's order: round the f32 sum to T, add the bias in T.
template <typename T>
__device__ __forceinline__ T finish(float acc, const T* bias, int col) {
  T v = from_f32<T>(acc);
  if (bias != nullptr) v = from_f32<T>(to_f32(v) + to_f32(bias[col]));
  return v;
}

constexpr int kThreads = 256;
constexpr int BM = 128;  // output pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 32;   // K rows per step (a chunk of one tap row's run)
constexpr int kStages = 3;
constexpr int kBlocksPerSM = 2;       // resident blocks the split count aims to fill
constexpr int kMinStepsPerSplit = 4;  // a split walks at least this many steps
constexpr int kMaxSplits = 32;
constexpr int kPastEnd = -(1 << 30);  // row of a pixel past the last one: reads zero

template <typename T>
struct Tile {
  static constexpr int VEC = 16 / sizeof(T);               // elements per 16-byte copy
  static constexpr int AS = BK + VEC;                       // A row stride (+16 bytes)
  static constexpr int BS = BN + 8;                         // B row stride
  static constexpr int A_ELEMS = BM * AS;
  static constexpr int STAGE = A_ELEMS + BK * BS;
  static constexpr int SMEM = kStages * STAGE * (int)sizeof(T);
};
// A rows of 36 f32 / 40 bf16 and B rows of 72: every fragment read of a warp
// falls on 32 distinct banks (or on one word, for pairs of bf16 lanes).
static_assert(Tile<float>::AS == 36 && Tile<__nv_bfloat16>::AS == 40, "A padding");
static_assert((Tile<float>::A_ELEMS * 4) % 16 == 0 && (Tile<__nv_bfloat16>::A_ELEMS * 2) % 16 == 0,
              "stage parts 16-byte aligned");

// K steps of a conv: k tap rows, each ceil(k*Cin / BK) chunks of its run.
__host__ __device__ inline int steps_per_row(int k, int cin) { return (k * cin + BK - 1) / BK; }

// The number of K ranges (grid z) for M pixels x Cout channels: as many as
// fill kBlocksPerSM blocks per SM in one wave, with at least
// kMinStepsPerSplit steps each, at most kMaxSplits; 1 when the tiles fill the card.
inline int split_count(long long m, int cout, int k, int cin, int sms) {
  const long long tiles = ((m + BM - 1) / BM) * ((cout + BN - 1) / BN);
  const long long fill = (long long)kBlocksPerSM * sms / std::max(tiles, 1LL);
  const long long most = (long long)k * steps_per_row(k, cin) / kMinStepsPerSplit;
  return (int)std::max(1LL, std::min({fill, most, (long long)kMaxSplits}));
}

// One element global -> shared: an asynchronous 4-byte copy for f32; for
// bf16 (no 2-byte cp.async) a predicated load and store.
__device__ __forceinline__ void copy1(float* dst, const float* src, bool ok) {
  sm90::cp_async4(dst, src, ok);
}
__device__ __forceinline__ void copy1(__nv_bfloat16* dst, const __nv_bfloat16* src, bool ok) {
  __nv_bfloat16 v = __float2bfloat16(0.f);
  if (ok) v = *src;
  *dst = v;
}

// x = hi + lo, both TF32: the two halves of the 3xTF32 product.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = sm90::cvt_tf32(x);
  lo = sm90::cvt_tf32(x - __uint_as_float(hi));
}

// One stage's products for a warp's 32 x 32 tile, float32 as 3xTF32.  The
// tensor cores add to the accumulator truncating toward zero (sm90_ops.cuh),
// so each 8-deep K slice goes to a fresh partial sum -- the small terms
// (a_lo*b_hi, a_hi*b_lo, ~2^-11 of the big one) first, then a_hi*b_hi -- and
// is added to the running sum with a rounded f32 add.  So no big term is
// truncated into a partial that already holds other big terms: a partial
// per 32-deep stage biased every output toward zero by ~1.8e-7 of
// sum |x w|, which EfficientNet-B7's batch norms amplified past DEPTH_RTOL
// (ROADMAP.md §3); a partial per slice cuts the bias ~5x.
__device__ __forceinline__ void mma_stage(const float* As, const float* Bs, float acc[2][4][4],
                                          int wm, int wn, int g, int t) {
  constexpr int AS = Tile<float>::AS, BS = Tile<float>::BS;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 8) {
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const float* a = As + (wm * 32 + mi * 16 + g) * AS + kk + t;
      split_tf32(a[0], ah[mi][0], al[mi][0]);
      split_tf32(a[8 * AS], ah[mi][1], al[mi][1]);
      split_tf32(a[4], ah[mi][2], al[mi][2]);
      split_tf32(a[8 * AS + 4], ah[mi][3], al[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const float* b = Bs + (kk + t) * BS + wn * 32 + ni * 8 + g;
      split_tf32(b[0], bh[ni][0], bl[ni][0]);
      split_tf32(b[4 * BS], bh[ni][1], bl[ni][1]);
    }
    // per 8-deep K slice a fresh partial: the small terms, then the big one
    float part[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mi][ni][e] = 0.f;
        sm90::mma_tf32(part[mi][ni], al[mi], bh[ni]);
      }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) sm90::mma_tf32(part[mi][ni], ah[mi], bl[ni]);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) sm90::mma_tf32(part[mi][ni], ah[mi], bh[ni]);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
  }
}

// The same for bf16: m16n8k16, exact products, straight into the running
// sum (its truncation, ~2^-23 of |acc| per instruction, is far below bf16's
// rounding of the output).
__device__ __forceinline__ uint32_t bf16_pair(const __nv_bfloat16* lo, const __nv_bfloat16* hi) {
  return uint32_t(*reinterpret_cast<const uint16_t*>(lo)) |
         (uint32_t(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

__device__ __forceinline__ void mma_stage(const __nv_bfloat16* As, const __nv_bfloat16* Bs,
                                          float acc[2][4][4], int wm, int wn, int g, int t) {
  constexpr int AS = Tile<__nv_bfloat16>::AS, BS = Tile<__nv_bfloat16>::BS;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t af[2][4], bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const __nv_bfloat16* a = As + (wm * 32 + mi * 16 + g) * AS + kk + 2 * t;
      af[mi][0] = *reinterpret_cast<const uint32_t*>(a);
      af[mi][1] = *reinterpret_cast<const uint32_t*>(a + 8 * AS);
      af[mi][2] = *reinterpret_cast<const uint32_t*>(a + 8);
      af[mi][3] = *reinterpret_cast<const uint32_t*>(a + 8 * AS + 8);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const __nv_bfloat16* b = Bs + (kk + 2 * t) * BS + wn * 32 + ni * 8 + g;
      bf[ni][0] = bf16_pair(b, b + BS);
      bf[ni][1] = bf16_pair(b + 8 * BS, b + 9 * BS);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) sm90::mma_bf16(acc[mi][ni], af[mi], bf[ni]);
  }
}

// The implicit GEMM over the K steps of range blockIdx.z of gridDim.z.  VA /
// VB: A / B copied as 16-byte vectors (else element by element).  With
// gridDim.z > 1 it writes f32 partials to ws[z][M][Cout], else y.
template <typename T, typename Src, bool VA, bool VB>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
conv2d_igemm(Src src, const T* __restrict__ wt, const T* __restrict__ bias,
             T* __restrict__ y, float* __restrict__ ws, Shape a) {
  using TL = Tile<T>;
  T* smem = reinterpret_cast<T*>(sm90::dynamic_smem());
  const int tid = threadIdx.x;
  const long long M = (long long)a.n * a.ho * a.wo;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int run = a.k * a.cin;  // K rows of one tap row
  const int per_row = steps_per_row(a.k, a.cin);
  const int nsteps = a.k * per_row;
  const int s_begin = (int)((long long)nsteps * blockIdx.z / gridDim.z);
  const int s_end = (int)((long long)nsteps * (blockIdx.z + 1) / gridDim.z);

  // A: this thread copies half `half` of the step's BK elements of pixel a_row.
  const int a_row = tid / 2, half = tid % 2;
  typename Src::Px px;
  int r0, q0;
  {
    const long long m = m0 + a_row;
    if (m < M) {
      const int ow = (int)(m % a.wo);
      const long long t = m / a.wo;
      px = src.pixel(t / a.ho);
      r0 = (int)(t % a.ho) * a.stride;
      q0 = ow * a.stride - src.pad;
    } else {
      px = src.pixel(0);
      r0 = kPastEnd;
      q0 = 0;
    }
  }
  int row_ky = -1;  // the tap row `row` was resolved for
  Row<T> row{nullptr, 0};

  // Issue the copies of K step `st` into stage `stage`.
  auto load = [&](int stage, int st) {
    const int ky = st / per_row;
    const int j0 = (st - ky * per_row) * BK;  // offset in the tap row's run
    if (ky != row_ky) {  // once per pixel and tap row
      row = src.row(px, r0 + ky);
      row_ky = ky;
    }
    T* As = smem + stage * TL::STAGE + a_row * TL::AS;
    T* Bs = smem + stage * TL::STAGE + TL::A_ELEMS;
    if constexpr (VA) {
      constexpr int CH = BK / TL::VEC / 2;  // 16-byte copies per thread
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int e = (half * CH + i) * TL::VEC;
        const int j = j0 + e;
        const int kx = j / a.cin, iw = q0 + kx;
        const bool ok = j < run && row.p != nullptr && iw >= 0 && iw < src.w;
        const T* g = wt;  // any valid address: nothing is read when !ok
        if (ok) g = row.p + iw * row.sw + (j - kx * a.cin);
        sm90::cp_async16(As + e, g, ok);
      }
    } else {
      constexpr int EL = BK / 2;
      int j = j0 + half * EL;
      int kx = j / a.cin, c = j - kx * a.cin;
#pragma unroll
      for (int i = 0; i < EL; ++i, ++j) {
        const int iw = q0 + kx;
        const bool ok = j < run && row.p != nullptr && iw >= 0 && iw < src.w;
        const T* g = wt;
        if (ok) g = row.p + iw * row.sw + c;
        copy1(As + half * EL + i, g, ok);
        if (++c == a.cin) {
          c = 0;
          ++kx;
        }
      }
    }
    const long long kb = (long long)ky * run + j0;  // the step's first weight row
    if constexpr (VB) {
      constexpr int CPR = BN / TL::VEC;        // 16-byte copies per B row
      constexpr int RPP = kThreads / CPR;      // B rows per pass
      const int bc = (tid % CPR) * TL::VEC, br = tid / CPR;
#pragma unroll
      for (int i = 0; i < BK / RPP; ++i) {
        const int r = br + i * RPP;
        const bool ok = j0 + r < run && n0 + bc < a.cout;
        const T* g = wt;
        if (ok) g = wt + (kb + r) * a.cout + n0 + bc;
        sm90::cp_async16(Bs + r * TL::BS + bc, g, ok);
      }
    } else {
      const int bc = tid % BN, br = tid / BN;
#pragma unroll
      for (int i = 0; i < BK / (kThreads / BN); ++i) {
        const int r = br + i * (kThreads / BN);
        const bool ok = j0 + r < run && n0 + bc < a.cout;
        const T* g = wt;
        if (ok) g = wt + (kb + r) * a.cout + n0 + bc;
        copy1(Bs + r * TL::BS + bc, g, ok);
      }
    }
  };

  const int lane = tid % 32, warp = tid / 32;
  const int wm = warp % 4, wn = warp / 4, g = lane / 4, t = lane % 4;
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int nloc = s_end - s_begin;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nloc) load(i, s_begin + i);
    sm90::cp_async_commit();  // an empty group keeps the count uniform
  }
  for (int it = 0; it < nloc; ++it) {
    sm90::cp_async_wait<kStages - 2>();  // step `it` has landed (this thread's copies)
    __syncthreads();                     // ... everyone's; and step it-1's stage is free
    const int nx = it + kStages - 1;
    if (nx < nloc) load(nx % kStages, s_begin + nx);
    sm90::cp_async_commit();
    const T* st = smem + (it % kStages) * TL::STAGE;
    mma_stage(st, st + TL::A_ELEMS, acc, wm, wn, g, t);
  }

  float* part = gridDim.z > 1 ? ws + (long long)blockIdx.z * M * a.cout : nullptr;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long m = m0 + wm * 32 + mi * 16 + g + (e / 2) * 8;
        const int col = n0 + wn * 32 + ni * 8 + 2 * t + e % 2;
        if (m < M && col < a.cout) {
          if (part != nullptr)
            part[m * a.cout + col] = acc[mi][ni][e];
          else
            y[m * a.cout + col] = finish<T>(acc[mi][ni][e], bias, col);
        }
      }
}

// Split-K's second pass: y = epilogue(sum over z = 0..S-1 of ws[z]), in that order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
splitk_reduce(const float* __restrict__ ws, const T* __restrict__ bias, T* __restrict__ y,
              long long mn, int cout, int splits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int z = 0; z < splits; ++z) v += ws[z * mn + i];
    y[i] = finish<T>(v, bias, (int)(i % cout));
  }
}

// ---- The depthwise branch (header: "Design of the depthwise branch") -------
// ConvNeXt's 7x7 and EfficientNet's 3x3 / 5x5 depthwise convs
// (models/convnext.py, models/efficientnet.py).

constexpr int kDwR = 4;                 // outputs of a thread along W
constexpr int kDwMaxThreads = 256;      // 8 channel vectors x 32 output groups, at most
constexpr int kDwMaxGw = 5;             // thread groups along a tile row, at most
constexpr int kDwMaxTh = 16;            // output rows of a tile, at most
constexpr int kDwSmemCap = 100 * 1024;  // shared memory of a block, at most (unless one row needs more)

// How a depthwise conv launches (dw_tile): a pure function of the shape
// (k, s, C, dtype, Ho, Wo) and the copy width.
struct DwTile {
  int th, tw;     // output rows x columns of a block
  int cv;         // 16-byte channel vectors per pixel of a slab (CB = cv * VEC)
  int ih, iw;     // staged input rows x columns: (th-1)*s+k x (tw-1)*s+k
  int threads;    // cv * th * tw / kDwR
  int smem;       // bytes: the input tile, the weights, the row table
  int copy;       // bytes per staging copy: 16, or sizeof(T) (4-byte cp.async / element)
};

// The tile of a Ho x Wo output: gw thread groups of R = kDwR outputs along
// W (gw <= kDwMaxGw) by TH rows (<= kDwMaxTh and the block's threads), the
// pair with the least cost over the whole map -- twice the staged input
// pixels (the L2 -> shared copies, halo and ragged tiles included) plus the
// outputs computed (ragged ones too) times the shared-memory reads each
// takes, ((R-1)*s + 2k) * k / R, all per channel vector -- among those
// within kDwSmemCap bytes; on a tie, the more threads.
template <typename T>
DwTile dw_tile(int k, int s, int c, int ho, int wo, bool vec16) {
  constexpr int VEC = Tile<T>::VEC, R = kDwR;
  DwTile d{};
  const int vecs = (c + VEC - 1) / VEC;
  d.cv = vecs >= 8 ? 8 : vecs > 2 ? 4 : vecs;  // a power of two covering C, at most 8
  const auto smem = [&](int ih, int iw) { return (ih * iw + k * k) * d.cv * 16 + ih * (int)sizeof(Row<T>); };
  const long long reads = (long long)((R - 1) * s + 2 * k) * k;  // per output, times R
  const int gx = (wo + R - 1) / R;                               // groups a full output row takes
  long long best = LLONG_MAX;
  for (int gw = 1; gw <= std::min(kDwMaxGw, gx); ++gw) {
    const int tw = gw * R, iw = (tw - 1) * s + k;
    for (int th = 1; th <= std::min({kDwMaxTh, kDwMaxThreads / d.cv / gw, ho}); ++th) {
      const int ih = (th - 1) * s + k;
      if (smem(ih, iw) > kDwSmemCap && gw * th > 1) break;  // (one row of one group: taken)
      const long long tiles = (long long)((gx + gw - 1) / gw) * ((ho + th - 1) / th);
      const long long cost = tiles * (2LL * R * ih * iw + (long long)th * tw * reads);
      if (cost < best || (cost == best && th * gw > d.th * d.tw / R)) {
        best = cost;
        d.th = th;
        d.tw = tw;
      }
    }
  }
  d.ih = (d.th - 1) * s + k;
  d.iw = (d.tw - 1) * s + k;
  d.smem = smem(d.ih, d.iw);
  d.threads = d.cv * d.th * d.tw / R;
  d.copy = vec16 ? 16 : (int)sizeof(T);
  return d;
}

// 16 bytes of shared memory as f32 values (bf16: exact, by shifts).
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[8]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  const uint32_t u[4] = {__float_as_uint(q.x), __float_as_uint(q.y), __float_as_uint(q.z),
                         __float_as_uint(q.w)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);  // the lower-indexed element: the low half
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// VEC values of T to 16 bytes of global memory.
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = float4{v[0], v[1], v[2], v[3]};
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const __nv_bfloat16 (&v)[8]) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) u[i] = bf16_pair(&v[2 * i], &v[2 * i + 1]);
  *reinterpret_cast<float4*>(p) =
      float4{__uint_as_float(u[0]), __uint_as_float(u[1]), __uint_as_float(u[2]), __uint_as_float(u[3])};
}

// One depthwise conv tile (the header's design).  K, S: the kernel size and
// stride the register window is unrolled for, or 0 / 0 for any (a.k, a.stride).
template <typename T, typename Src, int K, int S>
__global__ void __launch_bounds__(kDwMaxThreads)
dwconv2d(Src src, const T* __restrict__ wt, const T* __restrict__ bias, T* __restrict__ y,
         Shape a, DwTile d) {
  constexpr int VEC = Tile<T>::VEC;
  constexpr int R = kDwR;  // outputs of a thread along W
  const int k = K ? K : a.k, s = S ? S : a.stride;
  const int cb = d.cv * VEC;  // channels of a slab, and elements of a staged pixel
  T* tile = reinterpret_cast<T*>(sm90::dynamic_smem());
  T* wsm = tile + d.ih * d.iw * cb;
  Row<T>* rows = reinterpret_cast<Row<T>*>(wsm + k * k * cb);
  const int tid = threadIdx.x;

  // the block's image, output tile and slab
  const int tiles_w = (a.wo + d.tw - 1) / d.tw, tiles_h = (a.ho + d.th - 1) / d.th;
  const int tx = blockIdx.x % tiles_w, t_rest = blockIdx.x / tiles_w;
  const int ty = t_rest % tiles_h, n = t_rest / tiles_h;
  const int oh0 = ty * d.th, ow0 = tx * d.tw, c0 = blockIdx.y * cb;
  const int q0 = ow0 * s - src.pad;  // the input column of staged column 0

  for (int r = tid; r < d.ih; r += blockDim.x) rows[r] = src.row(src.pixel(n), oh0 * s + r);  // once a row
  __syncthreads();
  if (d.copy == 16) {
    for (int i = tid; i < d.ih * d.iw * d.cv; i += blockDim.x) {
      const int v = i % d.cv, p = i / d.cv;
      const Row<T> row = rows[p / d.iw];
      const int iw = q0 + p % d.iw, c = c0 + v * VEC;
      const bool ok = row.p != nullptr && iw >= 0 && iw < src.w && c < a.cout;
      const T* g = wt;  // any valid address: nothing is read when !ok
      if (ok) g = row.p + iw * row.sw + c;
      sm90::cp_async16(tile + i * VEC, g, ok);
    }
    for (int i = tid; i < k * k * d.cv; i += blockDim.x) {
      const int c = c0 + (i % d.cv) * VEC;
      const bool ok = c < a.cout;
      const T* g = wt;
      if (ok) g = wt + (long long)(i / d.cv) * a.cout + c;
      sm90::cp_async16(wsm + i * VEC, g, ok);
    }
  } else {
    for (int i = tid; i < d.ih * d.iw * cb; i += blockDim.x) {
      const int p = i / cb;
      const Row<T> row = rows[p / d.iw];
      const int iw = q0 + p % d.iw, c = c0 + i % cb;
      const bool ok = row.p != nullptr && iw >= 0 && iw < src.w && c < a.cout;
      const T* g = wt;
      if (ok) g = row.p + iw * row.sw + c;
      copy1(tile + i, g, ok);
    }
    for (int i = tid; i < k * k * cb; i += blockDim.x) {
      const int c = c0 + i % cb;
      const bool ok = c < a.cout;
      const T* g = wt;
      if (ok) g = wt + (long long)(i / cb) * a.cout + c;
      copy1(wsm + i, g, ok);
    }
  }
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  __syncthreads();

  // this thread: channel vector v of the slab, outputs (orow, ocol .. ocol+R-1) of the tile
  const int v = tid % d.cv, grp = tid / d.cv;
  const int orow = grp / (d.tw / R), ocol = grp % (d.tw / R) * R;
  const T* xin = tile + (orow * s * d.iw + ocol * s) * cb + v * VEC;  // window column 0 of tap row 0
  const T* win = wsm + v * VEC;
  float acc[R][VEC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
  if constexpr (K > 0) {
    constexpr int W = (R - 1) * S + K;  // the window's input columns
#pragma unroll
    for (int ky = 0; ky < K; ++ky) {
      float w[K][VEC];
#pragma unroll
      for (int kx = 0; kx < K; ++kx) load_vec(win + (ky * K + kx) * cb, w[kx]);
      const T* xr = xin + ky * d.iw * cb;
#pragma unroll
      for (int j = 0; j < W; ++j) {  // window column j is tap kx = j - r*S of output r
        float xv[VEC];
        load_vec(xr + j * cb, xv);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int kx = j - r * S;
          if (kx >= 0 && kx < K) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(xv[e], w[kx][e], acc[r][e]);
          }
        }
      }
    }
  } else {
    for (int ky = 0; ky < k; ++ky)
      for (int kx = 0; kx < k; ++kx) {
        float w[VEC];
        load_vec(win + (ky * k + kx) * cb, w);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float xv[VEC];
          load_vec(xin + (ky * d.iw + r * s + kx) * cb, xv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(xv[e], w[e], acc[r][e]);
        }
      }
  }

  // the epilogue, finish<T> per element; 16-byte stores with 16-byte copies
  const int oh = oh0 + orow, c = c0 + v * VEC;
  T bv[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) bv[e] = from_f32<T>(0.f);
  if (bias != nullptr) {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      if (c + e < a.cout) bv[e] = bias[c + e];
  }
  const T* bp = bias != nullptr ? bv : nullptr;
  T* yrow = y + ((long long)n * a.ho + oh) * a.wo * a.cout + c;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int ow = ow0 + ocol + r;
    if (oh >= a.ho || ow >= a.wo) continue;
    T out[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[e] = finish<T>(acc[r][e], bp, e);
    T* dst = yrow + (long long)ow * a.cout;
    if (d.copy == 16) {
      if (c < a.cout) store_vec(dst, out);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (c + e < a.cout) dst[e] = out[e];
    }
  }
}

// The SM count of `device` (the split count's input).
inline int sm_count(int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) return 1;
  return std::max(sms, 1);
}

// Whether the weights [K, Cout] can be copied as 16-byte vectors.
template <typename T>
bool vec16_weights(const void* w, int cout) {
  return reinterpret_cast<uintptr_t>(w) % 16 == 0 && cout % Tile<T>::VEC == 0;
}

// The gather variant of a conv: bit 0, A copied as 16-byte vectors; bit 1, B.
template <typename T, typename Src>
int gather_variant(const Src& src, const void* w, int cout) {
  return (src.vec16() ? 1 : 0) | (vec16_weights<T>(w, cout) ? 2 : 0);
}

// The depthwise launch shape of these operands: the tile of (k, s, C, T), with
// 16-byte copies when the source, the weights and the output allow them.
template <typename T, typename Src>
DwTile dw_config(const Src& src, const void* w, const void* y, int c, int k, int s, int ho, int wo) {
  const bool vec16 = src.vec16() && vec16_weights<T>(w, c) && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  return dw_tile<T>(k, s, c, ho, wo, vec16);
}

// A launch shape as the C interfaces report it (conv2d_dw_config); vec:
// channels per 16-byte vector.
inline void dw_describe(const DwTile& d, int vec, int* out) {
  const int v[7] = {d.copy, d.th, d.tw, kDwR, d.cv * vec, d.threads, d.smem};
  std::copy(v, v + 7, out);
}

template <typename T, typename Src, int K, int S>
cudaError_t launch_dw(const Src& src, const T* w, const T* bias, T* y, const Shape& a, const DwTile& d,
                      cudaStream_t stream) {
  if (d.smem > 48 * 1024) {  // refused past the card's 227 KB
    const cudaError_t err = cudaFuncSetAttribute(
        dwconv2d<T, Src, K, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, d.smem);
    if (err != cudaSuccess) return err;
  }
  const long long tiles = (long long)a.n * ((a.ho + d.th - 1) / d.th) * ((a.wo + d.tw - 1) / d.tw);
  const int cb = d.cv * Tile<T>::VEC, slabs = (a.cout + cb - 1) / cb;
  if (tiles > INT_MAX || slabs > 65535) return cudaErrorInvalidConfiguration;
  dwconv2d<T, Src, K, S><<<dim3((unsigned)tiles, (unsigned)slabs), d.threads, d.smem, stream>>>(
      src, w, bias, y, a, d);
  return cudaSuccess;
}

// The depthwise conv, its window unrolled for the vision models' (k, s).
template <typename T, typename Src>
cudaError_t launch_depthwise(const Src& src, const T* w, const T* bias, T* y, const Shape& a,
                             cudaStream_t stream) {
  const DwTile d = dw_config<T>(src, w, y, a.cout, a.k, a.stride, a.ho, a.wo);
  const int k = a.k, s = a.stride;
  if (k == 3 && s == 1) return launch_dw<T, Src, 3, 1>(src, w, bias, y, a, d, stream);
  if (k == 3 && s == 2) return launch_dw<T, Src, 3, 2>(src, w, bias, y, a, d, stream);
  if (k == 5 && s == 1) return launch_dw<T, Src, 5, 1>(src, w, bias, y, a, d, stream);
  if (k == 5 && s == 2) return launch_dw<T, Src, 5, 2>(src, w, bias, y, a, d, stream);
  if (k == 7 && s == 1) return launch_dw<T, Src, 7, 1>(src, w, bias, y, a, d, stream);
  return launch_dw<T, Src, 0, 0>(src, w, bias, y, a, d, stream);
}

template <typename T, typename Src, bool VA, bool VB>
cudaError_t launch_igemm(const Src& src, const T* w, const T* bias, T* y, float* ws, int splits,
                         const Shape& a, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      conv2d_igemm<T, Src, VA, VB>, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<T>::SMEM);
  if (err != cudaSuccess) return err;
  const long long M = (long long)a.n * a.ho * a.wo;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((a.cout + BN - 1) / BN), (unsigned)splits);
  conv2d_igemm<T, Src, VA, VB><<<grid, kThreads, Tile<T>::SMEM, stream>>>(src, w, bias, y, ws, a);
  return cudaSuccess;
}

// Enqueue one conv on `stream`.  `splits` must be split_count(...) of the
// shape (the caller allocated `ws` for it: splits * M * Cout floats when
// splits > 1); returns an error for a refused configuration, and the caller
// also reads cudaGetLastError().
template <typename T, typename Src>
cudaError_t launch(const Src& src, const void* w, const void* bias, void* y, void* ws, int splits,
                   const Shape& a, bool depthwise, cudaStream_t stream) {
  const T* wp = static_cast<const T*>(w);
  const T* bp = static_cast<const T*>(bias);
  T* yp = static_cast<T*>(y);
  if (depthwise) return launch_depthwise<T>(src, wp, bp, yp, a, stream);
  if (splits < 1 || (splits > 1 && ws == nullptr)) return cudaErrorInvalidValue;
  float* wsp = static_cast<float*>(ws);
  cudaError_t err;
  switch (gather_variant<T>(src, w, a.cout)) {
    case 3: err = launch_igemm<T, Src, true, true>(src, wp, bp, yp, wsp, splits, a, stream); break;
    case 1: err = launch_igemm<T, Src, true, false>(src, wp, bp, yp, wsp, splits, a, stream); break;
    case 2: err = launch_igemm<T, Src, false, true>(src, wp, bp, yp, wsp, splits, a, stream); break;
    default: err = launch_igemm<T, Src, false, false>(src, wp, bp, yp, wsp, splits, a, stream);
  }
  if (err != cudaSuccess || splits == 1) return err;
  const long long mn = (long long)a.n * a.ho * a.wo * a.cout;
  const long long blocks = std::min<long long>((mn + kThreads - 1) / kThreads, 1LL << 16);
  splitk_reduce<T><<<(unsigned)blocks, kThreads, 0, stream>>>(wsp, bp, yp, mn, a.cout, splits);
  return cudaSuccess;
}

}  // namespace conv_igemm
