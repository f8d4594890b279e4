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
// Bound on an H100 SXM: every VGG-16 and ViT-L/16 layer does 2*k*k*Cin FLOPs
// per output element against a few bytes moved per element (hundreds of
// FLOP/byte), so it is bounded by operations: in float32 by the 3xTF32 rate,
// a third of the TF32 tensor-core peak (495 / 3 = 165 TFLOP/s; 67 TFLOP/s on
// the CUDA cores' FMAs), in bf16 by 989 TFLOP/s; the HBM bytes at 3.35 TB/s
// are 10-100x below that.
//
// Design.  M = N*Ho*Wo output pixels, N = Cout, K = k*k*Cin in HWIO order, so
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
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
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

// Depthwise branch (w [k,k,1,C], cin == cout): one thread per output element,
// neighbouring threads on neighbouring channels (coalesced NHWC reads),
// grid-stride over the output; f32 FMAs.  ConvNeXt's 7x7 and EfficientNet's
// 3x3 / 5x5 depthwise convs (models/convnext.py, models/efficientnet.py).
template <typename T, typename Src>
__global__ void __launch_bounds__(kThreads)
dwconv2d(Src src, const T* __restrict__ wt, const T* __restrict__ bias,
         T* __restrict__ y, Shape a) {
  const long long total = (long long)a.n * a.ho * a.wo * a.cout;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(idx % a.cout);
    long long t = idx / a.cout;
    const int ow = (int)(t % a.wo);
    t /= a.wo;
    const int oh = (int)(t % a.ho);
    const typename Src::Px px = src.pixel(t / a.ho);
    float acc = 0.f;
    for (int ky = 0; ky < a.k; ++ky) {
      const Row<T> row = src.row(px, oh * a.stride + ky);
      for (int kx = 0; kx < a.k; ++kx) {
        const int iw = ow * a.stride + kx - src.pad;
        float v = 0.f;
        if (row.p != nullptr && iw >= 0 && iw < src.w) v = to_f32(row.p[iw * row.sw + c]);
        acc = fmaf(v, to_f32(wt[(long long)(ky * a.k + kx) * a.cout + c]), acc);
      }
    }
    y[idx] = finish<T>(acc, bias, c);
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
  if (depthwise) {
    const long long total = (long long)a.n * a.ho * a.wo * a.cout;
    const long long blocks = std::min<long long>((total + kThreads - 1) / kThreads, 1LL << 20);
    dwconv2d<T, Src><<<(unsigned)blocks, kThreads, 0, stream>>>(src, wp, bp, yp, a);
    return cudaSuccess;
  }
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
