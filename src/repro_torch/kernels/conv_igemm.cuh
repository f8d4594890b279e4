// The convolution core shared by the port's two conv kernels (K1 conv2d.cu,
// K2 halo_conv.cu): an implicit GEMM on NHWC x HWIO -> NHWC with f32
// accumulation, and a depthwise branch.  The kernels differ only in where an
// input row comes from, so the core is a template over an input source `Src`:
//
//   typename Src::Px            per-pixel state, computed once per output pixel
//   Px  src.pixel(long long nb) from the batch index
//   float src.load(Px, int r, int q, int c, bool valid)
//                               input value at row r, column q, channel c, in
//                               the *padded* coordinates where output pixel
//                               (oh, ow) reads rows oh*s .. oh*s+k-1 and
//                               columns ow*s .. ow*s+k-1; zero wherever the
//                               padded input holds padding, and zero unless
//                               `valid`.  Rows below zero (the sentinel of a
//                               pixel past the end) read 0.
//
// A source writes its load as `float v = 0; if (valid && in range) v = ...;
// return v;`, which the compiler predicates, so a thread's eight gathers of
// one K step are all in flight at once.  An early `return 0.f` instead made
// the compiler branch around each load, and the conv ran 1.6x slower on the
// H100 (PERF.md).
//
// What it computes: y[n,oh,ow,co] = bias[co] + sum_{ky,kx,ci}
//   in[n, oh*s+ky, ow*s+kx, ci] * w[ky,kx,ci,co]; f32 or bf16 in and out, the
// bias added to the f32 sum before the single output cast.
//
// Bound on an H100 SXM: at every VGG-16 layer the conv does 2*k*k*Cin FLOPs
// per output element against a few bytes per element moved (several hundred
// FLOP/byte), far above the f32 ridge of 67 TFLOP/s / 3.35 TB/s = 20 FLOP/byte,
// so it is bounded by operations: the float32 FMA rate of the CUDA cores.
//
// Design: M = N*Ho*Wo output pixels, N = Cout, K = k*k*Cin in HWIO order, so
// the weights are the row-major [K, Cout] B matrix as they lie.  Each
// 256-thread block owns a 128-pixel x 64-channel output tile and walks K in
// steps of 16: the A tile (pixels x K) is gathered through `Src::load`
// straight from the input -- overlapping rows are re-read, never stacked as
// tiles in device memory -- and the B tile is read from the weights; both go
// to shared memory as f32, and every thread accumulates an 8x4 register block
// with FMAs.  Ragged pixel/channel/K edges are masked.  Any Cin is taken
// (conv1_1 has Cin = 3), since the K index is decoded per element rather than
// loaded as 16-byte vectors.  Offsets are 64-bit.  Tensor cores (wgmma), TMA
// and multi-stage pipelines are left for later work: this is the correct,
// simple baseline.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace conv_igemm {

struct Shape {
  int n, cin, cout, k, stride;
  int ho, wo;  // output [n, ho, wo, cout], contiguous
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

constexpr int kThreads = 256;
constexpr int BM = 128;  // output pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 16;   // K step
constexpr int TM = 8;    // pixels per thread   (16 threads along M)
constexpr int TN = 4;    // channels per thread (16 threads along N)
static_assert(BM == 16 * TM && BN == 16 * TN, "16x16 thread grid");
constexpr int kPastEnd = -(1 << 30);  // row of a pixel past the last one: reads zero

template <typename T, typename Src>
__global__ void __launch_bounds__(kThreads)
conv2d_igemm(Src src, const T* __restrict__ wt, const T* __restrict__ bias,
             T* __restrict__ y, Shape a) {
  // +4 columns: spreads the column-wise A stores over more banks while
  // keeping every row 16-byte aligned for the float4 reads below.
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const long long M = (long long)a.n * a.ho * a.wo;
  const int K = a.k * a.k * a.cin;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A gather: this thread loads K column a_kk of rows a_r0 + i * A_STEP.
  constexpr int A_STEP = kThreads / BK;  // 16
  constexpr int A_ITERS = BM / A_STEP;   // 8
  const int a_kk = tid % BK;
  const int a_r0 = tid / BK;
  typename Src::Px a_px[A_ITERS];
  int a_r[A_ITERS], a_q[A_ITERS];
#pragma unroll
  for (int i = 0; i < A_ITERS; ++i) {
    const long long m = m0 + a_r0 + i * A_STEP;
    if (m < M) {
      const int ow = (int)(m % a.wo);
      const long long t = m / a.wo;
      const int oh = (int)(t % a.ho);
      a_px[i] = src.pixel(t / a.ho);
      a_r[i] = oh * a.stride;
      a_q[i] = ow * a.stride;
    } else {
      a_px[i] = src.pixel(0);
      a_r[i] = kPastEnd;
      a_q[i] = 0;
    }
  }

  // B load: this thread loads column b_col of K rows b_r0 + j * B_STEP.
  constexpr int B_STEP = kThreads / BN;  // 4
  constexpr int B_ITERS = BK / B_STEP;   // 4
  const int b_col = tid % BN;
  const int b_r0 = tid / BN;
  const int gcol = n0 + b_col;

  const int tx = tid % 16;  // channel group
  const int ty = tid / 16;  // pixel group
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int kidx = k0 + a_kk;
    const bool kval = kidx < K;
    int c = 0, ky = 0, kx = 0;
    if (kval) {  // K index -> (tap, input channel), HWIO order
      const int tap = kidx / a.cin;
      c = kidx - tap * a.cin;
      ky = tap / a.k;
      kx = tap - ky * a.k;
    }
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i)
      As[a_kk][a_r0 + i * A_STEP] = src.load(a_px[i], a_r[i] + ky, a_q[i] + kx, c, kval);
#pragma unroll
    for (int j = 0; j < B_ITERS; ++j) {
      const int kr = k0 + b_r0 + j * B_STEP;
      float v = 0.f;
      if (kr < K && gcol < a.cout) v = to_f32(wt[(long long)kr * a.cout + gcol]);
      Bs[b_r0 + j * B_STEP][b_col] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[TN] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty * TM + i;
    if (m >= M) continue;
    T* yrow = y + m * a.cout;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx * TN + j;
      if (col < a.cout) {
        float v = acc[i][j];
        if (bias != nullptr) v += to_f32(bias[col]);
        yrow[col] = from_f32<T>(v);
      }
    }
  }
}

// Depthwise branch (w [k,k,1,C], cin == cout): one thread per output element,
// neighbouring threads on neighbouring channels (coalesced NHWC reads),
// grid-stride over the output.
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
    for (int ky = 0; ky < a.k; ++ky)
      for (int kx = 0; kx < a.k; ++kx)
        acc = fmaf(src.load(px, oh * a.stride + ky, ow * a.stride + kx, c, true),
                   to_f32(wt[(long long)(ky * a.k + kx) * a.cout + c]), acc);
    if (bias != nullptr) acc += to_f32(bias[c]);
    y[idx] = from_f32<T>(acc);
  }
}

// Enqueue one conv on `stream`; the caller reads cudaGetLastError().
template <typename T, typename Src>
void launch(const Src& src, const void* w, const void* bias, void* y, const Shape& a,
            bool depthwise, cudaStream_t stream) {
  const T* wp = static_cast<const T*>(w);
  const T* bp = static_cast<const T*>(bias);
  T* yp = static_cast<T*>(y);
  if (depthwise) {
    const long long total = (long long)a.n * a.ho * a.wo * a.cout;
    const long long blocks = std::min<long long>((total + kThreads - 1) / kThreads, 1LL << 20);
    dwconv2d<T, Src><<<(unsigned)blocks, kThreads, 0, stream>>>(src, wp, bp, yp, a);
  } else {
    const long long M = (long long)a.n * a.ho * a.wo;
    const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((a.cout + BN - 1) / BN));
    conv2d_igemm<T, Src><<<grid, kThreads, 0, stream>>>(src, wp, bp, yp, a);
  }
}

}  // namespace conv_igemm
