// Direct 2-D convolution for Hopper (sm_90a): NHWC x HWIO -> NHWC, f32 accumulate.
//
// Replaces the Pallas TPU kernel K1, src/repro/kernels/conv2d/conv2d.py:
// _conv_kernel / conv2d_tiles, together with its wrapper conv2d/ops.py:
// conv2d_pallas (padding, row tiling, remainder slicing, bias).
//
// What it computes: y[n,oh,ow,co] = T(T(sum_{ky,kx,ci}
//   x[n, oh*s-p+ky, ow*s-p+kx, ci] * w[ky,kx,ci,co]) + bias[co]), out-of-range
// taps reading zero (the padding never exists in memory): the f32 sum is
// rounded to the output type, then the bias added, as conv2d_pallas does
// (ops.py l.82-83).  Depthwise (groups == Cin == Cout, w [k,k,1,C]) is a
// per-channel multiply-add.  f32 or bf16 in and out.
//
// Bound on the H100 (operations): 2*k*k*Cin*Cout FLOPs per output pixel at
// 165 TFLOP/s (3xTF32, float32) or 989 TFLOP/s (bf16), against HBM bytes of
// input, weights and output at 3.35 TB/s; at every VGG-16 / ViT-L/16 shape the
// operations take 10-100x longer than the bytes.
//
// The implicit-GEMM core -- tap-row K steps with each source row resolved
// once, cp.async stages, 3xTF32 / bf16 mma.sync, deterministic split-K for
// thin grids -- is ../conv_igemm.cuh, shared with the halo conv (K2).  This
// file supplies the input source: one tensor whose batch/row/column strides
// are arbitrary (row slices of a batch are not contiguous; only the channel
// axis must be dense), padded by `pad` zero rows and columns on every side.
// The overlapping rows that the TPU kernel materialises as a tile stack in
// HBM (_tile_rows) are just re-read.
#include <cstdint>

#include "../conv_igemm.cuh"

namespace {

template <typename T>
struct DenseRows {
  const T* x;
  long long sn, sh, sw;  // input strides, in elements; the channel stride is 1
  int h, w, pad;
  int cin;

  using Px = const T*;  // the pixel's batch base
  __device__ Px pixel(long long nb) const { return x + nb * sn; }
  __device__ conv_igemm::Row<T> row(Px p, int r) const {
    const int ih = r - pad;
    const T* q = nullptr;
    if (ih >= 0 && ih < h) q = p + ih * sh;
    return {q, sw};
  }
  bool vec16() const {
    constexpr int v = conv_igemm::Tile<T>::VEC;
    return reinterpret_cast<uintptr_t>(x) % 16 == 0 && sn % v == 0 && sh % v == 0 &&
           sw % v == 0 && cin % v == 0;
  }
};

template <typename T>
DenseRows<T> source(const void* x, long long sn, long long sh, long long sw, int h, int wd,
                    int pad, int cin) {
  return DenseRows<T>{static_cast<const T*>(x), sn, sh, sw, h, wd, pad, cin};
}

}  // namespace

// The split count of a conv of m output pixels (grid z of the core); the
// wrapper allocates splits * m * cout floats of workspace when it is > 1.
extern "C" int conv_splits(long long m, int cout, int k, int cin, int device) {
  return conv_igemm::split_count(m, cout, k, cin, conv_igemm::sm_count(device));
}

// The core's gather variant for these operands: bit 0, the input copied as
// 16-byte vectors (else element by element); bit 1, the weights.
extern "C" int conv2d_gather(const void* x, const void* w, int dtype, int cin, long long sn,
                             long long sh, long long sw, int cout) {
  if (dtype == 0)
    return conv_igemm::gather_variant<float>(source<float>(x, sn, sh, sw, 0, 0, 0, cin), w, cout);
  return conv_igemm::gather_variant<__nv_bfloat16>(
      source<__nv_bfloat16>(x, sn, sh, sw, 0, 0, 0, cin), w, cout);
}

// The depthwise branch's launch shape for these operands (C = cin = cout, the
// output allocated by the wrapper), into out[7]: bytes per staging copy (16;
// 4, f32 cp.async; 2, bf16 element copies), output tile rows, columns,
// outputs a thread along W, channels a slab, threads, shared memory bytes.
extern "C" void conv2d_dw_config(const void* x, const void* w, int dtype, int c, long long sn,
                                long long sh, long long sw, int k, int stride, int ho, int wo,
                                int* out) {
  const conv_igemm::DwTile d =
      dtype == 0 ? conv_igemm::dw_config<float>(source<float>(x, sn, sh, sw, 0, 0, 0, c), w, nullptr,
                                                c, k, stride, ho, wo)
                 : conv_igemm::dw_config<__nv_bfloat16>(
                       source<__nv_bfloat16>(x, sn, sh, sw, 0, 0, 0, c), w, nullptr, c, k, stride, ho, wo);
  conv_igemm::dw_describe(d, dtype == 0 ? 4 : 8, out);
}

// dtype: 0 = float32, 1 = bfloat16.  bias may be null.  ws: splits * M *
// cout floats (null when splits == 1), splits from conv_splits.  Returns the
// CUDA error code of the launch (0 on success); the caller checks it and raises.
extern "C" int conv2d_fwd(const void* x, const void* w, const void* bias, void* y, void* ws,
                          int splits, int dtype, int n, int h, int wd, int cin, long long sn,
                          long long sh, long long sw, int cout, int k, int stride, int pad, int ho,
                          int wo, int depthwise, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const conv_igemm::Shape a{n, cin, cout, k, stride, ho, wo};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = conv_igemm::launch<float>(source<float>(x, sn, sh, sw, h, wd, pad, cin), w, bias, y, ws,
                                    splits, a, depthwise != 0, st);
  else if (dtype == 1)
    err = conv_igemm::launch<__nv_bfloat16>(source<__nv_bfloat16>(x, sn, sh, sw, h, wd, pad, cin),
                                            w, bias, y, ws, splits, a, depthwise != 0, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
