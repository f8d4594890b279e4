// Direct 2-D convolution for Hopper (sm_90a): NHWC x HWIO -> NHWC, f32 accumulate.
//
// Replaces the Pallas TPU kernel K1, src/repro/kernels/conv2d/conv2d.py:
// _conv_kernel / conv2d_tiles, together with its wrapper conv2d/ops.py:
// conv2d_pallas (padding, row tiling, remainder slicing, bias).
//
// What it computes: y[n,oh,ow,co] = bias[co] + sum_{ky,kx,ci}
//   x[n, oh*s-p+ky, ow*s-p+kx, ci] * w[ky,kx,ci,co], out-of-range taps reading
// zero (the padding never exists in memory).  Depthwise (groups == Cin ==
// Cout, w [k,k,1,C]) is a per-channel multiply-add.  f32 or bf16 in and out,
// f32 accumulation, bias added to the f32 sum before the single output cast.
//
// The implicit-GEMM core, its bound and its design are in ../conv_igemm.cuh,
// shared with the halo conv (K2).  This file supplies the input source: one
// tensor whose batch/row/column strides are arbitrary (row slices of a batch
// are not contiguous; only the channel axis must be dense), padded by `pad`
// zero rows and columns on every side, masked in the kernel.  The overlapping
// rows that the TPU kernel materialises as a tile stack in HBM (_tile_rows)
// are just re-read.
#include "../conv_igemm.cuh"

namespace {

template <typename T>
struct DenseRows {
  const T* x;
  long long sn, sh, sw;  // input strides, in elements; the channel stride is 1
  int h, w, pad;

  using Px = const T*;  // the pixel's batch base
  __device__ Px pixel(long long nb) const { return x + nb * sn; }
  __device__ float load(Px p, int r, int q, int c, bool valid) const {
    const int ih = r - pad, iw = q - pad;
    float v = 0.f;
    if (valid && ih >= 0 && ih < h && iw >= 0 && iw < w) v = conv_igemm::to_f32(p[ih * sh + iw * sw + c]);
    return v;
  }
};

template <typename T>
void run(const void* x, const void* w, const void* bias, void* y, const conv_igemm::Shape& a,
         long long sn, long long sh, long long sw, int h, int wd, int pad, bool depthwise,
         cudaStream_t stream) {
  const DenseRows<T> src{static_cast<const T*>(x), sn, sh, sw, h, wd, pad};
  conv_igemm::launch<T>(src, w, bias, y, a, depthwise, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  bias may be null.  Returns the CUDA error
// code of the launch (0 on success); the caller checks it and raises.
extern "C" int conv2d_fwd(const void* x, const void* w, const void* bias, void* y, int dtype,
                          int n, int h, int wd, int cin, long long sn, long long sh,
                          long long sw, int cout, int k, int stride, int pad, int ho, int wo,
                          int depthwise, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const conv_igemm::Shape a{n, cin, cout, k, stride, ho, wo};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    run<float>(x, w, bias, y, a, sn, sh, sw, h, wd, pad, depthwise != 0, st);
  else if (dtype == 1)
    run<__nv_bfloat16>(x, w, bias, y, a, sn, sh, sw, h, wd, pad, depthwise != 0, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
