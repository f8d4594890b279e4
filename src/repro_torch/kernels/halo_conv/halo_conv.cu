// HALP-fused halo conv for Hopper (sm_90a): the conv of one height shard with
// the halo rows its neighbours donated, NHWC x HWIO -> NHWC, f32 accumulate.
//
// Replaces the Pallas TPU kernel K2, src/repro/kernels/halo_conv/halo_conv.py:
// halo_conv2d (which reaches K1's pallas_call through conv2d_tiles).
//
// What it computes: the VALID conv, at stride s, of the extended slab
//   [top halo (lo rows); shard (hs rows); bottom halo (hi rows)]
// padded by `pad` zero columns on each side, with lo + hi == k - s, so the
// output has exactly hs / s rows; f32 or bf16 in and out, the f32 sum
// rounded to the output type and then the bias added, as halo_conv2d does
// (l.117-118).  Depthwise (w [k,k,1,C]) as in K1.
//
// Bound on the H100 (operations), as K1's: 2*k*k*Cin*Cout FLOPs per output
// pixel at 165 TFLOP/s (3xTF32, float32) or 989 TFLOP/s (bf16); the HBM
// bytes of shard, halos, weights and output at 3.35 TB/s are 10-100x less.
//
// The TPU kernel stacks overlapping row tiles of the slab in HBM (rows(),
// jnp.stack) because BlockSpecs cannot overlap.  Here nothing is assembled:
// the kernel takes three base pointers, each with its own batch/row/column
// strides (a halo is usually a row-slice view of the neighbouring shard).
// The source resolves an extended row once per pixel and tap row -- top,
// shard, bottom, then zero -- and the shared core (../conv_igemm.cuh: tap-row
// K steps, cp.async stages, 3xTF32 / bf16 mma.sync, split-K for the thin
// grids of deep shards) copies the row's channels with no further branch, so
// an output row whose window lies inside the shard never reads a halo row.
// A null halo pointer stands for zero rows (an edge shard's halo, or the zero
// bottom operand of the capacity-weighted path): its rows resolve to null,
// the copies zero-fill, and the zeros never exist in memory.
#include <cstdint>

#include "../conv_igemm.cuh"

namespace {

template <typename T>
struct Operand {
  const T* p;            // null: rows of zeros
  long long sn, sh, sw;  // strides, in elements; the channel stride is 1
  int rows;

  bool vec16() const {
    constexpr int v = conv_igemm::Tile<T>::VEC;
    return p == nullptr || (reinterpret_cast<uintptr_t>(p) % 16 == 0 && sn % v == 0 &&
                            sh % v == 0 && sw % v == 0);
  }
};

template <typename T>
struct HaloRows {
  Operand<T> top, mid, bot;  // extended rows [0, lo), [lo, lo + hs), [lo + hs, lo + hs + hi)
  int w, pad, cin;

  using Px = long long;  // the pixel's batch index
  __device__ Px pixel(long long nb) const { return nb; }
  __device__ conv_igemm::Row<T> row(Px nb, int r) const {
    // field by field: no pointer into the kernel's parameters
    const int rm = r - top.rows;  // row in the shard
    const bool above = rm < 0, below = rm >= mid.rows;
    const T* p = above ? top.p : below ? bot.p : mid.p;
    const long long sn = above ? top.sn : below ? bot.sn : mid.sn;
    const long long sh = above ? top.sh : below ? bot.sh : mid.sh;
    const long long sw = above ? top.sw : below ? bot.sw : mid.sw;
    const int ro = above ? r : below ? rm - mid.rows : rm;
    const int rows = above ? top.rows : below ? bot.rows : mid.rows;
    const T* q = nullptr;  // r < 0 (a pixel past the end) or overhang past the slab: zeros
    if (p != nullptr && ro >= 0 && ro < rows) q = p + nb * sn + ro * sh;
    return {q, sw};
  }
  bool vec16() const {
    return top.vec16() && mid.vec16() && bot.vec16() && cin % conv_igemm::Tile<T>::VEC == 0;
  }
};

template <typename T>
Operand<T> operand(const void* p, const long long* strides, int rows) {
  return Operand<T>{static_cast<const T*>(p), strides[0], strides[1], strides[2], rows};
}

template <typename T>
HaloRows<T> source(const void* top, const void* x, const void* bot, const long long* strides,
                   int lo, int hs, int hi, int wd, int pad, int cin) {
  return HaloRows<T>{operand<T>(top, strides, lo), operand<T>(x, strides + 3, hs),
                     operand<T>(bot, strides + 6, hi), wd, pad, cin};
}

}  // namespace

// The split count of a conv of m output pixels (grid z of the core); the
// wrapper allocates splits * m * cout floats of workspace when it is > 1.
extern "C" int conv_splits(long long m, int cout, int k, int cin, int device) {
  return conv_igemm::split_count(m, cout, k, cin, conv_igemm::sm_count(device));
}

// The core's gather variant for these operands: bit 0, shard and halos
// copied as 16-byte vectors (else element by element); bit 1, the weights.
extern "C" int halo_conv2d_gather(const void* top, const void* x, const void* bot,
                                  const long long* strides, const void* w, int dtype, int cin,
                                  int cout) {
  if (dtype == 0)
    return conv_igemm::gather_variant<float>(
        source<float>(top, x, bot, strides, 0, 0, 0, 0, 0, cin), w, cout);
  return conv_igemm::gather_variant<__nv_bfloat16>(
      source<__nv_bfloat16>(top, x, bot, strides, 0, 0, 0, 0, 0, cin), w, cout);
}

// top/bot may be null (rows of zeros); each operand has its own (batch, row,
// column) strides in `strides` = [top x3, shard x3, bottom x3], in elements.
// dtype: 0 = float32, 1 = bfloat16.  bias may be null.  ws: splits * M *
// cout floats (null when splits == 1), splits from conv_splits.  Returns the
// CUDA error code of the launch (0 on success); the caller checks it and raises.
extern "C" int halo_conv2d_fwd(const void* top, const void* x, const void* bot,
                               const long long* strides, int lo, int hs, int hi,
                               const void* w, const void* bias, void* y, void* ws, int splits,
                               int dtype, int n, int wd, int cin, int cout, int k, int stride,
                               int pad, int ho, int wo, int depthwise, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const conv_igemm::Shape a{n, cin, cout, k, stride, ho, wo};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = conv_igemm::launch<float>(source<float>(top, x, bot, strides, lo, hs, hi, wd, pad, cin),
                                    w, bias, y, ws, splits, a, depthwise != 0, st);
  else if (dtype == 1)
    err = conv_igemm::launch<__nv_bfloat16>(
        source<__nv_bfloat16>(top, x, bot, strides, lo, hs, hi, wd, pad, cin), w, bias, y, ws,
        splits, a, depthwise != 0, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
