// HALP-fused halo conv for Hopper (sm_90a): the conv of one height shard with
// the halo rows its neighbours donated, NHWC x HWIO -> NHWC, f32 accumulate.
//
// Replaces the Pallas TPU kernel K2, src/repro/kernels/halo_conv/halo_conv.py:
// halo_conv2d (which reaches K1's pallas_call through conv2d_tiles).
//
// What it computes: the VALID conv, at stride s, of the extended slab
//   [top halo (lo rows); shard (hs rows); bottom halo (hi rows)]
// padded by `pad` zero columns on each side, with lo + hi == k - s, so the
// output has exactly hs / s rows; f32 or bf16 in and out, f32 accumulation,
// the bias added to the f32 sum.  Depthwise (w [k,k,1,C]) as in K1.
//
// The TPU kernel stacks overlapping row tiles of the slab in HBM (rows(),
// jnp.stack) because BlockSpecs cannot overlap.  Here nothing is assembled:
// the kernel takes three base pointers, each with its own batch/row/column
// strides (a halo is usually a row-slice view of the neighbouring shard), and
// resolves every extended row in the gather -- top, shard, bottom, then zero
// -- so an output row whose window lies inside the shard never reads a halo
// row.  A null halo pointer stands for zero rows (an edge shard's halo, or the
// zero bottom operand of the capacity-weighted path), which need no memory.
// Width padding is masked.  The implicit-GEMM core, its bound (operations:
// float32 FMAs) and its design are in ../conv_igemm.cuh, shared with K1.
//
// A shard row is read as K1 reads its input (a per-pixel batch base, one
// address); a halo row takes a second path.  Both are predicated, so the
// halo path spends issue slots on every gather: at equal work this kernel
// takes about 1.8x K1's time on the H100 (PERF.md).  Resolving the
// source row once per pixel and tap row, not per element, is the next step.
#include "../conv_igemm.cuh"

namespace {

template <typename T>
struct Operand {
  const T* p;            // null: rows of zeros
  long long sn, sh, sw;  // strides, in elements; the channel stride is 1
  int rows;
};

template <typename T>
struct HaloRows {
  Operand<T> top, mid, bot;  // extended rows [0, lo), [lo, lo + hs), [lo + hs, lo + hs + hi)
  int w, pad;

  struct Px {
    const T* base;  // the pixel's batch in the shard
    long long nb;   // its batch index, for the halos
  };
  __device__ Px pixel(long long nb) const { return Px{mid.p + nb * mid.sn, nb}; }
  __device__ float load(const Px& px, int r, int q, int c, bool valid) const {
    const int iw = q - pad;
    const int rm = r - top.rows;  // row in the shard
    float v = 0.f;
    if (valid && iw >= 0 && iw < w) {
      if (rm >= 0 && rm < mid.rows) {  // the shard: as the direct conv reads it
        v = conv_igemm::to_f32(px.base[rm * mid.sh + iw * mid.sw + c]);
      } else if (r >= 0) {  // a halo row, or zero overhang past the slab
        // field by field: no pointer into the kernel's parameters
        const bool above = rm < 0;
        const T* p = above ? top.p : bot.p;
        const long long sn = above ? top.sn : bot.sn;
        const long long sh = above ? top.sh : bot.sh;
        const long long sw = above ? top.sw : bot.sw;
        const int ro = above ? r : rm - mid.rows;
        if (p != nullptr && ro < (above ? top.rows : bot.rows))
          v = conv_igemm::to_f32(p[px.nb * sn + ro * sh + iw * sw + c]);
      }
    }
    return v;
  }
};

template <typename T>
void run(const HaloRows<T>& src, const void* w, const void* bias, void* y,
         const conv_igemm::Shape& a, bool depthwise, cudaStream_t stream) {
  conv_igemm::launch<T>(src, w, bias, y, a, depthwise, stream);
}

template <typename T>
Operand<T> operand(const void* p, const long long* strides, int rows) {
  return Operand<T>{static_cast<const T*>(p), strides[0], strides[1], strides[2], rows};
}

}  // namespace

// top/bot may be null (rows of zeros); each operand has its own (batch, row,
// column) strides in `strides` = [top x3, shard x3, bottom x3], in elements.
// dtype: 0 = float32, 1 = bfloat16.  bias may be null.  Returns the CUDA error
// code of the launch (0 on success); the caller checks it and raises.
extern "C" int halo_conv2d_fwd(const void* top, const void* x, const void* bot,
                               const long long* strides, int lo, int hs, int hi,
                               const void* w, const void* bias, void* y, int dtype, int n,
                               int wd, int cin, int cout, int k, int stride, int pad, int ho,
                               int wo, int depthwise, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const conv_igemm::Shape a{n, cin, cout, k, stride, ho, wo};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const HaloRows<float> src{operand<float>(top, strides, lo), operand<float>(x, strides + 3, hs),
                              operand<float>(bot, strides + 6, hi), wd, pad};
    run<float>(src, w, bias, y, a, depthwise != 0, st);
  } else if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    const HaloRows<bf16> src{operand<bf16>(top, strides, lo), operand<bf16>(x, strides + 3, hs),
                             operand<bf16>(bot, strides + 6, hi), wd, pad};
    run<bf16>(src, w, bias, y, a, depthwise != 0, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
