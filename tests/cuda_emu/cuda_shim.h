// CPU emulation of the CUDA subset the port's kernels use, for the CPU tests:
// a kernel source compiles as C++20 with this header force-included, each
// block runs in turn, each of its threads on a std::thread, and
// __syncthreads() is a std::barrier over the block.  __shared__ arrays become
// function statics, which the threads of the one running block share; the
// dynamic shared memory is a buffer of the launch's size per block.
// Launches `k<<<grid, block, smem, stream>>>(args)` are rewritten by the test
// to `_emu_launch(grid, block, smem, stream, k, args)`.
//
// The PTX wrappers of the package (src/repro_torch/kernels/sm90_ops.cuh,
// namespace sm90) are defined here instead, for REPRO_CUDA_EMU:
//  * warp-collective instructions (mma.sync, __shfl_xor_sync, __syncwarp)
//    meet at a std::barrier of the warp's 32 threads; mma.sync and the
//    shuffle exchange the lanes' values through a per-warp buffer (two
//    slots, used in turn by consecutive collectives, so one barrier per
//    instruction suffices): each lane computes its own elements of D from
//    the PTX ISA's fragment layouts, or reads its partner lane's value;
//  * a TF32 operand keeps its top 19 bits, as the tensor cores read it;
//  * cp.async is deferred: a copy is queued and done when a wait_group
//    retires its group (the latest moment the hardware may land it), and
//    a src-size of 0 fills zeros.
#pragma once
#define REPRO_CUDA_EMU 1
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __restrict__ __restrict
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* _emu_barrier = nullptr;
inline void __syncthreads() { _emu_barrier->arrive_and_wait(); }

// One warp of the running block: its barrier and the fragment exchange of mma.sync.
struct _EmuWarp {
  explicit _EmuWarp(unsigned n) : bar(n) {}
  std::barrier<> bar;
  uint32_t a[2][32][4], b[2][32][2], shfl[2][32];
};
inline std::vector<std::unique_ptr<_EmuWarp>> _emu_warps;
inline unsigned char* _emu_dyn_smem = nullptr;
inline unsigned _emu_tid() { return threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z); }
inline _EmuWarp& _emu_warp() { return *_emu_warps[_emu_tid() / 32]; }
inline void __syncwarp(unsigned = 0xffffffffu) { _emu_warp().bar.arrive_and_wait(); }
// the slot of the warp's next collective (mma.sync or a shuffle): they alternate
inline thread_local unsigned _emu_phase = 0;

inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}

// Every lane of the warp posts its value, meets the others, and reads the
// value of lane ^ mask (the whole warp takes part: mask 0xffffffff).
template <typename V>
V __shfl_xor_sync(unsigned, V var, int lane_mask, int = 32) {
  static_assert(sizeof(V) == 4, "32-bit shuffles only");
  _EmuWarp& w = _emu_warp();
  const int slot = _emu_phase++ & 1;
  const unsigned lane = _emu_tid() % 32;
  std::memcpy(&w.shfl[slot][lane], &var, 4);
  w.bar.arrive_and_wait();
  V out;
  std::memcpy(&out, &w.shfl[slot][lane ^ unsigned(lane_mask)], 4);
  return out;
}

struct alignas(8) float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8, cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
template <typename F>
cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
// an H100's 132 SMs, so the split count is the card's
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = 132;
  return cudaSuccess;
}
// resident blocks of a kernel on an SM, from its threads and shared memory
// alone (an H100's 2048 threads and 227 KB; the emulation has no registers)
template <typename F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int threads, size_t smem) {
  *n = std::min(2048 / threads, smem ? int(232448 / smem) : 32);
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }

// bfloat16 as its bits; float -> bf16 rounds to nearest even, as __float2bfloat16
struct __nv_bfloat16 { uint16_t bits; };
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = uint32_t(b.bits) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __nv_bfloat16{uint16_t(u >> 16)};
}

namespace sm90 {

inline unsigned char* dynamic_smem() { return _emu_dyn_smem; }

struct _Copy {
  void* dst;
  const void* src;
  int bytes;
  bool ok;
};
inline thread_local std::vector<_Copy> _emu_open;           // issued, not committed
inline thread_local std::deque<std::vector<_Copy>> _emu_groups;  // committed, in flight

inline void cp_async16(void* dst, const void* src, bool ok) { _emu_open.push_back({dst, src, 16, ok}); }
inline void cp_async4(void* dst, const void* src, bool ok) { _emu_open.push_back({dst, src, 4, ok}); }
inline void cp_async_commit() {
  _emu_groups.push_back(std::move(_emu_open));
  _emu_open.clear();
}
template <int N>
void cp_async_wait() {
  while (_emu_groups.size() > size_t(N)) {
    for (const _Copy& c : _emu_groups.front()) {
      if (c.ok)
        std::memcpy(c.dst, c.src, c.bytes);
      else
        std::memset(c.dst, 0, c.bytes);
    }
    _emu_groups.pop_front();
  }
}

// round to nearest, ties away from zero, to 10 mantissa bits
inline uint32_t cvt_tf32(float x) {
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7f800000u) != 0x7f800000u) u = (u + 0x1000u) & 0xffffe000u;
  return u;
}

// Post this lane's fragments, meet the warp, and return the slot to read.
inline int _emu_exchange(const uint32_t a[4], const uint32_t b[2]) {
  _EmuWarp& w = _emu_warp();
  const int slot = _emu_phase++ & 1;
  const unsigned lane = _emu_tid() % 32;
  std::memcpy(w.a[slot][lane], a, sizeof(w.a[slot][lane]));
  std::memcpy(w.b[slot][lane], b, sizeof(w.b[slot][lane]));
  w.bar.arrive_and_wait();
  return slot;
}

// D (16x8) += A (16xK) B (Kx8) for this lane's four elements of D
template <int K>
void _emu_mma_out(float d[4], const float (&A)[16][K], const float (&B)[K][8]) {
  const unsigned lane = _emu_tid() % 32, g = lane / 4, t = lane % 4;
  for (int e = 0; e < 4; ++e) {
    const unsigned r = g + (e / 2) * 8, c = 2 * t + e % 2;
    float s = 0.f;
    for (int k = 0; k < K; ++k) s += A[r][k] * B[k][c];
    d[e] += s;
  }
}

inline void mma_tf32(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  const int slot = _emu_exchange(a, b);
  const _EmuWarp& w = _emu_warp();
  float A[16][8], B[8][8];
  auto tf32 = [](uint32_t u) { return __uint_as_float(u & 0xffffe000u); };
  for (unsigned l = 0; l < 32; ++l) {
    const unsigned g = l / 4, t = l % 4;
    A[g][t] = tf32(w.a[slot][l][0]);
    A[g + 8][t] = tf32(w.a[slot][l][1]);
    A[g][t + 4] = tf32(w.a[slot][l][2]);
    A[g + 8][t + 4] = tf32(w.a[slot][l][3]);
    B[t][g] = tf32(w.b[slot][l][0]);
    B[t + 4][g] = tf32(w.b[slot][l][1]);
  }
  _emu_mma_out<8>(d, A, B);
}

inline void mma_bf16(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  const int slot = _emu_exchange(a, b);
  const _EmuWarp& w = _emu_warp();
  float A[16][16], B[16][8];
  auto lo = [](uint32_t u) { return __uint_as_float(u << 16); };
  auto hi = [](uint32_t u) { return __uint_as_float(u & 0xffff0000u); };
  for (unsigned l = 0; l < 32; ++l) {
    const unsigned g = l / 4, t = l % 4;
    for (int h = 0; h < 2; ++h) {  // k = 2t + 8h and 2t + 8h + 1
      const uint32_t r0 = w.a[slot][l][2 * h], r8 = w.a[slot][l][2 * h + 1], bb = w.b[slot][l][h];
      A[g][2 * t + 8 * h] = lo(r0);
      A[g][2 * t + 8 * h + 1] = hi(r0);
      A[g + 8][2 * t + 8 * h] = lo(r8);
      A[g + 8][2 * t + 8 * h + 1] = hi(r8);
      B[2 * t + 8 * h][g] = lo(bb);
      B[2 * t + 8 * h + 1][g] = hi(bb);
    }
  }
  _emu_mma_out<16>(d, A, B);
}

}  // namespace sm90

template <typename K, typename... A>
void _emu_launch(dim3 grid, dim3 block, int smem, cudaStream_t, K kernel, A... args) {
  gridDim = grid;
  blockDim = block;
  const unsigned nt = block.x * block.y * block.z;
  std::vector<float4> dyn((size_t(smem) + 15) / 16);  // 16-byte aligned
  _emu_dyn_smem = reinterpret_cast<unsigned char*>(dyn.data());
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::barrier<> bar(nt);
        _emu_barrier = &bar;
        // stale shared memory reads as NaN: a read of a stage no copy filled shows
        std::memset(dyn.data(), 0xff, dyn.size() * sizeof(float4));
        _emu_warps.clear();
        for (unsigned w = 0; w < (nt + 31) / 32; ++w)
          _emu_warps.push_back(std::make_unique<_EmuWarp>(std::min(32u, nt - 32 * w)));
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < nt; ++t)
          threads.emplace_back([&, t] {
            blockIdx = dim3(bx, by, bz);
            threadIdx = dim3(t % block.x, (t / block.x) % block.y, t / (block.x * block.y));
            kernel(args...);
          });
        for (auto& th : threads) th.join();
      }
}
