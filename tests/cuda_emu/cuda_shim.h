// CPU emulation of the CUDA subset the port's kernels use, for the CPU tests:
// a kernel source compiles as C++20 with this header force-included, each
// block runs in turn, each of its threads on a std::thread, and
// __syncthreads() is a std::barrier over the block.  __shared__ arrays become
// function statics, which the threads of the one running block share.
// Launches `k<<<grid, block, smem, stream>>>(args)` are rewritten by the test
// to `_emu_launch(grid, block, smem, stream, k, args)`.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __restrict__ __restrict
#define __launch_bounds__(x)
#define __align__(n) __attribute__((aligned(n)))

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* _emu_barrier = nullptr;
inline void __syncthreads() { _emu_barrier->arrive_and_wait(); }

struct alignas(16) float4 { float x, y, z, w; };
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
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

template <typename K, typename... A>
void _emu_launch(dim3 grid, dim3 block, int, cudaStream_t, K kernel, A... args) {
  gridDim = grid;
  blockDim = block;
  const unsigned nt = block.x * block.y * block.z;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::barrier<> bar(nt);
        _emu_barrier = &bar;
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
