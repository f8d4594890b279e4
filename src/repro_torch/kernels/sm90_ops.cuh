// The PTX instructions the port's kernels issue, one wrapper each: the
// asynchronous global -> shared copy (cp.async with zero-fill), its group
// commit / wait, the warp-level tensor-core products (mma.sync m16n8k8 TF32
// and m16n8k16 bf16, f32 accumulate), the f32 -> TF32 rounding, and the block's
// dynamic shared memory.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k8 / m16n8k16"),
// with g = lane / 4 and t = lane % 4:
//   C, D (16x8 f32)      c[0], c[1]: row g,   cols 2t, 2t+1
//                        c[2], c[3]: row g+8, cols 2t, 2t+1
//   A tf32 (16x8, row)   a[0]: (g, t)  a[1]: (g+8, t)  a[2]: (g, t+4)  a[3]: (g+8, t+4)
//   B tf32 (8x8, col)    b[0]: (t, g)  b[1]: (t+4, g)
//   A bf16 (16x16, row)  a[0]: (g, 2t..2t+1)    a[1]: (g+8, 2t..2t+1)
//                        a[2]: (g, 2t+8..2t+9)  a[3]: (g+8, 2t+8..2t+9)
//   B bf16 (16x8, col)   b[0]: (2t..2t+1, g)    b[1]: (2t+8..2t+9, g)
// where a bf16 register holds its lower-indexed element in its low half.
//
// The CPU tests compile the kernels with g++ against an emulation of these
// same functions (tests/cuda_emu/cuda_shim.h defines REPRO_CUDA_EMU and
// supplies them), so nothing below is seen there.
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

#ifndef REPRO_CUDA_EMU
namespace sm90 {

// The block's dynamic shared memory (sized at launch).
__device__ __forceinline__ unsigned char* dynamic_smem() {
  extern __shared__ __align__(16) unsigned char smem_[];
  return smem_;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes global -> shared, asynchronously, bypassing L1 (.cg); with
// `ok` false nothing is read and the 16 bytes are zero-filled (src-size 0).
// Both addresses 16-byte aligned; `src` must be a valid address even then.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

// The same for 4 bytes (.ca: the only variant of this size).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// f32 -> TF32, round to nearest, ties away from zero; the low 13 bits are 0,
// so the result read as a float is the TF32 value.
__device__ __forceinline__ uint32_t cvt_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d = a * b + d, 16x8x8, TF32 inputs, f32 accumulate.  Not volatile: the
// compiler may interleave independent products (a chain of dependent ones
// waits out the tensor cores' latency at every step).  The tensor cores add
// the products to d truncating, not rounding, so a long chain into one d
// drifts toward zero (2^-23 of |d| per instruction, K/8 of them).
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a * b + d, 16x8x16, bf16 inputs, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace sm90
#endif  // REPRO_CUDA_EMU
