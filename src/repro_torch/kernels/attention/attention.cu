// Flash attention for Hopper (sm_90a): softmax(q k^T / sqrt(D)) v, online,
// with both products on the tensor cores.
//
// Replaces the Pallas TPU kernel K3, src/repro/kernels/attention/attention.py:
// _flash_kernel / flash_attention, together with its GQA wrapper
// attention/ops.py: gqa_flash (which repeats the KV heads in memory).
//
// What it computes, per batch b and head h (KV head h / (H / Hkv)):
//   o[t] = sum_j softmax_j(q[t] . k[j] * scale) v[j],  scale = 1/sqrt(DQK),
// over the keys j < S, or with the causal mask over j <= t (aligned top-left:
// query t sees keys 0..t whatever S is, as the Pallas kernel's
// q_pos >= kv_pos).  Masked logits are -1e30; the running max, normaliser and
// accumulator are f32, the normaliser is floored at 1e-30 before the
// division, and the output is cast once to the input type (f32 or bf16).
// q and k have one head width DQK, v and o another, DV: the compiled pairs
// (DQK, DV) are (16, 16), (32, 32), (64, 64), (128, 128), (192, 128) --
// MLA's (DeepSeek-V3: 128 no-RoPE + 64 RoPE query/key dims, value 128;
// replacing the two einsums of src/repro/models/attention.py: mla_apply,
// whose sum is one dot product over the concatenated 192 dims) -- and, in
// the library of attention_diffusion.cu (this file compiled with the other
// K3_PAIRS, so the two halves build in parallel), the diffusion models'
// (40, 40), (80, 80), (160, 160) (UNet-SD1.5: 8 heads over 320 / 640 / 1280
// channels) and (72, 72) (DiT-XL/2: 16 heads over 1152), replacing the
// einsums of src/repro/models/unet.py: _mha and dit.py: _block_apply.
// QK^T runs over DQK; PV, the accumulator, the merge and the
// store over DV.  A DQK that is a multiple of 8 but not of 16 (40, 72) has a
// last half slice: in float32 (m16n8k8) QK^T simply takes DQK / 8 slices; in
// bf16 (m16n8k16) the last slice's upper 8 dims are zeros in both Q's and K's
// fragments (registers, never read from memory), so QK^T runs over the
// padded width (48, 80) and the stored rows stay DQK wide.
//
// Bound on an H100 SXM.  A head does 2*T*S'*(DQK + DV) FLOPs (S' the
// unmasked keys) and moves (T + S)*DQK + (T + S)*DV elements.  Per ViT-L/16 forward (24 blocks x heads
// 8 + 5 + 3, batch 4, T = S = 196, D = 64) that is 15.1 GFLOP and 308 MB in
// float32: 0.092 ms of 3xTF32 products at 165 TFLOP/s and 0.092 ms of HBM
// at 3.35 TB/s -- the two bounds meet; in bf16 it is bytes-bound (0.046 ms
// against 0.015 ms at 989 TFLOP/s).  Each call is small (0.1-0.3 GFLOP),
// so what sets its time is the latency of a block's chain of key steps and
// how many blocks the grid keeps in flight, not the card's rates.
//
// Design.
//  * Tensor cores.  A warp owns 16 query rows.  S = Q K^T and P V are
//    mma.sync products (sm90_ops.cuh): float32 as 3xTF32 (x = hi + lo, both
//    TF32; lo*hi + hi*lo + hi*hi), bf16 as m16n8k16.  Q's fragments are
//    loaded once, straight from global memory, and split where used (f32).
//    P goes from S's accumulator fragments to PV's A fragments in registers:
//    in bf16 the C layout of two 8-key tiles is the A layout of m16n8k16
//    (P rounds to bf16 there, as FlashAttention-2 does; the plain version
//    keeps P in f32); in TF32 the C pair (cols 2t, 2t+1) is read as A's
//    (cols t, t+4), which permutes the 8 keys of a slice, and V's B fragment
//    is read with the same permutation (b[0] <- key 2t, b[1] <- key 2t+1),
//    so the product is unchanged.  QK^T's head dims are permuted alike, so a
//    lane's two dims of a key are one 8-byte shared-memory read.
//  * Accuracy.  The tensor cores add to the accumulator truncating
//    (sm90_ops.cuh), so in float32 every 16-deep slice of QK^T goes to a
//    fresh fragment added to S with a rounded FADD, and each key step's PV
//    goes to a fresh fragment folded in as acc = alpha*acc + pv, as the conv
//    core's per-stage partials.  expf, not __expf.
//  * Splitting the keys.  A block is a tile of 16*WQ query rows and WK warp
//    groups (WQ warps each, one per 16 rows); a group takes a contiguous run
//    of the tile's 16-key steps, as near equal as the steps allow (13 steps
//    at S = 196: 3 / 3 / 3 / 4).  The WK partial softmaxes (m, l, acc) are
//    merged through shared memory in a fixed order with exp(m_i - max m)
//    weights, a group whose keys are all masked (or that got none) weighing
//    0: one launch, no workspace, no atomics.
//  * The block shape, per call.  Three are compiled: 16 rows x 4 key groups
//    (13 x B*H blocks at T = 196), 32 x 4 (7 x B*H, two warps sharing each
//    group's staged keys) and 64 x 1 (4 x B*H: the first port's tile, no key
//    split).  The launcher takes the one whose grid needs the fewest waves
//    of the card's resident blocks (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
//    then the most warps: at the ViT's head shards 8 / 5 / 3 in float32 that
//    is 64x1 / 16x4 / 32x4, each the fastest of the three there
//    (tools/k3_variants.py).  A pure function of (T, B*H), the SM count and
//    the compiled kernels: a repeated call gives the same bits; a head shard
//    and the full call may sum in other orders.
//  * Copies.  Each warp group stages its own K and V steps by 16-byte
//    cp.async (zero-fill past the keys) into dynamic shared memory, two
//    steps deep; rows are padded, so the fragment reads hit 32 banks.  Where
//    a K/V base or stride is not 16-byte aligned, 4-byte copies (f32) or
//    plain loads (bf16) take over.
//  * Keys past S and past a row's causal diagonal are set to -1e30 in S
//    before the row max (a zero-filled key row would give 0, not -inf).  The
//    row max is taken over the quad of lanes that share a row
//    (__shfl_xor_sync 1, 2); the row sum stays per lane until the merge.
//  * Every thread reaches every barrier: the round count is the block's, a
//    warp group with fewer steps skips its copies and products (a warp-
//    uniform branch), rows past T run the loop and skip only the store, and
//    loads are predicated (`if (ok) v = load;`), never an early return.
// Measured against it on the card (tools/k3_variants.py): 32-key steps, a
// truncating TF32 split and a 168-register cap, none faster per forward.
// At (192, 128) in float32 Q's fragments (96 registers a thread) and the
// accumulator (64) stay in registers as at the square widths; what ptxas
// spills there is printed by the build (chip_smoke.py phase 2) and recorded
// in PERF.md.
// q, k, v and o are read and written through batch/head/row strides with a
// dense head dimension, so the model layout [B, T, H, D] needs no transpose,
// and a KV head shared by g query heads is indexed, never repeated.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "../sm90_ops.cuh"

// The (DQK, DV) pairs this library compiles (run() below; ops.py: HEAD_DIMS
// holds those of both libraries).  attention_diffusion.cu defines its own.
#ifndef K3_PAIRS
#define K3_PAIRS(X) X(16, 16) X(32, 32) X(64, 64) X(128, 128) X(192, 128)
#endif

namespace {

// A block shape: WQ warps along the query rows (16 rows each) times WK warp
// groups splitting the keys of those rows; the launcher picks one per call.
struct BlockShape {
  int wq, wk;
};
constexpr int kShapes = 3;
constexpr BlockShape kShape[kShapes] = {{1, 4}, {2, 4}, {4, 1}};
constexpr int KB = 16;                    // keys per step
constexpr int NJ = KB / 8;                // 8-key tiles per step
constexpr int kStages = 2;                // K/V steps in flight per warp group
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  int h, group, t, s;  // query heads, query heads per KV head, query rows, keys
  long long qs[3], ks[3], vs[3], os[3];  // (batch, head, row) strides in elements
  float scale;
  int causal;
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ uint16_t bits(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}
// two bf16 as one register, the lower-indexed element in the low half
__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* lo, const __nv_bfloat16* hi) {
  return uint32_t(bits(lo)) | (uint32_t(bits(hi)) << 16);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat16 a = __float2bfloat16(lo), b = __float2bfloat16(hi);
  return pair(&a, &b);
}

// x = hi + lo, both TF32: the two halves of the 3xTF32 product.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = sm90::cvt_tf32(x);
  lo = sm90::cvt_tf32(x - __uint_as_float(hi));
}

// One element global -> shared where a 16-byte copy is not aligned: an
// asynchronous 4-byte copy for f32; for bf16 a predicated load and store.
__device__ __forceinline__ void copy1(float* dst, const float* src, bool ok) {
  sm90::cp_async4(dst, src, ok);
}
__device__ __forceinline__ void copy1(__nv_bfloat16* dst, const __nv_bfloat16* src, bool ok) {
  __nv_bfloat16 v = __float2bfloat16(0.f);
  if (ok) v = *src;
  *dst = v;
}

// Row strides of a staged K and V step, in elements: padded so a warp's
// fragment reads fall on distinct banks -- K by 8 elements (f32: a row
// offset of 8 banks for the 8-byte reads of a key's two head dims), V by 16
// bytes (rows 2t and 2t + 1: 8 banks apart).  K rows are DQK wide, V rows DV.
template <typename T, int DQK>
constexpr int kLdK = DQK + 8;
template <typename T, int DV>
constexpr int kLdV = DV + 16 / (int)sizeof(T);
template <typename T, int DQK, int DV>
constexpr int kStage = KB * (kLdK<T, DQK> + kLdV<T, DV>);  // elements of one staged step

// The products of one warp, by type.  Fragment layouts: sm90_ops.cuh; g =
// lane / 4, t = lane % 4; the warp's rows are r0 = its first + g and r1 = r0 + 8.
// s[j][e] is the score of row (e < 2 ? r0 : r1) and key j*8 + 2t + e%2 of the step.
template <typename T, int DQK, int DV>
struct Warp;

template <int DQK, int DV>
struct Warp<float, DQK, DV> {
  static constexpr int LDK = kLdK<float, DQK>, LDV = kLdV<float, DV>;
  float qf[DQK / 8][4];  // Q's A fragments, split into TF32 hi / lo where used

  // q0 / q1: rows r0 / r1 of q, or null for a row past T (read as zeros).
  // QK^T sums over the head dims in any order, so within each 8-dim slice
  // A's column t is dim 2t and column t + 4 dim 2t + 1, and K's B fragment
  // the same: a lane's two dims of a key are one 8-byte read.
  __device__ __forceinline__ void load_q(const float* q0, const float* q1, int t) {
#pragma unroll
    for (int kc = 0; kc < DQK / 8; ++kc) {
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (q0 != nullptr) {
        x[0] = q0[kc * 8 + 2 * t];
        x[2] = q0[kc * 8 + 2 * t + 1];
      }
      if (q1 != nullptr) {
        x[1] = q1[kc * 8 + 2 * t];
        x[3] = q1[kc * 8 + 2 * t + 1];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) qf[kc][e] = x[e];
    }
  }

  // s = Q K^T for the step's KB keys (ks: the staged [KB][LDK] K step); each
  // 16-deep slice (the last one 8 deep where DQK % 16 == 8) goes to a fresh
  // fragment, small terms first, and is added with a rounded FADD.
  __device__ __forceinline__ void scores(const float* ks, float s[NJ][4], int g, int t) const {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int k2 = 0; k2 < (DQK + 15) / 16; ++k2) {
      float part[NJ][4] = {};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kc = 2 * k2 + h;
        if (kc >= DQK / 8) continue;  // past the last 8-dim slice (compile time)
        uint32_t qh[4], ql[4], bh[NJ][2], bl[NJ][2];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(qf[kc][e], qh[e], ql[e]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float2 kk = *reinterpret_cast<const float2*>(ks + (j * 8 + g) * LDK + kc * 8 + 2 * t);
          split_tf32(kk.x, bh[j][0], bl[j][0]);
          split_tf32(kk.y, bh[j][1], bl[j][1]);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) sm90::mma_tf32(part[j], ql, bh[j]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) sm90::mma_tf32(part[j], qh, bl[j]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) sm90::mma_tf32(part[j], qh, bh[j]);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += part[j][e];
    }
  }

  // acc = alpha * acc + P V for the step (p as s; vs: the staged V step).
  // A's column t is key 2t and column t + 4 key 2t + 1 of each 8-key slice,
  // and V's B rows are read in that order.
  __device__ __forceinline__ static void pv(const float p[NJ][4], const float* vs, float acc[DV / 8][4],
                                            float a0, float a1, int g, int t) {
    uint32_t ph[NJ][4], pl[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      split_tf32(p[j][0], ph[j][0], pl[j][0]);  // (r0, key 2t)
      split_tf32(p[j][2], ph[j][1], pl[j][1]);  // (r1, key 2t)
      split_tf32(p[j][1], ph[j][2], pl[j][2]);  // (r0, key 2t + 1)
      split_tf32(p[j][3], ph[j][3], pl[j][3]);  // (r1, key 2t + 1)
    }
#pragma unroll
    for (int nt = 0; nt < DV / 8; ++nt) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* vr = vs + (j * 8 + 2 * t) * LDV + nt * 8 + g;
        uint32_t bh[2], bl[2];
        split_tf32(vr[0], bh[0], bl[0]);
        split_tf32(vr[LDV], bh[1], bl[1]);
        sm90::mma_tf32(part, pl[j], bh);
        sm90::mma_tf32(part, ph[j], bl);
        sm90::mma_tf32(part, ph[j], bh);
      }
      acc[nt][0] = acc[nt][0] * a0 + part[0];
      acc[nt][1] = acc[nt][1] * a0 + part[1];
      acc[nt][2] = acc[nt][2] * a1 + part[2];
      acc[nt][3] = acc[nt][3] * a1 + part[3];
    }
  }
};

template <int DQK, int DV>
struct Warp<__nv_bfloat16, DQK, DV> {
  using T = __nv_bfloat16;
  static constexpr int LDK = kLdK<T, DQK>, LDV = kLdV<T, DV>;
  static constexpr int KC = (DQK + 15) / 16;  // 16-dim slices of QK^T, the last padded where DQK % 16 == 8
  uint32_t qa[KC][4];                          // Q's A fragments

  // dims past DQK (the upper half of a padded last slice) are zeros
  __device__ __forceinline__ void load_q(const T* q0, const T* q1, int t) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const int c = kc * 16 + 2 * t;
      const bool hi = kc * 16 + 8 < DQK;  // compile time: the slice's upper 8 dims exist
      uint32_t x[4] = {0u, 0u, 0u, 0u};
      if (q0 != nullptr) {
        x[0] = pair(q0 + c, q0 + c + 1);
        if (hi) x[2] = pair(q0 + c + 8, q0 + c + 9);
      }
      if (q1 != nullptr) {
        x[1] = pair(q1 + c, q1 + c + 1);
        if (hi) x[3] = pair(q1 + c + 8, q1 + c + 9);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) qa[kc][e] = x[e];
    }
  }

  // exact bf16 products, straight into s; K's dims past DQK are zeros in
  // the fragment (the staged row holds DQK dims)
  __device__ __forceinline__ void scores(const T* ks, float s[NJ][4], int g, int t) const {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const T* kr = ks + (j * 8 + g) * LDK + kc * 16 + 2 * t;
        const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(kr),
                               kc * 16 + 8 < DQK ? *reinterpret_cast<const uint32_t*>(kr + 8) : 0u};
        sm90::mma_bf16(s[j], qa[kc], b);
      }
    }
  }

  // P rounds to bf16: the C fragments of two 8-key tiles are m16n8k16's A.
  __device__ __forceinline__ static void pv(const float p[NJ][4], const T* vs, float acc[DV / 8][4],
                                            float a0, float a1, int g, int t) {
    uint32_t a[NJ / 2][4];
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk) {
      a[kk][0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
      a[kk][1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
      a[kk][2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
      a[kk][3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    }
#pragma unroll
    for (int nt = 0; nt < DV / 8; ++nt) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < NJ / 2; ++kk) {
        const T* vr = vs + (kk * 16 + 2 * t) * LDV + nt * 8 + g;
        const uint32_t b[2] = {pair(vr, vr + LDV), pair(vr + 8 * LDV, vr + 9 * LDV)};
        sm90::mma_bf16(part, a[kk], b);
      }
      acc[nt][0] = acc[nt][0] * a0 + part[0];
      acc[nt][1] = acc[nt][1] * a0 + part[1];
      acc[nt][2] = acc[nt][2] * a1 + part[2];
      acc[nt][3] = acc[nt][3] * a1 + part[3];
    }
  }
};

// Dynamic shared memory: the K/V stages of every warp group, then reused by
// the merge (each group's raw accumulators [16 WQ][DV + 4], maxima and sums).
// At (192, 128) in float32 a stage is 16 keys x (200 + 132) x 4 B = 21.2 KB,
// so the 4-group shapes take 170 KB and one block fits on an SM (the
// launcher's pick sees that through the occupancy query).
template <typename T, int DQK, int DV, int WQ, int WK>
constexpr int smem_bytes() {
  constexpr int kv = WK * kStages * kStage<T, DQK, DV> * (int)sizeof(T);
  constexpr int merge = WK * 16 * WQ * (DV + 4 + 2) * 4;
  return kv > merge ? kv : merge;
}

// One staged row (D elements) of K or V: thread `part` of the CPY threads
// copying the row issues its share of the 16-byte copies (zero-fill where
// !ok) -- or, unaligned (copy_row1), of the single elements.  Where the
// row's copies do not split evenly over its threads (D = 40 or 72: 10 / 18
// float32 copies, 5 / 9 bf16), thread `part` takes copies part, part + CPY,
// ..., and the last round only the copies that exist.
template <int D, int CPY, typename T>
__device__ __forceinline__ void copy_row16(T* dst, const T* src, int part, bool ok) {
  constexpr int VE = 16 / (int)sizeof(T), CPR = D / VE;  // 16-byte copies per row
  static_assert(D % VE == 0, "a row must be whole 16-byte copies");
  if constexpr (CPR >= CPY && CPR % CPY == 0) {
    constexpr int CPT = CPR / CPY;  // copies per thread
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = (part * CPT + i) * VE;
      sm90::cp_async16(dst + c, src + c, ok);
    }
  } else {
    constexpr int ROUNDS = (CPR + CPY - 1) / CPY;
#pragma unroll
    for (int i = 0; i < ROUNDS; ++i) {
      const int c = i * CPY + part;
      if (c < CPR) sm90::cp_async16(dst + c * VE, src + c * VE, ok);
    }
  }
}
template <int D, int CPY, typename T>
__device__ __forceinline__ void copy_row1(T* dst, const T* src, int part, bool ok) {
  constexpr int EPC = D / CPY;  // elements per thread
  static_assert(D % CPY == 0, "a row's elements must split evenly over its threads");
#pragma unroll 4
  for (int i = 0; i < EPC; ++i) {
    const int c = part * EPC + i;
    copy1(dst + c, src + c, ok);
  }
}

// VEC: every K/V base and stride 16-byte aligned (16-byte cp.async copies).
template <typename T, int DQK, int DV, bool VEC, int WQ, int WK>
__global__ void __launch_bounds__(32 * WQ * WK)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, Params p) {
  constexpr int NT = 32 * WQ * WK;  // threads
  constexpr int BQ = 16 * WQ;       // query rows
  static_assert(DQK % 8 == 0 && DV % 8 == 0, "head widths are whole 8-wide tensor-core tiles");
  constexpr int LDK = kLdK<T, DQK>, LDV = kLdV<T, DV>;
  constexpr int KTILE = KB * LDK;  // a stage: K [KB][LDK], then V [KB][LDV]
  T* smem = reinterpret_cast<T*>(sm90::dynamic_smem());

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wq = warp % WQ, wk = warp / WQ;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / p.h, h = bh % p.h, hk = h / p.group;
  const int q0 = blockIdx.x * BQ;
  const int r0 = q0 + wq * 16 + g, r1 = r0 + 8;  // this lane's two query rows

  // the keys the block needs (all S, or up to its last row's diagonal) in
  // steps of KB, and this warp group's contiguous run of those steps
  const int n_keys = p.causal ? (p.s < q0 + BQ ? p.s : q0 + BQ) : p.s;
  const int steps = (n_keys + KB - 1) / KB;
  const int st0 = steps * wk / WK;
  const int cnt = steps * (wk + 1) / WK - st0;
  const int rounds = (steps + WK - 1) / WK;  // the block's, the same for every thread

  const T* kb = k + b * p.ks[0] + hk * p.ks[1];
  const T* vb = v + b * p.vs[0] + hk * p.vs[1];

  // Issue the copies of step `st` (keys st*KB ..) into this group's stage
  // `stage`: thread gl of the group copies part `part` of key row `kr`, of K
  // and of V, from two row addresses and constant offsets.
  const int gl = tid % (32 * WQ);  // this thread's index in its warp group
  constexpr int CPY = 32 * WQ / KB;  // threads copying a key row
  const int kr = gl % KB, part = gl / KB;
  auto load = [&](int stage, int st) {
    T* ks = smem + (wk * kStages + stage) * kStage<T, DQK, DV>;
    T* vs = ks + KTILE;
    const int j = st * KB + kr;
    const bool ok = j < n_keys;
    // a key row past n_keys copies zeros from row 0 (valid addresses, not read)
    const T* ksrc = kb + (ok ? j * p.ks[2] : 0);
    const T* vsrc = vb + (ok ? j * p.vs[2] : 0);
    if constexpr (VEC) {
      copy_row16<DQK, CPY>(ks + kr * LDK, ksrc, part, ok);
      copy_row16<DV, CPY>(vs + kr * LDV, vsrc, part, ok);
    } else {
      copy_row1<DQK, CPY>(ks + kr * LDK, ksrc, part, ok);
      copy_row1<DV, CPY>(vs + kr * LDV, vsrc, part, ok);
    }
  };

  float acc[DV / 8][4];
#pragma unroll
  for (int nt = 0; nt < DV / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // rows r0, r1; l per lane

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < cnt) load(i, st0 + i);
    sm90::cp_async_commit();  // an empty group keeps the count uniform
  }
  // Q's fragments while the first steps' copies are in flight
  Warp<T, DQK, DV> w;
  {
    const T* qb = q + b * p.qs[0] + h * p.qs[1];
    w.load_q(r0 < p.t ? qb + r0 * p.qs[2] : nullptr, r1 < p.t ? qb + r1 * p.qs[2] : nullptr, t);
  }
  for (int r = 0; r < rounds; ++r) {
    sm90::cp_async_wait<kStages - 2>();  // step r has landed (this thread's copies)
    __syncthreads();                     // ... everyone's; and step r-1's stage is free
    const int nx = r + kStages - 1;
    if (nx < cnt) load(nx % kStages, st0 + nx);
    sm90::cp_async_commit();
    if (r < cnt) {  // warp-uniform: a group with fewer steps idles the last round
      const T* ks = smem + (wk * kStages + r % kStages) * kStage<T, DQK, DV>;
      float s[NJ][4];
      w.scores(ks, s, g, t);
      const int key0 = (st0 + r) * KB + 2 * t;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + j * 8 + (e & 1);
          const bool vis = key < p.s && (!p.causal || key <= (e < 2 ? r0 : r1));
          s[j][e] = vis ? s[j][e] * p.scale : kNegInf;
        }
      float x0 = kNegInf, x1 = kNegInf;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        x0 = fmaxf(x0, fmaxf(s[j][0], s[j][1]));
        x1 = fmaxf(x1, fmaxf(s[j][2], s[j][3]));
      }
      x0 = fmaxf(x0, __shfl_xor_sync(kFull, x0, 1));
      x0 = fmaxf(x0, __shfl_xor_sync(kFull, x0, 2));
      x1 = fmaxf(x1, __shfl_xor_sync(kFull, x1, 1));
      x1 = fmaxf(x1, __shfl_xor_sync(kFull, x1, 2));
      const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);
      const float a0 = expf(m0 - n0), a1 = expf(m1 - n1);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[j][0] = expf(s[j][0] - n0);
        s[j][1] = expf(s[j][1] - n0);
        s[j][2] = expf(s[j][2] - n1);
        s[j][3] = expf(s[j][3] - n1);
        sum0 += s[j][0] + s[j][1];
        sum1 += s[j][2] + s[j][3];
      }
      l0 = l0 * a0 + sum0;
      l1 = l1 * a1 + sum1;
      Warp<T, DQK, DV>::pv(s, ks + KTILE, acc, a0, a1, g, t);
      m0 = n0;
      m1 = n1;
    }
  }

  // Merge the WK partial softmaxes of each row, in the order of the
  // groups: o = sum_i f_i acc_i / max(sum_i f_i l_i, 1e-30), f_i = exp(m_i -
  // max_i m_i); a group that saw no visible key has m_i = -1e30, so f_i = 0.
  sm90::cp_async_wait<0>();
  __syncthreads();  // every group is done with its stages
  constexpr int RLD = DV + 4;
  float* red = reinterpret_cast<float*>(smem);
  float* ms = red + WK * BQ * RLD;
  float* ls = ms + WK * BQ;
  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l1 += __shfl_xor_sync(kFull, l1, 2);
  const int lr0 = wk * BQ + wq * 16 + g, lr1 = lr0 + 8;  // rows of this group's slice
  if (t == 0) {
    ms[lr0] = m0;
    ls[lr0] = l0;
    ms[lr1] = m1;
    ls[lr1] = l1;
  }
#pragma unroll
  for (int nt = 0; nt < DV / 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    red[lr0 * RLD + c] = acc[nt][0];
    red[lr0 * RLD + c + 1] = acc[nt][1];
    red[lr1 * RLD + c] = acc[nt][2];
    red[lr1 * RLD + c + 1] = acc[nt][3];
  }
  __syncthreads();
  // each thread finishes EPT consecutive head dims of one row
  constexpr int TPR = NT / BQ, EPT = DV / TPR;
  static_assert(DV % TPR == 0, "a row's head dims must split evenly over its threads");
  const int rl = tid / TPR, d0 = (tid % TPR) * EPT;
  float m_all = kNegInf;
#pragma unroll
  for (int i = 0; i < WK; ++i) m_all = fmaxf(m_all, ms[i * BQ + rl]);
  float f[WK], l_all = 0.f;
#pragma unroll
  for (int i = 0; i < WK; ++i) {
    f[i] = expf(ms[i * BQ + rl] - m_all);
    l_all += f[i] * ls[i * BQ + rl];
  }
  const float den = fmaxf(l_all, 1e-30f);
  const int row = q0 + rl;
  T* orow = o + b * p.os[0] + h * p.os[1] + (long long)row * p.os[2];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < WK; ++i) sum += f[i] * red[(i * BQ + rl) * RLD + d0 + e];
    if (row < p.t) store(orow + d0 + e, sum / den);
  }
}

// One kernel instantiation: its shared memory, raised past 48 KB once per
// device, and the blocks of it an SM holds (0 if it cannot run).
template <typename T, int DQK, int DV, bool VEC, int WQ, int WK>
int resident(int device) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> cache[kMaxDevices];  // resident blocks + 1; 0: not asked yet
  if (device < 0 || device >= kMaxDevices) return 0;
  int n = cache[device].load();
  if (n == 0) {
    constexpr int smem = smem_bytes<T, DQK, DV, WQ, WK>();
    int blocks = 0;
    if (cudaFuncSetAttribute(flash_fwd<T, DQK, DV, VEC, WQ, WK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, flash_fwd<T, DQK, DV, VEC, WQ, WK>,
                                                      32 * WQ * WK, smem) != cudaSuccess)
      blocks = 0;
    (void)cudaGetLastError();  // a refusal here shows as 0 blocks, not as the launch's error
    n = blocks + 1;
    cache[device].store(n);
  }
  return n - 1;
}

template <typename T, int DQK, int DV, bool VEC, int WQ, int WK>
void launch(const void* q, const void* k, const void* v, void* o, int bh, const Params& p,
            cudaStream_t stream) {
  const dim3 grid((p.t + 16 * WQ - 1) / (16 * WQ), bh);
  flash_fwd<T, DQK, DV, VEC, WQ, WK><<<grid, 32 * WQ * WK, smem_bytes<T, DQK, DV, WQ, WK>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), p);
}

// The calls of one instantiation (T, DQK, DV, VEC) by block shape index.
template <typename T, int DQK, int DV, bool VEC>
struct Kernels {
  static int resident(int shape, int device) {
    switch (shape) {
      case 0: return ::resident<T, DQK, DV, VEC, 1, 4>(device);
      case 1: return ::resident<T, DQK, DV, VEC, 2, 4>(device);
      default: return ::resident<T, DQK, DV, VEC, 4, 1>(device);
    }
  }
  static void launch(int shape, const void* q, const void* k, const void* v, void* o, int bh,
                     const Params& p, cudaStream_t stream) {
    switch (shape) {
      case 0: ::launch<T, DQK, DV, VEC, 1, 4>(q, k, v, o, bh, p, stream); break;
      case 1: ::launch<T, DQK, DV, VEC, 2, 4>(q, k, v, o, bh, p, stream); break;
      default: ::launch<T, DQK, DV, VEC, 4, 1>(q, k, v, o, bh, p, stream);
    }
  }
  // The block shape of a call: the one whose grid takes the fewest waves of
  // the card's resident blocks, and of those the one with the most warps in
  // flight -- a pure function of (T, B*H), the SM count and the compiled
  // kernels.  -1: no shape fits on an SM.
  static int pick(const Params& p, int bh, int device) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) sms = 1;
    int best = -1;
    long long best_waves = 0, best_warps = 0;
    for (int c = 0; c < kShapes; ++c) {
      const long long cap = (long long)resident(c, device) * sms;
      if (cap == 0) continue;
      const long long blocks = (long long)((p.t + 16 * kShape[c].wq - 1) / (16 * kShape[c].wq)) * bh;
      const long long waves = (blocks + cap - 1) / cap;
      const long long warps = blocks * kShape[c].wq * kShape[c].wk;
      if (best < 0 || waves < best_waves || (waves == best_waves && warps > best_warps)) {
        best = c;
        best_waves = waves;
        best_warps = warps;
      }
    }
    return best;
  }
};

// 16-byte copies need K's and V's bases and (batch, head, row) strides 16-byte aligned.
template <typename T>
bool vec16(const void* k, const void* v, const Params& p) {
  bool vec = reinterpret_cast<uintptr_t>(k) % 16 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  for (int i = 0; i < 3; ++i) vec = vec && (p.ks[i] * sizeof(T)) % 16 == 0 && (p.vs[i] * sizeof(T)) % 16 == 0;
  return vec;
}

// Pick the block shape (shape < 0) or take the one given, and launch unless
// `launch_it` is false; returns the shape index, or a negative CUDA error.
template <typename T, int DQK, int DV>
int run_d(const void* q, const void* k, const void* v, void* o, int bh, const Params& p, int shape,
          bool launch_it, int device, cudaStream_t stream) {
  using KV = Kernels<T, DQK, DV, true>;    // 16-byte copies
  using K1 = Kernels<T, DQK, DV, false>;   // element copies
  const bool vec = vec16<T>(k, v, p);
  if (shape < 0) shape = vec ? KV::pick(p, bh, device) : K1::pick(p, bh, device);
  if (shape < 0 || shape >= kShapes) return -(int)cudaErrorInvalidConfiguration;
  if (launch_it) {
    if ((vec ? KV::resident(shape, device) : K1::resident(shape, device)) == 0)
      return -(int)cudaErrorInvalidConfiguration;
    if (vec)
      KV::launch(shape, q, k, v, o, bh, p, stream);
    else
      K1::launch(shape, q, k, v, o, bh, p, stream);
  }
  return shape;
}

// The compiled (DQK, DV) pairs, K3_PAIRS; any other is refused.
template <typename T>
int run(const void* q, const void* k, const void* v, void* o, int bh, int d, int dv, const Params& p,
        int shape, bool launch_it, int device, cudaStream_t stream) {
#define K3_PAIR(DQK, DV) \
  if (d == DQK && dv == DV) return run_d<T, DQK, DV>(q, k, v, o, bh, p, shape, launch_it, device, stream);
  K3_PAIRS(K3_PAIR)
#undef K3_PAIR
  return -(int)cudaErrorInvalidValue;
}

int run_any(const void* q, const void* k, const void* v, void* o, int dtype, int b, int h, int hkv, int t,
            int s, int d, int dv, const long long* strides, float scale, int causal, int device, void* stream,
            int shape, bool launch_it) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  Params p;
  p.h = h;
  p.group = h / hkv;
  p.t = t;
  p.s = s;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.os[i] = strides[9 + i];
  }
  p.scale = scale;
  p.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(q, k, v, o, b * h, d, dv, p, shape, launch_it, device, st);
  if (dtype == 1) return run<__nv_bfloat16>(q, k, v, o, b * h, d, dv, p, shape, launch_it, device, st);
  return -(int)cudaErrorInvalidValue;
}

}  // namespace

// q [B, H, T, D], k [B, Hkv, S, D], v [B, Hkv, S, DV], o [B, H, T, DV], each
// through `strides` = its (batch, head, row) strides in elements, q's, k's,
// v's, then o's (12 values); the head dimension is dense.  (d, dv) one of
// the library's pairs (K3_PAIRS; any other: cudaErrorInvalidValue).
// dtype: 0 = float32, 1 = bfloat16.  H must be a multiple of Hkv; B*H at
// most 65535.  Returns the CUDA error code of the launch (0 on success); the
// caller checks it and raises.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int b, int h, int hkv, int t, int s, int d, int dv,
                                   const long long* strides, float scale, int causal,
                                   int device, void* stream) {
  const int r = run_any(q, k, v, o, dtype, b, h, hkv, t, s, d, dv, strides, scale, causal, device, stream,
                        -1, true);
  return r < 0 ? -r : (int)cudaGetLastError();
}

// The same with the block shape given (0: 16 rows x 4 key groups, 1: 32 x 4,
// 2: 64 x 1), for tests and measurements of the shapes the launcher picks from.
extern "C" int flash_attention_fwd_shape(const void* q, const void* k, const void* v, void* o,
                                         int dtype, int b, int h, int hkv, int t, int s, int d, int dv,
                                         const long long* strides, float scale, int causal,
                                         int device, void* stream, int shape) {
  if (shape < 0 || shape >= kShapes) return (int)cudaErrorInvalidValue;
  const int r = run_any(q, k, v, o, dtype, b, h, hkv, t, s, d, dv, strides, scale, causal, device, stream,
                        shape, true);
  return r < 0 ? -r : (int)cudaGetLastError();
}

// The block shape flash_attention_fwd picks for these arguments (o and the
// stream unused), or a negative CUDA error code; launches nothing.
extern "C" int flash_attention_shape(const void* q, const void* k, const void* v, int dtype, int b, int h,
                                     int hkv, int t, int s, int d, int dv, const long long* strides,
                                     int causal, int device) {
  return run_any(q, k, v, nullptr, dtype, b, h, hkv, t, s, d, dv, strides, 1.f, causal, device, nullptr, -1,
                 false);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
