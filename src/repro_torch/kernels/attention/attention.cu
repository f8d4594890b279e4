// Flash attention for Hopper (sm_90a): softmax(q k^T / sqrt(D)) v, online.
//
// Replaces the Pallas TPU kernel K3, src/repro/kernels/attention/attention.py:
// _flash_kernel / flash_attention, together with its GQA wrapper
// attention/ops.py: gqa_flash (which repeats the KV heads in memory).
//
// What it computes, per batch b and head h (KV head h / (H / Hkv)):
//   o[t] = sum_j softmax_j(q[t] . k[j] * scale) v[j],  scale = 1/sqrt(D),
// over the keys j < S, or with the causal mask over j <= t (aligned top-left:
// query t sees keys 0..t whatever S is, as the Pallas kernel's
// q_pos >= kv_pos).  The running max, normaliser and accumulator are f32, the
// normaliser is floored at 1e-30 before the division, and the output is cast
// once to the input type (f32 or bf16).
//
// Bound on an H100 SXM: 4*T*S'*D FLOPs per head (S' the unmasked keys)
// against 2*(T+S)*D elements moved; at the ViT path's T = S = 196, D = 64 that
// is ~98 FLOP per f32 element, above the f32 ridge of 67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/byte, so it is bounded by operations (the f32 FMA rate).
//
// Design (a simple baseline; tensor cores are later work): the grid is
// (query tiles of BQ = 64 rows, B*H), 256 threads a block.  Each query row
// belongs to SPLIT = 4 threads, one per quarter of every key tile; each keeps
// the row's scaled q, its own accumulator, running max and normaliser in f32
// registers, and the four partial softmaxes are merged through shared memory
// at the end (exp(m_i - max m) weights; at the ViT path's 196 tokens one
// thread per row left two warps on an SM, four threads per row give eight).
// The block walks the keys in tiles of KB = 64 (32 at D = 128): K and V are
// staged as f32 in static shared memory, and the threads of a warp, which
// share a quarter, read the same key row (a broadcast).  A thread scores its
// KB/4 keys of the tile into registers, then folds them into its online
// softmax: one rescale of the accumulator per tile, as the Pallas kernel's KV
// blocks do.  Ragged T and S are masked: rows past T load nothing and store
// nothing, keys past S are never scored; under the causal mask the block
// stops at its last row's diagonal.  Loads are predicated (`if (ok) v =
// load;`), and every thread reaches every __syncthreads.  q, k, v and o are
// read and written through batch/head/row strides with a dense head
// dimension, so the model layout [B, T, H, D] needs no transpose, and a KV
// head shared by g query heads is indexed, never repeated.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int SPLIT = 4;         // threads per query row, one per quarter of a key tile
constexpr int NT = BQ * SPLIT;   // threads per block
constexpr int CH = 8;            // head dims merged per round of the final merge
constexpr float kNegInf = -1e30f;

struct Params {
  int h, group, t, s;  // query heads, query heads per KV head, query rows, keys
  long long qs[3], ks[3], vs[3], os[3];  // (batch, head, row) strides in elements
  float scale;
  int causal;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, Params p) {
  constexpr int KB = D <= 64 ? 64 : 32;  // keys per tile: K + V stay at 32 KB
  constexpr int KS = KB / SPLIT;         // keys per thread per tile
  __shared__ __align__(16) float ks[KB][D];
  __shared__ __align__(16) float vs[KB][D];
  __shared__ float part_m[SPLIT][BQ], part_l[SPLIT][BQ];
  __shared__ float red[SPLIT][CH][BQ];

  const int tid = threadIdx.x;
  const int u = tid / BQ;   // this thread's quarter of each key tile
  const int rl = tid % BQ;  // its query row within the block
  const int bh = blockIdx.y;
  const int b = bh / p.h, h = bh % p.h, hk = h / p.group;
  const int q0 = blockIdx.x * BQ;
  const int row = q0 + rl;
  const bool live = row < p.t;

  const T* qrow = q + b * p.qs[0] + h * p.qs[1] + (long long)row * p.qs[2];
  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float x = 0.f;
    if (live) x = to_f32(qrow[d]);
    qr[d] = x * p.scale;
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const T* kb = k + b * p.ks[0] + hk * p.ks[1];
  const T* vb = v + b * p.vs[0] + hk * p.vs[1];
  // keys this block needs: all S, or up to its last row's diagonal
  const int n_keys = p.causal ? (p.s < q0 + BQ ? p.s : q0 + BQ) : p.s;
  // keys this thread's row sees: up to its own diagonal under the causal mask
  const int row_keys = p.causal ? (n_keys < row + 1 ? n_keys : row + 1) : n_keys;

  for (int j0 = 0; j0 < n_keys; j0 += KB) {
    const int kn = n_keys - j0 < KB ? n_keys - j0 : KB;  // keys in this tile
    __syncthreads();  // the previous tile is consumed
#pragma unroll
    for (int i = 0; i < KB * D / NT; ++i) {
      const int e = tid + i * NT;
      const int r = e / D, c = e % D;
      float kx = 0.f, vx = 0.f;
      if (r < kn) {
        const long long j = j0 + r;
        kx = to_f32(kb[j * p.ks[2] + c]);
        vx = to_f32(vb[j * p.vs[2] + c]);
      }
      ks[r][c] = kx;
      vs[r][c] = vx;
    }
    __syncthreads();

    // this thread scores keys base + r of the tile for r < lim
    const int base = u * KS;
    int lim = row_keys - j0 - base;
    if (kn - base < lim) lim = kn - base;
    float sc[KS];
    float tmax = kNegInf;
#pragma unroll
    for (int r = 0; r < KS; ++r) {
      float x = kNegInf;
      if (r < lim) {
        const float4* kr = reinterpret_cast<const float4*>(ks[base + r]);
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
        for (int c = 0; c < D / 4; ++c) {
          const float4 kk = kr[c];
          s0 += qr[4 * c] * kk.x;
          s1 += qr[4 * c + 1] * kk.y;
          s2 += qr[4 * c + 2] * kk.z;
          s3 += qr[4 * c + 3] * kk.w;
        }
        x = (s0 + s1) + (s2 + s3);
      }
      sc[r] = x;
      tmax = fmaxf(tmax, x);
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int r = 0; r < KS; ++r) {
      if (r < lim) {
        const float pr = expf(sc[r] - m_new);
        l += pr;
        const float4* vr = reinterpret_cast<const float4*>(vs[base + r]);
#pragma unroll
        for (int c = 0; c < D / 4; ++c) {
          const float4 vv = vr[c];
          acc[4 * c] += pr * vv.x;
          acc[4 * c + 1] += pr * vv.y;
          acc[4 * c + 2] += pr * vv.z;
          acc[4 * c + 3] += pr * vv.w;
        }
      }
    }
    m = m_new;
  }

  // merge the row's SPLIT partial softmaxes: o = sum_i f_i acc_i / max(sum_i f_i l_i, 1e-30),
  // f_i = exp(m_i - max_i m_i); a quarter that saw no key has m_i = -1e30, so f_i = 0
  part_m[u][rl] = m;
  part_l[u][rl] = l;
  __syncthreads();
  float m_all = kNegInf;
#pragma unroll
  for (int i = 0; i < SPLIT; ++i) m_all = fmaxf(m_all, part_m[i][rl]);
  float l_all = 0.f;
#pragma unroll
  for (int i = 0; i < SPLIT; ++i) l_all += expf(part_m[i][rl] - m_all) * part_l[i][rl];
  const float f = expf(m - m_all);
  const float den = fmaxf(l_all, 1e-30f);
  T* orow = o + b * p.os[0] + h * p.os[1] + (long long)row * p.os[2];
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += CH) {
#pragma unroll
    for (int i = 0; i < CH; ++i) red[u][i][rl] = acc[c0 + i] * f;
    __syncthreads();
    // this thread finishes CH / SPLIT of the round's head dims
#pragma unroll
    for (int i = 0; i < CH / SPLIT; ++i) {
      const int dd = u * (CH / SPLIT) + i;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < SPLIT; ++j) sum += red[j][dd][rl];
      if (live) store(orow + c0 + dd, sum / den);
    }
    __syncthreads();
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o, int bh, const Params& p,
            cudaStream_t stream) {
  const dim3 grid((p.t + BQ - 1) / BQ, bh);
  flash_fwd<T, D><<<grid, NT, 0, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(o), p);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int bh, int d,
             const Params& p, cudaStream_t stream) {
  switch (d) {
    case 16: launch<T, 16>(q, k, v, o, bh, p, stream); break;
    case 32: launch<T, 32>(q, k, v, o, bh, p, stream); break;
    case 64: launch<T, 64>(q, k, v, o, bh, p, stream); break;
    case 128: launch<T, 128>(q, k, v, o, bh, p, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// q [B, H, T, D], k / v [B, Hkv, S, D], o [B, H, T, D], each through
// `strides` = its (batch, head, row) strides in elements, q's, k's, v's, then
// o's (12 values); the head dimension is dense.  dtype: 0 = float32,
// 1 = bfloat16.  H must be a multiple of Hkv; B*H at most 65535.  Returns the
// CUDA error code of the launch (0 on success); the caller checks it and raises.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int b, int h, int hkv, int t, int s, int d,
                                   const long long* strides, float scale, int causal,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
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
  int bad;
  if (dtype == 0)
    bad = dispatch<float>(q, k, v, o, b * h, d, p, st);
  else if (dtype == 1)
    bad = dispatch<__nv_bfloat16>(q, k, v, o, b * h, d, p, st);
  else
    bad = (int)cudaErrorInvalidValue;
  if (bad) return bad;
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
