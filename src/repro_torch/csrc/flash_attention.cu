// Flash attention over contiguous q, k, v: causal, sliding-window and GQA.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _flash_kernel).  q (B, Sq, H, D), k and v
// (B, Skv, KV, D) with H % KV == 0, fp32 or bf16; out (B, Sq, H, D) in q's
// dtype.  Query and key positions both count from 0.  A key is masked
// where kv_pos >= Skv; under causal, where q_pos < kv_pos; under window,
// where q_pos - kv_pos >= window (one-sided: without causal, later keys
// stay visible).  Masked scores are -1e30, not -inf, and the online
// softmax is the TPU kernel's step for step: m_new = max(m, max s),
// p = exp(s - m_new), l = l * exp(m - m_new) + sum p, acc likewise, and
// out = acc / max(l, 1e-30).
//
// Bound on an H100: operations for long sequences (4 * D * H * the causal
// pairs over 989 TFLOP/s in bf16: Qwen2-7B prefill at 4,096 tokens is
// about 120 GFLOP), bytes for short ones (q, k, v and out read or written
// once over 3.35 TB/s).  This kernel's fp32 CUDA-core arithmetic is the
// limit in practice.
//
// Design.  The TPU kernel folded batch and heads into one grid axis after
// a transpose and a pad copy, and carried (m, l, acc) across the
// sequential kv grid axis in VMEM.  Here one CTA of 256 threads owns
// (q tile of block_q positions, head, batch) and walks the kv tiles of
// block_kv keys in order with (m, l, acc) in registers: no split over kv,
// no atomic, so results are deterministic.  It reads the native strided
// layout — no transpose, no pad copy — and masks the ragged last q and kv
// tiles in place (keys past Skv load as zeros).  GQA reads kv head
// h / (H / KV) with no K/V repeat.  kv tiles above the diagonal (under
// causal) and wholly outside the window are never visited.  Per kv tile:
// scores q_tile @ k_tile^T in 32-key chunks into a shared fp32 P tile,
// the online-softmax update of each row by the 16 threads that own it
// (fixed-order butterfly reductions), then acc += P @ v_tile; K and V
// share one shared buffer.  Thread (ty, tx) owns rows ty + 16 i and
// output columns tx + 16 c.  Shared memory: the scaled fp32 q tile
// (block_q x (D + 1)), P (block_q x (block_kv + 1)) and the K/V tile
// (block_kv x padded D) — the autotuner's budget filters (block_q,
// block_kv) by exactly this number.  fp32 FFMA for both dtypes: no TF32,
// no bf16 rounding of P.  A later PR moves both products onto tensor
// cores (mma/wgmma) with TMA-fed tiles.

#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;

// K/V tile row stride in elements: odd in 32-bit words, so the 16 threads
// that read 16 keys at one d fall on distinct banks
template <typename T>
__host__ __device__ constexpr int kv_stride(int D) {
  return sizeof(T) == 4 ? D + 1 : D + 2;
}

template <typename T>
__host__ __device__ inline long long smem_bytes_t(int bq, int bkv, int D) {
  return 4LL * bq * (D + 1) + 4LL * bq * (bkv + 1) +
         (long long)sizeof(T) * bkv * kv_stride<T>(D);
}

__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void store_zero(float* p) { *p = 0.f; }
__device__ __forceinline__ void store_zero(__nv_bfloat16* p) {
  *p = __float2bfloat16(0.f);
}

template <typename T, int BQ, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q,    // (B, Sq, H, D)
    const T* __restrict__ k,    // (B, Skv, KV, D)
    const T* __restrict__ v,    // (B, Skv, KV, D)
    T* __restrict__ out,        // (B, Sq, H, D)
    int Sq, int Skv, int H, int KV, int bkv, int causal, int window,
    float scale) {
  constexpr int RQ = BQ / 16, DC = D / 16, QS = D + 1;
  constexpr int KS = kv_stride<T>(D);
  const int PS = bkv + 1;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KV);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // [BQ][QS]
  float* p_s = q_s + BQ * QS;                       // [BQ][PS]
  T* kv_s = reinterpret_cast<T*>(p_s + BQ * PS);    // [bkv][KS]

  const int q0 = qt * BQ;
  const size_t q_step = (size_t)H * D, kv_step = (size_t)KV * D;
  const T* qb = q + ((size_t)b * Sq * H + h) * D;
  const T* kb = k + ((size_t)b * Skv * KV + kh) * D;
  const T* vb = v + ((size_t)b * Skv * KV + kh) * D;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i % D, pos = q0 + r;
    q_s[r * QS + d] = pos < Sq ? to_f32(qb[pos * q_step + d]) * scale : 0.f;
  }

  float acc[RQ][DC], m[RQ], l[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = (Skv + bkv - 1) / bkv;
  int t_end = n_tiles;
  if (causal) t_end = min(n_tiles, (q0 + BQ - 1) / bkv + 1);
  int t_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) t_begin = (q0 - window + 1) / bkv;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * bkv;
    for (int i = tid; i < bkv * D; i += kThreads) {
      const int r = i / D, d = i % D, pos = k0 + r;
      if (pos < Skv)
        kv_s[r * KS + d] = kb[pos * kv_step + d];
      else
        store_zero(kv_s + r * KS + d);
    }
    __syncthreads();

    // scores of this thread's rows against keys c0 + tx and c0 + 16 + tx
    for (int c0 = 0; c0 < bkv; c0 += 32) {
      float s[RQ][2];
#pragma unroll
      for (int i = 0; i < RQ; ++i) s[i][0] = s[i][1] = 0.f;
      const T* k_a = kv_s + (c0 + tx) * KS;
      const T* k_b = kv_s + (c0 + 16 + tx) * KS;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float ka = to_f32(k_a[d]), kb2 = to_f32(k_b[d]);
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          const float qv = q_s[(ty + 16 * i) * QS + d];
          s[i][0] = fmaf(qv, ka, s[i][0]);
          s[i][1] = fmaf(qv, kb2, s[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int row = ty + 16 * i, qpos = q0 + row;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int col = c0 + 16 * u + tx, kpos = k0 + col;
          const bool on = kpos < Skv && (!causal || qpos >= kpos) &&
                          (window == 0 || qpos - kpos < window);
          p_s[row * PS + col] = on ? s[i][u] : kNegInf;
        }
      }
    }
    __syncthreads();

    // V into the shared buffer, and the online-softmax step of each row
    for (int i = tid; i < bkv * D; i += kThreads) {
      const int r = i / D, d = i % D, pos = k0 + r;
      if (pos < Skv)
        kv_s[r * KS + d] = vb[pos * kv_step + d];
      else
        store_zero(kv_s + r * KS + d);
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      float* pr = p_s + (ty + 16 * i) * PS;
      float mx = kNegInf;
      for (int j = tx; j < bkv; j += 16) mx = fmaxf(mx, pr[j]);
      const float m_new = fmaxf(m[i], half_max(mx));
      float sum = 0.f;
      for (int j = tx; j < bkv; j += 16) {
        const float p = expf(pr[j] - m_new);
        pr[j] = p;
        sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + half_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    for (int j = 0; j < bkv; ++j) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = to_f32(kv_s[j * KS + tx + 16 * c]);
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float p = p_s[(ty + 16 * i) * PS + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Sq) continue;
    T* o = out + ((size_t)b * Sq + qpos) * q_step + (size_t)h * D;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) store(o + tx + 16 * c, acc[i][c] / den);
  }
}

template <typename T, int BQ, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int H, int KV, int bkv, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = (size_t)smem_bytes_t<T>(BQ, bkv, D);
  auto kernel = flash_attention_kernel<T, BQ, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, KV, bkv,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_bq(int bq, const void* q, const void* k, const void* v, void* out,
              int B, int Sq, int Skv, int H, int KV, int bkv, int causal,
              int window, float scale, cudaStream_t s) {
  switch (bq) {
    case 32:
      return launch<T, 32, D>(q, k, v, out, B, Sq, Skv, H, KV, bkv, causal,
                              window, scale, s);
    case 64:
      return launch<T, 64, D>(q, k, v, out, B, Sq, Skv, H, KV, bkv, causal,
                              window, scale, s);
    case 128:
      return launch<T, 128, D>(q, k, v, out, B, Sq, Skv, H, KV, bkv, causal,
                               window, scale, s);
    case 256:
      return launch<T, 256, D>(q, k, v, out, B, Sq, Skv, H, KV, bkv, causal,
                               window, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_d(int D, int bq, const void* q, const void* k, const void* v,
             void* out, int B, int Sq, int Skv, int H, int KV, int bkv,
             int causal, int window, float scale, cudaStream_t s) {
  if (D == 64)
    return launch_bq<T, 64>(bq, q, k, v, out, B, Sq, Skv, H, KV, bkv, causal,
                            window, scale, s);
  if (D == 128)
    return launch_bq<T, 128>(bq, q, k, v, out, B, Sq, Skv, H, KV, bkv,
                             causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Dynamic shared memory of one CTA for tiles (block_q, block_kv): the
// wrapper's smem_bytes mirrors it and the autotuner filters on it.
extern "C" long long flash_attention_smem_bytes(int block_q, int block_kv,
                                                int D, int dtype) {
  return dtype == kBFloat16
             ? smem_bytes_t<__nv_bfloat16>(block_q, block_kv, D)
             : smem_bytes_t<float>(block_q, block_kv, D);
}

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int Sq, int Skv, int H, int KV, int D,
                                      int block_q, int block_kv, int causal,
                                      int window, int dtype, float scale,
                                      void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV != 0 || window < 0 ||
      block_kv < 32 || block_kv % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_d<float>(D, block_q, q, k, v, out, B, Sq, Skv, H, KV,
                           block_kv, causal, window, scale, s);
  if (dtype == kBFloat16)
    return launch_d<__nv_bfloat16>(D, block_q, q, k, v, out, B, Sq, Skv, H,
                                   KV, block_kv, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
