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
// no bf16 rounding of P.
//
// bf16 variant (flash_attention_tc_launch, for bf16 q, k, v at D = 64 or
// 128; the wrapper's variant() picks it): the tensor-core main loop of
// attention_tc.cuh — wgmma for both products, P in bf16 — with Q, K and V
// tiles brought by TMA from tensor maps over the native (B * S, heads * D)
// views (no transpose, no pad copy): a box of 64 columns at column
// head * D + 64 c, of block_q query rows or block_kv key rows.  GQA reads
// kv head h / (H / KV); kv tiles above the diagonal or wholly outside the
// window are never loaded; keys past Skv (the next batch's rows, or TMA's
// zero fill past the end) and ragged q rows are masked or left unwritten
// in place.  Under causal, blockIdx.x walks the q tiles in reverse, so
// the CTAs with the most kv tiles start first and the grid's tail is
// short.  At (1, 4096, 28 / 4, 128) causal the products are 120 GFLOP,
// so operations bound it.

#include "attention_tc.cuh"
#include "common.cuh"
#include "tma.cuh"

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

// ------------------------------------------------- bf16 tensor-core variant
namespace {

using bf16 = __nv_bfloat16;
using repro::tc::Bars;
using repro::tc::Tile;

struct TcMask {
  int q0, bq, bkv, skv, causal, window;
  __device__ bool visible(int row, int key) const {
    const int qpos = q0 + row;
    return key < skv && (!causal || qpos >= key) &&
           (window == 0 || qpos - key < window);
  }
  __device__ bool full(int t) const {
    const int lo = t * bkv, hi = lo + bkv - 1;
    return hi < skv && (!causal || q0 >= hi) &&
           (window == 0 || q0 + bq - 1 - lo < window);
  }
};

struct TcOut {
  bf16* base;     // row q0 of (b, h)
  int rows;       // Sq - q0
  size_t stride;  // H * D
  __device__ bf16* row(int r) const {
    return r < rows ? base + (size_t)r * stride : nullptr;
  }
  __device__ bool zero(int) const { return false; }
};

template <int BQ, int BKV, int D>
__global__ void __launch_bounds__(Tile<BQ, BKV, D>::kThreads, 1)
    flash_attention_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              bf16* __restrict__ out, int Sq, int Skv, int H,
                              int KV, int causal, int window,
                              float scale_log2) {
  using T = Tile<BQ, BKV, D>;
  extern __shared__ unsigned char tc_smem[];
  uint8_t* smem = repro::tc::setup<BQ, BKV, D>(tc_smem, 1);
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / (H / KV);
  const int q0 = qt * BQ;
  const int n_kv = (Skv + BKV - 1) / BKV;
  const int t_end = causal ? min(n_kv, (q0 + BQ - 1) / BKV + 1) : n_kv;
  const int t_begin =
      (window > 0 && q0 - window + 1 > 0) ? (q0 - window + 1) / BKV : 0;
  const int n_tiles = max(0, t_end - t_begin);
  // warp-uniform (broadcast from lane 0), so the compiler sees the role
  // split below as no divergence around the consumers' wgmma
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);

  if (warp >= T::kNC * 4) {  // producer: one thread issues every TMA load
    // with two consumer warpgroups: 168 - 24 registers a producer thread
    // go to the consumers (168 -> 240), which then hold S, P and O of a
    // 128-key tile without spilling
    if constexpr (T::kNC == 2) repro::tc::setmaxnreg_dec<24>();
    if (threadIdx.x % 128 != 0 || n_tiles == 0) return;
    Bars* bars = reinterpret_cast<Bars*>(smem + T::kBars);
    const uint32_t base = repro::tc::smem_u32(smem);
    repro::tc::mbar_expect_tx(&bars->q_full, T::kQBytes);
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
      repro::tc::tma_load_2d(base + T::kQ + c * BQ * 128, &q_map,
                             &bars->q_full, h * D + 64 * c, b * Sq + q0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % T::kStages, k0 = b * Skv + (t_begin + i) * BKV;
      const uint32_t ph = ((i / T::kStages) & 1) ^ 1;
      repro::tc::mbar_wait(&bars->k_empty[st], ph);
      repro::tc::mbar_expect_tx(&bars->k_full[st], T::kKVBytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        repro::tc::tma_load_2d(base + T::kK + st * T::kKVBytes + c * BKV * 128,
                               &k_map, &bars->k_full[st], kh * D + 64 * c,
                               k0);
      repro::tc::mbar_wait(&bars->v_empty[st], ph);
      repro::tc::mbar_expect_tx(&bars->v_full[st], T::kKVBytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        repro::tc::tma_load_2d(base + T::kV + st * T::kKVBytes + c * BKV * 128,
                               &v_map, &bars->v_full[st], kh * D + 64 * c,
                               k0);
    }
  } else {
    if constexpr (T::kNC == 2) repro::tc::setmaxnreg_inc<240>();
    const TcMask mask{q0, BQ, BKV, Skv, causal, window};
    const TcOut o{out + ((size_t)b * Sq + q0) * H * D + (size_t)h * D,
                  Sq - q0, (size_t)H * D};
    repro::tc::consume<BQ, BKV, D>(smem, warp / 4, t_begin, n_tiles,
                                      scale_log2, mask, o);
  }
}

template <int BQ, int BKV, int D>
int launch_tc(const void* q, const void* k, const void* v, void* out, int B,
              int Sq, int Skv, int H, int KV, int causal, int window,
              float scale, cudaStream_t stream) {
  using repro::tma::encode_bf16;
  CUtensorMap qm, km, vm;
  int e = encode_bf16(&qm, q, (long long)B * Sq, (long long)H * D, BQ);
  if (e == 0)
    e = encode_bf16(&km, k, (long long)B * Skv, (long long)KV * D, BKV);
  if (e == 0)
    e = encode_bf16(&vm, v, (long long)B * Skv, (long long)KV * D, BKV);
  if (e != 0) return e;
  const size_t smem = (size_t)repro::tc::smem_bytes(BQ, BKV, D);
  auto kernel = flash_attention_tc_kernel<BQ, BKV, D>;
  const cudaError_t a = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (a != cudaSuccess) return (int)a;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, Tile<BQ, BKV, D>::kThreads, smem, stream>>>(
      qm, km, vm, static_cast<bf16*>(out), Sq, Skv, H, KV, causal, window,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <int D>
int launch_tc_tiles(int bq, int bkv, const void* q, const void* k,
                    const void* v, void* out, int B, int Sq, int Skv, int H,
                    int KV, int causal, int window, float scale,
                    cudaStream_t s) {
  if (bq == 64 && bkv == 64)
    return launch_tc<64, 64, D>(q, k, v, out, B, Sq, Skv, H, KV, causal,
                                window, scale, s);
  if (bq == 64 && bkv == 128)
    return launch_tc<64, 128, D>(q, k, v, out, B, Sq, Skv, H, KV, causal,
                                 window, scale, s);
  if (bq == 128 && bkv == 64)
    return launch_tc<128, 64, D>(q, k, v, out, B, Sq, Skv, H, KV, causal,
                                 window, scale, s);
  if (bq == 128 && bkv == 128)
    return launch_tc<128, 128, D>(q, k, v, out, B, Sq, Skv, H, KV, causal,
                                  window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Dynamic shared memory of one CTA of the bf16 variant:
// kernels/attention_tc.py::smem_bytes mirrors it and the autotuner
// filters on it.
extern "C" long long flash_attention_tc_smem_bytes(int block_q, int block_kv,
                                                   int D) {
  return repro::tc::smem_bytes(block_q, block_kv, D);
}

// bf16 q, k, v at D = 64 or 128; block_q and block_kv 64 or 128; every
// base 16-byte aligned (TMA).
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* out, int B,
                                         int Sq, int Skv, int H, int KV,
                                         int D, int block_q, int block_kv,
                                         int causal, int window, float scale,
                                         void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV != 0 || window < 0 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_tc_tiles<64>(block_q, block_kv, q, k, v, out, B, Sq, Skv,
                               H, KV, causal, window, scale, s);
  if (D == 128)
    return launch_tc_tiles<128>(block_q, block_kv, q, k, v, out, B, Sq, Skv,
                                H, KV, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
