// Flash-decoding attention for one generated token over a contiguous cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py
// (flash_decode / _decode_kernel): B sequences, one query token each,
// attend over their K/V held in the contiguous decode cache (B, L, KV, D),
// read in that native layout, under the caller's batch-shared (L,)
// validity mask (models/layers.py::kv_positions_for_cache /
// decode_attention_mask, passed as uint8).  The mask covers both the
// linear cache and the sliding-window ring, whose live slots are not a
// prefix once it has wrapped: the kernel trusts the mask and nothing else.
//
// Bound on an H100: bytes.  Every live slot's K and V row is read once
// (2 * live * KV * D * itemsize bytes for each sequence) for ~4 * g FLOPs
// per element read, far below the ~295 FLOP/byte where the card's
// arithmetic becomes the limit, so the floor is 2 * live * KV * D * 2
// bytes / 3.35 TB/s in bf16 (about 2.7 us for 8 sequences of 545 live
// slots at KV = 4, D = 128).
//
// Two variants; kernels/decode_tc.py::variant picks one from the dtypes
// and D.
//
// bf16 q and cache at D = 64 or 128 (flash_decode_tc_launch): the
// split-KV tensor-core main loop of decode_tc.cuh, which says what the
// split, the cp.async ring and mma.sync do.  Here slot s of sequence b
// is at (b * L + s) * KV * D + kh * D, and the chunk is a fixed number of
// slots (decode_tc.py::CHUNK); the last chunk of a cache length no chunk
// divides (577 = 4 * 128 + 65) is masked in place: there is no pad copy
// of the cache.  What the one-CTA-per-sequence design below could not
// do: its grid was B * KV CTAs (32 at the serving shape, on 132 SMs),
// each walking the cache alone with synchronous loads widened to fp32 and
// scalar FFMA products, far below the card's memory rate.
//
// fp32, mixed fp32/bf16 and other head dims (flash_decode_launch): one
// CTA per (sequence, kv head) walks the cache itself in tiles of
// kTileSlots slots and carries (m, l, acc) in shared memory: no atomics
// and no split across CTAs.  The g = H / KV query heads sharing a kv head
// are the rows of one tile, scored against one read of each K/V row (no
// expanded copy for GQA).  Tiles without a live slot are skipped (the
// Pallas pl.when(any(live))), dead slots of a live tile load as zeros,
// and a ragged last tile is masked in place.  Each warp runs the online-
// softmax update of one row with shuffle reductions in a fixed order;
// fp32 arithmetic on CUDA cores.
//
// Both variants are deterministic: a token's result never depends on
// scheduling, and greedy decoding is bit-reproducible run to run.

#include "common.cuh"
#include "decode_tc.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileSlots = 64;

// Shared-memory layout, in floats (sections 16-byte aligned).
struct Layout {
  int q_s, acc, k_s, v_s, p_s, m_s, l_s, c_s, live_s, total;
  __host__ __device__ Layout(int g, int D) {
    const int nt = kTileSlots;
    q_s = 0;                               // [g][D] scaled query rows
    acc = q_s + align4(g * D);             // [g][D] unnormalised output
    k_s = acc + align4(g * D);             // [nt][D + 1] (padded rows)
    v_s = k_s + align4(nt * (D + 1));      // [nt][D]
    p_s = v_s + align4(nt * D);            // [g][nt] scores -> probs
    m_s = p_s + align4(g * nt);            // [g] running max
    l_s = m_s + align4(g);                 // [g] running sum
    c_s = l_s + align4(g);                 // [g] this step's rescale
    live_s = c_s + align4(g);              // [nt] int: slot is live
    total = live_s + nt;
  }
};

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const TQ* __restrict__ q,                // (B, H, D)
    const TKV* __restrict__ k,               // (B, L, KV, D)
    const TKV* __restrict__ v,               // (B, L, KV, D)
    const uint8_t* __restrict__ mask,        // (L,)
    TQ* __restrict__ out,                    // (B, H, D)
    int n_heads, int n_kv, int head_dim, int cache_len, float scale) {
  const int D = head_dim, D4 = head_dim / 4, nt = kTileSlots;
  const int g = n_heads / n_kv;
  const int kh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(16) float smem[];
  const Layout lay(g, D);
  float* q_s = smem + lay.q_s;
  float* acc = smem + lay.acc;
  float* k_s = smem + lay.k_s;
  float* v_s = smem + lay.v_s;
  float* p_s = smem + lay.p_s;
  float* m_s = smem + lay.m_s;
  float* l_s = smem + lay.l_s;
  float* c_s = smem + lay.c_s;
  int* live_s = reinterpret_cast<int*>(smem + lay.live_s);

  const size_t q_row0 = ((size_t)b * n_heads + (size_t)kh * g) * D;
  for (int i = tid; i < g * D; i += kThreads) {
    q_s[i] = to_f32(q[q_row0 + i]) * scale;
    acc[i] = 0.f;
  }
  for (int i = tid; i < g; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  __syncthreads();

  // element offset of slot 0 of this (sequence, kv head); slot s adds
  // s * KV * D
  const size_t base0 = ((size_t)b * cache_len * n_kv + kh) * D;
  const size_t slot_stride = (size_t)n_kv * D;
  for (int s0 = 0; s0 < cache_len; s0 += nt) {
    int any = 0;
    for (int t = tid; t < nt; t += kThreads) {
      const int slot = s0 + t;
      const int lv = slot < cache_len && mask[slot] != 0;
      live_s[t] = lv;
      any |= lv;
    }
    if (!__syncthreads_or(any)) continue;  // no live slot: skip the tile

    for (int i = tid; i < nt * D4; i += kThreads) {
      const int t = i / D4, d = (i - t * D4) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (live_s[t]) {
        const size_t off = base0 + (size_t)(s0 + t) * slot_stride + d;
        kv = load4(k + off);
        vv = load4(v + off);
      }
      float* kr = k_s + t * (D + 1) + d;
      kr[0] = kv.x;
      kr[1] = kv.y;
      kr[2] = kv.z;
      kr[3] = kv.w;
      *reinterpret_cast<float4*>(v_s + t * D + d) = vv;
    }
    __syncthreads();

    for (int i = tid; i < g * nt; i += kThreads) {
      const int gi = i / nt, t = i - gi * nt;
      float s = kNegInf;
      if (live_s[t]) {
        const float* qr = q_s + gi * D;
        const float* kr = k_s + t * (D + 1);
        float a = 0.f;
        for (int d = 0; d < D; ++d) a = fmaf(qr[d], kr[d], a);
        s = a;
      }
      p_s[i] = s;
    }
    __syncthreads();

    // online-softmax update: one warp per row, fixed reduction order
    for (int gi = warp; gi < g; gi += kWarps) {
      float* pr = p_s + gi * nt;
      const float m_prev = m_s[gi];
      float mx = m_prev;
      for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, pr[t]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int t = lane; t < nt; t += 32) {
        const float p = live_s[t] ? expf(pr[t] - mx) : 0.f;
        pr[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_prev - mx);
        c_s[gi] = c;
        l_s[gi] = l_s[gi] * c + sum;
        m_s[gi] = mx;
      }
    }
    __syncthreads();

    for (int i = tid; i < g * D4; i += kThreads) {
      const int gi = i / D4, d = (i - gi * D4) * 4;
      const float* pr = p_s + gi * nt;
      const float c = c_s[gi];
      float4 a = *reinterpret_cast<float4*>(acc + gi * D + d);
      a.x *= c;
      a.y *= c;
      a.z *= c;
      a.w *= c;
      for (int t = 0; t < nt; ++t) {
        const float p = pr[t];
        const float4 vv = *reinterpret_cast<const float4*>(v_s + t * D + d);
        a.x = fmaf(p, vv.x, a.x);
        a.y = fmaf(p, vv.y, a.y);
        a.z = fmaf(p, vv.z, a.z);
        a.w = fmaf(p, vv.w, a.w);
      }
      *reinterpret_cast<float4*>(acc + gi * D + d) = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < g * D; i += kThreads) {
    store(out + q_row0 + i, acc[i] / fmaxf(l_s[i / D], 1e-30f));
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const uint8_t* mask,
           void* out, int B, int H, int KV, int D, int L, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)Layout(H / KV, D).total;
  auto kernel = decode_kernel<TQ, TKV>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(KV, B), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), mask, static_cast<TQ*>(out), H, KV, D, L,
      scale);
  return (int)cudaGetLastError();
}

// Slot addressing of the bf16 variant: one sequence's cache for kv head
// kh, under the batch-shared mask.
struct ContigSlots {
  const uint8_t* mask;  // (L,)
  int n;
  long long base, row;  // (b * L * KV + kh) * D, KV * D
  __device__ bool live(int s) const { return s < n && mask[s] != 0; }
  __device__ long long offset(int s) const { return base + s * row; }
};

template <int D, int S>
__global__ void __launch_bounds__(dtc::kThreads, dtc::kMinCtas)
    decode_tc_kernel(const dtc::bf16* __restrict__ q,
                     const dtc::bf16* __restrict__ k,
                     const dtc::bf16* __restrict__ v,
                     const uint8_t* __restrict__ mask,
                     float* __restrict__ ws, int H, int KV, int L,
                     int chunk, int n_chunks, float scale_log2) {
  extern __shared__ __align__(16) unsigned char dtc_smem[];
  const dtc::Cta cta(H, KV, n_chunks);
  const ContigSlots sl{mask, L,
                       ((long long)cta.r * L * KV + cta.kh) * D,
                       (long long)KV * D};
  const size_t q_off = ((size_t)cta.r * H + (size_t)cta.kh * cta.g +
                      cta.row0) * D;
  dtc::chunk_partial<D, S>(
      sl, k, v, q + q_off, cta, chunk, scale_log2,
      dtc::Workspace{ws, (size_t)gridDim.z * KV * n_chunks * cta.g, D},
      dtc_smem);
}

template <int D, int S>
int launch_tc(const void* q, const void* k, const void* v,
              const uint8_t* mask, void* out, float* ws, int B, int H,
              int KV, int L, int chunk, int n_chunks, float scale,
              cudaStream_t stream) {
  return dtc::launch<D, S>(
      decode_tc_kernel<D, S>, ws, static_cast<dtc::bf16*>(out), H, KV, B,
      n_chunks, chunk, stream, static_cast<const dtc::bf16*>(q),
      static_cast<const dtc::bf16*>(k), static_cast<const dtc::bf16*>(v),
      mask, ws, H, KV, L, chunk, n_chunks, scale * dtc::kLog2e);
}

}  // namespace

// Dynamic shared memory one CTA needs (the wrapper checks it fits).
extern "C" long long flash_decode_smem_bytes(int g, int D) {
  return (long long)sizeof(float) * Layout(g, D).total;
}

extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const uint8_t* mask,
                                   void* out, int B, int H, int KV, int D,
                                   int L, int q_dtype, int kv_dtype,
                                   float scale, void* stream) {
  if (B < 1 || KV < 1 || H % KV != 0 || D % 4 != 0 || L < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kFloat32 && kv_dtype == kFloat32)
    return launch<float, float>(q, k, v, mask, out, B, H, KV, D, L, scale, s);
  if (q_dtype == kBFloat16 && kv_dtype == kBFloat16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, mask, out, B, H, KV,
                                                D, L, scale, s);
  if (q_dtype == kFloat32 && kv_dtype == kBFloat16)
    return launch<float, __nv_bfloat16>(q, k, v, mask, out, B, H, KV, D, L,
                                        scale, s);
  if (q_dtype == kBFloat16 && kv_dtype == kFloat32)
    return launch<__nv_bfloat16, float>(q, k, v, mask, out, B, H, KV, D, L,
                                        scale, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of a partial CTA of the bf16 variant
// (decode_tc.py::smem_bytes mirrors it).
extern "C" long long flash_decode_tc_smem_bytes(int D, int chunk) {
  return dtc::smem_bytes(D, chunk);
}

// bf16 q and cache at D = 64 or 128.  chunk: slots of a chunk; n_chunks =
// ceil(L / chunk); ws: the fp32 workspace of B * KV * n_chunks * g *
// (D + 2) floats.  q and cache 16-byte aligned (16-byte cp.async).
extern "C" int flash_decode_tc_launch(const void* q, const void* k,
                                      const void* v, const uint8_t* mask,
                                      void* out, float* ws, int B, int H,
                                      int KV, int D, int L, int chunk,
                                      int n_chunks, float scale,
                                      void* stream) {
  if (B < 1 || KV < 1 || H % KV != 0 || L < 1 || chunk < 1 ||
      n_chunks != (L + chunk - 1) / chunk ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FD_TC(DD, SS)                                                 \
  if (D == DD && dtc::stages(chunk) == SS)                                  \
    return launch_tc<DD, SS>(q, k, v, mask, out, ws, B, H, KV, L, chunk,    \
                             n_chunks, scale, s);
  REPRO_FD_TC(64, 1)
  REPRO_FD_TC(64, 2)
  REPRO_FD_TC(128, 1)
  REPRO_FD_TC(128, 2)
#undef REPRO_FD_TC
  return (int)cudaErrorInvalidValue;
}
