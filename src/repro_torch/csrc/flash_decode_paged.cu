// Paged flash-decoding attention for one generated token per request.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode_paged.py
// (flash_decode_paged): R requests, one query token each, attend over
// their own K/V held in a shared page pool (P, page_size, KV, D) through a
// block table (R, M), under the caller's (R, M * page_size) validity mask
// (models/layers.py::paged_decode_attention_mask, passed as uint8).
//
// Bound on an H100: bytes.  Each request reads its live K/V once
// (2 * live * KV * D * itemsize bytes) and does ~4 * g FLOPs per element
// read, far below the ~295 FLOP/byte the card needs before its arithmetic
// is the limit, so the floor is 2 * live * KV * D * 2 bytes / 3.35 TB/s in
// bf16 (about 2.7 us for 8 requests of 545 slots at KV = 4, D = 128).
//
// Two variants; kernels/decode_tc.py::variant picks one from the dtypes
// and D.
//
// bf16 q and pages at D = 64, 80 or 128 (flash_decode_paged_tc_launch):
// the split-KV tensor-core main loop of decode_tc.cuh, which says what the
// split, the cp.async ring and mma.sync do.  Here a logical slot s of
// request r reaches its K/V row through the block table,
// (bt[r][s / ps] * ps + s % ps) * KV * D + kh * D; a chunk is a whole
// number of pages (decode_tc.py::paged_chunk), and slots past M * ps are
// masked in place.  Block-table entries past a request's pages point at
// the scratch page 0, a valid address; a dead slot's K/V row is never
// read.  What the one-CTA-per-row design below could not do: its grid was
// R * KV CTAs (32 at the serving shape, on 132 SMs), each walking ~545
// slots alone with synchronous loads widened to fp32 and scalar FFMA
// products, far below the card's memory rate.
//
// fp32, mixed fp32/bf16 and other head dims (flash_decode_paged_launch):
// one CTA per (request, kv head) walks the request's block-table row
// itself and carries (m, l, acc) in shared memory: no atomics and no
// split across CTAs.  The g = H / KV query heads sharing a kv head are
// the rows of one tile, scored against one read of each page.  A step
// takes a tile of whole pages (up to kTileSlots slots); tiles without a
// live slot are skipped (the Pallas pl.when(any(live))), dead slots of a
// live tile load as zeros.  Each warp runs the online-softmax update of
// one row with shuffle reductions in a fixed order; fp32 arithmetic on
// CUDA cores.
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
  int q_s, acc, k_s, v_s, p_s, m_s, l_s, c_s, live_s, base_s, total;
  __host__ __device__ Layout(int g, int D, int nt) {
    q_s = 0;                               // [g][D] scaled query rows
    acc = q_s + align4(g * D);             // [g][D] unnormalised output
    k_s = acc + align4(g * D);             // [nt][D + 1] (padded rows)
    v_s = k_s + align4(nt * (D + 1));      // [nt][D]
    p_s = v_s + align4(nt * D);            // [g][nt] scores -> probs
    m_s = p_s + align4(g * nt);            // [g] running max
    l_s = m_s + align4(g);                 // [g] running sum
    c_s = l_s + align4(g);                 // [g] this step's rescale
    live_s = c_s + align4(g);              // [nt] int: slot is live
    base_s = live_s + align4(nt);          // [nt] long long: slot offset
    total = base_s + 2 * nt;
  }
};

__host__ __device__ inline int tile_pages(int ps) {
  return ps >= kTileSlots ? 1 : kTileSlots / ps;
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const TQ* __restrict__ q,                // (R, H, D)
    const TKV* __restrict__ k_pages,         // (P, ps, KV, D)
    const TKV* __restrict__ v_pages,         // (P, ps, KV, D)
    const int* __restrict__ block_tables,    // (R, M)
    const uint8_t* __restrict__ mask,        // (R, M * ps)
    TQ* __restrict__ out,                    // (R, H, D)
    int n_heads, int n_kv, int head_dim, int page_size, int max_blocks,
    float scale) {
  const int D = head_dim, ps = page_size, D4 = head_dim / 4;
  const int g = n_heads / n_kv;
  const int ppt = tile_pages(ps), nt = ppt * ps;
  const int kh = blockIdx.x, r = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(16) float smem[];
  const Layout lay(g, D, nt);
  float* q_s = smem + lay.q_s;
  float* acc = smem + lay.acc;
  float* k_s = smem + lay.k_s;
  float* v_s = smem + lay.v_s;
  float* p_s = smem + lay.p_s;
  float* m_s = smem + lay.m_s;
  float* l_s = smem + lay.l_s;
  float* c_s = smem + lay.c_s;
  int* live_s = reinterpret_cast<int*>(smem + lay.live_s);
  long long* base_s = reinterpret_cast<long long*>(smem + lay.base_s);

  const size_t q_row0 = ((size_t)r * n_heads + (size_t)kh * g) * D;
  for (int i = tid; i < g * D; i += kThreads) {
    q_s[i] = to_f32(q[q_row0 + i]) * scale;
    acc[i] = 0.f;
  }
  for (int i = tid; i < g; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  __syncthreads();

  const int n_slots = max_blocks * ps;
  const uint8_t* mrow = mask + (size_t)r * n_slots;
  const int* bt_row = block_tables + (size_t)r * max_blocks;
  for (int s0 = 0; s0 < n_slots; s0 += nt) {
    // liveness and source offset of every slot of the tile
    int any = 0;
    for (int t = tid; t < nt; t += kThreads) {
      const int slot = s0 + t;
      const int lv = slot < n_slots && mrow[slot] != 0;
      live_s[t] = lv;
      base_s[t] = lv ? (((long long)bt_row[slot / ps] * ps + slot % ps)
                        * n_kv + kh) * D
                     : -1;
      any |= lv;
    }
    if (!__syncthreads_or(any)) continue;  // no live slot: skip the tile

    for (int i = tid; i < nt * D4; i += kThreads) {
      const int t = i / D4, d = (i - t * D4) * 4;
      const long long b = base_s[t];
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (b >= 0) {
        kv = load4(k_pages + b + d);
        vv = load4(v_pages + b + d);
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
        const float4 v = *reinterpret_cast<const float4*>(v_s + t * D + d);
        a.x = fmaf(p, v.x, a.x);
        a.y = fmaf(p, v.y, a.y);
        a.z = fmaf(p, v.z, a.z);
        a.w = fmaf(p, v.w, a.w);
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
int launch(const void* q, const void* kp, const void* vp, const int* bt,
           const uint8_t* mask, void* out, int R, int H, int KV, int D,
           int ps, int M, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t)Layout(H / KV, D, tile_pages(ps) * ps).total;
  auto kernel = paged_decode_kernel<TQ, TKV>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(KV, R), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), bt, mask, static_cast<TQ*>(out), H, KV,
      D, ps, M, scale);
  return (int)cudaGetLastError();
}

// Slot addressing of the bf16 variant: one request's row of the block
// table and of the mask, for kv head kh.
struct PagedSlots {
  const uint8_t* mask;  // (M * ps,)
  const int* bt;        // (M,)
  int n, ps;
  long long head, row;  // kh * D, KV * D
  __device__ bool live(int s) const { return s < n && mask[s] != 0; }
  __device__ long long offset(int s) const {
    const int b = s / ps;
    return ((long long)bt[b] * ps + (s - b * ps)) * row + head;
  }
};

template <int D, int S>
__global__ void __launch_bounds__(dtc::kThreads, dtc::kMinCtas)
    paged_decode_tc_kernel(const dtc::bf16* __restrict__ q,
                           const dtc::bf16* __restrict__ k_pages,
                           const dtc::bf16* __restrict__ v_pages,
                           const int* __restrict__ block_tables,
                           const uint8_t* __restrict__ mask,
                           float* __restrict__ ws, int H, int KV, int ps,
                           int M, int chunk, int n_chunks,
                           float scale_log2) {
  extern __shared__ __align__(16) unsigned char dtc_smem[];
  const dtc::Cta cta(H, KV, n_chunks);
  const int n = M * ps;
  const PagedSlots sl{mask + (size_t)cta.r * n,
                      block_tables + (size_t)cta.r * M, n, ps,
                      (long long)cta.kh * D, (long long)KV * D};
  const size_t q_off = ((size_t)cta.r * H + (size_t)cta.kh * cta.g +
                      cta.row0) * D;
  dtc::chunk_partial<D, S>(
      sl, k_pages, v_pages, q + q_off, cta, chunk, scale_log2,
      dtc::Workspace{ws, (size_t)gridDim.z * KV * n_chunks * cta.g, D},
      dtc_smem);
}

template <int D, int S>
int launch_tc(const void* q, const void* kp, const void* vp, const int* bt,
              const uint8_t* mask, void* out, float* ws, int R, int H, int KV,
              int ps, int M, int chunk, int n_chunks, float scale,
              cudaStream_t stream) {
  return dtc::launch<D, S>(
      paged_decode_tc_kernel<D, S>, ws, static_cast<dtc::bf16*>(out), H, KV,
      R, n_chunks, chunk, stream, static_cast<const dtc::bf16*>(q),
      static_cast<const dtc::bf16*>(kp), static_cast<const dtc::bf16*>(vp),
      bt, mask, ws, H, KV, ps, M, chunk, n_chunks, scale * dtc::kLog2e);
}

}  // namespace

// Dynamic shared memory one CTA needs (the wrapper checks it fits).
extern "C" long long flash_decode_paged_smem_bytes(int g, int D, int ps) {
  return (long long)sizeof(float) * Layout(g, D, tile_pages(ps) * ps).total;
}

extern "C" int flash_decode_paged_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const int* block_tables, const uint8_t* mask, void* out, int R, int H,
    int KV, int D, int ps, int M, int q_dtype, int kv_dtype, float scale,
    void* stream) {
  if (R < 1 || KV < 1 || H % KV != 0 || D % 4 != 0 || ps < 1 || M < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kFloat32 && kv_dtype == kFloat32)
    return launch<float, float>(q, k_pages, v_pages, block_tables, mask, out,
                                R, H, KV, D, ps, M, scale, s);
  if (q_dtype == kBFloat16 && kv_dtype == kBFloat16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k_pages, v_pages,
                                                block_tables, mask, out, R,
                                                H, KV, D, ps, M, scale, s);
  if (q_dtype == kFloat32 && kv_dtype == kBFloat16)
    return launch<float, __nv_bfloat16>(q, k_pages, v_pages, block_tables,
                                        mask, out, R, H, KV, D, ps, M, scale,
                                        s);
  if (q_dtype == kBFloat16 && kv_dtype == kFloat32)
    return launch<__nv_bfloat16, float>(q, k_pages, v_pages, block_tables,
                                        mask, out, R, H, KV, D, ps, M, scale,
                                        s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of a partial CTA of the bf16 variant
// (decode_tc.py::smem_bytes mirrors it).
extern "C" long long flash_decode_paged_tc_smem_bytes(int D, int chunk) {
  return dtc::smem_bytes(D, chunk);
}

// bf16 q and pages at D = 64, 80 or 128.  chunk: slots of a chunk, a
// whole number of pages; n_chunks = ceil(M * ps / chunk); ws: the fp32
// workspace of R * KV * n_chunks * g * (D + 2) floats.  q and pages
// 16-byte aligned (16-byte cp.async).
extern "C" int flash_decode_paged_tc_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const int* block_tables, const uint8_t* mask, void* out, float* ws,
    int R, int H, int KV, int D, int ps, int M, int chunk, int n_chunks,
    float scale, void* stream) {
  if (R < 1 || KV < 1 || H % KV != 0 || ps < 1 || M < 1 || chunk < ps ||
      chunk % ps != 0 || n_chunks != (M * ps + chunk - 1) / chunk ||
      ((uintptr_t)q | (uintptr_t)k_pages | (uintptr_t)v_pages) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FDP_TC(DD, SS)                                                \
  if (D == DD && dtc::stages(chunk) == SS)                                  \
    return launch_tc<DD, SS>(q, k_pages, v_pages, block_tables, mask, out,  \
                             ws, R, H, KV, ps, M, chunk, n_chunks, scale,   \
                             s);
  REPRO_FDP_TC(64, 1)
  REPRO_FDP_TC(64, 2)
  REPRO_FDP_TC(80, 1)
  REPRO_FDP_TC(80, 2)
  REPRO_FDP_TC(128, 1)
  REPRO_FDP_TC(128, 2)
#undef REPRO_FDP_TC
  return (int)cudaErrorInvalidValue;
}
