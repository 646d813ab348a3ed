// Batched ragged prefill attention over a block-table paged KV cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_prefill_ragged.py
// (flash_prefill_ragged): each of R admissions computes causal attention
// for its suffix queries q (R, S, H, D) — the prompt after its shared
// prefix, starting at absolute position offsets[r], lens[r] of them valid —
// over its K/V pages (shared prefix plus the suffix the layer has just
// written) in a page pool (P, page_size, KV, D) through a block table
// (R, M).  Query i of request r attends slot j iff
// j <= offsets[r] + i and i < lens[r]
// (models/layers.py::ragged_prefill_attention_mask); rows at or past
// lens[r] come out as 0.
//
// Bound on an H100: the larger of 4 * H * D * sum(causal pairs) FLOPs over
// 989 TFLOP/s and the bytes read and written (q, out, live K/V) over
// 3.35 TB/s.  At serving shapes (D = 128, suffixes of a few hundred
// tokens) both are tens of microseconds; this kernel's fp32 CUDA-core
// arithmetic is the limit in practice.
//
// Design.  One CTA per (q tile of block_q positions, kv head, request)
// loops over the request's pages up to the causal frontier of its last
// live query and carries (m, l, acc) for all block_q * g rows in shared
// memory — no atomics and no split across CTAs, so results are bit-
// reproducible.  The g query heads sharing a kv head are adjacent rows of
// the tile and score against one read of each page.  Pages past the
// frontier and q tiles past lens[r] are never visited (the Pallas
// pl.when(any(live))); the dead-row guard p = live ? exp(s - m) : 0 keeps
// fully masked rows and idle slots (lens == 0) at l = 0, hence output 0,
// instead of a uniform average.  K is held transposed so a thread scoring
// its row reads 16 slots of one d with four float4 broadcasts; the PV
// update works on float4 columns.
//
// bf16 variant (flash_prefill_ragged_tc_launch, for bf16 q and pages at
// D = 64 or 128; the wrapper's variant() picks it): the tensor-core main
// loop of attention_tc.cuh.  One CTA per (q tile of block_q suffix
// positions, QUERY head, request): no g-fold — a 512-token prefill is
// bound by operations (about 15 GFLOP against 67 MB), and g = 7 folded
// rows would not fill 64-row wgmma tiles; one request's K/V of one kv
// head (at most a few hundred KB) stays in L2 across its g query heads.
// The producer warpgroup gathers Q rows and 64-key K/V tiles through the
// block table with 16-byte cp.async into the swizzled layout (any page
// size: a tile spans 64 / page_size pages or part of one), zero-filling
// slots past the tile's causal frontier; the barriers complete on
// cp.async.mbarrier.arrive.  q tiles past lens[r] and idle slots do no
// work, kv tiles past the frontier are never visited, rows at or past
// lens[r] are written 0, and q tiles run last to first (most work
// first).

#include "attention_tc.cuh"
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;
constexpr int kTile = 16;  // slots scored per register tile

__host__ __device__ inline int pad_ps(int ps) {
  return (ps + kTile - 1) / kTile * kTile;
}

// Shared-memory layout, in floats (every section a multiple of 4).
struct Layout {
  int acc, k_t, v_s, p_s, m_s, l_s, c_s, total;
  __host__ __device__ Layout(int rows, int D, int ps) {
    acc = 0;
    k_t = acc + align4(rows * D);         // [D][pad_ps(ps)] transposed K
    v_s = k_t + align4(D * pad_ps(ps));   // [ps][D]
    p_s = v_s + align4(ps * D);           // [rows][ps]
    m_s = p_s + align4(rows * ps);        // [rows]
    l_s = m_s + align4(rows);             // [rows]
    c_s = l_s + align4(rows);             // [rows]
    total = c_s + align4(rows);
  }
};

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) ragged_prefill_kernel(
    const TQ* __restrict__ q,                // (R, S, H, D)
    const TKV* __restrict__ k_pages,         // (P, ps, KV, D)
    const TKV* __restrict__ v_pages,         // (P, ps, KV, D)
    const int* __restrict__ block_tables,    // (R, M)
    const int* __restrict__ offsets,         // (R,)
    const int* __restrict__ lens,            // (R,)
    TQ* __restrict__ out,                    // (R, S, H, D)
    int seq, int n_heads, int n_kv, int head_dim, int page_size,
    int max_blocks, int block_q, float scale) {
  const int D = head_dim, ps = page_size, ps_pad = pad_ps(page_size);
  const int D4 = D / 4;
  const int g = n_heads / n_kv;
  const int qt = blockIdx.x, kh = blockIdx.y, r = blockIdx.z;
  const int tid = threadIdx.x;
  const int rows = block_q * g;  // row = (query in tile) * g + head in group

  extern __shared__ __align__(16) float smem[];
  const Layout lay(rows, D, ps);
  float* acc = smem + lay.acc;
  float* k_t = smem + lay.k_t;
  float* v_s = smem + lay.v_s;
  float* p_s = smem + lay.p_s;
  float* m_s = smem + lay.m_s;
  float* l_s = smem + lay.l_s;
  float* c_s = smem + lay.c_s;

  const int off = offsets[r], len = lens[r];
  const int q0 = qt * block_q;
  // live query rows of this tile: q0 <= qrel < q_end
  const int q_end = min(min(q0 + block_q, seq), len);
  const int kv_last = off + q_end - 1;  // causal frontier of the tile
  const int n_pages = q_end > q0 ? min(max_blocks, kv_last / ps + 1) : 0;

  for (int i = tid; i < rows * D; i += kThreads) acc[i] = 0.f;
  for (int i = tid; i < D * ps_pad; i += kThreads) k_t[i] = 0.f;
  for (int i = tid; i < rows; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  __syncthreads();

  const int* bt_row = block_tables + (size_t)r * max_blocks;
  const size_t tok_stride = (size_t)n_kv * D;
  for (int j = 0; j < n_pages; ++j) {
    const size_t base = ((size_t)bt_row[j] * ps * n_kv + kh) * D;
    for (int i = tid; i < ps * D; i += kThreads) {
      const int t = i / D, d = i - t * D;
      const bool on = j * ps + t <= kv_last;  // slots past the frontier: 0
      const size_t o = base + t * tok_stride + d;
      k_t[d * ps_pad + t] = on ? to_f32(k_pages[o]) : 0.f;
      v_s[i] = on ? to_f32(v_pages[o]) : 0.f;
    }
    __syncthreads();

    // scores and the online-softmax update, one thread per live row
    for (int row = tid; row < rows; row += kThreads) {
      const int ql = row / g, gi = row - ql * g;
      const int qrel = q0 + ql;
      if (qrel >= q_end) continue;  // dead row: stays at m=-inf, l=0, acc=0
      const int kv_lim = off + qrel;
      const TQ* qr = q + (((size_t)r * seq + qrel) * n_heads
                          + (size_t)kh * g + gi) * D;
      float* pr = p_s + row * ps;
      const float m_prev = m_s[row];
      float m_new = m_prev;
      for (int t0 = 0; t0 < ps; t0 += kTile) {
        float a[kTile];
#pragma unroll
        for (int u = 0; u < kTile; ++u) a[u] = 0.f;
        for (int d = 0; d < D; ++d) {
          const float qv = to_f32(qr[d]) * scale;
          const float4* kc =
              reinterpret_cast<const float4*>(k_t + d * ps_pad + t0);
#pragma unroll
          for (int u4 = 0; u4 < kTile / 4; ++u4) {
            const float4 kk = kc[u4];
            a[4 * u4 + 0] = fmaf(qv, kk.x, a[4 * u4 + 0]);
            a[4 * u4 + 1] = fmaf(qv, kk.y, a[4 * u4 + 1]);
            a[4 * u4 + 2] = fmaf(qv, kk.z, a[4 * u4 + 2]);
            a[4 * u4 + 3] = fmaf(qv, kk.w, a[4 * u4 + 3]);
          }
        }
#pragma unroll
        for (int u = 0; u < kTile; ++u) {
          const int t = t0 + u;
          if (t < ps) {
            const bool on = j * ps + t <= kv_lim;
            pr[t] = on ? a[u] : kNegInf;
            if (on) m_new = fmaxf(m_new, a[u]);
          }
        }
      }
      float sum = 0.f;
      for (int t = 0; t < ps; ++t) {
        // dead-row guard: a masked slot contributes exactly 0
        const float p = (j * ps + t <= kv_lim) ? expf(pr[t] - m_new) : 0.f;
        pr[t] = p;
        sum += p;
      }
      const float c = expf(m_prev - m_new);
      c_s[row] = c;
      l_s[row] = l_s[row] * c + sum;
      m_s[row] = m_new;
    }
    __syncthreads();

    // acc[row] = acc[row] * c + p[row] @ V, four columns per thread
    for (int i = tid; i < rows * D4; i += kThreads) {
      const int row = i / D4, d4 = i - row * D4;
      if (q0 + row / g >= q_end) continue;
      const float* pr = p_s + row * ps;
      const float c = c_s[row];
      float4 a = reinterpret_cast<float4*>(acc)[i];
      a.x *= c;
      a.y *= c;
      a.z *= c;
      a.w *= c;
      for (int t = 0; t < ps; ++t) {
        const float p = pr[t];
        const float4 vv = reinterpret_cast<const float4*>(v_s + t * D)[d4];
        a.x = fmaf(p, vv.x, a.x);
        a.y = fmaf(p, vv.y, a.y);
        a.z = fmaf(p, vv.z, a.z);
        a.w = fmaf(p, vv.w, a.w);
      }
      reinterpret_cast<float4*>(acc)[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < rows * D; i += kThreads) {
    const int row = i / D, d = i - row * D;
    const int ql = row / g, gi = row - ql * g;
    const int qrel = q0 + ql;
    if (qrel < seq)
      store(out + (((size_t)r * seq + qrel) * n_heads + (size_t)kh * g + gi)
                      * D + d,
            acc[i] / fmaxf(l_s[row], 1e-30f));
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* kp, const void* vp, const int* bt,
           const int* offsets, const int* lens, void* out, int R, int S,
           int H, int KV, int D, int ps, int M, int block_q, float scale,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t)Layout(block_q * (H / KV), D, ps).total;
  auto kernel = ragged_prefill_kernel<TQ, TKV>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_qt = (S + block_q - 1) / block_q;
  kernel<<<dim3(n_qt, KV, R), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), bt, offsets, lens, static_cast<TQ*>(out),
      S, H, KV, D, ps, M, block_q, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory one CTA needs: the wrapper picks block_q with it.
extern "C" long long flash_prefill_ragged_smem_bytes(int block_q, int g,
                                                     int D, int ps) {
  return (long long)sizeof(float) * Layout(block_q * g, D, ps).total;
}

extern "C" int flash_prefill_ragged_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const int* block_tables, const int* offsets, const int* lens, void* out,
    int R, int S, int H, int KV, int D, int ps, int M, int block_q,
    int q_dtype, int kv_dtype, float scale, void* stream) {
  if (R < 1 || S < 1 || KV < 1 || H % KV != 0 || D % 4 != 0 || ps < 1 ||
      M < 1 || block_q < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kFloat32 && kv_dtype == kFloat32)
    return launch<float, float>(q, k_pages, v_pages, block_tables, offsets,
                                lens, out, R, S, H, KV, D, ps, M, block_q,
                                scale, s);
  if (q_dtype == kBFloat16 && kv_dtype == kBFloat16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pages, v_pages, block_tables, offsets, lens, out, R, S, H, KV,
        D, ps, M, block_q, scale, s);
  if (q_dtype == kFloat32 && kv_dtype == kBFloat16)
    return launch<float, __nv_bfloat16>(q, k_pages, v_pages, block_tables,
                                        offsets, lens, out, R, S, H, KV, D,
                                        ps, M, block_q, scale, s);
  if (q_dtype == kBFloat16 && kv_dtype == kFloat32)
    return launch<__nv_bfloat16, float>(q, k_pages, v_pages, block_tables,
                                        offsets, lens, out, R, S, H, KV, D,
                                        ps, M, block_q, scale, s);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------- bf16 tensor-core variant
namespace {

using bf16 = __nv_bfloat16;
using repro::tc::Bars;
using repro::tc::Tile;

constexpr int kTcKV = 64;  // keys per kv tile

// Query i of request r sees slot j iff j <= offsets[r] + i and
// i < lens[r] (models/layers.py::ragged_prefill_attention_mask).
struct TcMask {
  int q0, off, len;
  __device__ bool visible(int row, int key) const {
    const int qrel = q0 + row;
    return key <= off + qrel && qrel < len;
  }
  // every row of the tile sees the whole kv tile (dead rows are zeroed
  // on output whatever they compute)
  __device__ bool full(int t) const {
    return t * kTcKV + kTcKV - 1 <= off + q0;
  }
};

struct TcOut {
  bf16* base;     // row q0 of (r, h)
  int rows;       // S - q0
  int live;       // lens[r] - q0
  size_t stride;  // H * D
  __device__ bf16* row(int i) const {
    return i < rows ? base + (size_t)i * stride : nullptr;
  }
  __device__ bool zero(int i) const { return i >= live; }
};

template <int BQ, int D>
__global__ void __launch_bounds__(Tile<BQ, kTcKV, D>::kThreads, 1)
    ragged_prefill_tc_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k_pages,
                             const bf16* __restrict__ v_pages,
                             const int* __restrict__ block_tables,
                             const int* __restrict__ offsets,
                             const int* __restrict__ lens,
                             bf16* __restrict__ out, int S, int H, int KV,
                             int ps, int M, float scale_log2) {
  using T = Tile<BQ, kTcKV, D>;
  extern __shared__ unsigned char tc_smem[];
  uint8_t* smem = repro::tc::setup<BQ, kTcKV, D>(tc_smem, 128);
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, r = blockIdx.z, kh = h / (H / KV);
  const int off = offsets[r], len = lens[r], q0 = qt * BQ;
  const int q_end = min(min(q0 + BQ, S), len);   // live rows: q0 .. q_end-1
  const int kv_last = off + q_end - 1;           // the tile's causal frontier
  const int n_tiles = q_end > q0 ? kv_last / kTcKV + 1 : 0;
  // warp-uniform (broadcast from lane 0), so the compiler sees the role
  // split below as no divergence around the consumers' wgmma
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);

  if (warp >= T::kNC * 4) {  // producer warpgroup: gathers with cp.async
    if (n_tiles == 0) return;
    Bars* bars = reinterpret_cast<Bars*>(smem + T::kBars);
    const uint32_t base = repro::tc::smem_u32(smem);
    // this thread copies 16-byte chunk c of rows j0, j0 + kStep, ... of
    // the Q tile and of each kv tile; a row of zeros reads nothing
    constexpr int kChunks = D / 8, kStep = 128 / kChunks;
    constexpr int kRows = kTcKV / kStep;
    const int pt = threadIdx.x - T::kNC * 128;
    const int c = pt % kChunks, j0 = pt / kChunks;
    const size_t q_row = (size_t)H * D, kv_row = (size_t)KV * D;
    const bf16* qb = q + ((size_t)r * S * H + h) * D + 8 * c;
    for (int j = j0; j < BQ; j += kStep) {
      const bool live = q0 + j < q_end;
      repro::tc::cp_async16(base + T::kQ + repro::tc::swz(BQ, j, c),
                            qb + (live ? (size_t)(q0 + j) * q_row : 0),
                            live);
    }
    repro::tc::cp_async_arrive(&bars->q_full);
    const int* bt = block_tables + (size_t)r * M;
    const size_t head = (size_t)kh * D + 8 * c;
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % T::kStages;
      const uint32_t ph = ((i / T::kStages) & 1) ^ 1;
      // element offset of each row in a page pool (K and V alike), or -1
      // past the frontier: computed before the wait, used twice
      long long row_off[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int pos = i * kTcKV + j0 + kStep * u, blk = pos / ps;
        row_off[u] = (pos > kv_last || blk >= M)
                         ? -1
                         : ((long long)bt[blk] * ps + (pos - blk * ps)) *
                                   (long long)kv_row + (long long)head;
      }
      const uint32_t k_dst = base + T::kK + st * T::kKVBytes;
      const uint32_t v_dst = base + T::kV + st * T::kKVBytes;
      repro::tc::mbar_wait(&bars->k_empty[st], ph);
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        repro::tc::cp_async16(k_dst + repro::tc::swz(kTcKV, j0 + kStep * u, c),
                              k_pages + (row_off[u] < 0 ? 0 : row_off[u]),
                              row_off[u] >= 0);
      repro::tc::cp_async_arrive(&bars->k_full[st]);
      repro::tc::mbar_wait(&bars->v_empty[st], ph);
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        repro::tc::cp_async16(v_dst + repro::tc::swz(kTcKV, j0 + kStep * u, c),
                              v_pages + (row_off[u] < 0 ? 0 : row_off[u]),
                              row_off[u] >= 0);
      repro::tc::cp_async_arrive(&bars->v_full[st]);
    }
    repro::tc::cp_async_wait_all();
  } else {
    const TcOut o{out + ((size_t)r * S + q0) * H * D + (size_t)h * D, S - q0,
                  len - q0, (size_t)H * D};
    repro::tc::consume<BQ, kTcKV, D>(smem, warp / 4, 0, n_tiles, scale_log2,
                                     TcMask{q0, off, len}, o);
  }
}

template <int BQ, int D>
int launch_tc(const void* q, const void* kp, const void* vp, const int* bt,
              const int* offsets, const int* lens, void* out, int R, int S,
              int H, int KV, int ps, int M, float scale,
              cudaStream_t stream) {
  const size_t smem = (size_t)repro::tc::smem_bytes(BQ, kTcKV, D);
  auto kernel = ragged_prefill_tc_kernel<BQ, D>;
  const cudaError_t a = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (a != cudaSuccess) return (int)a;
  const dim3 grid((S + BQ - 1) / BQ, H, R);
  kernel<<<grid, Tile<BQ, kTcKV, D>::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
      static_cast<const bf16*>(vp), bt, offsets, lens,
      static_cast<bf16*>(out), S, H, KV, ps, M,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one CTA of the bf16 variant (64-key kv tiles):
// the wrapper's smem_bytes_tc mirrors it.
extern "C" long long flash_prefill_ragged_tc_smem_bytes(int block_q, int D) {
  return repro::tc::smem_bytes(block_q, kTcKV, D);
}

// bf16 q and pages at D = 64 or 128, block_q 64 or 128; every base
// 16-byte aligned (16-byte cp.async).
extern "C" int flash_prefill_ragged_tc_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const int* block_tables, const int* offsets, const int* lens, void* out,
    int R, int S, int H, int KV, int D, int ps, int M, int block_q,
    float scale, void* stream) {
  if (R < 1 || S < 1 || KV < 1 || H % KV != 0 || ps < 1 || M < 1 ||
      ((uintptr_t)q | (uintptr_t)k_pages | (uintptr_t)v_pages |
       (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FPR_TC(BQ, DD)                                                 \
  if (block_q == BQ && D == DD)                                              \
    return launch_tc<BQ, DD>(q, k_pages, v_pages, block_tables, offsets,     \
                             lens, out, R, S, H, KV, ps, M, scale, s);
  REPRO_FPR_TC(64, 64)
  REPRO_FPR_TC(64, 128)
  REPRO_FPR_TC(128, 64)
  REPRO_FPR_TC(128, 128)
#undef REPRO_FPR_TC
  return (int)cudaErrorInvalidValue;
}
