// The split-KV tensor-core decode main loop shared by the bf16 variants of
// flash_decode_paged.cu and flash_decode.cu (sm_90a).
//
// One query token per row attends over the row's logical KV slots, at
// head dim D = 64, 80 or 128.  The two kernels differ only in a Slots
// functor that maps a logical slot to the element offset of its K/V row
// (contiguous: base + slot * KV * D; paged: through the block table) and
// says whether the mask keeps it.
//
// Split.  The slots are cut into fixed chunks (kernels/decode_tc.py: a
// chunk depends on the page size alone, never on the batch, the table
// width, the card or the data).  Grid (chunk, kv head x row group,
// request): one CTA of 4 warps per chunk, each writing a partial
// (m, l, acc) of its rows to a workspace; a second kernel combines the
// partials of each (request, query head) in chunk order.  A chunk with no
// live slot loads and computes nothing and writes the neutral partial
// (m = -1e30, l = 0, acc = 0): the Pallas pl.when(any(live)).
//
// Loads in flight.  A chunk is walked in 32-slot sub-tiles (one slot per
// lane), warp w taking sub-tiles w, w + 4, ...; each warp keeps up to two
// sub-tiles of K and V in its own ring, copied by 16-byte cp.async (K and
// V in separate groups, so V lands while QK^T and the softmax run) into
// bf16 rows padded by 16 bytes (ldmatrix without bank conflicts: a row is
// D + 8 elements, so the 8 rows an ldmatrix reads fall on distinct 4-bank
// groups at D = 64, 80 and 128).  A lane copies the sub-tile's (row,
// 16-byte chunk) pairs lane, lane + 32, ... in row-major order.  Dead
// slots are zero-filled with cp.async's src-size-0 form and no address of
// theirs is ever read; a sub-tile without a live slot is neither loaded
// nor computed.  Warps synchronise only among their own lanes until the
// end of the chunk.
//
// Products.  mma.sync m16n8k16 bf16 x bf16 -> fp32.  The g query heads of
// a kv head are the rows of a 16-row A tile (padded with zero rows, which
// are never written; g > 16 takes one row group of the grid per 16
// heads), loaded once per CTA into registers.  S = q K^T takes K's B
// fragments through ldmatrix, 32 columns of D a step and the last 16 in
// one more step where D % 32 == 16 (D = 80); the scale, folded with
// log2(e), multiplies the fp32 product (q is not scaled in bf16:
// 1/sqrt(128) is no power of two).  The online softmax runs in
// registers: the 4 lanes sharing a row reduce its max in a fixed
// butterfly (xor 1, 2); p = live ? 2^(S * scale * log2 e - m) : 0.  P,
// rounded to bf16, is the A operand of O += P V, whose B fragments come
// through ldmatrix.trans; O stays fp32.
// At the chunk's end the four warps' partials are combined in warp order
// through shared memory.
//
// Combine.  m* = max_i m_i; acc = sum_i acc_i 2^(m_i - m*), l likewise,
// over the chunks i = 0 .. n-1 in order, skipping neutral partials; out =
// acc / max(l, 1e-30), rounded once to bf16.  A row with no live slot
// ends at 0.
//
// Invariance contract.  A request's output bits depend only on its q, its
// mask row and the values of its live K/V slots: not on its row index or
// the other rows, its physical page numbers, the table width M beyond
// its live slots, the batch size, the number of SMs or the launch order.
// The chunk and sub-tile boundaries are fixed logical slot ranges; dead
// and out-of-range slots alike enter as zeros with p = 0, and sub-tiles
// and chunks without a live slot are skipped, so they change no bit;
// every reduction has a fixed order and none uses atomics.  Preemption
// and restore move a request between rows and pages, and the recovery
// and journal layers promise tokens bit-identical to an uninterrupted
// run: this contract is what keeps that promise with a split grid.
#pragma once

#include "attention_tc.cuh"
#include "common.cuh"

namespace repro {
namespace dtc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSub = 32;          // slots of a sub-tile: one per lane
constexpr int kRows = 16;         // query rows of an mma A tile
constexpr int kMaxStages = 2;     // sub-tiles a warp keeps in flight
// CTAs an SM must hold at once (the launch bound): two leave ptxas 255
// registers a thread, and 2 x 132 CTAs cover a serving-shape grid
constexpr int kMinCtas = 2;
constexpr float kLog2e = 1.4426950408889634f;

// A sub-tile row in shared memory: D bf16 values and 16 bytes of padding.
__host__ __device__ constexpr int pitch(int d) { return d + 8; }
// K and V of one sub-tile, in bytes.
__host__ __device__ constexpr int stage_bytes(int d) {
  return 2 * kSub * pitch(d) * 2;
}
__host__ __device__ constexpr int n_sub(int chunk) {
  return (chunk + kSub - 1) / kSub;
}
// Two stages when a warp walks more than one sub-tile of a chunk.
__host__ __device__ constexpr int stages(int chunk) {
  return n_sub(chunk) > kWarps ? kMaxStages : 1;
}
// Dynamic shared memory of a partial CTA (kernels/decode_tc.py mirrors
// it): every warp's ring.  A warp's partial (acc [16][D], m and l) reuses
// its first stage.
__host__ __device__ constexpr long long smem_bytes(int d, int chunk) {
  return (long long)kWarps * stages(chunk) * stage_bytes(d);
}

// ------------------------------------------------------------- PTX helpers
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a b, m16n8k16, bf16 x bf16 -> fp32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p, bool ok) {
  return ok ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}

// The workspace of n_part = R * KV * n_chunks * g partials, fp32:
// acc (R, KV, n_chunks, g, D), then m and l (R, KV, n_chunks, g) each.
// The partial of (request r, kv head kh, chunk c, row i) is number
// ((r * KV + kh) * n_chunks + c) * g + i.
struct Workspace {
  float* base;
  size_t n_part;
  int D;
  __device__ float* acc(size_t p) const { return base + p * D; }
  __device__ float* m(size_t p) const { return base + n_part * D + p; }
  __device__ float* l(size_t p) const {
    return base + n_part * (D + 1) + p;
  }
};

// A partial CTA of grid (n_chunks, KV * row groups, R): its chunk, kv
// head, row group and request, and the partial number of its row row0.
struct Cta {
  int c, kh, row0, rows, r, g;
  size_t part;
  __device__ Cta(int H, int KV, int n_chunks) {
    g = H / KV;
    const int n_grp = (g + kRows - 1) / kRows;
    c = blockIdx.x;
    kh = blockIdx.y / n_grp;
    row0 = kRows * (blockIdx.y % n_grp);
    rows = min(kRows, g - row0);
    r = blockIdx.z;
    part = (((size_t)r * KV + kh) * n_chunks + c) * g + row0;
  }
};

// ------------------------------------------------------------ the main loop
// A Slots type gives, for one (row, kv head):
//   int n;                                  logical slots of the row
//   __device__ bool live(int s) const;      s < n and the mask keeps s
//   __device__ long long offset(int s) const;  element offset of slot s's
//                                           K/V row (called for any s < n,
//                                           read for live s)
//
// One CTA: the partial of the cta.rows (<= 16) query heads whose q rows
// start at `q` (row stride D) over slots c0 .. c0 + chunk - 1 of the row
// (cut at sl.n), c0 = cta.c * chunk, into the workspace (m in units of
// scale * log2 e).
template <int D, int S, class Slots>
__device__ __forceinline__ void chunk_partial(
    const Slots& sl, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ q, const Cta& cta, int chunk, float scale_log2,
    const Workspace& ws, unsigned char* smem) {
  static_assert(D == 64 || D == 80 || D == 128, "D is 64, 80 or 128");
  static_assert(kSub == 32, "the copy walks a sub-tile in steps of 32");
  static_assert(kRows * (D + 2) * 4 <= stage_bytes(D),
                "a warp's partial fits in its first stage");
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int rows = cta.rows, c0 = cta.c * chunk;
  const int c_end = min(c0 + chunk, sl.n);

  // q as the A operand, rows grp and grp + 8, for every 16-wide k step
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const bf16* p = q + grp * D + 16 * ks + 2 * tig;
    qa[ks][0] = ld_pair(p, grp < rows);
    qa[ks][1] = ld_pair(p + 8 * D, grp + 8 < rows);
    qa[ks][2] = ld_pair(p + 8, grp < rows);
    qa[ks][3] = ld_pair(p + 8 * D + 8, grp + 8 < rows);
  }

  const int nsub = (c_end - c0 + kSub - 1) / kSub;
  const int n_mine = warp < nsub ? (nsub - warp + kWarps - 1) / kWarps : 0;
  unsigned char* ring = smem + warp * S * stage_bytes(D);
  const uint32_t ring_s = repro::tc::smem_u32(ring);
  constexpr int kCh = D / 8;       // 16-byte chunks of a row

  // liveness of the 32 slots of the warp's i-th sub-tile, bit = lane
  auto live_bits = [&](int i) {
    const int slot = c0 + kSub * (warp + kWarps * i) + lane;
    return __ballot_sync(0xffffffffu, slot < c_end && sl.live(slot));
  };
  // copy the warp's i-th sub-tile into stage i % S: K, then V, one
  // commit group each (empty when the sub-tile has no live slot)
  auto issue = [&](int i) {
    const int slot = c0 + kSub * (warp + kWarps * i) + lane;
    // the offset of every slot in range (not only of live ones), so that
    // its table read need not wait for the mask
    const bool in = slot < c_end;
    const long long off = in ? sl.offset(slot) : 0;
    const uint32_t live = __ballot_sync(0xffffffffu, in && sl.live(slot));
    const uint32_t kd = ring_s + (i % S) * stage_bytes(D);
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const bf16* src = pass == 0 ? k : v;
      const uint32_t dst = kd + pass * kSub * pitch(D) * 2;
      if (live) {
        // the sub-tile's kSub x kCh (row, chunk) pairs in row-major order,
        // lane + 32 u for u = 0 .. kCh - 1
#pragma unroll
        for (int u = 0; u < kCh; ++u) {
          const int idx = lane + 32 * u;
          const int j = idx / kCh, c = idx - j * kCh;
          const long long o = __shfl_sync(0xffffffffu, off, j);
          const bool ok = (live >> j) & 1u;
          repro::tc::cp_async16(dst + (j * pitch(D) + 8 * c) * 2,
                                src + (ok ? o : 0) + 8 * c, ok);
        }
      }
      cp_async_commit();
    }
  };

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

#pragma unroll
  for (int i = 0; i < S; ++i) issue(i);
  for (int i = 0; i < n_mine; ++i) {
    const uint32_t live = live_bits(i);
    const uint32_t kd = ring_s + (i % S) * stage_bytes(D);
    const uint32_t vd = kd + kSub * pitch(D) * 2;
    if (live) {
      cp_async_wait<2 * S - 1>();  // this sub-tile's K has landed
      __syncwarp();
      // S = q K^T: 16 rows x 32 slots, four 8-slot n tiles
      float s[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t b[4];
          ldsm_x4(b, kd + ((8 * j + (lane & 7)) * pitch(D) + 32 * kk +
                           8 * (lane >> 3)) * 2);
          mma_bf16(s[j], qa[2 * kk], b[0], b[1]);
          mma_bf16(s[j], qa[2 * kk + 1], b[2], b[3]);
        }
      if constexpr (D % 32 == 16) {
        // the last 16 columns (D = 80): one k step, lanes 0-15 address
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t b[2];
          ldsm_x2(b, kd + ((8 * j + (lane & 7)) * pitch(D) + D - 16 +
                           8 * ((lane >> 3) & 1)) * 2);
          mma_bf16(s[j], qa[D / 16 - 1], b[0], b[1]);
        }
      }
      // online softmax of rows grp (h = 0) and grp + 8 (h = 1); element
      // e of n tile j is slot 8 j + 2 tig + (e & 1)
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if ((live >> (8 * j + 2 * tig + (e & 1))) & 1u)
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      float m_new[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        m_new[h] = fmaxf(m[h], mx[h] * scale_log2);
        corr[h] = repro::tc::ex2(m[h] - m_new[h]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              ((live >> (8 * j + 2 * tig + (e & 1))) & 1u)
                  ? repro::tc::ex2(fmaf(s[j][e], scale_log2, -m_new[e >> 1]))
                  : 0.f;
          s[j][e] = p;
          sum[e >> 1] += p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] = l[h] * corr[h] + sum[h];
        m[h] = m_new[h];
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
      cp_async_wait<2 * S - 2>();  // and its V
      __syncwarp();
      // O += P V: P (bf16) from the S registers, 16-slot k steps
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t a[4] = {
            repro::tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            repro::tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            repro::tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            repro::tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int n2 = 0; n2 < D / 16; ++n2) {
          uint32_t b[4];
          ldsm_x4_t(b, vd + ((16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7)) *
                                 pitch(D) +
                             16 * n2 + 8 * (lane >> 4)) * 2);
          mma_bf16(acc[2 * n2], a, b[0], b[1]);
          mma_bf16(acc[2 * n2 + 1], a, b[2], b[3]);
        }
      }
    }
    __syncwarp();  // every lane is done with this stage before it refills
    issue(i + S);
  }
  cp_async_wait<0>();

  // the rows' sums over the quad, in a fixed order
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  // this warp's partial into its first stage: acc [16][D], m [16], l [16]
  __syncwarp();
  float* wacc = reinterpret_cast<float*>(ring);
  float* wm = wacc + kRows * D;
  float* wl = wm + kRows;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<float2*>(wacc + grp * D + 8 * n + 2 * tig) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(wacc + (grp + 8) * D + 8 * n + 2 * tig) =
        make_float2(acc[n][2], acc[n][3]);
  }
  if (tig == 0) {
    wm[grp] = m[0];
    wm[grp + 8] = m[1];
    wl[grp] = l[0];
    wl[grp + 8] = l[1];
  }
  __syncthreads();

  // the chunk's partial: the warps combined in warp order (a chunk with
  // no live slot ends at the neutral partial)
  const size_t part = cta.part;
  for (int i = tid; i < rows * D; i += kThreads) {
    const int row = i / D, d = i - row * D;
    float mw[kWarps], ms = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* pw =
          reinterpret_cast<const float*>(smem + w * S * stage_bytes(D));
      mw[w] = pw[kRows * D + row];
      ms = fmaxf(ms, mw[w]);
    }
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (mw[w] == kNegInf) continue;  // a warp without a live sub-tile
      const float* pw =
          reinterpret_cast<const float*>(smem + w * S * stage_bytes(D));
      const float f = repro::tc::ex2(mw[w] - ms);
      a += pw[row * D + d] * f;
      ls += pw[kRows * D + kRows + row] * f;
    }
    ws.acc(part)[i] = a;
    if (d == 0) {
      *ws.m(part + row) = ms;
      *ws.l(part + row) = ls;
    }
  }

}

// One thread per output element of (query head h = blockIdx.x, request
// r = blockIdx.y): the chunks' partials combined in chunk order.  Every
// load is issued whatever the chunk's m (selects, not branches), so all
// of a pass's loads are in flight at once.
__global__ void __launch_bounds__(128) decode_combine_kernel(
    const float* __restrict__ ws, bf16* __restrict__ out, int R, int H,
    int KV, int D, int n_chunks) {
  const int h = blockIdx.x, r = blockIdx.y, g = H / KV;
  const int kh = h / g, row = h - kh * g;
  const Workspace w{const_cast<float*>(ws), (size_t)R * KV * n_chunks * g,
                    D};
  const size_t p0 = ((size_t)r * KV + kh) * n_chunks * g + row;
  const int d = threadIdx.x;
  float ms = kNegInf;
  for (int c = 0; c < n_chunks; ++c)
    ms = fmaxf(ms, *w.m(p0 + (size_t)c * g));
  float a = 0.f, ls = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const size_t p = p0 + (size_t)c * g;
    const float mc = *w.m(p), x = w.acc(p)[d], lc = *w.l(p);
    const bool on = mc != kNegInf;  // a chunk without a live slot: skipped
    const float f = repro::tc::ex2(mc - ms);
    a = on ? a + x * f : a;
    ls = on ? ls + lc * f : ls;
  }
  out[((size_t)r * H + h) * D + d] = __float2bfloat16(a / fmaxf(ls, 1e-30f));
}

// Launch a partial kernel on grid (n_chunks, KV * row groups, R) with its
// shared memory, then the combine on (H, R).
template <int D, int S, class Kernel, class... Args>
int launch(Kernel kernel, const float* ws, bf16* out, int H, int KV, int R,
           int n_chunks, int chunk, cudaStream_t stream, Args... args) {
  const int smem = (int)smem_bytes(D, chunk);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_grp = (H / KV + kRows - 1) / kRows;
  kernel<<<dim3(n_chunks, KV * n_grp, R), kThreads, smem, stream>>>(
      args...);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_combine_kernel<<<dim3(H, R), D, 0, stream>>>(ws, out, R, H, KV, D,
                                                      n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace dtc
}  // namespace repro

