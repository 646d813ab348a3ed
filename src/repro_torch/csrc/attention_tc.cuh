// The tensor-core attention main loop shared by the bf16 variants of
// flash_attention.cu and flash_prefill_ragged.cu (sm_90a only).
//
// One CTA owns BQ query rows of ONE query head (BQ = 64 or 128, one
// consumer warpgroup per 64 rows) and walks its kv tiles of BKV keys in
// order; the two kernels differ only in where Q, K and V come from (a
// strided tensor through TMA, or pages gathered with cp.async) and in the
// mask predicate, which each supplies.  Per kv tile:
//
//   S = Q K^T      wgmma m64n{BKV}k16, bf16 x bf16 -> fp32, Q and K from
//                  shared memory (both K-major, 128-byte swizzle);
//   online softmax in registers, in units of scale * log2(e): the 4
//                  threads that share a row reduce its max (over live
//                  keys; -1e30 while none) and sum in a fixed butterfly
//                  order (xor 1, 2); p = live ? 2^(S * scale * log2 e - m)
//                  : 0 (one FFMA and one ex2), so fully masked rows and
//                  idle slots end at l = 0 and output 0;
//   O += P V       P rounded to bf16 in registers (the accumulator layout
//                  of S is the A-operand layout of this product, so no
//                  shuffle) and used as the register A operand of wgmma
//                  m64n{D}k16 with V from shared memory (MN-major); O
//                  stays in fp32 registers.
//
// The reference scales q in fp32 before its product
// (src/repro/kernels/flash_attention.py:57); here the scale multiplies the
// fp32 product, one fp32 rounding apart.  P in bf16 is the one place the
// arithmetic leaves fp32: within one bf16 ulp of the output (the CPU tests
// emulate it against the JAX reference).  Epilogue: acc / max(l, 1e-30),
// rounded once to bf16, staged through the consumer's own rows of the Q
// tile and stored as 16-byte vectors.
//
// Warp specialisation: a producer warpgroup after the consumer
// warpgroups issues the loads into a ring of up to 4 K and 4 V tiles,
// each with a "full" and an "empty" mbarrier; K and V have separate
// buffers, so V's load overlaps QK^T and the softmax.  A kernel whose
// producer needs few registers may move them to the consumers
// (setmaxnreg_dec / setmaxnreg_inc below: 3 x 128 threads launch at 168
// a thread).  No split over kv and no atomics: results are bit-identical
// from run to run.
#pragma once

#include "common.cuh"

namespace repro {
namespace tc {

constexpr int kMaxStages = 4;
constexpr int kSmemLimit = 232448;   // opt-in dynamic shared memory (H100)
constexpr int kSmemExtra = 256 + 1024;  // barriers, base-alignment slack

// Stages of the K/V ring: as many as fit beside the Q tile, at most 4.
__host__ __device__ constexpr int stages(int bq, int bkv, int d) {
  return (kSmemLimit - kSmemExtra - 2 * bq * d) / (4 * bkv * d) <
                 kMaxStages
             ? (kSmemLimit - kSmemExtra - 2 * bq * d) / (4 * bkv * d)
             : kMaxStages;
}

// Shared-memory plan of one CTA, in bytes from a 1024-byte-aligned base:
// the Q tile, kStages K tiles, kStages V tiles, then the mbarriers.  A
// tile of R rows x D columns is D / 64 boxes of R rows x 128 bytes, each
// in the 128-byte swizzle TMA writes and wgmma reads (16-byte chunk c of
// row r at chunk c ^ (r % 8)).
template <int BQ, int BKV, int D>
struct Tile {
  static_assert(BQ == 64 || BQ == 128, "BQ is 64 or 128");
  static_assert(BKV == 64 || BKV == 128, "BKV is 64 or 128");
  static_assert(D == 64 || D == 128, "D is 64 or 128");
  static constexpr int kNC = BQ / 64;               // consumer warpgroups
  static constexpr int kThreads = (kNC + 1) * 128;  // + the producer's
  static constexpr int kStages = stages(BQ, BKV, D);
  static_assert(kStages >= 2, "the K/V ring needs two stages");
  static constexpr int kQBytes = BQ * D * 2;
  static constexpr int kKVBytes = BKV * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQBytes;                // + stage * kKVBytes
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBars = kV + kStages * kKVBytes;
};

// Dynamic shared memory a launch requests: the plan, 256 bytes of
// barriers and 1024 bytes of slack to align the base
// (kernels/attention_tc.py mirrors it and stages()).
__host__ __device__ constexpr long long smem_bytes(int bq, int bkv, int d) {
  return 2LL * d * (bq + 2 * stages(bq, bkv, d) * bkv) + kSmemExtra;
}

struct Bars {
  uint64_t q_full;
  uint64_t k_full[kMaxStages], v_full[kMaxStages];
  uint64_t k_empty[kMaxStages], v_empty[kMaxStages];
};

// ------------------------------------------------------------- PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.  The
// loop is one PTX block, so the compiler sees no divergent branch around
// the wgmma that follow (it would serialize them).  A wait that outlasts
// 2^32 cycles (seconds) traps: a lost arrival ends the launch with an
// error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, 4294967296;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// 16-byte cp.async into shared memory; src_bytes 0 writes zeros and reads
// nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// The barrier receives this thread's arrival once all of its earlier
// cp.async copies have landed (the arrival is counted in the barrier's
// init count).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile(
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One TMA load of a 2-D box (c0: column, c1: row) completing on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// Order this thread's view of shared memory (data that landed through
// the generic proxy, e.g. cp.async) before the async proxy's wgmma reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses to wgmma's accumulator registers
// across the asynchronous window between issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}


__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// 2^x in one MUFU op; results below 2^-126 flush to 0 (a weight that
// small is below any bf16 P's resolution next to the row's maximum, 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Move registers between warpgroups: all four warps of a warpgroup run
// it, on a role path that the compiler sees as warp-uniform.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// wgmma shared-memory matrix descriptor of a 128-byte-swizzled operand
// (layout type 1).  `lbo` and `sbo` in bytes: for a K-major operand sbo is
// the stride of 8-row groups (1024) and lbo unused; for an MN-major one
// lbo is the stride between 64-element column boxes and sbo that of
// 8-row groups along K.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// Byte offset of 16-byte chunk c (of a D-wide row) of row r in a swizzled
// tile of `rows` rows.
__device__ __forceinline__ uint32_t swz(int rows, int r, int c) {
  return (c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// wgmma m64nNk16, bf16 x bf16 -> fp32: ss (A and B from shared memory,
// both K-major) and rs (A from registers, B MN-major).
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  // d (+)= A(smem, K-major) x B(smem, K-major); N = 64
  static __device__ __forceinline__ void ss(float* d, uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d)
        : "memory");
  }
  // d += A(registers) x B(smem, MN-major); N = 64
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
        : "memory");
  }
};

template <>
struct Wgmma<128> {
  // d (+)= A(smem, K-major) x B(smem, K-major); N = 128
  static __device__ __forceinline__ void ss(float* d, uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d)
        : "memory");
  }
  // d += A(registers) x B(smem, MN-major); N = 128
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
        : "memory");
  }
};

// The scale, mask and exponentials of one S tile, in place: s becomes P
// (fp32), m_new the rows' new maxima (in units of scale * log2 e) and sum
// their partial sums; p = 2^(s * scale_log2 - m_new) in one FFMA and one
// MUFU op.  With kMasked, key t * BKV + 8 j + col0 + (e & 1) of element
// 4 j + e is live iff mask.visible(row0 + 8 (e >> 1), key); a dead
// element contributes exactly 0.
template <int BKV, bool kMasked, class Mask>
__device__ __forceinline__ void softmax_tile(float (&s)[BKV / 2],
                                             const Mask& mask,
                                             float scale_log2,
                                             const float (&m)[2],
                                             float (&m_new)[2],
                                             float (&sum)[2], int t,
                                             int row0, int col0) {
  uint32_t live[2] = {~0u, ~0u};   // bit 2 j + (e & 1): element 4 j + e
  if constexpr (kMasked) {
    live[0] = live[1] = 0u;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        // an `if`: OR-ing in the predicate shifted as an integer gave an
        // empty mask for the first row of each pair (nvcc 12.9, sm_90a)
        if (mask.visible(row0 + 8 * (e >> 1),
                         t * BKV + 8 * j + col0 + (e & 1)))
          live[e >> 1] |= 1u << (2 * j + (e & 1));
  }
  auto on = [&](int j, int e) {
    return !kMasked || ((live[e >> 1] >> (2 * j + (e & 1))) & 1u);
  };
  float mx[2] = {kNegInf, kNegInf};   // of the raw scores
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mx[e >> 1] = on(j, e) ? fmaxf(mx[e >> 1], s[4 * j + e]) : mx[e >> 1];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    // a row with no live key here keeps its maximum
    m_new[h] = mx[h] == kNegInf ? m[h] : fmaxf(m[h], mx[h] * scale_log2);
  }
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p =
          on(j, e) ? ex2(fmaf(s[4 * j + e], scale_log2, -m_new[e >> 1]))
                   : 0.f;
      s[4 * j + e] = p;
      sum[e >> 1] += p;
    }
}

// The consumers' main loop and epilogue.  Warpgroup `wg` owns tile rows
// 64 wg .. 64 wg + 63; a thread holds rows row0 and row0 + 8 of them and,
// in every 8-column block j of S and O, columns 8 j + col0 and + 1.
//
// Per kv tile i the warpgroup rescales O by corr_{i-1}, issues
// S_i = Q K_i^T and, behind it, O += P_{i-1} V_{i-1}; it waits for S_i
// alone and runs
// the softmax of tile i while the tensor cores still work on P_{i-1} V,
// then waits for that product and packs P_i.  The arithmetic is the
// plain order (rescale O, then add P V) — only its schedule overlaps.
//
// Mask: visible(row, key) for a tile row and an absolute key index, and
// full(t), true when every row that matters sees every key of kv tile t
// (the per-element predicate is then skipped).  Out: row(r), the output
// row's first element or nullptr (not written), and zero(r), rows written
// as 0.
template <int BQ, int BKV, int D, class Mask, class Out>
__device__ __forceinline__ void consume(uint8_t* smem, int wg, int t_begin,
                                        int n_tiles, float scale_log2,
                                        const Mask& mask, const Out& out) {
  using T = Tile<BQ, BKV, D>;
  Bars* bars = reinterpret_cast<Bars*>(smem + T::kBars);
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int row0 = wg * 64 + warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  // descriptors of this warpgroup's Q rows, K stage 0 and V stage 0; a
  // k-step or a stage adds its byte offset / 16
  const uint64_t q_desc =
      smem_desc(base + T::kQ + wg * 64 * 128, 16, 1024);
  const uint64_t k_desc = smem_desc(base + T::kK, 16, 1024);
  const uint64_t v_desc = smem_desc(base + T::kV, BKV * 128, 1024);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float corr[2] = {1.f, 1.f};
  float s[BKV / 2];
  uint32_t a[BKV / 16][4];   // P of the previous tile, bf16 A fragments

  // O * corr, done before the group that ends in P V is issued (no
  // non-wgmma write to an accumulator inside an issued group)
  auto rescale_o = [&]() {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j + 0] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }
    fence_regs(o);
  };
  // O += P V from V stage `st` (issued, not waited)
  auto issue_pv = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      Wgmma<D>::rs(o, a[kk], v_desc + ((st * T::kKVBytes + kk * 2048) >> 4));
    wgmma_commit();
  };
  auto finish_pv = [&](int st) {
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(a);
    mbar_arrive(&bars->v_empty[st]);
  };

  if (n_tiles > 0) mbar_wait(&bars->q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int t = t_begin + i, st = i % T::kStages;
    const int pst = (i + T::kStages - 1) % T::kStages;

    // S_i = Q K_i^T, then (behind it) the previous tile's P V
    mbar_wait(&bars->k_full[st], (i / T::kStages) & 1);
    if (i > 0) mbar_wait(&bars->v_full[pst], ((i - 1) / T::kStages) & 1);
    fence_proxy_async();
    if (i > 0) rescale_o();
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // 16 columns = 32 bytes within a 64-column box of 128-byte rows
      const int qoff = (kk >> 2) * BQ * 128 + (kk & 3) * 32;
      const int koff =
          st * T::kKVBytes + (kk >> 2) * BKV * 128 + (kk & 3) * 32;
      Wgmma<BKV>::ss(s, q_desc + (qoff >> 4), k_desc + (koff >> 4), kk > 0);
    }
    wgmma_commit();
    if (i > 0) issue_pv(pst);
    if (i > 0)
      wgmma_wait<1>();
    else
      wgmma_wait<0>();
    fence_regs(s);
    mbar_arrive(&bars->k_empty[st]);

    // scale, mask and the online-softmax step of rows row0 and row0 + 8
    float sum[2] = {0.f, 0.f}, m_new[2];
    if (mask.full(t))
      softmax_tile<BKV, false>(s, mask, scale_log2, m, m_new, sum, t, row0,
                               col0);
    else
      softmax_tile<BKV, true>(s, mask, scale_log2, m, m_new, sum, t, row0,
                              col0);
    if (i > 0) finish_pv(pst);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      corr[h] = ex2(m[h] - m_new[h]);
      l[h] = l[h] * corr[h] + sum[h];
      m[h] = m_new[h];
    }
    // P_i in bf16 as the A fragments of 16-key steps
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      a[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  }
  if (n_tiles > 0) {
    const int st = (n_tiles - 1) % T::kStages;
    mbar_wait(&bars->v_full[st], ((n_tiles - 1) / T::kStages) & 1);
    fence_proxy_async();
    rescale_o();
    wgmma_fence();
    issue_pv(st);
    finish_pv(st);
  }

  // epilogue: normalise, round to bf16, stage in this warpgroup's rows of
  // the Q tile once all of its warps are past their last product (no
  // other warpgroup reads those rows), store 16-byte vectors
  named_sync(1 + wg, 128);
  const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      *reinterpret_cast<uint32_t*>(smem + T::kQ + swz(BQ, r, j) +
                                   2 * col0) =
          pack_bf16(o[4 * j + 2 * h] / den[h],
                    o[4 * j + 2 * h + 1] / den[h]);
    }
  named_sync(1 + wg, 128);
  for (int idx = tid; idx < 64 * (D / 8); idx += 128) {
    const int r = wg * 64 + idx / (D / 8), c = idx % (D / 8);
    __nv_bfloat16* dst = out.row(r);
    if (dst == nullptr) continue;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (!out.zero(r))
      v = *reinterpret_cast<const uint4*>(smem + T::kQ + swz(BQ, r, c));
    *reinterpret_cast<uint4*>(dst + 8 * c) = v;
  }
}

// Barrier set-up by thread 0, before the roles split: `load_arrivals` is
// the count of a full barrier's arrivals per phase (1 for a TMA loader,
// one per producer thread for cp.async).
template <int BQ, int BKV, int D>
__device__ __forceinline__ uint8_t* setup(unsigned char* raw,
                                          int load_arrivals) {
  using T = Tile<BQ, BKV, D>;
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  Bars* bars = reinterpret_cast<Bars*>(smem + T::kBars);
  if (threadIdx.x == 0) {
    mbar_init(&bars->q_full, load_arrivals);
#pragma unroll
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&bars->k_full[s], load_arrivals);
      mbar_init(&bars->v_full[s], load_arrivals);
      mbar_init(&bars->k_empty[s], T::kNC * 128);
      mbar_init(&bars->v_empty[s], T::kNC * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return smem;
}

}  // namespace tc
}  // namespace repro
