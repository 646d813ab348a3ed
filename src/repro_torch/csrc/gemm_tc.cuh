// The tensor-core GEMM main loop shared by the s8 variant of
// quant_matmul.cu and the bf16 variant of block_sparse_matmul.cu (sm_90a).
//
// One CTA computes a tile C[BA, BB] = A[BA, k] . B[BB, k]^T over a list of
// k-blocks of 128 elements.  The two kernels differ in the element type,
// in where the k-blocks come from (a dense range, or the live entries of
// one kindex row) and in the epilogue, which each supplies; the ring, the
// barriers, the descriptors and the product are this header's.
//
// Warp roles.  A producer warpgroup after the consumer warpgroups: one of
// its threads keeps TMA loads in flight into a ring of up to 4 stages,
// each holding the A and the B tile of one k-block and guarded by a
// "full" mbarrier (the TMA's transaction count) and an "empty" one (an
// arrival from every consumer thread).  One or two consumer warpgroups
// (64 or 128 rows of A each: one or two m64 sub-tiles) issue wgmma on the
// stages that have landed, keep one stage's products in flight while the
// next is issued, and release a stage once its products are done.  The
// accumulators stay in registers until the epilogue.
//
// One tile format.  Every tile is rows of 128 bytes in the 128-byte
// swizzle that TMA writes and wgmma reads (16-byte chunk c of row r at
// chunk c ^ (r % 8)), one box of TMA per 128 bytes of row: a row holds
// 128 int8 or 64 bf16 values, and a k-step of wgmma is 32 bytes of it for
// both types (k32 of s8, k16 of bf16).
//  - s8 x s8 -> s32 (m64nNk32): 8-bit wgmma takes both operands K-major
//    only, so A and B are both (rows, K) row-major, as quant_matmul's
//    xq (M, K) and wq (N, K) are; a stage is one 128-byte box of each.
//  - bf16 x bf16 -> fp32 (m64n128k16): A is K-major (x, (M, K)); B is
//    MN-major (w, (K, N) row-major), read as attention_tc.cuh reads V:
//    BB / 64 boxes of 128 k-rows x 64 columns, the transpose bit set.  A
//    stage is the 128-element k-block: two boxes of A, two of B.
// No .satfinite on the integer product: int32 sums wrap modulo 2**32, as
// the reference's int32 dot_general does, and integer addition that wraps
// is associative, so any grouping of the k-blocks gives the same bits.
//
// Determinism.  Each CTA walks its k-blocks in list order with no atomics;
// floating-point sums (bf16) therefore have one fixed order per output,
// and two launches give the same bits.
#pragma once

#include "attention_tc.cuh"
#include "common.cuh"

namespace repro {
namespace gemm {

using tc::mbar_arrive;
using tc::mbar_expect_tx;
using tc::mbar_init;
using tc::mbar_wait;
using tc::smem_desc;
using tc::smem_u32;
using tc::wgmma_commit;
using tc::wgmma_fence;
using tc::wgmma_wait;

constexpr int kMaxStages = 4;
constexpr int kSmemLimit = 232448;       // opt-in dynamic shared memory (H100)
constexpr int kSmemExtra = 256 + 1024;   // barriers, base-alignment slack
constexpr int kBlockK = 128;             // k elements of a stage
constexpr int kRowBytes = 128;           // one swizzled row / TMA box width

// Stages of the ring: as many as fit, at most 4 (kernels/gemm_tc.py
// mirrors it).
__host__ __device__ constexpr int stages(int stage_bytes) {
  return (kSmemLimit - kSmemExtra) / stage_bytes < kMaxStages
             ? (kSmemLimit - kSmemExtra) / stage_bytes
             : kMaxStages;
}

// The element types: bytes a value, k-steps of wgmma per stage, the
// accumulator's register type and whether B is MN-major.
struct S8 {
  static constexpr int kBytes = 1;
  static constexpr int kKSteps = kBlockK / 32;   // k32
  static constexpr bool kBMNMajor = false;
  using Acc = uint32_t;                          // s32, wrapping
};
struct BF16 {
  static constexpr int kBytes = 2;
  static constexpr int kKSteps = kBlockK / 16;   // k16
  static constexpr bool kBMNMajor = true;
  using Acc = float;
};

// The plan of one CTA: BA rows of A over NC consumer warpgroups, BB rows
// of B (the wgmma N), and the shared-memory layout from a 1024-byte-aligned
// base: stage s at s * kStageBytes holds the A tile (kABytes) then the B
// tile; the barriers follow the last stage.
template <class E, int BA, int BB, int NC>
struct Gemm {
  static_assert(NC == 1 || NC == 2, "one or two consumer warpgroups");
  static_assert(BA % (64 * NC) == 0 && BA / (64 * NC) <= 2,
                "one or two m64 sub-tiles a consumer warpgroup");
  static_assert(BB % 8 == 0 && BB <= 256, "wgmma N");
  static_assert(!E::kBMNMajor || BB % 64 == 0, "MN-major B: 64-column boxes");
  using Elem = E;
  using Acc = typename E::Acc;
  static constexpr int kBA = BA, kBB = BB, kNC = NC;
  static constexpr int kMT = BA / (64 * NC);
  static constexpr int kThreads = (NC + 1) * 128;
  static constexpr int kABytes = BA * kBlockK * E::kBytes;
  static constexpr int kBBytes = BB * kBlockK * E::kBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = stages(kStageBytes);
  static_assert(kStages >= 2, "the ring needs two stages");
  static constexpr int kBars = kStages * kStageBytes;
  static constexpr long long kSmem =
      (long long)kStages * kStageBytes + kSmemExtra;
  static constexpr int kAccRegs = kMT * BB / 2;   // a consumer thread's
  // 128 accumulators a thread: the producer's registers move to the
  // consumers (3 x 128 threads launch at 168; 40 + 2 x 232 after)
  static constexpr bool kMoveRegs = NC == 2 && kAccRegs >= 128;
  // small accumulators: two CTAs an SM, so that a narrow grid still
  // keeps enough loads in flight
  static constexpr int kMinBlocks = kAccRegs <= 32 ? 2 : 1;

  // descriptor of A's sub-tile at row0 for k-step kk of the stage at a
  static __device__ __forceinline__ uint64_t a_desc(uint32_t a, int kk,
                                                    int row0) {
    return smem_desc(a + (kk / 4) * BA * kRowBytes + row0 * kRowBytes +
                         (kk % 4) * 32,
                     16, 1024);
  }
  // descriptor of the B tile for k-step kk of the stage at b
  static __device__ __forceinline__ uint64_t b_desc(uint32_t b, int kk) {
    if constexpr (E::kBMNMajor)   // 16 k-rows a step; boxes BK rows apart
      return smem_desc(b + kk * 16 * kRowBytes, kBlockK * kRowBytes, 1024);
    else
      return smem_desc(b + (kk / 4) * BB * kRowBytes + (kk % 4) * 32, 16,
                       1024);
  }
};

// Dynamic shared memory a launch requests for a stage of `stage_bytes`
// (kernels/gemm_tc.py::smem_bytes mirrors it).
__host__ __device__ constexpr long long smem_bytes(int stage_bytes) {
  return (long long)stages(stage_bytes) * stage_bytes + kSmemExtra;
}

struct Bars {
  uint64_t full[kMaxStages], empty[kMaxStages];
};

// wgmma m64nNk32 s8 and m64nNk16 bf16 with both operands in shared memory
// and the accumulator in registers (scale-d 1: d += A B).
template <class E, int N>
struct Mma;

template <>
struct Mma<S8, 8> {
  // d += A(smem, K-major) x B(smem, K-major), s8 x s8 -> s32; N = 8
  static __device__ __forceinline__ void run(uint32_t* d, uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "l"(da), "l"(db), "r"(1)
        : "memory");
  }
};

template <>
struct Mma<S8, 16> {
  // d += A(smem, K-major) x B(smem, K-major), s8 x s8 -> s32; N = 16
  static __device__ __forceinline__ void run(uint32_t* d, uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(da), "l"(db), "r"(1)
        : "memory");
  }
};

template <>
struct Mma<S8, 32> {
  // d += A(smem, K-major) x B(smem, K-major), s8 x s8 -> s32; N = 32
  static __device__ __forceinline__ void run(uint32_t* d, uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(da), "l"(db), "r"(1)
        : "memory");
  }
};

template <>
struct Mma<S8, 64> {
  // d += A(smem, K-major) x B(smem, K-major), s8 x s8 -> s32; N = 64
  static __device__ __forceinline__ void run(uint32_t* d, uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(1)
        : "memory");
  }
};

template <>
struct Mma<S8, 128> {
  // d += A(smem, K-major) x B(smem, K-major), s8 x s8 -> s32; N = 128
  static __device__ __forceinline__ void run(uint32_t* d, uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(1)
        : "memory");
  }
};

template <>
struct Mma<S8, 256> {
  // d += A(smem, K-major) x B(smem, K-major), s8 x s8 -> s32; N = 256
  static __device__ __forceinline__ void run(uint32_t* d, uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87,"
        "%88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103,"
        "%104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119,"
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
          "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
          "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
          "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
          "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
          "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
          "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
          "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
          "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
          "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(da), "l"(db), "r"(1)
        : "memory");
  }
};

template <>
struct Mma<BF16, 128> {
  // d += A(smem, K-major) x B(smem, MN-major), bf16 x bf16 -> fp32;
  // N = 128
  static __device__ __forceinline__ void run(float* d, uint64_t da,
                                             uint64_t db) {
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
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
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
        : "l"(da), "l"(db), "r"(1)
        : "memory");
  }
};
// Barrier set-up by thread 0, before the roles split.
template <class G>
__device__ __forceinline__ uint8_t* setup(unsigned char* raw) {
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  Bars* bars = reinterpret_cast<Bars*>(smem + G::kBars);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(&bars->full[s], 1);
      mbar_init(&bars->empty[s], G::kNC * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return smem;
}

// The producer's loop, run by one thread: for the n_k k-blocks in order,
// wait for the stage to be free, arm its full barrier with the stage's
// bytes and call load(i, a, b, bar), which issues the TMA loads of k-block
// i into the A tile at shared address a and the B tile at b, completing
// on bar.  Boxes past a matrix's edge land as zeros and count their full
// bytes.
template <class G, class Load>
__device__ __forceinline__ void produce(uint8_t* smem, int n_k,
                                        const Load& load) {
  Bars* bars = reinterpret_cast<Bars*>(smem + G::kBars);
  const uint32_t base = smem_u32(smem);
  for (int i = 0; i < n_k; ++i) {
    const int st = i % G::kStages;
    mbar_wait(&bars->empty[st], ((i / G::kStages) & 1) ^ 1);
    mbar_expect_tx(&bars->full[st], G::kStageBytes);
    const uint32_t a = base + st * G::kStageBytes;
    load(i, a, a + G::kABytes, &bars->full[st]);
  }
}

// Keep the compiler from moving the accumulators across the window in
// which wgmma still writes them.
template <int N>
__device__ __forceinline__ void fence_acc(float (&r)[N]) {
  tc::fence_regs(r);
}
template <int N>
__device__ __forceinline__ void fence_acc(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// The consumers' main loop: warpgroup wg accumulates, over n_k stages in
// order, its kMT sub-tiles of 64 rows x BB columns into acc (zeroed
// first; a tile with no k-block ends at 0).  Stage i's products are
// issued while stage i - 1's are still in flight; stage i - 1 is released
// once they are done.
template <class G>
__device__ __forceinline__ void consume(
    uint8_t* smem, int wg, int n_k,
    typename G::Acc (&acc)[G::kMT][G::kBB / 2]) {
  Bars* bars = reinterpret_cast<Bars*>(smem + G::kBars);
  const uint32_t base = smem_u32(smem);
#pragma unroll
  for (int mt = 0; mt < G::kMT; ++mt) {
#pragma unroll
    for (int r = 0; r < G::kBB / 2; ++r) acc[mt][r] = 0;
    fence_acc(acc[mt]);
  }
  for (int i = 0; i < n_k; ++i) {
    const int st = i % G::kStages;
    mbar_wait(&bars->full[st], (i / G::kStages) & 1);
    const uint32_t a = base + st * G::kStageBytes, b = a + G::kABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < G::Elem::kKSteps; ++kk) {
      const uint64_t db = G::b_desc(b, kk);
#pragma unroll
      for (int mt = 0; mt < G::kMT; ++mt)
        Mma<typename G::Elem, G::kBB>::run(
            acc[mt], G::a_desc(a, kk, (wg * G::kMT + mt) * 64), db);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (i > 0)
      mbar_arrive(&bars->empty[(i + G::kStages - 1) % G::kStages]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < G::kMT; ++mt) fence_acc(acc[mt]);
}

// Visit a consumer thread's accumulators in pairs: fn(r, c, v0, v1) with
// v0 at tile row r, column c and v1 at (r, c + 1); rows count from the
// CTA's first row of A, columns from its first row of B.  (The m64nN
// layout: element 4 j + e of a sub-tile sits at row 16 warp + lane / 4 +
// 8 (e >> 1), column 8 j + 2 (lane % 4) + (e & 1).)
template <class G, class Fn>
__device__ __forceinline__ void for_each_pair(
    int wg, typename G::Acc (&acc)[G::kMT][G::kBB / 2], const Fn& fn) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int mt = 0; mt < G::kMT; ++mt) {
    const int row0 = (wg * G::kMT + mt) * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < G::kBB / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        fn(row0 + 8 * h, 8 * j + 2 * (lane % 4), acc[mt][4 * j + 2 * h],
           acc[mt][4 * j + 2 * h + 1]);
  }
}

}  // namespace gemm
}  // namespace repro
