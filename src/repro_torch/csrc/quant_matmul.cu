// Dynamic-activation int8 x int8 matrix product with int32 accumulation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/quant_matmul.py
// (quant_matmul / _qmm_kernel).  Inputs arrive quantized, as the TPU
// kernel's do: xq (M, K) int8 with per-row fp32 scales xs (M,), and the
// weight's int8 values with per-output-column fp32 scales ws (N,), handed
// over as wq (N, K) so that k is contiguous for both operands.  Output
// (M, N) fp32: ((float)acc * xs[m]) * ws[n], acc the int32 sum, which
// wraps modulo 2**32 as the reference's int32 dot_general does (|acc| can
// pass 2**31 only for K >= 133,143).  The epilogue multiplies in the
// plain version's order and the library is built without fast math, so
// the output is bit-identical to it.
//
// Bound on an H100: bytes at decode (M = 8: the int8 weight is read once
// for 2 * 8 operations per byte), operations at prefill (M = 4096: about
// 2 * 4096 operations per weight byte, above the ~590 operations per byte
// where int8 tensor cores at 1,979 TOPS outrun 3.35 TB/s).
//
// Two variants; kernels/gemm_tc.py picks one by K alone.
//
// "tc" (K % 16 == 0, a TMA row pitch; every Qwen2-7B shape): the shared
// TMA/wgmma main loop of gemm_tc.cuh, s8 x s8 -> s32, with a plan that is
// a pure function of (M, N, K) (qmm_plan below; kernels/gemm_tc.py
// mirrors it):
//  - M > 64: C = xq . wq^T in tiles of 128 rows of M x 256 rows of N;
//    the grid walks M fastest, so CTAs in flight share wq's tiles;
//  - M <= 64 (decode): the operands swap, C^T = wq . xq^T, so that the
//    weight fills wgmma's 64-row A side (128 rows of N a CTA) and the
//    activations its N side (M rounded up to 8, 16, 32 or 64); the
//    epilogue stores C^T transposed;
//  - split K where the tiles alone would leave the card short of two
//    waves of CTAs, or of one when swapped (a swapped CTA streams its 128
//    weight rows with 4 stages in flight, more than an SM's share of the
//    memory bandwidth needs, so more CTAs would only add the combine):
//    the down projection at M = 8, TUNE's embed product at M = 128;
//    split s takes a fixed range of 128-element k-blocks and writes its
//    exact int32 partials to a workspace, and qmm_combine_kernel sums them
//    in split order (wrapping) and applies the scales.  Integer sums are
//    exact, so every split count gives the same bits.
// Ragged M, N and K edges are TMA's zero fill: zeros add nothing to the
// sums, and the epilogue stores only rows and columns inside (M, N).
//
// "mma" (any other K): one CTA owns a 64 x 64 output tile and walks all
// of K itself: 4 warps (2 x 2, 32 x 32 each) issue mma.sync.m16n8k32
// s8.s8.s32 over 64-wide k slabs staged in shared memory, with the int32
// sums in registers.  Rows of a slab are padded to 80 bytes so that the
// fragment loads of a warp fall on distinct banks.  Ragged M, N and K
// edges load as zeros, so any shape works with no pad copy.  It has no
// load pipeline (loads and products do not overlap).

#include "common.cuh"
#include "gemm_tc.cuh"
#include "tma.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 64;
constexpr int kRow = kBK + 16;  // bytes per shared-memory row (padded)
constexpr int kThreads = 128;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage rows [r0, r0 + 64) x k [k0, k0 + 64) of a (rows, K) int8 matrix
// into shared memory, zeros past either edge.  16-byte loads where the
// whole chunk is inside and K keeps rows 16-byte aligned.
__device__ __forceinline__ void load_slab(int8_t* s, const int8_t* g,
                                          int rows, int K, int r0, int k0,
                                          bool vec) {
  constexpr int kChunks = kBK / 16;
  for (int i = threadIdx.x; i < kBM * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 16;
    const int gr = r0 + r, gk = k0 + c;
    int4 val = make_int4(0, 0, 0, 0);
    if (gr < rows && gk < K) {
      const int8_t* src = g + (size_t)gr * K + gk;
      if (vec && gk + 16 <= K) {
        val = *reinterpret_cast<const int4*>(src);
      } else {
        alignas(16) int8_t tmp[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) tmp[j] = gk + j < K ? src[j] : 0;
        val = *reinterpret_cast<const int4*>(tmp);
      }
    }
    *reinterpret_cast<int4*>(s + r * kRow + c) = val;
  }
}

__global__ void __launch_bounds__(kThreads) quant_matmul_kernel(
    const int8_t* __restrict__ xq,  // (M, K)
    const float* __restrict__ xs,   // (M,)
    const int8_t* __restrict__ wq,  // (N, K)
    const float* __restrict__ ws,   // (N,)
    float* __restrict__ out,        // (M, N)
    int M, int N, int K, int vec) {
  __shared__ __align__(16) int8_t a_s[kBM * kRow];
  __shared__ __align__(16) int8_t b_s[kBN * kRow];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    load_slab(a_s, xq, M, K, m0, k0, vec);
    load_slab(b_s, wq, N, K, n0, k0, vec);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // A fragment (16 x 32, row major): rows grp and grp + 8, bytes
        // 4 * tig .. + 3 and 16 + 4 * tig .. + 3
        const int8_t* p = a_s + (wm + mi * 16 + grp) * kRow + kk + tig * 4;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kRow);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kRow + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        // B fragment (32 x 8, column major): column grp, the same bytes
        const int8_t* p = b_s + (wn + ni * 8 + grp) * kRow + kk + tig * 4;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(p);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  // C fragment (16 x 8): rows grp (c0, c1) and grp + 8 (c2, c3), columns
  // 2 * tig and 2 * tig + 1
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + wm + mi * 16 + grp + (i >= 2 ? 8 : 0);
        const int col = n0 + wn + ni * 8 + tig * 2 + (i & 1);
        if (row < M && col < N) {
          const float a = (float)acc[mi][ni][i] * xs[row];
          out[(size_t)row * N + col] = a * ws[col];
        }
      }
}

}  // namespace

extern "C" int quant_matmul_launch(const void* xq, const void* xs,
                                   const void* wq, const void* ws, void* out,
                                   int M, int N, int K, void* stream) {
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  quant_matmul_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const int8_t*>(wq), static_cast<const float*>(ws),
      static_cast<float*>(out), M, N, K, K % 16 == 0);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ s8 tensor-core variant
namespace {

using repro::gemm::Gemm;
using repro::gemm::S8;

constexpr int kSMs = 132;        // H100 SXM: the plan's fixed card
constexpr int kWaves = 2;        // CTAs wanted: two waves of the SMs ...
constexpr int kSwapWaves = 1;    // ... or one where the operands swap
constexpr int kMinSplitKb = 4;   // k-blocks a split takes at least
constexpr int kSwapMaxM = 64;    // M up to this swaps the operands
constexpr int kTileA = 128;      // rows of A a CTA (two m64 warpgroups)
constexpr int kTileB = 256;      // rows of B (N) a CTA, unswapped

// The tc plan of (M, N, K): kernels/gemm_tc.py::qmm_plan mirrors it.
struct Plan {
  int swap, block_a, block_b, splits, k_per_split;
};

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

inline Plan qmm_plan(int M, int N, int K) {
  Plan p;
  p.swap = M <= kSwapMaxM;
  p.block_a = kTileA;
  const long long a_rows = p.swap ? N : M, b_rows = p.swap ? M : N;
  p.block_b = !p.swap  ? kTileB
              : M <= 8  ? 8
              : M <= 16 ? 16
              : M <= 32 ? 32
                        : 64;
  const long long tiles =
      cdiv(a_rows, p.block_a) * cdiv(b_rows, p.block_b);
  const long long kb = cdiv(K, repro::gemm::kBlockK);
  long long want =
      cdiv((long long)kSMs * (p.swap ? kSwapWaves : kWaves), tiles);
  const long long most = kb / kMinSplitKb > 1 ? kb / kMinSplitKb : 1;
  if (want > most) want = most;
  p.k_per_split = (int)cdiv(kb, want);
  p.splits = (int)cdiv(kb, p.k_per_split);   // no empty split
  return p;
}

template <int BB>
using QmmGemm = Gemm<S8, kTileA, BB, 2>;

// One CTA: A tile blockIdx.x, B tile blockIdx.y, split blockIdx.z over
// k-blocks [z * k_per_split, ...).  A = xq and B = wq, or swapped.
template <int BB, bool kSwap>
__global__ void __launch_bounds__(QmmGemm<BB>::kThreads,
                                  QmmGemm<BB>::kMinBlocks)
    qmm_tc_kernel(const __grid_constant__ CUtensorMap a_map,
                  const __grid_constant__ CUtensorMap b_map,
                  const float* __restrict__ xs,   // (M,)
                  const float* __restrict__ ws,   // (N,)
                  float* __restrict__ out,        // (M, N), or nullptr
                  int* __restrict__ part,         // (splits, M, N), or nullptr
                  int M, int N, int K, int k_per_split) {
  using G = QmmGemm<BB>;
  extern __shared__ unsigned char qmm_smem[];
  uint8_t* smem = repro::gemm::setup<G>(qmm_smem);
  const int a0 = blockIdx.x * kTileA, b0 = blockIdx.y * BB;
  const int split = blockIdx.z;
  const int kb = (K + repro::gemm::kBlockK - 1) / repro::gemm::kBlockK;
  const int t0 = split * k_per_split;
  const int n_k = max(0, min(kb, t0 + k_per_split) - t0);
  // warp-uniform role split (see attention_tc.cuh)
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  if (warp >= G::kNC * 4) {
    if constexpr (G::kMoveRegs) repro::tc::setmaxnreg_dec<40>();
    if (threadIdx.x % 128 != 0) return;
    repro::gemm::produce<G>(
        smem, n_k, [&](int i, uint32_t a, uint32_t b, uint64_t* bar) {
          const int kc = (t0 + i) * repro::gemm::kBlockK;
          repro::tc::tma_load_2d(a, &a_map, bar, kc, a0);
          repro::tc::tma_load_2d(b, &b_map, bar, kc, b0);
        });
  } else {
    if constexpr (G::kMoveRegs) repro::tc::setmaxnreg_inc<232>();
    const int wg = warp / 4;
    uint32_t acc[G::kMT][BB / 2];
    repro::gemm::consume<G>(smem, wg, n_k, acc);
    int* dst = part == nullptr ? nullptr : part + (size_t)split * M * N;
    auto put = [&](int r, int c, uint32_t v) {
      const int m = kSwap ? b0 + c : a0 + r, n = kSwap ? a0 + r : b0 + c;
      if (m >= M || n >= N) return;
      const size_t at = (size_t)m * N + n;
      if (dst != nullptr)
        dst[at] = (int)v;
      else
        out[at] = ((float)(int)v * xs[m]) * ws[n];
    };
    repro::gemm::for_each_pair<G>(
        wg, acc, [&](int r, int c, uint32_t v0, uint32_t v1) {
          put(r, c, v0);
          put(r, c + 1, v1);
        });
  }
}

// out = ((float)(sum of the splits' partials, in split order, wrapping)
// * xs[m]) * ws[n]
__global__ void __launch_bounds__(256) qmm_combine_kernel(
    const int* __restrict__ part, const float* __restrict__ xs,
    const float* __restrict__ ws, float* __restrict__ out, int M, int N,
    int splits) {
  const size_t mn = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    uint32_t acc = 0;
    for (int s = 0; s < splits; ++s) acc += (uint32_t)part[s * mn + i];
    out[i] = ((float)(int)acc * xs[i / N]) * ws[i % N];
  }
}

template <int BB, bool kSwap>
int launch_tc(const void* xq, const void* xs, const void* wq, const void* ws,
              void* out, void* part, int M, int N, int K, int splits,
              cudaStream_t stream) {
  using G = QmmGemm<BB>;
  CUtensorMap am, bm;
  const void* a = kSwap ? wq : xq;
  const void* b = kSwap ? xq : wq;
  const long long a_rows = kSwap ? N : M, b_rows = kSwap ? M : N;
  int e = repro::tma::encode_s8(&am, a, a_rows, K, kTileA);
  if (e == 0) e = repro::tma::encode_s8(&bm, b, b_rows, K, BB);
  if (e != 0) return e;
  auto kernel = qmm_tc_kernel<BB, kSwap>;
  const cudaError_t c = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kSmem);
  if (c != cudaSuccess) return (int)c;
  const int kb = (int)cdiv(K, repro::gemm::kBlockK);
  const int per = (int)cdiv(kb, splits);
  const dim3 grid((unsigned)cdiv(a_rows, kTileA), (unsigned)cdiv(b_rows, BB),
                  (unsigned)splits);
  const bool split = splits > 1;
  kernel<<<grid, G::kThreads, G::kSmem, stream>>>(
      am, bm, static_cast<const float*>(xs), static_cast<const float*>(ws),
      split ? nullptr : static_cast<float*>(out),
      split ? static_cast<int*>(part) : nullptr, M, N, K, per);
  cudaError_t r = cudaGetLastError();
  if (r != cudaSuccess || !split) return (int)r;
  const long long mn = (long long)M * N;
  const int blocks = (int)(cdiv(mn, 256) < 4096 ? cdiv(mn, 256) : 4096);
  qmm_combine_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const int*>(part), static_cast<const float*>(xs),
      static_cast<const float*>(ws), static_cast<float*>(out), M, N, splits);
  return (int)cudaGetLastError();
}

long long plan_smem(const Plan& p) {
  return repro::gemm::smem_bytes((p.block_a + p.block_b) *
                                 repro::gemm::kBlockK);
}

}  // namespace

// The tc plan of (M, N, K) as {swap, block_a, block_b, splits,
// k_per_split, stages, smem bytes}: kernels/gemm_tc.py::qmm_plan mirrors
// it and chip_smoke.py holds the two equal.
extern "C" void quant_matmul_tc_plan(int M, int N, int K, long long* out) {
  const Plan p = qmm_plan(M, N, K);
  out[0] = p.swap;
  out[1] = p.block_a;
  out[2] = p.block_b;
  out[3] = p.splits;
  out[4] = p.k_per_split;
  out[5] = repro::gemm::stages((p.block_a + p.block_b) *
                               repro::gemm::kBlockK);
  out[6] = plan_smem(p);
}

// K % 16 == 0; every base 16-byte aligned (TMA).  `splits` (>= 1, at
// most the k-blocks) cuts K into that many ranges of ceil(k-blocks /
// splits) k-blocks; the wrapper passes the plan's, and a check may force
// another (the bits do not change).  With splits > 1, `part` holds
// splits * M * N int32.
extern "C" int quant_matmul_tc_launch(const void* xq, const void* xs,
                                      const void* wq, const void* ws,
                                      void* out, void* part, int M, int N,
                                      int K, int splits, void* stream) {
  const int kb = (int)cdiv(K, repro::gemm::kBlockK);
  if (M < 1 || N < 1 || K < 16 || K % 16 || splits < 1 || splits > kb ||
      (splits > 1 && part == nullptr) ||
      ((uintptr_t)xq | (uintptr_t)wq | (uintptr_t)part) % 16)
    return (int)cudaErrorInvalidValue;
  const Plan p = qmm_plan(M, N, K);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!p.swap)
    return launch_tc<kTileB, false>(xq, xs, wq, ws, out, part, M, N, K,
                                    splits, s);
  switch (p.block_b) {
    case 8:
      return launch_tc<8, true>(xq, xs, wq, ws, out, part, M, N, K, splits, s);
    case 16:
      return launch_tc<16, true>(xq, xs, wq, ws, out, part, M, N, K, splits,
                                 s);
    case 32:
      return launch_tc<32, true>(xq, xs, wq, ws, out, part, M, N, K, splits,
                                 s);
    default:
      return launch_tc<64, true>(xq, xs, wq, ws, out, part, M, N, K, splits,
                                 s);
  }
}
