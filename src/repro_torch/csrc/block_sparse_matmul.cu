// Block-sparse matrix product over a 128 x 128 block mask.
//
// Replaces the Pallas TPU kernel src/repro/kernels/block_sparse_matmul.py
// (block_sparse_matmul / _bsmm_kernel): out = x @ w summed over the live
// k-blocks of each 128-column block of w only.  x (M, K) and w (K, N)
// (already masked) in fp32 or bf16; kindex (N / 128, max_live) int32 lists,
// for output column block j, the k-blocks to read, -1 padded
// (compact_block_index).  fp32 accumulation; out (M, N) in x's dtype,
// rounded once.  A block that kindex leaves out is never read, whatever w
// holds there; a column block with no live k-block is 0.
//
// Bound on an H100: bytes.  The product reads x, the live 128 x 128 blocks
// of w and writes out; at M = 128 (the TUNE problem of Qwen2-7B's lm_head)
// that is 128 operations per byte of w against the ~295 at which bf16
// tensor cores outrun 3.35 TB/s, so the live weight bytes set the time.
//
// Design.  The TPU kernel walked a sequential grid (i, j, t) and carried
// an fp32 (block_m, 128) accumulator across t in VMEM, with the k-block of
// step t prefetched as a scalar.  Here one CTA owns an output tile of
// rows x one 128-column block, reads its own kindex row and walks its live
// k-blocks in index order, skipping -1 entries, with the sums in
// registers: no split-K across CTAs and no atomic, so the result is
// deterministic.  Two variants (kernels/gemm_tc.py picks one by dtype):
//  - bf16 ("tc"): the shared TMA/wgmma main loop of gemm_tc.cuh.  The
//    producer reads the kindex row and issues TMA only for live entries:
//    per k-block the x tile (rows x 128, K-major, two 64-column boxes)
//    and the w block (128 x 128, MN-major, two boxes), into a ring of 2-4
//    stages; the consumers run wgmma m64n128k16 bf16 x bf16 -> fp32
//    (products of bf16 values are exact in fp32).  Tiles of 64, 128 or
//    256 rows (one or two consumer warpgroups; a block_m request maps to
//    the nearest); TMA zero-fills rows past M, which are not stored.
//  - fp32 ("ffma"): FFMA on CUDA cores (no TF32, which would round the
//    operands); each of 256 threads owns block_m / 16 rows x 8 columns,
//    the x tile and the w block staged in shared memory (rows padded so
//    that fragment loads fall on distinct banks) with no load pipeline.
//    block_m (the autotuned M tile) is padded to 32, 64, 128 or 256 rows;
//    padding rows load as zeros and are not stored.

#include "common.cuh"
#include "gemm_tc.cuh"
#include "tma.cuh"

namespace {

using namespace repro;

constexpr int kBlock = 128;
constexpr int kThreads = 256;
constexpr int kRowF = kBlock + 4;  // fp32 x-tile row stride (floats)

// ----------------------------------------------------------------- fp32
template <int BMP>
__global__ void __launch_bounds__(kThreads) bsmm_f32_kernel(
    const float* __restrict__ x,       // (M, K)
    const float* __restrict__ w,       // (K, N)
    const int* __restrict__ kindex,    // (N / 128, max_live)
    float* __restrict__ out,           // (M, N)
    int K, int N, int bm, int max_live) {
  constexpr int RT = BMP / 16;  // rows per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // [BMP][kRowF]
  float* ws = xs + BMP * kRowF;                    // [128][128]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.x * bm, j = blockIdx.y;
  const int kblocks = K / kBlock;
  const int* krow = kindex + (size_t)j * max_live;

  float acc[RT][8];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  for (int t = 0; t < max_live; ++t) {
    const int kb = krow[t];
    if (kb < 0 || kb >= kblocks) continue;  // uniform over the CTA
    for (int i = tid; i < BMP * (kBlock / 4); i += kThreads) {
      const int r = i / (kBlock / 4), c4 = i % (kBlock / 4);
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < bm)
        val = *reinterpret_cast<const float4*>(
            x + (size_t)(m0 + r) * K + (size_t)kb * kBlock + 4 * c4);
      *reinterpret_cast<float4*>(xs + r * kRowF + 4 * c4) = val;
    }
    for (int i = tid; i < kBlock * (kBlock / 4); i += kThreads) {
      const int r = i / (kBlock / 4), c4 = i % (kBlock / 4);
      *reinterpret_cast<float4*>(ws + r * kBlock + 4 * c4) =
          *reinterpret_cast<const float4*>(
              w + ((size_t)kb * kBlock + r) * N + (size_t)j * kBlock +
              4 * c4);
    }
    __syncthreads();
    for (int k = 0; k < kBlock; ++k) {
      const float4 b0 = *reinterpret_cast<const float4*>(ws + k * kBlock +
                                                         4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(
          ws + k * kBlock + 64 + 4 * tx);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float a = xs[(ty + 16 * i) * kRowF + k];
        acc[i][0] = fmaf(a, b0.x, acc[i][0]);
        acc[i][1] = fmaf(a, b0.y, acc[i][1]);
        acc[i][2] = fmaf(a, b0.z, acc[i][2]);
        acc[i][3] = fmaf(a, b0.w, acc[i][3]);
        acc[i][4] = fmaf(a, b1.x, acc[i][4]);
        acc[i][5] = fmaf(a, b1.y, acc[i][5]);
        acc[i][6] = fmaf(a, b1.z, acc[i][6]);
        acc[i][7] = fmaf(a, b1.w, acc[i][7]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = ty + 16 * i;
    if (r >= bm) continue;
    float* o = out + (size_t)(m0 + r) * N + (size_t)j * kBlock;
    *reinterpret_cast<float4*>(o + 4 * tx) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(o + 64 + 4 * tx) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// Rows of the fp32 kernel's tile: block_m padded up to 32, 64, 128 or
// 256.
inline int tile_rows(int bm) {
  return bm <= 32 ? 32 : bm <= 64 ? 64 : bm <= 128 ? 128 : 256;
}

long long smem_bytes_f32(int bm) {
  const long long rows = tile_rows(bm);
  return 4LL * (rows * kRowF + (long long)kBlock * kBlock);
}

template <int BMP>
int launch_f32(const void* x, const void* w, const int* kindex, void* out,
               int M, int K, int N, int bm, int max_live, cudaStream_t s) {
  const size_t smem = (size_t)smem_bytes_f32(bm);
  const dim3 grid(M / bm, N / kBlock);
  auto kernel = bsmm_f32_kernel<BMP>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), kindex,
      static_cast<float*>(out), K, N, bm, max_live);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------- bf16 tensor-core
using bf16 = __nv_bfloat16;

// The tc tile of a block_m request: the nearest of 64, 128 and 256
// (kernels/gemm_tc.py::bsmm_tile mirrors it).
inline int tc_tile(int bm) { return bm < 96 ? 64 : bm < 192 ? 128 : 256; }

template <int T>
using BsmmGemm = gemm::Gemm<gemm::BF16, T, kBlock, T == 64 ? 1 : 2>;

template <int T>
__global__ void __launch_bounds__(BsmmGemm<T>::kThreads,
                                  BsmmGemm<T>::kMinBlocks)
    bsmm_tc_kernel(const __grid_constant__ CUtensorMap x_map,
                   const __grid_constant__ CUtensorMap w_map,
                   const int* __restrict__ kindex,  // (N / 128, max_live)
                   bf16* __restrict__ out,          // (M, N)
                   int M, int K, int N, int max_live) {
  using G = BsmmGemm<T>;
  extern __shared__ unsigned char bsmm_smem[];
  uint8_t* smem = gemm::setup<G>(bsmm_smem);
  const int m0 = blockIdx.x * T, j = blockIdx.y;
  const int kblocks = K / kBlock;
  const int* krow = kindex + (size_t)j * max_live;
  int n_k = 0;
  for (int t = 0; t < max_live; ++t)
    n_k += krow[t] >= 0 && krow[t] < kblocks;
  // warp-uniform role split (see attention_tc.cuh)
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  if (warp >= G::kNC * 4) {
    if constexpr (G::kMoveRegs) tc::setmaxnreg_dec<40>();
    if (threadIdx.x % 128 != 0) return;
    int t = 0;   // the next kindex entry to look at
    gemm::produce<G>(
        smem, n_k, [&](int, uint32_t a, uint32_t b, uint64_t* bar) {
          int kb = krow[t++];
          while (kb < 0 || kb >= kblocks) kb = krow[t++];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            tc::tma_load_2d(a + c * T * gemm::kRowBytes, &x_map, bar,
                            kb * kBlock + 64 * c, m0);
            tc::tma_load_2d(b + c * kBlock * gemm::kRowBytes, &w_map, bar,
                            j * kBlock + 64 * c, kb * kBlock);
          }
        });
  } else {
    if constexpr (G::kMoveRegs) tc::setmaxnreg_inc<232>();
    const int wg = warp / 4;
    float acc[G::kMT][kBlock / 2];
    gemm::consume<G>(smem, wg, n_k, acc);
    bf16* o = out + (size_t)j * kBlock;
    gemm::for_each_pair<G>(wg, acc, [&](int r, int c, float v0, float v1) {
      if (m0 + r < M)
        *reinterpret_cast<uint32_t*>(o + (size_t)(m0 + r) * N + c) =
            tc::pack_bf16(v0, v1);
    });
  }
}

template <int T>
int launch_tc(const void* x, const void* w, const int* kindex, void* out,
              int M, int K, int N, int max_live, cudaStream_t s) {
  using G = BsmmGemm<T>;
  CUtensorMap xm, wm;
  int e = tma::encode_bf16(&xm, x, M, K, T);
  if (e == 0) e = tma::encode_bf16(&wm, w, K, N, kBlock);
  if (e != 0) return e;
  auto kernel = bsmm_tc_kernel<T>;
  const cudaError_t a = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kSmem);
  if (a != cudaSuccess) return (int)a;
  const dim3 grid((M + T - 1) / T, N / kBlock);
  kernel<<<grid, G::kThreads, G::kSmem, s>>>(
      xm, wm, kindex, static_cast<bf16*>(out), M, K, N, max_live);
  return (int)cudaGetLastError();
}

long long smem_bytes_tc(int bm) {
  switch (tc_tile(bm)) {
    case 64:
      return BsmmGemm<64>::kSmem;
    case 128:
      return BsmmGemm<128>::kSmem;
    default:
      return BsmmGemm<256>::kSmem;
  }
}

}  // namespace

// Dynamic shared memory of one CTA for an M tile of block_m rows (bf16:
// the tc tile block_m maps to): the wrapper's smem_bytes mirrors it and
// the autotuner filters on it.
extern "C" long long block_sparse_matmul_smem_bytes(int block_m, int dtype) {
  return dtype == kBFloat16 ? smem_bytes_tc(block_m) : smem_bytes_f32(block_m);
}

// fp32 x and w; M a multiple of block_m <= 256.
extern "C" int block_sparse_matmul_launch(const void* x, const void* w,
                                          const int* kindex, void* out,
                                          int M, int K, int N, int block_m,
                                          int max_live, void* stream) {
  if (M < 1 || block_m < 1 || block_m > 256 || M % block_m != 0 ||
      K < kBlock || K % kBlock != 0 || N < kBlock || N % kBlock != 0 ||
      max_live < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_rows(block_m)) {
    case 32:
      return launch_f32<32>(x, w, kindex, out, M, K, N, block_m, max_live,
                            s);
    case 64:
      return launch_f32<64>(x, w, kindex, out, M, K, N, block_m, max_live,
                            s);
    case 128:
      return launch_f32<128>(x, w, kindex, out, M, K, N, block_m, max_live,
                             s);
    default:
      return launch_f32<256>(x, w, kindex, out, M, K, N, block_m, max_live,
                             s);
  }
}

// bf16 x and w, every base 16-byte aligned (TMA); the tile is the tc tile
// of block_m (64, 128 or 256 rows; any M).
extern "C" int block_sparse_matmul_tc_launch(const void* x, const void* w,
                                             const int* kindex, void* out,
                                             int M, int K, int N,
                                             int block_m, int max_live,
                                             void* stream) {
  if (M < 1 || block_m < 1 || K < kBlock || K % kBlock != 0 ||
      N < kBlock || N % kBlock != 0 || max_live < 1 ||
      ((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tc_tile(block_m)) {
    case 64:
      return launch_tc<64>(x, w, kindex, out, M, K, N, max_live, s);
    case 128:
      return launch_tc<128>(x, w, kindex, out, M, K, N, max_live, s);
    default:
      return launch_tc<256>(x, w, kindex, out, M, K, N, max_live, s);
  }
}
