// Block-sparse matrix product over a 128 x 128 block mask.
//
// Replaces the Pallas TPU kernel src/repro/kernels/block_sparse_matmul.py
// (block_sparse_matmul / _bsmm_kernel): out = x @ w summed over the live
// k-blocks of each 128-column block of w only.  x (M, K) and w (K, N)
// (already masked) in fp32 or bf16; kindex (N / 128, max_live) int32 lists,
// for output column block j, the k-blocks to read, -1 padded
// (compact_block_index).  fp32 accumulation; out (M, N) in x's dtype.  A
// block that kindex leaves out is never read, whatever w holds there.
//
// Bound on an H100: bytes.  The product reads x, the live 128 x 128 blocks
// of w and writes out; at M = 128 (the TUNE problem of Qwen2-7B's lm_head)
// that is 128 operations per byte of w against the ~295 at which bf16
// tensor cores outrun 3.35 TB/s, so the live weight bytes set the time.
//
// Design.  The TPU kernel walked a sequential grid (i, j, t) and carried
// an fp32 (block_m, 128) accumulator across t in VMEM, with the k-block of
// step t prefetched as a scalar.  Here one CTA owns an output tile of
// block_m rows x one 128-column block, reads its own kindex row and walks
// its live k-blocks in index order, skipping -1 entries, with the sums in
// registers: no split-K across CTAs and no atomic, so the result is
// deterministic.  Per k-block it stages the x tile and the w block in
// shared memory (rows padded so fragment loads fall on distinct banks)
// and multiplies them:
//  - bf16: 8 warps (2 x 4) issue mma.sync m16n8k16 bf16 products with fp32
//    accumulation (products of bf16 values are exact in fp32);
//  - fp32: FFMA on CUDA cores (no TF32, which would round the operands);
//    each of 256 threads owns block_m / 16 rows x 8 columns.
// block_m (the autotuned M tile) sets how often one w block is reused:
// larger tiles read w fewer times but give fewer CTAs.  The tile is padded
// to 32, 64, 128 or 256 rows; padding rows load as zeros and are not
// stored.
// What bounds this simple form: loads and products do not overlap (no
// cp.async/TMA pipeline) and mma.sync instead of wgmma; later work.

#include "common.cuh"

namespace {

using namespace repro;

constexpr int kBlock = 128;
constexpr int kThreads = 256;
constexpr int kRowF = kBlock + 4;  // fp32 x-tile row stride (floats)
constexpr int kRowH = kBlock + 8;  // bf16 tile row stride (halves)

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

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

// ----------------------------------------------------------------- bf16
template <int BMP>
__global__ void __launch_bounds__(kThreads) bsmm_bf16_kernel(
    const __nv_bfloat16* __restrict__ x,  // (M, K)
    const __nv_bfloat16* __restrict__ w,  // (K, N)
    const int* __restrict__ kindex,       // (N / 128, max_live)
    __nv_bfloat16* __restrict__ out,      // (M, N)
    int K, int N, int bm, int max_live) {
  constexpr int MT = BMP / 32;  // m16 tiles per warp (2 warps along M)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs =
      reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BMP][kRowH]
  __nv_bfloat16* ws = xs + BMP * kRowH;            // [128 (k)][kRowH]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;   // mma group / thread in group
  const int wm = warp / 4, wn = warp % 4;   // warp's 16*MT rows, 32 cols
  const int m0 = blockIdx.x * bm, j = blockIdx.y;
  const int kblocks = K / kBlock;
  const int* krow = kindex + (size_t)j * max_live;

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int t = 0; t < max_live; ++t) {
    const int kb = krow[t];
    if (kb < 0 || kb >= kblocks) continue;  // uniform over the CTA
    for (int i = tid; i < BMP * (kBlock / 8); i += kThreads) {
      const int r = i / (kBlock / 8), c8 = i % (kBlock / 8);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < bm)
        val = *reinterpret_cast<const uint4*>(
            x + (size_t)(m0 + r) * K + (size_t)kb * kBlock + 8 * c8);
      *reinterpret_cast<uint4*>(xs + r * kRowH + 8 * c8) = val;
    }
    for (int i = tid; i < kBlock * (kBlock / 8); i += kThreads) {
      const int r = i / (kBlock / 8), c8 = i % (kBlock / 8);
      *reinterpret_cast<uint4*>(ws + r * kRowH + 8 * c8) =
          *reinterpret_cast<const uint4*>(
              w + ((size_t)kb * kBlock + r) * N + (size_t)j * kBlock +
              8 * c8);
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < kBlock; kk += 16) {
      uint32_t bf[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = wn * 32 + nt * 8 + gq;
        const __nv_bfloat16* wc = ws + (kk + 2 * tq) * kRowH + n;
        bf[nt][0] = pack_bf16(wc[0], wc[kRowH]);
        bf[nt][1] = pack_bf16(wc[8 * kRowH], wc[9 * kRowH]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = wm * (BMP / 2) + mt * 16 + gq;
        const __nv_bfloat16* xr = xs + r * kRowH + kk + 2 * tq;
        uint32_t af[4];
        af[0] = *reinterpret_cast<const uint32_t*>(xr);
        af[1] = *reinterpret_cast<const uint32_t*>(xr + 8 * kRowH);
        af[2] = *reinterpret_cast<const uint32_t*>(xr + 8);
        af[3] = *reinterpret_cast<const uint32_t*>(xr + 8 * kRowH + 8);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af, bf[nt]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * (BMP / 2) + mt * 16 + gq + 8 * half;
      if (r >= bm) continue;
      __nv_bfloat16* o = out + (size_t)(m0 + r) * N + (size_t)j * kBlock;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = wn * 32 + nt * 8 + 2 * tq;
        *reinterpret_cast<__nv_bfloat162*>(o + c) = __floats2bfloat162_rn(
            acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
    }
  }
}

// Rows of the CTA's tile: block_m padded up to 32, 64, 128 or 256.
inline int tile_rows(int bm) {
  return bm <= 32 ? 32 : bm <= 64 ? 64 : bm <= 128 ? 128 : 256;
}

long long smem_bytes(int bm, int dtype) {
  const long long rows = tile_rows(bm);
  if (dtype == kBFloat16) return 2LL * (rows + kBlock) * kRowH;
  return 4LL * (rows * kRowF + (long long)kBlock * kBlock);
}

template <int BMP>
int launch(const void* x, const void* w, const int* kindex, void* out, int M,
           int K, int N, int bm, int max_live, int dtype, cudaStream_t s) {
  const size_t smem = (size_t)smem_bytes(bm, dtype);
  const dim3 grid(M / bm, N / kBlock);
  if (dtype == kBFloat16) {
    auto kernel = bsmm_bf16_kernel<BMP>;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), kindex,
        static_cast<__nv_bfloat16*>(out), K, N, bm, max_live);
  } else {
    auto kernel = bsmm_f32_kernel<BMP>;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), kindex,
        static_cast<float*>(out), K, N, bm, max_live);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one CTA for an M tile of block_m rows: the
// wrapper's smem_bytes mirrors it and the autotuner filters on it.
extern "C" long long block_sparse_matmul_smem_bytes(int block_m, int dtype) {
  return smem_bytes(block_m, dtype);
}

extern "C" int block_sparse_matmul_launch(const void* x, const void* w,
                                          const int* kindex, void* out,
                                          int M, int K, int N, int block_m,
                                          int max_live, int dtype,
                                          void* stream) {
  if (M < 1 || block_m < 1 || block_m > 256 || M % block_m != 0 ||
      K < kBlock || K % kBlock != 0 || N < kBlock || N % kBlock != 0 ||
      max_live < 1 || (dtype != kFloat32 && dtype != kBFloat16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_rows(block_m)) {
    case 32:
      return launch<32>(x, w, kindex, out, M, K, N, block_m, max_live, dtype,
                        s);
    case 64:
      return launch<64>(x, w, kindex, out, M, K, N, block_m, max_live, dtype,
                        s);
    case 128:
      return launch<128>(x, w, kindex, out, M, K, N, block_m, max_live,
                         dtype, s);
    default:
      return launch<256>(x, w, kindex, out, M, K, N, block_m, max_live,
                         dtype, s);
  }
}
