// Dynamic-activation int8 x int8 matrix product with int32 accumulation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/quant_matmul.py
// (quant_matmul / _qmm_kernel).  Inputs arrive quantized, as the TPU
// kernel's do: xq (M, K) int8 with per-row fp32 scales xs (M,), and the
// weight's int8 values with per-output-column fp32 scales ws (N,), handed
// over as wq (N, K) so that k is contiguous for both operands.  Output
// (M, N) fp32: ((float)acc * xs[m]) * ws[n], acc the exact int32 sum.
//
// Bound on an H100: bytes at decode (M = 8: the int8 weight is read once
// for 2 * 8 operations per byte), operations at prefill (M = 4096: about
// 2 * 4096 operations per weight byte, above the ~590 operations per byte
// where int8 tensor cores at 1,979 TOPS outrun 3.35 TB/s).
//
// Design.  The TPU kernel carried an int32 (BM, BN) accumulator across
// the sequential k grid dimension in VMEM.  Here one CTA owns a 64 x 64
// output tile and walks all of K itself: 4 warps (2 x 2, 32 x 32 each)
// issue mma.sync.m16n8k32 s8.s8.s32 tensor-core products over 64-wide k
// slabs staged in shared memory, with the int32 sums in registers.  Rows
// of a slab are padded to 80 bytes so that the fragment loads of a warp
// fall on distinct banks.  Ragged M, N and K edges load as zeros, so any
// shape works with no pad copy.  Integer sums are exact, so the result
// does not depend on the k order; there is no split-K across CTAs and no
// atomic.  The epilogue multiplies in the plain version's order, and the
// library is built without fast math, so the output is bit-identical to
// it.  K < 133,143 keeps |acc| <= 127 * 127 * K below 2**31 (the wrapper
// checks it).  What bounds this simple form: no cp.async/TMA pipeline
// (loads and products do not overlap) and mma.sync instead of wgmma;
// both are later work.

#include "common.cuh"

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
