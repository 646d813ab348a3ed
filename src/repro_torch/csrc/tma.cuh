// Host-side TMA tensor maps of 2-D row-major matrices, shared by the
// kernels that load tiles with cp.async.bulk.tensor (flash_attention.cu,
// quant_matmul.cu, block_sparse_matmul.cu).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace repro {
namespace tma {

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda)
inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map over a row-major (rows, cols) matrix of `elem_bytes`-byte
// elements of `type`: boxes of box_cols columns by box_rows rows, 128-byte
// swizzle (box_cols * elem_bytes must be 128), zeros past the edges.  The
// row pitch cols * elem_bytes must be a multiple of 16 bytes and the base
// 16-byte aligned.
inline int encode_2d(CUtensorMap* map, const void* ptr,
                     CUtensorMapDataType type, int elem_bytes,
                     long long rows, long long cols, int box_cols,
                     int box_rows) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(ptr), dims, strides,
                        box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// bf16: boxes of 64 columns (128 bytes) by box_rows rows
inline int encode_bf16(CUtensorMap* map, const void* ptr, long long rows,
                       long long cols, int box_rows) {
  return encode_2d(map, ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, rows, cols,
                   64, box_rows);
}

// int8 (as raw bytes): boxes of 128 columns by box_rows rows
inline int encode_s8(CUtensorMap* map, const void* ptr, long long rows,
                     long long cols, int box_rows) {
  return encode_2d(map, ptr, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, rows, cols,
                   128, box_rows);
}

}  // namespace tma
}  // namespace repro
