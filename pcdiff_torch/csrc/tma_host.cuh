// Host side of the tensor memory accelerator (TMA): the tensor maps that the kernels' TMA
// copies (ptx.cuh tma_load_2d / tma_load_3d) read, built by cuTensorMapEncodeTiled, libcuda's
// entry point fetched through the runtime (no link to libcuda). Used by the whole-MLP kernel K5
// (ln_mlp.cu), the wide rows of K3 (ln_dense.cu) and K1 at head dim 64 (attention_mh64.cu).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace pcdiff_tma {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// The tensor map of a bf16 (or, with fp32 = true, fp32) tensor of `rank` (2 or 3)
// dimensions, dims[0] innermost and contiguous, strides[i] the bytes between steps of
// dims[i + 1], read in boxes of `box` elements (box[0] x the element size = 128 bytes: one
// row of the 128-byte swizzle, 16-byte chunk c of box row r at c ^ (r % 8), which wgmma and
// the fp32 fragments read); elements outside the tensor are zero-filled. Returns a
// cudaError_t (0 on success).
inline int tensor_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                      const cuuint64_t* strides, const cuuint32_t* box, bool fp32 = false) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapDataType type =
      fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r = fn(map, type, (cuuint32_t)rank, const_cast<void*>(base), dims, strides,
                        box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace pcdiff_tma
