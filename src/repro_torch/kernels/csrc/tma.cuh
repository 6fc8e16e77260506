// What the kernels that bring tiles in by the Tensor Memory Accelerator
// (flash_fwd.cu, ssd_scan.cu) or by bulk copies onto an mbarrier
// (flash_decode.cuh) share: the mbarrier helpers, the tensor-map encoder
// reached through the runtime (so nothing links libcuda), the encoding of
// a [B, S, NH, D] array as 64-row x 64-column boxes, and the 4-d box copy.
// How each kernel lays its tiles out and describes them to wgmma is its
// own: the forward takes bf16 boxes in the 128-byte swizzle, the SSD scan
// f32 boxes unswizzled, which it converts itself.
#pragma once

#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached
                   // through the runtime, so nothing links libcuda
#include <cuda_runtime.h>

namespace repro {

constexpr int TMA_BOX = 64;  // rows and columns of a box

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers in shared memory for copies that complete on them: one
// arrival a phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}
// the one arrival of this phase, and the bytes its copies will bring
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(phase)
        : "memory");
  } while (!done);
}

// One TMA copy of a box of 64 rows x 64 columns of a [B, S, NH, D] array
// (map: encode_rows) into shared memory at ``dst``; completes on ``bar``.
// Rows and columns past the array are zero-filled.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        int col, int head, int row, int b,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head), "r"(row),
      "r"(b), "r"(smem_u32(bar))
      : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime.
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [B, S, NH, D] array of bf16 (``f32`` false) or f32 as a 4-d tensor
// (D, NH, S, B) read in boxes of 64 columns x 1 head x 64 rows x 1 batch,
// zeros past every end.  The base must be 16-byte aligned and D a
// multiple of 16 bytes.  -> 0, or -2 without an encoder, -3 if refused.
inline int encode_rows(CUtensorMap* map, const void* base, int B, int S,
                       int NH, int D, bool f32, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return -2;
  const cuuint64_t e = f32 ? 4 : 2;
  const cuuint64_t dim[4] = {(cuuint64_t)D, (cuuint64_t)NH, (cuuint64_t)S,
                             (cuuint64_t)B};
  const cuuint64_t stride[3] = {(cuuint64_t)D * e, (cuuint64_t)NH * D * e,
                                (cuuint64_t)S * NH * D * e};
  const cuuint32_t box[4] = {TMA_BOX, 1, TMA_BOX, 1}, one[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map,
      f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(base), dim, stride, box, one,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

}  // namespace repro
