// What the two wgmma attention kernels (flash_fwd.cu, flash_bwd.cu) both
// use: the tile of 64 rows (q rows or keys) and the warpgroup that owns
// it, and the split of an f32 accumulator fragment into the bf16 register
// operands of a product.  How each kernel stages its tiles and describes
// them to wgmma is its own: the backward by 16-byte cp.async in the
// no-swizzle layout, the forward by TMA in the 128-byte swizzle.
#pragma once

#include "flash_common.cuh"
#include "wgmma.cuh"

namespace repro {

constexpr int BT = 64;           // rows of a tile: q rows or keys
constexpr int WG_THREADS = 128;  // one warpgroup
static_assert(BT == BK, "a key tile is one K/V tile");

// X [64 x 64], an accumulator fragment, as two bf16 register A operands
// hi = bf16(X), lo = bf16(X - hi), each for the four k-steps of a product
// over X's 64 columns
__device__ __forceinline__ void to_operands(const float (&x)[32],
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = x[8 * kk + 2 * r], b = x[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      const float2 hf = __bfloat1622float2(h);
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][r] = pack_bf16(a - hf.x, b - hf.y);
    }
}

}  // namespace repro
