// Shared pieces of the attention kernels (flash_fwd.cu, flash_fwd_f32.cu,
// flash_bwd.cu, flash_bwd_f32.cu, flash_decode.cu, flash_paged_decode.cu).
//
// Numerics follow src/repro/kernels/flash_attention.py: f32 arithmetic,
// the finite sentinel NEG_INF = -1e30 for masked scores (a fully masked
// tile gives exp(0) = 1 and is cancelled exactly by corr = 0 once a valid
// tile arrives; -inf would give NaN there), rows of a tile outside the
// array zeroed before use (the TPU kernel's _clean), and l clamped at
// 1e-30 before the division.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tma.cuh"  // smem_u32 and the mbarrier helpers

namespace repro {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BK = 64;  // keys per K/V tile staged in shared memory

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Whether query row ``row`` sees key ``kpos`` (no offset; the backward's
// mask): both inside the arrays, causal and window bounds as flagged.
__device__ __forceinline__ bool visible(int row, int kpos, int Sq, int Sk,
                                        int causal, int window) {
  bool ok = kpos < Sk && row < Sq;
  if (causal) ok = ok && kpos <= row;
  if (window > 0) ok = ok && kpos > row - window;
  return ok;
}

// two f32 values as a bf16 pair (lo in the low half), rounded to nearest
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float2 bf2_to_f2(uint32_t w) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&w);
  return __bfloat1622float2(h);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Padded shared-memory row stride of a staged K/V tile, in 32-bit words:
// HD/2 bf16 pairs plus one word, so that 32 lanes reading 32 different
// rows at the same column hit 32 different banks.
template <int HD>
struct Tile {
  static constexpr int KW = HD / 2 + 1;
  static constexpr int WORDS = BK * KW;
  static constexpr int PPL = (HD / 2 + 31) / 32;  // bf16 pairs per lane
};

// Stage rows [k0, k0 + BK) of one KV head into shared memory with 16-byte
// loads: key position pos lives at ``src + pos * row_stride``, ``src``
// the address of row 0 of the head.  Rows for which valid(pos) is false
// are zeroed and never read from device memory.
template <int HD, typename Valid>
__device__ __forceinline__ void load_kv_tile(
    uint32_t* __restrict__ dst, const __nv_bfloat16* __restrict__ src,
    long row_stride, int k0, Valid valid) {
  constexpr int KW = Tile<HD>::KW;
  constexpr int VPR = HD / 8;  // uint4 vectors per row
  for (int idx = threadIdx.x; idx < BK * VPR; idx += blockDim.x) {
    const int j = idx / VPR, c = idx % VPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (valid(k0 + j))
      val = __ldg(reinterpret_cast<const uint4*>(
          src + (long)(k0 + j) * row_stride + c * 8));
    uint32_t* d = dst + j * KW + c * 4;
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

// One warp's online-softmax update over one staged tile of BK keys, for
// up to R query rows (``nr`` of them live, warp-uniform).  Lane l scores
// keys l and l + 32; the probabilities go through the warp's slice of
// shared memory ``p_w`` [R][BK]; for P·V lane l owns the bf16 pairs
// l, l + 32, ... of the head dimension.
//   row_of(i)    -> row of q_s (f32, pre-scaled, [*][HD]) for row i
//   mask(i, pos) -> whether row i attends to key position pos
template <int HD, int R, typename RowOf, typename Mask>
__device__ __forceinline__ void tile_step(
    const float* __restrict__ q_s, const uint32_t* __restrict__ k_s,
    const uint32_t* __restrict__ v_s, float* __restrict__ p_w, int k0,
    int nr, RowOf row_of, Mask mask, float (&m)[R], float (&l)[R],
    float (&acc)[R][2 * Tile<HD>::PPL]) {
  constexpr int KW = Tile<HD>::KW;
  constexpr int PPL = Tile<HD>::PPL;
  const int lane = threadIdx.x & 31;

  float s[R][2];
#pragma unroll
  for (int i = 0; i < R; ++i) s[i][0] = s[i][1] = 0.f;
  const uint32_t* k0p = k_s + lane * KW;
  const uint32_t* k1p = k_s + (lane + 32) * KW;
#pragma unroll 4
  for (int w = 0; w < HD / 2; ++w) {
    const float2 a = bf2_to_f2(k0p[w]);
    const float2 c = bf2_to_f2(k1p[w]);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i < nr) {
        const float2 qv =
            reinterpret_cast<const float2*>(q_s + row_of(i) * HD)[w];
        s[i][0] = fmaf(qv.x, a.x, s[i][0]);
        s[i][0] = fmaf(qv.y, a.y, s[i][0]);
        s[i][1] = fmaf(qv.x, c.x, s[i][1]);
        s[i][1] = fmaf(qv.y, c.y, s[i][1]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i < nr) {
      const float s0 = mask(i, k0 + lane) ? s[i][0] : NEG_INF;
      const float s1 = mask(i, k0 + lane + 32) ? s[i][1] : NEG_INF;
      const float m_new = fmaxf(m[i], warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p0 + p1);
      m[i] = m_new;
      p_w[i * BK + lane] = p0;
      p_w[i * BK + lane + 32] = p1;
#pragma unroll
      for (int t = 0; t < 2 * PPL; ++t) acc[i][t] *= corr;
    }
  }
  __syncwarp();

  for (int j = 0; j < BK; ++j) {
    const uint32_t* vr = v_s + j * KW;
    float2 vv[PPL];
#pragma unroll
    for (int t = 0; t < PPL; ++t) {
      const int pi = lane + 32 * t;
      vv[t] = (pi < HD / 2) ? bf2_to_f2(vr[pi]) : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i < nr) {
        const float p = p_w[i * BK + j];
#pragma unroll
        for (int t = 0; t < PPL; ++t) {
          acc[i][2 * t] = fmaf(p, vv[t].x, acc[i][2 * t]);
          acc[i][2 * t + 1] = fmaf(p, vv[t].y, acc[i][2 * t + 1]);
        }
      }
    }
  }
  __syncwarp();
}

// Write one finished row: o_row[d] = acc / max(l, 1e-30).
template <int HD, typename TO>
__device__ __forceinline__ void store_row(TO* __restrict__ o_row,
                                          const float (&acc)[2 * Tile<HD>::PPL],
                                          float l_clamped) {
  constexpr int PPL = Tile<HD>::PPL;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < PPL; ++t) {
    const int pi = lane + 32 * t;
    if (pi < HD / 2) {
      o_row[2 * pi] = from_f<TO>(acc[2 * t] / l_clamped);
      o_row[2 * pi + 1] = from_f<TO>(acc[2 * t + 1] / l_clamped);
    }
  }
}

}  // namespace repro
