// The body shared by the two decode kernels (flash_decode.cu against the
// linear slot cache, flash_paged_decode.cu against block pools): one block
// of 8 warps per (KV head, query row), warp w owning the group's heads w
// and w + 8 (g <= 16), the row's keys streamed in 64-row tiles and an f32
// online softmax per warp.  The two kernels differ only in where key
// position pos lives, which the caller passes as ``row_off``; everything
// that touches a value is this one template, so on the same keys the two
// give the same bits.
#pragma once

#include "flash_common.cuh"

namespace repro {

constexpr int DEC_WARPS = 8;
constexpr int DEC_ROWS = 2;  // query heads per warp: g <= 16
constexpr int DEC_MAX_G = DEC_WARPS * DEC_ROWS;

// Shared memory of decode_block: q (f32), one K and one V tile, and the
// warps' probability rows.
template <int HD>
__host__ __device__ constexpr int decode_smem_bytes() {
  return DEC_MAX_G * HD * 4 + 2 * Tile<HD>::WORDS * 4 +
         DEC_WARPS * DEC_ROWS * BK * 4;
}

// Attend query row b's g heads of KV head kvh to key positions
// [lo, len) with lo = max(0, len - window) (window 0: no window).  Key
// position pos of K (V) lives at kc + row_off(pos) (vc + row_off(pos)).
// ``smem`` holds decode_smem_bytes<HD>() bytes.
template <int HD, typename TQ, typename RowOff>
__device__ __forceinline__ void decode_block(
    const TQ* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
    const __nv_bfloat16* __restrict__ vc, TQ* __restrict__ o, int b, int kvh,
    int H, int KV, int len, int window, float scale, unsigned char* smem,
    RowOff row_off) {
  constexpr int PPL = Tile<HD>::PPL;
  float* q_s = reinterpret_cast<float*>(smem);
  uint32_t* k_s = reinterpret_cast<uint32_t*>(q_s + DEC_MAX_G * HD);
  uint32_t* v_s = k_s + Tile<HD>::WORDS;
  float* p_s = reinterpret_cast<float*>(v_s + Tile<HD>::WORDS);

  const int warp = threadIdx.x >> 5;
  const int g = H / KV;
  const long q_base = ((long)b * H + (long)kvh * g) * HD;

  for (int idx = threadIdx.x; idx < g * HD; idx += blockDim.x)
    q_s[idx] = to_f(q[q_base + idx]) * scale;

  const int lo = window > 0 ? max(0, len - window) : 0;
  const int nr = warp < g ? (g - warp + DEC_WARPS - 1) / DEC_WARPS : 0;

  float m[DEC_ROWS], l[DEC_ROWS], acc[DEC_ROWS][2 * PPL];
#pragma unroll
  for (int i = 0; i < DEC_ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int t = 0; t < 2 * PPL; ++t) acc[i][t] = 0.f;
  }

  auto valid = [&](int pos) { return pos < len && pos >= lo; };
  auto row_of = [&](int i) { return warp + DEC_WARPS * i; };
  auto mask = [&](int, int pos) { return valid(pos); };

  for (int kt = (lo / BK) * BK; kt < len; kt += BK) {
    __syncthreads();
    load_kv_rows<HD>(k_s, kc, row_off, kt, valid);
    load_kv_rows<HD>(v_s, vc, row_off, kt, valid);
    __syncthreads();
    if (nr > 0)
      tile_step<HD, DEC_ROWS>(q_s, k_s, v_s, p_s + warp * DEC_ROWS * BK, kt,
                              nr, row_of, mask, m, l, acc);
  }

#pragma unroll
  for (int i = 0; i < DEC_ROWS; ++i) {
    if (i < nr) {
      const float lc = fmaxf(l[i], 1e-30f);
      store_row<HD>(o + q_base + (long)row_of(i) * HD, acc[i], lc);
    }
  }
}

}  // namespace repro
