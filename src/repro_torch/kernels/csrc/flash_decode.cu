// Decode attention against the serving engine's linear slot cache, for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention_decode
// (_decode_kernel).  One query token per slot against its cache
// [B, S, KV, hd], per-slot valid lengths, an optional window that keeps
// positions [len - window, len); the g = H / KV query heads of one GQA
// group are computed together, as the TPU kernel's
// q.reshape(b, kv, g, hd) does.
//
// What bounds it on the H100: bytes.  Each cached position costs
// 2 x hd x 2 B of K/V and buys 4 x hd x g FLOPs (g = 6 on qwen2-1.5b), about
// 6 FLOPs per byte against the card's ~295 at the bf16 rate, so the bound
// is reading the live part of the cache once at 3.35 TB/s.
//
// Design: one block of 8 warps per (KV head, slot); warp w owns the
// group's heads w and w + 8 (g <= 16).  The block streams its slot's K/V
// from the window bound to the slot's length in 64-row tiles with 16-byte
// loads, and each warp runs the f32 online softmax over every tile.  At
// 16 slots x 2 KV heads that is 32 blocks on 132 SMs, so the card is far
// from its memory rate; a split-KV second pass is later work (PERF.md).
#include "flash_common.cuh"

namespace repro {

constexpr int DEC_WARPS = 8;
constexpr int DEC_ROWS = 2;  // query heads per warp: g <= 16
constexpr int DEC_MAX_G = DEC_WARPS * DEC_ROWS;

template <int HD>
constexpr int decode_smem_bytes() {
  return DEC_MAX_G * HD * 4 + 2 * Tile<HD>::WORDS * 4 +
         DEC_WARPS * DEC_ROWS * BK * 4;
}

template <int HD, typename TQ>
__global__ void __launch_bounds__(DEC_WARPS * 32)
    flash_decode_kernel(const TQ* __restrict__ q,
                        const __nv_bfloat16* __restrict__ kc,
                        const __nv_bfloat16* __restrict__ vc,
                        TQ* __restrict__ o, const int* __restrict__ lengths,
                        int S, int H, int KV, int window, float scale) {
  constexpr int PPL = Tile<HD>::PPL;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  uint32_t* k_s = reinterpret_cast<uint32_t*>(q_s + DEC_MAX_G * HD);
  uint32_t* v_s = k_s + Tile<HD>::WORDS;
  float* p_s = reinterpret_cast<float*>(v_s + Tile<HD>::WORDS);

  const int warp = threadIdx.x >> 5;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int g = H / KV;
  const long q_base = ((long)b * H + (long)kvh * g) * HD;

  for (int idx = threadIdx.x; idx < g * HD; idx += blockDim.x)
    q_s[idx] = to_f(q[q_base + idx]) * scale;

  const int len = min(lengths[b], S);
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

  const long row_stride = (long)KV * HD;
  const __nv_bfloat16* kb = kc + ((long)b * S * KV + kvh) * HD;
  const __nv_bfloat16* vb = vc + ((long)b * S * KV + kvh) * HD;
  auto valid = [&](int pos) { return pos < len && pos >= lo; };
  auto row_of = [&](int i) { return warp + DEC_WARPS * i; };
  auto mask = [&](int, int pos) { return valid(pos); };

  for (int kt = (lo / BK) * BK; kt < len; kt += BK) {
    __syncthreads();
    load_kv_tile<HD>(k_s, kb, row_stride, kt, valid);
    load_kv_tile<HD>(v_s, vb, row_stride, kt, valid);
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

template <int HD, typename TQ>
static int launch_decode(const void* q, const void* kc, const void* vc,
                         void* o, const int* lengths, int B, int S, int H,
                         int KV, int window, float scale,
                         cudaStream_t stream) {
  constexpr int smem = decode_smem_bytes<HD>();
  auto kern = flash_decode_kernel<HD, TQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(KV, B);
  kern<<<grid, DEC_WARPS * 32, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc), static_cast<TQ*>(o), lengths, S,
      H, KV, window, scale);
  return (int)cudaGetLastError();
}

template <int HD>
static int dispatch_decode(int q_is_f32, const void* q, const void* kc,
                           const void* vc, void* o, const int* lengths, int B,
                           int S, int H, int KV, int window, float scale,
                           cudaStream_t stream) {
  if (q_is_f32)
    return launch_decode<HD, float>(q, kc, vc, o, lengths, B, S, H, KV,
                                    window, scale, stream);
  return launch_decode<HD, __nv_bfloat16>(q, kc, vc, o, lengths, B, S, H, KV,
                                          window, scale, stream);
}

}  // namespace repro

// Plain C interface, loaded with ctypes; same return convention as
// repro_flash_fwd.  The wrapper guarantees H % KV == 0 and H / KV <= 16.
extern "C" int repro_flash_decode(const void* q, const void* kc,
                                  const void* vc, void* o, const int* lengths,
                                  int B, int S, int H, int KV, int hd,
                                  int window, float scale, int q_is_f32,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return repro::dispatch_decode<16>(q_is_f32, q, kc, vc, o, lengths, B, S,
                                        H, KV, window, scale, st);
    case 64:
      return repro::dispatch_decode<64>(q_is_f32, q, kc, vc, o, lengths, B, S,
                                        H, KV, window, scale, st);
    case 128:
      return repro::dispatch_decode<128>(q_is_f32, q, kc, vc, o, lengths, B,
                                         S, H, KV, window, scale, st);
    default:
      return -1;
  }
}
