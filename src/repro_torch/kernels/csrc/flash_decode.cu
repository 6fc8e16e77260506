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
#include "flash_decode.cuh"

namespace repro {

template <int HD, typename TQ>
__global__ void __launch_bounds__(DEC_WARPS * 32)
    flash_decode_kernel(const TQ* __restrict__ q,
                        const __nv_bfloat16* __restrict__ kc,
                        const __nv_bfloat16* __restrict__ vc,
                        TQ* __restrict__ o, const int* __restrict__ lengths,
                        int S, int H, int KV, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const long head0 = ((long)b * S * KV + kvh) * HD;
  const long row_stride = (long)KV * HD;
  decode_block<HD>(q, kc, vc, o, b, kvh, H, KV, min(lengths[b], S), window,
                   scale, smem,
                   [=](int pos) { return head0 + (long)pos * row_stride; });
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
    case 80:
      return repro::dispatch_decode<80>(q_is_f32, q, kc, vc, o, lengths, B, S,
                                        H, KV, window, scale, st);
    case 128:
      return repro::dispatch_decode<128>(q_is_f32, q, kc, vc, o, lengths, B,
                                         S, H, KV, window, scale, st);
    default:
      return -1;
  }
}
