// Decode attention against the serving engine's linear slot cache, for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention_decode
// (_decode_kernel, called at :280).  One query token per slot against its
// cache [B, S, KV, hd], per-slot valid lengths, an optional window that
// keeps positions [len - window, len); the g = H / KV query heads of one
// GQA group are computed together, as the TPU kernel's
// q.reshape(b, kv, g, hd) does.
//
// What bounds it on the H100: bytes (2 x hd x 2 B of K/V per live
// position for 4 x hd x g FLOPs, ~6 FLOPs a byte against the card's ~295).
// Design: the split-KV body of flash_decode.cuh, grid (splits, KV, B),
// each block a ``split``-position slice of one (slot, KV head); position
// pos of the slot lives at row (b, pos, kvh) of the cache, so a tile's
// live rows are bulk-copied straight from there.
#include "flash_decode.cuh"

namespace repro {

// position pos of one (slot, KV head) at head0 + pos * stride
struct LinearRows {
  long head0, stride;
  template <typename F>
  __device__ __forceinline__ void each(int p0, int p1, int lane, F f) const {
    for (int pos = p0 + lane; pos < p1; pos += 32)
      f(pos, head0 + (long)pos * stride);
  }
};

template <int HD, typename TQ>
__global__ void __launch_bounds__(DEC_WARPS * 32)
    flash_decode_kernel(const TQ* __restrict__ q,
                        const __nv_bfloat16* __restrict__ kc,
                        const __nv_bfloat16* __restrict__ vc,
                        TQ* __restrict__ o, const int* __restrict__ lengths,
                        float* __restrict__ part, int* __restrict__ arrived,
                        int S, int H, int KV, int window, int split,
                        float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int kvh = blockIdx.y, b = blockIdx.z;
  const LinearRows rows{((long)b * S * KV + kvh) * HD, (long)KV * HD};
  decode_split<HD>(q, kc, vc, o, lengths, part, arrived, b, kvh, H, KV, S,
                   window, split, scale, smem, rows);
}

template <int HD, typename TQ>
static int launch_decode(const void* q, const void* kc, const void* vc,
                         void* o, const int* lengths, float* part,
                         int* arrived, int B, int S, int H, int KV,
                         int window, int split, float scale,
                         cudaStream_t stream) {
  constexpr int smem = dec_smem_bytes<HD>();
  auto kern = flash_decode_kernel<HD, TQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(max(1, (S + split - 1) / split), KV, B);
  kern<<<grid, DEC_WARPS * 32, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc), static_cast<TQ*>(o), lengths,
      part, arrived, S, H, KV, window, split, scale);
  return (int)cudaGetLastError();
}

template <int HD>
static int dispatch_decode(int q_is_f32, const void* q, const void* kc,
                           const void* vc, void* o, const int* lengths,
                           float* part, int* arrived, int B, int S, int H,
                           int KV, int window, int split, float scale,
                           cudaStream_t stream) {
  if (q_is_f32)
    return launch_decode<HD, float>(q, kc, vc, o, lengths, part, arrived, B,
                                    S, H, KV, window, split, scale, stream);
  return launch_decode<HD, __nv_bfloat16>(q, kc, vc, o, lengths, part,
                                          arrived, B, S, H, KV, window, split,
                                          scale, stream);
}

}  // namespace repro

// Plain C interface, loaded with ctypes; same return convention as
// repro_flash_fwd, and -4 for a split that is not a positive multiple of
// 64 or that cuts S into more than 64 splits.  The wrapper guarantees
// H % KV == 0 and H / KV <= 16; ``part`` holds ceil(S / split) records of
// dec_record(H / KV, hd) floats per (slot, KV head) and ``arrived`` B x KV
// ints, zero (each launch leaves them zero); both may be null when S <=
// split.
extern "C" int repro_flash_decode(const void* q, const void* kc,
                                  const void* vc, void* o, const int* lengths,
                                  float* part, int* arrived, int B, int S,
                                  int H, int KV, int hd, int window,
                                  int split, float scale, int q_is_f32,
                                  void* stream) {
  if (split < repro::BK || split % repro::BK ||
      (S + split - 1) / split > repro::DEC_MAX_SPLITS)
    return -4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
#define REPRO_HD(HD)                                                      \
  case HD:                                                                \
    return repro::dispatch_decode<HD>(q_is_f32, q, kc, vc, o, lengths,    \
                                      part, arrived, B, S, H, KV, window, \
                                      split, scale, st)
    REPRO_HD(16);
    REPRO_HD(64);
    REPRO_HD(80);
    REPRO_HD(120);
    REPRO_HD(128);
#undef REPRO_HD
    default:
      return -1;
  }
}
