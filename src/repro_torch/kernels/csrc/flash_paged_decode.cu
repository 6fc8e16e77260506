// Decode attention against the paged tier's block pools, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention_paged_decode
// (_paged_decode_kernel).  One query token per table row against block
// pools [NB, BL, KV, hd] read through that row's block table [MB]: key
// position pos of row b lives in pool block table[b, pos / BL] at offset
// pos % BL.  Positions at or past the row's length (at most MB x BL) are
// masked; there is no window (the paged tier serves full-attention
// configurations only).  Block 0 is the allocator's null sink: table
// entries past a row's blocks point there, and nothing in it is read.
//
// What bounds it on the H100: bytes, as for flash_decode.cu.  Each live
// position costs 2 x hd x 2 B of K/V and buys 4 x hd x g FLOPs (g = 6 on
// qwen2-1.5b), about 6 FLOPs per byte against the card's ~295 at the bf16
// rate, so the bound is reading the live K/V once (plus the live table
// entries) at 3.35 TB/s.
//
// Design: the decode body of flash_decode.cuh, shared with the linear
// kernel so that on the gathered view the two give the same bits (one
// block of 8 warps per (KV head, row), 64-row tiles, f32 online softmax).
// Only the row address changes.  The block first copies the live part of
// its table row, ceil(len / BL) entries, into shared memory: the
// counterpart of the TPU kernel's scalar prefetch, so the tile loop
// makes no load whose address waits on another global load.  Rows at or
// past the length are zero-filled and never read (the TPU kernel's
// _clean), so no value of block 0 or of a stale block, NaN and inf
// included, can reach the output.  The block is computed per row, so any
// block length BL >= 1 works, whether or not it divides the 64-row tile.
// Offsets are 64-bit: the pool's leading axis is blocks, not slots.
#include "flash_decode.cuh"

namespace repro {

template <int HD, typename TQ>
__global__ void __launch_bounds__(DEC_WARPS * 32)
    flash_paged_decode_kernel(const TQ* __restrict__ q,
                              const __nv_bfloat16* __restrict__ kp,
                              const __nv_bfloat16* __restrict__ vp,
                              TQ* __restrict__ o,
                              const int* __restrict__ table,
                              const int* __restrict__ lengths, int MB, int BL,
                              int H, int KV, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* tbl_s = reinterpret_cast<int*>(smem + decode_smem_bytes<HD>());
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int len = min(lengths[b], MB * BL);
  const int nblk = (len + BL - 1) / BL;
  for (int i = threadIdx.x; i < nblk; i += blockDim.x)
    tbl_s[i] = table[(long)b * MB + i];
  // decode_block synchronises the block before its first read of tbl_s
  const long row_stride = (long)KV * HD;
  decode_block<HD>(q, kp, vp, o, b, kvh, H, KV, len, 0, scale, smem,
                   [=](int pos) {
                     return ((long)tbl_s[pos / BL] * BL + pos % BL) *
                                row_stride +
                            (long)kvh * HD;
                   });
}

template <int HD, typename TQ>
static int launch_paged_decode(const void* q, const void* kp, const void* vp,
                               void* o, const int* table, const int* lengths,
                               int B, int MB, int BL, int H, int KV,
                               float scale, cudaStream_t stream) {
  const int smem = decode_smem_bytes<HD>() + MB * 4;
  auto kern = flash_paged_decode_kernel<HD, TQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(KV, B);
  kern<<<grid, DEC_WARPS * 32, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), static_cast<TQ*>(o), table,
      lengths, MB, BL, H, KV, scale);
  return (int)cudaGetLastError();
}

template <int HD>
static int dispatch_paged_decode(int q_is_f32, const void* q, const void* kp,
                                 const void* vp, void* o, const int* table,
                                 const int* lengths, int B, int MB, int BL,
                                 int H, int KV, float scale,
                                 cudaStream_t stream) {
  if (q_is_f32)
    return launch_paged_decode<HD, float>(q, kp, vp, o, table, lengths, B,
                                          MB, BL, H, KV, scale, stream);
  return launch_paged_decode<HD, __nv_bfloat16>(q, kp, vp, o, table, lengths,
                                                B, MB, BL, H, KV, scale,
                                                stream);
}

}  // namespace repro

// Plain C interface, loaded with ctypes; same return convention as
// repro_flash_decode.  The wrapper guarantees H % KV == 0, H / KV <= 16,
// BL >= 1 and a table row that fits in shared memory; the table's entries
// must lie in [0, NB).
extern "C" int repro_flash_paged_decode(const void* q, const void* kp,
                                        const void* vp, void* o,
                                        const int* table, const int* lengths,
                                        int B, int MB, int BL, int H, int KV,
                                        int hd, float scale, int q_is_f32,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return repro::dispatch_paged_decode<16>(q_is_f32, q, kp, vp, o, table,
                                              lengths, B, MB, BL, H, KV,
                                              scale, st);
    case 64:
      return repro::dispatch_paged_decode<64>(q_is_f32, q, kp, vp, o, table,
                                              lengths, B, MB, BL, H, KV,
                                              scale, st);
    case 128:
      return repro::dispatch_paged_decode<128>(q_is_f32, q, kp, vp, o, table,
                                               lengths, B, MB, BL, H, KV,
                                               scale, st);
    default:
      return -1;
  }
}
