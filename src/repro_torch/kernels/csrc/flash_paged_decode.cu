// Decode attention against the paged tier's block pools, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention_paged_decode
// (_paged_decode_kernel, called at :378).  One query token per table row
// against block pools [NB, BL, KV, hd] read through that row's block
// table [MB]: key position pos of row b lives in pool block
// table[b, pos / BL] at offset pos % BL.  Positions at or past the row's
// length (at most MB x BL) are masked; there is no window (the paged tier
// serves full-attention configurations only).  Block 0 is the
// allocator's null sink: table entries past a row's blocks point there,
// and nothing in it is read.
//
// What bounds it on the H100: bytes, as for flash_decode.cu (the live
// K/V read once, plus the live table entries).
// Design: the split-KV body of flash_decode.cuh, shared with the linear
// kernel so that on the gathered view, at the same split, the two give
// the same bits; only the row address differs.  For each tile warp 0
// reads the table entries that the tile's live rows lie in (those of its
// own split, one per lane, not the whole row), then walks them in order:
// a pool block's base address is computed once per entry, and its live
// rows are bulk-copied from there, so no row pays a division by BL.  Rows
// at or past the length are never read from the pools (the TPU kernel's
// _clean), so no value of block 0 or of a stale block, NaN and inf
// included, can reach the output.  Any block length BL >= 1 works,
// whether or not it divides the 64-row tile.  Offsets are 64-bit: the
// pool's leading axis is blocks, not slots.
#include "flash_decode.cuh"

namespace repro {

// row b's table; position pos of entry e at
// (table[e] * BL + pos - e BL) * stride + head
struct PagedRows {
  const int* table;
  int BL;
  long stride, head;
  template <typename F>
  __device__ __forceinline__ void each(int p0, int p1, int lane, F f) const {
    const int e0 = p0 / BL, e1 = (p1 - 1) / BL;  // once per tile
    for (int eb = e0; eb <= e1; eb += 32) {
      const int mine = eb + lane <= e1 ? __ldg(table + eb + lane) : 0;
      const int ee = min(e1, eb + 31);
      for (int e = eb, start = eb * BL; e <= ee; ++e, start += BL) {
        const int blk = __shfl_sync(0xffffffffu, mine, e - eb);
        const long base = ((long)blk * BL - start) * stride + head;
        const int r1 = min(p1, start + BL);
        for (int pos = max(p0, start) + lane; pos < r1; pos += 32)
          f(pos, base + (long)pos * stride);
      }
    }
  }
};

template <int HD, typename TQ>
__global__ void __launch_bounds__(DEC_WARPS * 32)
    flash_paged_decode_kernel(const TQ* __restrict__ q,
                              const __nv_bfloat16* __restrict__ kp,
                              const __nv_bfloat16* __restrict__ vp,
                              TQ* __restrict__ o,
                              const int* __restrict__ table,
                              const int* __restrict__ lengths,
                              float* __restrict__ part,
                              int* __restrict__ arrived, int MB, int BL,
                              int H, int KV, int split, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int kvh = blockIdx.y, b = blockIdx.z;
  const PagedRows rows{table + (long)b * MB, BL, (long)KV * HD,
                       (long)kvh * HD};
  decode_split<HD>(q, kp, vp, o, lengths, part, arrived, b, kvh, H, KV,
                   MB * BL, 0, split, scale, smem, rows);
}

template <int HD, typename TQ>
static int launch_paged_decode(const void* q, const void* kp, const void* vp,
                               void* o, const int* table, const int* lengths,
                               float* part, int* arrived, int B, int MB,
                               int BL, int H, int KV, int split, float scale,
                               cudaStream_t stream) {
  constexpr int smem = dec_smem_bytes<HD>();
  auto kern = flash_paged_decode_kernel<HD, TQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(max(1, (MB * BL + split - 1) / split), KV, B);
  kern<<<grid, DEC_WARPS * 32, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), static_cast<TQ*>(o), table,
      lengths, part, arrived, MB, BL, H, KV, split, scale);
  return (int)cudaGetLastError();
}

template <int HD>
static int dispatch_paged_decode(int q_is_f32, const void* q, const void* kp,
                                 const void* vp, void* o, const int* table,
                                 const int* lengths, float* part,
                                 int* arrived, int B, int MB, int BL, int H,
                                 int KV, int split, float scale,
                                 cudaStream_t stream) {
  if (q_is_f32)
    return launch_paged_decode<HD, float>(q, kp, vp, o, table, lengths, part,
                                          arrived, B, MB, BL, H, KV, split,
                                          scale, stream);
  return launch_paged_decode<HD, __nv_bfloat16>(q, kp, vp, o, table, lengths,
                                                part, arrived, B, MB, BL, H,
                                                KV, split, scale, stream);
}

}  // namespace repro

// Plain C interface, loaded with ctypes; same return convention as
// repro_flash_decode (-4: a split that is not a positive multiple of 64,
// or more than 64 splits of MB x BL).  The wrapper guarantees H % KV == 0,
// H / KV <= 16 and BL >= 1; the table's entries must lie in [0, NB).
// ``part`` and ``arrived`` as for repro_flash_decode, with MB x BL
// positions in place of S.
extern "C" int repro_flash_paged_decode(const void* q, const void* kp,
                                        const void* vp, void* o,
                                        const int* table, const int* lengths,
                                        float* part, int* arrived, int B,
                                        int MB, int BL, int H, int KV,
                                        int hd, int split, float scale,
                                        int q_is_f32, void* stream) {
  const long positions = (long)MB * BL;
  if (split < repro::BK || split % repro::BK ||
      (positions + split - 1) / split > repro::DEC_MAX_SPLITS)
    return -4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
#define REPRO_HD(HD)                                                         \
  case HD:                                                                   \
    return repro::dispatch_paged_decode<HD>(q_is_f32, q, kp, vp, o, table,   \
                                            lengths, part, arrived, B, MB,   \
                                            BL, H, KV, split, scale, st)
    REPRO_HD(16);
    REPRO_HD(64);
    REPRO_HD(80);
    REPRO_HD(128);
#undef REPRO_HD
    default:
      return -1;
  }
}
