// Flash attention forward for f32 queries (q and o in f32; K/V bf16), on
// the CUDA cores in f32.
//
// Replaces, for that dtype: src/repro/kernels/flash_attention.py:
// flash_attention_fwd, both its pallas_call sites (_fwd_kernel at
// q_offset = None, :146, and the scalar-prefetch _fwd_kernel_off, :191).
// Causal and sliding-window GQA attention, query row i at absolute
// position q_offset + i, online softmax over K/V tiles; writes O and the
// f32 logsumexp.  The main paths send bf16 queries to the wgmma kernel of
// flash_fwd.cu, which stages Q in bf16; a reduced f32 model on the card
// sends f32 ones, which keep this kernel (the port's first forward,
// unchanged) and every product in f32.
//
// What bounds it on the H100: operations, as flash_fwd.cu; this kernel
// does its products in f32 FMAs (no wgmma, no TMA) and sits far below the
// bound, which no main path pays for.
//
// Design: one block of 8 warps per (64-row q tile, head, batch).  The q
// tile is staged once in shared memory as f32, pre-scaled.  K/V tiles of
// 64 rows (2 x 64 x 128 x 2 B = 32 KB of bf16 at hd 128) are staged with
// 16-byte loads into padded rows, so that the score loop is free of bank
// conflicts.  Each warp owns 8 query rows and keeps their running m, l
// and acc in registers.  The key loop starts at the window bound and
// stops at the causal bound of the tile's last valid row: the tiles it
// skips are fully masked, and they contribute exactly 0 in the TPU kernel
// too.  q_offset is read on the device from an int32 tensor (the
// counterpart of scalar prefetch), so the caller never syncs on it; a
// static offset (0 in training) is passed by value, with no tensor.
#include "flash_common.cuh"

namespace repro {
namespace {  // this file's own symbols

constexpr int FWD_WARPS = 8;
constexpr int FWD_ROWS = 8;                   // query rows per warp
constexpr int FWD_BQ = FWD_WARPS * FWD_ROWS;  // 64 query rows per block

template <int HD>
constexpr int fwd_smem_bytes() {
  return FWD_BQ * HD * 4 + 2 * Tile<HD>::WORDS * 4 +
         FWD_WARPS * FWD_ROWS * BK * 4;
}

template <int HD, typename TQ>
__global__ void __launch_bounds__(FWD_WARPS * 32)
    flash_fwd_f32_kernel(const TQ* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         TQ* __restrict__ o, float* __restrict__ lse,
                         const int* __restrict__ q_off_ptr, int q_off_value,
                         int Sq, int Sk, int H, int KV, int causal,
                         int window, float scale) {
  constexpr int PPL = Tile<HD>::PPL;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  uint32_t* k_s = reinterpret_cast<uint32_t*>(q_s + FWD_BQ * HD);
  uint32_t* v_s = k_s + Tile<HD>::WORDS;
  float* p_s = reinterpret_cast<float*>(v_s + Tile<HD>::WORDS);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * FWD_BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q_off = q_off_ptr != nullptr ? *q_off_ptr : q_off_value;

  for (int idx = threadIdx.x; idx < FWD_BQ * HD; idx += blockDim.x) {
    const int r = idx / HD, d = idx % HD, row = q0 + r;
    float x = 0.f;  // padded rows are zero (_clean)
    if (row < Sq) x = to_f(q[((long)(b * Sq + row) * H + h) * HD + d]) * scale;
    q_s[idx] = x;
  }

  const int q_last = min(q0 + FWD_BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + q_off + 1) : Sk;
  int k_begin = window > 0 ? max(0, q0 + q_off - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  float m[FWD_ROWS], l[FWD_ROWS], acc[FWD_ROWS][2 * PPL];
#pragma unroll
  for (int i = 0; i < FWD_ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int t = 0; t < 2 * PPL; ++t) acc[i][t] = 0.f;
  }

  const long row_stride = (long)KV * HD;
  const __nv_bfloat16* kb = k + ((long)b * Sk * KV + kvh) * HD;
  const __nv_bfloat16* vb = v + ((long)b * Sk * KV + kvh) * HD;
  auto in_range = [&](int pos) { return pos < Sk; };
  auto row_of = [&](int i) { return warp * FWD_ROWS + i; };
  auto mask = [&](int i, int kpos) {
    const int row = q0 + warp * FWD_ROWS + i;  // chunk-local: validity
    const int qpos = row + q_off;              // absolute: causal/window
    bool ok = kpos < Sk && row < Sq;
    if (causal) ok = ok && kpos <= qpos;
    if (window > 0) ok = ok && kpos > qpos - window;
    return ok;
  };

  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();  // the previous tile is consumed (and q_s is staged)
    load_kv_tile<HD>(k_s, kb, row_stride, kt, in_range);
    load_kv_tile<HD>(v_s, vb, row_stride, kt, in_range);
    __syncthreads();
    tile_step<HD, FWD_ROWS>(q_s, k_s, v_s, p_s + warp * FWD_ROWS * BK, kt,
                            FWD_ROWS, row_of, mask, m, l, acc);
  }

#pragma unroll
  for (int i = 0; i < FWD_ROWS; ++i) {
    const int row = q0 + warp * FWD_ROWS + i;
    if (row < Sq) {
      const float lc = fmaxf(l[i], 1e-30f);
      store_row<HD>(o + ((long)(b * Sq + row) * H + h) * HD, acc[i], lc);
      if (lane == 0) lse[((long)b * H + h) * Sq + row] = m[i] + logf(lc);
    }
  }
}

template <int HD>
int launch_fwd_f32(const void* q, const void* k, const void* v, void* o,
                   float* lse, const int* q_off, int q_off_value, int B,
                   int Sq, int Sk, int H, int KV, int causal, int window,
                   float scale, cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<HD>();
  auto kern = flash_fwd_f32_kernel<HD, float>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + FWD_BQ - 1) / FWD_BQ, H, B);
  kern<<<grid, FWD_WARPS * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<float*>(o), lse,
      q_off, q_off_value, Sq, Sk, H, KV, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro

// Plain C interface, loaded with ctypes; q and o f32, k and v bf16 (bf16
// queries: flash_fwd.cu).  Returns a cudaError_t code, or -1 for a head
// dimension without a template instance.  The launch is asynchronous on
// ``stream``; nothing here synchronises or allocates.  ``q_off`` is a
// device int32 read by the kernel, or null: then the offset is
// ``q_off_value``, passed by value (no host-to-device copy).
extern "C" int repro_flash_fwd_f32(const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   const int* q_off, int q_off_value, int B,
                                   int Sq, int Sk, int H, int KV, int hd,
                                   int causal, int window, float scale,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return repro::launch_fwd_f32<16>(q, k, v, o, lse, q_off, q_off_value,
                                       B, Sq, Sk, H, KV, causal, window,
                                       scale, st);
    case 64:
      return repro::launch_fwd_f32<64>(q, k, v, o, lse, q_off, q_off_value,
                                       B, Sq, Sk, H, KV, causal, window,
                                       scale, st);
    case 80:
      return repro::launch_fwd_f32<80>(q, k, v, o, lse, q_off, q_off_value,
                                       B, Sq, Sk, H, KV, causal, window,
                                       scale, st);
    case 120:
      return repro::launch_fwd_f32<120>(q, k, v, o, lse, q_off,
                                        q_off_value, B, Sq, Sk, H, KV,
                                        causal, window, scale, st);
    case 128:
      return repro::launch_fwd_f32<128>(q, k, v, o, lse, q_off, q_off_value,
                                        B, Sq, Sk, H, KV, causal, window,
                                        scale, st);
    default:
      return -1;
  }
}
