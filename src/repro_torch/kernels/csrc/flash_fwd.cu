// Flash attention forward with a query offset for Hopper (sm_90a), every
// product on the tensor cores through wgmma.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention_fwd, both
// its pallas_call sites (_fwd_kernel at q_offset = None, :146, and the
// scalar-prefetch _fwd_kernel_off used by chunked prefill, :191); the
// body of both is _fwd_tile (:42-91).  Causal and sliding-window GQA
// attention, query row i at absolute position q_offset + i, online
// softmax over K/V tiles; writes O (bf16) and the f32 logsumexp
// lse = m + log(max(l, 1e-30)).  q is bf16 here; f32 queries go to
// flash_fwd_f32.cu.
//
// What bounds it on the H100: ~4 hd FLOPs per (row, visible key) against
// 2 hd 2 bytes of K/V per key, shared by the g query heads and the 64 rows
// of a tile: operations at the training shape (q [4,1024,12,128]) and at
// the prefill chunk (q [1,256,12,128] against a 2048-slot cache).  The
// bound is the bf16 tensor-core rate, which only wgmma reaches.
//
// Design.  One warpgroup (128 threads) per block of 64 query rows of one
// head: 64, not 128, because the prefill chunk gives only 48 blocks of 64
// rows for 132 SMs (24 of 128), and because a 64-row block at hd 128
// takes 81 KB of shared memory, so two blocks share an SM and one block's
// softmax overlaps the other's products, as two consumer warpgroups of a
// 128-row block would.  Tiles are 64 rows x hd bf16, each 64-column half
// in 128-byte rows swizzled in 1024 B atoms (hd 80 takes two halves, hd
// 16 one, zero past the head dim), written by TMA: one thread issues a
// bulk tensor copy per half-tile (rows and columns past the arrays
// zero-filled, the TPU's _clean) and the block waits on an mbarrier.  Q
// is loaded once; K/V tiles of 64 keys are double-buffered so the copies
// of tile i + 1 overlap the products of tile i.  TMA, not the backward's
// 16-byte cp.async by every thread (flash_bwd.cu::stage): staged that
// way, this kernel's time followed the number of those instructions
// (PERF.md).  S = Q K^T is m64n64k16 with both operands K-major in shared
// memory (hd / 16 steps); O += P V takes P from registers in the
// accumulator-fragment layout rounded to bf16, V read MN-major with the
// transpose bit (m64n<hd>k16, 4 k-steps a tile).  P enters as two
// operands hi = bf16(P) and lo = bf16(P - hi) (to_operands), as in the
// backward: rounded once to bf16, P moved O by up to 7.81e-3 on the
// card, over half of the 1e-2 band (PERF.md).  The Pallas kernel
// scales q in f32 before an f32 dot; here the bf16 products are exact in
// the f32 accumulator and the sum is scaled once, by scale log2 e (the
// softmax runs in exp2): one f32 rounding of each score where the
// reference had one of each q element, ~1e-7 relative of the score, far
// inside the 1e-3 lse band.  A row's 64 scores of a tile are spread over
// the 4 lanes of a quad (wgmma.cuh), so the row max takes two shfl_xor
// steps; l is summed per lane and over the quad once at the end.  The
// mask (causal, window, array ends, the finite sentinel NEG_INF, as
// flash_common.cuh) is evaluated only on tiles that cross the diagonal,
// the window edge or an array end.  The key loop starts at the window
// start and stops at the causal end of the tile's last row; causal grids
// launch the tiles with the most keys first.  q_offset is a device int32
// read by the kernel or a value, so no caller syncs.
// No key split: the prefill chunk leaves SMs idle (48 blocks), but
// splitting each q tile's key range over blocks, with f32 partials
// combined in a fixed order, measured no gain there (PERF.md).
#include "flash_tiles.cuh"
#include "tma.cuh"

namespace repro {

constexpr float LN2 = 0.6931471805599453f;
constexpr int HALF = 64;                   // columns of a half-tile: 128 B rows
constexpr int HALF_BYTES = BT * HALF * 2;  // 8 KB, eight 1024 B swizzle atoms
static_assert(HALF == TMA_BOX && BT == TMA_BOX, "a half-tile is one box");

template <int HD>
__host__ __device__ constexpr int tile_bytes() {
  return (HD + HALF - 1) / HALF * HALF_BYTES;
}
template <int HD>
constexpr int fwd_smem_bytes() {
  return 5 * tile_bytes<HD>() + 1024;  // Q, K and V twice; 1 KB to align
}

// Descriptor of a tile in the 128-byte swizzle (layout type 1): rows of
// 128 B whose 16-byte chunks are XOR-permuted by the row within each
// 1024 B atom of 8 rows, as TMA writes them.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// K-major (the tile's columns are K), k-step kk of 16 columns: in
// half-tile kk / 4, 32 B on along its rows; 8-row atoms 1024 B apart
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc_sw128(tile + (kk >> 2) * HALF_BYTES + (kk & 3) * 32, 16, 1024);
}
// MN-major (the tile's rows are K), k-step kk of 16 rows: two atoms on;
// the 64-column halves (LBO) HALF_BYTES apart, atoms (SBO) 1024 B apart
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * 2048, HALF_BYTES, 1024);
}

// rows [r0, r0 + 64) of one head as a tile: one box per half-tile
template <int HD>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         int head, int r0, int b,
                                         uint64_t* bar) {
#pragma unroll
  for (int j = 0; j < tile_bytes<HD>() / HALF_BYTES; ++j)
    tma_box(dst + j * HALF_BYTES, map, j * HALF, head, r0, b, bar);
}

template <int HD>
__global__ void __launch_bounds__(WG_THREADS)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     const int* __restrict__ q_off_ptr, int q_off_value,
                     int B, int Sq, int Sk, int H, int KV, int causal,
                     int window, float scale) {
  constexpr int TB = tile_bytes<HD>();
  extern __shared__ __align__(1024) unsigned char smem[];
  // Q, K[2], V[2], each TB bytes, from the first 1024 B boundary
  const uint32_t q_s = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t k_s = q_s + TB, v_s = k_s + 2 * TB;
  __shared__ __align__(8) uint64_t bar[3];  // Q, then K/V buffers 0 and 1

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_qt = (Sq + BT - 1) / BT;
  const int per = H * B;
  const int qt = causal ? n_qt - 1 - blockIdx.x / per : blockIdx.x / per;
  const int h = (blockIdx.x % per) % H, b = (blockIdx.x % per) / H;
  const int q0 = qt * BT, kvh = h / (H / KV);
  const int q_off = q_off_ptr != nullptr ? *q_off_ptr : q_off_value;
  const long qstride = (long)H * HD, qhead = ((long)b * Sq * H + h) * HD;

  // the key tiles from the window start to the causal end
  const int q_last = min(q0 + BT, Sq) - 1;
  const int kt1 = causal ? min(Sk, q_last + q_off + 1) : Sk;
  const int kt0 = (window > 0 ? max(0, q0 + q_off - window + 1) : 0) / BT * BT;

  // one thread issues every copy: Q, and the first K/V tile
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&bar[0], TB);
    tma_tile<HD>(q_s, &tm_q, h, q0, b, &bar[0]);
    if (kt0 < kt1) {
      mbar_expect(&bar[1], 2 * TB);
      tma_tile<HD>(k_s, &tm_k, kvh, kt0, b, &bar[1]);
      tma_tile<HD>(v_s, &tm_v, kvh, kt0, b, &bar[1]);
    }
  }
  __syncthreads();  // the barriers are initialised

  // this thread's accumulator rows: ra and ra + 8; columns cq, cq + 1 of
  // each group of 8
  const int ra = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
  const float sl2 = scale * LOG2E;
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // m in log2 units
  mbar_wait(&bar[0], 0);

  int buf = 0;
  uint32_t phase[2] = {0, 0};
  for (int kt = kt0; kt < kt1; kt += BT, buf ^= 1) {
    __syncthreads();  // the products of the previous tile are done
    if (tid == 0 && kt + BT < kt1) {
      mbar_expect(&bar[2 - buf], 2 * TB);
      tma_tile<HD>(k_s + (buf ^ 1) * TB, &tm_k, kvh, kt + BT, b, &bar[2 - buf]);
      tma_tile<HD>(v_s + (buf ^ 1) * TB, &tm_v, kvh, kt + BT, b, &bar[2 - buf]);
    }
    mbar_wait(&bar[1 + buf], phase[buf]);
    phase[buf] ^= 1;
    const uint32_t kb = k_s + buf * TB, vb = v_s + buf * TB;

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wg::fence_regs(s);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wg::ss_n64(s, desc_k(q_s, kk), desc_k(kb, kk), kk > 0);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(s);

    const bool edge = (causal && kt + BT - 1 > q0 + q_off) ||
                      (window > 0 && kt < q0 + q_off + BT - window) ||
                      kt + BT > Sk || q0 + BT > Sq;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hi = (i >> 1) & 1;
      float x = s[i] * sl2;
      if (edge) {
        const int row = q0 + ra + 8 * hi;  // chunk-local: validity
        const int qpos = row + q_off;      // absolute: causal/window
        const int kpos = kt + 8 * (i >> 2) + cq + (i & 1);
        bool ok = kpos < Sk && row < Sq;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        if (!ok) x = NEG_INF;
      }
      s[i] = x;
      mx[hi] = fmaxf(mx[hi], x);
    }
    float corr[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 1));
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 2));
      corr[hi] = exp2f(m[hi] - mx[hi]);  // 0 once a visible key arrives
      m[hi] = mx[hi];
      l[hi] *= corr[hi];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hi = (i >> 1) & 1;
      s[i] = exp2f(s[i] - m[hi]);  // P
      l[hi] += s[i];
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

    uint32_t p_hi[4][4], p_lo[4][4];
    to_operands(s, p_hi, p_lo);
    wg::fence_regs(acc);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wg::rs<HD>(acc, p_hi[kk], desc_mn(vb, kk), 1);
      wg::rs<HD>(acc, p_lo[kk], desc_mn(vb, kk), 1);
    }
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(acc);
    wg::fence_regs(p_hi);
    wg::fence_regs(p_lo);
  }
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 1);
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 2);
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = q0 + ra + 8 * hi;
    if (row >= Sq) continue;
    const float lc = fmaxf(l[hi], 1e-30f);
    __nv_bfloat16* out = o + qhead + (long)row * qstride + cq;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * hi] / lc, acc[4 * j + 2 * hi + 1] / lc);
    if ((lane & 3) == 0)
      lse[((long)b * H + h) * Sq + row] = m[hi] * LN2 + logf(lc);
  }
}

struct FwdArgs {
  const void *q, *k, *v;
  void* o;
  float* lse;
  const int* q_off;
  int q_off_value, B, Sq, Sk, H, KV, causal, window;
  float scale;
  cudaStream_t stream;
};

template <int HD>
static int launch_fwd(const FwdArgs& a) {
  CUtensorMap tq{}, tk{}, tv{};
  constexpr CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  int err = encode_rows(&tq, a.q, a.B, a.Sq, a.H, HD, false, sw);
  if (err == 0 && a.Sk > 0)
    err = encode_rows(&tk, a.k, a.B, a.Sk, a.KV, HD, false, sw);
  if (err == 0 && a.Sk > 0)
    err = encode_rows(&tv, a.v, a.B, a.Sk, a.KV, HD, false, sw);
  if (err != 0) return err;
  constexpr int smem = fwd_smem_bytes<HD>();
  auto kern = flash_fwd_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (a.Sq + BT - 1) / BT * a.H * a.B;
  kern<<<grid, WG_THREADS, smem, a.stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(a.o), a.lse, a.q_off,
      a.q_off_value, a.B, a.Sq, a.Sk, a.H, a.KV, a.causal, a.window,
      a.scale);
  return (int)cudaGetLastError();
}

}  // namespace repro

// Plain C interface, loaded with ctypes; q, k, v, o bf16 (f32 queries:
// flash_fwd_f32.cu).  Returns a cudaError_t code, -1 for a head dimension
// without a template instance, or -2 / -3 when a TMA descriptor cannot be
// made.  The launch is asynchronous on ``stream``; nothing here
// synchronises or allocates.  ``q_off`` is a device int32 read by the
// kernel, or null: then the offset is ``q_off_value``, passed by value (no
// host-to-device copy).
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, float* lse, const int* q_off,
                               int q_off_value, int B, int Sq, int Sk, int H,
                               int KV, int hd, int causal, int window,
                               float scale, void* stream) {
  repro::FwdArgs a{q,  k,  v,  o,  lse, q_off, q_off_value, B, Sq, Sk, H, KV,
                   causal, window, scale, static_cast<cudaStream_t>(stream)};
  switch (hd) {
    case 16:
      return repro::launch_fwd<16>(a);
    case 64:
      return repro::launch_fwd<64>(a);
    case 80:
      return repro::launch_fwd<80>(a);
    case 128:
      return repro::launch_fwd<128>(a);
    default:
      return -1;
  }
}

extern "C" const char* repro_cuda_error_string(int code) {
  if (code == -1) return "head dimension has no kernel instance";
  if (code == -2) return "no cuTensorMapEncodeTiled in the driver";
  if (code == -3) return "cuTensorMapEncodeTiled refused the array";
  if (code == -4)
    return "decode split not a positive multiple of 64, or over 64 splits";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
