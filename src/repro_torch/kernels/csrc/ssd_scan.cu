// Mamba2 SSD chunk scan for Hopper (sm_90a): chunk-parallel, every product
// on the tensor cores through wgmma, tiles brought in by TMA.
//
// Replaces: src/repro/kernels/ssd.py:ssd_chunk_scan (_ssd_kernel, :73).
// For each (batch b, head h), over chunks of Q rows, with cum the in-chunk
// prefix sum of a_log, clip to [-60, 0] and S the [P, N] f32 state (zero
// at the first chunk):
//   y_q   = sum_{t<=q} (C_q.B_t) exp(clip(cum_q - cum_t)) x_t
//         + exp(clip(cum_q)) (C_q . S^T)
//   S_new = exp(clip(cum_{Q-1})) S
//         + sum_t exp(clip(cum_{Q-1} - cum_t)) x_t (x) B_t
// f32 in and out; y is written, the final state is not (as on the TPU).
//
// What bounds it on the H100: bytes.  At the training shape (xh
// [2,1024,80,64], N 64, chunk 256) xh, a_log, B and C are read once and y
// written once: 85.6 MB, 0.0255 ms at 3.35 TB/s, against 8.07 GFLOP
// (chip_smoke.ssd_work), 0.0082 ms at the bf16 tensor-core rate.
//
// Design.  The TPU kernel carries S on a sequential grid axis; the port's
// first kernel did the same with one block per (b, h), 160 blocks for 132
// SMs, every product an f32 FMA on the CUDA cores (0.887 ms, PERF.md).
// Here the work is cut where it does not depend on the carried state, in
// three launches on the stream:
// - ssd_state_kernel, one block per (b, chunk, pair of heads), those with
//   products first: cum for the chunk (a block-wide scan of a_log, written
//   to ``cum`` [B, H, S]) and, for every chunk but the last, the chunk's
//   local end state S_local = (tail o x)^T B, tail_t = exp(clip(cum_{Q-1}
//   - cum_t)), into slot c of ``s_local`` [B, nc - 1, H, P, N].  The key
//   tiles' boxes come two stages deep.
// - ssd_carry_kernel, one thread per 4 elements of a (b, h) state: slot c
//   becomes S_prev of chunk c + 1 = d_c S_prev(c) + S_local(c), in chunk
//   order, d_c = exp(clip(cum_{Q-1})) of chunk c: the carried decay is the
//   product of the per-chunk clipped decays, as the reference composes it
//   (never exp(clip(sum of cum))).  Forming S_prev in each output block
//   from all earlier chunks' S_local read them from L2 once per query tile
//   (61 MB at the training shape) and cost ~15% of the output kernel.
// - ssd_output_kernel, one block per (64-row query tile, b, chunk, pair
//   of heads), the tiles with the most key tiles first: 1280 blocks at the
//   training shape, two an SM.  The inter-chunk term from S_prev, then the
//   key tiles 0 .. qt through a ring of two stages, so the copies of tile
//   kt + 1 run while tile kt is multiplied; each stage's f32 boxes are
//   converted in place into their hi/lo operand tiles (the same 16 KB a
//   box), which is what lets two stages and C fit twice an SM.
// No float atomics: two calls give the same bits.
// - C.B^T once per (query tile, key tile) for both heads of the block: B
//   and C are one group shared by the heads.  Each head's decay L =
//   exp(clip(cum_q - cum_t)) is applied to the score fragment in
//   registers, formed as the exponential of a difference (exp(cum_q)
//   exp(-cum_t) overflows within a chunk at the model's a_log, ~ -0.8 a
//   step), and exactly 0 above the diagonal and past the chunk's end.
// - The four products on wgmma (m64n64k16, one warpgroup a block): C.B^T
//   and C.S_prev^T with both operands K-major in shared memory;
//   (C.B^T o L).x and (tail o x)^T.B with the first operand from registers
//   (the accumulator-fragment layout) and x or B MN-major.  Tiles are
//   wgmma's no-swizzle layout (wgmma.cuh); one copy of the B tile is
//   K-major for C.B^T and MN-major for the state.
// - Precision.  The inputs are f32 and the band is 2e-4 x max(1, max|y|);
//   one bf16 rounding of an operand (2^-9 relative) would not hold it.
//   Every operand X enters as hi = bf16(X) and lo = bf16(X - hi), and a
//   product as hi.hi + hi.lo + lo.hi (lo.lo, ~2^-16 relative, dropped):
//   each product keeps ~2^-16 of its terms, about 1.5e-5, summed in the
//   f32 accumulator.  Four products deep (C.B^T, then its W = C.B^T o L
//   with x; S_local, then C.S_prev^T), the chain stays near 1e-4 of
//   sum |terms| at worst, inside the band; tests/test_torch_ssd.py holds
//   the same arithmetic, emulated (ref.ssd_chunk_scan_split_ref), to
//   repro's Pallas kernel and to the sequential recurrence, and the card
//   measured 2.4e-5 of max|y| at worst (PERF.md).  3 x bf16 and not
//   3 x TF32: TF32 wgmma reads both operands K-major only (x is MN-major
//   in (W).x) and runs at half the bf16 rate.
// - TMA: a 64 x 64 f32 box of x (per head), B and C is one bulk tensor copy
//   onto an mbarrier (tma.cuh), zeros past the arrays' ends; the state
//   kernel keeps two stages of boxes too.
// - Uniform products: every k-loop runs 4 steps (columns past N are zeros)
//   and both heads' products run even where H leaves one head (its
//   accumulator is never stored): products under a runtime condition made
//   ptxas inject warpgroup arrives.
// What still bounds it (PERF.md): with no arithmetic at all the output
// kernel's copies and stores take about half its time (each x tile is read
// by every query tile at or past it, ~2.5 times at the training shape, and
// y written once), and xh is read once more by the state pass; the rest is
// the per-tile chain of conversion, C.B^T, decays and W x, with 8 warps an
// SM to hide it (registers: 213 output, 176 state).
// Scratch, allocated by the wrapper: s_local B (nc - 1) H P N f32 (7.9 MB
// at the training shape) and cum B H S f32 (0.66 MB).  Shared memory:
// 96 KB (state) and 112 KB (output) a block.
#include "flash_tiles.cuh"
#include "tma.cuh"

namespace repro {
namespace ssd {

constexpr int T = 64;         // rows (positions) and columns (P, N) of a tile
constexpr int HG = 2;         // heads of a block
constexpr int THREADS = 128;  // one warpgroup
constexpr int BOX_F32 = T * T;  // floats of an f32 box
constexpr int OPS = T * T;      // bf16 elements of an operand tile
constexpr int SLOTS = T * T / 8 / THREADS;  // 8-column groups a thread converts
static_assert(T == TMA_BOX, "a tile is one box");

__host__ __device__ constexpr int state_smem_bytes() {
  return 2 * (1 + HG) * BOX_F32 * 4 + 128;
}
__host__ __device__ constexpr int output_smem_bytes() {
  return (1 + 2 * (1 + HG)) * BOX_F32 * 4 + 128;
}

// exp(clip(x)) as 2^(x log2 e) on the special-function unit: relative
// error ~2.6e-6 at the clip's -60 (the rounding of x log2 e), ~1e-7 near
// 0, against the band's 2e-4; expf's range reduction cost ~15% of the
// output kernel's time (PERF.md).
__device__ __forceinline__ float clip_exp(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;"
      : "=f"(r)
      : "f"(fminf(fmaxf(x, -60.f), 0.f) * LOG2E));
  return r;
}

// wgmma descriptors of a no-swizzle operand tile of 64 columns for k-step
// kk: K-major (the columns are K) and MN-major (the rows are K), as in
// flash_bwd.cu.
__device__ __forceinline__ uint64_t desc_k(const __nv_bfloat16* t, int kk) {
  return wg::make_desc(t + kk * 128, 128, 16 * T);
}
__device__ __forceinline__ uint64_t desc_mn(const __nv_bfloat16* t, int kk) {
  return wg::make_desc(t + kk * 16 * T, 16 * T, 128);
}

__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Eight f32 values as their hi and lo bf16 halves, 16 bytes each.
__device__ __forceinline__ void split8(const float (&v)[8], uint4& hi,
                                       uint4& lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    h[k] = pack_bf16(v[2 * k], v[2 * k + 1]);
    const float2 hf = bf2_to_f2(h[k]);
    l[k] = pack_bf16(v[2 * k] - hf.x, v[2 * k + 1] - hf.y);
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// The (row, 8-column group) that slot k of this thread converts: the
// eight threads of a quarter-warp take eight rows of one core-matrix
// row-group, their column groups rotated by the row, so the 16-byte stores
// fill whole core matrices and the f32 reads spread over the banks.
__device__ __forceinline__ void slot(int k, int& r, int& c8) {
  const int idx = threadIdx.x + k * THREADS;
  const int j = idx & 7, g = idx >> 3;
  r = (g >> 3) * 8 + j;
  c8 = (((g & 7) + j) & 7) * 8;
}

// The f32 box at ``box`` becomes, in place, its hi operand tile (the
// first OPS bf16) and its lo tile (the next OPS): the same 16 KB.  Rows at
// or past ``live`` become zeros.  Every thread reads its slots before any
// thread writes.
__device__ __forceinline__ void split_in_place(float* box, int live) {
  float v[SLOTS][8];
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    int r, c8;
    slot(k, r, c8);
    const float4 a = r < live
                         ? *reinterpret_cast<const float4*>(box + r * T + c8)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 b = r < live ? *reinterpret_cast<const float4*>(
                                    box + r * T + c8 + 4)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    v[k][0] = a.x, v[k][1] = a.y, v[k][2] = a.z, v[k][3] = a.w;
    v[k][4] = b.x, v[k][5] = b.y, v[k][6] = b.z, v[k][7] = b.w;
  }
  __syncthreads();
  __nv_bfloat16* hi = reinterpret_cast<__nv_bfloat16*>(box);
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    int r, c8;
    slot(k, r, c8);
    uint4 h, l;
    split8(v[k], h, l);
    *reinterpret_cast<uint4*>(hi + wg::tile_off<T>(r, c8)) = h;
    *reinterpret_cast<uint4*>(hi + OPS + wg::tile_off<T>(r, c8)) = l;
  }
}

// The inclusive prefix sum of src[i * stride], i < n, into dst[i], by the
// block: each thread sums a run of consecutive values, the runs' sums are
// scanned across the warps, then each thread writes its run.
__device__ void block_scan(const float* __restrict__ src, long stride,
                           float* dst, int n, float* part) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + THREADS - 1) / THREADS;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) run += __ldg(src + i * stride);
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  float acc = incl - run;
  for (int w = 0; w < warp; ++w) acc += part[w];
  for (int i = lo; i < hi; ++i) {
    acc += __ldg(src + i * stride);
    dst[i] = acc;
  }
  __syncthreads();  // part is free again
}

// Block (b, chunk, pair of heads), the blocks with products first: cum of
// the chunk, then (all chunks but the last) S_local of each head, summed
// over the chunk's key tiles, two stages of boxes deep; the B box becomes
// its operand tiles in place.
__global__ void __launch_bounds__(THREADS)
    ssd_state_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_b,
                     const float* __restrict__ a_log, float* cum,
                     float* __restrict__ s_local, int B, int S, int H, int P,
                     int N, int Q) {
  extern __shared__ unsigned char smem_raw[];
  float* box = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  // two stages of boxes: B, then x of each head
  constexpr int STAGE = (1 + HG) * BOX_F32;
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ float part[THREADS / 32];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nc = S / Q, ng = (H + HG - 1) / HG;
  const int with = B * (nc - 1) * ng;  // blocks with products
  const bool states = (int)blockIdx.x < with;
  int rest = states ? blockIdx.x : blockIdx.x - with;
  const int grp = rest % ng;
  rest /= ng;
  const int c = states ? rest % (nc - 1) : nc - 1;
  const int b = states ? rest / (nc - 1) : rest;
  const int h0 = grp * HG, nh = min(HG, H - h0), pos0 = c * Q;
  const int nkt = (Q + T - 1) / T;

  // the boxes of key tile kt into stage kt % 2
  auto load_tile = [&](int kt) {
    float* st = box + (kt & 1) * STAGE;
    uint64_t* br = &bar[kt & 1];
    mbar_expect(br, (1 + nh) * BOX_F32 * 4);
    tma_box(smem_u32(st), &tm_b, 0, 0, pos0 + kt * T, b, br);
    for (int g = 0; g < nh; ++g)
      tma_box(smem_u32(st + (1 + g) * BOX_F32), &tm_x, 0, h0 + g,
              pos0 + kt * T, b, br);
  };
  if (tid == 0 && states) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load_tile(0);
    if (nkt > 1) load_tile(1);
  }
  for (int g = 0; g < nh; ++g)
    block_scan(a_log + ((long)b * S + pos0) * H + h0 + g, H,
               cum + ((long)b * H + h0 + g) * S + pos0, Q, part);
  if (!states) return;

  float last[HG];
#pragma unroll
  for (int g = 0; g < HG; ++g)
    last[g] = g < nh ? cum[((long)b * H + h0 + g) * S + pos0 + Q - 1] : 0.f;
  float acc[HG][32];
#pragma unroll
  for (int g = 0; g < HG; ++g)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[g][i] = 0.f;
  const int prow = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);

  for (int kt = 0; kt < nkt; ++kt) {
    const int t0 = kt * T, tv = min(T, Q - t0);
    float* st = box + (kt & 1) * STAGE;
    // cum of this thread's 16 key columns, per head, while the tile lands
    float ck[HG][16];
#pragma unroll
    for (int g = 0; g < HG; ++g)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = 8 * j + cq + e;
          ck[g][2 * j + e] =
              g < nh && t < tv
                  ? cum[((long)b * H + h0 + g) * S + pos0 + t0 + t]
                  : 0.f;
        }
    mbar_wait(&bar[kt & 1], (kt >> 1) & 1);
    split_in_place(st, tv);
    const __nv_bfloat16* b_hi = reinterpret_cast<const __nv_bfloat16*>(st);
    const __nv_bfloat16* b_lo = b_hi + OPS;
    // A = (tail o x)^T [p][t] from the x boxes, in the fragment layout
    uint32_t a_hi[HG][4][4], a_lo[HG][4][4];
#pragma unroll
    for (int g = 0; g < HG; ++g) {
      const float* xs = st + (1 + g) * BOX_F32;
      float f[32];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = prow + 8 * (e >> 1), t = 8 * j + cq + (e & 1);
          const float tail =
              t < tv ? clip_exp(last[g] - ck[g][2 * j + (e & 1)]) : 0.f;
          f[4 * j + e] = tail * xs[t * T + p];
        }
      to_operands(f, a_hi[g], a_lo[g]);
    }
    proxy_fence();
    __syncthreads();  // the B operand tiles are written
#pragma unroll
    for (int g = 0; g < HG; ++g) wg::fence_regs(acc[g]);
    wg::fence();
#pragma unroll
    for (int g = 0; g < HG; ++g) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wg::rs_n64(acc[g], a_hi[g][kk], desc_mn(b_hi, kk), 1);
        wg::rs_n64(acc[g], a_hi[g][kk], desc_mn(b_lo, kk), 1);
        wg::rs_n64(acc[g], a_lo[g][kk], desc_mn(b_hi, kk), 1);
      }
    }
    wg::commit();
    wg::wait<0>();
#pragma unroll
    for (int g = 0; g < HG; ++g) {
      wg::fence_regs(acc[g]);
      wg::fence_regs(a_hi[g]);
      wg::fence_regs(a_lo[g]);
    }
    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && kt + 2 < nkt) load_tile(kt + 2);
  }

  // acc[g]: rows p, columns n of the accumulator fragment
#pragma unroll
  for (int g = 0; g < HG; ++g) {
    if (g >= nh) continue;
    float* dst = s_local + (((long)b * (nc - 1) + c) * H + h0 + g) * P * N;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int p = prow + 8 * hi;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = 8 * j + cq;
        if (n < N)
          *reinterpret_cast<float2*>(dst + p * N + n) =
              make_float2(acc[g][4 * j + 2 * hi], acc[g][4 * j + 2 * hi + 1]);
      }
    }
  }
}

// The carry, in place: slot c of ``s_local`` holds S_local of chunk c and
// becomes S_prev of chunk c + 1 = d_c S_prev(c) + S_local(c), in chunk
// order, d_c = exp(clip(cum at chunk c's last row)): the carried decay is
// the product of the per-chunk clipped decays.  One thread per 4
// consecutive elements of one (b, h) state.
constexpr int CARRY_THREADS = 256;
__global__ void __launch_bounds__(CARRY_THREADS)
    ssd_carry_kernel(const float* __restrict__ cum, float* s_local, int B,
                     int S, int H, int PN, int Q) {
  const int per = PN / 4;
  const long i = (long)blockIdx.x * CARRY_THREADS + threadIdx.x;
  if (i >= (long)B * H * per) return;
  const int e = i % per, h = (i / per) % H, b = i / per / H;
  const int nc = S / Q;
  const float* last = cum + ((long)b * H + h) * S + Q - 1;
  float4* slot =
      reinterpret_cast<float4*>(s_local + ((long)b * (nc - 1) * H + h) * PN) +
      e;
  const long stride = (long)H * per;  // float4s from one chunk's slot on
  float4 st = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c + 1 < nc; ++c) {
    const float d = clip_exp(last[c * Q]);
    const float4 l = slot[c * stride];
    st = make_float4(fmaf(d, st.x, l.x), fmaf(d, st.y, l.y),
                     fmaf(d, st.z, l.z), fmaf(d, st.w, l.w));
    slot[c * stride] = st;
  }
}

// S_prev of each of the block's nh heads (``s_prev``: head h0's, heads
// ``head_stride`` apart), as hi/lo operand tiles [p][n] (K-major for
// C.S_prev^T; head g's at ops + 2 g OPS), zero outside P x N; every load
// in flight at once.
__device__ __forceinline__ void prev_states(const float* __restrict__ s_prev,
                                            long head_stride, int nh, int P,
                                            int N, __nv_bfloat16* ops) {
  float4 l4[HG][SLOTS][2];
#pragma unroll
  for (int g = 0; g < HG; ++g)
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      int r, c8;
      slot(k, r, c8);
      const float* src = s_prev + g * head_stride + r * N + c8;
#pragma unroll
      for (int half = 0; half < 2; ++half)
        l4[g][k][half] =
            g < nh && r < P && c8 + 4 * half < N
                ? __ldg(reinterpret_cast<const float4*>(src + 4 * half))
                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
  for (int g = 0; g < HG; ++g) {
    if (g >= nh) continue;
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      int r, c8;
      slot(k, r, c8);
      const float4 a = l4[g][k][0], b = l4[g][k][1];
      const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      uint4 h, l;
      split8(v, h, l);
      __nv_bfloat16* hi = ops + 2 * g * OPS;
      *reinterpret_cast<uint4*>(hi + wg::tile_off<T>(r, c8)) = h;
      *reinterpret_cast<uint4*>(hi + OPS + wg::tile_off<T>(r, c8)) = l;
    }
  }
}

// Block (64-row query tile, b, chunk, pair of heads): y of those rows.
// Shared memory: C's box, then a ring of two stages, each the boxes of one
// key tile (B, x of each head); every box is converted in place to its
// hi/lo operand tiles, so the copies of key tile kt + 1 run while tile kt
// is multiplied.
__global__ void __launch_bounds__(THREADS, 2)
    ssd_output_kernel(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_b,
                      const __grid_constant__ CUtensorMap tm_c,
                      const float* __restrict__ cum,
                      const float* __restrict__ s_local, float* __restrict__ y,
                      int B, int S, int H, int P, int N, int Q) {
  extern __shared__ unsigned char smem_raw[];
  float* c_box = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  constexpr int STAGE = (1 + HG) * BOX_F32;
  float* stage = c_box + BOX_F32;  // stage s at s STAGE
  const __nv_bfloat16* c_hi = reinterpret_cast<const __nv_bfloat16*>(c_box);
  const __nv_bfloat16* c_lo = c_hi + OPS;
  __shared__ __align__(8) uint64_t bar[3];  // C, stages 0 and 1

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nc = S / Q, ng = (H + HG - 1) / HG, nqt = (Q + T - 1) / T;
  const int per = B * nc * ng;
  const int qt = nqt - 1 - blockIdx.x / per, rest = blockIdx.x % per;
  const int grp = rest % ng, c = (rest / ng) % nc, b = rest / ng / nc;
  const int h0 = grp * HG, nh = min(HG, H - h0), pos0 = c * Q;
  const int q0 = qt * T, qv = min(T, Q - q0);
  const long row_y = (long)H * P;

  // the boxes of key tile kt into stage kt % 2
  auto load_tile = [&](int kt) {
    float* st = stage + (kt & 1) * STAGE;
    uint64_t* br = &bar[1 + (kt & 1)];
    mbar_expect(br, (1 + nh) * BOX_F32 * 4);
    tma_box(smem_u32(st), &tm_b, 0, 0, pos0 + kt * T, b, br);
    for (int g = 0; g < nh; ++g)
      tma_box(smem_u32(st + (1 + g) * BOX_F32), &tm_x, 0, h0 + g,
              pos0 + kt * T, b, br);
  };
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&bar[0], BOX_F32 * 4);
    tma_box(smem_u32(c_box), &tm_c, 0, 0, pos0 + q0, b, &bar[0]);
    load_tile(0);
    if (c == 0 && qt > 0) load_tile(1);  // else stage 1 holds S_prev first
  }

  const int prow = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
  // cum of this thread's two rows (prow, prow + 8), per head
  float cr[HG][2];
#pragma unroll
  for (int g = 0; g < HG; ++g)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = prow + 8 * hi;
      cr[g][hi] = g < nh && r < qv
                      ? cum[((long)b * H + h0 + g) * S + pos0 + q0 + r]
                      : 0.f;
    }
  // S_prev of each head (slot c - 1 after the carry) as operand tiles in
  // stage 1, while C and key tile 0 load
  __nv_bfloat16* s_ops = reinterpret_cast<__nv_bfloat16*>(stage + STAGE);
  if (c > 0)
    prev_states(s_local + (((long)b * (nc - 1) + c - 1) * H + h0) * P * N,
                (long)P * N, nh, P, N, s_ops);
  __syncthreads();  // the barriers are initialised
  mbar_wait(&bar[0], 0);
  split_in_place(c_box, qv);
  proxy_fence();
  __syncthreads();  // C and S_prev are in their operand tiles

  float acc[HG][32];
#pragma unroll
  for (int g = 0; g < HG; ++g)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[g][i] = 0.f;

  // inter-chunk: y = exp(clip(cum_q)) C_q . S_prev
  if (c > 0) {
#pragma unroll
    for (int g = 0; g < HG; ++g) wg::fence_regs(acc[g]);
    wg::fence();
#pragma unroll
    for (int g = 0; g < HG; ++g) {
      const __nv_bfloat16* s_hi = s_ops + 2 * g * OPS;
      const __nv_bfloat16* s_lo = s_hi + OPS;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wg::ss_n64(acc[g], desc_k(c_hi, kk), desc_k(s_hi, kk), 1);
        wg::ss_n64(acc[g], desc_k(c_hi, kk), desc_k(s_lo, kk), 1);
        wg::ss_n64(acc[g], desc_k(c_lo, kk), desc_k(s_hi, kk), 1);
      }
    }
    wg::commit();
    wg::wait<0>();
#pragma unroll
    for (int g = 0; g < HG; ++g) {
      wg::fence_regs(acc[g]);
      const float d0 = clip_exp(cr[g][0]), d1 = clip_exp(cr[g][1]);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[g][i] *= (i >> 1) & 1 ? d1 : d0;
    }
    __syncthreads();  // stage 1 is free
    if (tid == 0 && qt > 0) load_tile(1);
  }

  // intra-chunk, key tiles 0 .. qt
  for (int kt = 0; kt <= qt; ++kt) {
    const int t0 = kt * T, tv = min(T, Q - t0);
    float* st = stage + (kt & 1) * STAGE;
    // cum of this thread's 16 key columns, per head, while the tile lands
    float ck[HG][16];
#pragma unroll
    for (int g = 0; g < HG; ++g)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = 8 * j + cq + e;
          ck[g][2 * j + e] =
              g < nh && t < tv
                  ? cum[((long)b * H + h0 + g) * S + pos0 + t0 + t]
                  : 0.f;
        }
    mbar_wait(&bar[1 + (kt & 1)], (kt >> 1) & 1);
    for (int i = 0; i < 1 + nh; ++i) split_in_place(st + i * BOX_F32, tv);
    proxy_fence();
    __syncthreads();  // the tile's operand tiles are written
    const __nv_bfloat16* b_hi = reinterpret_cast<const __nv_bfloat16*>(st);
    const __nv_bfloat16* b_lo = b_hi + OPS;

    // scores C.B^T, once for both heads
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wg::fence_regs(sc);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wg::ss_n64(sc, desc_k(c_hi, kk), desc_k(b_hi, kk), 1);
      wg::ss_n64(sc, desc_k(c_hi, kk), desc_k(b_lo, kk), 1);
      wg::ss_n64(sc, desc_k(c_lo, kk), desc_k(b_hi, kk), 1);
    }
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(sc);

    // per head: W = C.B^T o L as hi/lo register operands, y += W x
    const bool diag = kt == qt;  // t0 == q0: compare tile-local indices
    uint32_t w_hi[HG][4][4], w_lo[HG][4][4];
#pragma unroll
    for (int g = 0; g < HG; ++g) {
      float w[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hi = (i >> 1) & 1;
        const int r = prow + 8 * hi, t = 8 * (i >> 2) + cq + (i & 1);
        float v = sc[i] * clip_exp(cr[g][hi] - ck[g][2 * (i >> 2) + (i & 1)]);
        if (diag && !(t <= r && t < tv && r < qv)) v = 0.f;
        w[i] = v;
      }
      to_operands(w, w_hi[g], w_lo[g]);
      const __nv_bfloat16* xh_ =
          reinterpret_cast<const __nv_bfloat16*>(st + (1 + g) * BOX_F32);
      const __nv_bfloat16* xl_ = xh_ + OPS;
      wg::fence_regs(acc[g]);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wg::rs_n64(acc[g], w_hi[g][kk], desc_mn(xh_, kk), 1);
        wg::rs_n64(acc[g], w_hi[g][kk], desc_mn(xl_, kk), 1);
        wg::rs_n64(acc[g], w_lo[g][kk], desc_mn(xh_, kk), 1);
      }
      wg::commit();  // the next head's W is formed while these run
    }
    wg::wait<0>();
#pragma unroll
    for (int g = 0; g < HG; ++g) {
      wg::fence_regs(acc[g]);
      wg::fence_regs(w_hi[g]);
      wg::fence_regs(w_lo[g]);
    }
    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && kt + 2 <= qt) load_tile(kt + 2);
  }

#pragma unroll
  for (int g = 0; g < HG; ++g) {
    if (g >= nh) continue;
    float* yb = y + ((long)b * S + pos0 + q0) * row_y + (long)(h0 + g) * P;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = prow + 8 * hi;
      if (r >= qv) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = 8 * j + cq;
        if (p < P)
          *reinterpret_cast<float2*>(yb + r * row_y + p) =
              make_float2(acc[g][4 * j + 2 * hi], acc[g][4 * j + 2 * hi + 1]);
      }
    }
  }
}

}  // namespace ssd
}  // namespace repro

// Plain C interface, loaded with ctypes.  Returns a cudaError_t code, or
// -2 / -3 when a TMA descriptor cannot be made.  The caller guarantees
// 1 <= P, N <= 64 with P and N multiples of 4, S % Q == 0, contiguous f32
// inputs with xh, bb and cc 16-byte aligned, and the scratch ``cum``
// [B, H, S] and ``s_local`` [B, S / Q - 1, H, P, N] (kernels/ssd.py pads
// and allocates).  Three launches (two when S == Q), asynchronous on
// ``stream``; nothing here synchronises or allocates.
extern "C" int repro_ssd_chunk_scan(const float* xh, const float* a_log,
                                    const float* bb, const float* cc,
                                    float* y, float* cum, float* s_local,
                                    int B, int S, int H, int P, int N, int Q,
                                    void* stream) {
  using namespace repro;
  using namespace repro::ssd;
  CUtensorMap tx{}, tb{}, tc{};
  constexpr CUtensorMapSwizzle none = CU_TENSOR_MAP_SWIZZLE_NONE;
  int err = encode_rows(&tx, xh, B, S, H, P, true, none);
  if (err == 0) err = encode_rows(&tb, bb, B, S, 1, N, true, none);
  if (err == 0) err = encode_rows(&tc, cc, B, S, 1, N, true, none);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      state_smem_bytes());
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_output_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             output_smem_bytes());
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = S / Q, ng = (H + HG - 1) / HG, nqt = (Q + T - 1) / T;
  ssd_state_kernel<<<B * nc * ng, THREADS, state_smem_bytes(), st>>>(
      tx, tb, a_log, cum, s_local, B, S, H, P, N, Q);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (nc > 1) {
    const long n4 = (long)B * H * P * N / 4;
    ssd_carry_kernel<<<(n4 + CARRY_THREADS - 1) / CARRY_THREADS,
                       CARRY_THREADS, 0, st>>>(cum, s_local, B, S, H, P * N,
                                               Q);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  ssd_output_kernel<<<nqt * B * nc * ng, THREADS, output_smem_bytes(), st>>>(
      tx, tb, tc, cum, s_local, y, B, S, H, P, N, Q);
  return (int)cudaGetLastError();
}
