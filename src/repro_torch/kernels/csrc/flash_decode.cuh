// The split-KV decode body shared by flash_decode.cu (the linear slot
// cache) and flash_paged_decode.cu (block pools read through a table).
//
// What bounds it on the H100: bytes.  Each cached position costs
// 2 x hd x 2 B of K/V and buys 4 x hd x g FLOPs (g = 6 on qwen2-1.5b),
// about 6 FLOPs per byte against the card's ~295 at the bf16 rate, so
// the bound is reading the live K/V once at 3.35 TB/s.  The design is
// about filling 132 SMs, keeping bytes in flight and keeping the
// arithmetic short enough to hide under the copies.
//
// Design.
// - Split the keys.  One block of 4 warps per (split, KV head, row): the
//   split's ``split`` positions (a multiple of the 64-row tile; the host
//   picks it from the position count alone, ``decode_split``, so a row's
//   bits do not depend on the batch it is in).  A block whose split
//   lies wholly outside the row's live range [lo, len) exits at once;
//   split 0 counts as live for an empty row, so that it writes zeros.
// - Bulk copies.  Every K or V row of one (position, KV head) is hd x 2
//   contiguous bytes, a multiple of 16, in the slot cache and in a pool
//   block alike: warp 0 brings each live row of a tile into shared memory
//   with one ``cp.async.bulk`` completing on the stage's mbarrier (one
//   instruction per row, whatever the layout).  Two stages: the copies of
//   tile i + 1 run under the arithmetic of tile i.  Dead rows (outside
//   [lo, len)) are not copied: their scores are NEG_INF by a select, and
//   their V rows are zeroed before the copies (P is 0 there, but 0 x NaN
//   is NaN), so whatever a stage held before (stale rows, NaN bits)
//   cannot reach O.  Staged rows are padded to an odd number of 16-byte
//   units, so ldmatrix's eight rows fall in eight different bank groups.
// - Every warp busy, on the tensor cores.  Warp w takes keys
//   [16 w, 16 w + 16) of each tile and keeps (m, l, O) for the group's g
//   heads, padded to the 16 rows of mma.sync m16n8k16 (g <= 16).  The
//   arithmetic on the CUDA cores (f32 FMAs with a lane per 16-byte chunk
//   and a shuffle reduction per key) took ~10 us of a ~32 us call at row
//   3's shape on the card, not hidden under the copies (PERF.md); on the
//   tensor cores S is hd / 16 products a tile and P V 2 hd / 8.  Q's
//   fragments stay in registers for the whole loop: bf16 queries enter as
//   they are (the products are exact in f32 and the score is scaled once,
//   by scale log2 e, after the sum: one f32 rounding of each score where
//   the TPU kernel had one of each q element), f32 queries as hi = bf16(q)
//   and lo = bf16(q - hi).  P enters as hi + lo too.  K fragments come
//   from ldmatrix, V's from ldmatrix.trans.  The softmax runs in exp2 on
//   the S fragments: a row's 16 keys lie in the 4 lanes of a quad, so its
//   max and sum take two shuffles each.
// - Merge in one launch, in a fixed order.  The warps merge through
//   shared memory (warp order).  A row with one live split writes O
//   directly; otherwise each live split writes f32 partials (the
//   unnormalised O [g, hd], m and l per head), and the last block of the
//   row to arrive (an int counter after __threadfence) merges them in
//   split order, as an online softmax over the splits with every load in
//   flight at once, and resets the counter for the next launch.  The bits
//   depend on the inputs and ``split`` only, not on which block came last.
// - One template for everything that touches a value: the two kernels
//   differ only in where position pos of the row lives (``Rows::each``),
//   so on the gathered view, at the same split, the paged kernel gives
//   the linear kernel's bits.
// Numerics follow the TPU kernels: f32 scores and P V, the finite
// sentinel NEG_INF, l clamped at 1e-30 (an empty row gives exact zeros).
// Head dims are multiples of 8 (a row is whole 16-byte units), not of 16
// nor powers of two: a staged row holds hd rounded up to the 16 columns
// of S's k-steps, and each block zeroes those pad columns once (no copy
// writes them), so the last k-step of S and the last n-tile pair of P V
// read zeros there.  hd 120 is one more instance.
#pragma once

#include "flash_common.cuh"

namespace repro {

constexpr int DEC_WARPS = 4;
constexpr int DEC_KPW = BK / DEC_WARPS;  // keys of a tile per warp: 16
constexpr int DEC_STAGES = 2;            // K/V tiles in flight per block
constexpr int DEC_ROWS = 16;             // the group's heads, padded
constexpr int DEC_MAX_SPLITS = 64;       // splits per row

template <int HD>
struct DecTile {
  static_assert(HD % 8 == 0, "a K or V row is whole 16-byte units");
  static constexpr int HDP = (HD + 15) / 16 * 16;  // staged columns
  static constexpr int ROW = HD * 2;    // bytes of a K or V row (copied)
  static constexpr int PROW = HDP * 2;  // bytes of a staged row's columns
  // staged row stride: an odd number of 16-byte units
  static constexpr int RS = PROW / 16 % 2 ? PROW : PROW + 16;
  static constexpr int TILE = BK * RS;  // bytes of a staged K or V tile
  static constexpr int NK = HDP / 16;   // k-steps of S, n-tile pairs of P V
};

// Shared memory of decode_split: the ring of K/V stages (reused for the
// warps' merge at the end), the stages' mbarriers.
template <int HD>
__host__ __device__ constexpr int dec_ring_bytes() {
  return DEC_STAGES * 2 * DecTile<HD>::TILE;
}
template <int HD>
__host__ __device__ constexpr int dec_smem_bytes() {
  return dec_ring_bytes<HD>() + DEC_STAGES * 8;
}

// Floats of one split's partials: O [g][hd], m [g], l [g], rounded up to
// a multiple of 4 (flash_attention.py allocates the same), so that each
// record's O is 16-byte aligned.
__host__ __device__ constexpr int dec_record(int g, int hd) {
  return (g * (hd + 2) + 3) / 4 * 4;
}

// One bulk copy of ``bytes`` (a multiple of 16) from global ``src`` into
// shared ``dst`` (both 16-byte aligned), completing on ``bar``.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
// d += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), d 16 x 8 f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// hi = bf16(a, b), lo = bf16(a - hi_a, b - hi_b)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// Attend row b's g = H / KV query heads of KV head kvh (g <= 16) to key
// positions [lo, len) of split blockIdx.x (positions [sp split,
// (sp + 1) split)), len = min(lengths[b], cap) and lo = len - window (0
// without a window).  rows.each(p0, p1, lane, f) calls f(pos, off) for
// the positions of [p0, p1) that this lane of warp 0 copies, off being
// the element offset of position pos's row of this KV head in kc (and
// vc).  ``part`` holds gridDim.x records of dec_record(g, hd) floats per
// (row, KV head) and ``arrived`` one int per (row, KV head), zero between
// launches; both are unused (may be null) when gridDim.x is 1.  ``smem``
// holds dec_smem_bytes<HD>() bytes, 128-byte aligned.
template <int HD, typename TQ, typename Rows>
__device__ __forceinline__ void decode_split(
    const TQ* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
    const __nv_bfloat16* __restrict__ vc, TQ* __restrict__ o,
    const int* __restrict__ lengths, float* __restrict__ part,
    int* __restrict__ arrived, int b, int kvh, int H, int KV, int cap,
    int window, int split, float scale, unsigned char* smem,
    const Rows& rows) {
  using L = DecTile<HD>;
  constexpr unsigned FULL = 0xffffffffu;
  constexpr int NQ = sizeof(TQ) == 4 ? 2 : 1;  // Q operands: hi (+ lo)
  static_assert((3 * DEC_WARPS * DEC_ROWS + 2 * DEC_ROWS +
                 DEC_WARPS * DEC_ROWS * HD) * 4 <= dec_ring_bytes<HD>(),
                "the warps' merge fits the ring");
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int g = H / KV;
  const int sp = blockIdx.x;
  const long qb = ((long)b * H + (long)kvh * g) * HD;

  // Q as A fragments (rows: the group's heads, zero past g); their loads
  // do not wait on the length
  uint32_t qa[NQ][L::NK][4];
#pragma unroll
  for (int kk = 0; kk < L::NK; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = gid + 8 * (r & 1), col = 16 * kk + 8 * (r >> 1) + 2 * tig;
      uint32_t hi = 0u, lo = 0u;
      if (row < g && (L::HDP == HD || col < HD)) {
        if constexpr (NQ == 2) {
          const float2 v = __ldg(reinterpret_cast<const float2*>(
              q + qb + (long)row * HD + col));
          split_bf16(v.x, v.y, hi, lo);
        } else {
          hi = __ldg(reinterpret_cast<const unsigned int*>(
              q + qb + (long)row * HD + col));
        }
      }
      qa[0][kk][r] = hi;
      if constexpr (NQ == 2) qa[NQ - 1][kk][r] = lo;
    }
  }

  // the row's live splits; an empty row's split 0 writes its zeros
  const int len = min(__ldg(lengths + b), cap);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int s_lo = lo / split, s_hi = max(len - 1, lo) / split;
  if (sp < s_lo || sp > s_hi) return;
  const int nlive = s_hi - s_lo + 1;
  const int k0 = max(lo, sp * split), k1 = min(len, (sp + 1) * split);
  const int kt0 = k0 / BK * BK;
  const int ntiles = k1 > k0 ? (k1 - kt0 + BK - 1) / BK : 0;

  unsigned char* ring = smem;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + dec_ring_bytes<HD>());

  // tile i into stage i % DEC_STAGES (warp 0): zero the V rows that are
  // not live, then one bulk copy per live K and V row
  auto issue = [&](int i) {
    const int kt = kt0 + i * BK;
    const int p0 = max(kt, k0), p1 = min(kt + BK, k1);
    uint64_t* br = &bar[i % DEC_STAGES];
    unsigned char* kd = ring + (i % DEC_STAGES) * 2 * L::TILE;
    unsigned char* vd = kd + L::TILE;
    constexpr int CH = L::ROW / 16;
    const int d0 = p0 - kt, d1 = p1 - kt;  // the tile's live rows
    for (int idx = lane; idx < (d0 + BK - d1) * CH; idx += 32) {
      const int jj = idx / CH, j = jj < d0 ? jj : jj - d0 + d1;
      *reinterpret_cast<uint4*>(vd + j * L::RS + (idx - jj * CH) * 16) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    // order those writes, and this stage's earlier reads, before the
    // copies of the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();  // every lane's writes and fence before the arrive
    if (lane == 0) mbar_expect(br, 2u * (p1 - p0) * L::ROW);
    __syncwarp();
    rows.each(p0, p1, lane, [&](int pos, long off) {
      bulk_copy(kd + (pos - kt) * L::RS, kc + off, L::ROW, br);
      bulk_copy(vd + (pos - kt) * L::RS, vc + off, L::ROW, br);
    });
  };

  if constexpr (L::HDP > HD) {
    // the pad columns of every staged K and V row, once
    constexpr int PC = (L::PROW - L::ROW) / 16;
    for (int idx = tid; idx < DEC_STAGES * 2 * BK * PC; idx += blockDim.x)
      *reinterpret_cast<uint4*>(ring + idx / PC * L::RS + L::ROW +
                                idx % PC * 16) = make_uint4(0u, 0u, 0u, 0u);
  }
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < DEC_STAGES; ++s) mbar_init(&bar[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are initialised
  if (warp == 0)
    for (int i = 0; i < min(ntiles, DEC_STAGES); ++i) issue(i);
  __syncthreads();  // the zeroed V rows are visible

  // per warp: O [16 heads x hd] as n-tiles of 8 columns, the running max
  // (log2 units) and sum of rows gid and gid + 8
  float oacc[2 * L::NK][4];
#pragma unroll
  for (int n = 0; n < 2 * L::NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float sl2 = scale * LOG2E;
  const int wk = warp * DEC_KPW;  // the warp's first key of a tile
  // ldmatrix row addresses: matrix mi = lane / 8, row lane % 8; K's
  // matrices are (keys 0-7 | 8-15) x (columns 0-7 | 8-15) of a k-step,
  // V's (keys 0-7 | 8-15) of (columns 0-7 | 8-15) of an n-tile pair
  const int mi = lane >> 3, mr = lane & 7;
  const uint32_t k_off = (wk + (mi >> 1) * 8 + mr) * L::RS + (mi & 1) * 16;
  const uint32_t v_off = (wk + (mi & 1) * 8 + mr) * L::RS + (mi >> 1) * 16;
  const uint32_t ring_u = smem_u32(ring);

  for (int i = 0; i < ntiles; ++i) {
    const int kt = kt0 + i * BK;
    const uint32_t ks = ring_u + (i % DEC_STAGES) * 2 * L::TILE;
    const uint32_t vs = ks + L::TILE;
    mbar_wait(&bar[i % DEC_STAGES], (i / DEC_STAGES) & 1);

    // S = Q K^T for the warp's 16 keys: s[nt] holds keys 8 nt + 2 tig +
    // {0, 1} of rows gid ([0], [1]) and gid + 8 ([2], [3])
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < L::NK; ++kk) {
      uint32_t kb[4];
      ldsm_x4(ks + k_off + kk * 32, kb);
#pragma unroll
      for (int x = 0; x < NQ; ++x) {
        mma_bf16(s[0], qa[x][kk], kb[0], kb[1]);
        mma_bf16(s[1], qa[x][kk], kb[2], kb[3]);
      }
    }

    // online softmax (exp2) over the warp's keys; dead keys: NEG_INF, p 0
    const int j0 = k0 - kt - wk, j1 = k1 - kt - wk;
    bool live[2][2];
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 8 * nt + 2 * tig + e;
        live[nt][e] = j >= j0 && j < j1;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& x = s[nt][2 * h + e];
          x = live[nt][e] ? x * sl2 : NEG_INF;
          mx[h] = fmaxf(mx[h], x);
        }
      }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 2));
      mx[h] = fmaxf(m[h], mx[h]);
      corr[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& x = s[nt][2 * h + e];
          x = live[nt][e] ? exp2f(x - m[h]) : 0.f;
          rs[h] += x;
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(FULL, rs[h], 1);
      rs[h] += __shfl_xor_sync(FULL, rs[h], 2);
      l[h] = l[h] * corr[h] + rs[h];
    }
#pragma unroll
    for (int n = 0; n < 2 * L::NK; ++n) {
      oacc[n][0] *= corr[0];
      oacc[n][1] *= corr[0];
      oacc[n][2] *= corr[1];
      oacc[n][3] *= corr[1];
    }

    // O += P V, P as the A operand straight from S's fragments (hi + lo)
    uint32_t pa[2][4];
    split_bf16(s[0][0], s[0][1], pa[0][0], pa[1][0]);
    split_bf16(s[0][2], s[0][3], pa[0][1], pa[1][1]);
    split_bf16(s[1][0], s[1][1], pa[0][2], pa[1][2]);
    split_bf16(s[1][2], s[1][3], pa[0][3], pa[1][3]);
#pragma unroll
    for (int nn = 0; nn < L::NK; ++nn) {
      uint32_t vb[4];
      ldsm_x4_t(vs + v_off + nn * 32, vb);
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        mma_bf16(oacc[2 * nn], pa[x], vb[0], vb[1]);
        mma_bf16(oacc[2 * nn + 1], pa[x], vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (warp == 0 && i + DEC_STAGES < ntiles) issue(i + DEC_STAGES);
  }

  // merge the warps through the (now idle) ring, in warp order
  float* wm = reinterpret_cast<float*>(ring);  // [DEC_WARPS][16]
  float* wl = wm + DEC_WARPS * DEC_ROWS;       // [DEC_WARPS][16]
  float* wt = wl + DEC_WARPS * DEC_ROWS;       // [DEC_WARPS][16] weights
  float* hm = wt + DEC_WARPS * DEC_ROWS;       // [16] the block's max
  float* hl = hm + DEC_ROWS;                   // [16] its sum
  float* wa = hl + DEC_ROWS;                   // [DEC_WARPS][16][HD]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = gid + 8 * h;
    if (row < g) {
      if (tig == 0) {
        wm[warp * DEC_ROWS + row] = m[h];
        wl[warp * DEC_ROWS + row] = l[h];
      }
      float* d = wa + (warp * DEC_ROWS + row) * HD + 2 * tig;
#pragma unroll
      for (int n = 0; n < 2 * L::NK; ++n) {
        if (8 * n >= HD) break;  // the pad's n-tile
        d[8 * n] = oacc[n][2 * h];
        d[8 * n + 1] = oacc[n][2 * h + 1];
      }
    }
  }
  __syncthreads();
  if (tid < g) {
    float mx = NEG_INF;
    for (int w = 0; w < DEC_WARPS; ++w)
      mx = fmaxf(mx, wm[w * DEC_ROWS + tid]);
    float ls = 0.f;
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float wgt = exp2f(wm[w * DEC_ROWS + tid] - mx);
      wt[w * DEC_ROWS + tid] = wgt;
      ls += wl[w * DEC_ROWS + tid] * wgt;
    }
    hm[tid] = mx;
    hl[tid] = ls;
  }
  __syncthreads();

  const long r = (long)b * KV + kvh;
  const int rec = dec_record(g, HD);
  float* mine = nlive > 1 ? part + (r * gridDim.x + sp) * rec : nullptr;
  for (int idx = tid; idx < g * HD; idx += blockDim.x) {
    const int h = idx / HD, d = idx - h * HD;
    float a = 0.f;
    for (int w = 0; w < DEC_WARPS; ++w)
      a += wa[(w * DEC_ROWS + h) * HD + d] * wt[w * DEC_ROWS + h];
    if (nlive == 1)
      o[qb + idx] = from_f<TQ>(a / fmaxf(hl[h], 1e-30f));
    else
      mine[idx] = a;
  }
  if (nlive == 1) return;
  if (tid < g) {
    mine[g * HD + tid] = hm[tid];
    mine[g * HD + g + tid] = hl[tid];
  }

  // the last live split of the row to arrive merges, in split order
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(arrived + r, 1) == nlive - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* first = part + (r * gridDim.x + s_lo) * rec;
  for (int i4 = tid; i4 < g * HD / 4; i4 += blockDim.x) {
    const int h = i4 * 4 / HD;
    float mx = NEG_INF, ls = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < nlive; ++s) {
      const float* rs = first + s * rec;
      const float4 v = __ldcg(reinterpret_cast<const float4*>(rs) + i4);
      const float ms = __ldcg(rs + g * HD + h);
      const float lsp = __ldcg(rs + g * HD + g + h);
      const float mn = fmaxf(mx, ms);
      const float c_old = exp2f(mx - mn), c_new = exp2f(ms - mn);
      a.x = a.x * c_old + v.x * c_new;
      a.y = a.y * c_old + v.y * c_new;
      a.z = a.z * c_old + v.z * c_new;
      a.w = a.w * c_old + v.w * c_new;
      ls = ls * c_old + lsp * c_new;
      mx = mn;
    }
    const float lc = fmaxf(ls, 1e-30f);
    TQ* out = o + qb + 4 * i4;
    out[0] = from_f<TQ>(a.x / lc);
    out[1] = from_f<TQ>(a.y / lc);
    out[2] = from_f<TQ>(a.z / lc);
    out[3] = from_f<TQ>(a.w / lc);
  }
  if (tid == 0) arrived[r] = 0;  // ready for the next launch
}

}  // namespace repro
