// Flash attention backward for Hopper (sm_90a): dq, and dk/dv with the GQA
// group sum, every product on the tensor cores through wgmma.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention_bwd, both
// its pallas_call sites: _bwd_dq_kernel (dq, :491) and _bwd_dkv_kernel
// (dk/dv, :519).  Same formulas: P is recomputed from the forward's f32
// logsumexp under the causal/window mask, delta = rowsum(O * dO) in f32,
// dS = P * (dP - delta); dq = dS K scale, dk = dS^T Q scale, dv = P^T dO.
//
// What bounds it on the H100: at the training shape (q [4,1024,12,128],
// kv [4,1024,2,128], causal) dq does 3 and dk/dv 4 products of the size
// of Q K^T over the visible half, ~19 and ~26 GFLOP, against a few tens of
// MB of inputs and outputs: operations.  The bound is the bf16 tensor-core
// rate, which only wgmma reaches.
//
// Design.  One warpgroup (128 threads) per block; every tile is 64 rows
// (q rows or keys) by the head dim, bf16, in shared memory in wgmma's
// no-swizzle layout (8 x 16-byte core matrices of 128 contiguous bytes,
// wgmma.cuh): any head dim that is a multiple of 8 fits it without
// padding (hd 80 is 10 core matrices a row), wgmma reads it without bank
// conflicts, and one copy of a tile serves as a K-major operand and, with
// the transpose bit, as an MN-major one.  Tiles are staged with 16-byte
// cp.async (rows past the array zero-filled), the streamed operand
// double-buffered so the loads of step i + 1 overlap the products of step
// i.  P and dS, f32 in registers, enter their products as two bf16
// operands, hi = bf16(x) and lo = bf16(x - hi) (to_operands,
// flash_tiles.cuh, shared with flash_fwd.cu): rounding them to one bf16
// moved dv by up to two bf16 ulps from the plain version, past its 1e-2
// band; the split costs two more register-operand products a step and
// keeps ~16 bits of P and dS.
// q, o and dO are bf16 here; f32 ones go to flash_bwd_f32.cu.
//   dq:    block = (64-row q tile, head, batch), blocks with the most key
//          tiles first.  Q and dO stay; K/V tiles stream.  S = Q K^T and
//          dP = dO V^T (m64n64k16, both operands in shared memory) land
//          as rows x keys in registers; dS (hi + lo) is the register A
//          operand of dQ += dS K (m64n<hd>k16, K MN-major).
//          While its first tiles load, the block computes delta for its
//          rows from O and dO in f32 and writes it for the dk/dv kernel,
//          which follows on the same stream.
//   dk/dv: block = (64-key tile, split of the group, KV head, batch), key
//          tile 0 (the longest causal walk) first.  K/V stay; Q, dO, lse,
//          delta stream over the block's query heads and the q tiles
//          between the causal and the window bound.  S^T = K Q^T and
//          dP^T = V dO^T come out keys x rows, so P^T and dS^T (hi + lo)
//          are the register A operands of dV += P^T dO and dK += dS^T Q
//          (dO and Q MN-major).  The g query heads of a KV head are split
//          over ``nsplit`` blocks when the grid would otherwise leave SMs
//          idle (qwen2's 128 key-tile blocks become 384): each block
//          writes its f32 partial, and the last of a group to finish (an
//          int counter) sums the partials in split order, so the result
//          does not depend on which block finishes last.  No float
//          atomics: two launches give the same bits.
// Tile shapes: 64 x hd bf16, six of them per block (96 KB at hd 128,
// 60 KB at hd 80), plus lse/delta rows; two blocks share an SM.  Masked
// scores give P = 0 exactly; only tiles that cross the diagonal, the
// window edge or the end of the arrays evaluate the mask, per element of
// the accumulator fragment.  Rows and keys outside the arrays are zeroed
// when staged (the TPU's _clean), and so are their lse and delta.
#include "flash_tiles.cuh"

namespace repro {

constexpr int BWD_THREADS = WG_THREADS;
static_assert(BWD_THREADS == 2 * BT, "one thread per staged lse/delta row");

template <int HD>
constexpr int bwd_smem_bytes() {
  return 6 * BT * HD * 2 + 4 * BT * 4;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest cp.async group have landed, and are visible to
// wgmma (the async proxy) once the block has passed a barrier
__device__ __forceinline__ void cp_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Stage rows [r0, r0 + BT) of one head (row r at src + r * stride) as a
// no-swizzle tile; rows at or past ``limit`` are zero-filled.  Eight
// neighbouring threads fill one core matrix (128 contiguous bytes).
template <int HD>
__device__ __forceinline__ void stage(__nv_bfloat16* __restrict__ dst,
                                      const __nv_bfloat16* __restrict__ src,
                                      long stride, int r0, int limit) {
  constexpr int CPR = HD / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < BT * CPR; idx += BWD_THREADS) {
    const int rest = idx >> 3, c = rest % CPR;
    const int r = (rest / CPR) * 8 + (idx & 7);
    const bool ok = r0 + r < limit;
    cp_async16(dst + wg::tile_off<HD>(r, c * 8),
               src + (ok ? (long)(r0 + r) * stride : 0) + c * 8, ok);
  }
}

// wgmma descriptors of a staged tile, for k-step kk (16 along K).  As a
// K-major operand the tile's columns (hd) are K: core matrices 128 bytes
// apart along K, 16 hd bytes apart along rows.  As an MN-major operand its
// rows are K: core matrices 16 hd bytes apart along K (LBO) and 128 bytes
// apart along hd (SBO).
template <int HD>
__device__ __forceinline__ uint64_t desc_kmajor(const __nv_bfloat16* t,
                                                int kk) {
  return wg::make_desc(t + kk * 128, 128, 16 * HD);
}
template <int HD>
__device__ __forceinline__ uint64_t desc_mnmajor(const __nv_bfloat16* t,
                                                 int kk) {
  return wg::make_desc(t + kk * 16 * HD, 16 * HD, 128);
}

// acc (+)= A B^T over the head dim, A and B staged tiles (64 x 64 out)
template <int HD>
__device__ __forceinline__ void tile_product(
    float (&acc)[32], const __nv_bfloat16* a, const __nv_bfloat16* b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wg::ss_n64(acc, desc_kmajor<HD>(a, kk), desc_kmajor<HD>(b, kk), kk > 0);
}

// acc += X B for X given by to_operands and B a staged tile read MN-major
// (64 x hd out).  The operand registers are read asynchronously: the
// caller keeps them (wg::fence_regs) until the products are waited for.
template <int HD>
__device__ __forceinline__ void reg_product(float (&acc)[HD / 2],
                                                  const uint32_t (&a)[4][4],
                                                  const __nv_bfloat16* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wg::rs<HD>(acc, a[kk], desc_mnmajor<HD>(b, kk), 1);
}

template <int HD>
__global__ void __launch_bounds__(BWD_THREADS)
    flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ o,
                        const __nv_bfloat16* __restrict__ dO,
                        const float* __restrict__ lse,
                        float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq,
                        int B, int Sq, int Sk, int H, int KV, int causal,
                        int window, float scale) {
  constexpr int T = BT * HD;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* do_s = q_s + T;
  __nv_bfloat16* k_s = do_s + T;     // [2][T]
  __nv_bfloat16* v_s = k_s + 2 * T;  // [2][T]
  float* lse_s = reinterpret_cast<float*>(v_s + 2 * T);  // [BT], x log2 e
  float* dl_s = lse_s + BT;                              // [BT]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_qt = (Sq + BT - 1) / BT;
  const int per = H * B;
  const int qt = causal ? n_qt - 1 - blockIdx.x / per : blockIdx.x / per;
  const int h = (blockIdx.x % per) % H, b = (blockIdx.x % per) / H;
  const int q0 = qt * BT, kvh = h / (H / KV);

  const long qstride = (long)H * HD, kstride = (long)KV * HD;
  const long qhead = ((long)b * Sq * H + h) * HD;
  const long khead = ((long)b * Sk * KV + kvh) * HD;

  const int q_last = min(q0 + BT, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = (window > 0 ? max(0, q0 - window + 1) : 0) / BT * BT;

  stage<HD>(q_s, q + qhead, qstride, q0, Sq);
  stage<HD>(do_s, dO + qhead, qstride, q0, Sq);
  if (k_begin < k_end) {
    stage<HD>(k_s, k + khead, kstride, k_begin, Sk);
    stage<HD>(v_s, v + khead, kstride, k_begin, Sk);
  }
  cp_commit();

  // delta = rowsum(O * dO) in f32 from the arrays, and lse, per row: two
  // threads a row, each over half of it in 16-byte loads, all in flight
  static_assert(HD % 16 == 0, "two threads a row, 8 elements a load");
  const long rows = ((long)b * H + h) * Sq;
  {
    constexpr int NC = HD / 16;  // 16-byte chunks per thread
    const int r = tid >> 1, row = q0 + r;
    float acc = 0.f;
    if (row < Sq) {
      const long off = qhead + (long)row * qstride + (tid & 1) * (HD / 2);
      uint4 ov[NC], dv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        ov[c] = __ldg(reinterpret_cast<const uint4*>(o + off) + c);
        dv[c] = __ldg(reinterpret_cast<const uint4*>(dO + off) + c);
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const uint32_t* ow = reinterpret_cast<const uint32_t*>(&ov[c]);
        const uint32_t* dw = reinterpret_cast<const uint32_t*>(&dv[c]);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float2 x = bf2_to_f2(ow[w]), y = bf2_to_f2(dw[w]);
          acc = fmaf(x.x, y.x, acc);
          acc = fmaf(x.y, y.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((tid & 1) == 0) {
      dl_s[r] = acc;
      lse_s[r] = row < Sq ? lse[rows + row] * LOG2E : 0.f;
      if (row < Sq) delta[rows + row] = acc;
    }
  }
  __syncthreads();
  // this thread's accumulator rows: ra and ra + 8; columns cq, cq + 1 of
  // each group of 8
  const int ra = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
  const float lse2[2] = {lse_s[ra], lse_s[ra + 8]};
  const float dlt[2] = {dl_s[ra], dl_s[ra + 8]};
  const float sl2 = scale * LOG2E;

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  int buf = 0;
  for (int kt = k_begin; kt < k_end; kt += BT, buf ^= 1) {
    __syncthreads();  // the products of the previous tile are done
    if (kt + BT < k_end) {
      stage<HD>(k_s + (buf ^ 1) * T, k + khead, kstride, kt + BT, Sk);
      stage<HD>(v_s + (buf ^ 1) * T, v + khead, kstride, kt + BT, Sk);
    }
    cp_commit();
    cp_wait_all_but_newest();
    __syncthreads();
    const __nv_bfloat16* kb = k_s + buf * T;
    const __nv_bfloat16* vb = v_s + buf * T;

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wg::fence_regs(s);
    wg::fence_regs(dp);
    wg::fence();
    tile_product<HD>(s, q_s, kb);
    tile_product<HD>(dp, do_s, vb);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(s);
    wg::fence_regs(dp);

    const bool edge = (causal && kt + BT - 1 > q0) ||
                      (window > 0 && kt < q0 + BT - window) ||
                      kt + BT > Sk || q0 + BT > Sq;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hi = (i >> 1) & 1;
      float p = exp2f(fmaf(s[i], sl2, -lse2[hi]));
      if (edge && !visible(q0 + ra + 8 * hi, kt + 8 * (i >> 2) + cq + (i & 1),
                           Sq, Sk, causal, window))
        p = 0.f;
      s[i] = p * (dp[i] - dlt[hi]);  // dS
    }
    uint32_t ds_hi[4][4], ds_lo[4][4];
    to_operands(s, ds_hi, ds_lo);
    wg::fence_regs(acc);
    wg::fence();
    reg_product<HD>(acc, ds_hi, kb);
    reg_product<HD>(acc, ds_lo, kb);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(acc);
    wg::fence_regs(ds_hi);
    wg::fence_regs(ds_lo);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = q0 + ra + 8 * hi;
    if (row >= Sq) continue;
    __nv_bfloat16* out = dq + qhead + (long)row * qstride + cq;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * hi] * scale, acc[4 * j + 2 * hi + 1] * scale);
  }
}

template <int HD>
__global__ void __launch_bounds__(BWD_THREADS)
    flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dO,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv,
                         float* __restrict__ partial, int* __restrict__ arrived,
                         int B, int Sq, int Sk, int H, int KV, int nsplit,
                         int causal, int window, float scale) {
  constexpr int T = BT * HD;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_s = k_s + T;
  __nv_bfloat16* q_s = v_s + T;       // [2][T]
  __nv_bfloat16* do_s = q_s + 2 * T;  // [2][T]
  float* rows_s = reinterpret_cast<float*>(do_s + 2 * T);  // [2][lse, dl][BT]
  __shared__ int is_last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int per = nsplit * KV * B;
  const int k0 = (blockIdx.x / per) * BT;
  const int rem = blockIdx.x % per;
  const int sp = rem % nsplit, kvh = (rem / nsplit) % KV,
            b = rem / (nsplit * KV);
  const int g = H / KV, gps = g / nsplit;

  const long qstride = (long)H * HD, kstride = (long)KV * HD;
  const long khead = ((long)b * Sk * KV + kvh) * HD;
  stage<HD>(k_s, k + khead, kstride, k0, Sk);
  stage<HD>(v_s, v + khead, kstride, k0, Sk);

  const int k_last = min(k0 + BT, Sk) - 1;
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(Sq, k_last + window) : Sq;
  const int nq = q_begin < q_end ? (q_end - q_begin + BT - 1) / BT : 0;
  const int n_steps = gps * nq;

  // step t: query head kvh g + sp gps + t / nq, q tile t % nq
  auto stage_step = [&](int t, int bf) {
    const int h = kvh * g + sp * gps + t / nq;
    const int qt = q_begin + (t % nq) * BT;
    const long qhead = ((long)b * Sq * H + h) * HD;
    stage<HD>(q_s + bf * T, q + qhead, qstride, qt, Sq);
    stage<HD>(do_s + bf * T, dO + qhead, qstride, qt, Sq);
    const int r = tid % BT;
    const bool ok = qt + r < Sq;
    const float* src = (tid < BT ? lse : delta) + ((long)b * H + h) * Sq;
    cp_async4(rows_s + bf * 2 * BT + tid, src + (ok ? qt + r : 0), ok);
  };
  if (n_steps > 0) stage_step(0, 0);
  cp_commit();

  const int ra = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
  const float sl2 = scale * LOG2E;
  float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int t = 0; t < n_steps; ++t) {
    const int bf = t & 1;
    __syncthreads();  // the products of the previous step are done
    if (t + 1 < n_steps) stage_step(t + 1, bf ^ 1);
    cp_commit();
    cp_wait_all_but_newest();
    __syncthreads();
    const int qt = q_begin + (t % nq) * BT;
    const __nv_bfloat16* qb = q_s + bf * T;
    const __nv_bfloat16* dob = do_s + bf * T;
    const float* lse_r = rows_s + bf * 2 * BT;
    const float* dl_r = lse_r + BT;

    // S^T = K Q^T and dP^T = V dO^T: keys x q rows
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wg::fence_regs(s);
    wg::fence_regs(dp);
    wg::fence();
    tile_product<HD>(s, k_s, qb);
    tile_product<HD>(dp, v_s, dob);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(s);
    wg::fence_regs(dp);

    const bool edge = (causal && qt < k0 + BT - 1) ||
                      (window > 0 && k0 <= qt + BT - 1 - window) ||
                      qt + BT > Sq || k0 + BT > Sk;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i >> 2) + cq + (i & 1);
      float p = exp2f(fmaf(s[i], sl2, -lse_r[col] * LOG2E));
      if (edge && !visible(qt + col, k0 + ra + 8 * ((i >> 1) & 1), Sq, Sk,
                           causal, window))
        p = 0.f;
      dp[i] = p * (dp[i] - dl_r[col]);  // dS^T
      s[i] = p;                         // P^T
    }
    uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
    to_operands(s, p_hi, p_lo);
    to_operands(dp, ds_hi, ds_lo);
    wg::fence_regs(dv_acc);
    wg::fence_regs(dk_acc);
    wg::fence();
    reg_product<HD>(dv_acc, p_hi, dob);
    reg_product<HD>(dv_acc, p_lo, dob);
    reg_product<HD>(dk_acc, ds_hi, qb);
    reg_product<HD>(dk_acc, ds_lo, qb);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(dv_acc);
    wg::fence_regs(dk_acc);
    wg::fence_regs(p_hi);
    wg::fence_regs(p_lo);
    wg::fence_regs(ds_hi);
    wg::fence_regs(ds_lo);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  if (nsplit > 1) {
    // partials in fragment order: register i of thread tid at i * 128 + tid
    constexpr int P = HD * BWD_THREADS;
    const long group = blockIdx.x / nsplit;
    float* mine = partial + (group * nsplit + sp) * P;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) {
      mine[i * BWD_THREADS + tid] = dk_acc[i];
      mine[(HD / 2 + i) * BWD_THREADS + tid] = dv_acc[i];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) is_last = atomicAdd(arrived + group, 1) == nsplit - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    const float* all = partial + group * nsplit * P;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) {
      float a = 0.f, c = 0.f;  // in split order, whoever finishes last
      for (int j = 0; j < nsplit; ++j) {
        a += j == sp ? dk_acc[i] : __ldcg(all + j * P + i * BWD_THREADS + tid);
        c += j == sp ? dv_acc[i]
                     : __ldcg(all + j * P + (HD / 2 + i) * BWD_THREADS + tid);
      }
      dk_acc[i] = a;
      dv_acc[i] = c;
    }
    if (tid == 0) arrived[group] = 0;  // ready for the next launch
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int kpos = k0 + ra + 8 * hi;
    if (kpos >= Sk) continue;
    const long off = khead + (long)kpos * kstride + cq;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int i = 4 * j + 2 * hi;
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
          __floats2bfloat162_rn(dk_acc[i] * scale, dk_acc[i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
          __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *o, *dO;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  float* partial;
  int* arrived;
  int B, Sq, Sk, H, KV, nsplit, causal, window;
  float scale;
  cudaStream_t stream;
};

template <int HD>
static int launch_dq(const BwdArgs& a) {
  constexpr int smem = bwd_smem_bytes<HD>();
  auto kern = flash_bwd_dq_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (a.Sq + BT - 1) / BT * a.H * a.B;
  kern<<<grid, BWD_THREADS, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.o),
      static_cast<const __nv_bfloat16*>(a.dO), a.lse, a.delta,
      static_cast<__nv_bfloat16*>(a.dq),
      a.B, a.Sq, a.Sk, a.H, a.KV, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

template <int HD>
static int launch_dkv(const BwdArgs& a) {
  constexpr int smem = bwd_smem_bytes<HD>();
  auto kern = flash_bwd_dkv_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (a.Sk + BT - 1) / BT * a.nsplit * a.KV * a.B;
  kern<<<grid, BWD_THREADS, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dO), a.lse, a.delta,
      static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv),
      a.partial, a.arrived, a.B, a.Sq,
      a.Sk, a.H, a.KV, a.nsplit, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

template <bool DKV, int HD>
static int launch(const BwdArgs& a) {
  return DKV ? launch_dkv<HD>(a) : launch_dq<HD>(a);
}

template <bool DKV>
static int dispatch_hd(int hd, const BwdArgs& a) {
  switch (hd) {
    case 16:
      return launch<DKV, 16>(a);
    case 64:
      return launch<DKV, 64>(a);
    case 80:
      return launch<DKV, 80>(a);
    case 128:
      return launch<DKV, 128>(a);
    default:
      return -1;
  }
}

}  // namespace repro

// Plain C interface, loaded with ctypes; q, k, v, o, dO, dq, dk, dv bf16
// (f32 queries: flash_bwd_f32.cu).  Each returns a cudaError_t code,
// or -1 for a head dimension without a template instance (or a split that
// does not divide the group).  Launches are asynchronous on ``stream``;
// nothing here synchronises or allocates.  repro_flash_bwd_dq writes dq
// and delta [B,H,Sq] (f32); repro_flash_bwd_dkv reads that delta, so it
// must follow on the same stream.  With nsplit > 1 the dk/dv kernel needs
// ``partial``, f32 [ceil(Sk/64) KV B nsplit, 128 hd], and ``arrived``, int32
// [ceil(Sk/64) KV B], zero at launch (the kernel leaves it zero).
extern "C" int repro_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* o, const void* dO,
                                  const float* lse, float* delta, void* dq,
                                  int B, int Sq, int Sk, int H, int KV, int hd,
                                  int causal, int window, float scale,
                                  void* stream) {
  repro::BwdArgs a{q,  k,  v,  o,  dO, lse,    delta,  dq, nullptr, nullptr,
                   nullptr, nullptr, B, Sq, Sk, H, KV, 1, causal, window,
                   scale, static_cast<cudaStream_t>(stream)};
  return repro::dispatch_hd<false>(hd, a);
}

extern "C" int repro_flash_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* dO,
                                   const float* lse, const float* delta,
                                   void* dk, void* dv, float* partial,
                                   int* arrived, int B, int Sq, int Sk, int H,
                                   int KV, int hd, int nsplit, int causal,
                                   int window, float scale, void* stream) {
  if (nsplit < 1 || (H / KV) % nsplit != 0) return -1;
  repro::BwdArgs a{q,  k,  v,  nullptr, dO, lse, const_cast<float*>(delta),
                   nullptr, dk, dv, partial, arrived, B, Sq, Sk, H, KV,
                   nsplit, causal, window, scale,
                   static_cast<cudaStream_t>(stream)};
  return repro::dispatch_hd<true>(hd, a);
}
