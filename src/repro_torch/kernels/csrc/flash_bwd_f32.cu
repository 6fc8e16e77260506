// Flash attention backward for f32 queries (q, o, dO in f32; K/V bf16):
// dq, and dk/dv with the GQA group sum, on the CUDA cores in f32.
//
// Replaces, for that dtype: src/repro/kernels/flash_attention.py:
// flash_attention_bwd, _bwd_dq_kernel (:491) and _bwd_dkv_kernel (:519).
// The main paths send bf16 queries to the wgmma kernels of flash_bwd.cu,
// which stage their tiles in bf16; rounding f32 queries and dO to bf16
// there moved the gradients past the 1e-2 band of the plain version, so
// f32 inputs keep these kernels, which do every product in f32.
// Operations bound them, as flash_bwd.cu; these sit far below the bound
// (no tensor cores), which no main path pays for.
//
// Design.  dq: one block of 8 warps per (64-row q tile, head, batch);
// each warp owns 8 rows and keeps their dq in registers; the k loop runs
// from the window bound to the causal bound.  The block also computes
// delta for its rows and writes it out for the dk/dv kernel, which runs
// after it on the same stream.  dk/dv: one block of 8 warps per (64-key
// tile, KV head, batch); each warp owns 8 keys and keeps their dk and dv
// in f32 registers; the block loops over the g query heads and the q
// tiles, so the group sum happens in registers and each of dk, dv is
// written once, in an order that does not depend on scheduling.  Masked
// scores give P = 0 exactly; rows and keys outside the arrays are zeroed
// when staged (the TPU's _clean).
#include "flash_common.cuh"

namespace repro {
namespace {  // this file's own symbols

constexpr int BWD_WARPS = 8;
constexpr int BWD_ROWS = 8;                    // rows (dq) / keys (dkv) per warp
constexpr int BWD_BQ = BWD_WARPS * BWD_ROWS;   // 64 query rows per q tile
static_assert(BWD_BQ == BK, "the dk/dv kernel's key tile is one K/V tile");

template <int HD>
constexpr int dq_smem_bytes() {
  return 2 * BWD_BQ * HD * 4 + 2 * Tile<HD>::WORDS * 4 +
         BWD_WARPS * BWD_ROWS * BK * 4;
}

template <int HD>
constexpr int dkv_smem_bytes() {
  return 2 * Tile<HD>::WORDS * 4 + 2 * BWD_BQ * (HD + 1) * 4 + 2 * BWD_BQ * 4 +
         2 * BWD_WARPS * BWD_ROWS * BWD_BQ * 4;
}

template <int HD, typename TQ>
__global__ void __launch_bounds__(BWD_WARPS * 32)
    flash_bwd_dq_f32_kernel(const TQ* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const TQ* __restrict__ o, const TQ* __restrict__ dO,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, TQ* __restrict__ dq,
                        int Sq, int Sk, int H, int KV, int causal, int window,
                        float scale) {
  constexpr int R = BWD_ROWS;
  constexpr int PPL = Tile<HD>::PPL;
  constexpr int KW = Tile<HD>::KW;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);        // [BQ][HD], q * scale
  float* do_s = q_s + BWD_BQ * HD;                     // [BQ][HD]
  uint32_t* k_s = reinterpret_cast<uint32_t*>(do_s + BWD_BQ * HD);
  uint32_t* v_s = k_s + Tile<HD>::WORDS;
  float* ds_s = reinterpret_cast<float*>(v_s + Tile<HD>::WORDS);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BWD_BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);

  for (int idx = threadIdx.x; idx < BWD_BQ * HD; idx += blockDim.x) {
    const int r = idx / HD, d = idx % HD, row = q0 + r;
    float x = 0.f, y = 0.f;  // padded rows are zero (_clean)
    if (row < Sq) {
      const long off = ((long)(b * Sq + row) * H + h) * HD + d;
      x = to_f(q[off]) * scale;
      y = to_f(dO[off]);
    }
    q_s[idx] = x;
    do_s[idx] = y;
  }
  __syncthreads();

  // per row: the forward's lse, and delta = rowsum(O * dO) in f32
  float lse_r[R], dlt[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = warp * R + i, row = q0 + r;
    float acc = 0.f;
    if (row < Sq) {
      const TQ* orow = o + ((long)(b * Sq + row) * H + h) * HD;
      for (int d = lane; d < HD; d += 32) acc += to_f(orow[d]) * do_s[r * HD + d];
    }
    acc = warp_sum(acc);
    dlt[i] = acc;
    lse_r[i] = row < Sq ? lse[((long)b * H + h) * Sq + row] : 0.f;
    if (lane == 0 && row < Sq) delta[((long)b * H + h) * Sq + row] = acc;
  }

  const int q_last = min(q0 + BWD_BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  float acc[R][2 * PPL];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int t = 0; t < 2 * PPL; ++t) acc[i][t] = 0.f;

  const long row_stride = (long)KV * HD;
  const __nv_bfloat16* kb = k + ((long)b * Sk * KV + kvh) * HD;
  const __nv_bfloat16* vb = v + ((long)b * Sk * KV + kvh) * HD;
  auto in_range = [&](int pos) { return pos < Sk; };
  float* ds_w = ds_s + warp * R * BK;

  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();  // the previous tile is consumed
    load_kv_tile<HD>(k_s, kb, row_stride, kt, in_range);
    load_kv_tile<HD>(v_s, vb, row_stride, kt, in_range);
    __syncthreads();

    // S = (q scale) K^T and dP = dO V^T for keys kt + lane, kt + lane + 32
    float s[R][2], dp[R][2];
#pragma unroll
    for (int i = 0; i < R; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
    const uint32_t* k0p = k_s + lane * KW;
    const uint32_t* k1p = k_s + (lane + 32) * KW;
    const uint32_t* v0p = v_s + lane * KW;
    const uint32_t* v1p = v_s + (lane + 32) * KW;
#pragma unroll 2
    for (int w = 0; w < HD / 2; ++w) {
      const float2 ka = bf2_to_f2(k0p[w]), kc = bf2_to_f2(k1p[w]);
      const float2 va = bf2_to_f2(v0p[w]), vc = bf2_to_f2(v1p[w]);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float2 qv = reinterpret_cast<const float2*>(q_s + (warp * R + i) * HD)[w];
        const float2 dv = reinterpret_cast<const float2*>(do_s + (warp * R + i) * HD)[w];
        s[i][0] = fmaf(qv.x, ka.x, fmaf(qv.y, ka.y, s[i][0]));
        s[i][1] = fmaf(qv.x, kc.x, fmaf(qv.y, kc.y, s[i][1]));
        dp[i][0] = fmaf(dv.x, va.x, fmaf(dv.y, va.y, dp[i][0]));
        dp[i][1] = fmaf(dv.x, vc.x, fmaf(dv.y, vc.y, dp[i][1]));
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + warp * R + i;
      const float p0 = visible(row, kt + lane, Sq, Sk, causal, window)
                           ? expf(s[i][0] - lse_r[i]) : 0.f;
      const float p1 = visible(row, kt + lane + 32, Sq, Sk, causal, window)
                           ? expf(s[i][1] - lse_r[i]) : 0.f;
      ds_w[i * BK + lane] = p0 * (dp[i][0] - dlt[i]);
      ds_w[i * BK + lane + 32] = p1 * (dp[i][1] - dlt[i]);
    }
    __syncwarp();

    // dq += dS K; lane owns the bf16 pairs lane, lane + 32, ... of hd
    for (int j = 0; j < BK; ++j) {
      const uint32_t* kr = k_s + j * KW;
      float2 kv2[PPL];
#pragma unroll
      for (int t = 0; t < PPL; ++t) {
        const int pi = lane + 32 * t;
        kv2[t] = (pi < HD / 2) ? bf2_to_f2(kr[pi]) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float dsv = ds_w[i * BK + j];
#pragma unroll
        for (int t = 0; t < PPL; ++t) {
          acc[i][2 * t] = fmaf(dsv, kv2[t].x, acc[i][2 * t]);
          acc[i][2 * t + 1] = fmaf(dsv, kv2[t].y, acc[i][2 * t + 1]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + warp * R + i;
    if (row < Sq) {
      TQ* out = dq + ((long)(b * Sq + row) * H + h) * HD;
#pragma unroll
      for (int t = 0; t < PPL; ++t) {
        const int pi = lane + 32 * t;
        if (pi < HD / 2) {
          out[2 * pi] = from_f<TQ>(acc[i][2 * t] * scale);
          out[2 * pi + 1] = from_f<TQ>(acc[i][2 * t + 1] * scale);
        }
      }
    }
  }
}

template <int HD, typename TQ>
__global__ void __launch_bounds__(BWD_WARPS * 32)
    flash_bwd_dkv_f32_kernel(const TQ* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const TQ* __restrict__ dO,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H,
                         int KV, int causal, int window, float scale) {
  constexpr int R = BWD_ROWS;
  constexpr int PPL = Tile<HD>::PPL;
  constexpr int KW = Tile<HD>::KW;
  constexpr int QS = HD + 1;  // odd row stride: lanes on 32 rows, 32 banks
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* k_s = reinterpret_cast<uint32_t*>(smem);
  uint32_t* v_s = k_s + Tile<HD>::WORDS;
  float* q_s = reinterpret_cast<float*>(v_s + Tile<HD>::WORDS);  // [BQ][QS]
  float* do_s = q_s + BWD_BQ * QS;                                // [BQ][QS]
  float* lse_s = do_s + BWD_BQ * QS;
  float* dl_s = lse_s + BWD_BQ;
  float* p_s = dl_s + BWD_BQ;                     // [WARPS][R][BQ]
  float* ds_s = p_s + BWD_WARPS * R * BWD_BQ;     // [WARPS][R][BQ]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int g = H / KV;

  const long row_stride = (long)KV * HD;
  auto in_range = [&](int pos) { return pos < Sk; };
  load_kv_tile<HD>(k_s, k + ((long)b * Sk * KV + kvh) * HD, row_stride, k0,
                   in_range);
  load_kv_tile<HD>(v_s, v + ((long)b * Sk * KV + kvh) * HD, row_stride, k0,
                   in_range);

  float dk_acc[R][2 * PPL], dv_acc[R][2 * PPL];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int t = 0; t < 2 * PPL; ++t) dk_acc[i][t] = dv_acc[i][t] = 0.f;

  const int k_last = min(k0 + BK, Sk) - 1;
  const int q_begin = causal ? (k0 / BWD_BQ) * BWD_BQ : 0;
  const int q_end = window > 0 ? min(Sq, k_last + window) : Sq;
  float* p_w = p_s + warp * R * BWD_BQ;
  float* ds_w = ds_s + warp * R * BWD_BQ;

  for (int gi = 0; gi < g; ++gi) {
    const int h = kvh * g + gi;
    for (int qt = q_begin; qt < q_end; qt += BWD_BQ) {
      __syncthreads();  // the previous q tile is consumed (K/V are staged)
      for (int idx = threadIdx.x; idx < BWD_BQ * HD; idx += blockDim.x) {
        const int r = idx / HD, d = idx % HD, row = qt + r;
        float x = 0.f, y = 0.f;
        if (row < Sq) {
          const long off = ((long)(b * Sq + row) * H + h) * HD + d;
          x = to_f(q[off]);
          y = to_f(dO[off]);
        }
        q_s[r * QS + d] = x;
        do_s[r * QS + d] = y;
      }
      for (int r = threadIdx.x; r < BWD_BQ; r += blockDim.x) {
        const int row = qt + r;
        const long off = ((long)b * H + h) * Sq + row;
        lse_s[r] = row < Sq ? lse[off] : 0.f;
        dl_s[r] = row < Sq ? delta[off] : 0.f;
      }
      __syncthreads();

      // S = Q K^T (unscaled) and dP = dO V^T for this warp's keys against
      // rows qt + lane and qt + lane + 32
      float s[R][2], dp[R][2];
#pragma unroll
      for (int i = 0; i < R; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
      const float* q0p = q_s + lane * QS;
      const float* q1p = q_s + (lane + 32) * QS;
      const float* d0p = do_s + lane * QS;
      const float* d1p = do_s + (lane + 32) * QS;
#pragma unroll 2
      for (int w = 0; w < HD / 2; ++w) {
        const float qa0 = q0p[2 * w], qa1 = q0p[2 * w + 1];
        const float qb0 = q1p[2 * w], qb1 = q1p[2 * w + 1];
        const float da0 = d0p[2 * w], da1 = d0p[2 * w + 1];
        const float db0 = d1p[2 * w], db1 = d1p[2 * w + 1];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int kk = warp * R + i;
          const float2 kv2 = bf2_to_f2(k_s[kk * KW + w]);
          const float2 vv2 = bf2_to_f2(v_s[kk * KW + w]);
          s[i][0] = fmaf(qa0, kv2.x, fmaf(qa1, kv2.y, s[i][0]));
          s[i][1] = fmaf(qb0, kv2.x, fmaf(qb1, kv2.y, s[i][1]));
          dp[i][0] = fmaf(da0, vv2.x, fmaf(da1, vv2.y, dp[i][0]));
          dp[i][1] = fmaf(db0, vv2.x, fmaf(db1, vv2.y, dp[i][1]));
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int kpos = k0 + warp * R + i;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = lane + 32 * half;
          const float p = visible(qt + r, kpos, Sq, Sk, causal, window)
                              ? expf(s[i][half] * scale - lse_s[r]) : 0.f;
          p_w[i * BWD_BQ + r] = p;
          ds_w[i * BWD_BQ + r] = p * (dp[i][half] - dl_s[r]);
        }
      }
      __syncwarp();

      // dv += P^T dO, dk += dS^T Q; lane owns the pairs lane, lane + 32, ...
      for (int r = 0; r < BWD_BQ; ++r) {
        float2 dov[PPL], qv[PPL];
#pragma unroll
        for (int t = 0; t < PPL; ++t) {
          const int pi = lane + 32 * t;
          if (pi < HD / 2) {
            dov[t] = make_float2(do_s[r * QS + 2 * pi], do_s[r * QS + 2 * pi + 1]);
            qv[t] = make_float2(q_s[r * QS + 2 * pi], q_s[r * QS + 2 * pi + 1]);
          } else {
            dov[t] = qv[t] = make_float2(0.f, 0.f);
          }
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float pv = p_w[i * BWD_BQ + r];
          const float dsv = ds_w[i * BWD_BQ + r];
#pragma unroll
          for (int t = 0; t < PPL; ++t) {
            dv_acc[i][2 * t] = fmaf(pv, dov[t].x, dv_acc[i][2 * t]);
            dv_acc[i][2 * t + 1] = fmaf(pv, dov[t].y, dv_acc[i][2 * t + 1]);
            dk_acc[i][2 * t] = fmaf(dsv, qv[t].x, dk_acc[i][2 * t]);
            dk_acc[i][2 * t + 1] = fmaf(dsv, qv[t].y, dk_acc[i][2 * t + 1]);
          }
        }
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kpos = k0 + warp * R + i;
    if (kpos < Sk) {
      const long off = ((long)(b * Sk + kpos) * KV + kvh) * HD;
#pragma unroll
      for (int t = 0; t < PPL; ++t) {
        const int pi = lane + 32 * t;
        if (pi < HD / 2) {
          dk[off + 2 * pi] = __float2bfloat16(dk_acc[i][2 * t] * scale);
          dk[off + 2 * pi + 1] = __float2bfloat16(dk_acc[i][2 * t + 1] * scale);
          dv[off + 2 * pi] = __float2bfloat16(dv_acc[i][2 * t]);
          dv[off + 2 * pi + 1] = __float2bfloat16(dv_acc[i][2 * t + 1]);
        }
      }
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *o, *dO;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, Sq, Sk, H, KV, causal, window;
  float scale;
  cudaStream_t stream;
};

template <int HD, typename TQ>
static int launch_dq(const BwdArgs& a) {
  constexpr int smem = dq_smem_bytes<HD>();
  auto kern = flash_bwd_dq_f32_kernel<HD, TQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sq + BWD_BQ - 1) / BWD_BQ, a.H, a.B);
  kern<<<grid, BWD_WARPS * 32, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const TQ*>(a.o),
      static_cast<const TQ*>(a.dO), a.lse, a.delta, static_cast<TQ*>(a.dq),
      a.Sq, a.Sk, a.H, a.KV, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

template <int HD, typename TQ>
static int launch_dkv(const BwdArgs& a) {
  constexpr int smem = dkv_smem_bytes<HD>();
  auto kern = flash_bwd_dkv_f32_kernel<HD, TQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sk + BK - 1) / BK, a.KV, a.B);
  kern<<<grid, BWD_WARPS * 32, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const TQ*>(a.dO),
      a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.Sq, a.Sk, a.H, a.KV, a.causal,
      a.window, a.scale);
  return (int)cudaGetLastError();
}

template <bool DKV>
static int dispatch_hd(int hd, const BwdArgs& a) {
  switch (hd) {
    case 16:
      return DKV ? launch_dkv<16, float>(a) : launch_dq<16, float>(a);
    case 64:
      return DKV ? launch_dkv<64, float>(a) : launch_dq<64, float>(a);
    case 80:
      return DKV ? launch_dkv<80, float>(a) : launch_dq<80, float>(a);
    case 120:
      return DKV ? launch_dkv<120, float>(a)
                 : launch_dq<120, float>(a);
    case 128:
      return DKV ? launch_dkv<128, float>(a) : launch_dq<128, float>(a);
    default:
      return -1;
  }
}

}  // namespace
}  // namespace repro

// Plain C interface, loaded with ctypes, as repro_flash_bwd_dq / _dkv in
// flash_bwd.cu for f32 q, o and dO.  Each returns a cudaError_t code, or
// -1 for a head dimension without a template instance; nothing here
// synchronises or allocates.  repro_flash_bwd_dq_f32 writes dq and delta
// [B,H,Sq] (f32); repro_flash_bwd_dkv_f32 reads that delta, so it must
// follow on the same stream.
extern "C" int repro_flash_bwd_dq_f32(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dO, const float* lse,
                                      float* delta, void* dq, int B, int Sq,
                                      int Sk, int H, int KV, int hd,
                                      int causal, int window, float scale,
                                      void* stream) {
  repro::BwdArgs a{q,  k,  v,  o,  dO, lse,    delta,  dq,
                   nullptr, nullptr, B, Sq, Sk, H, KV, causal, window, scale,
                   static_cast<cudaStream_t>(stream)};
  return repro::dispatch_hd<false>(hd, a);
}

extern "C" int repro_flash_bwd_dkv_f32(const void* q, const void* k,
                                       const void* v, const void* dO,
                                       const float* lse, const float* delta,
                                       void* dk, void* dv, int B, int Sq,
                                       int Sk, int H, int KV, int hd,
                                       int causal, int window, float scale,
                                       void* stream) {
  repro::BwdArgs a{q,  k,  v,  nullptr, dO, lse, const_cast<float*>(delta),
                   nullptr, dk, dv, B, Sq, Sk, H, KV, causal, window, scale,
                   static_cast<cudaStream_t>(stream)};
  return repro::dispatch_hd<true>(hd, a);
}
