// Mamba2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd.py:ssd_chunk_scan (_ssd_kernel).  For each
// (batch b, head h), sequentially over chunks of Q rows, with cum the
// in-chunk prefix sum of a_log and S the [P, N] f32 state (zero at the
// first chunk):
//   y_q   = sum_{t<=q} (C_q.B_t) exp(clip(cum_q - cum_t)) x_t
//         + exp(clip(cum_q)) (C_q . S^T)
//   S_new = exp(clip(cum_{Q-1})) S
//         + sum_t exp(clip(cum_{Q-1} - cum_t)) x_t (x) B_t
// with clip to [-60, 0].  f32 throughout; y is written, the final state is
// not (as on the TPU).
//
// What bounds it on the H100: at the training shape (xh [2,1024,80,64],
// N 64, chunk 256) the inputs and the output are ~85 MB against ~8 GFLOP
// (the Q x Q score block is causal, so half of it is work), so the byte
// bound (~0.026 ms) is above the bf16 tensor-core bound; but this first
// version does its products in f32 on the CUDA cores (no wgmma, no TMA),
// whose rate, not memory, limits it.  PERF.md records by how much.
//
// Design.  The TPU kernel walks the chunks on a sequential grid axis and
// carries S in VMEM scratch.  Here one block of 256 threads owns one
// (b, h) and loops over the chunks itself, with S in shared memory
// (transposed, [N][P]).  Per chunk: cum is scanned once into shared memory
// by one warp, together with exp(clip(cum)) and the tail decays
// exp(clip(cum_{Q-1} - cum_t)).  The Q x Q score block is tiled in 64-row
// query tiles against 64-row key tiles t0 <= q0; B and C tiles are staged
// transposed ([N][64], odd row stride), x tiles row-major, and the score
// tile goes through shared memory.  Each thread owns a 4 x 4 sub-tile
// (rows rg + 16i, columns cg + 16j), so a warp's shared-memory reads are
// broadcasts or consecutive words.  The decay is formed as
// exp(clip(cum_q - cum_t)), never as exp(cum_q) exp(-cum_t), which would
// overflow within a chunk at the model's a_log (~ -0.7 a step); weights
// above the diagonal are exactly 0.  The state's new value is summed in
// registers during the last query tile's key loop (which visits every key
// tile) and written only after every row of the chunk has read the old
// one.  B and C are indexed by (b, s) only: one group, shared by the
// heads.  xh and y are read and written with their [B,S,H,P] strides.
#include <cstdint>
#include <cuda_runtime.h>

namespace repro {
namespace ssd {

constexpr int THREADS = 256;
constexpr int TILE = 64;         // rows of a query tile and of a key tile
constexpr int MAXD = 64;         // largest P and N
constexpr int TS = TILE + 1;     // row stride of the transposed B/C tiles
constexpr int WS = TILE + 16;    // row stride of the score tile

__device__ __forceinline__ float clip_exp(float x) {
  return expf(fminf(fmaxf(x, -60.f), 0.f));
}

// Shared memory: the state [MAXD][MAXD], C^T and B^T tiles [MAXD][TS],
// the x tile [TILE][MAXD], the score tile [TILE][WS], then cum,
// exp(clip(cum)) and the tail decays, Q floats each.
__host__ __device__ constexpr int fixed_smem_floats() {
  return MAXD * MAXD + 2 * MAXD * TS + TILE * MAXD + TILE * WS;
}

__global__ void __launch_bounds__(THREADS)
    ssd_chunk_scan_kernel(const float* __restrict__ xh,
                          const float* __restrict__ a_log,
                          const float* __restrict__ bb,
                          const float* __restrict__ cc, float* __restrict__ y,
                          int S, int H, int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  float* st_s = smem;                      // [N][P] at stride MAXD
  float* ct_s = st_s + MAXD * MAXD;        // [N][TS]: C of the query tile
  float* bt_s = ct_s + MAXD * TS;          // [N][TS]: B of the key tile
  float* x_s = bt_s + MAXD * TS;           // [TILE][MAXD]
  float* w_s = x_s + TILE * MAXD;          // [TILE][WS]
  float* cum_s = w_s + TILE * WS;          // [Q]
  float* din_s = cum_s + Q;                // [Q] exp(clip(cum_q))
  float* tail_s = din_s + Q;               // [Q] exp(clip(cum_last - cum_t))

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int rg = tid >> 4;  // row (or state n) group: rows rg + 16 i
  const int cg = tid & 15;  // column group: columns cg + 16 j
  const int h = blockIdx.x, b = blockIdx.y;
  const long row_x = (long)H * P;  // xh / y stride between positions

  for (int i = tid; i < MAXD * MAXD; i += THREADS) st_s[i] = 0.f;

  const int nqt = (Q + TILE - 1) / TILE;
  for (int c0 = 0; c0 < S; c0 += Q) {
    const long pos0 = (long)b * S + c0;    // row of (b, chunk start)
    __syncthreads();  // the previous chunk is done with cum_s
    for (int t = tid; t < Q; t += THREADS)
      cum_s[t] = a_log[(pos0 + t) * H + h];
    __syncthreads();
    if (warp == 0) {  // inclusive prefix sum: lane l owns a run of rows
      const int per = (Q + 31) / 32;
      const int lo = min(Q, lane * per), hi = min(Q, lo + per);
      float run = 0.f;
      for (int t = lo; t < hi; ++t) run += cum_s[t];
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      float acc = incl - run;  // exclusive prefix of this lane's run
      for (int t = lo; t < hi; ++t) {
        acc += cum_s[t];
        cum_s[t] = acc;
      }
    }
    __syncthreads();
    const float cum_last = cum_s[Q - 1];
    for (int t = tid; t < Q; t += THREADS) {
      din_s[t] = clip_exp(cum_s[t]);
      tail_s[t] = clip_exp(cum_last - cum_s[t]);
    }
    const float chunk_decay = clip_exp(cum_last);

    float s_acc[4][4];  // new-state terms for (n = rg + 16i, p = cg + 16j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s_acc[i][j] = 0.f;

    for (int qt = 0; qt < nqt; ++qt) {
      const int q0 = qt * TILE;
      const int qv = min(TILE, Q - q0);  // live rows of this query tile
      const bool last = qt == nqt - 1;
      __syncthreads();  // ct_s and the previous tile's reads are done
      for (int idx = tid; idx < TILE * N; idx += THREADS) {
        const int r = idx / N, n = idx % N;
        ct_s[n * TS + r] = r < qv ? cc[(pos0 + q0 + r) * N + n] : 0.f;
      }
      __syncthreads();

      // inter-chunk: y = exp(clip(cum_q)) C_q . S_prev
      float y_acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) y_acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = ct_s[n * TS + rg + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = cg + 16 * j;
          sv[j] = p < P ? st_s[n * MAXD + p] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            y_acc[i][j] = fmaf(cv[i], sv[j], y_acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg + 16 * i;
        const float d = r < qv ? din_s[q0 + r] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) y_acc[i][j] *= d;
      }

      // intra-chunk, key tiles t0 <= q0
      for (int t0 = 0; t0 <= q0; t0 += TILE) {
        const int tv = min(TILE, Q - t0);  // live rows of this key tile
        __syncthreads();  // the previous key tile is consumed
        for (int idx = tid; idx < TILE * N; idx += THREADS) {
          const int t = idx / N, n = idx % N;
          bt_s[n * TS + t] = t < tv ? bb[(pos0 + t0 + t) * N + n] : 0.f;
        }
        for (int idx = tid; idx < TILE * P; idx += THREADS) {
          const int t = idx / P, p = idx % P;
          x_s[t * MAXD + p] =
              t < tv ? xh[(pos0 + t0 + t) * row_x + (long)h * P + p] : 0.f;
        }
        __syncthreads();

        // scores W[q][t] = (C_q.B_t) exp(clip(cum_q - cum_t)), 0 above the
        // diagonal and outside the chunk
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = ct_s[n * TS + rg + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = bt_s[n * TS + cg + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cv[i], bv[j], sc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = rg + 16 * i, q = q0 + r;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int tc = cg + 16 * j, t = t0 + tc;
            const bool live = r < qv && tc < tv && t <= q;
            w_s[r * WS + tc] =
                live ? sc[i][j] * clip_exp(cum_s[q] - cum_s[t]) : 0.f;
          }
        }

        // the new state's terms: S += (tail_t x_t) (x) B_t over this tile
        if (last) {
          for (int t = 0; t < tv; ++t) {
            const float tl = tail_s[t0 + t];
            float bv[4], xv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int n = rg + 16 * i;
              bv[i] = n < N ? bt_s[n * TS + t] : 0.f;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j)
              xv[j] = x_s[t * MAXD + cg + 16 * j] * tl;
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                s_acc[i][j] = fmaf(bv[i], xv[j], s_acc[i][j]);
          }
        }
        __syncthreads();  // w_s is complete

        // y += W x over this key tile
        for (int t = 0; t < tv; ++t) {
          float wv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) wv[i] = w_s[(rg + 16 * i) * WS + t];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = x_s[t * MAXD + cg + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              y_acc[i][j] = fmaf(wv[i], xv[j], y_acc[i][j]);
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg + 16 * i;
        if (r < qv) {
          float* yr = y + (pos0 + q0 + r) * row_x + (long)h * P;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = cg + 16 * j;
            if (p < P) yr[p] = y_acc[i][j];
          }
        }
      }
    }

    // every row of the chunk has read S_prev: S = decay S_prev + S_local
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = rg + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = cg + 16 * j;
        if (n < N && p < P)
          st_s[n * MAXD + p] =
              fmaf(chunk_decay, st_s[n * MAXD + p], s_acc[i][j]);
      }
    }
  }
}

}  // namespace ssd
}  // namespace repro

// Plain C interface, loaded with ctypes.  Returns a cudaError_t code.  The
// caller guarantees 1 <= P, N <= 64, S % Q == 0 and contiguous f32 inputs
// (kernels/ssd.py checks them).  Asynchronous on ``stream``; nothing here
// synchronises or allocates.
extern "C" int repro_ssd_chunk_scan(const float* xh, const float* a_log,
                                    const float* bb, const float* cc,
                                    float* y, int B, int S, int H, int P,
                                    int N, int Q, void* stream) {
  using namespace repro::ssd;
  const int smem = (fixed_smem_floats() + 3 * Q) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B);
  ssd_chunk_scan_kernel<<<grid, THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      xh, a_log, bb, cc, y, S, H, P, N, Q);
  return (int)cudaGetLastError();
}
