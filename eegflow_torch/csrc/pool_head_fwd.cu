// Fused LayerNorm + additive-attention pool head, forward, for Hopper (sm_90a).
//
// Replaces: eegflow/nn/pallas_attention.py _pool_head_fwd_kernel (entry
// _pool_head_fwd_call / pool_head_fused), run once per batch by the
// classifier on the serving path and once per training micro-step; and, in
// its float32 body with one part and no LayerNorm, _attention_pool_kernel
// (entry attention_pool_pallas).
//
// For each batch row, over the feature parts x_p (B, T, d_p) of the BiLSTM
// output:
//   y_t = LN(concat_p x_p[t])  statistics pooled across parts:
//         mu = E[x], var = E[x^2] - mu^2, eps 1e-5 (as _ln_rows)
//   s_t = sum_k tanh(bf16(y_t) . bf16(W1)[:, k] + b1_k) * w2_k   (float32)
//   ctx = sum_t softmax(s)_t y_t     (online softmax over t, float32 y)
// and returns the context split back into parts plus the raw scores s; the
// score bias b2 is added outside (eegflow/nn/model.py adds it). bf16
// rounding happens only under `bf16`.
//
// What bounds it on the card: per row it reads T x D float32 of input once
// (0.54 GB at B = 1024, T = 256, D = 512: 0.16 ms at 3.35 TB/s) and does
// T x D x K multiply-adds (69 GFLOP at K = 256: 0.07 ms at the bf16
// tensor-core peak), so the bytes bound it. The T loop of the online softmax
// is serial within a row.
//
// bf16 mode (pool_head_fwd_bf16_kernel). One CTA of 8 warps per batch row
// walks time in tiles of kM = 64 steps. Per tile: one warp per row computes
// the LayerNorm statistics with shuffles and writes bf16(y) into a K-major
// tile [kM][D + 8] in shared memory; proj = bf16(y) . bf16(W1) runs on
// mma.sync m16n8k16 (mma_gemm.cuh's tile_mma), W1 rounded to bf16 once by
// the wrapper and streamed from L2 through a ring of two 32-deep cp.async
// slices, so a batch row reads W1 T / 64 times as bf16 (4 x 256 KB at
// T = 256) where the float32 body reads it T / 16 times as float32 (16 x
// 512 KB). The epilogue reduces tanh(acc + b1) w2 over K in a fixed order:
// a thread's columns, the quad by shuffles, then the warps in order; warp 0
// turns the 64 scores into the online softmax's weights. The context sums
// float32 y, as the reference does (bf16 y would move it by ~4e-3): a float32
// y tile (128 KB at D = 512) beside the bf16 tile (65 KB) and the ring (33
// KB) is over the 227 KB a CTA may have, so each thread recomputes y for its
// features from x (the tile it read a moment before, an L2 hit) and the
// row's statistics. Without the float32 tile a CTA takes 101 KB, so two
// share an SM and one's loads overlap the other's products. Sums in fixed
// orders, no atomics: a launch repeats bit for bit. Needs D <= 512 and K <=
// 256, both multiples of 32 (the wrapper raises otherwise).
//
// float32 mode (pool_head_fwd_kernel, launched with bf16 = 0; also kernel 6):
// one CTA per batch row, time in chunks of kT steps staged in shared memory,
// each W1 element loaded from L2 feeding kT multiply-adds. One warp per
// staged step computes its LayerNorm statistics with shuffles; each thread
// owns columns k of W1 for the projection on CUDA-core FMA; the per-step
// scores are reduced across warps through shared memory; each thread owns
// features d of the softmax accumulator. Nothing of size T x D is written
// back to device memory.

#include <math.h>

#include "common.cuh"
#include "mma_gemm.cuh"

namespace {

constexpr int kT = 16;          // time steps per chunk
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// float32 mode; its bf16 branches are dead (the bf16 mode has its own
// kernel below) and stay, as kernel 8's float32 body keeps its own: taking
// such branches out of that body slowed it by 1.1 ms on an H100.
__global__ void __launch_bounds__(kThreads)
pool_head_fwd_kernel(const float* __restrict__ x0, const float* __restrict__ x1,
                     int d0, int d1, const float* __restrict__ gamma,
                     const float* __restrict__ beta, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ w2,
                     float* __restrict__ ctx0, float* __restrict__ ctx1,
                     float* __restrict__ scores, int T, int K, int use_ln, int bf16,
                     float eps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = d0 + d1;
  float* y = smem;                // [kT][D]  LayerNorm output (float32)
  float* yb = y + kT * D;         // [D][kT]  projection operand
  float* acc = yb + kT * D;       // [D]      softmax-weighted accumulator
  float* red = acc + D;           // [kWarps][kT] partial scores
  float* s_sh = red + kWarps * kT;  // [kT]  scores of the chunk

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float inv_d = 1.0f / static_cast<float>(D);

  for (int d = tid; d < D; d += kThreads) acc[d] = 0.f;
  float m = -INFINITY;  // running max
  float l = 0.f;        // running denominator

  for (int t0 = 0; t0 < T; t0 += kT) {
    const int tc = min(kT, T - t0);
    for (int i = tid; i < kT * D; i += kThreads) {
      const int tt = i / D;
      const int d = i - tt * D;
      float v = 0.f;
      if (tt < tc) {
        const size_t t = static_cast<size_t>(b) * T + t0 + tt;
        v = (d < d0) ? x0[t * d0 + d] : x1[t * d1 + (d - d0)];
      }
      y[i] = v;
    }
    __syncthreads();

    for (int tt = warp; tt < kT; tt += kWarps) {
      float* row = y + tt * D;
      float mu = 0.f, rsig = 1.f;
      if (use_ln) {
        float s1 = 0.f, s2 = 0.f;
        for (int d = lane; d < D; d += 32) {
          const float v = row[d];
          s1 += v;
          s2 += v * v;
        }
        s1 = eegflow::warp_sum(s1);
        s2 = eegflow::warp_sum(s2);
        mu = s1 * inv_d;
        rsig = rsqrtf(s2 * inv_d - mu * mu + eps);
      }
      for (int d = lane; d < D; d += 32) {
        float v = row[d];
        if (use_ln) v = (v - mu) * rsig * gamma[d] + beta[d];
        row[d] = v;
        yb[d * kT + tt] = bf16 ? eegflow::bf16_round(v) : v;
      }
    }
    __syncthreads();

    float sp[kT];
#pragma unroll
    for (int tt = 0; tt < kT; ++tt) sp[tt] = 0.f;
    for (int k = tid; k < K; k += kThreads) {
      float a[kT];
#pragma unroll
      for (int tt = 0; tt < kT; ++tt) a[tt] = 0.f;
      const float* wk = w1 + k;
      for (int d = 0; d < D; ++d, wk += K) {
        const float w = bf16 ? eegflow::bf16_round(*wk) : *wk;
        const float4* yv = reinterpret_cast<const float4*>(yb + d * kT);
#pragma unroll
        for (int q = 0; q < kT / 4; ++q) {
          const float4 v = yv[q];
          a[4 * q + 0] = fmaf(v.x, w, a[4 * q + 0]);
          a[4 * q + 1] = fmaf(v.y, w, a[4 * q + 1]);
          a[4 * q + 2] = fmaf(v.z, w, a[4 * q + 2]);
          a[4 * q + 3] = fmaf(v.w, w, a[4 * q + 3]);
        }
      }
      const float bk = b1[k], w2k = w2[k];
#pragma unroll
      for (int tt = 0; tt < kT; ++tt) sp[tt] += tanhf(a[tt] + bk) * w2k;
    }
#pragma unroll
    for (int tt = 0; tt < kT; ++tt) {
      const float v = eegflow::warp_sum(sp[tt]);
      if (lane == 0) red[warp * kT + tt] = v;
    }
    __syncthreads();
    if (tid < kT) {
      float v = 0.f;
      for (int w = 0; w < kWarps; ++w) v += red[w * kT + tid];
      s_sh[tid] = v;
      if (tid < tc) scores[static_cast<size_t>(b) * T + t0 + tid] = v;
    }
    __syncthreads();

    float m_new = m;
    for (int tt = 0; tt < tc; ++tt) m_new = fmaxf(m_new, s_sh[tt]);
    const float scale = expf(m - m_new);  // 0 on the first chunk (m = -inf)
    float pe[kT];
    float psum = 0.f;
#pragma unroll
    for (int tt = 0; tt < kT; ++tt) {
      pe[tt] = tt < tc ? expf(s_sh[tt] - m_new) : 0.f;
      psum += pe[tt];
    }
    l = l * scale + psum;
    for (int d = tid; d < D; d += kThreads) {
      float a = acc[d] * scale;
#pragma unroll
      for (int tt = 0; tt < kT; ++tt) a = fmaf(pe[tt], y[tt * D + d], a);
      acc[d] = a;
    }
    m = m_new;
    __syncthreads();  // the next chunk overwrites y
  }

  const float inv_l = 1.0f / l;
  for (int d = tid; d < D; d += kThreads) {
    const float v = acc[d] * inv_l;
    if (d < d0)
      ctx0[static_cast<size_t>(b) * d0 + d] = v;
    else
      ctx1[static_cast<size_t>(b) * d1 + (d - d0)] = v;
  }
}

// bf16 mode: tiles of kM (b, t) rows of one batch row, kBThreads threads (8
// warps), W1 in kTileSlice-deep slices in a ring of kStages.
constexpr int kM = 64;
constexpr int kMT = kM / 16;  // m-tiles of a tile
constexpr int kBThreads = 256;
constexpr int kBWarps = kBThreads / 32;
constexpr int kStages = 2;
constexpr int kMaxD = 512;  // a lane holds at most 16 features of a row
constexpr int kMaxK = 256;  // a warp owns at most 2 16-column pairs of proj
constexpr int kF = kMaxD / kBThreads;  // context features a thread

// bf16 mode, one CTA per batch row. Thread (warp w, lane = 4 g + q) holds,
// for m-tile i and n-tile j of its pairs, rows 16 i + g, 16 i + g + 8 and
// columns 16 pair + 8 (j % 2) + 2 q, + 1 of proj (tile_mma); in the LayerNorm
// pass warp w takes rows 2 w, 2 w + 1, 2 w + 16, .. and lane l features
// l + 32 i; in the context sum thread tid owns features tid + kBThreads i.
//   x_p (B, T, d_p) float32; w1b (D, K) bf16; ctx_p (B, d_p), scores (B, T).
__global__ void __launch_bounds__(kBThreads, 2)
pool_head_fwd_bf16_kernel(const float* __restrict__ x0, const float* __restrict__ x1, int d0,
                          int d1, const float* __restrict__ gamma,
                          const float* __restrict__ beta, const __nv_bfloat16* __restrict__ w1b,
                          const float* __restrict__ b1, const float* __restrict__ w2,
                          float* __restrict__ ctx0, float* __restrict__ ctx1,
                          float* __restrict__ scores, int T, int K, int use_ln, float eps) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int D = d0 + d1;
  const int lda = D + 8;
  const int stage_elems = eegflow::kTileSlice * (K + 8);
  __nv_bfloat16* const ys = reinterpret_cast<__nv_bfloat16*>(smem);  // [kM][D + 8] bf16(y)
  __nv_bfloat16* const ring = ys + kM * lda;                          // [kStages][stage]
  float2* const stat = reinterpret_cast<float2*>(ring + kStages * stage_elems);  // [kM] mu, rsig
  float* const red = reinterpret_cast<float*>(stat + kM);  // [kBWarps][kM] partial scores
  float* const p_s = red + kBWarps * kM;  // [kM] the tile's exp(s - running max)
  float* const scal = p_s + kM;           // [2] the tile's rescale; at the end the sum l

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const float inv_d = 1.0f / static_cast<float>(D);
  float acc_c[kF];  // the context sums of features tid + kBThreads i
#pragma unroll
  for (int i = 0; i < kF; ++i) acc_c[i] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;  // warp 0's running max and denominator

  for (int t0 = 0; t0 < T; t0 += kM) {
    const int tc = min(kM, T - t0);
    const size_t bt0 = static_cast<size_t>(b) * T + t0;
    // LayerNorm, bf16(y) into the tile (rows past T zero), two rows a warp
    // at a time so that their loads are in flight together
    for (int r0 = 2 * warp; r0 < kM; r0 += 2 * kBWarps) {
      float xv[2][kMaxD / 32];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const bool valid = r0 + rr < tc;
        const size_t bt = bt0 + r0 + rr;
#pragma unroll
        for (int i = 0; i < kMaxD / 32; ++i) {
          const int d = lane + 32 * i;
          float v = 0.f;
          if (valid && d < D) v = d < d0 ? x0[bt * d0 + d] : x1[bt * d1 + (d - d0)];
          xv[rr][i] = v;
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = r0 + rr;
        float mu = 0.f, rsig = 1.f;
        if (use_ln) {
          float s1 = 0.f, s2 = 0.f;
#pragma unroll
          for (int i = 0; i < kMaxD / 32; ++i) {
            s1 += xv[rr][i];
            s2 += xv[rr][i] * xv[rr][i];
          }
          s1 = eegflow::warp_sum(s1);
          s2 = eegflow::warp_sum(s2);
          mu = s1 * inv_d;
          rsig = rsqrtf(s2 * inv_d - mu * mu + eps);
        }
#pragma unroll
        for (int i = 0; i < kMaxD / 32; ++i) {
          const int d = lane + 32 * i;
          if (d >= D) continue;
          float v = xv[rr][i];
          if (use_ln) v = (v - mu) * rsig * gamma[d] + beta[d];
          ys[r * lda + d] = __float2bfloat16_rn(r < tc ? v : 0.f);
        }
        if (lane == 0) stat[r] = make_float2(mu, rsig);
      }
    }
    // (tile_mma's first barrier orders these stores before the product)

    // proj = bf16(y) . bf16(W1); the scores, reduced over K in a fixed order
    {
      float acc[kMT][4][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      eegflow::tile_mma<kMT, 2, kStages, kBWarps>(acc, ys, lda, w1b, D, K, ring, stage_elems);
      float sp[kMT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) sp[i][0] = sp[i][1] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pair = warp + kBWarps * (j / 2);
        if (pair >= K / 16) continue;
        const int col = pair * 16 + 8 * (j % 2) + 2 * q;
        const float bk[2] = {b1[col], b1[col + 1]}, w2k[2] = {w2[col], w2[col + 1]};
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int rh = 0; rh < 2; ++rh)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              sp[i][rh] += tanhf(acc[i][j][2 * rh + e] + bk[e]) * w2k[e];
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          float v = sp[i][rh];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (q == 0) red[warp * kM + 16 * i + 8 * rh + gq] = v;
        }
    }
    __syncthreads();

    // warp 0: the scores (the warps' partials in order) and the online softmax
    if (warp == 0) {
      float s[2], mx = -INFINITY;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lane + 32 * h;
        float v = 0.f;
        for (int w = 0; w < kBWarps; ++w) v += red[w * kM + r];
        s[h] = v;
        if (r < tc) {
          scores[bt0 + r] = v;
          mx = fmaxf(mx, v);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run, mx);
      float psum = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lane + 32 * h;
        const float pe = r < tc ? expf(s[h] - m_new) : 0.f;
        p_s[r] = pe;
        psum += pe;
      }
      psum = eegflow::warp_sum(psum);
      const float scale = expf(m_run - m_new);  // 0 on the first tile (m_run = -inf)
      l_run = l_run * scale + psum;
      m_run = m_new;
      if (lane == 0) scal[0] = scale;
    }
    __syncthreads();

    // ctx = ctx * scale + sum_r p_r y_r over float32 y, recomputed from x
    const float scale = scal[0];
    const float* xp[kF];
    int ld[kF];
    float gd[kF], bd[kF], a[kF];
#pragma unroll
    for (int i = 0; i < kF; ++i) {
      const int d = min(tid + kBThreads * i, D - 1);  // clamped: the sum of d >= D is unused
      const bool first = d < d0;
      xp[i] = first ? x0 + bt0 * d0 + d : x1 + bt0 * d1 + (d - d0);
      ld[i] = first ? d0 : d1;
      gd[i] = use_ln ? gamma[d] : 1.f;
      bd[i] = use_ln ? beta[d] : 0.f;
      a[i] = acc_c[i] * scale;
    }
#pragma unroll 8
    for (int r = 0; r < tc; ++r) {
      const float2 st = stat[r];
      const float pr = p_s[r];
#pragma unroll
      for (int i = 0; i < kF; ++i) {
        float v = xp[i][static_cast<size_t>(r) * ld[i]];
        if (use_ln) v = (v - st.x) * st.y * gd[i] + bd[i];
        a[i] = fmaf(pr, v, a[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kF; ++i) acc_c[i] = a[i];
    __syncthreads();  // the next tile overwrites ys, stat and p_s
  }

  if (tid == 0) scal[1] = l_run;
  __syncthreads();
  const float inv_l = 1.0f / scal[1];
#pragma unroll
  for (int i = 0; i < kF; ++i) {
    const int d = tid + kBThreads * i;
    if (d >= D) continue;
    const float v = acc_c[i] * inv_l;
    if (d < d0)
      ctx0[static_cast<size_t>(b) * d0 + d] = v;
    else
      ctx1[static_cast<size_t>(b) * d1 + (d - d0)] = v;
  }
}

size_t bf16_smem_bytes(int D, int K) {
  return (static_cast<size_t>(kM) * (D + 8) +
          static_cast<size_t>(kStages) * eegflow::kTileSlice * (K + 8)) *
             sizeof(__nv_bfloat16) +
         kM * sizeof(float2) + (static_cast<size_t>(kBWarps) * kM + kM + 2) * sizeof(float);
}

}  // namespace

// x_p (B, T, d_p) float32; gamma, beta (d0 + d1,) float32 (null without LN);
// w1 (d0 + d1, K): bf16 under `bf16` (which needs d0 + d1 <= 512 and K <=
// 256, both multiples of 32), else float32; b1, w2 (K,) float32; ctx_p
// (B, d_p) and scores (B, T) float32. x1/ctx1 may be null when d1 == 0.
extern "C" int eegflow_pool_head_fwd(const float* x0, const float* x1, int d0, int d1,
                                     const float* gamma, const float* beta, const void* w1,
                                     const float* b1, const float* w2, float* ctx0,
                                     float* ctx1, float* scores, int B, int T, int K,
                                     int use_ln, int bf16, cudaStream_t stream) {
  const int D = d0 + d1;
  if (B <= 0 || T <= 0 || K <= 0 || d0 <= 0 || d1 < 0 ||
      (use_ln && (gamma == nullptr || beta == nullptr)) ||
      (bf16 && (D % 32 != 0 || K % 32 != 0 || D > kMaxD || K > kMaxK)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (bf16) {
    const size_t smem = bf16_smem_bytes(D, K);
    err = eegflow::allow_dynamic_smem(pool_head_fwd_bf16_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    pool_head_fwd_bf16_kernel<<<B, kBThreads, smem, stream>>>(
        x0, x1, d0, d1, gamma, beta, static_cast<const __nv_bfloat16*>(w1), b1, w2, ctx0,
        ctx1, scores, T, K, use_ln, 1e-5f);
  } else {
    const size_t smem =
        (2 * static_cast<size_t>(kT) * D + D + kWarps * kT + kT) * sizeof(float);
    err = eegflow::allow_dynamic_smem(pool_head_fwd_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    pool_head_fwd_kernel<<<B, kThreads, smem, stream>>>(
        x0, x1, d0, d1, gamma, beta, static_cast<const float*>(w1), b1, w2, ctx0, ctx1,
        scores, T, K, use_ln, 0, 1e-5f);
  }
  return static_cast<int>(cudaGetLastError());
}
