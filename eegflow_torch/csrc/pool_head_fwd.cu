// Fused LayerNorm + additive-attention pool head, forward, for Hopper (sm_90a).
//
// Replaces: eegflow/nn/pallas_attention.py _pool_head_fwd_kernel (entry
// _pool_head_fwd_call / pool_head_fused), run once per batch by the
// classifier on the bf16 serving path.
//
// For each batch row, over the feature parts x_p (B, T, d_p) of the BiLSTM
// output:
//   y_t = LN(concat_p x_p[t])  statistics pooled across parts:
//         mu = E[x], var = E[x^2] - mu^2, eps 1e-5 (as _ln_rows)
//   s_t = sum_k tanh(bf16(y_t) . bf16(W1)[:, k] + b1_k) * w2_k   (float32)
//   ctx = sum_t softmax(s)_t y_t     (online softmax over t)
// and returns the context split back into parts plus the raw scores s; the
// score bias b2 is added outside (eegflow/nn/model.py adds it).
//
// What bounds it on the card: per row it streams T x D float32 of input once
// and does T x D x K multiply-adds; W1 (D x K, 512 KB in float32 at D=512,
// K=256) is read from L2 for every chunk of time steps. The T loop of the
// online softmax is serial within a row.
//
// Design: one CTA per batch row, kThreads threads. Time goes in chunks of kT
// steps staged in shared memory, so each W1 element loaded from L2 feeds kT
// multiply-adds. One warp per staged step computes its LayerNorm statistics
// with shuffles; each thread owns columns k of W1 for the projection; the
// per-step scores are reduced across warps through shared memory; each
// thread owns features d of the softmax accumulator. Nothing of size T x D
// is written back to device memory.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kT = 16;          // time steps per chunk
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

}  // namespace

// x_p (B, T, d_p) float32; gamma, beta (d0 + d1,) float32 (null without LN);
// w1 (d0 + d1, K) float32; b1, w2 (K,) float32; ctx_p (B, d_p) and scores
// (B, T) float32. x1/ctx1 may be null when d1 == 0.
extern "C" int eegflow_pool_head_fwd(const float* x0, const float* x1, int d0, int d1,
                                     const float* gamma, const float* beta,
                                     const float* w1, const float* b1, const float* w2,
                                     float* ctx0, float* ctx1, float* scores, int B,
                                     int T, int K, int use_ln, int bf16,
                                     cudaStream_t stream) {
  if (B <= 0 || T <= 0 || K <= 0 || d0 <= 0 || d1 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int D = d0 + d1;
  const size_t smem =
      (2 * static_cast<size_t>(kT) * D + D + kWarps * kT + kT) * sizeof(float);
  cudaError_t err = eegflow::allow_dynamic_smem(pool_head_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pool_head_fwd_kernel<<<B, kThreads, smem, stream>>>(
      x0, x1, d0, d1, gamma, beta, w1, b1, w2, ctx0, ctx1, scores, T, K, use_ln,
      bf16, 1e-5f);
  return static_cast<int>(cudaGetLastError());
}
