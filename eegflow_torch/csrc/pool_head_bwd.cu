// Fused LayerNorm + additive-attention pool head, backward, for Hopper (sm_90a).
//
// Replaces: eegflow/nn/pallas_attention.py _pool_head_bwd_kernel (entry
// _pool_head_bwd_call, reached through pool_head_fused's custom VJP), run
// once per micro-step by the classifier's training step.
//
// Given the forward's input parts x_p (B, T, d_p), the softmax weights w
// (B, T) of the raw scores, the upstream gradients of the context parts g_p
// (B, d_p) and of the raw scores gs (B, T), and gctx = sum_p g_p . ctx_p
// (B,) (the three prepared outside, as in _pool_head_vjp_bwd), it recomputes
// per step t of every row
//   y_t = LN(x_t) (pooled statistics as in the forward), proj_t =
//   tanh(bf16(y_t) . bf16(W1) + b1)
// and produces
//   ds_t   = w_t (g . y_t - gctx) + gs_t
//   u_t    = ds_t (1 - proj_t^2) w2                         (float32)
//   dy_t   = w_t g + bf16(u_t) . bf16(W1)^T
//   dh_t   = rsig (dy_t gamma - mean(dy_t gamma) - xhat_t mean(dy_t gamma xhat_t))
//   db1 = sum u_t, dw2 = sum ds_t proj_t, dgamma = sum dy_t xhat_t,
//   dbeta = sum dy_t, dW1 = sum bf16(y_t)^T bf16(u_t)       (over b and t)
// (without LN, dh_t = dy_t and no dgamma, dbeta). Rounding to bf16 happens
// only under `bf16`, at the same points as the reference.
//
// What bounds it on the card: per row it streams T x D float32 of input
// once and does two T x D x K products (the recomputed projection and dy),
// W1 read from L2 for every chunk of steps; dW1 is a third product of the
// same size whose sum runs over all B T steps.
//
// Design: one CTA per batch row walks time in chunks of kT steps staged in
// shared memory, as the forward does: one warp per step for the LayerNorm
// statistics and the row dots, each thread owning columns k of W1 for the
// projection and features d for dy. The per-row sums of db1, dw2, dgamma
// and dbeta are owned by single threads in shared memory and written as one
// partial row per batch row; bf16(y) and bf16(u) go to float32 scratch
// (B T x D and B T x K) from which the tiled GEMM of gemm.cuh forms dW1 in
// split-K partials. Both partial sets are then summed in a fixed order: no
// atomics, so the result is bitwise repeatable.

#include <math.h>

#include "common.cuh"
#include "gemm.cuh"

namespace {

constexpr int kT = 16;          // time steps per chunk
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
pool_head_bwd_kernel(const float* __restrict__ x0, const float* __restrict__ x1, int d0,
                     int d1, const float* __restrict__ gamma, const float* __restrict__ beta,
                     const float* __restrict__ w1, const float* __restrict__ w1t,
                     const float* __restrict__ b1, const float* __restrict__ w2,
                     const float* __restrict__ wts, const float* __restrict__ gsc,
                     const float* __restrict__ g0, const float* __restrict__ g1,
                     const float* __restrict__ gctx, float* __restrict__ dh0,
                     float* __restrict__ dh1, float* __restrict__ y_scr,
                     float* __restrict__ u_scr, float* __restrict__ vec_part, int T, int K,
                     int use_ln, int bf16, float eps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = d0 + d1;
  float* y = smem;               // [kT][D]  LN output, then dy
  float* xh = y + kT * D;        // [kT][D]  normalized input (LN only)
  float* yb = xh + kT * D;       // [D][kT]  projection operand
  float* us = yb + kT * D;       // [K][kT]  dy operand bf16(u)
  float* g = us + kT * K;        // [D]      upstream gradient of the context
  float* acc_db1 = g + D;        // [K]
  float* acc_dw2 = acc_db1 + K;  // [K]
  float* acc_dg = acc_dw2 + K;   // [D]
  float* acc_dbt = acc_dg + D;   // [D]
  float* w_s = acc_dbt + D;      // [kT] softmax weights of the chunk
  float* ds_s = w_s + kT;        // [kT]
  float* rsig_s = ds_s + kT;     // [kT]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float inv_d = 1.0f / static_cast<float>(D);
  const float gc = gctx[b];

  for (int d = tid; d < D; d += kThreads) {
    g[d] = (d < d0) ? g0[static_cast<size_t>(b) * d0 + d]
                    : g1[static_cast<size_t>(b) * d1 + (d - d0)];
    acc_dg[d] = 0.f;
    acc_dbt[d] = 0.f;
  }
  for (int k = tid; k < K; k += kThreads) acc_db1[k] = acc_dw2[k] = 0.f;

  for (int t0 = 0; t0 < T; t0 += kT) {
    const int tc = min(kT, T - t0);
    const size_t bt0 = static_cast<size_t>(b) * T + t0;
    for (int i = tid; i < kT * D; i += kThreads) {
      const int tt = i / D;
      const int d = i - tt * D;
      float v = 0.f;
      if (tt < tc) v = (d < d0) ? x0[(bt0 + tt) * d0 + d] : x1[(bt0 + tt) * d1 + (d - d0)];
      y[i] = v;
    }
    if (tid < kT) w_s[tid] = tid < tc ? wts[bt0 + tid] : 0.f;
    __syncthreads();

    // LayerNorm (recomputed), the projection operand, and ds_t
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
      float gy = 0.f;
      for (int d = lane; d < D; d += 32) {
        float v = row[d];
        if (use_ln) {
          const float xhat = (v - mu) * rsig;
          xh[tt * D + d] = xhat;
          v = xhat * gamma[d] + beta[d];
        }
        row[d] = v;
        const float vb = bf16 ? eegflow::bf16_round(v) : v;
        yb[d * kT + tt] = vb;
        if (tt < tc) y_scr[(bt0 + tt) * D + d] = vb;
        gy += g[d] * v;
      }
      gy = eegflow::warp_sum(gy);
      if (lane == 0) {
        ds_s[tt] = tt < tc ? w_s[tt] * (gy - gc) + gsc[bt0 + tt] : 0.f;
        rsig_s[tt] = rsig;
      }
    }
    __syncthreads();

    // proj_t recomputed per column k; u_t, db1, dw2
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
      float db1 = acc_db1[k], dw2 = acc_dw2[k];
#pragma unroll
      for (int tt = 0; tt < kT; ++tt) {
        const float pr = tanhf(a[tt] + bk);
        const float ds = ds_s[tt];
        const float u = ds * (1.f - pr * pr) * w2k;
        const float ub = bf16 ? eegflow::bf16_round(u) : u;
        us[k * kT + tt] = tt < tc ? ub : 0.f;
        if (tt < tc) {
          db1 += u;
          dw2 += ds * pr;
          u_scr[(bt0 + tt) * K + k] = ub;
        }
      }
      acc_db1[k] = db1;
      acc_dw2[k] = dw2;
    }
    __syncthreads();

    // dy_t = w_t g + bf16(u_t) . W1^T per feature d; dgamma, dbeta
    for (int d = tid; d < D; d += kThreads) {
      float a[kT];
#pragma unroll
      for (int tt = 0; tt < kT; ++tt) a[tt] = 0.f;
      const float* wd = w1t + d;
      for (int k = 0; k < K; ++k, wd += D) {
        const float w = bf16 ? eegflow::bf16_round(*wd) : *wd;
        const float4* uv = reinterpret_cast<const float4*>(us + k * kT);
#pragma unroll
        for (int q = 0; q < kT / 4; ++q) {
          const float4 v = uv[q];
          a[4 * q + 0] = fmaf(v.x, w, a[4 * q + 0]);
          a[4 * q + 1] = fmaf(v.y, w, a[4 * q + 1]);
          a[4 * q + 2] = fmaf(v.z, w, a[4 * q + 2]);
          a[4 * q + 3] = fmaf(v.w, w, a[4 * q + 3]);
        }
      }
      const float gd = g[d];
      float dg = acc_dg[d], dbt = acc_dbt[d];
#pragma unroll
      for (int tt = 0; tt < kT; ++tt) {
        const float dy = tt < tc ? w_s[tt] * gd + a[tt] : 0.f;
        y[tt * D + d] = dy;
        if (use_ln && tt < tc) {
          dg += dy * xh[tt * D + d];
          dbt += dy;
        }
      }
      acc_dg[d] = dg;
      acc_dbt[d] = dbt;
    }
    __syncthreads();

    // LayerNorm backward, one warp per step
    for (int tt = warp; tt < tc; tt += kWarps) {
      const float* dyr = y + tt * D;
      const size_t bt = bt0 + tt;
      float m1 = 0.f, m2 = 0.f, rsig = rsig_s[tt];
      if (use_ln) {
        for (int d = lane; d < D; d += 32) {
          const float dxh = dyr[d] * gamma[d];
          m1 += dxh;
          m2 += dxh * xh[tt * D + d];
        }
        m1 = eegflow::warp_sum(m1) * inv_d;
        m2 = eegflow::warp_sum(m2) * inv_d;
      }
      for (int d = lane; d < D; d += 32) {
        float v = dyr[d];
        if (use_ln) v = rsig * (v * gamma[d] - m1 - xh[tt * D + d] * m2);
        if (d < d0)
          dh0[bt * d0 + d] = v;
        else
          dh1[bt * d1 + (d - d0)] = v;
      }
    }
    __syncthreads();  // the next chunk overwrites y, xh and the step arrays
  }

  float* out = vec_part + static_cast<size_t>(b) * (2 * K + 2 * D);
  for (int k = tid; k < K; k += kThreads) {
    out[k] = acc_db1[k];
    out[K + k] = acc_dw2[k];
  }
  for (int d = tid; d < D; d += kThreads) {
    out[2 * K + d] = acc_dg[d];
    out[2 * K + D + d] = acc_dbt[d];
  }
}

}  // namespace

// Operands of dW1 = bf16(y)^T . bf16(u) over the scratch rows (gemm.cuh).
namespace pool_head_bwd_ops {

struct RowsA {  // A(m = feature, k = b*T + t) = y_scr[k][m]
  static constexpr bool kMContiguous = true;
  const float* a;
  int M;
  __device__ float operator()(int m, int k) const { return a[static_cast<size_t>(k) * M + m]; }
};

struct RowsB {  // B(k = b*T + t, n = column) = u_scr[k][n]
  static constexpr bool kNContiguous = true;
  const float* b;
  int N;
  __device__ float operator()(int k, int n) const { return b[static_cast<size_t>(k) * N + n]; }
};

}  // namespace pool_head_bwd_ops

// x_p (B, T, d_p) float32; gamma, beta (d0 + d1,) or null without LN; w1
// (d0 + d1, K) and w1t (K, d0 + d1) float32; b1, w2 (K,); wts, gs (B, T);
// g_p (B, d_p); gctx (B,). Outputs dh_p (B, T, d_p), dw1 (d0 + d1, K) and
// vec (2K + 2(d0 + d1)) = [db1, dw2, dgamma, dbeta] float32. Scratch, float32:
// y_scr (B, T, d0 + d1), u_scr (B, T, K), vec_part (B, 2K + 2(d0 + d1)),
// part (splits * (d0 + d1) * K). x1, g1 and dh1 may be null when d1 == 0.
extern "C" int eegflow_pool_head_bwd(
    const float* x0, const float* x1, int d0, int d1, const float* gamma, const float* beta,
    const float* w1, const float* w1t, const float* b1, const float* w2, const float* wts,
    const float* gs, const float* g0, const float* g1, const float* gctx, float* dh0,
    float* dh1, float* dw1, float* vec, float* y_scr, float* u_scr, float* vec_part,
    float* part, int splits, int B, int T, int K, int use_ln, int bf16,
    cudaStream_t stream) {
  if (B <= 0 || T <= 0 || K <= 0 || d0 <= 0 || d1 < 0 || splits <= 0 ||
      (use_ln && (gamma == nullptr || beta == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int D = d0 + d1;
  const size_t smem =
      (3 * static_cast<size_t>(kT) * D + static_cast<size_t>(kT) * K + 3 * D + 2 * K +
       3 * kT) *
      sizeof(float);
  cudaError_t err = eegflow::allow_dynamic_smem(pool_head_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pool_head_bwd_kernel<<<B, kThreads, smem, stream>>>(
      x0, x1, d0, d1, gamma, beta, w1, w1t, b1, w2, wts, gs, g0, g1, gctx, dh0, dh1, y_scr,
      u_scr, vec_part, T, K, use_ln, bf16, 1e-5f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  using pool_head_bwd_ops::RowsA;
  using pool_head_bwd_ops::RowsB;
  err = eegflow::gemm_split_k(RowsA{y_scr, D}, RowsB{u_scr, K}, dw1, part, D, K, B * T,
                              splits, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t count = 2 * static_cast<size_t>(K) + 2 * static_cast<size_t>(D);
  eegflow::reduce_splits_kernel<<<static_cast<unsigned>((count + 255) / 256), 256, 0,
                                  stream>>>(vec_part, vec, B, count);
  return static_cast<int>(cudaGetLastError());
}
