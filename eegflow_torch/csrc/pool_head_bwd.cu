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
// What bounds it on the card: three products of 2 B T D K operations (the
// recomputed projection, dy and dW1: 34 GFLOP each at B = 512, T = 256,
// D = 512, K = 256). In bf16 they take 0.10 ms together at the tensor-core
// peak, below the bytes: x read and dh written once (0.54 GB, 0.16 ms). In
// float32 they take 1.54 ms at the CUDA-core peak (TF32 is off), and 0.62 ms
// as three TF32 products each at the TF32 peak (3xTF32, below). At H = 512
// (D = 1024, K = 512) the bf16 products are 412 GFLOP (0.42 ms), above the
// 1.07 GB of bytes (0.32 ms).
//
// Both modes share one structure. One CTA per batch row walks time in tiles
// of kM (b, t) rows. Per tile: one warp per row computes the LayerNorm
// statistics and y (float32) with shuffles, keeps y as a K-major tile in
// shared memory (and writes it to scratch for dW1), and ds. The two products
// run on the tensor cores in registers: proj = y[kM x D] . W1[D x K], then,
// after the epilogue forms u (into a second tile and the scratch), dy =
// u[kM x K] . W1^T[K x D]. W1 and W1^T stream through a ring of slices in
// shared memory with cp.async; each warp owns every row of the tile and
// 16-column pairs of the output. dy goes as float32 to shared memory, over
// the tiles and the ring, which the dy product no longer reads; then each
// warp forms dh (the LayerNorm backward, xhat recomputed from x) as the
// forward's LayerNorm pass does, and each lane sums dgamma and dbeta of its
// columns over its warp's rows, added over the warps in order at the end.
// db1 and dw2: per-column sums over a tile's rows reduced across lanes in a
// fixed order, added by the column's one owner thread into the CTA's
// partial row. dW1 = y^T . u over all B T rows runs on a split-K GEMM from
// the scratch. Every partial set is summed in a fixed order: no atomics, so
// the result repeats bit for bit.
//
// bf16 mode (pool_head_bwd_bf16_kernel): y and u rounded to bf16 (tiles and
// scratch), W1 and W1^T rounded to bf16 once per launch by the wrapper and
// streamed in 32-deep slices (mma_gemm.cuh's tile_mma, mma.sync m16n8k16);
// the product of two bf16 values is exact and the sums are float32, as the
// reference's preferred_element_type=float32; only the order of summation
// differs. dW1 on mma_gemm.cuh's tensor-core split-K from the bf16 scratch.
// Two width classes. D <= 512 and K <= 256 (the narrow class): 64-row tiles
// and a ring of three slices on 8 warps, one CTA a batch row. D <= 1024 and
// K <= 512 otherwise (the wide class, the classifier at H = 512;
// pool_head_bwd_wide_kernel): a cluster of two CTAs a batch row, each owning
// half of D and half of K (pool_head_wide.cuh), 64-row tiles on 16 warps.
// There one 32-deep slice of W1^T would be 66 KB and a 64-row y tile 132 KB,
// so a single CTA could take only 16 rows a tile, streaming all of W1 and
// W1^T (2 MiB) from L2 every 16 rows and feeding each slice to one m-tile of
// products: on an H100 that stream took 2.2 of the class's 6.2 ms, the
// products at M = 16 another 1.8, and the row-wise phases of a lone CTA per
// SM the rest (PERF.md). A cluster tile reads W1 once per 64 rows, in the
// CTA's own rows of W1 (Dh x K, 512 KB at most) for proj and their
// transpose for dy, through a ring of four 32-deep slices (tile_mma); y and
// u share one A tile, which the ring then fits beside.
//
// float32 mode (pool_head_bwd_f32_kernel): the same in 3xTF32 (mma_gemm.cuh:
// each float32 operand split into two TF32 parts as its fragment loads, three
// m16n8k8 products a tile, float32 accumulators, each product good to about
// 2^-21 relative). Float32 tiles are twice the bf16 ones, so a tile has 32
// rows on 16 warps (16 rows on 8 warps for D > 512 or K > 256, up to 1024 and
// 512), and B reaches the tensor cores transposed: proj streams W1^T and dy
// streams W1, in 16-deep slices (8 at 16 rows) through one ring of three
// stages of D rows (two at 16 rows), or twice as many of K rows. y and u go
// to float32 scratch, and dW1 runs on mma_gemm.cuh's tf32x3_gemm_split_k. On
// an H100 the products are bound by mma.sync's issue, not by streaming W1
// from L2 (PERF.md).

#include <math.h>

#include <algorithm>

#include "common.cuh"
#include "mma_gemm.cuh"
#include "pool_head_wide.cuh"

namespace {

// bf16 mode: kBThreads threads (8 warps), the W1 slices kSlice deep.
constexpr int kBThreads = 256;
constexpr int kBWarps = kBThreads / 32;
constexpr int kSlice = eegflow::kTileSlice;
constexpr int kMaxD = 512;  // the narrow class: D <= 512 and K <= 256
constexpr int kMaxK = 256;
// the narrow class's tiles of 16 kBMT rows, ring of kBStages slices and
// LayerNorm backward kBPair rows at a time
constexpr int kBMT = 4, kBStages = 3, kBPair = 2;

// bf16 mode's narrow class, one CTA per batch row: tiles of 16 kBMT (b, t)
// rows, a ring of kBStages slices, D <= kMaxD and K <= kMaxD / 2, so a warp
// owns at most kMaxD / 128 16-column pairs of dy and half as many of proj.
// Thread (warp w, lane = 4 g + q) holds, for m-tile i and n-tile j of its
// pairs, rows 16 i + g, 16 i + g + 8 and columns 16 pair + 8 (j % 2) + 2 q,
// + 1 of each
// product; in the row-wise phases warp w takes rows w, w + 8, .. (the
// LayerNorm backward: kBPair rows at a time, rows kBPair w .. kBPair w +
// kBPair - 1, then + 8 kBPair, ..) and lane l columns l + 32 i.
//   x_p (B, T, d_p) float32; w1b (D, K) and w1tb (K, D) bf16; y_scr (B T, D)
//   and u_scr (B T, K) bf16 scratch; vec_part (B, 2K + 2D) the row's
//   [db1, dw2, dgamma, dbeta] partials.
__global__ void __launch_bounds__(kBThreads, 1)
pool_head_bwd_bf16_kernel(const float* __restrict__ x0, const float* __restrict__ x1, int d0,
                          int d1, const float* __restrict__ gamma,
                          const float* __restrict__ beta, const __nv_bfloat16* __restrict__ w1b,
                          const __nv_bfloat16* __restrict__ w1tb, const float* __restrict__ b1,
                          const float* __restrict__ w2, const float* __restrict__ wts,
                          const float* __restrict__ gsc, const float* __restrict__ g0,
                          const float* __restrict__ g1, const float* __restrict__ gctx,
                          float* __restrict__ dh0, float* __restrict__ dh1,
                          __nv_bfloat16* __restrict__ y_scr, __nv_bfloat16* __restrict__ u_scr,
                          float* __restrict__ vec_part, int T, int K, int use_ln, float eps) {
  constexpr int kM = 16 * kBMT;
  constexpr int kCols = kMaxD / 32;           // columns of a row a lane owns
  constexpr int kNPp = kMaxD / 32 / kBWarps;  // 16-column pairs of proj a warp owns
  constexpr int kNPd = kMaxD / 16 / kBWarps;  // and of dy
  extern __shared__ __align__(16) uint8_t smem[];
  const int D = d0 + d1;
  const int lda_y = D + 8, lda_u = K + 8;
  const int stage_elems = kSlice * (max(D, K) + 8);
  __nv_bfloat16* const ys = reinterpret_cast<__nv_bfloat16*>(smem);  // [kM][D + 8]
  __nv_bfloat16* const us = ys + kM * lda_y;                          // [kM][K + 8]
  __nv_bfloat16* const ring = us + kM * lda_u;                        // [kBStages][stage]
  float* const g = reinterpret_cast<float*>(ring + kBStages * stage_elems);  // [D]
  float* const acc_db1 = g + D;         // [K]
  float* const acc_dw2 = acc_db1 + K;   // [K]
  float* const mu_s = acc_dw2 + K;      // [kM] per-row LayerNorm mean,
  float* const rsig_s = mu_s + kM;      // [kM] 1 / sigma,
  float* const ds_s = rsig_s + kM;      // [kM] ds and
  float* const w_s = ds_s + kM;         // [kM] softmax weight
  // dy as float32, [kM][D + 8], over the two tiles and the ring once the
  // dy product is done with them (they hold at least twice its bytes)
  float* const dys = reinterpret_cast<float*>(smem);
  const int ldd = D + 8;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const float inv_d = 1.0f / static_cast<float>(D);
  const float gc = gctx[b];
  for (int d = tid; d < D; d += kBThreads)
    g[d] = d < d0 ? g0[static_cast<size_t>(b) * d0 + d] : g1[static_cast<size_t>(b) * d1 + d - d0];
  for (int k = tid; k < K; k += kBThreads) acc_db1[k] = acc_dw2[k] = 0.f;
  // dgamma and dbeta of the lane's columns lane + 32 i over its warp's rows
  float pdg[kCols], pdb[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) pdg[i] = pdb[i] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < T; t0 += kM) {
    // LayerNorm (recomputed), bf16(y) into the tile and the scratch, ds
    for (int r = warp; r < kM; r += kBWarps) {
      const int t = t0 + r;
      const bool valid = t < T;
      const size_t bt = static_cast<size_t>(b) * T + t;
      float xv[kCols];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int d = lane + 32 * i;
        float v = 0.f;
        if (valid && d < D) v = d < d0 ? x0[bt * d0 + d] : x1[bt * d1 + (d - d0)];
        xv[i] = v;
        s1 += v;
        s2 += v * v;
      }
      float mu = 0.f, rsig = 1.f;
      if (use_ln) {
        s1 = eegflow::warp_sum(s1);
        s2 = eegflow::warp_sum(s2);
        mu = s1 * inv_d;
        rsig = rsqrtf(s2 * inv_d - mu * mu + eps);
      }
      float gy = 0.f;
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int d = lane + 32 * i;
        if (d >= D) continue;
        float v = xv[i];
        if (use_ln) v = (v - mu) * rsig * gamma[d] + beta[d];
        if (!valid) v = 0.f;
        const __nv_bfloat16 vb = __float2bfloat16_rn(v);
        ys[r * lda_y + d] = vb;
        if (valid) y_scr[bt * D + d] = vb;
        gy += g[d] * v;
      }
      gy = eegflow::warp_sum(gy);
      if (lane == 0) {
        const float w = valid ? wts[bt] : 0.f;
        mu_s[r] = mu;
        rsig_s[r] = rsig;
        w_s[r] = w;
        ds_s[r] = valid ? w * (gy - gc) + gsc[bt] : 0.f;
      }
    }
    __syncthreads();

    // proj = bf16(y) . bf16(W1); u = ds (1 - proj^2) w2; db1, dw2
    {
      float acc[kBMT][2 * kNPp][4];
#pragma unroll
      for (int i = 0; i < kBMT; ++i)
#pragma unroll
        for (int j = 0; j < 2 * kNPp; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      eegflow::tile_mma<kBMT, kNPp, kBStages, kBWarps>(acc, ys, lda_y, w1b, K, D, K, ring,
                                                       stage_elems);
#pragma unroll
      for (int j = 0; j < 2 * kNPp; ++j) {
        const int pair = warp + kBWarps * (j / 2);
        if (pair >= K / 16) continue;
        const int col = pair * 16 + 8 * (j % 2) + 2 * q;
        const float bk[2] = {b1[col], b1[col + 1]}, w2k[2] = {w2[col], w2[col + 1]};
        float sdb[2] = {0.f, 0.f}, sdw[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < kBMT; ++i)
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            const int row = 16 * i + 8 * rh + gq;
            const float ds = ds_s[row];
            float u[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float pr = tanhf(acc[i][j][2 * rh + e] + bk[e]);
              u[e] = ds * (1.f - pr * pr) * w2k[e];
              sdb[e] += u[e];
              sdw[e] += ds * pr;
            }
            const __nv_bfloat162 ub = __floats2bfloat162_rn(u[0], u[1]);
            *reinterpret_cast<__nv_bfloat162*>(us + row * lda_u + col) = ub;
            if (t0 + row < T)
              *reinterpret_cast<__nv_bfloat162*>(
                  u_scr + (static_cast<size_t>(b) * T + t0 + row) * K + col) = ub;
          }
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            sdb[e] += __shfl_xor_sync(0xffffffffu, sdb[e], off);
            sdw[e] += __shfl_xor_sync(0xffffffffu, sdw[e], off);
          }
        if (gq == 0) {
          acc_db1[col] += sdb[0];
          acc_db1[col + 1] += sdb[1];
          acc_dw2[col] += sdw[0];
          acc_dw2[col + 1] += sdw[1];
        }
      }
    }
    __syncthreads();  // the u tile is whole; no thread reads the ring

    // dy = w g + bf16(u) . bf16(W1)^T, staged as float32 in shared memory
    {
      float acc[kBMT][2 * kNPd][4];
#pragma unroll
      for (int i = 0; i < kBMT; ++i)
#pragma unroll
        for (int j = 0; j < 2 * kNPd; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      eegflow::tile_mma<kBMT, kNPd, kBStages, kBWarps>(acc, us, lda_u, w1tb, D, K, D, ring,
                                                       stage_elems);
      __syncthreads();  // no thread reads the tiles or the ring any more
#pragma unroll
      for (int j = 0; j < 2 * kNPd; ++j) {
        const int pair = warp + kBWarps * (j / 2);
        if (pair >= D / 16) continue;
        const int col = pair * 16 + 8 * (j % 2) + 2 * q;
#pragma unroll
        for (int i = 0; i < kBMT; ++i)
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            const int row = 16 * i + 8 * rh + gq;
            *reinterpret_cast<float2*>(dys + row * ldd + col) =
                make_float2(w_s[row] * g[col] + acc[i][j][2 * rh],
                            w_s[row] * g[col + 1] + acc[i][j][2 * rh + 1]);
          }
      }
    }
    __syncthreads();

    // the LayerNorm backward, one warp per kBPair rows (their loads in flight
    // together), and dgamma, dbeta
    for (int r0 = kBPair * warp; r0 < kM; r0 += kBPair * kBWarps) {
      float xh[kBPair][kCols];
      float m1[kBPair], m2[kBPair];
#pragma unroll
      for (int rr = 0; rr < kBPair; ++rr) m1[rr] = m2[rr] = 0.f;
      if (use_ln) {
#pragma unroll
        for (int rr = 0; rr < kBPair; ++rr) {
          const int t = t0 + r0 + rr;
          const size_t bt = static_cast<size_t>(b) * T + min(t, T - 1);
#pragma unroll
          for (int i = 0; i < kCols; ++i) {
            const int d = lane + 32 * i;
            float x = 0.f;
            if (t < T && d < D) x = d < d0 ? x0[bt * d0 + d] : x1[bt * d1 + (d - d0)];
            xh[rr][i] = x;
          }
        }
#pragma unroll
        for (int rr = 0; rr < kBPair; ++rr) {
          const int r = r0 + rr;
          if (t0 + r >= T) continue;
          const float* dyr = dys + r * ldd;
#pragma unroll
          for (int i = 0; i < kCols; ++i) {
            const int d = lane + 32 * i;
            if (d >= D) continue;
            xh[rr][i] = (xh[rr][i] - mu_s[r]) * rsig_s[r];
            const float dy = dyr[d];
            const float dxh = dy * gamma[d];
            m1[rr] += dxh;
            m2[rr] += dxh * xh[rr][i];
            pdg[i] += dy * xh[rr][i];
            pdb[i] += dy;
          }
          m1[rr] = eegflow::warp_sum(m1[rr]) * inv_d;
          m2[rr] = eegflow::warp_sum(m2[rr]) * inv_d;
        }
      }
#pragma unroll
      for (int rr = 0; rr < kBPair; ++rr) {
        const int r = r0 + rr;
        const int t = t0 + r;
        if (t >= T) continue;
        const size_t bt = static_cast<size_t>(b) * T + t;
        const float* dyr = dys + r * ldd;
        const float rsig = rsig_s[r];
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          const int d = lane + 32 * i;
          if (d >= D) continue;
          float v = dyr[d];
          if (use_ln) v = rsig * (v * gamma[d] - m1[rr] - xh[rr][i] * m2[rr]);
          if (d < d0)
            dh0[bt * d0 + d] = v;
          else
            dh1[bt * d1 + (d - d0)] = v;
        }
      }
    }
    __syncthreads();  // the next tile overwrites the tiles and the row stats
  }

  // the warps' dgamma and dbeta summed in warp order
  float* const part_s = dys;  // [kBWarps][2][D]
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const int d = lane + 32 * i;
    if (d >= D) continue;
    part_s[2 * warp * D + d] = pdg[i];
    part_s[(2 * warp + 1) * D + d] = pdb[i];
  }
  __syncthreads();
  float* out = vec_part + static_cast<size_t>(b) * (2 * K + 2 * D);
  for (int k = tid; k < K; k += kBThreads) {
    out[k] = acc_db1[k];
    out[K + k] = acc_dw2[k];
  }
  for (int d = tid; d < D; d += kBThreads) {
    float dg = 0.f, dbt = 0.f;
    for (int w = 0; w < kBWarps; ++w) {
      dg += part_s[2 * w * D + d];
      dbt += part_s[(2 * w + 1) * D + d];
    }
    out[2 * K + d] = dg;
    out[2 * K + D + d] = dbt;
  }
}

// shared memory of pool_head_bwd_bf16_kernel: the y and u tiles, the ring,
// then g, db1, dw2 and the row statistics
size_t narrow_bwd_smem(int D, int K) {
  const size_t rows = 16 * kBMT;
  const size_t elems = rows * (D + 8) + rows * (K + 8) +
                       static_cast<size_t>(kBStages) * kSlice * (std::max(D, K) + 8);
  const size_t floats = static_cast<size_t>(D) + 2 * K + 4 * rows;
  return elems * 2 + floats * 4;
}

cudaError_t launch_bf16(const float* x0, const float* x1, int d0, int d1, const float* gamma,
                        const float* beta, const __nv_bfloat16* w1b, const __nv_bfloat16* w1tb,
                        const float* b1, const float* w2, const float* wts, const float* gs,
                        const float* g0, const float* g1, const float* gctx, float* dh0,
                        float* dh1, __nv_bfloat16* y_scr, __nv_bfloat16* u_scr,
                        float* vec_part, int B, int T, int K, int use_ln, cudaStream_t stream) {
  const size_t smem = narrow_bwd_smem(d0 + d1, K);
  auto kernel = pool_head_bwd_bf16_kernel;
  cudaError_t err = eegflow::allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, kBThreads, smem, stream>>>(x0, x1, d0, d1, gamma, beta, w1b, w1tb, b1, w2, wts, gs,
                                         g0, g1, gctx, dh0, dh1, y_scr, u_scr, vec_part, T, K,
                                         use_ln, 1e-5f);
  return cudaGetLastError();
}

// bf16 mode's wide class: one cluster of two CTAs per batch row
// (pool_head_wide.cuh), 64-row tiles on 16 warps; D = d0 + d1 <= 1024 and
// K <= 512, CTA `rank` owning the columns [c0, c0 + Dh) of x, y, dy and dh
// and [k0, k0 + Kh) of proj and u. Per tile, with five cluster barriers:
//   L: the LayerNorm sums of x and x^2 over each half;
//   A: bf16(y) of the own half into the A tile and the scratch, the half's
//      g . y, and the partial proj = bf16(y_half) . bf16(W1[half, :]) over
//      all K columns, W1's rows of the half streamed;
//   B: the partner's columns of the partial pushed into its ring;
//   C: the own columns' proj (the two partials added), u into both CTAs' A
//      tiles (over y) and the scratch, db1 and dw2 (added a tile at a time by
//      the column's one owner thread);
//   dy of the own half = w g + bf16(u) . bf16(W1)^T over all of K (W1^T's
//   columns of the half streamed), staged as float32 over the A tile and the
//   ring;
//   D: the LayerNorm backward's sums of dy gamma and dy gamma xhat over
//      each half;
//   then dh, and the warps' dgamma and dbeta of the tile, added over the
//   warps in order by the column's thread. The two halves' sums of a row add
//   as rank 0's + rank 1's in both CTAs. Thread (warp w, lane = 4 g + q)
//   holds, for m-tile i and n-tile j, rows 16 i + g, + 8 and columns
//   16 pair + 8 (j % 2) + 2 q, + 1 of each product (pair = w + 16 (j / 2)); in
//   the row-wise phases warp w takes rows 2 w + 32 p, + 1 and lane l the
//   half's columns l + 32 i (pool_head_wide.cuh), x read again in each; thread
//   tid sums dgamma and dbeta of the half's column tid.
//   Arguments as pool_head_bwd_bf16_kernel's.
__host__ __device__ inline size_t wide_bwd_region(int half_d, int K) {
  // the A tile (y, then u) and the ring; over them dy (float32) and the
  // warps' dgamma and dbeta
  const size_t tiles = 2 * (static_cast<size_t>(eegflow::wide_tile_elems(half_d, K)) +
                            static_cast<size_t>(eegflow::kWideStages) *
                                eegflow::wide_stage_elems(half_d, K));
  const size_t dy = 4 * (static_cast<size_t>(eegflow::kWideRows) * (half_d + 8) +
                         2 * static_cast<size_t>(eegflow::kWideWarps) * half_d);
  return tiles > dy ? tiles : dy;
}

__global__ void __launch_bounds__(eegflow::kWideThreads, 1)
pool_head_bwd_wide_kernel(const float* __restrict__ x0, const float* __restrict__ x1, int d0,
                          int d1, const float* __restrict__ gamma,
                          const float* __restrict__ beta, const __nv_bfloat16* __restrict__ w1b,
                          const __nv_bfloat16* __restrict__ w1tb, const float* __restrict__ b1,
                          const float* __restrict__ w2, const float* __restrict__ wts,
                          const float* __restrict__ gsc, const float* __restrict__ g0,
                          const float* __restrict__ g1, const float* __restrict__ gctx,
                          float* __restrict__ dh0, float* __restrict__ dh1,
                          __nv_bfloat16* __restrict__ y_scr, __nv_bfloat16* __restrict__ u_scr,
                          float* __restrict__ vec_part, int T, int K, int use_ln, float eps) {
  constexpr int kM = eegflow::kWideRows, kMT = eegflow::kWideMT, kW = eegflow::kWideWarps;
  constexpr int kNT = eegflow::kWideThreads, kNP = eegflow::kWideNP;
  constexpr int kHC = eegflow::kWideLaneCols;
  static_assert(kNT >= eegflow::kWideMaxHalfD, "a thread a column of the half");
  extern __shared__ __align__(16) uint8_t smem[];
  const int D = d0 + d1, Dh = D / 2, Kh = K / 2;
  const uint32_t rank = eegflow::cluster_rank(), partner = rank ^ 1u;
  const int c0 = static_cast<int>(rank) * Dh, k0 = static_cast<int>(rank) * Kh;
  const int pk0 = static_cast<int>(partner) * Kh;
  const int b = blockIdx.x >> 1;
  const int lda_y = Dh + 8, lda_u = K + 8, ldd = Dh + 8, ldi = Kh + 4;
  const int stage_elems = eegflow::wide_stage_elems(Dh, K);
  // the A tile: bf16(y) [kM][Dh + 8] until proj, then bf16(u) [kM][K + 8]
  __nv_bfloat16* const ys = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const us = ys;
  __nv_bfloat16* const ring = ys + eegflow::wide_tile_elems(Dh, K);  // [kWideStages][stage]
  float* const inbox = reinterpret_cast<float*>(ring);  // the partner's partial, [kM][Kh + 4]
  float* const dys = reinterpret_cast<float*>(smem);    // dy, [kM][Dh + 8] over the tiles
  float* const part = dys + kM * ldd;  // [kW][2][Dh] the warps' dgamma and dbeta of a tile
  float* const g = reinterpret_cast<float*>(smem + wide_bwd_region(Dh, K));  // [Dh]
  float* const acc_db1 = g + Dh;     // [Kh]
  float* const acc_dw2 = acc_db1 + Kh;  // [Kh]
  float* const ln_x = acc_dw2 + Kh;  // [2][kM][2] each rank's half sums of x and x^2
  float* const gy_x = ln_x + 4 * kM;  // [2][kM][2] each rank's half g . y (and an unused 0)
  float* const m_x = gy_x + 4 * kM;   // [2][kM][2] each rank's half sums of dy gamma (xhat)
  float* const mu_s = m_x + 4 * kM;   // [kM] per-row LayerNorm mean,
  float* const rsig_s = mu_s + kM;    // [kM] 1 / sigma,
  float* const ds_s = rsig_s + kM;    // [kM] ds and
  float* const w_s = ds_s + kM;       // [kM] softmax weight

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const float inv_d = 1.0f / static_cast<float>(D);
  const float gc = gctx[b];
  // x of rows r0, r0 + 1 of the tile at step bt0, the half's columns
  // lane + 32 i (0 past the tile's tc rows or the half)
  auto load_pair = [&](size_t bt0, int r0, int tc, float (&xv)[2][kHC]) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int i = 0; i < kHC; ++i) {
        const int dl = lane + 32 * i, d = c0 + dl;
        const size_t bt = bt0 + r0 + rr;
        xv[rr][i] = r0 + rr < tc && dl < Dh
                        ? (d < d0 ? x0[bt * d0 + d] : x1[bt * d1 + (d - d0)])
                        : 0.f;
      }
  };
  for (int d = tid; d < Dh; d += kNT) {
    const int gd = c0 + d;
    g[d] = gd < d0 ? g0[static_cast<size_t>(b) * d0 + gd]
                   : g1[static_cast<size_t>(b) * d1 + gd - d0];
  }
  for (int k = tid; k < Kh; k += kNT) acc_db1[k] = acc_dw2[k] = 0.f;
  float pdg = 0.f, pdb = 0.f;  // dgamma, dbeta of the half's column tid
  eegflow::pair_sync();  // both CTAs run before either stores into the other
  EEGFLOW_WIDE_MARK(0);

  for (int t0 = 0; t0 < T; t0 += kM) {
    const int tc = min(kM, T - t0);
    const size_t bt0 = static_cast<size_t>(b) * T + t0;
    // L: the halves' LayerNorm sums
    if (use_ln) {
      for (int r0 = 2 * warp; r0 < kM; r0 += 2 * kW) {
        float xv[2][kHC];
        load_pair(bt0, r0, tc, xv);
        float sums[2][2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          sums[rr][0] = sums[rr][1] = 0.f;
#pragma unroll
          for (int i = 0; i < kHC; ++i) {
            sums[rr][0] += xv[rr][i];
            sums[rr][1] += xv[rr][i] * xv[rr][i];
          }
        }
        eegflow::push_pair_sums(sums, r0, ln_x, rank, partner);
      }
      eegflow::pair_sync();
    }
    EEGFLOW_WIDE_MARK(1);
    // bf16(y) of the own half into the A tile and the scratch; the half's
    // g . y
    for (int r0 = 2 * warp; r0 < kM; r0 += 2 * kW) {
      float xv[2][kHC];
      load_pair(bt0, r0, tc, xv);
      float gy[2][2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = r0 + rr;
        const bool valid = r < tc;
        float2 st = make_float2(0.f, 1.f);
        if (use_ln) st = eegflow::ln_stats(ln_x, r, inv_d, eps);
        gy[rr][0] = gy[rr][1] = 0.f;
#pragma unroll
        for (int i = 0; i < kHC; ++i) {
          const int dl = lane + 32 * i;
          if (dl >= Dh) continue;
          float v = xv[rr][i];
          if (use_ln) v = (v - st.x) * st.y * gamma[c0 + dl] + beta[c0 + dl];
          if (!valid) v = 0.f;
          const __nv_bfloat16 vb = __float2bfloat16_rn(v);
          ys[r * lda_y + dl] = vb;
          if (valid) y_scr[(bt0 + r) * D + c0 + dl] = vb;
          gy[rr][0] += g[dl] * v;
        }
        if (lane == rr) {
          mu_s[r] = st.x;
          rsig_s[r] = st.y;
          w_s[r] = valid ? wts[bt0 + r] : 0.f;
        }
      }
      eegflow::push_pair_sums(gy, r0, gy_x, rank, partner);
    }
    EEGFLOW_WIDE_MARK(2);

    // A, B, C: proj = bf16(y) . bf16(W1) from the two halves' partials;
    // u = ds (1 - proj^2) w2 of the own columns; db1, dw2
    {
      float acc[kMT][2 * kNP][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < 2 * kNP; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      eegflow::tile_mma<kMT, kNP, eegflow::kWideStages, kW, true>(
          acc, ys, lda_y, w1b + static_cast<size_t>(c0) * K, K, Dh, K, ring, stage_elems);
      EEGFLOW_WIDE_MARK(3);
      eegflow::pair_sync();  // A: both products are done; the halves' g . y have landed
      EEGFLOW_WIDE_MARK(4);
      eegflow::push_partial<kNP>(acc, eegflow::map_rank(eegflow::smem_addr(inbox), partner), K,
                                 pk0, Kh);
      if (tid < kM)
        ds_s[tid] = tid < tc
                        ? w_s[tid] * (gy_x[2 * tid] + gy_x[2 * (kM + tid)] - gc) + gsc[bt0 + tid]
                        : 0.f;
      eegflow::pair_sync();  // B: the partner's partial has landed; ds is in place
      EEGFLOW_WIDE_MARK(5);
      const uint32_t us_remote = eegflow::map_rank(eegflow::smem_addr(us), partner);
#pragma unroll
      for (int j = 0; j < 2 * kNP; ++j) {
        const int pair = warp + kW * (j / 2);
        const int col = pair * 16 + 8 * (j % 2) + 2 * q;
        if (pair >= K / 16 || col < k0 || col >= k0 + Kh) continue;
        const float bk[2] = {b1[col], b1[col + 1]}, w2k[2] = {w2[col], w2[col + 1]};
        float sdb[2] = {0.f, 0.f}, sdw[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            const int row = 16 * i + 8 * rh + gq;
            const float ds = ds_s[row];
            const float2 other = *reinterpret_cast<const float2*>(inbox + row * ldi + col - k0);
            const float sum[2] = {acc[i][j][2 * rh] + other.x, acc[i][j][2 * rh + 1] + other.y};
            float u[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float pr = tanhf(sum[e] + bk[e]);
              u[e] = ds * (1.f - pr * pr) * w2k[e];
              sdb[e] += u[e];
              sdw[e] += ds * pr;
            }
            const uint32_t ub = eegflow::pack_bf16(u[0], u[1]);
            const int off = row * lda_u + col;
            *reinterpret_cast<uint32_t*>(us + off) = ub;
            eegflow::st_cluster_u32(us_remote + 2u * static_cast<uint32_t>(off), ub);
            if (row < tc) *reinterpret_cast<uint32_t*>(u_scr + (bt0 + row) * K + col) = ub;
          }
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            sdb[e] += __shfl_xor_sync(0xffffffffu, sdb[e], off);
            sdw[e] += __shfl_xor_sync(0xffffffffu, sdw[e], off);
          }
        if (gq == 0) {
          acc_db1[col - k0] += sdb[0];
          acc_db1[col - k0 + 1] += sdb[1];
          acc_dw2[col - k0] += sdw[0];
          acc_dw2[col - k0 + 1] += sdw[1];
        }
      }
    }
    EEGFLOW_WIDE_MARK(6);
    eegflow::pair_sync();  // C: the u tiles are whole; no thread reads its inbox any more
    EEGFLOW_WIDE_MARK(7);

    // dy of the own half = w g + bf16(u) . bf16(W1)^T, staged as float32
    {
      float acc[kMT][2 * kNP][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < 2 * kNP; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      eegflow::tile_mma<kMT, kNP, eegflow::kWideStages, kW, true>(
          acc, us, lda_u, w1tb + c0, D, K, Dh, ring, stage_elems);
      __syncthreads();  // no thread reads the tiles or the ring any more
      EEGFLOW_WIDE_MARK(8);
#pragma unroll
      for (int j = 0; j < 2 * kNP; ++j) {
        const int pair = warp + kW * (j / 2);
        if (pair >= Dh / 16) continue;
        const int col = pair * 16 + 8 * (j % 2) + 2 * q;
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            const int row = 16 * i + 8 * rh + gq;
            *reinterpret_cast<float2*>(dys + row * ldd + col) =
                make_float2(w_s[row] * g[col] + acc[i][j][2 * rh],
                            w_s[row] * g[col + 1] + acc[i][j][2 * rh + 1]);
          }
      }
    }
    __syncthreads();
    EEGFLOW_WIDE_MARK(9);

    // D: the halves' sums of the LayerNorm backward
    if (use_ln) {
      for (int r0 = 2 * warp; r0 < kM; r0 += 2 * kW) {
        float xv[2][kHC];
        load_pair(bt0, r0, tc, xv);
        float m[2][2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int r = r0 + rr;
          const float mu = mu_s[r], rsig = rsig_s[r];
          m[rr][0] = m[rr][1] = 0.f;
#pragma unroll
          for (int i = 0; i < kHC; ++i) {
            const int dl = lane + 32 * i;
            if (dl >= Dh) continue;
            const float dxh = dys[r * ldd + dl] * gamma[c0 + dl];
            m[rr][0] += dxh;
            m[rr][1] += dxh * ((xv[rr][i] - mu) * rsig);
          }
        }
        eegflow::push_pair_sums(m, r0, m_x, rank, partner);
      }
      eegflow::pair_sync();
    }
    EEGFLOW_WIDE_MARK(10);
    // dh; the warps' dgamma and dbeta of the tile, then added in warp order
    {
      float pg[kHC], pb[kHC];
#pragma unroll
      for (int i = 0; i < kHC; ++i) pg[i] = pb[i] = 0.f;
      for (int r0 = 2 * warp; r0 < kM; r0 += 2 * kW) {
        float xv[2][kHC];
        if (use_ln) load_pair(bt0, r0, tc, xv);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int r = r0 + rr;
          if (r >= tc) continue;
          const size_t bt = bt0 + r;
          const float mu = mu_s[r], rsig = rsig_s[r];
          float m1 = 0.f, m2 = 0.f;
          if (use_ln) {
            m1 = (m_x[2 * r] + m_x[2 * (kM + r)]) * inv_d;
            m2 = (m_x[2 * r + 1] + m_x[2 * (kM + r) + 1]) * inv_d;
          }
#pragma unroll
          for (int i = 0; i < kHC; ++i) {
            const int dl = lane + 32 * i;
            if (dl >= Dh) continue;
            const int d = c0 + dl;
            const float dy = dys[r * ldd + dl];
            float v = dy;
            if (use_ln) {
              const float xhat = (xv[rr][i] - mu) * rsig;
              v = rsig * (dy * gamma[d] - m1 - xhat * m2);
              pg[i] += dy * xhat;
              pb[i] += dy;
            }
            if (d < d0)
              dh0[bt * d0 + d] = v;
            else
              dh1[bt * d1 + (d - d0)] = v;
          }
        }
      }
      if (use_ln) {
#pragma unroll
        for (int i = 0; i < kHC; ++i) {
          const int dl = lane + 32 * i;
          if (dl >= Dh) continue;
          part[2 * warp * Dh + dl] = pg[i];
          part[(2 * warp + 1) * Dh + dl] = pb[i];
        }
        __syncthreads();
        if (tid < Dh) {
          float sg = 0.f, sb = 0.f;
          for (int w = 0; w < kW; ++w) {
            sg += part[2 * w * Dh + tid];
            sb += part[(2 * w + 1) * Dh + tid];
          }
          pdg += sg;
          pdb += sb;
        }
      }
    }
    __syncthreads();  // the next tile overwrites the tiles and the row stats
    EEGFLOW_WIDE_MARK(11);
  }

  // the batch row's partials of the own columns (no store into the partner
  // follows the last tile's barrier)
  float* out = vec_part + static_cast<size_t>(b) * (2 * K + 2 * D);
  for (int k = tid; k < Kh; k += kNT) {
    out[k0 + k] = acc_db1[k];
    out[K + k0 + k] = acc_dw2[k];
  }
  if (tid < Dh) {
    out[2 * K + c0 + tid] = pdg;
    out[2 * K + D + c0 + tid] = pdb;
  }
}

// shared memory of pool_head_bwd_wide_kernel: the tiles, then g, db1, dw2
// and the row sums
size_t wide_bwd_smem(int D, int K) {
  const size_t floats = static_cast<size_t>(D / 2) + K + 16 * eegflow::kWideRows;
  return wide_bwd_region(D / 2, K) + floats * sizeof(float);
}

// float32 mode: a tile of 16 kMT (b, t) rows of one batch row, kWarps
// warps, W1 and W1^T streamed transposed in kSlice-deep slices through a
// ring of kStages stages of D rows (dy) or 2 kStages of K rows (proj: the
// same bytes in flight at K = D / 2). kMT = 2 takes D <= 512 and K <= 256
// on 16 warps, kMT = 1 up to 1024 and 512 on 8 (the lanes' dgamma and dbeta
// of 1024 columns would not fit 16 warps' registers): a warp owns at most
// 64 / kMT / kWarps 16-column pairs of proj and 128 / kMT / kWarps of dy.
//   Thread (warp w, lane = 4 g + q) holds, for m-tile i and n-tile j of its
// pairs, rows 16 i + g, + 8 and columns 16 pair + 8 (j % 2) + 2 q, + 1 of
// each product; in the row-wise phases warp w takes rows w, w + kWarps, ..
// and lane l columns l + 32 i.
//   x_p (B, T, d_p) float32; w1 (D, K) and w1t (K, D) float32; y_scr (B T, D)
// and u_scr (B T, K) float32 scratch; vec_part (B, 2K + 2D) the row's [db1,
// dw2, dgamma, dbeta] partials.
template <int kMT, int kSlice, int kStages, int kWarps>
__global__ void __launch_bounds__(32 * kWarps, 1)
pool_head_bwd_f32_kernel(const float* __restrict__ x0, const float* __restrict__ x1, int d0,
                         int d1, const float* __restrict__ gamma, const float* __restrict__ beta,
                         const float* __restrict__ w1, const float* __restrict__ w1t,
                         const float* __restrict__ b1, const float* __restrict__ w2,
                         const float* __restrict__ wts, const float* __restrict__ gsc,
                         const float* __restrict__ g0, const float* __restrict__ g1,
                         const float* __restrict__ gctx, float* __restrict__ dh0,
                         float* __restrict__ dh1, float* __restrict__ y_scr,
                         float* __restrict__ u_scr, float* __restrict__ vec_part, int T, int K,
                         int use_ln, float eps) {
  constexpr int kRows = 16 * kMT;
  constexpr int kThreads = 32 * kWarps;
  constexpr int kDMax = 1024 / kMT;             // the widest D (and 2 K) of this tile
  constexpr int kNPp = kDMax / 32 / kWarps;     // 16-column pairs of proj a warp owns
  constexpr int kNPd = kDMax / 16 / kWarps;     // and of dy
  constexpr int kCols = kDMax / 32;             // columns of a row a lane owns
  extern __shared__ __align__(16) uint8_t smem[];
  const int D = d0 + d1;
  const int lda_y = D + 4, lda_u = K + 4;
  const int ldr = kSlice + 4;
  float* const ys = reinterpret_cast<float*>(smem);  // [kRows][D + 4]
  float* const us = ys + kRows * lda_y;               // [kRows][K + 4]
  float* const ring = us + kRows * lda_u;             // the ring's stages
  float* const g = ring + max(2 * kStages * K, kStages * D) * ldr;  // [D]
  float* const acc_db1 = g + D;                       // [K]
  float* const acc_dw2 = acc_db1 + K;                 // [K]
  float* const mu_s = acc_dw2 + K;                    // [kRows] per-row LayerNorm mean,
  float* const rsig_s = mu_s + kRows;                 // [kRows] 1 / sigma,
  float* const ds_s = rsig_s + kRows;                 // [kRows] ds and
  float* const w_s = ds_s + kRows;                    // [kRows] softmax weight
  // dy as float32 over the y tile, which no thread reads after the proj
  // product
  float* const dys = ys;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const float inv_d = 1.0f / static_cast<float>(D);
  const float gc = gctx[b];
  for (int d = tid; d < D; d += kThreads)
    g[d] = d < d0 ? g0[static_cast<size_t>(b) * d0 + d] : g1[static_cast<size_t>(b) * d1 + d - d0];
  for (int k = tid; k < K; k += kThreads) acc_db1[k] = acc_dw2[k] = 0.f;
  // x of step t, the lane's columns lane + 32 i (0 past D or past T)
  auto load_row = [&](int t, float (&xv)[kCols]) {
    const size_t bt = static_cast<size_t>(b) * T + min(t, T - 1);
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int d = lane + 32 * i;
      xv[i] = t < T && d < D ? (d < d0 ? x0[bt * d0 + d] : x1[bt * d1 + (d - d0)]) : 0.f;
    }
  };
  // dgamma and dbeta of the lane's columns over its warp's rows
  float pdg[kCols], pdb[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) pdg[i] = pdb[i] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < T; t0 += kRows) {
    // LayerNorm (recomputed), y into the tile and the scratch, ds
    for (int r = warp; r < kRows; r += kWarps) {
      const int t = t0 + r;
      const bool valid = t < T;
      const size_t bt = static_cast<size_t>(b) * T + t;
      float xv[kCols];
      load_row(t, xv);
      float mu = 0.f, rsig = 1.f;
      if (use_ln) {
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          s1 += xv[i];
          s2 += xv[i] * xv[i];
        }
        s1 = eegflow::warp_sum(s1);
        s2 = eegflow::warp_sum(s2);
        mu = s1 * inv_d;
        rsig = rsqrtf(s2 * inv_d - mu * mu + eps);
      }
      float gy = 0.f;
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int d = lane + 32 * i;
        if (d >= D) continue;
        float v = xv[i];
        if (use_ln) v = (v - mu) * rsig * gamma[d] + beta[d];
        if (!valid) v = 0.f;
        ys[r * lda_y + d] = v;
        if (valid) y_scr[bt * D + d] = v;
        gy += g[d] * v;
      }
      gy = eegflow::warp_sum(gy);
      if (lane == 0) {
        const float w = valid ? wts[bt] : 0.f;
        mu_s[r] = mu;
        rsig_s[r] = rsig;
        w_s[r] = w;
        ds_s[r] = valid ? w * (gy - gc) + gsc[bt] : 0.f;
      }
    }
    __syncthreads();

    // proj = y . W1; u = ds (1 - proj^2) w2; db1, dw2
    {
      float acc[kMT][2 * kNPp][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < 2 * kNPp; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      eegflow::tile_mma_tf32x3<kMT, kNPp, kSlice, 2 * kStages, kWarps>(acc, ys, lda_y, w1t, D,
                                                                        K, ring, K * ldr);
#pragma unroll
      for (int j = 0; j < 2 * kNPp; ++j) {
        const int pair = warp + kWarps * (j / 2);
        if (pair >= K / 16) continue;
        const int col = pair * 16 + 8 * (j % 2) + 2 * q;
        const float bk[2] = {b1[col], b1[col + 1]}, w2k[2] = {w2[col], w2[col + 1]};
        float sdb[2] = {0.f, 0.f}, sdw[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            const int row = 16 * i + 8 * rh + gq;
            const float ds = ds_s[row];
            float u[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float pr = tanhf(acc[i][j][2 * rh + e] + bk[e]);
              u[e] = ds * (1.f - pr * pr) * w2k[e];
              sdb[e] += u[e];
              sdw[e] += ds * pr;
            }
            const float2 u2 = make_float2(u[0], u[1]);
            *reinterpret_cast<float2*>(us + row * lda_u + col) = u2;
            if (t0 + row < T)
              *reinterpret_cast<float2*>(u_scr + (static_cast<size_t>(b) * T + t0 + row) * K +
                                         col) = u2;
          }
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            sdb[e] += __shfl_xor_sync(0xffffffffu, sdb[e], off);
            sdw[e] += __shfl_xor_sync(0xffffffffu, sdw[e], off);
          }
        if (gq == 0) {
          acc_db1[col] += sdb[0];
          acc_db1[col + 1] += sdb[1];
          acc_dw2[col] += sdw[0];
          acc_dw2[col + 1] += sdw[1];
        }
      }
    }
    __syncthreads();  // the u tile is whole; no thread reads the ring or the y tile

    // dy = w g + u . W1^T, staged as float32 over the y tile
    {
      float acc[kMT][2 * kNPd][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < 2 * kNPd; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      eegflow::tile_mma_tf32x3<kMT, kNPd, kSlice, kStages, kWarps>(acc, us, lda_u, w1, K, D,
                                                                    ring, D * ldr);
#pragma unroll
      for (int j = 0; j < 2 * kNPd; ++j) {
        const int pair = warp + kWarps * (j / 2);
        if (pair >= D / 16) continue;
        const int col = pair * 16 + 8 * (j % 2) + 2 * q;
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            const int row = 16 * i + 8 * rh + gq;
            *reinterpret_cast<float2*>(dys + row * lda_y + col) =
                make_float2(w_s[row] * g[col] + acc[i][j][2 * rh],
                            w_s[row] * g[col + 1] + acc[i][j][2 * rh + 1]);
          }
      }
    }
    __syncthreads();

    // the LayerNorm backward, one warp per row, and dgamma, dbeta
    for (int r = warp; r < kRows; r += kWarps) {
      const int t = t0 + r;
      if (t >= T) break;
      const size_t bt = static_cast<size_t>(b) * T + t;
      const float* dyr = dys + r * lda_y;
      const float rsig = rsig_s[r];
      float xh[kCols];
      float m1 = 0.f, m2 = 0.f;
      if (use_ln) {
        load_row(t, xh);
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          const int d = lane + 32 * i;
          if (d >= D) continue;
          xh[i] = (xh[i] - mu_s[r]) * rsig;
          const float dy = dyr[d];
          const float dxh = dy * gamma[d];
          m1 += dxh;
          m2 += dxh * xh[i];
          pdg[i] += dy * xh[i];
          pdb[i] += dy;
        }
        m1 = eegflow::warp_sum(m1) * inv_d;
        m2 = eegflow::warp_sum(m2) * inv_d;
      }
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int d = lane + 32 * i;
        if (d >= D) continue;
        float v = dyr[d];
        if (use_ln) v = rsig * (v * gamma[d] - m1 - xh[i] * m2);
        if (d < d0)
          dh0[bt * d0 + d] = v;
        else
          dh1[bt * d1 + (d - d0)] = v;
      }
    }
    __syncthreads();  // the next tile overwrites the tiles and the row stats
  }

  // the warps' dgamma and dbeta summed in warp order
  float* const part_s = ys;  // [kWarps][2][D], over the tiles and the ring
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const int d = lane + 32 * i;
    if (d >= D) continue;
    part_s[2 * warp * D + d] = pdg[i];
    part_s[(2 * warp + 1) * D + d] = pdb[i];
  }
  __syncthreads();
  float* out = vec_part + static_cast<size_t>(b) * (2 * K + 2 * D);
  for (int k = tid; k < K; k += kThreads) {
    out[k] = acc_db1[k];
    out[K + k] = acc_dw2[k];
  }
  for (int d = tid; d < D; d += kThreads) {
    float dg = 0.f, dbt = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      dg += part_s[2 * w * D + d];
      dbt += part_s[(2 * w + 1) * D + d];
    }
    out[2 * K + d] = dg;
    out[2 * K + D + d] = dbt;
  }
}

template <int kMT, int kSlice, int kStages>
size_t f32_smem_bytes(int D, int K) {
  const size_t rows = 16 * kMT;
  return (rows * (D + 4) + rows * (K + 4) +
          static_cast<size_t>(std::max(2 * kStages * K, kStages * D)) * (kSlice + 4) + D + 2 * K +
          4 * rows) *
         sizeof(float);
}

template <int kMT, int kSlice, int kStages, int kWarps>
cudaError_t launch_f32(const float* x0, const float* x1, int d0, int d1, const float* gamma,
                       const float* beta, const float* w1, const float* w1t, const float* b1,
                       const float* w2, const float* wts, const float* gs, const float* g0,
                       const float* g1, const float* gctx, float* dh0, float* dh1,
                       float* y_scr, float* u_scr, float* vec_part, int B, int T, int K,
                       int use_ln, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes<kMT, kSlice, kStages>(d0 + d1, K);
  auto kernel = pool_head_bwd_f32_kernel<kMT, kSlice, kStages, kWarps>;
  cudaError_t err = eegflow::allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, 32 * kWarps, smem, stream>>>(x0, x1, d0, d1, gamma, beta, w1, w1t, b1, w2, wts, gs,
                                         g0, g1, gctx, dh0, dh1, y_scr, u_scr, vec_part, T, K,
                                         use_ln, 1e-5f);
  return cudaGetLastError();
}

// D and K both modes take: multiples of 32 up to twice the narrow class's
bool widths_ok(int D, int K) {
  return D > 0 && K > 0 && D % 32 == 0 && K % 32 == 0 && D <= 2 * kMaxD && K <= 2 * kMaxK;
}

// the narrow class (one CTA a batch row) in both modes; the wide one above
bool narrow_class(int D, int K) { return D <= kMaxD && K <= kMaxK; }

}  // namespace

// The launch of the bf16 mode's row kernel for D and K, as
// eegflow_pool_head_bwd makes it: plan = {class (0 narrow, 1 wide), CTAs a
// batch row (its cluster), time steps a tile, dynamic shared memory a CTA in
// bytes}, and the kernel's (mangled) name from the runtime.
extern "C" int eegflow_pool_head_bwd_bf16_plan(int D, int K, int* plan, const char** name) {
  if (!widths_ok(D, K)) return static_cast<int>(cudaErrorInvalidValue);
  const bool narrow = narrow_class(D, K);
  plan[0] = narrow ? 0 : 1;
  plan[1] = narrow ? 1 : eegflow::kWideCluster;
  plan[2] = narrow ? 16 * kBMT : eegflow::kWideRows;
  plan[3] = static_cast<int>(narrow ? narrow_bwd_smem(D, K) : wide_bwd_smem(D, K));
  const void* kernel = narrow ? reinterpret_cast<const void*>(pool_head_bwd_bf16_kernel)
                              : reinterpret_cast<const void*>(pool_head_bwd_wide_kernel);
  return static_cast<int>(cudaFuncGetName(name, kernel));
}

// x_p (B, T, d_p) float32; gamma, beta (d0 + d1,) or null without LN; b1,
// w2 (K,); wts, gs (B, T); g_p (B, d_p); gctx (B,). W1 as w1 (d0 + d1, K)
// and w1t (K, d0 + d1): bf16 under `bf16`, else float32 (16-byte aligned);
// d0 + d1 <= 1024 and K <= 512, both multiples of 32. Outputs dh_p (B, T, d_p), dw1 (d0 + d1, K) and vec
// (2K + 2(d0 + d1)) = [db1, dw2, dgamma, dbeta] float32. Scratch: y_scr (B,
// T, d0 + d1) and u_scr (B, T, K), bf16 under `bf16`, else float32 (16-byte
// aligned); vec_part (B, 2K + 2(d0 + d1)) and part (splits * (d0 + d1) * K)
// float32. x1, g1 and dh1 may be null when d1 == 0.
extern "C" int eegflow_pool_head_bwd(
    const float* x0, const float* x1, int d0, int d1, const float* gamma, const float* beta,
    const void* w1, const void* w1t, const float* b1, const float* w2, const float* wts,
    const float* gs, const float* g0, const float* g1, const float* gctx, float* dh0,
    float* dh1, float* dw1, float* vec, void* y_scr, void* u_scr, float* vec_part,
    float* part, int splits, int B, int T, int K, int use_ln, int bf16,
    cudaStream_t stream) {
  const int D = d0 + d1;
  if (B <= 0 || T <= 0 || d0 <= 0 || d1 < 0 || splits <= 0 ||
      (use_ln && (gamma == nullptr || beta == nullptr)) || !widths_ok(D, K))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  const int BT = B * T;
  const bool narrow = narrow_class(D, K);
  if (bf16) {
    using Bf = __nv_bfloat16;
    const auto* const wb = static_cast<const Bf*>(w1);
    const auto* const wtb = static_cast<const Bf*>(w1t);
    auto* const ysb = static_cast<Bf*>(y_scr);
    auto* const usb = static_cast<Bf*>(u_scr);
    if (narrow)
      err = launch_bf16(x0, x1, d0, d1, gamma, beta, wb, wtb, b1, w2, wts, gs,
                                        g0, g1, gctx, dh0, dh1, ysb, usb, vec_part, B, T, K,
                                        use_ln, stream);
    else
      err = eegflow::launch_pairs(pool_head_bwd_wide_kernel, B, wide_bwd_smem(D, K), stream, x0,
                                  x1, d0, d1, gamma, beta, wb, wtb, b1, w2, wts, gs, g0, g1, gctx,
                                  dh0, dh1, ysb, usb, vec_part, T, K, use_ln, 1e-5f);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = eegflow::mma_gemm_split_k(
        eegflow::Bf16Cols{{static_cast<const Bf*>(y_scr), nullptr}, {BT, 0}, D, D},
        eegflow::Bf16Cols{{static_cast<const Bf*>(u_scr), nullptr}, {BT, 0}, K, K}, dw1, part, D,
        K, BT, splits, stream);
  } else {
    const float* const wf = static_cast<const float*>(w1);
    const float* const wtf = static_cast<const float*>(w1t);
    float* const ys = static_cast<float*>(y_scr);
    float* const us = static_cast<float*>(u_scr);
    for (const void* ptr : {static_cast<const void*>(wf), static_cast<const void*>(wtf),
                            static_cast<const void*>(ys), static_cast<const void*>(us)})
      if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (narrow)
      err = launch_f32<2, 16, 3, 16>(x0, x1, d0, d1, gamma, beta, wf, wtf, b1, w2, wts, gs, g0, g1,
                                 gctx, dh0, dh1, ys, us, vec_part, B, T, K, use_ln, stream);
    else
      err = launch_f32<1, 8, 2, 8>(x0, x1, d0, d1, gamma, beta, wf, wtf, b1, w2, wts, gs, g0, g1,
                                gctx, dh0, dh1, ys, us, vec_part, B, T, K, use_ln, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = eegflow::tf32x3_gemm_split_k(ys, us, dw1, part, D, K, BT, splits, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t count = 2 * static_cast<size_t>(K) + 2 * static_cast<size_t>(D);
  eegflow::reduce_splits_kernel<<<static_cast<unsigned>((count + 255) / 256), 256, 0,
                                  stream>>>(vec_part, vec, B, count);
  return static_cast<int>(cudaGetLastError());
}
