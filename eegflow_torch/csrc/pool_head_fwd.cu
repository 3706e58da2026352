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
//   s_t = sum_k tanh(y_t . W1[:, k] + b1_k) * w2_k   (bf16(y), bf16(W1) under bf16)
//   ctx = sum_t softmax(s)_t y_t     (online softmax over t, float32 y)
// and returns the context split back into parts plus the raw scores s; the
// score bias b2 is added outside (eegflow/nn/model.py adds it).
//
// What bounds it on the card: per row it reads T x D float32 of input once
// (0.54 GB at B = 1024, T = 256, D = 512: 0.16 ms at 3.35 TB/s) and does
// T x D x K multiply-adds (69 GFLOP at K = 256: 0.07 ms at the bf16
// tensor-core peak, 0.42 ms in 3xTF32 at a third of the TF32 peak), so the
// bytes bound the bf16 mode and the products the float32 one. At H = 512
// (D = 1024, K = 512, B = 512) the bf16 mode reads the same 0.54 GB and does
// 137 GFLOP (0.14 ms): still bound by the bytes, by a little. The T loop of
// the online softmax is serial within a row.
//
// Both modes: one CTA per batch row walks time in tiles. Per tile: one warp
// per row computes the LayerNorm statistics with shuffles and writes y into
// a K-major tile in shared memory; proj = y . W1 runs on the tensor cores
// with W1 streamed from L2 through a cp.async ring (mma_gemm.cuh); the
// epilogue reduces tanh(acc + b1) w2 over K in a fixed order: a thread's
// columns, the quad by shuffles, then the warps in order; warp 0 turns the
// tile's scores into the online softmax's weights; then the context sums
// float32 y, as the reference does. Sums in fixed orders, no atomics: a
// launch repeats bit for bit.
//
// bf16 mode (pool_head_fwd_bf16_kernel): 64-step tiles of bf16(y) [kM][D +
// 8]; proj on mma.sync m16n8k16 (tile_mma), W1 rounded to bf16 once by the
// wrapper and streamed through a ring of two 32-deep slices, so a batch row
// reads W1 T / 64 times (4 x 256 KB at T = 256, D = 512, K = 256). bf16 y
// would move the context by ~4e-3, and a float32 y tile (128 KB at D = 512)
// beside the bf16 tile (65 KB) and the ring (33 KB) is over the 227 KB a CTA
// may have, so each thread recomputes y for its features from x (the tile it
// read a moment before, an L2 hit) and the row's statistics. Two width
// classes, one template body: D <= 512 and K <= 256 on 8 warps (a CTA takes
// 101 KB, so two share an SM and one's loads overlap the other's products),
// and D <= 1024, K <= 512 (the classifier at H = 512) on 16 warps, one CTA an
// SM (199 KB of tile and ring at D = 1024, K = 512; bf16 W1 is then 1 MiB, so
// it streams from L2 as at the narrow width). In both a warp owns two
// 16-column pairs of proj and a thread two context features. D and K
// multiples of 32.
//
// float32 mode (pool_head_fwd_f32_kernel; also kernel 6, one part without
// LayerNorm): the float32 y tile is the product's A operand and the context
// sums it directly. proj in 3xTF32 on mma.sync m16n8k8 (tile_mma_tf32x3:
// each float32 operand split into two TF32 parts, three products, float32
// accumulators, each product good to about 2^-21 relative), as kernel 8's
// float32 mode runs its products. ldmatrix cannot transpose 32-bit elements,
// so B reaches the tensor cores as W1^T (K rows of D floats, transposed once
// by the wrapper), streamed in 16-deep slices through a ring of three
// stages. 64-step tiles on 16 warps (a 132 KB y tile at D = 512, 198 KB a
// CTA), so a batch row reads W1 T / 64 times from L2 (2 MB at T = 256, 1 GB
// a call at B = 512): at 32-step tiles streaming W1^T took a third of the
// kernel's time on an H100 (PERF.md). 16-step tiles on 8 warps for D > 512
// or K > 256, up to 1024 and 512. Needs D and K multiples of 32.

#include <math.h>

#include "common.cuh"
#include "mma_gemm.cuh"

namespace {

// bf16 mode: tiles of kM (b, t) rows of one batch row, W1 in
// kTileSlice-deep slices in a ring of kStages.
constexpr int kM = 64;
constexpr int kMT = kM / 16;  // m-tiles of a tile
constexpr int kStages = 2;
constexpr int kMaxD = 512;  // the narrow bf16 class: D <= 512, K <= 256 on 8 warps
constexpr int kMaxK = 256;
constexpr int kWideD = 1024;  // the wide class (and the float32 mode): D <= 1024, K <= 512
constexpr int kWideK = 512;

// bf16 mode, one CTA per batch row, kWarps warps, D <= kDMax and K <=
// kDMax / 2. Thread (warp w, lane = 4 g + q) holds, for m-tile i and n-tile j
// of its pairs, rows 16 i + g, 16 i + g + 8 and columns 16 pair + 8 (j % 2) +
// 2 q, + 1 of proj (tile_mma; pair = w + kWarps (j / 2)); in the LayerNorm
// pass warp w takes rows 2 w, 2 w + 1, 2 w + 2 kWarps, .. and lane l features
// l + 32 i; in the context sum thread tid owns features tid + 32 kWarps i.
//   x_p (B, T, d_p) float32; w1b (D, K) bf16; ctx_p (B, d_p), scores (B, T).
template <int kWarps, int kDMax, int kMinBlocks>
__global__ void __launch_bounds__(32 * kWarps, kMinBlocks)
pool_head_fwd_bf16_kernel(const float* __restrict__ x0, const float* __restrict__ x1, int d0,
                          int d1, const float* __restrict__ gamma,
                          const float* __restrict__ beta, const __nv_bfloat16* __restrict__ w1b,
                          const float* __restrict__ b1, const float* __restrict__ w2,
                          float* __restrict__ ctx0, float* __restrict__ ctx1,
                          float* __restrict__ scores, int T, int K, int use_ln, float eps) {
  constexpr int kBThreads = 32 * kWarps;
  constexpr int kBWarps = kWarps;
  constexpr int kNP = kDMax / 32 / kWarps;  // 16-column pairs of proj a warp owns
  constexpr int kCols = kDMax / 32;         // features of a row a lane holds
  constexpr int kF = kDMax / kBThreads;     // context features a thread
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
      float xv[2][kCols];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const bool valid = r0 + rr < tc;
        const size_t bt = bt0 + r0 + rr;
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
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
          for (int i = 0; i < kCols; ++i) {
            s1 += xv[rr][i];
            s2 += xv[rr][i] * xv[rr][i];
          }
          s1 = eegflow::warp_sum(s1);
          s2 = eegflow::warp_sum(s2);
          mu = s1 * inv_d;
          rsig = rsqrtf(s2 * inv_d - mu * mu + eps);
        }
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
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
      float acc[kMT][2 * kNP][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < 2 * kNP; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      eegflow::tile_mma<kMT, kNP, kStages, kBWarps>(acc, ys, lda, w1b, K, D, K, ring,
                                                     stage_elems);
      float sp[kMT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) sp[i][0] = sp[i][1] = 0.f;
#pragma unroll
      for (int j = 0; j < 2 * kNP; ++j) {
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

template <int kWarps, int kDMax, int kMinBlocks>
cudaError_t launch_bf16(const float* x0, const float* x1, int d0, int d1, const float* gamma,
                        const float* beta, const __nv_bfloat16* w1b, const float* b1,
                        const float* w2, float* ctx0, float* ctx1, float* scores, int B, int T,
                        int K, int use_ln, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(kM) * (d0 + d1 + 8) +
                       static_cast<size_t>(kStages) * eegflow::kTileSlice * (K + 8)) *
                          sizeof(__nv_bfloat16) +
                      kM * sizeof(float2) +
                      (static_cast<size_t>(kWarps) * kM + kM + 2) * sizeof(float);
  auto kernel = pool_head_fwd_bf16_kernel<kWarps, kDMax, kMinBlocks>;
  cudaError_t err = eegflow::allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, 32 * kWarps, smem, stream>>>(x0, x1, d0, d1, gamma, beta, w1b, b1, w2, ctx0, ctx1,
                                          scores, T, K, use_ln, 1e-5f);
  return cudaGetLastError();
}

// float32 mode (and kernel 6): a tile of 16 kMT (b, t) rows of one batch
// row, kWarps warps, D <= kDMax and K <= kDMax / 2, W1^T streamed in
// kSlice-deep slices through a ring of kStages stages of K rows: 64-row
// tiles on 16 warps up to D = 512 and K = 256, 16-row tiles on 8 warps up to
// 1024 and 512 (a y tile of 1024 columns and the ring fill the shared
// memory). A warp owns kDMax / 32 / kWarps 16-column pairs of proj. Thread (warp w, lane =
// 4 g + q) holds, for m-tile i and n-tile j of its pairs, rows 16 i + g, + 8
// and columns 16 pair + 8 (j % 2) + 2 q, + 1 of proj; in the LayerNorm pass
// warp w takes rows w, w + kWarps, .. and lane l features l + 32 i; in the
// context sum thread tid owns features tid + 32 kWarps i.
//   x_p (B, T, d_p) float32; w1t (K, D) float32 (W1^T, 16-byte aligned);
//   ctx_p (B, d_p), scores (B, T).
template <int kMT, int kWarps, int kDMax, int kSlice, int kStages>
__global__ void __launch_bounds__(32 * kWarps, 1)
pool_head_fwd_f32_kernel(const float* __restrict__ x0, const float* __restrict__ x1, int d0,
                         int d1, const float* __restrict__ gamma, const float* __restrict__ beta,
                         const float* __restrict__ w1t, const float* __restrict__ b1,
                         const float* __restrict__ w2, float* __restrict__ ctx0,
                         float* __restrict__ ctx1, float* __restrict__ scores, int T, int K,
                         int use_ln, float eps) {
  constexpr int kRows = 16 * kMT;
  constexpr int kThreads = 32 * kWarps;
  constexpr int kNP = kDMax / 32 / kWarps;   // 16-column pairs of proj a warp owns
  constexpr int kCols = kDMax / 32;          // features of a row a lane owns
  constexpr int kCtx = kDMax / kThreads;     // context features a thread owns
  extern __shared__ __align__(16) uint8_t smem[];
  const int D = d0 + d1;
  const int lda = D + 4, ldr = kSlice + 4;
  float* const ys = reinterpret_cast<float*>(smem);  // [kRows][D + 4] y
  float* const ring = ys + kRows * lda;               // [kStages][K][kSlice + 4]
  float* const red = ring + kStages * K * ldr;        // [kWarps][kRows] partial scores
  float* const p_s = red + kWarps * kRows;            // [kRows] the tile's exp(s - running max)
  float* const scal = p_s + kRows;                    // [2] the tile's rescale; at the end l

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const float inv_d = 1.0f / static_cast<float>(D);
  float acc_c[kCtx];  // the context sums of features tid + kThreads i
#pragma unroll
  for (int i = 0; i < kCtx; ++i) acc_c[i] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;  // warp 0's running max and denominator

  for (int t0 = 0; t0 < T; t0 += kRows) {
    const int tc = min(kRows, T - t0);
    const size_t bt0 = static_cast<size_t>(b) * T + t0;
    // LayerNorm, y into the tile (rows past T zero); a warp's rows unrolled,
    // so that their loads are in flight together
#pragma unroll
    for (int rr = 0; rr < kRows / kWarps; ++rr) {
      const int r = warp + kWarps * rr;
      const size_t bt = bt0 + r;
      float xv[kCols];
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int d = lane + 32 * i;
        xv[i] = r < tc && d < D ? (d < d0 ? x0[bt * d0 + d] : x1[bt * d1 + (d - d0)]) : 0.f;
      }
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
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int d = lane + 32 * i;
        if (d >= D) continue;
        float v = xv[i];
        if (use_ln) v = (v - mu) * rsig * gamma[d] + beta[d];
        ys[r * lda + d] = r < tc ? v : 0.f;
      }
    }
    // (tile_mma_tf32x3's first barrier orders these stores before the product)

    // proj = y . W1 in 3xTF32; the scores, reduced over K in a fixed order:
    // a thread's columns, the quad by shuffles, then the warps in order
    {
      float acc[kMT][2 * kNP][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < 2 * kNP; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      eegflow::tile_mma_tf32x3<kMT, kNP, kSlice, kStages, kWarps>(acc, ys, lda, w1t, D, K, ring,
                                                                  K * ldr);
      float sp[kMT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) sp[i][0] = sp[i][1] = 0.f;
#pragma unroll
      for (int j = 0; j < 2 * kNP; ++j) {
        const int pair = warp + kWarps * (j / 2);
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
          if (q == 0) red[warp * kRows + 16 * i + 8 * rh + gq] = v;
        }
    }
    __syncthreads();

    // warp 0, lane l the rows l + 32 h: the scores (the warps' partials in
    // order) and the online softmax
    if (warp == 0) {
      constexpr int kH = (kRows + 31) / 32;
      float s[kH], mx = -INFINITY;
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        const int r = lane + 32 * h;
        s[h] = 0.f;
        if (r < kRows)
          for (int w = 0; w < kWarps; ++w) s[h] += red[w * kRows + r];
        if (r < tc) {
          scores[bt0 + r] = s[h];
          mx = fmaxf(mx, s[h]);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run, mx);
      float psum = 0.f;
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        const int r = lane + 32 * h;
        const float pe = r < tc ? expf(s[h] - m_new) : 0.f;
        if (r < kRows) p_s[r] = pe;
        psum += pe;
      }
      psum = eegflow::warp_sum(psum);
      const float scale = expf(m_run - m_new);  // 0 on the first tile (m_run = -inf)
      l_run = l_run * scale + psum;
      m_run = m_new;
      if (lane == 0) scal[0] = scale;
    }
    __syncthreads();

    // ctx = ctx * scale + sum_r p_r y_r over the float32 y tile
    const float scale = scal[0];
    float a[kCtx];
#pragma unroll
    for (int i = 0; i < kCtx; ++i) a[i] = acc_c[i] * scale;
    for (int r = 0; r < tc; ++r) {
      const float pr = p_s[r];
      const float* const yr = ys + r * lda;
#pragma unroll
      for (int i = 0; i < kCtx; ++i) {
        const int d = min(tid + kThreads * i, D - 1);  // clamped: the sum of d >= D is unused
        a[i] = fmaf(pr, yr[d], a[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kCtx; ++i) acc_c[i] = a[i];
    __syncthreads();  // the next tile overwrites ys, red and p_s
  }

  if (tid == 0) scal[1] = l_run;
  __syncthreads();
  const float inv_l = 1.0f / scal[1];
#pragma unroll
  for (int i = 0; i < kCtx; ++i) {
    const int d = tid + kThreads * i;
    if (d >= D) continue;
    const float v = acc_c[i] * inv_l;
    if (d < d0)
      ctx0[static_cast<size_t>(b) * d0 + d] = v;
    else
      ctx1[static_cast<size_t>(b) * d1 + (d - d0)] = v;
  }
}

template <int kMT, int kWarps, int kDMax, int kSlice, int kStages>
cudaError_t launch_f32(const float* x0, const float* x1, int d0, int d1, const float* gamma,
                       const float* beta, const float* w1t, const float* b1, const float* w2,
                       float* ctx0, float* ctx1, float* scores, int B, int T, int K, int use_ln,
                       cudaStream_t stream) {
  constexpr int kRows = 16 * kMT;
  const size_t smem = (static_cast<size_t>(kRows) * (d0 + d1 + 4) +
                       static_cast<size_t>(kStages) * K * (kSlice + 4) + kWarps * kRows + kRows +
                       2) *
                      sizeof(float);
  auto kernel = pool_head_fwd_f32_kernel<kMT, kWarps, kDMax, kSlice, kStages>;
  cudaError_t err = eegflow::allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, 32 * kWarps, smem, stream>>>(x0, x1, d0, d1, gamma, beta, w1t, b1, w2, ctx0, ctx1,
                                           scores, T, K, use_ln, 1e-5f);
  return cudaGetLastError();
}

}  // namespace

// x_p (B, T, d_p) float32; gamma, beta (d0 + d1,) float32 (null without LN);
// w1: W1 (d0 + d1, K) bf16 under `bf16`, else W1^T (K, d0 + d1) float32,
// 16-byte aligned; d0 + d1 <= 1024 and K <= 512, both multiples of 32; b1, w2
// (K,) float32; ctx_p (B, d_p) and scores (B, T) float32. x1/ctx1 may be null
// when d1 == 0.
extern "C" int eegflow_pool_head_fwd(const float* x0, const float* x1, int d0, int d1,
                                     const float* gamma, const float* beta, const void* w1,
                                     const float* b1, const float* w2, float* ctx0,
                                     float* ctx1, float* scores, int B, int T, int K,
                                     int use_ln, int bf16, cudaStream_t stream) {
  const int D = d0 + d1;
  if (B <= 0 || T <= 0 || K <= 0 || d0 <= 0 || d1 < 0 ||
      (use_ln && (gamma == nullptr || beta == nullptr)) || D % 32 != 0 || K % 32 != 0 ||
      D > kWideD || K > kWideK || (!bf16 && reinterpret_cast<uintptr_t>(w1) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  const bool narrow = D <= kMaxD && K <= kMaxK;
  if (bf16) {
    const auto* const w1b = static_cast<const __nv_bfloat16*>(w1);
    if (narrow)
      err = launch_bf16<8, kMaxD, 2>(x0, x1, d0, d1, gamma, beta, w1b, b1, w2, ctx0, ctx1,
                                     scores, B, T, K, use_ln, stream);
    else
      err = launch_bf16<16, kWideD, 1>(x0, x1, d0, d1, gamma, beta, w1b, b1, w2, ctx0, ctx1,
                                       scores, B, T, K, use_ln, stream);
  } else {
    const float* const w1t = static_cast<const float*>(w1);
    if (narrow)
      err = launch_f32<4, 16, 512, 16, 3>(x0, x1, d0, d1, gamma, beta, w1t, b1, w2, ctx0, ctx1,
                                          scores, B, T, K, use_ln, stream);
    else
      err = launch_f32<1, 8, 1024, 8, 4>(x0, x1, d0, d1, gamma, beta, w1t, b1, w2, ctx0, ctx1,
                                         scores, B, T, K, use_ln, stream);
  }
  return static_cast<int>(err);
}
