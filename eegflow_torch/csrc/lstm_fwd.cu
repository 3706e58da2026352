// Fused LSTM layer-direction forward, eval mode, for Hopper (sm_90a).
//
// Replaces: eegflow/nn/pallas_lstm.py _fwd_proj_kernel (entry
// lstm_fwd_fused_proj) with need_residuals=False and no dropout, the mode the
// coupled-inference path runs (3 layers x 2 directions per batch).
//
// Per step t (walked T-1..0 for the reverse direction, h written at its
// natural position):
//   z = b + sum_p bf16(x_p[t]) . bf16(W_ih_p) + bf16(h) . bf16(W_hh)
//   i, f, o = 0.5 tanh(z/2) + 0.5;  g = tanh(z)
//   c = f c + i g;  h = o tanh(c)          (c, h float32, zero initial state)
// Products of bf16-rounded operands are accumulated in float32. The input
// arrives as one or two parts (a bidirectional predecessor's halves) read
// through two pointers; they are never concatenated.
//
// What bounds it on the card: the recurrence is serial in t, and every step
// needs all of W_ih (D x 4H) and W_hh (H x 4H). At H=256 W_hh alone is 512 KB
// in bf16 and layers 1-2 add 1 MB of W_ih, above the 227 KB of shared memory
// a block may hold. This first design therefore re-reads the weights from
// global memory every step and relies on them staying resident in the 50 MB
// L2; the time per step is bound by L2 bandwidth and FMA issue, with few
// warps per SM (one CTA of H threads per 8 batch rows).
//
// Design: a CTA owns kRows batch rows and one direction; thread u owns hidden
// unit u and computes the four gate columns u, H+u, 2H+u, 3H+u for all kRows
// rows, so the gate math needs no exchange between threads and the weight
// loads are coalesced across the warp. c stays in registers. x_t and h_{t-1}
// are staged in shared memory (bf16-rounded, transposed to [k][row] so one
// float4 pair feeds the 8 rows), double-buffered so each step needs a single
// __syncthreads. Rows past B are masked (no padding of the batch).
// Splitting W_hh across a thread-block cluster (distributed shared memory,
// FlashRNN-style) and wgmma are later work.

#include "common.cuh"

namespace {

constexpr int kRows = 8;          // batch rows per CTA
constexpr int kMaxThreads = 512;  // H <= 512 (one thread per hidden unit)

// acc[g][r] += sum_k xs[k][r] * W[k][g*H + u]  for k in [0, D)
__device__ __forceinline__ void accumulate(float (&acc)[4][kRows],
                                           const float* __restrict__ xs,
                                           const __nv_bfloat16* __restrict__ w,
                                           int D, int H, int u) {
  const size_t G = 4 * static_cast<size_t>(H);
  const __nv_bfloat16* wk = w + u;
#pragma unroll 4
  for (int k = 0; k < D; ++k, wk += G) {
    const float wg[4] = {__bfloat162float(wk[0]), __bfloat162float(wk[H]),
                         __bfloat162float(wk[2 * H]), __bfloat162float(wk[3 * H])};
    const float4 xa = *reinterpret_cast<const float4*>(xs + k * kRows);
    const float4 xb = *reinterpret_cast<const float4*>(xs + k * kRows + 4);
    const float xv[kRows] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
    for (int g = 0; g < 4; ++g) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[g][r] = fmaf(xv[r], wg[g], acc[g][r]);
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
lstm_fwd_kernel(const float* __restrict__ x0, const float* __restrict__ x1, int d0,
                int d1, const __nv_bfloat16* __restrict__ w0,
                const __nv_bfloat16* __restrict__ w1, const float* __restrict__ bias,
                const __nv_bfloat16* __restrict__ whh, float* __restrict__ h_out,
                int B, int T, int H, int reverse) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = d0 + d1;
  // layout: x_t buffers [2][D][kRows], then h buffers [2][H][kRows]
  float* const xbase = smem;
  float* const hbase = smem + 2 * D * kRows;

  const int u = threadIdx.x;  // blockDim.x == H
  const int nthreads = blockDim.x;
  const int row0 = blockIdx.x * kRows;

  for (int i = u; i < H * kRows; i += nthreads) hbase[i] = 0.f;
  float c[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) c[r] = 0.f;
  const float b_i = bias[u], b_f = bias[H + u], b_g = bias[2 * H + u],
              b_o = bias[3 * H + u];

  int p = 0;
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    // stage x_t: consecutive threads read consecutive features of one row
    float* xs = xbase + p * D * kRows;
    const float* h_prev = hbase + p * H * kRows;
    float* h_next = hbase + (p ^ 1) * H * kRows;
    for (int i = u; i < D * kRows; i += nthreads) {
      const int r = i / D;
      const int k = i - r * D;
      const int row = row0 + r;
      float v = 0.f;
      if (row < B) {
        v = (k < d0) ? x0[(static_cast<size_t>(row) * T + t) * d0 + k]
                     : x1[(static_cast<size_t>(row) * T + t) * d1 + (k - d0)];
      }
      xs[k * kRows + r] = eegflow::bf16_round(v);
    }
    __syncthreads();

    float acc[4][kRows];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[g][r] = 0.f;
    }
    accumulate(acc, xs, w0, d0, H, u);
    if (d1 > 0) accumulate(acc, xs + d0 * kRows, w1, d1, H, u);
    accumulate(acc, h_prev, whh, H, H, u);

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float ig = eegflow::sigmoid_tanh(acc[0][r] + b_i);
      const float fg = eegflow::sigmoid_tanh(acc[1][r] + b_f);
      const float gg = tanhf(acc[2][r] + b_g);
      const float og = eegflow::sigmoid_tanh(acc[3][r] + b_o);
      c[r] = fg * c[r] + ig * gg;
      const float h = og * tanhf(c[r]);
      h_next[u * kRows + r] = eegflow::bf16_round(h);
      const int row = row0 + r;
      if (row < B) h_out[(static_cast<size_t>(row) * T + t) * H + u] = h;
    }
    p ^= 1;
  }
}

}  // namespace

// h_out (B, T, H) float32; x_p (B, T, d_p) float32; w_p (d_p, 4H) bf16;
// bias (4H,) float32; whh (H, 4H) bf16. x1/w1 may be null when d1 == 0.
extern "C" int eegflow_lstm_fwd(const float* x0, const float* x1, int d0, int d1,
                                const __nv_bfloat16* w0, const __nv_bfloat16* w1,
                                const float* bias, const __nv_bfloat16* whh,
                                float* h_out, int B, int T, int H, int reverse,
                                cudaStream_t stream) {
  if (H <= 0 || H > kMaxThreads || H % 32 != 0 || B <= 0 || T <= 0 || d0 <= 0 ||
      d1 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(d0 + d1 + H) * kRows * sizeof(float);
  cudaError_t err = eegflow::allow_dynamic_smem(lstm_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + kRows - 1) / kRows);
  lstm_fwd_kernel<<<grid, H, smem, stream>>>(x0, x1, d0, d1, w0, w1, bias, whh,
                                             h_out, B, T, H, reverse);
  return static_cast<int>(cudaGetLastError());
}
