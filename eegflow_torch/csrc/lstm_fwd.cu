// Fused LSTM layer-direction forward for Hopper (sm_90a): eval mode and
// two training modes.
//
// Replaces: eegflow/nn/pallas_lstm.py _fwd_proj_kernel (entry
// lstm_fwd_fused_proj). Eval mode (eegflow_lstm_fwd) is need_residuals=False
// without dropout, the mode the coupled-inference path runs. Training mode
// (eegflow_lstm_fwd_train) is need_residuals=True under the default
// adjoint-residual contract (_ADJ_RES=1) with the uint8-mask input dropout
// (the reference's n_masks path): the mode the training step runs, 3 layers
// x 2 directions per micro-step. Raw-gate training mode
// (eegflow_lstm_fwd_train_gates) is need_residuals=True under the raw-gate
// contract (_ADJ_RES=0): the post-activation gates and c of every step, the
// residuals of the two-pass backward (lstm_bwd_v2.cu).
//
// Per step t (walked T-1..0 for the reverse direction, h written at its
// natural position):
//   x_p = where(m_p[t], x_p[t] * (1/keep), 0)     (training mode with masks)
//   z = b + sum_p bf16(x_p) . bf16(W_ih_p) + bf16(h) . bf16(W_hh)
//   i, f, o = 0.5 tanh(z/2) + 0.5;  g = tanh(z)
//   c = f c_prev + i g;  h = o tanh(c)      (c, h float32, zero initial state)
// Products of bf16-rounded operands are accumulated in float32. The input
// arrives as one or two parts (a bidirectional predecessor's halves) read
// through two pointers; they are never concatenated. Training mode also
// writes the six float32 adjoint planes of step t into res (B, T, 6H):
//   [g i(1-i), c_prev f(1-f), i(1-g^2), o(1-tanh^2 c), f, tanh(c) o(1-o)]
// so the backward (lstm_bwd.cu) needs neither c nor a transcendental.
// Raw-gate mode writes [i, f, g, o] (B, T, 4H) and c (B, T, H) instead, 5H
// float32 a row and step against the planes' 6H; its backward recomputes
// tanh(c) and reads c_prev from c at t-1 (t+1 reverse). Eval mode writes no
// residuals.
//
// What bounds it on the card: the recurrence is serial in t, and every step
// needs all of W_ih (D x 4H) and W_hh (H x 4H). At H=256 W_hh alone is 512 KB
// in bf16 and layers 1-2 add 1 MB of W_ih, above the 227 KB of shared memory
// a block may hold. This first design therefore re-reads the weights from
// global memory every step and relies on them staying resident in the 50 MB
// L2; the time per step is bound by L2 bandwidth and FMA issue, with few
// warps per SM (one CTA of H threads per 8 batch rows). Training mode adds
// 6H float32 of residual writes per row and step (0.8 GB per launch at
// B=512, T=256, H=256), coalesced across the CTA's threads.
//
// Design: a CTA owns kRows batch rows and one direction; thread u owns hidden
// unit u and computes the four gate columns u, H+u, 2H+u, 3H+u for all kRows
// rows, so the gate math and the residual planes need no exchange between
// threads and the weight loads are coalesced across the warp. c stays in
// registers. x_t (masked, then bf16-rounded) and h_{t-1} are staged in shared
// memory (transposed to [k][row] so one float4 pair feeds the 8 rows),
// double-buffered so each step needs a single __syncthreads. Rows past B are
// masked (no padding of the batch). The three modes are one template.
// Splitting W_hh across a thread-block cluster (distributed shared memory,
// FlashRNN-style) and wgmma are later work.

#include <stdint.h>

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

// One input element, with the inverted-dropout keep-mask applied when the
// part has one (the reference's _masked: where(m != 0, x * inv_keep, 0)).
__device__ __forceinline__ float load_input(const float* __restrict__ x,
                                            const uint8_t* __restrict__ m, size_t i,
                                            float inv_keep) {
  const float v = x[i];
  if (m == nullptr) return v;
  return m[i] != 0 ? v * inv_keep : 0.f;
}

// What a launch writes besides h.
enum Mode { kEval = 0, kPlanes = 1, kGates = 2 };

template <int kMode>
__global__ void __launch_bounds__(kMaxThreads)
lstm_fwd_kernel(const float* __restrict__ x0, const float* __restrict__ x1,
                const uint8_t* __restrict__ m0, const uint8_t* __restrict__ m1,
                int d0, int d1, float inv_keep, const __nv_bfloat16* __restrict__ w0,
                const __nv_bfloat16* __restrict__ w1, const float* __restrict__ bias,
                const __nv_bfloat16* __restrict__ whh, float* __restrict__ h_out,
                float* __restrict__ res_out, float* __restrict__ c_out, int B, int T,
                int H, int reverse) {
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
        const size_t bt = static_cast<size_t>(row) * T + t;
        v = (k < d0) ? load_input(x0, m0, bt * d0 + k, inv_keep)
                     : load_input(x1, m1, bt * d1 + (k - d0), inv_keep);
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
      const float c_prev = c[r];
      c[r] = fg * c_prev + ig * gg;
      const float tc = tanhf(c[r]);
      const float h = og * tc;
      h_next[u * kRows + r] = eegflow::bf16_round(h);
      const int row = row0 + r;
      if (row < B) {
        const size_t bt = static_cast<size_t>(row) * T + t;
        h_out[bt * H + u] = h;
        if (kMode == kPlanes) {
          float* z = res_out + bt * 6 * H + u;
          z[0] = gg * (ig * (1.f - ig));
          z[H] = c_prev * (fg * (1.f - fg));
          z[2 * H] = ig * (1.f - gg * gg);
          z[3 * H] = og * (1.f - tc * tc);
          z[4 * H] = fg;
          z[5 * H] = tc * (og * (1.f - og));
        } else if (kMode == kGates) {
          float* z = res_out + bt * 4 * H + u;
          z[0] = ig;
          z[H] = fg;
          z[2 * H] = gg;
          z[3 * H] = og;
          c_out[bt * H + u] = c[r];
        }
      }
    }
    p ^= 1;
  }
}

template <int kMode>
int launch(const float* x0, const float* x1, const uint8_t* m0, const uint8_t* m1,
           int d0, int d1, float inv_keep, const __nv_bfloat16* w0,
           const __nv_bfloat16* w1, const float* bias, const __nv_bfloat16* whh,
           float* h_out, float* res_out, float* c_out, int B, int T, int H, int reverse,
           cudaStream_t stream) {
  if (H <= 0 || H > kMaxThreads || H % 32 != 0 || B <= 0 || T <= 0 || d0 <= 0 ||
      d1 < 0 || (kMode != kEval && res_out == nullptr) ||
      (kMode == kGates && c_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(d0 + d1 + H) * kRows * sizeof(float);
  cudaError_t err = eegflow::allow_dynamic_smem(lstm_fwd_kernel<kMode>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + kRows - 1) / kRows);
  lstm_fwd_kernel<kMode><<<grid, H, smem, stream>>>(x0, x1, m0, m1, d0, d1, inv_keep, w0,
                                                    w1, bias, whh, h_out, res_out, c_out,
                                                    B, T, H, reverse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Eval mode. h_out (B, T, H) float32; x_p (B, T, d_p) float32; w_p (d_p, 4H)
// bf16; bias (4H,) float32; whh (H, 4H) bf16. x1/w1 may be null when d1 == 0.
extern "C" int eegflow_lstm_fwd(const float* x0, const float* x1, int d0, int d1,
                                const __nv_bfloat16* w0, const __nv_bfloat16* w1,
                                const float* bias, const __nv_bfloat16* whh,
                                float* h_out, int B, int T, int H, int reverse,
                                cudaStream_t stream) {
  return launch<kEval>(x0, x1, nullptr, nullptr, d0, d1, 1.f, w0, w1, bias, whh, h_out,
                       nullptr, nullptr, B, T, H, reverse, stream);
}

// Training mode: as eval mode, plus uint8 keep-masks m_p (B, T, d_p) (null:
// no dropout on that part; 0 = dropped) scaled by inv_keep, and the adjoint
// planes res_out (B, T, 6H) float32.
extern "C" int eegflow_lstm_fwd_train(const float* x0, const float* x1,
                                      const uint8_t* m0, const uint8_t* m1, int d0,
                                      int d1, float inv_keep, const __nv_bfloat16* w0,
                                      const __nv_bfloat16* w1, const float* bias,
                                      const __nv_bfloat16* whh, float* h_out,
                                      float* res_out, int B, int T, int H, int reverse,
                                      cudaStream_t stream) {
  return launch<kPlanes>(x0, x1, m0, m1, d0, d1, inv_keep, w0, w1, bias, whh, h_out,
                         res_out, nullptr, B, T, H, reverse, stream);
}

// Raw-gate training mode: as training mode, but the residuals are the
// post-activation gates [i, f, g, o] gates_out (B, T, 4H) and the cell state
// c_out (B, T, H), float32.
extern "C" int eegflow_lstm_fwd_train_gates(const float* x0, const float* x1,
                                            const uint8_t* m0, const uint8_t* m1, int d0,
                                            int d1, float inv_keep,
                                            const __nv_bfloat16* w0,
                                            const __nv_bfloat16* w1, const float* bias,
                                            const __nv_bfloat16* whh, float* h_out,
                                            float* gates_out, float* c_out, int B, int T,
                                            int H, int reverse, cudaStream_t stream) {
  return launch<kGates>(x0, x1, m0, m1, d0, d1, inv_keep, w0, w1, bias, whh, h_out,
                        gates_out, c_out, B, T, H, reverse, stream);
}
