// Fused LSTM layer-direction backward for Hopper (sm_90a).
//
// Replaces: eegflow/nn/pallas_lstm.py _bwd_fused_kernel (entry
// lstm_bwd_fused) under the default adjoint-residual contract (_ADJ_RES=1)
// with uint8-mask input dropout and the sibling direction's dx added in
// (dx_add), the mode the training step runs 3 layers x 2 directions per
// micro-step.
//
// Inputs: the six float32 planes res (B, T, 6H) that lstm_fwd.cu writes in
// training mode, h (B, T, H), the upstream gradient g (B, T, H), the input
// parts x_p (B, T, d_p) with their keep-masks, and the weights. The adjoint
// walks against the direction of time (t = T-1..0 for the forward direction,
// 0..T-1 for the reverse one):
//   dh = g[t] + dh_carry;   dc = dh E + dc_carry;   dc_carry = dc F
//   dz = [dc A, dc B, dc C, dh G]                    (float32)
//   dh_carry = bf16(dz) . bf16(W_hh)^T
// and then, with h_prev[t] the state before step t (h[t-1] forward, h[t+1]
// reverse, zero before the direction's first step) and x_p masked as in the
// forward:
//   dx_p    = where(m_p, (bf16(dz) . bf16(W_ih_p)^T) / keep, 0) + dx_add_p
//   dW_ih_p = bf16(x_p)^T . bf16(dz)      dW_hh = bf16(h_prev)^T . bf16(dz)
//   db      = sum over (b, t) of dz (float32)
// Products take bf16-rounded operands and sum in float32.
//
// What bounds it on the card: the adjoint chain is serial in t and needs
// all of W_hh (512 KB in bf16 at H=256) every step, like the forward; the
// three products are 2 B T 4H (d0 + d1 + H) multiply-adds (at B=512, T=256,
// H=256 and two parts: 0.2 TFLOP per launch) whose weight-gradient sums run
// over B T = 131072 rows.
//
// Design, two stages per launch. (1) The chain of lstm_bwd_chain.cuh (shared
// with kernel 4): one CTA per 8 batch rows, one thread per hidden unit, the
// carries in registers, dz to a float32 scratch (B, T, 4H) and, bf16-rounded,
// to a double-buffered shared tile that feeds the dh_carry product, whose
// W_hh^T reads are coalesced across the warp (the wrapper passes W_hh^T).
// (2) The products, on the tiled GEMM of gemm.cuh: dx with its mask and
// dx_add in the epilogue; dW_ih, dW_hh and db split over B T into partial
// sums that a second pass adds in a fixed order. No atomics: the result is
// bitwise repeatable. Tensor cores and fusing the chain with the products
// are later work.

#include <stdint.h>

#include "common.cuh"
#include "gemm.cuh"
#include "lstm_bwd_chain.cuh"

namespace {

__global__ void __launch_bounds__(kChainMaxThreads)
lstm_bwd_chain_kernel(const float* __restrict__ res, const float* __restrict__ g,
                      const __nv_bfloat16* __restrict__ whh_t, float* __restrict__ dz,
                      int B, int T, int H, int reverse) {
  chain_direction(res, g, whh_t, dz, B, T, H, reverse);
}

}  // namespace

namespace lstm_bwd_ops {

// dx epilogue: the part's dropout mask, then the sibling direction's dx
struct DxStore {
  float* dx;
  const uint8_t* m;
  const float* add;
  int D;
  float inv_keep;
  __device__ void operator()(int, int bt, int d, float v) const {
    const size_t i = static_cast<size_t>(bt) * D + d;
    if (m != nullptr) v = m[i] != 0 ? v * inv_keep : 0.f;
    if (add != nullptr) v += add[i];
    dx[i] = v;
  }
};

}  // namespace lstm_bwd_ops

using namespace lstm_bwd_ops;

// res (B, T, 6H), h, g (B, T, H), x_p (B, T, d_p) float32; m_p (B, T, d_p)
// uint8 or null; w_p (d_p, 4H) and whh_t (4H, H) bf16; add_p (B, T, d_p) or
// null. Outputs dx_p (B, T, d_p), dw_ih (d0 + d1, 4H), dw_hh (H, 4H), db (4H)
// float32. Scratch: dz (B, T, 4H) and part (splits * max(d0, d1, H) * 4H)
// float32. x1, m1, w1, add1 and dx1 may be null when d1 == 0.
extern "C" int eegflow_lstm_bwd(const float* res, const float* h, const float* g,
                                const float* x0, const float* x1, const uint8_t* m0,
                                const uint8_t* m1, int d0, int d1, float inv_keep,
                                const __nv_bfloat16* w0, const __nv_bfloat16* w1,
                                const __nv_bfloat16* whh_t, const float* add0,
                                const float* add1, float* dx0, float* dx1, float* dw_ih,
                                float* dw_hh, float* db, float* dz, float* part,
                                int splits, int B, int T, int H, int reverse,
                                cudaStream_t stream) {
  if (H <= 0 || H > kChainMaxThreads || H % 32 != 0 || B <= 0 || T <= 0 || d0 <= 0 ||
      d1 < 0 || splits <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = 4 * H;
  const int BT = B * T;
  const size_t smem = chain_smem_bytes(H);
  cudaError_t err = eegflow::allow_dynamic_smem(lstm_bwd_chain_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  lstm_bwd_chain_kernel<<<(B + kChainRows - 1) / kChainRows, H, smem, stream>>>(
      res, g, whh_t, dz, B, T, H, reverse);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const float* xs[2] = {x0, x1};
  const uint8_t* ms[2] = {m0, m1};
  const __nv_bfloat16* ws[2] = {w0, w1};
  const float* adds[2] = {add0, add1};
  float* dxs[2] = {dx0, dx1};
  const int ds[2] = {d0, d1};
  size_t row_off = 0;
  for (int q = 0; q < (d1 > 0 ? 2 : 1); ++q) {
    err = eegflow::gemm(DzRowsA{dz, G}, WihT{ws[q], G},
                        DxStore{dxs[q], ms[q], adds[q], ds[q], inv_keep}, BT, ds[q], G,
                        stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = eegflow::gemm_split_k(MaskedXA{xs[q], ms[q], ds[q], inv_keep}, DzB{dz, G},
                                dw_ih + row_off * G, part, ds[q], G, BT, splits, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    row_off += ds[q];
  }
  err = eegflow::gemm_split_k(HPrevA{h, T, H, reverse}, DzB{dz, G}, dw_hh, part, H, G, BT,
                              splits, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(eegflow::colsum_split(dz, db, part, BT, G, splits, stream));
}
