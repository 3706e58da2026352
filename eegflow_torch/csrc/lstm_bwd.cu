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
// Design, two stages per launch. (1) The chain: one CTA per 8 batch rows,
// one thread per hidden unit, the carries in registers; dz of a step is
// written to a float32 scratch (B, T, 4H) and, bf16-rounded, to a
// double-buffered shared tile that feeds the dh_carry product, whose
// W_hh^T reads are coalesced across the warp (the wrapper passes W_hh^T).
// (2) The products, on the tiled GEMM of gemm.cuh: dx with its mask and
// dx_add in the epilogue; dW_ih, dW_hh and db split over B T into partial
// sums that a second pass adds in a fixed order. No atomics: the result is
// bitwise repeatable. Tensor cores and fusing the chain with the products
// are later work.

#include <stdint.h>

#include "common.cuh"
#include "gemm.cuh"

namespace {

constexpr int kRows = 8;          // batch rows per CTA of the chain
constexpr int kMaxThreads = 512;  // H <= 512 (one thread per hidden unit)

__global__ void __launch_bounds__(kMaxThreads)
lstm_bwd_chain_kernel(const float* __restrict__ res, const float* __restrict__ g,
                      const __nv_bfloat16* __restrict__ whh_t, float* __restrict__ dz,
                      int B, int T, int H, int reverse) {
  extern __shared__ float4 smem4[];
  float* const dzs = reinterpret_cast<float*>(smem4);  // [2][4H][kRows]
  const int G = 4 * H;
  const int u = threadIdx.x;  // blockDim.x == H
  const int row0 = blockIdx.x * kRows;

  float dh_carry[kRows], dc_carry[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) dh_carry[r] = dc_carry[r] = 0.f;

  int p = 0;
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? s : T - 1 - s;
    float* buf = dzs + p * G * kRows;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      float zi = 0.f, zf = 0.f, zg = 0.f, zo = 0.f;
      if (row < B) {
        const size_t bt = static_cast<size_t>(row) * T + t;
        const float* rp = res + bt * 6 * H + u;
        const float dh = g[bt * H + u] + dh_carry[r];
        const float dc = dh * rp[3 * H] + dc_carry[r];
        dc_carry[r] = dc * rp[4 * H];
        zi = dc * rp[0];
        zf = dc * rp[H];
        zg = dc * rp[2 * H];
        zo = dh * rp[5 * H];
        float* dzp = dz + bt * G + u;
        dzp[0] = zi;
        dzp[H] = zf;
        dzp[2 * H] = zg;
        dzp[3 * H] = zo;
      }
      buf[u * kRows + r] = eegflow::bf16_round(zi);
      buf[(H + u) * kRows + r] = eegflow::bf16_round(zf);
      buf[(2 * H + u) * kRows + r] = eegflow::bf16_round(zg);
      buf[(3 * H + u) * kRows + r] = eegflow::bf16_round(zo);
    }
    __syncthreads();

    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    const __nv_bfloat16* wj = whh_t + u;
#pragma unroll 4
    for (int j = 0; j < G; ++j, wj += H) {
      const float w = __bfloat162float(*wj);
      const float4 za = *reinterpret_cast<const float4*>(buf + j * kRows);
      const float4 zb = *reinterpret_cast<const float4*>(buf + j * kRows + 4);
      acc[0] = fmaf(za.x, w, acc[0]);
      acc[1] = fmaf(za.y, w, acc[1]);
      acc[2] = fmaf(za.z, w, acc[2]);
      acc[3] = fmaf(za.w, w, acc[3]);
      acc[4] = fmaf(zb.x, w, acc[4]);
      acc[5] = fmaf(zb.y, w, acc[5]);
      acc[6] = fmaf(zb.z, w, acc[6]);
      acc[7] = fmaf(zb.w, w, acc[7]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) dh_carry[r] = acc[r];
    p ^= 1;
  }
}

}  // namespace

// Operand loaders and epilogue of the products (gemm.cuh), in a named
// namespace so the GEMM template is instantiated on types with linkage.
namespace lstm_bwd_ops {

// bf16(dz) as the A operand of dx = dz . W_ih_p^T: A(m = b*T + t, k = gate col)
struct DzRowsA {
  static constexpr bool kMContiguous = false;
  const float* dz;
  int G;
  __device__ float operator()(int m, int k) const {
    return eegflow::bf16_round(dz[static_cast<size_t>(m) * G + k]);
  }
};

// W_ih_p^T as the B operand of dx: B(k = gate col, n = feature) = W_ih_p[n][k]
struct WihT {
  static constexpr bool kNContiguous = false;
  const __nv_bfloat16* w;
  int G;
  __device__ float operator()(int k, int n) const {
    return __bfloat162float(w[static_cast<size_t>(n) * G + k]);
  }
};

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

// bf16(masked x_p) as the A operand of dW_ih_p = x_p^T . dz: A(m = feature, k = b*T + t)
struct MaskedXA {
  static constexpr bool kMContiguous = true;
  const float* x;
  const uint8_t* m;
  int D;
  float inv_keep;
  __device__ float operator()(int d, int bt) const {
    const size_t i = static_cast<size_t>(bt) * D + d;
    float v = x[i];
    if (m != nullptr) v = m[i] != 0 ? v * inv_keep : 0.f;
    return eegflow::bf16_round(v);
  }
};

// bf16(h_prev) as the A operand of dW_hh = h_prev^T . dz: A(m = unit, k = b*T + t)
struct HPrevA {
  static constexpr bool kMContiguous = true;
  const float* h;
  int T, H, reverse;
  __device__ float operator()(int u, int bt) const {
    const int b = bt / T;
    const int tp = (bt - b * T) + (reverse ? 1 : -1);
    if (tp < 0 || tp >= T) return 0.f;
    return eegflow::bf16_round(h[(static_cast<size_t>(b) * T + tp) * H + u]);
  }
};

// bf16(dz) as the B operand of the weight gradients: B(k = b*T + t, n = gate col)
struct DzB {
  static constexpr bool kNContiguous = true;
  const float* dz;
  int G;
  __device__ float operator()(int bt, int n) const {
    return eegflow::bf16_round(dz[static_cast<size_t>(bt) * G + n]);
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
  if (H <= 0 || H > kMaxThreads || H % 32 != 0 || B <= 0 || T <= 0 || d0 <= 0 ||
      d1 < 0 || splits <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = 4 * H;
  const int BT = B * T;
  const size_t smem = 2 * static_cast<size_t>(G) * kRows * sizeof(float);
  cudaError_t err = eegflow::allow_dynamic_smem(lstm_bwd_chain_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  lstm_bwd_chain_kernel<<<(B + kRows - 1) / kRows, H, smem, stream>>>(res, g, whh_t, dz, B,
                                                                      T, H, reverse);
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
