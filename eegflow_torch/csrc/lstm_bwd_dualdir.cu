// Dual-direction LSTM backward for Hopper (sm_90a): both directions of a
// bidirectional layer in one launch.
//
// Replaces: eegflow/nn/pallas_lstm.py _bwd_dualdir_kernel (entry
// lstm_bwd_dualdir) under the default adjoint-residual contract
// (_ADJ_RES=1), with select dropout recovered from the already-dropped
// input (mask_from_x): the "dualdir" schedule of the bf16 training step, one
// launch per bidirectional layer (3 per micro-step).
//
// Inputs, per direction d in {forward, reverse}: the six float32 planes
// res_d (B, T, 6H) that lstm_fwd.cu writes in training mode, h_d (B, T, H)
// and the upstream gradient g_d (B, T, H); the input parts x_p (B, T, d_p)
// that both directions read (already dropped when mask_from_x), and the
// weights. Each direction's adjoint is kernel 3's (lstm_bwd.cu), the forward
// direction walking t downwards and the reverse one upwards:
//   dh = g[t] + dh_carry;   dc = dh E + dc_carry;   dc_carry = dc F
//   dz = [dc A, dc B, dc C, dh G];   dh_carry = bf16(dz) . bf16(W_hh)^T
// then, with v_d = bf16(dz_d) . bf16(W_ih_d,p)^T:
//   dx_p = where(x_p == 0, 0, v_f / keep) + where(x_p == 0, 0, v_r / keep)
//          (mask_from_x; plain v_f + v_r without it)
//   dW_ih_d,p = bf16(x_p)^T . bf16(dz_d)  (x_p as given: dropped, not re-masked)
//   dW_hh_d = bf16(h_prev_d)^T . bf16(dz_d);   db_d = sum of dz_d (float32)
// The two directions' dx are added in the kernel, forward then reverse.
//
// What bounds it on the card: each direction's chain is kernel 3's, serial in
// t and bound by latency (all of W_hh, 512 KB bf16 at H=256, from L2 every
// step). Kernel 3 runs the two chains one launch after the other with
// B/8 CTAs each (64 of 132 SMs at B=512). Here one chain kernel runs both
// directions side by side, 2 B/8 CTAs (128 at B=512), so the two chains
// share the time of one. The products are twice kernel 3's per launch
// (0.4 TFLOP at B=512, T=256, H=256, two parts) on CUDA cores.
//
// Design: kernel 3's chain (chain_direction, lstm_bwd_chain.cuh) on a grid
// of (B/8, 2), blockIdx.y the direction, each branch calling it with its
// direction's pointers, dz to a float32 scratch per direction.
// Then gemm.cuh runs kernel 3's products with its operand loaders: dx of the
// forward direction with the mask_from_x epilogue below, dx of the reverse
// direction adding the forward one in its epilogue, the weight gradients
// split over B T with fixed-order partial sums, db by fixed-order column
// sums. No atomics: a launch repeats bit for bit, and without dropout it
// equals two kernel 3 launches (forward, then reverse with dx_add).

#include <stdint.h>

#include "common.cuh"
#include "gemm.cuh"
#include "lstm_bwd_chain.cuh"

namespace {

struct Dir {
  const float* res;
  const float* g;
  const __nv_bfloat16* whh_t;
  float* dz;
};

// grid (ceil(B / 8), 2): blockIdx.y 0 the forward direction, 1 the reverse
__global__ void __launch_bounds__(kChainMaxThreads)
lstm_bwd_dualdir_chain_kernel(Dir fwd, Dir rev, int B, int T, int H) {
  if (blockIdx.y == 0)
    chain_direction(fwd.res, fwd.g, fwd.whh_t, fwd.dz, B, T, H, 0);
  else
    chain_direction(rev.res, rev.g, rev.whh_t, rev.dz, B, T, H, 1);
}

}  // namespace

namespace lstm_bwd_ops {

// dx epilogue: the mask recovered from the dropped input's zeros, then the
// other direction's dx (the reverse direction adds the forward one)
struct DxFromXStore {
  float* dx;
  const float* x;
  const float* add;
  int D;
  int mask_from_x;
  float inv_keep;
  __device__ void operator()(int, int bt, int d, float v) const {
    const size_t i = static_cast<size_t>(bt) * D + d;
    if (mask_from_x) v = x[i] == 0.f ? 0.f : v * inv_keep;
    if (add != nullptr) v = add[i] + v;
    dx[i] = v;
  }
};

}  // namespace lstm_bwd_ops

using namespace lstm_bwd_ops;

// Per direction (suffix _f forward, _r reverse): res (B, T, 6H), h, g (B, T,
// H) float32; w0, w1 (d_p, 4H) and whh_t (4H, H) bf16; outputs dw_ih (d0 +
// d1, 4H), dw_hh (H, 4H), db (4H) float32; scratch dz (B, T, 4H) float32.
// Shared: x_p (B, T, d_p) float32, outputs dx_p (B, T, d_p) float32 (the two
// directions' sum), part (splits * max(d0, d1, H) * 4H) float32. x1, the w1
// and dx1 may be null when d1 == 0. mask_from_x: 1 when x_p carries the
// select dropout (dropped positions exactly 0) with keep = 1 / inv_keep.
extern "C" int eegflow_lstm_bwd_dualdir(
    const float* res_f, const float* h_f, const float* g_f, const float* res_r,
    const float* h_r, const float* g_r, const float* x0, const float* x1, int d0, int d1,
    int mask_from_x, float inv_keep, const __nv_bfloat16* w0_f, const __nv_bfloat16* w1_f,
    const __nv_bfloat16* whh_t_f, const __nv_bfloat16* w0_r, const __nv_bfloat16* w1_r,
    const __nv_bfloat16* whh_t_r, float* dx0, float* dx1, float* dw_ih_f, float* dw_hh_f,
    float* db_f, float* dw_ih_r, float* dw_hh_r, float* db_r, float* dz_f, float* dz_r,
    float* part, int splits, int B, int T, int H, cudaStream_t stream) {
  if (H <= 0 || H > kChainMaxThreads || H % 32 != 0 || B <= 0 || T <= 0 || d0 <= 0 ||
      d1 < 0 || splits <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = 4 * H;
  const int BT = B * T;
  const size_t smem = chain_smem_bytes(H);
  cudaError_t err = eegflow::allow_dynamic_smem(lstm_bwd_dualdir_chain_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + kChainRows - 1) / kChainRows, 2);
  lstm_bwd_dualdir_chain_kernel<<<grid, H, smem, stream>>>(
      Dir{res_f, g_f, whh_t_f, dz_f}, Dir{res_r, g_r, whh_t_r, dz_r}, B, T, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const float* xs[2] = {x0, x1};
  const __nv_bfloat16* ws[2][2] = {{w0_f, w1_f}, {w0_r, w1_r}};
  const float* dzs[2] = {dz_f, dz_r};
  float* dw_ih[2] = {dw_ih_f, dw_ih_r};
  float* dxs[2] = {dx0, dx1};
  const int ds[2] = {d0, d1};
  for (int dir = 0; dir < 2; ++dir) {
    size_t row_off = 0;
    for (int q = 0; q < (d1 > 0 ? 2 : 1); ++q) {
      err = eegflow::gemm(DzRowsA{dzs[dir], G}, WihT{ws[dir][q], G},
                          DxFromXStore{dxs[q], xs[q], dir == 1 ? dxs[q] : nullptr, ds[q],
                                       mask_from_x, inv_keep},
                          BT, ds[q], G, stream);
      if (err != cudaSuccess) return static_cast<int>(err);
      err = eegflow::gemm_split_k(MaskedXA{xs[q], nullptr, ds[q], 1.f}, DzB{dzs[dir], G},
                                  dw_ih[dir] + row_off * G, part, ds[q], G, BT, splits,
                                  stream);
      if (err != cudaSuccess) return static_cast<int>(err);
      row_off += ds[q];
    }
  }
  err = eegflow::gemm_split_k(HPrevA{h_f, T, H, 0}, DzB{dz_f, G}, dw_hh_f, part, H, G, BT,
                              splits, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = eegflow::gemm_split_k(HPrevA{h_r, T, H, 1}, DzB{dz_r, G}, dw_hh_r, part, H, G, BT,
                              splits, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = eegflow::colsum_split(dz_f, db_f, part, BT, G, splits, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(eegflow::colsum_split(dz_r, db_r, part, BT, G, splits, stream));
}
