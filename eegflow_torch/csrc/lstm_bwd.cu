// Fused LSTM layer-direction backward for Hopper (sm_90a), kernel 3.
//
// Replaces: eegflow/nn/pallas_lstm.py _bwd_fused_kernel (entry
// lstm_bwd_fused) under the default adjoint-residual contract (_ADJ_RES=1)
// with uint8-mask input dropout, or (EEGFLOW_KERNEL_DROPOUT) the in-kernel
// PRNG dropout whose bits the port draws from Philox (philox.cuh) into the
// keep-bit plane of philox_bits.cu, and the sibling direction's dx added in
// (dx_add), the mode the training step runs 3 layers x 2 directions per
// micro-step; the planes may be bf16 (res_bf16, EEGFLOW_RES_BF16=1), widened
// on load.
//
// Inputs: the six float32 (or bf16) planes res (B, T, 6H) that lstm_fwd.cu
// writes in training mode, h (B, T, H), the upstream gradient g (B, T, H), the input
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
// What bounds it on the card: the chain is serial in t and each step needs
// all of W_hh^T (512 KB bf16 at H = 256) against the dz of every unit; the
// three products are 2 B T 4H (d0 + d1 + H) multiply-adds, 0.34 TFLOP at
// B = 512, T = 256, H = 256 with two parts (0.35 ms at the bf16 tensor-core
// peak), and the bytes in and out are 0.58 ms of HBM (bf16 planes take 0.40
// GB of it off). The serial chain's
// latency is what remains above the bound (lstm_bwd_chain.cuh): on an H100
// 80GB HBM3 at 700 W the chain takes ~2.5 ms of a ~5 ms launch at B = 512.
//
// Design, two stages per launch. (1) The chain of lstm_bwd_chain.cuh (shared
// with kernel 4) on thread-block clusters: W_hh^T split over the cluster's
// CTAs and resident in shared memory, bf16 dz exchanged through distributed
// shared memory, dh_carry on mma.sync; it writes bf16 dz (B, T, 4H) and
// per-16-row partials of db. (2) The products on the tensor-core GEMM of
// mma_gemm.cuh from the bf16 dz: dx with its mask and dx_add in the
// epilogue; dW_ih and dW_hh split over B T into partial sums that a second
// pass adds in a fixed order, as are db's partials. No atomics: the result
// is bitwise repeatable.

#include <stdint.h>

#include "common.cuh"
#include "lstm_bwd_chain.cuh"

namespace {

using eegflow::ClusterGeom;

template <int kMT, int kMaxThreads, typename ResT>
__global__ void __launch_bounds__(kMaxThreads, 1)
lstm_bwd_chain_kernel(const ResT* __restrict__ res, const float* __restrict__ g,
                      const uint4* __restrict__ wfrag, __nv_bfloat16* __restrict__ dz16,
                      float* __restrict__ db_part, int B, int T, int H, int k_res, int reverse) {
  chain_direction<kMT, false>(res, nullptr, g, wfrag, dz16, db_part, B, T, H, k_res,
                              reverse);
}

}  // namespace

using namespace lstm_bwd_ops;

// The chain's shared memory per CTA and the clusters the card holds at once
// at this geometry, on float32 planes or (res_bf16) bf16 ones.
extern "C" int eegflow_lstm_bwd_plan(int res_bf16, int H, int hc, int rows, int k_res, int* smem,
                                     int* clusters) {
  const ClusterGeom geo{H, hc, rows, k_res, 1};
  *smem = static_cast<int>(geo.smem_bytes());
  *clusters = 0;
  auto query = [&](auto tag) {
    return eegflow::with_tile(geo, [&](auto mt, auto threads) {
      return eegflow::max_active_clusters(
          lstm_bwd_chain_kernel<decltype(mt)::value, decltype(threads)::value,
                                typename decltype(tag)::type>,
          geo, smem, clusters);
    });
  };
  cudaError_t err = res_bf16 ? query(eegflow::Type<__nv_bfloat16>{})
                             : query(eegflow::Type<float>{});
  return static_cast<int>(err);
}

// res (B, T, 6H) float32 (bf16 when res_bf16), h, g (B, T, H), x_p (B, T,
// d_p) float32 with the dropout of the forward: the keep-bit planes bits_p,
// or uint8 masks m_p, or none, as eegflow_lstm_fwd_train takes them; w_p
// (d_p, 4H) bf16; wfrag W_hh^T bf16 in the fragment order of nn/lstm_plan.py
// bwd_fragments; add_p (B, T, d_p) or null. Outputs dx_p (B, T, d_p), dw_ih
// (d0 + d1, 4H), dw_hh (H, 4H), db (4H) float32. Scratch: dz16 (B, T, 4H)
// bf16, db_part (ceil(B / 16), 4H) and part (splits * max(d0, d1, H) * 4H)
// float32. (hc, rows, k_res): the cluster plan. x1, m1, bits1, w1, add1 and
// dx1 may be null when d1 == 0.
extern "C" int eegflow_lstm_bwd(const void* res, int res_bf16, const float* h, const float* g,
                                const float* x0, const float* x1, const uint8_t* m0,
                                const uint8_t* m1, const uint8_t* bits0,
                                const uint8_t* bits1, int d0, int d1, float inv_keep,
                                const __nv_bfloat16* w0, const __nv_bfloat16* w1,
                                const uint4* wfrag, const float* add0, const float* add1,
                                float* dx0, float* dx1, float* dw_ih, float* dw_hh, float* db,
                                __nv_bfloat16* dz16, float* db_part, float* part, int splits,
                                int B, int T, int H, int hc, int rows, int k_res, int reverse,
                                cudaStream_t stream) {
  const ClusterGeom geo{H, hc, rows, k_res, 1};
  if (!geo.valid() || B <= 0 || T <= 0 || d0 <= 0 || d1 < 0 || splits <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto chain = [&](auto tag) {
    using ResT = typename decltype(tag)::type;
    return eegflow::with_tile(geo, [&](auto mt, auto threads) {
      return eegflow::launch_cluster(
          lstm_bwd_chain_kernel<decltype(mt)::value, decltype(threads)::value, ResT>, geo,
          (B + rows - 1) / rows, 1, stream, static_cast<const ResT*>(res), g, wfrag, dz16,
          db_part, B, T, H, k_res, reverse);
    });
  };
  cudaError_t err = res_bf16 ? chain(eegflow::Type<__nv_bfloat16>{})
                             : chain(eegflow::Type<float>{});
  if (err != cudaSuccess) return static_cast<int>(err);

  const float* xs[2] = {x0, x1};
  const __nv_bfloat16* ws[2] = {w0, w1};
  const float* adds[2] = {add0, add1};
  float* const dxs[2] = {dx0, dx1};
  const int ds[2] = {d0, d1};
  return static_cast<int>(bwd_products_masked(h, xs, m0, m1, bits0, bits1, ds, inv_keep, ws,
                                              adds, dxs, dz16, db_part, dw_ih, dw_hh, db, part,
                                              splits, B, T, H, reverse, stream));
}
