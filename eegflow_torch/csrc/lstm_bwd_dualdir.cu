// Dual-direction LSTM backward for Hopper (sm_90a): both directions of a
// bidirectional layer in one launch.
//
// Replaces: eegflow/nn/pallas_lstm.py _bwd_dualdir_kernel (entry
// lstm_bwd_dualdir) under the default adjoint-residual contract
// (_ADJ_RES=1), with select dropout recovered from the already-dropped
// input (mask_from_x): the "dualdir" schedule of the bf16 training step, one
// launch per bidirectional layer (3 per micro-step). The planes may be bf16
// (EEGFLOW_RES_BF16=1, the reference's cast_z), upcast on load.
//
// Inputs, per direction d in {forward, reverse}: the six float32 (or bf16)
// planes res_d (B, T, 6H) that lstm_fwd.cu writes in training mode, h_d (B, T, H)
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
// What bounds it on the card: each direction's chain is kernel 3's, serial
// in t; the products are twice kernel 3's per launch (0.7 TFLOP at B = 512,
// T = 256, H = 256, two parts). Both directions need 2 x 16 clusters of 32
// rows, over the 30 four-CTA clusters an H100 holds at once, so the plan
// (nn/lstm_plan.py) takes 48-row tiles: 22 clusters on 88 SMs in one wave,
// both directions resident together (python -m eegflow_torch.kernels.ablate
// --variant stamps). The chain's serial step at three m-tiles is therefore
// its cost; the shared chain (lstm_bwd_chain.cuh) is laid out for it: the
// dh_carry product split over warp pairs by accumulator chain, the dz
// exchange interleaved with its computation, the dz rows to HBM by TMA bulk
// stores, and the planes prefetched into L2 two steps ahead and loaded after
// the product, which at three m-tiles held them in 255 registers.
//
// Design: kernel 3's cluster chain (chain_direction, lstm_bwd_chain.cuh) on
// a grid of (row tiles x cluster, 2), blockIdx.y the direction, each branch
// calling it with its direction's pointers; each direction's bf16 dz and db
// partials to its own scratch. Then kernel 3's tensor-core products
// (bwd_products): dx of the forward direction with the mask_from_x epilogue
// below, dx of the reverse direction adding the forward one in its
// epilogue, the weight gradients split over B T with fixed-order partial
// sums, db from the per-16-row partials in order. No atomics: a launch
// repeats bit for bit, and without dropout it equals two kernel 3 launches
// (forward, then reverse with dx_add) bit for bit.

#include <stdint.h>

#include "common.cuh"
#include "lstm_bwd_chain.cuh"

namespace {

using eegflow::ClusterGeom;

template <typename ResT>
struct Dir {
  const ResT* res;
  const float* g;
  const uint4* wfrag;
  __nv_bfloat16* dz16;
  float* db_part;
};

// grid (row tiles x cluster, 2): blockIdx.y 0 the forward direction, 1 the reverse
template <int kMT, int kMaxThreads, typename ResT>
__global__ void __launch_bounds__(kMaxThreads, 1)
lstm_bwd_dualdir_chain_kernel(Dir<ResT> fwd, Dir<ResT> rev, int B, int T, int H, int k_res) {
  if (blockIdx.y == 0)
    chain_direction<kMT, false>(fwd.res, nullptr, fwd.g, fwd.wfrag, fwd.dz16, fwd.db_part, B,
                                T, H, k_res, 0);
  else
    chain_direction<kMT, false>(rev.res, nullptr, rev.g, rev.wfrag, rev.dz16, rev.db_part, B,
                                T, H, k_res, 1);
}

}  // namespace

namespace lstm_bwd_ops {

// dx epilogue: the mask recovered from the dropped input's zeros, then the
// other direction's dx (the reverse direction adds the forward one)
struct DxFromXStore {
  float* dx;
  const float* x;
  const float* add;
  int M, D;
  int mask_from_x;
  float inv_keep;
  __device__ void one(size_t i, float v) const {
    if (mask_from_x) v = x[i] == 0.f ? 0.f : v * inv_keep;
    if (add != nullptr) v = add[i] + v;
    dx[i] = v;
  }
  __device__ void operator()(int, int bt, int d, float v0, float v1) const {
    if (bt >= M) return;
    const size_t i = static_cast<size_t>(bt) * D + d;
    if (d < D) one(i, v0);
    if (d + 1 < D) one(i + 1, v1);
  }
};

}  // namespace lstm_bwd_ops

using namespace lstm_bwd_ops;

// The dual-direction chain's shared memory per CTA and the clusters the card
// holds at once at this geometry, on float32 planes or (res_bf16) bf16 ones.
extern "C" int eegflow_lstm_bwd_dualdir_plan(int res_bf16, int H, int hc, int rows, int k_res,
                                             int* smem, int* clusters) {
  const ClusterGeom geo{H, hc, rows, k_res, 1};
  *smem = static_cast<int>(geo.smem_bytes());
  *clusters = 0;
  auto query = [&](auto tag) {
    return eegflow::with_tile(geo, [&](auto mt, auto threads) {
      return eegflow::max_active_clusters(
          lstm_bwd_dualdir_chain_kernel<decltype(mt)::value, decltype(threads)::value,
                                        typename decltype(tag)::type>,
          geo, smem, clusters);
    });
  };
  cudaError_t err = res_bf16 ? query(eegflow::Type<__nv_bfloat16>{})
                             : query(eegflow::Type<float>{});
  return static_cast<int>(err);
}

// Per direction (suffix _f forward, _r reverse): res (B, T, 6H) float32 (bf16
// when res_bf16), h, g (B, T, H) float32; w0, w1 (d_p, 4H) bf16 and wfrag
// W_hh^T in the fragment order of nn/lstm_plan.py bwd_fragments; outputs dw_ih
// (d0 + d1, 4H), dw_hh (H, 4H), db (4H) float32; scratch dz16 (B, T, 4H) bf16
// and db_part (ceil(B / 16), 4H) float32. Shared: x_p (B, T, d_p) float32,
// outputs dx_p (B, T, d_p) float32 (the two directions' sum), part (splits *
// max(d0, d1, H) * 4H) float32; (hc, rows, k_res) the cluster plan. x1, the w1
// and dx1 may be null when d1 == 0. mask_from_x: 1 when x_p carries the select
// dropout (dropped positions exactly 0) with keep = 1 / inv_keep.
extern "C" int eegflow_lstm_bwd_dualdir(
    const void* res_f, const float* h_f, const float* g_f, const void* res_r,
    const float* h_r, const float* g_r, int res_bf16, const float* x0, const float* x1, int d0,
    int d1, int mask_from_x, float inv_keep, const __nv_bfloat16* w0_f, const __nv_bfloat16* w1_f,
    const uint4* wfrag_f, const __nv_bfloat16* w0_r, const __nv_bfloat16* w1_r,
    const uint4* wfrag_r, float* dx0, float* dx1, float* dw_ih_f, float* dw_hh_f, float* db_f,
    float* dw_ih_r, float* dw_hh_r, float* db_r, __nv_bfloat16* dz16_f, __nv_bfloat16* dz16_r,
    float* db_part_f, float* db_part_r, float* part, int splits, int B, int T, int H, int hc,
    int rows, int k_res, cudaStream_t stream) {
  const ClusterGeom geo{H, hc, rows, k_res, 1};
  if (!geo.valid() || B <= 0 || T <= 0 || d0 <= 0 || d1 < 0 || splits <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto chain = [&](auto tag) {
    using ResT = typename decltype(tag)::type;
    const Dir<ResT> fwd{static_cast<const ResT*>(res_f), g_f, wfrag_f, dz16_f, db_part_f};
    const Dir<ResT> rev{static_cast<const ResT*>(res_r), g_r, wfrag_r, dz16_r, db_part_r};
    return eegflow::with_tile(geo, [&](auto mt, auto threads) {
      return eegflow::launch_cluster(
          lstm_bwd_dualdir_chain_kernel<decltype(mt)::value, decltype(threads)::value, ResT>,
          geo, (B + rows - 1) / rows, 2, stream, fwd, rev, B, T, H, k_res);
    });
  };
  cudaError_t err = res_bf16 ? chain(eegflow::Type<__nv_bfloat16>{})
                             : chain(eegflow::Type<float>{});
  if (err != cudaSuccess) return static_cast<int>(err);

  const float* xs[2] = {x0, x1};
  const __nv_bfloat16* ws[2][2] = {{w0_f, w1_f}, {w0_r, w1_r}};
  const __nv_bfloat16* dzs[2] = {dz16_f, dz16_r};
  const float* db_parts[2] = {db_part_f, db_part_r};
  const float* hs[2] = {h_f, h_r};
  float* dw_ih[2] = {dw_ih_f, dw_ih_r};
  float* dw_hh[2] = {dw_hh_f, dw_hh_r};
  float* dbs[2] = {db_f, db_r};
  float* dxs[2] = {dx0, dx1};
  const int ds[2] = {d0, d1};
  const int BT = B * T;
  for (int dir = 0; dir < 2; ++dir) {
    auto dx_store = [&](int qp) {
      return DxFromXStore{dxs[qp], xs[qp], dir == 1 ? dxs[qp] : nullptr, BT, ds[qp],
                          mask_from_x, inv_keep};
    };
    err = bwd_products(dx_store, hs[dir], xs, eegflow::MaskNone{}, ds, d1 > 0 ? 2 : 1, 1.f,
                       ws[dir], dzs[dir], db_parts[dir], dw_ih[dir], dw_hh[dir], dbs[dir], part,
                       splits, B, T, H, dir, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
