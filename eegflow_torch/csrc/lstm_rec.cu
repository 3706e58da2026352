// LSTM recurrence over precomputed gates, forward and backward, float32, for
// Hopper (sm_90a): the float32 policy's pair.
//
// Replaces: eegflow/nn/pallas_lstm.py _lstm_chunk_kernel (entry
// lstm_recurrence_pallas) and _lstm_bwd_chunk_kernel (entry
// lstm_recurrence_backward), both in their float32 mode: the kernels the
// classifier runs under the float32 policy, 3 layers x 2 directions per eval
// batch or training micro-step. The input projection gates = x . W_ih + b,
// dW_ih, dW_hh, dx and db stay outside, as the reference leaves them to XLA.
//
// Forward, kernel 1 (eegflow_lstm_rec_fwd), per step t (walked T-1..0 for
// the reverse direction, h written at its natural position), zero initial
// state:
//   z = gates[t] + h_prev . W_hh        (float32 products and sums)
//   i, f, o = 0.5 tanh(z/2) + 0.5;  g = tanh(z)
//   c = f c_prev + i g;  h = o tanh(c)
// writes h (B, T, H) and, in training mode (c_out given), c (B, T, H).
//
// Backward, kernel 5 (eegflow_lstm_rec_bwd), from the forward's (gates, h,
// c), the upstream gradient g of h and W_hh. With h_prev[t], c_prev[t] the
// state before step t (t-1 forward, t+1 reverse, zero before the direction's
// first step), the activations are recomputed from z[t] = gates[t] + h_prev[t]
// . W_hh and the adjoint walks against the direction of time:
//   dh = g[t] + dh_carry;  do = dh tanh(c);  dc = dh o (1 - tanh^2 c) + dc_carry
//   dz = [dc g i(1-i), dc c_prev f(1-f), dc i (1-g^2), do o(1-o)]
//   dc_carry = dc f;  dh_carry = dz . W_hh^T            (float32)
// and writes dgates = dz (B, T, 4H).
//
// What bounds them on the card: both recurrences are serial in t and need
// all of W_hh every step (1 MB float32 at H = 256, over the 227 KB a block
// may hold). Kernel 1's products are 2 B T H 4H operations, 69 GFLOP at
// B = 512, T = 256, H = 256: 1.03 ms at the card's 67 TFLOP/s of float32
// outside the tensor cores (TF32 is off, so they cannot compute this
// function), above its 0.77 GB of HBM traffic (0.23 ms). Once the weights
// stay on chip the products bound it: the card holds 15 clusters of 8 such
// CTAs, so B = 512 runs 11 clusters of 48 rows on 88 SMs and a step costs
// ~15 us, ~9.6 of them the product, ~1.3 the exchange of h, the rest the
// cell update and the cluster barrier (H100 80GB HBM3 at 700 W, python -m
// eegflow_torch.kernels.ablate).
//
// Kernel 1's design, after kernel 2's recurrence (lstm_fwd.cu) in float32:
// a thread-block cluster (lstm_cluster.cuh) of hc CTAs owns a tile of 16,
// 32 or 48 batch rows and one direction; each CTA owns U = H / hc units (8
// CTAs of 32 at H = 256) and keeps W_hh[:, the 4U gate columns of its
// units] in shared memory for the whole launch, float32, in the layout
// (k, unit, gate) of nn/lstm_plan.py rec_slices (128 KB at H = 256; at
// H = 512 its first k_res rows, the rest read from L2 each step). Beside it
// h_{t-1} of the tile is double-buffered in float32, rows of H + 4. Thread
// (row group q of 4, unit uu) computes all four gates of its unit for
// kR = rows / 4 rows on CUDA-core FMA: per k one 16-byte load of the unit's
// four weights (the warp's 32 lanes read 32 consecutive units) and one
// 16-byte broadcast load of h per row and four k, 4 kR accumulators, c in
// registers. Each output is summed with k ascending in one fmaf chain from
// 0 and the gate added last, the order of kernel 5's z GEMM (gemm.cuh,
// ZStore), so kernel 5's recomputed z is bitwise the forward's. The new h
// of the CTA's units goes to every CTA of the cluster through distributed
// shared memory, as 16-byte stores after a 4 x 4 transpose across each quad
// (rows by units); then one cluster barrier a step, with the HBM stores of h
// and c and the next step's gate loads between its arrive and wait. Rows
// past B are masked; the batch is not padded. No atomics: a launch repeats
// bitwise.
//
// Kernel 5's design: (1) z for all B*T rows as one tiled GEMM (gemm.cuh)
// written into dgates, with the forward's product order (k ascending, fmaf
// from 0, then + gates); (2) the serial chain, one CTA per kRows batch rows
// and one thread per unit, reads z, overwrites it with dz in place and
// carries dh through dz . W_hh^T read from L2 (the wrapper passes W_hh^T so
// the reads are coalesced).

#include <stdint.h>

#include "common.cuh"
#include "gemm.cuh"
#include "lstm_cluster.cuh"
#include "mma_gemm.cuh"

namespace {

using eegflow::ClusterGeom;

// What a kernel 1 launch writes besides h: nothing (eval), c (training),
// or c and the pre-activations z (the check of kernel 5's recomputation).
enum RecMode { kRecEval = 0, kRecTrain = 1, kRecZ = 2 };

// Four k of a thread's product: its kR rows' h at k..k+3 (one float4 each,
// ldh floats apart) times the (i, f, g, o) weights of its unit at each k,
// added into acc with k ascending.
template <int kR>
__device__ __forceinline__ void rec_kquad(float (&acc)[kR][4], const float* h, int ldh,
                                          const float4 (&w)[4]) {
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const float4 hv = *reinterpret_cast<const float4*>(h + r * ldh);
    const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      acc[r][0] = fmaf(hk[kk], w[kk].x, acc[r][0]);
      acc[r][1] = fmaf(hk[kk], w[kk].y, acc[r][1]);
      acc[r][2] = fmaf(hk[kk], w[kk].z, acc[r][2]);
      acc[r][3] = fmaf(hk[kk], w[kk].w, acc[r][3]);
    }
  }
}

// Kernel 1. Thread i of cluster CTA `rank` (blockDim 4U) owns unit
// u = rank U + i % U and the kR = 4 kMT rows kR (i / U) .. kR (i / U) + kR - 1
// of the cluster's tile. wslice: (hc, H, U) float4 (i, f, g, o) weights.
template <int kMode, int kMT, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads, 1)
lstm_rec_fwd_kernel(const float* __restrict__ gates, const float4* __restrict__ wslice,
                    float* __restrict__ h_out, float* __restrict__ c_out,
                    float* __restrict__ z_out, int B, int T, int H, int k_res, int reverse) {
  constexpr int kR = 4 * kMT;
  extern __shared__ __align__(16) uint8_t smem[];
  const int U = blockDim.x / 4;
  const int hc = H / U;
  const uint32_t rank = eegflow::cluster_rank();
  const int lane = threadIdx.x % 32, q = lane & 3;
  const int grp = threadIdx.x / U;
  const int uu = threadIdx.x - grp * U;
  const int u = rank * U + uu;
  const int ucol = rank * U + (uu & ~3);  // the first unit of the thread's quad
  const int lr0 = grp * kR;               // the thread's first row in the tile
  const int row0 = (blockIdx.x / hc) * 16 * kMT + lr0;
  const int G = 4 * H;
  const int ldh = H + 4;  // floats per row of an h buffer
  const int buf_elems = 16 * kMT * ldh;
  float4* const wsm = reinterpret_cast<float4*>(smem);
  float* const hbuf = reinterpret_cast<float*>(smem + static_cast<size_t>(k_res) * U * 16);
  const float4* const wsl = wslice + static_cast<size_t>(rank) * H * U;

  // the resident rows of this CTA's slice, and h_{-1} = 0
  for (int i = threadIdx.x; i < k_res * U; i += blockDim.x) wsm[i] = wsl[i];
  for (int i = threadIdx.x; i < buf_elems; i += blockDim.x) hbuf[i] = 0.f;

  float c[kR], pre[kR][4];
#pragma unroll
  for (int r = 0; r < kR; ++r) c[r] = 0.f;
  // the gates of step t for this thread's (row, unit) pairs
  auto load_pre = [&](int t) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int row = row0 + r;
      const float* p = gates + (static_cast<size_t>(row) * T + t) * G + u;
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        float v = 0.f;
        if (row < B) v = __ldcs(p + gate * H);
        pre[r][gate] = v;
      }
    }
  };
  load_pre(reverse ? T - 1 : 0);
  eegflow::cluster_arrive();
  eegflow::cluster_wait();

  int p = 0;
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    // h_{t-1} . W_hh-slice for the thread's rows and unit: the resident k
    // from shared memory, the rest from L2, k ascending
    float acc[kR][4];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) acc[r][gate] = 0.f;
    const float* hp = hbuf + p * buf_elems + lr0 * ldh;
    const float4* ws = wsm + uu;
#pragma unroll 2
    for (int k = 0; k < k_res; k += 4) {
      const float4 w[4] = {ws[k * U], ws[(k + 1) * U], ws[(k + 2) * U], ws[(k + 3) * U]};
      rec_kquad<kR>(acc, hp + k, ldh, w);
    }
    const float4* wg = wsl + uu;
#pragma unroll 2
    for (int k = k_res; k < H; k += 4) {
      const float4 w[4] = {__ldg(wg + k * U), __ldg(wg + (k + 1) * U), __ldg(wg + (k + 2) * U),
                           __ldg(wg + (k + 3) * U)};
      rec_kquad<kR>(acc, hp + k, ldh, w);
    }

    // the cell update
    float hv[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float zi = pre[r][0] + acc[r][0], zf = pre[r][1] + acc[r][1];
      const float zg = pre[r][2] + acc[r][2], zo = pre[r][3] + acc[r][3];
      if (kMode == kRecZ && row0 + r < B) {
        float* z = z_out + (static_cast<size_t>(row0 + r) * T + t) * G + u;
        z[0] = zi;
        z[H] = zf;
        z[2 * H] = zg;
        z[3 * H] = zo;
      }
      const float ig = eegflow::sigmoid_tanh(zi);
      const float fg = eegflow::sigmoid_tanh(zf);
      const float gg = tanhf(zg);
      const float og = eegflow::sigmoid_tanh(zo);
      c[r] = fg * c[r] + ig * gg;
      hv[r] = og * tanhf(c[r]);
    }

    // h of this CTA's units to every CTA of the cluster: a 4 x 4 transpose
    // across each quad gives lane q row 4 b + q of the quad's four units
    uint4 chunk[kMT];
#pragma unroll
    for (int b = 0; b < kMT; ++b) {
      const uint32_t v[4] = {__float_as_uint(hv[4 * b]), __float_as_uint(hv[4 * b + 1]),
                             __float_as_uint(hv[4 * b + 2]), __float_as_uint(hv[4 * b + 3])};
      chunk[b] = eegflow::quad_transpose(v, lane);
    }
    const uint32_t next = eegflow::smem_addr(hbuf + (p ^ 1) * buf_elems);
    for (int r = 0; r < hc; ++r) {
      const uint32_t base = eegflow::map_rank(next, r);
#pragma unroll
      for (int b = 0; b < kMT; ++b)
        eegflow::st_cluster_v4(base + ((lr0 + 4 * b + q) * ldh + ucol) * 4, chunk[b]);
    }
    eegflow::cluster_arrive();

#pragma unroll
    for (int b = 0; b < kMT; ++b) {
      const int row = row0 + 4 * b + q;
      if (row < B)
        *reinterpret_cast<uint4*>(h_out + (static_cast<size_t>(row) * T + t) * H + ucol) =
            chunk[b];
    }
    if (kMode != kRecEval) {
#pragma unroll
      for (int r = 0; r < kR; ++r)
        if (row0 + r < B) __stcs(c_out + (static_cast<size_t>(row0 + r) * T + t) * H + u, c[r]);
    }
    if (s + 1 < T) load_pre(reverse ? t - 1 : t + 1);
    eegflow::cluster_wait();
    p ^= 1;
  }
}

template <int kMode>
cudaError_t rec_fwd_launch(const float* gates, const float4* wslice, float* h_out, float* c_out,
                           float* z_out, int B, int T, int H, int hc, int rows, int k_res,
                           int reverse, cudaStream_t stream) {
  const ClusterGeom geo{H, hc, rows, k_res, 2};
  if (!geo.valid() || B <= 0 || T <= 0 || (kMode != kRecEval && c_out == nullptr) ||
      (kMode == kRecZ && z_out == nullptr))
    return cudaErrorInvalidValue;
  return eegflow::with_tile(geo, [&](auto mt, auto threads) {
    return eegflow::launch_cluster(
        lstm_rec_fwd_kernel<kMode, decltype(mt)::value, decltype(threads)::value>, geo,
        (B + rows - 1) / rows, 1, stream, gates, wslice, h_out, c_out, z_out, B, T, H, k_res,
        reverse);
  });
}

template <int kMode>
cudaError_t rec_plan_query(int H, int hc, int rows, int k_res, int* smem, int* clusters) {
  const ClusterGeom geo{H, hc, rows, k_res, 2};
  *smem = static_cast<int>(geo.smem_bytes());
  *clusters = 0;
  return eegflow::with_tile(geo, [&](auto mt, auto threads) {
    return eegflow::max_active_clusters(
        lstm_rec_fwd_kernel<kMode, decltype(mt)::value, decltype(threads)::value>, geo, smem,
        clusters);
  });
}

// Kernel 5's chain: one CTA per kRows batch rows, one thread per hidden unit.
constexpr int kRows = 8;
constexpr int kMaxThreads = 512;  // H <= 512

__global__ void __launch_bounds__(kMaxThreads)
lstm_rec_bwd_chain_kernel(const float* __restrict__ c, const float* __restrict__ g,
                          const float* __restrict__ whh_t, float* __restrict__ dgates, int B,
                          int T, int H, int reverse) {
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
    const int tp = reverse ? t + 1 : t - 1;  // the step before t in the forward's order
    float* buf = dzs + p * G * kRows;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      float zi = 0.f, zf = 0.f, zg = 0.f, zo = 0.f;
      if (row < B) {
        const size_t bt = static_cast<size_t>(row) * T + t;
        float* zp = dgates + bt * G + u;  // z on entry, dz on exit
        const float ig = eegflow::sigmoid_tanh(zp[0]);
        const float fg = eegflow::sigmoid_tanh(zp[H]);
        const float gg = tanhf(zp[2 * H]);
        const float og = eegflow::sigmoid_tanh(zp[3 * H]);
        const float c_prev =
            (tp >= 0 && tp < T) ? c[(static_cast<size_t>(row) * T + tp) * H + u] : 0.f;
        const float tc = tanhf(c[bt * H + u]);
        const float dh = g[bt * H + u] + dh_carry[r];
        const float dout = dh * tc;
        const float dc = dh * og * (1.f - tc * tc) + dc_carry[r];
        dc_carry[r] = dc * fg;
        zi = dc * gg * ig * (1.f - ig);
        zf = dc * c_prev * fg * (1.f - fg);
        zg = dc * ig * (1.f - gg * gg);
        zo = dout * og * (1.f - og);
        zp[0] = zi;
        zp[H] = zf;
        zp[2 * H] = zg;
        zp[3 * H] = zo;
      }
      buf[u * kRows + r] = zi;
      buf[(H + u) * kRows + r] = zf;
      buf[(2 * H + u) * kRows + r] = zg;
      buf[(3 * H + u) * kRows + r] = zo;
    }
    __syncthreads();

    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    const float* wj = whh_t + u;
#pragma unroll 4
    for (int j = 0; j < G; ++j, wj += H) {
      const float w = *wj;
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

bool bad_shape(int B, int T, int H) {
  return H <= 0 || H > kMaxThreads || H % 32 != 0 || B <= 0 || T <= 0;
}

}  // namespace

// Operands and epilogue of the recomputation z = gates + h_prev . W_hh
// (gemm.cuh), in a named namespace so the GEMM template is instantiated on
// types with linkage.
namespace lstm_rec_ops {

// h_prev as the A operand: A(m = b*T + t, k = unit) = h[b, t -/+ 1, k], 0 at the edge
struct HPrevRowsA {
  static constexpr bool kMContiguous = false;
  const float* h;
  int T, H, reverse;
  __device__ float operator()(int bt, int k) const {
    const int b = bt / T;
    const int tp = (bt - b * T) + (reverse ? 1 : -1);
    if (tp < 0 || tp >= T) return 0.f;
    return h[(static_cast<size_t>(b) * T + tp) * H + k];
  }
};

// W_hh as the B operand: B(k = unit, n = gate column)
struct WhhB {
  static constexpr bool kNContiguous = true;
  const float* w;
  int G;
  __device__ float operator()(int k, int n) const { return w[static_cast<size_t>(k) * G + n]; }
};

// z = gates + the product, written where dz will go
struct ZStore {
  const float* gates;
  float* z;
  int G;
  __device__ void operator()(int, int bt, int n, float v) const {
    const size_t i = static_cast<size_t>(bt) * G + n;
    z[i] = gates[i] + v;
  }
};

}  // namespace lstm_rec_ops

namespace {

// Kernel 5's stage 1: z = gates + h_prev . W_hh for all B T rows into z.
cudaError_t rec_z(const float* gates, const float* h, const float* whh, float* z, int B, int T,
                  int H, int reverse, cudaStream_t stream) {
  using namespace lstm_rec_ops;
  const int G = 4 * H;
  return eegflow::gemm(HPrevRowsA{h, T, H, reverse}, WhhB{whh, G}, ZStore{gates, z, G}, B * T,
                       G, H, stream);
}

}  // namespace

// Kernel 1's shared memory per CTA and the clusters the card holds at once
// for mode (0 eval, 1 training, 2 training with z) at this geometry.
extern "C" int eegflow_lstm_rec_plan(int mode, int H, int hc, int rows, int k_res, int* smem,
                                     int* clusters) {
  cudaError_t err =
      mode == kRecEval    ? rec_plan_query<kRecEval>(H, hc, rows, k_res, smem, clusters)
      : mode == kRecTrain ? rec_plan_query<kRecTrain>(H, hc, rows, k_res, smem, clusters)
                          : rec_plan_query<kRecZ>(H, hc, rows, k_res, smem, clusters);
  return static_cast<int>(err);
}

// Kernel 1. gates (B, T, 4H) float32; wslice W_hh float32 in the layout of
// nn/lstm_plan.py rec_slices (hc, H, U, 4); h_out (B, T, H) float32; c_out
// (B, T, H) float32, or null in eval mode; (hc, rows, k_res) the cluster plan.
extern "C" int eegflow_lstm_rec_fwd(const float* gates, const float4* wslice, float* h_out,
                                    float* c_out, int B, int T, int H, int hc, int rows,
                                    int k_res, int reverse, cudaStream_t stream) {
  const cudaError_t err =
      c_out == nullptr
          ? rec_fwd_launch<kRecEval>(gates, wslice, h_out, nullptr, nullptr, B, T, H, hc, rows,
                                     k_res, reverse, stream)
          : rec_fwd_launch<kRecTrain>(gates, wslice, h_out, c_out, nullptr, B, T, H, hc, rows,
                                      k_res, reverse, stream);
  return static_cast<int>(err);
}

// Kernel 1 in training mode that also writes its pre-activations z_out
// (B, T, 4H) float32, and kernel 5's stage 1 alone (z into z_out from the
// forward's gates and h and W_hh (H, 4H)): the two sides of the check that
// kernel 5 recomputes the forward's z bit for bit.
extern "C" int eegflow_lstm_rec_fwd_z(const float* gates, const float4* wslice, float* h_out,
                                      float* c_out, float* z_out, int B, int T, int H, int hc,
                                      int rows, int k_res, int reverse, cudaStream_t stream) {
  return static_cast<int>(rec_fwd_launch<kRecZ>(gates, wslice, h_out, c_out, z_out, B, T, H, hc,
                                                rows, k_res, reverse, stream));
}

extern "C" int eegflow_lstm_rec_bwd_z(const float* gates, const float* h, const float* whh,
                                      float* z_out, int B, int T, int H, int reverse,
                                      cudaStream_t stream) {
  if (bad_shape(B, T, H)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(rec_z(gates, h, whh, z_out, B, T, H, reverse, stream));
}

// Kernel 5. gates (B, T, 4H), h, c, g (B, T, H) float32; whh (H, 4H) and
// whh_t (4H, H) float32. Output dgates (B, T, 4H) float32.
extern "C" int eegflow_lstm_rec_bwd(const float* gates, const float* h, const float* c,
                                    const float* g, const float* whh, const float* whh_t,
                                    float* dgates, int B, int T, int H, int reverse,
                                    cudaStream_t stream) {
  if (bad_shape(B, T, H)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = rec_z(gates, h, whh, dgates, B, T, H, reverse, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = 2 * static_cast<size_t>(4 * H) * kRows * sizeof(float);
  err = eegflow::allow_dynamic_smem(lstm_rec_bwd_chain_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  lstm_rec_bwd_chain_kernel<<<(B + kRows - 1) / kRows, H, smem, stream>>>(c, g, whh_t, dgates,
                                                                          B, T, H, reverse);
  return static_cast<int>(cudaGetLastError());
}
