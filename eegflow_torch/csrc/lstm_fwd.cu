// Fused LSTM layer-direction forward for Hopper (sm_90a), kernel 2: eval mode
// and two training modes.
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
// residuals of the two-pass backward (lstm_bwd_v2.cu). Either training mode
// takes its input dropout from uint8 masks or, in place of the reference's
// in-kernel PRNG dropout (_prng_block_masks under EEGFLOW_KERNEL_DROPOUT; the
// producer's dropped copy of EEGFLOW_FWD_DROPW=1 and the input block's
// out_seed, applied here by the consumer), from the Philox bits of
// philox.cuh, read in the A loader from the packed plane (1 bit an element)
// that philox_bits.cu draws once per layer for both directions.
//
// Per step t (walked T-1..0 for the reverse direction, h written at its
// natural position):
//   x_p = where(m_p[t], x_p[t] * (1/keep), 0)     (training mode with dropout)
//   z = b + sum_p bf16(x_p) . bf16(W_ih_p) + bf16(h) . bf16(W_hh)
//   i, f, o = 0.5 tanh(z/2) + 0.5;  g = tanh(z)
//   c = f c_prev + i g;  h = o tanh(c)      (c, h float32, zero initial state)
// Products of bf16-rounded operands are accumulated in float32. The input
// arrives as one or two parts (a bidirectional predecessor's halves) read
// through two pointers; they are never concatenated. Training mode also
// writes the six float32 adjoint planes of step t into res (B, T, 6H):
//   [g i(1-i), c_prev f(1-f), i(1-g^2), o(1-tanh^2 c), f, tanh(c) o(1-o)]
// so the backward (lstm_bwd.cu) needs neither c nor a transcendental.
// Raw-gate mode writes [i, f, g, o] (B, T, 4H) and c (B, T, H) instead; its
// backward recomputes tanh(c) and reads c_prev from c at t-1 (t+1 reverse).
// Eval mode writes no residuals. Either training mode may store its
// residuals (the planes, or the raw gates; c stays float32) in bf16, rounded
// to nearest even as the reference's astype(bfloat16) (res_bf16,
// EEGFLOW_RES_BF16=1), which halves the largest stream.
//
// What bounds it on the card: the recurrence is serial in t. Each step's
// h . W_hh needs all of W_hh (512 KB bf16 at H = 256, over the 227 KB a block
// may hold) and the h of every unit; the input projection does not depend
// on h. At B = 512, T = 256, H = 256 the products are 0.2 TFLOP (0.2 ms on
// the tensor cores) and training mode writes 0.8 GB of planes (0.24 ms of
// HBM; 0.4 GB in bf16): the bound is far below one microsecond a step, so
// the time is the latency of the serial step. On an H100 80GB HBM3 at 700 W
// a step of the recurrence takes ~5 us at 32 rows a cluster (B = 512), its
// product, DSMEM exchange, HBM stores and pre-gate loads under 1 us each,
// the rest the cluster barrier and the gate math (python -m
// eegflow_torch.kernels.ablate).
//
// Design, two stages per launch:
// (1) The input projection b + sum_p bf16(mask_p(x_p)) . bf16(W_ih_p) for all
//     B T rows at once on the tensor cores (mma_gemm.cuh): the mask (a uint8
//     byte or a plane's bit an element, read) and 1/keep
//     applied in the A loader before the bf16 rounding, the two parts as two
//     K segments, the result to a float32 pre-gate scratch (B, T, 4H).
// (2) The recurrence on thread-block clusters (lstm_cluster.cuh): a cluster
//     of H/64 CTAs owns 16, 32 or 48 batch rows; each CTA owns 64 units and
//     holds W_hh[:, their 256 gate columns] (128 KB at H = 256) in shared
//     memory for the whole launch, in an order where one warp's four mma
//     n-tiles are the i, f, g, o columns of the same 8 units. Per step its 8 warps run
//     bf16(h_{t-1}) . W_hh-slice on mma.sync; each thread's accumulators then
//     hold all four gates of its (row, unit) pairs, so the cell update needs
//     no exchange and c stays in registers. The bf16 h of the CTA's units
//     goes to every CTA of the cluster through distributed shared memory
//     (double-buffered), then one cluster barrier; h, the residual stores and
//     the next step's pre-gate loads are issued between its arrive and wait.
//     Rows past B are masked; the batch is not padded. The three modes are
//     one template, with the residual's element type a parameter. At H = 512
//     the slice exceeds shared memory: its first rows stay resident and the
//     rest is read from L2 each step (nn/lstm_plan.py).

#include <stdint.h>

#include "common.cuh"
#include "lstm_cluster.cuh"
#include "mma_gemm.cuh"

namespace {

using eegflow::ClusterGeom;

// What a launch writes besides h.
enum Mode { kEval = 0, kPlanes = 1, kGates = 2 };

// a pair of adjacent residuals, streamed out: float32, or bf16 (nearest even)
__device__ __forceinline__ void store_res(float* p, float a, float b) {
  __stcs(reinterpret_cast<float2*>(p), make_float2(a, b));
}
__device__ __forceinline__ void store_res(__nv_bfloat16* p, float a, float b) {
  __stcs(reinterpret_cast<unsigned int*>(p), eegflow::pack_bf16(a, b));
}

// b + the projection's sum, to the pre-gate scratch (M = B T rows of 4H)
struct PreStore {
  float* pre;
  const float* bias;
  int M, N;
  __device__ void operator()(int, int m, int n, float v0, float v1) const {
    if (m >= M || n >= N) return;
    *reinterpret_cast<float2*>(pre + static_cast<size_t>(m) * N + n) =
        make_float2(bias[n] + v0, bias[n + 1] + v1);
  }
};

// One 16-deep k-tile of a warp's product for each m-tile: A (h, 16 rows a
// m-tile, ld_bytes apart) by ldmatrix at a_addr, B the k-tile's fragments of
// the i, f (b01) and g, o (b23) columns of the warp's octet.
template <int kMT>
__device__ __forceinline__ void fwd_ktile(float (&acc)[kMT][4][4], uint32_t a_addr, int ld_bytes,
                                          uint4 b01, uint4 b23) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    uint32_t a[4];
    eegflow::ldmatrix_x4(a, a_addr + mt * 16 * ld_bytes);
    eegflow::mma_bf16(acc[mt][0], a, b01.x, b01.y);
    eegflow::mma_bf16(acc[mt][1], a, b01.z, b01.w);
    eegflow::mma_bf16(acc[mt][2], a, b23.x, b23.y);
    eegflow::mma_bf16(acc[mt][3], a, b23.z, b23.w);
  }
}

// Stage 2. Thread (warp w, lane = 4 g + q) of cluster CTA `rank` owns the
// units u0 = 8 (rank * warps + w) + 2 q and u0 + 1 and, in m-tile mt, the rows
// 16 mt + g and 16 mt + g + 8 of the cluster's tile.
// res_out holds ResT (float or bf16).
template <int kMode, typename ResT, int kMT, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads, 1)
lstm_fwd_rec_kernel(const float* __restrict__ pre, const uint4* __restrict__ wfrag,
                    float* __restrict__ h_out, ResT* __restrict__ res_out,
                    float* __restrict__ c_out, int B, int T, int H, int k_res, int reverse) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, q = lane & 3;
  const int hc = H / (8 * warps);
  const uint32_t rank = eegflow::cluster_rank();
  const int row0 = (blockIdx.x / hc) * 16 * kMT;
  const int octet = rank * warps + warp;
  const int u0 = octet * 8 + 2 * q;
  const int G = 4 * H;
  const int KT = H / 16, KT_res = k_res / 16;
  const int ldh = H + 8;  // bf16 elements per row of an h buffer
  const int buf_elems = 16 * kMT * ldh;
  uint4* const wsm = reinterpret_cast<uint4*>(smem);
  __nv_bfloat16* const hbuf =
      reinterpret_cast<__nv_bfloat16*>(smem + static_cast<size_t>(warps) * KT_res * 1024);

  // the resident part of this CTA's slice: per octet, its first KT_res k-tiles
  for (int i = threadIdx.x; i < warps * KT_res * 64; i += blockDim.x) {
    const int w = i / (KT_res * 64);
    wsm[i] = wfrag[(static_cast<size_t>(rank) * warps + w) * KT * 64 + (i - w * KT_res * 64)];
  }
  for (int i = threadIdx.x; i < buf_elems; i += blockDim.x) hbuf[i] = __float2bfloat16(0.f);

  float c[kMT][4], pre_r[kMT][4][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[mt][e] = 0.f;

  // pre-gates of step t for this thread's (row, unit) pairs: [mt][gate][2 rh + uu]
  auto load_pre = [&](int t) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int row = row0 + 16 * mt + 8 * rh + g;
        const float* p = pre + (static_cast<size_t>(row) * T + t) * G + u0;
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) {
          float2 v = make_float2(0.f, 0.f);
          if (row < B) v = __ldcs(reinterpret_cast<const float2*>(p + gate * H));
          pre_r[mt][gate][2 * rh] = v.x;
          pre_r[mt][gate][2 * rh + 1] = v.y;
        }
      }
  };
  load_pre(reverse ? T - 1 : 0);
  eegflow::cluster_arrive();
  eegflow::cluster_wait();

  const uint32_t a_lane = ((lane & 15) * ldh + (lane >> 4) * 8) * 2;
  int p = 0;
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    // h_{t-1} . W_hh-slice: even and odd k-tiles in two accumulator sets
    // (eight independent mma chains a warp), the resident k-tiles from
    // shared memory, the rest from L2, then the two sets added
    float acc[kMT][4][4], acc_odd[kMT][4][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int gate = 0; gate < 4; ++gate)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][gate][e] = acc_odd[mt][gate][e] = 0.f;
    const uint32_t a_base = eegflow::smem_addr(hbuf + p * buf_elems) + a_lane;
    const uint4* ws = wsm + warp * KT_res * 64 + lane;
#pragma unroll 2
    for (int kt = 0; kt < KT_res; kt += 2) {
      const uint4* w = ws + kt * 64;
      fwd_ktile(acc, a_base + kt * 32, ldh * 2, w[0], w[32]);
      fwd_ktile(acc_odd, a_base + kt * 32 + 32, ldh * 2, w[64], w[96]);
    }
    const uint4* wg = wfrag + static_cast<size_t>(octet) * KT * 64 + lane;
#pragma unroll 2
    for (int kt = KT_res; kt < KT; kt += 2) {
      const uint4* w = wg + kt * 64;
      fwd_ktile(acc, a_base + kt * 32, ldh * 2, __ldg(w), __ldg(w + 32));
      fwd_ktile(acc_odd, a_base + kt * 32 + 32, ldh * 2, __ldg(w + 64), __ldg(w + 96));
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int gate = 0; gate < 4; ++gate)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][gate][e] += acc_odd[mt][gate][e];

    // the cell update; res_v holds what the stores after the arrive write
    float hv[kMT][4];
    float res_v[kMT][kMode == kPlanes ? 6 : (kMode == kGates ? 5 : 1)][4];
    uint32_t packed[kMT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ig = eegflow::sigmoid_tanh(pre_r[mt][0][e] + acc[mt][0][e]);
        const float fg = eegflow::sigmoid_tanh(pre_r[mt][1][e] + acc[mt][1][e]);
        const float gg = tanhf(pre_r[mt][2][e] + acc[mt][2][e]);
        const float og = eegflow::sigmoid_tanh(pre_r[mt][3][e] + acc[mt][3][e]);
        const float c_prev = c[mt][e];
        c[mt][e] = fg * c_prev + ig * gg;
        const float tc = tanhf(c[mt][e]);
        hv[mt][e] = og * tc;
        if (kMode == kPlanes) {
          res_v[mt][0][e] = gg * (ig * (1.f - ig));
          res_v[mt][1][e] = c_prev * (fg * (1.f - fg));
          res_v[mt][2][e] = ig * (1.f - gg * gg);
          res_v[mt][3][e] = og * (1.f - tc * tc);
          res_v[mt][4][e] = fg;
          res_v[mt][5][e] = tc * (og * (1.f - og));
        } else if (kMode == kGates) {
          res_v[mt][0][e] = ig;
          res_v[mt][1][e] = fg;
          res_v[mt][2][e] = gg;
          res_v[mt][3][e] = og;
          res_v[mt][4][e] = c[mt][e];
        }
      }
      packed[mt][0] = eegflow::pack_bf16(hv[mt][0], hv[mt][1]);
      packed[mt][1] = eegflow::pack_bf16(hv[mt][2], hv[mt][3]);
    }

    // bf16 h of this CTA's units to every CTA of the cluster: each quad
    // gathers its octet's 16 bytes per row, and lane q stores them to the
    // ranks q, q + 4
    uint4 chunk[kMT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) chunk[mt][rh] = eegflow::quad_gather(packed[mt][rh], lane);
    const uint32_t next = eegflow::smem_addr(hbuf + (p ^ 1) * buf_elems);
    for (int r = q; r < hc; r += 4) {
      const uint32_t base = eegflow::map_rank(next, r);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh)
          eegflow::st_cluster_v4(base + ((16 * mt + 8 * rh + g) * ldh + octet * 8) * 2,
                                 chunk[mt][rh]);
    }
    eegflow::cluster_arrive();

#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int row = row0 + 16 * mt + 8 * rh + g;
        if (row >= B) continue;
        const size_t bt = static_cast<size_t>(row) * T + t;
        const int e = 2 * rh;
        *reinterpret_cast<float2*>(h_out + bt * H + u0) = make_float2(hv[mt][e], hv[mt][e + 1]);
        if (kMode == kPlanes) {
          ResT* z = res_out + bt * 6 * H + u0;
#pragma unroll
          for (int k = 0; k < 6; ++k) store_res(z + k * H, res_v[mt][k][e], res_v[mt][k][e + 1]);
        } else if (kMode == kGates) {
          ResT* z = res_out + bt * 4 * H + u0;
#pragma unroll
          for (int k = 0; k < 4; ++k) store_res(z + k * H, res_v[mt][k][e], res_v[mt][k][e + 1]);
          __stcs(reinterpret_cast<float2*>(c_out + bt * H + u0),
                 make_float2(res_v[mt][4][e], res_v[mt][4][e + 1]));
        }
      }
    if (s + 1 < T) load_pre(reverse ? t - 1 : t + 1);
    eegflow::cluster_wait();
    p ^= 1;
  }
}

template <int kMode, typename ResT, class Src>
int launch(const float* x0, const float* x1, const Src& src, int d0, int d1, float inv_keep,
           const __nv_bfloat16* w0, const __nv_bfloat16* w1, const float* bias,
           const uint4* wfrag, float* pre, float* h_out, void* res_out, float* c_out, int B,
           int T, int H, int hc, int rows, int k_res, int reverse, cudaStream_t stream) {
  const ClusterGeom geo{H, hc, rows, k_res, 0};
  if (!geo.valid() || B <= 0 || T <= 0 || d0 <= 0 || d1 < 0 ||
      (kMode != kEval && res_out == nullptr) || (kMode == kGates && c_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = 4 * H;
  const int BT = B * T;
  cudaError_t err = eegflow::mma_gemm(
      eegflow::MaskedXRows<Src>{{x0, x1}, src, {d0, d1}, BT, inv_keep},
      eegflow::Bf16Cols{{w0, w1}, {d0, d1}, G, G}, PreStore{pre, bias, BT, G}, BT, G, d0, d1,
      stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = eegflow::with_tile(geo, [&](auto mt, auto threads) {
    return eegflow::launch_cluster(
        lstm_fwd_rec_kernel<kMode, ResT, decltype(mt)::value, decltype(threads)::value>, geo,
        (B + rows - 1) / rows, 1, stream, pre, wfrag, h_out, static_cast<ResT*>(res_out), c_out,
        B, T, H, k_res, reverse);
  });
  return static_cast<int>(err);
}

// A training mode's launch on the mask source of its arguments
// (with_mask_source: the keep-bit planes bits_p, else the uint8 masks m_p,
// else none) and its residual type (bf16 when res_bf16).
template <int kMode>
int launch_train(const float* x0, const float* x1, const uint8_t* m0, const uint8_t* m1,
                 const uint8_t* bits0, const uint8_t* bits1, int d0, int d1, float inv_keep,
                 const __nv_bfloat16* w0, const __nv_bfloat16* w1, const float* bias,
                 const uint4* wfrag, float* pre, float* h_out, void* res_out, int res_bf16,
                 float* c_out, int B, int T, int H, int hc, int rows, int k_res, int reverse,
                 cudaStream_t stream) {
  return static_cast<int>(eegflow::with_mask_source(m0, m1, bits0, bits1, [&](auto src) {
    auto run = [&](auto tag) {
      return static_cast<cudaError_t>(launch<kMode, typename decltype(tag)::type>(
          x0, x1, src, d0, d1, inv_keep, w0, w1, bias, wfrag, pre, h_out, res_out, c_out, B, T,
          H, hc, rows, k_res, reverse, stream));
    };
    return res_bf16 ? run(eegflow::Type<__nv_bfloat16>{}) : run(eegflow::Type<float>{});
  }));
}

template <int kMode, typename ResT>
cudaError_t plan_query(int H, int hc, int rows, int k_res, int* smem, int* clusters) {
  const ClusterGeom geo{H, hc, rows, k_res, 0};
  *smem = static_cast<int>(geo.smem_bytes());
  *clusters = 0;
  return eegflow::with_tile(geo, [&](auto mt, auto threads) {
    return eegflow::max_active_clusters(
        lstm_fwd_rec_kernel<kMode, ResT, decltype(mt)::value, decltype(threads)::value>, geo,
        smem, clusters);
  });
}

}  // namespace

// The recurrence's shared memory per CTA and the clusters the card holds at
// once for mode (0 eval, 1 planes, 2 raw gates, 3 bf16 planes, 4 bf16 raw
// gates) at this geometry.
extern "C" int eegflow_lstm_fwd_plan(int mode, int H, int hc, int rows, int k_res, int* smem,
                                     int* clusters) {
  using Bf = __nv_bfloat16;
  cudaError_t err;
  switch (mode) {
    case 0: err = plan_query<kEval, float>(H, hc, rows, k_res, smem, clusters); break;
    case 1: err = plan_query<kPlanes, float>(H, hc, rows, k_res, smem, clusters); break;
    case 2: err = plan_query<kGates, float>(H, hc, rows, k_res, smem, clusters); break;
    case 3: err = plan_query<kPlanes, Bf>(H, hc, rows, k_res, smem, clusters); break;
    case 4: err = plan_query<kGates, Bf>(H, hc, rows, k_res, smem, clusters); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Eval mode. h_out (B, T, H) float32; x_p (B, T, d_p) float32; w_p (d_p, 4H)
// bf16; bias (4H,) float32; wfrag W_hh (H, 4H) bf16 in the fragment order of
// nn/lstm_plan.py fwd_fragments; pre (B, T, 4H) float32 scratch; (hc, rows,
// k_res) the cluster plan. x1/w1 may be null when d1 == 0.
extern "C" int eegflow_lstm_fwd(const float* x0, const float* x1, int d0, int d1,
                                const __nv_bfloat16* w0, const __nv_bfloat16* w1,
                                const float* bias, const uint4* wfrag, float* pre, float* h_out,
                                int B, int T, int H, int hc, int rows, int k_res, int reverse,
                                cudaStream_t stream) {
  return launch<kEval, float>(x0, x1, eegflow::MaskNone{}, d0, d1, 1.f, w0, w1, bias, wfrag,
                              pre, h_out, nullptr, nullptr, B, T, H, hc, rows, k_res, reverse,
                              stream);
}

// Training mode: as eval mode, plus the input parts' dropout, kept values
// scaled by inv_keep, from one of three sources: the packed keep bits bits_p
// of part p (philox_bits.cu's planes; 1 = kept) where bits0 is not null;
// else uint8 keep-masks m_p (B, T, d_p) (null: no dropout on that part; 0 =
// dropped); else none. Writes the adjoint planes res_out (B, T, 6H),
// float32, or bf16 when res_bf16.
extern "C" int eegflow_lstm_fwd_train(const float* x0, const float* x1, const uint8_t* m0,
                                      const uint8_t* m1, const uint8_t* bits0,
                                      const uint8_t* bits1, int d0, int d1, float inv_keep,
                                      const __nv_bfloat16* w0, const __nv_bfloat16* w1,
                                      const float* bias,
                                      const uint4* wfrag, float* pre, float* h_out,
                                      void* res_out, int res_bf16, int B, int T, int H, int hc,
                                      int rows, int k_res, int reverse, cudaStream_t stream) {
  return launch_train<kPlanes>(x0, x1, m0, m1, bits0, bits1, d0, d1, inv_keep, w0, w1, bias,
                               wfrag, pre, h_out, res_out, res_bf16, nullptr, B, T, H, hc, rows,
                               k_res, reverse, stream);
}

// Raw-gate training mode: as training mode, but the residuals are the
// post-activation gates [i, f, g, o] gates_out (B, T, 4H) (float32, or bf16
// when res_bf16) and the cell state c_out (B, T, H) float32.
extern "C" int eegflow_lstm_fwd_train_gates(const float* x0, const float* x1,
                                            const uint8_t* m0, const uint8_t* m1,
                                            const uint8_t* bits0, const uint8_t* bits1, int d0,
                                            int d1, float inv_keep, const __nv_bfloat16* w0,
                                            const __nv_bfloat16* w1, const float* bias,
                                            const uint4* wfrag, float* pre, float* h_out,
                                            void* gates_out, int res_bf16, float* c_out, int B,
                                            int T, int H, int hc, int rows, int k_res,
                                            int reverse, cudaStream_t stream) {
  return launch_train<kGates>(x0, x1, m0, m1, bits0, bits1, d0, d1, inv_keep, w0, w1, bias,
                              wfrag, pre, h_out, gates_out, res_bf16, c_out, B, T, H, hc, rows,
                              k_res, reverse, stream);
}
