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
// writes h (B, T, H) and, in training mode (c_out given), c (B, T, H) and
// the pre-activations z over its gates input, in place: each thread reads
// gates[row, t, gate H + u] a step ahead and writes z to the same element.
//
// Backward, kernel 5 (eegflow_lstm_rec_bwd), from the z, c the training-mode
// forward left, the upstream gradient g of h and W_hh. With c_prev[t] the
// cell state before step t (t-1 forward, t+1 reverse, zero before the
// direction's first step), the adjoint walks against the direction of time:
//   dh = g[t] + dh_carry;  do = dh tanh(c);  dc = dh o (1 - tanh^2 c) + dc_carry
//   dz = [dc g i(1-i), dc c_prev f(1-f), dc i (1-g^2), do o(1-o)]
//   dc_carry = dc f;  dh_carry = dz . W_hh^T            (float32)
// and writes dgates = dz (B, T, 4H). It reads the forward's z, where the
// reference recomputes z from the gates, h and W_hh.
//
// What bounds them on the card: both recurrences are serial in t and need
// all of W_hh every step (1 MB float32 at H = 256, over the 227 KB a block
// may hold). Each one's products are 2 B T H 4H operations, 69 GFLOP at
// B = 512, T = 256, H = 256: 1.03 ms at the card's 67 TFLOP/s of float32
// outside the tensor cores (TF32 is off, so they cannot compute this
// function), above their HBM traffic (0.77 GB for kernel 1 in eval mode,
// 1.3 GB with c and z; 1.3 GB for kernel 5: 0.39 ms). Once the weights stay
// on chip the products bound them: the card holds 15 clusters of 8 such
// CTAs, so B = 512 runs 11 clusters of 48 rows on 88 SMs and a kernel 1 step
// costs ~15 us, ~9.6 of them the product, ~1.3 the exchange of h, the rest
// the cell update and the cluster barrier (H100 80GB HBM3 at 700 W, python
// -m eegflow_torch.kernels.ablate).
//
// Both run on thread-block clusters (lstm_cluster.cuh) of hc CTAs that own a
// tile of 16, 32 or 48 batch rows and one direction; each CTA owns U = H / hc
// units (8 CTAs of 32 at H = 256) and keeps its slice of W_hh, W_hh[:, the
// 4U gate columns of its units], in shared memory for the whole launch,
// float32 (128 KB at H = 256; at H = 512 its first k_res rows, the rest read
// from L2 each step). Thread (row group of kR = rows / 4 rows, unit uu) owns
// the cell of its unit for its rows, with the carries in registers. Products
// run on CUDA-core FMA, each output one fmaf chain from 0 over its k
// ascending. Rows past B are masked; the batch is not padded. No atomics: a
// launch repeats bitwise.
//
// Kernel 1: the slice in the layout (k, unit, gate) of nn/lstm_plan.py
// rec_slices; h_{t-1} of the tile double-buffered in float32, rows of H + 4.
// Per k a thread does one 16-byte load of its unit's four weights (the
// warp's 32 lanes read 32 consecutive units) and one 16-byte broadcast load
// of h per row and four k, 4 kR accumulators; the gate is added last. The
// new h of the CTA's units goes to every CTA of the cluster through
// distributed shared memory, as 16-byte stores after a 4 x 4 transpose
// across each quad (rows by units); then one cluster barrier a step, with
// the HBM stores of h, c and z and the next step's gate loads between its
// arrive and wait. Since kernel 5 reads the z kernel 1 writes, nothing ties
// kernel 1's summation order to another kernel's.
//
// Kernel 5: dh_carry = dz . W_hh^T by reduce-scatter. Each CTA multiplies
// its own dz (rows x 4U, staged in shared memory) by its own slice, laid out
// (unit, gate, k) with k contiguous (nn/lstm_plan.py rec_bwd_slices), into a
// partial dh for all H units: thread (row group, uu) owns the 4-unit quads
// uu and uu + U of its rows, so a warp's lanes read consecutive 16-byte
// words of the slice and the dz of a row is a broadcast. It sends each CTA r
// of the cluster the rows x U block of r's units through DSMEM (the volume
// of kernel 1's h exchange), and after the cluster barrier each thread adds
// the hc partials of its (row, unit) in rank order. The FMA count a step is
// kernel 1's. The partial inbox has one buffer (a second one would not fit
// beside the slice at 48 rows): a second barrier phase a step, arrived at
// once the inbox is read and waited for just before the next exchange,
// keeps a CTA from overwriting an inbox another still reads; the step's
// cell update and product hide its wait. dz goes to HBM, and the next step's
// z, c_prev and g are loaded, between the exchange's arrive and wait.

#include <stdint.h>

#include "common.cuh"
#include "lstm_cluster.cuh"
#include "mma_gemm.cuh"

namespace {

using eegflow::ClusterGeom;

// What a kernel 1 launch writes besides h: nothing (eval), or c and z over
// the gates (training).
enum RecMode { kRecEval = 0, kRecTrain = 1 };

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
lstm_rec_fwd_kernel(float* __restrict__ gates, const float4* __restrict__ wslice,
                    float* __restrict__ h_out, float* __restrict__ c_out, int B, int T, int H,
                    int k_res, int reverse) {
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

    // the cell update; pre becomes z
    float hv[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) pre[r][gate] += acc[r][gate];
      const float ig = eegflow::sigmoid_tanh(pre[r][0]);
      const float fg = eegflow::sigmoid_tanh(pre[r][1]);
      const float gg = tanhf(pre[r][2]);
      const float og = eegflow::sigmoid_tanh(pre[r][3]);
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
    if (kMode == kRecTrain) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (row0 + r >= B) continue;
        float* zp = gates + (static_cast<size_t>(row0 + r) * T + t) * G + u;
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) __stcs(zp + gate * H, pre[r][gate]);
      }
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
cudaError_t rec_fwd_launch(float* gates, const float4* wslice, float* h_out, float* c_out, int B,
                           int T, int H, int hc, int rows, int k_res, int reverse,
                           cudaStream_t stream) {
  const ClusterGeom geo{H, hc, rows, k_res, 2};
  if (!geo.valid() || B <= 0 || T <= 0 || (kMode == kRecTrain && c_out == nullptr))
    return cudaErrorInvalidValue;
  return eegflow::with_tile(geo, [&](auto mt, auto threads) {
    return eegflow::launch_cluster(
        lstm_rec_fwd_kernel<kMode, decltype(mt)::value, decltype(threads)::value>, geo,
        (B + rows - 1) / rows, 1, stream, gates, wslice, h_out, c_out, B, T, H, k_res, reverse);
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

// Four n of a thread's product: its kR rows' dz at n..n+3 (one float4
// broadcast each, ldz floats apart) times the slice's weights of its output
// quad at each n, added into acc with n ascending.
template <int kR>
__device__ __forceinline__ void rec_bwd_nquad(float (&acc)[kR][4], const float* dz, int ldz,
                                              const float4 (&w)[4]) {
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const float4 dv = *reinterpret_cast<const float4*>(dz + r * ldz);
    const float d[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
    for (int nn = 0; nn < 4; ++nn) {
      acc[r][0] = fmaf(d[nn], w[nn].x, acc[r][0]);
      acc[r][1] = fmaf(d[nn], w[nn].y, acc[r][1]);
      acc[r][2] = fmaf(d[nn], w[nn].z, acc[r][2]);
      acc[r][3] = fmaf(d[nn], w[nn].w, acc[r][3]);
    }
  }
}

// Kernel 5. Thread i of cluster CTA `rank` (blockDim 8U: two halves of 4U)
// is (half = i / 4U, row group grp, unit uu) with i % 4U = grp U + uu. For
// the cell's adjoint it owns unit u = rank U + uu and the kR / 2 rows
// kR grp + half kR / 2 .. of the tile. In the product it owns one output
// quad (4 units) of kR grp's rows: quad uu + U half of all kR rows when the
// H / 4 quads are more than U (kSplitQ, hc > 4), else quad uu of its cell
// rows. wslice: (hc, 4U, H) float32, [CTA][unit uu, gate][k]
// = W_hh[k, gate H + rank U + uu] (rec_bwd_slices).
template <int kMT, int kMaxThreads, bool kSplitQ>
__global__ void __launch_bounds__(kMaxThreads, 1)
lstm_rec_bwd_kernel(const float* __restrict__ z, const float* __restrict__ cst,
                    const float* __restrict__ gup, const float* __restrict__ wslice,
                    float* __restrict__ dgates, int B, int T, int H, int k_res, int reverse) {
  constexpr int kR = 4 * kMT;                 // rows of a row group
  constexpr int kER = kR / 2;                 // a thread's cell rows
  constexpr int kPR = kSplitQ ? kR : kER;     // a thread's product rows
  constexpr int kRows = 16 * kMT;
  extern __shared__ __align__(16) uint8_t smem[];
  const int U = blockDim.x / 8;
  const int hc = H / U;
  const int K = 4 * U;  // the CTA's gate columns, the product's depth
  const int quads = H / 4;
  const uint32_t rank = eegflow::cluster_rank();
  const int half = threadIdx.x / (4 * U);
  const int grp = (threadIdx.x - half * 4 * U) / U;
  const int uu = threadIdx.x - half * 4 * U - grp * U;
  const int u = rank * U + uu;
  const int er0 = grp * kR + half * kER;      // the first cell row in the tile
  const int pr0 = kSplitQ ? grp * kR : er0;   // the first product row
  const int quad = kSplitQ ? uu + U * half : uu;
  const int qcol = 4 * min(quad, quads - 1);  // the quad's first unit, clamped in range
  const int row0 = (blockIdx.x / hc) * kRows + er0;
  const int G = 4 * H;
  float* const wsm = reinterpret_cast<float*>(smem);      // [k_res][H]
  float* const dzs = wsm + static_cast<size_t>(k_res) * H;  // [rows][K]: (row, uu, gate)
  float* const inbox = dzs + kRows * K;                     // [hc][rows][U]
  const float* const wsl = wslice + static_cast<size_t>(rank) * K * H;

  for (int i = threadIdx.x; i < k_res * H / 4; i += blockDim.x)
    reinterpret_cast<float4*>(wsm)[i] = reinterpret_cast<const float4*>(wsl)[i];

  // what step t reads for this thread's (row, unit) pairs: z, c_prev, g
  float zr[kER][4], cp[kER], gr[kER];
  auto load_step = [&](int t) {
    const int tp = reverse ? t + 1 : t - 1;
    const bool has_prev = tp >= 0 && tp < T;
#pragma unroll
    for (int r = 0; r < kER; ++r) {
      const int row = row0 + r;
      const size_t bt = static_cast<size_t>(row) * T + t;
      if (row < B) {
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) zr[r][gate] = __ldcs(z + bt * G + gate * H + u);
        gr[r] = __ldcs(gup + bt * H + u);
        cp[r] = has_prev ? __ldcs(cst + (static_cast<size_t>(row) * T + tp) * H + u) : 0.f;
      } else {
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) zr[r][gate] = 0.f;
        gr[r] = cp[r] = 0.f;
      }
    }
  };
  // c at the first step of the walk, then each step's c_prev is the next one's c
  const int t_first = reverse ? 0 : T - 1;
  float c_cur[kER], dc_c[kER];
#pragma unroll
  for (int r = 0; r < kER; ++r) {
    const int row = row0 + r;
    c_cur[r] = row < B ? cst[(static_cast<size_t>(row) * T + t_first) * H + u] : 0.f;
    dc_c[r] = 0.f;
  }
  load_step(t_first);
  eegflow::cluster_arrive();
  eegflow::cluster_wait();

  const uint32_t box = eegflow::smem_addr(inbox);
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? s : T - 1 - s;
    // the cell's adjoint: dh = g + the hc partials of dh_carry in rank
    // order, dz into the CTA's dz tile as (row, uu, i f g o)
#pragma unroll
    for (int r = 0; r < kER; ++r) {
      float carry = 0.f;
      if (s > 0) {
#pragma unroll
        for (int src = 0; src < eegflow::kMaxCluster; ++src)
          if (src < hc) carry += inbox[(src * kRows + er0 + r) * U + uu];
      }
      const float dh = gr[r] + carry;
      const float ig = eegflow::sigmoid_tanh(zr[r][0]);
      const float fg = eegflow::sigmoid_tanh(zr[r][1]);
      const float gg = tanhf(zr[r][2]);
      const float og = eegflow::sigmoid_tanh(zr[r][3]);
      const float tc = tanhf(c_cur[r]);
      const float dout = dh * tc;
      const float dc = dh * og * (1.f - tc * tc) + dc_c[r];
      dc_c[r] = dc * fg;
      *reinterpret_cast<float4*>(dzs + (er0 + r) * K + 4 * uu) =
          make_float4(dc * gg * ig * (1.f - ig), dc * cp[r] * fg * (1.f - fg),
                      dc * ig * (1.f - gg * gg), dout * og * (1.f - og));
      c_cur[r] = cp[r];
    }
    if (s > 0) eegflow::cluster_arrive();  // this CTA's reads of the inbox are done
    __syncthreads();                        // the dz tile is whole

    // the partial dh_carry of every unit from this CTA's dz and slice: the
    // resident n-rows from shared memory, the rest from L2, n ascending
    float acc[kPR][4];
#pragma unroll
    for (int r = 0; r < kPR; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
    if (s + 1 < T) {
      const float* dzr = dzs + pr0 * K;
#pragma unroll 2
      for (int n = 0; n < k_res; n += 4) {
        const float4 w[4] = {*reinterpret_cast<const float4*>(wsm + n * H + qcol),
                             *reinterpret_cast<const float4*>(wsm + (n + 1) * H + qcol),
                             *reinterpret_cast<const float4*>(wsm + (n + 2) * H + qcol),
                             *reinterpret_cast<const float4*>(wsm + (n + 3) * H + qcol)};
        rec_bwd_nquad<kPR>(acc, dzr + n, K, w);
      }
      const float4* wg = reinterpret_cast<const float4*>(wsl + qcol);
#pragma unroll 2
      for (int n = k_res; n < K; n += 4) {
        const float4 w[4] = {__ldg(wg + n * H / 4), __ldg(wg + (n + 1) * H / 4),
                             __ldg(wg + (n + 2) * H / 4), __ldg(wg + (n + 3) * H / 4)};
        rec_bwd_nquad<kPR>(acc, dzr + n, K, w);
      }
    }
    if (s > 0) eegflow::cluster_wait();  // every CTA has read its inbox

    // the quad's rows to the CTA that owns its units
    if (s + 1 < T && quad < quads) {
      const int dst = qcol / U;
      const uint32_t base =
          eegflow::map_rank(box, dst) + ((rank * kRows + pr0) * U + qcol - dst * U) * 4;
#pragma unroll
      for (int r = 0; r < kPR; ++r)
        eegflow::st_cluster_v4(base + r * U * 4,
                               make_uint4(__float_as_uint(acc[r][0]), __float_as_uint(acc[r][1]),
                                          __float_as_uint(acc[r][2]),
                                          __float_as_uint(acc[r][3])));
    }
    eegflow::cluster_arrive();

    // dz of the thread's pairs to HBM, from the tile, and the next step's loads
#pragma unroll
    for (int r = 0; r < kER; ++r) {
      const int row = row0 + r;
      const float4 dv = *reinterpret_cast<const float4*>(dzs + (er0 + r) * K + 4 * uu);
      if (row >= B) continue;
      float* dp = dgates + (static_cast<size_t>(row) * T + t) * G + u;
      __stcs(dp, dv.x);
      __stcs(dp + H, dv.y);
      __stcs(dp + 2 * H, dv.z);
      __stcs(dp + 3 * H, dv.w);
    }
    if (s + 1 < T) load_step(reverse ? t + 1 : t - 1);
    eegflow::cluster_wait();
  }
}

using RecBwdKernel = void (*)(const float*, const float*, const float*, const float*, float*,
                              int, int, int, int, int);

// The instantiation of kernel 5 for a geometry's tile and cluster size.
template <int kMT, int kMaxThreads>
RecBwdKernel rec_bwd_kernel_for(int hc) {
  if (hc > 4) return lstm_rec_bwd_kernel<kMT, kMaxThreads, true>;
  return lstm_rec_bwd_kernel<kMT, kMaxThreads, false>;
}

}  // namespace

// Kernel 1's shared memory per CTA and the clusters the card holds at once
// for mode (0 eval, 1 training) at this geometry.
extern "C" int eegflow_lstm_rec_plan(int mode, int H, int hc, int rows, int k_res, int* smem,
                                     int* clusters) {
  const cudaError_t err = mode == kRecEval
                              ? rec_plan_query<kRecEval>(H, hc, rows, k_res, smem, clusters)
                              : rec_plan_query<kRecTrain>(H, hc, rows, k_res, smem, clusters);
  return static_cast<int>(err);
}

// Kernel 1. gates (B, T, 4H) float32, overwritten with z in training mode;
// wslice W_hh float32 in the layout of nn/lstm_plan.py rec_slices
// (hc, H, U, 4); h_out (B, T, H) float32; c_out (B, T, H) float32, or null
// in eval mode; (hc, rows, k_res) the cluster plan.
extern "C" int eegflow_lstm_rec_fwd(float* gates, const float4* wslice, float* h_out,
                                    float* c_out, int B, int T, int H, int hc, int rows,
                                    int k_res, int reverse, cudaStream_t stream) {
  const cudaError_t err =
      c_out == nullptr
          ? rec_fwd_launch<kRecEval>(gates, wslice, h_out, nullptr, B, T, H, hc, rows, k_res,
                                     reverse, stream)
          : rec_fwd_launch<kRecTrain>(gates, wslice, h_out, c_out, B, T, H, hc, rows, k_res,
                                      reverse, stream);
  return static_cast<int>(err);
}

// Kernel 5's shared memory per CTA and the clusters the card holds at once.
extern "C" int eegflow_lstm_rec_bwd_plan(int H, int hc, int rows, int k_res, int* smem,
                                         int* clusters) {
  const ClusterGeom geo{H, hc, rows, k_res, 3};
  *smem = static_cast<int>(geo.smem_bytes());
  *clusters = 0;
  return static_cast<int>(eegflow::with_tile<1024>(geo, [&](auto mt, auto threads) {
    return eegflow::max_active_clusters(
        rec_bwd_kernel_for<decltype(mt)::value, decltype(threads)::value>(hc), geo, smem,
        clusters);
  }));
}

// Kernel 5. z, dgates (B, T, 4H), c, g (B, T, H) float32; wslice W_hh
// float32 in the layout of nn/lstm_plan.py rec_bwd_slices (hc, U, 4, H);
// (hc, rows, k_res) the cluster plan. Output dgates.
extern "C" int eegflow_lstm_rec_bwd(const float* z, const float* c, const float* g,
                                    const float* wslice, float* dgates, int B, int T, int H,
                                    int hc, int rows, int k_res, int reverse,
                                    cudaStream_t stream) {
  const ClusterGeom geo{H, hc, rows, k_res, 3};
  if (!geo.valid() || B <= 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(eegflow::with_tile<1024>(geo, [&](auto mt, auto threads) {
    return eegflow::launch_cluster(
        rec_bwd_kernel_for<decltype(mt)::value, decltype(threads)::value>(hc), geo,
        (B + rows - 1) / rows, 1, stream, z, c, g, wslice, dgates, B, T, H, k_res, reverse);
  }));
}
