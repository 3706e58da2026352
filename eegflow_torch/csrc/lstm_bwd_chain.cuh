// The adjoint chain and the products shared by the bf16 backward kernels:
// kernel 3 (lstm_bwd.cu, one direction a launch) and kernel 4
// (lstm_bwd_dualdir.cu, both directions in one launch) from the six adjoint
// planes, kernel 3b (lstm_bwd_v2.cu) from the raw gates and c. With them it
// replaces the adjoint and the products of eegflow/nn/pallas_lstm.py
// _bwd_fused_kernel, _bwd_dualdir_kernel and _bwd_fused_kernel_v2.
//
// The chain walks against the direction of time (t = T-1..0 for the forward
// direction, 0..T-1 for the reverse one):
//   dh = g[t] + dh_carry;   dc = dh E + dc_carry;   dc_carry = dc F
//   dz = [dc A, dc B, dc C, dh G]                    (float32)
//   dh_carry = bf16(dz) . bf16(W_hh)^T
// from the planes, or from the raw gates [i, f, g, o], c and c_prev (c at the
// step before t in the forward's order, zero before the direction's first):
//   do = dh tanh(c);  dc = dh o (1 - tanh^2 c) + dc_carry;  dc_carry = dc f
//   dz = [dc g i(1-i), dc c_prev f(1-f), dc i (1-g^2), do o(1-o)]
// The planes, or the raw gates, arrive in float32 or in bf16 (the
// forward's res_bf16, EEGFLOW_RES_BF16=1), upcast on load; c and g are
// float32. Then the products, with h_prev[t] the state before step t and
// x_p masked as in the forward:
//   dx_p = bf16(dz) . bf16(W_ih_p)^T (masked, plus the sibling's dx)
//   dW_ih_p = bf16(x_p)^T . bf16(dz);  dW_hh = bf16(h_prev)^T . bf16(dz)
//   db = sum over (b, t) of the float32 dz
//
// What bounds it on the card: the chain is serial in t and each step needs
// all of W_hh^T (512 KB bf16 at H = 256, over the 227 KB a block may hold)
// against the dz of every unit; the products are 0.4 TFLOP a launch at
// B = 512, T = 256, H = 256 with two parts (0.4 ms on the tensor cores).
// The chain's time is the latency of its serial step. On an H100 80GB HBM3
// at 700 W the first design took ~9.7 us a step at 32 rows a cluster and
// ~19 us at 48 (three m-tiles, kernel 4's plan), where its 255 registers
// left the next step's plane loads exposed (6.9 us of the step) and each of
// a CTA's 8 warps read the whole dz tile for its product; this one ~8.6
// and ~11.3 (python -m eegflow_torch.kernels.ablate).
//
// Design. The chain runs on thread-block clusters (lstm_cluster.cuh): a cluster
// of H/64 CTAs owns 16, 32 or 48 batch rows and one direction; each CTA owns 64
// units and holds W_hh^T[:, its units] (4H x 64 bf16, 128 KB at H = 256) in
// shared memory for the whole launch. Per step a thread computes dz for all
// four gates of its (row, unit) pairs from the planes, in registers with the
// carries, m-tile by m-tile, and stores each m-tile's bf16 dz into every CTA of
// the cluster through distributed shared memory (its own CTA's by a local
// store) as soon as it is computed, so one m-tile's stores travel while the
// next computes; then a cluster barrier. Between the barrier's arrive and wait
// goes an L2 prefetch, by the TMA unit, of the planes two steps ahead. Once the
// tile has gathered, each CTA writes its share of the tile's rows to HBM by TMA
// bulk stores, and its warps run dh_carry for its units, bf16(dz) (rows x 4H) .
// W_hh^T-slice, on mma.sync. Each output sums four accumulator chains, chain c
// over the k-tiles kt = c mod 4 in order, as (chain 0 + chain 1) + (chain 2 +
// chain 3): a pair of warps shares two octets, each warp taking two of the
// chains of both, so each reads half the tile (and the W_hh^T fragments once a
// step); the chain-pair sums a warp holds for its partner's octet go across
// through shared memory, so the result lands on the threads that own those
// units. Then the next step's planes load, from L2, with the product's
// registers free (loaded during the product, they kept the three-m-tile step at
// 255 registers). The dz tile has one buffer (two would not fit beside the
// slice at 32 rows): a second barrier phase, arrived at after the product's and
// the bulk stores' reads and the partners' exchange and waited for before the
// next step's exchange, keeps a CTA from overwriting a buffer another CTA still
// reads. db is summed in registers over the steps, then over the 16 rows of
// each m-tile in a fixed order, into per-16-row partials that a second pass
// adds in order. The products then run on the tensor-core GEMM of mma_gemm.cuh
// from the bf16 dz: dx with its epilogue, dW_ih and dW_hh split over B T with
// fixed-order partial sums. No float atomics: a launch repeats bit for bit, and
// per row and per 16-row tile the result does not depend on the plan, so kernel
// 4 without dropout equals two kernel 3 launches bit for bit.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "lstm_cluster.cuh"
#include "mma_gemm.cuh"

namespace {

// Two adjacent residuals (float32, or bf16 widened exactly) by one streaming
// load.
__device__ __forceinline__ float2 ldcs_pair(const float* p) {
  return __ldcs(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ldcs_pair(const __nv_bfloat16* p) {
  const unsigned int u = __ldcs(reinterpret_cast<const unsigned int*>(p));
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// kM m-tiles of a warp's dh_carry product over one pair of its accumulator
// chains (chain c takes the k-tiles kt = c mod 4, in order): the pair
// index kk runs over h, h + 2, ... (k-tiles 2 kk and 2 kk + 1: chains 2 h
// and 2 h + 1) for kOct octets. A (bf16 dz, 16 rows an m-tile, ld_bytes
// apart) by ldmatrix from a_addr; B, the octets' 16-byte fragment pairs,
// from the resident slice at ws[o] for kk < KT2_res, else from global
// memory at wg[o] (both indexed kk * 32). acc[j][o][m] is chain 2 h + j of
// octet o in m-tile m.
template <int kOct, int kM>
__device__ __forceinline__ void chain_pair_mma(float (&acc)[2][kOct][kM][4], uint32_t a_addr,
                                               int ld_bytes, const uint4* const (&ws)[kOct],
                                               const uint4* const (&wg)[kOct], int h,
                                               int KT2_res, int KT2) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int o = 0; o < kOct; ++o)
#pragma unroll
      for (int m = 0; m < kM; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][o][m][e] = 0.f;
  auto kpair = [&](int kk, const uint4 (&b)[kOct]) {
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      uint32_t a0[4], a1[4];
      eegflow::ldmatrix_x4(a0, a_addr + m * 16 * ld_bytes + kk * 64);
      eegflow::ldmatrix_x4(a1, a_addr + m * 16 * ld_bytes + kk * 64 + 32);
#pragma unroll
      for (int o = 0; o < kOct; ++o) {
        eegflow::mma_bf16(acc[0][o][m], a0, b[o].x, b[o].y);
        eegflow::mma_bf16(acc[1][o][m], a1, b[o].z, b[o].w);
      }
    }
  };
#pragma unroll 2
  for (int kk = h; kk < KT2_res; kk += 2) {
    uint4 b[kOct];
#pragma unroll
    for (int o = 0; o < kOct; ++o) b[o] = ws[o][kk * 32];
    kpair(kk, b);
  }
#pragma unroll 2
  for (int kk = KT2_res + h; kk < KT2; kk += 2) {
    uint4 b[kOct];
#pragma unroll
    for (int o = 0; o < kOct; ++o) b[o] = __ldg(wg[o] + kk * 32);
    kpair(kk, b);
  }
}

// bytes global -> L2 by the TMA unit (no registers held), from p rounded
// down to 16 bytes
__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uintptr_t lo = a & ~uintptr_t{15};
  const uint32_t n = static_cast<uint32_t>((a + bytes + 15 - lo) & ~uintptr_t{15});
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(lo), "r"(n) : "memory");
}

// bytes shared -> global by the TMA unit, in the thread's bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until the thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// until the thread's bulk stores are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// shared-memory writes of the generic proxy (the cluster's DSMEM stores,
// acquired by a barrier) made visible to the thread's later bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One direction's chain over a cluster's row tile, inlined into the kernels'
// entry functions with __restrict__ pointers. Thread (warp w, lane = 4 g + q)
// of CTA `rank` owns units u0 = 8 (rank * warps + w) + 2 q, u0 + 1 and, in
// m-tile mt, rows 16 mt + g and 16 mt + g + 8 of the tile.
//   res (B, T, 6H) planes, or with kRaw the raw gates (B, T, 4H), of type
//   ResT (float or bf16), and with kRaw cst the cell state c (B, T, H)
//   float32; g (B, T, H) float32; wfrag W_hh^T in the fragment
//   order of nn/lstm_plan.py bwd_fragments; dz16 (B, T, 4H) bf16 out; db_part
//   (ceil(B / 16), 4H) float32 out.
template <int kMT, bool kRaw, typename ResT>
__device__ __forceinline__ void chain_direction(const ResT* __restrict__ res,
                                                const float* __restrict__ cst,
                                                const float* __restrict__ gup,
                                                const uint4* __restrict__ wfrag,
                                                __nv_bfloat16* __restrict__ dz16,
                                                float* __restrict__ db_part, int B, int T,
                                                int H, int k_res, int reverse) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, q = lane & 3;
  const int hc = H / (8 * warps);
  const uint32_t rank = eegflow::cluster_rank();
  const int tile = blockIdx.x / hc;
  const int row0 = tile * 16 * kMT;
  const int octet = rank * warps + warp;
  const int u0 = octet * 8 + 2 * q;
  const int G = 4 * H;
  const int KT2 = H / 8, KT2_res = k_res / 32;  // pairs of 16-row k-tiles of K = 4H
  const int ldz = G + 8;                        // bf16 elements per row of the dz buffer
  uint4* const wsm = reinterpret_cast<uint4*>(smem);
  __nv_bfloat16* const dzbuf =
      reinterpret_cast<__nv_bfloat16*>(smem + static_cast<size_t>(warps) * KT2_res * 512);

  for (int i = threadIdx.x; i < warps * KT2_res * 32; i += blockDim.x) {
    const int w = i / (KT2_res * 32);
    wsm[i] = wfrag[(static_cast<size_t>(rank) * warps + w) * KT2 * 32 + (i - w * KT2_res * 32)];
  }

  // what step t reads for this thread's pairs, [mt][k][2 rh + uu]: the planes
  // A..G and g, or (kRaw) i, f, g, o, c, c_prev and g. One loader serves both,
  // so the ablations of eegflow_torch.kernels.ablate patch both alike.
  float pl[kMT][7][4];
  auto load_planes = [&](int t) {
    const int tp = reverse ? t + 1 : t - 1;
    const bool has_prev = tp >= 0 && tp < T;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int row = row0 + 16 * mt + 8 * rh + g;
        const size_t bt = static_cast<size_t>(row) * T + t;
        const size_t btp = has_prev ? static_cast<size_t>(row) * T + tp : bt;
#pragma unroll
        for (int k = 0; k < 7; ++k) {
          // a plane or raw gate of res, else c, c_prev or g
          const bool planar = kRaw ? k < 4 : k < 6;
          const float* src = kRaw && k == 4 ? cst + bt * H
                             : kRaw && k == 5 ? cst + btp * H : gup + bt * H;
          float2 v = make_float2(0.f, 0.f);
          if (row < B)
            v = planar ? ldcs_pair(res + bt * (kRaw ? 4 : 6) * H + k * H + u0)
                       : ldcs_pair(src + u0);
          if (kRaw && k == 5 && !has_prev) v = make_float2(0.f, 0.f);
          pl[mt][k][2 * rh] = v.x;
          pl[mt][k][2 * rh + 1] = v.y;
        }
      }
  };
  // what step t reads for the whole tile into L2, each CTA its 1/hc of each
  // row's span of res (and of c), and its units of g
  const int P = kRaw ? 4 : 6;
  auto prefetch_step = [&](int t) {
    const int rows = 16 * kMT, streams = kRaw ? 3 : 2;
    for (int i = threadIdx.x; i < streams * rows; i += blockDim.x) {
      const int row = row0 + i % rows;
      if (row >= B) continue;
      const size_t bt = static_cast<size_t>(row) * T + t;
      const int stream = i / rows;
      if (stream == 0)
        prefetch_l2(res + bt * P * H + rank * (P * H / hc), P * H / hc * sizeof(ResT));
      else if (stream == 1)
        prefetch_l2(gup + bt * H + rank * (H / hc), H / hc * 4);
      else
        prefetch_l2(cst + bt * H + rank * (H / hc), H / hc * 4);
    }
  };
  load_planes(reverse ? 0 : T - 1);
  if (T > 1) prefetch_step(reverse ? 1 : T - 2);
  eegflow::cluster_arrive();
  eegflow::cluster_wait();

  float dh_c[kMT][4], dc_c[kMT][4], dbacc[kMT][4][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dh_c[mt][e] = dc_c[mt][e] = 0.f;
#pragma unroll
    for (int gate = 0; gate < 4; ++gate) dbacc[mt][gate][0] = dbacc[mt][gate][1] = 0.f;
  }
  const uint32_t cur = eegflow::smem_addr(dzbuf);
  const uint32_t a_base = cur + ((lane & 15) * ldz + (lane >> 4) * 8) * 2;
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? s : T - 1 - s;
    // m-tile by m-tile: this thread's dz, then its bf16 dz to every CTA of
    // the cluster (the first m-tile's once every CTA has read the buffer's
    // previous step, the second phase of that step), so one m-tile's
    // distributed stores are in flight while the next one computes. A
    // transpose across each quad gives lane q gate q's 16 bytes of the octet
    // per row.
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      float z[4][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dh = pl[mt][6][e] + dh_c[mt][e];
        if (kRaw) {
          const float gi = pl[mt][0][e], gf = pl[mt][1][e], gg = pl[mt][2][e];
          const float go = pl[mt][3][e], tc = tanhf(pl[mt][4][e]);
          const float d_o = dh * tc;
          const float dc = dh * go * (1.f - tc * tc) + dc_c[mt][e];
          dc_c[mt][e] = dc * gf;
          z[0][e] = dc * gg * gi * (1.f - gi);
          z[1][e] = dc * pl[mt][5][e] * gf * (1.f - gf);
          z[2][e] = dc * gi * (1.f - gg * gg);
          z[3][e] = d_o * go * (1.f - go);
        } else {
          const float dc = dh * pl[mt][3][e] + dc_c[mt][e];
          dc_c[mt][e] = dc * pl[mt][4][e];
          z[0][e] = dc * pl[mt][0][e];
          z[1][e] = dc * pl[mt][1][e];
          z[2][e] = dc * pl[mt][2][e];
          z[3][e] = dh * pl[mt][5][e];
        }
      }
      uint32_t zp[4][2];  // bf16 dz pairs: [gate][rh]
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        dbacc[mt][gate][0] += z[gate][0];
        dbacc[mt][gate][1] += z[gate][1];
        dbacc[mt][gate][0] += z[gate][2];
        dbacc[mt][gate][1] += z[gate][3];
        zp[gate][0] = eegflow::pack_bf16(z[gate][0], z[gate][1]);
        zp[gate][1] = eegflow::pack_bf16(z[gate][2], z[gate][3]);
      }
      uint4 chunk[2];
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const uint32_t v[4] = {zp[0][rh], zp[1][rh], zp[2][rh], zp[3][rh]};
        chunk[rh] = eegflow::quad_transpose(v, lane);
      }
      if (mt == 0 && s > 0) eegflow::cluster_wait();
      for (int r = 0; r < hc; ++r) {
        const uint32_t off = ((16 * mt + g) * ldz + q * H + octet * 8) * 2;
        if (r == static_cast<int>(rank)) {
          eegflow::st_shared_v4(cur + off, chunk[0]);
          eegflow::st_shared_v4(cur + off + 8 * ldz * 2, chunk[1]);
        } else {
          const uint32_t base = eegflow::map_rank(cur, r);
          eegflow::st_cluster_v4(base + off, chunk[0]);
          eegflow::st_cluster_v4(base + off + 8 * ldz * 2, chunk[1]);
        }
      }
    }
    eegflow::cluster_arrive();
    if (s + 2 < T) prefetch_step(reverse ? t + 2 : t - 2);
    eegflow::cluster_wait();

    // the step's dz rows to HBM from the gathered tile, each CTA its rows
    // r = rank mod hc, by the TMA unit
    const int store_row = threadIdx.x * hc + static_cast<int>(rank);
    const bool storer = store_row < 16 * kMT && row0 + store_row < B;
    if (storer) {
      fence_proxy_async();
      bulk_store(dz16 + (static_cast<size_t>(row0 + store_row) * T + t) * G,
                 cur + store_row * ldz * 2, G * 2);
    }

    // dh_carry: dz (rows x 4H) . W_hh^T[:, octet]. A pair
    // of warps (2p, 2p + 1) shares octets 2p and 2p + 1, warp 2p + h taking
    // chains 2h and 2h + 1 of both, so each reads half of the dz tile; a
    // warp without a partner (odd count) takes all four chains of its own.
    // Each warp keeps its own octet's chain-pair sum and passes the other
    // to its partner through shared memory, and each output is added as
    // (chain 0 + chain 1) + (chain 2 + chain 3).
    const int h = warp & 1;
    const bool paired = (warp | 1) < warps;
    float other[kMT][4];
    if (paired) {
      const int o0 = warp & ~1;
      const uint4* const ws[2] = {wsm + o0 * KT2_res * 32 + lane,
                                  wsm + (o0 + 1) * KT2_res * 32 + lane};
      const uint4* const wg[2] = {wfrag + static_cast<size_t>(octet - h) * KT2 * 32 + lane,
                                  wfrag + static_cast<size_t>(octet - h + 1) * KT2 * 32 + lane};
      float acc[2][2][kMT][4];
      chain_pair_mma<2, kMT>(acc, a_base, ldz * 2, ws, wg, h, KT2_res, KT2);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float s0 = acc[0][0][mt][e] + acc[1][0][mt][e];
          const float s1 = acc[0][1][mt][e] + acc[1][1][mt][e];
          dh_c[mt][e] = h ? s1 : s0;
          other[mt][e] = h ? s0 : s1;
        }
    } else {
      const uint4* const ws[1] = {wsm + warp * KT2_res * 32 + lane};
      const uint4* const wg[1] = {wfrag + static_cast<size_t>(octet) * KT2 * 32 + lane};
      float acc[2][1][kMT][4], s01[kMT][4];
      chain_pair_mma<1, kMT>(acc, a_base, ldz * 2, ws, wg, 0, KT2_res, KT2);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s01[mt][e] = acc[0][0][mt][e] + acc[1][0][mt][e];
      chain_pair_mma<1, kMT>(acc, a_base, ldz * 2, ws, wg, 1, KT2_res, KT2);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dh_c[mt][e] = s01[mt][e] + (acc[0][0][mt][e] + acc[1][0][mt][e]);
    }
    // the partners' sums through the dz tile, once no warp and no bulk
    // store reads it any more
    if (storer) bulk_wait_read();
    __syncthreads();
    float* const sums = reinterpret_cast<float*>(dzbuf);
    if (paired) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sums[(warp * kMT + mt) * 128 + e * 32 + lane] = other[mt][e];
    }
    __syncthreads();
    if (paired) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dh_c[mt][e] += sums[((warp ^ 1) * kMT + mt) * 128 + e * 32 + lane];
    }
    // the next step's planes, from L2 (prefetched a step ago), once the
    // product no longer holds its registers
    if (s + 1 < T) load_planes(reverse ? t + 1 : t - 1);
    eegflow::cluster_arrive();  // this CTA's reads of the buffer are done
  }
  eegflow::cluster_wait();
  bulk_wait();

  // db: each m-tile's sums over its 16 rows (the 8 lanes of one q, in a
  // fixed order), one partial row per 16-row tile of the batch
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const int btile = tile * kMT + mt;
#pragma unroll
    for (int gate = 0; gate < 4; ++gate)
#pragma unroll
      for (int uu = 0; uu < 2; ++uu) {
        float v = dbacc[mt][gate][uu];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0 && btile * 16 < B)
          db_part[static_cast<size_t>(btile) * G + gate * H + u0 + uu] = v;
      }
  }
}

}  // namespace

// Operands and epilogues of the products (mma_gemm.cuh), in a named namespace
// so the GEMM template is instantiated on types with linkage.
namespace lstm_bwd_ops {

// dx epilogue: the part's dropout mask from the mask source (mma_gemm.cuh:
// none, uint8 or the keep-bit plane), then the sibling direction's dx
template <class Src>
struct DxStore {
  float* dx;
  Src src;
  int part;
  const float* add;
  int M, D;
  float inv_keep;
  __device__ void one(size_t i, float v, bool kept) const {
    if (src.on(part)) v = kept ? v * inv_keep : 0.f;
    if (add != nullptr) v += add[i];
    dx[i] = v;
  }
  __device__ void operator()(int, int bt, int d, float v0, float v1) const {
    if (bt >= M || d >= D) return;
    const size_t i = static_cast<size_t>(bt) * D + d;
    if (d + 1 < D) {
      const uint32_t kept = src.keep2(part, i);
      one(i, v0, kept & 1u);
      one(i + 1, v1, kept & 2u);
    } else {
      one(i, v0, src.keep1(part, i));
    }
  }
};

// The products of one direction from its bf16 dz (B T, 4H), and db from the
// chain's per-16-row partials: dx_p with the epilogue `dx_store(q)`, dW_ih
// (the parts' rows stacked) from the parts masked by `src` (a mask source of
// mma_gemm.cuh), dW_hh; `part` holds splits * max(d0, d1, H) * 4H floats.
template <class DxStoreFor, class Src>
cudaError_t bwd_products(DxStoreFor dx_store, const float* h, const float* const* xs,
                         const Src& src, const int* ds, int n_parts, float inv_keep,
                         const __nv_bfloat16* const* ws, const __nv_bfloat16* dz16,
                         const float* db_part, float* dw_ih, float* dw_hh, float* db,
                         float* part, int splits, int B, int T, int H, int reverse,
                         cudaStream_t stream) {
  const int G = 4 * H;
  const int BT = B * T;
  const eegflow::Bf16Cols dz_cols{{dz16, nullptr}, {BT, 0}, G, G};
  size_t row_off = 0;
  cudaError_t err;
  for (int qp = 0; qp < n_parts; ++qp) {
    err = eegflow::mma_gemm(eegflow::Bf16Rows{dz16, BT, G, G},
                            eegflow::Bf16Rows{ws[qp], ds[qp], G, G}, dx_store(qp), BT, ds[qp], G,
                            0, stream);
    if (err != cudaSuccess) return err;
    err = eegflow::mma_gemm_split_k(
        eegflow::MaskedXCols<Src>{xs[qp], src, qp, ds[qp], BT, inv_keep}, dz_cols,
        dw_ih + row_off * G, part, ds[qp], G, BT, splits, stream);
    if (err != cudaSuccess) return err;
    row_off += ds[qp];
  }
  err = eegflow::mma_gemm_split_k(eegflow::HPrevCols{h, T, H, BT, reverse}, dz_cols, dw_hh, part,
                                  H, G, BT, splits, stream);
  if (err != cudaSuccess) return err;
  const int tiles = (B + 15) / 16;
  eegflow::reduce_splits_kernel<<<(G + 255) / 256, 256, 0, stream>>>(db_part, db, tiles,
                                                                      static_cast<size_t>(G));
  return cudaGetLastError();
}

// The products of kernel 3 or 3b (one direction, the sibling's dx added) on
// the mask source of the launch's arguments (with_mask_source).
inline cudaError_t bwd_products_masked(const float* h, const float* const* xs,
                                       const uint8_t* m0, const uint8_t* m1,
                                       const uint8_t* bits0, const uint8_t* bits1,
                                       const int* ds, float inv_keep,
                                       const __nv_bfloat16* const* ws,
                                       const float* const* adds, float* const* dxs,
                                       const __nv_bfloat16* dz16, const float* db_part,
                                       float* dw_ih, float* dw_hh, float* db, float* part,
                                       int splits, int B, int T, int H, int reverse,
                                       cudaStream_t stream) {
  const int BT = B * T;
  return eegflow::with_mask_source(m0, m1, bits0, bits1, [&](auto src) {
    auto dx_store = [&](int qp) {
      return DxStore<decltype(src)>{dxs[qp], src, qp, adds[qp], BT, ds[qp], inv_keep};
    };
    return bwd_products(dx_store, h, xs, src, ds, ds[1] > 0 ? 2 : 1, inv_keep, ws, dz16,
                        db_part, dw_ih, dw_hh, db, part, splits, B, T, H, reverse, stream);
  });
}

}  // namespace lstm_bwd_ops
