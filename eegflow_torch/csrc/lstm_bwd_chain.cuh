// The adjoint chain and the product operands shared by the backward kernels
// that read the six adjoint planes: kernel 3 (lstm_bwd.cu, one direction a
// launch) and kernel 4 (lstm_bwd_dualdir.cu, both directions in one launch).
//
// The chain walks against the direction of time (t = T-1..0 for the forward
// direction, 0..T-1 for the reverse one):
//   dh = g[t] + dh_carry;   dc = dh E + dc_carry;   dc_carry = dc F
//   dz = [dc A, dc B, dc C, dh G]                    (float32)
//   dh_carry = bf16(dz) . bf16(W_hh)^T
// One CTA per 8 batch rows and direction, one thread per hidden unit, the
// carries in registers; dz of a step is written to a float32 scratch
// (B, T, 4H) and, bf16-rounded, to a double-buffered shared tile that feeds
// the dh_carry product, whose W_hh^T reads are coalesced across the warp.
// Each kernel's entry function calls chain_direction once per direction.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kChainRows = 8;          // batch rows per CTA of the chain
constexpr int kChainMaxThreads = 512;  // H <= 512 (one thread per hidden unit)

// One direction's chain over a CTA's 8 rows, inlined into the kernels'
// entry functions. The chain is bound by the latency of its W_hh^T loads,
// and the pointers are __restrict__ so the compiler keeps enough of them in
// flight: one direction takes 17.2 ms at B=512, T=256, H=256 (H100 80GB
// HBM3, 700 W, train/profile.py); the same body reading pointers picked
// from a struct by blockIdx.y took 23.6 ms.
__device__ __forceinline__ void chain_direction(const float* __restrict__ res,
                                                const float* __restrict__ g,
                                                const __nv_bfloat16* __restrict__ whh_t,
                                                float* __restrict__ dz, int B, int T, int H,
                                                int reverse) {
  extern __shared__ float4 smem4[];
  float* const dzs = reinterpret_cast<float*>(smem4);  // [2][4H][kChainRows]
  const int G = 4 * H;
  const int u = threadIdx.x;  // blockDim.x == H
  const int row0 = blockIdx.x * kChainRows;

  float dh_carry[kChainRows], dc_carry[kChainRows];
#pragma unroll
  for (int r = 0; r < kChainRows; ++r) dh_carry[r] = dc_carry[r] = 0.f;

  int p = 0;
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? s : T - 1 - s;
    float* buf = dzs + p * G * kChainRows;
#pragma unroll
    for (int r = 0; r < kChainRows; ++r) {
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
      buf[u * kChainRows + r] = eegflow::bf16_round(zi);
      buf[(H + u) * kChainRows + r] = eegflow::bf16_round(zf);
      buf[(2 * H + u) * kChainRows + r] = eegflow::bf16_round(zg);
      buf[(3 * H + u) * kChainRows + r] = eegflow::bf16_round(zo);
    }
    __syncthreads();

    float acc[kChainRows];
#pragma unroll
    for (int r = 0; r < kChainRows; ++r) acc[r] = 0.f;
    const __nv_bfloat16* wj = whh_t + u;
#pragma unroll 4
    for (int j = 0; j < G; ++j, wj += H) {
      const float w = __bfloat162float(*wj);
      const float4 za = *reinterpret_cast<const float4*>(buf + j * kChainRows);
      const float4 zb = *reinterpret_cast<const float4*>(buf + j * kChainRows + 4);
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
    for (int r = 0; r < kChainRows; ++r) dh_carry[r] = acc[r];
    p ^= 1;
  }
}

// Dynamic shared memory of a chain CTA: the double-buffered bf16(dz) tile.
inline size_t chain_smem_bytes(int H) {
  return 2 * static_cast<size_t>(4 * H) * kChainRows * sizeof(float);
}

}  // namespace

// Operand loaders of the products (gemm.cuh), in a named namespace so the
// GEMM template is instantiated on types with linkage.
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

// bf16(masked x_p) as the A operand of dW_ih_p = x_p^T . dz: A(m = feature,
// k = b*T + t); m null takes x_p as it is
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
