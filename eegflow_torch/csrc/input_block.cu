// Fused input block y = gelu(LayerNorm(x . W + b)), forward and recomputing
// backward, for Hopper (sm_90a).
//
// Replaces: eegflow/nn/pallas_input.py _input_block_fwd_kernel (entry
// _fwd_call) and _input_block_bwd_kernel (entry _bwd_call), reached through
// input_block_fused: the classifier's first block, once per eval batch and,
// with its backward, once per training micro-step, under either precision
// policy.
//
// Per row (b, t) of the (B*T, C) input, C = 61 channels to H = 256 units:
//   z = x . W + b      x and W rounded to bf16 under `bf16`; float32 sums
//   mu = mean(z), var = mean(z^2) - mu^2, rsig = rsqrt(var + eps), eps 1e-5
//   xhat = (z - mu) rsig;  zl = xhat gamma + beta;  y = gelu(zl)
// with GELU's erf from Abramowitz & Stegun 7.1.26 (|err| <= 1.5e-7), as the
// reference's kernel evaluates it. The backward recomputes z from x with the
// same products in the same order and the same statistics code as the
// forward, and from the upstream gradient dy produces
//   dln = dy gelu'(zl);  dgamma += dln xhat;  dbeta += dln
//   dxhat = dln gamma;  dz = rsig (dxhat - mean(dxhat) - xhat mean(dxhat xhat))
//   db += dz;  dx = bf16?(dz) . bf16?(W)^T;  dW += bf16?(x)^T . bf16?(dz)
// (the sums over all B*T rows).
//
// What bounds it on the card: a row reads 61 floats and writes 256 (the
// backward reads 256 + 61 and writes 61 + 256 of scratch); the products are
// 2 x 61 x 256 multiply-adds a row each way, so at B=512, T=256 a launch
// moves ~0.2 GB and does ~4 GFLOP: memory-bound. The LayerNorm needs a
// reduction across the 256 units of a row.
//
// Design: a CTA of H threads owns kR rows at a time, thread u owns unit u
// (column u of W), so x . W, the LayerNorm and GELU are per-thread loops
// over the kR rows with the row staged in shared memory; the row sums (the
// statistics, mean(dxhat), mean(dxhat xhat)) reduce by warp shuffles and
// then over the warps in a fixed order. The backward stages W (bf16-rounded
// under bf16) in shared memory, padded so dx = dz . W^T reads it without
// bank conflicts, and forms dx in the kernel. It walks the rows in a grid of
// at most kMaxCtas CTAs, each owning its partial db, dgamma, dbeta; those
// partial rows, and the split-K partials of dW (from bf16?(dz) written to a
// float32 scratch, on gemm.cuh's tiled GEMM), are summed in a fixed order.
// No atomics: a launch repeats bitwise.

#include <math.h>

#include <algorithm>

#include "common.cuh"
#include "gemm.cuh"

namespace {

constexpr int kR = 16;          // rows per CTA pass
constexpr int kMaxH = 512;      // H <= 512 (one thread per unit)
constexpr int kMaxCtas = 256;   // CTAs of the backward (rows are walked)

__device__ __forceinline__ float maybe_bf16(float v, int bf16) {
  return bf16 ? eegflow::bf16_round(v) : v;
}

// erf by Abramowitz & Stegun 7.1.26, as eegflow/nn/pallas_input.py _erf
__device__ __forceinline__ float erf_as(float x) {
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * ax);
  const float poly =
      ((((1.061405429f * t - 1.453152027f) * t + 1.421413741f) * t - 0.284496736f) * t +
       0.254829592f) *
      t;
  const float r = 1.0f - poly * expf(-ax * ax);
  return x < 0.f ? -r : r;
}

__device__ __forceinline__ float gelu(float z) {
  return 0.5f * z * (1.0f + erf_as(z * 0.7071067811865476f));
}

__device__ __forceinline__ float gelu_grad(float z) {
  const float phi = expf(-0.5f * z * z) * 0.3989422804014327f;
  const float cdf = 0.5f * (1.0f + erf_as(z * 0.7071067811865476f));
  return cdf + z * phi;
}

// Stage kR rows of x (row-major, C floats each) into xs, bf16-rounded under
// bf16; rows past `rows` read as 0.
__device__ __forceinline__ void stage_rows(const float* __restrict__ x, float* xs, int row0,
                                           int rows, int C, int bf16) {
  const int avail = min(kR, rows - row0) * C;
  for (int i = threadIdx.x; i < kR * C; i += blockDim.x)
    xs[i] = i < avail ? maybe_bf16(x[static_cast<size_t>(row0) * C + i], bf16) : 0.f;
}

// z[r] = sum_c xs[r][c] w[c][u] + b_u over c ascending; w has leading
// dimension ldw. The forward and the backward both call this, with the same
// values of w, so they compute the same z bit for bit.
__device__ __forceinline__ void project(const float* xs, const float* w, int ldw, int C,
                                        int u, float bias, int bf16, float (&z)[kR]) {
#pragma unroll
  for (int r = 0; r < kR; ++r) z[r] = 0.f;
  for (int c = 0; c < C; ++c) {
    const float wc = maybe_bf16(w[static_cast<size_t>(c) * ldw + u], bf16);
#pragma unroll
    for (int r = 0; r < kR; ++r) z[r] = fmaf(xs[r * C + c], wc, z[r]);
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) z[r] = z[r] + bias;
}

// a[r] and b[r] summed over the CTA's threads, for each of the kR rows: by
// shuffles within a warp, then over the warps in order. Every thread gets
// the same sums. red holds kMaxH / 32 * kR * 2 floats.
__device__ __forceinline__ void row_sums(float (&a)[kR], float (&b)[kR], float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const float sa = eegflow::warp_sum(a[r]);
    const float sb = eegflow::warp_sum(b[r]);
    if (lane == 0) {
      red[(warp * kR + r) * 2] = sa;
      red[(warp * kR + r) * 2 + 1] = sb;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    float sa = 0.f, sb = 0.f;
    for (int w = 0; w < nwarps; ++w) {
      sa += red[(w * kR + r) * 2];
      sb += red[(w * kR + r) * 2 + 1];
    }
    a[r] = sa;
    b[r] = sb;
  }
  __syncthreads();  // red is reused by the next call
}

// mean and 1/sqrt(var + eps) of a row from its sums of z and z^2
__device__ __forceinline__ void ln_stats(float s1, float s2, float inv_h, float eps, float& mu,
                                         float& rsig) {
  mu = s1 * inv_h;
  rsig = rsqrtf(s2 * inv_h - mu * mu + eps);
}

__global__ void __launch_bounds__(kMaxH)
input_block_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ bias, const float* __restrict__ gamma,
                       const float* __restrict__ beta, float* __restrict__ y, int rows, int C,
                       int bf16, float eps) {
  extern __shared__ float4 smem4[];
  float* const xs = reinterpret_cast<float*>(smem4);  // [kR][C]
  float* const red = xs + kR * C;                     // [warps][kR][2]
  const int u = threadIdx.x;  // blockDim.x == H
  const int H = blockDim.x;
  const int row0 = blockIdx.x * kR;
  const float inv_h = 1.0f / static_cast<float>(H);

  stage_rows(x, xs, row0, rows, C, bf16);
  __syncthreads();
  float z[kR], s1[kR], s2[kR];
  project(xs, w, H, C, u, bias[u], bf16, z);
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    s1[r] = z[r];
    s2[r] = z[r] * z[r];
  }
  row_sums(s1, s2, red);
  const float gu = gamma[u], bu = beta[u];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    float mu, rsig;
    ln_stats(s1[r], s2[r], inv_h, eps, mu, rsig);
    const float zl = (z[r] - mu) * rsig * gu + bu;
    if (row0 + r < rows) y[static_cast<size_t>(row0 + r) * H + u] = gelu(zl);
  }
}

__global__ void __launch_bounds__(kMaxH)
input_block_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                       const float* __restrict__ w, const float* __restrict__ bias,
                       const float* __restrict__ gamma, const float* __restrict__ beta,
                       float* __restrict__ dx, float* __restrict__ dz_scr,
                       float* __restrict__ vec_part, int rows, int C, int bf16, float eps) {
  extern __shared__ float4 smem4[];
  const int u = threadIdx.x;  // blockDim.x == H
  const int H = blockDim.x;
  const int ldw = H + 1;                               // padded: dx reads w[c][k] across c
  float* const ws = reinterpret_cast<float*>(smem4);   // [C][H + 1]  bf16?(W)
  float* const dzs = ws + C * ldw;                     // [kR][H]     bf16?(dz)
  float* const xs = dzs + kR * H;                      // [kR][C]     bf16?(x)
  float* const red = xs + kR * C;                      // [warps][kR][2]
  const float inv_h = 1.0f / static_cast<float>(H);

  for (int c = 0; c < C; ++c)
    ws[c * ldw + u] = maybe_bf16(w[static_cast<size_t>(c) * H + u], bf16);
  const float bu = bias[u], gu = gamma[u], btu = beta[u];
  float db = 0.f, dgam = 0.f, dbet = 0.f;

  for (int row0 = blockIdx.x * kR; row0 < rows; row0 += gridDim.x * kR) {
    stage_rows(x, xs, row0, rows, C, bf16);
    __syncthreads();
    float z[kR], s1[kR], s2[kR];
    project(xs, ws, ldw, C, u, bu, bf16, z);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      s1[r] = z[r];
      s2[r] = z[r] * z[r];
    }
    row_sums(s1, s2, red);

    float rsig[kR], dxh[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      float mu;
      ln_stats(s1[r], s2[r], inv_h, eps, mu, rsig[r]);
      z[r] = (z[r] - mu) * rsig[r];  // xhat from here on
      const float g =
          row0 + r < rows ? dy[static_cast<size_t>(row0 + r) * H + u] : 0.f;
      const float dln = g * gelu_grad(z[r] * gu + btu);
      dgam += dln * z[r];
      dbet += dln;
      dxh[r] = dln * gu;
      s1[r] = dxh[r];
      s2[r] = dxh[r] * z[r];
    }
    row_sums(s1, s2, red);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float dz = rsig[r] * (dxh[r] - s1[r] * inv_h - z[r] * (s2[r] * inv_h));
      db += dz;
      const float dzb = maybe_bf16(dz, bf16);
      dzs[r * H + u] = dzb;
      if (row0 + r < rows) dz_scr[static_cast<size_t>(row0 + r) * H + u] = dzb;
    }
    __syncthreads();

    const int avail = min(kR, rows - row0) * C;
    for (int i = u; i < avail; i += H) {
      const int r = i / C;
      const int c = i - r * C;
      const float* dzr = dzs + r * H;
      const float* wc = ws + c * ldw;
      float acc = 0.f;
      for (int k = 0; k < H; ++k) acc = fmaf(dzr[k], wc[k], acc);
      dx[static_cast<size_t>(row0) * C + i] = acc;
    }
    __syncthreads();  // the next pass overwrites xs and dzs
  }

  float* out = vec_part + static_cast<size_t>(blockIdx.x) * 3 * H;
  out[u] = db;
  out[H + u] = dgam;
  out[2 * H + u] = dbet;
}

bool bad_shape(int rows, int C, int H) {
  return rows <= 0 || C <= 0 || H <= 0 || H > kMaxH || H % 32 != 0;
}

}  // namespace

// Operands of dW = bf16?(x)^T . bf16?(dz) over the rows (gemm.cuh).
namespace input_block_ops {

struct XRowsA {  // A(m = channel, k = row) = bf16?(x[k][m])
  static constexpr bool kMContiguous = true;
  const float* x;
  int C, bf16;
  __device__ float operator()(int c, int row) const {
    return maybe_bf16(x[static_cast<size_t>(row) * C + c], bf16);
  }
};

struct DzRowsB {  // B(k = row, n = unit) = dz_scr[k][n]
  static constexpr bool kNContiguous = true;
  const float* dz;
  int H;
  __device__ float operator()(int row, int n) const {
    return dz[static_cast<size_t>(row) * H + n];
  }
};

}  // namespace input_block_ops

// Forward. x (rows, C), w (C, H), bias, gamma, beta (H,) float32 -> y (rows,
// H) float32.
extern "C" int eegflow_input_block_fwd(const float* x, const float* w, const float* bias,
                                       const float* gamma, const float* beta, float* y,
                                       int rows, int C, int H, int bf16,
                                       cudaStream_t stream) {
  if (bad_shape(rows, C, H)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(kR) * C + kMaxH / 32 * kR * 2) * sizeof(float);
  cudaError_t err = eegflow::allow_dynamic_smem(input_block_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  input_block_fwd_kernel<<<(rows + kR - 1) / kR, H, smem, stream>>>(x, w, bias, gamma, beta, y,
                                                                    rows, C, bf16, 1e-5f);
  return static_cast<int>(cudaGetLastError());
}

// Backward. x (rows, C), dy (rows, H), w (C, H), bias, gamma, beta (H,)
// float32. Outputs dx (rows, C), dw (C, H) and vec (3H) = [db, dgamma,
// dbeta] float32. Scratch, float32: dz_scr (rows, H), vec_part
// (eegflow_input_block_bwd_ctas(rows) * 3H), part (splits * C * H).
extern "C" int eegflow_input_block_bwd(const float* x, const float* dy, const float* w,
                                       const float* bias, const float* gamma,
                                       const float* beta, float* dx, float* dw, float* vec,
                                       float* dz_scr, float* vec_part, float* part,
                                       int splits, int rows, int C, int H, int bf16,
                                       cudaStream_t stream) {
  if (bad_shape(rows, C, H) || splits <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int ctas = std::min(kMaxCtas, (rows + kR - 1) / kR);
  const size_t smem = (static_cast<size_t>(C) * (H + 1) + static_cast<size_t>(kR) * H +
                       static_cast<size_t>(kR) * C + kMaxH / 32 * kR * 2) *
                      sizeof(float);
  cudaError_t err = eegflow::allow_dynamic_smem(input_block_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  input_block_bwd_kernel<<<ctas, H, smem, stream>>>(x, dy, w, bias, gamma, beta, dx, dz_scr,
                                                    vec_part, rows, C, bf16, 1e-5f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  using input_block_ops::DzRowsB;
  using input_block_ops::XRowsA;
  err = eegflow::gemm_split_k(XRowsA{x, C, bf16}, DzRowsB{dz_scr, H}, dw, part, C, H, rows,
                              splits, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t count = 3 * static_cast<size_t>(H);
  eegflow::reduce_splits_kernel<<<static_cast<unsigned>((count + 255) / 256), 256, 0,
                                  stream>>>(vec_part, vec, ctas, count);
  return static_cast<int>(cudaGetLastError());
}

// The number of partial rows the backward writes to vec_part.
extern "C" int eegflow_input_block_bwd_ctas(int rows) {
  return rows <= 0 ? 0 : std::min(kMaxCtas, (rows + kR - 1) / kR);
}
