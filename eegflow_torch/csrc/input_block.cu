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
// same operands and from the upstream gradient dy produces
//   dln = dy gelu'(zl);  dgamma += dln xhat;  dbeta += dln
//   dxhat = dln gamma;  dz = rsig (dxhat - mean(dxhat) - xhat mean(dxhat xhat))
//   db += dz;  dx = bf16?(dz) . bf16?(W)^T;  dW += bf16?(x)^T . bf16?(dz)
// (the sums over all B*T rows).
//
// What bounds it on the card: a row reads 61 floats and writes 256 (the
// backward reads 61 + 256 and writes 61); the products are 2 x 61 x 256
// multiply-adds a row each (three in the backward). At B=512, T=256 the
// forward moves 166 MB (0.050 ms at 3.35 TB/s; y is 80 % of it) and does
// 4.1 GFLOP (0.061 ms at the float32 CUDA-core peak, 0.004 ms at the bf16
// tensor-core peak); the backward moves 198 MB (0.059 ms) and does 12 GFLOP
// (float32: z 4.1 GFLOP on CUDA cores, 0.061 ms, and dx and dW 8.2 GFLOP in
// 3xTF32, 0.050 ms at a third of the TF32 peak). Both are memory-bound
// except the float32 modes, bound by their products; at H = 512 the bf16
// backward moves 332 MB (0.099 ms) for 25 GFLOP, but its row pass's GELU
// derivative (~30 instructions an element, 67 M elements) and the products'
// shared-memory traffic take longer than the bytes on the card. The
// LayerNorm needs a reduction across the H units of a row.
//
// Forward (input_block_fwd_kernel): a persistent grid of a fixed number of
// CTAs of 16 warps (the caller's plan, eegflow_torch/nn/cuda_input.py
// fwd_plan) walks tiles of kRows rows (64; 32 for H > 256, where a 64-row z
// tile and W would not fit): tile i of CTA c is i = c, c + grid, .. . W is
// resident in shared memory once per CTA, and a tile's x rows (one contiguous
// span) stream in by cp.async one tile ahead, behind the product and the
// LayerNorm pass. z goes into a float32 tile; then one warp per row forms the
// statistics with shuffles (no CTA barrier per row), the LayerNorm and GELU,
// and stores the row with 16-byte streaming stores. The bf16 mode computes z
// on mma.sync m16n8k16 with C padded to kCP = 64 by zeros (z_pair_mma, the
// same function as the bf16 backward's recomputed z, so both see the same z
// and the same statistics, row_stats). The float32 mode keeps the products on
// CUDA cores (TF32 would be a different function): float32 W in shared
// memory, each thread a 4-row register tile (ZTileF32), each z
// summed as fmaf over c ascending from 0, then + b; the float32 backward
// recomputes z with the same tile, so both see the same z bit for bit (the
// reference's bit-identical recomputation, pallas_input.py _proj_ln). C > kCP
// runs the product in channel chunks of kCP, W and x staged per chunk (no
// row of the classifier takes that path). Rows past B*T read as zero x and
// store nothing.
//
// Backward: both modes run on a persistent grid of a fixed number of CTAs of
// 16 warps (the caller's plan, cuda_input.py bwd_plan), each walking row
// tiles (tile i of CTA c: i = c, c + grid, ..), with dy and x streaming into
// shared memory by cp.async one tile ahead, behind the products. Per tile: z
// into a float32 tile; then one warp per row (two passes of shuffles: the
// statistics, then mean(dxhat) and mean(dxhat xhat)) forms dz into a tile,
// and each lane sums db, dgamma and dbeta of its columns; then dx = dz . W^T
// is stored and dW += x^T . dz accumulates in registers across the CTA's
// tiles. Each CTA (each cluster in the bf16 wide class) writes one partial
// row [dW (C x H), db, dgamma, dbeta] (the warps' column sums added in warp
// order), and a second small launch adds the rows in CTA (cluster) order: no
// scratch of size B*T x H, no atomics, so a launch repeats bit for bit. Rows
// past B*T have zero x and zero-filled dy, so their dz is exactly 0.
//
// The backward's bf16 mode (input_block_bwd_bf16_kernel): 64-row tiles, its
// three products on mma.sync m16n8k16 with C padded to kCP = 64 by zeros in
// shared memory and bf16(W) resident there: z = bf16(x) . bf16(W) (+ b), dx =
// bf16(dz) . bf16(W)^T, dW += bf16(x)^T . bf16(dz). Takes C <= 64 and H <=
// 256, H % 32 == 0.
//
// Its wide class (input_block_bwd_wide_kernel), C > 64 or H > 256: any C,
// H <= 512, H % 32 == 0 (kernel 9's widths). One CTA cannot hold a 64-row
// tile at H = 512 (its float32 z and dy alone are 256 KB), and dW's
// accumulators over 512 units (64 a thread) beside the row pass would spill;
// the class before ran 16-row tiles, whose short phases between CTA
// barriers, dx on four warps and W and x re-read every 16 rows took 8.8x the
// bound (PERF.md). This one runs a cluster of two CTAs a 64-row tile, CTA
// `rank` owning the units [rank H/2, rank H/2 + H/2) of z, dy and dW, each
// CTA the narrow class's tile on its half: bf16(W) of its units resident, z
// and dy of its units in shared memory (bf16(dz) goes over z and dxhat over
// dy, in place), dW of its units in registers (32 a thread), and each warp
// refills its own rows of dy for the next tile by cp.async as soon as its
// row pass is done with them. A row's sums over H (the statistics, then
// mean(dxhat) and mean(dxhat xhat)) are two half sums, each pushed into both
// CTAs' shared memory (DSMEM) and added as rank 0's + rank 1's after a
// cluster barrier, so both CTAs hold the same bits; dx = bf16(dz) .
// bf16(W)^T is two partial products over the halves, the CTA that finishes a
// 32-channel block adding the other's, pushed through DSMEM, behind the dW
// product: three cluster barriers a tile. db, dgamma and dbeta are each
// CTA's own columns, and a cluster writes one partial row. z is kernel 9's
// bf16 z bit for bit (z_pair_mma); the statistics sum each half and then the
// halves, an order other than kernel 9's (the last bits differ). The row
// pass, the largest phase of a tile, issues ~30 instructions an element with
// GELU's derivative on the hardware's approximate reciprocal and exponential
// (gelu_grad_fast); the products are bound by their ldmatrix traffic. For C >
// kCP the cluster walks its tiles once per channel chunk, as the float32 mode
// does: z and dz recomputed each pass from every chunk (W and x staged per
// chunk), dx's columns and dW's rows of that pass's chunk formed.
//
// The backward's float32 mode (input_block_bwd_f32_kernel): 32-row tiles (16
// for H > 256, as the forward's rule), W resident as float32 [c][u], z
// recomputed on CUDA cores with the forward's ZTileF32 on warp tiles half as
// wide, all 16 warps busy (the statistics are the forward's bit for bit), dz
// a float32 tile, and dx and dW in 3xTF32 on
// mma.sync m16n8k8 (mma_gemm.cuh's tf32_split, Tf32A and mma_tf32: each
// product good to about 2^-21 relative). ldmatrix cannot transpose 32-bit
// elements, so each operand is read where its k runs contiguous: dx's A (dz
// [r][u]) and B (W [c][u], k = u) and dW's A (x staged transposed, [c][r],
// k = r) by ldmatrix at row strides of 4 mod 32 floats (conflict-free), dW's
// B (dz, k = r across rows) by scalar loads (two-way bank conflicts). Any C:
// for C > kCP the CTA walks its tiles once per channel chunk, recomputing z
// and dz each time and forming that chunk's dx columns and dW rows. H % 32
// == 0, H <= 512.

#include <math.h>

#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma_gemm.cuh"
#include "pool_head_wide.cuh"

// Phase marks of kernel 10's wide bf16 class: nothing in a build of the
// kernels; kernels.ablate's "phases" variant defines the mark to add the SM
// clock cycles since a CTA's previous mark to phase p (thread 0 of each CTA).
#ifndef EEGFLOW_INPUT_MARK
#define EEGFLOW_INPUT_MARK(p)
#endif

namespace {

constexpr int kMaxH = 512;  // the widest H of either kernel

// erf by Abramowitz & Stegun 7.1.26, as eegflow/nn/pallas_input.py _erf.
// kFast takes the hardware's approximate reciprocal and exponential, a few
// float32 ulp apart from the IEEE forms (the formula itself is up to 1.5e-7
// off erf): the forward's GELU, which bounds its LayerNorm pass, uses it.
template <bool kFast = false>
__device__ __forceinline__ float erf_as(float x) {
  const float ax = fabsf(x);
  const float d = 1.0f + 0.3275911f * ax;
  const float t = kFast ? __fdividef(1.0f, d) : 1.0f / d;
  const float poly =
      ((((1.061405429f * t - 1.453152027f) * t + 1.421413741f) * t - 0.284496736f) * t +
       0.254829592f) *
      t;
  const float r = 1.0f - poly * (kFast ? __expf(-ax * ax) : expf(-ax * ax));
  return x < 0.f ? -r : r;
}

__device__ __forceinline__ float gelu_fast(float z) {
  return 0.5f * z * (1.0f + erf_as<true>(z * 0.7071067811865476f));
}

__device__ __forceinline__ float gelu_grad(float z) {
  const float phi = expf(-0.5f * z * z) * 0.3989422804014327f;
  const float cdf = 0.5f * (1.0f + erf_as(z * 0.7071067811865476f));
  return cdf + z * phi;
}

// gelu_grad with the hardware's approximate reciprocal and exponential, and
// one exponential exp(-z^2 / 2) for both phi(z) and the erf formula's
// exp(-(z / sqrt 2)^2): a few float32 ulp apart. The bf16 backward's wide
// class, whose row pass it bounds, uses it.
__device__ __forceinline__ float gelu_grad_fast(float z) {
  const float e = __expf(-0.5f * z * z);
  const float ax = fabsf(z * 0.7071067811865476f);
  const float t = __fdividef(1.0f, 1.0f + 0.3275911f * ax);
  const float poly =
      ((((1.061405429f * t - 1.453152027f) * t + 1.421413741f) * t - 0.284496736f) * t +
       0.254829592f) *
      t;
  const float erf_abs = 1.0f - poly * e;
  const float cdf = 0.5f * (1.0f + (z < 0.f ? -erf_abs : erf_abs));
  return cdf + z * (e * 0.3989422804014327f);
}

// mean and 1/sqrt(var + eps) of a row from its sums of z and z^2
__device__ __forceinline__ void ln_stats(float s1, float s2, float inv_h, float eps, float& mu,
                                         float& rsig) {
  mu = s1 * inv_h;
  rsig = rsqrtf(s2 * inv_h - mu * mu + eps);
}

// ---- the bf16 z tile and the row statistics, shared by kernels 9 and 10 ----

constexpr int kCP = 64;  // channels of a product chunk, padded by zeros

// acc[i][j] += bf16(x)[16 kMT rows x kCP] . bf16(W)[kCP x the 16 columns of
// `pair`], the kCP / 16 k-steps in ascending order: xs and ws bf16 tiles in
// shared memory, ldx and ldw elements a row. Thread (lane = 4 g + q) gets
// rows 16 i + g, + 8 and columns 16 pair + 8 j + 2 q, + 1.
template <int kMT>
__device__ __forceinline__ void z_pair_mma(float (&acc)[kMT][2][4], const __nv_bfloat16* xs,
                                           int ldx, const __nv_bfloat16* ws, int ldw, int pair,
                                           int lane) {
  using eegflow::smem_addr;
#pragma unroll
  for (int kk = 0; kk < kCP / 16; ++kk) {
    uint32_t r[4];
    eegflow::ldmatrix_x4_trans(
        r, smem_addr(ws + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldw + pair * 16 +
                     (lane >> 4) * 8));
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      uint32_t af[4];
      eegflow::ldmatrix_x4(af, smem_addr(xs + (16 * i + (lane & 15)) * ldx + kk * 16 +
                                         (lane >> 4) * 8));
      eegflow::mma_bf16(acc[i][0], af, r[0], r[1]);
      eegflow::mma_bf16(acc[i][1], af, r[2], r[3]);
    }
  }
}

// z = acc + b of z_pair_mma's rows and columns into the float32 tile zs
template <int kMT>
__device__ __forceinline__ void z_pair_store(const float (&acc)[kMT][2][4], float* zs, int ldz,
                                             const float* __restrict__ bias, int pair,
                                             int lane) {
  const int gq = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int col = pair * 16 + 8 * j + 2 * q;
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh)
        *reinterpret_cast<float2*>(zs + (16 * i + 8 * rh + gq) * ldz + col) =
            make_float2(acc[i][j][2 * rh] + b0, acc[i][j][2 * rh + 1] + b1);
  }
}

// One warp's row of z (hc float4 chunks; lane l takes chunks l + 32 i) into
// zv, and its LayerNorm statistics, summed over the chunks in order and then
// by shuffles. Chunks past hc read as 0, so a wider kCh sums the same.
template <int kCh>
__device__ __forceinline__ void row_stats(const float* zrow, int hc, int lane, float inv_h,
                                          float eps, float (&zv)[kCh][4], float& mu,
                                          float& rsig) {
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kCh; ++i) {
    const int ch = lane + 32 * i;
    float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ch < hc) z4 = *reinterpret_cast<const float4*>(zrow + 4 * ch);
    zv[i][0] = z4.x, zv[i][1] = z4.y, zv[i][2] = z4.z, zv[i][3] = z4.w;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s1 += zv[i][e];
      s2 += zv[i][e] * zv[i][e];
    }
  }
  ln_stats(eegflow::warp_sum(s1), eegflow::warp_sum(s2), inv_h, eps, mu, rsig);
}

// ---- kernel 9: the forward ----

constexpr int kFThreads = 512;
constexpr int kFWarps = kFThreads / 32;
constexpr int kFChunks = kMaxH / 128;  // float4 chunks of a row a lane owns

// bf16 z of a tile: warp w owns the 16-column pairs w + 16 p (p < kNP), all
// kRows rows; kNP = 64 / kRows, so H <= 256 at 64 rows and H <= 512 at 32.
template <int kRows>
struct ZTileBf16 {
  static constexpr int kMT = kRows / 16;
  static constexpr int kNP = 64 / kRows;
  float acc[kNP][kMT][2][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int p = 0; p < kNP; ++p)
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[p][i][j][e] = 0.f;
  }
  // one chunk of kCP channels: xs [kRows][ldx] and ws [kCP][ldw] bf16
  __device__ __forceinline__ void accumulate(const __nv_bfloat16* xs, int ldx,
                                             const __nv_bfloat16* ws, int ldw, int H, int warp,
                                             int lane) {
#pragma unroll
    for (int p = 0; p < kNP; ++p) {
      const int pair = warp + kFWarps * p;
      if (pair < H / 16) z_pair_mma<kMT>(acc[p], xs, ldx, ws, ldw, pair, lane);
    }
  }
  __device__ __forceinline__ void store(float* zs, int ldz, const float* __restrict__ bias,
                                        int H, int warp, int lane) const {
#pragma unroll
    for (int p = 0; p < kNP; ++p) {
      const int pair = warp + kFWarps * p;
      if (pair < H / 16) z_pair_store<kMT>(acc[p], zs, ldz, bias, pair, lane);
    }
  }
};

// float32 z of a tile on CUDA cores: warp tiles of 16 rows x kUW units (at
// most 16 of them: kRows / 16 x Hp / kUW, Hp = H rounded up to 64), warp w
// owning tile w; lane (lr = lane / 8, lu = lane % 8) the rows 4 lr .. + 3 of
// it and the units 4 lu + 32 j + e (j < kUW / 32, e < 4). x is staged
// transposed, xt [c][ldx], W as ws [c][ldw] float32 (ldw >= Hp, columns past
// H zero). Each z is fmaf over c ascending from 0, then + b, whatever the
// tile shape: kernels 9 (kUW = 64) and 10 (kUW = 32, so its 32-row tiles
// keep all 16 warps busy) both take z from here and agree bit for bit.
template <int kRows, int kUW = 64>
struct ZTileF32 {
  static constexpr int kWR = kRows / 16;  // warp tiles down a tile
  static constexpr int kN = kUW / 8;      // units a thread owns
  float acc[4][kN];
  float bv[kN];  // b of the thread's units (0 past H)
  int r0, u0;    // the thread's first row and unit
  bool active;

  __device__ __forceinline__ void init(const float* __restrict__ bias, int H, int warp,
                                       int lane) {
    const int Hp = (H + 63) / 64 * 64;
    active = warp < kWR * (Hp / kUW);
    r0 = 16 * (warp % kWR) + 4 * (lane >> 3);
    u0 = kUW * (warp / kWR) + 4 * (lane & 7);
#pragma unroll
    for (int j = 0; j < kN / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = u0 + 32 * j + e;
        bv[4 * j + e] = active && u < H ? bias[u] : 0.f;
      }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int n = 0; n < kN; ++n) acc[r][n] = 0.f;
  }
  // channels c0 + c, c < cn, in ascending order: z = fmaf(x, w, z)
  __device__ __forceinline__ void accumulate(const float* xt, int ldx, const float* ws, int ldw,
                                             int cn) {
    if (!active) return;
    const float* xp = xt + r0;
    const float* wp = ws + u0;
#pragma unroll 4
    for (int c = 0; c < cn; ++c) {
      const float4 xv = *reinterpret_cast<const float4*>(xp + c * ldx);
      float wn[kN];
#pragma unroll
      for (int j = 0; j < kN / 4; ++j) {
        const float4 wj = *reinterpret_cast<const float4*>(wp + c * ldw + 32 * j);
        wn[4 * j] = wj.x, wn[4 * j + 1] = wj.y, wn[4 * j + 2] = wj.z, wn[4 * j + 3] = wj.w;
      }
      const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int n = 0; n < kN; ++n) acc[r][n] = fmaf(xr[r], wn[n], acc[r][n]);
    }
  }
  __device__ __forceinline__ void store(float* zs, int ldz) const {
    if (!active) return;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < kN / 4; ++j)
        *reinterpret_cast<float4*>(zs + (r0 + r) * ldz + u0 + 32 * j) =
            make_float4(acc[r][4 * j] + bv[4 * j], acc[r][4 * j + 1] + bv[4 * j + 1],
                        acc[r][4 * j + 2] + bv[4 * j + 2], acc[r][4 * j + 3] + bv[4 * j + 3]);
  }
};

// gelu(LN(z)) of four consecutive units
__device__ __forceinline__ float4 ln_gelu4(const float (&z)[4], float mu, float rsig,
                                           float4 g, float4 b) {
  const float gv[4] = {g.x, g.y, g.z, g.w}, bv[4] = {b.x, b.y, b.z, b.w};
  float o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float xhat = (z[e] - mu) * rsig;
    o[e] = gelu_fast(xhat * gv[e] + bv[e]);
  }
  return make_float4(o[0], o[1], o[2], o[3]);
}

// Kernel 9 on tiles of kRows rows, kFThreads threads a CTA; x (rows, C) and
// y (rows, H) 16-byte aligned, w (C, H), bias, gamma, beta (H,) float32.
// Shared memory (fwd_smem_bytes): z [kRows][ldz] f32, the tile's raw x
// [kRows * min(C, kCP)] f32, W [kCP][ldw] (bf16, or f32 with ldw = Hp), and
// the product's x (bf16 [kRows][kCP + 8], or f32 transposed [kCP][kRows + 4]).
template <int kRows, bool kBf16>
__global__ void __launch_bounds__(kFThreads, 1)
input_block_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ bias, const float* __restrict__ gamma,
                       const float* __restrict__ beta, float* __restrict__ y, int rows, int C,
                       int H, float eps) {
  using eegflow::smem_addr;
  using Bf = __nv_bfloat16;
  extern __shared__ __align__(16) uint8_t smem[];
  const int Hp = (H + 63) / 64 * 64;
  const int ldz = (kBf16 ? H : Hp) + 8;
  const int ldw = kBf16 ? H + 8 : Hp;
  const int ldx = kBf16 ? kCP + 8 : kRows + 4;
  float* const zs = reinterpret_cast<float*>(smem);
  float* const xraw = zs + kRows * ldz;
  uint8_t* const wbase = reinterpret_cast<uint8_t*>(xraw + kRows * kCP);
  uint8_t* const xbase = wbase + static_cast<size_t>(kCP) * ldw * (kBf16 ? 2 : 4);
  Bf* const wsb = reinterpret_cast<Bf*>(wbase);
  float* const wsf = reinterpret_cast<float*>(wbase);
  Bf* const xsb = reinterpret_cast<Bf*>(xbase);
  float* const xtf = reinterpret_cast<float*>(xbase);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = (rows + kRows - 1) / kRows;
  const int nch = (C + kCP - 1) / kCP;
  const int hc = H / 4;
  const float inv_h = 1.0f / static_cast<float>(H);

  // W's channels c0 .. c0 + kCP into ws: bf16 rows past C zero; float32
  // columns past H zero
  auto stage_w = [&](int c0) {
    const int cn = min(kCP, C - c0);
    if constexpr (kBf16) {
      for (int i = tid; i < kCP * H; i += kFThreads) {
        const int c = i / H, u = i - c * H;
        wsb[c * ldw + u] = __float2bfloat16_rn(
            c < cn ? w[static_cast<size_t>(c0 + c) * H + u] : 0.f);
      }
    } else {
      for (int i = tid; i < cn * Hp; i += kFThreads) {
        const int c = i / Hp, u = i - c * Hp;
        wsf[i] = u < H ? w[static_cast<size_t>(c0 + c) * H + u] : 0.f;
      }
    }
  };
  // x[r][c] (c < cn) of the tile into the product's tile, from `src` with
  // row stride lds; the bf16 tile's columns cn .. kCP - 1 zero
  auto stage_x = [&](const float* src, int lds, int cn, int avail) {
    if constexpr (kBf16) {
      for (int i = tid; i < kRows * kCP; i += kFThreads) {
        const int r = i / kCP, c = i - r * kCP;
        xsb[r * ldx + c] = __float2bfloat16_rn(c < cn && r < avail ? src[r * lds + c] : 0.f);
      }
    } else {
      for (int i = tid; i < kRows * cn; i += kFThreads) {
        const int c = i / kRows, r = i - c * kRows;
        xtf[c * ldx + r] = r < avail ? src[r * lds + c] : 0.f;
      }
    }
  };
  // C <= kCP: the tile's x rows (one contiguous span, 16-byte aligned) into
  // xraw by cp.async, rows past `rows` zero-filled
  auto fetch = [&](int tile) {
    const int row0 = tile * kRows;
    const int nx = min(kRows, rows - row0) * C;
    const float* const xtile = x + static_cast<size_t>(row0) * C;
    for (int c = tid; c < kRows * C / 4; c += kFThreads) {
      const int n = min(4, max(0, nx - 4 * c));
      eegflow::cp_async16_part(smem_addr(xraw + 4 * c), n > 0 ? xtile + 4 * c : x, 4 * n);
    }
    eegflow::cp_async_commit();
  };

  // gamma and beta of the lane's columns 4 (lane + 32 i) .. + 3
  float4 gam[kFChunks], bet[kFChunks];
#pragma unroll
  for (int i = 0; i < kFChunks; ++i) {
    const int u = 4 * (lane + 32 * i);
    gam[i] = u < H ? make_float4(gamma[u], gamma[u + 1], gamma[u + 2], gamma[u + 3])
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    bet[i] = u < H ? make_float4(beta[u], beta[u + 1], beta[u + 2], beta[u + 3])
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  using ZTile = typename std::conditional<kBf16, ZTileBf16<kRows>, ZTileF32<kRows>>::type;
  ZTile zt;
  if constexpr (!kBf16) zt.init(bias, H, warp, lane);
  if (nch == 1) {  // W resident for the CTA's tiles
    if (static_cast<int>(blockIdx.x) < tiles) fetch(blockIdx.x);
    stage_w(0);
  }

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * kRows;
    const int avail = min(kRows, rows - row0);
    zt.zero();
    for (int ch = 0; ch < nch; ++ch) {
      const int cn = min(kCP, C - ch * kCP);
      if (nch == 1) {
        eegflow::cp_async_wait<0>();
        __syncthreads();  // the tile's x landed; the last tile's rows are done with zs
        stage_x(xraw, C, cn, kRows);
        __syncthreads();  // xraw is free again
        if (tile + static_cast<int>(gridDim.x) < tiles) fetch(tile + gridDim.x);
      } else {
        __syncthreads();  // no thread reads ws or the x tile any more
        stage_w(ch * kCP);
        stage_x(x + static_cast<size_t>(row0) * C + ch * kCP, C, cn, avail);
        __syncthreads();
      }
      if constexpr (kBf16)
        zt.accumulate(xsb, ldx, wsb, ldw, H, warp, lane);
      else
        zt.accumulate(xtf, ldx, wsf, Hp, cn);
    }
    if constexpr (kBf16)
      zt.store(zs, ldz, bias, H, warp, lane);
    else
      zt.store(zs, ldz);
    __syncthreads();  // z whole

    // one warp per row: the statistics, the LayerNorm and GELU, y stored
    for (int r = warp; r < avail; r += kFWarps) {
      float zv[kFChunks][4], mu, rsig;
      row_stats<kFChunks>(zs + r * ldz, hc, lane, inv_h, eps, zv, mu, rsig);
      float* const yr = y + static_cast<size_t>(row0 + r) * H;
#pragma unroll
      for (int i = 0; i < kFChunks; ++i) {
        const int ch = lane + 32 * i;
        if (ch >= hc) continue;
        const float4 o = ln_gelu4(zv[i], mu, rsig, gam[i], bet[i]);
        __stcs(reinterpret_cast<float4*>(yr + 4 * ch), o);
      }
    }
  }
}

template <int kRows, bool kBf16>
size_t fwd_smem_bytes(int C, int H) {
  const size_t Hp = (H + 63) / 64 * 64;
  const size_t ldz = (kBf16 ? H : Hp) + 8;
  const size_t w_bytes = kBf16 ? kCP * (H + 8) * 2 : kCP * Hp * 4;
  const size_t x_bytes = kBf16 ? kRows * (kCP + 8) * 2 : kCP * (kRows + 4) * 4;
  return (kRows * ldz + kRows * kCP) * sizeof(float) + w_bytes + x_bytes;
}

template <int kRows, bool kBf16>
cudaError_t launch_fwd(const float* x, const float* w, const float* bias, const float* gamma,
                       const float* beta, float* y, int ctas, int rows, int C, int H,
                       cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<kRows, kBf16>(C, H);
  cudaError_t err = eegflow::allow_dynamic_smem(input_block_fwd_kernel<kRows, kBf16>, smem);
  if (err != cudaSuccess) return err;
  input_block_fwd_kernel<kRows, kBf16><<<ctas, kFThreads, smem, stream>>>(
      x, w, bias, gamma, beta, y, rows, C, H, 1e-5f);
  return cudaGetLastError();
}

// ---- kernel 10, float32 mode ----

constexpr int kF32Threads = 512;
constexpr int kF32Warps = kF32Threads / 32;

// Tiles of kRows rows (32: H <= 256; 16: H <= 512), kF32Threads threads.
// Thread (warp w, lane = 4 g + q): row pass rows w, w + 16, columns 4 (lane +
// 32 i) .. + 3; dx m-tile w % kMT (rows 16 (w % kMT) + g, + 8) and n-tile
// w / kMT (channels 8 (w / kMT) + 2 q, + 1 of the chunk); dW channels
// 16 (w % 4) + g, + 8 of the chunk and units 8 nt + 2 q, + 1 of the n-tiles
// nt = w / 4 + 4 j.
//   x (rows, C), dy (rows, H) (both 16-byte aligned), w (C, H), bias, gamma,
//   beta (H,) float32; dx (rows, C); part (gridDim.x, C H + 3 H) the CTA's
//   partial [dW, db, dgamma, dbeta].
// Shared memory (bwd_f32_smem_bytes): W of a channel chunk [kCP][Hp + 4], x^T
// of the chunk [kCP][kRows + 4], z and then dz [kRows][Hp + 4], dy [kRows][H],
// the tile's x as read [kRows * kCP] (C <= kCP).
template <int kRows>
__global__ void __launch_bounds__(kF32Threads, 1)
input_block_bwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                           const float* __restrict__ w, const float* __restrict__ bias,
                           const float* __restrict__ gamma, const float* __restrict__ beta,
                           float* __restrict__ dx, float* __restrict__ part, int rows, int C,
                           int H, float eps) {
  using eegflow::smem_addr;
  constexpr int kMT = kRows / 16;      // m-tiles of dx
  constexpr int kMaxHt = 512 / kMT;    // the widest H of this tile
  constexpr int kCh = kMaxHt / 128;    // float4 chunks of a row a lane owns
  constexpr int kNT = kMaxHt / 8 / 4;  // n-tiles of dW a warp owns
  constexpr int kGroup = 4;            // dW's n-tiles whose products go in turns
  extern __shared__ __align__(16) uint8_t smem[];
  const int Hp = (H + 63) / 64 * 64;
  const int ldw = Hp + 4, ldx = kRows + 4, ldz = Hp + 4;
  float* const ws = reinterpret_cast<float*>(smem);
  float* const xt = ws + kCP * ldw;
  float* const zs = xt + kCP * ldx;
  float* const dys = zs + kRows * ldz;
  float* const xraw = dys + kRows * H;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const int tiles = (rows + kRows - 1) / kRows;
  const int nch = (C + kCP - 1) / kCP;
  const int hc = H / 4;
  const float inv_h = 1.0f / static_cast<float>(H);

  // W's channels c0 .. c0 + kCP into ws, rows past C and columns past H zero
  auto stage_w = [&](int c0) {
    for (int i = tid; i < kCP * Hp; i += kF32Threads) {
      const int c = i / Hp, u = i - c * Hp;
      ws[c * ldw + u] = c0 + c < C && u < H ? w[static_cast<size_t>(c0 + c) * H + u] : 0.f;
    }
  };
  // the tile's x[r][c0 + c] transposed into xt from src (its channel c0,
  // rows lds floats apart), rows past avail and channels past C zero
  auto stage_x = [&](const float* src, int lds, int c0, int avail) {
    const int cn = min(kCP, C - c0);
    for (int i = tid; i < kCP * kRows; i += kF32Threads) {
      const int c = i / kRows, r = i - c * kRows;
      xt[c * ldx + r] = c < cn && r < avail ? src[r * lds + c] : 0.f;
    }
  };
  // a tile's dy into dys by cp.async, rows past `rows` zero-filled, and for
  // C <= kCP its x rows (one contiguous span) into xraw
  auto fetch = [&](int tile) {
    const int row0 = tile * kRows;
    const float* const dyg = dy + static_cast<size_t>(row0) * H;
    for (int c = tid; c < kRows * hc; c += kF32Threads) {
      const int r = c / hc, col = (c - r * hc) * 4;
      const bool valid = row0 + r < rows;
      eegflow::cp_async16(smem_addr(dys + r * H + col), valid ? dyg + r * H + col : dy, valid);
    }
    if (nch == 1) {
      const int nx = min(kRows, rows - row0) * C;  // floats of the tile's rows
      const float* const xg = x + static_cast<size_t>(row0) * C;
      for (int c = tid; c < kRows * C / 4; c += kF32Threads) {
        const int n = min(4, max(0, nx - 4 * c));
        eegflow::cp_async16_part(smem_addr(xraw + 4 * c), n > 0 ? xg + 4 * c : x, 4 * n);
      }
    }
    eegflow::cp_async_commit();
  };

  // db, dgamma, dbeta of the lane's columns over the warp's rows
  float pdb[kCh][4], pdg[kCh][4], pdbt[kCh][4];
#pragma unroll
  for (int i = 0; i < kCh; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) pdb[i][e] = pdg[i][e] = pdbt[i][e] = 0.f;
  ZTileF32<kRows, 32> zt;
  zt.init(bias, H, warp, lane);
  float* const out = part + static_cast<size_t>(blockIdx.x) * (C + 3) * H;

  // one pass over the CTA's tiles per channel chunk (one for C <= kCP): dx's
  // columns and dW's rows of channels c0 .. c0 + kCP
  for (int pass = 0; pass < nch; ++pass) {
    const int c0 = pass * kCP;
    const int cn = min(kCP, C - c0);
    float acc_w[kNT][4];  // dW of the warp's channels and n-tiles over the CTA's rows
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_w[j][e] = 0.f;
    if (static_cast<int>(blockIdx.x) < tiles) fetch(blockIdx.x);
    if (nch == 1) stage_w(0);  // W resident for the CTA's tiles

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int row0 = tile * kRows;
      const int tr = min(kRows, rows - row0);
      eegflow::cp_async_wait<0>();
      __syncthreads();  // the tile's dy (and x) landed

      // z = x . W + b, each z summed as kernel 9 sums it
      zt.zero();
      if (nch == 1) {
        stage_x(xraw, C, 0, kRows);
        __syncthreads();
        zt.accumulate(xt, ldx, ws, ldw, C);
      } else {
        for (int ch = 0; ch < nch; ++ch) {
          if (ch > 0) __syncthreads();  // no thread reads ws or xt any more
          stage_w(ch * kCP);
          stage_x(x + static_cast<size_t>(row0) * C + ch * kCP, C, ch * kCP, tr);
          __syncthreads();
          zt.accumulate(xt, ldx, ws, ldw, min(kCP, C - ch * kCP));
        }
      }
      zt.store(zs, ldz);
      __syncthreads();  // z whole

      // the LayerNorm and GELU backward, one warp per row: dz over z in zs.
      // Rows past `rows` have dy = 0 (zero-filled), so their dz and sums are 0.
      for (int r = warp; r < kRows; r += kF32Warps) {
        float zv[kCh][4], dv[kCh][4], mu, rsig;
        row_stats<kCh>(zs + r * ldz, hc, lane, inv_h, eps, zv, mu, rsig);
#pragma unroll
        for (int i = 0; i < kCh; ++i) {
          const int ch = lane + 32 * i;
          float4 d4 = make_float4(0.f, 0.f, 0.f, 0.f);
          if (ch < hc) d4 = *reinterpret_cast<const float4*>(dys + r * H + 4 * ch);
          dv[i][0] = d4.x, dv[i][1] = d4.y, dv[i][2] = d4.z, dv[i][3] = d4.w;
        }
        float m1 = 0.f, m2 = 0.f;
#pragma unroll
        for (int i = 0; i < kCh; ++i) {
          const int ch = lane + 32 * i;
          if (ch >= hc) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float gv = gamma[4 * ch + e];
            const float xhat = (zv[i][e] - mu) * rsig;
            const float dln = dv[i][e] * gelu_grad(xhat * gv + beta[4 * ch + e]);
            if (pass == 0) {
              pdg[i][e] += dln * xhat;
              pdbt[i][e] += dln;
            }
            const float dxh = dln * gv;
            zv[i][e] = xhat;
            dv[i][e] = dxh;
            m1 += dxh;
            m2 += dxh * xhat;
          }
        }
        m1 = eegflow::warp_sum(m1) * inv_h;
        m2 = eegflow::warp_sum(m2) * inv_h;
#pragma unroll
        for (int i = 0; i < kCh; ++i) {
          const int ch = lane + 32 * i;
          if (ch >= hc) continue;
          float dz[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dz[e] = rsig * (dv[i][e] - m1 - zv[i][e] * m2);
            if (pass == 0) pdb[i][e] += dz[e];
          }
          *reinterpret_cast<float4*>(zs + r * ldz + 4 * ch) =
              make_float4(dz[0], dz[1], dz[2], dz[3]);
        }
      }
      __syncthreads();  // dz whole; no thread reads dys, xraw or (C > kCP) ws and xt
      if (nch > 1) {  // the pass's channels of W and x for dx and dW
        stage_w(c0);
        stage_x(x + static_cast<size_t>(row0) * C + c0, C, c0, tr);
        __syncthreads();
      }
      if (tile + static_cast<int>(gridDim.x) < tiles) fetch(tile + gridDim.x);

      // dx = dz . W^T over the units in 16-deep steps (two k-steps of 8):
      // lo . hi, hi . lo and hi . hi into sums of their own for each k-step
      // parity, so consecutive products do not wait on each other
      {
        const int mt = warp % kMT, nt = warp / kMT;
        if (nt < kCP / 8 && 8 * nt < cn) {
          float acc[6][4];
#pragma unroll
          for (int s = 0; s < 6; ++s)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[s][e] = 0.f;
          for (int k0 = 0; k0 < H; k0 += 16) {
            uint32_t br[4];
            eegflow::ldmatrix_x4(br, smem_addr(ws + (8 * nt + (lane & 7)) * ldw + k0 +
                                               (lane >> 3) * 4));
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              uint32_t ar[4];
              eegflow::ldmatrix_x4(ar, smem_addr(zs + (16 * mt + (lane & 7) +
                                                       ((lane >> 3) & 1) * 8) * ldz +
                                                 k0 + 8 * h + (lane >> 4) * 4));
              eegflow::Tf32A a;
              a.split(ar);
              uint32_t bh[2], bl[2];
              eegflow::tf32_split(__uint_as_float(br[2 * h]), bh[0], bl[0]);
              eegflow::tf32_split(__uint_as_float(br[2 * h + 1]), bh[1], bl[1]);
              eegflow::mma_tf32(acc[3 * h], a.lo, bh[0], bh[1]);
              eegflow::mma_tf32(acc[3 * h + 1], a.hi, bl[0], bl[1]);
              eegflow::mma_tf32(acc[3 * h + 2], a.hi, bh[0], bh[1]);
            }
          }
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            const int row = 16 * mt + 8 * rh + gq;
            if (row >= tr) continue;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 8 * nt + 2 * q + e;
              const int k = 2 * rh + e;
              const float v = (acc[2][k] + acc[5][k]) +
                              ((acc[0][k] + acc[3][k]) + (acc[1][k] + acc[4][k]));
              if (c < cn) dx[static_cast<size_t>(row0 + row) * C + c0 + c] = v;
            }
          }
        }
      }

      // dW += x^T . dz over the tile's rows: per k-step, kGroup n-tiles at a
      // time, lo . hi over the group, then hi . lo, then hi . hi
      {
        const int mt = warp & 3;
        if (16 * mt < cn) {
#pragma unroll
          for (int kk = 0; kk < kRows / 8; ++kk) {
            uint32_t ar[4];
            eegflow::ldmatrix_x4(ar, smem_addr(xt + (16 * mt + (lane & 7) +
                                                     ((lane >> 3) & 1) * 8) * ldx +
                                               kk * 8 + (lane >> 4) * 4));
            eegflow::Tf32A a;
            a.split(ar);
            const float* const dzk = zs + (kk * 8 + q) * ldz + gq;
#pragma unroll
            for (int j0 = 0; j0 < kNT; j0 += kGroup) {
              uint32_t bh[kGroup][2], bl[kGroup][2];
#pragma unroll
              for (int j = 0; j < kGroup; ++j) {
                const int n = 8 * ((warp >> 2) + 4 * (j0 + j));
                const bool on = n < H;
                eegflow::tf32_split(on ? dzk[n] : 0.f, bh[j][0], bl[j][0]);
                eegflow::tf32_split(on ? dzk[4 * ldz + n] : 0.f, bh[j][1], bl[j][1]);
              }
#pragma unroll
              for (int j = 0; j < kGroup; ++j)
                if (8 * ((warp >> 2) + 4 * (j0 + j)) < H)
                  eegflow::mma_tf32(acc_w[j0 + j], a.lo, bh[j][0], bh[j][1]);
#pragma unroll
              for (int j = 0; j < kGroup; ++j)
                if (8 * ((warp >> 2) + 4 * (j0 + j)) < H)
                  eegflow::mma_tf32(acc_w[j0 + j], a.hi, bl[j][0], bl[j][1]);
#pragma unroll
              for (int j = 0; j < kGroup; ++j)
                if (8 * ((warp >> 2) + 4 * (j0 + j)) < H)
                  eegflow::mma_tf32(acc_w[j0 + j], a.hi, bh[j][0], bh[j][1]);
            }
          }
        }
      }
      __syncthreads();  // the next tile overwrites xt, zs, dys (and ws)
    }

    // the pass's rows of the CTA's partial dW
    {
      const int mt = warp & 3;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = 8 * ((warp >> 2) + 4 * j) + 2 * q;
        if (n >= H) continue;
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int c = 16 * mt + 8 * rh + gq;
          if (c < cn)
            *reinterpret_cast<float2*>(out + static_cast<size_t>(c0 + c) * H + n) =
                make_float2(acc_w[j][2 * rh], acc_w[j][2 * rh + 1]);
        }
      }
    }
  }

  // db, dgamma, dbeta summed over the warps in order
  __syncthreads();
  float* const red = ws;  // [kF32Warps][3][H], over W
#pragma unroll
  for (int i = 0; i < kCh; ++i) {
    const int ch = lane + 32 * i;
    if (ch >= hc) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      red[(3 * warp) * H + 4 * ch + e] = pdb[i][e];
      red[(3 * warp + 1) * H + 4 * ch + e] = pdg[i][e];
      red[(3 * warp + 2) * H + 4 * ch + e] = pdbt[i][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < 3 * H; i += kF32Threads) {
    float v = 0.f;
    for (int wi = 0; wi < kF32Warps; ++wi) v += red[wi * 3 * H + i];
    out[static_cast<size_t>(C) * H + i] = v;
  }
}

template <int kRows>
size_t bwd_f32_smem_bytes(int H) {
  const size_t Hp = (H + 63) / 64 * 64;
  return (kCP * (Hp + 4) + kCP * (kRows + 4) + kRows * (Hp + 4) + static_cast<size_t>(kRows) * H +
          kRows * kCP) *
         sizeof(float);
}

template <int kRows>
cudaError_t launch_bwd_f32(const float* x, const float* dy, const float* w, const float* bias,
                           const float* gamma, const float* beta, float* dx, float* part,
                           int ctas, int rows, int C, int H, cudaStream_t stream) {
  const size_t smem = bwd_f32_smem_bytes<kRows>(H);
  cudaError_t err = eegflow::allow_dynamic_smem(input_block_bwd_f32_kernel<kRows>, smem);
  if (err != cudaSuccess) return err;
  input_block_bwd_f32_kernel<kRows><<<ctas, kF32Threads, smem, stream>>>(
      x, dy, w, bias, gamma, beta, dx, part, rows, C, H, 1e-5f);
  return cudaGetLastError();
}

// bf16 backward: tiles of kTile rows, kBThreads threads (16 warps), the
// channels padded to kCP.
constexpr int kTile = 64;
constexpr int kBThreads = 512;
constexpr int kBWarps = kBThreads / 32;
constexpr int kMaxHB = 256;          // a warp owns one 16-column pair of z
constexpr int kChunks = kMaxHB / 128;  // float4 chunks of a row a lane owns

// Thread (warp w, lane = 4 g + q). z: rows 16 i + g, + 8 of m-tile i and
// columns 16 w + 8 j + 2 q, + 1. Row pass: rows w + 16 r, columns
// 4 (lane + 32 i) .. + 3. dx: rows 16 (w % 4) + g, + 8, channels
// 16 (w / 4) + 8 j + 2 q, + 1. dW: channels 16 (w % 4) + g, + 8, columns
// 16 p + 8 j + 2 q, + 1 of the pairs p = w / 4 + 4 jj.
//   x (rows, C), dy (rows, H) (both 16-byte aligned), w (C, H), bias, gamma, beta
//   (H,) float32; dx (rows, C); part (gridDim.x, C H + 3 H) the CTA's partial
//   [dW, db, dgamma, dbeta].
__global__ void __launch_bounds__(kBThreads, 1)
input_block_bwd_bf16_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                            const float* __restrict__ w, const float* __restrict__ bias,
                            const float* __restrict__ gamma, const float* __restrict__ beta,
                            float* __restrict__ dx, float* __restrict__ part, int rows, int C,
                            int H, float eps) {
  using eegflow::smem_addr;
  extern __shared__ __align__(16) uint8_t smem[];
  const int ldw = H + 8, ldx = kCP + 8, ldz = H + 8;
  __nv_bfloat16* const ws = reinterpret_cast<__nv_bfloat16*>(smem);  // [kCP][H + 8] bf16(W)
  __nv_bfloat16* const xs = ws + kCP * ldw;                         // [kTile][kCP + 8] bf16(x)
  __nv_bfloat16* const dzs = xs + kTile * ldx;                      // [kTile][H + 8] bf16(dz)
  float* const zs = reinterpret_cast<float*>(dzs + kTile * ldz);    // [kTile][H + 8] z
  float* const dys = zs + kTile * ldz;                              // [kTile][H] dy
  float* const xraw = dys + kTile * H;                              // [kTile * C] x as read

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const int tiles = (rows + kTile - 1) / kTile;
  const int hc = H / 4;  // float4 chunks of a row
  const float inv_h = 1.0f / static_cast<float>(H);

  // a tile's dy into dys and its x rows (contiguous, 16-byte aligned) into
  // xraw by cp.async, rows past `rows` zero-filled
  auto fetch = [&](int tile) {
    const int row0 = tile * kTile;
    for (int c = tid; c < kTile * hc; c += kBThreads) {
      const int r = c / hc, col = (c - r * hc) * 4;
      const bool valid = row0 + r < rows;
      eegflow::cp_async16(smem_addr(dys + r * H + col),
                          valid ? dy + static_cast<size_t>(row0 + r) * H + col : dy, valid);
    }
    const int nx = min(kTile, rows - row0) * C;  // floats of the tile's rows
    const float* const xt = x + static_cast<size_t>(row0) * C;
    for (int c = tid; c < (kTile * C + 3) / 4; c += kBThreads) {
      const int n = min(4, max(0, nx - 4 * c));
      eegflow::cp_async16_part(smem_addr(xraw + 4 * c), n > 0 ? xt + 4 * c : x, 4 * n);
    }
    eegflow::cp_async_commit();
  };
  fetch(blockIdx.x);
  // bf16(W), its rows past C zero; xs's columns past C zero (never written again)
  for (int i = tid; i < kCP * H; i += kBThreads) {
    const int c = i / H;
    ws[c * ldw + (i - c * H)] = __float2bfloat16_rn(c < C ? w[i] : 0.f);
  }
  for (int i = tid; i < kTile * (kCP - C); i += kBThreads) {
    const int r = i / (kCP - C);
    xs[r * ldx + C + (i - r * (kCP - C))] = __float2bfloat16_rn(0.f);
  }

  // db, dgamma, dbeta of the lane's columns over the warp's rows
  float pdb[kChunks][4], pdg[kChunks][4], pdbt[kChunks][4];
  // dW of the warp's channels and pairs over the CTA's rows
  float acc_w[4][2][4];
#pragma unroll
  for (int i = 0; i < kChunks; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) pdb[i][e] = pdg[i][e] = pdbt[i][e] = 0.f;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_w[jj][j][e] = 0.f;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * kTile;
    const int tr = min(kTile, rows - row0);
    eegflow::cp_async_wait<0>();
    __syncthreads();  // the tile's x and dy landed
    for (int i = tid; i < kTile * C; i += kBThreads) {
      const int r = i / C;
      xs[r * ldx + (i - r * C)] = __float2bfloat16_rn(xraw[i]);
    }
    __syncthreads();

    // z = bf16(x) . bf16(W) + b into zs, warp w taking columns 16 w .. + 15
    if (warp < H / 16) {
      float acc[4][2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      z_pair_mma<4>(acc, xs, ldx, ws, ldw, warp, lane);
      z_pair_store<4>(acc, zs, ldz, bias, warp, lane);
    }
    __syncthreads();  // z whole

    // the LayerNorm and GELU backward, one warp per row: dz, bf16(dz) into
    // dzs. Rows past `rows` have dy = 0 (zero-filled), so their dz and sums
    // are 0.
    for (int r = warp; r < kTile; r += kBWarps) {
      float zv[kChunks][4], dv[kChunks][4], mu, rsig;
      row_stats<kChunks>(zs + r * ldz, hc, lane, inv_h, eps, zv, mu, rsig);
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int ch = lane + 32 * i;
        float4 d4 = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ch < hc) d4 = *reinterpret_cast<const float4*>(dys + r * H + 4 * ch);
        dv[i][0] = d4.x, dv[i][1] = d4.y, dv[i][2] = d4.z, dv[i][3] = d4.w;
      }
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int ch = lane + 32 * i;
        if (ch >= hc) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float gv = gamma[4 * ch + e];
          const float xhat = (zv[i][e] - mu) * rsig;
          const float dln = dv[i][e] * gelu_grad(xhat * gv + beta[4 * ch + e]);
          pdg[i][e] += dln * xhat;
          pdbt[i][e] += dln;
          const float dxh = dln * gv;
          zv[i][e] = xhat;
          dv[i][e] = dxh;
          m1 += dxh;
          m2 += dxh * xhat;
        }
      }
      m1 = eegflow::warp_sum(m1) * inv_h;
      m2 = eegflow::warp_sum(m2) * inv_h;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int ch = lane + 32 * i;
        if (ch >= hc) continue;
        float dz[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dz[e] = rsig * (dv[i][e] - m1 - zv[i][e] * m2);
          pdb[i][e] += dz[e];
        }
        *reinterpret_cast<uint2*>(dzs + r * ldz + 4 * ch) =
            make_uint2(eegflow::pack_bf16(dz[0], dz[1]), eegflow::pack_bf16(dz[2], dz[3]));
      }
    }
    __syncthreads();  // bf16(dz) whole; no thread reads dys or xraw any more
    if (tile + static_cast<int>(gridDim.x) < tiles) fetch(tile + gridDim.x);

    // dx = bf16(dz) . bf16(W)^T
    {
      const int mt = warp & 3, nb = 16 * (warp >> 2);
      float acc[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      for (int kk = 0; kk < H / 16; ++kk) {
        uint32_t af[4], r[4];
        eegflow::ldmatrix_x4(af, smem_addr(dzs + (16 * mt + (lane & 15)) * ldz + kk * 16 +
                                           (lane >> 4) * 8));
        eegflow::ldmatrix_x4(r, smem_addr(ws + (nb + (lane & 7) + ((lane >> 4) << 3)) * ldw +
                                          kk * 16 + ((lane >> 3) & 1) * 8));
        eegflow::mma_bf16(acc[0], af, r[0], r[1]);
        eegflow::mma_bf16(acc[1], af, r[2], r[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int row = 16 * mt + 8 * rh + gq;
          if (row >= tr) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = nb + 8 * j + 2 * q + e;
            if (c < C) dx[static_cast<size_t>(row0 + row) * C + c] = acc[j][2 * rh + e];
          }
        }
    }

    // dW += bf16(x)^T . bf16(dz) over the tile's rows
    {
      const int mt = warp & 3;
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t af[4];
        eegflow::ldmatrix_x4_trans(af, smem_addr(xs + (kk * 16 + (lane & 7) +
                                                       ((lane >> 4) << 3)) * ldx +
                                                 16 * mt + ((lane >> 3) & 1) * 8));
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int pr = (warp >> 2) + 4 * jj;
          if (pr >= H / 16) continue;
          uint32_t r[4];
          eegflow::ldmatrix_x4_trans(
              r, smem_addr(dzs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldz + pr * 16 +
                           (lane >> 4) * 8));
          eegflow::mma_bf16(acc_w[jj][0], af, r[0], r[1]);
          eegflow::mma_bf16(acc_w[jj][1], af, r[2], r[3]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites xs, zs and dzs
  }

  // the CTA's partial row: dW, then db, dgamma, dbeta summed over the warps
  // in order
  float* const out = part + static_cast<size_t>(blockIdx.x) * (C + 3) * H;
  {
    const int mt = warp & 3;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int pr = (warp >> 2) + 4 * jj;
      if (pr >= H / 16) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int c = 16 * mt + 8 * rh + gq;
          if (c < C)
            *reinterpret_cast<float2*>(out + static_cast<size_t>(c) * H + pr * 16 + 8 * j +
                                       2 * q) =
                make_float2(acc_w[jj][j][2 * rh], acc_w[jj][j][2 * rh + 1]);
        }
    }
  }
  float* const red = zs;  // [kBWarps][3][H], over zs and dys
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int ch = lane + 32 * i;
    if (ch >= hc) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      red[(3 * warp) * H + 4 * ch + e] = pdb[i][e];
      red[(3 * warp + 1) * H + 4 * ch + e] = pdg[i][e];
      red[(3 * warp + 2) * H + 4 * ch + e] = pdbt[i][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < 3 * H; i += kBThreads) {
    float v = 0.f;
    for (int wi = 0; wi < kBWarps; ++wi) v += red[wi * 3 * H + i];
    out[static_cast<size_t>(C) * H + i] = v;
  }
}

size_t bwd_bf16_smem_bytes(int H) {
  return (static_cast<size_t>(kCP) * (H + 8) + static_cast<size_t>(kTile) * (kCP + 8) +
          static_cast<size_t>(kTile) * (H + 8)) *
             sizeof(__nv_bfloat16) +
         (static_cast<size_t>(kTile) * (H + 8) + static_cast<size_t>(kTile) * H +
          static_cast<size_t>(kTile) * kCP) *
             sizeof(float);
}

// ---- kernel 10, bf16 mode, the wide class ----

constexpr int kPair = 2;                                // CTAs a row tile: one cluster
constexpr int kPairRows = 64;                           // rows a tile
constexpr int kPairRowWarp = kPairRows / kBWarps;       // rows of the row pass a warp owns
constexpr int kPairChunks = kMaxH / kPair / 128;        // float4 chunks of a half row a lane owns
constexpr int kPairDx = kCP / kPair;                    // dx channels of a chunk a CTA finishes
constexpr int kPairLdi = kPairDx + 4;                   // the dx inbox's row stride

// The wide class's shared memory, in floats from its start, for H units:
// bf16(W) of the CTA's columns [kCP][Hh + 8], bf16(x) [kPairRows][kCP + 8],
// z [kPairRows][Hh + 4] (then bf16(dz) over it, rows of 2 (Hh + 4)), dy
// [kPairRows][Hh] (then dxhat over it), the tile's x as read [kPairRows *
// kCP], gamma and beta of the columns [2][Hh], the half rows' sums of z and
// z^2, then of dxhat and dxhat xhat ([kPair][kPairRows][2] each, one block a
// rank), the partner's partial dx [kPairRows][kPairLdi], and db of the
// columns over each warp's rows [kBWarps][Hh].
struct PairLayout {
  int Hh, ws, xs, zs, dys, xraw, gb, stat, msum, inbox, dbs, total;
  __host__ __device__ explicit PairLayout(int H) : Hh(H / kPair) {
    ws = 0;
    xs = ws + kCP * (Hh + 8) / 2;
    zs = xs + kPairRows * (kCP + 8) / 2;
    dys = zs + kPairRows * (Hh + 4);
    xraw = dys + kPairRows * Hh;
    gb = xraw + kPairRows * kCP;
    stat = gb + 2 * Hh;
    msum = stat + kPair * kPairRows * 2;
    inbox = msum + kPair * kPairRows * 2;
    dbs = inbox + kPairRows * kPairLdi;
    total = dbs + kBWarps * Hh;
  }
};

// mean and 1 / sigma of row r from both halves' sums (rank 0's + rank 1's)
__device__ __forceinline__ void pair_ln_stats(const float* stat, int r, float inv_h, float eps,
                                              float& mu, float& rsig) {
  ln_stats(stat[2 * r] + stat[2 * (kPairRows + r)],
           stat[2 * r + 1] + stat[2 * (kPairRows + r) + 1], inv_h, eps, mu, rsig);
}

// Tiles of kPairRows rows, one cluster of kPair CTAs of kBThreads threads a
// tile: the clusters walk the tiles as one CTA would (tile i of cluster k: i
// = k, k + clusters, ..), both CTAs of a cluster the same ones, and CTA
// `rank` takes the columns [rank Hh, rank Hh + Hh) (Hh = H / 2). Thread
// (warp w, lane = 4 g + q). z: columns 16 w + 8 j + 2 q, + 1 of the half,
// rows 16 i + g, + 8. Row pass: rows w + 16 k, the half's columns 4 (lane +
// 32 i) .. + 3. dx: rows 16 (w % 4) + g, + 8, channels 16 (w / 4) + 8 j +
// 2 q, + 1 of the chunk (a partial sum over the half's units; CTA c / 32
// finishes channel c). dW: channels 16 (w % 4) + g, + 8 of the chunk, the
// half's columns 16 p + 8 j + 2 q, + 1 of the pairs p = w / 4 + 4 jj.
//   x (rows, C), dy (rows, H) (both 16-byte aligned), w (C, H), bias, gamma,
//   beta (H,) float32; dx (rows, C); part (clusters, C H + 3 H) the
//   cluster's partial [dW, db, dgamma, dbeta], each CTA its columns.
__global__ void __launch_bounds__(kBThreads, 1)
input_block_bwd_wide_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                            const float* __restrict__ w, const float* __restrict__ bias,
                            const float* __restrict__ gamma, const float* __restrict__ beta,
                            float* __restrict__ dx, float* __restrict__ part, int rows, int C,
                            int H, float eps) {
  using eegflow::smem_addr;
  using Bf = __nv_bfloat16;
  extern __shared__ __align__(16) float smem_f[];
  const PairLayout lay(H);
  const int Hh = lay.Hh, ldw = Hh + 8, ldx = kCP + 8, ldz = Hh + 4, ldzb = 2 * ldz;
  Bf* const ws = reinterpret_cast<Bf*>(smem_f + lay.ws);
  Bf* const xs = reinterpret_cast<Bf*>(smem_f + lay.xs);
  float* const zs = smem_f + lay.zs;
  const Bf* const dzs = reinterpret_cast<const Bf*>(zs);
  float* const dys = smem_f + lay.dys;
  float* const xraw = smem_f + lay.xraw;
  float* const gb = smem_f + lay.gb;
  float* const stat = smem_f + lay.stat;
  float* const msum = smem_f + lay.msum;
  float* const inbox = smem_f + lay.inbox;
  float* const dbs = smem_f + lay.dbs;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const uint32_t rank = eegflow::cluster_rank(), partner = rank ^ 1u;
  const int cl = blockIdx.x / kPair, ncl = gridDim.x / kPair;
  const int u0 = static_cast<int>(rank) * Hh;  // the CTA's first column
  const int tiles = (rows + kPairRows - 1) / kPairRows;
  const int nch = (C + kCP - 1) / kCP;
  const int hc = Hh / 4;  // float4 chunks of a half row
  const float inv_h = 1.0f / static_cast<float>(H);

  // bf16(W)'s channels c0 .. c0 + kCP and the CTA's columns into ws, rows past C zero
  auto stage_w = [&](int c0) {
    for (int i = tid; i < kCP * Hh; i += kBThreads) {
      const int c = i / Hh, u = i - c * Hh;
      ws[c * ldw + u] = __float2bfloat16_rn(
          c0 + c < C ? w[static_cast<size_t>(c0 + c) * H + u0 + u] : 0.f);
    }
  };
  // bf16(x)[r][c0 + c] of the tile into xs from src (its channel c0, rows
  // lds floats apart), rows past avail and channels past C zero
  auto stage_x = [&](const float* src, int lds, int c0, int avail) {
    const int cn = min(kCP, C - c0);
    for (int i = tid; i < kPairRows * kCP; i += kBThreads) {
      const int r = i / kCP, c = i - r * kCP;
      xs[r * ldx + c] = __float2bfloat16_rn(c < cn && r < avail ? src[r * lds + c] : 0.f);
    }
  };
  // For C <= kCP a tile's x rows (one contiguous span) into xraw by
  // cp.async, rows past `rows` zero-filled; one group a call (empty past the
  // last tile or for C > kCP), so each thread's groups alternate x, dy.
  auto fetch_x = [&](int tile) {
    if (nch == 1 && tile < tiles) {
      const int row0 = tile * kPairRows;
      const int nx = min(kPairRows, rows - row0) * C;  // floats of the tile's rows
      const float* const src = x + static_cast<size_t>(row0) * C;
      for (int c = tid; c < kPairRows * C / 4; c += kBThreads) {
        const int n = min(4, max(0, nx - 4 * c));
        eegflow::cp_async16_part(smem_addr(xraw + 4 * c), n > 0 ? src + 4 * c : x, 4 * n);
      }
    }
    eegflow::cp_async_commit();
  };
  // The warp's rows of a tile's dy (the CTA's columns) into dys, rows past
  // `rows` zero-filled: the warp reads those rows alone, so it refills them
  // as soon as it is done with them. One group a call (empty past the last tile).
  auto fetch_dy = [&](int tile) {
    if (tile < tiles) {
      const int row0 = tile * kPairRows;
      for (int i = lane; i < kPairRowWarp * hc; i += 32) {
        const int k = i / hc, col = (i - k * hc) * 4;
        const int r = warp + kBWarps * k;
        const bool valid = row0 + r < rows;
        eegflow::cp_async16(smem_addr(dys + r * Hh + col),
                            valid ? dy + static_cast<size_t>(row0 + r) * H + u0 + col : dy,
                            valid);
      }
    }
    eegflow::cp_async_commit();
  };

  for (int i = tid; i < Hh; i += kBThreads) {
    gb[i] = gamma[u0 + i];
    gb[Hh + i] = beta[u0 + i];
  }
  // dgamma and dbeta of the lane's columns over the warp's rows; db in dbs
  // (fewer registers live beside dW's)
  float cdg[kPairChunks][4], cdbt[kPairChunks][4];
#pragma unroll
  for (int i = 0; i < kPairChunks; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) cdg[i][e] = cdbt[i][e] = 0.f;
  for (int i = tid; i < kBWarps * Hh; i += kBThreads) dbs[i] = 0.f;
  float* const out = part + static_cast<size_t>(cl) * (C + 3) * H;
  eegflow::pair_sync();  // both CTAs run: each may write the other's shared memory

  // one pass over the cluster's tiles per channel chunk (one for C <= kCP):
  // dx's columns and dW's rows of channels c0 .. c0 + kCP
  for (int pass = 0; pass < nch; ++pass) {
    const int c0 = pass * kCP;
    const int cn = min(kCP, C - c0);
    float acc_w[4][2][4];  // dW of the warp's channels and pairs over the cluster's rows
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_w[jj][j][e] = 0.f;
    __syncthreads();  // the last pass's products are done with ws, xs and zs
    if (nch == 1) stage_w(0);  // bf16(W) resident for the cluster's tiles
    fetch_x(cl);
    fetch_dy(cl);
    EEGFLOW_INPUT_MARK(0);

    for (int tile = cl; tile < tiles; tile += ncl) {
      const int row0 = tile * kPairRows;
      const int tr = min(kPairRows, rows - row0);
      const int next = tile + ncl;
      eegflow::cp_async_wait<1>();
      __syncthreads();  // the tile's x landed; the last tile's products are done
      EEGFLOW_INPUT_MARK(1);

      // z = bf16(x) . bf16(W) + b of the CTA's columns, as kernel 9 forms it
      float acc[4][2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      if (nch == 1) {
        stage_x(xraw, C, 0, kPairRows);
        __syncthreads();  // xraw is free again
        fetch_x(next);
        if (warp < Hh / 16) z_pair_mma<4>(acc, xs, ldx, ws, ldw, warp, lane);
      } else {
        fetch_x(tiles);
        for (int ch = 0; ch < nch; ++ch) {
          if (ch > 0) __syncthreads();  // no thread reads ws or xs any more
          stage_w(ch * kCP);
          stage_x(x + static_cast<size_t>(row0) * C + ch * kCP, C, ch * kCP, tr);
          __syncthreads();
          if (warp < Hh / 16) z_pair_mma<4>(acc, xs, ldx, ws, ldw, warp, lane);
        }
      }
      if (warp < Hh / 16) z_pair_store<4>(acc, zs, ldz, bias + u0, warp, lane);
      __syncthreads();  // z whole
      EEGFLOW_INPUT_MARK(2);

      // The LayerNorm statistics: each half row's sums of z and z^2 into
      // both CTAs' stat[rank]; a row's are rank 0's + rank 1's in both.
#pragma unroll 1
      for (int k = 0; k < kPairRowWarp; ++k) {
        const int r = warp + kBWarps * k;
        const float* const zr = zs + r * ldz;
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int i = 0; i < kPairChunks; ++i) {
          const int ch = lane + 32 * i;
          if (ch >= hc) continue;
          const float4 z4 = *reinterpret_cast<const float4*>(zr + 4 * ch);
          const float zv[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s1 += zv[e];
            s2 += zv[e] * zv[e];
          }
        }
        s1 = eegflow::warp_sum(s1);
        s2 = eegflow::warp_sum(s2);
        if (lane == 0) {
          float* const at = stat + 2 * (static_cast<int>(rank) * kPairRows + r);
          eegflow::store_both(at, partner, s1);
          eegflow::store_both(at + 1, partner, s2);
        }
      }
      eegflow::pair_sync();  // both halves' sums of z landed
      EEGFLOW_INPUT_MARK(3);
      eegflow::cp_async_wait<1>();
      __syncwarp();  // the warp's rows of dy landed
      EEGFLOW_INPUT_MARK(4);

      // The LayerNorm and GELU backward's first half, one warp a row: dxhat
      // over dy, dgamma and dbeta summed per lane, and the half rows' sums of
      // dxhat and dxhat xhat into both CTAs' msum[rank]. Rows past `rows`
      // have dy = 0 (zero-filled), so all of it is 0 there.
      float gv[kPairChunks][4], bv[kPairChunks][4];
#pragma unroll
      for (int i = 0; i < kPairChunks; ++i) {
        const int ch = min(lane + 32 * i, hc - 1);
        const float4 g4 = *reinterpret_cast<const float4*>(gb + 4 * ch);
        const float4 b4 = *reinterpret_cast<const float4*>(gb + Hh + 4 * ch);
        gv[i][0] = g4.x, gv[i][1] = g4.y, gv[i][2] = g4.z, gv[i][3] = g4.w;
        bv[i][0] = b4.x, bv[i][1] = b4.y, bv[i][2] = b4.z, bv[i][3] = b4.w;
      }
#pragma unroll 1
      for (int k = 0; k < kPairRowWarp; ++k) {
        const int r = warp + kBWarps * k;
        float mu, rsig;
        pair_ln_stats(stat, r, inv_h, eps, mu, rsig);
        float m1 = 0.f, m2 = 0.f;
#pragma unroll
        for (int i = 0; i < kPairChunks; ++i) {
          const int ch = lane + 32 * i;
          if (ch >= hc) continue;
          const float4 z4 = *reinterpret_cast<const float4*>(zs + r * ldz + 4 * ch);
          const float4 d4 = *reinterpret_cast<const float4*>(dys + r * Hh + 4 * ch);
          const float zv[4] = {z4.x, z4.y, z4.z, z4.w}, dv[4] = {d4.x, d4.y, d4.z, d4.w};
          float o[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float xhat = (zv[e] - mu) * rsig;
            const float dln = dv[e] * gelu_grad_fast(xhat * gv[i][e] + bv[i][e]);
            if (pass == 0) {
              cdg[i][e] += dln * xhat;
              cdbt[i][e] += dln;
            }
            const float dxh = dln * gv[i][e];
            o[e] = dxh;
            m1 += dxh;
            m2 += dxh * xhat;
          }
          *reinterpret_cast<float4*>(dys + r * Hh + 4 * ch) = make_float4(o[0], o[1], o[2], o[3]);
        }
        m1 = eegflow::warp_sum(m1);
        m2 = eegflow::warp_sum(m2);
        if (lane == 0) {
          float* const at = msum + 2 * (static_cast<int>(rank) * kPairRows + r);
          eegflow::store_both(at, partner, m1);
          eegflow::store_both(at + 1, partner, m2);
        }
      }
      eegflow::pair_sync();  // both halves' sums of dxhat landed
      EEGFLOW_INPUT_MARK(5);

      // Its second half: dz = rsig (dxhat - mean(dxhat) - xhat mean(dxhat
      // xhat)), db summed per lane over the warp's rows and then added to its
      // row of dbs, bf16(dz) over the row's z. Then the warp refills its rows
      // of dy with the next tile's.
      float tdb[kPairChunks][4];
#pragma unroll
      for (int i = 0; i < kPairChunks; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) tdb[i][e] = 0.f;
#pragma unroll 1
      for (int k = 0; k < kPairRowWarp; ++k) {
        const int r = warp + kBWarps * k;
        float mu, rsig;
        pair_ln_stats(stat, r, inv_h, eps, mu, rsig);
        const float m1 = (msum[2 * r] + msum[2 * (kPairRows + r)]) * inv_h;
        const float m2 = (msum[2 * r + 1] + msum[2 * (kPairRows + r) + 1]) * inv_h;
        float zv[kPairChunks][4], dv[kPairChunks][4];
#pragma unroll
        for (int i = 0; i < kPairChunks; ++i) {
          const int ch = lane + 32 * i;
          float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f), d4 = z4;
          if (ch < hc) {
            z4 = *reinterpret_cast<const float4*>(zs + r * ldz + 4 * ch);
            d4 = *reinterpret_cast<const float4*>(dys + r * Hh + 4 * ch);
          }
          zv[i][0] = z4.x, zv[i][1] = z4.y, zv[i][2] = z4.z, zv[i][3] = z4.w;
          dv[i][0] = d4.x, dv[i][1] = d4.y, dv[i][2] = d4.z, dv[i][3] = d4.w;
        }
        __syncwarp();  // the row's z is read before bf16(dz) goes over it
#pragma unroll
        for (int i = 0; i < kPairChunks; ++i) {
          const int ch = lane + 32 * i;
          if (ch >= hc) continue;
          float dz[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float xhat = (zv[i][e] - mu) * rsig;
            dz[e] = rsig * (dv[i][e] - m1 - xhat * m2);
            tdb[i][e] += dz[e];
          }
          *reinterpret_cast<uint2*>(zs + r * ldz + 2 * ch) =
              make_uint2(eegflow::pack_bf16(dz[0], dz[1]), eegflow::pack_bf16(dz[2], dz[3]));
        }
      }
      if (pass == 0) {
#pragma unroll
        for (int i = 0; i < kPairChunks; ++i) {
          const int ch = lane + 32 * i;
          if (ch >= hc) continue;
          float4* const at = reinterpret_cast<float4*>(dbs + warp * Hh + 4 * ch);
          const float4 v = *at;
          *at = make_float4(v.x + tdb[i][0], v.y + tdb[i][1], v.z + tdb[i][2], v.w + tdb[i][3]);
        }
      }
      __syncwarp();  // the warp's dxhat is read before the next tile's dy goes over it
      fetch_dy(next);
      if (nch > 1) {  // the pass's channels of W and x for dx and dW
        stage_w(c0);
        stage_x(x + static_cast<size_t>(row0) * C + c0, C, c0, tr);
      }
      __syncthreads();  // bf16(dz) whole
      EEGFLOW_INPUT_MARK(6);

      // dx = bf16(dz) . bf16(W)^T over the half's units: a partial sum; the
      // CTA that finishes a channel block gets the other's through DSMEM
      const int mt = warp & 3, nb = 16 * (warp >> 2);
      const int owner = nb / kPairDx;
      float accx[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) accx[j][e] = 0.f;
      if (nb < cn) {
        for (int kk = 0; kk < Hh / 16; ++kk) {
          uint32_t af[4], r[4];
          eegflow::ldmatrix_x4(af, smem_addr(dzs + (16 * mt + (lane & 15)) * ldzb + kk * 16 +
                                             (lane >> 4) * 8));
          eegflow::ldmatrix_x4(r, smem_addr(ws + (nb + (lane & 7) + ((lane >> 4) << 3)) * ldw +
                                            kk * 16 + ((lane >> 3) & 1) * 8));
          eegflow::mma_bf16(accx[0], af, r[0], r[1]);
          eegflow::mma_bf16(accx[1], af, r[2], r[3]);
        }
        if (owner != static_cast<int>(rank)) {
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int rh = 0; rh < 2; ++rh) {
              const int row = 16 * mt + 8 * rh + gq, c = nb + 8 * j + 2 * q - kPairDx * owner;
              eegflow::st_cluster_v2_f32(
                  eegflow::map_rank(smem_addr(inbox), partner) +
                      4u * static_cast<uint32_t>(row * kPairLdi + c),
                  accx[j][2 * rh], accx[j][2 * rh + 1]);
            }
        }
      }
      eegflow::cluster_arrive();  // (release) the partial dx pushed

      // dW += bf16(x)^T . bf16(dz) over the tile's rows
      if (16 * mt < cn) {
#pragma unroll
        for (int kk = 0; kk < kPairRows / 16; ++kk) {
          uint32_t af[4];
          eegflow::ldmatrix_x4_trans(af, smem_addr(xs + (kk * 16 + (lane & 7) +
                                                         ((lane >> 4) << 3)) * ldx +
                                                   16 * mt + ((lane >> 3) & 1) * 8));
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int pr = (warp >> 2) + 4 * jj;
            if (pr >= Hh / 16) continue;
            uint32_t r[4];
            eegflow::ldmatrix_x4_trans(
                r, smem_addr(dzs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldzb +
                             pr * 16 + (lane >> 4) * 8));
            eegflow::mma_bf16(acc_w[jj][0], af, r[0], r[1]);
            eegflow::mma_bf16(acc_w[jj][1], af, r[2], r[3]);
          }
        }
      }
      EEGFLOW_INPUT_MARK(7);
      eegflow::cluster_wait();  // (acquire) the partner's partial dx landed

      // the CTA's channel blocks of dx: its partial + the partner's
      if (owner == static_cast<int>(rank) && nb < cn) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            const int row = 16 * mt + 8 * rh + gq;
            if (row >= tr) continue;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = nb + 8 * j + 2 * q + e;
              if (c < cn)
                dx[static_cast<size_t>(row0 + row) * C + c0 + c] =
                    accx[j][2 * rh + e] + inbox[row * kPairLdi + c - kPairDx * owner];
            }
          }
      }
      EEGFLOW_INPUT_MARK(8);
    }

    // the pass's rows of the cluster's partial dW, the CTA's columns
    {
      const int mt = warp & 3;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int pr = (warp >> 2) + 4 * jj;
        if (pr >= Hh / 16) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            const int c = 16 * mt + 8 * rh + gq;
            if (c < cn)
              *reinterpret_cast<float2*>(out + static_cast<size_t>(c0 + c) * H + u0 + pr * 16 +
                                         8 * j + 2 * q) =
                  make_float2(acc_w[jj][j][2 * rh], acc_w[jj][j][2 * rh + 1]);
          }
      }
    }
  }

  // db, dgamma, dbeta of the CTA's columns summed over the warps in order
  eegflow::cp_async_wait<0>();
  __syncthreads();  // no thread reads zs or dys any more
  float* const red = zs;  // [kBWarps][2][Hh] dgamma, dbeta, over zs and dys
#pragma unroll
  for (int i = 0; i < kPairChunks; ++i) {
    const int ch = lane + 32 * i;
    if (ch >= hc) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      red[(2 * warp) * Hh + 4 * ch + e] = cdg[i][e];
      red[(2 * warp + 1) * Hh + 4 * ch + e] = cdbt[i][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < 3 * Hh; i += kBThreads) {
    const int s = i / Hh, u = i - s * Hh;
    float v = 0.f;
    for (int wi = 0; wi < kBWarps; ++wi)
      v += s == 0 ? dbs[wi * Hh + u] : red[(2 * wi + s - 1) * Hh + u];
    out[static_cast<size_t>(C + s) * H + u0 + u] = v;
  }
}

size_t bwd_wide_smem_bytes(int H) { return static_cast<size_t>(PairLayout(H).total) * 4; }

bool bad_shape(int rows, int C, int H) {
  return rows <= 0 || C <= 0 || H <= 0 || H > kMaxH || H % 32 != 0;
}

// the bf16 backward's narrow class (one CTA a 64-row tile); the wide one beyond
bool narrow_class(int C, int H) { return C <= kCP && H <= kMaxHB; }

static_assert(kPair == eegflow::kWideCluster && kBThreads == eegflow::kWideThreads,
              "the wide class launches as eegflow::launch_pairs does");

}  // namespace

// Forward. x (rows, C), w (C, H), bias, gamma, beta (H,) float32 -> y (rows,
// H) float32, on `ctas` CTAs walking tiles of tile_rows rows (the caller's
// plan, eegflow_torch/nn/cuda_input.py fwd_plan: 64, or 32 for H > 256); x
// and y 16-byte aligned.
extern "C" int eegflow_input_block_fwd(const float* x, const float* w, const float* bias,
                                       const float* gamma, const float* beta, float* y,
                                       int ctas, int tile_rows, int rows, int C, int H,
                                       int bf16, cudaStream_t stream) {
  // a 64-row tile's warps cover H <= 256 (ZTileBf16, ZTileF32)
  if (bad_shape(rows, C, H) || ctas <= 0 || (tile_rows != 32 && tile_rows != 64) ||
      (tile_rows == 64 && H > 256) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (tile_rows == 64)
    err = bf16 ? launch_fwd<64, true>(x, w, bias, gamma, beta, y, ctas, rows, C, H, stream)
               : launch_fwd<64, false>(x, w, bias, gamma, beta, y, ctas, rows, C, H, stream);
  else
    err = bf16 ? launch_fwd<32, true>(x, w, bias, gamma, beta, y, ctas, rows, C, H, stream)
               : launch_fwd<32, false>(x, w, bias, gamma, beta, y, ctas, rows, C, H, stream);
  return static_cast<int>(err);
}

// Backward. x (rows, C), dy (rows, H) (both 16-byte aligned), w (C, H),
// bias, gamma, beta (H,) float32. Outputs dx (rows, C) and grads (C H + 3 H)
// = [dW (C, H), db, dgamma, dbeta] float32, on `ctas` CTAs walking tiles of
// tile_rows rows (the caller's plan, eegflow_torch/nn/cuda_input.py
// bwd_plan): bf16 C <= 64 and H <= 256 one CTA a 64-row tile, ctas <= the
// tiles; bf16 beyond either ctas / 2 clusters of two CTAs a 64-row tile,
// ctas / 2 <= the tiles; float32 32 rows, or 16 for H > 256, ctas <= the
// tiles. part float32 scratch, the partial rows [dW, db, dgamma, dbeta] of
// the CTAs (the clusters in the wide class), (C H + 3 H) floats each.
extern "C" int eegflow_input_block_bwd(const float* x, const float* dy, const float* w,
                                       const float* bias, const float* gamma,
                                       const float* beta, float* dx, float* grads, float* part,
                                       int ctas, int tile_rows, int rows, int C, int H,
                                       int bf16, cudaStream_t stream) {
  if (bad_shape(rows, C, H) || ctas <= 0 || tile_rows <= 0 ||
      reinterpret_cast<uintptr_t>(dy) % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (rows + tile_rows - 1) / tile_rows;
  int splits = ctas;  // partial rows
  cudaError_t err;
  if (bf16 && narrow_class(C, H)) {
    if (tile_rows != kTile || ctas > tiles) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = bwd_bf16_smem_bytes(H);
    err = eegflow::allow_dynamic_smem(input_block_bwd_bf16_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    input_block_bwd_bf16_kernel<<<ctas, kBThreads, smem, stream>>>(x, dy, w, bias, gamma, beta,
                                                                   dx, part, rows, C, H, 1e-5f);
    err = cudaGetLastError();
  } else if (bf16) {
    if (tile_rows != kPairRows || ctas % kPair != 0 || ctas / kPair > tiles)
      return static_cast<int>(cudaErrorInvalidValue);
    splits = ctas / kPair;
    err = eegflow::launch_pairs(input_block_bwd_wide_kernel, splits, bwd_wide_smem_bytes(H),
                                stream, x, dy, w, bias, gamma, beta, dx, part, rows, C, H,
                                1e-5f);
  } else if (ctas > tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if (tile_rows == 32 && H <= 256) {
    err = launch_bwd_f32<32>(x, dy, w, bias, gamma, beta, dx, part, ctas, rows, C, H, stream);
  } else if (tile_rows == 16 && H > 256) {
    err = launch_bwd_f32<16>(x, dy, w, bias, gamma, beta, dx, part, ctas, rows, C, H, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t count = (static_cast<size_t>(C) + 3) * H;
  eegflow::reduce_splits_kernel<<<static_cast<unsigned>((count + 255) / 256), 256, 0, stream>>>(
      part, grads, splits, count);
  return static_cast<int>(cudaGetLastError());
}

// The launch of the bf16 backward's row kernel for C and H, as
// eegflow_input_block_bwd makes it: plan = {class (0 narrow, 1 wide), CTAs a
// row tile (its cluster), rows a tile, dynamic shared memory a CTA in bytes,
// the CTAs (narrow) or clusters (wide) the card holds at once}, and the
// kernel's (mangled) name from the runtime.
extern "C" int eegflow_input_block_bwd_bf16_plan(int C, int H, int* plan, const char** name) {
  if (bad_shape(1, C, H)) return static_cast<int>(cudaErrorInvalidValue);
  const bool narrow = narrow_class(C, H);
  const size_t smem = narrow ? bwd_bf16_smem_bytes(H) : bwd_wide_smem_bytes(H);
  plan[0] = narrow ? 0 : 1;
  plan[1] = narrow ? 1 : kPair;
  plan[2] = narrow ? kTile : kPairRows;
  plan[3] = static_cast<int>(smem);
  plan[4] = 0;
  const void* kernel = narrow ? reinterpret_cast<const void*>(input_block_bwd_bf16_kernel)
                              : reinterpret_cast<const void*>(input_block_bwd_wide_kernel);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (narrow) {
    int per_sm = 0, dev = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBThreads, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    plan[4] = per_sm * sms;
  } else {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kPair;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kPair, 1, 1);
    cfg.blockDim = dim3(kBThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&plan[4], kernel, &cfg);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaFuncGetName(name, kernel));
}
