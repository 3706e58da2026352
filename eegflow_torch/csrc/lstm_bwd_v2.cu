// Two-pass LSTM layer-direction backward for Hopper (sm_90a), from raw-gate
// residuals.
//
// Replaces: eegflow/nn/pallas_lstm.py _bwd_fused_kernel_v2 (entry
// lstm_bwd_fused under EEGFLOW_ADJOINT_RES=0, EEGFLOW_BWD_V2=1) with
// uint8-mask input dropout and the sibling direction's dx added in (dx_add):
// the "two_pass" schedule of the bf16 training step, 3 layers x 2 directions
// per micro-step.
//
// Inputs: the post-activation gates (B, T, 4H) [i, f, g, o] and the cell
// state c (B, T, H) that lstm_fwd.cu writes in raw-gate mode, h (B, T, H),
// the upstream gradient g (B, T, H), the input parts x_p (B, T, d_p) with
// their keep-masks, and the weights. The adjoint walks against the direction
// of time (t = T-1..0 forward, 0..T-1 reverse), tanh(c) recomputed and c_prev
// read from c at t-1 (t+1 reverse; zero before the direction's first step):
//   dh = g[t] + dh_carry;  do = dh tanh(c)
//   dc = dh o (1 - tanh^2 c) + dc_carry;  dc_carry = dc f
//   dz = [dc g i(1-i), dc c_prev f(1-f), dc i (1-g^2), do o(1-o)]   (float32)
//   dh_carry = bf16(dz) . bf16(W_hh)^T
// then, as kernel 3 (lstm_bwd.cu):
//   dx_p    = where(m_p, (bf16(dz) . bf16(W_ih_p)^T) / keep, 0) + dx_add_p
//   dW_ih_p = bf16(x_p)^T . bf16(dz)      dW_hh = bf16(h_prev)^T . bf16(dz)
//   db      = sum over (b, t) of dz (float32)
//
// What bounds it on the card: like kernel 3, a serial chain that reads all of
// W_hh (512 KB bf16 at H=256) from L2 every step at 8 batch rows per CTA
// (64 of 132 SMs at B=512), then 2 B T 4H (d0 + d1 + H) multiply-adds of
// products (0.2 TFLOP at B=512, T=256, H=256, two parts) on CUDA cores.
// Kernel 3 runs them one after the other and round-trips all of dz through
// device memory in float32 (512 MB at B=512, written once and read by every
// product).
//
// Design: the TPU kernel's two passes per time chunk, mapped to the card.
// The adjoint order is cut into chunks of t_chunk steps. (1) The chain kernel
// runs one chunk: the carries and the CTA's partial db live in a small
// global buffer between chunks (the CTA keeps them in registers within one),
// db sums the float32 dz in registers, and dz is written only as bf16 into
// a chunk buffer (B, t_chunk, 4H) that the wrapper sizes to 16 MB, so it
// stays in the 50 MB L2. (2) The chunk's products run as GEMMs of
// M = B t_chunk rows on gemm.cuh; the weight gradients add each chunk's
// split-K partial sums to their output in chunk order. A chunk's sums are
// cut into slices of ~512 rows (16 at B=512, t_chunk 16), so each product
// has ~1024 CTAs: with kernel 3's ~4096 rows a slice (2 slices, 128 CTAs) the
// products were latency-bound and a launch took 50.8 ms at B=512, T=256,
// H=256, two parts, against kernel 3's 36.2 ms (H100 80GB HBM3, 700 W,
// chip_smoke.py). The products of chunk k run on a second stream while the
// chain of chunk k+1 runs on the caller's stream (two chunk buffers, events
// between them), so the products fill the SMs the chain leaves idle. Every
// sum has a fixed order and there are no atomics: a launch repeats bit for
// bit. Tensor cores for the products are later work.
//
// Against kernel 3: dz never makes a float32 round trip through HBM (kernel
// 3 writes all of it, 512 MB at B=512, and every product reads it back), the
// products' M is B t_chunk rows instead of B T, they overlap the chain
// instead of following it, and the chain recomputes tanh(c) and reads c_prev
// where kernel 3 reads two more precomputed planes.

#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "gemm.cuh"

namespace {

constexpr int kRows = 8;          // batch rows per CTA of the chain
constexpr int kMaxThreads = 512;  // H <= 512 (one thread per hidden unit)

// One chunk of the adjoint chain: steps t in [t_lo, t_lo + t_len), walked
// downwards (forward direction) or upwards (reverse). carry (2, B, H) holds
// dh_carry and dc_carry between chunks, db_part (n_cta, 4H) each CTA's
// running db. dz16 (B, t_len, 4H) receives bf16(dz) of the chunk.
__global__ void __launch_bounds__(kMaxThreads)
lstm_bwd_v2_chain_kernel(const float* __restrict__ gates, const float* __restrict__ c,
                         const float* __restrict__ g,
                         const __nv_bfloat16* __restrict__ whh_t, float* __restrict__ carry,
                         float* __restrict__ db_part, __nv_bfloat16* __restrict__ dz16,
                         int B, int T, int H, int reverse, int t_lo, int t_len) {
  extern __shared__ float4 smem4[];
  float* const dzs = reinterpret_cast<float*>(smem4);  // [2][4H][kRows]
  const int G = 4 * H;
  const int u = threadIdx.x;  // blockDim.x == H
  const int row0 = blockIdx.x * kRows;
  float* const dh_g = carry;
  float* const dc_g = carry + static_cast<size_t>(B) * H;

  float dh_carry[kRows], dc_carry[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    dh_carry[r] = row < B ? dh_g[static_cast<size_t>(row) * H + u] : 0.f;
    dc_carry[r] = row < B ? dc_g[static_cast<size_t>(row) * H + u] : 0.f;
  }
  float* const dbp = db_part + static_cast<size_t>(blockIdx.x) * G + u;
  float db_i = dbp[0], db_f = dbp[H], db_g = dbp[2 * H], db_o = dbp[3 * H];

  int p = 0;
  for (int s = 0; s < t_len; ++s) {
    const int tl = reverse ? s : t_len - 1 - s;
    const int t = t_lo + tl;
    const int tp = reverse ? t + 1 : t - 1;
    float* buf = dzs + p * G * kRows;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      float zi = 0.f, zf = 0.f, zg = 0.f, zo = 0.f;
      if (row < B) {
        const size_t bt = static_cast<size_t>(row) * T + t;
        const float* gp = gates + bt * G + u;
        const float gi = gp[0], gf = gp[H], gg = gp[2 * H], go = gp[3 * H];
        const float tc = tanhf(c[bt * H + u]);
        const float c_prev =
            (tp >= 0 && tp < T) ? c[(static_cast<size_t>(row) * T + tp) * H + u] : 0.f;
        const float dh = g[bt * H + u] + dh_carry[r];
        const float d_o = dh * tc;
        const float dc = dh * go * (1.f - tc * tc) + dc_carry[r];
        dc_carry[r] = dc * gf;
        zi = dc * gg * gi * (1.f - gi);
        zf = dc * c_prev * gf * (1.f - gf);
        zg = dc * gi * (1.f - gg * gg);
        zo = d_o * go * (1.f - go);
        db_i += zi;
        db_f += zf;
        db_g += zg;
        db_o += zo;
        __nv_bfloat16* zp = dz16 + (static_cast<size_t>(row) * t_len + tl) * G + u;
        zp[0] = __float2bfloat16_rn(zi);
        zp[H] = __float2bfloat16_rn(zf);
        zp[2 * H] = __float2bfloat16_rn(zg);
        zp[3 * H] = __float2bfloat16_rn(zo);
      }
      buf[u * kRows + r] = eegflow::bf16_round(zi);
      buf[(H + u) * kRows + r] = eegflow::bf16_round(zf);
      buf[(2 * H + u) * kRows + r] = eegflow::bf16_round(zg);
      buf[(3 * H + u) * kRows + r] = eegflow::bf16_round(zo);
    }
    __syncthreads();

    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    const __nv_bfloat16* wj = whh_t + u;
#pragma unroll 4
    for (int j = 0; j < G; ++j, wj += H) {
      const float w = __bfloat162float(*wj);
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

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    if (row < B) {
      dh_g[static_cast<size_t>(row) * H + u] = dh_carry[r];
      dc_g[static_cast<size_t>(row) * H + u] = dc_carry[r];
    }
  }
  dbp[0] = db_i;
  dbp[H] = db_f;
  dbp[2 * H] = db_g;
  dbp[3 * H] = db_o;
}

}  // namespace

// Operand loaders and epilogue of one chunk's products (gemm.cuh). A chunk
// row m = b * t_len + tl stands for (b, t = t_lo + tl).
namespace lstm_bwd_v2_ops {

struct Chunk {
  int T, t_lo, t_len;
  // (b, t) row of the full sequence for chunk row m
  __device__ size_t bt(int m) const {
    const int b = m / t_len;
    return static_cast<size_t>(b) * T + t_lo + (m - b * t_len);
  }
};

// bf16(dz) as the A operand of dx = dz . W_ih_p^T: A(m = chunk row, k = gate col)
struct Dz16RowsA {
  static constexpr bool kMContiguous = false;
  const __nv_bfloat16* dz;
  int G;
  __device__ float operator()(int m, int k) const {
    return __bfloat162float(dz[static_cast<size_t>(m) * G + k]);
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

// dx epilogue: the part's dropout mask, then the sibling direction's dx
struct DxStore {
  float* dx;
  const uint8_t* m;
  const float* add;
  int D;
  float inv_keep;
  Chunk ch;
  __device__ void operator()(int, int row, int d, float v) const {
    const size_t i = ch.bt(row) * D + d;
    if (m != nullptr) v = m[i] != 0 ? v * inv_keep : 0.f;
    if (add != nullptr) v += add[i];
    dx[i] = v;
  }
};

// bf16(masked x_p) as the A operand of dW_ih_p = x_p^T . dz: A(m = feature, k = chunk row)
struct MaskedXA {
  static constexpr bool kMContiguous = true;
  const float* x;
  const uint8_t* m;
  int D;
  float inv_keep;
  Chunk ch;
  __device__ float operator()(int d, int row) const {
    const size_t i = ch.bt(row) * D + d;
    float v = x[i];
    if (m != nullptr) v = m[i] != 0 ? v * inv_keep : 0.f;
    return eegflow::bf16_round(v);
  }
};

// bf16(h_prev) as the A operand of dW_hh = h_prev^T . dz: A(m = unit, k = chunk row)
struct HPrevA {
  static constexpr bool kMContiguous = true;
  const float* h;
  int H, reverse;
  Chunk ch;
  __device__ float operator()(int u, int row) const {
    const int b = row / ch.t_len;
    const int tp = ch.t_lo + (row - b * ch.t_len) + (reverse ? 1 : -1);
    if (tp < 0 || tp >= ch.T) return 0.f;
    return eegflow::bf16_round(h[(static_cast<size_t>(b) * ch.T + tp) * H + u]);
  }
};

// bf16(dz) as the B operand of the weight gradients: B(k = chunk row, n = gate col)
struct Dz16B {
  static constexpr bool kNContiguous = true;
  const __nv_bfloat16* dz;
  int G;
  __device__ float operator()(int row, int n) const {
    return __bfloat162float(dz[static_cast<size_t>(row) * G + n]);
  }
};

}  // namespace lstm_bwd_v2_ops

using namespace lstm_bwd_v2_ops;

namespace {

struct Args {
  const float *h, *xs[2];
  const uint8_t* ms[2];
  const __nv_bfloat16* ws[2];
  const float* adds[2];
  float* dxs[2];
  int ds[2];
  float inv_keep;
  float *dw_ih, *dw_hh, *part;
  int splits, B, T, H, reverse;
};

// The products of one chunk: dx of its rows, the weight gradients added in
// (written by the first chunk), each split-K product's partials in order.
cudaError_t chunk_products(const Args& a, const __nv_bfloat16* dz, Chunk ch, bool first,
                           cudaStream_t stream) {
  const int G = 4 * a.H;
  const int rows = a.B * ch.t_len;
  size_t row_off = 0;
  cudaError_t err = cudaSuccess;
  for (int q = 0; q < (a.ds[1] > 0 ? 2 : 1); ++q) {
    err = eegflow::gemm(Dz16RowsA{dz, G}, WihT{a.ws[q], G},
                        DxStore{a.dxs[q], a.ms[q], a.adds[q], a.ds[q], a.inv_keep, ch}, rows,
                        a.ds[q], G, stream);
    if (err != cudaSuccess) return err;
    err = eegflow::gemm_split_k(MaskedXA{a.xs[q], a.ms[q], a.ds[q], a.inv_keep, ch},
                                Dz16B{dz, G}, a.dw_ih + row_off * G, a.part, a.ds[q], G,
                                rows, a.splits, stream, !first);
    if (err != cudaSuccess) return err;
    row_off += a.ds[q];
  }
  return eegflow::gemm_split_k(HPrevA{a.h, a.H, a.reverse, ch}, Dz16B{dz, G}, a.dw_hh,
                               a.part, a.H, G, rows, a.splits, stream, !first);
}

}  // namespace

// gates (B, T, 4H), c, h, g (B, T, H), x_p (B, T, d_p) float32; m_p (B, T,
// d_p) uint8 or null; w_p (d_p, 4H) and whh_t (4H, H) bf16; add_p (B, T,
// d_p) or null. Outputs dx_p (B, T, d_p), dw_ih (d0 + d1, 4H), dw_hh (H, 4H),
// db (4H) float32. Scratch: carry (2 B H) and db_part (ceil(B/8) 4H) float32,
// zero on entry; dz16 (2 B t_chunk 4H) bf16; part (splits * max(d0, d1, H) *
// 4H) float32. aux: the second stream the chunks' products run on.
// x1, m1, w1, add1 and dx1 may be null when d1 == 0.
extern "C" int eegflow_lstm_bwd_v2(const float* gates, const float* c, const float* h,
                                   const float* g, const float* x0, const float* x1,
                                   const uint8_t* m0, const uint8_t* m1, int d0, int d1,
                                   float inv_keep, const __nv_bfloat16* w0,
                                   const __nv_bfloat16* w1, const __nv_bfloat16* whh_t,
                                   const float* add0, const float* add1, float* dx0,
                                   float* dx1, float* dw_ih, float* dw_hh, float* db,
                                   float* carry, float* db_part, __nv_bfloat16* dz16,
                                   float* part, int splits, int t_chunk, int B, int T, int H,
                                   int reverse, cudaStream_t stream, cudaStream_t aux) {
  if (H <= 0 || H > kMaxThreads || H % 32 != 0 || B <= 0 || T <= 0 || d0 <= 0 ||
      d1 < 0 || splits <= 0 || t_chunk <= 0 || aux == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = 4 * H;
  const int n_cta = (B + kRows - 1) / kRows;
  const size_t smem = 2 * static_cast<size_t>(G) * kRows * sizeof(float);
  cudaError_t err = eegflow::allow_dynamic_smem(lstm_bwd_v2_chain_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{h, {x0, x1}, {m0, m1}, {w0, w1}, {add0, add1}, {dx0, dx1}, {d0, d1},
               inv_keep, dw_ih, dw_hh, part, splits, B, T, H, reverse};
  const int n_chunks = (T + t_chunk - 1) / t_chunk;
  const size_t buf_elems = static_cast<size_t>(B) * t_chunk * G;

  // events: start (aux waits for the caller's inputs), chain_done[slot],
  // prod_done[slot]; created per launch, released when they complete
  cudaEvent_t start = nullptr, chain_done[2] = {nullptr, nullptr},
              prod_done[2] = {nullptr, nullptr};
  cudaEvent_t* events[] = {&start, &chain_done[0], &chain_done[1], &prod_done[0],
                           &prod_done[1]};
  auto release = [&]() {
    for (cudaEvent_t* e : events)
      if (*e != nullptr) cudaEventDestroy(*e);
  };
  for (cudaEvent_t* e : events) {
    err = cudaEventCreateWithFlags(e, cudaEventDisableTiming);
    if (err != cudaSuccess) {
      release();
      return static_cast<int>(err);
    }
  }
  cudaEventRecord(start, stream);
  cudaStreamWaitEvent(aux, start, 0);
  for (int k = 0; k < n_chunks && err == cudaSuccess; ++k) {
    // chunks in the adjoint's order: from the end for the forward direction
    const int t_end = reverse ? std::min(T, (k + 1) * t_chunk) : T - k * t_chunk;
    const int t_lo = reverse ? k * t_chunk : std::max(0, T - (k + 1) * t_chunk);
    const int t_len = t_end - t_lo;
    const int slot = k & 1;
    __nv_bfloat16* buf = dz16 + slot * buf_elems;
    // the chunk buffer is free once the products of chunk k - 2 have read it
    if (k >= 2) cudaStreamWaitEvent(stream, prod_done[slot], 0);
    lstm_bwd_v2_chain_kernel<<<n_cta, H, smem, stream>>>(gates, c, g, whh_t, carry, db_part,
                                                         buf, B, T, H, reverse, t_lo, t_len);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
    cudaEventRecord(chain_done[slot], stream);
    cudaStreamWaitEvent(aux, chain_done[slot], 0);
    err = chunk_products(a, buf, Chunk{T, t_lo, t_len}, k == 0, aux);
    if (err == cudaSuccess) cudaEventRecord(prod_done[slot], aux);
  }
  if (err == cudaSuccess) {
    // db: the CTAs' partial sums, in CTA order
    eegflow::reduce_splits_kernel<<<(G + 255) / 256, 256, 0, stream>>>(
        db_part, db, n_cta, static_cast<size_t>(G));
    err = cudaGetLastError();
  }
  // the caller's stream sees every product before it goes on
  if (err == cudaSuccess) {
    cudaEventRecord(prod_done[0], aux);
    cudaStreamWaitEvent(stream, prod_done[0], 0);
  }
  release();
  return static_cast<int>(err);
}
