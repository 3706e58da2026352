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
// Forward (eegflow_lstm_rec_fwd), per step t (walked T-1..0 for the reverse
// direction, h written at its natural position), zero initial state:
//   z = gates[t] + h_prev . W_hh        (float32 products and sums)
//   i, f, o = 0.5 tanh(z/2) + 0.5;  g = tanh(z)
//   c = f c_prev + i g;  h = o tanh(c)
// writes h (B, T, H) and, in training mode (c_out given), c (B, T, H).
//
// Backward (eegflow_lstm_rec_bwd), from the forward's (gates, h, c), the
// upstream gradient g of h and W_hh. With h_prev[t], c_prev[t] the state
// before step t (t-1 forward, t+1 reverse, zero before the direction's first
// step), the activations are recomputed from z[t] = gates[t] + h_prev[t] .
// W_hh and the adjoint walks against the direction of time:
//   dh = g[t] + dh_carry;  do = dh tanh(c);  dc = dh o (1 - tanh^2 c) + dc_carry
//   dz = [dc g i(1-i), dc c_prev f(1-f), dc i (1-g^2), do o(1-o)]
//   dc_carry = dc f;  dh_carry = dz . W_hh^T            (float32)
// and writes dgates = dz (B, T, 4H).
//
// What bounds it on the card: both recurrences are serial in t and need all
// of W_hh every step; in float32 that is 1 MB at H=256, above the 227 KB of
// shared memory a block may hold, so it is read from L2 every step, as
// lstm_fwd.cu reads its bf16 weights (keeping the weights on chip is later
// work). The recomputation of z is not serial: h is known for every step.
//
// Design. Forward: as lstm_fwd.cu, one CTA per kRows batch rows, thread u
// owns hidden unit u and its four gate columns, c in registers, h_{t-1}
// double-buffered in shared memory as [k][row]. Backward, two stages:
// (1) z for all B*T rows as one tiled GEMM (gemm.cuh) written into dgates,
// with the forward's product order (k ascending, fmaf from 0, then + gates),
// so z is bitwise the forward's; (2) the serial chain, shaped like the
// forward, reads z, overwrites it with dz in place and carries dh through
// dz . W_hh^T (the wrapper passes W_hh^T so the reads are coalesced). The
// chain then does one product per step, as the forward does, instead of the
// reference's two. No atomics: a launch repeats bitwise.

#include "common.cuh"
#include "gemm.cuh"

namespace {

constexpr int kRows = 8;          // batch rows per CTA
constexpr int kMaxThreads = 512;  // H <= 512 (one thread per hidden unit)

__global__ void __launch_bounds__(kMaxThreads)
lstm_rec_fwd_kernel(const float* __restrict__ gates, const float* __restrict__ whh,
                    float* __restrict__ h_out, float* __restrict__ c_out, int B, int T,
                    int H, int reverse) {
  extern __shared__ float4 smem4[];
  float* const hbase = reinterpret_cast<float*>(smem4);  // [2][H][kRows]
  const int u = threadIdx.x;  // blockDim.x == H
  const int row0 = blockIdx.x * kRows;
  const size_t G = 4 * static_cast<size_t>(H);

  for (int i = u; i < H * kRows; i += blockDim.x) hbase[i] = 0.f;
  float c[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) c[r] = 0.f;
  __syncthreads();

  int p = 0;
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const float* h_prev = hbase + p * H * kRows;
    float* h_next = hbase + (p ^ 1) * H * kRows;

    float acc[4][kRows];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[g][r] = 0.f;
    }
    const float* wk = whh + u;
#pragma unroll 4
    for (int k = 0; k < H; ++k, wk += G) {
      const float wg[4] = {wk[0], wk[H], wk[2 * H], wk[3 * H]};
      const float4 ha = *reinterpret_cast<const float4*>(h_prev + k * kRows);
      const float4 hb = *reinterpret_cast<const float4*>(h_prev + k * kRows + 4);
      const float hv[kRows] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
#pragma unroll
      for (int g = 0; g < 4; ++g) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[g][r] = fmaf(hv[r], wg[g], acc[g][r]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      const size_t bt = static_cast<size_t>(row) * T + t;
      float zi = acc[0][r], zf = acc[1][r], zg = acc[2][r], zo = acc[3][r];
      if (row < B) {
        const float* gp = gates + bt * G + u;
        zi = gp[0] + zi;
        zf = gp[H] + zf;
        zg = gp[2 * H] + zg;
        zo = gp[3 * H] + zo;
      }
      const float ig = eegflow::sigmoid_tanh(zi);
      const float fg = eegflow::sigmoid_tanh(zf);
      const float gg = tanhf(zg);
      const float og = eegflow::sigmoid_tanh(zo);
      c[r] = fg * c[r] + ig * gg;
      const float h = og * tanhf(c[r]);
      h_next[u * kRows + r] = h;
      if (row < B) {
        h_out[bt * H + u] = h;
        if (c_out != nullptr) c_out[bt * H + u] = c[r];
      }
    }
    __syncthreads();
    p ^= 1;
  }
}

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

// Forward. gates (B, T, 4H) and whh (H, 4H) float32; h_out (B, T, H) float32;
// c_out (B, T, H) float32, or null in eval mode.
extern "C" int eegflow_lstm_rec_fwd(const float* gates, const float* whh, float* h_out,
                                    float* c_out, int B, int T, int H, int reverse,
                                    cudaStream_t stream) {
  if (bad_shape(B, T, H)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(H) * kRows * sizeof(float);
  cudaError_t err = eegflow::allow_dynamic_smem(lstm_rec_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  lstm_rec_fwd_kernel<<<(B + kRows - 1) / kRows, H, smem, stream>>>(gates, whh, h_out, c_out,
                                                                    B, T, H, reverse);
  return static_cast<int>(cudaGetLastError());
}

// Backward. gates (B, T, 4H), h, c, g (B, T, H) float32; whh (H, 4H) and
// whh_t (4H, H) float32. Output dgates (B, T, 4H) float32.
extern "C" int eegflow_lstm_rec_bwd(const float* gates, const float* h, const float* c,
                                    const float* g, const float* whh, const float* whh_t,
                                    float* dgates, int B, int T, int H, int reverse,
                                    cudaStream_t stream) {
  if (bad_shape(B, T, H)) return static_cast<int>(cudaErrorInvalidValue);
  const int G = 4 * H;
  using namespace lstm_rec_ops;
  cudaError_t err = eegflow::gemm(HPrevRowsA{h, T, H, reverse}, WhhB{whh, G},
                                  ZStore{gates, dgates, G}, B * T, G, H, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = 2 * static_cast<size_t>(G) * kRows * sizeof(float);
  err = eegflow::allow_dynamic_smem(lstm_rec_bwd_chain_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  lstm_rec_bwd_chain_kernel<<<(B + kRows - 1) / kRows, H, smem, stream>>>(c, g, whh_t, dgates,
                                                                          B, T, H, reverse);
  return static_cast<int>(cudaGetLastError());
}
