// Kernel 11: batched fixed-step RK4 of the three-state APF system, one
// candidate rate vector per thread.
//
// Replaces two loops the JAX package compiles into single XLA programs:
// rk4_solve's lax.scan over output intervals with its lax.fori_loop over
// RK4 substeps (eegflow/ode/integrate.py:41-68), and the loss body of
// make_fit_loss over it (eegflow/fit/evolution.py:52-62). Eager PyTorch runs
// those loops as one launch per serial step (~30 ops a step, ~8,000 steps a
// fit-loss evaluation); here a whole evaluation is one launch.
//
// What bounds it: the serial chain of RK4 steps. A thread's 6 rates, the
// 3 x 3 rate matrix, its 3 states and (gradient mode) its 3 x 6 tangents
// live in registers; nothing but the observed series (read as a broadcast,
// every thread the same address) and the outputs touches memory. The time
// is steps x the dependent-FMA path of one step, whatever the population
// (a DE population of 90 fills 2 warps of one SM each), so it is latency
// bound; the design keeps that chain free of memory traffic and of
// synchronisation.
//
// Modes (template kMode):
//   0 trajectory: traj (n_points, B, 3), the initial point first;
//   1 fit loss: at each output point clip to [0, 1], renormalise and add the
//     squared error against obs (n_points, 3); loss[b] = sum / (3 n_points)
//     + reg_weight * sum(k^2);
//   2 fit loss and its gradient: forward tangents dy/dk through every RK4
//     stage, the clamp at 0 (slope 0 at 0), the clip and the
//     renormalisation give the exact gradient of that discrete loss.
// The step keeps _rk4_step's expression order (integrate.py:32-37), so the
// plain twin (eegflow_torch/ode/cuda_ode.py) differs only by FMA
// contraction and the order of the field's 3-term sums.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

// The rate matrix Q, q[src][dst]; the field is max(y, 0) @ Q.
struct RateMatrix {
  float q[3][3];
};

__device__ __forceinline__ RateMatrix rate_matrix(const float k[6]) {
  RateMatrix m;
  m.q[0][0] = -(k[0] + k[1]); m.q[0][1] = k[0];            m.q[0][2] = k[1];
  m.q[1][0] = k[2];            m.q[1][1] = -(k[2] + k[3]); m.q[1][2] = k[3];
  m.q[2][0] = k[4];            m.q[2][1] = k[5];            m.q[2][2] = -(k[4] + k[5]);
  return m;
}

__device__ __forceinline__ void field(const float y[3], const RateMatrix& m, float f[3]) {
  const float a = fmaxf(y[0], 0.f), p = fmaxf(y[1], 0.f), z = fmaxf(y[2], 0.f);
#pragma unroll
  for (int j = 0; j < 3; ++j) f[j] = (a * m.q[0][j] + p * m.q[1][j]) + z * m.q[2][j];
}

// d(field)/dk at y with tangents t = dy/dk: Q^T (mask * t) + max(y, 0) . dQ/dk
__device__ __forceinline__ void field_tangent(const float y[3], const float t[3][6],
                                              const RateMatrix& m, float g[3][6]) {
  float pos[3], mask[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pos[i] = fmaxf(y[i], 0.f);
    mask[i] = y[i] > 0.f ? 1.f : 0.f;
  }
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    const float t0 = t[0][r] * mask[0], t1 = t[1][r] * mask[1], t2 = t[2][r] * mask[2];
#pragma unroll
    for (int j = 0; j < 3; ++j) g[j][r] = (m.q[0][j] * t0 + m.q[1][j] * t1) + m.q[2][j] * t2;
  }
  // dQ/dk: rate r moves mass from its source to its destination (k_ap A->P,
  // k_af A->F, k_pa P->A, k_pf P->F, k_fa F->A, k_fp F->P)
  g[1][0] += pos[0]; g[0][0] -= pos[0];
  g[2][1] += pos[0]; g[0][1] -= pos[0];
  g[0][2] += pos[1]; g[1][2] -= pos[1];
  g[2][3] += pos[1]; g[1][3] -= pos[1];
  g[0][4] += pos[2]; g[2][4] -= pos[2];
  g[1][5] += pos[2]; g[2][5] -= pos[2];
}

// One RK4 step of y (and of its tangents when kTangent), in _rk4_step's
// order: y + h/6 * (((f1 + 2 f2) + 2 f3) + f4).
template <bool kTangent>
__device__ __forceinline__ void rk4_step(float y[3], float t[3][6], const RateMatrix& m,
                                         float half, float full, float sixth) {
  float f[3], acc[3], ys[3];
  field(y, m, f);
#pragma unroll
  for (int j = 0; j < 3; ++j) { acc[j] = f[j]; ys[j] = y[j] + half * f[j]; }
  float g[3][6], tacc[3][6], ts[3][6];
  if (kTangent) {
    field_tangent(y, t, m, g);
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int r = 0; r < 6; ++r) { tacc[j][r] = g[j][r]; ts[j][r] = t[j][r] + half * g[j][r]; }
  }
  // stages 2 and 3 (weight 2), then 4 (weight 1)
#pragma unroll
  for (int stage = 2; stage <= 4; ++stage) {
    const float step = stage == 3 ? full : half;  // the step to the NEXT stage's point
    if (kTangent) field_tangent(ys, ts, m, g);
    field(ys, m, f);
    const float w = stage == 4 ? 1.f : 2.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      acc[j] = acc[j] + w * f[j];
      if (stage < 4) ys[j] = y[j] + step * f[j];
    }
    if (kTangent) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int r = 0; r < 6; ++r) {
          tacc[j][r] = tacc[j][r] + w * g[j][r];
          if (stage < 4) ts[j][r] = t[j][r] + step * g[j][r];
        }
    }
  }
  if (kTangent) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int r = 0; r < 6; ++r) t[j][r] = t[j][r] + sixth * tacc[j][r];
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) y[j] = y[j] + sixth * acc[j];
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
apf_rk4_kernel(const float* __restrict__ y0, int y0_stride, const float* __restrict__ k,
               int batch, int n_points, int substeps, float half, float full, float sixth,
               float* __restrict__ traj, const float* __restrict__ obs, float reg_weight,
               float* __restrict__ loss, float* __restrict__ grad) {
  constexpr bool kTangent = kMode == 2;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  float kk[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) kk[r] = k[b * 6 + r];
  const RateMatrix m = rate_matrix(kk);
  float y[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) y[j] = y0[b * y0_stride + j];
  float t[3][6];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int r = 0; r < 6; ++r) t[j][r] = 0.f;
  float acc = 0.f, g[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  for (int i = 0; i < n_points; ++i) {
    if (i > 0) {
      for (int s = 0; s < substeps; ++s) rk4_step<kTangent>(y, t, m, half, full, sixth);
    }
    if (kMode == 0) {
      float* out = traj + (static_cast<size_t>(i) * batch + b) * 3;
      out[0] = y[0]; out[1] = y[1]; out[2] = y[2];
    } else {
      float c[3], p[3], e[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) c[j] = fminf(fmaxf(y[j], 0.f), 1.f);
      const float s = (c[0] + c[1]) + c[2];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        p[j] = c[j] / s;
        e[j] = p[j] - __ldg(obs + 3 * i + j);
      }
      acc += (e[0] * e[0] + e[1] * e[1]) + e[2] * e[2];
      if (kTangent) {
        const float w = (e[0] * p[0] + e[1] * p[1]) + e[2] * p[2];
        const float scale = 2.f / s;
        float d[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) d[j] = (y[j] > 0.f && y[j] < 1.f) ? e[j] - w : 0.f;
#pragma unroll
        for (int r = 0; r < 6; ++r)
          g[r] += scale * ((d[0] * t[0][r] + d[1] * t[1][r]) + d[2] * t[2][r]);
      }
    }
  }
  if (kMode == 0) return;
  const float count = static_cast<float>(3 * n_points);
  float ksq = 0.f;
#pragma unroll
  for (int r = 0; r < 6; ++r) ksq += kk[r] * kk[r];
  loss[b] = acc / count + reg_weight * ksq;
  if (kTangent) {
#pragma unroll
    for (int r = 0; r < 6; ++r) grad[b * 6 + r] = g[r] / count + (2.f * reg_weight) * kk[r];
  }
}

}  // namespace

// y0: (B, 3) with y0_stride 3, or one (3,) state for every candidate with
// y0_stride 0; k (B, 6). Trajectory mode when traj is given, else the fit
// loss into loss (B,), and its gradient into grad (B, 6) when grad is given.
extern "C" int eegflow_apf_rk4(const float* y0, int y0_stride, const float* k, int batch,
                               int n_points, int substeps, float half, float full, float sixth,
                               float* traj, const float* obs, float reg_weight, float* loss,
                               float* grad, cudaStream_t stream) {
  const dim3 grid((batch + kThreads - 1) / kThreads);
  if (traj != nullptr) {
    apf_rk4_kernel<0><<<grid, kThreads, 0, stream>>>(y0, y0_stride, k, batch, n_points,
                                                     substeps, half, full, sixth, traj, obs,
                                                     reg_weight, loss, grad);
  } else if (grad != nullptr) {
    apf_rk4_kernel<2><<<grid, kThreads, 0, stream>>>(y0, y0_stride, k, batch, n_points,
                                                     substeps, half, full, sixth, traj, obs,
                                                     reg_weight, loss, grad);
  } else {
    apf_rk4_kernel<1><<<grid, kThreads, 0, stream>>>(y0, y0_stride, k, batch, n_points,
                                                     substeps, half, full, sixth, traj, obs,
                                                     reg_weight, loss, grad);
  }
  return static_cast<int>(cudaGetLastError());
}
