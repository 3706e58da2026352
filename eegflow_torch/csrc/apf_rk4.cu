// Kernel 11: batched fixed-step RK4 of the three-state APF system, one
// candidate rate vector per thread, and the differential evolution (DE)
// that fits the rates, whole generations in one launch.
//
// Replaces three loops the JAX package compiles into single XLA programs:
// rk4_solve's lax.scan over output intervals with its lax.fori_loop over
// RK4 substeps (eegflow/ode/integrate.py:41-68), the loss body of
// make_fit_loss over it (eegflow/fit/evolution.py:52-62), and _de_minimize's
// lax.while_loop over generations (eegflow/fit/evolution.py:83-134). Eager
// PyTorch runs the first two as one launch per serial step (~30 ops a step,
// ~8,000 steps a fit-loss evaluation) and the third as ~30 launches and a
// host synchronisation a generation; here a loss evaluation is one launch,
// and so is a chunk of up to G generations.
//
// What bounds it: the serial chain of RK4 steps. A thread's rates, its
// three scaled rate matrices, its 3 states and (gradient mode) its 3 x 6
// tangents live in registers; nothing but the observed series (read as a
// broadcast, every thread the same address) and the outputs touches memory.
// The time is steps x the dependent path of one step, whatever the
// population up to a warp an SM sub-partition (the DE mode puts a member
// warp on each SM: 3 at n = 90, 94 at n = 3,000), so it is latency bound. The step is written for that
// chain: the field max(y, 0) @ Q is linear in max(y, 0), so a stage point is
// y + max(y_k, 0) @ (c Q) with the step sizes folded into three matrices
// once a candidate (no product of the field by the step), and the RK4 sum
// is (p1 + 2 p2 + 2 p3 + p4) @ (h/6 Q), one matrix product in place of
// four: 21 dependent operations a step, 69 instructions. Each increment is
// summed at its own scale and added into y once, as the reference rounds.
// A substep count of 16 (the fit's) runs unrolled in the trajectory, loss
// and DE modes; any other, and the tangent mode, run the step in a loop. A
// point's loss (branch-free) is taken beside the next interval's steps.
//
// Modes:
//   trajectory: traj (n_points, B, 3), the initial point first;
//   fit loss: at each output point clip to [0, 1], renormalise and add the
//     squared error against obs (n_points, 3); loss[b] = sum / (3 n_points)
//     + reg_weight * sum(k^2);
//   fit loss and its gradient: forward tangents dy/dk through every RK4
//     stage, the clamp at 0 (slope 0 at 0), the clip and the
//     renormalisation give the exact gradient of that discrete loss;
//   DE (apf_de_grid_kernel): up to G generations of best1bin DE on random
//     numbers the host drew for them, stopping early when the population
//     converges: a cooperative grid of 32 members a CTA over any population
//     the card holds at once, the population double-buffered in global
//     memory (L2), one grid barrier a generation.
// The loss is written with rounding intrinsics, so every mode and the DE
// give the same bits for the same candidate. The plain twins
// (eegflow_torch/ode/cuda_ode.py, eegflow_torch/fit/evolution.py) keep the
// step's expression order; they differ from the loss modes by FMA
// contraction and the order of the field's 3-term sums, and the DE's twin
// (the generation loop on the loss mode) equals the DE mode bit for bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 64;    // loss and trajectory modes: candidates a CTA
constexpr int kGridMembers = 32;  // DE mode: members a CTA (one warp)
constexpr int kGridThreads = 64;  // and its service warp
constexpr int kRates = 6;
constexpr int kFastSubsteps = 16;  // the fit's substeps, compiled unrolled
// rate r moves mass from state src(r) to dst(r) (k_ap A->P, k_af A->F,
// k_pa P->A, k_pf P->F, k_fa F->A, k_fp F->P)
__device__ __forceinline__ constexpr int src(int r) { return r / 2; }
__device__ __forceinline__ constexpr int dst(int r) {
  return r == 0 ? 1 : r == 1 ? 2 : r == 2 ? 0 : r == 3 ? 2 : r == 4 ? 0 : 1;
}

struct StepSizes {
  float half, full, sixth;
};

// The rate matrix Q (q[src][dst]; the field is max(y, 0) @ Q) times half
// the step to the second and third stage points (h/2), to the fourth (h)
// and of the RK4 sum (h/6): the step multiplies pos2 = 2 max(y, 0), so each
// product is that of max(y, 0) and the whole scaled matrix, bit for bit
// (halving is exact above float32's subnormals).
struct Scaled {
  float h[3][3], f[3][3], s[3][3];
};

__device__ __forceinline__ Scaled scaled_rates(const float k[kRates], StepSizes st) {
  float q[3][3];
  q[0][0] = -__fadd_rn(k[0], k[1]); q[0][1] = k[0];                q[0][2] = k[1];
  q[1][0] = k[2];                   q[1][1] = -__fadd_rn(k[2], k[3]); q[1][2] = k[3];
  q[2][0] = k[4];                   q[2][1] = k[5];                q[2][2] = -__fadd_rn(k[4], k[5]);
  Scaled m;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      m.h[i][j] = __fmul_rn(0.5f * st.half, q[i][j]);
      m.f[i][j] = __fmul_rn(0.5f * st.full, q[i][j]);
      m.s[i][j] = __fmul_rn(0.5f * st.sixth, q[i][j]);
    }
  return m;
}

// 2 max(y, 0), exactly, as y + |y|: a FADD on the FMA pipe in place of an
// FMNMX on the ALU pipe (a DE generation ~9 % faster on the H100)
__device__ __forceinline__ float twice_pos(float y) { return __fadd_rn(y, fabsf(y)); }

// out = y + p @ c, component j as y_j + ((p_0 c_0j + p_1 c_1j) + p_2 c_2j):
// the increment is summed at its own scale and rounded into y once, as
// _rk4_step rounds y + c f (three FMAs into y would round at y's scale three
// times, ~10x the twin's distance to the reference over a fit's 8,192 steps)
__device__ __forceinline__ void add_field(const float y[3], const float p[3], const float c[3][3],
                                          float out[3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
    out[j] = __fadd_rn(y[j], __fmaf_rn(p[2], c[2][j],
                                       __fmaf_rn(p[1], c[1][j], __fmul_rn(p[0], c[0][j]))));
}

// Stage k's share of the tangents, all doubled as pos2 is: dpos2 = 2
// mask(y_k > 0) t_k is added to dP2 with weight w, and (when next) the next
// stage point's tangents are t + dpos2^T (c/2 Q) + (c/2) pos2 . dQ/dk, with
// c2 = c/2 Q and half_step = c/2.
__device__ __forceinline__ void stage_tangent(const float yk[3], const float pos2[3],
                                              const float tk[3][kRates], const float t[3][kRates],
                                              const float c2[3][3], float half_step, float w,
                                              float dP[3][kRates], float next[3][kRates],
                                              bool first, bool has_next) {
  float dpos[3][kRates];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int r = 0; r < kRates; ++r) {
      dpos[i][r] = yk[i] > 0.f ? __fadd_rn(tk[i][r], tk[i][r]) : 0.f;
      dP[i][r] = first ? dpos[i][r] : __fmaf_rn(w, dpos[i][r], dP[i][r]);
    }
  if (!has_next) return;
#pragma unroll
  for (int r = 0; r < kRates; ++r) {
    const float moved = __fmul_rn(half_step, pos2[src(r)]);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float v = __fmaf_rn(dpos[2][r], c2[2][j],
                          __fmaf_rn(dpos[1][r], c2[1][j], __fmaf_rn(dpos[0][r], c2[0][j], t[j][r])));
      if (j == dst(r)) v = __fadd_rn(v, moved);
      if (j == src(r)) v = __fsub_rn(v, moved);
      next[j][r] = v;
    }
  }
}

// One RK4 step of y (and of its tangents t = dy/dk when kTangent):
//   p_k = max(y_k, 0); y_2 = y + p_1 @ (h/2 Q); y_3 = y + p_2 @ (h/2 Q);
//   y_4 = y + p_3 @ (h Q); y' = y + (((p_1 + 2 p_2) + 2 p_3) + p_4) @ (h/6 Q),
// each p_k carried doubled against the halved matrices (Scaled).
template <bool kTangent>
__device__ __forceinline__ void rk4_step(float y[3], float t[3][kRates], const Scaled& m,
                                         StepSizes st) {
  float pos[3], P[3], ys[3];
  float dP[3][kRates], ts[3][kRates];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pos[i] = twice_pos(y[i]);
    P[i] = pos[i];
  }
  if (kTangent) stage_tangent(y, pos, t, t, m.h, 0.5f * st.half, 1.f, dP, ts, true, true);
  add_field(y, pos, m.h, ys);
#pragma unroll
  for (int stage = 2; stage <= 4; ++stage) {
    const float(&c)[3][3] = stage == 3 ? m.f : m.h;  // the step to the NEXT stage's point
    const float half_step = 0.5f * (stage == 3 ? st.full : st.half);
#pragma unroll
    for (int i = 0; i < 3; ++i) pos[i] = twice_pos(ys[i]);
    if (kTangent) {
      float tn[3][kRates];
      stage_tangent(ys, pos, ts, t, c, half_step, stage == 4 ? 1.f : 2.f, dP, tn, false,
                    stage < 4);
      if (stage < 4) {
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int r = 0; r < kRates; ++r) ts[j][r] = tn[j][r];
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
      P[i] = stage == 4 ? __fadd_rn(P[i], pos[i]) : __fmaf_rn(2.f, pos[i], P[i]);
    if (stage < 4) add_field(y, pos, c, ys);
  }
  if (kTangent) {
    // t' = t + dP2^T (h/12 Q) + h/12 P2 . dQ/dk
#pragma unroll
    for (int r = 0; r < kRates; ++r) {
      const float moved = __fmul_rn(0.5f * st.sixth, P[src(r)]);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float v = __fmaf_rn(dP[2][r], m.s[2][j],
                            __fmaf_rn(dP[1][r], m.s[1][j], __fmaf_rn(dP[0][r], m.s[0][j], t[j][r])));
        if (j == dst(r)) v = __fadd_rn(v, moved);
        if (j == src(r)) v = __fsub_rn(v, moved);
        t[j][r] = v;
      }
    }
  }
  add_field(y, P, m.s, ys);
#pragma unroll
  for (int j = 0; j < 3; ++j) y[j] = ys[j];
}

// The substeps of one output interval: kSub unrolled, or (kSub 0) a loop of
// ``substeps``.
template <int kSub, bool kTangent>
__device__ __forceinline__ void interval(float y[3], float t[3][kRates], const Scaled& m,
                                         StepSizes st, int substeps) {
  if (kSub > 0) {
#pragma unroll
    for (int s = 0; s < kSub; ++s) rk4_step<kTangent>(y, t, m, st);
  } else {
#pragma unroll 1
    for (int s = 0; s < substeps; ++s) rk4_step<kTangent>(y, t, m, st);
  }
}

// One output point's share of the fit loss: clip y to [0, 1], renormalise
// and add the squared error against o to acc; p and e for the tangents.
// Branch-free (the quotient by __fdividef, within 2 ulp), so the compiler
// can interleave it with the next interval's steps.
__device__ __forceinline__ float point_loss(float acc, const float y[3], const float o[3],
                                            float p[3], float e[3], float& s) {
  float c[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) c[j] = fminf(fmaxf(y[j], 0.f), 1.f);
  s = __fadd_rn(__fadd_rn(c[0], c[1]), c[2]);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    p[j] = __fdividef(c[j], s);
    e[j] = __fsub_rn(p[j], o[j]);
  }
  return __fadd_rn(acc, __fmaf_rn(e[2], e[2], __fmaf_rn(e[1], e[1], __fmul_rn(e[0], e[0]))));
}

// The fit loss of one candidate k from y0 against obs (n_points, 3), and
// its gradient into grad when kTangent. Every rounding is written out, so
// each kernel that inlines it gives the same bits. Without tangents a
// point's loss is taken at the top of the next interval, beside its steps
// (the same sum in the same order).
template <int kSub, bool kTangent>
__device__ float candidate_loss(const float k[kRates], const float* __restrict__ y0,
                                const float* __restrict__ obs, int n_points, int substeps,
                                StepSizes st, float reg_weight, float grad[kRates]) {
  float ksq = __fmul_rn(k[0], k[0]);
#pragma unroll
  for (int r = 1; r < kRates; ++r) ksq = __fmaf_rn(k[r], k[r], ksq);
  const Scaled m = scaled_rates(k, st);
  float y[3] = {y0[0], y0[1], y0[2]};
  float acc = 0.f, p[3], e[3], s;
  if (!kTangent) {
    float last[3] = {y[0], y[1], y[2]};
    for (int i = 1; i < n_points; ++i) {
      const float o[3] = {__ldg(obs + 3 * i - 3), __ldg(obs + 3 * i - 2), __ldg(obs + 3 * i - 1)};
      acc = point_loss(acc, last, o, p, e, s);
      interval<kSub, false>(y, nullptr, m, st, substeps);
#pragma unroll
      for (int j = 0; j < 3; ++j) last[j] = y[j];
    }
    const float* ol = obs + 3 * (n_points - 1);
    const float o[3] = {__ldg(ol), __ldg(ol + 1), __ldg(ol + 2)};
    acc = point_loss(acc, last, o, p, e, s);
  } else {
    float t[3][kRates];
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int r = 0; r < kRates; ++r) t[j][r] = 0.f;
    float g[kRates] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < n_points; ++i) {
      const float o[3] = {__ldg(obs + 3 * i), __ldg(obs + 3 * i + 1), __ldg(obs + 3 * i + 2)};
      if (i > 0) interval<kSub, true>(y, t, m, st, substeps);
      acc = point_loss(acc, y, o, p, e, s);
      const float w = (e[0] * p[0] + e[1] * p[1]) + e[2] * p[2];
      const float scale = 2.f / s;
      float d[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) d[j] = (y[j] > 0.f && y[j] < 1.f) ? e[j] - w : 0.f;
#pragma unroll
      for (int r = 0; r < kRates; ++r)
        g[r] += scale * ((d[0] * t[0][r] + d[1] * t[1][r]) + d[2] * t[2][r]);
    }
    const float count = static_cast<float>(3 * n_points);
#pragma unroll
    for (int r = 0; r < kRates; ++r) grad[r] = g[r] / count + (2.f * reg_weight) * k[r];
  }
  const float count = static_cast<float>(3 * n_points);
  return __fadd_rn(__fdiv_rn(acc, count), __fmul_rn(reg_weight, ksq));
}

// Modes 0 (trajectory), 1 (fit loss) and 2 (fit loss and gradient), one
// candidate a thread.
template <int kMode, int kSub>
__global__ void __launch_bounds__(kThreads)
apf_rk4_kernel(const float* __restrict__ y0, int y0_stride, const float* __restrict__ k,
               int batch, int n_points, int substeps, StepSizes st,
               float* __restrict__ traj, const float* __restrict__ obs, float reg_weight,
               float* __restrict__ loss, float* __restrict__ grad) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  float kk[kRates];
#pragma unroll
  for (int r = 0; r < kRates; ++r) kk[r] = k[b * kRates + r];
  const float* start = y0 + b * y0_stride;
  if (kMode == 0) {
    const Scaled m = scaled_rates(kk, st);
    float y[3] = {start[0], start[1], start[2]};
    float* out = traj + static_cast<size_t>(b) * 3;
    for (int i = 0; i < n_points; ++i, out += static_cast<size_t>(batch) * 3) {
      if (i > 0) interval<kSub, false>(y, nullptr, m, st, substeps);
      out[0] = y[0]; out[1] = y[1]; out[2] = y[2];
    }
    return;
  }
  float g[kRates];
  loss[b] = candidate_loss<kSub, kMode == 2>(kk, start, obs, n_points, substeps, st,
                                             reg_weight, g);
  if (kMode == 2) {
#pragma unroll
    for (int r = 0; r < kRates; ++r) grad[b * kRates + r] = g[r];
  }
}

// The DE mode's pieces. A member's two partners are the two least of its
// row of draws in the order (draw, index), which is the stable sort's: each
// lane scans its columns in increasing order and the lanes' pairs merge in
// any order, every index being distinct (the sentinels, draws of 2 past the
// row's end, never reach the top two of a row of n >= 3).
struct Least2 {
  float v1, v2;
  int i1, i2;
};

__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  return a < b || (a == b && ia < ib);
}

__device__ __forceinline__ Least2 merge_least2(const Least2& a, const Least2& b) {
  Least2 r;
  if (before(b.v1, b.i1, a.v1, a.i1)) {
    r.v1 = b.v1, r.i1 = b.i1;
    const bool b2 = before(b.v2, b.i2, a.v1, a.i1);
    r.v2 = b2 ? b.v2 : a.v1, r.i2 = b2 ? b.i2 : a.i1;
  } else {
    r.v1 = a.v1, r.i1 = a.i1;
    const bool b1 = before(b.v1, b.i1, a.v2, a.i2);
    r.v2 = b1 ? b.v1 : a.v2, r.i2 = b1 ? b.i1 : a.i2;
  }
  return r;
}

// Member i's partners from its row of n draws, read by the whole warp
// (coalesced), its own column skipped; every lane returns the pair. A lane
// loads kScanBatch columns before it compares any: the scan is bound by the
// loads' latency, not by their bytes.
constexpr int kScanBatch = 16;

__device__ __forceinline__ Least2 warp_partners(const float* __restrict__ row, int n, int i,
                                                int lane) {
  Least2 p{2.f, 2.f, INT_MAX, INT_MAX};
  for (int base = lane; base < n; base += 32 * kScanBatch) {
    float v[kScanBatch];
#pragma unroll
    for (int k = 0; k < kScanBatch; ++k) {
      const int j = base + 32 * k;
      v[k] = j < n ? __ldg(row + j) : 2.f;
    }
#pragma unroll
    for (int k = 0; k < kScanBatch; ++k) {
      const int j = base + 32 * k;
      if (j == i || j >= n) continue;
      if (v[k] < p.v1) {
        p.v2 = p.v1, p.i2 = p.i1;
        p.v1 = v[k], p.i1 = j;
      } else if (v[k] < p.v2) {
        p.v2 = v[k], p.i2 = j;
      }
    }
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    Least2 o;
    o.v1 = __shfl_xor_sync(0xffffffffu, p.v1, m);
    o.v2 = __shfl_xor_sync(0xffffffffu, p.v2, m);
    o.i1 = __shfl_xor_sync(0xffffffffu, p.i1, m);
    o.i2 = __shfl_xor_sync(0xffffffffu, p.i2, m);
    p = merge_least2(p, o);
  }
  return p;
}

// The best member, as de_best: the lowest index of the least loss, a NaN
// never less. A candidate (v, i) with i == INT_MAX is none; better() keeps the
// serial scan's answer whenever fit[0] is not NaN (the caller takes 0 when it
// is, as the scan does).
__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return i != INT_MAX && (j == INT_MAX || v < w || (v == w && i < j));
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, m);
    const int j = __shfl_xor_sync(0xffffffffu, i, m);
    if (better(w, j, v, i)) v = w, i = j;
  }
}

// de_converged in float64 in candidate order, bit for bit, every lane of the
// warp the same sum: the warp reads 32 losses at a time, coalesced, and adds
// them in order from the shuffles.
// Whole groups of 32 run unrolled, so only the float64 adds are serial.
__device__ bool warp_converged(const float* fit, int n, double tol, double atol, int lane) {
  const int whole = n & ~31;
  double sum = 0.0;
  for (int base = 0; base < whole; base += 32) {
    const float v = __ldcg(fit + base + lane);
#pragma unroll
    for (int k = 0; k < 32; ++k)
      sum = __dadd_rn(sum, static_cast<double>(__shfl_sync(0xffffffffu, v, k)));
  }
  {
    const float v = whole + lane < n ? __ldcg(fit + whole + lane) : 0.f;
    for (int k = 0; k < n - whole; ++k)
      sum = __dadd_rn(sum, static_cast<double>(__shfl_sync(0xffffffffu, v, k)));
  }
  const double mean = __ddiv_rn(sum, static_cast<double>(n));
  double ss = 0.0;
  for (int base = 0; base < whole; base += 32) {
    const float v = __ldcg(fit + base + lane);
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const double dv = __dsub_rn(static_cast<double>(__shfl_sync(0xffffffffu, v, k)), mean);
      ss = __dadd_rn(ss, __dmul_rn(dv, dv));
    }
  }
  {
    const float v = whole + lane < n ? __ldcg(fit + whole + lane) : 0.f;
    for (int k = 0; k < n - whole; ++k) {
      const double dv = __dsub_rn(static_cast<double>(__shfl_sync(0xffffffffu, v, k)), mean);
      ss = __dadd_rn(ss, __dmul_rn(dv, dv));
    }
  }
  const double sd = __dsqrt_rn(__ddiv_rn(ss, static_cast<double>(n)));
  return sd <= __dadd_rn(atol, __dmul_rn(tol, fabs(mean)));
}

// The DE mode: up to `gens` generations of best1bin DE over the population
// pop (n, 6) with losses fit (n), both updated in place. Generation g reads
// the host's draws: fdraw[g] (the dither), u[g] (n, n) (the partners),
// cr[g] (n, 6) (the crossover), jr[g] (n) (the guaranteed dimension).
// Each generation, in _de_minimize's order:
//   1. stop if std(fit) <= atol + tol |mean(fit)|, in float64 in candidate
//      order;
//   2. best = the lowest index of the least loss;
//   3. member i's partners are the two least of u[g][i][j], j != i, ties to
//      the lower index; its mutant clamp(best + F (pop[r1] - pop[r2]), lo,
//      hi) with F = u * 0.5 + 0.5, each operation rounded on its own;
//      crossover where cr < 0.7f or at jr;
//   4. the trial's loss through candidate_loss, the loss mode's function;
//   5. selection: the trial replaces the member where its loss is less,
//      once every mutant has read the population.
// status[0] = generations run, status[1] = 1 when the test stopped them.
//
// It runs over ceil(n / 32) CTAs launched cooperatively (all resident at
// once). Warp 0 of CTA c holds members 32c .. 32c + 31, each its own row and loss in
// registers; warp 1 is the CTA's service warp. The population is published
// double-buffered: buffer 0 is pop/fit, buffer 1 the scratch (pop1, fit1), and
// generation g reads buffer g % 2 and writes every member's row and loss,
// replaced or not, into the other. One grid barrier ends a generation. Off
// the members' path, during generation g:
//   * the service warp of CTA 0 runs de_converged on buffer g % 2 and writes
//     the answer to stop[g % 2]; the members run the generation meanwhile,
//     and after the barrier every CTA reads the flag: when set, generation g
//     did not happen (its writes went to the other buffer, and each member
//     keeps its registers' row);
//   * each service warp scans its members' partner rows of generation g + 1
//     (a warp a row, coalesced) into shared memory;
//   * each member warp leaves its CTA's best candidate of the new losses
//     (part_v, part_i, slot (g + 1) % 2), so the next generation's best
//     member is a reduction over ceil(n / 32) candidates, not n losses.
template <int kSub>
__global__ void __launch_bounds__(kGridThreads)
apf_de_grid_kernel(float* __restrict__ pop, float* __restrict__ fit, int n,
                   const float* __restrict__ lo, const float* __restrict__ hi,
                   const float* __restrict__ fdraw, const float* __restrict__ u,
                   const float* __restrict__ cr, const long long* __restrict__ jr, int gens,
                   double tol, double atol, const float* __restrict__ y0,
                   const float* __restrict__ obs, int n_points, int substeps, StepSizes st,
                   float reg_weight, int* __restrict__ status, float* __restrict__ work) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  const int ctas = gridDim.x;
  float* const pops[2] = {pop, work};
  float* const fits[2] = {fit, work + kRates * n};
  float* const part_v = work + (kRates + 1) * n;                          // (2, ctas)
  int* const part_i = reinterpret_cast<int*>(part_v + 2 * ctas);         // (2, ctas)
  int* const stop = part_i + 2 * ctas;                                    // (2)
  __shared__ int s_partners[2][kGridMembers][2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = blockIdx.x * kGridMembers;
  const int i = first + lane;
  const bool member = warp == 0 && i < n;

  // the prologue: each member's row and loss, its CTA's best candidate, the
  // partners of generation 0
  float own[kRates], own_fit = 0.f;
  if (warp == 0) {
    float v = 0.f;
    int vi = INT_MAX;
    if (member) {
#pragma unroll
      for (int d = 0; d < kRates; ++d) own[d] = pop[i * kRates + d];
      own_fit = fit[i];
      if (!isnan(own_fit)) v = own_fit, vi = i;
    }
    warp_best(v, vi);
    if (lane == 0) part_v[blockIdx.x] = v, part_i[blockIdx.x] = vi;
  } else {
    for (int r = 0; r < kGridMembers && first + r < n; ++r) {
      const Least2 p = warp_partners(u + static_cast<size_t>(first + r) * n, n, first + r, lane);
      if (lane == 0) s_partners[0][r][0] = p.i1, s_partners[0][r][1] = p.i2;
    }
  }
  grid.sync();

  int g = 0, stopped = 0;
  for (; g < gens; ++g) {
    const int cur = g & 1, nxt = cur ^ 1;
    float trial[kRates], trial_fit = 0.f;
    if (warp == 0) {
      // the best member of buffer cur
      float v = 0.f;
      int vi = INT_MAX;
      for (int c = lane; c < ctas; c += 32) {
        const float w = __ldcg(part_v + cur * ctas + c);
        const int j = __ldcg(part_i + cur * ctas + c);
        if (better(w, j, v, vi)) v = w, vi = j;
      }
      warp_best(v, vi);
      const int best = isnan(__ldcg(fits[cur])) ? 0 : vi;
      const float* const pc = pops[cur];
      if (member) {
        const int r1 = s_partners[cur][lane][0], r2 = s_partners[cur][lane][1];
        const float f_scale = __fadd_rn(__fmul_rn(__ldg(fdraw + g), 0.5f), 0.5f);
        const float* crow = cr + (static_cast<size_t>(g) * n + i) * kRates;
        const long long jrand = jr[static_cast<size_t>(g) * n + i];
#pragma unroll
        for (int d = 0; d < kRates; ++d) {
          const float diff = __fsub_rn(__ldcg(pc + r1 * kRates + d), __ldcg(pc + r2 * kRates + d));
          const float mutant =
              fminf(fmaxf(__fadd_rn(__ldcg(pc + best * kRates + d), __fmul_rn(f_scale, diff)),
                          __ldg(lo + d)),
                    __ldg(hi + d));
          const bool cross = __ldg(crow + d) < 0.7f || d == jrand;
          trial[d] = cross ? mutant : own[d];
        }
        trial_fit = candidate_loss<kSub, false>(trial, y0, obs, n_points, substeps, st,
                                                reg_weight, nullptr);
        // selection into buffer nxt, replaced or not
        if (!(trial_fit < own_fit)) {
#pragma unroll
          for (int d = 0; d < kRates; ++d) trial[d] = own[d];
          trial_fit = own_fit;
        }
#pragma unroll
        for (int d = 0; d < kRates; ++d) __stcg(pops[nxt] + i * kRates + d, trial[d]);
        __stcg(fits[nxt] + i, trial_fit);
      }
      float w = 0.f;
      int wi = INT_MAX;
      if (member && !isnan(trial_fit)) w = trial_fit, wi = i;
      warp_best(w, wi);
      if (lane == 0) {
        __stcg(part_v + nxt * ctas + blockIdx.x, w);
        __stcg(part_i + nxt * ctas + blockIdx.x, wi);
      }
    } else {
      if (blockIdx.x == 0) {
        const bool done = warp_converged(fits[cur], n, tol, atol, lane);
        if (lane == 0) __stcg(stop + cur, done ? 1 : 0);
      }
      if (g + 1 < gens) {
        for (int r = 0; r < kGridMembers && first + r < n; ++r) {
          const Least2 p = warp_partners(u + (static_cast<size_t>(g + 1) * n + first + r) * n,
                                         n, first + r, lane);
          if (lane == 0) s_partners[nxt][r][0] = p.i1, s_partners[nxt][r][1] = p.i2;
        }
      }
    }
    grid.sync();
    if (__ldcg(stop + cur)) {
      stopped = 1;
      break;
    }
    if (member) {
#pragma unroll
      for (int d = 0; d < kRates; ++d) own[d] = trial[d];
      own_fit = trial_fit;
    }
  }
  // every read of the buffers is behind the last barrier: pop and fit take the
  // members' rows
  if (member) {
#pragma unroll
    for (int d = 0; d < kRates; ++d) pop[i * kRates + d] = own[d];
    fit[i] = own_fit;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    status[0] = g;
    status[1] = stopped;
  }
}

template <int kSub>
void launch_modes(const float* y0, int y0_stride, const float* k, int batch, int n_points,
                  int substeps, StepSizes st, float* traj, const float* obs, float reg_weight,
                  float* loss, float* grad, cudaStream_t stream) {
  const dim3 grid((batch + kThreads - 1) / kThreads);
  if (traj != nullptr)
    apf_rk4_kernel<0, kSub><<<grid, kThreads, 0, stream>>>(
        y0, y0_stride, k, batch, n_points, substeps, st, traj, obs, reg_weight, loss, grad);
  else if (grad != nullptr)  // the tangents' step is ~470 instructions: never unrolled
    apf_rk4_kernel<2, 0><<<grid, kThreads, 0, stream>>>(
        y0, y0_stride, k, batch, n_points, substeps, st, traj, obs, reg_weight, loss, grad);
  else
    apf_rk4_kernel<1, kSub><<<grid, kThreads, 0, stream>>>(
        y0, y0_stride, k, batch, n_points, substeps, st, traj, obs, reg_weight, loss, grad);
}

// The DE mode's launch for n members: a CTA for each 32 members, each CTA the
// members' warp and the service warp.
struct DePlan {
  int ctas, threads;
};

DePlan de_plan(int n) { return {(n + kGridMembers - 1) / kGridMembers, kGridThreads}; }

// the scratch, in floats: pop1 (n, 6), fit1 (n), part_v and part_i (2, ctas)
// each, stop (2)
int de_scratch_floats(int n, const DePlan& plan) { return (kRates + 1) * n + 4 * plan.ctas + 2; }

template <int kSub>
const void* de_kernel() {
  return reinterpret_cast<const void*>(apf_de_grid_kernel<kSub>);
}

// CTAs the card holds at once
cudaError_t de_held(const void* kernel, int* held) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGridThreads, 0);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *held = per_sm * sms;
  return err;
}

template <int kSub>
int launch_de(float* pop, float* fit, int n, const float* lo, const float* hi,
              const float* fdraw, const float* u, const float* cr, const long long* jr,
              int gens, double tol, double atol, const float* y0, const float* obs,
              int n_points, int substeps, StepSizes st, float reg_weight, int* status,
              float* work, cudaStream_t stream) {
  if (n < 3) return static_cast<int>(cudaErrorInvalidValue);
  const DePlan plan = de_plan(n);
  const void* kernel = de_kernel<kSub>();
  int held = 0;
  cudaError_t err = de_held(kernel, &held);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (plan.ctas > held) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&pop, &fit, &n, &lo, &hi, &fdraw, &u, &cr, &jr, &gens, &tol, &atol, &y0,
                  &obs, &n_points, &substeps, &st, &reg_weight, &status, &work};
  err = cudaLaunchCooperativeKernel(kernel, dim3(plan.ctas), dim3(plan.threads), args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y0: (B, 3) with y0_stride 3, or one (3,) state for every candidate with
// y0_stride 0; k (B, 6). Trajectory mode when traj is given, else the fit
// loss into loss (B,), and its gradient into grad (B, 6) when grad is given.
extern "C" int eegflow_apf_rk4(const float* y0, int y0_stride, const float* k, int batch,
                               int n_points, int substeps, float half, float full, float sixth,
                               float* traj, const float* obs, float reg_weight, float* loss,
                               float* grad, cudaStream_t stream) {
  const StepSizes st{half, full, sixth};
  if (substeps == kFastSubsteps)
    launch_modes<kFastSubsteps>(y0, y0_stride, k, batch, n_points, substeps, st, traj, obs,
                                reg_weight, loss, grad, stream);
  else
    launch_modes<0>(y0, y0_stride, k, batch, n_points, substeps, st, traj, obs, reg_weight,
                    loss, grad, stream);
  return static_cast<int>(cudaGetLastError());
}

// The DE mode: pop (n, 6) and fit (n) in place, n >= 3; the draws of
// `gens` generations; y0 (3,), obs (n_points, 3); status (2,) int32; work
// the scratch eegflow_apf_de_plan sizes.
extern "C" int eegflow_apf_de(float* pop, float* fit, int n, const float* lo, const float* hi,
                              const float* fdraw, const float* u, const float* cr,
                              const long long* jr, int gens, double tol, double atol,
                              const float* y0, const float* obs, int n_points, int substeps,
                              float half, float full, float sixth, float reg_weight,
                              int* status, float* work, cudaStream_t stream) {
  const StepSizes st{half, full, sixth};
  if (substeps == kFastSubsteps)
    return launch_de<kFastSubsteps>(pop, fit, n, lo, hi, fdraw, u, cr, jr, gens, tol, atol, y0,
                                    obs, n_points, substeps, st, reg_weight, status, work,
                                    stream);
  return launch_de<0>(pop, fit, n, lo, hi, fdraw, u, cr, jr, gens, tol, atol, y0, obs, n_points,
                      substeps, st, reg_weight, status, work, stream);
}

// The DE mode's launch for n members at `substeps`: plan = (CTAs, threads a
// CTA, static shared memory a CTA, CTAs the card holds at once, the scratch
// eegflow_apf_de's work holds in floats), *name the kernel's. eegflow_apf_de
// refuses a population whose CTAs exceed what the card holds
// (cudaErrorCooperativeLaunchTooLarge).
extern "C" int eegflow_apf_de_plan(int n, int substeps, int* plan, const char** name) {
  if (n < 3) return static_cast<int>(cudaErrorInvalidValue);
  const DePlan p = de_plan(n);
  const void* kernel = substeps == kFastSubsteps ? de_kernel<kFastSubsteps>() : de_kernel<0>();
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = de_held(kernel, &plan[3]);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan[0] = p.ctas;
  plan[1] = p.threads;
  plan[2] = static_cast<int>(attr.sharedSizeBytes);
  plan[4] = de_scratch_floats(n, p);
  return static_cast<int>(cudaFuncGetName(name, kernel));
}
