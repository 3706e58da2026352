// Kernel 12: scipy-filtfilt-parity zero-phase IIR as a cascade of
// second-order sections, one thread per signal row.
//
// Replaces _sos_scan and _filtfilt_core (eegflow/signal/filters.py:96-138):
// a lax.scan over every sample of the odd-extended recording, forward and
// then reversed, which eager PyTorch would run as ~40 small launches a
// sample (~120,000 serial steps for a 60,000-sample recording).
//
// Steps, as the reference: (1) odd extension by padlen = 3 max(len(a),
// len(b)); (2) the delay lines start at zi x the first extended sample;
// (3) forward pass; (4) reverse pass over its output, its delay lines at zi
// x that pass's first sample; (5) trim the padding.
//
// What bounds it: the serial recursion. Each sample waits on the delay
// lines of the sample before, so a row costs 2 passes x (T + 2 padlen)
// samples x the dependent chain of its sections; rows (EEG channels: 61)
// run in parallel on one or two warps, and the bytes (x read once, the
// forward pass written and read once, the output written once) are a few
// MB. The design keeps the 2 S delay-line states and the coefficients in
// registers and the chain free of memory waits: rows are staged time-major
// (T, R), so a warp's loads and stores are neighbouring floats, and the
// loads of the next chunk of samples are issued before the current chunk's
// recursion runs.
//
// Roundings: the recursion's 1 Hz poles (|p| ~ 0.996) make float32 results
// sensitive to every rounding, so this takes the reference's expressions
// with the multiply-adds XLA's CPU compiler forms from them, written out as
// intrinsics nvcc does not re-associate:
//   y = fma(b0, v, z0);  z0 = fma(b1, v, -(a1 y)) + z1;  z1 = fma(b2, v, -(a2 y)).
// The plain twin (eegflow_torch/signal/filters.py) does the same.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kChunk = 16;

template <int S>
struct Cascade {
  float b0[S], b1[S], b2[S], a1[S], a2[S], zi0[S], zi1[S];
  float z0[S], z1[S];

  __device__ __forceinline__ void load(const float* __restrict__ sos,
                                       const float* __restrict__ zi) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      b0[s] = sos[6 * s + 0]; b1[s] = sos[6 * s + 1]; b2[s] = sos[6 * s + 2];
      a1[s] = sos[6 * s + 4]; a2[s] = sos[6 * s + 5];
      zi0[s] = zi[2 * s]; zi1[s] = zi[2 * s + 1];
    }
  }

  __device__ __forceinline__ void start(float first) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      z0[s] = __fmul_rn(zi0[s], first);
      z1[s] = __fmul_rn(zi1[s], first);
    }
  }

  __device__ __forceinline__ float step(float v) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float y = __fmaf_rn(b0[s], v, z0[s]);
      z0[s] = __fadd_rn(__fmaf_rn(b1[s], v, -__fmul_rn(a1[s], y)), z1[s]);
      z1[s] = __fmaf_rn(b2[s], v, -__fmul_rn(a2[s], y));
      v = y;
    }
    return v;
  }
};

// sample i of the odd extension of row r of x (T, R)
__device__ __forceinline__ float extended(const float* __restrict__ x, int i, int r, int rows,
                                          int t, int padlen, float twice_first,
                                          float twice_last) {
  if (i < padlen) return __fsub_rn(twice_first, x[static_cast<size_t>(padlen - i) * rows + r]);
  if (i < padlen + t) return x[static_cast<size_t>(i - padlen) * rows + r];
  return __fsub_rn(twice_last, x[static_cast<size_t>(2 * t + padlen - 2 - i) * rows + r]);
}

template <int S>
__global__ void __launch_bounds__(kThreads)
sos_filtfilt_kernel(const float* __restrict__ x, const float* __restrict__ sos,
                    const float* __restrict__ zi, float* y_fwd, float* __restrict__ out,
                    int rows, int t, int padlen) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int n = t + 2 * padlen;
  Cascade<S> cascade;
  cascade.load(sos, zi);
  const float twice_first = __fmul_rn(2.f, x[r]);
  const float twice_last = __fmul_rn(2.f, x[static_cast<size_t>(t - 1) * rows + r]);

  // forward pass over the extension, into y_fwd (n, R)
  float cur[kChunk], nxt[kChunk];
#pragma unroll
  for (int j = 0; j < kChunk; ++j)
    cur[j] = j < n ? extended(x, j, r, rows, t, padlen, twice_first, twice_last) : 0.f;
  cascade.start(cur[0]);
  float last = 0.f;
  for (int base = 0; base < n; base += kChunk) {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int i = base + kChunk + j;
      nxt[j] = i < n ? extended(x, i, r, rows, t, padlen, twice_first, twice_last) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int i = base + j;
      if (i < n) {
        last = cascade.step(cur[j]);
        y_fwd[static_cast<size_t>(i) * rows + r] = last;
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) cur[j] = nxt[j];
  }

  // reverse pass: sample j is y_fwd[n - 1 - j]; keep the trimmed part
#pragma unroll
  for (int j = 0; j < kChunk; ++j)
    cur[j] = j < n ? y_fwd[static_cast<size_t>(n - 1 - j) * rows + r] : 0.f;
  cascade.start(last);
  for (int base = 0; base < n; base += kChunk) {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int i = base + kChunk + j;
      nxt[j] = i < n ? y_fwd[static_cast<size_t>(n - 1 - i) * rows + r] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int i = base + j;
      const int o = n - 1 - padlen - i;  // the output sample this step gives
      if (i < n) {
        const float v = cascade.step(cur[j]);
        if (o >= 0 && o < t) out[static_cast<size_t>(o) * rows + r] = v;
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) cur[j] = nxt[j];
  }
}

template <int S>
void launch(const float* x, const float* sos, const float* zi, float* y_fwd, float* out,
            int rows, int t, int padlen, cudaStream_t stream) {
  sos_filtfilt_kernel<S><<<(rows + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      x, sos, zi, y_fwd, out, rows, t, padlen);
}

}  // namespace

// x (T, R) time-major rows, sos (S, 6) float32 sections [b0 b1 b2 a0 a1 a2],
// zi (S, 2) their unit steady-state delay lines, y_fwd (T + 2 padlen, R)
// scratch for the forward pass, out (T, R); 1 <= sections <= 8.
extern "C" int eegflow_sos_filtfilt(const float* x, const float* sos, const float* zi,
                                    float* y_fwd, float* out, int rows, int t, int padlen,
                                    int sections, cudaStream_t stream) {
  switch (sections) {
    case 1: launch<1>(x, sos, zi, y_fwd, out, rows, t, padlen, stream); break;
    case 2: launch<2>(x, sos, zi, y_fwd, out, rows, t, padlen, stream); break;
    case 3: launch<3>(x, sos, zi, y_fwd, out, rows, t, padlen, stream); break;
    case 4: launch<4>(x, sos, zi, y_fwd, out, rows, t, padlen, stream); break;
    case 5: launch<5>(x, sos, zi, y_fwd, out, rows, t, padlen, stream); break;
    case 6: launch<6>(x, sos, zi, y_fwd, out, rows, t, padlen, stream); break;
    case 7: launch<7>(x, sos, zi, y_fwd, out, rows, t, padlen, stream); break;
    case 8: launch<8>(x, sos, zi, y_fwd, out, rows, t, padlen, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
