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
// samples x the dependent chain of its sections (4 dependent operations a
// sample once the sections pipeline: 0.97 ms for 61 x 60,000 on an H100);
// one warp issues the ~27 instructions of its 32 rows' sample (four
// sections) at one a clock, ~1.6 ms. The bytes (x read once, the forward
// pass written and read once, the output written once) are a few MB. The
// first design read every sample from global memory in the recursion's
// thread and waited on it: ~200 cycles a sample, 12 ms on an H100 80GB HBM3
// at 700 W; this one ~50 cycles, 3.0 ms (python -m
// eegflow_torch.kernels.ablate --calls filter), 1.2 ms of it without the
// recursion.
//
// Design: a CTA a group of 32 rows, staged group-major (G, T, 32) by the
// wrapper, so a chunk of a group's samples is one contiguous block. Warp 1
// is a producer: one lane streams the chunks the recursion reads (64
// samples x 32 rows, 8 KB) into a ring of 8 shared-memory stages with TMA
// bulk copies (cp.async.bulk, an mbarrier a stage), up to 8 chunks ahead:
// x's chunks in order for the forward pass, then the forward pass's chunks
// in reverse order for the reverse pass. Warp 0 runs the recursion, lane r
// row r of the group, reading each sample from the stage and writing its
// result into a ring of 4 output stages, which its lane 0 writes out by TMA
// bulk stores: the forward pass's middle (the T samples of x) to the
// scratch y_fwd, the reverse pass's to the output, whose trim they are. The
// 2 padlen extension samples of each pass run apart from the steady loop,
// from and to global memory: the forward pass's head and tail read x by
// the thread and keep their results in y_fwd, which the reverse pass reads
// back at its start and end. The reverse pass's chunks wait until the
// forward pass's bulk stores are complete; the tails of both passes run
// meanwhile.
//
// Roundings: the recursion's 1 Hz poles (|p| ~ 0.996) make float32 results
// sensitive to every rounding, so this takes the reference's expressions
// with the multiply-adds XLA's CPU compiler forms from them, written out as
// intrinsics nvcc does not re-associate:
//   y = fma(b0, v, z0);  z0 = fma(b1, v, -(a1 y)) + z1;  z1 = fma(b2, v, -(a2 y)).
// The plain twin (eegflow_torch/signal/filters.py) does the same.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;        // rows a CTA: one warp of recursion
constexpr int kChunk = 64;       // samples a stage
constexpr int kStages = 8;       // input stages in flight
constexpr int kOutStages = 4;    // output stages
constexpr int kThreads = 64;     // warp 0 the recursion, warp 1 the producer
constexpr int kStageBytes = kChunk * kRows * 4;

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

  // the outputs of the sections first (the sample's dependent chain), then
  // their delay lines, which the next sample needs
  __device__ __forceinline__ float step(float v) {
    float in[S], y[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      in[s] = s == 0 ? v : y[s - 1];
      y[s] = __fmaf_rn(b0[s], in[s], z0[s]);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      z0[s] = __fadd_rn(__fmaf_rn(b1[s], in[s], -__fmul_rn(a1[s], y[s])), z1[s]);
      z1[s] = __fmaf_rn(b2[s], in[s], -__fmul_rn(a2[s], y[s]));
    }
    return y[S - 1];
  }
};

// ---- mbarriers and TMA bulk copies --------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// bar: the shared::cta address of an 8-byte aligned uint64_t
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// the inits visible to the cluster and to the async proxy
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// an arrival that also expects `bytes` more of the phase's transactions
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// until the phase of `parity` has completed; a wait that outlasts `polls`
// tries (never, unless a pipeline is broken) traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity,
                                          uint32_t polls = 1u << 26) {
  uint32_t done;
  for (uint32_t i = 0;; ++i) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (i == polls) __trap();
  }
}

// `bytes` of global memory into a stage by the TMA unit; the stage's
// barrier completes its phase when they have landed
__device__ __forceinline__ void load_stage(uint32_t dst, const float* src, uint32_t bytes,
                                           uint32_t bar) {
  mbar_arrive_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// `bytes` of a stage to global memory by the TMA unit, in the thread's bulk
// group (the stage's writers have fenced them for the async proxy)
__device__ __forceinline__ void store_chunk(float* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most kPending of the thread's bulk stores still read shared memory
template <int kPending>
__device__ __forceinline__ void store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// One chunk of `len` samples of the steady loop: in and out hold a sample's
// 32 rows contiguous; the reverse pass walks the chunk backwards. The
// samples go in batches whose shared-memory loads issue together ahead of
// their recursion, so a load's latency is paid once a batch.
template <bool kBackwards, int S>
__device__ __forceinline__ void run_chunk(Cascade<S>& cascade, const float* __restrict__ in,
                                          float* __restrict__ out, int len, int lane) {
  constexpr int kBatch = 8;
  auto at = [&](int i) { return (kBackwards ? len - 1 - i : i) * kRows + lane; };
  int i = 0;
  for (; i + kBatch <= len; i += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) v[b] = in[at(i + b)];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) out[at(i + b)] = cascade.step(v[b]);
  }
  for (; i < len; ++i) out[at(i)] = cascade.step(in[at(i)]);
}

// x (G, t, 32), y_fwd (G, t + 2 padlen, 32), out (G, t, 32): group g's
// rows; the stages and barriers in dynamic shared memory.
template <int S>
__global__ void __launch_bounds__(kThreads)
sos_filtfilt_kernel(const float* __restrict__ x, const float* __restrict__ sos,
                    const float* __restrict__ zi, float* y_fwd, float* __restrict__ out, int t,
                    int padlen) {
  extern __shared__ __align__(128) uint8_t smem[];
  float* const in_ring = reinterpret_cast<float*>(smem);
  float* const out_ring = reinterpret_cast<float*>(smem + kStages * kStageBytes);
  uint64_t* const bars =
      reinterpret_cast<uint64_t*>(smem + (kStages + kOutStages) * kStageBytes);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + kStages);
  const uint32_t turn = smem_u32(bars + 2 * kStages);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = t + 2 * padlen;
  const int chunks = (t + kChunk - 1) / kChunk;
  const float* const xg = x + static_cast<size_t>(blockIdx.x) * t * kRows;
  float* const yg = y_fwd + static_cast<size_t>(blockIdx.x) * n * kRows;
  float* const og = out + static_cast<size_t>(blockIdx.x) * t * kRows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 1);
    }
    mbar_init(turn, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 1) {
    // the producer: chunk k < chunks is x's chunk k, then the forward pass's
    // chunks 2 chunks - 1 - k, once its bulk stores are complete
    if (lane == 0) {
      for (int k = 0; k < 2 * chunks; ++k) {
        const int stage = k % kStages;
        if (k >= kStages) mbar_wait(empty0 + 8 * stage, (k / kStages - 1) & 1);
        if (k == chunks) mbar_wait(turn, 0, 0xffffffffu);  // the whole forward pass
        const int c = k < chunks ? k : 2 * chunks - 1 - k;
        const int lo = c * kChunk, len = min(kChunk, t - lo);
        const float* src = k < chunks ? xg + static_cast<size_t>(lo) * kRows
                                      : yg + static_cast<size_t>(padlen + lo) * kRows;
        load_stage(smem_u32(in_ring) + stage * kStageBytes, src, len * kRows * 4,
                   full0 + 8 * stage);
      }
    }
    return;
  }

  Cascade<S> cascade;
  cascade.load(sos, zi);
  const float twice_first = __fmul_rn(2.f, xg[lane]);
  const float twice_last = __fmul_rn(2.f, xg[static_cast<size_t>(t - 1) * kRows + lane]);
  int k = 0, m = 0;  // input chunks read, output chunks written
  // the steady loop's chunk k into output stage m, stored to dst
  auto steady = [&](float* dst, bool backwards) {
    const int stage = k % kStages, ostage = m % kOutStages;
    const int c = k < chunks ? k : 2 * chunks - 1 - k;
    const int lo = c * kChunk, len = min(kChunk, t - lo);
    float* const ost = out_ring + ostage * kChunk * kRows;
    if (lane == 0 && m >= kOutStages) store_wait_read<kOutStages - 1>();
    __syncwarp();
    mbar_wait(full0 + 8 * stage, (k / kStages) & 1);
    if (backwards)
      run_chunk<true>(cascade, in_ring + stage * kChunk * kRows, ost, len, lane);
    else
      run_chunk<false>(cascade, in_ring + stage * kChunk * kRows, ost, len, lane);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(empty0 + 8 * stage);
      store_chunk(dst + static_cast<size_t>(lo) * kRows, smem_u32(ost), len * kRows * 4);
    }
    ++k, ++m;
  };

  // forward pass: the head of the odd extension, x, then its tail
  cascade.start(__fsub_rn(twice_first, xg[static_cast<size_t>(padlen) * kRows + lane]));
  for (int i = 0; i < padlen; ++i)
    yg[static_cast<size_t>(i) * kRows + lane] =
        cascade.step(__fsub_rn(twice_first, xg[static_cast<size_t>(padlen - i) * kRows + lane]));
  for (int c = 0; c < chunks; ++c) steady(yg + static_cast<size_t>(padlen) * kRows, false);
  if (lane == 0) {
    store_wait_all();
    mbar_arrive(turn);  // the forward pass's chunks are in y_fwd
  }
  float last = 0.f;
  for (int i = padlen + t; i < n; ++i) {
    last = cascade.step(
        __fsub_rn(twice_last, xg[static_cast<size_t>(2 * t + padlen - 2 - i) * kRows + lane]));
    yg[static_cast<size_t>(i) * kRows + lane] = last;
  }

  // reverse pass from the forward pass's last sample: its tail (trimmed),
  // the chunks into the output, its head (trimmed)
  cascade.start(last);
  for (int i = n - 1; i >= padlen + t; --i) cascade.step(yg[static_cast<size_t>(i) * kRows + lane]);
  for (int c = 0; c < chunks; ++c) steady(og, true);
  for (int i = padlen - 1; i >= 0; --i) cascade.step(yg[static_cast<size_t>(i) * kRows + lane]);
  if (lane == 0) store_wait_all();
}

template <int S>
cudaError_t launch(const float* x, const float* sos, const float* zi, float* y_fwd, float* out,
                   int groups, int t, int padlen, cudaStream_t stream) {
  const size_t smem = (kStages + kOutStages) * kStageBytes + (2 * kStages + 1) * 8;
  cudaError_t err = cudaFuncSetAttribute(
      sos_filtfilt_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  sos_filtfilt_kernel<S><<<groups, kThreads, smem, stream>>>(x, sos, zi, y_fwd, out, t, padlen);
  return cudaGetLastError();
}

}  // namespace

// x (G, T, 32) float32: the rows in groups of 32 (G = ceil(rows / 32), the
// last group padded), time-major in each group; sos (S, 6) float32 sections
// [b0 b1 b2 a0 a1 a2], zi (S, 2) their unit steady-state delay lines, y_fwd
// (G, T + 2 padlen, 32) scratch for the forward pass, out (G, T, 32);
// 1 <= sections <= 8, 0 < padlen < T.
extern "C" int eegflow_sos_filtfilt(const float* x, const float* sos, const float* zi,
                                    float* y_fwd, float* out, int rows, int t, int padlen,
                                    int sections, cudaStream_t stream) {
  if (rows <= 0 || padlen <= 0 || t <= padlen) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (rows + kRows - 1) / kRows;
  cudaError_t err;
  switch (sections) {
    case 1: err = launch<1>(x, sos, zi, y_fwd, out, groups, t, padlen, stream); break;
    case 2: err = launch<2>(x, sos, zi, y_fwd, out, groups, t, padlen, stream); break;
    case 3: err = launch<3>(x, sos, zi, y_fwd, out, groups, t, padlen, stream); break;
    case 4: err = launch<4>(x, sos, zi, y_fwd, out, groups, t, padlen, stream); break;
    case 5: err = launch<5>(x, sos, zi, y_fwd, out, groups, t, padlen, stream); break;
    case 6: err = launch<6>(x, sos, zi, y_fwd, out, groups, t, padlen, stream); break;
    case 7: err = launch<7>(x, sos, zi, y_fwd, out, groups, t, padlen, stream); break;
    case 8: err = launch<8>(x, sos, zi, y_fwd, out, groups, t, padlen, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
