// A tiled float32 GEMM for the backward kernels' products, with split-K
// partial sums reduced in a fixed order (no atomics, so a step is bitwise
// repeatable run to run).
//
//   C[m][n] = sum_k A(m, k) * B(k, n)
//
// A and B are functors that load one element, already rounded to bf16 where
// the reference's product takes bf16 operands (the products of two bf16
// values are exact in float32; the sums are float32). Each operand says
// which of its indices is contiguous in memory (kMContiguous /
// kNContiguous) so the tile loads are coalesced. The output functor takes
// (split, m, n, value): a split-K product writes its partial sums to a
// (splits, M, N) scratch that reduce_splits_kernel then sums over the
// splits in order.
//
// Design: 64 x 64 tiles of C per CTA, 16-deep slices of k staged in shared
// memory, 256 threads each holding a 4 x 4 block of C in registers. FMA on
// CUDA cores; tensor cores (wgmma) are later work.
#pragma once

#include "common.cuh"

namespace eegflow {

constexpr int kGemmBM = 64;
constexpr int kGemmBN = 64;
constexpr int kGemmBK = 16;
constexpr int kGemmThreads = 256;

template <class LoadA, class LoadB, class Store>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(LoadA a, LoadB b, Store out, int M, int N, int K, int k_per_split) {
  __shared__ __align__(16) float As[kGemmBK][kGemmBM + 4];
  __shared__ __align__(16) float Bs[kGemmBK][kGemmBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kGemmBM;
  const int n0 = blockIdx.x * kGemmBN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kGemmBK) {
    for (int i = tid; i < kGemmBK * kGemmBM; i += kGemmThreads) {
      int kk, mm;
      if constexpr (LoadA::kMContiguous) {
        kk = i / kGemmBM;
        mm = i % kGemmBM;
      } else {
        mm = i / kGemmBK;
        kk = i % kGemmBK;
      }
      const int k = k0 + kk, m = m0 + mm;
      As[kk][mm] = (k < k_end && m < M) ? a(m, k) : 0.f;
    }
    for (int i = tid; i < kGemmBK * kGemmBN; i += kGemmThreads) {
      int kk, nn;
      if constexpr (LoadB::kNContiguous) {
        kk = i / kGemmBN;
        nn = i % kGemmBN;
      } else {
        nn = i / kGemmBK;
        kk = i % kGemmBK;
      }
      const int k = k0 + kk, n = n0 + nn;
      Bs[kk][nn] = (k < k_end && n < N) ? b(k, n) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGemmBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (m < M && n < N) out(blockIdx.z, m, n, acc[i][j]);
    }
  }
}

// out[i] = sum_{s < splits} part[s * count + i], summed in order of s;
// kAccumulate adds the sum to out[i] instead.
template <bool kAccumulate = false>
static __global__ void reduce_splits_kernel(const float* __restrict__ part,
                                            float* __restrict__ out, int splits,
                                            size_t count) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += part[s * count + i];
  out[i] = kAccumulate ? out[i] + v : v;
}

// Writes one split's partial sums of an (M, N) product.
struct PartialStore {
  float* part;
  int M, N;
  __device__ void operator()(int s, int m, int n, float v) const {
    part[(static_cast<size_t>(s) * M + m) * N + n] = v;
  }
};

// C = A . B over k in `splits` slices, then the slices summed in order into
// out (M, N), or added to it with `accumulate`. part holds splits * M * N
// floats.
template <class LoadA, class LoadB>
cudaError_t gemm_split_k(LoadA a, LoadB b, float* out, float* part, int M, int N, int K,
                         int splits, cudaStream_t stream, bool accumulate = false) {
  int per = (K + splits - 1) / splits;
  per = (per + kGemmBK - 1) / kGemmBK * kGemmBK;
  const dim3 grid((N + kGemmBN - 1) / kGemmBN, (M + kGemmBM - 1) / kGemmBM, splits);
  gemm_kernel<<<grid, kGemmThreads, 0, stream>>>(a, b, PartialStore{part, M, N}, M, N, K,
                                                  per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t count = static_cast<size_t>(M) * N;
  const unsigned blocks = static_cast<unsigned>((count + 255) / 256);
  if (accumulate)
    reduce_splits_kernel<true><<<blocks, 256, 0, stream>>>(part, out, splits, count);
  else
    reduce_splits_kernel<<<blocks, 256, 0, stream>>>(part, out, splits, count);
  return cudaGetLastError();
}

// C = A . B with an epilogue functor, no split of k.
template <class LoadA, class LoadB, class Store>
cudaError_t gemm(LoadA a, LoadB b, Store out, int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((N + kGemmBN - 1) / kGemmBN, (M + kGemmBM - 1) / kGemmBM, 1);
  gemm_kernel<<<grid, kGemmThreads, 0, stream>>>(a, b, out, M, N, K, K);
  return cudaGetLastError();
}

// Column sums of a row-major (rows, cols) float32 matrix in `splits` slices
// of rows, each slice summed in order, then the slices summed in order.
static __global__ void colsum_partial_kernel(const float* __restrict__ x,
                                             float* __restrict__ part, int rows, int cols,
                                             int rows_per_split) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cols) return;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(rows, r0 + rows_per_split);
  float v = 0.f;
  for (int r = r0; r < r1; ++r) v += x[static_cast<size_t>(r) * cols + j];
  part[static_cast<size_t>(blockIdx.y) * cols + j] = v;
}

inline cudaError_t colsum_split(const float* x, float* out, float* part, int rows, int cols,
                                int splits, cudaStream_t stream) {
  const int per = (rows + splits - 1) / splits;
  const dim3 grid((cols + 255) / 256, splits);
  colsum_partial_kernel<<<grid, 256, 0, stream>>>(x, part, rows, cols, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_splits_kernel<<<(cols + 255) / 256, 256, 0, stream>>>(part, out, splits,
                                                               static_cast<size_t>(cols));
  return cudaGetLastError();
}

}  // namespace eegflow
