// Helpers shared by the eegflow_torch kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace eegflow {

// A type as a value, to pick a template's element type at run time:
// f(Type<float>{}) or f(Type<__nv_bfloat16>{}), f reading typename
// decltype(tag)::type.
template <class T>
struct Type {
  using type = T;
};

// Round a float to bfloat16 (nearest even) and back: the bf16 matmul
// operands of the reference's precision policy, multiplied in float32.
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// sigmoid through the tanh identity, as the reference's Pallas kernels
// evaluate it (eegflow/nn/pallas_lstm.py _sigmoid). tanhf is the accurate
// libdevice tanh, not tanh.approx.
__device__ __forceinline__ float sigmoid_tanh(float z) {
  return 0.5f * tanhf(0.5f * z) + 0.5f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
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

// Raise the dynamic shared-memory cap of `kernel` when `bytes` exceeds the
// 48 KB default; returns the CUDA error of the attribute call.
template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace eegflow
