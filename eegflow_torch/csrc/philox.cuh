// Philox4x32-10 keep bits for the input dropout of the bf16 LSTM kernels
// (kernels 2, 3 and 3b under kernel_dropout): the counter-based generator of
// Salmon et al., "Parallel Random Numbers: As Easy as 1, 2, 3" (SC'11,
// Random123), the one curand and PyTorch's CUDA generator use.
//
// Replaces the TPU's hardware bits of eegflow/nn/pallas_lstm.py
// _prng_block_masks, which key a block of masks by (seed, batch tile, seq
// chunk, part). The port's kernels walk other tiles (kernel 2's 128 x 128
// product tiles, the chains' 16 to 48 rows a cluster, both directions of the
// next layer reading the same part), so a bit here is a function of the
// element and never of the tile that reads it:
//   element i = ((b_global T + t) D + j) of a part's (B_global, T, D) tensor
//   reads word i & 3 of philox4x32_10(counter (q mod 2^32, q >> 32, stream, 0),
//   key (k0, k1)), q = i >> 2, and is kept where that word < thresh,
// thresh = min(floor(keep 2^32), 2^32 - 1) (the reference's _keep_threshold).
// eegflow_torch/nn/philox.py is the plain twin.
//
// philox_bits.cu draws these bits once per layer and pass into a transient
// packed plane, 1 bit an element (1/32 of the part's float32 bytes), which
// the kernels' loaders and dx epilogue read (mma_gemm.cuh MaskBits): a call
// is ten rounds of two 32 x 64-bit-result multiplies (one IMAD.WIDE each, on
// the FMA pipe) and two three-way XORs (one LOP3 each, on the ALU pipe),
// then 4 compares with the threshold (ALU) for four elements.

#pragma once

#include <stdint.h>

namespace eegflow {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

// Philox4x32 with ten rounds of counter c under key (k0, k1)
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t lo0 = kPhiloxM0 * c.x, hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo1 = kPhiloxM1 * c.z, hi1 = __umulhi(kPhiloxM1, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// the keep bits of the four elements 4q .. 4q + 3 of a stream, bit e for
// element 4q + e
__device__ __forceinline__ uint32_t keep_bits4(uint32_t k0, uint32_t k1, uint32_t stream,
                                               uint64_t q, uint32_t thresh) {
  const uint4 w = philox4x32_10(
      make_uint4(static_cast<uint32_t>(q), static_cast<uint32_t>(q >> 32), stream, 0u), k0, k1);
  return (w.x < thresh ? 1u : 0u) | (w.y < thresh ? 2u : 0u) | (w.z < thresh ? 4u : 0u) |
         (w.w < thresh ? 8u : 0u);
}

}  // namespace eegflow
