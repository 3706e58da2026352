// The keep-bit plane of the in-kernel Philox dropout (kernel_dropout): the
// draw kernel the bf16 LSTM stack launches once per layer and pass.
//
// Replaces: the TPU's hardware bits of eegflow/nn/pallas_lstm.py
// _prng_block_masks, drawn inside the reference's kernels (no TPU kernel of
// its own). The port's first design drew the bits inside kernel 2's
// projection loader, kernel 3's dW_ih loader and its dx epilogue: every
// element's bits once per 128-column tile of 4H and per direction, 34 times
// a step. Here each element's bits are drawn once per layer and pass, and
// the two directions' kernels read them from the plane.
//
// plane p holds the bits of part p's n_p elements, bit i mod 32 of 32-bit
// word i / 32 (bit i mod 8 of byte i / 8) for element i of the part; bits
// past n_p are 0. Element i is element off_p + i of philox.cuh's counting
// (off_p = row_offset T d_p: a mesh rank's first row).
//
// What bounds it on the card: the integer work of the ALU pipe, at least 19
// three-way XORs and 4 compares for every 4 elements (the 19 products run
// beside them on the FMA pipe), against n / 8 bytes written (4 MiB for a
// 256-wide part at B = 512, T = 256: 1.3 us at 3.35 TB/s).
// Design: a thread makes one 32-bit word, 8 independent generator calls
// (9 when the part does not start at a block of four) unrolled so their
// multiplies interleave, the key's round schedule shared by the 8; a warp
// stores 128 contiguous bytes.

#include <stdint.h>

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

struct BitsPart {
  uint32_t* out;
  unsigned long long off;  // counter index of the part's first element
  long long n;             // elements
  long long words;         // ceil(n / 32)
  uint32_t stream;
};

__global__ void __launch_bounds__(kThreads)
philox_keep_bits_kernel(const uint32_t* __restrict__ key, BitsPart p0, BitsPart p1,
                        uint32_t thresh) {
  long long w = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool second = w >= p0.words;
  if (second) w -= p0.words;
  uint32_t* const out = second ? p1.out : p0.out;
  const unsigned long long off = second ? p1.off : p0.off;
  const long long n = second ? p1.n : p0.n;
  const uint32_t stream = second ? p1.stream : p0.stream;
  if (w >= (second ? p1.words : p0.words)) return;
  const uint32_t k0 = __ldg(key), k1 = __ldg(key + 1);
  const unsigned long long first = off + 32ull * static_cast<unsigned long long>(w);
  const unsigned long long q = first >> 2;
  const int s = static_cast<int>(first & 3);
  uint32_t nib[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) nib[c] = eegflow::keep_bits4(k0, k1, stream, q + c, thresh);
  uint64_t bits = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) bits |= static_cast<uint64_t>(nib[c]) << (4 * c);
  if (s != 0)
    bits |= static_cast<uint64_t>(eegflow::keep_bits4(k0, k1, stream, q + 8, thresh)) << 32;
  uint32_t word = static_cast<uint32_t>(bits >> s);
  const long long left = n - 32 * w;
  if (left < 32) word &= (1u << left) - 1u;
  out[w] = word;
}

}  // namespace

// The keep-bit planes bits_p (ceil(n_p / 32) uint32 words) of one or two
// parts of n_p elements: stream stream_p, element i at counter index off_p +
// i, under the key (k0, k1) (uint32 on the device), kept where the word <
// thresh. bits1 may be null when n1 == 0.
extern "C" int eegflow_philox_keep_bits(const uint32_t* key, int stream0, int stream1,
                                        long long off0, long long off1, long long n0,
                                        long long n1, uint32_t thresh, uint32_t* bits0,
                                        uint32_t* bits1, cudaStream_t stream) {
  if (key == nullptr || bits0 == nullptr || n0 <= 0 || n1 < 0 || (n1 > 0 && bits1 == nullptr) ||
      off0 < 0 || off1 < 0 || stream0 < 0 || stream1 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const BitsPart p0{bits0, static_cast<unsigned long long>(off0), n0, (n0 + 31) / 32,
                    static_cast<uint32_t>(stream0)};
  const BitsPart p1{bits1, static_cast<unsigned long long>(off1), n1, (n1 + 31) / 32,
                    static_cast<uint32_t>(stream1)};
  const long long words = p0.words + p1.words;
  philox_keep_bits_kernel<<<static_cast<unsigned>((words + kThreads - 1) / kThreads), kThreads,
                            0, stream>>>(key, p0, p1, thresh);
  return static_cast<int>(cudaGetLastError());
}
