// A bf16 tensor-core GEMM for the LSTM kernels' big products (kernel 2's
// input projection, kernel 3's and 4's dx and weight gradients), the
// mma.sync / ldmatrix / cp.async primitives the recurrent kernels share, and
// tile_mma, the pool-head kernels' product of a resident tile against a
// streamed operand; and their float32 counterparts in 3xTF32 for the
// float32 pool-head backward (tile_mma_tf32x3, tf32x3_gemm_split_k).
//
//   C[m][n] = sum over the K segments s of sum_k A_s(m, k) B_s(k, n)
//
// with bf16 operands and float32 accumulation (mma.sync.m16n8k16). A and B
// are operand functors that fill 8-element chunks of a shared-memory tile
// along their contiguous dimension, in one of two ways. An operand that
// already is bf16 in memory (kAsync) copies them with cp.async. One that
// needs a mask, a 1/keep scale, a shift by one step or bf16 rounding of a
// float32 value (the operand rules of the reference's products) loads its
// float32 chunks into registers (load) before the CTA computes the current
// tile, and converts and stores them (store) after it, so those loads are in
// flight while the tensor cores work. Each operand says whether its
// contiguous dimension is K (kKMajor) or M / N; the tile is stored that way
// and read by ldmatrix, transposed where it is not K-major. A problem has one
// or two K segments (two input parts read through two pointers, never
// concatenated). The store functor takes (split, m, n, v(m, n), v(m, n + 1))
// for even n.
//
// Design: 128 x 128 tiles of C per CTA, 32-deep slices of K in a ring of 4
// shared-memory stages (three in flight while one is used, one barrier a
// slice); 8 warps of 64 x 32, each 4 x 4 mma tiles per 16 of K.
// Split-K writes per-split partial sums that common.cuh's reduce_splits_kernel
// adds in order of the split: no float atomics, so a result repeats bit for
// bit. wgmma and TMA are later work: mma.sync at half the card's bf16 rate
// already takes these products well below the serial chains.
//
// 3xTF32: a float32 operand a splits into hi = tf32(a) and lo = tf32(a - hi)
// (cvt.rna, round to nearest); a . b is then hi_a hi_b + hi_a lo_b +
// lo_a hi_b on mma.sync m16n8k8 with float32 accumulators: each product good
// to about 2^-21 relative (the dropped lo_a lo_b and lo's own rounding),
// against float32's 2^-24, where a single TF32 product keeps 2^-11. It costs
// three tensor-core products for one.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace eegflow {

// ---- PTX primitives ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lane i gives the address of row i % 8 of matrix i / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a . b for one 16 x 8 x 16 tile, bf16 operands, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the first n bytes (0 <= n <= 16, a multiple of 4) of 16 global -> shared,
// the rest zero-filled (src is read only for n > 0)
__device__ __forceinline__ void cp_async16_part(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

// 16 bytes global -> shared; zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  cp_async16_part(dst, src, valid ? 16 : 0);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint4 pack_bf16x8(const float (&v)[8]) {
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                    pack_bf16(v[6], v[7]));
}

// 8 consecutive floats at p (16-byte aligned)
__device__ __forceinline__ void load_f32x8(float (&v)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// ---- one tile's product against an operand streamed from global memory -----

constexpr int kTileSlice = 32;  // depth of a streamed slice

// acc[m-tile][n-tile][4] += A . B for this warp's 16-column pairs (pair =
// warp + kWarps p, p < kNP, pair < N / 16) in a CTA of kWarps warps: A a
// K-major bf16 tile of 16 kMT rows (lda elements apart) in shared memory
// holding the whole depth; B (depth x N bf16, rows ldg elements apart in
// global memory, 16-byte aligned) streamed through a ring of kStages
// kTileSlice-deep slices by cp.async, each stage [kTileSlice][N + 8]. depth
// is a multiple of kTileSlice, or with kTail of 16 (the last slice then may
// be 16 deep); N is a multiple of 16 and ldg of 8. Thread (warp, lane =
// 4 g + q) gets rows 16 i + g, + 8 and columns 16 pair + 8 (n % 2) + 2 q, + 1
// of m-tile i, n-tile n. The caller makes sure no thread still reads the
// ring, and waits for every warp's last reads of it before the ring is
// written again.
template <int kMT, int kNP, int kStages, int kWarps, bool kTail = false>
__device__ __forceinline__ void tile_mma(float (&acc)[kMT][2 * kNP][4], const __nv_bfloat16* As,
                                         int lda, const __nv_bfloat16* __restrict__ Bg, int ldg,
                                         int depth, int N, __nv_bfloat16* ring,
                                         int stage_elems) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ldb = N + 8;
  const int slices = kTail ? (depth + kTileSlice - 1) / kTileSlice : depth / kTileSlice;
  const int chunks_per_row = N / 8;
  auto issue = [&](int i) {
    __nv_bfloat16* st = ring + (i % kStages) * stage_elems;
    const int rows = kTail ? min(kTileSlice, depth - i * kTileSlice) : kTileSlice;
    for (int c = tid; c < rows * chunks_per_row; c += 32 * kWarps) {
      const int r = c / chunks_per_row, col = (c - r * chunks_per_row) * 8;
      cp_async16(smem_addr(st + r * ldb + col),
                 Bg + static_cast<size_t>(i * kTileSlice + r) * ldg + col, true);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < slices) issue(i);
    cp_async_commit();
  }
  for (int it = 0; it < slices; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice it has landed; slice it - 1's stage is free again
    if (it + kStages - 1 < slices) issue(it + kStages - 1);
    cp_async_commit();
    const __nv_bfloat16* bs = ring + (it % kStages) * stage_elems;
    auto step = [&](int kk) {  // 16 of the depth
      uint32_t af[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        ldmatrix_x4(af[i], smem_addr(As + (16 * i + (lane & 15)) * lda + it * kTileSlice +
                                     kk * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int p = 0; p < kNP; ++p) {
        const int pair = warp + kWarps * p;
        if (pair >= N / 16) continue;
        uint32_t r[4];
        ldmatrix_x4_trans(r, smem_addr(bs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldb +
                                       pair * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          mma_bf16(acc[i][2 * p], af[i], r[0], r[1]);
          mma_bf16(acc[i][2 * p + 1], af[i], r[2], r[3]);
        }
      }
    };
    if (!kTail || (it + 1) * kTileSlice <= depth) {
#pragma unroll
      for (int kk = 0; kk < kTileSlice / 16; ++kk) step(kk);
    } else {
      step(0);  // the last slice, 16 deep
    }
  }
  cp_async_wait<0>();
}

// ---- 3xTF32 -------------------------------------------------------------------

// v rounded to TF32 (nearest, ties away from zero), as a b32 operand: the
// bits of cvt.rna.tf32.f32 for every finite v, in two integer operations
// (the low 13 of the magnitude's bits rounded off; a carry moves into the
// exponent as rounding up should) instead of a conversion
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo to about 2^-22 relative: hi = tf32(v), lo = tf32(v - hi)
__device__ __forceinline__ void tf32_split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// d += a . b for one 16 x 8 x 8 tile, TF32 operands, float32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment (m16 x k8, row-major) of float32 values split for 3xTF32
struct Tf32A {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void split(const uint32_t (&r)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) tf32_split(__uint_as_float(r[e]), hi[e], lo[e]);
  }
};

// acc[m-tile][n-tile][4] += A . B in 3xTF32 for this warp's 16-column pairs
// (pair = warp + kWarps p, p < kNP, pair < N / 16) in a CTA of kWarps warps:
// A a float32 tile of 16 kMT rows (lda floats apart, lda % 32 == 4) in shared
// memory holding the whole depth; B given as its transpose BTg (N rows of
// `depth` float32 in global memory) and streamed through a ring of kStages
// kSlice-deep slices by cp.async, each stage [N][kSlice + 4]. depth is a
// multiple of kSlice, N of 16, both pointers 16-byte aligned. ldmatrix reads
// the 32-bit elements as pairs of b16: each 8 x 8 b16 matrix is 8 rows of 4
// floats, which is the m16n8k8 TF32 fragment layout for A (row-major) and for
// B's transpose. Thread (warp, lane = 4 g + q) gets rows 16 i + g, + 8 and
// columns 16 pair + 8 (n % 2) + 2 q, + 1 of m-tile i, n-tile n. Per k-step
// the three products go in passes (lo . hi, hi . lo, then hi . hi) over all
// the warp's tiles, so no two consecutive ones share an accumulator. The
// caller makes sure no thread still reads the ring.
template <int kMT, int kNP, int kSlice, int kStages, int kWarps>
__device__ __forceinline__ void tile_mma_tf32x3(float (&acc)[kMT][2 * kNP][4], const float* As,
                                                int lda, const float* __restrict__ BTg,
                                                int depth, int N, float* ring,
                                                int stage_elems) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int ldb = kSlice + 4;
  constexpr int kRowChunks = kSlice / 4;  // 16-byte chunks of a slice row
  const int slices = depth / kSlice;
  auto issue = [&](int i) {
    float* st = ring + (i % kStages) * stage_elems;
    for (int c = tid; c < N * kRowChunks; c += 32 * kWarps) {
      const int r = c / kRowChunks, col = (c - r * kRowChunks) * 4;
      cp_async16(smem_addr(st + r * ldb + col),
                 BTg + static_cast<size_t>(r) * depth + i * kSlice + col, true);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < slices) issue(i);
    cp_async_commit();
  }
  for (int it = 0; it < slices; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice it has landed; slice it - 1's stage is free again
    if (it + kStages - 1 < slices) issue(it + kStages - 1);
    cp_async_commit();
    const float* bs = ring + (it % kStages) * stage_elems;
#pragma unroll
    for (int kk = 0; kk < kSlice / 8; ++kk) {
      Tf32A a[kMT];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        uint32_t r[4];
        ldmatrix_x4(r, smem_addr(As + (16 * i + (lane & 7) + ((lane >> 3) & 1) * 8) * lda +
                                 it * kSlice + kk * 8 + (lane >> 4) * 4));
        a[i].split(r);
      }
#pragma unroll
      for (int p = 0; p < kNP; ++p) {
        const int pair = warp + kWarps * p;
        if (pair >= N / 16) continue;
        uint32_t r[4], bh[4], bl[4];
        ldmatrix_x4(r, smem_addr(bs + (pair * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldb +
                                 kk * 8 + ((lane >> 3) & 1) * 4));
#pragma unroll
        for (int e = 0; e < 4; ++e) tf32_split(__uint_as_float(r[e]), bh[e], bl[e]);
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          mma_tf32(acc[i][2 * p], a[i].lo, bh[0], bh[1]);
          mma_tf32(acc[i][2 * p + 1], a[i].lo, bh[2], bh[3]);
        }
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          mma_tf32(acc[i][2 * p], a[i].hi, bl[0], bl[1]);
          mma_tf32(acc[i][2 * p + 1], a[i].hi, bl[2], bl[3]);
        }
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          mma_tf32(acc[i][2 * p], a[i].hi, bh[0], bh[1]);
          mma_tf32(acc[i][2 * p + 1], a[i].hi, bh[2], bh[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// The split-K GEMM in 3xTF32 over float32 rows: part[split] (M, N) = the
// split's sum over k of A[k][m] B[k][n], A (K, M) and B (K, N) row-major
// (M and N multiples of 4, both 16-byte aligned). 128 x 128 tiles of C per
// CTA, 16-deep slices of k in a ring of 4 stages by cp.async, 8 warps of
// 64 x 32; the fragments are read from the k-major tiles with scalar loads
// (conflict-free at a row stride of 8 mod 32 floats) and split as they load.
// The kernel and its launcher are templates, so only a file that launches
// them compiles them.
constexpr int kT3BM = 128;
constexpr int kT3BN = 128;
constexpr int kT3BK = 16;
constexpr int kT3Stages = 4;
constexpr int kT3Threads = 256;
constexpr int kT3Lda = kT3BM + 8;
constexpr int kT3Ldb = kT3BN + 8;

template <int kBK>
__global__ void __launch_bounds__(kT3Threads, 2)
tf32x3_gemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ part, int M, int N, int K, int tiles_per_split) {
  extern __shared__ __align__(16) uint8_t t3_smem[];
  float* const As = reinterpret_cast<float*>(t3_smem);  // [stages][BK][BM + 8]
  float* const Bs = As + kT3Stages * kBK * kT3Lda;     // [stages][BK][BN + 8]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * kT3BM, n0 = blockIdx.x * kT3BN;
  const int tiles = (K + kBK - 1) / kBK;
  const int t_begin = blockIdx.z * tiles_per_split;
  const int n_tiles = min(tiles, t_begin + tiles_per_split) - t_begin;

  auto issue = [&](int i) {
    const int k0 = (t_begin + i) * kBK;
    float* const as = As + (i % kT3Stages) * kBK * kT3Lda;
    float* const bs = Bs + (i % kT3Stages) * kBK * kT3Ldb;
#pragma unroll
    for (int j = 0; j < kBK * kT3BM / 4 / kT3Threads; ++j) {
      const int c = tid + j * kT3Threads;
      const int r = c / (kT3BM / 4), col = (c % (kT3BM / 4)) * 4;
      const bool valid = k0 + r < K && m0 + col < M;
      cp_async16(smem_addr(as + r * kT3Lda + col),
                 valid ? A + static_cast<size_t>(k0 + r) * M + m0 + col : A, valid);
    }
#pragma unroll
    for (int j = 0; j < kBK * kT3BN / 4 / kT3Threads; ++j) {
      const int c = tid + j * kT3Threads;
      const int r = c / (kT3BN / 4), col = (c % (kT3BN / 4)) * 4;
      const bool valid = k0 + r < K && n0 + col < N;
      cp_async16(smem_addr(bs + r * kT3Ldb + col),
                 valid ? B + static_cast<size_t>(k0 + r) * N + n0 + col : B, valid);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int i = 0; i < kT3Stages - 1; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<kT3Stages - 2>();
    __syncthreads();  // tile kt has landed; tile kt - 1's stage is free again
    if (kt + kT3Stages - 1 < n_tiles) issue(kt + kT3Stages - 1);
    cp_async_commit();
    const float* const as = As + (kt % kT3Stages) * kBK * kT3Lda;
    const float* const bs = Bs + (kt % kT3Stages) * kBK * kT3Ldb;
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      const float* const ak = as + (kk * 8 + q) * kT3Lda + wm * 64 + g;
      const float* const bk = bs + (kk * 8 + q) * kT3Ldb + wn * 32 + g;
      Tf32A a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t r[4] = {__float_as_uint(ak[16 * i]), __float_as_uint(ak[16 * i + 8]),
                               __float_as_uint(ak[4 * kT3Lda + 16 * i]),
                               __float_as_uint(ak[4 * kT3Lda + 16 * i + 8])};
        a[i].split(r);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bh[2], bl[2];
        tf32_split(bk[8 * j], bh[0], bl[0]);
        tf32_split(bk[4 * kT3Ldb + 8 * j], bh[1], bl[1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_tf32(acc[i][j], a[i].lo, bh[0], bh[1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_tf32(acc[i][j], a[i].hi, bl[0], bl[1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_tf32(acc[i][j], a[i].hi, bh[0], bh[1]);
      }
    }
  }

  float* const out = part + static_cast<size_t>(blockIdx.z) * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + wm * 64 + 16 * i + g;
      const int n = n0 + wn * 32 + 8 * j + 2 * q;
      if (n >= N) continue;
      if (m < M)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(m) * N + n) =
            make_float2(acc[i][j][0], acc[i][j][1]);
      if (m + 8 < M)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(m + 8) * N + n) =
            make_float2(acc[i][j][2], acc[i][j][3]);
    }
}

// out (M, N) = A^T B over the K rows of A (K, M) and B (K, N), float32 in
// 3xTF32, in `splits` slices of whole 16-row tiles whose partial sums are
// then added in order of the slice. part holds splits * M * N floats.
template <int kBK = kT3BK>
cudaError_t tf32x3_gemm_split_k(const float* A, const float* B, float* out, float* part, int M,
                                int N, int K, int splits, cudaStream_t stream) {
  const int tiles = (K + kBK - 1) / kBK;
  const int per = (tiles + splits - 1) / splits;
  constexpr size_t smem = kT3Stages * kBK * (kT3Lda + kT3Ldb) * sizeof(float);
  cudaError_t err = allow_dynamic_smem(tf32x3_gemm_kernel<kBK>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kT3BN - 1) / kT3BN, (M + kT3BM - 1) / kT3BM, splits);
  tf32x3_gemm_kernel<kBK><<<grid, kT3Threads, smem, stream>>>(A, B, part, M, N, K, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t count = static_cast<size_t>(M) * N;
  reduce_splits_kernel<<<static_cast<unsigned>((count + 255) / 256), 256, 0, stream>>>(
      part, out, splits, count);
  return cudaGetLastError();
}

// ---- the GEMM ----------------------------------------------------------------

constexpr int kMmaBM = 128;
constexpr int kMmaBN = 128;
constexpr int kMmaBK = 32;
constexpr int kMmaThreads = 256;
constexpr int kMmaStages = 4;

// A shared-memory operand tile of kRows (M or N) by kMmaBK, bf16: [kRows][BK+8]
// when K-major, else [BK][kRows+8]; the padding keeps ldmatrix conflict-free.
template <bool kKMajor, int kRows>
struct MmaTile {
  static constexpr int kStride = kKMajor ? kMmaBK + 8 : kRows + 8;
  static constexpr int kElems = kKMajor ? kRows * kStride : kMmaBK * kStride;
  static constexpr int kChunks = kRows * kMmaBK / 8;
  // chunk c: its first element (r, k), 8 elements along the contiguous dim
  __device__ static void chunk(int c, int& r, int& k) {
    if (kKMajor) {
      r = c / (kMmaBK / 8);
      k = (c % (kMmaBK / 8)) * 8;
    } else {
      k = c / (kRows / 8);
      r = (c % (kRows / 8)) * 8;
    }
  }
  __device__ static int off(int r, int k) { return kKMajor ? r * kStride + k : k * kStride + r; }
};

// The chunks of one operand tile this thread copies: issue starts them
// (cp.async, or loads to registers), finish converts and stores the
// register-staged ones.
template <class Op, class Tile>
struct MmaStager {
  static constexpr int kPer = Tile::kChunks / kMmaThreads;
  typename Op::Raw raw[Op::kAsync ? 1 : kPer];
  __device__ __forceinline__ void issue(const Op& op, int seg, int r0, int kb, int tid,
                                        __nv_bfloat16* tile) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      int r, k;
      Tile::chunk(tid + i * kMmaThreads, r, k);
      if constexpr (Op::kAsync)
        op.fill(seg, r0 + r, kb + k, smem_addr(tile + Tile::off(r, k)));
      else
        raw[i] = op.load(seg, r0 + r, kb + k);
    }
  }
  __device__ __forceinline__ void finish(const Op& op, int tid, __nv_bfloat16* tile) {
    if constexpr (!Op::kAsync) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        int r, k;
        Tile::chunk(tid + i * kMmaThreads, r, k);
        op.store(raw[i], smem_addr(tile + Tile::off(r, k)));
      }
    }
  }
};

template <class LoadA, class LoadB>
constexpr size_t mma_gemm_smem() {
  return kMmaStages * (MmaTile<LoadA::kKMajor, kMmaBM>::kElems +
                       MmaTile<LoadB::kKMajor, kMmaBN>::kElems) *
         sizeof(__nv_bfloat16);
}

template <class LoadA, class LoadB, class Store>
__global__ void __launch_bounds__(kMmaThreads, 2)
mma_gemm_kernel(LoadA a, LoadB b, Store out, int M, int N, int k_seg0, int k_seg1,
                int tiles_per_split) {
  using TA = MmaTile<LoadA::kKMajor, kMmaBM>;
  using TB = MmaTile<LoadB::kKMajor, kMmaBN>;
  extern __shared__ __align__(16) uint8_t mma_smem[];
  __nv_bfloat16* const As = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* const Bs = As + kMmaStages * TA::kElems;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * kMmaBM, n0 = blockIdx.x * kMmaBN;
  const int tiles0 = (k_seg0 + kMmaBK - 1) / kMmaBK;
  const int tiles = tiles0 + (k_seg1 + kMmaBK - 1) / kMmaBK;
  const int t_begin = blockIdx.z * tiles_per_split;
  const int n_tiles = min(tiles, t_begin + tiles_per_split) - t_begin;

  MmaStager<LoadA, TA> sa;
  MmaStager<LoadB, TB> sb;
  // start the copies of the split's i-th tile into its stage: cp.async, or
  // loads to registers
  auto issue = [&](int i) {
    const int tile = t_begin + i;
    const int seg = tile < tiles0 ? 0 : 1;
    const int kb = (seg == 0 ? tile : tile - tiles0) * kMmaBK;
    const int stage = i % kMmaStages;
    sa.issue(a, seg, m0, kb, tid, As + stage * TA::kElems);
    sb.issue(b, seg, n0, kb, tid, Bs + stage * TB::kElems);
  };
  // convert and store what the register-staged operands loaded for tile i
  auto finish = [&](int i) {
    const int stage = i % kMmaStages;
    sa.finish(a, tid, As + stage * TA::kElems);
    sb.finish(b, tid, Bs + stage * TB::kElems);
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // a ring of kMmaStages tiles: kMmaStages - 1 in flight while one is used
#pragma unroll
  for (int i = 0; i < kMmaStages - 1; ++i) {
    if (i < n_tiles) {
      issue(i);
      finish(i);
    }
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();  // tile it has landed; tile it - 1's stage is free again
    const int next = it + kMmaStages - 1;
    if (next < n_tiles) issue(next);
    cp_async_commit();
    const __nv_bfloat16* const as = As + (it % kMmaStages) * TA::kElems;
    const __nv_bfloat16* const bs = Bs + (it % kMmaStages) * TB::kElems;
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int mb = wm * 64 + i * 16;
        if (LoadA::kKMajor)
          ldmatrix_x4(af[i],
                      smem_addr(as + TA::off(mb + (lane & 15), kk * 16 + (lane >> 4) * 8)));
        else
          ldmatrix_x4_trans(af[i], smem_addr(as + TA::off(mb + ((lane >> 3) & 1) * 8,
                                                          kk * 16 + (lane & 7) +
                                                              ((lane >> 4) << 3))));
      }
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        const int nb = wn * 32 + jp * 16;
        uint32_t r[4];
        if (LoadB::kKMajor)
          ldmatrix_x4(r, smem_addr(bs + TB::off(nb + (lane & 7) + ((lane >> 4) << 3),
                                                kk * 16 + ((lane >> 3) & 1) * 8)));
        else
          ldmatrix_x4_trans(r, smem_addr(bs + TB::off(nb + (lane >> 4) * 8,
                                                      kk * 16 + (lane & 7) +
                                                          ((lane >> 3) & 1) * 8)));
        bfr[2 * jp][0] = r[0];
        bfr[2 * jp][1] = r[1];
        bfr[2 * jp + 1][0] = r[2];
        bfr[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
    if (next < n_tiles) finish(next);
  }

  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + wm * 64 + i * 16 + g;
      const int n = n0 + wn * 32 + j * 8 + q * 2;
      out(blockIdx.z, m, n, acc[i][j][0], acc[i][j][1]);
      out(blockIdx.z, m + 8, n, acc[i][j][2], acc[i][j][3]);
    }
  }
}

// C = sum over the segments of A . B with an epilogue functor, no split of K.
template <class LoadA, class LoadB, class Store>
cudaError_t mma_gemm(LoadA a, LoadB b, Store out, int M, int N, int k_seg0, int k_seg1,
                     cudaStream_t stream) {
  const int tiles = (k_seg0 + kMmaBK - 1) / kMmaBK + (k_seg1 + kMmaBK - 1) / kMmaBK;
  constexpr size_t smem = mma_gemm_smem<LoadA, LoadB>();
  cudaError_t err = allow_dynamic_smem(mma_gemm_kernel<LoadA, LoadB, Store>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kMmaBN - 1) / kMmaBN, (M + kMmaBM - 1) / kMmaBM, 1);
  mma_gemm_kernel<<<grid, kMmaThreads, smem, stream>>>(a, b, out, M, N, k_seg0, k_seg1, tiles);
  return cudaGetLastError();
}

// Writes one split's partial sums of an (M, N) product, N even.
struct PartialStore2 {
  float* part;
  int M, N;
  __device__ void operator()(int s, int m, int n, float v0, float v1) const {
    if (m >= M || n >= N) return;
    *reinterpret_cast<float2*>(part + (static_cast<size_t>(s) * M + m) * N + n) =
        make_float2(v0, v1);
  }
};

// C = A . B over K in `splits` slices of whole 32-row tiles, the slices'
// partial sums then added in order of the slice into out (M, N), N even.
// part holds splits * M * N floats.
template <class LoadA, class LoadB>
cudaError_t mma_gemm_split_k(LoadA a, LoadB b, float* out, float* part, int M, int N, int K,
                             int splits, cudaStream_t stream) {
  const int tiles = (K + kMmaBK - 1) / kMmaBK;
  const int per = (tiles + splits - 1) / splits;
  constexpr size_t smem = mma_gemm_smem<LoadA, LoadB>();
  cudaError_t err = allow_dynamic_smem(mma_gemm_kernel<LoadA, LoadB, PartialStore2>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kMmaBN - 1) / kMmaBN, (M + kMmaBM - 1) / kMmaBM, splits);
  mma_gemm_kernel<<<grid, kMmaThreads, smem, stream>>>(a, b, PartialStore2{part, M, N}, M, N, K,
                                                       0, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t count = static_cast<size_t>(M) * N;
  reduce_splits_kernel<<<static_cast<unsigned>((count + 255) / 256), 256, 0, stream>>>(
      part, out, splits, count);
  return cudaGetLastError();
}

// ---- operands shared by the LSTM products --------------------------------------

// bf16 rows, K contiguous: element (r, k) = p[r * ld + k], r < R, k < K;
// K and ld multiples of 8.
struct Bf16Rows {
  static constexpr bool kKMajor = true;
  static constexpr bool kAsync = true;
  struct Raw {};
  const __nv_bfloat16* p;
  int R, K, ld;
  __device__ void fill(int, int r, int k, uint32_t dst) const {
    const bool valid = r < R && k < K;
    cp_async16(dst, valid ? p + static_cast<size_t>(r) * ld + k : p, valid);
  }
};

// bf16, r contiguous, in one or two K segments: element (r, k) of segment s =
// p[s][k * ld + r], r < R, k < K[s]; R and ld multiples of 8.
struct Bf16Cols {
  static constexpr bool kKMajor = false;
  static constexpr bool kAsync = true;
  struct Raw {};
  const __nv_bfloat16* p[2];
  int K[2];
  int R, ld;
  __device__ void fill(int s, int r, int k, uint32_t dst) const {
    const bool valid = r < R && k < K[s];
    cp_async16(dst, valid ? p[s] + static_cast<size_t>(k) * ld + r : p[s], valid);
  }
};

// ---- the keep-mask sources of an input part's dropout -------------------------
//
// A source gives the keep bits of a part's elements (flat index i of the
// part's row-major (B, T, D) tensor): on(s) says whether part s is masked at
// all (kept values scaled by 1/keep), keep8 the keep marks (a Keep, element e
// kept where kept(k, e)) of the 8 elements at i0 when i0 % 8 == 0 and all 8
// lie in the row, keep_upto those of the first `limit` of them anywhere (the
// rest dropped), keep1 one element's and keep2 those of elements i and i + 1
// of one row (bits 0 and 1). keep8's marks are what the loader fetched,
// tested only when the tile is stored, so the load stays in flight while the
// tensor cores work.

// keep marks as bytes, nonzero = kept, byte e of the pair for element e (the
// Keep of MaskNone and MaskU8)
__device__ __forceinline__ bool byte_kept(const uint2& k, int e) {
  return (((e < 4 ? k.x : k.y) >> (8 * (e & 3))) & 0xffu) != 0;
}

// no dropout (eval, kernel 4's parts as given)
struct MaskNone {
  using Keep = uint2;
  __device__ static Keep all() { return make_uint2(0x01010101u, 0x01010101u); }
  __device__ static bool kept(const Keep& k, int e) { return byte_kept(k, e); }
  __device__ bool on(int) const { return false; }
  __device__ uint2 keep8(int, size_t) const { return make_uint2(0x01010101u, 0x01010101u); }
  __device__ uint2 keep_upto(int, size_t, int limit) const {
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e) w[e >> 2] |= (e < limit ? 1u : 0u) << (8 * (e & 3));
    return make_uint2(w[0], w[1]);
  }
  __device__ bool keep1(int, size_t) const { return true; }
  __device__ uint32_t keep2(int, size_t) const { return 3u; }
};

// uint8 keep-masks in device memory, one per part shaped like it (null: that
// part is not masked)
struct MaskU8 {
  using Keep = uint2;
  __device__ static Keep all() { return make_uint2(0x01010101u, 0x01010101u); }
  __device__ static bool kept(const Keep& k, int e) { return byte_kept(k, e); }
  const uint8_t* m[2];
  __device__ bool on(int s) const { return m[s] != nullptr; }
  __device__ uint2 keep8(int s, size_t i0) const {
    return *reinterpret_cast<const uint2*>(m[s] + i0);
  }
  __device__ uint2 keep_upto(int s, size_t i0, int limit) const {
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t kept = e < limit && (m[s] == nullptr || m[s][i0 + e] != 0) ? 1u : 0u;
      w[e >> 2] |= kept << (8 * (e & 3));
    }
    return make_uint2(w[0], w[1]);
  }
  __device__ bool keep1(int s, size_t i) const { return m[s] == nullptr || m[s][i] != 0; }
  __device__ uint32_t keep2(int s, size_t i) const {
    return (keep1(s, i) ? 1u : 0u) | (keep1(s, i + 1) ? 2u : 0u);
  }
};

// packed keep bits in device memory, one plane per part: bit i mod 8 of byte
// i / 8 for element i (philox_bits.cu draws them from the Philox key once per
// layer and pass); a byte serves 8 elements, 1/32 of the part's bytes, and
// is keep8's marks as loaded (bit e for element e)
struct MaskBits {
  using Keep = uint32_t;
  __device__ static Keep all() { return 0xffu; }
  __device__ static bool kept(Keep k, int e) { return ((k >> e) & 1u) != 0u; }
  const uint8_t* b[2];
  __device__ bool on(int) const { return true; }
  __device__ uint32_t bit(int s, size_t i) const { return (b[s][i >> 3] >> (i & 7)) & 1u; }
  __device__ Keep keep8(int s, size_t i0) const { return b[s][i0 >> 3]; }
  __device__ Keep keep_upto(int s, size_t i0, int limit) const {
    uint32_t k = 0u;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < limit) k |= bit(s, i0 + e) << e;
    return k;
  }
  __device__ bool keep1(int s, size_t i) const { return bit(s, i) != 0u; }
  __device__ uint32_t keep2(int s, size_t i) const {
    if ((i & 7) == 7) return bit(s, i) | (bit(s, i + 1) << 1);
    return (b[s][i >> 3] >> (i & 7)) & 3u;
  }
};

// Run f(source) on the mask source of a launch's arguments: the keep-bit
// planes where bits0 is given (then no uint8 mask may be), the uint8 masks
// where either part has one, else none.
template <class F>
cudaError_t with_mask_source(const uint8_t* m0, const uint8_t* m1, const uint8_t* bits0,
                             const uint8_t* bits1, F&& f) {
  if (bits0 != nullptr) {
    if (m0 != nullptr || m1 != nullptr) return cudaErrorInvalidValue;
    return f(MaskBits{{bits0, bits1}});
  }
  if (bits1 != nullptr) return cudaErrorInvalidValue;
  if (m0 != nullptr || m1 != nullptr) return f(MaskU8{{m0, m1}});
  return f(MaskNone{});
}

// 8 consecutive float32 elements as loaded, with their keep marks (a mask
// source's Keep) and the scale of a kept one (1 and all kept when the part
// has no mask)
template <class Keep>
struct MaskedRaw {
  float v[8];
  Keep keep;
  float scale;
};

// 8 consecutive elements of input part s at flat index i0 (row-major rows of
// D), the ones at or past `limit` (within the row) zero, with their keep
// bytes from the mask source
template <class Src>
__device__ __forceinline__ MaskedRaw<typename Src::Keep> masked_load_x8(
    const float* __restrict__ x, const Src& src, int s, size_t i0, int D, int limit,
    float inv_keep) {
  MaskedRaw<typename Src::Keep> raw;
  raw.scale = src.on(s) ? inv_keep : 1.f;
  raw.keep = Src::all();
  if (limit >= 8 && (D & 7) == 0) {
    load_f32x8(raw.v, x + i0);
    if (src.on(s)) raw.keep = src.keep8(s, i0);
    return raw;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) raw.v[e] = e < limit ? x[i0 + e] : 0.f;
  raw.keep = src.keep_upto(s, i0, limit);
  return raw;
}

// where(m != 0, x * (1/keep), 0) (the reference's _masked), rounded to bf16
template <class Src>
__device__ __forceinline__ void masked_store(const MaskedRaw<typename Src::Keep>& raw,
                                             uint32_t dst) {
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = Src::kept(raw.keep, e) ? raw.v[e] * raw.scale : 0.f;
  st_shared_v4(dst, pack_bf16x8(v));
}

// bf16(masked x_p) with K contiguous, one or two parts as the K segments:
// element (r = b*T + t, k = feature) of segment s = mask_s(x_s)[r * D[s] + k]
template <class Src>
struct MaskedXRows {
  static constexpr bool kKMajor = true;
  static constexpr bool kAsync = false;
  using Raw = MaskedRaw<typename Src::Keep>;
  const float* x[2];
  Src src;
  int D[2];
  int M;
  float inv_keep;
  __device__ Raw load(int s, int r, int k) const {
    return masked_load_x8(x[s], src, s, static_cast<size_t>(r) * D[s] + k, D[s],
                          r < M ? D[s] - k : 0, inv_keep);
  }
  __device__ void store(const Raw& raw, uint32_t dst) const { masked_store<Src>(raw, dst); }
};

// bf16(masked x) of input part `part` with M contiguous: element (r =
// feature, k = b*T + t) = mask(x)[k * D + r]
template <class Src>
struct MaskedXCols {
  static constexpr bool kKMajor = false;
  static constexpr bool kAsync = false;
  using Raw = MaskedRaw<typename Src::Keep>;
  const float* x;
  Src src;
  int part;
  int D, K;
  float inv_keep;
  __device__ Raw load(int, int r, int k) const {
    return masked_load_x8(x, src, part, static_cast<size_t>(k) * D + r, D, k < K ? D - r : 0,
                          inv_keep);
  }
  __device__ void store(const Raw& raw, uint32_t dst) const { masked_store<Src>(raw, dst); }
};

// bf16(h_prev) with M contiguous: element (r = unit, k = b*T + t) = h[b, t-1]
// (h[b, t+1] reverse), zero before the direction's first step
struct HPrevCols {
  static constexpr bool kKMajor = false;
  static constexpr bool kAsync = false;
  struct Raw {
    float v[8];
  };
  const float* h;
  int T, H, K, reverse;
  __device__ Raw load(int, int r, int k) const {
    Raw raw;
    const int b = k / T;
    const int tp = (k - b * T) + (reverse ? 1 : -1);
    if (k < K && r < H && tp >= 0 && tp < T) {
      load_f32x8(raw.v, h + (static_cast<size_t>(b) * T + tp) * H + r);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) raw.v[e] = 0.f;
    }
    return raw;
  }
  __device__ void store(const Raw& raw, uint32_t dst) const {
    st_shared_v4(dst, pack_bf16x8(raw.v));
  }
};

}  // namespace eegflow
