// The pieces of kernel 8's wide bf16 class (pool_head_bwd.cu: D <= 1024 and
// K <= 512, the classifier at H = 512): a cluster of two CTAs per batch row,
// the product of a 64-row tile against a streamed operand, and the exchange
// of partial sums between the two CTAs.
//
// A cluster walks its batch row's time steps in 64-row tiles. CTA `rank`
// owns the columns [rank Dh, rank Dh + Dh) of x, y, dy and dh (Dh = D / 2)
// and the columns [rank Kh, rank Kh + Kh) of proj and u (Kh = K / 2). A
// row's LayerNorm statistics and its other sums over D are two partial sums,
// one a CTA, each pushed into both CTAs' shared memory and added as
// rank 0's + rank 1's after a cluster barrier, so both CTAs hold the same
// bits. proj = y . W1 sums over D, so each CTA's product (tile_mma) gives a
// partial proj of all K columns from its own y columns and its own rows of
// W1 (Dh x K, streamed): it pushes the partner's columns of it into the
// partner's shared memory (push_partial, over the partner's ring, which no
// product reads then) and adds what the partner pushed to its own columns.
// So a 64-row tile reads W1 once across the cluster, where the 16-row tiles
// of the class before read it whole once every 16 rows in each CTA, and each
// W1 slice in shared memory feeds four m-tiles of products instead of one.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "lstm_cluster.cuh"
#include "mma_gemm.cuh"

// Phase marks of the wide class: nothing in a build of the kernels;
// kernels.ablate's "phases" variant defines the mark to add the SM clock
// cycles since a CTA's previous mark to phase p (thread 0 of each CTA).
#ifndef EEGFLOW_WIDE_MARK
#define EEGFLOW_WIDE_MARK(p)
#endif

namespace eegflow {

constexpr int kWideCluster = 2;              // CTAs a batch row
constexpr int kWideRows = 64;                // time steps a tile
constexpr int kWideMT = kWideRows / 16;      // m-tiles a tile
constexpr int kWideWarps = 16;
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kWideStages = 4;               // slices in the ring
constexpr int kWideMaxHalfD = 512;           // Dh <= 512 (D <= 1024)
constexpr int kWideMaxK = 512;
constexpr int kWideNP = kWideMaxK / 16 / kWideWarps;  // 16-column pairs a warp owns
constexpr int kWideLaneCols = kWideMaxHalfD / 32;      // columns of a half row a lane holds

// elements of one ring stage for a product of N columns (N <= max(K, Dh))
__host__ __device__ inline int wide_stage_elems(int half_d, int K) {
  return kTileSlice * ((K > half_d ? K : half_d) + 8);
}

// elements of a 64-row bf16 A tile of N <= max(K, Dh) columns: the y tile
// and the u tile, which kernel 8 keeps in the same place (y is read by proj
// only, u written after it)
__host__ __device__ inline int wide_tile_elems(int half_d, int K) {
  return kWideRows * ((K > half_d ? K : half_d) + 8);
}

__device__ __forceinline__ void st_cluster_f32(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ void st_cluster_v2_f32(uint32_t addr, float a, float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b)
               : "memory");
}

__device__ __forceinline__ void st_cluster_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// one barrier of both CTAs of the cluster (release, then acquire)
__device__ __forceinline__ void pair_sync() {
  cluster_arrive();
  cluster_wait();
}

// v stored at p in this CTA's shared memory and at the same place in CTA
// `partner`'s
__device__ __forceinline__ void store_both(float* p, uint32_t partner, float v) {
  *p = v;
  st_cluster_f32(map_rank(smem_addr(p), partner), v);
}

// The row-wise phases of kernel 8: warp w takes the tile's row pairs r0 =
// 2 w + 32 p and r0 + 1 (p < 2) and lane l the half's columns l + 32 i (i <
// kWideLaneCols), both rows' loads in flight together. push_pair_sums
// pushes two sums over the half of each row (v[rr][0], v[rr][1]) into both
// CTAs' sums[rank] ([2][kWideRows][2]); ln_stats gives a row's mean and
// 1 / sigma from both halves' sums of x and x^2, rank 0's + rank 1's, as one
// sum over D.
__device__ __forceinline__ void push_pair_sums(float (&v)[2][2], int r0, float* sums,
                                               uint32_t rank, uint32_t partner) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      v[rr][0] += __shfl_xor_sync(0xffffffffu, v[rr][0], off);
      v[rr][1] += __shfl_xor_sync(0xffffffffu, v[rr][1], off);
    }
  if (lane < 2) {
    float* const at = sums + 2 * (rank * kWideRows + r0 + lane);
    store_both(at, partner, lane == 0 ? v[0][0] : v[1][0]);
    store_both(at + 1, partner, lane == 0 ? v[0][1] : v[1][1]);
  }
}

__device__ __forceinline__ float2 ln_stats(const float* ln_x, int r, float inv_d, float eps) {
  const float mu = (ln_x[2 * r] + ln_x[2 * (kWideRows + r)]) * inv_d;
  const float ex2 = (ln_x[2 * r + 1] + ln_x[2 * (kWideRows + r) + 1]) * inv_d;
  return make_float2(mu, rsqrtf(ex2 - mu * mu + eps));
}

// The partial proj of a 64-row tile (tile_mma's acc over the K columns, this
// CTA's half of D): the partner's columns [pk0, pk0 + Kh) pushed into its
// inbox (float [64][Kh + 4] in its shared memory, at remote address
// `inbox`). Columns come in even pairs and Kh is a multiple of 16, so a pair
// never straddles the halves.
template <int kNP>
__device__ __forceinline__ void push_partial(const float (&acc)[kWideMT][2 * kNP][4],
                                             uint32_t inbox, int K, int pk0, int Kh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const int ldi = Kh + 4;
#pragma unroll
  for (int j = 0; j < 2 * kNP; ++j) {
    const int pair = warp + kWideWarps * (j / 2);
    const int col = pair * 16 + 8 * (j % 2) + 2 * q;
    if (pair >= K / 16 || col < pk0 || col >= pk0 + Kh) continue;
#pragma unroll
    for (int i = 0; i < kWideMT; ++i)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int row = 16 * i + 8 * rh + gq;
        st_cluster_v2_f32(inbox + 4u * static_cast<uint32_t>(row * ldi + col - pk0),
                          acc[i][j][2 * rh], acc[i][j][2 * rh + 1]);
      }
  }
}

// Launch `kernel` on `pairs` clusters of kWideCluster CTAs of kWideThreads
// threads.
template <typename... Params, typename... Args>
cudaError_t launch_pairs(void (*kernel)(Params...), int pairs, size_t smem, cudaStream_t stream,
                         Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kWideCluster * pairs, 1, 1);
  cfg.blockDim = dim3(kWideThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kWideCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace eegflow
