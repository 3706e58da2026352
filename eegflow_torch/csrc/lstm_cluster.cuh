// The thread-block-cluster pieces of the recurrent LSTM kernels (kernel 2's
// recurrence in lstm_fwd.cu, the adjoint chain of kernels 3, 3b and 4 in
// lstm_bwd_chain.cuh, kernel 1's float32 recurrence and kernel 5's float32
// adjoint in lstm_rec.cu): the geometry of a launch, the cluster barrier,
// stores into another CTA's shared memory, and the launch itself.
//
// A cluster of hc CTAs owns 16 * kMT batch rows (kMT = 1..3 mma m-tiles)
// and one direction; CTA `rank` owns U = H / hc hidden units with 4 U
// threads (bf16 kernels: one warp per octet of 8 units; kernel 1: four row
// groups of U threads; kernels 1 and 5) and keeps its slice of the recurrent
// weight (in the layout nn/lstm_plan.py builds) in shared memory: the first
// k_res rows of it, the rest read from L2 each step. Each step a CTA sends
// its part of the new state (bf16, or float32 in kernel 1; kernel 5 sends
// each CTA its block of a partial dh instead) to every CTA of the cluster
// through distributed shared memory, then arrives
// at the cluster barrier (release); work that does not need the exchange
// (HBM stores, the next step's loads) goes before the wait (acquire). The
// forward double-buffers h, so one barrier per step is enough: a CTA writes
// a buffer again only after every CTA has arrived past its reads of it. The
// backward kernels keep one buffer (dz; kernel 5 its partial inbox) and a
// second barrier phase per step, arrived at after the buffer's reads and
// waited for just before the next step's exchange, so the step's work hides
// it.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace eegflow {

// the largest portable cluster
constexpr int kMaxCluster = 8;

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// barrier.cluster.arrive has release and .wait acquire semantics by default
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// the address of the same shared-memory location in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// The four lanes of a quad (lane = 4 g + q) each hold 2 bf16 units of the
// same 8-unit octet and row: gathered, the octet's 16 bytes, lane order.
__device__ __forceinline__ uint4 quad_gather(uint32_t v, int lane) {
  const int base = lane & ~3;
  return make_uint4(__shfl_sync(0xffffffffu, v, base), __shfl_sync(0xffffffffu, v, base + 1),
                    __shfl_sync(0xffffffffu, v, base + 2), __shfl_sync(0xffffffffu, v, base + 3));
}

// A 4 x 4 transpose across a quad: lane q holds v[0..3] (one value of each
// of four gates); it gets back v[q] of lanes 0..3, so the quad's lanes hold
// one gate's octet each, as 16 bytes in lane order.
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&v)[4], int lane) {
  const int q = lane & 3, base = lane & ~3;
  uint32_t c[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int give = (q + j) & 3;   // the receiver (q + j) & 3 wants v[its q]
    const int from = (q - j) & 3;   // the sender whose v[q] arrives in this round
    const uint32_t send = give == 0 ? v[0] : give == 1 ? v[1] : give == 2 ? v[2] : v[3];
    const uint32_t got = __shfl_sync(0xffffffffu, send, base | from);
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = from == e ? got : c[e];
  }
  return make_uint4(c[0], c[1], c[2], c[3]);
}

// The geometry of a recurrent launch, as nn/lstm_plan.py plans it.
struct ClusterGeom {
  int H;      // hidden units
  int hc;     // CTAs per cluster
  int rows;   // batch rows per cluster: 16, 32 or 48
  int k_res;  // resident rows of the CTA's weight slice
  int kind;   // 0: forward (K = H, 4U bf16 columns); 1: backward (K = 4H, U
              // bf16 columns); 2: float32 recurrence (K = H, 4U float32
              // columns); 3: float32 adjoint (K = 4U, H float32 columns)

  int units() const { return H / hc; }
  // 4U threads; kernel 5 8U (two halves that split its rows and products)
  int threads() const { return 32 * (units() / 8) * (kind == 3 ? 2 : 1); }
  int k_total() const { return kind == 1 ? 4 * H : kind == 3 ? 4 * units() : H; }
  size_t slice_row_bytes() const {
    return kind == 0 ? 4 * units() * 2
         : kind == 1 ? units() * 2
         : kind == 2 ? 4 * units() * 4
                     : static_cast<size_t>(H) * 4;
  }
  // the weight slice's k_res rows, then the state buffers: two bf16 ones
  // (forward) or one (backward) of `rows` rows of K + 8 elements; two
  // float32 ones (float32 recurrence) of rows of H + 4; or (float32 adjoint)
  // the dz tile, rows x 4U, and the partial inbox, hc x rows x U, float32
  size_t smem_bytes() const {
    size_t state;
    if (kind == 2)
      state = 2 * static_cast<size_t>(rows) * (H + 4) * 4;
    else if (kind == 3)
      state = static_cast<size_t>(rows) * (4 * units() + H) * 4;
    else
      state = (kind == 0 ? 2 : 1) * static_cast<size_t>(rows) * (k_total() + 8) * 2;
    return static_cast<size_t>(k_res) * slice_row_bytes() + state;
  }
  bool valid() const {
    return H % 32 == 0 && H >= 32 && H <= 512 && hc >= 1 && hc <= kMaxCluster &&
           H % (8 * hc) == 0 &&
           units() / 8 <= 16 && (rows == 16 || rows == 32 || rows == 48) && k_res >= 0 &&
           (k_res == k_total() || k_res % 64 == 0) && k_res <= k_total() && smem_bytes() <= 232448;
  }
};

// f(kMT, kMaxThreads) for this geometry's m-tiles (rows / 16) and thread
// count, each an std::integral_constant: the instantiation of a recurrent
// kernel that a launch or a query takes. More than 256 threads (over 8
// octets a CTA, widths such as H = 160) leave 128 registers a thread, and
// take 16 rows only; a kernel whose CTAs may exceed 512 threads (kernel 5)
// asks for the 1024-thread instantiation with kThreadsCap.
template <int kThreadsCap = 512, class F>
cudaError_t with_tile(const ClusterGeom& geo, F&& f) {
  using std::integral_constant;
  if constexpr (kThreadsCap > 512) {
    if (geo.threads() > 512)
      return geo.rows == 16 ? f(integral_constant<int, 1>{}, integral_constant<int, 1024>{})
                            : cudaErrorInvalidValue;
  }
  if (geo.threads() > 256)
    return geo.rows == 16 ? f(integral_constant<int, 1>{}, integral_constant<int, 512>{})
                          : cudaErrorInvalidValue;
  switch (geo.rows) {
    case 16:
      return f(integral_constant<int, 1>{}, integral_constant<int, 256>{});
    case 32:
      return f(integral_constant<int, 2>{}, integral_constant<int, 256>{});
    case 48:
      return f(integral_constant<int, 3>{}, integral_constant<int, 256>{});
  }
  return cudaErrorInvalidValue;
}

inline cudaLaunchConfig_t cluster_config(const ClusterGeom& geo, dim3 grid, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(geo.threads(), 1, 1);
  cfg.dynamicSmemBytes = geo.smem_bytes();
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = geo.hc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launch `kernel` on `tiles` clusters per direction (grid.y = directions).
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), const ClusterGeom& geo, int tiles,
                           int directions, cudaStream_t stream, Args... args) {
  if (!geo.valid()) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(geo.smem_bytes()));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(geo, dim3(tiles * geo.hc, directions, 1), stream, attr);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of `kernel` at this geometry the card holds at once.
template <typename... Params>
cudaError_t max_active_clusters(void (*kernel)(Params...), const ClusterGeom& geo, int* smem,
                                int* clusters) {
  *smem = static_cast<int>(geo.smem_bytes());
  *clusters = 0;
  if (!geo.valid()) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(geo.smem_bytes()));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(geo, dim3(geo.hc, 1, 1), nullptr, attr);
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

}  // namespace eegflow
