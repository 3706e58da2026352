"""Where a step of the recurrent kernels' time goes, and the parts of the
input-block forward, the float32 input-block backward and the float32 pool
head, on the GPU.

    python -m eegflow_torch.kernels.ablate [--variant base|nomma|noexch|nostore|noload|noln|
                                                     nostream|onetf32|onedir|stamps|nodraw|
                                                     nodraw_loader|rk4loop|phases|exactgelu|
                                                     gbload]
                                           [--rows 16,32,48]
                                           [--calls all|recurrent|head|input|filter|philox|rk4|
                                                    steps]
                                           [--csrc DIR] [--save FILE] [--against FILE]

Builds the kernels from a copy of ``eegflow_torch/csrc`` with one part of
the serial step of kernel 2's recurrence, of kernels 3, 3b and 4's chain, of
kernel 1's float32 recurrence and of kernel 5's float32 adjoint taken out
(``nomma``: the per-step product; ``noexch``: the DSMEM exchange of the new
state, or of kernel 5's partial dh; ``nostore``: the HBM stores of h, c, z,
the planes, bf16 dz and kernel 5's dz; ``noload``: the HBM loads of the
pre-gates, the planes, the raw gates and kernel 5's z, c_prev and g;
``base``: nothing), then times, with ``torch.profiler``, the recurrence
kernel of each full-width call (H=256, T=256, two parts of 256): kernel 2 in
eval and training mode, kernels 3 and 3b and kernels 1 (training mode) and 5
at B=16 (one cluster) and at the main path's batch (512; eval 1024, kernel 1
in eval mode too), and kernel 4 at 512. The same variants take out a part of
kernel 9 (the input-block forward, both modes), of kernel 10's float32 mode
and of the float32 modes of kernels 8 and 7 (3xTF32): ``nomma`` its
products (kernel 10: z, dx and dW; kernel 8: both in-kernel products and
the dW1 GEMM; kernel 7: proj), ``noload`` its HBM reads (x; kernel 10 also
dy), ``nostore`` its HBM stores (y; kernel 10's dx; kernel 8's dh and the y
and u scratch; kernel 7's scores), and ``noln`` the LayerNorm (kernel 9:
the statistics, LayerNorm and GELU; kernel 8: the statistics and the
LayerNorm backward's row sums), and two take out a part of the 3xTF32
products alone: ``nostream`` the streaming of W1 and W1^T into kernels 8
and 7 (the products read stale slices), ``onetf32`` two of the three TF32
products (one TF32 product, a different function; kernel 10's dx and dW
too). Kernel 12 (``sos_filter.cu``, ``--calls filter``) takes ``nomma`` as
its steady loop's recursion (the samples pass through), ``noload`` as the
bulk copies of x and of the forward pass into its stages, ``nostore`` as
the bulk stores of the forward pass and the output; it is timed on 61 x
20,000 and 61 x 60,000 samples. Each is timed
at B=512 (kernel 9's bf16 mode also at 1024), every
launch of the call by name, with the SM clock and power draw that
``nvidia-smi`` samples during the warm-up (a power-limited card lowers its
clock under a sustained load). ``--calls`` times only the recurrent kernels or
only kernels 9, 10, 8 and 7, ``filter`` only kernel 12. ``--rows`` restricts the
plan's rows per cluster (``cuda_lstm.restrict_plan_rows``). A variant's
results are wrong by construction and only its times mean anything; the
difference to ``base`` is the part's share of a step or a call. Each variant
needs its own process: two builds of the library in one process fault.
Needs CUDA and nvcc.

Two probes of kernel 4's placement: ``onedir`` runs its chain with the
reverse direction's clusters returning at once (a chain as long as both
directions' means they ran side by side), and ``stamps`` records each chain
CTA's SM and ``%globaltimer`` at its start and end and prints, for kernel
4's last launch at each batch, the SMs each direction ran on, their start
and end spans and how many CTAs ran at the latest start. The recurrent
calls print ptxas's registers and spills of every chain kernel
(``-Xptxas -v``). ``--csrc`` builds another tree's sources (the same C
interface), so one process per tree times a parent against a change in
turns; ``--save`` writes the outputs of kernels 3, 3b and 4 (and of kernel
12's calls, and of the bf16 classes of kernels 8 and 7 under ``--calls
head``) and ``--against`` holds this run's to a saved file bit for bit.
The readings behind kernel 4's chain design (kernel 3's chain at 48 and 32
rows, kernel 4 at both, its co-residence, the spills) repeat with::

    python -m eegflow_torch.kernels.ablate --calls recurrent --rows 48
    python -m eegflow_torch.kernels.ablate --calls recurrent --rows 32
    python -m eegflow_torch.kernels.ablate --calls recurrent --rows 48 --variant onedir
    python -m eegflow_torch.kernels.ablate --calls recurrent --variant stamps

``--calls philox`` times the Philox modes of kernels 2 (planes), 3 and 3b
(``kernel_dropout``) at B=512 (two parts of 256, H=256, T=256, keep 0.7)
beside the same kernels on the uint8 masks the Philox source expands to,
each launch by name: kernel 2's projection GEMM (``proj_gemm``) and
recurrence, kernel 3's and 3b's chain, ``dx_gemm``, ``dw_ih_gemm``,
``dw_hh_gemm`` and the split sums, and the mask source's own launches. A
Philox call draws the layer's keep-bit planes (``philox_keep_bits_kernel``,
timed by name; once per layer and pass in a step) and launches the kernel
on them. It prints ptxas's registers and spills of every product kernel on
a mask source. The variant ``nodraw`` takes the keep bits out of the
kernels: ``MaskBits``' ``keep8``/``keep1``/``keep2`` return a fixed
pattern in place of the plane's bits (wrong results), so the difference to
``base`` is the plane reads' share of each launch::

    python -m eegflow_torch.kernels.ablate --calls philox
    python -m eegflow_torch.kernels.ablate --calls philox --variant nodraw

Before the plane (commit ``0839b25``, the parent of the commit that added
``csrc/philox_bits.cu``) the kernels drew the bits in their loaders and dx
epilogue (``MaskPhilox``), and their wrappers took the source itself. The
readings of that design's draw (PERF.md §6, "Step 1") repeat in a checkout
of that commit with this module copied over its
``eegflow_torch/kernels/ablate.py``: there ``--calls philox`` passes the
source to the wrappers, and the variant ``nodraw_loader`` replaces the
generator calls of ``MaskPhilox::keep8``, ``keep1`` and ``keep2`` by fixed
patterns::

    python -m eegflow_torch.kernels.ablate --calls philox
    python -m eegflow_torch.kernels.ablate --calls philox --variant nodraw_loader

``--save FILE`` / ``--against FILE`` (run in each tree) hold the two
designs' outputs to each other bit for bit (the bits do not change).

``--calls rk4`` times kernel 11 (``apf_rk4.cu``) at the fit's shape (a DE
population of 90, 513 points, 16 RK4 substeps): the fit loss, the loss with
tangents, the trajectory and, where the tree has it, the DE mode on a
chunk of 64 generations at n = 90 (and at 1,024, 1,026 and 3,000 where the
tree takes them, fewer generations where their draws would pass 256 MiB),
each launch by name with the SM clock and the DE's ms a generation; prints
ptxas's registers and spills of every kernel 11 instantiation and the SASS
(``cuobjdump -sass``) of each, whole and by loop that holds no other loop,
by the pipe that issues each instruction (``fma``: FFMA, FMUL, FADD, IMAD,
IMUL; ``alu``: FMNMX, FSETP, FSEL, LOP3, ISETP, ...; ``other``); then runs
``differential_evolution_fit`` without its polish for 50 generations under
``torch.profiler`` (a generation's wall ms, kernel 11's device ms, the
other launches' device ms, the device's idle share) and for 1,000 (wall
time). The variant ``stamps`` adds each warp's SM clock cycles over a
trajectory or loss launch (``clock64()``; per RK4 step, the per-point work
included; the probe itself slows the launch), ``rk4loop`` runs the fit's
16 substeps through the general loop instead of unrolled, ``rk4fdiv`` takes
a point's quotients with the IEEE division (a slow-path branch) in place of
``__fdividef``, and ``rk4fmax`` the clamp as ``fmaxf`` (ALU pipe) in place of
``y + |y|`` (FMA pipe). The readings behind kernel 11's design (PERF.md
§6) repeat on the design before it (commit ``b70bdc5``: a thread a
candidate, 21 dependent operations a step, the generation loop on the host)
from an unpacked copy of that commit with this module copied over its
``eegflow_torch/kernels/ablate.py``, and on today's tree::

    python -m eegflow_torch.kernels.ablate --calls rk4
    python -m eegflow_torch.kernels.ablate --calls rk4 --variant stamps
    python -m eegflow_torch.kernels.ablate --calls rk4 --variant rk4loop

``--calls head`` also times the bf16 classes of kernels 8 and 7: the narrow
ones at the main path's shapes (B=512, T=256, two parts of 256, K=256,
LayerNorm) and the wide ones at a hidden-512 classifier's (two parts of 512,
K=512), every launch by name (kernel 8's row kernel, its dW1 split-K GEMM
``mma_gemm_kernel`` and the two ``reduce_splits_kernel``); ``--save`` and
``--against`` hold their outputs bit for bit. It prints ptxas's registers
and spills of every pool-head kernel and, at B=1, T=256 on the card tests'
edge cases (``WIDE_EDGE_PARTS``, ``wide_head_case``), how far kernel 8's
wide class and its twin each lie from the float64 function
(``pool_head_bwd_f64``). ``nostream`` also
stops the refills of the rings that ``mma_gemm.cuh``'s ``tile_mma`` streams
W1 through in both classes of kernels 8 and 7, ``nomma`` its product loops;
the variant ``phases`` makes thread 0 of each CTA of kernel 8's wide class
add the SM clock cycles between the marks in its source
(``EEGFLOW_WIDE_MARK``, nothing in a normal build) to a table by phase,
printed as cycles a CTA tile and shares::

    python -m eegflow_torch.kernels.ablate --calls head
    python -m eegflow_torch.kernels.ablate --calls head --variant phases
    python -m eegflow_torch.kernels.ablate --calls head --variant nostream

``--calls input`` times kernels 9 and 10 at ``chip_smoke.py`` phase 19's
shapes (B=512, T=256, C=61, H = 256 and 512): the bf16 forward, both classes
of the bf16 backward (the narrow one at H = 256, the wide one, a cluster of
two CTAs a 64-row tile, at H = 512) and the float32 backward, every launch
by name (the row kernel and ``reduce_splits_kernel`` apart) and each call
by CUDA events (the wrapper's host time included); it prints ptxas's report
of the input-block kernels, the bf16 launch plans read from the C entry
point, and at B = 1, T = 256, H = 512 how far the wide class and its twin
lie from the float64 function (``input_block_bwd_f64``). ``noload`` zero-fills
the x and dy copies of both bf16 classes, ``nomma`` takes out their three
products, ``noexch`` turns the wide class's cluster barriers into CTA
barriers, ``exactgelu`` and ``gbload`` are its row pass with the IEEE GELU
derivative and with gamma and beta read from shared memory for each row, and
``phases`` adds its SM cycles a tile by phase. ``--save``/``--against`` hold
every output to another tree's bit for bit (the file holds every output at
B=512, over 100 MB). The parent's readings come from its own tree with this
module copied over its ``eegflow_torch/kernels/ablate.py`` (its wrapper plans
its own tiles)::

    python -m eegflow_torch.kernels.ablate --calls input --save /tmp/input.pt
    python -m eegflow_torch.kernels.ablate --calls input --variant phases

``--calls steps`` times, with CUDA events, a bf16 micro-step of
``ModelConfig()`` at hidden 256 and 512 (B=512) and a classifier
evaluation at B=1024, and the CLI stage ``ablate --hidden 512 --epochs 1`` on
a synthetic processed set (4,096 training windows) by the host clock. With
``--csrc`` naming another tree's sources, the same calls run on that
tree's kernels, so a parent and a change are timed in turns, one process a
turn::

    python -m eegflow_torch.kernels.ablate --calls steps --csrc PARENT/eegflow_torch/csrc
    python -m eegflow_torch.kernels.ablate --calls steps

The readings of kernel 8's wide class before its redesign (PERF.md §6)
repeat in a checkout of commit ``27992d0`` with this module copied over its
``eegflow_torch/kernels/ablate.py`` (a variant skips its patches to a source
the tree does not have).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path
from typing import Dict

import numpy as np
import torch

H, STEPS, CHANNELS = 256, 256, 61

# the "stamps" variant's probe: one record (SM, start ns, end ns) a CTA of
# kernel 4's chain, indexed by its block, and a C entry that copies them out
STAMPS_CODE = r"""
__device__ unsigned long long g_ablate_stamps[4096][3];
__device__ __forceinline__ unsigned long long ablate_clock() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
struct Stamp {
  unsigned long long start;
  __device__ Stamp() : start(ablate_clock()) {}
  __device__ ~Stamp() {
    unsigned int sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    const unsigned int i = blockIdx.y * gridDim.x + blockIdx.x;
    if (threadIdx.x == 0 && i < 4096) {
      g_ablate_stamps[i][0] = sm;
      g_ablate_stamps[i][1] = start;
      g_ablate_stamps[i][2] = ablate_clock();
    }
  }
};
}  // namespace
extern "C" int eegflow_ablate_stamps(unsigned long long* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_ablate_stamps, 24 * n));
}
namespace {
"""
STAMPS_MAX = 4096

# the "stamps" variant's probe of kernel 11: each warp's lane 0 records the
# SM clock cycles from the start to the end of its candidates' launch of a
# trajectory or loss mode (the step loop and the per-point work), indexed by
# warp, and a C entry that copies them out
APF_STAMPS_CODE = r"""
__device__ unsigned long long g_ablate_apf_cycles[4096];
__device__ __forceinline__ unsigned long long ablate_apf_clock() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t));
  return t;
}
struct ApfStamp {
  unsigned long long start;
  __device__ ApfStamp() : start(ablate_apf_clock()) {}
  __device__ ~ApfStamp() {
    const unsigned int t = blockIdx.x * blockDim.x + threadIdx.x;
    if ((threadIdx.x & 31) == 0 && (t >> 5) < 4096)
      g_ablate_apf_cycles[t >> 5] = ablate_apf_clock() - start;
  }
};
extern "C" int eegflow_ablate_apf_cycles(unsigned long long* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_ablate_apf_cycles, 8 * n));
}
"""

# the "phases" variant's probe of kernel 8's wide bf16 class
# (pool_head_wide.cuh's EEGFLOW_WIDE_MARK): thread 0 of each CTA adds the SM
# clock cycles since its previous mark to the mark's phase (and counts the
# tiles at phase 1), and a C entry that copies the table out
WIDE_MARKS_CODE = r"""
__device__ unsigned long long g_wide_marks[17];
__device__ unsigned long long g_wide_last[8192];
#define EEGFLOW_WIDE_MARK(p)                                                        \
  do {                                                                              \
    if (threadIdx.x == 0 && blockIdx.x < 8192) {                                    \
      unsigned long long t_;                                                        \
      asm volatile("mov.u64 %0, %%clock64;" : "=l"(t_));                            \
      if ((p) > 0) atomicAdd(&g_wide_marks[(p)], t_ - g_wide_last[blockIdx.x]); \
      if ((p) == 1) atomicAdd(&g_wide_marks[16], 1ull);                         \
      g_wide_last[blockIdx.x] = t_;                                             \
    }                                                                               \
  } while (0)
extern "C" int eegflow_ablate_wide_marks(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_wide_marks, 8 * 17));
}
"""
# the "phases" variant's probe of kernel 10's wide bf16 class (input_block.cu's
# EEGFLOW_INPUT_MARK), as WIDE_MARKS_CODE for kernel 8's
INPUT_MARKS_CODE = WIDE_MARKS_CODE.replace("EEGFLOW_WIDE_MARK", "EEGFLOW_INPUT_MARK").replace(
    "g_wide_", "g_input_").replace("eegflow_ablate_wide_marks", "eegflow_ablate_input_marks")
#: the phases kernel 10's wide class marks close
INPUT_PHASES = ["x waited for, barrier", "x staged, z product", "statistics, cluster barrier 1",
                "dy waited for", "row pass 1, cluster barrier 2", "row pass 2, barrier",
                "dx and dW products", "cluster barrier 3, dx stored"]
#: the phases the marks close
WIDE_PHASES = ["LN sums and barrier L", "y, y scratch, g . y", "proj product", "barrier A",
               "partial pushed, barrier B", "u, db1, dw2", "barrier C", "dy product",
               "dy staged", "LN backward sums, barrier D", "dh, dgamma, dbeta"]

#: SASS opcodes by the SM pipe that issues them (the rest: memory, control,
#: moves, conversions, the uniform datapath)
SASS_PIPES = {"fma": {"IMAD", "IMUL", "FFMA", "FMUL", "FADD"},
              "alu": {"LOP3", "ISETP", "IADD3", "SHF", "LEA", "SEL", "PRMT", "IMNMX",
                      "IABS", "PLOP3", "BMSK", "SGXT", "FSETP", "FSEL", "FMNMX"}}

# variant -> (source file, text, replacement); each text occurs once in its
# source (held by tests/test_torch_lstm_plan.py)
VARIANTS = {
    "base": [],
    "nomma": [
        ("lstm_fwd.cu", "for (int kt = 0; kt < KT_res; kt += 2)",
         "for (int kt = 0; kt < 0; kt += 2)"),
        ("lstm_fwd.cu", "for (int kt = KT_res; kt < KT; kt += 2)",
         "for (int kt = KT; kt < KT; kt += 2)"),
        ("lstm_bwd_chain.cuh", "for (int kk = h; kk < KT2_res; kk += 2)",
         "for (int kk = h; kk < 0; kk += 2)"),
        ("lstm_bwd_chain.cuh", "for (int kk = KT2_res + h; kk < KT2; kk += 2)",
         "for (int kk = KT2 + h; kk < KT2; kk += 2)"),
        ("lstm_rec.cu", "for (int k = 0; k < k_res; k += 4) {", "for (int k = 0; k < 0; k += 4) {"),
        ("lstm_rec.cu", "for (int k = k_res; k < H; k += 4) {",
         "for (int k = H; k < H; k += 4) {"),
        ("lstm_rec.cu", "for (int n = 0; n < k_res; n += 4) {",
         "for (int n = 0; n < 0; n += 4) {"),
        ("lstm_rec.cu", "for (int n = k_res; n < K; n += 4) {",
         "for (int n = K; n < K; n += 4) {"),
        ("input_block.cu", "for (int c = 0; c < cn; ++c) {\n      const float4 xv",
         "for (int c = 0; c < 0; ++c) {\n      const float4 xv"),
        ("input_block.cu", "if (pair < H / 16) z_pair_mma<kMT>(acc[p]",
         "if (pair < 0) z_pair_mma<kMT>(acc[p]"),
        ("input_block.cu", "for (int k0 = 0; k0 < H; k0 += 16) {",
         "for (int k0 = 0; k0 < 0; k0 += 16) {"),
        ("input_block.cu", "for (int kk = 0; kk < kRows / 8; ++kk) {",
         "for (int kk = 0; kk < 0; ++kk) {"),
        ("mma_gemm.cuh", "for (int it = 0; it < slices; ++it) {\n"
         "    cp_async_wait<kStages - 2>();\n"
         "    __syncthreads();  // slice it has landed; slice it - 1's stage is free again\n"
         "    if (it + kStages - 1 < slices) issue(it + kStages - 1);\n    cp_async_commit();\n"
         "    const float* bs",
         "for (int it = 0; it < 0; ++it) {\n    cp_async_wait<kStages - 2>();\n"
         "    __syncthreads();  // slice it has landed; slice it - 1's stage is free again\n"
         "    if (it + kStages - 1 < slices) issue(it + kStages - 1);\n    cp_async_commit();\n"
         "    const float* bs"),
        ("mma_gemm.cuh", "for (int kt = 0; kt < n_tiles; ++kt) {",
         "for (int kt = 0; kt < 0; ++kt) {"),
        ("mma_gemm.cuh", "for (int it = 0; it < slices; ++it) {\n"
         "    cp_async_wait<kStages - 2>();\n"
         "    __syncthreads();  // slice it has landed; slice it - 1's stage is free again\n"
         "    if (it + kStages - 1 < slices) issue(it + kStages - 1);\n    cp_async_commit();\n"
         "    const __nv_bfloat16* bs",
         "for (int it = 0; it < 0; ++it) {\n    cp_async_wait<kStages - 2>();\n"
         "    __syncthreads();  // slice it has landed; slice it - 1's stage is free again\n"
         "    if (it + kStages - 1 < slices) issue(it + kStages - 1);\n    cp_async_commit();\n"
         "    const __nv_bfloat16* bs"),
        ("sos_filter.cu", "out[at(i + b)] = cascade.step(v[b]);", "out[at(i + b)] = v[b];"),
        ("sos_filter.cu", "out[at(i)] = cascade.step(in[at(i)]);", "out[at(i)] = in[at(i)];")],
    "noexch": [
        ("lstm_fwd.cu", "for (int r = q; r < hc; r += 4) {", "for (int r = q; r < 0; r += 4) {"),
        ("lstm_bwd_chain.cuh", "      for (int r = 0; r < hc; ++r) {\n        const uint32_t off",
         "      for (int r = 0; r < 0; ++r) {\n        const uint32_t off"),
        ("lstm_rec.cu", "    for (int r = 0; r < hc; ++r) {\n      const uint32_t base",
         "    for (int r = 0; r < 0; ++r) {\n      const uint32_t base"),
        ("lstm_rec.cu", "    if (s + 1 < T && quad < quads) {", "    if (s + 1 < T && quad < 0) {")],
    "nostore": [
        ("lstm_fwd.cu", "        if (row >= B) continue;\n        const size_t bt",
         "        if (row >= 0) continue;\n        const size_t bt"),
        ("lstm_bwd_chain.cuh", "store_row < 16 * kMT && row0 + store_row < B;",
         "store_row < 16 * kMT && row0 + store_row < 0;"),
        ("lstm_rec.cu", "      if (row < B)\n        *reinterpret_cast<uint4*>(h_out",
         "      if (row < 0)\n        *reinterpret_cast<uint4*>(h_out"),
        ("lstm_rec.cu", "if (row0 + r < B) __stcs(c_out", "if (row0 + r < 0) __stcs(c_out"),
        ("lstm_rec.cu", "if (row0 + r >= B) continue;", "if (row0 + r >= 0) continue;"),
        ("lstm_rec.cu", "if (row >= B) continue;\n      float* dp = dgates",
         "if (row >= 0) continue;\n      float* dp = dgates"),
        ("input_block.cu", "__stcs(reinterpret_cast<float4*>(yr + 4 * ch), o);",
         "*reinterpret_cast<float4*>(zs + r * ldz + 4 * ch) = o;"),
        ("input_block.cu", "if (c < cn) dx[static_cast<size_t>(row0 + row) * C + c0 + c] = v;",
         "if (c < 0) dx[static_cast<size_t>(row0 + row) * C + c0 + c] = v;"),
        ("pool_head_fwd.cu", "          scores[bt0 + r] = s[h];\n", ""),
        ("pool_head_bwd.cu", "if (valid) y_scr[bt * D + d] = v;",
         "if (valid && d < 0) y_scr[bt * D + d] = v;"),
        ("pool_head_bwd.cu", "if (t0 + row < T)\n              *reinterpret_cast<float2*>(u_scr",
         "if (t0 + row < 0)\n              *reinterpret_cast<float2*>(u_scr"),
        ("pool_head_bwd.cu", "        if (d < d0)\n          dh0[bt * d0 + d] = v;\n        else\n"
         "          dh1[bt * d1 + (d - d0)] = v;\n      }\n    }\n    __syncthreads();  // the "
         "next tile overwrites the tiles and the row stats\n  }\n\n  // the warps' dgamma and "
         "dbeta summed in warp order\n  float* const part_s = ys;",
         "        if (d < 0)\n          dh0[bt * d0 + d] = v;\n        else if (d < 0)\n"
         "          dh1[bt * d1 + (d - d0)] = v;\n      }\n    }\n    __syncthreads();  // the "
         "next tile overwrites the tiles and the row stats\n  }\n\n  // the warps' dgamma and "
         "dbeta summed in warp order\n  float* const part_s = ys;"),
        ("sos_filter.cu",
         "      store_chunk(dst + static_cast<size_t>(lo) * kRows, smem_u32(ost), len * kRows * 4);",
         "")],
    "noload": [
        ("lstm_fwd.cu", "if (row < B) v = __ldcs", "if (row < 0) v = __ldcs"),
        ("lstm_bwd_chain.cuh", "          if (row < B)\n            v = planar ?",
         "          if (row < 0)\n            v = planar ?"),
        ("lstm_rec.cu", "if (row < B) v = __ldcs(p + gate * H);",
         "if (row < 0) v = __ldcs(p + gate * H);"),
        ("lstm_rec.cu", "      if (row < B) {\n#pragma unroll\n        for (int gate = 0; gate < 4; "
                        "++gate) zr[r][gate]",
         "      if (row < 0) {\n#pragma unroll\n        for (int gate = 0; gate < 4; "
         "++gate) zr[r][gate]"),
        ("input_block.cu", "eegflow::cp_async16_part(smem_addr(xraw + 4 * c), n > 0 ? xtile + 4 "
         "* c : x, 4 * n);",
         "eegflow::cp_async16_part(smem_addr(xraw + 4 * c), n > 0 ? xtile + 4 * c : x, 0);"),
        ("pool_head_bwd.cu", "xv[i] = t < T && d < D ? (d < d0 ? x0[bt * d0 + d] : x1[bt * d1 + "
         "(d - d0)]) : 0.f;",
         "xv[i] = 0.f;"),
        ("input_block.cu", "valid ? dyg + r * H + col : dy, valid);", "dy, false);"),
        ("input_block.cu", "n > 0 ? xg + 4 * c : x, 4 * n);", "x, 0);"),
        ("pool_head_fwd.cu", "xv[i] = r < tc && d < D ? (d < d0 ? x0[bt * d0 + d] : x1[bt * d1 + "
         "(d - d0)]) : 0.f;",
         "xv[i] = 0.f;"),
        ("sos_filter.cu",
         "        load_stage(smem_u32(in_ring) + stage * kStageBytes, src, len * kRows * 4,\n"
         "                   full0 + 8 * stage);",
         "        mbar_arrive(full0 + 8 * stage);")],
    "nostream": [
        ("mma_gemm.cuh", "if (it + kStages - 1 < slices) issue(it + kStages - 1);\n"
         "    cp_async_commit();\n    const float* bs",
         "if (it + kStages - 1 < 0) issue(it + kStages - 1);\n"
         "    cp_async_commit();\n    const float* bs"),
        ("mma_gemm.cuh", "if (it + kStages - 1 < slices) issue(it + kStages - 1);\n"
         "    cp_async_commit();\n    const __nv_bfloat16* bs",
         "if (it + kStages - 1 < 0) issue(it + kStages - 1);\n"
         "    cp_async_commit();\n    const __nv_bfloat16* bs")],
    "onetf32": [
        ("mma_gemm.cuh", "          mma_tf32(acc[i][2 * p], a[i].lo, bh[0], bh[1]);\n"
         "          mma_tf32(acc[i][2 * p + 1], a[i].lo, bh[2], bh[3]);\n", ""),
        ("mma_gemm.cuh", "          mma_tf32(acc[i][2 * p], a[i].hi, bl[0], bl[1]);\n"
         "          mma_tf32(acc[i][2 * p + 1], a[i].hi, bl[2], bl[3]);\n", ""),
        ("mma_gemm.cuh", "        for (int i = 0; i < 4; ++i) mma_tf32(acc[i][j], a[i].lo, bh[0], "
         "bh[1]);\n#pragma unroll\n        for (int i = 0; i < 4; ++i) mma_tf32(acc[i][j], "
         "a[i].hi, bl[0], bl[1]);\n#pragma unroll\n", ""),
        ("input_block.cu", "eegflow::mma_tf32(acc[3 * h], a.lo, bh[0], bh[1]);", ""),
        ("input_block.cu", "eegflow::mma_tf32(acc[3 * h + 1], a.hi, bl[0], bl[1]);", ""),
        ("input_block.cu", "eegflow::mma_tf32(acc_w[j0 + j], a.lo, bh[j][0], bh[j][1]);", "{}"),
        ("input_block.cu", "eegflow::mma_tf32(acc_w[j0 + j], a.hi, bl[j][0], bl[j][1]);", "{}")],
    # kernel 4's chain with the reverse direction's clusters returning at once
    "onedir": [
        ("lstm_bwd_dualdir.cu", "  else\n    chain_direction<kMT, false>(rev.res",
         "  else if (B < 0)\n    chain_direction<kMT, false>(rev.res")],
    # the Philox keep bits as a fixed pattern, not read from the plane (the
    # draw kernel's own launch is timed by name)
    "nodraw": [
        ("mma_gemm.cuh", "const { return (b[s][i >> 3] >> (i & 7)) & 1u; }",
         "const { return (i & 3) != 2 ? 1u : 0u; }"),
        ("mma_gemm.cuh", "size_t i0) const { return b[s][i0 >> 3]; }",
         "size_t i0) const { return 0xb5u; }"),
        ("mma_gemm.cuh", "    return (b[s][i >> 3] >> (i & 7)) & 3u;", "    return 1u;")],
    # the same fixed patterns in place of the generator calls of the design
    # before the plane (MaskPhilox, commit 0839b25; see the module docstring)
    "nodraw_loader": [
        ("mma_gemm.cuh",
         "    return keep_bits8(__ldg(key), __ldg(key + 1), stream[s], off[s] + i0, thresh);",
         "    return make_uint2(0x01000101u, 0x01010001u);"),
        ("mma_gemm.cuh",
         "    return keep_bits(__ldg(key), __ldg(key + 1), stream[s], off[s] + i, 1, thresh) "
         "!= 0u;",
         "    return (i & 3) != 2;"),
        ("mma_gemm.cuh",
         "    return keep_bits(__ldg(key), __ldg(key + 1), stream[s], off[s] + i, 2, thresh);",
         "    return 1u;")],
    # kernel 4's chain with each CTA's SM and %globaltimer at its start and end
    # (read back through eegflow_ablate_stamps)
    # and kernel 11's trajectory and loss modes with each warp's cycles (read back
    # through eegflow_ablate_apf_cycles)
    "stamps": [
        ("lstm_bwd_dualdir.cu", "template <typename ResT>\nstruct Dir {",
         STAMPS_CODE + "template <typename ResT>\nstruct Dir {"),
        ("lstm_bwd_dualdir.cu", "int H, int k_res) {\n  if (blockIdx.y == 0)",
         "int H, int k_res) {\n  const Stamp stamp;\n  if (blockIdx.y == 0)"),
        ("apf_rk4.cu", "#include <cuda_runtime.h>\n",
         "#include <cuda_runtime.h>\n" + APF_STAMPS_CODE),
        ("apf_rk4.cu", "const int b = blockIdx.x * blockDim.x + threadIdx.x;",
         "const ApfStamp apf_stamp;\n  const int b = blockIdx.x * blockDim.x + threadIdx.x;")],
    # kernel 8's wide class with its phases' cycles (read back through
    # eegflow_ablate_wide_marks)
    "phases": [
        ("pool_head_bwd.cu", '#include "pool_head_wide.cuh"',
         WIDE_MARKS_CODE + '#include "pool_head_wide.cuh"'),
        ("input_block.cu", '#include "common.cuh"', INPUT_MARKS_CODE + '#include "common.cuh"')],
    # kernel 10's wide class reading gamma and beta from shared memory for each
    # row in its row pass, not holding the lane's in registers
    "gbload": [
        ("input_block.cu",
         "        gv[i][0] = g4.x, gv[i][1] = g4.y, gv[i][2] = g4.z, gv[i][3] = g4.w;\n"
         "        bv[i][0] = b4.x, bv[i][1] = b4.y, bv[i][2] = b4.z, bv[i][3] = b4.w;\n",
         "        gv[i][0] = gv[i][1] = gv[i][2] = gv[i][3] = 0.f;\n"
         "        bv[i][0] = bv[i][1] = bv[i][2] = bv[i][3] = 0.f;\n"),
        ("input_block.cu",
         "          float o[4];\n#pragma unroll\n          for (int e = 0; e < 4; ++e) {\n"
         "            const float xhat = (zv[e] - mu) * rsig;",
         "          float o[4];\n          {\n"
         "            const float4 g4 = *reinterpret_cast<const float4*>(gb + 4 * ch);\n"
         "            const float4 b4 = *reinterpret_cast<const float4*>(gb + Hh + 4 * ch);\n"
         "            gv[i][0] = g4.x, gv[i][1] = g4.y, gv[i][2] = g4.z, gv[i][3] = g4.w;\n"
         "            bv[i][0] = b4.x, bv[i][1] = b4.y, bv[i][2] = b4.z, bv[i][3] = b4.w;\n"
         "          }\n#pragma unroll\n          for (int e = 0; e < 4; ++e) {\n"
         "            const float xhat = (zv[e] - mu) * rsig;")],
    # kernel 10's wide class with the row pass's GELU derivative in IEEE
    # division and expf (gelu_grad, the narrow class's) in place of the
    # hardware's approximations (a few float32 ulp apart)
    "exactgelu": [("input_block.cu", "dv[e] * gelu_grad_fast(xhat * gv[i][e] + bv[i][e]);",
                   "dv[e] * gelu_grad(xhat * gv[i][e] + bv[i][e]);")],
    # kernel 11's point loss with the IEEE quotient (__fdiv_rn, a slow-path branch)
    "rk4fdiv": [("apf_rk4.cu", "p[j] = __fdividef(c[j], s);", "p[j] = __fdiv_rn(c[j], s);")],
    # kernel 11's clamp as max(y, 0) on the ALU pipe (FMNMX) against whole rate
    # matrices, not y + |y| against halved ones: the same trajectory and loss
    # bits, wrong tangents
    "rk4fmax": [
        ("apf_rk4.cu", "m.h[i][j] = __fmul_rn(0.5f * st.half, q[i][j]);",
         "m.h[i][j] = __fmul_rn(st.half, q[i][j]);"),
        ("apf_rk4.cu", "m.f[i][j] = __fmul_rn(0.5f * st.full, q[i][j]);",
         "m.f[i][j] = __fmul_rn(st.full, q[i][j]);"),
        ("apf_rk4.cu", "m.s[i][j] = __fmul_rn(0.5f * st.sixth, q[i][j]);",
         "m.s[i][j] = __fmul_rn(st.sixth, q[i][j]);"),
        ("apf_rk4.cu", "float twice_pos(float y) { return __fadd_rn(y, fabsf(y)); }",
         "float twice_pos(float y) { return fmaxf(y, 0.f); }")],
    # kernel 11 with the fit's 16 substeps run by the general loop, not unrolled
    "rk4loop": [
        ("apf_rk4.cu", "  if (substeps == kFastSubsteps)\n    launch_modes<kFastSubsteps>(",
         "  if (substeps < 0)\n    launch_modes<kFastSubsteps>("),
        ("apf_rk4.cu", "  if (substeps == kFastSubsteps)\n    return launch_de<kFastSubsteps>(",
         "  if (substeps < 0)\n    return launch_de<kFastSubsteps>(")],
    "noln": [
        ("input_block.cu", "const float4 o = ln_gelu4(zv[i], mu, rsig, gam[i], bet[i]);",
         "const float4 o = make_float4(zv[i][0], zv[i][1], zv[i][2], zv[i][3]);"),
        ("pool_head_bwd.cu", "if (use_ln) {\n        float s1 = 0.f, s2 = 0.f;",
         "if (use_ln < 0) {\n        float s1 = 0.f, s2 = 0.f;"),
        ("pool_head_bwd.cu", "if (use_ln) {\n        load_row(t, xh);",
         "if (use_ln < 0) {\n        load_row(t, xh);")],
}

# the parts of kernel 10's bf16 classes that "nomma" (the three products) and
# "noload" (the HBM reads of x and dy: zero-filled copies) take out
VARIANTS["nomma"] += [
    ("input_block.cu", "z_pair_mma<4>(acc, xs, ldx, ws, ldw, warp, lane);\n"
     "      z_pair_store<4>(acc, zs, ldz, bias, warp, lane);",
     "z_pair_store<4>(acc, zs, ldz, bias, warp, lane);"),
    ("input_block.cu", "fetch_x(next);\n        if (warp < Hh / 16) z_pair_mma<4>",
     "fetch_x(next);\n        if (warp < 0) z_pair_mma<4>"),
    ("input_block.cu", "__syncthreads();\n          if (warp < Hh / 16) z_pair_mma<4>",
     "__syncthreads();\n          if (warp < 0) z_pair_mma<4>"),
    ("input_block.cu", "\n        eegflow::mma_bf16(acc[0], af, r[0], r[1]);\n"
     "        eegflow::mma_bf16(acc[1], af, r[2], r[3]);", ""),
    ("input_block.cu", "eegflow::mma_bf16(accx[0], af, r[0], r[1]);\n"
     "          eegflow::mma_bf16(accx[1], af, r[2], r[3]);", ""),
    ("input_block.cu", "\n          eegflow::mma_bf16(acc_w[jj][0], af, r[0], r[1]);\n"
     "          eegflow::mma_bf16(acc_w[jj][1], af, r[2], r[3]);", ""),
    ("input_block.cu", "\n            eegflow::mma_bf16(acc_w[jj][0], af, r[0], r[1]);\n"
     "            eegflow::mma_bf16(acc_w[jj][1], af, r[2], r[3]);", "")]
# kernel 10's wide class with its three cluster barriers a tile as CTA
# barriers (the partner's sums and partial dx read unsynchronised: wrong
# results), the exchange's cost
VARIANTS["noexch"] += [
    ("input_block.cu", "eegflow::pair_sync();  // both halves' sums of z landed",
     "__syncthreads();"),
    ("input_block.cu", "eegflow::pair_sync();  // both halves' sums of dxhat landed",
     "__syncthreads();"),
    ("input_block.cu", "eegflow::cluster_arrive();  // (release) the partial dx pushed", ""),
    ("input_block.cu", "eegflow::cluster_wait();  // (acquire) the partner's partial dx landed",
     "__syncthreads();")]
VARIANTS["noload"] += [
    ("input_block.cu", "c < kTile * hc; c += kBThreads) {\n      const int r = c / hc, col = "
     "(c - r * hc) * 4;\n      const bool valid = row0 + r < rows;",
     "c < kTile * hc; c += kBThreads) {\n      const int r = c / hc, col = "
     "(c - r * hc) * 4;\n      const bool valid = false;"),
    ("input_block.cu", "const bool valid = row0 + r < rows;\n        eegflow::cp_async16("
     "smem_addr(dys + r * Hh + col),",
     "const bool valid = false;\n        eegflow::cp_async16(smem_addr(dys + r * Hh + col),"),
    ("input_block.cu", "n > 0 ? xt + 4 * c : x, 4 * n);", "x, 0);"),
    ("input_block.cu", "n > 0 ? src + 4 * c : x, 4 * n);", "x, 0);")]


def patched_sources(variant: str, into: Path, csrc=None) -> Path:
    """A copy of the kernel sources (``csrc``, by default the package's)
    under ``into`` with ``variant``'s parts taken out -> its ``csrc``
    directory. A patch to a source the tree lacks (an older tree) is
    skipped."""
    from eegflow_torch import kernels

    src = into / "csrc"
    shutil.copytree(csrc or kernels.CSRC, src)
    for name, text, repl in VARIANTS[variant]:
        path = src / name
        if not path.exists():  # an older tree, from before the source
            continue
        body = path.read_text()
        if body.count(text) != 1:
            raise RuntimeError(f"variant {variant}: {name} holds {text!r} "
                               f"{body.count(text)} times, not once")
        path.write_text(body.replace(text, repl))
    return src


#: the calls whose outputs --save and --against hold bit for bit
BIT_CALLS = ("lstm_bwd", "lstm_bwd_v2", "lstm_bwd_dualdir")


def _flat_cpu(out) -> list:
    """The tensors of a call's (nested) output, on the host."""
    if isinstance(out, torch.Tensor):
        return [out.cpu()]
    return [t for o in out for t in _flat_cpu(o)]


def _recurrence_ms(fn, reps: int = 3) -> float:
    """Mean device ms of a launch of the recurrence or chain kernel (one a
    call of ``fn``), over the launches the profiler recorded."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and ("rec_kernel" in e.name or "rec_fwd_kernel" in e.name
                  or "rec_bwd_kernel" in e.name or "chain_kernel" in e.name)]
    return sum(spans) / max(len(spans), 1) / 1e3


def _ptxas_report(log: str, pattern: str = "chain_kernel"):
    """ptxas's registers and spills of each compiled entry whose (mangled)
    name matches the regular expression ``pattern``, from the build's
    ``-Xptxas -v`` log -> lines of text."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if re.search(pattern, m.group(1)) else None
        elif name and ("spill" in line or "Used" in line):
            out.append(f"{_demangle(name)}: {line.strip()}")
    return list(dict.fromkeys(out))  # each source that instantiates a kernel reports it


def _demangle(name: str) -> str:
    try:
        return subprocess.run(["c++filt", name], capture_output=True, text=True,
                              timeout=10).stdout.strip() or name
    except OSError:
        return name


def _chain_stamps(lib, n: int, tiles: int, hc: int):
    """Kernel 4's chain CTAs in the last launch of the ``stamps`` variant:
    per direction the SMs it ran on and its start and end (ms after the
    first CTA started), and how many CTAs of both ran at once at the latest
    start -> a line of text."""
    from eegflow_torch import kernels

    buf = np.zeros((STAMPS_MAX, 3), dtype=np.uint64)
    kernels.check(lib, lib.eegflow_ablate_stamps(
        buf.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(n)), "eegflow_ablate_stamps")
    per_dir = tiles * hc
    rec = buf[:2 * per_dir].astype(np.int64)
    t0 = rec[:, 1].min()
    parts = []
    for d, name in enumerate(("forward", "reverse")):
        r = rec[d * per_dir:(d + 1) * per_dir]
        parts.append(f"{name}: {len(np.unique(r[:, 0]))} SMs, starts "
                     f"{(r[:, 1].min() - t0) / 1e6:.3f}-{(r[:, 1].max() - t0) / 1e6:.3f} ms, "
                     f"ends {(r[:, 2].min() - t0) / 1e6:.3f}-{(r[:, 2].max() - t0) / 1e6:.3f} ms")
    last = rec[:, 1].max()
    running = int(((rec[:, 1] <= last) & (rec[:, 2] > last)).sum())
    both = len(np.unique(rec[:, 0]))
    return (f"{'; '.join(parts)}; {both} SMs in all; {running} of {2 * per_dir} CTAs "
            f"running at the latest start")


def _wide_marks(lib, entry: str = "eegflow_ablate_wide_marks") -> np.ndarray:
    """The "phases" variant's table of kernel 8's wide class (or, with
    ``entry`` ``eegflow_ablate_input_marks``, kernel 10's): cycles by phase
    1-15 and, at 16, the tiles counted."""
    from eegflow_torch import kernels

    buf = np.zeros(17, dtype=np.uint64)
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    kernels.check(lib, fn(buf.ctypes.data_as(ctypes.c_void_p)), entry)
    return buf.astype(np.int64)


def _phase_line(name: str, cycles: np.ndarray, phases=WIDE_PHASES) -> str:
    """A wide class: cycles a CTA tile by phase, with their shares."""
    tiles = max(int(cycles[16]), 1)
    total = max(cycles[1:len(phases) + 1].sum(), 1)
    return (f"phases {name}: {tiles} CTA tiles, {total / tiles:.0f} cycles a tile: "
            + ", ".join(f"{ph} {cycles[i + 1] / tiles:.0f} ({100 * cycles[i + 1] / total:.1f} %)"
                        for i, ph in enumerate(phases)))


def _device_ms_by_name(fn, reps: int = 5, warm_s: float = 0.5):
    """Mean device ms of a launch of each kernel a call of ``fn`` makes, by
    name, with the launches a call makes of it, after ``warm_s`` seconds of
    calls (the card's clocks settle under load), and the median SM clock
    (MHz) and the largest power draw (W) that ``nvidia-smi`` sampled every
    100 ms during the warm-up. The mean is over the launches the profiler
    recorded (it has dropped some of a session's launches on the H100
    machines), so the launches' times add up to the call's device time."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < warm_s:
            fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        samples = [tuple(float(v) for v in line.split(","))
                   for line in smi.communicate(timeout=10)[0].splitlines() if "," in line]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_time_total > 0]
    by_name = {}
    for e in events:
        ms, n = by_name.get(_launch_name(e.key), (0.0, 0))
        by_name[_launch_name(e.key)] = (ms + e.device_time_total / 1e3, n + e.count)
    by_name = {k: (ms / n, max(1, round(n / reps))) for k, (ms, n) in by_name.items()}
    clock = statistics.median(c for c, _ in samples) if samples else float("nan")
    power = max((w for _, w in samples), default=float("nan"))
    return by_name, clock, power


#: the LSTM products' GEMM (mma_gemm.cuh) named by the operand or epilogue
#: its template holds
GEMM_NAMES = (("MaskedXRows", "proj_gemm"), ("DxStore", "dx_gemm"),
              ("MaskedXCols", "dw_ih_gemm"), ("HPrevCols", "dw_hh_gemm"))


def _launch_name(key: str) -> str:
    """A launch's name in a profile: the LSTM products' GEMM by its role
    (:data:`GEMM_NAMES`), else the kernel's function name."""
    if "mma_gemm_kernel" in key:
        for part, name in GEMM_NAMES:
            if part in key:
                return name
    m = re.search(r"(\w+)(?:<[^>]*>)?\(", key)
    return m.group(1) if m else key


def sass_counts(library, function: str, leaf_loops: bool = False) -> Dict[str, Counter]:
    """The SASS (``cuobjdump -sass``) of the built ``library``'s kernels whose
    mangled name contains ``function``, by the pipe of :data:`SASS_PIPES` that
    issues each instruction -> {kernel: {"fma": n, "alu": n, "other": n}};
    with ``leaf_loops``, one entry a loop that holds no other loop (the body
    from a backward branch's target to the branch), named ``kernel @0xaddr``."""
    from eegflow_torch import kernels

    tool = Path(kernels._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(library)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    funcs, name, labels, pending = {}, None, {}, []
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            name = name if function in name else None
            if name:
                funcs[name], labels[name], pending = [], {}, []
            continue
        if name is None:
            continue
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            pending.append(label.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(.*)", line)
        if m and m.group(2) != "NOP":
            addr = int(m.group(1), 16)
            labels[name].update((lab, addr) for lab in pending)
            pending = []
            funcs[name].append((addr, m.group(2), m.group(3)))

    def by_pipe(instrs):
        return Counter({"fma": 0, "alu": 0, "other": 0}) + Counter(
            next((pipe for pipe, ops in SASS_PIPES.items() if op in ops), "other")
            for _, op, _ in instrs)

    out = {}
    for name, instrs in funcs.items():
        if not leaf_loops:
            out[name] = by_pipe(instrs)
            continue
        loops = []
        for addr, op, rest in instrs:
            t = re.search(r"(0x[0-9a-f]+)|\(?(\.L_x_\d+)\)?", rest) if op == "BRA" else None
            target = (int(t.group(1), 16) if t.group(1) else labels[name].get(t.group(2))) \
                if t else None
            if target is not None and target <= addr:
                loops.append((target, addr))
        for lo, hi in loops:
            if not any((a, b) != (lo, hi) and lo <= a and b <= hi for a, b in loops):
                out[f"{name} @{lo:#x}"] = by_pipe([i for i in instrs if lo <= i[0] <= hi])
    return out


#: kernel 11 at the fit: a DE population (popsize 15 x 6 rates), the
#: pipeline's 513 proportion points, 16 RK4 substeps; the DE mode's chunk
RK4_POP, RK4_POINTS, RK4_SUBSTEPS, RK4_CHUNK = 90, 513, 16, 64
#: the DE mode's populations timed by ``--calls rk4``: the default fit's, the
#: most the earlier one-CTA design held, popsize 171 and 500; a chunk of
#: RK4_CHUNK generations, fewer where their partner draws would pass
#: RK4_DE_BYTES
RK4_DE_POPS, RK4_DE_BYTES = (90, 1024, 1026, 3000), 2 ** 28


def _rk4_calls(dev, gen):
    """Kernel 11's modes at the fit's shape (B=90, 513 points, 16 substeps):
    the fit loss, the loss with tangents, the trajectory, and (where the tree
    has it) the DE mode running a chunk of generations on fixed draws from
    the same population each call, at each population of RK4_DE_POPS that
    the tree's DE mode takes (a population it refuses is printed and
    skipped)."""
    from eegflow_torch.core.config import ODEConfig
    from eegflow_torch.ode import cuda_ode

    n, pts, sub = RK4_POP, RK4_POINTS, RK4_SUBSTEPS
    rng = np.random.default_rng(0)
    lo, hi = (torch.tensor(v, dtype=torch.float32) for v in zip(*ODEConfig().bounds))
    k = (lo + torch.rand(n, 6, generator=gen) * (hi - lo)).to(dev)
    y0 = torch.tensor(rng.dirichlet([2.0] * 3, n), dtype=torch.float32, device=dev)
    obs = torch.tensor(rng.dirichlet([4.0] * 3, pts), dtype=torch.float32, device=dev)
    start = obs[0] / obs[0].sum()
    h = cuda_ode.step_sizes(0.0, float(pts - 1), pts, sub)
    calls = {f"apf_rk4 loss B={n}": lambda: cuda_ode.rk4_fit_loss(k, start, obs, sub, h, 1e-3),
             f"apf_rk4 loss with tangents B={n}":
                 lambda: cuda_ode.rk4_fit_loss(k, start, obs, sub, h, 1e-3, grad=True),
             f"apf_rk4 trajectory B={n}": lambda: cuda_ode.rk4_trajectory(y0, k, pts, sub, h)}
    if not hasattr(cuda_ode, "de_generations"):
        return calls, (n, pts, sub)
    dgen = torch.Generator(device=dev).manual_seed(0)
    for pop_n in RK4_DE_POPS:
        gens = max(1, min(RK4_CHUNK, RK4_DE_BYTES // (4 * pop_n * pop_n)))
        pop0 = (lo.to(dev) + torch.rand(pop_n, 6, generator=dgen, device=dev)
                * (hi - lo).to(dev))
        fit0 = cuda_ode.rk4_fit_loss(pop0, start, obs, sub, h, 1e-3)[0]
        draws = cuda_ode.GenerationDraws(
            torch.rand(gens, generator=dgen, device=dev),
            torch.rand(gens, pop_n, pop_n, generator=dgen, device=dev),
            torch.rand(gens, pop_n, 6, generator=dgen, device=dev),
            torch.randint(0, 6, (gens, pop_n), generator=dgen, device=dev))
        pop_c, fit_c = pop0.clone(), fit0.clone()

        def de_chunk(pop0=pop0, fit0=fit0, draws=draws, pop_c=pop_c, fit_c=fit_c):
            pop_c.copy_(pop0)
            fit_c.copy_(fit0)
            return cuda_ode.de_generations(pop_c, fit_c, lo.to(dev), hi.to(dev), draws, start,
                                           obs, sub, h, 1e-3, -1.0)

        try:
            de_chunk()
        except ValueError as err:
            print(f"apf_de B={pop_n}: refused ({err})", flush=True)
            continue
        calls[f"apf_de {gens} generations B={pop_n}"] = de_chunk
    return calls, (n, pts, sub)


def _apf_cycles(lib, batch: int, steps: int) -> str:
    """The ``stamps`` variant's cycles of kernel 11's last launch: each
    warp's, over its ``steps`` RK4 steps -> a line of text."""
    from eegflow_torch import kernels

    warps = -(-batch // 32)
    buf = np.zeros(warps, dtype=np.uint64)
    kernels.check(lib, lib.eegflow_ablate_apf_cycles(
        buf.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(warps)), "eegflow_ablate_apf_cycles")
    per_step = buf.astype(np.float64) / steps
    return (f"{warps} warps, cycles a step (per-point work included) "
            f"{per_step.min():.1f}-{per_step.max():.1f}")


def _fit_profile(dev, gen, card: str) -> None:
    """The fit without its polish at the fit's shape: 50 generations under
    ``torch.profiler`` (a generation's wall ms, kernel 11's device ms, the
    other launches' device ms, the device's idle share), and 1,000
    generations' wall time (tol -1: no generation passes the convergence
    test, so every generation runs in either design)."""
    from eegflow_torch.core.config import ODEConfig
    from eegflow_torch.fit import differential_evolution_fit, make_fit_loss

    obs = np.random.default_rng(1).dirichlet([4.0] * 3, RK4_POINTS).astype(np.float32)
    loss = make_fit_loss(torch.from_numpy(obs).to(dev), 0.0, float(RK4_POINTS - 1), RK4_POINTS,
                         substeps=RK4_SUBSTEPS, device=dev)
    bounds = ODEConfig().bounds

    def fit(gens):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = differential_evolution_fit(loss, bounds, maxiter=gens, tol=-1.0, polish=False)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    fit(50)  # warm-up: the build, the allocator, the profiler's first use
    base, _ = fit(0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall, (_, _, info) = fit(50)
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    apf = sum(b - a for a, b, nm in spans if "apf_" in nm) / 1e3
    other = sum(b - a for a, b, nm in spans if "apf_" not in nm) / 1e3
    busy, end = 0.0, None
    for a, b, _ in spans:
        busy += max(0.0, b - max(a, end if end is not None else a))
        end = b if end is None else max(end, b)
    gens = info["generations"]
    print(f"fit without polish, 50 generations (B={RK4_POP}, {RK4_POINTS} points, "
          f"{RK4_SUBSTEPS} substeps): wall {wall * 1e3:.3f} ms ({(wall - base) * 1e3 / gens:.3f} "
          f"ms a generation beyond the {base * 1e3:.3f} ms of 0 generations); device ms a "
          f"generation: kernel 11 {apf / gens:.3f}, other launches {other / gens:.3f}; device "
          f"idle {100 * (1 - busy / 1e3 / (wall * 1e3)):.2f} % of the wall; {len(spans)} device "
          f"spans [{card}]", flush=True)
    wall, (_, _, info) = fit(1000)
    print(f"fit without polish, {info['generations']} generations: wall {wall:.4f} s, "
          f"{wall * 1e3 / info['generations']:.4f} ms a generation [{card}]", flush=True)


def _philox_calls(dev, gen):
    """Kernels 2 (planes), 3 and 3b at B=512 with two parts of 256 on the
    keep-bit planes of a Philox source (streams 1 and 2, keep 0.7), drawn in
    each call, and on the uint8 masks it expands to."""
    from eegflow_torch.nn import cuda_lstm as cl
    from eegflow_torch.nn import philox

    bound = H ** -0.5

    def uniform(*shape):
        return ((torch.rand(shape, generator=gen) * 2 - 1) * bound).to(dev)

    keep, batch = 0.7, 512
    w_ih, w_hh, b = uniform(2 * H, 4 * H), uniform(H, 4 * H), uniform(4 * H)
    xs = tuple(torch.randn(batch, STEPS, H, generator=gen).to(dev) for _ in range(2))
    key = torch.randint(-2 ** 31, 2 ** 31 - 1, (2,), dtype=torch.int32, generator=gen)
    src = philox.PhiloxSource(key.to(dev), (1, 2))
    ms = src.masks(xs, keep)
    if hasattr(philox, "draw_keep_bits"):
        bits = lambda: philox.draw_keep_bits(src, xs, keep)  # noqa: E731
    else:  # the design before the plane: its wrappers take the source
        bits = lambda: src  # noqa: E731
    h, res = cl.lstm_fwd_train_plain(xs, w_ih, b, w_hh, False, ms, keep)
    hg, raw, c = cl.lstm_fwd_train_gates_plain(xs, w_ih, b, w_hh, False, ms, keep)
    g = 0.1 * torch.randn(h.shape, generator=gen).to(dev)
    calls = {}
    for mode, masks in (("philox", bits), ("uint8", lambda: ms)):
        calls[f"lstm_fwd_train {mode} B={batch}"] = (
            lambda m=masks: cl.lstm_fwd_train(xs, w_ih, b, w_hh, False, m(), keep))
        calls[f"lstm_bwd {mode} B={batch}"] = (
            lambda m=masks: cl.lstm_bwd(res, h, g, xs, w_ih, w_hh, False, m(), keep))
        calls[f"lstm_bwd_v2 {mode} B={batch}"] = (
            lambda m=masks: cl.lstm_bwd_v2(raw, c, hg, g, xs, w_ih, w_hh, False, m(), keep))
    return calls


def _head_calls(dev, gen):
    """The wide bf16 classes of kernels 8 and 7 (B=512, two parts of 512,
    K=512, LayerNorm: the classifier at hidden 512), kernel 9 (both modes at
    B=512, bf16 at 1024), kernel 10's float32 mode (B=512) and the float32
    modes of kernels 8 and 7 (B=512, two parts of 256, K=256, LayerNorm) at
    full width."""
    from eegflow_torch.nn.cuda_attention import pool_head_bwd, pool_head_fused
    from eegflow_torch.nn.cuda_input import input_block_bwd, input_block_fused

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    bound = CHANNELS ** -0.5
    proj = {"w": (torch.rand(CHANNELS, H, generator=gen) * 2 - 1).to(dev) * bound,
            "b": (torch.rand(H, generator=gen) * 2 - 1).to(dev) * bound}
    norm = {"scale": 1 + 0.1 * randn(H), "bias": 0.1 * randn(H)}
    x512, x1024 = randn(512, STEPS, CHANNELS), randn(1024, STEPS, CHANNELS)
    d, k = 2 * H, H
    ln = {"scale": 1 + 0.1 * randn(d), "bias": 0.1 * randn(d)}
    attn = {"proj": {"w": 0.05 * randn(d, k), "b": 0.1 * randn(k)},
            "score": {"w": 0.1 * randn(k, 1)}}
    pargs = (ln, attn, tuple(torch.tanh(randn(512, STEPS, H)) for _ in range(2)),
             torch.softmax(randn(512, STEPS), dim=-1), 0.01 * randn(512, STEPS),
             tuple(0.1 * randn(512, H) for _ in range(2)), 0.1 * randn(512), True, False)
    dy512 = randn(512, STEPS, H)
    # the wide bf16 classes at hidden 512 (chip_smoke.py phase 19's shapes)
    dw, kw = 4 * H, 2 * H
    lnw = {"scale": 1 + 0.1 * randn(dw), "bias": 0.1 * randn(dw)}
    attnw = {"proj": {"w": 0.05 * randn(dw, kw), "b": 0.1 * randn(kw)},
             "score": {"w": 0.1 * randn(kw, 1)}}
    wargs = (lnw, attnw, tuple(torch.tanh(randn(512, STEPS, 2 * H)) for _ in range(2)),
             torch.softmax(randn(512, STEPS), dim=-1), 0.01 * randn(512, STEPS),
             tuple(0.1 * randn(512, 2 * H) for _ in range(2)), 0.1 * randn(512), True, True)
    return {"pool_head_bwd bf16 wide B=512": lambda: pool_head_bwd(*wargs),
            "pool_head_fwd bf16 wide B=512": lambda: pool_head_fused(lnw, attnw, wargs[2], True,
                                                                     True),
            "input_block_fwd bf16 B=512": lambda: input_block_fused(proj, norm, x512, True),
            "input_block_fwd float32 B=512": lambda: input_block_fused(proj, norm, x512, False),
            "input_block_fwd bf16 B=1024": lambda: input_block_fused(proj, norm, x1024, True),
            "input_block_bwd float32 B=512": lambda: input_block_bwd(proj, norm, x512, dy512,
                                                                     False),
            "pool_head_bwd bf16 B=512": lambda: pool_head_bwd(*pargs[:-1], True),
            "pool_head_fwd bf16 B=512": lambda: pool_head_fused(ln, attn, pargs[2], True, True),
            "pool_head_bwd float32 B=512": lambda: pool_head_bwd(*pargs),
            "pool_head_fwd float32 B=512": lambda: pool_head_fused(ln, attn, pargs[2], True,
                                                                   False)}


#: kernel 8's and 7's widths at the edges of the wide bf16 class (parts, K):
#: the narrowest that pick it (D = 544, K = 288: halves of 272 columns, 144
#: columns of proj) and the widest (1024, 512); one part, two equal parts, and
#: two unequal ones whose boundary falls inside a CTA's half
WIDE_EDGE_PARTS = [((544,), 288), ((272, 272), 288), ((160, 384), 288), ((1024,), 512),
                   ((512, 512), 512), ((256, 768), 512)]


def wide_head_case(gen, widths, k, batch, steps, dev):
    """A pool-head case of these widths, drawn from ``gen`` (the card tests'
    draws): (LayerNorm params, attention params, parts (B, T, w), (softmax
    weights, score gradients, context gradient parts, gctx))."""
    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    d = sum(widths)
    ln = {"scale": 1 + 0.1 * randn(d), "bias": 0.1 * randn(d)}
    attn = {"proj": {"w": 0.03 * randn(d, k), "b": 0.1 * randn(k)},
            "score": {"w": 0.1 * randn(k, 1)}}
    xs = tuple(torch.tanh(randn(batch, steps, w)) for w in widths)
    grads = (torch.softmax(randn(batch, steps), dim=-1), 0.01 * randn(batch, steps),
             tuple(0.1 * randn(batch, w) for w in widths), 0.1 * randn(batch))
    return ln, attn, xs, grads


def pool_head_bwd_f64(ln, attn, xs, weights, g_scores, g_ctx, gctx, use_ln):
    """The function of ``nn.cuda_attention.pool_head_bwd_plain`` under bf16
    in float64: y, W1 and u rounded to bf16 where the twin rounds them, every
    other value and every sum in float64 -> its outputs in the twin's order
    (dh parts, dW1, db1, dw2[, dgamma, dbeta]), float64."""
    f = lambda t: t.to(torch.float64)  # noqa: E731
    r = lambda t: t.to(torch.bfloat16).to(torch.float64)  # noqa: E731
    widths = [p.shape[-1] for p in xs]
    x = torch.cat([f(p) for p in xs], dim=-1)
    d = x.shape[-1]
    if use_ln:
        mu = x.mean(-1, keepdim=True)
        rsig = torch.rsqrt((x * x).mean(-1, keepdim=True) - mu * mu + 1e-5)
        xhat = (x - mu) * rsig
        y = xhat * f(ln["scale"]) + f(ln["bias"])
    else:
        y = x
    w1 = r(attn["proj"]["w"])
    proj = torch.tanh(r(y) @ w1 + f(attn["proj"]["b"]))
    g = torch.cat([f(t) for t in g_ctx], dim=-1)
    ds = f(weights) * ((y * g[:, None, :]).sum(-1) - f(gctx)[:, None]) + f(g_scores)
    u = ds[..., None] * (1 - proj * proj) * f(attn["score"]["w"][:, 0])
    dy = f(weights)[..., None] * g[:, None, :] + r(u) @ w1.t()
    dw1 = r(y).reshape(-1, d).t() @ r(u).reshape(-1, w1.shape[1])
    sums = [dw1, u.sum(dim=(0, 1)), (ds[..., None] * proj).sum(dim=(0, 1))]
    if use_ln:
        dxh = dy * f(ln["scale"])
        dh = rsig * (dxh - dxh.mean(-1, keepdim=True) - xhat * (dxh * xhat).mean(-1, keepdim=True))
        sums += [(dy * xhat).sum(dim=(0, 1)), dy.sum(dim=(0, 1))]
    else:
        dh = dy
    return list(dh.split(widths, dim=-1)) + sums


def _lstm_adjoint_f64(step, g, w_hh, reverse):
    """dz (B, T, 4H) float64 of kernels 3, 3b and 4's chain against the
    direction of time: dh = g + dh_carry, ``step(t, dh, dc_carry) -> (dz row,
    dc, f)``, dc_carry = dc f, dh_carry = bf16(dz) . bf16(W_hh)^T (the only
    rounding on the chain, where the twin rounds), in float64."""
    f = lambda t: t.to(torch.float64)  # noqa: E731
    r = lambda t: t.to(torch.bfloat16).to(torch.float64)  # noqa: E731
    g = f(g)
    batch, steps, hidden = g.shape
    whh_t = r(w_hh).t()
    dh_c = torch.zeros(batch, hidden, dtype=torch.float64, device=g.device)
    dc_c = torch.zeros_like(dh_c)
    dz = torch.empty(batch, steps, 4 * hidden, dtype=torch.float64, device=g.device)
    for t in (range(steps) if reverse else range(steps - 1, -1, -1)):
        dh = g[:, t] + dh_c
        z, dc, forget = step(t, dh, dc_c)
        dc_c = dc * forget
        dz[:, t] = z
        dh_c = r(z) @ whh_t
    return dz


def _lstm_products_f64(dz, h, xs, w_ih, reverse, masks=None, keep=1.0):
    """The products of the bf16 backward kernels from the float64 dz, as
    ``nn.cuda_lstm._weight_products`` takes them: bf16(dz) against bf16
    W_ih parts, masked bf16 x (masked as the twin masks, in float32) and
    bf16 h_prev, the sums in float64; db the float64 dz's sum."""
    from eegflow_torch.nn.cuda_lstm import _expand, _mask_list, _shift, apply_mask

    f = lambda t: t.to(torch.float64)  # noqa: E731
    r = lambda t: t.to(torch.bfloat16).to(torch.float64)  # noqa: E731
    masks = _mask_list(_expand(masks, xs, keep), len(xs))
    batch, steps, g4 = dz.shape
    dz16 = r(dz).reshape(batch * steps, g4)
    dw_hh = r(_shift(h, reverse)).reshape(-1, g4 // 4).t() @ dz16
    widths = [p.shape[-1] for p in xs]
    dxs, dw_ih = [], []
    for x, m, w in zip(xs, masks, torch.split(w_ih, widths, dim=0)):
        dw_ih.append(r(apply_mask(x, m, keep)).reshape(-1, x.shape[-1]).t() @ dz16)
        dxs.append(apply_mask((dz16 @ r(w).t()).reshape(x.shape), m, keep))
    return tuple(dxs), torch.cat(dw_ih, dim=0), dw_hh, dz.sum(dim=(0, 1))


def lstm_bwd_f64(res, h, g, xs, w_ih, w_hh, reverse=False, masks=None, keep=1.0):
    """The function of ``nn.cuda_lstm.lstm_bwd_plain`` (kernel 3) in float64:
    dz rounded to bf16 where the twin rounds it (into dh_carry and the
    products), W_hh, W_ih, the masked x and h_prev in bf16, every other value
    and every sum in float64 -> (dx parts, dW_ih, dW_hh, db), float64."""
    res = res.to(torch.float64)
    hidden = w_hh.shape[0]

    def step(t, dh, dc_c):
        a, b, c, e, forget, gg = res[:, t].split(hidden, dim=-1)
        dc = dh * e + dc_c
        return torch.cat([dc * a, dc * b, dc * c, dh * gg], dim=-1), dc, forget

    dz = _lstm_adjoint_f64(step, g, w_hh, reverse)
    return _lstm_products_f64(dz, h, tuple(xs), w_ih, reverse, masks, keep)


def lstm_bwd_v2_f64(gates, c, h, g, xs, w_ih, w_hh, reverse=False, masks=None, keep=1.0):
    """The function of ``nn.cuda_lstm.lstm_bwd_v2_plain`` (kernel 3b) in
    float64: the raw gates and c as given, tanh(c) and every product in
    float64, bf16 rounding where :func:`lstm_bwd_f64` has it -> (dx parts,
    dW_ih, dW_hh, db), float64."""
    from eegflow_torch.nn.cuda_lstm import _shift

    gates = gates.to(torch.float64)
    hidden = w_hh.shape[0]
    gi, gf, gg, go = gates.split(hidden, dim=-1)
    tc, c_prev = torch.tanh(c.to(torch.float64)), _shift(c.to(torch.float64), reverse)

    def step(t, dh, dc_c):
        i, forget, gt, o, tct = gi[:, t], gf[:, t], gg[:, t], go[:, t], tc[:, t]
        dc = dh * o * (1 - tct * tct) + dc_c
        z = torch.cat([dc * gt * i * (1 - i), dc * c_prev[:, t] * forget * (1 - forget),
                       dc * i * (1 - gt * gt), dh * tct * o * (1 - o)], dim=-1)
        return z, dc, forget

    dz = _lstm_adjoint_f64(step, g, w_hh, reverse)
    return _lstm_products_f64(dz, h, tuple(xs), w_ih, reverse, masks, keep)


def lstm_bwd_dualdir_f64(res_f, h_f, g_f, res_r, h_r, g_r, xs, w_f, w_r):
    """The function of ``nn.cuda_lstm.lstm_bwd_dualdir_plain`` (kernel 4)
    without select dropout in float64: each direction's
    :func:`lstm_bwd_f64`, dx the forward direction's plus the reverse one's
    -> (dx parts, (dW_ih, dW_hh, db) forward, ... reverse), float64."""
    fwd = lstm_bwd_f64(res_f, h_f, g_f, xs, *w_f, reverse=False)
    rev = lstm_bwd_f64(res_r, h_r, g_r, xs, *w_r, reverse=True)
    return tuple(a + b for a, b in zip(fwd[0], rev[0])), fwd[1:], rev[1:]


def lstm_bwd_case(gen, hidden, widths, batch, steps, dev):
    """A layer-direction's backward case at these widths, drawn from ``gen``:
    weights uniform in +-1/sqrt(H) as ``classifier_init`` draws them, input
    parts (B, T, w) and the upstream gradient (B, T, H) normal -> (parts,
    (w_ih, b, w_hh) of the forward direction, ... of the reverse one, g of
    the forward direction, g of the reverse one)."""
    bound = hidden ** -0.5

    def uniform(*shape):
        return ((torch.rand(shape, generator=gen) * 2 - 1) * bound).to(dev)

    xs = tuple(torch.randn(batch, steps, w, generator=gen).to(dev) for w in widths)
    dirs = [(uniform(sum(widths), 4 * hidden), uniform(4 * hidden), uniform(hidden, 4 * hidden))
            for _ in range(2)]
    gs = [torch.randn(batch, steps, hidden, generator=gen).to(dev) for _ in range(2)]
    return xs, dirs[0], dirs[1], gs[0], gs[1]


def lstm_bwd_f64_holds(dev):
    """Kernels 3, 3b and 4 (and their twins) at B = 1, T = 256, H = 256 on
    two parts of 256 (a layer above the first), each on its own forward's
    residuals (the training-mode kernel 2 or its twin, by device), against
    :func:`lstm_bwd_f64`, :func:`lstm_bwd_v2_f64` and
    :func:`lstm_bwd_dualdir_f64` -> {kernel: (largest error of the kernel,
    of its twin), each relative to a gradient's largest entry}."""
    from eegflow_torch.core.prng import make_generator
    from eegflow_torch.nn import cuda_lstm as cl

    def worst(got, want):
        return max(((a.double() - c).abs().max() / c.abs().max()).item()
                   for a, c in zip(got, want))

    def flat(out):
        return list(out[0]) + [t for t in out[1:] if isinstance(t, torch.Tensor)] + [
            t for part in out[1:] if isinstance(part, tuple) for t in part]

    xs, (wf, bf, hf), (wr, br, hr), g_f, g_r = lstm_bwd_case(make_generator(2600), 256,
                                                             (256, 256), 1, 256, dev)
    out = {}
    h, res = cl.lstm_fwd_train(xs, wf, bf, hf)
    want = flat(lstm_bwd_f64(res, h, g_f, xs, wf, hf))
    out["lstm_bwd"] = tuple(worst(flat(fn(res, h, g_f, xs, wf, hf)), want)
                            for fn in (cl.lstm_bwd, cl.lstm_bwd_plain))
    h, gates, c = cl.lstm_fwd_train_gates(xs, wf, bf, hf)
    want = flat(lstm_bwd_v2_f64(gates, c, h, g_f, xs, wf, hf))
    out["lstm_bwd_v2"] = tuple(worst(flat(fn(gates, c, h, g_f, xs, wf, hf)), want)
                               for fn in (cl.lstm_bwd_v2, cl.lstm_bwd_v2_plain))
    hf_, res_f = cl.lstm_fwd_train(xs, wf, bf, hf)
    hr_, res_r = cl.lstm_fwd_train(xs, wr, br, hr, True)
    args = (res_f, hf_, g_f, res_r, hr_, g_r, xs, (wf, hf), (wr, hr))
    want = flat(lstm_bwd_dualdir_f64(*args))
    out["lstm_bwd_dualdir"] = tuple(worst(flat(fn(*args)), want)
                                    for fn in (cl.lstm_bwd_dualdir, cl.lstm_bwd_dualdir_plain))
    return out


def narrow_bwd_f64_holds(dev):
    """The narrow bf16 classes of kernels 8 and 10 (and their twins) at B = 1,
    T = 256 against :func:`pool_head_bwd_f64` (the classifier's head at H = 256:
    two parts of 256, K = 256, with and without LayerNorm) and
    :func:`input_block_bwd_f64` (C = 61, H = 256) -> {case: (largest error of
    the kernel, of its twin), each relative to a gradient's largest
    entry}."""
    from eegflow_torch.core.prng import make_generator
    from eegflow_torch.nn.cuda_attention import pool_head_bwd, pool_head_bwd_plain
    from eegflow_torch.nn.cuda_input import input_block_bwd, input_block_bwd_plain

    def worst(got, want):
        return max(((a.double() - c).abs().max() / c.abs().max()).item()
                   for a, c in zip(got, want))

    flat = lambda out: list(out[0]) + [t for t in out[1:] if t is not None]  # noqa: E731
    out = {}
    for use_ln in (False, True):
        gen = make_generator(2610 + int(use_ln))
        ln, attn, xs, grads = wide_head_case(gen, (256, 256), 256, 1, 256, dev)
        args = (ln if use_ln else None, attn, xs, *grads, use_ln)
        want = pool_head_bwd_f64(*args)
        out[f"pool_head_bwd LN {use_ln}"] = tuple(
            worst(flat(fn(*args, True)), want) for fn in (pool_head_bwd, pool_head_bwd_plain))
    gen = make_generator(2620)
    proj, norm = _input_params(gen, CHANNELS, 256, dev)
    x = torch.randn(1, STEPS, CHANNELS, generator=gen).to(dev)
    dy = torch.randn(1, STEPS, 256, generator=gen).to(dev)
    want = input_block_bwd_f64(proj, norm, x, dy)
    out["input_block_bwd"] = tuple(worst(fn(proj, norm, x, dy, True), want)
                                   for fn in (input_block_bwd, input_block_bwd_plain))
    return out


def _one_row_readings(card: str) -> None:
    """Kernel 8's wide class and its twin at B = 1, T = 256 against
    :func:`pool_head_bwd_f64`, on the cases of the card test
    ``test_pool_head_bwd_wide_cluster_on_one_long_row``: each side's largest
    error relative to a gradient's largest entry."""
    from eegflow_torch.core.prng import make_generator
    from eegflow_torch.nn.cuda_attention import pool_head_bwd, pool_head_bwd_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    flat = lambda out: list(out[0]) + [t for t in out[1:] if t is not None]  # noqa: E731
    for widths, k in WIDE_EDGE_PARTS:
        for use_ln in (False, True):
            gen = make_generator(400 + sum(widths) + k + 1 + 256 + int(use_ln))
            ln, attn, xs, grads = wide_head_case(gen, widths, k, 1, 256, torch.device("cuda"))
            args = (ln if use_ln else None, attn, xs, *grads, use_ln)
            want = pool_head_bwd_f64(*args)
            errs = [max(((a.double() - c).abs().max() / c.abs().max()).item()
                        for a, c in zip(flat(fn(*args, True)), want))
                    for fn in (pool_head_bwd, pool_head_bwd_plain)]
            print(f"pool_head_bwd bf16 wide B=1 T=256 parts {widths} K={k} LN {use_ln}: from "
                  f"the float64 function kernel {errs[0]:.3e}, twin {errs[1]:.3e} (relative to "
                  f"each gradient's largest entry) [{card}]", flush=True)


def _input_params(gen, channels, hidden, dev):
    """The input block's parameters as ``classifier_init`` draws them (W and b
    uniform in +-1/sqrt(C)), LayerNorm scale and bias near 1 and 0."""
    bound = channels ** -0.5
    proj = {"w": ((torch.rand(channels, hidden, generator=gen) * 2 - 1) * bound).to(dev),
            "b": ((torch.rand(hidden, generator=gen) * 2 - 1) * bound).to(dev)}
    norm = {"scale": (1 + 0.1 * torch.randn(hidden, generator=gen)).to(dev),
            "bias": (0.1 * torch.randn(hidden, generator=gen)).to(dev)}
    return proj, norm


def _input_calls(dev, gen):
    """Kernels 9 and 10 at ``chip_smoke.py`` phase 19's shapes (B=512, T=256,
    C=61): the bf16 forward and both classes of the bf16 backward, the narrow
    at H = 256 and the wide at H = 512, and the float32 backward at both."""
    from eegflow_torch.nn.cuda_input import input_block_bwd, input_block_fused

    x = torch.randn(512, STEPS, CHANNELS, generator=gen).to(dev)
    calls = {}
    for hidden in (256, 512):
        proj, norm = _input_params(gen, CHANNELS, hidden, dev)
        dy = torch.randn(512, STEPS, hidden, generator=gen).to(dev)
        cls = "narrow" if hidden <= 256 else "wide"
        calls[f"input_block_fwd bf16 H={hidden} B=512"] = (
            lambda p=proj, n=norm: input_block_fused(p, n, x, True))
        calls[f"input_block_bwd bf16 {cls} H={hidden} B=512"] = (
            lambda p=proj, n=norm, d=dy: input_block_bwd(p, n, x, d, True))
        calls[f"input_block_bwd float32 H={hidden} B=512"] = (
            lambda p=proj, n=norm, d=dy: input_block_bwd(p, n, x, d, False))
    return calls


def input_block_bwd_f64(proj, norm, x, dy):
    """The function of ``nn.cuda_input.input_block_bwd_plain`` under bf16 in
    float64: x, W and dz rounded to bf16 where the twin rounds them, every
    other value and every sum in float64 -> (dx, dW, db, dgamma, dbeta),
    float64."""
    from eegflow_torch.nn.cuda_input import LN_EPS, _gelu_grad

    f = lambda t: t.to(torch.float64)  # noqa: E731
    r = lambda t: t.to(torch.bfloat16).to(torch.float64)  # noqa: E731
    xr, wr, gamma = r(x).reshape(-1, x.shape[-1]), r(proj["w"]), f(norm["scale"])
    z = xr @ wr + f(proj["b"])
    mu = z.mean(-1, keepdim=True)
    rsig = torch.rsqrt((z * z).mean(-1, keepdim=True) - mu * mu + LN_EPS)
    xhat = (z - mu) * rsig
    dln = f(dy).reshape(z.shape) * _gelu_grad(xhat * gamma + f(norm["bias"]))
    dxhat = dln * gamma
    dz = rsig * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    dzr = r(dz)
    return ((dzr @ wr.t()).reshape(x.shape), xr.t() @ dzr, dz.sum(0), (dln * xhat).sum(0),
            dln.sum(0))


def _input_one_row_readings(card: str) -> None:
    """Kernel 10's wide class and its twin at B = 1, T = 256, C = 61, H = 512
    (one row tile) against :func:`input_block_bwd_f64`: each side's largest
    error relative to a gradient's largest entry."""
    from eegflow_torch.core.prng import make_generator
    from eegflow_torch.nn.cuda_input import input_block_bwd, input_block_bwd_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    for seed in range(3):
        gen = make_generator(700 + seed)
        proj, norm = _input_params(gen, CHANNELS, 512, dev)
        x = torch.randn(1, STEPS, CHANNELS, generator=gen).to(dev)
        dy = torch.randn(1, STEPS, 512, generator=gen).to(dev)
        want = input_block_bwd_f64(proj, norm, x, dy)
        errs = [max(((a.double() - c).abs().max() / c.abs().max()).item()
                    for a, c in zip(fn(proj, norm, x, dy, True), want))
                for fn in (input_block_bwd, input_block_bwd_plain)]
        print(f"input_block_bwd bf16 wide B=1 T={STEPS} C={CHANNELS} H=512 seed {700 + seed}: "
              f"from the float64 function kernel {errs[0]:.3e}, twin {errs[1]:.3e} (relative "
              f"to each gradient's largest entry) [{card}]", flush=True)


def _step_calls(dev):
    """Whole-path timings around the pool-head kernels: one bf16 micro-step
    (forward and backward, ``"fused"``, dropout masks, B=512, T=256) of
    ``ModelConfig()`` at hidden 256 (``chip_smoke.py`` phase 9's) and at
    hidden 512 (phase 19's), and one bf16 classifier evaluation at B=1024
    (phase 6's bucket), on random weights and windows."""
    from eegflow_torch.core.config import ModelConfig
    from eegflow_torch.core.prng import make_generator
    from eegflow_torch.nn.losses import cross_entropy_loss
    from eegflow_torch.nn.model import classifier_apply, classifier_init, draw_dropout_masks

    gen = torch.Generator(device="cpu").manual_seed(9)
    x = torch.randn(1024, STEPS, CHANNELS, generator=gen).to(dev)
    y = (torch.rand(512, generator=gen) < 0.5).long().to(dev)
    calls = {}
    for hidden in (256, 512):
        cfg = ModelConfig(input_size=CHANNELS, hidden_size=hidden)
        params = classifier_init(cfg, make_generator(9), device=dev, trainable=True)
        masks = draw_dropout_masks(cfg, 512, STEPS, torch.Generator(device=dev).manual_seed(9),
                                   dev)

        def step(params=params, cfg=cfg, masks=masks):
            for q in params.parameters():
                q.grad = None
            logits = classifier_apply(params, x[:512], cfg, compute_dtype=torch.bfloat16,
                                      lstm_impl="kernel", train=True, masks=masks)
            cross_entropy_loss(logits, y).backward()

        calls[f"micro-step hidden {hidden} B=512"] = step
    cfg = ModelConfig(input_size=CHANNELS)
    eparams = classifier_init(cfg, make_generator(6), device=dev)

    def infer():
        with torch.no_grad():
            classifier_apply(eparams, x, cfg, compute_dtype=torch.bfloat16, lstm_impl="kernel")

    calls["classifier eval hidden 256 B=1024"] = infer
    return calls


def _event_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event ms of a call of ``fn``, after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _ablate_stage_s(windows: int = 4096) -> float:
    """Host seconds of the CLI stage ``ablate --hidden 512 --epochs 1`` on the
    card, on a processed set of ``windows`` training windows (and an eighth
    as many validation and a quarter as many test windows) of 256 x 61 from
    a numpy seed."""
    from eegflow_torch.cli.main import main as cli_main
    from eegflow_torch.core.artifacts import save_processed, save_results

    rng = np.random.default_rng(19)
    arrays = {}
    for split, n in (("train", windows), ("val", windows // 8), ("test", windows // 4)):
        yy = np.arange(n) % 2
        xx = rng.standard_normal((n, STEPS, CHANNELS)).astype(np.float32)
        xx[:, :, 0] += (yy - 0.5).astype(np.float32)[:, None]
        arrays[f"X_{split}"], arrays[f"y_{split}"] = xx, yy.astype(np.int64)
    out = Path(tempfile.mkdtemp(prefix="eegflow_ablate_stage_"))
    try:
        save_processed(out / "processed_data", arrays, {})
        save_results(out / "results" / "coupling_analysis.json", {"alphas": [0.0]})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli_main(["--output-dir", str(out), "ablate", "--hidden", "512", "--epochs", "1",
                       "--device", "cuda"])
        torch.cuda.synchronize()
        if rc not in (0, None):
            raise RuntimeError(f"ablate stage returned {rc}")
        return time.perf_counter() - t0
    finally:
        shutil.rmtree(out, ignore_errors=True)


def _filter_calls(dev, gen):
    """Kernel 12 on 61 channels of 20,000 and of 60,000 samples (a 120 s
    recording at 500 Hz), the default 4th-order bandpass: 4 sections."""
    from eegflow_torch.signal.filters import _sos_design, butter_bandpass, sos_filtfilt

    sos, zi, padlen = _sos_design(*butter_bandpass(1.0, 45.0, 500.0, 4))
    calls = {}
    for samples in (20_000, 60_000):
        x = torch.randn(CHANNELS, samples, generator=gen).to(dev)
        calls[f"sos_filtfilt {CHANNELS} x {samples}"] = (
            lambda x=x: sos_filtfilt(x, sos, zi, padlen))
    return calls


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="eegflow_torch.kernels.ablate")
    parser.add_argument("--variant", default="base", choices=sorted(VARIANTS))
    parser.add_argument("--rows", default=None, help="rows per cluster the plan may take")
    parser.add_argument("--calls", default="all",
                        choices=("all", "recurrent", "head", "input", "filter", "philox",
                                 "rk4", "steps"))
    parser.add_argument("--csrc", default=None,
                        help="build from this kernel source directory (another tree's)")
    parser.add_argument("--save", default=None,
                        help="save the backward kernels' and kernel 12's outputs to this file")
    parser.add_argument("--against", default=None,
                        help="compare those outputs bit for bit with a --save file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("ablate: needs a CUDA device", file=sys.stderr)
        return 2
    from eegflow_torch import kernels
    from eegflow_torch.nn import cuda_lstm as cl

    if args.rows:
        cl.restrict_plan_rows(int(r) for r in args.rows.split(","))
    tmp = Path(tempfile.mkdtemp(prefix="eegflow_ablate_"))
    try:
        lib = kernels.load_library(patched_sources(args.variant, tmp, args.csrc), tmp / "build")
        if args.variant == "stamps":
            lib.eegflow_ablate_stamps.restype = ctypes.c_int
            lib.eegflow_ablate_apf_cycles.restype = ctypes.c_int
        if args.calls in ("all", "recurrent"):
            for line in _ptxas_report(kernels.build_info.get("log", "")):
                print(f"ptxas {line}", flush=True)
        if args.calls in ("all", "head"):
            for line in _ptxas_report(kernels.build_info.get("log", ""), "pool_head"):
                print(f"ptxas {line}", flush=True)
        if args.calls == "input":
            for line in _ptxas_report(kernels.build_info.get("log", ""), "input_block"):
                print(f"ptxas {line}", flush=True)
            if hasattr(lib, "eegflow_input_block_bwd_bf16_plan"):  # not in older trees
                from eegflow_torch.nn.cuda_input import input_block_bwd_bf16_plan

                for channels, hidden in ((CHANNELS, 256), (CHANNELS, 512)):
                    print(f"plan input_block_bwd bf16 C={channels} H={hidden}: "
                          f"{input_block_bwd_bf16_plan(channels, hidden)}", flush=True)
        if args.calls == "philox":
            for line in _ptxas_report(kernels.build_info.get("log", ""),
                                      r"mma_gemm_kernel.*Mask(Philox|U8|Bits)|philox_keep_bits"):
                print(f"ptxas {line}", flush=True)
        if args.calls == "rk4":
            for line in _ptxas_report(kernels.build_info.get("log", ""), "apf_"):
                print(f"ptxas {line}", flush=True)
            library = kernels.build_info["library"]
            for loops in (False, True):
                for name, c in sass_counts(library, "apf_", loops).items():
                    if sum(c.values()) >= 20:
                        print(f"sass {'leaf loop' if loops else 'kernel'} {_demangle(name)}: "
                              f"{sum(c.values())} instructions, fma pipe {c['fma']}, alu pipe "
                              f"{c['alu']}, other {c['other']}", flush=True)
        dev = torch.device("cuda", 0)
        gen = torch.Generator(device="cpu").manual_seed(0)
        bound = H ** -0.5

        def uniform(*shape):
            return ((torch.rand(shape, generator=gen) * 2 - 1) * bound).to(dev)

        w_ih, w_hh, b = uniform(2 * H, 4 * H), uniform(H, 4 * H), uniform(4 * H)
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip()
        outputs = {}
        for batch in (16, 512, 1024) if args.calls in ("all", "recurrent") else ():
            xs = tuple(torch.randn(batch, STEPS, H, generator=gen).to(dev) for _ in range(2))
            ms = tuple((torch.rand(batch, STEPS, H, generator=gen) < 0.7).to(torch.uint8)
                       .to(dev) for _ in range(2))
            gates = (torch.cat(xs, dim=-1) @ w_ih + b).contiguous()
            calls = {"lstm_fwd": (lambda: cl.lstm_fwd_fused_proj(xs, w_ih, b, w_hh),
                                  ("fwd", batch, H, 0)),
                     "lstm_rec_fwd": (lambda: cl.lstm_recurrence(gates, w_hh),
                                      ("rec", batch, H, 0))}
            if batch < 1024:
                h, res = cl.lstm_fwd_train_plain(xs, w_ih, b, w_hh, False, ms, 0.7)
                g = 0.1 * torch.randn(h.shape, generator=gen).to(dev)
                calls["lstm_fwd_train"] = (
                    lambda: cl.lstm_fwd_train(xs, w_ih, b, w_hh, False, ms, 0.7),
                    ("fwd", batch, H, 1))
                calls["lstm_bwd"] = (
                    lambda: cl.lstm_bwd(res, h, g, xs, w_ih, w_hh, False, ms, 0.7),
                    ("bwd", batch, H))
                hg, raw, c = cl.lstm_fwd_train_gates_plain(xs, w_ih, b, w_hh, False, ms, 0.7)
                calls["lstm_bwd_v2"] = (
                    lambda: cl.lstm_bwd_v2(raw, c, hg, g, xs, w_ih, w_hh, False, ms, 0.7),
                    ("bwd_v2", batch, H))
                # training mode writes z over its gates: each call gets a copy
                calls["lstm_rec_fwd_train"] = (
                    lambda: cl.lstm_recurrence(gates.clone(), w_hh, False, True),
                    ("rec", batch, H, 1))
                z = gates.clone()
                hr, cr = cl.lstm_recurrence_plain(z, w_hh, False, True)
                calls["lstm_rec_bwd"] = (
                    lambda: cl.lstm_recurrence_backward(z, hr, cr, w_hh, g), ("rec_bwd", batch, H))
                calls["lstm_bwd_dualdir"] = (
                    lambda: cl.lstm_bwd_dualdir(res, h, g, res, h, g, xs, (w_ih, w_hh),
                                                (w_ih, w_hh)),
                    ("bwd_dualdir", batch, H))
            for name, (fn, plan_args) in calls.items():
                if name in BIT_CALLS:
                    outputs[f"{name} B={batch}"] = _flat_cpu(fn())
                plan = cl.kernel_plan(*plan_args)
                ms_rec = _recurrence_ms(fn)
                print(f"{args.variant} {name} B={batch}: rows {plan.rows}, "
                      f"{plan.clusters} clusters in {plan.waves} wave(s); recurrence "
                      f"{ms_rec:.3f} ms, {ms_rec / STEPS * 1e3:.2f} us a step [{card}]",
                      flush=True)
                if args.variant == "stamps" and name == "lstm_bwd_dualdir":
                    print(f"stamps {name} B={batch}: "
                          f"{_chain_stamps(lib, STAMPS_MAX, plan.tiles, plan.hc)}", flush=True)
        head = _head_calls(dev, gen) if args.calls in ("all", "head") else {}
        if args.calls in ("all", "filter"):
            head.update(_filter_calls(dev, gen))
        if args.calls == "philox":
            head.update(_philox_calls(dev, gen))
        if args.calls == "input":
            head.update(_input_calls(dev, gen))
        rk4_shape = None
        if args.calls == "rk4":
            rk4_calls, rk4_shape = _rk4_calls(dev, gen)
            head.update(rk4_calls)
        for name, fn in head.items():
            if name.startswith("sos_filtfilt") or (args.calls == "philox"
                                                   and not args.variant.startswith("nodraw")) \
                    or (name.startswith("pool_head") and " bf16 " in name) \
                    or name.startswith("input_block"):
                outputs[name] = _flat_cpu(fn())
            marks = args.variant == "phases" and (name.startswith("pool_head_bwd bf16 wide")
                                                  or name.startswith("input_block_bwd bf16 wide"))
            entry, phases = (("eegflow_ablate_input_marks", INPUT_PHASES)
                             if name.startswith("input_block") else
                             ("eegflow_ablate_wide_marks", WIDE_PHASES))
            if marks:
                before = _wide_marks(lib, entry)
            by_name, clock, power = _device_ms_by_name(fn)
            if marks:
                print(_phase_line(name, _wide_marks(lib, entry) - before, phases), flush=True)
            print(f"{args.variant} {name}: device ms a launch by kernel: "
                  + ", ".join(f"{k} {v:.3f}" + (f" x{n}" if n > 1 else "")
                              for k, (v, n) in by_name.items())
                  + f"; a call {sum(v * n for v, n in by_name.values()):.3f}"
                  + f"; during the warm-up SM clock {clock:.0f} MHz (median), power up to "
                  f"{power:.1f} W [{card}]", flush=True)
            if args.calls == "input":
                print(f"{args.variant} {name}: {_event_ms(fn):.3f} ms a call (CUDA events, "
                      f"median of 5) [{card}]", flush=True)
            if name.startswith("apf_de"):
                gens = int(name.split()[1])
                print(f"{args.variant} {name}: {sum(v * n for v, n in by_name.values()) / gens:.4f} "
                      f"device ms a generation, {_event_ms(fn) / gens:.4f} by CUDA events (median "
                      f"of 5 calls) [{card}]", flush=True)
            if rk4_shape and args.variant == "stamps" and not name.startswith("apf_de"):
                fn()
                torch.cuda.synchronize()
                batch, pts, sub = rk4_shape
                print(f"stamps {name}: {_apf_cycles(lib, batch, (pts - 1) * sub)}", flush=True)
        if args.calls == "head":
            _one_row_readings(card)
        if args.calls == "input" and args.variant == "base":
            _input_one_row_readings(card)
        if args.calls == "rk4":
            _fit_profile(dev, gen, card)
        if args.calls == "steps":
            for name, fn in _step_calls(dev).items():
                print(f"{args.variant} {name}: {_event_ms(fn):.3f} ms (CUDA events, median of 5) "
                      f"[{card}]", flush=True)
            print(f"{args.variant} ablate --hidden 512 --epochs 1 stage: "
                  f"{_ablate_stage_s():.2f} s [{card}]", flush=True)
        for name in [n for n in outputs if " philox " in n]:
            twin = name.replace(" philox ", " uint8 ")
            same = all(torch.equal(a, b) for a, b in zip(outputs[name], outputs[twin]))
            print(f"bits {name}: equal to the uint8 mode's: {same}", flush=True)
        if args.save:
            torch.save(outputs, args.save)
        if args.against:
            want = torch.load(args.against)
            for key, got in outputs.items():
                same = key in want and len(want[key]) == len(got) and all(
                    torch.equal(a, b) for a, b in zip(got, want[key]))
                print(f"bits {key}: equal to {args.against}'s: {same}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
