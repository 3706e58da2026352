#!/usr/bin/env python3
"""Smoke test of eegflow_torch on one NVIDIA GPU (Hopper, sm_90a).

Run from the root of the repository:  python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and exits non-zero:
  1. the card (nvidia-smi name and power limit); requires CUDA;
  2. builds the CUDA kernels from eegflow_torch/csrc with nvcc and prints
     ptxas's register, spill and shared-memory report, and the cluster plan
     of each recurrent kernel at the main path's shapes (rows per cluster,
     cudaOccupancyMaxActiveClusters, waves, resident weight rows, shared
     memory): kernel 2's three modes, kernels 3, 3b and 4 at B=512, kernel 1
     (float32) in training mode at B=512 and in eval mode at B=512 and 1024,
     kernel 5 (float32) at B=512;
  3. lstm_fwd against its plain twin at B=64, T=256, H=256, one and two
     input parts, both directions, and bitwise against itself;
  4. pool_head_fwd against its plain twin: two parts of 256, K=256, T=256;
  5. serves a full-width coupled model (61 -> 256, 3 bidirectional layers,
     T=256, random weights from a seed) over HTTP on 127.0.0.1: /health and
     three /predict requests of 1, 7 and 33 windows; checks the answers, the
     kernel launch counts (1 input_block_fwd, 6 lstm_fwd, 1 pool_head_fwd per
     batch), and the probabilities against the plain path;
  6. times predict_batch at the 1024 bucket on the kernel path and the
     plain path (CUDA events), and each kernel against its twin; lstm_fwd at
     B=1024 (the cluster plan serving launches), pool_head_fwd in bf16
     mode (tensor cores) and input_block_fwd in bf16 mode at B=1024 are also
     held to their twins and to a bitwise repeat, and pool_head_fwd in float32
     mode (3xTF32; the float32 served batch) held likewise and its launch
     timed with torch.profiler;
  7. the bf16 training kernels against their twins at B=64, T=256, H=256:
     lstm_fwd in training mode (masks, residual planes) and lstm_bwd, each
     also bitwise against itself, and pool_head_bwd in its bf16 (tensor
     cores) and float32 modes;
  8. trains through the `train` stage of the CLI (in-process) on a
     synthetic processed_sequences.npz (2048 training windows of 256 x 61,
     2 epochs, full-width ModelConfig, default TrainConfig: bf16); checks the
     kernel launches per micro-step (1 input_block_fwd, 1 input_block_bwd,
     6 lstm_fwd_train, 6 lstm_bwd, 1 pool_head_fwd, 1 pool_head_bwd) and per
     eval batch, the finite loss, the written artifacts, and that the serve
     loader reads the checkpoint;
  9. one bf16 training micro-step at B=512 on the kernel path against the
     plain path from identical params and masks (loss and every gradient), a
     second kernel run bitwise identical; holds lstm_fwd_train and lstm_bwd
     at B=512 (the plans the micro-step launches), pool_head_fwd and
     pool_head_bwd in bf16 mode at B=512, T=256, D=512, K=256 to their twins
     and to a bitwise repeat; then times the micro-step on both paths and
     each training kernel against its twin at B=512 (pool_head_fwd too);
 10. the float32 policy's kernels against their twins: lstm_rec_fwd (eval and
     training mode, each also bitwise against itself; training mode's z
     written over the gates) and lstm_rec_bwd on that z at B=64, T=256,
     H=256 on the gates of one- and two-part inputs, both directions;
     input_block_fwd and input_block_bwd in both modes;
     attention_pool at D=256;
 11. attention_pool through its entry point, attention_pool_apply, at B=512,
     T=256, D=256 (no classifier path calls it), against its twin;
 12. the `train` stage with --config {"train": {"bf16": false}} for 1 epoch on
     a synthetic set: launches per micro-step (1 input_block_fwd,
     1 input_block_bwd, 6 lstm_rec_fwd_train, 6 lstm_rec_bwd, 1 pool_head_fwd,
     1 pool_head_bwd) and per eval batch (6 lstm_rec_fwd), the serve loader on
     its checkpoint, and coupled_rollout(bf16=False) on it, kernel path
     against plain path;
 13. one float32 micro-step at B=512, kernel path against plain path (loss,
     every gradient, bitwise repeat), timed on both paths and in turns with
     the bf16 "fused" step; lstm_rec_fwd on the plans the main path launches
     (training at B=512, with the z it leaves over the gates, and eval at
     B=512 and 1024) and lstm_rec_bwd on its B=512 plan held to their twins
     and to a bitwise repeat; input_block_bwd in both modes (bf16 on the
     tensor cores, float32 in 3xTF32), input_block_fwd in both modes,
     pool_head_bwd and pool_head_fwd in float32 mode (3xTF32) at B=512 held to
     their twins and to bitwise repeats, and their launches (kernel 10's row
     kernel and partial-row reduction, kernel 8's kernel, dW1 GEMM and
     reductions) timed apart with torch.profiler; each float32
     kernel (and the input block and pool_head_fwd in both modes) timed
     against its twin, lstm_rec_fwd eval also at B=1024;
 14. the kernels of the two other bf16 backward schedules against their
     twins at B=64, T=256, H=256, one and two parts: lstm_fwd_train_gates
     (h, gates, c; both directions; bitwise repeat), lstm_bwd_v2 on the same
     residuals (masks, dx_add, bitwise repeat), lstm_bwd_dualdir with and
     without mask_from_x (bitwise repeat) and, without dropout, against two
     lstm_bwd launches (bit for bit: the two share their chain and products);
 15. one bf16 micro-step at B=512 under lstm_bwd="two_pass" and under
     "dualdir", kernel path against plain path (loss, every gradient, bitwise
     repeat, exact launch counts), each timed in turns against "fused", and
     lstm_bwd_v2 and lstm_bwd_dualdir timed at B=512 against their twins and
     against kernel 3 on the same work; lstm_fwd_train_gates, lstm_bwd_v2
     (two parts, dx_add) and lstm_bwd_dualdir at B=512 held to their twins
     and to bitwise repeats,
     and lstm_bwd_dualdir without dropout to two lstm_bwd launches bit for
     bit; then one cuDNN LSTM call per LSTM kernel at its shape as a
     yardstick (never on the port's path).
 16. kernels 3, 3b and 4 and the narrow bf16 classes of kernels 8 and 10 at
     B=1, T=256 against their functions in float64 (kernels.ablate), both
     sides' distances printed; kernels 11 and 12 against their twins:
     apf_rk4 (a DE population of 90, 200 points, 16 substeps) in trajectory
     mode, loss mode and loss mode with tangents, each bitwise repeatable,
     and its cycles a step from the loss mode's time and the SM clock; its
     DE mode (apf_de) against its twin, the loop of generations on the loss
     mode, bit for bit and repeated, at 513 points: a population of 90 that
     converges, 64 not dividing 100 generations, n = 18, 90, 1,026 and 3,000
     (apf_de_grid_kernel over 33 and 94 CTAs, chunks of 63 and 7 by the draws'
     byte budget); the plan from C and the ms a generation at n = 90, 1,026
     and 3,000; sos_filtfilt on 61 x 20,000
     samples (bitwise repeatable), and bandpass_filter(method="filtfilt") on a
     61 x 60,000 recording against scipy's float64 filtfilt; their times
     beside their chain bounds;
 17. the pipeline from raw recordings to a served model, every step a CLI
     call on the card in one temporary directory: synth (12 subjects x 120 s
     per task, 61 channels at 500 Hz), preprocess (default fft filter),
     train --epochs 1 (default TrainConfig, bf16 "fused"), fit-ode (default
     ODEConfig: one apf_rk4 launch for the first population, one apf_de a
     chunk of 64 generations, apf_rk4 for the polish, nothing else; the
     launches and the stage time printed), serve in its own process with a
     --config whose coupling sets strength 0.8 and 30 forecast steps; the
     served answers equal predict_batch at that coupling and differ from the
     default coupling's; prints each stage's time, the windows per split,
     the proportion points, the fit and which of scipy, pandas and sklearn
     import; then times apf_rk4 and its twin at the fit's shape, and holds
     the fit's whole DE (1,000 generations on the pipeline's series) in
     apf_de to its twin bit for bit, repeated, timing both and a chunk;
 18. the analysis stages on phase 17's artifacts (its directory lives until
     this phase ends), each a CLI call on the card: integrate, explain at its
     defaults (KernelSHAP included), forecast and export; checks each
     stage's launches (integrate, forecast and export only input_block_fwd,
     lstm_fwd and pool_head_fwd; explain also one backward: 1
     input_block_bwd, 6 lstm_fwd_train, 6 lstm_bwd, 1 pool_head_bwd), holds
     one KernelSHAP evaluation (B=10,000 time-tiled rows) and one permuted
     stack (B=5,000) to the plain path (P(closed)) and to a bitwise repeat,
     and the B=100 input gradients likewise; checks the sweep's accuracy
     against integrate's, the importances, shap_values.npy, the
     efficiency identity and three rows evaluated in flight against
     synchronous evaluations of their coalitions, the forecast's
     trajectories against solve_ivp and the export CSVs against
     predict_batch; prints each stage's and each attribution's time and
     windows/s, the peak device memory of the B=10,000 evaluation, its
     device time a window beside B=1,024's, and the kernel-shap step's
     device idle share (the device time of its classifier forwards, by CUDA
     events around each in the stage, against its wall time).
 19. the ablate stage on phase 17's processed set (and phase 18's
     coupling_analysis.json), a CLI call on the card at its defaults but
     --epochs 4 (six variants at hidden 256, bf16) and one with --hidden 512
     --epochs 1: each variant's launches per micro-step (1 input_block_fwd,
     1 input_block_bwd, one lstm_fwd_train and one lstm_bwd a layer and
     direction, the pool_head_fwd/pool_head_bwd pair with attention) and per
     eval batch, its training seconds, windows/s and test accuracy, the
     stage's seconds, sensitivity_analysis.json against the reference's
     contracts; one B=512 bf16 micro-step of each variant at hidden 256 and of
     the Full Model at hidden 512 against the plain path (phase 9's
     tolerances) and a bitwise repeat; kernels 7, 8 and 10 in their wide bf16
     classes (D = 1024, K = 512; C = 61, H = 512) and kernel 9 on its 32-row
     tiles at B=512 held to their twins and bitwise repeats and timed beside
     them; kernel 8's and kernel 10's wide launches read from their C entry
     points (row kernel, cluster, tile rows, shared memory; kernel 10 also the
     clusters the card holds) and required to be the two-CTA clusters.
 20. the EEGFormer and the snapshots on phase 17's processed set: `train --model
     transformer --epochs 1` as a CLI call (1 input_block_fwd, 1 input_block_bwd,
     1 pool_head_fwd and 1 pool_head_bwd a micro-step, 1 input_block_fwd and
     1 pool_head_fwd an eval batch, no LSTM kernel), `serve` of its checkpoint
     in its own process (one /predict batch against the plain path),
     `explain --skip-shap` on it (launches exact); one B=512 micro-step of
     TransformerConfig() (4 layers, D=256) under bf16 against the plain path
     (a bitwise repeat, timed, its device time by kernel and the GEMMs' share)
     and under float32; evals at B=1,024 (against the plain path) and 10,000
     (us a window, peak memory); kernels 9, 10, 7 and 8 in both modes at the
     transformer's shapes (one part of 256, K=128) against their twins; a run
     of the flagship (bf16 "fused") and of the transformer, 2 epochs on 2,048
     windows, interrupted after epoch 1 and resumed from its snapshot, against
     the uninterrupted run (train_state.msgpack byte for byte).
 21. explore and the baselines' features on phase 17's tree: `explore` as a
     CLI call on its raw recordings (eda_summary.json's keys and census, its
     alpha closed/open ratio against scipy's float64 welch on the same
     channel, no kernel launched, the stage's seconds); welch_psd on the card
     on both full recordings (61 x 60,000) against scipy and against its own
     CPU run; load_or_extract_features on the three processed splits on the
     card, writing models/features_{split}.npz as the baselines stage does,
     against a float64 oracle (the zcr's differing entries counted apart), a
     bitwise repeat and the cache read back; extract_features timed on 50,000
     N(0,1) windows (windows/s, device ms a chunk, the pageable upload's share,
     the bound of one read of a chunk); whether sklearn imports and whether
     matplotlib is installed (no estimator runs without sklearn: the
     baselines, parity and all stages stop there on the GPU machine).
     In phases 17-21 each stage that draws figures in the JAX package
     (explore, preprocess, baselines, train, fit-ode, integrate, explain,
     forecast, ablate) is checked for them: where matplotlib is not installed
     it printed its skip line once and wrote no file under figures/ (and no
     phase imports matplotlib), where it is installed it drew.
 22. `train --profile DIR --epochs 1` as a CLI call on a synthetic processed
     set (phase 8's windows, 1,024 for training): the Chrome trace parsed and
     searched for the default bf16 path's hand-written kernels (lstm_fwd in
     planes mode, lstm_bwd, pool_head_fwd, pool_head_bwd, input_block forward
     and backward; presence, since the profiler drops launches), its size and
     the run's wall time; fig10's series (ode_analysis_series: one apf_rk4
     launch in trajectory mode, 3 initial states x 120 points, and the steady
     state) against its CPU twin; Timer/timed around one served batch and
     compute_metrics on its decisions against analyze/evaluate.py.
 23. the data mesh (eegflow_torch/train/mesh.py) in spawned ranks that load
     the library phase 2 built: (a) NCCL at world size 1: one B=512 bf16
     micro-step of make_train_step(mesh=) against the step without a mesh
     from the same params and masks, loss and every gradient bit for bit,
     its launches phase 9's, both timed in turns and the 18 MB gradient
     all-reduce apart; (b) gloo with two ranks sharing cuda:0 (NCCL refuses
     two ranks on one device; no scaling is measured): a micro-step at
     global B=512 against the single-process step (loss, every gradient),
     four micro-steps (one AdamW update) leaving the ranks' params bitwise
     equal, each rank's launches a micro-step and an eval batch,
     train_classifier(mesh=) for 1 epoch on 2,048 windows (finite history,
     best params bitwise equal on the ranks), predict_probs on 10,000
     windows, predict_batch on 1,024 and 1,000, the coupling sweep, the
     permutation importance (n = 1,000) and multistep_forecast with the mesh
     against without it; each rank's micro-step, the gloo all-reduce and the
     global mask draw timed.
 24. the bf16 stack's option res_bf16 (EEGFLOW_RES_BF16=1: bf16 residual
     planes or raw gates): (a) at B=64, T=256, H=256, one and two parts, both
     directions, against the twins and a bitwise repeat: kernel 2 with bf16
     planes and bf16 raw gates (the float32 mode's residual rounded to
     nearest even, bit for bit), kernels 3 and 3b on bf16 residuals, kernel 4
     on bf16 planes; (b) one B=512 micro-step of ModelConfig() on bf16
     residuals under each of "fused", "two_pass" and "dualdir", kernel path
     against plain path (loss, every gradient, bitwise repeat, exact launch
     counts from model.train_step_launches); (c) its loss equal to the
     float32-residual step's, and (d) its gradients' distance from that
     step's and both steps' peak device memory; (e) each step timed in turns
     with the float32-residual one, and each mode the steps launch held at
     B=512 to its twin and a bitwise repeat and timed against its
     float32-residual counterpart and its twin.
 25. the in-kernel Philox dropout (kernel_dropout; the reference's
     EEGFLOW_KERNEL_DROPOUT=1, FWD_DROPW=1 and the input block's out_seed) of
     kernels 2, 3 and 3b (philox_phase): (a) at B=64, T=256, H=256, one and
     two parts, both directions (the reverse one at a mesh rank's row
     offset), kernel 2 (planes, raw gates, each with and without res_bf16)
     and kernels 3 and 3b (float32 and bf16 residuals) against their twins,
     a bitwise repeat and the same kernel on the uint8 masks the twin
     expands from the key, bit for bit; (b) one B=512 ModelConfig()
     micro-step under "fused" and under "two_pass" with kernel_dropout:
     exact launch counts, loss and every gradient against the mask-path step
     on the expanded masks bit for bit, each stream's keep fraction and the
     agreement of streams and of two keys within 5 sigma of independent
     masks', layer 0's dx zero exactly at stream 0's drops; (c) each step
     timed in turns with the mask path (each with its draw), their peak
     device memory above the allocations before the step at B=512 and, with
     res_bf16, at B=7,168, and each Philox mode at B=512 on a layer's drawn
     keep-bit planes against its twin and a bitwise repeat, timed in turns
     with its uint8 mode; the draw kernel (philox_keep_bits) against its
     twin bit for bit at B=64, at a layer's B=512 and at a row offset that
     carries the counter past 2^32, timed at B=512 against its twin, and
     the generator calls a B=512 step makes, reckoned from the shapes, with
     the draw in the loaders (the first design) and with the planes.
The line before the last lists the kernels as JSON, each with its time, its
twin's, its bound on an H100 (bytes over 3.35 TB/s or products over the
dtype's peak, whichever is larger), the library call's time where there is
one and its launches in phase 18 (analysis_launches), phase 19
(ablate_launches) and phase 20's train and explain stages
(transformer_launches); the wide bf16 classes' entries (and kernel 9's
32-row tiles, "input_block_fwd bf16 wide") count their launches in the
hidden-512 ablate run, the one-part pool head's in phase 20, the
res_bf16 modes of phase 24 theirs in its three micro-steps, the Philox modes
of phase 25 theirs in its micro-steps (B=512, and B=7,168 with res_bf16); the
last line is {"ok": true, "device": {...}}.
"""

import contextlib
import importlib.util
import io
import json
import math
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter
from http.client import HTTPConnection
from pathlib import Path

import numpy as np
import torch

SEED = 0
B_CHECK, T, H, C = 64, 256, 256, 61
BUCKET = 1024
# lstm_fwd vs twin: identical bf16-rounded products, float32 sums in another
# order; a last-bit difference can flip the bf16 rounding of h for the next
# step, and such flips carry through the recurrence over 256 steps.
LSTM_TOL = 2e-3
# pool_head_fwd vs twin: LayerNorm sums and the 512-term projection sums in
# another order (with possible bf16 flips of y), and the online softmax
# against a direct one.
POOL_TOL = 1e-3
# served probabilities (kernels) vs predict_batch on the plain twins
PROBS_TOL = 2e-3
# training-mode lstm_fwd vs twin: as LSTM_TOL (the planes are products of
# the same gates, so they move with h)
TRAIN_FWD_TOL = 2e-3
# lstm_bwd vs twin, relative to the largest gradient entry: the same
# bf16-rounded operands, float32 sums over B*T = 16384 rows in another
# order; a last-bit difference in a float32 dz can flip its bf16 rounding
# and the carried dh_carry moves with it through the 256 steps (measured
# 7.6e-4 at this shape on an H100)
BWD_REL_TOL = 5e-3
# pool_head_bwd vs twin, relative: LayerNorm and projection sums in another
# order and bf16 flips of y or u (measured 1.0e-4)
POOL_BWD_REL_TOL = 1e-3
# one training micro-step at B=512, kernel path vs plain path: the loss,
# and every gradient leaf relative to its largest entry; the JAX package
# holds its fused kernels to its scan path at 2e-2 (tests/test_pallas_lstm.py)
STEP_LOSS_TOL = 1e-3
STEP_GRAD_REL_TOL = 2e-2
# float32 kernels vs twins: the same float32 operations, sums in another
# order (the twins' products are cuBLAS float32 with TF32 off) through 256
# steps of the recurrence; gradients relative to their largest entry
REC_TOL = 1e-4
REC_BWD_REL_TOL = 1e-3
# input block: float32 sums in another order; under bf16 a last-bit
# difference in dz can flip its bf16 rounding before the dx and dW products
INPUT_TOL = 1e-4
INPUT_BWD_REL_TOL = {False: 1e-3, True: 5e-3}
# attention_pool (float32): sums in another order, an online softmax
ATTN_POOL_TOL = 1e-4
# pool_head_fwd in float32 mode (3xTF32, each product good to ~2^-21
# relative) vs its twin's float32 products: ctx and scores
POOL32_TOL = 1e-4
# the float32 micro-step, kernel path vs plain path: summation order only
STEP32_LOSS_TOL = 1e-4
STEP32_GRAD_REL_TOL = 1e-3
N_TRAIN32_EPOCHS = 1
B_TRAIN = 512
# the least time of a kernel's work on an H100 SXM (NVIDIA's data sheet, dense):
# HBM bytes per second, and products per second by operand type (bf16 on the
# tensor cores; float32 outside them, since TF32 is off; float32 in 3xTF32,
# three TF32 tensor-core products for each, at a third of the 495 TFLOP/s
# TF32 peak; 32-bit integer instructions outside them, counted in slots of
# one integer pipe: 64 results a clock on each of the 132 SMs (the CUDA C++
# Programming Guide's throughput table, compute capability 9.0) at the 1.98
# GHz at which the 128 float32 lanes give the data sheet's 67 TFLOP/s)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "float32": 67e12, "tf32x3": 495e12 / 3,
              "int32": 132 * 64 * 1.98e9}
# the fewest instructions of one Philox4x32-10 call and its threshold, by
# the SM pipe that runs them (Nsight Compute's pipe names): the FMA pipe the
# 10 rounds' two 32 x 32 -> 64-bit products (one IMAD.WIDE each, both
# halves), the ALU pipe their two three-way XORs (one LOP3 each) and the 4
# compares with the threshold (ISETP); the first round's product of the
# stream word and its XOR with the key are the same for every call of a
# stream, so a thread's calls share them (the compiled kernel does). The
# pipes run side by side, each at 64 a clock an SM, and an SM issues 128 a
# clock, so a call takes the busiest pipe's slots or half its instructions,
# whichever is more
PHILOX_PIPE_OPS = {"fma": 10 * 2 - 1, "alu": 10 * 2 - 1 + 4}
PHILOX_CALL_OPS = max(*PHILOX_PIPE_OPS.values(), sum(PHILOX_PIPE_OPS.values()) / 2)
N_TRAIN_WINDOWS = 2048
TRAIN_EPOCHS = 2
# kernel 11 (apf_rk4) vs its twin: the same float32 RK4 steps, with FMA
# contraction and the field's 3-term sums in another order; the loss
# relative, the tangents' gradient relative to its largest entry,
# trajectories absolute
APF_LOSS_REL_TOL = 1e-5
APF_GRAD_REL_TOL = 1e-4
APF_TRAJ_TOL = 1e-6
# kernel 11's check shape: a DE population (popsize 15 x 6 rates), 200
# output points, 16 RK4 substeps an interval
APF_CANDIDATES, APF_POINTS, APF_SUBSTEPS = 90, 200, 16
# kernel 11's DE mode against its twin at the fit's 513 points:
# (popsize, generations, tol) of a population of 90 that converges, 64 not
# dividing 100 generations at n = 18, all 100 at n = 90, 63 (the chunk at
# n = 1,026) not dividing 150, and 7 (the chunk at n = 3,000, 94 CTAs of the
# grid class) not dividing 40
APF_DE_POINTS = 513
APF_DE_CASES = ((15, 600, 5e-2), (3, 100, 1e-7), (15, 100, 1e-7), (171, 150, 1e-7),
                (500, 40, 1e-7))
# kernel 11's DE mode timed a generation (a chunk at tol -1, every generation
# run) at these populations: the default fit's, a popsize of 171 and of 500
APF_DE_TIMED = (90, 1026, 3000)
# kernel 12 (sos_filtfilt) vs its twin, relative to the output's scale: the
# same roundings (the multiply-adds written out on both sides); vs scipy's
# float64 filtfilt: the float32 recursion floor (the JAX package's bound)
SOS_REL_TOL = 1e-5
SOS_SCIPY_REL_TOL = 3e-4
# kernel 12's shape: one recording of the pipeline (61 channels, 120 s at
# 500 Hz)
SOS_ROWS, SOS_SAMPLES = 61, 60_000
# the pipeline phase: synth 12 subjects x 1 session x 120 s per task
PIPE_SUBJECTS, PIPE_SECONDS = 12, 120.0
# dependent operations on the serial chain, for the chain bounds: one RK4
# step of kernel 11 (per stage point the max, the increment's mul, fma, fma
# against a scaled rate matrix and its add into y: 3 x 5, then stage 4's
# max and the weighted sum's last add: 2, then the update's mul, fma, fma,
# add: 4) and one sample of one section of kernel 12 (the delay line's
# loop-carried cycle: fma, mul, fma, add); FP32 latency on Hopper, cycles
APF_CHAIN_OPS_PER_STEP = 21
SOS_CHAIN_OPS_PER_SAMPLE = 4
FP32_LATENCY_CYCLES = 4
# float32 operations a kernel does, for its roofline bound: one RK4 step of
# one candidate (4 x 3 max, 3 stage points of 3 x (mul, 2 fma, add), the
# weighted sum's 6 FMAs and 3 adds, the update's 3 x (mul, 2 fma, add): 99,
# an FMA as 2; 111 in the first design, which scaled each field) and one
# section-sample of kernel 12 (3 fma, 2 mul, 1 add: 9)
APF_FLOPS_PER_STEP = 99
SOS_FLOPS_PER_SECTION_SAMPLE = 9
# phase 18: the analysis stages' batches at their defaults: a KernelSHAP
# evaluation (100 coalitions x 100 background rows), a permuted stack (5
# repeats x 1,000 windows), the gradient attribution's windows; the input
# gradients are held to their twin as phase 9 holds the micro-step's
# gradients (STEP_GRAD_REL_TOL), the probabilities as phase 5 holds served
# ones (PROBS_TOL); the forecast's trajectories against solve_ivp to the
# judged ODE budget; the efficiency identity of the SHAP values per row;
# the SHAP values of the first, a middle and the last explained row against
# the same regression on synchronous evaluations of the same batches, which
# give the same probabilities bit for bit (float64 rounding of the solve)
SHAP_BG, SHAP_COALITIONS, SHAP_EXPLAIN = 100, 100, 200
SHAP_CHECK_ROWS = (0, 100, SHAP_EXPLAIN - 1)
SHAP_ROW_TOL = 1e-9
PERM_REPEATS, PERM_WINDOWS = 5, 1000
GRAD_WINDOWS = 100
EXPLAIN_SEED = 42
FORECAST_TOL = 1e-5
EFFICIENCY_TOL = 1e-6
# phase 19: the ablate stage's variants (eegflow_torch.analyze.ablation
# ABLATION_CONFIGS): bidirectional, attention, layers; its wide run's hidden
# size and epochs, and the epochs of the run at the default 256 units (the
# stage's default 10 cut to 4 for the script's time limit)
ABLATE_VARIANTS = {"Full Model": (True, True, 3), "No Attention": (True, False, 3),
                   "Unidirectional": (False, True, 3), "1 Layer": (True, True, 1),
                   "2 Layers": (True, True, 2), "Minimal": (False, False, 1)}
ABLATE_WIDE_H, ABLATE_WIDE_EPOCHS = 512, 1
ABLATE_EPOCHS = 4
# phase 20: the EEGFormer's large eval batch (a KernelSHAP evaluation's size);
# gradients zero by symmetry (the attention's key biases), rounding noise on
# both paths (measured ~1e-11)
TF_EVAL_BIG = 10_000
ZERO_GRAD_TOL = 1e-7
# phase 21: Welch on the card against scipy's float64 welch, relative per bin
# (the JAX package's rtol; float32 on the CPU measured 3.8e-7), and against its
# own CPU run (float32 rfft of two libraries); the features against a float64
# oracle of the reference's semantics at the JAX package's bound, the zcr apart:
# a sample within float32 rounding of its window's mean may take the other
# sign there (expected ~1 of the 175 M samples of phase 17's windows), moving
# its window's rate by 1/T or 2/T; the timing set, five chunks of the
# reference's 10,000 windows
WELCH_SCIPY_RTOL = 1e-3
WELCH_CPU_RTOL = 1e-4
FEATURE_ORACLE_TOL = 2e-3
ZCR_MAX_FLIP_SHARE = 1e-4
FEATURE_CHUNK, FEATURE_TIMING_WINDOWS = 10_000, 50_000
# the stages that draw figures in the JAX package (eegflow/cli/main.py)
FIGURE_STAGES = ("explore", "preprocess", "baselines", "train", "fit-ode", "integrate",
                 "explain", "forecast", "ablate")
# phase 22: the training windows of the profiled run; fig10's series on the card
# against its CPU twin: float32 RK4 with FMA contraction on one side (kernel
# 11's trajectory mode, APF_TRAJ_TOL at its check shape) and a float32 3 x 3
# solve of two libraries
PROFILE_WINDOWS = 1024
ODE_SERIES_TOL = 1e-5
# the default bf16 path's hand-written kernels as their names appear in a trace
TRACE_KERNELS = {"lstm_fwd (planes)": r"lstm_fwd_rec_kernel<1,",
                 "lstm_bwd": r"lstm_bwd_chain_kernel",
                 "pool_head_fwd": r"pool_head_fwd_bf16_kernel",
                 "pool_head_bwd": r"pool_head_bwd_bf16_kernel",
                 "input_block_fwd": r"input_block_fwd_kernel",
                 "input_block_bwd": r"input_block_bwd_bf16_kernel"}
# phase 23: the data mesh (eegflow_torch/train/mesh.py) on the card. The
# micro-step's kernels are row-independent, but the head's cuBLAS products
# pick their kernel by M, so a rank's 256 rows give logits ~2e-4 from the
# same rows in a batch of 512 (ROADMAP §3, "A row's result depends on the
# batch"): the loss is held as phase 9 holds it (STEP_LOSS_TOL), every
# gradient to 2e-3 of its largest entry (the bf16 step tests' FUSED_REL_TOL)
# but the head's weights': the gradient of a product of bf16-rounded operands
# is rounded to bf16, once a rank, so two rounded half sums meet one rounded
# whole, up to 2^-8 of an entry (measured 4.1e-3 on the CPU twins at B=32);
# P(closed) to ~7x the 2.825e-05 that chunking moves it; an importance or a
# sweep accuracy moves by 1/n a decision that this flips
MESH_GRAD_REL_TOL = 2e-3
MESH_BF16_GRAD_REL_TOL = 1e-2
MESH_BF16_GRADS = ("head1.w", "head2.w", "head3.w")
MESH_PROBS_TOL = 2e-4
MESH_FLIP_SHARE = 5e-3
MESH_PREDICT_WINDOWS = 10_000
MESH_ROLLOUT_WINDOWS = (1024, 1000)
MESH_PERM_WINDOWS = 1000
MESH_TIMEOUT_S = 600
# phase 24: a bf16 residual of a kernel against its twin's rounds float32
# values that agree within TRAIN_FWD_TOL, so a value near a rounding boundary
# takes the next bf16: one ulp of 8 significant bits, 2^-8 for the planes and
# gates (all in [-1, 1])
RES16_TOL = TRAIN_FWD_TOL + 2.0 ** -8
# phase 25: the batch that fits on the 80 GB card only with res_bf16 (PERF.md),
# where the masks the Philox dropout does without weigh most
B_BIG = 7168
# one micro-step's launches on the default bf16 "fused" path (phase 9) and an
# eval batch's
STEP_LAUNCHES = {"input_block_fwd": 1, "input_block_bwd": 1, "lstm_fwd_train": 6,
                 "lstm_bwd": 6, "pool_head_fwd": 1, "pool_head_bwd": 1}
EVAL_LAUNCHES = {"input_block_fwd": 1, "lstm_fwd": 6, "pool_head_fwd": 1}
# the columns the reference exports (eegflow/analyze/export.py)
SAMPLE_COLUMNS = ["Sample_ID", "Prob_EyesOpen", "Prob_Drowsy", "Prob_EyesClosed", "LSTM_P_Open",
                  "LSTM_P_Closed", "Predicted_State", "Ground_Truth"]
PARTICIPANT_COLUMNS = ["Participant_ID", "N_Samples", "Prob_EyesOpen", "Prob_Drowsy",
                       "Prob_EyesClosed", "Prob_EyesOpen_Std", "Prob_Drowsy_Std",
                       "Prob_EyesClosed_Std", "Mean_LSTM_P_Open", "Mean_LSTM_P_Closed",
                       "Pct_EyesOpen", "Pct_Drowsy", "Pct_EyesClosed"]


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


class _Tee(io.TextIOBase):
    """Writes to ``out`` and keeps a copy."""

    def __init__(self, out):
        self.out, self.kept = out, io.StringIO()

    def write(self, text):
        self.out.write(text)
        self.kept.write(text)
        return len(text)

    def flush(self):
        self.out.flush()


def run_cli(cli_main, argv):
    """``cli_main(argv)`` with its standard output shown as it goes and kept
    -> (return code, output)."""
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        rc = cli_main(argv)
    return rc, tee.kept.getvalue()


def check_figures(stage, output, out_dir):
    """A stage that draws figures in the JAX package: where matplotlib is not
    installed (the GPU machine), it printed its skip line once and wrote no
    file under ``figures/``; where it is, it drew."""
    from eegflow_torch.cli.main import FIGURES_SKIPPED

    if stage not in FIGURE_STAGES:
        return
    skipped = output.count(f"{stage}: {FIGURES_SKIPPED}")
    files = sorted(p.name for p in (Path(out_dir) / "figures").glob("*"))
    if importlib.util.find_spec("matplotlib") is None:
        require(skipped == 1 and not files,
                f"{stage} printed its skip line once ({skipped}) and wrote no figure ({files})")
    else:
        require(skipped == 0 and files, f"{stage} drew its figures")


def cuda_ms(fn, reps):
    """Mean milliseconds per call of ``fn`` over ``reps`` calls (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def median_ms(fns, rounds=2):
    """Median CUDA-event milliseconds per call of each of ``fns`` (name ->
    callable), run in turns (a, b, b, a) ``rounds`` times after a warmup."""
    names = list(fns)
    for n in names:
        fns[n]()
    times = {n: [] for n in names}
    for _ in range(rounds):
        for n in names + names[::-1]:
            times[n].append(cuda_ms(fns[n], 1))
    return {n: statistics.median(v) for n, v in times.items()}


def rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def hold_at_main_shape(label, got, again, want, tol, relative):
    """Hold a kernel's outputs at a shape ``label`` names (a main-path shape
    launches the main path's plan) to its twin's on the same inputs: the
    largest difference,
    relative to each output's largest entry where ``relative``, within
    ``tol``, and a second launch bitwise identical. ``got``, ``again`` and
    ``want`` are flat lists of tensors. -> the largest absolute difference."""
    torch.cuda.synchronize()
    err = max((rel_err(a, w) if relative else (a - w).abs().max().item())
              for a, w in zip(got, want))
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    print(f"{label}: max {'rel' if relative else 'abs'} diff {err:.3e} (tol {tol:g}); repeat "
          f"bitwise identical: {same}", flush=True)
    require(finite and err <= tol and same,
            f"{label} within {tol} of its twin, finite, bitwise repeatable")
    return max((a - w).abs().max().item() for a, w in zip(got, want))


def device_ms(fn, reps):
    """Mean device milliseconds of a launch of each kernel a call of ``fn``
    makes, by kernel name (torch.profiler, ``reps`` calls after a warmup).
    The mean is over the launches the profiler recorded: on the H100
    machines it has dropped some of a session's launches, and a sum over
    ``reps`` calls would count those as 0."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_time_total > 0]
    names = (re.search(r"(\w+)(?:<[^>]*>)?\(", e.key) for e in events)
    return {m.group(1) if m else e.key: e.device_time_total / 1e3 / e.count
            for m, e in zip(names, events)}


def split_ms(fn, reps, key):
    """(device ms a call of the kernels whose name holds ``key``, device ms a
    call of the others) over ``reps`` calls of ``fn`` after a warmup
    (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    inside = outside = 0.0
    for e in prof.key_averages():
        if e.device_time_total > 0:
            if key in e.key:
                inside += e.device_time_total
            else:
                outside += e.device_time_total
    return inside / 1e3 / reps, outside / 1e3 / reps


def nbytes(*items):
    """Bytes of every tensor in ``items`` (tuples, lists and dicts walked;
    anything else counts 0)."""
    total = 0
    for t in items:
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        elif isinstance(t, (tuple, list)):
            total += nbytes(*t)
        elif isinstance(t, dict):
            total += nbytes(*t.values())
    return total


def bound(bytes_moved, flops, dtype):
    """(ms, "bytes" | "operations"): the larger of the bytes over the HBM
    rate and the products' operations over the peak rate of ``dtype``; a
    kernel whose products run at several peaks gives ``flops`` and ``dtype``
    as tuples, and their times add."""
    pairs = zip(flops, dtype) if isinstance(dtype, tuple) else [(flops, dtype)]
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = sum(f / PEAK_FLOPS[d] for f, d in pairs) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def sass_pipe_counts(library, function):
    """The instructions of the kernels whose name holds ``function`` in the
    SASS of the built ``library`` (``cuobjdump -sass``), by the pipe that
    issues them (``eegflow_torch.kernels.ablate.SASS_PIPES``) -> {"fma": n,
    "alu": n, "other": n}."""
    from eegflow_torch.kernels.ablate import sass_counts

    counts = Counter({"fma": 0, "alu": 0, "other": 0})
    for c in sass_counts(library, function).values():
        counts.update(c)
    require(sum(counts.values()) > 0, f"cuobjdump -sass {library}: no {function}")
    return dict(counts)


def synthetic_split(rng, n, steps, channels):
    """Windows N(0, 1) plus a class-dependent offset on the first 8
    channels, so the classifier can learn; balanced labels."""
    y = rng.permutation(np.arange(n) % 2).astype(np.int64)
    x = rng.standard_normal((n, steps, channels), dtype=np.float32)
    x[:, :, :8] += (0.5 * (2 * y - 1)).astype(np.float32)[:, None, None]
    return x, y


def request(addr, method, path, payload=None):
    conn = HTTPConnection(*addr, timeout=600)
    try:
        body = json.dumps(payload) if payload is not None else None
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"} if body else {})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def sm_clock_mhz():
    """(current, max) SM clock of card 0 in MHz, from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    cur, top = (float(v) for v in out.strip().split(","))
    return cur, top


def chain_ms(links, clock_mhz):
    """Milliseconds of ``links`` dependent FP32 operations in series at
    ``clock_mhz``: the least time of a serial recurrence."""
    return links * FP32_LATENCY_CYCLES / (clock_mhz * 1e3)


def de_against_twin(label, loss, dev, popsize, maxiter, tol, seed, smi):
    """Kernel 11's DE mode, run as the fit runs it on the card (chunks of
    DE_CHUNK generations), against its twin, the loop of generations on the
    loss mode, on the fit loss ``loss``: the same generations, best member
    and loss bit for bit, again on a second run, one loss-mode launch and one
    DE launch a chunk run -> (DE s, twin s, generations, DE launches, the
    largest abs difference of the best member and loss), the times host
    clock to a synchronize."""
    from eegflow_torch import kernels
    from eegflow_torch.core.config import ODEConfig
    from eegflow_torch.fit.evolution import _de_minimize, _de_minimize_chunked, de_chunk_length

    lo, hi = (torch.tensor(v, dtype=torch.float32, device=dev) for v in zip(*ODEConfig().bounds))
    chunk = de_chunk_length(popsize * 6)

    def run(fn):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = fn(loss, gen, lo, hi, popsize, maxiter, tol)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    twin, twin_s = run(_de_minimize)
    kernels.reset_launch_counts()
    got, de_s = run(_de_minimize_chunked)
    launches = dict(kernels.launch_counts)
    again, _ = run(_de_minimize_chunked)
    gens = got[2]
    chunks = gens // chunk + 1 if gens < maxiter else -(-maxiter // chunk)
    same = gens == twin[2] == again[2] and all(
        torch.equal(a, b) for a, b in ((got[0], twin[0]), (got[1], twin[1]), (got[0], again[0]),
                                       (got[1], again[1])))
    print(f"apf_de {label}: n={popsize * 6}, {gens} of {maxiter} generations in chunks of "
          f"{chunk} (tol {tol:g}; "
          f"{'converged inside chunk ' + str(gens // chunk + 1) if gens < maxiter else 'all run'}"
          f"), best loss {got[1].item():.9g}; equal to its twin (the loop on the loss mode) bit for "
          f"bit: {same}, launches {launches}; DE {de_s * 1e3:.1f} ms, twin {twin_s * 1e3:.1f} ms "
          f"(host clock) [{smi}]", flush=True)
    require(same and launches == {"apf_rk4": 1, "apf_de": chunks},
            f"apf_de {label} equals its twin bit for bit, repeats, {chunks} DE launches")
    err = max((got[0] - twin[0]).abs().max().item(), (got[1] - twin[1]).abs().item())
    return de_s, twin_s, gens, launches.get("apf_de", 0), err


def bwd_f64_holds(dev, smi):
    """Kernels 3, 3b and 4 (H = 256, two parts of 256) and the narrow bf16
    classes of kernels 8 (D = 512, K = 256) and 10 (C = 61, H = 256) at B = 1,
    T = 256 against their functions in float64 (``kernels.ablate``): at one
    long row a bf16 tie that a float32 side rounds the other way moves a
    256-row dW by ~1e-3 of its largest entry, so a twin is no yardstick
    there. Each kernel is held to BWD_REL_TOL; both sides' distances are
    printed."""
    from eegflow_torch.kernels.ablate import lstm_bwd_f64_holds, narrow_bwd_f64_holds

    for name, (kernel, twin) in {**lstm_bwd_f64_holds(dev), **narrow_bwd_f64_holds(dev)}.items():
        print(f"{name} bf16 B=1 T=256 against its float64 function: kernel {kernel:.3e}, twin "
              f"{twin:.3e} (relative to each gradient's largest entry; tol {BWD_REL_TOL:g}) "
              f"[{smi}]", flush=True)
        require(kernel <= BWD_REL_TOL, f"{name} at B=1 holds to its float64 function")


def de_generation_ms(loss, dev, n, seed=0):
    """Kernel 11's DE mode on n members of a Latin hypercube in the default
    bounds, one chunk of ``de_chunk_length(n)`` generations at tol -1 (no
    generation passes the convergence test, all run), timed by CUDA events
    (median of 3 after a warm-up) -> (ms a generation, generations a chunk,
    the plan from C)."""
    from eegflow_torch.core.config import ODEConfig
    from eegflow_torch.fit.evolution import _draw_generations, _latin_hypercube, de_chunk_length
    from eegflow_torch.ode.cuda_ode import de_generations, de_plan

    lo, hi = (torch.tensor(v, dtype=torch.float32, device=dev) for v in zip(*ODEConfig().bounds))
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + seed)
    pop0 = _latin_hypercube(gen, n, lo, hi).contiguous()
    with torch.no_grad():
        fit0 = loss(pop0).contiguous()
    gens = de_chunk_length(n)
    draws = _draw_generations(gen, n, 6, gens, dev)
    pop, fit = pop0.clone(), fit0.clone()

    def chunk():
        pop.copy_(pop0)
        fit.copy_(fit0)
        return de_generations(pop, fit, lo, hi, draws, loss.y0, loss.observed, loss.substeps,
                              loss.steps, loss.reg_weight, -1.0)

    status = chunk()
    require(status.tolist() == [gens, 0], f"apf_de n={n} runs its {gens} generations")
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        chunk()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[1] / gens, gens, de_plan(n, loss.substeps)


def de_timings(loss, dev, smi, chain):
    """Kernel 11's DE mode a generation at the populations of APF_DE_TIMED,
    each with its plan from C, beside the loss mode's chain bound ``chain``
    (ms a generation) -> {n: (ms, plan)}."""
    out = {}
    for n in APF_DE_TIMED:
        ms, gens, plan = de_generation_ms(loss, dev, n)
        out[n] = (ms, plan)
        print(f"apf_de n={n}: plan from C {plan._asdict()}; {ms:.4f} ms a generation (a chunk of "
              f"{gens}, CUDA events, median of 3), {ms / chain:.2f}x the loss mode's "
              f"{chain:.3f} ms chain bound [{smi}]", flush=True)
    return out


def kernel_check_phase(dev, smi):
    """Phase 16: kernel 11's three modes against its twin at a DE
    population's shape, and kernel 12 through ``bandpass_filter(method=
    "filtfilt")`` on a full recording against its twin and scipy's filtfilt
    (each repeats bit for bit), and their times. -> the kernels line's
    numbers for kernel 12."""
    from scipy.signal import filtfilt

    from eegflow_torch import kernels
    from eegflow_torch.core.config import ODEConfig
    from eegflow_torch.data.synthetic import generate_recording
    from eegflow_torch.ode.cuda_ode import (rk4_fit_loss, rk4_fit_loss_plain, rk4_trajectory,
                                            rk4_trajectory_plain, step_sizes)
    from eegflow_torch.signal.filters import (_sos_design, bandpass_filter, butter_bandpass,
                                              sos_filtfilt, sos_filtfilt_plain)

    out = {}
    rng = np.random.default_rng(SEED + 16)
    # kernel 11 at a DE population's shape
    n, pts, sub = APF_CANDIDATES, APF_POINTS, APF_SUBSTEPS
    lo, hi = np.array(ODEConfig().bounds).T
    k = torch.tensor(lo + rng.uniform(size=(n, 6)) * (hi - lo), dtype=torch.float32,
                     device=dev)
    y0 = torch.tensor(rng.dirichlet([2.0, 2.0, 2.0], n), dtype=torch.float32, device=dev)
    obs = torch.tensor(rng.dirichlet([4.0, 4.0, 4.0], pts), dtype=torch.float32, device=dev)
    start = obs[0] / obs[0].sum()
    h = step_sizes(0.0, float(pts - 1), pts, sub)
    targs = (y0, k, pts, sub, h)
    largs = (k, start, obs, sub, h, 1e-3)
    shape = f"B={n} points={pts} substeps={sub}"
    hold_at_main_shape(f"apf_rk4 trajectory {shape}", [rk4_trajectory(*targs)],
                       [rk4_trajectory(*targs)], [rk4_trajectory_plain(*targs)], APF_TRAJ_TOL,
                       relative=False)
    got, again = rk4_fit_loss(*largs, grad=True), rk4_fit_loss(*largs, grad=True)
    want = rk4_fit_loss_plain(*largs, grad=True)
    hold_at_main_shape(f"apf_rk4 loss with tangents {shape}", got[:1], again[:1], want[:1],
                       APF_LOSS_REL_TOL, relative=True)
    hold_at_main_shape(f"apf_rk4 tangent gradient {shape}", got[1:], again[1:], want[1:],
                       APF_GRAD_REL_TOL, relative=True)
    # the modes with and without tangents are two compilations of the loss
    hold_at_main_shape(f"apf_rk4 loss without tangents {shape}", rk4_fit_loss(*largs)[:1],
                       rk4_fit_loss(*largs)[:1], want[:1], APF_LOSS_REL_TOL, relative=True)
    m = median_ms({"plain": lambda: rk4_fit_loss_plain(*largs),
                   "kernel": lambda: rk4_fit_loss(*largs)}, rounds=1)
    m["kernel grad"] = median_ms({"g": lambda: rk4_fit_loss(*largs, grad=True)})["g"]
    m["kernel traj"] = median_ms({"t": lambda: rk4_trajectory(*targs)})["t"]
    clock = sm_clock_mhz()
    steps = (pts - 1) * sub
    print(f"apf_rk4 {shape} ({steps} serial steps): loss kernel {m['kernel']:.3f} ms, with "
          f"tangents {m['kernel grad']:.3f} ms, trajectory {m['kernel traj']:.3f} ms, plain "
          f"twin (loss) {m['plain']:.3f} ms; chain bound "
          f"{chain_ms(steps * APF_CHAIN_OPS_PER_STEP, clock[1]):.3f} ms at the "
          f"{clock[1]:.0f} MHz max SM clock (read {clock[0]:.0f} MHz) [{smi}]", flush=True)

    # kernel 11's DE mode against its twin on a noisy series of the ODE at the fit's 513 points
    from eegflow_torch.fit.evolution import make_fit_loss
    from eegflow_torch.ode.field import DEFAULT_RATES, rates_to_array
    from eegflow_torch.ode.integrate import solve

    _, series = solve([0.6, 0.25, 0.15], (0.0, float(APF_DE_POINTS - 1)), APF_DE_POINTS,
                      k=rates_to_array(DEFAULT_RATES, dev), method="expm")
    series = np.clip(series.cpu().numpy() + rng.normal(0.0, 0.02, series.shape), 1e-3, 1.0)
    series = (series / series.sum(axis=1, keepdims=True)).astype(np.float32)
    de_loss = make_fit_loss(series, 0.0, float(APF_DE_POINTS - 1), APF_DE_POINTS, device=dev)
    # the loss mode's cycles a step at the fit's 513 points, from calls back to back: each
    # call's host path (~0.25 ms) runs under the previous launch, so the mean is the kernel's
    fit_args = (k, de_loss.y0, de_loss.observed, sub, de_loss.steps, 1e-3)
    back_to_back = cuda_ms(lambda: rk4_fit_loss(*fit_args), 20)
    fit_steps = (APF_DE_POINTS - 1) * sub
    print(f"apf_rk4 loss B={n} points={APF_DE_POINTS} substeps={sub}: {back_to_back:.3f} ms a "
          f"call over 20 calls back to back (CUDA events), "
          f"{back_to_back * clock[1] * 1e3 / fit_steps:.1f} cycles a step at the max SM clock, "
          f"the per-point work included ({APF_CHAIN_OPS_PER_STEP * FP32_LATENCY_CYCLES} on its "
          f"chain) [{smi}]", flush=True)
    for i, (popsize, maxiter, tol) in enumerate(APF_DE_CASES):
        _, _, gens, _, _ = de_against_twin(f"case {i + 1}, a noisy ODE series of {APF_DE_POINTS} "
                                        f"points", de_loss, dev, popsize, maxiter, tol,
                                        SEED + i, smi)
        require((gens < maxiter) == (tol > 1e-3), f"apf_de case {i + 1} converged as planned")
    out["de_timings"] = de_timings(de_loss, dev, smi,
                                         chain_ms(fit_steps * APF_CHAIN_OPS_PER_STEP, clock[1]))

    # kernel 12 on one recording, as bandpass_filter(method="filtfilt") gives it
    b, a = butter_bandpass(1.0, 45.0, 500.0, 4)
    sos, zi, padlen = _sos_design(b, a)
    # one synthetic recording, eyes closed (61 channels, volts)
    rec = generate_recording(True, SOS_SAMPLES / 500.0, 500.0, seed=SEED + 16)
    require(rec.shape == (SOS_ROWS, SOS_SAMPLES), "the recording's shape")
    x_rec = torch.from_numpy(rec).to(dev)
    kernels.reset_launch_counts()
    got = bandpass_filter(x_rec, 1.0, 45.0, 500.0, 4, method="filtfilt")
    torch.cuda.synchronize()
    out["sos_launches"] = kernels.launch_counts["sos_filtfilt"]
    require(out["sos_launches"] == 1, "bandpass_filter(method='filtfilt') runs kernel 12 once")
    again = bandpass_filter(x_rec, 1.0, 45.0, 500.0, 4, method="filtfilt")
    t0 = time.perf_counter()
    want = sos_filtfilt_plain(x_rec, sos, zi, padlen)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    out["sos_err"] = hold_at_main_shape(
        f"sos_filtfilt through bandpass_filter(method='filtfilt') rows={SOS_ROWS} "
        f"samples={SOS_SAMPLES} sections={len(sos)}", [got], [again], [want], SOS_REL_TOL,
        relative=True)
    ref = filtfilt(b, a, rec.astype(np.float64), axis=1)
    sp_err = np.abs(got.cpu().numpy() - ref).max() / np.abs(ref).max()
    print(f"bandpass_filter(method='filtfilt') rows={SOS_ROWS} samples={SOS_SAMPLES}: max "
          f"diff to scipy filtfilt (float64) {sp_err:.3e} of its scale (tol "
          f"{SOS_SCIPY_REL_TOL:g})", flush=True)
    require(sp_err < SOS_SCIPY_REL_TOL, "kernel 12 agrees with scipy's filtfilt")
    kernel_ms = median_ms({"k": lambda: sos_filtfilt(x_rec, sos, zi, padlen)})["k"]
    clock = sm_clock_mhz()
    links = 2 * (SOS_SAMPLES + 2 * padlen) * SOS_CHAIN_OPS_PER_SAMPLE
    out["sos_ms"] = (kernel_ms, plain_ms)
    out["sos_chain_ms"] = chain_ms(links, clock[1])
    print(f"sos_filtfilt rows={SOS_ROWS} samples={SOS_SAMPLES}: kernel {kernel_ms:.3f} ms, "
          f"plain twin {plain_ms:.1f} ms (one call, host clock to synchronize); chain bound "
          f"{out['sos_chain_ms']:.3f} ms at the {clock[1]:.0f} MHz max SM clock (read "
          f"{clock[0]:.0f} MHz), the kernel at {kernel_ms / out['sos_chain_ms']:.2f}x it; "
          f"equal to its twin bit for bit: {torch.equal(got, want)} [{smi}]", flush=True)
    out["sos_work"] = (nbytes(x_rec, got), SOS_ROWS * 2 * (SOS_SAMPLES + 2 * padlen)
                       * len(sos) * SOS_FLOPS_PER_SECTION_SAMPLE, "float32")
    return out


def apf_at_the_fit(dev, props, smi):
    """Kernel 11 at the shapes the fit-ode stage gave it, held to its twin
    and timed: the DE's loss over a population of 90 on the pipeline's
    proportion series, the polish's loss and gradient of one candidate
    through the fit loss's autograd, and the fit's whole DE (the default
    ODEConfig: 1,000 generations unless it converges) in the DE mode against
    its twin, with a chunk of 64 generations timed. -> (kernel ms, plain ms,
    largest abs difference, (bytes, flops, dtype), chain bound ms, the DE
    mode's numbers for the kernels line, the loss mode's ms a call over
    calls back to back)."""
    from eegflow_torch.core.config import ODEConfig
    from eegflow_torch.fit.evolution import make_fit_loss
    from eegflow_torch.ode.cuda_ode import rk4_fit_loss_plain

    cfg = ODEConfig()
    n, pts = cfg.de_popsize * 6, len(props)
    loss = make_fit_loss(props.astype(np.float32), 0.0, float(pts - 1), pts, cfg.reg_weight,
                         cfg.rk4_substeps, dev)
    lo, hi = np.array(cfg.bounds).T
    rng = np.random.default_rng(SEED + 17)
    k = torch.tensor(lo + rng.uniform(size=(n, 6)) * (hi - lo), dtype=torch.float32,
                     device=dev)
    args = (k, loss.y0, loss.observed, loss.substeps, loss.steps, loss.reg_weight)
    shape = f"points={pts} substeps={cfg.rk4_substeps}"
    err = hold_at_main_shape(f"apf_rk4 at the fit, the DE's loss B={n} {shape}", [loss(k)],
                             [loss(k)], [rk4_fit_loss_plain(*args)[0]], APF_LOSS_REL_TOL,
                             relative=True)

    def polish_step():
        # as the polish's loss_and_grad: one candidate, the gradient by backward
        kk = k[0].clone().requires_grad_()
        val = loss(kk)
        val.backward()
        return [val.detach().reshape(1), kk.grad.reshape(1, 6)]

    got, again = polish_step(), polish_step()
    want = rk4_fit_loss_plain(k[:1], *args[1:], grad=True)
    err = max(err, hold_at_main_shape(f"apf_rk4 at the fit, the polish's loss B=1 {shape}",
                                      got[:1], again[:1], want[:1], APF_LOSS_REL_TOL,
                                      relative=True))
    err = max(err, hold_at_main_shape(f"apf_rk4 at the fit, the polish's gradient B=1 {shape}",
                                      got[1:], again[1:], want[1:], APF_GRAD_REL_TOL,
                                      relative=True))
    m = median_ms({"kernel": lambda: loss(k), "plain": lambda: rk4_fit_loss_plain(*args)},
                  rounds=1)
    back_to_back = cuda_ms(lambda: loss(k), 20)  # each call's host path under the previous launch
    clock = sm_clock_mhz()
    steps = (pts - 1) * cfg.rk4_substeps
    chain = chain_ms(steps * APF_CHAIN_OPS_PER_STEP, clock[1])
    print(f"apf_rk4 at the fit: B={n} {shape} ({steps} serial steps): kernel "
          f"{m['kernel']:.3f} ms (CUDA events around one call, the host's launch path in), "
          f"{back_to_back:.3f} ms a call over 20 back to back, plain twin {m['plain']:.1f} ms; "
          f"chain bound {chain:.3f} ms at "
          f"the {clock[1]:.0f} MHz max SM clock (read {clock[0]:.0f} MHz) [{smi}]", flush=True)
    work = (nbytes(k, loss.observed, loss.y0) + 4 * n, n * steps * APF_FLOPS_PER_STEP,
            "float32")

    # the fit's whole DE on the pipeline's series, and one chunk of it timed
    from eegflow_torch.fit.evolution import DE_CHUNK, _draw_generations, _latin_hypercube
    from eegflow_torch.ode.cuda_ode import de_generations, de_generations_plain

    de_s, twin_s, gens, launches, de_err = de_against_twin(
        f"the fit-ode stage's DE on the pipeline's series ({pts} points)", loss, dev,
        cfg.de_popsize, cfg.de_maxiter, cfg.de_tol, cfg.de_seed, smi)
    lo_t, hi_t = (torch.tensor(v, dtype=torch.float32, device=dev) for v in zip(*cfg.bounds))
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.de_seed)
    pop0 = _latin_hypercube(gen, n, lo_t, hi_t).contiguous()
    with torch.no_grad():
        fit0 = loss(pop0).contiguous()
    draws = _draw_generations(gen, n, 6, DE_CHUNK, dev)
    pop_c, fit_c = pop0.clone(), fit0.clone()

    def chunk(fn, *rest):
        pop_c.copy_(pop0)
        fit_c.copy_(fit0)
        with torch.no_grad():
            return fn(pop_c, fit_c, lo_t, hi_t, draws, *rest)

    # tol -1: no generation passes the convergence test, all of the chunk's run
    dm = median_ms({"kernel": lambda: chunk(de_generations, loss.y0, loss.observed,
                                            loss.substeps, loss.steps, loss.reg_weight, -1.0),
                    "plain": lambda: chunk(de_generations_plain, loss, -1.0)}, rounds=1)
    de_chain = chain * DE_CHUNK
    de_work = (nbytes(pop0, fit0, draws, loss.observed, loss.y0, lo_t, hi_t) + 8,
               DE_CHUNK * n * steps * APF_FLOPS_PER_STEP, "float32")
    per_gen_bound = bound(*de_work)[0] / DE_CHUNK
    print(f"apf_de at the fit: a chunk of {DE_CHUNK} generations (B={n} {shape}) "
          f"{dm['kernel']:.3f} ms, {dm['kernel'] / DE_CHUNK:.4f} ms a generation; its twin (the "
          f"loop on the loss mode) {dm['plain']:.3f} ms, {dm['plain'] / DE_CHUNK:.4f} ms a "
          f"generation; a generation's chain bound {chain:.3f} ms, bound {per_gen_bound:.5f} ms; "
          f"the whole DE ({gens} generations, {launches} DE launches, without polish) "
          f"{de_s:.4f} s, its twin {twin_s:.4f} s [{smi}]", flush=True)
    de = {"ms": dm["kernel"], "plain_ms": dm["plain"], "work": de_work,
          "chain_bound_ms": de_chain, "generations": DE_CHUNK,
          "per_generation": {"ms": dm["kernel"] / DE_CHUNK, "plain_ms": dm["plain"] / DE_CHUNK,
                             "bound_ms": per_gen_bound, "chain_bound_ms": chain},
          "fit_s": de_s, "fit_twin_s": twin_s, "fit_generations": gens, "err": de_err}
    return m["kernel"], m["plain"], err, work, chain, de, back_to_back


@contextlib.contextmanager
def serve_process(out_dir, dev, config=None):
    """``serve --port 0`` on ``out_dir`` (with ``--config config``) in its own
    process, as a user starts it -> its (host, port), read from its first
    lines; the process is stopped on the way out."""
    cmd = [sys.executable, "-m", "eegflow_torch.cli.main", "--output-dir", str(out_dir)]
    cmd += ["--config", str(config)] if config else []
    cmd += ["serve", "--port", "0", "--device", dev.type]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, cwd=str(Path(__file__).resolve().parent))
    try:
        lines = []
        reader = threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True)
        reader.start()
        deadline = time.time() + 600
        addr = None
        while addr is None and time.time() < deadline and proc.poll() is None:
            for line in list(lines):
                found = re.search(r"http://([\d.]+):(\d+)", line)
                if found:
                    addr = (found.group(1), int(found.group(2)))
            time.sleep(0.2)
        require(addr is not None, f"serve printed its address: {''.join(lines)[-2000:]}")
        yield addr
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)


def pipeline_phase(dev, smi, tmp):
    """Phase 17: synth -> preprocess -> train -> fit-ode -> serve --config,
    every step a CLI call on the card in the directory ``tmp``, nothing
    written by hand; phase 18 reads its artifacts under ``tmp / "out"``. ->
    launches, times and the fit's proportions."""
    from eegflow_torch import kernels
    from eegflow_torch.cli.main import load_coupled_model
    from eegflow_torch.cli.main import main as cli_main
    from eegflow_torch.core.artifacts import load_processed, load_results
    from eegflow_torch.core.config import CouplingConfig, ODEConfig
    from eegflow_torch.couple.rollout import predict_batch
    from eegflow_torch.ode.field import RATE_NAMES
    from eegflow_torch.ode.mapping import map_eye_state_to_cognitive

    for name in ("scipy", "pandas", "sklearn"):
        try:
            __import__(name)
            print(f"host package {name}: imports on this machine")
        except ImportError as e:
            print(f"host package {name}: does not import ({e})")
    out, times = {}, {}
    base = ["--data-dir", str(tmp / "data"), "--output-dir", str(tmp / "out")]

    def stage(name, argv, config=None):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rc, text = run_cli(cli_main, (["--config", str(config)] if config else []) + argv)
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        counts = dict(kernels.launch_counts)
        require(rc == 0, f"{name} stage returned 0")
        check_figures(name, text, tmp / "out")
        print(f"pipeline {name}: {times[name]:.1f} s, launches {counts}", flush=True)
        return counts

    stage("synth", base + ["synth", "--subjects", str(PIPE_SUBJECTS), "--sessions", "1",
                           "--duration", str(PIPE_SECONDS)])
    stage("preprocess", base + ["preprocess", "--device", dev.type])
    arrays, meta = load_processed(tmp / "out" / "processed_data" / "processed_sequences.npz")
    windows = {s: tuple(arrays[f"X_{s}"].shape) for s in ("train", "val", "test")}
    print(f"pipeline windows per split: {windows}; subjects "
          f"{ {s: len(v['subjects']) for s, v in meta['splits'].items()} }")
    require(all(len(v) == 3 and v[1:] == (T, C) for v in windows.values())
            and min(v[0] for v in windows.values()) > 0
            and np.isfinite(arrays["X_train"]).all(), "processed windows")
    stage("train", base + ["train", "--epochs", "1", "--device", dev.type])
    counts = stage("fit-ode", base + ["fit-ode", "--device", dev.type])
    out["apf_launches"] = counts.get("apf_rk4", 0)
    out["apf_de_launches"] = counts.get("apf_de", 0)
    print(f"pipeline fit-ode: {times['fit-ode']:.3f} s, kernel 11's launches: apf_de "
          f"{out['apf_de_launches']} (a chunk of up to 64 generations each), apf_rk4 "
          f"{out['apf_launches']} (the first population and the polish's evaluations)",
          flush=True)
    require(out["apf_launches"] > 0 and out["apf_de_launches"] > 0
            and set(counts) == {"apf_rk4", "apf_de"},
            "fit-ode runs kernel 11's DE and loss modes and nothing else")
    eye = np.concatenate([arrays["y_train"], arrays["y_test"]])
    _, props = map_eye_state_to_cognitive(eye, 20)
    res = load_results(tmp / "out" / "results" / "ode_results.json")
    print(f"pipeline fit-ode: {len(props)} proportion points, {res['fit_info']}, loss "
          f"{res['fit_loss']:.6g}, rates {res['fitted_params']}, steady state "
          f"{res['steady_state']}", flush=True)
    require(math.isfinite(res["fit_loss"]) and res["stability"]["is_stable"]
            and all(lo - 1e-9 <= res["fitted_params"][nm] <= hi + 1e-9
                    for nm, (lo, hi) in zip(RATE_NAMES, ODEConfig().bounds)),
            "fitted rates finite, stable and within the bounds")
    out["fit_props"] = props

    # serve --config in its own process, as a user starts it
    coupling = {"coupling_strength": 0.8, "forecast_steps": 30}
    (tmp / "serve.json").write_text(json.dumps({"coupling": coupling}))
    t0 = time.perf_counter()
    with serve_process(tmp / "out", dev, tmp / "serve.json") as addr:
        x_test = arrays["X_test"]
        picks = [x_test[:1], x_test[1:6], x_test[6:23]]
        served = []
        for i, xs in enumerate(picks):
            status, body = request(addr, "POST", "/predict",
                                   {"windows": xs.tolist(), "trajectories": i == 0})
            require(status == 200, f"/predict -> {status} {body}")
            served.append(body)
        status, health = request(addr, "GET", "/health")
        times["serve"] = time.perf_counter() - t0
        require(status == 200 and health["model"]["coupling_strength"] == 0.8,
                "/health reports the config's coupling")
    model = load_coupled_model(tmp / "out", dev, CouplingConfig(**coupling))
    default = load_coupled_model(tmp / "out", dev)
    err, moved = 0.0, 0.0
    for xs, body in zip(picks, served):
        want = predict_batch(model, xs, batch_size=BUCKET)
        for key in ("probs", "final_state"):
            err = max(err, float(np.abs(np.asarray(body[key]) - want[key]).max()))
        moved = max(moved, float(np.abs(np.asarray(body["final_state"]) - predict_batch(
            default, xs, batch_size=BUCKET)["final_state"]).max()))
    traj = np.asarray(served[0]["trajectories"])
    err = max(err, float(np.abs(traj - predict_batch(model, picks[0],
                                                     batch_size=BUCKET)["trajectories"]).max()))
    print(f"pipeline serve --config (coupling_strength 0.8, forecast_steps 30), own process, "
          f"{times['serve']:.1f} s to start and answer {len(picks)} /predict: served "
          f"probs, final states and trajectories {traj.shape} vs predict_batch at that "
          f"coupling max abs diff {err:.3e}; vs the default coupling's final states "
          f"{moved:.3e}", flush=True)
    require(traj.shape == (1, 30, 3) and err <= 1e-6 and moved > 1e-4,
            "served answers equal predict_batch at the config's coupling")
    print(f"pipeline stage times: {', '.join(f'{k} {v:.1f} s' for k, v in times.items())}; "
          f"total {sum(times.values()):.1f} s [{smi}]", flush=True)
    return out


def analysis_phase(dev, smi, out_dir, infer_ms_1024):
    """Phase 18: integrate, explain (KernelSHAP included), forecast and
    export as CLI calls on the card on phase 17's artifacts under
    ``out_dir``, each with its launches counted; the new batches held to the
    plain path (a KernelSHAP evaluation at B = 10,000, a permuted stack at
    5,000, the input gradients at 100), and the stages' results checked. ->
    the launches of the four stages together."""
    from collections import Counter

    import pandas as pd
    from scipy.integrate import solve_ivp

    from eegflow_torch import explain, kernels
    from eegflow_torch.analyze.forecast import multistep_forecast, prob_to_ode_state
    from eegflow_torch.cli.main import load_coupled_model, load_splits
    from eegflow_torch.cli.main import main as cli_main
    from eegflow_torch.convert import params_from_jax
    from eegflow_torch.core.artifacts import load_checkpoint, load_results
    from eegflow_torch.core.config import CouplingConfig, TrainConfig
    from eegflow_torch.couple.modulation import infer_initial_state, modulate_rates
    from eegflow_torch.couple.rollout import bucket_size, predict_batch
    from eegflow_torch.explain.gradient import batch_input_gradients
    from eegflow_torch.explain import kernelshap
    from eegflow_torch.explain.kernelshap import _sample_coalitions
    from eegflow_torch.nn.model import classifier_apply
    from eegflow_torch.ode.field import rates_to_array
    from eegflow_torch.ode.integrate import solve_batch
    from eegflow_torch.train.loop import predict_probs

    results = out_dir / "results"
    times, counts, calls = {}, {}, {}

    def stage(name, argv):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rc, text = run_cli(cli_main, ["--output-dir", str(out_dir)] + argv
                           + ["--device", dev.type])
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        counts[name] = Counter(kernels.launch_counts)
        require(rc == 0, f"{name} stage returned 0")
        check_figures(name, text, out_dir)
        print(f"analysis {name}: {times[name]:.1f} s, launches {dict(counts[name])}", flush=True)

    def timed(name, fn):
        """``fn`` timed to a synchronize, with its launches and result."""
        def call(*args, **kw):
            before = Counter(kernels.launch_counts)
            t0 = time.perf_counter()
            res = fn(*args, **kw)
            torch.cuda.synchronize()
            calls[name] = (time.perf_counter() - t0, Counter(kernels.launch_counts) - before, res)
            return res
        return call

    attributions = ("gradient_channel_importance", "permutation_channel_importance",
                    "kernel_shap_channel_importance")
    # the KernelSHAP step's classifier forwards, each between two CUDA events
    # on the stream the kernels run on: their sum is the step's device time
    shap_spans = []
    shap_apply = kernelshap.classifier_apply

    def spanned(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = shap_apply(*args, **kw)
        end.record()
        shap_spans.append((start, end))
        return out

    stage("integrate", ["integrate"])
    originals = {name: getattr(explain, name) for name in attributions}
    try:
        for name, fn in originals.items():
            setattr(explain, name, timed(name, fn))
        kernelshap.classifier_apply = spanned
        stage("explain", ["explain"])
    finally:
        for name, fn in originals.items():
            setattr(explain, name, fn)
        kernelshap.classifier_apply = shap_apply
    stage("forecast", ["forecast"])
    stage("export", ["export"])

    arrays, _ = load_splits(out_dir)
    x_test, y_test = arrays["X_test"], arrays["y_test"]
    n_test, steps, channels = x_test.shape
    splits = [s for s in ("train", "val", "test") if len(arrays[f"y_{s}"])]

    # launches: an eval launches 1 input_block_fwd, 6 lstm_fwd, 1 pool_head_fwd
    def evals(n):
        return Counter({"input_block_fwd": n, "lstm_fwd": 6 * n, "pool_head_fwd": n})

    def batches(n, size):
        return -(-n // size)

    want = {"integrate": evals(2 * batches(n_test, 2048)),  # predict_batch, the sweep
            "forecast": evals(batches(n_test, TrainConfig().eval_batch_size)),
            "export": evals(sum(batches(len(arrays[f"y_{s}"]), 2048) for s in splits))}
    backward = Counter({"input_block_fwd": 1, "pool_head_fwd": 1, "lstm_fwd_train": 6,
                        "lstm_bwd": 6, "input_block_bwd": 1, "pool_head_bwd": 1})
    want_calls = {"gradient_channel_importance": evals(1) + backward,
                  "permutation_channel_importance": evals(1 + channels),
                  "kernel_shap_channel_importance": evals(2 + SHAP_EXPLAIN)}
    want["explain"] = sum(want_calls.values(), Counter())
    for name, c in want_calls.items():
        require(calls[name][1] == c, f"{name} launched {dict(c)}, got {dict(calls[name][1])}")
    for name, c in want.items():
        require(counts[name] == c, f"{name} launched {dict(c)}, got {dict(counts[name])}")
    print("analysis launches as expected: integrate, forecast and export only the eval kernels "
          "(input_block_fwd, lstm_fwd, pool_head_fwd); explain one backward (1 input_block_bwd, "
          "6 lstm_fwd_train, 6 lstm_bwd, 1 pool_head_bwd); no apf_rk4, no sos_filtfilt",
          flush=True)

    params_np, cfg, _, _ = load_checkpoint(out_dir / "models" / "lstm_attention")
    params = params_from_jax(params_np, dev)
    bf16 = torch.bfloat16

    # integrate: the sweep's accuracy at the config's strength against integrate's
    cpl = CouplingConfig()
    sweep = load_results(results / "coupling_analysis.json")
    integ = load_results(results / "integration_results.json")["evaluation"]
    require(list(sweep) == [f"{a}" for a in cpl.sweep_alphas], "coupling_analysis has 5 alphas")
    model = load_coupled_model(out_dir, dev, cpl)
    batch = predict_batch(model, x_test)  # integrate's buckets
    probs_sweep = predict_probs(model.params, x_test, cfg, 2048)  # the sweep's chunks
    with torch.inference_mode():
        probs_d = torch.from_numpy(probs_sweep).to(dev)
        k_mod = modulate_rates(model.k_base, probs_d[:, 1], probs_d[:, 0],
                               cpl.coupling_strength, cpl.rate_floor)
        y0 = infer_initial_state(probs_d[:, 1], probs_d[:, 0], cpl.init_threshold)
        f_sweep = solve_batch(y0, 0.0, float(cpl.forecast_steps), cpl.forecast_steps,
                              k_mod)[:, -1, 2].cpu().numpy()
    f_batch = batch["final_state"][:, 2]
    acc_sweep, acc_int = sweep[f"{cpl.coupling_strength}"]["accuracy"], integ["accuracy"]
    differ = (f_sweep > 0.5) != (f_batch > 0.5)
    near = np.minimum(np.abs(f_sweep - 0.5), np.abs(f_batch - 0.5)) <= PROBS_TOL
    print(f"integrate: accuracy {acc_int:.6f}, the sweep's at alpha {cpl.coupling_strength} "
          f"{acc_sweep:.6f}; P(closed) at B=2048 chunks vs power-of-two buckets max abs diff "
          f"{np.abs(probs_sweep - batch['probs']).max():.3e}; windows whose decision differs "
          f"{int(differ.sum())} of {n_test} (all within {PROBS_TOL:g} of 0.5: "
          f"{bool(near[differ].all())})", flush=True)
    # where B enters a row's result: the last chunk alone and in its bucket
    tail = x_test[(n_test - 1) // 2048 * 2048:]
    padded = np.concatenate([tail, np.zeros((bucket_size(len(tail), 2048) - len(tail),)
                                            + tail.shape[1:], tail.dtype)])
    with torch.inference_mode():
        alone, in_bucket = (classifier_apply(params, torch.from_numpy(xb).to(dev), cfg,
                                             return_attention=True, compute_dtype=bf16)
                            for xb in (tail, padded))
    print(f"the last {len(tail)} test windows alone vs in their {len(padded)}-window bucket: "
          f"attention (kernels 9, 2, 7) max abs diff "
          f"{(alone[1] - in_bucket[1][:len(tail)]).abs().max().item():.3e}, logits (the "
          f"head's cuBLAS products after them) "
          f"{(alone[0] - in_bucket[0][:len(tail)]).abs().max().item():.3e}", flush=True)
    require(float(((f_sweep > 0.5) == y_test).mean()) == acc_sweep, "the sweep reproduced")
    require(near[differ].all() and abs(acc_sweep - acc_int) <= differ.sum() / n_test,
            "the sweep's accuracy equals integrate's but for windows at 0.5")

    # explain: the attributions' times, results and the kernels at their batches
    (grad_s, _, grad), (perm_s, _, perm), (shap_s, _, shap) = (calls[n] for n in attributions)
    shap_windows = SHAP_BG + SHAP_EXPLAIN + SHAP_EXPLAIN * SHAP_COALITIONS * SHAP_BG
    perm_windows = PERM_WINDOWS * (1 + channels * PERM_REPEATS)
    print(f"explain: gradient {grad_s:.2f} s ({GRAD_WINDOWS} windows forward and backward, "
          f"{GRAD_WINDOWS / grad_s:.0f} windows/s), permutation {perm_s:.2f} s ({perm_windows} "
          f"windows, {perm_windows / perm_s:.0f}/s), kernel-shap {shap_s:.2f} s ({shap_windows} "
          f"windows, {shap_windows / shap_s:.0f}/s) [{smi}]", flush=True)
    for res in (grad, perm, shap):
        require(np.isfinite(res["importance"]).all() and len(res["importance"]) == channels,
                f"{res['method']} importances finite")
    for res in (grad, shap):
        require(abs(sum(res["importance"]) - 1.0) <= 1e-9, f"{res['method']} importances sum to 1")
    collapsed = x_test.mean(axis=1)
    rng = np.random.RandomState(EXPLAIN_SEED)
    background = collapsed[rng.choice(n_test, SHAP_BG, replace=False)]
    explained = collapsed[rng.choice(n_test, SHAP_EXPLAIN, replace=False)]
    shap_values = np.load(results / "shap_values.npy")
    require(shap_values.shape == (SHAP_EXPLAIN, channels)
            and np.array_equal(shap["x_explain"], explained), "shap_values.npy (200, C)")

    def shap_probs(rows, impl):
        with torch.inference_mode():
            r = torch.from_numpy(np.ascontiguousarray(rows, np.float32)).to(dev)
            logits = classifier_apply(params, r[:, None, :].expand(r.shape[0], steps, channels),
                                      cfg, compute_dtype=bf16, lstm_impl=impl)
            return torch.softmax(logits, dim=-1)[:, 1]

    fx = shap_probs(explained, "kernel").double().cpu().numpy()
    phi0 = float(np.mean(shap_probs(background, "kernel").double().cpu().numpy()))
    eff = np.abs(shap_values.sum(1) - (fx - phi0)).max()
    print(f"shap_values.npy {shap_values.shape}: sum(phi) vs f(x) - phi0 per row max abs diff "
          f"{eff:.3e} (tol {EFFICIENCY_TOL:g})", flush=True)
    require(eff <= EFFICIENCY_TOL, "the efficiency identity per row")

    # rows the stage evaluated with others in flight (pinned uploads, host
    # copies read late), solved again from synchronous evaluations of the
    # same coalitions: a copy read before it landed would change them
    z = _sample_coalitions(np.random.RandomState(EXPLAIN_SEED), channels, SHAP_COALITIONS)
    design = z[:, :-1] - z[:, -1:]

    def synth_rows(i):
        return np.where(z[:, None, :] > 0, explained[i][None, None, :],
                        background[None, :, :]).reshape(-1, channels)

    row_err = {}
    for i in SHAP_CHECK_ROWS:
        v = shap_probs(synth_rows(i), "kernel").double().cpu().numpy().reshape(
            SHAP_COALITIONS, SHAP_BG).mean(axis=1)
        coef, *_ = np.linalg.lstsq(design, v - phi0 - z[:, -1] * (fx[i] - phi0), rcond=None)
        phi = np.append(coef, (fx[i] - phi0) - coef.sum())
        row_err[i] = np.abs(phi - shap_values[i]).max()
    print(f"shap_values rows {list(SHAP_CHECK_ROWS)} vs synchronous evaluations of their "
          f"coalitions: max abs diff {max(row_err.values()):.3e} (tol {SHAP_ROW_TOL:g}), "
          f"bitwise {all(e == 0 for e in row_err.values())}", flush=True)
    require(max(row_err.values()) <= SHAP_ROW_TOL, "the in-flight rows' SHAP values reproduced")

    # one KernelSHAP evaluation (the stage's first: its coalitions, the first
    # explained row over the background), kernel path against the plain path
    synth = synth_rows(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # what the earlier phases still hold
    got = shap_probs(synth, "kernel")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    shap_err = hold_at_main_shape(
        f"KernelSHAP evaluation B={len(synth)} T={steps} C={channels} (time-tiled rows, eval "
        f"kernels): P(closed)", [got], [shap_probs(synth, "kernel")], [shap_probs(synth, "plain")],
        PROBS_TOL, relative=False)
    rows_dev = torch.from_numpy(synth.astype(np.float32)).to(dev)

    def eval_rows(r):
        with torch.inference_mode():
            classifier_apply(params, r[:, None, :].expand(r.shape[0], steps, channels), cfg,
                             compute_dtype=bf16)

    ms_big = cuda_ms(lambda: eval_rows(rows_dev), 3)
    ms_1024 = cuda_ms(lambda: eval_rows(rows_dev[:BUCKET]), 5)
    require(len(shap_spans) == 2 + SHAP_EXPLAIN, "a span for each of KernelSHAP's forwards")
    busy = sum(start.elapsed_time(end) for start, end in shap_spans) / 1e3
    print(f"KernelSHAP evaluation B={len(synth)}: peak device memory "
          f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated), "
          f"{(peak - held) / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB held before it; "
          f"classifier eval "
          f"{ms_big:.3f} ms, {ms_big / len(synth) * 1e3:.3f} us a window; at B={BUCKET} "
          f"{ms_1024:.3f} ms, {ms_1024 / BUCKET * 1e3:.3f} us a window; phase 6's predict_batch "
          f"at B={BUCKET} {infer_ms_1024 / BUCKET * 1e3:.3f} us a window; the kernel-shap "
          f"step's {len(shap_spans)} classifier forwards {busy:.2f} s of device time (CUDA "
          f"events around each in the stage) in its {shap_s:.2f} s, an idle share of "
          f"{100 * (1 - busy / shap_s):.1f} % [{smi}]", flush=True)
    del rows_dev

    # one permuted stack (the stage's channel of largest importance), kernel
    # path against the plain path, and that channel's importance on both
    rng = np.random.RandomState(EXPLAIN_SEED)
    pidx = rng.choice(n_test, PERM_WINDOWS, replace=False)
    perms = np.stack([[rng.permutation(PERM_WINDOWS) for _ in range(PERM_REPEATS)]
                      for _ in range(channels)])
    ch = int(np.argmax(perm["importance"]))
    x_dev = torch.from_numpy(np.ascontiguousarray(x_test[pidx])).to(dev)
    flat = torch.from_numpy(perms[ch].reshape(-1)).to(dev)
    stacked = torch.where(torch.arange(channels, device=dev) == ch, x_dev[flat],
                          x_dev.repeat(PERM_REPEATS, 1, 1))

    def stack_logits(impl):
        with torch.inference_mode():
            return classifier_apply(params, stacked, cfg, compute_dtype=bf16, lstm_impl=impl)

    lk, lp = stack_logits("kernel"), stack_logits("plain")
    perm_err = hold_at_main_shape(
        f"permuted stack B={len(stacked)} T={steps} C={channels} (channel {ch}): P(closed)",
        [torch.softmax(lk, -1)[:, 1]], [torch.softmax(stack_logits("kernel"), -1)[:, 1]],
        [torch.softmax(lp, -1)[:, 1]], PROBS_TOL, relative=False)

    def channel_importance(impl, logits):
        base = float((predict_probs(params, x_test[pidx], cfg, 5120, lstm_impl=impl).argmax(1)
                      == y_test[pidx]).mean())
        hits = (logits.argmax(-1).reshape(PERM_REPEATS, -1).cpu().numpy() == y_test[pidx])
        accs = hits.sum(1).astype(np.float32) * np.float32(1.0 / PERM_WINDOWS)
        return float(np.mean(base - accs))

    imp_k, imp_p = channel_importance("kernel", lk), channel_importance("plain", lp)
    print(f"permutation importance of channel {ch}: stage {perm['importance'][ch]:.6f}, kernel "
          f"path {imp_k:.6f}, plain path {imp_p:.6f}", flush=True)
    require(imp_k == perm["importance"][ch], "the stage's permutation importance reproduced")
    del x_dev, stacked, lk, lp

    # the input gradients at B=100 (the stage's windows), kernel path against
    # the plain path, and the gradient importance on both
    gidx = np.random.RandomState(EXPLAIN_SEED).choice(n_test, GRAD_WINDOWS, replace=False)
    xb = torch.from_numpy(np.ascontiguousarray(x_test[gidx])).to(dev)
    grad_err = hold_at_main_shape(
        f"input gradients B={GRAD_WINDOWS} T={steps} C={channels} (lstm_fwd_train, lstm_bwd, "
        f"pool_head_bwd, input_block_bwd without dropout): dlogit/dx",
        [batch_input_gradients(params, xb, cfg, "kernel")],
        [batch_input_gradients(params, xb, cfg, "kernel")],
        [batch_input_gradients(params, xb, cfg, "plain")], STEP_GRAD_REL_TOL, relative=True)
    plain_grad = originals["gradient_channel_importance"](
        params, cfg, x_test, channel_names=grad["channels"], lstm_impl="plain")
    gk, gp = np.asarray(grad["importance"]), np.asarray(plain_grad["importance"])
    print(f"gradient importance, kernel path (the stage's) vs plain path: max abs diff "
          f"{np.abs(gk - gp).max():.3e}; top 5 {grad['ranking'][:5]} vs "
          f"{plain_grad['ranking'][:5]}; {np.round(gk, 5).tolist()} vs "
          f"{np.round(gp, 5).tolist()}", flush=True)

    # forecast: the trajectories of three start indices against solve_ivp
    fres = load_results(results / "forecasting_results.json")
    require(list(fres["metrics"]) == ["5", "10", "20"] and all(
        math.isfinite(v) for m in fres["metrics"].values() for v in m.values()),
        "forecasting_results has finite metrics at 5, 10 and 20 steps")
    p_closed = predict_probs(params, x_test, cfg, TrainConfig().eval_batch_size)[:, 1]
    rates = load_results(results / "ode_results.json")["fitted_params"]
    k = rates_to_array(rates, dev)
    starts = [0, n_test // 2, n_test - 21]
    y0 = torch.from_numpy(prob_to_ode_state(p_closed[starts]).astype(np.float32)).to(dev)
    with torch.inference_mode():
        traj = solve_batch(y0, 0.0, 20.0, 21, k.expand(len(starts), 6)).cpu().numpy()
    kk = k.cpu().double().numpy()

    def rhs(t, y):
        a, pp, f = y
        return [-(kk[0] + kk[1]) * a + kk[2] * pp + kk[4] * f,
                kk[0] * a - (kk[2] + kk[3]) * pp + kk[5] * f,
                kk[1] * a + kk[3] * pp - (kk[4] + kk[5]) * f]

    ode_err = max(np.abs(traj[i] - solve_ivp(
        rhs, (0.0, 20.0), prob_to_ode_state(p_closed[s]), t_eval=np.arange(21.0), rtol=1e-10,
        atol=1e-12).y.T).max() for i, s in enumerate(starts))
    fc = multistep_forecast(p_closed, k, (5, 10, 20))
    read = max(abs(fc[h]["predictions"][s] - np.clip(traj[i, h, 2] + 0.5 * traj[i, h, 1], 0, 1))
               for h in (5, 10, 20) for i, s in enumerate(starts))
    print(f"forecast: trajectories from start indices {starts} vs solve_ivp max abs diff "
          f"{ode_err:.3e} (tol {FORECAST_TOL:g}); the readouts F + P/2 {read:.3e}; metrics "
          f"{fres['metrics']}", flush=True)
    require(ode_err <= FORECAST_TOL and read <= FORECAST_TOL, "forecast trajectories")

    # export: the reference's columns, a row a window, predict_batch's final states
    for split in splits:
        df = pd.read_csv(results / f"{split}_sample_probabilities.csv")
        final = predict_batch(model, arrays[f"X_{split}"])["final_state"]
        got3 = df[["Prob_EyesOpen", "Prob_Drowsy", "Prob_EyesClosed"]].to_numpy(np.float32)
        print(f"export {split}: {len(df)} rows, three-state probabilities equal predict_batch's "
              f"final_state bitwise: {np.array_equal(got3, final)}", flush=True)
        require(list(df.columns) == SAMPLE_COLUMNS and len(df) == len(final)
                and np.array_equal(got3, final), f"{split}_sample_probabilities.csv")
    parts = pd.read_csv(results / "participant_probabilities.csv")
    require(list(parts.columns) == PARTICIPANT_COLUMNS and len(parts) == 5,
            "participant_probabilities.csv")
    print(f"analysis stage times: {', '.join(f'{k} {v:.1f} s' for k, v in times.items())}; "
          f"total {sum(times.values()):.1f} s [{smi}]", flush=True)
    return {"launches": sum(counts.values(), Counter()), "shap_err": shap_err,
            "perm_err": perm_err, "grad_err": grad_err}


def ablation_phase(dev, smi, out_dir):
    """Phase 19: the ablate stage as a CLI call on the card on phase 17's
    processed set under ``out_dir`` (and phase 18's coupling_analysis.json),
    at hidden 256 (ABLATE_EPOCHS epochs, bf16) and at hidden 512 for one
    epoch; each variant's launches per micro-step and per eval batch, its
    training time and test accuracy; the JSON against the reference's
    contracts; one B=512 micro-step per variant (and the Full Model at
    hidden 512) against the plain path and a bitwise repeat; kernels 7, 8
    and 10 in their wide bf16 classes at B=512 against their twins, bitwise
    repeats, timed. -> launches, errors, times and work of the wide kernels."""
    from collections import Counter

    from eegflow_torch import kernels
    from eegflow_torch.analyze import ablation
    from eegflow_torch.cli.main import load_splits
    from eegflow_torch.cli.main import main as cli_main
    from eegflow_torch.core.artifacts import load_results
    from eegflow_torch.core.config import ModelConfig
    from eegflow_torch.core.prng import make_generator
    from eegflow_torch.nn.cuda_attention import (pool_head_bwd, pool_head_bwd_bf16_plan,
                                                 pool_head_bwd_plain, pool_head_fused,
                                                 pool_head_fused_plain)
    from eegflow_torch.nn.cuda_input import (input_block_bwd, input_block_bwd_bf16_plan,
                                             input_block_bwd_plain, input_block_fused,
                                             input_block_fused_plain)
    from eegflow_torch.nn.losses import cross_entropy_loss
    from eegflow_torch.nn.model import classifier_apply, classifier_init, draw_dropout_masks

    arrays, _ = load_splits(out_dir)
    n_train, n_test = len(arrays["y_train"]), len(arrays["y_test"])
    bs = min(B_TRAIN, max(n_train // 2, 1))
    results_dir = out_dir / "results"
    out = {"launches": Counter(), "wide": Counter(), "work": {}, "ms": {}, "err": {},
           "plan": {}}

    def launches_of(variant):
        """(per micro-step, per eval batch) launches of a variant: one LSTM
        forward and backward a layer and direction, the pool-head pair only
        with attention."""
        bidirectional, attention, layers = ABLATE_VARIANTS[variant]
        lstm = layers * (2 if bidirectional else 1)
        train = {"input_block_fwd": 1, "input_block_bwd": 1, "lstm_fwd_train": lstm,
                 "lstm_bwd": lstm}
        evals = {"input_block_fwd": 1, "lstm_fwd": lstm}
        if attention:
            train.update(pool_head_fwd=1, pool_head_bwd=1)
            evals["pool_head_fwd"] = 1
        return train, evals

    def run(hidden, epochs):
        """One ablate call; each variant's counts read around its training
        and its evaluation."""
        records = []
        train_fn, probs_fn = ablation.quick_train_evaluate, ablation.predict_probs

        def timed_train(model_cfg, *args, **kw):
            rec = {}

            def timed_probs(*a, **k):
                torch.cuda.synchronize()
                rec["train_s"] = time.perf_counter() - rec["t0"]
                rec["train"] = dict(kernels.launch_counts)
                kernels.reset_launch_counts()
                probs = probs_fn(*a, **k)
                rec["eval"] = dict(kernels.launch_counts)
                return probs

            ablation.predict_probs = timed_probs
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            rec["t0"] = time.perf_counter()
            try:
                metrics, preds = train_fn(model_cfg, *args, **kw)
            finally:
                ablation.predict_probs = probs_fn
            rec["metrics"] = metrics
            records.append(rec)
            return metrics, preds

        argv = ["--output-dir", str(out_dir), "ablate", "--device", dev.type]
        if hidden != 256:
            argv += ["--hidden", str(hidden)]
        if epochs != 10:
            argv += ["--epochs", str(epochs)]
        ablation.quick_train_evaluate = timed_train
        t0 = time.perf_counter()
        try:
            rc, text = run_cli(cli_main, argv)
        finally:
            ablation.quick_train_evaluate = train_fn
        torch.cuda.synchronize()
        stage_s = time.perf_counter() - t0
        require(rc == 0 and len(records) == len(ABLATE_VARIANTS), f"ablate {argv[2:]} ran")
        check_figures("ablate", text, out_dir)
        steps, batches = n_train // bs * epochs, -(-n_test // (2 * bs))
        total = Counter()
        for variant, rec in zip(ABLATE_VARIANTS, records):
            train, evals = launches_of(variant)
            total.update(rec["train"])
            total.update(rec["eval"])
            ok = (rec["train"] == {k: v * steps for k, v in train.items()}
                  and rec["eval"] == {k: v * batches for k, v in evals.items()})
            print(f"ablate hidden {hidden} {variant}: {steps} micro-steps of {bs} in "
                  f"{rec['train_s']:.2f} s ({steps * bs / rec['train_s']:.1f} windows/s), "
                  f"test accuracy {rec['metrics']['accuracy']:.4f} f1 "
                  f"{rec['metrics']['f1']:.4f}; launches per micro-step "
                  f"{ {k: v / steps for k, v in rec['train'].items()} }, per eval batch "
                  f"{ {k: v / batches for k, v in rec['eval'].items()} } ({batches} batches): "
                  f"{ok} [{smi}]", flush=True)
            require(ok, f"ablate hidden {hidden} {variant}: launches per micro-step and batch")
            bidirectional, attention, _ = ABLATE_VARIANTS[variant]
            if hidden > 256:  # kernel 10's wide class, kernel 9's 32-row tiles; kernels 7 and
                # 8's wide classes at D = 2H = 1024
                out["wide"]["input_block_bwd"] += rec["train"]["input_block_bwd"]
                out["wide"]["input_block_fwd"] += (rec["train"]["input_block_fwd"]
                                                   + rec["eval"]["input_block_fwd"])
                if attention and bidirectional:
                    out["wide"]["pool_head_fwd"] += (rec["train"]["pool_head_fwd"]
                                                     + rec["eval"]["pool_head_fwd"])
                    out["wide"]["pool_head_bwd"] += rec["train"]["pool_head_bwd"]
        require(all(total[k] > 0 for k in ("input_block_fwd", "input_block_bwd", "lstm_fwd",
                                             "lstm_fwd_train", "lstm_bwd", "pool_head_fwd",
                                             "pool_head_bwd")),
                f"ablate hidden {hidden} launched every kernel of its path")
        out["launches"].update(total)

        # the JSON: the reference's keys and contracts
        res = load_results(results_dir / "sensitivity_analysis.json")
        abl, comp, cis = res["ablation"], res["statistical_comparison"], res["bootstrap_cis"]
        full = abl["Full Model"]["metrics"]["accuracy"]
        contrib = {c: full - abl[v]["metrics"]["accuracy"] for c, v in (
            ("attention", "No Attention"), ("bidirectional", "Unidirectional"),
            ("depth", "1 Layer"))}
        ok = (list(res) == ["ablation", "statistical_comparison", "bootstrap_cis",
                            "component_contributions", "coupling_sensitivity"]
              and list(abl) == list(ABLATE_VARIANTS) == list(cis)
              and list(comp) == list(ABLATE_VARIANTS)[1:]
              and all(0 <= r["metrics"][m] <= 1 for r in abl.values() for m in ("accuracy", "f1"))
              and all(0 <= c["mcnemar"]["p_value"] <= 1 for c in comp.values())
              and all(ci["lower"] <= ci["mean"] <= ci["upper"] for ci in cis.values())
              and res["component_contributions"] == contrib
              and res["coupling_sensitivity"] == load_results(
                  results_dir / "coupling_analysis.json")
              and "Architecture ablation" in (results_dir / "results_tables.txt").read_text())
        print(f"ablate hidden {hidden}: {stage_s:.1f} s for the stage; "
              f"sensitivity_analysis.json keys {list(res)}, contributions "
              f"{res['component_contributions']}; the reference's contracts hold: {ok} "
              f"[{smi}]", flush=True)
        require(ok, f"ablate hidden {hidden}: sensitivity_analysis.json")
        return stage_s

    out["stage_s"] = {256: run(256, ABLATE_EPOCHS),
                      ABLATE_WIDE_H: run(ABLATE_WIDE_H, ABLATE_WIDE_EPOCHS)}

    # one B=512 micro-step per variant, kernel path against plain path
    rng = np.random.default_rng(SEED + 19)
    x, y = synthetic_split(rng, B_TRAIN, T, C)
    x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    for variant, hidden in [(v, H) for v in ABLATE_VARIANTS] + [("Full Model", ABLATE_WIDE_H)]:
        bidirectional, attention, layers = ABLATE_VARIANTS[variant]
        cfg = ModelConfig(input_size=C, hidden_size=hidden, num_layers=layers, dropout=0.4,
                          bidirectional=bidirectional, use_attention=attention)
        params = classifier_init(cfg, make_generator(SEED + 19), device=dev, trainable=True)
        masks = draw_dropout_masks(cfg, B_TRAIN, T, torch.Generator(device=dev).manual_seed(19),
                                   dev)
        leaves = list(params.parameters())

        def step(impl):
            for q in leaves:
                q.grad = None
            logits = classifier_apply(params, x, cfg, compute_dtype=torch.bfloat16,
                                      lstm_impl=impl, train=True, masks=masks)
            loss = cross_entropy_loss(logits, y)
            loss.backward()
            return loss.detach(), [q.grad.clone() if q.grad is not None else torch.zeros_like(q)
                                   for q in leaves]

        loss_k, grads_k = step("kernel")
        loss_k2, grads_k2 = step("kernel")
        loss_p, grads_p = step("plain")
        torch.cuda.synchronize()
        loss_diff = abs(loss_k.item() - loss_p.item())
        grad_rel = max(rel_err(a, b) for a, b in zip(grads_k, grads_p) if b.abs().max() > 0)
        bitwise = torch.equal(loss_k, loss_k2) and all(torch.equal(a, b)
                                                       for a, b in zip(grads_k, grads_k2))
        print(f"ablate micro-step {variant} hidden {hidden} B={B_TRAIN}: loss kernel "
              f"{loss_k.item():.6f} plain {loss_p.item():.6f} (diff {loss_diff:.3e}, tol "
              f"{STEP_LOSS_TOL:g}); gradients max rel diff {grad_rel:.3e} over {len(leaves)} "
              f"leaves (tol {STEP_GRAD_REL_TOL:g}); second kernel run bitwise identical: "
              f"{bitwise}", flush=True)
        require(math.isfinite(loss_k.item()) and loss_diff <= STEP_LOSS_TOL
                and grad_rel <= STEP_GRAD_REL_TOL and bitwise,
                f"ablate micro-step {variant} hidden {hidden}: kernel path within tolerance "
                "of the plain path and bitwise repeatable")
        if hidden == ABLATE_WIDE_H:
            m = median_ms({"plain": lambda: step("plain"), "kernel": lambda: step("kernel")},
                          rounds=1)
            print(f"training micro-step (forward + backward) hidden {hidden} B={B_TRAIN} T={T}: "
                  f"kernel {m['kernel']:.3f} ms ({B_TRAIN / m['kernel'] * 1e3:.1f} windows/s), "
                  f"plain {m['plain']:.3f} ms [{smi}]", flush=True)
        del params, masks, leaves, grads_k, grads_k2, grads_p

    # kernels 7, 8 and 10 in their wide bf16 classes and kernel 9 on its 32-row tiles at
    # B=512, on hidden-512 weights
    wide = classifier_init(ModelConfig(input_size=C, hidden_size=ABLATE_WIDE_H), make_generator(
        SEED + 190), device=dev)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 190)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    hw = ABLATE_WIDE_H
    parts = tuple(torch.tanh(randn(B_TRAIN, T, hw)) for _ in range(2))
    fargs = (wide["lstm_norm"], wide["attention"], parts, True, True)
    bargs = (wide["lstm_norm"], wide["attention"], parts, torch.softmax(randn(B_TRAIN, T), dim=-1),
             0.01 * randn(B_TRAIN, T), tuple(0.1 * randn(B_TRAIN, hw) for _ in range(2)),
             0.1 * randn(B_TRAIN), True, True)
    iargs = (wide["input_proj"], wide["input_norm"], randn(B_TRAIN, T, C),
             randn(B_TRAIN, T, hw), True)
    ifargs = (*iargs[:3], True)
    flat_head = lambda o: list(o[0]) + [o[1]]  # noqa: E731
    flat_bwd = lambda o: list(o[0]) + [t for t in o[1:] if t is not None]  # noqa: E731
    head_flops = 2 * B_TRAIN * T * 2 * hw * hw  # y . W1 at D = 2H, K = H
    for name, kfn, pfn, args, flat, tol, relative, flops in (
            ("pool_head_fwd bf16 wide", pool_head_fused, pool_head_fused_plain, fargs, flat_head,
             POOL_TOL, False, head_flops),
            ("pool_head_bwd bf16 wide", pool_head_bwd, pool_head_bwd_plain, bargs, flat_bwd,
             POOL_BWD_REL_TOL, True, 3 * head_flops),
            ("input_block_bwd bf16 wide", input_block_bwd, input_block_bwd_plain, iargs, list,
             INPUT_BWD_REL_TOL[True], True, 3 * 2 * B_TRAIN * T * C * hw),
            ("input_block_fwd bf16 wide", input_block_fused, input_block_fused_plain, ifargs,
             lambda o: [o], INPUT_TOL, False, 2 * B_TRAIN * T * C * hw)):
        out["err"][name] = hold_at_main_shape(
            f"{name} B={B_TRAIN} T={T} H={hw}", flat(kfn(*args)), flat(kfn(*args)),
            flat(pfn(*args)), tol, relative)
        out["work"][name] = (nbytes(args, kfn(*args)), flops, "bf16")
        m = median_ms({"plain": lambda: pfn(*args), "kernel": lambda: kfn(*args)}, rounds=1)
        out["ms"][name] = (m["kernel"], m["plain"])
        bound_ms, bound_by = bound(*out["work"][name])
        if name.startswith("pool_head_bwd"):
            # kernel 8: the row kernel, cluster, tile and shared memory that its
            # C entry point launches with
            plan = pool_head_bwd_bf16_plan(2 * hw, hw)
            require(plan.wide, f"{name}: D={2 * hw}, K={hw} take the wide class ({plan})")
            out["plan"][name] = {"kernel": plan.kernel, "cluster": plan.cluster,
                                 "tile_rows": plan.tile_rows, "smem": plan.smem}
            print(f"{name}: {out['plan'][name]}", flush=True)
        if name.startswith("input_block_bwd"):
            # kernel 10: the row kernel, cluster, tile, shared memory and the
            # clusters the card holds, as its C entry point launches them
            plan = input_block_bwd_bf16_plan(C, hw)
            require(plan.wide and plan.cluster == 2 and plan.tile_rows == 64
                    and plan.kernel == "input_block_bwd_wide_kernel",
                    f"{name}: C={C}, H={hw} take the wide class, a cluster of two CTAs a "
                    f"64-row tile ({plan})")
            out["plan"][name] = {"kernel": plan.kernel, "cluster": plan.cluster,
                                 "tile_rows": plan.tile_rows, "smem": plan.smem,
                                 "clusters_held": plan.held}
            print(f"{name}: {out['plan'][name]}", flush=True)
        print(f"{name} B={B_TRAIN} T={T} H={hw}: kernel {m['kernel']:.3f} ms, plain "
              f"{m['plain']:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}) [{smi}]", flush=True)
    return out


def feature_oracle(x, fs):
    """The reference's 20 features a channel (ref 03:151-258) in float64
    numpy, 1,024 windows at a time: (N, T, C) -> (N, C, 20)."""
    n, t, c = x.shape
    freqs = np.fft.rfftfreq(t, 1 / fs)
    masks = [(freqs >= lo) & (freqs < hi) for lo, hi in
             ((0.5, 4), (4, 8), (8, 13), (13, 30), (30, 45))]
    out = np.empty((n, c, 20))
    for i in range(0, n, 1024):
        s = np.ascontiguousarray(x[i:i + 1024].transpose(0, 2, 1), np.float64)  # (b, C, T)
        mean = s.mean(-1)
        std, var = s.std(-1, ddof=1), s.var(-1, ddof=1)
        mn, mx = s.min(-1), s.max(-1)
        cen = s - mean[..., None]
        cen2 = cen * cen  # products, not pow: numpy's float64 pow is ~20x slower
        m2, m3, m4 = cen2.mean(-1), (cen2 * cen).mean(-1), (cen2 * cen2).mean(-1)
        d1 = np.diff(s, axis=-1)
        d2 = np.diff(d1, axis=-1)
        mob = d1.std(-1, ddof=1) / (std + 1e-10)
        comp = (d2.std(-1, ddof=1) / (d1.std(-1, ddof=1) + 1e-10)) / (mob + 1e-10)
        p = np.abs(np.fft.rfft(s, axis=-1)) ** 2
        delta, theta, alpha, beta, gamma = (p[..., m].sum(-1) for m in masks)
        tot = delta + theta + alpha + beta + gamma + 1e-10
        out[i:i + 1024] = np.stack(
            [mean, std, var, mn, mx, mx - mn, m3 / (m2 ** 1.5 + 1e-10),
             m4 / (m2 ** 2 + 1e-10) - 3,
             np.abs(np.diff(np.sign(cen), axis=-1)).sum(-1) / 2 / t, (s ** 2).mean(-1), var,
             mob, comp, delta / tot, theta / tot, alpha / tot, beta / tot, gamma / tot,
             alpha / (theta + 1e-10), alpha / (beta + 1e-10)], axis=-1)
    return out


def eda_phase(dev, smi, tmp):
    """Phase 21: the explore stage as a CLI call on phase 17's raw recordings
    under ``tmp / "data"``, Welch on the card against scipy and its CPU run,
    the baselines' feature extraction on phase 17's three splits against a
    float64 oracle (a bitwise repeat, the cache read back) and timed on 50,000
    windows; which of sklearn and matplotlib import. No estimator runs where
    sklearn does not import. -> the numbers it printed."""
    from scipy import signal as sps

    from eegflow_torch import kernels
    from eegflow_torch.baselines.classical import load_or_extract_features
    from eegflow_torch.cli.main import main as cli_main
    from eegflow_torch.core.artifacts import load_processed, load_results
    from eegflow_torch.data.bids import discover_recordings
    from eegflow_torch.data.brainvision import read_brainvision
    from eegflow_torch.signal.features import _extract, extract_features
    from eegflow_torch.signal.spectral import band_power, welch_psd

    out = {}
    imports = {}
    try:
        __import__("sklearn")
        imports["sklearn"] = True
        print("host package sklearn: imports on this machine")
    except ImportError as e:
        imports["sklearn"] = False
        print(f"host package sklearn: does not import ({e})")
    # looked up, not imported: no phase imports matplotlib
    print("host package matplotlib: "
          + ("installed" if importlib.util.find_spec("matplotlib") else "not installed"))
    if imports["sklearn"]:
        print("estimators: sklearn imports, but this phase runs none (their results are held "
              "to the JAX package's on the CPU by tests/test_torch_baselines.py)")
    else:
        print("estimators: none run here; sklearn does not import, so the baselines, parity "
              "and all stages stop at their first estimator on this machine")

    # explore as a user runs it
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc, text = run_cli(cli_main, ["--data-dir", str(tmp / "data"), "--output-dir",
                                  str(tmp / "out"), "explore", "--device", dev.type])
    torch.cuda.synchronize()
    out["explore_s"] = time.perf_counter() - t0
    check_figures("explore", text, tmp / "out")
    launches = {k: v for k, v in kernels.launch_counts.items() if v}
    summary = load_results(tmp / "out" / "results" / "eda_summary.json")
    report = (tmp / "out" / "results" / "eda_report.md").read_text()
    print(f"explore: {out['explore_s']:.1f} s, census {summary['census']['n_recordings']} "
          f"recordings of {summary['census']['n_subjects']} subjects, statistics "
          f"{summary['statistics']}, alpha closed/open ratio {summary['alpha_ratio']:.6f}, "
          f"kernel launches {launches} [{smi}]", flush=True)
    require(rc == 0 and set(summary) == {"census", "statistics", "alpha_ratio"}
            and summary["census"]["n_recordings"] == 2 * PIPE_SUBJECTS
            and summary["census"]["n_subjects"] == PIPE_SUBJECTS
            and summary["statistics"]["n_recordings"] == 5
            and summary["statistics"]["sampling_rates"] == [500.0]
            and "Alpha (8-13 Hz) closed/open power ratio" in report and not launches,
            "explore writes the reference's summary and report and launches no kernel")

    # the same channel of the same two recordings in float64 through scipy
    recs = discover_recordings(tmp / "data")
    open_data, header = read_brainvision(next(r for r in recs if r["label"] == 0)["vhdr_path"])
    closed_data, _ = read_brainvision(next(r for r in recs if r["label"] == 1)["vhdr_path"])
    fs = header["sampling_rate"]
    names = [c["name"] for c in header["channels"]]
    ch = next((names.index(w) for w in ("O1", "Oz", "O2", "POz", "Pz") if w in names),
              len(open_data) - 1)
    f_ref, p_open = sps.welch(open_data[ch].astype(np.float64), fs, nperseg=1024)
    _, p_closed = sps.welch(closed_data[ch].astype(np.float64), fs, nperseg=1024)
    want = (band_power(f_ref, p_closed, (8.0, 13.0))
            / (band_power(f_ref, p_open, (8.0, 13.0)) + 1e-30))
    ratio_err = abs(summary["alpha_ratio"] - want) / want
    print(f"explore alpha ratio on {names[ch]}: {summary['alpha_ratio']:.6f}, scipy float64 "
          f"{want:.6f}, relative diff {ratio_err:.3e} (tol {WELCH_SCIPY_RTOL:g})", flush=True)
    require(ratio_err <= WELCH_SCIPY_RTOL, "the alpha ratio within tolerance of scipy's")

    # Welch on the card, both full recordings, every channel
    for label, data in (("open", open_data), ("closed", closed_data)):
        freqs, psd = welch_psd(data, fs, 1024, device=dev)
        _, psd_cpu = welch_psd(data, fs, 1024, device="cpu")
        f_ref, p_ref = sps.welch(data.astype(np.float64), fs, nperseg=1024)
        err_scipy = float((np.abs(psd - p_ref) / p_ref).max())
        err_cpu = float((np.abs(psd - psd_cpu) / psd_cpu).max())
        print(f"welch_psd on the card, eyes-{label} recording {data.shape}: relative diff per "
              f"bin vs scipy float64 {err_scipy:.3e} (tol {WELCH_SCIPY_RTOL:g}), vs its CPU "
              f"run {err_cpu:.3e} (tol {WELCH_CPU_RTOL:g})", flush=True)
        require(np.array_equal(freqs, f_ref) and psd.shape == p_ref.shape
                and err_scipy <= WELCH_SCIPY_RTOL and err_cpu <= WELCH_CPU_RTOL,
                f"welch_psd ({label}) within tolerance of scipy and of its CPU run")

    # the baselines' features of phase 17's splits, cached where the stage caches them
    arrays, _ = load_processed(tmp / "out" / "processed_data" / "processed_sequences.npz")
    for split in ("train", "val", "test"):
        x = np.asarray(arrays[f"X_{split}"])
        cache = tmp / "out" / "models" / f"features_{split}.npz"
        require(not cache.exists(), f"no features_{split}.npz before this phase")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        feats = load_or_extract_features(x, cache, fs, device=dev)
        secs = time.perf_counter() - t0
        again = extract_features(x, fs, device=dev)
        read_back = load_or_extract_features(x[:0], cache, fs, device=dev)
        n, t, c = x.shape
        got = feats.reshape(n, c, 20)
        want = feature_oracle(x, fs)
        rest_got, rest_want = np.delete(got, 8, -1), np.delete(want, 8, -1)
        outside = int((np.abs(rest_got - rest_want)
                       > FEATURE_ORACLE_TOL + FEATURE_ORACLE_TOL * np.abs(rest_want)).sum())
        zcr_diff = np.abs(got[..., 8] - want[..., 8])
        flips = int((zcr_diff > 0.25 / t).sum())
        print(f"features {split} {x.shape} on the card: {secs:.2f} s ({n / secs:.0f} windows/s, "
              f"the cache written), {feats.shape}; non-zcr entries outside rtol/atol "
              f"{FEATURE_ORACLE_TOL:g} of the float64 oracle: {outside} of {rest_got.size}; zcr "
              f"entries that differ: {flips} of {zcr_diff.size} (bound "
              f"{ZCR_MAX_FLIP_SHARE:g} of them), largest {zcr_diff.max(initial=0.0) * t:.3f}/T; repeat "
              f"bitwise identical: {np.array_equal(feats, again)}; cache read back equal: "
              f"{np.array_equal(read_back, feats)}; kernel launches "
              f"{ {k: v for k, v in kernels.launch_counts.items() if v} }", flush=True)
        require(outside == 0 and flips <= ZCR_MAX_FLIP_SHARE * zcr_diff.size
                and zcr_diff.max(initial=0.0) <= 2 / t + 1e-6 and np.isfinite(feats).all()
                and np.array_equal(feats, again) and np.array_equal(read_back, feats)
                and feats.shape == (n, c * 20),
                f"the {split} features against the oracle, repeatable, cached")
        out[f"features_{split}_s"] = secs

    # 50,000 N(0, 1) windows: five chunks of 10,000, host -> card -> host
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    x_big = torch.randn(FEATURE_TIMING_WINDOWS, T, C, generator=gen, device=dev).cpu().numpy()
    extract_features(x_big[:FEATURE_CHUNK], device=dev)  # warm-up at the chunk's shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = extract_features(x_big, device=dev)
    wall = time.perf_counter() - t0
    # one chunk through extract_features' steps by the host clock, and the
    # host's concatenation and scrub of the five chunks' features
    marks = [time.perf_counter()]
    chunk = torch.from_numpy(x_big[:FEATURE_CHUNK]).to(dev)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    res = _extract(chunk, 500.0)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    host = res.reshape(FEATURE_CHUNK, -1).cpu().numpy()
    marks.append(time.perf_counter())
    np.nan_to_num(np.concatenate([host] * (FEATURE_TIMING_WINDOWS // FEATURE_CHUNK)),
                  nan=0.0, posinf=0.0, neginf=0.0)
    marks.append(time.perf_counter())
    steps_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    print(f"extract_features' steps by the host clock, one chunk: upload {steps_ms[0]:.2f} ms, "
          f"device work {steps_ms[1]:.2f} ms, features' download {steps_ms[2]:.2f} ms; the "
          f"host's concatenation and scrub of all {FEATURE_TIMING_WINDOWS:,} windows' "
          f"features {steps_ms[3]:.2f} ms [{smi}]", flush=True)
    compute_ms = cuda_ms(lambda: _extract(chunk, 500.0), 3)
    upload_ms = cuda_ms(lambda: torch.from_numpy(x_big[:FEATURE_CHUNK]).to(dev), 3)
    download_ms = cuda_ms(lambda: res.cpu(), 3)
    chunk_ms = wall * 1e3 * FEATURE_CHUNK / FEATURE_TIMING_WINDOWS
    read_bound = chunk.numel() * 4 / HBM_BYTES_PER_S * 1e3
    io_bound = (chunk.numel() + res.numel()) * 4 / HBM_BYTES_PER_S * 1e3
    out.update(windows_per_s=FEATURE_TIMING_WINDOWS / wall, compute_ms=compute_ms,
               upload_ms=upload_ms, chunk_ms=chunk_ms, steps_ms=steps_ms)
    print(f"extract_features on {FEATURE_TIMING_WINDOWS:,} N(0,1) windows of {T} x {C} (chunks "
          f"of {FEATURE_CHUNK:,}): {wall:.3f} s, {out['windows_per_s']:,.0f} windows/s, "
          f"{chunk_ms:.2f} ms a chunk; device ms a chunk on the card (CUDA events, the chunk "
          f"resident) {compute_ms:.3f}; its pageable upload ({chunk.numel() * 4 / 1e6:.1f} MB) "
          f"{upload_ms:.3f} ms, {upload_ms / chunk_ms:.1%} of a chunk; the features' download "
          f"{download_ms:.3f} ms; bound of one read of the chunk {read_bound:.3f} ms (with the "
          f"features written {io_bound:.3f} ms; {read_bound / compute_ms:.1%} of the device "
          f"time) [{smi}]", flush=True)
    require(feats.shape == (FEATURE_TIMING_WINDOWS, C * 20) and np.isfinite(feats).all(),
            "the timing set's features")
    del x_big, chunk, res, host
    return out


def transformer_phase(dev, smi, out_dir):
    """Phase 20: the EEGFormer and the snapshots on phase 17's processed set
    under ``out_dir``. ``train --model transformer --epochs 1`` as a CLI call
    (launches per micro-step and per eval batch), ``serve`` of its
    checkpoint in its own process (one /predict batch against the plain
    path), ``explain --skip-shap`` on it; one B=512 micro-step of
    ``TransformerConfig()`` under bf16 (kernel against plain path, a bitwise
    repeat, timed, its device time by kernel) and under float32; evals at
    B = 1,024 and 10,000; kernels 9, 10, 7 and 8 at the transformer's shapes
    against their twins; an interrupted and resumed run of the flagship and
    of the transformer against the uninterrupted one. -> launches, errors,
    times and work of the one-part pool head."""
    import shutil
    from collections import Counter

    from eegflow_torch import kernels
    from eegflow_torch.cli.main import load_coupled_model, load_splits
    from eegflow_torch.cli.main import main as cli_main
    from eegflow_torch.core.artifacts import load_checkpoint, load_results, msgpack_unpack
    from eegflow_torch.core.config import ModelConfig, TrainConfig, TransformerConfig
    from eegflow_torch.core.prng import make_generator
    from eegflow_torch.couple.rollout import predict_batch
    from eegflow_torch.nn.cuda_attention import (pool_head_bwd, pool_head_bwd_plain,
                                                 pool_head_fused, pool_head_fused_plain)
    from eegflow_torch.nn.cuda_input import (input_block_bwd, input_block_bwd_plain,
                                             input_block_fused, input_block_fused_plain)
    from eegflow_torch.nn.losses import cross_entropy_loss
    from eegflow_torch.nn.model import (classifier_apply, classifier_init, draw_dropout_masks,
                                        model_flops_per_window)
    from eegflow_torch.train import loop, steps
    from eegflow_torch.train.steps import make_eval_step

    out = {"launches": Counter(), "err": {}, "ms": {}, "work": {}}
    per_step = Counter({"input_block_fwd": 1, "input_block_bwd": 1, "pool_head_fwd": 1,
                        "pool_head_bwd": 1})
    per_eval = Counter({"input_block_fwd": 1, "pool_head_fwd": 1})
    tf_dir = out_dir.parent / "transformer"
    (tf_dir / "results").mkdir(parents=True)
    (tf_dir / "processed_data").symlink_to(out_dir / "processed_data")
    shutil.copy(out_dir / "results" / "ode_results.json", tf_dir / "results")

    # the train stage, each micro-step's and eval batch's launches read around it
    records = {"step": [], "eval": []}

    def counted(kind, make):
        def factory(*args, **kw):
            fn = make(*args, **kw)

            def call(*a, **k):
                before = Counter(kernels.launch_counts)
                res = fn(*a, **k)
                records[kind].append(Counter(kernels.launch_counts) - before)
                return res
            return call
        return factory

    made = (loop.make_train_step, loop.make_eval_step, steps.make_eval_step)
    loop.make_train_step = counted("step", made[0])
    loop.make_eval_step = steps.make_eval_step = counted("eval", made[1])
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        rc, text = run_cli(cli_main, ["--output-dir", str(tf_dir), "train", "--model",
                                      "transformer", "--epochs", "1", "--device", dev.type])
    finally:
        loop.make_train_step, loop.make_eval_step, steps.make_eval_step = made
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    check_figures("train", text, tf_dir)
    counts = Counter(kernels.launch_counts)
    out["launches"].update(counts)
    _, tf_cfg, hist, extra = load_checkpoint(tf_dir / "models" / "lstm_attention")
    results = load_results(tf_dir / "results" / "lstm_results.json")
    n_steps, n_evals = len(records["step"]), len(records["eval"])
    ok = (rc == 0 and isinstance(tf_cfg, TransformerConfig) and tf_cfg.num_layers == 3
          and tf_cfg.resolved_d_model() == H and n_steps > 0 and n_evals > 0
          and all(r == per_step for r in records["step"])
          and all(r == per_eval for r in records["eval"])
          and counts == Counter({k: v * n_steps for k, v in per_step.items()})
          + Counter({k: v * n_evals for k, v in per_eval.items()})
          and all(math.isfinite(v) for v in hist["train_loss"] + hist["val_loss"]))
    print(f"transformer train --model transformer --epochs 1: {train_s:.1f} s, {n_steps} "
          f"micro-steps of {B_TRAIN} ({extra['windows_per_sec']:.1f} windows/s), {n_evals} eval "
          f"batches; launches {dict(counts)}: {dict(per_step)} a micro-step and "
          f"{dict(per_eval)} an eval batch, no LSTM kernel: {ok}; {tf_cfg}; train_loss "
          f"{hist['train_loss']}, val_f1 {hist['val_f1']}, test accuracy "
          f"{results['accuracy']:.4f} [{smi}]", flush=True)
    require(ok, "train --model transformer: its checkpoint and its launches")

    # serve the transformer's checkpoint in its own process: one /predict batch
    arrays, _ = load_splits(out_dir)
    x_test = arrays["X_test"]
    t0 = time.perf_counter()
    with serve_process(tf_dir, dev) as addr:
        status, body = request(addr, "POST", "/predict", {"windows": x_test[:17].tolist()})
    serve_s = time.perf_counter() - t0
    require(status == 200, f"/predict on the transformer -> {status}")
    model = load_coupled_model(tf_dir, dev)
    want = predict_batch(model, x_test[:17], batch_size=BUCKET, lstm_impl="plain")
    err = max(float(np.abs(np.asarray(body[k]) - want[k]).max()) for k in ("probs", "final_state"))
    print(f"transformer serve, own process: {serve_s:.1f} s to start and answer /predict of 17 "
          f"windows; probs and final states vs the plain path max abs diff {err:.3e} (tol "
          f"{PROBS_TOL:g})", flush=True)
    require(err <= PROBS_TOL, "served transformer probabilities agree with the plain path")

    # explain --skip-shap: the input gradients (one backward) and the permutation
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc, text = run_cli(cli_main, ["--output-dir", str(tf_dir), "explain", "--skip-shap",
                                  "--device", dev.type])
    torch.cuda.synchronize()
    explain_s = time.perf_counter() - t0
    check_figures("explain", text, tf_dir)
    counts = Counter(kernels.launch_counts)
    out["launches"].update(counts)
    summary = load_results(tf_dir / "results" / "explainability_summary.json")
    evals = 2 + 1 + C  # gradient: prediction and differentiable forward; permutation
    want_counts = Counter({"input_block_fwd": evals, "pool_head_fwd": evals,
                           "input_block_bwd": 1, "pool_head_bwd": 1})
    ok = rc == 0 and counts == want_counts and len(summary["top_channels"]) > 0
    print(f"transformer explain --skip-shap: {explain_s:.1f} s, launches {dict(counts)} (want "
          f"{dict(want_counts)}): {ok}; top channels {summary['top_channels']}", flush=True)
    require(ok, "explain on the transformer's checkpoint")

    # one micro-step of TransformerConfig() at full width, kernel path against plain path
    cfg = TransformerConfig()
    require(cfg.resolved_d_model() == H and cfg.input_size == C and cfg.num_layers == 4,
            "full-width TransformerConfig defaults")
    flops = model_flops_per_window(cfg, T)
    params = classifier_init(cfg, make_generator(SEED + 20), device=dev, trainable=True)
    rng = np.random.default_rng(SEED + 20)
    x, y = synthetic_split(rng, B_TRAIN, T, C)
    x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    masks = draw_dropout_masks(cfg, B_TRAIN, T, torch.Generator(device=dev).manual_seed(20), dev)
    names, leaves = zip(*params.named_parameters())
    # the key biases' gradients are zero by symmetry (softmax over the keys
    # ignores them): rounding noise on both paths, held absolutely
    symmetric = [n.endswith("mha.key.b") for n in names]

    def step(impl, compute_dtype=torch.bfloat16):
        for q in leaves:
            q.grad = None
        logits = classifier_apply(params, x, cfg, compute_dtype=compute_dtype, lstm_impl=impl,
                                  train=True, masks=masks)
        loss = cross_entropy_loss(logits, y)
        loss.backward()
        return loss.detach(), [q.grad.clone() if q.grad is not None else torch.zeros_like(q)
                               for q in leaves]

    for policy, dtype, loss_tol, grad_tol in (("bf16", torch.bfloat16, STEP_LOSS_TOL,
                                               STEP_GRAD_REL_TOL),
                                              ("float32", None, STEP32_LOSS_TOL,
                                               STEP32_GRAD_REL_TOL)):
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev) / 2 ** 30
        kernels.reset_launch_counts()
        loss_k, grads_k = step("kernel", dtype)
        launched = Counter(kernels.launch_counts)
        loss_k2, grads_k2 = step("kernel", dtype)
        loss_p, grads_p = step("plain", dtype)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        loss_diff = abs(loss_k.item() - loss_p.item())
        grad_rel = max(rel_err(a, b) for a, b, sym in zip(grads_k, grads_p, symmetric)
                       if b.abs().max() > 0 and not sym)
        noise = max(max(a.abs().max().item(), b.abs().max().item())
                    for a, b, sym in zip(grads_k, grads_p, symmetric) if sym)
        bitwise = torch.equal(loss_k, loss_k2) and all(torch.equal(a, b)
                                                       for a, b in zip(grads_k, grads_k2))
        print(f"transformer micro-step {policy} B={B_TRAIN} T={T} D={H} 4 layers: loss kernel "
              f"{loss_k.item():.6f} plain {loss_p.item():.6f} (diff {loss_diff:.3e}, tol "
              f"{loss_tol:g}); gradients max rel diff {grad_rel:.3e} over {len(leaves)} leaves "
              f"(tol {grad_tol:g}), the key biases' {noise:.3e} (tol {ZERO_GRAD_TOL:g}); second "
              f"kernel run bitwise identical: {bitwise}; launches {dict(launched)}; peak "
              f"{peak:.2f} GiB ({held:.2f} GiB allocated before)", flush=True)
        require(math.isfinite(loss_k.item()) and loss_diff <= loss_tol and grad_rel <= grad_tol
                and noise <= ZERO_GRAD_TOL and bitwise and launched == per_step,
                f"transformer {policy} micro-step: kernel path within tolerance of the plain "
                "path, bitwise repeatable, one launch of each kernel")
        del grads_k, grads_k2, grads_p
        if policy == "bf16":
            m = median_ms({"plain": lambda: step("plain"), "kernel": lambda: step("kernel")})
            out["step_ms"] = m["kernel"]
            print(f"transformer micro-step bf16 B={B_TRAIN}: kernel median {m['kernel']:.3f} ms "
                  f"({B_TRAIN / m['kernel'] * 1e3:.1f} windows/s), plain {m['plain']:.3f} ms; "
                  f"{flops / 1e9:.4f} GFLOP a window forward, {3 * flops * B_TRAIN / 1e12:.4f} "
                  f"TFLOP a step, {3 * flops * B_TRAIN / m['kernel'] / 1e9:.2f} TFLOP/s achieved "
                  f"[{smi}]", flush=True)
            # device time by kernel of one step (torch.profiler): the products' share
            step("kernel")
            torch.cuda.synchronize()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                step("kernel")
                torch.cuda.synchronize()
            by_kernel = sorted(((e.device_time_total / 1e3, e.count, e.key)
                                for e in prof.key_averages() if e.device_time_total > 0),
                               reverse=True)
            total = sum(t for t, _, _ in by_kernel)
            gemm = sum(t for t, _, k in by_kernel if re.search(r"gemm|xmma|cutlass", k, re.I))
            print(f"transformer micro-step bf16 device time {total:.3f} ms, GEMM kernels "
                  f"{gemm:.3f} ms ({100 * gemm / max(total, 1e-9):.1f} %); top: "
                  + "; ".join(f"{k[:60]} {t:.3f} ms ({n})" for t, n, k in by_kernel[:8]),
                  flush=True)

    # evals at B = 1,024 and 10,000 (no gradients: kernels 9 and 7 once each)
    evaluate = make_eval_step(cfg, bf16=True)
    evaluate_plain = make_eval_step(cfg, bf16=True, lstm_impl="plain")
    x_eval = torch.from_numpy(np.resize(x_test, (TF_EVAL_BIG,) + x_test.shape[1:])).to(dev)
    kernels.reset_launch_counts()
    probs = evaluate(params, x_eval[:BUCKET])
    launched = Counter(kernels.launch_counts)
    err = (probs - evaluate_plain(params, x_eval[:BUCKET])).abs().max().item()
    m = median_ms({"plain": lambda: evaluate_plain(params, x_eval[:BUCKET]),
                   "kernel": lambda: evaluate(params, x_eval[:BUCKET])})
    print(f"transformer eval B={BUCKET}: kernel {m['kernel']:.3f} ms a batch "
          f"({m['kernel'] / BUCKET * 1e3:.3f} us a window), plain {m['plain']:.3f} ms; probs vs "
          f"plain max abs diff {err:.3e} (tol {PROBS_TOL:g}); launches {dict(launched)} "
          f"[{smi}]", flush=True)
    require(err <= PROBS_TOL and launched == per_eval, "transformer eval at 1,024")
    evaluate(params, x_eval)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev) / 2 ** 30
    big_ms = cuda_ms(lambda: evaluate(params, x_eval), 1)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    big = evaluate(params, x_eval)
    require(bool(torch.isfinite(big).all()) and big.shape == (TF_EVAL_BIG, 2),
            "transformer eval at the large batch finite")
    print(f"transformer eval B={TF_EVAL_BIG}: {big_ms:.3f} ms, "
          f"{big_ms / TF_EVAL_BIG * 1e3:.3f} us a window; "
          f"peak {peak:.2f} GiB ({held:.2f} GiB allocated before) [{smi}]", flush=True)

    # kernels 9, 10, 7 and 8 at the transformer's shapes against their twins
    gen = torch.Generator(device="cpu").manual_seed(SEED + 200)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    k = H // 2
    with torch.no_grad():
        h = torch.tanh(randn(B_TRAIN, T, H))
        h_eval = torch.tanh(randn(BUCKET, T, H))
    for bf16 in (True, False):
        mode = "bf16" if bf16 else "float32"
        iargs = (params["input_proj"], params["input_norm"], x, randn(B_TRAIN, T, H), bf16)
        fargs = (params["final_norm"], params["attention"], (h,), True, bf16)
        eargs = (params["final_norm"], params["attention"], (h_eval,), True, bf16)
        bargs = (params["final_norm"], params["attention"], (h,),
                 torch.softmax(randn(B_TRAIN, T), dim=-1), 0.01 * randn(B_TRAIN, T),
                 (0.1 * randn(B_TRAIN, H),), 0.1 * randn(B_TRAIN), True, bf16)
        flat_head = lambda o: list(o[0]) + [o[1]]  # noqa: E731
        flat_bwd = lambda o: list(o[0]) + [t for t in o[1:] if t is not None]  # noqa: E731
        pool_tol = POOL_TOL if bf16 else POOL32_TOL
        in_shape, pool_shape = f"C={C} H={H}", f"one part D={H} K={k}"
        for name, batch, shape, kfn, pfn, args, flat, tol, relative in (
                (f"input_block_fwd {mode}", B_TRAIN, in_shape, input_block_fused,
                 input_block_fused_plain, iargs[:3] + iargs[4:], lambda o: [o], INPUT_TOL,
                 False),
                (f"input_block_bwd {mode}", B_TRAIN, in_shape, input_block_bwd,
                 input_block_bwd_plain, iargs, list, INPUT_BWD_REL_TOL[bf16], True),
                (f"pool_head_fwd one part {mode}", B_TRAIN, pool_shape, pool_head_fused,
                 pool_head_fused_plain, fargs, flat_head, pool_tol, False),
                (f"pool_head_fwd one part {mode} eval", BUCKET, pool_shape, pool_head_fused,
                 pool_head_fused_plain, eargs, flat_head, pool_tol, False),
                (f"pool_head_bwd one part {mode}", B_TRAIN, pool_shape, pool_head_bwd,
                 pool_head_bwd_plain, bargs, flat_bwd, POOL_BWD_REL_TOL, True)):
            out["err"][name] = hold_at_main_shape(
                f"transformer {name} B={batch} T={T} {shape}", flat(kfn(*args)),
                flat(kfn(*args)), flat(pfn(*args)), tol, relative)
            if name in ("pool_head_fwd one part bf16", "pool_head_bwd one part bf16"):
                head_flops = 2 * B_TRAIN * T * H * k
                out["work"][name] = (nbytes(args, kfn(*args)),
                                     head_flops * (3 if "bwd" in name else 1), "bf16")
                t = median_ms({"plain": lambda: pfn(*args), "kernel": lambda: kfn(*args)},
                              rounds=1)
                out["ms"][name] = (t["kernel"], t["plain"])
                bound_ms, bound_by = bound(*out["work"][name])
                print(f"transformer {name} B={B_TRAIN} T={T} {pool_shape}: kernel "
                      f"{t['kernel']:.3f} ms, plain {t['plain']:.3f} ms, bound {bound_ms:.3f} "
                      f"ms ({bound_by}) [{smi}]", flush=True)
    del params, masks, names, leaves, x_eval, big, h, h_eval

    # an interrupted and resumed run against the uninterrupted one, per family:
    # 2 epochs on 2,048 training windows, accumulation 3 (an epoch ends between
    # updates), a snapshot every epoch
    class Interrupted(Exception):
        pass

    def stop_at_epoch_1(xd, epoch):
        if epoch == 1:
            raise Interrupted
        return xd

    train = TrainConfig(epochs=2, accumulation_steps=3)
    data = (arrays["X_train"][:N_TRAIN_WINDOWS], arrays["y_train"][:N_TRAIN_WINDOWS],
            arrays["X_val"], arrays["y_val"])
    for family, family_cfg in (("flagship", ModelConfig()), ("transformer", cfg)):
        snaps = out_dir.parent / f"snapshots_{family}"
        t0 = time.perf_counter()
        full = loop.train_classifier(*data, family_cfg, train, device=dev, verbose=False,
                                     checkpoint_dir=snaps / "full", checkpoint_every=1)
        try:
            loop.train_classifier(*data, family_cfg, train, device=dev, verbose=False,
                                  checkpoint_dir=snaps / "cut", checkpoint_every=1,
                                  epoch_transform=stop_at_epoch_1)
            require(False, f"{family}: the run stops at epoch 1")
        except Interrupted:
            pass
        resumed = loop.train_classifier(*data, family_cfg, train, device=dev, verbose=False,
                                        checkpoint_dir=snaps / "resumed", checkpoint_every=1,
                                        resume_from=snaps / "cut")
        torch.cuda.synchronize()
        a = (snaps / "full" / "train_state.msgpack").read_bytes()
        b = (snaps / "resumed" / "train_state.msgpack").read_bytes()
        bitwise = a == b and resumed.history["train_loss"] == full.history["train_loss"]
        diff = 0.0
        if not bitwise:
            sa, sb = msgpack_unpack(a), msgpack_unpack(b)

            def leaves_of(tree):
                if isinstance(tree, dict):
                    return [v for key in sorted(tree) for v in leaves_of(tree[key])]
                return [np.asarray(tree, np.float64)]
            diff = max(float(np.abs(u - v).max() / max(np.abs(v).max(), 1e-30))
                       for u, v in zip(leaves_of(sa), leaves_of(sb)) if v.size)
        print(f"resume {family} on the card: 2 epochs of {len(data[1]) // B_TRAIN} micro-steps, "
              f"interrupted after epoch 1 and resumed, {time.perf_counter() - t0:.1f} s for the "
              f"three runs; train_state.msgpack ({len(a)} bytes) and train_loss "
              f"{full.history['train_loss']} equal to the uninterrupted run's bit for bit: "
              f"{bitwise}" + ("" if bitwise else f"; largest relative difference {diff:.3e}"),
              flush=True)
        require(bitwise or (family == "transformer" and diff <= STEP_GRAD_REL_TOL),
                f"{family}: the resumed run ends with the uninterrupted run's train state")
    return out


def profile_phase(dev, smi, tmp):
    """Phase 22: ``train --profile DIR --epochs 1`` as a CLI call on a
    synthetic processed set (phase 8's windows, ``PROFILE_WINDOWS`` of them
    for training), its Chrome trace parsed and searched for the default bf16
    path's hand-written kernels (presence: the profiler drops launches on
    these machines); fig10's series (``ode_analysis_series``: kernel 11's
    trajectory mode, 3 initial states x 120 points, and the steady state) on
    the card against its CPU twin; ``Timer``/``timed`` around one served
    batch of the trained model and ``compute_metrics`` on its decisions
    against ``analyze/evaluate.py``. -> the numbers it printed."""
    from eegflow_torch import kernels
    from eegflow_torch.analyze.evaluate import binary_metrics
    from eegflow_torch.cli.main import load_coupled_model
    from eegflow_torch.cli.main import main as cli_main
    from eegflow_torch.core import Timer, timed
    from eegflow_torch.core.artifacts import save_results
    from eegflow_torch.core.registry import available_metrics, compute_metrics
    from eegflow_torch.couple.rollout import predict_batch
    from eegflow_torch.ode.field import DEFAULT_RATES, RATE_NAMES
    from eegflow_torch.viz.figures import ode_analysis_series

    out = {}
    rng = np.random.default_rng(SEED + 22)
    (tmp / "processed_data").mkdir(parents=True)
    arrays = {}
    for split, n in (("train", PROFILE_WINDOWS), ("val", 256), ("test", 256)):
        arrays[f"X_{split}"], arrays[f"y_{split}"] = synthetic_split(rng, n, T, C)
    np.savez(tmp / "processed_data" / "processed_sequences.npz", **arrays)
    save_results(tmp / "results" / "ode_results.json", {"fitted_params": DEFAULT_RATES})

    # train --profile
    trace_dir = tmp / "trace"
    t0 = time.perf_counter()
    rc, text = run_cli(cli_main, ["--output-dir", str(tmp), "train", "--epochs", "1",
                                  "--profile", str(trace_dir), "--device", dev.type])
    torch.cuda.synchronize()
    out["train_profile_s"] = time.perf_counter() - t0
    require(rc == 0, "train --profile returned 0")
    check_figures("train", text, tmp)
    traces = sorted(trace_dir.glob("torch_trace_*.json"))
    require(len(traces) == 1, f"one trace written: {traces}")
    out["trace_mb"] = traces[0].stat().st_size / 1e6
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    found = {k: any(re.search(pat, n) for n in names) for k, pat in TRACE_KERNELS.items()}
    print(f"train --profile --epochs 1 on {PROFILE_WINDOWS} windows: "
          f"{out['train_profile_s']:.1f} s wall (profiler on), trace {traces[0].name} "
          f"{out['trace_mb']:.1f} MB, {len(events)} events, {len(names)} distinct kernels; "
          f"the default bf16 path's kernels named: {found} [{smi}]", flush=True)
    require(all(found.values()), f"the trace names the default bf16 path's kernels: {found}")

    # fig10's series on the card against its CPU twin
    k = np.asarray([DEFAULT_RATES[r] for r in RATE_NAMES], np.float32)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = ode_analysis_series(k, dev)
    series_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(kernels.launch_counts)
    want = ode_analysis_series(k, "cpu")
    out["ode_series_err"] = max(float(np.abs(got[key] - want[key]).max()) for key in want)
    print(f"ode_analysis_series on the card (trajectories {got['trajectories'].shape}, steady "
          f"state {got['steady_state']}): {series_ms:.1f} ms, launches {launches}; max abs diff "
          f"from the CPU twin {out['ode_series_err']:.3e} (tol {ODE_SERIES_TOL:g})", flush=True)
    require(launches == {"apf_rk4": 1} and out["ode_series_err"] <= ODE_SERIES_TOL,
            "fig10's series: one apf_rk4 launch, within its tolerance of the CPU twin")

    # Timer / timed around one served batch, the registry on its decisions
    model = load_coupled_model(tmp, dev)
    timer = Timer()
    serve_batch = timed("served batch", timer)(
        lambda xs: predict_batch(model, xs, batch_size=BUCKET))
    res = serve_batch(arrays["X_test"])
    res = serve_batch(arrays["X_test"])
    span = timer.summary()["served batch"]
    y = arrays["y_test"]
    metrics = compute_metrics(available_metrics(), y, res["pred_binary"], res["probs"][:, 1])
    want = binary_metrics(y, res["pred_binary"], res["probs"][:, 1])
    agree = all(abs(metrics[n] - want[n]) <= 1e-12 for n in metrics)
    print(f"Timer/timed around predict_batch of {len(y)} windows: {span['count']} calls, "
          f"mean {span['mean_s'] * 1e3:.2f} ms (host clock, the call returns host arrays); "
          f"compute_metrics {metrics} equal to analyze/evaluate.py's: {agree}", flush=True)
    require(span["count"] == 2 and agree, "the registry's metrics equal analyze/evaluate.py's")
    return out


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mesh_rank_setup(rank, world, port):
    """A spawned rank's environment (as torch.distributed.run sets it), the
    kernel library phase 2 built (loaded, not built again) and the float32
    policy outside the kernels. -> the kernels module."""
    import os

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from eegflow_torch import kernels

    kernels.load_library()
    require("command" not in kernels.build_info,
            "a rank loads the library phase 2 built, without building it")
    return kernels


def _mesh_micro_step_case(dev, seed):
    """Full-width params (from ``seed``), a bf16 "fused" micro-step's global
    batch of B_TRAIN windows N(0, 1) and its dropout masks, on ``dev``."""
    from eegflow_torch.core.config import ModelConfig
    from eegflow_torch.nn.model import draw_dropout_masks
    from eegflow_torch.train.data import class_weight_array

    cfg = ModelConfig()
    x, y = synthetic_split(np.random.default_rng(seed), B_TRAIN, T, C)
    masks = draw_dropout_masks(cfg, B_TRAIN, T, torch.Generator(device=dev).manual_seed(seed),
                               dev)
    cw = torch.from_numpy(class_weight_array(y, 2)).to(dev)
    return cfg, x, y, masks, cw


def _fresh_step(cfg, dev, seed, cw, mesh):
    from eegflow_torch.core.config import TrainConfig
    from eegflow_torch.core.prng import make_generator
    from eegflow_torch.nn.model import classifier_init
    from eegflow_torch.train.steps import make_optimizer, make_train_step

    params = classifier_init(cfg, make_generator(seed), dev, trainable=True)
    opt = make_optimizer(list(params.parameters()), TrainConfig(), updates_per_epoch=1)
    return params, make_train_step(cfg, TrainConfig(), opt, class_weights=cw, mesh=mesh)


def _grads(params):
    return [p.grad.clone() if p.grad is not None else torch.zeros_like(p)
            for p in params.parameters()]


def mesh_nccl_rank(rank, port, smi):
    """Phase 23 (a): NCCL at world size 1 on cuda:0. One micro-step of
    make_train_step(mesh=) against the step without a mesh from the same
    params and masks, bit for bit; its launches; both timed in turns; the
    18 MB gradient all-reduce timed apart."""
    import torch.distributed as dist

    from eegflow_torch.train.mesh import all_reduce_sum, make_data_mesh, shard_batch

    kernels = _mesh_rank_setup(rank, 1, port)
    mesh = make_data_mesh()
    dev = mesh.device
    require(dist.get_backend() == "nccl" and dev == torch.device("cuda", 0),
            f"the default mesh on one card is NCCL on cuda:0 ({dist.get_backend()}, {dev})")
    cfg, x, y, masks, cw = _mesh_micro_step_case(dev, SEED + 23)
    xd, yd = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    xs, ys, ms = shard_batch((x, y, masks), mesh)
    p_one, step_one = _fresh_step(cfg, dev, SEED + 23, cw, None)
    p_mesh, step_mesh = _fresh_step(cfg, dev, SEED + 23, cw, mesh)
    m_one = step_one(p_one, xd, yd, masks)
    kernels.reset_launch_counts()
    m_mesh = step_mesh(p_mesh, xs, ys, ms)
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    same = (torch.equal(m_one["loss"], m_mesh["loss"])
            and all(torch.equal(a, b) for a, b in zip(_grads(p_one), _grads(p_mesh))))
    print(f"phase 23a NCCL world size 1: micro-step B={B_TRAIN} with the mesh: loss "
          f"{m_mesh['loss'].item():.6f}, without {m_one['loss'].item():.6f}; loss and "
          f"{len(list(p_mesh.parameters()))} gradients bit for bit: {same}; launches "
          f"{launches}", flush=True)
    require(same, "NCCL world size 1: the mesh step is the step without a mesh bit for bit")
    require(launches == STEP_LAUNCHES, f"the mesh micro-step's launches are phase 9's "
            f"({launches})")
    ms_steps = median_ms({"mesh=None": lambda: step_one(p_one, xd, yd, masks),
                          "mesh": lambda: step_mesh(p_mesh, xs, ys, ms)}, rounds=2)
    flat = torch.zeros(sum(p.numel() for p in p_mesh.parameters()) + 2, device=dev)
    reduce_ms = median_ms({"all_reduce": lambda: all_reduce_sum(flat, mesh)})["all_reduce"]
    print(f"phase 23a timed in turns (CUDA events, median of 4): micro-step mesh=None "
          f"{ms_steps['mesh=None']:.3f} ms, mesh (NCCL, world 1) {ms_steps['mesh']:.3f} ms; "
          f"the all-reduce of {flat.numel() * 4 / 1e6:.2f} MB alone {reduce_ms:.3f} ms "
          f"[{smi}]", flush=True)
    dist.destroy_process_group()


def mesh_gloo_rank(rank, port, smi):
    """Phase 23 (b): two ranks sharing cuda:0 over gloo. A micro-step at
    global B_TRAIN against the single-process step (rank 0), an AdamW
    update of four micro-steps (the ranks' params bitwise equal), the
    launches a micro-step and an eval batch, train_classifier(mesh=), and
    predict_probs, predict_batch, the sweep, the permutation importance and
    the forecasts with the mesh against without it (rank 0)."""
    from datetime import timedelta

    import torch.distributed as dist

    from eegflow_torch.analyze.forecast import multistep_forecast
    from eegflow_torch.core.config import CouplingConfig, TrainConfig
    from eegflow_torch.core.prng import make_generator
    from eegflow_torch.couple.rollout import CoupledModel, predict_batch
    from eegflow_torch.couple.sweep import coupling_strength_sweep
    from eegflow_torch.explain.permutation import permutation_channel_importance
    from eegflow_torch.nn.model import classifier_init, draw_dropout_masks
    from eegflow_torch.ode.field import DEFAULT_RATES, rates_to_array
    from eegflow_torch.train.loop import predict_probs, train_classifier
    from eegflow_torch.train.mesh import (all_gather_rows, all_reduce_sum, make_data_mesh,
                                          make_spmd_eval_step, shard_batch)

    kernels = _mesh_rank_setup(rank, 2, port)
    mesh = make_data_mesh(devices=["cuda:0", "cuda:0"], backend="gloo",
                          timeout=timedelta(seconds=MESH_TIMEOUT_S))
    dev = mesh.device
    tag = f"phase 23b gloo rank {rank}/2 on {dev}"
    require(dist.get_backend() == "gloo" and dev == torch.device("cuda", 0),
            f"{tag}: gloo on the shared card")

    def same_on_every_rank(t):
        rows = all_gather_rows(t.reshape(1, -1), mesh)
        return all(torch.equal(rows[0], r) for r in rows[1:])

    # one micro-step at global B_TRAIN, B_TRAIN / 2 rows a rank
    cfg, x, y, masks, cw = _mesh_micro_step_case(dev, SEED + 23)
    xs, ys, ms = shard_batch((x, y, masks), mesh)
    p_mesh, step_mesh = _fresh_step(cfg, dev, SEED + 23, cw, mesh)
    kernels.reset_launch_counts()
    m_mesh = step_mesh(p_mesh, xs, ys, ms)
    torch.cuda.synchronize()
    step_launches = dict(kernels.launch_counts)
    g_mesh = _grads(p_mesh)
    if rank == 0:
        p_one, step_one = _fresh_step(cfg, dev, SEED + 23, cw, None)
        m_one = step_one(p_one, torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev),
                         masks)
        loss_diff = abs(m_mesh["loss"].item() - m_one["loss"].item())
        errs = {n: rel_err(a, b) for (n, _), a, b in zip(p_one.named_parameters(), g_mesh,
                                                          _grads(p_one)) if b.abs().max() > 0}
        head_rel = max(errs[n] for n in MESH_BF16_GRADS)
        grad_rel, worst = max((e, n) for n, e in errs.items() if n not in MESH_BF16_GRADS)
        print(f"{tag}: micro-step global B={B_TRAIN} ({B_TRAIN // 2} rows a rank) against the "
              f"single-process step at B={B_TRAIN}: loss {m_mesh['loss'].item():.6f} vs "
              f"{m_one['loss'].item():.6f} (diff {loss_diff:.3e}, tol {STEP_LOSS_TOL:g}); "
              f"gradients max rel diff {grad_rel:.3e} ({worst}; tol {MESH_GRAD_REL_TOL:g}), "
              f"the head's weights' {head_rel:.3e} (tol {MESH_BF16_GRAD_REL_TOL:g})",
              flush=True)
        require(loss_diff <= STEP_LOSS_TOL and grad_rel <= MESH_GRAD_REL_TOL
                and head_rel <= MESH_BF16_GRAD_REL_TOL,
                "two gloo ranks' micro-step within its tolerances of the single-process step")
        del p_one
    for _ in range(3):  # accumulation 4: the fourth micro-step updates
        step_mesh(p_mesh, xs, ys, ms)
    flat = torch.cat([p.detach().reshape(-1) for p in p_mesh.parameters()])
    equal = same_on_every_rank(flat)
    print(f"{tag}: launches a micro-step {step_launches}; after 4 micro-steps (one AdamW "
          f"update) the ranks' params bitwise equal: {equal}", flush=True)
    require(step_launches == STEP_LAUNCHES, f"{tag}: a micro-step's launches are phase 9's")
    require(equal, "the ranks' params bitwise equal after the update")
    evaluate = make_spmd_eval_step(cfg, mesh)
    x_eval = synthetic_split(np.random.default_rng(SEED + 24), BUCKET, T, C)[0]
    kernels.reset_launch_counts()
    evaluate(p_mesh, shard_batch(x_eval, mesh))
    torch.cuda.synchronize()
    eval_launches = dict(kernels.launch_counts)
    print(f"{tag}: launches an eval batch ({BUCKET // 2} rows) {eval_launches}", flush=True)
    require(eval_launches == EVAL_LAUNCHES, f"{tag}: an eval batch's launches")

    # overheads: a rank's micro-step, the gloo all-reduce, the global mask draw
    micro = median_ms({"step": lambda: step_mesh(p_mesh, xs, ys, ms)}, rounds=2)["step"]
    buf = torch.zeros(flat.numel() + 2, device=dev)
    t0 = time.perf_counter()
    for _ in range(4):
        all_reduce_sum(buf, mesh)
    torch.cuda.synchronize()
    reduce_ms = (time.perf_counter() - t0) * 1e3 / 4
    gen = torch.Generator(device=dev).manual_seed(SEED)
    draw_ms = cuda_ms(lambda: draw_dropout_masks(cfg, B_TRAIN, T, gen, dev), 4)
    print(f"{tag}: micro-step {micro:.3f} ms (CUDA events, median of 4, two ranks on one "
          f"card); gloo all-reduce of {buf.numel() * 4 / 1e6:.2f} MB {reduce_ms:.3f} ms (host "
          f"clock); the global mask draw for B={B_TRAIN} {draw_ms:.3f} ms [{smi}]", flush=True)
    del p_mesh, step_mesh

    # train_classifier(mesh=), 1 epoch on phase 8's kind of windows
    rng = np.random.default_rng(SEED + 8)
    train_data = (*synthetic_split(rng, N_TRAIN_WINDOWS, T, C), *synthetic_split(rng, 256, T, C))
    t0 = time.perf_counter()
    res = train_classifier(*train_data, cfg, TrainConfig(epochs=1), mesh=mesh)
    train_s = time.perf_counter() - t0
    finite = all(math.isfinite(v) for k in ("train_loss", "val_loss")
                 for v in res.history[k])
    best = torch.cat([torch.from_numpy(np.asarray(a, np.float32)).reshape(-1)
                      for a in _tree_leaves(res.params)]).to(dev)
    equal = same_on_every_rank(best)
    print(f"{tag}: train_classifier(mesh=) 1 epoch on {N_TRAIN_WINDOWS} windows in "
          f"{train_s:.1f} s: train_loss {res.history['train_loss']}, val_loss "
          f"{res.history['val_loss']}, {res.windows_per_sec:.0f} windows/s; best params "
          f"bitwise equal on the ranks: {equal}", flush=True)
    require(finite and equal, f"{tag}: finite history, the ranks' best params bitwise equal")

    # the inference and analysis paths with the mesh against without it
    params = classifier_init(cfg, make_generator(SEED + 25), dev)
    rng = np.random.default_rng(SEED + 25)
    x_big, y_big = synthetic_split(rng, MESH_PREDICT_WINDOWS, T, C)
    t0 = time.perf_counter()
    probs = predict_probs(params, x_big, cfg, mesh=mesh)
    probs_s = time.perf_counter() - t0
    model = CoupledModel(params, cfg, rates_to_array(DEFAULT_RATES, dev), CouplingConfig(),
                         device=dev)
    rolled = {n: predict_batch(model, x_big[:n], mesh=mesh) for n in MESH_ROLLOUT_WINDOWS}
    x_perm, y_perm = x_big[:MESH_PERM_WINDOWS], y_big[:MESH_PERM_WINDOWS]
    sweep = coupling_strength_sweep(model, x_perm, y_perm, mesh=mesh)
    t0 = time.perf_counter()
    perm = permutation_channel_importance(params, cfg, x_perm, y_perm,
                                          n_samples=MESH_PERM_WINDOWS, mesh=mesh)
    perm_s = time.perf_counter() - t0
    k = rates_to_array(DEFAULT_RATES, dev)
    forecast = multistep_forecast(probs[:, 1], k, mesh=mesh)
    same = same_on_every_rank(torch.from_numpy(probs).to(dev))
    require(same, f"{tag}: every rank returns the same probabilities")
    if rank == 0:
        want = predict_probs(params, x_big, cfg)
        err = float(np.abs(probs[:, 1] - want[:, 1]).max())
        flips = int((probs.argmax(1) != want.argmax(1)).sum())
        print(f"{tag}: predict_probs on {MESH_PREDICT_WINDOWS} windows with the mesh in "
              f"{probs_s:.2f} s: P(closed) max abs diff {err:.3e} from mesh=None (tol "
              f"{MESH_PROBS_TOL:g}), {flips} decisions flipped", flush=True)
        require(err <= MESH_PROBS_TOL, f"{tag}: predict_probs with the mesh")
        for n, got in rolled.items():
            want = predict_batch(model, x_big[:n])
            err = float(np.abs(got["probs"][:, 1] - want["probs"][:, 1]).max())
            flips = int((got["pred_binary"] != want["pred_binary"]).sum())
            shapes = all(got[key].shape == want[key].shape for key in want)
            print(f"{tag}: predict_batch on {n} windows with the mesh: P(closed) max abs "
                  f"diff {err:.3e} (tol {MESH_PROBS_TOL:g}), {flips} decisions flipped, "
                  f"shapes equal: {shapes}", flush=True)
            require(err <= MESH_PROBS_TOL and shapes, f"{tag}: predict_batch({n}) with the mesh")
        want = coupling_strength_sweep(model, x_perm, y_perm)
        sweep_err = max(abs(sweep[a][m] - want[a][m]) for a in want for m in want[a])
        print(f"{tag}: coupling sweep on {MESH_PERM_WINDOWS} windows with the mesh {sweep}; "
              f"max metric diff from mesh=None {sweep_err:.3e}", flush=True)
        require(all(abs(sweep[a]["accuracy"] - want[a]["accuracy"]) <= MESH_FLIP_SHARE
                    for a in want), f"{tag}: the sweep's accuracies with the mesh")
        want = permutation_channel_importance(params, cfg, x_perm, y_perm,
                                              n_samples=MESH_PERM_WINDOWS)
        imp_err = float(np.abs(np.subtract(perm["importance"], want["importance"])).max())
        print(f"{tag}: permutation importance (n={MESH_PERM_WINDOWS}, 61 channels x 5 "
              f"repeats, {MESH_PERM_WINDOWS // 2} rows a rank) with the mesh in {perm_s:.1f} s; "
              f"baseline {perm['baseline_accuracy']:.4f} vs {want['baseline_accuracy']:.4f}, "
              f"max importance diff {imp_err:.3e} (tol {MESH_FLIP_SHARE:g})", flush=True)
        require(imp_err <= MESH_FLIP_SHARE, f"{tag}: the importances with the mesh")
        want = multistep_forecast(probs[:, 1], k)
        f_err = max(float(np.abs(forecast[h]["predictions"] - want[h]["predictions"]).max())
                    for h in want)
        print(f"{tag}: multistep_forecast of {len(want[5]['predictions'])} start states with "
              f"the mesh: max abs diff {f_err:.3e} (tol {FORECAST_TOL:g})", flush=True)
        require(f_err <= FORECAST_TOL, f"{tag}: the forecasts with the mesh")
    dist.destroy_process_group()


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _tree_leaves(v)]
    return [tree]


def mesh_phase(smi):
    """Phase 23: the data mesh on the card, in spawned ranks that load the
    library phase 2 built: (a) NCCL at world size 1, (b) gloo with two
    ranks sharing cuda:0 (NCCL refuses two ranks on one device, and the
    machine has one card: no scaling is measured). A failure in a rank
    raises here."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    mp.spawn(mesh_nccl_rank, args=(free_port(), smi), nprocs=1, join=True)
    t_a = time.perf_counter() - t0
    mp.spawn(mesh_gloo_rank, args=(free_port(), smi), nprocs=2, join=True)
    print(f"phase 23 (the data mesh): (a) {t_a:.1f} s, (b) {time.perf_counter() - t0 - t_a:.1f} s",
          flush=True)


def binomial_z(count, n, p):
    """How many standard deviations ``count`` of ``n`` lies from a binomial
    mean n p."""
    return (count - n * p) / math.sqrt(n * p * (1 - p))


def philox_phase(dev, smi, params, tparams, cfg, micro_step, randn, work, train_ms):
    """Phase 25: the in-kernel Philox dropout (kernel_dropout) of kernels 2,
    3 and 3b. (a) At B=64, one and two parts, both directions (the reverse
    one at a mesh rank's row offset), each mode against its twin, a bitwise
    repeat and the same kernel on the uint8 masks the twin expands from the
    key, bit for bit; (b) one B=512 ModelConfig() micro-step under "fused"
    and "two_pass" with kernel_dropout: launches, loss and every gradient
    against the mask-path step on the expanded masks (bit for bit), each
    stream's keep fraction, the agreement of streams and keys, layer 0's dx
    zeros against stream 0's drops; (c) the steps timed in turns with the
    mask path (its draw counted), the peak device memory above the
    allocations before the step at B=512 and B=7,168 (res_bf16), each mode
    at B=512 against its uint8 mode and its twin; the draw kernel against its
    twin bit for bit and timed. -> {"err", "draw_err", "launches"}."""
    from eegflow_torch import kernels
    from eegflow_torch.nn.cuda_lstm import (counter, lstm_bwd, lstm_bwd_plain, lstm_bwd_v2,
                                            lstm_bwd_v2_plain, lstm_fwd_train,
                                            lstm_fwd_train_gates, lstm_fwd_train_gates_plain,
                                            lstm_fwd_train_plain)
    from eegflow_torch.nn.model import (draw_dropout_masks, expand_dropout_masks,
                                        train_step_launches)
    from eegflow_torch.nn.philox import PhiloxSource, draw_keep_bits, philox_keep_bits

    err = {}  # a Philox mode's counter name -> its largest absolute difference from its twin
    kgen = torch.Generator(device=dev).manual_seed(SEED + 25)
    keep_in, keep_mid = 1.0 - cfg.dropout / 2, 1.0 - cfg.dropout
    flat_bwd = lambda out: list(out[0]) + list(out[1:])  # noqa: E731
    fwd_modes = ((lstm_fwd_train, lstm_fwd_train_plain, "lstm_fwd_train"),
                 (lstm_fwd_train_gates, lstm_fwd_train_gates_plain, "lstm_fwd_train_gates"))

    def new_key():
        return torch.randint(-2 ** 31, 2 ** 31, (2,), generator=kgen, device=dev,
                             dtype=torch.int32)

    def hold25(label, name, got, again, want, on_masks, tol, relative):
        """hold_at_main_shape, and the kernel on the expanded masks bit for bit."""
        e = hold_at_main_shape(label, [t.float() for t in got], [t.float() for t in again],
                               [t.float() for t in want], tol, relative)
        same = all(torch.equal(a, b) for a, b in zip(got, on_masks))
        print(f"{label}: the same kernel on the expanded uint8 masks bit for bit: {same}",
              flush=True)
        require(same, f"{name}: the Philox mode equals its uint8 mode on the expanded masks")
        err[name] = max(err.get(name, 0.0), e)

    # (a) the draw kernel against its twin bit for bit: the stack's input
    # (stream 0) and a layer's two parts at B=64 (the second at a mesh rank's
    # offset), a layer's two parts at B=512, and two rows at row 262,143,
    # whose counter passes 2^32 (element 2^34 = T H 262,144 opens the second);
    # keys of their own, so the phase's other keys stay those drawn before
    # the draw kernel existed; draw_err counts the bits that differ
    dgen = torch.Generator(device=dev).manual_seed(SEED + 27)
    draw_err = 0
    for batch, streams, row_offset in ((B_CHECK, (0,), 0), (B_CHECK, (1, 2), B_CHECK),
                                       (B_TRAIN, (3, 4), 0), (2, (5,), 2 ** 34 // (T * H) - 1)):
        key = torch.randint(-2 ** 31, 2 ** 31, (2,), generator=dgen, device=dev,
                            dtype=torch.int32)
        src = PhiloxSource(key, streams, row_offset)
        parts = tuple(torch.empty(batch, T, H, device=dev) for _ in streams)
        got = draw_keep_bits(src, parts, keep_mid).planes
        again = draw_keep_bits(src, parts, keep_mid).planes
        want = [philox_keep_bits(src.key, q, (batch, T, H), keep_mid, row_offset)
                for q in streams]
        torch.cuda.synchronize()
        same = all(torch.equal(a, w) for a, w in zip(got, want))
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        wrong = sum(int(((a ^ w) >> k & 1).sum()) for a, w in zip(got, want) for k in range(8))
        draw_err = max(draw_err, wrong)
        print(f"philox_keep_bits streams={streams} B={batch} T={T} D={H} row_offset={row_offset} "
              f"(counter words {row_offset * T * H // 4:#x}..): {sum(g.numel() for g in got)} "
              f"bytes equal to the twin's bit for bit: {same} ({wrong} bits differ); repeat "
              f"bitwise identical: {bitwise}", flush=True)
        require(same and bitwise, f"philox_keep_bits B={batch} row_offset={row_offset}: the "
                                  f"twin's bits, repeatable")
    del parts, got, again, want

    # (a) each mode at B=64 against its twin, a bitwise repeat and its uint8 mode
    for n_parts, layer, keep in ((1, params["lstm"][0], keep_in),
                                 (2, params["lstm"][1], keep_mid)):
        xs = tuple(torch.tanh(randn(B_CHECK, T, H)) for _ in range(n_parts))
        for direction, reverse in (("fwd", False), ("bwd", True)):
            p = layer[direction]
            src = PhiloxSource(new_key(), tuple(1 + q for q in range(n_parts)),
                               B_CHECK if reverse else 0)
            ms = src.masks(xs, keep)
            bits = draw_keep_bits(src, xs, keep)
            tag = (f"parts={n_parts} reverse={reverse} row_offset={src.row_offset} B={B_CHECK} "
                   f"T={T} H={H}")
            head = (xs, p["w_ih"], p["b"], p["w_hh"], reverse)
            for fwd, plain, base in fwd_modes:
                for res16 in (False, True):
                    name = counter(base, res16, True)
                    got = fwd(*head, bits, keep, res_bf16=res16)
                    hold25(f"{name} {tag}", name, got, fwd(*head, bits, keep, res_bf16=res16),
                           plain(*head, bits, keep, res_bf16=res16),
                           fwd(*head, ms, keep, res_bf16=res16),
                           RES16_TOL if res16 else TRAIN_FWD_TOL, relative=False)
            g_up = 0.1 * randn(B_CHECK, T, H)
            dx_add = tuple(randn(B_CHECK, T, H) for _ in range(n_parts)) if reverse else None
            for res16 in (False, True):
                h_p, planes = lstm_fwd_train_plain(*head, ms, keep, res_bf16=res16)
                h_g, gates, c_g = lstm_fwd_train_gates_plain(*head, ms, keep, res_bf16=res16)
                for bwd, plain, res, h_in, base in (
                        (lstm_bwd, lstm_bwd_plain, (planes,), h_p, "lstm_bwd"),
                        (lstm_bwd_v2, lstm_bwd_v2_plain, (gates, c_g), h_g, "lstm_bwd_v2")):
                    name = counter(base, res16, True)
                    b_head = (*res, h_in, g_up, xs, p["w_ih"], p["w_hh"], reverse)
                    hold25(f"{name} {tag} dx_add={dx_add is not None}: dx, dW_ih, dW_hh, db",
                           name, flat_bwd(bwd(*b_head, bits, keep, dx_add)),
                           flat_bwd(bwd(*b_head, bits, keep, dx_add)),
                           flat_bwd(plain(*b_head, bits, keep, dx_add)),
                           flat_bwd(bwd(*b_head, ms, keep, dx_add)), BWD_REL_TOL, relative=True)
    del xs, ms, bits, planes, gates, c_g, h_p, h_g

    # (b) one B=512 micro-step under "fused" and "two_pass" with kernel_dropout
    rng25 = np.random.default_rng(SEED + 25)
    x25, y25 = synthetic_split(rng25, B_TRAIN, T, C)
    x25, y25 = torch.from_numpy(x25).to(dev), torch.from_numpy(y25).to(dev)
    masks25 = draw_dropout_masks(cfg, B_TRAIN, T, kgen, dev, kernel_dropout=True)
    expanded = expand_dropout_masks(masks25, cfg, B_TRAIN, T)
    launches = Counter()
    for sched in ("fused", "two_pass"):
        label = f"lstm_bwd={sched} kernel_dropout=True"
        kernels.reset_launch_counts()
        loss_k, grads_k = micro_step("kernel", lstm_bwd=sched, masks=masks25,
                                     kernel_dropout=True, x=x25, y=y25)
        torch.cuda.synchronize()
        step_counts = dict(kernels.launch_counts)
        want_counts = train_step_launches(cfg, sched, kernel_dropout=True)
        print(f"micro-step {label} B={B_TRAIN}: launches {step_counts}")
        require(step_counts == want_counts, f"{label} launches per micro-step: want {want_counts}")
        launches.update(step_counts)
        loss_k2, grads_k2 = micro_step("kernel", lstm_bwd=sched, masks=masks25,
                                       kernel_dropout=True, x=x25, y=y25)
        loss_m, grads_m = micro_step("kernel", lstm_bwd=sched, masks=expanded, x=x25, y=y25)
        torch.cuda.synchronize()
        bitwise = torch.equal(loss_k, loss_k2) and all(torch.equal(a, b)
                                                       for a, b in zip(grads_k, grads_k2))
        same = torch.equal(loss_k, loss_m) and all(torch.equal(a, b)
                                                   for a, b in zip(grads_k, grads_m))
        grad_rel = max(rel_err(a, b) for a, b in zip(grads_k, grads_m) if b.abs().max() > 0)
        print(f"micro-step {label} B={B_TRAIN}: loss {loss_k.item():.6f}, the mask-path step "
              f"on the expanded masks {loss_m.item():.6f}; loss and all {len(grads_k)} "
              f"gradients bit for bit: {same} (max rel diff {grad_rel:.3e}); second run bitwise "
              f"identical: {bitwise}", flush=True)
        require(math.isfinite(loss_k.item()) and same and bitwise,
                f"{label}: the mask-path step on the expanded masks, bit for bit, repeatable")
        del grads_k, grads_k2, grads_m

    # the masks' statistics: each stream's keep fraction, the agreement of
    # streams (and of two keys on one stream) with independent masks'
    streams = [(0, expanded.input, keep_in)] + [
        (1 + 2 * layer + q, m, keep_mid) for layer, parts in enumerate(expanded.layers)
        for q, m in enumerate(parts)]
    zs = []
    for s, m, keep in streams:
        z = binomial_z(int(m.sum()), m.numel(), keep)
        zs.append(z)
        print(f"stream {s}: keep fraction {m.float().mean().item():.6f} (keep {keep:g}, "
              f"{m.numel()} elements, {z:+.2f} sigma)")
        require(abs(z) < 5, f"stream {s}'s keep fraction within 5 sigma of its binomial")
    other = expand_dropout_masks(draw_dropout_masks(cfg, B_TRAIN, T, kgen, dev,
                                                    kernel_dropout=True), cfg, B_TRAIN, T)
    others = [other.input] + [m for parts in other.layers for m in parts]
    pairs = [(f"streams {a[0]},{b[0]}", a[1], b[1], a[2], b[2])
             for i, a in enumerate(streams) for b in streams[i + 1:]]
    pairs += [(f"stream {s} under two keys", m, o, keep, keep)
              for (s, m, keep), o in zip(streams, others)]
    worst = 0.0
    for what, a, b, ka, kb in pairs:
        p_agree = ka * kb + (1 - ka) * (1 - kb)
        z = binomial_z(int((a == b).sum()), a.numel(), p_agree)
        worst = max(worst, abs(z))
        require(abs(z) < 5, f"{what}: agreement within 5 sigma of independent masks'")
    print(f"agreement of {len(pairs)} pairs of masks (streams, and each stream under two keys) "
          f"against keep_a keep_b + (1 - keep_a)(1 - keep_b): largest |z| {worst:.2f} sigma",
          flush=True)
    del other, others, pairs

    # layer 0's dx (both directions on stream 0): each direction's own dx is
    # zero exactly where stream 0 drops (the forward and the backward draw the
    # same bits), and so is the reverse direction's with the forward's added
    # in its epilogue; that sum also vanishes where the two cancel (~2^-24 of
    # the kept elements may), and there it must be their sum to one rounding
    layer0 = tparams["lstm"][0]
    x0 = (torch.tanh(randn(B_TRAIN, T, H)),)
    bits0 = draw_keep_bits(PhiloxSource(masks25.key, (0,)), x0, keep_in)
    outs = [lstm_fwd_train(x0, layer0[d]["w_ih"], layer0[d]["b"], layer0[d]["w_hh"], d == "bwd",
                           bits0, keep_in) for d in ("fwd", "bwd")]
    dx_f = lstm_bwd(outs[0][1], outs[0][0], 0.1 * randn(B_TRAIN, T, H), x0,
                    layer0["fwd"]["w_ih"], layer0["fwd"]["w_hh"], False, bits0, keep_in)[0]
    head_r = (outs[1][1], outs[1][0], 0.1 * randn(B_TRAIN, T, H), x0, layer0["bwd"]["w_ih"],
              layer0["bwd"]["w_hh"], True, bits0, keep_in)
    dx_r = lstm_bwd(*head_r)[0][0]
    dx = lstm_bwd(*head_r, dx_f)[0][0]
    dx_f = dx_f[0]
    dropped = ~expanded.input
    cancel = (dx == 0) & ~dropped
    zeros_match = (torch.equal(dx_f == 0, dropped) and torch.equal(dx_r == 0, dropped)
                   and bool((dx[dropped] == 0).all()))
    cancelled = bool(((dx_r + dx_f)[cancel].abs() <= 2 ** -23 * dx_r[cancel].abs()).all())
    print(f"layer 0's dx (kernel 3) of each direction and of both zero exactly at stream 0's "
          f"{int(dropped.sum())} dropped positions: {zeros_match}; both also zero at "
          f"{int(cancel.sum())} kept positions, where the two cancel to one rounding: "
          f"{cancelled}", flush=True)
    require(zeros_match and cancelled, "layer 0's dx zeros are stream 0's drops")
    del outs, dx, dx_f, dx_r, head_r, x0, bits0, expanded, dropped, cancel

    # (c) the steps in turns with the mask path, each with its own draw
    mgen = torch.Generator(device=dev).manual_seed(SEED + 26)

    def step_of(sched, kernel_dropout, batch=B_TRAIN, x=x25, y=y25, res16=False):
        return lambda: micro_step("kernel", lstm_bwd=sched, res_bf16=res16,
                                  masks=draw_dropout_masks(cfg, batch, T, mgen, dev,
                                                           kernel_dropout=kernel_dropout),
                                  kernel_dropout=kernel_dropout, x=x, y=y)

    def peak_bytes(fn):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - before

    for sched in ("fused", "two_pass"):
        fns = {f"{sched} masks": step_of(sched, False), f"{sched} Philox": step_of(sched, True)}
        m = median_ms(fns)
        peaks = {name: peak_bytes(fn) for name, fn in fns.items()}
        for name in fns:
            print(f"training micro-step {name} B={B_TRAIN} T={T} with its draw (kernel path, in "
                  f"turns, median of 4): {m[name]:.3f} ms, {B_TRAIN / m[name] * 1e3:.1f} "
                  f"windows/s; peak device memory above the allocations before it "
                  f"{peaks[name]} bytes [{smi}]", flush=True)
    torch.cuda.empty_cache()
    big = B_BIG
    xb = torch.randn(big, T, C, device=dev, generator=kgen)
    yb = torch.randint(0, 2, (big,), device=dev, generator=kgen)
    for sched in ("fused", "two_pass"):
        kernels.reset_launch_counts()
        peak_p = peak_bytes(step_of(sched, True, big, xb, yb, True))
        step_counts = dict(kernels.launch_counts)
        want_counts = train_step_launches(cfg, sched, True, kernel_dropout=True)
        require(step_counts == want_counts,
                f"B={big} {sched} res_bf16 Philox launches: want {want_counts}, got {step_counts}")
        launches.update(step_counts)
        peak_m = peak_bytes(step_of(sched, False, big, xb, yb, True))
        print(f"training micro-step {sched} res_bf16 B={big}: peak device memory above the "
              f"allocations before it {peak_p} bytes with the Philox dropout, {peak_m} bytes "
              f"on the mask path ({peak_m - peak_p} bytes less) [{smi}]", flush=True)
    del xb, yb
    torch.cuda.empty_cache()

    # each mode at B=512 on the micro-step's plans (two parts, reverse, dx_add)
    # on a layer's keep-bit planes, drawn once as the step draws them: against
    # its twin and a bitwise repeat, timed in turns with its uint8 mode and
    # its twin; the bound counts the planes' bytes (1/32 of the parts')
    p1 = params["lstm"][1]["bwd"]
    xs2 = tuple(torch.tanh(randn(B_TRAIN, T, H)) for _ in range(2))
    src2 = PhiloxSource(masks25.key, (1, 2))
    ms2 = src2.masks(xs2, keep_mid)
    bits2 = draw_keep_bits(src2, xs2, keep_mid)

    # the draw kernel at a layer's B=512 against its twin, and the generator
    # calls of a B=512 step: before, every element's bits drawn in kernel 2's
    # projection loader once per 128-column tile of 4H (4H / 128 = 8, one
    # call per 4 elements) and in kernel 3's dW_ih loader as often, both per
    # direction, and in kernel 3's dx epilogue once per pair of elements per
    # direction: 2 (2 8 / 4 + 1 / 2) = 9 calls per element a step; now one
    # call per 4 elements (8 per 32-element word, 9 where a part does not
    # start at a block of four) at the top of each layer's forward and
    # backward; the bound counts each call's fewest instructions on its
    # busiest pipe (PHILOX_PIPE_OPS), printed beside the compiled kernel's
    m = median_ms({"kernel": lambda: draw_keep_bits(src2, xs2, keep_mid),
                   "plain": lambda: [philox_keep_bits(src2.key, q, (B_TRAIN, T, H), keep_mid)
                                     for q in src2.streams]}, rounds=2)
    train_ms["philox_keep_bits"] = (m["kernel"], m["plain"])
    layer_calls = sum(8 * -(-x.numel() // 32) for x in xs2)
    work["philox_keep_bits"] = (nbytes(src2.key, bits2.planes), layer_calls * PHILOX_CALL_OPS,
                                "int32")
    bound_ms, bound_by = bound(*work["philox_keep_bits"])
    sass = sass_pipe_counts(kernels.build_info["library"], "philox_keep_bits_kernel")
    print(f"philox_keep_bits_kernel SASS (cuobjdump, 8 generator calls a 32-bit word and a "
          f"9th for a part that does not start at a block of four): {sass}; the bound counts "
          f"{PHILOX_PIPE_OPS} a call, {PHILOX_CALL_OPS:g} slots of the busiest pipe",
          flush=True)
    require(all(sass[pipe] >= 8 * n for pipe, n in PHILOX_PIPE_OPS.items()),
            "philox_keep_bits: the bound counts no more instructions a pipe than the kernel has")
    n_stack = B_TRAIN * T * H * (1 + 2 * (cfg.num_layers - 1))
    print(f"philox_keep_bits (a layer's two parts, B={B_TRAIN} T={T} D={H}, "
          f"{layer_calls} generator calls): kernel {m['kernel']:.3f} ms, plain {m['plain']:.3f} "
          f"ms, bound {bound_ms:.4f} ms ({bound_by}); generator calls of a B={B_TRAIN} step "
          f"over the stack's {n_stack} input elements: {9 * n_stack} with the draw in the "
          f"loaders and dx epilogue, {2 * n_stack // 4} with one plane per layer and pass "
          f"[{smi}]", flush=True)
    g2 = 0.1 * randn(B_TRAIN, T, H)
    add2 = tuple(randn(B_TRAIN, T, H) for _ in range(2))
    head = (xs2, p1["w_ih"], p1["b"], p1["w_hh"], True)
    fwd_flops = 2 * B_TRAIN * T * (2 * H + H) * 4 * H
    bwd_flops = 2 * B_TRAIN * T * 4 * H * (2 * 2 * H + 2 * H)
    for res16 in (False, True):
        h_p, planes = lstm_fwd_train_plain(*head, ms2, keep_mid, res_bf16=res16)
        h_g, gates, c_g = lstm_fwd_train_gates_plain(*head, ms2, keep_mid, res_bf16=res16)
        modes = {}
        for fwd, plain, base in fwd_modes:
            modes[counter(base, res16, True)] = (
                fwd, plain, head, (keep_mid,), dict(res_bf16=res16), fwd_flops,
                lambda out: list(out), RES16_TOL if res16 else TRAIN_FWD_TOL, False)
        for bwd, plain, res, h_in, base in (
                (lstm_bwd, lstm_bwd_plain, (planes,), h_p, "lstm_bwd"),
                (lstm_bwd_v2, lstm_bwd_v2_plain, (gates, c_g), h_g, "lstm_bwd_v2")):
            modes[counter(base, res16, True)] = (
                bwd, plain, (*res, h_in, g2, xs2, p1["w_ih"], p1["w_hh"], True),
                (keep_mid, add2), {}, bwd_flops, flat_bwd, BWD_REL_TOL, True)
        for name, (kfn, pfn, a, tail, kw, flops, flat, tol, relative) in modes.items():
            out = kfn(*a, bits2, *tail, **kw)
            hold25(f"{name} B={B_TRAIN} T={T} H={H} parts=2 (the micro-step's plan)", name,
                   flat(out), flat(kfn(*a, bits2, *tail, **kw)),
                   flat(pfn(*a, bits2, *tail, **kw)), flat(kfn(*a, ms2, *tail, **kw)), tol,
                   relative)
            work[name] = (nbytes(a, bits2.planes, tail, kw, out), flops, "bf16")
            del out
            m = median_ms({"plain": lambda: pfn(*a, bits2, *tail, **kw),
                           "kernel": lambda: kfn(*a, bits2, *tail, **kw),
                           "uint8": lambda: kfn(*a, ms2, *tail, **kw)}, rounds=1)
            train_ms[name] = (m["kernel"], m["plain"])
            bound_ms, bound_by = bound(*work[name])
            print(f"{name} B={B_TRAIN} T={T} H={H}: kernel {m['kernel']:.3f} ms, its uint8 mode "
                  f"in the same turns {m['uint8']:.3f} ms, plain {m['plain']:.3f} ms, bound "
                  f"{bound_ms:.3f} ms ({bound_by}) [{smi}]", flush=True)
        del modes, h_p, planes, h_g, gates, c_g
    return {"err": err, "draw_err": draw_err, "launches": dict(launches)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a GPU",
              file=sys.stderr)
        return 2

    from eegflow_torch import kernels
    from eegflow_torch.cli.serve import serve
    from eegflow_torch.core.config import CouplingConfig, ModelConfig
    from eegflow_torch.core.prng import make_generator
    from eegflow_torch.couple.rollout import CoupledModel, bucket_size, predict_batch
    from eegflow_torch.cli.main import load_coupled_model
    from eegflow_torch.cli.main import main as cli_main
    from eegflow_torch.core.artifacts import load_checkpoint, save_results
    from eegflow_torch.couple.rollout import coupled_rollout
    from eegflow_torch.nn.attention import additive_attention_init
    from eegflow_torch.nn.cuda_attention import (attention_pool, attention_pool_apply,
                                                 attention_pool_plain, pool_head_bwd,
                                                 pool_head_bwd_plain, pool_head_fused,
                                                 pool_head_fused_plain)
    from eegflow_torch.nn.cuda_input import (bwd_plan, fwd_plan, input_block_bwd,
                                             input_block_bwd_plain, input_block_fused,
                                             input_block_fused_plain)
    from eegflow_torch.nn.cuda_lstm import (LSTM_BWD_SCHEDULES, counter, kernel_plan,
                                            lstm_bwd, lstm_bwd_dualdir,
                                            lstm_bwd_dualdir_plain,
                                            lstm_bwd_plain, lstm_bwd_v2, lstm_bwd_v2_plain,
                                            lstm_fwd_fused_proj, lstm_fwd_fused_proj_plain,
                                            lstm_fwd_train, lstm_fwd_train_gates,
                                            lstm_fwd_train_gates_plain, lstm_fwd_train_plain,
                                            lstm_recurrence, lstm_recurrence_backward,
                                            lstm_recurrence_backward_plain,
                                            lstm_recurrence_plain, select_dropout)
    from eegflow_torch.nn.losses import cross_entropy_loss
    from eegflow_torch.nn.model import (classifier_apply, classifier_init, draw_dropout_masks,
                                        train_step_launches)
    from eegflow_torch.ode.field import DEFAULT_RATES, rates_to_array

    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda", 0)
    card_name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {card_name} "
          f"count {torch.cuda.device_count()}", flush=True)
    # float32 matmuls outside the kernels stay float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build
    t0 = time.perf_counter()
    kernels.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s, {kernels.build_info.get('library')}")
    if "command" in kernels.build_info:
        for cmd in kernels.build_info["command"]:
            print("build command: " + " ".join(cmd))
        for line in kernels.build_info["log"].splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print("  ptxas: " + line.strip())
    # the cluster plans of kernels 1-4 at the main path's shapes
    for kind, batch, mode, label in (("fwd", BUCKET, 0, "lstm_fwd"),
                                     ("fwd", B_TRAIN, 1, "lstm_fwd_train"),
                                     ("fwd", B_TRAIN, 2, "lstm_fwd_train_gates"),
                                     ("bwd", B_TRAIN, 0, "lstm_bwd"),
                                     ("bwd_v2", B_TRAIN, 0, "lstm_bwd_v2"),
                                     ("bwd_dualdir", B_TRAIN, 0, "lstm_bwd_dualdir"),
                                     ("fwd", B_TRAIN, 3, "lstm_fwd_train_res16"),
                                     ("fwd", B_TRAIN, 4, "lstm_fwd_train_gates_res16"),
                                     ("bwd", B_TRAIN, 1, "lstm_bwd_res16"),
                                     ("bwd_v2", B_TRAIN, 1, "lstm_bwd_v2_res16"),
                                     ("bwd_dualdir", B_TRAIN, 1, "lstm_bwd_dualdir_res16"),
                                     ("rec", B_TRAIN, 1, "lstm_rec_fwd_train"),
                                     ("rec_bwd", B_TRAIN, 0, "lstm_rec_bwd"),
                                     ("rec", B_TRAIN, 0, "lstm_rec_fwd"),
                                     ("rec", BUCKET, 0, "lstm_rec_fwd"),
                                     ("fwd", B_CHECK, 1, "lstm_fwd_train"),
                                     ("bwd", B_CHECK, 0, "lstm_bwd"),
                                     ("rec", B_CHECK, 1, "lstm_rec_fwd_train"),
                                     ("rec_bwd", B_CHECK, 0, "lstm_rec_bwd")):
        print(f"cluster plan {label}: {kernel_plan(kind, batch, H, mode).describe()}")
    print(flush=True)

    cfg = ModelConfig()
    require(cfg.resolved_hidden() == H and cfg.input_size == C and cfg.num_layers == 3,
            "full-width ModelConfig defaults")
    params = classifier_init(cfg, make_generator(SEED), device=dev)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    # phase 3: lstm_fwd against its twin
    lstm_err = 0.0
    for n_parts, layer in ((1, params["lstm"][0]), (2, params["lstm"][1])):
        xs = tuple(randn(B_CHECK, T, H) if n_parts == 1
                   else torch.tanh(randn(B_CHECK, T, H)) for _ in range(n_parts))
        for direction, reverse in (("fwd", False), ("bwd", True)):
            p = layer[direction]
            got = lstm_fwd_fused_proj(xs, p["w_ih"], p["b"], p["w_hh"], reverse)
            again = lstm_fwd_fused_proj(xs, p["w_ih"], p["b"], p["w_hh"], reverse)
            want = lstm_fwd_fused_proj_plain(xs, p["w_ih"], p["b"], p["w_hh"], reverse)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(got).all()), "lstm_fwd output finite")
            err = (got - want).abs().max().item()
            same = torch.equal(got, again)
            print(f"lstm_fwd parts={n_parts} reverse={reverse} B={B_CHECK} T={T} H={H}: "
                  f"max_abs_diff {err:.3e} (tol {LSTM_TOL:g}); repeat bitwise identical: {same}")
            require(err <= LSTM_TOL and same,
                    f"lstm_fwd within {LSTM_TOL} of its twin, bitwise repeatable")
            lstm_err = max(lstm_err, err)

    # phase 4: pool_head_fwd against its twin
    pool_parts = tuple(torch.tanh(randn(B_CHECK, T, H)) for _ in range(2))
    got_ctx, got_s = pool_head_fused(params["lstm_norm"], params["attention"], pool_parts,
                                     use_ln=True, bf16=True)
    want_ctx, want_s = pool_head_fused_plain(params["lstm_norm"], params["attention"],
                                             pool_parts, use_ln=True, bf16=True)
    torch.cuda.synchronize()
    pool_err = max([(g - w).abs().max().item() for g, w in zip(got_ctx, want_ctx)]
                   + [(got_s - want_s).abs().max().item()])
    print(f"pool_head_fwd parts=2x{H} K={H} B={B_CHECK} T={T}: max_abs_diff "
          f"{pool_err:.3e} (tol {POOL_TOL:g})", flush=True)
    require(pool_err <= POOL_TOL, f"pool_head_fwd within {POOL_TOL} of its twin")

    # phase 5: serve
    model = CoupledModel(params=params, model_cfg=cfg,
                         k_base=rates_to_array(DEFAULT_RATES, dev),
                         coupling=CouplingConfig(), lstm_impl="auto", device=dev)
    httpd = serve(model, host="127.0.0.1", port=0, warmup_seq_len=T)
    server_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    server_thread.start()
    rng = np.random.default_rng(SEED)
    try:
        httpd.warmup_thread.join(timeout=900)
        require(not httpd.warmup_thread.is_alive(), "warmup finished")
        addr = httpd.server_address
        kernels.reset_launch_counts()
        status, health = request(addr, "GET", "/health")
        print(f"/health {status} {json.dumps(health)}")
        require(status == 200 and health["status"] == "ok", "/health ok")
        require(health["model"]["hidden_size"] == H and health["model"]["num_layers"] == 3
                and health["model"]["input_size"] == C
                and health["model"]["lstm_impl"] == "kernel", "/health reports the model")
        served, sizes = [], (1, 7, 33)
        for n in sizes:
            w64 = np.round(rng.standard_normal((n, T, C)), 4)  # short JSON numbers
            t_req = time.perf_counter()
            status, out = request(addr, "POST", "/predict",
                                  {"windows": w64.tolist(), "trajectories": n == 1})
            dt = time.perf_counter() - t_req
            require(status == 200, f"/predict {n} windows -> {status} {out}")
            probs = np.asarray(out["probs"])
            final = np.asarray(out["final_state"])
            pred_three = np.asarray(out["pred_three"])
            print(f"/predict n={n} bucket={bucket_size(n, BUCKET)}: {status} in {dt:.3f} s, "
                  f"probs[0]={probs[0].tolist()} final[0]={final[0].tolist()}")
            require(probs.shape == (n, 2) and final.shape == (n, 3)
                    and pred_three.shape == (n,), "response shapes")
            require(np.isfinite(probs).all() and np.isfinite(final).all(), "finite")
            require(np.allclose(probs.sum(-1), 1.0, atol=1e-5), "probs sum to 1")
            require(np.allclose(final.sum(-1), 1.0, atol=1e-5)
                    and (final >= 0).all() and (final <= 1).all(), "final_state on simplex")
            want_three = np.where(final[:, 2] > 0.5, 2, np.where(final[:, 0] > 0.5, 0, 1))
            require((pred_three == want_three).all(), "pred_three agrees with final_state")
            require((np.asarray(out["pred_binary"]) == (final[:, 2] > 0.5)).all(),
                    "pred_binary agrees with final_state")
            if n == 1:
                require(np.asarray(out["trajectories"]).shape == (1, 20, 3), "trajectories")
            served.append((w64.astype(np.float32), probs, final))
        counts = dict(kernels.launch_counts)
        n_batches = sum(math.ceil(n / BUCKET) for n in sizes)
        print(f"launches during serving ({n_batches} bucketed batches): {counts}")
        require(counts.get("lstm_fwd", 0) == 6 * n_batches,
                "lstm_fwd launched 6 times per batch")
        require(counts.get("pool_head_fwd", 0) == n_batches,
                "pool_head_fwd launched once per batch")
        require(counts.get("input_block_fwd", 0) == n_batches,
                "input_block_fwd launched once per batch")
        status, out = request(addr, "POST", "/predict", {"windows": [[1, 2]]})
        require(status == 400 and "N, T, C" in out["error"], "validation error")
    finally:
        httpd.shutdown()
        httpd.server_close()
        server_thread.join(timeout=60)
    probs_err = 0.0
    for x, probs, final in served:
        ref = predict_batch(model, x, batch_size=BUCKET, lstm_impl="plain")
        probs_err = max(probs_err, float(np.abs(ref["probs"] - probs).max()))
        require(np.abs(ref["final_state"] - final).max() <= PROBS_TOL,
                "final_state agrees with the plain path")
    print(f"served probs vs plain predict_batch: max_abs_diff {probs_err:.3e} "
          f"(tol {PROBS_TOL:g})", flush=True)
    require(probs_err <= PROBS_TOL, "served probs agree with the plain path")

    # phase 6: timing at the 1024 bucket
    x_big = rng.standard_normal((BUCKET, T, C)).astype(np.float32)
    batch_ms = median_ms({impl: (lambda impl=impl: predict_batch(
        model, x_big, batch_size=BUCKET, lstm_impl=impl)) for impl in ("plain", "kernel")},
        rounds=3)
    for impl in ("kernel", "plain"):
        print(f"predict_batch B={BUCKET} T={T} lstm_impl={impl}: median "
              f"{batch_ms[impl]:.3f} ms/batch, {BUCKET / batch_ms[impl] * 1e3:.1f} samples/s "
              f"over 6 runs [{smi}]")

    x1 = (randn(BUCKET, T, H),)
    x2 = tuple(torch.tanh(randn(BUCKET, T, H)) for _ in range(2))
    p0, p1 = params["lstm"][0]["fwd"], params["lstm"][1]["fwd"]
    kernel_ms = {}
    # name -> (bytes, operations of its products, their dtype) of the timed call
    work = {}

    def lstm_flops(batch, d_in, hidden):
        """Products of one LSTM layer-direction's forward: 2 B T (D + H) 4H."""
        return 2 * batch * T * (d_in + hidden) * 4 * hidden

    for label, xs, p in (("1 part", x1, p0), ("2 parts", x2, p1)):
        args = (xs, p["w_ih"], p["b"], p["w_hh"], False)
        out = lstm_fwd_fused_proj(*args)
        lstm_err = max(lstm_err, hold_at_main_shape(
            f"lstm_fwd B={BUCKET} T={T} H={H} {label} ({kernel_plan('fwd', BUCKET, H).rows} rows "
            f"a cluster)", [out], [lstm_fwd_fused_proj(*args)],
            [lstm_fwd_fused_proj_plain(*args)], LSTM_TOL, relative=False))
        if label == "2 parts":
            work["lstm_fwd"] = (nbytes(args, out), lstm_flops(BUCKET, 2 * H, H), "bf16")
        ms = cuda_ms(lambda: lstm_fwd_fused_proj(*args), 3)
        plain_ms = cuda_ms(lambda: lstm_fwd_fused_proj_plain(*args), 2)
        kernel_ms[label] = (ms, plain_ms)
        print(f"lstm_fwd B={BUCKET} T={T} H={H} {label}: kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms [{smi}]")
    pargs = (params["lstm_norm"], params["attention"], x2, True, True)
    flat_head = lambda out: list(out[0]) + [out[1]]  # noqa: E731
    pool_err = max(pool_err, hold_at_main_shape(
        f"pool_head_fwd bf16 B={BUCKET} T={T} parts=2x{H} K={H} (tensor cores): ctx parts, "
        f"scores", flat_head(pool_head_fused(*pargs)), flat_head(pool_head_fused(*pargs)),
        flat_head(pool_head_fused_plain(*pargs)), POOL_TOL, relative=False))
    work["pool_head_fwd"] = (nbytes(pargs, pool_head_fused(*pargs)), 2 * BUCKET * T * 2 * H * H,
                             "bf16")
    pool_ms = cuda_ms(lambda: pool_head_fused(*pargs), 5)
    pool_plain_ms = cuda_ms(lambda: pool_head_fused_plain(*pargs), 5)
    print(f"pool_head_fwd B={BUCKET} T={T} parts=2x{H} K={H}: kernel {pool_ms:.3f} ms, "
          f"plain {pool_plain_ms:.3f} ms [{smi}]")
    # kernel 7's float32 mode on the float32 served batch (coupled_rollout(bf16=False))
    pargs32_big = pargs[:-1] + (False,)
    pool_err32 = hold_at_main_shape(
        f"pool_head_fwd float32 B={BUCKET} T={T} parts=2x{H} K={H} (3xTF32 tensor cores): ctx "
        f"parts, scores", flat_head(pool_head_fused(*pargs32_big)),
        flat_head(pool_head_fused(*pargs32_big)), flat_head(pool_head_fused_plain(*pargs32_big)),
        POOL32_TOL, relative=False)
    split = device_ms(lambda: pool_head_fused(*pargs32_big), 5)
    print(f"pool_head_fwd float32 B={BUCKET} T={T}: device ms a launch by kernel (torch.profiler): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()) + f" [{smi}]", flush=True)
    # kernel 9's bf16 mode on the plan serving launches at the bucket
    ib = (params["input_proj"], params["input_norm"])
    xin_big = torch.from_numpy(x_big).to(dev)
    in_big_plan = fwd_plan(BUCKET * T, H)
    in_fwd_err = hold_at_main_shape(
        f"input_block_fwd bf16 B={BUCKET} T={T} C={C} H={H} ({in_big_plan.ctas} CTAs of "
        f"{in_big_plan.tile_rows}-row tiles, tensor cores): y",
        [input_block_fused(*ib, xin_big, True)], [input_block_fused(*ib, xin_big, True)],
        [input_block_fused_plain(*ib, xin_big, True)], INPUT_TOL, relative=False)
    in_big_ms = device_ms(lambda: input_block_fused(*ib, xin_big, True), 5)
    print(f"input_block_fwd bf16 B={BUCKET} T={T}: device ms a launch by kernel (torch.profiler): "
          + ", ".join(f"{k} {v:.3f}" for k, v in in_big_ms.items()) + f" [{smi}]", flush=True)
    del xin_big

    # phase 7: the training kernels against their twins
    keep_in, keep_mid = 1.0 - cfg.dropout / 2, 1.0 - cfg.dropout
    mgen = torch.Generator(device=dev).manual_seed(SEED + 2)

    def keep_masks(shape, keep):
        return (torch.rand(shape, generator=mgen, device=dev) < keep).to(torch.uint8)

    train_fwd_err = bwd_err = 0.0
    for n_parts, layer, keep in ((1, params["lstm"][0], keep_in),
                                 (2, params["lstm"][1], keep_mid)):
        xs = tuple(torch.tanh(randn(B_CHECK, T, H)) for _ in range(n_parts))
        ms = tuple(keep_masks((B_CHECK, T, H), keep) for _ in range(n_parts))
        for direction, reverse in (("fwd", False), ("bwd", True)):
            p = layer[direction]
            h_k, res_k = lstm_fwd_train(xs, p["w_ih"], p["b"], p["w_hh"], reverse, ms, keep)
            h_k2, res_k2 = lstm_fwd_train(xs, p["w_ih"], p["b"], p["w_hh"], reverse, ms, keep)
            h_p, res_p = lstm_fwd_train_plain(xs, p["w_ih"], p["b"], p["w_hh"], reverse, ms,
                                              keep)
            torch.cuda.synchronize()
            err = max((h_k - h_p).abs().max().item(), (res_k - res_p).abs().max().item())
            same = torch.equal(h_k, h_k2) and torch.equal(res_k, res_k2)
            print(f"lstm_fwd train parts={n_parts} reverse={reverse} B={B_CHECK} T={T} H={H}: "
                  f"h and planes max_abs_diff {err:.3e} (tol {TRAIN_FWD_TOL:g}); repeat bitwise "
                  f"identical: {same}")
            require(bool(torch.isfinite(res_k).all()) and err <= TRAIN_FWD_TOL and same,
                    f"lstm_fwd training mode within {TRAIN_FWD_TOL} of its twin, bitwise "
                    f"repeatable")
            train_fwd_err = max(train_fwd_err, err)
            g_up = 0.1 * randn(B_CHECK, T, H)
            dx_add = tuple(randn(B_CHECK, T, H) for _ in range(n_parts)) if reverse else None
            bwd_args = (res_p, h_p, g_up, xs, p["w_ih"], p["w_hh"], reverse, ms, keep, dx_add)
            got = lstm_bwd(*bwd_args)
            again = lstm_bwd(*bwd_args)
            want = lstm_bwd_plain(*bwd_args)
            torch.cuda.synchronize()
            errs = {"dx": max(rel_err(a, b) for a, b in zip(got[0], want[0])),
                    "dW_ih": rel_err(got[1], want[1]), "dW_hh": rel_err(got[2], want[2]),
                    "db": rel_err(got[3], want[3])}
            same = all(torch.equal(a, b) for a, b in zip(got[0] + got[1:], again[0] + again[1:]))
            print(f"lstm_bwd parts={n_parts} reverse={reverse} dx_add={dx_add is not None}: "
                  + ", ".join(f"{k} rel {v:.3e}" for k, v in errs.items())
                  + f" (tol {BWD_REL_TOL:g}); repeat bitwise identical: {same}")
            require(max(errs.values()) <= BWD_REL_TOL and same,
                    f"lstm_bwd within {BWD_REL_TOL}, bitwise repeatable")
            bwd_err = max(bwd_err, *[(a - b).abs().max().item()
                                     for a, b in zip(got[0] + got[1:], want[0] + want[1:])])
    pool_parts = tuple(torch.tanh(randn(B_CHECK, T, H)) for _ in range(2))
    wts = torch.softmax(randn(B_CHECK, T), dim=-1)
    g_ctx = tuple(0.1 * randn(B_CHECK, H) for _ in range(2))
    g_sc = 0.01 * randn(B_CHECK, T)
    gctx = 0.1 * randn(B_CHECK)
    names = ("dh", "dW1", "db1", "dw2", "dgamma", "dbeta")
    pool_bwd_err = 0.0
    for bf16 in (True, False):
        pool_args = (params["lstm_norm"], params["attention"], pool_parts, wts, g_sc, g_ctx,
                     gctx, True, bf16)
        got = pool_head_bwd(*pool_args)
        want = pool_head_bwd_plain(*pool_args)
        torch.cuda.synchronize()
        errs = {"dh": max(rel_err(a, b) for a, b in zip(got[0], want[0]))}
        errs.update({n: rel_err(a, b) for n, a, b in zip(names[1:], got[1:], want[1:])})
        print(f"pool_head_bwd bf16={int(bf16)} parts=2x{H} K={H} B={B_CHECK} T={T}: "
              + ", ".join(f"{k} rel {v:.3e}" for k, v in errs.items())
              + f" (tol {POOL_BWD_REL_TOL:g})", flush=True)
        require(max(errs.values()) <= POOL_BWD_REL_TOL,
                f"pool_head_bwd bf16={int(bf16)} within {POOL_BWD_REL_TOL}")
        pool_bwd_err = max([pool_bwd_err]
                           + [(a - b).abs().max().item() for a, b in zip(got[0], want[0])]
                           + [(a - b).abs().max().item() for a, b in zip(got[1:], want[1:])])

    # phase 8: the train stage of the CLI on a synthetic processed set
    rng8 = np.random.default_rng(SEED + 8)
    with tempfile.TemporaryDirectory(prefix="eegflow_chip_smoke_") as tmp:
        out_dir = Path(tmp)
        (out_dir / "processed_data").mkdir()
        arrays = {}
        for split, n in (("train", N_TRAIN_WINDOWS), ("val", 256), ("test", 256)):
            arrays[f"X_{split}"], arrays[f"y_{split}"] = synthetic_split(rng8, n, T, C)
        np.savez(out_dir / "processed_data" / "processed_sequences.npz", **arrays)
        save_results(out_dir / "results" / "ode_results.json",
                     {"fitted_params": DEFAULT_RATES})
        kernels.reset_launch_counts()
        t_train = time.perf_counter()
        rc = cli_main(["--output-dir", str(out_dir), "train", "--epochs", str(TRAIN_EPOCHS),
                       "--device", "cuda"])
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t_train
        train_counts = dict(kernels.launch_counts)
        require(rc == 0, "train stage returned 0")
        n_micro = TRAIN_EPOCHS * (3 * N_TRAIN_WINDOWS // B_TRAIN)  # x3 augmentation
        n_eval = TRAIN_EPOCHS + 1  # one validation batch per epoch, one test batch
        print(f"train stage: {TRAIN_EPOCHS} epochs, {n_micro} micro-steps of {B_TRAIN} in "
              f"{t_train:.1f} s; launches {train_counts}")
        for name, per_step in (("lstm_fwd_train", 6), ("lstm_bwd", 6), ("pool_head_bwd", 1),
                               ("input_block_bwd", 1)):
            require(train_counts.get(name, 0) == per_step * n_micro,
                    f"{name} launched {per_step} times per micro-step")
        for name in ("pool_head_fwd", "input_block_fwd"):
            require(train_counts.get(name, 0) == n_micro + n_eval,
                    f"{name} launched once per micro-step and per eval batch")
        require(train_counts.get("lstm_fwd", 0) == 6 * n_eval,
                "eval-mode lstm_fwd launched 6 times per eval batch")
        ckpt = out_dir / "models" / "lstm_attention"
        results = json.loads((out_dir / "results" / "lstm_results.json").read_text())
        require((ckpt / "params.msgpack").exists() and "f1" in results
                and (out_dir / "models" / "attention_weights.npy").exists(),
                "checkpoint, lstm_results.json and attention weights written")
        _, _, hist, _ = load_checkpoint(ckpt)
        require(len(hist["train_loss"]) == TRAIN_EPOCHS
                and all(math.isfinite(v) for v in hist["train_loss"] + hist["val_loss"]),
                "finite losses in the history")
        print(f"train history: train_loss {hist['train_loss']}, val_loss {hist['val_loss']}, "
              f"val_f1 {hist['val_f1']}; test acc {results['accuracy']:.4f}")
        served_model = load_coupled_model(out_dir, dev)
        pred = predict_batch(served_model, arrays["X_test"][:8], batch_size=BUCKET)
        require(pred["probs"].shape == (8, 2) and np.isfinite(pred["probs"]).all(),
                "the serve loader reads the trained checkpoint")
        print("serve loader: checkpoint read, probs finite", flush=True)

    # phase 9: one micro-step at B=512, kernel path against plain path
    tparams = classifier_init(cfg, make_generator(SEED + 9), device=dev, trainable=True)
    rng9 = np.random.default_rng(SEED + 9)
    x9, y9 = synthetic_split(rng9, B_TRAIN, T, C)
    x9, y9 = torch.from_numpy(x9).to(dev), torch.from_numpy(y9).to(dev)
    masks9 = draw_dropout_masks(cfg, B_TRAIN, T, torch.Generator(device=dev).manual_seed(9),
                                dev)
    cw = torch.tensor([1.0, 1.0], device=dev)
    leaves = list(tparams.parameters())

    def micro_step(impl, compute_dtype=torch.bfloat16, lstm_bwd="fused", res_bf16=False,
                   masks=None, kernel_dropout=False, x=None, y=None):
        for q in leaves:
            q.grad = None
        logits = classifier_apply(tparams, x9 if x is None else x, cfg,
                                  compute_dtype=compute_dtype, lstm_impl=impl, train=True,
                                  masks=masks9 if masks is None else masks, lstm_bwd=lstm_bwd,
                                  res_bf16=res_bf16, kernel_dropout=kernel_dropout)
        loss = cross_entropy_loss(logits, y9 if y is None else y, cw)
        loss.backward()
        return loss.detach(), [q.grad.clone() if q.grad is not None else torch.zeros_like(q)
                               for q in leaves]

    loss_k, grads_k = micro_step("kernel")
    loss_k2, grads_k2 = micro_step("kernel")
    loss_p, grads_p = micro_step("plain")
    torch.cuda.synchronize()
    loss_diff = abs(loss_k.item() - loss_p.item())
    grad_rel = max(rel_err(a, b) for a, b in zip(grads_k, grads_p) if b.abs().max() > 0)
    bitwise = torch.equal(loss_k, loss_k2) and all(torch.equal(a, b)
                                                   for a, b in zip(grads_k, grads_k2))
    print(f"micro-step B={B_TRAIN}: loss kernel {loss_k.item():.6f} plain {loss_p.item():.6f} "
          f"(diff {loss_diff:.3e}, tol {STEP_LOSS_TOL:g}); gradients max rel diff "
          f"{grad_rel:.3e} over {len(leaves)} leaves (tol {STEP_GRAD_REL_TOL:g}); "
          f"second kernel run bitwise identical: {bitwise}")
    require(math.isfinite(loss_k.item()) and loss_diff <= STEP_LOSS_TOL,
            "micro-step loss: kernel path within tolerance of the plain path")
    require(grad_rel <= STEP_GRAD_REL_TOL, "micro-step gradients within tolerance")
    require(bitwise, "kernel-path gradients bitwise repeatable")
    step_ms = median_ms({"plain": lambda: micro_step("plain"),
                         "kernel": lambda: micro_step("kernel")})
    for impl in ("kernel", "plain"):
        print(f"training micro-step (forward + backward) B={B_TRAIN} T={T} lstm_impl={impl}: "
              f"median {step_ms[impl]:.3f} ms, {B_TRAIN / step_ms[impl] * 1e3:.1f} windows/s "
              f"[{smi}]")
    del grads_k, grads_k2, grads_p

    xs2 = tuple(torch.tanh(randn(B_TRAIN, T, H)) for _ in range(2))
    ms2 = tuple(keep_masks((B_TRAIN, T, H), keep_mid) for _ in range(2))
    p1 = params["lstm"][1]["bwd"]
    fargs = (xs2, p1["w_ih"], p1["b"], p1["w_hh"], True, ms2, keep_mid)
    h2, res2 = lstm_fwd_train_plain(*fargs)
    g2 = 0.1 * randn(B_TRAIN, T, H)
    add2 = tuple(randn(B_TRAIN, T, H) for _ in range(2))
    bargs = (res2, h2, g2, xs2, p1["w_ih"], p1["w_hh"], True, ms2, keep_mid, add2)
    pool2 = tuple(torch.tanh(randn(B_TRAIN, T, H)) for _ in range(2))
    pargs2 = (params["lstm_norm"], params["attention"], pool2,
              torch.softmax(randn(B_TRAIN, T), dim=-1), 0.01 * randn(B_TRAIN, T),
              tuple(0.1 * randn(B_TRAIN, H) for _ in range(2)), 0.1 * randn(B_TRAIN), True,
              True)
    # products of one layer-direction's backward at B=512, two parts: dh_carry,
    # dx, dW_ih and dW_hh, 2 B T 4H (2 D + 2 H)
    bwd_flops = 2 * B_TRAIN * T * 4 * H * (2 * 2 * H + 2 * H)
    # kernels 2 (planes) and 3 at the micro-step's batch, on the plans it launches
    train_fwd_err = max(train_fwd_err, hold_at_main_shape(
        f"lstm_fwd train B={B_TRAIN} T={T} H={H} parts=2 reverse "
        f"({kernel_plan('fwd', B_TRAIN, H, 1).rows} rows a cluster)",
        list(lstm_fwd_train(*fargs)), list(lstm_fwd_train(*fargs)), [h2, res2], TRAIN_FWD_TOL,
        relative=False))
    flat_bwd = lambda out: list(out[0]) + list(out[1:])  # noqa: E731
    bwd_err = max(bwd_err, hold_at_main_shape(
        f"lstm_bwd B={B_TRAIN} T={T} H={H} parts=2 reverse dx_add "
        f"({kernel_plan('bwd', B_TRAIN, H).rows} rows a cluster): dx, dW_ih, dW_hh, db",
        flat_bwd(lstm_bwd(*bargs)), flat_bwd(lstm_bwd(*bargs)), flat_bwd(lstm_bwd_plain(*bargs)),
        BWD_REL_TOL, relative=True))
    flat_pool = lambda out: list(out[0]) + list(out[1:])  # noqa: E731
    pool_bwd_err = max(pool_bwd_err, hold_at_main_shape(
        f"pool_head_bwd bf16 B={B_TRAIN} T={T} parts=2x{H} K={H} (tensor cores): dh, dW1, db1, "
        f"dw2, dgamma, dbeta", flat_pool(pool_head_bwd(*pargs2)), flat_pool(pool_head_bwd(*pargs2)),
        flat_pool(pool_head_bwd_plain(*pargs2)), POOL_BWD_REL_TOL, relative=True))
    head_flops = 3 * 2 * B_TRAIN * T * 2 * H * H  # projection, dW1, dh
    # kernel 7 at the micro-step's batch
    fargs7 = (params["lstm_norm"], params["attention"], pool2, True, True)
    pool_err = max(pool_err, hold_at_main_shape(
        f"pool_head_fwd bf16 B={B_TRAIN} T={T} parts=2x{H} K={H} (tensor cores): ctx parts, "
        f"scores", flat_head(pool_head_fused(*fargs7)), flat_head(pool_head_fused(*fargs7)),
        flat_head(pool_head_fused_plain(*fargs7)), POOL_TOL, relative=False))
    train_ms = {}
    for name, kfn, pfn, args, flops in (
            ("lstm_fwd_train", lstm_fwd_train, lstm_fwd_train_plain, fargs,
             lstm_flops(B_TRAIN, 2 * H, H)),
            ("lstm_bwd", lstm_bwd, lstm_bwd_plain, bargs, bwd_flops),
            ("pool_head_bwd", pool_head_bwd, pool_head_bwd_plain, pargs2, head_flops),
            ("pool_head_fwd bf16", pool_head_fused, pool_head_fused_plain, fargs7,
             head_flops // 3)):
        work[name] = (nbytes(args, kfn(*args)), flops, "bf16")
        m = median_ms({"plain": lambda: pfn(*args), "kernel": lambda: kfn(*args)}, rounds=1)
        train_ms[name] = (m["kernel"], m["plain"])
        print(f"{name} B={B_TRAIN} T={T} H={H} parts=2: kernel {m['kernel']:.3f} ms, "
              f"plain {m['plain']:.3f} ms [{smi}]", flush=True)

    # phase 10: the float32 policy's kernels against their twins
    rec_err = rec_bwd_err = 0.0
    for n_parts, layer in ((1, params["lstm"][0]), (2, params["lstm"][1])):
        xs = tuple(torch.tanh(randn(B_CHECK, T, H)) for _ in range(n_parts))
        for direction, reverse in (("fwd", False), ("bwd", True)):
            p = layer[direction]
            gates = torch.cat(xs, dim=-1) @ p["w_ih"] + p["b"]
            h_e = lstm_recurrence(gates, p["w_hh"], reverse)
            # training mode writes z over its gates: each call gets its own copy
            z_k, z_k2, z_p = gates.clone(), gates.clone(), gates.clone()
            h_k, c_k = lstm_recurrence(z_k, p["w_hh"], reverse, True)
            h_p, c_p = lstm_recurrence_plain(z_p, p["w_hh"], reverse, True)
            same = (torch.equal(h_e, lstm_recurrence(gates, p["w_hh"], reverse))
                    and all(torch.equal(a, b) for a, b in
                            zip((h_k, c_k), lstm_recurrence(z_k2, p["w_hh"], reverse, True)))
                    and torch.equal(z_k, z_k2))
            torch.cuda.synchronize()
            err = max((h_e - h_p).abs().max().item(), (h_k - h_p).abs().max().item(),
                      (c_k - c_p).abs().max().item(), (z_k - z_p).abs().max().item())
            print(f"lstm_rec_fwd parts={n_parts} reverse={reverse} B={B_CHECK} T={T} H={H}: "
                  f"h (eval, training), c and z max_abs_diff {err:.3e} (tol {REC_TOL:g}); repeat "
                  f"bitwise identical: {same}")
            require(bool(torch.isfinite(h_k).all()) and err <= REC_TOL and same,
                    f"lstm_rec_fwd within {REC_TOL} of its twin, bitwise repeatable")
            rec_err = max(rec_err, err)
            g_up = 0.1 * randn(B_CHECK, T, H)
            got = lstm_recurrence_backward(z_p, h_p, c_p, p["w_hh"], g_up, reverse)
            again = lstm_recurrence_backward(z_p, h_p, c_p, p["w_hh"], g_up, reverse)
            want = lstm_recurrence_backward_plain(z_p, h_p, c_p, p["w_hh"], g_up, reverse)
            torch.cuda.synchronize()
            errs = {"dgates": rel_err(got[0], want[0]), "dW_hh": rel_err(got[1], want[1])}
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            print(f"lstm_rec_bwd parts={n_parts} reverse={reverse}: "
                  + ", ".join(f"{k} rel {v:.3e}" for k, v in errs.items())
                  + f" (tol {REC_BWD_REL_TOL:g}); repeat bitwise identical: {same}")
            require(max(errs.values()) <= REC_BWD_REL_TOL and same,
                    f"lstm_rec_bwd within {REC_BWD_REL_TOL} of its twin, bitwise repeatable")
            rec_bwd_err = max(rec_bwd_err, *[(a - b).abs().max().item()
                                             for a, b in zip(got, want)])
    x_in = randn(B_CHECK, T, C)
    dy_in = randn(B_CHECK, T, H)
    in_fwd_err32 = in_bwd_err = in_bwd_err32 = 0.0
    for bf16 in (False, True):
        y_k = input_block_fused(params["input_proj"], params["input_norm"], x_in, bf16)
        y_p = input_block_fused_plain(params["input_proj"], params["input_norm"], x_in, bf16)
        got = input_block_bwd(params["input_proj"], params["input_norm"], x_in, dy_in, bf16)
        again = input_block_bwd(params["input_proj"], params["input_norm"], x_in, dy_in, bf16)
        want = input_block_bwd_plain(params["input_proj"], params["input_norm"], x_in, dy_in,
                                     bf16)
        torch.cuda.synchronize()
        err = (y_k - y_p).abs().max().item()
        errs = {n: rel_err(a, b) for n, a, b in
                zip(("dx", "dW", "db", "dgamma", "dbeta"), got, want)}
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"input_block bf16={int(bf16)} B={B_CHECK} T={T} C={C} H={H}: forward "
              f"max_abs_diff {err:.3e} (tol {INPUT_TOL:g}); backward "
              + ", ".join(f"{k} rel {v:.3e}" for k, v in errs.items())
              + f" (tol {INPUT_BWD_REL_TOL[bf16]:g}); repeat bitwise identical: {same}")
        require(err <= INPUT_TOL, f"input_block_fwd within {INPUT_TOL} of its twin")
        require(max(errs.values()) <= INPUT_BWD_REL_TOL[bf16] and same,
                "input_block_bwd within tolerance of its twin, bitwise repeatable")
        bwd_abs = max((a - b).abs().max().item() for a, b in zip(got, want))
        if bf16:
            in_fwd_err = max(in_fwd_err, err)
            in_bwd_err = max(in_bwd_err, bwd_abs)
        else:
            in_fwd_err32 = max(in_fwd_err32, err)
            in_bwd_err32 = max(in_bwd_err32, bwd_abs)
    attn256 = {name: {k: v.to(dev) for k, v in sub.items()}
               for name, sub in additive_attention_init(make_generator(SEED + 10), H).items()}
    apool_args = (torch.tanh(randn(B_CHECK, T, H)), attn256["proj"]["w"], attn256["proj"]["b"],
                  attn256["score"]["w"][:, 0])
    got = attention_pool(*apool_args)
    want = attention_pool_plain(*apool_args)
    torch.cuda.synchronize()
    apool_err = max((a - b).abs().max().item() for a, b in zip(got, want))
    print(f"attention_pool D={H} K={H // 2} B={B_CHECK} T={T}: ctx and scores max_abs_diff "
          f"{apool_err:.3e} (tol {ATTN_POOL_TOL:g})", flush=True)
    require(apool_err <= ATTN_POOL_TOL, f"attention_pool within {ATTN_POOL_TOL} of its twin")

    # phase 11: attention_pool through its entry point at B=512
    xa = torch.tanh(randn(B_TRAIN, T, H))
    kernels.reset_launch_counts()
    ctx_a, wts_a = attention_pool_apply(attn256, xa)
    torch.cuda.synchronize()
    attn_counts = dict(kernels.launch_counts)
    require(attn_counts == {"attention_pool": 1}, f"attention_pool_apply launches {attn_counts}")
    ctx_w, s_w = attention_pool_plain(xa, attn256["proj"]["w"], attn256["proj"]["b"],
                                      attn256["score"]["w"][:, 0])
    wts_w = torch.softmax(s_w + attn256["score"]["b"][0], dim=-1)
    err = max((ctx_a - ctx_w).abs().max().item(), (wts_a - wts_w).abs().max().item())
    print(f"attention_pool_apply B={B_TRAIN} T={T} D={H}: launches {attn_counts}; context and "
          f"weights max_abs_diff {err:.3e} (tol {ATTN_POOL_TOL:g})")
    require(err <= ATTN_POOL_TOL and bool(torch.isfinite(ctx_a).all()),
            "attention_pool_apply agrees with its twin")
    apool_err = max(apool_err, err)
    aargs = (xa, attn256["proj"]["w"], attn256["proj"]["b"], attn256["score"]["w"][:, 0])
    work["attention_pool"] = (nbytes(aargs, attention_pool(*aargs)),
                              2 * B_TRAIN * T * H * (H // 2), "tf32x3")
    m = median_ms({"plain": lambda: attention_pool_plain(*aargs),
                   "kernel": lambda: attention_pool(*aargs)}, rounds=1)
    apool_ms = (m["kernel"], m["plain"])
    print(f"attention_pool B={B_TRAIN} T={T} D={H} K={H // 2}: kernel {m['kernel']:.3f} ms, "
          f"plain {m['plain']:.3f} ms [{smi}]", flush=True)

    # phase 12: the train stage under the float32 policy
    rng12 = np.random.default_rng(SEED + 12)
    with tempfile.TemporaryDirectory(prefix="eegflow_chip_smoke_f32_") as tmp:
        out_dir = Path(tmp)
        (out_dir / "processed_data").mkdir()
        arrays = {}
        for split, n in (("train", N_TRAIN_WINDOWS), ("val", 256), ("test", 256)):
            arrays[f"X_{split}"], arrays[f"y_{split}"] = synthetic_split(rng12, n, T, C)
        np.savez(out_dir / "processed_data" / "processed_sequences.npz", **arrays)
        save_results(out_dir / "results" / "ode_results.json",
                     {"fitted_params": DEFAULT_RATES})
        (out_dir / "config.json").write_text(json.dumps({"train": {"bf16": False}}))
        kernels.reset_launch_counts()
        t_train = time.perf_counter()
        rc = cli_main(["--output-dir", str(out_dir), "--config", str(out_dir / "config.json"),
                       "train", "--epochs", str(N_TRAIN32_EPOCHS), "--device", "cuda"])
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t_train
        f32_counts = dict(kernels.launch_counts)
        require(rc == 0, "float32 train stage returned 0")
        n_micro = N_TRAIN32_EPOCHS * (3 * N_TRAIN_WINDOWS // B_TRAIN)
        n_eval = N_TRAIN32_EPOCHS + 1
        print(f"train stage (bf16 false): {N_TRAIN32_EPOCHS} epoch, {n_micro} micro-steps of "
              f"{B_TRAIN} in {t_train:.1f} s; launches {f32_counts}")
        want_counts = {"input_block_fwd": n_micro + n_eval, "input_block_bwd": n_micro,
                       "lstm_rec_fwd_train": 6 * n_micro, "lstm_rec_bwd": 6 * n_micro,
                       "pool_head_fwd": n_micro + n_eval, "pool_head_bwd": n_micro,
                       "lstm_rec_fwd": 6 * n_eval}
        require(f32_counts == want_counts,
                f"float32 launches 1/1/6/6/1/1 per micro-step, 6 lstm_rec_fwd per eval "
                f"batch: want {want_counts}")
        _, _, hist, _ = load_checkpoint(out_dir / "models" / "lstm_attention")
        require(all(math.isfinite(v) for v in hist["train_loss"] + hist["val_loss"]),
                "finite losses in the float32 history")
        print(f"float32 train history: train_loss {hist['train_loss']}, val_loss "
              f"{hist['val_loss']}, val_f1 {hist['val_f1']}")
        served_model = load_coupled_model(out_dir, dev)
        xt = torch.from_numpy(arrays["X_test"][:64]).to(dev)
        rollout_args = (served_model.params, xt, served_model.k_base, served_model.model_cfg)
        with torch.inference_mode():
            kernels.reset_launch_counts()
            roll_k = coupled_rollout(*rollout_args, bf16=False)
            torch.cuda.synchronize()
            roll_counts = dict(kernels.launch_counts)
            roll_p = coupled_rollout(*rollout_args, bf16=False, lstm_impl="plain")
        err = max((roll_k[n] - roll_p[n]).abs().max().item()
                  for n in ("probs", "final_state", "attention"))
        print(f"serve loader read the float32 checkpoint; coupled_rollout(bf16=False) on 64 "
              f"windows: launches {roll_counts}, kernel vs plain max_abs_diff {err:.3e} "
              f"(tol {PROBS_TOL:g})", flush=True)
        require(roll_counts == {"input_block_fwd": 1, "lstm_rec_fwd": 6, "pool_head_fwd": 1},
                "coupled_rollout(bf16=False) runs the float32 kernels")
        require(err <= PROBS_TOL, "float32 rollout: kernel path agrees with the plain path")

    # phase 13: a float32 micro-step at B=512, kernel path against plain path
    kernels.reset_launch_counts()
    loss_k, grads_k = micro_step("kernel", None)
    torch.cuda.synchronize()
    step_counts = dict(kernels.launch_counts)
    loss_k2, grads_k2 = micro_step("kernel", None)
    loss_p, grads_p = micro_step("plain", None)
    torch.cuda.synchronize()
    require(step_counts == {"input_block_fwd": 1, "input_block_bwd": 1, "lstm_rec_fwd_train": 6,
                            "lstm_rec_bwd": 6, "pool_head_fwd": 1, "pool_head_bwd": 1},
            f"float32 micro-step launches {step_counts}")
    loss_diff = abs(loss_k.item() - loss_p.item())
    grad_rel = max(rel_err(a, b) for a, b in zip(grads_k, grads_p) if b.abs().max() > 0)
    bitwise = torch.equal(loss_k, loss_k2) and all(torch.equal(a, b)
                                                   for a, b in zip(grads_k, grads_k2))
    print(f"float32 micro-step B={B_TRAIN}: loss kernel {loss_k.item():.6f} plain "
          f"{loss_p.item():.6f} (diff {loss_diff:.3e}, tol {STEP32_LOSS_TOL:g}); gradients max "
          f"rel diff {grad_rel:.3e} over {len(leaves)} leaves (tol {STEP32_GRAD_REL_TOL:g}); "
          f"second kernel run bitwise identical: {bitwise}")
    require(math.isfinite(loss_k.item()) and loss_diff <= STEP32_LOSS_TOL,
            "float32 micro-step loss: kernel path within tolerance of the plain path")
    require(grad_rel <= STEP32_GRAD_REL_TOL, "float32 micro-step gradients within tolerance")
    require(bitwise, "float32 kernel-path gradients bitwise repeatable")
    del grads_k, grads_k2, grads_p
    step32_ms = median_ms({"plain": lambda: micro_step("plain", None),
                           "kernel": lambda: micro_step("kernel", None),
                           "bf16 fused": lambda: micro_step("kernel")})
    for impl in ("kernel", "plain"):
        print(f"float32 training micro-step (forward + backward) B={B_TRAIN} T={T} "
              f"lstm_impl={impl}: median {step32_ms[impl]:.3f} ms, "
              f"{B_TRAIN / step32_ms[impl] * 1e3:.1f} windows/s (in turns with the bf16 "
              f"\"fused\" step on the kernel path, {step32_ms['bf16 fused']:.3f} ms) [{smi}]")

    gates2 = torch.cat(xs2, dim=-1) @ p1["w_ih"] + p1["b"]
    z32 = gates2.clone()  # training mode leaves z over its gates
    h32, c32 = lstm_recurrence_plain(z32, p1["w_hh"], True, True)
    # kernel 1 on the plans the main path launches: training (the float32
    # micro-step, h, c and the z it leaves over the gates) and eval at B=512,
    # eval at the serving bucket (coupled_rollout(bf16=False) of a
    # 1024-window batch)
    gates_big = (torch.cat(tuple(torch.tanh(randn(BUCKET, T, H)) for _ in range(2)), dim=-1)
                 @ p1["w_ih"] + p1["b"])
    h_big = lstm_recurrence_plain(gates_big, p1["w_hh"], False)
    for gates_m, reverse, train, want in ((gates2, True, True, [h32, c32, z32]),
                                          (gates2, True, False, [h32]),
                                          (gates_big, False, False, [h_big])):
        plan = kernel_plan("rec", gates_m.shape[0], H, int(train))
        runs = []
        for _ in range(2):
            z = gates_m.clone() if train else gates_m
            out = lstm_recurrence(z, p1["w_hh"], reverse, train)
            runs.append(list(out) + [z] if train else [out])
        rec_err = max(rec_err, hold_at_main_shape(
            f"lstm_rec_fwd {'training' if train else 'eval'} B={gates_m.shape[0]} T={T} H={H} "
            f"({plan.rows} rows a cluster of {plan.hc}, {plan.clusters} clusters in "
            f"{plan.waves} wave(s)): " + ("h, c, z over the gates" if train else "h"),
            runs[0], runs[1], want, REC_TOL, relative=False))
    # kernel 5 on the plan the float32 micro-step launches, from the z kernel
    # 1's training mode leaves
    plan = kernel_plan("rec_bwd", B_TRAIN, H)
    rec_bwd_args = (z32, h32, c32, p1["w_hh"], g2, True)
    rec_bwd_err = max(rec_bwd_err, hold_at_main_shape(
        f"lstm_rec_bwd B={B_TRAIN} T={T} H={H} ({plan.rows} rows a cluster of {plan.hc}, "
        f"{plan.clusters} clusters in {plan.waves} wave(s)): dgates, dW_hh",
        list(lstm_recurrence_backward(*rec_bwd_args)),
        list(lstm_recurrence_backward(*rec_bwd_args)),
        list(lstm_recurrence_backward_plain(*rec_bwd_args)), REC_BWD_REL_TOL, relative=True))
    del h_big
    m = median_ms({"plain": lambda: lstm_recurrence_plain(gates_big, p1["w_hh"], False),
                   "kernel": lambda: lstm_recurrence(gates_big, p1["w_hh"], False)}, rounds=1)
    print(f"lstm_rec_fwd eval B={BUCKET} T={T} H={H}: kernel {m['kernel']:.3f} ms, plain "
          f"{m['plain']:.3f} ms [{smi}]", flush=True)
    del gates_big
    x512 = randn(B_TRAIN, T, C)
    dy512 = randn(B_TRAIN, T, H)
    pargs32 = pargs2[:-1] + (False,)
    rec_flops = 2 * B_TRAIN * T * H * 4 * H  # one h . W_hh per step, float32
    in_flops = 2 * B_TRAIN * T * C * H  # x . W of the input block
    # kernel 10's bf16 mode at the micro-step's shape, on its persistent grid
    in_plan = bwd_plan(B_TRAIN * T, C, H, True)
    in_bwd_err = max(in_bwd_err, hold_at_main_shape(
        f"input_block_bwd bf16 B={B_TRAIN} T={T} C={C} H={H} ({in_plan.ctas} CTAs of "
        f"{in_plan.tile_rows}-row tiles, tensor cores): dx, dW, db, dgamma, dbeta",
        list(input_block_bwd(*ib, x512, dy512, True)),
        list(input_block_bwd(*ib, x512, dy512, True)),
        list(input_block_bwd_plain(*ib, x512, dy512, True)), INPUT_BWD_REL_TOL[True],
        relative=True))
    in_parts = device_ms(lambda: input_block_bwd(*ib, x512, dy512, True), 5)
    print(f"input_block_bwd bf16 B={B_TRAIN} T={T}: device ms a launch by kernel (torch.profiler): "
          + ", ".join(f"{k} {v:.3f}" for k, v in in_parts.items()) + f" [{smi}]",
          flush=True)
    # kernel 9 in both modes at the micro-step's shape, on its persistent grid
    in_plan = fwd_plan(B_TRAIN * T, H)
    for bf16 in (True, False):
        mode = "bf16" if bf16 else "float32"
        err = hold_at_main_shape(
            f"input_block_fwd {mode} B={B_TRAIN} T={T} C={C} H={H} ({in_plan.ctas} CTAs of "
            f"{in_plan.tile_rows}-row tiles, {'tensor' if bf16 else 'CUDA'} cores): y",
            [input_block_fused(*ib, x512, bf16)], [input_block_fused(*ib, x512, bf16)],
            [input_block_fused_plain(*ib, x512, bf16)], INPUT_TOL, relative=False)
        if bf16:
            in_fwd_err = max(in_fwd_err, err)
        else:
            in_fwd_err32 = max(in_fwd_err32, err)
        split = device_ms(lambda: input_block_fused(*ib, x512, bf16), 5)
        print(f"input_block_fwd {mode} B={B_TRAIN} T={T}: device ms a launch by kernel "
              f"(torch.profiler): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
              + f" [{smi}]", flush=True)
    # kernel 8's float32 mode at the micro-step's shape (two parts of 256)
    pool_bwd_err32 = hold_at_main_shape(
        f"pool_head_bwd float32 B={B_TRAIN} T={T} parts=2x{H} K={H} (3xTF32 tensor cores): dh, "
        f"dW1, db1, dw2, dgamma, dbeta", flat_pool(pool_head_bwd(*pargs32)),
        flat_pool(pool_head_bwd(*pargs32)), flat_pool(pool_head_bwd_plain(*pargs32)),
        POOL_BWD_REL_TOL, relative=True)
    split = device_ms(lambda: pool_head_bwd(*pargs32), 5)
    print(f"pool_head_bwd float32 B={B_TRAIN} T={T}: device ms a launch by kernel (torch.profiler): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()) + f" [{smi}]", flush=True)
    # kernel 10's float32 mode at the micro-step's shape, on its persistent grid
    in_plan32 = bwd_plan(B_TRAIN * T, C, H, False)
    in_bwd_err32 = max(in_bwd_err32, hold_at_main_shape(
        f"input_block_bwd float32 B={B_TRAIN} T={T} C={C} H={H} ({in_plan32.ctas} CTAs of "
        f"{in_plan32.tile_rows}-row tiles, 3xTF32 tensor cores): dx, dW, db, dgamma, dbeta",
        list(input_block_bwd(*ib, x512, dy512, False)),
        list(input_block_bwd(*ib, x512, dy512, False)),
        list(input_block_bwd_plain(*ib, x512, dy512, False)), INPUT_BWD_REL_TOL[False],
        relative=True))
    split = device_ms(lambda: input_block_bwd(*ib, x512, dy512, False), 5)
    print(f"input_block_bwd float32 B={B_TRAIN} T={T}: device ms a launch by kernel "
          f"(torch.profiler): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f" [{smi}]", flush=True)
    # kernel 7's float32 mode at the micro-step's batch
    fargs32 = fargs7[:-1] + (False,)
    pool_err32 = max(pool_err32, hold_at_main_shape(
        f"pool_head_fwd float32 B={B_TRAIN} T={T} parts=2x{H} K={H} (3xTF32 tensor cores): ctx "
        f"parts, scores", flat_head(pool_head_fused(*fargs32)),
        flat_head(pool_head_fused(*fargs32)), flat_head(pool_head_fused_plain(*fargs32)),
        POOL32_TOL, relative=False))
    split = device_ms(lambda: pool_head_fused(*fargs32), 5)
    print(f"pool_head_fwd float32 B={B_TRAIN} T={T}: device ms a launch by kernel (torch.profiler): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()) + f" [{smi}]", flush=True)
    # training mode writes z over its gates; the timed calls share one buffer
    # (its z drifts from call to call, which no timing depends on)
    z_buf = gates2.clone()
    timed = (
        ("lstm_rec_fwd", lstm_recurrence, lstm_recurrence_plain, (gates2, p1["w_hh"], True),
         rec_flops, "float32"),
        ("lstm_rec_fwd_train", lstm_recurrence, lstm_recurrence_plain,
         (z_buf, p1["w_hh"], True, True), rec_flops, "float32"),
        # dh_carry and dW_hh
        ("lstm_rec_bwd", lstm_recurrence_backward, lstm_recurrence_backward_plain,
         rec_bwd_args, 2 * rec_flops, "float32"),
        ("input_block_fwd bf16", input_block_fused, input_block_fused_plain, (*ib, x512, True),
         in_flops, "bf16"),
        # the recomputed forward, dW and dx
        ("input_block_bwd bf16", input_block_bwd, input_block_bwd_plain,
         (*ib, x512, dy512, True), 3 * in_flops, "bf16"),
        ("input_block_fwd float32", input_block_fused, input_block_fused_plain,
         (*ib, x512, False), in_flops, "float32"),
        # the recomputed forward on CUDA cores, dx and dW in 3xTF32
        ("input_block_bwd float32", input_block_bwd, input_block_bwd_plain,
         (*ib, x512, dy512, False), (in_flops, 2 * in_flops), ("float32", "tf32x3")),
        ("pool_head_bwd float32", pool_head_bwd, pool_head_bwd_plain, pargs32, head_flops,
         "tf32x3"),
        ("pool_head_fwd float32", pool_head_fused, pool_head_fused_plain, fargs32,
         head_flops // 3, "tf32x3"))
    for name, kfn, pfn, args, flops, dtype in timed:
        # kernel 1's training mode also writes z (the size of its gates)
        extra = nbytes(z_buf) if name == "lstm_rec_fwd_train" else 0
        work[name] = (nbytes(args, kfn(*args)) + extra, flops, dtype)
        m = median_ms({"plain": lambda: pfn(*args), "kernel": lambda: kfn(*args)}, rounds=1)
        train_ms[name] = (m["kernel"], m["plain"])
        bound_ms, bound_by = bound(*work[name])
        peaks = "+".join(dtype) if isinstance(dtype, tuple) else dtype
        print(f"{name} B={B_TRAIN} T={T} H={H}: kernel {m['kernel']:.3f} ms, "
              f"plain {m['plain']:.3f} ms, bound {bound_ms:.3f} ms by {bound_by} at the "
              f"{peaks} peak [{smi}]", flush=True)

    # phase 14: the kernels of the two other bf16 backward schedules
    gates_err = v2_err = dd_err = 0.0
    for n_parts, layer, keep in ((1, params["lstm"][0], keep_in),
                                 (2, params["lstm"][1], keep_mid)):
        xs = tuple(torch.tanh(randn(B_CHECK, T, H)) for _ in range(n_parts))
        ms = tuple(keep_masks((B_CHECK, T, H), keep) for _ in range(n_parts))
        for direction, reverse in (("fwd", False), ("bwd", True)):
            p = layer[direction]
            fwd_args = (xs, p["w_ih"], p["b"], p["w_hh"], reverse, ms, keep)
            got = lstm_fwd_train_gates(*fwd_args)
            again = lstm_fwd_train_gates(*fwd_args)
            h_p, gates_p, c_p = lstm_fwd_train_gates_plain(*fwd_args)
            torch.cuda.synchronize()
            err = max((a - b).abs().max().item() for a, b in zip(got, (h_p, gates_p, c_p)))
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            print(f"lstm_fwd_train_gates parts={n_parts} reverse={reverse} B={B_CHECK} T={T} "
                  f"H={H}: h, gates and c max_abs_diff {err:.3e} (tol {TRAIN_FWD_TOL:g}); "
                  f"repeat bitwise identical: {same}")
            require(all(bool(torch.isfinite(t).all()) for t in got) and err <= TRAIN_FWD_TOL
                    and same, f"lstm_fwd_train_gates within {TRAIN_FWD_TOL} of its twin, "
                    f"bitwise repeatable")
            gates_err = max(gates_err, err)
            g_up = 0.1 * randn(B_CHECK, T, H)
            dx_add = tuple(randn(B_CHECK, T, H) for _ in range(n_parts)) if reverse else None
            v2_args = (gates_p, c_p, h_p, g_up, xs, p["w_ih"], p["w_hh"], reverse, ms, keep,
                       dx_add)
            got = lstm_bwd_v2(*v2_args)
            again = lstm_bwd_v2(*v2_args)
            want = lstm_bwd_v2_plain(*v2_args)
            torch.cuda.synchronize()
            errs = {"dx": max(rel_err(a, b) for a, b in zip(got[0], want[0])),
                    "dW_ih": rel_err(got[1], want[1]), "dW_hh": rel_err(got[2], want[2]),
                    "db": rel_err(got[3], want[3])}
            same = all(torch.equal(a, b) for a, b in zip(got[0] + got[1:], again[0] + again[1:]))
            print(f"lstm_bwd_v2 parts={n_parts} reverse={reverse} dx_add={dx_add is not None}: "
                  + ", ".join(f"{k} rel {v:.3e}" for k, v in errs.items())
                  + f" (tol {BWD_REL_TOL:g}); repeat bitwise identical: {same}")
            require(max(errs.values()) <= BWD_REL_TOL and same,
                    f"lstm_bwd_v2 within {BWD_REL_TOL} of its twin, bitwise repeatable")
            v2_err = max(v2_err, *[(a - b).abs().max().item()
                                   for a, b in zip(got[0] + got[1:], want[0] + want[1:])])
        # kernel 4: the layer's two directions on parts dropped by select dropout
        for mask_from_x in (True, False):
            xd = (tuple(select_dropout(x, m, keep) for x, m in zip(xs, ms)) if mask_from_x
                  else xs)
            kd = keep if mask_from_x else 1.0
            pf, pb = layer["fwd"], layer["bwd"]
            h_f, res_f = lstm_fwd_train_plain(xd, pf["w_ih"], pf["b"], pf["w_hh"], False)
            h_r, res_r = lstm_fwd_train_plain(xd, pb["w_ih"], pb["b"], pb["w_hh"], True)
            g_f, g_r = 0.1 * randn(B_CHECK, T, H), 0.1 * randn(B_CHECK, T, H)
            dd_args = (res_f, h_f, g_f, res_r, h_r, g_r, xd, (pf["w_ih"], pf["w_hh"]),
                       (pb["w_ih"], pb["w_hh"]), kd, mask_from_x)
            got = lstm_bwd_dualdir(*dd_args)
            again = lstm_bwd_dualdir(*dd_args)
            want = lstm_bwd_dualdir_plain(*dd_args)
            flat = lambda out: list(out[0]) + list(out[1]) + list(out[2])  # noqa: E731
            cases = {"twin": want}
            if not mask_from_x:  # kernel 3 twice: forward, then reverse adding its dx
                dx_f, *gr_f = lstm_bwd(res_f, h_f, g_f, xd, pf["w_ih"], pf["w_hh"], False)
                dx_b, *gr_r = lstm_bwd(res_r, h_r, g_r, xd, pb["w_ih"], pb["w_hh"], True,
                                       dx_add=dx_f)
                cases["two lstm_bwd"] = (dx_b, tuple(gr_f), tuple(gr_r))
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(flat(got), flat(again)))
            if not mask_from_x:
                k3_same = all(torch.equal(a, b)
                              for a, b in zip(flat(got), flat(cases["two lstm_bwd"])))
                print(f"lstm_bwd_dualdir parts={n_parts} without dropout: equals two lstm_bwd "
                      f"launches bit for bit: {k3_same}")
                require(k3_same, "lstm_bwd_dualdir equals two lstm_bwd launches bit for bit")
            for label, ref in cases.items():
                err = max(rel_err(a, b) for a, b in zip(flat(got), flat(ref)))
                print(f"lstm_bwd_dualdir parts={n_parts} mask_from_x={mask_from_x} vs {label}: "
                      f"dx, dW_ih, dW_hh, db of both directions max rel {err:.3e} "
                      f"(tol {BWD_REL_TOL:g}); repeat bitwise identical: {same}")
                require(err <= BWD_REL_TOL and same,
                        f"lstm_bwd_dualdir within {BWD_REL_TOL} of {label}, bitwise repeatable")
            dd_err = max(dd_err, *[(a - b).abs().max().item()
                                   for a, b in zip(flat(got), flat(want))])
    print(flush=True)

    # phase 15: B=512 micro-steps under the two other backward schedules
    sched_counts, sched_ms = {}, {}
    for sched in ("two_pass", "dualdir"):
        kernels.reset_launch_counts()
        loss_k, grads_k = micro_step("kernel", lstm_bwd=sched)
        torch.cuda.synchronize()
        sched_counts[sched] = dict(kernels.launch_counts)
        loss_k2, grads_k2 = micro_step("kernel", lstm_bwd=sched)
        loss_p, grads_p = micro_step("plain", lstm_bwd=sched)
        torch.cuda.synchronize()
        want_counts = train_step_launches(cfg, sched)
        print(f"micro-step lstm_bwd={sched} B={B_TRAIN}: launches {sched_counts[sched]}")
        require(sched_counts[sched] == want_counts,
                f"lstm_bwd={sched} launches per micro-step: want {want_counts}")
        loss_diff = abs(loss_k.item() - loss_p.item())
        grad_rel = max(rel_err(a, b) for a, b in zip(grads_k, grads_p) if b.abs().max() > 0)
        bitwise = torch.equal(loss_k, loss_k2) and all(torch.equal(a, b)
                                                       for a, b in zip(grads_k, grads_k2))
        print(f"micro-step lstm_bwd={sched} B={B_TRAIN}: loss kernel {loss_k.item():.6f} plain "
              f"{loss_p.item():.6f} (diff {loss_diff:.3e}, tol {STEP_LOSS_TOL:g}); gradients "
              f"max rel diff {grad_rel:.3e} over {len(leaves)} leaves (tol "
              f"{STEP_GRAD_REL_TOL:g}); second kernel run bitwise identical: {bitwise}")
        require(math.isfinite(loss_k.item()) and loss_diff <= STEP_LOSS_TOL,
                f"lstm_bwd={sched} micro-step loss within tolerance of the plain path")
        require(grad_rel <= STEP_GRAD_REL_TOL,
                f"lstm_bwd={sched} micro-step gradients within tolerance")
        require(bitwise, f"lstm_bwd={sched} kernel-path gradients bitwise repeatable")
        del grads_k, grads_k2, grads_p
        m = median_ms({"fused": lambda: micro_step("kernel"),
                       sched: lambda: micro_step("kernel", lstm_bwd=sched)})
        sched_ms[sched] = m
        for name in ("fused", sched):
            print(f"training micro-step lstm_bwd={name} B={B_TRAIN} T={T} (kernel path, in turns "
                  f"with the other): median {m[name]:.3f} ms, "
                  f"{B_TRAIN / m[name] * 1e3:.1f} windows/s [{smi}]", flush=True)

    # kernel 3b and kernel 4 at B=512 against their twins and kernel 3
    h_g, gates_g, c_g = lstm_fwd_train_gates_plain(*fargs)
    v2_args = (gates_g, c_g, h_g, g2, xs2, p1["w_ih"], p1["w_hh"], True, ms2, keep_mid, add2)
    work["lstm_fwd_train_gates"] = (nbytes(fargs, (h_g, gates_g, c_g)),
                                    lstm_flops(B_TRAIN, 2 * H, H), "bf16")
    work["lstm_bwd_v2"] = (nbytes(v2_args, lstm_bwd_v2(*v2_args)), bwd_flops, "bf16")
    v2_err = max(v2_err, hold_at_main_shape(
        f"lstm_bwd_v2 B={B_TRAIN} T={T} H={H} parts=2 reverse dx_add "
        f"({kernel_plan('bwd_v2', B_TRAIN, H).rows} rows a cluster): dx, dW_ih, dW_hh, db",
        flat_bwd(lstm_bwd_v2(*v2_args)), flat_bwd(lstm_bwd_v2(*v2_args)),
        flat_bwd(lstm_bwd_v2_plain(*v2_args)), BWD_REL_TOL, relative=True))
    gates_err = max(gates_err, hold_at_main_shape(
        f"lstm_fwd_train_gates B={B_TRAIN} T={T} H={H} parts=2 reverse "
        f"({kernel_plan('fwd', B_TRAIN, H, 2).rows} rows a cluster): h, gates, c",
        list(lstm_fwd_train_gates(*fargs)), list(lstm_fwd_train_gates(*fargs)),
        [h_g, gates_g, c_g], TRAIN_FWD_TOL, relative=False))
    del h_g, gates_g, c_g
    m = median_ms({"plain": lambda: lstm_fwd_train_gates_plain(*fargs),
                   "kernel": lambda: lstm_fwd_train_gates(*fargs)}, rounds=1)
    train_ms["lstm_fwd_train_gates"] = (m["kernel"], m["plain"])
    print(f"lstm_fwd_train_gates B={B_TRAIN} T={T} H={H} parts=2: kernel {m['kernel']:.3f} ms, "
          f"plain {m['plain']:.3f} ms [{smi}]")
    m = median_ms({"plain": lambda: lstm_bwd_v2_plain(*v2_args),
                   "kernel": lambda: lstm_bwd_v2(*v2_args),
                   "kernel 3": lambda: lstm_bwd(*bargs)}, rounds=1)
    train_ms["lstm_bwd_v2"] = (m["kernel"], m["plain"])
    print(f"lstm_bwd_v2 B={B_TRAIN} T={T} H={H} parts=2 dx_add: kernel {m['kernel']:.3f} ms, "
          f"plain {m['plain']:.3f} ms, kernel 3 (lstm_bwd) on the same work "
          f"{m['kernel 3']:.3f} ms [{smi}]")
    del v2_args
    pf, pb = params["lstm"][1]["fwd"], params["lstm"][1]["bwd"]
    xd2 = tuple(select_dropout(x, m_, keep_mid) for x, m_ in zip(xs2, ms2))
    h_f, res_f = lstm_fwd_train_plain(xd2, pf["w_ih"], pf["b"], pf["w_hh"], False)
    h_r, res_r = lstm_fwd_train_plain(xd2, pb["w_ih"], pb["b"], pb["w_hh"], True)
    g_r = 0.1 * randn(B_TRAIN, T, H)
    dd_args = (res_f, h_f, g2, res_r, h_r, g_r, xd2, (pf["w_ih"], pf["w_hh"]),
               (pb["w_ih"], pb["w_hh"]), keep_mid, True)
    work["lstm_bwd_dualdir"] = (nbytes(dd_args, lstm_bwd_dualdir(*dd_args)), 2 * bwd_flops,
                                "bf16")
    # kernel 4 on the plan the "dualdir" micro-step launches: against its twin,
    # and, without dropout, against two kernel 3 launches bit for bit
    dd_plan = kernel_plan("bwd_dualdir", B_TRAIN, H).rows
    flat = lambda out: list(out[0]) + list(out[1]) + list(out[2])  # noqa: E731
    dd_err = max(dd_err, hold_at_main_shape(
        f"lstm_bwd_dualdir B={B_TRAIN} T={T} H={H} parts=2 mask_from_x ({dd_plan} rows a "
        f"cluster): dx, dW_ih, dW_hh, db of both directions", flat(lstm_bwd_dualdir(*dd_args)),
        flat(lstm_bwd_dualdir(*dd_args)), flat(lstm_bwd_dualdir_plain(*dd_args)), BWD_REL_TOL,
        relative=True))
    h_f0, res_f0 = lstm_fwd_train_plain(xs2, pf["w_ih"], pf["b"], pf["w_hh"], False)
    h_r0, res_r0 = lstm_fwd_train_plain(xs2, pb["w_ih"], pb["b"], pb["w_hh"], True)
    dd0 = (res_f0, h_f0, g2, res_r0, h_r0, g_r, xs2, (pf["w_ih"], pf["w_hh"]),
           (pb["w_ih"], pb["w_hh"]), 1.0, False)
    got = flat(lstm_bwd_dualdir(*dd0))
    dx_f, *gr_f = lstm_bwd(res_f0, h_f0, g2, xs2, pf["w_ih"], pf["w_hh"], False)
    dx_b, *gr_r = lstm_bwd(res_r0, h_r0, g_r, xs2, pb["w_ih"], pb["w_hh"], True, dx_add=dx_f)
    dd_err = max(dd_err, hold_at_main_shape(
        f"lstm_bwd_dualdir B={B_TRAIN} T={T} H={H} parts=2 without dropout ({dd_plan} rows a "
        f"cluster)", got, flat(lstm_bwd_dualdir(*dd0)), flat(lstm_bwd_dualdir_plain(*dd0)),
        BWD_REL_TOL, relative=True))
    k3_same = all(torch.equal(a, b) for a, b in zip(got, flat((dx_b, tuple(gr_f), tuple(gr_r)))))
    print(f"lstm_bwd_dualdir B={B_TRAIN} without dropout ({dd_plan} rows a cluster) equals two "
          f"lstm_bwd launches ({kernel_plan('bwd', B_TRAIN, H).rows} rows a cluster) bit for "
          f"bit: {k3_same}", flush=True)
    require(k3_same, f"lstm_bwd_dualdir at B={B_TRAIN} equals two lstm_bwd launches bit for bit")
    del dd0, got, dx_f, dx_b, gr_f, gr_r, h_f0, res_f0, h_r0, res_r0

    def two_lstm_bwd():
        dx_f = lstm_bwd(res_f, h_f, g2, xd2, pf["w_ih"], pf["w_hh"], False)[0]
        return lstm_bwd(res_r, h_r, g_r, xd2, pb["w_ih"], pb["w_hh"], True, dx_add=dx_f)

    m = median_ms({"plain": lambda: lstm_bwd_dualdir_plain(*dd_args),
                   "kernel": lambda: lstm_bwd_dualdir(*dd_args),
                   "2 x kernel 3": two_lstm_bwd}, rounds=1)
    train_ms["lstm_bwd_dualdir"] = (m["kernel"], m["plain"])
    dd = kernel_plan("bwd_dualdir", B_TRAIN, H)
    chain, products = split_ms(lambda: lstm_bwd_dualdir(*dd_args), 3, "chain_kernel")
    print(f"lstm_bwd_dualdir B={B_TRAIN} T={T} H={H} parts=2 mask_from_x: kernel "
          f"{m['kernel']:.3f} ms, plain {m['plain']:.3f} ms, two kernel 3 launches (lstm_bwd, "
          f"forward then reverse with dx_add) on the same work {m['2 x kernel 3']:.3f} ms; "
          f"plan {dd.rows} rows a cluster, {dd.clusters} clusters of {dd.hc} CTAs on "
          f"{dd.clusters * dd.hc} SMs; device time a launch: chain {chain:.3f} ms, products "
          f"{products:.3f} ms [{smi}]", flush=True)
    del dd_args, res_f, res_r, h_f, h_r

    # phase 16: the bf16 backwards at one long row against their float64 functions,
    # kernels 11 and 12 against their twins; phase 17: the pipeline; phases 18-21:
    # the analysis, ablate, EEGFormer and explore phases on its artifacts
    t_new = time.perf_counter()
    bwd_f64_holds(dev, smi)
    checks = kernel_check_phase(dev, smi)
    with tempfile.TemporaryDirectory(prefix="eegflow_chip_pipeline_") as tmp:
        pipe = pipeline_phase(dev, smi, Path(tmp))
        t_analysis = time.perf_counter()
        analysis = analysis_phase(dev, smi, Path(tmp) / "out", batch_ms["kernel"])
        print(f"phase 18 (the analysis stages): {time.perf_counter() - t_analysis:.1f} s",
              flush=True)
        t_ablation = time.perf_counter()
        abl = ablation_phase(dev, smi, Path(tmp) / "out")
        print(f"phase 19 (the ablate stage): {time.perf_counter() - t_ablation:.1f} s",
              flush=True)
        t_transformer = time.perf_counter()
        tf = transformer_phase(dev, smi, Path(tmp) / "out")
        print(f"phase 20 (the EEGFormer and the snapshots): "
              f"{time.perf_counter() - t_transformer:.1f} s", flush=True)
        t_eda = time.perf_counter()
        eda_phase(dev, smi, Path(tmp))
        print(f"phase 21 (explore, Welch and the baselines' features): "
              f"{time.perf_counter() - t_eda:.1f} s", flush=True)
    work.update(abl["work"])
    work.update(tf["work"])
    apf_ms, apf_plain_ms, apf_err, work["apf_rk4"], apf_chain, apf_de, apf_b2b = apf_at_the_fit(
        dev, pipe["fit_props"], smi)
    work["apf_de"] = apf_de.pop("work")
    work["sos_filtfilt"] = checks["sos_work"]
    print(f"phases 16-21 (kernels 11 and 12, the pipeline, the analysis and ablate stages, "
          f"the EEGFormer and the snapshots, explore and the features): "
          f"{time.perf_counter() - t_new:.1f} s",
          flush=True)

    # phase 22: train --profile, fig10's series, the timer and the registry
    t_profile = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="eegflow_chip_profile_") as tmp:
        profile_phase(dev, smi, Path(tmp))
    print(f"phase 22 (train --profile, fig10's series, Timer and the registry): "
          f"{time.perf_counter() - t_profile:.1f} s", flush=True)
    if importlib.util.find_spec("matplotlib") is None:
        require("matplotlib" not in sys.modules, "no phase imported matplotlib")

    # phase 23: the data mesh, in spawned ranks
    torch.cuda.empty_cache()
    mesh_phase(smi)

    # phase 24: the option res_bf16 (EEGFLOW_RES_BF16=1) of kernels 2, 3, 3b and 4
    t24 = time.perf_counter()
    opt_err = {}  # a mode's counter name -> its largest absolute difference from its twin
    flat3 = lambda out: list(out[0]) + list(out[1]) + list(out[2])  # noqa: E731
    bf = lambda t: t.to(torch.bfloat16)  # noqa: E731

    def hold24(label, name, got, again, want, tol, relative):
        err = hold_at_main_shape(label, [t.float() for t in got], [t.float() for t in again],
                                 [t.float() for t in want], tol, relative)
        opt_err[name] = max(opt_err.get(name, 0.0), err)

    # (a) each mode at B=64 against its twin and a bitwise repeat
    for n_parts, layer, keep in ((1, params["lstm"][0], keep_in),
                                 (2, params["lstm"][1], keep_mid)):
        xs = tuple(torch.tanh(randn(B_CHECK, T, H)) for _ in range(n_parts))
        ms = tuple(keep_masks((B_CHECK, T, H), keep) for _ in range(n_parts))
        for direction, reverse in (("fwd", False), ("bwd", True)):
            p = layer[direction]
            tag = f"parts={n_parts} reverse={reverse} B={B_CHECK} T={T} H={H}"
            fa = (xs, p["w_ih"], p["b"], p["w_hh"], reverse, ms, keep)
            for fwd, plain, name in ((lstm_fwd_train, lstm_fwd_train_plain,
                                      counter("lstm_fwd_train", True)),
                                     (lstm_fwd_train_gates, lstm_fwd_train_gates_plain,
                                      counter("lstm_fwd_train_gates", True))):
                got, again = fwd(*fa, res_bf16=True), fwd(*fa, res_bf16=True)
                want, f32 = plain(*fa, res_bf16=True), fwd(*fa)
                hold24(f"{name} {tag}: h{', c' if len(got) == 3 else ''}", name,
                       [got[0], *got[2:]], [again[0], *again[2:]], [want[0], *want[2:]],
                       TRAIN_FWD_TOL, relative=False)
                hold24(f"{name} {tag}: bf16 residual", name, got[1:2], again[1:2], want[1:2],
                       RES16_TOL, relative=False)
                same = (got[1].dtype == torch.bfloat16
                        and torch.equal(got[1], bf(f32[1]))
                        and all(torch.equal(a, b) for a, b in zip([got[0], *got[2:]],
                                                                  [f32[0], *f32[2:]])))
                print(f"{name} {tag}: the float32 mode's outputs, its residual rounded to bf16 "
                      f"(nearest even), bit for bit: {same}")
                require(same, f"{name}: the float32 mode's residual rounded to bf16")
            # kernels 3 and 3b on bf16 residuals
            g_up = 0.1 * randn(B_CHECK, T, H)
            dx_add = tuple(randn(B_CHECK, T, H) for _ in range(n_parts)) if reverse else None
            h_p, planes = lstm_fwd_train_plain(*fa, res_bf16=True)
            h_g, gates, c_g = lstm_fwd_train_gates_plain(*fa, res_bf16=True)
            for bwd, plain, res, h_in, base in (
                    (lstm_bwd, lstm_bwd_plain, (planes,), h_p, "lstm_bwd"),
                    (lstm_bwd_v2, lstm_bwd_v2_plain, (gates, c_g), h_g, "lstm_bwd_v2")):
                ba = (*res, h_in, g_up, xs, p["w_ih"], p["w_hh"], reverse, ms, keep, dx_add)
                name = counter(base, True)
                hold24(f"{name} {tag} dx_add={dx_add is not None}: dx, dW_ih, dW_hh, db",
                       name, flat_bwd(bwd(*ba)), flat_bwd(bwd(*ba)), flat_bwd(plain(*ba)),
                       BWD_REL_TOL, relative=True)
        # kernel 4 on the bf16 planes of the layer's parts dropped by select dropout
        xd = tuple(select_dropout(x, m, keep) for x, m in zip(xs, ms))
        pf, pb = layer["fwd"], layer["bwd"]
        h_f, res_f = lstm_fwd_train_plain(xd, pf["w_ih"], pf["b"], pf["w_hh"], False,
                                          res_bf16=True)
        h_r, res_r = lstm_fwd_train_plain(xd, pb["w_ih"], pb["b"], pb["w_hh"], True,
                                          res_bf16=True)
        da = (res_f, h_f, 0.1 * randn(B_CHECK, T, H), res_r, h_r, 0.1 * randn(B_CHECK, T, H), xd,
              (pf["w_ih"], pf["w_hh"]), (pb["w_ih"], pb["w_hh"]), keep, True)
        name = counter("lstm_bwd_dualdir", True)
        hold24(f"{name} parts={n_parts} mask_from_x B={B_CHECK} T={T} H={H}: dx, dW_ih, dW_hh, "
               f"db of both directions", name, flat3(lstm_bwd_dualdir(*da)),
               flat3(lstm_bwd_dualdir(*da)), flat3(lstm_bwd_dualdir_plain(*da)), BWD_REL_TOL,
               relative=True)
    del xs, ms, xd, da, h_f, res_f, h_r, res_r

    # (b)-(e) a B=512 micro-step on bf16 residuals under each schedule: kernel
    # path against plain path, then against the float32-residual step (loss,
    # gradients, the step's peak device memory) and timed in turns with it
    opt_counts = Counter()
    for sched in LSTM_BWD_SCHEDULES:
        label = f"lstm_bwd={sched} res_bf16=True"
        kernels.reset_launch_counts()
        loss_k, grads_k = micro_step("kernel", lstm_bwd=sched, res_bf16=True)
        torch.cuda.synchronize()
        step_counts = dict(kernels.launch_counts)
        want_counts = train_step_launches(cfg, sched, res_bf16=True)
        print(f"micro-step {label} B={B_TRAIN}: launches {step_counts}")
        require(step_counts == want_counts,
                f"{label} launches per micro-step: want {want_counts}")
        opt_counts.update(step_counts)
        loss_k2, grads_k2 = micro_step("kernel", lstm_bwd=sched, res_bf16=True)
        loss_p, grads_p = micro_step("plain", lstm_bwd=sched, res_bf16=True)
        torch.cuda.synchronize()
        loss_diff = abs(loss_k.item() - loss_p.item())
        grad_rel = max(rel_err(a, b) for a, b in zip(grads_k, grads_p) if b.abs().max() > 0)
        bitwise = torch.equal(loss_k, loss_k2) and all(torch.equal(a, b)
                                                       for a, b in zip(grads_k, grads_k2))
        print(f"micro-step {label} B={B_TRAIN}: loss kernel {loss_k.item():.6f} plain "
              f"{loss_p.item():.6f} (diff {loss_diff:.3e}, tol {STEP_LOSS_TOL:g}); gradients "
              f"max rel diff {grad_rel:.3e} over {len(leaves)} leaves (tol "
              f"{STEP_GRAD_REL_TOL:g}); second kernel run bitwise identical: {bitwise}")
        require(math.isfinite(loss_k.item()) and loss_diff <= STEP_LOSS_TOL,
                f"{label} micro-step loss within tolerance of the plain path")
        require(grad_rel <= STEP_GRAD_REL_TOL, f"{label} micro-step gradients within tolerance")
        require(bitwise, f"{label} kernel-path gradients bitwise repeatable")
        del grads_k2, grads_p
        # (d) the distance from the float32-residual step on the same masks and params
        loss_32, grads_32 = micro_step("kernel", lstm_bwd=sched)
        torch.cuda.synchronize()
        rels = [rel_err(a, b) for a, b in zip(grads_k, grads_32) if b.abs().max() > 0]
        print(f"micro-step {label} B={B_TRAIN} against the float32-residual step: loss "
              f"{loss_k.item():.8f} vs {loss_32.item():.8f} (equal: "
              f"{torch.equal(loss_k, loss_32)}); gradients relative to each one's largest "
              f"entry: max {max(rels):.3e}, median {statistics.median(rels):.3e} over "
              f"{len(rels)} leaves")
        require(torch.equal(loss_k, loss_32), f"{label}: the forward does not read the residuals")
        del grads_k, grads_32
        # the step's peak device memory above what was allocated before it
        peaks = {}
        for res16 in (False, True):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            micro_step("kernel", lstm_bwd=sched, res_bf16=res16)
            torch.cuda.synchronize()
            peaks[res16] = torch.cuda.max_memory_allocated() - before
        print(f"micro-step lstm_bwd={sched} B={B_TRAIN}: peak device memory above the "
              f"allocations before it {peaks[False]} bytes with float32 residuals, "
              f"{peaks[True]} bytes with bf16 ({peaks[False] - peaks[True]} bytes less) [{smi}]",
              flush=True)
        m = median_ms({sched: lambda: micro_step("kernel", lstm_bwd=sched),
                       label: lambda: micro_step("kernel", lstm_bwd=sched, res_bf16=True)})
        for name in (sched, label):
            print(f"training micro-step {name} B={B_TRAIN} T={T} (kernel path, in turns with "
                  f"the other): median {m[name]:.3f} ms, {B_TRAIN / m[name] * 1e3:.1f} "
                  f"windows/s [{smi}]", flush=True)

    # (e) each mode at B=512 on the micro-step's plans: against its twin and a
    # bitwise repeat, then timed in turns with its float32-residual counterpart
    # and its twin
    hg, gates_m, c_m = lstm_fwd_train_gates_plain(*fargs)
    xd2 = tuple(select_dropout(x, m, keep_mid) for x, m in zip(xs2, ms2))
    pf, pb = params["lstm"][1]["fwd"], params["lstm"][1]["bwd"]
    h_f, res_f = lstm_fwd_train_plain(xd2, pf["w_ih"], pf["b"], pf["w_hh"], False)
    h_r, res_r = lstm_fwd_train_plain(xd2, pb["w_ih"], pb["b"], pb["w_hh"], True)
    g_r = 0.1 * randn(B_TRAIN, T, H)
    m_bwd = (xs2, p1["w_ih"], p1["w_hh"], True, ms2, keep_mid, add2)
    dd = lambda rf, rr: (rf, h_f, g2, rr, h_r, g_r, xd2, (pf["w_ih"], pf["w_hh"]),  # noqa: E731
                         (pb["w_ih"], pb["w_hh"]), keep_mid, True)
    fwd_flops = lstm_flops(B_TRAIN, 2 * H, H)
    v2_args = (gates_m, c_m, hg, g2, *m_bwd)
    # mode -> (kernel, twin, args, keywords, its float32-residual args, operations,
    #          flatten, tolerance, relative)
    flat_list = lambda out: list(out)  # noqa: E731
    modes = {
        counter("lstm_fwd_train", True): (lstm_fwd_train, lstm_fwd_train_plain, fargs,
                                          dict(res_bf16=True), fargs, fwd_flops, flat_list,
                                          RES16_TOL, False),
        counter("lstm_fwd_train_gates", True): (lstm_fwd_train_gates, lstm_fwd_train_gates_plain,
                                                fargs, dict(res_bf16=True), fargs, fwd_flops,
                                                flat_list, RES16_TOL, False),
        counter("lstm_bwd", True): (lstm_bwd, lstm_bwd_plain, (bf(res2), *bargs[1:]), {}, bargs,
                                    bwd_flops, flat_bwd, BWD_REL_TOL, True),
        counter("lstm_bwd_v2", True): (lstm_bwd_v2, lstm_bwd_v2_plain,
                                       (bf(gates_m), *v2_args[1:]), {}, v2_args, bwd_flops,
                                       flat_bwd, BWD_REL_TOL, True),
        counter("lstm_bwd_dualdir", True): (lstm_bwd_dualdir, lstm_bwd_dualdir_plain,
                                            dd(bf(res_f), bf(res_r)), {}, dd(res_f, res_r),
                                            2 * bwd_flops, flat3, BWD_REL_TOL, True),
    }
    for name, (kfn, pfn, args, kw, base_args, flops, flat, tol, relative) in modes.items():
        out = kfn(*args, **kw)
        hold24(f"{name} B={B_TRAIN} T={T} H={H} parts=2 (the micro-step's plan)", name,
               flat(out), flat(kfn(*args, **kw)), flat(pfn(*args, **kw)), tol, relative)
        work[name] = (nbytes(args, kw, out), flops, "bf16")
        del out
        m = median_ms({"plain": lambda: pfn(*args, **kw), "kernel": lambda: kfn(*args, **kw),
                       "float32": lambda: kfn(*base_args)}, rounds=1)
        train_ms[name] = (m["kernel"], m["plain"])
        bound_ms24, bound_by24 = bound(*work[name])
        print(f"{name} B={B_TRAIN} T={T} H={H}: kernel {m['kernel']:.3f} ms, on float32 "
              f"residuals {m['float32']:.3f} ms, plain {m['plain']:.3f} ms, bound "
              f"{bound_ms24:.3f} ms ({bound_by24}) [{smi}]", flush=True)
    del modes, xd2, hg, gates_m, c_m, h_f, res_f, h_r, res_r, v2_args
    print(f"phase 24 (res_bf16): {time.perf_counter() - t24:.1f} s", flush=True)

    # phase 25: the in-kernel Philox dropout (kernel_dropout) of kernels 2, 3 and 3b
    t25 = time.perf_counter()
    philox = philox_phase(dev, smi, params, tparams, cfg, micro_step, randn, work, train_ms)
    opt_err.update(philox["err"])
    print(f"phase 25 (in-kernel Philox dropout): {time.perf_counter() - t25:.1f} s", flush=True)

    # one cuDNN LSTM call per LSTM kernel, at its shape (TF32 off): the forward,
    # or forward + backward minus forward; in bf16 for the bf16 kernels where
    # cuDNN takes it (torch.backends.cudnn.is_acceptable), else in float16
    def library_lstm_ms(batch, dtype, backward=False, train=False, bidirectional=False):
        lstm = torch.nn.LSTM(2 * H, H, batch_first=True, bidirectional=bidirectional).to(
            dev, dtype)
        lstm.flatten_parameters()
        x = torch.randn(batch, T, 2 * H, device=dev, dtype=dtype, generator=lgen)
        x.requires_grad_(backward or train)
        g = torch.randn(batch, T, (2 if bidirectional else 1) * H, device=dev, dtype=dtype,
                        generator=lgen)
        with torch.set_grad_enabled(backward or train):
            fwd_ms = median_ms({"f": lambda: lstm(x)}, rounds=2)["f"]
            if not backward:
                return fwd_ms
            both = median_ms({"fb": lambda: lstm(x)[0].backward(g)}, rounds=2)["fb"]
        return both - fwd_ms

    lgen = torch.Generator(device=dev).manual_seed(SEED + 15)
    lib16 = (torch.bfloat16 if torch.backends.cudnn.is_acceptable(
        torch.zeros(1, device=dev, dtype=torch.bfloat16)) else torch.float16)
    library_ms = {
        "lstm_fwd": library_lstm_ms(BUCKET, lib16),
        "lstm_fwd_train": library_lstm_ms(B_TRAIN, lib16, train=True),
        "lstm_bwd": library_lstm_ms(B_TRAIN, lib16, backward=True),
        "lstm_bwd_dualdir": library_lstm_ms(B_TRAIN, lib16, backward=True, bidirectional=True),
        "lstm_rec_fwd": library_lstm_ms(B_TRAIN, torch.float32),
        "lstm_rec_fwd_train": library_lstm_ms(B_TRAIN, torch.float32, train=True),
        "lstm_rec_bwd": library_lstm_ms(B_TRAIN, torch.float32, backward=True),
        f"lstm_rec_fwd B={BUCKET}": library_lstm_ms(BUCKET, torch.float32),
    }
    library_ms["lstm_fwd_train_gates"] = library_ms["lstm_fwd_train"]
    library_ms["lstm_bwd_v2"] = library_ms["lstm_bwd"]
    # phase 24's and 25's modes: the yardstick of the layer-direction they compute
    for name in opt_err:
        library_ms[name] = library_ms[name.removesuffix("_philox").removesuffix("_res16")]
    print(f"library yardsticks, one cuDNN torch.nn.LSTM call (D={2 * H}, H={H}, T={T}, {lib16} for "
          f"the bf16 kernels, float32 for the float32 ones): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in library_ms.items()) + f" [{smi}]", flush=True)

    def entry(name, source, replaces, launches, err, ms, plain_ms, work_name=None, **extra):
        bytes_moved, flops, dtype = work[work_name or name]
        bound_ms, bound_by = bound(bytes_moved, flops, dtype)
        return {"name": name, "route": "cuda", "source": f"eegflow_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms.get(name),
                "analysis_launches": analysis["launches"].get(name, 0),
                "ablate_launches": abl["launches"].get(name, 0),
                "transformer_launches": tf["launches"].get(name, 0), **extra}

    print(json.dumps({"kernels": [
        entry("lstm_fwd", "lstm_fwd.cu", "eegflow/nn/pallas_lstm.py:430",
              counts.get("lstm_fwd", 0), lstm_err, *kernel_ms["2 parts"]),
        entry("lstm_fwd_train", "lstm_fwd.cu", "eegflow/nn/pallas_lstm.py:430",
              train_counts.get("lstm_fwd_train", 0), train_fwd_err,
              *train_ms["lstm_fwd_train"]),
        entry("lstm_bwd", "lstm_bwd.cu", "eegflow/nn/pallas_lstm.py:754",
              train_counts.get("lstm_bwd", 0), bwd_err, *train_ms["lstm_bwd"]),
        entry("pool_head_fwd", "pool_head_fwd.cu", "eegflow/nn/pallas_attention.py:155",
              counts.get("pool_head_fwd", 0), pool_err, pool_ms, pool_plain_ms),
        entry("pool_head_bwd", "pool_head_bwd.cu", "eegflow/nn/pallas_attention.py:221",
              train_counts.get("pool_head_bwd", 0), pool_bwd_err, *train_ms["pool_head_bwd"]),
        entry("lstm_rec_fwd", "lstm_rec.cu", "eegflow/nn/pallas_lstm.py:146",
              f32_counts.get("lstm_rec_fwd", 0), rec_err, *train_ms["lstm_rec_fwd"]),
        entry("lstm_rec_fwd_train", "lstm_rec.cu", "eegflow/nn/pallas_lstm.py:146",
              f32_counts.get("lstm_rec_fwd_train", 0), rec_err,
              *train_ms["lstm_rec_fwd_train"]),
        entry("lstm_rec_bwd", "lstm_rec.cu", "eegflow/nn/pallas_lstm.py:1551",
              f32_counts.get("lstm_rec_bwd", 0), rec_bwd_err, *train_ms["lstm_rec_bwd"]),
        entry("input_block_fwd", "input_block.cu", "eegflow/nn/pallas_input.py:78",
              train_counts.get("input_block_fwd", 0), in_fwd_err,
              *train_ms["input_block_fwd bf16"], "input_block_fwd bf16"),
        entry("input_block_fwd float32", "input_block.cu", "eegflow/nn/pallas_input.py:78",
              f32_counts.get("input_block_fwd", 0), in_fwd_err32,
              *train_ms["input_block_fwd float32"]),
        entry("pool_head_bwd float32", "pool_head_bwd.cu", "eegflow/nn/pallas_attention.py:221",
              f32_counts.get("pool_head_bwd", 0), pool_bwd_err32,
              *train_ms["pool_head_bwd float32"]),
        entry("input_block_bwd", "input_block.cu", "eegflow/nn/pallas_input.py:117",
              train_counts.get("input_block_bwd", 0), in_bwd_err,
              *train_ms["input_block_bwd bf16"], "input_block_bwd bf16"),
        entry("input_block_bwd float32", "input_block.cu", "eegflow/nn/pallas_input.py:117",
              f32_counts.get("input_block_bwd", 0), in_bwd_err32,
              *train_ms["input_block_bwd float32"]),
        # the wide bf16 classes (phase 19): launches in the hidden-512 ablate run
        entry("pool_head_fwd bf16 wide", "pool_head_fwd.cu", "eegflow/nn/pallas_attention.py:155",
              abl["wide"]["pool_head_fwd"], abl["err"]["pool_head_fwd bf16 wide"],
              *abl["ms"]["pool_head_fwd bf16 wide"]),
        entry("pool_head_bwd bf16 wide", "pool_head_bwd.cu", "eegflow/nn/pallas_attention.py:221",
              abl["wide"]["pool_head_bwd"], abl["err"]["pool_head_bwd bf16 wide"],
              *abl["ms"]["pool_head_bwd bf16 wide"], **abl["plan"]["pool_head_bwd bf16 wide"]),
        entry("input_block_bwd bf16 wide", "input_block.cu", "eegflow/nn/pallas_input.py:117",
              abl["wide"]["input_block_bwd"], abl["err"]["input_block_bwd bf16 wide"],
              *abl["ms"]["input_block_bwd bf16 wide"], **abl["plan"]["input_block_bwd bf16 wide"]),
        entry("input_block_fwd bf16 wide", "input_block.cu", "eegflow/nn/pallas_input.py:78",
              abl["wide"]["input_block_fwd"], abl["err"]["input_block_fwd bf16 wide"],
              *abl["ms"]["input_block_fwd bf16 wide"]),
        # the EEGFormer's one-part pool head (phase 20): launches in its train and explain
        # stages
        entry("pool_head_fwd one part bf16", "pool_head_fwd.cu",
              "eegflow/nn/pallas_attention.py:155", tf["launches"]["pool_head_fwd"],
              tf["err"]["pool_head_fwd one part bf16"],
              *tf["ms"]["pool_head_fwd one part bf16"],
              transformer_launches=tf["launches"]["pool_head_fwd"]),
        entry("pool_head_bwd one part bf16", "pool_head_bwd.cu",
              "eegflow/nn/pallas_attention.py:221", tf["launches"]["pool_head_bwd"],
              tf["err"]["pool_head_bwd one part bf16"],
              *tf["ms"]["pool_head_bwd one part bf16"],
              transformer_launches=tf["launches"]["pool_head_bwd"]),
        entry("pool_head_fwd float32", "pool_head_fwd.cu", "eegflow/nn/pallas_attention.py:155",
              f32_counts.get("pool_head_fwd", 0), pool_err32,
              *train_ms["pool_head_fwd float32"]),
        entry("attention_pool", "pool_head_fwd.cu", "eegflow/nn/pallas_attention.py:28",
              attn_counts.get("attention_pool", 0), apool_err, *apool_ms),
        entry("lstm_fwd_train_gates", "lstm_fwd.cu", "eegflow/nn/pallas_lstm.py:430",
              sched_counts["two_pass"].get("lstm_fwd_train_gates", 0), gates_err,
              *train_ms["lstm_fwd_train_gates"]),
        entry("lstm_bwd_v2", "lstm_bwd_v2.cu", "eegflow/nn/pallas_lstm.py:960",
              sched_counts["two_pass"].get("lstm_bwd_v2", 0), v2_err, *train_ms["lstm_bwd_v2"]),
        entry("lstm_bwd_dualdir", "lstm_bwd_dualdir.cu", "eegflow/nn/pallas_lstm.py:1293",
              sched_counts["dualdir"].get("lstm_bwd_dualdir", 0), dd_err,
              *train_ms["lstm_bwd_dualdir"]),
        # phase 24's modes (res_bf16): launches in its three micro-steps
        *[entry(counter(name, True), source, replaces, opt_counts.get(counter(name, True), 0),
                opt_err[counter(name, True)], *train_ms[counter(name, True)])
          for name, source, replaces in (
              ("lstm_fwd_train", "lstm_fwd.cu", "eegflow/nn/pallas_lstm.py:430"),
              ("lstm_fwd_train_gates", "lstm_fwd.cu", "eegflow/nn/pallas_lstm.py:430"),
              ("lstm_bwd", "lstm_bwd.cu", "eegflow/nn/pallas_lstm.py:754"),
              ("lstm_bwd_v2", "lstm_bwd_v2.cu", "eegflow/nn/pallas_lstm.py:960"),
              ("lstm_bwd_dualdir", "lstm_bwd_dualdir.cu", "eegflow/nn/pallas_lstm.py:1293"))],
        # phase 25's Philox modes (kernel_dropout): launches in its micro-steps, B=512
        # on float32 residuals, B=7,168 on bf16 ones; the in-kernel PRNG masks
        # (_prng_block_masks) of the TPU kernels they replace
        *[entry(counter(name, res16, True), source,
                f"{replaces} (_prng_block_masks eegflow/nn/pallas_lstm.py:395-422)",
                philox["launches"].get(counter(name, res16, True), 0),
                philox["err"][counter(name, res16, True)],
                *train_ms[counter(name, res16, True)])
          for name, source, replaces in (
              ("lstm_fwd_train", "lstm_fwd.cu", "eegflow/nn/pallas_lstm.py:430"),
              ("lstm_fwd_train_gates", "lstm_fwd.cu", "eegflow/nn/pallas_lstm.py:430"),
              ("lstm_bwd", "lstm_bwd.cu", "eegflow/nn/pallas_lstm.py:754"),
              ("lstm_bwd_v2", "lstm_bwd_v2.cu", "eegflow/nn/pallas_lstm.py:960"))
          for res16 in (False, True)],
        # the keep-bit planes of the Philox modes: launches in phase 25's
        # micro-steps, timed at a layer's B=512
        entry("philox_keep_bits", "philox_bits.cu",
              "eegflow/nn/pallas_lstm.py:395-422 (_prng_block_masks, the TPU's in-kernel bits)",
              philox["launches"].get("philox_keep_bits", 0), philox["draw_err"],
              *train_ms["philox_keep_bits"]),
        # kernels of the port with no Pallas counterpart: the lax loops they
        # replace, and the least time of their serial chain
        entry("apf_rk4", "apf_rk4.cu", "eegflow/ode/integrate.py:41-68 (rk4_solve lax.scan + "
              "fori_loop) and eegflow/fit/evolution.py:52-62 (make_fit_loss)",
              pipe["apf_launches"], apf_err, apf_ms, apf_plain_ms,
              chain_bound_ms=apf_chain, back_to_back_ms=apf_b2b),
        # a launch of the DE mode: a chunk of generations (its error that of the
        # whole fit's DE against its twin); its numbers per generation beside,
        # and each timed population's kernel, CTAs and ms a generation
        entry("apf_de", "apf_rk4.cu", "eegflow/fit/evolution.py:83-134 (_de_minimize's "
              "lax.while_loop over generations)", pipe["apf_de_launches"], apf_de.pop("err"),
              apf_de.pop("ms"), apf_de.pop("plain_ms"), **apf_de,
              populations={str(n): {"kernel": plan.kernel, "ctas": plan.ctas,
                                    "ms_per_generation": ms}
                       for n, (ms, plan) in checks["de_timings"].items()}),
        entry("sos_filtfilt", "sos_filter.cu", "eegflow/signal/filters.py:96-138 (_sos_scan "
              "lax.scan, _filtfilt_core)", checks["sos_launches"], checks["sos_err"],
              *checks["sos_ms"], chain_bound_ms=checks["sos_chain_ms"]),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card_name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
