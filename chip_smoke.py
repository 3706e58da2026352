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
 16. kernels 11 and 12 against their twins: apf_rk4 (a DE population of 90,
     200 points, 16 substeps) in trajectory mode, loss mode and loss mode
     with tangents, each bitwise repeatable; sos_filtfilt on 61 x 20,000
     samples (bitwise repeatable), and bandpass_filter(method="filtfilt") on a
     61 x 60,000 recording against scipy's float64 filtfilt; their times
     beside their chain bounds;
 17. the pipeline from raw recordings to a served model, every step a CLI
     call on the card in one temporary directory: synth (12 subjects x 120 s
     per task, 61 channels at 500 Hz), preprocess (default fft filter),
     train --epochs 1 (default TrainConfig, bf16 "fused"), fit-ode (default
     ODEConfig: apf_rk4 and nothing else), serve in its own process with a
     --config whose coupling sets strength 0.8 and 30 forecast steps; the
     served answers equal predict_batch at that coupling and differ from the
     default coupling's; prints each stage's time, the windows per split,
     the proportion points, the fit and which of scipy, pandas and sklearn
     import; then times apf_rk4 and its twin at the fit's shape.
The line before the last lists the kernels as JSON, each with its time, its
twin's, its bound on an H100 (bytes over 3.35 TB/s or products over the
dtype's peak, whichever is larger) and the library call's time where there is
one; the last line is {"ok": true, "device": {...}}.
"""

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
# TF32 peak)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "float32": 67e12, "tf32x3": 495e12 / 3}
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
# step of kernel 11 (per stage max, the field's mul-fma-add, and the axpy
# to the next stage's point: 3 x 5, then stage 4's field: 4, then the sum's
# last add and the update: 2) and one sample of one section of kernel 12 (the
# delay line's loop-carried cycle: fma, mul, fma, add); FP32 latency on
# Hopper, cycles
APF_CHAIN_OPS_PER_STEP = 21
SOS_CHAIN_OPS_PER_SAMPLE = 4
FP32_LATENCY_CYCLES = 4
# float32 operations a kernel does, for its roofline bound: one RK4 step of
# one candidate (4 fields of 3 max + 3 x (mul + 2 fma), 3 axpys, the
# weighted sum and the update: 111, an FMA as 2) and one section-sample of
# kernel 12 (3 fma, 2 mul, 1 add: 9)
APF_FLOPS_PER_STEP = 111
SOS_FLOPS_PER_SECTION_SAMPLE = 9


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


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
          f"{clock[0]:.0f} MHz) [{smi}]", flush=True)
    out["sos_work"] = (nbytes(x_rec, got), SOS_ROWS * 2 * (SOS_SAMPLES + 2 * padlen)
                       * len(sos) * SOS_FLOPS_PER_SECTION_SAMPLE, "float32")
    return out


def apf_at_the_fit(dev, props, smi):
    """Kernel 11 at the shapes the fit-ode stage gave it, held to its twin
    and timed: the DE's loss over a population of 90 on the pipeline's
    proportion series, and the polish's loss and gradient of one candidate
    through the fit loss's autograd. -> (kernel ms, plain ms, largest abs
    difference, (bytes, flops, dtype), chain bound ms)."""
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
    clock = sm_clock_mhz()
    steps = (pts - 1) * cfg.rk4_substeps
    chain = chain_ms(steps * APF_CHAIN_OPS_PER_STEP, clock[1])
    print(f"apf_rk4 at the fit: B={n} {shape} ({steps} serial steps): kernel "
          f"{m['kernel']:.3f} ms, plain twin {m['plain']:.1f} ms; chain bound {chain:.3f} ms at "
          f"the {clock[1]:.0f} MHz max SM clock (read {clock[0]:.0f} MHz) [{smi}]", flush=True)
    work = (nbytes(k, loss.observed, loss.y0) + 4 * n, n * steps * APF_FLOPS_PER_STEP,
            "float32")
    return m["kernel"], m["plain"], err, work, chain


def pipeline_phase(dev, smi):
    """Phase 17: synth -> preprocess -> train -> fit-ode -> serve --config,
    every step a CLI call on the card in one temporary directory, nothing
    written by hand. -> launches, times and the fit's proportions."""
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
    with tempfile.TemporaryDirectory(prefix="eegflow_chip_pipeline_") as tmp:
        tmp = Path(tmp)
        base = ["--data-dir", str(tmp / "data"), "--output-dir", str(tmp / "out")]

        def stage(name, argv, config=None):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            rc = cli_main((["--config", str(config)] if config else []) + argv)
            torch.cuda.synchronize()
            times[name] = time.perf_counter() - t0
            counts = dict(kernels.launch_counts)
            require(rc == 0, f"{name} stage returned 0")
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
        require(out["apf_launches"] > 0 and set(counts) == {"apf_rk4"},
                "fit-ode runs kernel 11 and nothing else")
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
        cmd = [sys.executable, "-m", "eegflow_torch.cli.main", "--output-dir", str(tmp / "out"),
               "--config", str(tmp / "serve.json"), "serve", "--port", "0", "--device", dev.type]
        t0 = time.perf_counter()
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
        finally:
            proc.send_signal(signal.SIGINT)
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=60)
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
    from eegflow_torch.nn.cuda_lstm import (kernel_plan, lstm_bwd, lstm_bwd_dualdir,
                                            lstm_bwd_dualdir_plain,
                                            lstm_bwd_plain, lstm_bwd_v2, lstm_bwd_v2_plain,
                                            lstm_fwd_fused_proj, lstm_fwd_fused_proj_plain,
                                            lstm_fwd_train, lstm_fwd_train_gates,
                                            lstm_fwd_train_gates_plain, lstm_fwd_train_plain,
                                            lstm_recurrence, lstm_recurrence_backward,
                                            lstm_recurrence_backward_plain,
                                            lstm_recurrence_plain, select_dropout)
    from eegflow_torch.nn.losses import cross_entropy_loss
    from eegflow_torch.nn.model import classifier_apply, classifier_init, draw_dropout_masks
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

    def micro_step(impl, compute_dtype=torch.bfloat16, lstm_bwd="fused"):
        for q in leaves:
            q.grad = None
        logits = classifier_apply(tparams, x9, cfg, compute_dtype=compute_dtype,
                                  lstm_impl=impl, train=True, masks=masks9, lstm_bwd=lstm_bwd)
        loss = cross_entropy_loss(logits, y9, cw)
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
    for sched, fwd_name, bwd_name, n_bwd in (("two_pass", "lstm_fwd_train_gates",
                                              "lstm_bwd_v2", 6),
                                             ("dualdir", "lstm_fwd_train", "lstm_bwd_dualdir",
                                              3)):
        kernels.reset_launch_counts()
        loss_k, grads_k = micro_step("kernel", lstm_bwd=sched)
        torch.cuda.synchronize()
        sched_counts[sched] = dict(kernels.launch_counts)
        loss_k2, grads_k2 = micro_step("kernel", lstm_bwd=sched)
        loss_p, grads_p = micro_step("plain", lstm_bwd=sched)
        torch.cuda.synchronize()
        want_counts = {"input_block_fwd": 1, "input_block_bwd": 1, fwd_name: 6,
                       bwd_name: n_bwd, "pool_head_fwd": 1, "pool_head_bwd": 1}
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
    print(f"lstm_bwd_dualdir B={B_TRAIN} T={T} H={H} parts=2 mask_from_x: kernel "
          f"{m['kernel']:.3f} ms, plain {m['plain']:.3f} ms, two kernel 3 launches (lstm_bwd, "
          f"forward then reverse with dx_add) on the same work {m['2 x kernel 3']:.3f} ms "
          f"[{smi}]", flush=True)
    del dd_args, res_f, res_r, h_f, h_r

    # phase 16: kernels 11 and 12 against their twins; phase 17: the pipeline
    t_new = time.perf_counter()
    checks = kernel_check_phase(dev, smi)
    pipe = pipeline_phase(dev, smi)
    apf_ms, apf_plain_ms, apf_err, work["apf_rk4"], apf_chain = apf_at_the_fit(
        dev, pipe["fit_props"], smi)
    work["sos_filtfilt"] = checks["sos_work"]
    print(f"phases 16-17 (kernels 11 and 12, the pipeline): {time.perf_counter() - t_new:.1f} s",
          flush=True)

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
    print(f"library yardsticks, one cuDNN torch.nn.LSTM call (D={2 * H}, H={H}, T={T}, {lib16} for "
          f"the bf16 kernels, float32 for the float32 ones): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in library_ms.items()) + f" [{smi}]", flush=True)

    def entry(name, source, replaces, launches, err, ms, plain_ms, work_name=None, **extra):
        bytes_moved, flops, dtype = work[work_name or name]
        bound_ms, bound_by = bound(bytes_moved, flops, dtype)
        return {"name": name, "route": "cuda", "source": f"eegflow_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms.get(name), **extra}

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
        # kernels of the port with no Pallas counterpart: the lax loops they
        # replace, and the least time of their serial chain
        entry("apf_rk4", "apf_rk4.cu", "eegflow/ode/integrate.py:41-68 (rk4_solve lax.scan + "
              "fori_loop) and eegflow/fit/evolution.py:52-62 (make_fit_loss)",
              pipe["apf_launches"], apf_err, apf_ms, apf_plain_ms,
              chain_bound_ms=apf_chain),
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
