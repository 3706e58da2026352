#!/usr/bin/env python3
"""Smoke test of eegflow_torch on one NVIDIA GPU (Hopper, sm_90a).

Run from the root of the repository:  python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and exits non-zero:
  1. the card (nvidia-smi name and power limit); requires CUDA;
  2. builds the CUDA kernels from eegflow_torch/csrc with nvcc;
  3. lstm_fwd against its plain twin at B=64, T=256, H=256, one and two
     input parts, both directions;
  4. pool_head_fwd against its plain twin: two parts of 256, K=256, T=256;
  5. serves a full-width coupled model (61 -> 256, 3 bidirectional layers,
     T=256, random weights from a seed) over HTTP on 127.0.0.1: /health and
     three /predict requests of 1, 7 and 33 windows; checks the answers, the
     kernel launch counts (1 input_block_fwd, 6 lstm_fwd, 1 pool_head_fwd per
     batch), and the probabilities against the plain path;
  6. times predict_batch at the 1024 bucket on the kernel path and the
     plain path (CUDA events), and each kernel against its twin;
  7. the bf16 training kernels against their twins at B=64, T=256, H=256:
     lstm_fwd in training mode (masks, residual planes), lstm_bwd, and
     pool_head_bwd in its bf16 and float32 modes;
  8. trains through the `train` stage of the CLI (in-process) on a
     synthetic processed_sequences.npz (2048 training windows of 256 x 61,
     2 epochs, full-width ModelConfig, default TrainConfig: bf16); checks the
     kernel launches per micro-step (1 input_block_fwd, 1 input_block_bwd,
     6 lstm_fwd_train, 6 lstm_bwd, 1 pool_head_fwd, 1 pool_head_bwd) and per
     eval batch, the finite loss, the written artifacts, and that the serve
     loader reads the checkpoint;
  9. one bf16 training micro-step at B=512 on the kernel path against the
     plain path from identical params and masks (loss and every gradient), a
     second kernel run bitwise identical; then times the micro-step on both
     paths and each training kernel against its twin at B=512;
 10. the float32 policy's kernels against their twins: lstm_rec_fwd (eval and
     training mode) and lstm_rec_bwd at B=64, T=256, H=256 on the gates of
     one- and two-part inputs, both directions; input_block_fwd and
     input_block_bwd in both modes; attention_pool at D=256;
 11. attention_pool through its entry point, attention_pool_apply, at B=512,
     T=256, D=256 (no classifier path calls it), against its twin;
 12. the `train` stage with --config {"train": {"bf16": false}} for 1 epoch on
     a synthetic set: launches per micro-step (1 input_block_fwd,
     1 input_block_bwd, 6 lstm_rec_fwd_train, 6 lstm_rec_bwd, 1 pool_head_fwd,
     1 pool_head_bwd) and per eval batch (6 lstm_rec_fwd), the serve loader on
     its checkpoint, and coupled_rollout(bf16=False) on it, kernel path
     against plain path;
 13. one float32 micro-step at B=512, kernel path against plain path (loss,
     every gradient, bitwise repeat), timed on both paths, and each float32
     kernel (and the input block in both modes) timed against its twin;
 14. the kernels of the two other bf16 backward schedules against their
     twins at B=64, T=256, H=256, one and two parts: lstm_fwd_train_gates
     (h, gates, c; both directions), lstm_bwd_v2 on the same residuals (masks,
     dx_add, bitwise repeat), lstm_bwd_dualdir with and without mask_from_x
     (bitwise repeat) and, without dropout, against two lstm_bwd launches;
 15. one bf16 micro-step at B=512 under lstm_bwd="two_pass" and under
     "dualdir", kernel path against plain path (loss, every gradient, bitwise
     repeat, exact launch counts), each timed in turns against "fused", and
     lstm_bwd_v2 and lstm_bwd_dualdir timed at B=512 against their twins and
     against kernel 3 on the same work; then one cuDNN LSTM call per LSTM
     kernel at its shape as a yardstick (never on the port's path).
The line before the last lists the kernels as JSON, each with its time, its
twin's, its bound on an H100 (bytes over 3.35 TB/s or products over the
dtype's peak, whichever is larger) and the library call's time where there is
one; the last line is {"ok": true, "device": {...}}.
"""

import json
import math
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
# the float32 micro-step, kernel path vs plain path: summation order only
STEP32_LOSS_TOL = 1e-4
STEP32_GRAD_REL_TOL = 1e-3
N_TRAIN32_EPOCHS = 1
B_TRAIN = 512
# the least time of a kernel's work on an H100 SXM (NVIDIA's data sheet, dense):
# HBM bytes per second, and products per second by operand type (bf16 on the
# tensor cores; float32 outside them, since TF32 is off)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "float32": 67e12}
N_TRAIN_WINDOWS = 2048
TRAIN_EPOCHS = 2


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
    rate and the products' operations over the peak rate of ``dtype``."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
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
    from eegflow_torch.nn.cuda_input import (input_block_bwd, input_block_bwd_plain,
                                             input_block_fused, input_block_fused_plain)
    from eegflow_torch.nn.cuda_lstm import (lstm_bwd, lstm_bwd_dualdir, lstm_bwd_dualdir_plain,
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
            want = lstm_fwd_fused_proj_plain(xs, p["w_ih"], p["b"], p["w_hh"], reverse)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(got).all()), "lstm_fwd output finite")
            err = (got - want).abs().max().item()
            print(f"lstm_fwd parts={n_parts} reverse={reverse} B={B_CHECK} T={T} H={H}: "
                  f"max_abs_diff {err:.3e} (tol {LSTM_TOL:g})")
            require(err <= LSTM_TOL, f"lstm_fwd within {LSTM_TOL} of its twin")
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
        if label == "2 parts":
            work["lstm_fwd"] = (nbytes(args, out), lstm_flops(BUCKET, 2 * H, H), "bf16")
        ms = cuda_ms(lambda: lstm_fwd_fused_proj(*args), 3)
        plain_ms = cuda_ms(lambda: lstm_fwd_fused_proj_plain(*args), 2)
        kernel_ms[label] = (ms, plain_ms)
        print(f"lstm_fwd B={BUCKET} T={T} H={H} {label}: kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms [{smi}]")
    pargs = (params["lstm_norm"], params["attention"], x2, True, True)
    work["pool_head_fwd"] = (nbytes(pargs, pool_head_fused(*pargs)), 2 * BUCKET * T * 2 * H * H,
                             "bf16")
    pool_ms = cuda_ms(lambda: pool_head_fused(*pargs), 5)
    pool_plain_ms = cuda_ms(lambda: pool_head_fused_plain(*pargs), 5)
    print(f"pool_head_fwd B={BUCKET} T={T} parts=2x{H} K={H}: kernel {pool_ms:.3f} ms, "
          f"plain {pool_plain_ms:.3f} ms [{smi}]")

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
            h_p, res_p = lstm_fwd_train_plain(xs, p["w_ih"], p["b"], p["w_hh"], reverse, ms,
                                              keep)
            torch.cuda.synchronize()
            err = max((h_k - h_p).abs().max().item(), (res_k - res_p).abs().max().item())
            print(f"lstm_fwd train parts={n_parts} reverse={reverse} B={B_CHECK} T={T} H={H}: "
                  f"h and planes max_abs_diff {err:.3e} (tol {TRAIN_FWD_TOL:g})")
            require(bool(torch.isfinite(res_k).all()) and err <= TRAIN_FWD_TOL,
                    f"lstm_fwd training mode within {TRAIN_FWD_TOL} of its twin")
            train_fwd_err = max(train_fwd_err, err)
            g_up = 0.1 * randn(B_CHECK, T, H)
            dx_add = tuple(randn(B_CHECK, T, H) for _ in range(n_parts)) if reverse else None
            got = lstm_bwd(res_p, h_p, g_up, xs, p["w_ih"], p["w_hh"], reverse, ms, keep,
                           dx_add)
            want = lstm_bwd_plain(res_p, h_p, g_up, xs, p["w_ih"], p["w_hh"], reverse, ms,
                                  keep, dx_add)
            torch.cuda.synchronize()
            errs = {"dx": max(rel_err(a, b) for a, b in zip(got[0], want[0])),
                    "dW_ih": rel_err(got[1], want[1]), "dW_hh": rel_err(got[2], want[2]),
                    "db": rel_err(got[3], want[3])}
            print(f"lstm_bwd parts={n_parts} reverse={reverse} dx_add={dx_add is not None}: "
                  + ", ".join(f"{k} rel {v:.3e}" for k, v in errs.items())
                  + f" (tol {BWD_REL_TOL:g})")
            require(max(errs.values()) <= BWD_REL_TOL, f"lstm_bwd within {BWD_REL_TOL}")
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
    head_flops = 3 * 2 * B_TRAIN * T * 2 * H * H  # projection, dW1, dh
    train_ms = {}
    for name, kfn, pfn, args, flops in (
            ("lstm_fwd_train", lstm_fwd_train, lstm_fwd_train_plain, fargs,
             lstm_flops(B_TRAIN, 2 * H, H)),
            ("lstm_bwd", lstm_bwd, lstm_bwd_plain, bargs, bwd_flops),
            ("pool_head_bwd", pool_head_bwd, pool_head_bwd_plain, pargs2, head_flops)):
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
            h_k, c_k = lstm_recurrence(gates, p["w_hh"], reverse, True)
            h_p, c_p = lstm_recurrence_plain(gates, p["w_hh"], reverse, True)
            torch.cuda.synchronize()
            err = max((h_e - h_p).abs().max().item(), (h_k - h_p).abs().max().item(),
                      (c_k - c_p).abs().max().item())
            print(f"lstm_rec_fwd parts={n_parts} reverse={reverse} B={B_CHECK} T={T} H={H}: "
                  f"h (eval, training) and c max_abs_diff {err:.3e} (tol {REC_TOL:g})")
            require(bool(torch.isfinite(h_k).all()) and err <= REC_TOL,
                    f"lstm_rec_fwd within {REC_TOL} of its twin")
            rec_err = max(rec_err, err)
            g_up = 0.1 * randn(B_CHECK, T, H)
            got = lstm_recurrence_backward(gates, h_p, c_p, p["w_hh"], g_up, reverse)
            again = lstm_recurrence_backward(gates, h_p, c_p, p["w_hh"], g_up, reverse)
            want = lstm_recurrence_backward_plain(gates, h_p, c_p, p["w_hh"], g_up, reverse)
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
    in_fwd_err = in_bwd_err = 0.0
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
        in_fwd_err = max(in_fwd_err, err)
        in_bwd_err = max(in_bwd_err, *[(a - b).abs().max().item() for a, b in zip(got, want)])
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
                              2 * B_TRAIN * T * H * (H // 2), "float32")
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
                           "kernel": lambda: micro_step("kernel", None)})
    for impl in ("kernel", "plain"):
        print(f"float32 training micro-step (forward + backward) B={B_TRAIN} T={T} "
              f"lstm_impl={impl}: median {step32_ms[impl]:.3f} ms, "
              f"{B_TRAIN / step32_ms[impl] * 1e3:.1f} windows/s [{smi}]")

    gates2 = torch.cat(xs2, dim=-1) @ p1["w_ih"] + p1["b"]
    h32, c32 = lstm_recurrence_plain(gates2, p1["w_hh"], True, True)
    x512 = randn(B_TRAIN, T, C)
    dy512 = randn(B_TRAIN, T, H)
    ib = (params["input_proj"], params["input_norm"])
    pargs32 = pargs2[:-1] + (False,)
    rec_flops = 2 * B_TRAIN * T * H * 4 * H  # one h . W_hh per step, float32
    in_flops = 2 * B_TRAIN * T * C * H  # x . W of the input block
    timed = (
        ("lstm_rec_fwd", lstm_recurrence, lstm_recurrence_plain, (gates2, p1["w_hh"], True),
         rec_flops, "float32"),
        ("lstm_rec_fwd_train", lstm_recurrence, lstm_recurrence_plain,
         (gates2, p1["w_hh"], True, True), rec_flops, "float32"),
        # z recomputed, dh_carry, and dW_hh
        ("lstm_rec_bwd", lstm_recurrence_backward, lstm_recurrence_backward_plain,
         (gates2, h32, c32, p1["w_hh"], g2, True), 3 * rec_flops, "float32"),
        ("input_block_fwd bf16", input_block_fused, input_block_fused_plain, (*ib, x512, True),
         in_flops, "bf16"),
        # the recomputed forward, dW and dx
        ("input_block_bwd bf16", input_block_bwd, input_block_bwd_plain,
         (*ib, x512, dy512, True), 3 * in_flops, "bf16"),
        ("input_block_fwd float32", input_block_fused, input_block_fused_plain,
         (*ib, x512, False), in_flops, "float32"),
        ("input_block_bwd float32", input_block_bwd, input_block_bwd_plain,
         (*ib, x512, dy512, False), 3 * in_flops, "float32"),
        ("pool_head_bwd float32", pool_head_bwd, pool_head_bwd_plain, pargs32, head_flops,
         "float32"))
    for name, kfn, pfn, args, flops, dtype in timed:
        work[name] = (nbytes(args, kfn(*args)), flops, dtype)
        m = median_ms({"plain": lambda: pfn(*args), "kernel": lambda: kfn(*args)}, rounds=1)
        train_ms[name] = (m["kernel"], m["plain"])
        print(f"{name} B={B_TRAIN} T={T} H={H}: kernel {m['kernel']:.3f} ms, "
              f"plain {m['plain']:.3f} ms [{smi}]", flush=True)

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
            h_p, gates_p, c_p = lstm_fwd_train_gates_plain(*fwd_args)
            torch.cuda.synchronize()
            err = max((a - b).abs().max().item() for a, b in zip(got, (h_p, gates_p, c_p)))
            print(f"lstm_fwd_train_gates parts={n_parts} reverse={reverse} B={B_CHECK} T={T} "
                  f"H={H}: h, gates and c max_abs_diff {err:.3e} (tol {TRAIN_FWD_TOL:g})")
            require(all(bool(torch.isfinite(t).all()) for t in got) and err <= TRAIN_FWD_TOL,
                    f"lstm_fwd_train_gates within {TRAIN_FWD_TOL} of its twin")
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
    }
    library_ms["lstm_fwd_train_gates"] = library_ms["lstm_fwd_train"]
    library_ms["lstm_bwd_v2"] = library_ms["lstm_bwd"]
    print(f"library yardsticks, one cuDNN torch.nn.LSTM call (D={2 * H}, H={H}, T={T}, {lib16} for "
          f"the bf16 kernels, float32 for the float32 ones): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in library_ms.items()) + f" [{smi}]", flush=True)

    def entry(name, source, replaces, launches, err, ms, plain_ms, work_name=None):
        bytes_moved, flops, dtype = work[work_name or name]
        bound_ms, bound_by = bound(bytes_moved, flops, dtype)
        return {"name": name, "route": "cuda", "source": f"eegflow_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms.get(name)}

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
        entry("input_block_bwd", "input_block.cu", "eegflow/nn/pallas_input.py:117",
              train_counts.get("input_block_bwd", 0), in_bwd_err,
              *train_ms["input_block_bwd bf16"], "input_block_bwd bf16"),
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
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card_name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
