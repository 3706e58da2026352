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
     kernel launch counts, and the probabilities against the plain path;
  6. times predict_batch at the 1024 bucket on the kernel path and the
     plain path (CUDA events), and each kernel against its twin;
  7. the training kernels against their twins at B=64, T=256, H=256:
     lstm_fwd in training mode (masks, residual planes), lstm_bwd and
     pool_head_bwd;
  8. trains through the `train` stage of the CLI (in-process) on a
     synthetic processed_sequences.npz (2048 training windows of 256 x 61,
     2 epochs, full-width ModelConfig, default TrainConfig); checks the
     kernel launches per micro-step, the finite loss, the written artifacts,
     and that the serve loader reads the checkpoint;
  9. one training micro-step at B=512 on the kernel path against the plain
     path from identical params and masks (loss and every gradient), a
     second kernel run bitwise identical; then times the micro-step on both
     paths and each training kernel against its twin at B=512.
The line before the last lists the kernels as JSON; the last line is
{"ok": true, "device": {...}}.
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
B_TRAIN = 512
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
    from eegflow_torch.nn.cuda_attention import (pool_head_bwd, pool_head_bwd_plain,
                                                 pool_head_fused, pool_head_fused_plain)
    from eegflow_torch.nn.cuda_lstm import (lstm_bwd, lstm_bwd_plain, lstm_fwd_fused_proj,
                                            lstm_fwd_fused_proj_plain, lstm_fwd_train,
                                            lstm_fwd_train_plain)
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
    for label, xs, p in (("1 part", x1, p0), ("2 parts", x2, p1)):
        args = (xs, p["w_ih"], p["b"], p["w_hh"], False)
        lstm_fwd_fused_proj(*args)
        ms = cuda_ms(lambda: lstm_fwd_fused_proj(*args), 3)
        plain_ms = cuda_ms(lambda: lstm_fwd_fused_proj_plain(*args), 2)
        kernel_ms[label] = (ms, plain_ms)
        print(f"lstm_fwd B={BUCKET} T={T} H={H} {label}: kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms [{smi}]")
    pargs = (params["lstm_norm"], params["attention"], x2, True, True)
    pool_head_fused(*pargs)
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
    pool_args = (params["lstm_norm"], params["attention"], pool_parts, wts, g_sc, g_ctx, gctx,
                 True, True)
    got = pool_head_bwd(*pool_args)
    want = pool_head_bwd_plain(*pool_args)
    torch.cuda.synchronize()
    names = ("dh", "dW1", "db1", "dw2", "dgamma", "dbeta")
    errs = {"dh": max(rel_err(a, b) for a, b in zip(got[0], want[0]))}
    errs.update({n: rel_err(a, b) for n, a, b in zip(names[1:], got[1:], want[1:])})
    print(f"pool_head_bwd parts=2x{H} K={H} B={B_CHECK} T={T}: "
          + ", ".join(f"{k} rel {v:.3e}" for k, v in errs.items())
          + f" (tol {POOL_BWD_REL_TOL:g})", flush=True)
    require(max(errs.values()) <= POOL_BWD_REL_TOL, f"pool_head_bwd within {POOL_BWD_REL_TOL}")
    pool_bwd_err = max([(a - b).abs().max().item() for a, b in zip(got[0], want[0])]
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
        for name, per_step in (("lstm_fwd_train", 6), ("lstm_bwd", 6), ("pool_head_bwd", 1)):
            require(train_counts.get(name, 0) == per_step * n_micro,
                    f"{name} launched {per_step} times per micro-step")
        require(train_counts.get("pool_head_fwd", 0) == n_micro + n_eval,
                "pool_head_fwd launched once per micro-step and per eval batch")
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

    def micro_step(impl):
        for q in leaves:
            q.grad = None
        logits = classifier_apply(tparams, x9, cfg, compute_dtype=torch.bfloat16,
                                  lstm_impl=impl, train=True, masks=masks9)
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
    train_ms = {}
    for name, kfn, pfn, args in (("lstm_fwd_train", lstm_fwd_train, lstm_fwd_train_plain, fargs),
                                 ("lstm_bwd", lstm_bwd, lstm_bwd_plain, bargs),
                                 ("pool_head_bwd", pool_head_bwd, pool_head_bwd_plain, pargs2)):
        m = median_ms({"plain": lambda: pfn(*args), "kernel": lambda: kfn(*args)}, rounds=1)
        train_ms[name] = (m["kernel"], m["plain"])
        print(f"{name} B={B_TRAIN} T={T} H={H} parts=2: kernel {m['kernel']:.3f} ms, "
              f"plain {m['plain']:.3f} ms [{smi}]", flush=True)

    def entry(name, source, replaces, launches, err, ms, plain_ms):
        return {"name": name, "route": "cuda", "source": f"eegflow_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms}

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
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card_name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
