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
     plain path (CUDA events), and each kernel against its twin.
The last line is {"ok": true, "device": {...}}.
"""

import json
import math
import statistics
import subprocess
import sys
import threading
import time
from http.client import HTTPConnection

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
    from eegflow_torch.nn.cuda_attention import pool_head_fused, pool_head_fused_plain
    from eegflow_torch.nn.cuda_lstm import lstm_fwd_fused_proj, lstm_fwd_fused_proj_plain
    from eegflow_torch.nn.model import classifier_init
    from eegflow_torch.ode.field import DEFAULT_RATES, rates_to_array

    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name} "
          f"count {torch.cuda.device_count()}", flush=True)
    # float32 matmuls outside the kernels stay float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build
    t0 = time.perf_counter()
    kernels.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s, {kernels.build_info.get('library')}")
    if "command" in kernels.build_info:
        print("build command: " + " ".join(kernels.build_info["command"]))
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
    times = {"kernel": [], "plain": []}
    for impl in ("kernel", "plain"):  # warmup
        predict_batch(model, x_big, batch_size=BUCKET, lstm_impl=impl)
    for _ in range(3):
        for impl in ("plain", "kernel", "kernel", "plain"):
            times[impl].append(cuda_ms(
                lambda: predict_batch(model, x_big, batch_size=BUCKET, lstm_impl=impl), 1))
    for impl in ("kernel", "plain"):
        med = statistics.median(times[impl])
        print(f"predict_batch B={BUCKET} T={T} lstm_impl={impl}: median {med:.3f} ms/batch, "
              f"{BUCKET / med * 1e3:.1f} samples/s over {len(times[impl])} runs "
              f"[{smi}]")

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

    print(json.dumps({"kernels": [
        {"name": "lstm_fwd", "route": "cuda", "source": "eegflow_torch/csrc/lstm_fwd.cu",
         "replaces": "eegflow/nn/pallas_lstm.py:430", "launches": counts.get("lstm_fwd", 0),
         "max_abs_err": lstm_err, "ms": kernel_ms["2 parts"][0],
         "plain_ms": kernel_ms["2 parts"][1]},
        {"name": "pool_head_fwd", "route": "cuda",
         "source": "eegflow_torch/csrc/pool_head_fwd.cu",
         "replaces": "eegflow/nn/pallas_attention.py:155",
         "launches": counts.get("pool_head_fwd", 0), "max_abs_err": pool_err,
         "ms": pool_ms, "plain_ms": pool_plain_ms},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
