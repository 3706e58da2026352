"""Profile one training micro-step, or one served batch, on the GPU with
``torch.profiler``.

    python -m eegflow_torch.train.profile [--impl kernel|plain] [--policy bf16|float32]
                                          [--bwd fused|two_pass|dualdir] [--res-bf16]
                                          [--kernel-dropout] [--batch N] [--infer]
                                          [--trace DIR]

Runs the full-width classifier (``ModelConfig()``, B=512, T=256, the bf16
policy or, with ``--policy float32``, ``TrainConfig(bf16=False)``; random
weights and windows from a seed; ``--bwd`` picks the bf16 stack's backward
schedule, ``make_train_step(..., lstm_bwd=...)``, ``--res-bf16`` its
bf16 residuals and ``--kernel-dropout`` its in-kernel Philox dropout, the
key drawn each step in place of the stack's masks; ``--batch`` another
batch than 512) through one forward +
backward + optimizer micro-step after two warm-up steps, and prints the
step's wall time, the share of it in which the device was busy (the union of
the device-side intervals: kernels, copies, memsets), the device time by
kernel name, and the peak device memory the second warm-up step allocated
(``torch.cuda.max_memory_allocated``), or that it does not fit (exit 3).
``--infer`` profiles one ``predict_batch`` of the coupled
model on 1024 windows (the serving bucket) instead, after two warm-ups.
``--trace`` also writes the Chrome trace there. Needs CUDA.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

BATCH, STEPS = 512, 256
BUCKET = 1024


def _kernel_key(name: str) -> str:
    """A kernel's name without its arguments: the port's kernels by name and
    GEMM operand types, PyTorch's own by their template's name."""
    name = re.sub(r"\(anonymous namespace\)::", "", name).removeprefix("void ")
    name = name.split("(")[0]
    if name.startswith("at::native::"):
        name = name.split("<")[0] + "<...>"
    return name[:120]


def _busy_us(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="eegflow_torch.train.profile")
    parser.add_argument("--impl", default="kernel", choices=["kernel", "plain"])
    parser.add_argument("--policy", default="bf16", choices=["bf16", "float32"])
    parser.add_argument("--bwd", default="fused", choices=["fused", "two_pass", "dualdir"])
    parser.add_argument("--res-bf16", action="store_true",
                        help="bf16 residuals in the LSTM kernels (bf16 only)")
    parser.add_argument("--kernel-dropout", action="store_true",
                        help="the LSTM stack's dropout drawn in the kernels from a Philox key "
                             "(bf16, fused or two_pass)")
    parser.add_argument("--batch", type=int, default=BATCH, help="the micro-step's windows")
    parser.add_argument("--infer", action="store_true")
    parser.add_argument("--trace", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile: needs a CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from eegflow_torch.core.config import ModelConfig, TrainConfig
    from eegflow_torch.core.prng import make_generator
    from eegflow_torch.nn.model import classifier_init, draw_dropout_masks
    from eegflow_torch.train.steps import make_optimizer, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = ModelConfig()
    params = classifier_init(cfg, make_generator(0), dev, trainable=True)
    rng = np.random.default_rng(0)
    if args.infer:
        from eegflow_torch.core.config import CouplingConfig
        from eegflow_torch.couple.rollout import CoupledModel, predict_batch
        from eegflow_torch.ode.field import DEFAULT_RATES, rates_to_array

        model = CoupledModel(params=params, model_cfg=cfg,
                             k_base=rates_to_array(DEFAULT_RATES, dev),
                             coupling=CouplingConfig(), lstm_impl=args.impl, device=dev)
        windows = rng.standard_normal((BUCKET, STEPS, cfg.input_size)).astype(np.float32)

        def one_step():
            predict_batch(model, windows, batch_size=BUCKET, lstm_impl=args.impl)
    else:
        train_cfg = TrainConfig(lstm_impl=args.impl, bf16=args.policy == "bf16")
        opt = make_optimizer(list(params.parameters()), train_cfg, updates_per_epoch=1)
        step = make_train_step(cfg, train_cfg, opt, lstm_bwd=args.bwd,
                               res_bf16=args.res_bf16, kernel_dropout=args.kernel_dropout)
        x = torch.from_numpy(rng.standard_normal((args.batch, STEPS, cfg.input_size),
                                                 dtype=np.float32)).to(dev)
        y = torch.from_numpy(rng.integers(0, 2, args.batch)).to(dev)
        gen = torch.Generator(device=dev).manual_seed(0)

        def one_step():
            step(params, x, y, draw_dropout_masks(cfg, args.batch, STEPS, gen, dev,
                                                  kernel_dropout=args.kernel_dropout))

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    what = (f"predict_batch B={BUCKET} T={STEPS} impl={args.impl}" if args.infer else
            f"micro-step B={args.batch} T={STEPS} impl={args.impl} policy={args.policy} "
            f"bwd={args.bwd} res_bf16={args.res_bf16} kernel_dropout={args.kernel_dropout}")
    try:
        one_step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        one_step()
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as err:
        print(f"{what}: does not fit in the card's "
              f"{torch.cuda.get_device_properties(0).total_memory} bytes: {err} [{card}]")
        return 3
    peak = torch.cuda.max_memory_allocated()
    print(f"{what}: peak device memory allocated {peak} bytes = {peak / 2 ** 30:.3f} GiB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.3f} GiB [{card}]")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    intervals = [(e.time_range.start, e.time_range.end) for e in device]
    busy = _busy_us(intervals)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in device:
        row = by_name[_kernel_key(e.name)]
        row[0] += e.time_range.end - e.time_range.start
        row[1] += 1
    total_dev = sum(v[0] for v in by_name.values())
    print(f"{what}: wall "
          f"{wall_us / 1e3:.3f} ms (profiler on), device busy {busy / 1e3:.3f} ms = "
          f"{100 * busy / wall_us:.2f} %, idle {100 * (1 - busy / wall_us):.2f} %, "
          f"{len(device)} device operations, summed device time {total_dev / 1e3:.3f} ms "
          f"[{card}]")
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (us, n) in rows[:20]:
        print(f"  {100 * us / total_dev:6.2f} %  {us / 1e3:9.3f} ms  x{n:<5d} {name}")
    if args.trace:
        Path(args.trace).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(
            str(Path(args.trace) / (f"predict_batch_{args.impl}.json" if args.infer else
                                    f"train_step_{args.impl}_{args.policy}_{args.bwd}.json")))
    print(json.dumps({"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
                      "device_ms": total_dev / 1e3, "ops": len(device), "peak_bytes": peak}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
