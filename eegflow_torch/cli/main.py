"""eegflow_torch CLI: the ``train`` and ``serve`` subcommands.

``train`` reads ``processed_data/processed_sequences.npz`` under
``--output-dir`` (the JAX package's preprocess stage writes it), trains the
BiLSTM-attention classifier, evaluates it on the test split with attention,
and writes the JAX package's artifacts: ``models/lstm_attention``
(``checkpoint.json`` + ``params.msgpack``), ``results/lstm_results.json`` and
``models/attention_weights.npy``:

    python -m eegflow_torch.cli.main --output-dir outputs train --device cuda

``--config`` reads the ``model`` and ``train`` sections of a
``PipelineConfig`` JSON. The training figures of the JAX package's stage
(``plot_training_history``, ``plot_attention_weights``) are not drawn: the
plotting module is not ported.

``serve`` loads the classifier checkpoint and the fitted rates in
``results/ode_results.json`` and serves the coupled model over HTTP:

    python -m eegflow_torch.cli.main --output-dir outputs serve --port 8799 --device cuda

``--device cuda`` without a usable GPU raises; it never carries on on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from eegflow_torch.convert import params_from_jax
from eegflow_torch.core.artifacts import (load_checkpoint, load_processed, load_results,
                                          save_checkpoint, save_results)
from eegflow_torch.core.config import CouplingConfig, ModelConfig, TrainConfig
from eegflow_torch.couple.rollout import CoupledModel
from eegflow_torch.ode.field import rates_to_array

#: window length of the warmup batch (the preprocessing's sequence length)
WINDOW_LEN = 256


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    return device


def load_coupled_model(output_dir: str | Path, device: torch.device) -> CoupledModel:
    """The counterpart of ``eegflow.cli.main._load_coupled_model``."""
    out = Path(output_dir)
    params, model_cfg, _, _ = load_checkpoint(out / "models" / "lstm_attention")
    ode_results = load_results(out / "results" / "ode_results.json")
    return CoupledModel(
        params=params_from_jax(params, device), model_cfg=model_cfg,
        k_base=rates_to_array(ode_results["fitted_params"], device),
        coupling=CouplingConfig(), device=device)


def load_configs(path: Optional[str]) -> Tuple[ModelConfig, TrainConfig]:
    """The ``model`` and ``train`` sections of a ``PipelineConfig`` JSON
    (defaults for what it leaves out, or without a file)."""
    data = json.loads(Path(path).read_text()) if path else {}
    return ModelConfig(**data.get("model", {})), TrainConfig(**data.get("train", {}))


def apply_small_subject_reg(train_cfg: TrainConfig, n_train_subj: Optional[int]) -> TrainConfig:
    """``eegflow.cli.main.apply_small_subject_reg``: below 12 training
    subjects add mixup + channel-dropout copies, below 20 add x2 fresh
    phase-surrogate copies, unless ``auto_small_subject_reg`` is off."""
    if not train_cfg.auto_small_subject_reg or n_train_subj is None:
        return train_cfg
    if (n_train_subj < 12 and not train_cfg.aug_mixup
            and train_cfg.aug_channel_dropout == 0.0):
        train_cfg = dataclasses.replace(train_cfg, aug_mixup=True, aug_channel_dropout=0.1)
        print(f"{n_train_subj} training subjects < 12: enabling mixup + "
              "channel-dropout regularizers")
    if n_train_subj < 20 and train_cfg.aug_phase_surrogates == 0:
        train_cfg = dataclasses.replace(train_cfg, aug_phase_surrogates=2,
                                        aug_fresh_surrogates=True)
        print(f"{n_train_subj} training subjects < 20: enabling x2 fresh "
              "phase-surrogate copies")
    return train_cfg


def cmd_train(args) -> None:
    from eegflow_torch.analyze.evaluate import evaluate_model
    from eegflow_torch.train.data import augment_data, make_surrogate_refresher
    from eegflow_torch.train.loop import train_classifier
    from eegflow_torch.train.steps import make_eval_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = resolve_device(args.device)
    model_cfg, train_cfg = load_configs(args.config)
    out = Path(args.output_dir)
    models, results = out / "models", out / "results"
    models.mkdir(parents=True, exist_ok=True)
    results.mkdir(parents=True, exist_ok=True)
    arrays, meta = load_processed(out / "processed_data" / "processed_sequences.npz")
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    x_train, y_train = arrays["X_train"], arrays["y_train"]
    x_val, y_val = arrays["X_val"], arrays["y_val"]
    if len(y_val) == 0:  # carve 15% from train, as the reference does
        n_val = max(1, int(0.15 * len(y_train)))
        x_val, y_val = x_train[-n_val:], y_train[-n_val:]
        x_train, y_train = x_train[:-n_val], y_train[:-n_val]
    if args.epochs:
        train_cfg = dataclasses.replace(train_cfg, epochs=args.epochs)
    model_cfg = dataclasses.replace(model_cfg, input_size=x_train.shape[2])
    n_train_subj = len((meta or {}).get("splits", {}).get("train", {})
                       .get("subjects", [])) or None
    train_cfg = apply_small_subject_reg(train_cfg, n_train_subj)

    epoch_transform = None
    if train_cfg.augment:
        rng = np.random.default_rng(train_cfg.seed)
        n_orig = len(x_train)
        x_train, y_train = augment_data(x_train, y_train, rng, train_cfg.noise_std,
                                        train_cfg.max_shift, mixup=train_cfg.aug_mixup,
                                        channel_dropout=train_cfg.aug_channel_dropout,
                                        phase_surrogates=train_cfg.aug_phase_surrogates)
        print(f"augmented train set: {x_train.shape}")
        if train_cfg.aug_fresh_surrogates and train_cfg.aug_phase_surrogates:
            epoch_transform = make_surrogate_refresher(
                n_orig, train_cfg.aug_phase_surrogates, train_cfg.seed)
            print("per-epoch fresh surrogate refresh enabled")

    res = train_classifier(x_train, y_train, x_val, y_val, model_cfg, train_cfg,
                           device=device, epoch_transform=epoch_transform)
    print(f"best val F1 {res.best_val_f1:.4f} in {res.epochs_run} epochs "
          f"({res.wall_time_s:.0f}s, {res.windows_per_sec:.0f} windows/s) on {device}")

    params = params_from_jax(res.params, device)
    eval_attn = make_eval_step(model_cfg, bf16=train_cfg.bf16, return_attention=True,
                               lstm_impl=train_cfg.lstm_impl)
    probs_list, attn_list = [], []
    x_test = arrays["X_test"]
    for i in range(0, len(x_test), train_cfg.eval_batch_size):
        xb = torch.from_numpy(np.ascontiguousarray(x_test[i: i + train_cfg.eval_batch_size],
                                                   np.float32)).to(device)
        p, a = eval_attn(params, xb)
        probs_list.append(p.cpu().numpy())
        attn_list.append(a.cpu().numpy())
    probs = np.concatenate(probs_list) if probs_list else np.empty((0, 2))
    attention = np.concatenate(attn_list) if attn_list else np.empty((0, 1))
    y_test = arrays["y_test"]
    evaluation = evaluate_model(y_test, probs.argmax(1), probs[:, 1], "lstm_attention")
    print(f"test acc={evaluation['accuracy']:.4f} f1={evaluation['f1']:.4f} "
          f"auc={evaluation.get('auc', float('nan')):.4f}")

    save_checkpoint(models / "lstm_attention", res.params, model_cfg, history=res.history,
                    extra={"best_val_f1": res.best_val_f1,
                           "windows_per_sec": res.windows_per_sec})
    save_results(results / "lstm_results.json", evaluation)
    np.save(models / "attention_weights.npy", attention)


def cmd_serve(args) -> None:
    from eegflow_torch.cli.serve import serve

    # float32 matmuls outside the kernels (dense layers, the ODE) stay float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = load_coupled_model(args.output_dir, resolve_device(args.device))
    httpd = serve(model, host=args.host, port=args.port,
                  warmup_seq_len=WINDOW_LEN)
    print(f"serving coupled LSTM-ODE model on http://{args.host}:{args.port} "
          f"(POST /predict, GET /health) on {model.device}", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="eegflow_torch")
    parser.add_argument("--output-dir", default="outputs")
    parser.add_argument("--config", default=None, help="PipelineConfig JSON file")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("train", help="train the BiLSTM-attention classifier")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_train)
    p = sub.add_parser("serve", help="serve the coupled model over HTTP")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8799)
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_serve)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
