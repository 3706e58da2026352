"""Training loop (``eegflow.train.loop``): weighted sampling, training steps
on a device-resident training set, validation every epoch, early stopping
with best-weight restore, the history dict and windows/s.

One device, no mesh, no mid-run snapshots (``checkpoint_dir`` /
``resume_from`` of the reference are not ported).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from eegflow_torch.analyze.evaluate import f1_binary, matthews_corrcoef
from eegflow_torch.convert import params_to_jax
from eegflow_torch.core.config import ModelConfig, TrainConfig
from eegflow_torch.core.prng import make_generator
from eegflow_torch.nn.model import classifier_init, draw_dropout_masks
from eegflow_torch.train.data import class_weight_array, weighted_epoch_indices
from eegflow_torch.train.schedule import lr_trace
from eegflow_torch.train.steps import make_eval_step, make_optimizer, make_train_step


@dataclass
class TrainResult:
    params: Any                 # numpy pytree of the best epoch (classifier_init's structure)
    history: Dict[str, list]
    best_val_f1: float          # the best value of the selection metric, as the reference names it
    epochs_run: int
    wall_time_s: float
    windows_per_sec: float = 0.0


def predict_probs(params: Any, x: Union[np.ndarray, torch.Tensor], model_cfg: ModelConfig,
                  batch_size: int = 1024, bf16: bool = True, eval_step=None,
                  lstm_impl: str = "auto") -> np.ndarray:
    """Batched inference -> (N, num_classes) probabilities on the host.
    ``params`` is a torch parameter tree; ``x`` may already lie on its
    device, otherwise each batch is copied there."""
    device = next(iter(params.parameters())).device
    step = eval_step or make_eval_step(model_cfg, bf16=bf16, lstm_impl=lstm_impl)
    out = []
    for i in range(0, len(x), batch_size):
        xb = x[i: i + batch_size]
        xb = xb if isinstance(xb, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(xb))
        out.append(step(params, xb.to(device)).cpu().numpy())
    return np.concatenate(out) if out else np.empty((0, model_cfg.num_classes), np.float32)


def train_classifier(x_train: np.ndarray, y_train: np.ndarray, x_val: np.ndarray,
                     y_val: np.ndarray, model_cfg: ModelConfig, train_cfg: TrainConfig,
                     device: Union[torch.device, str] = "cpu", verbose: bool = True,
                     epoch_transform: Optional[Callable] = None) -> TrainResult:
    """Full training run -> best params + history.

    Weights come from ``classifier_init`` with a generator seeded by
    ``train_cfg.seed``; dropout masks from a generator on ``device`` seeded
    by the same seed. Epoch e samples its batches with
    ``np.random.default_rng(seed * 1_000_003 + e)``, as the reference does.
    The training set is copied to the device once and each batch is gathered
    there. ``epoch_transform``: ``(x_train_dev, epoch) -> x_train_dev`` at the
    start of every epoch (e.g. :func:`~eegflow_torch.train.data.make_surrogate_refresher`).
    Two runs with the same arguments on the same device give the same bits.
    """
    t_start = time.time()
    device = torch.device(device)
    params = classifier_init(model_cfg, make_generator(train_cfg.seed), device, trainable=True)
    batches_per_epoch = max(1, len(y_train) // train_cfg.batch_size)
    updates_per_epoch = max(1, batches_per_epoch // max(train_cfg.accumulation_steps, 1))
    optimizer = make_optimizer(list(params.parameters()), train_cfg, updates_per_epoch)
    cw = torch.from_numpy(class_weight_array(y_train, model_cfg.num_classes)).to(device)
    step = make_train_step(model_cfg, train_cfg, optimizer, class_weights=cw)
    eval_step = make_eval_step(model_cfg, bf16=train_cfg.bf16, lstm_impl=train_cfg.lstm_impl)
    drop_gen = torch.Generator(device=device)
    drop_gen.manual_seed(int(train_cfg.seed))

    history: Dict[str, list] = {
        "train_loss": [], "val_loss": [], "train_acc": [], "val_acc": [],
        "val_f1": [], "learning_rates": [], "epoch_time_s": [],
    }
    lrs = lr_trace(train_cfg.learning_rate, train_cfg.epochs, train_cfg.warmup_epochs)
    # -inf, not 0: MCC ranges to -1, and with a 0 floor a run whose val MCC
    # never exceeds 0 would return the untrained init weights
    best_score = float("-inf")
    best_params = params_to_jax(params)
    no_improve = 0
    epochs_run = 0
    total_windows = 0
    step_time = 0.0

    x_train_dev = torch.from_numpy(np.ascontiguousarray(x_train, np.float32)).to(device)
    y_train_dev = torch.from_numpy(np.asarray(y_train, np.int64)).to(device)
    x_val_dev = torch.from_numpy(np.ascontiguousarray(x_val, np.float32)).to(device)
    steps = x_train.shape[1]
    bs = train_cfg.batch_size

    for epoch in range(train_cfg.epochs):
        ep_start = time.time()
        if epoch_transform is not None:
            x_train_dev = epoch_transform(x_train_dev, epoch)
        rng = np.random.default_rng(train_cfg.seed * 1_000_003 + epoch)
        if train_cfg.weighted_sampling:
            indices = weighted_epoch_indices(y_train, rng)
        else:
            indices = rng.permutation(len(y_train))

        batch_metrics = []
        ep_count = 0
        t_steps = time.time()
        for b_idx in range(len(indices) // bs):
            sel = torch.from_numpy(indices[b_idx * bs: (b_idx + 1) * bs]).to(device)
            xb = x_train_dev.index_select(0, sel)
            yb = y_train_dev.index_select(0, sel)
            masks = draw_dropout_masks(model_cfg, bs, steps, drop_gen, device)
            metrics = step(params, xb, yb, masks)
            batch_metrics.append((metrics, bs))
            ep_count += bs
            total_windows += bs
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_time += time.time() - t_steps
        ep_loss = sum(float(m["loss"]) * n for m, n in batch_metrics)
        ep_correct = sum(int(m["correct"]) for m, n in batch_metrics)

        val_probs = predict_probs(params, x_val_dev, model_cfg, train_cfg.eval_batch_size,
                                  train_cfg.bf16, eval_step)
        val_pred = val_probs.argmax(axis=1)
        val_f1 = f1_binary(y_val, val_pred)
        val_acc = float((val_pred == y_val).mean()) if len(y_val) else 0.0
        val_loss = float(-np.log(np.clip(val_probs[np.arange(len(y_val)), y_val], 1e-12, 1))
                         .mean()) if len(y_val) else 0.0

        epoch_time = time.time() - ep_start
        history["train_loss"].append(ep_loss / max(ep_count, 1))
        history["val_loss"].append(val_loss)
        history["train_acc"].append(ep_correct / max(ep_count, 1))
        history["val_acc"].append(val_acc)
        history["val_f1"].append(val_f1)
        history["learning_rates"].append(float(lrs[epoch]))
        history["epoch_time_s"].append(epoch_time)
        epochs_run = epoch + 1

        if verbose and ((epoch + 1) % 5 == 0 or epoch == 0
                        or epoch == train_cfg.warmup_epochs - 1):
            print(f"Epoch [{epoch + 1:3d}/{train_cfg.epochs}] | "
                  f"Loss: {history['train_loss'][-1]:.4f}/{val_loss:.4f} | "
                  f"Acc: {history['train_acc'][-1]:.4f}/{val_acc:.4f} | "
                  f"F1: {val_f1:.4f} | LR: {lrs[epoch]:.2e} | Time: {epoch_time:.1f}s",
                  flush=True)

        # early stopping on val MCC (default) or val F1 (the reference's)
        if train_cfg.selection_metric == "mcc":
            val_sel = matthews_corrcoef(y_val, val_pred) if len(y_val) else 0.0
        else:
            val_sel = val_f1
        if val_sel > best_score:
            best_score = val_sel
            best_params = params_to_jax(params)
            no_improve = 0
        else:
            no_improve += 1
        if no_improve >= train_cfg.patience:
            if verbose:
                print(f"Early stopping at epoch {epoch + 1} "
                      f"(no improvement for {train_cfg.patience} epochs)", flush=True)
            break

    wall = time.time() - t_start
    return TrainResult(params=best_params, history=history,
                       best_val_f1=best_score if np.isfinite(best_score) else 0.0,
                       epochs_run=epochs_run, wall_time_s=wall,
                       windows_per_sec=total_windows / step_time if step_time > 0 else 0.0)
