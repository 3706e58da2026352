"""Training loop (``eegflow.train.loop``): weighted sampling, training steps
on a device-resident training set, validation every epoch, early stopping
with best-weight restore, the history dict and windows/s, and the
reference's crash-recovery snapshots (``checkpoint_dir``,
``checkpoint_every``, ``resume_from``) in its format, so either package
resumes the other's. ``mesh=`` (:mod:`eegflow_torch.train.mesh`) shares a
batch out over the ranks of a data mesh.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from eegflow_torch.analyze.evaluate import f1_binary, matthews_corrcoef
from eegflow_torch.convert import params_to_jax
from eegflow_torch.core.artifacts import (load_checkpoint, load_train_state, save_checkpoint,
                                          save_train_state)
from eegflow_torch.core.config import ModelConfig, TrainConfig
from eegflow_torch.core.prng import make_generator
from eegflow_torch.nn.model import classifier_init, draw_dropout_masks
from eegflow_torch.train.data import class_weight_array, weighted_epoch_indices
from eegflow_torch.train.mesh import (DataMesh, all_gather_rows, make_spmd_eval_step,
                                      replicate_to_mesh, shard_batch)
from eegflow_torch.train.schedule import lr_trace
from eegflow_torch.train.steps import (leaf_at, load_optimizer_state_dict, make_eval_step,
                                       make_optimizer, make_train_step, optimizer_state_dict)

#: added to the per-epoch seed of the dropout-mask generator, which keeps its
#: seeds apart from those of the surrogate refresher (``train.data``)
MASK_SEED_OFFSET = 2 ** 31


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
                  lstm_impl: str = "auto", mesh: Optional[DataMesh] = None) -> np.ndarray:
    """Batched inference -> (N, num_classes) probabilities on the host.
    ``params`` is a torch parameter tree; ``x`` may already lie on its
    device, otherwise each batch is copied there.

    ``mesh``: ``params`` are the same on every rank, on its device.
    ``batch_size`` is rounded up to a multiple of the world size, as the
    JAX package rounds it; each batch, zero-padded to a multiple of the
    world size, is sharded, each rank evaluates its rows and the shards are
    gathered in rank order, so every rank returns the whole array."""
    device = next(iter(params.parameters())).device
    if mesh is None:
        step = eval_step or make_eval_step(model_cfg, bf16=bf16, lstm_impl=lstm_impl)
    else:
        step = eval_step or make_spmd_eval_step(model_cfg, mesh, bf16=bf16,
                                                lstm_impl=lstm_impl)
        batch_size += (-batch_size) % mesh.world_size
    out = []
    for i in range(0, len(x), batch_size):
        xb = x[i: i + batch_size]
        xb = xb if isinstance(xb, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(xb))
        if mesh is None:
            out.append(step(params, xb.to(device)).cpu().numpy())
            continue
        k = len(xb)
        pad = (-k) % mesh.world_size
        if pad:
            xb = torch.cat([xb, xb.new_zeros((pad,) + tuple(xb.shape[1:]))])
        probs = all_gather_rows(step(params, shard_batch(xb, mesh)), mesh)
        out.append(probs[:k].cpu().numpy())
    return np.concatenate(out) if out else np.empty((0, model_cfg.num_classes), np.float32)


def restore_train_state(path: Union[str, Path], params, optimizer) -> bool:
    """Load the ``train_state.msgpack`` of the snapshot directory ``path``
    (either package's) into ``params`` (a torch parameter tree) and
    ``optimizer`` (:func:`~eegflow_torch.train.steps.make_optimizer`'s, over
    ``params.parameters()``) in place. -> False when there is none."""
    snapshot = load_train_state(path)
    if snapshot is None:
        return False
    snap_params, snap_opt = snapshot
    names = [n for n, _ in params.named_parameters()]
    with torch.no_grad():
        for name, p in params.named_parameters():
            p.copy_(torch.from_numpy(leaf_at(snap_params, name)))
    load_optimizer_state_dict(optimizer, names, snap_opt)
    return True


def train_classifier(x_train: np.ndarray, y_train: np.ndarray, x_val: np.ndarray,
                     y_val: np.ndarray, model_cfg: ModelConfig, train_cfg: TrainConfig,
                     device: Union[torch.device, str] = "cuda", verbose: bool = True,
                     checkpoint_dir: Optional[Union[str, Path]] = None,
                     checkpoint_every: int = 10,
                     resume_from: Optional[Union[str, Path]] = None,
                     epoch_transform: Optional[Callable] = None,
                     mesh: Optional[DataMesh] = None) -> TrainResult:
    """Full training run -> best params + history (either model family).

    Weights come from ``classifier_init`` with a generator seeded by
    ``train_cfg.seed``. Epoch e samples its batches with
    ``np.random.default_rng(seed * 1_000_003 + e)``, as the reference does,
    and draws its dropout masks from a generator on ``device`` seeded with
    ``seed * 1_000_003 + e + MASK_SEED_OFFSET``, a function of (seed, e)
    alone, so a resumed run draws the same masks. The training set is
    copied to the device once and each batch is gathered there.
    ``epoch_transform``: ``(x_train_dev, epoch) -> x_train_dev`` at the
    start of every epoch (e.g.
    :func:`~eegflow_torch.train.data.make_surrogate_refresher`). Two runs
    with the same arguments on the same device give the same bits.

    ``checkpoint_dir``: every ``checkpoint_every`` epochs, a snapshot there
    (``eegflow.train.loop``'s format): the best params so far with the
    history and ``extra = {epoch, best_val_f1, selection_metric, step,
    resumable}``, written before that epoch's early-stopping update, and
    ``train_state.msgpack`` with the current params and optimizer state.
    ``resume_from``: such a directory (of either package); without a
    ``train_state.msgpack`` the run starts afresh. A resumed run cuts the
    history to the snapshot's epoch, restores the best score only when its
    ``selection_metric`` matches, takes the best params from
    ``params.msgpack`` and restarts the patience count, as the reference
    does; interrupted after an epoch and resumed, it ends with the
    uninterrupted run's train state.

    ``mesh`` (:class:`~eegflow_torch.train.mesh.DataMesh`; ``device`` is
    then the mesh's): every rank holds the training set on its device,
    draws the same epoch order and the whole batch's dropout masks, and
    takes its rows of each; the step is
    :func:`~eegflow_torch.train.steps.make_train_step` with the mesh, the
    single-device function of the whole batch, so a mesh run is the run
    without one up to the order of the sums. The JAX package takes its
    explicit ``shard_map`` step on a TPU mesh, whose per-shard weighted
    means are another function under class weights, because its implicit
    sharded step cannot reach the Pallas kernels; each rank of the port
    runs the kernels on its own shard either way, so the port keeps the
    implicit step's function on every device. Every rank validates the
    whole validation set, as the JAX package validates unsharded, so every
    rank makes the same early-stopping decisions. Rank 0 alone prints and
    writes the snapshots; every rank resumes from the same one. An
    ``epoch_transform`` with a mesh raises ``ValueError``, as the JAX
    package's does.
    """
    t_start = time.time()
    if mesh is not None and epoch_transform is not None:
        raise ValueError("epoch_transform needs the single-device training path (mesh=None)")
    device = mesh.device if mesh is not None else torch.device(device)
    writer = mesh is None or mesh.rank == 0
    verbose = verbose and writer
    params = classifier_init(model_cfg, make_generator(train_cfg.seed), device, trainable=True)
    if mesh is not None:
        replicate_to_mesh(params, mesh)
    names = [n for n, _ in params.named_parameters()]
    batches_per_epoch = max(1, len(y_train) // train_cfg.batch_size)
    updates_per_epoch = max(1, batches_per_epoch // max(train_cfg.accumulation_steps, 1))
    optimizer = make_optimizer(list(params.parameters()), train_cfg, updates_per_epoch)

    start_epoch, n_steps, resume_payload = 0, 0, None
    if resume_from is not None:
        ckpt_best_params, _, resume_history, extra = load_checkpoint(resume_from)
        if restore_train_state(resume_from, params, optimizer):
            n_steps = int(extra.get("step", 0))
            start_epoch = int(extra.get("epoch", 0))
            resume_payload = (resume_history, extra, ckpt_best_params)

    cw = torch.from_numpy(class_weight_array(y_train, model_cfg.num_classes)).to(device)
    step = make_train_step(model_cfg, train_cfg, optimizer, class_weights=cw, mesh=mesh)
    eval_step = make_eval_step(model_cfg, bf16=train_cfg.bf16, lstm_impl=train_cfg.lstm_impl)
    drop_gen = torch.Generator(device=device)

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

    if resume_payload is not None:
        resume_history, extra, ckpt_best_params = resume_payload
        for k in history:
            history[k] = list(resume_history.get(k, []))[:start_epoch]
        # the stored best is comparable only under the same selection metric
        if extra.get("selection_metric") == train_cfg.selection_metric:
            best_score = float(extra.get("best_val_f1", float("-inf")))
        # params.msgpack holds the best params so far (the train state the
        # current ones)
        best_params = ckpt_best_params
        epochs_run = start_epoch

    x_train_dev = torch.from_numpy(np.ascontiguousarray(x_train, np.float32)).to(device)
    y_train_dev = torch.from_numpy(np.asarray(y_train, np.int64)).to(device)
    x_val_dev = torch.from_numpy(np.ascontiguousarray(x_val, np.float32)).to(device)
    steps = x_train.shape[1]
    bs = train_cfg.batch_size

    for epoch in range(start_epoch, train_cfg.epochs):
        ep_start = time.time()
        if epoch_transform is not None:
            x_train_dev = epoch_transform(x_train_dev, epoch)
        rng = np.random.default_rng(train_cfg.seed * 1_000_003 + epoch)
        if train_cfg.weighted_sampling:
            indices = weighted_epoch_indices(y_train, rng)
        else:
            indices = rng.permutation(len(y_train))
        drop_gen.manual_seed(train_cfg.seed * 1_000_003 + epoch + MASK_SEED_OFFSET)

        batch_metrics = []
        ep_count = 0
        t_steps = time.time()
        for b_idx in range(len(indices) // bs):
            sel = indices[b_idx * bs: (b_idx + 1) * bs]
            sel = (torch.from_numpy(sel).to(device) if mesh is None
                   else shard_batch(sel, mesh))
            xb = x_train_dev.index_select(0, sel)
            yb = y_train_dev.index_select(0, sel)
            masks = draw_dropout_masks(model_cfg, bs, steps, drop_gen, device)
            if mesh is not None:
                masks = shard_batch(masks, mesh)
            metrics = step(params, xb, yb, masks)
            batch_metrics.append((metrics, bs))
            ep_count += bs
            total_windows += bs
            n_steps += 1
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

        # the snapshot: the best params as of the previous epochs, then the
        # current train state
        if writer and checkpoint_dir is not None and (epoch + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint_dir, best_params, model_cfg, history=history,
                            extra={"epoch": epoch + 1, "best_val_f1": best_score,
                                   "selection_metric": train_cfg.selection_metric,
                                   "step": n_steps, "resumable": True})
            save_train_state(checkpoint_dir, params, optimizer_state_dict(optimizer, names))

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
