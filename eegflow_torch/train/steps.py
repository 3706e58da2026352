"""Train and eval steps (``eegflow.train.steps``).

The reference chains ``optax.clip_by_global_norm`` and ``optax.adamw``
inside ``optax.MultiSteps``. :class:`AdamW` is that chain written out over a
list of parameters, with optax's arithmetic in optax's order:

* every micro-step folds its gradient into a running mean,
  ``acc + (g - acc) / (n + 1)``; the parameters stay as they are;
* every ``every_k``-th micro-step the mean is clipped to global norm
  ``max_norm`` (``g / norm * max_norm`` when the norm is not below it), and
  AdamW applies it: b1 0.9, b2 0.999, eps 1e-8 outside the square root,
  bias corrections ``1 - b**count`` in float32, weight decay added to the
  update on EVERY parameter (no mask), then the update scaled by
  ``-schedule(k)`` for the k-th update (0-based) and added.

A parameter without a gradient (the attention score bias: softmax ignores
it) takes a zero gradient, so its moments stay 0 and weight decay still
shrinks it, as optax does. ``torch.optim.AdamW`` would skip such a
parameter.

With ``max_norm=None``, ``every_k=1`` and a constant learning rate in place
of the schedule it is plain ``optax.adamw(lr)``, as the ablation stage's
quick training runs it (``eegflow.analyze.ablation.quick_train_evaluate``).

:func:`optimizer_state_dict` and :func:`load_optimizer_state_dict` carry
the state of :func:`make_optimizer`'s chain to and from optax's state-dict
layout (flax's ``to_state_dict`` of ``tx.init(params)``), which the
snapshots' ``train_state.msgpack`` holds:

    every_k > 1 (optax.MultiSteps):
      {mini_step, gradient_step,
       inner_opt_state: {"0": {} (clip),
                         "1": {"0": {count, mu, nu} (scale_by_adam),
                               "1": {} (add_decayed_weights),
                               "2": {count} (scale_by_schedule)}},
       acc_grads, skip_state: {}}
    every_k == 1: the inner_opt_state dict alone

``mu``, ``nu`` and ``acc_grads`` are parameter trees (lists as ``{"0": ...}``
maps) and the counters 0-d int32 arrays: ``count`` (updates applied) is
both ``count``s and ``gradient_step``, ``mini_step`` the micro-steps folded
into ``acc_grads`` since the last update.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from eegflow_torch.core.config import ModelConfig, TrainConfig, TransformerConfig
from eegflow_torch.nn.cuda_lstm import check_lstm_bwd
from eegflow_torch.nn.losses import cross_entropy_loss
from eegflow_torch.nn.model import DropoutMasks, classifier_apply
from eegflow_torch.train.mesh import DataMesh, all_reduce_sum, reduce_gradients
from eegflow_torch.train.schedule import warmup_cosine_schedule


class AdamW:
    """``MultiSteps(chain(clip_by_global_norm, adamw), every_k)`` over
    ``params`` (see the module docstring). ``schedule`` maps the update's
    index to its learning rate, or is the learning rate itself;
    ``max_norm=None`` leaves out the clipping."""

    def __init__(self, params: Sequence[torch.Tensor],
                 schedule: Union[Callable[[int], float], float], weight_decay: float = 1e-4,
                 max_norm: Optional[float] = 1.0, every_k: int = 1, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.schedule = schedule if callable(schedule) else (lambda _: float(schedule))
        self.weight_decay, self.max_norm, self.every_k = weight_decay, max_norm, every_k
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = [torch.zeros_like(p) for p in self.params]
        self.mini_step = 0   # micro-steps folded into acc since the last update
        self.count = 0       # updates applied

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> bool:
        """Fold the parameters' ``.grad`` (None counts as zeros) into the
        running mean; apply an update on every ``every_k``-th call. Returns
        whether the parameters changed."""
        n = self.mini_step
        for p, acc in zip(self.params, self.acc):
            if p.grad is None:
                acc.sub_(acc / (n + 1))
            else:
                acc.add_((p.grad - acc) / (n + 1))
        self.mini_step += 1
        if self.mini_step < self.every_k:
            return False
        self.mini_step = 0
        if self.max_norm is not None:
            norm = torch.sqrt(sum(torch.sum(a * a) for a in self.acc))
            keep = norm < self.max_norm  # on the device: no host sync
        self.count += 1
        f32 = torch.float32
        dev = self.params[0].device
        bc1 = 1 - torch.tensor(self.b1, dtype=f32, device=dev) ** self.count
        bc2 = 1 - torch.tensor(self.b2, dtype=f32, device=dev) ** self.count
        step_size = torch.tensor(-self.schedule(self.count - 1), dtype=f32, device=dev)
        for p, acc, mu, nu in zip(self.params, self.acc, self.mu, self.nu):
            g = acc if self.max_norm is None else torch.where(keep, acc,
                                                              (acc / norm) * self.max_norm)
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            upd = upd + self.weight_decay * p
            p.add_(upd * step_size)
            acc.zero_()
        return True


def _tree_of(names: Sequence[str], tensors: Sequence[torch.Tensor]) -> Dict[str, Any]:
    """Host copies of ``tensors`` as a nested dict in flax's state-dict form:
    ``names`` are their dotted paths (``blocks.0.mha.query.w``), so a list
    index becomes a ``"0"`` key."""
    tree: Dict[str, Any] = {}
    for name, t in zip(names, tensors):
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.detach().cpu().numpy().copy()
    return tree


def leaf_at(tree: Dict[str, Any], name: str) -> np.ndarray:
    """The leaf of a state-dict tree at the dotted path ``name``."""
    for key in name.split("."):
        tree = tree[key]
    return np.asarray(tree)


def _int32(n: int) -> np.ndarray:
    return np.asarray(n, np.int32)


def optimizer_state_dict(optimizer: AdamW, names: Sequence[str]) -> Dict[str, Any]:
    """``optimizer``'s state in optax's state-dict layout (module docstring)
    for the optimizer :func:`make_optimizer` builds; ``names`` are the
    dotted paths of ``optimizer.params``, in order."""
    inner = {"0": {},
             "1": {"0": {"count": _int32(optimizer.count), "mu": _tree_of(names, optimizer.mu),
                         "nu": _tree_of(names, optimizer.nu)},
                   "1": {},
                   "2": {"count": _int32(optimizer.count)}}}
    if optimizer.every_k == 1:
        return inner
    return {"mini_step": _int32(optimizer.mini_step),
            "gradient_step": _int32(optimizer.count),
            "inner_opt_state": inner,
            "acc_grads": _tree_of(names, optimizer.acc),
            "skip_state": {}}


@torch.no_grad()
def load_optimizer_state_dict(optimizer: AdamW, names: Sequence[str],
                              state: Dict[str, Any]) -> None:
    """Restore ``optimizer`` in place from optax's state-dict layout (as
    :func:`optimizer_state_dict` writes it, or the JAX package's snapshot)."""
    multi = "inner_opt_state" in state
    if multi != (optimizer.every_k > 1):
        raise ValueError("the snapshot's optimizer state is "
                         f"{'' if multi else 'not '}accumulated (optax.MultiSteps), "
                         f"the optimizer's every_k is {optimizer.every_k}")
    adam = (state["inner_opt_state"] if multi else state)["1"]["0"]
    for name, mu, nu, acc in zip(names, optimizer.mu, optimizer.nu, optimizer.acc):
        mu.copy_(torch.from_numpy(leaf_at(adam["mu"], name)))
        nu.copy_(torch.from_numpy(leaf_at(adam["nu"], name)))
        if multi:
            acc.copy_(torch.from_numpy(leaf_at(state["acc_grads"], name)))
        else:
            acc.zero_()
    optimizer.count = int(adam["count"])
    optimizer.mini_step = int(state["mini_step"]) if multi else 0


def make_optimizer(params: Sequence[torch.Tensor], train_cfg: TrainConfig,
                   updates_per_epoch: int) -> AdamW:
    """The reference's optimizer: clip, AdamW on the warmup-cosine schedule,
    accumulated over ``accumulation_steps`` micro-steps."""
    schedule = warmup_cosine_schedule(train_cfg.learning_rate, train_cfg.epochs,
                                      train_cfg.warmup_epochs, updates_per_epoch)
    return AdamW(params, schedule, weight_decay=train_cfg.weight_decay,
                 max_norm=train_cfg.grad_clip,
                 every_k=max(train_cfg.accumulation_steps, 1))


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig, optimizer: AdamW,
                    class_weights: Optional[torch.Tensor] = None,
                    lstm_impl: Optional[str] = None, *, lstm_bwd: str = "fused",
                    res_bf16: bool = False, mesh: Optional[DataMesh] = None,
                    kernel_dropout: bool = False) -> Callable:
    """``step(params, x, y, masks) -> {"loss", "correct", "count"}``: forward
    in training mode with the dropout ``masks``, weighted cross-entropy,
    backward, optimizer step (the parameters change in place on every
    ``accumulation_steps``-th call). ``loss`` and ``correct`` stay on the
    device. ``lstm_bwd``: the LSTM stack's backward schedule, and
    ``res_bf16`` its bf16 residuals, ``kernel_dropout`` its in-kernel
    Philox dropout with the masks of ``draw_dropout_masks(...,
    kernel_dropout=True)`` (``classifier_apply``; the EEGFormer has none of
    them); not ``TrainConfig`` fields, whose fields stay the JAX package's.

    ``mesh`` (:class:`~eegflow_torch.train.mesh.DataMesh`): ``x``, ``y``
    and ``masks`` are this rank's shard of the batch, and the step computes
    the single-device function of the whole batch, as the JAX package's
    implicit sharded step does: each rank divides its rows' weighted sum by
    the whole batch's weight sum (one all-reduce, from the labels), and the
    gradients are summed over the ranks in one all-reduce before the
    optimizer step. ``loss`` is the whole batch's, ``correct`` and
    ``count`` the mesh's sums. With class weights, at world size 1 it is
    the step without a mesh bit for bit. With ``kernel_dropout`` every rank
    takes the whole batch's Philox key and the step sets the masks'
    ``row_offset`` to the rank's first row (rank x its rows), so the ranks
    draw the one-process step's masks."""
    return _make_step(model_cfg, train_cfg, optimizer, class_weights, lstm_impl, lstm_bwd,
                      mesh, explicit=False, res_bf16=res_bf16, kernel_dropout=kernel_dropout)


def _make_step(model_cfg, train_cfg: TrainConfig, optimizer: AdamW,
               class_weights: Optional[torch.Tensor], lstm_impl: Optional[str], lstm_bwd: str,
               mesh: Optional[DataMesh], explicit: bool, res_bf16: bool = False,
               kernel_dropout: bool = False) -> Callable:
    """The step of :func:`make_train_step` (``explicit=False``) or of
    :func:`~eegflow_torch.train.mesh.make_spmd_train_step` (``explicit``:
    each rank's own weighted mean, the gradients averaged, and with
    ``kernel_dropout`` the Philox rows from 0 on every rank)."""
    compute_dtype = torch.bfloat16 if train_cfg.bf16 else None
    impl = lstm_impl or train_cfg.lstm_impl
    if isinstance(model_cfg, TransformerConfig):
        if kernel_dropout:
            raise ValueError("kernel_dropout is the LSTM stack's; the EEGFormer has none")
    else:
        check_lstm_bwd(lstm_bwd, train_cfg.bf16, model_cfg.bidirectional, res_bf16=res_bf16,
                       kernel_dropout=kernel_dropout)

    def step(params, x: torch.Tensor, y: torch.Tensor,
             masks: Optional[DropoutMasks]) -> Dict[str, object]:
        optimizer.zero_grad()
        denominator = None
        if mesh is not None and not explicit:
            denominator = all_reduce_sum(
                torch.tensor(float(y.shape[0]), device=y.device) if class_weights is None
                else class_weights[y.long()].sum(), mesh)
        if mesh is not None and kernel_dropout and masks is not None and masks.key is not None:
            # the implicit step draws the rank's rows of the whole batch; the
            # explicit one, every shard the same key's rows from 0
            masks = dataclasses.replace(masks, row_offset=0 if explicit
                                        else mesh.rank * int(x.shape[0]))
        logits = classifier_apply(params, x, model_cfg, compute_dtype=compute_dtype,
                                  lstm_impl=impl, train=True, masks=masks, lstm_bwd=lstm_bwd,
                                  res_bf16=res_bf16, kernel_dropout=kernel_dropout)
        loss = cross_entropy_loss(logits, y, class_weights, denominator)
        loss.backward()
        correct = (logits.detach().argmax(-1) == y).sum()
        count = int(y.shape[0])
        if mesh is not None:
            loss, correct = reduce_gradients(optimizer.params, mesh, loss, correct,
                                             average=explicit)
            count *= mesh.world_size
        optimizer.step()
        return {"loss": loss.detach(), "correct": correct, "count": count}

    return step


def make_eval_step(model_cfg: ModelConfig, bf16: bool = True, return_attention: bool = False,
                   lstm_impl: str = "auto") -> Callable:
    """``evaluate(params, x) -> probs`` (or ``(probs, attention)``), without
    gradients, on the eval-mode kernels."""
    compute_dtype = torch.bfloat16 if bf16 else None

    @torch.no_grad()
    def evaluate(params, x: torch.Tensor):
        out = classifier_apply(params, x, model_cfg, return_attention=return_attention,
                               compute_dtype=compute_dtype, lstm_impl=lstm_impl)
        if return_attention:
            logits, attn = out
            return torch.softmax(logits, dim=-1), attn
        return torch.softmax(out, dim=-1)

    return evaluate
