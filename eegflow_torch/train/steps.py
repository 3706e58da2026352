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
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from eegflow_torch.core.config import ModelConfig, TrainConfig
from eegflow_torch.nn.cuda_lstm import check_lstm_bwd
from eegflow_torch.nn.losses import cross_entropy_loss
from eegflow_torch.nn.model import DropoutMasks, classifier_apply
from eegflow_torch.train.schedule import warmup_cosine_schedule


class AdamW:
    """``MultiSteps(chain(clip_by_global_norm, adamw), every_k)`` over
    ``params`` (see the module docstring)."""

    def __init__(self, params: Sequence[torch.Tensor], schedule: Callable[[int], float],
                 weight_decay: float = 1e-4, max_norm: float = 1.0, every_k: int = 1,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.schedule = schedule
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
        norm = torch.sqrt(sum(torch.sum(a * a) for a in self.acc))
        keep = norm < self.max_norm  # on the device: no host sync
        self.count += 1
        f32 = torch.float32
        dev = self.params[0].device
        bc1 = 1 - torch.tensor(self.b1, dtype=f32, device=dev) ** self.count
        bc2 = 1 - torch.tensor(self.b2, dtype=f32, device=dev) ** self.count
        step_size = torch.tensor(-self.schedule(self.count - 1), dtype=f32, device=dev)
        for p, acc, mu, nu in zip(self.params, self.acc, self.mu, self.nu):
            g = torch.where(keep, acc, (acc / norm) * self.max_norm)
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            upd = upd + self.weight_decay * p
            p.add_(upd * step_size)
            acc.zero_()
        return True


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
                    lstm_impl: Optional[str] = None, *, lstm_bwd: str = "fused") -> Callable:
    """``step(params, x, y, masks) -> {"loss", "correct", "count"}``: forward
    in training mode with the dropout ``masks``, weighted cross-entropy,
    backward, optimizer step (the parameters change in place on every
    ``accumulation_steps``-th call). ``loss`` and ``correct`` stay on the
    device. ``lstm_bwd``: the LSTM stack's backward schedule
    (``classifier_apply``); not a ``TrainConfig`` field, whose fields stay
    the JAX package's."""
    compute_dtype = torch.bfloat16 if train_cfg.bf16 else None
    impl = lstm_impl or train_cfg.lstm_impl
    check_lstm_bwd(lstm_bwd, train_cfg.bf16, model_cfg.bidirectional)

    def step(params, x: torch.Tensor, y: torch.Tensor,
             masks: Optional[DropoutMasks]) -> Dict[str, object]:
        optimizer.zero_grad()
        logits = classifier_apply(params, x, model_cfg, compute_dtype=compute_dtype,
                                  lstm_impl=impl, train=True, masks=masks, lstm_bwd=lstm_bwd)
        loss = cross_entropy_loss(logits, y, class_weights)
        loss.backward()
        optimizer.step()
        correct = (logits.detach().argmax(-1) == y).sum()
        return {"loss": loss.detach(), "correct": correct, "count": int(y.shape[0])}

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
