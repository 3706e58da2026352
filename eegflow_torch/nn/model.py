"""The flagship EEG classifier: input projection -> BiLSTM stack -> layer norm
-> additive-attention pooling -> MLP head (``eegflow.nn.model``).

``classifier_init`` returns an ``nn.ModuleDict`` whose indexing and
``state_dict`` paths mirror the JAX params pytree (:mod:`eegflow_torch.convert`);
``classifier_apply`` is a plain function over such a tree (or a nested dict
of tensors), in eval mode or, with ``train=True``, in training mode.

``lstm_impl`` picks how the input block, the recurrent stack and the pool
head run, under either precision policy:

* ``"kernel"`` — the hand-written CUDA kernels. Eval mode launches
  ``input_block_fwd`` once, six LSTM forwards for 3 bidirectional layers and
  ``pool_head_fwd`` once. A differentiable forward (training, or gradients
  enabled on the parameters) launches the LSTM forwards in training mode
  instead, and its backward ``input_block_bwd`` once, six LSTM backwards and
  ``pool_head_bwd`` once. Under the bf16 policy
  (``compute_dtype=torch.bfloat16``) the LSTM kernels are ``lstm_fwd`` /
  ``lstm_fwd_train`` / ``lstm_bwd`` (input projection inside the kernel);
  under the float32 policy (``compute_dtype=None``) they are
  ``lstm_rec_fwd`` / ``lstm_rec_fwd_train`` / ``lstm_rec_bwd`` (recurrence
  only; the projection and the weight products are float32
  ``torch.matmul``), and the pool head runs in its float32 mode. CUDA
  tensors only: on a CPU tensor it raises, and a kernel that cannot launch
  raises.
* ``"plain"`` — the kernels' plain PyTorch twins, on the same schedule.
* ``"auto"`` — ``"kernel"`` for CUDA tensors, ``"plain"`` for CPU tensors.

This is the JAX package's ``lstm_impl="pallas"`` schedule with its fused
input block (``EEGFLOW_FUSED_INPUT=1``). Without attention (the mean-pool
ablation) the stack's parts are concatenated, layer-normed and averaged in
plain PyTorch, as the reference does.

Dropout (training mode) takes explicit keep-masks (:class:`DropoutMasks`,
drawn by :func:`draw_dropout_masks` from a ``torch.Generator``) at the
reference's places: rate d/2 on the stack's input, d on each layer's output
but the last, d after ``head1`` and after ``head2``. Each LSTM layer applies
the masks of its input parts as uint8 masks (the reference's explicit-mask
mode, ``EEGFLOW_MASK_DROPOUT``): inside the kernels under bf16, before the
projection and on dx under float32. Forward and backward use the same
masks, so gradients are exact.

``lstm_bwd`` picks the bf16 stack's backward schedule
(:data:`~eegflow_torch.nn.cuda_lstm.LSTM_BWD_SCHEDULES`): ``"fused"`` (the
default, above), ``"two_pass"`` (raw-gate forwards, kernel 3b: the
reference's ``EEGFLOW_ADJOINT_RES=0 EEGFLOW_BWD_V2=1``) or ``"dualdir"``
(kernel 4, one backward launch per layer: ``EEGFLOW_BWD_DUALDIR=1`` on the
reference's select-dropout path, where each layer's input parts are dropped
by :func:`~eegflow_torch.nn.cuda_lstm.select_dropout` with the same masks
and the kernels recover the mask from the zeros). The float32 policy runs
only ``"fused"``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from eegflow_torch.convert import module_from_tree
from eegflow_torch.core.config import ModelConfig
from eegflow_torch.core.prng import make_generator
from eegflow_torch.nn.attention import additive_attention_init
from eegflow_torch.nn.cuda_attention import pool_head, pool_head_fused, pool_head_fused_plain
from eegflow_torch.nn.cuda_input import input_block
from eegflow_torch.nn.cuda_lstm import (bilstm_layer, check_lstm_bwd, lstm_fwd_fused_proj,
                                        lstm_fwd_fused_proj_plain, lstm_rec_layer,
                                        select_dropout)
from eegflow_torch.nn.layers import (dense_apply, dense_init, dropout, dropout_mask, gelu,
                                     layer_norm_apply, layer_norm_init)
from eegflow_torch.nn.lstm import bilstm_stack_init

LSTM_IMPLS = ("auto", "kernel", "plain")


def resolve_lstm_impl(impl: str, device: torch.device) -> str:
    """``"auto"`` -> ``"kernel"`` on CUDA, ``"plain"`` on the CPU."""
    if impl not in LSTM_IMPLS:
        raise ValueError(f"lstm_impl must be one of {LSTM_IMPLS}, got {impl!r}")
    if impl == "auto":
        return "kernel" if device.type == "cuda" else "plain"
    if impl == "kernel" and device.type != "cuda":
        raise ValueError(f"lstm_impl='kernel' needs CUDA tensors, got {device}")
    return impl


@dataclass
class DropoutMasks:
    """Boolean keep-masks of one training forward (True = kept).

    ``input`` (B, T, H): the stack's input, rate d/2. ``layers[i]``: the
    output parts of layer i (one (B, T, H) mask per direction), rate d, for
    every layer but the last. ``head1`` (B, H) and ``head2`` (B, H/2): after
    the first two head layers, rate d.
    """

    input: Optional[torch.Tensor] = None
    layers: Tuple[Tuple[torch.Tensor, ...], ...] = ()
    head1: Optional[torch.Tensor] = None
    head2: Optional[torch.Tensor] = None


def draw_dropout_masks(config: ModelConfig, batch: int, steps: int, gen: torch.Generator,
                       device: Optional[Union[torch.device, str]] = None) -> DropoutMasks:
    """All keep-masks of one training forward, drawn from ``gen`` (a generator
    on ``device``) in a fixed order; no masks when ``config.dropout`` is 0."""
    d = config.dropout
    if d <= 0.0:
        return DropoutMasks()
    hidden = config.resolved_hidden()
    n_dir = 2 if config.bidirectional else 1

    def draw(rate, *shape):
        return dropout_mask(gen, rate, shape, device)

    return DropoutMasks(
        input=draw(d / 2, batch, steps, hidden),
        layers=tuple(tuple(draw(d, batch, steps, hidden) for _ in range(n_dir))
                     for _ in range(config.num_layers - 1)),
        head1=draw(d, batch, hidden),
        head2=draw(d, batch, hidden // 2))


def classifier_init(config: ModelConfig, gen: Optional[torch.Generator] = None,
                    device: Optional[Union[torch.device, str]] = None,
                    trainable: bool = False) -> nn.ModuleDict:
    """torch-default init (uniform fan-in bounds) drawn from ``gen``;
    parameters require grad when ``trainable``."""
    gen = gen if gen is not None else make_generator(0)
    hidden = config.resolved_hidden()
    lstm_out = hidden * (2 if config.bidirectional else 1)
    tree = {
        "input_proj": dense_init(gen, config.input_size, hidden),
        "input_norm": layer_norm_init(hidden),
        "lstm": bilstm_stack_init(gen, hidden, hidden, config.num_layers,
                                  config.bidirectional),
        "head1": dense_init(gen, lstm_out, hidden),
        "head2": dense_init(gen, hidden, hidden // 2),
        "head3": dense_init(gen, hidden // 2, config.num_classes),
    }
    if config.use_layer_norm:
        tree["lstm_norm"] = layer_norm_init(lstm_out)
    if config.use_attention:
        tree["attention"] = additive_attention_init(gen, lstm_out)
    return module_from_tree(tree, torch.device(device) if device else None, trainable)


def _stack_eval(layers, h: torch.Tensor, kernel: bool, bf16: bool) -> Tuple[torch.Tensor, ...]:
    """The stack without residuals (inference) as feature parts: a
    bidirectional layer's fwd/rev halves flow to the next layer (and to the
    pool head) as two tensors."""
    if bf16:
        fwd_fn = lstm_fwd_fused_proj if kernel else lstm_fwd_fused_proj_plain
    else:
        fwd_fn = functools.partial(lstm_rec_layer, kernel=kernel)
    parts = (h,)
    for layer in layers:
        parts = tuple(fwd_fn(parts, layer[d]["w_ih"], layer[d]["b"], layer[d]["w_hh"],
                             d == "bwd")
                      for d in ("fwd", "bwd") if d in layer)
    return parts


def _as_u8(masks: Optional[Sequence[torch.Tensor]]):
    return None if masks is None else tuple(m.to(torch.uint8).contiguous() for m in masks)


def _stack_train(layers, h: torch.Tensor, kernel: bool, bf16: bool,
                 masks: Optional[DropoutMasks], rate: float,
                 lstm_bwd: str = "fused") -> Tuple[torch.Tensor, ...]:
    """The differentiable stack, one autograd Function per layer
    (:class:`~eegflow_torch.nn.cuda_lstm.BiLSTMLayer` under bf16,
    :class:`~eegflow_torch.nn.cuda_lstm.BiLSTMLayerF32` under float32), as
    feature parts; each layer applies the dropout of its input as masks, or
    under ``"dualdir"`` reads parts dropped by ``select_dropout``."""
    part_masks, keep = None, 1.0
    if masks is not None and masks.input is not None:
        part_masks, keep = (masks.input,), 1.0 - rate / 2
    parts = (h,)
    for idx, layer in enumerate(layers):
        if lstm_bwd == "dualdir" and part_masks is not None:
            parts = tuple(select_dropout(p, m, keep) for p, m in zip(parts, part_masks))
            part_masks = None
        parts = bilstm_layer(layer, parts, _as_u8(part_masks), keep, kernel, bf16,
                             lstm_bwd=lstm_bwd)
        part_masks, keep = None, 1.0
        if masks is not None and idx < len(masks.layers):
            part_masks, keep = masks.layers[idx], 1.0 - rate
    return parts


def classifier_apply(
    params: Mapping,
    x: torch.Tensor,
    config: ModelConfig,
    return_attention: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    lstm_impl: str = "auto",
    *,
    train: bool = False,
    masks: Optional[DropoutMasks] = None,
    lstm_bwd: str = "fused",
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """(B, T, C) windows -> (B, num_classes) logits (+ attention (B, T)).

    ``compute_dtype`` is ``torch.bfloat16`` (the bf16 policy) or None
    (float32). ``train=True`` applies dropout with ``masks`` (none when
    ``masks`` is None, as the reference does without a dropout key).
    ``lstm_bwd`` picks the stack's backward schedule (module docstring);
    any value but ``"fused"`` needs the bf16 policy, and ``"dualdir"`` a
    bidirectional stack.
    """
    if compute_dtype not in (None, torch.bfloat16):
        raise ValueError(f"unsupported compute_dtype {compute_dtype}")
    bf16 = compute_dtype == torch.bfloat16
    check_lstm_bwd(lstm_bwd, bf16, config.bidirectional)
    kernel = resolve_lstm_impl(lstm_impl, x.device) == "kernel"
    rate = config.dropout
    masks = masks if train else None

    h = input_block(params["input_proj"], params["input_norm"],
                    x.to(torch.float32).contiguous(), bf16, kernel)

    ln = params["lstm_norm"] if config.use_layer_norm else None
    # the residual-free eval kernels serve inference; a forward that may be
    # differentiated (or carries dropout) runs the autograd Functions
    differentiable = masks is not None or (torch.is_grad_enabled() and h.requires_grad)
    parts = (_stack_train(params["lstm"], h, kernel, bf16, masks, rate, lstm_bwd)
             if differentiable
             else _stack_eval(params["lstm"], h, kernel, bf16))
    if config.use_attention:
        if differentiable:
            ctx_parts, raw_scores = pool_head(ln, params["attention"], parts,
                                              use_ln=config.use_layer_norm, bf16=bf16,
                                              kernel=kernel)
        else:
            pool_fn = pool_head_fused if kernel else pool_head_fused_plain
            ctx_parts, raw_scores = pool_fn(ln, params["attention"], parts,
                                            use_ln=config.use_layer_norm, bf16=bf16)
        context = torch.cat(ctx_parts, dim=-1)
        attn = torch.softmax(raw_scores + params["attention"]["score"]["b"][0], dim=-1)
    else:
        h = torch.cat(parts, dim=-1)
        if config.use_layer_norm:
            h = layer_norm_apply(ln, h)
        context = h.mean(dim=1)  # ablation fallback: mean pooling
        attn = torch.full(h.shape[:2], 1.0 / h.shape[1], dtype=h.dtype, device=h.device)

    z = gelu(dense_apply(params["head1"], context, compute_dtype))
    if masks is not None:
        z = dropout(z, rate, masks.head1)
    z = gelu(dense_apply(params["head2"], z, compute_dtype))
    if masks is not None:
        z = dropout(z, rate, masks.head2)
    logits = dense_apply(params["head3"], z, compute_dtype)
    if return_attention:
        return logits, attn
    return logits
