"""The flagship EEG classifier: input projection -> BiLSTM stack -> layer norm
-> additive-attention pooling -> MLP head (``eegflow.nn.model``).

``classifier_init`` returns an ``nn.ModuleDict`` whose indexing and
``state_dict`` paths mirror the JAX params pytree (:mod:`eegflow_torch.convert`);
``classifier_apply`` is a plain function over such a tree (or a nested dict
of tensors), in eval mode or, with ``train=True``, in training mode.

``lstm_impl`` picks how the recurrent stack and the pool head run:

* ``"kernel"`` — the hand-written CUDA kernels: eval mode launches
  ``lstm_fwd`` six times for 3 bidirectional layers and ``pool_head_fwd``
  once; a differentiable forward (training, or gradients enabled on the
  parameters) launches ``lstm_fwd`` in training mode instead, and its
  backward ``lstm_bwd`` six times and ``pool_head_bwd`` once. CUDA tensors
  only: on a CPU tensor it raises, and a kernel that cannot launch raises.
* ``"plain"`` — the kernels' plain PyTorch twins, on the same schedule.
* ``"auto"`` — ``"kernel"`` for CUDA tensors, ``"plain"`` for CPU tensors.

The fused schedule is the bf16 policy (``compute_dtype=torch.bfloat16``),
as in the JAX package, whose fused LSTM kernels are bf16-only. Under the
float32 policy the plain path runs the eager float32 stack
(:mod:`eegflow_torch.nn.lstm`), LayerNorm and additive attention; its
kernel counterpart (the recurrence-only ``_lstm_chunk_kernel``) is not
ported yet, so ``"kernel"`` with float32 raises.

Dropout (training mode) takes explicit keep-masks (:class:`DropoutMasks`,
drawn by :func:`draw_dropout_masks` from a ``torch.Generator``) at the
reference's places: rate d/2 on the stack's input, d on each layer's output
but the last, d after ``head1`` and after ``head2``. On the fused schedule
the stack's masks are applied inside the LSTM kernels as uint8 masks (the
reference's explicit-mask mode, ``EEGFLOW_MASK_DROPOUT``); forward and
backward use the same masks, so gradients are exact.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from eegflow_torch.convert import module_from_tree
from eegflow_torch.core.config import ModelConfig
from eegflow_torch.core.prng import make_generator
from eegflow_torch.nn.attention import additive_attention_apply, additive_attention_init
from eegflow_torch.nn.cuda_attention import pool_head, pool_head_fused, pool_head_fused_plain
from eegflow_torch.nn.cuda_lstm import (bilstm_layer, lstm_fwd_fused_proj,
                                        lstm_fwd_fused_proj_plain)
from eegflow_torch.nn.layers import (dense_apply, dense_init, dropout, dropout_mask, gelu,
                                     layer_norm_apply, layer_norm_init)
from eegflow_torch.nn.lstm import bilstm_stack_apply, bilstm_stack_init

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


def _fused_stack(layers, h: torch.Tensor, kernel: bool) -> Tuple[torch.Tensor, ...]:
    """BiLSTM stack as feature parts: a bidirectional layer's fwd/rev halves
    flow to the next layer (and to the pool head) as two tensors."""
    fwd_fn = lstm_fwd_fused_proj if kernel else lstm_fwd_fused_proj_plain
    parts = (h,)
    for layer in layers:
        out = [fwd_fn(parts, layer["fwd"]["w_ih"], layer["fwd"]["b"],
                      layer["fwd"]["w_hh"], False)]
        if "bwd" in layer:
            out.append(fwd_fn(parts, layer["bwd"]["w_ih"], layer["bwd"]["b"],
                              layer["bwd"]["w_hh"], True))
        parts = tuple(out)
    return parts


def _as_u8(masks: Optional[Sequence[torch.Tensor]]):
    return None if masks is None else tuple(m.to(torch.uint8).contiguous() for m in masks)


def _fused_stack_train(layers, h: torch.Tensor, kernel: bool, masks: Optional[DropoutMasks],
                       rate: float) -> Tuple[torch.Tensor, ...]:
    """The differentiable stack (:class:`~eegflow_torch.nn.cuda_lstm.BiLSTMLayer`
    per layer) as feature parts; each layer's kernels apply the dropout of
    its input as masks."""
    part_masks, keep = None, 1.0
    if masks is not None and masks.input is not None:
        part_masks, keep = (masks.input,), 1.0 - rate / 2
    parts = (h,)
    for idx, layer in enumerate(layers):
        parts = bilstm_layer(layer, parts, _as_u8(part_masks), keep, kernel)
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
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """(B, T, C) windows -> (B, num_classes) logits (+ attention (B, T)).

    ``train=True`` applies dropout with ``masks`` (none when ``masks`` is
    None, as the reference does without a dropout key).
    """
    impl = resolve_lstm_impl(lstm_impl, x.device)
    fused = compute_dtype == torch.bfloat16
    if impl == "kernel" and not fused:
        raise NotImplementedError(
            "the float32 policy needs the recurrence-only kernel "
            "(eegflow/nn/pallas_lstm.py _lstm_chunk_kernel), not ported yet; "
            "use compute_dtype=torch.bfloat16 or lstm_impl='plain'")
    kernel = impl == "kernel"
    rate = config.dropout
    masks = masks if train else None

    h = dense_apply(params["input_proj"], x.to(torch.float32), compute_dtype)
    h = gelu(layer_norm_apply(params["input_norm"], h))

    ln = params["lstm_norm"] if config.use_layer_norm else None
    # the residual-free eval kernels serve inference; a forward that may be
    # differentiated (or carries dropout) runs the autograd Functions
    differentiable = masks is not None or (torch.is_grad_enabled() and h.requires_grad)
    if fused:
        parts = (_fused_stack_train(params["lstm"], h, kernel, masks, rate) if differentiable
                 else _fused_stack(params["lstm"], h, kernel))
    if fused and config.use_attention:
        if differentiable:
            ctx_parts, raw_scores = pool_head(ln, params["attention"], parts,
                                              use_ln=config.use_layer_norm, bf16=True,
                                              kernel=kernel)
        else:
            pool_fn = pool_head_fused if kernel else pool_head_fused_plain
            ctx_parts, raw_scores = pool_fn(ln, params["attention"], parts,
                                            use_ln=config.use_layer_norm, bf16=True)
        context = torch.cat(ctx_parts, dim=-1)
        attn = torch.softmax(raw_scores + params["attention"]["score"]["b"][0], dim=-1)
    else:
        if fused:
            h = torch.cat(parts, dim=-1)
        else:
            if masks is not None:
                h = dropout(h, rate / 2, masks.input)
            layer_masks = (None if masks is None
                           else [torch.cat(m, dim=-1) for m in masks.layers])
            h = bilstm_stack_apply(params["lstm"], h, masks=layer_masks, rate=rate)
        if config.use_layer_norm:
            h = layer_norm_apply(ln, h)
        if config.use_attention:
            context, attn = additive_attention_apply(params["attention"], h)
        else:
            context = h.mean(dim=1)  # ablation fallback: mean pooling
            attn = torch.full(h.shape[:2], 1.0 / h.shape[1], dtype=h.dtype,
                              device=h.device)

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
