"""The flagship EEG classifier: input projection -> BiLSTM stack -> layer norm
-> additive-attention pooling -> MLP head (``eegflow.nn.model``).

``classifier_init`` returns an ``nn.ModuleDict`` whose indexing and
``state_dict`` paths mirror the JAX params pytree (:mod:`eegflow_torch.convert`);
``classifier_apply`` is a plain function over such a tree (or a nested dict
of tensors), in eval mode or, with ``train=True``, in training mode. Both,
``draw_dropout_masks`` and ``model_flops_per_window`` dispatch on the config
type, as the reference's do: a ``TransformerConfig`` selects the EEGFormer
(:mod:`eegflow_torch.nn.transformer`), whose schedule is its own.

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
reference's ``EEGFLOW_ADJOINT_RES=0 EEGFLOW_BWD_V2=1``, and as the same
function its other raw-gate backwards: ``EEGFLOW_ADJOINT_RES=0`` with
``BWD_V2`` unset, with or without ``EEGFLOW_BWD_TC=1``, and
``EEGFLOW_ADJOINT_RES=0 EEGFLOW_BWD_DUALDIR=1``) or ``"dualdir"``
(kernel 4, one backward launch per layer: ``EEGFLOW_BWD_DUALDIR=1`` on the
reference's select-dropout path, where each layer's input parts are dropped
by :func:`~eegflow_torch.nn.cuda_lstm.select_dropout` with the same masks
and the kernels recover the mask from the zeros). The float32 policy runs
only ``"fused"``.

``res_bf16`` (the reference's ``EEGFLOW_RES_BF16=1``), under any bf16
schedule: the LSTM forwards store their residual planes (or raw gates) in
bf16 and the backwards widen them, about 0.4 % relative error in the gate
derivatives for half their bytes; the float32 policy refuses it. The
reference's ``EEGFLOW_FWD_DROPW=2`` (the producing kernels write the
dropped copies, the consumers recover the masks from their zeros) draws the
same masks and gives the same loss and gradients as the mask path above,
which is its counterpart here.

``kernel_dropout`` (the bf16 policy under ``"fused"`` or ``"two_pass"``):
the stack's dropout comes from the Philox bits of a per-step key
(:mod:`eegflow_torch.nn.philox`; ``masks.key``), drawn once per layer and
pass into a transient packed plane of 1 bit an element that kernels 2, 3
and 3b read, with no uint8 mask in device memory: the reference's in-kernel
PRNG dropout
(``EEGFLOW_KERNEL_DROPOUT=1``, the default mode 1 of ``EEGFLOW_FWD_DROPW``,
the input block's ``out_seed``), whose TPU bits no other device reproduces.
Stream 0 drops the stack's input, stream 1 + 2 l + p part p of layer l's
output; the head keeps its generator masks. On the same bits
(:func:`expand_dropout_masks`) it is the mask path's function bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from eegflow_torch.convert import module_from_tree
from eegflow_torch.core.config import ModelConfig, TransformerConfig
from eegflow_torch.core.prng import make_generator
from eegflow_torch.nn.attention import additive_attention_init
from eegflow_torch.nn.cuda_attention import pool_head, pool_head_fused, pool_head_fused_plain
from eegflow_torch.nn.cuda_input import input_block
from eegflow_torch.nn.cuda_lstm import (bilstm_layer, check_lstm_bwd, counter,
                                        lstm_fwd_fused_proj, lstm_fwd_fused_proj_plain,
                                        lstm_rec_layer, select_dropout)
from eegflow_torch.nn.layers import (dense_apply, dense_init, dropout, dropout_mask, gelu,
                                     layer_norm_apply, layer_norm_init)
from eegflow_torch.nn.lstm import bilstm_stack_init
from eegflow_torch.nn.philox import PhiloxSource, philox_keep_mask

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

    With ``kernel_dropout`` the stack's masks are not drawn (``input`` None,
    ``layers`` empty): ``key``, a (2,) int32 tensor on the device, keys the
    Philox bits the LSTM kernels draw, and ``row_offset`` is the global row
    of the batch's first row (a mesh rank's offset). ``key`` is the whole
    batch's on every rank: ``shard_batch`` replicates it.
    """

    input: Optional[torch.Tensor] = None
    layers: Tuple[Tuple[torch.Tensor, ...], ...] = ()
    head1: Optional[torch.Tensor] = None
    head2: Optional[torch.Tensor] = None
    key: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                    metadata={"replicated": True})
    row_offset: int = 0


def draw_dropout_masks(config: ModelConfig, batch: int, steps: int, gen: torch.Generator,
                       device: Optional[Union[torch.device, str]] = None, *,
                       kernel_dropout: bool = False) -> DropoutMasks:
    """All keep-masks of one training forward, drawn from ``gen`` (a generator
    on ``device``) in a fixed order; no masks when ``config.dropout`` is 0.
    ``kernel_dropout``: the Philox key of the stack's in-kernel dropout
    (two 32-bit words, drawn on ``device``: no host sync), then the head's
    masks. A ``TransformerConfig`` gets its own record
    (:func:`~eegflow_torch.nn.transformer.draw_transformer_masks`), and has
    no in-kernel dropout."""
    if isinstance(config, TransformerConfig):
        if kernel_dropout:
            raise ValueError("kernel_dropout is the LSTM stack's; the EEGFormer has none")
        from eegflow_torch.nn.transformer import draw_transformer_masks

        return draw_transformer_masks(config, batch, steps, gen, device)
    d = config.dropout
    if d <= 0.0:
        return DropoutMasks()
    hidden = config.resolved_hidden()
    n_dir = 2 if config.bidirectional else 1

    def draw(rate, *shape):
        return dropout_mask(gen, rate, shape, device)

    if kernel_dropout:
        key = torch.randint(-2 ** 31, 2 ** 31, (2,), generator=gen, device=device,
                            dtype=torch.int32)
        return DropoutMasks(key=key, head1=draw(d, batch, hidden),
                            head2=draw(d, batch, hidden // 2))
    return DropoutMasks(
        input=draw(d / 2, batch, steps, hidden),
        layers=tuple(tuple(draw(d, batch, steps, hidden) for _ in range(n_dir))
                     for _ in range(config.num_layers - 1)),
        head1=draw(d, batch, hidden),
        head2=draw(d, batch, hidden // 2))


def _stack_sources(masks: DropoutMasks, n_dir: int,
                   num_layers: int) -> Tuple[PhiloxSource, ...]:
    """The Philox source of each layer's input parts: stream 0 for the
    stack's input, 1 + 2 l + p for part p of layer l's output."""
    return tuple(PhiloxSource(masks.key, (0,) if idx == 0 else
                              tuple(1 + 2 * (idx - 1) + p for p in range(n_dir)),
                              masks.row_offset)
                 for idx in range(num_layers))


def expand_dropout_masks(masks: DropoutMasks, config: ModelConfig, batch: int,
                         steps: int) -> DropoutMasks:
    """The mask-path record of a ``kernel_dropout`` draw: the stack's masks
    the kernels draw from ``masks.key`` (bool, on its device) for these
    ``batch`` rows from ``masks.row_offset`` on, and its head masks."""
    d, hidden = config.dropout, config.resolved_hidden()
    n_dir = 2 if config.bidirectional else 1
    shape = (batch, steps, hidden)
    keep = lambda idx: 1.0 - (d / 2 if idx == 0 else d)  # noqa: E731
    parts = [tuple(philox_keep_mask(src.key, s, shape, keep(idx), src.row_offset)
                   for s in src.streams)
             for idx, src in enumerate(_stack_sources(masks, n_dir, config.num_layers))]
    return DropoutMasks(input=parts[0][0], layers=tuple(parts[1:]), head1=masks.head1,
                        head2=masks.head2)


def classifier_init(config: ModelConfig, gen: Optional[torch.Generator] = None,
                    device: Optional[Union[torch.device, str]] = None,
                    trainable: bool = False) -> nn.ModuleDict:
    """torch-default init (uniform fan-in bounds) drawn from ``gen``;
    parameters require grad when ``trainable``. A ``TransformerConfig``
    builds the EEGFormer (:mod:`eegflow_torch.nn.transformer`)."""
    if isinstance(config, TransformerConfig):
        from eegflow_torch.nn.transformer import transformer_init

        return transformer_init(config, gen, device, trainable)
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
                 masks: Optional[DropoutMasks], rate: float, lstm_bwd: str = "fused",
                 res_bf16: bool = False) -> Tuple[torch.Tensor, ...]:
    """The differentiable stack, one autograd Function per layer
    (:class:`~eegflow_torch.nn.cuda_lstm.BiLSTMLayer` under bf16,
    :class:`~eegflow_torch.nn.cuda_lstm.BiLSTMLayerF32` under float32), as
    feature parts; each layer applies the dropout of its input as masks, or
    from the Philox key (``masks.key``), or under ``"dualdir"`` reads parts
    dropped by ``select_dropout``."""
    if masks is not None and masks.key is not None:
        sources = _stack_sources(masks, 2 if "bwd" in layers[0] else 1, len(layers))
        parts = (h,)
        for idx, (layer, src) in enumerate(zip(layers, sources)):
            parts = bilstm_layer(layer, parts, src, 1.0 - (rate / 2 if idx == 0 else rate),
                                 kernel, bf16, lstm_bwd=lstm_bwd, res_bf16=res_bf16,
                                 kernel_dropout=True)
        return parts
    part_masks, keep = None, 1.0
    if masks is not None and masks.input is not None:
        part_masks, keep = (masks.input,), 1.0 - rate / 2
    parts = (h,)
    for idx, layer in enumerate(layers):
        if lstm_bwd == "dualdir" and part_masks is not None:
            parts = tuple(select_dropout(p, m, keep) for p, m in zip(parts, part_masks))
            part_masks = None
        parts = bilstm_layer(layer, parts, _as_u8(part_masks), keep, kernel, bf16,
                             lstm_bwd=lstm_bwd, res_bf16=res_bf16)
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
    res_bf16: bool = False,
    kernel_dropout: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """(B, T, C) windows -> (B, num_classes) logits (+ attention (B, T)).

    ``compute_dtype`` is ``torch.bfloat16`` (the bf16 policy) or None
    (float32). ``train=True`` applies dropout with ``masks`` (none when
    ``masks`` is None, as the reference does without a dropout key).
    ``lstm_bwd`` picks the stack's backward schedule (module docstring);
    any value but ``"fused"`` needs the bf16 policy, and ``"dualdir"`` a
    bidirectional stack. ``res_bf16``: the bf16 stack's residuals in bf16
    (module docstring). ``kernel_dropout``: ``masks`` (from
    ``draw_dropout_masks(..., kernel_dropout=True)``) carry the Philox key
    of the stack's in-kernel dropout (module docstring); the bf16 policy
    under ``"fused"`` or ``"two_pass"`` only. A ``TransformerConfig`` runs
    the EEGFormer (:func:`~eegflow_torch.nn.transformer.transformer_apply`,
    which has no LSTM and so none of these options).
    """
    if isinstance(config, TransformerConfig):
        if kernel_dropout:
            raise ValueError("kernel_dropout is the LSTM stack's; the EEGFormer has none")
        from eegflow_torch.nn.transformer import transformer_apply

        return transformer_apply(params, x, config, return_attention, compute_dtype,
                                 lstm_impl, train=train, masks=masks)
    if compute_dtype not in (None, torch.bfloat16):
        raise ValueError(f"unsupported compute_dtype {compute_dtype}")
    bf16 = compute_dtype == torch.bfloat16
    check_lstm_bwd(lstm_bwd, bf16, config.bidirectional, res_bf16=res_bf16,
                   kernel_dropout=kernel_dropout)
    kernel = resolve_lstm_impl(lstm_impl, x.device) == "kernel"
    rate = config.dropout
    masks = masks if train else None
    if masks is not None and (masks.key is not None) != (kernel_dropout and rate > 0.0):
        raise ValueError("kernel_dropout takes the masks draw_dropout_masks(..., "
                         "kernel_dropout=True) draws, and only then")

    h = input_block(params["input_proj"], params["input_norm"],
                    x.to(torch.float32).contiguous(), bf16, kernel)

    ln = params["lstm_norm"] if config.use_layer_norm else None
    # the residual-free eval kernels serve inference; a forward that may be
    # differentiated (or carries dropout) runs the autograd Functions
    differentiable = masks is not None or (torch.is_grad_enabled() and h.requires_grad)
    parts = (_stack_train(params["lstm"], h, kernel, bf16, masks, rate, lstm_bwd, res_bf16)
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


def train_step_launches(config: ModelConfig, lstm_bwd: str = "fused",
                        res_bf16: bool = False, kernel_dropout: bool = False) -> Dict[str, int]:
    """The kernel launches of one bf16 training micro-step of the LSTM
    classifier ``config`` on the kernel path, by counter name
    (:data:`eegflow_torch.kernels.launch_counts`): the input block's two,
    each layer-direction's forward and backward under the schedule
    ``lstm_bwd`` (one backward a layer under ``"dualdir"``) on float32 or
    bf16 residuals, with the Philox dropout (``kernel_dropout`` and a
    dropout rate above 0: each layer's keep-bit planes drawn at the top of
    its forward and of its backward) or not, and the pool head's two with
    attention."""
    dirs = 2 if config.bidirectional else 1
    fwd = "lstm_fwd_train_gates" if lstm_bwd == "two_pass" else "lstm_fwd_train"
    bwd = {"fused": "lstm_bwd", "two_pass": "lstm_bwd_v2", "dualdir": "lstm_bwd_dualdir"}[lstm_bwd]
    philox = kernel_dropout and config.dropout > 0.0
    launches = {"input_block_fwd": 1, "input_block_bwd": 1,
                counter(fwd, res_bf16, philox): config.num_layers * dirs,
                counter(bwd, res_bf16, philox): config.num_layers * (1 if lstm_bwd == "dualdir"
                                                                     else dirs)}
    if philox:
        launches["philox_keep_bits"] = 2 * config.num_layers
    if config.use_attention:
        launches.update(pool_head_fwd=1, pool_head_bwd=1)
    return launches


def model_flops_per_window(config: ModelConfig, seq_len: int = 256) -> int:
    """Forward-pass FLOPs per window, matmuls only
    (``eegflow.nn.model.model_flops_per_window``)."""
    if isinstance(config, TransformerConfig):
        from eegflow_torch.nn.transformer import transformer_flops_per_window

        return transformer_flops_per_window(config, seq_len)
    h = config.resolved_hidden()
    n_dir = 2 if config.bidirectional else 1
    fl = 2 * seq_len * config.input_size * h  # input projection
    d = h
    for _ in range(config.num_layers):
        fl += n_dir * (2 * seq_len * d * 4 * h + 2 * seq_len * h * 4 * h)
        d = h * n_dir
    lstm_out = h * n_dir
    fl += 2 * seq_len * lstm_out * (lstm_out // 2) + 2 * seq_len * (lstm_out // 2)
    fl += 2 * lstm_out * h + 2 * h * (h // 2) + 2 * (h // 2) * config.num_classes
    return int(fl)
