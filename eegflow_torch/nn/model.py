"""The flagship EEG classifier: input projection -> BiLSTM stack -> layer norm
-> additive-attention pooling -> MLP head (``eegflow.nn.model``).

Eval-mode forward only (the serving path). ``classifier_init`` returns an
``nn.ModuleDict`` whose indexing and ``state_dict`` paths mirror the JAX
params pytree (:mod:`eegflow_torch.convert`); ``classifier_apply`` is a plain
function over such a tree (or a nested dict of tensors).

``lstm_impl`` picks how the recurrent stack and the pool head run:

* ``"kernel"`` — the hand-written CUDA kernels (``lstm_fwd`` six times for
  3 bidirectional layers, ``pool_head_fwd`` once). CUDA tensors only: on a
  CPU tensor it raises, and a kernel that cannot launch raises.
* ``"plain"`` — the kernels' plain PyTorch twins, on the same schedule.
* ``"auto"`` — ``"kernel"`` for CUDA tensors, ``"plain"`` for CPU tensors.

The fused schedule is the bf16 policy (``compute_dtype=torch.bfloat16``),
as in the JAX package, whose fused LSTM kernel is bf16-only. Under the
float32 policy the plain path runs the eager float32 stack
(:mod:`eegflow_torch.nn.lstm`), LayerNorm and additive attention; its
kernel counterpart (the recurrence-only ``_lstm_chunk_kernel``) is not
ported yet, so ``"kernel"`` with float32 raises.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple, Union

import torch
from torch import nn

from eegflow_torch.convert import module_from_tree
from eegflow_torch.core.config import ModelConfig
from eegflow_torch.core.prng import make_generator
from eegflow_torch.nn.attention import additive_attention_apply, additive_attention_init
from eegflow_torch.nn.cuda_attention import pool_head_fused, pool_head_fused_plain
from eegflow_torch.nn.cuda_lstm import lstm_fwd_fused_proj, lstm_fwd_fused_proj_plain
from eegflow_torch.nn.layers import (dense_apply, dense_init, gelu, layer_norm_apply,
                                     layer_norm_init)
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


def classifier_init(config: ModelConfig, gen: Optional[torch.Generator] = None,
                    device: Optional[Union[torch.device, str]] = None) -> nn.ModuleDict:
    """torch-default init (uniform fan-in bounds) drawn from ``gen``."""
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
    return module_from_tree(tree, torch.device(device) if device else None)


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


def classifier_apply(
    params: Mapping,
    x: torch.Tensor,
    config: ModelConfig,
    return_attention: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    lstm_impl: str = "auto",
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """(B, T, C) windows -> (B, num_classes) logits (+ attention (B, T))."""
    impl = resolve_lstm_impl(lstm_impl, x.device)
    fused = compute_dtype == torch.bfloat16
    if impl == "kernel" and not fused:
        raise NotImplementedError(
            "the float32 policy needs the recurrence-only kernel "
            "(eegflow/nn/pallas_lstm.py _lstm_chunk_kernel), not ported yet; "
            "use compute_dtype=torch.bfloat16 or lstm_impl='plain'")

    h = dense_apply(params["input_proj"], x.to(torch.float32), compute_dtype)
    h = gelu(layer_norm_apply(params["input_norm"], h))

    ln = params["lstm_norm"] if config.use_layer_norm else None
    if fused and config.use_attention:
        parts = _fused_stack(params["lstm"], h, impl == "kernel")
        pool_fn = pool_head_fused if impl == "kernel" else pool_head_fused_plain
        ctx_parts, raw_scores = pool_fn(ln, params["attention"], parts,
                                        use_ln=config.use_layer_norm, bf16=True)
        context = torch.cat(ctx_parts, dim=-1)
        attn = torch.softmax(raw_scores + params["attention"]["score"]["b"][0], dim=-1)
    else:
        if fused:
            h = torch.cat(_fused_stack(params["lstm"], h, impl == "kernel"), dim=-1)
        else:
            h = bilstm_stack_apply(params["lstm"], h)
        if config.use_layer_norm:
            h = layer_norm_apply(ln, h)
        if config.use_attention:
            context, attn = additive_attention_apply(params["attention"], h)
        else:
            context = h.mean(dim=1)  # ablation fallback: mean pooling
            attn = torch.full(h.shape[:2], 1.0 / h.shape[1], dtype=h.dtype,
                              device=h.device)

    z = gelu(dense_apply(params["head1"], context, compute_dtype))
    z = gelu(dense_apply(params["head2"], z, compute_dtype))
    logits = dense_apply(params["head3"], z, compute_dtype)
    if return_attention:
        return logits, attn
    return logits
