"""EEGFormer, the attention-only window classifier (``eegflow.nn.transformer``).

Pre-LN encoder:

    input block GELU(LN(x . W + b))                      kernels 9 and 10
    + sinusoidal positions, dropout d/2
    N x [ LN -> MHA -> dropout d -> + residual ;
          LN -> MLP(D -> r D -> D, GELU) -> dropout d -> + residual ]
    final LN -> additive-attention pooling over time      kernels 7 and 8
    -> head1 (D -> D/2) -> GELU -> dropout d -> head2

The input block is exactly the flagship's (``cuda_input.input_block``: the
``InputBlock`` autograd Function where gradients are enabled, whose backward
gives dx for the input gradients). The final LayerNorm followed by the
additive pool is exactly the flagship's pool head with one part and
``use_ln=True`` (LN params ``final_norm``): ``cuda_attention.pool_head``
(kernels 7 and 8 under ``PoolHead``) on a forward that may be
differentiated, ``pool_head_fused`` (kernel 7) in eval mode; the attention
weights are ``softmax(raw scores + score bias)``. The blocks are plain
PyTorch, as the reference computes them in XLA outside any Pallas kernel:
their products are ``dense_apply`` under the precision policy (float32
GEMMs on bf16-rounded operands under bf16) and the attention core is
float32 (:func:`~eegflow_torch.nn.attention.multihead_attention_apply`).

``lstm_impl`` picks kernels or twins for the input block and the pool head
exactly as for the flagship (``"auto" | "kernel" | "plain"``). A training
micro-step on the kernels launches 1 ``input_block_fwd``, 1
``input_block_bwd``, 1 ``pool_head_fwd`` and 1 ``pool_head_bwd``; an eval
batch 1 ``input_block_fwd`` and 1 ``pool_head_fwd``.

Dropout takes explicit keep-masks (:class:`TransformerDropoutMasks`) at the
reference's places; the reference draws them from ``fold_in(dropout_key,
i)`` with i = 0 (input), 1 + 2l and 2 + 2l (block l's attention and MLP
outputs) and 1 + 2L (after head1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional, Tuple, Union

import torch
from torch import nn

from eegflow_torch.convert import module_from_tree
from eegflow_torch.core.config import TransformerConfig
from eegflow_torch.core.prng import make_generator
from eegflow_torch.nn.attention import (additive_attention_init, multihead_attention_apply,
                                        multihead_attention_init)
from eegflow_torch.nn.cuda_attention import pool_head, pool_head_fused, pool_head_fused_plain
from eegflow_torch.nn.cuda_input import input_block
from eegflow_torch.nn.layers import (dense_apply, dense_init, dropout, dropout_mask, gelu,
                                     layer_norm_apply, layer_norm_init)
from eegflow_torch.nn.model import resolve_lstm_impl


def sinusoidal_positions(steps: int, dim: int,
                         device: Optional[Union[torch.device, str]] = None) -> torch.Tensor:
    """(T, D) float32 sinusoidal position encoding: sin of pos / 10000^(2i/D)
    in the first D/2 columns, cos in the next; a zero last column for odd D."""
    pos = torch.arange(steps, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=device), 2.0 * i / dim)
    enc = torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)
    if enc.shape[-1] < dim:
        enc = torch.nn.functional.pad(enc, (0, dim - enc.shape[-1]))
    return enc


@dataclass
class TransformerDropoutMasks:
    """Boolean keep-masks of one training forward (True = kept).

    ``input`` (B, T, D): after the positions, rate d/2. ``blocks[l]``: block
    l's (attention output, MLP output) masks, (B, T, D) each, rate d.
    ``head1`` (B, D/2): after head1's GELU, rate d.
    """

    input: Optional[torch.Tensor] = None
    blocks: Tuple[Tuple[torch.Tensor, torch.Tensor], ...] = ()
    head1: Optional[torch.Tensor] = None


def draw_transformer_masks(config: TransformerConfig, batch: int, steps: int,
                           gen: torch.Generator,
                           device: Optional[Union[torch.device, str]] = None
                           ) -> TransformerDropoutMasks:
    """All keep-masks of one training forward, drawn from ``gen`` (a
    generator on ``device``) in a fixed order; none when the rate is 0."""
    d = config.dropout
    if d <= 0.0:
        return TransformerDropoutMasks()
    dim = config.resolved_d_model()

    def draw(rate, *shape):
        return dropout_mask(gen, rate, shape, device)

    return TransformerDropoutMasks(
        input=draw(d / 2, batch, steps, dim),
        blocks=tuple((draw(d, batch, steps, dim), draw(d, batch, steps, dim))
                     for _ in range(config.num_layers)),
        head1=draw(d, batch, dim // 2))


def transformer_init(config: TransformerConfig, gen: Optional[torch.Generator] = None,
                     device: Optional[Union[torch.device, str]] = None,
                     trainable: bool = False) -> nn.ModuleDict:
    """torch-default init (uniform fan-in bounds) drawn from ``gen``, in the
    tree of ``eegflow.nn.transformer.transformer_init`` (``blocks`` a list);
    parameters require grad when ``trainable``."""
    gen = gen if gen is not None else make_generator(0)
    d = config.resolved_d_model()
    tree = {
        "input_proj": dense_init(gen, config.input_size, d),
        "input_norm": layer_norm_init(d),
        "blocks": [{
            "ln1": layer_norm_init(d),
            "mha": multihead_attention_init(gen, d),
            "ln2": layer_norm_init(d),
            "mlp1": dense_init(gen, d, config.mlp_ratio * d),
            "mlp2": dense_init(gen, config.mlp_ratio * d, d),
        } for _ in range(config.num_layers)],
        "final_norm": layer_norm_init(d),
        "attention": additive_attention_init(gen, d),
        "head1": dense_init(gen, d, d // 2),
        "head2": dense_init(gen, d // 2, config.num_classes),
    }
    return module_from_tree(tree, torch.device(device) if device else None, trainable)


def transformer_apply(
    params: Mapping,
    x: torch.Tensor,
    config: TransformerConfig,
    return_attention: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    lstm_impl: str = "auto",
    *,
    train: bool = False,
    masks: Optional[TransformerDropoutMasks] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """(B, T, C) windows -> (B, num_classes) logits (+ pooling attention
    (B, T)); the contract of ``classifier_apply`` (module docstring).
    ``train=True`` applies dropout with ``masks`` (none when ``masks`` is
    None, as the reference does without a dropout key)."""
    if compute_dtype not in (None, torch.bfloat16):
        raise ValueError(f"unsupported compute_dtype {compute_dtype}")
    bf16 = compute_dtype == torch.bfloat16
    kernel = resolve_lstm_impl(lstm_impl, x.device) == "kernel"
    rate = config.dropout
    masks = masks if train else None
    drop = masks if masks is not None else TransformerDropoutMasks()

    h = input_block(params["input_proj"], params["input_norm"],
                    x.to(torch.float32).contiguous(), bf16, kernel)
    h = h + sinusoidal_positions(h.shape[1], h.shape[2], h.device)[None]
    h = dropout(h, rate / 2, drop.input)
    for idx, blk in enumerate(params["blocks"]):
        attn_mask, mlp_mask = drop.blocks[idx] if drop.blocks else (None, None)
        a, _ = multihead_attention_apply(blk["mha"], layer_norm_apply(blk["ln1"], h),
                                         config.num_heads, compute_dtype)
        h = h + dropout(a, rate, attn_mask)
        m = gelu(dense_apply(blk["mlp1"], layer_norm_apply(blk["ln2"], h), compute_dtype))
        m = dense_apply(blk["mlp2"], m, compute_dtype)
        h = h + dropout(m, rate, mlp_mask)

    # final LayerNorm + additive pool: the pool head with one part; the
    # residual-free eval kernel serves inference, a forward that may be
    # differentiated (or carries dropout) runs the autograd Function
    h = h.contiguous()
    if masks is not None or (torch.is_grad_enabled() and h.requires_grad):
        ctx_parts, raw_scores = pool_head(params["final_norm"], params["attention"], (h,),
                                          use_ln=True, bf16=bf16, kernel=kernel)
    else:
        pool_fn = pool_head_fused if kernel else pool_head_fused_plain
        ctx_parts, raw_scores = pool_fn(params["final_norm"], params["attention"], (h,),
                                        use_ln=True, bf16=bf16)
    attn = torch.softmax(raw_scores + params["attention"]["score"]["b"][0], dim=-1)

    z = gelu(dense_apply(params["head1"], ctx_parts[0], compute_dtype))
    logits = dense_apply(params["head2"], dropout(z, rate, drop.head1), compute_dtype)
    if return_attention:
        return logits, attn
    return logits


def transformer_flops_per_window(config: TransformerConfig, seq_len: int = 256) -> int:
    """Forward matmul FLOPs per window (``eegflow.nn.transformer``)."""
    d = config.resolved_d_model()
    t = seq_len
    fl = 2 * t * config.input_size * d                        # input projection
    per_block = (4 * 2 * t * d * d                            # Q, K, V, out
                 + 2 * 2 * t * t * d                          # scores, context
                 + 2 * 2 * t * d * (config.mlp_ratio * d))    # MLP
    fl += config.num_layers * per_block
    fl += 2 * t * d * (d // 2) + 2 * t * (d // 2)             # additive pool
    fl += 2 * d * (d // 2) + 2 * (d // 2) * config.num_classes
    return int(fl)
