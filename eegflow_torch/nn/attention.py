"""Attention modules (``eegflow.nn.attention``).

* ``additive_attention_*``: Linear(D -> D/2) -> tanh -> Linear(D/2 -> 1) ->
  softmax over time -> weighted sum, in plain PyTorch. The classifiers run
  the fused LayerNorm + attention-pool head
  (:mod:`eegflow_torch.nn.cuda_attention`) under both precision policies
  and take only ``additive_attention_init`` from here;
  ``additive_attention_apply`` is the counterpart of the reference's, held
  to it by the tests.
* ``multihead_attention_*``: QKV self-attention with head- and
  query-averaged weights, the EEGFormer's blocks
  (:mod:`eegflow_torch.nn.transformer`). The projections go through
  ``dense_apply`` under the precision policy; the scores ``q . k^T *
  hd^-0.5``, their softmax and the context are float32 ``torch.matmul`` and
  ``torch.softmax``, as the reference computes them.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch

from eegflow_torch.nn.layers import dense_apply, dense_init


def additive_attention_init(gen: torch.Generator, hidden: int):
    return {
        "proj": dense_init(gen, hidden, hidden // 2),
        "score": dense_init(gen, hidden // 2, 1),
    }


def additive_attention_apply(
    params: Mapping[str, Mapping[str, torch.Tensor]], x: torch.Tensor,
    compute_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, H) -> (context (B, H), weights (B, T)); softmax over time."""
    scores = dense_apply(
        params["score"],
        torch.tanh(dense_apply(params["proj"], x, compute_dtype)),
        compute_dtype,
    )  # (B, T, 1)
    weights = torch.softmax(scores, dim=1)
    context = torch.sum(weights * x, dim=1)
    return context, weights[..., 0]


def multihead_attention_init(gen: torch.Generator, hidden: int):
    """Four (hidden, hidden) projections: query, key, value, out. The head
    count is an apply-time argument, as in the reference."""
    return {name: dense_init(gen, hidden, hidden) for name in ("query", "key", "value", "out")}


def multihead_attention_apply(
    params: Mapping[str, Mapping[str, torch.Tensor]], x: torch.Tensor, num_heads: int = 4,
    compute_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, H) -> (output (B, T, H), head+query-averaged weights (B, T))."""
    batch, steps, hidden = x.shape
    head_dim = hidden // num_heads

    def split_heads(y):  # (B, T, H) -> (B, heads, T, head_dim)
        return y.reshape(batch, steps, num_heads, head_dim).transpose(1, 2)

    q = split_heads(dense_apply(params["query"], x, compute_dtype))
    k = split_heads(dense_apply(params["key"], x, compute_dtype))
    v = split_heads(dense_apply(params["value"], x, compute_dtype))
    scores = torch.matmul(q, k.transpose(-1, -2)) * head_dim ** -0.5
    weights = torch.softmax(scores, dim=-1)
    context = torch.matmul(weights, v).transpose(1, 2).reshape(batch, steps, hidden)
    out = dense_apply(params["out"], context, compute_dtype)
    return out, weights.mean(dim=(1, 2))
