"""Additive attention pooling (``eegflow.nn.attention``).

Linear(D -> D/2) -> tanh -> Linear(D/2 -> 1) -> softmax over time ->
weighted sum, in plain PyTorch. The classifier runs the fused LayerNorm +
attention-pool head (:mod:`eegflow_torch.nn.cuda_attention`) under both
precision policies and takes only ``additive_attention_init`` from here;
``additive_attention_apply`` is the counterpart of the reference's, held to
it by the tests.
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
