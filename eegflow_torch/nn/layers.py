"""Functional building blocks: dense, layer norm, GELU, dropout and the
residual block (``eegflow.nn.layers``).

Params are nested mappings of float32 tensors (see :mod:`eegflow_torch.convert`).

The bf16 policy of the reference (``compute_dtype=jnp.bfloat16``: bf16
operands, float32 accumulation via ``preferred_element_type``) is emulated
rather than run as a bf16 matmul: ``torch.matmul`` on bf16 tensors returns
bf16, rounding the float32 sum. Operands are rounded to bf16 and multiplied
in float32 (:func:`bf16_round`). The products of two bf16 values are exact in
float32 and in TF32 alike, but callers that need float32 sums
(``chip_smoke.py``, the CLI) set ``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32`` to False explicitly.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Union

import torch
import torch.nn.functional as F


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 (nearest even) and return float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def matmul_policy(a: torch.Tensor, b: torch.Tensor,
                  compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a @ b`` under the precision policy: float32, or bf16 operands with
    float32 accumulation when ``compute_dtype`` is ``torch.bfloat16``."""
    if compute_dtype is None:
        return a @ b
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"unsupported compute_dtype {compute_dtype}")
    return bf16_round(a) @ bf16_round(b)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int):
    """torch default Linear init: W, b ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    W stored (in, out) as in the JAX package."""
    bound = 1.0 / in_dim ** 0.5
    return {
        "w": (torch.rand((in_dim, out_dim), generator=gen) * 2 - 1) * bound,
        "b": (torch.rand((out_dim,), generator=gen) * 2 - 1) * bound,
    }


def dense_apply(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x @ W + b; params stay float32."""
    return matmul_policy(x, params["w"], compute_dtype) + params["b"]


def layer_norm_init(dim: int):
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def layer_norm_apply(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis; statistics in float32."""
    x = x.to(torch.float32)
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x, approximate="none")


def dropout_mask(gen: torch.Generator, rate: float, shape: Sequence[int],
                 device: Optional[Union[torch.device, str]] = None) -> torch.Tensor:
    """Boolean KEEP-mask with P(keep) = 1 - rate, drawn from ``gen`` (a
    generator on ``device``): ``rand < keep``. The keep probability is exact,
    unlike the reference's 8-bit draw (``EEGFLOW_DROP8``), which quantises it."""
    return torch.rand(tuple(shape), generator=gen, device=device) < (1.0 - rate)


def dropout(x: torch.Tensor, rate: float, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Inverted dropout with an explicit keep-mask: ``where(mask, x / keep,
    0)``, as ``eegflow.nn.layers.dropout`` applies its mask; identity when
    ``mask`` is None or ``rate`` is 0."""
    if mask is None or rate <= 0.0:
        return x
    return torch.where(mask, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def residual_block_init(gen: torch.Generator, hidden: int):
    """FC-GELU-dropout-FC + post-add LayerNorm residual block
    (``eegflow.nn.layers.residual_block_init``; ref 04_lstm_model.py:131-150,
    declared there but unused)."""
    return {
        "fc1": dense_init(gen, hidden, hidden),
        "fc2": dense_init(gen, hidden, hidden),
        "norm": layer_norm_init(hidden),
    }


def residual_block_apply(params: Mapping[str, Mapping[str, torch.Tensor]], x: torch.Tensor,
                         rate: float = 0.3,
                         masks: Optional[Sequence[torch.Tensor]] = None,
                         train: bool = False,
                         compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``LayerNorm(x + fc2(dropout(GELU(fc1(x)))))`` with a second dropout
    after fc2. ``masks`` are the two keep-masks (after the GELU, after fc2;
    :func:`dropout_mask`), applied only when ``train``; without them the
    block applies no dropout, as the JAX block does without a key."""
    m1 = m2 = None
    if train and masks is not None:
        m1, m2 = masks
    out = gelu(dense_apply(params["fc1"], x, compute_dtype))
    out = dropout(out, rate, m1)
    out = dense_apply(params["fc2"], out, compute_dtype)
    out = dropout(out, rate, m2)
    return layer_norm_apply(params["norm"], out + x)
