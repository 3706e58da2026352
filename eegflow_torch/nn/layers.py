"""Functional building blocks: dense, layer norm, GELU (``eegflow.nn.layers``).

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

from typing import Mapping, Optional

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
