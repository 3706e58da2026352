"""Fused LayerNorm + additive-attention pool head (``eegflow.nn.pallas_attention``
counterpart).

:func:`pool_head_fused` launches the hand-written CUDA kernel
``eegflow_torch/csrc/pool_head_fwd.cu`` for CUDA tensors. It replaces
``eegflow/nn/pallas_attention.py`` ``_pool_head_fwd_kernel`` (entry
``_pool_head_fwd_call``, reached through ``pool_head_fused``); the kernel
source says what bounds it on the card and how its design deals with that.
For CPU tensors the wrapper runs :func:`pool_head_fused_plain`, the same
function in plain PyTorch; for CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch

from eegflow_torch import kernels
from eegflow_torch.nn.cuda_lstm import Parts, as_parts
from eegflow_torch.nn.layers import bf16_round

LN_EPS = 1e-5


def pool_head_fused_plain(ln_params: Optional[Mapping], attn_params: Mapping,
                          xs: Parts, use_ln: bool = True, bf16: bool = False
                          ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Plain twin of the kernel: parts (B, T, D_p) -> (ctx parts (B, D_p),
    raw scores (B, T)).

    LayerNorm statistics pooled across the parts (mean and E[x^2] - mean^2,
    eps 1e-5), s = tanh(y . W1 + b1) . w2 with bf16-rounded operands under
    ``bf16``, softmax over t, ctx = sum_t softmax_t y_t. The score bias b2 is
    not added (softmax ignores it; the caller adds it to the raw scores).
    """
    xs = as_parts(xs)
    widths = [p.shape[-1] for p in xs]
    x = torch.cat([p.to(torch.float32) for p in xs], dim=-1)
    if use_ln:
        d_total = x.shape[-1]
        mu = x.sum(-1, keepdim=True) / d_total
        var = (x * x).sum(-1, keepdim=True) / d_total - mu * mu
        y = (x - mu) * torch.rsqrt(var + LN_EPS) * ln_params["scale"] + ln_params["bias"]
    else:
        y = x
    w1 = attn_params["proj"]["w"]
    if bf16:
        proj = torch.tanh(bf16_round(y) @ bf16_round(w1) + attn_params["proj"]["b"])
    else:
        proj = torch.tanh(y @ w1 + attn_params["proj"]["b"])
    scores = (proj * attn_params["score"]["w"][:, 0]).sum(-1)
    ctx = (torch.softmax(scores, dim=-1)[..., None] * y).sum(1)
    return tuple(ctx.split(widths, dim=-1)), scores


def _check_cuda_args(xs, ln_params, attn_params, use_ln):
    dev = xs[0].device
    if len(xs) not in (1, 2):
        raise ValueError(f"pool_head_fwd takes 1 or 2 parts, got {len(xs)}")
    batch, steps = xs[0].shape[:2]
    for x in xs:
        if x.device != dev or x.dtype != torch.float32 or x.dim() != 3:
            raise ValueError("parts must be float32 (B, T, D_p) on one device")
        if tuple(x.shape[:2]) != (batch, steps) or not x.is_contiguous():
            raise ValueError("parts must be contiguous and agree on (B, T)")
    d_total = sum(x.shape[-1] for x in xs)
    w1 = attn_params["proj"]["w"]
    if w1.dim() != 2 or w1.shape[0] != d_total:
        raise ValueError(f"attention proj w must be ({d_total}, K), got {tuple(w1.shape)}")
    k = w1.shape[1]
    if tuple(attn_params["proj"]["b"].shape) != (k,) or \
            tuple(attn_params["score"]["w"].shape) != (k, 1):
        raise ValueError("attention proj b must be (K,) and score w (K, 1)")
    tensors = [w1, attn_params["proj"]["b"], attn_params["score"]["w"]]
    if use_ln:
        for name in ("scale", "bias"):
            if tuple(ln_params[name].shape) != (d_total,):
                raise ValueError(f"lstm_norm {name} must be ({d_total},)")
            tensors.append(ln_params[name])
    if any(t.device != dev for t in tensors):
        raise ValueError("parameters must be on the inputs' device")


def pool_head_fused(ln_params: Optional[Mapping], attn_params: Mapping, xs: Parts,
                    use_ln: bool = True, bf16: bool = False
                    ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Fused LayerNorm + additive-attention pooling over feature parts.

    ``xs``: one or two (B, T, D_p) parts (their concat is the BiLSTM output).
    Returns ``(ctx_parts, raw_scores)``: concat the parts for the (B, D)
    context; softmax(raw_scores + score bias) gives the attention weights.
    """
    xs = as_parts(xs)
    if xs[0].device.type == "cpu":
        return pool_head_fused_plain(ln_params, attn_params, xs, use_ln, bf16)
    if xs[0].device.type != "cuda":
        raise ValueError(f"pool_head_fwd: unsupported device {xs[0].device}")
    _check_cuda_args(xs, ln_params, attn_params, use_ln)
    lib = kernels.load_library()
    dev = xs[0].device
    batch, steps = xs[0].shape[:2]
    widths = [x.shape[-1] for x in xs]
    two = len(xs) == 2
    f32 = lambda t: t.to(torch.float32).contiguous()  # noqa: E731
    w1 = f32(attn_params["proj"]["w"])
    b1 = f32(attn_params["proj"]["b"])
    w2 = f32(attn_params["score"]["w"][:, 0])
    gamma = f32(ln_params["scale"]) if use_ln else None
    beta = f32(ln_params["bias"]) if use_ln else None
    ctx = [torch.empty(batch, w, dtype=torch.float32, device=dev) for w in widths]
    scores = torch.empty(batch, steps, dtype=torch.float32, device=dev)
    err = lib.eegflow_pool_head_fwd(
        xs[0].data_ptr(), xs[1].data_ptr() if two else None,
        widths[0], widths[1] if two else 0,
        gamma.data_ptr() if use_ln else None, beta.data_ptr() if use_ln else None,
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        ctx[0].data_ptr(), ctx[1].data_ptr() if two else None, scores.data_ptr(),
        batch, steps, w1.shape[1], int(use_ln), int(bf16),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(lib, err, "pool_head_fwd")
    kernels.launch_counts["pool_head_fwd"] += 1
    return tuple(ctx), scores
