"""Fused LayerNorm + additive-attention pool head (``eegflow.nn.pallas_attention``
counterpart), forward and backward.

:func:`pool_head_fused` launches the hand-written CUDA kernel
``eegflow_torch/csrc/pool_head_fwd.cu`` for CUDA tensors. It replaces
``eegflow/nn/pallas_attention.py`` ``_pool_head_fwd_kernel`` (entry
``_pool_head_fwd_call``, reached through ``pool_head_fused``).
:func:`pool_head_bwd` launches ``csrc/pool_head_bwd.cu``, which replaces
``_pool_head_bwd_kernel`` (entry ``_pool_head_bwd_call``). Each kernel
source says what bounds it on the card and how its design deals with that.
For CPU tensors a wrapper runs its plain PyTorch twin
(:func:`pool_head_fused_plain`, :func:`pool_head_bwd_plain`); for CUDA
tensors it launches the kernel or raises. :class:`PoolHead` is the
``torch.autograd.Function`` around the pair, as ``_pool_head_core``'s custom
VJP is in the reference.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import torch

from eegflow_torch import kernels
from eegflow_torch.nn.cuda_lstm import Parts, _ptr, _stream, as_parts
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


PoolGrads = Tuple[Tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor, torch.Tensor,
                  Optional[torch.Tensor], Optional[torch.Tensor]]


def pool_head_bwd_plain(ln_params: Optional[Mapping], attn_params: Mapping, xs: Parts,
                        weights: torch.Tensor, g_scores: torch.Tensor,
                        g_ctx: Sequence[torch.Tensor], gctx: torch.Tensor,
                        use_ln: bool = True, bf16: bool = False) -> PoolGrads:
    """Plain twin of the backward kernel: -> (dh parts, dW1 (D, K), db1 (K,),
    dw2 (K,), dgamma, dbeta) (the last two None without LN).

    ``weights``: softmax of the raw scores (B, T); ``g_scores`` (B, T) and
    ``g_ctx`` (parts of (B, D_p)): the upstream gradients; ``gctx`` (B,):
    sum_p g_p . ctx_p. The LayerNorm and the projection are recomputed as in
    :func:`pool_head_fused_plain`; y and u are rounded to bf16 before their
    products under ``bf16``.
    """
    xs = as_parts(xs)
    widths = [p.shape[-1] for p in xs]
    x = torch.cat([p.to(torch.float32) for p in xs], dim=-1)
    d_total = x.shape[-1]
    rnd = bf16_round if bf16 else (lambda t: t)
    if use_ln:
        mu = x.sum(-1, keepdim=True) / d_total
        var = (x * x).sum(-1, keepdim=True) / d_total - mu * mu
        rsig = torch.rsqrt(var + LN_EPS)
        xhat = (x - mu) * rsig
        y = xhat * ln_params["scale"] + ln_params["bias"]
    else:
        y = x
    w1 = attn_params["proj"]["w"]
    k = w1.shape[1]
    proj = torch.tanh(rnd(y) @ rnd(w1) + attn_params["proj"]["b"])
    g = torch.cat(list(g_ctx), dim=-1)
    gy = (y * g[:, None, :]).sum(-1)
    ds = weights * (gy - gctx[:, None]) + g_scores
    u = ds[..., None] * (1 - proj * proj) * attn_params["score"]["w"][:, 0]
    u16 = rnd(u)
    db1 = u.sum(dim=(0, 1))
    dw2 = (ds[..., None] * proj).sum(dim=(0, 1))
    dy = weights[..., None] * g[:, None, :] + u16 @ rnd(w1).t()
    dw1 = rnd(y).reshape(-1, d_total).t() @ u16.reshape(-1, k)
    if use_ln:
        dxh = dy * ln_params["scale"]
        m1 = dxh.sum(-1, keepdim=True) / d_total
        m2 = (dxh * xhat).sum(-1, keepdim=True) / d_total
        dh = rsig * (dxh - m1 - xhat * m2)
        dgamma, dbeta = (dy * xhat).sum(dim=(0, 1)), dy.sum(dim=(0, 1))
    else:
        dh, dgamma, dbeta = dy, None, None
    return tuple(dh.split(widths, dim=-1)), dw1, db1, dw2, dgamma, dbeta


def pool_head_bwd(ln_params: Optional[Mapping], attn_params: Mapping, xs: Parts,
                  weights: torch.Tensor, g_scores: torch.Tensor,
                  g_ctx: Sequence[torch.Tensor], gctx: torch.Tensor,
                  use_ln: bool = True, bf16: bool = False) -> PoolGrads:
    """Backward of :func:`pool_head_fused` (arguments as
    :func:`pool_head_bwd_plain`)."""
    xs = as_parts(xs)
    if xs[0].device.type == "cpu":
        return pool_head_bwd_plain(ln_params, attn_params, xs, weights, g_scores, g_ctx,
                                   gctx, use_ln, bf16)
    if xs[0].device.type != "cuda":
        raise ValueError(f"pool_head_bwd: unsupported device {xs[0].device}")
    _check_cuda_args(xs, ln_params, attn_params, use_ln)
    g_ctx = tuple(g_ctx)
    batch, steps = xs[0].shape[:2]
    widths = [x.shape[-1] for x in xs]
    d_total = sum(widths)
    for name, t, shape in (("weights", weights, (batch, steps)),
                           ("g_scores", g_scores, (batch, steps)), ("gctx", gctx, (batch,)),
                           *((f"g_ctx[{i}]", gp, (batch, w))
                             for i, (gp, w) in enumerate(zip(g_ctx, widths)))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != xs[0].device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {shape}")
    if len(g_ctx) != len(xs):
        raise ValueError("one context gradient per part")
    lib = kernels.load_library()
    dev = xs[0].device
    two = len(xs) == 2
    f32 = lambda t: t.to(torch.float32).contiguous()  # noqa: E731
    w1 = f32(attn_params["proj"]["w"])
    k = w1.shape[1]
    w1t = w1.t().contiguous()
    b1 = f32(attn_params["proj"]["b"])
    w2 = f32(attn_params["score"]["w"][:, 0])
    gamma = f32(ln_params["scale"]) if use_ln else None
    beta = f32(ln_params["bias"]) if use_ln else None
    dh = [torch.empty_like(x) for x in xs]
    dw1 = torch.empty(d_total, k, dtype=torch.float32, device=dev)
    vec = torch.empty(2 * k + 2 * d_total, dtype=torch.float32, device=dev)
    y_scr = torch.empty(batch, steps, d_total, dtype=torch.float32, device=dev)
    u_scr = torch.empty(batch, steps, k, dtype=torch.float32, device=dev)
    vec_part = torch.empty(batch, 2 * k + 2 * d_total, dtype=torch.float32, device=dev)
    splits = kernels.gemm_splits(batch * steps)
    part = torch.empty(splits * d_total * k, dtype=torch.float32, device=dev)
    err = lib.eegflow_pool_head_bwd(
        xs[0].data_ptr(), xs[1].data_ptr() if two else None,
        widths[0], widths[1] if two else 0, _ptr(gamma), _ptr(beta),
        w1.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        weights.data_ptr(), g_scores.data_ptr(), g_ctx[0].data_ptr(),
        g_ctx[1].data_ptr() if two else None, gctx.data_ptr(),
        dh[0].data_ptr(), dh[1].data_ptr() if two else None, dw1.data_ptr(), vec.data_ptr(),
        y_scr.data_ptr(), u_scr.data_ptr(), vec_part.data_ptr(), part.data_ptr(), splits,
        batch, steps, k, int(use_ln), int(bf16), _stream(dev))
    kernels.check(lib, err, "pool_head_bwd")
    kernels.launch_counts["pool_head_bwd"] += 1
    db1, dw2, dgamma, dbeta = vec.split([k, k, d_total, d_total])
    if not use_ln:
        dgamma = dbeta = None
    return tuple(dh), dw1, db1, dw2, dgamma, dbeta


class PoolHead(torch.autograd.Function):
    """LayerNorm + additive-attention pooling with its backward kernel.

    ``forward(kernel, use_ln, bf16, x0, x1, gamma, beta, w1, b1, w2) ->
    (*ctx_parts, raw_scores)``; ``w2`` is the score weight (K, 1). The score
    bias does not enter (softmax ignores it), so it gets no gradient here:
    the caller's optimizer sees a zero gradient for it, as the reference's
    VJP returns.
    """

    @staticmethod
    def forward(ctx, kernel, use_ln, bf16, x0, x1, gamma, beta, w1, b1, w2):
        xs = (x0,) if x1 is None else (x0, x1)
        ln = {"scale": gamma, "bias": beta} if use_ln else None
        attn = {"proj": {"w": w1, "b": b1}, "score": {"w": w2}}
        fwd = pool_head_fused if kernel else pool_head_fused_plain
        ctx_parts, scores = fwd(ln, attn, xs, use_ln, bf16)
        ctx.kernel, ctx.use_ln, ctx.bf16, ctx.two = kernel, use_ln, bf16, x1 is not None
        ctx.save_for_backward(x0, x1, gamma, beta, w1, b1, w2, scores, *ctx_parts)
        return (*ctx_parts, scores)

    @staticmethod
    def backward(ctx, *grads):
        x0, x1, gamma, beta, w1, b1, w2, scores, *ctx_parts = ctx.saved_tensors
        xs = (x0, x1) if ctx.two else (x0,)
        g_ctx = tuple(g.contiguous() for g in grads[:-1])
        g_scores = grads[-1].contiguous()
        weights = torch.softmax(scores, dim=-1)
        gctx = sum((gp * cp).sum(-1) for gp, cp in zip(g_ctx, ctx_parts))
        ln = {"scale": gamma, "bias": beta} if ctx.use_ln else None
        attn = {"proj": {"w": w1, "b": b1}, "score": {"w": w2}}
        bwd = pool_head_bwd if ctx.kernel else pool_head_bwd_plain
        dh, dw1, db1, dw2, dgamma, dbeta = bwd(ln, attn, xs, weights, g_scores, g_ctx,
                                               gctx.contiguous(), ctx.use_ln, ctx.bf16)
        return (None, None, None, dh[0], dh[1] if ctx.two else None, dgamma, dbeta,
                dw1, db1, dw2[:, None])


def pool_head(ln_params: Optional[Mapping], attn_params: Mapping, xs: Parts,
              use_ln: bool = True, bf16: bool = False, kernel: bool = False
              ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Differentiable :func:`pool_head_fused` (through :class:`PoolHead`) ->
    ``(ctx_parts, raw_scores)``."""
    xs = as_parts(xs)
    two = len(xs) == 2
    out = PoolHead.apply(kernel, use_ln, bf16, xs[0], xs[1] if two else None,
                         ln_params["scale"] if use_ln else None,
                         ln_params["bias"] if use_ln else None,
                         attn_params["proj"]["w"], attn_params["proj"]["b"],
                         attn_params["score"]["w"])
    return tuple(out[:-1]), out[-1]
