"""Fused LSTM layer-direction forward (``eegflow.nn.pallas_lstm`` counterpart).

:func:`lstm_fwd_fused_proj` launches the hand-written CUDA kernel
``eegflow_torch/csrc/lstm_fwd.cu`` for CUDA tensors. It replaces
``eegflow/nn/pallas_lstm.py`` ``_fwd_proj_kernel`` (entry
``lstm_fwd_fused_proj``) in eval mode: ``need_residuals=False``, no dropout.
The kernel source says what bounds it on the card and how its design deals
with that. For CPU tensors the wrapper runs :func:`lstm_fwd_fused_proj_plain`,
the same function in plain PyTorch; for CUDA tensors it launches the kernel
or raises.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from eegflow_torch import kernels
from eegflow_torch.nn.layers import bf16_round

Parts = Union[torch.Tensor, Sequence[torch.Tensor]]


def as_parts(xs: Parts) -> Tuple[torch.Tensor, ...]:
    return (xs,) if isinstance(xs, torch.Tensor) else tuple(xs)


def _sigmoid(z: torch.Tensor) -> torch.Tensor:
    """sigmoid through the tanh identity, as the kernels evaluate it."""
    return 0.5 * torch.tanh(0.5 * z) + 0.5


def lstm_fwd_fused_proj_plain(xs: Parts, w_ih: torch.Tensor, b: torch.Tensor,
                              w_hh: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Plain twin of the kernel: parts (B, T, D_p) -> h (B, T, H) float32.

    z = b + sum_p bf16(x_p) . bf16(W_ih_p) + bf16(h) . bf16(W_hh), products
    accumulated in float32; W_ih is split by rows to match the parts.
    """
    xs = as_parts(xs)
    widths = [p.shape[-1] for p in xs]
    gates = b + sum(bf16_round(x) @ bf16_round(w)
                    for x, w in zip(xs, torch.split(w_ih, widths, dim=0)))
    batch, steps, _ = xs[0].shape
    hidden = w_hh.shape[0]
    whh = bf16_round(w_hh)
    h = torch.zeros(batch, hidden, dtype=torch.float32, device=xs[0].device)
    c = torch.zeros_like(h)
    out = torch.empty(batch, steps, hidden, dtype=torch.float32, device=xs[0].device)
    order = range(steps - 1, -1, -1) if reverse else range(steps)
    for t in order:
        z = gates[:, t] + bf16_round(h) @ whh
        i, f, g, o = z.split(hidden, dim=-1)
        c = _sigmoid(f) * c + _sigmoid(i) * torch.tanh(g)
        h = _sigmoid(o) * torch.tanh(c)
        out[:, t] = h
    return out


def _check_cuda_args(xs, w_ih, b, w_hh):
    dev = xs[0].device
    if len(xs) not in (1, 2):
        raise ValueError(f"lstm_fwd takes 1 or 2 input parts, got {len(xs)}")
    batch, steps = xs[0].shape[:2]
    for x in xs:
        if x.device != dev or x.dtype != torch.float32 or x.dim() != 3:
            raise ValueError("input parts must be float32 (B, T, D_p) on one device")
        if tuple(x.shape[:2]) != (batch, steps):
            raise ValueError("input parts disagree on (B, T)")
        if not x.is_contiguous():
            raise ValueError("input parts must be contiguous")
    hidden = w_hh.shape[0]
    d_total = sum(x.shape[-1] for x in xs)
    if tuple(w_hh.shape) != (hidden, 4 * hidden):
        raise ValueError(f"w_hh must be (H, 4H), got {tuple(w_hh.shape)}")
    if tuple(w_ih.shape) != (d_total, 4 * hidden):
        raise ValueError(f"w_ih must be ({d_total}, {4 * hidden}), got {tuple(w_ih.shape)}")
    if tuple(b.shape) != (4 * hidden,):
        raise ValueError(f"b must be ({4 * hidden},), got {tuple(b.shape)}")
    if hidden % 32 or hidden > 512:
        raise ValueError(f"the lstm_fwd kernel needs H % 32 == 0 and H <= 512, got {hidden}")
    for w in (w_ih, b, w_hh):
        if w.device != dev:
            raise ValueError("weights must be on the inputs' device")


def lstm_fwd_fused_proj(xs: Parts, w_ih: torch.Tensor, b: torch.Tensor,
                        w_hh: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """One LSTM direction over input parts (B, T, D_p) -> h (B, T, H) float32.

    Weights in the JAX layout: ``w_ih`` (sum D_p, 4H), ``b`` (4H,), ``w_hh``
    (H, 4H), gate order i, f, g, o. ``reverse`` walks t from T-1 down to 0
    and writes ``h[:, t]`` at its natural position.
    """
    xs = as_parts(xs)
    if xs[0].device.type == "cpu":
        return lstm_fwd_fused_proj_plain(xs, w_ih, b, w_hh, reverse)
    if xs[0].device.type != "cuda":
        raise ValueError(f"lstm_fwd: unsupported device {xs[0].device}")
    _check_cuda_args(xs, w_ih, b, w_hh)
    lib = kernels.load_library()
    dev = xs[0].device
    batch, steps = xs[0].shape[:2]
    hidden = w_hh.shape[0]
    widths = [x.shape[-1] for x in xs]
    w_parts = torch.split(w_ih.to(torch.bfloat16).contiguous(), widths, dim=0)
    whh = w_hh.to(torch.bfloat16).contiguous()
    bias = b.to(torch.float32).contiguous()
    out = torch.empty(batch, steps, hidden, dtype=torch.float32, device=dev)
    two = len(xs) == 2
    err = lib.eegflow_lstm_fwd(
        xs[0].data_ptr(), xs[1].data_ptr() if two else None,
        widths[0], widths[1] if two else 0,
        w_parts[0].data_ptr(), w_parts[1].data_ptr() if two else None,
        bias.data_ptr(), whh.data_ptr(), out.data_ptr(),
        batch, steps, hidden, int(reverse),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(lib, err, "lstm_fwd")
    kernels.launch_counts["lstm_fwd"] += 1
    return out
