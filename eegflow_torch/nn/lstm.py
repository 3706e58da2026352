"""Eager bidirectional LSTM stack (``eegflow.nn.lstm`` scan path).

The input projection ``x @ W_ih + b`` for all time steps is hoisted into one
matmul; a Python loop over time then runs the recurrence. Gate order i, f,
g, o; zero initial state; (h, c) stay float32; the reverse direction walks
time backwards and writes each state at its natural position.

This is the float32 algorithm oracle the port's LSTM kernels are held
against in the tests, and ``bilstm_stack_init`` builds the classifier's
stack. The classifier itself runs the kernels of
:mod:`eegflow_torch.nn.cuda_lstm` (or their twins) under both precision
policies.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Sequence

import torch

from eegflow_torch.nn.layers import dropout, matmul_policy


def lstm_layer_init(gen: torch.Generator, in_dim: int, hidden: int):
    """One direction; torch init U(-1/sqrt(H), 1/sqrt(H)). The fused bias is
    the sum of two independent uniforms, as torch's b_ih + b_hh."""
    bound = 1.0 / hidden ** 0.5

    def u(shape):
        return (torch.rand(shape, generator=gen) * 2 - 1) * bound

    return {
        "w_ih": u((in_dim, 4 * hidden)),
        "w_hh": u((hidden, 4 * hidden)),
        "b": u((4 * hidden,)) + u((4 * hidden,)),
    }


def bilstm_stack_init(gen: torch.Generator, in_dim: int, hidden: int,
                      num_layers: int, bidirectional: bool = True):
    layers = []
    d = in_dim
    for _ in range(num_layers):
        layer = {"fwd": lstm_layer_init(gen, d, hidden)}
        if bidirectional:
            layer["bwd"] = lstm_layer_init(gen, d, hidden)
        layers.append(layer)
        d = hidden * (2 if bidirectional else 1)
    return layers


def lstm_layer_apply(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                     reverse: bool = False,
                     compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One direction over (B, T, D) -> (B, T, H)."""
    w_ih, w_hh, b = params["w_ih"], params["w_hh"], params["b"]
    gates_all = matmul_policy(x, w_ih, compute_dtype) + b   # (B, T, 4H)
    batch, steps, _ = x.shape
    hidden = w_hh.shape[0]
    h = torch.zeros(batch, hidden, dtype=torch.float32, device=x.device)
    c = torch.zeros_like(h)
    out = torch.empty(batch, steps, hidden, dtype=torch.float32, device=x.device)
    order = range(steps - 1, -1, -1) if reverse else range(steps)
    for t in order:
        z = gates_all[:, t] + matmul_policy(h, w_hh, compute_dtype)
        i, f, g, o = z.split(hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[:, t] = h
    return out


def bilstm_stack_apply(layers: List[Mapping], x: torch.Tensor,
                       compute_dtype: Optional[torch.dtype] = None,
                       masks: Optional[Sequence[torch.Tensor]] = None,
                       rate: float = 0.0) -> torch.Tensor:
    """(B, T, D) -> (B, T, H * n_dir). ``masks[i]`` (B, T, H * n_dir), when
    given, is the keep-mask of inter-layer dropout (``rate``) on layer i's
    output, for every layer but the last, as torch's ``nn.LSTM`` drops."""
    out = x
    for idx, layer in enumerate(layers):
        fwd = lstm_layer_apply(layer["fwd"], out, False, compute_dtype)
        if "bwd" in layer:
            bwd = lstm_layer_apply(layer["bwd"], out, True, compute_dtype)
            out = torch.cat([fwd, bwd], dim=-1)
        else:
            out = fwd
        if masks is not None and idx < len(masks):
            out = dropout(out, rate, masks[idx])
    return out
