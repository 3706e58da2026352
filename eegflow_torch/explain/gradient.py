"""Gradient-based channel attribution (``eegflow.explain.gradient``;
reference 07_explainability.py:203-284): per-sample gradient of the
predicted class's logit with respect to the input, |grad| averaged over
time, summed over ~100 samples, normalized to sum 1.

The whole batch of per-sample input gradients is one backward of the sum of
predicted-class logits (samples are independent, so d(sum_i logit_i)/dx_i is
each sample's own gradient), under the bf16 policy. With frozen weights only
the windows require grad; ``classifier_apply`` then takes its differentiable
path, which on the card runs the training-mode kernels without dropout and
their backward kernels down to the input block's dx.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from eegflow_torch.core.config import ModelConfig
from eegflow_torch.nn.model import classifier_apply


def batch_input_gradients(params, x: torch.Tensor, model_cfg: ModelConfig,
                          lstm_impl: str = "auto") -> torch.Tensor:
    """``x (B, T, C)`` -> d logit[predicted class] / dx, ``(B, T, C)``."""
    kw = dict(compute_dtype=torch.bfloat16, lstm_impl=lstm_impl)
    with torch.no_grad():
        pred = classifier_apply(params, x, model_cfg, **kw).argmax(dim=-1)
    x_in = x.detach().requires_grad_(True)
    with torch.enable_grad():
        logits = classifier_apply(params, x_in, model_cfg, **kw)
        (grad,) = torch.autograd.grad(logits.gather(1, pred[:, None]).sum(), x_in)
    return grad


def gradient_channel_importance(
    params,
    model_cfg: ModelConfig,
    x: np.ndarray,
    n_samples: int = 100,
    batch_size: int = 256,
    seed: int = 42,
    channel_names: Optional[Sequence[str]] = None,
    lstm_impl: str = "auto",
) -> Dict[str, object]:
    """Per-channel attribution scores, normalized to sum 1 (ref 07:203-284),
    on the device of ``params`` (a torch parameter tree)."""
    device = next(iter(params.parameters())).device
    rng = np.random.RandomState(seed)
    n_samples = min(n_samples, len(x))
    idx = rng.choice(len(x), n_samples, replace=False)
    subset = x[idx]

    n_channels = x.shape[2]
    importance = np.zeros(n_channels)
    for start in range(0, n_samples, batch_size):
        xb = torch.from_numpy(np.ascontiguousarray(subset[start: start + batch_size],
                                                   np.float32)).to(device)
        grads = batch_input_gradients(params, xb, model_cfg, lstm_impl).cpu().numpy()
        importance += np.abs(grads).mean(axis=1).sum(axis=0)  # mean time, sum samples
    importance /= n_samples
    importance = importance / importance.sum()

    names = list(channel_names) if channel_names else [
        f"Ch{i+1}" for i in range(n_channels)
    ]
    order = np.argsort(-importance)
    return {
        "channels": names,
        "importance": importance.tolist(),
        "ranking": [names[i] for i in order],
        "method": "gradient",
    }
