"""Classification losses (``eegflow.nn.losses``).

* :func:`cross_entropy_loss` — class-weighted cross-entropy with torch
  semantics: per-sample weights w[y], mean normalised by the sum of weights.
* :func:`focal_loss` — (1 - p_t)^gamma times the cross-entropy, optional
  per-class alpha.
"""

from __future__ import annotations

from typing import Optional

import torch


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    log_probs = torch.log_softmax(logits, dim=-1)
    return -log_probs.gather(-1, labels[:, None].long())[:, 0]


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       class_weights: Optional[torch.Tensor] = None,
                       denominator: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted CE: logits (B, C), int labels (B,) -> scalar.
    ``denominator`` replaces the sum of the weights (the count without
    weights): a data-parallel rank divides its rows' sum by the whole
    batch's (``train.steps.make_train_step(mesh=)``)."""
    nll = _nll(logits, labels)
    if class_weights is None:
        return nll.mean() if denominator is None else nll.sum() / denominator
    w = class_weights[labels.long()]
    return (w * nll).sum() / (w.sum() if denominator is None else denominator)


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, gamma: float = 2.0,
               alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Focal loss: mean over (1 - p_t)^gamma * CE, optional per-class alpha."""
    ce = _nll(logits, labels)
    pt = torch.exp(-ce)
    fl = (1.0 - pt) ** gamma * ce
    if alpha is not None:
        fl = alpha[labels.long()] * fl
    return fl.mean()
