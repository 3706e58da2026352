"""Probabilistic LSTM->ODE rate modulation (``eegflow.couple.modulation``).

    k_af' = k_af (1 + alpha P_closed)    k_pf' = k_pf (1 + alpha P_closed)
    k_fa' = k_fa (1 + alpha P_open)      k_pa' = k_pa (1 + alpha P_open)

with every rate floored at ``floor``. Rate order:
``[k_ap, k_af, k_pa, k_pf, k_fa, k_fp]``.
"""

from __future__ import annotations

import torch

#: multiplier selector per rate: 0 unmodulated, 1 by P_closed, 2 by P_open
_MOD_KIND = (0, 1, 2, 1, 2, 0)

#: canonical initial states
_INIT_FATIGUED = (0.2, 0.2, 0.6)
_INIT_ACTIVE = (0.6, 0.2, 0.2)
_INIT_MIXED = (0.33, 0.34, 0.33)


def modulate_rates(k_base: torch.Tensor, p_closed: torch.Tensor, p_open: torch.Tensor,
                   alpha: float = 0.5, floor: float = 1e-3) -> torch.Tensor:
    """``k_base (6,)`` or ``(..., 6)``; probabilities ``(...,)`` -> ``(..., 6)``."""
    kind = torch.tensor(_MOD_KIND, device=k_base.device)
    mult_closed = 1.0 + alpha * p_closed[..., None]
    mult_open = 1.0 + alpha * p_open[..., None]
    one = torch.ones_like(mult_closed)
    mult = torch.where(kind == 1, mult_closed, torch.where(kind == 2, mult_open, one))
    return torch.clamp_min(k_base * mult, floor)


def infer_initial_state(p_closed: torch.Tensor, p_open: torch.Tensor,
                        threshold: float = 0.6) -> torch.Tensor:
    """P_closed > threshold -> mostly fatigued; P_open > threshold -> mostly
    active; else mixed. Returns ``(..., 3)``."""
    dev, dt = p_closed.device, p_closed.dtype
    fatigued = torch.tensor(_INIT_FATIGUED, device=dev, dtype=dt)
    active = torch.tensor(_INIT_ACTIVE, device=dev, dtype=dt)
    mixed = torch.tensor(_INIT_MIXED, device=dev, dtype=dt)
    return torch.where(p_closed[..., None] > threshold, fatigued,
                       torch.where(p_open[..., None] > threshold, active, mixed))
