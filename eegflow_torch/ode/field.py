"""Three-state Active/Passive/Fatigued compartmental vector field
(``eegflow.ode.field``).

    dA/dt = -(k_ap + k_af) A + k_pa P + k_fa F
    dP/dt =  k_ap A - (k_pa + k_pf) P + k_fp F
    dF/dt =  k_af A + k_pf P - (k_fa + k_fp) F

Rate order everywhere: ``[k_ap, k_af, k_pa, k_pf, k_fa, k_fp]``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

RATE_NAMES: Tuple[str, ...] = ("k_ap", "k_af", "k_pa", "k_pf", "k_fa", "k_fp")

#: default rates
DEFAULT_RATES: Dict[str, float] = {
    "k_ap": 0.1, "k_af": 0.02, "k_pa": 0.15, "k_pf": 0.08, "k_fa": 0.05, "k_fp": 0.1,
}


def rates_to_array(params: Dict[str, float],
                   device: Optional[torch.device | str] = None) -> torch.Tensor:
    return torch.tensor([params[name] for name in RATE_NAMES], dtype=torch.float32,
                        device=device)


def transition_matrix(k: torch.Tensor) -> torch.Tensor:
    """Rate matrix Q (rows = source state) for ``k (..., 6)`` -> ``(..., 3, 3)``;
    the field is ``dy/dt = y @ Q`` for a row-vector state ``y``."""
    k_ap, k_af, k_pa, k_pf, k_fa, k_fp = k.unbind(-1)
    row_a = torch.stack([-(k_ap + k_af), k_ap, k_af], dim=-1)
    row_p = torch.stack([k_pa, -(k_pa + k_pf), k_pf], dim=-1)
    row_f = torch.stack([k_fa, k_fp, -(k_fa + k_fp)], dim=-1)
    return torch.stack([row_a, row_p, row_f], dim=-2)


def apf_field(y: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """RHS for state ``y (..., 3)`` and rates ``k (..., 6)``; the state is
    clamped at 0 as in the reference RHS."""
    return torch.einsum("...i,...ij->...j", y.clamp_min(0.0), transition_matrix(k))
