"""Three-state Active/Passive/Fatigued compartmental vector field
(``eegflow.ode.field``).

    dA/dt = -(k_ap + k_af) A + k_pa P + k_fa F
    dP/dt =  k_ap A - (k_pa + k_pf) P + k_fp F
    dF/dt =  k_af A + k_pf P - (k_fa + k_fp) F

Rate order everywhere: ``[k_ap, k_af, k_pa, k_pf, k_fa, k_fp]``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

RATE_NAMES: Tuple[str, ...] = ("k_ap", "k_af", "k_pa", "k_pf", "k_fa", "k_fp")

#: default rates
DEFAULT_RATES: Dict[str, float] = {
    "k_ap": 0.1, "k_af": 0.02, "k_pa": 0.15, "k_pf": 0.08, "k_fa": 0.05, "k_fp": 0.1,
}

STATE_NAMES: Tuple[str, ...] = ("Active", "Passive", "Fatigued")


def rates_to_array(params: Dict[str, float],
                   device: Optional[torch.device | str] = None) -> torch.Tensor:
    return torch.tensor([params[name] for name in RATE_NAMES], dtype=torch.float32,
                        device=device)


def rates_to_dict(k) -> Dict[str, float]:
    k = k.detach().cpu().numpy() if isinstance(k, torch.Tensor) else np.asarray(k)
    return {name: float(k[i]) for i, name in enumerate(RATE_NAMES)}


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


def steady_state(k: torch.Tensor) -> torch.Tensor:
    """Stationary distribution of ``k (..., 6)`` -> ``(..., 3)``: ``p @ Q = 0``
    with ``sum(p) = 1``, through the 3 x 3 normal equations of the 4 x 3
    system (batched over the leading axes), as the reference solves it."""
    q = transition_matrix(k)
    lead = q.shape[:-2]
    a = torch.cat([q.transpose(-1, -2), torch.ones(lead + (1, 3), dtype=q.dtype,
                                                  device=q.device)], dim=-2)
    b = torch.cat([torch.zeros(lead + (3,), dtype=q.dtype, device=q.device),
                   torch.ones(lead + (1,), dtype=q.dtype, device=q.device)], dim=-1)
    ata = torch.einsum("...ki,...kj->...ij", a, a)
    atb = torch.einsum("...ki,...k->...i", a, b)
    return torch.linalg.solve(ata, atb.unsqueeze(-1)).squeeze(-1)


def steady_state_numeric(k: torch.Tensor, t_end: float = 1000.0,
                         n_points: int = 1000) -> torch.Tensor:
    """The steady state by a long integration from (0.33, 0.33, 0.34), with
    the exact propagator as the reference integrates it."""
    from eegflow_torch.ode.integrate import solve

    y0 = torch.tensor([0.33, 0.33, 0.34], dtype=torch.float32, device=k.device)
    _, traj = solve(y0, (0.0, t_end), n_points, k, method="expm")
    return traj[-1]


def stability_analysis(k) -> Dict[str, object]:
    """Eigenvalues of Q^T on the host (numpy, float64 from the float32 Q the
    reference builds): stable when every real part is <= 0, and the dominant
    time constant -1 / max(Re lambda) over the non-conserved modes."""
    k = k.detach().cpu().numpy() if isinstance(k, torch.Tensor) else k
    q = transition_matrix(torch.as_tensor(np.asarray(k, np.float32))).numpy()
    eigvals = np.linalg.eigvals(q.astype(np.float64).T)
    # the conservation mode is 0 analytically; allow float fuzz
    stable = bool(np.all(eigvals.real <= 1e-6))
    nonzero = eigvals[np.abs(eigvals.real) > 1e-6]
    dominant = float(-1.0 / np.max(nonzero.real)) if len(nonzero) > 0 else float("inf")
    return {
        "eigenvalues_real": eigvals.real.tolist(),
        "eigenvalues_imag": eigvals.imag.tolist(),
        "is_stable": stable,
        "dominant_time_constant": dominant,
    }


def validate_rates(params: Dict[str, float]) -> Dict[str, object]:
    """Physiological-plausibility checks: the recovery / fatigue balance and
    very slow or very fast transitions, as warnings."""
    recovery = params["k_fa"] + params["k_fp"] + params["k_pa"]
    fatigue = params["k_af"] + params["k_pf"]
    balance = recovery / (fatigue + 1e-10)
    warnings = []
    if balance < 0.5:
        warnings.append("very high fatigue dominance (balance < 0.5)")
    elif balance > 5.0:
        warnings.append("very high recovery dominance (balance > 5.0)")
    for name, v in params.items():
        if v < 0.005:
            warnings.append(f"very slow transition {name}={v:.4f}")
        elif v > 0.4:
            warnings.append(f"very fast transition {name}={v:.4f}")
    return {"balance": balance, "warnings": warnings}
