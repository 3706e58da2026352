"""Exact-propagator integration of the APF system (``eegflow.ode.integrate``).

For constant rates the solution is ``y(t + dt) = expm(Q^T dt) y(t)``: one
matrix exponential per sample (scaling, order-12 Taylor, 4 squarings — no
solves), then a loop applying the propagator. The RK4 integrator for
modulated rates is not ported yet.
"""

from __future__ import annotations

import torch

from eegflow_torch.ode.field import transition_matrix


def _expm_taylor(a: torch.Tensor, order: int = 12, squarings: int = 4) -> torch.Tensor:
    """Batched matrix exponential: scale by 2^-squarings, Horner-sum the
    Taylor series, square back."""
    a = a / (2.0 ** squarings)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device).expand(a.shape)
    result = eye
    for n in range(order, 0, -1):
        result = eye + (a / n) @ result
    for _ in range(squarings):
        result = result @ result
    return result


def expm_solve(y0: torch.Tensor, t0: float, t1: float, n_points: int,
               k: torch.Tensor) -> torch.Tensor:
    """``y0 (..., 3)``, ``k (..., 6)`` -> trajectory ``(n_points, ..., 3)`` on
    ``linspace(t0, t1, n_points)``, including the initial point."""
    dt = (t1 - t0) / max(n_points - 1, 1)
    q = transition_matrix(k)
    prop = _expm_taylor(q.transpose(-1, -2) * dt)  # (..., 3, 3)
    y = torch.broadcast_to(y0, q.shape[:-2] + (3,))
    traj = [y]
    for _ in range(n_points - 1):
        y = (prop @ y[..., None])[..., 0]
        traj.append(y)
    return torch.stack(traj, dim=0)


def _project_simplex(traj: torch.Tensor) -> torch.Tensor:
    """Clip to [0, 1] then renormalise rows to sum 1."""
    traj = traj.clamp(0.0, 1.0)
    return traj / traj.sum(dim=-1, keepdim=True)


def solve_batch(y0: torch.Tensor, t0: float, t1: float, n_points: int,
                k: torch.Tensor, method: str = "expm") -> torch.Tensor:
    """Batched solve: ``y0 (B, 3)``, ``k (B, 6)`` -> ``(B, n_points, 3)``,
    projected onto the simplex."""
    if method != "expm":
        raise NotImplementedError(f"method {method!r} is not ported; use 'expm'")
    y0 = y0 / y0.sum(dim=-1, keepdim=True)
    traj = expm_solve(y0, t0, t1, n_points, k)
    return _project_simplex(traj).movedim(0, 1)
