"""Integrators of the APF system (``eegflow.ode.integrate``).

* :func:`rk4_solve`: classic RK4 with ``substeps`` per output interval, for
  a batch of initial states and rate vectors at once; on the card one launch
  of kernel 11 (:mod:`eegflow_torch.ode.cuda_ode`).
* :func:`expm_solve`: the exact propagator ``expm(Q^T dt)`` for constant
  rates (scaling, order-12 Taylor, 4 squarings; no solves), then a loop
  applying it; :func:`expm_solve_piecewise` builds one propagator per
  segment for piecewise-constant rates.
* :func:`solve`, :func:`solve_batch`, :func:`solve_with_modulation`: the
  reference's wrappers (initial-state normalisation, linspace grid, final
  clip to [0, 1] and renormalisation).
* :func:`rk4_solve_modulated`: RK4 with rates from a Python ``rate_fn(t)``
  at the stage times, in plain torch (no kernel can call back into
  Python).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from eegflow_torch.ode.cuda_ode import rk4_trajectory, step_sizes
from eegflow_torch.ode.field import (DEFAULT_RATES, RATE_NAMES, apf_field, rates_to_array,
                                     transition_matrix)


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


def rk4_solve(y0: torch.Tensor, t0: float, t1: float, n_points: int, k: torch.Tensor,
              substeps: int = 16) -> torch.Tensor:
    """RK4 on the ``linspace(t0, t1, n_points)`` grid, ``substeps`` steps per
    output interval. ``y0 (..., 3)`` and ``k (..., 6)`` broadcast over their
    leading axes -> ``(n_points, ..., 3)``, the initial point first."""
    k = torch.as_tensor(k, dtype=torch.float32)
    y0 = torch.as_tensor(y0, dtype=torch.float32, device=k.device)
    batch = torch.broadcast_shapes(y0.shape[:-1], k.shape[:-1])
    traj = rk4_trajectory(y0.expand(batch + (3,)).reshape(-1, 3),
                          k.expand(batch + (6,)).reshape(-1, 6), n_points, substeps,
                          step_sizes(t0, t1, n_points, substeps))
    return traj.reshape((n_points,) + tuple(batch) + (3,))


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


def expm_solve_piecewise(y0: torch.Tensor, t0: float, t1: float, n_points: int,
                         ks: torch.Tensor) -> torch.Tensor:
    """Piecewise-constant rates, ``ks (n_points - 1, ..., 6)`` one rate vector
    per segment of the grid: all segment propagators in one batched Taylor
    evaluation, then a loop applying them -> ``(n_points, ..., 3)``."""
    if ks.shape[0] != n_points - 1:
        raise ValueError(f"ks must carry one rate vector per segment: "
                         f"{ks.shape[0]} != {n_points - 1}")
    dt = (t1 - t0) / max(n_points - 1, 1)
    props = _expm_taylor(transition_matrix(ks).transpose(-1, -2) * dt)  # (S, ..., 3, 3)
    y = torch.broadcast_to(torch.as_tensor(y0, dtype=ks.dtype, device=ks.device),
                           props.shape[1:-2] + (3,))
    traj = [y]
    for prop in props:
        y = (prop @ y[..., None])[..., 0]
        traj.append(y)
    return torch.stack(traj, dim=0)


def _project_simplex(traj: torch.Tensor) -> torch.Tensor:
    """Clip to [0, 1] then renormalise rows to sum 1."""
    traj = traj.clamp(0.0, 1.0)
    return traj / traj.sum(dim=-1, keepdim=True)


def _rates_and_state(initial_state, k, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """k (default rates when None) and the normalised float32 initial state
    on one device: k's, the initial state's, else ``device`` (the card by
    default)."""
    if isinstance(k, torch.Tensor):
        device = k.device
    elif isinstance(initial_state, torch.Tensor):
        device = initial_state.device
    device = torch.device(device or "cuda")
    k = rates_to_array(DEFAULT_RATES, device) if k is None else torch.as_tensor(
        k, dtype=torch.float32, device=device)
    y0 = torch.as_tensor(initial_state, dtype=torch.float32, device=device)
    return k, y0 / y0.sum(dim=-1, keepdim=True)


def solve(initial_state, t_span: Tuple[float, float], n_points: int = 100,
          k: Optional[torch.Tensor] = None, method: str = "rk4", substeps: int = 16,
          device: Optional[torch.device | str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``solve``: normalise the initial state, integrate on
    ``linspace(*t_span, n_points)``, clip and renormalise -> ``(t,
    trajectory (n_points, ..., 3))``. Runs on k's device, or the initial
    state's, else ``device``."""
    k, y0 = _rates_and_state(initial_state, k, device)
    t = torch.linspace(t_span[0], t_span[1], n_points, dtype=torch.float32, device=k.device)
    if method == "expm":
        traj = expm_solve(y0, t_span[0], t_span[1], n_points, k)
    else:
        traj = rk4_solve(y0, t_span[0], t_span[1], n_points, k, substeps=substeps)
    return t, _project_simplex(traj)


def solve_batch(y0: torch.Tensor, t0: float, t1: float, n_points: int,
                k: torch.Tensor, method: str = "expm", substeps: int = 16) -> torch.Tensor:
    """Batched solve: ``y0 (B, 3)``, ``k (B, 6)`` -> ``(B, n_points, 3)``,
    projected onto the simplex; ``method`` ``"expm"`` or ``"rk4"``."""
    y0 = y0 / y0.sum(dim=-1, keepdim=True)
    if method == "expm":
        traj = expm_solve(y0, t0, t1, n_points, k)
    else:
        traj = rk4_solve(y0, t0, t1, n_points, k, substeps=substeps)
    return _project_simplex(traj).movedim(0, 1)


def solve_with_modulation(initial_state, t_span: Tuple[float, float], modulation_func,
                          n_points: int = 100, k: Optional[torch.Tensor] = None,
                          method: str = "rk4", substeps: int = 16,
                          device: Optional[torch.device | str] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Time-varying rates: ``modulation_func(t, rates)`` gets the time and the
    base rate dict (keys ``RATE_NAMES``) and returns the modified dict.

    ``"rk4"``: non-autonomous RK4 with the rates at the stage times (``t`` a
    0-d float32 tensor, so the function uses torch ops or arithmetic on it).
    ``"expm"``: rates sampled at the segment midpoints (Python floats) and
    integrated exactly per segment. -> ``(t, solution)``, clipped and
    renormalised."""
    k, y0 = _rates_and_state(initial_state, k, device)
    base = {name: k[..., i] for i, name in enumerate(RATE_NAMES)}
    t = torch.linspace(t_span[0], t_span[1], n_points, dtype=torch.float32, device=k.device)

    def rate_fn(tt):
        mod = modulation_func(tt, dict(base))
        return torch.stack([torch.as_tensor(mod[name], dtype=torch.float32, device=k.device)
                            for name in RATE_NAMES], dim=-1)

    if method == "expm":
        t_np = t.cpu().numpy()
        mids = 0.5 * (t_np[:-1] + t_np[1:])
        ks = torch.stack([rate_fn(float(tt)) for tt in mids])  # (S, 6)
        return t, _project_simplex(expm_solve_piecewise(y0, t_span[0], t_span[1], n_points,
                                                        ks))
    return t, rk4_solve_modulated(y0, t_span[0], t_span[1], n_points, rate_fn,
                                  substeps=substeps)


def rk4_solve_modulated(y0: torch.Tensor, t0: float, t1: float, n_points: int,
                        rate_fn: Callable[[torch.Tensor], torch.Tensor],
                        substeps: int = 16) -> torch.Tensor:
    """RK4 with rates ``k = rate_fn(t)`` at the stage times (``t`` a 0-d
    float32 tensor) -> the clipped, renormalised trajectory
    ``(n_points, ..., 3)``. Plain torch: one small launch per operation."""
    dt = (t1 - t0) / max(n_points - 1, 1) / substeps
    y = y0 / y0.sum(dim=-1, keepdim=True)
    t = torch.tensor(t0, dtype=y.dtype, device=y.device)
    traj = [y]
    for _ in range(n_points - 1):
        for _ in range(substeps):
            f1 = apf_field(y, rate_fn(t))
            f2 = apf_field(y + 0.5 * dt * f1, rate_fn(t + 0.5 * dt))
            f3 = apf_field(y + 0.5 * dt * f2, rate_fn(t + 0.5 * dt))
            f4 = apf_field(y + dt * f3, rate_fn(t + dt))
            y = y + (dt / 6.0) * (f1 + 2 * f2 + 2 * f3 + f4)
            t = t + dt
        traj.append(y)
    return _project_simplex(torch.stack(traj, dim=0))

