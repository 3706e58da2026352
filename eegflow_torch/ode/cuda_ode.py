"""Batched fixed-step RK4 of the APF system, one candidate per thread
(kernel 11, ``eegflow_torch/csrc/apf_rk4.cu``).

It replaces two loops the JAX package compiles into single XLA programs:
the ``lax.scan`` over output intervals with its ``lax.fori_loop`` over RK4
substeps in ``rk4_solve`` (``eegflow/ode/integrate.py:41-68``), and the loss
body of ``make_fit_loss`` over it (``eegflow/fit/evolution.py:52-62``). In
eager PyTorch those loops are one launch per serial step; here each is one
launch. Two modes:

* trajectory, :func:`rk4_trajectory`: ``(n_points, B, 3)``;
* fit loss, :func:`rk4_fit_loss`: at each output point clip to [0, 1],
  renormalise and add the squared error against the observed proportions;
  ``mean + reg_weight * sum(k^2)`` per candidate, and with ``grad`` also
  the exact gradient of that discrete loss from forward tangents dy/dk
  (3 x 6 per candidate) carried through the clamp, the clip and the
  renormalisation.

For CPU tensors a wrapper runs its plain twin (:func:`rk4_trajectory_plain`,
:func:`rk4_fit_loss_plain`), the same arithmetic as torch ops; for CUDA
tensors it launches the kernel or raises. :class:`Rk4FitLoss` is the
``torch.autograd.Function`` around the loss mode: its forward keeps dloss/dk
from the same launch and its backward scales it.

The step keeps ``_rk4_step``'s expression order (``integrate.py:32-37``) and
the field clamps y at 0 (``eegflow/ode/field.py:57-66``); at a component
exactly 0 the tangent takes the clamp's slope as 0 (JAX's ``maximum`` splits
it 0.5/0.5 at a tie), and the clip's slope at 0 and 1 likewise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from eegflow_torch import kernels
from eegflow_torch.ode.field import transition_matrix

#: d(field)/dk for a unit state: _RATE_FLOW[i, j, m] is the rate of change of
#: state j per unit of state i when rate m grows by one. Rate m moves mass
#: from its source state to its destination:
#: k_ap A->P, k_af A->F, k_pa P->A, k_pf P->F, k_fa F->A, k_fp F->P.
_FLOWS = ((0, 1), (0, 2), (1, 0), (1, 2), (2, 0), (2, 1))
_RATE_FLOW = np.zeros((3, 3, 6), np.float32)
for _m, (_src, _dst) in enumerate(_FLOWS):
    _RATE_FLOW[_src, _dst, _m] = 1.0
    _RATE_FLOW[_src, _src, _m] = -1.0


class StepSizes(NamedTuple):
    """The RK4 step's constants in float32, as the reference's traced
    arithmetic forms them: dt = (t1 - t0) / max(n_points - 1, 1) / substeps,
    0.5 * dt and dt / 6."""

    half: float
    full: float
    sixth: float


def step_sizes(t0: float, t1: float, n_points: int, substeps: int) -> StepSizes:
    f32 = np.float32
    dt_out = (f32(t1) - f32(t0)) / f32(max(n_points - 1, 1))
    dt = f32(dt_out / f32(substeps))
    return StepSizes(float(f32(0.5) * dt), float(dt), float(dt / f32(6.0)))


def _field(y: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """max(y, 0) @ Q for row states y (B, 1, 3) and Q (B, 3, 3)."""
    return torch.bmm(y.clamp_min(0.0), q)


def _field_tangent(y: torch.Tensor, tan: torch.Tensor, q_t: torch.Tensor,
                   flow: torch.Tensor) -> torch.Tensor:
    """d(field)/dk (B, 3, 6) at y (B, 1, 3) with tangents dy/dk (B, 3, 6):
    Q^T (mask * dy/dk) + max(y, 0) . dQ/dk."""
    masked = tan * (y > 0.0).to(tan.dtype).transpose(1, 2)
    by_rate = (y.clamp_min(0.0) @ flow).view(-1, 3, 6)
    return torch.baddbmm(by_rate, q_t, masked)


def _rk4_steps(y, tan, q, q_t, flow, h: StepSizes, substeps: int):
    """``substeps`` RK4 steps of y (B, 1, 3) (and of its tangents when
    ``tan`` is not None), in ``_rk4_step``'s order; ``y + c * f`` is one
    fused multiply-add, as the kernel's compiler contracts it."""
    for _ in range(substeps):
        f1 = _field(y, q)
        y2 = torch.add(y, f1, alpha=h.half)
        f2 = _field(y2, q)
        y3 = torch.add(y, f2, alpha=h.half)
        f3 = _field(y3, q)
        y4 = torch.add(y, f3, alpha=h.full)
        f4 = _field(y4, q)
        if tan is not None:
            g1 = _field_tangent(y, tan, q_t, flow)
            g2 = _field_tangent(y2, torch.add(tan, g1, alpha=h.half), q_t, flow)
            g3 = _field_tangent(y3, torch.add(tan, g2, alpha=h.half), q_t, flow)
            g4 = _field_tangent(y4, torch.add(tan, g3, alpha=h.full), q_t, flow)
            gsum = torch.add(torch.add(torch.add(g1, g2, alpha=2.0), g3, alpha=2.0), g4)
            tan = torch.add(tan, gsum, alpha=h.sixth)
        fsum = torch.add(torch.add(torch.add(f1, f2, alpha=2.0), f3, alpha=2.0), f4)
        y = torch.add(y, fsum, alpha=h.sixth)
    return y, tan


def rk4_trajectory_plain(y0: torch.Tensor, k: torch.Tensor, n_points: int, substeps: int,
                         h: StepSizes) -> torch.Tensor:
    """Twin of :func:`rk4_trajectory`: y0 (B, 3), k (B, 6) -> (n_points, B, 3),
    the initial point first."""
    q = transition_matrix(k)
    y = y0.unsqueeze(1)
    traj = [y]
    for _ in range(n_points - 1):
        y, _ = _rk4_steps(y, None, q, None, None, h, substeps)
        traj.append(y)
    return torch.cat(traj, dim=1).transpose(0, 1)


def rk4_fit_loss_plain(k: torch.Tensor, y0: torch.Tensor, observed: torch.Tensor,
                       substeps: int, h: StepSizes, reg_weight: float, grad: bool = False
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Twin of :func:`rk4_fit_loss`: k (B, 6), y0 (3,), observed (n_points, 3)
    -> (loss (B,), dloss/dk (B, 6) or None)."""
    batch, n_points = k.shape[0], observed.shape[0]
    q = transition_matrix(k)
    y = y0.expand(batch, 1, 3)
    tan = q_t = flow = None
    if grad:
        tan = torch.zeros(batch, 3, 6, dtype=k.dtype, device=k.device)
        q_t = q.transpose(1, 2)
        flow = torch.from_numpy(_RATE_FLOW).to(k.device).view(3, 18)
        g = torch.zeros(batch, 6, dtype=k.dtype, device=k.device)
    acc = torch.zeros(batch, dtype=k.dtype, device=k.device)
    for i in range(n_points):
        if i:
            y, tan = _rk4_steps(y, tan, q, q_t, flow, h, substeps)
        c = y[:, 0].clamp(0.0, 1.0)
        s = c.sum(-1, keepdim=True)
        p = c / s
        e = p - observed[i]
        acc = acc + (e * e).sum(-1)
        if grad:
            d = (e - (e * p).sum(-1, keepdim=True)) * ((c > 0.0) & (c < 1.0)).to(k.dtype)
            g = g + (2.0 / s) * torch.bmm(d.unsqueeze(1), tan).squeeze(1)
    count = float(3 * n_points)
    loss = acc / count + reg_weight * (k * k).sum(-1)
    return loss, (g / count + (2.0 * reg_weight) * k) if grad else None


def _check(k: torch.Tensor, y0: torch.Tensor) -> None:
    if k.dtype != torch.float32 or k.dim() != 2 or k.shape[1] != 6:
        raise ValueError(f"k must be float32 (B, 6), got {k.dtype} {tuple(k.shape)}")
    if y0.dtype != torch.float32 or y0.shape[-1] != 3 or y0.device != k.device:
        raise ValueError("y0 must be float32 (..., 3) on k's device")


def rk4_trajectory(y0: torch.Tensor, k: torch.Tensor, n_points: int, substeps: int,
                   h: StepSizes) -> torch.Tensor:
    """Kernel 11, trajectory mode: y0 (B, 3) or (3,) for every candidate,
    k (B, 6) float32 -> (n_points, B, 3). The kernel has no gradient: CUDA
    inputs that require one raise (the fit's gradient is
    :class:`Rk4FitLoss`)."""
    if k.device.type == "cpu":
        return rk4_trajectory_plain(y0.expand(k.shape[0], 3), k, n_points, substeps, h)
    _check(k, y0)
    if k.requires_grad or y0.requires_grad:
        raise ValueError("rk4_trajectory: the kernel's trajectory mode has no gradient")
    if y0.dim() == 2 and y0.shape[0] != k.shape[0]:
        raise ValueError(f"y0 must be (3,) or ({k.shape[0]}, 3)")
    batch = k.shape[0]
    k, y0 = k.contiguous(), y0.contiguous()
    traj = torch.empty(n_points, batch, 3, dtype=torch.float32, device=k.device)
    lib = kernels.load_library()
    err = lib.eegflow_apf_rk4(y0.data_ptr(), 3 if y0.dim() == 2 else 0, k.data_ptr(), batch,
                              n_points, substeps, h.half, h.full, h.sixth, traj.data_ptr(),
                              None, 0.0, None, None, kernels.stream(k.device))
    kernels.check(lib, err, "apf_rk4")
    kernels.launch_counts["apf_rk4"] += 1
    return traj


def rk4_fit_loss(k: torch.Tensor, y0: torch.Tensor, observed: torch.Tensor, substeps: int,
                 h: StepSizes, reg_weight: float, grad: bool = False
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Kernel 11, fit-loss mode: k (B, 6), the initial state y0 (3,), the
    observed proportions (n_points, 3) -> (loss (B,), dloss/dk (B, 6) with
    ``grad``, else None), float32."""
    if k.device.type == "cpu":
        return rk4_fit_loss_plain(k, y0, observed, substeps, h, reg_weight, grad)
    _check(k, y0)
    n_points = observed.shape[0]
    if (observed.dtype != torch.float32 or observed.device != k.device
            or tuple(observed.shape) != (n_points, 3) or y0.dim() != 1):
        raise ValueError("observed must be float32 (n_points, 3) and y0 (3,) on k's device")
    batch = k.shape[0]
    # held in locals until the launch is queued
    k, y0, observed = k.detach().contiguous(), y0.contiguous(), observed.contiguous()
    loss = torch.empty(batch, dtype=torch.float32, device=k.device)
    dk = torch.empty(batch, 6, dtype=torch.float32, device=k.device) if grad else None
    lib = kernels.load_library()
    err = lib.eegflow_apf_rk4(y0.data_ptr(), 0, k.data_ptr(), batch, n_points, substeps,
                              h.half, h.full, h.sixth, None, observed.data_ptr(), reg_weight,
                              loss.data_ptr(), None if dk is None else dk.data_ptr(),
                              kernels.stream(k.device))
    kernels.check(lib, err, "apf_rk4")
    kernels.launch_counts["apf_rk4"] += 1
    return loss, dk


class Rk4FitLoss(torch.autograd.Function):
    """``forward(k, y0, observed, substeps, h, reg_weight) -> loss (B,)``
    through :func:`rk4_fit_loss`; when k needs a gradient the same launch
    also gives dloss/dk, which the backward scales by ``grad_output``."""

    @staticmethod
    def forward(ctx, k, y0, observed, substeps, h, reg_weight):
        loss, dk = rk4_fit_loss(k.detach(), y0, observed, substeps, h, reg_weight,
                                grad=ctx.needs_input_grad[0])
        if dk is not None:
            ctx.save_for_backward(dk)
        return loss

    @staticmethod
    def backward(ctx, grad_output):
        (dk,) = ctx.saved_tensors
        return grad_output.unsqueeze(-1) * dk, None, None, None, None, None
