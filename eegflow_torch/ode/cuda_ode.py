"""Batched fixed-step RK4 of the APF system, one candidate per thread, and
the differential evolution that fits its rates (kernel 11,
``eegflow_torch/csrc/apf_rk4.cu``).

It replaces three loops the JAX package compiles into single XLA programs:
the ``lax.scan`` over output intervals with its ``lax.fori_loop`` over RK4
substeps in ``rk4_solve`` (``eegflow/ode/integrate.py:41-68``), the loss
body of ``make_fit_loss`` over it (``eegflow/fit/evolution.py:52-62``) and
the ``lax.while_loop`` over DE generations in ``_de_minimize``
(``eegflow/fit/evolution.py:83-134``). In eager PyTorch the first two are
one launch per serial step and the third ~30 launches and a host
synchronisation a generation; here each is one launch (the DE one a chunk
of generations). Modes:

* trajectory, :func:`rk4_trajectory`: ``(n_points, B, 3)``;
* fit loss, :func:`rk4_fit_loss`: at each output point clip to [0, 1],
  renormalise and add the squared error against the observed proportions;
  ``mean + reg_weight * sum(k^2)`` per candidate, and with ``grad`` also
  the exact gradient of that discrete loss from forward tangents dy/dk
  (3 x 6 per candidate) carried through the clamp, the clip and the
  renormalisation;
* DE, :func:`de_generations`: up to G generations of best1bin DE over a
  population of any size the card holds at once, on random numbers drawn
  by the host (:class:`GenerationDraws`), the trials' losses through the
  fit-loss mode's own device function (the same bits); its launch
  (:func:`de_plan`) comes from the C entry ``eegflow_apf_de_plan``.

For CPU tensors a wrapper runs its plain twin (:func:`rk4_trajectory_plain`,
:func:`rk4_fit_loss_plain`, :func:`de_generations_plain`), the same
arithmetic as torch ops; for CUDA tensors it launches the kernel or raises.
:class:`Rk4FitLoss` is the ``torch.autograd.Function`` around the loss mode:
its forward keeps dloss/dk from the same launch and its backward scales it.

The step uses that the field ``max(y, 0) @ Q`` (``eegflow/ode/field.py:57-66``)
is linear in ``max(y, 0)``: with ``p_k = max(y_k, 0)`` the stage points are
``y + p_k @ (c Q)`` and the step ``y + (((p_1 + 2 p_2) + 2 p_3) + p_4) @ (h/6
Q)``, the step sizes folded into Q once a candidate. That is ``_rk4_step``
(``integrate.py:32-37``) reassociated, and the twins keep this order. At a
component exactly 0 the tangent takes the clamp's slope as 0 (JAX's
``maximum`` splits it 0.5/0.5 at a tie), and the clip's slope at 0 and 1
likewise.

The DE's two rules that a reduction's order could decide are written out,
the same in the kernel and in :func:`de_generations_plain`: a member's two
partners are its row's two least draws, ties to the lower index (the
reference's stable ``argsort``), and the convergence statistic is taken in
float64 in candidate order (:func:`de_converged`); the best member is the
lowest index of the least loss (:func:`de_best`).
"""

from __future__ import annotations

import ctypes
import math
import re
from typing import Callable, List, NamedTuple, Optional, Tuple

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


def _scaled_rates(k: torch.Tensor, h: StepSizes):
    """Q (B, 3, 3) times h/2, h and h/6, each product rounded to float32 as
    the kernel rounds it once a candidate."""
    q = transition_matrix(k)
    return q * h.half, q * h.full, q * h.sixth


def _masked(y: torch.Tensor, tan: torch.Tensor) -> torch.Tensor:
    """The tangents of max(y, 0): dy/dk (B, 3, 6) where y (B, 1, 3) > 0, else 0."""
    return tan * (y > 0.0).to(tan.dtype).transpose(1, 2)


def _tangent_to(tan, dpos, qc_t, pos, step: float, flow):
    """The tangents of ``y + pos @ (step Q)`` for dpos = d(pos)/dk:
    dy/dk + (step Q)^T dpos + step pos . dQ/dk."""
    return torch.baddbmm(tan, qc_t, dpos) + ((pos * step) @ flow).view(-1, 3, 6)


def _rk4_steps(y, tan, scaled, flow, h: StepSizes, substeps: int):
    """``substeps`` RK4 steps of y (B, 1, 3) (and of its tangents when
    ``tan`` is not None) in the kernel's order: p_k = max(y_k, 0), the
    stage points y + p_k @ (c Q), the step y + (((p_1 + 2 p_2) + 2 p_3) +
    p_4) @ (h/6 Q)."""
    qh, qf, qs = scaled
    for _ in range(substeps):
        p1 = y.clamp_min(0.0)
        y2 = torch.baddbmm(y, p1, qh)
        p2 = y2.clamp_min(0.0)
        y3 = torch.baddbmm(y, p2, qh)
        p3 = y3.clamp_min(0.0)
        y4 = torch.baddbmm(y, p3, qf)
        p4 = y4.clamp_min(0.0)
        psum = torch.add(torch.add(torch.add(p1, p2, alpha=2.0), p3, alpha=2.0), p4)
        if tan is not None:
            d1 = _masked(y, tan)
            d2 = _masked(y2, _tangent_to(tan, d1, qh.transpose(1, 2), p1, h.half, flow))
            d3 = _masked(y3, _tangent_to(tan, d2, qh.transpose(1, 2), p2, h.half, flow))
            d4 = _masked(y4, _tangent_to(tan, d3, qf.transpose(1, 2), p3, h.full, flow))
            dsum = torch.add(torch.add(torch.add(d1, d2, alpha=2.0), d3, alpha=2.0), d4)
            tan = _tangent_to(tan, dsum, qs.transpose(1, 2), psum, h.sixth, flow)
        y = torch.baddbmm(y, psum, qs)
    return y, tan


def rk4_trajectory_plain(y0: torch.Tensor, k: torch.Tensor, n_points: int, substeps: int,
                         h: StepSizes) -> torch.Tensor:
    """Twin of :func:`rk4_trajectory`: y0 (B, 3), k (B, 6) -> (n_points, B, 3),
    the initial point first."""
    scaled = _scaled_rates(k, h)
    y = y0.unsqueeze(1)
    traj = [y]
    for _ in range(n_points - 1):
        y, _ = _rk4_steps(y, None, scaled, None, h, substeps)
        traj.append(y)
    return torch.cat(traj, dim=1).transpose(0, 1)


def rk4_fit_loss_plain(k: torch.Tensor, y0: torch.Tensor, observed: torch.Tensor,
                       substeps: int, h: StepSizes, reg_weight: float, grad: bool = False
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Twin of :func:`rk4_fit_loss`: k (B, 6), y0 (3,), observed (n_points, 3)
    -> (loss (B,), dloss/dk (B, 6) or None)."""
    batch, n_points = k.shape[0], observed.shape[0]
    scaled = _scaled_rates(k, h)
    y = y0.expand(batch, 1, 3)
    tan = flow = None
    if grad:
        tan = torch.zeros(batch, 3, 6, dtype=k.dtype, device=k.device)
        flow = torch.from_numpy(_RATE_FLOW).to(k.device).view(3, 18)
        g = torch.zeros(batch, 6, dtype=k.dtype, device=k.device)
    acc = torch.zeros(batch, dtype=k.dtype, device=k.device)
    for i in range(n_points):
        if i:
            y, tan = _rk4_steps(y, tan, scaled, flow, h, substeps)
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
    if (observed.dtype != torch.float32 or observed.device != k.device or n_points < 1
            or tuple(observed.shape) != (n_points, 3) or y0.dim() != 1):
        raise ValueError("observed must be float32 (n_points >= 1, 3) and y0 (3,) on k's "
                         "device")
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


#: binomial crossover rate; the draws are float32 and compare with float32(0.7)
DE_CROSSOVER = 0.7


class GenerationDraws(NamedTuple):
    """The random numbers of G DE generations over n members and d rates,
    in the order the generation loop draws them: ``f`` (G,) the dither's
    uniform, ``u`` (G, n, n) the partners', ``cr`` (G, n, d) the
    crossover's (float32), ``j`` (G, n) the guaranteed dimension (int64)."""

    f: torch.Tensor
    u: torch.Tensor
    cr: torch.Tensor
    j: torch.Tensor


def de_converged(values: List[float], tol: float, atol: float = 0.0) -> bool:
    """``std <= atol + tol |mean|`` of the losses ``values`` in float64,
    summed in candidate order (the DE mode's rule)."""
    total = 0.0
    for v in values:
        total += v
    mean = total / len(values)
    sq = 0.0
    for v in values:
        dv = v - mean
        sq += dv * dv
    return math.sqrt(sq / len(values)) <= atol + tol * abs(mean)


def de_best(values: List[float]) -> int:
    """The lowest index of the least of ``values`` (a NaN is never less)."""
    best = 0
    for i in range(1, len(values)):
        if values[i] < values[best]:
            best = i
    return best


def de_partners(u: torch.Tensor) -> torch.Tensor:
    """Each member's two partners from its row of ``u`` (n, n): the two least
    draws but its own, ties to the lower index -> (n, 2) int64."""
    n = u.shape[0]
    u = u + torch.eye(n, dtype=u.dtype, device=u.device) * 2.0
    return torch.sort(u, dim=1, stable=True).indices[:, :2]


def de_generations_plain(pop: torch.Tensor, fit: torch.Tensor, lo: torch.Tensor,
                         hi: torch.Tensor, draws: GenerationDraws,
                         loss_fn: Callable[[torch.Tensor], torch.Tensor], tol: float,
                         atol: float = 0.0) -> Tuple[int, bool]:
    """Twin of :func:`de_generations`: up to ``len(draws.f)`` generations of
    best1bin DE, pop (n, d) and fit (n,) updated in place, the trials' losses
    from ``loss_fn``; reads the losses back to the host each generation for
    the convergence test -> (generations run, stopped by the test)."""
    n, d = pop.shape
    dims = torch.arange(d, device=pop.device)
    for g in range(draws.f.shape[0]):
        values = fit.tolist()
        if de_converged(values, tol, atol):
            return g, True
        best = pop[de_best(values)]
        f_scale = draws.f[g] * 0.5 + 0.5
        r = de_partners(draws.u[g])
        mutant = torch.clamp(best + f_scale * (pop[r[:, 0]] - pop[r[:, 1]]), lo, hi)
        cross = (draws.cr[g] < DE_CROSSOVER) | (dims[None, :] == draws.j[g][:, None])
        trial = torch.where(cross, mutant, pop)
        trial_fit = loss_fn(trial)
        improve = trial_fit < fit
        pop.copy_(torch.where(improve[:, None], trial, pop))
        fit.copy_(torch.where(improve, trial_fit, fit))
    return draws.f.shape[0], False


class DePlan(NamedTuple):
    """Kernel 11's DE launch for a population, as ``csrc/apf_rk4.cu``'s
    ``eegflow_apf_de_plan`` makes it: its CTAs (a cooperative grid, 32
    members a CTA), threads a CTA and shared memory a CTA, the CTAs the card
    holds at once (``held``), the scratch it takes in floats and the
    kernel's name."""

    ctas: int
    threads: int
    smem: int
    held: int
    scratch: int
    kernel: str


def de_plan(n: int, substeps: int = 16) -> DePlan:
    """The DE mode's launch for n members at ``substeps``. Builds the kernels
    (CUDA only)."""
    lib = kernels.load_library()
    plan, name = (ctypes.c_int * 5)(), ctypes.c_char_p()
    kernels.check(lib, lib.eegflow_apf_de_plan(n, substeps, plan, ctypes.byref(name)),
                  "apf_de_plan")
    mangled = name.value.decode()
    ident = re.search(r"apf_de[a-z_]*kernel", mangled)
    return DePlan(*plan, ident.group(0) if ident else mangled)


def de_generations(pop: torch.Tensor, fit: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                   draws: GenerationDraws, y0: torch.Tensor, observed: torch.Tensor,
                   substeps: int, h: StepSizes, reg_weight: float, tol: float,
                   atol: float = 0.0) -> torch.Tensor:
    """Kernel 11, DE mode: up to ``len(draws.f)`` generations of best1bin DE
    over pop (n, 6) and fit (n,), float32, updated in place, each trial's
    loss the fit-loss mode's (y0 (3,), observed (n_points, 3)), stopping
    at the generation whose population passes :func:`de_converged`. ->
    status (2,) int32 on pop's device: generations run, 1 if the test
    stopped them. Nothing is synchronised: the caller reads the status.
    The launch is :func:`de_plan`'s; a population whose CTAs the card
    cannot hold at once raises ``ValueError``."""
    if pop.device.type == "cpu":
        ran, stopped = de_generations_plain(
            pop, fit, lo, hi, draws,
            lambda k: rk4_fit_loss_plain(k, y0, observed, substeps, h, reg_weight)[0], tol, atol)
        return torch.tensor([ran, int(stopped)], dtype=torch.int32)
    n = pop.shape[0]
    gens = draws.f.shape[0]
    want = {"pop": (pop, (n, 6), torch.float32), "fit": (fit, (n,), torch.float32),
            "lo": (lo, (6,), torch.float32), "hi": (hi, (6,), torch.float32),
            "draws.f": (draws.f, (gens,), torch.float32),
            "draws.u": (draws.u, (gens, n, n), torch.float32),
            "draws.cr": (draws.cr, (gens, n, 6), torch.float32),
            "draws.j": (draws.j, (gens, n), torch.int64), "y0": (y0, (3,), torch.float32),
            "observed": (observed, (observed.shape[0], 3), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if (tuple(t.shape) != shape or t.dtype != dtype or t.device != pop.device
                or not t.is_contiguous()):
            raise ValueError(f"de_generations: {name} must be contiguous {dtype} {shape} on "
                             f"{pop.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if n < 3 or gens < 1 or observed.shape[0] < 1:
        raise ValueError(f"de_generations: a population of at least 3, at least one generation "
                         f"and one point, got {n}, {gens} and {observed.shape[0]}")
    plan = de_plan(n, substeps)
    if plan.ctas > plan.held:
        raise ValueError(f"de_generations: a population of {n} takes {plan.ctas} CTAs of "
                         f"{plan.kernel} at once, and the card holds {plan.held}")
    status = torch.empty(2, dtype=torch.int32, device=pop.device)
    work = torch.empty(plan.scratch, dtype=torch.float32, device=pop.device)
    lib = kernels.load_library()
    err = lib.eegflow_apf_de(pop.data_ptr(), fit.data_ptr(), n, lo.data_ptr(), hi.data_ptr(),
                             draws.f.data_ptr(), draws.u.data_ptr(), draws.cr.data_ptr(),
                             draws.j.data_ptr(), gens, tol, atol, y0.data_ptr(),
                             observed.data_ptr(), observed.shape[0], substeps, h.half, h.full,
                             h.sixth, reg_weight, status.data_ptr(), work.data_ptr(),
                             kernels.stream(pop.device))
    kernels.check(lib, err, "apf_de")
    kernels.launch_counts["apf_de"] += 1
    return status
