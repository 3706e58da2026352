"""ODE rate fitting: differential evolution on the population's device and
an L-BFGS-B polish (``eegflow.fit.evolution``).

On the card the whole search runs as the JAX package's ``lax.while_loop``
does, on the device: the first population's loss is one launch of kernel
11's fit-loss mode, then each chunk of generations (:func:`de_chunk_length`:
up to :data:`DE_CHUNK`, fewer where a large population's draws would pass
:data:`DE_CHUNK_BYTES`) is one launch of its DE mode
(:func:`eegflow_torch.ode.cuda_ode.de_generations`, any population the card
holds), and the host reads one status (generations run, converged) a chunk. A
:class:`FitLoss` on a CUDA device takes that path or raises. On the CPU, and
for any other loss, :func:`_de_minimize` runs the same generations as a
loop, one loss evaluation and one read-back of the losses a generation; on
the card it is the DE mode's twin, equal bit for bit.

As the reference, after scipy's defaults:
  * strategy best1bin: mutant = best + F (r1 - r2), F dithered U(0.5, 1);
  * binomial crossover, CR = 0.7, one guaranteed dimension;
  * Latin-hypercube initialisation within the bounds;
  * stop when std(fitness) <= atol + tol |mean(fitness)|;
  * polish: scipy's L-BFGS-B within the bounds on the host, loss and
    gradient from one launch of kernel 11 (:class:`Rk4FitLoss`).
Where a reduction's order could decide, the rules are written out
(``cuda_ode``: :func:`de_partners`, :func:`de_converged`, :func:`de_best`):
partner ties go to the lower index, as the reference's stable argsort; the
statistic is float64 in candidate order.

The draws come from a ``torch.Generator`` on the population's device seeded
from ``de_seed``, four calls a generation in the loop's order (:func:`_draw_generations`;
a chunk's are drawn before its launch): they repeat bit for bit from the
seed, but are not the reference's ``jax.random`` (threefry) stream.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from eegflow_torch.core.config import ODEConfig
from eegflow_torch.ode.cuda_ode import (GenerationDraws, Rk4FitLoss, de_best,
                                        de_generations, de_generations_plain, step_sizes)
from eegflow_torch.ode.field import rates_to_dict


class FitLoss:
    """The fitting loss over rate vectors ``k (..., 6)`` -> ``(...,)``: MSE
    between the RK4 trajectory from the first observed state (clipped and
    renormalised) and the observed proportions (n_points, 3), plus
    ``reg_weight * sum(k^2)``. Differentiable in k."""

    def __init__(self, observed, t0: float, t1: float, n_points: int,
                 reg_weight: float = 1e-3, substeps: int = 16,
                 device: Optional[torch.device | str] = None):
        if not isinstance(observed, torch.Tensor):
            observed = torch.tensor(np.asarray(observed, np.float32))
        self.observed = observed.to(device=device, dtype=torch.float32).contiguous()
        if self.observed.shape != (n_points, 3):
            raise ValueError(f"observed must be ({n_points}, 3), got "
                             f"{tuple(self.observed.shape)}")
        self.device = self.observed.device
        self.y0 = self.observed[0] / self.observed[0].sum()
        self.substeps = substeps
        self.steps = step_sizes(t0, t1, n_points, substeps)
        self.reg_weight = reg_weight

    def __call__(self, k: torch.Tensor) -> torch.Tensor:
        k = torch.as_tensor(k, dtype=torch.float32, device=self.device)
        loss = Rk4FitLoss.apply(k.reshape(-1, 6), self.y0, self.observed, self.substeps,
                                self.steps, self.reg_weight)
        return loss.reshape(k.shape[:-1])


def make_fit_loss(observed, t0: float, t1: float, n_points: int, reg_weight: float = 1e-3,
                  substeps: int = 16, device: Optional[torch.device | str] = None) -> FitLoss:
    """The reference's ``make_fit_loss``: a :class:`FitLoss` on ``device``
    (observed's device when it is a tensor, else the card)."""
    if device is None:
        device = observed.device if isinstance(observed, torch.Tensor) else "cuda"
    return FitLoss(observed, t0, t1, n_points, reg_weight, substeps, device)


def _latin_hypercube(gen: torch.Generator, n: int, lo: torch.Tensor,
                     hi: torch.Tensor) -> torch.Tensor:
    """Stratified uniform samples, permuted independently per dimension."""
    d = lo.shape[0]
    u = torch.rand((n, d), generator=gen, device=lo.device)
    strata = (torch.arange(n, device=lo.device, dtype=lo.dtype)[:, None] + u) / n
    perms = torch.argsort(torch.rand((n, d), generator=gen, device=lo.device), dim=0,
                          stable=True)
    return lo + torch.gather(strata, 0, perms) * (hi - lo)


def _draw_generations(gen: torch.Generator, n: int, d: int, count: int,
                      dev: torch.device) -> GenerationDraws:
    """The random numbers of ``count`` generations, drawn in the generation
    loop's order: per generation ``rand(())``, ``rand((n, n))``,
    ``rand((n, d))``, ``randint(0, d, (n,))``."""
    draws = GenerationDraws(torch.empty(count, device=dev), torch.empty(count, n, n, device=dev),
                            torch.empty(count, n, d, device=dev),
                            torch.empty(count, n, dtype=torch.int64, device=dev))
    for g in range(count):
        torch.rand((), generator=gen, out=draws.f[g])
        torch.rand((n, n), generator=gen, out=draws.u[g])
        torch.rand((n, d), generator=gen, out=draws.cr[g])
        torch.randint(0, d, (n,), generator=gen, out=draws.j[g])
    return draws


def _de_minimize(loss_fn: Callable[[torch.Tensor], torch.Tensor], gen: torch.Generator,
                 lo: torch.Tensor, hi: torch.Tensor, popsize: int, maxiter: int, tol: float,
                 atol: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """best1bin DE as a loop of generations -> (best member, its loss,
    generations run)."""
    d = lo.shape[0]
    n = popsize * d
    pop = _latin_hypercube(gen, n, lo, hi)
    fit = loss_fn(pop)
    gens = 0
    while gens < maxiter:
        draws = _draw_generations(gen, n, d, 1, lo.device)
        ran, stopped = de_generations_plain(pop, fit, lo, hi, draws, loss_fn, tol, atol)
        gens += ran
        if stopped:
            break
    i_best = de_best(fit.tolist())
    return pop[i_best], fit[i_best], gens


#: the most generations a launch of the DE mode runs (draws of ~2.3 MB at n = 90)
DE_CHUNK = 64
#: the draws' bytes a chunk may hold: two chunks are live at once (the next is
#: drawn before this one's status is read)
DE_CHUNK_BYTES = 256 * 2 ** 20


def de_chunk_length(n: int, d: int = 6) -> int:
    """Generations a chunk of the DE mode runs for n members and d rates:
    :data:`DE_CHUNK`, or fewer where their draws (float32 f, u (n, n), cr
    (n, d), int64 j (n) a generation) would exceed :data:`DE_CHUNK_BYTES`;
    at least one."""
    per_generation = 4 + 4 * n * n + 4 * n * d + 8 * n
    return max(1, min(DE_CHUNK, DE_CHUNK_BYTES // per_generation))


def _de_minimize_chunked(loss_fn: FitLoss, gen: torch.Generator, lo: torch.Tensor,
                         hi: torch.Tensor, popsize: int, maxiter: int, tol: float,
                         atol: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """:func:`_de_minimize` in chunks of :func:`de_chunk_length` generations,
    each one launch of kernel 11's DE mode (its twin on the CPU), the next
    chunk's draws queued before this one's status is read."""
    d = lo.shape[0]
    n = popsize * d
    chunk = de_chunk_length(n, d)
    pop = _latin_hypercube(gen, n, lo, hi).contiguous()
    fit = loss_fn(pop).contiguous()
    gens = 0
    draws = _draw_generations(gen, n, d, min(chunk, maxiter), lo.device) if maxiter > 0 else None
    while gens < maxiter:
        status = de_generations(pop, fit, lo, hi, draws, loss_fn.y0, loss_fn.observed,
                                loss_fn.substeps, loss_fn.steps, loss_fn.reg_weight, tol, atol)
        left = maxiter - gens - draws.f.shape[0]
        draws = _draw_generations(gen, n, d, min(chunk, left), lo.device) if left > 0 else None
        ran, stopped = status.tolist()
        gens += ran
        if stopped:
            break
    i_best = de_best(fit.tolist())
    return pop[i_best], fit[i_best], gens


def differential_evolution_fit(loss_fn: FitLoss, bounds: Tuple[Tuple[float, float], ...],
                               seed: int = 42, popsize: int = 15, maxiter: int = 1000,
                               tol: float = 1e-7, polish: bool = True
                               ) -> Tuple[np.ndarray, float, Dict[str, object]]:
    """Minimise ``loss_fn`` within ``bounds`` -> (x float64, loss, info with
    ``generations`` and ``polished``). The population lives on
    ``loss_fn.device``; a :class:`FitLoss` on a CUDA device runs the
    generations in kernel 11's DE mode."""
    dev = loss_fn.device
    lo = torch.tensor([b[0] for b in bounds], dtype=torch.float32, device=dev)
    hi = torch.tensor([b[1] for b in bounds], dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    on_card = isinstance(loss_fn, FitLoss) and dev.type == "cuda"
    with torch.no_grad():
        x, fx, gens = (_de_minimize_chunked if on_card else _de_minimize)(
            loss_fn, gen, lo, hi, popsize, maxiter, tol)
    x = x.cpu().numpy().astype(np.float64)
    fx = float(fx)
    info = {"generations": int(gens), "polished": False}

    if polish:
        from scipy.optimize import minimize

        def loss_and_grad(xx):
            k = torch.tensor(xx, dtype=torch.float32, device=dev, requires_grad=True)
            val = loss_fn(k)
            val.backward()
            return float(val.detach()), k.grad.cpu().numpy().astype(np.float64)

        res = minimize(loss_and_grad, x, jac=True, bounds=list(bounds), method="L-BFGS-B")
        if res.fun <= fx:
            x, fx = np.asarray(res.x), float(res.fun)
            info["polished"] = True
    return x, fx, info


def fit_ode_rates(observed_proportions: np.ndarray, time_points: np.ndarray,
                  config: Optional[ODEConfig] = None,
                  device: torch.device | str = "cuda"
                  ) -> Tuple[Dict[str, float], float, Dict[str, object]]:
    """Fit the six rates to observed [A, P, F] proportions (n_points, 3) at
    ``time_points`` -> (rates, loss, info), the DE on ``device``."""
    config = config or ODEConfig()
    t = np.asarray(time_points, np.float64)
    loss = make_fit_loss(np.asarray(observed_proportions, np.float32), float(t[0]),
                         float(t[-1]), len(t), reg_weight=config.reg_weight,
                         substeps=config.rk4_substeps, device=device)
    x, fx, info = differential_evolution_fit(
        loss, config.bounds, seed=config.de_seed, popsize=config.de_popsize,
        maxiter=config.de_maxiter, tol=config.de_tol)
    return rates_to_dict(x), fx, info
