"""Steady-state sensitivity to the rates (``eegflow.ode.sensitivity``): the
(6 rates x deltas) grid of perturbed rate vectors in one batched
:func:`~eegflow_torch.ode.field.steady_state` solve."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from eegflow_torch.ode.field import RATE_NAMES, STATE_NAMES, steady_state


def parameter_sensitivity(k: torch.Tensor, deltas: Sequence[float] = (-0.2, 0.2)
                          ) -> Dict[str, object]:
    """d(steady state)/d(rate) per rate and state, averaged over the relative
    perturbations ``deltas``, with the base and perturbed steady states."""
    k = torch.as_tensor(k, dtype=torch.float32)
    base = steady_state(k)
    eye = torch.eye(6, dtype=torch.float32, device=k.device)
    deltas_t = torch.tensor(deltas, dtype=torch.float32, device=k.device)
    perturbed = k[None, None, :] * (1.0 + deltas_t[None, :, None] * eye[:, None, :])
    steady = steady_state(perturbed)  # (6, n_deltas, 3)

    base_np = base.cpu().numpy()
    steady_np = steady.cpu().numpy()
    k_np = k.cpu().numpy()
    sensitivities: Dict[str, Dict[str, float]] = {}
    for i, name in enumerate(RATE_NAMES):
        per_state = {}
        for j, state in enumerate(STATE_NAMES):
            grads = []
            for d_idx, d in enumerate(deltas):
                dk = k_np[i] * d
                if abs(dk) > 1e-12:
                    grads.append((steady_np[i, d_idx, j] - base_np[j]) / dk)
            per_state[state] = float(np.mean(grads)) if grads else 0.0
        sensitivities[name] = per_state
    return {
        "base_steady_state": base_np.tolist(),
        "sensitivities": sensitivities,
        "perturbed_steady_states": steady_np.tolist(),
        "deltas": list(deltas),
    }
