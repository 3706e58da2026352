"""Coupling-strength sensitivity sweep (``eegflow.couple.sweep``; ref
06_lstm_ode_integration.py:525-575).

alpha in {0, 0.25, 0.5, 0.75, 1.0} -> accuracy/F1/MCC each. The classifier
runs once over the windows; for each alpha only the rate modulation, the
batched ODE solve and the final-state threshold run again, on the model's
device. With ``mesh=`` both the classifier pass and every alpha's solves
shard the samples over the ranks of a data mesh.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from eegflow_torch.analyze.evaluate import binary_metrics
from eegflow_torch.couple.modulation import infer_initial_state, modulate_rates
from eegflow_torch.couple.rollout import CoupledModel
from eegflow_torch.ode.integrate import solve_batch
from eegflow_torch.train.loop import predict_probs
from eegflow_torch.train.mesh import DataMesh, all_gather_rows, shard_batch


def coupling_strength_sweep(
    model: CoupledModel,
    x: np.ndarray,
    y: np.ndarray,
    alphas: Sequence[float] = (0.0, 0.25, 0.5, 0.75, 1.0),
    forecast_steps: int = 20,
    batch_size: int = 2048,
    mesh: Optional[DataMesh] = None,
) -> Dict[str, Dict[str, float]]:
    """Returns {alpha: {accuracy, f1, mcc}} like coupling_analysis.json.
    ``mesh``: the model is the same on every rank; the probabilities are
    zero-padded to a multiple of the world size and sharded for the
    per-alpha solves, as the JAX package pads them, and every rank returns
    the whole result."""
    probs = predict_probs(model.params, x, model.model_cfg, batch_size,
                          lstm_impl=model.lstm_impl, mesh=mesh)
    n = len(probs)
    with torch.inference_mode():
        if mesh is None:
            probs_d = torch.from_numpy(probs).to(model.device)
        else:
            probs_d = shard_batch(np.pad(probs, ((0, (-n) % mesh.world_size), (0, 0))), mesh)
        p_open, p_closed = probs_d[:, 0], probs_d[:, 1]
        y0 = infer_initial_state(p_closed, p_open, model.coupling.init_threshold)
        results: Dict[str, Dict[str, float]] = {}
        for alpha in alphas:
            k_mod = modulate_rates(model.k_base, p_closed, p_open, float(alpha),
                                   model.coupling.rate_floor)
            traj = solve_batch(y0, 0.0, float(forecast_steps), forecast_steps, k_mod)
            pred = (traj[:, -1, 2] > 0.5).to(torch.int32)
            if mesh is not None:
                pred = all_gather_rows(pred, mesh)[:n]
            m = binary_metrics(y, pred.cpu().numpy())
            results[f"{alpha}"] = {"accuracy": m["accuracy"], "f1": m["f1"], "mcc": m["mcc"]}
    return results
