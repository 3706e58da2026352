"""Coupling-strength sensitivity sweep (``eegflow.couple.sweep``; ref
06_lstm_ode_integration.py:525-575).

alpha in {0, 0.25, 0.5, 0.75, 1.0} -> accuracy/F1/MCC each. The classifier
runs once over the windows; for each alpha only the rate modulation, the
batched ODE solve and the final-state threshold run again, on the model's
device.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from eegflow_torch.analyze.evaluate import binary_metrics
from eegflow_torch.couple.modulation import infer_initial_state, modulate_rates
from eegflow_torch.couple.rollout import CoupledModel
from eegflow_torch.ode.integrate import solve_batch
from eegflow_torch.train.loop import predict_probs


def coupling_strength_sweep(
    model: CoupledModel,
    x: np.ndarray,
    y: np.ndarray,
    alphas: Sequence[float] = (0.0, 0.25, 0.5, 0.75, 1.0),
    forecast_steps: int = 20,
    batch_size: int = 2048,
) -> Dict[str, Dict[str, float]]:
    """Returns {alpha: {accuracy, f1, mcc}} like coupling_analysis.json."""
    probs = predict_probs(model.params, x, model.model_cfg, batch_size,
                          lstm_impl=model.lstm_impl)
    with torch.inference_mode():
        probs_d = torch.from_numpy(probs).to(model.device)
        p_open, p_closed = probs_d[:, 0], probs_d[:, 1]
        y0 = infer_initial_state(p_closed, p_open, model.coupling.init_threshold)
        results: Dict[str, Dict[str, float]] = {}
        for alpha in alphas:
            k_mod = modulate_rates(model.k_base, p_closed, p_open, float(alpha),
                                   model.coupling.rate_floor)
            traj = solve_batch(y0, 0.0, float(forecast_steps), forecast_steps, k_mod)
            pred = (traj[:, -1, 2] > 0.5).to(torch.int32).cpu().numpy()
            m = binary_metrics(y, pred)
            results[f"{alpha}"] = {"accuracy": m["accuracy"], "f1": m["f1"], "mcc": m["mcc"]}
    return results
