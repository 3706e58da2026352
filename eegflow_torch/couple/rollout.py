"""Coupled LSTM->ODE trajectory prediction (``eegflow.couple.rollout``).

Classifier forward (eval; the bf16 policy, or float32 with ``bf16=False``),
softmax, rate modulation, initial-state inference, one batched exact ODE
solve, and the final-state thresholds — all on the model's device.
``predict_batch`` pads each chunk of windows to a power-of-two bucket, as the
JAX package does, so the shapes the device sees stay few and static;
``predict_trajectory`` rolls out one window, optionally from a given state.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from eegflow_torch.core.config import CouplingConfig, ModelConfig, TransformerConfig
from eegflow_torch.couple.modulation import infer_initial_state, modulate_rates
from eegflow_torch.nn.model import classifier_apply
from eegflow_torch.ode.integrate import solve_batch


@dataclass
class CoupledModel:
    """Classifier params (either model family) + fitted ODE rates + coupling
    config. ``params`` and ``k_base (6,)`` live on ``device``."""

    params: Mapping
    model_cfg: Union[ModelConfig, TransformerConfig]
    k_base: torch.Tensor
    coupling: CouplingConfig
    lstm_impl: str = "auto"
    device: torch.device = torch.device("cuda")


def coupled_rollout(
    params: Mapping,
    x: torch.Tensor,
    k_base: torch.Tensor,
    model_cfg: Union[ModelConfig, TransformerConfig],
    forecast_steps: int = 20,
    alpha: float = 0.5,
    rate_floor: float = 1e-3,
    init_threshold: float = 0.6,
    bf16: bool = True,
    lstm_impl: str = "auto",
) -> Dict[str, torch.Tensor]:
    """(B, T, C) windows -> probs, attention, trajectories, final state and
    the binary / three-way predictions."""
    logits, attention = classifier_apply(
        params, x, model_cfg, return_attention=True,
        compute_dtype=torch.bfloat16 if bf16 else None, lstm_impl=lstm_impl)
    probs = torch.softmax(logits, dim=-1)
    p_open, p_closed = probs[:, 0], probs[:, 1]
    k_mod = modulate_rates(k_base, p_closed, p_open, alpha, rate_floor)   # (B, 6)
    y0 = infer_initial_state(p_closed, p_open, init_threshold)             # (B, 3)
    traj = solve_batch(y0, 0.0, float(forecast_steps), forecast_steps, k_mod)
    final = traj[:, -1, :]
    pred_binary = (final[:, 2] > 0.5).to(torch.int32)
    # three-way class: F > 0.5 -> 2 (closed), A > 0.5 -> 0 (open), else 1
    pred_three = torch.where(final[:, 2] > 0.5, 2,
                             torch.where(final[:, 0] > 0.5, 0, 1)).to(torch.int32)
    return {
        "probs": probs,
        "attention": attention,
        "trajectories": traj,
        "final_state": final,
        "pred_binary": pred_binary,
        "pred_three": pred_three,
    }


def bucket_size(k: int, batch_size: int) -> int:
    """Power-of-two bucket (at least 8, at most ``batch_size``) for a chunk
    of ``k`` windows."""
    return min(batch_size, max(8, 1 << (k - 1).bit_length()))


def predict_batch(
    model: CoupledModel,
    x: np.ndarray,
    forecast_steps: Optional[int] = None,
    batch_size: int = 2048,
    lstm_impl: Optional[str] = None,
) -> Dict[str, np.ndarray]:
    """Host wrapper: pads chunks of ``x (N, T, C)`` to static buckets, runs
    the rollout on ``model.device`` and concatenates the results as numpy.
    ``lstm_impl`` overrides the model's choice (``"plain"`` for reference
    runs on the card)."""
    steps = forecast_steps or model.coupling.forecast_steps
    impl = lstm_impl or model.lstm_impl
    out: Dict[str, list] = {}
    with torch.inference_mode():
        for i in range(0, len(x), batch_size):
            xb = np.asarray(x[i : i + batch_size], np.float32)
            k = len(xb)
            bucket = bucket_size(k, batch_size)
            if k < bucket:
                xb = np.concatenate([xb, np.zeros((bucket - k,) + xb.shape[1:], xb.dtype)])
            res = coupled_rollout(
                model.params, torch.from_numpy(xb).to(model.device), model.k_base,
                model.model_cfg, forecast_steps=steps,
                alpha=model.coupling.coupling_strength,
                rate_floor=model.coupling.rate_floor,
                init_threshold=model.coupling.init_threshold, lstm_impl=impl)
            for name, val in res.items():
                out.setdefault(name, []).append(val[:k].cpu().numpy())
    return {name: np.concatenate(vals, axis=0) for name, vals in out.items()}


def predict_trajectory(
    model: CoupledModel,
    x: np.ndarray,
    initial_state: Optional[np.ndarray] = None,
    forecast_steps: int = 10,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One window ``x (1, T, C)`` -> (trajectory (steps, 3), probs (1, 2),
    attention (1, T)). With ``initial_state`` the ODE is solved again from
    that state with the window's modulated rates, in place of the heuristic
    initial state."""
    cpl = model.coupling
    with torch.inference_mode():
        res = coupled_rollout(
            model.params, torch.as_tensor(np.asarray(x, np.float32), device=model.device),
            model.k_base, model.model_cfg, forecast_steps=forecast_steps,
            alpha=cpl.coupling_strength, rate_floor=cpl.rate_floor,
            init_threshold=cpl.init_threshold, lstm_impl=model.lstm_impl)
        traj = res["trajectories"][0]
        if initial_state is not None:
            probs = res["probs"]
            k_mod = modulate_rates(model.k_base, probs[0, 1], probs[0, 0],
                                   cpl.coupling_strength, cpl.rate_floor)
            y0 = torch.as_tensor(np.asarray(initial_state), dtype=torch.float32,
                                 device=model.device)
            traj = solve_batch(y0[None, :], 0.0, float(forecast_steps), forecast_steps,
                               k_mod[None, :])[0]
        return traj.cpu().numpy(), res["probs"].cpu().numpy(), res["attention"].cpu().numpy()
