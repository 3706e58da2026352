"""Multi-horizon ODE forecasting of P(closed) (``eegflow.analyze.forecast``;
ref 08_forecasting.py).

Every start index's rollout to the largest horizon is one batched solve on
the device (shared rates, one propagator), and all horizons read out of the
same trajectory tensor.

Readout (ref 08:276): P_hat(closed at t+h) = F(h) + 0.5 * P(h), clipped to
[0, 1]; initial state from :func:`prob_to_ode_state` (ref 08:215-234).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from scipy.stats import spearmanr

from eegflow_torch.ode.integrate import solve_batch
from eegflow_torch.train.mesh import DataMesh, all_gather_rows, shard_batch


def prob_to_ode_state(prob_closed: np.ndarray) -> np.ndarray:
    """LSTM P(closed) (...,) -> APF simplex (..., 3) (ref 08:215-234)."""
    p = np.asarray(prob_closed, np.float64)
    a = 1.0 - p
    f = np.where(p > 0.5, p * 0.6, p * 0.3)
    pp = np.where(p > 0.5, p * 0.4, p * 0.3)
    state = np.stack([a, pp, f], axis=-1)
    return state / state.sum(axis=-1, keepdims=True)


def create_sequences_for_forecasting(
    probs: np.ndarray, y_labels: np.ndarray, window_size: int = 10
):
    """Sliding windows of P(closed) with current/next labels (ref 08:237-249):
    returns (sequences (N, w), label_windows (N, w), future_labels (N,))."""
    probs = np.asarray(probs)
    y_labels = np.asarray(y_labels)
    n = len(probs) - window_size
    if n <= 0:
        return (np.empty((0, window_size)), np.empty((0, window_size)),
                np.empty((0,)))
    idx = np.arange(window_size)[None, :] + np.arange(n)[:, None]
    sequences = probs[:, 1][idx]
    label_windows = y_labels[idx]
    future = y_labels[np.minimum(np.arange(n) + window_size, len(y_labels) - 1)]
    return sequences, label_windows, future


def multistep_forecast(
    probs_closed: np.ndarray,
    k: torch.Tensor,
    horizons: Sequence[int] = (5, 10, 20),
    dt: float = 1.0,
    mesh: Optional[DataMesh] = None,
) -> Dict[int, Dict[str, np.ndarray]]:
    """For each start index i: ODE rollout from prob_to_ode_state(probs[i])
    with fixed (unmodulated) rates ``k (6,)``; predictions vs actual probs
    at t+h. ``probs_closed (N,)``. Returns {h: {predictions, actuals}}. The
    solve runs on k's device. ``mesh``: the start states are padded to a
    multiple of the world size with [1, 0, 0] rows, as the JAX package pads
    them, and sharded; every rank returns the whole result."""
    probs_closed = np.asarray(probs_closed, np.float64)
    max_h = max(horizons)
    n = len(probs_closed) - max_h
    if n <= 0:
        return {h: {"predictions": np.array([]), "actuals": np.array([])}
                for h in horizons}

    k = k.to(torch.float32)
    y0 = prob_to_ode_state(probs_closed[:n]).astype(np.float32)
    if mesh is None:
        y0 = torch.from_numpy(y0).to(k.device)
    else:
        pad = np.tile(np.float32([1.0, 0.0, 0.0]), ((-n) % mesh.world_size, 1))
        y0 = shard_batch(np.concatenate([y0, pad]), mesh)
    # grid matches ref predict_trajectory: t = linspace(0, H*dt, H+1)
    with torch.inference_mode():
        traj = solve_batch(y0, 0.0, max_h * dt, max_h + 1, k.to(y0.device).expand(len(y0), 6))
        if mesh is not None:
            traj = all_gather_rows(traj, mesh)[:n]
        traj = traj.cpu().numpy()

    results: Dict[int, Dict[str, np.ndarray]] = {}
    for h in horizons:
        pred = np.clip(traj[:, h, 2] + 0.5 * traj[:, h, 1], 0.0, 1.0)
        actual = probs_closed[h : h + n]
        results[h] = {"predictions": pred, "actuals": actual}
    return results


def evaluate_forecasts(
    forecast_results: Dict[int, Dict[str, np.ndarray]],
    horizons: Sequence[int],
) -> Dict[int, Dict[str, float]]:
    """Per-horizon metrics (ref 08:292-343): threshold accuracy, MAE, RMSE,
    Spearman rho, direction accuracy."""
    metrics: Dict[int, Dict[str, float]] = {}
    for h in horizons:
        preds = np.asarray(forecast_results[h]["predictions"])
        actuals = np.asarray(forecast_results[h]["actuals"])
        if len(preds) == 0:
            continue
        acc = float(np.mean((preds > 0.5) == (actuals > 0.5)))
        mae = float(np.mean(np.abs(preds - actuals)))
        rmse = float(np.sqrt(np.mean((preds - actuals) ** 2)))
        corr = spearmanr(preds, actuals).statistic if len(preds) > 1 else 0.0
        if len(preds) > 1:
            dir_acc = float(np.mean(
                np.sign(np.diff(preds)) == np.sign(np.diff(actuals))
            ))
        else:
            dir_acc = 0.0
        metrics[h] = {
            "accuracy": acc, "mae": mae, "rmse": rmse,
            "correlation": float(corr) if np.isfinite(corr) else 0.0,
            "direction_accuracy": dir_acc, "n_samples": int(len(preds)),
        }
    return metrics


def rolling_forecast_evaluation(
    probs_closed: np.ndarray,
    k: torch.Tensor,
    window_size: int = 50,
    horizon: int = 10,
    mesh: Optional[DataMesh] = None,
) -> list:
    """Non-overlapping rolling windows -> per-window accuracy/MAE
    (ref 08:346-392), on top of one batched forecast (sharded over
    ``mesh``'s ranks, as :func:`multistep_forecast`)."""
    probs_closed = np.asarray(probs_closed, np.float64)
    res = multistep_forecast(probs_closed, k, horizons=(horizon,), mesh=mesh)
    preds = res[horizon]["predictions"]
    actuals = res[horizon]["actuals"]
    n_windows = (len(probs_closed) - window_size - horizon) // window_size
    rows = []
    for w in range(max(n_windows, 0)):
        sl = slice(w * window_size, min((w + 1) * window_size, len(preds)))
        p, a = preds[sl], actuals[sl]
        if len(p) == 0:
            continue
        rows.append({
            "window": w,
            "accuracy": float(np.mean((p > 0.5) == (a > 0.5))),
            "mae": float(np.mean(np.abs(p - a))),
        })
    return rows
