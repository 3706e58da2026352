"""Per-sample / per-participant three-state probability export (stage 10;
``eegflow.analyze.export``).

Reference: 10_three_state_probabilities.py:204-463. The per-sample ODE loop
becomes one :func:`eegflow_torch.couple.rollout.predict_batch` call on the
model's device; the export contract (column names, participant aggregation,
CSV/JSON files) is kept.
Excel output is gated on openpyxl availability (CSV is always written).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import pandas as pd

from eegflow_torch.couple.rollout import CoupledModel, predict_batch


def three_state_probabilities(
    model: CoupledModel, x: np.ndarray, batch_size: int = 2048
) -> Dict[str, np.ndarray]:
    """LSTM probs + final [A,P,F] + 3-way class per sample (ref 10:204-290).

    Class mapping: F > 0.5 -> 2 (eyes closed), A > 0.5 -> 0 (eyes open),
    else 1 (drowsy).
    """
    res = predict_batch(model, x, batch_size=batch_size)
    return {
        "lstm_probs": res["probs"],
        "three_state_probs": res["final_state"],
        "predictions": res["pred_three"],
    }


def sample_dataframe(
    lstm_probs: np.ndarray,
    three_state_probs: np.ndarray,
    predictions: np.ndarray,
    y_true: Optional[np.ndarray] = None,
    prefix: str = "",
) -> pd.DataFrame:
    """Per-sample frame with the reference's column contract (ref 10:293-315)."""
    n = len(lstm_probs)
    df = pd.DataFrame({
        "Sample_ID": [f"{prefix}S{i+1:05d}" for i in range(n)],
        "Prob_EyesOpen": three_state_probs[:, 0],
        "Prob_Drowsy": three_state_probs[:, 1],
        "Prob_EyesClosed": three_state_probs[:, 2],
        "LSTM_P_Open": lstm_probs[:, 0],
        "LSTM_P_Closed": lstm_probs[:, 1],
        "Predicted_State": predictions,
    })
    if y_true is not None:
        df["Ground_Truth"] = np.asarray(y_true)
    return df


def participant_dataframe(sample_df: pd.DataFrame, n_participants: int = 30) -> pd.DataFrame:
    """Even-partition pseudo-participant aggregation (ref 10:318-352)."""
    n = len(sample_df)
    per = max(n // n_participants, 1)
    rows = []
    for p in range(n_participants):
        start = p * per
        end = start + per if p < n_participants - 1 else n
        if start >= n:
            break
        sub = sample_df.iloc[start:end]
        rows.append({
            "Participant_ID": f"P{p+1:03d}",
            "N_Samples": len(sub),
            "Prob_EyesOpen": sub["Prob_EyesOpen"].mean(),
            "Prob_Drowsy": sub["Prob_Drowsy"].mean(),
            "Prob_EyesClosed": sub["Prob_EyesClosed"].mean(),
            "Prob_EyesOpen_Std": sub["Prob_EyesOpen"].std(),
            "Prob_Drowsy_Std": sub["Prob_Drowsy"].std(),
            "Prob_EyesClosed_Std": sub["Prob_EyesClosed"].std(),
            "Mean_LSTM_P_Open": sub["LSTM_P_Open"].mean(),
            "Mean_LSTM_P_Closed": sub["LSTM_P_Closed"].mean(),
            "Pct_EyesOpen": (sub["Predicted_State"] == 0).mean() * 100,
            "Pct_Drowsy": (sub["Predicted_State"] == 1).mean() * 100,
            "Pct_EyesClosed": (sub["Predicted_State"] == 2).mean() * 100,
        })
    return pd.DataFrame(rows)


def export_frames(
    out_dir: str | Path,
    frames: Dict[str, pd.DataFrame],
) -> Dict[str, list]:
    """Write each frame as CSV (always) and XLSX (if openpyxl is available).

    Returns {name: [written paths]}.
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    try:
        import openpyxl  # noqa: F401

        have_xlsx = True
    except ImportError:
        have_xlsx = False

    written: Dict[str, list] = {}
    for name, df in frames.items():
        paths = []
        csv_path = out_dir / f"{name}.csv"
        df.to_csv(csv_path, index=False)
        paths.append(str(csv_path))
        if have_xlsx:
            xlsx_path = out_dir / f"{name}.xlsx"
            df.to_excel(xlsx_path, index=False)
            paths.append(str(xlsx_path))
        written[name] = paths
    return written
