"""Preprocessing: z-score, windowing, subject-wise splits and the recording
pipeline (``eegflow.signal.preprocess``).

A recording is filtered, z-scored and cut into windows on the device
(``unfold``); each split's windows are concatenated there and copied to the
host once. The reference's rules are kept:

* the FIRST training recording's per-channel stats are the normalisation
  of every later recording;
* windows of ``sequence_length`` samples with step
  ``int(sequence_length * (1 - overlap))``;
* a subject-wise 70/15/15 split with session and time fallbacks.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from eegflow_torch.core.config import PreprocessConfig
from eegflow_torch.signal.filters import bandpass_filter


def normalize(data: torch.Tensor, mean: Optional[torch.Tensor] = None,
              std: Optional[torch.Tensor] = None, std_floor: float = 1e-10
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-channel z-score over time of ``data (C, T)`` -> (normalised, mean
    (C,), std (C,)); given stats are reused (val and test take the train
    stats), a computed std is floored at ``std_floor``."""
    if mean is None:
        mean = data.mean(dim=1, keepdim=True)
    else:
        mean = torch.as_tensor(mean, dtype=data.dtype, device=data.device).reshape(-1, 1)
    if std is None:
        std = data.std(dim=1, correction=0, keepdim=True)
        std = torch.where(std < std_floor, torch.full_like(std, std_floor), std)
    else:
        std = torch.as_tensor(std, dtype=data.dtype, device=data.device).reshape(-1, 1)
    return (data - mean) / std, mean.flatten(), std.flatten()


def create_sequences(data: torch.Tensor, label: int, seq_length: int, overlap: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Overlapping windows of ``data (C, T)`` (a tensor or an array) -> (x (N,
    seq_length, C), y (N,) int64 of ``label``), on data's device."""
    data = torch.as_tensor(data)
    n_channels, n_samples = data.shape
    step = int(seq_length * (1 - overlap))
    if n_samples < seq_length:
        return (data.new_empty((0, seq_length, n_channels)),
                torch.empty(0, dtype=torch.int64, device=data.device))
    x = data.unfold(1, seq_length, step).permute(1, 2, 0).contiguous()  # (N, L, C)
    return x, torch.full((x.shape[0],), label, dtype=torch.int64, device=data.device)


def split_subjects(recordings: Sequence[Dict[str, Any]], train_frac: float = 0.70,
                   val_frac: float = 0.15, seed: int = 42) -> Dict[str, List[Dict[str, Any]]]:
    """Subject-wise 70/15/15 split (numpy's ``RandomState(seed)`` shuffle, as
    the reference). Below 3 subjects it splits by session; below 3 sessions
    everything is train and ``time_split`` is set (windows are carved
    downstream)."""
    rng = np.random.RandomState(seed)
    subjects = sorted({r["subject"] for r in recordings})

    if len(subjects) >= 3:
        order = list(subjects)
        rng.shuffle(order)
        n_train = max(1, int(len(order) * train_frac))
        n_val = max(1, int(len(order) * val_frac))
        train_s = set(order[:n_train])
        val_s = set(order[n_train: n_train + n_val])
        test_s = set(order[n_train + n_val:])
        if not test_s:  # keep the test split non-empty
            test_s = {order[-1]}
            val_s.discard(order[-1])
        return {
            "train": [r for r in recordings if r["subject"] in train_s],
            "val": [r for r in recordings if r["subject"] in val_s],
            "test": [r for r in recordings if r["subject"] in test_s],
        }

    sessions = sorted({(r["subject"], r["session"]) for r in recordings})
    if len(sessions) >= 3:
        order = list(sessions)
        rng.shuffle(order)
        n_train = max(1, int(len(order) * train_frac))
        n_val = max(1, int(len(order) * val_frac))
        train_s = set(order[:n_train])
        val_s = set(order[n_train: n_train + n_val])
        return {
            "train": [r for r in recordings if (r["subject"], r["session"]) in train_s],
            "val": [r for r in recordings if (r["subject"], r["session"]) in val_s],
            "test": [r for r in recordings
                     if (r["subject"], r["session"]) not in train_s | val_s],
        }

    # time-based fallback: all recordings in train; windows are carved downstream
    return {"train": list(recordings), "val": [], "test": [], "time_split": True}


def preprocess_recording(data, label: int, config: PreprocessConfig,
                         norm_mean: Optional[torch.Tensor] = None,
                         norm_std: Optional[torch.Tensor] = None,
                         device: torch.device | str = "cuda"
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Filter -> z-score -> window one recording ``data (C, T)`` in volts (a
    tensor or an array) on ``device`` -> (X (N, L, C), y (N,), mean (C,),
    std (C,)), all on ``device``."""
    raw = torch.as_tensor(data, dtype=torch.float32, device=device)
    filtered = bandpass_filter(raw, config.lowcut, config.highcut, config.sampling_rate,
                               config.filter_order, method=config.filter_method)
    normalized, mean, std = normalize(filtered, norm_mean, norm_std, std_floor=config.std_floor)
    x, y = create_sequences(normalized, label, config.sequence_length, config.overlap)
    return x, y, mean, std


def process_recordings(loaded: Dict[str, List[Tuple[Dict[str, Any], np.ndarray]]],
                       config: PreprocessConfig, device: torch.device | str = "cuda"
                       ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Pre-split recordings (split -> [(info, raw (C, T))]) -> the processed
    archive's arrays (``X_{split}`` float32, ``y_{split}`` int64, on the
    host) and metadata. The first *train* recording fixes the global
    normalisation."""
    norm_mean: Optional[torch.Tensor] = None
    norm_std: Optional[torch.Tensor] = None
    arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, Any] = {
        "sampling_rate": config.sampling_rate,
        "sequence_length": config.sequence_length,
        "overlap": config.overlap,
        "filter": {
            "lowcut": config.lowcut, "highcut": config.highcut,
            "order": config.filter_order, "method": config.filter_method,
        },
        "splits": {},
    }
    for split in ("train", "val", "test"):
        xs, ys, subjects = [], [], []
        for info, raw in loaded.get(split, []):
            x, y, mean, std = preprocess_recording(raw, info["label"], config, norm_mean,
                                                   norm_std, device)
            if split == "train" and norm_mean is None:
                norm_mean, norm_std = mean, std
                meta["normalization"] = {"mean": mean.cpu().tolist(), "std": std.cpu().tolist()}
            xs.append(x)
            ys.append(y)
            subjects.append(info["subject"])
        if xs:
            arrays[f"X_{split}"] = torch.cat(xs).cpu().numpy()
            arrays[f"y_{split}"] = torch.cat(ys).cpu().numpy()
        else:
            nch = loaded["train"][0][1].shape[0] if loaded.get("train") else 0
            arrays[f"X_{split}"] = np.empty((0, config.sequence_length, nch), np.float32)
            arrays[f"y_{split}"] = np.empty((0,), np.int64)
        meta["splits"][split] = {
            "n_sequences": int(arrays[f"y_{split}"].shape[0]),
            "subjects": sorted(set(subjects)),
        }
    return arrays, meta
