"""Synthetic ds004148-shaped EEG (``eegflow.data.synthetic``).

Per channel: 1/f ("pink") background plus an occipitally weighted alpha
oscillation (about x3 when the eyes are closed) with a slow amplitude
envelope, scaled to tens of microvolts. numpy with the JAX package's
``default_rng`` seeds and operations, so the files it writes are byte for
byte the JAX package's.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from eegflow_torch.data.brainvision import write_brainvision

#: 61-channel 10-10 montage of ds004148's cap
EEG_CHANNELS_61: List[str] = [
    "Fp1", "Fp2", "AF7", "AF3", "AFz", "AF4", "AF8",
    "F7", "F5", "F3", "F1", "Fz", "F2", "F4", "F6", "F8",
    "FT7", "FC5", "FC3", "FC1", "FCz", "FC2", "FC4", "FC6", "FT8",
    "T7", "C5", "C3", "C1", "Cz", "C2", "C4", "C6", "T8",
    "TP7", "CP5", "CP3", "CP1", "CPz", "CP2", "CP4", "CP6", "TP8",
    "P7", "P5", "P3", "P1", "Pz", "P2", "P4", "P6", "P8",
    "PO7", "PO3", "POz", "PO4", "PO8", "O1", "Oz", "O2", "Iz",
]

#: posterior channels carrying the alpha biomarker
_OCCIPITAL = {"O1", "Oz", "O2", "PO7", "PO3", "POz", "PO4", "PO8", "Iz",
              "P7", "P5", "P3", "P1", "Pz", "P2", "P4", "P6", "P8"}


def _pink_noise(rng: np.random.Generator, n_ch: int, n_t: int, fs: float) -> np.ndarray:
    """1/f-shaped noise by spectral shaping of white noise."""
    white = rng.standard_normal((n_ch, n_t))
    spec = np.fft.rfft(white, axis=1)
    freqs = np.fft.rfftfreq(n_t, 1.0 / fs)
    shaping = 1.0 / np.sqrt(np.maximum(freqs, 1.0))
    pink = np.fft.irfft(spec * shaping, n=n_t, axis=1)
    return pink / pink.std(axis=1, keepdims=True)


def generate_recording(eyes_closed: bool, duration_s: float = 30.0, fs: float = 500.0,
                       channel_names: Optional[List[str]] = None, seed: int = 0,
                       alpha_freq: float = 10.0) -> np.ndarray:
    """One synthetic recording -> (C, T) float32 volts."""
    rng = np.random.default_rng(seed)
    names = channel_names or EEG_CHANNELS_61
    n_ch = len(names)
    n_t = int(duration_s * fs)
    t = np.arange(n_t) / fs

    data = 10.0 * _pink_noise(rng, n_ch, n_t, fs)  # ~10 uV background

    occ_weight = np.asarray([1.0 if n in _OCCIPITAL else 0.3 for n in names])[:, None]
    alpha_amp = 8.0 if eyes_closed else 2.5  # the eyes-closed alpha boost
    phase = rng.uniform(0, 2 * np.pi, (n_ch, 1))
    # a slow amplitude modulation keeps the rhythm non-stationary
    envelope = 1.0 + 0.3 * np.sin(2 * np.pi * 0.2 * t + rng.uniform(0, 2 * np.pi))
    alpha = alpha_amp * occ_weight * np.sin(2 * np.pi * alpha_freq * t + phase) * envelope

    data = (data + alpha) * 1e-6  # microvolts -> volts
    return data.astype(np.float32)


def montage_subset(n_channels: int) -> List[str]:
    """Evenly spaced subset of the 61-channel montage (posterior sites
    included)."""
    if n_channels >= len(EEG_CHANNELS_61):
        return list(EEG_CHANNELS_61)
    idx = np.linspace(0, len(EEG_CHANNELS_61) - 1, n_channels).round().astype(int)
    return [EEG_CHANNELS_61[i] for i in idx]


def generate_synthetic_dataset(out_dir: str | Path, n_subjects: int = 4, n_sessions: int = 1,
                               duration_s: float = 30.0, fs: float = 500.0,
                               n_channels: int = 61, seed: int = 42) -> Path:
    """Write a ds004148-shaped BIDS tree of BrainVision triplets:
    ``sub-XX/ses-sessionY/eeg/sub-XX_ses-sessionY_task-{eyesopen,eyesclosed}_eeg``."""
    out_dir = Path(out_dir)
    names = montage_subset(n_channels)
    counter = 0
    for s in range(1, n_subjects + 1):
        for ses in range(1, n_sessions + 1):
            for task, closed in (("eyesopen", False), ("eyesclosed", True)):
                base = (out_dir / f"sub-{s:02d}" / f"ses-session{ses}" / "eeg"
                        / f"sub-{s:02d}_ses-session{ses}_task-{task}_eeg")
                data = generate_recording(closed, duration_s, fs, names, seed=seed + counter)
                write_brainvision(base, data, names, fs)
                counter += 1
    return out_dir


def synthetic_windows(n_per_class: int = 256, seq_length: int = 256, n_channels: int = 61,
                      fs: float = 500.0, seed: int = 42) -> Tuple[np.ndarray, np.ndarray]:
    """Z-scored windows straight from the generator, without files ->
    (x (N, seq_length, C) float32, y (N,) int64), shuffled."""
    rng = np.random.default_rng(seed)
    names = montage_subset(n_channels)
    xs, ys = [], []
    for label, closed in ((0, False), (1, True)):
        dur = (n_per_class * seq_length // 2 + seq_length) / fs
        rec = generate_recording(closed, dur, fs, names, seed=seed + label)
        rec = (rec - rec.mean(1, keepdims=True)) / rec.std(1, keepdims=True)
        step = seq_length // 2
        for i in range(n_per_class):
            start = i * step
            xs.append(rec[:, start: start + seq_length].T)
            ys.append(label)
    x = np.asarray(xs, np.float32)
    y = np.asarray(ys, np.int64)
    order = rng.permutation(len(y))
    return x[order], y[order]
