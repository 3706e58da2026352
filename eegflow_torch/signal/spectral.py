"""Welch PSD and band powers (``eegflow.signal.spectral``).

The reference's ``scipy.signal.welch`` usage (ref 01_data_exploration.py:
384-507) in float32 on the device: Hann-windowed segments at 50% overlap,
each segment's mean removed before the window, density scaling, the
one-sided doubling and the mean over segments. Used by the ``explore`` stage
for the spectral summary and the alpha closed/open biomarker (ref
01:470-476). The band powers integrate the PSD on the host, as the
reference does.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

CANONICAL_BANDS: Dict[str, Tuple[float, float]] = {
    "delta": (0.5, 4.0),
    "theta": (4.0, 8.0),
    "alpha": (8.0, 13.0),
    "beta": (13.0, 30.0),
    "gamma": (30.0, 45.0),
}


def _welch(x: torch.Tensor, fs: float, nperseg: int) -> torch.Tensor:
    """(..., T) float32 -> (..., nperseg//2+1) PSD on x's device."""
    segs = x.unfold(-1, nperseg, nperseg // 2)  # (..., n_seg, nperseg)
    segs = segs - segs.mean(dim=-1, keepdim=True)  # detrend='constant'
    # periodic Hann window (scipy.signal.welch's default, sym=False)
    n = torch.arange(nperseg, dtype=torch.float32, device=x.device)
    win = 0.5 - 0.5 * torch.cos(2 * math.pi * n / nperseg)
    spec = torch.fft.rfft(segs * win, dim=-1)
    scale = 1.0 / (fs * torch.sum(win ** 2))
    psd = spec.abs() ** 2 * scale
    # one-sided: double every bin but DC and (even nperseg) the Nyquist bin
    factor = torch.full((psd.shape[-1],), 2.0, device=x.device)
    factor[0] = 1.0
    if nperseg % 2 == 0:
        factor[-1] = 1.0
    return (psd * factor).mean(dim=-2)


def welch_psd(x: np.ndarray | torch.Tensor, fs: float = 500.0, nperseg: int = 1024,
              device: torch.device | str | None = None) -> Tuple[np.ndarray, np.ndarray]:
    """Welch PSD along the last axis -> (freqs, psd) as host arrays. Runs on
    ``device``: by default a tensor's own device, and the card for a host
    array."""
    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else "cuda"
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    nperseg = min(nperseg, x.shape[-1])
    psd = _welch(x, float(fs), int(nperseg))
    freqs = np.fft.rfftfreq(nperseg, 1.0 / fs)
    return freqs, psd.cpu().numpy()


def band_power(freqs: np.ndarray, psd: np.ndarray, band: Tuple[float, float]) -> np.ndarray:
    """Integrated band power by the trapezoid rule over [lo, hi)."""
    lo, hi = band
    mask = (freqs >= lo) & (freqs < hi)
    if mask.sum() < 2:
        return np.sum(psd[..., mask], axis=-1)
    return np.trapezoid(psd[..., mask], freqs[mask], axis=-1)


def band_power_summary(x: np.ndarray | torch.Tensor, fs: float = 500.0, nperseg: int = 1024,
                       device: torch.device | str | None = None) -> Dict[str, np.ndarray]:
    """All canonical band powers of (..., T) signals."""
    freqs, psd = welch_psd(x, fs, nperseg, device)
    return {name: band_power(freqs, psd, b) for name, b in CANONICAL_BANDS.items()}
