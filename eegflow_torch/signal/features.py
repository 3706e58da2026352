"""The 20-per-channel feature extractor of the classical baselines
(``eegflow.signal.features``).

Reference: ``extract_features_gpu`` (03_baseline_models.py:151-275), 13
time-domain and 7 spectral features per channel. Every channel of a chunk
of windows is computed at once on the device in float32, as the JAX package
does under ``jit``; the rfft batches over (windows, channels).

Semantics (the reference's):
* std and var with ddof=1; every ddof is written out;
* skew and kurt from biased central moments with +1e-10 guards, kurt as
  excess kurtosis (-3);
* the zero-crossing rate counts sign changes of the mean-centred signal,
  |diff(sign)| / 2 summed over time over seq_len, with sign(0) = 0 and
  sign(NaN) = NaN, as ``jnp.sign`` gives them;
* Hjorth mobility and complexity from ddof=1 stds with 1e-10 guards;
* band powers are sums of |rfft|^2 under the [0.5,4), [4,8), [8,13),
  [13,30), [30,45) Hz masks, ratios over their sum + 1e-10;
* NaN and Inf are scrubbed to 0 on the host (ref 03:257).

Feature order per channel (ref 03:243-251): mean, std, var, min, max, range,
skew, kurt, zcr, energy, activity, mobility, complexity, delta, theta, alpha,
beta, gamma, alpha_theta, alpha_beta. The output is channel-major: (N, C*20).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

N_FEATURES_PER_CHANNEL = 20

_BANDS = {
    "delta": (0.5, 4.0),
    "theta": (4.0, 8.0),
    "alpha": (8.0, 13.0),
    "beta": (13.0, 30.0),
    "gamma": (30.0, 45.0),
}


def _band_masks(seq_len: int, fs: float) -> np.ndarray:
    freqs = np.fft.rfftfreq(seq_len, 1.0 / fs)
    return np.stack(
        [(freqs >= lo) & (freqs < hi) for lo, hi in _BANDS.values()]
    ).astype(np.float32)  # (5, n_freqs)


def _extract(x: torch.Tensor, fs: float) -> torch.Tensor:
    """(B, T, C) float32 -> (B, C, 20) features on x's device."""
    t = x.shape[1]
    eps = 1e-10

    mean = x.mean(dim=1)
    centered = x - mean[:, None, :]
    var_u = (centered ** 2).sum(dim=1) / (t - 1)  # ddof=1
    std_u = torch.sqrt(var_u)
    min_v = x.amin(dim=1)
    max_v = x.amax(dim=1)
    range_v = max_v - min_v

    m2 = (centered ** 2).mean(dim=1)
    m3 = (centered ** 3).mean(dim=1)
    m4 = (centered ** 4).mean(dim=1)
    skew = m3 / (m2 ** 1.5 + eps)
    kurt = m4 / (m2 ** 2 + eps) - 3.0

    # sign(NaN) is NaN, as in jnp.sign (torch.sign gives 0)
    signs = torch.where(centered.isnan(), centered, torch.sign(centered))
    zcr = torch.diff(signs, dim=1).abs().sum(dim=1) / 2.0 / t

    energy = (x ** 2).mean(dim=1)

    diff1 = torch.diff(x, dim=1)
    diff2 = torch.diff(diff1, dim=1)
    d1_std = torch.std(diff1, dim=1, correction=1)
    d2_std = torch.std(diff2, dim=1, correction=1)
    activity = var_u
    mobility = d1_std / (std_u + eps)
    complexity = (d2_std / (d1_std + eps)) / (mobility + eps)

    power = torch.fft.rfft(x, dim=1).abs() ** 2  # (B, F, C)
    masks = torch.from_numpy(_band_masks(t, fs)).to(x.device)  # (5, F)
    band = torch.einsum("bfc,kf->bkc", power, masks)  # (B, 5, C)
    delta_p, theta_p, alpha_p, beta_p, gamma_p = band.unbind(dim=1)
    total = delta_p + theta_p + alpha_p + beta_p + gamma_p + eps

    return torch.stack(
        [
            mean, std_u, var_u, min_v, max_v, range_v,
            skew, kurt, zcr, energy, activity, mobility, complexity,
            delta_p / total, theta_p / total, alpha_p / total,
            beta_p / total, gamma_p / total,
            alpha_p / (theta_p + eps), alpha_p / (beta_p + eps),
        ],
        dim=-1,
    )  # (B, C, 20)


def extract_features(x: np.ndarray, fs: float = 500.0, batch_size: int = 10000,
                     device: torch.device | str | None = None) -> np.ndarray:
    """(N, T, C) windows -> (N, C*20) float32 feature matrix, NaN/Inf
    scrubbed. Chunks of ``batch_size`` windows go to ``device`` (by default
    the card), are reduced there and come back, which bounds device memory as
    the reference does (ref 03:178)."""
    device = torch.device("cuda" if device is None else device)
    x = np.asarray(x, np.float32)
    out: List[np.ndarray] = []
    for start in range(0, x.shape[0], batch_size):
        chunk = torch.from_numpy(np.ascontiguousarray(x[start:start + batch_size])).to(device)
        feats = _extract(chunk, float(fs))
        out.append(feats.reshape(feats.shape[0], -1).cpu().numpy())
    features = np.concatenate(out, axis=0) if out else np.empty((0, 0), np.float32)
    return np.nan_to_num(features, nan=0.0, posinf=0.0, neginf=0.0)


def feature_names(channel_names: Sequence[str]) -> List[str]:
    """Feature names in the reference's order (ref 03:261-272)."""
    suffixes = [
        "mean", "std", "var", "min", "max", "range", "skew", "kurt", "zcr",
        "energy", "activity", "mobility", "complexity",
        "delta", "theta", "alpha", "beta", "gamma", "alpha_theta", "alpha_beta",
    ]
    names = []
    for ch in channel_names:
        names.extend(f"{ch}_{s}" for s in suffixes)
    return names
