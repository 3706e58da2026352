"""Eye-state -> cognitive-state mapping (``eegflow.ode.mapping``), numpy.

A centred sliding window's closed ratio and variance from one cumulative
sum, then the rules:
    closed_ratio < 0.3 and variance < 0.15 -> Active (0)
    closed_ratio > 0.7                     -> Fatigued (2)
    otherwise                              -> Passive (1)
and the [A, P, F] occupancy of each non-overlapping block.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _centered_window_stats(x: np.ndarray, window_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Mean and variance over [i - w//2, i + w//2), clipped to the array."""
    n = len(x)
    half = window_size // 2
    csum = np.concatenate([[0.0], np.cumsum(x, dtype=np.float64)])
    csum2 = np.concatenate([[0.0], np.cumsum(x.astype(np.float64) ** 2)])
    idx = np.arange(n)
    start = np.maximum(0, idx - half)
    end = np.minimum(n, idx + half)
    count = (end - start).astype(np.float64)
    mean = (csum[end] - csum[start]) / count
    mean2 = (csum2[end] - csum2[start]) / count
    var = mean2 - mean**2
    return mean, np.maximum(var, 0.0)


def map_eye_state_to_cognitive(eye_states: np.ndarray, window_size: int = 20
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """Binary eye states (0 open, 1 closed) -> (cognitive labels (n,) with
    0 Active, 1 Passive, 2 Fatigued; [A, P, F] proportions (n_windows, 3) of
    each non-overlapping ``window_size`` block)."""
    eye_states = np.asarray(eye_states, dtype=np.float64)
    n = len(eye_states)
    closed_ratio, variance = _centered_window_stats(eye_states, window_size)

    cognitive = np.full(n, 1, dtype=np.int64)  # Passive by default
    cognitive[(closed_ratio < 0.3) & (variance < 0.15)] = 0  # Active
    cognitive[closed_ratio > 0.7] = 2  # Fatigued

    step = window_size
    proportions = []
    for i in range(0, n - step, step):
        w = cognitive[i: i + step]
        proportions.append([np.mean(w == 0), np.mean(w == 1), np.mean(w == 2)])
    return cognitive.astype(np.float64), np.asarray(proportions, dtype=np.float64)
