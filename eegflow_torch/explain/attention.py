"""Temporal attention-pattern analytics (ref 07_explainability.py:684-730):
mean/std/peak per class and normalized entropy of the mean attention
(``eegflow.explain.attention``, numpy, copied from the reference)."""

from __future__ import annotations

from typing import Dict

import numpy as np


def analyze_attention_patterns(
    attention_weights: np.ndarray, y: np.ndarray
) -> Dict[str, object]:
    """``attention_weights (N, T)`` softmax weights, ``y (N,)`` binary labels."""
    attention_weights = np.asarray(attention_weights, np.float64)
    y = np.asarray(y)
    mean_attention = attention_weights.mean(axis=0)
    std_attention = attention_weights.std(axis=0)

    results: Dict[str, object] = {
        "mean_attention": mean_attention.tolist(),
        "std_attention": std_attention.tolist(),
        "peak_position": int(np.argmax(mean_attention)),
        "max_attention": float(mean_attention.max()),
        "min_attention": float(mean_attention.min()),
    }

    for class_idx, class_name in enumerate(["open", "closed"]):
        mask = y == class_idx
        if mask.sum() > 0:
            class_mean = attention_weights[mask].mean(axis=0)
            results[f"{class_name}_mean"] = class_mean.tolist()
            results[f"{class_name}_peak"] = int(np.argmax(class_mean))

    entropy = -np.sum(mean_attention * np.log(mean_attention + 1e-10))
    results["entropy"] = float(entropy / np.log(len(mean_attention)))
    return results
