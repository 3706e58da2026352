"""Evaluation metrics (``eegflow.analyze.evaluate``): accuracy, precision,
recall, F1, MCC, AUC, the confusion matrix and a bootstrap CI on accuracy.
numpy only, copied from the reference; model inference is done by the
caller.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def confusion_binary(y_true: np.ndarray, y_pred: np.ndarray) -> np.ndarray:
    """2x2 confusion matrix [[tn, fp], [fn, tp]] (sklearn layout)."""
    y_true = np.asarray(y_true).astype(int)
    y_pred = np.asarray(y_pred).astype(int)
    tn = int(np.sum((y_true == 0) & (y_pred == 0)))
    fp = int(np.sum((y_true == 0) & (y_pred == 1)))
    fn = int(np.sum((y_true == 1) & (y_pred == 0)))
    tp = int(np.sum((y_true == 1) & (y_pred == 1)))
    return np.array([[tn, fp], [fn, tp]])


def f1_binary(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    cm = confusion_binary(y_true, y_pred)
    tp, fp, fn = cm[1, 1], cm[0, 1], cm[1, 0]
    denom = 2 * tp + fp + fn
    return float(2 * tp / denom) if denom > 0 else 0.0


def roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """AUC via the Mann-Whitney U statistic (ties handled by midranks)."""
    y_true = np.asarray(y_true).astype(int)
    y_score = np.asarray(y_score, np.float64)
    n_pos = int(np.sum(y_true == 1))
    n_neg = int(np.sum(y_true == 0))
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(y_score, kind="mergesort")
    ranks = np.empty(len(y_score), np.float64)
    sorted_scores = y_score[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    rank_sum_pos = float(np.sum(ranks[y_true == 1]))
    u = rank_sum_pos - n_pos * (n_pos + 1) / 2.0
    return u / (n_pos * n_neg)


def matthews_corrcoef(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    cm = confusion_binary(y_true, y_pred)
    tn, fp, fn, tp = cm[0, 0], cm[0, 1], cm[1, 0], cm[1, 1]
    denom = np.sqrt(float(tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    if denom == 0:
        return 0.0
    return float((tp * tn - fp * fn) / denom)


def binary_metrics(
    y_true: np.ndarray, y_pred: np.ndarray, y_prob: Optional[np.ndarray] = None
) -> Dict[str, float]:
    """Core binary classification metrics (zero_division=0 semantics)."""
    cm = confusion_binary(y_true, y_pred)
    tn, fp, fn, tp = cm[0, 0], cm[0, 1], cm[1, 0], cm[1, 1]
    total = tn + fp + fn + tp
    precision = tp / (tp + fp) if (tp + fp) > 0 else 0.0
    recall = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    out = {
        "accuracy": float((tp + tn) / total) if total else 0.0,
        "precision": float(precision),
        "recall": float(recall),
        "f1": f1_binary(y_true, y_pred),
        "mcc": matthews_corrcoef(y_true, y_pred),
        "confusion_matrix": cm.tolist(),
    }
    if y_prob is not None and len(np.unique(np.asarray(y_true))) > 1:
        out["auc"] = roc_auc(y_true, y_prob)
    elif y_prob is not None:
        out["auc"] = float("nan")  # single-class guard (ref 03:614-620)
    return out


def bootstrap_ci(
    y_true: np.ndarray,
    y_pred: np.ndarray,
    n_bootstrap: int = 1000,
    confidence: float = 0.95,
    seed: int = 42,
) -> Dict[str, float]:
    """1000-draw bootstrap CI on accuracy (ref 03:636-646), vectorized:
    all resamples drawn as one (n_bootstrap, N) index matrix."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    rng = np.random.RandomState(seed)
    n = len(y_true)
    idx = rng.randint(0, n, size=(n_bootstrap, n))
    accs = (y_true[idx] == y_pred[idx]).mean(axis=1)
    alpha = (1 - confidence) / 2
    return {
        "mean": float(accs.mean()),
        "lower": float(np.percentile(accs, 100 * alpha)),
        "upper": float(np.percentile(accs, 100 * (1 - alpha))),
    }


def evaluate_model(
    y_true: np.ndarray,
    y_pred: np.ndarray,
    y_prob: Optional[np.ndarray] = None,
    model_name: str = "model",
    n_bootstrap: int = 1000,
) -> Dict[str, object]:
    """Full evaluation result dict matching the reference contract
    (metrics + bootstrap CI + stored predictions, ref 03:600-663)."""
    metrics = binary_metrics(y_true, y_pred, y_prob)
    ci = bootstrap_ci(y_true, y_pred, n_bootstrap=n_bootstrap)
    result = {
        "model_name": model_name,
        **metrics,
        "accuracy_ci_95": [ci["lower"], ci["upper"]],
        "y_pred": np.asarray(y_pred).tolist(),
    }
    if y_prob is not None:
        result["y_prob"] = np.asarray(y_prob).tolist()
    return result
