"""Statistics toolkit (``eegflow.analyze.stats``; numpy and scipy on the
host, copied from the reference, ref 09_sensitivity_analysis.py:71-154,
381-421): Cohen's d with interpretation, McNemar's test (exact binomial for
b+c < 25, else chi-squared with continuity correction), generic bootstrap CI
(``RandomState(seed)`` draws in the reference's order), paired t.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
from scipy import stats as spstats


def cohens_d(x: np.ndarray, y: np.ndarray) -> float:
    """Cohen's d with pooled standard deviation (ref 09:71-85)."""
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    nx, ny = len(x), len(y)
    pooled = np.sqrt(((nx - 1) * x.var(ddof=1) + (ny - 1) * y.var(ddof=1))
                     / (nx + ny - 2))
    if pooled == 0:
        return 0.0
    return float((x.mean() - y.mean()) / pooled)


def interpret_cohens_d(d: float) -> str:
    """Magnitude labels (ref 09:87-93)."""
    ad = abs(d)
    if ad < 0.2:
        return "negligible"
    if ad < 0.5:
        return "small"
    if ad < 0.8:
        return "medium"
    return "large"


def mcnemar_test(
    y_true: np.ndarray, pred_a: np.ndarray, pred_b: np.ndarray
) -> Dict[str, float]:
    """McNemar's test on paired classifier predictions (ref 09:96-138).

    b = A right / B wrong; c = A wrong / B right. Exact binomial when
    b + c < 25, else chi-squared with continuity correction.
    """
    y_true = np.asarray(y_true)
    a_right = np.asarray(pred_a) == y_true
    b_right = np.asarray(pred_b) == y_true
    b = int(np.sum(a_right & ~b_right))
    c = int(np.sum(~a_right & b_right))
    n = b + c
    if n == 0:
        return {"statistic": 0.0, "p_value": 1.0, "b": b, "c": c, "method": "exact"}
    if n < 25:
        p = float(min(1.0, 2.0 * spstats.binom.cdf(min(b, c), n, 0.5)))
        return {"statistic": float(min(b, c)), "p_value": p, "b": b, "c": c,
                "method": "exact"}
    stat = (abs(b - c) - 1.0) ** 2 / n
    p = float(spstats.chi2.sf(stat, df=1))
    return {"statistic": float(stat), "p_value": p, "b": b, "c": c,
            "method": "chi2_cc"}


def bootstrap_metric_ci(
    values_fn: Callable[[np.ndarray], float],
    y_true: np.ndarray,
    y_pred: np.ndarray,
    n_bootstrap: int = 1000,
    confidence: float = 0.95,
    seed: int = 42,
) -> Tuple[float, float, float]:
    """Generic bootstrap CI for any paired metric (ref 09:141-154)."""
    rng = np.random.RandomState(seed)
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    n = len(y_true)
    stats = []
    for _ in range(n_bootstrap):
        idx = rng.randint(0, n, n)
        stats.append(values_fn(y_true[idx] == y_pred[idx]))
    stats = np.asarray(stats)
    alpha = (1 - confidence) / 2
    return (
        float(stats.mean()),
        float(np.percentile(stats, 100 * alpha)),
        float(np.percentile(stats, 100 * (1 - alpha))),
    )


def paired_t_test(a: np.ndarray, b: np.ndarray) -> Dict[str, float]:
    """Paired t-test on per-sample correctness (ref 09:403)."""
    t, p = spstats.ttest_rel(np.asarray(a, np.float64), np.asarray(b, np.float64))
    return {"t_statistic": float(t), "p_value": float(p)}
