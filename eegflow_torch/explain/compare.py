"""Cross-method importance comparison (ref 07_explainability.py:1102-1204):
normalize each method's channel scores, Pearson correlation matrix, and the
merged ranking table (``eegflow.explain.compare``, numpy, copied from the
reference)."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def compare_importance_methods(
    results: Sequence[Dict[str, object]],
) -> Dict[str, object]:
    """``results``: list of method dicts with 'method', 'channels', 'importance'."""
    methods = [r["method"] for r in results]
    channels = results[0]["channels"]
    mat = []
    for r in results:
        v = np.asarray(r["importance"], np.float64)
        v = v / (np.abs(v).sum() + 1e-12)
        mat.append(v)
    mat = np.stack(mat)  # (n_methods, C)

    corr = np.corrcoef(mat)
    merged = {
        ch: {m: float(mat[i, j]) for i, m in enumerate(methods)}
        for j, ch in enumerate(channels)
    }
    consensus = mat.mean(axis=0)
    order = np.argsort(-consensus)
    return {
        "methods": methods,
        "channels": channels,
        "normalized": mat.tolist(),
        "correlation_matrix": corr.tolist(),
        "merged": merged,
        "consensus_ranking": [channels[i] for i in order],
    }
