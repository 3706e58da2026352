"""The classical baselines on the 1,220 hand-crafted features
(``eegflow.baselines.classical``; stage 03, ref 03_baseline_models.py:
401-597).

An RBF SVM (grid C in {1, 10}, class-weighted, a 50k-window cap for the
O(n^2) kernel), a random forest (a manual grid over trees, depth and
min_split, balanced class weights) and boosted trees (xgboost where it
imports, else the reference's own fallback, ref 03:46-51, here sklearn's
HistGradientBoosting), each selected on validation accuracy, with the
StandardScaler fit on train.

The features are extracted on the device (``signal/features.py``); the
estimators are host sklearn, as in the reference. sklearn is imported where
each estimator is built, so an environment without it raises
``ModuleNotFoundError`` there.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from eegflow_torch.analyze.evaluate import evaluate_model
from eegflow_torch.signal.features import extract_features


def load_or_extract_features(x: np.ndarray, cache_path: Optional[str | Path] = None,
                             fs: float = 500.0,
                             device: torch.device | str | None = None) -> np.ndarray:
    """The features of windows ``x``: read from ``cache_path`` (an ``.npz``
    with key ``features``) when it exists, else extracted on ``device`` (by
    default the card) and cached there (ref 03:107-148)."""
    if cache_path is not None:
        cache_path = Path(cache_path)
        if cache_path.exists():
            return np.load(cache_path)["features"]
    feats = extract_features(x, fs=fs, device=device)
    if cache_path is not None:
        cache_path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(cache_path, features=feats)
    return feats


def _select_on_val(candidates, x_val, y_val):
    """The candidate with the best validation accuracy (the first on ties)."""
    best, best_acc = None, -1.0
    for model in candidates:
        acc = float((model.predict(x_val) == y_val).mean()) if len(y_val) else 0.0
        if acc > best_acc:
            best, best_acc = model, acc
    return best, best_acc


def train_svm(x_train, y_train, x_val, y_val, max_samples: int = 50000,
              seed: int = 42) -> Tuple[object, Dict[str, float]]:
    """RBF SVC, grid C in {1, 10}, gamma=scale, class-weighted, at most
    ``max_samples`` training windows drawn by ``RandomState(seed)`` (ref
    03:401-456)."""
    from sklearn.svm import SVC

    rng = np.random.RandomState(seed)
    if len(x_train) > max_samples:
        idx = rng.choice(len(x_train), max_samples, replace=False)
        x_train, y_train = x_train[idx], y_train[idx]

    candidates = []
    for c in (1.0, 10.0):
        model = SVC(C=c, kernel="rbf", gamma="scale", class_weight="balanced",
                    probability=True, random_state=seed)
        model.fit(x_train, y_train)
        candidates.append(model)
    best, val_acc = _select_on_val(candidates, x_val, y_val)
    return best, {"val_accuracy": val_acc, "grid": "C in {1,10}"}


def train_random_forest(x_train, y_train, x_val, y_val, seed: int = 42, n_jobs: int = -1,
                        grid: Optional[list] = None) -> Tuple[object, Dict[str, float]]:
    """The manual random-forest grid (ref 03:459-504): n_estimators {100,
    200} x max_depth {10, 20, None} x min_samples_split {2, 5}, balanced
    class weights."""
    from sklearn.ensemble import RandomForestClassifier

    grid = grid or [
        {"n_estimators": n, "max_depth": d, "min_samples_split": m}
        for n in (100, 200) for d in (10, 20, None) for m in (2, 5)
    ]
    candidates = []
    for g in grid:
        model = RandomForestClassifier(**g, class_weight="balanced", n_jobs=n_jobs,
                                       random_state=seed)
        model.fit(x_train, y_train)
        candidates.append(model)
    best, val_acc = _select_on_val(candidates, x_val, y_val)
    return best, {"val_accuracy": val_acc, "grid_size": len(grid)}


def train_gradient_boosting(x_train, y_train, x_val, y_val, seed: int = 42,
                            grid: Optional[list] = None) -> Tuple[object, Dict[str, float]]:
    """Boosted trees over n_estimators {100, 200} x max_depth {4, 6} x
    learning_rate {0.1, 0.3} with the class imbalance weighted in: xgboost's
    hist trees where xgboost imports, else the reference's own sklearn
    fallback (ref 03:46-51, 507-597)."""
    grid = grid or [
        {"n_estimators": n, "max_depth": d, "learning_rate": lr}
        for n in (100, 200) for d in (4, 6) for lr in (0.1, 0.3)
    ]
    pos_weight = float((np.asarray(y_train) == 0).sum()
                       / max((np.asarray(y_train) == 1).sum(), 1))
    candidates = []
    try:
        from xgboost import XGBClassifier

        for g in grid:
            model = XGBClassifier(**g, tree_method="hist", scale_pos_weight=pos_weight,
                                  random_state=seed, eval_metric="logloss")
            model.fit(x_train, y_train)
            candidates.append(model)
        backend = "xgboost"
    except ImportError:
        from sklearn.ensemble import HistGradientBoostingClassifier

        sample_weight = np.where(np.asarray(y_train) == 1, pos_weight, 1.0)
        for g in grid:
            # 63 bins, as the reference's fallback takes them
            model = HistGradientBoostingClassifier(
                max_iter=g["n_estimators"], max_depth=g["max_depth"],
                learning_rate=g["learning_rate"], random_state=seed, max_bins=63)
            model.fit(x_train, y_train, sample_weight=sample_weight)
            candidates.append(model)
        backend = "sklearn_hist_gb"
    best, val_acc = _select_on_val(candidates, x_val, y_val)
    return best, {"val_accuracy": val_acc, "backend": backend, "scale_pos_weight": pos_weight}


def run_all_baselines(x_train, y_train, x_val, y_val, x_test, y_test, fs: float = 500.0,
                      cache_dir: Optional[str | Path] = None,
                      models: Tuple[str, ...] = ("svm", "random_forest", "gradient_boosting"),
                      seed: int = 42,
                      device: torch.device | str | None = None) -> Dict[str, object]:
    """Stage 03: features (on ``device``, cached as ``features_{split}.npz``
    under ``cache_dir``) -> the scaler fit on train -> each model's grid ->
    its test evaluation with bootstrap CIs: the ``baseline_results.json``
    contract. The fitted scaler and models go to
    ``cache_dir/baseline_models.pkl``."""
    from sklearn.preprocessing import StandardScaler

    def cache(name):
        return None if cache_dir is None else Path(cache_dir) / f"{name}.npz"

    f_train = load_or_extract_features(x_train, cache("features_train"), fs, device)
    f_val = load_or_extract_features(x_val, cache("features_val"), fs, device)
    f_test = load_or_extract_features(x_test, cache("features_test"), fs, device)

    scaler = StandardScaler().fit(f_train)
    f_train, f_val, f_test = (scaler.transform(f) for f in (f_train, f_val, f_test))

    trainers = {
        "svm": train_svm,
        "random_forest": train_random_forest,
        "gradient_boosting": train_gradient_boosting,
    }
    results: Dict[str, object] = {}
    fitted = {"scaler": scaler}
    for name in models:
        model, info = trainers[name](f_train, y_train, f_val, y_val, seed=seed)
        y_pred = model.predict(f_test)
        y_prob = (model.predict_proba(f_test)[:, 1]
                  if hasattr(model, "predict_proba") else None)
        results[name] = {
            **evaluate_model(y_test, y_pred, y_prob, model_name=name),
            "selection": info,
        }
        fitted[name] = model

    if cache_dir is not None:
        Path(cache_dir).mkdir(parents=True, exist_ok=True)
        with open(Path(cache_dir) / "baseline_models.pkl", "wb") as f:
            pickle.dump(fitted, f)
    return results
