"""Metrics registry (``eegflow.core.registry``): named metric functions
resolvable by config strings, each over :mod:`eegflow_torch.analyze.evaluate`
as the JAX package's are over its own."""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from eegflow_torch.analyze.evaluate import (binary_metrics, f1_binary, matthews_corrcoef,
                                            roc_auc)

_REGISTRY: Dict[str, Callable] = {}


def register_metric(name: str) -> Callable:
    def deco(fn: Callable) -> Callable:
        _REGISTRY[name] = fn
        return fn

    return deco


def get_metric(name: str) -> Callable:
    if name not in _REGISTRY:
        raise KeyError(f"unknown metric {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_metrics() -> list:
    return sorted(_REGISTRY)


def compute_metrics(names, y_true, y_pred, y_prob=None) -> Dict[str, float]:
    return {name: get_metric(name)(y_true, y_pred, y_prob) for name in names}


@register_metric("accuracy")
def _accuracy(y_true, y_pred, y_prob=None) -> float:
    y_true = np.asarray(y_true)
    return float((y_true == np.asarray(y_pred)).mean()) if len(y_true) else 0.0


@register_metric("f1")
def _f1(y_true, y_pred, y_prob=None) -> float:
    return f1_binary(y_true, y_pred)


@register_metric("mcc")
def _mcc(y_true, y_pred, y_prob=None) -> float:
    return matthews_corrcoef(y_true, y_pred)


@register_metric("auc")
def _auc(y_true, y_pred, y_prob=None) -> float:
    if y_prob is None:
        return float("nan")
    return roc_auc(y_true, y_prob)


@register_metric("precision")
def _precision(y_true, y_pred, y_prob=None) -> float:
    return binary_metrics(y_true, y_pred)["precision"]


@register_metric("recall")
def _recall(y_true, y_pred, y_prob=None) -> float:
    return binary_metrics(y_true, y_pred)["recall"]
