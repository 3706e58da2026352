"""Architecture ablation + statistical comparison (``eegflow.analyze.ablation``,
stage 09).

Reference: 09_sensitivity_analysis.py:265-519. Six configs (Full /
No-Attention / Unidirectional / 1-layer / 2-layer / Minimal), quick-trained
on a <=20k-sample subset for 10 epochs with plain CE + AdamW (lr 1e-3, no
clipping, no schedule), then compared against the Full model with McNemar,
Cohen's d, and paired t-tests, plus 1000-draw bootstrap CIs and
component-contribution deltas.

Each variant trains on the device through :func:`classifier_apply` on the
default ``"fused"`` schedule (the kernels on CUDA, their plain twins on the
CPU), bf16 by default. The unidirectional variants run the one-part pool
head (or the mean pool) and the mean-pool variants pool in plain PyTorch, as
the reference does. The subset, the batch size and the epoch orders are the
reference's (numpy ``default_rng(seed)``); the dropout masks come from a
``torch.Generator`` on the device seeded with ``seed``, so the trained
variants match the reference's statistically, not bit for bit (JAX's
dropout stream is not reproducible here).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from eegflow_torch.analyze.evaluate import binary_metrics, bootstrap_ci
from eegflow_torch.analyze.stats import (cohens_d, interpret_cohens_d, mcnemar_test,
                                         paired_t_test)
from eegflow_torch.core.config import ModelConfig, TrainConfig
from eegflow_torch.core.prng import make_generator
from eegflow_torch.nn.model import classifier_init, draw_dropout_masks
from eegflow_torch.train.loop import predict_probs
from eegflow_torch.train.steps import AdamW, make_train_step

ABLATION_CONFIGS: List[Dict[str, object]] = [
    {"name": "Full Model", "bidirectional": True, "use_attention": True, "num_layers": 3},
    {"name": "No Attention", "bidirectional": True, "use_attention": False, "num_layers": 3},
    {"name": "Unidirectional", "bidirectional": False, "use_attention": True, "num_layers": 3},
    {"name": "1 Layer", "bidirectional": True, "use_attention": True, "num_layers": 1},
    {"name": "2 Layers", "bidirectional": True, "use_attention": True, "num_layers": 2},
    {"name": "Minimal", "bidirectional": False, "use_attention": False, "num_layers": 1},
]


def quick_train_evaluate(
    model_cfg: ModelConfig,
    x_train: np.ndarray,
    y_train: np.ndarray,
    x_test: np.ndarray,
    y_test: np.ndarray,
    epochs: int = 10,
    batch_size: int = 512,
    lr: float = 1e-3,
    max_train: int = 20000,
    seed: int = 42,
    bf16: bool = True,
    device: Union[torch.device, str] = "cuda",
) -> Tuple[Dict[str, float], np.ndarray]:
    """Quick train (plain CE + AdamW) + test metrics (ref 09:265-327).

    The training subset and windows are copied to ``device`` once and each
    batch is gathered there; the batches are ``batch_iterator``'s
    (``drop_last``) over each epoch's ``rng.permutation``."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    if len(x_train) > max_train:
        idx = rng.choice(len(x_train), max_train, replace=False)
        x_train, y_train = x_train[idx], y_train[idx]

    params = classifier_init(model_cfg, make_generator(seed), device, trainable=True)
    optimizer = AdamW(list(params.parameters()), lr, max_norm=None)
    step = make_train_step(model_cfg, TrainConfig(bf16=bf16), optimizer)
    drop_gen = torch.Generator(device=device)
    drop_gen.manual_seed(int(seed))
    x_dev = torch.from_numpy(np.ascontiguousarray(x_train, np.float32)).to(device)
    y_dev = torch.from_numpy(np.asarray(y_train, np.int64)).to(device)
    steps = x_train.shape[1]

    bs = min(batch_size, max(len(y_train) // 2, 1))
    for _ in range(epochs):
        order = rng.permutation(len(y_train))
        for b in range(len(order) // bs):
            sel = torch.from_numpy(order[b * bs: (b + 1) * bs]).to(device)
            masks = draw_dropout_masks(model_cfg, bs, steps, drop_gen, device)
            step(params, x_dev.index_select(0, sel), y_dev.index_select(0, sel), masks)
    del x_dev, y_dev, optimizer, step  # the training set and moments, before the evaluation

    probs = predict_probs(params, x_test, model_cfg, batch_size * 2, bf16=bf16)
    preds = probs.argmax(axis=1)
    m = binary_metrics(y_test, preds)
    return (
        {"accuracy": m["accuracy"], "f1": m["f1"], "mcc": m["mcc"]},
        preds,
    )


def run_architecture_ablation(
    x_train, y_train, x_test, y_test,
    input_size: Optional[int] = None,
    hidden_size: int = 256,
    epochs: int = 10,
    max_train: int = 20000,
    configs: Optional[List[Dict[str, object]]] = None,
    bf16: bool = True,
    batch_size: int = 512,
    lr: float = 1e-3,
    device: Union[torch.device, str] = "cuda",
) -> Tuple[Dict[str, object], Dict[str, np.ndarray]]:
    """All ablation configs -> metrics + per-config test predictions
    (ref 09:330-378)."""
    input_size = input_size or x_train.shape[2]
    results: Dict[str, object] = {}
    predictions: Dict[str, np.ndarray] = {}
    for cfg in configs or ABLATION_CONFIGS:
        model_cfg = ModelConfig(
            input_size=input_size, hidden_size=hidden_size,
            num_layers=int(cfg["num_layers"]), dropout=0.4,
            bidirectional=bool(cfg["bidirectional"]),
            use_attention=bool(cfg["use_attention"]),
        )
        metrics, preds = quick_train_evaluate(
            model_cfg, x_train, y_train, x_test, y_test,
            epochs=epochs, max_train=max_train, bf16=bf16,
            batch_size=batch_size, lr=lr, device=device,
        )
        results[str(cfg["name"])] = {
            "config": {k: v for k, v in cfg.items() if k != "name"},
            "metrics": metrics,
        }
        predictions[str(cfg["name"])] = preds
    return results, predictions


def run_statistical_comparison(
    y_test: np.ndarray,
    predictions: Dict[str, np.ndarray],
    reference_name: str = "Full Model",
) -> Dict[str, object]:
    """Each variant vs the Full model: McNemar + Cohen's d + paired t
    (ref 09:381-421)."""
    ref_pred = predictions[reference_name]
    ref_correct = (ref_pred == y_test).astype(np.float64)
    out: Dict[str, object] = {}
    for name, preds in predictions.items():
        if name == reference_name:
            continue
        correct = (preds == y_test).astype(np.float64)
        d = cohens_d(ref_correct, correct)
        out[name] = {
            "mcnemar": mcnemar_test(y_test, ref_pred, preds),
            "cohens_d": d,
            "effect_size": interpret_cohens_d(d),
            "paired_t": paired_t_test(ref_correct, correct),
        }
    return out


def compute_bootstrap_intervals(
    y_test: np.ndarray, predictions: Dict[str, np.ndarray], n_bootstrap: int = 1000
) -> Dict[str, Dict[str, float]]:
    """1000-draw accuracy CI per config (ref 09:464-489)."""
    return {name: bootstrap_ci(y_test, preds, n_bootstrap)
            for name, preds in predictions.items()}


def analyze_component_contribution(
    results: Dict[str, object], reference_name: str = "Full Model"
) -> Dict[str, float]:
    """Full-model accuracy minus each ablated accuracy (ref 09:492-519)."""
    full_acc = results[reference_name]["metrics"]["accuracy"]
    contributions = {}
    mapping = {
        "attention": "No Attention",
        "bidirectional": "Unidirectional",
        "depth": "1 Layer",
    }
    for component, ablated in mapping.items():
        if ablated in results:
            contributions[component] = float(
                full_acc - results[ablated]["metrics"]["accuracy"]
            )
    return contributions
