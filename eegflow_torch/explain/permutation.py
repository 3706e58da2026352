"""Permutation channel importance (``eegflow.explain.permutation``; ref
07_explainability.py:287-361).

Per channel: shuffle that channel's values across samples (n_permutations
repeats) and record the accuracy drop vs baseline.

The evaluation windows go to the device once. Each channel's (R N, T, C)
permuted stack is built on the device by a gather and a one-hot select, so
only the (R, N) permutation indices cross from the host per channel, and it
is classified in eval mode as one batch; a few channels stay in flight
before their accuracies are read back. The permutations are drawn from
``RandomState(seed)`` in the reference's order, so both packages permute
alike. With ``mesh=`` the ranks of a data mesh share the rows out.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from eegflow_torch.core.config import ModelConfig
from eegflow_torch.kernels import HostCopy
from eegflow_torch.nn.model import classifier_apply
from eegflow_torch.train.loop import predict_probs
from eegflow_torch.train.mesh import DataMesh, all_reduce_sum


def permutation_channel_importance(
    params,
    model_cfg: ModelConfig,
    x: np.ndarray,
    y: np.ndarray,
    n_permutations: int = 5,
    n_samples: int = 1000,
    batch_size: int = 5120,
    seed: int = 42,
    channel_names: Optional[Sequence[str]] = None,
    mesh: Optional[DataMesh] = None,
) -> Dict[str, object]:
    """On the device of ``params`` (a torch parameter tree).

    ``mesh``: ``params`` are the same on every rank, on its device. The
    baseline runs through ``predict_probs(mesh=)``; where the world size
    divides n, as the JAX package requires for sharding, each rank builds
    and classifies the permuted stack of its own block of rows from the
    whole ``x`` and the per-repeat correct counts are summed over the
    ranks (otherwise every rank classifies every row). Every rank returns
    the whole result."""
    device = next(iter(params.parameters())).device
    rng = np.random.RandomState(seed)
    if len(x) > n_samples:
        idx = rng.choice(len(x), n_samples, replace=False)
        x, y = x[idx], y[idx]
    n = len(x)
    n_channels = x.shape[2]
    probs = predict_probs(params, x, model_cfg, batch_size, mesh=mesh)
    baseline_acc = float((probs.argmax(1) == y).mean())

    x_dev = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)  # ships once
    y_dev = torch.from_numpy(np.asarray(y)).to(device)
    onehot_base = torch.arange(n_channels, device=device)
    rows = slice(0, n)
    sharded = mesh is not None and n % mesh.world_size == 0
    if sharded:
        part = n // mesh.world_size
        rows = slice(mesh.rank * part, (mesh.rank + 1) * part)

    def channel_accs(perms: np.ndarray, ch: int) -> torch.Tensor:
        # replace feature ``ch`` of each repeat with its permuted values
        r = perms.shape[0]
        flat = torch.from_numpy(np.ascontiguousarray(perms[:, rows]).reshape(-1))
        if device.type == "cuda":  # an asynchronous upload needs pinned memory
            flat = flat.pin_memory()
        flat = flat.to(device, non_blocking=True)
        stacked = torch.where(onehot_base == ch, x_dev[flat], x_dev[rows].repeat(r, 1, 1))
        logits = classifier_apply(params, stacked, model_cfg, compute_dtype=torch.bfloat16)
        preds = logits.argmax(dim=-1).reshape(r, -1)
        hits = (preds == y_dev[None, rows]).sum(dim=1)
        if sharded:
            hits = all_reduce_sum(hits, mesh)
        # the mean as XLA forms the reference's: the count times the float32
        # reciprocal of n, so both packages write the same importances
        return hits.to(torch.float32) * torch.tensor(1.0 / n, dtype=torch.float32)

    all_perms = np.stack(
        [[rng.permutation(n) for _ in range(n_permutations)]
         for _ in range(n_channels)])     # (C, R, N)

    importance = [0.0] * n_channels
    inflight = []

    def drain(limit: int) -> None:
        while len(inflight) > limit:
            ch0, accs = inflight.pop(0)
            importance[ch0] = float(np.mean(baseline_acc - np.asarray(accs)))

    with torch.inference_mode():
        for ch in range(n_channels):
            inflight.append((ch, HostCopy(channel_accs(all_perms[ch], ch))))
            drain(3)
        drain(0)

    names = list(channel_names) if channel_names else [
        f"Ch{i+1}" for i in range(n_channels)
    ]
    order = np.argsort(-np.asarray(importance))
    return {
        "channels": names,
        "importance": importance,
        "baseline_accuracy": baseline_acc,
        "ranking": [names[i] for i in order],
        "method": "permutation",
    }
