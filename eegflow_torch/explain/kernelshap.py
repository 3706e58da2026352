"""KernelSHAP (``eegflow.explain.kernelshap``), reimplemented: the ``shap``
package is not used.

Reference usage (07_explainability.py:364-508): windows are collapsed to
per-channel time-means (B, T, C) -> (B, C); a background of 100 samples and
200 explained samples; the prediction function tiles channel vectors back
across time; KernelExplainer(nsamples=100); class-1 SHAP values; mean |SHAP|
per channel. Here all (coalition x background) model evaluations of one
explained sample are one batched forward on the device, and a few of them
stay in flight while the host builds the next sample's rows and solves the
previous one's regression.

Algorithm (Lundberg & Lee 2017): sample coalitions z in {0,1}^C from the
Shapley kernel (size s with prob ~ (C-1)/(s(C-s)), pairing each subset with
its complement), estimate v(z) = E_bg[f(z*x + (1-z)*bg)], then solve the
constrained weighted least squares with sum(phi) = f(x) - E_bg[f(bg)] by
eliminating the last feature. The coalition samplers and
:func:`kernel_shap_values` are numpy, copied from the reference, so both
packages draw the same coalitions from the same seed.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from eegflow_torch.core.config import ModelConfig
from eegflow_torch.kernels import HostCopy
from eegflow_torch.nn.model import classifier_apply


def _sample_coalitions(rng: np.random.RandomState, n_features: int, nsamples: int) -> np.ndarray:
    """Coalition masks from the Shapley kernel, complements paired."""
    c = n_features
    sizes = np.arange(1, c)
    probs = (c - 1) / (sizes * (c - sizes))
    probs = probs / probs.sum()
    masks = []
    while len(masks) < nsamples:
        s = rng.choice(sizes, p=probs)
        members = rng.choice(c, size=s, replace=False)
        z = np.zeros(c, dtype=np.float64)
        z[members] = 1.0
        masks.append(z)
        if len(masks) < nsamples:
            masks.append(1.0 - z)  # paired complement (variance reduction)
    return np.asarray(masks[:nsamples])


def _enumerate_coalitions(n_features: int):
    """All 2^C - 2 non-trivial coalitions with exact Shapley-kernel weights
    (what scipy's shap does when the budget allows — gives EXACT Shapley
    values from the weighted regression)."""
    from itertools import combinations
    from math import comb

    c = n_features
    masks, weights = [], []
    for s in range(1, c):
        w = (c - 1) / (comb(c, s) * s * (c - s))
        for members in combinations(range(c), s):
            z = np.zeros(c, dtype=np.float64)
            z[list(members)] = 1.0
            masks.append(z)
            weights.append(w)
    return np.asarray(masks), np.asarray(weights)


def _stratified_coalitions(
    rng: np.random.RandomState, n_features: int, nsamples: int
):
    """Mid-size-C budget allocation like shap's KernelExplainer: enumerate
    COMPLETE size strata (paired s and C-s, smallest sizes first — they carry
    the largest Shapley-kernel weight per coalition) while the budget covers
    them, then spend the remainder sampling from the residual sizes. Complete
    strata contribute exact-kernel-weighted rows (zero sampling variance for
    the heaviest strata); sampled rows share the residual weight mass.
    """
    from itertools import combinations
    from math import comb

    c = n_features
    sizes = np.arange(1, c)
    kernel = (c - 1) / (sizes * (c - sizes))          # weight per coalition
    mass = kernel * np.array([comb(c, int(s)) for s in sizes])  # per stratum

    # visiting order: (1, C-1), (2, C-2), ... — outermost pairs first
    order = []
    lo, hi = 1, c - 1
    while lo <= hi:
        order.append(lo)
        if hi != lo:
            order.append(hi)
        lo += 1
        hi -= 1

    masks, weights = [], []
    budget = nsamples
    enumerated = set()
    for s in order:
        n_s = comb(c, s)
        if n_s > budget:
            break
        w = float(kernel[s - 1])
        for members in combinations(range(c), s):
            z = np.zeros(c, np.float64)
            z[list(members)] = 1.0
            masks.append(z)
            weights.append(w)
        enumerated.add(s)
        budget -= n_s

    rest_sizes = [s for s in sizes if s not in enumerated]
    if budget > 0 and rest_sizes:
        rest_mass = np.array([mass[s - 1] for s in rest_sizes])
        rest_probs = rest_mass / rest_mass.sum()
        # the sampled rows jointly represent the residual kernel mass, on the
        # same (unnormalized) scale as the enumerated rows' exact weights
        w_each = float(rest_mass.sum()) / budget
        drawn = 0
        while drawn < budget:
            s = int(rng.choice(rest_sizes, p=rest_probs))
            members = rng.choice(c, size=s, replace=False)
            z = np.zeros(c, np.float64)
            z[members] = 1.0
            masks.append(z)
            weights.append(w_each)
            drawn += 1
            if drawn < budget:
                masks.append(1.0 - z)
                weights.append(w_each)
                drawn += 1
    return np.asarray(masks), np.asarray(weights)


def kernel_shap_values(
    f_batch: Callable[[np.ndarray], np.ndarray],
    x_explain: np.ndarray,
    background: np.ndarray,
    nsamples: int = 100,
    seed: int = 42,
) -> np.ndarray:
    """SHAP values (n_explain, C) for a scalar-output model ``f_batch``.

    ``f_batch`` maps (N, C) feature rows to (N,) outputs and is called once
    per explained sample with the full (M * n_background, C) matrix.

    Coalition budget tiers: when all 2^C - 2 coalitions fit ``nsamples`` they
    are enumerated with exact Shapley-kernel weights (exact Shapley values,
    matching shap's exhaustive mode); when at least the outermost size strata
    fit (mid-size C — e.g. the 61-channel montage with the default budget)
    complete strata are enumerated and only the residual sizes are sampled;
    otherwise pure paired kernel sampling.
    """
    rng = np.random.RandomState(seed)
    x_explain = np.asarray(x_explain, np.float64)
    background = np.asarray(background, np.float64)
    n_explain, c = x_explain.shape
    nb = background.shape[0]

    def _materialize(out):
        parts = out if isinstance(out, list) else [out]
        return np.concatenate([np.asarray(p, np.float64) for p in parts])

    phi0 = float(np.mean(_materialize(f_batch(background))))
    fx_all = _materialize(f_batch(x_explain))

    if c <= 24 and 2**c - 2 <= nsamples:
        z, weights = _enumerate_coalitions(c)
    elif nsamples >= 2 * c:  # at least the (1, C-1) strata fit: stratify
        z, weights = _stratified_coalitions(rng, c, nsamples)
    else:
        z = _sample_coalitions(rng, c, nsamples)  # (M, C)
        weights = np.ones(len(z))
    m = len(z)
    sqrt_w = np.sqrt(weights)[:, None]
    design = z[:, :-1] - z[:, -1:]

    shap_values = np.zeros((n_explain, c))

    def solve(i, v):
        fx = fx_all[i]
        # eliminate last feature via the sum constraint; weighted LSQ
        target = v - phi0 - z[:, -1] * (fx - phi0)
        coef, *_ = np.linalg.lstsq(design * sqrt_w, target * sqrt_w[:, 0],
                                   rcond=None)
        phi = np.empty(c)
        phi[:-1] = coef
        phi[-1] = (fx - phi0) - coef.sum()
        shap_values[i] = phi

    # keep a few model evaluations in flight before forcing each result to
    # host, so the device's work overlaps the host's rows and regressions
    inflight: list = []

    def drain(limit: int) -> None:
        while len(inflight) > limit:
            i0, pending = inflight.pop(0)
            v = np.concatenate(
                [np.asarray(p, np.float64) for p in pending]
            ).reshape(m, nb).mean(axis=1)
            solve(i0, v)

    for i in range(n_explain):
        x = x_explain[i]
        # synthetic inputs: for each coalition, x where z=1 else background rows
        synth = np.where(
            z[:, None, :] > 0, x[None, None, :], background[None, :, :]
        ).reshape(-1, c)  # (M*nb, C)
        out = f_batch(synth)
        inflight.append((i, out if isinstance(out, list) else [out]))
        drain(6)
    drain(0)
    return shap_values


def kernel_shap_channel_importance(
    params,
    model_cfg: ModelConfig,
    x: np.ndarray,
    n_background: int = 100,
    n_explain: int = 200,
    nsamples: int = 100,
    seq_len: Optional[int] = None,
    seed: int = 42,
    channel_names: Optional[Sequence[str]] = None,
    batch_size: int = 10240,
) -> Dict[str, object]:
    """Channel importance via KernelSHAP on time-mean-collapsed windows
    (ref 07:364-508), on the device of ``params`` (a torch parameter tree).
    Returns mean |SHAP| per channel plus raw values."""
    device = next(iter(params.parameters())).device
    rng = np.random.RandomState(seed)
    t = seq_len or x.shape[1]
    collapsed = x.mean(axis=1)  # (N, C) time-mean collapse (ref 07:411-414)

    bg_idx = rng.choice(len(collapsed), min(n_background, len(collapsed)),
                        replace=False)
    ex_idx = rng.choice(len(collapsed), min(n_explain, len(collapsed)),
                        replace=False)
    background = collapsed[bg_idx]
    explain = collapsed[ex_idx]

    def rows_to_prob(rows: torch.Tensor) -> torch.Tensor:
        # tile across time on the device: only the (B, C) feature rows cross
        # from the host
        tiled = rows[:, None, :].expand(rows.shape[0], t, rows.shape[1])
        logits = classifier_apply(params, tiled, model_cfg, compute_dtype=torch.bfloat16)
        return torch.softmax(logits, dim=-1)[:, 1]

    def f_batch(feat_rows: np.ndarray):
        # a list of host copies still on their way: the caller keeps a few
        # evaluations in flight and reads them late
        out = []
        n = len(feat_rows)
        for i in range(0, n, batch_size):
            chunk = feat_rows[i : i + batch_size].astype(np.float32)
            k = len(chunk)
            if k < batch_size and n > batch_size:
                chunk = np.concatenate(
                    [chunk, np.zeros((batch_size - k, chunk.shape[1]), np.float32)]
                )
            rows = torch.from_numpy(chunk)
            if device.type == "cuda":  # an asynchronous upload needs pinned memory
                rows = rows.pin_memory()
            with torch.inference_mode():
                prob = rows_to_prob(rows.to(device, non_blocking=True))
            out.append(HostCopy(prob[:k]))
        return out  # class-1 (eyes closed) probability chunks

    values = kernel_shap_values(f_batch, explain, background, nsamples, seed)
    importance = np.abs(values).mean(axis=0)
    importance = importance / (importance.sum() + 1e-12)

    names = list(channel_names) if channel_names else [
        f"Ch{i+1}" for i in range(x.shape[2])
    ]
    order = np.argsort(-importance)
    return {
        "channels": names,
        "importance": importance.tolist(),
        "shap_values": values,
        "x_explain": explain,  # the time-collapsed rows the values explain
        "ranking": [names[i] for i in order],
        "method": "kernel_shap",
    }
