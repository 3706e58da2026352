"""The figures of the pipeline's stages (``eegflow.viz.figures``): one
function per figure family, each saving PNG and PDF at 300 dpi through
:func:`save_figure`, on matplotlib's Agg backend.

matplotlib is imported when a figure is drawn (:func:`pyplot`), not when
this module is: the stages import it where matplotlib is absent, and
:func:`ode_analysis_series`, fig10's device work, needs no matplotlib.
Plotting arithmetic stays host numpy, as in the JAX package.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

DPI = 300
STATE_COLORS = {"Active": "#2ca02c", "Passive": "#ff7f0e", "Fatigued": "#d62728"}
STATE_NAMES = ("Active", "Passive", "Fatigued")


# fig10's canonical initial states (ref 05:497-684)
ODE_ANALYSIS_INITS = {"mixed": [0.33, 0.34, 0.33], "active": [0.8, 0.1, 0.1],
                      "fatigued": [0.1, 0.1, 0.8]}


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend (headless); raises
    ``ModuleNotFoundError`` where matplotlib does not import."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_figure(fig, path_base: str | Path, formats=("png", "pdf")) -> List[str]:
    """Save PNG+PDF at 300 dpi (the reference's convention) and close."""
    plt = pyplot()
    path_base = Path(path_base)
    path_base.parent.mkdir(parents=True, exist_ok=True)
    written = []
    for ext in formats:
        p = path_base.with_suffix(f".{ext}")
        fig.savefig(p, dpi=DPI, bbox_inches="tight")
        written.append(str(p))
    plt.close(fig)
    return written


def plot_class_distribution(y_by_split: Dict[str, np.ndarray], path_base) -> List[str]:
    """Per-split class balance bars (ref 01:307-335)."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(7, 4))
    splits = list(y_by_split)
    width = 0.35
    xs = np.arange(len(splits))
    open_counts = [int((np.asarray(y) == 0).sum()) for y in y_by_split.values()]
    closed_counts = [int((np.asarray(y) == 1).sum()) for y in y_by_split.values()]
    ax.bar(xs - width / 2, open_counts, width, label="Eyes open", color="#1f77b4")
    ax.bar(xs + width / 2, closed_counts, width, label="Eyes closed", color="#d62728")
    ax.set_xticks(xs, splits)
    ax.set_ylabel("Windows")
    ax.set_title("Class distribution per split")
    ax.legend()
    return save_figure(fig, path_base)


def plot_sample_timeseries(
    data: np.ndarray, fs: float, channel_names: Sequence[str], path_base,
    n_channels: int = 6, duration_s: float = 5.0,
) -> List[str]:
    """Stacked multichannel traces (ref 01:338-381)."""
    plt = pyplot()
    n_t = min(int(duration_s * fs), data.shape[1])
    t = np.arange(n_t) / fs
    fig, axes = plt.subplots(n_channels, 1, figsize=(10, 1.2 * n_channels),
                             sharex=True)
    for i, ax in enumerate(np.atleast_1d(axes)):
        ax.plot(t, data[i, :n_t] * 1e6, lw=0.5, color="#1f77b4")
        ax.set_ylabel(channel_names[i], rotation=0, ha="right", fontsize=8)
        ax.tick_params(labelsize=7)
    np.atleast_1d(axes)[-1].set_xlabel("Time (s)")
    fig.suptitle("Sample EEG time series (uV)")
    return save_figure(fig, path_base)


def plot_spectral_analysis(spectral: Dict, path_base) -> List[str]:
    """PSD open-vs-closed + band-power ratios (ref 01:384-507)."""
    plt = pyplot()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    freqs = np.asarray(spectral["psd"]["freqs"])
    ax1.semilogy(freqs, spectral["psd"]["open"], label="Eyes open", color="#1f77b4")
    ax1.semilogy(freqs, spectral["psd"]["closed"], label="Eyes closed", color="#d62728")
    ax1.axvspan(8, 13, alpha=0.15, color="green", label="Alpha band")
    ax1.set_xlim(0, 50)
    ax1.set_xlabel("Frequency (Hz)")
    ax1.set_ylabel("PSD (V^2/Hz)")
    ax1.set_title("Welch PSD")
    ax1.legend()
    bands = spectral["bands"]
    names = list(bands)
    ratios = [bands[b]["ratio"] for b in names]
    ax2.bar(names, ratios, color=["#999" if b != "alpha" else "#2ca02c" for b in names])
    ax2.axhline(1.0, color="k", lw=0.5)
    ax2.set_ylabel("Closed/Open power ratio")
    ax2.set_title("Band-power ratios (alpha biomarker)")
    return save_figure(fig, path_base)


def plot_preprocessing_overview(
    raw: np.ndarray, filtered: np.ndarray, normalized: np.ndarray,
    fs: float, path_base, channel: int = 0, duration_s: float = 4.0,
) -> List[str]:
    """Raw -> filtered -> normalized pipeline stages (ref 02:417-523)."""
    plt = pyplot()
    n_t = min(int(duration_s * fs), raw.shape[1])
    t = np.arange(n_t) / fs
    fig, axes = plt.subplots(3, 1, figsize=(10, 7), sharex=True)
    axes[0].plot(t, raw[channel, :n_t] * 1e6, lw=0.6)
    axes[0].set_title("Raw (uV)")
    axes[1].plot(t, filtered[channel, :n_t] * 1e6, lw=0.6, color="#ff7f0e")
    axes[1].set_title("Bandpass 1-45 Hz (uV)")
    axes[2].plot(t, normalized[channel, :n_t], lw=0.6, color="#2ca02c")
    axes[2].set_title("Z-scored")
    axes[2].set_xlabel("Time (s)")
    return save_figure(fig, path_base)


def plot_baseline_comparison(results: Dict[str, Dict], path_base) -> List[str]:
    """Accuracy/F1/AUC bars with bootstrap CIs (ref 03:666-757)."""
    plt = pyplot()
    models = list(results)
    metrics = ["accuracy", "f1", "auc"]
    fig, ax = plt.subplots(figsize=(8, 4.5))
    width = 0.25
    xs = np.arange(len(models))
    for i, m in enumerate(metrics):
        vals = [results[name].get(m, np.nan) for name in models]
        bars = ax.bar(xs + (i - 1) * width, vals, width, label=m.upper())
        if m == "accuracy":
            for j, name in enumerate(models):
                ci = results[name].get("accuracy_ci_95")
                if ci:
                    ax.errorbar(xs[j] + (i - 1) * width, vals[j],
                                yerr=[[vals[j] - ci[0]], [ci[1] - vals[j]]],
                                fmt="none", ecolor="k", capsize=3, lw=1)
    ax.set_xticks(xs, models, rotation=15)
    ax.set_ylim(0, 1)
    ax.set_title("Model comparison")
    ax.legend()
    return save_figure(fig, path_base)


def plot_training_history(history: Dict[str, list], path_base) -> List[str]:
    """Loss/accuracy/F1/LR curves (ref 04:678-716)."""
    plt = pyplot()
    fig, axes = plt.subplots(2, 2, figsize=(11, 7))
    epochs = np.arange(1, len(history["train_loss"]) + 1)
    axes[0, 0].plot(epochs, history["train_loss"], label="train")
    axes[0, 0].plot(epochs, history["val_loss"], label="val")
    axes[0, 0].set_title("Loss")
    axes[0, 0].legend()
    axes[0, 1].plot(epochs, history["train_acc"], label="train")
    axes[0, 1].plot(epochs, history["val_acc"], label="val")
    axes[0, 1].set_title("Accuracy")
    axes[0, 1].legend()
    axes[1, 0].plot(epochs, history["val_f1"], color="#2ca02c")
    axes[1, 0].set_title("Validation F1")
    axes[1, 1].plot(epochs, history["learning_rates"], color="#9467bd")
    axes[1, 1].set_title("Learning rate")
    axes[1, 1].set_yscale("log")
    for ax in axes.flat:
        ax.set_xlabel("Epoch")
    return save_figure(fig, path_base)


def plot_attention_weights(
    attention: np.ndarray, y: np.ndarray, path_base, fs: float = 500.0,
) -> List[str]:
    """Per-class mean attention + sample heatmap (ref 04:719-776, 07:892-987)."""
    plt = pyplot()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    t = np.arange(attention.shape[1]) / fs * 1000  # ms
    for cls, name, color in ((0, "Open", "#1f77b4"), (1, "Closed", "#d62728")):
        mask = np.asarray(y) == cls
        if mask.sum():
            mean = attention[mask].mean(0)
            std = attention[mask].std(0)
            ax1.plot(t, mean, label=f"Eyes {name}", color=color)
            ax1.fill_between(t, mean - std, mean + std, alpha=0.2, color=color)
    ax1.set_xlabel("Time (ms)")
    ax1.set_ylabel("Attention weight")
    ax1.set_title("Mean temporal attention by class")
    ax1.legend()
    n_show = min(50, len(attention))
    im = ax2.imshow(attention[:n_show], aspect="auto", cmap="viridis")
    ax2.set_xlabel("Time step")
    ax2.set_ylabel("Sample")
    ax2.set_title("Attention heatmap")
    fig.colorbar(im, ax=ax2)
    return save_figure(fig, path_base)


def ode_analysis_series(k, device=None) -> Dict[str, np.ndarray]:
    """fig10's device work, without matplotlib: the APF trajectories from
    the three canonical initial states (:data:`ODE_ANALYSIS_INITS`) over
    ``linspace(0, 60, 120)`` in one batched RK4 solve (kernel 11's
    trajectory mode on the card) and the steady state of the rates ``k``
    (6,) -> ``{"t": (120,), "trajectories": (3, 120, 3), "steady_state":
    (3,)}`` as host arrays. Runs on ``device``, the card unless the caller
    asks for the CPU."""
    import torch

    from eegflow_torch.ode import solve, steady_state

    k = torch.as_tensor(np.asarray(k, np.float32), device=torch.device(device or "cuda"))
    y0 = torch.tensor(list(ODE_ANALYSIS_INITS.values()), dtype=torch.float32, device=k.device)
    t, traj = solve(y0, (0, 60), 120, k=k)
    return {"t": t.cpu().numpy(), "trajectories": traj.transpose(0, 1).cpu().numpy(),
            "steady_state": steady_state(k).cpu().numpy()}


def plot_ode_analysis(
    k: np.ndarray, path_base, sensitivity: Optional[Dict] = None, device=None,
) -> List[str]:
    """Trajectories from canonical inits + steady state + sensitivity heatmap
    (ref 05:497-684); the series from :func:`ode_analysis_series` on
    ``device`` (the card unless the caller asks for the CPU)."""
    from eegflow_torch.ode.field import RATE_NAMES

    plt = pyplot()
    series = ode_analysis_series(k, device)
    fig, axes = plt.subplots(1, 3 if sensitivity else 2, figsize=(14, 4))
    for name, traj in zip(ODE_ANALYSIS_INITS, series["trajectories"]):
        for j, state in enumerate(STATE_NAMES):
            axes[0].plot(series["t"], traj[:, j],
                         color=STATE_COLORS[state], alpha=0.8,
                         label=state if name == "mixed" else None)
    axes[0].set_xlabel("Time")
    axes[0].set_ylabel("Proportion")
    axes[0].set_title("APF trajectories")
    axes[0].legend()

    axes[1].bar(STATE_NAMES, series["steady_state"],
                color=[STATE_COLORS[s] for s in STATE_NAMES])
    axes[1].set_ylim(0, 1)
    axes[1].set_title("Steady state")

    if sensitivity:
        sens = sensitivity["sensitivities"]
        mat = np.asarray([[sens[r][s] for s in STATE_NAMES] for r in RATE_NAMES])
        im = axes[2].imshow(mat, cmap="RdBu_r",
                            vmin=-np.abs(mat).max(), vmax=np.abs(mat).max())
        axes[2].set_xticks(range(3), STATE_NAMES)
        axes[2].set_yticks(range(6), RATE_NAMES)
        axes[2].set_title("d(steady)/d(rate)")
        fig.colorbar(im, ax=axes[2])
    return save_figure(fig, path_base)


def plot_state_diagram(rates: Dict[str, float], path_base) -> List[str]:
    """Three-node transition diagram with rate labels (ref 05:594-684)."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(6, 6))
    pos = {"A": (0, 1), "P": (-0.9, -0.5), "F": (0.9, -0.5)}
    full = {"A": "Active", "P": "Passive", "F": "Fatigued"}
    for s, (x, y) in pos.items():
        ax.add_patch(plt.Circle((x, y), 0.28, color=STATE_COLORS[full[s]],
                                alpha=0.85, zorder=2))
        ax.text(x, y, full[s], ha="center", va="center", fontsize=10,
                color="white", weight="bold", zorder=3)
    edges = [("A", "P", "k_ap"), ("P", "A", "k_pa"), ("A", "F", "k_af"),
             ("F", "A", "k_fa"), ("P", "F", "k_pf"), ("F", "P", "k_fp")]
    for src, dst, name in edges:
        x1, y1 = pos[src]
        x2, y2 = pos[dst]
        dx, dy = x2 - x1, y2 - y1
        norm = np.hypot(dx, dy)
        off = 0.08 * np.array([-dy, dx]) / norm
        ax.annotate(
            "", xy=(x2 - 0.3 * dx / norm + off[0], y2 - 0.3 * dy / norm + off[1]),
            xytext=(x1 + 0.3 * dx / norm + off[0], y1 + 0.3 * dy / norm + off[1]),
            arrowprops=dict(arrowstyle="-|>", color="#444", lw=1.4),
        )
        ax.text((x1 + x2) / 2 + 2.5 * off[0], (y1 + y2) / 2 + 2.5 * off[1],
                f"{name}={rates[name]:.3f}", fontsize=8, ha="center")
    ax.set_xlim(-1.5, 1.5)
    ax.set_ylim(-1.2, 1.6)
    ax.axis("off")
    ax.set_title("Cognitive state transition diagram")
    return save_figure(fig, path_base)


def plot_coupling_analysis(sweep: Dict[str, Dict[str, float]], path_base) -> List[str]:
    """Metrics vs coupling strength alpha (ref 06:553-573)."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(7, 4))
    alphas = [float(a) for a in sweep]
    for metric in ("accuracy", "f1", "mcc"):
        ax.plot(alphas, [sweep[a][metric] for a in sweep], marker="o", label=metric)
    ax.set_xlabel("Coupling strength alpha")
    ax.set_ylabel("Metric")
    ax.set_title("Coupling-strength sensitivity")
    ax.legend()
    return save_figure(fig, path_base)


def plot_trajectory_examples(
    trajectories: np.ndarray, probs: np.ndarray, path_base, n_show: int = 6,
) -> List[str]:
    """Example APF trajectories with their LSTM probabilities (ref 06:578-633)."""
    plt = pyplot()
    n_show = min(n_show, len(trajectories))
    fig, axes = plt.subplots(2, (n_show + 1) // 2, figsize=(4 * ((n_show + 1) // 2), 6),
                             squeeze=False)
    for i in range(n_show):
        ax = axes[i % 2][i // 2]
        for j, state in enumerate(STATE_NAMES):
            ax.plot(trajectories[i, :, j], color=STATE_COLORS[state], label=state)
        ax.set_title(f"P(closed)={probs[i, 1]:.2f}", fontsize=9)
        ax.set_ylim(0, 1)
        if i == 0:
            ax.legend(fontsize=7)
    fig.suptitle("Coupled LSTM-ODE trajectories")
    return save_figure(fig, path_base)


def plot_channel_importance(
    importance: Dict, path_base, top_k: int = 20,
) -> List[str]:
    """Top-k channel importance bars (ref 07:786-889)."""
    plt = pyplot()
    imp = np.asarray(importance["importance"])
    names = importance["channels"]
    order = np.argsort(-imp)[:top_k]
    fig, ax = plt.subplots(figsize=(9, 4.5))
    ax.bar([names[i] for i in order], imp[order], color="#1f77b4")
    ax.set_ylabel("Importance")
    ax.set_title(f"Channel importance — {importance.get('method', '')}")
    plt.setp(ax.get_xticklabels(), rotation=60, ha="right", fontsize=7)
    return save_figure(fig, path_base)


def plot_importance_comparison(comparison: Dict, path_base) -> List[str]:
    """Method correlation heatmap + scatter (ref 07:1102-1204)."""
    plt = pyplot()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.5))
    corr = np.asarray(comparison["correlation_matrix"])
    im = ax1.imshow(corr, cmap="RdBu_r", vmin=-1, vmax=1)
    methods = comparison["methods"]
    ax1.set_xticks(range(len(methods)), methods, rotation=30)
    ax1.set_yticks(range(len(methods)), methods)
    for i in range(len(methods)):
        for j in range(len(methods)):
            ax1.text(j, i, f"{corr[i, j]:.2f}", ha="center", va="center", fontsize=8)
    ax1.set_title("Importance-method correlation")
    fig.colorbar(im, ax=ax1)
    mat = np.asarray(comparison["normalized"])
    if len(mat) >= 2:
        ax2.scatter(mat[0], mat[1], s=14)
        ax2.set_xlabel(methods[0])
        ax2.set_ylabel(methods[1])
        r = corr[0, 1]
        ax2.set_title(f"Per-channel scores (r={r:.2f})")
    return save_figure(fig, path_base)


def plot_forecasting_results(
    forecast_results: Dict, metrics: Dict, horizons: Sequence[int], path_base,
) -> List[str]:
    """Pred-vs-actual per horizon + metric bars (ref 08:395-515)."""
    plt = pyplot()
    fig, axes = plt.subplots(1, len(horizons) + 1,
                             figsize=(4 * (len(horizons) + 1), 3.6))
    for i, h in enumerate(horizons):
        ax = axes[i]
        preds = np.asarray(forecast_results[h]["predictions"])[:200]
        actuals = np.asarray(forecast_results[h]["actuals"])[:200]
        ax.plot(actuals, lw=0.8, label="actual")
        ax.plot(preds, lw=0.8, label="forecast")
        m = metrics.get(h, {})
        ax.set_title(f"h={h} (acc={m.get('accuracy', 0):.2f})", fontsize=9)
        if i == 0:
            ax.legend(fontsize=7)
    ax = axes[-1]
    hs = [str(h) for h in horizons]
    ax.bar(hs, [metrics[h]["mae"] for h in horizons], color="#ff7f0e")
    ax.set_title("MAE by horizon")
    ax.set_xlabel("Horizon")
    return save_figure(fig, path_base)


def plot_comprehensive_comparison(all_results: Dict, path_base) -> List[str]:
    """Model-zoo comparison: metric bars + accuracy CIs + radar
    (ref 06:636-777)."""
    plt = pyplot()
    models = list(all_results)
    metrics = ["accuracy", "f1", "auc", "mcc"]
    fig = plt.figure(figsize=(13, 4.5))
    ax1 = fig.add_subplot(1, 3, 1)
    xs = np.arange(len(models))
    width = 0.8 / len(metrics)
    for i, m in enumerate(metrics):
        vals = [all_results[n].get(m) or np.nan for n in models]
        ax1.bar(xs + (i - 1.5) * width, vals, width, label=m.upper())
    ax1.set_xticks(xs, models, rotation=25, ha="right", fontsize=7)
    ax1.legend(fontsize=7)
    ax1.set_title("Metrics")

    ax2 = fig.add_subplot(1, 3, 2)
    accs = [all_results[n].get("accuracy") or 0 for n in models]
    cis = [all_results[n].get("accuracy_ci_95") or [a, a]
           for n, a in zip(models, accs)]
    err = [[a - c[0] for a, c in zip(accs, cis)],
           [c[1] - a for a, c in zip(accs, cis)]]
    ax2.errorbar(xs, accs, yerr=err, fmt="o", capsize=4)
    ax2.set_xticks(xs, models, rotation=25, ha="right", fontsize=7)
    ax2.set_title("Accuracy (95% bootstrap CI)")

    ax3 = fig.add_subplot(1, 3, 3, projection="polar")
    angles = np.linspace(0, 2 * np.pi, len(metrics), endpoint=False).tolist()
    for name in models:
        vals = [all_results[name].get(m) or 0 for m in metrics]
        vals = [max(v, 0) if v == v else 0 for v in vals]
        ax3.plot(angles + angles[:1], vals + vals[:1], lw=1, label=name)
        ax3.fill(angles + angles[:1], vals + vals[:1], alpha=0.08)
    ax3.set_xticks(angles, [m.upper() for m in metrics], fontsize=7)
    ax3.legend(fontsize=5, loc="lower right", bbox_to_anchor=(1.3, -0.15))
    return save_figure(fig, path_base)


def plot_ablation_results(
    results: Dict, cis: Optional[Dict] = None, path_base="ablation",
) -> List[str]:
    """Per-config accuracy bars with CIs (ref 09:522-668)."""
    plt = pyplot()
    names = list(results)
    accs = [results[n]["metrics"]["accuracy"] for n in names]
    fig, ax = plt.subplots(figsize=(8, 4.5))
    bars = ax.bar(names, accs, color="#1f77b4")
    if cis:
        err_low = [accs[i] - cis[n]["lower"] for i, n in enumerate(names)]
        err_hi = [cis[n]["upper"] - accs[i] for i, n in enumerate(names)]
        ax.errorbar(names, accs, yerr=[err_low, err_hi], fmt="none",
                    ecolor="k", capsize=3)
    ax.set_ylabel("Test accuracy")
    ax.set_title("Architecture ablation")
    plt.setp(ax.get_xticklabels(), rotation=20, ha="right")
    return save_figure(fig, path_base)


def plot_shap_analysis(
    shap_values: np.ndarray,
    x_explain: np.ndarray,
    channel_names: Sequence[str],
    path_base,
    gradient_importance: Optional[np.ndarray] = None,
    seed: int = 0,
) -> List[str]:
    """Six-panel SHAP battery (ref 07_explainability.py:511-678).

    ``shap_values``/``x_explain``: (N, C) class-1 SHAP values and the
    time-collapsed features they explain. Panels: top-15 |SHAP| bars colored
    by region, beeswarm-style distribution, regional aggregation, per-sample
    heatmap, dependence plot for the top channel (colored by its strongest
    interactor), and — instead of the reference's placeholder sixth panel —
    the SHAP-vs-gradient scatter when gradient importances are given.
    """
    from eegflow_torch.viz.regions import aggregate_by_region, region_of

    plt = pyplot()

    shap_values = np.asarray(shap_values, np.float64)
    x_explain = np.asarray(x_explain, np.float64)
    channel_names = [str(c) for c in channel_names]
    mean_abs = np.abs(shap_values).mean(axis=0)
    order = np.argsort(-mean_abs)

    region_color = {"Occipital": "#e74c3c", "Parietooccipital": "#e74c3c",
                    "Frontal": "#3498db", "Prefrontal": "#3498db",
                    "Temporal": "#2ecc71"}

    fig, axes = plt.subplots(2, 3, figsize=(18, 11))

    # 1. top-15 |SHAP| bars, region-colored (ref 07:524-548)
    ax = axes[0, 0]
    top15 = order[:15]
    colors = [region_color.get(region_of(channel_names[i]), "#9b59b6")
              for i in top15]
    ax.barh(range(len(top15)), mean_abs[top15], color=colors, edgecolor="black")
    ax.set_yticks(range(len(top15)), [channel_names[i] for i in top15])
    ax.set_xlabel("Mean |SHAP value|")
    ax.set_title("SHAP feature importance (top 15)")
    ax.invert_yaxis()

    # 2. beeswarm-style distribution, top 10 (ref 07:550-580)
    ax = axes[0, 1]
    rng_j = np.random.default_rng(seed)
    sc = None
    for row, i in enumerate(order[:10][::-1]):
        feat = x_explain[:, i]
        span = feat.max() - feat.min()
        norm = (feat - feat.min()) / (span + 1e-10)
        jitter = row + rng_j.uniform(-0.2, 0.2, len(shap_values))
        sc = ax.scatter(shap_values[:, i], jitter, c=norm, cmap="RdBu_r",
                        s=10, alpha=0.6)
    ax.set_yticks(range(10), [channel_names[i] for i in order[:10][::-1]])
    ax.axvline(0.0, color="gray", linestyle="--", linewidth=1)
    ax.set_xlabel("SHAP value")
    ax.set_title("SHAP value distribution (top 10)")
    if sc is not None:
        fig.colorbar(sc, ax=ax, label="Feature value")

    # 3. regional aggregation (ref 07:582-608)
    ax = axes[0, 2]
    by_region = aggregate_by_region(channel_names, mean_abs)
    regions = sorted(by_region, key=lambda r: -by_region[r])
    vals = [by_region[r] for r in regions]
    shades = plt.cm.YlOrRd([v / (max(vals) + 1e-12) for v in vals])
    ax.barh(regions, vals, color=shades, edgecolor="black")
    ax.set_xlabel("Aggregated |SHAP|")
    ax.set_title("SHAP importance by brain region")
    ax.invert_yaxis()

    # 4. per-sample heatmap, top 20 channels (ref 07:610-629)
    ax = axes[1, 0]
    n_show = min(50, len(shap_values))
    top20 = order[:20]
    hm = shap_values[:n_show][:, top20]
    lim = np.percentile(np.abs(hm), 95) + 1e-12
    im = ax.imshow(hm.T, aspect="auto", cmap="RdBu_r", vmin=-lim, vmax=lim)
    ax.set_xlabel("Sample index")
    ax.set_yticks(range(len(top20)), [channel_names[i] for i in top20],
                  fontsize=7)
    ax.set_title("SHAP values heatmap (top 20 channels)")
    fig.colorbar(im, ax=ax, label="SHAP value")

    # 5. dependence plot for the top channel (ref 07:631-655)
    ax = axes[1, 1]
    top_i = int(order[0])
    shap_top = shap_values[:, top_i]
    corr_best, inter_i = -1.0, (top_i + 1) % len(channel_names)
    for i in range(len(channel_names)):
        if i == top_i:
            continue
        f = x_explain[:, i]
        if np.std(f) < 1e-12 or np.std(shap_top) < 1e-12:
            continue
        c = abs(np.corrcoef(shap_top, f)[0, 1])
        if np.isfinite(c) and c > corr_best:
            corr_best, inter_i = c, i
    sc = ax.scatter(x_explain[:, top_i], shap_top, c=x_explain[:, inter_i],
                    cmap="coolwarm", s=20, alpha=0.7, edgecolors="k",
                    linewidth=0.3)
    ax.axhline(0.0, color="gray", linestyle="--", linewidth=1)
    ax.set_xlabel(f"{channel_names[top_i]} value")
    ax.set_ylabel(f"SHAP value for {channel_names[top_i]}")
    ax.set_title(f"SHAP dependence: {channel_names[top_i]}")
    fig.colorbar(sc, ax=ax, label=f"{channel_names[inter_i]} value")

    # 6. SHAP vs gradient scatter (the reference leaves this panel as a
    # placeholder, ref 07:657-663; filled in here when gradients exist)
    ax = axes[1, 2]
    if gradient_importance is not None and len(gradient_importance) == len(mean_abs):
        g = np.asarray(gradient_importance, np.float64)
        ax.scatter(g / (g.sum() + 1e-12), mean_abs / (mean_abs.sum() + 1e-12),
                   s=25, alpha=0.7, edgecolors="k", linewidth=0.3)
        r = np.corrcoef(g, mean_abs)[0, 1] if np.std(g) > 0 else np.nan
        ax.set_xlabel("Gradient importance (normalized)")
        ax.set_ylabel("SHAP importance (normalized)")
        ax.set_title(f"SHAP vs gradient (Pearson r={r:.3f})")
    else:
        ax.text(0.5, 0.5, "SHAP vs gradient\n(gradient scores unavailable)",
                ha="center", va="center", transform=ax.transAxes)
        ax.axis("off")

    fig.suptitle("SHAP channel attribution", fontweight="bold")
    fig.tight_layout()
    return save_figure(fig, path_base)


def plot_attention_explainability(
    attention: np.ndarray, y: np.ndarray, path_base,
) -> List[str]:
    """Six-panel deep attention analysis (ref 07_explainability.py:892-987):
    mean±CI, per-class curves, closed-open difference bars, peak-sorted
    heatmap, peak-position histogram, early-vs-late scatter."""
    plt = pyplot()
    attention = np.asarray(attention, np.float64)
    y = np.asarray(y)
    t = np.arange(attention.shape[1])
    mean_a = attention.mean(axis=0)
    std_a = attention.std(axis=0)

    fig, axes = plt.subplots(2, 3, figsize=(16, 9))

    ax = axes[0, 0]
    ax.plot(t, mean_a, color="#1f77b4", linewidth=2, label="Mean attention")
    ax.fill_between(t, mean_a - 1.96 * std_a, mean_a + 1.96 * std_a,
                    alpha=0.3, color="#1f77b4", label="95% CI")
    ax.axhline(1.0 / len(t), color="red", linestyle="--", label="Uniform")
    ax.set_xlabel("Time step")
    ax.set_ylabel("Attention weight")
    ax.set_title("Temporal attention pattern")
    ax.legend(fontsize=8)

    ax = axes[0, 1]
    for cls, (name, color) in enumerate((("Open", "#3498db"), ("Closed", "#e74c3c"))):
        mask = y == cls
        if mask.any():
            ax.plot(t, attention[mask].mean(axis=0), color=color,
                    linewidth=2, label=name)
    ax.set_xlabel("Time step")
    ax.set_ylabel("Attention weight")
    ax.set_title("Attention by eye state")
    ax.legend(fontsize=8)

    ax = axes[0, 2]
    if (y == 0).any() and (y == 1).any():
        diff = attention[y == 1].mean(axis=0) - attention[y == 0].mean(axis=0)
        ax.bar(t, diff, color=["#e74c3c" if d > 0 else "#3498db" for d in diff],
               alpha=0.7)
    ax.axhline(0.0, color="black", linewidth=1)
    ax.set_xlabel("Time step")
    ax.set_ylabel("Attention difference")
    ax.set_title("Closed − open attention")

    ax = axes[1, 0]
    peaks = attention.argmax(axis=1)
    order = np.argsort(peaks)[:100]
    im = ax.imshow(attention[order], aspect="auto", cmap="viridis")
    ax.set_xlabel("Time step")
    ax.set_ylabel("Sample (sorted by peak)")
    ax.set_title("Attention heatmap (peak-sorted)")
    fig.colorbar(im, ax=ax, label="Weight")

    ax = axes[1, 1]
    ax.hist(peaks, bins=20, color="steelblue", edgecolor="black", alpha=0.7)
    ax.axvline(peaks.mean(), color="red", linestyle="--", linewidth=2,
               label=f"Mean: {peaks.mean():.1f}")
    ax.set_xlabel("Peak position (time step)")
    ax.set_ylabel("Frequency")
    ax.set_title("Attention peak distribution")
    ax.legend(fontsize=8)

    ax = axes[1, 2]
    third = attention.shape[1] // 3
    early = attention[:, :third].mean(axis=1)
    late = attention[:, -third:].mean(axis=1)
    ax.scatter(early, late, c=y, cmap="RdYlBu", alpha=0.6, edgecolors="black")
    lim = max(early.max(), late.max()) * 1.05
    ax.plot([0, lim], [0, lim], "k--", label="y=x")
    ax.set_xlabel("Early attention (first 1/3)")
    ax.set_ylabel("Late attention (last 1/3)")
    ax.set_title("Early vs late attention")
    ax.legend(fontsize=8)

    fig.suptitle("Attention explainability", fontweight="bold")
    fig.tight_layout()
    return save_figure(fig, path_base)


def plot_ode_explainability(rates: Dict[str, float], path_base) -> List[str]:
    """Four-panel ODE dynamics explainability (ref 07_explainability.py:990-1099):
    transition-rate bars, time constants, state-transition network with
    rate-weighted arrows, recovery-vs-fatigue balance."""
    plt = pyplot()
    k = {n: float(rates[n]) for n in
         ("k_ap", "k_af", "k_pa", "k_pf", "k_fa", "k_fp")}
    transitions = ["A→P", "A→F", "P→A", "P→F", "F→A", "F→P"]
    vals = [k["k_ap"], k["k_af"], k["k_pa"], k["k_pf"], k["k_fa"], k["k_fp"]]
    colors = ["#e74c3c", "#c0392b", "#2ecc71", "#e74c3c", "#27ae60", "#3498db"]

    fig, axes = plt.subplots(2, 2, figsize=(13, 11))

    ax = axes[0, 0]
    bars = ax.bar(transitions, vals, color=colors, edgecolor="black")
    for bar, v in zip(bars, vals):
        ax.text(bar.get_x() + bar.get_width() / 2, bar.get_height() + 0.01,
                f"{v:.4f}", ha="center", fontsize=8)
    ax.set_ylabel("Transition rate")
    ax.set_title("ODE transition rates")

    ax = axes[0, 1]
    taus = [1.0 / v if v > 0 else 100.0 for v in vals]
    ax.bar(transitions, taus, color=colors, edgecolor="black")
    ax.set_ylabel("Time constant (1/rate)")
    ax.set_title("Transition time constants")

    # state network with rate-weighted arrows
    ax = axes[1, 0]
    pos = {"Active": np.array([0.5, 0.8]), "Passive": np.array([0.2, 0.3]),
           "Fatigued": np.array([0.8, 0.3])}
    node_color = {"Active": STATE_COLORS["Active"],
                  "Passive": STATE_COLORS["Passive"],
                  "Fatigued": STATE_COLORS["Fatigued"]}
    for name, p in pos.items():
        ax.add_patch(plt.Circle(p, 0.12, color=node_color[name],
                                ec="black", linewidth=2, zorder=5))
        ax.text(*p, name, ha="center", va="center", fontsize=9,
                fontweight="bold", color="white", zorder=10)
    edges = [("Active", "Passive", k["k_ap"], +1),
             ("Active", "Fatigued", k["k_af"], +1),
             ("Passive", "Active", k["k_pa"], -1),
             ("Passive", "Fatigued", k["k_pf"], +1),
             ("Fatigued", "Active", k["k_fa"], -1),
             ("Fatigued", "Passive", k["k_fp"], -1)]
    for a, b, rate, side in edges:
        d = pos[b] - pos[a]
        d = d / np.linalg.norm(d)
        perp = np.array([-d[1], d[0]]) * 0.03 * side
        ax.annotate("", xy=pos[b] - d * 0.14 + perp,
                    xytext=pos[a] + d * 0.14 + perp,
                    arrowprops=dict(arrowstyle="->", color="gray",
                                    lw=1 + rate * 5, mutation_scale=15))
    ax.set_xlim(-0.05, 1.05)
    ax.set_ylim(0, 1.05)
    ax.set_aspect("equal")
    ax.axis("off")
    ax.set_title("State transition network")

    ax = axes[1, 1]
    recovery = k["k_fa"] + k["k_fp"] + k["k_pa"]
    fatigue = k["k_af"] + k["k_pf"]
    ax.bar(["Recovery\n(F→A, F→P, P→A)", "Fatigue\n(A→F, P→F)"],
           [recovery, fatigue], color=["#2ecc71", "#e74c3c"],
           edgecolor="black")
    balance = recovery / fatigue if fatigue > 0 else float("inf")
    ax.text(0.5, 0.95, f"Balance ratio: {balance:.2f}", ha="center",
            fontsize=11, fontweight="bold", transform=ax.transAxes)
    ax.set_ylabel("Aggregate rate")
    ax.set_title("Recovery vs fatigue dynamics")

    fig.suptitle("ODE explainability", fontweight="bold")
    fig.tight_layout()
    return save_figure(fig, path_base)


def plot_sensitivity_heatmap(sensitivity: Dict[str, Dict[str, float]],
                             path_base) -> List[str]:
    """Annotated rate×state steady-state sensitivity heatmap
    (ref 05_ode_model.py:687-750). ``sensitivity``: {rate: {state: dS/dk}}."""
    plt = pyplot()
    rate_names = list(sensitivity)
    mat = np.array([[float(sensitivity[r].get(s, 0.0)) for s in STATE_NAMES]
                    for r in rate_names])
    fig, ax = plt.subplots(figsize=(9, 5.5))
    im = ax.imshow(mat, cmap="RdBu_r", aspect="auto", vmin=-1, vmax=1)
    ax.set_xticks(range(3), STATE_NAMES)
    ax.set_yticks(range(len(rate_names)),
                  [f"$k_{{{n[2:]}}}$" for n in rate_names])
    for i in range(len(rate_names)):
        for j in range(3):
            ax.text(j, i, f"{mat[i, j]:.3f}", ha="center", va="center",
                    fontsize=9)
    ax.set_title("Parameter sensitivity of the steady state\n"
                 "(Δ steady state per unit parameter change)")
    fig.colorbar(im, ax=ax, label="Sensitivity")
    fig.tight_layout()
    return save_figure(fig, path_base)
