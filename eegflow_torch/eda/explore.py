"""Exploratory data analysis (``eegflow.eda.explore``; stage 01, ref
01_data_exploration.py).

The dataset census, per-recording amplitude and duration statistics, the
Welch band powers of an eyes-open and an eyes-closed channel with the alpha
closed/open biomarker (ref 01:470-476), and the EDA markdown report (ref
01:510-568). The Welch PSD runs on the device (``signal/spectral.py``); the
rest is host numpy over the port's BrainVision reader.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from eegflow_torch.data.bids import discover_recordings
from eegflow_torch.data.brainvision import read_brainvision
from eegflow_torch.signal.spectral import CANONICAL_BANDS, band_power, welch_psd


def dataset_census(dataset_dir: str | Path, max_subjects: Optional[int] = None) -> Dict[str, Any]:
    """Counts of subjects, sessions, tasks and recordings (ref 01:181-211)."""
    recs = discover_recordings(dataset_dir, max_subjects=max_subjects)
    subjects = sorted({r["subject"] for r in recs})
    sessions = sorted({(r["subject"], r["session"]) for r in recs})
    by_task: Dict[str, int] = {}
    for r in recs:
        by_task[r["task"]] = by_task.get(r["task"], 0) + 1
    return {
        "n_recordings": len(recs),
        "n_subjects": len(subjects),
        "n_sessions": len(sessions),
        "subjects": subjects,
        "recordings_per_task": by_task,
    }


def analyze_recordings(dataset_dir: str | Path, n_sample: int = 5,
                       crop_seconds: Optional[float] = 30.0,
                       max_subjects: Optional[int] = None) -> List[Dict[str, Any]]:
    """Per-recording stats on the first ``n_sample`` recordings (ref
    01:214-259): channels, duration, sampling rate, amplitude range and std
    in microvolts. A recording that cannot be read gets a row with its
    ``error`` and the others go on (ref 01:176-178)."""
    recs = discover_recordings(dataset_dir, max_subjects=max_subjects)[:n_sample]
    stats = []
    for r in recs:
        try:
            data, header = read_brainvision(r["vhdr_path"], crop_seconds)
        except Exception as e:  # per-recording isolation, as the reference's
            stats.append({**{k: str(v) for k, v in r.items()}, "error": str(e)})
            continue
        uv = data * 1e6
        stats.append({
            "subject": r["subject"], "session": r["session"], "task": r["task"],
            "n_channels": int(data.shape[0]),
            "n_samples": int(data.shape[1]),
            "sampling_rate": float(header["sampling_rate"]),
            "duration_s": float(data.shape[1] / header["sampling_rate"]),
            "amplitude_mean_uv": float(uv.mean()),
            "amplitude_std_uv": float(uv.std()),
            "amplitude_range_uv": [float(uv.min()), float(uv.max())],
        })
    return stats


def basic_statistics(recording_stats: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate of the readable recordings' stats (ref 01:262-304)."""
    good = [s for s in recording_stats if "error" not in s]
    if not good:
        return {"n_recordings": 0}
    return {
        "n_recordings": len(good),
        "mean_duration_s": float(np.mean([s["duration_s"] for s in good])),
        "mean_channels": float(np.mean([s["n_channels"] for s in good])),
        "mean_amplitude_std_uv": float(np.mean([s["amplitude_std_uv"] for s in good])),
        "sampling_rates": sorted({s["sampling_rate"] for s in good}),
    }


def spectral_summary(open_signal: np.ndarray, closed_signal: np.ndarray, fs: float = 500.0,
                     nperseg: int = 1024,
                     device: torch.device | str | None = None) -> Dict[str, Any]:
    """Band powers of an eyes-open and an eyes-closed signal and the alpha
    closed/open ratio biomarker (ref 01:384-507, 470-476); the PSDs on
    ``device`` (by default the card)."""
    out: Dict[str, Any] = {"bands": {}}
    freqs_o, psd_o = welch_psd(open_signal, fs, nperseg, device)
    freqs_c, psd_c = welch_psd(closed_signal, fs, nperseg, device)
    for name, band in CANONICAL_BANDS.items():
        p_open = float(band_power(freqs_o, psd_o, band))
        p_closed = float(band_power(freqs_c, psd_c, band))
        out["bands"][name] = {"open": p_open, "closed": p_closed,
                              "ratio": p_closed / (p_open + 1e-30)}
    out["alpha_closed_open_ratio"] = out["bands"]["alpha"]["ratio"]
    out["psd"] = {"freqs": freqs_o.tolist(), "open": psd_o.tolist(), "closed": psd_c.tolist()}
    return out


def generate_eda_report(census: Dict[str, Any], stats: Dict[str, Any],
                        spectral: Optional[Dict[str, Any]] = None,
                        out_path: Optional[str | Path] = None) -> str:
    """The EDA markdown report with its modeling implications (ref
    01:510-568); written to ``out_path`` when given."""
    lines = [
        "# EEG Dataset — Exploratory Data Analysis",
        "",
        "## Dataset census",
        f"- Recordings: {census.get('n_recordings', 0)}",
        f"- Subjects: {census.get('n_subjects', 0)}",
        f"- Sessions: {census.get('n_sessions', 0)}",
        f"- Per task: {census.get('recordings_per_task', {})}",
        "",
        "## Signal statistics",
        f"- Mean duration: {stats.get('mean_duration_s', 0):.1f} s",
        f"- Mean channels: {stats.get('mean_channels', 0):.0f}",
        f"- Mean amplitude std: {stats.get('mean_amplitude_std_uv', 0):.2f} uV",
        f"- Sampling rates: {stats.get('sampling_rates', [])}",
    ]
    if spectral is not None:
        ratio = spectral["alpha_closed_open_ratio"]
        lines += [
            "",
            "## Spectral biomarker",
            f"- Alpha (8-13 Hz) closed/open power ratio: {ratio:.2f}",
            "",
            "## Modeling implications",
            "- Strong posterior alpha separability -> spectral features and"
            " sequence models should both discriminate eyes-open/closed.",
            "- Subject-wise splits are required: within-subject correlation"
            " inflates naive random-split accuracy.",
            "- 256-sample (0.512 s) windows at 50% overlap capture multiple"
            " alpha cycles per window.",
        ]
    report = "\n".join(lines) + "\n"
    if out_path is not None:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(report)
    return report
