"""Real-data parity against the reference's published results table
(``eegflow.analyze.parity``).

The reference publishes its model scores in README.md:220-224, and the
rebuild's accuracy target is ±0.5 percentage points of them. The ``parity``
stage preprocesses with ``filter_method='filtfilt'``, runs the baselines,
trains at the reference's hyperparameters, fits the ODE, integrates, and
diffs every published number here. The real check needs the ds004148
download; ``--synthetic`` runs the chain on the synthetic dataset, whose
results are marked not comparable.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

from eegflow_torch.data.bids import is_real_data

#: Published reference results (ref README.md:220-224).
REFERENCE_RESULTS: Dict[str, Dict[str, float]] = {
    "svm": {"accuracy": 0.380, "f1": 0.000, "auc": 0.467},
    "random_forest": {"accuracy": 0.603, "f1": 0.563, "auc": 0.657},
    "xgboost": {"accuracy": 0.620, "f1": 0.632, "auc": 0.689},
    "lstm_attention": {"accuracy": 0.549, "f1": 0.603, "auc": 0.596},
    "lstm_ode_integration": {"accuracy": 0.549, "f1": 0.599, "auc": 0.596},
}

#: Result-file model keys -> reference table rows. The no-xgboost fallback
#: (the reference's own, ref 03:46-51) is compared against the xgboost row.
MODEL_KEYS = {
    "svm": "svm",
    "random_forest": "random_forest",
    "xgboost": "xgboost",
    "gradient_boosting": "xgboost",
    "lstm_attention": "lstm_attention",
    "lstm_ode_integration": "lstm_ode_integration",
}

PARITY_TOLERANCE_PP = 0.5  # percentage points

# the ds004148 download's layout (ref download_dataset.py:41-68): 60
# subjects x 3 sessions x 2 tasks x a BrainVision triplet; a file of at most
# MIN_REAL_SIZE bytes is a git-annex placeholder
N_SUBJECTS = 60
SESSIONS = ("session1", "session2", "session3")
EXTENSIONS = (".vhdr", ".vmrk", ".eeg")
MIN_REAL_SIZE = 200


def compare_to_reference(measured: Dict[str, Dict[str, float]],
                         tolerance_pp: float = PARITY_TOLERANCE_PP,
                         comparable: bool = True) -> Dict[str, object]:
    """Diff measured {model: {accuracy, f1, auc}} against the published
    table: per-model deltas and the accuracy-parity verdict, which
    ``comparable`` False (synthetic data) marks informational."""
    rows = {}
    all_within = True
    for key, res in measured.items():
        ref_key = MODEL_KEYS.get(key)
        if ref_key is None or ref_key not in REFERENCE_RESULTS:
            continue
        ref = REFERENCE_RESULTS[ref_key]
        entry = {"reference_row": ref_key}
        for metric in ("accuracy", "f1", "auc"):
            ours = res.get(metric)
            if ours is None:
                continue
            entry[metric] = {
                "ours": round(float(ours), 4),
                "reference": ref[metric],
                "delta": round(float(ours) - ref[metric], 4),
            }
        acc_delta_pp = (abs(entry["accuracy"]["delta"]) * 100
                        if "accuracy" in entry else float("inf"))
        entry["accuracy_within_tolerance"] = bool(acc_delta_pp <= tolerance_pp)
        all_within = all_within and entry["accuracy_within_tolerance"]
        rows[key] = entry
    return {
        "tolerance_pp": tolerance_pp,
        "comparable": comparable,
        "models": rows,
        "verdict": (
            ("PASS" if all_within else "FAIL") if comparable and rows
            else "NOT COMPARABLE (synthetic data — the real-ds004148 check "
                 "needs network egress for the download step)"
        ),
    }


def _expected_files(data_dir: Path, n_subjects: int, sessions: Sequence[str],
                    tasks: Sequence[str]) -> List[Dict[str, object]]:
    """Every file of the download's first ``n_subjects`` subjects."""
    files = []
    for s in range(1, n_subjects + 1):
        sub = f"sub-{s:02d}"
        for ses in sessions:
            for task in tasks:
                for ext in EXTENSIONS:
                    rel = f"{sub}/ses-{ses}/eeg/{sub}_ses-{ses}_task-{task}_eeg{ext}"
                    files.append({"path": data_dir / rel, "subject": sub, "session": ses})
    return files


def _vmrk_real(path: Path) -> bool:
    try:
        head = path.read_text(errors="replace")[:200]
    except OSError:
        return False
    return "Brain Vision" in head or "Marker Infos" in head


def reference_dataset_audit(data_dir, n_subjects: Optional[int] = 30, sessions=None,
                            tasks=("eyesopen", "eyesclosed")) -> Dict[str, object]:
    """Audit ``data_dir`` for the real-ds004148 files the ±0.5 pp check
    needs and list exactly which are absent.

    The manifest is the download's layout restricted to the ``n_subjects``
    the parity run reads (ref 02:56 MAX_SUBJECTS=30). A file counts as
    present only if it exists, an ``.eeg`` exceeds the git-annex placeholder
    size, a ``.vhdr`` passes the BrainVision header sniff and a ``.vmrk``
    the marker-file sniff. -> {"ok", "missing": [str, ...], "present": N,
    "expected": N, "data_dir"}."""
    n = N_SUBJECTS if n_subjects is None else min(n_subjects, N_SUBJECTS)
    expected = _expected_files(Path(data_dir), n, sessions or SESSIONS, tasks)
    missing: list = []
    for f in expected:
        path = Path(f["path"])
        rel = f"{f['subject']}/ses-{f['session']}/{path.name}"
        if not path.exists():
            missing.append(f"{rel}: absent")
        elif path.suffix == ".eeg" and path.stat().st_size <= MIN_REAL_SIZE:
            missing.append(f"{rel}: git-annex placeholder ({path.stat().st_size} B)")
        elif path.suffix == ".vhdr" and not is_real_data(path):
            missing.append(f"{rel}: not BrainVision (bad header)")
        elif path.suffix == ".vmrk" and not _vmrk_real(path):
            missing.append(f"{rel}: not a BrainVision marker file")
    return {
        "ok": not missing,
        "missing": missing,
        "present": len(expected) - len(missing),
        "expected": len(expected),
        "data_dir": str(data_dir),
    }


def format_parity_table(report: Dict[str, object]) -> str:
    """The parity report as a text table with the verdict."""
    lines = [
        "Parity vs reference README.md:220-224 "
        f"(accuracy tolerance ±{report['tolerance_pp']} pp)",
        f"{'model':<22} {'metric':<9} {'ours':>8} {'ref':>8} {'delta':>8}  ok",
        "-" * 62,
    ]
    for model, entry in report["models"].items():
        for metric in ("accuracy", "f1", "auc"):
            if metric not in entry:
                continue
            e = entry[metric]
            flag = ""
            if metric == "accuracy":
                flag = "yes" if entry["accuracy_within_tolerance"] else "NO"
            lines.append(
                f"{model:<22} {metric:<9} {e['ours']:>8.4f} "
                f"{e['reference']:>8.4f} {e['delta']:>+8.4f}  {flag}"
            )
    lines.append(f"verdict: {report['verdict']}")
    return "\n".join(lines)
