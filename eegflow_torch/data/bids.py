"""BIDS recording discovery for ds004148-shaped trees (``eegflow.data.bids``).

Walks ``sub-*/ses-*/eeg/*task-{eyesopen,eyesclosed}*_eeg.vhdr``, labels each
recording by its task's index (0 = eyes open, 1 = eyes closed), skips
git-annex placeholders by sniffing the header, and caps the subject count.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence


def is_real_data(vhdr_path: str | Path) -> bool:
    """True if the .vhdr is BrainVision data, not a git-annex placeholder."""
    try:
        with open(vhdr_path, "r", errors="replace") as f:
            content = f.read(200)
        return ("Common Infos" in content or "BrainVision" in content
                or "Brain Vision" in content)
    except OSError:
        return False


def discover_recordings(dataset_dir: str | Path,
                        tasks: Sequence[str] = ("eyesopen", "eyesclosed"),
                        max_subjects: Optional[int] = 30) -> List[Dict[str, Any]]:
    """The recordings under ``dataset_dir`` with subject, session, task, path
    and label (the task's index in ``tasks``), in sorted order."""
    dataset_dir = Path(dataset_dir)
    recordings: List[Dict[str, Any]] = []
    subjects_found: set = set()

    for subject_dir in sorted(dataset_dir.glob("sub-*")):
        if not subject_dir.is_dir():
            continue
        if max_subjects is not None and len(subjects_found) >= max_subjects:
            break
        for session_dir in sorted(subject_dir.glob("ses-*")):
            eeg_dir = session_dir / "eeg"
            if not eeg_dir.exists():
                continue
            for label, task in enumerate(tasks):
                for vhdr in sorted(eeg_dir.glob(f"*task-{task}*_eeg.vhdr")):
                    if is_real_data(vhdr):
                        recordings.append({
                            "subject": subject_dir.name,
                            "session": session_dir.name,
                            "task": task,
                            "vhdr_path": vhdr,
                            "label": label,
                        })
                        subjects_found.add(subject_dir.name)
    return recordings
