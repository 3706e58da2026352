"""Scalp region grouping of the 61-channel montage (ref 07_explainability.py:72-82;
``eegflow.viz.regions``, copied from the reference).

Behavioral constant required for parity: the explainability figures and the
summary report aggregate channel importances by these anatomical regions.
"""

from __future__ import annotations

from typing import Dict, List

CHANNEL_REGIONS: Dict[str, List[str]] = {
    "Prefrontal": ["Fp1", "Fpz", "Fp2", "AF3", "AF4", "AF7", "AF8"],
    "Frontal": ["Fz", "F1", "F2", "F3", "F4", "F5", "F6", "F7", "F8"],
    "Frontocentral": ["FC1", "FC2", "FC3", "FC4", "FC5", "FC6", "FT7", "FT8"],
    "Central": ["Cz", "C1", "C2", "C3", "C4", "C5", "C6"],
    "Temporal": ["T7", "T8", "TP7", "TP8", "TP9", "TP10"],
    "Centroparietal": ["CPz", "CP1", "CP2", "CP3", "CP4", "CP5", "CP6"],
    "Parietal": ["Pz", "P1", "P2", "P3", "P4", "P5", "P6", "P7", "P8"],
    "Parietooccipital": ["POz", "PO3", "PO4", "PO7", "PO8"],
    "Occipital": ["Oz", "O1", "O2"],
}


def region_of(channel: str) -> str:
    for region, chans in CHANNEL_REGIONS.items():
        if channel in chans:
            return region
    return "Other"


def aggregate_by_region(channels, scores) -> Dict[str, float]:
    """Sum per-channel scores into per-region totals (ref 07:497-508)."""
    out: Dict[str, float] = {}
    for ch, s in zip(channels, scores):
        r = region_of(str(ch))
        out[r] = out.get(r, 0.0) + float(s)
    return out
