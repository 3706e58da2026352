"""Reference-parity explainability summary (ref 07_explainability.py:1207-1273;
``eegflow.explain.summary``, copied from the reference).

The reference's ``explainability_summary.json`` carries, beyond the raw
per-method results, anatomical region shares of channel importance
(occipital / frontal / parietal), the attention/ODE analyses, and derived
clinical-insight strings. ``build_summary`` reproduces that contract as a
superset: every reference field is present under the same key, plus the
full per-region breakdown for every importance method.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from eegflow_torch.viz.regions import CHANNEL_REGIONS, aggregate_by_region


def _region_shares(method_result: Dict) -> Dict[str, object]:
    """Reference region fields for one importance method (ref 07:1215-1228).

    The reference sums normalized importances over the occipital channels
    (O1/O2/Oz), ``CHANNEL_REGIONS['Frontal']`` and
    ``CHANNEL_REGIONS['Parietal']``; the full ``region_shares`` breakdown is
    an eegflow extension (same aggregation, every region).
    """
    channels = [str(c) for c in method_result["channels"]]
    importance = [float(v) for v in method_result["importance"]]
    by_region = aggregate_by_region(channels, importance)
    occ = set(CHANNEL_REGIONS["Occipital"])
    return {
        "top_3_channels": list(method_result["ranking"][:3]),
        "occipital_importance": sum(
            v for c, v in zip(channels, importance) if c in occ),
        "frontal_importance": by_region.get("Frontal", 0.0),
        "parietal_importance": by_region.get("Parietal", 0.0),
        "region_shares": by_region,
    }


def build_summary(
    gradient: Dict,
    permutation: Dict,
    comparison: Dict,
    attention_analysis: Optional[Dict] = None,
    ode_analysis: Optional[Dict] = None,
    shap: Optional[Dict] = None,
) -> Dict[str, object]:
    """Assemble ``explainability_summary.json`` (ref 07:1207-1273).

    Reference-parity fields: ``channel_importance.gradient_based`` (+
    ``.shap_based`` when SHAP ran), ``attention_patterns``,
    ``ode_dynamics``, ``clinical_insights`` (primary_indicators,
    temporal_pattern, state_dynamics — the recovery/fatigue sentence keyed
    on ODE ``balance`` > 1, ref 07:1233-1237), ``explainability_methods``.
    eegflow supersets: ``permutation_based`` region shares, the raw
    per-method results, and the cross-method ``comparison``.
    """
    channel_importance: Dict[str, object] = {
        "gradient_based": _region_shares(gradient),
        "permutation_based": _region_shares(permutation),
    }
    methods: List[str] = ["gradient", "permutation"]
    if shap is not None:
        channel_importance["shap_based"] = _region_shares(shap)
        methods.append("shap")

    grad_fields = channel_importance["gradient_based"]
    top3 = grad_fields["top_3_channels"]
    insights: Dict[str, str] = {
        # the reference hard-codes its ds004148 finding; eegflow states the
        # measured result in the same shape so synthetic runs stay honest
        "primary_indicators": (
            f"Channels {', '.join(top3)} carry the highest importance for "
            f"eye state detection "
            f"(occipital share {grad_fields['occipital_importance']:.1%}, "
            f"parietal share {grad_fields['parietal_importance']:.1%})"),
        "temporal_pattern": (
            "Attention focuses on specific temporal windows within "
            "0.5s EEG segments"),
    }
    if attention_analysis is not None:
        insights["temporal_pattern"] = (
            f"Attention peaks at position "
            f"{attention_analysis['peak_position']} of the window "
            f"(normalized entropy {attention_analysis['entropy']:.3f}; "
            f"lower = more focused)")
    if ode_analysis is not None:
        insights["state_dynamics"] = (
            "Recovery processes dominate system dynamics, suggesting "
            "natural resilience"
            if float(ode_analysis["balance"]) > 1 else
            "Fatigue processes dominate, suggesting vigilance decrement")

    return {
        "channel_importance": channel_importance,
        "attention_patterns": attention_analysis,
        "ode_dynamics": ode_analysis,
        "clinical_insights": insights,
        "explainability_methods": methods,
        # eegflow supersets (round-2 summary contract, kept for continuity)
        "gradient": gradient,
        "permutation": permutation,
        "comparison": comparison,
        "top_channels": comparison["consensus_ranking"][:10],
    }
