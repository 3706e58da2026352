"""ODE transition-rate interpretation (ref 07_explainability.py:733-783):
per-rate meaning/time-constant table, dominant pathways, recovery/fatigue
balance — returned as data, not printed (``eegflow.explain.ode_interp``,
copied from the reference)."""

from __future__ import annotations

from typing import Dict

INTERPRETATIONS = {
    "k_ap": ("Active->Passive", "Attention waning"),
    "k_af": ("Active->Fatigued", "Direct fatigue onset"),
    "k_pa": ("Passive->Active", "Re-engagement"),
    "k_pf": ("Passive->Fatigued", "Fatigue buildup"),
    "k_fa": ("Fatigued->Active", "Recovery"),
    "k_fp": ("Fatigued->Passive", "Partial recovery"),
}


def analyze_ode_dynamics(ode_params: Dict[str, float]) -> Dict[str, object]:
    params = {k: float(v) for k, v in ode_params.items()}
    table = {}
    for name, value in params.items():
        transition, meaning = INTERPRETATIONS[name]
        table[name] = {
            "value": value,
            "transition": transition,
            "meaning": meaning,
            "time_constant": 1.0 / value if value > 0 else float("inf"),
        }
    dominant = sorted(params.items(), key=lambda kv: kv[1], reverse=True)[:3]
    recovery = params["k_fa"] + params["k_fp"] + params["k_pa"]
    fatigue = params["k_af"] + params["k_pf"]
    balance = recovery / (fatigue + 1e-10)
    return {
        "params": params,
        "table": table,
        "dominant_pathways": [
            {"rate": k, "transition": INTERPRETATIONS[k][0], "value": v}
            for k, v in dominant
        ],
        "balance": balance,
        "tendency": "recovery" if balance > 1 else "fatigue",
    }
