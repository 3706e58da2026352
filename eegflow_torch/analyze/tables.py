"""Manuscript-style result tables and the model-zoo comparison
(``eegflow.analyze.tables``, pure Python, copied from the reference).

* :func:`merge_all_model_results` — merges baseline/LSTM/integration result
  JSONs into one ``all_model_results.json`` payload (ref 06:636-777).
* :func:`format_results_table` / :func:`create_results_tables` — the
  formatted text tables the reference prints for the manuscript
  (ref 09:671-703), returned as strings so they can be logged AND saved.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence


def merge_all_model_results(
    baseline_results: Optional[Dict] = None,
    lstm_results: Optional[Dict] = None,
    integration_results: Optional[Dict] = None,
) -> Dict[str, Dict[str, float]]:
    """One {model: {accuracy, f1, auc, mcc, ci}} map across the whole zoo."""
    merged: Dict[str, Dict[str, float]] = {}

    def pick(res: Dict, name: str):
        merged[name] = {
            "accuracy": res.get("accuracy"),
            "f1": res.get("f1"),
            "auc": res.get("auc"),
            "mcc": res.get("mcc"),
            "accuracy_ci_95": res.get("accuracy_ci_95"),
        }

    for model_name, res in (baseline_results or {}).items():
        pick(res, model_name)
    if lstm_results:
        pick(lstm_results, "lstm_attention")
    if integration_results:
        res = integration_results.get("evaluation", integration_results)
        pick(res, "lstm_ode_integration")
    return merged


def format_results_table(
    results: Dict[str, Dict[str, float]],
    metrics: Sequence[str] = ("accuracy", "f1", "auc", "mcc"),
    title: str = "Model comparison",
) -> str:
    """Fixed-width text table (manuscript Table 1 style, ref 09:671-703)."""
    name_w = max([len(n) for n in results] + [10])
    header = f"{'Model':<{name_w}} | " + " | ".join(f"{m.upper():>8}" for m in metrics)
    sep = "-" * len(header)
    lines = [title, "=" * len(header), header, sep]
    for name, r in results.items():
        cells = []
        for m in metrics:
            v = r.get(m)
            cells.append(f"{v:>8.4f}" if isinstance(v, (int, float)) and v == v
                         else f"{'—':>8}")
        lines.append(f"{name:<{name_w}} | " + " | ".join(cells))
    return "\n".join(lines)


def format_ablation_table(ablation_results: Dict[str, Dict]) -> str:
    """Ablation table with config flags (ref 09:671-703)."""
    lines = ["Architecture ablation", "=" * 72,
             f"{'Config':<16} | {'bidir':>5} | {'attn':>5} | {'layers':>6} | "
             f"{'ACC':>7} | {'F1':>7} | {'MCC':>7}", "-" * 72]
    for name, r in ablation_results.items():
        cfg = r["config"]
        m = r["metrics"]
        lines.append(
            f"{name:<16} | {str(cfg.get('bidirectional')):>5} | "
            f"{str(cfg.get('use_attention')):>5} | {cfg.get('num_layers'):>6} | "
            f"{m['accuracy']:>7.4f} | {m['f1']:>7.4f} | {m['mcc']:>7.4f}"
        )
    return "\n".join(lines)


def format_statistical_table(comparison: Dict[str, Dict]) -> str:
    """Variant-vs-full statistical comparison table (ref 09:381-421)."""
    lines = ["Statistical comparison vs Full Model", "=" * 78,
             f"{'Variant':<16} | {'McNemar p':>10} | {'method':>8} | "
             f"{'Cohen d':>8} | {'effect':>10} | {'paired-t p':>10}", "-" * 78]
    for name, c in comparison.items():
        lines.append(
            f"{name:<16} | {c['mcnemar']['p_value']:>10.4f} | "
            f"{c['mcnemar']['method']:>8} | {c['cohens_d']:>8.3f} | "
            f"{c['effect_size']:>10} | {c['paired_t']['p_value']:>10.4f}"
        )
    return "\n".join(lines)


def create_results_tables(
    all_results: Optional[Dict] = None,
    ablation: Optional[Dict] = None,
    comparison: Optional[Dict] = None,
) -> List[str]:
    """All manuscript tables as strings (ref 09:671-703)."""
    tables = []
    if all_results:
        tables.append(format_results_table(all_results))
    if ablation:
        tables.append(format_ablation_table(ablation))
    if comparison:
        tables.append(format_statistical_table(comparison))
    return tables
