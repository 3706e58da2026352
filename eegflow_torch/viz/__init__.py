"""Plotting helpers (``eegflow.viz``): the scalp regions of the montage and
the figures of the stages.

The figures (:mod:`eegflow_torch.viz.figures`) are imported on first use of
one of their names (PEP 562), so importing this package, its regions and
every stage module needs no matplotlib."""

import importlib

from eegflow_torch.viz.regions import CHANNEL_REGIONS, aggregate_by_region, region_of

_FIGURES = (
    "plot_ablation_results",
    "plot_attention_explainability",
    "plot_attention_weights",
    "plot_baseline_comparison",
    "plot_channel_importance",
    "plot_class_distribution",
    "plot_comprehensive_comparison",
    "plot_coupling_analysis",
    "plot_forecasting_results",
    "plot_importance_comparison",
    "plot_ode_analysis",
    "plot_ode_explainability",
    "plot_preprocessing_overview",
    "plot_sample_timeseries",
    "plot_sensitivity_heatmap",
    "plot_shap_analysis",
    "plot_spectral_analysis",
    "plot_state_diagram",
    "plot_training_history",
    "plot_trajectory_examples",
    "save_figure",
)

__all__ = ["CHANNEL_REGIONS", "aggregate_by_region", "region_of", *_FIGURES]


def __getattr__(name):
    if name in _FIGURES:
        return getattr(importlib.import_module("eegflow_torch.viz.figures"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
