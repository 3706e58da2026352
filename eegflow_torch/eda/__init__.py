"""Exploratory data analysis (``eegflow.eda``)."""

from eegflow_torch.eda.explore import (analyze_recordings, basic_statistics, dataset_census,
                                       generate_eda_report, spectral_summary)

__all__ = ["analyze_recordings", "basic_statistics", "dataset_census", "generate_eda_report",
           "spectral_summary"]
