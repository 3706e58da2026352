"""The classical baselines on the hand-crafted features (``eegflow.baselines``)."""

from eegflow_torch.baselines.classical import (load_or_extract_features, run_all_baselines,
                                               train_gradient_boosting, train_random_forest,
                                               train_svm)

__all__ = ["load_or_extract_features", "run_all_baselines", "train_gradient_boosting",
           "train_random_forest", "train_svm"]
