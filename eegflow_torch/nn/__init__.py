"""Classifier layers, the eager LSTM oracle, and the CUDA-kernel wrappers."""

from eegflow_torch.nn.model import classifier_apply, classifier_init, resolve_lstm_impl

__all__ = ["classifier_apply", "classifier_init", "resolve_lstm_impl"]
