"""Evaluation of trained models (``eegflow.analyze`` counterpart)."""
