"""eegflow_torch — the coupled LSTM->ODE serving path and the classifier's
training path in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper
(sm_90a).

A second package beside ``eegflow`` (the JAX reference). Module names mirror
the reference so each counterpart is easy to find; this package imports
``torch`` and numpy only, never ``jax`` and never ``eegflow``.

Kernels (``eegflow_torch/csrc``) build with ``nvcc`` on first use and bind
through ``ctypes`` (:mod:`eegflow_torch.kernels`).
"""

from eegflow_torch.core.config import CouplingConfig, ModelConfig, TrainConfig, TransformerConfig

__all__ = ["CouplingConfig", "ModelConfig", "TrainConfig", "TransformerConfig"]
