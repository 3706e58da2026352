"""Configs, seeded generators and the artifact reader and writer."""

from eegflow_torch.core.config import CouplingConfig, ModelConfig, TrainConfig
from eegflow_torch.core.prng import make_generator

__all__ = ["CouplingConfig", "ModelConfig", "TrainConfig", "make_generator"]
