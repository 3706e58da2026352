"""Configs, seeded generators and the checkpoint reader."""

from eegflow_torch.core.config import CouplingConfig, ModelConfig
from eegflow_torch.core.prng import make_generator

__all__ = ["CouplingConfig", "ModelConfig", "make_generator"]
