"""Configs, seeded generators and the artifact reader and writer."""

from eegflow_torch.core.config import (CouplingConfig, DataConfig, ModelConfig, ODEConfig,
                                       PipelineConfig, PreprocessConfig, TrainConfig,
                                       TransformerConfig)
from eegflow_torch.core.prng import make_generator

__all__ = ["CouplingConfig", "DataConfig", "ModelConfig", "ODEConfig", "PipelineConfig",
           "PreprocessConfig", "TrainConfig", "TransformerConfig", "make_generator"]
