"""Configs, seeded generators, wall-clock spans and the artifact reader and
writer."""

from eegflow_torch.core.config import (CouplingConfig, DataConfig, ModelConfig, ODEConfig,
                                       PipelineConfig, PreprocessConfig, TrainConfig,
                                       TransformerConfig)
from eegflow_torch.core.prng import make_generator
from eegflow_torch.core.timing import Timer, timed

__all__ = ["CouplingConfig", "DataConfig", "ModelConfig", "ODEConfig", "PipelineConfig",
           "PreprocessConfig", "Timer", "TrainConfig", "TransformerConfig", "make_generator",
           "timed"]
