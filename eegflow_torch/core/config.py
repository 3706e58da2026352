"""The configs the serving and training paths need, carried over from
``eegflow.core.config`` as plain dataclasses.

Field names and defaults are those of the JAX package, so a checkpoint's
embedded ``model_config`` dict constructs either class. They are copies, not
imports: importing anything from ``eegflow`` imports jax. The tests hold the
defaults equal to the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """BiLSTM-attention classifier architecture (``eegflow.core.config.ModelConfig``).

    ``hidden_size=None`` resolves to 256 when input_size > 30 else 128.
    """

    input_size: int = 61
    hidden_size: Optional[int] = None
    num_layers: int = 3
    num_classes: int = 2
    dropout: float = 0.4
    bidirectional: bool = True
    num_heads: int = 4
    use_attention: bool = True
    use_layer_norm: bool = True

    def resolved_hidden(self) -> int:
        if self.hidden_size is not None:
            return self.hidden_size
        return 256 if self.input_size > 30 else 128


@dataclass(frozen=True)
class CouplingConfig:
    """LSTM->ODE probabilistic coupling (``eegflow.core.config.CouplingConfig``)."""

    coupling_strength: float = 0.5
    forecast_steps: int = 20
    rate_floor: float = 1e-3
    init_threshold: float = 0.6
    fatigued_threshold: float = 0.5
    sweep_alphas: Tuple[float, ...] = (0.0, 0.25, 0.5, 0.75, 1.0)


@dataclass(frozen=True)
class TrainConfig:
    """Training-loop hyperparameters (``eegflow.core.config.TrainConfig``).

    The mesh (``data_axis``), the phase-surrogate refresh and the
    ``lstm_impl`` names are those of the reference; the port's trainer reads
    ``lstm_impl`` as ``"auto" | "kernel" | "plain"`` (``"auto"`` is the
    reference's default and means the CUDA kernels on a GPU).
    """

    epochs: int = 100
    batch_size: int = 512
    eval_batch_size: int = 1024
    accumulation_steps: int = 4
    learning_rate: float = 3e-4
    weight_decay: float = 1e-4
    warmup_epochs: int = 5
    grad_clip: float = 1.0
    patience: int = 15
    selection_metric: str = "mcc"
    seed: int = 42
    bf16: bool = True
    augment: bool = True
    noise_std: float = 0.01
    max_shift: int = 5
    aug_mixup: bool = False
    aug_channel_dropout: float = 0.0
    aug_phase_surrogates: int = 0
    aug_fresh_surrogates: bool = False
    auto_small_subject_reg: bool = True
    weighted_sampling: bool = True
    data_axis: str = "data"
    lstm_impl: str = "auto"
