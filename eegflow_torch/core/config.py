"""The two configs the serving path needs, carried over from
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
