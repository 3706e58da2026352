"""The config tree of ``eegflow.core.config``, carried over as plain
dataclasses.

Field names and defaults are those of the JAX package, so a checkpoint's
embedded ``model_config`` dict constructs either class and a
``PipelineConfig`` JSON file reads the same in both packages. They are
copies, not imports: importing anything from ``eegflow`` imports jax. The
tests hold the fields and defaults equal to the reference's.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional, Tuple


def _asdict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _asdict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_asdict(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _asdict(v) for k, v in obj.items()}
    if isinstance(obj, Path):
        return str(obj)
    return obj


def _fromdict(cls: type, data: Dict[str, Any]) -> Any:
    """``cls`` from a dict: nested sections by :data:`_NESTED`, the JSON lists
    of :data:`_TUPLE_FIELDS` back to tuples; absent fields keep defaults."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        sub = _NESTED.get((cls.__name__, f.name))
        if sub is not None and isinstance(v, dict):
            v = _fromdict(sub, v)
        elif isinstance(v, list) and f.name in _TUPLE_FIELDS.get(cls.__name__, ()):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        kwargs[f.name] = v
    return cls(**kwargs)


@dataclass(frozen=True)
class DataConfig:
    """Dataset location and BIDS discovery (``eegflow.core.config.DataConfig``)."""

    dataset_dir: str = "data/ds004148"
    output_dir: str = "outputs"
    max_subjects: Optional[int] = 30
    tasks: Tuple[str, ...] = ("eyesopen", "eyesclosed")
    n_channels: int = 61
    crop_seconds: Optional[float] = None


@dataclass(frozen=True)
class PreprocessConfig:
    """Signal preprocessing (``eegflow.core.config.PreprocessConfig``).

    ``filter_method``: ``"fft"`` (zero-phase FFT filter with filtfilt's
    |H|^2 magnitude) or ``"filtfilt"`` (scipy ``filtfilt`` parity, the SOS
    recursion of kernel 12).
    """

    sampling_rate: float = 500.0
    sequence_length: int = 256
    overlap: float = 0.5
    lowcut: float = 1.0
    highcut: float = 45.0
    filter_order: int = 4
    filter_method: str = "fft"
    std_floor: float = 1e-10
    train_frac: float = 0.70
    val_frac: float = 0.15
    seed: int = 42


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
class TransformerConfig:
    """EEGFormer architecture (``eegflow.core.config.TransformerConfig``),
    the second model family: ``classifier_init`` / ``classifier_apply``
    dispatch on this type wherever a ``ModelConfig`` goes.

    ``d_model=None`` resolves like the flagship's hidden size (256 when
    input_size > 30 else 128).
    """

    input_size: int = 61
    d_model: Optional[int] = None
    num_layers: int = 4
    num_heads: int = 4
    mlp_ratio: int = 4
    num_classes: int = 2
    dropout: float = 0.3

    def resolved_d_model(self) -> int:
        if self.d_model is not None:
            return self.d_model
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


@dataclass(frozen=True)
class ODEConfig:
    """Three-state A/P/F ODE and its fit (``eegflow.core.config.ODEConfig``)."""

    k_ap: float = 0.1
    k_af: float = 0.02
    k_pa: float = 0.15
    k_pf: float = 0.08
    k_fa: float = 0.05
    k_fp: float = 0.1
    rk4_substeps: int = 16
    de_popsize: int = 15
    de_maxiter: int = 1000
    de_tol: float = 1e-7
    de_seed: int = 42
    reg_weight: float = 1e-3
    bounds: Tuple[Tuple[float, float], ...] = (
        (0.01, 0.5),   # k_ap
        (0.001, 0.2),  # k_af
        (0.02, 0.5),   # k_pa
        (0.01, 0.3),   # k_pf
        (0.01, 0.3),   # k_fa
        (0.02, 0.4),   # k_fp
    )
    map_window_size: int = 20

    def rates(self) -> Dict[str, float]:
        return {
            "k_ap": self.k_ap, "k_af": self.k_af, "k_pa": self.k_pa,
            "k_pf": self.k_pf, "k_fa": self.k_fa, "k_fp": self.k_fp,
        }


@dataclass(frozen=True)
class PipelineConfig:
    """Root of the config tree (``eegflow.core.config.PipelineConfig``)."""

    data: DataConfig = field(default_factory=DataConfig)
    preprocess: PreprocessConfig = field(default_factory=PreprocessConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    ode: ODEConfig = field(default_factory=ODEConfig)
    coupling: CouplingConfig = field(default_factory=CouplingConfig)

    def to_dict(self) -> Dict[str, Any]:
        return _asdict(self)

    def to_json(self, path: Optional[str | Path] = None) -> str:
        s = json.dumps(self.to_dict(), indent=2)
        if path is not None:
            Path(path).write_text(s)
        return s

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "PipelineConfig":
        return _fromdict(cls, data)

    @classmethod
    def from_json(cls, path: str | Path) -> "PipelineConfig":
        return cls.from_dict(json.loads(Path(path).read_text()))


_NESTED = {
    ("PipelineConfig", "data"): DataConfig,
    ("PipelineConfig", "preprocess"): PreprocessConfig,
    ("PipelineConfig", "model"): ModelConfig,
    ("PipelineConfig", "train"): TrainConfig,
    ("PipelineConfig", "ode"): ODEConfig,
    ("PipelineConfig", "coupling"): CouplingConfig,
}
_TUPLE_FIELDS = {
    "ODEConfig": ("bounds",),
    "DataConfig": ("tasks",),
    "CouplingConfig": ("sweep_alphas",),
}
