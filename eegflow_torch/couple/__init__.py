"""Rate modulation, the coupled LSTM->ODE rollout and the coupling sweep."""

from eegflow_torch.couple.modulation import infer_initial_state, modulate_rates
from eegflow_torch.couple.rollout import (CoupledModel, coupled_rollout, predict_batch,
                                          predict_trajectory)
from eegflow_torch.couple.sweep import coupling_strength_sweep

__all__ = ["CoupledModel", "coupled_rollout", "coupling_strength_sweep", "infer_initial_state",
           "modulate_rates", "predict_batch", "predict_trajectory"]
