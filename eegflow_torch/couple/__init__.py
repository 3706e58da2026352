"""Rate modulation and the coupled LSTM->ODE rollout."""

from eegflow_torch.couple.modulation import infer_initial_state, modulate_rates
from eegflow_torch.couple.rollout import CoupledModel, coupled_rollout, predict_batch

__all__ = ["CoupledModel", "coupled_rollout", "infer_initial_state", "modulate_rates",
           "predict_batch"]
