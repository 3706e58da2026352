"""ODE rate fitting (``eegflow.fit``)."""

from eegflow_torch.fit.evolution import (FitLoss, differential_evolution_fit, fit_ode_rates,
                                         make_fit_loss)

__all__ = ["FitLoss", "differential_evolution_fit", "fit_ode_rates", "make_fit_loss"]
