"""APF vector field and its exact-propagator integrator."""

from eegflow_torch.ode.field import (DEFAULT_RATES, RATE_NAMES, apf_field, rates_to_array,
                                     transition_matrix)
from eegflow_torch.ode.integrate import expm_solve, solve_batch

__all__ = ["DEFAULT_RATES", "RATE_NAMES", "apf_field", "expm_solve", "rates_to_array",
           "solve_batch", "transition_matrix"]
