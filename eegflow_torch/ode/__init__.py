"""APF vector field, its integrators, the eye-state mapping and the
steady-state sensitivity."""

from eegflow_torch.ode.field import (DEFAULT_RATES, RATE_NAMES, apf_field, rates_to_array,
                                     rates_to_dict, stability_analysis, steady_state,
                                     steady_state_numeric, transition_matrix, validate_rates)
from eegflow_torch.ode.integrate import (expm_solve, expm_solve_piecewise, rk4_solve,
                                         rk4_solve_modulated, solve, solve_batch,
                                         solve_with_modulation)
from eegflow_torch.ode.mapping import map_eye_state_to_cognitive
from eegflow_torch.ode.sensitivity import parameter_sensitivity

__all__ = ["DEFAULT_RATES", "RATE_NAMES", "apf_field", "expm_solve", "expm_solve_piecewise",
           "map_eye_state_to_cognitive", "parameter_sensitivity", "rates_to_array",
           "rates_to_dict", "rk4_solve", "rk4_solve_modulated", "solve", "solve_batch",
           "solve_with_modulation", "stability_analysis", "steady_state",
           "steady_state_numeric", "transition_matrix", "validate_rates"]
