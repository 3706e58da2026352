"""Explainability: gradient, permutation and KernelSHAP channel attributions,
attention and ODE-rate analytics, the cross-method comparison and the
summary report (``eegflow.explain``)."""

from eegflow_torch.explain.attention import analyze_attention_patterns
from eegflow_torch.explain.compare import compare_importance_methods
from eegflow_torch.explain.gradient import gradient_channel_importance
from eegflow_torch.explain.kernelshap import kernel_shap_channel_importance, kernel_shap_values
from eegflow_torch.explain.ode_interp import analyze_ode_dynamics
from eegflow_torch.explain.permutation import permutation_channel_importance
from eegflow_torch.explain.summary import build_summary

__all__ = ["analyze_attention_patterns", "analyze_ode_dynamics", "build_summary",
           "compare_importance_methods", "gradient_channel_importance",
           "kernel_shap_channel_importance", "kernel_shap_values",
           "permutation_channel_importance"]
