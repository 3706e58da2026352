"""``predict_trajectory`` and ``coupling_strength_sweep`` of eegflow_torch
against ``eegflow.couple``: the same numpy inputs and the JAX params pytree,
converted with ``params_from_jax``; the port runs its plain twins on the
CPU, the JAX package its Pallas kernels in interpret mode (``predict_trajectory``,
and the sweep's probabilities on the port's schedule, with the fused input
block) or its scan path (the sweep itself: its ``predict_probs`` resolves
``"auto"`` to the scan off the TPU)."""

import jax
import numpy as np
import pytest
import torch

from eegflow.core import config as jcfg
from eegflow.couple import coupling_strength_sweep as jax_sweep
from eegflow.couple import predict_trajectory as jax_predict_trajectory
from eegflow.couple.rollout import CoupledModel as JaxCoupledModel
from eegflow.nn.model import classifier_init as jax_init
from eegflow.ode.field import rates_to_array as jax_rates
from eegflow.train.loop import predict_probs as jax_predict_probs
from eegflow_torch.convert import params_from_jax
from eegflow_torch.core import config as tcfg
from eegflow_torch.couple import CoupledModel, coupling_strength_sweep, predict_trajectory
from eegflow_torch.ode.field import DEFAULT_RATES, rates_to_array
from eegflow_torch.train.loop import predict_probs
from torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(input_size=5, hidden_size=32, num_layers=2)
# bf16 schedule vs the Pallas path (and vs the scan path): identical
# bf16-rounded operands, float32 sums in another order; a rounding flip of
# one bf16 operand moves a probability by a few 1e-5 at these widths
PROB_TOL = 1e-4
# the same against the scan path, whose bf16 input block is XLA's dense ->
# LayerNorm -> GELU rather than the fused block (measured up to 2.2e-4)
SCAN_PROB_TOL = 5e-4
RATES = {"k_ap": 0.2, "k_af": 0.08, "k_pa": 0.1, "k_pf": 0.15, "k_fa": 0.07, "k_fp": 0.2}


def _models(seed, coupling=None, impl="pallas"):
    jc = jcfg.ModelConfig(**SMALL)
    params = jax_init(jax.random.key(seed), jc)
    coupling = coupling or {}
    jax_model = JaxCoupledModel(params, jc, jax_rates(RATES), jcfg.CouplingConfig(**coupling),
                                lstm_impl=impl)
    model = CoupledModel(params_from_jax(params), tcfg.ModelConfig(**SMALL),
                         rates_to_array(RATES), tcfg.CouplingConfig(**coupling),
                         device=torch.device("cpu"))
    return jax_model, model


def _windows(seed, b, t=16):
    return np.random.default_rng(seed).standard_normal((b, t, 5)).astype(np.float32)


@pytest.mark.parametrize("initial_state", [None, [0.7, 0.2, 0.1]], ids=["heuristic", "given"])
def test_predict_trajectory_matches_jax(initial_state):
    jax_model, model = _models(3, {"coupling_strength": 0.8})
    x = _windows(4, 1)
    want = jax_predict_trajectory(jax_model, x, initial_state=initial_state, forecast_steps=12)
    got = predict_trajectory(model, x, initial_state=initial_state, forecast_steps=12)
    for g, w, shape in zip(got, want, ((12, 3), (1, 2), (1, 16))):
        assert g.shape == shape == np.asarray(w).shape
        np.testing.assert_allclose(g, np.asarray(w), atol=PROB_TOL, rtol=0)
    if initial_state is not None:
        np.testing.assert_allclose(got[0][0], initial_state, atol=1e-6)


def test_predict_trajectory_defaults_to_the_models_device():
    _, model = _models(3)
    traj, probs, attn = predict_trajectory(model, _windows(5, 1))
    assert traj.shape == (10, 3) and probs.shape == (1, 2) and attn.shape == (1, 16)
    np.testing.assert_allclose(traj.sum(-1), 1.0, atol=1e-5)


def _far_from_thresholds(p_closed, cpl, margin=1e-3):
    """Windows whose P(closed) is not within ``margin`` of a decision the
    sweep takes on it: 0.5, and the initial-state thresholds."""
    edges = (0.5, cpl.init_threshold, 1.0 - cpl.init_threshold)
    return np.all([np.abs(p_closed - e) > margin for e in edges], axis=0)


@pytest.fixture
def fused_input(monkeypatch):
    """The JAX package's schedule that the port runs: the fused input block."""
    monkeypatch.setenv("EEGFLOW_FUSED_INPUT", "1")
    jax.clear_caches()
    yield
    jax.clear_caches()


def test_sweep_probabilities_match_the_pallas_schedule(fused_input):
    jax_model, model = _models(6)
    x = _windows(7, 48)
    want = jax_predict_probs(jax_model.params, x, jax_model.model_cfg, 2048,
                             lstm_impl="pallas")
    got = predict_probs(model.params, x, model.model_cfg, 2048)
    np.testing.assert_allclose(got, want, atol=PROB_TOL, rtol=0)


def test_coupling_sweep_matches_jax():
    jax_model, model = _models(6, impl="auto")
    x = _windows(7, 48)
    y = np.random.default_rng(8).integers(0, 2, 48)
    want_probs = jax_predict_probs(jax_model.params, x, jax_model.model_cfg, 2048)
    got_probs = predict_probs(model.params, x, model.model_cfg, 2048)
    np.testing.assert_allclose(got_probs, want_probs, atol=SCAN_PROB_TOL, rtol=0)
    keep = _far_from_thresholds(want_probs[:, 1], model.coupling)
    assert keep.sum() >= 40
    alphas = (0.0, 0.25, 0.5, 0.75, 1.0)
    want = jax_sweep(jax_model, x[keep], y[keep], alphas, forecast_steps=20)
    got = coupling_strength_sweep(model, x[keep], y[keep], alphas, forecast_steps=20)
    assert list(got) == ["0.0", "0.25", "0.5", "0.75", "1.0"]
    assert got == want


def test_coupling_sweep_keys_follow_the_alphas():
    """One entry per alpha, keyed as the reference writes them."""
    _, model = _models(9)
    x = _windows(10, 24)
    y = np.arange(24) % 2
    res = coupling_strength_sweep(model, x, y, alphas=(0.0, 1.0), forecast_steps=20)
    assert set(res) == {"0.0", "1.0"}
    for v in res.values():
        assert set(v) == {"accuracy", "f1", "mcc"} and 0 <= v["accuracy"] <= 1
