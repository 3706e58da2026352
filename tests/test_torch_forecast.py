"""The forecast and export modules of eegflow_torch against
``eegflow.analyze.forecast`` and ``eegflow.analyze.export`` on the same
numpy inputs: the batched ODE forecasts, their metrics and rolling windows,
the three-state probabilities (the port's plain twins against the JAX
package's Pallas kernels in interpret mode), the per-sample and
per-participant frames and the CSV files they write."""

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from scipy.integrate import solve_ivp

from eegflow.analyze import export as jexport
from eegflow.analyze import forecast as jforecast
from eegflow.core import config as jcfg
from eegflow.couple.rollout import CoupledModel as JaxCoupledModel
from eegflow.nn.model import classifier_init as jax_init
from eegflow.ode.field import rates_to_array as jax_rates
from eegflow_torch.analyze import export as texport
from eegflow_torch.analyze import forecast as tforecast
from eegflow_torch.convert import params_from_jax
from eegflow_torch.core import config as tcfg
from eegflow_torch.couple.rollout import CoupledModel
from eegflow_torch.ode.field import RATE_NAMES, rates_to_array

RATES = {"k_ap": 0.12, "k_af": 0.05, "k_pa": 0.1, "k_pf": 0.09, "k_fa": 0.07, "k_fp": 0.15}
HORIZONS = (5, 10, 20)
# float32 exact propagators on both sides, products in another order
TRAJ_TOL = 1e-5
METRIC_TOL = 1e-6
# the coupled rollout's probabilities and final states: the bf16 schedule
# against the Pallas path (tests/test_torch_rollout.py)
PROB_TOL = 1e-4
CPU = torch.device("cpu")


def _series(seed, n=160):
    """A smooth P(closed) series with noise, as a classifier gives over
    consecutive windows."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return np.clip(0.5 + 0.35 * np.sin(t / 9.0) + 0.1 * rng.standard_normal(n), 0.0, 1.0)


def test_prob_to_ode_state_and_sequences_equal_the_reference():
    p = np.linspace(0.0, 1.0, 41)
    np.testing.assert_array_equal(tforecast.prob_to_ode_state(p), jforecast.prob_to_ode_state(p))
    probs = np.stack([1 - p, p], axis=1)
    labels = (p > 0.5).astype(int)
    for w in (10, 60):
        for got, want in zip(tforecast.create_sequences_for_forecasting(probs, labels, w),
                             jforecast.create_sequences_for_forecasting(probs, labels, w)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rates_on_device", [False, True], ids=["host_rates", "tensor_rates"])
def test_multistep_forecast_matches_jax(rates_on_device):
    """Rates taken over from the JAX package's array, or made by the port."""
    p = _series(1)
    k_host = np.asarray(jax_rates(RATES))
    k = rates_to_array(RATES, CPU) if rates_on_device else torch.tensor(k_host)
    want = jforecast.multistep_forecast(p, k_host, HORIZONS)
    got = tforecast.multistep_forecast(p, k, HORIZONS)
    assert set(got) == set(want)
    for h in HORIZONS:
        np.testing.assert_array_equal(got[h]["actuals"], want[h]["actuals"])
        np.testing.assert_allclose(got[h]["predictions"], want[h]["predictions"],
                                   atol=TRAJ_TOL, rtol=0)
    assert all(np.abs(want[h]["predictions"] - 0.5).min() > 10 * TRAJ_TOL for h in HORIZONS)
    got_m = tforecast.evaluate_forecasts(got, HORIZONS)
    want_m = jforecast.evaluate_forecasts(want, HORIZONS)
    assert set(got_m) == set(want_m) == set(HORIZONS)
    for h in HORIZONS:
        assert set(got_m[h]) == set(want_m[h])
        for name, v in want_m[h].items():
            assert abs(got_m[h][name] - v) <= METRIC_TOL, (h, name)


def test_forecast_readout_matches_scipy():
    """F(h) + 0.5 P(h) of the batched solve against solve_ivp from three
    start indices."""
    p = _series(2, 60)
    got = tforecast.multistep_forecast(p, rates_to_array(RATES, CPU), HORIZONS)
    k = np.array([RATES[n] for n in RATE_NAMES])

    def rhs(t, y):
        a, pp, f = y
        return [-(k[0] + k[1]) * a + k[2] * pp + k[4] * f,
                k[0] * a - (k[2] + k[3]) * pp + k[5] * f,
                k[1] * a + k[3] * pp - (k[4] + k[5]) * f]

    for i in (0, 17, 39):
        sol = solve_ivp(rhs, (0.0, 20.0), tforecast.prob_to_ode_state(p[i]),
                        t_eval=np.arange(21.0), rtol=1e-10, atol=1e-12).y.T
        for h in HORIZONS:
            want = np.clip(sol[h, 2] + 0.5 * sol[h, 1], 0.0, 1.0)
            assert abs(got[h]["predictions"][i] - want) < TRAJ_TOL


def test_rolling_forecast_and_short_series_match_jax():
    p = _series(3, 400)
    k = np.asarray(jax_rates(RATES))
    got = tforecast.rolling_forecast_evaluation(p, rates_to_array(RATES, CPU))
    want = jforecast.rolling_forecast_evaluation(p, k)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g["window"] == w["window"] and g["accuracy"] == w["accuracy"]
        assert abs(g["mae"] - w["mae"]) <= METRIC_TOL
    short = tforecast.multistep_forecast(p[:15], rates_to_array(RATES, CPU), HORIZONS)
    assert all(len(short[h]["predictions"]) == 0 for h in HORIZONS)
    assert tforecast.evaluate_forecasts(short, HORIZONS) == {}


def _frames_inputs(seed, n=23):
    rng = np.random.default_rng(seed)
    lstm = rng.dirichlet([1, 1], n).astype(np.float32)
    three = rng.dirichlet([1, 1, 1], n).astype(np.float32)
    pred = rng.integers(0, 3, n).astype(np.int32)
    y = rng.integers(0, 2, n)
    return lstm, three, pred, y


def test_export_frames_and_files_equal_the_reference(tmp_path):
    lstm, three, pred, y = _frames_inputs(4)
    got = texport.sample_dataframe(lstm, three, pred, y, prefix="test_")
    want = jexport.sample_dataframe(lstm, three, pred, y, prefix="test_")
    pd.testing.assert_frame_equal(got, want)
    got_p = texport.participant_dataframe(got, n_participants=5)
    pd.testing.assert_frame_equal(got_p, jexport.participant_dataframe(want, n_participants=5))
    frames = {"test_sample_probabilities": got, "participant_probabilities": got_p}
    written = texport.export_frames(tmp_path / "port", frames)
    jexport.export_frames(tmp_path / "jax", {"test_sample_probabilities": want,
                                             "participant_probabilities":
                                             jexport.participant_dataframe(want, 5)})
    for name in frames:
        assert written[name][0] == str(tmp_path / "port" / f"{name}.csv")
        assert ((tmp_path / "port" / f"{name}.csv").read_bytes()
                == (tmp_path / "jax" / f"{name}.csv").read_bytes())


def test_three_state_probabilities_match_jax():
    kw = dict(input_size=5, hidden_size=32, num_layers=2)
    jc = jcfg.ModelConfig(**kw)
    params = jax_init(jax.random.key(11), jc)
    jax_model = JaxCoupledModel(params, jc, jax_rates(RATES), jcfg.CouplingConfig(),
                                lstm_impl="pallas")
    model = CoupledModel(params_from_jax(params), tcfg.ModelConfig(**kw),
                         rates_to_array(RATES), tcfg.CouplingConfig(), device=CPU)
    x = np.random.default_rng(12).standard_normal((9, 16, 5)).astype(np.float32)
    want = jexport.three_state_probabilities(jax_model, x)
    got = texport.three_state_probabilities(model, x)
    assert set(got) == set(want) == {"lstm_probs", "three_state_probs", "predictions"}
    for name in ("lstm_probs", "three_state_probs"):
        assert got[name].shape == want[name].shape
        np.testing.assert_allclose(got[name], want[name], atol=PROB_TOL, rtol=0)
    final = want["three_state_probs"]
    decided = np.minimum(np.abs(final[:, 2] - 0.5), np.abs(final[:, 0] - 0.5)) > PROB_TOL
    assert decided.sum() >= 7
    np.testing.assert_array_equal(got["predictions"][decided], want["predictions"][decided])
