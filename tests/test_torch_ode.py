"""eegflow_torch ODE layer against the JAX package: the RK4 integrator (kernel
11's trajectory twin on the CPU), the exact-propagator solves, the
modulated solves, the steady states, stability, sensitivity and the
eye-state mapping, on inputs made with numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp

from eegflow import ode as jode
from eegflow.ode import field as jfield
from eegflow_torch import ode as tode
from eegflow_torch.ode import field as tfield
from eegflow_torch.ode.cuda_ode import rk4_trajectory, rk4_trajectory_plain, step_sizes

# float32 trajectories of two implementations: summation order and FMA
# contraction of the same steps
TRAJ_TOL = 1e-6
# against scipy's float64 solve_ivp (rtol 1e-10): the judged budget
SCIPY_TOL = 1e-5


def _rates(rng, n):
    return rng.uniform(0.01, 0.4, (n, 6)).astype(np.float32)


def _states(rng, n):
    return rng.dirichlet([2.0, 2.0, 2.0], n).astype(np.float32)


@pytest.mark.parametrize("batch,n_points,substeps,t1", [((), 21, 16, 20.0),
                                                        ((5,), 31, 16, 30.0),
                                                        ((2, 3), 12, 4, 5.5)])
def test_rk4_solve_matches_jax(rng, batch, n_points, substeps, t1):
    n = int(np.prod(batch)) if batch else 1
    k = _rates(rng, n).reshape(batch + (6,))
    y0 = _states(rng, n).reshape(batch + (3,))
    want = np.asarray(jode.rk4_solve(jnp.asarray(y0), 0.5, t1, n_points, jnp.asarray(k),
                                     substeps=substeps))
    got = tode.rk4_solve(torch.from_numpy(y0), 0.5, t1, n_points, torch.from_numpy(k),
                         substeps=substeps).numpy()
    assert got.shape == want.shape == (n_points,) + batch + (3,)
    assert np.abs(got - want).max() <= TRAJ_TOL


def test_rk4_solve_matches_solve_ivp(rng):
    k = _rates(rng, 1)[0]
    y0 = np.array([0.6, 0.3, 0.1], np.float32)
    got = tode.rk4_solve(torch.from_numpy(y0), 0.0, 40.0, 41, torch.from_numpy(k)).numpy()
    q = tfield.transition_matrix(torch.from_numpy(k)).double().numpy()
    ref = solve_ivp(lambda t, y: np.maximum(y, 0) @ q, (0.0, 40.0), y0.astype(np.float64),
                    t_eval=np.linspace(0, 40, 41), rtol=1e-10, atol=1e-12)
    assert np.abs(got - ref.y.T).max() < SCIPY_TOL


def test_rk4_trajectory_broadcasts_one_state_and_differentiates(rng):
    k = torch.from_numpy(_rates(rng, 4))
    y0 = torch.tensor([0.5, 0.3, 0.2])
    h = step_sizes(0.0, 10.0, 11, 8)
    a = rk4_trajectory(y0, k, 11, 8, h)
    b = rk4_trajectory_plain(y0.expand(4, 3), k, 11, 8, h)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    kg = k.clone().requires_grad_()
    tode.rk4_solve(y0, 0.0, 10.0, 11, kg, substeps=8)[-1, :, 2].sum().backward()
    assert kg.grad.shape == (4, 6) and torch.isfinite(kg.grad).all()


@pytest.mark.parametrize("method", ["rk4", "expm"])
def test_solve_and_solve_batch_match_jax(rng, method):
    k = _rates(rng, 6)
    y0 = (_states(rng, 6) * 3.0).astype(np.float32)  # unnormalised, as callers pass it
    t_want, want = jode.solve([0.5, 0.3, 0.2], (0.0, 15.0), 16, k=jnp.asarray(k[0]),
                              method=method)
    t_got, got = tode.solve([0.5, 0.3, 0.2], (0.0, 15.0), 16, k=torch.from_numpy(k[0]),
                            method=method)
    np.testing.assert_allclose(t_got.numpy(), np.asarray(t_want), rtol=1e-6)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TRAJ_TOL
    want = np.asarray(jode.solve_batch(jnp.asarray(y0), 0.0, 12.0, 13, jnp.asarray(k),
                                       method=method))
    got = tode.solve_batch(torch.from_numpy(y0), 0.0, 12.0, 13, torch.from_numpy(k),
                           method=method).numpy()
    assert got.shape == (6, 13, 3)
    assert np.abs(got - want).max() <= TRAJ_TOL


def test_solve_defaults_to_the_reference_rates_and_the_card():
    _, want = jode.solve([1.0, 1.0, 1.0], (0.0, 10.0), 11)
    _, got = tode.solve([1.0, 1.0, 1.0], (0.0, 10.0), 11, device="cpu")
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TRAJ_TOL
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tode.solve([1.0, 1.0, 1.0], (0.0, 10.0), 11)


def test_expm_solve_piecewise_matches_jax(rng):
    ks = _rates(rng, 9 * 4).reshape(9, 4, 6)
    y0 = _states(rng, 4)
    want = np.asarray(jode.expm_solve_piecewise(jnp.asarray(y0), 0.0, 9.0, 10, jnp.asarray(ks)))
    got = tode.expm_solve_piecewise(torch.from_numpy(y0), 0.0, 9.0, 10,
                                    torch.from_numpy(ks)).numpy()
    assert got.shape == (10, 4, 3)
    assert np.abs(got - want).max() <= TRAJ_TOL
    with pytest.raises(ValueError, match="one rate vector per segment"):
        tode.expm_solve_piecewise(torch.from_numpy(y0), 0.0, 9.0, 11, torch.from_numpy(ks))


@pytest.mark.parametrize("method", ["rk4", "expm"])
def test_solve_with_modulation_matches_jax(method):
    def modulation(t, params):  # arithmetic only: works on jax and torch scalars
        out = dict(params)
        out["k_ap"] = params["k_ap"] * (1.0 + 0.5 * t / 20.0)
        out["k_fa"] = params["k_fa"] * (2.0 - t / 20.0)
        return out

    k = np.array([0.1, 0.05, 0.2, 0.15, 0.1, 0.2], np.float32)
    t_want, want = jode.solve_with_modulation([0.5, 0.3, 0.2], (0.0, 20.0), modulation, 11,
                                              k=jnp.asarray(k), method=method, substeps=8)
    t_got, got = tode.solve_with_modulation([0.5, 0.3, 0.2], (0.0, 20.0), modulation, 11,
                                            k=torch.from_numpy(k), method=method, substeps=8)
    assert got.shape == (11, 3)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TRAJ_TOL
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-6)


def test_steady_states_match_jax(rng):
    k = _rates(rng, 7)
    want = np.asarray(jfield.steady_state(jnp.asarray(k)))
    got = tfield.steady_state(torch.from_numpy(k)).numpy()
    assert got.shape == (7, 3)
    assert np.abs(got - want).max() <= TRAJ_TOL
    grid = k.reshape(7, 1, 6) * np.float32(1.1)
    assert np.abs(tfield.steady_state(torch.from_numpy(grid)).numpy()
                  - np.asarray(jfield.steady_state(jnp.asarray(grid)))).max() <= TRAJ_TOL
    want = np.asarray(jfield.steady_state_numeric(jnp.asarray(k[0])))
    got = tfield.steady_state_numeric(torch.from_numpy(k[0])).numpy()
    assert np.abs(got - want).max() <= TRAJ_TOL


def test_stability_validation_and_rate_dicts_match_jax(rng):
    for k in list(_rates(rng, 3)) + [np.array([0.1, 0.02, 0.15, 0.08, 0.05, 0.1])]:
        assert tfield.stability_analysis(torch.from_numpy(np.asarray(k, np.float32))) == \
            jfield.stability_analysis(k)
        assert tfield.stability_analysis(k) == jfield.stability_analysis(k)
        rates = jfield.rates_to_dict(k)
        assert tfield.rates_to_dict(torch.from_numpy(np.asarray(k))) == rates
        assert tfield.validate_rates(rates) == jfield.validate_rates(rates)
    odd = {"k_ap": 0.45, "k_af": 0.3, "k_pa": 0.001, "k_pf": 0.3, "k_fa": 0.01, "k_fp": 0.02}
    assert tfield.validate_rates(odd) == jfield.validate_rates(odd)
    assert tfield.RATE_NAMES == jfield.RATE_NAMES
    assert tfield.DEFAULT_RATES == jfield.DEFAULT_RATES
    assert tfield.STATE_NAMES == jfield.STATE_NAMES


def test_parameter_sensitivity_matches_jax(rng):
    """Steady states within 1e-6; the sensitivities are their differences
    over dk = 0.2 k, so within 1e-6 / min(dk)."""
    k = _rates(rng, 1)[0]
    want = jode.parameter_sensitivity(jnp.asarray(k))
    got = tode.parameter_sensitivity(torch.from_numpy(k))
    assert sorted(got) == sorted(want) and got["deltas"] == want["deltas"]
    for key in ("base_steady_state", "perturbed_steady_states"):
        assert np.abs(np.asarray(got[key]) - np.asarray(want[key])).max() <= TRAJ_TOL
    tol = 2 * TRAJ_TOL / (0.2 * k.min())
    for name, per_state in want["sensitivities"].items():
        for state, v in per_state.items():
            assert abs(got["sensitivities"][name][state] - v) <= tol


@pytest.mark.parametrize("n,window", [(500, 20), (333, 10), (40, 20), (15, 20)])
def test_map_eye_state_to_cognitive_equals_jax(rng, n, window):
    eye = (rng.uniform(size=n) < np.linspace(0.1, 0.9, n)).astype(np.int64)
    got = tode.map_eye_state_to_cognitive(eye, window)
    want = jode.map_eye_state_to_cognitive(eye, window)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
