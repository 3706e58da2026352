"""eegflow_torch ODE fit against the JAX package: the fit loss (kernel 11's
loss twin on the CPU) and its gradient, the differential evolution with its
polish, and the ``fit-ode`` stage's results file, which the JAX package
reads."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegflow.cli.main import _load_coupled_model as jax_load_coupled_model
from eegflow.core.artifacts import load_results as jax_load_results
from eegflow.core.config import PipelineConfig as JaxPipelineConfig
from eegflow.fit import make_fit_loss as jax_make_fit_loss
from eegflow.ode import field as jfield
from eegflow.ode import rates_to_array as jax_rates_to_array
from eegflow.ode import solve as jax_solve
from eegflow_torch.cli.main import main as cli_main
from eegflow_torch.core.config import ODEConfig
from eegflow_torch.fit import differential_evolution_fit, fit_ode_rates, make_fit_loss
from eegflow_torch.ode.cuda_ode import rk4_fit_loss_plain
from figure_records import STAGE_FIGURES, figure_files, patch_figures

TRUE = {"k_ap": 0.1, "k_af": 0.05, "k_pa": 0.2, "k_pf": 0.15, "k_fa": 0.1, "k_fp": 0.2}
# float32 losses of two implementations of the same steps (sums in another
# order, FMA contraction)
LOSS_REL_TOL = 1e-5
# the gradient: forward tangents here, reverse mode through the scan in JAX,
# relative to its largest entry
GRAD_REL_TOL = 1e-3


def _observation(rates, n_points=60, t_end=60.0, noise=0.0, seed=0):
    """tests/test_fit.py's observation, from the JAX package's solve."""
    _, traj = jax_solve([0.6, 0.25, 0.15], (0.0, t_end), n_points,
                        k=jax_rates_to_array(rates), method="expm")
    traj = np.asarray(traj)
    if noise:
        traj = np.clip(traj + np.random.default_rng(seed).normal(0, noise, traj.shape),
                       1e-3, 1.0)
        traj = traj / traj.sum(axis=1, keepdims=True)
    return traj


def _population(n=17, seed=3):
    rng = np.random.default_rng(seed)
    lo, hi = np.array(ODEConfig().bounds).T
    return (lo + rng.uniform(size=(n, 6)) * (hi - lo)).astype(np.float32)


@pytest.mark.parametrize("reg_weight,noise", [(1e-3, 0.0), (0.0, 0.02)])
def test_fit_loss_and_gradient_match_jax(reg_weight, noise):
    obs = _observation(TRUE, noise=noise)
    pop = _population()
    jloss = jax_make_fit_loss(obs, 0.0, 60.0, len(obs), reg_weight=reg_weight)
    tloss = make_fit_loss(obs, 0.0, 60.0, len(obs), reg_weight=reg_weight, device="cpu")
    want = np.asarray(jloss(jnp.asarray(pop)))
    got = tloss(torch.from_numpy(pop))
    assert got.shape == (17,) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= LOSS_REL_TOL * np.abs(want).max()

    want_g = np.asarray(jax.vmap(jax.grad(jloss))(jnp.asarray(pop)))
    k = torch.from_numpy(pop).requires_grad_()
    tloss(k).sum().backward()
    assert np.abs(k.grad.numpy() - want_g).max() <= GRAD_REL_TOL * np.abs(want_g).max()
    # the autograd Function carries the tangents' gradient, scaled by grad_output
    _, direct = rk4_fit_loss_plain(torch.from_numpy(pop), tloss.y0, tloss.observed, 16,
                                   tloss.steps, reg_weight, grad=True)
    k2 = torch.from_numpy(pop).requires_grad_()
    (3.0 * tloss(k2)).sum().backward()
    torch.testing.assert_close(k2.grad, 3.0 * direct)


def test_fit_loss_vanishes_at_the_true_rates():
    obs = _observation(TRUE)
    loss = make_fit_loss(obs, 0.0, 60.0, len(obs), reg_weight=0.0, device="cpu")
    k = torch.tensor([TRUE[n] for n in jfield.RATE_NAMES])
    assert float(loss(k)) < 1e-8
    assert loss(k[None, None].expand(2, 3, 6)).shape == (2, 3)
    with pytest.raises(ValueError, match="observed"):
        make_fit_loss(obs, 0.0, 60.0, len(obs) + 1, device="cpu")


def test_de_recovers_rates_and_repeats_bit_for_bit():
    """tests/test_fit.py's test_de_recovers_rates, and a second run from the
    same seed gives the same bits."""
    true = {"k_ap": 0.12, "k_af": 0.06, "k_pa": 0.25, "k_pf": 0.18, "k_fa": 0.09, "k_fp": 0.22}
    obs = _observation(true)
    cfg = ODEConfig(de_maxiter=150, reg_weight=0.0)
    fitted, fx, info = fit_ode_rates(obs, np.linspace(0, 60, len(obs)), cfg, device="cpu")
    assert fx < 1e-5
    assert info["generations"] <= 150 and isinstance(info["polished"], bool)
    for (lo, hi), name in zip(cfg.bounds, jfield.RATE_NAMES):
        assert lo - 1e-9 <= fitted[name] <= hi + 1e-9
    refit = _observation(fitted, n_points=len(obs), t_end=60.0)
    assert np.max(np.abs(refit - obs)) < 0.02
    again = fit_ode_rates(obs, np.linspace(0, 60, len(obs)), cfg, device="cpu")
    assert again == (fitted, fx, info)


def test_de_respects_bounds_without_polish():
    obs = _observation(TRUE, noise=0.02)
    bounds = ODEConfig().bounds
    loss = make_fit_loss(obs, 0.0, 60.0, len(obs), device="cpu")
    x, fx, info = differential_evolution_fit(loss, bounds, maxiter=20, polish=False)
    assert info == {"generations": 20, "polished": False}
    assert x.dtype == np.float64 and np.isfinite(fx)
    for i, (lo, hi) in enumerate(bounds):
        assert lo - 1e-9 <= x[i] <= hi + 1e-9
    # a converged population (every loss equal) stops before its first generation

    class Flat:
        device = torch.device("cpu")

        def __call__(self, k):
            return torch.ones(k.shape[:-1])

    _, fx, info = differential_evolution_fit(Flat(), bounds, maxiter=20, polish=False)
    assert info == {"generations": 0, "polished": False} and fx == 1.0


def test_fit_ode_stage_writes_what_the_jax_package_reads(tmp_path, monkeypatch):
    """synth -> preprocess -> fit-ode through the CLI on the CPU; the JAX
    package's load_results and _load_coupled_model read the results, and its
    steady state and stability of the fitted rates equal the port's; the two
    stages draw the JAX stages' figures (recorded, not rasterised), fig10 from
    the fitted rates."""
    rec = patch_figures(monkeypatch)
    from eegflow_torch.core.artifacts import save_checkpoint
    from eegflow_torch.core.config import ModelConfig
    from eegflow_torch.core.prng import make_generator
    from eegflow_torch.nn.model import classifier_init

    cfg = tmp_path / "cfg.json"
    cfg.write_text('{"ode": {"de_maxiter": 3}, "preprocess": {"sequence_length": 64}}')
    base = ["--data-dir", str(tmp_path / "data"), "--output-dir", str(tmp_path / "out"),
            "--config", str(cfg)]
    assert cli_main(base + ["synth", "--subjects", "3", "--duration", "3",
                            "--channels", "4"]) == 0
    assert cli_main(base + ["preprocess", "--device", "cpu"]) == 0
    assert cli_main(base + ["fit-ode", "--device", "cpu"]) == 0
    res = jax_load_results(tmp_path / "out" / "results" / "ode_results.json")
    assert list(res) == ["fitted_params", "fit_loss", "fit_info", "steady_state", "stability",
                         "sensitivity", "validation"]
    assert res["fit_info"]["generations"] == 3
    k = jax_rates_to_array(res["fitted_params"])
    np.testing.assert_allclose(res["steady_state"], np.asarray(jfield.steady_state(k)),
                               atol=1e-6)
    assert res["stability"] == jfield.stability_analysis(k)
    assert res["validation"] == jfield.validate_rates(res["fitted_params"])
    assert figure_files(tmp_path / "out") == sorted(
        f"{n}.{e}" for stage in ("preprocess", "fit-ode") for n in STAGE_FIGURES[stage]
        for e in ("png", "pdf"))
    fig10 = next(c for c in rec["port"]["calls"] if c[0] == "plot_ode_analysis")
    np.testing.assert_allclose(fig10[1][0], np.asarray(k))

    mcfg = ModelConfig(input_size=4, hidden_size=16, num_layers=1)
    save_checkpoint(tmp_path / "out" / "models" / "lstm_attention",
                    classifier_init(mcfg, make_generator(0)), mcfg)
    paths = {"models": tmp_path / "out" / "models", "results": tmp_path / "out" / "results"}
    model = jax_load_coupled_model(paths, JaxPipelineConfig())
    np.testing.assert_allclose(np.asarray(model.k_base), np.asarray(k))
