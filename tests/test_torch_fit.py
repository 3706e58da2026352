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
from torch_threads import one_torch_thread  # noqa: F401

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


def _small_fit_loss(seed=0):
    """A fit loss at a small shape: 20 points, 2 RK4 substeps."""
    obs = _observation(TRUE, n_points=20, t_end=20.0, noise=0.02, seed=seed)
    return make_fit_loss(obs, 0.0, 20.0, 20, substeps=2, device="cpu")


def test_chunked_draws_are_the_loops_draws_from_the_same_seed():
    """A chunk's draws, G generations at once, are the numbers the generation
    loop draws one generation at a time from the same seed: per generation
    rand(()), rand((n, n)), rand((n, d)), randint(0, d, (n,))."""
    from eegflow_torch.fit.evolution import _draw_generations

    n, d, count = 18, 6, 5
    chunk = _draw_generations(torch.Generator().manual_seed(7), n, d, count, torch.device("cpu"))
    gen = torch.Generator().manual_seed(7)
    for g in range(count):
        assert torch.equal(chunk.f[g], torch.rand((), generator=gen))
        assert torch.equal(chunk.u[g], torch.rand((n, n), generator=gen))
        assert torch.equal(chunk.cr[g], torch.rand((n, d), generator=gen))
        assert torch.equal(chunk.j[g], torch.randint(0, d, (n,), generator=gen))
    assert chunk.f.dtype == chunk.u.dtype == chunk.cr.dtype == torch.float32
    assert chunk.j.dtype == torch.int64


def test_partner_ties_go_to_the_lower_index_as_jnp_argsort():
    """The pinned partner rule against the reference's stable argsort of the
    self-masked draws, on rows with forced ties (on the 2^-24 grid of torch's
    float32 uniforms) and on a plain draw."""
    from eegflow_torch.ode.cuda_ode import de_partners

    rng = np.random.default_rng(5)
    n = 18
    u = np.floor(rng.uniform(size=(n, n)) * 2 ** 24).astype(np.float32) / np.float32(2 ** 24)
    tick = np.float32(2.0 ** -24)
    u[0, [3, 9, 12]] = 0.0                       # three-way tie for both partners
    u[1, [0, 17]] = 0.0                          # a tie at the head of the row
    u[2, [4, 5]] = tick
    u[2, 6] = 0.0                                # the second partner tied
    u[4, :] = np.float32(0.5)                    # a row of one value
    want = np.asarray(jnp.argsort(jnp.asarray(u) + jnp.eye(n) * 2.0, axis=1))[:, :2]
    got = de_partners(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0].tolist() == [3, 9] and got[1].tolist() == [0, 17]
    assert got[2].tolist() == [6, 4] and got[4].tolist() == [0, 1]


@pytest.mark.parametrize("spread", [1e-6, 1e-4, 1e-2])
def test_fixed_order_convergence_test_agrees_with_jnp_away_from_the_threshold(spread):
    """The DE's float64 candidate-order statistic decides as the reference's
    float32 jnp.std <= atol + tol |jnp.mean| wherever tol is not within a
    factor of 2 of the ratio; the best member is jnp.argmin's."""
    from eegflow_torch.ode.cuda_ode import de_best, de_converged

    rng = np.random.default_rng(11)
    fit = (0.01 * (1.0 + spread * rng.standard_normal(90))).astype(np.float32)
    ratio = float(jnp.std(fit) / jnp.abs(jnp.mean(fit)))
    for tol in (ratio / 2, ratio * 2):
        want = bool(jnp.std(fit) <= tol * jnp.abs(jnp.mean(fit)))
        assert de_converged(fit.tolist(), tol) == want == (tol > ratio)
    fit[[7, 30]] = fit.min() / 2
    assert de_best(fit.tolist()) == int(jnp.argmin(fit)) == 7
    assert de_converged([0.5] * 18, 0.0)


def test_chunked_generations_are_the_loops_bit_for_bit(monkeypatch):
    """The card's chunked search (the DE mode's CPU twin here) equals the loop
    of generations bit for bit: chunks of 3 over 10 generations (3 does not
    divide 10), and a chunk inside which the population converges."""
    from eegflow_torch.fit import evolution
    from eegflow_torch.fit.evolution import _de_minimize, _de_minimize_chunked

    monkeypatch.setattr(evolution, "DE_CHUNK", 3)
    loss = _small_fit_loss()
    lo = torch.tensor([b[0] for b in ODEConfig().bounds])
    hi = torch.tensor([b[1] for b in ODEConfig().bounds])
    for maxiter, tol in ((10, 1e-7), (40, 0.3)):
        loop = _de_minimize(loss, torch.Generator().manual_seed(3), lo, hi, 3, maxiter, tol)
        chunked = _de_minimize_chunked(loss, torch.Generator().manual_seed(3), lo, hi, 3,
                                       maxiter, tol)
        assert torch.equal(loop[0], chunked[0]) and torch.equal(loop[1], chunked[1])
        assert loop[2] == chunked[2]
        assert (loop[2] == maxiter) == (tol < 0.1)


def test_pinned_loop_recovers_rates_at_a_small_shape():
    """tests/test_fit.py's recovery criteria (loss under 1e-5, the refitted
    trajectory within 0.02) for the loop with the pinned rules, at 20 points
    and 4 substeps with popsize 5."""
    true = {"k_ap": 0.12, "k_af": 0.06, "k_pa": 0.25, "k_pf": 0.18, "k_fa": 0.09, "k_fp": 0.22}
    obs = _observation(true, n_points=20, t_end=60.0)
    cfg = ODEConfig(de_maxiter=150, de_popsize=5, reg_weight=0.0, rk4_substeps=4)
    fitted, fx, info = fit_ode_rates(obs, np.linspace(0, 60, 20), cfg, device="cpu")
    assert fx < 1e-5 and info["generations"] <= 150
    refit = _observation(fitted, n_points=20, t_end=60.0)
    assert np.max(np.abs(refit - obs)) < 0.02


def test_chunk_length_comes_from_the_draws_byte_budget():
    """A chunk's generations: DE_CHUNK = 64 at the default n = 90 (so the
    default fit keeps its 13 launches over 1,000 generations), fewer where 64
    generations' draws (f, u (n, n), cr (n, 6), j (n)) would pass
    DE_CHUNK_BYTES (63 at n = 1,026, 7 at n = 3,000), and never 0."""
    from eegflow_torch.fit.evolution import DE_CHUNK, DE_CHUNK_BYTES, de_chunk_length

    assert DE_CHUNK == 64 and de_chunk_length(90) == 64 and de_chunk_length(18) == 64
    assert de_chunk_length(1026) == 63 and de_chunk_length(3000) == 7
    for n in (1026, 3000, 8191, 10 ** 5):
        chunk = de_chunk_length(n)
        per_generation = 4 + 4 * n * n + 4 * n * 6 + 8 * n
        assert 1 <= chunk < 64
        assert chunk * per_generation <= DE_CHUNK_BYTES or chunk == 1
        assert chunk == 1 or (chunk + 1) * per_generation > DE_CHUNK_BYTES
    assert de_chunk_length(10 ** 5) == 1


@pytest.mark.parametrize("maxiter,tol", [(5, 1e-7), (5, 10.0)])
def test_chunked_generations_at_popsize_171_are_the_loops_bit_for_bit(monkeypatch, maxiter, tol):
    """At popsize 171 (n = 1,026, over the one-CTA class's 1,024) the chunked
    search equals the loop bit for bit: a byte budget of two generations'
    draws gives chunks of 2 over 5 generations (2 does not divide 5), and a
    population that passes the test before its first generation."""
    from eegflow_torch.fit import evolution
    from eegflow_torch.fit.evolution import _de_minimize, _de_minimize_chunked, de_chunk_length

    n = 171 * 6
    monkeypatch.setattr(evolution, "DE_CHUNK_BYTES", 2 * (4 + 4 * n * n + 4 * n * 6 + 8 * n))
    assert de_chunk_length(n) == 2
    obs = _observation(TRUE, n_points=4, t_end=6.0, noise=0.02)
    loss = make_fit_loss(obs, 0.0, 6.0, 4, substeps=2, device="cpu")
    lo = torch.tensor([b[0] for b in ODEConfig().bounds])
    hi = torch.tensor([b[1] for b in ODEConfig().bounds])
    calls = []
    real = evolution.de_generations
    monkeypatch.setattr(evolution, "de_generations",
                        lambda *a, **k: calls.append(a[4].f.shape[0]) or real(*a, **k))
    loop = _de_minimize(loss, torch.Generator().manual_seed(8), lo, hi, 171, maxiter, tol)
    chunked = _de_minimize_chunked(loss, torch.Generator().manual_seed(8), lo, hi, 171, maxiter,
                                   tol)
    assert torch.equal(loop[0], chunked[0]) and torch.equal(loop[1], chunked[1])
    assert loop[2] == chunked[2] == (maxiter if tol < 1 else 0)
    assert calls == ([2, 2, 1] if tol < 1 else [2])


def test_de_at_popsize_171_recovers_rates_at_a_small_shape():
    """tests/test_fit.py's recovery criteria (loss under 1e-5, the refitted
    trajectory within 0.02) for differential_evolution_fit at popsize 171
    (n = 1,026), with its polish, at 12 points and 2 substeps."""
    true = {"k_ap": 0.12, "k_af": 0.06, "k_pa": 0.25, "k_pf": 0.18, "k_fa": 0.09, "k_fp": 0.22}
    obs = _observation(true, n_points=12, t_end=60.0)
    cfg = ODEConfig(de_maxiter=30, de_popsize=171, reg_weight=0.0, rk4_substeps=2)
    fitted, fx, info = fit_ode_rates(obs, np.linspace(0, 60, 12), cfg, device="cpu")
    assert fx < 1e-5 and info["generations"] <= 30
    refit = _observation(fitted, n_points=12, t_end=60.0)
    assert np.max(np.abs(refit - obs)) < 0.02
