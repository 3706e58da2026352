"""eegflow_torch's figures (``viz/figures.py``) against the JAX package's, on
the CPU: each of the 21 figures of the stages drawn by both packages from
the same inputs (made from a numpy seed), their artist data recorded before
the figure closes and held equal (host numpy 1e-6 relative; fig10's
trajectories and steady state, float32 RK4 and a 3 x 3 solve on each side,
1e-5 absolute); no pixel is compared and no file rasterised but the one
case that writes PNG and PDF through the port's ``save_figure``. Also:
fig10's series on the CPU against ``eegflow.ode``, the stages that draw
fig01, fig04, fig07, fig08 and fig10-fig12 (``preprocess``, ``train``,
``fit-ode``) in both packages, the six-channel behaviour of ``explore``'s
fig02, and the port's ``all`` with matplotlib blocked."""

import contextlib
import functools
import io
import json
import re
import sys

import numpy as np
import pytest
import torch

import eegflow.viz.figures as jax_figures
import eegflow_torch.viz.figures as port_figures
from eegflow.baselines import classical as jax_classical
from eegflow.cli.main import main as jax_cli_main
from eegflow.data.synthetic import generate_synthetic_dataset as jax_synth
from eegflow.ode import rates_to_array as jax_rates_to_array
from eegflow.ode import solve as jax_solve
from eegflow.ode import steady_state as jax_steady_state
from eegflow_torch.baselines import classical as port_classical
from eegflow_torch.cli.main import FIGURES_SKIPPED
from eegflow_torch.cli.main import main as cli_main
from figure_records import (STAGE_FIGURES, assert_close, call_name, figure_files,
                            patch_figures)

RATES = {"k_ap": 0.2, "k_af": 0.03, "k_pa": 0.1, "k_pf": 0.05, "k_fa": 0.07, "k_fp": 0.2}
STATES = ("Active", "Passive", "Fatigued")
CHANNELS = ["Fp1", "Fz", "F3", "C3", "Cz", "T7", "P7", "Pz", "POz", "O1", "Oz", "O2"]
# host numpy on both sides
HOST_RTOL = 1e-6
# fig10: float32 RK4 (kernel 11's twin against the JAX scan), float32
# steady-state solves of two libraries and float32 linspaces (one ulp at 60
# is 3.8e-6)
ODE_ATOL = 1e-5


def _sensitivity(rng):
    return {r: {s: float(v) for s, v in zip(STATES, rng.normal(0, 0.3, 3))} for r in RATES}


def _inputs(fig, rng):
    """``fig``'s plot function and its arguments (``"PATH"`` for the path)."""
    if fig == "fig01":
        return "plot_class_distribution", [{s: rng.integers(0, 2, n) for s, n in
                                            (("train", 40), ("val", 12), ("test", 16))},
                                           "PATH"], {}
    if fig == "fig02":
        return "plot_sample_timeseries", [rng.normal(0, 1e-5, (8, 700)), 100.0,
                                          CHANNELS[:8], "PATH"], {}
    if fig == "fig03":
        freqs = np.linspace(0, 60, 31)
        return "plot_spectral_analysis", [{
            "psd": {"freqs": freqs.tolist(), "open": rng.uniform(1e-12, 1e-10, 31).tolist(),
                    "closed": rng.uniform(1e-12, 1e-10, 31).tolist()},
            "bands": {b: {"ratio": float(rng.uniform(0.5, 3))}
                      for b in ("delta", "theta", "alpha", "beta", "gamma")}}, "PATH"], {}
    if fig == "fig04":
        raw = rng.normal(0, 1e-5, (4, 500))
        return "plot_preprocessing_overview", [raw, raw * 0.8, raw / raw.std(1, keepdims=True),
                                               100.0, "PATH"], {}
    if fig == "fig05":
        res = {m: {"accuracy": float(rng.uniform(0.5, 1)), "f1": float(rng.uniform(0.5, 1)),
                   "auc": float(rng.uniform(0.5, 1))} for m in ("svm", "random_forest")}
        res["svm"]["accuracy_ci_95"] = [res["svm"]["accuracy"] - 0.05,
                                        res["svm"]["accuracy"] + 0.04]
        res["gradient_boosting"] = {"accuracy": 0.7, "f1": 0.6}
        return "plot_baseline_comparison", [res, "PATH"], {}
    if fig == "fig07":
        hist = {k: rng.uniform(0, 1, 5).tolist() for k in
                ("train_loss", "val_loss", "train_acc", "val_acc", "val_f1")}
        hist["learning_rates"] = np.geomspace(1e-4, 3e-4, 5).tolist()
        return "plot_training_history", [hist, "PATH"], {}
    if fig == "fig08":
        return "plot_attention_weights", [rng.dirichlet(np.ones(16), 60),
                                          np.arange(60) % 2, "PATH", 250.0], {}
    if fig == "fig10":
        return "plot_ode_analysis", [np.asarray(list(RATES.values()), np.float32), "PATH",
                                     {"sensitivities": _sensitivity(rng)}], {}
    if fig == "fig11":
        return "plot_state_diagram", [dict(RATES), "PATH"], {}
    if fig == "fig12":
        return "plot_sensitivity_heatmap", [_sensitivity(rng), "PATH"], {}
    if fig == "fig13":
        return "plot_coupling_analysis", [{str(a): {m: float(rng.uniform()) for m in
                                                    ("accuracy", "f1", "mcc")}
                                           for a in (0.0, 0.25, 0.5, 1.0)}, "PATH"], {}
    if fig == "fig14":
        traj = rng.dirichlet(np.ones(3), (7, 20))
        return "plot_trajectory_examples", [traj, rng.dirichlet(np.ones(2), 7), "PATH"], {}
    if fig == "fig15":
        res = {m: {"accuracy": float(rng.uniform(0.5, 1)), "f1": float(rng.uniform(0.5, 1)),
                   "auc": float(rng.uniform(0.5, 1)), "mcc": float(rng.uniform(-0.2, 1)),
                   "accuracy_ci_95": [0.5, 0.9]} for m in ("svm", "lstm_attention")}
        res["lstm_ode_integration"] = {"accuracy": 0.8, "f1": 0.7, "auc": None, "mcc": -0.1}
        return "plot_comprehensive_comparison", [res, "PATH"], {}
    if fig in ("fig16", "fig17"):
        method = "gradient" if fig == "fig16" else "permutation"
        return "plot_channel_importance", [{"method": method, "channels": CHANNELS,
                                            "importance": rng.dirichlet(np.ones(12)).tolist()},
                                           "PATH"], {}
    if fig == "fig18":
        return "plot_attention_explainability", [rng.dirichlet(np.ones(18), 40),
                                                 np.arange(40) % 2, "PATH"], {}
    if fig == "fig19":
        norm = rng.dirichlet(np.ones(12), 3)
        return "plot_importance_comparison", [{
            "methods": ["gradient", "permutation", "kernel_shap"],
            "correlation_matrix": np.corrcoef(norm).tolist(), "normalized": norm.tolist()},
            "PATH"], {}
    if fig == "fig20":
        return "plot_ode_explainability", [dict(RATES), "PATH"], {}
    if fig == "fig21":
        return "plot_shap_analysis", [rng.normal(0, 0.1, (30, 12)), rng.normal(0, 1, (30, 12)),
                                      CHANNELS, "PATH"], {
            "gradient_importance": rng.dirichlet(np.ones(12))}
    if fig == "fig23":
        hs = [5, 10, 20]
        res = {h: {"predictions": rng.uniform(0, 1, 40), "actuals": rng.uniform(0, 1, 40)}
               for h in hs}
        metrics = {h: {"accuracy": float(rng.uniform()), "mae": float(rng.uniform())}
                   for h in hs}
        return "plot_forecasting_results", [res, metrics, hs, "PATH"], {}
    if fig == "fig25":
        names = ["Full Model", "No Attention", "Minimal"]
        res = {n: {"metrics": {"accuracy": float(rng.uniform(0.5, 1))}} for n in names}
        cis = {n: {"lower": res[n]["metrics"]["accuracy"] - 0.1,
                   "upper": res[n]["metrics"]["accuracy"] + 0.05} for n in names}
        return "plot_ablation_results", [res, cis, "PATH"], {}
    raise KeyError(fig)


FIGURES = [f for names in STAGE_FIGURES.values() for f in (n[:5] for n in names)]


def test_the_port_has_every_public_name_of_the_jax_module():
    import eegflow.viz as jax_viz
    import eegflow_torch.viz as port_viz

    public = {n for n in dir(jax_figures) if n.startswith(("plot_", "save_"))}
    assert len(public) == 21 and public <= set(dir(port_figures))
    assert set(port_viz.__all__) == {n for n in dir(jax_viz) if not n.startswith("_")} - {
        "figures", "regions"}
    assert port_figures.DPI == jax_figures.DPI == 300
    assert port_figures.STATE_COLORS == jax_figures.STATE_COLORS
    assert port_figures.STATE_NAMES == jax_figures.STATE_NAMES
    assert sorted(FIGURES) == sorted(set(FIGURES)) and len(FIGURES) == 21


@pytest.mark.parametrize("fig", FIGURES)
def test_figure_records_equal_the_jax_figures(fig, tmp_path, monkeypatch):
    rec = patch_figures(monkeypatch)
    name, args, kwargs = _inputs(fig, np.random.default_rng(FIGURES.index(fig)))
    path = tmp_path / fig
    args = [path if isinstance(a, str) and a == "PATH" else a for a in args]
    extra = {"device": "cpu"} if fig == "fig10" else {}
    assert getattr(port_figures, name)(*args, **kwargs, **extra) == \
        getattr(jax_figures, name)(*args, **kwargs)
    (got_name, got), (want_name, want) = rec["port"]["figures"][0], rec["jax"]["figures"][0]
    assert got_name == want_name == fig
    if fig == "fig10":
        for ax in (0, 1):  # trajectories, steady state: float32 solves on each side
            assert_close(got["axes"][ax], want["axes"][ax], rtol=0.0, atol=ODE_ATOL)
        got["axes"], want["axes"] = got["axes"][2:], want["axes"][2:]
    assert_close(got, want, rtol=HOST_RTOL)


def test_save_figure_writes_png_and_pdf(tmp_path):
    """The port's ``save_figure`` writes real files at 300 dpi, as
    tests/test_viz.py checks the JAX package's."""
    written = port_figures.plot_state_diagram(dict(RATES), tmp_path / "figs" / "fig11")
    assert written == [str(tmp_path / "figs" / "fig11.png"), str(tmp_path / "figs" / "fig11.pdf")]
    for p in written:
        assert (tmp_path / "figs" / p.rsplit("/", 1)[1]).stat().st_size > 1000


def test_ode_analysis_series_matches_the_jax_solve():
    k = np.asarray(list(RATES.values()), np.float32)
    got = port_figures.ode_analysis_series(k, device="cpu")
    assert got["trajectories"].shape == (3, 120, 3)
    for i, y0 in enumerate(port_figures.ODE_ANALYSIS_INITS.values()):
        t, traj = jax_solve(y0, (0, 60), 120, k=jax_rates_to_array(RATES))
        np.testing.assert_allclose(got["t"], np.asarray(t), rtol=0, atol=ODE_ATOL)
        np.testing.assert_allclose(got["trajectories"][i], np.asarray(traj), rtol=0,
                                   atol=ODE_ATOL)
    np.testing.assert_allclose(got["steady_state"], np.asarray(jax_steady_state(k)), rtol=0,
                               atol=ODE_ATOL)


@pytest.fixture
def small_grids(monkeypatch):
    for module in (jax_classical, port_classical):
        monkeypatch.setattr(module, "train_random_forest", functools.partial(
            module.train_random_forest,
            grid=[{"n_estimators": 10, "max_depth": 4, "min_samples_split": 2}]))
        monkeypatch.setattr(module, "train_gradient_boosting", functools.partial(
            module.train_gradient_boosting,
            grid=[{"n_estimators": 10, "max_depth": 3, "learning_rate": 0.3}]))


def _tiny_config(path):
    path.write_text(json.dumps({
        "data": {"max_subjects": None},
        "model": {"hidden_size": 16, "num_layers": 1},
        "preprocess": {"sequence_length": 64},
        "train": {"batch_size": 64, "eval_batch_size": 128, "accumulation_steps": 1,
                  "bf16": False, "warmup_epochs": 1},
        "ode": {"de_maxiter": 3}}))
    return path


def test_preprocess_train_and_fit_ode_draw_what_the_jax_stages_draw(tmp_path, monkeypatch):
    """``preprocess``, ``train --epochs 1`` and ``fit-ode`` of both packages
    on one tiny dataset: the same figure files, and the same plot calls. The
    preprocessing arrays agree (the same windows and splits; fig04's
    recording filtered by float32 FFTs of two libraries); the trained model
    and the fitted rates come from each package's own random streams, so
    their histories, attention and rates are held in structure."""
    rec = patch_figures(monkeypatch)
    jax_synth(tmp_path / "data", n_subjects=3, duration_s=4.0, n_channels=6)
    cfg = _tiny_config(tmp_path / "cfg.json")
    for stage in ("preprocess", "train", "fit-ode"):
        extra = ["--epochs", "1"] if stage == "train" else []
        for key, run, dev in (("port", cli_main, ["--device", "cpu"]), ("jax", jax_cli_main, [])):
            rec[key]["calls"].clear()
            before = figure_files(tmp_path / key)
            assert (run(["--data-dir", str(tmp_path / "data"), "--output-dir",
                         str(tmp_path / key), "--config", str(cfg), stage, *extra, *dev])
                    or 0) == 0
            rec[key][stage] = (sorted(set(figure_files(tmp_path / key)) - set(before)),
                               list(rec[key]["calls"]))
        files, calls = rec["port"][stage]
        want_files, want_calls = rec["jax"][stage]
        assert files == want_files == sorted(f"{n}.{e}" for n in STAGE_FIGURES[stage]
                                             for e in ("png", "pdf"))
        assert [call_name(c) for c in calls] == [call_name(c) for c in want_calls]
        if stage == "preprocess":
            assert_close(calls[0], want_calls[0], rtol=0.0, atol=0.0)  # class counts
            (_, (raw, filt, norm, fs, _), _), (_, (wraw, wfilt, wnorm, wfs, _), _) = \
                calls[1], want_calls[1]
            assert fs == wfs and np.array_equal(raw, wraw)
            np.testing.assert_allclose(filt, wfilt, rtol=0, atol=1e-5 * np.abs(wfilt).max())
            np.testing.assert_allclose(norm, wnorm, rtol=0, atol=1e-4)
        else:
            for got, want in zip(calls, want_calls):
                _same_structure(got, want)


def _same_structure(got, want):
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _same_structure(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_structure(g, w)
    elif isinstance(want, np.ndarray):
        assert np.shape(got) == want.shape and np.isfinite(got).all() == np.isfinite(want).all()
    else:
        assert type(got) is type(want) or (np.isscalar(got) and np.isscalar(want))


def _blocked_matplotlib(monkeypatch):
    for name in [n for n in sys.modules if n == "matplotlib" or n.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)


def test_explore_needs_six_channels_for_fig02_unless_matplotlib_is_absent(tmp_path, monkeypatch):
    """On a 4-channel set both packages' ``explore`` raise IndexError in
    fig02 (six channels indexed, eegflow/viz/figures.py:54-66); with
    matplotlib blocked the port's writes its results and prints its skip
    line once."""
    rec = patch_figures(monkeypatch)
    jax_synth(tmp_path / "data", n_subjects=2, duration_s=3.0, n_channels=4)
    base = ["--data-dir", str(tmp_path / "data")]
    with pytest.raises(IndexError):
        jax_cli_main(base + ["--output-dir", str(tmp_path / "jax"), "explore"])
    with pytest.raises(IndexError):
        cli_main(base + ["--output-dir", str(tmp_path / "port"), "explore", "--device", "cpu"])
    assert [c[0] for c in rec["port"]["calls"]] == [c[0] for c in rec["jax"]["calls"]] == [
        "plot_spectral_analysis", "plot_sample_timeseries"]
    _blocked_matplotlib(monkeypatch)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli_main(base + ["--output-dir", str(tmp_path / "blocked"), "explore",
                                "--device", "cpu"]) == 0
    assert out.getvalue().count(FIGURES_SKIPPED) == 1
    assert f"explore: {FIGURES_SKIPPED}" in out.getvalue()
    assert sorted(p.name for p in (tmp_path / "blocked" / "results").iterdir()) == [
        "eda_report.md", "eda_summary.json"]
    assert not (tmp_path / "blocked" / "figures").exists()


def test_all_without_matplotlib_writes_everything_but_the_figures(tmp_path, monkeypatch,
                                                                  small_grids):
    """The port's ``all --epochs 1 --skip-shap --hidden 16 --device cpu``,
    with matplotlib drawing and with it blocked, on one tiny 6-channel
    dataset: blocked, each stage that draws prints its skip line once and
    the run writes the same files but ``figures/``."""
    jax_synth(tmp_path / "data", n_subjects=4, duration_s=8.0, n_channels=6)
    cfg = _tiny_config(tmp_path / "cfg.json")
    argv = ["all", "--epochs", "1", "--skip-shap", "--hidden", "16", "--device", "cpu"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    logs = {}
    try:
        with monkeypatch.context() as mp:
            rec = patch_figures(mp)
            assert cli_main(["--data-dir", str(tmp_path / "data"), "--output-dir",
                             str(tmp_path / "drawn"), "--config", str(cfg)] + argv) == 0
        _blocked_matplotlib(monkeypatch)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert cli_main(["--data-dir", str(tmp_path / "data"), "--output-dir",
                             str(tmp_path / "blocked"), "--config", str(cfg)] + argv) == 0
        logs = out.getvalue()
    finally:
        torch.set_num_threads(threads)
    skipped = re.findall(rf"^(\S+): {FIGURES_SKIPPED}", logs, flags=re.M)
    assert sorted(skipped) == sorted(STAGE_FIGURES)

    def files(out):
        return {str(p.relative_to(out)) for p in out.rglob("*") if p.is_file()}

    drawn, blocked = files(tmp_path / "drawn"), files(tmp_path / "blocked")
    figures = {f for f in drawn if f.startswith("figures/")}
    assert blocked == drawn - figures
    assert figures == {f"figures/{n}.{e}" for stage, names in STAGE_FIGURES.items()
                       if stage != "explain" for n in names for e in ("png", "pdf")} | {
        f"figures/{n}.{e}" for n in STAGE_FIGURES["explain"][1:] for e in ("png", "pdf")}
    assert len(rec["port"]["figures"]) == 20
