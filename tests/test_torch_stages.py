"""The ``explore``, ``baselines``, ``integrate``, ``explain``, ``forecast``
and ``export`` stages of the port's CLI with ``--device cpu`` on artifacts
the JAX package wrote (its ``save_processed``, ``save_checkpoint`` and
``save_results``, as its ``preprocess``, ``train`` and ``fit-ode`` stages
write them, at a tiny size; a raw dataset its ``synth`` writes): each writes
the files the JAX package's stage writes on the same artifacts, with the
same keys, and draws the figures the JAX package's stage draws, by file
name, from the same arrays (the plot calls of both packages recorded, the
figures not rasterised: tests/figure_records.py); with ``--device cuda`` and
no GPU each raises. Then the port's ``all`` on a tiny dataset writes every
one of those files, figures included, and the rest of the JAX package's
``all``. The baselines' forest and boosted trees run a one-candidate grid
here (their default grids are held in tests/test_torch_baselines.py)."""

import functools
import json
import shutil

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from eegflow.baselines import classical as jax_classical
from eegflow.cli.main import main as jax_cli_main
from eegflow.data.synthetic import generate_synthetic_dataset as jax_synth
from eegflow.core.artifacts import save_checkpoint, save_processed, save_results
from eegflow.core.config import ModelConfig as JaxModelConfig
from eegflow.nn.model import classifier_init as jax_classifier_init
from eegflow_torch.baselines import classical as port_classical
from eegflow_torch.cli.main import build_parser
from eegflow_torch.cli.main import main as cli_main
from figure_records import (STAGE_FIGURES, assert_close, call_name, figure_files,
                            patch_figures)
from torch_threads import one_torch_thread  # noqa: F401

T, C = 16, 5
RATES = {"k_ap": 0.2, "k_af": 0.03, "k_pa": 0.1, "k_pf": 0.05, "k_fa": 0.07, "k_fp": 0.2}
CHANNELS = ["O1", "O2", "Fz", "P7", "Cz"]
# what each stage writes under results/ (the JAX stages also draw figures)
WRITES = {
    "explore": ["eda_report.md", "eda_summary.json"],
    "baselines": ["baseline_results.json"],
    "integrate": ["all_model_results.json", "coupling_analysis.json",
                  "integration_results.json"],
    "explain": ["explainability_summary.json"],
    "forecast": ["forecasting_results.json"],
    "export": ["participant_probabilities.csv", "test_sample_probabilities.csv",
               "three_state_summary.json", "train_sample_probabilities.csv",
               "val_sample_probabilities.csv"],
}
STAGE_ARGS = {"explain": ["--skip-shap"]}
# what the baselines stage writes under models/
BASELINE_MODELS = ["baseline_models.pkl", "features_test.npz", "features_train.npz",
                   "features_val.npz"]
# what the ablate stage writes under results/ (held against the JAX package's
# stage in tests/test_torch_ablation_stage.py)
ABLATE_WRITES = ["results_tables.txt", "sensitivity_analysis.json"]
# the arguments of the port's plot calls against the JAX stage's (rtol, atol),
# measured on this fixture in brackets: explore's band powers and PSDs (float32
# Welch of two libraries, tests/test_torch_eda.py's bound; 3.6e-7) and the
# baselines' probabilities (the features of two float32 extractors, 1e-5,
# through sklearn; 1.8e-6) relative; the classifier's P(closed) and what is
# computed from it absolutely: the JAX stages' "auto" is its scan path, ~2e-4
# from the port's probabilities (ROADMAP §3; trajectories 7.2e-5, importances
# 5.1e-5), and the forecast's correlation over 20 points amplifies it (9.6e-4)
DRAW_TOL = {"explore": (1e-5, 0.0), "baselines": (1e-5, 0.0), "integrate": (0.0, 5e-4),
            "explain": (0.0, 5e-4), "forecast": (0.0, 5e-3), "export": (0.0, 0.0)}
SMALL_RF = [{"n_estimators": 10, "max_depth": 4, "min_samples_split": 2}]
SMALL_GB = [{"n_estimators": 10, "max_depth": 3, "learning_rate": 0.3}]


@pytest.fixture(scope="module")
def small_grids():
    with pytest.MonkeyPatch.context() as mp:
        for module in (jax_classical, port_classical):
            mp.setattr(module, "train_random_forest",
                       functools.partial(module.train_random_forest, grid=SMALL_RF))
            mp.setattr(module, "train_gradient_boosting",
                       functools.partial(module.train_gradient_boosting, grid=SMALL_GB))
        yield


def _split(rng, n):
    y = np.arange(n) % 2
    x = rng.standard_normal((n, T, C)).astype(np.float32)
    x[:, :, 0] += (y - 0.5).astype(np.float32)[:, None]
    return x, y.astype(np.int64)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """One output directory of JAX-written artifacts -> (jax copy, port copy);
    the raw dataset the explore stage reads is ``data`` beside them."""
    root = tmp_path_factory.mktemp("stages")
    jax_synth(root / "data", n_subjects=2, duration_s=4.0, n_channels=8)
    src = root / "src"
    rng = np.random.default_rng(0)
    arrays = {}
    for split, n in (("train", 24), ("val", 8), ("test", 40)):
        arrays[f"X_{split}"], arrays[f"y_{split}"] = _split(rng, n)
    save_processed(src / "processed_data", arrays, {"channel_names": CHANNELS})
    cfg = JaxModelConfig(input_size=C, hidden_size=16, num_layers=1)
    save_checkpoint(src / "models" / "lstm_attention",
                    jax_classifier_init(jax.random.key(3), cfg), cfg)
    attention = rng.dirichlet(np.ones(T), 40).astype(np.float32)
    np.save(src / "models" / "attention_weights.npy", attention)
    save_results(src / "results" / "ode_results.json", {"fitted_params": RATES})
    save_results(src / "results" / "lstm_results.json",
                 {"accuracy": 0.6, "f1": 0.5, "auc": 0.55, "mcc": 0.1,
                  "accuracy_ci_95": [0.5, 0.7]})
    shutil.copytree(src, root / "jax")
    shutil.copytree(src, root / "port")
    return root / "jax", root / "port"


def _shape(obj):
    """The key structure of a JSON document (dict keys, list lengths)."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_shape(v) for v in obj]
    return type(obj).__name__ if obj is None else "value"


@pytest.fixture(scope="module")
def ran(artifacts, small_grids):
    """Every stage of both packages, in pipeline order, on its copy, the
    figures recorded (for this module) -> (jax copy, port copy, {stage: the
    files the port's stage wrote}, {stage: {package: (the figure files it
    drew, its plot calls)}})."""
    jax_out, port_out = artifacts
    data = ["--data-dir", str(jax_out.parent / "data")]
    written, drawn = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        rec = patch_figures(mp)
        for stage in WRITES:
            figs = {"jax": figure_files(jax_out), "port": figure_files(port_out)}
            for calls in (rec["jax"]["calls"], rec["port"]["calls"]):
                calls.clear()
            before = set((port_out / "results").iterdir())
            assert cli_main(data + ["--output-dir", str(port_out), stage,
                                    *STAGE_ARGS.get(stage, []), "--device", "cpu"]) == 0
            written[stage] = sorted(p.name for p in set((port_out / "results").iterdir())
                                    - before)
            assert (jax_cli_main(data + ["--output-dir", str(jax_out), stage,
                                         *STAGE_ARGS.get(stage, [])]) or 0) == 0
            drawn[stage] = {key: (sorted(set(figure_files(out)) - set(figs[key])),
                                  list(rec[key]["calls"]))
                            for key, out in (("jax", jax_out), ("port", port_out))}
        yield jax_out, port_out, written, drawn


@pytest.mark.parametrize("stage", list(WRITES))
def test_stage_writes_what_the_jax_stage_writes(stage, ran):
    jax_out, port_out, written, _ = ran
    assert written[stage] == WRITES[stage]
    for name in written[stage]:
        mine, theirs = port_out / "results" / name, jax_out / "results" / name
        if name.endswith(".json"):
            assert _shape(json.loads(mine.read_text())) == _shape(json.loads(theirs.read_text()))
        elif name.endswith(".md"):
            assert mine.read_text() == theirs.read_text()
        else:
            got, want = pd.read_csv(mine), pd.read_csv(theirs)
            assert list(got.columns) == list(want.columns)
            assert list(got.iloc[:, 0]) == list(want.iloc[:, 0])  # sample / participant ids


def test_explain_summary_reads_the_artifacts(ran):
    """The summary names the metadata's channels, the attention and ODE
    analyses of the stored weights and rates, and (with --skip-shap) two
    methods."""
    _, port_out, _, _ = ran
    summary = json.loads((port_out / "results" / "explainability_summary.json").read_text())
    assert summary["explainability_methods"] == ["gradient", "permutation"]
    assert summary["gradient"]["channels"] == CHANNELS
    np.testing.assert_allclose(sum(summary["gradient"]["importance"]), 1.0, atol=1e-9)
    assert summary["attention_patterns"]["peak_position"] in range(T)
    assert summary["ode_dynamics"]["params"] == RATES
    assert not (port_out / "results" / "shap_values.npy").exists()


def test_explore_and_baselines_read_what_they_should(ran):
    """explore's census and biomarker come from the raw dataset; baselines
    caches the features and pickles the models under models/, as the JAX
    package's stage does."""
    jax_out, port_out, _, _ = ran
    summary = json.loads((port_out / "results" / "eda_summary.json").read_text())
    want = json.loads((jax_out / "results" / "eda_summary.json").read_text())
    assert summary["census"] == want["census"] and summary["statistics"] == want["statistics"]
    assert summary["census"]["n_recordings"] == 4
    # float32 Welch of two libraries (tests/test_torch_spectral.py's bound)
    assert summary["alpha_ratio"] == pytest.approx(want["alpha_ratio"], rel=1e-5)
    for out in (jax_out, port_out):
        assert sorted(p.name for p in (out / "models").iterdir()
                      if p.name in BASELINE_MODELS) == BASELINE_MODELS
    res = json.loads((port_out / "results" / "baseline_results.json").read_text())
    assert list(res) == ["svm", "random_forest", "gradient_boosting"]
    zoo = json.loads((port_out / "results" / "all_model_results.json").read_text())
    assert {"svm", "random_forest", "gradient_boosting"} <= set(zoo)


@pytest.mark.parametrize("stage", list(WRITES))
def test_stage_draws_what_the_jax_stage_draws(stage, ran):
    """The same figure files as the JAX stage's, from plot calls with the
    same arguments."""
    files, calls = ran[3][stage]["port"]
    want_files, want_calls = ran[3][stage]["jax"]
    names = [n for n in STAGE_FIGURES.get(stage, []) if n != "fig21_shap_analysis"]
    assert files == want_files == sorted(f"{n}.{e}" for n in names for e in ("png", "pdf"))
    assert [call_name(c) for c in calls] == [call_name(c) for c in want_calls]
    rtol, atol = DRAW_TOL[stage]
    for got, want in zip(calls, want_calls):
        assert_close(got, want, rtol=rtol, atol=atol, where=call_name(got)[1])


def _kernel_shap_stand_in(params, model_cfg, x, channel_names=None, **_):
    """KernelSHAP's result format from a fixed function of the windows (the
    values themselves are held in tests/test_torch_explain_numpy.py)."""
    explain = np.asarray(x, np.float64)[:8].mean(axis=1)
    values = explain * np.linspace(-1.0, 1.0, explain.shape[1])
    importance = np.abs(values).mean(axis=0)
    importance = importance / importance.sum()
    names = list(channel_names)
    return {"channels": names, "importance": importance.tolist(), "shap_values": values,
            "x_explain": explain, "ranking": [names[i] for i in np.argsort(-importance)],
            "method": "kernel_shap"}


def test_explain_draws_fig21_where_the_jax_stage_does(tmp_path, monkeypatch):
    """``explain`` without ``--skip-shap`` in both packages, KernelSHAP
    replaced by one stand-in (its default budget takes minutes on the CPU):
    fig21 is drawn from the SHAP values, the rows they explain, the channels
    and the gradient importances, as the JAX stage draws it. Twelve channels:
    fig21 labels ten, and both packages raise on fewer."""
    import eegflow.explain
    import eegflow_torch.explain

    names = ["Fp1", "Fz", "F3", "C3", "Cz", "T7", "P7", "Pz", "POz", "O1", "Oz", "O2"]
    rng = np.random.default_rng(1)
    arrays = {}
    for split, n in (("train", 8), ("val", 4), ("test", 12)):
        arrays[f"X_{split}"] = rng.standard_normal((n, T, len(names))).astype(np.float32)
        arrays[f"y_{split}"] = (np.arange(n) % 2).astype(np.int64)
    save_processed(tmp_path / "src" / "processed_data", arrays, {"channel_names": names})
    cfg = JaxModelConfig(input_size=len(names), hidden_size=16, num_layers=1)
    save_checkpoint(tmp_path / "src" / "models" / "lstm_attention",
                    jax_classifier_init(jax.random.key(4), cfg), cfg)
    for key in ("jax", "port"):
        shutil.copytree(tmp_path / "src", tmp_path / key)
    for module in (eegflow.explain, eegflow_torch.explain):
        monkeypatch.setattr(module, "kernel_shap_channel_importance", _kernel_shap_stand_in)
    rec = patch_figures(monkeypatch)
    assert cli_main(["--output-dir", str(tmp_path / "port"), "explain", "--device", "cpu"]) == 0
    assert (jax_cli_main(["--output-dir", str(tmp_path / "jax"), "explain"]) or 0) == 0
    drawn = ["fig21_shap_analysis", "fig16_gradient_importance",
             "fig17_permutation_importance", "fig19_importance_comparison"]
    for key in ("jax", "port"):
        assert [call_name(c)[1] for c in rec[key]["calls"]] == drawn
        assert figure_files(tmp_path / key) == sorted(f"{n}.{e}" for n in drawn
                                                      for e in ("png", "pdf"))
    rtol, atol = DRAW_TOL["explain"]
    for got, want in zip(rec["port"]["calls"], rec["jax"]["calls"]):
        assert_close(got, want, rtol=rtol, atol=atol, where=call_name(got)[1])
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "results" / "shap_values.npy"),
                                  np.load(tmp_path / "jax" / "results" / "shap_values.npy"))


@pytest.mark.parametrize("stage", list(WRITES) + ["parity", "all"])
def test_stage_on_cuda_without_a_gpu_raises(stage, artifacts):
    assert build_parser().parse_args([stage]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the refusal without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["--data-dir", str(artifacts[0].parent / "data"),
                  "--output-dir", str(artifacts[1]), stage])


def test_all_writes_every_file_of_the_jax_packages_all(ran, tmp_path_factory, small_grids):
    """``all --epochs 1 --skip-shap --hidden 16 --device cpu`` on a tiny
    dataset (one torch thread) runs the ten stages and writes every file the
    JAX package's stages wrote above, where its ``all`` writes them, with the
    figures of the stages run here alone (``preprocess``, ``train``,
    ``fit-ode``, ``ablate``), and the ablate stage's files: nothing missing,
    nothing more. Six channels: ``explore``'s fig02 draws six, in both
    packages (tests/test_torch_figures.py holds the raise on fewer)."""
    jax_out = ran[0]
    root = tmp_path_factory.mktemp("all")
    jax_synth(root / "data", n_subjects=4, duration_s=8.0, n_channels=6)
    (root / "cfg.json").write_text(json.dumps({
        "data": {"max_subjects": None},
        "model": {"hidden_size": 16, "num_layers": 1},
        "train": {"batch_size": 64, "eval_batch_size": 128, "accumulation_steps": 1,
                  "bf16": False, "warmup_epochs": 1},
        "ode": {"de_maxiter": 5}}))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rc = cli_main(["--data-dir", str(root / "data"), "--output-dir", str(root / "out"),
                       "--config", str(root / "cfg.json"), "all", "--epochs", "1",
                       "--skip-shap", "--hidden", "16", "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    assert rc == 0

    def files(out):
        return {str(p.relative_to(out)) for p in out.rglob("*") if p.is_file()}

    want = files(jax_out) | {f"results/{name}" for name in ABLATE_WRITES} | {
        f"figures/{n}.{e}" for stage in ("preprocess", "train", "fit-ode", "ablate")
        for n in STAGE_FIGURES[stage] for e in ("png", "pdf")}
    assert files(root / "out") == want
    ckpt = json.loads((root / "out" / "models" / "lstm_attention" / "checkpoint.json")
                      .read_text())
    assert ckpt["model_config"]["input_size"] == 6
    ablation = json.loads((root / "out" / "results" / "sensitivity_analysis.json").read_text())
    assert len(ablation["ablation"]) == 6
